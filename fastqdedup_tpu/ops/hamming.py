"""Batched / all-pairs Hamming distance on device.

Replaces the reference's per-pair scalar loop (distances.h:8-31) and the
trie's fast-fail Hamming walk (_triemodule.c:380-495) with dense forms
that XLA compiles:

* **all-pairs tile** (:func:`within_tile_packed`): one-hot the index
  matrices to ``[N, Lp*A]`` and compute pairwise *match counts* as one
  matrix product; ``distance = L - matches`` is thresholded and bitpacked
  on device, so only ``N*M/8`` bytes return to the host.
* **paired rows** (:func:`rowwise_within_packed`): XOR + nibble-collapse +
  population count over 4-bit-packed uint32 lanes (8 bases per lane).

Callers tile over groups/buckets; this module exposes jitted forms plus a
host orchestrator that emits within-distance index pairs.
"""

import functools
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from . import ROUTE_COUNTS
from .encode import UNASSIGNED, _pad_dims, onehot_flat, pack_bits


@functools.partial(jax.jit, static_argnames=("alphabet_size",))
def _match_counts(a: jax.Array, b: jax.Array, alphabet_size: int
                  ) -> jax.Array:
    """Pairwise match counts between index matrices a [N, L] and b [M, L]:
    one-hot rows, one matrix product."""
    return jax.lax.dot_general(
        onehot_flat(a, alphabet_size), onehot_flat(b, alphabet_size),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)


@functools.partial(jax.jit, static_argnames=("alphabet_size",))
def pairwise_hamming(a: jax.Array, b: jax.Array, alphabet_size: int
                     ) -> jax.Array:
    """int32 [N, M] Hamming distances between equal-length index rows."""
    return a.shape[1] - _match_counts(a, b, alphabet_size)


@functools.partial(jax.jit, static_argnames=("alphabet_size", "max_distance"))
def pairwise_within(a: jax.Array, b: jax.Array, alphabet_size: int,
                    max_distance: int) -> jax.Array:
    """bool [N, M]: Hamming(a_i, b_j) <= max_distance."""
    return pairwise_hamming(a, b, alphabet_size) <= max_distance


@functools.partial(jax.jit, static_argnames=("alphabet_size", "max_distance"))
def rowwise_within(a: jax.Array, b: jax.Array, alphabet_size: int,
                   max_distance: int) -> jax.Array:
    """bool [N]: Hamming(a_i, b_i) <= max_distance (paired rows)."""
    mismatches = jnp.sum(a != b, axis=1, dtype=jnp.int32)
    return mismatches <= max_distance


@functools.partial(jax.jit, static_argnames=("alphabet_pad",))
def within_tile_packed(a: jax.Array, b: jax.Array, scalars: jax.Array,
                       alphabet_pad: int) -> jax.Array:
    """uint8 [N, ceil(M/8)]: bitpacked all-pairs Hamming <= max_distance
    (little bit order along columns).

    ``a`` [N, Lp] / ``b`` [M, Lp]: alphabet indices padded with 0xFF, whose
    one-hot is all-zero, so pad rows and columns match nothing.
    ``scalars``: int32 [2] = (real length, max_distance), runtime values,
    so one compiled program per (N, M, Lp, Ap) serves every length and
    distance."""
    matches = _match_counts(a, b, alphabet_pad)
    return pack_bits((scalars[0] - matches) <= scalars[1])


def unpack_within(packed) -> np.ndarray:
    """Host-side expansion of a bitpacked tile to bool [N, 8*ceil(M/8)]."""
    return np.unpackbits(np.asarray(packed), axis=1,
                         bitorder="little").astype(bool)


# Pair-count padding quantum of the rowwise form: pair batches pad to a
# power-of-two multiple of it, bounding the compiled-shape family.
ROW_BLOCK = 8192


@functools.partial(jax.jit, static_argnames=("max_distance",))
def rowwise_within_packed(a: jax.Array, b: jax.Array,
                          max_distance: int) -> jax.Array:
    """bool [P]: paired-row packed Hamming <= max_distance.

    ``a``/``b``: uint32 [P, lanes] nibble-packed (see
    fastqdedup_tpu.ops.encode.pack_nibbles).  A nibble-wise OR-collapse
    maps every non-zero XOR nibble to exactly one set bit, so the
    population count is the mismatch count."""
    x = jax.lax.bitwise_xor(a, b)
    y = x | jax.lax.shift_right_logical(x, jnp.uint32(2))
    y = y | jax.lax.shift_right_logical(y, jnp.uint32(1))
    y = y & jnp.uint32(0x11111111)
    mism = jnp.sum(jax.lax.population_count(y).astype(jnp.int32), axis=1)
    return mism <= max_distance


def _pad_rows(matrix: np.ndarray, target: int) -> np.ndarray:
    if matrix.shape[0] == target:
        return matrix
    # 0xFF one-hots to all-zero, so padding rows match nothing — keeps the
    # host-side nonzero() from wading through pad-vs-pad hits.
    pad = np.full((target - matrix.shape[0], matrix.shape[1]), UNASSIGNED,
                  dtype=matrix.dtype)
    return np.concatenate([matrix, pad], axis=0)


def neighbor_pairs(matrix: np.ndarray, alphabet_size: int, max_distance: int,
                   tile: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
    """All index pairs (i < j) of rows of ``matrix`` within ``max_distance``.

    Tiles the [N, N] upper triangle at one fixed tile size (one compiled
    shape; the 2048 tile is untuned on the GPU); each tile runs on device
    and only its bitpacked adjacency returns to the host, where
    ``np.nonzero`` extracts pairs.  Returns two int64 arrays (rows_i,
    rows_j).
    """
    n, length = matrix.shape
    if n < 2:
        return (np.empty(0, dtype=np.int64),) * 2
    l_pad, a_pad = _pad_dims(length, alphabet_size)
    if l_pad != length:
        matrix = np.pad(matrix, ((0, 0), (0, l_pad - length)),
                        constant_values=UNASSIGNED)
    scalars = np.array([length, max_distance], dtype=np.int32)
    t = tile
    out_i: List[np.ndarray] = []
    out_j: List[np.ndarray] = []
    for i0 in range(0, n, t):
        a = _pad_rows(matrix[i0:i0 + t], t)
        for j0 in range(i0, n, t):
            b = _pad_rows(matrix[j0:j0 + t], t)
            within = unpack_within(within_tile_packed(a, b, scalars, a_pad))
            ROUTE_COUNTS["tile_calls"] += 1
            ii, jj = np.nonzero(within)
            ii = ii + i0
            jj = jj + j0
            keep = (ii < jj) & (ii < n) & (jj < n)
            out_i.append(ii[keep])
            out_j.append(jj[keep])
    if not out_i:
        return (np.empty(0, dtype=np.int64),) * 2
    return (np.concatenate(out_i).astype(np.int64),
            np.concatenate(out_j).astype(np.int64))


def verify_pairs(matrix: np.ndarray, pairs_i: np.ndarray,
                 pairs_j: np.ndarray, alphabet_size: int, max_distance: int,
                 batch: int = 1 << 20) -> np.ndarray:
    """bool mask over candidate pairs: full Hamming <= max_distance.

    Used after pigeonhole bucketing to verify candidates; rowwise (paired)
    comparison, so cost is O(pairs * L).  When the alphabet fits in 4 bits
    the XOR+popcount form runs over nibble-packed lanes (8 bases per
    uint32); otherwise an elementwise compare.
    """
    from .encode import pack_nibbles

    out = np.empty(len(pairs_i), dtype=bool)
    lanes = max(-(-matrix.shape[1] // 8), 1)
    for start in range(0, len(pairs_i), batch):
        sl = slice(start, start + batch)
        a = matrix[pairs_i[sl]]
        b = matrix[pairs_j[sl]]
        if alphabet_size <= 16:
            p = len(a)
            padded = -(-max(p, 1) // ROW_BLOCK) * ROW_BLOCK
            pa = np.zeros((padded, lanes), dtype=np.uint32)
            pb = np.zeros((padded, lanes), dtype=np.uint32)
            pa[:p] = pack_nibbles(a, lanes)
            pb[:p] = pack_nibbles(b, lanes)
            out[sl] = np.asarray(
                rowwise_within_packed(pa, pb, max_distance))[:p]
        else:
            out[sl] = np.asarray(
                rowwise_within(a, b, alphabet_size, max_distance))
    return out
