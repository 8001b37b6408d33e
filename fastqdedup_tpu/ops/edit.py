"""Batched bounded Levenshtein (edit) distance on device.

Replaces the reference's recursive branch-and-bound (distances.h:33-88)
with a banded dynamic program: for ``lev(a, b) <= d`` only the diagonal
band ``|i - j| <= d`` of the DP matrix matters, so each pair carries a
band of ``W = 2d + 1`` cells down the rows of the edit matrix, vectorized
across a batch of pairs.  Variable lengths are handled by capturing the
band cell of ``(len_a, len_b)`` as the row loop passes ``len_a``.

:func:`banded_within_edit_distance` is plain JAX (a ``lax.fori_loop`` over
the rows) that XLA compiles for the GPU and the CPU alike; a hand-written
Triton kernel of the same DP was 14x faster per batch on an H100 but no
faster end to end, and was removed (PERF.md, "Kernels on the H100").
:func:`batched_edit_distance`, the full-row O(L^2) DP that returns exact
distances, is the reference the tests check it against.

Semantics pinned by /root/reference/tests/test__distance.py:37-60 (e.g.
lev("GC", "AAAGC") == 3, lev("ABCDE", "ABDEF") == 2).
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp

from . import ROUTE_COUNTS

# Pair-batch geometries of the verifier: batches pad to PAIR_BLOCK (tiny
# runs) or to a multiple of EDIT_VERIFY_BATCH, so a run compiles at most
# two programs per (Lp, d).
PAIR_BLOCK = 4096
EDIT_VERIFY_BATCH = 1 << 16

_INF = 1 << 20


@jax.jit
def batched_edit_distance(a: jax.Array, len_a: jax.Array,
                          b: jax.Array, len_b: jax.Array) -> jax.Array:
    """int32 [P] Levenshtein distances between padded index-row pairs
    (full-row DP; the reference the banded DP is tested against).

    ``a``: [P, L1] uint8/int32 alphabet indices, valid prefix ``len_a``.
    ``b``: [P, L2] likewise.  Padding values are ignored.
    """
    p, l1 = a.shape
    l2 = b.shape[1]
    len_a = len_a.astype(jnp.int32)
    len_b = len_b.astype(jnp.int32)
    a = a.astype(jnp.int32)
    b = b.astype(jnp.int32)

    js = jnp.arange(l2 + 1, dtype=jnp.int32)  # [L2+1]
    row0 = jnp.broadcast_to(js, (p, l2 + 1))  # dp[0, j] = j
    # Answer for len_a == 0 is len_b.
    result0 = jnp.where(len_a == 0, len_b, jnp.int32(0))

    def step(carry, i):
        prev_row, result = carry
        # Row i: dp[i, 0] = i.
        chars_a = a[:, i - 1]  # [P]
        eq = chars_a[:, None] == b  # [P, L2]
        sub = prev_row[:, :-1] + jnp.where(eq, 0, 1)  # substitution/match
        delete = prev_row[:, 1:] + 1                   # remove from a
        best_nolateral = jnp.minimum(sub, delete)      # [P, L2]
        # Insertion (dp[i, j-1] + 1) creates a left-to-right dependence;
        # resolve it with an associative prefix-min scan over j:
        #   dp[i, j] = min_k ( cand[k] + (j - k) )  for k <= j
        # where cand[j] = min(sub, delete) and cand[0] = i.
        cand = jnp.concatenate(
            [jnp.full((p, 1), i, dtype=jnp.int32), best_nolateral], axis=1)
        shifted = cand - js[None, :]
        running = jax.lax.associative_scan(jnp.minimum, shifted, axis=1)
        row = running + js[None, :]
        result = jnp.where(i == len_a, row[jnp.arange(p), len_b], result)
        return (row, result), None

    (_, result), _ = jax.lax.scan(
        step, (row0, result0), jnp.arange(1, l1 + 1, dtype=jnp.int32))
    return result


@functools.partial(jax.jit, static_argnames=("max_distance",))
def banded_within_edit_distance(a: jax.Array, len_a: jax.Array,
                                b: jax.Array, len_b: jax.Array,
                                max_distance: int) -> jax.Array:
    """bool [P]: lev(a_p[:len_a_p], b_p[:len_b_p]) <= max_distance.

    ``a``/``b``: uint8 [P, L] with the same L (padding arbitrary);
    ``len_a``/``len_b``: [P].  Pairs with |len_a - len_b| > max_distance
    are False by construction.

    Band coordinates: ``band[k]`` holds ``dp[i][j]`` with ``j = i - d + k``.
    Moving from row i-1 to i, the diagonal (substitution) predecessor
    keeps index k, deletion (``dp[i-1][j]``) is k+1 and insertion
    (``dp[i][j-1]``) is k-1.  ``window[k]`` holds ``b[j - 1]`` for the
    cell ``j = i - d + k``, so each row reads one new row of ``b``; rows
    outside [0, L) are clamped, as they only meet invalid cells.  As the
    loop passes ``i == len_a`` the cell ``(len_a, len_b)`` is captured.
    """
    d = max_distance
    w = 2 * d + 1
    length = a.shape[1]
    a_t = a.T
    b_t = b.T
    la = len_a.astype(jnp.int32)
    lb = len_b.astype(jnp.int32)
    # Row 0: dp[0][j] = j for j >= 0; a pair with la == 0 has distance lb.
    band = tuple(jnp.full_like(la, k - d if k >= d else _INF)
                 for k in range(w))
    result = jnp.where(la == 0, lb, jnp.full_like(la, _INF))
    window = tuple(b_t[min(max(k - d - 1, 0), length - 1)]
                   for k in range(w))

    def row(i, carry):
        band, window, result = carry
        ai = jax.lax.dynamic_index_in_dim(a_t, i - 1, keepdims=False)
        newest = jax.lax.dynamic_index_in_dim(
            b_t, jnp.clip(i + d - 1, 0, length - 1), keepdims=False)
        window = window[1:] + (newest,)
        cells = []
        left = None
        for k in range(w):
            j = i - d + k
            best = band[k] + jnp.where(ai == window[k], 0, 1)
            if k + 1 < w:
                best = jnp.minimum(best, band[k + 1] + 1)
            if left is not None:
                best = jnp.minimum(best, left + 1)
            # Cells outside [1, lb] are invalid; dp[i][0] = i sits on the
            # band's left edge while j == 0.
            best = jnp.where((j < 1) | (j > lb), _INF, best)
            best = jnp.where(j == 0, i, best)
            left = best
            cells.append(best)
        target_k = lb - la + d
        gathered = jnp.full_like(result, _INF)
        for k in range(w):
            gathered = jnp.where(target_k == k, cells[k], gathered)
        return tuple(cells), window, jnp.where(la == i, gathered, result)

    _, _, result = jax.lax.fori_loop(1, length + 1, row,
                                     (band, window, result))
    return result <= d


@functools.partial(jax.jit, static_argnames=("max_distance",))
def _edit_verify_gathered(keys: jax.Array, lens: jax.Array,
                          ci: jax.Array, cj: jax.Array,
                          max_distance: int) -> jax.Array:
    """bool [P]: banded verification of key-index pairs, gathered on
    device.  ``keys`` [n, Lp] uint8 (Lp a multiple of 16) and ``lens``
    [n] int32 are device-resident; only the int32 index pairs cross the
    host-device boundary per batch."""
    return banded_within_edit_distance(keys[ci], lens[ci], keys[cj],
                                       lens[cj], max_distance)


@functools.partial(jax.jit, static_argnames=("max_distance",))
def _edit_verify_gathered_packed(keys2: jax.Array, lens: jax.Array,
                                 ci: jax.Array, cj: jax.Array,
                                 max_distance: int) -> jax.Array:
    """Nibble-packed variant: ``keys2`` [n, Lp/2] holds two alphabet
    indices per byte (even column in the high nibble).  The resident key
    matrix ships at half size and unpacks per gathered batch on device
    (one shift/mask/stack)."""

    def unpack(g: jax.Array) -> jax.Array:
        p, half = g.shape
        pair = jnp.stack([g >> 4, g & jnp.uint8(0xF)], axis=-1)
        return pair.reshape(p, half * 2)

    return banded_within_edit_distance(unpack(keys2[ci]), lens[ci],
                                       unpack(keys2[cj]), lens[cj],
                                       max_distance)


def pack_nibble_rows(padded: np.ndarray) -> np.ndarray:
    """uint8 [n, L] -> [n, L/2] with two values per byte (L even).

    Valid only when every value fits 4 bits; the engine maps its 0xFF
    padding byte to 15 first (pad positions are never read by the DP —
    the banded scan stops at len_a/len_b)."""
    nib = np.where(padded == 0xFF, np.uint8(15), padded)
    return ((nib[:, ::2] << 4) | nib[:, 1::2]).astype(np.uint8)


def _padded_pairs(p: int) -> int:
    return PAIR_BLOCK if p <= PAIR_BLOCK \
        else -(-p // EDIT_VERIFY_BATCH) * EDIT_VERIFY_BATCH


def edit_verify_indexed(keys_dev, lens_dev, cand_i, cand_j,
                        max_distance: int,
                        packed: bool = False) -> np.ndarray:
    """bool [P]: lev(keys[i], keys[j]) <= d for index pairs, device gather.

    The padded key matrix is shipped (or resident) once and each batch
    sends 8 bytes/pair of indices instead of ~2 L bytes/pair of gathered
    rows.  Indices are padded to the canonical pair-count geometries with
    pair (0, 0), which verifies trivially and is sliced off.
    """
    p = len(cand_i)
    if p == 0:
        return np.empty(0, dtype=bool)
    padded = _padded_pairs(p)
    ci = np.zeros(padded, dtype=np.int32)
    cj = np.zeros(padded, dtype=np.int32)
    ci[:p] = cand_i
    cj[:p] = cand_j
    fn = _edit_verify_gathered_packed if packed else _edit_verify_gathered
    out = fn(keys_dev, lens_dev, jnp.asarray(ci), jnp.asarray(cj),
             max_distance)
    ROUTE_COUNTS["edit_batches"] += 1
    return np.asarray(out[:p])


def within_edit_distance(a, len_a, b, len_b,
                         max_distance: int) -> np.ndarray:
    """bool [P]: lev(a_i, b_i) <= max_distance for row pairs of equal
    padded width, through the banded DP.  Pair count and
    width pad to the canonical geometries (pad characters are never read:
    the DP stops at len_a/len_b)."""
    a = np.asarray(a)
    p, length = a.shape
    padded = _padded_pairs(p)
    l_pad = max(-(-length // 16) * 16, 16)
    pad = ((0, padded - p), (0, l_pad - length))
    a = np.pad(a, pad)
    b = np.pad(np.asarray(b), pad)
    la = np.pad(np.asarray(len_a, dtype=np.int32), (0, padded - p))
    lb = np.pad(np.asarray(len_b, dtype=np.int32), (0, padded - p))
    out = banded_within_edit_distance(a, jnp.asarray(la), b,
                                      jnp.asarray(lb), max_distance)
    return np.asarray(out[:p])
