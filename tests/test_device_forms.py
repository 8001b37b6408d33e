"""Device forms of the distance predicates vs numpy and scalar references.

Every predicate is an integer one, so each form must agree exactly with
its reference.  The forms run here on the CPU backend; tests that take
the ``gpu`` fixture check what XLA makes of them on the card and run
there through ``chip_smoke.py``.
Semantics pinned: all-pairs and paired-row Hamming "within distance" per
the reference's distances.h:8-31, Levenshtein per distances.h:33-88.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fastqdedup_tpu.ops.bucket import _bucketed_within_padded
from fastqdedup_tpu.ops.encode import _pad_dims, pack_bits, pack_nibbles
from fastqdedup_tpu.ops.hamming import (
    ROW_BLOCK,
    neighbor_pairs,
    rowwise_within_packed,
    unpack_within,
    within_tile_packed,
)


@pytest.fixture
def gpu():
    """Skip unless JAX computes on a GPU: the test runs a kernel compiled
    for the card.  ``chip_smoke.py`` runs these tests on the chip (with
    --noconftest, so the fixture lives here)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the kernel has no CPU lowering")


def mutated_pair(rng, n, length, alphabet):
    a = rng.integers(0, alphabet, size=(n, length), dtype=np.uint8)
    b = a.copy()
    for i in range(n):
        for _ in range(rng.integers(0, 4)):
            b[i, rng.integers(length)] = rng.integers(alphabet)
    return a, b


def _tile(a, b, alphabet, max_distance):
    length = a.shape[1]
    l_pad, a_pad = _pad_dims(length, alphabet)
    pad = ((0, 0), (0, l_pad - length))
    scalars = np.array([length, max_distance], dtype=np.int32)
    packed = within_tile_packed(np.pad(a, pad, constant_values=0xFF),
                                np.pad(b, pad, constant_values=0xFF),
                                scalars, a_pad)
    return unpack_within(packed)[:, :b.shape[0]]


@pytest.mark.parametrize("length,alphabet,max_distance", [
    (24, 5, 1), (16, 4, 2), (31, 6, 0),
])
def test_within_tile_packed_matches_numpy(length, alphabet, max_distance):
    rng = np.random.default_rng(7)
    a, b = mutated_pair(rng, 128, length, alphabet)
    got = _tile(a, b, alphabet, max_distance)
    want = (a[:, None, :] != b[None, :, :]).sum(2) <= max_distance
    np.testing.assert_array_equal(got, want)


def test_neighbor_pairs_multi_tile_sweep():
    """Several tiles of the upper triangle, a ragged last tile padded
    with rows that match nothing."""
    rng = np.random.default_rng(8)
    a, b = mutated_pair(rng, 150, 12, 5)
    matrix = np.concatenate([a, b])
    ii, jj = neighbor_pairs(matrix, 5, 1, tile=128)
    near = (matrix[:, None, :] != matrix[None, :, :]).sum(2) <= 1
    wi, wj = np.nonzero(np.triu(near, k=1))
    assert sorted(zip(ii.tolist(), jj.tolist())) == \
        sorted(zip(wi.tolist(), wj.tolist()))


@pytest.mark.parametrize("buckets,size,length,max_distance", [
    (3, 128, 20, 1), (2, 256, 33, 2),
])
def test_bucketed_within_matches_numpy(buckets, size, length,
                                       max_distance):
    """Per-bucket all-pairs form vs brute force, including 0xFF pad rows
    (match nothing, not even each other) and a padded length."""
    rng = np.random.default_rng(9)
    l_pad, a_pad = _pad_dims(length, 5)
    batch = np.full((buckets, size, l_pad), 0xFF, dtype=np.uint8)
    fills = []
    for k in range(buckets):
        fill = int(rng.integers(2, size))
        a, _ = mutated_pair(rng, fill, length, 5)
        batch[k, :fill, :length] = a
        fills.append(fill)
    scalars = np.array([length, max_distance], dtype=np.int32)
    got = np.asarray(_bucketed_within_padded(batch, scalars, a_pad))
    assert got.shape == (buckets, size, size // 8)
    unpacked = np.unpackbits(got, axis=-1, bitorder="little")
    for k, fill in enumerate(fills):
        rows = batch[k, :fill, :length]
        want = (rows[:, None, :] != rows[None, :, :]).sum(2) <= max_distance
        np.testing.assert_array_equal(
            unpacked[k, :fill, :fill].astype(bool), want)
        assert not unpacked[k, fill:, :].any()
        assert not unpacked[k, :, fill:].any()


def test_pack_bits_round_trips_ragged_width():
    rng = np.random.default_rng(3)
    within = rng.random((4, 5, 13)) < 0.5
    packed = np.asarray(pack_bits(jnp.asarray(within)))
    assert packed.shape == (4, 5, 2)
    back = np.unpackbits(packed, axis=-1, bitorder="little")[..., :13]
    np.testing.assert_array_equal(back.astype(bool), within)


@pytest.mark.parametrize("length,max_distance", [(24, 1), (7, 2), (40, 0)])
def test_rowwise_within_packed_matches_numpy(length, max_distance):
    rng = np.random.default_rng(9)
    n = 100
    a, b = mutated_pair(rng, n, length, 5)
    lanes = max(-(-length // 8), 1)
    pa = np.zeros((ROW_BLOCK, lanes), dtype=np.uint32)
    pb = np.zeros((ROW_BLOCK, lanes), dtype=np.uint32)
    pa[:n] = pack_nibbles(a, lanes)
    pb[:n] = pack_nibbles(b, lanes)
    got = np.asarray(rowwise_within_packed(pa, pb, max_distance))[:n]
    want = (a != b).sum(1) <= max_distance
    np.testing.assert_array_equal(got, want)


def test_verify_pairs_uses_packed_form():
    from fastqdedup_tpu.ops.hamming import verify_pairs
    rng = np.random.default_rng(10)
    matrix = rng.integers(0, 5, size=(64, 20), dtype=np.uint8)
    pi = rng.integers(0, 64, size=500).astype(np.int64)
    pj = rng.integers(0, 64, size=500).astype(np.int64)
    got = verify_pairs(matrix, pi, pj, 5, 1)
    want = (matrix[pi] != matrix[pj]).sum(1) <= 1
    np.testing.assert_array_equal(got, want)


class TestBandedEdit:
    """Banded Levenshtein DP vs the scalar host oracle and the full-row
    DP (truth table from the reference's tests/test__distance.py:37-60)."""

    CASES = [
        ("", "", 0, True), ("A", "", 1, True), ("", "AB", 1, False),
        ("ABC", "ABC", 0, True), ("ABC", "ABD", 1, True),
        ("ABC", "ABD", 0, False), ("GC", "AAAGC", 2, False),
        ("GC", "AAAGC", 3, True), ("ABCDE", "ABDEF", 2, True),
        ("ABCDE", "ABDEF", 1, False), ("AAAA", "AAA", 1, True),
        ("AAAA", "AA", 1, False), ("ACGT", "AGCT", 2, True),
    ]

    @staticmethod
    def _encode(pairs, p=256):
        lmax = max(max((len(a) for a, b in pairs), default=1),
                   max((len(b) for a, b in pairs), default=1), 1)
        A = np.full((p, lmax), 0xFF, dtype=np.uint8)
        B = np.full((p, lmax), 0xEE, dtype=np.uint8)
        la = np.zeros(p, dtype=np.int32)
        lb = np.zeros(p, dtype=np.int32)
        for i, (a, b) in enumerate(pairs):
            A[i, :len(a)] = np.frombuffer(a.encode(), dtype=np.uint8)
            B[i, :len(b)] = np.frombuffer(b.encode(), dtype=np.uint8)
            la[i], lb[i] = len(a), len(b)
        return A, la, B, lb

    def _run(self, pairs, max_distance):
        from fastqdedup_tpu.ops.edit import banded_within_edit_distance
        out = banded_within_edit_distance(*self._encode(pairs),
                                          max_distance)
        return np.asarray(out)[:len(pairs)]

    @pytest.mark.parametrize("d", [0, 1, 2, 3])
    def test_truth_table(self, d):
        cases = [(a, b) for a, b, cd, _ in self.CASES if cd == d]
        wants = [w for a, b, cd, w in self.CASES if cd == d]
        got = self._run(cases, d)
        assert list(got) == wants

    @staticmethod
    def _fuzz_pairs(seed, count=64, max_len=12):
        rng = np.random.default_rng(seed)
        pairs = []
        for _ in range(count):
            la = rng.integers(0, max_len)
            a = "".join(rng.choice(list("ACGT")) for _ in range(la))
            b = list(a)
            for _ in range(rng.integers(0, 4)):
                op = rng.integers(3)
                if op == 0 and b:
                    b[rng.integers(len(b))] = rng.choice(list("ACGT"))
                elif op == 1 and b:
                    del b[rng.integers(len(b))]
                else:
                    b.insert(rng.integers(len(b) + 1),
                             rng.choice(list("ACGT")))
            pairs.append((a, "".join(b)))
        return pairs

    @pytest.mark.parametrize("d", [1, 2])
    def test_fuzz_against_scalar_oracle(self, d):
        from fastqdedup_tpu.distance import within_distance
        pairs = self._fuzz_pairs(11)
        got = self._run(pairs, d)
        want = [within_distance(a, b, d, use_edit_distance=True)
                for a, b in pairs]
        assert list(got) == want

    @pytest.mark.parametrize("d", [0, 1, 2, 3, 4])
    def test_matches_full_row_dp(self, d):
        """Every pair, against the exact distances of the full-row DP —
        longer keys and wider bands than the oracle fuzz."""
        from fastqdedup_tpu.ops.edit import batched_edit_distance
        pairs = self._fuzz_pairs(100 + d, count=256, max_len=40)
        A, la, B, lb = self._encode(pairs)
        want = np.asarray(batched_edit_distance(A, la, B, lb)) <= d
        got = self._run(pairs, d)
        np.testing.assert_array_equal(got, want[:len(pairs)])


def test_edit_verify_gathered_packed_matches_unpacked():
    """The nibble-packed resident-key verify path must agree with the
    unpacked path, and both with the scalar oracle, for every pair."""
    from fastqdedup_tpu.distance import within_distance
    from fastqdedup_tpu.ops.edit import (
        _edit_verify_gathered,
        _edit_verify_gathered_packed,
        pack_nibble_rows,
    )

    rng = np.random.default_rng(17)
    n, l_pad = 300, 32
    padded = np.full((n, l_pad), 0xFF, dtype=np.uint8)
    lens = rng.integers(20, l_pad - 2, n).astype(np.int32)
    for i in range(n):
        padded[i, :lens[i]] = rng.integers(0, 5, lens[i])
    # Plant near pairs so some verifications succeed.
    for i in range(0, n - 1, 3):
        lens[i + 1] = lens[i]
        padded[i + 1] = padded[i]
        padded[i + 1, rng.integers(lens[i])] = rng.integers(5)
    ci = rng.integers(0, n, 512).astype(np.int32)
    cj = rng.integers(0, n, 512).astype(np.int32)
    ref = np.asarray(_edit_verify_gathered(
        jnp.asarray(padded), jnp.asarray(lens),
        jnp.asarray(ci), jnp.asarray(cj), 1))
    got = np.asarray(_edit_verify_gathered_packed(
        jnp.asarray(pack_nibble_rows(padded)), jnp.asarray(lens),
        jnp.asarray(ci), jnp.asarray(cj), 1))
    assert (got == ref).all()
    strs = ["".join("ACGTN"[c] for c in padded[i, :lens[i]])
            for i in range(n)]
    want = [within_distance(strs[i], strs[j], 1, use_edit_distance=True)
            for i, j in zip(ci, cj)]
    assert list(ref) == want


def test_within_edit_distance_pads_to_canonical_geometry():
    """The row-pair entry point (used by contains_within) pads pair
    count and width and slices the answer back."""
    from fastqdedup_tpu.distance import within_distance
    from fastqdedup_tpu.ops.edit import within_edit_distance

    words = [("ACGTAC", "ACGAC"), ("ACGTAC", "TTGTAA"), ("", "A"),
             ("GATTACA", "GATTACA")]
    width = 7
    a = np.full((len(words), width), 0xFF, dtype=np.uint8)
    b = np.full((len(words), width), 0xFF, dtype=np.uint8)
    for i, (x, y) in enumerate(words):
        a[i, :len(x)] = np.frombuffer(x.encode(), dtype=np.uint8)
        b[i, :len(y)] = np.frombuffer(y.encode(), dtype=np.uint8)
    la = np.array([len(x) for x, _ in words])
    lb = np.array([len(y) for _, y in words])
    got = within_edit_distance(a, la, b, lb, 1)
    assert got.tolist() == [within_distance(x, y, 1, True)
                            for x, y in words]


# ---- platform choice ------------------------------------------------


def test_platform_is_cpu_here():
    from fastqdedup_tpu.runtime import platform
    assert platform() == "cpu"


def test_platform_refuses_other_backends(monkeypatch):
    from fastqdedup_tpu.runtime import platform
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        platform()


def _edit_entries(n_pairs=40, length=24, seed=5):
    """Engine entries for an edit-mode run: families of near keys of two
    lengths, plus the scalar oracle's edge set."""
    from fastqdedup_tpu.distance import within_distance
    from fastqdedup_tpu.engine import _entries_from_keys, _group_by_length
    from fastqdedup_tpu.ops.encode import EncodeTable
    rng = np.random.default_rng(seed)
    keys = []
    for _ in range(n_pairs):
        base = bytes(rng.choice(list(b"ACGT"), length))
        keys.append(base)
        pos = int(rng.integers(length))
        keys.append(base[:pos] + base[pos + 1:])          # deletion
        keys.append(base[:pos] + b"G" + base[pos + 1:])   # substitution
    keys = list(dict.fromkeys(keys))
    table = EncodeTable("ACGTN")
    entries = _entries_from_keys(keys, _group_by_length(keys), table)
    strs = [k.decode() for k in keys]
    want = {(i, j) for i in range(len(keys)) for j in range(i + 1, len(keys))
            if within_distance(strs[i], strs[j], 1, True)}
    return entries, len(keys), want


@pytest.mark.parametrize("h2d_rate,route", [
    ("1e12", "edit_batches"),     # fast link: keys resident on the card
    ("1", "edit_pairs_host"),     # slow link: the C verifier on the host
])
def test_engine_edit_gates_on_an_accelerator(monkeypatch, h2d_rate, route):
    """With the platform reported as "gpu", the edit path measures the
    host link and picks device-resident keys or the host C verifier;
    both give the oracle's edge set."""
    from fastqdedup_tpu import engine, runtime
    from fastqdedup_tpu.ops import ROUTE_COUNTS

    entries, n, want = _edit_entries()
    monkeypatch.setattr(runtime, "platform", lambda: "gpu")
    monkeypatch.setenv("FASTQDEDUP_H2D_RATE", h2d_rate)
    before = ROUTE_COUNTS[route]
    ei, ej = engine._edit_edges_entries(entries, n, 1)
    got = {(min(i, j), max(i, j)) for i, j in zip(ei.tolist(), ej.tolist())}
    assert got == want
    assert ROUTE_COUNTS[route] > before


def test_engine_edit_on_cpu_uses_resident_keys():
    """On the CPU backend the edit path skips the link probe and verifies
    through the banded DP on device-resident keys."""
    from fastqdedup_tpu import engine
    from fastqdedup_tpu.ops import ROUTE_COUNTS

    entries, n, want = _edit_entries(seed=6)
    before = ROUTE_COUNTS["edit_batches"]
    ei, ej = engine._edit_edges_entries(entries, n, 1)
    got = {(min(i, j), max(i, j)) for i, j in zip(ei.tolist(), ej.tolist())}
    assert got == want
    assert ROUTE_COUNTS["edit_batches"] > before


@pytest.mark.gpu
@pytest.mark.parametrize("size_class", [0, 128, 512, 2048])
def test_onehot_product_is_a_gemm_on_the_card(gpu, size_class):
    """XLA turns the one-hot product of the tile (size_class 0) and of
    every bucket size class into a GEMM (cuBLAS or a Triton GEMM fusion),
    not a loop fusion."""
    import re

    from fastqdedup_tpu.ops.bucket import _buckets_per_call
    scalars = np.array([100, 1], dtype=np.int32)
    if size_class:
        k = _buckets_per_call(size_class)
        batch = np.zeros((k, size_class, 112), dtype=np.uint8)
        hlo = _bucketed_within_padded.lower(
            batch, scalars, alphabet_pad=5).compile().as_text()
    else:
        a = np.zeros((2048, 112), dtype=np.uint8)
        hlo = within_tile_packed.lower(
            a, a, scalars, alphabet_pad=5).compile().as_text()
    targets = re.findall(r'custom_call_target="([^"]+)"', hlo) + \
        re.findall(r'"kind":"([^"]+)"', hlo)
    assert any("gemm" in t or "matmul" in t for t in targets), targets


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 2])
def test_banded_dp_on_the_card_matches_full_row_dp(gpu, d):
    """The banded DP as compiled for the card, at the production width
    (Lp = 112), agrees bit for bit with the full-row DP."""
    from fastqdedup_tpu.ops.edit import (
        banded_within_edit_distance,
        batched_edit_distance,
    )
    rng = np.random.default_rng(d)
    p, length = 1 << 14, 112
    a = rng.integers(0, 4, size=(p, length), dtype=np.uint8)
    b = a.copy()
    rows = np.arange(p)
    for _ in range(d + 1):
        b[rows, rng.integers(0, length, p)] = rng.integers(0, 4, p)
    la = rng.integers(length - 12, length + 1, p).astype(np.int32)
    lb = np.clip(la + rng.integers(-d - 1, d + 2, p), 0, length)
    lb = lb.astype(np.int32)
    want = np.asarray(batched_edit_distance(a, la, b, lb)) <= d
    got = np.asarray(banded_within_edit_distance(a, la, b, lb, d))
    np.testing.assert_array_equal(got, want)
    assert 0 < want.mean() < 1


# ---- compile cache placement ------------------------------------------


@pytest.fixture
def fresh_jax_config(monkeypatch):
    """Let configure_jax run again, and restore the cache settings."""
    from fastqdedup_tpu import runtime
    from jax._src import compilation_cache

    saved = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(runtime, "_configured", False)
    yield runtime
    jax.config.update("jax_compilation_cache_dir", saved)
    compilation_cache.reset_cache()


def test_compile_cache_follows_env_var(fresh_jax_config, monkeypatch,
                                       tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the cache is written there only."""
    from jax._src import compilation_cache

    runtime = fresh_jax_config
    target = tmp_path / "cache"
    # A default of this test's own, so other workers' compiles into the
    # shared checkout cache cannot show up in it.
    default = tmp_path / "default"
    monkeypatch.setattr(runtime, "DEFAULT_CACHE_DIR", str(default))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    runtime.configure_jax()
    assert jax.config.jax_compilation_cache_dir == str(target)
    compilation_cache.reset_cache()
    # A program no other test compiles, so the write is a fresh entry.
    jax.jit(lambda x: x * 3 + 11)(jnp.arange(17.0)).block_until_ready()
    assert os.listdir(target), "nothing was cached in the chosen dir"
    assert not default.exists(), "the default dir was used as well"


def test_compile_cache_defaults_to_checkout(fresh_jax_config,
                                            monkeypatch):
    """JAX_COMPILATION_CACHE_DIR unset: a fixed, gitignored path inside
    the checkout — no home directory, temp name, pid or time in it."""
    runtime = fresh_jax_config
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    runtime.configure_jax()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jax.config.jax_compilation_cache_dir == \
        os.path.join(repo, ".jax_cache")
    assert runtime.compile_cache_dir() == runtime.DEFAULT_CACHE_DIR
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
