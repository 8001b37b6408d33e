"""Dense clustering engine tests: kernel paths vs brute-force oracle."""

import random

import numpy as np
import pytest

from fastqdedup_tpu.engine import build_clusters
from fastqdedup_tpu.distance import within_distance
from fastqdedup_tpu.ops.bucket import hamming_neighbor_pairs_bucketed
from fastqdedup_tpu.ops.encode import EncodeTable, keys_to_matrix
from fastqdedup_tpu.ops.hamming import neighbor_pairs


def _random_keys(rng, n, length, alphabet="ACGT", mutate_from=None):
    keys = []
    for _ in range(n):
        if mutate_from and rng.random() < 0.7:
            base = list(rng.choice(mutate_from))
            pos = rng.randrange(len(base))
            base[pos] = rng.choice(alphabet)
            keys.append("".join(base).encode())
        else:
            keys.append("".join(rng.choice(alphabet)
                                for _ in range(length)).encode())
            if mutate_from is not None:
                mutate_from.append(keys[-1].decode())
    return keys


def _oracle_components(keys, max_distance, use_edit):
    n = len(keys)
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    strings = [k.decode() for k in keys]
    for i in range(n):
        for j in range(i + 1, n):
            if within_distance(strings[i], strings[j], max_distance,
                               use_edit):
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[ri] = rj
    comps = {}
    for i in range(n):
        comps.setdefault(find(i), set()).add(keys[i])
    return sorted([frozenset(v) for v in comps.values()], key=sorted)


def _engine_components(clusters):
    return sorted([frozenset(c.keys) for c in clusters], key=sorted)


@pytest.mark.parametrize("d", [1, 2])
def test_neighbor_pairs_vs_bruteforce(d):
    rng = random.Random(7 + d)
    seeds = []
    keys = _random_keys(rng, 300, 12, mutate_from=seeds)
    keys = list(dict.fromkeys(keys))  # unique
    table = EncodeTable("ACGTN")
    matrix, _ = keys_to_matrix(keys, table)
    ii, jj = neighbor_pairs(matrix, table.size, d, tile=128)
    got = set(zip(ii.tolist(), jj.tolist()))
    expected = set()
    for i in range(len(keys)):
        for j in range(i + 1, len(keys)):
            if within_distance(keys[i].decode(), keys[j].decode(), d):
                expected.add((i, j))
    assert got == expected


@pytest.mark.parametrize("d", [1, 2])
def test_bucketed_pairs_vs_bruteforce(d):
    rng = random.Random(77 + d)
    seeds = []
    keys = _random_keys(rng, 500, 10, mutate_from=seeds)
    keys = list(dict.fromkeys(keys))
    table = EncodeTable("ACGTN")
    matrix, _ = keys_to_matrix(keys, table)
    ii, jj = hamming_neighbor_pairs_bucketed(matrix, table.size, d)
    got = set(zip(ii.tolist(), jj.tolist()))
    expected = set()
    for i in range(len(keys)):
        for j in range(i + 1, len(keys)):
            if within_distance(keys[i].decode(), keys[j].decode(), d):
                expected.add((i, j))
    assert got == expected


def test_bucketed_handles_large_buckets():
    # Keys sharing one segment exactly force oversized buckets.
    rng = random.Random(5)
    keys = set()
    while len(keys) < 600:
        keys.add(b"ACGTACGT" + "".join(
            rng.choice("ACGT") for _ in range(8)).encode())
    keys = sorted(keys)
    table = EncodeTable("ACGTN")
    matrix, _ = keys_to_matrix(keys, table)
    ii, jj = hamming_neighbor_pairs_bucketed(
        matrix, table.size, 1, large_bucket_threshold=128)
    got = set(zip(ii.tolist(), jj.tolist()))
    expected = set()
    for i in range(len(keys)):
        for j in range(i + 1, len(keys)):
            if within_distance(keys[i].decode(), keys[j].decode(), 1):
                expected.add((i, j))
    assert got == expected


def test_bucketed_raw_bytes_with_lut_matches_encoded():
    # Raw-byte matrix + encode_lut must yield the same pair set as the
    # pre-encoded matrix: bucketing/hashing are representation-invariant
    # and the LUT translates only kernel-bound rows.
    rng = random.Random(99)
    keys = list(dict.fromkeys(_random_keys(rng, 500, 10, mutate_from=[])))
    table = EncodeTable("ACGTN")
    encoded, _ = keys_to_matrix(keys, table)
    raw = np.frombuffer(b"".join(keys), dtype=np.uint8) \
        .reshape(len(keys), 10)
    for threshold in (2048, 64):  # large: device classes; small: oversized
        ref = hamming_neighbor_pairs_bucketed(
            encoded, table.size, 2, large_bucket_threshold=threshold)
        got = hamming_neighbor_pairs_bucketed(
            raw, table.size, 2, large_bucket_threshold=threshold,
            encode_lut=table.table)
        assert set(zip(*map(np.ndarray.tolist, got))) == \
            set(zip(*map(np.ndarray.tolist, ref)))


def test_build_clusters_tolerates_0xff_key_bytes():
    # Byte 0xFF collides with the padding sentinel; _encode_entries must
    # fall back to index matrices and still match the scalar oracle.
    rng = random.Random(3)
    base = bytes(rng.choice(b"\x41\x43\x47\x54\xff") for _ in range(12))
    keys = {base}
    while len(keys) < 80:
        k = bytearray(base)
        for _ in range(rng.randrange(1, 4)):
            k[rng.randrange(12)] = rng.choice(b"\x41\x43\x47\x54\xff")
        keys.add(bytes(k))
    keys = sorted(keys)
    clusters = build_clusters(keys, [1] * len(keys), max_distance=1)
    member_of = {}
    for c in clusters:
        for k in c.keys:
            member_of[k] = c
    for i, a in enumerate(keys):
        for j in range(i + 1, len(keys)):
            b = keys[j]
            d = sum(x != y for x, y in zip(a, b))
            if d <= 1:
                assert member_of[a] is member_of[b], (a, b)


@pytest.mark.parametrize("use_edit", [False, True])
def test_build_clusters_matches_oracle(use_edit):
    rng = random.Random(13 + use_edit)
    seeds = []
    keys = _random_keys(rng, 150, 8, mutate_from=seeds)
    if use_edit:  # add some length-varying keys
        keys += [k[:-1] for k in keys[:30]] + [k + b"A" for k in keys[30:50]]
    keys = list(dict.fromkeys(keys))
    counts = [rng.randrange(1, 5) for _ in keys]
    clusters = build_clusters(keys, counts, 1, use_edit)
    assert _engine_components(clusters) == _oracle_components(keys, 1,
                                                              use_edit)
    # Counts preserved per key.
    count_map = dict(zip(keys, counts))
    for cluster in clusters:
        for key, count in zip(cluster.keys, cluster.counts):
            assert count_map[key] == count
    # Edges are exactly the within-distance pairs inside each cluster.
    for cluster in clusters:
        strings = [k.decode() for k in cluster.keys]
        for i in range(len(strings)):
            for j in range(i + 1, len(strings)):
                expected = within_distance(strings[i], strings[j], 1,
                                           use_edit)
                assert ((i, j) in cluster.edges) == expected


def test_build_clusters_distance_zero():
    keys = [b"AAAA", b"AAAT", b"CCCC"]
    clusters = build_clusters(keys, [2, 1, 1], 0)
    assert sorted(frozenset(c.keys) for c in clusters) == \
        sorted(frozenset({k}) for k in keys)


def test_verify_pairs_rowwise():
    from fastqdedup_tpu.ops.hamming import verify_pairs
    table = EncodeTable("ACGTN")
    keys = [b"AAAA", b"AAAT", b"AATT", b"CCCC"]
    matrix, _ = keys_to_matrix(keys, table)
    pi = np.array([0, 0, 0])
    pj = np.array([1, 2, 3])
    mask = verify_pairs(matrix, pi, pj, table.size, 1)
    assert mask.tolist() == [True, False, False]


def test_edit_kernel_batch_matches_scalar():
    from fastqdedup_tpu.ops.edit import batched_edit_distance
    rng = random.Random(3)
    table = EncodeTable("ACGTN")
    pairs = []
    for _ in range(64):
        a = "".join(rng.choice("ACGT") for _ in range(rng.randrange(1, 10)))
        b = "".join(rng.choice("ACGT") for _ in range(rng.randrange(1, 10)))
        pairs.append((a, b))
    lmax = max(max(len(a), len(b)) for a, b in pairs)
    pa = np.full((len(pairs), lmax), 0xFF, dtype=np.uint8)
    pb = np.full((len(pairs), lmax), 0xFF, dtype=np.uint8)
    la = np.zeros(len(pairs), dtype=np.int64)
    lb = np.zeros(len(pairs), dtype=np.int64)
    for i, (a, b) in enumerate(pairs):
        pa[i, :len(a)] = table.encode(np.frombuffer(a.encode(), np.uint8))
        pb[i, :len(b)] = table.encode(np.frombuffer(b.encode(), np.uint8))
        la[i], lb[i] = len(a), len(b)
    got = np.asarray(batched_edit_distance(pa, la, pb, lb))

    def full_lev(a, b):
        dp = list(range(len(b) + 1))
        for i, ca in enumerate(a, 1):
            prev, dp[0] = dp[0], i
            for j, cb in enumerate(b, 1):
                cur = dp[j]
                dp[j] = min(prev + (ca != cb), dp[j] + 1, dp[j - 1] + 1)
                prev = cur
        return dp[-1]

    for i, (a, b) in enumerate(pairs):
        assert got[i] == full_lev(a, b), (a, b)


def test_hamming_pair_code_limit_documented():
    """The i*n+j int64 packing refuses key counts that would wrap."""
    import numpy as np
    import pytest

    from fastqdedup_tpu.ops import bucket

    matrix = np.zeros((4, 8), dtype=np.uint8)
    fake = bucket._HAMMING_PAIR_CODE_LIMIT

    class _Huge(np.ndarray):
        @property
        def shape(self):
            return (fake + 1, 8)

    huge = matrix.view(_Huge)
    with pytest.raises(OverflowError, match="equal-length unique keys"):
        bucket.hamming_neighbor_pairs_bucketed(huge, 5, 1)


def test_edit_pair_code_limit_documented():
    """Edit-mode i*2^31+j packing refuses global indices >= 2^31."""
    import numpy as np
    import pytest

    from fastqdedup_tpu.ops import bucket

    matrix = np.zeros((2, 8), dtype=np.uint8)
    gidx = np.asarray([0, bucket._PAIR_BASE + 5], dtype=np.int64)
    with pytest.raises(OverflowError, match="edit-mode pair encoding"):
        bucket.edit_candidate_pairs([matrix], [gidx], 1)


def test_host_device_crossover_moves_with_dispatch_cost(monkeypatch):
    """The host-bucket cap is derived from measured rates: an expensive
    dispatch pushes small buckets onto the host; a free dispatch pulls
    them onto the device."""
    import numpy as np

    from fastqdedup_tpu.ops import bucket

    # Histogram: a moderate count of 60-member buckets — enough host
    # work that a cheap dispatch favors the device, little enough that
    # an expensive dispatch favors staying on host.
    sizes = np.full(100, 60, dtype=np.int64)
    monkeypatch.setenv("FASTQDEDUP_HOST_RATE", "2e9")
    monkeypatch.setenv("FASTQDEDUP_DISPATCH_S", "0.5")   # pathological link
    slow_cap = bucket.choose_host_bucket_cap(sizes, 100, 2048)
    monkeypatch.setenv("FASTQDEDUP_DISPATCH_S", "0.0000001")  # local chip
    fast_cap = bucket.choose_host_bucket_cap(sizes, 100, 2048)
    assert slow_cap >= 60, slow_cap      # slow link: keep them on host
    assert fast_cap < 60, fast_cap       # local: ship them to the device
    assert fast_cap < slow_cap


def test_pair_source_fraction_logged(caplog):
    """DEBUG output reports how many pairs were verified on host vs
    device."""
    import logging

    import numpy as np

    from fastqdedup_tpu.ops.bucket import hamming_neighbor_pairs_bucketed

    rng = np.random.default_rng(5)
    matrix = rng.integers(0, 5, size=(400, 24), dtype=np.uint8)
    matrix[200:] = matrix[:200]  # guarantee pairs
    with caplog.at_level(logging.DEBUG, logger="fastqdedup"):
        ii, jj = hamming_neighbor_pairs_bucketed(matrix, 5, 1)
    assert len(ii)
    assert any("pairs host=" in rec.message and "on device" in rec.message
               for rec in caplog.records)


def test_partition_assemble_native_matches_argsort_grouping():
    """The O(n) counting-sort assembly must reproduce the stable-argsort
    grouping bit for bit (order, starts/ends, cluster ids, local ranks)."""
    pytest.importorskip("fastqdedup_tpu.native.loader")
    from fastqdedup_tpu.native.loader import partition_assemble_native

    rng = np.random.default_rng(42)
    for n in (1, 2, 7, 1000):
        # Component-min labels: build from random merges via union-find
        # to match production label structure.
        from fastqdedup_tpu.ops.components import connected_components_host
        e = max(n // 2, 1)
        ei = rng.integers(0, n, size=e).astype(np.int64)
        ej = rng.integers(0, n, size=e).astype(np.int64)
        labels = connected_components_host(n, ei, ej)
        order, starts, ends, cluster_of, local_index = \
            partition_assemble_native(labels)

        ref_order = np.argsort(labels, kind="stable")
        sorted_labels = labels[ref_order]
        boundaries = np.flatnonzero(np.diff(sorted_labels)) + 1
        ref_starts = np.concatenate([[0], boundaries])
        ref_ends = np.concatenate([boundaries, [n]])
        sizes = ref_ends - ref_starts
        ref_cluster = np.empty(n, dtype=np.int64)
        ref_cluster[ref_order] = np.repeat(
            np.arange(len(ref_starts), dtype=np.int64), sizes)
        ref_local = np.empty(n, dtype=np.int64)
        ref_local[ref_order] = np.arange(n, dtype=np.int64) - \
            np.repeat(ref_starts, sizes)

        np.testing.assert_array_equal(order, ref_order)
        np.testing.assert_array_equal(starts, ref_starts)
        np.testing.assert_array_equal(ends, ref_ends)
        np.testing.assert_array_equal(cluster_of, ref_cluster)
        np.testing.assert_array_equal(local_index, ref_local)


def _bruteforce_pairs(keys, d):
    expected = set()
    for i in range(len(keys)):
        for j in range(i + 1, len(keys)):
            if within_distance(keys[i].decode(), keys[j].decode(), d):
                expected.add((i, j))
    return expected


@pytest.mark.parametrize("d", [1, 2])
def test_bucketed_complement_device_classes(monkeypatch, d):
    """Segment-complement comparison through the batched size classes.

    Keys share pigeonhole segments heavily, so buckets exceed the host
    cap (forced to its minimum) and route through
    _launch_bucket_batches with exclude_cols — the pair set must still
    match brute force exactly.
    """
    monkeypatch.setenv("FASTQDEDUP_DISPATCH_S", "1e-9")
    rng = random.Random(3 + d)
    length = 12
    common = [
        "".join(rng.choice("ACGT") for _ in range(length))
        for _ in range(3)
    ]
    keys = []
    for base in common:
        for _ in range(80):
            row = list(base)
            # Mutate only one half so one segment stays shared and the
            # bucket grows past every host cap candidate.
            pos = rng.randrange(length // 2, length)
            row[pos] = rng.choice("ACGT")
            keys.append("".join(row).encode())
    keys = list(dict.fromkeys(keys))
    table = EncodeTable("ACGTN")
    matrix, _ = keys_to_matrix(keys, table)
    ii, jj = hamming_neighbor_pairs_bucketed(matrix, table.size, d,
                                             large_bucket_threshold=2048)
    got = set(zip(ii.tolist(), jj.tolist()))
    assert got == _bruteforce_pairs(keys, d)


@pytest.mark.parametrize("path", ["classes", "oversized"])
def test_bucketed_complement_exact_under_hash_collisions(monkeypatch, path):
    """Bucket hashes are allowed to collide: different segment contents
    landing in one bucket must NOT produce false pairs now that kernels
    compare only the segment complement (the per-pair segment re-check
    in _drain_bucket_batches / the oversized sweep prunes them)."""
    import fastqdedup_tpu.ops.bucket as bucket_mod

    def weak_hash(window, salt, strong=True):
        # 4 possible values: massive collisions between distinct
        # segment contents, but still deterministic (equal contents
        # always collide, preserving completeness).
        return (window.astype(np.uint64).sum(axis=1) % np.uint64(4))

    monkeypatch.setattr(bucket_mod, "_hash_window_rows", weak_hash)
    monkeypatch.setenv("FASTQDEDUP_DISPATCH_S", "1e-9")
    rng = random.Random(11)
    length = 10
    keys = list(dict.fromkeys(
        "".join(rng.choice("ACGT") for _ in range(length)).encode()
        for _ in range(400)))
    table = EncodeTable("ACGTN")
    matrix, _ = keys_to_matrix(keys, table)
    threshold = 2048 if path == "classes" else 8
    ii, jj = hamming_neighbor_pairs_bucketed(
        matrix, table.size, 1, large_bucket_threshold=threshold)
    got = set(zip(ii.tolist(), jj.tolist()))
    assert got == _bruteforce_pairs(keys, 1)


def test_bucket_slices_composite_radix_contract():
    """The composite radix grouping path may MERGE hash runs (truncated
    high bits) but must never split one — exactness then follows from
    the per-pair verification, as for the bucket hash itself."""
    import fastqdedup_tpu.native.loader as loader_mod
    import fastqdedup_tpu.ops.bucket as bucket_mod

    if not hasattr(loader_mod, "radix_sort_u64_native"):
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(31)
    h = rng.integers(0, 2**63, 1 << 20, dtype=np.int64).view(np.uint64)
    h[1::3] = h[::3][:len(h[1::3])]  # plant duplicate runs
    o1, s1, e1 = bucket_mod._bucket_slices_of_hashes(h)
    saved = loader_mod.radix_sort_u64_native
    del loader_mod.radix_sort_u64_native
    try:
        o2, s2, e2 = bucket_mod._bucket_slices_of_hashes(h)
    finally:
        loader_mod.radix_sort_u64_native = saved
    comp_run_of = np.empty(len(h), dtype=np.int64)
    for r, (a, b) in enumerate(zip(s1, e1)):
        comp_run_of[o1[a:b]] = r
    for a, b in zip(s2, e2):
        assert len(np.unique(comp_run_of[o2[a:b]])) == 1
    # Sorted radix output parity while we are here.
    v = rng.integers(0, 2**63, 65536, dtype=np.int64).view(np.uint64)
    assert (saved(v.copy()) == np.sort(v)).all()


def test_edit_candidate_completeness_brute_force():
    """Every true lev<=1 pair (substitutions, insertions, deletions,
    across lengths) must appear among the generated candidates — the
    pigeonhole argument with the probe-left join (window rows that
    coincide with a matrix's own probe segments are dropped; probes
    pair against later probes in the run instead)."""
    import numpy as np

    from fastqdedup_tpu.distance import within_distance
    from fastqdedup_tpu.ops.bucket import edit_candidate_pairs

    rng = np.random.default_rng(5)
    keys = []
    for length in (12, 13):
        for _ in range(40):
            m = rng.integers(0, 4, size=length, dtype=np.uint8)
            keys.append(m)
            v = m.copy()
            v[rng.integers(0, len(v))] = rng.integers(0, 4)
            keys.append(v)                                     # sub
            keys.append(np.delete(m, rng.integers(0, len(m))))  # del
            keys.append(np.insert(m, rng.integers(0, len(m) + 1),
                                  rng.integers(0, 4)))          # ins
    seen = set()
    uniq = []
    for k in keys:
        b = bytes(k)
        if b not in seen:
            seen.add(b)
            uniq.append(k)
    by_len = {}
    for i, k in enumerate(uniq):
        by_len.setdefault(len(k), []).append(i)
    mats, gs = [], []
    for length, idxs in by_len.items():
        mats.append(np.stack([uniq[i] for i in idxs]).astype(np.uint8))
        gs.append(np.asarray(idxs, dtype=np.int64))
    ci, cj = edit_candidate_pairs(mats, gs, 1)
    cand = set(zip(ci.tolist(), cj.tolist()))
    strs = [bytes(k + 65).decode("latin-1") for k in uniq]
    for i in range(len(uniq)):
        for j in range(i + 1, len(uniq)):
            if within_distance(strs[i], strs[j], 1, True):
                assert (i, j) in cand, (strs[i], strs[j])


def test_pairlist_device_route_matches_host(monkeypatch):
    import re
    """Forcing the explicit-pair-list device route (rates that make the
    rowwise kernel win) must produce the identical pair set."""
    import numpy as np

    from fastqdedup_tpu.ops.bucket import hamming_neighbor_pairs_bucketed

    rng = np.random.default_rng(11)
    base = rng.integers(0, 5, size=(30, 40), dtype=np.uint8)
    rows = [base]
    for _ in range(7):  # dense near-duplicate neighborhoods: the pair
        m = base.copy()  # graph must outweigh the modeled pack cost
        idx = rng.integers(0, 40, size=len(m))
        m[np.arange(len(m)), idx] = rng.integers(0, 5, size=len(m))
        rows.append(m)
    matrix = np.unique(np.concatenate(rows), axis=0)

    want = hamming_neighbor_pairs_bucketed(matrix, 5, 1)
    monkeypatch.setenv("FASTQDEDUP_DISPATCH_S", "1e-9")
    monkeypatch.setenv("FASTQDEDUP_H2D_RATE", "1e15")
    monkeypatch.setenv("FASTQDEDUP_HOST_RATE", "1.0")  # host "slow"
    import logging
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("fastqdedup")
    handler = Grab(level=logging.DEBUG)
    old = logger.level
    logger.setLevel(logging.DEBUG)
    logger.addHandler(handler)
    try:
        got = hamming_neighbor_pairs_bucketed(matrix, 5, 1)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    splits = [re.search(r"pairs host=(\d+) device=(\d+)", m)
              for m in records]
    splits = [m for m in splits if m]
    assert splits, "bucketed debug line missing"
    host = sum(int(m.group(1)) for m in splits)
    device = sum(int(m.group(2)) for m in splits)
    assert device > 0 and device >= host, (host, device)
