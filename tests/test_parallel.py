"""Multi-device sharded clustering tests (8 virtual CPU devices)."""

import random

import numpy as np
import pytest

import jax

from fastqdedup_tpu.distance import within_distance
from fastqdedup_tpu.ops.encode import EncodeTable, keys_to_matrix
from fastqdedup_tpu.ops.labels import dedup_step
from fastqdedup_tpu.parallel.sharded import make_mesh, sharded_dedup_step


def _keys_and_counts(rng, n, length=12):
    seeds = []
    keys = []
    while len(keys) < n:
        if seeds and rng.random() < 0.6:
            base = list(rng.choice(seeds))
            base[rng.randrange(length)] = rng.choice("ACGT")
            key = "".join(base)
        else:
            key = "".join(rng.choice("ACGT") for _ in range(length))
            seeds.append(key)
        if key not in keys:
            keys.append(key)
    counts = np.array([rng.randrange(1, 10) for _ in keys], dtype=np.int64)
    return keys, counts


def _expected_labels(keys, d):
    n = len(keys)
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(n):
        for j in range(i + 1, n):
            if within_distance(keys[i], keys[j], d):
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[max(ri, rj)] = min(ri, rj)
    return np.array([find(i) for i in range(n)])


def test_eight_virtual_devices_available():
    assert jax.device_count() >= 8


def test_dense_dedup_step_single_device():
    rng = random.Random(11)
    keys, counts = _keys_and_counts(rng, 100)
    table = EncodeTable("ACGTN")
    matrix, _ = keys_to_matrix([k.encode() for k in keys], table)
    # rank = position in ascending lexicographic order (ties in count break
    # toward the greatest string, like sorted(cluster, reverse=True)[0]).
    rank = np.argsort(np.argsort(keys))
    labels, keep = dedup_step(matrix, counts, rank, table.size, 1)
    labels, keep = np.asarray(labels), np.asarray(keep)
    assert (labels == _expected_labels(keys, 1)).all()
    # Exactly one representative per cluster; it's the max (count, string).
    for lab in np.unique(labels):
        members = np.flatnonzero(labels == lab)
        reps = members[keep[members]]
        assert len(reps) == 1
        expected = max(members, key=lambda i: (counts[i], keys[i]))
        assert reps[0] == expected


@pytest.mark.parametrize("n", [64, 101])
def test_sharded_matches_single_device(n):
    rng = random.Random(13)
    keys, counts = _keys_and_counts(rng, n)
    table = EncodeTable("ACGTN")
    matrix, _ = keys_to_matrix([k.encode() for k in keys], table)
    rank = np.argsort(np.argsort(keys)).astype(np.int64)

    mesh = make_mesh(8)
    labels_sh, keep_sh = sharded_dedup_step(matrix, counts, rank,
                                            table.size, 1, mesh)
    labels, keep = dedup_step(matrix, counts, rank, table.size, 1)
    assert (labels_sh == np.asarray(labels)).all()
    assert (keep_sh == np.asarray(keep)).all()


def test_sharded_on_smaller_mesh():
    rng = random.Random(17)
    keys, counts = _keys_and_counts(rng, 40)
    table = EncodeTable("ACGTN")
    matrix, _ = keys_to_matrix([k.encode() for k in keys], table)
    rank = np.argsort(np.argsort(keys)).astype(np.int64)
    mesh = make_mesh(4)
    labels_sh, _ = sharded_dedup_step(matrix, counts, rank, table.size, 1,
                                      mesh)
    assert (labels_sh == _expected_labels(keys, 1)).all()


# --------------------------------------------------------------------- #
# Mesh routing observability: the engine must
# actually take the mesh path on a multi-device backend, the fallback
# must be loud, and FASTQDEDUP_REQUIRE_MESH must make it fatal.

def test_engine_takes_mesh_path_on_virtual_mesh(monkeypatch):
    from fastqdedup_tpu.engine import build_clusters
    from fastqdedup_tpu.parallel import sharded

    monkeypatch.setenv("FASTQDEDUP_REQUIRE_MESH", "1")
    monkeypatch.setenv("FASTQDEDUP_MESH_MIN_EDGES", "1")
    before = sharded.MESH_COMPONENT_RUNS
    keys = [b"AAAA", b"AAAT", b"AATT", b"CCCC", b"CCCA", b"GGGG"]
    clusters = build_clusters(keys, [4, 1, 1, 2, 3, 1], max_distance=1)
    assert sharded.MESH_COMPONENT_RUNS == before + 1
    got = sorted(frozenset(c.keys) for c in clusters)
    assert got == sorted([frozenset(keys[:3]), frozenset(keys[3:5]),
                          frozenset(keys[5:])])


def test_require_mesh_raises_below_edge_threshold(monkeypatch):
    from fastqdedup_tpu.engine import build_clusters

    monkeypatch.setenv("FASTQDEDUP_REQUIRE_MESH", "1")
    monkeypatch.setenv("FASTQDEDUP_MESH_MIN_EDGES", "1000000")
    with pytest.raises(RuntimeError, match="FASTQDEDUP_MESH_MIN_EDGES"):
        build_clusters([b"AAAA", b"AAAT"], [1, 1], max_distance=1)


def test_mesh_fallback_is_loud_and_require_mesh_fatal(monkeypatch, caplog):
    import logging

    from fastqdedup_tpu.parallel import sharded

    def boom(*a, **k):
        raise ValueError("injected mesh failure")

    monkeypatch.setattr(sharded, "sharded_components_from_edges", boom)
    ei = np.array([0], dtype=np.int64)
    ej = np.array([1], dtype=np.int64)

    # Default: degrade to host path (None) but WARN.
    monkeypatch.delenv("FASTQDEDUP_REQUIRE_MESH", raising=False)
    with caplog.at_level(logging.WARNING, logger="fastqdedup"):
        assert sharded.components_on_mesh(4, ei, ej) is None
    assert any("falling back to host union-find" in r.message
               for r in caplog.records)

    # Required: the injected failure propagates.
    monkeypatch.setenv("FASTQDEDUP_REQUIRE_MESH", "1")
    with pytest.raises(ValueError, match="injected mesh failure"):
        sharded.components_on_mesh(4, ei, ej)
