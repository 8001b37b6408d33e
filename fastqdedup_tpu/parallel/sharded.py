"""Multi-device clustering (Mesh + shard_map + collectives) — sparse.

Greenfield relative to the reference (single-threaded CPU, SURVEY.md
section 2).  The production pipeline's pair generation (pigeonhole buckets
-> batched one-hot products, ops/bucket.py) already data-parallelizes across
local chips by round-robining bucket batches; this module supplies the
device-side CLUSTERING stage over the resulting sparse edge list:

* :func:`sharded_components_from_edges` — connected-component labels by
  min-label propagation with pointer doubling.  Edges shard row-wise over
  a 1-D mesh; labels stay replicated ([N] int32) and combine each round
  with one ``pmin`` collective.  Memory is O(N + E/D) per device
  — no dense adjacency anywhere, so the same code path scales from the
  8-virtual-device dryrun to production key counts.
* :func:`sharded_dedup_step` — the composed multi-chip dedup step the
  driver dry-runs: bucket-kernel pair generation (round-robin across the
  mesh's devices) -> sparse label propagation -> highest-count
  representative selection, i.e. exactly the production algorithm.

The engine routes clustering through :func:`components_on_mesh` when more
than one local device is attached (engine.py); the host union-find remains
the single-device path.
"""

import functools
import logging
import os
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

AXIS = "shard"

logger = logging.getLogger("fastqdedup")

# Observability for the engine's mesh routing: incremented on every
# successful sharded_components_from_edges call so tests can assert the
# mesh path was actually taken (a silent fallback must not ship green).
MESH_COMPONENT_RUNS = 0


def _require_mesh() -> bool:
    """FASTQDEDUP_REQUIRE_MESH=1 turns any mesh fallback into an error.

    Set in CI/dryrun contexts where the mesh path is expected to carry the
    clustering pass; production leaves it unset so a backend hiccup
    degrades to the (identical-output) host union-find — loudly, via a
    warning log.
    """
    return os.environ.get("FASTQDEDUP_REQUIRE_MESH", "0") == "1"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D device mesh over the first ``n_devices`` available devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (AXIS,))


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@functools.lru_cache(maxsize=None)
def _components_fn(mesh: Mesh):
    """shard_map'd (ei_shard, ej_shard, labels0) -> labels."""

    def per_shard(ei, ej, labels0):
        # ei/ej: int32 [E/D] local edge slabs; labels0: int32 [N]
        # replicated.  Each round: local scatter-min over this shard's
        # edges, a pmin collective to combine shards, then two pointer-
        # doubling hops so long chains converge in O(log N) rounds.
        ei = ei[0]
        ej = ej[0]

        def body(state):
            labels, _ = state
            m = jnp.minimum(labels[ei], labels[ej])
            new = labels.at[ei].min(m).at[ej].min(m)
            new = jax.lax.pmin(new, AXIS)
            new = new[new]
            new = new[new]
            return new, jnp.any(new != labels)

        # The while_loop carry is device-varying (the scatter-min uses the
        # device-local edge slab); cast the replicated inits to match.
        init = (jax.lax.pcast(labels0, (AXIS,), to="varying"),
                jax.lax.pcast(jnp.array(True), (AXIS,), to="varying"))
        labels, _ = jax.lax.while_loop(lambda s: s[1], body, init)
        return labels

    # Every device converges to the same labels (final pmin + pointer
    # doubling are deterministic); vma inference can't prove replication,
    # so the static check is off.
    return shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(None, AXIS), P(None, AXIS), P()),
        out_specs=P(),
        check_vma=False)


def sharded_components_from_edges(n: int, edges_i: np.ndarray,
                                  edges_j: np.ndarray,
                                  mesh: Optional[Mesh] = None) -> np.ndarray:
    """int64 [n] min-index component labels over a sparse edge list.

    Output contract matches ops.components.connected_components_host: each
    key's label is the smallest key index in its component.  Shapes pad to
    powers of two so the compiled-executable family stays logarithmic.
    """
    if mesh is None:
        mesh = make_mesh()
    d = mesh.devices.size
    n_pad = _pow2_at_least(max(n, 2))
    e_pad = _round_up(_pow2_at_least(max(len(edges_i), 1)), d)
    # Self-loops on a padding node are no-ops under scatter-min.
    ei = np.full(e_pad, n_pad - 1, dtype=np.int32)
    ej = np.full(e_pad, n_pad - 1, dtype=np.int32)
    ei[:len(edges_i)] = edges_i
    ej[:len(edges_j)] = edges_j
    labels0 = np.arange(n_pad, dtype=np.int32)
    fn = jax.jit(_components_fn(mesh))
    edge_sharding = NamedSharding(mesh, P(None, AXIS))
    ei_dev = jax.device_put(ei.reshape(1, -1), edge_sharding)
    ej_dev = jax.device_put(ej.reshape(1, -1), edge_sharding)
    labels_dev = jax.device_put(labels0, NamedSharding(mesh, P()))
    labels = np.asarray(fn(ei_dev, ej_dev, labels_dev))
    return labels[:n].astype(np.int64)


def components_on_mesh(n: int, edges_i: np.ndarray, edges_j: np.ndarray
                       ) -> Optional[np.ndarray]:
    """Device component labels when >1 local device is attached, else
    None.

    The engine calls this before falling back to the host union-find; a
    single device gains nothing from device clustering, but a multi-card
    host keeps the whole pass on the mesh.
    """
    global MESH_COMPONENT_RUNS
    if jax.local_device_count() <= 1 or n < 2:
        if _require_mesh():
            raise RuntimeError(
                "FASTQDEDUP_REQUIRE_MESH=1 but no multi-device mesh is "
                f"available (local_device_count="
                f"{jax.local_device_count()}, n={n})")
        return None
    try:
        labels = sharded_components_from_edges(n, edges_i, edges_j)
    except Exception as exc:
        # A compiler / sharding regression must not ship silently: log the
        # degradation every time, and raise when the env demands the mesh.
        if _require_mesh():
            raise
        logger.warning(
            "device-mesh clustering failed (%s: %s) — falling back to "
            "host union-find; set FASTQDEDUP_REQUIRE_MESH=1 to make this "
            "fatal", type(exc).__name__, exc)
        return None
    MESH_COMPONENT_RUNS += 1
    return labels


@functools.partial(jax.jit, static_argnames=())
def _representative_pick(labels: jax.Array, counts: jax.Array,
                         rank: jax.Array) -> jax.Array:
    """bool [N]: one representative per component — highest count, ties
    broken toward the highest rank (callers pass lexicographic rank,
    reproducing the reference's descending (count, string) sort,
    __init__.py:99-101)."""
    n = labels.shape[0]
    labels = labels.astype(jnp.int32)
    counts = counts.astype(jnp.int32)
    rank = rank.astype(jnp.int32)
    max_count = jnp.zeros(n, jnp.int32).at[labels].max(counts)
    is_max = counts == max_count[labels]
    best_rank = jnp.full(n, -1, jnp.int32).at[labels].max(
        jnp.where(is_max, rank, -1))
    return is_max & (rank == best_rank[labels])


def sharded_dedup_step(matrix: np.ndarray, counts: np.ndarray,
                       rank: np.ndarray, alphabet_size: int,
                       max_distance: int,
                       mesh: Optional[Mesh] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Full multi-chip dedup step: cluster labels + highest-count
    representatives for a batch of equal-length encoded keys.

    Composition IS the production pipeline's: pigeonhole bucket kernels
    generate the sparse pair list (batches round-robin across the mesh's
    devices, ops/bucket.py), min-label propagation runs sharded over the
    mesh, and the representative pick is one fused scatter step.
    """
    from ..ops.bucket import hamming_neighbor_pairs_bucketed

    if mesh is None:
        mesh = make_mesh()
    n = matrix.shape[0]
    ei, ej = hamming_neighbor_pairs_bucketed(
        matrix, alphabet_size, max_distance)
    labels = sharded_components_from_edges(n, ei, ej, mesh)
    keep = np.asarray(_representative_pick(
        jnp.asarray(labels), jnp.asarray(counts), jnp.asarray(rank)))
    return labels, keep
