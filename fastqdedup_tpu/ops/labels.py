"""Dense on-device clustering step — the ORACLE for the sharded path.

Role (deliberate, not production): this module is the reference
implementation that the sparse/sharded production path is validated
against.  ``entry()`` (the flagship compile check) and the pipeline both
use the grouped bucket kernels + sparse label propagation
(ops/bucket.py, parallel/sharded.py); tests/test_parallel.py compares
those against this module's dense ``[N, N]`` formulation, whose
correctness is transparent by construction.  Keep it small and obvious.

A single jitted computation takes a batch of packed keys and produces
duplicate-cluster labels and representative selection, replacing the
reference's pop_cluster + highest_count loop (_triemodule.c:778-897,
__init__.py:94-102) with dense device-friendly ops:

* pairwise Hamming via a one-hot matrix product;
* connected components via min-label propagation with pointer doubling
  (O(log N) sweeps over an [N, N] adjacency);
* per-cluster representative = max (count, rank) via segment scatter-max.
"""

import functools

import jax
import jax.numpy as jnp

from .hamming import pairwise_within


@functools.partial(jax.jit, static_argnames=("alphabet_size", "max_distance"))
def dense_cluster_labels(matrix: jax.Array, alphabet_size: int,
                         max_distance: int) -> jax.Array:
    """int32 labels [N]: connected components of the within-distance graph.

    ``matrix``: uint8 [N, L] alphabet indices (equal-length keys).  Labels
    are the smallest member index of each component.
    """
    n = matrix.shape[0]
    adj = pairwise_within(matrix, matrix, alphabet_size, max_distance)
    labels0 = jnp.arange(n, dtype=jnp.int32)

    def step(state):
        labels, _ = state
        neighbor_min = jnp.min(
            jnp.where(adj, labels[None, :], jnp.int32(n)), axis=1)
        new = jnp.minimum(labels, neighbor_min)
        new = new[new]
        new = new[new]
        return new, jnp.any(new != labels)

    labels, _ = jax.lax.while_loop(
        lambda s: s[1], step, (labels0, jnp.array(True)))
    return labels


@jax.jit
def highest_count_representatives(labels: jax.Array, counts: jax.Array,
                                  rank: jax.Array) -> jax.Array:
    """bool [N]: True for the representative of each cluster.

    The representative is the member with the highest count; ties break
    toward the highest ``rank`` (callers pass the lexicographic string rank
    to reproduce the reference's descending (count, string) tuple sort,
    __init__.py:99-101).
    """
    n = labels.shape[0]
    counts = counts.astype(jnp.int32)
    max_count = jnp.zeros(n, dtype=jnp.int32).at[labels].max(counts)
    is_max = counts == max_count[labels]
    rank = rank.astype(jnp.int32)
    best_rank = jnp.full(n, -1, dtype=jnp.int32).at[labels].max(
        jnp.where(is_max, rank, -1))
    return is_max & (rank == best_rank[labels])


@functools.partial(jax.jit, static_argnames=("alphabet_size", "max_distance"))
def dedup_step(matrix: jax.Array, counts: jax.Array, rank: jax.Array,
               alphabet_size: int = 5, max_distance: int = 1):
    """Full single-chip dedup step: labels + highest-count representatives.

    Returns (labels int32 [N], keep bool [N]).
    """
    labels = dense_cluster_labels(matrix, alphabet_size, max_distance)
    keep = highest_count_representatives(labels, counts, rank)
    return labels, keep
