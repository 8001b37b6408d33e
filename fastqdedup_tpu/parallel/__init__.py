"""Multi-device / multi-host scaling (jax.sharding Mesh + shard_map).

The reference is single-threaded and single-process (SURVEY.md section 2,
"Parallelism inventory: none"); this subpackage is greenfield: unique keys
shard across devices by bucket hash, the pairwise kernels run under
shard_map, and candidate pairs / kept-key sets merge via XLA collectives.
"""
