"""Device-side compute ops (JAX / XLA / Pallas).

The reference's native hot paths and their device replacements:

* ``_triemodule.c:380-495`` (fast-fail nearest-neighbor trie walk)
  -> :mod:`.hamming` all-pairs one-hot / XOR forms + :mod:`.bucket`
  pigeonhole candidate generation + :mod:`.components` clustering.
* ``distances.h:8-88`` (scalar distance predicates)
  -> :mod:`.hamming` (batched) and :mod:`.edit` (banded DP, batched).
* ``_fastqmodule.c:38-76`` (phred -> error rate reduction)
  -> :mod:`.phred` (LUT gather + masked mean).

All ops are jit-compatible with static shapes; ragged work is padded and
masked by the callers.
"""

import collections

# JAX runtime configuration (persistent compilation cache) is applied by
# the entry points — cli.main() and pipeline.deduplicate_cluster() — via
# runtime.configure_jax(), NOT as an import side effect: embedding hosts
# that import this package alongside other JAX code must not have global
# config silently changed.

# Device work per route, counted where each route dispatches: tile calls,
# bucket batches per size class and per device, pair-list batches, edit
# verify batches (and edit pairs the host C verifier took), and pairs
# verified on host vs device.  Read by
# chip_smoke.py to show that each route ran on the card.
ROUTE_COUNTS: "collections.Counter[str]" = collections.Counter()
