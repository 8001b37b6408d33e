#!/usr/bin/env python3
"""100M-read flagship measurement: in-process sustained rep hunt.

Generates (once) the standard 100M x 100 bp BGZF input
(bench.generate_fastq defaults:
seed 7, 5x duplication, ~15% single-substitution error profile), then
runs the full dedup pipeline repeatedly IN ONE PROCESS — the steady
state a long-lived service sees, and the only state that is measurable
on hosts with virtio free-page reporting, where freed pages return to
the hypervisor within seconds so every fresh process re-pays full page
backing.

Per rep it prints wall time, output sha256 (must be identical every
rep), fresh page mappings and CPU time; at the end one JSON summary
line with the steady-rep median/best (rep 0 is the cold rep and is
excluded from the median, matching every prior recorded hunt).

Usage: python tools/hunt100m.py [reps] [input.fastq.gz]
Env: HUNT_READS (default 100_000_000), HUNT_EDIT=1 for --edit mode,
HUNT_DEBUG=1 for phase-level DEBUG logs to stderr.
"""
import hashlib
import json
import logging
import os
import resource
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    n_reads = int(os.environ.get("HUNT_READS", 100_000_000))
    src = sys.argv[2] if len(sys.argv) > 2 else "/tmp/bench100m.fastq.gz"
    use_edit = os.environ.get("HUNT_EDIT") == "1"
    if os.environ.get("HUNT_DEBUG") == "1":
        logging.basicConfig(level=logging.DEBUG,
                            format="%(relativeCreated)8.0fms %(message)s")
        logging.getLogger("jax").setLevel(logging.WARNING)

    if not os.path.exists(src):
        import bench
        print(f"generating {n_reads} reads at {src} ...", file=sys.stderr)
        t0 = time.time()
        bench.generate_fastq(src, n_reads, 100, 12)
        print(f"generated in {time.time() - t0:.0f}s", file=sys.stderr)

    out = src + ".dedup.fastq.gz"
    from fastqdedup_tpu.dissect import CLUSTER_DISSECTION_METHODS
    from fastqdedup_tpu.pipeline import deduplicate_cluster

    walls = []
    shas = set()
    for r in range(reps):
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        deduplicate_cluster([src], [out], None, 1, 0.001,
                            CLUSTER_DISSECTION_METHODS["directional"],
                            use_edit)
        wall = time.perf_counter() - t0
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        sha = hashlib.sha256(open(out, "rb").read()).hexdigest()[:16]
        shas.add(sha)
        walls.append(wall)
        print(f"rep {r}: {wall:.1f}s  {n_reads / wall / 1e3:.0f}k reads/s"
              f"  sha {sha}  minflt {ru1.ru_minflt - ru0.ru_minflt}"
              f"  cpu {ru1.ru_utime - ru0.ru_utime + ru1.ru_stime - ru0.ru_stime:.0f}s",
              flush=True)
        if len(shas) != 1:
            raise AssertionError(f"output changed between reps: {shas}")
    steady = sorted(walls[1:]) or walls
    median = steady[len(steady) // 2]
    print(json.dumps({
        "metric": f"100M sustained ({'edit' if use_edit else 'hamming'})",
        "reps_s": [round(w, 1) for w in walls],
        "steady_median_s": round(median, 1),
        "steady_median_reads_per_sec": round(n_reads / median, 0),
        "best_s": round(min(walls), 1),
        "best_reads_per_sec": round(n_reads / min(walls), 0),
        "sha": sorted(shas)[0],
    }))


if __name__ == "__main__":
    main()
