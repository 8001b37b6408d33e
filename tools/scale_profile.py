#!/usr/bin/env python3
"""Per-stage profile of a P-process scaling run (developer tool).

Launches P pinned jax.distributed processes on one generated input (like
bench_scaling.py) with DEBUG logging, and saves every host's full output
to /tmp/scale_prof_P{P}_host{i}.log so the per-stage budget can be
re-derived after pipeline changes.

Usage: python tools/scale_profile.py [P] [reads]
"""
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import bench_scaling  # noqa: E402


def main():
    nproc = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else 8_000_000
    reps = int(os.environ.get("SCALE_INPROC_REPS", "3"))

    workdir = tempfile.mkdtemp(prefix="fastqdedup_prof_")
    shards = []
    per_shard = n_reads // 4
    for s in range(4):
        path = os.path.join(workdir, f"shard{s}.fastq.gz")
        bench.generate_fastq(path, per_shard, 100, 12, seed=1000 + s)
        shards.append(path)
    print(f"generated 4x{per_shard} reads in {workdir}", file=sys.stderr)

    port = str(bench_scaling._free_port())
    driver = os.path.join(workdir, "driver.py")
    with open(driver, "w") as f:
        f.write(bench_scaling._DRIVER)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["FASTQDEDUP_SHARDED_INPUT"] = "1"
    env["SCALE_DEBUG"] = "1"
    env["SCALE_INPROC_REPS"] = str(reps)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO

    per_host = len(shards) // nproc
    procs = []
    logs = []
    for p in range(nproc):
        mine = shards[p * per_host:(p + 1) * per_host]
        if len(mine) > 1:
            merged = os.path.join(workdir, f"host{p}of{nproc}.fastq.gz")
            with open(merged, "wb") as out:
                for path in mine:
                    with open(path, "rb") as src:
                        out.write(src.read())
            mine = [merged]
        out_path = os.path.join(workdir, f"out{p}of{nproc}.fastq.gz")
        log_path = f"/tmp/scale_prof_P{nproc}_host{p}.log"
        logs.append(log_path)
        cmd = ["taskset", "-c", str(p % os.cpu_count()), sys.executable,
               driver, str(nproc), str(p), port, ",".join(mine), out_path]
        procs.append(subprocess.Popen(
            cmd, env=env, cwd=workdir,
            stdout=open(log_path, "w"), stderr=subprocess.STDOUT))
    for p, proc in enumerate(procs):
        rc = proc.wait()
        print(f"host {p}: rc={rc} log={logs[p]}", file=sys.stderr)
    for log in logs:
        with open(log) as f:
            walls = [ln.strip() for ln in f if "HOSTWALL" in ln]
        print(log, walls[-1] if walls else "NO WALL", file=sys.stderr)


if __name__ == "__main__":
    main()
