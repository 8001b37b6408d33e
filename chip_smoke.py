"""Run the dedup pipeline on an NVIDIA GPU and check what it computes.

    python chip_smoke.py                # one card: phases 1-3
    python chip_smoke.py --four-cards   # the four cards of one host: 3(a)

1. Environment: the card's name and power limit (nvidia-smi), the JAX
   version, device kind, host cores and compile-cache directory.
2. Every device form at real widths (L=100, Lp=112, alphabet 5), compiled
   for the card: its ``memory_analysis()``, a bit-exact comparison with
   numpy brute force or the C scalar verifier, and its time; the HLO op
   kinds of the one-hot product forms; the repo's GPU-only tests.
3. The pipeline through ``deduplicate_cluster`` (the call the CLI makes)
   on generated inputs: (a) 4M reads x 100 bp, Hamming d=1, directional,
   filter 0.001; (b) the same input with --edit; (c) a dup-dense input,
   30x duplication at 0.01 errors per base.  Each output's sha256 must
   equal a CPU-only child's (``python -m fastqdedup_tpu`` with
   ``JAX_PLATFORMS=cpu``) on the same input and arguments, and each route
   the phase exists to drive must do device work; where the measured
   host/device crossovers keep a route on the host, the phase forces it
   (a fixed host bucket cap, or the FASTQDEDUP_DISPATCH_S / _H2D_RATE
   rate overrides) and says so.

``--four-cards`` runs phase 3(a) alone, on four cards in one process, with
``FASTQDEDUP_REQUIRE_MESH=1`` so the mesh carries the clustering; the
forced size-class run repeats until every card has received a batch.

Any failure raises, so the script exits non-zero and prints no result.
The last line of standard output is the result:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import contextlib
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_work")
READS = 4_000_000
READ_LEN = 100
UMI_LEN = 12

# What forces a route onto the device when the measured crossovers keep
# it on the host, as (environment overrides, host bucket cap or None):
# buckets of more than 4 keys to the size classes; the edit key matrix
# to the card; small-bucket candidates to the pair-list route; buckets
# of more than 8 keys to the size classes.
FORCE_BUCKETS = ({}, 4)
FORCE_EDIT = ({"FASTQDEDUP_H2D_RATE": "1e12"}, None)
FORCE_PAIRLIST = ({"FASTQDEDUP_DISPATCH_S": "1e-9",
                   "FASTQDEDUP_H2D_RATE": "1e12"}, None)
FORCE_CLASSES = ({}, 8)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def log(msg: str = "") -> None:
    print(msg, flush=True)


def build_native() -> None:
    """Rebuild the host library from its C source before any of the
    package is imported, so no build from another machine is loaded,
    then check that the loaded library is the rebuilt file (which also
    refuses the pure-Python fallback)."""
    os.environ.pop("FASTQDEDUP_NATIVE_LIB", None)
    check("fastqdedup_tpu" not in sys.modules,
          "the package was imported before the native build")
    # build.py by path: importing it through the package would run
    # native/__init__.py, which loads whatever library is on disk.
    spec = importlib.util.spec_from_file_location(
        "_native_build", os.path.join(REPO, "fastqdedup_tpu", "native",
                                      "build.py"))
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    t0 = time.perf_counter()
    path = build.build()
    dt = time.perf_counter() - t0
    from fastqdedup_tpu.native import loader
    inode = os.stat(path).st_ino
    with open("/proc/self/maps") as f:
        mapped = {int(line.split()[4]) for line in f
                  if os.path.basename(path) in line}
    check(os.path.samefile(loader._lib._name, path) and mapped == {inode},
          f"the loaded native library is not the rebuilt {path}")
    log(f"native library rebuilt from source and loaded: {path} "
        f"({dt:.1f} s)")


# ---------------------------------------------------------------- phase 1


def phase_environment(jax) -> None:
    from fastqdedup_tpu.runtime import compile_cache_dir
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log("== 1. environment")
    for line in smi.splitlines():
        log(line)
    dev = jax.devices()[0]
    log(f"jax {jax.__version__}, backend {jax.default_backend()}, "
        f"device_kind {dev.device_kind!r}, devices {len(jax.devices())}")
    log(f"host cores {len(os.sched_getaffinity(0))}, "
        f"compile cache {compile_cache_dir()}")


# ---------------------------------------------------------------- phase 2


def _per_call(jax, fn, *args, reps: int = 30) -> float:
    """Seconds per call on device-resident inputs: ``reps`` calls
    enqueued back to back, then one wait (host dispatch overlaps device
    work, as in the pipeline)."""
    import numpy as np
    args = [jax.device_put(a) if isinstance(a, np.ndarray) else a
            for a in args]
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def _compile_report(name: str, jitted, *args, **static) -> str:
    compiled = jitted.lower(*args, **static).compile()
    mem = compiled.memory_analysis()
    log(f"{name}: memory_analysis args={mem.argument_size_in_bytes} "
        f"out={mem.output_size_in_bytes} temp={mem.temp_size_in_bytes} "
        f"bytes")
    return compiled.as_text()


def _op_kinds(name: str, hlo: str) -> None:
    """Print the optimized HLO's custom calls and fusion kinds: the
    one-hot product should be a GEMM (cuBLAS or a Triton GEMM fusion),
    not a loop fusion (the GPU-only tests assert it)."""
    import collections
    import re
    calls = collections.Counter(re.findall(r'custom_call_target="([^"]+)"',
                                           hlo))
    kinds = collections.Counter(re.findall(r"kind=(k\w+)", hlo))
    backend = collections.Counter(re.findall(r'"kind":"([^"]+)"', hlo))
    log(f"{name}: custom calls {dict(calls)}, fusion kinds {dict(kinds)}, "
        f"backend fusion kinds {dict(backend)}")


def _mutated(rng, n, length, subs):
    import numpy as np
    base = rng.integers(0, 4, size=(n, length), dtype=np.uint8)
    out = base.copy()
    rows = np.arange(n)
    for _ in range(subs):
        hit = rng.random(n) < 0.5
        out[rows[hit], rng.integers(0, length, hit.sum())] = \
            rng.integers(0, 4, hit.sum())
    return base, out


def _brute_within(a, b, d):
    import numpy as np
    out = np.empty((len(a), len(b)), dtype=bool)
    for i in range(0, len(a), 64):
        out[i:i + 64] = (a[i:i + 64, None, :] != b[None, :, :]).sum(2) <= d
    return out


def phase_kernels(jax) -> None:
    import numpy as np

    from fastqdedup_tpu.ops.bucket import (
        SIZE_CLASSES,
        _bucketed_within_padded,
        _buckets_per_call,
        _verify_packed_pairs,
    )
    from fastqdedup_tpu.ops.edit import (
        _edit_verify_gathered_packed,
        banded_within_edit_distance,
        pack_nibble_rows,
    )
    from fastqdedup_tpu.ops.encode import _pad_dims, pack_nibbles
    from fastqdedup_tpu.ops.hamming import within_tile_packed

    log("== 2. device forms at L=100 (Lp=112, alphabet 5)")
    rng = np.random.default_rng(2)
    length, d = READ_LEN, 1
    l_pad, a_pad = _pad_dims(length, 5)
    scalars = np.array([length, d], dtype=np.int32)

    def padded(rows):
        return np.pad(rows, ((0, 0), (0, l_pad - length)),
                      constant_values=0xFF)

    # All-pairs tile, 2048 x 2048.
    a, b = _mutated(rng, 2048, length, 2)
    b[1024:] = a[:1024]  # exact copies too
    ap, bp = padded(a), padded(b)
    hlo = _compile_report("tile 2048x2048", within_tile_packed, ap, bp,
                          scalars, alphabet_pad=a_pad)
    _op_kinds("tile 2048x2048", hlo)
    got = np.unpackbits(np.asarray(within_tile_packed(ap, bp, scalars,
                                                      a_pad)),
                        axis=1, bitorder="little").astype(bool)
    want = _brute_within(a, b, d)
    check((got == want).all(), "tile form != numpy brute force")
    t = _per_call(jax, within_tile_packed, ap, bp, scalars, a_pad)
    log(f"tile 2048x2048: bit-exact vs numpy ({int(want.sum())} pairs "
        f"within d={d}); {t * 1e3:.4f} ms/call")

    # Bucket form per size class, at its production K.
    for s in SIZE_CLASSES:
        k = _buckets_per_call(s)
        batch = np.full((k, s, l_pad), 0xFF, dtype=np.uint8)
        fills = rng.integers(2, s + 1, size=k)
        for i in range(k):
            _, rows = _mutated(rng, fills[i], length, 2)
            rows[:fills[i] // 2] = rows[0]  # a near-duplicate family
            batch[i, :fills[i], :length] = rows
        hlo = _compile_report(f"bucket S={s} K={k}",
                              _bucketed_within_padded, batch, scalars,
                              alphabet_pad=a_pad)
        _op_kinds(f"bucket S={s}", hlo)
        got = np.unpackbits(np.asarray(_bucketed_within_padded(
            batch, scalars, a_pad)), axis=-1, bitorder="little")
        checked = min(k, {128: 64, 512: 8}.get(s, 2))
        for i in range(checked):
            f = fills[i]
            rows = batch[i, :f, :length]
            check((got[i, :f, :f].astype(bool)
                   == _brute_within(rows, rows, d)).all(),
                  f"bucket S={s} bucket {i} != numpy brute force")
        for i in range(k):
            check(not got[i, fills[i]:].any() and
                  not got[i, :, fills[i]:].any(),
                  f"bucket S={s}: pad rows matched")
        t = _per_call(jax, _bucketed_within_padded, batch, scalars, a_pad,
                      reps=10)
        log(f"bucket S={s} K={k}: bit-exact vs numpy on {checked} "
            f"buckets, pad rows clean on all {k}; "
            f"{t * 1e3:.4f} ms/call")

    # Rowwise verify of 2^21 index pairs over a resident packed table.
    n, p = 1 << 20, 1 << 21
    base, var = _mutated(rng, n // 2, length, 2)
    matrix = np.concatenate([base, var])
    gi = rng.integers(0, n, p).astype(np.int32)
    gj = rng.integers(0, n, p).astype(np.int32)
    gj[: p // 2] = (gi[: p // 2] + n // 2) % n  # planted near pairs
    lanes = -(-length // 8)
    packed_dev = jax.device_put(pack_nibbles(matrix, lanes))
    _compile_report("rowwise 2^21 pairs", _verify_packed_pairs, packed_dev,
                    gi, gj, max_distance=d)
    got = np.asarray(_verify_packed_pairs(packed_dev, gi, gj, d))
    want = (matrix[gi] != matrix[gj]).sum(1) <= d
    check((got == want).all(), "rowwise form != numpy")
    t = _per_call(jax, _verify_packed_pairs, packed_dev, gi, gj, d)
    log(f"rowwise 2^21 pairs: bit-exact vs numpy ({int(want.sum())} "
        f"within); {t * 1e3:.4f} ms/call")

    # Banded edit DP, P = 65,536: alone on gathered rows, and as the
    # engine runs it (gather from the resident nibble-packed keys).
    from fastqdedup_tpu.distance import within_distance
    from fastqdedup_tpu.native.loader import edit_verify_native
    p = 1 << 16
    keys_n = 1 << 17
    keys = np.full((keys_n, l_pad), 0xFF, dtype=np.uint8)
    lens = rng.integers(length - 6, length + 1, keys_n).astype(np.int32)
    src = rng.integers(0, 4, size=(keys_n // 2, length), dtype=np.uint8)
    for i in range(keys_n // 2):
        keys[i, :lens[i]] = src[i, :lens[i]]
        row = list(src[i, :lens[i]])
        for _ in range(rng.integers(0, 3)):
            op = rng.integers(3)
            pos = int(rng.integers(len(row)))
            if op == 0:
                row[pos] = rng.integers(4)
            elif op == 1:
                del row[pos]
            else:
                row.insert(pos, rng.integers(4))
        row = row[:l_pad]
        j = i + keys_n // 2
        lens[j] = len(row)
        keys[j, :len(row)] = row
    ci = rng.integers(0, keys_n, p).astype(np.int32)
    cj = ci.copy()
    cj[: p // 2] = (ci[: p // 2] + keys_n // 2) % keys_n
    cj[p // 2:] = rng.integers(0, keys_n, p - p // 2)
    keys_packed = jax.device_put(pack_nibble_rows(keys))
    lens_dev = jax.device_put(lens)
    a_rows, b_rows = keys[ci], keys[cj]
    la, lb = lens[ci], lens[cj]
    sample = rng.choice(p, 1000, replace=False)
    for dd in (1, 2):
        want = edit_verify_native(keys, lens, ci.astype(np.int64),
                                  cj.astype(np.int64), dd)
        for i in sample:
            x = "".join("ACGT"[c] for c in keys[ci[i], :lens[ci[i]]])
            y = "".join("ACGT"[c] for c in keys[cj[i], :lens[cj[i]]])
            check(within_distance(x, y, dd, True) == want[i],
                  "C verifier disagrees with the scalar oracle")
        _compile_report(f"edit d={dd} P={p}", banded_within_edit_distance,
                        a_rows, la, b_rows, lb, max_distance=dd)
        got = np.asarray(banded_within_edit_distance(a_rows, la, b_rows, lb,
                                                     dd))
        check((got == want).all(), f"edit d={dd} != C verifier")
        gathered = np.asarray(_edit_verify_gathered_packed(
            keys_packed, lens_dev, ci, cj, dd))
        check((gathered == want).all(),
              f"edit d={dd} gathered-packed != C verifier")
        t = _per_call(jax, banded_within_edit_distance, a_rows, la, b_rows,
                      lb, dd)
        tg = _per_call(jax, _edit_verify_gathered_packed, keys_packed,
                       lens_dev, ci, cj, dd)
        log(f"edit d={dd} P={p}: bit-exact vs the C verifier "
            f"({int(want.sum())} within; C verifier agrees with the "
            f"scalar oracle on 1000 pairs); {t * 1e3:.4f} ms/call, "
            f"{tg * 1e3:.4f} ms/call with the gather")

    import pytest
    passed = []

    class Count:
        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                passed.append(report.nodeid)

    rc = pytest.main(["-q", "--noconftest", "-p", "no:cacheprovider",
                      "-m", "gpu",
                      os.path.join(REPO, "tests", "test_device_forms.py")],
                     plugins=[Count()])
    check(rc == 0 and passed, f"GPU tests failed or did not run (rc={rc})")
    log(f"GPU-only tests passed: {len(passed)}")


# ---------------------------------------------------------------- phase 3


def _sha(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _cpu_sha(src: str, edit: bool) -> str:
    """Output sha256 of the CLI on the CPU backend, in a child process
    that never opens the card."""
    out = os.path.join(WORK, f"cpu_{os.path.basename(src)}_{int(edit)}.gz")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("FASTQDEDUP_")}
    env.update(JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "fastqdedup_tpu", "-q", "-d", "1",
           "-e", "0.001", "-c", "directional", "-o", out, src]
    if edit:
        cmd.append("--edit")
    t0 = time.perf_counter()
    child = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                           text=True)
    if child.returncode:
        sys.stderr.write(child.stderr[-4000:])
    check(child.returncode == 0, f"CPU child exited {child.returncode}")
    sha = _sha(out)
    log(f"  cpu child: sha256 {sha} ({time.perf_counter() - t0:.1f} s)")
    os.unlink(out)
    return sha


def _routes(diff) -> str:
    return ", ".join(f"{k}={v}" for k, v in sorted(diff.items())) or "none"


@contextlib.contextmanager
def _forced(force):
    """Apply a FORCE_* pair for the duration of the block."""
    from fastqdedup_tpu.ops import bucket
    env, cap = force
    saved_env = {k: os.environ.get(k) for k in env}
    saved_cap = bucket.choose_host_bucket_cap
    os.environ.update(env)
    if cap is not None:
        bucket.choose_host_bucket_cap = \
            lambda sizes, length, limit, **kw: min(cap, limit)
    try:
        yield
    finally:
        bucket.choose_host_bucket_cap = saved_cap
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _describe(force) -> str:
    env, cap = force
    parts = [f"{k}={v}" for k, v in env.items()]
    if cap is not None:
        parts.append(f"host bucket cap {cap}")
    return ", ".join(parts)


def _run_phase(name: str, src: str, edit: bool, drives,
               cpu_sha: str, attempts: int = 1):
    """Cold and warm runs through deduplicate_cluster, then forced runs
    for each driven route the measured crossovers kept on the host, up
    to ``attempts`` of them until the route's test holds.

    ``drives`` maps a route to (test of the run's route counters, the
    FORCE_* pair that forces it).  Returns the counters summed over
    runs."""
    import collections

    from fastqdedup_tpu.dissect import CLUSTER_DISSECTION_METHODS
    from fastqdedup_tpu.ops import ROUTE_COUNTS
    from fastqdedup_tpu.pipeline import deduplicate_cluster

    out = os.path.join(WORK, "gpu_out.fastq.gz")
    method = CLUSTER_DISSECTION_METHODS["directional"]
    total: "collections.Counter[str]" = collections.Counter()

    def run(label):
        before = collections.Counter(ROUTE_COUNTS)
        t0 = time.perf_counter()
        deduplicate_cluster([src], [out], None, 1, 0.001, method, edit)
        dt = time.perf_counter() - t0
        diff = collections.Counter(ROUTE_COUNTS)
        diff.subtract(before)
        diff = +diff
        total.update(diff)
        sha = _sha(out)
        log(f"  {label}: {dt:.3f} s, {READS / dt:.0f} reads/s, sha256 "
            f"{sha}; device routes: {_routes(diff)}")
        check(sha == cpu_sha, f"{name} {label}: sha differs from CPU")

    log(f"-- {name}")
    run("cold")
    run("warm")
    for route, (test, force) in drives.items():
        if test(total):
            continue
        log(f"  measured crossovers kept {route} on the host; forcing it "
            f"with {_describe(force)}")
        for _ in range(attempts):
            with _forced(force):
                run(f"forced {route}")
            if test(total):
                break
        check(test(total), f"{name}: no device work on {route}")
    return total


def _bucket_batches(diff) -> int:
    return sum(v for k, v in diff.items()
               if k.startswith("bucket_batches_S"))


def phase_pipeline(jax, four_cards: bool) -> None:
    sys.path.insert(0, REPO)
    from bench import generate_fastq
    from fastqdedup_tpu.parallel import sharded

    log(f"== 3. pipeline, {READS} reads x {READ_LEN} bp")
    src = os.path.join(WORK, "default.fastq.gz")
    t0 = time.perf_counter()
    generate_fastq(src, READS, READ_LEN, UMI_LEN, seed=7)
    log(f"generated default input ({time.perf_counter() - t0:.1f} s)")
    if four_cards:
        os.environ["FASTQDEDUP_REQUIRE_MESH"] = "1"
        runs = sharded.MESH_COMPONENT_RUNS
        devices = [f"bucket_batches_dev{d.id}" for d in jax.devices()]
        total = _run_phase(
            "3(a) Hamming d=1, four cards", src, False,
            {"bucket batches on every device":
             (lambda c: all(c[k] > 0 for k in devices), FORCE_BUCKETS)},
            _cpu_sha(src, False), attempts=len(devices))
        mesh = sharded.MESH_COMPONENT_RUNS - runs
        log(f"  MESH_COMPONENT_RUNS +{mesh}; bucket batches per device "
            f"over the phase: {[total[k] for k in devices]}")
        check(mesh > 0, "the mesh did not carry the clustering")
        return
    _run_phase("3(a) Hamming d=1", src, False,
               {"size classes": (_bucket_batches, FORCE_BUCKETS)},
               _cpu_sha(src, False))
    _run_phase("3(b) edit d=1", src, True,
               {"edit verify": (lambda c: c["edit_batches"], FORCE_EDIT)},
               _cpu_sha(src, True))
    os.unlink(src)
    dense = os.path.join(WORK, "dense.fastq.gz")
    t0 = time.perf_counter()
    generate_fastq(dense, READS, READ_LEN, UMI_LEN, seed=7, dup_factor=30,
                   error_rate=0.01)
    log(f"generated dup-dense input ({time.perf_counter() - t0:.1f} s)")
    _run_phase("3(c) dup-dense Hamming d=1", dense, False,
               {"pair-list": (lambda c: c["pairlist_batches"],
                              FORCE_PAIRLIST),
                "size classes": (_bucket_batches, FORCE_CLASSES)},
               _cpu_sha(dense, False))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run phase 3(a) alone on four cards")
    args = parser.parse_args()
    # A CUDA plugin that fails to start must stop the run, not fall back
    # to the CPU.
    os.environ["JAX_PLATFORMS"] = "cuda"
    # The package must be here (the script alone is not the program);
    # the native build fails first if it is not.
    sys.path.insert(0, REPO)
    build_native()
    import jax

    from fastqdedup_tpu.runtime import configure_jax
    configure_jax()
    check(jax.default_backend() == "gpu",
          f"backend is {jax.default_backend()}, not gpu")
    want = 4 if args.four_cards else 1
    check(len(jax.devices()) >= want,
          f"{want} card(s) needed, found {len(jax.devices())}")
    os.makedirs(WORK, exist_ok=True)
    try:
        phase_environment(jax)
        if not args.four_cards:
            phase_kernels(jax)
        phase_pipeline(jax, args.four_cards)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
