"""Error injection for the async ingest/write stack.

The pipeline runs a parse producer + BGZF inflate helpers (C threads), a
quality worker, an accumulate worker, and a writer thread.  These tests
deliberately break each stage mid-stream and assert the failure surfaces
as a clean exception on the caller — with no hung or leaked threads.
"""

import gzip
import random
import struct
import threading
import time

import numpy as np
import pytest

from fastqdedup_tpu.io.bgzf import BGZF_EOF, BgzfWriter
from fastqdedup_tpu.io.fastq import FastqFormatError
from fastqdedup_tpu.pipeline import deduplicate_cluster


def _records(n, length=40, seed=5, qual_char="I"):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        seq = "".join(rng.choice("ACGT") for _ in range(length))
        out.append(f"@r{i} x\n{seq}\n+\n{qual_char * length}\n")
    return "".join(out)


def _write_bgzf(path, text):
    with BgzfWriter(str(path), compresslevel=1) as f:
        f.write(text.encode())


def _bgzf_block_offsets(path):
    """Start offsets of every BGZF member in the file (via FEXTRA BSIZE)."""
    data = path.read_bytes()
    offsets = []
    pos = 0
    while pos < len(data) - len(BGZF_EOF):
        assert data[pos:pos + 2] == b"\x1f\x8b", "not a BGZF member"
        bsize = struct.unpack_from("<H", data, pos + 16)[0] + 1
        offsets.append(pos)
        pos += bsize
    return offsets, data


def _assert_threads_settle(baseline, deadline_s=10.0):
    deadline = time.time() + deadline_s
    while threading.active_count() > baseline and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= baseline, (
        f"leaked threads: {[t.name for t in threading.enumerate()]}")


def test_bgzf_corruption_midstream_fails_cleanly(tmp_path):
    """Corrupting a middle block's deflate payload must raise on the
    caller while the inflate helpers and producer shut down cleanly."""
    src = tmp_path / "in.fastq.gz"
    _write_bgzf(src, _records(60_000))
    offsets, data = _bgzf_block_offsets(src)
    assert len(offsets) > 10, "need a multi-block file"
    victim = offsets[len(offsets) // 2]
    corrupted = bytearray(data)
    for i in range(30, 60):  # clobber deflate payload, keep the header
        corrupted[victim + i] ^= 0xFF
    src.write_bytes(bytes(corrupted))

    out = tmp_path / "out.fastq.gz"
    baseline = threading.active_count()
    with pytest.raises((OSError, FastqFormatError)):
        deduplicate_cluster([str(src)], [str(out)], None, 1, 1.0)
    _assert_threads_settle(baseline)

    # The pipeline stays usable afterwards (no poisoned global state).
    good = tmp_path / "good.fastq.gz"
    _write_bgzf(good, _records(500))
    deduplicate_cluster([str(good)], [str(out)], None, 1, 1.0)


def test_writer_failure_midstream_propagates(tmp_path, monkeypatch):
    """A write() that fails after the stream opened must surface after
    the writer-thread join, not hang or get swallowed."""
    import fastqdedup_tpu.pipeline as pl

    src = tmp_path / "in.fastq.gz"
    with gzip.open(src, "wt") as f:
        f.write(_records(5_000))

    real_xopen = pl.xopen

    class _FailsMidstream:
        def __init__(self, inner):
            self._inner = inner
            self._writes = 0

        def write(self, payload):
            self._writes += 1
            if self._writes >= 2:
                raise OSError("injected mid-stream write failure")
            return self._inner.write(payload)

        def close(self):
            self._inner.close()

    def fake_xopen(path, mode="rb", **kw):
        handle = real_xopen(path, mode, **kw)
        if "w" in mode:
            return _FailsMidstream(handle)
        return handle

    monkeypatch.setattr(pl, "xopen", fake_xopen)
    baseline = threading.active_count()
    out = tmp_path / "out.fastq.gz"
    # Tiny chunks force several writer payloads so write #2 exists.
    with pytest.raises(OSError, match="injected mid-stream"):
        deduplicate_cluster([str(src)], [str(out)], None, 1, 1.0,
                            chunk_records=256)
    _assert_threads_settle(baseline)


def test_quality_pool_exception_races_shutdown(tmp_path):
    """An out-of-range phred byte in the LAST chunk raises ValueError
    through the quality worker -> accumulate worker -> caller chain while
    the producer thread is already winding down."""
    src = tmp_path / "in.fastq.gz"
    good = _records(4_000)
    bad = f"@bad x\nACGTACGT\n+\n{'I' * 7}{chr(127)}\n"  # 127 > '~'
    with gzip.open(src, "wt") as f:
        f.write(good + bad)

    baseline = threading.active_count()
    out = tmp_path / "out.fastq.gz"
    with pytest.raises(ValueError, match="phred"):
        deduplicate_cluster([str(src)], [str(out)], None, 1, 0.001,
                            chunk_records=512)
    _assert_threads_settle(baseline)


def test_corrupt_shard_fails_distributed_2proc(tmp_path):
    """Sharded-input 2-process run where ONE host's shard is corrupt: the
    owning host must exit nonzero with the parse error; the test must not
    deadlock waiting on collectives."""
    import os
    import socket
    import subprocess
    import sys

    good = tmp_path / "shard0.fastq.gz"
    badf = tmp_path / "shard1.fastq.gz"
    _write_bgzf(good, _records(60_000, seed=6))
    _write_bgzf(badf, _records(60_000, seed=7))
    offsets, data = _bgzf_block_offsets(badf)
    victim = offsets[len(offsets) // 2]
    corrupted = bytearray(data)
    for i in range(30, 60):
        corrupted[victim + i] ^= 0xFF
    badf.write_bytes(bytes(corrupted))

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    driver = tmp_path / "driver.py"
    driver.write_text(
        "import sys\n"
        "import jax\n"
        "pid = int(sys.argv[1])\n"
        f"jax.distributed.initialize('127.0.0.1:{port}', 2, pid)\n"
        "from fastqdedup_tpu.pipeline import deduplicate_cluster\n"
        "deduplicate_cluster([sys.argv[2]], [sys.argv[3]], None, 1, 1.0)\n"
        "print('DONE', pid)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo,
               FASTQDEDUP_SHARDED_INPUT="1")
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(driver), str(p), str(shard),
             str(tmp_path / f"out{p}.fastq.gz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p, shard in enumerate([good, badf])]
    try:
        out1 = procs[1].communicate(timeout=180)[0].decode(
            "utf-8", "replace")
        assert procs[1].returncode != 0, out1[-2000:]
        assert "corrupt" in out1.lower() or "inflate" in out1.lower() \
            or "gzip" in out1.lower() or "bgzf" in out1.lower(), \
            out1[-2000:]
    finally:
        # The healthy peer may be parked in a collective that will never
        # complete once its partner died; reap it by exact handle.
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
