#!/bin/sh
# AddressSanitizer pass over the native C library's test surface.
#
# Builds an -fsanitize=address variant of _fastq_io.c and runs the test
# files that exercise it without importing jaxlib's compiled extensions
# (whose statically linked unwinder trips the ASan __cxa_throw
# interceptor — an environment incompatibility, not a finding).  The reference ships no sanitizer job at all
# (SURVEY.md §5).
#
# Usage: sh tools/asan_check.sh
set -e
repo=$(cd "$(dirname "$0")/.." && pwd)
build=$(mktemp -d)
cc -O1 -g -fsanitize=address -pthread -shared -fPIC \
    -o "$build/_fastq_io_asan.so" \
    "$repo/fastqdedup_tpu/native/_fastq_io.c" -lz -ldl
asan_rt=$(cc -print-file-name=libasan.so)
LD_PRELOAD="$asan_rt" \
ASAN_OPTIONS="detect_leaks=0" \
FASTQDEDUP_NATIVE_LIB="$build/_fastq_io_asan.so" \
JAX_PLATFORMS=cpu \
PYTHONPATH="$repo" \
python -m pytest \
    "$repo/tests/test_native_io.py" \
    "$repo/tests/test_parallel_ingest.py" \
    "$repo/tests/test_io.py" \
    "$repo/tests/test_quality.py" \
    "$repo/tests/test_distance.py" \
    -q
rm -rf "$build"
echo "asan_check: native library clean"
