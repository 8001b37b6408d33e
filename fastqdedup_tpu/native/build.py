"""On-demand compiler for the native host-I/O library.

Builds ``_fastq_io.c`` into a shared library next to the source the first
time the native path is imported (and whenever the source is newer than the
built artifact).  ``setup.py`` performs the same build at install time; this
fallback keeps source checkouts fast without an install step.
"""

import os
import subprocess
import sysconfig

_SRC = os.path.join(os.path.dirname(__file__), "_fastq_io.c")
_LIB = os.path.join(os.path.dirname(__file__), "_fastq_io.so")


def library_path() -> str:
    """Path to the built shared library, compiling it if needed."""
    if os.path.exists(_LIB) and \
            os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return _LIB
    return build()


def build() -> str:
    """Compile ``_fastq_io.c`` into the shared library now, whatever is
    on disk; raises ImportError when it cannot."""
    cc = sysconfig.get_config_var("CC") or os.environ.get("CC") or "cc"
    # Unique temp name + atomic replace: concurrent processes (e.g. a
    # jax.distributed job whose hosts all find the source newer) may
    # build simultaneously without clobbering each other's output.
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = cc.split() + ["-O3", "-pthread", "-shared", "-fPIC", "-o",
                        tmp, _SRC, "-lz", "-ldl"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, _LIB)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise ImportError(
            f"could not build native FASTQ parser: {detail}") from e
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    return _LIB
