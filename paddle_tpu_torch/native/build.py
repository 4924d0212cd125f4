"""Build the port's native libraries at first use (g++; cached by mtime).

Each library is a standalone .so with a C ABI, bound with ctypes. It is
built into native/build/ (gitignored) beside its sources, never loaded
from the JAX package. The build writes a temporary file and renames it, so
processes that build at once (test workers, decode worker processes) each
load a whole library.
"""

import os
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "build")
# Link the shared libstdc++ ahead of anything the compiler adds: a g++ that
# links libstdc++ statically would give the library its own copy beside the
# process's (the same rule as cuda_build.LD_FLAGS).
LD_FLAGS = ["-l:libstdc++.so.6"]


def build_library(name, sources, extra_flags=(), deps=()):
    """Compile `sources` (file names in this directory) into
    build/lib<name>.so; returns its path. Rebuilds when a source or a
    header it includes (`deps`) is newer than the library."""
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    srcs = [os.path.join(_HERE, s) for s in sources]
    watch = srcs + [os.path.join(_HERE, d) for d in deps]
    if os.path.exists(out) and all(
            os.path.getmtime(out) >= os.path.getmtime(s) for s in watch):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".lib{name}.", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-o", tmp,
           *srcs, *extra_flags, *LD_FLAGS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"native build failed: {' '.join(cmd)}\n{e.stderr}") from e
    except FileNotFoundError:
        raise RuntimeError(f"g++ not found: the native library {name!r} "
                           f"cannot be built") from None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def recordio_lib():
    return build_library("recordio", ["recordio.cc"], ["-lz"])


def infer_lib():
    """The native inference predictor (infer.cc over runtime.h)."""
    return build_library("ptinfer", ["infer.cc"], deps=["runtime.h"])


def train_lib():
    """The native training runtime (train.cc over runtime.h)."""
    return build_library("pttrain", ["train.cc"], deps=["runtime.h"])
