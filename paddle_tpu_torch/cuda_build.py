"""Build the port's CUDA sources (paddle_tpu_torch/csrc) at first use.

One extension holds every kernel: torch.utils.cpp_extension.load compiles
all of csrc/'s `.cu` files with nvcc for sm_90a and the one PyTorch
binding, csrc/kernels_binding.cpp, with the host compiler (ninja runs them
in parallel), links them against torch into csrc/build/ (gitignored) and
imports the result. It reuses a build whose sources and flags are
unchanged and rebuilds an edited one. Nothing here runs at import time; a
machine without nvcc or ninja fails at the first kernel launch with the
builder's own error — the callers never fall back to a plain version.
"""

import glob
import os
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build", "kernels")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# No --use_fast_math, and -fmad=false: the update kernels promise bitwise
# agreement with PyTorch's eager ops, which round after every operation.
# Kernels that want fused multiply-adds write them as __fmaf_rn.
NVCC_FLAGS = ["-O3", "-fmad=false"]
# Link the shared libstdc++ ahead of anything the compiler adds. A g++ that
# links libstdc++ statically (some toolchains that `CXX` names do) gives
# the extension its own copy of the iostream and locale code, whose
# facet ids disagree with the process's shared libstdc++: formatting any
# number into a stream, as a TORCH_CHECK message with an integer does, then
# segfaults. With the shared library first, there is one copy.
LD_FLAGS = ["-l:libstdc++.so.6"]

_module = None
# seconds the one load() of this process took (chip_smoke.py prints it)
build_seconds = None
# every kernel wrapper's launch counts, as (wrapper, attribute) pairs
_counters = []


def count_launches(wrapper, *attrs):
    """Give `wrapper` the integer launch counts `attrs` (0 each) and list
    them, so that code which runs the wrappers without launching, as a CUDA
    graph capture does, can read and restore them (`launch_counts`)."""
    for attr in attrs:
        setattr(wrapper, attr, 0)
        _counters.append((wrapper, attr))


def launch_counts():
    """{(wrapper, attribute): count} of every listed launch count."""
    return {(w, a): getattr(w, a) for w, a in _counters}


def set_launch_counts(counts):
    for (wrapper, attr), n in counts.items():
        setattr(wrapper, attr, n)


def sources():
    """Every kernel source of csrc/ plus the one binding, in a fixed order."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))) + [
        os.path.join(CSRC_DIR, "kernels_binding.cpp")]


def kernels():
    """Build (first call only) and import the extension with every kernel."""
    global _module, build_seconds
    if _module is None:
        from torch.utils import cpp_extension

        os.makedirs(BUILD_DIR, exist_ok=True)  # load() needs it for its lock
        t0 = time.perf_counter()
        _module = cpp_extension.load(
            name="paddle_tpu_torch_kernels", sources=sources(),
            build_directory=BUILD_DIR, extra_cflags=["-O3"],
            extra_cuda_cflags=ARCH_FLAGS + NVCC_FLAGS, extra_ldflags=LD_FLAGS,
            verbose=False)
        build_seconds = time.perf_counter() - t0
    return _module
