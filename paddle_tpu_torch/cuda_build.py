"""Build the port's CUDA sources (paddle_tpu_torch/csrc) at first use.

torch.utils.cpp_extension.load compiles an extension's sources — the
kernels with nvcc for sm_90a, the PyTorch binding with the host compiler —
into its own directory under csrc/build/ (gitignored), links it against
torch and imports it. It reuses a build whose sources and flags are
unchanged and rebuilds an edited one. Nothing here runs at import time; a
machine without nvcc or ninja fails at the first kernel launch with the
builder's own error — the callers never fall back to a plain version.
"""

import os
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# No --use_fast_math, and -fmad=false: the kernels promise bitwise
# agreement with PyTorch's eager ops, which round after every operation.
NVCC_FLAGS = ["-O3", "-fmad=false"]

# {extension name: seconds its load took} for every extension this process
# loaded (chip_smoke.py prints it)
BUILT = {}


def load(name, sources, build_dir=None):
    """Build (or reuse) and import the extension `name` from csrc/`sources`,
    in `build_dir` (default csrc/build/<name>)."""
    from torch.utils import cpp_extension

    build_dir = build_dir or os.path.join(BUILD_DIR, name)
    os.makedirs(build_dir, exist_ok=True)  # load() needs it for its lock
    t0 = time.perf_counter()
    module = cpp_extension.load(
        name=name, sources=[os.path.join(CSRC_DIR, s) for s in sources],
        build_directory=build_dir, extra_cflags=["-O3"],
        extra_cuda_cflags=ARCH_FLAGS + NVCC_FLAGS, verbose=False)
    BUILT[name] = time.perf_counter() - t0
    return module
