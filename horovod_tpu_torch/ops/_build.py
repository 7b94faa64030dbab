"""Build and load the port's hand-written CUDA kernels.

All sources under ``horovod_tpu_torch/csrc/`` go into one
``torch.utils.cpp_extension.load`` call, compiled by ``nvcc`` for
``sm_90a`` (Hopper, with its architecture-specific instructions) into
``build/horovod_tpu_torch/`` at the root of the checkout. The build runs
at first use, never at import, so the CPU-only tests can import every
module; a failed build raises — nothing falls back to a plain version.
"""

import os
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "horovod_tpu_torch")
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "bindings.cpp")
CUDA_FLAGS = ("-O3", "-std=c++17",
              "-gencode=arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_ext = None


def extension():
    """The compiled extension module, building it on first call."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load
            os.makedirs(BUILD_DIR, exist_ok=True)
            _ext = load(name="horovod_tpu_torch_kernels",
                        sources=[os.path.join(CSRC, s) for s in SOURCES],
                        build_directory=BUILD_DIR,
                        extra_cuda_cflags=list(CUDA_FLAGS),
                        verbose=False)
        return _ext
