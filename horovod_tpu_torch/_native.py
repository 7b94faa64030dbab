"""ctypes binding to the native host core (libhvd_core.so).

The port's counterpart of ``horovod_tpu/_native/__init__.py``: the same
flat extern-C surface for the fusion planner ``hvd_plan_buckets``, the
timeline writer and the autotuner's GP engine (``hvd_autotune_*``),
compiled from ``csrc/host/`` by the host C++ compiler
at first use into ``build/horovod_tpu_torch/`` at the root of the
checkout, and loaded with ``ctypes.CDLL`` (reference
horovod/common/basics.py:25-28). The build never runs at import. A
failed build raises with the compiler's error: nothing falls back to a
Python implementation, except where the JAX package's own rule does:
the autotuner takes its random-search engine when ``available()`` is
False, and says so.
"""

import ctypes
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc", "host")
SOURCES = ("hvd_core.cc", "timeline.cc", "autotune.cc")
HEADERS = ("hvd_core.h",)
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "horovod_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libhvd_core.so")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-fvisibility=hidden")

_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    """The host compiler refused the native core's sources."""


def _configure(lib):
    c = ctypes
    lib.hvd_core_version.restype = c.c_char_p

    lib.hvd_plan_buckets.restype = c.c_int64
    lib.hvd_plan_buckets.argtypes = [
        c.c_int64, c.POINTER(c.c_int64), c.POINTER(c.c_int32), c.c_int64,
        c.POINTER(c.c_int32)]

    lib.hvd_timeline_create.restype = c.c_void_p
    lib.hvd_timeline_create.argtypes = [c.c_char_p, c.c_int, c.c_int64,
                                        c.c_int64]
    lib.hvd_timeline_destroy.argtypes = [c.c_void_p]
    lib.hvd_timeline_event.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p,
                                       c.c_int]
    lib.hvd_timeline_cycle.argtypes = [c.c_void_p]
    lib.hvd_timeline_pending.restype = c.c_int64
    lib.hvd_timeline_pending.argtypes = [c.c_void_p]

    lib.hvd_autotune_create.restype = c.c_void_p
    lib.hvd_autotune_create.argtypes = [c.c_double, c.c_double, c.c_double,
                                        c.c_double, c.c_uint64]
    lib.hvd_autotune_destroy.argtypes = [c.c_void_p]
    lib.hvd_autotune_record.argtypes = [c.c_void_p, c.c_double, c.c_double,
                                        c.c_double]
    lib.hvd_autotune_suggest.argtypes = [c.c_void_p, c.POINTER(c.c_double),
                                         c.POINTER(c.c_double)]
    lib.hvd_autotune_num_samples.restype = c.c_int64
    lib.hvd_autotune_num_samples.argtypes = [c.c_void_p]
    lib.hvd_autotune_best.restype = c.c_int
    lib.hvd_autotune_best.argtypes = [c.c_void_p, c.POINTER(c.c_double),
                                      c.POINTER(c.c_double),
                                      c.POINTER(c.c_double)]
    return lib


def build(force=False):
    """Compile libhvd_core.so with the host C++ compiler (``$CXX``, else
    g++); a no-op when the library is newer than every source. Raises
    ``NativeBuildError`` carrying the compiler's output on failure."""
    deps = [os.path.join(SRC_DIR, f) for f in SOURCES + HEADERS]
    if not force and os.path.exists(LIB_PATH) and \
            os.path.getmtime(LIB_PATH) >= max(map(os.path.getmtime, deps)):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build beside the target and rename: a concurrent loader never sees
    # a half-written library
    tmp = f"{LIB_PATH}.{os.getpid()}.{threading.get_ident()}"
    cmd = ([os.environ.get("CXX", "g++")] + list(CXX_FLAGS) + ["-o", tmp] +
           [os.path.join(SRC_DIR, f) for f in SOURCES])
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise NativeBuildError(f"cannot run the host compiler {cmd[0]!r}: "
                               f"{exc}") from exc
    if proc.returncode:
        raise NativeBuildError(
            f"building the native core failed ({' '.join(cmd)}):\n"
            f"{proc.stderr or proc.stdout}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def load():
    """The loaded library, building it on first call."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            _lib = _configure(ctypes.CDLL(LIB_PATH))
        return _lib


def available():
    """Whether the native core loads (building it if need be); False,
    never an exception, when the host compiler refuses it or
    ``HVD_DISABLE_NATIVE=1`` is set (the JAX package's switch)."""
    if os.environ.get("HVD_DISABLE_NATIVE", "") in ("1", "true"):
        return False
    try:
        load()
    except NativeBuildError:
        return False
    return True
