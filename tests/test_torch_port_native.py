"""horovod_tpu_torch's native host core (``_native``, ``csrc/host/``)
against the JAX package's: the fusion planner ``hvd_plan_buckets``, its
plain version ``_python_plan`` and the JAX ``plan_buckets`` give equal
assignments over seeded sizes and dtypes; the timeline writer behaves
as ``tests/test_native.py`` holds the JAX core's to; a failed build
raises with the compiler's error. ``bucket_stats`` and
``fused_map`` of ``ops/fusion.py`` against the JAX functions.

The port's core is built here with the host compiler (g++) into
``build/horovod_tpu_torch/`` at first use.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu_torch import _native
from horovod_tpu_torch.ops import fusion as tfusion

DTYPES = ("float32", "bfloat16", "int32", "float16", "int64")
THRESHOLDS = (0, 1, 5000, 50000, 10 ** 9)


class _Meta:
    """A leaf the planners size by shape and dtype name."""

    def __init__(self, n, dtype):
        self.shape, self.dtype = (n,), dtype


def lib():
    return _native.load()


def _case(seed, n=64):
    rng = np.random.RandomState(seed)
    elems = [int(s) for s in rng.randint(1, 4000, n)]
    dtypes = [DTYPES[i] for i in rng.randint(0, len(DTYPES), n)]
    return elems, dtypes


def test_version():
    assert lib().hvd_core_version().decode() == "0.1.0"


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_matches_python_plan_and_jax(threshold, seed):
    """Bucket assignments: native == plain == the JAX package's
    ``plan_buckets`` over the same element counts and dtypes."""
    from horovod_tpu.ops import fusion as jfusion
    elems, dtypes = _case(seed)
    leaves = [_Meta(n, d) for n, d in zip(elems, dtypes)]
    sizes = [tfusion._nbytes(m) for m in leaves]
    native = tfusion._native_plan(sizes, dtypes, threshold)
    assert native == tfusion._python_plan(sizes, dtypes, threshold)
    got = [(b.indices, b.nbytes)
           for b in tfusion.plan_buckets(leaves, threshold)]
    want = [(b.indices, b.nbytes) for b in jfusion.plan_buckets(
        [jax.ShapeDtypeStruct((n,), jnp.dtype(d))
         for n, d in zip(elems, dtypes)], threshold)]
    assert got == want


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_plan_of_tensors_equals_plan_of_metas(threshold):
    """Torch tensors and their (shape, dtype-name) metas plan alike."""
    elems, dtypes = _case(7, n=24)
    tensors = [torch.zeros(n, dtype=getattr(torch, d))
               for n, d in zip(elems, dtypes)]
    metas = [_Meta(n, d) for n, d in zip(elems, dtypes)]
    assert [b.indices for b in tfusion.plan_buckets(tensors, threshold)] \
        == [b.indices for b in tfusion.plan_buckets(metas, threshold)]


def test_plan_lookahead_skips_oversized():
    """FuseResponses look-ahead (operations.cc:478-533): an entry that
    does not fit the open bucket is skipped — later same-dtype entries
    still join that bucket."""
    sizes = [4096, 4096, 100 << 20, 4096]
    dtypes = ["float32"] * 4
    for plan in (tfusion._python_plan(sizes, dtypes, 64 << 20),
                 tfusion._native_plan(sizes, dtypes, 64 << 20)):
        assert plan[0] == plan[1] == plan[3], plan
        assert plan[2] != plan[0], plan


def test_native_timeline_writes_chrome_trace(tmp_path):
    from horovod_tpu_torch.utils import timeline as tl
    path = str(tmp_path / "tl.json")
    t = tl.NativeTimeline(path, mark_cycles=True)
    t.negotiate_start("grad/w", "allreduce")
    t.negotiate_end("grad/w")
    t.start_activity("grad/w", tl.ALLREDUCE)
    t.end_activity("grad/w")
    t.mark_cycle_start()
    deadline = time.monotonic() + 5
    while t.pending() and time.monotonic() < deadline:
        time.sleep(0.01)
    t.close()
    events = json.load(open(path))
    names = [e.get("name") for e in events]
    assert "NEGOTIATE_ALLREDUCE" in names and "ALLREDUCE" in names
    assert "CYCLE_START" in names
    assert {"process_name", "clock_sync"} <= set(names)
    phases = [e.get("ph") for e in events if e.get("pid") == 1]
    assert phases.count("B") == phases.count("E") == 2


def test_failed_build_raises_with_the_compilers_error(tmp_path,
                                                       monkeypatch):
    """A source the compiler refuses raises NativeBuildError naming the
    compiler's diagnosis; nothing falls back to Python."""
    src = tmp_path / "src"
    src.mkdir()
    for f in _native.SOURCES + _native.HEADERS:
        (src / f).write_text(open(os.path.join(_native.SRC_DIR, f)).read())
    (src / "hvd_core.cc").write_text("this is not C++;\n")
    monkeypatch.setattr(_native, "SRC_DIR", str(src))
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_native, "LIB_PATH",
                        str(tmp_path / "build" / "libhvd_core.so"))
    with pytest.raises(_native.NativeBuildError, match="error"):
        _native.build()


@pytest.mark.parametrize("sizes", [(5, 3, 8), (4, 4, 4), (1,), (7, 0, 2)])
def test_bucket_stats_matches_jax(sizes):
    from horovod_tpu.ops import fusion as jfusion
    rng = np.random.RandomState(sum(sizes))
    flat = rng.randn(sum(sizes)).astype(np.float32)
    flat[::4] = 0.0
    if len(flat) > 2:
        flat[1], flat[2] = np.inf, np.nan
    got = tfusion.bucket_stats(torch.from_numpy(flat), sizes).numpy()
    want = np.asarray(jfusion.bucket_stats(jnp.asarray(flat), sizes))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("threshold", [0, 64, 10 ** 6])
def test_fused_map_matches_jax(threshold):
    from horovod_tpu.ops import fusion as jfusion
    rng = np.random.RandomState(3)
    arrays = [rng.randn(*s).astype(np.float32)
              for s in ((3, 4), (5,), (2, 2, 2), (9,))]
    calls = []

    def fn(flat):
        calls.append(flat.shape[0])
        return flat * 2.0 + 1.0
    got = tfusion.fused_map(fn, [torch.from_numpy(a) for a in arrays],
                            threshold)
    n_port = len(calls)
    want = jfusion.fused_map(fn, [jnp.asarray(a) for a in arrays],
                             threshold)
    assert n_port == len(calls) - n_port
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
