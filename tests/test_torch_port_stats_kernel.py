"""The numerics plane's stats kernel (``csrc/segment_stats.cu``): what of
it runs on the CPU.

  * the kernel's layout (``numerics.kernel_layout``): every chunk lies in
    one slice, the chunks of a slice cover it in order, none for an empty
    slice, at both element sizes;
  * the wrapper: a buffer that is not on the CPU (a ``meta`` tensor here)
    goes to the kernel's entry point once a call, in its own dtype, with
    the cached layout and float64 partials of 5 per chunk, and never to
    the plain version; a CPU buffer runs the plain version;
  * the plain version (``segment_stats_plain``, which the kernel is held
    against on the card) against the JAX package's ``segment_stats`` on
    the edge layouts: empty slices, slices shorter than a kernel chunk,
    slices across several chunks, with NaN, +-inf and zeros planted (fp32
    norms and checksum within rtol 1e-6, counts exact), and one slice of
    several chunks against float64 numpy;
  * ``overhead_gate``: ``bench.py``'s protocol (an off and an on window a
    round, the side that runs first alternating; the best window of each
    side; another round only while over budget, up to the cap; raise past
    the budget);
  * ``NumericsMonitor._park`` takes its host buffers from a pool: after
    the first groups are read, parks of the same shape allocate nothing.

The kernel itself is held against the plain version and float64 on the
card by ``chip_smoke.py`` phase 3n (b).
"""

import math

import numpy as np
import pytest
import torch

from horovod_tpu.utils import numerics as jn
from horovod_tpu_torch.utils import numerics as tn

EDGE_LAYOUTS = [[0], [5, 0, 3], [0, 1, 0, 0, 2], [16383, 16384, 16385],
                [0, 3 * 16384 + 7, 0, 2], [1, 32768 * 2 + 1, 1]]


def _planted(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    for i, v in zip((1, n // 3, n // 2, n - 2), (np.nan, np.inf, -np.inf,
                                                  0.0)):
        if 0 <= i < n:
            x[i] = v
    if n > 10:
        x[5:9] = 0.0
    return x


def _np_rows(x, sizes):
    rows, off = [], 0
    for n in sizes:
        f = x[off:off + n].astype(np.float64)
        fin = np.isfinite(f)
        safe = np.where(fin, f, 0.0)
        rows.append([math.sqrt(float(np.sum(safe * safe))),
                     float(np.max(np.abs(safe))) if n else 0.0,
                     float(n - np.count_nonzero(fin)),
                     float(np.count_nonzero(f == 0.0)) / max(n, 1),
                     float(np.sum(safe))])
        off += n
    return np.array(rows)


def _assert_rows(got, want, rtol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=0, atol=1e-7)
    for c in (0, 1, 4):
        np.testing.assert_allclose(
            got[:, c], want[:, c], rtol=rtol,
            atol=1e-6 * max(float(np.abs(want[:, 0]).max(initial=0.0)), 1.0)
            if c == 4 else 1e-30)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("sizes", EDGE_LAYOUTS)
def test_kernel_layout_chunks_each_slice(sizes, itemsize):
    per = tn.KERNEL_CHUNK_BYTES // itemsize
    starts, first, n_chunks = tn.kernel_layout(tuple(sizes), itemsize,
                                               "cpu")
    starts, first = starts.tolist(), first.tolist()
    assert n_chunks == len(starts) - 1 == sum(-(-n // per) for n in sizes)
    assert starts[-1] == sum(sizes) and first[-1] == n_chunks
    off = 0
    for i, n in enumerate(sizes):
        cs = starts[first[i]:first[i + 1] + 1]
        if not n:
            assert first[i] == first[i + 1]
        else:
            assert cs[0] == off and cs[-1] == off + n
            assert all(0 < b - a <= per for a, b in zip(cs, cs[1:]))
        off += n
    # cached: the same tensors for the same layout
    again = tn.kernel_layout(tuple(sizes), itemsize, "cpu")
    assert again[0] is tn.kernel_layout(tuple(sizes), itemsize, "cpu")[0]


class _Stub:
    """Stands in for the compiled extension: records each stats call."""

    def __init__(self):
        self.calls = []

    def segment_stats(self, x, starts, first, part, out):
        self.calls.append((x.dtype, x.device.type, starts, first,
                           part.dtype, part.numel(), tuple(out.shape),
                           out.dtype))


@pytest.mark.parametrize("dtype,read_as", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.bfloat16),
                                           (torch.float16, torch.float16),
                                           (torch.int32, torch.float32)])
def test_a_device_buffer_launches_the_kernel_once(monkeypatch, dtype,
                                                  read_as):
    stub = _Stub()
    monkeypatch.setattr(tn, "extension", lambda: stub)

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a device buffer")
    monkeypatch.setattr(tn, "segment_stats_plain", no_plain)
    tn.reset_launch_counts()
    sizes = [3, 0, 40000, 17]
    flat = torch.empty(sum(sizes), dtype=dtype, device="meta")
    for _ in range(2):
        out = tn.segment_stats(flat, sizes)
        assert out.shape == (4, 5) and out.dtype == torch.float32
    assert tn.launch_counts["segment_stats"] == 2
    per = tn.KERNEL_CHUNK_BYTES // torch.empty(0, dtype=read_as).itemsize
    n_chunks = sum(-(-n // per) for n in sizes)
    (d0, dev0, s0, f0, pd, pn, oshape, odt), second = stub.calls
    assert (d0, dev0, pd, pn, oshape, odt) == (
        read_as, "meta", torch.float64, 5 * n_chunks, (4, 5), torch.float32)
    # the second call reuses the cached layout: the same device tensors
    assert second[2] is s0 and second[3] is f0
    with pytest.raises(ValueError, match="slices"):
        tn.segment_stats(flat, [1, 2])


def test_a_cpu_buffer_runs_the_plain_version(monkeypatch):
    def no_kernel():
        raise AssertionError("the kernel was reached for a CPU buffer")
    monkeypatch.setattr(tn, "extension", no_kernel)
    x = torch.from_numpy(_planted(100, 0))
    got = tn.segment_stats(x, [60, 0, 40]).numpy()
    _assert_rows(got, _np_rows(x.numpy(), [60, 0, 40]))


@pytest.mark.parametrize("sizes", EDGE_LAYOUTS[:3] + [[16383, 2, 16385]])
def test_plain_stats_match_jax_on_edge_layouts(sizes):
    x = _planted(sum(sizes), len(sizes))
    got = tn.segment_stats_plain(torch.from_numpy(x), sizes).numpy()
    want = np.asarray(jn.segment_stats(x, sizes))
    _assert_rows(got, want)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("sizes", EDGE_LAYOUTS[3:])
def test_plain_stats_across_kernel_chunks_against_float64(sizes):
    # the JAX package's cumulative-sum layout is itself good to ~5e-3
    # beside a slice this long, so these are held to float64
    x = _planted(sum(sizes), sum(sizes))
    got = tn.segment_stats_plain(torch.from_numpy(x), sizes).numpy()
    _assert_rows(got, _np_rows(x, sizes))


def _scripted(values):
    calls = []
    it = iter(values)

    def window(enabled):
        calls.append(enabled)
        return next(it)
    return window, calls


def test_overhead_gate_takes_the_best_interleaved_windows():
    # round 1 over budget (+4 %), round 2 (on first) brings the best on
    # within 2 % of the best off, whichever round each came from
    window, calls = _scripted([100.0, 104.0, 101.5, 101.0, 99.0, 99.0])
    out = tn.overhead_gate(window, budget_pct=2.0, rounds=3)
    assert calls == [False, True, True, False]
    assert out["rounds"] == 2
    assert out["off_best_ms"] == 100.0 and out["on_best_ms"] == 101.5
    assert out["overhead_pct"] == pytest.approx(1.5)
    # within budget at once: one round
    window, calls = _scripted([50.0, 50.5])
    assert tn.overhead_gate(window)["rounds"] == 1 and len(calls) == 2
    # a faster on side reads negative and passes
    window, _ = _scripted([50.0, 49.0])
    assert tn.overhead_gate(window)["overhead_pct"] == pytest.approx(-2.0)


def test_overhead_gate_raises_past_the_budget_after_the_cap():
    window, calls = _scripted([100.0, 110.0, 103.0, 100.0, 101.0, 102.5])
    with pytest.raises(AssertionError, match="exceeds the 2.0% budget"):
        tn.overhead_gate(window, budget_pct=2.0, rounds=3)
    assert calls == [False, True, True, False, False, True]


class _Event:
    def record(self, stream=None):
        pass

    def query(self):
        return True

    def synchronize(self):
        pass


def test_park_reuses_its_pinned_buffers(monkeypatch):
    allocs = []
    real_empty = torch.empty

    def empty(*shape, pin_memory=False, **kw):
        t = real_empty(*shape, **kw)
        if pin_memory:
            allocs.append(t)
        return t
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        None)
    mon = tn.NumericsMonitor()
    names = ["a", "b"]
    for i in range(6):
        mat = torch.full((2, 5), float(i + 1))
        mon._park(("stats", names, i), mat)
        assert mon.take_records()[i]["a"][0] == float(i + 1)
    # one buffer, read and given back before the next park
    assert len(allocs) == 1
    mon._park(("stats", names, 7), torch.ones(3, 5))
    assert len(allocs) == 2
