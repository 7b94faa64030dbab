"""The port's device-trace summarization
(``horovod_tpu_torch/utils/profiling.py``) against the JAX package's
(``horovod_tpu/utils/profiling.py``):

  * ``_merge_intervals``, ``overlap_accounting`` and
    ``profile_decomposition`` on the same ``OpEvent`` lists (op names
    both packages classify alike: the port's classes keep every JAX
    needle) give equal results;
  * the CUDA kernel names of the port's path land in the reference's
    class names (flash_fwd, flash_dq, flash_dkv, collective, matmul,
    copy, fusion);
  * ``summarize_trace`` on a small Chrome trace written here (device
    events by category, lanes by pid/tid), and on a real
    ``torch.profiler`` CPU capture, which has no device event;
  * ``main`` prints the decomposition.
"""

import json

import numpy as np
import pytest
import torch

from horovod_tpu.utils import profiling as jp
from horovod_tpu_torch.utils import profiling as tp

# name, lane, start ms, end ms: two compute lanes and a comm lane
EVENTS = [
    ("fusion.1", "0/1", 0.0, 2.0),
    ("dot.3", "0/1", 2.0, 5.5),
    ("all-reduce.2", "0/2", 1.0, 4.0),
    ("all-reduce.2", "0/2", 6.0, 7.0),
    ("copy.9", "0/1", 5.5, 6.5),
    ("custom-call.fwd_kernel", "0/1", 7.5, 8.0),
    ("custom-call.dq_kernel", "0/3", 8.0, 9.0),
    ("custom-call.dkv_kernel", "0/3", 9.0, 9.25),
    ("mystery", "0/1", 9.0, 9.5),
]


def _summary(mod):
    rows = {}
    for name, _, s, e in EVENTS:
        r = rows.setdefault(name, [0.0, 0])
        r[0] += e - s
        r[1] += 1
    return mod.TraceSummary(
        [mod.OpRow(n, n.split(".")[0], ms, c, "") for n, (ms, c)
         in rows.items()],
        events=[mod.OpEvent(n, lane, s, e) for n, lane, s, e in EVENTS],
        lane_names={"0/2": "stream 2"})


@pytest.mark.parametrize("ivs", [
    [(0, 2), (1, 3), (5, 6), (6, 7), (9, 9), (8, 8.5)],
    [(3, 4), (0, 1)], []])
def test_merge_intervals_equal(ivs):
    assert tp._merge_intervals(ivs) == jp._merge_intervals(ivs)
    a, b = tp._merge_intervals(ivs), tp._merge_intervals([(0.5, 6.5)])
    assert tp._intersect_ms(a, b) == jp._intersect_ms(a, b)


@pytest.mark.parametrize("steps", [1, 3])
def test_overlap_and_decomposition_equal(steps):
    t, j = _summary(tp), _summary(jp)
    for row in t.rows:
        assert tp.classify_op(row) == jp.classify_op(row)
    assert tp.overlap_accounting(t, steps=steps) == \
        jp.overlap_accounting(j, steps=steps)
    for wall in (None, 0.0, 12.5):
        assert tp.profile_decomposition(t, wall_ms=wall, steps=steps) == \
            jp.profile_decomposition(j, wall_ms=wall, steps=steps)
    assert tp.overlap_accounting(tp.TraceSummary([])) is None


@pytest.mark.parametrize("name,cls", [
    ("void flash_fwd_sm90_kernel<128, 128, true>(Params)", "flash_fwd"),
    ("flash_fwd_cc_kernel", "flash_fwd"),
    ("flash_fwd_dyn_kernel", "flash_fwd"),
    ("void flash_bwd_sm90_dq_kernel<128>(BwdParams)", "flash_dq"),
    ("flash_bwd_dq_cc_kernel", "flash_dq"),
    ("flash_bwd_dkv_dyn_kernel", "flash_dkv"),
    ("void flash_bwd_sm90_dkv_kernel<128>(BwdParams)", "flash_dkv"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)",
     "collective"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "matmul"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", "matmul"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::bfloat16_copy_kernel_cuda>", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::AddFunctor<float>>", "fusion"),
    ("void at::native::reduce_kernel<512, 1, ReduceOp<float>>", "fusion"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel"
     "<at::native::(anonymous namespace)::TensorListMetadata<4>, "
     "FusedAdamMathFunctor<float, 4>>", "fusion"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
     "<float, float, true>", "fusion"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, "
     "float, float, float, Epilogue>", "fusion"),
    ("void at_cuda_detail::cub::DeviceScanKernel<Policy900, float*>",
     "fusion"),
    ("void at::native::(anonymous namespace)::indexSelectLargeIndex<float, "
     "long, unsigned int, 2, 2, -2, true>", "copy"),
    ("bn_partial_kernel", "other")])
def test_cuda_kernel_names_land_in_the_reference_classes(name, cls):
    assert tp.classify_op(tp.OpRow(name, "", 1.0, 1, "")) == cls


def _chrome_trace():
    ev = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
           "args": {"name": "stream 7"}},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 11,
           "tid": 11, "ts": 0.0, "dur": 50.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "pid": 11, "tid": 11, "ts": 1.0, "dur": 3.0}]
    for i, (name, tid, ts, dur, cat) in enumerate([
            ("nvjet_tst_gemm", 7, 10.0, 1000.0, "kernel"),
            ("ncclDevKernel_AllReduce_Sum_f32", 13, 500.0, 2000.0,
             "kernel"),
            ("flash_fwd_sm90_kernel", 7, 1010.0, 300.0, "kernel"),
            ("Memcpy HtoD (Pageable -> Device)", 7, 2600.0, 100.0,
             "gpu_memcpy"),
            ("Memset (Device)", 7, 2700.0, 5.0, "gpu_memset")]):
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0,
                   "tid": tid, "ts": ts, "dur": dur,
                   "args": {"stream": tid}})
    return {"traceEvents": ev, "baseTimeNanoseconds": 10 ** 18}


def test_summarize_a_written_chrome_trace(tmp_path):
    path = tmp_path / "prof" / "trace.json"
    path.parent.mkdir()
    path.write_text(json.dumps(_chrome_trace()))
    for where in (str(path), str(path.parent)):
        s = tp.summarize_trace(where)
        assert sorted(r.name for r in s.rows) == sorted(
            e["name"] for e in _chrome_trace()["traceEvents"]
            if e.get("cat") in tp.DEVICE_CATEGORIES)
        assert s.total_ms == pytest.approx(3.405)
        assert s.lane_names == {"0/7": "stream 7"}
    ov = tp.overlap_accounting(s)
    # the collective [0.5, 2.5) ms overlaps compute [0.01, 1.31) ms
    assert ov["comm_ms_per_step"] == 2.0
    assert ov["hidden_comm_ms"] == pytest.approx(0.81)
    assert ov["exposed_comm_ms"] == pytest.approx(1.19)
    dec = tp.profile_decomposition(str(path), wall_ms=4.0)
    assert {c["class"] for c in dec["classes"]} == \
        {"matmul", "collective", "flash_fwd", "copy"}
    assert sum(c["ms_per_step"] for c in dec["classes"]) == \
        pytest.approx(dec["device_ms_per_step"], abs=2e-3)
    assert dec["device_busy_frac"] == pytest.approx(3.405 / 4.0, abs=1e-4)
    assert "peak_hbm_bytes" not in dec        # no allocator on the CPU


def test_summarize_a_real_cpu_capture(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        a = torch.randn(64, 64)
        (a @ a).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    s = tp.summarize_trace(str(path))
    assert s.rows == [] and s.events == []     # no device event on a CPU
    assert tp.summarize_profile(prof).rows == []
    dec = tp.profile_decomposition(s, wall_ms=1.0)
    assert dec["device_ms_per_step"] == 0.0 and dec["classes"] == []


def test_device_events_from_a_live_profiler(tmp_path):
    # a real CPU capture: no device event, and the profiler's start is
    # the epoch its events are timed from (an exported trace's host
    # events at baseTimeNanoseconds + ts land on the same instants)
    import types
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        a = torch.randn(64, 64)
        for _ in range(3):
            (a @ a).sum()
    assert tp.device_events(prof) == []
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    exported = sorted(base_us + e["ts"] for e in trace["traceEvents"]
                      if e.get("name") == "aten::mm")
    live = sorted(tp.trace_start_us(prof) + e.time_range.start
                  for e in prof.events() if e.name == "aten::mm")
    assert len(live) == len(exported) == 3
    assert max(abs(x - y) for x, y in zip(live, exported)) < 2.0
    # the card's events (stand-ins here) become Chrome X events in
    # epoch µs, their lane the (device, stream) pair, anchored on their
    # launch calls (a pair shares its correlation id; an aten op with the
    # same number is no launch)
    res = types.SimpleNamespace(trace_start_ns=lambda: 5_000_000)
    fake = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=res),
        events=lambda: [types.SimpleNamespace(
            id=i, device_type=dev, name=name, device_index=0,
            device_resource_id=7, time_range=types.SimpleNamespace(
                start=start, elapsed_us=lambda: 2.5))
            for i, dev, name, start in [
                (11, DeviceType.CUDA, "nvjet_tst_gemm", 10.0),
                (11, DeviceType.CPU, "cudaLaunchKernel", 4.0),
                (12, DeviceType.CPU, "aten::mm", 19.5),
                (12, DeviceType.CPU, "cudaMemcpyAsync", 17.0),
                (12, DeviceType.CUDA, "Memcpy DtoD (Device -> Device)", 20.0),
                (13, DeviceType.CUDA, "Memset (Device)", 30.0)]])
    assert tp.launch_gap_us(fake) == 3.0
    # every launch call (the kernel's, the copy's) has its device event
    assert tp.unrecorded_launches(fake) == (2, [])
    want = [("nvjet_tst_gemm", "kernel", 10.0),
            ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 20.0),
            ("Memset (Device)", "gpu_memset", 30.0)]
    for anchor, shift in ((False, 0.0), (True, 3.0)):
        assert tp.device_events(fake, anchor=anchor) == [
            {"name": n, "cat": c, "ph": "X", "pid": 0, "tid": 7,
             "ts": 5000.0 + ts - shift, "dur": 2.5} for n, c, ts in want]
    assert tp.launch_gap_us(prof) is None      # no launch on the CPU
    assert tp.unrecorded_launches(prof) == (0, [])


def test_unrecorded_launches_names_the_dropped_device_records():
    # host launch calls whose device event the profiler dropped are named;
    # a runtime call that queues nothing (an event record) is no launch
    import types
    from torch.autograd import DeviceType
    fake = types.SimpleNamespace(events=lambda: [
        types.SimpleNamespace(id=i, device_type=dev, name=name)
        for i, dev, name in [
            (21, DeviceType.CPU, "cudaLaunchKernel"),
            (22, DeviceType.CPU, "cudaMemcpyAsync"),
            (23, DeviceType.CPU, "cuLaunchKernelEx"),
            (24, DeviceType.CPU, "cudaEventRecord"),
            (25, DeviceType.CPU, "cudaMemsetAsync"),
            (0, DeviceType.CPU, "cudaLaunchKernel"),
            (23, DeviceType.CUDA, "ncclDevKernel_AllReduce_Sum_bf16"),
            (25, DeviceType.CUDA, "Memset (Device)")]])
    assert tp.unrecorded_launches(fake) == (
        4, ["cudaLaunchKernel", "cudaMemcpyAsync"])


def test_main_prints_the_decomposition(tmp_path, capsys):
    path = tmp_path / "trace.json.gz"
    import gzip
    with gzip.open(path, "wt") as f:
        json.dump(_chrome_trace(), f)
    tp.main([str(path), "--decompose", "--wall-ms", "4", "--steps", "1"])
    out = json.loads(capsys.readouterr().out)
    assert out["device_ms_per_step"] == pytest.approx(3.405)
    tp.main([str(path), "-n", "2"])
    assert "device-op total: 3.4 ms" in capsys.readouterr().out
