"""Analytical roofline cost model: where the milliseconds SHOULD go.

The port of ``horovod_tpu/utils/costmodel.py``. ``utils/profiling.py``
measures where step time went; this module computes where it is allowed
to go (per-op-class FLOPs and bytes against the card's peak matmul rate,
HBM and interconnect bandwidth), so that an MFU figure becomes a
decomposition:

    measured MFU 0.17, roofline-bound MFU 0.81
      gap: other +0.52, attention +0.07, matmul +0.05

Three layers, all plain arithmetic:

  * ``chip_spec`` / ``CHIP_SPECS``: nominal per-card peak dense bf16
    FLOPs, HBM bandwidth, interconnect (NVLink) bandwidth and HBM
    capacity by device-name prefix (``torch.cuda.get_device_name``).
  * ``analytic_lm_costs``: per-class FLOPs/bytes per step per card of
    the transformer LM, by the same PaLM appendix-B convention as
    ``models.transformer.matmul_flops_per_token``. ``program_costs``
    counts a step's own FLOPs with ``torch.utils.flop_counter``.
  * ``roofline`` / ``mfu_decomposition``: per-class compute-, memory- or
    comm-bound verdicts (arithmetic intensity against the ridge point)
    and the achievable-MFU decomposition.

All "bytes" figures are a traffic model, not a measurement: weights make
three HBM passes per step (forward read, dgrad read, wgrad write), flash
attention streams its operand and residual tensors, and a ring allreduce
moves ``2·(n-1)/n`` of the payload over the interconnect.
"""

import math


class ChipSpec:
    """Nominal per-card roofline parameters (bf16 dense matmul peak, HBM
    and interconnect bandwidth in bytes/s, HBM capacity in bytes: the
    memory plane's budget denominator; None when unknown)."""

    __slots__ = ("kind", "peak_flops", "hbm_bytes_per_s",
                 "ici_bytes_per_s", "hbm_capacity_bytes")

    def __init__(self, kind, peak_flops, hbm_bytes_per_s,
                 ici_bytes_per_s, hbm_capacity_bytes=None):
        self.kind = kind
        self.peak_flops = peak_flops
        self.hbm_bytes_per_s = hbm_bytes_per_s
        self.ici_bytes_per_s = ici_bytes_per_s
        self.hbm_capacity_bytes = hbm_capacity_bytes

    @property
    def ridge_flops_per_byte(self):
        """Arithmetic intensity at which HBM stops being the bound."""
        return self.peak_flops / self.hbm_bytes_per_s

    def as_dict(self):
        return {"kind": self.kind, "peak_flops": self.peak_flops,
                "hbm_bytes_per_s": self.hbm_bytes_per_s,
                "ici_bytes_per_s": self.ici_bytes_per_s,
                "hbm_capacity_bytes": self.hbm_capacity_bytes}


_GiB = 2 ** 30

# Nominal datasheet numbers by device-name prefix; the longest prefix
# wins. The H100 rows are NVIDIA's H100 Tensor Core GPU datasheet: dense
# BF16 (the sheet's 1,979 / 1,513 TFLOPS are with sparsity, dense is
# half), HBM bandwidth, NVLink bandwidth (SXM: 900 GB/s NVLink 4; PCIe:
# 600 GB/s over the NVLink bridge) and 80 GB of memory. The SXM part
# reports itself as "NVIDIA H100 80GB HBM3" (or with "SXM" in the name),
# the PCIe card as "NVIDIA H100 PCIe". The "cpu" row is the JAX
# package's stand-in so that the attribution path runs on a CPU host: an
# order of magnitude, not a measurement (its 4 GiB "capacity" bounds a
# CPU ledger, it is not host RAM).
_H100_SXM = dict(peak_flops=989e12, hbm_bytes_per_s=3.35e12,
                 ici_bytes_per_s=900e9, hbm_capacity_bytes=80 * 10 ** 9)
_H100_PCIE = dict(peak_flops=756e12, hbm_bytes_per_s=2.0e12,
                  ici_bytes_per_s=600e9, hbm_capacity_bytes=80 * 10 ** 9)
CHIP_SPECS = (
    ChipSpec("NVIDIA H100 80GB HBM3", **_H100_SXM),
    ChipSpec("NVIDIA H100 SXM", **_H100_SXM),
    ChipSpec("NVIDIA H100 PCIe", **_H100_PCIE),
    ChipSpec("cpu", 200e9, 50e9, 10e9, 4 * _GiB),
)


def _kind_of(device_or_kind):
    """A kind string from a kind, a ``torch.device`` or a device index:
    the card's name for a CUDA device, "cpu" for the CPU."""
    if isinstance(device_or_kind, str) or device_or_kind is None:
        return device_or_kind or ""
    import torch
    dev = torch.device(device_or_kind) \
        if isinstance(device_or_kind, int) else device_or_kind
    if getattr(dev, "type", None) == "cuda":
        return torch.cuda.get_device_name(dev)
    return getattr(dev, "type", "") or ""


def chip_spec(device_or_kind):
    """Longest-prefix match against CHIP_SPECS; accepts a kind string
    (``torch.cuda.get_device_name()``), a ``torch.device`` or a CUDA
    device index. None when unknown."""
    kind = _kind_of(device_or_kind)
    best = None
    for spec in CHIP_SPECS:
        if kind.lower().startswith(spec.kind.lower()):
            if best is None or len(spec.kind) > len(best.kind):
                best = spec
    return best


def peak_flops(device_or_kind):
    """Peak dense bf16 FLOPs/s for a card, or None when unknown (and for
    the cpu stand-in, whose MFU would be noise)."""
    spec = chip_spec(device_or_kind)
    if spec is None or spec.kind == "cpu":
        return None
    return spec.peak_flops


def program_costs(step_fn, *args, **kwargs):
    """FLOPs of one call of ``step_fn(*args, **kwargs)`` counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (the counterpart of the
    JAX package's read of XLA's ``cost_analysis()``). Returns ``{"flops":
    float, "bytes": None}``: the counter sees no memory traffic. The
    flash-attention custom ops are opaque to it, so their FLOPs are not
    in the count: take the attention class from ``analytic_lm_costs``.
    The call really runs (and, for a train step, updates its state)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        step_fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes": None}


def lm_matmul_params(cfg):
    """P_matmul of the PaLM convention: qkv+out projections (4·d²), the
    gated SwiGLU MLP (three d×d_ff kernels), and the lm_head."""
    return (cfg.num_layers * (4 * cfg.d_model ** 2 +
                              3 * cfg.d_model * cfg.d_ff) +
            cfg.d_model * cfg.vocab_size)


def analytic_lm_costs(cfg, seq, batch_per_chip, n_chips=1,
                      dtype_bytes=2, wire_bytes_per_param=2.0):
    """Per-class FLOPs and bytes PER STEP PER CARD of the transformer LM,
    from the config alone.

      matmul     flops = 6·P_matmul·T  (fwd 2 + bwd 4, per token)
                 hbm   = 3·P_matmul·dtype_bytes
      attention  flops = 12·L·seq·d·T
                 hbm   = 10·L·T·d·dtype_bytes
      collective wire  = 2·P_matmul·wire_bytes_per_param·(n-1)/n

    T = batch_per_chip·seq tokens per card per step. Returns
    ``{cls: {"flops": f, "hbm_bytes": b, "wire_bytes": w}}``.
    """
    tokens = batch_per_chip * seq
    p_matmul = lm_matmul_params(cfg)
    ring = (n_chips - 1) / n_chips if n_chips > 1 else 0.0
    attn_tensors = 10 * cfg.num_layers * tokens * cfg.d_model
    return {
        "matmul": {
            "flops": 6.0 * p_matmul * tokens,
            "hbm_bytes": 3.0 * p_matmul * dtype_bytes,
            "wire_bytes": 0.0,
        },
        "attention": {
            "flops": 12.0 * cfg.num_layers * seq * cfg.d_model * tokens,
            "hbm_bytes": float(attn_tensors * dtype_bytes),
            "wire_bytes": 0.0,
        },
        "collective": {
            "flops": 0.0,
            "hbm_bytes": 2.0 * p_matmul * dtype_bytes * (1 if ring else 0),
            "wire_bytes": 2.0 * p_matmul * wire_bytes_per_param * ring,
        },
    }


def lm_activation_bytes(cfg, seq, batch_per_chip, dtype_bytes=None):
    """Per-card LIVE activation bytes of one training step of the
    transformer LM (the memory plane's "activations" component), per
    token per layer ≈(8·d + 3·d_ff)·bytes, plus the residual stream once
    and the [B,T,vocab] logits (fp32 when ``cfg.logits_fp32``). A
    planning estimate, good to the tens of percent a fit verdict needs."""
    if dtype_bytes is None:
        dtype_bytes = getattr(cfg.dtype, "itemsize", 2)
    tokens = batch_per_chip * seq
    per_layer = (8 * cfg.d_model + 3 * cfg.d_ff) * dtype_bytes
    logits_bytes = 4 if getattr(cfg, "logits_fp32", True) else dtype_bytes
    return int(tokens * (cfg.num_layers * per_layer
                         + cfg.d_model * dtype_bytes
                         + cfg.vocab_size * logits_bytes))


def roofline(costs, spec):
    """Per-class roofline verdicts: the time each resource needs and
    which one binds. ``costs`` is ``analytic_lm_costs``-shaped."""
    out = {}
    for cls, c in costs.items():
        t_compute = c.get("flops", 0.0) / spec.peak_flops
        t_memory = c.get("hbm_bytes", 0.0) / spec.hbm_bytes_per_s
        t_comm = c.get("wire_bytes", 0.0) / spec.ici_bytes_per_s
        bound_s, verdict = max(
            (t_compute, "compute-bound"),
            (t_memory, "memory-bound"),
            (t_comm, "comm-bound"))
        ai = (c.get("flops", 0.0) / c["hbm_bytes"]
              if c.get("hbm_bytes") else math.inf)
        out[cls] = {
            "flops": c.get("flops", 0.0),
            "hbm_bytes": c.get("hbm_bytes", 0.0),
            "wire_bytes": c.get("wire_bytes", 0.0),
            "compute_ms": round(t_compute * 1e3, 4),
            "memory_ms": round(t_memory * 1e3, 4),
            "comm_ms": round(t_comm * 1e3, 4),
            "bound_ms": round(bound_s * 1e3, 4),
            "verdict": verdict,
            "arith_intensity": round(ai, 2) if math.isfinite(ai) else None,
            "ridge_flops_per_byte": round(spec.ridge_flops_per_byte, 2),
        }
    return out


# profile_decomposition class -> cost-model class (the three flash
# kernel classes are one analytic "attention"; everything else that is
# not a product or a collective is modeled as HBM traffic under "other")
_PROFILE_TO_MODEL = {
    "flash_fwd": "attention", "flash_dq": "attention",
    "flash_dkv": "attention", "matmul": "matmul",
    "collective": "collective",
}


def measured_class_ms(decomposition):
    """Fold a ``profile_decomposition`` dict's measured per-class ms into
    the cost-model classes (everything unmapped -> "other")."""
    out = {}
    for c in (decomposition or {}).get("classes", ()):
        cls = _PROFILE_TO_MODEL.get(c["class"], "other")
        out[cls] = out.get(cls, 0.0) + c["ms_per_step"]
    return out


def mfu_decomposition(measured_ms_per_step, costs, spec,
                      measured_ms_by_class=None):
    """Measured vs roofline-bound MFU, with the gap attributed per class.
    ``roofline_ms`` is the sum of per-class bound times. With the
    measured per-class ms, each class's excess over its bound, plus the
    unattributed residual (wall minus accounted classes), splits the MFU
    gap proportionally."""
    total_flops = sum(c.get("flops", 0.0) for c in costs.values())
    rl = roofline(costs, spec)
    roofline_ms = sum(c["bound_ms"] for c in rl.values())
    measured_mfu = (total_flops /
                    (spec.peak_flops * measured_ms_per_step / 1e3)
                    if measured_ms_per_step else None)
    roofline_mfu = (total_flops /
                    (spec.peak_flops * roofline_ms / 1e3)
                    if roofline_ms else None)
    out = {
        "flops_per_step": total_flops,
        "measured_ms_per_step": round(measured_ms_per_step, 3),
        "roofline_ms_per_step": round(roofline_ms, 3),
        "measured_mfu": round(measured_mfu, 4)
        if measured_mfu is not None else None,
        "roofline_mfu": round(roofline_mfu, 4)
        if roofline_mfu is not None else None,
        "classes": rl,
    }
    if measured_mfu is None or roofline_mfu is None:
        return out
    gap = roofline_mfu - measured_mfu
    out["mfu_gap"] = round(gap, 4)
    if measured_ms_by_class:
        excess = {}
        accounted = 0.0
        for cls, ms in measured_ms_by_class.items():
            bound = rl.get(cls, {}).get("bound_ms", 0.0)
            excess[cls] = max(ms - bound, 0.0)
            accounted += ms
        residual = measured_ms_per_step - accounted
        if residual > 0:
            excess["residual"] = residual
        total_excess = sum(excess.values())
        if total_excess > 0 and gap > 0:
            out["gap_by_class"] = {
                cls: round(gap * e / total_excess, 4)
                for cls, e in sorted(excess.items()) if e > 0}
    return out


def lm_attribution(cfg, seq, batch_per_chip, spec,
                   measured_ms_per_step, decomposition=None,
                   n_chips=1, wire_bytes_per_param=2.0):
    """Analytic costs -> roofline -> MFU decomposition in one call,
    folding in a measured ``profile_decomposition`` when one is given."""
    costs = analytic_lm_costs(cfg, seq, batch_per_chip, n_chips=n_chips,
                              wire_bytes_per_param=wire_bytes_per_param)
    by_class = measured_class_ms(decomposition) if decomposition else None
    out = mfu_decomposition(measured_ms_per_step, costs, spec,
                            measured_ms_by_class=by_class)
    out["chip"] = spec.as_dict()
    out["n_chips"] = n_chips
    return out
