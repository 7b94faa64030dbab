"""BatchNorm with fused statistics for the port: public side and dispatch.

The counterpart of ``horovod_tpu/ops/batch_norm.py``. ``moments`` (Σx and
Σx² per channel, the forward's reduction) and ``moments2`` (Σa and Σa·b,
the backward's pair with a = dy, b = x) take ``[..., C]`` tensors with the
channels last, as the JAX functions do. A CUDA tensor goes to the
hand-written Hopper kernels in ``csrc/batch_norm.cu``; a CPU tensor to
their plain PyTorch versions in ``batch_norm_ref.py``. Nothing on a CUDA
tensor ever takes the plain version: if a kernel cannot build or launch,
the call raises.

Layout. The kernels reduce a row-major ``[rows, C]`` matrix, the NHWC
activations flattened. The port's vision models keep activations
NCHW-shaped in ``torch.channels_last`` memory, so the NHWC view
``x.movedim(1, -1)`` is already contiguous and flattens for free. A
tensor whose channels are not innermost in memory (an NCHW-contiguous
one, say) is copied to that layout first: a plain ``reshape(-1, C)`` of
its NHWC view would pair the wrong elements with each channel. Every
such copy is counted in ``layout_copies``; a ResNet step in channels_last
makes none.

``TpuBatchNorm`` is the JAX package's module of that name: its training
forward and backward run through ``moments`` and ``moments2`` inside a
``torch.autograd.Function`` (the counterpart of the JAX ``custom_vjp``)
with the same order of operations, so the fast-variance formula
``max(E[x²] − E[x]², 0)`` and all. Its surface is the NCHW one of
``torch.nn.BatchNorm2d`` with flax's fields and conventions.
"""

import collections

import torch
import torch.nn as nn

from . import batch_norm_ref as ref
from ._build import extension

#: Kernel launches by kernel name, counted where each launch is made.
launch_counts = collections.Counter()

#: Copies made to bring an input's channels innermost, by function.
layout_copies = collections.Counter()


def reset_counts():
    launch_counts.clear()
    layout_copies.clear()


def _rows(x, what):
    """``x [..., C]`` as a row-major ``[rows, C]`` matrix: a view when the
    channels are innermost in memory, else a counted copy."""
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"{what}: expected [..., C] with C >= 1, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        layout_copies[what] += 1
        x = x.contiguous()
    return x.view(-1, x.shape[-1])


def _kernel(af, bf=None):
    """Launch the statistics kernel on contiguous ``[rows, C]`` operands:
    (Σa, Σa²) without ``bf``, (Σa, Σa·b) with it."""
    if af.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"BatchNorm statistics kernel takes float32 or "
                        f"bfloat16, got {af.dtype}")
    if bf is not None and (bf.shape != af.shape or bf.dtype != af.dtype or
                           bf.device != af.device):
        raise ValueError(f"moments2: b {tuple(bf.shape)} {bf.dtype} does "
                         f"not fit a {tuple(af.shape)} {af.dtype}")
    c = af.shape[1]
    out0 = torch.empty(c, dtype=torch.float32, device=af.device)
    out1 = torch.empty_like(out0)
    two = bf is not None
    extension().bn_moments(af, bf if two else af, out0, out1, two)
    launch_counts["bn_moments2" if two else "bn_moments"] += 1
    return out0, out1


def moments(x):
    """Per-channel (Σx, Σx²) over all leading axes of ``x [..., C]``, fp32
    accumulation, one streaming pass."""
    xf = _rows(x, "moments")
    if xf.is_cuda:
        return _kernel(xf)
    if xf.device.type == "cpu":
        return ref.moments(xf)
    raise ValueError(f"moments runs on cuda or cpu, not {xf.device}")


def moments2(a, b):
    """Per-channel (Σa, Σa·b) of same-shape ``[..., C]`` tensors — the
    backward pass's pair (a = dy, b = x)."""
    if a.shape != b.shape:
        raise ValueError(f"moments2: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    af, bf = _rows(a, "moments2"), _rows(b, "moments2")
    if af.is_cuda:
        return _kernel(af, bf)
    if af.device.type == "cpu":
        return ref.moments2(af, bf)
    raise ValueError(f"moments2 runs on cuda or cpu, not {af.device}")


class _BnTrain(torch.autograd.Function):
    """``(y, mean, var)`` of channels-last ``x [..., C]`` with batch
    statistics, as the JAX ``_bn_train``; mean and var feed the running
    statistics only and carry no gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        n = x.numel() // x.shape[-1]
        s, ss = moments(x)
        mean = s / n
        var = torch.clamp(ss / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        y = (x.float() - mean) * (inv * scale) + bias
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, inv = ctx.saved_tensors
        n = x.numel() // x.shape[-1]
        # the two per-channel reductions of the standard BN gradient, in
        # one streamed pass: sum(dy) and sum(dy·x)
        sum_dy, sum_dyx = moments2(dy, x)
        # sum(dy·x̂) with x̂ = (x − μ)·inv
        sum_dyxhat = (sum_dyx - mean * sum_dy) * inv
        g = scale * inv
        xhat = (x.float() - mean) * inv
        dx = g * (dy.float() - sum_dy / n - xhat * (sum_dyxhat / n))
        return dx.to(x.dtype), sum_dyxhat, sum_dy, None


class BatchNormBase(nn.Module):
    """The fields, parameters and buffers the port's two BatchNorms share,
    on NCHW-shaped inputs (channel axis 1, any rank >= 2).

    Fields as flax's: ``use_running_average`` (None follows the module's
    ``training`` flag, so ``model.eval()`` switches to the running
    statistics), ``momentum`` in flax's convention (``ra ← m·ra +
    (1 − m)·batch``; 0.9 where torch's own BatchNorm would say 0.1),
    ``epsilon``, ``dtype`` of the output (the input's when None),
    ``use_scale``/``use_bias`` and their initial values. ``scale`` and
    ``bias`` are fp32 parameters; the running ``mean`` and ``var`` fp32
    buffers, the variance biased, as flax keeps it."""

    def __init__(self, num_features, use_running_average=None, momentum=0.99,
                 epsilon=1e-5, dtype=None, use_scale=True, use_bias=True,
                 scale_init=1.0, bias_init=0.0, device=None):
        super().__init__()
        self.use_running_average = use_running_average
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = (nn.Parameter(torch.full((num_features,), scale_init,
                                              **f32))
                      if use_scale else None)
        self.bias = (nn.Parameter(torch.full((num_features,), bias_init,
                                             **f32))
                     if use_bias else None)
        self.register_buffer("mean", torch.zeros(num_features, **f32))
        self.register_buffer("var", torch.ones(num_features, **f32))

    def _use_running_average(self, override):
        for choice in (override, self.use_running_average):
            if choice is not None:
                return choice
        return not self.training

    def _affine(self, c, device):
        scale = (self.scale if self.scale is not None else
                 torch.ones(c, dtype=torch.float32, device=device))
        bias = (self.bias if self.bias is not None else
                torch.zeros(c, dtype=torch.float32, device=device))
        return scale, bias

    def _update_running(self, mean, var):
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)


class TpuBatchNorm(BatchNormBase):
    """BatchNorm whose training statistics (forward AND backward
    reductions) run through the fused kernels: the JAX package's
    ``TpuBatchNorm``, with ``BatchNormBase``'s fields."""

    def forward(self, x, use_running_average=None):
        out_dtype = self.dtype or x.dtype
        xc = x.movedim(1, -1)
        scale, bias = self._affine(xc.shape[-1], x.device)
        if self._use_running_average(use_running_average):
            inv = torch.rsqrt(self.var + self.epsilon)
            y = (xc.float() - self.mean) * (inv * scale) + bias
            return y.to(out_dtype).movedim(-1, 1)
        y, mean, var = _BnTrain.apply(xc, scale, bias, self.epsilon)
        self._update_running(mean, var)
        return y.to(out_dtype).movedim(-1, 1)
