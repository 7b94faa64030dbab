"""Layers shared by the vision models: flax's Conv, Dense, BatchNorm and
pooling on NCHW-shaped tensors kept in ``torch.channels_last`` memory.

The JAX models are NHWC; the port keeps PyTorch's NCHW shapes at its
public functions and stores activations channels-last, which is NHWC in
memory: cuDNN's fast convolution layout, and the one in which the
BatchNorm statistics kernels read a contiguous ``[rows, C]`` matrix.

Weights are fp32 masters cast to the model's ``dtype`` at each use, as
flax casts its fp32 params ("bf16 compute, fp32 params"). Submodules are
registered under the flax module names (``Conv_0``, ``BatchNorm_1``,
``conv_init``, ...), so a parameter's dotted name is its flax path and
``models.convert.vision_from_flax`` needs no table per model.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.batch_norm import BatchNormBase, TpuBatchNorm

NEG_INF = float("-inf")


def same_pads(size, kernel, stride):
    """(before, after) padding of one spatial axis under flax's and lax's
    ``padding="SAME"``: the output has ceil(size / stride) positions and
    the odd pad goes after, so a stride-2 window pads asymmetrically."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def resolve_pads(padding, spatial, kernel, strides):
    """``((top, bottom), (left, right))`` for flax's padding forms:
    "SAME", "VALID", an int, or a pair of (before, after) pairs."""
    if padding == "SAME":
        return tuple(same_pads(n, k, s)
                     for n, k, s in zip(spatial, kernel, strides))
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    return tuple(tuple(p) for p in padding)


def _pad_args(pads):
    """(padding for the op itself, or None when an explicit F.pad is
    needed first): torch's conv and pooling pad symmetrically only."""
    if all(lo == hi for lo, hi in pads):
        return tuple(lo for lo, _ in pads)
    return None


def _explicit_pad(x, pads, value=0.0):
    (top, bottom), (left, right) = pads
    return F.pad(x, (left, right, top, bottom), value=value)


def max_pool(x, window, strides, padding="VALID"):
    """``flax.linen.max_pool`` (VALID by default; padded positions are
    −inf, so they never win)."""
    pads = resolve_pads(padding, x.shape[2:], window, strides)
    sym = _pad_args(pads)
    if sym is None:
        x, sym = _explicit_pad(x, pads, NEG_INF), (0, 0)
    return F.max_pool2d(x, window, strides, padding=sym)


def avg_pool(x, window, strides, padding="VALID"):
    """``flax.linen.avg_pool``: the padded zeros count in the mean, as
    torch's ``count_include_pad`` default counts them."""
    pads = resolve_pads(padding, x.shape[2:], window, strides)
    sym = _pad_args(pads)
    if sym is None:
        x, sym = _explicit_pad(x, pads), (0, 0)
    return F.avg_pool2d(x, window, strides, padding=sym,
                        count_include_pad=True)


class Conv(nn.Module):
    """``flax.linen.Conv`` on NCHW: ``weight [out, in, kh, kw]`` (flax's
    ``kernel [kh, kw, in, out]``) and an optional bias, fp32, cast to
    ``dtype`` with the input at each use. ``padding`` takes flax's forms;
    an asymmetric one (SAME at stride 2) pads explicitly, then runs a
    VALID convolution."""

    def __init__(self, in_channels, features, kernel, strides=(1, 1),
                 padding="SAME", use_bias=True, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        self.padding, self.dtype = padding, dtype
        self.weight = nn.Parameter(torch.zeros(
            features, in_channels, *self.kernel, dtype=torch.float32,
            device=device))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=torch.float32,
                                              device=device))
                     if use_bias else None)

    def forward(self, x):
        x = x.to(self.dtype)
        pads = resolve_pads(self.padding, x.shape[2:], self.kernel,
                            self.strides)
        sym = _pad_args(pads)
        if sym is None:
            x, sym = _explicit_pad(x, pads), (0, 0)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, self.strides,
                        sym)


class Dense(nn.Module):
    """``flax.linen.Dense``: ``weight [out, in]`` (flax's ``kernel [in,
    out]``) and bias, fp32, computed in ``dtype``."""

    def __init__(self, in_features, features, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(
            features, in_features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32,
                                             device=device))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class BatchNorm(BatchNormBase):
    """``flax.linen.BatchNorm`` (the ``norm_impl="flax"`` default): the
    fields, parameters and buffers of ``TpuBatchNorm``, with the
    statistics and the normalize left to PyTorch's own batch norm, as the
    JAX package leaves them to XLA.

    Two of torch's conventions differ from flax's and are not used: its
    running variance is the unbiased one, and its momentum weighs the new
    batch. So torch's op normalizes (with the biased batch variance, as
    flax does) and this module updates the running statistics itself,
    ``ra ← m·ra + (1 − m)·batch``, from the batch mean and the biased
    variance the op saved (as 1/√(var + ε))."""

    def forward(self, x, use_running_average=None):
        out_dtype = self.dtype or x.dtype
        scale, bias = self._affine(x.shape[1], x.device)
        if self._use_running_average(use_running_average):
            y = torch.native_batch_norm(x, scale, bias, self.mean, self.var,
                                        False, 0.0, self.epsilon)[0]
            return y.to(out_dtype)
        y, mean, invstd = torch.native_batch_norm(x, scale, bias, None, None,
                                                  True, 0.0, self.epsilon)
        with torch.no_grad():
            var = torch.clamp(1.0 / (invstd * invstd) - self.epsilon,
                              min=0.0)
        self._update_running(mean, var)
        return y.to(out_dtype)


NORMS = {"flax": BatchNorm, "tpu": TpuBatchNorm}


def norm_class(norm_impl):
    """The BatchNorm class of a ``norm_impl``: "flax" (PyTorch's batch norm
    with flax's conventions) or "tpu" (the fused statistics kernels)."""
    if norm_impl not in NORMS:
        raise ValueError(f"norm_impl={norm_impl!r}: expected 'flax' or "
                         f"'tpu'")
    return NORMS[norm_impl]


def init_weights(model, generator=None):
    """Seeded weights for ``model``'s Conv and Dense layers: normal with
    std 1/sqrt(fan_in) (the scale of flax's lecun_normal), drawn from
    ``generator`` (a CPU generator seeded 0 when None, so a seed gives the
    same weights on every device); biases zero. BatchNorm keeps the scale
    and bias it was built with."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for module in model.modules():
            if not isinstance(module, (Conv, Dense)):
                continue
            w = module.weight
            fan_in = math.prod(w.shape[1:])
            draw = torch.randn(w.shape, generator=generator,
                               device=generator.device) * fan_in ** -0.5
            w.copy_(draw.to(device=w.device, dtype=w.dtype))
            if module.bias is not None:
                module.bias.zero_()
    return model


def finish(model, generator):
    """Seeded weights, 4-D weights in channels_last memory."""
    init_weights(model, generator)
    return model.to(memory_format=torch.channels_last)
