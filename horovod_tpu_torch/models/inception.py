"""Inception V3, port of ``horovod_tpu/models/inception.py``: stem, 3×
InceptionA, InceptionB, 4× InceptionC, InceptionD, 2× InceptionE, no aux
head. Every convolution is a ``ConvBN`` (bias-free conv with the flax
model's explicit symmetric padding, flax-semantics BatchNorm with
epsilon 1e-3, ReLU); max-pools are VALID (flax's default); the 3×3
average pools pad by one and count the padding, as flax's do; branches
concatenate on the channel axis.

flax names a block's ``ConvBN`` modules in the order they are built,
and in ``outer(inner(x))`` the outer one is built first, so the names
below (``ConvBN_k``) follow that order, not the data flow.
"""

import collections
import functools

import torch
import torch.nn as nn

from ..common.device import check_on, resolve_device
from . import layers


class ConvBN(nn.Module):
    def __init__(self, in_channels, filters, kernel, strides=(1, 1),
                 padding=0, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.Conv_0 = layers.Conv(in_channels, filters, kernel, strides,
                                  padding, use_bias=False, dtype=dtype,
                                  device=device)
        self.BatchNorm_0 = layers.BatchNorm(filters, momentum=0.9,
                                            epsilon=1e-3, dtype=dtype,
                                            device=device)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


_P17 = ((0, 0), (3, 3))   # (1, 7) kernels
_P71 = ((3, 3), (0, 0))   # (7, 1)
_P13 = ((0, 0), (1, 1))   # (1, 3)
_P31 = ((1, 1), (0, 0))   # (3, 1)


def _pool3(x):
    return layers.avg_pool(x, (3, 3), (1, 1), ((1, 1), (1, 1)))


class _Mixed(nn.Module):
    """A block of ``ConvBN_k`` built from (in, out, kernel, strides,
    padding) specs; ``_c(k, x)`` applies the k-th."""

    def __init__(self, specs, dtype, device):
        super().__init__()
        for k, (c_in, c_out, kernel, strides, padding) in enumerate(specs):
            self.add_module(f"ConvBN_{k}", ConvBN(
                c_in, c_out, kernel, strides, padding, dtype, device))

    def _c(self, k, x):
        return getattr(self, f"ConvBN_{k}")(x)


class InceptionA(_Mixed):
    def __init__(self, c, pool_features, dtype=torch.bfloat16, device=None):
        one = (1, 1)
        super().__init__([(c, 64, one, one, 0), (48, 64, (5, 5), one, 2),
                          (c, 48, one, one, 0), (96, 96, (3, 3), one, 1),
                          (64, 96, (3, 3), one, 1), (c, 64, one, one, 0),
                          (c, pool_features, one, one, 0)], dtype, device)
        self.out_channels = 224 + pool_features

    def forward(self, x):
        c = self._c
        return torch.cat([c(0, x), c(1, c(2, x)), c(3, c(4, c(5, x))),
                          c(6, _pool3(x))], dim=1)


class InceptionB(_Mixed):
    def __init__(self, c, dtype=torch.bfloat16, device=None):
        one, two = (1, 1), (2, 2)
        super().__init__([(c, 384, (3, 3), two, 0), (96, 96, (3, 3), two, 0),
                          (64, 96, (3, 3), one, 1), (c, 64, one, one, 0)],
                         dtype, device)
        self.out_channels = 480 + c

    def forward(self, x):
        c = self._c
        return torch.cat([c(0, x), c(1, c(2, c(3, x))),
                          layers.max_pool(x, (3, 3), (2, 2))], dim=1)


class InceptionC(_Mixed):
    def __init__(self, c, c7, dtype=torch.bfloat16, device=None):
        one = (1, 1)
        super().__init__([(c, 192, one, one, 0),
                          (c7, 192, (7, 1), one, _P71),
                          (c7, c7, (1, 7), one, _P17),
                          (c, c7, one, one, 0),
                          (c, c7, one, one, 0),
                          (c7, c7, (7, 1), one, _P71),
                          (c7, c7, (1, 7), one, _P17),
                          (c7, c7, (7, 1), one, _P71),
                          (c7, 192, (1, 7), one, _P17),
                          (c, 192, one, one, 0)], dtype, device)
        self.out_channels = 768

    def forward(self, x):
        c = self._c
        b3 = x
        for k in range(4, 9):
            b3 = c(k, b3)
        return torch.cat([c(0, x), c(1, c(2, c(3, x))), b3,
                          c(9, _pool3(x))], dim=1)


class InceptionD(_Mixed):
    def __init__(self, c, dtype=torch.bfloat16, device=None):
        one, two = (1, 1), (2, 2)
        super().__init__([(192, 320, (3, 3), two, 0), (c, 192, one, one, 0),
                          (c, 192, one, one, 0),
                          (192, 192, (1, 7), one, _P17),
                          (192, 192, (7, 1), one, _P71),
                          (192, 192, (3, 3), two, 0)], dtype, device)
        self.out_channels = 512 + c

    def forward(self, x):
        c = self._c
        b2 = x
        for k in range(2, 6):
            b2 = c(k, b2)
        return torch.cat([c(0, c(1, x)), b2,
                          layers.max_pool(x, (3, 3), (2, 2))], dim=1)


class InceptionE(_Mixed):
    def __init__(self, c, dtype=torch.bfloat16, device=None):
        one = (1, 1)
        super().__init__([(c, 320, one, one, 0), (c, 384, one, one, 0),
                          (384, 384, (1, 3), one, _P13),
                          (384, 384, (3, 1), one, _P31),
                          (c, 448, one, one, 0), (448, 384, (3, 3), one, 1),
                          (384, 384, (1, 3), one, _P13),
                          (384, 384, (3, 1), one, _P31),
                          (c, 192, one, one, 0)], dtype, device)
        self.out_channels = 2048

    def forward(self, x):
        c = self._c
        b2 = c(1, x)
        b3 = c(5, c(4, x))
        return torch.cat([c(0, x), c(2, b2), c(3, b2), c(6, b3), c(7, b3),
                          c(8, _pool3(x))], dim=1)


class InceptionV3(nn.Module):
    """``forward(images [b, 3, H, W]) -> logits [b, num_classes]`` fp32;
    the smallest valid input is 75×75."""

    def __init__(self, num_classes=1000, dtype=torch.bfloat16, in_channels=3,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.device, self.dtype = device, dtype
        conv = functools.partial(ConvBN, dtype=dtype, device=device)
        self.ConvBN_0 = conv(in_channels, 32, (3, 3), (2, 2))
        self.ConvBN_1 = conv(32, 32, (3, 3))
        self.ConvBN_2 = conv(32, 64, (3, 3), padding=1)
        self.ConvBN_3 = conv(64, 80, (1, 1))
        self.ConvBN_4 = conv(80, 192, (3, 3))
        self._blocks = []
        built = collections.Counter()
        c = 192
        for cls, args in ([(InceptionA, (p,)) for p in (32, 64, 64)] +
                          [(InceptionB, ())] +
                          [(InceptionC, (c7,)) for c7 in (128, 160, 160, 192)]
                          + [(InceptionD, ())] + [(InceptionE, ())] * 2):
            name = f"{cls.__name__}_{built[cls]}"
            built[cls] += 1
            block = cls(c, *args, dtype=dtype, device=device)
            self.add_module(name, block)
            self._blocks.append(name)
            c = block.out_channels
        self.Dense_0 = layers.Dense(c, num_classes, dtype, device)
        layers.finish(self, generator)

    def forward(self, x):
        check_on(self.device, x)
        x = x.to(self.dtype, memory_format=torch.channels_last)
        x = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        x = layers.max_pool(x, (3, 3), (2, 2))
        x = self.ConvBN_4(self.ConvBN_3(x))
        x = layers.max_pool(x, (3, 3), (2, 2))
        for name in self._blocks:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return self.Dense_0(x).float()
