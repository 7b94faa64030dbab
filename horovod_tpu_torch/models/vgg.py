"""VGG family, port of ``horovod_tpu/models/vgg.py``: 3×3 convolutions
(padding 1, with bias) and ReLU, 2×2 max-pools, then three Dense layers,
all in ``dtype`` from fp32 masters, dropout between the Dense layers.

The classifier flattens the last feature map in NHWC order, as the flax
model does, so that ``Dense_0``'s rows mean the same (h, w, c) in both
packages. Torch needs that layer's width up front, hence ``image_size``.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common.device import check_on, resolve_device
from . import layers

# layer configs: ints are conv output channels, "M" is 2x2 max-pool
_CFGS = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(nn.Module):
    def __init__(self, depth=16, num_classes=1000, dtype=torch.bfloat16,
                 dropout_rate=0.5, image_size=224, in_channels=3,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.device, self.dtype = device, dtype
        self.depth, self.dropout_rate = depth, dropout_rate
        c, n_conv, size = in_channels, 0, image_size
        for v in _CFGS[depth]:
            if v == "M":
                size //= 2
                continue
            self.add_module(f"Conv_{n_conv}", layers.Conv(
                c, v, (3, 3), padding=1, dtype=dtype, device=device))
            c, n_conv = v, n_conv + 1
        widths = [c * size * size, 4096, 4096, num_classes]
        for i in range(3):
            self.add_module(f"Dense_{i}", layers.Dense(
                widths[i], widths[i + 1], dtype, device))
        layers.finish(self, generator)

    def forward(self, x):
        check_on(self.device, x)
        x = x.to(self.dtype, memory_format=torch.channels_last)
        n_conv = 0
        for v in _CFGS[self.depth]:
            if v == "M":
                x = layers.max_pool(x, (2, 2), (2, 2))
            else:
                x = torch.relu(getattr(self, f"Conv_{n_conv}")(x))
                n_conv += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for i in range(2):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
            if self.dropout_rate:
                x = F.dropout(x, self.dropout_rate, self.training)
        return self.Dense_2(x).float()


def VGG11(**kw):
    return VGG(depth=11, **kw)


def VGG16(**kw):
    return VGG(depth=16, **kw)


def VGG19(**kw):
    return VGG(depth=19, **kw)
