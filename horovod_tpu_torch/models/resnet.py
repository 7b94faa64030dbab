"""ResNet v1.5 family, port of ``horovod_tpu/models/resnet.py``.

The same architecture and numerics as the flax model, on NCHW-shaped
inputs in channels_last memory: bias-free convolutions with flax's SAME
padding (explicit and asymmetric at stride 2: (2, 3) for the 7×7 stem on
224, (0, 1) for each stride-2 3×3 and for the −inf-padded 3×3 max-pool),
stride on the 3×3 of the bottleneck, the last BatchNorm of every block
starting at scale 0, bf16 compute with fp32 masters and statistics, the
head a mean over (H, W) in the working dtype and then an fp32 Dense.
``norm_impl`` picks the BatchNorm: "flax" (PyTorch's batch norm with
flax's conventions, the default) or "tpu" (``ops.batch_norm.TpuBatchNorm``,
whose statistics run through the hand-written kernels).

Train or eval is the module's ``training`` flag (``model.train()`` /
``model.eval()``), where the flax model takes ``train=``.
"""

import functools

import torch
import torch.nn as nn

from ..common.device import check_on, resolve_device
from . import layers


class _Block(nn.Module):
    """The parts of a residual block: convolutions ``Conv_j`` and norms
    ``{Norm}_j`` under their flax names, and the projection ``conv_proj``
    / ``norm_proj`` when the block changes the shape."""

    def __init__(self, in_channels, specs, strides, norm, dtype, device):
        super().__init__()
        conv = functools.partial(layers.Conv, use_bias=False, dtype=dtype,
                                 padding="SAME", device=device)
        self._norm_name = norm.func.__name__
        self._depth = len(specs)
        c_in = in_channels
        for j, (features, kernel, stride) in enumerate(specs):
            self.add_module(f"Conv_{j}", conv(c_in, features, kernel, stride))
            last = j == len(specs) - 1
            self.add_module(f"{self._norm_name}_{j}",
                            norm(features, scale_init=0.0 if last else 1.0))
            c_in = features
        if in_channels != c_in or tuple(strides) != (1, 1):
            self.conv_proj = conv(in_channels, c_in, (1, 1), strides)
            self.norm_proj = norm(c_in)
        else:
            self.conv_proj = self.norm_proj = None

    def forward(self, x):
        residual = x
        y = x
        for j in range(self._depth):
            y = getattr(self, f"Conv_{j}")(y)
            y = getattr(self, f"{self._norm_name}_{j}")(y)
            if j < self._depth - 1:
                y = torch.relu(y)
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(residual))
        return torch.relu(residual + y)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, in_channels, filters, norm, strides=(1, 1),
                 dtype=torch.bfloat16, device=None):
        super().__init__(in_channels, [(filters, (3, 3), strides),
                                       (filters, (3, 3), (1, 1))],
                         strides, norm, dtype, device)


class BottleneckBlock(_Block):
    expansion = 4

    def __init__(self, in_channels, filters, norm, strides=(1, 1),
                 dtype=torch.bfloat16, device=None):
        # v1.5: stride on the 3x3, not the 1x1
        super().__init__(in_channels, [(filters, (1, 1), (1, 1)),
                                       (filters, (3, 3), strides),
                                       (filters * 4, (1, 1), (1, 1))],
                         strides, norm, dtype, device)


class ResNet(nn.Module):
    """``forward(images [b, 3, H, W]) -> logits [b, num_classes]`` fp32.
    Blocks are registered as ``{BlockClass}_{i}``, the flax names."""

    def __init__(self, stage_sizes, block_cls, num_classes=1000,
                 num_filters=64, dtype=torch.bfloat16, norm_impl="flax",
                 in_channels=3, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.device, self.dtype, self.norm_impl = device, dtype, norm_impl
        norm = functools.partial(layers.norm_class(norm_impl), momentum=0.9,
                                 epsilon=1e-5, dtype=dtype, device=device)
        self.conv_init = layers.Conv(in_channels, num_filters, (7, 7), (2, 2),
                                     "SAME", use_bias=False, dtype=dtype,
                                     device=device)
        self.bn_init = norm(num_filters)
        self._blocks = []
        c = num_filters
        for i, block_size in enumerate(stage_sizes):
            for j in range(block_size):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                block = block_cls(c, num_filters * 2 ** i, norm, strides,
                                  dtype, device)
                name = f"{block_cls.__name__}_{len(self._blocks)}"
                self.add_module(name, block)
                self._blocks.append(name)
                c = num_filters * 2 ** i * block_cls.expansion
        self.Dense_0 = layers.Dense(c, num_classes, torch.float32, device)
        layers.finish(self, generator)

    def forward(self, x):
        check_on(self.device, x)
        x = x.to(self.dtype, memory_format=torch.channels_last)
        x = torch.relu(self.bn_init(self.conv_init(x)))
        x = layers.max_pool(x, (3, 3), (2, 2), "SAME")
        for name in self._blocks:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return self.Dense_0(x).float()


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=BasicBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block_cls=BottleneckBlock)

MODELS = {"resnet18": ResNet18, "resnet34": ResNet34, "resnet50": ResNet50,
          "resnet101": ResNet101, "resnet152": ResNet152}
