"""MNIST CNN, port of ``horovod_tpu/models/mnist.py``: conv(10, 5×5) →
maxpool → relu → conv(20, 5×5) → dropout → maxpool → relu → fc(50) →
relu → dropout → fc(10), the reference example's Net. The flatten is in
NHWC order, as the flax model's, so ``Dense_0``'s rows match."""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common.device import check_on, resolve_device
from . import layers


class MnistCNN(nn.Module):
    def __init__(self, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.device, self.dtype = device, dtype
        self.Conv_0 = layers.Conv(1, 10, (5, 5), padding="VALID",
                                  dtype=dtype, device=device)
        self.Conv_1 = layers.Conv(10, 20, (5, 5), padding="VALID",
                                  dtype=dtype, device=device)
        self.Dense_0 = layers.Dense(320, 50, dtype, device)
        self.Dense_1 = layers.Dense(50, 10, dtype, device)
        layers.finish(self, generator)

    def forward(self, x):
        """``x [b, 1, 28, 28]`` -> logits ``[b, 10]`` fp32."""
        check_on(self.device, x)
        x = x.to(self.dtype, memory_format=torch.channels_last)
        x = torch.relu(layers.max_pool(self.Conv_0(x), (2, 2), (2, 2)))
        x = F.dropout(self.Conv_1(x), 0.5, self.training)
        x = torch.relu(layers.max_pool(x, (2, 2), (2, 2)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.dropout(torch.relu(self.Dense_0(x)), 0.5, self.training)
        return self.Dense_1(x).float()
