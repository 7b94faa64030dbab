"""Where the port's entry points run.

Every entry point takes ``device`` and defaults to CUDA. Without a card
and without an explicit ``device="cpu"`` it raises: the port never moves
to the CPU on its own, so a run that was meant for the card cannot pass
quietly on the host.
"""

import torch


def resolve_device(device=None):
    """``device`` as a ``torch.device``, CUDA when None; raises when CUDA
    is asked for and no card is visible."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return device


def check_on(device, *tensors):
    """Raise unless every tensor lies on ``device``."""
    for t in tensors:
        if t.device.type != device.type or (
                device.index is not None and t.device.index != device.index):
            raise ValueError(f"tensor on {t.device}, expected {device}")
