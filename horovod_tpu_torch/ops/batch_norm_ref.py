"""Plain PyTorch versions of the BatchNorm statistics kernels.

The CPU path of ``ops/batch_norm.py`` and, on the card, what
``chip_smoke.py`` holds the kernels of ``csrc/batch_norm.cu`` against.
Both take a row-major ``[rows, C]`` matrix (the NHWC activations flattened
over every leading axis) in any float dtype and return fp32 ``[C]`` sums
accumulated in fp32, as the TPU kernels do; only the order of the
additions differs from the kernels'.
"""


def moments(xf):
    """(Σx, Σx²) per channel of ``xf [rows, C]``, fp32."""
    x = xf.float()
    return x.sum(0), (x * x).sum(0)


def moments2(af, bf):
    """(Σa, Σa·b) per channel of same-shape ``af, bf [rows, C]``, fp32."""
    a = af.float()
    return a.sum(0), (a * bf.float()).sum(0)
