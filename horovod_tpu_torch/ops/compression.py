"""Gradient compression codecs, plus the registry that names them.

The port of ``horovod_tpu/ops/compression.py``'s cast codecs (the
reference's Compressor interface, horovod/torch/compression.py):
``compress`` returns ``(compressed_tensor, ctx)`` and ``decompress``
restores the original dtype from ``ctx``. fp16 and bf16 halve the wire
bytes of an fp32 gradient; the sum itself runs in the wire dtype.
Non-floating tensors pass through unchanged: a cast would corrupt their
exact sums.

The block-scaled int8 and fp8 codecs of the JAX package are not ported
yet (ROADMAP.md); ``from_name`` refuses them by name.
"""

import torch


class Compressor:
    """Interface to compress and decompress a tensor."""

    name = "none"

    @staticmethod
    def compress(tensor):
        """Returns (compressed_tensor, context_for_decompression)."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """No-op."""

    name = "none"

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype = None

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point() and tensor.dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    """Cast floating tensors to fp16 on the wire."""
    name = "fp16"
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """Cast floating tensors to bfloat16 on the wire: fp32's exponent
    range, so large gradients do not overflow as they may in fp16."""
    name = "bf16"
    wire_dtype = torch.bfloat16


class Compression:
    """Optional gradient compression used during allreduce, plus the name
    registry that ``HOROVOD_COMPRESSION`` selects from."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor

    _BY_NAME = {c.name: c for c in (NoneCompressor, FP16Compressor,
                                    BF16Compressor)}

    @classmethod
    def from_name(cls, name):
        """Codec class for ``name`` (None and '' mean none); raises on a
        name it does not know, so ranks never disagree about the wire."""
        key = (name or "none").strip().lower()
        if key in ("int8", "fp8"):
            raise NotImplementedError(
                f"compression codec {key!r} is not ported yet; use "
                f"{', '.join(cls._BY_NAME)}")
        codec = cls._BY_NAME.get(key)
        if codec is None:
            raise ValueError(f"unknown compression codec {name!r}; expected "
                             f"one of {', '.join(cls._BY_NAME)}")
        return codec


# ---------------------------------------------------------------------------
# the eager core's wire codec (ops/negotiation.py), the port of the cast
# half of horovod_tpu/ops/quantization.py's config_fingerprint and
# select_codec: HOROVOD_COMPRESSION picks the codec a fused allreduce's
# buffer crosses the wire in, and under negotiation rank 0's choice is
# the plan every rank follows

CAST_CODECS = ("fp16", "bf16")
# the JAX package's defaults of its quantizer knobs, which the port does
# not have yet; they ride the fingerprint so both packages' agree
QUANT_BLOCK, QUANT_MIN_BYTES, QUANT_EF = 256, 1024, True
_FLOATING = ("float64", "float32", "float16", "bfloat16")


def config_fingerprint(config):
    """The codec knobs that must agree across ranks for the wire to be
    decodable, compared by the coordinator every cycle."""
    name = getattr(config, "compression", "none") or "none"
    return "%s/b%d/min%d/ef%d" % (name, QUANT_BLOCK, QUANT_MIN_BYTES,
                                  1 if QUANT_EF else 0)


def select_codec(config, dtype, nbytes):
    """The wire codec of one tensor (its dtype's name and bytes) under
    this rank's config: the configured cast codec when the tensor is
    floating, at least QUANT_MIN_BYTES and not at the wire width already,
    else None (full width)."""
    name = getattr(config, "compression", "none") or "none"
    if name not in CAST_CODECS or dtype is None:
        return None
    from .fusion import dtype_name
    dt = dtype_name(dtype)
    if dt not in _FLOATING or nbytes < QUANT_MIN_BYTES:
        return None
    if dt == {"fp16": "float16", "bf16": "bfloat16"}[name]:
        return None   # already at wire width
    return name


def wire_dtype(codec):
    return {"fp16": torch.float16, "bf16": torch.bfloat16}[codec]
