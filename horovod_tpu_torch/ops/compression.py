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
