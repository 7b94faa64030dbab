"""Gradient compression codecs, plus the registry that names them.

The port of ``horovod_tpu/ops/compression.py`` (the reference's
Compressor interface, horovod/torch/compression.py): ``compress``
returns ``(compressed_tensor, ctx)`` and ``decompress`` restores the
original dtype from ``ctx``. fp16 and bf16 halve the wire bytes of an
fp32 gradient; the sum itself runs in the wire dtype. Non-floating
tensors pass through unchanged: a cast would corrupt their exact sums.

The block-scaled int8 and fp8 codecs (``ops/quantization.py``) have two
uses, as in the JAX package. On the op API (``compression=``) they are a
fake-quant round trip: encode, then decode at once, in the input's
dtype, so the numerics are the wire's while the bytes that move stay
full width. On the negotiated eager wire (``HOROVOD_COMPRESSION``) the
eager core encodes each fused buffer and the payload itself narrows.
"""

import torch

from . import quantization


class Compressor:
    """Interface to compress and decompress a tensor."""

    name = "none"
    # quantized codecs defer the real encode to the negotiated wire
    quantized = False

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


class _QuantizedCompressor(Compressor):
    """Block-scaled quantized codec on the op API: ``compress`` is the
    fake-quant round trip (encode, decode, the input's dtype and shape);
    the byte reduction itself happens on the negotiated eager wire."""

    quantized = True
    block = quantization.BLOCK_DEFAULT

    @classmethod
    def compress(cls, tensor):
        if not tensor.is_floating_point():
            return tensor, None
        flat = tensor.reshape(-1)
        payload, scales = quantization.encode(flat, cls.block, cls.name)
        dec = quantization.decode(payload, scales, cls.block, flat.numel())
        return dec.reshape(tensor.shape).to(tensor.dtype), None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class Int8Compressor(_QuantizedCompressor):
    """Symmetric block-scaled int8: per-block max-abs scale, 4x fewer
    wire bytes than f32."""
    name = "int8"


class FP8Compressor(_QuantizedCompressor):
    """Block-scaled float8_e4m3fn: int8's wire width with more dynamic
    range inside a block."""
    name = "fp8"


class Compression:
    """Optional gradient compression used during allreduce, plus the name
    registry that ``HOROVOD_COMPRESSION`` selects from."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    fp8 = FP8Compressor

    _BY_NAME = {c.name: c for c in (NoneCompressor, FP16Compressor,
                                    BF16Compressor, Int8Compressor,
                                    FP8Compressor)}

    @classmethod
    def names(cls):
        return tuple(cls._BY_NAME)

    @classmethod
    def from_name(cls, name):
        """Codec class for ``name`` (None and '' mean none); raises on a
        name it does not know, so ranks never disagree about the wire."""
        key = (name or "none").strip().lower()
        codec = cls._BY_NAME.get(key)
        if codec is None:
            raise ValueError(f"unknown compression codec {name!r}; expected "
                             f"one of {', '.join(cls._BY_NAME)}")
        return codec


# the eager core's wire codec (ops/negotiation.py): HOROVOD_COMPRESSION
# picks the codec a fused allreduce's buffer crosses the wire in, and
# under negotiation rank 0's choice is the plan every rank follows
CAST_CODECS = quantization.CAST_CODECS
config_fingerprint = quantization.config_fingerprint
select_codec = quantization.select_codec
wire_dtype = quantization.wire_dtype
