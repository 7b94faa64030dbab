"""Block-scaled quantized wire codecs for the allreduce data plane.

The port of ``horovod_tpu/ops/quantization.py`` (EQuARX-style bandwidth
compression, PAPERS.md): tensors cross the wire as fixed-size blocks of
a narrow dtype plus one f32 max-abs scale per block, and every step that
accumulates runs in f32 (dequant -> sum -> requant), so the only
precision loss is the two quantization roundings. An error-feedback
residual (what the last encode dropped, added back before the next one)
turns that rounding into a zero-mean perturbation over steps.

Wire format, per tensor (or fused buffer) of n elements:

  payload  [pad(n)]            int8 / float8_e4m3fn, block-contiguous
  scales   [pad(n) // block]   f32, scale b = max|x_block_b| / QMAX

``pad(n)`` rounds up to a block multiple (the two-phase collectives
round to ``block * nproc`` so that chunk boundaries land on block
boundaries). Dequant is ``payload * scales[block_of(i)]``; zeros pad the
tail and decode to exact zeros. Every operation is IEEE f32 arithmetic
(multiplies, one divide, a round half to even, the cast to the wire
type), so the card and the CPU give the same bytes.

Plain torch ops, on whatever device the input lies on. The wire-byte
tally (``account``, ``account_leg``) is a module-level dict keyed as the
JAX package's metric labels; moving it onto a metrics registry comes
with the observability slice.
"""

import threading

import torch

from .fusion import dtype_name

# Per-block element count; HOROVOD_QUANT_BLOCK overrides it.
BLOCK_DEFAULT = 256

# Largest exactly representable magnitude per codec: symmetric int8
# keeps -128 unused; e4m3fn's max normal is 448 and overflow converts to
# NaN, so encode clips to it.
_QMAX = {"int8": 127.0, "fp8": 448.0}



def _f32_recip(v):
    """1/v rounded to f32, as a Python float."""
    return float(torch.tensor(1.0 / v, dtype=torch.float32))


_RECIP = {k: _f32_recip(v) for k, v in _QMAX.items()}

QUANTIZED_CODECS = ("int8", "fp8")
CAST_CODECS = ("fp16", "bf16")
WIRE_CODECS = QUANTIZED_CODECS + CAST_CODECS

# the dtypes select_codec treats as floating: the reference's numpy
# check (np.issubdtype(dtype, np.floating)) is false for ml_dtypes'
# bfloat16, so a bfloat16 tensor stays full width under every codec
_FLOATING = ("float64", "float32", "float16")


def is_quantized(codec):
    return codec in QUANTIZED_CODECS


def is_wire(codec):
    """True when ``codec`` changes what crosses the wire (anything but
    none/unset)."""
    return codec in WIRE_CODECS


def wire_dtype(codec):
    dtypes = {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
              "fp16": torch.float16, "bf16": torch.bfloat16}
    if codec not in dtypes:
        raise ValueError(f"unknown wire codec {codec!r}")
    return dtypes[codec]


def pad_to(n, multiple):
    """Smallest multiple of ``multiple`` that is at least n."""
    return n + (-n) % multiple


def _block_encode(x32, block, codec):
    """[..., m] f32 with m % block == 0 -> (payload [..., m] wire dtype,
    scales [..., m // block] f32). Padding zeros encode to zeros."""
    shape = x32.shape
    blocks = x32.reshape(shape[:-1] + (shape[-1] // block, block))
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    # the reference's ``amax / QMAX`` as its compiler emits it: a divide
    # by a constant becomes a multiply by the constant's f32 reciprocal
    # (1/127 and 1/448 are inexact, so the two differ in the last bit)
    scale = amax * _RECIP[codec]
    # all-zero blocks (and the zero pad tail) get scale 0; divide by a
    # stand-in 1 so the quotient is a well-defined 0, not inf*0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    scaled = blocks / safe
    if codec == "int8":
        q = torch.round(scaled).to(torch.int8)   # half to even
    else:
        # f32 rounding in the divide can land a hair above 448, and
        # e4m3fn overflows to NaN rather than saturating
        q = scaled.clamp(-_QMAX["fp8"], _QMAX["fp8"]).to(wire_dtype("fp8"))
    return (q.reshape(shape),
            scale.reshape(shape[:-1] + (shape[-1] // block,)))


def _block_decode(payload, scales, block):
    """Inverse of _block_encode, always f32."""
    shape = payload.shape
    blocks = payload.to(torch.float32).reshape(
        shape[:-1] + (shape[-1] // block, block))
    return (blocks * scales[..., None]).reshape(shape)


def encode(x, block, codec, multiple=None):
    """Encode [..., n] (any float dtype) -> (payload, scales), padding
    the last axis with zeros to ``multiple`` (default: one block)."""
    n = x.shape[-1]
    m = pad_to(n, multiple or block)
    x32 = x.to(torch.float32)
    if m != n:
        x32 = torch.nn.functional.pad(x32, (0, m - n))
    return _block_encode(x32, block, codec)


def decode(payload, scales, block, n):
    """Decode back to f32 [..., n] (drops the pad tail)."""
    return _block_decode(payload, scales, block)[..., :n]


def stacked_wire_allreduce(stacked, block, codec, average, n):
    """The quantized allreduce over the rows of a [world, n] buffer,
    computed in one place: encode each row as its own wire contribution,
    dequant to f32, sum in f32 in row order, requant the sum, dequant.
    The same arithmetic as the two-phase cross-process collective of
    ``process_collectives``. Returns ([world, n] of identical rows,
    [world, n] f32 decode of each row's own payload — the error-feedback
    reference)."""
    q, s = encode(stacked, block, codec)
    dec = _block_decode(q, s, block)               # [world, m] f32
    total = dec[0].clone()
    for row in dec[1:]:
        total = total + row
    q2, s2 = _block_encode(total, block, codec)
    out = _block_decode(q2, s2, block)[:n]
    if average:
        # compiled as the reference's is: a multiply by the f32 reciprocal
        out = out * _f32_recip(stacked.shape[0])
    return out.expand(stacked.shape[0], n), dec[..., :n]


def ef_update(comp, decoded, block):
    """New residual after encoding the compensated buffer ``comp`` whose
    own-wire decode was ``decoded``, and its L2 norm."""
    r = comp.to(torch.float32) - decoded
    return r, torch.sqrt(torch.sum(r * r))


class ErrorFeedback:
    """Per-buffer error-feedback residuals (1-bit SGD / EF-SGD lineage):
    whatever the encoder rounded away this step is added back before the
    next encode, so quantization error telescopes instead of
    accumulating. Keyed by the fused buffer's member names — stable
    across steps because the plan is — and reset on any shape change."""

    def __init__(self):
        self._residuals = {}  # guarded_by: _lock
        self._lock = threading.Lock()
        #: L2 norm of the newest residual, by anchor tensor name
        self.norms = {}

    def compensate(self, key, x):
        with self._lock:
            r = self._residuals.get(key)
        if r is None or r.shape != x.shape:
            return x
        # accumulate in f32: a bf16 gradient cannot even represent the
        # small residuals EF exists to carry
        return x.to(torch.float32) + r

    def update(self, key, comp, decoded, block, anchor=None):
        """Store ``comp - decoded``; ``anchor`` (the bucket's first member)
        labels its norm."""
        r, norm = ef_update(comp, decoded, block)
        with self._lock:
            self._residuals[key] = r
            if anchor is not None:
                self.norms[anchor] = norm

    def __len__(self):
        """The residuals held."""
        with self._lock:
            return len(self._residuals)

    def peek(self, key, shape=None):
        """The residual of ``key`` (or None), optionally only at an exact
        shape: the hierarchical leg threads the raw residual into its
        collective instead of adding it here."""
        with self._lock:
            r = self._residuals.get(key)
        if r is not None and shape is not None and \
                tuple(r.shape) != tuple(shape):
            return None
        return r

    def reset(self):
        with self._lock:
            self._residuals.clear()
            self.norms.clear()


# -- selection + accounting ------------------------------------------------


def config_fingerprint(config):
    """The codec knobs that must agree across ranks for the wire to be
    decodable, compared by the coordinator every cycle
    (``negotiation.py``)."""
    name = getattr(config, "compression", "none") or "none"
    fp = "%s/b%d/min%d/ef%d" % (
        name, int(getattr(config, "quant_block", BLOCK_DEFAULT)),
        int(getattr(config, "quant_min_bytes", 0)),
        1 if getattr(config, "quant_ef", True) else 0)
    if getattr(config, "overlap_hierarchical", False):
        fp += "/h%d" % int(getattr(config, "overlap_local_size", 0))
    return fp


def select_codec(config, dtype, nbytes):
    """The wire codec of one tensor (its dtype, a torch dtype or its
    name, and its bytes) under this rank's config: the configured codec
    when the tensor is floating and at least ``quant_min_bytes``, else
    None (full width). Deterministic in (config, dtype, nbytes), so every
    rank with the same config picks the same codec."""
    name = getattr(config, "compression", "none") or "none"
    if name == "none" or not is_wire(name) or dtype is None:
        return None
    dt = dtype_name(dtype)
    if dt not in _FLOATING:
        return None
    if nbytes < int(getattr(config, "quant_min_bytes", 0)):
        return None
    if name in CAST_CODECS and dt == dtype_name(wire_dtype(name)):
        return None  # already at wire width
    return name


def encoded_nbytes(n, codec, block):
    """Wire bytes of one encoded n-element contribution: n at the wire
    width for cast codecs; pad(n) narrow bytes + one f32 scale per block
    for quantized codecs."""
    if codec in CAST_CODECS:
        return int(n) * 2
    m = pad_to(int(n), block)
    return m + (m // block) * 4


def wire_nbytes(payload, scales=None):
    nb = payload.numel() * payload.element_size()
    if scales is not None:
        nb += scales.numel() * scales.element_size()
    return int(nb)


# the wire tally: {(metric, labels...): value}, the JAX package's
# counters under their own names and label tuples
_tally = {}
_tally_lock = threading.Lock()


def _add(key, value):
    with _tally_lock:
        _tally[key] = _tally.get(key, 0) + int(value)


def account(codec, raw_nbytes, wire_nb, axis="dp"):
    """Fold one executed collective into the tally: encoded bytes and
    full-width bytes by (codec, axis), and the newest raw/wire ratio."""
    labels = (codec or "none", axis or "dp")
    _add(("hvd_wire_bytes_total",) + labels, wire_nb)
    _add(("hvd_wire_raw_bytes_total",) + labels, raw_nbytes)
    if wire_nb:
        with _tally_lock:
            _tally[("hvd_wire_compression_ratio",)] = \
                float(raw_nbytes) / float(wire_nb)


def account_leg(leg, codec, wire_nb):
    """Per-leg bytes of the two-level reduction: ``leg`` is 'intra'
    (full width inside a host) or 'inter' (the cross-host hop, the only
    leg a quantized codec rides)."""
    _add(("hvd_wire_leg_bytes_total", leg, codec or "none"), wire_nb)


def tally():
    """A copy of the wire tally."""
    with _tally_lock:
        return dict(_tally)


def reset_tally():
    with _tally_lock:
        _tally.clear()
