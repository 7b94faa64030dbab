"""Fused (flash) attention for the port: public side and dispatch.

The counterpart of ``horovod_tpu/ops/flash_attention.py``, forward and
backward. A CUDA tensor goes to the hand-written Hopper kernels: the
forward variants (online, lazy, twopass) in ``csrc/flash_fwd.cu``, the
backward's dq and dk/dv kernels in ``csrc/flash_bwd.cu``. A CPU tensor
goes to their plain PyTorch versions in ``flash_attention_ref.py``, which
walk the same tiles. Nothing on a CUDA tensor ever takes the plain
version: if a kernel cannot build or launch, the call raises.

``flash_attention`` is differentiable through a ``torch.autograd.Function``
(the counterpart of the JAX package's ``custom_vjp``): the forward saves
q, k, v, O and lse; the backward computes delta = rowsum(dO∘O) as plain
torch, as the JAX package does, and launches the two backward kernels.

Tiles are 64 rows of Q by 64 rows of K/V, chosen for Hopper: 16 query
rows per warp of mma.sync, and a bf16 K/V tile of d=128 double-buffered
in 87 KB of shared memory (two CTAs per SM). A sequence shorter than a
tile is one partial tile; a longer one must be a tile multiple, except
causal self-attention, which is end-padded (the padded keys sit after
every real query, so the causal mask discards them exactly).

``decode_attention`` — one query against the KV cache — stays plain
torch, as the JAX package keeps it plain XLA: a GEMV per (batch, head)
has no logits matrix to keep out of memory.
"""

import collections
import os

import torch
import torch.nn.functional as F

from ..common.device import check_on, resolve_device
from . import flash_attention_ref as ref
from ._build import extension

NEG_INF = ref.NEG_INF
LOG2E = ref.LOG2E

#: Forward accumulation variants (see flash_attention_ref.py for each one's
#: tile walk). The backward kernels are shared: every variant writes the
#: same natural-log lse.
VARIANTS = ("online", "lazy", "twopass")

#: Rows of Q and of K/V per tile — the one tile shape the kernels compile.
BLOCK = 64

#: Kernel launches by kernel name, counted where each launch is made.
launch_counts = collections.Counter()


def reset_launch_counts():
    launch_counts.clear()


def resolve_variant(variant, nk=1):
    """Resolve 'auto' (and the HVD_FLASH_VARIANT env override, which wins
    over any explicit argument) to a concrete forward variant: lazy
    whenever the k loop has two or more tiles, online for a one-tile
    loop; twopass only when asked for."""
    env = os.environ.get("HVD_FLASH_VARIANT", "").strip().lower()
    if env:
        variant = env
    if variant not in VARIANTS + ("auto",):
        raise ValueError(
            f"unknown flash variant {variant!r}; expected one of "
            f"{VARIANTS + ('auto',)}")
    if variant == "auto":
        return "lazy" if nk >= 2 else "online"
    return variant


def fit_block(s):
    """Tile rows for a sequence of ``s``: the full tile, or one partial
    tile when the whole sequence is shorter. No halving: the kernels are
    compiled for one tile shape, so a longer sequence that the tile does
    not divide is end-padded (causal) or refused."""
    return min(BLOCK, s)


def _check_operands(qf, kf, vf):
    """Raise unless ``[b·h, s, d]`` q, k, v are what the kernels take."""
    if qf.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{qf.dtype}")
    if not (qf.dtype == kf.dtype == vf.dtype):
        raise TypeError("q, k and v must share a dtype")
    if qf.shape[2] not in (16, 32, 64, 128):
        raise ValueError(f"flash kernel head_dim must be 16/32/64/128, got "
                         f"{qf.shape[2]}")
    if kf.shape != vf.shape or kf.shape[0] != qf.shape[0] or \
            kf.shape[2] != qf.shape[2]:
        raise ValueError(f"k/v shape {tuple(kf.shape)} does not fit q "
                         f"{tuple(qf.shape)}")
    _check_contiguous(qf, kf, vf)


def _check_contiguous(*ts):
    for t in ts:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash kernel operands must be contiguous and "
                             "16-byte aligned")


def _kernel_fwd(qf, kf, vf, causal, scale, variant):
    """Launch the forward kernel on ``[b·h, s, d]`` operands."""
    _check_operands(qf, kf, vf)
    out = torch.empty_like(qf)
    lse = torch.empty(qf.shape[:2], dtype=torch.float32, device=qf.device)
    extension().flash_fwd(qf, kf, vf, out, lse, VARIANTS.index(variant),
                          bool(causal), float(scale * LOG2E))
    launch_counts[f"flash_fwd_{variant}"] += 1
    return out, lse


def _kernel_bwd(qf, kf, vf, dof, lse, delta, causal, scale):
    """Launch the backward kernels on ``[b·h, s, d]`` operands (dO like
    q; lse and delta fp32 ``[b·h, sq]``); returns (dq, dk, dv)."""
    _check_operands(qf, kf, vf)
    if dof.shape != qf.shape or dof.dtype != qf.dtype:
        raise ValueError(f"dO {tuple(dof.shape)} {dof.dtype} does not fit "
                         f"q {tuple(qf.shape)} {qf.dtype}")
    for stat in (lse, delta):
        if stat.dtype != torch.float32 or stat.shape != qf.shape[:2]:
            raise ValueError("lse and delta must be fp32 [b·h, sq]")
    _check_contiguous(dof, lse, delta)
    dq, dk, dv = (torch.empty_like(t) for t in (qf, kf, vf))
    ext = extension()
    args = (bool(causal), float(scale * LOG2E), float(scale))
    ext.flash_bwd_dq(qf, kf, vf, dof, lse, delta, dq, *args)
    launch_counts["flash_bwd_dq"] += 1
    ext.flash_bwd_dkv(qf, kf, vf, dof, lse, delta, dk, dv, *args)
    launch_counts["flash_bwd_dkv"] += 1
    return dq, dk, dv


def _check_kernel_blocks(block_q, block_k, sq, sk):
    if (block_q, block_k) != (fit_block(sq), fit_block(sk)):
        raise ValueError(
            f"the CUDA kernel walks {BLOCK}-row tiles; got blocks "
            f"({block_q}, {block_k}) for seq ({sq}, {sk})")


def _fwd_flat(qf, kf, vf, causal, block_q, block_k, variant):
    """(out, lse) of ``[b·h, s, d]`` operands: the kernel on the card,
    the plain version on the CPU."""
    scale = qf.shape[-1] ** -0.5
    if qf.is_cuda:
        _check_kernel_blocks(block_q, block_k, qf.shape[1], kf.shape[1])
        return _kernel_fwd(qf.contiguous(), kf.contiguous(),
                           vf.contiguous(), causal, scale, variant)
    if qf.device.type == "cpu":
        return ref.FWD[variant](qf, kf, vf, causal, block_q, block_k, scale)
    raise ValueError(f"flash attention runs on cuda or cpu, not {qf.device}")


def _bwd_flat(qf, kf, vf, of, lse, dof, causal, block_q, block_k):
    """(dq, dk, dv) of ``[b·h, s, d]`` operands given the forward's out
    and lse and the output gradient dO."""
    scale = qf.shape[-1] ** -0.5
    delta = ref.flash_delta(of, dof)
    if qf.is_cuda:
        _check_kernel_blocks(block_q, block_k, qf.shape[1], kf.shape[1])
        return _kernel_bwd(qf.contiguous(), kf.contiguous(),
                           vf.contiguous(), dof.contiguous(), lse, delta,
                           causal, scale)
    if qf.device.type == "cpu":
        dq = ref.flash_bwd_dq(qf, kf, vf, dof, lse, delta, causal, block_q,
                              block_k, scale)
        dk, dv = ref.flash_bwd_dkv(qf, kf, vf, dof, lse, delta, causal,
                                   block_q, block_k, scale)
        return dq, dk, dv
    raise ValueError(f"flash attention runs on cuda or cpu, not {qf.device}")


def _layout_dims(q, k, layout):
    """(b, h, sq, sk, d) of operands in ``layout``."""
    if layout == "bhsd":
        b, h, sq, d = q.shape
        return b, h, sq, k.shape[2], d
    if layout == "bshd":
        b, sq, h, d = q.shape
        return b, h, sq, k.shape[1], d
    raise ValueError(f"unknown layout {layout!r}")


def _flat(t, layout):
    """``[b, s, h, d]`` or ``[b, h, s, d]`` to ``[b·h, s, d]``."""
    if layout == "bhsd":
        return t.reshape(-1, t.shape[2], t.shape[3])
    return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])


def _unflat(t, b, h, layout):
    t = t.reshape(b, h, t.shape[1], t.shape[2])
    return t if layout == "bhsd" else t.transpose(1, 2)


def _blocks(sq, sk, block_q, block_k):
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(
            f"flash_attention needs seq divisible by block sizes: "
            f"q {sq}%{block_q}, k {sk}%{block_k}")
    return block_q, block_k


def flash_fwd(q, k, v, causal, block_q=BLOCK, block_k=BLOCK, layout="bshd",
              variant="online"):
    """Forward on ``q, k, v`` in ``layout`` ('bshd' [b, s, h, d] or 'bhsd'
    [b, h, s, d]); returns ``(out, lse)`` with out in q's layout and
    dtype, lse the natural-log row log-sum-exp, fp32, ``[b·h, sq]``.

    CUDA tensors launch the kernel, which walks BLOCK-row tiles (or one
    partial tile for a shorter sequence); CPU tensors run the plain
    version at the given blocks."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown flash variant {variant!r}")
    b, h, sq, sk, _ = _layout_dims(q, k, layout)
    block_q, block_k = _blocks(sq, sk, block_q, block_k)
    out, lse = _fwd_flat(_flat(q, layout), _flat(k, layout),
                         _flat(v, layout), causal, block_q, block_k, variant)
    return _unflat(out, b, h, layout), lse


def flash_bwd(q, k, v, out, lse, g, causal, block_q=BLOCK, block_k=BLOCK,
              layout="bshd"):
    """Gradients ``(dq, dk, dv)`` in the operands' layout, given the
    forward's ``out`` (layout like q) and ``lse`` (``[b·h, sq]``) and the
    output gradient ``g`` (like out): the counterpart of the JAX
    package's ``_flash_bwd``. CUDA tensors launch the dq and dk/dv
    kernels; CPU tensors run their plain versions at the given blocks."""
    b, h, sq, sk, _ = _layout_dims(q, k, layout)
    block_q, block_k = _blocks(sq, sk, block_q, block_k)
    dq, dk, dv = _bwd_flat(*(_flat(t, layout) for t in (q, k, v, out)), lse,
                           _flat(g, layout), causal, block_q, block_k)
    return tuple(_unflat(t, b, h, layout) for t in (dq, dk, dv))


class _FlashAttention(torch.autograd.Function):
    """Attention on ``[b·h, s, d]`` operands with the flash backward."""

    @staticmethod
    def forward(ctx, qf, kf, vf, causal, block_q, block_k, variant):
        out, lse = _fwd_flat(qf, kf, vf, causal, block_q, block_k, variant)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.walk = (causal, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_flat(qf, kf, vf, out, lse, g, *ctx.walk)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=True, layout="bshd", variant="auto",
                    device=None):
    """Fused attention; q/k/v ``[b, s, h, d]`` (or ``[b, h, s, d]`` with
    ``layout="bhsd"``). Causal mask in global positions; exact softmax
    with fp32 statistics, matching ``parallel.ring.full_attention``.
    Differentiable: gradients come from the flash backward (the kernels
    on the card, their plain versions on the CPU), the same for every
    forward variant.

    ``device`` is where the caller means to run (CUDA unless it says
    ``"cpu"``); the tensors must lie there. A sequence the tile does not
    divide is end-padded for causal self-attention and refused otherwise;
    the padded rows get a zero output gradient, so they add nothing to
    dk and dv. ``variant`` is 'auto' or one of VARIANTS
    (HVD_FLASH_VARIANT overrides both)."""
    device = resolve_device(device)
    check_on(device, q, k, v)
    b, h, sq, sk, _ = _layout_dims(q, k, layout)
    seq_axis = 2 if layout == "bhsd" else 1
    bq, bk = fit_block(sq), fit_block(sk)
    pad_q, pad_k = -sq % bq, -sk % bk
    if (pad_q or pad_k) and not (causal and sq == sk):
        raise ValueError(
            f"flash_attention needs seq divisible by block sizes unless "
            f"causal self-attention: q {sq}%{bq}, k {sk}%{bk}")
    if pad_q or pad_k:
        def seq_pad(t, p):
            # F.pad lists pads from the last dim backwards
            return F.pad(t, [0, 0] * (3 - seq_axis) + [0, p])
        q, k, v = seq_pad(q, pad_q), seq_pad(k, pad_k), seq_pad(v, pad_k)
    variant = resolve_variant(variant, nk=(sk + pad_k) // bk)
    qf, kf, vf = (_flat(t, layout).contiguous() for t in (q, k, v))
    out = _unflat(_FlashAttention.apply(qf, kf, vf, causal, bq, bk, variant),
                  b, h, layout)
    if pad_q:
        out = out[:, :, :sq] if layout == "bhsd" else out[:, :sq]
    return out


def decode_attention(q, k, v, lengths):
    """Single-query attention against a cached K/V prefix — the decode
    step of the serving plane.

    q        [batch, 1, heads, head_dim] — the current token's query
    k, v     [batch, s_max, heads, head_dim] — the KV cache; only the
             first ``lengths[b]`` positions of row b are real
    lengths  [batch] int — valid prefix length per row

    Plain torch on purpose (see the module docstring). Numerics as the
    JAX version: fp32 logits from the input-dtype values, fp32 softmax,
    P in V's dtype with fp32 accumulation, output in q's dtype.
    """
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention wants q [b, 1, h, d], got "
                         f"{tuple(q.shape)}")
    d = q.shape[-1]
    s_max = k.shape[1]
    scale = d ** -0.5
    # [b, h, d] x [b, s, h, d] -> [b, h, s]
    logits = torch.einsum("bhd,bshd->bhs", q[:, 0].float(), k.float())
    logits = logits * scale
    pos = torch.arange(s_max, device=q.device)[None, None, :]
    valid = pos < lengths.to(torch.int64)[:, None, None]
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)[:, None]
