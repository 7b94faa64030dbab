"""Decoder-only transformer LM, port of ``horovod_tpu/models/transformer.py``.

The same architecture and numerics contract as the flax model, written
as ``torch.nn`` modules: bias-free dense layers (weights ``[out, in]``),
one fused qkv projection, RoPE with fp32 angles and the rotation in the
activations' dtype, RMSNorm with fp32 statistics and epsilon 1e-6 (as
``flax.linen.RMSNorm``), a gated SiLU MLP, and an lm_head that is either
separate or the tied embedding, with fp32 or working-dtype logits.

In PyTorch a module owns its weights, so where the JAX package passes a
``(model, params)`` pair the port passes the ``TransformerLM`` alone:
``init_params`` returns one with seeded weights and
``models.convert.params_from_flax`` one holding a flax checkpoint.

Dense and embedding weights are stored in the model's ``param_dtype``
and cast to ``cfg.dtype`` at every use, as flax casts its fp32 params
("bf16 compute, fp32 params"). A training model keeps fp32 masters, so
that a 3e-4 update does not round away in bf16; a serving model stores
them in ``cfg.dtype`` (the casts are then no-ops, and the arithmetic is
the same). The RMSNorm scales are fp32 in both, where flax applies them.

Parallelism. Parameters placed on a mesh (``trainer.place`` with
``param_specs``: Megatron's column-parallel qkv/gate/up, row-parallel
out/down, a vocab-sharded head) are DTensors; each layer computes on this
rank's shard with the tp collectives of ``parallel.tensor_parallel``, so
no DTensor reaches a kernel and nothing is redistributed behind the
caller's back. The fused qkv kernel keeps the JAX package's placement
(a contiguous split of its ``3·d_model`` output rows, which cuts across
q | k | v); the attention gathers it each step and takes the q, k and v
rows of this rank's heads (``Attention.project``). A sequence sharded
over a ring (``forward(..., sp=ring)``) takes global RoPE positions and
attends across shards by ``attention_impl``.
"""

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from ..common.device import check_on, resolve_device
from ..parallel import ring
from ..parallel import tensor_parallel as tpl
from ..parallel.mesh import P


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # share the input embedding with the lm_head (GPT-2 ties them)
    tie_embeddings: bool = False
    # fp32 logits from the head matmul's accumulator; False keeps them in
    # ``dtype``
    logits_fp32: bool = True
    # recompute each block in the backward (torch.utils.checkpoint);
    # remat_policy None saves nothing, "dots" every matmul result,
    # "dots_no_batch" only the batch-free ones (projections and MLP)
    remat: bool = False
    remat_policy: Optional[str] = None
    # 'full', 'flash', 'ring', 'ring_flash' or 'ulysses'; with the whole
    # sequence on one worker the last three run as the reference runs them
    # without an sp axis (flash for ring_flash, full for the others)
    attention_impl: str = "full"
    # flash forward variant: 'auto' | 'online' | 'lazy' | 'twopass'
    flash_variant: str = "auto"
    # Mixture-of-Experts: num_experts > 0 replaces the dense MLP with
    # models/moe.py's expert layer (experts shard over the 'ep' mesh axis)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    expert_capacity_factor: float = 1.25

    @property
    def head_dim(self):
        return self.d_model // self.num_heads

    @classmethod
    def tiny(cls, **kw):
        return cls(vocab_size=256, num_layers=2, num_heads=4, d_model=64,
                   d_ff=256, max_seq_len=128, **kw)

    @classmethod
    def gpt2_small(cls, **kw):
        return cls(vocab_size=50304, num_layers=12, num_heads=12,
                   d_model=768, d_ff=3072, max_seq_len=1024, **kw)

    @classmethod
    def gpt2_small_tpu(cls, **kw):
        """GPT-2-small with 6 heads x 128 head_dim instead of 12 x 64:
        the same parameter count, layers, d_model and attention FLOPs."""
        return cls(vocab_size=50304, num_layers=12, num_heads=6,
                   d_model=768, d_ff=3072, max_seq_len=1024, **kw)

    @classmethod
    def llama_1b(cls, **kw):
        return cls(vocab_size=32000, num_layers=16, num_heads=16,
                   d_model=2048, d_ff=8192, max_seq_len=4096, **kw)


_ATTENTION_IMPLS = ("full", "ring", "ring_flash", "ulysses", "flash")


def _dispatch_attention(cfg, q, k, v, device, sp=None, sp_gather=False):
    """Causal attention on ``[b, s, h, d]`` by ``cfg.attention_impl``.

    ``sp`` is the ring the sequence is sharded over (None when the whole
    sequence is on this worker). With a ring, ring / ring_flash / ulysses
    attend across the shards; full and flash cannot, and raise as the
    reference does under an sp axis, unless ``sp_gather``: the GSPMD step
    shards the sequence through its batch spec, where the JAX package's
    XLA gathers the sequence for them, and the port does the same
    explicitly (every shard's q, k and v all-gathered, attention over the
    whole sequence, this shard's rows kept; the gradients reduce-scattered
    back). With no ring, ring_flash is the flash kernel (the single-block
    ring) and ring and ulysses exact full attention."""
    if cfg.attention_impl not in _ATTENTION_IMPLS:
        raise ValueError(
            f"Unknown attention_impl={cfg.attention_impl!r}; "
            f"expected one of {_ATTENTION_IMPLS}.")
    if sp is not None:
        if cfg.attention_impl == "ring":
            return ring.ring_attention(q, k, v, axis_name=sp, causal=True)
        if cfg.attention_impl == "ring_flash":
            return ring.ring_flash_attention(q, k, v, axis_name=sp,
                                             causal=True)
        if cfg.attention_impl == "ulysses":
            return ring.ulysses_attention(q, k, v, axis_name=sp, causal=True)
        if not sp_gather:
            raise ValueError(
                "The sequence is sharded over the 'sp' mesh axis but "
                f"attention_impl={cfg.attention_impl!r} cannot attend "
                "across shards — construct the model with "
                "attention_impl='ring', 'ring_flash', or 'ulysses' for "
                "sequence parallelism.")
        s_loc = q.shape[1]
        q, k, v = (ring.gather_sequence(t, sp) for t in (q, k, v))
        out = _dispatch_attention(cfg, q, k, v, device)
        return out[:, sp.rank * s_loc:(sp.rank + 1) * s_loc]
    if cfg.attention_impl in ("flash", "ring_flash"):
        from ..ops.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=True,
                               variant=cfg.flash_variant, device=device)
    return ring.full_attention(q, k, v, causal=True)


def _rope(x, positions):
    """Rotary position embedding on ``[..., seq, heads, head_dim]``:
    angles in fp32, the rotation in x's own dtype."""
    half = x.shape[-1] // 2
    freq = 1.0 / (10000.0 ** (
        torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None, None].to(torch.float32) * freq
    sin = torch.sin(angles).to(x.dtype)
    cos = torch.cos(angles).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class RMSNorm(nn.Module):
    """``flax.linen.RMSNorm`` with its defaults: mean of x² in fp32,
    ``x · (rsqrt(var + 1e-6) · scale)`` in fp32, cast to ``dtype``."""

    def __init__(self, dim, dtype, eps=1e-6, device=None):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, x):
        xf = x.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        scale = tpl.local(self.scale)
        return (xf * (torch.rsqrt(var + self.eps) * scale)).to(self.dtype)


class Dense(nn.Linear):
    """Bias-free ``nn.Linear`` computing in ``dtype`` from a weight stored
    in ``param_dtype``: flax's ``Dense(dtype=...)``, which casts its input
    and its kernel to ``dtype`` at each use."""

    def __init__(self, d_in, d_out, dtype, param_dtype, device=None):
        super().__init__(d_in, d_out, bias=False, dtype=param_dtype,
                         device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        """``x @ weightᵀ`` on this rank's shard of the weight (the whole
        weight when it is not placed on a mesh)."""
        return F.linear(x.to(self.compute_dtype),
                        tpl.local(self.weight).to(self.compute_dtype))


class Embedding(nn.Embedding):
    """``nn.Embedding`` whose rows come out in ``dtype`` from a table
    stored in ``param_dtype`` (flax's ``Embed(dtype=...)``). A table
    sharded over tp on the vocab (the tied embedding's placement) looks up
    the tokens of its vocab range and sums the ranks' rows."""

    def __init__(self, vocab, dim, dtype, param_dtype, device=None):
        super().__init__(vocab, dim, dtype=param_dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, tokens, weight=None):
        """Rows of ``tokens``; ``weight`` is this rank's shard of the table
        when the caller took it already (a tied head uses it too, so the
        two gradients meet on the shard)."""
        w = tpl.local(self.weight) if weight is None else weight
        tp = tpl.tp_of(self.weight)
        if tp is None:
            return F.embedding(tokens, w).to(self.compute_dtype)
        ids = tokens - tp.rank * w.shape[0]
        mine = (ids >= 0) & (ids < w.shape[0])
        rows = F.embedding(ids.clamp(0, w.shape[0] - 1), w)
        rows = rows * mine[..., None].to(rows.dtype)
        return tpl.reduce_from(rows, tp).to(self.compute_dtype)


def _dense(d_in, d_out, cfg, param_dtype, device):
    return Dense(d_in, d_out, cfg.dtype, param_dtype, device)


def heads_split(cfg, tp_size):
    """Whether the heads split over ``tp_size`` ranks. When they do not
    (6 heads over tp 4), every rank computes every head from the whole
    qkv weight, as the JAX package's GSPMD does with the column-sharded
    kernel, and the row-parallel ``out`` takes this rank's
    ``d_model / tp`` columns of the attention output."""
    return cfg.num_heads % tp_size == 0


def head_rows(cfg, tp_size, tp_rank, device=None):
    """The rows of the fused ``[3·d_model, d_model]`` qkv weight that hold
    q, k and v of tp rank ``tp_rank``'s heads, in q | k | v order: every
    row when the heads do not split over ``tp_size``."""
    if not heads_split(cfg, tp_size):
        return torch.arange(3 * cfg.d_model, device=device)
    width = cfg.d_model // tp_size
    mine = torch.arange(tp_rank * width, (tp_rank + 1) * width,
                        device=device)
    return torch.cat([mine + i * cfg.d_model for i in range(3)])


def attention_columns(cfg, out, tp_size, tp_rank):
    """This rank's input of the row-parallel ``out`` projection: its heads'
    attention output ``[..., d_model / tp]`` as it is, or, when the heads
    do not split and every rank holds all of them, its ``d_model / tp``
    columns of the whole output."""
    if heads_split(cfg, tp_size):
        return out
    width = cfg.d_model // tp_size
    return out[..., tp_rank * width:(tp_rank + 1) * width]


def split_heads(cfg, qkv, positions):
    """q, k and v ``[..., heads, head_dim]`` of a fused qkv product
    ``[..., 3 · heads · head_dim]`` (q | k | v), q and k rotated."""
    width = qkv.shape[-1] // 3
    heads = width // cfg.head_dim
    q, k, v = qkv.split(width, dim=-1)
    shape = qkv.shape[:-1] + (heads, cfg.head_dim)
    q, k, v = q.reshape(shape), k.reshape(shape), v.reshape(shape)
    return _rope(q, positions), _rope(k, positions), v


class Attention(nn.Module):
    def __init__(self, cfg, param_dtype, device=None):
        super().__init__()
        self.cfg = cfg
        self.qkv = _dense(cfg.d_model, 3 * cfg.d_model, cfg, param_dtype,
                          device)
        self.out = _dense(cfg.d_model, cfg.d_model, cfg, param_dtype, device)

    def project(self, x, positions, tp=None):
        """Rotated q, k and v, each ``[b, s, heads, head_dim]``: every
        head, or under tensor parallelism (``tp``) this rank's
        ``num_heads / tp`` heads (every head when they do not split),
        from their rows of the gathered qkv weight."""
        cfg = self.cfg
        if tp is None:
            return split_heads(cfg, self.qkv(x), positions)
        w = tpl.gather_rows(
            tpl.local(self.qkv.weight).to(cfg.dtype), tp,
            head_rows(cfg, tp.size, tp.rank, x.device))
        return split_heads(cfg, F.linear(x.to(cfg.dtype), w), positions)

    def forward(self, x, positions, sp=None, sp_gather=False):
        tp = tpl.tp_of(self.qkv.weight)
        if tp is not None:
            x = tpl.copy_to(x, tp)
        q, k, v = self.project(x, positions, tp)
        out = _dispatch_attention(self.cfg, q, k, v, x.device, sp,
                                  sp_gather)
        out = out.reshape(out.shape[:2] + (-1,))
        if tp is None:
            return self.out(out)
        out = attention_columns(self.cfg, out, tp.size, tp.rank)
        return tpl.reduce_from(self.out(out), tp)


class MLP(nn.Module):
    """Gated SiLU MLP: down(silu(gate(x)) · up(x))."""

    def __init__(self, cfg, param_dtype, device=None):
        super().__init__()
        self.gate = _dense(cfg.d_model, cfg.d_ff, cfg, param_dtype, device)
        self.up = _dense(cfg.d_model, cfg.d_ff, cfg, param_dtype, device)
        self.down = _dense(cfg.d_ff, cfg.d_model, cfg, param_dtype, device)

    def forward(self, x):
        """Column-parallel gate and up, row-parallel down under tensor
        parallelism: the ranks' partial outputs are summed."""
        tp = tpl.tp_of(self.gate.weight)
        if tp is not None:
            x = tpl.copy_to(x, tp)
        out = self.down(F.silu(self.gate(x)) * self.up(x))
        return out if tp is None else tpl.reduce_from(out, tp)


class Block(nn.Module):
    """Attention and the MLP, each behind an RMSNorm and a residual; the
    MLP is ``moe.MoEMLP`` when ``cfg.num_experts > 0``."""

    def __init__(self, cfg, param_dtype, device=None):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.attn = Attention(cfg, param_dtype, device)
        self.ln_mlp = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        if cfg.num_experts > 0:
            from .moe import MoEMLP
            self.mlp = MoEMLP(cfg, param_dtype, device)
        else:
            self.mlp = MLP(cfg, param_dtype, device)

    def forward(self, x, positions, sp=None, sp_gather=False,
                return_aux=False):
        """The block's output; with ``return_aux=True`` ``(output, aux)``,
        aux the expert layer's load-balance loss (None for a dense MLP)."""
        x = x + self.attn(self.ln_attn(x), positions, sp, sp_gather)
        y, aux = self.ln_mlp(x), None
        if isinstance(self.mlp, MLP):
            y = self.mlp(y)
        else:
            y, aux = self.mlp(y, sp)
        x = x + y
        return (x, aux) if return_aux else x


def _remat_context(name):
    """The selective-checkpoint context of ``remat_policy``: None saves
    nothing (the plain checkpoint), "dots" every matmul result,
    "dots_no_batch" the batch-free ones (2-D products: the projections
    and the MLP; attention's batched products are recomputed)."""
    if name is None:
        return None
    if name not in ("dots", "dots_no_batch"):
        raise ValueError(f"remat_policy={name!r}: expected one of "
                         f"['None', 'dots', 'dots_no_batch']")
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    ops = ("mm", "addmm") if name == "dots_no_batch" else (
        "mm", "addmm", "bmm", "baddbmm")
    saved = {getattr(torch.ops.aten, op).default for op in ops}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return lambda: create_selective_checkpoint_contexts(policy)


def head_logits(cfg, x, weight):
    """``x @ weight.T`` from ``cfg.dtype`` operands, in fp32 when
    ``cfg.logits_fp32`` (the exact products of the working-dtype values,
    accumulated in fp32 — what the flax head's preferred_element_type
    gives) and in ``cfg.dtype`` otherwise."""
    x, weight = x.to(cfg.dtype), weight.to(cfg.dtype)
    if cfg.logits_fp32:
        return F.linear(x.to(torch.float32), weight.to(torch.float32))
    return F.linear(x, weight)


class TransformerLM(nn.Module):
    """The LM; ``forward(tokens [b, s])`` gives logits ``[b, s, vocab]``.

    ``param_dtype`` is the storage dtype of the dense and embedding
    weights (``cfg.dtype`` when None): fp32 masters for training,
    ``cfg.dtype`` for serving."""

    def __init__(self, cfg, device=None, param_dtype=None):
        super().__init__()
        device = resolve_device(device)
        param_dtype = cfg.dtype if param_dtype is None else param_dtype
        self.cfg = cfg
        self.device = device
        self.param_dtype = param_dtype
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, cfg.dtype,
                               param_dtype, device)
        self.layers = nn.ModuleList(Block(cfg, param_dtype, device)
                                    for _ in range(cfg.num_layers))
        self.ln_f = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        _dense(cfg.d_model, cfg.vocab_size, cfg, param_dtype,
                               device))

    def head_weight(self):
        """``[vocab, d_model]``: the tied embedding or the lm_head (a
        DTensor when placed on a mesh; ``head_tp`` says whether its vocab
        is sharded)."""
        if self.lm_head is None:
            return self.embed.weight
        return self.lm_head.weight

    def head_tp(self):
        """The tp group the head's vocab is sharded over, or None."""
        return tpl.tp_of(self.head_weight())

    def forward(self, tokens, return_hidden=False, sp=None,
                sp_gather=False, return_aux=False):
        """Logits ``[b, s, vocab]``; with ``return_hidden=True`` the
        final-norm hidden states ``[b, s, d_model]`` instead. Serving
        callers run it under ``torch.no_grad()``. ``return_aux=True``
        gives ``(that, auxes)``, auxes the list of the expert layers'
        load-balance losses (``moe.aux_loss_from`` sums them; the JAX
        package sows them).

        ``sp``: the ring (``parallel.ring``) the sequence is sharded over,
        ``tokens`` being this rank's shard: positions are global
        (``rank · s_loc + arange``) and attention crosses the shards (see
        ``_dispatch_attention``; ``sp_gather`` as there). Under tensor
        parallelism the logits are this rank's vocab shard."""
        x, head, auxes = self.hidden_and_head(tokens, sp, sp_gather,
                                              return_aux=True)
        if not return_hidden:
            tp = self.head_tp()
            if tp is not None:
                x = tpl.copy_to(x, tp)
            x = head_logits(self.cfg, x, head)
        return (x, auxes) if return_aux else x

    def hidden_and_head(self, tokens, sp=None, sp_gather=False,
                        return_aux=False):
        """(final-norm hidden states, this rank's shard of the head
        weight): ``forward`` before the head. The tied table's shard is
        taken once for the lookup and the head, so that its two gradients
        meet on the shard. ``return_aux=True`` appends the expert layers'
        load-balance losses (a list, one per layer)."""
        check_on(self.device, tokens)
        table = tpl.local(self.embed.weight)
        x = self.embed(tokens, table)
        s_loc = tokens.shape[1]
        offset = 0 if sp is None else sp.rank * s_loc
        positions = (offset + torch.arange(s_loc, device=tokens.device))[None]
        remat = self.cfg.remat and torch.is_grad_enabled()
        context = _remat_context(self.cfg.remat_policy) if remat else None
        auxes = []
        for layer in self.layers:
            if remat:
                kw = {"context_fn": context} if context else {}
                x, aux = torch_checkpoint.checkpoint(
                    layer, x, positions, sp, sp_gather, True,
                    use_reentrant=False, **kw)
            else:
                x, aux = layer(x, positions, sp, sp_gather, True)
            auxes.append(aux)
        head = table if self.lm_head is None else tpl.local(
            self.lm_head.weight)
        out = (self.ln_f(x), head)
        return out + (auxes,) if return_aux else out


def set_trainable(model, train):
    """``model`` in training mode with gradients on, or in eval mode with
    its parameters frozen (serving)."""
    model.train(train)
    return model.requires_grad_(train)


def init_params(cfg, generator=None, device=None, train=False,
                param_dtype=None):
    """A ``TransformerLM`` on ``device`` (CUDA unless told otherwise)
    with random weights drawn from ``generator`` (a CPU generator seeded
    0 when None, so a seed gives the same weights on every device):
    dense kernels normal with std 1/sqrt(fan_in), the embedding normal
    with std 1/sqrt(d_model), RMSNorm scales one — the scales of the
    flax initializers.

    ``train=True`` gives a training model: fp32 master weights (unless
    ``param_dtype`` says otherwise) with gradients on. Otherwise the
    weights are stored in ``param_dtype`` or ``cfg.dtype`` and frozen,
    for serving. The fp32 draws are the same either way, so a training
    and a serving model of one seed compute the same function."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if param_dtype is None and train:
        param_dtype = torch.float32
    model = TransformerLM(cfg, device, param_dtype)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
                continue
            # fan_in as flax's initializers take it: the input dim, times
            # the experts of a [E, in, out] stack
            fan_in = (cfg.d_model if name == "embed.weight" else
                      p.shape[1] * (p.shape[0] if p.dim() == 3 else 1))
            std = fan_in ** -0.5
            draw = torch.randn(p.shape, generator=generator,
                               device=generator.device) * std
            p.copy_(draw.to(device=device, dtype=p.dtype))
    return set_trainable(model, train)


# ---------------------------------------------------------------------------
# Sharding rules: Megatron-style tensor parallelism as PartitionSpecs, in
# the port's [out, in] weight layout (the JAX package's specs on its
# [in, out] kernels, transposed).
# ---------------------------------------------------------------------------

_TP_RULES = (
    # (name suffix, spec) — first match wins.
    (("attn", "qkv", "weight"), P("tp", None)),      # column parallel
    (("attn", "out", "weight"), P(None, "tp")),      # row parallel
    (("mlp", "gate", "weight"), P("tp", None)),
    (("mlp", "up", "weight"), P("tp", None)),
    (("mlp", "down", "weight"), P(None, "tp")),
    # MoE expert stacks ([E, in, out], as the JAX package's): experts
    # over 'ep', ffn dim over 'tp'; the router replicated
    (("mlp", "w_gate"), P("ep", None, "tp")),
    (("mlp", "w_up"), P("ep", None, "tp")),
    (("mlp", "w_down"), P("ep", "tp", None)),
    (("mlp", "router", "weight"), P()),
    (("lm_head", "weight"), P("tp", None)),          # vocab-sharded head
    (("embed", "weight"), P(None, None)),
)


def param_specs(params):
    """PartitionSpec of every parameter of ``params`` (a ``TransformerLM``
    or a dict of named tensors), keyed by parameter name, for
    tensor-parallel placement (``trainer.place``). Unmatched parameters
    (the RMSNorm scales) are replicated.

    A tied-embedding model (no ``lm_head``) shards the embedding over 'tp'
    on the VOCAB axis, so that it keeps playing the vocab-sharded head's
    role; the lookup then sums the ranks' rows (``Embedding``)."""
    names = (dict(params.named_parameters()) if isinstance(params, nn.Module)
             else params)
    tied = not any(n.split(".")[0] == "lm_head" for n in names)

    def spec_for(name):
        parts = tuple(name.split("."))
        if tied and parts[-2:] == ("embed", "weight"):
            return P("tp", None)
        for suffix, spec in _TP_RULES:
            if parts[-len(suffix):] == suffix:
                return spec
        return P()
    return {n: spec_for(n) for n in names}


def batch_spec(sp=False):
    """Activation sharding for [batch, seq] token arrays: batch over 'dp',
    sequence over 'sp' when sequence parallelism is on."""
    return P("dp", "sp" if sp else None)


class _ChunkedCE(torch.autograd.Function):
    """Per-token nll ``lse - logit[target]`` of ``hidden @ kernel``, the
    lse taken online over vocab chunks; the backward recomputes each
    chunk's logits, so no ``[B, S, vocab]`` buffer lives past one chunk."""

    @staticmethod
    def forward(ctx, hidden, kernel, targets, chunk):
        m = torch.full(targets.shape, float("-inf"), device=hidden.device)
        s = torch.zeros(targets.shape, device=hidden.device)
        tgt = torch.zeros(targets.shape, device=hidden.device)
        for i0 in range(0, kernel.shape[1], chunk):
            logits = _chunk_logits(hidden, kernel, i0, chunk)
            new_m = torch.maximum(m, logits.amax(dim=-1))
            s = (s * torch.exp(m - new_m) +
                 torch.exp(logits - new_m[..., None]).sum(dim=-1))
            m = new_m
            loc, in_chunk = _in_chunk(targets, i0, logits.shape[-1])
            t = torch.gather(logits, -1, loc[..., None])[..., 0]
            tgt = torch.where(in_chunk, t, tgt)
        lse = m + torch.log(s)
        ctx.save_for_backward(hidden, kernel, targets, lse)
        ctx.chunk = chunk
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        hidden, kernel, targets, lse = ctx.saved_tensors
        dh = torch.zeros(hidden.shape, device=hidden.device)
        dk = torch.zeros(kernel.shape, device=kernel.device)
        for i0 in range(0, kernel.shape[1], ctx.chunk):
            logits = _chunk_logits(hidden, kernel, i0, ctx.chunk)
            dl = torch.exp(logits - lse[..., None])   # softmax
            loc, in_chunk = _in_chunk(targets, i0, logits.shape[-1])
            dl.scatter_add_(-1, loc[..., None],
                            -in_chunk[..., None].to(dl.dtype))
            # the transpose of the logits' cast to fp32
            dl = (dl * g[..., None]).to(hidden.dtype)
            k_i = kernel[:, i0:i0 + ctx.chunk].to(hidden.dtype)
            dh += torch.matmul(dl, k_i.t()).float()
            dk[:, i0:i0 + ctx.chunk] += torch.matmul(
                hidden.reshape(-1, hidden.shape[-1]).t(),
                dl.reshape(-1, dl.shape[-1])).float()
        return dh.to(hidden.dtype), dk.to(kernel.dtype), None, None


def _chunk_logits(hidden, kernel, i0, chunk):
    """fp32 logits of vocab columns [i0, i0 + chunk): the product in the
    hidden states' dtype, then cast, as the JAX package computes them."""
    k_i = kernel[:, i0:i0 + chunk].to(hidden.dtype)
    return torch.matmul(hidden, k_i).float()


def _in_chunk(targets, i0, width):
    in_chunk = (targets >= i0) & (targets < i0 + width)
    return (targets - i0).clamp(0, width - 1), in_chunk


def chunked_softmax_cross_entropy(hidden, head_kernel, targets, chunk=8192,
                                  weights=None, norm=None):
    """Mean next-token cross entropy WITHOUT materializing the
    [B, S, vocab] logits: the lm_head product and an online (running max
    and sum-exp) logsumexp chunk by chunk over the vocab, recomputed
    chunk by chunk in the backward, so the live logits stay
    [B, S, chunk] for about twice the head's FLOPs.

    ``hidden`` [B, S, D] (any dtype), ``head_kernel`` [D, V] (the JAX
    package's layout: the tied embedding transposed, or the lm_head
    kernel), ``targets`` [B, S] int ids. ``weights`` masks positions out
    of the mean; ``norm`` replaces the weights' sum as its denominator.
    """
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    chunk = min(chunk, head_kernel.shape[1])
    nll = _ChunkedCE.apply(hidden, head_kernel, targets.long(), chunk)
    if weights is None:
        return nll.mean()
    weights = weights.to(nll.dtype)
    return (nll * weights).sum() / (weights.sum() if norm is None else norm)


def _lm_batch(tokens):
    """(this rank's tokens, the ring its sequence is sharded over or None,
    targets, weights, the mean's denominator) of an LM batch.

    The targets are the tokens rolled left by one, and the final position,
    whose target is unknowable, gets weight 0. A batch placed on a mesh
    (a DTensor, as the GSPMD step gives it) whose sequence is sharded over
    'sp' builds them on its whole sequence (the shards' tokens
    all-gathered) before taking this shard's part, so the roll crosses
    the shard boundaries and only the last *global* position is dropped;
    the mean then divides by the whole sequence's weight, so the shards'
    losses sum to this batch row block's mean."""
    from torch.distributed.tensor import DTensor, Shard
    sp = None
    if isinstance(tokens, DTensor):
        mesh = tokens.device_mesh
        names = mesh.mesh_dim_names or ()
        if "sp" in names:
            i = names.index("sp")
            if mesh.size(i) > 1 and tokens.placements[i] == Shard(1):
                sp = ring.GroupRing(mesh.get_group("sp"))
        tokens = tokens.to_local()
    whole = tokens if sp is None else sp.all_gather(tokens, 1)
    targets = torch.roll(whole, -1, dims=1)
    weights = torch.ones(whole.shape, dtype=torch.float32,
                         device=whole.device)
    weights[:, -1] = 0.0
    norm = None
    if sp is not None:
        norm = weights.sum()
        cols = slice(sp.rank * tokens.shape[1],
                     (sp.rank + 1) * tokens.shape[1])
        targets, weights = targets[:, cols], weights[:, cols]
    return tokens, sp, targets, weights, norm


def lm_loss_fn(model, aux_weight=0.01, vocab_chunk=0):
    """Next-token loss for ``TransformerLM``: returns ``loss_fn(model,
    tokens) -> loss``, the model standing where the JAX package's params
    stand. With experts (``cfg.num_experts > 0``) it adds ``aux_weight``
    times the layers' load-balance losses (``moe.aux_loss_from``); their
    statistics include the final token, whose target alone is unknowable.
    A shard of a sequence ring adds its share of them (1/sp), so that the
    shards' losses sum to the batch's.

    Full-length inputs, as the JAX package feeds them: the targets are the
    tokens rolled left by one, and the final position, whose target is
    unknowable, gets weight 0 — causal masking keeps every other
    position's output independent of the extra input token, so the loss is
    that of the shifted split. ``tokens`` is the whole batch, or a batch
    placed on a mesh (see ``_lm_batch``); under tensor parallelism the
    cross entropy runs over the vocab-sharded logits.

    ``vocab_chunk > 0`` computes the cross entropy blockwise over the
    vocab (``chunked_softmax_cross_entropy``) from the final hidden states
    instead of materializing the full logits; under tensor parallelism the
    vocab-sharded head is gathered for it (every tp rank then computes the
    same loss), as the JAX package's chunking reshape forces a gather."""
    from .. import trainer
    from .moe import aux_loss_from
    moe = model.cfg.num_experts > 0

    def loss_fn(model, tokens):
        tokens, sp, targets, weights, norm = _lm_batch(tokens)
        if vocab_chunk:
            hidden, head, auxes = model.hidden_and_head(
                tokens, sp, sp_gather=True, return_aux=True)
            tp = model.head_tp()
            if tp is not None:   # the whole [vocab, d_model] head
                head = tpl.gather_replicated(head, tp)
            loss = chunked_softmax_cross_entropy(
                hidden, head.t(), targets, chunk=vocab_chunk,
                weights=weights, norm=norm)
        else:
            logits, auxes = model(tokens, sp=sp, sp_gather=True,
                                  return_aux=True)
            loss = trainer.softmax_cross_entropy(
                logits, targets, weights, norm=norm, tp=model.head_tp())
        if moe:
            share = 1 if sp is None else sp.size
            loss = loss + aux_loss_from(auxes, weight=aux_weight) / share
        return loss
    return loss_fn


def matmul_flops_per_token(cfg, seq):
    """Matmul FLOPs per token, PaLM appendix-B convention:
    ``6·P_matmul + 12·L·seq·d_model``. P_matmul counts the qkv and out
    projections (4·d²), the gated MLP's three d×d_ff kernels and the
    lm_head. Head-count independent, so MFU numbers are comparable across
    head shapes. It counts a dense MLP, with experts too (where the
    figure is no MoE step's work)."""
    p_matmul = (cfg.num_layers * (4 * cfg.d_model ** 2 +
                                  3 * cfg.d_model * cfg.d_ff) +
                cfg.d_model * cfg.vocab_size)
    return 6 * p_matmul + 12 * cfg.num_layers * seq * cfg.d_model
