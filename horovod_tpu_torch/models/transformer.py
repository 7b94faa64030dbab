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
"""

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common.device import check_on, resolve_device
from ..parallel import ring


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
    # 'full' or 'flash' in this slice; 'ring', 'ring_flash' and 'ulysses'
    # come with the tensor/sequence-parallel slice
    attention_impl: str = "full"
    # flash forward variant: 'auto' | 'online' | 'lazy' | 'twopass'
    flash_variant: str = "auto"
    # Mixture-of-Experts is not ported yet: num_experts > 0 raises
    num_experts: int = 0

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


def _dispatch_attention(cfg, q, k, v, device):
    """Causal attention on ``[b, s, h, d]`` by ``cfg.attention_impl``."""
    if cfg.attention_impl not in _ATTENTION_IMPLS:
        raise ValueError(
            f"Unknown attention_impl={cfg.attention_impl!r}; "
            f"expected one of {_ATTENTION_IMPLS}.")
    if cfg.attention_impl == "flash":
        from ..ops.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=True,
                               variant=cfg.flash_variant, device=device)
    if cfg.attention_impl == "full":
        return ring.full_attention(q, k, v, causal=True)
    raise NotImplementedError(
        f"attention_impl={cfg.attention_impl!r} needs sequence "
        f"parallelism, which the port brings in its tensor/sequence-"
        f"parallel slice (ROADMAP.md); use 'full' or 'flash'")


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
        return (xf * (torch.rsqrt(var + self.eps) * self.scale)).to(
            self.dtype)


class Dense(nn.Linear):
    """Bias-free ``nn.Linear`` computing in ``dtype`` from a weight stored
    in ``param_dtype``: flax's ``Dense(dtype=...)``, which casts its input
    and its kernel to ``dtype`` at each use."""

    def __init__(self, d_in, d_out, dtype, param_dtype, device=None):
        super().__init__(d_in, d_out, bias=False, dtype=param_dtype,
                         device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.compute_dtype),
                        self.weight.to(self.compute_dtype))


class Embedding(nn.Embedding):
    """``nn.Embedding`` whose rows come out in ``dtype`` from a table
    stored in ``param_dtype`` (flax's ``Embed(dtype=...)``)."""

    def __init__(self, vocab, dim, dtype, param_dtype, device=None):
        super().__init__(vocab, dim, dtype=param_dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, tokens):
        return super().forward(tokens).to(self.compute_dtype)


def _dense(d_in, d_out, cfg, param_dtype, device):
    return Dense(d_in, d_out, cfg.dtype, param_dtype, device)


class Attention(nn.Module):
    def __init__(self, cfg, param_dtype, device=None):
        super().__init__()
        self.cfg = cfg
        self.qkv = _dense(cfg.d_model, 3 * cfg.d_model, cfg, param_dtype,
                          device)
        self.out = _dense(cfg.d_model, cfg.d_model, cfg, param_dtype, device)

    def project(self, x, positions):
        """Rotated q, k and v, each ``[b, s, heads, head_dim]``."""
        cfg = self.cfg
        q, k, v = self.qkv(x).split(cfg.d_model, dim=-1)
        shape = x.shape[:-1] + (cfg.num_heads, cfg.head_dim)
        q, k, v = q.reshape(shape), k.reshape(shape), v.reshape(shape)
        return _rope(q, positions), _rope(k, positions), v

    def forward(self, x, positions):
        q, k, v = self.project(x, positions)
        out = _dispatch_attention(self.cfg, q, k, v, x.device)
        return self.out(out.reshape(x.shape))


class MLP(nn.Module):
    """Gated SiLU MLP: down(silu(gate(x)) · up(x))."""

    def __init__(self, cfg, param_dtype, device=None):
        super().__init__()
        self.gate = _dense(cfg.d_model, cfg.d_ff, cfg, param_dtype, device)
        self.up = _dense(cfg.d_model, cfg.d_ff, cfg, param_dtype, device)
        self.down = _dense(cfg.d_ff, cfg.d_model, cfg, param_dtype, device)

    def forward(self, x):
        return self.down(F.silu(self.gate(x)) * self.up(x))


class Block(nn.Module):
    def __init__(self, cfg, param_dtype, device=None):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.attn = Attention(cfg, param_dtype, device)
        self.ln_mlp = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.mlp = MLP(cfg, param_dtype, device)

    def forward(self, x, positions):
        x = x + self.attn(self.ln_attn(x), positions)
        return x + self.mlp(self.ln_mlp(x))


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
        if cfg.num_experts > 0:
            raise NotImplementedError(
                "the port has no Mixture-of-Experts layer yet "
                "(num_experts must be 0)")
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
        """``[vocab, d_model]``: the tied embedding or the lm_head."""
        if self.lm_head is None:
            return self.embed.weight
        return self.lm_head.weight

    def forward(self, tokens, return_hidden=False):
        """Logits ``[b, s, vocab]``; with ``return_hidden=True`` the
        final-norm hidden states ``[b, s, d_model]`` instead. Serving
        callers run it under ``torch.no_grad()``."""
        check_on(self.device, tokens)
        x = self.embed(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        for layer in self.layers:
            x = layer(x, positions)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return head_logits(self.cfg, x, self.head_weight())


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
            std = (cfg.d_model ** -0.5 if name == "embed.weight"
                   else p.shape[1] ** -0.5)
            draw = torch.randn(p.shape, generator=generator,
                               device=generator.device) * std
            p.copy_(draw.to(device=device, dtype=p.dtype))
    return set_trainable(model, train)


def lm_loss_fn(model, vocab_chunk=0):
    """Next-token loss for ``TransformerLM``: returns ``loss_fn(model,
    tokens) -> loss``, the model standing where the JAX package's params
    stand.

    Full-length inputs, as the JAX package feeds them: the targets are the
    tokens rolled left by one, and the final position, whose target is
    unknowable, gets weight 0 — causal masking keeps every other
    position's output independent of the extra input token, so the loss is
    that of the shifted split. ``vocab_chunk > 0`` (the chunked cross
    entropy over vocab blocks) is not ported yet."""
    if vocab_chunk:
        raise NotImplementedError(
            "vocab_chunk > 0 (chunked_softmax_cross_entropy) is not ported "
            "yet (ROADMAP.md); use vocab_chunk=0")
    if model.cfg.num_experts > 0:
        raise NotImplementedError("the MoE auxiliary loss is not ported yet")
    from .. import trainer

    def loss_fn(model, tokens):
        targets = torch.roll(tokens, -1, dims=1)
        weights = torch.ones(tokens.shape, dtype=torch.float32,
                             device=tokens.device)
        weights[:, -1] = 0.0
        return trainer.softmax_cross_entropy(model(tokens), targets, weights)
    return loss_fn


def matmul_flops_per_token(cfg, seq):
    """Matmul FLOPs per token, PaLM appendix-B convention:
    ``6·P_matmul + 12·L·seq·d_model``. P_matmul counts the qkv and out
    projections (4·d²), the gated MLP's three d×d_ff kernels and the
    lm_head. Head-count independent, so MFU numbers are comparable across
    head shapes."""
    p_matmul = (cfg.num_layers * (4 * cfg.d_model ** 2 +
                                  3 * cfg.d_model * cfg.d_ff) +
                cfg.d_model * cfg.vocab_size)
    return 6 * p_matmul + 12 * cfg.num_layers * seq * cfg.d_model
