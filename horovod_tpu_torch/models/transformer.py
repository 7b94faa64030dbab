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
Dense and embedding weights are kept in ``cfg.dtype`` (the flax model
casts its fp32 params to that dtype at every use, which is the same
arithmetic); the RMSNorm scales stay fp32, where flax applies them.
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


def _dense(d_in, d_out, cfg, device):
    return nn.Linear(d_in, d_out, bias=False, dtype=cfg.dtype,
                     device=device)


class Attention(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.qkv = _dense(cfg.d_model, 3 * cfg.d_model, cfg, device)
        self.out = _dense(cfg.d_model, cfg.d_model, cfg, device)

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

    def __init__(self, cfg, device=None):
        super().__init__()
        self.gate = _dense(cfg.d_model, cfg.d_ff, cfg, device)
        self.up = _dense(cfg.d_model, cfg.d_ff, cfg, device)
        self.down = _dense(cfg.d_ff, cfg.d_model, cfg, device)

    def forward(self, x):
        return self.down(F.silu(self.gate(x)) * self.up(x))


class Block(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.attn = Attention(cfg, device)
        self.ln_mlp = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.mlp = MLP(cfg, device)

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
    """The LM; ``forward(tokens [b, s])`` gives logits ``[b, s, vocab]``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        if cfg.num_experts > 0:
            raise NotImplementedError(
                "the port has no Mixture-of-Experts layer yet "
                "(num_experts must be 0)")
        device = resolve_device(device)
        self.cfg = cfg
        self.device = device
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                  dtype=cfg.dtype, device=device)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.ln_f = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        _dense(cfg.d_model, cfg.vocab_size, cfg, device))

    def head_weight(self):
        """``[vocab, d_model]``: the tied embedding or the lm_head."""
        if self.lm_head is None:
            return self.embed.weight
        return self.lm_head.weight

    @torch.no_grad()
    def forward(self, tokens):
        check_on(self.device, tokens)
        x = self.embed(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        for layer in self.layers:
            x = layer(x, positions)
        return head_logits(self.cfg, self.ln_f(x), self.head_weight())


def init_params(cfg, generator=None, device=None):
    """A ``TransformerLM`` on ``device`` (CUDA unless told otherwise)
    with random weights drawn from ``generator`` (a CPU generator seeded
    0 when None, so a seed gives the same weights on every device):
    dense kernels normal with std 1/sqrt(fan_in), the embedding normal
    with std 1/sqrt(d_model), RMSNorm scales one — the scales of the
    flax initializers."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = TransformerLM(cfg, device)
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
    return model.eval().requires_grad_(False)
