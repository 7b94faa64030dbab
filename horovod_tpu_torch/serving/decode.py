"""Prefill and single-token decode forwards over the port's LM.

The counterpart of ``horovod_tpu/serving/decode.py``: the same layer
primitives as ``TransformerLM.forward`` (its own embedding, RMSNorms,
qkv projection with RoPE, MLP and head), re-run so that prefill can
RETURN the per-layer K/V it computed and decode can read and extend the
cache. The model's weights are the numerics contract; the tests hold
both entry points to the JAX ones and to ``TransformerLM.forward``.

Prefill attends through the model's own dispatch (the flash kernels on
the card for ``attention_impl="flash"``); decode uses
``ops.flash_attention.decode_attention`` (one query against the cache,
fixed ``s_max`` masked by per-row lengths).
"""

import torch

from ..models.transformer import _dispatch_attention, head_logits
from ..ops.flash_attention import decode_attention


def _check_dense(cfg):
    if cfg.num_experts > 0:
        raise NotImplementedError(
            "serving supports dense configs only (num_experts=0); the "
            "MoE expert dispatch has no cached decode path yet")


@torch.no_grad()
def prefill_forward(cfg, model, tokens):
    """Full causal forward over ``tokens`` [b, s], also returning the
    rotated per-layer K/V to seed the cache.

    Returns (logits [b, s, vocab], k [layers, b, s, h, d], v like k).
    Right-padded prompts are safe: causal masking makes every real
    position's output independent of later pad positions.
    """
    _check_dense(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None]
    x = model.embed(tokens)
    ks, vs = [], []
    for layer in model.layers:
        q, k, v = layer.attn.project(layer.ln_attn(x), positions)
        ks.append(k)
        vs.append(v)
        attn = _dispatch_attention(cfg, q, k, v, model.device)
        x = x + layer.attn.out(attn.reshape(b, s, cfg.d_model))
        x = x + layer.mlp(layer.ln_mlp(x))
    x = model.ln_f(x)
    return (head_logits(cfg, x, model.head_weight()), torch.stack(ks),
            torch.stack(vs))


@torch.no_grad()
def decode_step(cfg, model, tokens, positions, kv_k, kv_v):
    """One decode token for every cache row.

    tokens     [b] int — the token each row feeds in this step
    positions  [b] int — where that token sits (== tokens already in
               the row's cache; its K/V are written there)
    kv_k/kv_v  [layers, b, s_max, h, d] — the dense cache, updated IN
               PLACE; rows beyond a row's length hold junk that the
               length mask hides

    Returns (logits [b, vocab], kv_k, kv_v) with the new token's K/V
    written at ``positions``; attention spans 0..positions inclusive.
    """
    _check_dense(cfg)
    b = tokens.shape[0]
    rows = torch.arange(b, device=tokens.device)
    x = model.embed(tokens[:, None])
    lengths = positions + 1
    for i, layer in enumerate(model.layers):
        q, k, v = layer.attn.project(layer.ln_attn(x), positions[:, None])
        kv_k[i, rows, positions] = k[:, 0]
        kv_v[i, rows, positions] = v[:, 0]
        attn = decode_attention(q, kv_k[i], kv_v[i], lengths)
        x = x + layer.attn.out(attn.reshape(b, 1, cfg.d_model))
        x = x + layer.mlp(layer.ln_mlp(x))
    x = model.ln_f(x)
    return head_logits(cfg, x, model.head_weight())[:, 0], kv_k, kv_v
