"""Sequence-parallel attention, port of ``horovod_tpu/parallel/ring.py``.

Only ``full_attention`` — the single-device exact attention behind
``attention_impl="full"`` — is ported so far; ring, ring-flash and
Ulysses attention come with the tensor/sequence-parallel slice.
"""

import torch

NEG_INF = -1e30


def full_attention(q, k, v, causal=True):
    """Exact attention on ``[b, s, h, d]`` operands: fp32 logits from the
    input-dtype values, fp32 softmax, P in V's dtype, output in q's."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)
