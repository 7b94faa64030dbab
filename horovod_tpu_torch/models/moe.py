"""Mixture-of-Experts layer with expert parallelism over the 'ep' mesh
axis, port of ``horovod_tpu/models/moe.py``.

The GShard/Switch pattern of the JAX package, with its numerics:

  * Routing, dispatch and combine are dense one-hot products over
    capacity-limited slots: static shapes, large matrix products.
  * The router is an fp32 dense layer with no bias on the input in fp32;
    softmax, then the top ``k`` experts (ties to the lower index, as
    ``jax.lax.top_k`` breaks them), their gates renormalised.
  * Each expert takes at most ``capacity = max(1, int(cf · s · k / E))``
    tokens of a batch row, by slot priority: slot 0 of every token before
    slot 1, each slot in sequence order. Tokens over capacity are dropped
    (their combine weight is zero).
  * The Switch load-balance loss ``E · Σ_e f_e · P_e`` over the whole
    batch is returned beside the output (flax's ``sow`` has no PyTorch
    counterpart; ``aux_loss_from`` sums the layers' values).

Placement. The expert stacks ``w_gate``/``w_up`` ``[E, d_model, d_ff]``
and ``w_down`` ``[E, d_ff, d_model]`` (the JAX package's layout) are
sharded over 'ep' on the expert dim and over 'tp' on the ffn dim; the
router ``[E, d_model]`` (the port's ``[out, in]``) is replicated. The
tokens are replicated over 'ep', as the JAX package's batch spec places
them: every ep rank routes its whole batch shard, runs its ``E / ep``
experts on it and the combine's partial sums meet in ONE all-reduce over
'ep' (what XLA makes of the JAX layer: no all-to-all). The batch
statistics of the loss are means over the whole batch: summed over the
mesh's 'dp' shards and the sequence ring's shards; under a sequence
ring, each shard's capacity positions count the tokens of the shards
before it.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import tensor_parallel as tpl
from .transformer import Dense


def top_k(probs, k):
    """The ``k`` largest entries of the last dim and their indices, equal
    values in index order (``jax.lax.top_k``'s order; ``torch.topk``
    promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity_of(cfg, seq):
    """Tokens each expert takes per batch row of ``seq`` tokens."""
    return max(1, int(cfg.expert_capacity_factor * seq *
                      cfg.num_experts_per_tok / cfg.num_experts))


class MoEMLP(nn.Module):
    """Gated (SwiGLU) expert FFN with top-k routing and fixed capacity:
    the block's MLP when ``cfg.num_experts > 0``. ``forward(x, sp=None)``
    gives ``(out, aux)``, ``aux`` the layer's load-balance loss."""

    def __init__(self, cfg, param_dtype, device=None):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        self.router = Dense(d, e, torch.float32, param_dtype, device)

        def stack(*shape):
            return nn.Parameter(torch.empty(shape, dtype=param_dtype,
                                            device=device))
        self.w_gate = stack(e, d, f)
        self.w_up = stack(e, d, f)
        self.w_down = stack(e, f, d)

    def route(self, x, sp=None, shards=()):
        """``(combine [b, s, E, C] fp32, aux)`` of ``x [b, s, d]``: each
        token's renormalised gate at its (expert, slot) or zero, and the
        load-balance loss over the whole batch. ``sp`` is the ring the
        sequence is sharded over, or None; ``shards`` the groups the
        expert stacks are split over (ep, tp), each of whose ranks sees a
        part of the gates' gradient."""
        cfg = self.cfg
        e, k = cfg.num_experts, cfg.num_experts_per_tok
        b, s, _ = x.shape
        cap = capacity_of(cfg, s if sp is None else s * sp.size)
        probs = torch.softmax(self.router(x.to(torch.float32)), dim=-1)
        gate_vals, gate_idx = top_k(probs, k)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(
            1e-9)
        # summed over the shards, the router's gradient comes out whole on
        # every rank
        for group in shards:
            gate_vals = tpl.copy_to(gate_vals, group)

        # capacity positions: slot j of a token queues behind every slot
        # j' < j of the row and the tokens before it (earlier sequence
        # shards included)
        masks = F.one_hot(gate_idx, e)                     # [b, s, k, E]
        counts = masks.sum(1)                              # [b, k, E]
        before = torch.zeros_like(counts)
        total = counts
        if sp is not None and sp.size > 1:
            by_shard = sp.all_gather(counts[None], 0)      # [sp, b, k, E]
            before = by_shard[:sp.rank].sum(0)
            total = by_shard.sum(0)
        prev = torch.zeros_like(counts[:, :1])             # [b, 1, E]
        combine = torch.zeros((b, s, e * cap), dtype=torch.float32,
                              device=x.device)
        for j in range(k):
            m = masks[:, :, j]
            pos = (m.cumsum(1) - m + before[:, j:j + 1] + prev) * m
            prev = prev + total[:, j:j + 1]
            mine = gate_idx[..., j:j + 1]
            pos = pos.gather(-1, mine)[..., 0]             # [b, s]
            within = (pos < cap).to(torch.float32)
            slot = gate_idx[..., j] * cap + pos.clamp(max=cap - 1)
            combine = combine.scatter_add(
                -1, slot[..., None], (gate_vals[..., j] * within)[..., None])

        # load balance (Switch: E · Σ_e f_e · P_e), means over the batch
        stats = torch.cat([masks[:, :, 0].to(torch.float32).sum((0, 1)),
                           probs.sum((0, 1))])
        n = b * s
        for group in (tpl.axis_of(self.router.weight, "dp", sharded=False),
                      sp if sp is not None and sp.size > 1 else None):
            if group is not None:
                stats = tpl.sum_over(stats, group)
                n *= group.size
        token_frac, prob_frac = (stats / n).split(e)
        aux = e * torch.sum(token_frac * prob_frac)
        return combine.view(b, s, e, cap), aux

    def forward(self, x, sp=None):
        cfg = self.cfg
        ep = tpl.ep_of(self.w_gate)
        groups = [g for g in (ep, tpl.tp_of(self.w_gate)) if g is not None]
        combine, aux = self.route(x, sp, groups)
        dispatch = (combine > 0).to(cfg.dtype)
        xd = x.to(cfg.dtype)
        w_gate, w_up, w_down = (tpl.local(w).to(cfg.dtype) for w in
                                (self.w_gate, self.w_up, self.w_down))
        for group in groups:
            xd = tpl.copy_to(xd, group)
        if ep is not None:      # this rank's experts
            n = w_gate.shape[0]
            combine = combine[:, :, ep.rank * n:(ep.rank + 1) * n]
            dispatch = dispatch[:, :, ep.rank * n:(ep.rank + 1) * n]
        expert_in = torch.einsum("bsec,bsm->ebcm", dispatch, xd)
        h = (F.silu(torch.einsum("ebcm,emf->ebcf", expert_in, w_gate))
             * torch.einsum("ebcm,emf->ebcf", expert_in, w_up))
        expert_out = torch.einsum("ebcf,efm->ebcm", h, w_down)
        out = torch.einsum("bsec,ebcm->bsm", combine.to(cfg.dtype),
                           expert_out)
        for group in reversed(groups):
            out = tpl.reduce_from(out, group)
        return out.to(cfg.dtype), aux


def aux_loss_from(auxes, weight=0.01):
    """``weight`` times the sum of the layers' load-balance losses (the
    list ``TransformerLM.forward(..., return_aux=True)`` returns)."""
    total = 0.0
    for aux in auxes:
        if aux is not None:
            total = total + aux
    return weight * total
