"""Prefill and single-token decode forwards over the port's LM.

The counterpart of ``horovod_tpu/serving/decode.py``: the same layer
primitives as ``TransformerLM.forward`` (its embedding, RMSNorms, qkv
projection with RoPE, MLP and head), re-run so that prefill can RETURN the
per-layer K/V it computed and decode can read and extend the cache. The
model's weights are the numerics contract; the tests hold both entry
points to the JAX ones and to ``TransformerLM.forward``.

Both read the weights through ``ServingWeights``: the model's own tensors
on one card, or, on a tensor-parallel mesh (the engine's ``mesh=``), this
rank's shards, placed once by the model's ``param_specs`` (Megatron's
column-parallel qkv, gate and up, row-parallel out and down, a
vocab-sharded head). There the fused qkv weight is gathered once, at
placement, and this rank keeps the rows of its ``heads / tp`` heads
(every head when tp does not divide them; the KV cache is then
replicated, ``parallel.mesh.kv_cache_spec``). From then on a forward
issues no collective on any weight: per layer one all-reduce of the
attention's ``out`` partial sums and one of the MLP's ``down``, then one
all-gather of the vocab-sharded head's logits for sampling (and, with a
tied, vocab-sharded embedding, one all-reduce of the lookup).
``ServingWeights.counts`` counts them by kind, and ``recording`` keeps
their shapes for the engine's ``resharding_report``.

Prefill attends through the model's own dispatch (the flash kernels on
the card for ``attention_impl="flash"``, on ``b · heads / tp`` rows under
tp); decode uses ``ops.flash_attention.decode_attention`` (one query
against the cache, fixed ``s_max`` masked by per-row lengths).
"""

import collections
import contextlib

import torch
import torch.nn.functional as F

from ..models.transformer import (_dispatch_attention, attention_columns,
                                  head_logits, head_rows, param_specs,
                                  split_heads)
from ..ops.flash_attention import decode_attention
from ..parallel import mesh as mesh_lib
from ..parallel.tensor_parallel import local


def _check_dense(cfg):
    if cfg.num_experts > 0:
        raise NotImplementedError(
            "serving supports dense configs only (num_experts=0); the "
            "MoE expert dispatch has no cached decode path yet")


class _Layer:
    """One block's weights as a serving forward reads them."""

    __slots__ = ("ln_attn", "qkv", "out", "ln_mlp", "gate", "up", "down")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class ServingWeights:
    """The weights of a ``TransformerLM`` as the serving forwards read
    them: the model's own tensors with no ``mesh`` (or a mesh whose tp
    axis is 1), else this rank's tp shards, placed by ``param_specs``
    (see the module docstring). ``counts`` counts the collectives the
    forwards issue, by kind: ``activation_all_reduce``, ``logits_gather``
    and ``weight_gather`` (placement's qkv gather, the only one)."""

    def __init__(self, cfg, model, mesh=None):
        self.cfg = cfg
        self.device = model.device
        self.mesh = mesh
        self.tp = 1 if mesh is None else mesh_lib.mesh_axis_size(mesh, "tp")
        self.counts = collections.Counter()
        self._records = None
        self.comm = mesh.comm("tp") if self.tp > 1 else None
        self.tp_rank = mesh.coordinate("tp") if self.tp > 1 else 0
        self.ln_f = model.ln_f
        if self.tp == 1:
            self.embed = local(model.embed.weight)
            self.head = local(model.head_weight())
            self.layers = [_Layer(
                ln_attn=b.ln_attn, qkv=local(b.attn.qkv.weight),
                out=local(b.attn.out.weight), ln_mlp=b.ln_mlp,
                gate=local(b.mlp.gate.weight), up=local(b.mlp.up.weight),
                down=local(b.mlp.down.weight)) for b in model.layers]
            return
        shards = self._shards(model)
        self.embed = shards["embed.weight"]
        self.embed_sharded = cfg.tie_embeddings
        self.head = shards["embed.weight" if cfg.tie_embeddings
                           else "lm_head.weight"]
        rows = head_rows(cfg, self.tp, self.tp_rank, self.device)
        self.layers = []
        for i, b in enumerate(model.layers):
            name = f"layers.{i}."
            qkv = self.all_gather(shards[name + "attn.qkv.weight"], 0,
                                  "weight_gather")
            self.layers.append(_Layer(
                ln_attn=b.ln_attn, qkv=qkv[rows].contiguous(),
                out=shards[name + "attn.out.weight"], ln_mlp=b.ln_mlp,
                gate=shards[name + "mlp.gate.weight"],
                up=shards[name + "mlp.up.weight"],
                down=shards[name + "mlp.down.weight"]))

    def _shards(self, model):
        """This rank's shard of every weight, plain and contiguous."""
        specs = param_specs(model)
        out = {}
        for name, p in model.named_parameters():
            sharding = mesh_lib.NamedSharding(self.mesh, specs[name])
            out[name] = sharding.local_slice(local(p).detach()).contiguous()
        return out

    @property
    def head_sharding(self):
        """The decode activations' head sharding (None when the heads
        are not split)."""
        if self.tp == 1:
            return None
        return mesh_lib.decode_head_sharding(self.cfg.num_heads, self.mesh)

    # -- the tp collectives, counted and recorded -----------------------

    def _record(self, kind, op, operand, result, dim=None):
        self.counts[kind] += 1
        if self._records is not None:
            self._records.append({
                "kind": kind, "op": op, "dim": dim,
                "result_shape": tuple(result.shape),
                "operand_shapes": [tuple(operand.shape)]})
        return result

    def all_reduce(self, x, kind="activation_all_reduce"):
        return self._record(kind, "all-reduce", x, self.comm.all_reduce(x))

    def all_gather(self, x, dim, kind):
        dim %= x.dim()
        return self._record(kind, "all-gather", x,
                            self.comm.all_gather(x.contiguous(), dim), dim)

    @contextlib.contextmanager
    def recording(self):
        """Within the block, every collective's (op, result shape,
        operand shapes, dim) is appended to the list yielded."""
        self._records = records = []
        try:
            yield records
        finally:
            self._records = None

    # -- the layer primitives -------------------------------------------

    def dense(self, x, w):
        """``x @ wᵀ`` in ``cfg.dtype``: flax's Dense, as ``Dense``."""
        return F.linear(x.to(self.cfg.dtype), w.to(self.cfg.dtype))

    def row_parallel(self, x, w):
        """The row-parallel product summed over tp: this rank's partial
        ``x @ wᵀ`` over its rows of the contraction, the exact products
        of the ``cfg.dtype`` operands accumulated in fp32, the ranks'
        partial sums added in fp32 and rounded to ``cfg.dtype`` once,
        where the unsharded product rounds its fp32 accumulator: the two
        differ only in the order of the fp32 sum."""
        dtype = self.cfg.dtype
        partial = F.linear(x.to(dtype).float(), w.to(dtype).float())
        return self.all_reduce(partial).to(dtype)

    def lookup(self, tokens):
        """The embedding rows of ``tokens`` in ``cfg.dtype``; a tied table
        sharded over tp on the vocab sums the ranks' rows."""
        w = self.embed
        if self.tp == 1 or not self.embed_sharded:
            return F.embedding(tokens, w).to(self.cfg.dtype)
        ids = tokens - self.tp_rank * w.shape[0]
        mine = (ids >= 0) & (ids < w.shape[0])
        rows = F.embedding(ids.clamp(0, w.shape[0] - 1), w)
        rows = rows * mine[..., None].to(rows.dtype)
        return self.all_reduce(rows).to(self.cfg.dtype)

    def project(self, layer, x, positions):
        """Rotated q, k, v of this rank's heads."""
        return split_heads(self.cfg, self.dense(x, layer.qkv), positions)

    def attn_out(self, layer, attn):
        """The attention block's output from ``attn`` ``[..., heads ·
        head_dim]`` of this rank's heads: the row-parallel ``out``
        summed over tp."""
        if self.tp == 1:
            return self.dense(attn, layer.out)
        attn = attention_columns(self.cfg, attn, self.tp, self.tp_rank)
        return self.row_parallel(attn, layer.out)

    def mlp(self, layer, x):
        h = F.silu(self.dense(x, layer.gate)) * self.dense(x, layer.up)
        if self.tp == 1:
            return self.dense(h, layer.down)
        return self.row_parallel(h, layer.down)

    def logits(self, x):
        """Logits over the whole vocab: this rank's vocab shard gathered
        over tp."""
        out = head_logits(self.cfg, x, self.head)
        if self.tp == 1:
            return out
        return self.all_gather(out, -1, "logits_gather")


def as_weights(cfg, model):
    """``model`` as ``ServingWeights``: a ``TransformerLM`` read as it is
    (no copy), or placed weights as they are."""
    return model if isinstance(model, ServingWeights) else \
        ServingWeights(cfg, model)


@torch.no_grad()
def prefill_forward(cfg, model, tokens):
    """Full causal forward over ``tokens`` [b, s], also returning the
    rotated per-layer K/V to seed the cache. ``model`` is a
    ``TransformerLM`` or its ``ServingWeights`` (this rank's heads under
    tp).

    Returns (logits [b, s, vocab], k [layers, b, s, h, d], v like k), h
    this rank's heads. Right-padded prompts are safe: causal masking
    makes every real position's output independent of later pad
    positions.
    """
    _check_dense(cfg)
    w = as_weights(cfg, model)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None]
    x = w.lookup(tokens)
    ks, vs = [], []
    for layer in w.layers:
        q, k, v = w.project(layer, layer.ln_attn(x), positions)
        ks.append(k)
        vs.append(v)
        attn = _dispatch_attention(cfg, q, k, v, w.device)
        x = x + w.attn_out(layer, attn.reshape(b, s, -1))
        x = x + w.mlp(layer, layer.ln_mlp(x))
    x = w.ln_f(x)
    return w.logits(x), torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def decode_step(cfg, model, tokens, positions, kv_k, kv_v):
    """One decode token for every cache row.

    tokens     [b] int — the token each row feeds in this step
    positions  [b] int — where that token sits (== tokens already in
               the row's cache; its K/V are written there)
    kv_k/kv_v  [layers, b, s_max, h, d] — the dense cache (h this rank's
               heads), updated IN PLACE; rows beyond a row's length hold
               junk that the length mask hides

    Returns (logits [b, vocab], kv_k, kv_v) with the new token's K/V
    written at ``positions``; attention spans 0..positions inclusive.
    """
    _check_dense(cfg)
    w = as_weights(cfg, model)
    b = tokens.shape[0]
    rows = torch.arange(b, device=tokens.device)
    x = w.lookup(tokens[:, None])
    lengths = positions + 1
    heads = w.head_sharding
    for i, layer in enumerate(w.layers):
        q, k, v = w.project(layer, layer.ln_attn(x), positions[:, None])
        kv_k[i, rows, positions] = k[:, 0]
        kv_v[i, rows, positions] = v[:, 0]
        attn = decode_attention(q, kv_k[i], kv_v[i], lengths,
                                head_sharding=heads)
        x = x + w.attn_out(layer, attn.reshape(b, 1, -1))
        x = x + w.mlp(layer, layer.ln_mlp(x))
    x = w.ln_f(x)
    return w.logits(x)[:, 0], kv_k, kv_v
