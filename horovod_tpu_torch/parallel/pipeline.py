"""Pipeline parallelism: the GPipe microbatch schedule over the 'pp' mesh
axis, port of ``horovod_tpu/parallel/pipeline.py``.

  * ``gpipe`` runs one stage of the schedule on this rank: M + P − 1
    ticks (M microbatches, P stages); stage 0 injects microbatch
    ``min(t, M − 1)``, every other stage takes its neighbour's output of
    the tick before, and the last stage keeps its outputs from tick
    P − 1 on. The hop is one way (stage i to i + 1; stage 0 receives
    nothing, as ``lax.ppermute`` with the pairs (i, i + 1) gives), and the
    backward sends each cotangent the other way. The backward is the
    schedule run in reverse tick by tick on the graphs the forward kept,
    so every rank makes the same exchanges in the same order.
  * Bubble ticks compute on inputs whose outputs are never read: their
    gradient is exactly zero (the GPipe trade, bubble (P−1)/(M+P−1)).
  * ``make_pipeline_step`` trains the transformer LM on dp × pp (× tp ×
    sp): the layer stack split over 'pp', each stage's layers ordinary
    ``Block``s on their tp shards, the embedding on stage 0 and the final
    norm, head and loss on the last stage.

The stacked layout (``stack_pipeline_params``: ``layers.{i}.<name>`` of
every layer stacked into one ``[L, ...]`` tensor under ``layers``) is the
interchange format with the JAX package and its spec tree; placed on the
mesh, each stacked leaf is a DTensor whose local shard holds this stage's
layers.

A hop between two processes of one gloo group stages a CUDA activation
through host memory: gloo's point-to-point moves host buffers only.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import mesh as mesh_lib
from . import tensor_parallel as tpl
from .mesh import P
from .ring import as_ring


# ---------------------------------------------------------------------------
# the schedule


def _exchange(ring, send=None, dst=None, src=None, like=None):
    """Send ``send`` to group rank ``dst`` and receive a tensor shaped like
    ``like`` from group rank ``src`` (either may be None); returns what
    arrived, or None. Over gloo a CUDA tensor goes through host memory."""
    device = (send if send is not None else like).device
    staged = device.type == "cuda" and dist.get_backend(ring.group) == "gloo"
    ops, out = [], None
    if send is not None:
        buf = send.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, buf.cpu() if staged else buf,
                              ring._peer(dst), ring.group))
    if src is not None:
        out = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if staged else device)
        ops.append(dist.P2POp(dist.irecv, out, ring._peer(src), ring.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if out is not None and staged:
        out = out.to(device)
    return out


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, ring, micro, anchor):
        stage, n_stages, num_micro = ring.rank, ring.size, micro.shape[0]
        ticks = num_micro + n_stages - 1
        state = torch.zeros_like(micro[0])
        outputs = [torch.zeros_like(micro[0]) for _ in range(num_micro)]
        graphs = []
        for t in range(ticks):
            x_in = micro[min(t, num_micro - 1)] if stage == 0 else state
            leaf = x_in.detach().requires_grad_(True)
            with torch.enable_grad():
                y = stage_fn(leaf)
            graphs.append((leaf, y))
            if stage == n_stages - 1 and t >= n_stages - 1:
                outputs[t - (n_stages - 1)] = y.detach()
            if t < ticks - 1:       # the last tick's hop is never read
                state = _exchange(
                    ring, y if stage < n_stages - 1 else None, stage + 1,
                    stage - 1 if stage > 0 else None, like=y)
        ctx.ring, ctx.graphs, ctx.shape = ring, graphs, micro.shape
        return torch.stack(outputs)

    @staticmethod
    def backward(ctx, g_out):
        ring, graphs = ctx.ring, ctx.graphs
        stage, n_stages = ring.rank, ring.size
        num_micro = ctx.shape[0]
        g_micro = g_out.new_zeros(ctx.shape)
        for t in reversed(range(len(graphs))):
            leaf, y = graphs[t]
            g = torch.zeros_like(y)
            if stage == n_stages - 1 and t >= n_stages - 1:
                g = g + g_out[t - (n_stages - 1)]
            if t < len(graphs) - 1 and stage < n_stages - 1:
                # the cotangent of the output this rank sent at tick t
                g = g + _exchange(ring, src=stage + 1, like=y)
            torch.autograd.backward(y, g)
            g_in = leaf.grad if leaf.grad is not None else torch.zeros_like(
                leaf)
            graphs[t] = None
            if stage == 0:
                g_micro[min(t, num_micro - 1)] += g_in
            elif t > 0:             # tick 0's input was no hop's
                _exchange(ring, g_in, dst=stage - 1)
        ctx.graphs = None
        return None, None, g_micro, None


def gpipe(stage_fn, microbatches, ring="pp"):
    """Run ``stage_fn`` as this rank's stage of a GPipe pipeline.

    ``stage_fn``: activation -> activation of the same shape and dtype
    (embedding and head outside the pipeline); ``microbatches``: ``[M,
    ...]`` stacked microbatch activations (only stage 0 reads them);
    ``ring``: the pipeline axis, a name of the global mesh, a process
    group or a group object (``parallel.ring.GroupRing``).

    Returns ``[M, ...]`` outputs, valid on the LAST stage (zeros
    elsewhere; ``last_stage_value`` gives them to every stage).
    Differentiable: the gradient of ``microbatches`` lands on stage 0,
    the parameters ``stage_fn`` closes over get theirs in the backward."""
    # the stage's parameters want gradients even where the microbatches
    # want none (every stage but the first): the anchor makes the output
    # part of the graph whenever grad is on
    anchor = torch.zeros((), requires_grad=torch.is_grad_enabled())
    return _GPipe.apply(stage_fn, as_ring(ring), microbatches, anchor)


class _LastStage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring):
        ctx.last = ring.rank == ring.size - 1
        return ring.all_reduce(x if ctx.last else torch.zeros_like(x))

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def last_stage_value(x, ring="pp"):
    """The last stage's ``x`` on every stage (a masked sum over the
    pipeline ring); its gradient reaches the last stage's ``x`` alone."""
    return _LastStage.apply(x, as_ring(ring))


# ---------------------------------------------------------------------------
# the stacked layout


def _named(params):
    if isinstance(params, torch.nn.Module):
        return {n: p.detach() for n, p in params.named_parameters()}
    return dict(params)


def stack_pipeline_params(params, num_layers):
    """A ``TransformerLM``'s parameters (the module, or a dict by name) in
    the pipeline layout: ``{"layers": {name: [L, ...]}, "embed.weight",
    "ln_f.scale", "lm_head.weight"}``, each ``layers.{i}.<name>`` stacked
    on a new leading layer axis (the axis 'pp' shards)."""
    params = _named(params)
    first = [n[len("layers.0."):] for n in params if n.startswith("layers.0.")]
    layers = {n: torch.stack([params[f"layers.{i}.{n}"]
                              for i in range(num_layers)]) for n in first}
    rest = {n: t for n, t in params.items() if not n.startswith("layers.")}
    return {"layers": layers, **rest}


def unstack_pipeline_params(pparams, num_layers):
    """``stack_pipeline_params``' inverse: parameters by name (e.g. for
    checkpointing in the model's layout)."""
    out = {k: v for k, v in pparams.items() if k != "layers"}
    for i in range(num_layers):
        for n, t in pparams["layers"].items():
            out[f"layers.{i}.{n}"] = t[i]
    return out


# Megatron's rules for the STACKED layer layout, in the port's [out, in]
# weights: the leading dim is the pp-sharded layer axis, then
# models/transformer.py's _TP_RULES (column-parallel qkv/gate/up,
# row-parallel out/down)
_STACKED_TP_RULES = (
    ("attn.qkv.weight", P("pp", "tp", None)),
    ("attn.out.weight", P("pp", None, "tp")),
    ("mlp.gate.weight", P("pp", "tp", None)),
    ("mlp.up.weight", P("pp", "tp", None)),
    ("mlp.down.weight", P("pp", None, "tp")),
)


def pipeline_param_specs(pparams, tp=False):
    """PartitionSpecs of the pipeline layout: the layer stacks sharded
    over 'pp' on the leading axis, everything else replicated; ``tp=True``
    also shards the stacked kernels (Megatron) and the lm_head (on the
    vocab) over 'tp'."""
    rules = dict(_STACKED_TP_RULES) if tp else {}
    out = {"layers": {n: rules.get(n, P("pp")) for n in pparams["layers"]}}
    for n in pparams:
        if n != "layers":
            out[n] = P("tp", None) if tp and n == "lm_head.weight" else P()
    return out


def place_pipeline_params(pparams, shardings):
    """The pipeline tree (whole tensors, the same on every rank) placed by
    ``shardings`` (``make_pipeline_step``'s): trainable DTensor
    parameters, each holding this rank's shard."""
    def put(t, s):
        if isinstance(t, dict):
            return {k: put(t[k], s[k]) for k in t}
        return torch.nn.Parameter(s.place(t), requires_grad=True)
    return put(pparams, shardings)


def pipeline_leaves(pparams):
    """The leaves of a placed pipeline tree, in a fixed order (an
    optimizer's parameter list)."""
    return [pparams["layers"][n] for n in sorted(pparams["layers"])] + \
        [pparams[n] for n in sorted(pparams) if n != "layers"]


def _leaf_at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


# ---------------------------------------------------------------------------
# the transformer pipeline step


def make_pipeline_step(cfg, tx, mesh, num_microbatches, pparams,
                       dp_axis="dp", pp_axis="pp", tp_axis="tp",
                       sp_axis="sp"):
    """The dp × pp (× tp × sp) training step for ``TransformerLM``.

    The layer stack is split over ``pp_axis`` (num_layers / pp a stage),
    the batch over ``dp_axis``; microbatches flow through the stages by
    ``gpipe``. Gradients: the mean over dp (and sp) for every leaf, then
    the sum over pp for the embedding, final norm and head, which one
    stage each uses. Under ``tp_axis`` > 1 the stage's layers compute on
    their Megatron shards with the tp collectives of
    ``models.transformer`` and the head is vocab-sharded. Under
    ``sp_axis`` > 1 with ring, ring_flash or ulysses attention, the
    tokens arrive sp-replicated and each sp member takes its chunk of the
    global sequence after the shift; with full or flash attention the sp
    axis stays replicated.

    ``pparams``: the stacked layout (whole or placed; read for its names
    and shapes). ``tx``: a plain optimizer over the placed leaves
    (``place_pipeline_params``, ``pipeline_leaves``), not a
    ``DistributedOptimizer``: the step reduces the gradients itself.

    Returns ``(step, pparam_shardings, batch_sharding)``;
    ``step(pparams, opt_state, tokens [b, S+1]) -> (pparams, opt_state,
    loss)`` takes the placed tree, ``tx`` and the whole batch (or one
    placed by ``batch_sharding``), makes one update in place and returns
    the loss, the mean over the batch, the same on every rank."""
    from .. import mpi_ops, trainer
    from ..models import transformer as tr
    from .ring import GroupRing

    pp = mesh_lib.mesh_axis_size(mesh, pp_axis)
    if cfg.num_layers % pp:
        raise ValueError(
            f"num_layers={cfg.num_layers} not divisible by pp={pp}")
    if cfg.num_experts > 0:
        raise NotImplementedError(
            "make_pipeline_step does not yet thread the MoE aux loss "
            "through the pipeline; use make_gspmd_step with "
            "models.transformer.lm_loss_fn for MoE configs.")
    if cfg.tie_embeddings:
        raise NotImplementedError(
            "make_pipeline_step does not support tie_embeddings: the "
            "embedding lives on the first stage and the head on the "
            "last, so tying needs a cross-stage weight exchange; use "
            "make_gspmd_step, or an untied config, for pipeline "
            "parallelism.")
    sp = mesh_lib.mesh_axis_size(mesh, sp_axis)
    sp_active = sp > 1 and cfg.attention_impl in ("ring", "ring_flash",
                                                  "ulysses")
    tp = mesh_lib.mesh_axis_size(mesh, tp_axis)
    specs = pipeline_param_specs(pparams, tp=tp > 1)
    shardings = mesh_lib.tree_shardings(specs, mesh)
    batch_sharding = mesh_lib.named_sharding(P(dp_axis, None), mesh)
    # one layer's weight as a Block reads it: the stacked spec without
    # its layer axis, so that a tp shard is recognised as one
    layer_shardings = {n: mesh_lib.named_sharding(P(*s[1:]), mesh)
                       for n, s in specs["layers"].items()}
    shapes = {n: tuple(t.shape[1:]) for n, t in pparams["layers"].items()}
    tp_sharded = [n for n, s in specs["layers"].items() if "tp" in s]
    head_tp = (GroupRing(mesh.group(tp_axis))
               if "tp" in specs["lm_head.weight"] else None)
    # the leaves' paths: ("layers", name) or (name,)
    leaf_names = {"layers": {n: ("layers", n) for n in pparams["layers"]},
                  **{n: (n,) for n in pparams if n != "layers"}}
    block = tr.Block(cfg, torch.float32, device="meta")
    ln_f = tr.RMSNorm(cfg.d_model, cfg.dtype, device="meta")
    per_stage = cfg.num_layers // pp
    reduce_over = [(dp_axis, True)] + ([(sp_axis, True)] if sp_active
                                       else [])

    def ring_of(axis):
        return GroupRing(mesh.group(axis))

    def per_rank_loss(leaf, tokens, pp_ring):
        """This rank's part of the forward and backward on ``leaf``, its
        shards of the leaves as plain tensors that collect the gradients:
        returns the last stage's loss (None on the other stages)."""
        from torch.distributed.tensor import DTensor
        tokens = (tokens.to_local() if isinstance(tokens, DTensor)
                  else batch_sharding.local_slice(tokens))
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        b_loc, s = inputs.shape
        if b_loc % num_microbatches:
            raise ValueError(
                f"local batch {b_loc} not divisible by "
                f"num_microbatches={num_microbatches}")
        sp_ring = None
        if sp_active:
            if s % sp:
                raise ValueError(
                    f"sequence length {s} not divisible by sp={sp}")
            sp_ring = ring_of(sp_axis)
            s = s // sp
            start = sp_ring.rank * s
            inputs = inputs[:, start:start + s]
            targets = targets[:, start:start + s]
        else:
            start = 0
        positions = (start + torch.arange(s, device=tokens.device))[None]
        stage = pp_ring.rank
        mb = b_loc // num_microbatches
        if stage == 0:
            x = F.embedding(inputs, leaf["embed.weight"])
            x = x.to(cfg.dtype)
        else:
            x = torch.zeros((b_loc, s, cfg.d_model), dtype=cfg.dtype,
                            device=tokens.device)
        x = x.reshape(num_microbatches, mb, s, cfg.d_model)
        def stage_fn(act):
            # this stage's layers, each a Block on its weights' shards (a
            # tp shard wrapped as the DTensor the layer takes it for)
            for i in range(per_stage):
                w = {n: t[i] for n, t in leaf["layers"].items()}
                for n in tp_sharded:
                    w[n] = layer_shardings[n].wrap(w[n], shapes[n])
                act = torch.func.functional_call(block, w,
                                                 (act, positions, sp_ring))
            return act

        y = gpipe(stage_fn, x, pp_ring)
        if stage != pp_ring.size - 1:
            # the head and the loss are the last stage's; this stage's
            # backward still runs the schedule's exchanges
            torch.autograd.backward(y, torch.zeros_like(y))
            return None
        y = y.reshape(b_loc, s, cfg.d_model)
        y = torch.func.functional_call(
            ln_f, {"scale": leaf["ln_f.scale"]}, (y,))
        if head_tp is not None:
            y = tpl.copy_to(y, head_tp)
        logits = F.linear(y.to(cfg.dtype),
                          leaf["lm_head.weight"].to(cfg.dtype)).float()
        loss = trainer.softmax_cross_entropy(logits, targets, tp=head_tp)
        loss.backward()
        return loss.detach()

    def step(pparams, opt_state, tokens):
        opt_state.zero_grad(set_to_none=True)
        pp_ring = ring_of(pp_axis)
        # the shards as leaves of this step's graph: the gradients collect
        # in plain tensors over the ticks, and each parameter gets its
        # reduced gradient wrapped once (no DTensor arithmetic)
        leaf = {"layers": {n: tpl.local(p).detach().requires_grad_(True)
                           for n, p in pparams["layers"].items()}}
        leaf.update({n: tpl.local(p).detach().requires_grad_(True)
                     for n, p in pparams.items() if n != "layers"})
        loss = per_rank_loss(leaf, tokens, pp_ring)
        names = pipeline_leaves(leaf_names)
        grads = [_leaf_at(leaf, n).grad for n in names]
        grads = [torch.zeros_like(_leaf_at(leaf, n)) if g is None else g
                 for n, g in zip(names, grads)]   # a leaf this stage never
        shared = [g for n, g in zip(names, grads) if n[0] != "layers"]
        passes = [(grads, axis, avg) for axis, avg in reduce_over] + [
            (shared, pp_axis, False)]
        for group, axis, average in passes:
            if mesh_lib.mesh_axis_size(mesh, axis) > 1:
                reduced = mpi_ops.grouped_allreduce(
                    group, average=average, axis_name=mesh.group(axis))
                for g, r in zip(group, reduced):
                    g.copy_(r)
        for n, g in zip(names, grads):
            p = _leaf_at(pparams, n)
            p.grad = _leaf_at(shardings, n).wrap(g, p.shape)
        opt_state.step()
        value = last_stage_value(
            torch.zeros((), device=grads[0].device) if loss is None
            else loss.float(), pp_ring)
        for axis, average in reduce_over:
            if mesh_lib.mesh_axis_size(mesh, axis) > 1:
                value = mpi_ops.grouped_allreduce(
                    [value], average=average,
                    axis_name=mesh.group(axis))[0]
        return pparams, opt_state, value

    return step, shardings, batch_sharding
