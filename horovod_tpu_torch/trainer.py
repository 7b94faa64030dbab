"""Train steps and the loss, port of ``horovod_tpu/trainer.py``.

PyTorch runs eagerly, so a train step is a Python function over a model
that owns its parameters and an optimizer that owns its state: zero the
gradients, run the loss forward and backward, step. With a
``DistributedOptimizer`` the gradients are averaged across workers
during the backward, which is what the JAX package's data-parallel step
does inside one compiled program.

The GSPMD step (``make_gspmd_step``, ``make_gspmd_multi_step``) takes a
model placed on a mesh (``place``: its parameters DTensors by
PartitionSpec, e.g. ``models.transformer.param_specs``) and a batch
placed by ``batch_spec``, and writes out the collectives the JAX
package's XLA inserts for dp, tp and sp.

The eager step (``make_eager_step``, ``build_eager_lm_step``,
``build_eager_image_step``) averages the gradients through the eager
core between the backward and the update, the JAX package's
``--eager-allreduce`` recipe.

``Checkpointer`` is the train loop's checkpoint contract (periodic async
saves, auto-resume, preemption-safe exit with ``PREEMPTED_EXIT_CODE``).

``instrument_step`` wraps a step with its telemetry: step time, tokens/s,
MFU against the card's ``costmodel.chip_spec``, the allocator peak, the
compile tracker, the history and alert ticks and, every Nth step, a
``torch.profiler`` capture attributed by op class
(``utils/profiling.py``).
"""

import functools
import signal
import time

import torch

from . import mpi_ops, optim
from .common.config import env_bool, env_int
from .common.exceptions import PREEMPTED_EXIT_CODE  # noqa: F401
from .utils import alerts as hvd_alerts
from .utils import checkpoint as hvd_checkpoint
from .utils import history as hvd_history
from .utils import memory as hvd_memory
from .utils import metrics as hvd_metrics
from .utils import tracing as hvd_tracing
from .ops.compression import Compression
from .parallel import mesh as mesh_lib
from .parallel import tensor_parallel as tpl
from .parallel.mesh import P


def _step_device(device):
    if device is not None:
        return torch.device(device)
    from .common import state
    return state.device() if state.is_initialized() else torch.device("cpu")


def instrument_step(step_fn, tokens_per_step=None, name="train",
                    flops_per_token=None, attrib_every=None, spec=None,
                    device=None):
    """Wrap a train step with step-path telemetry (the JAX package's
    ``trainer.instrument_step``): an ``hvd_step_seconds`` histogram, an
    ``hvd_steps_total`` counter and, given ``tokens_per_step``, an
    ``hvd_tokens_per_second`` gauge, all labeled ``loop=name``.

    The step's end is stamped after ``torch.cuda.synchronize(device)``
    (``device``: the worker's by default): without it the host clock
    would time the launches, not the step. So it is a per-step host sync,
    right for a loop that reads the loss every step. With metrics off
    (``HVD_METRICS=0``) the step is returned as it is.

      * ``flops_per_token`` with ``tokens_per_step`` publishes
        ``hvd_mfu`` against the card's peak (``spec``, a
        ``costmodel.ChipSpec``, found from the card when omitted); no
        gauge on the CPU.
      * ``attrib_every=N`` (default ``HOROVOD_PERF_ATTRIB_EVERY``, 0 =
        off) wraps every Nth step, never step 1, in a ``torch.profiler``
        capture and publishes ``hvd_step_device_busy_frac``, per-class
        ``hvd_step_breakdown_ms`` and ``_drift`` and the exposed/hidden
        comm gauges (``profiling.profile_decomposition``). The wrapper
        keeps the last decomposition and the profiler it came from
        (``last_decomposition``, ``last_profile``); the decomposition
        also counts the capture's launch calls and those the profiler
        kept no device record for (``launch_calls``,
        ``unrecorded_launches``: work missing from the breakdown). A
        capture that fails emits ``perf_attrib_error`` and never breaks
        the step.
      * The memory plane (``HVD_MEM``): each call reports its
        abstract-shape key to the compile tracker at ``train:<name>``,
        and ``hvd_step_peak_hbm_bytes`` holds the allocator peak of the
        step (reset at its start); no gauge on the CPU.
      * The history writer and the alert manager tick every step.
    """
    reg = hvd_metrics.get_registry()
    if not reg.enabled:
        return step_fn
    dev = _step_device(device)
    on_card = dev.type == "cuda"
    step_s = reg.histogram(
        "hvd_step_seconds", "Wall time of one training step (synced).",
        labels=("loop",))
    steps = reg.counter(
        "hvd_steps_total", "Training steps executed.", labels=("loop",))
    tps = reg.gauge(
        "hvd_tokens_per_second",
        "Throughput of the most recent step (tokens_per_step / step "
        "seconds).", labels=("loop",))
    if attrib_every is None:
        attrib_every = env_int("PERF_ATTRIB_EVERY", 0)
    flops_per_step = ((flops_per_token or 0) * (tokens_per_step or 0)) or None
    if flops_per_step and spec is None and on_card:
        from .utils import costmodel
        spec = costmodel.chip_spec(dev)
    if spec is not None and spec.kind == "cpu":
        spec = None  # the stand-in peak would make MFU noise
    mfu = reg.gauge(
        "hvd_mfu", "Model FLOPs utilization of the most recent step "
        "(flops_per_step / peak / step seconds).",
        labels=("loop",)) if flops_per_step and spec else None
    peak_hbm = reg.gauge(
        "hvd_step_peak_hbm_bytes",
        "Peak allocated device bytes on this card in the most recent "
        "step (memory plane; absent on the CPU).",
        labels=("loop",)) if hvd_memory.enabled() \
        and hvd_memory.step_peak_bytes(dev) is not None else None
    if attrib_every:
        busy = reg.gauge(
            "hvd_step_device_busy_frac",
            "Device-busy fraction of the last attributed step "
            "(device-op time / wall).", labels=("loop",))
        breakdown = reg.gauge(
            "hvd_step_breakdown_ms",
            "Per-op-class device ms of the last attributed step.",
            labels=("loop", "op_class"))
        drift = reg.gauge(
            "hvd_step_breakdown_drift",
            "Per-op-class ms drift of the last attributed step vs its "
            "running mean (relative; +0.1 = 10% slower than usual).",
            labels=("loop", "op_class"))
        exposed = reg.gauge(
            "hvd_step_exposed_comm_ms",
            "Collective ms NOT hidden under compute in the last "
            "attributed step.", labels=("loop",))
        hidden = reg.gauge(
            "hvd_step_hidden_comm_ms",
            "Collective ms overlapped with compute in the last "
            "attributed step.", labels=("loop",))
        ovl_frac = reg.gauge(
            "hvd_step_overlap_frac",
            "hidden / (hidden + exposed) collective ms of the last "
            "attributed step.", labels=("loop",))
    ema = {}  # op_class -> running-mean ms, for the drift gauge
    counter = [0]

    def _attribute(prof, dt):
        from .utils import profiling
        dec = profiling.profile_decomposition(
            profiling.summarize_profile(prof), wall_ms=dt * 1e3, steps=1)
        launched, lost = profiling.unrecorded_launches(prof)
        dec["launch_calls"], dec["unrecorded_launches"] = launched, len(lost)
        wrapped.last_decomposition = dec
        if dec.get("device_busy_frac") is not None:
            busy.labels(loop=name).set(dec["device_busy_frac"])
        for c in dec["classes"]:
            cls, ms = c["class"], c["ms_per_step"]
            breakdown.labels(loop=name, op_class=cls).set(ms)
            prev = ema.get(cls)
            if prev:
                drift.labels(loop=name, op_class=cls).set(
                    round(ms / prev - 1.0, 4))
            ema[cls] = ms if prev is None else 0.8 * prev + 0.2 * ms
        ov = dec.get("overlap")
        if ov:
            exposed.labels(loop=name).set(ov["exposed_comm_ms"])
            hidden.labels(loop=name).set(ov["hidden_comm_ms"])
            if ov["overlap_frac"] is not None:
                ovl_frac.labels(loop=name).set(ov["overlap_frac"])

    tracer = hvd_tracing.get_tracer()

    def _start_capture():
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if on_card:
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    @functools.wraps(step_fn)
    def wrapped(*args, **kwargs):
        counter[0] += 1
        capture = attrib_every and counter[0] % attrib_every == 0 \
            and counter[0] > 1
        prof = None
        if capture:
            try:
                prof = _start_capture()
            except Exception as exc:  # noqa: BLE001 — never break the step
                reg.event("perf_attrib_error", phase="start",
                          error=type(exc).__name__)
                prof = None
        if hvd_memory.enabled():
            hvd_memory.get_tracker().observe(f"train:{name}",
                                             (args, kwargs))
            if peak_hbm is not None:
                hvd_memory.reset_step_peak(dev)
        t0 = time.perf_counter()
        # the step span: the root every per-tensor span of this step
        # hangs under in the postmortem timeline
        with tracer.span(hvd_tracing.STEP, tensor=name) as span:
            out = step_fn(*args, **kwargs)
            if on_card:
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            span.annotate(seconds=dt)
        if prof is not None:
            try:
                prof.stop()
                wrapped.last_profile = prof
                _attribute(prof, dt)
            except Exception as exc:  # noqa: BLE001 — never break the step
                reg.event("perf_attrib_error", phase="attribute",
                          error=type(exc).__name__)
        step_s.labels(loop=name).observe(dt)
        steps.labels(loop=name).inc()
        if tokens_per_step and dt > 0:
            tps.labels(loop=name).set(tokens_per_step / dt)
        if mfu is not None and dt > 0:
            mfu.labels(loop=name).set(
                flops_per_step / (spec.peak_flops * dt))
        if peak_hbm is not None and hvd_memory.enabled():
            pb = hvd_memory.step_peak_bytes(dev)
            if pb is not None:
                peak_hbm.labels(loop=name).set(pb)
        hvd_history.poke()
        hvd_alerts.tick()
        return out

    wrapped.last_decomposition = None
    wrapped.last_profile = None
    return wrapped


def softmax_cross_entropy(logits, labels, weights=None, norm=None,
                          tp=None):
    """Mean token-level cross entropy (labels are int ids). ``weights``
    (same shape as labels) masks positions out of the mean; ``norm``
    replaces the weights' sum as its denominator (a shard of a sequence
    divides by the whole sequence's).

    As the JAX package computes it: ``nll = lse(logits) - logits[label]``
    with the row max detached (it cancels in the gradient), ``logits - max``
    in the logits' dtype and the sum of exponentials in fp32, so bf16
    logits round only where they are stored.

    ``tp``: the logits are this rank's shard of a vocab split evenly over
    that tensor-parallel group (rank r holding ids [r·V/tp, (r+1)·V/tp));
    the max, the sum of exponentials and the label's logit are reduced
    over its ranks, and every rank gets the same loss."""
    m = logits.amax(dim=-1, keepdim=True).detach()
    if tp is not None:
        m = tpl.all_reduce_max(m, tp)
    sumexp = torch.exp((logits - m).float()).sum(dim=-1)
    labels = labels[..., None].long()
    if tp is None:
        tgt = torch.gather(logits, -1, labels)[..., 0].float()
    else:
        sumexp = tpl.reduce_from(sumexp, tp)
        v = logits.shape[-1]
        ids = labels - tp.rank * v
        mine = ((ids >= 0) & (ids < v))[..., 0]
        tgt = torch.gather(logits, -1, ids.clamp(0, v - 1))[..., 0].float()
        tgt = tpl.reduce_from(tgt * mine.to(tgt.dtype), tp)
    lse = m[..., 0].float() + torch.log(sumexp)
    nll = lse - tgt
    if weights is None:
        return nll.mean()
    weights = weights.to(nll.dtype)
    return (nll * weights).sum() / (weights.sum() if norm is None else norm)


def make_train_step(model, optimizer, loss_fn):
    """``step(batch) -> loss``: one optimizer update of ``model`` on
    ``loss_fn(model, batch)``; the returned loss is detached and stays on
    the device (reading it is the caller's sync point)."""

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step


def make_multi_step(model, optimizer, loss_fn):
    """``multi_step(batches) -> loss``: one update per entry of a stacked
    ``[n_steps, ...]`` batch, returning the last step's loss — the eager
    counterpart of ``make_gspmd_multi_step``, as a host loop."""
    step = make_train_step(model, optimizer, loss_fn)

    def multi_step(batches):
        loss = None
        for batch in batches:
            loss = step(batch)
        return loss
    return multi_step


def make_data_parallel_step(model, optimizer, loss_fn, steps_per_call=1):
    """``step(batch) -> loss``: the port of the JAX package's
    ``make_data_parallel_step``. Each worker passes its own shard of the
    batch; ``optimizer`` is a ``DistributedOptimizer``, which averages the
    gradients across workers during the backward (with its compression
    and fusion threshold) before it applies them. ``steps_per_call``
    updates run on the SAME batch per call, the synthetic-benchmark loop.
    Returns the last update's loss averaged over the workers, detached and
    on the device."""
    one = make_train_step(model, optimizer, loss_fn)

    def step(batch):
        for _ in range(steps_per_call):
            loss = one(batch)
        if mpi_ops.size() > 1:
            loss = mpi_ops.allreduce(loss, average=True)
        return loss
    return step


# ---------------------------------------------------------------------------
# the GSPMD step: parameters and batch placed on a mesh by PartitionSpecs


def place(tree, mesh, spec_tree):
    """Place ``tree`` on the mesh (``mesh=None``: the process-global mesh)
    by the PartitionSpecs of ``spec_tree``: a module's parameters become
    DTensors holding this rank's shard (in place; the module is returned),
    a dict of whole tensors a dict of DTensors. Every rank passes the same
    whole values (the same seed); no communication."""
    if isinstance(tree, torch.nn.Module):
        shardings = mesh_lib.tree_shardings(spec_tree, mesh)
        for name, p in list(tree.named_parameters()):
            owner, _, attr = name.rpartition(".")
            module = tree.get_submodule(owner) if owner else tree
            setattr(module, attr, torch.nn.Parameter(
                shardings[name].place(p), requires_grad=p.requires_grad))
        return tree
    return mesh_lib.device_put_tree(tree, spec_tree, mesh)


def replicate(tree, mesh=None):
    """``tree`` placed fully replicated (spec ``P()``) on the mesh."""
    if isinstance(tree, torch.nn.Module):
        return place(tree, mesh, {n: P() for n, _ in tree.named_parameters()})
    return mesh_lib.replicate_tree(tree, mesh)


def _param_names(tx, params):
    names = {p: n for n, p in params.named_parameters()}
    return [(names[p], p, group) for group in tx.param_groups
            for p in group["params"]]


def opt_state_specs(tx, params, param_spec_tree):
    """PartitionSpec of each optimizer state entry, by parameter name:
    the entries shaped like the parameter (AdamW's mu and nu, SGD's
    trace) take its spec, the others (step counts) are replicated."""
    out = {}
    for name, _, group in _param_names(tx, params):
        like, other = tx.state_keys(group)
        out[name] = {**{k: param_spec_tree[name] for k in like},
                     **{k: P() for k in other}}
    return out


def init_opt_state(tx, params):
    """The optimizer's state for every parameter of ``params``, created
    now and placed as ``opt_state_specs`` says: each entry shaped like a
    parameter on that parameter's placement (place the parameters first),
    step counts replicated. Returns ``tx``. Unlike the JAX package's, it
    takes no mesh or spec tree: each entry takes its parameter's own
    placement."""
    for _, p, group in _param_names(tx, params):
        tx.init_state(p, group)
    return tx


def reduce_gradients(model, mesh, dp=True):
    """What the JAX package's XLA inserts for a GSPMD step's gradients:
    the sum over the 'sp' axis (each shard of the sequence contributes a
    part of every parameter's gradient) and the mean over 'dp' (skipped
    with ``dp=False``, when a ``DistributedOptimizer`` averages over dp
    itself). The tp shards' gradients are whole already: the layers'
    collectives made them so."""
    grads = [tpl.local(p.grad) for p in model.parameters()
             if p.grad is not None]
    for axis, average, on in (("sp", False, True), ("dp", True, dp)):
        if on and mesh_lib.mesh_axis_size(mesh, axis) > 1:
            reduced = mpi_ops.grouped_allreduce(
                grads, average=average, axis_name=mesh.group(axis))
            for g, r in zip(grads, reduced):
                g.copy_(r)


def _batch_on(batch, sharding):
    from torch.distributed.tensor import DTensor
    return batch if isinstance(batch, DTensor) else sharding.place(batch)


def _global_loss(loss, mesh):
    """The step's loss as the JAX package returns it, the mean over the
    whole batch: this rank's part summed over 'sp', averaged over 'dp'."""
    loss = loss.detach().float()
    for axis, average in (("sp", False), ("dp", True)):
        if mesh_lib.mesh_axis_size(mesh, axis) > 1:
            loss = mpi_ops.grouped_allreduce(
                [loss], average=average, axis_name=mesh.group(axis))[0]
    return loss


def _gspmd_shardings(mesh, param_spec_tree, batch_spec):
    mesh = mesh_lib.global_mesh() if mesh is None else mesh
    return (mesh, mesh_lib.tree_shardings(param_spec_tree, mesh),
            mesh_lib.named_sharding(batch_spec, mesh))


def make_gspmd_step(loss_fn, tx, mesh, param_spec_tree, batch_spec):
    """The sharding-annotated train step, port of the JAX package's
    ``make_gspmd_step``: returns ``(step, param_shardings,
    batch_sharding)``, where ``step(params, opt_state, batch) -> (params,
    opt_state, loss)`` takes the model placed by ``param_spec_tree``
    (``place``), its optimizer and the whole batch (every rank the same;
    placed by ``batch_spec`` here) or a batch already placed, and makes
    one update. ``mesh=None`` targets the process-global mesh.

    PyTorch runs eagerly, so the collectives XLA would insert are written
    out: the layers' tp collectives (``models.transformer``), the
    sequence's ring, and ``reduce_gradients`` (the sp sum and the dp
    mean; a ``DistributedOptimizer`` ``tx`` averages over dp itself). The
    returned loss is the mean over the whole batch, the same on every
    rank. Unlike the JAX package's, it takes no ``donate`` or ``params``:
    updates are in place, and the placement is the caller's (``place``)."""
    mesh, param_shardings, batch_sharding = _gspmd_shardings(
        mesh, param_spec_tree, batch_spec)
    dp_by_tx = optim.averages_gradients(tx)

    def step(params, opt_state, batch):
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, _batch_on(batch, batch_sharding))
        loss.backward()
        reduce_gradients(params, mesh, dp=not dp_by_tx)
        opt_state.step()
        return params, opt_state, _global_loss(loss, mesh)
    return step, param_shardings, batch_sharding


def make_gspmd_multi_step(loss_fn, tx, mesh, param_spec_tree, batch_spec):
    """Like ``make_gspmd_step``, but the step takes a STACKED batch
    ``[n_steps, ...]`` and makes one update per entry, returning the last
    step's loss. The stacked batch is placed as ``P(None, *batch_spec)``:
    the leading step axis is never split across ranks. (The JAX package
    scans on the device; the port loops on the host.)"""
    one, param_shardings, _ = make_gspmd_step(
        loss_fn, tx, mesh, param_spec_tree, batch_spec)
    mesh, _, batch_sharding = _gspmd_shardings(
        mesh, param_spec_tree, P(None, *batch_spec))
    step_sharding = mesh_lib.named_sharding(batch_spec, mesh)

    def multi_step(params, opt_state, batches):
        batches = _batch_on(batches, batch_sharding)
        local = batches.to_local()
        loss = None
        for i in range(local.shape[0]):
            one_batch = step_sharding.wrap(local[i], batches.shape[1:])
            params, opt_state, loss = one(params, opt_state, one_batch)
        return params, opt_state, loss
    return multi_step, param_shardings, batch_sharding


# ---------------------------------------------------------------------------
# the eager data-parallel step: gradients averaged by the eager core
# (ops/eager.py) between the backward and the update, the port of the JAX
# package's _eager_step (examples/bench_common.py:288-366)


def make_eager_step(model, optimizer, loss_fn, compression=None):
    """``step(batch) -> loss``: this rank's forward and backward on its own
    ``batch``, every gradient allreduced through the eager core by
    ``optim.reduce_on_core`` (ONE grouped submission, or under
    HOROVOD_OVERLAP_EAGER the overlap plane's reverse-order enqueue with
    ready buckets drained as they fill), then ``optimizer``'s step on the
    averaged gradients.
    ``optimizer`` is a plain one (not a ``DistributedOptimizer``, which
    would average a second time). The gradients keep their names from
    step to step (``hvd.eager_grads.{i}``), so that a quantized wire
    carries its error feedback. A parameter without a gradient
    contributes zeros and keeps none. Returns this rank's loss, detached
    and on the device."""
    params = [p for p in model.parameters() if p.requires_grad]
    if optim.averages_gradients(optimizer):
        raise ValueError("make_eager_step averages the gradients itself; "
                         "pass the optimizer a DistributedOptimizer wraps")
    compression = compression or Compression.none

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        reduced = optim.reduce_on_core(grads, compression=compression,
                                       name="hvd.eager_grads")
        for p, r in zip(params, reduced):
            if p.grad is not None:
                p.grad.copy_(r)
        optimizer.step()
        return loss.detach()
    return step


def build_eager_lm_step(cfg, batch_per_shard, seq, device, lr=3e-4,
                        inner=1, seed=0):
    """The transformer LM's eager step (``build_eager_lm_step`` of the JAX
    package's bench harness): the model from ``seed``, ``AdamW(lr,
    mu_dtype=bfloat16)``, and this rank's tokens ``[inner,
    batch_per_shard, seq]`` — rows ``[rank · b, (rank + 1) · b)`` of
    ``numpy.random.RandomState(0)``'s ``[inner, world · b, seq]``, as the
    JAX harness's stacked ``[world, b, seq]`` row ``rank``. Returns
    ``(step, model, optimizer, toks)``; ``step(toks[i]) -> loss``."""
    import numpy as np
    from .models import transformer as tr
    model = tr.init_params(cfg, torch.Generator().manual_seed(seed),
                           device=device, train=True)
    opt = optim.AdamW(model.parameters(), lr, mu_dtype=torch.bfloat16)
    step = make_eager_step(model, opt, tr.lm_loss_fn(model))
    n, r = mpi_ops.size(), mpi_ops.rank()
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (inner, n * batch_per_shard, seq),
                       dtype=np.int64)
    toks = toks[:, r * batch_per_shard:(r + 1) * batch_per_shard]
    return step, model, opt, torch.from_numpy(toks.copy()).to(device)


def build_eager_image_step(model_name, batch_per_shard, image_size, device,
                           compression=None, norm_impl="flax", seed=0):
    """An image model's eager step (``build_eager_image_step`` of the JAX
    package's bench harness): a zoo model of 1000 classes at bf16 with
    seeded fp32 master weights, ``SGD(0.01, momentum=0.9)``, zero images and labels
    of this rank's batch. Returns ``(step, model, optimizer, (images,
    labels))``; ``step((images, labels)) -> loss``."""
    from . import models
    kwargs = {}
    if model_name.startswith("vgg"):
        kwargs = {"dropout_rate": 0.0, "image_size": image_size}
    elif model_name.startswith("resnet"):
        kwargs = {"norm_impl": norm_impl}
    model = models.build(model_name, num_classes=1000, dtype=torch.bfloat16,
                         device=device,
                         generator=torch.Generator().manual_seed(seed),
                         **kwargs)
    model.train()
    images = torch.zeros((batch_per_shard, 3, image_size, image_size),
                         dtype=torch.bfloat16, device=device).to(
        memory_format=torch.channels_last)
    labels = torch.zeros((batch_per_shard,), dtype=torch.int64,
                         device=device)
    opt = optim.SGD(model.parameters(), 0.01, momentum=0.9)

    def loss_fn(model, batch):
        imgs, lbls = batch
        return softmax_cross_entropy(model(imgs), lbls)

    step = make_eager_step(model, opt, loss_fn, compression=compression)
    return step, model, opt, (images, labels)


# ---------------------------------------------------------------------------
# the checkpoint contract of a train loop


class Checkpointer:
    """The train loop's checkpoint contract: periodic async saves,
    auto-resume and preemption-safe exit, in three calls (the port of
    ``horovod_tpu/trainer.py``'s)::

        ckpt = trainer.Checkpointer(args.checkpoint_dir,
                                    every=args.checkpoint_every,
                                    rank=rank, world_size=world)
        state, start_step, extra = ckpt.resume(like=state_tree())
        for i in range(start_step, steps):
            ...one optimizer step...
            if ckpt.step_end(i + 1, state_tree(), extra={"data_pos": i + 1}):
                sys.exit(trainer.PREEMPTED_EXIT_CODE)
        ckpt.close()

    ``step_end`` saves every ``every`` steps through the async
    ``CheckpointManager`` (the loop blocks only for the host snapshot)
    and consumes preemption: on SIGTERM/SIGINT the in-flight step
    finishes, then a BLOCKING emergency save of the state it was handed
    commits and it returns True; the caller exits with
    ``PREEMPTED_EXIT_CODE`` (45), which the elastic supervisor takes as
    a restart on the same slots. ``extra`` carries what resume needs
    beyond the tree (the data position) into the manifest.

    Several ranks must stop at the same step, since each writes its shard
    and rank 0 commits: ``agree(flag) -> bool`` (e.g. an allreduce of the
    flag over the workers) makes the decision collective at every step
    end. ``publish=True`` (default HVD_FLEET_PUBLISH) hangs a
    ``fleet.WeightPublisher`` on rank 0's commit hook. Signal handlers
    chain to a previously installed callable handler and are installed
    from the main thread only and take no lock (they set a flag);
    ``preemption=False`` or HVD_CKPT_PREEMPTION=0 turns them off."""

    def __init__(self, directory, every=None, keep=None, async_save=None,
                 preemption=None, rank=0, world_size=1, manager=None,
                 verbose=False, layout=None, agree=None, publish=None):
        self.every = env_int("CKPT_EVERY", 0) if every is None else int(every)
        self.manager = manager or hvd_checkpoint.CheckpointManager(
            directory, rank=rank, world_size=world_size, keep=keep,
            async_save=async_save, layout=layout)
        # fleet plane: publish every commit as a weight generation that
        # serving replicas hot-swap to. The publisher continues its
        # generation counter from the existing pointer, so a preempted
        # and restarted trainer keeps publishing monotonic ids. Rank 0
        # only: its writer commits.
        if publish is None:
            publish = env_bool("FLEET_PUBLISH", False)
        self.publisher = None
        if publish and self.manager.rank == 0:
            from .fleet import WeightPublisher
            self.publisher = WeightPublisher(self.manager.directory)
            self.manager.on_commit = self.publisher.publish
        self.verbose = verbose
        self._agree = agree
        # the signal number that asked for preemption: a plain attribute,
        # since a signal handler must take no lock (it runs on the main
        # thread, maybe inside a critical section of the metrics plane)
        self._preempt_signum = None
        self._preempt_recorded = False
        self._signals = []
        if preemption is None:
            preemption = env_bool("CKPT_PREEMPTION", True)
        if preemption:
            self._install_handlers()

    def _install_handlers(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev = signal.getsignal(sig)

                def handler(signum, frame, _prev=prev):
                    # only the flag: ``step_end`` records the event
                    self._preempt_signum = int(signum)
                    # chain CUSTOM handlers only (the tracing plane's
                    # flight dump): SIG_DFL, SIG_IGN and the default
                    # KeyboardInterrupt raiser would abort the in-flight
                    # step this handler promises to finish
                    if callable(_prev) and _prev not in (
                            signal.SIG_IGN, signal.SIG_DFL,
                            signal.default_int_handler):
                        _prev(signum, frame)

                signal.signal(sig, handler)
                self._signals.append(sig)
            except ValueError:
                return  # not the main thread: run without handlers

    @property
    def preempted(self):
        return self._preempt_signum is not None

    def resume(self, like=None, mesh=None, spec_tree=None):
        """(state, start_step, extra): the newest committed checkpoint when
        one exists, else ``(like, 0, {})``. ``spec_tree`` places the
        restored leaves on the mesh (``restore_on_mesh``)."""
        if not self.manager.exists():
            return like, 0, {}
        tree, step, extra = self.manager.restore(like=like, mesh=mesh,
                                                 spec_tree=spec_tree)
        if self.verbose:
            print(f"checkpoint: resumed step {step} from "
                  f"{self.manager.directory}", flush=True)
        return tree, step, extra

    def step_end(self, step, state, extra=None):
        """Call after every completed optimizer step. Returns True when the
        process should exit with PREEMPTED_EXIT_CODE (an emergency durable
        checkpoint of ``state`` has already committed). ``state`` may be a
        callable returning the tree, called only when this step saves
        (a state gathered from shards costs collectives)."""
        preempt = self.preempted
        if preempt and not self._preempt_recorded:
            self._preempt_recorded = True
            hvd_metrics.get_registry().event(
                "ckpt_preempt", signum=self._preempt_signum)
        if self._agree is not None:
            preempt = bool(self._agree(preempt))
        if callable(state) and (preempt or (
                self.every and step % self.every == 0)):
            state = state()
        if preempt:
            self.manager.save(state, step, extra=extra, block=True,
                              kind="emergency")
            hvd_metrics.get_registry().event("ckpt_emergency_exit",
                                             step=int(step))
            if self.verbose:
                print(f"checkpoint: preempted — emergency save at step "
                      f"{step} committed, exiting {PREEMPTED_EXIT_CODE}",
                      flush=True)
            self.close()
            return True
        if self.every and step % self.every == 0:
            self.manager.save(state, step, extra=extra)
        return False

    def close(self):
        for sig in self._signals:
            try:
                signal.signal(sig, signal.SIG_DFL)
            except ValueError:
                pass
        self._signals = []
        self.manager.close()
