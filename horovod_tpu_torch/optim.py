"""Distributed optimizer, AdamW, and state-consistency primitives.

The port of ``horovod_tpu/optim.py`` and of the torch frontend's
optimizer mixin (``horovod_tpu/torch/__init__.py``; reference
horovod/torch/__init__.py:42-348):

  * ``DistributedOptimizer`` wraps a ``torch.optim.Optimizer`` so that
    gradients are averaged across workers during backward: a
    post-accumulate-grad hook on each parameter marks its gradient ready,
    and once every gradient of a fusion bucket (parameters in backward
    order, at most ``HOROVOD_FUSION_THRESHOLD`` bytes) is ready, one async
    allreduce of the fused bucket starts, overlapping the rest of the
    backward. ``step()`` joins them. Hooks are registered only when
    ``size() > 1``, as in the reference.
  * ``AdamW`` is ``optax.adamw`` (the JAX package's training optimizer)
    in PyTorch, with its ``mu_dtype``: ``torch.optim.AdamW`` has no
    low-precision first moment and puts the decay elsewhere.
  * ``allreduce_gradients``, ``broadcast_parameters``,
    ``broadcast_optimizer_state`` and ``broadcast_object``.
"""

import collections

import torch

from . import mpi_ops
from .common import state as state_mod
from .ops import fusion
from .ops.compression import Compression


class AdamW(torch.optim.Optimizer):
    """``optax.adamw`` (0.2.6): Adam with decoupled weight decay.

        mu = (1 - b1)·g + b1·mu          nu = (1 - b2)·g² + b2·nu
        m̂ = mu / (1 - b1^t)              v̂ = nu / (1 - b2^t)
        p ← p - lr·(m̂ / (√(v̂ + eps_root) + eps) + weight_decay·p)

    with optax's defaults, weight decay on every parameter. ``mu_dtype``
    (bfloat16 on the flagship) is the storage dtype of the first moment:
    m̂ is taken from the new mu before it is rounded to it, and b1·mu is
    computed in it (b1 rounded to it too), as JAX computes a weakly typed
    scalar times a bf16 array. The bias corrections are fp32, as optax's
    int32 step count gives them. Parameters without a gradient are left
    alone."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 weight_decay=1e-4, mu_dtype=None):
        defaults = dict(lr=lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                        weight_decay=weight_decay, mu_dtype=mu_dtype)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(
                        p, dtype=group["mu_dtype"] or p.dtype)
                    state["nu"] = torch.zeros_like(p)
                state["step"] += 1
                g, mu_dtype = p.grad, state["mu"].dtype
                # b1 in mu's dtype times mu, in mu's dtype; the sum with the
                # fp32 gradient term is fp32 (the uncast new mu)
                mu = (1 - b1) * g + state["mu"] * torch.tensor(b1,
                                                               dtype=mu_dtype)
                nu = (1 - b2) * (g * g) + b2 * state["nu"]
                # 1 - b^t in fp32 with a float exponent: pow correctly
                # rounded, as optax's jnp.power of the int32 count gives it
                # (repeated products drift by an ulp at t = 3)
                t = torch.tensor(float(state["step"]))
                bc1 = (1 - torch.tensor(b1) ** t).to(mu.dtype)
                bc2 = (1 - torch.tensor(b2) ** t).to(nu.dtype)
                u = (mu / bc1) / (torch.sqrt(nu / bc2 + group["eps_root"]) +
                                  group["eps"])
                u = u + group["weight_decay"] * p
                p.add_(u * -group["lr"])
                state["mu"] = mu.to(mu_dtype)
                state["nu"] = nu
        return loss

    def load_state_dict(self, state_dict):
        # torch.optim casts loaded state to each parameter's dtype; the
        # first moment goes back to mu_dtype (a lossless round trip)
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            for p in group["params"]:
                if group["mu_dtype"] is not None and self.state.get(p):
                    self.state[p]["mu"] = self.state[p]["mu"].to(
                        group["mu_dtype"])


class _DistributedOptimizer:
    """Mixin grafted onto the wrapped optimizer's own class (reference
    torch/__init__.py:42-198). Gradients are allreduced in fusion buckets
    planned over the parameters in reverse order, which is about the
    order backward produces them: the post-accumulate-grad hook marks a
    gradient ready, and a bucket's one fused async allreduce starts when
    its last gradient is. ``backward_passes_per_step`` delays that until
    k local backwards have accumulated."""

    def _register_hooks(self):
        params = [p for group in self.param_groups for p in group["params"]
                  if p.requires_grad]
        params.reverse()
        self._buckets = [[params[i] for i in b.indices] for b in
                         fusion.plan_buckets(params, self._fusion_threshold)]
        self._bucket_of = {p: i for i, ps in enumerate(self._buckets)
                           for p in ps}
        for p in params:
            self._hook_handles.append(
                p.register_post_accumulate_grad_hook(self._hook))

    def _name(self, p):
        return self._names.get(p) or f"grad.{id(p)}"

    def _hook(self, p):
        self._passes[p] += 1
        if self._passes[p] % self.backward_passes_per_step:
            return
        b = self._bucket_of[p]
        if b in self._handles or p in self._ready[b]:
            raise ValueError(
                f"Gradient for {self._name(p)} allreduced twice without an "
                f"optimizer step; call synchronize() or step() between "
                f"effective batches.")
        self._ready[b].add(p)
        if len(self._ready[b]) == len(self._buckets[b]):
            self._start(b)

    def _start(self, b):
        """Start bucket b's fused allreduce; a parameter without a
        gradient contributes zeros and keeps no gradient."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._buckets[b]]
        self._handles[b] = mpi_ops._grouped_allreduce_async(
            grads, True, self._compression, self._fusion_threshold)

    def synchronize(self):
        """Join every gradient allreduce (reference torch/__init__.py:
        132-147). Buckets still waiting for a gradient (a frozen or unused
        parameter, an odd warm-up backward, a leftover micro-batch) are
        flushed now, so step() never applies a gradient that was not
        reduced; the counters reset, so the next effective batch starts a
        fresh window."""
        for b, ps in enumerate(self._buckets):
            if b not in self._handles and any(p.grad is not None
                                              for p in ps):
                self._start(b)
        for b, started in self._handles.items():
            for fused, handle in started:
                for i, reduced in zip(fused.indices,
                                      mpi_ops.synchronize(handle)):
                    p = self._buckets[b][i]
                    if p.grad is not None:
                        p.grad.copy_(reduced)
        self._handles.clear()
        self._ready.clear()
        self._passes.clear()

    def step(self, closure=None):
        self.synchronize()
        return super(self.__class__, self).step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "zero_grad with outstanding gradient allreduces; call "
                "step() or synchronize() first")
        return super(self.__class__, self).zero_grad(*args, **kwargs)


def DistributedOptimizer(optimizer, named_parameters=None, compression=None,
                         backward_passes_per_step=1, fusion_threshold=None):
    """Wrap a constructed ``torch.optim.Optimizer`` so that gradients are
    averaged across workers during backward (reference
    torch/__init__.py:163-198). The wrapper subclasses the optimizer's own
    class at run time and adopts its state, so step, state and
    param_group semantics are the optimizer's.

    ``compression`` (``Compression.none/fp16/bf16``) and
    ``fusion_threshold`` default to ``HOROVOD_COMPRESSION`` and
    ``HOROVOD_FUSION_THRESHOLD``. Needs ``init()`` first."""
    config = state_mod.global_state().config
    if config is None:
        raise mpi_ops.NotInitializedError()
    methods = {k: v for k, v in _DistributedOptimizer.__dict__.items()
               if k not in ("__dict__", "__weakref__")}
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               methods)
    wrapped = cls.__new__(cls)
    wrapped.__dict__.update(optimizer.__dict__)
    wrapped._compression = (Compression.from_name(config.compression)
                            if compression is None else compression)
    wrapped._fusion_threshold = (config.fusion_threshold
                                 if fusion_threshold is None
                                 else fusion_threshold)
    wrapped.backward_passes_per_step = backward_passes_per_step
    named = list(named_parameters) if named_parameters is not None else []
    dups = [n for n, c in collections.Counter(n for n, _ in named).items()
            if c > 1]
    if dups:
        raise ValueError(f"named_parameters has duplicate names: {dups}")
    wrapped._names = {p: n for n, p in named}
    wrapped._handles = {}
    wrapped._ready = collections.defaultdict(set)
    wrapped._passes = collections.defaultdict(int)
    wrapped._hook_handles = []
    wrapped._buckets = []
    if mpi_ops.size() > 1:
        wrapped._register_hooks()
    return wrapped


def allreduce_gradients(grads, compression=Compression.none, average=True,
                        fusion_threshold=None):
    """Average (or sum) a list or dict of gradient tensors across workers,
    one fused collective per bucket; returns the same structure."""
    if isinstance(grads, dict):
        keys = list(grads)
        out = mpi_ops.grouped_allreduce([grads[k] for k in keys], average,
                                        compression, fusion_threshold)
        return dict(zip(keys, out))
    return mpi_ops.grouped_allreduce(grads, average, compression,
                                     fusion_threshold)


def broadcast_parameters(params, root_rank=0):
    """Broadcast a ``state_dict`` or ``named_parameters`` iterable from
    root_rank, in place (reference torch/__init__.py:200-230): every
    broadcast starts, then all are joined."""
    items = sorted(params.items()) if isinstance(params, dict) \
        else list(params)
    handles = [mpi_ops.broadcast_async_(p, root_rank=root_rank,
                                        name=f"bcast.{name}")
               for name, p in items if torch.is_tensor(p)]
    for h in handles:
        mpi_ops.synchronize(h)


def broadcast_optimizer_state(optimizer, root_rank=0):
    """Broadcast optimizer state from root_rank (reference
    torch/__init__.py:232-348) as one pickled object, since the state may
    differ in structure between workers (only the root loaded a
    checkpoint, say)."""
    root = mpi_ops.rank() == root_rank
    state = broadcast_object(optimizer.state_dict() if root else None,
                             root_rank)
    if not root:
        optimizer.load_state_dict(state)


def broadcast_object(obj, root_rank=0):
    """Broadcast an arbitrary picklable object from root_rank (epoch
    counters on resume, say)."""
    return mpi_ops.broadcast_object(obj, root_rank)
