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
  * ``SGD`` is ``optax.sgd`` with momentum (the vision benchmarks'
    optimizer), in optax's order of operations.
  * ``allreduce_gradients`` (through the eager core, one grouped
    submission) and ``distributed_grad``, ``broadcast_parameters``,
    ``broadcast_optimizer_state`` and ``broadcast_object``.

Parameters placed on a mesh (DTensors, ``trainer.place``) are updated on
this rank's shard: every optimizer works on ``local`` views of the
parameter, its gradient and its state (which ``init_state`` places like
the parameter), so an update costs no communication; a
``DistributedOptimizer`` over such parameters averages their gradients
over the mesh's dp axis only.
"""

import collections
import weakref

import torch

from . import mpi_ops
from .common import state as state_mod
from .ops import fusion
from .ops.compression import Compression
from .parallel.tensor_parallel import local


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

    @staticmethod
    def state_keys(group):
        """(state entries shaped and placed like the parameter, the
        others)."""
        return ("mu", "nu"), ("step",)

    @torch.no_grad()
    def init_state(self, p, group):
        """Zero moments for ``p``, placed like it (a DTensor's shard)."""
        state = self.state[p]
        state["step"] = 0
        state["mu"] = torch.zeros_like(p, dtype=group["mu_dtype"] or p.dtype)
        state["nu"] = torch.zeros_like(p)

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
                    self.init_state(p, group)
                state["step"] += 1
                g, mu_dtype = local(p.grad), state["mu"].dtype
                # b1 in mu's dtype times mu, in mu's dtype; the sum with the
                # fp32 gradient term is fp32 (the uncast new mu)
                mu_old, nu_old, p = (local(state["mu"]), local(state["nu"]),
                                     local(p))
                mu = (1 - b1) * g + mu_old * torch.tensor(b1, dtype=mu_dtype)
                nu = (1 - b2) * (g * g) + b2 * nu_old
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
                mu_old.copy_(mu)   # rounded to mu_dtype
                nu_old.copy_(nu)
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


class SGD(torch.optim.Optimizer):
    """``optax.sgd(lr, momentum)``: heavy-ball momentum with no dampening
    and no Nesterov term,

        t = g + momentum·t            p ← p + (−lr)·t

    the trace starting at zero, in the parameter's dtype. Without momentum
    the update is ``p ← p + (−lr)·g``. Parameters without a gradient are
    left alone."""

    def __init__(self, params, lr, momentum=None):
        super().__init__(params, dict(lr=lr, momentum=momentum))

    @staticmethod
    def state_keys(group):
        """(state entries shaped and placed like the parameter, the
        others): the trace, with momentum."""
        return ("trace",) if group["momentum"] else (), ()

    @torch.no_grad()
    def init_state(self, p, group):
        """The zero momentum trace of ``p``, placed like it."""
        if group["momentum"]:
            self.state[p]["trace"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            momentum = group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                t = local(p.grad)
                if momentum:
                    state = self.state[p]
                    if not state:
                        self.init_state(p, group)
                    trace = local(state["trace"])
                    t = t + momentum * trace
                    trace.copy_(t)
                local(p).add_(t * -group["lr"])
        return loss


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
        # the hooks hold the optimizer weakly: a parameter keeps its hooks
        # in autograd's C++ state, where the garbage collector cannot see
        # a cycle back to it, so a strong reference would keep a dropped
        # optimizer and its model alive
        hook = _weak_hook(weakref.ref(self))
        for p in params:
            self._hook_handles.append(
                p.register_post_accumulate_grad_hook(hook))

    def _name(self, p):
        return self._names.get(p) or f"grad.{id(p)}"

    def _hook(self, p):
        self._passes[p] += 1
        if self._passes[p] % self.backward_passes_per_step:
            return
        if p.grad is not None and p.grad.is_sparse and \
                self._sparse_as_dense:
            p.grad = p.grad.to_dense()
        b = self._bucket_of[p]
        if b in self._handles or p in self._ready[b]:
            raise ValueError(
                f"Gradient for {self._name(p)} allreduced twice without an "
                f"optimizer step; call synchronize() or step() between "
                f"effective batches.")
        self._ready[b].add(p)
        # a backend that runs to its end when started (the two-level or
        # the ring allreduce, or ranks that are threads) reduces at
        # synchronize(), on the caller's thread, not in autograd's
        if len(self._ready[b]) == len(self._buckets[b]) and \
                mpi_ops.launches_async(self._process_group):
            self._start(b)

    def _start(self, b):
        """Start bucket b's fused allreduce; a parameter without a
        gradient contributes zeros and keeps no gradient. A sparse
        gradient stays out of the fused buffer: ``synchronize`` reduces
        it on the sparse path."""
        dense = [p for p in self._buckets[b]
                 if p.grad is None or not p.grad.is_sparse]
        grads = [local(p.grad) if p.grad is not None
                 else torch.zeros_like(local(p)) for p in dense]
        self._handles[b] = (dense, mpi_ops._grouped_allreduce_async(
            grads, True, self._compression, self._fusion_threshold,
            self._process_group))

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
        # sparse gradients (nn.Embedding(sparse=True)): one grouped values
        # + indices allgather through the eager core, every gather in
        # flight at once (over the process group when it is not every
        # worker), each given back as a sparse COO gradient
        sparse = [p for ps in self._buckets for p in ps
                  if p.grad is not None and p.grad.is_sparse]
        if sparse:
            from .ops import sparse as sparse_mod
            reduced = sparse_mod.grouped_sparse_allreduce(
                [sparse_mod.from_coo(p.grad) for p in sparse],
                average=True, name="hvd.sparse_grads",
                axis_name=self._process_group)
            for p, r in zip(sparse, reduced):
                p.grad = sparse_mod.to_coo(r)
        for b, (dense, started) in self._handles.items():
            for fused, handle in started:
                for i, reduced in zip(fused.indices,
                                      mpi_ops.synchronize(handle)):
                    p = dense[i]
                    if p.grad is not None:
                        local(p.grad).copy_(reduced)
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


def _weak_hook(ref):
    def hook(p):
        opt = ref()
        if opt is not None:
            opt._hook(p)
    return hook


def averages_gradients(optimizer):
    """Whether ``optimizer`` is a ``DistributedOptimizer``, which averages
    the gradients over its process group itself (the mesh's dp axis when
    the parameters are placed on one)."""
    return isinstance(optimizer, _DistributedOptimizer)


def _dp_group(optimizer):
    """The dp axis's process group of the mesh the optimizer's parameters
    are placed on, or None (every worker) for plain parameters."""
    from torch.distributed.tensor import DTensor
    for group in optimizer.param_groups:
        for p in group["params"]:
            if isinstance(p, DTensor):
                names = p.device_mesh.mesh_dim_names or ()
                return p.device_mesh.get_group("dp") if "dp" in names \
                    else None
    return None


def DistributedOptimizer(optimizer, named_parameters=None, compression=None,
                         backward_passes_per_step=1, fusion_threshold=None,
                         process_group=None, sparse_as_dense=False):
    """Wrap a constructed ``torch.optim.Optimizer`` so that gradients are
    averaged across workers during backward (reference
    torch/__init__.py:163-198). The wrapper subclasses the optimizer's own
    class at run time and adopts its state, so step, state and
    param_group semantics are the optimizer's.

    ``compression`` (``Compression.none/fp16/bf16``) and
    ``fusion_threshold`` default to ``HOROVOD_COMPRESSION`` and
    ``HOROVOD_FUSION_THRESHOLD``. ``process_group`` is the workers to
    average over: every worker by default, and the mesh's dp axis when
    the parameters are placed on a mesh (their tp and sp shards are no
    data-parallel replicas); a group object of ``parallel.ring`` (ranks
    that are threads) is taken too. Each bucket's allreduce goes through
    the operation manager (``HOROVOD_HIERARCHICAL_ALLREDUCE``,
    ``HOROVOD_RING_ALLREDUCE``). A sparse COO gradient
    (``nn.Embedding(sparse=True)``) is reduced on the sparse path of
    ``ops/sparse.py`` over the same workers (through the eager core when
    they are every worker) and given back sparse, or densified first
    with ``sparse_as_dense`` (the reference's
    _keras/__init__.py:39-46). Needs ``init()`` first."""
    config = state_mod.global_state().config
    if config is None:
        raise mpi_ops.NotInitializedError()
    methods = {k: v for k, v in _DistributedOptimizer.__dict__.items()
               if k not in ("__dict__", "__weakref__")}
    cls = type(optimizer.__class__.__name__,
               (optimizer.__class__, _DistributedOptimizer), methods)
    wrapped = cls.__new__(cls)
    wrapped.__dict__.update(optimizer.__dict__)
    wrapped._compression = (Compression.from_name(config.compression)
                            if compression is None else compression)
    wrapped._fusion_threshold = (config.fusion_threshold
                                 if fusion_threshold is None
                                 else fusion_threshold)
    wrapped.backward_passes_per_step = backward_passes_per_step
    wrapped._sparse_as_dense = sparse_as_dense
    wrapped._process_group = (_dp_group(optimizer) if process_group is None
                              else process_group)
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
    if mpi_ops.group_size(wrapped._process_group) > 1:
        wrapped._register_hooks()
    return wrapped


def allreduce_gradients(grads, compression=Compression.none, average=True,
                        fusion_threshold=None, axis_name=None,
                        sparse_as_dense=False):
    """Average (or sum) a pytree (a list, a dict, nested) of gradient
    tensors across workers; returns the same structure. Over every
    worker the leaves go to the eager core as ONE grouped submission,
    which the coordinator fuses into buckets of the live
    ``HOROVOD_FUSION_THRESHOLD`` (the JAX package's eager route,
    ``horovod_tpu/optim.py:61-139``); over ``axis_name`` they take the
    direct route, one fused collective per bucket of
    ``fusion_threshold``.

    ``IndexedSlices`` leaves, and sparse COO tensors (each given back in
    its own form), take the sparse values + indices allgather path
    (``ops/sparse.py``), all in flight at once, unless
    ``sparse_as_dense``, which densifies them first."""
    from torch.utils import _pytree as pytree
    from .ops import sparse as sparse_mod

    def is_leaf(x):
        return sparse_mod.is_indexed_slices(x)
    leaves, spec = pytree.tree_flatten(grads, is_leaf=is_leaf)
    kinds = ["coo" if sparse_mod.is_sparse_coo(l) else
             "slices" if sparse_mod.is_indexed_slices(l) else None
             for l in leaves]
    if sparse_as_dense:
        leaves = [l.to_dense() if k == "coo" else
                  sparse_mod.to_dense(l) if k == "slices" else l
                  for l, k in zip(leaves, kinds)]
        kinds = [None] * len(leaves)
    dense = [l for l, k in zip(leaves, kinds) if k is None]
    dense_out = iter(mpi_ops.grouped_allreduce(
        dense, average, compression, fusion_threshold, axis_name)
        if dense else [])
    sparse = [sparse_mod.from_coo(l) if k == "coo" else l
              for l, k in zip(leaves, kinds) if k is not None]
    sparse_out = iter(sparse_mod.grouped_sparse_allreduce(
        sparse, average=average, name="hvd.sparse_grads",
        axis_name=axis_name) if sparse else [])
    out = []
    for l, k in zip(leaves, kinds):
        if k is None:
            out.append(next(dense_out))
        else:
            s = next(sparse_out)
            out.append(sparse_mod.to_coo(s) if k == "coo" else s)
    return pytree.tree_unflatten(out, spec)


def distributed_grad(fun, argnums=0, compression=Compression.none,
                     average=True, has_aux=False, fusion_threshold=None,
                     axis_name=None):
    """``torch.func.grad`` with cross-worker gradient averaging — the port
    of the JAX package's ``distributed_grad`` (the analogue of
    ``DistributedGradientTape``, tensorflow/__init__.py:242-316): the
    gradients of ``fun`` with respect to its ``argnums`` arguments,
    averaged (or summed) through ``allreduce_gradients``; with
    ``has_aux``, ``(grads, aux)``."""
    grad_fn = torch.func.grad(fun, argnums=argnums, has_aux=has_aux)

    def wrapped(*args, **kwargs):
        out = grad_fn(*args, **kwargs)
        grads, aux = out if has_aux else (out, None)
        grads = allreduce_gradients(
            grads, compression=compression, average=average,
            fusion_threshold=fusion_threshold, axis_name=axis_name)
        return (grads, aux) if has_aux else grads
    return wrapped


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
