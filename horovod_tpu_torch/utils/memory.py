"""Memory & compile observability plane, the port of
``horovod_tpu/utils/memory.py``.

It answers three questions:

  * **where did the bytes go**: an :class:`HBMLedger` attributing
    per-card device bytes by component (params, optimizer state,
    gradients, KV-cache, activation estimate), published as
    ``hvd_hbm_bytes{component}`` / ``hvd_hbm_headroom_bytes`` gauges and
    snapshotted into flight dumps;
  * **why did this call recompile**: a :class:`CompileTracker` that
    turns every instrumented call into a hit or a miss of its
    abstract-shape key (a key is what a compiled-program cache would key
    on: every tensor's dtype and shape), plus an EMA recompile-storm
    detector escalating event -> warning -> flight dump (once per site).
    The port compiles no programs per shape, so the tracker is the same
    host-side bookkeeping as the JAX package's: a new key at a site is a
    miss, and a churn of new keys is the leak it names;
  * **did a collective undo a declared parameter sharding**:
    :func:`scan_resharding`. The JAX package scans a compiled step's HLO;
    the port has no HLO: its serving forwards record each collective
    they issue (op, result shape, operand shapes, gathered dim;
    ``serving.decode.ServingWeights.recording``), and the same rule runs
    over those records. A collective is flagged when its result shape
    equals a parameter's full shape while one of its operands has that
    parameter's declared shard shape. A result shape that is also the
    full shape of a parameter declared replicated is ambiguous and stays
    silent: the rule is precision-first.

Attribution is host-side math over tensor metadata and declared specs.
The device probes (``torch.cuda.memory_allocated`` and friends) live in
this module only: :func:`device_memory_stats`, :func:`step_peak_bytes`
and :func:`live_array_bytes`, all None on the CPU.
``python -m horovod_tpu_torch.tools.hvd_mem`` fronts the pre-flight
planner (:func:`plan_memory`: "does this model fit at dp 2, tp 4 on an
H100?" from the costmodel ChipSpec table) and a selftest.
"""

import logging
import math

import torch

from ..common.config import env_bool, env_float, env_int
from ..parallel.mesh import spec_shard_shape
from . import lockdep

log = logging.getLogger("horovod_tpu_torch.memory")

# Ledger component keys, in the order panes render them.
COMPONENTS = ("params", "opt_state", "grads", "kv_cache", "activations",
              "other")

_lock = lockdep.lock("memory._lock", reentrant=True)
_enabled = None  # guarded_by: _lock; cached HVD_MEM switch
_ledger = None   # guarded_by: _lock
_tracker = None  # guarded_by: _lock


def enabled():
    """Master switch (HVD_MEM, default on). Cached; reset() re-reads."""
    global _enabled
    with _lock:
        if _enabled is None:
            _enabled = env_bool("MEM", True)
        return _enabled


def reset(enabled=None):
    """Drop the process ledger/tracker singletons. ``enabled`` forces the
    plane on/off regardless of HVD_MEM; None re-reads the environment on
    next use."""
    global _enabled, _ledger, _tracker
    with _lock:
        _enabled = enabled
        _ledger = None
        _tracker = None


def get_ledger():
    global _ledger
    with _lock:
        if _ledger is None:
            _ledger = HBMLedger()
        return _ledger


def get_tracker():
    global _tracker
    with _lock:
        if _tracker is None:
            _tracker = CompileTracker()
        return _tracker


# ---------------------------------------------------------------------------
# device probes: the only place the port reads the allocator
# ---------------------------------------------------------------------------

def _cuda_device(device=None):
    """``device`` as a CUDA ``torch.device``, or None for the CPU (and for
    None when no card is visible or the worker's device is the CPU)."""
    if device is None:
        from ..common import state
        if state.is_initialized():
            device = state.device()
        elif torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            return None
    device = torch.device(device)
    return device if device.type == "cuda" else None


def device_memory_stats(device=None):
    """The CUDA allocator's view of one card (``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_reserved``, ``bytes_limit``: the JAX
    ``memory_stats()`` keys, from ``torch.cuda.memory_allocated``,
    ``max_memory_allocated``, ``memory_reserved`` and the card's
    ``total_memory``), or None on the CPU."""
    dev = _cuda_device(device)
    if dev is None:
        return None
    return {
        "bytes_in_use": int(torch.cuda.memory_allocated(dev)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
        "bytes_reserved": int(torch.cuda.memory_reserved(dev)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev)
                           .total_memory),
    }


def reset_step_peak(device=None):
    """Start a new peak window (``torch.cuda.reset_peak_memory_stats``):
    ``step_peak_bytes`` then reads the peak of what ran since. A no-op on
    the CPU."""
    dev = _cuda_device(device)
    if dev is not None:
        torch.cuda.reset_peak_memory_stats(dev)


def step_peak_bytes(device=None):
    """Peak allocated device bytes since the last ``reset_step_peak``, or
    None on the CPU: the trainer nulls its ``hvd_step_peak_hbm_bytes``
    gauge there, as the JAX package does off the TPU."""
    stats = device_memory_stats(device)
    if not stats:
        return None
    return stats["peak_bytes_in_use"]


def live_array_bytes(device=None):
    """Bytes of the live tensors on this worker's card (the allocator's
    ``memory_allocated``), or None on the CPU."""
    stats = device_memory_stats(device)
    return stats["bytes_in_use"] if stats else None


# ---------------------------------------------------------------------------
# byte attribution (host-side math, no device traffic)
# ---------------------------------------------------------------------------

def tree_leaves(tree):
    """The tensors of a tree, in order: an ``nn.Module`` gives its
    parameters, an optimizer its state's tensors, a dict its values (keys
    sorted, as the JAX package's tree order), a list or tuple its items;
    None and non-tensor leaves are dropped."""
    out = []

    def walk(x):
        if x is None:
            return
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
        elif isinstance(x, torch.optim.Optimizer):
            for st in x.state.values():
                walk(st)
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(tree)
    return out


def _per_chip_nbytes(leaf):
    """Bytes one card holds for a tensor: its local shard for a DTensor,
    the whole tensor else."""
    local = leaf.to_local() if hasattr(leaf, "to_local") else leaf
    return int(local.numel()) * int(local.element_size())


def tree_per_chip_bytes(tree, spec_tree=None, mesh=None):
    """Per-card bytes of a tree. Without ``spec_tree``, every tensor
    counts what this card holds (a DTensor its shard). With it (a dict
    name -> PartitionSpec beside a dict name -> tensor, or a list of
    specs in ``tree_leaves`` order), each tensor's shape is sharded by
    the spec math on ``mesh`` (a mesh or {axis: size}): the planner's
    path, which also takes tensors on the ``meta`` device."""
    if spec_tree is None:
        return sum(_per_chip_nbytes(t) for t in tree_leaves(tree))
    if isinstance(tree, dict) and isinstance(spec_tree, dict):
        pairs = [(tree[k], spec_tree.get(k)) for k in sorted(tree, key=str)]
    else:
        pairs = list(zip(tree_leaves(tree), spec_tree))
    total = 0
    for leaf, spec in pairs:
        shard = spec_shard_shape(tuple(leaf.shape), spec, mesh)
        total += int(math.prod(shard)) * int(leaf.element_size())
    return total


# ---------------------------------------------------------------------------
# the per-card HBM ledger
# ---------------------------------------------------------------------------

class HBMLedger:
    """Attributes per-card device bytes by component and publishes the
    ``hvd_hbm_bytes{component}`` / ``hvd_hbm_headroom_bytes`` gauges.

    Components are absolute (account() overwrites, it does not
    accumulate): each plane re-states what it holds: params on placement
    and on every weight swap, kv_cache at engine build, activations
    whenever the estimate changes. Capacity is the card's own
    (``total_memory``); on the CPU the costmodel's cpu stand-in row."""

    def __init__(self, capacity_bytes=None, device=None):
        self._components = {}
        self._capacity = (capacity_bytes if capacity_bytes is not None
                          else self._detect_capacity(device))

    @staticmethod
    def _detect_capacity(device=None):
        stats = device_memory_stats(device)
        if stats:
            return stats["bytes_limit"]
        from . import costmodel
        spec = costmodel.chip_spec("cpu")
        return spec.hbm_capacity_bytes

    @property
    def capacity_bytes(self):
        return self._capacity

    def account(self, component, nbytes):
        """State the per-card bytes a component currently holds."""
        with _lock:
            self._components[str(component)] = max(0, int(nbytes))
        self.publish()

    def account_tree(self, component, tree, spec_tree=None, mesh=None):
        self.account(component,
                     tree_per_chip_bytes(tree, spec_tree, mesh))

    def account_kv(self, kv_cache):
        """Ride the serving KV cache's own shard-aware accountant."""
        self.account("kv_cache", kv_cache.per_chip_bytes())

    def set_activation_estimate(self, nbytes):
        self.account("activations", nbytes)

    def total_bytes(self):
        with _lock:
            return sum(self._components.values())

    def headroom_bytes(self):
        if self._capacity is None:
            return None
        return self._capacity - self.total_bytes()

    def snapshot(self):
        """Flight-dump / hvd_mem section: components, capacity math and
        the allocator's view (None on the CPU) to validate against."""
        with _lock:
            components = dict(self._components)
        stats = device_memory_stats()
        return {
            "components": components,
            "total_bytes": sum(components.values()),
            "capacity_bytes": self._capacity,
            "headroom_bytes": self.headroom_bytes(),
            "measured_bytes_in_use": (stats or {}).get("bytes_in_use"),
            "measured_peak_bytes": (stats or {}).get("peak_bytes_in_use"),
        }

    def publish(self):
        """Refresh the gauges; a no-op under the null registry."""
        from . import metrics as hvd_metrics
        reg = hvd_metrics.get_registry()
        if not reg.enabled:
            return
        g = reg.gauge("hvd_hbm_bytes",
                      "Attributed per-chip HBM bytes by component",
                      labels=("component",))
        with _lock:
            items = sorted(self._components.items())
        for component, nbytes in items:
            g.labels(component=component).set(nbytes)
        if self._capacity is not None:
            reg.gauge("hvd_hbm_capacity_bytes",
                      "Per-chip HBM capacity (the card's total memory)"
                      ).set(self._capacity)
            reg.gauge("hvd_hbm_headroom_bytes",
                      "Capacity minus attributed bytes").set(
                          self.headroom_bytes())


# ---------------------------------------------------------------------------
# compile observability: hit/miss tracking + recompile-storm escalation
# ---------------------------------------------------------------------------

def _dtype_name(dtype):
    """``float32`` for ``torch.float32``: the JAX package's dtype names."""
    return str(dtype).replace("torch.", "")


def abstract_key(args):
    """The abstract-shape key of a call: every leaf's dtype and shape, in
    tree order (tuples/lists in order, dicts by sorted key, None
    dropped); a leaf without a dtype keys by its type's name."""
    out = []

    def walk(x):
        if x is None:
            return
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            dtype = getattr(x, "dtype", None)
            out.append((_dtype_name(dtype) if dtype is not None
                        else type(x).__name__,
                        tuple(int(d) for d in getattr(x, "shape", ()))))
    walk(args)
    return tuple(out)


def format_key(key, max_leaves=8):
    parts = [f"{dt}[{','.join(str(d) for d in shape)}]"
             for dt, shape in key[:max_leaves]]
    if len(key) > max_leaves:
        parts.append(f"...+{len(key) - max_leaves}")
    return " ".join(parts) or "()"


class CompileTracker:
    """Per-site hit/miss accounting of abstract-shape keys with an EMA
    storm ladder (the JAX package's, unchanged).

    Each instrumented site (``train:<loop>``, ``serve_prefill``,
    ``serve_decode``) reports its call's key; a key this site has never
    seen is a miss. Misses feed a per-site EMA of the miss rate (decay
    HVD_MEM_STORM_DECAY); when the EMA crosses HVD_MEM_STORM_EMA with at
    least HVD_MEM_STORM_MIN misses, the site is in a recompile storm and
    the ladder fires once per site: ``recompile_storm`` event + warning
    naming the site and the churning key, then one flight dump tagged
    ``recompile_storm``. The first miss at a site is free."""

    def __init__(self, decay=None, threshold=None, min_misses=None):
        self._decay = (decay if decay is not None
                       else env_float("MEM_STORM_DECAY", 0.8))
        self._threshold = (threshold if threshold is not None
                           else env_float("MEM_STORM_EMA", 0.5))
        self._min_misses = (min_misses if min_misses is not None
                            else env_int("MEM_STORM_MIN", 3))
        self._sites = {}

    @property
    def min_misses(self):
        return self._min_misses

    def _site(self, site):
        entry = self._sites.get(site)
        if entry is None:
            entry = {"keys": set(), "hits": 0, "misses": 0, "ema": 0.0,
                     "storming": False, "dumped": False, "last_key": None}
            self._sites[site] = entry
        return entry

    def observe(self, site, args):
        """Record one call at a site; returns 'hit' or 'miss'."""
        key = abstract_key(args)
        from . import metrics as hvd_metrics
        reg = hvd_metrics.get_registry()
        with _lock:
            entry = self._site(site)
            miss = key not in entry["keys"]
            if miss:
                entry["keys"].add(key)
                entry["misses"] += 1
                entry["last_key"] = format_key(key)
            else:
                entry["hits"] += 1
            signal = 1.0 if (miss and entry["misses"] > 1) else 0.0
            entry["ema"] = (self._decay * entry["ema"]
                            + (1.0 - self._decay) * signal)
            storm = (entry["misses"] >= self._min_misses
                     and entry["ema"] > self._threshold)
            first_storm = storm and not entry["storming"]
            entry["storming"] = storm
            misses, key_str = entry["misses"], entry["last_key"]
            need_dump = first_storm and not entry["dumped"]
            if need_dump:
                entry["dumped"] = True
        outcome = "miss" if miss else "hit"
        if reg.enabled:
            reg.counter("hvd_compile_total",
                        "Instrumented compile-site calls by cache outcome",
                        labels=("site", "outcome")).labels(
                            site=site, outcome=outcome).inc()
            if miss:
                reg.event("compile_miss", site=site, key=format_key(key))
        if first_storm:
            self._escalate(site, misses, key_str, need_dump, reg)
        return outcome

    def _escalate(self, site, misses, key_str, need_dump, reg):
        log.warning(
            "recompile storm at site %r: %d distinct abstract-shape keys, "
            "last missed key %s — a shape polymorphism is leaking into "
            "this site", site, misses, key_str)
        if reg.enabled:
            reg.counter("hvd_recompile_storms_total",
                        "Recompile storms detected, by compile site",
                        labels=("site",)).labels(site=site).inc()
            reg.event("recompile_storm", site=site, misses=misses,
                      key=key_str)
        if need_dump:
            from . import tracing as hvd_tracing
            # the dump is the last rung of a telemetry ladder: a tracer
            # that cannot write must not break the call that tripped it
            hvd_tracing.get_tracer().dump("recompile_storm")

    def site_summary(self):
        with _lock:
            return {
                site: {"hits": e["hits"], "misses": e["misses"],
                       "ema": round(e["ema"], 4),
                       "storming": e["storming"],
                       "last_key": e["last_key"]}
                for site, e in sorted(self._sites.items())}


class instrument_compiles:
    """Wrap a callable so every call reports hit/miss at ``site``;
    attribute access passes through."""

    def __init__(self, fn, site):
        self._fn = fn
        self._site = site

    def __call__(self, *args, **kwargs):
        if enabled():
            get_tracker().observe(self._site, (args, kwargs))
        return self._fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)


# ---------------------------------------------------------------------------
# resharding sentinel over recorded collectives
# ---------------------------------------------------------------------------

def leaf_table(params, spec_tree, mesh_shape):
    """(name, full shape, declared shard shape, spec) of every parameter
    of ``params`` (name -> tensor) under ``spec_tree`` (name -> spec) on
    a mesh of ``mesh_shape`` ({axis: size})."""
    table = []
    for name, t in params.items():
        shape = tuple(t.shape)
        if not shape:
            continue
        spec = spec_tree.get(name)
        table.append((name, shape, spec_shard_shape(shape, spec, mesh_shape),
                      spec))
    return table


def _axis_for(spec, dim, ratio, mesh_shape):
    """The mesh axis a gather undoes: the axis the declared spec put on
    that dim, else any mesh axis whose size matches the ratio."""
    entries = tuple(spec) if spec is not None else ()
    if dim is not None and dim < len(entries) and entries[dim] is not None:
        part = entries[dim]
        names = part if isinstance(part, (tuple, list)) else (part,)
        return "+".join(str(n) for n in names)
    for name, size in mesh_shape.items():
        if int(size) == ratio:
            return str(name)
    return None


def scan_resharding(collectives, params, spec_tree, mesh_shape,
                    site="serve_decode"):
    """Findings (one dict per flagged collective: leaf, op, axis, dim,
    full and shard shapes, site) of ``collectives`` (records of ``op``,
    ``result_shape``, ``operand_shapes``, ``dim``) against the parameters'
    declared shardings; empty on a clean spec tree."""
    full_table = leaf_table(params, spec_tree, mesh_shape)
    table = [row for row in full_table if row[1] != row[2]]
    replicated_fulls = {row[1] for row in full_table if row[1] == row[2]}
    findings = []
    for coll in collectives:
        result = tuple(coll["result_shape"])
        if result in replicated_fulls:
            continue
        operands = [tuple(s) for s in coll["operand_shapes"]]
        for name, full, shard, spec in table:
            if result != full or shard not in operands:
                continue
            dim = coll.get("dim")
            if dim is None:
                dim = next((i for i, (f, s) in enumerate(zip(full, shard))
                            if f != s), None)
            ratio = (full[dim] // max(1, shard[dim])
                     if dim is not None and dim < len(full) else 0)
            findings.append({
                "leaf": name, "op": coll["op"],
                "axis": _axis_for(spec, dim, ratio, mesh_shape),
                "dim": dim, "full_shape": list(full),
                "shard_shape": list(shard), "site": site})
            break
    return findings


# ---------------------------------------------------------------------------
# pre-flight planner (tools/hvd_mem --plan)
# ---------------------------------------------------------------------------

def _kv_plan_bytes(cfg, slots, max_len, tp):
    if not slots or not max_len:
        return 0
    head_dim = cfg.d_model // cfg.num_heads
    heads = cfg.num_heads // tp if tp and cfg.num_heads % tp == 0 \
        else cfg.num_heads  # kv_cache_spec: indivisible heads replicate
    itemsize = cfg.dtype.itemsize
    return (2 * cfg.num_layers * slots * max_len * heads * head_dim
            * itemsize)


def plan_memory(cfg, *, dp=1, tp=1, sp=1, batch_per_chip=1, seq=None,
                chip=None, optimizer="adam", kv_slots=0, kv_max_len=0):
    """Pre-flight per-card HBM estimate for a TransformerConfig at a
    dp×tp×sp layout: pure math from the model config, the declared
    parameter specs and the ChipSpec table; no card touched (the model
    is built on the ``meta`` device, fp32 masters as the training model
    holds them).

    Params/grads per card come from the parameter shapes sharded by
    ``models.transformer.param_specs``; optimizer state is adam's 2×
    (``optimizer='sgd'`` 1×); activations the costmodel estimate; KV the
    serving cache's shape. ``chip`` is a ChipSpec kind (a card name)."""
    from ..models import transformer as tr
    from . import costmodel

    seq = seq or min(cfg.max_seq_len, 128)
    model = tr.TransformerLM(cfg, torch.device("meta"), torch.float32)
    params = dict(model.named_parameters())
    specs = tr.param_specs(params)
    layout = {"dp": dp, "tp": tp, "sp": sp}
    params_b = tree_per_chip_bytes(params, specs, layout)
    opt_factor = {"adam": 2, "adamw": 2, "sgd": 1, "none": 0}.get(
        str(optimizer).lower(), 2)
    act_b = costmodel.lm_activation_bytes(cfg, seq, batch_per_chip)
    kv_b = _kv_plan_bytes(cfg, kv_slots, kv_max_len, tp)
    components = {
        "params": params_b,
        "grads": params_b,
        "opt_state": opt_factor * params_b,
        "activations": act_b,
        "kv_cache": kv_b,
    }
    total = sum(components.values())
    spec = costmodel.chip_spec(chip) if chip else None
    capacity = getattr(spec, "hbm_capacity_bytes", None) if spec else None
    return {
        "config": type(cfg).__name__,
        "layout": layout,
        "batch_per_chip": batch_per_chip, "seq": seq,
        "chip": spec.kind if spec else None,
        "components": components,
        "total_bytes": total,
        "capacity_bytes": capacity,
        "headroom_bytes": capacity - total if capacity else None,
        "fits": (capacity - total > 0) if capacity else None,
    }


# ---------------------------------------------------------------------------
# flight-dump section
# ---------------------------------------------------------------------------

def flight_section():
    """The ``memory`` section of a flight dump: ledger snapshot +
    per-site compile summary; None when the plane is off or nothing has
    been accounted yet."""
    if not enabled():
        return None
    with _lock:
        # capture the singletons under the lock: a concurrent reset()
        # must not null them between the check and the snapshots
        ledger, tracker = _ledger, _tracker
        have = (ledger is not None and ledger._components) or \
            (tracker is not None and tracker._sites)
    if not have:
        return None
    section = {}
    if ledger is not None:
        section["hbm"] = ledger.snapshot()
    if tracker is not None:
        section["compile"] = tracker.site_summary()
    return section or None
