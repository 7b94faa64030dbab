"""Eager coordination core: queue → negotiate → fuse → execute → callback.

The port of ``horovod_tpu/ops/eager.py``, the reference's background
thread and rank-0 negotiation (BackgroundThreadLoop operations.cc:857,
RunLoopOnce operations.cc:1246, protocol comment operations.cc:1217-1245).
Each rank is one process on one card, as in reference Horovod, so the
tensor a rank submits is its own contribution (the JAX package's
"replicated" kind; its single-controller "stacked" and per-local-worker
list conventions have no counterpart here, and the tests map JAX's
stacked row i to port rank i).

  * tensor table keyed by name, duplicate-name detection
    (DUPLICATE_NAME_ERROR, operations.cc:121; EnqueueTensorAllreduce
    operations.cc:1654)
  * a paced background loop (HOROVOD_CYCLE_TIME, default 5 ms,
    operations.cc:1013) on a thread of its own, the only origin of the
    data plane's collectives under negotiation
  * rank-0 negotiation over the authenticated TCP wire
    (``ops/negotiation.py``) when the world has more than one rank and a
    control address and key (``HVD_CONTROL_ADDR`` or the rendezvous,
    ``HVD_SECRET_KEY``); without them the ranks must submit in the same
    order, which the first occurrence of each collective signature
    checks across processes
  * tensor fusion into bucketed collectives (HOROVOD_FUSION_THRESHOLD,
    FuseResponses operations.cc:450-573): at the coordinator under
    negotiation, locally on one rank
  * an LRU plan cache and the worker half of the response cache
    (response_cache.h:43-92, RunBypass operations.cc:1168-1215)
  * integer handles with poll/synchronize semantics
    (torch/handle_manager.h:30-41, torch/mpi_ops.py:406-438)
  * stall detection with warning/shutdown deadlines
    (CheckForStalledTensors operations.cc:688-769)
  * timeline spans (NEGOTIATE_*, MEMCPY_IN_FUSION_BUFFER, ALLREDUCE, ...)
  * the CUDA completion machinery (``process_collectives.StreamSync``):
    a ready event per entry at enqueue, the collective stream waiting on
    it, ``record_stream`` on inputs and fusion buffers, a completion
    event per executed group that a finalizer thread waits on before it
    fires the entries' callbacks and marks their handles done.

  * the overlap plane (``HOROVOD_OVERLAP_EAGER``): ``flush_ready``
    drains every fusion group whose queued bytes reached the threshold
    while the caller is still enqueuing (``optim``'s reverse-order
    gradient enqueue), each drained bucket still waiting on the card for
    its own entries' ready events, not for the host; under negotiation
    it only wakes the background cycle, the one origin of the data
    plane's collectives
  * the two-level engine under ``HOROVOD_OVERLAP_HIERARCHICAL`` (the JAX
    core's ``_hier_engine``; processes per host from
    ``HOROVOD_OVERLAP_LOCAL_SIZE``, else the launcher's
    ``HVD_LOCAL_SIZE``), with the ``/h<N>`` suffix on the negotiated
    codec fingerprint. ``HOROVOD_HIERARCHICAL_ALLREDUCE`` keeps what it
    does in the JAX package: the operation manager's two-level backend
    for the collectives over mesh axes and ``DistributedOptimizer``,
    not the eager core's engine.

  * the observability planes, as the JAX core has them: the metrics
    registry (``utils/metrics.py``: plan-cache, flush, collective,
    negotiation-cycle, stall and overlap instruments; the exposition
    server on ``HVD_METRICS_PORT`` + rank, rank 0 serving the aggregate
    of the snapshots workers piggyback on their cycle requests every
    ``HVD_METRICS_INTERVAL`` seconds), and the tracing plane
    (``utils/tracing.py``): every tensor's spans enqueue -> negotiate ->
    fusion -> execute -> callback under one trace id, the negotiate span
    closed with the coordinator's ``cycle``, the flight recorder dumped
    on a lost rank, a stale ack, a stall kill or SIGTERM, and sent to
    rank 0 when its responses ask for it (``dump_requested``). The JAX
    core keeps one execute and one callback span per fused group; the
    port keeps one of each per tensor, so that every tensor's tree is
    whole, and on the card an execute span closes where the group's CUDA
    completion event has fired, not where the collective was issued.
    ``HVD_METRICS=0`` and ``HVD_TRACE=0`` give the null objects. The
    queue, flush and handle locks opt into ``HVD_LOCKDEP``.

  * the numerics plane (``utils/numerics.py``): every executed
    allreduce bucket's per-tensor health stats, queued on the collective
    stream after the bucket's completion event (no caller waits on
    them; the host reads them once their event has fired), the local
    contribution's before the collective where the world has more than
    one rank; under negotiation their records ride the next cycle
    request as the digest the coordinator's divergence sentinel
    compares. ``test_perturb`` ({name: relative}) scales this rank's
    reduced copy of a named tensor, the hook a divergence drill uses.
  * the autotuner (``HOROVOD_AUTOTUNE``, ``utils/autotune.py``): only
    rank 0 tunes, scoring the bytes each flush moved over the time
    between flushes; on one rank it applies each suggestion at once,
    under negotiation the coordinator reads rank 0's live config and
    the values ride every response, and without a coordinator the
    ranks adopt rank 0's values every
    ``HOROVOD_AUTOTUNE_SYNC_COLLECTIVES`` collectives
    (``_sync_tuned_params``, one allgather).

``tally()`` reads the overlap plane's ``hvd_overlap_*`` and ``optim``'s
``hvd_grad_*`` counters back from the registry, flat, as
``quantization.tally()`` reads the wire bytes.
"""

import collections
import contextlib
import functools
import queue
import threading
import time
import zlib

import torch
import torch.distributed as dist

from ..common import hvd_logging as log
from ..common.exceptions import (DuplicateNameError, MismatchError,
                                 RanksLostError, ShutdownError,
                                 StalledError)
from ..utils import lockdep
from ..utils import metrics as hvd_metrics
from ..utils import numerics as hvd_numerics
from ..utils import timeline as timeline_mod
from ..utils import tracing as hvd_tracing
from . import compression as compression_mod
from . import fusion as fusion_mod
from . import quantization as quant_mod
from .process_collectives import (HierarchicalProcessEngine,
                                  ProcessCollectiveEngine, StreamSync)

ALLREDUCE = "allreduce"
ALLGATHER = "allgather"
BROADCAST = "broadcast"
REDUCESCATTER = "reducescatter"
ALLTOALL = "alltoall"
_OPS = (ALLREDUCE, ALLGATHER, BROADCAST, REDUCESCATTER, ALLTOALL)
#: the infix of the names ``mpi_ops`` gives a collective submitted without
#: one (``{op}.noname.{n}``): new on every submission
AUTO_NAME_INFIX = ".noname."


def _entry_nbytes(entry):
    return fusion_mod._nbytes(entry.tensor)


_TALLY = hvd_metrics.Tally((
    "hvd_overlap_ready_flushes_total", "hvd_overlap_ready_tensors_total",
    "hvd_overlap_wakes_total", "hvd_grad_reduce_steps_total",
    "hvd_grad_enqueue_ms_total", "hvd_grad_exposed_ms_total"))


def tally():
    """The overlap plane's counters since ``reset_tally()``, flat:
    ``{(metric, labels...): value}``."""
    return _TALLY.read()


def reset_tally():
    _TALLY.reset()


class _Instruments:
    """The core's instruments on one registry, bound once (the JAX core
    binds them at construction); ``EagerCoordinator._m`` rebinds when
    the process registry is replaced."""

    def __init__(self, reg):
        self.reg = reg
        self.plan_hits = reg.counter(
            "hvd_plan_cache_hits_total",
            "Fusion-plan cache hits (batch signature seen before).")
        self.plan_misses = reg.counter(
            "hvd_plan_cache_misses_total",
            "Fusion-plan cache misses (plan computed fresh).")
        self.neg_cycles = reg.counter(
            "hvd_negotiation_cycles_total",
            "Negotiation cycle RPCs completed by this worker.")
        self.neg_cycle_s = reg.histogram(
            "hvd_negotiation_cycle_seconds",
            "Latency of one negotiation cycle RPC (request to response, "
            "excluding response application).")
        self.neg_failures = reg.counter(
            "hvd_negotiation_cycle_failures_total",
            "Cycle RPC failures (transient transport errors; backoff "
            "applies between retries).")
        self.flush_s = reg.histogram(
            "hvd_flush_seconds",
            "Duration of one non-negotiated flush (plan + execute).")
        self.flush_tensors = reg.histogram(
            "hvd_flush_tensors",
            "Tensors drained per non-negotiated flush.",
            buckets=hvd_metrics.COUNT_BUCKETS)
        self.coll_bytes = reg.counter(
            "hvd_collective_bytes_total",
            "Payload bytes executed through the eager data plane, by "
            "op class.", labels=("op",))
        self.coll_s = reg.histogram(
            "hvd_collective_seconds",
            "Dispatch latency of one eager collective execution "
            "(async: completion happens on device), by op class.",
            labels=("op",))
        self.overlap_flushes = reg.counter(
            "hvd_overlap_ready_flushes_total",
            "Ready-bucket drains dispatched while the caller was still "
            "enqueuing later tensors (overlap plane).")
        self.overlap_tensors = reg.counter(
            "hvd_overlap_ready_tensors_total",
            "Tensors dispatched by ready-bucket drains ahead of the "
            "whole-tree barrier.")
        self.overlap_wakes = reg.counter(
            "hvd_overlap_wakes_total",
            "Early background-cycle wakes requested by flush_ready "
            "(negotiated path: a bucket's worth of bytes is queued).")
        self.stalled_tensors = reg.gauge(
            "hvd_stalled_tensors",
            "Pending tensors on this worker past the stall warning "
            "deadline (0 = healthy).")
        self.stall_kills = reg.counter(
            "hvd_stall_kills_total",
            "Tensors failed by the stall shutdown deadline.")


def _divide(t, n):
    if t.is_floating_point():
        return t / n
    return torch.div(t, n, rounding_mode="floor")


class TensorTableEntry:
    """Parity: TensorTableEntry (common.h:167-184)."""

    __slots__ = ("name", "op", "tensor", "root_rank", "average", "handle",
                 "result", "status", "event", "enqueue_time", "ready_event",
                 "done_event", "callbacks", "trace_id", "span", "fu_span",
                 "ex_span")

    def __init__(self, name, op, tensor, root_rank=0, average=False,
                 handle=None):
        self.name = name
        self.op = op
        self.tensor = tensor
        self.root_rank = root_rank
        self.average = average
        self.handle = handle
        self.result = None
        self.status = None  # None = pending, True = ok, Exception = error
        self.event = threading.Event()
        self.enqueue_time = time.monotonic()
        # CUDA: recorded on the caller's stream at enqueue, and on the
        # collective stream once the result is written
        self.ready_event = None
        self.done_event = None
        # fired by the finalizer once the collective has completed
        self.callbacks = []
        # the tracing plane: the trace id minted at enqueue, the open
        # negotiate span, then the fusion and execute spans
        self.trace_id = None
        self.span = self.fu_span = self.ex_span = hvd_tracing._NULL_SPAN

    def signature(self):
        return (self.op, self.name, tuple(self.tensor.shape),
                fusion_mod.dtype_name(self.tensor.dtype), self.root_rank,
                self.average)


class HandleManager:
    """Integer async handles (torch/handle_manager.h:30-41)."""

    def __init__(self):
        self._lock = lockdep.lock("HandleManager._lock")
        self._next = 0      # guarded_by: _lock
        self._entries = {}  # guarded_by: _lock

    def allocate(self, entry):
        with self._lock:
            h = self._next
            self._next += 1
            self._entries[h] = entry
            entry.handle = h
            return h

    def get(self, handle):
        with self._lock:
            entry = self._entries.get(handle)
        if entry is None:
            raise ValueError(f"Handle {handle} was not created or has "
                             f"already been released.")
        return entry

    def poll(self, handle):
        return self.get(handle).event.is_set()

    def release(self, handle):
        with self._lock:
            self._entries.pop(handle, None)


class PlanCache:
    """LRU plan cache — response-cache analogue (response_cache.h:43-92).

    Maps the signature of a drained batch to its fusion plan so repeat
    iterations skip planning (the RunBypass fast path,
    operations.cc:1168-1215)."""

    def __init__(self, capacity):
        self.capacity = capacity
        self._cache = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key, instruments=None):
        plan = self._cache.get(key)
        if plan is not None:
            self._cache.move_to_end(key)
            self.hits += 1
            if instruments is not None:
                instruments.plan_hits.inc()
        else:
            self.misses += 1
            if instruments is not None:
                instruments.plan_misses.inc()
        return plan

    def put(self, key, plan):
        if self.capacity <= 0:
            return
        self._cache[key] = plan
        self._cache.move_to_end(key)
        while len(self._cache) > self.capacity:
            self._cache.popitem(last=False)

    def clear(self):
        self._cache.clear()


class EagerCoordinator:
    """The per-process coordination core (BackgroundThreadLoop analogue).

    ``state`` is the initialized global state (its config, device, rank
    and world size); the core makes its own process group over every
    rank, so it must be constructed on every rank at the same point."""

    # how long the control plane must stay unreachable (with >=3 failed
    # attempts under exponential backoff) before this worker declares it
    # lost and fails pending work
    POISON_GRACE_S = 5.0

    def __init__(self, state):
        self._config = state.config
        # validate HOROVOD_COMPRESSION at init, not mid-step
        compression_mod.Compression.from_name(
            getattr(self._config, "compression", "none"))
        self._device = state.device
        self._rank = dist.get_rank()
        self._world = dist.get_world_size()
        # the core's own communicator: no other route (the optimizer's
        # hooks, the tp/sp collectives) ever issues on it
        self.group = dist.new_group(list(range(self._world)))
        self._sync = StreamSync(self._device)
        # error-feedback residuals of the quantized wire, by fused bucket
        self._ef = quant_mod.ErrorFeedback()
        #: when set, the flat quantized leg keeps its last bucket's names,
        #: codec, compensated input and result in ``last_quantized``
        self.record_quantized = False
        self.last_quantized = None
        self._queue = collections.deque()  # guarded_by: _queue_lock
        self._queue_lock = lockdep.lock("EagerCoordinator._queue_lock")
        self._tensor_table = {}  # guarded_by: _queue_lock; name -> entry
        self._flush_lock = lockdep.lock("EagerCoordinator._flush_lock")
        self.handles = HandleManager()
        self.plan_cache = PlanCache(self._config.cache_capacity)
        self._shutdown = False
        self._poison_grace_s = (
            getattr(self._config, "coordinator_lost_timeout_seconds", 0.0)
            or self.POISON_GRACE_S)
        self._paused = False  # test hook: lets stall detection be exercised
        # interruptible pacing: an enqueue under HOROVOD_CYCLE_TIME=0 and
        # shutdown wake the cycle
        self._ready_event = threading.Event()
        self._stall_warned = set()
        self._verified_sigs = set()  # cross-process checks done
        self.timeline = timeline_mod.create_from_env(self._config,
                                                     self._rank == 0)
        self._negotiator = None
        self._negotiated_pending = {}  # name -> entry awaiting a response
        self._applied_seq = -1
        self._cycle_failures = 0
        self._cycle_fail_since = None
        self._cycle_backoff_until = 0.0
        self._cycle_req_id = 0
        self._negotiation_dead = False
        #: the ranks the control plane declared lost (its liveness ledger,
        #: or this worker when the coordinator is gone), once it has
        self.lost_ranks = ()
        self._unannounced = None  # (metas, hit_ids) not yet delivered
        # worker half of the response cache: a name resubmitted with an
        # unchanged signature rides the wire as its cache id
        self._neg_cache = {}      # name -> (cache_id, signature)
        self._neg_cache_ids = {}  # cache_id -> name
        self._reannounce = set()  # names whose ids came back unknown
        self._neg_hit_count = 0   # tensors announced as cache bits
        # fused groups executed (negotiated responses or local plan
        # groups) and the tensors in them: the bucket counts a caller
        # compares with plan_buckets
        self.executed_groups = 0
        self.executed_tensors = 0
        #: executed groups by op (a fused allgatherv counts once)
        self.executed_ops = collections.Counter()
        # the two-level engine, on groups of its own built here, on every
        # rank at the same point (dist.new_group is collective)
        self._hier = self._make_hier_engine(
            int(getattr(self._config, "overlap_local_size", 0))
            or state.local_size)
        # the observability planes: the registry takes this rank, the
        # tracer too, and SIGTERM dumps the flight recorder
        self._inst = None
        reg = hvd_metrics.get_registry()
        if reg.enabled and reg.rank is None:
            reg.rank = self._rank
        hvd_tracing.set_rank(self._rank)
        hvd_tracing.install_signal_dump()
        # dump solicitation: the coordinator sets dump_requested on its
        # responses when it escalates; this worker attaches ONE flight
        # snapshot to its next cycle request in reply
        self._flight_send_pending = False
        self._flight_sent = False
        self._metrics_next_push = 0.0
        if self._world > 1:
            from . import negotiation as neg
            addrs = neg.control_addresses()
            key = neg.control_key()
            if addrs is None or key is None:
                missing = ("HVD_CONTROL_ADDR/HVD_COORDINATOR_ADDR/"
                           "MASTER_ADDR" if addrs is None
                           else "HVD_SECRET_KEY")
                log.warning(
                    "no %s; the multi-process eager API runs WITHOUT "
                    "rank-0 negotiation — every process must submit "
                    "collectives in the same order", missing)
            else:
                self._negotiator = neg.NegotiationWorker(
                    self._rank, self._world, self._config, addrs, key)
        self._init_autotune()
        # numerics plane: the digest awaiting piggyback, the seq being
        # executed (None: a local flush) and the staged stats of the
        # allreduce bucket being executed
        self._numerics_pending = None
        self._numerics_cycle = None
        self._numerics_staged = None
        #: test hook: {tensor name: relative} scales this rank's reduced
        #: copy of the named tensor (a divergence drill)
        self.test_perturb = {}
        self._finalize_q = queue.SimpleQueue()
        self._finalizer = None
        if self._sync.cuda:
            self._finalizer = threading.Thread(
                target=self._finalize_loop, daemon=True,
                name="hvd-finalizer")
            self._finalizer.start()
        self._metrics_server = None
        port = int(getattr(self._config, "metrics_port", 0) or 0)
        if port and reg.enabled:
            try:
                self._metrics_server = hvd_metrics.MetricsServer(
                    port + self._rank,
                    lambda: hvd_metrics.get_registry().snapshot(),
                    remote_snapshots_fn=self._remote_metrics_snapshots)
            except OSError as exc:
                log.warning("metrics server failed to bind port %s: %s",
                            port + self._rank, exc)
        self._thread = threading.Thread(
            target=self._background_loop, daemon=True, name="hvd-background")
        self._thread.start()

    def _init_autotune(self):
        """The autotuner's state (the JAX core's constructor). Without a
        coordinator and with more than one rank, per-rank tuning would
        diverge the ranks' plans, so rank 0 tunes and every rank adopts
        its values at the same agreed point in the collective order
        (``_sync_tuned_params``). Under negotiation fusion happens at
        the coordinator with rank 0's live config, and the values ride
        every response."""
        cfg = self._config
        self.autotuner = None
        self._autotune_defer = (cfg.autotune and self._world > 1 and
                                self._negotiator is None)
        sync_every = int(getattr(cfg, "autotune_sync_collectives", 32))
        if self._autotune_defer and sync_every <= 0:
            raise ValueError(
                "HOROVOD_AUTOTUNE_SYNC_COLLECTIVES must be >= 1 (got "
                f"{sync_every}); to disable autotuning, unset "
                "HOROVOD_AUTOTUNE instead")
        self._autotune_sync_every = sync_every if self._autotune_defer \
            else 0
        self._replicated_count = 0
        self._proposed_params = None
        # set by _sync_tuned_params: the adoption flush is not scored
        self._adopted_this_flush = False
        # between staging a suggestion and its adoption, cycles run under
        # the old knobs: scoring pauses
        self._autotune_pending_adoption = False
        # passive scoring: (flush start, bytes) of the previous flush;
        # a flush scores prev_bytes / (this start - prev start)
        self._at_prev_flush = None
        if cfg.autotune and self._rank == 0:
            from ..utils import autotune as autotune_mod
            self.autotuner = autotune_mod.Autotuner(
                cfg, log_path=getattr(cfg, "autotune_log", "") or None)

    def _apply_suggestion(self):
        """Adopt the autotuner's current knobs: at once on one rank or
        under negotiation, staged for the next agreed sync point
        without a coordinator."""
        if self._autotune_defer:
            self._proposed_params = (self.autotuner.threshold,
                                     self.autotuner.cycle_time_ms)
            self._autotune_pending_adoption = True
        else:
            self._config.fusion_threshold = int(self.autotuner.threshold)
            self._config.cycle_time_ms = float(self.autotuner.cycle_time_ms)

    def _score_flush(self, t0, batch):
        """The non-negotiated cycle's autotune scoring (the JAX core's
        ``_flush_locked`` tail)."""
        if (self.autotuner is None or self.autotuner.frozen
                or self._autotune_pending_adoption):
            return
        total = sum(_entry_nbytes(e) for e in batch)
        prev = self._at_prev_flush
        self._at_prev_flush = (t0, total)
        # a pause in traffic is not collective time: a window much
        # longer than the cycle pacing is the app going idle
        idle_cap = max(10 * self._config.cycle_time_ms / 1000.0, 1.0)
        if self._adopted_this_flush:
            # the interval straddles two knob settings: restart it
            self._at_prev_flush = None
        elif prev is not None and (t0 - prev[0]) < idle_cap:
            if self.autotuner.record_cycle(prev[1], t0 - prev[0]):
                self._at_prev_flush = None
                self._apply_suggestion()

    def freeze_autotune(self):
        """End the tuning phase: adopt the best scored point and stop
        scoring (the reference ParameterManager's converged state).
        Without a coordinator the values still travel through the next
        agreed sync point. Returns (threshold, cycle_ms, score) or None
        (not rank 0, or nothing scored)."""
        if self.autotuner is None:
            return None
        # under the flush lock: a cycle scoring concurrently would apply
        # its own suggestion after this freeze
        with self._flush_lock:
            best = self.autotuner.freeze()
            if best is not None:
                self._apply_suggestion()
        return best

    def _sync_tuned_params(self):
        """Adopt rank 0's (possibly staged) tuned parameters on every
        rank at this agreed point of the collective order: one int64
        allgather of (threshold, cycle µs), every rank reaching it by the
        count-scheduled call site."""
        if self._proposed_params is not None:
            thr, ct = self._proposed_params
        else:
            thr, ct = (self._config.fusion_threshold,
                       self._config.cycle_time_ms)
        mine = torch.tensor([int(thr), int(round(ct * 1000))],
                            dtype=torch.int64, device=self._device)
        rows = self._proc_engine.allgather_rows(mine).cpu().tolist()
        self._config.fusion_threshold = int(rows[0][0])
        self._config.cycle_time_ms = float(rows[0][1]) / 1000.0
        self._proposed_params = None
        self._autotune_pending_adoption = False
        self._adopted_this_flush = True

    @property
    def _m(self):
        """The core's instruments on the current process registry."""
        reg = hvd_metrics.get_registry()
        inst = self._inst
        if inst is None or inst.reg is not reg:
            inst = self._inst = _Instruments(reg)
        return inst

    @property
    def _tracer(self):
        return hvd_tracing.get_tracer()

    def _remote_metrics_snapshots(self):
        """Rank 0 only: the peers' piggybacked snapshots held by the
        coordinator service (the exposition server's aggregation
        source), through its locked accessor."""
        neg = self._negotiator
        svc = getattr(neg, "service", None) if neg is not None else None
        return svc.metrics_snapshot_view() if svc is not None else {}

    @property
    def negotiated(self):
        """Whether collectives are ordered by rank 0's coordinator."""
        return self._negotiator is not None

    # -- enqueue API (EnqueueTensorAllreduce/..., operations.cc:1654-1770) --

    def enqueue(self, name, op, tensor, root_rank=0, average=False,
                callback=None):
        """Queue one collective of this rank's ``tensor``; returns its
        handle."""
        return self.enqueue_group([(name, op, tensor, root_rank, average,
                                    callback)])[0]

    def enqueue_group(self, items):
        """Queue several collectives at once — ``(name, op, tensor,
        root_rank, average, callback)`` each — so that they drain in one
        cycle (one negotiation announcement; one local plan); returns
        their handles in order."""
        if self._shutdown:
            raise ShutdownError()
        if self._negotiation_dead:
            raise self._dead_error()
        tracer = self._tracer
        entries = []
        for name, op, tensor, root_rank, average, callback in items:
            if op not in _OPS:
                raise ValueError(f"Unknown op {op}")
            if not isinstance(tensor, torch.Tensor):
                raise ValueError(f"expected a torch.Tensor for '{name}', "
                                 f"got {type(tensor)}")
            if op == BROADCAST and not 0 <= root_rank < self._world:
                raise MismatchError(
                    f"Invalid root_rank {root_rank} for broadcast "
                    f"'{name}': must be in [0, {self._world}).")
            entry = TensorTableEntry(name, op, tensor, root_rank=root_rank,
                                     average=average)
            if callback is not None:
                entry.callbacks.append(callback)
            entry.ready_event = self._sync.ready_event(tensor)
            entries.append(entry)
        # a group's spans open and close together (one clock read, one
        # tracer lock): the per-tensor trees cost a few µs a tensor
        names = [e.name for e in entries]
        for e, tid in zip(entries, tracer.new_trace_ids(names)):
            e.trace_id = tid
        spans = tracer.open_many(hvd_tracing.ENQUEUE, [
            (e.name, e.trace_id, None, {"op": e.op}) for e in entries])
        try:
            with self._queue_lock:
                for i, n in enumerate(names):
                    if n in self._tensor_table or n in names[:i]:
                        raise DuplicateNameError(n)
                # the negotiation-wait spans stay open until the
                # coordinator orders the tensor or a local flush drains it
                negs = tracer.open_many(hvd_tracing.NEGOTIATE, [
                    (e.name, e.trace_id, enq,
                     {"op": e.op, "enqueue_req": self._cycle_req_id})
                    for e, enq in zip(entries, spans)])
                for e, neg in zip(entries, negs):
                    e.span = neg
                    self._tensor_table[e.name] = e
                    self._queue.append(e)
        except BaseException as exc:
            tracer.close_many(spans, status="error", error=str(exc))
            raise
        tracer.close_many(spans)
        handles = [self.handles.allocate(e) for e in entries]
        if self.timeline:
            for e in entries:
                self.timeline.negotiate_start(e.name, e.op)
        if self._config.cycle_time_ms <= 0:
            self._ready_event.set()   # no pacing: this cycle starts now
        return handles

    # -- handle API --

    def poll(self, handle):
        return self.handles.poll(handle)

    @contextlib.contextmanager
    def hold_cycle(self):
        """While held, no cycle runs, so every collective enqueued inside
        lands in one cycle on the next flush. A background cycle that
        read the pause just before the hold began re-reads it when it
        takes the queue (``flush(unless_held=True)``), so it cannot take
        what the held block enqueues."""
        prev = self._paused
        self._paused = True
        try:
            yield
        finally:
            self._paused = prev

    def synchronize(self, handle):
        """Block until the handle's collective completes and return its
        output (torch/mpi_ops.py:422-438); on the card, the caller's
        current stream waits on the collective's completion event."""
        entry = self.handles.get(handle)
        deadline = None
        if self._config.stall_shutdown_time_seconds > 0:
            deadline = (entry.enqueue_time +
                        self._config.stall_shutdown_time_seconds)
        while not entry.event.is_set():
            if not self._paused and self._negotiator is None:
                # non-blocking: a flush stuck in a transport collective
                # must not swallow the stall deadline below. Under
                # negotiation ONLY the background thread runs the cycle.
                self.flush(blocking=False, unless_held=True)
            if entry.event.wait(timeout=max(
                    self._config.cycle_time_ms / 1000.0, 1e-3)):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise StalledError(
                    f"Collective '{entry.name}' stalled for more than "
                    f"{self._config.stall_shutdown_time_seconds}s.")
        self.handles.release(handle)
        if isinstance(entry.status, Exception):
            raise entry.status
        StreamSync.hand_over(entry.done_event, [entry.result])
        return entry.result

    # -- the cycle loop (RunLoopOnce, operations.cc:1246) --

    def _set_device(self):
        if self._sync.cuda:
            torch.cuda.set_device(self._device)

    def _background_loop(self):
        self._set_device()
        while not self._shutdown:
            self._ready_event.wait(self._cycle_wait())
            self._ready_event.clear()
            if self._paused:
                continue
            try:
                self.flush(unless_held=True)
            except Exception as exc:  # noqa: BLE001 — never kill the loop
                log.error("background flush failed: %s", exc)
            self._check_stalled()

    # HOROVOD_CYCLE_TIME=0 means no pacing: without a coordinator to poll,
    # the loop sleeps until an enqueue wakes it (a spinning loop would
    # starve the caller's thread of the interpreter lock), waking this
    # often for the stall scan
    IDLE_WAIT_S = 0.1

    def _cycle_wait(self):
        cycle = self._config.cycle_time_ms / 1000.0
        if cycle <= 0 and self._negotiator is None:
            return self.IDLE_WAIT_S
        return cycle

    def _finalize_loop(self):
        """Wait on each executed group's completion event, then fire its
        entries' callbacks and mark their handles done."""
        self._set_device()
        while True:
            item = self._finalize_q.get()
            if item is None:
                return
            ev, entries = item
            ev.synchronize()
            # the residual norms computed before the event are ready
            self._ef.publish()
            self._mark_done(entries)

    def flush(self, blocking=True, unless_held=False):
        """Drain the queue and execute everything in it (one cycle).
        ``unless_held``: take nothing while ``hold_cycle`` is held, read
        under the queue lock, where enqueues land."""
        if not self._flush_lock.acquire(blocking):
            return
        try:
            self._flush_locked(unless_held)
        finally:
            self._flush_lock.release()

    def _take_queue(self, unless_held):
        with self._queue_lock:
            if unless_held and self._paused:
                return []
            batch = list(self._queue)
            self._queue.clear()
        return batch

    def _flush_locked(self, unless_held=False):
        if self._negotiator is not None:
            self._negotiated_flush_locked(unless_held)
            return
        batch = self._take_queue(unless_held)
        if batch:
            self._score_flush(self._run_batch(batch), batch)

    def _run_batch(self, batch):
        """Plan + execute one drained batch — the body of a
        non-negotiated cycle. Caller holds _flush_lock. Returns the
        flush start time (the autotune scorer's window anchor)."""
        if self.timeline:
            self.timeline.mark_cycle_start()
            for e in batch:
                self.timeline.negotiate_end(e.name)
        tracer = self._tracer
        # without a coordinator, negotiation is a local queue wait
        tracer.close_many([e.span for e in batch], local=True)
        fusion = tracer.open_many(hvd_tracing.FUSION, [
            (e.name, e.trace_id, e.span, {}) for e in batch])
        for e, fu in zip(batch, fusion):
            e.fu_span = fu
        m = self._m
        t0 = time.perf_counter()
        key = (int(self._config.fusion_threshold),
               compression_mod.config_fingerprint(self._config),
               tuple(e.signature() for e in batch))
        plan = self.plan_cache.get(key, m)
        hit = plan is not None
        if plan is None:
            plan = self._make_plan(batch)
            self.plan_cache.put(key, plan)
        fused = [0] * len(batch)
        for _, idxs, _, _ in plan:
            for i in idxs:
                fused[i] = len(idxs)
        tracer.close_many(fusion, [{"fused": n} for n in fused],
                          plan_cache_hit=hit)
        self._adopted_this_flush = False
        self._execute(batch, plan)
        m.flush_s.observe(time.perf_counter() - t0)
        m.flush_tensors.observe(len(batch))
        return t0

    def flush_ready(self):
        """Overlap plane: dispatch every fusion group that has FILLED,
        without waiting for the whole-set barrier or the cycle pacing
        (the JAX core's ``flush_ready``). Callers (``optim``'s
        reverse-order gradient enqueue) call it between enqueues, so a
        full bucket's collective starts while later tensors are still
        being submitted; on the card it still waits on its entries'
        ready events. Partial groups stay queued for the normal cycle.
        Under negotiation only the background thread originates
        data-plane collectives, so this wakes its cycle instead of
        draining here. No-op unless HOROVOD_OVERLAP_EAGER is on."""
        if self._shutdown or self._paused:
            return
        if not getattr(self._config, "overlap_eager", False):
            return
        if self._negotiator is not None:
            threshold = int(self._config.fusion_threshold)
            with self._queue_lock:
                queued = sum(_entry_nbytes(e) for e in self._queue
                             if e.op == ALLREDUCE)
            if queued and (threshold <= 0 or queued >= threshold):
                self._m.overlap_wakes.inc()
                self._ready_event.set()
            return
        if not self._flush_lock.acquire(False):
            return  # a cycle is already draining; it takes the queue
        try:
            with self._queue_lock:
                batch = self._take_ready_locked()
            if not batch:
                return
            m = self._m
            m.overlap_flushes.inc()
            m.overlap_tensors.inc(len(batch))
            self._run_batch(batch)
        finally:
            self._flush_lock.release()

    def _take_ready_locked(self):
        """Remove and return every queued entry of a fusion group whose
        queued bytes reached the fusion threshold. Groups are keyed as
        ``_make_plan`` buckets them (dtype, average, wire codec), so a
        drained group plans into at least one full bucket; partial
        groups and other ops stay queued in submission order.
        Deterministic given the same program and config, so
        non-negotiated drains stay matched across ranks. Caller holds
        _queue_lock."""
        threshold = int(self._config.fusion_threshold)
        if threshold <= 0 or not self._queue:
            return []
        group_bytes = {}
        keys = []
        for e in self._queue:
            if e.op != ALLREDUCE:
                keys.append(None)
                continue
            key = (fusion_mod.dtype_name(e.tensor.dtype), e.average,
                   self._codec(e))
            keys.append(key)
            group_bytes[key] = group_bytes.get(key, 0) + _entry_nbytes(e)
        ready = {k for k, b in group_bytes.items() if b >= threshold}
        if not ready:
            return []
        batch = []
        keep = collections.deque()
        for e, key in zip(self._queue, keys):
            (batch if key in ready else keep).append(e)
        self._queue.clear()
        self._queue.extend(keep)
        return batch

    def _codec(self, e):
        return compression_mod.select_codec(
            self._config, e.tensor.dtype, _entry_nbytes(e))

    def _make_plan(self, batch):
        """Group the batch's entries (FuseResponses parity): on one rank,
        allreduces bucketed per (dtype, average, wire codec) in
        submission order; with more ranks and no coordinator, one group
        per entry in submission order, since the ranks' drained batches
        need not split alike."""
        groups = []
        fused = set()
        if self._world == 1:
            by_key = collections.OrderedDict()
            for i, e in enumerate(batch):
                if e.op == ALLREDUCE:
                    by_key.setdefault((fusion_mod.dtype_name(e.tensor.dtype),
                                       e.average, self._codec(e)),
                                      []).append(i)
            for (_, average, codec), idxs in by_key.items():
                for b in fusion_mod.plan_buckets(
                        [batch[i].tensor for i in idxs],
                        self._config.fusion_threshold):
                    groups.append((ALLREDUCE, [idxs[j] for j in b.indices],
                                   average, codec))
                fused.update(idxs)
        for i, e in enumerate(batch):
            if i not in fused:
                codec = self._codec(e) if e.op == ALLREDUCE else None
                groups.append((e.op, [i], e.average, codec))
        return groups

    def _execute(self, batch, plan):
        for op, idxs, average, codec in plan:
            entries = [batch[i] for i in idxs]
            if op == ALLREDUCE and self._world == 1:
                self._finish_entries(
                    entries, lambda es, a=average, c=codec:
                    self._exec_fused_allreduce(es, a, c))
            else:
                self._finish_entries(
                    entries, lambda es: self._exec_single(es[0], es[0].op))

    # -- negotiated multi-process cycle (RunLoopOnce's coordinator
    # protocol, operations.cc:1246-1551, over the TCP control plane) --

    def _negotiated_flush_locked(self, unless_held=False):
        """One negotiation round: announce newly queued entries, apply
        every response the coordinator has ordered since our last ack.
        Runs ONLY on the background thread — all data-plane collectives
        originate here, in response-seq order, so they match across
        processes no matter how entries were submitted."""
        from . import negotiation as neg
        if self._negotiation_dead:
            self._fail_pending_negotiated(self._dead_error())
            return
        if time.monotonic() < self._cycle_backoff_until:
            return  # exponential backoff after control-plane failures
        # a retry resends the SAME request id + metas/hits, and the
        # coordinator dedupes on the id
        if self._unannounced is not None:
            metas, hit_ids = self._unannounced
        else:
            batch = self._take_queue(unless_held)
            if self.timeline and batch:
                self.timeline.mark_cycle_start()
            metas, hit_ids = [], []
            for e in batch:
                self._negotiated_pending[e.name] = e
                cached = self._neg_cache.get(e.name)
                if cached is not None:
                    if cached[1] == e.signature():
                        hit_ids.append(cached[0])  # steady-state bypass
                        self._neg_hit_count += 1
                        e.span.annotate(cache_hit=True)
                        continue
                    # signature changed: a full meta, which also makes
                    # the coordinator invalidate the id for every peer
                    del self._neg_cache[e.name]
                    self._neg_cache_ids.pop(cached[0], None)
                metas.append(self._meta_of(e, neg))
                e.span.annotate(cache_hit=False)
            # names whose cache ids came back unknown: re-announce
            for name in sorted(self._reannounce):
                e = self._negotiated_pending.get(name)
                if e is not None and all(m.name != name for m in metas):
                    metas.append(self._meta_of(e, neg))
            self._reannounce.clear()
            self._cycle_req_id += 1
        # low-rate metrics piggyback: rank 0's registry is local to the
        # aggregating server, so only workers push snapshots
        m = self._m
        reg = m.reg
        push = None
        if reg.enabled and self._rank != 0:
            now = time.monotonic()
            if now >= self._metrics_next_push:
                self._metrics_next_push = now + (
                    getattr(self._config, "metrics_interval", 5.0) or 5.0)
                push = reg.snapshot(max_events=32)
        # dump solicitation: the coordinator asked for this worker's
        # flight recorder; attach one snapshot
        flight = None
        tracer = self._tracer
        if self._flight_send_pending:
            self._flight_send_pending = False
            flight = tracer.flight_snapshot("coordinator_request")
        # numerics digest piggyback: the records of every bucket whose
        # stats have been read since the last cycle
        for cyc, recs in hvd_numerics.get_monitor().take_records().items():
            self._numerics_pending = hvd_numerics.fold_digest(
                self._numerics_pending, cyc, recs, rank=self._rank)
        digest, self._numerics_pending = self._numerics_pending, None
        t0 = time.perf_counter()
        try:
            resp = self._negotiator.cycle(
                metas, self._applied_seq, req_id=self._cycle_req_id,
                hits=neg.encode_hits(hit_ids), metrics=push, flight=flight,
                digest=digest,
                codec_fp=compression_mod.config_fingerprint(self._config))
        except Exception as exc:  # noqa: BLE001 — transient TCP hiccups
            self._unannounced = (metas, hit_ids)
            if digest is not None:
                # the retry cycle carries it instead
                self._numerics_pending = digest
            m.neg_failures.inc()
            now = time.monotonic()
            self._cycle_failures += 1
            if self._cycle_fail_since is None:
                self._cycle_fail_since = now
            # exponential backoff between retries (50 ms → 1.6 s)
            self._cycle_backoff_until = now + min(
                0.05 * (2 ** min(self._cycle_failures - 1, 5)), 1.6)
            if (self._cycle_failures >= 3 and
                    now - self._cycle_fail_since >= self._poison_grace_s):
                # the coordinator (rank 0's process) has been gone for a
                # real time window: record it, dump the flight recorder,
                # fail pending work, tell the plane if it still listens,
                # and poison this core
                reg.event("ranks_lost", ranks=[0],
                          reason="control plane unreachable",
                          trace_id=self._blocking_trace_id())
                tracer.dump("coordinator_lost")
                self._fail_pending_negotiated(RanksLostError(
                    [0], reason="negotiation control plane unreachable: "
                                f"{exc}",
                    trace_id=self._blocking_trace_id()))
                self._unannounced = None
                self._negotiation_dead = True
                try:
                    self._cycle_req_id += 1
                    self._negotiator.cycle([], self._applied_seq,
                                           shutdown=True,
                                           req_id=self._cycle_req_id)
                except Exception:  # noqa: BLE001 — plane truly gone
                    pass
            return
        m.neg_cycles.inc()
        m.neg_cycle_s.observe(time.perf_counter() - t0)
        tracer.record_cycle(
            req_id=self._cycle_req_id, ack=self._applied_seq,
            n_metas=len(metas), n_hits=len(hit_ids),
            rtt_ms=(time.perf_counter() - t0) * 1000.0)
        if getattr(resp, "dump_requested", False) and not self._flight_sent:
            self._flight_sent = True
            self._flight_send_pending = True
            tracer.dump("coordinator_request")
        self._unannounced = None
        self._cycle_failures = 0
        self._cycle_fail_since = None
        self._cycle_backoff_until = 0.0
        executed_bytes = self._apply_cycle_response(resp)
        if self.autotuner is not None and executed_bytes > 0:
            if self.autotuner.record_cycle(executed_bytes,
                                           time.perf_counter() - t0):
                # rank 0 applies directly: the coordinator fuses with
                # this config, and workers mirror it off the responses
                self._apply_suggestion()

    @staticmethod
    def _meta_of(e, neg):
        return neg.EntryMeta(e.name, e.op,
                             fusion_mod.dtype_name(e.tensor.dtype),
                             tuple(e.tensor.shape), e.root_rank, e.average)

    def _finish_entries(self, entries, exec_fn):
        """Run exec_fn over entries on the collective stream, then
        complete them: at once on the CPU, through the finalizer after
        the completion event on the card. A failure completes them with
        the error. Each entry's execute span opens here and closes in
        ``_mark_done``, once the group has completed."""
        self.executed_groups += 1
        self.executed_tensors += len(entries)
        op = entries[0].op
        self.executed_ops[op] += 1
        tracer = self._tracer
        spans = tracer.open_many(hvd_tracing.EXECUTE, [
            (e.name, e.trace_id, e.fu_span, {"op": e.op,
                                             "fused": len(entries)})
            for e in entries])
        for e, ex in zip(entries, spans):
            e.ex_span = ex
        m = self._m
        t0 = time.perf_counter()
        self._numerics_staged = None
        try:
            with self._sync.collective_stream(
                    [e.ready_event for e in entries]):
                exec_fn(entries)
                self._sync.keep_alive([e.tensor for e in entries])
                ev = self._sync.completion_event()
                # gradient health, queued behind the completion event
                self._observe_numerics(entries)
        except Exception as exc:  # noqa: BLE001 — status carries it
            self._numerics_staged = None
            self._fail(entries, exc)
            return
        m.coll_bytes.labels(op=op).inc(sum(_entry_nbytes(e)
                                           for e in entries))
        m.coll_s.labels(op=op).observe(time.perf_counter() - t0)
        for e in entries:
            if not e.event.is_set():
                e.status = True
                e.done_event = ev
        if ev is None:
            self._ef.publish()
            self._mark_done(entries)
        else:
            self._finalize_q.put((ev, entries))

    def _observe_numerics(self, entries):
        """The gradient-health side pass of an executed allreduce bucket
        (the JAX core's ``_finish_entries`` numerics block): per-slice
        stats of the reduced buffer the bucket staged (beside its local
        stats when the world has more than one rank), handed to the
        monitor, which parks them on the card and reads them at once on
        the CPU. Records of a negotiated cycle fold into the digest. On
        the card the stats run after the completion event the caller's
        stream waits on, so they read what the bucket produced only while
        the caller reads its results without writing into them, as the
        eager step and ``allreduce_gradients`` do."""
        staged, self._numerics_staged = self._numerics_staged, None
        mon = hvd_numerics.get_monitor()
        if staged is None or not mon.enabled:
            return
        names, sizes, reduced, loc_mat = staged
        mat = hvd_numerics.segment_stats(reduced, sizes)
        if loc_mat is not None:
            mat = torch.cat([mat, loc_mat], dim=1)
        cyc = self._numerics_cycle
        recs = mon.ingest_async(names, mat, cycle=cyc)
        if recs and cyc is not None:
            self._numerics_pending = hvd_numerics.fold_digest(
                self._numerics_pending, cyc, recs, rank=self._rank)
        for e in entries:
            rec = recs.get(e.name)
            if rec is not None:
                e.ex_span.annotate(
                    grad_l2=rec[hvd_numerics.R_RED_L2],
                    nonfinite=rec[hvd_numerics.R_RED_NONFINITE])

    def _fail(self, entries, exc):
        """Complete the entries not yet completed with ``exc``."""
        entries = [e for e in entries if not e.event.is_set()]
        for e in entries:
            e.status = exc
        self._mark_done(entries)

    def _mark_done(self, entries):
        # an entry completes once: one the stall deadline already failed
        # may still run when the coordinator orders it
        entries = [e for e in entries if not e.event.is_set()]
        with self._queue_lock:
            for e in entries:
                if self._tensor_table.get(e.name) is e:
                    del self._tensor_table[e.name]
        tracer = self._tracer
        ok = [e for e in entries if not isinstance(e.status, Exception)]
        for e in entries:
            if isinstance(e.status, Exception):
                for s in (e.span, e.fu_span, e.ex_span):
                    s.abort(e.status)
        tracer.close_many([e.ex_span for e in ok],
                          [{"bytes": _entry_nbytes(e)} for e in ok])
        callbacks = tracer.open_many(hvd_tracing.CALLBACK, [
            (e.name, e.trace_id, e.ex_span,
             {"n_callbacks": len(e.callbacks)}) for e in entries])
        for e in entries:
            for cb in e.callbacks:
                try:
                    cb(e)
                except Exception as exc:  # noqa: BLE001 — a callback's
                    log.error("callback of '%s' failed: %s", e.name, exc)
            e.event.set()
        tracer.close_many(callbacks)

    def _apply_cycle_response(self, resp):
        """Apply coordinator responses strictly in seq order; returns the
        bytes the executed responses moved (the autotune score's
        numerator)."""
        from . import negotiation as neg
        tracer = self._tracer
        try:
            # liveness fail-fast: the coordinator's ledger declared ranks
            # dead — pending work can never complete
            neg.raise_if_ranks_lost(resp,
                                    trace_id=self._blocking_trace_id())
        except RanksLostError as exc:
            tracer.dump("ranks_lost")
            self._fail_pending_negotiated(exc)
            self._negotiation_dead = True
            return 0
        if getattr(resp, "stale_ack", False):
            # this rank fell behind the coordinator's bounded response
            # log: fail pending work and tell the peers
            tracer.dump("stale_ack")
            self._fail_pending_negotiated(ShutdownError(
                "negotiation response log overflow: this rank fell "
                "behind the coordinator's retained window"))
            self._negotiation_dead = True
            try:
                self._cycle_req_id += 1
                self._negotiator.cycle([], self._applied_seq,
                                       shutdown=True,
                                       req_id=self._cycle_req_id)
            except Exception:  # noqa: BLE001 — plane gone too
                pass
            return 0
        executed_bytes = 0
        for off, r in enumerate(resp.responses):
            seq = resp.base_seq + off
            if seq <= self._applied_seq:
                continue
            entries = [self._negotiated_pending.pop(n)
                       for n in r.names if n in self._negotiated_pending]
            if len(entries) != len(r.names):
                # control-plane state diverged: fail cleanly rather than
                # wedge the loop on the same seqs forever
                missing = [n for n in r.names
                           if all(e.name != n for e in entries)]
                exc = ShutdownError(
                    f"control-plane state diverged: coordinator ordered "
                    f"{r.names} but {missing} are not pending here")
                self._fail(entries, exc)
                self._fail_pending_negotiated(exc)
                self._applied_seq = seq
                continue
            if self.timeline:
                for e in entries:
                    self.timeline.negotiate_end(e.name)
            # the coordinator has ordered (or errored) these tensors;
            # ``cycle`` (=seq) is the same on every rank, the cross-rank
            # stitch key
            if r.kind == r.ERROR:
                for e in entries:
                    e.span.abort(r.error)
            else:
                tracer.close_many(
                    [e.span for e in entries],
                    [{"cycles_waited": self._cycle_req_id - int(
                        getattr(e.span, "attrs", {}).get(
                            "enqueue_req", self._cycle_req_id))}
                     for e in entries], cycle=seq)
                # fusion placement was the coordinator's: this rank
                # learns its group from the response
                fusion = tracer.open_many(hvd_tracing.FUSION, [
                    (e.name, e.trace_id, e.span, {"cycle": seq})
                    for e in entries])
                tracer.close_many(fusion, fused=len(entries))
                for e, fu in zip(entries, fusion):
                    e.fu_span = fu
            if r.kind == r.EXECUTE and getattr(r, "cache_ids", None):
                # learn coordinator-assigned cache ids; riding the
                # seq-ordered log makes every rank's mapping identical
                for e, cid in zip(entries, r.cache_ids):
                    old = self._neg_cache.get(e.name)
                    if old is not None and old[0] != cid:
                        self._neg_cache_ids.pop(old[0], None)
                    self._neg_cache[e.name] = (cid, e.signature())
                    self._neg_cache_ids[cid] = e.name
            # the digest key of the bucket about to execute: seq is the
            # same on every rank
            self._numerics_cycle = seq
            if r.kind != r.ERROR:
                executed_bytes += sum(_entry_nbytes(e) for e in entries)
            if r.kind == r.ERROR:
                exc = MismatchError(r.error)
                self._fail(entries, exc)
            elif r.op == ALLREDUCE:
                codec = getattr(r, "codec", None)
                self._finish_entries(
                    entries, lambda es, c=codec: self._exec_fused_allreduce(
                        es, es[0].average, c))
            elif r.op == ALLGATHER and len(entries) > 1:
                self._finish_entries(entries, self._exec_fused_allgather)
            else:
                self._finish_entries(
                    entries, lambda es: self._exec_single(es[0], r.op))
            self._applied_seq = seq
        self._numerics_cycle = None
        for cid in getattr(resp, "unknown_ids", ()):
            # the coordinator no longer holds this id: re-announce in full
            name = self._neg_cache_ids.pop(cid, None)
            if name is not None:
                self._neg_cache.pop(name, None)
                if name in self._negotiated_pending:
                    self._reannounce.add(name)
        if resp.params and self._rank != 0:
            # mirror rank 0's knobs; fusion decisions happen at the
            # coordinator
            self._config.fusion_threshold = int(resp.params[0])
            self._config.cycle_time_ms = float(resp.params[1])
        if resp.shutdown:
            self._fail_pending_negotiated(ShutdownError())
        return executed_bytes

    def _blocking_trace_id(self):
        """Trace id of the oldest tensor still waiting on negotiation,
        the one a RanksLostError names so that its flight dump can be
        read from the span that was blocked."""
        for e in self._negotiated_pending.values():
            if e.trace_id:
                return e.trace_id
        return None

    def _dead_error(self):
        """The error of work that meets a lost control plane: a
        RanksLostError naming the ranks when that is why it was lost."""
        if self.lost_ranks:
            return RanksLostError(self.lost_ranks,
                                  reason="declared lost earlier")
        return ShutdownError("negotiation control plane lost")

    def _fail_pending_negotiated(self, exc):
        if isinstance(exc, RanksLostError):
            self.lost_ranks = exc.ranks
        self._reannounce.clear()
        with self._queue_lock:
            pending = list(self._negotiated_pending.values()) + \
                list(self._queue)
            self._negotiated_pending.clear()
            self._queue.clear()
        self._fail(pending, exc)

    # -- execution engines --

    @functools.cached_property
    def _proc_engine(self):
        return ProcessCollectiveEngine(self.group)

    def _make_hier_engine(self, local):
        """The two-level engine of the eager allreduces, or None when
        ``local`` (processes per host) does not split the world over
        more than one host (a single-host "split" is the flat engine
        with extra steps). Built whatever HOROVOD_OVERLAP_HIERARCHICAL
        says now, since the flag is read at every allreduce."""
        if self._world <= 1 or local < 1 or self._world % local or \
                self._world // local <= 1:
            if getattr(self._config, "overlap_hierarchical", False):
                log.warning(
                    "hierarchical reduction disabled: local_size %d gives "
                    "no multi-host split of %d processes", local,
                    self._world)
            return None
        return HierarchicalProcessEngine(self.group, local)

    @property
    def _hier_engine(self):
        """The two-level engine while HOROVOD_OVERLAP_HIERARCHICAL is on
        (read live) and the world splits over hosts, else None."""
        if getattr(self._config, "overlap_hierarchical", False):
            return self._hier
        return None

    def _allreduce_engine(self):
        """The engine of the eager allreduces: the two-level one under
        ``_hier_engine``, else the flat one."""
        return self._hier_engine or self._proc_engine

    def _exec_fused_allreduce(self, entries, average, codec=None):
        """One flattened buffer, ONE collective for the whole group
        (MPIAllreduce's fusion-buffer memcpy-in/allreduce/memcpy-out,
        mpi_operations.cc:25-66): concat, the sum and the un-fuse
        slicing all run on the device, on the collective stream.
        ``codec`` is the wire codec (the negotiated plan's, or this
        rank's own choice): a quantized one runs the two-phase encoded
        collective with error feedback, a cast one narrows the buffer
        for the sum."""
        tl = self.timeline
        names = [e.name for e in entries]
        if tl:
            for n in names:
                tl.start_activity(n, timeline_mod.MEMCPY_IN_FUSION_BUFFER)
        flats = [e.tensor.detach().reshape(-1) for e in entries]
        # always a new buffer: the sum is taken in place
        fused = torch.cat(flats) if len(flats) > 1 else flats[0].clone()
        if tl:
            for n in names:
                tl.end_activity(n)
                tl.start_activity(n, timeline_mod.ALLREDUCE)
        nbytes = fused.numel() * fused.element_size()
        engine = self._allreduce_engine()
        hier = engine if engine is self._hier else None
        mon = hvd_numerics.get_monitor()
        sizes = [f.numel() for f in flats]
        # this rank's contribution, before the sum takes the buffer in
        # place (on one rank the reduced buffer is the contribution)
        loc_mat = hvd_numerics.segment_stats(fused, sizes) \
            if mon.enabled and self._world > 1 else None
        if codec is not None and quant_mod.is_quantized(codec):
            summed = self._quantized_allreduce(fused, names, codec, average,
                                               hier)
        else:
            wire = fused.to(quant_mod.wire_dtype(codec)) if codec \
                else fused
            engine.allreduce(wire)
            summed = wire.to(fused.dtype) if codec else wire
            if average:
                summed = _divide(summed, self._world)
            self._sync.keep_alive([wire])
            quant_mod.account(codec, nbytes, quant_mod.wire_nbytes(wire))
            if hier is not None:
                quant_mod.account_leg("intra", None, nbytes)
                quant_mod.account_leg("inter", codec,
                                      quant_mod.wire_nbytes(wire) //
                                      hier.axes[0].size)
        self._sync.keep_alive([fused, summed])
        if tl:
            for n in names:
                tl.end_activity(n)
                tl.start_activity(n, timeline_mod.MEMCPY_OUT_FUSION_BUFFER)
        offset = 0
        for e, flat in zip(entries, flats):
            n = flat.numel()
            e.result = summed[offset:offset + n].view(e.tensor.shape)
            rel = self.test_perturb.get(e.name)
            if rel:
                e.result.mul_(1.0 + rel)
            offset += n
        if mon.enabled:
            self._numerics_staged = (names, sizes, summed, loc_mat)
        if tl:
            for n in names:
                tl.end_activity(n)

    def _quantized_allreduce(self, fused, names, codec, average, hier):
        """The quantized leg (the JAX core's ``eager.py:1269-1334``): on
        the flat engine, EF-compensate the fused buffer (keyed by its
        members' names), encode it padded to ``block · world``, run the
        two-phase collective and update the residual from this rank's
        own wire decode; on the two-level engine, the same with the
        residual at shard length (key suffix ``#hier``) and only the
        inter-host leg encoded. One rank takes the same arithmetic."""
        block = int(getattr(self._config, "quant_block",
                            quant_mod.BLOCK_DEFAULT))
        # a residual is kept only for a bucket whose members all have the
        # caller's names: a generated name is new on every submission, so
        # its residual could never be read back, only pile up
        ef_on = bool(getattr(self._config, "quant_ef", True)) and not any(
            AUTO_NAME_INFIX in n for n in names)
        total = fused.numel()
        nbytes = total * fused.element_size()
        if hier is not None:
            key = "|".join(names) + "#hier"
            shard_len = quant_mod.pad_to(
                total, block * self._world) // hier.axes[0].size
            residual = self._ef.peek(key, (shard_len,)) if ef_on else None
            full, comp, dec_own = hier.allreduce_quantized(
                fused, codec, block, average=average, residual=residual)
            if ef_on:
                self._ef.update(key, comp, dec_own, block, anchor=names[0])
            hvd_numerics.get_monitor().observe_compression(
                names[0], comp, dec_own, codec)
            wire_inter = quant_mod.encoded_nbytes(shard_len, codec, block)
            quant_mod.account(codec, nbytes, wire_inter)
            quant_mod.account_leg("intra", None, nbytes)
            quant_mod.account_leg("inter", codec, wire_inter)
            self._sync.keep_alive([full, comp, dec_own])
            return full[:total].to(fused.dtype)
        key = "|".join(names)
        comp = self._ef.compensate(key, fused) if ef_on else fused
        payload, scales = quant_mod.encode(comp, block, codec,
                                           multiple=block * self._world)
        out = self._proc_engine.allreduce_quantized(
            payload, scales, codec, block, average=average)
        # this rank's own contribution as the peers decoded it: the
        # error-feedback reference
        dec_own = quant_mod.decode(payload, scales, block, total)
        if ef_on:
            self._ef.update(key, comp, dec_own, block, anchor=names[0])
        hvd_numerics.get_monitor().observe_compression(names[0], comp,
                                                       dec_own, codec)
        if self.record_quantized:
            self.last_quantized = {"names": names, "codec": codec,
                                   "comp": comp, "out": out[:total],
                                   "compensated": comp is not fused}
        quant_mod.account(codec, nbytes,
                          quant_mod.wire_nbytes(payload, scales))
        self._sync.keep_alive([comp, payload, scales, out, dec_own])
        return out[:total].to(fused.dtype)

    def _exec_fused_allgather(self, entries):
        """Coordinator-fused allgatherv: ONE counts exchange and ONE
        payload collective for the whole group
        (Response::add_allgather_response fusion, message.h:172, with the
        per-rank displacement math of collective_operations.cc:68-134).
        Members may have different inner shapes and per-rank first dims;
        every process executes this identically because the group's
        composition rides the coordinator's seq-ordered response."""
        eng = self._proc_engine
        tl = self.timeline
        names = [e.name for e in entries]
        if tl:
            for n in names:
                tl.start_activity(n, timeline_mod.MEMCPY_IN_FUSION_BUFFER)
        tensors = [e.tensor.detach() for e in entries]
        shapes = [tuple(t.shape) for t in tensors]
        inners = [s[1:] for s in shapes]
        # scalars gather to [nproc] (rank-1 contract, as unfused)
        d0s = [s[0] if len(s) else 1 for s in shapes]
        inner_sizes = [int(torch.Size(i).numel()) for i in inners]
        flats = [t.reshape(-1) for t in tensors]
        local = torch.cat(flats) if len(flats) > 1 else flats[0]
        if tl:
            for n in names:
                tl.end_activity(n)
                tl.start_activity(n, timeline_mod.ALLGATHER)
        # one dim0-counts exchange for the whole group
        counts = eng.allgather_rows(torch.tensor(
            d0s, dtype=torch.int64, device=local.device)).cpu().tolist()
        totals = [sum(c * s for c, s in zip(row, inner_sizes))
                  for row in counts]
        maxlen = max(totals)
        if local.numel() < maxlen:
            local = torch.cat([local, local.new_zeros(maxlen -
                                                      local.numel())])
        gathered = eng.allgather_rows(local)  # [nproc, maxlen]
        self._sync.keep_alive([local, gathered])
        if tl:
            for n in names:
                tl.end_activity(n)
                tl.start_activity(n, timeline_mod.MEMCPY_OUT_FUSION_BUFFER)
        # un-fuse: rank p's chunk holds member m's rows at displacement
        # sum_{j<m} counts[p][j] * inner_sizes[j]
        for m, e in enumerate(entries):
            pieces = []
            for p, row in enumerate(counts):
                off = sum(row[j] * inner_sizes[j] for j in range(m))
                seg = gathered[p, off:off + row[m] * inner_sizes[m]]
                if len(shapes[m]):
                    seg = seg.view((row[m],) + tuple(inners[m]))
                pieces.append(seg)
            e.result = torch.cat(pieces, dim=0)
        if tl:
            for n in names:
                tl.end_activity(n)

    def _exec_single(self, entry, op):
        tl = self.timeline
        if tl:
            tl.start_activity(entry.name, op.upper())
        # without a coordinator every rank executes the same collectives
        # in the same order (errors included), so a count of them keeps
        # the tuned-value sync schedule in lockstep
        sync_params = False
        if self._autotune_sync_every:
            self._replicated_count += 1
            sync_params = (
                self._replicated_count % self._autotune_sync_every == 0)
        try:
            # without a coordinator, verify on the FIRST occurrence of
            # each collective signature (op/dtype/shape/root, not name);
            # under negotiation the coordinator already checked the metas
            if self._negotiator is None and self._world > 1:
                vkey = self._verify_key(entry, op)
                if vkey not in self._verified_sigs:
                    self._verify_cross_process(entry, op)
                    if len(self._verified_sigs) >= 65536:
                        self._verified_sigs.clear()
                    self._verified_sigs.add(vkey)
            if op == ALLREDUCE:
                self._exec_fused_allreduce([entry], entry.average,
                                           self._codec(entry))
            elif op == ALLGATHER:
                entry.result = self._allgather_one(entry)
            elif op == BROADCAST:
                entry.result = self._proc_engine.broadcast(
                    entry.tensor.detach().clone(), int(entry.root_rank))
            elif op == REDUCESCATTER:
                entry.result = self._reducescatter_one(entry)
            elif op == ALLTOALL:
                entry.result = self._alltoall_one(entry)
            else:
                raise ValueError(f"Unknown op {op}")
        finally:
            if sync_params:
                self._sync_tuned_params()
            if tl:
                tl.end_activity(entry.name)

    _META_DIMS = 10

    def _verify_key(self, entry, op):
        """What _verify_cross_process compares, minus the name."""
        shape = tuple(entry.tensor.shape)
        vshape = shape[1:] if op == ALLGATHER else shape
        return (op, fusion_mod.dtype_name(entry.tensor.dtype), len(shape),
                vshape, int(entry.root_rank))

    def _verify_cross_process(self, entry, op):
        """Cross-process shape/dtype/op agreement before the collective —
        the coordinator's error checking (ConstructResponse,
        operations.cc:209-371) without its negotiation: one fixed-size
        metadata allgather; mismatches raise MismatchError naming the
        tensor instead of hanging or crashing inside the transport.
        Allgather tolerates differing first dims."""
        shape = tuple(entry.tensor.shape)
        meta = [0] * self._META_DIMS
        meta[0] = _OPS.index(op)
        meta[1] = zlib.crc32(fusion_mod.dtype_name(
            entry.tensor.dtype).encode()) & 0x7FFFFFFF
        meta[2] = int(entry.root_rank)
        meta[3] = len(shape)
        if len(shape) <= self._META_DIMS - 4:
            meta[4:4 + len(shape)] = shape
        else:
            # rank exceeds the descriptor: compare a shape digest
            vshape = shape[1:] if op == ALLGATHER else shape
            meta[4] = zlib.crc32(str(vshape).encode()) & 0x7FFFFFFF
        mine = torch.tensor(meta, dtype=torch.int64,
                            device=entry.tensor.device)
        all_meta = self._proc_engine.allgather_rows(mine).cpu().tolist()
        for p, other in enumerate(all_meta):
            if other[:4] != meta[:4]:
                same = False
            elif len(shape) > self._META_DIMS - 4:
                same = other[4] == meta[4]
            else:
                start = 5 if op == ALLGATHER else 4
                same = other[start:] == meta[start:]
            if not same:
                raise MismatchError(
                    f"Mismatched {op} '{entry.name}' across processes: "
                    f"process {self._rank} submitted op={meta[0]} "
                    f"dtype_id={meta[1]} root={meta[2]} shape={shape}, "
                    f"process {p} submitted op={other[0]} dtype_id="
                    f"{other[1]} root={other[2]} shape="
                    f"{tuple(other[4:4 + other[3]])} (ConstructResponse "
                    f"checks, operations.cc:209-371).")

    def _allgather_one(self, entry):
        """Cross-process allgatherv: first dims may differ per rank
        (MPI_Allgatherv recvcounts/displacements,
        mpi_operations.cc:142): exchange dim-0 sizes, pad to the max,
        gather, slice each rank's true extent back out."""
        eng = self._proc_engine
        t = entry.tensor.detach()
        if t.dim() == 0:
            return eng.allgather_rows(t)  # → [nproc]
        counts = eng.allgather_rows(torch.tensor(
            [t.shape[0]], dtype=torch.int64, device=t.device))[:, 0]
        counts = counts.cpu().tolist()
        top = max(counts)
        if t.shape[0] < top:
            t = torch.cat([t, t.new_zeros((top - t.shape[0],) +
                                          tuple(t.shape[1:]))])
        else:
            t = t.contiguous()
        gathered = eng.allgather_rows(t)
        if all(c == top for c in counts):
            return gathered.reshape((-1,) + tuple(gathered.shape[2:]))
        return torch.cat([gathered[p, :c] for p, c in enumerate(counts)])

    def _reducescatter_one(self, entry):
        """Each worker gets its 1/world block of the elementwise sum
        (nccl_operations.cc:269)."""
        t = entry.tensor.detach()
        if t.dim() == 0 or t.shape[0] % self._world:
            raise MismatchError(
                f"reducescatter '{entry.name}': first dim "
                f"{tuple(t.shape)[:1]} not divisible by world size "
                f"{self._world}.")
        out = self._proc_engine.reducescatter(t.contiguous())
        return _divide(out, self._world) if entry.average else out

    def _alltoall_one(self, entry):
        """Worker j's block i goes to worker i (MPI_Alltoall semantics;
        an extension — the reference exposes no alltoall)."""
        t = entry.tensor.detach()
        if t.dim() == 0 or t.shape[0] % self._world:
            raise MismatchError(
                f"alltoall '{entry.name}': first dim "
                f"{tuple(t.shape)[:1]} not divisible by world size "
                f"{self._world}.")
        return self._proc_engine.alltoall(t.contiguous())

    # -- stall detection (CheckForStalledTensors, operations.cc:688-769) --

    def _check_stalled(self):
        if self._config.stall_check_disable:
            return
        now = time.monotonic()
        warn = self._config.stall_warning_time_seconds
        kill = self._config.stall_shutdown_time_seconds
        with self._queue_lock:
            pending = list(self._tensor_table.values())
        stalled = [e for e in pending if now - e.enqueue_time > warn]
        m = self._m
        # recomputed every scan, so it clears when laggards arrive
        m.stalled_tensors.set(len(stalled))
        new = [e for e in stalled if e.name not in self._stall_warned]
        if new:
            names = ", ".join(
                f"{e.name} [trace {e.trace_id}]" if e.trace_id else e.name
                for e in new)
            m.reg.event(
                "stall", tensors=sorted(e.name for e in new),
                deadline_s=warn,
                trace_ids=sorted(e.trace_id for e in new if e.trace_id))
            log.warning(
                "One or more tensors were submitted to be reduced, gathered "
                "or broadcasted by subset of ranks and are waiting for "
                "remainder of ranks for more than %ss: %s", warn, names)
            self._stall_warned.update(e.name for e in new)
        if kill > 0:
            dead = [e for e in pending if now - e.enqueue_time > kill]
            if dead:
                m.stall_kills.inc(len(dead))
                m.reg.event(
                    "stall_kill", tensors=sorted(e.name for e in dead),
                    deadline_s=kill,
                    trace_ids=sorted(e.trace_id for e in dead
                                     if e.trace_id))
                self._tracer.dump("stall_kill")
                exc = StalledError(
                    f"Collectives stalled past shutdown deadline: "
                    f"{', '.join(e.name for e in dead)} (traces: "
                    f"{', '.join(e.trace_id or '?' for e in dead)})")
                # a killed entry stays pending under negotiation: if the
                # coordinator orders it after all, this rank still runs
                # the collective its peers run
                with self._queue_lock:
                    for e in dead:
                        try:
                            self._queue.remove(e)
                        except ValueError:
                            pass
                self._fail(dead, exc)

    # -- shutdown (horovod_shutdown, operations.cc:1101-1122) --

    def shutdown(self):
        """Stop the core: a final drain and shutdown announcement under
        negotiation, then every pending handle fails with
        ShutdownError."""
        self._shutdown = True
        self._ready_event.set()   # wake the loop out of its cycle wait
        if self._thread.is_alive():
            self._thread.join(timeout=2)
        if self._negotiator is not None and not self._negotiation_dead:
            # apply the responses the coordinator ALREADY ordered (the
            # peers will execute those collectives), then the shutdown
            # flag makes the coordinator ERROR anything ready later
            try:
                self._cycle_req_id += 1
                resp = self._negotiator.cycle([], self._applied_seq,
                                              shutdown=True,
                                              req_id=self._cycle_req_id)
                if not self._thread.is_alive():
                    # single-origin: only when the loop is really gone
                    self._apply_cycle_response(resp)
            except Exception:  # noqa: BLE001 — peer may already be gone
                pass
        with self._queue_lock:
            pending = list(self._tensor_table.values())
            self._queue.clear()
            self._negotiated_pending.clear()
        if self._finalizer is not None:
            # completions already queued land before the pending fail
            self._finalize_q.put(None)
            self._finalizer.join(timeout=30)
        exc = ShutdownError()
        self._fail(pending, exc)
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        if self._negotiator is not None:
            self._negotiator.close()
            self._negotiator = None
        if self.timeline:
            self.timeline.close()
            self.timeline = None
