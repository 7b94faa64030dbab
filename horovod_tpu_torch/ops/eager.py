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

Left for the observability slice: the JAX core's metrics, numerics,
tracing-span and lockdep calls, and the autotuner (``HOROVOD_AUTOTUNE``
raises here until then).
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
from ..utils import timeline as timeline_mod
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


def _divide(t, n):
    if t.is_floating_point():
        return t / n
    return torch.div(t, n, rounding_mode="floor")


class TensorTableEntry:
    """Parity: TensorTableEntry (common.h:167-184)."""

    __slots__ = ("name", "op", "tensor", "root_rank", "average", "handle",
                 "result", "status", "event", "enqueue_time", "ready_event",
                 "done_event", "callbacks")

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

    def signature(self):
        return (self.op, self.name, tuple(self.tensor.shape),
                fusion_mod.dtype_name(self.tensor.dtype), self.root_rank,
                self.average)


class HandleManager:
    """Integer async handles (torch/handle_manager.h:30-41)."""

    def __init__(self):
        self._lock = threading.Lock()
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

    def get(self, key):
        plan = self._cache.get(key)
        if plan is not None:
            self._cache.move_to_end(key)
            self.hits += 1
        else:
            self.misses += 1
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
        if getattr(self._config, "autotune", False):
            raise NotImplementedError(
                "HOROVOD_AUTOTUNE: the autotuner is not ported yet; it "
                "comes with the observability planes (slice 8, "
                "ROADMAP.md). Unset HOROVOD_AUTOTUNE.")
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
        self._queue_lock = threading.Lock()
        self._tensor_table = {}  # guarded_by: _queue_lock; name -> entry
        self._flush_lock = threading.Lock()
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
        self._hier = self._make_hier_engine(state.local_size)
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
        self._finalize_q = queue.SimpleQueue()
        self._finalizer = None
        if self._sync.cuda:
            self._finalizer = threading.Thread(
                target=self._finalize_loop, daemon=True,
                name="hvd-finalizer")
            self._finalizer.start()
        self._thread = threading.Thread(
            target=self._background_loop, daemon=True, name="hvd-background")
        self._thread.start()

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
        with self._queue_lock:
            names = [e.name for e in entries]
            for i, n in enumerate(names):
                if n in self._tensor_table or n in names[:i]:
                    raise DuplicateNameError(n)
            for e in entries:
                self._tensor_table[e.name] = e
                self._queue.append(e)
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
        lands in one cycle on the next flush."""
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
                self.flush(blocking=False)
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
                self.flush()
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
            self._mark_done(entries)

    def flush(self, blocking=True):
        """Drain the queue and execute everything in it (one cycle)."""
        if not self._flush_lock.acquire(blocking):
            return
        try:
            self._flush_locked()
        finally:
            self._flush_lock.release()

    def _flush_locked(self):
        if self._negotiator is not None:
            self._negotiated_flush_locked()
            return
        with self._queue_lock:
            batch = list(self._queue)
            self._queue.clear()
        if batch:
            self._run_batch(batch)

    def _run_batch(self, batch):
        """Plan + execute one drained batch — the body of a
        non-negotiated cycle. Caller holds _flush_lock."""
        if self.timeline:
            self.timeline.mark_cycle_start()
            for e in batch:
                self.timeline.negotiate_end(e.name)
        key = (int(self._config.fusion_threshold),
               compression_mod.config_fingerprint(self._config),
               tuple(e.signature() for e in batch))
        plan = self.plan_cache.get(key)
        if plan is None:
            plan = self._make_plan(batch)
            self.plan_cache.put(key, plan)
        self._execute(batch, plan)

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

    def _negotiated_flush_locked(self):
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
            with self._queue_lock:
                batch = list(self._queue)
                self._queue.clear()
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
                        continue
                    # signature changed: a full meta, which also makes
                    # the coordinator invalidate the id for every peer
                    del self._neg_cache[e.name]
                    self._neg_cache_ids.pop(cached[0], None)
                metas.append(self._meta_of(e, neg))
            # names whose cache ids came back unknown: re-announce
            for name in sorted(self._reannounce):
                e = self._negotiated_pending.get(name)
                if e is not None and all(m.name != name for m in metas):
                    metas.append(self._meta_of(e, neg))
            self._reannounce.clear()
            self._cycle_req_id += 1
        try:
            resp = self._negotiator.cycle(
                metas, self._applied_seq, req_id=self._cycle_req_id,
                hits=neg.encode_hits(hit_ids),
                codec_fp=compression_mod.config_fingerprint(self._config))
        except Exception as exc:  # noqa: BLE001 — transient TCP hiccups
            self._unannounced = (metas, hit_ids)
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
                # real time window: fail pending work, tell the plane if
                # it still listens, and poison this core
                self._fail_pending_negotiated(RanksLostError(
                    [0], reason="negotiation control plane unreachable: "
                                f"{exc}"))
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
        self._unannounced = None
        self._cycle_failures = 0
        self._cycle_fail_since = None
        self._cycle_backoff_until = 0.0
        self._apply_cycle_response(resp)

    @staticmethod
    def _meta_of(e, neg):
        return neg.EntryMeta(e.name, e.op,
                             fusion_mod.dtype_name(e.tensor.dtype),
                             tuple(e.tensor.shape), e.root_rank, e.average)

    def _finish_entries(self, entries, exec_fn):
        """Run exec_fn over entries on the collective stream, then
        complete them: at once on the CPU, through the finalizer after
        the completion event on the card. A failure completes them with
        the error."""
        self.executed_groups += 1
        self.executed_tensors += len(entries)
        self.executed_ops[entries[0].op] += 1
        try:
            with self._sync.collective_stream(
                    [e.ready_event for e in entries]):
                exec_fn(entries)
                self._sync.keep_alive([e.tensor for e in entries])
                ev = self._sync.completion_event()
        except Exception as exc:  # noqa: BLE001 — status carries it
            self._fail(entries, exc)
            return
        for e in entries:
            if not e.event.is_set():
                e.status = True
                e.done_event = ev
        if ev is None:
            self._mark_done(entries)
        else:
            self._finalize_q.put((ev, entries))

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
        for e in entries:
            for cb in e.callbacks:
                try:
                    cb(e)
                except Exception as exc:  # noqa: BLE001 — a callback's
                    log.error("callback of '%s' failed: %s", e.name, exc)
            e.event.set()

    def _apply_cycle_response(self, resp):
        """Apply coordinator responses strictly in seq order."""
        from . import negotiation as neg
        try:
            # liveness fail-fast: the coordinator's ledger declared ranks
            # dead — pending work can never complete
            neg.raise_if_ranks_lost(resp)
        except RanksLostError as exc:
            self._fail_pending_negotiated(exc)
            self._negotiation_dead = True
            return
        if getattr(resp, "stale_ack", False):
            # this rank fell behind the coordinator's bounded response
            # log: fail pending work and tell the peers
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
            return
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
            if r.kind == r.EXECUTE and getattr(r, "cache_ids", None):
                # learn coordinator-assigned cache ids; riding the
                # seq-ordered log makes every rank's mapping identical
                for e, cid in zip(entries, r.cache_ids):
                    old = self._neg_cache.get(e.name)
                    if old is not None and old[0] != cid:
                        self._neg_cache_ids.pop(old[0], None)
                    self._neg_cache[e.name] = (cid, e.signature())
                    self._neg_cache_ids[cid] = e.name
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
        with extra steps). Built whatever HOROVOD_HIERARCHICAL_ALLREDUCE
        says now, since the flag is read at every allreduce."""
        if self._world <= 1 or local < 1 or self._world % local or \
                self._world // local <= 1:
            if getattr(self._config, "hierarchical_allreduce", False):
                log.warning(
                    "hierarchical reduction disabled: local_size %d gives "
                    "no multi-host split of %d processes", local,
                    self._world)
            return None
        return HierarchicalProcessEngine(self.group, local)

    def _allreduce_engine(self):
        """The engine of the eager allreduces: the two-level one while
        HOROVOD_HIERARCHICAL_ALLREDUCE is on (read live) and the world
        splits over hosts, else the flat one."""
        if self._hier is not None and \
                getattr(self._config, "hierarchical_allreduce", False):
            return self._hier
        return self._proc_engine

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
            offset += n
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
        new = [e for e in stalled if e.name not in self._stall_warned]
        if new:
            log.warning(
                "One or more tensors were submitted to be reduced, gathered "
                "or broadcasted by subset of ranks and are waiting for "
                "remainder of ranks for more than %ss: %s", warn,
                ", ".join(e.name for e in new))
            self._stall_warned.update(e.name for e in new)
        if kill > 0:
            dead = [e for e in pending if now - e.enqueue_time > kill]
            if dead:
                exc = StalledError(
                    f"Collectives stalled past shutdown deadline: "
                    f"{', '.join(e.name for e in dead)}")
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
        if self._negotiator is not None:
            self._negotiator.close()
            self._negotiator = None
        if self.timeline:
            self.timeline.close()
            self.timeline = None
