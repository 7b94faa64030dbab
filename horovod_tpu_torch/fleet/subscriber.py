"""Replica-side weight subscription, the port of
``horovod_tpu/fleet/subscriber.py``.

A ``WeightSubscriber`` turns the publisher's pointer file into armed,
swap-ready weight trees without stalling decode::

    idle --poll: new generation--> loading --verified--> armed
      ^                               |                    |
      |                               +--bad manifest------+--> refused
      +------- take_armed() (the engine swaps at a step boundary)

``poll()`` is called from ``ServeEngine.step()`` once per step; it is
rate-limited (HVD_FLEET_POLL_S) and its fast path is ONE stat of the
publication pointer (``checkpoint.manifest_signature``). A changed
signature starts a daemon thread that restores the generation through the
checkpoint plane, checksum-verifies it (HVD_FLEET_VERIFY), moves it to the
device and only then makes it visible as the armed standby; the buffer is
double (latest wins), so the engine never sees a half-loaded tree. Corrupt
or structurally mismatched generations are refused loudly (the
``fleet_refuse`` event, ``hvd_fleet_refusals_total{reason}``), remembered
so one bad publish cannot livelock the poller, and leave the serving
generation untouched.

The device transfer is where the port differs from ``jax.device_put``. On
a CUDA device the loader thread pins each restored host tensor and copies
it with ``non_blocking=True`` on a ``torch.cuda.Stream`` of its own, so
the copy neither serializes with decode on the engine's stream nor blocks
the host on a pageable copy; it records a ``torch.cuda.Event`` after the
last copy into the ``ArmedGeneration``, which the engine waits on (and
``record_stream``s the leaves onto its own stream) before its first read.
On the CPU the transfer is a no-op. A failed transfer is refused as
``error`` and re-raised on the engine thread: there is no fallback to the
CPU or to a synchronous copy.
"""

import threading
import time

import numpy as np
import torch

from ..common import config
from ..common.device import resolve_device
from ..common.exceptions import CheckpointError, CorruptCheckpointError
from ..utils import checkpoint as hvd_checkpoint
from ..utils import lockdep
from ..utils import metrics as hvd_metrics


def map_tree(fn, tree):
    """``tree`` (nested dicts, lists and tuples) with ``fn`` applied to
    every leaf; None stays an empty subtree."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def tree_leaves(tree):
    """The leaves of ``tree``, in ``map_tree``'s order."""
    out = []
    map_tree(out.append, tree)
    return out


def _host_template(like):
    """``like`` with each tensor leaf replaced by an empty CPU tensor of
    its dtype: the restore keeps the dtypes and stays on the host, and
    the device copy is this module's own."""
    if like is None:
        return None
    return map_tree(lambda t: torch.empty(0, dtype=t.dtype)
                    if isinstance(t, torch.Tensor) else t, like)


def _tree_device(like):
    for leaf in tree_leaves(like) if like is not None else ():
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


class ArmedGeneration:
    """A fully loaded + verified weight generation, ready to swap.
    Timestamps (subscriber clock) bound the swap-latency phases the
    engine reports: detect -> loaded -> armed -> swapped. ``event`` is
    the CUDA event recorded on the loader's copy stream after the tree's
    last copy (None on the CPU): the engine waits on it before reading
    ``params``."""

    __slots__ = ("generation", "step", "params", "extra",
                 "detect_ts", "loaded_ts", "armed_ts", "event")

    def __init__(self, generation, step, params, extra,
                 detect_ts, loaded_ts, armed_ts, event=None):
        self.generation = generation
        self.step = step
        self.params = params
        self.extra = extra
        self.detect_ts = detect_ts
        self.loaded_ts = loaded_ts
        self.armed_ts = armed_ts
        self.event = event


class WeightSubscriber:
    """Watch a checkpoint directory for published weight generations.

    ``like`` is the replica's parameter template (the structure to
    rebuild into, checked against the manifest's leaf names: a trainer
    that changed the model's shape is refused instead of arming a
    scrambled tree); for a ``ServeEngine`` it is the model's parameters
    by name (``serving_tree``). ``replica`` labels this subscriber's
    gauges. ``device_put`` (default on) moves loaded trees to the device
    of ``like``'s tensors (CUDA when it holds none) on the background
    thread, which keeps the transfer off the decode path.
    """

    def __init__(self, directory, like=None, replica=0,
                 poll_interval_s=None, verify=None, device_put=True,
                 clock=time.monotonic):
        self.directory = directory
        self.like = like
        self.replica = int(replica)
        self.poll_interval_s = (
            config.env_float("FLEET_POLL_S", 0.5)
            if poll_interval_s is None else float(poll_interval_s))
        self.verify = (config.env_bool("FLEET_VERIFY", True)
                       if verify is None else bool(verify))
        self.device_put = bool(device_put)
        self.device = (resolve_device(_tree_device(like))
                       if self.device_put else None)
        self.clock = clock
        self._host_like = _host_template(like)
        self._stream = None       # loader thread only: its copy stream
        self._lock = lockdep.lock("WeightSubscriber._lock")
        self._thread = None       # guarded_by: _lock
        self._armed = None        # guarded_by: _lock; standby buffer
        self._current_gen = None  # guarded_by: _lock; last gen taken
        self._refused = {}        # guarded_by: _lock; gen -> reason
        self._error = None        # guarded_by: _lock; loader crash
        # engine-thread-only scratch
        self._last_sig = None
        self._last_poll = None
        reg = self._metrics = hvd_metrics.get_registry()
        lab = {"replica": str(self.replica)}
        self._m_inprog = reg.gauge(
            "hvd_fleet_swap_in_progress",
            "1 while a published generation is loading or armed but "
            "not yet swapped in by this replica's engine.",
            labels=("replica",)).labels(**lab)
        self._m_refusals = reg.counter(
            "hvd_fleet_refusals_total",
            "Published generations this replica refused to arm, by "
            "reason (corrupt/mismatch/missing/error). The old "
            "generation keeps serving.", labels=("reason",))

    # -- queries -------------------------------------------------------

    @property
    def current_generation(self):
        """The generation this replica last took (or loaded at start)."""
        with self._lock:
            return self._current_gen

    @property
    def armed(self):
        """The armed standby ``ArmedGeneration`` (None when nothing is
        armed), left in place."""
        with self._lock:
            return self._armed

    @property
    def armed_generation(self):
        """The standby generation loaded + verified but not yet swapped
        in (None when nothing is armed). The router's canary controller
        reads it through the engine's load snapshot."""
        with self._lock:
            return (self._armed.generation if self._armed is not None
                    else None)

    @property
    def refusals(self):
        """{generation: reason} for every publish this replica refused."""
        with self._lock:
            return dict(self._refused)

    # -- startup -------------------------------------------------------

    def load_initial(self):
        """Blocking load of the newest published generation (replica
        startup, before traffic). Returns an ArmedGeneration, not queued
        as a swap: hand its params and generation to the engine, or None
        when nothing is published yet. A corrupt initial load raises: it
        is a startup error, not a refusal."""
        latest = hvd_checkpoint.latest_manifest(self.directory)
        if latest is None:
            return None
        step, _d, manifest = latest
        gen = int(manifest.get("generation", 0))
        rec = self._restore(gen, step, self.clock())
        if rec.event is not None:
            rec.event.synchronize()
        with self._lock:
            self._current_gen = gen
        self._last_sig = hvd_checkpoint.manifest_signature(self.directory)
        return rec

    # -- the watch loop (driven by ServeEngine.step) -------------------

    def poll(self, force=False):
        """One watch tick: a clock read, then (rate-limited) one stat.
        Starts a background load when the pointer names a generation
        newer than the current and the armed one, and returns True
        exactly then. Re-raises a loader crash here, on the engine
        thread."""
        self._raise_if_failed()
        now = self.clock()
        if not force and self._last_poll is not None and \
                now - self._last_poll < self.poll_interval_s:
            return False
        self._last_poll = now
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False  # a load is already in flight
        sig = hvd_checkpoint.manifest_signature(self.directory)
        if sig is not None and sig == self._last_sig and not force:
            return False
        latest = hvd_checkpoint.latest_manifest(self.directory)
        if latest is None:
            return False
        self._last_sig = sig
        step, _d, manifest = latest
        gen = int(manifest.get("generation", 0))
        with self._lock:
            if gen in self._refused:
                return False
            if self._current_gen is not None and gen <= self._current_gen:
                return False
            if self._armed is not None and gen <= self._armed.generation:
                return False
            thread = threading.Thread(
                target=self._load, args=(gen, step, now),
                name=f"hvd-fleet-subscriber-{self.replica}", daemon=True)
            self._thread = thread
        self._m_inprog.set(1)
        thread.start()
        return True

    def take_armed(self, expected=None):
        """Pop the armed standby (None when nothing is ready); the taken
        generation becomes current. The engine calls this at the step
        boundary and swaps. ``expected`` (a record read from ``armed``)
        takes that record even if a newer one replaced it in the standby
        buffer meanwhile, which then stays armed: the tensor-parallel
        engine's ranks take the generation they agreed on."""
        with self._lock:
            if expected is None:
                rec, self._armed = self._armed, None
            else:
                rec = expected
                if self._armed is expected:
                    self._armed = None
            if rec is not None:
                self._current_gen = rec.generation
            idle = self._armed is None
        if rec is not None and idle:
            self._m_inprog.set(0)
        return rec

    def wait(self, timeout=30.0):
        """Join an in-flight background load (tests and drills; the
        engine never needs this). Returns True when idle."""
        with self._lock:
            thread = self._thread
        if thread is not None:
            thread.join(timeout)
        self._raise_if_failed()
        with self._lock:
            return self._thread is None or not self._thread.is_alive()

    # -- background loader ---------------------------------------------

    def _restore(self, gen, step, detect_ts):
        tree, got_step, extra = hvd_checkpoint.restore_with_extra(
            self.directory, like=self._host_like, step=step,
            verify=self.verify)
        loaded_ts = self.clock()
        event = None
        if self.device_put and self.device.type == "cuda":
            tree, event = self._to_device(tree)
        return ArmedGeneration(gen, got_step, tree, extra,
                               detect_ts, loaded_ts, self.clock(), event)

    def _to_device(self, tree):
        """Pin every host leaf and copy it to the device on this
        subscriber's own stream, without blocking the host; returns the
        device tree and the event recorded after the last copy. The
        pinned buffers come from the caching host allocator, which keeps
        each one until its copy has run."""
        def copy(leaf):
            host = torch.as_tensor(np.asarray(leaf)) \
                if not isinstance(leaf, torch.Tensor) else leaf
            return host.pin_memory().to(self.device, non_blocking=True)

        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._stream):
                out = map_tree(copy, tree)
                event = torch.cuda.Event()
                event.record(self._stream)
        return out, event

    def _load(self, gen, step, detect_ts):
        try:
            rec = self._restore(gen, step, detect_ts)
            with self._lock:
                # double buffer, latest wins: the standby is only ever a
                # complete, verified tree; a newer publish replaces an
                # untaken one
                self._armed = rec
        except CorruptCheckpointError as e:
            self._refuse(gen, step, "corrupt", e)
        except FileNotFoundError as e:
            self._refuse(gen, step, "missing", e)
        except (CheckpointError, OSError) as e:
            self._refuse(gen, step, "mismatch", e)
        except BaseException as e:  # stored, re-raised on the engine thread
            self._refuse(gen, step, "error", e)
            with self._lock:
                self._error = e
        finally:
            with self._lock:
                self._thread = None

    def _refuse(self, gen, step, reason, err):
        with self._lock:
            self._refused[gen] = reason
        self._m_refusals.labels(reason=reason).inc()
        self._m_inprog.set(0)
        self._metrics.event(
            "fleet_refuse", replica=self.replica, generation=gen,
            step=int(step), reason=reason, error=str(err)[:200])

    def _raise_if_failed(self):
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise CheckpointError(
                f"background weight load failed: {err!r}") from err
