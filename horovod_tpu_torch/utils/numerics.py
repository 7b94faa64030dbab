"""Numerics observability plane: gradient health + divergence digests.

The port of ``horovod_tpu/utils/numerics.py``. The metrics plane answers
"how much / how fast", the tracing plane "why is rank 7 stalled"; this
module answers "is the math still right". Two layers:

**Per-tensor gradient health.** ``tensor_stats`` computes the L2 norm,
max-abs, nan/inf count, zero fraction and a checksum of one tensor;
``segment_stats`` the same for every tensor of a fused buffer at once:
on the card one hand-written kernel (``csrc/segment_stats.cu``, two
launches whatever the tensor count, the reference's one compiled pass
per slice layout), on the CPU its plain torch version
``segment_stats_plain``. Both are queued on the current CUDA stream
behind the gradients they read (the eager core queues them on its
collective stream after a bucket's completion event, so no caller waits
on them). ``NumericsMonitor.observe`` / ``ingest_async`` park the
result with one CUDA event per call (the stats matrix is copied
into pinned host memory, taken from a small pool the monitor reuses,
on the same stream before the event), and the host reads a group once
``event.query()`` is true: a flush never synchronizes a stream. On the
CPU the stats are read at once. The policy then publishes
``hvd_grad_norm{tensor}`` and its EMA drift, the ``hvd_nonfinite_total``
counter, and flags an anomaly on a nan/inf or on an L2 norm above
``HOROVOD_NUMERICS_EMA_K`` times its moving average: ``numerics_anomaly``
event -> warning -> one flight dump.

**Cross-rank divergence sentinel.** Replicas of one allreduce must hold
identical post-reduce state. Each cycle's per-tensor records fold into a
digest (``fold_digest``) that piggybacks on ``CycleRequest.digest``, and
the coordinator (``ops/negotiation.py`` ``_numerics_scan``) compares
them across ranks: a disagreement beyond ``HOROVOD_NUMERICS_TOLERANCE``
names the divergent rank, the tensor and the first bad cycle. On the
card a record reaches the digest when its stats are read, a cycle or
more after the bucket ran; the coordinator keys records by cycle, so
they line up all the same.

The port's record carries one field more than the JAX package's: the
local checksum (``R_LOC_SUM``, appended, so the first seven fields keep
the reference's layout). ``blame_rank`` uses it where the reference's
rule cannot decide: with two holders the local-L2 outlier rule is
symmetric (both sit equally far from their median, and the reference
blames the lower rank), while the reduced checksum of a correct replica
equals the sum (or mean) of the local checksums, the one linear
statistic of the records, so the replica whose checksum strays from it
is the one that diverged.

On by default under the reference's <=2 % overhead contract, which
``overhead_gate`` holds as ``bench.py``'s ``_bench_numerics_overhead``
does; ``HVD_NUMERICS=0`` lands every call on a shared null object.
"""

import collections
import math
import threading

import torch

from ..common import hvd_logging as log
from ..common.config import env_bool, env_float, env_int
from ..ops._build import extension
from . import lockdep
from . import metrics as metrics_mod
from . import tracing as tracing_mod

DIGEST_VERSION = 1

# stats row layout (one float32 row per tensor)
S_L2, S_MAX_ABS, S_NONFINITE, S_ZERO_FRAC, S_CHECKSUM = range(5)

# per-tensor digest record: reduced (post-allreduce) stats first, local
# (pre-reduce) second; the reference's seven fields, then the local
# checksum
R_RED_L2, R_RED_MAX, R_RED_NONFINITE, R_RED_SUM, \
    R_LOC_L2, R_LOC_MAX, R_LOC_NONFINITE, R_LOC_SUM = range(8)

ANOMALY_NONFINITE = "nonfinite"
ANOMALY_NORM_SPIKE = "norm_spike"
ANOMALY_DIVERGENCE = "divergence"

# pinned host buffers the monitor keeps for reuse, per (shape, dtype)
_PINNED_KEEP = 4

# EMA floor below which the norm-spike policy stays disarmed: an all-zero
# warmup must not flag the first real gradient as an explosion
_EMA_FLOOR = 1e-12


def numerics_enabled():
    """Master gate (HVD_NUMERICS; default on)."""
    return env_bool("NUMERICS", True)


def tolerance():
    """Relative cross-rank disagreement tolerance for digest records
    (HVD_NUMERICS_TOLERANCE)."""
    return env_float("NUMERICS_TOLERANCE", 1e-4)


def digest_window():
    """How many recent cycles the coordinator retains digests for
    (HVD_NUMERICS_DIGEST_CYCLES)."""
    return max(1, env_int("NUMERICS_DIGEST_CYCLES", 32))


def tensor_stats(x):
    """Gradient-health stats of one tensor, on its device: a dict of 0-d
    float32 tensors. ``l2``/``max_abs``/``checksum`` are over the finite
    values (a NaN burst must not wipe out the norm that describes it),
    ``nonfinite`` is the nan/inf count, ``zero_frac`` the exact-zero
    fraction."""
    f = x.detach().reshape(-1).float()
    if f.numel() == 0:
        z = f.new_zeros(())
        return {"l2": z, "max_abs": z, "nonfinite": z, "zero_frac": z,
                "checksum": z}
    finite = torch.isfinite(f)
    safe = torch.where(finite, f, f.new_zeros(()))
    return {
        "l2": torch.sqrt(torch.sum(safe * safe)),
        "max_abs": torch.max(torch.abs(safe)),
        "nonfinite": (f.numel() - torch.sum(finite)).float(),
        "zero_frac": torch.mean((f == 0.0).float()),
        "checksum": torch.sum(safe),
    }


def stats_vector(x):
    """``tensor_stats`` as one [5] float32 tensor (S_* layout)."""
    s = tensor_stats(x)
    return torch.stack([s["l2"], s["max_abs"], s["nonfinite"],
                        s["zero_frac"], s["checksum"]])


# elements per row of the additive statistics: a row's sums are taken in
# float32, exact for the counts of a row this short
_CHUNK = 255

_LAYOUTS = collections.OrderedDict()  # (sizes, device) -> index tensors
_LAYOUTS_MAX = 256


def _layout(sizes, device):
    """The cached index tensors of one slice layout on ``device``. The
    buffer is read as rows of ``_CHUNK`` elements; each slice boundary
    (0, then the end of every slice) has its row and a mask of that
    row's lanes before it. Also the reciprocal element counts, and which
    slices are not empty. Built once per layout, so the flush path makes
    no host-to-device copy."""
    key = (sizes, str(device))
    hit = _LAYOUTS.get(key)
    if hit is not None:
        _LAYOUTS.move_to_end(key)
        return hit
    bounds, acc = [0], 0
    for n in sizes:
        acc += n
        bounds.append(acc)
    rows = torch.tensor([b // _CHUNK for b in bounds], dtype=torch.long)
    lanes = (torch.arange(_CHUNK)[None, :] <
             torch.tensor([b % _CHUNK for b in bounds])[:, None])
    inv = torch.tensor([1.0 / max(n, 1) for n in sizes], dtype=torch.float32)
    nonempty = [i for i, n in enumerate(sizes) if n]
    at = torch.tensor(nonempty, dtype=torch.long) \
        if len(nonempty) < len(sizes) else None
    hit = tuple(t.to(device) if t is not None else None
                for t in (rows, lanes, inv, at)) + (nonempty,)
    _LAYOUTS[key] = hit
    if len(_LAYOUTS) > _LAYOUTS_MAX:
        _LAYOUTS.popitem(last=False)
    return hit


def _boundary_sums(chunks, rows, lanes):
    """Per-slice sums of a [k, m, _CHUNK] float32 buffer, [k, n] in
    float64: its prefix sum at each slice boundary is the total of the
    whole rows before the boundary's row (float32 row totals, a float64
    cumulative sum over them) plus that row's lanes before the boundary;
    the slices' sums are the differences of consecutive prefixes."""
    before = torch.nn.functional.pad(
        torch.cumsum(chunks.sum(-1), -1, dtype=torch.float64), (1, 0))
    part = torch.where(lanes, chunks.index_select(-2, rows), 0.0)
    prefix = before.index_select(-1, rows) + \
        part.sum(-1, dtype=torch.float64)
    return prefix[..., 1:] - prefix[..., :-1]


def segment_stats(flat, sizes):
    """Per-slice S_* stats of a fused buffer: ``sizes`` are the element
    counts of its slices in order; returns an [n, 5] float32 tensor on
    the buffer's device. A buffer on the CPU runs the plain version
    (``segment_stats_plain``); any other goes to the kernel
    (``csrc/segment_stats.cu``, ``_kernel_stats``), which raises if it
    cannot build or launch."""
    sizes = tuple(int(s) for s in sizes)
    if flat.device.type == "cpu":
        return segment_stats_plain(flat, sizes)
    return _kernel_stats(flat, sizes)


# bytes of the buffer each CTA of the kernel's first pass reads
KERNEL_CHUNK_BYTES = 64 * 1024

# the dtypes the kernel reads as they are; any other is read as float32,
# as the plain version reads every dtype
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_KERNEL_LAYOUTS = collections.OrderedDict()  # (sizes, item, device) -> layout
_kernel_layouts_lock = threading.Lock()

#: Launches of the stats kernel, counted where each call launches it.
launch_counts = collections.Counter()
_count_lock = threading.Lock()


def reset_launch_counts():
    with _count_lock:
        launch_counts.clear()


def kernel_layout(sizes, itemsize, device):
    """The kernel's cached layout of one slice layout on ``device``:
    (chunk starts, int64 ``[n_chunks + 1]``: each chunk of
    ``KERNEL_CHUNK_BYTES // itemsize`` elements lies inside one slice and
    the last entry is the buffer's end; slice firsts, int32 ``[n + 1]``:
    slice i's chunks are ``first[i] .. first[i + 1]``; n_chunks). Built
    on the host once per (layout, element size, device) and copied to the
    device once, so a flush makes no host-to-device copy."""
    key = (sizes, itemsize, str(device))
    with _kernel_layouts_lock:
        hit = _KERNEL_LAYOUTS.get(key)
        if hit is not None:
            _KERNEL_LAYOUTS.move_to_end(key)
            return hit
    per = KERNEL_CHUNK_BYTES // itemsize
    starts, first, off = [], [0], 0
    for n in sizes:
        starts.extend(range(off, off + n, per))
        off += n
        first.append(len(starts))
    starts.append(off)
    hit = (torch.tensor(starts, dtype=torch.int64).to(device),
           torch.tensor(first, dtype=torch.int32).to(device),
           len(starts) - 1)
    with _kernel_layouts_lock:
        _KERNEL_LAYOUTS[key] = hit
        if len(_KERNEL_LAYOUTS) > _LAYOUTS_MAX:
            _KERNEL_LAYOUTS.popitem(last=False)
    return hit


def _kernel_stats(flat, sizes):
    """``segment_stats`` on the kernel: two launches over the buffer in
    its own dtype, float64 partials of 40 bytes per chunk as the only
    scratch."""
    x = flat.detach().reshape(-1)
    if x.dtype not in _KERNEL_DTYPES:
        x = x.float()
    if x.numel() != sum(sizes):
        raise ValueError(f"segment_stats: the buffer holds {x.numel()} "
                         f"elements, the slices {sum(sizes)}")
    out = torch.empty((len(sizes), 5), dtype=torch.float32, device=x.device)
    if not sizes:
        return out
    starts, first, n_chunks = kernel_layout(sizes, x.element_size(),
                                            x.device)
    part = torch.empty(n_chunks * 5, dtype=torch.float64, device=x.device)
    extension().segment_stats(x.contiguous(), starts, first, part, out)
    with _count_lock:
        launch_counts["segment_stats"] += 1
    return out


def segment_stats_plain(flat, sizes):
    """The plain torch version of ``segment_stats`` (the CPU's, and what
    the kernel is held against). About twenty launches whatever the slice
    count, and twelve bytes an element of scratch: one float32 buffer of
    three rows padded to whole rows of ``_CHUNK``, the finite values (the
    nonfinite ones zeroed, ``nan_to_num``), a nonfinite indicator and a
    zero indicator; the norms of every slice by ``torch._foreach_norm``
    over the first row (L2 and max-abs over the finite values), and the
    three additive statistics (checksum, nonfinite and zero counts) at
    once by ``_boundary_sums``."""
    sizes = tuple(int(s) for s in sizes)
    f = flat.detach().reshape(-1).float()
    n = len(sizes)
    if n == 0:
        return f.new_zeros((0, 5))
    rows, lanes, inv, at, nonempty = _layout(sizes, f.device)
    total = f.numel()
    m = total // _CHUNK + 1
    buf = f.new_empty((3, m * _CHUNK))
    safe = buf[0, :total]
    torch.nan_to_num(f, nan=0.0, posinf=0.0, neginf=0.0, out=safe)
    torch.ne(f, safe, out=buf[1, :total])    # nan and inf
    torch.eq(f, 0.0, out=buf[2, :total])
    buf[:, total:].zero_()
    views = safe.split(list(sizes))
    live = [views[i] for i in nonempty]

    def norms(ord_):
        if not live:
            return f.new_zeros(n)
        vals = torch.stack(torch._foreach_norm(live, ord_))
        return vals if at is None else \
            f.new_zeros(n).index_copy_(0, at, vals)
    checksum, nonfinite, zeros = _boundary_sums(
        buf.view(3, m, _CHUNK), rows, lanes).float()
    return torch.stack([norms(2), norms(float("inf")), nonfinite,
                        zeros * inv, checksum], dim=1)


def overhead_gate(window, budget_pct=2.0, rounds=3):
    """The reference's overhead contract as ``bench.py``'s
    ``_bench_numerics_overhead`` holds it: ``window(enabled)`` runs one
    timed window of steps with the plane on or off and returns its ms per
    step. Each round runs an off window and an on window; the side that
    runs first alternates from round to round (``bench.py`` runs off first
    each round), so that drift or warm-up across a round favours neither.
    The best window of each side is kept, and another round runs only
    while the best on lies more than ``budget_pct`` % above the best off,
    up to ``rounds`` rounds. Returns the figures; raises AssertionError
    past the budget."""
    best = {True: math.inf, False: math.inf}
    seen = {True: [], False: []}
    for r in range(rounds):
        for enabled in ((False, True) if r % 2 == 0 else (True, False)):
            ms = float(window(enabled))
            seen[enabled].append(ms)
            best[enabled] = min(best[enabled], ms)
        if best[True] <= best[False] * (1.0 + budget_pct / 100.0):
            break
    overhead_pct = (best[True] - best[False]) / best[False] * 100.0
    out = {"off_best_ms": best[False], "on_best_ms": best[True],
           "overhead_pct": overhead_pct, "budget_pct": budget_pct,
           "rounds": len(seen[True]), "off_ms": seen[False],
           "on_ms": seen[True]}
    if overhead_pct > budget_pct:
        raise AssertionError(f"numerics plane overhead {overhead_pct:.2f}% "
                             f"exceeds the {budget_pct}% budget: {out}")
    return out


def _round(v):
    # digest stability: two ranks computing the same value must encode
    # the same number, so records are rounded to 6 significant digits
    return float(f"{float(v):.6g}")


def make_record(reduced_row, local_row):
    """One wire digest record (R_* layout) from two S_* stats rows."""
    return (_round(reduced_row[S_L2]), _round(reduced_row[S_MAX_ABS]),
            int(reduced_row[S_NONFINITE]), _round(reduced_row[S_CHECKSUM]),
            _round(local_row[S_L2]), _round(local_row[S_MAX_ABS]),
            int(local_row[S_NONFINITE]), _round(local_row[S_CHECKSUM]))


def fold_digest(pending, cycle, records, rank=None):
    """Fold one cycle's records into the digest awaiting piggyback."""
    if not records:
        return pending
    if pending is None:
        pending = {"v": DIGEST_VERSION, "rank": rank, "cycles": {}}
    pending["cycles"].setdefault(int(cycle), {}).update(records)
    return pending


def records_disagree(a, b, tol=None):
    """Do two ranks' records for the same (cycle, tensor) describe
    different post-allreduce states? Relative comparison on the reduced
    norm, max-abs and checksum; any nonfinite-count mismatch is an
    immediate disagreement."""
    if tol is None:
        tol = tolerance()
    if int(a[R_RED_NONFINITE]) != int(b[R_RED_NONFINITE]):
        return True
    for idx in (R_RED_L2, R_RED_MAX, R_RED_SUM):
        x, y = float(a[idx]), float(b[idx])
        if abs(x - y) > tol * max(abs(x), abs(y), 1.0):
            return True
    return False


def _checksum_stray(records_by_rank, ranks):
    """Per rank, how far its reduced checksum lies from the sum (or the
    mean) of every holder's local checksum; None when a record lacks the
    local checksum."""
    if any(len(records_by_rank[r]) <= R_LOC_SUM for r in ranks):
        return None
    total = sum(float(records_by_rank[r][R_LOC_SUM]) for r in ranks)
    mean = total / len(ranks)
    return {r: min(abs(float(records_by_rank[r][R_RED_SUM]) - total),
                   abs(float(records_by_rank[r][R_RED_SUM]) - mean))
            for r in ranks}


def blame_rank(records_by_rank):
    """Name the divergent rank among disagreeing replicas.

    A rank whose pre-reduce stats carry nonfinites is blamed outright;
    otherwise the rank whose local L2 deviates most from the cross-rank
    median (the reference's rule). Where that deviation ties (always so
    with two holders), the tied rank whose reduced checksum strays
    furthest from the local checksums' sum or mean. Deterministic:
    sorted ranks, first wins a remaining tie."""
    ranks = sorted(records_by_rank)
    if not ranks:
        return None
    for r in ranks:
        if int(records_by_rank[r][R_LOC_NONFINITE]) > 0:
            return r
    locs = sorted(float(records_by_rank[r][R_LOC_L2]) for r in ranks)
    mid = len(locs) // 2
    med = locs[mid] if len(locs) % 2 else (locs[mid - 1] + locs[mid]) / 2.0
    devs = {r: abs(float(records_by_rank[r][R_LOC_L2]) - med)
            for r in ranks}
    top = max(devs.values())
    tied = [r for r in ranks if devs[r] >= top - 1e-9 * max(top, 1e-30)]
    if len(tied) > 1:
        stray = _checksum_stray(records_by_rank, ranks)
        if stray is not None:
            return max(tied, key=lambda r: (stray[r], -r))
    return tied[0]


class NumericsMonitor:
    """Per-rank gradient-health observer + digest builder.

    Module singleton via ``get_monitor()``/``reset()``, null object when
    HVD_NUMERICS=0. ``observe`` and ``ingest_async`` are the hot-path
    entries, called from the eager core's background thread."""

    def __init__(self, ema_beta=None, ema_k=None, warmup=None):
        self._beta = (ema_beta if ema_beta is not None
                      else env_float("NUMERICS_EMA_BETA", 0.9))
        self._ema_k = (ema_k if ema_k is not None
                       else env_float("NUMERICS_EMA_K", 8.0))
        self._warmup = (warmup if warmup is not None
                        else env_int("NUMERICS_WARMUP", 5))
        self._lock = lockdep.lock("NumericsMonitor._lock")
        self._ema = {}        # guarded_by: _lock; tensor -> EMA of L2 norm
        self._obs = {}        # guarded_by: _lock; tensor -> observations
        self._children = {}   # guarded_by: _lock; tensor -> gauge children
        # parked card results: (names, cycle, pinned host [k, 5|10],
        # event); FIFO in dispatch order
        self._pending_lock = lockdep.lock("NumericsMonitor._pending_lock")
        self._parked = collections.deque()  # guarded_by: _pending_lock
        self._records = {}    # guarded_by: _pending_lock; cycle -> records
        # pinned host buffers of ingested groups, by (shape, dtype), for
        # the next parks to reuse
        self._pinned = {}     # guarded_by: _pending_lock
        self._flagged = set()  # guarded_by: _lock; one event per (tensor, kind)
        self._dumped = False   # guarded_by: _lock; one flight dump per process
        reg = metrics_mod.get_registry()
        self._m_norm = reg.gauge(
            "hvd_grad_norm",
            "L2 norm of this rank's latest pre-reduce contribution, by "
            "tensor.", labels=("tensor",))
        self._m_max = reg.gauge(
            "hvd_grad_max_abs",
            "Max |value| of the latest pre-reduce contribution, by "
            "tensor.", labels=("tensor",))
        self._m_zero = reg.gauge(
            "hvd_grad_zero_fraction",
            "Exact-zero fraction of the latest pre-reduce contribution, "
            "by tensor.", labels=("tensor",))
        self._m_ema = reg.gauge(
            "hvd_grad_norm_ema",
            "Exponential moving average of hvd_grad_norm (the norm-spike "
            "policy baseline).", labels=("tensor",))
        self._m_drift = reg.gauge(
            "hvd_grad_norm_drift",
            "hvd_grad_norm / its EMA — the spike policy trips past "
            "HVD_NUMERICS_EMA_K.", labels=("tensor",))
        self._m_nonfinite = reg.counter(
            "hvd_nonfinite_total",
            "NaN/Inf values seen in gradient buffers, by tensor and "
            "side (local = this rank's contribution, reduced = "
            "post-allreduce).", labels=("tensor", "where"))
        self._m_anomalies = reg.counter(
            "hvd_numerics_anomalies_total",
            "Numerics anomalies flagged by the health policy or the "
            "divergence sentinel, by kind.", labels=("kind",))
        self._m_observed = reg.counter(
            "hvd_numerics_tensors_observed_total",
            "Tensors that went through the gradient-health pass.")

    @property
    def enabled(self):
        return True

    def observe(self, items, cycle=None):
        """Gradient-health pass over one executed flush.

        ``items``: [(name, local, reduced-or-None)]: the pre-reduce
        contribution and the post-allreduce result (None: the same
        tensor, as on one rank). The stats are ``segment_stats`` over
        the tensors laid end to end, one call per side, as the eager core
        takes them over a fused bucket. On the CPU they are ingested at
        once and the wire records of this call are returned when
        ``cycle`` is given; on the card they are parked and ``{}`` is
        returned: their records come out of ``take_records`` once the
        card has computed them."""
        if not items:
            return {}
        names = [name for name, _, _ in items]
        locs = [loc for _, loc, _ in items]
        sizes = [t.numel() for t in locs]

        def stats(tensors):
            return segment_stats(torch.cat(
                [t.detach().reshape(-1).float() for t in tensors]), sizes)
        mat = stats(locs)
        if any(r is not None for _, _, r in items):
            reds = [r if r is not None else loc for _, loc, r in items]
            mat = torch.cat([stats(reds), mat], dim=1)
        return self.ingest_async(names, mat, cycle=cycle) or {}

    def ingest_async(self, names, mat, cycle=None):
        """``ingest`` of a stats matrix still being computed: on the CPU
        at once (returns the records); on the card the matrix is copied
        into pinned host memory on the current stream, an event recorded
        behind the copy, and the group parked for a later drain (returns
        ``{}``). A backlog past 64 groups is drained blocking."""
        if not mat.is_cuda:
            return self.ingest(names, mat, cycle=cycle)
        self._park(("stats", list(names), cycle), mat)
        return {}

    def _park(self, what, mat):
        """Copy ``mat`` into pinned host memory (a buffer of the pool when
        one of its shape is free) on the current stream, record an event
        behind the copy, and queue it for ``_drain``."""
        key = (tuple(mat.shape), mat.dtype)
        with self._pending_lock:
            free = self._pinned.get(key)
            host = free.pop() if free else None
        if host is None:
            host = torch.empty(mat.shape, dtype=mat.dtype, pin_memory=True)
        host.copy_(mat, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(mat.device))
        with self._pending_lock:
            self._parked.append((what, host, ev))
            backlog = len(self._parked)
        self._drain(block=backlog > 64)

    def take_records(self):
        """Ingest every parked group the card has finished and hand over
        the records gathered since the last call: {cycle: {name:
        record}}."""
        self._drain(block=False)
        with self._pending_lock:
            out, self._records = self._records, {}
        return out

    def drain(self):
        """Ingest every parked group, waiting for the card where it must
        (tests, shutdown, anyone about to read the gauges)."""
        self._drain(block=True)

    def _drain(self, block):
        while True:
            with self._pending_lock:
                if not self._parked:
                    return
                what, host, ev = self._parked[0]
                # FIFO readiness: later groups were dispatched later
                if not block and not ev.query():
                    return
                self._parked.popleft()
            if block:
                ev.synchronize()
            if what[0] == "compression":
                self._set_compression(what[1], what[2], host.tolist())
                self._give_back(host)
                continue
            _, names, cycle = what
            recs = self.ingest(names, host, cycle=cycle)
            self._give_back(host)
            if recs:
                with self._pending_lock:
                    self._records.setdefault(int(cycle), {}).update(recs)

    def _give_back(self, host):
        """Return a read pinned buffer to the pool (a few of each shape
        are kept: a bucket layout parks the same shapes every step)."""
        with self._pending_lock:
            free = self._pinned.setdefault((tuple(host.shape), host.dtype),
                                           [])
            if len(free) < _PINNED_KEEP:
                free.append(host)

    def ingest(self, names, mat, cycle=None):
        """Policy half of ``observe``: ``mat`` is an [n, 10] host stats
        matrix (reduced S_* columns, then local) or [n, 5] when the two
        sides are one. Wire records are built only when a ``cycle`` is
        given."""
        rows = mat.detach().cpu().tolist()
        want_records = cycle is not None
        records = {}
        anomalies = []
        with self._lock:
            for name, row in zip(names, rows):
                red = row[:5]
                loc = row[5:] if len(row) > 5 else red
                if want_records:
                    records[name] = make_record(red, loc)
                loc_l2 = loc[S_L2]
                ch = self._children.get(name)
                if ch is None:
                    ch = (self._m_norm.labels(tensor=name),
                          self._m_max.labels(tensor=name),
                          self._m_zero.labels(tensor=name),
                          self._m_ema.labels(tensor=name),
                          self._m_drift.labels(tensor=name))
                    self._children[name] = ch
                ch[0].set(loc_l2)
                ch[1].set(loc[S_MAX_ABS])
                ch[2].set(loc[S_ZERO_FRAC])
                nf_loc = int(loc[S_NONFINITE])
                nf_red = int(red[S_NONFINITE])
                if nf_loc:
                    self._m_nonfinite.labels(
                        tensor=name, where="local").inc(nf_loc)
                if nf_red:
                    self._m_nonfinite.labels(
                        tensor=name, where="reduced").inc(nf_red)
                ema = self._ema.get(name)
                seen = self._obs.get(name, 0)
                if nf_loc or nf_red:
                    anomalies.append((ANOMALY_NONFINITE, name, {
                        "nonfinite_local": nf_loc,
                        "nonfinite_reduced": nf_red}))
                elif (ema is not None and seen >= self._warmup and
                        ema > _EMA_FLOOR and loc_l2 > self._ema_k * ema):
                    anomalies.append((ANOMALY_NORM_SPIKE, name, {
                        "l2": loc_l2, "ema": _round(ema),
                        "k": self._ema_k}))
                ema = (loc_l2 if ema is None
                       else self._beta * ema + (1.0 - self._beta) * loc_l2)
                self._ema[name] = ema
                self._obs[name] = seen + 1
                ch[3].set(ema)
                ch[4].set(loc_l2 / ema if ema > _EMA_FLOOR else 1.0)
            self._m_observed.inc(len(names))
        for kind, name, detail in anomalies:
            self._flag(kind, name, cycle, detail)
        return records

    def observe_compression(self, name, before, after, compressor):
        """Pre/post-compression relative norm delta of a quantized wire
        leg (``hvd_compression_norm_delta``): the two norms are computed
        on the tensors' device and, on the card, read once their event
        has fired, as the stats are."""
        norms = torch.stack([stats_vector(before)[S_L2],
                             stats_vector(after.to(before.dtype))[S_L2]])
        if norms.is_cuda:
            self._park(("compression", name, compressor), norms)
            return
        self._set_compression(name, compressor, norms.tolist())

    def _set_compression(self, name, compressor, norms):
        pre, post = float(norms[0]), float(norms[1])
        reg = metrics_mod.get_registry()
        reg.gauge(
            "hvd_compression_norm_delta",
            "Relative L2 norm lost to wire compression "
            "(|pre - post| / pre), by tensor and compressor.",
            labels=("tensor", "compressor")).labels(
            tensor=name, compressor=compressor).set(
            abs(pre - post) / pre if pre > 0.0 else 0.0)
        reg.counter(
            "hvd_compressed_tensors_total",
            "Tensors that went through a lossy wire compressor.",
            labels=("compressor",)).labels(compressor=compressor).inc()

    def _flag(self, kind, tensor, cycle, detail):
        """Escalate one anomaly: structured event -> trace-id-tagged
        warning -> one flight dump. Deduped per (tensor, kind)."""
        with self._lock:
            if (tensor, kind) in self._flagged:
                return
            self._flagged.add((tensor, kind))
            first_dump = not self._dumped
            self._dumped = True
        reg = metrics_mod.get_registry()
        tracer = tracing_mod.get_tracer()
        trace_id = tracer.trace_id_for(tensor)
        self._m_anomalies.labels(kind=kind).inc()
        reg.event("numerics_anomaly", anomaly=kind, tensor=tensor,
                  rank=reg.rank, cycle=cycle, trace_id=trace_id, **detail)
        log.warning(
            "numerics: %s anomaly on tensor '%s' (rank %s, cycle %s, "
            "trace %s): %s", kind, tensor, reg.rank, cycle, trace_id,
            detail)
        if first_dump:
            tracer.dump("numerics_anomaly")


class NullMonitor:
    """HVD_NUMERICS=0: every call is a no-op."""

    enabled = False

    def observe(self, items, cycle=None):
        return {}

    def ingest(self, names, mat, cycle=None):
        return {}

    def ingest_async(self, names, mat, cycle=None):
        return {}

    def take_records(self):
        return {}

    def drain(self):
        return None

    def observe_compression(self, name, before, after, compressor):
        return None


_monitor = None  # guarded_by: _monitor_lock
_monitor_lock = lockdep.lock("numerics._monitor_lock")


def get_monitor():
    """The process-wide monitor (created on first use; HVD_NUMERICS=0
    yields a no-op monitor)."""
    global _monitor
    m = _monitor
    if m is None:
        with _monitor_lock:
            if _monitor is None:
                _monitor = (NumericsMonitor() if numerics_enabled()
                            else NullMonitor())
            m = _monitor
    return m


def reset(enabled=None, **knobs):
    """Replace the process monitor. ``enabled``: None re-reads
    HVD_NUMERICS, True/False forces."""
    global _monitor
    with _monitor_lock:
        if enabled is None:
            _monitor = None
        else:
            _monitor = (NumericsMonitor(**knobs) if enabled
                        else NullMonitor())
            return _monitor
    return get_monitor()
