"""Rank-0 coordinator negotiation for the multi-process eager API.

The port of ``horovod_tpu/ops/negotiation.py``, itself the
reimplementation of the reference's control plane
(operations.cc:1217-1245: workers gather readiness Requests to rank 0,
the coordinator decides which tensors every rank has submitted, fuses
small ones, and broadcasts an ordered Response plan that every rank then
executes identically). The reference runs this over MPI; here the control
plane is the launch layer's HMAC-authenticated TCP protocol
(run/network.py) so it never touches the accelerators, and the data plane
stays XLA collectives — the same split as MPI-control/NCCL-data.

Why negotiation at all: without it, the multi-process eager API requires
every process to submit collectives in exactly the same order (the strict
SPMD contract, the fallback mode in ops/eager.py). With it, processes may
submit in any order or tempo — the coordinator holds a tensor back until
every rank is ready (IncrementTensorCount, operations.cc:164), checks
shape/dtype/op agreement centrally (ConstructResponse,
operations.cc:198-400), fuses ready same-dtype allreduces under the
fusion threshold (FuseResponses, operations.cc:450-573), and assigns the
one global execution order every process follows.

Left out of the port until their slices: the numerics sentinel
(``_numerics_scan``; slice 8), the flight-recorder dumps and the
metrics ledger (slice 8), and the chaos injection points. The wire
fields they ride (``digest``, ``flight``, ``metrics``) stay on
``CycleRequest``, so the message is the JAX package's; the
``dump_requested`` flag is still raised on a stall or a lost rank.

Protocol: each worker's background cycle sends
``CycleRequest(rank, new entry metas, last applied seq, shutdown)``; the
coordinator replies ``CycleResponse(responses after seq, params,
shutdown)``. Responses are applied strictly in seq order, so the
data-plane collectives match across processes by construction. Tuned
autotuner parameters ride every response (the reference broadcasts them
with a custom MPI struct, parameter_manager.cc:66-81).
"""

import collections
import os
import socketserver
import struct
import threading
import time

from ..common import hvd_logging as log
from ..common.exceptions import RanksLostError
from ..run import network, secret
from . import compression as compression_mod

# ops (mirrors eager.py's constants; import cycle keeps them local)
ALLREDUCE = "allreduce"
ALLGATHER = "allgather"
BROADCAST = "broadcast"
REDUCESCATTER = "reducescatter"
ALLTOALL = "alltoall"

SERVICE_NAME = "hvd.negotiation"
CONTROL_PORT_SPAN = 16  # candidate ports above the rendezvous port


class EntryMeta:
    """One tensor's readiness announcement (reference Request,
    message.h:45)."""

    __slots__ = ("name", "op", "dtype", "shape", "root_rank", "average")

    def __init__(self, name, op, dtype, shape, root_rank, average):
        self.name = name
        self.op = op
        self.dtype = str(dtype)
        self.shape = tuple(int(d) for d in shape)
        self.root_rank = int(root_rank)
        self.average = bool(average)

    def agrees_with(self, other):
        """Cross-rank compatibility (ConstructResponse checks,
        operations.cc:209-371): everything must match exactly, except an
        allgather's first dim (MPI_Allgatherv semantics)."""
        if (self.op, self.dtype, self.root_rank, self.average) != \
                (other.op, other.dtype, other.root_rank, other.average):
            return False
        if len(self.shape) != len(other.shape):
            return False
        a, b = self.shape, other.shape
        if self.op == ALLGATHER and len(a) >= 1:
            a, b = a[1:], b[1:]
        return a == b


def encode_hits(ids):
    """Compactly encode a set of cache ids (the response-cache bypass's
    per-cycle announcement, reference bit-vector sync
    response_cache.cc:317-354). Two encodings, smaller one wins: a
    bitset (1 bit/id — dense steady state, ~n/8 bytes for n tensors)
    or sorted varint deltas (~1-2 bytes/id — robust when ids are sparse
    after heavy churn). First byte tags the encoding."""
    if not ids:
        return b""
    ids = sorted(ids)
    out = bytearray()
    prev = -1
    for i in ids:
        d = i - prev
        prev = i
        while True:
            out.append((d & 0x7F) | (0x80 if d > 0x7F else 0))
            d >>= 7
            if not d:
                break
    varints = bytes(out)
    # only build the bitset when it can win: its size is max_id/8, which
    # after id churn can dwarf the hit count (ids are never reused)
    nbytes = ids[-1] // 8 + 1
    if nbytes <= len(varints):
        buf = bytearray(nbytes)
        for i in ids:
            buf[i >> 3] |= 1 << (i & 7)
        return b"\x00" + bytes(buf)
    return b"\x01" + varints


def decode_hits(data):
    if not data:
        return []
    tag, body = data[0], data[1:]
    ids = []
    if tag == 0:
        for byte_i, byte in enumerate(body):
            while byte:
                low = byte & -byte
                ids.append((byte_i << 3) + low.bit_length() - 1)
                byte &= byte - 1
        return ids
    cur = shift = 0
    prev = -1
    for b in body:
        cur |= (b & 0x7F) << shift
        if b & 0x80:
            shift += 7
        else:
            prev += cur
            ids.append(prev)
            cur = shift = 0
    return ids


# --- compact response wire --------------------------------------------------
#
# The steady-state hot message is the coordinator's CycleResponse: one per
# worker per cycle (default every 5 ms x nproc). As a plain pickle each
# response serialized the class layout of CycleResponse plus every
# NegotiatedResponse — ~90 bytes of pickle framing/attribute names PER
# RESPONSE OBJECT before any payload, against a few bytes of actual
# content (the request path already went compact: encode_hits). The
# response now pickles via __reduce__ into (decoder, (payload,)) where
# payload is a versioned struct/varint byte string: integers are varint,
# strings length-prefixed utf-8, the op an enum nibble, and the whole
# NegotiatedResponse list flattened inline.
#
# Versioning is load-bearing, not decoration: the first payload byte is
# RESPONSE_WIRE_VERSION and decode_response REFUSES (ValueError naming
# both versions) anything else, so a coordinator speaking a newer wire
# fails a mismatched worker loudly at the first cycle instead of letting
# it misparse fields. Workers from builds predating this encoding fail
# equally loudly: their unpickle cannot resolve decode_response at all.

#
# Version history: 2 added the per-response wire-codec field (header
# bit 5 + string) carrying the negotiated quantized-allreduce codec —
# a plan field every rank must agree on, hence the version bump rather
# than an optional flag a stale build would silently ignore.

RESPONSE_WIRE_VERSION = 2

# op enum for the wire; index 0 is reserved for "op carried as a string"
# so an op this table doesn't know (a newer build's) still round-trips
_WIRE_OPS = (ALLREDUCE, ALLGATHER, BROADCAST, REDUCESCATTER, ALLTOALL)


def _put_varint(out, n):
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            break


def _get_varint(buf, i):
    cur = shift = 0
    while True:
        b = buf[i]
        i += 1
        cur |= (b & 0x7F) << shift
        if not b & 0x80:
            return cur, i
        shift += 7


def _put_str(out, s):
    """Length-prefixed utf-8; the length is offset by one so 0 can carry
    None (NegotiatedResponse.error is None on every EXECUTE)."""
    if s is None:
        out.append(0)
        return
    b = s.encode("utf-8")
    _put_varint(out, len(b) + 1)
    out.extend(b)


def _get_str(buf, i):
    n, i = _get_varint(buf, i)
    if n == 0:
        return None, i
    n -= 1
    return bytes(buf[i:i + n]).decode("utf-8"), i + n


def encode_response(resp):
    """CycleResponse -> versioned compact bytes (see block comment)."""
    out = bytearray()
    out.append(RESPONSE_WIRE_VERSION)
    _put_varint(out, resp.base_seq)
    out.append((1 if resp.shutdown else 0) | (2 if resp.stale_ack else 0)
               | (4 if resp.dump_requested else 0))
    thr, cyc = resp.params
    _put_varint(out, int(thr))
    out.extend(struct.pack("<d", float(cyc)))
    for ids in (resp.unknown_ids, resp.lost_ranks):
        _put_varint(out, len(ids))
        for v in ids:
            _put_varint(out, int(v))
    _put_varint(out, len(resp.responses))
    for r in resp.responses:
        try:
            op_i = _WIRE_OPS.index(r.op) + 1
        except ValueError:
            op_i = 0
        # one header byte: bit0 kind, bits1-3 op enum, bit4 cache_ids,
        # bit5 wire codec
        out.append((1 if r.kind == NegotiatedResponse.EXECUTE else 0)
                   | (op_i << 1)
                   | (16 if r.cache_ids is not None else 0)
                   | (32 if r.codec is not None else 0))
        if op_i == 0:
            _put_str(out, r.op)
        _put_varint(out, len(r.names))
        for name in r.names:
            _put_str(out, name)
        _put_str(out, r.error)
        if r.cache_ids is not None:
            for cid in r.cache_ids:  # parallel to names, same count
                _put_varint(out, int(cid))
        if r.codec is not None:
            _put_str(out, r.codec)
    return bytes(out)


def decode_response(payload):
    """Versioned compact bytes -> CycleResponse; refuses any version
    other than RESPONSE_WIRE_VERSION so mismatched builds fail at the
    first cycle with a diagnosis instead of misparsing the stream."""
    if not payload:
        raise ValueError("negotiation: empty CycleResponse payload")
    got = payload[0]
    if got != RESPONSE_WIRE_VERSION:
        raise ValueError(
            f"negotiation: CycleResponse wire version {got} from the "
            f"coordinator, this worker speaks {RESPONSE_WIRE_VERSION} — "
            "coordinator and workers are running mismatched horovod_tpu "
            "builds; run the same version on every rank")
    i = 1
    base_seq, i = _get_varint(payload, i)
    flags = payload[i]
    i += 1
    thr, i = _get_varint(payload, i)
    cyc = struct.unpack_from("<d", payload, i)[0]
    i += 8
    lists = []
    for _ in range(2):  # unknown_ids, lost_ranks
        n, i = _get_varint(payload, i)
        vals = []
        for _ in range(n):
            v, i = _get_varint(payload, i)
            vals.append(v)
        lists.append(vals)
    unknown_ids, lost_ranks = lists
    n_resp, i = _get_varint(payload, i)
    responses = []
    for _ in range(n_resp):
        head = payload[i]
        i += 1
        kind = (NegotiatedResponse.EXECUTE if head & 1
                else NegotiatedResponse.ERROR)
        op_i = (head >> 1) & 0x7
        if op_i:
            op = _WIRE_OPS[op_i - 1]
        else:
            op, i = _get_str(payload, i)
        n_names, i = _get_varint(payload, i)
        names = []
        for _ in range(n_names):
            s, i = _get_str(payload, i)
            names.append(s)
        error, i = _get_str(payload, i)
        cache_ids = None
        if head & 16:
            cache_ids = []
            for _ in range(n_names):
                cid, i = _get_varint(payload, i)
                cache_ids.append(cid)
        codec = None
        if head & 32:
            codec, i = _get_str(payload, i)
        responses.append(NegotiatedResponse(kind, op, names, error=error,
                                            cache_ids=cache_ids,
                                            codec=codec))
    return CycleResponse(base_seq, responses, (thr, cyc), bool(flags & 1),
                         stale_ack=bool(flags & 2),
                         dump_requested=bool(flags & 4),
                         unknown_ids=unknown_ids, lost_ranks=lost_ranks)


class CycleRequest:
    def __init__(self, rank, entries, ack, shutdown=False, req_id=0,
                 hits=b"", metrics=None, flight=None, digest=None,
                 codec_fp=None, load=None):
        self.rank = rank
        self.entries = entries  # list[EntryMeta]
        self.ack = ack          # last response seq this worker applied
        self.shutdown = shutdown
        # wire-codec config fingerprint (compression.config_fingerprint):
        # the coordinator compares it against rank 0's every cycle and
        # fails negotiation loudly on any asymmetry — a rank casting to
        # bf16 while another sends fp32 would corrupt sums silently.
        # Requests are plain-pickled, so the field is wire-safe.
        self.codec_fp = codec_fp
        # numerics digest piggyback (utils/numerics.py): per-cycle
        # gradient-health records ({"v", "rank", "cycles": {seq: {name:
        # record}}}) for the coordinator's cross-rank divergence
        # sentinel (_numerics_scan). Requests are plain-pickled, so
        # adding the field is wire-safe — same pattern as `metrics`.
        self.digest = digest
        # flight-recorder piggyback (utils/tracing.py): when the previous
        # CycleResponse carried dump_requested, the worker attaches its
        # flight snapshot here (once) so the coordinator can persist every
        # rank's last seconds even for ranks whose disks are unreachable.
        # None on every normal cycle — same pattern as `metrics` below.
        self.flight = flight
        # low-rate piggyback: every HVD_METRICS_INTERVAL seconds the
        # worker attaches its metrics snapshot (utils/metrics.py) here,
        # making the negotiation cycle the aggregation transport — no
        # extra connections, no extra message types. None on the other
        # ~99% of cycles.
        self.metrics = metrics
        # serving-load piggyback (serving/replica.py): a serving
        # replica's heartbeat attaches its compact load snapshot (queue
        # depth, active slots, free KV blocks, generations) so the
        # router reads live per-replica state off the coordinator's
        # ledger instead of polling replicas. Plain-pickled, wire-safe —
        # same pattern as `metrics`.
        self.load = load
        # idempotency token: a retry after a lost response reuses the id,
        # and the coordinator skips re-submitting entries it already
        # recorded (a popped-and-resubmitted name would otherwise create
        # a ghost table row no other rank ever completes)
        self.req_id = req_id
        # response-cache hits: encode_hits() of the cache ids this worker
        # re-submits unchanged — the steady-state bypass of full
        # EntryMeta uploads (reference RunBypass,
        # operations.cc:1168-1215)
        self.hits = hits


class NegotiatedResponse:
    """One unit of agreed work (reference Response, message.h:130)."""

    __slots__ = ("kind", "op", "names", "error", "cache_ids", "codec")
    EXECUTE = "execute"
    ERROR = "error"

    def __init__(self, kind, op, names, error=None, cache_ids=None,
                 codec=None):
        self.kind = kind
        self.op = op
        self.names = names  # >1 names = fused allreduce
        self.error = error
        # cache ids assigned to `names` (parallel list) on EXECUTE —
        # riding the seq-ordered response log means every rank learns
        # each assignment at the same point in its apply order
        self.cache_ids = cache_ids
        # negotiated wire codec for this (fused) allreduce — decided
        # once by the coordinator from rank 0's config so every rank
        # encodes/decodes identically (ops/compression.py); None means
        # full width. Versioned plan field (wire version 2).
        self.codec = codec


class CycleResponse:
    def __init__(self, base_seq, responses, params, shutdown,
                 stale_ack=False, dump_requested=False, unknown_ids=(),
                 lost_ranks=()):
        self.base_seq = base_seq      # seq of responses[0]
        self.responses = responses    # list[NegotiatedResponse]
        self.params = params          # (fusion_threshold, cycle_time_ms)
        self.shutdown = shutdown
        # the requester's ack predates the bounded response log: it can
        # never catch up and must fail its pending work (see
        # _prune_acknowledged's cap)
        self.stale_ack = stale_ack
        # the coordinator is soliciting a flight-recorder dump (stall or
        # liveness escalation): the worker attaches its flight snapshot
        # to the next CycleRequest. An optional flag bit old decoders
        # ignore — same RESPONSE_WIRE_VERSION.
        self.dump_requested = dump_requested
        # cache ids the requester announced as hits that this coordinator
        # does not hold (evicted, or invalidated by another rank's
        # changed-signature resubmission): the worker drops its mapping
        # and re-announces those tensors with full metas
        self.unknown_ids = tuple(unknown_ids)
        # ranks the coordinator's liveness ledger declared DEAD (silent
        # past HOROVOD_RANK_LOST_TIMEOUT_SECONDS): the requester must
        # fail its pending work with RanksLostError naming them — a
        # bounded fail-fast instead of the legacy stall-warning hang
        self.lost_ranks = tuple(lost_ranks)

    def __reduce__(self):
        # the wire form: the per-cycle hot message pickles as
        # (decode_response, (compact bytes,)) instead of a class-layout
        # pickle — see the compact-response-wire block above. Pre-wire
        # workers fail the unpickle loudly (no decode_response symbol);
        # future-wire workers fail in decode_response's version check.
        return (decode_response, (encode_response(self),))


def _meta_identical(a, b):
    """Exact equality of every negotiated parameter — the cache-hit
    contract (stricter than agrees_with, which allows allgather dim-0
    variance: a hit asserts the tensor is byte-for-byte re-describable
    by the cached meta)."""
    return (a.name, a.op, a.dtype, a.shape, a.root_rank, a.average) == \
        (b.name, b.op, b.dtype, b.shape, b.root_rank, b.average)


def _meta_nbytes(meta):
    """Payload bytes an EntryMeta describes — the size gate for
    wire-codec selection."""
    n = 1
    for d in meta.shape:
        n *= int(d)
    from .fusion import _ITEMSIZE
    # a dtype name without a known size counts 4-byte elements rather
    # than failing negotiation over a gate
    return n * _ITEMSIZE.get(meta.dtype, 4)


class _TableRow:
    __slots__ = ("metas", "first_ts", "warned")

    def __init__(self):
        self.metas = {}   # rank -> EntryMeta
        self.first_ts = time.monotonic()
        self.warned = False


class CoordinatorService(network.BasicService):
    """Rank 0's negotiation server (the coordinator role of
    BackgroundThreadLoop, operations.cc:1246-1551, minus the data plane).

    All state mutations happen under one lock inside request handling;
    the handler never blocks on collectives, so the TCP plane stays
    responsive regardless of data-plane progress.
    """

    def __init__(self, nproc, key, ports, config):
        self._nproc = nproc
        self._config = config  # rank 0's HorovodConfig (live object)
        self._lock = threading.Lock()
        self._table = {}     # guarded_by: _lock; name -> _TableRow
        self._order = []     # guarded_by: _lock; first-submission order
        # responses[i] has seq = _base_seq + i; prefixes every rank has
        # acknowledged are pruned so the log stays bounded over long runs
        self._responses = []  # guarded_by: _lock
        self._base_seq = 0    # guarded_by: _lock
        self._acks = {}       # guarded_by: _lock; rank -> last acked seq
        # rank -> (last processed request id, unknown-id tuple resolved
        # on its FIRST processing): a deduped retry returns the SAME
        # answer the lost response carried
        self._seen_req = {}   # guarded_by: _lock
        self._shutdown = False  # guarded_by: _lock
        # liveness ledger: rank -> monotonic time of its last cycle. A
        # rank that heartbeated and then went silent past
        # config.rank_lost_timeout_seconds is declared lost
        # (_liveness_scan).
        self._last_seen = {}    # guarded_by: _lock
        self._lost_ranks = set()  # guarded_by: _lock
        self._ports = ports
        # Response cache (response_cache.h:43-92): names that EXECUTEd get
        # a monotonically increasing cache id; a steady-state resubmission
        # is one bit on the wire instead of a full EntryMeta. Ids are
        # never reused. LRU-bounded by HOROVOD_CACHE_CAPACITY (0 disables
        # caching entirely).
        self._cache = collections.OrderedDict()  # guarded_by: _lock
        self._cache_id_of = {}   # guarded_by: _lock; name -> id
        self._next_cache_id = 0  # guarded_by: _lock
        # serving-load snapshots piggybacked on replica heartbeats (rank
        # -> dict), receipt-stamped on this clock
        self.load_snapshots = {}
        # stall/liveness escalation flips this; every later
        # CycleResponse carries the flag
        self._dump_requested = False  # guarded_by: _lock
        # wire-codec agreement: rank 0's codec-config fingerprint is the
        # negotiated truth; a rank whose fingerprint differs is recorded
        # here and every subsequently ready tensor becomes an ERROR
        self._codec_fp = compression_mod.config_fingerprint(config)
        self._codec_mismatch = {}  # guarded_by: _lock; rank -> their fp
        super().__init__(SERVICE_NAME, key)

    # bind to one of the agreed candidate ports instead of an ephemeral
    # one, so workers can find the coordinator without a side channel
    def _bind_ephemeral(self):
        last_err = None
        for port in self._ports:
            try:
                srv = socketserver.ThreadingTCPServer(
                    ("0.0.0.0", port), self._make_handler())
                srv.daemon_threads = True
                return srv
            except OSError as e:
                last_err = e
        raise RuntimeError(
            f"negotiation coordinator: no free port in {self._ports}: "
            f"{last_err}")

    def _handle(self, req, client_address):
        if isinstance(req, network.PingRequest):
            return network.PingResponse(SERVICE_NAME, client_address[0])
        if isinstance(req, CycleRequest):
            with self._lock:
                if getattr(req, "load", None) is not None:
                    # receipt-stamped on the coordinator's clock, so a
                    # replica that heartbeated and went silent stops
                    # looking freshly idle
                    self.load_snapshots[req.rank] = dict(
                        req.load, ts=time.monotonic())
                fp = getattr(req, "codec_fp", None)
                if (fp is not None and fp != self._codec_fp
                        and req.rank not in self._codec_mismatch):
                    self._codec_mismatch[req.rank] = fp
                    log.error(
                        "negotiation: rank %d wire-codec config %r "
                        "differs from rank 0's %r — failing its "
                        "collectives (HOROVOD_COMPRESSION must agree on "
                        "every rank)", req.rank, fp, self._codec_fp)
                self._last_seen[req.rank] = time.monotonic()
                self._acks[req.rank] = max(
                    self._acks.get(req.rank, -1), req.ack)
                # Hits resolve ONLY on the first processing of a request
                # id; the resolved unknowns are persisted with the req_id
                # and returned verbatim on a deduped retry, whose first
                # response may have been lost on the wire.
                seen = self._seen_req.get(req.rank)
                if seen is None or seen[0] != req.req_id:
                    unknown = []
                    self._submit(req.rank, req.entries)
                    for cid in decode_hits(req.hits):
                        meta = self._cache.get(cid)
                        if meta is None:
                            unknown.append(cid)
                        else:
                            self._cache.move_to_end(cid)
                            self._submit(req.rank, [meta])
                    self._seen_req[req.rank] = (req.req_id,
                                                tuple(unknown))
                else:
                    unknown = list(seen[1])
                self._negotiate()
                # the shutdown flag is set AFTER this request's negotiate:
                # work that became ready in the departing rank's final
                # (drain) cycle is still EXECUTE-ordered and rides this
                # very response; anything ready LATER becomes an ERROR
                if req.shutdown:
                    self._shutdown = True
                self._stall_scan()
                self._prune_acknowledged()
                stale = req.ack + 1 < self._base_seq
                start = max(0, req.ack + 1 - self._base_seq)
                return CycleResponse(
                    self._base_seq + start, list(self._responses[start:]),
                    (self._config.fusion_threshold,
                     self._config.cycle_time_ms),
                    self._shutdown, stale_ack=stale,
                    dump_requested=self._dump_requested,
                    unknown_ids=unknown,
                    lost_ranks=sorted(self._lost_ranks))
        raise NotImplementedError(req)

    def load_snapshot_view(self):
        """Copy of the per-replica serving-load ledger (other threads read
        through this, never the live dict)."""
        with self._lock:
            return dict(self.load_snapshots)

    # retained-response cap: a rank that crashed (or never reaches the
    # eager API) must not let the log grow unboundedly for the rest of a
    # long run. A rank whose ack falls behind the retained window gets
    # stale_ack=True and fails its pending work instead of hanging.
    MAX_RESPONSE_LOG = 4096

    def _prune_acknowledged(self):
        """Drop response prefixes every rank has applied (each rank's ack
        rides its CycleRequest), bounding coordinator memory over long
        runs; a hard cap covers ranks that stopped acking entirely."""
        if len(self._acks) >= self._nproc and self._responses:
            min_ack = min(self._acks.values())
            drop = min_ack + 1 - self._base_seq
            if drop > 0:
                del self._responses[:drop]
                self._base_seq += drop
        over = len(self._responses) - self.MAX_RESPONSE_LOG
        if over > 0:
            laggards = sorted(r for r, a in self._acks.items()
                              if a + 1 < self._base_seq + over)
            log.warning(
                "negotiation response log exceeded %d entries; dropping "
                "%d oldest (ranks %s have fallen behind the retained "
                "window and will fail their pending work)",
                self.MAX_RESPONSE_LOG, over, laggards)
            del self._responses[:over]
            self._base_seq += over

    def _submit(self, rank, entries):
        for meta in entries:
            # a full meta for a cached name whose parameters changed
            # invalidates the id (shape change mid-run, e.g. a ragged
            # last batch): peers still holding the old id get it back as
            # unknown and re-announce (response_cache.cc invalidation)
            cid = self._cache_id_of.get(meta.name)
            if cid is not None:
                cached = self._cache.get(cid)
                if cached is not None and cached is not meta and \
                        not _meta_identical(cached, meta):
                    del self._cache[cid]
                    del self._cache_id_of[meta.name]
            row = self._table.get(meta.name)
            if row is None:
                row = self._table[meta.name] = _TableRow()
                self._order.append(meta.name)
            row.metas[rank] = meta

    def _negotiate(self):
        """Promote fully-submitted names to responses: meta agreement
        check, then fusion of ready same-dtype allreduces in ready order
        (ConstructResponse + FuseResponses)."""
        ready = []
        for name in self._order:
            row = self._table.get(name)
            if row is not None and len(row.metas) == self._nproc:
                ready.append(name)
        if not ready:
            return
        # one O(n) rebuild instead of per-name list.remove() — at 1000
        # ready gradients the removes alone are ~10^6 element shifts per
        # negotiation, a measured control-plane hot spot
        ready_set = set(ready)
        self._order = [n for n in self._order if n not in ready_set]
        if self._shutdown:
            # a rank has left: an EXECUTE now would strand the remaining
            # ranks inside a collective the departed rank never runs
            # (reference drains, then errors late arrivals —
            # operations.cc:1101-1122). Fail the work instead.
            for name in ready:
                row = self._table.pop(name)
                op = next(iter(row.metas.values())).op
                self._responses.append(NegotiatedResponse(
                    NegotiatedResponse.ERROR, op, [name],
                    error=f"Horovod has been shut down: {op} '{name}' "
                          "became ready after a rank requested shutdown."))
            return
        if self._codec_mismatch:
            # rank-asymmetric codec config (the text is the JAX
            # package's, so both coordinators send the same bytes):
            # EXECUTE responses here would
            # have ranks encoding/decoding different wire formats into
            # the same sum. Fail every ready tensor loudly instead.
            detail = ", ".join(
                f"process {r} has '{self._codec_mismatch[r]}'"
                for r in sorted(self._codec_mismatch))
            for name in ready:
                row = self._table.pop(name)
                op = next(iter(row.metas.values())).op
                self._responses.append(NegotiatedResponse(
                    NegotiatedResponse.ERROR, op, [name],
                    error=(
                        f"Mismatched wire-codec config across processes "
                        f"for {op} '{name}': process 0 negotiates "
                        f"'{self._codec_fp}' but {detail}. "
                        "HVD_COMPRESSION and the HVD_QUANT_* knobs must "
                        "be identical on every rank; a quantized "
                        "allreduce under mismatched codecs would corrupt "
                        "the sums silently.")))
            return
        checked = []
        for name in ready:
            row = self._table.pop(name)
            base = row.metas[0]
            bad = [(r, m) for r, m in sorted(row.metas.items())
                   if not base.agrees_with(m)]
            if bad:
                r, m = bad[0]
                self._responses.append(NegotiatedResponse(
                    NegotiatedResponse.ERROR, base.op, [name],
                    error=(
                        f"Mismatched {base.op} '{name}' across processes: "
                        f"process 0 submitted op={base.op} "
                        f"dtype={base.dtype} root={base.root_rank} "
                        f"shape={base.shape}, process {r} submitted "
                        f"op={m.op} dtype={m.dtype} root={m.root_rank} "
                        f"shape={m.shape} (ConstructResponse checks, "
                        f"operations.cc:209-371).")))
            else:
                checked.append((name, base))
        # Fusion: the same look-ahead dtype-bucketing planner (native
        # hvd_plan_buckets when built) that serves the jit path and the
        # eager stacked path — EntryMeta quacks like a leaf (shape/dtype).
        # Allreduces partition by `average` first (sum and mean cannot
        # share a fused buffer); allgathers bucket by dtype alone and
        # execute as one fused allgatherv with per-rank displacement
        # math (Response::add_allgather_response, message.h:172).
        from . import fusion as fusion_mod
        threshold = self._config.fusion_threshold
        anchors = {}  # first checked-index of a bucket -> member indices
        # Allreduces additionally partition by negotiated wire codec
        # (selected here, from rank 0's config, so the decision is made
        # exactly once for all ranks): a fused buffer is encoded as one
        # unit, so its members must share a codec. The fingerprint check
        # above guarantees every rank's config would have chosen the
        # same partition.
        bucket_codec = {}  # anchor index -> codec (None = full width)
        ar_groups = {}
        for i, (_, m) in enumerate(checked):
            if m.op != ALLREDUCE:
                continue
            codec = compression_mod.select_codec(
                self._config, m.dtype, _meta_nbytes(m))
            ar_groups.setdefault((m.average, codec or ""), []).append(i)
        for (avg, codec), idx in sorted(ar_groups.items()):
            buckets = fusion_mod.plan_buckets(
                [checked[i][1] for i in idx], threshold)
            for b in buckets:
                members = [idx[j] for j in b.indices]
                anchors[members[0]] = members
                if codec:
                    bucket_codec[members[0]] = codec
        # plan_buckets partitions by dtype internally, so all ready
        # allgathers go through one planning call
        idx = [i for i, (_, m) in enumerate(checked)
               if m.op == ALLGATHER]
        if idx:
            buckets = fusion_mod.plan_buckets(
                [checked[i][1] for i in idx], threshold)
            for b in buckets:
                members = [idx[j] for j in b.indices]
                anchors[members[0]] = members
        for i, (name, meta) in enumerate(checked):
            if meta.op not in (ALLREDUCE, ALLGATHER):
                self._responses.append(NegotiatedResponse(
                    NegotiatedResponse.EXECUTE, meta.op, [name],
                    cache_ids=self._assign_cache_ids([(name, meta)])))
                continue
            members = anchors.get(i)
            if members is None:  # emitted with an earlier anchor
                continue
            named = [checked[j] for j in members]
            self._responses.append(NegotiatedResponse(
                NegotiatedResponse.EXECUTE, meta.op,
                [n for n, _ in named],
                cache_ids=self._assign_cache_ids(named),
                codec=bucket_codec.get(i)))

    def _assign_cache_ids(self, named_metas):
        """Give each EXECUTEd name a cache id (new names and
        changed-signature names get fresh ids; unchanged names keep
        theirs, LRU-touched). Returns the parallel id list, or None when
        caching is disabled (HOROVOD_CACHE_CAPACITY=0)."""
        cap = int(getattr(self._config, "cache_capacity", 0) or 0)
        if cap <= 0:
            return None
        ids = []
        for name, meta in named_metas:
            cid = self._cache_id_of.get(name)
            if cid is not None and cid in self._cache and \
                    _meta_identical(self._cache[cid], meta):
                self._cache.move_to_end(cid)
            else:
                if cid is not None:
                    self._cache.pop(cid, None)
                cid = self._next_cache_id
                self._next_cache_id += 1
                self._cache[cid] = meta
                self._cache_id_of[name] = cid
                while len(self._cache) > cap:
                    old_id, old_meta = self._cache.popitem(last=False)
                    if self._cache_id_of.get(old_meta.name) == old_id:
                        del self._cache_id_of[old_meta.name]
            ids.append(cid)
        return ids

    def _stall_scan(self):
        now = time.monotonic()
        self._liveness_scan(now)
        warn = self._config.stall_warning_time_seconds
        if self._config.stall_check_disable or warn <= 0:
            return
        stalled_tensors = 0
        for name in self._order:
            row = self._table[name]
            if now - row.first_ts <= warn:
                continue
            stalled_tensors += 1
            if not row.warned:
                row.warned = True
                missing = sorted(set(range(self._nproc)) -
                                 set(row.metas.keys()))
                log.warning(
                    "One or more tensors were submitted to be reduced, "
                    "gathered or broadcasted by subset of ranks and are "
                    "waiting for remainder of ranks for more than %ss: "
                    "%s (missing ranks: %s)", warn, name, missing)
        if stalled_tensors:
            # stall escalation: every later response carries the flag
            self._dump_requested = True

    def _liveness_scan(self, now):
        """Escalate silence to fail-fast: a rank that heartbeated at
        least once and then sent nothing for
        ``rank_lost_timeout_seconds`` is declared LOST. Every pending
        table row becomes an ERROR response naming the dead ranks, and
        every subsequent CycleResponse carries ``lost_ranks`` so each
        surviving rank fails its pending work with RanksLostError within
        one cycle. Disabled once a clean shutdown drain starts — a
        departed rank is not a dead rank."""
        deadline = getattr(self._config, "rank_lost_timeout_seconds", 0.0)
        if deadline <= 0 or self._shutdown or self._lost_ranks:
            return
        dead = sorted(r for r, ts in self._last_seen.items()
                      if now - ts > deadline)
        if not dead:
            return
        self._lost_ranks = set(dead)
        self._dump_requested = True
        log.error(
            "negotiation liveness: ranks %s sent no cycle for more than "
            "%ss — declaring them LOST and failing all pending work "
            "(%d tensors). Survivors receive RanksLostError.",
            dead, deadline, len(self._order))
        reason = (f"ranks {dead} sent no negotiation cycle for more "
                  f"than {deadline}s")
        for name in self._order:
            row = self._table.pop(name)
            op = next(iter(row.metas.values())).op
            self._responses.append(NegotiatedResponse(
                NegotiatedResponse.ERROR, op, [name],
                error=f"RanksLostError: {op} '{name}' cannot complete: "
                      f"{reason}."))
        self._order = []


def raise_if_ranks_lost(resp, trace_id=None):
    """The worker half of the liveness protocol: fail fast when the
    coordinator declared ranks dead. Shared by the eager engine
    (_apply_cycle_response) and the protocol-level chaos drills so both
    exercise the same path. ``trace_id`` names the caller's blocking
    tensor so the error points into the flight-recorder dump."""
    lost = getattr(resp, "lost_ranks", ())
    if lost:
        raise RanksLostError(
            lost, reason="declared lost by the coordinator's liveness "
                         "ledger",
            trace_id=trace_id)


def control_addresses():
    """Candidate (host, port) list for the coordinator service.

    ``HVD_CONTROL_ADDR`` (host:port) pins it exactly; otherwise it is
    derived from the rendezvous — ``HVD_COORDINATOR_ADDR`` (the JAX
    package's launchers), else torchrun's ``MASTER_ADDR:MASTER_PORT``:
    the coordinator binds the first free port in [rendezvous+1000,
    rendezvous+1000+span) and workers probe them all (run/network.py
    BasicClient). Returns None when no rendezvous is known — callers
    fall back to non-negotiated mode."""
    pinned = os.environ.get("HVD_CONTROL_ADDR")
    if pinned:
        host, _, port = pinned.rpartition(":")
        return [(host, int(port))]
    addr = os.environ.get("HVD_COORDINATOR_ADDR")
    if not addr and os.environ.get("MASTER_ADDR") and \
            os.environ.get("MASTER_PORT"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if not addr:
        return None
    host, _, port = addr.rpartition(":")
    base = int(port) + 1000
    return [(host, p) for p in range(base, base + CONTROL_PORT_SPAN)]


def control_key():
    """The control-plane HMAC key: the launcher's per-job secret, base64
    (``_HVD_SECRET_KEY``, the JAX package's launcher variable, else the
    user-facing ``HVD_SECRET_KEY`` or ``HOROVOD_SECRET_KEY``; reference
    run/common/util/secret.py). Returns None when unset — the caller
    must then fall back to non-negotiated mode.
    NO derived fallback: the wire protocol deserializes pickles, so a key
    computable from public information (addresses, constants) would make
    the 0.0.0.0-bound coordinator remotely scriptable; an unauthenticated
    channel is strictly worse than no channel."""
    k = None
    for var in (secret.HVD_SECRET_KEY, "HVD_SECRET_KEY",
                "HOROVOD_SECRET_KEY"):
        k = os.environ.get(var)
        if k:
            break
    if not k:
        return None
    import base64
    return base64.b64decode(k)


class NegotiationWorker:
    """Every process's client side (rank 0 additionally hosts the
    service). ``cycle()`` is called from the eager background loop; it
    never runs data-plane collectives itself."""

    def __init__(self, rank, nproc, config, addresses, key,
                 start_timeout_s=120.0):
        self._rank = rank
        self._nproc = nproc
        self.service = None
        if rank == 0:
            ports = sorted({p for _, p in addresses})
            self.service = CoordinatorService(nproc, key, ports, config)
        # workers may start before rank 0's server is up: retry the probe
        deadline = time.monotonic() + start_timeout_s
        addr_map = {"control": list(addresses)}
        last = None
        while True:
            try:
                # retry_requests: CycleRequests are idempotent at the
                # coordinator (req_id dedupe), so the transport may
                # silently resend over a fresh socket
                self._client = network.BasicClient(
                    SERVICE_NAME, addr_map, key, probe_timeout=2.0,
                    attempts=1, retry_requests=True)
                break
            except network.NoValidAddressesFound as e:
                last = e
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"negotiation: coordinator unreachable at "
                        f"{addresses} after {start_timeout_s}s") from last
                time.sleep(0.2)

    def cycle(self, entries, ack, shutdown=False, req_id=0, hits=b"",
              metrics=None, flight=None, digest=None, codec_fp=None,
              load=None):
        return self._client.request(
            CycleRequest(self._rank, entries, ack, shutdown,
                         req_id=req_id, hits=hits, metrics=metrics,
                         flight=flight, digest=digest,
                         codec_fp=codec_fp, load=load))

    def close(self, linger_s=2.0):
        """Stop the coordinator service — after a grace window, so peers
        mid-cycle still receive their shutdown=True responses instead of
        connection errors (the reference's shutdown Response reaches every
        rank before MPI_Finalize, operations.cc:1101-1122)."""
        try:
            self._client.close()  # release the persistent socket
        except Exception:  # noqa: BLE001 — already torn down
            pass
        if self.service is not None:
            service, self.service = self.service, None
            timer = threading.Timer(linger_s, service.shutdown)
            timer.daemon = True
            timer.start()
