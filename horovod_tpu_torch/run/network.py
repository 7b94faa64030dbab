"""HMAC-authenticated pickle-over-TCP RPC for the control plane.

The port's copy of ``horovod_tpu/run/network.py`` (reference
horovod/run/common/util/network.py:49-84): every message is
``digest(32) | length(4) | body`` where body is a pickled object and the
digest is HMAC-SHA256 under a per-job secret key. Services bind a port
and serve on a daemon thread, many requests per connection; clients try
every (ip, port) pair they were given and remember the first route that
answers a Ping.

Adapted, not imported: the body is the standard library's pickle (the
JAX package uses cloudpickle) and the interfaces are read with
``SIOCGIFADDR`` (the JAX package uses psutil). ``advertise_ip`` never
opens a socket towards another host. As in the JAX package, a service
carries the chaos plane's injector (``run/chaos.py``, under
``HVD_CHAOS_SPEC``) at its handler loop, and the client counts its
silent resends and backoff (``hvd_transport_retries_total``,
``hvd_transport_backoff_seconds_total``).
"""

import array
import fcntl
import pickle
import queue
import random
import socket
import socketserver
import struct
import threading
import time

from ..utils import metrics as hvd_metrics
from . import chaos as chaos_mod
from . import secret

_SIOCGIFADDR = 0x8915


class PingRequest:
    pass


class PingResponse:
    def __init__(self, service_name, source_address):
        self.service_name = service_name
        self.source_address = source_address  # client ip as seen by service


class AckResponse:
    pass


class NoValidAddressesFound(Exception):
    pass


class Wire:
    """Serialize/authenticate one message per direction on a stream."""

    def __init__(self, key):
        self._key = key
        # cumulative on-wire payload bytes (digest + length prefix +
        # body); one Wire is shared by all of a service's handler threads
        self.bytes_out = 0  # guarded_by: _count_lock
        self.bytes_in = 0   # guarded_by: _count_lock
        self._count_lock = threading.Lock()

    def write(self, obj, wfile):
        body = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        wfile.write(secret.compute_digest(self._key, body))
        wfile.write(struct.pack("i", len(body)))
        wfile.write(body)
        wfile.flush()
        with self._count_lock:
            self.bytes_out += secret.DIGEST_LENGTH + 4 + len(body)

    def write_truncated(self, obj, wfile, frac=0.5):
        """Chaos-plane helper (``truncate_response``): a cut-off frame
        whose digest and length promise a body that never arrives, so
        the peer's read sees a mid-message disconnect (EOFError), never
        a bogus HMAC failure."""
        body = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        frame = (secret.compute_digest(self._key, body) +
                 struct.pack("i", len(body)) + body)
        cut = max(1, int(len(frame) * frac))
        wfile.write(frame[:cut])
        wfile.flush()
        with self._count_lock:
            self.bytes_out += cut

    def read(self, rfile):
        digest = rfile.read(secret.DIGEST_LENGTH)
        if len(digest) < secret.DIGEST_LENGTH:
            raise EOFError("peer closed the connection")
        raw_len = rfile.read(4)
        if len(raw_len) < 4:
            raise EOFError("peer closed the connection mid-header")
        (length,) = struct.unpack("i", raw_len)
        body = rfile.read(length)
        if len(body) < length:
            # a disconnect mid-body must read as a disconnect, not as an
            # HMAC failure
            raise EOFError("peer closed the connection mid-message")
        with self._count_lock:
            self.bytes_in += secret.DIGEST_LENGTH + 4 + length
        if not secret.check_digest(self._key, body, digest):
            raise RuntimeError(
                "Security error: HMAC digest did not match the message.")
        return pickle.loads(body)


def _iface_ipv4(name):
    """The IPv4 address of interface ``name``, or None."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        req = array.array("B", struct.pack("256s", name.encode()[:15]))
        try:
            fcntl.ioctl(s.fileno(), _SIOCGIFADDR, req)
        except OSError:
            return None
        return socket.inet_ntoa(req.tobytes()[20:24])


def local_addresses(port=None):
    """All non-loopback IPv4 addresses of this host, as (ip, port) pairs
    keyed by interface name (reference network.py
    get_local_host_addresses)."""
    result = {}
    for _, iface in socket.if_nameindex():
        ip = _iface_ipv4(iface)
        if ip is not None and ip != "127.0.0.1":
            result.setdefault(iface, []).append((ip, port))
    return result


def free_port():
    """An OS-assigned free TCP port (bind 0, read, release). The port is
    only reserved while bound, so callers should bind their real socket
    promptly."""
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def advertise_ip():
    """The IP this host should publish for peers to connect to: the first
    non-loopback interface address, else what gethostname resolves to
    (which /etc/hosts commonly maps to 127.0.x.1 — last resort only)."""
    for addrs in local_addresses().values():
        for ip, _ in addrs:
            if not ip.startswith("127."):
                return ip
    return socket.gethostbyname(socket.gethostname())


class BasicService:
    """Threaded TCP server speaking Wire; subclasses override _handle."""

    def __init__(self, service_name, key):
        self._service_name = service_name
        self._wire = Wire(key)
        # the chaos plane: None unless HVD_CHAOS_SPEC targets this
        # service; evaluated once so every handler thread shares one
        # deterministic rule state
        self._chaos = chaos_mod.from_env(service_name)
        # live persistent connections: shutdown() must sever them, or
        # clients looping on an established socket would keep being
        # served by daemon handler threads after the accept loop stops
        self._conns = set()  # guarded_by: _conns_lock
        self._conns_lock = threading.Lock()
        self._closing = False
        self._server = self._bind_ephemeral()
        self._port = self._server.socket.getsockname()[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _bind_ephemeral(self):
        # randomized start offset avoids collisions when many services
        # bind at once on the same host (reference network.py:97-108)
        lo, hi = 1024, 65536
        start = random.randrange(hi - lo)
        for off in range(hi - lo):
            try:
                port = lo + (start + off) % (hi - lo)
                srv = socketserver.ThreadingTCPServer(
                    ("0.0.0.0", port), self._make_handler())
                srv.daemon_threads = True
                return srv
            except OSError:
                continue
        raise RuntimeError("Unable to find a port to bind to.")

    def _make_handler(self):
        service = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                # many requests per connection: the negotiation cycle at
                # 5 ms keeps one persistent socket
                with service._conns_lock:
                    service._conns.add(self.connection)
                # re-check after registering: a racing shutdown() either
                # saw the socket in _conns or set _closing first
                if service._closing:
                    return
                try:
                    self.connection.setsockopt(socket.IPPROTO_TCP,
                                               socket.TCP_NODELAY, 1)
                except OSError:
                    pass
                try:
                    while True:
                        req = service._wire.read(self.rfile)
                        cz = service._chaos
                        fault = (cz.decide("request", type(req).__name__)
                                 if cz else None)
                        if fault == "drop_request":
                            # severed before the handler: no state
                            # applied, the client sees EOF and retries
                            break
                        if fault == "delay_request":
                            time.sleep(cz.delay_s)
                        resp = service._handle(req, self.client_address)
                        if fault == "dup_request":
                            # duplicate delivery: only a service that
                            # dedupes (req_id) survives unchanged
                            resp = service._handle(req,
                                                   self.client_address)
                        if resp is None:
                            raise RuntimeError(
                                "Handler returned no response.")
                        fault = (cz.decide("response",
                                           type(resp).__name__)
                                 if cz else None)
                        if fault == "drop_response":
                            # state was applied; the response is lost
                            break
                        if fault == "truncate_response":
                            service._wire.write_truncated(resp,
                                                          self.wfile)
                            break
                        if fault == "reset":
                            try:
                                self.connection.setsockopt(
                                    socket.SOL_SOCKET, socket.SO_LINGER,
                                    struct.pack("ii", 1, 0))
                            except OSError:
                                pass
                            break  # close with RST: peer sees ECONNRESET
                        if fault == "delay_response":
                            time.sleep(cz.delay_s)
                        service._wire.write(resp, self.wfile)
                except (EOFError, ConnectionError, struct.error):
                    pass
                finally:
                    with service._conns_lock:
                        service._conns.discard(self.connection)

        return Handler

    def _handle(self, req, client_address):
        if isinstance(req, PingRequest):
            return PingResponse(self._service_name, client_address[0])
        raise NotImplementedError(req)

    def addresses(self):
        return {iface: [(ip, self._port) for ip, _ in addrs]
                for iface, addrs in local_addresses().items()}

    @property
    def port(self):
        return self._port

    def shutdown(self):
        self._closing = True  # before severing: see the handler re-check
        self._server.shutdown()
        self._server.server_close()
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class BasicClient:
    """Client that resolves the first reachable (ip, port) of a service.

    addresses: {iface: [(ip, port), ...]} as published by the service.
    Probing happens in parallel threads with the given per-attempt
    timeout (reference network.py _probe/_connect).
    """

    def __init__(self, service_name, addresses, key, probe_timeout=5.0,
                 attempts=3, retry_requests=False, retry_attempts=3,
                 backoff_base_s=0.05, backoff_cap_s=1.0):
        self._service_name = service_name
        self._wire = Wire(key)
        self._timeout = probe_timeout
        self._addr = None
        self._sock = self._rfile = self._wfile = None
        self._req_lock = threading.Lock()  # one in-flight request/conn
        # transport-level resend on a dead persistent socket: only safe
        # when the service deduplicates (the negotiation coordinator's
        # req_id)
        self._retry_requests = retry_requests
        self._retry_attempts = max(0, retry_attempts)
        # capped exponential backoff with full jitter between resends:
        # decorrelated clients do not herd a recovering server
        self._backoff_base_s = backoff_base_s
        self._backoff_cap_s = backoff_cap_s
        self._backoff_rng = random.Random()
        for attempt in range(attempts):
            self._addr = self._probe(addresses)
            if self._addr:
                break
            if attempt < attempts - 1:
                time.sleep(self._backoff_delay(attempt))
        if self._addr is None:
            raise NoValidAddressesFound(
                f"Unable to connect to {service_name} at any of {addresses}")

    def _backoff_delay(self, attempt):
        """Delay before retry #attempt+1: uniform in [0, min(base ·
        2^attempt, cap)]."""
        return self._backoff_rng.uniform(
            0.0, min(self._backoff_base_s * (2 ** attempt),
                     self._backoff_cap_s))

    def _probe(self, addresses):
        results = queue.Queue()
        threads = []
        for addrs in addresses.values():
            for addr in addrs:
                t = threading.Thread(target=self._try_ping,
                                     args=(addr, results), daemon=True)
                t.start()
                threads.append(t)
        for t in threads:
            t.join()
        try:
            return results.get_nowait()
        except queue.Empty:
            return None

    def _try_ping(self, addr, results):
        try:
            resp = self._request_at(PingRequest(), addr)
            if isinstance(resp, PingResponse) and \
                    resp.service_name == self._service_name:
                results.put(addr)
        except Exception:  # noqa: BLE001 — absence from results says it
            pass

    def _request_at(self, req, addr):
        with socket.create_connection(addr, timeout=self._timeout) as sock:
            rfile = sock.makefile("rb")
            wfile = sock.makefile("wb")
            self._wire.write(req, wfile)
            return self._wire.read(rfile)

    def _connect_persistent(self):
        sock = socket.create_connection(self._addr,
                                        timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._rfile = sock.makefile("rb")
        self._wfile = sock.makefile("wb")

    def _close_persistent(self):
        for attr in ("_rfile", "_wfile", "_sock"):
            obj = getattr(self, attr, None)
            if obj is not None:
                try:
                    obj.close()
                except OSError:
                    pass
            setattr(self, attr, None)

    def request(self, req):
        """One request/response over a persistent connection. A dead
        socket closes and, when ``retry_requests``, gets up to
        ``retry_attempts`` reconnect-and-resends under jittered backoff;
        otherwise the error propagates and the next request reconnects."""
        with self._req_lock:
            last = self._retry_attempts if self._retry_requests else 0
            for attempt in range(last + 1):
                try:
                    if self._sock is None:
                        self._connect_persistent()
                    self._wire.write(req, self._wfile)
                    return self._wire.read(self._rfile)
                except (OSError, EOFError, struct.error):
                    self._close_persistent()
                    if attempt == last:
                        raise
                    delay = self._backoff_delay(attempt)
                    reg = hvd_metrics.get_registry()
                    reg.counter(
                        "hvd_transport_retries_total",
                        "Silent reconnect-and-resend retries on a dead "
                        "persistent control-plane socket.").inc()
                    reg.counter(
                        "hvd_transport_backoff_seconds_total",
                        "Total seconds slept in transport retry "
                        "backoff.").inc(delay)
                    time.sleep(delay)
                except BaseException:
                    # e.g. an HMAC mismatch: the stream position is
                    # undefined, never reuse it
                    self._close_persistent()
                    raise

    def close(self):
        """Release the persistent connection (and its server-side handler
        thread)."""
        with self._req_lock:
            self._close_persistent()

    @property
    def address(self):
        return self._addr


def probe_reachable(service_name, addresses, key, timeout=5.0):
    """Which of {iface: [(ip, port)]} answer a valid Ping for
    service_name (reference run/run.py:234-255)."""
    wire = Wire(key)
    reachable = {}
    for iface, addrs in addresses.items():
        for addr in addrs:
            try:
                with socket.create_connection(addr, timeout=timeout) as sock:
                    wire.write(PingRequest(), sock.makefile("wb"))
                    resp = wire.read(sock.makefile("rb"))
            except Exception:  # noqa: BLE001 — an unreachable candidate
                continue
            if isinstance(resp, PingResponse) and \
                    resp.service_name == service_name:
                reachable.setdefault(iface, []).append(addr)
    return reachable
