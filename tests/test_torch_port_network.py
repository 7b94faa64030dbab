"""horovod_tpu_torch's control-plane wire (``run/network.py``,
``run/secret.py``) against the JAX package's: the HMAC digests agree, a
message under the wrong key is refused, a service answers on its
advertised addresses, clients probe, retry and reconnect, and the
interface enumeration (``SIOCGIFADDR`` here, psutil there) finds the
same addresses. Everything runs on this host's own interfaces.
"""

import io
import socket
import struct
import threading

import pytest

from horovod_tpu_torch.run import network as tnet
from horovod_tpu_torch.run import secret as tsecret

KEY = b"k" * 32


class _Echo(tnet.BasicService):
    def __init__(self, key=KEY):
        self.calls = 0
        self._calls_lock = threading.Lock()
        super().__init__("test.echo", key)

    def _handle(self, req, client_address):
        if isinstance(req, dict):
            with self._calls_lock:
                self.calls += 1
            return {"echo": req, "n": self.calls}
        return super()._handle(req, client_address)


def _loopback(port):
    return {"lo": [("127.0.0.1", port)]}


@pytest.fixture
def echo():
    svc = _Echo()
    yield svc
    svc.shutdown()


@pytest.mark.parametrize("message", [b"", b"x", b"horovod" * 100])
def test_digest_matches_jax(message):
    from horovod_tpu.run import secret as jsecret
    key = tsecret.make_secret_key()
    assert len(key) == tsecret.SECRET_LENGTH == jsecret.SECRET_LENGTH
    d = tsecret.compute_digest(key, message)
    assert d == jsecret.compute_digest(key, message)
    assert len(d) == tsecret.DIGEST_LENGTH
    assert tsecret.check_digest(key, message, d)
    assert not tsecret.check_digest(key, message + b"!", d)
    assert tsecret.HVD_SECRET_KEY == jsecret.HVD_SECRET_KEY


def test_wire_round_trip_and_frame():
    wire = tnet.Wire(KEY)
    buf = io.BytesIO()
    wire.write({"a": [1, 2, 3]}, buf)
    raw = buf.getvalue()
    (length,) = struct.unpack("i", raw[32:36])
    assert len(raw) == 32 + 4 + length == wire.bytes_out
    assert wire.read(io.BytesIO(raw)) == {"a": [1, 2, 3]}
    assert wire.bytes_in == wire.bytes_out


def test_wire_refuses_a_message_under_another_key():
    buf = io.BytesIO()
    tnet.Wire(b"a" * 32).write({"cmd": "x"}, buf)
    with pytest.raises(RuntimeError, match="HMAC digest did not match"):
        tnet.Wire(b"b" * 32).read(io.BytesIO(buf.getvalue()))


def test_wire_truncated_frame_reads_as_disconnect():
    buf = io.BytesIO()
    tnet.Wire(KEY).write({"cmd": "x"}, buf)
    raw = buf.getvalue()
    for cut in (10, 34, len(raw) - 1):
        with pytest.raises(EOFError):
            tnet.Wire(KEY).read(io.BytesIO(raw[:cut]))


def test_service_answers_ping_and_requests(echo):
    client = tnet.BasicClient("test.echo", _loopback(echo.port), KEY,
                              probe_timeout=2.0, attempts=1)
    try:
        assert client.address == ("127.0.0.1", echo.port)
        for i in range(3):   # one persistent connection, many requests
            assert client.request({"i": i}) == {"echo": {"i": i},
                                                "n": i + 1}
    finally:
        client.close()


def test_service_answers_on_its_advertised_addresses(echo):
    addrs = echo.addresses()
    assert addrs == {iface: [(ip, echo.port) for ip, _ in pairs]
                     for iface, pairs in tnet.local_addresses().items()}
    reachable = tnet.probe_reachable("test.echo", addrs, KEY, timeout=2.0)
    assert reachable == addrs
    if addrs:   # a host with a non-loopback interface
        client = tnet.BasicClient("test.echo", addrs, KEY,
                                  probe_timeout=2.0, attempts=1)
        try:
            assert client.request({"x": 1})["echo"] == {"x": 1}
        finally:
            client.close()


def test_client_under_the_wrong_key_finds_no_service(echo):
    with pytest.raises(tnet.NoValidAddressesFound):
        tnet.BasicClient("test.echo", _loopback(echo.port), b"z" * 32,
                         probe_timeout=1.0, attempts=1)
    assert tnet.probe_reachable("test.echo", _loopback(echo.port),
                                b"z" * 32, timeout=1.0) == {}


def test_client_refuses_another_service_name(echo):
    with pytest.raises(tnet.NoValidAddressesFound):
        tnet.BasicClient("other.service", _loopback(echo.port), KEY,
                         probe_timeout=1.0, attempts=1)


def test_no_service_at_a_free_port():
    port = tnet.free_port()
    with socket.socket() as s:   # free_port gives a bindable port
        s.bind(("", port))
    with pytest.raises(tnet.NoValidAddressesFound):
        tnet.BasicClient("test.echo", _loopback(port), KEY,
                         probe_timeout=0.5, attempts=2,
                         backoff_base_s=0.01)


def test_retrying_client_reconnects_after_a_severed_socket(echo):
    client = tnet.BasicClient("test.echo", _loopback(echo.port), KEY,
                              probe_timeout=2.0, attempts=1,
                              retry_requests=True, backoff_base_s=0.01)
    try:
        assert client.request({"a": 1})["n"] == 1
        client._sock.shutdown(socket.SHUT_RDWR)   # the wire goes dead
        assert client.request({"a": 2})["echo"] == {"a": 2}
    finally:
        client.close()


def test_shutdown_severs_live_connections():
    svc = _Echo()
    client = tnet.BasicClient("test.echo", _loopback(svc.port), KEY,
                              probe_timeout=1.0, attempts=1)
    try:
        client.request({"a": 1})
        svc.shutdown()
        with pytest.raises((OSError, EOFError)):
            client.request({"a": 2})
    finally:
        client.close()


def test_local_addresses_match_jax():
    from horovod_tpu.run import network as jnet
    assert tnet.local_addresses(7) == jnet.local_addresses(7)
    ip = tnet.advertise_ip()
    socket.inet_aton(ip)   # a dotted quad
