"""The port's etcd registry and NATS plane against the JAX package's, on
the CPU.

The JAX package's own cases (`tests/test_registry.py`,
`tests/test_nats.py`) run against both packages (`torch_tier_cases`; the
port's worker behind the port's frontend there is a CPU engine); then the
wire, both ways: the port's client and worker plane against the JAX
broker, and the JAX client and frontend against the port's broker."""

import json
import threading
import time

import pytest

from dynamo_tpu.serving import nats as jnats
from dynamo_tpu.serving import nats_plane as jnats_plane
from dynamo_tpu_torch.serving import nats, nats_plane
from torch_tier_cases import FixtureCache, cases, run


@pytest.fixture(scope="module")
def tier_fixtures():
    with FixtureCache() as cache:
        yield cache


@pytest.mark.parametrize("pkg,case", cases("test_registry"))
def test_registry_cases(pkg, case, request, tier_fixtures):
    run(request, tier_fixtures, "test_registry", pkg, case)


@pytest.mark.parametrize("pkg,case", cases("test_nats"))
def test_nats_cases(pkg, case, request, tier_fixtures):
    run(request, tier_fixtures, "test_nats", pkg, case)


def wait_for(pred, timeout_s=5.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    pytest.fail(f"timed out waiting for {what}")


# (broker module, client module): the port's client on the JAX broker and
# the JAX client on the port's broker
INTEROP = [pytest.param(jnats, nats, id="port_client-jax_broker"),
           pytest.param(nats, jnats, id="jax_client-port_broker")]


def subscribed(broker, n):
    """Poll until the broker holds `n` subscriptions in all."""
    wait_for(lambda: sum(len(c.subs) for c in list(broker._conns)) >= n,
             what=f"{n} subscriptions at the broker")


@pytest.mark.parametrize("broker_mod,client_mod", INTEROP)
def test_pub_sub_queue_groups_and_headers_interoperate(broker_mod,
                                                       client_mod):
    broker = broker_mod.MiniNatsBroker()
    other = jnats if client_mod is nats else nats
    a = client_mod.NatsClient(broker.url, name="a")
    b = other.NatsClient(broker.url, name="b")
    try:
        got, grouped, marks = [], [], []
        a.subscribe("dynamo.kv_events.>", got.append)
        for c in (a, b):
            c.subscribe("work.q", grouped.append, queue_group="workers")
            c.subscribe("work.mark", marks.append)
        subscribed(broker, 5)
        b.publish("dynamo.kv_events.m.w", b'{"x": 1}',
                  headers={"traceparent": "00-abc-def-01"})
        a.publish("work.q", b"one")
        # published after "one" by the same client: once both clients
        # hold it, any delivery of "one" has arrived
        a.publish("work.mark", b"mark")
        wait_for(lambda: got and len(marks) == 2, what="delivery")
        assert got[0].data == b'{"x": 1}'
        assert got[0].parsed_headers() == {"traceparent": "00-abc-def-01"}
        assert [m.data for m in grouped] == [b"one"], \
            "a queue group delivers to one member"
    finally:
        a.close()
        b.close()
        broker.close()


class _Responder:
    """A stand-in worker HTTP server for the request plane's bridge."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = self
        self.headers = []

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                outer.headers.append(self.headers.get("x-request-id"))
                out = json.dumps({"echo": body, "path": self.path}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"


@pytest.mark.parametrize("broker_mod,client_mod", INTEROP)
def test_request_plane_interoperates(broker_mod, client_mod):
    """One package's worker plane answers the other package's frontend
    call (`nats_request`) over a broker of the first."""
    plane_mod = nats_plane if client_mod is jnats else jnats_plane
    call_mod = jnats_plane if plane_mod is nats_plane else nats_plane
    broker = broker_mod.MiniNatsBroker()
    worker = _Responder()
    plane = plane_mod.WorkerNatsPlane(broker.url, worker.url, "tiny-debug")
    nc = client_mod.NatsClient(broker.url, name="frontend")
    try:
        subscribed(broker, 2)  # the worker's subject and its queue group
        status, ctype, chunks = call_mod.nats_request(
            nc, call_mod.worker_subject(worker.url), "/v1/completions",
            {"prompt": "hi"}, timeout=10,
            trace_headers={"x-request-id": "rid-1"})
        body = json.loads(b"".join(chunks))
        assert (status, ctype) == (200, "application/json")
        assert body == {"echo": {"prompt": "hi"}, "path": "/v1/completions"}
        assert worker.headers == ["rid-1"]
    finally:
        nc.close()
        plane.close()
        worker.srv.shutdown()
        broker.close()


def test_client_and_broker_sockets_send_small_frames_at_once():
    """The port's NATS client and broker set TCP_NODELAY (the JAX copies
    do not): the request plane's back-to-back small frames otherwise wait
    out the peer's delayed-ACK timer at every hop."""
    import socket

    broker = nats.MiniNatsBroker()
    nc = nats.NatsClient(broker.url, name="nodelay")
    try:
        wait_for(lambda: broker._conns, what="the broker's connection")
        socks = [nc.sock] + [c.sock for c in list(broker._conns)]
        assert all(s.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY)
                   for s in socks)
    finally:
        nc.close()
        broker.close()
