"""Minimal NATS client + embedded broker (core protocol, dependency-free).

The port's own copy of `dynamo_tpu/serving/nats.py` (it imports nothing
of the JAX package); keep the two in step. One divergence: the client's
and the broker's sockets set TCP_NODELAY. The plane writes small frames
back to back (ack, head, chunks), and with Nagle's algorithm each one
after the first waited for the peer's delayed-ACK timer, so a stream's
first event over NATS came tens of ms after the same event over HTTP.

The reference platform runs NATS as its frontend<->worker request plane
(reference install-dynamo-1node.sh:241-242, README.md:334). This module
makes that plane REAL here rather than ornamental: the frontend publishes
requests to per-worker / queue-group subjects and workers stream response
chunks back over reply inboxes (dynamo_tpu_torch.serving.nats_plane).

Two pieces:
- `NatsClient`: a synchronous client speaking the standard NATS text protocol
  (INFO/CONNECT/PING/PONG/SUB/PUB/MSG, HMSG from headers-enabled servers,
  queue groups, reply inboxes) — works against the official `nats-server`
  the platform manifests deploy (deploy/platform/nats.yaml); conformance
  covered by recorded-transcript tests plus an opt-in run against the real
  binary (tests/test_nats_conformance.py).
- `MiniNatsBroker`: an in-process broker implementing the same core subset,
  used by the test suite and for single-node dev (`python -m
  dynamo_tpu_torch.serving.nats` serves one on :4222). Subject matching supports
  the `*` token and `>` tail wildcards.

No JetStream/auth/TLS — core pub/sub is exactly what the request plane needs
(at-most-once; HTTP remains the fallback path on timeout).
"""

from __future__ import annotations

import json
import logging
import queue
import socket
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from dynamo_tpu_torch.robustness import faults

log = logging.getLogger("dynamo_tpu_torch.nats")

DEFAULT_PORT = 4222


def parse_url(url: str) -> Tuple[str, int]:
    """nats://host:port (scheme optional)."""
    u = url.strip()
    if "://" in u:
        u = u.split("://", 1)[1]
    if "/" in u:
        u = u.split("/", 1)[0]
    if ":" in u:
        host, port = u.rsplit(":", 1)
        return host, int(port)
    return u, DEFAULT_PORT


def subject_token(raw: str) -> str:
    """Sanitize an arbitrary string (model name, worker URL) into a single
    NATS subject token (no dots/spaces/wildcards)."""
    return "".join(c if c.isalnum() or c in "-_" else "-" for c in raw)


HEADER_VERSION_LINE = b"NATS/1.0"


def encode_headers(headers: Dict[str, str]) -> bytes:
    """Encode a NATS message-header block (the HPUB wire form): version
    line + `Key: Value` pairs + blank line. Values are sanitized of CR/LF
    so a hostile value cannot smuggle extra header lines."""
    out = [HEADER_VERSION_LINE]
    for k, v in headers.items():
        v = str(v).replace("\r", " ").replace("\n", " ")
        out.append(f"{k}: {v}".encode())
    return b"\r\n".join(out) + b"\r\n\r\n"


def decode_headers(raw: Optional[bytes]) -> Dict[str, str]:
    """Parse the raw header block off an HMSG frame into a dict (header
    names lowercased: NATS headers are case-insensitive like HTTP's).
    Tolerant: malformed lines are skipped, never raised."""
    if not raw:
        return {}
    out: Dict[str, str] = {}
    for line in raw.split(b"\r\n"):
        if not line or line.startswith(HEADER_VERSION_LINE):
            continue
        k, sep, v = line.partition(b":")
        if not sep:
            continue
        out[k.decode("utf-8", "replace").strip().lower()] = (
            v.decode("utf-8", "replace").strip())
    return out


def _subject_matches(pattern: str, subject: str) -> bool:
    pt, st = pattern.split("."), subject.split(".")
    for i, p in enumerate(pt):
        if p == ">":
            return True
        if i >= len(st):
            return False
        if p != "*" and p != st[i]:
            return False
    return len(pt) == len(st)


class _LineReader:
    """Buffered protocol reader over a socket."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = b""

    def read_line(self) -> bytes:
        while b"\r\n" not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("nats connection closed")
            self.buf += chunk
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def read_exact(self, n: int) -> bytes:
        while len(self.buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("nats connection closed")
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out


class Msg:
    __slots__ = ("subject", "reply", "data", "headers")

    def __init__(self, subject: str, reply: Optional[str], data: bytes,
                 headers: Optional[bytes] = None):
        self.subject = subject
        self.reply = reply
        self.data = data
        # raw NATS/1.0 header block from HMSG frames (None for MSG) — the
        # request plane carries trace context here (nats_plane)
        self.headers = headers

    def parsed_headers(self) -> Dict[str, str]:
        return decode_headers(self.headers)


class NatsClient:
    """Synchronous NATS client; a reader thread dispatches MSG callbacks.

    Resilient to broker restarts: on disconnect the reader thread redials
    with exponential backoff and re-sends every active subscription, so
    long-lived planes (worker responders, frontend routers) survive a
    nats-server pod bounce. Publishes during the outage raise
    ConnectionError/OSError — callers (the frontend) already treat plane
    failures as fall-back-to-HTTP."""

    RECONNECT_MAX_BACKOFF_S = 15.0

    def __init__(self, url: str, name: str = "dynamo-tpu",
                 connect_timeout: float = 5.0):
        self._url = url
        self._name = name
        self._connect_timeout = connect_timeout
        self._wlock = threading.Lock()
        self._subs: Dict[int, Callable[[Msg], None]] = {}
        # sid -> (subject, queue_group), for re-subscription after redial
        self._sub_specs: Dict[int, Tuple[str, Optional[str]]] = {}
        self._next_sid = 1
        self._closed = False
        # readiness signal (the frontend's /healthz gate): True while a
        # live connection is up, False from disconnect until redial lands
        self._connected = False
        self._connect()
        self._thread = threading.Thread(target=self._read_loop, daemon=True,
                                        name="nats-reader")
        self._thread.start()

    def _connect(self) -> None:
        host, port = parse_url(self._url)
        sock = socket.create_connection((host, port),
                                        timeout=self._connect_timeout)
        # small frames go out at once (see the module doc)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # keep the timeout through the greeting: a peer that accepts TCP but
        # never sends INFO must not hang the (sole) reconnect thread
        reader = _LineReader(sock)
        try:
            info = reader.read_line()
        except socket.timeout:
            sock.close()
            raise ConnectionError("timed out waiting for NATS INFO") from None
        if not info.startswith(b"INFO "):
            sock.close()
            raise ConnectionError(f"unexpected NATS greeting: {info[:64]!r}")
        sock.settimeout(None)
        connect = (
            b"CONNECT "
            + json.dumps({"verbose": False, "pedantic": False,
                          "name": self._name, "lang": "python",
                          "version": "0", "protocol": 1,
                          # we can PARSE HMSG (defensive), so advertising
                          # headers support is honest — a headers-enabled
                          # nats-server may then route headered publishes
                          # from other clients to us intact
                          "headers": True, "no_responders": False}).encode()
            + b"\r\n"
        )
        # re-send active subscriptions (no-op on first connect)
        for sid, (subject, group) in list(self._sub_specs.items()):
            q = f" {group}" if group else ""
            connect += f"SUB {subject}{q} {sid}\r\n".encode()
        sock.sendall(connect)
        with self._wlock:
            self.sock = sock
            self._reader = reader
        self._connected = True

    # ------------------------------------------------------------------ io --
    def _send(self, data: bytes) -> None:
        with self._wlock:
            # _wlock exists precisely to serialize writers on this socket
            # (interleaved partial frames corrupt the protocol stream)
            self.sock.sendall(data)  # dynalint: off blocking-under-lock

    def _dispatch(self, sid: int, msg: Msg) -> None:
        cb = self._subs.get(sid)
        if cb is not None:
            try:
                cb(msg)
            except Exception:
                log.exception("nats subscription callback failed")

    def _skip_frame(self, line: bytes, parts) -> None:
        """Resync past a malformed/future-variant MSG/HMSG control line.

        Both variants advertise the payload byte count as the LAST token;
        consuming that many bytes (+CRLF) realigns the stream so one odd
        frame doesn't tear down the connection and force a full reconnect.
        When even the count is unparseable, give up on this frame and let
        the next read_line find the next control line (worst case the
        server closes on protocol error and the redial loop recovers)."""
        log.warning("malformed nats control line %r; skipping one frame",
                    line[:120])
        try:
            n = int(parts[-1])
        except (ValueError, IndexError):
            return
        if 0 <= n <= (64 << 20):  # a garbage count must not hang the reader
            self._reader.read_exact(n)
            self._reader.read_exact(2)

    def _read_loop(self) -> None:
        backoff = 0.2
        while not self._closed:
            try:
                while not self._closed:
                    line = self._reader.read_line()
                    backoff = 0.2  # healthy traffic resets the redial clock
                    # first whitespace-delimited token routes the frame:
                    # the protocol permits tab separators, which a
                    # startswith(b"MSG ") check would misroute to ignore
                    # (and then misparse the payload as control lines)
                    op = line.split(None, 1)[0] if line.strip() else b""
                    if line == b"PING":
                        self._send(b"PONG\r\n")
                    elif op == b"MSG":
                        # MSG <subject> <sid> [reply-to] <#bytes> — split()
                        # tolerates the runs of spaces/tabs the protocol
                        # permits; a malformed line costs one frame, not
                        # the whole connection (see _skip_frame)
                        # "replace" decoding: a misaligned stream can hand
                        # payload bytes to the control-line parser, and a
                        # UnicodeDecodeError here would kill the reader
                        # thread with no redial — garbage must cost frames,
                        # never the loop
                        parts = line.decode("utf-8", "replace").split()
                        if len(parts) == 5:
                            _, subject, sid, reply, nbytes = parts
                        elif len(parts) == 4:
                            _, subject, sid, nbytes = parts
                            reply = None
                        else:
                            self._skip_frame(line, parts)
                            continue
                        try:
                            n, isid = int(nbytes), int(sid)
                        except ValueError:
                            self._skip_frame(line, parts)
                            continue
                        data = self._reader.read_exact(n)
                        self._reader.read_exact(2)  # trailing CRLF
                        self._dispatch(isid, Msg(subject, reply, data))
                    elif op == b"HMSG":
                        # HMSG <subject> <sid> [reply-to] <#hdr> <#total> —
                        # sent by headers-enabled servers (nats-server 2.2+)
                        # when a peer publishes with headers. Headers ride
                        # along raw; payload is the post-header remainder.
                        parts = line.decode("utf-8", "replace").split()
                        if len(parts) == 6:
                            _, subject, sid, reply, hbytes, tbytes = parts
                        elif len(parts) == 5:
                            _, subject, sid, hbytes, tbytes = parts
                            reply = None
                        else:
                            self._skip_frame(line, parts)
                            continue
                        try:
                            nt, nh, isid = int(tbytes), int(hbytes), int(sid)
                        except ValueError:
                            self._skip_frame(line, parts)
                            continue
                        blob = self._reader.read_exact(nt)
                        self._reader.read_exact(2)  # trailing CRLF
                        self._dispatch(
                            isid,
                            Msg(subject, reply, blob[nh:], headers=blob[:nh]))
                    elif line.startswith(b"-ERR"):
                        log.warning("nats error: %s",
                                    line.decode(errors="replace"))
                    # +OK / PONG / INFO updates: ignore
            except (ConnectionError, OSError):
                if self._closed:
                    return
                self._connected = False
                log.warning("nats disconnected; redialing %s", self._url)
            try:
                # release the dead connection: a half-open socket pins the
                # broker-side port and leaks an fd per redial
                self.sock.close()
            except OSError:
                pass
            while not self._closed:
                try:
                    self._connect()
                    log.info("nats reconnected to %s (%d subscriptions)",
                             self._url, len(self._sub_specs))
                    break
                except OSError:
                    time.sleep(backoff)
                    backoff = min(backoff * 2,
                                  self.RECONNECT_MAX_BACKOFF_S)

    # ------------------------------------------------------------- surface --
    @property
    def connected(self) -> bool:
        return self._connected and not self._closed

    def publish(self, subject: str, data: bytes,
                reply: Optional[str] = None,
                headers: Optional[Dict[str, str]] = None) -> None:
        """PUB, or HPUB when `headers` is given (nats-server 2.2+ and the
        mini broker both speak it) — trace context rides NATS message
        headers exactly as it rides HTTP headers."""
        # chaos plane: a partitioned NATS fails every publish — the
        # frontend's request path falls back to HTTP, worker responders
        # fail their reply stream (docs/robustness.md)
        faults.raise_point("nats.partition", ConnectionError)
        if headers:
            hblock = encode_headers(headers)
            head = (f"HPUB {subject} {reply + ' ' if reply else ''}"
                    f"{len(hblock)} {len(hblock) + len(data)}\r\n")
            self._send(head.encode() + hblock + data + b"\r\n")
            return
        head = f"PUB {subject} {reply + ' ' if reply else ''}{len(data)}\r\n"
        self._send(head.encode() + data + b"\r\n")

    def subscribe(self, subject: str, cb: Callable[[Msg], None],
                  queue_group: Optional[str] = None) -> int:
        with self._wlock:  # sid allocation races across handler threads
            sid = self._next_sid
            self._next_sid += 1
        self._subs[sid] = cb
        self._sub_specs[sid] = (subject, queue_group)
        q = f" {queue_group}" if queue_group else ""
        self._send(f"SUB {subject}{q} {sid}\r\n".encode())
        return sid

    def unsubscribe(self, sid: int) -> None:
        self._subs.pop(sid, None)
        self._sub_specs.pop(sid, None)
        try:
            self._send(f"UNSUB {sid}\r\n".encode())
        except OSError:
            pass

    def new_inbox(self) -> str:
        return f"_INBOX.{uuid.uuid4().hex}"

    def request_stream(self, subject: str, data: bytes,
                       timeout: float = 600.0,
                       first_timeout: Optional[float] = None,
                       headers: Optional[Dict[str, str]] = None):
        """Publish with a reply inbox; yield reply Msgs until the responder
        sends a message whose JSON body has "done": true.

        `first_timeout` bounds the wait for the FIRST reply separately —
        core NATS silently drops publishes with no subscriber, so a missing
        responder should fail fast instead of eating the full stream
        timeout. Raises TimeoutError on either bound."""
        inbox = self.new_inbox()
        q: "queue.Queue[Msg]" = queue.Queue()
        sid = self.subscribe(inbox, q.put)
        try:
            self.publish(subject, data, reply=inbox, headers=headers)
            wait = first_timeout if first_timeout is not None else timeout
            while True:
                try:
                    msg = q.get(timeout=wait)
                except queue.Empty:
                    raise TimeoutError(
                        f"no reply on {subject} within {wait}s"
                    ) from None
                wait = timeout
                yield msg
                try:
                    if json.loads(msg.data).get("done"):
                        return
                except (json.JSONDecodeError, AttributeError):
                    pass
        finally:
            self.unsubscribe(sid)

    def request(self, subject: str, data: bytes,
                timeout: float = 30.0) -> bytes:
        for msg in self.request_stream(subject, data, timeout=timeout):
            return msg.data
        raise TimeoutError(f"no responder on {subject}")

    def close(self) -> None:
        self._closed = True
        try:
            self.sock.close()
        except OSError:
            pass


# ------------------------------------------------------------------ broker --


class _BrokerConn:
    def __init__(self, sock: socket.socket, broker: "MiniNatsBroker"):
        self.sock = sock
        self.broker = broker
        self.reader = _LineReader(sock)
        self.wlock = threading.Lock()
        # sid -> (subject_pattern, queue_group)
        self.subs: Dict[int, Tuple[str, Optional[str]]] = {}
        self.alive = True

    def send(self, data: bytes) -> None:
        try:
            with self.wlock:
                # wlock serializes broker->client frame writes — holding
                # it across the send IS the point (frame atomicity)
                self.sock.sendall(data)  # dynalint: off blocking-under-lock
        except OSError:
            self.alive = False

    def serve(self) -> None:
        self.send(b'INFO {"server_name":"dynamo-tpu-mini-nats","version":"0"}\r\n')
        try:
            while True:
                line = self.reader.read_line()
                verb = line.split(b" ", 1)[0].upper()
                if verb == b"CONNECT":
                    pass
                elif verb == b"PING":
                    self.send(b"PONG\r\n")
                elif verb == b"PONG":
                    pass
                elif verb == b"SUB":
                    parts = line.decode().split(" ")
                    if len(parts) == 4:
                        _, subject, group, sid = parts
                    else:
                        _, subject, sid = parts
                        group = None
                    self.subs[int(sid)] = (subject, group)
                elif verb == b"UNSUB":
                    sid = int(line.decode().split(" ")[1])
                    self.subs.pop(sid, None)
                elif verb == b"PUB":
                    parts = line.decode().split(" ")
                    if len(parts) == 4:
                        _, subject, reply, nbytes = parts
                    else:
                        _, subject, nbytes = parts
                        reply = None
                    data = self.reader.read_exact(int(nbytes))
                    self.reader.read_exact(2)
                    self.broker.route(subject, reply, data)
                elif verb == b"HPUB":
                    # HPUB <subject> [reply] <#hdr> <#total>: the first
                    # #hdr bytes of the payload are the header block
                    parts = line.decode().split(" ")
                    if len(parts) == 5:
                        _, subject, reply, hbytes, tbytes = parts
                    else:
                        _, subject, hbytes, tbytes = parts
                        reply = None
                    blob = self.reader.read_exact(int(tbytes))
                    self.reader.read_exact(2)
                    nh = int(hbytes)
                    self.broker.route(subject, reply, blob[nh:],
                                      headers=blob[:nh])
        except (ConnectionError, OSError):
            pass
        finally:
            self.alive = False
            self.broker.drop(self)


class MiniNatsBroker:
    """In-process NATS-core broker: pub/sub, queue groups, wildcards."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._conns: List[_BrokerConn] = []
        self._lock = threading.Lock()
        self._rr = 0  # queue-group round-robin cursor
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="mini-nats-accept"
        )
        self._closed = False
        self._accept_thread.start()

    @property
    def url(self) -> str:
        return f"nats://{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._srv.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _BrokerConn(sock, self)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=conn.serve, daemon=True,
                             name="mini-nats-conn").start()

    def drop(self, conn: _BrokerConn) -> None:
        with self._lock:
            if conn in self._conns:
                self._conns.remove(conn)

    def route(self, subject: str, reply: Optional[str], data: bytes,
              headers: Optional[bytes] = None) -> None:
        """Deliver to every plain match; ONE member per queue group.
        Headered publishes fan out as HMSG (every client here advertises
        headers support in CONNECT, so no per-client downgrade path)."""
        plain: List[Tuple[_BrokerConn, int]] = []
        groups: Dict[str, List[Tuple[_BrokerConn, int]]] = {}
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            for sid, (pattern, group) in list(conn.subs.items()):
                if not _subject_matches(pattern, subject):
                    continue
                if group:
                    groups.setdefault(group, []).append((conn, sid))
                else:
                    plain.append((conn, sid))
        for group_members in groups.values():
            self._rr += 1
            plain.append(group_members[self._rr % len(group_members)])
        head_reply = f" {reply}" if reply else ""
        for conn, sid in plain:
            if headers:
                conn.send(
                    f"HMSG {subject} {sid}{head_reply} {len(headers)} "
                    f"{len(headers) + len(data)}\r\n".encode()
                    + headers + data + b"\r\n"
                )
            else:
                conn.send(
                    f"MSG {subject} {sid}{head_reply} {len(data)}\r\n".encode()
                    + data + b"\r\n"
                )

    def close(self) -> None:
        self._closed = True
        try:
            # shutdown() wakes the accept() thread; a bare close() while a
            # thread blocks in accept leaves the listener fd (and the port)
            # alive indefinitely
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=2)
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                # same blocked-thread quirk as the listener: shutdown()
                # wakes the conn's recv loop so close actually releases it
                c.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.sock.close()
            except OSError:
                pass


def main() -> None:  # pragma: no cover - dev convenience
    import time

    logging.basicConfig(level="INFO")
    broker = MiniNatsBroker(host="0.0.0.0", port=DEFAULT_PORT)
    log.info("mini NATS broker on %s", broker.url)
    while True:
        time.sleep(60)


if __name__ == "__main__":  # pragma: no cover
    main()
