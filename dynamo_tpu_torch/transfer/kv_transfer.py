"""KV-cache handoff between prefill and decode workers.

The port's counterpart of `dynamo_tpu/transfer/kv_transfer.py`. Three data
planes, picked by the decode side (`serving/disagg.py`) under
`--disaggregation-transfer-backend` (the reference's
examples/deploy/sglang/disagg.yaml:47-48):

- "ici", in process (`ICIHandoff`, found through `transfer.ici_registry`):
  both roles in one process on one card; the prefill engine's gather and
  the decode engine's in-place scatter are two device copies, no host
  bounce.
- "ici", across processes (`DeviceKVSource` / `DeviceKVClient`): the JAX
  package's `jax.experimental.transfer` pull becomes CUDA IPC between two
  processes on the one card (or on two cards with peer access). The
  prefill side gathers the parked pages into a fresh device tensor (never
  a view of the pools: an IPC handle opens its whole caching-allocator
  block) on the stream its steps use, exports the tensor's IPC handle with
  an IPC event recorded after the gather (torch's own
  `torch.multiprocessing.reductions.reduce_tensor`), and holds the tensor
  until `/disagg/release` or the TTL sweep; the decode side opens the
  handle (its stream waits on the event) and scatters the pages into its
  pools. A process cannot open its own handle, so the in-process case
  never comes here. A pair that can do neither degrades to the TCP plane
  with a loud per-pair warning on the decode side.
- "dcn" (`KVSource` / `fetch_kv`): pages serialize to bytes and stream
  over the native transport (`transfer/transport.py`), with NIXL-style key
  rendezvous on the prefill worker's bootstrap port; it bounces through
  host memory.

The KVBM's cross-worker pull (`HostTierSource` / `fetch_host_blocks`)
rides the same TCP plane. Both TCP wire formats are the JAX package's, so
either package's end talks to the other's (tests/test_torch_disagg_wire.py):

- dcn: one JSON header {request_id, n_tokens, dtype, shape} (or {error}),
  then one message per tensor (k then v, raw bytes, C order, shape
  [L, n_pages, page_size, lanes]), then the puller's b"OK" ack, on which
  the source releases the parked pages;
- kvbm: the peer sends {"blocks": [hex hash, ...]}, the source answers
  {"found": n, "shape", "dtype"} for the longest run from the start it
  holds, then n (k, v) raw-byte message pairs in host-pool layout.

Host tensors here are torch CPU tensors; dtype names are the JAX ones
("bfloat16", "float32", "int8").
"""

from __future__ import annotations

import base64
import json
import logging
import secrets
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from dynamo_tpu_torch.transfer import transport

log = logging.getLogger("dynamo_tpu_torch.kv_transfer")


def _tobytes(t: torch.Tensor) -> bytes:
    """A host tensor's raw bytes, C order (bfloat16 has no numpy dtype:
    the bytes and the dtype's name travel instead)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy() \
        .tobytes()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _frombytes(data: bytes, dtype: str, shape) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=getattr(torch, dtype)) \
        .reshape(tuple(shape))


class KVSource:
    """Prefill-worker side: holds exported KV until the decode side pulls
    it. One accept thread serves the bootstrap port; each parked request is
    keyed by request_id. After a successful pull (or expiry) the engine's
    parked pages are released."""

    def __init__(self, engine, port: int = 0, parked_ttl_s: float = 120.0):
        self.engine = engine
        self.parked_ttl_s = parked_ttl_s
        self.listener = transport.Listener(port)
        self.port = self.listener.port
        self._stop = False
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="kv-source")
        self._thread.start()

    def close(self):
        self._stop = True
        self.listener.close()

    def _serve(self):
        last_expiry = 0.0
        while not self._stop:
            now = time.monotonic()
            if now - last_expiry > 10.0:
                # reclaim KV parked for peers that never pulled (a crash or
                # a lost ack), so failures cannot bleed the page pool dry
                self.engine.expire_parked(self.parked_ttl_s)
                last_expiry = now
            try:
                conn, key = self.listener.accept(timeout_ms=500)
            except TimeoutError:
                continue
            except Exception:
                if self._stop:
                    return
                log.exception("kv-source accept failed")
                continue
            threading.Thread(target=self._handle, args=(conn, key),
                             daemon=True).start()

    def _handle(self, conn: transport.Connection, request_id: str):
        try:
            k, v, n_tokens = self.engine.export_kv(request_id)
            header = {"request_id": request_id, "n_tokens": n_tokens,
                      "dtype": _dtype_name(k), "shape": list(k.shape)}
            conn.send_msg(json.dumps(header).encode())
            conn.send_msg(_tobytes(k))
            conn.send_msg(_tobytes(v))
            # wait for the ack, so the pages outlive a failure mid-transfer
            if conn.recv_msg(max_len=64) == b"OK":
                self.engine.release_parked(request_id)
        except KeyError:
            try:
                conn.send_msg(json.dumps({"error": "unknown request"})
                              .encode())
            except Exception:
                pass
        except Exception:
            log.exception("kv transfer for %s failed", request_id)
        finally:
            conn.close()


def fetch_kv(host: str, port: int, request_id: str
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Decode-worker side: pull one sequence's KV. Returns (k, v, n_tokens),
    host tensors [L, n_pages, page_size, lanes]."""
    conn = transport.connect(host, port, request_id)
    try:
        header = json.loads(conn.recv_msg(max_len=1 << 16))
        if "error" in header:
            raise KeyError(f"prefill side: {header['error']}")
        k = _frombytes(conn.recv_msg(), header["dtype"], header["shape"])
        v = _frombytes(conn.recv_msg(), header["dtype"], header["shape"])
        conn.send_msg(b"OK")
        return k, v, header["n_tokens"]
    finally:
        conn.close()


# ----------------------------------------------------------- KVBM host tier --
# Cross-worker onboard (kvbm/manager.py `peer_fetch`): on a miss a worker
# pulls demoted prefix BLOCKS from a peer's host tier over this same TCP
# plane instead of re-prefilling them. One connection per pull; the key
# namespace ("kvbm") keeps it off the per-request parked-KV protocol above.

KVBM_KEY = "kvbm"


class HostTierSource:
    """Serves a worker's KVBM host-tier blocks to pulling peers. Blocks are
    copied out of the pool under its lock (`HostBlockPool.get`, after the
    slot's device copy), so concurrent demotes and LRU evictions cannot
    tear a served block."""

    def __init__(self, kvbm, port: int = 0):
        self.kvbm = kvbm
        self.listener = transport.Listener(port)
        self.port = self.listener.port
        self._stop = False
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="kvbm-host-tier")
        self._thread.start()

    def close(self):
        self._stop = True
        self.listener.close()

    def _serve(self):
        while not self._stop:
            try:
                conn, key = self.listener.accept(timeout_ms=500)
            except TimeoutError:
                continue
            except Exception:
                if self._stop:
                    return
                log.exception("kvbm host-tier accept failed")
                continue
            if key != KVBM_KEY:
                conn.close()
                continue
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: transport.Connection):
        try:
            req = json.loads(conn.recv_msg(max_len=1 << 20))
            blocks = []
            for h in req.get("blocks", []):
                got = self.kvbm.pool.get(bytes.fromhex(h))
                if got is None:
                    break
                blocks.append(got)
            header = {"found": len(blocks)}
            if blocks:
                header["shape"] = list(blocks[0][0].shape)
                header["dtype"] = _dtype_name(blocks[0][0])
            conn.send_msg(json.dumps(header).encode())
            for k, v in blocks:
                conn.send_msg(_tobytes(k))
                conn.send_msg(_tobytes(v))
        except Exception:
            log.exception("kvbm host-tier pull failed")
        finally:
            conn.close()


def fetch_host_blocks(host: str, port: int, hashes_hex
                      ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Pull host-tier blocks from a peer. Returns the consecutive run from
    the start that the peer held, as (k, v) host tensors in host-pool
    layout [L, page_size, lanes]."""
    conn = transport.connect(host, port, KVBM_KEY)
    try:
        conn.send_msg(json.dumps({"blocks": list(hashes_hex)}).encode())
        header = json.loads(conn.recv_msg(max_len=1 << 16))
        out = []
        for _ in range(int(header.get("found", 0))):
            k = _frombytes(conn.recv_msg(), header["dtype"], header["shape"])
            v = _frombytes(conn.recv_msg(), header["dtype"], header["shape"])
            out.append((k, v))
        return out
    finally:
        conn.close()


# ------------------------------------------------------- device-buffer plane --


def device_uuid(device) -> Optional[str]:
    """The physical card behind a CUDA device ("GPU-..."), None off CUDA:
    two processes on one card see one UUID whatever their device index."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return f"GPU-{torch.cuda.get_device_properties(device).uuid}"


def peer_reachable(uuid: Optional[str], device) -> bool:
    """Whether memory on the card `uuid` can be opened from `device`: the
    same physical card, or a visible card `device` has peer access to."""
    if uuid is None:
        return False
    local = device_uuid(device)
    if local is None:
        return False
    if uuid == local:
        return True
    here = torch.device(device).index or 0
    for i in range(torch.cuda.device_count()):
        if i != here and device_uuid(torch.device("cuda", i)) == uuid:
            return torch.cuda.can_device_access_peer(here, i)
    return False


def _b64(raw) -> Optional[str]:
    return None if raw is None else base64.b64encode(bytes(raw)).decode()


def _unb64(s: Optional[str]) -> Optional[bytes]:
    return None if s is None else base64.b64decode(s)


def cuda_ipc_export(t: torch.Tensor) -> dict:
    """A device tensor's CUDA IPC descriptor (JSON-safe): torch's own
    reduction (`reduce_tensor`), which shares the tensor's storage block,
    registers the producer-side reference count and records an IPC event
    on the current stream, so the importer's stream waits for every launch
    queued before the export (the gather)."""
    from torch.multiprocessing.reductions import reduce_tensor

    (_, size, stride, offset, _, dtype, dev, handle, storage_bytes,
     storage_offset, _, rc_handle, rc_offset, ev_handle,
     ev_sync) = reduce_tensor(t)[1]
    return {"size": list(size), "stride": list(stride), "offset": offset,
            "dtype": str(dtype).replace("torch.", ""), "device": dev,
            "handle": _b64(handle), "storage_bytes": storage_bytes,
            "storage_offset": storage_offset,
            "ref_counter_handle": _b64(rc_handle),
            "ref_counter_offset": rc_offset,
            "event_handle": _b64(ev_handle), "event_sync": bool(ev_sync)}


def cuda_ipc_import(desc: dict, device) -> torch.Tensor:
    """Open a `cuda_ipc_export` descriptor in this process, on `device`
    (the producer's card, or one with peer access to it)."""
    from torch.multiprocessing.reductions import rebuild_cuda_tensor

    dev = torch.device(device)
    return rebuild_cuda_tensor(
        torch.Tensor, torch.Size(desc["size"]), tuple(desc["stride"]),
        desc["offset"], torch.storage.TypedStorage,
        getattr(torch, desc["dtype"]), dev.index or 0,
        _unb64(desc["handle"]), desc["storage_bytes"],
        desc["storage_offset"], False, _unb64(desc["ref_counter_handle"]),
        desc["ref_counter_offset"], _unb64(desc["event_handle"]),
        desc["event_sync"])


class DeviceKVSource:
    """Prefill side: stages a parked sequence's KV for a pull over CUDA IPC.

    Staging is LAZY (the decode side's /disagg/stage RPC, not the prefill
    response): an eager stage would pin a gathered copy in device memory
    for every request whose peer then pulls over TCP instead. The stage
    holds the gathered tensors until the decode side's /disagg/release
    (or the engine's parked-KV TTL frees the pages; the gather stays).

    The ledger is the JAX package's (its `jax.experimental.transfer`
    server has no un-await; an exported IPC block likewise stays mapped by
    a peer that crashed before releasing):
    - outstanding stages are CAPPED (`max_staged`), counting both live
      stages and expired-but-never-released ones, so the cap bounds the
      pinned device memory; past it, stage() refuses and the peer degrades
      to the TCP plane.
    - a TTL sweep demotes expired entries to the leaked ledger, loudly, so
      operators see stage-then-crash peers in logs and /worker/stats; a
      late re-stage for a leaked request RESURRECTS the original
      coordinates instead of pinning a second gather.
    - each stage carries a fresh nonce, so a re-stage after a release is
      never mistaken for the old one.
    - a duplicate stage() for a request still staged returns the ORIGINAL
      coordinates (the peer retried the RPC or lost the response). The
      whole stage body runs under one lock, so concurrent duplicates never
      double-pin.

    `export(tensor) -> dict` makes a tensor's descriptor (default: CUDA
    IPC); `uuid` names the card the exports live on (default: the
    engine's). A test on the CPU gives both."""

    def __init__(self, engine, staged_ttl_s: float = 120.0,
                 max_staged: int = 64,
                 export: Optional[Callable[[torch.Tensor], dict]] = None,
                 uuid: Optional[str] = None):
        self.engine = engine
        self.staged_ttl_s = staged_ttl_s
        self.max_staged = max_staged
        self._export = export or cuda_ipc_export
        self.uuid = uuid if uuid is not None else device_uuid(engine.device)
        self._warned = False
        self._lock = threading.Lock()
        # request_id -> (monotonic ts, descriptor dict, (k, v) tensors)
        self._staged: Dict[str, tuple] = {}
        # expired un-released stages: still pinned, still holding cap slots
        self._leaked: Dict[str, tuple] = {}

    @property
    def eligible(self) -> bool:
        """Whether this worker can stage at all (its KV on a card)."""
        return self.uuid is not None

    def eligible_for(self, peer_uuid: Optional[str]) -> bool:
        """The pre-check advertised in the prefill response: the decode
        peer runs on this card, or on one with peer access to it (the
        peer's own check, `peer_reachable`, runs again before it pulls)."""
        if not self.eligible or peer_uuid is None:
            return False
        if peer_uuid == self.uuid:
            return True
        return (self.engine.device.type == "cuda"
                and peer_reachable(peer_uuid, self.engine.device))

    def counts(self) -> tuple:
        """(live, leaked) under ONE lock and sweep; the sweep on read keeps
        expiry observable in /worker/stats and /metrics even when no new
        stage traffic arrives."""
        with self._lock:
            self._sweep_locked(time.monotonic())
            return len(self._staged), len(self._leaked)

    @property
    def staged_count(self) -> int:
        return self.counts()[0]

    @property
    def leaked_count(self) -> int:
        return self.counts()[1]

    def _sweep_locked(self, now: float) -> None:
        dead = [rid for rid, (ts, _, _) in self._staged.items()
                if now - ts > self.staged_ttl_s]
        for rid in dead:
            self._leaked[rid] = self._staged.pop(rid)
        if dead:
            log.warning(
                "%d staged KV gather(s) expired un-pulled (%s): their "
                "device copies stay exported and keep holding stage slots "
                "until /disagg/release", len(dead), ", ".join(dead[:5]))

    def mark_released(self, request_id: str) -> None:
        """The decode side released the request (after its pull): forget
        the stage and drop the gathered tensors."""
        with self._lock:
            self._staged.pop(request_id, None)
            self._leaked.pop(request_id, None)

    def stage(self, request_id: str) -> Optional[dict]:
        """The pull coordinates of a parked request's KV, staging it on
        first call (KeyError for an unknown request); None when this
        worker cannot stage (the peer then uses the TCP plane)."""
        if not self.eligible:
            return None
        now = time.monotonic()
        with self._lock:
            self._sweep_locked(now)
            hit = self._staged.get(request_id)
            if hit is not None:
                return dict(hit[1])
            leaked = self._leaked.pop(request_id, None)
            if leaked is not None:
                # the peer came back after the TTL: its gather is still
                # exported: resurrect rather than double-pin
                self._staged[request_id] = (now, leaked[1], leaked[2])
                return dict(leaked[1])
            if len(self._staged) + len(self._leaked) >= self.max_staged:
                log.warning(
                    "staged-KV cap reached (%d live + %d leaked); refusing "
                    "stage for %s: the peer will use the TCP plane",
                    len(self._staged), len(self._leaked), request_id)
                return None
            k, v, n_tokens = self.engine.export_kv_device(request_id)
            try:
                kd, vd = self._export(k), self._export(v)
            except Exception as e:
                if not self._warned:
                    self._warned = True
                    log.warning(
                        "device-buffer KV staging unavailable (%s); this "
                        "prefill worker will serve KV over the TCP plane", e)
                return None
            desc = {"transfer_uuid": secrets.token_hex(8),
                    "device_uuid": self.uuid, "n_tokens": n_tokens,
                    "kv_shape": list(k.shape), "kv_dtype": _dtype_name(k),
                    "k": kd, "v": vd}
            self._staged[request_id] = (now, desc, (k, v))
            return dict(desc)


class DeviceKVClient:
    """Decode side: opens a stage's IPC handles on this worker's card."""

    def __init__(self, device):
        self.device = torch.device(device)

    def reachable(self, uuid: Optional[str]) -> bool:
        return peer_reachable(uuid, self.device)

    def pull(self, staged: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """(k, v) device tensors [L, n_pages, page_size, lanes], mapped
        from the prefill worker's memory: read them (the import's scatter)
        and synchronize before the release lets the producer free them."""
        if not self.reachable(staged.get("device_uuid")):
            raise RuntimeError(
                f"staged KV lives on {staged.get('device_uuid')}, which "
                f"{self.device} cannot open (not the same card, no peer "
                f"access)")
        k = cuda_ipc_import(staged["k"], self.device)
        v = cuda_ipc_import(staged["v"], self.device)
        want = (list(staged["kv_shape"]), staged["kv_dtype"])
        if (list(k.shape), _dtype_name(k)) != want:
            raise RuntimeError(f"staged KV opened as {list(k.shape)} "
                               f"{_dtype_name(k)}, expected {want}")
        return k, v


class ICIHandoff:
    """Both roles in one process on one card: a device-to-device copy.

    export_kv_device gathers the parked pages into a fresh device tensor
    and import_kv scatters them into the decode engine's pools in place, on
    the one stream both engines issue their work on, with no host bounce.
    The serving path reaches this through transfer.ici_registry when
    `--disaggregation-transfer-backend ici` finds the routed prefill
    engine in this process."""

    def __init__(self, prefill_engine, decode_engine):
        self.src = prefill_engine
        self.dst = decode_engine

    def transfer(self, req, first_token: int) -> None:
        k, v, _ = self.src.export_kv_device(req.request_id)
        self.dst.import_kv(req, first_token, k, v)
        self.src.release_parked(req.request_id)
