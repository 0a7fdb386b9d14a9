"""Process-local engine registry for the in-process disagg data plane.

The port's copy of `dynamo_tpu/transfer/ici_registry.py`.
`--disaggregation-transfer-backend ici` (the reference's nixl slot,
examples/deploy/sglang/disagg.yaml:47-48) means the KV handoff stays on the
device: when the prefill engine a decode request was routed to lives in THIS
process (both roles in one process on one card), the decode client skips
the HTTP RPC and the TCP byte pump entirely and moves pages engine to
engine as device tensors (`ICIHandoff`: a gather and an in-place scatter on
the card, no host bounce). A process cannot open its own CUDA IPC handle,
so this registry is also how the in-process case avoids the IPC plane.

Workers register their engine under every URL they advertise; the decode
client consults the registry before the cross-process planes.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

_lock = threading.Lock()
_engines: Dict[str, object] = {}


def register(url: str, engine) -> None:
    with _lock:
        _engines[url.rstrip("/")] = engine


def unregister(url: str) -> None:
    with _lock:
        _engines.pop(url.rstrip("/"), None)


def lookup(url: str) -> Optional[object]:
    with _lock:
        return _engines.get(url.rstrip("/"))


def clear() -> None:
    with _lock:
        _engines.clear()
