"""ctypes bindings + on-demand builds of the native libraries.

The port's own copy of `dynamo_tpu/runtime/native.py`: the transport
library (`get_lib`: framed sockets with a rendezvous handshake, the
disaggregated KV handoff's TCP plane and the KVBM's peer pull,
`transfer/transport.py`) and the router core (`get_router_lib` with
`dr_pick` and `dr_hash64`). Each shared object is compiled with g++ from
`runtime/csrc/` at first use, into `build/dynamo_tpu_torch/native/`
beside the package, named by a hash of its source (pybind11 is not
needed: a plain C ABI). A build or load failure degrades to `lib = None`;
the transport then runs its pure-Python sockets (the same wire format)
and the router its pure-Python pick (bit-identical scores). Whether each
loaded is not left silent: `transport_status()` and `router_status()` say
so and why; the worker's `/worker/stats` and the frontend's stats carry
them.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

log = logging.getLogger("dynamo_tpu_torch.native")

_CSRC = Path(__file__).resolve().parent / "csrc"
_SRC = _CSRC / "dynamo_transport.cpp"
_ROUTER_SRC = _CSRC / "dynamo_router.cpp"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "dynamo_tpu_torch" / "native")
_lock = threading.Lock()
_lib = None
_tried = False
_error = ""
_router_lib = None
_router_tried = False
_router_error = ""


def _build(src: Path, stem: str) -> Path:
    """Compile `src` (if needed) into BUILD_DIR; return the .so path."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = BUILD_DIR / f"lib{stem}_{digest}.so"
    if so_path.exists():
        return so_path
    # per-process tmp name: concurrent first-start compiles (colocated
    # workers) must not interleave writes into one .tmp; whoever's
    # os.replace lands last wins, both outputs are identical
    tmp = Path(f"{so_path}.{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-Wall",
           str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
    finally:
        if tmp.exists():
            tmp.unlink()
    return so_path


def build_library() -> str:
    """Compile (if needed) and return the transport .so path."""
    return str(_build(_SRC, "dynamo_transport"))


def get_lib():
    """The loaded native transport library, or None if unavailable."""
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = build_library()
            lib = ctypes.CDLL(path)
            lib.dt_listen.argtypes = [ctypes.c_uint16,
                                      ctypes.POINTER(ctypes.c_uint16)]
            lib.dt_listen.restype = ctypes.c_int
            lib.dt_accept.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                      ctypes.c_int]
            lib.dt_accept.restype = ctypes.c_int
            lib.dt_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint16,
                                       ctypes.c_char_p]
            lib.dt_connect.restype = ctypes.c_int
            lib.dt_send_msg.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_int64]
            lib.dt_send_msg.restype = ctypes.c_int
            lib.dt_recv_len.argtypes = [ctypes.c_int]
            lib.dt_recv_len.restype = ctypes.c_int64
            lib.dt_recv_into.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_int64]
            lib.dt_recv_into.restype = ctypes.c_int
            lib.dt_close.argtypes = [ctypes.c_int]
            lib.dt_key_len.restype = ctypes.c_int
            _lib = lib
            log.info("native transport loaded: %s", path)
        except Exception as e:
            _error = f"{type(e).__name__}: {e}"
            log.warning("native transport unavailable (%s); python fallback",
                        e)
            _lib = None
        return _lib


def transport_status() -> dict:
    """Whether the native transport loaded (building it on first call),
    and the reason when it did not."""
    lib = get_lib()
    out = {"native_transport": lib is not None}
    if lib is None:
        out["native_transport_error"] = _error
    return out


def get_router_lib():
    """The native router-core library, or None if unavailable."""
    global _router_lib, _router_tried, _router_error
    with _lock:
        if _router_tried:
            return _router_lib
        _router_tried = True
        try:
            path = _build(_ROUTER_SRC, "dynamo_router")
            lib = ctypes.CDLL(str(path))
            lib.dr_pick.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int,
            ]
            lib.dr_pick.restype = ctypes.c_int
            lib.dr_hash64.argtypes = [ctypes.c_char_p]
            lib.dr_hash64.restype = ctypes.c_uint64
            _router_lib = lib
            log.info("native router core loaded: %s", path)
        except Exception as e:
            _router_error = f"{type(e).__name__}: {e}"
            log.warning("native router unavailable (%s); python fallback", e)
            _router_lib = None
        return _router_lib


def router_status() -> dict:
    """Whether the native router core loaded (building it on first call),
    and the reason when it did not."""
    lib = get_router_lib()
    out = {"native_router": lib is not None}
    if lib is None:
        out["native_router_error"] = _router_error
    return out
