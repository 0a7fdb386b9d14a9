"""ctypes binding + on-demand build of the native router core.

The port's own copy of the router half of `dynamo_tpu/runtime/native.py`:
`get_router_lib` with `dr_pick` and `dr_hash64` (the transport library
comes with disaggregation). The shared object is compiled with g++ from
`runtime/csrc/dynamo_router.cpp` at first use, into
`build/dynamo_tpu_torch/native/` beside the package, named by a hash of
the source (pybind11 is not needed: a plain C ABI). A build or load
failure degrades to `lib = None`; the router then runs its pure-Python
pick, whose scores are bit-identical. Whether the core loaded is not left
silent: `router_status()` says so and why, and the frontend puts it in its
stats and its log.
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

_ROUTER_SRC = Path(__file__).resolve().parent / "csrc" / "dynamo_router.cpp"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "dynamo_tpu_torch" / "native")
_lock = threading.Lock()
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
