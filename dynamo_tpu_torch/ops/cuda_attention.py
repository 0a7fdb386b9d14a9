"""Hand-written CUDA attention kernels for Hopper and their wrappers.

The three kernels of the serving path live in `dynamo_tpu_torch/csrc/`:
`decode.cu` (paged decode), `prefill.cu` (causal prefill over padded
prompts) and `chunk.cu` (chunked prefill over the paged cache). They replace
`_decode_kernel`, `_prefill_kernel` and `_chunk_kernel` of
`dynamo_tpu/ops/pallas_attention.py`; each source's header says what bounds
it on the H100 and how its design answers that.

Build: the first call compiles every `csrc/*.cu` with
`nvcc -gencode arch=compute_90a,code=sm_90a` (one nvcc per source, started
together) and links them into one shared library with a plain C interface
under `build/dynamo_tpu_torch/`, named by a hash of the sources, so an edited
source rebuilds. It is loaded with ctypes: pointers and PyTorch's current
stream go over as `c_void_p`, each C entry point returns `cudaGetLastError()`
and the wrapper raises when that is not 0.

Wrappers check device, dtype, shape and contiguity, allocate their output
with `torch.empty`, and count their launches in `LAUNCHES` (nothing else
touches the counts). They take CUDA tensors only; the plain PyTorch versions
of the same functions are in `dynamo_tpu_torch.ops.attention`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dynamo_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

# launches of each kernel since the last reset (see reset_launch_counts)
LAUNCHES: Dict[str, int] = {"decode": 0, "prefill": 0, "chunk": 0}

MAX_QUERY_TILE = 16

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc/ptxas output of the build this process made


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources_digest() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(so: Path) -> str:
    """nvcc every source to an object in parallel, then link `so`."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = so.stem.rsplit("_", 1)[-1]
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}_{digest}.o"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", str(CSRC), "-c", str(src), "-o",
               str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in jobs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {so.name} failed:\n{link.stdout}")
    os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    return "\n".join(log)


def build() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so = BUILD_DIR / f"libdtt_attention_{_sources_digest()}.so"
        if not so.exists():
            build_log = _compile(so)
        lib = ctypes.CDLL(str(so))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dtt_paged_decode.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                         f, p]
        lib.dtt_prefill.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, p]
        lib.dtt_chunk.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, p]
        for fn in (lib.dtt_paged_decode, lib.dtt_prefill, lib.dtt_chunk):
            fn.restype = ctypes.c_int
        lib.dtt_error_string.argtypes = [ctypes.c_int]
        lib.dtt_error_string.restype = ctypes.c_char_p
        lib.dtt_max_rows_times_dim.argtypes = []
        lib.dtt_max_rows_times_dim.restype = ctypes.c_int
        _lib = lib
        return lib


def _raise_on(lib: ctypes.CDLL, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.dtt_error_string(rc).decode()}"
            f" (cudaError {rc})")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _expect(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: torch.device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_heads(lib: ctypes.CDLL, n_heads: int, n_kv: int,
                 head_dim: int) -> int:
    if n_kv < 1 or n_heads % n_kv:
        raise ValueError(f"query heads ({n_heads}) must be a multiple of the "
                         f"KV heads ({n_kv})")
    if head_dim % 8:
        raise ValueError(f"head_dim must be a multiple of 8, got {head_dim}")
    group = n_heads // n_kv
    limit = lib.dtt_max_rows_times_dim()
    if group * head_dim > limit:
        raise ValueError(f"GQA group x head_dim ({group} x {head_dim}) "
                         f"exceeds the kernels' {limit} accumulators")
    return group


def query_tile(lib: ctypes.CDLL, group: int, head_dim: int) -> int:
    """Query positions per block for prefill and chunk: the largest power
    of two <= MAX_QUERY_TILE whose rows fit the block's accumulators (the
    library's limit; its entry points refuse a launch past it)."""
    limit = lib.dtt_max_rows_times_dim()
    qt = MAX_QUERY_TILE
    while qt > 1 and qt * group * head_dim > limit:
        qt //= 2
    return qt


def paged_attention_decode(q, k_pages, v_pages, block_table, context_lens, *,
                           page_size: int) -> torch.Tensor:
    """q [B, H, D] bf16; pools [P, ps, KV*D] bf16; block_table [B, Pmax]
    int32; context_lens [B] int32 (incl. the current token) -> [B, H, D]."""
    dev = q.device
    _expect(q, "q", torch.bfloat16, 3, dev)
    _expect(k_pages, "k_pages", torch.bfloat16, 3, dev)
    _expect(v_pages, "v_pages", torch.bfloat16, 3, dev)
    _expect(block_table, "block_table", torch.int32, 2, dev)
    _expect(context_lens, "context_lens", torch.int32, 1, dev)
    b, h, d = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[1] != page_size:
        raise ValueError(f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match page_size "
                         f"{page_size}")
    if k_pages.shape[2] % d:
        raise ValueError(f"pool lane width {k_pages.shape[2]} is not a "
                         f"multiple of head_dim {d}")
    n_kv = k_pages.shape[2] // d
    lib = build()
    _check_heads(lib, h, n_kv, d)
    if block_table.shape[0] != b or context_lens.shape[0] != b:
        raise ValueError("block_table / context_lens batch does not match q")
    out = torch.empty_like(q)
    if b == 0:
        return out
    rc = lib.dtt_paged_decode(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(block_table),
        _ptr(context_lens), _ptr(out), b, h, n_kv, d, page_size,
        block_table.shape[1], d ** -0.5, _stream(q))
    _raise_on(lib, rc, "decode")
    LAUNCHES["decode"] += 1
    return out


def prefill_attention(q, k, v, seq_lens) -> torch.Tensor:
    """q [N, S, H, D], k/v [N, S, KV, D] bf16; seq_lens [N] int32 (true
    lengths) -> [N, S, H, D]. Causal within each lane."""
    dev = q.device
    _expect(q, "q", torch.bfloat16, 4, dev)
    _expect(k, "k", torch.bfloat16, 4, dev)
    _expect(v, "v", torch.bfloat16, 4, dev)
    _expect(seq_lens, "seq_lens", torch.int32, 1, dev)
    n, s, h, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (n, s) or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if seq_lens.shape[0] != n:
        raise ValueError("seq_lens does not match the lane count")
    n_kv = k.shape[2]
    lib = build()
    group = _check_heads(lib, h, n_kv, d)
    out = torch.empty_like(q)
    if n == 0 or s == 0:
        return out
    qt = query_tile(lib, group, d)
    rc = lib.dtt_prefill(
        _ptr(q), _ptr(k), _ptr(v), _ptr(seq_lens), _ptr(out), n, s, h, n_kv,
        d, qt, d ** -0.5, _stream(q))
    _raise_on(lib, rc, "prefill")
    LAUNCHES["prefill"] += 1
    return out


def chunk_prefill_attention(q, k_pages, v_pages, pages, start: int, *,
                            page_size: int) -> torch.Tensor:
    """q [C, H, D] bf16 at absolute positions start..start+C-1; pools
    [P, ps, KV*D] bf16; pages [W] int32 (trash-padded tail) -> [C, H, D]."""
    dev = q.device
    _expect(q, "q", torch.bfloat16, 3, dev)
    _expect(k_pages, "k_pages", torch.bfloat16, 3, dev)
    _expect(v_pages, "v_pages", torch.bfloat16, 3, dev)
    _expect(pages, "pages", torch.int32, 1, dev)
    c, h, d = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[1] != page_size:
        raise ValueError(f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match page_size "
                         f"{page_size}")
    if k_pages.shape[2] % d:
        raise ValueError(f"pool lane width {k_pages.shape[2]} is not a "
                         f"multiple of head_dim {d}")
    n_kv = k_pages.shape[2] // d
    lib = build()
    group = _check_heads(lib, h, n_kv, d)
    start = int(start)
    if start < 0 or start + c > pages.shape[0] * page_size:
        raise ValueError(f"chunk [{start}, {start + c}) runs past the "
                         f"{pages.shape[0]}-page list")
    out = torch.empty_like(q)
    if c == 0:
        return out
    qt = query_tile(lib, group, d)
    rc = lib.dtt_chunk(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(pages), _ptr(out), c, h,
        n_kv, d, page_size, start, qt, d ** -0.5, _stream(q))
    _raise_on(lib, rc, "chunk")
    LAUNCHES["chunk"] += 1
    return out
