"""Hand-written CUDA attention kernels for Hopper and their wrappers.

The four kernels of the serving path live in `dynamo_tpu_torch/csrc/`:
`decode.cu` (paged decode), `prefill.cu` (causal prefill over padded
prompts), `chunk.cu` (chunked prefill over the paged cache) and `ragged.cu`
(the mixed step: decode rows and one chunk in one launch; the speculative
verify steps: rows of K+1 queries, beside a chunk or alone). They replace
`_decode_kernel`, `_prefill_kernel` and `_chunk_kernel` of
`dynamo_tpu/ops/pallas_attention.py` and `_ragged_kernel` of
`dynamo_tpu/ops/ragged_attention.py`; each source's header says what bounds
it on the H100 and how its design answers that. All four run the
tensor-core tile (`attend_mma` in `attention_common.cuh`: 64-row query
tiles on mma.sync, K/V tiles through a cp.async ring); decode and the
ragged kernel's decode rows are split along their keys, one block per
(row, span, KV head), and the spans merged by a second small kernel. The
launch plans of the tile (`tile_positions`, `split_plan`) are pure
functions of host-known sizes. At head_dim 640 (MLA's latent row, one KV
head shared by 16 query heads) every kernel but prefill runs the latent
tile's walk (`latent_walk`: 32-key tiles, S and P V on wgmma): chunk.cu
and ragged's chunk rows as `chunk_latent_kernel`, each query tile's keys
cut into `chunk_spans` spans, one block each, the spans of a query tile
one thread-block cluster that merges them in shared memory; decode.cu and
ragged's decode and verify rows as `decode_latent_kernel`, each row's
horizon cut into `latent_decode_spans` spans (a verify window's query
tiles walking the same span side by side), merged by
`merge_latent_kernel`; prefill.cu runs `attend_latent` (16 warps that
split O's lanes in four, 16-key tiles). The three pool-reading
kernels (decode, chunk, ragged) each have a bf16 and an int8 entry point,
the latter for the packed rows of `kv_cache_dtype="int8"` pools; their
wrappers take either pool and count the int8 launches under their own
`*_int8` names.

Build: the first call compiles every `csrc/*.cu` with
`nvcc -gencode arch=compute_90a,code=sm_90a` (one nvcc per source, started
together) and links them into one shared library with a plain C interface
under `build/dynamo_tpu_torch/`, named by a hash of the sources, so an edited
source rebuilds; nvcc's output (ptxas's registers and spills per kernel)
is kept beside it as `.log` and read into `build_log` with the library.
It is loaded with ctypes: pointers and PyTorch's current
stream go over as `c_void_p`, each C entry point returns `cudaGetLastError()`
and the wrapper raises when that is not 0.

Wrappers check device, dtype, shape and contiguity, allocate their output
with `torch.empty`, and count their launches in `LAUNCHES`. They take CUDA
tensors only; the plain PyTorch versions of the same functions are in
`dynamo_tpu_torch.ops.attention`. Each launch also counts under its
variant in `VARIANT_LAUNCHES` (`decode[head_dim=64]`,
`ragged[decode_q=5,chunk]`, `ragged[decode_q=5,no_chunk]`, ...; a ragged
launch counts under its row shape and under its head_dim), so a run can
show which shapes of a kernel its main path reached: the ragged kernel's
verify windows (decode_q = K + 1, with a chunk or, C = 0, without one), a
draft model's head_dim, Gemma's head_dim 256. Under a CUDA graph capture a
wrapper call records its kernel instead of launching it: `counting_capture`
takes such calls back out of both counts and keeps them with the graph,
and `count_replay` adds them at every replay, so the counts stay launches.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dynamo_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

# launches of each kernel since the last reset (see reset_launch_counts)
LAUNCHES: Dict[str, int] = {
    "decode": 0, "prefill": 0, "chunk": 0, "ragged": 0,
    "decode_int8": 0, "chunk_int8": 0, "ragged_int8": 0,
    "json_mask": 0, "json_advance": 0}
# the same launches by kernel and variant, e.g. "ragged[decode_q=5,chunk]"
VARIANT_LAUNCHES: Dict[str, int] = collections.Counter()

# The tensor-core tile of every kernel (attention_common.cuh: kTileRows,
# tile_head_dim, kKeyTile, kSplitKeys, kSplitBlocksPerSm). The library
# reports its own values (dtt_chunk_positions, dtt_decode_split_keys) and
# its entry points refuse a launch that disagrees with them.
TILE_ROWS = 64
# the head_dims the tile is compiled for; LATENT_DIM, MLA's latent row
# (DeepSeek-V2's 576 lanes padded to 640), runs attention_common.cuh's
# attend_latent, the other four attend_mma
LATENT_DIM = 640
TILE_HEAD_DIMS = (32, 64, 128, 256, LATENT_DIM)
KEY_TILE = 64
SPLIT_KEYS = 256
SPLIT_BLOCKS_PER_SM = 4
# the latent chunk tile (attention_common.cuh: kChunkKeys, kMaxChunkSpans):
# keys per K/V tile, and most spans (blocks of one cluster) a query tile
# is cut into
CHUNK_KEYS = 32
MAX_CHUNK_SPANS = 8
# the latent decode rows (attention_common.cuh: kLatentSpanKeys): at most
# one span per LATENT_SPAN_KEYS keys of the table's width
LATENT_SPAN_KEYS = 64

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc/ptxas output of the build of the loaded library


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    VARIANT_LAUNCHES.clear()


def _count(name: str, *variants: str) -> None:
    """One launch of kernel `name`, counted under each of its `variants`."""
    LAUNCHES[name] += 1
    for variant in variants:
        VARIANT_LAUNCHES[f"{name}[{variant}]"] += 1


@contextlib.contextmanager
def counting_capture() -> Iterator[Dict[str, int]]:
    """Around a CUDA graph capture: yields a dict that holds, on exit, the
    wrapper calls made inside by kernel name and by variant (the launches
    each replay of the graph makes), and leaves LAUNCHES and
    VARIANT_LAUNCHES as they were before."""
    before = dict(LAUNCHES)
    before_variants = dict(VARIANT_LAUNCHES)
    recorded: Dict[str, int] = {}
    try:
        yield recorded
    finally:
        for counts, prior in ((LAUNCHES, before),
                              (VARIANT_LAUNCHES, before_variants)):
            for name in list(counts):
                n = prior.get(name, 0)
                if counts[name] != n:
                    recorded[name] = counts[name] - n
                counts[name] = n


def count_replay(recorded: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture recorded `recorded`."""
    for name, n in recorded.items():
        (LAUNCHES if name in LAUNCHES else VARIANT_LAUNCHES)[name] += n


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
    text = "\n".join(log)
    so.with_suffix(".log").write_text(text)
    os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    return text


def build() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so = BUILD_DIR / f"libdtt_attention_{_sources_digest()}.so"
        if not so.exists():
            build_log = _compile(so)
        else:  # built before: its log was kept beside it
            log = so.with_suffix(".log")
            build_log = log.read_text() if log.exists() else ""
        lib = ctypes.CDLL(str(so))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dtt_paged_decode.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                         i, i, i, i, f, p]
        lib.dtt_prefill.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, p]
        lib.dtt_chunk.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, f,
                                  p, p]
        lib.dtt_ragged.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                   i, i, i, i, i, i, f, p]
        lib.dtt_paged_decode_int8.argtypes = [p, p, p, p, p, p, p, p, i, i,
                                              i, i, i, i, i, i, i, f, p]
        lib.dtt_chunk_int8.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                       i, i, f, p, p]
        lib.dtt_ragged_int8.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i,
                                        i, i, i, i, i, i, i, i, i, f, p]
        # the grammar kernel (csrc/json_mask.cu; ops/cuda_guide.py)
        lib.dtt_json_mask.argtypes = [p, i, p, p, p, p, p, p, p, i, i, p]
        lib.dtt_json_advance.argtypes = [p, p, p, p, p, p, p, i, i, p]
        for fn in (lib.dtt_paged_decode, lib.dtt_prefill, lib.dtt_chunk,
                   lib.dtt_ragged, lib.dtt_paged_decode_int8,
                   lib.dtt_chunk_int8, lib.dtt_ragged_int8,
                   lib.dtt_json_mask, lib.dtt_json_advance):
            fn.restype = ctypes.c_int
        lib.dtt_error_string.argtypes = [ctypes.c_int]
        lib.dtt_error_string.restype = ctypes.c_char_p
        lib.dtt_chunk_positions.argtypes = [i, i]
        lib.dtt_chunk_positions.restype = ctypes.c_int
        lib.dtt_chunk_spans.argtypes = [i, i, i, i, i, i]
        lib.dtt_chunk_spans.restype = ctypes.c_int
        lib.dtt_chunk_max_clusters.argtypes = [i, i]
        lib.dtt_chunk_max_clusters.restype = ctypes.c_int
        lib.dtt_decode_split_keys.argtypes = [i, i, i, i, i]
        lib.dtt_decode_split_keys.restype = ctypes.c_longlong
        lib.dtt_latent_decode_spans.argtypes = [i, i, i, i, i, i, i]
        lib.dtt_latent_decode_spans.restype = ctypes.c_int
        lib.dtt_latent_merge.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.dtt_latent_merge.restype = ctypes.c_int
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
    if t.dtype in (torch.bfloat16, torch.int8) and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _gqa_group(n_heads: int, n_kv: int) -> int:
    if n_kv < 1 or n_heads % n_kv:
        raise ValueError(f"query heads ({n_heads}) must be a multiple of the "
                         f"KV heads ({n_kv})")
    return n_heads // n_kv


def _check_pools(k_pages, v_pages, page_size: int, head_dim: int,
                 num_kv_heads: Optional[int], device: torch.device):
    """(KV heads, lane width, int8?) of a K/V pool pair [P, ps, W]: bf16
    rows of KV*D lanes, or int8 packed rows of at least KV*D + 2*KV lanes
    (num_kv_heads required) with D a multiple of 16."""
    # ops.attention imports this module: its pool rule is looked up here
    from dynamo_tpu_torch.ops.attention import pool_kv_heads

    int8 = k_pages.dtype == torch.int8
    dtype = torch.int8 if int8 else torch.bfloat16
    _expect(k_pages, "k_pages", dtype, 3, device)
    _expect(v_pages, "v_pages", dtype, 3, device)
    if k_pages.shape != v_pages.shape or k_pages.shape[1] != page_size:
        raise ValueError(f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match page_size "
                         f"{page_size}")
    width = k_pages.shape[2]
    n_kv = pool_kv_heads(k_pages, head_dim, num_kv_heads)
    if not int8:
        if width % head_dim:
            raise ValueError(f"pool lane width {width} is not a multiple of "
                             f"head_dim {head_dim}")
        if num_kv_heads is not None and num_kv_heads != n_kv:
            raise ValueError(f"num_kv_heads {num_kv_heads} does not match "
                             f"the pool's {n_kv}")
        return n_kv, width, False
    if head_dim % 16:
        raise ValueError(f"int8 KV pools need head_dim a multiple of 16, got "
                         f"{head_dim}")
    if width < n_kv * (head_dim + 2) or width % 16:
        raise ValueError(f"int8 pool lane width {width} cannot hold "
                         f"{n_kv} heads of {head_dim} values and "
                         f"their scales in 16-byte aligned rows")
    return n_kv, width, True


def tile_positions(group: int, head_dim: int) -> int:
    """Query positions per block of the tensor-core tile (prefill, chunk
    and ragged's chunk tiles): its 64 rows hold positions x the GQA group.
    Raises ValueError for what the tile cannot take: a head_dim it is not
    compiled for (TILE_HEAD_DIMS), a group above 64."""
    if head_dim not in TILE_HEAD_DIMS:
        raise ValueError(f"the attention kernels are built for head_dim in "
                         f"{TILE_HEAD_DIMS}, got {head_dim}")
    if not 1 <= group <= TILE_ROWS:
        raise ValueError(f"GQA group {group} does not fit the attention "
                         f"kernels' {TILE_ROWS}-row query tile")
    return TILE_ROWS // group


def check_decode_rows(decode_q: int, group: int, head_dim: int) -> int:
    """tile_positions, also refusing decode rows (decode.cu's with
    decode_q = 1, ragged's) of decode_q queries x the group past the
    tile's rows. At head_dim LATENT_DIM any decode_q is taken: a row's
    queries are cut into query tiles of `positions` positions (a verify
    window of 5 x 16 rows into 4 and 1), one block each per key span, and
    the query tiles of a span walk its keys side by side
    (latent_decode_blocks)."""
    positions = tile_positions(group, head_dim)
    if head_dim != LATENT_DIM and decode_q * group > TILE_ROWS:
        raise ValueError(f"decode_q x GQA group ({decode_q} x {group}) does "
                         f"not fit the ragged kernel's {TILE_ROWS}-row query "
                         f"tile")
    return positions


def split_keys(width: int, page_size: int, num_decode: int, num_kv: int,
               num_sms: int) -> int:
    """Keys per split of a decode row (decode.cu, ragged.cu) whose page
    list has `width` pages, from host-known sizes only (the context
    lengths live on the card and are never read back): SPLIT_KEYS, or
    more where that would give num_decode rows x num_kv heads more than
    SPLIT_BLOCKS_PER_SM decode blocks per SM in all, rounded up to whole
    KEY_TILEs. So the blocks and the partials' scratch grow with the rows
    and the card, not with the table's width * page_size keys."""
    keys = width * page_size
    cap = max(1, SPLIT_BLOCKS_PER_SM * num_sms // max(1, num_decode * num_kv))
    n = min(max(1, -(-keys // SPLIT_KEYS)), cap)
    span = -(-keys // n)
    return max(SPLIT_KEYS, -(-span // KEY_TILE) * KEY_TILE)


def split_plan(width: int, page_size: int, num_decode: int, num_kv: int,
               num_sms: int) -> Tuple[int, int]:
    """(keys per split, splits) of num_decode decode rows over page lists
    of `width` pages: the plan the library's entry points take."""
    span = split_keys(width, page_size, num_decode, num_kv, num_sms)
    return span, -(-(width * page_size) // span)


def split_spans(width: int, page_size: int, num_decode: int, num_kv: int,
                num_sms: int) -> List[Tuple[int, int]]:
    """Key spans [lo, hi) of a decode row's splits: spans of split_keys
    keys over the table's width * page_size keys, the last cut at the
    table's end. A split walks its span below its row's horizon (none at
    all when the span starts past it)."""
    keys = width * page_size
    span = split_keys(width, page_size, num_decode, num_kv, num_sms)
    return [(lo, min(lo + span, keys)) for lo in range(0, keys, span)]


def latent_decode_spans(width: int, page_size: int, num_decode: int,
                        decode_q: int, group: int, num_kv: int,
                        num_sms: int) -> int:
    """Key spans a row of the latent decode rows (decode.cu and ragged.cu's
    decode and verify rows at LATENT_DIM) on average, from host-known
    sizes only (the library's own plan too, `dtt_latent_decode_spans`):
    as many as one wave of blocks holds (spans x query tiles x rows x KV
    heads <= num_sms; at least one), and at most one per LATENT_SPAN_KEYS
    keys of the table's width * page_size. The launch holds this many
    times num_decode spans per query tile and KV head; the context
    lengths live on the card and are never read back: the card shares
    the spans out over the rows (latent_decode_blocks)."""
    positions = tile_positions(group, LATENT_DIM)
    tiles = max(1, num_decode * -(-decode_q // positions) * num_kv)
    most = max(1, -(-(width * page_size) // LATENT_SPAN_KEYS))
    return max(1, min(num_sms // tiles, most))


def latent_span_keys(total: int, rows: int, budget: int) -> Optional[int]:
    """Keys a span of the latent decode rows may hold when `budget` spans
    are shared out over `rows` rows of `total` keys (attention_common.cuh
    latent_span_keys): the least multiple of CHUNK_KEYS with ceil(h / L)
    spans for a row of h keys (one for a row with none) within the budget;
    None (a span a row) where the budget is one a row."""
    if budget <= rows:
        return None
    per = -(-total // (budget - rows))
    return max(CHUNK_KEYS, -(-per // CHUNK_KEYS) * CHUNK_KEYS)


def latent_decode_blocks(width: int, page_size: int, kv_lens, q_starts,
                         decode_q: int, group: int, num_kv: int,
                         num_sms: int) -> List[Tuple[int, int, int, int,
                                                     int, int, int]]:
    """(row, span, the row's spans, first query, query count, lo, hi) of
    each block of the latent decode rows for one KV head that has a span
    to walk, as decode_latent_kernel computes them on the card from the
    descriptors (q_starts None: decode.cu, a query at kv_len - 1): row r's
    horizon min(q_start + decode_q, kv_len, width * page_size); the
    latent_decode_spans x rows spans of the launch shared out by
    latent_span_keys, a row of h keys cut into ceil(h / L) equal spans
    (one, walking nothing, for a row with none), each walked by every
    query tile of `positions` queries. The launch's other blocks, past
    the last span, exit at once."""
    positions = tile_positions(group, LATENT_DIM)
    n = latent_decode_spans(width, page_size, len(kv_lens), decode_q, group,
                            num_kv, num_sms)
    horizons = [max(0, min((kv - 1 if q_starts is None else q_starts[r])
                           + decode_q, kv, width * page_size))
                for r, kv in enumerate(kv_lens)]
    span_keys = latent_span_keys(sum(horizons), len(kv_lens),
                                 n * len(kv_lens))
    out = []
    for r, h in enumerate(horizons):
        k = 1 if h == 0 or span_keys is None else -(-h // span_keys)
        span = -(-h // k)
        for s in range(k):
            for first in range(0, decode_q, positions):
                out.append((r, s, k, first, min(positions, decode_q - first),
                            s * span, min((s + 1) * span, h)))
    return out


def latent_scratch_rows(num_decode: int, decode_q: int, group: int,
                        num_kv: int, spans: int) -> int:
    """Partial rows (640 f32 lanes, then (m, l)) of the latent decode rows'
    scratch: a slot of a query tile's rows per block of the launch."""
    positions = tile_positions(group, LATENT_DIM)
    return (spans * num_decode * num_kv * -(-decode_q // positions)
            * min(decode_q, positions) * group)


def decode_plan(width: int, page_size: int, num_decode: int, decode_q: int,
                group: int, num_kv: int, head_dim: int,
                num_sms: int) -> Tuple[int, int]:
    """(split_keys, splits) the decode entry points take: split_plan below
    LATENT_DIM, (0, latent_decode_spans) at it."""
    if head_dim == LATENT_DIM:
        return 0, latent_decode_spans(width, page_size, num_decode,
                                      decode_q, group, num_kv, num_sms)
    return split_plan(width, page_size, num_decode, num_kv, num_sms)


def ragged_chunk_spans(c: int, width: int, page_size: int, group: int,
                       num_kv: int, num_sms: int) -> int:
    """Key spans a query tile of ragged.cu's chunk rows at LATENT_DIM: the
    chunk's start lives on the card, so chunk_spans is planned at the
    table's end, start = width * page_size - c (the same count as
    chunk.cu's wherever the key tiles do not bind, as at C = 256)."""
    return chunk_spans(c, max(0, width * page_size - c), group, LATENT_DIM,
                       num_kv, num_sms)


def chunk_spans(c: int, start: int, group: int, head_dim: int,
                num_kv: int, num_sms: int) -> int:
    """Key spans per query tile of chunk.cu for a c-query chunk at `start`
    (a pure function of host sizes, the library's own plan too,
    `dtt_chunk_spans`): 1 below LATENT_DIM; at LATENT_DIM the largest power of two up to
    MAX_CHUNK_SPANS (one cluster) whose blocks, spans x query tiles x KV
    heads, run in one wave on num_sms SMs, and at most the CHUNK_KEYS
    tiles of the longest horizon, start + c. (Clusters of 2, 4 and 8
    blocks fill an H100's GPCs; 3, 5 or 6 leave SMs idle.)"""
    positions = tile_positions(group, head_dim)
    if head_dim != LATENT_DIM:
        return 1
    tiles = -(-c // positions) * num_kv
    key_tiles = -(-(start + c) // CHUNK_KEYS)
    n = 1
    while (2 * n <= MAX_CHUNK_SPANS and 2 * n * tiles <= num_sms
           and 2 * n <= key_tiles):
        n *= 2
    return n


def chunk_span_keys(c: int, start: int, group: int, head_dim: int,
                    num_kv: int, num_sms: int
                    ) -> List[Tuple[int, int, List[Tuple[int, int]]]]:
    """(first query, query count, key spans [lo, hi)) of each query tile of
    chunk.cu: the tile's horizon start + first + count (the keys its last
    query sees) cut into chunk_spans equal spans of ceil(horizon / spans)
    keys; a span at or past the horizon is empty (lo >= hi)."""
    positions = tile_positions(group, head_dim)
    n = chunk_spans(c, start, group, head_dim, num_kv, num_sms)
    out = []
    for first in range(0, c, positions):
        count = min(positions, c - first)
        horizon = start + first + count
        span = -(-horizon // n)
        out.append((first, count, [(s * span, min((s + 1) * span, horizon))
                                   for s in range(n)]))
    return out


@functools.lru_cache(maxsize=None)
def _sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _num_sms(dev: torch.device) -> int:
    """The SM count of `dev` (split_plan, chunk_spans), looked up once per
    device."""
    return _sms_of(torch.cuda.current_device() if dev.index is None
                   else dev.index)


def _scratch_shape(n_splits: int, num_decode: int, decode_q: int,
                   group: int, n_kv: int, h: int, d: int
                   ) -> Tuple[int, int, int, int, int]:
    """_split_scratch's (n_splits, nd, h, d, extra) for a decode plan:
    [splits, decode queries, heads] rows below LATENT_DIM;
    latent_scratch_rows at it, then the rows' plan (an int32 pair a row)."""
    if d == LATENT_DIM:
        return (1, latent_scratch_rows(num_decode, decode_q, group, n_kv,
                                       n_splits), 1, d, 2 * num_decode)
    return n_splits, num_decode * decode_q, h, d, 0


def _split_scratch(n_splits: int, nd: int, h: int, d: int, extra: int,
                   dev: torch.device) -> Tuple[ctypes.c_void_p,
                                               ctypes.c_void_p, torch.Tensor]:
    """The split decode rows' partials, part_o [n_splits, nd, h, d] then
    part_ml [n_splits, nd, h, 2] f32 and `extra` 4-byte words, in one
    allocation: (part_o pointer, part_ml pointer, the tensor that owns
    them)."""
    n_o = n_splits * nd * h * d
    part = torch.empty((n_o + n_splits * nd * h * 2 + extra,),
                       dtype=torch.float32, device=dev)
    return (ctypes.c_void_p(part.data_ptr()),
            ctypes.c_void_p(part.data_ptr() + 4 * n_o), part)


def paged_attention_decode(q, k_pages, v_pages, block_table, context_lens, *,
                           page_size: int, num_kv_heads: Optional[int] = None
                           ) -> torch.Tensor:
    """q [B, H, D] bf16; pools [P, ps, W] bf16 (W = KV*D) or int8 packed
    (with num_kv_heads); block_table [B, Pmax] int32; context_lens [B]
    int32 (incl. the current token) -> [B, H, D]. Each row is split along
    its keys (decode_plan, from B, Pmax, the group and the SM count) and
    merged."""
    dev = q.device
    _expect(q, "q", torch.bfloat16, 3, dev)
    _expect(block_table, "block_table", torch.int32, 2, dev)
    _expect(context_lens, "context_lens", torch.int32, 1, dev)
    b, h, d = q.shape
    n_kv, width, int8 = _check_pools(k_pages, v_pages, page_size, d,
                                     num_kv_heads, dev)
    group = _gqa_group(h, n_kv)
    check_decode_rows(1, group, d)
    if block_table.shape[0] != b or context_lens.shape[0] != b:
        raise ValueError("block_table / context_lens batch does not match q")
    pmax = block_table.shape[1]
    if pmax < 1:
        raise ValueError("block_table has no page column")
    lib = build()
    out = torch.empty_like(q)
    if b == 0:
        return out
    span, n_splits = decode_plan(pmax, page_size, b, 1, group, n_kv, d,
                                 _num_sms(dev))
    part_o, part_ml, _part = _split_scratch(
        *_scratch_shape(n_splits, b, 1, group, n_kv, h, d), dev)
    args = [_ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(block_table),
            _ptr(context_lens), _ptr(out), part_o, part_ml, b, h, n_kv, d,
            page_size, pmax]
    tail = [n_splits, span, d ** -0.5, _stream(q)]
    name = "decode_int8" if int8 else "decode"
    if int8:
        rc = lib.dtt_paged_decode_int8(*args, width, *tail)
    else:
        rc = lib.dtt_paged_decode(*args, *tail)
    _raise_on(lib, rc, name)
    _count(name, f"head_dim={d}")
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
    positions = tile_positions(_gqa_group(h, n_kv), d)
    lib = build()
    out = torch.empty_like(q)
    if n == 0 or s == 0:
        return out
    rc = lib.dtt_prefill(
        _ptr(q), _ptr(k), _ptr(v), _ptr(seq_lens), _ptr(out), n, s, h, n_kv,
        d, positions, d ** -0.5, _stream(q))
    _raise_on(lib, rc, "prefill")
    _count("prefill", f"head_dim={d}")
    return out


def chunk_prefill_attention(q, k_pages, v_pages, pages, start: int, *,
                            page_size: int,
                            num_kv_heads: Optional[int] = None,
                            clocks: Optional[torch.Tensor] = None,
                            spans: Optional[int] = None) -> torch.Tensor:
    """q [C, H, D] bf16 at absolute positions start..start+C-1; pools
    [P, ps, W] bf16 or int8 packed (with num_kv_heads); pages [W] int32
    (trash-padded tail) -> [C, H, D]. At LATENT_DIM each query tile's keys
    are cut into chunk_spans spans (from C, start, the group and the SM
    count). Measurement, LATENT_DIM only: `spans` runs another span count
    (1 to MAX_CHUNK_SPANS; every count gives the same attention), and
    `clocks`, an int64 CUDA tensor of 2 x the launch's blocks, takes each
    block's global-timer stamps (ns) when its key walk ends and when its
    merge is done."""
    dev = q.device
    _expect(q, "q", torch.bfloat16, 3, dev)
    _expect(pages, "pages", torch.int32, 1, dev)
    c, h, d = q.shape
    n_kv, width, int8 = _check_pools(k_pages, v_pages, page_size, d,
                                     num_kv_heads, dev)
    group = _gqa_group(h, n_kv)
    positions = tile_positions(group, d)
    lib = build()
    start = int(start)
    if start < 0 or start + c > pages.shape[0] * page_size:
        raise ValueError(f"chunk [{start}, {start + c}) runs past the "
                         f"{pages.shape[0]}-page list")
    out = torch.empty_like(q)
    if c == 0:
        return out
    plan = chunk_spans(c, start, group, d, n_kv, _num_sms(dev))
    if spans is not None and (d != LATENT_DIM
                              or not 1 <= spans <= MAX_CHUNK_SPANS):
        raise ValueError(f"spans {spans} needs head_dim {LATENT_DIM} and "
                         f"1 to {MAX_CHUNK_SPANS} spans")
    spans = plan if spans is None else spans
    clock_ptr = ctypes.c_void_p(None)
    if clocks is not None:
        blocks = spans * -(-c // positions) * n_kv
        _expect(clocks, "clocks", torch.int64, 1, dev)
        if d != LATENT_DIM or clocks.numel() < 2 * blocks:
            raise ValueError(f"clocks needs head_dim {LATENT_DIM} and "
                             f"{2 * blocks} entries")
        clock_ptr = _ptr(clocks)
    args = [_ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(pages), _ptr(out), c,
            h, n_kv, d, page_size]
    tail = [start, positions, spans, d ** -0.5, clock_ptr, _stream(q)]
    name = "chunk_int8" if int8 else "chunk"
    if int8:
        rc = lib.dtt_chunk_int8(*args, width, *tail)
    else:
        rc = lib.dtt_chunk(*args, *tail)
    _raise_on(lib, rc, name)
    _count(name, f"head_dim={d}")
    return out


def ragged_paged_attention(q, k_pages, v_pages, tables, kv_lens, q_starts, *,
                           page_size: int, num_kv_heads: Optional[int] = None,
                           num_decode: int, decode_q: int = 1
                           ) -> torch.Tensor:
    """q [num_decode*decode_q + C, H, D] bf16 (C >= 0): num_decode rows of
    decode_q queries, then one chunk; pools [P, ps, W] bf16 or int8 packed
    (with num_kv_heads); tables [num_decode + 1, W] int32 (the last row is
    the chunk's pages, unread when C = 0); kv_lens, q_starts
    [num_decode + 1] int32 -> like q. Query j of row r sees key tok iff
    tok <= q_starts[r] + j and tok < kv_lens[r]."""
    dev = q.device
    _expect(q, "q", torch.bfloat16, 3, dev)
    _expect(tables, "tables", torch.int32, 2, dev)
    _expect(kv_lens, "kv_lens", torch.int32, 1, dev)
    _expect(q_starts, "q_starts", torch.int32, 1, dev)
    total, h, d = q.shape
    n_kv, width, int8 = _check_pools(k_pages, v_pages, page_size, d,
                                     num_kv_heads, dev)
    group = _gqa_group(h, n_kv)
    if num_decode < 0 or decode_q < 1:
        raise ValueError(f"num_decode {num_decode} / decode_q {decode_q}")
    c = total - num_decode * decode_q
    if c < 0:
        raise ValueError(f"{total} queries are fewer than {num_decode} rows "
                         f"of {decode_q}")
    rows = num_decode + 1
    if (tables.shape[0] != rows or kv_lens.shape[0] != rows
            or q_starts.shape[0] != rows):
        raise ValueError(f"descriptors {tuple(tables.shape)}, "
                         f"{tuple(kv_lens.shape)}, {tuple(q_starts.shape)} "
                         f"do not have num_decode + 1 = {rows} rows")
    positions = check_decode_rows(decode_q, group, d)
    width_pages = tables.shape[1]
    span, n_splits = decode_plan(width_pages, page_size, num_decode,
                                 decode_q, group, n_kv, d, _num_sms(dev))
    lib = build()
    out = torch.empty_like(q)
    if total == 0:
        return out
    # the decode rows' per-split partials, merged into `out` by the library
    part_o, part_ml, _part = _split_scratch(
        *_scratch_shape(n_splits, num_decode, decode_q, group, n_kv, h, d),
        dev)
    args = [_ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(tables),
            _ptr(kv_lens), _ptr(q_starts), _ptr(out), part_o, part_ml,
            num_decode, decode_q, c, h, n_kv, d, page_size, width_pages]
    tail = [positions, n_splits, span, d ** -0.5, _stream(q)]
    name = "ragged_int8" if int8 else "ragged"
    if int8:
        rc = lib.dtt_ragged_int8(*args, width, *tail)
    else:
        rc = lib.dtt_ragged(*args, *tail)
    _raise_on(lib, rc, name)
    _count(name, f"decode_q={decode_q},{'chunk' if c else 'no_chunk'}",
           f"head_dim={d}")
    return out
