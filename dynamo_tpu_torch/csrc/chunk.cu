// Chunked-prefill attention over the paged KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel `_chunk_kernel` (dynamo_tpu/ops/pallas_attention.py,
// wrapper `chunk_prefill_attention`): the C queries of one prefill chunk, at
// absolute positions start .. start + C - 1, attend the sequence's pages
// (prefix plus the chunk itself, already written) with the causal mask
// tok <= start + i. The page list has W entries with a trash-page tail; the
// kernel stops at each query tile's causal horizon and never reads the tail.
// bf16 pools (dtt_chunk) or int8 packed pools (dtt_chunk_int8, dequantized
// on read as the TPU kernel's int8 branch does).
//
// Bound on the H100: bytes for short chunks over a long prefix (each query
// tile re-reads the prefix: C / q_tile * (start + C) * KV * D * 4 bytes),
// FLOPs (4 * C * (start + C / 2) * H * D) once the chunk is long.
//
// Design: the decode kernel's loop with a tile of the chunk's queries in
// place of one token. One block per (query tile of up to 16 positions, KV
// head); the rows are the tile's positions x the group = H/KV query heads of
// the KV head, so a K/V tile is shared by the whole GQA group, and the page
// walk, the 16-byte K/V loads and the f32 online softmax are the ones decode
// uses (attention_common.cuh). Larger query tiles on wgmma, and a prefix
// read once for several query tiles, are later work.
#include "attention_common.cuh"

namespace dtt {

template <typename KVRows>
__global__ void __launch_bounds__(kThreads) chunk_kernel(
    const __nv_bfloat16* __restrict__ q,  // [C, H, D]
    KVRows kv,                            // pools [P, ps, W]
    const int* __restrict__ pages,        // [W]
    __nv_bfloat16* __restrict__ out,      // [C, H, D]
    int C, int H, int KV, int D, int page_size, int lane_width, int start,
    int q_tile, float scale) {
  const int i0 = blockIdx.x * q_tile, kvh = blockIdx.y;
  const int group = H / KV;
  const int nq = min(q_tile, C - i0);
  const PagedRows rows{pages, page_size, lane_width};
  attend(q, ((long long)i0 * H + kvh * group) * D, H * D, kv, rows, kvh, out,
         nq, group, D, /*qpos0=*/start + i0, /*kv_len=*/start + C, scale);
}

template <typename KVRows>
int launch_chunk(const void* q, KVRows kv, const void* pages, void* out,
                 int C, int H, int KV, int D, int page_size, int lane_width,
                 int start, int q_tile, float scale, void* stream) {
  if (!fits_accumulators(q_tile * (H / KV), D)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(q_tile * (H / KV), D);
  cudaError_t err = set_smem(chunk_kernel<KVRows>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + q_tile - 1) / q_tile, KV);
  chunk_kernel<KVRows><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, kv, (const int*)pages, (__nv_bfloat16*)out, C,
      H, KV, D, page_size, lane_width, start, q_tile, scale);
  return (int)cudaGetLastError();
}

}  // namespace dtt

extern "C" int dtt_chunk(const void* q, const void* k_pages,
                         const void* v_pages, const void* pages, void* out,
                         int C, int H, int KV, int D, int page_size, int start,
                         int q_tile, float scale, void* stream) {
  const dtt::Bf16Rows kv{(const __nv_bfloat16*)k_pages,
                         (const __nv_bfloat16*)v_pages};
  return dtt::launch_chunk(q, kv, pages, out, C, H, KV, D, page_size, KV * D,
                           start, q_tile, scale, stream);
}

extern "C" int dtt_chunk_int8(const void* q, const void* k_pages,
                              const void* v_pages, const void* pages,
                              void* out, int C, int H, int KV, int D,
                              int page_size, int lane_width, int start,
                              int q_tile, float scale, void* stream) {
  if (D % dtt::Int8Rows::kVec) return (int)cudaErrorInvalidValue;
  const dtt::Int8Rows kv{(const int8_t*)k_pages, (const int8_t*)v_pages,
                         KV * D};
  return dtt::launch_chunk(q, kv, pages, out, C, H, KV, D, page_size,
                           lane_width, start, q_tile, scale, stream);
}
