// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` (dynamo_tpu/ops/pallas_attention.py,
// wrapper `paged_attention_decode`): one query token per sequence attends its
// context through the block table, mask tok < ctx (ctx counts the token
// written this step), ctx 0 -> zeros. Pools are [P, ps, W] with page 0 as
// the trash page: bf16 rows (W = KV*D, dtt_paged_decode) or the int8 packed
// rows of kv_cache_dtype="int8" (dtt_paged_decode_int8), dequantized on read
// as the TPU kernel's int8 branch does.
//
// Bound on the H100: bytes. Each step reads every valid K and V row of every
// sequence once (2 * sum(ctx) * KV * D * 2 bytes in bf16, 2 * sum(ctx) * W
// bytes in int8) and does ~4 FLOPs per bf16 byte, far below the ~295
// FLOP/byte where the tensor cores would bind.
//
// Design: one block per (sequence, KV head). The block holds the
// group = H/KV query heads that share the KV head, so each K/V byte is read
// from device memory once per step (not once per query head), walks the
// sequence's pages up to ctx in 32-token tiles with 16-byte loads, and keeps
// an f32 online softmax (attention_common.cuh). The TPU machinery (the
// sequential grid with its SMEM DMA cursor, the num_bufs ring, the
// block-diagonal [H, KV*D] query) does not come across: blocks run in
// parallel and load their own tiles. Split-K over long contexts, cp.async or
// TMA pipelining and wgmma are later work.
#include "attention_common.cuh"

namespace dtt {

template <typename KVRows>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, H, D]
    KVRows kv,                            // pools [P, ps, W]
    const int* __restrict__ block_table,  // [B, pmax]
    const int* __restrict__ context_lens, // [B]
    __nv_bfloat16* __restrict__ out,      // [B, H, D]
    int H, int KV, int D, int page_size, int pmax, int lane_width,
    float scale) {
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int group = H / KV;
  const int ctx = context_lens[b];
  const PagedRows rows{block_table + (long long)b * pmax, page_size,
                       lane_width};
  attend(q, ((long long)b * H + kvh * group) * D, H * D, kv, rows, kvh, out,
         /*nq=*/1, group, D, /*qpos0=*/ctx - 1, /*kv_len=*/ctx, scale);
}

template <typename KVRows>
int launch_decode(const void* q, KVRows kv, const void* block_table,
                  const void* context_lens, void* out, int B, int H, int KV,
                  int D, int page_size, int pmax, int lane_width, float scale,
                  void* stream) {
  if (!fits_accumulators(H / KV, D)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(H / KV, D);
  cudaError_t err = set_smem(decode_kernel<KVRows>, smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<KVRows><<<dim3(B, KV), kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, kv, (const int*)block_table,
      (const int*)context_lens, (__nv_bfloat16*)out, H, KV, D, page_size, pmax,
      lane_width, scale);
  return (int)cudaGetLastError();
}

}  // namespace dtt

extern "C" int dtt_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* block_table,
                                const void* context_lens, void* out, int B,
                                int H, int KV, int D, int page_size, int pmax,
                                float scale, void* stream) {
  const dtt::Bf16Rows kv{(const __nv_bfloat16*)k_pages,
                         (const __nv_bfloat16*)v_pages};
  return dtt::launch_decode(q, kv, block_table, context_lens, out, B, H, KV,
                            D, page_size, pmax, KV * D, scale, stream);
}

extern "C" int dtt_paged_decode_int8(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* block_table,
                                     const void* context_lens, void* out,
                                     int B, int H, int KV, int D,
                                     int page_size, int pmax, int lane_width,
                                     float scale, void* stream) {
  if (D % dtt::Int8Rows::kVec) return (int)cudaErrorInvalidValue;
  const dtt::Int8Rows kv{(const int8_t*)k_pages, (const int8_t*)v_pages,
                         KV * D};
  return dtt::launch_decode(q, kv, block_table, context_lens, out, B, H, KV,
                            D, page_size, pmax, lane_width, scale, stream);
}

extern "C" int dtt_max_rows_times_dim() { return dtt::kMaxRowsTimesDim; }

extern "C" const char* dtt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
