// Ragged paged attention (the engine's mixed step) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ragged_kernel` (dynamo_tpu/ops/ragged_attention.py,
// wrapper `ragged_paged_attention`): ONE launch serves a mixed batch of
// num_decode rows of decode_q queries each (decode_q = 1 for the mixed step;
// wider rows are the TPU kernel's speculative verify windows) plus one
// prefill chunk of C queries, all over the same paged pool. Descriptors
// drive everything ragged: tables [R, W] (row r = sequence r's pages,
// trash-padded; row num_decode is the chunk's), kv_lens [R] (the sequence's
// horizon, including the tokens written this step) and q_starts [R] (the
// absolute position of its first query). Query j of row r sees key tok iff
// tok <= q_starts[r] + j and tok < kv_lens[r], the mask `attend` already
// implements. bf16 pools (dtt_ragged) or int8 packed pools (dtt_ragged_int8,
// dequantized on read as the TPU kernel's int8 branch does).
//
// Bound on the H100: bytes, as decode and a short chunk are: every decode
// row reads its context once, and each chunk query tile re-reads the chunk's
// prefix; a long chunk over a long prefix moves towards FLOPs.
//
// Design: the decode and chunk kernels' blocks on one grid (query block,
// KV head). Blocks 0 .. num_decode-1 are the decode rows, one row of decode_q
// queries each; the remaining blocks tile the chunk q_tile positions at a
// time. A block reads its descriptor row r = min(block, num_decode) and calls
// the shared `attend` (attention_common.cuh) with its page row, its first
// query's position and the row's horizon. The TPU kernel's sequential grid,
// which carried one DMA pipeline across the decode and chunk rows, becomes
// blocks that run in parallel and load their own tiles; with the same tile
// a decode row computes exactly what decode.cu does, and a chunk tile what
// chunk.cu does.
#include "attention_common.cuh"

namespace dtt {

template <typename KVRows>
__global__ void __launch_bounds__(kThreads) ragged_kernel(
    const __nv_bfloat16* __restrict__ q,  // [num_decode * decode_q + C, H, D]
    KVRows kv,                            // pools [P, ps, lane_width]
    const int* __restrict__ tables,       // [num_decode + 1, W]
    const int* __restrict__ kv_lens,      // [num_decode + 1]
    const int* __restrict__ q_starts,     // [num_decode + 1]
    __nv_bfloat16* __restrict__ out,      // like q
    int num_decode, int decode_q, int C, int H, int KV, int D, int page_size,
    int W, int lane_width, int q_tile, float scale) {
  const int bx = blockIdx.x, kvh = blockIdx.y;
  const int group = H / KV;
  const int r = min(bx, num_decode);
  int first, nq, offset;  // first query in q, its count, offset in the row
  if (bx < num_decode) {
    first = bx * decode_q;
    nq = decode_q;
    offset = 0;
  } else {
    offset = (bx - num_decode) * q_tile;
    first = num_decode * decode_q + offset;
    nq = min(q_tile, C - offset);
  }
  const PagedRows rows{tables + (long long)r * W, page_size, lane_width};
  attend(q, ((long long)first * H + kvh * group) * D, H * D, kv, rows, kvh,
         out, nq, group, D, /*qpos0=*/q_starts[r] + offset,
         /*kv_len=*/kv_lens[r], scale);
}

template <typename KVRows>
int launch_ragged(const void* q, KVRows kv, const void* tables,
                  const void* kv_lens, const void* q_starts, void* out,
                  int num_decode, int decode_q, int C, int H, int KV, int D,
                  int page_size, int W, int lane_width, int q_tile,
                  float scale, void* stream) {
  const int group = H / KV;
  if (C < 1 || num_decode < 0 || decode_q < 1
      || !fits_accumulators(decode_q * group, D)
      || !fits_accumulators(q_tile * group, D))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes((decode_q > q_tile ? decode_q : q_tile) * group, D);
  cudaError_t err = set_smem(ragged_kernel<KVRows>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(num_decode + (C + q_tile - 1) / q_tile, KV);
  ragged_kernel<KVRows><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, kv, (const int*)tables, (const int*)kv_lens,
      (const int*)q_starts, (__nv_bfloat16*)out, num_decode, decode_q, C, H,
      KV, D, page_size, W, lane_width, q_tile, scale);
  return (int)cudaGetLastError();
}

}  // namespace dtt

extern "C" int dtt_ragged(const void* q, const void* k_pages,
                          const void* v_pages, const void* tables,
                          const void* kv_lens, const void* q_starts, void* out,
                          int num_decode, int decode_q, int C, int H, int KV,
                          int D, int page_size, int W, int q_tile, float scale,
                          void* stream) {
  const dtt::Bf16Rows kv{(const __nv_bfloat16*)k_pages,
                         (const __nv_bfloat16*)v_pages};
  return dtt::launch_ragged(q, kv, tables, kv_lens, q_starts, out, num_decode,
                            decode_q, C, H, KV, D, page_size, W, KV * D,
                            q_tile, scale, stream);
}

extern "C" int dtt_ragged_int8(const void* q, const void* k_pages,
                               const void* v_pages, const void* tables,
                               const void* kv_lens, const void* q_starts,
                               void* out, int num_decode, int decode_q, int C,
                               int H, int KV, int D, int page_size, int W,
                               int lane_width, int q_tile, float scale,
                               void* stream) {
  if (D % dtt::Int8Rows::kVec) return (int)cudaErrorInvalidValue;
  const dtt::Int8Rows kv{(const int8_t*)k_pages, (const int8_t*)v_pages,
                         KV * D};
  return dtt::launch_ragged(q, kv, tables, kv_lens, q_starts, out, num_decode,
                            decode_q, C, H, KV, D, page_size, W, lane_width,
                            q_tile, scale, stream);
}
