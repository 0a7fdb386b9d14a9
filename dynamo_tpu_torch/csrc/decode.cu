// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` (dynamo_tpu/ops/pallas_attention.py,
// wrapper `paged_attention_decode`): one query token per sequence attends its
// context through the block table, mask tok < ctx (ctx counts the token
// written this step), ctx 0 -> zeros. Pools are [P, ps, W] with page 0 as
// the trash page: bf16 rows (W = KV*D, dtt_paged_decode) or the int8 packed
// rows of kv_cache_dtype="int8" (dtt_paged_decode_int8), whose scales fold
// into the scores and probabilities as the TPU kernel's int8 branch
// dequantizes (attention_common.cuh).
//
// Bound on the H100: bytes. Each step reads every valid K and V row of every
// sequence once (2 * sum(ctx) * KV * D * 2 bytes in bf16, 2 * sum(ctx) *
// (KV * D + 2 * KV) bytes in int8) and does ~1 FLOP per byte per query
// head, far below the ~295 FLOP/byte where the tensor cores would bind.
//
// Design: the split decode rows of attention_common.cuh, two kernels on one
// stream counted as one call. decode_kernel runs one block per (sequence,
// key span, KV head): the tensor-core tile attend_mma over the span's keys
// with the group = H/KV query heads that share the KV head as its real
// rows (so each K/V byte is read once per step, not once per query head),
// K/V through the cp.async ring, writing the span's f32 partial; spans of
// decode_split_keys keys (256, widened so that the blocks stay within 4
// per SM), planned on the host from the table's width, the batch and the
// SM count, never from context_lens. merge_splits_kernel folds the spans
// into the bf16 rows. So a 2048-token context runs on 8 SMs, not serially
// on one; the blocks are ragged.cu's decode blocks, and a row here is
// bit-identical to the same row there under the same plan. The TPU
// machinery (the sequential grid with its SMEM DMA cursor, the num_bufs
// ring, the block-diagonal [H, KV*D] query) does not come across.
#include <limits.h>

#include "attention_common.cuh"

namespace dtt {

template <int kD, typename KVTiles>
__global__ void __launch_bounds__(tile_threads<kD>()) decode_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, H, kD]
    KVTiles kv,                           // pools [P, ps, lane_width]
    const int* __restrict__ block_table,  // [B, pmax]
    const int* __restrict__ context_lens, // [B]
    int H, int KV, int page_size, int pmax, int lane_width, float scale,
    Splits sp) {
  const int bx = blockIdx.x / KV, kvh = blockIdx.x - bx * KV;
  decode_split_block<kD>(bx, kvh, q, kv, block_table, pmax, page_size,
                         lane_width, context_lens, /*q_starts=*/nullptr,
                         /*decode_q=*/1, H / KV, H, scale, sp);
}

template <typename KVTiles>
int launch_decode(const void* q, KVTiles kv, const void* block_table,
                  const void* context_lens, void* out, void* part_o,
                  void* part_ml, int B, int H, int KV, int D, int page_size,
                  int pmax, int lane_width, int num_splits, int split_keys,
                  float scale, void* stream) {
  if (B < 1 || KV < 1 || H % KV || pmax < 1 || !tile_fits(H / KV, D)
      || part_o == nullptr || part_ml == nullptr)
    return (int)cudaErrorInvalidValue;
  const int plan = check_split_plan((long long)pmax * page_size, B, KV,
                                    split_keys, num_splits);
  if (plan != 0) return plan;
  const long long blocks = (long long)B * num_splits * KV;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Splits sp{(float*)part_o, (float*)part_ml, B, num_splits, split_keys};
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    const size_t smem = tile_smem_bytes<KVTiles, kD>();
    const cudaError_t set = set_smem(decode_kernel<kD, KVTiles>, smem);
    if (set != cudaSuccess) return (int)set;
    decode_kernel<kD, KVTiles><<<(unsigned)blocks, tile_threads<kD>(), smem,
                                 st>>>(
        (const __nv_bfloat16*)q, kv, (const int*)block_table,
        (const int*)context_lens, H, KV, page_size, pmax, lane_width, scale,
        sp);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    return launch_merge<kD>(sp, (__nv_bfloat16*)out, B * H, st);
  });
}

}  // namespace dtt

extern "C" int dtt_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* block_table,
                                const void* context_lens, void* out,
                                void* part_o, void* part_ml, int B, int H,
                                int KV, int D, int page_size, int pmax,
                                int num_splits, int split_keys, float scale,
                                void* stream) {
  const dtt::Bf16Tiles kv{(const __nv_bfloat16*)k_pages,
                          (const __nv_bfloat16*)v_pages};
  return dtt::launch_decode(q, kv, block_table, context_lens, out, part_o,
                            part_ml, B, H, KV, D, page_size, pmax, KV * D,
                            num_splits, split_keys, scale, stream);
}

extern "C" int dtt_paged_decode_int8(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* block_table,
                                     const void* context_lens, void* out,
                                     void* part_o, void* part_ml, int B,
                                     int H, int KV, int D, int page_size,
                                     int pmax, int lane_width, int num_splits,
                                     int split_keys, float scale,
                                     void* stream) {
  if (lane_width % 16 || lane_width < KV * (D + 2))
    return (int)cudaErrorInvalidValue;
  const dtt::Int8Tiles kv{(const int8_t*)k_pages, (const int8_t*)v_pages,
                          KV * D};
  return dtt::launch_decode(q, kv, block_table, context_lens, out, part_o,
                            part_ml, B, H, KV, D, page_size, pmax, lane_width,
                            num_splits, split_keys, scale, stream);
}

// Keys per split of a decode row (decode.cu, ragged.cu) whose table holds
// W pages of page_size, for num_decode rows of KV heads on a card of
// num_sms SMs.
extern "C" long long dtt_decode_split_keys(int W, int page_size,
                                           int num_decode, int KV,
                                           int num_sms) {
  return dtt::decode_split_keys((long long)W * page_size, num_decode, KV,
                                num_sms);
}

extern "C" const char* dtt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
