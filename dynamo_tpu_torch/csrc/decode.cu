// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` (dynamo_tpu/ops/pallas_attention.py,
// wrapper `paged_attention_decode`): one query token per sequence attends its
// context through the block table, mask tok < ctx (ctx counts the token
// written this step), ctx 0 -> zeros. Pools are [P, ps, W] with page 0 as
// the trash page: bf16 rows (W = KV*D, dtt_paged_decode) or the int8 packed
// rows of kv_cache_dtype="int8" (dtt_paged_decode_int8), whose scales fold
// into the scores and probabilities as the TPU kernel's int8 branch
// dequantizes (attention_common.cuh). Below head_dim 640 a launch also
// takes one layer's sliding window and tanh logit cap (Gemma-2/3:
// `window`, `logit_cap`, 0 for none; ScoreMods in attention_common.cuh): a
// windowed row reads only the key tiles from its window's start on, in
// spans cut from there.
//
// Bound on the H100: bytes. Each step reads every valid K and V row of every
// sequence once (2 * sum(ctx) * KV * D * 2 bytes in bf16, 2 * sum(ctx) *
// (KV * D + 2 * KV) bytes in int8) and does ~1 FLOP per byte per query
// head, far below the ~295 FLOP/byte where the tensor cores would bind.
//
// Design below head_dim 640: the split decode rows of attention_common.cuh,
// two kernels on one stream counted as one call. decode_kernel runs one
// block per (sequence, key span, KV head) over the group = H/KV query heads
// that share the KV head (so each K/V byte is read once per step, not once
// per query head), writing the span's f32 partial; merge_splits_kernel
// folds the spans into the bf16 rows. The spans are planned on the host
// from the table's width, the batch, the layer's window and the SM count
// (decode_plan_keys, decode_split_keys: spans of 256 keys or more, at most
// 4 blocks an SM, 8 for windowed rows at head_dim <= 128), never from
// context_lens: without a window they cut the
// table, under one the keys a row can see, each block placing its span
// from its own row's window start on the card, so a windowed row's keys
// spread over every span of the plan (Phi-3: four spans of 576 keys for
// its 2047-key window on 4096-key tables, not one of 2048 in a span of
// its own). A block is the narrow tile attend_narrow: 16 query rows, the
// row's group (1 at Phi-3, 2 at Gemma-2, 4 at the 8B), every one of its
// eight warps computing, each on a 16-key slice of every 64-key tile and
// half of the head's lanes, K/V through the cp.async ring; a group
// above 16 (no preset) runs attend_mma's 64-row tile. The blocks are
// ragged.cu's decode blocks, and a row here is bit-identical to the same
// row there under the same plan.
//
// At head_dim 640 (MLA's latent row: DeepSeek-V2's 16 query heads on one
// KV head) the rows run the latent decode rows of attention_common.cuh
// (launch_latent_rows): a launch of latent_decode_spans x B spans
// (planned on the host from the table's width, the batch, the group and
// the SM count: 16 x 8 = 128 blocks, one a SM, for 8 rows on 2048-key
// tables), shared out on the card in proportion to the rows' horizons,
// each row's horizon cut into equal spans (at phase 3's contexts no
// block walks more than 64 keys), one block each running the latent
// tile's walk (32-key tiles, S and P V on wgmma, two barriers a tile,
// int8 widened by the copying thread), and merge_latent_kernel folding
// the spans of the rows that have more than one. They are ragged.cu's
// latent decode blocks, so a row here equals the same row there under
// the same plan, bit for bit.
//
// The TPU machinery (the sequential grid with its SMEM DMA cursor, the
// num_bufs ring, the block-diagonal [H, KV*D] query) does not come across.
#include <limits.h>

#include "attention_common.cuh"

namespace dtt {

template <int kD, typename KVTiles, bool kNarrow>
__global__ void __launch_bounds__(kTileThreads) decode_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, H, kD]
    KVTiles kv,                           // pools [P, ps, lane_width]
    const int* __restrict__ block_table,  // [B, pmax]
    const int* __restrict__ context_lens, // [B]
    int H, int KV, int page_size, int pmax, int lane_width, float scale,
    ScoreMods mods, Splits sp) {
  const int bx = blockIdx.x / KV, kvh = blockIdx.x - bx * KV;
  decode_split_block<kD, KVTiles, kNarrow>(
      bx, kvh, q, kv, block_table, pmax, page_size, lane_width, context_lens,
      /*q_starts=*/nullptr, /*decode_q=*/1, H / KV, H, scale, mods, sp);
}

template <typename KVTiles>
int launch_decode(const void* q, KVTiles kv, const void* block_table,
                  const void* context_lens, void* out, void* part_o,
                  void* part_ml, int B, int H, int KV, int D, int page_size,
                  int pmax, int lane_width, int num_splits, int split_keys,
                  float scale, ScoreMods mods, void* stream) {
  if (B < 1 || KV < 1 || H % KV || pmax < 1 || !tile_fits(H / KV, D)
      || mods.window < 0 || !(mods.cap >= 0.f))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (D == kLatentDim) {
    if (mods.window || mods.cap > 0.f) return (int)cudaErrorInvalidValue;
    const int plan = check_latent_plan(B, 1, H / KV, KV,
                                       (long long)pmax * page_size,
                                       num_splits, split_keys);
    if (plan != 0) return plan;
    return launch_latent_rows(q, kv, block_table, context_lens,
                              /*q_starts=*/nullptr, out, part_o, part_ml, B,
                              /*decode_q=*/1, H, KV, page_size, pmax,
                              lane_width, num_splits, scale, st);
  }
  if (part_o == nullptr || part_ml == nullptr)
    return (int)cudaErrorInvalidValue;
  const int plan = check_split_plan((long long)pmax * page_size, B,
                                    /*decode_q=*/1, KV, D, mods.window,
                                    split_keys, num_splits);
  if (plan != 0) return plan;
  const long long blocks = (long long)B * num_splits * KV;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const Splits sp{(float*)part_o, (float*)part_ml, B, num_splits, split_keys};
  const bool narrow = narrow_rows(1, H / KV);
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    auto launch = [&](auto narrow_tile) {
      constexpr bool kNarrow = decltype(narrow_tile)::value;
      const size_t smem = decode_smem_bytes<KVTiles, kD, kNarrow>();
      auto kernel = decode_kernel<kD, KVTiles, kNarrow>;
      const cudaError_t set = set_smem(kernel, smem);
      if (set != cudaSuccess) return (int)set;
      kernel<<<(unsigned)blocks, kTileThreads, smem, st>>>(
          (const __nv_bfloat16*)q, kv, (const int*)block_table,
          (const int*)context_lens, H, KV, page_size, pmax, lane_width,
          scale, mods, sp);
      const int rc = (int)cudaGetLastError();
      if (rc != 0) return rc;
      return launch_merge<kD>(sp, (__nv_bfloat16*)out, B * H, st);
    };
    return narrow ? launch(std::true_type{}) : launch(std::false_type{});
  });
}

}  // namespace dtt

extern "C" int dtt_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* block_table,
                                const void* context_lens, void* out,
                                void* part_o, void* part_ml, int B, int H,
                                int KV, int D, int page_size, int pmax,
                                int num_splits, int split_keys, float scale,
                                int window, float logit_cap, void* stream) {
  const dtt::Bf16Tiles kv{(const __nv_bfloat16*)k_pages,
                          (const __nv_bfloat16*)v_pages};
  return dtt::launch_decode(q, kv, block_table, context_lens, out, part_o,
                            part_ml, B, H, KV, D, page_size, pmax, KV * D,
                            num_splits, split_keys, scale,
                            dtt::ScoreMods{window, logit_cap}, stream);
}

extern "C" int dtt_paged_decode_int8(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* block_table,
                                     const void* context_lens, void* out,
                                     void* part_o, void* part_ml, int B,
                                     int H, int KV, int D, int page_size,
                                     int pmax, int lane_width, int num_splits,
                                     int split_keys, float scale, int window,
                                     float logit_cap, void* stream) {
  if (lane_width % 16 || lane_width < KV * (D + 2))
    return (int)cudaErrorInvalidValue;
  const dtt::Int8Tiles kv{(const int8_t*)k_pages, (const int8_t*)v_pages,
                          KV * D};
  return dtt::launch_decode(q, kv, block_table, context_lens, out, part_o,
                            part_ml, B, H, KV, D, page_size, pmax, lane_width,
                            num_splits, split_keys, scale,
                            dtt::ScoreMods{window, logit_cap}, stream);
}

// Keys per split of a decode row (decode.cu, ragged.cu) whose table holds
// W pages of page_size, for num_decode rows of decode_q queries, KV heads
// of head_dim D and a layer's window (0: none) on a card of num_sms SMs.
extern "C" long long dtt_decode_split_keys(int W, int page_size,
                                           int num_decode, int decode_q,
                                           int KV, int D, int window,
                                           int num_sms) {
  return dtt::decode_split_keys(
      dtt::decode_plan_keys((long long)W * page_size, window, decode_q),
      num_decode, KV, num_sms, dtt::split_blocks_per_sm(window, D));
}

// Spans per query tile of num_decode latent decode rows (decode.cu,
// ragged.cu at head_dim 640) of decode_q queries, GQA group, KV heads, over
// tables of W pages of page_size, on a card of num_sms SMs.
extern "C" int dtt_latent_decode_spans(int W, int page_size, int num_decode,
                                       int decode_q, int group, int KV,
                                       int num_sms) {
  if (!dtt::tile_fits(group, dtt::kLatentDim) || KV < 1 || decode_q < 1)
    return 0;
  return dtt::latent_decode_spans(num_decode, decode_q, group, KV,
                                  (long long)W * page_size, num_sms);
}

// merge_latent_kernel alone over partials in the scratch layout of the
// latent decode rows (rows of num_decode x decode_q queries, H heads on
// KV, row_plan the rows' (first span, spans)): the merge's own time, for a
// measurement (decode.cu and ragged.cu launch it themselves).
extern "C" int dtt_latent_merge(const void* part_o, const void* part_ml,
                                const void* row_plan, void* out,
                                int num_decode, int decode_q, int H, int KV,
                                void* stream) {
  if (KV < 1 || H % KV || !dtt::tile_fits(H / KV, dtt::kLatentDim)
      || decode_q < 1)
    return (int)cudaErrorInvalidValue;
  int num_sms = 0;
  const int err = dtt::num_sms_of_device(&num_sms);
  if (err != 0) return err;
  return dtt::launch_latent_merge((const float*)part_o, (const float*)part_ml,
                                  (const int2*)row_plan, (__nv_bfloat16*)out,
                                  num_decode, decode_q, H, KV, num_sms,
                                  (cudaStream_t)stream);
}

extern "C" const char* dtt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
