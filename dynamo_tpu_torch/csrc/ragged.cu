// Ragged paged attention (the engine's mixed step) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ragged_kernel` (dynamo_tpu/ops/ragged_attention.py,
// wrapper `ragged_paged_attention`): ONE call serves a mixed batch of
// num_decode rows of decode_q queries each (decode_q = 1 for the mixed step;
// wider rows are the speculative verify windows, decode_q = K + 1) plus one
// prefill chunk of C >= 0 queries, all over the same paged pool. C = 0 is a
// verify step without a chunk: the grid then holds decode blocks only, and
// the chunk's descriptor row is never read. Descriptors
// drive everything ragged: tables [R, W] (row r = sequence r's pages,
// trash-padded; row num_decode is the chunk's), kv_lens [R] (the sequence's
// horizon, including the tokens written this step) and q_starts [R] (the
// absolute position of its first query). Query j of row r sees key tok iff
// tok <= q_starts[r] + j and tok < kv_lens[r]; a horizon past the table's
// W * page_size keys is cut there, where the TPU kernel clamps its page
// index. bf16 pools (dtt_ragged) or int8 packed pools (dtt_ragged_int8).
// Below head_dim 640 a launch also takes one layer's sliding window and
// tanh logit cap (Gemma-2/3: `window`, `logit_cap`, 0 for none; ScoreMods in
// attention_common.cuh), one scalar for all its rows, each row bounded at
// its own query positions; the latent rows refuse both.
//
// Bound on the H100: bytes for the decode rows (each reads its context
// once, ~1 FLOP per byte per query), operations for the chunk (chunk.cu).
//
// Design below head_dim 640: up to three kernels on one stream, counted as
// one call.
// - the chunk rows, first (the longest blocks): chunk.cu's chunk_pair_kernel
//   (launch_chunk_pair: the pair tile of attention_common.cuh, S and P V on
//   wgmma, a producer warpgroup's copies) with the chunk's start and
//   horizon read from q_starts[num_decode] and kv_lens[num_decode] on the
//   card, in one span a pair as chunk.cu's own launches (kPairSpans, no
//   plan from the start), so a chunk row equals chunk.cu's bit for bit;
// - ragged_kernel, a 1-D grid of (block, KV head) pairs, KV head fastest:
//   the decode rows split along their keys, one block per (row, span, KV
//   head), decode.cu's blocks (decode_split_block, attention_common.cuh),
//   so with decode.cu's plan (the same table width, row count and window)
//   and decode_q = 1 a decode row is bit-identical to decode.cu's. The
//   plan cuts the table without a window (a 128k-token table of 8 rows
//   gets 8 spans of 16k keys, not 512) and, under one, the window +
//   decode_q - 1 keys a row can see, each block placing its span from its
//   row's window start (read from q_starts on the card). Rows of
//   decode_q x group <= 16 (decode rows, and verify windows of small
//   groups: 5 x 2 at Gemma-2) run the narrow tile attend_narrow, every
//   warp on its own key slice and lane half; wider verify windows (5 x 4
//   at the 8B) attend_mma's 64-row tile;
// - merge_splits_kernel (attention_common.cuh), one warp per (decode
//   query, query head), folds the spans' partials into the bf16 rows.
// At head_dim 640 (MLA's latent row) two or three kernels on one stream,
// counted as one call:
// - the chunk rows run chunk_latent_kernel (chunk.cu's latent tile: query
//   tiles whose keys are cut into spans merged in a cluster) with the
//   chunk's start and horizon read from q_starts[num_decode] and
//   kv_lens[num_decode] on the card; its spans are planned from C and the
//   table's W * page_size keys (chunk_spans at start W * page_size - C),
//   so at the same span count a chunk row equals chunk.cu's bit for bit;
// - the decode and verify rows run decode_latent_kernel and
//   merge_latent_kernel (attention_common.cuh): latent_decode_spans x
//   num_decode spans shared out over the rows by their horizons on the
//   card, each row's horizon cut into equal spans, the query tiles of a
//   verify window (4 and 1 positions of 16 heads for 5 x 16 rows) walking
//   the same span side by side, never one after the other; decode.cu's
//   blocks, so at decode_q = 1 and the same plan a decode row equals
//   decode.cu's bit for bit.
// The TPU kernel's sequential grid, which carried one DMA pipeline across
// the decode and chunk rows, becomes blocks that run in parallel, each
// with its own copies in flight.
#include <limits.h>

#include "attention_common.cuh"

namespace dtt {

// Block bx / KV of the decode rows below head_dim 640, KV head bx % KV:
// the (row, span) block bx (decode_split_block). The partials go to `sp`;
// merge_splits_kernel writes the rows.
template <int kD, typename KVTiles, bool kNarrow>
__global__ void __launch_bounds__(kTileThreads) ragged_kernel(
    const __nv_bfloat16* __restrict__ q,  // decode rows first, [.., H, D]
    KVTiles kv,                           // pools [P, ps, lane_width]
    const int* __restrict__ tables,       // [num_decode + 1, W]
    const int* __restrict__ kv_lens,      // [num_decode + 1]
    const int* __restrict__ q_starts,     // [num_decode + 1]
    int decode_q, int H, int KV, int page_size, int W, int lane_width,
    float scale, ScoreMods mods, Splits sp) {
  const int bx = blockIdx.x / KV, kvh = blockIdx.x - bx * KV;
  decode_split_block<kD, KVTiles, kNarrow>(
      bx, kvh, q, kv, tables, W, page_size, lane_width, kv_lens, q_starts,
      decode_q, H / KV, H, scale, mods, sp);
}

// The latent rows (head_dim 640): the chunk on chunk_latent_kernel, then
// the decode rows on decode_latent_kernel and merge_latent_kernel.
template <typename KVTiles>
int launch_ragged_latent(const void* q, KVTiles kv, const void* tables,
                         const void* kv_lens, const void* q_starts, void* out,
                         void* part_o, void* part_ml, int num_decode,
                         int decode_q, int C, int H, int KV, int page_size,
                         int W, int lane_width, int positions, int num_splits,
                         int split_keys, float scale, cudaStream_t stream) {
  const long long max_keys = (long long)W * page_size;
  const int plan = check_latent_plan(num_decode, decode_q, H / KV, KV,
                                     max_keys, num_splits, split_keys);
  if (plan != 0) return plan;
  if (C > 0) {
    int num_sms = 0;
    const int err = num_sms_of_device(&num_sms);
    if (err != 0) return err;
    const long long first = (long long)num_decode * decode_q;  // its query 0
    const int spans = chunk_spans(
        C, (int)std::min((long long)INT_MAX, std::max(0LL, max_keys - C)),
        positions, KV, num_sms);
    const int rc = launch_chunk_latent(
        (const __nv_bfloat16*)q + first * H * kLatentDim, kv,
        (const int*)tables + (long long)num_decode * W,
        (__nv_bfloat16*)out + first * H * kLatentDim, C, H, KV, page_size,
        lane_width, /*start=*/0, positions, spans, scale, nullptr, stream,
        (const int*)q_starts + num_decode, (const int*)kv_lens + num_decode,
        (int)std::min((long long)INT_MAX, max_keys));
    if (rc != 0) return rc;
  }
  if (num_decode == 0) return 0;
  return launch_latent_rows(q, kv, tables, kv_lens, q_starts, out, part_o,
                            part_ml, num_decode, decode_q, H, KV, page_size,
                            W, lane_width, num_splits, scale, stream);
}

template <typename KVTiles>
int launch_ragged(const void* q, KVTiles kv, const void* tables,
                  const void* kv_lens, const void* q_starts, void* out,
                  void* part_o, void* part_ml, int num_decode, int decode_q,
                  int C, int H, int KV, int D, int page_size, int W,
                  int lane_width, int positions, int num_splits,
                  int split_keys, float scale, ScoreMods mods, void* stream) {
  if (KV < 1 || H % KV || mods.window < 0 || !(mods.cap >= 0.f)
      || (D == kLatentDim && (mods.window || mods.cap > 0.f)))
    return (int)cudaErrorInvalidValue;
  const int group = H / KV;
  if (C < 0 || num_decode < 0 || decode_q < 1 || W < 1
      || !tile_fits(group, D)
      || (D != kLatentDim && decode_q * group > kTileRows)
      || positions != tile_positions(group))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (D == kLatentDim)
    return launch_ragged_latent(q, kv, tables, kv_lens, q_starts, out,
                                part_o, part_ml, num_decode, decode_q, C, H,
                                KV, page_size, W, lane_width, positions,
                                num_splits, split_keys, scale, st);
  if (num_decode > 0 && (part_o == nullptr || part_ml == nullptr))
    return (int)cudaErrorInvalidValue;
  const int plan = check_split_plan((long long)W * page_size, num_decode,
                                    decode_q, KV, D, mods.window, split_keys,
                                    num_splits);
  if (plan != 0) return plan;
  if ((long long)W * page_size > INT_MAX) return (int)cudaErrorInvalidValue;
  // the chunk rows: chunk.cu's pair tile (one span, start read on the
  // card)
  if (C > 0) {
    const long long first = (long long)num_decode * decode_q;  // its query 0
    const int rc = launch_chunk_pair(
        (const __nv_bfloat16*)q + first * H * D, kv,
        (const int*)tables + (long long)num_decode * W,
        (__nv_bfloat16*)out + first * H * D, C, H, KV, D, page_size,
        lane_width, /*start=*/0, positions, kPairSpans, scale, mods, nullptr,
        st, (const int*)q_starts + num_decode,
        (const int*)kv_lens + num_decode, W * page_size);
    if (rc != 0) return rc;
  }
  const long long blocks = (long long)num_decode * num_splits * KV;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;  // no decode rows
  const Splits sp{(float*)part_o, (float*)part_ml,
                  (long long)num_decode * decode_q, num_splits, split_keys};
  const bool narrow = narrow_rows(decode_q, group);
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    auto launch = [&](auto narrow_tile) {
      constexpr bool kNarrow = decltype(narrow_tile)::value;
      const size_t smem = decode_smem_bytes<KVTiles, kD, kNarrow>();
      auto kernel = ragged_kernel<kD, KVTiles, kNarrow>;
      const cudaError_t set = set_smem(kernel, smem);
      if (set != cudaSuccess) return (int)set;
      kernel<<<(unsigned)blocks, kTileThreads, smem, st>>>(
          (const __nv_bfloat16*)q, kv, (const int*)tables,
          (const int*)kv_lens, (const int*)q_starts, decode_q, H, KV,
          page_size, W, lane_width, scale, mods, sp);
      const int rc = (int)cudaGetLastError();
      if (rc != 0) return rc;
      return launch_merge<kD>(sp, (__nv_bfloat16*)out,
                              num_decode * decode_q * H, st);
    };
    return narrow ? launch(std::true_type{}) : launch(std::false_type{});
  });
}

}  // namespace dtt

extern "C" int dtt_ragged(const void* q, const void* k_pages,
                          const void* v_pages, const void* tables,
                          const void* kv_lens, const void* q_starts, void* out,
                          void* part_o, void* part_ml, int num_decode,
                          int decode_q, int C, int H, int KV, int D,
                          int page_size, int W, int positions, int num_splits,
                          int split_keys, float scale, int window,
                          float logit_cap, void* stream) {
  const dtt::Bf16Tiles kv{(const __nv_bfloat16*)k_pages,
                          (const __nv_bfloat16*)v_pages};
  return dtt::launch_ragged(q, kv, tables, kv_lens, q_starts, out, part_o,
                            part_ml, num_decode, decode_q, C, H, KV, D,
                            page_size, W, KV * D, positions, num_splits,
                            split_keys, scale,
                            dtt::ScoreMods{window, logit_cap}, stream);
}

extern "C" int dtt_ragged_int8(const void* q, const void* k_pages,
                               const void* v_pages, const void* tables,
                               const void* kv_lens, const void* q_starts,
                               void* out, void* part_o, void* part_ml,
                               int num_decode, int decode_q, int C, int H,
                               int KV, int D, int page_size, int W,
                               int lane_width, int positions, int num_splits,
                               int split_keys, float scale, int window,
                               float logit_cap, void* stream) {
  if (lane_width % 16 || lane_width < KV * (D + 2))
    return (int)cudaErrorInvalidValue;
  const dtt::Int8Tiles kv{(const int8_t*)k_pages, (const int8_t*)v_pages,
                          KV * D};
  return dtt::launch_ragged(q, kv, tables, kv_lens, q_starts, out, part_o,
                            part_ml, num_decode, decode_q, C, H, KV, D,
                            page_size, W, lane_width, positions, num_splits,
                            split_keys, scale,
                            dtt::ScoreMods{window, logit_cap}, stream);
}
