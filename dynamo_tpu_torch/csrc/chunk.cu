// Chunked-prefill attention over the paged KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel `_chunk_kernel` (dynamo_tpu/ops/pallas_attention.py,
// wrapper `chunk_prefill_attention`): the C queries of one prefill chunk, at
// absolute positions start .. start + C - 1, attend the sequence's pages
// (prefix plus the chunk itself, already written) with the causal mask
// tok <= start + i. The page list has W entries with a trash-page tail; the
// kernel stops at each query tile's causal horizon and never reads the tail.
// bf16 pools (dtt_chunk) or int8 packed pools (dtt_chunk_int8, whose scales
// fold into the scores and probabilities; see attention_common.cuh).
//
// Bound on the H100: operations. A 256-token chunk over a 512-token prefix
// does 4 * C * (start + C / 2) * H * D = 2.7 GFLOP on 3 MB of K/V, ~900
// FLOP per byte, three times the ~295 where the tensor cores start to bind;
// a short chunk over a long prefix moves towards bytes.
//
// Design below head_dim 640: the pair tile (attention_common.cuh,
// pair_span_block; chunk_pair_kernel). What held the previous tile
// (attend_mma: one query tile a block, S and P V on mma.sync, the math
// warps issuing the 16-byte copies and passing a barrier or two a tile)
// back was latency, and at group 1 few blocks: Phi-3's 256-token chunk was
// 128 blocks each walking a 2047-key window serially. So:
// - a block holds two query tiles of the same KV head (a pair: two
//   consumer warpgroups of 64 rows) that share every K/V tile, so a K/V
//   tile is filled once for 128 query rows;
// - a producer warpgroup (setmaxnreg: 56 registers, the consumers 224)
//   copies the K/V tiles through the page list into a ring of stages
//   (cp.async into the 64-byte swizzle; int8 rows and their scale chunks
//   into a raw ring, widened to bf16 by the copying thread) with mbarrier
//   full/empty pairs, so the math warps issue no copies;
// - S = Q K^T and O += P V run on wgmma (q and K in shared memory, P from
//   registers in two bf16 parts, V read MN-major), 64-key tiles (32 at
//   head_dim 256);
// - a pair's keys (from the key tile of its first query's window to its
//   horizon) are walked by one block (kPairSpans): a chunk row then takes
//   the bits its prompt's whole prefill gives it (prefill.cu's blocks at
//   start 0). The kernel can cut them into spans, one block each, merged
//   in the pair's cluster through distributed shared memory in span order
//   (a measurement's `spans`): two spans halve Phi-3's windowed chunk, but
//   a count planned per launch gave a prompt's rows other bits chunked
//   than whole (attention_common.cuh, PERF.md).
// A query tile multiplies only the key tiles that meet its own rows'
// keys, and masks element by element only on an edge tile.
//
// At head_dim 96 (Phi-3: group 1, a 2047-key window on every layer) a
// 256-token chunk is two pairs a KV head, 64 blocks of pairs each walking
// ~2200 keys in one span: half the card. Such a launch takes blocks of one
// query tile instead (pair_query_tiles: 128 blocks), which leaves every
// row's walk, and so its bits, as they were; two spans would also halve
// it, but give a row other bits chunked than whole (PERF.md).
//
// At head_dim 640 (MLA's latent row: DeepSeek-V2's 16 query heads on one KV
// head) the chunk runs chunk_latent_kernel (attention_common.cuh).
// Bound: operations at the served shapes. A 256-token chunk at 512 does
// 4 * C * (start + C / 2) * H * D = 6.7 GFLOP on ~2 MB of K/V (0.0068 ms of
// tensor-core time against 0.0006 ms of bytes); a short chunk over a long
// prefix moves towards bytes (C = 1 reads the whole prefix for 16 rows).
// At group 16 a 64-row tile holds 4 positions, so a 256-token chunk has
// only 64 query tiles, each walking up to 768 keys: one block per tile
// left half the H100's 132 SMs idle and ran long serial walks. So:
// - each query tile's keys are cut into chunk_spans equal spans, planned on
//   the host from C, start, the group and the SM count: the largest power
//   of two whose blocks run in one wave (2 at C = 256: 128 blocks; 4 for
//   the ~88-token tail: 88). The spans of a query tile are one
//   thread-block cluster; after their walks the blocks merge the partials
//   (O in f32, m, l) through distributed shared memory, in span order
//   (equal bits run to run; no scratch in device memory, where the f32
//   partials of a 256-token chunk would be 2 x 10.5 MB). Clusters of 3, 5
//   or 6 blocks leave 15-30 SMs of the card idle, and a second wave costs
//   more than longer spans (PERF.md, the span sweep);
// - a block walks 32-key tiles with S = Q K^T on wgmma over all 640
//   lanes (q and K in the 128-byte swizzle, each warpgroup computing the
//   same scores, so no partial score crosses warps) and P V on wgmma over
//   each warpgroup's 320 lanes of O: two barriers per 32 keys, where the
//   first latent tile (16 warps, each a quarter of the lanes) paid two or
//   three per 16 keys plus a round trip of partial scores through shared
//   memory;
// - int8 pools are widened to bf16 by the thread that copied each chunk
//   (no work area, no extra barrier).
//
// Below head_dim 640 a launch also takes one layer's sliding window and
// tanh logit cap (Gemma-2/3: `window`, `logit_cap`, 0 for none; ScoreMods in
// attention_common.cuh): a pair's keys start at the key tile of its first
// query's window. The latent tile refuses both.

#include "attention_common.cuh"

namespace dtt {

template <typename KVTiles>
int launch_chunk_pair(const void* q, KVTiles kv, const void* pages, void* out,
                      int C, int H, int KV, int D, int page_size,
                      int lane_width, int start, int positions, int spans,
                      float scale, ScoreMods mods, void* clocks,
                      cudaStream_t stream, const int* desc_start,
                      const int* desc_kv_len, int max_keys) {
  int num_sms = 0;
  const int rc = num_sms_of_device(&num_sms);
  if (rc != 0) return rc;
  const int tiles = pair_query_tiles(pair_count(C, positions) * KV, num_sms);
  const long long blocks_y = pair_blocks_y(C, positions, tiles);
  // the longest horizon: the chunk's end, or ragged.cu's table end
  const long long horizon = desc_start ? max_keys : (long long)start + C;
  if (spans < 1 || spans > pair_max_spans(horizon, mods.window, positions, D)
      || blocks_y > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    constexpr size_t smem = PairSmem<KVTiles, kD>::bytes;
    auto kernel = chunk_pair_kernel<kD, KVTiles>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    LatentLaunch launch(dim3(spans, (unsigned)blocks_y, KV), smem, stream,
                        kPairThreads);
    err = cudaLaunchKernelEx(&launch.cfg, kernel, (const __nv_bfloat16*)q, kv,
                             (const int*)pages, (__nv_bfloat16*)out, C, H, KV,
                             page_size, lane_width, start, positions, tiles,
                             scale, mods, (unsigned long long*)clocks,
                             desc_start, desc_kv_len, max_keys);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  });
}

// the instances ragged.cu's chunk rows launch
template int launch_chunk_pair<Bf16Tiles>(const void*, Bf16Tiles, const void*,
                                          void*, int, int, int, int, int, int,
                                          int, int, int, float, ScoreMods,
                                          void*, cudaStream_t, const int*,
                                          const int*, int);
template int launch_chunk_pair<Int8Tiles>(const void*, Int8Tiles, const void*,
                                          void*, int, int, int, int, int, int,
                                          int, int, int, float, ScoreMods,
                                          void*, cudaStream_t, const int*,
                                          const int*, int);

template <typename KVTiles>
int launch_chunk(const void* q, KVTiles kv, const void* pages, void* out,
                 int C, int H, int KV, int D, int page_size, int lane_width,
                 int start, int positions, int spans, float scale,
                 ScoreMods mods, void* clocks, void* stream) {
  if (KV < 1 || H % KV || !tile_fits(H / KV, D)
      || positions != tile_positions(H / KV) || C < 1 || start < 0
      || mods.window < 0 || !(mods.cap >= 0.f)
      || (D == kLatentDim && (mods.window || mods.cap > 0.f)))
    return (int)cudaErrorInvalidValue;
  if (!pair_tile_takes(D))
    return launch_chunk_latent(q, kv, pages, out, C, H, KV, page_size,
                               lane_width, start, positions, spans, scale,
                               clocks, (cudaStream_t)stream);
  return launch_chunk_pair(q, kv, pages, out, C, H, KV, D, page_size,
                           lane_width, start, positions, spans, scale, mods,
                           clocks, (cudaStream_t)stream);
}

}  // namespace dtt

extern "C" int dtt_chunk(const void* q, const void* k_pages,
                         const void* v_pages, const void* pages, void* out,
                         int C, int H, int KV, int D, int page_size, int start,
                         int positions, int spans, float scale, int window,
                         float logit_cap, void* clocks, void* stream) {
  const dtt::Bf16Tiles kv{(const __nv_bfloat16*)k_pages,
                          (const __nv_bfloat16*)v_pages};
  return dtt::launch_chunk(q, kv, pages, out, C, H, KV, D, page_size, KV * D,
                           start, positions, spans, scale,
                           dtt::ScoreMods{window, logit_cap}, clocks, stream);
}

extern "C" int dtt_chunk_int8(const void* q, const void* k_pages,
                              const void* v_pages, const void* pages,
                              void* out, int C, int H, int KV, int D,
                              int page_size, int lane_width, int start,
                              int positions, int spans, float scale,
                              int window, float logit_cap, void* clocks,
                              void* stream) {
  if (lane_width % 16 || lane_width < KV * (D + 2))
    return (int)cudaErrorInvalidValue;
  const dtt::Int8Tiles kv{(const int8_t*)k_pages, (const int8_t*)v_pages,
                          KV * D};
  return dtt::launch_chunk(q, kv, pages, out, C, H, KV, D, page_size,
                           lane_width, start, positions, spans, scale,
                           dtt::ScoreMods{window, logit_cap}, clocks, stream);
}

// Query positions per block of the tensor-core tile (chunk.cu, prefill.cu
// and ragged.cu's chunk tiles) for a GQA group and head_dim, or 0 where
// the tile refuses them.
extern "C" int dtt_chunk_positions(int group, int D) {
  return dtt::tile_fits(group, D) ? dtt::tile_positions(group) : 0;
}

// Key spans per query tile (at head_dim 640) or query-tile pair (below it)
// of chunk.cu for a C-query chunk at `start`, GQA group and head_dim, KV
// heads, on a card of num_sms SMs: chunk_spans at head_dim 640
// (chunk_latent_kernel's clusters), kPairSpans (1) below it; 0 where the
// tile refuses the group or head_dim.
extern "C" int dtt_chunk_spans(int C, int start, int group, int D, int KV,
                               int num_sms) {
  using namespace dtt;
  if (!tile_fits(group, D) || C < 1 || KV < 1) return 0;
  return D == kLatentDim
             ? chunk_spans(C, start, tile_positions(group), KV, num_sms)
             : kPairSpans;
}

// Query tiles a block of the pair tile holds for a launch of `pair_blocks`
// blocks of pairs on a card of num_sms SMs (pair_query_tiles): 2, or 1
// where blocks of single tiles still run in one wave.
extern "C" int dtt_pair_query_tiles(long long pair_blocks, int num_sms) {
  return dtt::pair_query_tiles(pair_blocks, num_sms);
}

// Clusters of `spans` blocks of the latent chunk tile (bf16 pools, or int8
// with int8 != 0) that the current device runs at once, or -1 where the
// query fails (cudaOccupancyMaxActiveClusters): how far a cluster size
// fills the card's GPCs.
extern "C" int dtt_chunk_max_clusters(int spans, int int8) {
  using namespace dtt;
  if (spans < 1 || spans > kMaxChunkSpans) return -1;
  int n = -1;
  auto query = [&](auto kernel, size_t smem) {
    if (set_smem(kernel, smem) != cudaSuccess) return;
    const LatentLaunch launch(dim3(spans, 1, 1), smem, nullptr);
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &launch.cfg)
        != cudaSuccess)
      n = -1;
  };
  if (int8)
    query(chunk_latent_kernel<Int8Tiles>, ChunkSmem<Int8Tiles>::bytes);
  else
    query(chunk_latent_kernel<Bf16Tiles>, ChunkSmem<Bf16Tiles>::bytes);
  return n;
}

