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
// Design: one block per (query tile of 64 / group positions, KV head), the
// tensor-core tile `attend_mma` (attention_common.cuh): 64 rows = positions
// x the GQA group of one KV head, so a K/V tile feeds the whole group; S and
// P V on mma.sync with f32 accumulation, the online softmax and O in
// registers, two warpgroups splitting each 64-key tile, and the K/V tiles
// streamed through a cp.async ring (three stages; two for bf16 pools at
// head_dim 256, where three do not fit). A 256-token chunk with
// group 4 is 16 x 8 = 128 blocks: one wave on the 132 SMs. Each query tile
// re-reads its causal prefix, 16 times per chunk, and mostly from the
// 50 MB L2: the 3 MB of K/V are
// read from device memory about once. What holds the tile back is latency,
// not the tensor cores: with one block per SM, the 16-byte copies (2048 per
// tile, made by the math warps), the barriers and the softmax's
// dependent steps leave the MMAs idle most of the time. TMA copies from a
// producer warp, and reading the prefix once for several query tiles (a
// cluster sharing its tiles), are later work.
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
//   each warpgroup's 320 lanes of O: two barriers per 32 keys, where
//   attend_latent paid two or three per 16 keys plus a round trip of
//   partial scores through shared memory;
// - int8 pools are widened to bf16 by the thread that copied each chunk
//   (no work area, no extra barrier).

#include <limits.h>

#include "attention_common.cuh"

namespace dtt {

template <int kD, typename KVTiles>
__global__ void __launch_bounds__(tile_threads<kD>()) chunk_kernel(
    const __nv_bfloat16* __restrict__ q,  // [C, H, kD]
    KVTiles kv,                           // pools [P, ps, W]
    const int* __restrict__ pages,        // [W]
    __nv_bfloat16* __restrict__ out,      // [C, H, kD]
    int C, int H, int KV, int page_size, int lane_width, int start,
    int positions, float scale) {
  const int i0 = blockIdx.x * positions, kvh = blockIdx.y;
  const int group = H / KV;
  const int nq = min(positions, C - i0);
  const PagedRows rows{pages, page_size, lane_width};
  attend<kD>(q, ((long long)i0 * H + kvh * group) * kD, H * kD, kv, rows,
                 kvh, nq, group, /*qpos0=*/start + i0, /*kv_len=*/start + C,
                 /*key_lo=*/0, /*key_hi=*/INT_MAX, scale,
                 TileOut{out, nullptr, nullptr, 0, H});
}

template <typename KVTiles>
int launch_chunk(const void* q, KVTiles kv, const void* pages, void* out,
                 int C, int H, int KV, int D, int page_size, int lane_width,
                 int start, int positions, int spans, float scale,
                 void* clocks, void* stream) {
  if (KV < 1 || H % KV || !tile_fits(H / KV, D)
      || positions != tile_positions(H / KV) || C < 1 || start < 0)
    return (int)cudaErrorInvalidValue;
  if (D == kLatentDim)
    return launch_chunk_latent(q, kv, pages, out, C, H, KV, page_size,
                               lane_width, start, positions, spans, scale,
                               clocks, (cudaStream_t)stream);
  if (spans != 1 || clocks != nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + positions - 1) / positions, KV);
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if constexpr (kD == kLatentDim) {
      return (int)cudaErrorInvalidValue;  // chunk_latent_kernel above
    } else {
      const size_t smem = tile_smem_bytes<KVTiles, kD>();
      cudaError_t err = set_smem(chunk_kernel<kD, KVTiles>, smem);
      if (err != cudaSuccess) return (int)err;
      chunk_kernel<kD, KVTiles><<<grid, tile_threads<kD>(), smem,
                                  (cudaStream_t)stream>>>(
          (const __nv_bfloat16*)q, kv, (const int*)pages,
          (__nv_bfloat16*)out, C, H, KV, page_size, lane_width, start,
          positions, scale);
      return (int)cudaGetLastError();
    }
  });
}

}  // namespace dtt

extern "C" int dtt_chunk(const void* q, const void* k_pages,
                         const void* v_pages, const void* pages, void* out,
                         int C, int H, int KV, int D, int page_size, int start,
                         int positions, int spans, float scale, void* clocks,
                         void* stream) {
  const dtt::Bf16Tiles kv{(const __nv_bfloat16*)k_pages,
                          (const __nv_bfloat16*)v_pages};
  return dtt::launch_chunk(q, kv, pages, out, C, H, KV, D, page_size, KV * D,
                           start, positions, spans, scale, clocks, stream);
}

extern "C" int dtt_chunk_int8(const void* q, const void* k_pages,
                              const void* v_pages, const void* pages,
                              void* out, int C, int H, int KV, int D,
                              int page_size, int lane_width, int start,
                              int positions, int spans, float scale,
                              void* clocks, void* stream) {
  if (lane_width % 16 || lane_width < KV * (D + 2))
    return (int)cudaErrorInvalidValue;
  const dtt::Int8Tiles kv{(const int8_t*)k_pages, (const int8_t*)v_pages,
                          KV * D};
  return dtt::launch_chunk(q, kv, pages, out, C, H, KV, D, page_size,
                           lane_width, start, positions, spans, scale, clocks,
                           stream);
}

// Query positions per block of the tensor-core tile (chunk.cu, prefill.cu
// and ragged.cu's chunk tiles) for a GQA group and head_dim, or 0 where
// the tile refuses them.
extern "C" int dtt_chunk_positions(int group, int D) {
  return dtt::tile_fits(group, D) ? dtt::tile_positions(group) : 0;
}

// Key spans per query tile of chunk.cu for a C-query chunk at `start`, GQA
// group and head_dim, KV heads, on a card of num_sms SMs: chunk_spans at
// head_dim 640 (chunk_latent_kernel's clusters), 1 below it; 0 where the
// tile refuses the group or head_dim.
extern "C" int dtt_chunk_spans(int C, int start, int group, int D, int KV,
                               int num_sms) {
  if (!dtt::tile_fits(group, D) || C < 1 || KV < 1) return 0;
  return D == dtt::kLatentDim
             ? dtt::chunk_spans(C, start, dtt::tile_positions(group), KV,
                                num_sms)
             : 1;
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
