// Ragged paged attention (the engine's mixed step) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ragged_kernel` (dynamo_tpu/ops/ragged_attention.py,
// wrapper `ragged_paged_attention`): ONE call serves a mixed batch of
// num_decode rows of decode_q queries each (decode_q = 1 for the mixed step;
// wider rows are the TPU kernel's speculative verify windows) plus one
// prefill chunk of C queries, all over the same paged pool. Descriptors
// drive everything ragged: tables [R, W] (row r = sequence r's pages,
// trash-padded; row num_decode is the chunk's), kv_lens [R] (the sequence's
// horizon, including the tokens written this step) and q_starts [R] (the
// absolute position of its first query). Query j of row r sees key tok iff
// tok <= q_starts[r] + j and tok < kv_lens[r]; a horizon past the table's
// W * page_size keys is cut there, where the TPU kernel clamps its page
// index. bf16 pools (dtt_ragged) or int8 packed pools (dtt_ragged_int8).
//
// Bound on the H100: bytes for the decode rows (each reads its context
// once, ~1 FLOP per byte per query), operations for the chunk (chunk.cu).
//
// Design: two kernels on one stream, counted as one call.
// - ragged_kernel, a 1-D grid of (block, KV head) pairs, KV head fastest:
//   the chunk tiles first, so the longest blocks start first and the short
//   decode blocks fill the SMs behind them. The chunk tiles are chunk.cu's
//   blocks: the same attend_mma call with the same tiling, so a chunk row
//   is bit-identical to chunk.cu's. Each decode row
//   is split along its keys into num_splits spans of split_keys keys
//   (ragged_split_keys: kSplitKeys, widened so that the decode blocks stay
//   within kSplitBlocksPerSm per SM; from the table's width, the row count
//   and the SM count on the host: the kv_lens live on the card and are
//   never read back), one block per (row, span, KV head) writing the
//   span's unnormalized partial (O, m, l) in f32; a span at or past its
//   row's horizon writes m = -inf, l = 0 and exits. So a 2048-token row
//   of 8 runs on 8 SMs beside the chunk tiles instead of serially on one,
//   and a 128k-token table of 8 rows gets 8 spans of 16k keys, not 512.
//   The decode block runs the same 64-row tile with decode_q x group real
//   rows: the rows are bound by bytes, and the MMA lanes the padding
//   wastes cost no bytes.
// - merge_splits_kernel, one warp per (decode query, query head): the
//   log-sum-exp merge of the spans' partials, O = sum_s O_s 2^(m_s - M) /
//   sum_s l_s 2^(m_s - M) with M = max_s m_s, skipping empty spans; exact
//   zeros where every span was empty.
// The TPU kernel's sequential grid, which carried one DMA pipeline across
// the decode and chunk rows, becomes blocks that run in parallel, each
// with its own cp.async ring.
#include <limits.h>

#include "attention_common.cuh"

namespace dtt {

template <int kD, typename KVTiles>
__global__ void __launch_bounds__(kTileThreads) ragged_kernel(
    const __nv_bfloat16* __restrict__ q,  // [num_decode * decode_q + C, H, D]
    KVTiles kv,                           // pools [P, ps, lane_width]
    const int* __restrict__ tables,       // [num_decode + 1, W]
    const int* __restrict__ kv_lens,      // [num_decode + 1]
    const int* __restrict__ q_starts,     // [num_decode + 1]
    __nv_bfloat16* __restrict__ out,      // like q
    float* __restrict__ part_o,           // [num_splits, num_decode * decode_q, H, D]
    float* __restrict__ part_ml,          // [num_splits, num_decode * decode_q, H, 2]
    int num_decode, int decode_q, int C, int H, int KV, int page_size, int W,
    int lane_width, int positions, int num_splits, int split_keys,
    float scale) {
  const int bx = blockIdx.x / KV, kvh = blockIdx.x - bx * KV;
  const int group = H / KV;
  const int tiles = (C + positions - 1) / positions;
  const int max_tok = W * page_size;
  if (bx >= tiles) {  // a decode block: row b, key span s
    const int b = (bx - tiles) / num_splits;
    const int s = bx - tiles - b * num_splits;
    const long long nd = (long long)num_decode * decode_q;
    const PagedRows rows{tables + (long long)b * W, page_size, lane_width};
    attend_mma<kD>(q, ((long long)b * decode_q * H + kvh * group) * kD,
                   H * kD, kv, rows, kvh, decode_q, group,
                   /*qpos0=*/q_starts[b], /*kv_len=*/min(kv_lens[b], max_tok),
                   s * split_keys, (s + 1) * split_keys, scale,
                   TileOut{nullptr, part_o + s * nd * H * kD,
                           part_ml + s * nd * H * 2, (long long)b * decode_q,
                           H});
  } else {  // a chunk tile
    const int offset = bx * positions;
    const int first = num_decode * decode_q + offset;
    const PagedRows rows{tables + (long long)num_decode * W, page_size,
                         lane_width};
    attend_mma<kD>(q, ((long long)first * H + kvh * group) * kD, H * kD, kv,
                   rows, kvh, min(positions, C - offset), group,
                   /*qpos0=*/q_starts[num_decode] + offset,
                   /*kv_len=*/min(kv_lens[num_decode], max_tok), 0, INT_MAX,
                   scale, TileOut{out, nullptr, nullptr, 0, H});
  }
}

// out[pair * D ..] for pair = decode query * H + head, from num_splits
// partials [num_splits, n_pairs, D] and (m, l) [num_splits, n_pairs, 2].
__global__ void __launch_bounds__(kThreads) merge_splits_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    __nv_bfloat16* __restrict__ out, int n_pairs, int num_splits, int D) {
  const int pair = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pair >= n_pairs) return;
  float big = -INFINITY;
  for (int s = 0; s < num_splits; ++s)
    big = fmaxf(big, part_ml[2 * ((long long)s * n_pairs + pair)]);
  constexpr int kPer = kMaxTileDim / 32;
  float acc[kPer] = {};
  float denom = 0.f;
  if (big != -INFINITY) {
    for (int s = 0; s < num_splits; ++s) {
      const long long p = (long long)s * n_pairs + pair;
      const float m = part_ml[2 * p];
      if (m == -INFINITY) continue;  // an empty span: its O is never written
      const float w = exp2f(m - big);
      denom += w * part_ml[2 * p + 1];
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int dd = lane + 32 * c;
        if (dd < D) acc[c] += w * part_o[p * D + dd];
      }
    }
  }
  const float inv = denom > 0.f ? 1.f / denom : 0.f;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int dd = lane + 32 * c;
    if (dd < D) out[(long long)pair * D + dd] = __float2bfloat16(acc[c] * inv);
  }
}

template <typename KVTiles>
int launch_ragged(const void* q, KVTiles kv, const void* tables,
                  const void* kv_lens, const void* q_starts, void* out,
                  void* part_o, void* part_ml, int num_decode, int decode_q,
                  int C, int H, int KV, int D, int page_size, int W,
                  int lane_width, int positions, int num_splits,
                  int split_keys, float scale, void* stream) {
  if (KV < 1 || H % KV) return (int)cudaErrorInvalidValue;
  const int group = H / KV;
  int device = 0, num_sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const long long max_tok = (long long)W * page_size;
  if (C < 1 || num_decode < 0 || decode_q < 1 || W < 1
      || !tile_fits(group, D) || decode_q * group > kTileRows
      || positions != tile_positions(group)
      || split_keys != ragged_split_keys(max_tok, num_decode, KV, num_sms)
      || num_splits != ragged_splits(max_tok, split_keys)
      || (num_decode > 0 && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem_bytes<KVTiles>(D);
  const cudaStream_t st = (cudaStream_t)stream;
  const long long blocks =
      ((long long)num_decode * num_splits + (C + positions - 1) / positions) * KV;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  const int rc = with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    const cudaError_t set = set_smem(ragged_kernel<kD, KVTiles>, smem);
    if (set != cudaSuccess) return (int)set;
    ragged_kernel<kD, KVTiles><<<grid, kTileThreads, smem, st>>>(
        (const __nv_bfloat16*)q, kv, (const int*)tables, (const int*)kv_lens,
        (const int*)q_starts, (__nv_bfloat16*)out, (float*)part_o,
        (float*)part_ml, num_decode, decode_q, C, H, KV, page_size, W,
        lane_width, positions, num_splits, split_keys, scale);
    return (int)cudaGetLastError();
  });
  if (rc != 0 || num_decode == 0) return rc;
  const int n_pairs = num_decode * decode_q * H;
  const int per_block = kThreads / 32;
  merge_splits_kernel<<<(n_pairs + per_block - 1) / per_block, kThreads, 0,
                        st>>>((const float*)part_o, (const float*)part_ml,
                              (__nv_bfloat16*)out, n_pairs, num_splits, D);
  return (int)cudaGetLastError();
}

}  // namespace dtt

extern "C" int dtt_ragged(const void* q, const void* k_pages,
                          const void* v_pages, const void* tables,
                          const void* kv_lens, const void* q_starts, void* out,
                          void* part_o, void* part_ml, int num_decode,
                          int decode_q, int C, int H, int KV, int D,
                          int page_size, int W, int positions, int num_splits,
                          int split_keys, float scale, void* stream) {
  const dtt::Bf16Tiles kv{(const __nv_bfloat16*)k_pages,
                          (const __nv_bfloat16*)v_pages};
  return dtt::launch_ragged(q, kv, tables, kv_lens, q_starts, out, part_o,
                            part_ml, num_decode, decode_q, C, H, KV, D,
                            page_size, W, KV * D, positions, num_splits,
                            split_keys, scale, stream);
}

extern "C" int dtt_ragged_int8(const void* q, const void* k_pages,
                               const void* v_pages, const void* tables,
                               const void* kv_lens, const void* q_starts,
                               void* out, void* part_o, void* part_ml,
                               int num_decode, int decode_q, int C, int H,
                               int KV, int D, int page_size, int W,
                               int lane_width, int positions, int num_splits,
                               int split_keys, float scale, void* stream) {
  if (lane_width % 16 || lane_width < KV * (D + 2))
    return (int)cudaErrorInvalidValue;
  const dtt::Int8Tiles kv{(const int8_t*)k_pages, (const int8_t*)v_pages,
                          KV * D};
  return dtt::launch_ragged(q, kv, tables, kv_lens, q_starts, out, part_o,
                            part_ml, num_decode, decode_q, C, H, KV, D,
                            page_size, W, lane_width, positions, num_splits,
                            split_keys, scale, stream);
}

// Keys per split of a ragged decode row whose table holds W pages of
// page_size, for num_decode rows of KV heads on a card of num_sms SMs.
extern "C" long long dtt_ragged_split_keys(int W, int page_size,
                                           int num_decode, int KV,
                                           int num_sms) {
  return dtt::ragged_split_keys((long long)W * page_size, num_decode, KV,
                                num_sms);
}
