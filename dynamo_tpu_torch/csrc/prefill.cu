// Causal prefill attention over padded prompts for Hopper (sm_90a).
//
// Replaces the TPU kernel `_prefill_kernel` (dynamo_tpu/ops/pallas_attention.py,
// wrapper `prefill_attention`, vmapped over lanes by llama.prefill_batch):
// q [N, S, H, D] attends k/v [N, S, KV, D] of its own lane with the mask
// ki <= qi and ki < seq_len; a lane with seq_len 0 gives zeros. Rows past
// seq_len (the bucket padding) are computed like the TPU kernel computes them
// (they see every key below seq_len) and are discarded by the caller.
//
// Bound on the H100: operations for a long prompt (Phi-3's two lanes of
// 3800 and 2600 tokens in a 4096 bucket under its 2047-key window do 140
// GFLOP of S and P V on ~50 MB of K/V), bytes for the short buckets (four
// 256-token lanes of the 8B: 19 MB for 1.2 GFLOP).
//
// Design below head_dim 640: the pair tile (attention_common.cuh,
// pair_span_block), chunk.cu's kernel over a dense K/V block instead of a
// page list. A block holds two query tiles of 64 / group positions (a
// pair: two consumer warpgroups, 64 rows each = positions x the GQA group
// of one KV head, so each K/V tile feeds 128 rows) and a producer
// warpgroup that copies the K/V tiles of the pair's keys through a ring of
// stages (cp.async, mbarrier full/empty pairs); S and P V run on wgmma
// (P in two bf16 parts), the online softmax in registers. Token t's K/V
// row of lane n starts at (n * S + t) * KV * D (DenseRows), 16-byte
// aligned for every S since D is a multiple of 8. Each pair's keys (the
// union of its tiles' windows, up to min(last position + 1, seq_len)) are
// walked by one block (kPairSpans; a measurement may cut them into spans
// merged in a cluster, as chunk.cu). Pairs run from the bucket's end, the
// longest walks first. A lane at seq_len S is chunk.cu's chunk of S
// queries at start 0, block for block, and a row's walk is its own keys'
// tiles in key order in either, so a prompt's rows take the same bits
// whole and in chunks.
//
// At head_dim 96 (Phi-3: 32 KV heads of group 1, a 2047-key window) the
// tile's operands are three 32-lane panels, S is m64n64k16 and P V
// m64n96k16, and a 3800-token lane's pairs each walk about 2047 + 128 keys.
//
// At head_dim 640 (MLA's latent row: DeepSeek-V2's 16 query heads on one
// KV head, and K and V the same latent rows) the prefill runs
// prefill_latent_kernel below. Bound: bytes at the served shapes. q is
// read and the output written in full, 16 heads x 640 lanes a token (40 KB
// a token, padding rows included), against one 1280-byte latent row of
// K/V a token and 4 * H * D FLOPs per visible (query, key) pair: a
// 256-token prompt moves 10.5 MB (3.1 µs at 3.35 TB/s) for 1.35 GFLOP
// (1.4 µs at 989 TFLOP/s). At group 16 a 64-row query tile holds 4
// positions, so a 256-token prompt is 64 query tiles, and under the
// causal mask tile i walks 4 (i + 1) keys: one block per tile left half
// of the 132 SMs idle and the last tile walking all 256 keys alone. So
// the kernel is chunk.cu's latent tile over a dense block:
// - each query tile's causal horizon, min(i0 + nq, seq_len) with seq_len
//   read on the card, is cut into latent_prefill_spans equal spans (a pure
//   function of N, S, the group, KV and the SM count: the largest power
//   of two whose blocks run in one wave, so 2 for a one-lane 128 or 256
//   bucket, 1 for four 256-token lanes; at N = 1 chunk_spans(S, 0)), one
//   block each (a query tile of one span writes its rows directly); the
//   spans of a query tile are one thread-block cluster that merges their
//   partials in distributed shared memory, in span order (equal bits run
//   to run, no scratch in device memory); a span past the horizon walks
//   nothing and merges as empty, so a lane at seq_len 0 writes zeros;
// - each block runs the latent walk (32-key tiles, S = Q K^T on wgmma
//   over all 640 lanes, P V on wgmma over each warpgroup's 320 lanes).
// K and V are the same tensor on the served path (the model passes its
// latent rows as both). Copying each 32-key tile once for both, with one
// barrier a tile, ran 4% faster than reading them as two tensors at
// phase 3's shape (PERF.md): under the 5% that would pay for a second
// walk, so K and V are read as two tensors.
// A lane at seq_len = S of a one-lane launch runs the blocks of chunk.cu's
// chunk of S queries at start 0, and is bit-identical to it.
//
// Below head_dim 640 a launch also takes one layer's sliding window and
// tanh logit cap (Gemma-2/3: `window`, `logit_cap`, 0 for none; ScoreMods in
// attention_common.cuh): a pair's keys start at the key tile of its first
// query's window, and a query tile walks only the key tiles that meet its
// own rows' windows, so a windowed prompt of S tokens reads ~window keys
// per pair, not up to S. The latent row refuses both.
#include "attention_common.cuh"

namespace dtt {

// Block (span, pair, lane x KV head) of the prefill below head_dim 640:
// pairs of query tiles run from the prompt's end (blockIdx.y 0 is the last
// pair; with tiles = 1, blocks of one query tile: pair_query_tiles), lane
// n = blockIdx.z / KV, KV head blockIdx.z % KV, over the lane's dense K/V
// with kv_len = min(seq_lens[n], S) (pair_span_block, `clocks` as there):
// chunk_pair_kernel's blocks at start 0.
template <int kD>
__global__ void __launch_bounds__(kPairThreads, 1) prefill_pair_kernel(
    const __nv_bfloat16* __restrict__ q,  // [N, S, H, kD]
    const __nv_bfloat16* __restrict__ k,  // [N, S, KV, kD]
    const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ seq_lens,     // [N]
    __nv_bfloat16* __restrict__ out,      // [N, S, H, kD]
    int S, int H, int KV, int positions, int tiles, float scale,
    ScoreMods mods, unsigned long long* __restrict__ clocks) {
  extern __shared__ __align__(16) char pair_smem[];
  const int i0 = (gridDim.y - 1 - blockIdx.y) * tiles * positions;
  const int n = blockIdx.z / KV, kvh = blockIdx.z - n * KV;
  const int group = H / KV;
  const int nq0 = min(positions, S - i0);
  const int nq1 =
      tiles == 2 ? max(0, min(positions, S - i0 - positions)) : 0;
  const PairRows pr{(((long long)n * S + i0) * H + kvh * group) * kD, H * kD,
                    positions, group, {nq0 * group, nq1 * group}};
  pair_span_block<kD>(pair_smem, q, Bf16Tiles{k, v},
                      DenseRows{(long long)n * S * KV * kD, KV * kD}, kvh, nq0,
                      nq1, pr, /*qpos0=*/i0, min(seq_lens[n], S), scale, mods,
                      out, clocks);
}

// Block (span, query tile, lane x KV head) of the latent prefill: query
// tile blockIdx.y of lane n = blockIdx.z / KV, KV head blockIdx.z % KV,
// horizon min(i0 + nq, seq_lens[n]) cut into gridDim.x spans
// (latent_span_block, `clocks` as there).
__global__ void __launch_bounds__(kChunkThreads, 1) prefill_latent_kernel(
    const __nv_bfloat16* __restrict__ q,  // [N, S, H, 640]
    const __nv_bfloat16* __restrict__ k,  // [N, S, KV, 640]
    const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ seq_lens,     // [N]
    __nv_bfloat16* __restrict__ out,      // [N, S, H, 640]
    int S, int H, int KV, int positions, float scale,
    unsigned long long* __restrict__ clocks) {
  constexpr int kD = kLatentDim;
  extern __shared__ __align__(16) char latent_smem[];
  const int i0 = blockIdx.y * positions;
  const int n = blockIdx.z / KV, kvh = blockIdx.z - n * KV;
  const int group = H / KV, nq = min(positions, S - i0);
  const int horizon = max(0, min(i0 + nq, min(seq_lens[n], S)));
  latent_span_block(
      latent_smem, q, (((long long)n * S + i0) * H + kvh * group) * kD,
      H * kD, Bf16Tiles{k, v}, DenseRows{(long long)n * S * KV * kD, KV * kD},
      kvh, nq * group, group, /*qpos0=*/i0, horizon, scale, out, clocks);
}

// prefill_latent_kernel in `spans` spans a query tile (the wrapper's plan
// is latent_prefill_spans, also dtt_latent_prefill_spans; a measurement
// may ask for any other count from 1 to kMaxChunkSpans: all are exact).
int launch_prefill_latent(const void* q, const void* k, const void* v,
                          const void* seq_lens, void* out, int N, int S,
                          int H, int KV, int positions, int spans,
                          float scale, void* clocks, cudaStream_t stream) {
  const int tiles = (S + positions - 1) / positions;
  if (spans < 1 || spans > kMaxChunkSpans || tiles > 65535
      || (long long)N * KV > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = ChunkSmem<Bf16Tiles>::bytes;
  cudaError_t err = set_smem(prefill_latent_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  LatentLaunch launch(dim3(spans, tiles, N * KV), smem, stream);
  err = cudaLaunchKernelEx(&launch.cfg, prefill_latent_kernel,
                           (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                           (const __nv_bfloat16*)v, (const int*)seq_lens,
                           (__nv_bfloat16*)out, S, H, KV, positions, scale,
                           (unsigned long long*)clocks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace dtt

extern "C" int dtt_prefill(const void* q, const void* k, const void* v,
                           const void* seq_lens, void* out, int N, int S,
                           int H, int KV, int D, int positions, int spans,
                           float scale, int window, float logit_cap,
                           void* clocks, void* stream) {
  using namespace dtt;
  if (N < 1 || S < 1 || KV < 1 || H % KV || !tile_fits(H / KV, D)
      || positions != tile_positions(H / KV) || N > 65535 || KV > 65535
      || window < 0 || !(logit_cap >= 0.f)
      || (D == kLatentDim && (window || logit_cap > 0.f)))
    return (int)cudaErrorInvalidValue;
  if (!pair_tile_takes(D))
    return launch_prefill_latent(q, k, v, seq_lens, out, N, S, H, KV,
                                 positions, spans, scale, clocks,
                                 (cudaStream_t)stream);
  int num_sms = 0;
  const int rc = num_sms_of_device(&num_sms);
  if (rc != 0) return rc;
  const int tiles =
      pair_query_tiles(pair_count(S, positions) * N * KV, num_sms);
  const long long blocks_y = pair_blocks_y(S, positions, tiles);
  if (spans < 1 || spans > pair_max_spans(S, window, positions, D)
      || blocks_y > 65535 || (long long)N * KV > 65535)
    return (int)cudaErrorInvalidValue;
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    constexpr size_t smem = PairSmem<Bf16Tiles, kD>::bytes;
    cudaError_t err = set_smem(prefill_pair_kernel<kD>, smem);
    if (err != cudaSuccess) return (int)err;
    LatentLaunch launch(dim3(spans, (unsigned)blocks_y, N * KV), smem,
                        (cudaStream_t)stream, kPairThreads);
    err = cudaLaunchKernelEx(&launch.cfg, prefill_pair_kernel<kD>,
                             (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                             (const __nv_bfloat16*)v, (const int*)seq_lens,
                             (__nv_bfloat16*)out, S, H, KV, positions, tiles,
                             scale, ScoreMods{window, logit_cap},
                             (unsigned long long*)clocks);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  });
}

// Key spans per query tile of prefill.cu for N lanes of S positions, GQA
// group, KV heads, on a card of num_sms SMs: latent_prefill_spans
// (prefill_latent_kernel's clusters); 0 where the latent row refuses the
// group.
extern "C" int dtt_latent_prefill_spans(int N, int S, int group, int KV,
                                        int num_sms) {
  if (!dtt::tile_fits(group, dtt::kLatentDim) || N < 1 || S < 1 || KV < 1)
    return 0;
  return dtt::latent_prefill_spans(N, S, dtt::tile_positions(group), KV,
                                   num_sms);
}
