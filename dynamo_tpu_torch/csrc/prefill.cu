// Causal prefill attention over padded prompts for Hopper (sm_90a).
//
// Replaces the TPU kernel `_prefill_kernel` (dynamo_tpu/ops/pallas_attention.py,
// wrapper `prefill_attention`, vmapped over lanes by llama.prefill_batch):
// q [N, S, H, D] attends k/v [N, S, KV, D] of its own lane with the mask
// ki <= qi and ki < seq_len; a lane with seq_len 0 gives zeros. Rows past
// seq_len (the bucket padding) are computed like the TPU kernel computes them
// (they see every key below seq_len) and are discarded by the caller.
//
// Bound on the H100: for the prompts this slice prefills (<= 256 tokens per
// full prefill) the kernel reads ~2 * S * KV * D * 2 bytes of K/V and does
// 2 * S^2 * H * D FLOPs (causal half), so it sits near the ridge; a long
// prompt is FLOP-bound and wants the tensor cores.
//
// Design: chunk.cu's blocks over a dense K/V block instead of a page list.
// One block per (query tile of 64 / group positions, KV head, lane) runs
// the tensor-core tile attend_mma (attention_common.cuh): 64 rows =
// positions x the GQA group of one KV head, so a K/V tile feeds the whole
// group; S and P V on mma.sync with f32 accumulation, K/V tiles of 64 keys
// through the cp.async ring (two stages at head_dim 256, three below),
// walked only up to min(diagonal, seq_len). Token t's K/V row of lane n
// starts at (n * S + t) * KV * D (DenseRows), 16-byte aligned for every S
// since D is a multiple of 8. A lane at seq_len = S is chunk.cu's chunk at
// start 0 under the same tiling, and bit-identical to it.
#include <limits.h>

#include "attention_common.cuh"

namespace dtt {

template <int kD>
__global__ void __launch_bounds__(tile_threads<kD>()) prefill_kernel(
    const __nv_bfloat16* __restrict__ q,  // [N, S, H, kD]
    const __nv_bfloat16* __restrict__ k,  // [N, S, KV, kD]
    const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ seq_lens,     // [N]
    __nv_bfloat16* __restrict__ out,      // [N, S, H, kD]
    int S, int H, int KV, int positions, float scale) {
  const int i0 = blockIdx.x * positions, kvh = blockIdx.y, n = blockIdx.z;
  const int group = H / KV;
  const DenseRows rows{(long long)n * S * KV * kD, KV * kD};
  attend<kD>(q, (((long long)n * S + i0) * H + kvh * group) * kD, H * kD,
                 Bf16Tiles{k, v}, rows, kvh, min(positions, S - i0), group,
                 /*qpos0=*/i0, /*kv_len=*/min(seq_lens[n], S),
                 /*key_lo=*/0, /*key_hi=*/INT_MAX, scale,
                 TileOut{out, nullptr, nullptr, 0, H});
}

}  // namespace dtt

extern "C" int dtt_prefill(const void* q, const void* k, const void* v,
                           const void* seq_lens, void* out, int N, int S,
                           int H, int KV, int D, int positions, float scale,
                           void* stream) {
  using namespace dtt;
  if (N < 1 || S < 1 || KV < 1 || H % KV || !tile_fits(H / KV, D)
      || positions != tile_positions(H / KV) || N > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + positions - 1) / positions, KV, N);
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    const size_t smem = tile_smem_bytes<Bf16Tiles, kD>();
    const cudaError_t err = set_smem(prefill_kernel<kD>, smem);
    if (err != cudaSuccess) return (int)err;
    prefill_kernel<kD><<<grid, tile_threads<kD>(), smem,
                         (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const int*)seq_lens, (__nv_bfloat16*)out, S,
        H, KV, positions, scale);
    return (int)cudaGetLastError();
  });
}
