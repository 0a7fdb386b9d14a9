// Causal prefill attention over padded prompts for Hopper (sm_90a).
//
// Replaces the TPU kernel `_prefill_kernel` (dynamo_tpu/ops/pallas_attention.py,
// wrapper `prefill_attention`, vmapped over lanes by llama.prefill_batch):
// q [N, S, H, D] attends k/v [N, S, KV, D] of its own lane with the mask
// ki <= qi and ki < seq_len; a lane with seq_len 0 gives zeros. Rows past
// seq_len (the bucket padding) are computed like the TPU kernel computes them
// and are discarded by the caller.
//
// Bound on the H100: for the prompts this slice prefills (<= 256 tokens per
// full prefill) the kernel reads ~2 * S * KV * D * 2 bytes of K/V and does
// 2 * S^2 * H * D FLOPs (causal half), so it sits near the ridge; a long
// prompt is FLOP-bound and wants the tensor cores.
//
// Design: one block per (query tile of up to 16 positions, KV head, lane).
// The tile's rows are its positions x the group = H/KV query heads of the
// KV head (at most 4096 / D rows, 8 positions x 4 heads for Llama-3-8B), so
// each K/V tile is read once for the whole GQA group. The block walks key
// tiles only up to min(diagonal, seq_len) with the shared f32 online softmax
// (attention_common.cuh). This first version runs the products on CUDA
// cores; wgmma with 64-row tiles and TMA-fed K/V is later work.
#include "attention_common.cuh"

namespace dtt {

__global__ void __launch_bounds__(kThreads) prefill_kernel(
    const __nv_bfloat16* __restrict__ q,  // [N, S, H, D]
    const __nv_bfloat16* __restrict__ k,  // [N, S, KV, D]
    const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ seq_lens,     // [N]
    __nv_bfloat16* __restrict__ out,      // [N, S, H, D]
    int S, int H, int KV, int D, int q_tile, float scale) {
  const int i0 = blockIdx.x * q_tile, kvh = blockIdx.y, lane_n = blockIdx.z;
  const int group = H / KV;
  const int nq = min(q_tile, S - i0);
  const DenseRows rows{(long long)lane_n * S * KV * D, KV * D};
  attend(q, (((long long)lane_n * S + i0) * H + kvh * group) * D, H * D,
         Bf16Rows{k, v}, rows, kvh, out, nq, group, D, /*qpos0=*/i0,
         /*kv_len=*/seq_lens[lane_n], scale);
}

}  // namespace dtt

extern "C" int dtt_prefill(const void* q, const void* k, const void* v,
                           const void* seq_lens, void* out, int N, int S,
                           int H, int KV, int D, int q_tile, float scale,
                           void* stream) {
  using namespace dtt;
  if (!fits_accumulators(q_tile * (H / KV), D)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(q_tile * (H / KV), D);
  cudaError_t err = set_smem(prefill_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + q_tile - 1) / q_tile, KV, N);
  prefill_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)seq_lens, (__nv_bfloat16*)out, S, H,
      KV, D, q_tile, scale);
  return (int)cudaGetLastError();
}
