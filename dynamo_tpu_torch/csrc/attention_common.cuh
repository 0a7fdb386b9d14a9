// Shared device code of the port's attention kernels (decode.cu, prefill.cu,
// chunk.cu, ragged.cu).
//
// Every kernel is one call of `attend`: a thread block owns `nq` query
// positions x `group` query heads of ONE KV head (rows r = i * group + g,
// query head kvh * group + g reads KV head kvh, the GQA mapping of the JAX
// package's repeat_kv), and walks that KV head's keys in tiles of kTile
// tokens with an f32 online softmax. The mask is the general one of the TPU
// kernels:
//
//     key tok is visible to query i  <=>  tok <= qpos0 + i  and  tok < kv_len
//
// decode sets qpos0 = ctx - 1, kv_len = ctx; chunked prefill qpos0 =
// start + first query of the block, kv_len = start + C; prefill qpos0 =
// first query of the block, kv_len = seq_len; the ragged kernel reads both
// from its descriptors. The block stops at the causal horizon
// min(qpos0 + nq, kv_len): tokens past it are never read, which is what
// makes a trash-padded page list or a padded prompt free. A row that sees
// no key at all (decode ctx 0, prefill seq_len 0) writes exact zeros, as
// the TPU kernels do.
//
// Two policies feed `attend`: `Rows` says where token tok's K/V row starts
// (PagedRows through a page list, DenseRows in a dense block), and `KVRows`
// how a row is read. Bf16Rows reads a head's D bf16 values (lanes
// [kvh*D, (kvh+1)*D) of a KV*D row) with 16-byte loads; Int8Rows reads the
// packed int8 row [KV*D int8 values | KV bf16 scales | pad] of the
// `kv_cache_dtype="int8"` pools, 16 values per 16-byte load, and the head's
// bf16 scale at byte KV*D + 2*kvh, and dequantizes value * scale in f32
// (exact, as the TPU kernels' _dequant_rows). Either way keys and values
// reach shared memory as f32; q is scaled by 1/sqrt(D) in f32 once. Scores,
// softmax and the PV product run in f32 on CUDA cores: the kernels are
// bounded by the bytes of K/V they read (decode, chunk) and this first
// version makes no use of the tensor cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dtt {

constexpr int kThreads = 128;  // 4 warps
constexpr int kTile = 32;      // keys per tile: one key per lane
constexpr int kMaxAcc = 32;    // f32 accumulators per thread
// rows * D a block may hold in registers: attend() keeps no output past
// it, so every entry point refuses a launch beyond it (fits_accumulators),
// and the Python wrappers read it from dtt_max_rows_times_dim().
constexpr int kMaxRowsTimesDim = kThreads * kMaxAcc;

inline bool fits_accumulators(int rows, int d) {
  return rows > 0 && d > 0 && (long long)rows * d <= kMaxRowsTimesDim;
}

// Offset (in pool elements) of token `tok`'s K/V row in a paged pool
// [P, ps, W].
struct PagedRows {
  const int* pages;  // the sequence's page ids
  int page_size;
  int row_stride;  // the pool's lane width W
  __device__ __forceinline__ long long operator()(int tok) const {
    const int page = __ldg(pages + tok / page_size);
    return ((long long)page * page_size + tok % page_size) * row_stride;
  }
};

// Offset of token `tok`'s K/V row in a dense [S, KV*D] bf16 block.
struct DenseRows {
  long long base;  // offset of token 0
  int row_stride;  // KV*D
  __device__ __forceinline__ long long operator()(int tok) const {
    return base + (long long)tok * row_stride;
  }
};

// K/V rows of bf16 values.
struct Bf16Rows {
  static constexpr int kVec = 8;  // values per 16-byte load
  const __nv_bfloat16* __restrict__ k;
  const __nv_bfloat16* __restrict__ v;
  // chunk c (kVec values) of head kvh's D values in the row at `row`
  __device__ __forceinline__ void load(long long row, int kvh, int d, int c,
                                       float* kd, float* vd) const {
    const long long off = row + (long long)kvh * d + c * kVec;
    const uint4 kr = __ldg(reinterpret_cast<const uint4*>(k + off));
    const uint4 vr = __ldg(reinterpret_cast<const uint4*>(v + off));
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kr);
    const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&vr);
#pragma unroll
    for (int e = 0; e < kVec / 2; ++e) {
      const float2 kf = __bfloat1622float2(k2[e]);
      const float2 vf = __bfloat1622float2(v2[e]);
      kd[2 * e] = kf.x;
      kd[2 * e + 1] = kf.y;
      vd[2 * e] = vf.x;
      vd[2 * e + 1] = vf.y;
    }
  }
};

// Packed int8 K/V rows [KV*D int8 | KV bf16 scales | pad]; the lane width W
// is a multiple of 128, so every row starts 16-byte aligned, and D % 16 == 0
// keeps each head's values so.
struct Int8Rows {
  static constexpr int kVec = 16;
  const int8_t* __restrict__ k;
  const int8_t* __restrict__ v;
  int kvd;  // KV*D: the byte offset of the scales in a row
  __device__ __forceinline__ void load(long long row, int kvh, int d, int c,
                                       float* kd, float* vd) const {
    const long long off = row + (long long)kvh * d + c * kVec;
    const uint4 kr = __ldg(reinterpret_cast<const uint4*>(k + off));
    const uint4 vr = __ldg(reinterpret_cast<const uint4*>(v + off));
    // the scale: a bf16 at an even byte offset, widened to f32 exactly
    const long long sc = row + kvd + 2 * kvh;
    const float ks = __uint_as_float(
        (unsigned)__ldg(reinterpret_cast<const unsigned short*>(k + sc)) << 16);
    const float vs = __uint_as_float(
        (unsigned)__ldg(reinterpret_cast<const unsigned short*>(v + sc)) << 16);
    const int8_t* k8 = reinterpret_cast<const int8_t*>(&kr);
    const int8_t* v8 = reinterpret_cast<const int8_t*>(&vr);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      kd[e] = (float)k8[e] * ks;
      vd[e] = (float)v8[e] * vs;
    }
  }
};

inline size_t smem_bytes(int rows, int d) {
  return sizeof(float) * ((size_t)rows * d           // q
                          + 2 * (size_t)kTile * (d + 1)  // K and V tiles
                          + (size_t)rows * kTile     // scores / probs
                          + 3 * (size_t)rows);       // m, l, alpha
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q element (i, g, dd) is q[q_off + i * q_row_stride + g * d + dd]; the
// output uses the same addressing. kvh is the KV head the block reads.
template <typename KVRows, typename Rows>
__device__ __forceinline__ void attend(
    const __nv_bfloat16* __restrict__ q, long long q_off, int q_row_stride,
    KVRows kv, Rows rows, int kvh, __nv_bfloat16* __restrict__ out, int nq,
    int group, int d, int qpos0, int kv_len, float scale) {
  extern __shared__ float smem[];
  const int n_rows = nq * group;
  const int kv_stride = d + 1;  // +1 float: conflict-free column reads
  float* qs = smem;                       // [n_rows, d]
  float* ks = qs + n_rows * d;            // [kTile, d + 1]
  float* vs = ks + kTile * kv_stride;     // [kTile, d + 1]
  float* ps = vs + kTile * kv_stride;     // [n_rows, kTile]
  float* m_s = ps + n_rows * kTile;       // [n_rows] running max
  float* l_s = m_s + n_rows;              // [n_rows] running denominator
  float* a_s = l_s + n_rows;              // [n_rows] this tile's rescale
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int idx = tid; idx < n_rows * d; idx += kThreads) {
    const int r = idx / d, dd = idx - r * d;
    const int i = r / group, g = r - i * group;
    qs[idx] = __bfloat162float(q[q_off + (long long)i * q_row_stride + g * d + dd]) * scale;
  }
  for (int r = tid; r < n_rows; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;
  __syncthreads();

  const int horizon = min(qpos0 + nq, kv_len);
  const int vecs = d / KVRows::kVec;  // 16-byte chunks of a head's row
  for (int t0 = 0; t0 < horizon; t0 += kTile) {
    const int n = min(kTile, horizon - t0);
    for (int idx = tid; idx < n * vecs; idx += kThreads) {
      const int t = idx / vecs, c = idx - t * vecs;
      kv.load(rows(t0 + t), kvh, d, c, ks + t * kv_stride + c * KVRows::kVec,
              vs + t * kv_stride + c * KVRows::kVec);
    }
    __syncthreads();

    // scores and the online-softmax update: one warp per row, lane = key
    for (int r = warp; r < n_rows; r += kThreads / 32) {
      const int i = r / group;
      const int tok = t0 + lane;
      float s = -INFINITY;
      if (lane < n && tok <= qpos0 + i && tok < kv_len) {
        const float* qr = qs + r * d;
        const float* kr = ks + lane * kv_stride;
        float dot = 0.f;
        for (int dd = 0; dd < d; ++dd) dot = fmaf(qr[dd], kr[dd], dot);
        s = dot;
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      float p = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {  // never exp(-inf - -inf)
        p = (s == -INFINITY) ? 0.f : __expf(s - m_new);
        alpha = __expf(m_old - m_new);  // 0 while the row saw nothing
      }
      const float sum = warp_sum(p);
      ps[r * kTile + lane] = p;
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, thread-owned (row, lane-of-D) outputs
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < n_rows * d) {
        const int r = idx / d, dd = idx - r * d;
        const float* pr = ps + r * kTile;
        float a = acc[j] * a_s[r];
        for (int t = 0; t < n; ++t) a = fmaf(pr[t], vs[t * kv_stride + dd], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int idx = tid + j * kThreads;
    if (idx < n_rows * d) {
      const int r = idx / d, dd = idx - r * d;
      const int i = r / group, g = r - i * group;
      const float l = l_s[r];
      const float o = l > 0.f ? acc[j] / l : 0.f;
      out[q_off + (long long)i * q_row_stride + g * d + dd] = __float2bfloat16(o);
    }
  }
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace dtt
