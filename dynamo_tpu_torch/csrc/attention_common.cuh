// Shared device code of the port's attention kernels (decode.cu, prefill.cu,
// chunk.cu, ragged.cu): `attend_mma`, the tensor-core query tile all four
// run below head_dim 640, its K/V policies, `attend_latent` (prefill.cu's
// tile at head_dim 640), the latent tile's walk `latent_walk` (32-key tiles,
// S and P V on wgmma) run by `chunk_latent_kernel` (chunk.cu and ragged.cu's
// chunk rows at 640: key spans merged in a cluster) and by
// `decode_latent_kernel` (decode.cu and ragged.cu's decode rows at 640: key
// spans merged by `merge_latent_kernel`), and the split decode rows of
// decode.cu and ragged.cu below 640 (`decode_split_block`,
// `merge_splits_kernel`).
//
// A block owns query positions x the `group` = H/KV query heads of ONE KV
// head (rows r = i * group + g, query head kvh * group + g reads KV head
// kvh, the GQA mapping of the JAX package's repeat_kv), so each K/V tile is
// read once for the whole group. The mask is the general one of the TPU
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
// `Rows` says where token tok's K/V row starts: PagedRows through a page
// list (decode, chunk, ragged), DenseRows in a dense block (prefill).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace dtt {

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

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------------
// attend_mma: the tensor-core query tile.
//
// A block owns kTileRows = 64 query rows of ONE KV head, rows r = i * group
// + g (i a position, g the head in the GQA group). Rows past
// nq * group are zero queries whose outputs are not written. The block
// walks its keys [key_lo, hi) with hi = min(qpos0 + nq, kv_len, key_hi) in
// tiles of kKeyTile = 64 keys, with two warpgroups of 4 warps: warp w of
// warpgroup wg owns rows 16 (w % 4) .. + 15 and keys 32 wg .. + 31 of every
// tile, with its own (m, l, O); the halves merge through shared memory at
// the end. A warp that owns none of the real rows skips the math.
//
//   - K/V tiles stream through a ring of stages in shared memory
//     (ring_stages: three, so two tiles are in flight while one is
//     multiplied, or two where three do not fit the block's shared memory:
//     bf16 pools at D = 256), filled with 16-byte cp.async copies through
//     the page list (four threads per key; a key's page id is loaded a tile
//     ahead), and one barrier per tile frees the oldest stage. Keys at or
//     past hi are never addressed (the page list is never read past the
//     horizon, hence never past its width) and are zero-filled in the
//     tile: a zero row keeps the masked products finite (0 * garbage can
//     be NaN).
//   - S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 products with f32
//     accumulation. P is not rounded to bf16: it goes in as two bf16 parts
//     (split_bf16: the rounded P and the rounded remainder), two MMAs per V
//     fragment, so P V keeps P to about 2^-16 as the TPU kernel's f32
//     p . v does (`_flash_update`). With P rounded once, the error of a
//     row grew with the row's RMS, and at the 8B's activations (rows of
//     RMS near 5) small elements fell outside atol 2e-2 of the f32
//     version (tests/test_torch_cuda.py, test_kernels_hold_at_large_values).
//     The fragments come from shared memory through ldmatrix
//     (V transposed by ldmatrix.trans). Tile rows are padded from D to
//     D + 8 bf16 values, which shifts consecutive rows by 16 bytes, so the
//     eight rows of an ldmatrix phase hit disjoint banks for every D % 16.
//     head_dim is a template parameter (with_head_dim: 32, 64, 128 and
//     256, the port's servable presets), so the loops over D are
//     straight-line code the compiler can schedule.
//   - Registers: a thread holds its rows' O accumulator, D / 2 f32 (128 at
//     D = 256). Up to D = 128 it also keeps q's MMA fragments for the whole
//     walk and loads a k16 step's V fragments for all of D before their
//     MMAs; at D = 256 that would be 64 + 64 more registers, so there q's
//     fragments are re-read from shared memory (where q stays) at every k16
//     step of every tile, and V's fragments are loaded just ahead of their
//     own MMAs.
//   - q enters the MMA as the caller gives it (bf16) and the f32 scores are
//     scaled by 1/sqrt(D), in log2 units so that the softmax uses exp2f.
//     The online softmax (m, l) and O stay in registers; each thread holds
//     two rows (lane / 4 and lane / 4 + 8 of its warp's 16) and reduces a
//     row's max and sum over the four lanes that share it.
//   - int8 pools: the raw int8 values and the 16-byte chunk holding the
//     head's bf16 scale are copied as they are, widened to bf16 in shared
//     memory (an int8 value is exact in bf16) once the stage arrives, and
//     the scales are folded in f32: s_t = (q . k_t) * k_scale_t / sqrt(D),
//     and P V takes p_t * v_scale_t (split in two bf16 parts, as P is in
//     the bf16 path) against the integer V; l sums the unscaled p_t. So
//     the TPU's value * scale product is kept exact and no K value is
//     rounded.
//
// Output: the normalized bf16 rows at the q addressing (TileOut::out), or
// (out == nullptr) the unnormalized partial of the key range: O in f32 at
// part_o and (m, l) at part_ml, m in log2 units, for a later merge (the
// split decode rows below). A row that sees no key writes exact zeros, or
// m = -inf, l = 0.
constexpr int kTileRows = 64;     // query rows per block: 4 warps x 16
constexpr int kTileThreads = 256;  // two warpgroups, one per key half
constexpr int kKeyTile = 64;      // keys per K/V tile: 4 pages of 16
constexpr int kHalfKeys = kKeyTile / 2;  // keys of a tile per warpgroup
constexpr int kMaxStages = 3;     // the cp.async ring: two tiles in flight
constexpr int kMaxTileDim = 256;  // largest head_dim
constexpr size_t kMaxBlockSmem = 232448;  // the H100's per-block limit
constexpr int kSplitKeys = 256;   // least keys per split of a decode row
constexpr int kSplitBlocksPerSm = 4;  // most decode blocks per SM, all splits
// MLA's latent row (DeepSeek-V2: 512 + 64 lanes, padded to 640), run by
// the latent tiles below instead of attend_mma
constexpr int kLatentDim = 640;

// The head_dims the tile is compiled for (with_head_dim): those of the
// port's servable presets.
inline bool tile_head_dim(int d) {
  return d == 32 || d == 64 || d == 128 || d == 256 || d == kLatentDim;
}

inline bool tile_fits(int group, int d) {
  return group >= 1 && group <= kTileRows && tile_head_dim(d);
}

// query positions per attend_mma block
inline int tile_positions(int group) { return kTileRows / group; }

// Keys per split of a decode row whose page list holds max_tok keys, with
// num_decode rows x kv heads on num_sms SMs: kSplitKeys, or more where
// kSplitKeys would give the rows more than kSplitBlocksPerSm blocks per SM
// in all, rounded up to whole key tiles. So the decode blocks and the
// partials' scratch stay bounded by the card, not by the table's width.
inline long long decode_split_keys(long long max_tok, int num_decode, int kv,
                                   int num_sms) {
  const long long pairs = std::max(1LL, (long long)num_decode * kv);
  const long long cap =
      std::max(1LL, (long long)kSplitBlocksPerSm * num_sms / pairs);
  const long long n =
      std::min(std::max(1LL, (max_tok + kSplitKeys - 1) / kSplitKeys), cap);
  const long long span = (max_tok + n - 1) / n;
  return std::max((long long)kSplitKeys,
                  (span + kKeyTile - 1) / kKeyTile * kKeyTile);
}

// splits of max_tok keys in spans of split_keys
inline int decode_splits(long long max_tok, long long split_keys) {
  return (int)std::max(1LL, (max_tok + split_keys - 1) / split_keys);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c[16x8 f32] += a[16x16 bf16, row] * b[16x8 bf16, col]
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// two f32 as two bf16 pairs, big + small = (lo, hi) to within 2^-16 of
// each value: big is the pair rounded, small the rounded remainder, so that
// two bf16 MMAs take an f32 operand nearly exactly
__device__ __forceinline__ void split_bf16(float lo, float hi, unsigned& big,
                                           unsigned& small) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  const float2 r = __bfloat1622float2(v);
  big = *reinterpret_cast<const unsigned*>(&v);
  small = pack_bf16(lo - r.x, hi - r.y);
}

// K/V tiles of bf16 pool rows: a stage holds the K tile then the V tile,
// [kKeyTile][d + 8] bf16 each, read by the MMAs where they land.
struct Bf16Tiles {
  static constexpr bool kInt8 = false;
  const __nv_bfloat16* __restrict__ k;
  const __nv_bfloat16* __restrict__ v;
  __host__ __device__ static constexpr size_t stage_bytes(int d) {
    return 2 * (size_t)kKeyTile * (d + 8) * sizeof(__nv_bfloat16);
  }
  __host__ __device__ static constexpr size_t work_bytes(int) { return 0; }
  // this thread's share of key slot t's copies: four threads per key,
  // `part` taking every fourth 16-byte chunk of its K and V rows, so the
  // four threads of a key read 64 contiguous bytes; row < 0 zero-fills.
  template <int kD>
  __device__ __forceinline__ void copy_key(char* stage, int t, int part,
                                           long long row, int kvh) const {
    __nv_bfloat16* kd = reinterpret_cast<__nv_bfloat16*>(stage) + t * (kD + 8);
    __nv_bfloat16* vd = kd + kKeyTile * (kD + 8);
    const long long off = row + (long long)kvh * kD;
#pragma unroll
    for (int c = part; c < kD / 8; c += 4) {
      cp_async16(kd + c * 8, row >= 0 ? k + off + c * 8 : k, row >= 0);
      cp_async16(vd + c * 8, row >= 0 ? v + off + c * 8 : v, row >= 0);
    }
  }
  template <int kD>
  __device__ __forceinline__ void prepare(char*, char*, int, int) const {}
  __device__ __forceinline__ const __nv_bfloat16* ktile(char* stage, char*,
                                                        int) const {
    return reinterpret_cast<const __nv_bfloat16*>(stage);
  }
  __device__ __forceinline__ const __nv_bfloat16* vtile(char* stage, char*,
                                                        int d) const {
    return reinterpret_cast<const __nv_bfloat16*>(stage) + kKeyTile * (d + 8);
  }
  __device__ __forceinline__ const float* scales(char*, int) const {
    return nullptr;
  }
};

// Widens the int8 rows of an arrived stage into bf16 work tiles: kRows
// raw rows [kRows][kD] int8 (the K rows, then the V rows) become
// [kRows][kD + 8] bf16, and each row's 16-byte scale chunk (after the raw
// rows) gives head kvh's scale as f32 at [kRows] after the bf16 rows. An
// int8 value is exact in bf16; kThreads threads share the work.
template <int kD, int kRows, int kThreads>
__device__ __forceinline__ void widen_int8_rows(const char* stage, char* work,
                                                int kvh, int tid) {
  constexpr int n = kD / 16;  // 16-value chunks per row
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(work);
#pragma unroll
  for (int idx = tid; idx < kRows * n; idx += kThreads) {
    const int row = idx / n, c = idx - row * n;
    const uint4 raw = *reinterpret_cast<const uint4*>(stage + row * kD + c * 16);
    const unsigned* w = reinterpret_cast<const unsigned*>(&raw);
    unsigned out[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // x + 128 as a byte u: the float with bits 0x4B0000uu is 2^23 + u,
      // so subtracting 2^23 + 128 gives x exactly (no I2F)
      const unsigned u = w[e] ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | b))
               - 8388736.f;
      out[2 * e] = pack_bf16(f[0], f[1]);
      out[2 * e + 1] = pack_bf16(f[2], f[3]);
    }
    uint4* dst = reinterpret_cast<uint4*>(wt + row * (kD + 8) + c * 16);
    dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
    dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
  }
  float* sc = reinterpret_cast<float*>(wt + kRows * (kD + 8));
  for (int idx = tid; idx < kRows; idx += kThreads) {
    const unsigned short bits = *reinterpret_cast<const unsigned short*>(
        stage + kRows * kD + idx * 16 + 2 * (kvh % 8));
    sc[idx] = __uint_as_float((unsigned)bits << 16);  // bf16 -> f32, exact
  }
}

// K/V tiles of int8 packed rows [KV*D int8 | KV bf16 scales | pad]. A stage
// holds the raw K values [kKeyTile][d], V values, then per key the 16-byte
// chunk of K's and of V's scale lanes that holds head kvh's scale (byte
// KV*D + 16 * (kvh / 8); the lane width is a multiple of 16, so the chunk
// lies inside the row). `prepare` widens an arrived stage into the work
// area: bf16 K and V tiles [kKeyTile][d + 8] and the f32 scales
// [2][kKeyTile].
struct Int8Tiles {
  static constexpr bool kInt8 = true;
  const int8_t* __restrict__ k;
  const int8_t* __restrict__ v;
  int kvd;  // KV*D: the byte offset of the scales in a row
  __host__ __device__ static constexpr size_t stage_bytes(int d) {
    return 2 * (size_t)kKeyTile * d + 2 * (size_t)kKeyTile * 16;
  }
  __host__ __device__ static constexpr size_t work_bytes(int d) {
    return 2 * (size_t)kKeyTile * (d + 8) * sizeof(__nv_bfloat16)
           + 2 * (size_t)kKeyTile * sizeof(float);
  }
  // as Bf16Tiles::copy_key; part 0 also copies K's scale chunk, part 1 V's
  template <int kD>
  __device__ __forceinline__ void copy_key(char* stage, int t, int part,
                                           long long row, int kvh) const {
    char* kd = stage + t * kD;
    char* vd = kd + kKeyTile * kD;
    const long long off = row + (long long)kvh * kD;
#pragma unroll
    for (int c = part; c < kD / 16; c += 4) {
      cp_async16(kd + c * 16, row >= 0 ? k + off + c * 16 : k, row >= 0);
      cp_async16(vd + c * 16, row >= 0 ? v + off + c * 16 : v, row >= 0);
    }
    if (part < 2) {
      const int8_t* src = part ? v : k;
      cp_async16(stage + 2 * kKeyTile * kD + (part * kKeyTile + t) * 16,
                 row >= 0 ? src + row + kvd + 16 * (kvh / 8) : src, row >= 0);
    }
  }
  template <int kD>
  __device__ __forceinline__ void prepare(char* stage, char* work, int kvh,
                                          int tid) const {
    widen_int8_rows<kD, 2 * kKeyTile, kTileThreads>(stage, work, kvh, tid);
  }
  __device__ __forceinline__ const __nv_bfloat16* ktile(char*, char* work,
                                                        int) const {
    return reinterpret_cast<const __nv_bfloat16*>(work);
  }
  __device__ __forceinline__ const __nv_bfloat16* vtile(char*, char* work,
                                                        int d) const {
    return reinterpret_cast<const __nv_bfloat16*>(work) + kKeyTile * (d + 8);
  }
  // K scales [kKeyTile], then V scales [kKeyTile]
  __device__ __forceinline__ const float* scales(char* work, int d) const {
    return reinterpret_cast<const float*>(
        reinterpret_cast<const __nv_bfloat16*>(work) + 2 * kKeyTile * (d + 8));
  }
};

// shared memory of an attend_mma block with `stages` ring stages: q's
// tile, the ring, the int8 work area
template <typename KVTiles>
__host__ __device__ constexpr size_t tile_smem_with(int d, int stages) {
  return (size_t)kTileRows * (d + 8) * sizeof(__nv_bfloat16)
         + stages * KVTiles::stage_bytes(d) + KVTiles::work_bytes(d);
}

// Stages of the K/V ring at head_dim kD: kMaxStages where the block's
// shared memory holds them, else two (bf16 pools at D = 256: 33,792 bytes
// of q and 3 x 67,584 of K/V would pass 232,448; two stages take 168,960,
// and int8 pools keep three in 206,336).
template <typename KVTiles, int kD>
__host__ __device__ constexpr int ring_stages() {
  return tile_smem_with<KVTiles>(kD, kMaxStages) <= kMaxBlockSmem
             ? kMaxStages : 2;
}

// The latent tile (attend_latent): 16 warps, K/V tiles of 16 keys, three
// ring stages, and the four lane quarters' score partials in f32.
constexpr int kLatentThreads = 512;
constexpr int kLatentKeys = 16;
constexpr int kLatentStages = 3;
constexpr int kLatentQuarter = kLatentDim / 4;  // lanes of a warp's share
constexpr int kLatentSld = kLatentKeys + 4;  // padded row of the partials

template <typename KVTiles>
__host__ __device__ constexpr size_t latent_stage_bytes() {
  return KVTiles::kInt8
             ? 2 * (size_t)kLatentKeys * kLatentDim + 2 * kLatentKeys * 16
             : 2 * (size_t)kLatentKeys * (kLatentDim + 8)
                   * sizeof(__nv_bfloat16);
}

template <typename KVTiles>
__host__ __device__ constexpr size_t latent_work_bytes() {
  return KVTiles::kInt8
             ? 2 * (size_t)kLatentKeys * (kLatentDim + 8)
                       * sizeof(__nv_bfloat16)
                   + 2 * kLatentKeys * sizeof(float)
             : 0;
}

// q's tile, the ring, the int8 work area, the score partials: 227,840
// bytes for bf16 pools, 208,000 for int8 ones
template <typename KVTiles>
__host__ __device__ constexpr size_t latent_smem_bytes() {
  return (size_t)kTileRows * (kLatentDim + 8) * sizeof(__nv_bfloat16)
         + kLatentStages * latent_stage_bytes<KVTiles>()
         + latent_work_bytes<KVTiles>()
         + 4 * (size_t)kTileRows * kLatentSld * sizeof(float);
}

// threads of a block of the tile at head_dim kD
template <int kD>
__host__ __device__ constexpr int tile_threads() {
  return kD == kLatentDim ? kLatentThreads : kTileThreads;
}

template <typename KVTiles, int kD>
inline size_t tile_smem_bytes() {
  if constexpr (kD == kLatentDim) {
    constexpr size_t bytes = latent_smem_bytes<KVTiles>();
    static_assert(bytes <= kMaxBlockSmem, "attend_latent's shared memory");
    return bytes;
  } else {
    constexpr size_t bytes =
        tile_smem_with<KVTiles>(kD, ring_stages<KVTiles, kD>());
    static_assert(bytes <= kMaxBlockSmem, "attend_mma's shared memory");
    return bytes;
  }
}

// Runs fn(std::integral_constant<int, D>{}) for the head_dim d, one of
// tile_head_dim's: the tile is compiled for each, so its loops over D are
// straight-line code. Refuses any other d.
template <typename Fn>
inline int with_head_dim(int d, Fn&& fn) {
  switch (d) {
    case 32: return fn(std::integral_constant<int, 32>{});
    case 64: return fn(std::integral_constant<int, 64>{});
    case 128: return fn(std::integral_constant<int, 128>{});
    case 256: return fn(std::integral_constant<int, 256>{});
    case kLatentDim: return fn(std::integral_constant<int, kLatentDim>{});
  }
  return (int)cudaErrorInvalidValue;
}

// Where attend_mma writes: bf16 rows at the q addressing (out), or, with
// out == nullptr, the partial (O, m, l) of query part_q0 + i, head h at
// part_o[((part_q0 + i) * heads + h) * d ..] and part_ml[.. * 2 + {0, 1}].
struct TileOut {
  __nv_bfloat16* out;
  float* part_o;
  float* part_ml;
  long long part_q0;
  int heads;
};

// q element (i, g, dd) is q[q_off + i * q_row_stride + g * kD + dd]; kvh is
// the KV head the block reads; queries i = 0 .. nq - 1 sit at qpos0 + i and
// see key tok iff tok <= qpos0 + i, tok < kv_len and key_lo <= tok < key_hi.
// Block of kTileThreads: warp w of warpgroup wg = w / 4 owns rows
// 16 (w % 4) .. + 15 and keys wg * 32 .. + 31 of every tile; the two
// warpgroups' (O, m, l) merge through shared memory at the end.
template <int kD, typename KVTiles, typename Rows>
__device__ __forceinline__ void attend_mma(
    const __nv_bfloat16* __restrict__ q, long long q_off, int q_row_stride,
    KVTiles kv, Rows rows, int kvh, int nq, int group, int qpos0, int kv_len,
    int key_lo, int key_hi, float scale, TileOut dst) {
  static_assert(kD % 16 == 0 && kD <= kMaxTileDim, "head_dim");
  constexpr int ld = kD + 8;  // padded tile row, in bf16 values
  constexpr int kSteps = kD / 16;  // k16 steps of Q K^T, n16 blocks of P V
  constexpr int kStages = ring_stages<KVTiles, kD>();
  // q's and V's fragments held for all of D (see Registers above)
  constexpr bool kWide = kD <= 128;
  // the halves' merge at the end reuses the ring
  static_assert(kTileRows * ((kD + 4) + 2) * sizeof(float)
                    <= kStages * KVTiles::stage_bytes(kD),
                "the merge area must fit the ring");
  extern __shared__ __align__(16) char tile_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wrow = (warp & 3) * 16;  // key half, first row
  const int quad = lane >> 2, pair = (lane & 3) * 2;  // fragment row, column
  const int n_rows = nq * group;
  const int lo = key_lo;
  const int hi = min(min(qpos0 + nq, kv_len), key_hi);

  if (lo >= hi) {  // no key in range: zeros, or an empty partial
    for (int idx = tid; idx < n_rows * kD; idx += kTileThreads) {
      const int r = idx / kD, dd = idx - r * kD, i = r / group, g = r - i * group;
      if (dst.out) {
        dst.out[q_off + (long long)i * q_row_stride + g * kD + dd] =
            __float2bfloat16(0.f);
      } else if (dd == 0) {
        const long long p = (dst.part_q0 + i) * dst.heads + kvh * group + g;
        dst.part_ml[2 * p] = -INFINITY;
        dst.part_ml[2 * p + 1] = 0.f;
      }
    }
    return;
  }

  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tile_smem);  // [64][ld]
  char* ring = tile_smem + (size_t)kTileRows * ld * sizeof(__nv_bfloat16);
  char* work = ring + kStages * KVTiles::stage_bytes(kD);
  const int n_tiles = (hi - lo + kKeyTile - 1) / kKeyTile;

  // Copies: four threads per key slot of every tile. A key's row offset
  // (one page-id load) is fetched a tile ahead, so the load's latency
  // hides under the current tile's math; -1 marks a key at or past hi.
  const int slot = tid >> 2, part = tid & 3;
  auto row_of = [&](int t) -> long long {
    const int tok = lo + t * kKeyTile + slot;
    return tok < hi ? rows(tok) : -1;
  };
  auto fetch = [&](int t, long long row) {
    kv.template copy_key<kD>(ring + (t % kStages) * KVTiles::stage_bytes(kD),
                             slot, part, row, kvh);
  };

  // q rows (zero rows past n_rows) join the first tile's group
  for (int idx = tid; idx < kTileRows * (kD / 8); idx += kTileThreads) {
    const int r = idx / (kD / 8), c = idx - r * (kD / 8);
    const int i = r / group, g = r - i * group;
    const bool valid = r < n_rows;
    const __nv_bfloat16* src =
        valid ? q + q_off + (long long)i * q_row_stride + g * kD + c * 8 : q;
    cp_async16(qs + r * ld + c * 8, src, valid);
  }
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) fetch(t, row_of(t));
    cp_async_commit();
  }
  long long next_row = kStages - 1 < n_tiles ? row_of(kStages - 1) : -1;

  const bool active = wrow < n_rows;
  // positions of this thread's two rows (a padding row's is past the range)
  int qlim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qlim[h] = qpos0 + (wrow + quad + 8 * h) / group;
  const float sl2 = scale * 1.4426950408889634f;  // 1/sqrt(D) in log2 units
  unsigned qf[kWide ? kSteps : 1][4];
  float o[kD / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t (and q) have landed
    // every warp is past tile t - 1: its stage, and the int8 work area,
    // are free again
    __syncthreads();
    const int tn = t + kStages - 1;
    if (tn < n_tiles) {
      fetch(tn, next_row);
      if (tn + 1 < n_tiles) next_row = row_of(tn + 1);
    }
    cp_async_commit();
    char* stage = ring + (t % kStages) * KVTiles::stage_bytes(kD);
    if (KVTiles::kInt8) {
      kv.template prepare<kD>(stage, work, kvh, tid);
      __syncthreads();
    }
    const int k0 = lo + t * kKeyTile + wg * kHalfKeys;  // this warp's keys
    if (active && k0 < hi) {
      if constexpr (kWide) {
        if (t == 0) {
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk)
            ldsm_x4(qf[kk], qs + (wrow + (lane & 15)) * ld + kk * 16
                                + ((lane >> 4) << 3));
        }
      }
      const __nv_bfloat16* kt = kv.ktile(stage, work, kD) + wg * kHalfKeys * ld;
      const __nv_bfloat16* vt = kv.vtile(stage, work, kD) + wg * kHalfKeys * ld;
      const float* ksc = kv.scales(work, kD) + wg * kHalfKeys;
      const float* vsc = ksc + kKeyTile;

      // S = Q K^T over this warp's 32 keys: per k16 step, the 4 key blocks
      // of 8 as independent accumulators (two per ldmatrix.x4)
      float s[kHalfKeys / 8][4];
#pragma unroll
      for (int j = 0; j < kHalfKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const unsigned* a = qf[kWide ? kk : 0];
        if constexpr (!kWide)
          ldsm_x4(qf[0], qs + (wrow + (lane & 15)) * ld + kk * 16
                             + ((lane >> 4) << 3));
        unsigned b[kHalfKeys / 16][4];
#pragma unroll
        for (int nb = 0; nb < kHalfKeys / 16; ++nb)
          ldsm_x4(b[nb], kt + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld
                             + kk * 16 + (((lane >> 3) & 1) << 3));
#pragma unroll
        for (int nb = 0; nb < kHalfKeys / 16; ++nb) {
          mma_bf16(s[2 * nb], a, b[nb][0], b[nb][1]);
          mma_bf16(s[2 * nb + 1], a, b[nb][2], b[nb][3]);
        }
      }

      // scale, mask, online softmax; s[j][2h + e] is row quad + 8h, key
      // k0 + j * 8 + pair + e
      const bool edge = k0 + kHalfKeys > hi || k0 + kHalfKeys - 1 > qpos0;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kHalfKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = j * 8 + pair + e, tok = k0 + key;
          const float f = KVTiles::kInt8 ? sl2 * ksc[key] : sl2;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x = s[j][2 * h + e] * f;
            if (edge && !(tok < hi && tok <= qlim[h])) x = -INFINITY;
            s[j][2 * h + e] = x;
            mx[h] = fmaxf(mx[h], x);
          }
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        // never exp(-inf - -inf): a row that has seen nothing keeps 0s
        const float base = m_new == -INFINITY ? 0.f : m_new;
        alpha[h] = exp2f(m[h] - base);  // 0 while the row saw nothing
        m[h] = m_new;
        l[h] *= alpha[h];
#pragma unroll
        for (int j = 0; j < kHalfKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(s[j][2 * h + e] - base);
            s[j][2 * h + e] = p;
            l[h] += p;
          }
      }
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }

      // O += P V: P from the score registers (the m16n8 accumulator layout
      // of two key blocks is the A layout of one k16 step), in two bf16
      // parts, each multiplied into O
#pragma unroll
      for (int kk = 0; kk < kHalfKeys / 16; ++kk) {
        float p[2][4];
#pragma unroll
        for (int hb = 0; hb < 2; ++hb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float vs = KVTiles::kInt8
                ? vsc[(2 * kk + hb) * 8 + pair + (e & 1)] : 1.f;
            p[hb][e] = s[2 * kk + hb][e] * vs;
          }
        unsigned a[4], a_lo[4];
        split_bf16(p[0][0], p[0][1], a[0], a_lo[0]);
        split_bf16(p[0][2], p[0][3], a[1], a_lo[1]);
        split_bf16(p[1][0], p[1][1], a[2], a_lo[2]);
        split_bf16(p[1][2], p[1][3], a[3], a_lo[3]);
        const __nv_bfloat16* vrow = vt + (kk * 16 + (lane & 7)
                                          + (((lane >> 3) & 1) << 3)) * ld
                                    + ((lane >> 4) << 3);
        if constexpr (kWide) {
          unsigned b[kSteps][4];
#pragma unroll
          for (int db = 0; db < kSteps; ++db)
            ldsm_x4_trans(b[db], vrow + db * 16);
#pragma unroll
          for (int db = 0; db < kSteps; ++db) {
            mma_bf16(o[2 * db], a, b[db][0], b[db][1]);
            mma_bf16(o[2 * db + 1], a, b[db][2], b[db][3]);
            mma_bf16(o[2 * db], a_lo, b[db][0], b[db][1]);
            mma_bf16(o[2 * db + 1], a_lo, b[db][2], b[db][3]);
          }
        } else {
#pragma unroll
          for (int db = 0; db < kSteps; ++db) {
            unsigned b[4];
            ldsm_x4_trans(b, vrow + db * 16);
            mma_bf16(o[2 * db], a, b[0], b[1]);
            mma_bf16(o[2 * db + 1], a, b[2], b[3]);
            mma_bf16(o[2 * db], a_lo, b[0], b[1]);
            mma_bf16(o[2 * db + 1], a_lo, b[2], b[3]);
          }
        }
      }
    }
  }

  // merge the key halves: warpgroup 1 leaves its rows' (O, m, l) in the
  // ring (free now: the last copies have landed), warpgroup 0 folds them in
  // and writes. xo rows are padded by 4 floats against bank conflicts.
  constexpr int xld = kD + 4;
  float* xo = reinterpret_cast<float*>(ring);   // [64][xld]
  float* xml = xo + kTileRows * xld;             // [64][2]
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (wg == 1 && active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wrow + quad + 8 * h;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<float2*>(xo + r * xld + j * 8 + pair) =
            make_float2(o[j][2 * h], o[j][2 * h + 1]);
      if (pair == 0) {
        xml[2 * r] = m[h];
        xml[2 * r + 1] = l[h];
      }
    }
  }
  __syncthreads();
  if (wg == 1 || !active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow + quad + 8 * h;
    if (r >= n_rows) continue;
    const float m1 = xml[2 * r], l1 = xml[2 * r + 1];
    const float mm = fmaxf(m[h], m1);
    const float base = mm == -INFINITY ? 0.f : mm;
    const float a0 = exp2f(m[h] - base), a1 = exp2f(m1 - base);
    const float lm = l[h] * a0 + l1 * a1;
    const float* xr = xo + r * xld;
    const int i = r / group, g = r - i * group;
    if (dst.out) {
      const float inv = lm > 0.f ? 1.f / lm : 0.f;
      __nv_bfloat16* orow = dst.out + q_off + (long long)i * q_row_stride + g * kD;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(xr + j * 8 + pair);
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + pair) =
            __floats2bfloat162_rn((o[j][2 * h] * a0 + x.x * a1) * inv,
                                  (o[j][2 * h + 1] * a0 + x.y * a1) * inv);
      }
    } else {
      const long long p = (dst.part_q0 + i) * dst.heads + kvh * group + g;
      float* orow = dst.part_o + p * kD;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(xr + j * 8 + pair);
        *reinterpret_cast<float2*>(orow + j * 8 + pair) =
            make_float2(o[j][2 * h] * a0 + x.x * a1,
                        o[j][2 * h + 1] * a0 + x.y * a1);
      }
      if (pair == 0) {
        dst.part_ml[2 * p] = mm;
        dst.part_ml[2 * p + 1] = lm;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// attend_latent: prefill.cu's query tile at head_dim 640, MLA's latent row.
//
// The contract of attend_mma (rows r = i * group + g of one KV head, the
// general mask, zeros for a row that sees no key) with bf16 rows out (the
// decode rows at 640 run decode_latent_kernel), for the one shape that
// attend_mma cannot hold: at
// D = 640 a warp's 16 rows of f32 O are 320 registers a thread, and q's
// tile plus one 64-key bf16 K/V stage (82,944 + 165,888 bytes) pass the
// block's 232,448 bytes of shared memory. So the block has 16 warps
// (kLatentThreads): warp w owns row block rb = w / 4 (rows 16 rb .. + 15)
// and lane quarter dq = w % 4 (lanes 160 dq .. + 159), and walks the keys
// in tiles of kLatentKeys = 16 through a three-stage cp.async ring (one
// warp copies each key's K and V rows):
//   - S: warp (rb, dq) multiplies its rows' q by the tile's K over its own
//     160 lanes only (10 k16 steps, mma.sync m16n8k16, f32), and leaves the
//     16 x 16 partial in shared memory; after a barrier each warp of row
//     block rb sums the four quarters' partials in the same order, so the
//     four hold the same scores, the same (m, l) and the same P;
//   - the online softmax as attend_mma's (scale in log2 units, exp2f, a
//     row's max and sum over the four lanes that share it; int8 scales
//     folded in f32);
//   - O += P V for the warp's own 160 lanes of V: 20 n8 blocks, 80 f32
//     registers, P in two bf16 parts as in attend_mma.
// No merge between warps is needed: every key of a row block passes
// through all four of its warps. Each warp writes its quarter of its rows.
// K and V are read from their own pools, as the plain versions do, though
// an MLA pool pair holds the same row twice.
template <typename KVTiles, typename Rows>
__device__ __forceinline__ void attend_latent(
    const __nv_bfloat16* __restrict__ q, long long q_off, int q_row_stride,
    KVTiles kv, Rows rows, int kvh, int nq, int group, int qpos0, int kv_len,
    int key_lo, int key_hi, float scale, TileOut dst) {
  constexpr int kD = kLatentDim, ld = kD + 8, kK = kLatentKeys;
  constexpr int kStages = kLatentStages, kQ = kLatentQuarter;
  constexpr size_t kStage = latent_stage_bytes<KVTiles>();
  extern __shared__ __align__(16) char tile_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wrow = (warp >> 2) * 16, dq = warp & 3, d0 = dq * kQ;
  const int quad = lane >> 2, pair = (lane & 3) * 2;
  const int n_rows = nq * group;
  const int lo = key_lo;
  const int hi = min(min(qpos0 + nq, kv_len), key_hi);

  if (lo >= hi) {  // no key in range: zeros
    for (int idx = tid; idx < n_rows * kD; idx += kLatentThreads) {
      const int r = idx / kD, dd = idx - r * kD, i = r / group, g = r - i * group;
      dst.out[q_off + (long long)i * q_row_stride + g * kD + dd] =
          __float2bfloat16(0.f);
    }
    return;
  }

  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tile_smem);  // [64][ld]
  char* ring = tile_smem + (size_t)kTileRows * ld * sizeof(__nv_bfloat16);
  char* work = ring + kStages * kStage;
  float* part = reinterpret_cast<float*>(work + latent_work_bytes<KVTiles>());
  const int n_tiles = (hi - lo + kK - 1) / kK;

  // Copies: warp `slot` copies key slot `slot` of a tile (K and V rows,
  // 16 bytes a lane); a key at or past hi is zero-filled, never addressed.
  const int slot = warp;
  auto fetch = [&](int t) {
    char* stage = ring + (t % kStages) * kStage;
    const int tok = lo + t * kK + slot;
    const long long row = tok < hi ? rows(tok) : -1;
    const bool ok = row >= 0;
    const long long off = row + (long long)kvh * kD;
    if constexpr (KVTiles::kInt8) {
      char* kd = stage + slot * kD;
      char* vd = kd + kK * kD;
      for (int c = lane; c < kD / 16; c += 32) {
        cp_async16(kd + c * 16, ok ? kv.k + off + c * 16 : kv.k, ok);
        cp_async16(vd + c * 16, ok ? kv.v + off + c * 16 : kv.v, ok);
      }
      if (lane < 2) {  // the chunks of K's and V's scales
        const int8_t* src = lane ? kv.v : kv.k;
        cp_async16(stage + 2 * kK * kD + (lane * kK + slot) * 16,
                   ok ? src + row + kv.kvd + 16 * (kvh / 8) : src, ok);
      }
    } else {
      __nv_bfloat16* kd = reinterpret_cast<__nv_bfloat16*>(stage) + slot * ld;
      __nv_bfloat16* vd = kd + kK * ld;
      for (int c = lane; c < kD / 8; c += 32) {
        cp_async16(kd + c * 8, ok ? kv.k + off + c * 8 : kv.k, ok);
        cp_async16(vd + c * 8, ok ? kv.v + off + c * 8 : kv.v, ok);
      }
    }
  };

  // q rows (zero rows past n_rows) join the first tile's group
  for (int idx = tid; idx < kTileRows * (kD / 8); idx += kLatentThreads) {
    const int r = idx / (kD / 8), c = idx - r * (kD / 8);
    const int i = r / group, g = r - i * group;
    const bool valid = r < n_rows;
    const __nv_bfloat16* src =
        valid ? q + q_off + (long long)i * q_row_stride + g * kD + c * 8 : q;
    cp_async16(qs + r * ld + c * 8, src, valid);
  }
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) fetch(t);
    cp_async_commit();
  }

  const bool active = wrow < n_rows;
  int qlim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qlim[h] = qpos0 + (wrow + quad + 8 * h) / group;
  const float sl2 = scale * 1.4426950408889634f;  // 1/sqrt(D) in log2 units
  float o[kQ / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t (and q) have landed
    // every warp is past tile t - 1: its stage, the work area and the
    // partials are free again
    __syncthreads();
    if (t + kStages - 1 < n_tiles) fetch(t + kStages - 1);
    cp_async_commit();
    char* stage = ring + (t % kStages) * kStage;
    const __nv_bfloat16* kt;
    const float* ksc = nullptr;
    if constexpr (KVTiles::kInt8) {
      widen_int8_rows<kD, 2 * kK, kLatentThreads>(stage, work, kvh, tid);
      __syncthreads();
      kt = reinterpret_cast<const __nv_bfloat16*>(work);
      ksc = reinterpret_cast<const float*>(kt + 2 * kK * ld);
    } else {
      kt = reinterpret_cast<const __nv_bfloat16*>(stage);
    }
    const __nv_bfloat16* vt = kt + kK * ld;
    const int k0 = lo + t * kK;

    // this quarter's partial scores of the row block's 16 rows x 16 keys
    if (active) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        unsigned a[4], b[4];
        ldsm_x4(a, qs + (wrow + (lane & 15)) * ld + d0 + kk * 16
                       + ((lane >> 4) << 3));
        ldsm_x4(b, kt + ((lane & 7) + ((lane >> 4) << 3)) * ld + d0
                       + kk * 16 + (((lane >> 3) & 1) << 3));
        mma_bf16(s[0], a, b[0], b[1]);
        mma_bf16(s[1], a, b[2], b[3]);
      }
      float* pw = part + (dq * kTileRows + wrow) * kLatentSld;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(pw + (quad + 8 * h) * kLatentSld
                                     + j * 8 + pair) =
              make_float2(s[j][2 * h], s[j][2 * h + 1]);
    }
    __syncthreads();  // every quarter's partial is in
    if (!active) continue;

    // the full scores (the quarters summed in order), scaled and masked;
    // s[j][2h + e] is row quad + 8h, key k0 + j * 8 + pair + e
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 x = make_float2(0.f, 0.f);
#pragma unroll
        for (int pq = 0; pq < 4; ++pq) {
          const float2 y = *reinterpret_cast<const float2*>(
              part + (pq * kTileRows + wrow + quad + 8 * h) * kLatentSld
              + j * 8 + pair);
          x.x += y.x;
          x.y += y.y;
        }
        s[j][2 * h] = x.x;
        s[j][2 * h + 1] = x.y;
      }
    const bool edge = k0 + kK > hi || k0 + kK - 1 > qpos0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * 8 + pair + e, tok = k0 + key;
        float f = sl2;
        if constexpr (KVTiles::kInt8) f = sl2 * ksc[key];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x = s[j][2 * h + e] * f;
          if (edge && !(tok < hi && tok <= qlim[h])) x = -INFINITY;
          s[j][2 * h + e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // never exp(-inf - -inf): a row that has seen nothing keeps 0s
      const float base = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = exp2f(m[h] - base);
      m[h] = m_new;
      l[h] *= alpha[h];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[j][2 * h + e] - base);
          s[j][2 * h + e] = p;
          l[h] += p;
        }
    }
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V over this quarter's lanes: the tile's 16 keys are one k16
    // step, P (times V's int8 scales) in two bf16 parts
    float p[2][4];
#pragma unroll
    for (int hb = 0; hb < 2; ++hb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vs = 1.f;
        if constexpr (KVTiles::kInt8) vs = ksc[kK + hb * 8 + pair + (e & 1)];
        p[hb][e] = s[hb][e] * vs;
      }
    unsigned a[4], a_lo[4];
    split_bf16(p[0][0], p[0][1], a[0], a_lo[0]);
    split_bf16(p[0][2], p[0][3], a[1], a_lo[1]);
    split_bf16(p[1][0], p[1][1], a[2], a_lo[2]);
    split_bf16(p[1][2], p[1][3], a[3], a_lo[3]);
    const __nv_bfloat16* vrow =
        vt + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + d0
        + ((lane >> 4) << 3);
#pragma unroll
    for (int db = 0; db < kQ / 16; ++db) {
      unsigned b[4];
      ldsm_x4_trans(b, vrow + db * 16);
      mma_bf16(o[2 * db], a, b[0], b[1]);
      mma_bf16(o[2 * db + 1], a, b[2], b[3]);
      mma_bf16(o[2 * db], a_lo, b[0], b[1]);
      mma_bf16(o[2 * db + 1], a_lo, b[2], b[3]);
    }
  }
  cp_async_wait<0>();

  if (!active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow + quad + 8 * h;
    if (r >= n_rows) continue;
    const int i = r / group, g = r - i * group;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    __nv_bfloat16* orow =
        dst.out + q_off + (long long)i * q_row_stride + g * kD + d0;
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + pair) =
          __floats2bfloat162_rn(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
  }
}

// The tile of head_dim kD: attend_latent at kLatentDim, attend_mma below.
// A block runs tile_threads<kD>() threads and tile_smem_bytes of shared
// memory.
template <int kD, typename KVTiles, typename Rows>
__device__ __forceinline__ void attend(
    const __nv_bfloat16* __restrict__ q, long long q_off, int q_row_stride,
    KVTiles kv, Rows rows, int kvh, int nq, int group, int qpos0, int kv_len,
    int key_lo, int key_hi, float scale, TileOut dst) {
  if constexpr (kD == kLatentDim)
    attend_latent(q, q_off, q_row_stride, kv, rows, kvh, nq, group, qpos0,
                  kv_len, key_lo, key_hi, scale, dst);
  else
    attend_mma<kD>(q, q_off, q_row_stride, kv, rows, kvh, nq, group, qpos0,
                   kv_len, key_lo, key_hi, scale, dst);
}

// ---------------------------------------------------------------------------
// The latent chunk tile: chunk.cu at head_dim 640 (chunk_latent_kernel).
//
// A query tile is attend_latent's (64 rows = positions x the GQA group of
// one KV head), but its keys [0, horizon) are cut into `spans` equal spans
// (chunk_spans: 1, 2, 4 or 8), one block each, and the blocks of a query
// tile form one thread-block cluster that merges their partials through
// distributed shared memory (no scratch in device memory). A block of
// kChunkThreads = two warpgroups walks its span in tiles of kChunkKeys = 32
// keys:
//   - S = Q K^T with wgmma (m64n32k16, both operands in shared memory in the
//     128-byte swizzle: q's 64 x 640 tile in 10 panels of 64 lanes, the K
//     tile likewise), over all 640 lanes, by each warpgroup: the two compute
//     the same scores, so no partial score crosses a warp; each thread holds
//     two rows' scores (the m16n8 accumulator layout, warp w of a warpgroup
//     owning rows 16w .. 16w + 15);
//   - the online softmax as attend_mma's (log2 units, exp2f, int8 scales in
//     f32);
//   - O += P V with wgmma over the warpgroup's own 320 lanes of O (160 f32
//     registers a thread, as m64n256k16 + m64n64k16): P from registers in
//     two bf16 parts (attend_mma's split_bf16), V from shared memory read
//     MN-major (its 64-lane panels, 8-key groups).
// Copies: every thread copies its share of a tile with cp.async into the
// swizzle (one key slot per 8 threads). Two barriers a tile: after K(t)
// has landed (then S), and after V(t) has landed (then P V). bf16 pools
// rotate K and V through three tiles: K(t + 1) is issued at the first
// barrier (into V(t - 1)'s tile: it lands under S(t) and P V(t)), V(t + 1)
// at the second (into K(t)'s: under P V(t) and S(t + 1)), and V(0) goes
// with q and K(0). int8 pools copy their raw rows into a staging area
// instead, and each thread widens the chunks it copied itself (its own
// writes: no barrier) into the single bf16 K or V tile, V(t) before the
// second barrier and K(t + 1) after P V(t), and copies the next raw rows
// of the same kind as soon as its own are widened. A thread fences its
// writes to the async proxy (fence.proxy.async) before the barrier that
// lets wgmma read them.
// After the walk a block leaves its unnormalized partial (O in f32, m in
// log2 units, l) in its own shared memory, the cluster synchronizes, and
// each block merges a share of the query tile's output from all the
// cluster's partials (merge_splits_kernel's formula, spans in order), so
// two runs give equal bits. A span past the horizon (a short query tile
// cut into more spans than it has keys) walks nothing and merges as empty.
constexpr int kChunkThreads = 256;  // two warpgroups
constexpr int kChunkKeys = 32;      // keys per K/V tile
constexpr int kMaxChunkSpans = 8;   // spans of a query tile: a portable cluster
constexpr int kSwizzleLanes = 64;   // bf16 lanes of one 128-byte swizzle panel
constexpr int kLatentPanels = kLatentDim / kSwizzleLanes;  // 10
constexpr int kChunkLanes = kLatentDim / 2;  // lanes of O per warpgroup
constexpr int kDumpLd = kLatentDim + 4;      // padded f32 row of the dump

// Shared memory of a chunk_latent_kernel block (offsets from a 1024-byte
// aligned base, which the swizzle needs): q's tile, the K tiles (bf16: two,
// int8: one), the V tile (bf16: the three K and V tiles rotate), for int8
// pools the raw rows, their scale chunks
// and the f32 scales; after the walk the same bytes hold the partial O
// [64][kDumpLd], (m, l) [64][2] and the merge's weights [64][9]. bf16:
// 204,800 bytes, int8: 206,080, plus the 1024 of alignment slack.
template <typename KVTiles>
struct ChunkSmem {
  static constexpr size_t q_bytes = (size_t)kTileRows * kLatentDim * 2;
  static constexpr size_t tile = (size_t)kChunkKeys * kLatentDim * 2;
  static constexpr int k_tiles = KVTiles::kInt8 ? 1 : 2;
  static constexpr size_t k_off = q_bytes;
  static constexpr size_t v_off = k_off + k_tiles * tile;
  static constexpr size_t raw_off = v_off + tile;
  static constexpr size_t raw_bytes =
      KVTiles::kInt8 ? 2 * (size_t)kChunkKeys * kLatentDim : 0;
  static constexpr size_t scl_off = raw_off + raw_bytes;
  static constexpr size_t f32_off =
      scl_off + (KVTiles::kInt8 ? 2 * kChunkKeys * 16 : 0);
  static constexpr size_t walk =
      f32_off + (KVTiles::kInt8 ? 2 * kChunkKeys * 4 : 0);
  static constexpr size_t dump = (size_t)kTileRows * kDumpLd * 4
                                 + (size_t)kTileRows * 2 * 4
                                 + (size_t)kTileRows * (kMaxChunkSpans + 1) * 4;
  static constexpr size_t bytes = 1024 + (walk > dump ? walk : dump);
  static_assert(bytes <= kMaxBlockSmem,
                "the latent chunk tile's shared memory");
};

// Spans per query tile of chunk_latent_kernel for a C-query chunk at
// `start` in query tiles of `positions` positions, with KV heads, on a card
// of num_sms SMs: the largest power of two up to kMaxChunkSpans whose
// blocks (spans x tiles x KV, one a SM) still run in one wave, and at most
// the key tiles of the longest query tile's horizon (start + C). Clusters
// of 2, 4 and 8 blocks fill an H100's GPCs (132, 120 and 120 of its SMs at
// once); 3, 5 or 6 leave 15-30 SMs idle, and a second wave costs more
// than the longer spans of fewer blocks (PERF.md, the span sweep).
inline int chunk_spans(int C, int start, int positions, int KV, int num_sms) {
  const long long tiles = (long long)((C + positions - 1) / positions) * KV;
  const long long key_tiles =
      ((long long)start + C + kChunkKeys - 1) / kChunkKeys;
  int n = 1;
  while (2 * n <= kMaxChunkSpans && 2 * n * tiles <= num_sms
         && 2 * n <= key_tiles)
    n *= 2;
  return n;
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzle: start address, leading offset 1 (unused by this layout), stride
// 1024 bytes between groups of 8 rows, layout type 1 (128B swizzle)
__device__ __forceinline__ unsigned long long gmma_desc(unsigned addr) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) | (1ull << 16)
         | ((unsigned long long)(1024 >> 4) << 32) | (1ull << 62);
}

// s[16] (+)= A B^T over one k16 step: A 64 x 16 and B 32 x 16 (keys) from
// their descriptors; accumulate = false overwrites s
__device__ __forceinline__ void wgmma_m64n32k16(float* s,
                                                unsigned long long a,
                                                unsigned long long b,
                                                bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(s[0]), "+f"(s[1]), "+f"(s[2]), "+f"(s[3]), "+f"(s[4]),
        "+f"(s[5]), "+f"(s[6]), "+f"(s[7]), "+f"(s[8]), "+f"(s[9]),
        "+f"(s[10]), "+f"(s[11]), "+f"(s[12]), "+f"(s[13]), "+f"(s[14]),
        "+f"(s[15])
      : "l"(a), "l"(b), "r"((int)accumulate));
}

// keeps the compiler from moving reads or writes of wgmma's accumulator
// registers across the asynchronous product
__device__ __forceinline__ void fence_regs16(float* s) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(s[i])::"memory");
}

// o[0 .. 31] += A B over one k16 step: A (16 rows of P a warp) in
// registers (the m16n8k16 A layout), B (256 lanes of V, 16 keys) from shared
// memory in the MN-major 128-byte swizzle
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (*o)[4],
                                                 const unsigned* a,
                                                 unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, "
      "{%128,%129,%130,%131}, %132, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(o[0][0]), "+f"(o[0][1]), "+f"(o[0][2]), "+f"(o[0][3]),
        "+f"(o[1][0]), "+f"(o[1][1]), "+f"(o[1][2]), "+f"(o[1][3]),
        "+f"(o[2][0]), "+f"(o[2][1]), "+f"(o[2][2]), "+f"(o[2][3]),
        "+f"(o[3][0]), "+f"(o[3][1]), "+f"(o[3][2]), "+f"(o[3][3]),
        "+f"(o[4][0]), "+f"(o[4][1]), "+f"(o[4][2]), "+f"(o[4][3]),
        "+f"(o[5][0]), "+f"(o[5][1]), "+f"(o[5][2]), "+f"(o[5][3]),
        "+f"(o[6][0]), "+f"(o[6][1]), "+f"(o[6][2]), "+f"(o[6][3]),
        "+f"(o[7][0]), "+f"(o[7][1]), "+f"(o[7][2]), "+f"(o[7][3]),
        "+f"(o[8][0]), "+f"(o[8][1]), "+f"(o[8][2]), "+f"(o[8][3]),
        "+f"(o[9][0]), "+f"(o[9][1]), "+f"(o[9][2]), "+f"(o[9][3]),
        "+f"(o[10][0]), "+f"(o[10][1]), "+f"(o[10][2]), "+f"(o[10][3]),
        "+f"(o[11][0]), "+f"(o[11][1]), "+f"(o[11][2]), "+f"(o[11][3]),
        "+f"(o[12][0]), "+f"(o[12][1]), "+f"(o[12][2]), "+f"(o[12][3]),
        "+f"(o[13][0]), "+f"(o[13][1]), "+f"(o[13][2]), "+f"(o[13][3]),
        "+f"(o[14][0]), "+f"(o[14][1]), "+f"(o[14][2]), "+f"(o[14][3]),
        "+f"(o[15][0]), "+f"(o[15][1]), "+f"(o[15][2]), "+f"(o[15][3]),
        "+f"(o[16][0]), "+f"(o[16][1]), "+f"(o[16][2]), "+f"(o[16][3]),
        "+f"(o[17][0]), "+f"(o[17][1]), "+f"(o[17][2]), "+f"(o[17][3]),
        "+f"(o[18][0]), "+f"(o[18][1]), "+f"(o[18][2]), "+f"(o[18][3]),
        "+f"(o[19][0]), "+f"(o[19][1]), "+f"(o[19][2]), "+f"(o[19][3]),
        "+f"(o[20][0]), "+f"(o[20][1]), "+f"(o[20][2]), "+f"(o[20][3]),
        "+f"(o[21][0]), "+f"(o[21][1]), "+f"(o[21][2]), "+f"(o[21][3]),
        "+f"(o[22][0]), "+f"(o[22][1]), "+f"(o[22][2]), "+f"(o[22][3]),
        "+f"(o[23][0]), "+f"(o[23][1]), "+f"(o[23][2]), "+f"(o[23][3]),
        "+f"(o[24][0]), "+f"(o[24][1]), "+f"(o[24][2]), "+f"(o[24][3]),
        "+f"(o[25][0]), "+f"(o[25][1]), "+f"(o[25][2]), "+f"(o[25][3]),
        "+f"(o[26][0]), "+f"(o[26][1]), "+f"(o[26][2]), "+f"(o[26][3]),
        "+f"(o[27][0]), "+f"(o[27][1]), "+f"(o[27][2]), "+f"(o[27][3]),
        "+f"(o[28][0]), "+f"(o[28][1]), "+f"(o[28][2]), "+f"(o[28][3]),
        "+f"(o[29][0]), "+f"(o[29][1]), "+f"(o[29][2]), "+f"(o[29][3]),
        "+f"(o[30][0]), "+f"(o[30][1]), "+f"(o[30][2]), "+f"(o[30][3]),
        "+f"(o[31][0]), "+f"(o[31][1]), "+f"(o[31][2]), "+f"(o[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// o[0 .. 7] += A B over one k16 step: A (16 rows of P a warp) in
// registers (the m16n8k16 A layout), B (64 lanes of V, 16 keys) from shared
// memory in the MN-major 128-byte swizzle
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (*o)[4],
                                                 const unsigned* a,
                                                 unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(o[0][0]), "+f"(o[0][1]), "+f"(o[0][2]), "+f"(o[0][3]),
        "+f"(o[1][0]), "+f"(o[1][1]), "+f"(o[1][2]), "+f"(o[1][3]),
        "+f"(o[2][0]), "+f"(o[2][1]), "+f"(o[2][2]), "+f"(o[2][3]),
        "+f"(o[3][0]), "+f"(o[3][1]), "+f"(o[3][2]), "+f"(o[3][3]),
        "+f"(o[4][0]), "+f"(o[4][1]), "+f"(o[4][2]), "+f"(o[4][3]),
        "+f"(o[5][0]), "+f"(o[5][1]), "+f"(o[5][2]), "+f"(o[5][3]),
        "+f"(o[6][0]), "+f"(o[6][1]), "+f"(o[6][2]), "+f"(o[6][3]),
        "+f"(o[7][0]), "+f"(o[7][1]), "+f"(o[7][2]), "+f"(o[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// wgmma's descriptor of an MN-major tile in the 128-byte swizzle: atoms of
// 64 lanes (128 bytes) x 8 keys, `lbo` bytes between atoms along the lanes,
// `sbo` bytes between groups of 8 keys
__device__ __forceinline__ unsigned long long gmma_desc_mn(unsigned addr,
                                                           unsigned lbo,
                                                           unsigned sbo) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4)
         | ((unsigned long long)(lbo >> 4) << 16)
         | ((unsigned long long)(sbo >> 4) << 32) | (1ull << 62);
}

// keeps the compiler from moving reads or writes of O's registers across
// an asynchronous product
__device__ __forceinline__ void fence_o(float (*o)[4]) {
#pragma unroll
  for (int j = 0; j < kChunkLanes / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(o[j][e])::"memory");
}

__device__ __forceinline__ unsigned cluster_rank_addr(unsigned addr,
                                                      unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float2 ld_cluster_f2(unsigned addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0,%1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_cluster_f4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}

// every thread of every block of the cluster; shared-memory writes before
// it are visible to the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// 16 int8 values -> 16 bf16 (exact) as two 16-byte chunks: out[0..3] the
// first 8, out[4..7] the last 8 (widen_int8_rows's arithmetic)
__device__ __forceinline__ void widen16(uint4 raw, unsigned* out) {
  const unsigned* w = reinterpret_cast<const unsigned*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const unsigned u = w[e] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | b))
             - 8388736.f;
    out[2 * e] = pack_bf16(f[0], f[1]);
    out[2 * e + 1] = pack_bf16(f[2], f[3]);
  }
}

// The share of cluster rank `span_idx` of a query tile's output: tasks of
// (row, 8-lane chunk) in row order, each the sum over the n spans' f32
// partials (dump [64][kDumpLd] in every rank's shared memory, at dump_a)
// times the row's span weights, in span order, times 1 / sum w l (wts
// [64][kMaxChunkSpans + 1] in this block's) -> bf16 rows at the q
// addressing, for a cluster of kN spans. An empty span's partial is zeros
// and its weight 0, so every load is issued without a test, and a thread
// keeps two tasks' loads in flight.
template <int kN>
__device__ __forceinline__ void merge_spans(
    int span_idx, int n_rows, const float* wts, unsigned dump_a,
    __nv_bfloat16* __restrict__ out, long long q_off, int q_row_stride,
    int group, int tid) {
  constexpr int kChunks = kLatentDim / 8;  // 8-lane chunks of a row
  constexpr int kW = kMaxChunkSpans + 1;
  constexpr int kBatch = 2;
  const int tasks = n_rows * kChunks;
  const int per = (tasks + kN - 1) / kN;
  const int t_end = min(tasks, (span_idx + 1) * per);
  for (int t0 = span_idx * per + tid; t0 < t_end;
       t0 += kBatch * kChunkThreads) {
    float4 x[kBatch][kN][2];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int task = t0 + b * kChunkThreads;
      const int r = task < t_end ? task / kChunks : 0;
      const int c8 = task < t_end ? task - r * kChunks : 0;
      const unsigned a = dump_a + 4 * (r * kDumpLd + 8 * c8);
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        const unsigned ra = cluster_rank_addr(a, u);
        x[b][u][0] = ld_cluster_f4(ra);
        x[b][u][1] = ld_cluster_f4(ra + 16);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int task = t0 + b * kChunkThreads;
      if (task >= t_end) break;
      const int r = task / kChunks, c8 = task - r * kChunks;
      const float* wr = wts + r * kW;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        const float w = wr[u];
        acc[0] += w * x[b][u][0].x;
        acc[1] += w * x[b][u][0].y;
        acc[2] += w * x[b][u][0].z;
        acc[3] += w * x[b][u][0].w;
        acc[4] += w * x[b][u][1].x;
        acc[5] += w * x[b][u][1].y;
        acc[6] += w * x[b][u][1].z;
        acc[7] += w * x[b][u][1].w;
      }
      const float inv = wr[kMaxChunkSpans];
      const int i = r / group, g = r - i * group;
      *reinterpret_cast<uint4*>(out + q_off + (long long)i * q_row_stride
                                + g * kLatentDim + 8 * c8) =
          make_uint4(pack_bf16(acc[0] * inv, acc[1] * inv),
                     pack_bf16(acc[2] * inv, acc[3] * inv),
                     pack_bf16(acc[4] * inv, acc[5] * inv),
                     pack_bf16(acc[6] * inv, acc[7] * inv));
    }
  }
}

// The walk of one block of the latent tile (chunk_latent_kernel, and the
// latent decode rows below) over its keys [lo, hi): q rows r = i * group +
// g (n_rows of them real, the rest zero) of KV head kvh, query i at qpos0 +
// i seeing key tok iff tok <= qpos0 + i and tok < hi (the caller puts hi at
// or below the horizon kv_len). Leaves this thread's unnormalized (O, m, l)
// in o, m and l (m in log2 units, l summed over the row's four lanes): O
// lanes wg * kChunkLanes + 8 j + pair + e of rows wrow + quad + 8 h, as
// chunk_latent_kernel's header describes. An empty range leaves O = 0,
// m = -inf, l = 0. Every thread of the block calls it with the same range;
// `base` is the 1024-byte aligned shared memory of ChunkSmem.
template <typename KVTiles>
__device__ __forceinline__ void latent_walk(
    char* base, const __nv_bfloat16* __restrict__ q, long long q_off,
    int q_row_stride, KVTiles kv, PagedRows rows, int kvh, int n_rows,
    int group, int qpos0, int lo, int hi, float scale,
    float (&o)[kChunkLanes / 8][4], float (&m)[2], float (&l)[2]) {
  using L = ChunkSmem<KVTiles>;
  constexpr int kD = kLatentDim, kK = kChunkKeys;
  constexpr int kPanelQ = kTileRows * 128;  // bytes of one q panel
  constexpr int kPanelK = kK * 128;         // of one K or V panel
  const unsigned base_a = smem_u32(base);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wrow = (warp & 3) * 16;
  const int quad = lane >> 2, pair = (lane & 3) * 2;

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kChunkLanes / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  if (lo < hi) {  // the same for every thread of the block
    char* qs = base;
    char* ks = base + L::k_off;     // int8: the K tile
    char* vs = base + L::v_off;     // int8: the V tile
    char* raw = base + L::raw_off;  // int8: K rows [32][640], V rows
    char* scl = base + L::scl_off;  // int8: K's, then V's scale chunks
    float* ksc = reinterpret_cast<float*>(base + L::f32_off);
    float* vsc = ksc + kK;
    const int n_tiles = (hi - lo + kK - 1) / kK;
    // copies: 8 threads per key slot, `part` taking 16-byte chunk `part` of
    // every swizzle panel (bf16) or int8 chunks part, part + 8, ... (int8)
    const int slot = tid >> 3, part = tid & 7, sw = slot & 7;
    auto row_of = [&](int t) -> long long {
      const int tok = lo + t * kK + slot;
      return tok < hi ? rows(tok) : -1;  // -1: zero-filled, never addressed
    };
    auto copy_tile = [&](const void* src_pool, char* dst, int which,
                         long long row) {
      const bool ok = row >= 0;
      const long long off = row + (long long)kvh * kD;
      if constexpr (KVTiles::kInt8) {
        const int8_t* src = static_cast<const int8_t*>(src_pool);
        char* r = raw + which * (kK * kD) + slot * kD;
#pragma unroll
        for (int i = 0; i < kD / 16 / 8; ++i) {
          const int c8 = part + 8 * i;
          cp_async16(r + c8 * 16, ok ? src + off + c8 * 16 : src, ok);
        }
        if (part == which)  // the chunk holding head kvh's scale
          cp_async16(scl + (which * kK + slot) * 16,
                     ok ? src + row + kv.kvd + 16 * (kvh / 8) : src, ok);
      } else {
        const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(src_pool);
        char* d = dst + slot * 128 + ((part ^ sw) << 4);
#pragma unroll
        for (int p = 0; p < kLatentPanels; ++p)
          cp_async16(d + p * kPanelK,
                     ok ? src + off + p * kSwizzleLanes + part * 8 : src, ok);
      }
    };
    // int8: this thread's raw chunks of K (which 0) or V (1) -> the bf16
    // tile at dst, and its key's scale -> f32
    auto widen_own = [&](int which, char* dst, float* sc) {
      if constexpr (KVTiles::kInt8) {
        const char* r = raw + which * (kK * kD) + slot * kD;
#pragma unroll
        for (int i = 0; i < kD / 16 / 8; ++i) {
          const int c8 = part + 8 * i;  // lanes 16 c8 .. + 15
          unsigned w[8];
          widen16(*reinterpret_cast<const uint4*>(r + c8 * 16), w);
          const int j = (c8 & 3) * 2;   // bf16 chunk in the panel
          char* d = dst + (c8 >> 2) * kPanelK + slot * 128;
          *reinterpret_cast<uint4*>(d + ((j ^ sw) << 4)) =
              make_uint4(w[0], w[1], w[2], w[3]);
          *reinterpret_cast<uint4*>(d + (((j + 1) ^ sw) << 4)) =
              make_uint4(w[4], w[5], w[6], w[7]);
        }
        if (part == which) {
          const unsigned short bits = *reinterpret_cast<const unsigned short*>(
              scl + (which * kK + slot) * 16 + 2 * (kvh % 8));
          sc[slot] = __uint_as_float((unsigned)bits << 16);
        }
      }
    };
    // the tiles of K(t) and V(t), as offsets: bf16 pools rotate the two
    // through three tiles (halves 2t and 2t + 1 of the walk); int8 pools
    // widen into one K and one V tile
    auto ktile = [&](int t) -> unsigned {
      return KVTiles::kInt8 ? (unsigned)L::k_off
                            : (unsigned)(L::k_off + (2 * t) % 3 * L::tile);
    };
    auto vtile = [&](int t) -> unsigned {
      return KVTiles::kInt8 ? (unsigned)L::v_off
                            : (unsigned)(L::k_off + (2 * t + 1) % 3 * L::tile);
    };

    // q rows slot and slot + 32 (zero rows past n_rows), then K(0)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = slot + 32 * rr, i = r / group, g = r - i * group;
      const bool valid = r < n_rows;
      const __nv_bfloat16* src =
          q + q_off + (long long)i * q_row_stride + g * kD + part * 8;
      char* d = qs + r * 128 + ((part ^ (r & 7)) << 4);
#pragma unroll
      for (int p = 0; p < kLatentPanels; ++p)
        cp_async16(d + p * kPanelQ, valid ? src + p * kSwizzleLanes : q,
                   valid);
    }
    // Copies, one commit group each, in the order K(0), V(0), K(1), V(1),
    // ...: so at each wait below only the last group may still be in
    // flight. bf16: K(t + 1) is issued at the barrier that frees V(t - 1)'s
    // tile, V(t + 1) at the one that frees K(t)'s. int8: each thread copies
    // the next raw K or V rows as soon as it has widened its own chunks of
    // the last ones.
    long long row = row_of(0);  // this thread's key slot of the next tile
    copy_tile(kv.k, base + ktile(0), 0, row);
    cp_async_commit();
    copy_tile(kv.v, base + vtile(0), 1, row);
    cp_async_commit();
    row = n_tiles > 1 ? row_of(1) : -1;
    if constexpr (KVTiles::kInt8) {
      cp_async_wait<1>();
      widen_own(0, ks, ksc);
      if (n_tiles > 1) copy_tile(kv.k, nullptr, 0, row);
      cp_async_commit();
    }

    int qlim[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) qlim[h] = qpos0 + (wrow + quad + 8 * h) / group;
    const float sl2 = scale * 1.4426950408889634f;  // 1/sqrt(D) in log2 units
    const unsigned long long desc_q = gmma_desc(base_a);

    for (int t = 0; t < n_tiles; ++t) {
      // K(t) has landed (V(t) may be in flight; int8: this thread widened
      // its chunks of K(t) before)
      if constexpr (!KVTiles::kInt8) cp_async_wait<1>();
      fence_proxy_async();
      // K(t) is in for everyone, and everyone is past S and P V of t - 1
      __syncthreads();
      if constexpr (!KVTiles::kInt8) {
        // K(t + 1) into V(t - 1)'s tile; it lands under S(t) and P V(t)
        if (t + 1 < n_tiles) copy_tile(kv.k, base + ktile(t + 1), 0, row);
        cp_async_commit();
      }
      // this thread's key slot of tile t + 2, a page id loaded early
      const long long row2 = t + 2 < n_tiles ? row_of(t + 2) : -1;

      // S = Q K^T: 40 k16 steps over the swizzle panels, 32 bytes apart
      // inside a panel
      float s[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = 0.f;
      const unsigned long long desc_k = gmma_desc(base_a + ktile(t));
      fence_regs16(s);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n32k16(
            s, desc_q + (((kk >> 2) * kPanelQ + (kk & 3) * 32) >> 4),
            desc_k + (((kk >> 2) * kPanelK + (kk & 3) * 32) >> 4), kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs16(s);

      // scale, mask, online softmax; s[4j + 2h + e] is row wrow + quad +
      // 8h, key k0 + 8j + pair + e
      const int k0 = lo + t * kK;
      const bool edge = k0 + kK > hi || k0 + kK - 1 > qpos0;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = j * 8 + pair + e, tok = k0 + key;
          float f = sl2;
          if constexpr (KVTiles::kInt8) f = sl2 * ksc[key];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x = s[4 * j + 2 * h + e] * f;
            if (edge && !(tok < hi && tok <= qlim[h])) x = -INFINITY;
            s[4 * j + 2 * h + e] = x;
            mx[h] = fmaxf(mx[h], x);
          }
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        // never exp(-inf - -inf): a row that has seen nothing keeps 0s
        const float b = m_new == -INFINITY ? 0.f : m_new;
        alpha[h] = exp2f(m[h] - b);
        m[h] = m_new;
        l[h] *= alpha[h];
#pragma unroll
        for (int j = 0; j < kK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(s[4 * j + 2 * h + e] - b);
            s[4 * j + 2 * h + e] = p;
            l[h] += p;
          }
      }
#pragma unroll
      for (int j = 0; j < kChunkLanes / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }

      cp_async_wait<1>();  // V(t) has landed (K(t + 1) may be in flight)
      if constexpr (KVTiles::kInt8) {
        widen_own(1, vs, vsc);
        if (t + 1 < n_tiles) copy_tile(kv.v, nullptr, 1, row);
        cp_async_commit();
      }
      fence_proxy_async();
      // V(t) is in for everyone, and everyone is past S(t)
      __syncthreads();
      if constexpr (!KVTiles::kInt8) {
        // V(t + 1) into K(t)'s tile; it lands under P V(t) and S(t + 1)
        if (t + 1 < n_tiles) copy_tile(kv.v, base + vtile(t + 1), 1, row);
        cp_async_commit();
      }
      const unsigned v_a = base_a + vtile(t) + 5 * wg * kPanelK;

      // O += P V on wgmma: P (times V's int8 scales, in two bf16 parts)
      // from registers, this warpgroup's 320 lanes of V as 256 + 64 from
      // shared memory (MN-major: 64-lane panels 4096 bytes apart, groups
      // of 8 keys 1024 bytes apart)
      unsigned a[2][4], a_lo[2][4];
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk) {
        float p[2][4];
#pragma unroll
        for (int hb = 0; hb < 2; ++hb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float vsf = 1.f;
            if constexpr (KVTiles::kInt8)
              vsf = vsc[(2 * kk + hb) * 8 + pair + (e & 1)];
            p[hb][e] = s[4 * (2 * kk + hb) + e] * vsf;
          }
        split_bf16(p[0][0], p[0][1], a[kk][0], a_lo[kk][0]);
        split_bf16(p[0][2], p[0][3], a[kk][1], a_lo[kk][1]);
        split_bf16(p[1][0], p[1][1], a[kk][2], a_lo[kk][2]);
        split_bf16(p[1][2], p[1][3], a[kk][3], a_lo[kk][3]);
      }
      fence_o(o);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk) {
        const unsigned vb = v_a + kk * 16 * 128;
        const unsigned long long d0 = gmma_desc_mn(vb, kPanelK, 1024);
        const unsigned long long d1 = gmma_desc_mn(vb + 4 * kPanelK, kPanelK, 1024);
        wgmma_m64n256k16_rs(o, a[kk], d0);
        wgmma_m64n64k16_rs(o + 32, a[kk], d1);
        wgmma_m64n256k16_rs(o, a_lo[kk], d0);
        wgmma_m64n64k16_rs(o + 32, a_lo[kk], d1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_o(o);
      if constexpr (KVTiles::kInt8) {
        // K(t + 1) into the K tile, which everyone is done with since the
        // barrier above, then K(t + 2)'s raw rows
        if (t + 1 < n_tiles) {
          cp_async_wait<1>();
          widen_own(0, ks, ksc);
          if (t + 2 < n_tiles) copy_tile(kv.k, nullptr, 0, row2);
          cp_async_commit();
        }
      }
      row = row2;
    }
    cp_async_wait<0>();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
}

// Block (span, query tile, KV head) of a C-query chunk at `start` over the
// page list `pages` (rows r = i * group + g, positions start + i0 ..): the
// walk of its span, then the cluster's merge into out's bf16 rows. The
// query tile's horizon is min(start + i0 + nq, kv_len) with kv_len =
// start + C (chunk.cu), or, with `desc_start` (ragged.cu's chunk rows),
// start = *desc_start and kv_len = min(*desc_kv_len, max_keys) read on the
// card: the same blocks and spans, so equal inputs give chunk.cu's bits.
// With `clocks`, thread 0 stamps the global timer when its walk ends and
// when the block is done: clocks[2 * block + {0, 1}] (the merge's own
// time).
template <typename KVTiles>
__global__ void __launch_bounds__(kChunkThreads, 1) chunk_latent_kernel(
    const __nv_bfloat16* __restrict__ q,  // [C, H, 640]
    KVTiles kv,                           // pools [P, ps, lane_width]
    const int* __restrict__ pages,        // [W]
    __nv_bfloat16* __restrict__ out,      // [C, H, 640]
    int C, int H, int KV, int page_size, int lane_width, int start,
    int positions, float scale, unsigned long long* __restrict__ clocks,
    const int* __restrict__ desc_start, const int* __restrict__ desc_kv_len,
    int max_keys) {
  constexpr int kD = kLatentDim;
  extern __shared__ __align__(16) char chunk_smem[];
  const unsigned smem0 = smem_u32(chunk_smem);
  char* base = chunk_smem + (((smem0 + 1023) & ~1023u) - smem0);

  const int span_idx = blockIdx.x, n_spans = gridDim.x;
  const int i0 = blockIdx.y * positions, kvh = blockIdx.z;
  const int group = H / KV;
  const int nq = min(positions, C - i0), n_rows = nq * group;
  int kv_len = start + C;
  if (desc_start) {
    start = *desc_start;
    kv_len = min(*desc_kv_len, max_keys);
  }
  const int qpos0 = start + i0;
  // the tile's last query sees start + i0 + nq - 1
  const int horizon = max(0, min(qpos0 + nq, kv_len));
  const int span = (horizon + n_spans - 1) / n_spans;
  const int lo = span_idx * span, hi = min(lo + span, horizon);
  const long long q_off = ((long long)i0 * H + kvh * group) * kD;
  const int q_row_stride = H * kD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wrow = (warp & 3) * 16;
  const int quad = lane >> 2, pair = (lane & 3) * 2;

  float o[kChunkLanes / 8][4], m[2], l[2];
  latent_walk(base, q, q_off, q_row_stride, kv,
              PagedRows{pages, page_size, lane_width}, kvh, n_rows, group,
              qpos0, lo, hi, scale, o, m, l);

  // the partial into this block's shared memory (over the walk's tiles)
  const long long block =
      blockIdx.x + (long long)gridDim.x * (blockIdx.y + (long long)gridDim.y
                                                            * blockIdx.z);
  __syncthreads();  // every warp is done with the tiles
  if (clocks && tid == 0) clocks[2 * block] = global_ns();
  float* dump = reinterpret_cast<float*>(base);
  float* ml = dump + kTileRows * kDumpLd;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow + quad + 8 * h;
    float* dr = dump + r * kDumpLd + wg * kChunkLanes + pair;
#pragma unroll
    for (int j = 0; j < kChunkLanes / 8; ++j)
      *reinterpret_cast<float2*>(dr + j * 8) =
          make_float2(o[j][2 * h], o[j][2 * h + 1]);
    if (wg == 0 && pair == 0) {
      ml[2 * r] = m[h];
      ml[2 * r + 1] = l[h];
    }
  }
  cluster_sync();  // every span's partial is in

  // merge (merge_splits_kernel's formula, spans in order): first each row's
  // span weights w_u = 2^(m_u - max m), 0 for an empty span, and
  // 1 / sum_u w_u l_u into this block's own shared memory; the loads of a
  // row's spans are independent, so their latencies overlap
  constexpr int kW = kMaxChunkSpans + 1;  // a row's weights, then 1 / sum
  float* wts = ml + 2 * kTileRows;
  const unsigned dump_a = smem_u32(dump), ml_a = smem_u32(ml);
  if (tid < n_rows) {
    float2 x[kMaxChunkSpans];
#pragma unroll
    for (int u = 0; u < kMaxChunkSpans; ++u)
      x[u] = u < n_spans ? ld_cluster_f2(cluster_rank_addr(ml_a + 8 * tid, u))
                         : make_float2(-INFINITY, 0.f);
    float big = -INFINITY;
#pragma unroll
    for (int u = 0; u < kMaxChunkSpans; ++u) big = fmaxf(big, x[u].x);
    float denom = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxChunkSpans; ++u) {
      const float w = x[u].x == -INFINITY ? 0.f : exp2f(x[u].x - big);
      wts[tid * kW + u] = w;
      denom += w * x[u].y;
    }
    wts[tid * kW + kMaxChunkSpans] = denom > 0.f ? 1.f / denom : 0.f;
  }
  __syncthreads();
  // then this block's share of the tile's (row, 8-lane chunk) tasks
  auto merge = [&](auto n) {
    merge_spans<decltype(n)::value>(span_idx, n_rows, wts, dump_a, out, q_off,
                                    q_row_stride, group, tid);
  };
  static_assert(kMaxChunkSpans == 8, "a merge for every span count");
  switch (n_spans) {
    case 1: merge(std::integral_constant<int, 1>{}); break;
    case 2: merge(std::integral_constant<int, 2>{}); break;
    case 3: merge(std::integral_constant<int, 3>{}); break;
    case 4: merge(std::integral_constant<int, 4>{}); break;
    case 5: merge(std::integral_constant<int, 5>{}); break;
    case 6: merge(std::integral_constant<int, 6>{}); break;
    case 7: merge(std::integral_constant<int, 7>{}); break;
    default: merge(std::integral_constant<int, 8>{});
  }
  cluster_sync();  // no block leaves while the cluster reads its partial
  if (clocks && tid == 0) clocks[2 * block + 1] = global_ns();
}

// The launch of chunk_latent_kernel: clusters of grid.x blocks (the spans
// of one query tile), kChunkThreads a block.
struct LatentLaunch {
  cudaLaunchAttribute cluster[1];
  cudaLaunchConfig_t cfg = {};
  LatentLaunch(dim3 grid, size_t smem, cudaStream_t stream) {
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = grid.x;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kChunkThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
  }
};

// chunk_latent_kernel over a C-query chunk in `spans` spans a query tile:
// chunk.cu's (start given, desc_start == nullptr), or ragged.cu's chunk
// rows (start and kv_len read from desc_start, desc_kv_len on the card, cut
// at max_keys). q, out and pages start at the chunk's.
template <typename KVTiles>
int launch_chunk_latent(const void* q, KVTiles kv, const void* pages,
                        void* out, int C, int H, int KV, int page_size,
                        int lane_width, int start, int positions, int spans,
                        float scale, void* clocks, cudaStream_t stream,
                        const int* desc_start = nullptr,
                        const int* desc_kv_len = nullptr,
                        int max_keys = 0) {
  cudaError_t err;
  const int tiles = (C + positions - 1) / positions;
  // any span count is exact; the wrapper's plan is chunk_spans (also
  // dtt_chunk_spans), and a measurement may ask for another
  if (spans < 1 || spans > kMaxChunkSpans || tiles > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  auto kernel = chunk_latent_kernel<KVTiles>;
  err = set_smem(kernel, ChunkSmem<KVTiles>::bytes);
  if (err != cudaSuccess) return (int)err;
  LatentLaunch launch(dim3(spans, tiles, KV), ChunkSmem<KVTiles>::bytes,
                      stream);
  err = cudaLaunchKernelEx(&launch.cfg, kernel,
                           (const __nv_bfloat16*)q, kv, (const int*)pages,
                           (__nv_bfloat16*)out, C, H, KV, page_size,
                           lane_width, start, positions, scale,
                           (unsigned long long*)clocks, desc_start,
                           desc_kv_len, max_keys);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Split decode rows below head_dim 640 (decode.cu, and the decode rows of
// ragged.cu).
//
// A decode row, decode_q queries of one sequence at qpos0 .. qpos0 +
// decode_q - 1 over its page list of W pages, is split along its keys into
// num_splits spans of split_keys keys (decode_split_keys: from the list's
// width, the row count and the SM count on the host; the kv_lens live on
// the card and are never read back). One block per (row, span, KV head)
// runs attend_mma over the span's keys and writes its unnormalized partial
// (O, m, l) in f32; a span at or past its row's horizon writes m = -inf,
// l = 0 and exits. merge_splits_kernel then folds the spans into the bf16
// rows. So a 2048-token row runs on 8 SMs instead of serially on one. The
// block runs the 64-row tile with decode_q x group real rows: the rows are
// bound by bytes, and the MMA lanes the padding wastes cost no bytes.
// Head_dim 640 runs the latent decode rows further below.

// The partials' scratch: split s of decode query n (of nd in all), head h
// at part_o[((s * nd + n) * heads + h) * D ..] and part_ml[.. * 2 + {0, 1}].
struct Splits {
  float* part_o;
  float* part_ml;
  long long nd;
  int num_splits;
  int split_keys;
};

// Decode block bx of a grid of (row, span) blocks, span fastest, for KV
// head kvh: row b = bx / num_splits reads page list tables[b] [W] up to
// min(kv_lens[b], W * page_size) keys; its queries sit at q_starts[b] ..,
// or without q_starts (decode.cu: one query per row) at kv_lens[b] - 1.
// q and its rows as in ragged_kernel: query j of row b, head h at
// q[((b * decode_q + j) * heads + h) * kD ..].
template <int kD, typename KVTiles>
__device__ __forceinline__ void decode_split_block(
    int bx, int kvh, const __nv_bfloat16* __restrict__ q, KVTiles kv,
    const int* __restrict__ tables, int W, int page_size, int lane_width,
    const int* __restrict__ kv_lens, const int* __restrict__ q_starts,
    int decode_q, int group, int heads, float scale, Splits sp) {
  static_assert(kD != kLatentDim, "head_dim 640: decode_latent_kernel");
  const int b = bx / sp.num_splits, s = bx - b * sp.num_splits;
  const int kv_len = kv_lens[b];
  const int qpos0 = q_starts ? q_starts[b] : kv_len - 1;
  const PagedRows rows{tables + (long long)b * W, page_size, lane_width};
  // The host keeps decode_q x group within the tile's rows, so this loop
  // over the row's query tiles runs once. It stays a loop: so written,
  // ptxas spills 36 / 40 bytes at head_dim 256 (a tile at 255 registers),
  // and 100 / 156 for the same call made once (on an H100, 0.054 against
  // 0.052 ms at phase 3's head_dim 256 decode rows).
  const int per = kTileRows / group;
  for (int j0 = 0; j0 < decode_q; j0 += per) {
    if (j0) __syncthreads();  // the last tile is done with shared memory
    attend_mma<kD>(
        q, ((long long)(b * decode_q + j0) * heads + kvh * group) * kD,
        heads * kD, kv, rows, kvh, min(per, decode_q - j0), group,
        qpos0 + j0, min(kv_len, W * page_size), s * sp.split_keys,
        (s + 1) * sp.split_keys, scale,
        TileOut{nullptr, sp.part_o + s * sp.nd * heads * kD,
                sp.part_ml + s * sp.nd * heads * 2,
                (long long)b * decode_q + j0, heads});
  }
}

constexpr int kMergeThreads = 128;  // 4 warps, one (query, head) each

// out[pair * kD ..] for pair = decode query * heads + head, from the
// partials of num_splits spans: the log-sum-exp merge O = sum_s O_s
// 2^(m_s - M) / sum_s l_s 2^(m_s - M) with M = max_s m_s, skipping empty
// spans; exact zeros where every span was empty.
template <int kD>
__global__ void __launch_bounds__(kMergeThreads) merge_splits_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    __nv_bfloat16* __restrict__ out, int n_pairs, int num_splits) {
  const int pair = blockIdx.x * (kMergeThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pair >= n_pairs) return;
  float big = -INFINITY;
  for (int s = 0; s < num_splits; ++s)
    big = fmaxf(big, part_ml[2 * ((long long)s * n_pairs + pair)]);
  constexpr int kPer = kD / 32;  // values per lane
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
      for (int c = 0; c < kPer; ++c) acc[c] += w * part_o[p * kD + lane + 32 * c];
    }
  }
  const float inv = denom > 0.f ? 1.f / denom : 0.f;
#pragma unroll
  for (int c = 0; c < kPer; ++c)
    out[(long long)pair * kD + lane + 32 * c] = __float2bfloat16(acc[c] * inv);
}

// The current device's SM count into num_sms: 0, or the CUDA error.
inline int num_sms_of_device(int* num_sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(num_sms, cudaDevAttrMultiProcessorCount,
                                 device);
  return (int)err;
}

// 0 where (split_keys, num_splits) is the plan of num_decode rows of kv
// heads over max_tok-key page lists on the current device, else the error
// to return: the entry points refuse a plan other than their own.
inline int check_split_plan(long long max_tok, int num_decode, int kv,
                            long long split_keys, int num_splits) {
  int num_sms = 0;
  const int err = num_sms_of_device(&num_sms);
  if (err != 0) return err;
  return split_keys == decode_split_keys(max_tok, num_decode, kv, num_sms)
                 && num_splits == decode_splits(max_tok, split_keys)
             ? 0
             : (int)cudaErrorInvalidValue;
}

// Merges n_pairs (query, head) rows of num_splits partials into out.
template <int kD>
inline int launch_merge(const Splits& sp, __nv_bfloat16* out, int n_pairs,
                        cudaStream_t stream) {
  constexpr int per_block = kMergeThreads / 32;
  merge_splits_kernel<kD><<<(n_pairs + per_block - 1) / per_block,
                            kMergeThreads, 0, stream>>>(
      sp.part_o, sp.part_ml, out, n_pairs, sp.num_splits);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The latent decode rows: decode.cu, and the decode and verify rows of
// ragged.cu, at head_dim 640 (decode_latent_kernel, merge_latent_kernel).
//
// Bound: bytes. A decode row reads each of its latent K and V rows once
// (2 x 1280 bytes a key in bf16, 2 x 768 in int8) and does ~1 FLOP per
// byte per query head. What the first latent tile (attend_latent) lost:
// spans of 256 keys sized for head_dim 128 left 45 of a phase-3 launch's
// 64 blocks without a key, 16-key tiles paid two or three barriers each
// and summed lane-quarter partial scores through shared memory, 12 of its
// 16 warps did no math on a decode row, and a verify window of 5 x 16 =
// 80 rows walked its span twice, one pass after the other. So:
// - a block is the latent tile's walk (latent_walk: 32-key tiles, S on
//   wgmma over all 640 lanes, P V on wgmma, two barriers a tile, int8
//   widened by the copying thread) over one query tile of a row (up to
//   64 / group positions, so a verify window of 5 x 16 rows is two query
//   tiles, 4 and 1 positions, whose blocks walk the same keys side by
//   side: the second read comes from L2) and one span of its keys;
// - the launch is planned on the host from host sizes only
//   (latent_decode_spans: n spans a row on average, as many as one wave
//   of blocks holds), so a captured decode or verify step replays at any
//   contexts; the spans are cut on the card from the rows' horizons
//   (min(q_start + decode_q, kv_len, W * page_size)): the n x rows spans
//   are shared out in proportion to the rows' keys (latent_span_keys: a
//   span of at most L keys, L a multiple of the 32-key tile chosen so
//   that every row's spans fit the budget), each row's horizon cut into
//   equal spans, so the longest block walks about its share of all the
//   keys, not a long row's 1/n (phase 3: 64 keys a block, not 128);
// - a row of one span writes its bf16 rows from the walk; the spans of a
//   longer row leave their unnormalized partials (O in f32, m, l) in
//   device scratch, and merge_latent_kernel folds each row's spans in a
//   fixed order (equal bits run to run; 8 or 4 threads per (query, head,
//   8 lanes), each folding every 8th or 4th span online, then combined).
//   A cluster could merge in distributed shared memory, as the chunk tile
//   does, but a cluster holds 8 blocks (16 at most), a 2048-key row needs
//   16 spans to keep its blocks within 128 keys, and the H100 holds 15
//   clusters of 8 at once (PERF.md), fewer of 16: 8 such rows would not
//   run in one wave.
constexpr int kLatentSpanKeys = 64;  // least keys a span, at the table's width
constexpr int kLatentMergeThreads = 128;
constexpr int kMaxSmThreads = 2048;  // resident threads an H100 SM holds

// Spans a row of num_decode latent decode rows of decode_q queries (query
// tiles of tile_positions(group) positions), KV heads, over page lists of
// max_keys keys, on num_sms SMs, on average: one wave of blocks (n x query
// tiles x rows x KV <= num_sms, at least one), and at most one span per
// kLatentSpanKeys keys of the table. The launch holds n x num_decode work
// items (spans) per query tile and KV head.
inline int latent_decode_spans(int num_decode, int decode_q, int group,
                               int KV, long long max_keys, int num_sms) {
  const int positions = tile_positions(group);
  const long long tiles = std::max(
      1LL, (long long)num_decode * ((decode_q + positions - 1) / positions)
               * KV);
  const long long most =
      std::max(1LL, (max_keys + kLatentSpanKeys - 1) / kLatentSpanKeys);
  return (int)std::max(1LL, std::min((long long)num_sms / tiles, most));
}

// The descriptors of the latent decode rows: row b's queries at q_start =
// q_starts[b] .. (or, without q_starts, decode.cu's one query at
// kv_lens[b] - 1) see keys below min(kv_lens[b], max_keys).
struct LatentRows {
  const int* __restrict__ kv_lens;
  const int* __restrict__ q_starts;
  int rows, decode_q, max_keys;
  __device__ __forceinline__ int q_start(int b) const {
    return q_starts ? q_starts[b] : kv_lens[b] - 1;
  }
  // the keys the row's last query sees
  __device__ __forceinline__ int horizon(int b) const {
    return max(0, min(q_start(b) + decode_q, min(kv_lens[b], max_keys)));
  }
};

// Keys a span may hold when `budget` spans are shared out over `rows` rows
// of `total` keys: a multiple of the 32-key tile with ceil(h / L) spans for
// a row of h keys (one for a row with none) within the budget, since
// sum ceil(h / L) <= total / L + rows; or every row one span where the
// budget is one a row.
__device__ __forceinline__ int latent_span_keys(long long total, int rows,
                                                int budget) {
  if (budget <= rows) return INT_MAX;
  const long long per = (total + budget - rows - 1) / (budget - rows);
  return (int)min((long long)INT_MAX,
                  max((long long)kChunkKeys,
                      (per + kChunkKeys - 1) / kChunkKeys * kChunkKeys));
}

__device__ __forceinline__ int latent_row_spans(int h, int span_keys) {
  return h == 0 || span_keys == INT_MAX ? 1 : (h + span_keys - 1) / span_keys;
}

// Where work item (span) w of the latent decode rows lies: its row b
// (-1 past the last item), its span s and the row's span count n, as every
// lane of a warp computes it from the descriptors (the same in every warp,
// so no barrier): the rows' horizons (the first 32 read once) summed, then
// the running count of their spans.
__device__ __forceinline__ void latent_item(const LatentRows& d, int budget,
                                            int w, int& b, int& s, int& n) {
  const int lane = threadIdx.x & 31;
  long long total = 0;
  const int h0 = lane < d.rows ? d.horizon(lane) : 0;
  for (int r0 = 0; r0 < d.rows; r0 += 32) {
    int h = r0 ? (r0 + lane < d.rows ? d.horizon(r0 + lane) : 0) : h0;
#pragma unroll
    for (int o = 16; o; o >>= 1) h += __shfl_xor_sync(0xffffffffu, h, o);
    total += h;
  }
  const int span_keys = latent_span_keys(total, d.rows, budget);
  b = -1;
  s = n = 0;
  int base = 0;
  for (int r0 = 0; r0 < d.rows; r0 += 32) {
    const int r = r0 + lane;
    const int h = r0 ? (r < d.rows ? d.horizon(r) : 0) : h0;
    const int k = r < d.rows ? latent_row_spans(h, span_keys) : 0;
    int incl = k;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    const int first = base + incl - k;
    const unsigned hit =
        __ballot_sync(0xffffffffu, k > 0 && w >= first && w < first + k);
    if (hit) {  // the same in every lane
      const int src = __ffs(hit) - 1;
      b = r0 + src;
      s = w - __shfl_sync(0xffffffffu, first, src);
      n = __shfl_sync(0xffffffffu, k, src);
    }
    base += __shfl_sync(0xffffffffu, incl, 31);
  }
}

// Block bx of the latent decode rows: query tile qt = bx % q_tiles of KV
// head kvh of work item w (bx = (w * KV + kvh) * q_tiles + qt), which is
// span s of row b's n (latent_item); a block past the last item exits.
// Queries and the output as in ragged_kernel (query j of row b, head h at
// ((b * decode_q + j) * H + h) * 640). A row of one span writes its bf16
// rows; otherwise the block writes its partial to slot bx of the scratch
// (slot_rows rows of 640 f32 at part_o, (m, l) at part_ml, row i * group +
// g for query j0 + i, head kvh * group + g), and the row's first block
// leaves (first item, spans) at row_plan[b] for the merge.
template <typename KVTiles>
__global__ void __launch_bounds__(kChunkThreads, 1) decode_latent_kernel(
    const __nv_bfloat16* __restrict__ q, KVTiles kv,
    const int* __restrict__ tables,  // [num_decode (+ 1), W]
    LatentRows d, int budget, __nv_bfloat16* __restrict__ out, int H,
    int KV, int page_size, int W, int lane_width, int positions, float scale,
    float* __restrict__ part_o, float* __restrict__ part_ml,
    int2* __restrict__ row_plan, int slot_rows) {
  constexpr int kD = kLatentDim;
  extern __shared__ __align__(16) char chunk_smem[];
  const unsigned smem0 = smem_u32(chunk_smem);
  char* base = chunk_smem + (((smem0 + 1023) & ~1023u) - smem0);
  const int q_tiles = (d.decode_q + positions - 1) / positions;
  const int qt = blockIdx.x % q_tiles;
  const int kvh = (blockIdx.x / q_tiles) % KV;
  const int w = blockIdx.x / q_tiles / KV;
  int b, s, n;
  latent_item(d, budget, w, b, s, n);
  if (b < 0) return;  // past the last span (the same for the whole block)
  if (row_plan && s == 0 && qt == 0 && kvh == 0 && threadIdx.x == 0)
    row_plan[b] = make_int2(w, n);
  const int group = H / KV;
  const int horizon = d.horizon(b);
  const int span = (horizon + n - 1) / n;
  const int lo = s * span, hi = min(lo + span, horizon);
  const int j0 = qt * positions, nq = min(positions, d.decode_q - j0);
  const int n_rows = nq * group;
  const long long first = (long long)b * d.decode_q + j0;  // its first query

  float o[kChunkLanes / 8][4], m[2], l[2];
  latent_walk(base, q, (first * H + kvh * group) * kD, H * kD, kv,
              PagedRows{tables + (long long)b * W, page_size, lane_width},
              kvh, n_rows, group, d.q_start(b) + j0, lo, hi, scale, o, m, l);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wrow = (warp & 3) * 16;
  const int quad = lane >> 2, pair = (lane & 3) * 2;
  const int d0 = wg * kChunkLanes + pair;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow + quad + 8 * h;
    if (r >= n_rows) continue;
    if (n == 1) {  // the row's only span: its bf16 rows (zeros if empty)
      const int i = r / group, g = r - i * group;
      const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
      __nv_bfloat16* orow = out + ((first + i) * H + kvh * group + g) * kD + d0;
#pragma unroll
      for (int j = 0; j < kChunkLanes / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
            __floats2bfloat162_rn(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
    } else {
      const long long p = (long long)blockIdx.x * slot_rows + r;
      float* orow = part_o + p * kD + d0;
#pragma unroll
      for (int j = 0; j < kChunkLanes / 8; ++j)
        *reinterpret_cast<float2*>(orow + j * 8) =
            make_float2(o[j][2 * h], o[j][2 * h + 1]);
      if (wg == 0 && pair == 0)
        *reinterpret_cast<float2*>(part_ml + 2 * p) = make_float2(m[h], l[h]);
    }
  }
}

// Rows of a partial slot of the latent decode rows: a query tile's rows.
inline int latent_slot_rows(int decode_q, int group) {
  return std::min(decode_q, tile_positions(group)) * group;
}

// (m, l, O over 8 lanes) of spans folded online: weights relative to the
// largest m so far; -inf m is a span that saw nothing
struct MergeAcc {
  float big = -INFINITY, denom = 0.f, acc[8] = {0.f, 0.f, 0.f, 0.f,
                                                  0.f, 0.f, 0.f, 0.f};
  __device__ __forceinline__ void add(float m, float l, const float* x) {
    if (m == -INFINITY) return;
    const float nb = fmaxf(big, m);
    const float a = exp2f(big - nb), wgt = exp2f(m - nb);  // a = 0 at first
    denom = denom * a + l * wgt;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = acc[e] * a + x[e] * wgt;
    big = nb;
  }
  // folds in the lane `lane_xor` away among the lanes of `lanes`
  // (commutative: both lanes get the same bits)
  __device__ __forceinline__ void combine(unsigned lanes, int lane_xor) {
    const float ob = __shfl_xor_sync(lanes, big, lane_xor);
    const float od = __shfl_xor_sync(lanes, denom, lane_xor);
    float ox[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      ox[e] = __shfl_xor_sync(lanes, acc[e], lane_xor);
    const float nb = fmaxf(big, ob);
    if (nb == -INFINITY) return;
    const float a = big == -INFINITY ? 0.f : exp2f(big - nb);
    const float oa = ob == -INFINITY ? 0.f : exp2f(ob - nb);
    denom = denom * a + od * oa;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = acc[e] * a + ox[e] * oa;
    big = nb;
  }
};

// The rows of more than one span: for each (decode query, head, 8 lanes)
// `lanes` threads (adjacent lanes, 4 or 8) fold every lanes-th of the
// row's spans' partials online, in span order, then combine in a fixed
// pattern, and the first writes the bf16 lanes: merge_splits_kernel's formula up to the
// order of its sums, equal bits run to run. Row b's spans are items
// row_plan[b].x .. + row_plan[b].y of the walk; rows of one span were
// written by their block. (static: every source that includes this header
// keeps its own copy, as the templates' instances are kept.)
static __global__ void __launch_bounds__(kLatentMergeThreads)
merge_latent_kernel(const float* __restrict__ part_o,
                    const float* __restrict__ part_ml,
                    const int2* __restrict__ row_plan,
                    __nv_bfloat16* __restrict__ out, int n_pairs,
                    int decode_q, int H, int KV, int positions,
                    int slot_rows, int lanes) {
  constexpr int kChunks = kLatentDim / 8;
  const long long task =
      (long long)blockIdx.x * kLatentMergeThreads + threadIdx.x;
  // the lanes of a (query, head, 8 lanes) leave or stay together
  if (task >= (long long)n_pairs * kChunks * lanes) return;
  const int part = (int)(task % lanes);
  const int c8 = (int)((task / lanes) % kChunks);
  const int pair = (int)(task / lanes / kChunks);  // query * H + head
  const int query = pair / H, head = pair - query * H;
  const int b = query / decode_q, j = query - b * decode_q;
  const int2 plan = __ldg(row_plan + b);
  if (plan.y == 1) return;
  const unsigned group_mask = ((1u << lanes) - 1) << (threadIdx.x & (32 - lanes));
  const int group = H / KV, kvh = head / group, g = head - kvh * group;
  const int q_tiles = (decode_q + positions - 1) / positions;
  const int qt = j / positions, r = (j - qt * positions) * group + g;
  MergeAcc acc;
#pragma unroll 4
  for (int s = part; s < plan.y; s += lanes) {
    const long long p =
        (((long long)(plan.x + s) * KV + kvh) * q_tiles + qt) * slot_rows + r;
    const float2 ml = __ldg(reinterpret_cast<const float2*>(part_ml + 2 * p));
    const float4* src =
        reinterpret_cast<const float4*>(part_o + p * kLatentDim + 8 * c8);
    const float4 x0 = __ldg(src), x1 = __ldg(src + 1);
    const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    acc.add(ml.x, ml.y, x);
  }
  for (int x = 1; x < lanes; x <<= 1) acc.combine(group_mask, x);
  if (part) return;
  const float inv = acc.denom > 0.f ? 1.f / acc.denom : 0.f;
  *reinterpret_cast<uint4*>(out + (long long)pair * kLatentDim + 8 * c8) =
      make_uint4(pack_bf16(acc.acc[0] * inv, acc.acc[1] * inv),
                 pack_bf16(acc.acc[2] * inv, acc.acc[3] * inv),
                 pack_bf16(acc.acc[4] * inv, acc.acc[5] * inv),
                 pack_bf16(acc.acc[6] * inv, acc.acc[7] * inv));
}

// merge_latent_kernel over num_decode rows of decode_q queries (see
// there) on a card of num_sms SMs: 8 threads per (query, head, 8 lanes)
// where they fit the card at once (the merge then waits on the loads of a
// long row's spans: phase 3's decode rows on an H100, 4.8 µs against 6.1
// with 4), 4 where 8 would not (it then waits on its instructions: phase
// 3's verify windows, 640 (query, head) pairs, 7.9 µs against 9.2 with 8).
inline int launch_latent_merge(const float* part_o, const float* part_ml,
                               const int2* row_plan, __nv_bfloat16* out,
                               int num_decode, int decode_q, int H, int KV,
                               int num_sms, cudaStream_t stream) {
  const int group = H / KV;
  const long long pairs = (long long)num_decode * decode_q * H;
  const long long tasks = pairs * (kLatentDim / 8);
  const int lanes = tasks * 8 <= (long long)num_sms * kMaxSmThreads ? 8 : 4;
  const long long blocks =
      (tasks * lanes + kLatentMergeThreads - 1) / kLatentMergeThreads;
  if (num_decode < 1 || pairs > INT_MAX || blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  merge_latent_kernel<<<(unsigned)blocks, kLatentMergeThreads, 0, stream>>>(
      part_o, part_ml, row_plan, out, (int)pairs, decode_q, H, KV,
      tile_positions(group), latent_slot_rows(decode_q, group), lanes);
  return (int)cudaGetLastError();
}

// 0 where (num_splits, split_keys) is the plan of num_decode latent decode
// rows of decode_q queries, GQA group, KV heads over max_keys-key tables
// on the current device (latent_decode_spans, split_keys 0), else the
// error to return: the entry points refuse a plan other than their own.
inline int check_latent_plan(int num_decode, int decode_q, int group, int KV,
                             long long max_keys, int num_splits,
                             long long split_keys) {
  int num_sms = 0;
  const int err = num_sms_of_device(&num_sms);
  if (err != 0) return err;
  return split_keys == 0
                 && num_splits == latent_decode_spans(num_decode, decode_q,
                                                      group, KV, max_keys,
                                                      num_sms)
             ? 0
             : (int)cudaErrorInvalidValue;
}

// The latent decode rows of decode.cu (q_starts == nullptr, decode_q = 1)
// and ragged.cu under a plan check_latent_plan accepted: decode_latent_kernel
// and, with more than one span a row, merge_latent_kernel, on one stream.
// q, out and tables start at row 0; the scratch holds num_splits x
// num_decode x KV x query tiles slots of latent_slot_rows rows (part_o),
// their (m, l) (part_ml), then the rows' plan (num_decode int2).
template <typename KVTiles>
int launch_latent_rows(const void* q, KVTiles kv, const void* tables,
                       const void* kv_lens, const void* q_starts, void* out,
                       void* part_o, void* part_ml, int num_decode,
                       int decode_q, int H, int KV, int page_size, int W,
                       int lane_width, int num_splits, float scale,
                       cudaStream_t stream) {
  const int group = H / KV, positions = tile_positions(group);
  if (num_splits > 1 && (part_o == nullptr || part_ml == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long budget = (long long)num_splits * num_decode;
  const long long blocks =
      budget * KV * ((decode_q + positions - 1) / positions);
  if (blocks > INT_MAX || (long long)W * page_size > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const LatentRows d{(const int*)kv_lens, (const int*)q_starts, num_decode,
                     decode_q, W * page_size};
  const int slot_rows = latent_slot_rows(decode_q, group);
  int2* row_plan = num_splits > 1
      ? reinterpret_cast<int2*>((float*)part_ml + 2 * blocks * slot_rows)
      : nullptr;
  auto kernel = decode_latent_kernel<KVTiles>;
  cudaError_t set = set_smem(kernel, ChunkSmem<KVTiles>::bytes);
  if (set != cudaSuccess) return (int)set;
  kernel<<<(unsigned)blocks, kChunkThreads, ChunkSmem<KVTiles>::bytes,
           stream>>>((const __nv_bfloat16*)q, kv, (const int*)tables, d,
                     (int)budget, (__nv_bfloat16*)out, H, KV, page_size, W,
                     lane_width, positions, scale, (float*)part_o,
                     (float*)part_ml, row_plan, slot_rows);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || num_splits == 1) return rc;
  int num_sms = 0;
  const int err = num_sms_of_device(&num_sms);
  if (err != 0) return err;
  return launch_latent_merge((const float*)part_o, (const float*)part_ml,
                             row_plan, (__nv_bfloat16*)out, num_decode,
                             decode_q, H, KV, num_sms, stream);
}

}  // namespace dtt
