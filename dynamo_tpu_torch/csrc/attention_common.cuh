// Shared device code of the port's attention kernels (decode.cu, prefill.cu,
// chunk.cu, ragged.cu): `attend_mma`, the tensor-core query tile all four
// run, its K/V policies, and the split decode rows of decode.cu and
// ragged.cu (`decode_split_block`, `merge_splits_kernel`).
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
// attend_latent below instead of attend_mma
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
// attend_latent: the query tile at head_dim 640, MLA's latent row.
//
// The same contract as attend_mma (rows r = i * group + g of one KV head,
// the general mask, zeros for a row that sees no key, bf16 rows or the
// split partial), for the one shape that attend_mma cannot hold: at
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

  if (lo >= hi) {  // no key in range: zeros, or an empty partial
    for (int idx = tid; idx < n_rows * kD; idx += kLatentThreads) {
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
    if (dst.out) {
      const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
      __nv_bfloat16* orow =
          dst.out + q_off + (long long)i * q_row_stride + g * kD + d0;
#pragma unroll
      for (int j = 0; j < kQ / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + pair) =
            __floats2bfloat162_rn(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
    } else {
      const long long pp = (dst.part_q0 + i) * dst.heads + kvh * group + g;
      float* orow = dst.part_o + pp * kD + d0;
#pragma unroll
      for (int j = 0; j < kQ / 8; ++j)
        *reinterpret_cast<float2*>(orow + j * 8 + pair) =
            make_float2(o[j][2 * h], o[j][2 * h + 1]);
      if (dq == 0 && pair == 0) {
        dst.part_ml[2 * pp] = m[h];
        dst.part_ml[2 * pp + 1] = l[h];
      }
    }
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
// Split decode rows (decode.cu, and the decode rows of ragged.cu).
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
  const int b = bx / sp.num_splits, s = bx - b * sp.num_splits;
  const int kv_len = kv_lens[b];
  const int qpos0 = q_starts ? q_starts[b] : kv_len - 1;
  const PagedRows rows{tables + (long long)b * W, page_size, lane_width};
  // the row's queries in passes of the tile's positions: one pass, except
  // for the latent tile's verify windows (5 x 16 rows at group 16)
  const int per = kTileRows / group;
  for (int j0 = 0; j0 < decode_q; j0 += per) {
    if (j0) __syncthreads();  // the last pass is done with shared memory
    attend<kD>(q, ((long long)(b * decode_q + j0) * heads + kvh * group) * kD,
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

// 0 where (split_keys, num_splits) is the plan of num_decode rows of kv
// heads over max_tok-key page lists on the current device, else the error
// to return: the entry points refuse a plan other than their own.
inline int check_split_plan(long long max_tok, int num_decode, int kv,
                            long long split_keys, int num_splits) {
  int device = 0, num_sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
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

}  // namespace dtt
