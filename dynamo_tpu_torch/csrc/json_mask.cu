// JSON grammar mask and state advance for guided decoding on Hopper (sm_90a).
//
// Beside the TPU kernels: it ports no Pallas kernel. The JAX package builds
// the allowed-token mask inside its jitted decode window
// (dynamo_tpu/engine/engine.py make_decode_window: json_guide.token_mask
// before sampling, json_guide.fold_bytes of the sampled token after), where
// XLA fuses the vectorised automaton (dynamo_tpu/ops/json_guide.py
// transition: ~100 elementwise where/compare/shift ops per byte, up to 16
// bytes per token) into one loop over [B, V]. Written as plain PyTorch that
// is thousands of kernels per decode step, so the port runs it here:
//
//   json_mask    one thread per (row, token): fold the token's bytes from the
//                row's state (mode, depth, bits); where the token is not
//                allowed, write -1e9 into the row's logits, in place. Rows
//                whose `active` byte is 0 (not guided) are left alone.
//   json_advance one thread per row: fold the row's sampled token through the
//                automaton and store the new state, in place, active rows
//                only.
//
// Both read only device memory (the state [B] int32, the vocab table:
// token_bytes uint8 [V, 16] zero-padded, token_len int32 [V], eos uint8
// [V]), allocate nothing and launch on the caller's stream, so they run
// inside the captured decode step (engine/decode_graphs.py).
//
// Semantics are json_guide.transition's exactly, including the int32 stack:
// bit `depth` is (int)(1u << depth), so depth 31 sets INT_MIN as numpy's int32
// shift does (a signed 1 << 31 would be undefined in C++); a shift past 31
// gives 0, as numpy's does. A token with token_len 0 (specials, stop tokens)
// is never allowed mid-JSON; at completion (AFTER_VALUE at depth 0) stop
// tokens are allowed and nothing else is.
//
// Bound on the H100: the work is data-dependent integer control flow. A
// thread walks its token's bytes only until the automaton dies (most tokens
// die at their first byte outside a string), each byte one switch over the
// 38 modes (~10-20 integer operations on the taken path, where the JAX
// version evaluates every mode's expression). The bytes are the table (2.6 MB
// at V = 128256: one 16-byte load per token, coalesced), the state and the
// masked logits; at B = 8 that is a few microseconds of HBM time, and the
// operations bound is below it, so the kernel is bound by bytes and by its
// launch. Design: nothing is staged in shared memory (each table row is read
// once per row of the batch; the table stays in the 50 MB L2 across the rows
// and steps), one block of 256 threads per (256 tokens, row), so a warp's 32
// tokens diverge only in how many bytes they fold.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtt {
namespace json {

enum : int {
  START = 0, VALUE = 1, OBJ_KEY_OR_END = 2, OBJ_KEY = 3, AFTER_KEY = 4,
  AFTER_VALUE = 5, ARR_VAL_OR_END = 6, STR_V = 7, ESC_V = 8, U1_V = 9,
  U2_V = 10, U3_V = 11, U4_V = 12, STR_K = 13, ESC_K = 14, U1_K = 15,
  U2_K = 16, U3_K = 17, U4_K = 18, NM_MINUS = 19, NM_Z = 20, NM_INT = 21,
  NM_FRAC0 = 22, NM_FRAC = 23, NM_EXP0 = 24, NM_EXPS = 25, NM_EXP = 26,
  T1 = 27, T2 = 28, T3 = 29, F1 = 30, F2 = 31, F3 = 32, F4 = 33, N1 = 34,
  N2 = 35, N3 = 36, DEAD = 37
};
constexpr int kMaxDepth = 31;
constexpr int kWidth = 16;  // bytes per token row of the table
constexpr int kThreads = 256;

struct State {
  int mode, depth, bits;
};

__device__ __forceinline__ int bit_at(int depth) {
  return (depth >= 0 && depth < 32) ? (int)(1u << depth) : 0;
}

__device__ __forceinline__ bool is_ws(int c) {
  return c == 32 || c == 9 || c == 10 || c == 13;
}
__device__ __forceinline__ bool is_digit(int c) { return c >= 48 && c <= 57; }
__device__ __forceinline__ bool is_hex(int c) {
  const int lo = c | 32;
  return is_digit(c) || (lo >= 97 && lo <= 102);
}
__device__ __forceinline__ bool is_e(int c) { return c == 101 || c == 69; }

// a value's first byte: '{' '[' (if the stack has room) '"' '-' digit t f n
__device__ __forceinline__ State value_start(State s, int c) {
  const bool can_push = s.depth < kMaxDepth;
  if ((c == 123 || c == 91) && can_push) {
    const int b = bit_at(s.depth);
    return {c == 123 ? OBJ_KEY_OR_END : ARR_VAL_OR_END, s.depth + 1,
            c == 91 ? (s.bits | b) : (s.bits & ~b)};
  }
  int m = DEAD;
  if (c == 34) m = STR_V;
  else if (c == 45) m = NM_MINUS;
  else if (c == 48) m = NM_Z;
  else if (c >= 49 && c <= 57) m = NM_INT;
  else if (c == 116) m = T1;
  else if (c == 102) m = F1;
  else if (c == 110) m = N1;
  return {m, s.depth, s.bits};
}

// the byte after a complete value: whitespace, ',' or its container's close;
// at depth 0 the object is complete and no byte is legal
__device__ __forceinline__ State after_value(State s, int c) {
  if (s.depth == 0) return {DEAD, s.depth, s.bits};
  if (is_ws(c)) return {AFTER_VALUE, s.depth, s.bits};
  const bool top_is_arr = (((unsigned)s.bits >> (s.depth - 1)) & 1u) != 0;
  if (c == 44) return {top_is_arr ? VALUE : OBJ_KEY, s.depth, s.bits};
  if ((c == 125 && !top_is_arr) || (c == 93 && top_is_arr))
    return {AFTER_VALUE, s.depth - 1, s.bits};
  return {DEAD, s.depth, s.bits};
}

// a number state: its continuation `cont`, else the byte ends the number
__device__ __forceinline__ State number(State s, int c, int cont) {
  return cont != DEAD ? State{cont, s.depth, s.bits} : after_value(s, c);
}

__device__ __forceinline__ int in_string(int c, int body, int esc,
                                         int close_to) {
  if (c == 34) return close_to;
  if (c == 92) return esc;
  return (c >= 32) ? body : DEAD;
}

__device__ __forceinline__ int escape(int c, int body, int u1) {
  if (c == 117) return u1;
  const bool ok = c == 34 || c == 92 || c == 47 || c == 98 || c == 102 ||
                  c == 110 || c == 114 || c == 116;
  return ok ? body : DEAD;
}

// json_guide.transition for one state and byte c
__device__ State transition(State s, int c) {
  State n{DEAD, s.depth, s.bits};
  switch (s.mode) {
    case START:
      n = c == 123 ? State{OBJ_KEY_OR_END, s.depth + 1,
                           s.bits & ~bit_at(s.depth)}
                   : n;
      break;
    case VALUE:
      n = is_ws(c) ? State{VALUE, s.depth, s.bits} : value_start(s, c);
      break;
    case OBJ_KEY_OR_END:
      if (is_ws(c)) n.mode = OBJ_KEY_OR_END;
      else if (c == 34) n.mode = STR_K;
      else if (c == 125 && s.depth > 0) n = {AFTER_VALUE, s.depth - 1, s.bits};
      break;
    case OBJ_KEY:
      n.mode = is_ws(c) ? OBJ_KEY : (c == 34 ? STR_K : DEAD);
      break;
    case AFTER_KEY:
      n.mode = is_ws(c) ? AFTER_KEY : (c == 58 ? VALUE : DEAD);
      break;
    case AFTER_VALUE:
      n = after_value(s, c);
      break;
    case ARR_VAL_OR_END:
      if (is_ws(c)) n.mode = ARR_VAL_OR_END;
      else if (c == 93 && s.depth > 0) n = {AFTER_VALUE, s.depth - 1, s.bits};
      else n = value_start(s, c);
      break;
    case STR_V: n.mode = in_string(c, STR_V, ESC_V, AFTER_VALUE); break;
    case ESC_V: n.mode = escape(c, STR_V, U1_V); break;
    case U1_V: n.mode = is_hex(c) ? U2_V : DEAD; break;
    case U2_V: n.mode = is_hex(c) ? U3_V : DEAD; break;
    case U3_V: n.mode = is_hex(c) ? U4_V : DEAD; break;
    case U4_V: n.mode = is_hex(c) ? STR_V : DEAD; break;
    case STR_K: n.mode = in_string(c, STR_K, ESC_K, AFTER_KEY); break;
    case ESC_K: n.mode = escape(c, STR_K, U1_K); break;
    case U1_K: n.mode = is_hex(c) ? U2_K : DEAD; break;
    case U2_K: n.mode = is_hex(c) ? U3_K : DEAD; break;
    case U3_K: n.mode = is_hex(c) ? U4_K : DEAD; break;
    case U4_K: n.mode = is_hex(c) ? STR_K : DEAD; break;
    case NM_MINUS:
      n.mode = c == 48 ? NM_Z : ((c >= 49 && c <= 57) ? NM_INT : DEAD);
      break;
    case NM_Z:
      n = number(s, c, c == 46 ? NM_FRAC0 : (is_e(c) ? NM_EXP0 : DEAD));
      break;
    case NM_INT:
      n = number(s, c, is_digit(c) ? NM_INT
                       : c == 46   ? NM_FRAC0
                       : is_e(c)   ? NM_EXP0
                                   : DEAD);
      break;
    case NM_FRAC0: n.mode = is_digit(c) ? NM_FRAC : DEAD; break;
    case NM_FRAC:
      n = number(s, c, is_digit(c) ? NM_FRAC : (is_e(c) ? NM_EXP0 : DEAD));
      break;
    case NM_EXP0:
      n.mode = is_digit(c) ? NM_EXP : ((c == 43 || c == 45) ? NM_EXPS : DEAD);
      break;
    case NM_EXPS: n.mode = is_digit(c) ? NM_EXP : DEAD; break;
    case NM_EXP: n = number(s, c, is_digit(c) ? NM_EXP : DEAD); break;
    case T1: n.mode = c == 114 ? T2 : DEAD; break;
    case T2: n.mode = c == 117 ? T3 : DEAD; break;
    case T3: n.mode = c == 101 ? AFTER_VALUE : DEAD; break;
    case F1: n.mode = c == 97 ? F2 : DEAD; break;
    case F2: n.mode = c == 108 ? F3 : DEAD; break;
    case F3: n.mode = c == 115 ? F4 : DEAD; break;
    case F4: n.mode = c == 101 ? AFTER_VALUE : DEAD; break;
    case N1: n.mode = c == 117 ? N2 : DEAD; break;
    case N2: n.mode = c == 108 ? N3 : DEAD; break;
    case N3: n.mode = c == 108 ? AFTER_VALUE : DEAD; break;
    default: break;  // DEAD, or a mode outside the automaton
  }
  // DEAD absorbs; depth and bits freeze there
  if (n.mode == DEAD) n = {DEAD, s.depth, s.bits};
  return n;
}

// fold `len` bytes of one table row; false if a byte kills the automaton
// (DEAD absorbs, so stopping there leaves the same state as folding on)
__device__ __forceinline__ bool fold(State& s, const uint8_t* __restrict__ tb,
                                     long long tok, int len) {
  const uint4 raw = *reinterpret_cast<const uint4*>(tb + tok * kWidth);
  const uint8_t* row = reinterpret_cast<const uint8_t*>(&raw);
  len = len < kWidth ? len : kWidth;
  for (int i = 0; i < len; ++i) {
    s = transition(s, row[i]);
    if (s.mode == DEAD) return false;
  }
  return true;
}

template <typename T>
__device__ __forceinline__ T masked();
template <>
__device__ __forceinline__ float masked<float>() { return -1e9f; }
template <>
__device__ __forceinline__ __nv_bfloat16 masked<__nv_bfloat16>() {
  return __float2bfloat16(-1e9f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) json_mask_kernel(
    T* __restrict__ logits,  // [B, V], masked in place
    const int* __restrict__ mode, const int* __restrict__ depth,
    const int* __restrict__ bits,          // [B]
    const uint8_t* __restrict__ active,    // [B]
    const uint8_t* __restrict__ tb,        // [V, kWidth]
    const int* __restrict__ tl,            // [V]
    const uint8_t* __restrict__ eos,       // [V]
    int V) {
  const int r = blockIdx.y;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= V || !active[r]) return;
  State s{mode[r], depth[r], bits[r]};
  const bool stop = eos[v] != 0;
  bool allowed;
  if (s.mode == AFTER_VALUE && s.depth == 0) {
    allowed = stop;  // complete: only a stop token may follow
  } else {
    const int len = tl[v];
    allowed = !stop && len > 0 && fold(s, tb, v, len);
  }
  if (!allowed) logits[(long long)r * V + v] = masked<T>();
}

__global__ void __launch_bounds__(kThreads) json_advance_kernel(
    const long long* __restrict__ tokens,  // [B] sampled ids
    int* __restrict__ mode, int* __restrict__ depth,
    int* __restrict__ bits,                // [B], advanced in place
    const uint8_t* __restrict__ active,    // [B]
    const uint8_t* __restrict__ tb, const int* __restrict__ tl, int B,
    int V) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= B || !active[r]) return;
  long long tok = tokens[r];
  tok = tok < 0 ? 0 : (tok >= V ? V - 1 : tok);  // the plain version's clamp
  State s{mode[r], depth[r], bits[r]};
  fold(s, tb, tok, tl[tok]);
  mode[r] = s.mode;
  depth[r] = s.depth;
  bits[r] = s.bits;
}

}  // namespace json
}  // namespace dtt

// logits_bf16: 1 for bf16 logits, 0 for float32
extern "C" int dtt_json_mask(void* logits, int logits_bf16, const void* mode,
                             const void* depth, const void* bits,
                             const void* active, const void* token_bytes,
                             const void* token_len, const void* eos, int B,
                             int V, void* stream) {
  using namespace dtt::json;
  if (B < 1 || B > 65535 || V < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((V + kThreads - 1) / kThreads, B);
  cudaStream_t st = (cudaStream_t)stream;
  const int *m = (const int*)mode, *d = (const int*)depth,
            *b = (const int*)bits;
  const uint8_t *a = (const uint8_t*)active, *tb = (const uint8_t*)token_bytes,
                *e = (const uint8_t*)eos;
  const int* tl = (const int*)token_len;
  if (logits_bf16)
    json_mask_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (__nv_bfloat16*)logits, m, d, b, a, tb, tl, e, V);
  else
    json_mask_kernel<float><<<grid, kThreads, 0, st>>>(
        (float*)logits, m, d, b, a, tb, tl, e, V);
  return (int)cudaGetLastError();
}

extern "C" int dtt_json_advance(const void* tokens, void* mode, void* depth,
                                void* bits, const void* active,
                                const void* token_bytes, const void* token_len,
                                int B, int V, void* stream) {
  using namespace dtt::json;
  if (B < 1 || V < 1) return (int)cudaErrorInvalidValue;
  json_advance_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const long long*)tokens, (int*)mode, (int*)depth, (int*)bits,
      (const uint8_t*)active, (const uint8_t*)token_bytes,
      (const int*)token_len, B, V);
  return (int)cudaGetLastError();
}
