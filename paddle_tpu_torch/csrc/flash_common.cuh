// Shared pieces of the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dkv.cu, flash_bwd_dq.cu): the masking semantics of
// paddle_tpu/ops/pallas/flash_attention.py and the bf16 tensor-core helpers.
//
// Masks act on GLOBAL positions q_off + i / k_off + j: causal (top-left
// aligned, q_pos >= k_pos), sliding window (q_pos - k_pos < window, causal
// only) and per-batch kv_len (k_pos < kv_len[b]). Masked scores take the
// finite NEG_INF = -1e9 of core/dtypes.py; keys past T_kv (the ragged edge of
// the last tile) score -inf and add exactly nothing.
//
// The helpers are templates over the kernel's parameter struct, which must
// have the fields T, T_kv, causal, window, q_off, k_off.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1.0e9f;  // core/dtypes.py NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInfLog2 = kNegInf * kLog2e;  // NEG_INF in log2 units
constexpr int kBlockM = 64;                      // q rows per forward / dQ block

// Kv tiles [*lo, *hi) that hold a live key for q rows at global positions
// [q_first, q_last] — the loop bounds of _flash_fwd_kernel_resident.
template <class P>
__device__ __forceinline__ void tile_range(const P& p, int q_first, int q_last,
                                           int kv_limit, int bn, int* lo, int* hi) {
  int h = (p.T_kv + bn - 1) / bn;
  if (p.causal) {
    int need = max(0, q_last - p.k_off + 1);  // local key idx < need
    h = min(h, (need + bn - 1) / bn);
  }
  if (kv_limit >= 0) {
    int need = max(0, kv_limit - p.k_off);
    h = min(h, (need + bn - 1) / bn);
  }
  int l = 0;
  if (p.window > 0) {
    int first = q_first - p.k_off - (p.window - 1);
    l = first > 0 ? first / bn : 0;
  }
  *lo = l;
  *hi = h;
}

// Q tiles [*lo, *hi) of size br that hold a live query for keys at global
// positions [k_first, k_last] — the skip conditions of _flash_bwd_dkv_kernel
// turned into loop bounds.
template <class P>
__device__ __forceinline__ void q_tile_range(const P& p, int k_first, int k_last,
                                             int kv_limit, int br, int* lo, int* hi) {
  int h = (p.T + br - 1) / br;
  int l = 0;
  if (kv_limit >= 0 && k_first >= kv_limit) h = 0;
  if (p.causal) {
    const int need = k_first - p.q_off;  // local q idx >= need sees a key
    if (need > 0) l = need / br;
    if (p.window > 0) {
      const int lim = k_last + p.window - 1 - p.q_off;  // local q idx <= lim
      h = lim < 0 ? 0 : min(h, lim / br + 1);
    }
  }
  *lo = l;
  *hi = h;
}

// True when every key of tile [k0, k0 + bn) is live for every q row in
// [q_first, q_last]: the tile then needs no per-element mask.
template <class P>
__device__ __forceinline__ bool tile_all_live(const P& p, int q_first, int q_last,
                                              int kv_limit, int k0, int bn) {
  if (k0 + bn > p.T_kv) return false;
  int k_first = p.k_off + k0, k_last = k_first + bn - 1;
  if (p.causal) {
    if (k_last > q_first) return false;
    if (p.window > 0 && q_last - k_first >= p.window) return false;
  }
  if (kv_limit >= 0 && k_last >= kv_limit) return false;
  return true;
}

// Score s (log2 units) of q row at global position q_pos against local key k_idx.
template <class P>
__device__ __forceinline__ float mask_score(const P& p, float s, int q_pos, int k_idx,
                                            int kv_limit) {
  if (k_idx >= p.T_kv) return -INFINITY;
  int k_pos = p.k_off + k_idx;
  if (p.causal) {
    if (q_pos < k_pos) return kNegInfLog2;
    if (p.window > 0 && q_pos - k_pos >= p.window) return kNegInfLog2;
  }
  if (kv_limit >= 0 && k_pos >= kv_limit) return kNegInfLog2;
  return s;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[0..3] += A(16x16 bf16, row) * B(16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A operand (16x16, row-major) of an m16n8k16 product from an
// accumulator tile pair: the f32 fragments s[2kk], s[2kk+1] of a 16-row
// product whose columns are this product's k dimension, rounded to bf16
// (the FlashAttention-2 register reuse: P and dS never touch shared memory).
__device__ __forceinline__ void acc_to_a(const float (*s)[4], int kk, uint32_t* a) {
  a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// The A operand of rows [r0, r0 + 16), columns [c0, c0 + 16) of a row-major
// bf16 tile in shared memory with row pitch `pitch` (elements).
__device__ __forceinline__ void smem_a(const __nv_bfloat16* t, int pitch, int r0, int c0,
                                       int g, int tg, uint32_t* a) {
  const __nv_bfloat16* lo = t + (r0 + g) * pitch + c0 + tg * 2;
  const __nv_bfloat16* hi = lo + 8 * pitch;
  a[0] = ld32(lo);
  a[1] = ld32(hi);
  a[2] = ld32(lo + 8);
  a[3] = ld32(hi + 8);
}

}  // namespace flash
