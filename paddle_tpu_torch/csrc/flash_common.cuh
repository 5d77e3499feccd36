// Shared pieces of the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dkv.cu, flash_bwd_dq.cu): the masking semantics of
// paddle_tpu/ops/pallas/flash_attention.py, the softmax exponent, and the
// conversion of a wgmma accumulator into a register A operand (the wgmma,
// TMA and mbarrier PTX of the bf16 kernels is in hopper.cuh).
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
constexpr int kBlockM = 64;                      // q rows per f32 block (forward, dQ)

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

// mask_score for a whole row of a tile at once: the live keys of the q row
// at global position q_pos among the tile's local columns [0, bn) at local
// key k0 are [lo, hi); columns >= end lie past T_kv. A column c then scores
// c >= end ? -inf : (lo <= c < hi ? s : NEG_INF), as mask_score does.
struct RowLimits {
  int lo, hi, end;
};

template <class P>
__device__ __forceinline__ RowLimits row_limits(const P& p, int q_pos, int k0, int bn,
                                                int kv_limit) {
  const int base = p.k_off + k0;  // global position of column 0
  int lo = 0, hi = bn;
  if (p.causal) {
    hi = min(hi, q_pos - base + 1);
    if (p.window > 0) lo = q_pos - p.window + 1 - base;
  }
  if (kv_limit >= 0) hi = min(hi, kv_limit - base);
  return {lo, hi, p.T_kv - k0};
}

// The same for a key row of a transposed tile (S^T): the live q columns of
// the key at local index k_idx among local q rows [q0, q0 + br) are
// [lo, hi); a key past T_kv scores -inf in every column (end = 0).
template <class P>
__device__ __forceinline__ RowLimits key_limits(const P& p, int k_idx, int q0, int br,
                                                int kv_limit) {
  if (k_idx >= p.T_kv) return {0, 0, 0};
  const int k_pos = p.k_off + k_idx, base = p.q_off + q0;  // global q position of column 0
  int lo = 0, hi = br;
  if (p.causal) {
    lo = k_pos - base;
    if (p.window > 0) hi = min(hi, k_pos + p.window - base);
  }
  if (kv_limit >= 0 && k_pos >= kv_limit) hi = lo;
  return {lo, hi, br};
}

__device__ __forceinline__ float apply_limits(const RowLimits& r, int c, float s) {
  return c >= r.end ? -INFINITY : (c >= r.lo && c < r.hi ? s : kNegInfLog2);
}

// 2^x on the special-function unit (ex2.approx, flushing denormals to 0):
// the softmax exponent of the Hopper kernels, whose P is rounded to bf16.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of the next product (its k dimension = the accumulator's
// columns), rounded to bf16, from an m64nN wgmma accumulator d[4 * (N / 8)]
// (hopper.cuh): P and dS never touch shared memory (FlashAttention-2's
// register reuse). k-step kk reads accumulator columns [16kk, 16kk + 16).
__device__ __forceinline__ void wgmma_acc_to_a(const float* s, int kk, uint32_t* a) {
  a[0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

}  // namespace flash
