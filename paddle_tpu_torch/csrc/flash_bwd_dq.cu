// Flash-attention backward, dQ, for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel _flash_bwd_dq_kernel of
// paddle_tpu/ops/pallas/flash_attention.py (:434, launched by _flash_bwd at
// :572 on the grid (B*H, T/bq, T_kv/bk) whose innermost kv axis carries the
// dQ sum in VMEM scratch). Here a thread block owns one (batch*head, 64-row
// q tile) and loops over the live kv tiles itself, so the sum stays in
// registers; no atomics, and the sum order is fixed.
//
// Semantics (FlashAttention-2, identical to the TPU kernel):
//   P  = exp(S - lse),  S = Q K^T * sm_scale, masked as the forward masks
//   dS = P o (dO V^T - Delta),  Delta = rowsum(dO o O) (computed by the caller)
//   dQ = dS K * sm_scale  (scaled once at the end, as :489 does)
// lse and Delta are f32 [B*H, T]; GQA query head h reads kv head h / (H/H_kv).
// Rows with no live key have lse ~ NEG_INF from the forward, so P is not 0
// there and their dQ is defined by the tiles this kernel visits; callers
// compare only rows that keep a live key.
//
// Two instantiations:
//   bf16 inputs: tensor-core mma.sync m16n8k16 (bf16 x bf16 -> f32). Four
//     warps of 16 q rows; Q and dO stay in registers as A operands, K, K^T
//     and V are staged per kv tile in shared memory; S, dP and dS are f32
//     accumulators and dS is rounded to bf16 as the A operand of dS K (the
//     TPU kernel keeps dS in f32). 64-key tiles, 32 at d=128 (registers).
//   f32 inputs (parity runs): plain FMA, four threads per q row.
//
// Bound on an H100 SXM at the training slice's shape (B=8, H=8, T=1024,
// d=64, bf16, causal): 6*d flops per live (q, k) pair (S, dP, dQ) over
// 33,587,200 pairs = 12.9 GFLOP, 13.0 us at 989 TFLOP/s; bytes: q, k, v, dO
// read once in bf16 (33.6 MB) plus lse and Delta (0.5 MB) and dQ written
// (8.4 MB) = 42.5 MB, 12.7 us at 3.35 TB/s. Operations bound it, by 3%.
//
// What this simple design leaves on the table (later work): mma.sync reaches
// well under the wgmma peak; K/V tiles are loaded synchronously (no cp.async
// or TMA pipeline, no double buffering); K^T is written through scalar
// shared-memory stores instead of ldmatrix.trans; blocks are not persistent
// and causal tiles are not ordered heaviest-first.

#include "flash_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B*H, T]
  const float* delta;  // [B*H, T]
  void* dq;
  const int* kv_len;  // [B] or null
  int B, H, H_kv, T, T_kv;
  int causal, window, q_off, k_off;  // window 0 = none
  float scale;                       // sm_scale
  float scale_log2;                  // sm_scale * log2(e)
};

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16_kernel(const Params p) {
  constexpr int BN = D == 128 ? 32 : 64;  // keys per kv tile
  constexpr int KSTEPS = D / 16;          // k-steps over the head dim
  constexpr int NT = BN / 8;              // 8-key n-tiles of S and dP
  constexpr int ND = D / 8;               // 8-dim n-tiles of dQ
  constexpr int KP = D + 8;               // padded K / V row
  constexpr int TP = BN + 8;              // padded K^T row
  __shared__ __align__(16) __nv_bfloat16 k_s[BN * KP];
  __shared__ __align__(16) __nv_bfloat16 v_s[BN * KP];
  __shared__ __align__(16) __nv_bfloat16 kt_s[D * TP];

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvbh = b * p.H_kv + h / (p.H / p.H_kv);
  const int q0 = blockIdx.y * kBlockM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q) + (size_t)bh * p.T * D;
  const __nv_bfloat16* dO = static_cast<const __nv_bfloat16*>(p.dout) + (size_t)bh * p.T * D;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(p.k) + (size_t)kvbh * p.T_kv * D;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(p.v) + (size_t)kvbh * p.T_kv * D;
  const int kv_limit = p.kv_len ? p.kv_len[b] : -1;

  // this thread's two q rows (fragment rows g and g + 8 of its warp's 16)
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  uint32_t qa[KSTEPS][4], da[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int c = ks * 16 + tg * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row[r] < p.T;
      const size_t o = (size_t)row[r] * D + c;
      qa[ks][r] = in ? ld32(Q + o) : 0u;
      qa[ks][r + 2] = in ? ld32(Q + o + 8) : 0u;
      da[ks][r] = in ? ld32(dO + o) : 0u;
      da[ks][r + 2] = in ? ld32(dO + o + 8) : 0u;
    }
  }
  // rows past T get lse = +inf: P, and so dS, is exactly 0 there
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < p.T;
    lse2[r] = in ? p.lse[(size_t)bh * p.T + row[r]] * kLog2e : INFINITY;
    dl[r] = in ? p.delta[(size_t)bh * p.T + row[r]] : 0.f;
  }

  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const int q_first = p.q_off + q0;
  const int q_last = p.q_off + min(q0 + kBlockM, p.T) - 1;
  int lo, hi;
  tile_range(p, q_first, q_last, kv_limit, BN, &lo, &hi);

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the previous tile's fragment reads are done
    for (int idx = tid; idx < BN * D / 8; idx += 128) {
      const int kr = idx / (D / 8), c8 = (idx % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + kr < p.T_kv) {
        kv = *reinterpret_cast<const uint4*>(K + (size_t)(k0 + kr) * D + c8);
        vv = *reinterpret_cast<const uint4*>(V + (size_t)(k0 + kr) * D + c8);
      }
      *reinterpret_cast<uint4*>(k_s + kr * KP + c8) = kv;
      *reinterpret_cast<uint4*>(v_s + kr * KP + c8) = vv;
      const __nv_bfloat16* ke = reinterpret_cast<const __nv_bfloat16*>(&kv);
#pragma unroll
      for (int i = 0; i < 8; ++i) kt_s[(c8 + i) * TP + kr] = ke[i];
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x BN keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      const __nv_bfloat16* kr = k_s + (nt * 8 + g) * KP + tg * 2;
      const __nv_bfloat16* vr = v_s + (nt * 8 + g) * KP + tg * 2;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        mma_bf16(s[nt], qa[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
        mma_bf16(dp[nt], da[ks], ld32(vr + ks * 16), ld32(vr + ks * 16 + 8));
      }
    }

    // dS = P o (dP - Delta), P = exp2(S * scale * log2e - lse * log2e)
    const bool all_live = tile_all_live(p, q_first, q_last, kv_limit, k0, BN);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[nt][c] * p.scale_log2;
        if (!all_live)
          x = mask_score(p, x, p.q_off + row[c >> 1], k0 + nt * 8 + tg * 2 + (c & 1),
                         kv_limit);
        s[nt][c] = exp2f(x - lse2[c >> 1]) * (dp[nt][c] - dl[c >> 1]);
      }

    // dQ += dS K: the dS fragments of key tiles 2kk, 2kk+1 form the A operand
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(s, kk, a);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* kt = kt_s + (n * 8 + g) * TP + kk * 16 + tg * 2;
        mma_bf16(dq[n], a, ld32(kt), ld32(kt + 8));
      }
    }
  }

  __nv_bfloat16* dQ = static_cast<__nv_bfloat16*>(p.dq) + (size_t)bh * p.T * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.T) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dQ + (size_t)row[r] * D + n * 8 + tg * 2) =
          pack_bf16(dq[n][2 * r] * p.scale, dq[n][2 * r + 1] * p.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(256) flash_bwd_dq_f32_kernel(const Params p) {
  constexpr int BN = 32;      // keys per kv tile
  constexpr int DPT = D / 4;  // dims per thread (4 threads per q row)
  __shared__ __align__(16) float k_s[BN * D];
  __shared__ __align__(16) float v_s[BN * D];

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvbh = b * p.H_kv + h / (p.H / p.H_kv);
  const int q0 = blockIdx.y * kBlockM;
  const int tid = threadIdx.x, part = tid & 3;
  const int row = q0 + (tid >> 2);
  const bool in = row < p.T;
  const float* Q = static_cast<const float*>(p.q) + (size_t)bh * p.T * D;
  const float* dO = static_cast<const float*>(p.dout) + (size_t)bh * p.T * D;
  const float* K = static_cast<const float*>(p.k) + (size_t)kvbh * p.T_kv * D;
  const float* V = static_cast<const float*>(p.v) + (size_t)kvbh * p.T_kv * D;
  const int kv_limit = p.kv_len ? p.kv_len[b] : -1;

  float q[DPT], d_o[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    q[i] = in ? Q[(size_t)row * D + part + 4 * i] : 0.f;
    d_o[i] = in ? dO[(size_t)row * D + part + 4 * i] : 0.f;
    acc[i] = 0.f;
  }
  const float lse2 = in ? p.lse[(size_t)bh * p.T + row] * kLog2e : INFINITY;
  const float dl = in ? p.delta[(size_t)bh * p.T + row] : 0.f;

  const int q_first = p.q_off + q0;
  const int q_last = p.q_off + min(q0 + kBlockM, p.T) - 1;
  int lo, hi;
  tile_range(p, q_first, q_last, kv_limit, BN, &lo, &hi);

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BN;
    __syncthreads();
    for (int idx = tid; idx < BN * D / 4; idx += 256) {
      const int kr = idx / (D / 4), c4 = (idx % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + kr < p.T_kv) {
        kv = *reinterpret_cast<const float4*>(K + (size_t)(k0 + kr) * D + c4);
        vv = *reinterpret_cast<const float4*>(V + (size_t)(k0 + kr) * D + c4);
      }
      *reinterpret_cast<float4*>(k_s + kr * D + c4) = kv;
      *reinterpret_cast<float4*>(v_s + kr * D + c4) = vv;
    }
    __syncthreads();
    for (int kk = 0; kk < BN; ++kk) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        s += q[i] * k_s[kk * D + part + 4 * i];
        dp += d_o[i] * v_s[kk * D + part + 4 * i];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      s = mask_score(p, s * p.scale_log2, p.q_off + row, k0 + kk, kv_limit);
      const float ds = exp2f(s - lse2) * (dp - dl);
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += ds * k_s[kk * D + part + 4 * i];
    }
  }

  if (in) {
    float* dQ = static_cast<float*>(p.dq) + (size_t)bh * p.T * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) dQ[(size_t)row * D + part + 4 * i] = acc[i] * p.scale;
  }
}

template <int D>
cudaError_t launch(const Params& p, bool bf16, cudaStream_t stream) {
  const dim3 grid(p.B * p.H, (p.T + kBlockM - 1) / kBlockM);
  if (bf16)
    flash_bwd_dq_bf16_kernel<D><<<grid, 128, 0, stream>>>(p);
  else
    flash_bwd_dq_f32_kernel<D><<<grid, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, dout [B*H, T, d], k/v [B*H_kv, T_kv, d] contiguous, bf16 (is_bf16=1) or
// f32; lse, delta [B*H, T] f32; dq like q; kv_len [B] int32 or null.
// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq,
                            const int* kv_len, int B, int H, int H_kv, int T, int T_kv,
                            int d, int is_bf16, int causal, int window, int q_off,
                            int k_off, float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || H_kv <= 0 || H % H_kv || T <= 0 || T_kv <= 0 ||
      (T + kBlockM - 1) / kBlockM > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q,      k,      v,     dout,  lse,   delta,   dq,
                 kv_len, B,      H,     H_kv,  T,     T_kv,    causal,
                 window, q_off,  k_off, sm_scale, sm_scale * kLog2e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return (int)launch<32>(p, is_bf16 != 0, s);
    case 64: return (int)launch<64>(p, is_bf16 != 0, s);
    case 128: return (int)launch<128>(p, is_bf16 != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
