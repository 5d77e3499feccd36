// Flash-attention backward, dK and dV, for NVIDIA Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel _flash_bwd_dkv_kernel of
// paddle_tpu/ops/pallas/flash_attention.py (:362, launched by _flash_bwd at
// :543 on the grid (B*H_kv, T_kv/bk, group*n_qb) whose innermost axis streams
// every q tile of every query head in the kv head's GQA group, carrying dK
// and dV in VMEM scratch). Here a thread block owns one (batch*kv head,
// 64-key tile) and loops over group x q tiles itself (the TPU kernel's qrow
// mapping, :530), so both sums stay in registers; no atomics, and the sum
// order is fixed. The loop bounds are the TPU kernel's skip conditions
// (causal, window, kv_len at global offsets): dead q tiles are never visited.
//
// Semantics (FlashAttention-2, identical to the TPU kernel):
//   P  = exp(S - lse),  S = Q K^T * sm_scale, masked as the forward masks
//   dV += P^T dO
//   dS = P o (dO V^T - Delta),  Delta = rowsum(dO o O) (computed by the caller)
//   dK += dS^T Q * sm_scale
//
// Two instantiations:
//   bf16 inputs: tensor-core mma.sync m16n8k16 (bf16 x bf16 -> f32). Four
//     warps of 16 keys each compute the TRANSPOSED products S^T = K Q^T and
//     dP^T = V dO^T, so that P^T and dS^T come out of the accumulators with
//     keys as rows and feed dV += P^T dO and dK += dS^T Q straight from
//     registers as A operands (rounded to bf16; the TPU kernel keeps them in
//     f32). K and V sit in shared memory for the whole block; each q tile
//     is staged as Q, dO (row-major, the B operands of S^T and dP^T) and
//     Q^T, dO^T (the B operands of dK and dV). 64 q rows a step, 32 at
//     d=128 (registers: dK and dV alone hold 2 x 16 x d f32 per warp).
//   f32 inputs (parity runs): plain FMA, four threads per key.
//
// Bound on an H100 SXM at the training slice's shape (B=8, H=8, T=1024,
// d=64, bf16, causal): 8*d flops per live (q, k) pair (S, dP, dV, dK) over
// 33,587,200 pairs = 17.2 GFLOP, 17.4 us at 989 TFLOP/s; bytes: q, k, v, dO
// read once in bf16 (33.6 MB) plus lse and Delta (0.5 MB) and dK, dV written
// (16.8 MB) = 50.9 MB, 15.2 us at 3.35 TB/s. Operations bound it.
//
// What this simple design leaves on the table (later work): mma.sync reaches
// well under the wgmma peak; Q/dO tiles are loaded synchronously (no
// cp.async or TMA pipeline, no double buffering); Q^T and dO^T are written
// through scalar shared-memory stores instead of ldmatrix.trans; blocks are
// not persistent and causal tiles are not ordered heaviest-first.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockN = 64;  // keys per block

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B*H, T]
  const float* delta;  // [B*H, T]
  void* dk;
  void* dv;
  const int* kv_len;  // [B] or null
  int B, H, H_kv, T, T_kv;
  int causal, window, q_off, k_off;  // window 0 = none
  float scale;                       // sm_scale
  float scale_log2;                  // sm_scale * log2(e)
};

template <int D>
struct Bf16Tiles {
  static constexpr int BR = D == 128 ? 32 : 64;  // q rows per step
  static constexpr int RP = D + 8;               // padded row of K, V, Q, dO
  static constexpr int TP = BR + 8;              // padded row of Q^T, dO^T
  static constexpr size_t kSmemBytes =
      (size_t)(2 * kBlockN * RP + 2 * BR * RP + 2 * D * TP) * sizeof(__nv_bfloat16) +
      2 * BR * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16_kernel(const Params p) {
  using Tiles = Bf16Tiles<D>;
  constexpr int BR = Tiles::BR, RP = Tiles::RP, TP = Tiles::TP;
  constexpr int KSTEPS = D / 16;  // k-steps over the head dim
  constexpr int NQ = BR / 8;      // 8-row n-tiles of S^T and dP^T
  constexpr int ND = D / 8;       // 8-dim n-tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][RP]
  __nv_bfloat16* v_s = k_s + kBlockN * RP;                        // [64][RP]
  __nv_bfloat16* q_s = v_s + kBlockN * RP;                        // [BR][RP]
  __nv_bfloat16* do_s = q_s + BR * RP;                            // [BR][RP]
  __nv_bfloat16* qt_s = do_s + BR * RP;                           // [D][TP]
  __nv_bfloat16* dot_s = qt_s + D * TP;                           // [D][TP]
  float* lse_s = reinterpret_cast<float*>(dot_s + D * TP);        // [BR], log2 units
  float* dl_s = lse_s + BR;                                       // [BR]

  const int r = blockIdx.x;  // combined (batch, kv head) row
  const int b = r / p.H_kv, hk = r % p.H_kv;
  const int group = p.H / p.H_kv;
  const int k0 = blockIdx.y * kBlockN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int kw = warp * 16;  // this warp's first key within the tile
  const int kv_limit = p.kv_len ? p.kv_len[b] : -1;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(p.k) + (size_t)r * p.T_kv * D;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(p.v) + (size_t)r * p.T_kv * D;

  for (int idx = tid; idx < kBlockN * D / 8; idx += 128) {
    const int kr = idx / (D / 8), c8 = (idx % (D / 8)) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (k0 + kr < p.T_kv) {
      kv = *reinterpret_cast<const uint4*>(K + (size_t)(k0 + kr) * D + c8);
      vv = *reinterpret_cast<const uint4*>(V + (size_t)(k0 + kr) * D + c8);
    }
    *reinterpret_cast<uint4*>(k_s + kr * RP + c8) = kv;
    *reinterpret_cast<uint4*>(v_s + kr * RP + c8) = vv;
  }

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;

  const int k_first = p.k_off + k0;
  const int k_last = p.k_off + min(k0 + kBlockN, p.T_kv) - 1;
  int lo, hi;
  q_tile_range(p, k_first, k_last, kv_limit, BR, &lo, &hi);

  for (int gi = 0; gi < group; ++gi) {
    const size_t bh = (size_t)b * p.H + hk * group + gi;  // the TPU kernel's qrow
    const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q) + bh * p.T * D;
    const __nv_bfloat16* dO = static_cast<const __nv_bfloat16*>(p.dout) + bh * p.T * D;
    const float* lse = p.lse + bh * p.T;
    const float* delta = p.delta + bh * p.T;
    for (int i = lo; i < hi; ++i) {
      const int qs0 = i * BR;
      __syncthreads();  // the previous step's fragment reads are done
      for (int idx = tid; idx < BR * D / 8; idx += 128) {
        const int qr = idx / (D / 8), c8 = (idx % (D / 8)) * 8;
        uint4 qv = make_uint4(0u, 0u, 0u, 0u), ov = qv;
        if (qs0 + qr < p.T) {
          qv = *reinterpret_cast<const uint4*>(Q + (size_t)(qs0 + qr) * D + c8);
          ov = *reinterpret_cast<const uint4*>(dO + (size_t)(qs0 + qr) * D + c8);
        }
        *reinterpret_cast<uint4*>(q_s + qr * RP + c8) = qv;
        *reinterpret_cast<uint4*>(do_s + qr * RP + c8) = ov;
        const __nv_bfloat16* qe = reinterpret_cast<const __nv_bfloat16*>(&qv);
        const __nv_bfloat16* oe = reinterpret_cast<const __nv_bfloat16*>(&ov);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          qt_s[(c8 + e) * TP + qr] = qe[e];
          dot_s[(c8 + e) * TP + qr] = oe[e];
        }
      }
      // rows past T get lse = +inf: their P, and so dS, is exactly 0
      for (int idx = tid; idx < BR; idx += 128) {
        const bool in = qs0 + idx < p.T;
        lse_s[idx] = in ? lse[qs0 + idx] * kLog2e : INFINITY;
        dl_s[idx] = in ? delta[qs0 + idx] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BR q rows
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[nt][c] = dpt[nt][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t ka[4], va[4];
        smem_a(k_s, RP, kw, ks * 16, g, tg, ka);
        smem_a(v_s, RP, kw, ks * 16, g, tg, va);
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
          const __nv_bfloat16* qr = q_s + (nt * 8 + g) * RP + ks * 16 + tg * 2;
          const __nv_bfloat16* orow = do_s + (nt * 8 + g) * RP + ks * 16 + tg * 2;
          mma_bf16(st[nt], ka, ld32(qr), ld32(qr + 8));
          mma_bf16(dpt[nt], va, ld32(orow), ld32(orow + 8));
        }
      }

      // P^T = exp2(S^T * scale * log2e - lse * log2e); dS^T = P^T o (dP^T - Delta)
      const int q_first = p.q_off + qs0;
      const int q_last = p.q_off + min(qs0 + BR, p.T) - 1;
      const bool all_live = tile_all_live(p, q_first, q_last, kv_limit, k0, kBlockN);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = nt * 8 + tg * 2 + (c & 1);
          float x = st[nt][c] * p.scale_log2;
          if (!all_live)
            x = mask_score(p, x, q_first + qi, k0 + kw + g + (c >> 1) * 8, kv_limit);
          const float pr = exp2f(x - lse_s[qi]);
          st[nt][c] = pr;
          dpt[nt][c] = pr * (dpt[nt][c] - dl_s[qi]);
        }

      // dV += P^T dO and dK += dS^T Q: A operands straight from registers
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk) {
        uint32_t pa[4], sa[4];
        acc_to_a(st, kk, pa);
        acc_to_a(dpt, kk, sa);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const __nv_bfloat16* ot = dot_s + (n * 8 + g) * TP + kk * 16 + tg * 2;
          const __nv_bfloat16* qt = qt_s + (n * 8 + g) * TP + kk * 16 + tg * 2;
          mma_bf16(dv[n], pa, ld32(ot), ld32(ot + 8));
          mma_bf16(dk[n], sa, ld32(qt), ld32(qt + 8));
        }
      }
    }
  }

  __nv_bfloat16* dK = static_cast<__nv_bfloat16*>(p.dk) + (size_t)r * p.T_kv * D;
  __nv_bfloat16* dV = static_cast<__nv_bfloat16*>(p.dv) + (size_t)r * p.T_kv * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = k0 + kw + g + rr * 8;
    if (key >= p.T_kv) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const size_t o = (size_t)key * D + n * 8 + tg * 2;
      *reinterpret_cast<uint32_t*>(dK + o) =
          pack_bf16(dk[n][2 * rr] * p.scale, dk[n][2 * rr + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dV + o) = pack_bf16(dv[n][2 * rr], dv[n][2 * rr + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256) flash_bwd_dkv_f32_kernel(const Params p) {
  constexpr int BR = 32;      // q rows per step
  constexpr int DPT = D / 4;  // dims per thread (4 threads per key)
  __shared__ __align__(16) float q_s[BR * D];
  __shared__ __align__(16) float do_s[BR * D];
  __shared__ float lse_s[BR];
  __shared__ float dl_s[BR];

  const int r = blockIdx.x;
  const int b = r / p.H_kv, hk = r % p.H_kv;
  const int group = p.H / p.H_kv;
  const int k0 = blockIdx.y * kBlockN;
  const int tid = threadIdx.x, part = tid & 3;
  const int key = k0 + (tid >> 2);
  const bool in = key < p.T_kv;
  const int kv_limit = p.kv_len ? p.kv_len[b] : -1;
  const float* K = static_cast<const float*>(p.k) + (size_t)r * p.T_kv * D;
  const float* V = static_cast<const float*>(p.v) + (size_t)r * p.T_kv * D;

  float kr[DPT], vr[DPT], dk[DPT], dv[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    kr[i] = in ? K[(size_t)key * D + part + 4 * i] : 0.f;
    vr[i] = in ? V[(size_t)key * D + part + 4 * i] : 0.f;
    dk[i] = dv[i] = 0.f;
  }

  const int k_first = p.k_off + k0;
  const int k_last = p.k_off + min(k0 + kBlockN, p.T_kv) - 1;
  int lo, hi;
  q_tile_range(p, k_first, k_last, kv_limit, BR, &lo, &hi);

  for (int gi = 0; gi < group; ++gi) {
    const size_t bh = (size_t)b * p.H + hk * group + gi;
    const float* Q = static_cast<const float*>(p.q) + bh * p.T * D;
    const float* dO = static_cast<const float*>(p.dout) + bh * p.T * D;
    for (int i = lo; i < hi; ++i) {
      const int qs0 = i * BR;
      __syncthreads();
      for (int idx = tid; idx < BR * D / 4; idx += 256) {
        const int qr = idx / (D / 4), c4 = (idx % (D / 4)) * 4;
        float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), ov = qv;
        if (qs0 + qr < p.T) {
          qv = *reinterpret_cast<const float4*>(Q + (size_t)(qs0 + qr) * D + c4);
          ov = *reinterpret_cast<const float4*>(dO + (size_t)(qs0 + qr) * D + c4);
        }
        *reinterpret_cast<float4*>(q_s + qr * D + c4) = qv;
        *reinterpret_cast<float4*>(do_s + qr * D + c4) = ov;
      }
      for (int idx = tid; idx < BR; idx += 256) {
        const bool q_in = qs0 + idx < p.T;
        lse_s[idx] = q_in ? p.lse[bh * p.T + qs0 + idx] * kLog2e : INFINITY;
        dl_s[idx] = q_in ? p.delta[bh * p.T + qs0 + idx] : 0.f;
      }
      __syncthreads();
      for (int qq = 0; qq < BR; ++qq) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          s += q_s[qq * D + part + 4 * i] * kr[i];
          dp += do_s[qq * D + part + 4 * i] * vr[i];
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 2);
        s = mask_score(p, s * p.scale_log2, p.q_off + qs0 + qq, key, kv_limit);
        const float pr = exp2f(s - lse_s[qq]);
        const float ds = pr * (dp - dl_s[qq]);
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          dv[i] += pr * do_s[qq * D + part + 4 * i];
          dk[i] += ds * q_s[qq * D + part + 4 * i];
        }
      }
    }
  }

  if (in) {
    float* dK = static_cast<float*>(p.dk) + (size_t)r * p.T_kv * D;
    float* dV = static_cast<float*>(p.dv) + (size_t)r * p.T_kv * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dK[(size_t)key * D + part + 4 * i] = dk[i] * p.scale;
      dV[(size_t)key * D + part + 4 * i] = dv[i];
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, bool bf16, cudaStream_t stream) {
  const dim3 grid(p.B * p.H_kv, (p.T_kv + kBlockN - 1) / kBlockN);
  if (bf16) {
    constexpr size_t smem = Bf16Tiles<D>::kSmemBytes;
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    flash_bwd_dkv_bf16_kernel<D><<<grid, 128, smem, stream>>>(p);
  } else {
    flash_bwd_dkv_f32_kernel<D><<<grid, 256, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// q, dout [B*H, T, d], k/v [B*H_kv, T_kv, d] contiguous, bf16 (is_bf16=1) or
// f32; lse, delta [B*H, T] f32; dk/dv like k; kv_len [B] int32 or null.
// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv,
                             const int* kv_len, int B, int H, int H_kv, int T, int T_kv,
                             int d, int is_bf16, int causal, int window, int q_off,
                             int k_off, float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || H_kv <= 0 || H % H_kv || T <= 0 || T_kv <= 0 ||
      (T_kv + kBlockN - 1) / kBlockN > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q,      k,     v,     dout,  lse,   delta,  dk,
                 dv,     kv_len, B,    H,     H_kv,  T,      T_kv,
                 causal, window, q_off, k_off, sm_scale, sm_scale * kLog2e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return (int)launch<32>(p, is_bf16 != 0, s);
    case 64: return (int)launch<64>(p, is_bf16 != 0, s);
    case 128: return (int)launch<128>(p, is_bf16 != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
