// Flash-attention backward, dK and dV, for NVIDIA Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel _flash_bwd_dkv_kernel of
// paddle_tpu/ops/pallas/flash_attention.py (:362, launched by _flash_bwd at
// :543 on the grid (B*H_kv, T_kv/bk, group*n_qb) whose innermost axis streams
// every q tile of every query head in the kv head's GQA group, carrying dK
// and dV in VMEM scratch). Here a thread block owns one (batch*kv head, key
// tile) and loops over group x q tiles itself (the TPU kernel's qrow
// mapping, :530), so both sums stay in registers; no atomics, and the sum
// order is fixed. The loop bounds are the TPU kernel's skip conditions
// (causal, window, kv_len at global offsets): dead q tiles are never visited.
//
// Semantics (FlashAttention-2, identical to the TPU kernel):
//   P  = exp(S - lse),  S = Q K^T * sm_scale, masked as the forward masks
//   dV += P^T dO
//   dS = P o (dO V^T - Delta),  Delta = rowsum(dO o O) (computed by the caller)
//   dK += dS^T Q * sm_scale
// Rows with no live key have lse ~ NEG_INF from the forward, which depends on
// the forward's q tiling; callers compare only rows that keep a live key.
//
// Bound on an H100 SXM at the training slice's shape (B=8, H=8, T=1024,
// d=64, bf16, causal): 8*d flops per live (q, k) pair (S, dP, dV, dK) over
// 33,587,200 pairs = 17.2 GFLOP, 17.4 us at 989 TFLOP/s; bytes: q, k, v, dO
// read once in bf16 (33.6 MB) plus lse and Delta (0.5 MB) and dK, dV written
// (16.8 MB) = 50.9 MB, 15.2 us at 3.35 TB/s. Operations bound it, so the
// design's job is to keep the tensor cores busy: wgmma, and Q/dO tiles that
// arrive while the previous step computes.
//
// Two instantiations:
//   bf16 inputs (the training path): warp-specialised wgmma. A block of 384
//     threads owns 128 keys: two consumer warpgroups of 64 keys each and a
//     producer warpgroup, one thread of which issues every TMA load; the
//     producer warpgroup gives its registers to the consumers (setmaxnreg,
//     168 -> 40 and 168 -> 232). K and V are loaded once and stay
//     resident. Q and dO tiles of 64 q rows stream through a 2-stage ring
//     (3-D tensor maps over [B*H, T, d], so the zero fill stops at each
//     head's T; 128-byte swizzle, 64-byte at d=32, and a d=128 row is two
//     64-column boxes); the producer's other lanes write the step's lse
//     (+inf past T, so those rows add exactly 0) and Delta into the same
//     stage. Each stage has a "full" mbarrier (the TMA bytes and the 32
//     lanes' arrivals) and an "empty" one (one arrival per consumer
//     warpgroup). Each consumer warpgroup computes the TRANSPOSED products
//     S^T = K Q^T and dP^T = V dO^T with wgmma from shared memory (Q and dO
//     row-major are K-major for B), so that P^T and dS^T come out of the
//     accumulators with keys as rows and feed dV += P^T dO and dK += dS^T Q
//     from registers as A operands (rounded to bf16; the TPU kernel keeps
//     them in f32; dP and Delta stay f32), with dO and Q read straight from
//     their row-major tiles through wgmma's transpose-B flag: no transposed
//     copies are written. At d=128 two blocks share a key tile, each
//     summing one 64-column half of dK and dV (both recompute S^T and dP^T):
//     dK and dV of all 128 columns are 128 f32 per thread, and ptxas spills
//     them even with the consumers at 232 registers. The elementwise pass
//     is instantiated twice, with and without masks, so that an unmasked
//     step runs no per-element branch. Causal key tiles with the most live
//     q tiles have the lowest grid y index, so they start first.
//   f32 inputs (parity runs): plain FMA, four threads per key, 64 keys a
//     block.
//
// What bounds it at the slice shape (H100, chip_smoke.py): not the tensor
// cores. A step (64 keys x 64 q rows per warpgroup) is one dependent chain
// (wait, S^T and dP^T, the elementwise pass, dV and dK), one block per SM,
// and the elementwise pass (64 exp2 on the special-function unit, the masks,
// dS) is the longest link. What the design leaves on the table (later
// work): the next step's S^T and dP^T in flight during this step's
// elementwise pass (registers), a persistent grid, dK and dV through shared
// memory and a TMA store, FP8.

#include "flash_common.cuh"
#include "hopper.cuh"


namespace {

using namespace flash;
using namespace hopper;

constexpr int kBlockN = 64;  // keys per f32 block

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

// The bf16 kernel's tiling at head dim D.
template <int D>
struct Bf16Tiles {
  static constexpr int BN = 128;                 // keys per block: 2 warpgroups x 64
  static constexpr int BR = 64;                  // q rows per step
  static constexpr int STAGES = 2;               // depth of the Q/dO ring
  static constexpr int BOX_W = D < 64 ? D : 64;  // columns per TMA box: one swizzle row
  static constexpr int ROW_B = 2 * BOX_W;        // bytes per box row
  static constexpr int NBOX = D / BOX_W;         // boxes across the head dim
  // dK/dV columns a block sums: at d=128 two blocks share a key tile, one
  // 64-column box each (registers: dK and dV of all 128 columns would be
  // 128 f32 per thread), and both recompute S^T and dP^T
  static constexpr int D_ACC = BOX_W;
  static constexpr int NSPLIT = D / D_ACC;
  static constexpr int KV_BYTES = BN * D * 2;    // K or V
  static constexpr int QT_BYTES = BR * D * 2;    // one Q or dO tile
  // a stage: Q, dO, then lse and Delta (2 * BR f32), padded to the atom
  static constexpr int STAGE_BYTES = 2 * QT_BYTES + 1024;
  static constexpr int BAR_OFF = 2 * KV_BYTES + STAGES * STAGE_BYTES;
  // barriers: K/V full, then full[STAGES], empty[STAGES]; plus 1 KB of
  // slack to align the tiles to the 1024-byte swizzle atom
  static constexpr size_t kSmemBytes = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

constexpr int kConsumerThreads = 256;             // two warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // and one producer warpgroup

struct TmaArgs {
  CUtensorMap q, k, v, dout;  // 3-D maps over [B*H, T, d] and [B*H_kv, T_kv, d]
  Params p;
};

// P^T = exp2(S^T * scale * log2e - lse * log2e) and dS^T = P^T o (dP^T -
// Delta) in place of S^T (st) and dP^T (dpt), keys as rows and BR q
// columns, lse and Delta of the step's q rows in shared memory. MASKED
// applies each key row's limits (a separate instantiation: a per-element
// branch on a runtime flag costs more than the products).
template <int BR, bool MASKED>
__device__ __forceinline__ void elementwise(float* st, float* dpt, const float* lse_s,
                                            const float* dl_s, const RowLimits* lim,
                                            float scale_log2, int tg) {
#pragma unroll
  for (int nt = 0; nt < BR / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qi = nt * 8 + tg * 2 + (c & 1);
      float x = st[4 * nt + c] * scale_log2;
      if (MASKED) x = apply_limits(lim[c >> 1], qi, x);
      const float pr = fast_exp2(fmaf(-lse_s[qi], kLog2e, x));
      st[4 * nt + c] = pr;
      dpt[4 * nt + c] = pr * (dpt[4 * nt + c] - dl_s[qi]);
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ TmaArgs a) {
  using Tl = Bf16Tiles<D>;
  constexpr int BN = Tl::BN, BR = Tl::BR, STAGES = Tl::STAGES;
  constexpr int BOX_W = Tl::BOX_W, ROW_B = Tl::ROW_B, NBOX = Tl::NBOX;
  const Params& p = a.p;
  extern __shared__ uint8_t smem[];
  const uint32_t k_s = (smem_u32(smem) + 1023) & ~1023u;  // [NBOX][BN][BOX_W]
  const uint32_t v_s = k_s + Tl::KV_BYTES;                // likewise
  const uint32_t st0 = v_s + Tl::KV_BYTES;                // stage s at st0 + s * STAGE_BYTES
  const uint32_t kv_full = k_s + Tl::BAR_OFF;
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * STAGES;  // + 8 * stage

  const int r = blockIdx.x;  // combined (batch, kv head) row
  const int b = r / p.H_kv, hk = r % p.H_kv;
  const int group = p.H / p.H_kv;
  const int k0 = blockIdx.y / Tl::NSPLIT * BN;
  const int xh = blockIdx.y % Tl::NSPLIT;  // which box of dK/dV columns
  const int kv_limit = p.kv_len ? p.kv_len[b] : -1;
  int lo, hi;
  q_tile_range(p, p.k_off + k0, p.k_off + min(k0 + BN, p.T_kv) - 1, kv_limit, BR, &lo, &hi);
  const int n_q = max(hi - lo, 0), steps = group * n_q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 33);
      mbar_init(empty0 + 8 * s, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's role, made warp-uniform for the compiler
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == kConsumerThreads / 128) {
    // producer warpgroup: its first warp works (lane 0 issues the TMA loads,
    // every lane stages lse and Delta); all four give registers to the
    // consumers
    setmaxnreg_dec<40>();
    if (warp != kConsumerThreads / 32) return;
    if (lane == 0 && steps > 0) {
      mbar_arrive_expect_tx(kv_full, 2 * Tl::KV_BYTES);
      for (int x = 0; x < NBOX; ++x) {
        tma_load_3d(k_s + x * BN * ROW_B, &a.k, kv_full, x * BOX_W, k0, r);
        tma_load_3d(v_s + x * BN * ROW_B, &a.v, kv_full, x * BOX_W, k0, r);
      }
    }
    for (int n = 0; n < steps; ++n) {
      const int s = n % STAGES, qs0 = (lo + n % n_q) * BR;
      const size_t bh = (size_t)b * p.H + hk * group + n / n_q;  // the TPU kernel's qrow
      const uint32_t st = st0 + s * Tl::STAGE_BYTES, full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, ((n / STAGES) & 1) ^ 1);
      if (lane == 0) {  // the copies first: their latency hides the loads below
        mbar_arrive_expect_tx(full, 2 * Tl::QT_BYTES);
        for (int x = 0; x < NBOX; ++x) {
          tma_load_3d(st + x * BR * ROW_B, &a.q, full, x * BOX_W, qs0, (int)bh);
          tma_load_3d(st + Tl::QT_BYTES + x * BR * ROW_B, &a.dout, full, x * BOX_W, qs0, (int)bh);
        }
      }
      // rows past T get lse = +inf: their P, and so dS, is exactly 0
      float* lse_s = reinterpret_cast<float*>(smem + (st + 2 * Tl::QT_BYTES - smem_u32(smem)));
      for (int i = lane; i < BR; i += 32) {
        const bool in = qs0 + i < p.T;
        lse_s[i] = in ? p.lse[bh * p.T + qs0 + i] : INFINITY;
        lse_s[BR + i] = in ? p.delta[bh * p.T + qs0 + i] : 0.f;
      }
      mbar_arrive(full);  // with lane 0's expect_tx: 33 arrivals
    }
  } else {
    // consumer warpgroup wg: keys [k0 + 64 wg, k0 + 64 wg + 64)
    setmaxnreg_inc<232>();
    const int wg = role;
    const int g = lane >> 2, tg = lane & 3;  // accumulator row group / column pair
    const int kw0 = k0 + wg * 64;
    const int key = kw0 + (warp & 3) * 16 + g;  // this thread's keys: key, key + 8
    const uint32_t k_w = k_s + wg * 64 * ROW_B, v_w = v_s + wg * 64 * ROW_B;

    float dk[Tl::D_ACC / 2], dv[Tl::D_ACC / 2];
#pragma unroll
    for (int i = 0; i < Tl::D_ACC / 2; ++i) dk[i] = dv[i] = 0.f;
    if (steps > 0) mbar_wait(kv_full, 0);

    for (int n = 0; n < steps; ++n) {
      const int s = n % STAGES, qs0 = (lo + n % n_q) * BR;
      const uint32_t q_t = st0 + s * Tl::STAGE_BYTES, do_t = q_t + Tl::QT_BYTES;
      const float* lse_s =
          reinterpret_cast<const float*>(smem + (do_t + Tl::QT_BYTES - smem_u32(smem)));
      const float* dl_s = lse_s + BR;
      mbar_wait(full0 + 8 * s, (n / STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x BR q rows, from shared memory
      float st[BR / 2], dpt[BR / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int x = kk * 16 / BOX_W;               // box
        const uint32_t off = (kk * 16 % BOX_W) * 2;  // bytes into its rows
        wgmma_ss<BR>(st, wgmma_desc(k_w + x * BN * ROW_B + off, 16, ROW_B),
                     wgmma_desc(q_t + x * BR * ROW_B + off, 16, ROW_B), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int x = kk * 16 / BOX_W;
        const uint32_t off = (kk * 16 % BOX_W) * 2;
        wgmma_ss<BR>(dpt, wgmma_desc(v_w + x * BN * ROW_B + off, 16, ROW_B),
                     wgmma_desc(do_t + x * BR * ROW_B + off, 16, ROW_B), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BR / 2>(st);
      fence_regs<BR / 2>(dpt);

      // P^T = exp2(S^T * scale * log2e - lse * log2e); dS^T = P^T o (dP^T - Delta)
      const int q_first = p.q_off + qs0;
      const int q_last = p.q_off + min(qs0 + BR, p.T) - 1;
      const bool all_live = tile_all_live(p, q_first, q_last, kv_limit, kw0, 64);
      if (all_live) {
        elementwise<BR, false>(st, dpt, lse_s, dl_s, nullptr, p.scale_log2, tg);
      } else {
        const RowLimits lim[2] = {key_limits(p, key, qs0, BR, kv_limit),
                                  key_limits(p, key + 8, qs0, BR, kv_limit)};
        elementwise<BR, true>(st, dpt, lse_s, dl_s, lim, p.scale_log2, tg);
      }

      // dV += P^T dO and dK += dS^T Q: A from registers, dO and Q MN-major
      // through the transpose flag
      uint32_t pa[BR / 16][4], sa[BR / 16][4];
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk) {
        wgmma_acc_to_a(st, kk, pa[kk]);
        wgmma_acc_to_a(dpt, kk, sa[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk) {
        const uint32_t off = xh * BR * ROW_B + kk * 16 * ROW_B;  // this block's box
        wgmma_rs_t<BOX_W>(dv, pa[kk], wgmma_desc(do_t + off, BR * ROW_B, ROW_B), 1);
        wgmma_rs_t<BOX_W>(dk, sa[kk], wgmma_desc(q_t + off, BR * ROW_B, ROW_B), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<Tl::D_ACC / 2>(dk);
      fence_regs<Tl::D_ACC / 2>(dv);
      if ((threadIdx.x & 127) == 0) mbar_arrive(empty0 + 8 * s);  // the stage is free
    }

    __nv_bfloat16* dK = static_cast<__nv_bfloat16*>(p.dk) + (size_t)r * p.T_kv * D;
    __nv_bfloat16* dV = static_cast<__nv_bfloat16*>(p.dv) + (size_t)r * p.T_kv * D;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int kr = key + rr * 8;
      if (kr >= p.T_kv) continue;
#pragma unroll
      for (int nd = 0; nd < Tl::D_ACC / 8; ++nd) {
        const size_t o = (size_t)kr * D + xh * Tl::D_ACC + nd * 8 + tg * 2;
        *reinterpret_cast<uint32_t*>(dK + o) =
            pack_bf16(dk[4 * nd + 2 * rr] * p.scale, dk[4 * nd + 2 * rr + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dV + o) = pack_bf16(dv[4 * nd + 2 * rr], dv[4 * nd + 2 * rr + 1]);
      }
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

// The TMA descriptors of a->p's q, dO, k and v (built per call: they hold
// the data pointers).
template <int D>
bool encode_maps(TmaArgs* a) {
  using Tl = Bf16Tiles<D>;
  const Params& p = a->p;
  return encode_rows_map(&a->q, p.q, p.B * p.H, p.T, D, Tl::BR) &&
         encode_rows_map(&a->dout, p.dout, p.B * p.H, p.T, D, Tl::BR) &&
         encode_rows_map(&a->k, p.k, p.B * p.H_kv, p.T_kv, D, Tl::BN) &&
         encode_rows_map(&a->v, p.v, p.B * p.H_kv, p.T_kv, D, Tl::BN);
}

template <int D>
cudaError_t launch(const Params& p, bool bf16, cudaStream_t stream) {
  if (bf16) {
    using Tl = Bf16Tiles<D>;
    TmaArgs a;
    a.p = p;
    if (!encode_maps<D>(&a)) return cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::kSmemBytes);
    if (e != cudaSuccess) return e;
    const dim3 grid(p.B * p.H_kv, (p.T_kv + Tl::BN - 1) / Tl::BN * Tl::NSPLIT);
    flash_bwd_dkv_bf16_kernel<D><<<grid, kThreads, Tl::kSmemBytes, stream>>>(a);
  } else {
    const dim3 grid(p.B * p.H_kv, (p.T_kv + kBlockN - 1) / kBlockN);
    flash_bwd_dkv_f32_kernel<D><<<grid, 256, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// q, dout [B*H, T, d], k/v [B*H_kv, T_kv, d] contiguous, bf16 (is_bf16=1) or
// f32; lse, delta [B*H, T] f32; dk/dv like k; kv_len [B] int32 or null.
// Launches on `stream` and returns the launch's cudaError_t (0 = success;
// bf16 inputs whose TMA descriptors cannot be encoded return
// cudaErrorInvalidValue).
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
