// Flash-attention backward, dQ, for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel _flash_bwd_dq_kernel of
// paddle_tpu/ops/pallas/flash_attention.py (:434, launched by _flash_bwd at
// :572 on the grid (B*H, T/bq, T_kv/bk) whose innermost kv axis carries the
// dQ sum in VMEM scratch). Here a thread block owns one (batch*head, q tile)
// and loops over the live kv tiles itself, so the sum stays in registers; no
// atomics, and the sum order is fixed.
//
// Semantics (FlashAttention-2, identical to the TPU kernel):
//   P  = exp(S - lse),  S = Q K^T * sm_scale, masked as the forward masks
//   dS = P o (dO V^T - Delta),  Delta = rowsum(dO o O) (computed by the caller)
//   dQ = dS K * sm_scale  (scaled once at the end, as :489 does)
// lse and Delta are f32 [B*H, T]; GQA query head h reads kv head h / (H/H_kv).
// lse and Delta are known per row, so no row max is taken and no
// accumulator is rescaled: any sm_scale works as it is. Rows with no live key
// have lse ~ NEG_INF from the forward, so P is not 0 there and their dQ is
// defined by the tiles this kernel visits; callers compare only rows that
// keep a live key.
//
// Bound on an H100 SXM at the training slice's shape (B=8, H=8, T=1024,
// d=64, bf16, causal): 6*d flops per live (q, k) pair (S, dP, dQ) over
// 33,587,200 pairs = 12.9 GFLOP, 13.0 us at 989 TFLOP/s; bytes: q, k, v, dO
// read once in bf16 (33.6 MB) plus lse and Delta (0.5 MB) and dQ written
// (8.4 MB) = 42.5 MB, 12.7 us at 3.35 TB/s. Operations bound it, by 3%, so
// the design's job is to keep the tensor cores busy: wgmma, and K/V tiles
// that arrive while the previous tile computes.
//
// Two instantiations:
//   bf16 inputs (the training path): warp-specialised wgmma, the forward's
//     loop shape (a fixed q tile, streamed K/V tiles) with one more product
//     and no online softmax. A block of 384 threads owns 128 q rows: two
//     consumer warpgroups of 64 rows each and a producer warpgroup, one
//     thread of which issues every TMA load; the producer warpgroup gives
//     its registers to the consumers (setmaxnreg, 168 -> 40 and 168 -> 232).
//     Q and dO are loaded once; K and V tiles of 64 keys (every d) stream
//     through a 3-stage ring in shared memory, each stage guarded by a
//     "full" mbarrier (transaction bytes) and an "empty" one (one arrival
//     per consumer warpgroup). The tensor maps are 3-D over [B*H(kv), T, d],
//     so TMA's zero fill stops at each head's own T; tiles carry the
//     128-byte swizzle (64-byte at d=32), and a d=128 row is two 64-column
//     boxes. Each consumer thread reads lse and Delta of its two rows once,
//     with plain loads (+inf and 0 past T, so those rows add exactly 0).
//     Per kv tile a consumer warpgroup computes S = Q K^T and dP = dO V^T
//     with wgmma from shared memory (K and V row-major are K-major for B),
//     then P = exp2(S * scale * log2e - lse * log2e) on the special-function
//     unit and dS = P o (dP - Delta) in f32, then dQ += dS K with dS from
//     registers (rounded to bf16, as the A operand; the TPU kernel keeps dS
//     in f32) and K straight from its row-major tile through wgmma's
//     transpose-B flag: no transposed copy of K is written. The next tile's
//     S and dP are issued with this tile's dS K, so that the elementwise
//     pass runs while dS K is in the tensor cores. (On an H100, starting
//     warpgroup 1 half a tile behind warpgroup 0, as the forward does, was
//     3-11% slower, and 128-key tiles at d <= 64 13-15% slower.) Masks are
//     limits computed once per row; a tile with a masked key runs a
//     separate instantiation of the elementwise pass, so an unmasked tile
//     runs no per-element branch.
//     Each warpgroup computes only its own rows' live tiles (those of a
//     64-row q tile) and passes over the block's others. Causal q tiles run
//     heaviest first (the grid's y index is reversed).
//   f32 inputs (parity runs): plain FMA, four threads per q row, 64-row q
//     tiles. Off the training path.
//
// What the design leaves on the table (later work): the next tile's S and
// dP in flight during this tile's elementwise pass as well (registers), a
// persistent grid, dQ through shared memory and a TMA store, FP8.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

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

// The bf16 kernel's tiling at head dim D.
template <int D>
struct Bf16Tiles {
  static constexpr int BM = 128;                 // q rows per block: 2 warpgroups x 64
  static constexpr int BN = 64;                  // keys per kv tile
  static constexpr int STAGES = 3;               // depth of the K/V ring
  static constexpr int BOX_W = D < 64 ? D : 64;  // columns per TMA box: one swizzle row
  static constexpr int ROW_B = 2 * BOX_W;        // bytes per box row
  static constexpr int NBOX = D / BOX_W;         // boxes across the head dim
  static constexpr int Q_BYTES = BM * D * 2;     // Q or dO
  static constexpr int KV_BYTES = BN * D * 2;    // one K or V tile
  static constexpr int BAR_OFF = 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
  // barriers: Q/dO full, then full[STAGES], empty[STAGES]; plus 1 KB of
  // slack to align the tiles to the 1024-byte swizzle atom
  static constexpr size_t kSmemBytes = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

constexpr int kConsumerThreads = 256;             // two warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // and one producer warpgroup

struct TmaArgs {
  CUtensorMap q, dout, k, v;  // 3-D maps over [B*H, T, d] and [B*H_kv, T_kv, d]
  Params p;
};

// S = A B^T for one warpgroup's 64 rows against a BN-key tile (A: Q or dO,
// B: K or V, both K-major); issued, not committed.
template <int D>
__device__ __forceinline__ void issue_rows_keys(float* acc, uint32_t a_w, uint32_t bt) {
  using Tl = Bf16Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int x = kk * 16 / Tl::BOX_W;               // box
    const uint32_t off = (kk * 16 % Tl::BOX_W) * 2;  // bytes into its rows
    wgmma_ss<Tl::BN>(acc, wgmma_desc(a_w + x * Tl::BM * Tl::ROW_B + off, 16, Tl::ROW_B),
                     wgmma_desc(bt + x * Tl::BN * Tl::ROW_B + off, 16, Tl::ROW_B), kk > 0);
  }
}

// dQ += dS K: dS from registers, K MN-major through the transpose flag
// (issued, committed, not waited).
template <int D>
__device__ __forceinline__ void issue_dsk(float* dq, const uint32_t (*da)[4], uint32_t kt) {
  using Tl = Bf16Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < Tl::BN / 16; ++kk)
#pragma unroll
    for (int x = 0; x < Tl::NBOX; ++x)
      wgmma_rs_t<Tl::BOX_W>(dq + x * Tl::BOX_W / 2, da[kk],
                            wgmma_desc(kt + x * Tl::BN * Tl::ROW_B + kk * 16 * Tl::ROW_B,
                                       Tl::BN * Tl::ROW_B, Tl::ROW_B),
                            1);
  wgmma_commit();
}

// P = exp2(S * scale * log2e - lse * log2e) and dS = P o (dP - Delta) in
// place of dP, for the thread's two rows (lse2 = lse * log2e). MASKED applies
// each row's limits (a separate instantiation: a per-element branch on a
// runtime flag costs more than the products).
template <int BN, bool MASKED>
__device__ __forceinline__ void elementwise(const float* s, float* dp, const float* lse2,
                                            const float* dl, const RowLimits* lim,
                                            float scale_log2, int tg) {
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = c >> 1;
      float pr;
      if (MASKED)
        pr = fast_exp2(apply_limits(lim[r], nt * 8 + tg * 2 + (c & 1), s[4 * nt + c] * scale_log2) -
                       lse2[r]);
      else
        pr = fast_exp2(fmaf(s[4 * nt + c], scale_log2, -lse2[r]));
      dp[4 * nt + c] = pr * (dp[4 * nt + c] - dl[r]);
    }
}

// The live kv tiles [*wlo, *whi) of the 64 q rows at local r0, as ring
// indices within [0, n_tiles) of a block whose ring starts at tile lo: none
// if the rows all lie past T.
__device__ __forceinline__ void rows_tiles(const Params& p, int r0, int kv_limit, int bn, int lo,
                                           int n_tiles, int* wlo, int* whi) {
  int l = lo, h = lo;
  if (r0 < p.T) tile_range(p, p.q_off + r0, p.q_off + min(r0 + 64, p.T) - 1, kv_limit, bn, &l, &h);
  *wlo = min(max(l - lo, 0), n_tiles);
  *whi = min(max(h - lo, *wlo), n_tiles);
}

// One tile's elementwise pass for a warpgroup's rows [qw_first, qw_last]
// (global) at local key k0, masked only if some key of the tile is dead.
template <int BN>
__device__ __forceinline__ void tile_pass(const Params& p, const float* sc, float* dp,
                                          const float* lse2, const float* dl, int qw_first,
                                          int qw_last, int row, int k0, int kv_limit, int tg) {
  if (tile_all_live(p, qw_first, qw_last, kv_limit, k0, BN)) {
    elementwise<BN, false>(sc, dp, lse2, dl, nullptr, p.scale_log2, tg);
  } else {
    const RowLimits lim[2] = {row_limits(p, p.q_off + row, k0, BN, kv_limit),
                              row_limits(p, p.q_off + row + 8, k0, BN, kv_limit)};
    elementwise<BN, true>(sc, dp, lse2, dl, lim, p.scale_log2, tg);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ TmaArgs a) {
  using Tl = Bf16Tiles<D>;
  constexpr int BM = Tl::BM, BN = Tl::BN, STAGES = Tl::STAGES;
  constexpr int BOX_W = Tl::BOX_W, ROW_B = Tl::ROW_B, NBOX = Tl::NBOX;
  const Params& p = a.p;
  extern __shared__ uint8_t smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023) & ~1023u;  // [NBOX][BM][BOX_W]
  const uint32_t do_s = q_s + Tl::Q_BYTES;                // likewise
  const uint32_t k_s = do_s + Tl::Q_BYTES;                // [STAGES][NBOX][BN][BOX_W]
  const uint32_t v_s = k_s + STAGES * Tl::KV_BYTES;       // likewise
  const uint32_t qdo_full = q_s + Tl::BAR_OFF;
  const uint32_t full0 = qdo_full + 8, empty0 = full0 + 8 * STAGES;  // + 8 * stage

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvbh = b * p.H_kv + h / (p.H / p.H_kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest causal tiles first
  const int kv_limit = p.kv_len ? p.kv_len[b] : -1;
  int lo, hi;
  tile_range(p, p.q_off + q0, p.q_off + min(q0 + BM, p.T) - 1, kv_limit, BN, &lo, &hi);
  const int n_tiles = max(hi - lo, 0);  // the block's ring carries tiles lo + [0, n_tiles)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's role, made warp-uniform for the compiler
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == kConsumerThreads / 128) {
    // producer warpgroup: one thread issues every TMA load; all four warps
    // give registers to the consumers
    setmaxnreg_dec<40>();
    if (warp != kConsumerThreads / 32 || lane != 0 || n_tiles == 0) return;
    mbar_arrive_expect_tx(qdo_full, 2 * Tl::Q_BYTES);
    for (int x = 0; x < NBOX; ++x) {
      tma_load_3d(q_s + x * BM * ROW_B, &a.q, qdo_full, x * BOX_W, q0, bh);
      tma_load_3d(do_s + x * BM * ROW_B, &a.dout, qdo_full, x * BOX_W, q0, bh);
    }
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % STAGES;
      mbar_wait(empty0 + 8 * s, ((n / STAGES) & 1) ^ 1);
      mbar_arrive_expect_tx(full0 + 8 * s, 2 * Tl::KV_BYTES);
      for (int x = 0; x < NBOX; ++x) {
        const uint32_t off = s * Tl::KV_BYTES + x * BN * ROW_B;
        tma_load_3d(k_s + off, &a.k, full0 + 8 * s, x * BOX_W, (lo + n) * BN, kvbh);
        tma_load_3d(v_s + off, &a.v, full0 + 8 * s, x * BOX_W, (lo + n) * BN, kvbh);
      }
    }
  } else {
    // consumer warpgroup wg: q rows [q0 + 64 wg, q0 + 64 wg + 64)
    setmaxnreg_inc<232>();
    const int wg = role;
    const int g = lane >> 2, tg = lane & 3;  // accumulator row group / column pair
    const int row = q0 + wg * 64 + (warp & 3) * 16 + g;  // this thread's rows: row, row + 8
    const int qw_first = p.q_off + q0 + wg * 64;
    const int qw_last = p.q_off + min(q0 + wg * 64 + 64, p.T) - 1;
    const uint32_t q_w = q_s + wg * 64 * ROW_B, do_w = do_s + wg * 64 * ROW_B;
    const bool leader = (threadIdx.x & 127) == 0;  // arrives for the warpgroup
    int wlo, whi;
    rows_tiles(p, q0 + wg * 64, kv_limit, BN, lo, n_tiles, &wlo, &whi);

    // rows past T get lse = +inf: P, and so dS, is exactly 0 there
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row + 8 * r < p.T;
      lse2[r] = in ? p.lse[(size_t)bh * p.T + row + 8 * r] * kLog2e : INFINITY;
      dl[r] = in ? p.delta[(size_t)bh * p.T + row + 8 * r] : 0.f;
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    // the ring's tiles before this warpgroup's live ones: passed over
    for (int n = 0; n < wlo; ++n) {
      mbar_wait(full0 + 8 * (n % STAGES), (n / STAGES) & 1);
      if (leader) mbar_arrive(empty0 + 8 * (n % STAGES));
    }
    if (whi > wlo) {
      // Tile wlo: S, dP, the elementwise pass, dS. Then step n issues S_n,
      // dP_n and dQ += dS_{n-1} K_{n-1} back to back and runs tile n's
      // elementwise pass while dS K is in the tensor cores.
      float sc[BN / 2], dp[BN / 2];
      uint32_t da[BN / 16][4];  // dS rounded to bf16: the A operand of dS K
      mbar_wait(qdo_full, 0);
      mbar_wait(full0 + 8 * (wlo % STAGES), (wlo / STAGES) & 1);
      wgmma_fence();
      issue_rows_keys<D>(sc, q_w, k_s + (wlo % STAGES) * Tl::KV_BYTES);
      issue_rows_keys<D>(dp, do_w, v_s + (wlo % STAGES) * Tl::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BN / 2>(sc);
      fence_regs<BN / 2>(dp);
      tile_pass<BN>(p, sc, dp, lse2, dl, qw_first, qw_last, row, (lo + wlo) * BN, kv_limit, tg);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_acc_to_a(dp, kk, da[kk]);
      for (int n = wlo + 1; n < whi; ++n) {
        const int s = n % STAGES, sp = (n - 1) % STAGES;
        mbar_wait(full0 + 8 * s, (n / STAGES) & 1);
        wgmma_fence();
        issue_rows_keys<D>(sc, q_w, k_s + s * Tl::KV_BYTES);
        issue_rows_keys<D>(dp, do_w, v_s + s * Tl::KV_BYTES);
        wgmma_commit();
        issue_dsk<D>(dq, da, k_s + sp * Tl::KV_BYTES);
        wgmma_wait<1>();
        fence_regs<BN / 2>(sc);
        fence_regs<BN / 2>(dp);
        tile_pass<BN>(p, sc, dp, lse2, dl, qw_first, qw_last, row, (lo + n) * BN, kv_limit, tg);
        wgmma_wait<0>();
        fence_regs<D / 2>(dq);
        if (leader) mbar_arrive(empty0 + 8 * sp);  // tile n-1 is done
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) wgmma_acc_to_a(dp, kk, da[kk]);
      }
      const int sl = (whi - 1) % STAGES;
      wgmma_fence();
      issue_dsk<D>(dq, da, k_s + sl * Tl::KV_BYTES);
      wgmma_wait<0>();
      fence_regs<D / 2>(dq);
      if (leader) mbar_arrive(empty0 + 8 * sl);
    }
    // and those after them
    for (int n = whi; n < n_tiles; ++n) {
      mbar_wait(full0 + 8 * (n % STAGES), (n / STAGES) & 1);
      if (leader) mbar_arrive(empty0 + 8 * (n % STAGES));
    }

    __nv_bfloat16* dQ = static_cast<__nv_bfloat16*>(p.dq) + (size_t)bh * p.T * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = row + 8 * r;
      if (qr >= p.T) continue;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<uint32_t*>(dQ + (size_t)qr * D + nd * 8 + tg * 2) =
            pack_bf16(dq[4 * nd + 2 * r] * p.scale, dq[4 * nd + 2 * r + 1] * p.scale);
    }
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

// The TMA descriptors of a->p's q, dO, k and v (built per call: they hold
// the data pointers).
template <int D>
bool encode_maps(TmaArgs* a) {
  using Tl = Bf16Tiles<D>;
  const Params& p = a->p;
  return encode_rows_map(&a->q, p.q, p.B * p.H, p.T, D, Tl::BM) &&
         encode_rows_map(&a->dout, p.dout, p.B * p.H, p.T, D, Tl::BM) &&
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
        flash_bwd_dq_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::kSmemBytes);
    if (e != cudaSuccess) return e;
    const dim3 grid(p.B * p.H, (p.T + Tl::BM - 1) / Tl::BM);
    flash_bwd_dq_bf16_kernel<D><<<grid, kThreads, Tl::kSmemBytes, stream>>>(a);
  } else {
    const dim3 grid(p.B * p.H, (p.T + kBlockM - 1) / kBlockM);
    flash_bwd_dq_f32_kernel<D><<<grid, 256, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// q, dout [B*H, T, d], k/v [B*H_kv, T_kv, d] contiguous, bf16 (is_bf16=1) or
// f32; lse, delta [B*H, T] f32; dq like q; kv_len [B] int32 or null.
// Launches on `stream` and returns the launch's cudaError_t (0 = success;
// bf16 inputs whose TMA descriptors cannot be encoded return
// cudaErrorInvalidValue).
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
