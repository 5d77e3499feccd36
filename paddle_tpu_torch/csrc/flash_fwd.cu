// Flash-attention forward for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the two Pallas TPU forward kernels of
// paddle_tpu/ops/pallas/flash_attention.py: _flash_fwd_kernel (:67, K/V
// streamed through the grid) and _flash_fwd_kernel_resident (:139, K/V held
// in VMEM). Their split is a VMEM-capacity artefact; here one kernel covers
// both: a thread block owns one (batch*head, q tile) and loops over kv
// tiles staged in shared memory, which takes the place of the TPU's
// sequential kv grid axis.
//
// Semantics (identical to _flash_fwd, :263-359):
//   out = softmax(q k^T * sm_scale) v, lse = m + log(max(l, 1e-20)) (f32)
//   causal mask top-left aligned at GLOBAL positions (q_off + i >= k_off + j),
//   sliding window (q_pos - k_pos < window, causal only), per-batch kv_len
//   (k_pos < kv_len[b]), GQA (query head h reads kv head h / (H / H_kv)).
//   Masked scores take the finite NEG_INF = -1e9 (core/dtypes.py), so a row
//   with no live key in a visited tile still adds exp(0) terms; such rows are
//   defined only by lse < -1e8, and their lse depends on which tiles the
//   block visits (the 128-row q tile of the bf16 kernel visits other tiles
//   than the 64-row one of the f32 kernel). Kv tiles that are dead under
//   causal, window or kv_len are skipped by the loop bounds. Keys past T_kv
//   (the ragged edge of the last tile, which the TPU kernels never had: they
//   required T_kv to divide by the block) score -inf and add exactly nothing.
//
// Bound on an H100 SXM at the serving slice's prefill shape (B=8, H=8,
// T=1024, d=64, bf16, causal): 4*d flops per live (q, k) pair over
// B*H*T*(T+1)/2 pairs = 8.6 GFLOP, 8.7 us at 989 TFLOP/s; bytes: q, k, v read
// and out written once in bf16 (8.4 MB each) plus lse in f32 = 33.8 MB,
// 10.1 us at 3.35 TB/s. The two bounds are within 16% of each other, bytes
// the larger: at d=64 causal attention has only ~255 flops per byte, under
// the card's ~295. So the kernel must keep the tensor cores fed from shared
// memory while the next tiles stream in, and read K/V once per q tile.
//
// Two instantiations:
//   bf16 inputs (the serving and training path): warp-specialised wgmma.
//     A block of 288 threads owns 128 q rows: two consumer warpgroups of 64
//     rows each and one producer warp. The producer loads the Q tile once
//     and streams K and V tiles (128 keys, 64 at d=128 where registers
//     decide) through a 3-stage ring in shared memory with TMA, each stage
//     guarded by a "full" mbarrier (transaction bytes) and an "empty" one
//     (one arrival per consumer warpgroup). The tensor maps are 3-D over
//     [B*H(kv), T, d], so TMA's zero fill stops at each head's own T; tiles
//     carry the 128-byte swizzle (64-byte at d=32), and a d=128 row is two
//     64-column boxes. Each consumer warpgroup computes S = Q K^T with
//     wgmma m64nNk16 from shared memory (K row-major is K-major for B),
//     the online softmax in f32 in the log2 domain (exp2 on the special-
//     function unit; a positive scale folded into the exponent's FFMA, any
//     other scale applied to the scores first), then O += P V with P from
//     registers (the S accumulator rounded to bf16, as
//     the A operand) and V straight from its row-major tile through wgmma's
//     transpose-B flag: no transposed copy of V is written. The next
//     tile's S and this tile's P V are issued together, so that the
//     softmax runs while P V is in the tensor cores (FlashAttention-3's
//     intra-warpgroup overlap), and warpgroup 1 starts half a tile behind
//     warpgroup 0, so that their softmaxes and products tend to alternate.
//     Causal q tiles run heaviest first (the grid's y index is reversed),
//     so the cheap tiles fill the tail.
//   f32 inputs (parity runs): plain FMA, four threads per q row, online
//     softmax one key at a time, 64-row q tiles. Off the serving path.
//
// What bounds it at the slice shape (H100, chip_smoke.py): not the bytes.
// One block per SM (registers) runs its tiles as a chain whose longest
// link is the softmax: at d=64 a tile's 16,384 exp2 on the special-
// function unit (16 per clock per SM) take as long as its two products on
// the tensor cores. What the design leaves on the table (later work): a
// persistent grid, exp2 partly on the FMA units, `out` through shared
// memory and a TMA store, FP8. (A strict ping-pong of the two warpgroups
// around their products, FlashAttention-3's inter-warpgroup schedule, was
// slower here than the one-time offset.)

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  const int* kv_len;  // [B] or null
  int B, H, H_kv, T, T_kv;
  int causal, window, q_off, k_off;  // window 0 = none
  float scale_log2;                  // sm_scale * log2(e)
};

// The bf16 kernel's tiling at head dim D.
template <int D>
struct Bf16Tiles {
  static constexpr int BM = 128;                  // q rows per block: 2 warpgroups x 64
  static constexpr int BN = D == 128 ? 64 : 128;  // keys per kv tile
  static constexpr int STAGES = 3;                // depth of the K/V ring
  static constexpr int BOX_W = D < 64 ? D : 64;   // columns per TMA box: one swizzle row
  static constexpr int ROW_B = 2 * BOX_W;         // bytes per box row
  static constexpr int NBOX = D / BOX_W;          // boxes across the head dim
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;     // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // barriers: Q full, then full[STAGES], empty[STAGES]; plus 1 KB of slack
  // to align the tiles to the 1024-byte swizzle atom
  static constexpr size_t kSmemBytes = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

constexpr int kConsumerThreads = 256;            // two warpgroups
constexpr int kThreads = kConsumerThreads + 32;  // and one producer warp
constexpr int kOffsetBar = 1;                    // named barrier of the warpgroups' offset

struct TmaArgs {
  CUtensorMap q, k, v;  // 3-D maps over [B*H, T, d] and [B*H_kv, T_kv, d]
  Params p;
};

// S = Q K^T for one warpgroup's 64 rows (issued, committed, not waited).
template <int D>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t q_w, uint32_t kt) {
  using Tl = Bf16Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int x = kk * 16 / Tl::BOX_W;
    const uint32_t off = (kk * 16 % Tl::BOX_W) * 2;
    wgmma_ss<Tl::BN>(sc, wgmma_desc(q_w + x * Tl::BM * Tl::ROW_B + off, 16, Tl::ROW_B),
                     wgmma_desc(kt + x * Tl::BN * Tl::ROW_B + off, 16, Tl::ROW_B), kk > 0);
  }
  wgmma_commit();
}

// O += P V: P from registers, V MN-major through the transpose flag
// (issued, committed, not waited).
template <int D>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t (*pa)[4], uint32_t vt) {
  using Tl = Bf16Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < Tl::BN / 16; ++kk)
#pragma unroll
    for (int x = 0; x < Tl::NBOX; ++x)
      wgmma_rs_t<Tl::BOX_W>(o + x * Tl::BOX_W / 2, pa[kk],
                            wgmma_desc(vt + x * Tl::BN * Tl::ROW_B + kk * 16 * Tl::ROW_B,
                                       Tl::BN * Tl::ROW_B, Tl::ROW_B),
                            1);
  wgmma_commit();
}

// One tile's online softmax in place: the scores sc become P (f32), the row
// max m and the partial row sums l (the 4 threads of an accumulator row
// group share each row) move on, and alpha is the factor O must take. A
// positive scale stays out of the scores until one FFMA in the exponent,
// exp2(s * scale_log2 - m): the row max of unscaled scores then scales to
// the max of scaled ones, and masked scores take NEG_INF / scale_log2. A
// negative or zero scale, which would not keep that order, is applied to
// each score first (one FMUL). Either way any sm_scale means what it means
// to mask_score: NEG_INF where the mask kills a key, -inf past T_kv. The
// mask is apply_limits written out (through the shared helper ptxas
// spilled at d=64).
template <int D>
__device__ __forceinline__ void softmax_tile(const Params& p, float* sc, float* m, float* l,
                                            float* alpha, int qw_first, int qw_last, int row,
                                            int k0, int kv_limit, int tg) {
  constexpr int BN = Bf16Tiles<D>::BN;
  const bool folded = p.scale_log2 > 0.f;  // the scale goes into the exponent
  const float pre = folded ? 1.f : p.scale_log2, post = folded ? p.scale_log2 : 1.f;
  if (!tile_all_live(p, qw_first, qw_last, kv_limit, k0, BN)) {
    const RowLimits lim[2] = {row_limits(p, p.q_off + row, k0, BN, kv_limit),
                              row_limits(p, p.q_off + row + 8, k0, BN, kv_limit)};
    const float masked = kNegInfLog2 / post;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = nt * 8 + tg * 2 + (c & 1);
        const RowLimits& L = lim[c >> 1];
        sc[4 * nt + c] = col >= L.end ? -INFINITY
                         : (col >= L.lo && col < L.hi ? sc[4 * nt + c] * pre : masked);
      }
  } else if (!folded) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] *= pre;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
      mx = fmaxf(mx, fmaxf(sc[4 * nt + 2 * r], sc[4 * nt + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(m[r], mx * post);
    alpha[r] = fast_exp2(m[r] - mx);
    m[r] = mx;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      sc[4 * nt + 2 * r] = fast_exp2(fmaf(sc[4 * nt + 2 * r], post, -mx));
      sc[4 * nt + 2 * r + 1] = fast_exp2(fmaf(sc[4 * nt + 2 * r + 1], post, -mx));
      sum += sc[4 * nt + 2 * r] + sc[4 * nt + 2 * r + 1];
    }
    l[r] = l[r] * alpha[r] + sum;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ TmaArgs a) {
  using Tl = Bf16Tiles<D>;
  constexpr int BM = Tl::BM, BN = Tl::BN, STAGES = Tl::STAGES;
  constexpr int BOX_W = Tl::BOX_W, ROW_B = Tl::ROW_B, NBOX = Tl::NBOX;
  const Params& p = a.p;
  extern __shared__ uint8_t smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023) & ~1023u;  // [NBOX][BM][BOX_W]
  const uint32_t k_s = q_s + Tl::Q_BYTES;                 // [STAGES][NBOX][BN][BOX_W]
  const uint32_t v_s = k_s + STAGES * Tl::KV_BYTES;       // likewise
  const uint32_t q_full = q_s + Tl::BAR_OFF;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * STAGES;  // + 8 * stage

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvbh = b * p.H_kv + h / (p.H / p.H_kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest causal tiles first
  const int kv_limit = p.kv_len ? p.kv_len[b] : -1;
  int lo, hi;
  tile_range(p, p.q_off + q0, p.q_off + min(q0 + BM, p.T) - 1, kv_limit, BN, &lo, &hi);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == kConsumerThreads / 128) {
    // producer: one thread issues every TMA load
    if (warp == kConsumerThreads / 32 && lane == 0 && hi > lo) {
      mbar_arrive_expect_tx(q_full, Tl::Q_BYTES);
      for (int x = 0; x < NBOX; ++x)
        tma_load_3d(q_s + x * BM * ROW_B, &a.q, q_full, x * BOX_W, q0, bh);
      for (int j = lo; j < hi; ++j) {
        const int n = j - lo, s = n % STAGES;
        mbar_wait(empty0 + 8 * s, ((n / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full0 + 8 * s, 2 * Tl::KV_BYTES);
        for (int x = 0; x < NBOX; ++x) {
          const uint32_t off = s * Tl::KV_BYTES + x * BN * ROW_B;
          tma_load_3d(k_s + off, &a.k, full0 + 8 * s, x * BOX_W, j * BN, kvbh);
          tma_load_3d(v_s + off, &a.v, full0 + 8 * s, x * BOX_W, j * BN, kvbh);
        }
      }
    }
  } else {
    // consumer warpgroup wg: q rows [q0 + 64 wg, q0 + 64 wg + 64)
    const int wg = role;
    const int g = lane >> 2, tg = lane & 3;  // accumulator row group / column pair
    const int row = q0 + wg * 64 + (warp & 3) * 16 + g;  // this thread's rows: row, row + 8
    const int qw_first = p.q_off + q0 + wg * 64;
    const int qw_last = p.q_off + min(q0 + wg * 64 + 64, p.T) - 1;
    const uint32_t q_w = q_s + wg * 64 * ROW_B;  // the warpgroup's rows of each Q box

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInfLog2, kNegInfLog2};
    float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end
    if (hi > lo) {
      // Tile lo: S, softmax, P. Then step j issues S_j = Q K_j^T and
      // O += P_{j-1} V_{j-1} back to back and runs tile j's softmax while
      // P V is in the tensor cores; O takes tile j's alpha once P V is done.
      // Warpgroup 1 starts half a tile behind warpgroup 0 (its first S
      // waits for 0's first softmax), so that one's softmax tends to run
      // while the other's products are in the tensor cores.
      float sc[BN / 2], alpha[2];
      uint32_t pa[BN / 16][4];  // P rounded to bf16: the A operand of P V
      mbar_wait(q_full, 0);
      mbar_wait(full0, 0);
      if (wg == 1) named_bar_sync(kOffsetBar, kConsumerThreads);
      wgmma_fence();
      issue_qk<D>(sc, q_w, k_s);
      wgmma_wait<0>();
      fence_regs<BN / 2>(sc);
      softmax_tile<D>(p, sc, m, l, alpha, qw_first, qw_last, row, lo * BN, kv_limit, tg);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_acc_to_a(sc, kk, pa[kk]);
      if (wg == 0) named_bar_arrive(kOffsetBar, kConsumerThreads);
      for (int j = lo + 1; j < hi; ++j) {
        const int n = j - lo, s = n % STAGES, sp = (n - 1) % STAGES;
        mbar_wait(full0 + 8 * s, (n / STAGES) & 1);
        wgmma_fence();
        issue_qk<D>(sc, q_w, k_s + s * Tl::KV_BYTES);
        issue_pv<D>(o, pa, v_s + sp * Tl::KV_BYTES);
        wgmma_wait<1>();
        fence_regs<BN / 2>(sc);
        softmax_tile<D>(p, sc, m, l, alpha, qw_first, qw_last, row, j * BN, kv_limit, tg);
        wgmma_wait<0>();
        fence_regs<D / 2>(o);
        if ((threadIdx.x & 127) == 0) mbar_arrive(empty0 + 8 * sp);  // tile j-1 is done
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          o[4 * nd] *= alpha[0];
          o[4 * nd + 1] *= alpha[0];
          o[4 * nd + 2] *= alpha[1];
          o[4 * nd + 3] *= alpha[1];
        }
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) wgmma_acc_to_a(sc, kk, pa[kk]);
      }
      const int sl = (hi - lo - 1) % STAGES;
      wgmma_fence();
      issue_pv<D>(o, pa, v_s + sl * Tl::KV_BYTES);
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      if ((threadIdx.x & 127) == 0) mbar_arrive(empty0 + 8 * sl);
    }

    __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.out) + (size_t)bh * p.T * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float l_safe = fmaxf(lr, 1e-20f);
      const float inv = 1.f / l_safe;
      const int qr = row + 8 * r;
      if (qr < p.T) {
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd)
          *reinterpret_cast<uint32_t*>(O + (size_t)qr * D + nd * 8 + tg * 2) =
              pack_bf16(o[4 * nd + 2 * r] * inv, o[4 * nd + 2 * r + 1] * inv);
        if (tg == 0) p.lse[(size_t)bh * p.T + qr] = m[r] * kLn2 + logf(l_safe);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256) flash_fwd_f32_kernel(const Params p) {
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
  const float* Q = static_cast<const float*>(p.q) + (size_t)bh * p.T * D;
  const float* K = static_cast<const float*>(p.k) + (size_t)kvbh * p.T_kv * D;
  const float* V = static_cast<const float*>(p.v) + (size_t)kvbh * p.T_kv * D;
  const int kv_limit = p.kv_len ? p.kv_len[b] : -1;

  float q[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    q[i] = row < p.T ? Q[(size_t)row * D + part + 4 * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInfLog2, l = 0.f;

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
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) s += q[i] * k_s[kk * D + part + 4 * i];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s = mask_score(p, s * p.scale_log2, p.q_off + row, k0 + kk, kv_limit);
      const float m_new = fmaxf(m, s);
      const float alpha = exp2f(m - m_new);
      const float pr = exp2f(s - m_new);
      l = l * alpha + pr;
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = acc[i] * alpha + pr * v_s[kk * D + part + 4 * i];
      m = m_new;
    }
  }

  if (row < p.T) {
    const float l_safe = fmaxf(l, 1e-20f);
    float* O = static_cast<float*>(p.out) + (size_t)bh * p.T * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) O[(size_t)row * D + part + 4 * i] = acc[i] / l_safe;
    if (part == 0) p.lse[(size_t)bh * p.T + row] = m * kLn2 + logf(l_safe);
  }
}

// The TMA descriptors of a->p's q, k and v (built per call: they hold the
// data pointers).
template <int D>
bool encode_maps(TmaArgs* a) {
  using Tl = Bf16Tiles<D>;
  const Params& p = a->p;
  return encode_rows_map(&a->q, p.q, p.B * p.H, p.T, D, Tl::BM) &&
         encode_rows_map(&a->k, p.k, p.B * p.H_kv, p.T_kv, D, Tl::BN) &&
         encode_rows_map(&a->v, p.v, p.B * p.H_kv, p.T_kv, D, Tl::BN);
}

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  using Tl = Bf16Tiles<D>;
  TmaArgs a;
  a.p = p;
  if (!encode_maps<D>(&a)) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.B * p.H, (p.T + Tl::BM - 1) / Tl::BM);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, Tl::kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, bool bf16, cudaStream_t stream) {
  if (bf16) return launch_bf16<D>(p, stream);
  const dim3 grid(p.B * p.H, (p.T + kBlockM - 1) / kBlockM);
  flash_fwd_f32_kernel<D><<<grid, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q [B*H, T, d], k/v [B*H_kv, T_kv, d] contiguous, bf16 (is_bf16=1) or f32;
// out like q; lse [B*H, T] f32; kv_len [B] int32 or null. Launches on
// `stream` and returns the launch's cudaError_t (0 = success; bf16 inputs
// whose TMA descriptors cannot be encoded return cudaErrorInvalidValue).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out,
                         float* lse, const int* kv_len, int B, int H, int H_kv,
                         int T, int T_kv, int d, int is_bf16, int causal,
                         int window, int q_off, int k_off, float sm_scale,
                         void* stream) {
  if (B <= 0 || H <= 0 || H_kv <= 0 || H % H_kv || T <= 0 || T_kv <= 0 ||
      (T + kBlockM - 1) / kBlockM > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, out, lse, kv_len, B, H, H_kv, T, T_kv,
                 causal, window, q_off, k_off, sm_scale * kLog2e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return (int)launch<32>(p, is_bf16 != 0, s);
    case 64: return (int)launch<64>(p, is_bf16 != 0, s);
    case 128: return (int)launch<128>(p, is_bf16 != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
