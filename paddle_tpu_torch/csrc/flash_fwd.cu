// Flash-attention forward for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the two Pallas TPU forward kernels of
// paddle_tpu/ops/pallas/flash_attention.py: _flash_fwd_kernel (:67, K/V
// streamed through the grid) and _flash_fwd_kernel_resident (:139, K/V held
// in VMEM). Their split is a VMEM-capacity artefact; here one kernel covers
// both: a thread block owns one (batch*head, 64-row q tile) and loops over
// kv tiles staged in shared memory, which takes the place of the TPU's
// sequential kv grid axis.
//
// Semantics (identical to _flash_fwd, :263-359):
//   out = softmax(q k^T * sm_scale) v, lse = m + log(max(l, 1e-20)) (f32)
//   causal mask top-left aligned at GLOBAL positions (q_off + i >= k_off + j),
//   sliding window (q_pos - k_pos < window, causal only), per-batch kv_len
//   (k_pos < kv_len[b]), GQA (query head h reads kv head h / (H / H_kv)).
//   Masked scores take the finite NEG_INF = -1e9 (core/dtypes.py), so a row
//   with no live key in a visited tile still adds exp(0) terms; such rows are
//   defined only by lse < -1e8. Kv tiles that are dead under causal, window
//   or kv_len are skipped by the loop bounds. Keys past T_kv (the ragged edge
//   of the last tile, which the TPU kernels never had: they required T_kv to
//   divide by the block) score -inf and add exactly nothing.
//
// Two instantiations:
//   bf16 inputs: tensor-core mma.sync m16n8k16 (bf16 x bf16 -> f32). Four warps
//     of 16 q rows each; S = Q K^T and O += P V stay in registers
//     (FlashAttention-2 register layout: the S accumulator fragment is the A
//     operand of the P V product), softmax in the log2 domain in f32.
//   f32 inputs (parity runs): plain FMA, four threads per q row, online
//     softmax one key at a time. Off the serving path.
//
// Bound on an H100 SXM at the serving slice's prefill shape (B=8, H=8,
// T=1024, d=64, bf16, causal): 4*d flops per live (q, k) pair over
// B*H*T*(T+1)/2 pairs = 8.6 GFLOP, 8.7 us at 989 TFLOP/s; bytes: q, k, v read
// and out written once in bf16 (8.4 MB each) plus lse in f32 = 33.8 MB,
// 10.1 us at 3.35 TB/s. The two bounds are within 16% of each other, bytes
// the larger: at d=64 causal attention has only ~255 flops per byte, under
// the card's ~295. The design reads each K/V tile once per 64-row q tile
// (from L2 after the first q tile of a head) and never writes S or P.
//
// What this simple design leaves on the table (later work): mma.sync reaches
// well under the wgmma peak; K/V tiles are loaded synchronously (no cp.async
// or TMA pipeline, no double buffering), V is transposed through scalar
// shared-memory stores instead of ldmatrix.trans, blocks are not persistent
// and causal tiles are not ordered heaviest-first.

#include "flash_common.cuh"

namespace {

using namespace flash;

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

template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16_kernel(const Params p) {
  constexpr int BN = 64;          // keys per kv tile
  constexpr int KSTEPS = D / 16;  // k-steps of Q K^T
  constexpr int NT = BN / 8;      // 8-key n-tiles of S
  constexpr int ND = D / 8;       // 8-dim n-tiles of O
  constexpr int KP = D + 8;       // padded K row (conflict-free fragment reads)
  constexpr int VP = BN + 8;      // padded V^T row
  __shared__ __align__(16) __nv_bfloat16 k_s[BN * KP];
  __shared__ __align__(16) __nv_bfloat16 vt_s[D * VP];

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvbh = b * p.H_kv + h / (p.H / p.H_kv);
  const int q0 = blockIdx.y * kBlockM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row group / column pair
  const __nv_bfloat16* Q =
      static_cast<const __nv_bfloat16*>(p.q) + (size_t)bh * p.T * D;
  const __nv_bfloat16* K =
      static_cast<const __nv_bfloat16*>(p.k) + (size_t)kvbh * p.T_kv * D;
  const __nv_bfloat16* V =
      static_cast<const __nv_bfloat16*>(p.v) + (size_t)kvbh * p.T_kv * D;
  const int kv_limit = p.kv_len ? p.kv_len[b] : -1;

  // this thread's two q rows (fragment rows g and g + 8 of its warp's 16)
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int c = ks * 16 + tg * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row[r] < p.T;
      qa[ks][r] = in ? ld32(Q + (size_t)row[r] * D + c) : 0u;
      qa[ks][r + 2] = in ? ld32(Q + (size_t)row[r] * D + c + 8) : 0u;
    }
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInfLog2, kNegInfLog2};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end

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
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt_s[(c8 + i) * VP + kr] = ve[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = k_s + (nt * 8 + g) * KP + tg * 2;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        mma_bf16(s[nt], qa[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
    }
    const bool all_live = tile_all_live(p, q_first, q_last, kv_limit, k0, BN);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v = s[nt][c] * p.scale_log2;
        if (!all_live)
          v = mask_score(p, v, p.q_off + row[c >> 1], k0 + nt * 8 + tg * 2 + (c & 1),
                         kv_limit);
        s[nt][c] = v;
      }

    // online softmax; the 4 threads of a fragment row group share each row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][2 * r] = exp2f(s[nt][2 * r] - mx);
        s[nt][2 * r + 1] = exp2f(s[nt][2 * r + 1] - mx);
        sum += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    // O += P V: the S fragments of key tiles 2kk, 2kk+1 form P's A operand
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vr = vt_s + (n * 8 + g) * VP + kk * 16 + tg * 2;
        mma_bf16(o[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.out) + (size_t)bh * p.T * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float l_safe = fmaxf(lr, 1e-20f);
    const float inv = 1.f / l_safe;
    if (row[r] < p.T) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<uint32_t*>(O + (size_t)row[r] * D + n * 8 + tg * 2) =
            pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
      if (tg == 0) p.lse[(size_t)bh * p.T + row[r]] = m[r] * kLn2 + logf(l_safe);
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

template <int D>
cudaError_t launch(const Params& p, bool bf16, cudaStream_t stream) {
  const dim3 grid(p.B * p.H, (p.T + kBlockM - 1) / kBlockM);
  if (bf16)
    flash_fwd_bf16_kernel<D><<<grid, 128, 0, stream>>>(p);
  else
    flash_fwd_f32_kernel<D><<<grid, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q [B*H, T, d], k/v [B*H_kv, T_kv, d] contiguous, bf16 (is_bf16=1) or f32;
// out like q; lse [B*H, T] f32; kv_len [B] int32 or null. Launches on
// `stream` and returns the launch's cudaError_t (0 = success).
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
