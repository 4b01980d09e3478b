// Flash-attention backward, GQA, causal / sliding-window masks.
//
// The TPU kernel `_flash_kernel` of src/repro/kernels/flash_attention.py is
// forward only: the reference differentiates its plain attention
// (`attend_dense` / `attend_blockwise`) instead.  The port's forward on the
// card is the kernel of flash_attention.cu, so a train step needs this
// backward.  Given q, k, v, the forward's output o, its row log-sum-exp lse
// (the LSE variant of the forward) and dO, it computes
//
//   delta = rowsum(dO * O)                                   (delta kernel)
//   P  = exp(scale * Q K^T - lse), 0 where masked
//   dV = sum_g P^T dO,  dP = dO V^T,  dS = P * (dP - delta)
//   dK = scale * sum_g dS^T Q                                (dK/dV kernel)
//   dQ = scale * dS K                                        (dQ kernel)
//
// recomputing P from the scores rather than storing it.  dK/dV and dQ are
// separate kernels, so that nothing needs atomics and every sum is taken in
// the same order on every run; the price is that the dQ kernel computes S and
// dP again (seven products of a tile pair where a fused backward has five).
//
// On this card the backward is bound by operations (the seven products are
// 14 D operations a visible (q, key) pair: about 1,300 operations a byte of
// its inputs and outputs at phi4-mini's train shape, against the 295 at which
// the tensor cores and device memory balance), so the train path's case is
// built around the tensor cores:
//
//   * bf16 with 16-byte aligned operands (the train path's) at one head dim
//     of 64, 128 or 256, or MLA's (192, 128): TMA loads and wgmma products,
//     every tile in shared memory as rows of 128 bytes with the 128-byte
//     swizzle (hopper.cuh); a row of 192 or 256 arrives as 3 or 4 boxes of 64
//     columns.  Every kernel is a template over (DQ, DV), q's and k's head
//     dim and v's; one head dim is (D, D).  Up to D = 128 a block is one
//     warpgroup (128 threads, two blocks an SM, so that a thread may hold
//     255 registers: dK and dV of 64 rows x 128 in fp32, S^T and dP^T, and
//     their bf16 halves take about 230; at D 64 three dK/dV blocks an SM,
//     BwdPlan says why); its first thread issues the TMA
//     loads one ring stage ahead.  A producer warp of its own would put the
//     block at 160 threads and cap a thread at 200 registers.  Above D = 128
//     (BwdPlan::SPLIT) a dK/dV block is two warpgroups, one block an SM: one
//     owns dV and P^T, the other dK and dP^T, dS^T (the kernel's note says
//     why that split); a dQ block stays one warpgroup (BwdPlan says how
//     many share an SM).
//       - dK/dV kernel, one block a (batch, q head, kv tile of 64): K and V
//         loaded once; Q, dO and their rows of lse and delta through a ring
//         of STAGES stages of 64 q rows.  S^T = K Q^T and dP^T = V dO^T with
//         both operands in shared memory; P^T and dS^T rounded to bf16 in
//         registers as the A operand of dV += P^T dO and dK += dS^T Q, where
//         dO and Q are read through MN-major (transposed) descriptors, as the
//         forward reads V: no transposed copy of any tile.  The G q heads of
//         a group are split over G blocks (G = 1 writes dK and dV directly).
//         At D 128 (BwdPlan::CHAIN) the G blocks of a kv tile add their dK,
//         dV in head order into one fp32 sum a kv head, (B, Hkv, Sk, D),
//         which stays in L2: the block of head g waits on a counter until
//         head g - 1's has added, adds, and passes the turn on; the last
//         head's block writes dK and dV in bf16 (`chain_grads`).  At the
//         other widths each block writes its partial dK, dV in fp32 to a (B,
//         H, Sk, D) workspace, and `flash_bwd_sum_kernel` sums the G in head
//         order.  Both sum in the same order, so they give the same bits.
//         (An earlier design, the group's last block summing the H-sized
//         partials itself, was measured no faster on an H100 than the sum
//         kernel: the fence and the wait on the others' partials took what
//         the launch saved.)
//       - dQ kernel, one block a (batch, q head, q tile of 64): Q and dO
//         loaded once; K and V through a ring.  S = Q K^T, dP = dO V^T, then
//         dQ += dS K with dS from registers and K MN-major.
//       - delta kernel: rowsum(dO * O) and the lse in log2 units, over q rows
//         padded to whole tiles, D/8 threads a row with 16-byte loads.
//       Both grids are one-dimensional and put the heaviest tiles under a
//       causal mask first (the first kv tiles, the last q tiles), over every
//       head, so the last wave holds the lightest blocks.  A tile pair that
//       no mask and no end of Q or K cuts takes no mask arithmetic.
//   * otherwise (fp32, or views off 16 bytes, at any of those dims): fp32
//     FMAs over tiles widened to fp32 in shared memory, the forward's FMA
//     kernel's thread layout (16 x 16 threads, 4 rows x D/16 columns a
//     thread).  TF32 tensor cores would keep about three decimal digits and
//     miss the fp32 tolerance.  At MLA's dims S^T, dS^T, dK and dQ run over
//     192 and delta, dP^T and dV over 128; a dK/dV block of 32 kv rows holds
//     K and Q at 192 and V and dO at 128 as fp32 tiles (91 KB of shared
//     memory, two blocks an SM), a dQ block of 64 q rows 132 KB (one).
//
// P and dS are rounded to bf16 before their products (the forward rounds P
// before P V in the same way); dS is formed from P in fp32.  A fully masked
// row keeps the forward's convention: its output is 0, and so is every
// gradient it sends.
//
// Layout: every tensor (B, heads, S, head dim) with free strides over its
// first three dims (multiples of 4 elements; of 8 for the tensor-core path)
// and stride 1 over the head dim; lse (B, H, Sq) contiguous fp32.  The wrapper allocates the
// workspace (`flash_attention_bwd_workspace`); the kernels allocate nothing.
#include "common.cuh"
#include "hopper.cuh"

#define FB_THREADS 256

enum { T_Q = 0, T_K, T_V, T_O, T_DO, T_DQ, T_DK, T_DV, T_N };

struct BwdParams {
  const void* t[T_N];        // q, k, v, o, dO (read); dq, dk, dv (written)
  long long st[T_N][3];      // element strides over (batch, head, seq)
  const float* lse;
  float* delta;
  int H, Hkv, Sq, Sk, causal, window;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* row_ptr(const BwdParams& p, int which, int b, int h, int s) {
  return (const T*)p.t[which] + b * p.st[which][0] + h * p.st[which][1] + s * p.st[which][2];
}

__device__ __forceinline__ bool seen(int q, int k, const BwdParams& p) {
  return q < p.Sq && k < p.Sk && (!p.causal || k <= q) && (p.window <= 0 || k > q - p.window);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// rows [r0, r0 + R) of one (batch, head) of tensor `which` -> fp32 shared
// tile of row stride RS; rows past `n` as zeros.
template <typename T, int D, int R, int RS>
__device__ __forceinline__ void load_tile(float* dst, const BwdParams& p, int which, int b, int h,
                                          int r0, int n) {
  for (int c = threadIdx.x; c < R * (D / 4); c += FB_THREADS) {
    const int r = c / (D / 4), d4 = (c % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) val = load4<T>(row_ptr<T>(p, which, b, h, r0 + r) + d4);
    *reinterpret_cast<float4*>(&dst[r * RS + d4]) = val;
  }
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O): one warp a row, over v's head dim DV.

template <typename T, int DV>
__global__ void __launch_bounds__(FB_THREADS) flash_bwd_delta_kernel(const BwdParams p, int B) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (FB_THREADS / 32) + warp;
  if (row >= (long long)B * p.H * p.Sq) return;   // uniform over the warp
  const int s = (int)(row % p.Sq);
  const int h = (int)((row / p.Sq) % p.H);
  const int b = (int)(row / ((long long)p.Sq * p.H));
  const T* op = row_ptr<T>(p, T_O, b, h, s);
  const T* gp = row_ptr<T>(p, T_DO, b, h, s);
  float acc = 0.f;
  for (int d = lane * 4; d < DV; d += 128) acc += dot4(load4<T>(op + d), load4<T>(gp + d));
  acc = warp_sum(acc);
  if (lane == 0) p.delta[row] = acc;
}

// ---------------------------------------------------------------------------
// The FMA kernels take q and k at head dim DQ and v, o and dO at DV: one
// head dim (DQ = DV), or MLA's (192, 128).  S^T and dS^T sum over DQ, dP^T
// over DV.
//
// dK, dV of one kv tile of BKV rows.  Thread (ty, tx) owns kv rows ty + 16 i
// (i < BKV / 16) and, of a q tile of BQ = 32 rows, columns tx + 16 j (j < 2)
// of S^T and dP^T, columns tx + 16 j (j < DQ / 16) of dK and (j < DV / 16)
// of dV.

template <int DQ, int DV, int BKV> struct DkdvSmem {
  static constexpr int BQ = 32;
  static constexpr int RQ = DQ + 4;   // row stride of the K and Q tiles: (RQ / 4) odd
  static constexpr int RV = DV + 4;   // row stride of the V and dO tiles: (RV / 4) odd
  static constexpr int PS = BQ + 4;   // row stride of P^T and dS^T
  static constexpr int FLOATS = BKV * (RQ + RV) + BQ * (RQ + RV) + 2 * BKV * PS + 2 * BQ;
};

template <typename T, int DQ, int DV, int BKV>
__global__ void __launch_bounds__(FB_THREADS) flash_bwd_dkdv_kernel(const BwdParams p) {
  using Sm = DkdvSmem<DQ, DV, BKV>;
  constexpr int BQ = Sm::BQ, RQ = Sm::RQ, RV = Sm::RV, PS = Sm::PS;
  constexpr int RI = BKV / 16, CQ = DQ / 16, CV = DV / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BKV * RQ;
  float* Qs = Vs + BKV * RV;
  float* Gs = Qs + BQ * RQ;        // dO
  float* Ps = Gs + BQ * RV;        // P^T
  float* Ss = Ps + BKV * PS;       // dS^T
  float* Ls = Ss + BKV * PS;       // lse of the q tile's rows
  float* Dl = Ls + BQ;             // delta of the q tile's rows

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BKV;   // the first kv tiles see the most q rows under a causal mask
  const int G = p.H / p.Hkv;

  load_tile<T, DQ, BKV, RQ>(Ks, p, T_K, b, hk, k0, p.Sk);
  load_tile<T, DV, BKV, RV>(Vs, p, T_V, b, hk, k0, p.Sk);

  float dk[RI][CQ], dv[RI][CV];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int j = 0; j < CQ; ++j) dk[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < CV; ++j) dv[i][j] = 0.f;
  }

  // q rows that can see some row of this kv tile
  const int q_lo = p.causal ? (k0 / BQ) * BQ : 0;
  int q_hi = p.Sq;
  if (p.window > 0) q_hi = min(q_hi, k0 + BKV - 1 + p.window);

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
    const float* delta = p.delta + ((long long)b * p.H + h) * p.Sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();   // the tile before is read to its end
      load_tile<T, DQ, BQ, RQ>(Qs, p, T_Q, b, h, q0, p.Sq);
      load_tile<T, DV, BQ, RV>(Gs, p, T_DO, b, h, q0, p.Sq);
      if (threadIdx.x < BQ) {
        const int q = q0 + threadIdx.x;
        Ls[threadIdx.x] = q < p.Sq ? lse[q] : 0.f;
        Dl[threadIdx.x] = q < p.Sq ? delta[q] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T (over DQ) and dP^T = V dO^T (over DV)
      float s[RI][2], dp[RI][2];
#pragma unroll
      for (int i = 0; i < RI; ++i) { s[i][0] = s[i][1] = 0.f; dp[i][0] = dp[i][1] = 0.f; }
#pragma unroll 2
      for (int d = 0; d < DQ; d += 4) {
        float4 qv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) qv[j] = *reinterpret_cast<const float4*>(&Qs[(tx + 16 * j) * RQ + d]);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float4 kv = *reinterpret_cast<const float4*>(&Ks[(ty + 16 * i) * RQ + d]);
#pragma unroll
          for (int j = 0; j < 2; ++j) s[i][j] += dot4(kv, qv[j]);
        }
      }
#pragma unroll 2
      for (int d = 0; d < DV; d += 4) {
        float4 gv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) gv[j] = *reinterpret_cast<const float4*>(&Gs[(tx + 16 * j) * RV + d]);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float4 vv = *reinterpret_cast<const float4*>(&Vs[(ty + 16 * i) * RV + d]);
#pragma unroll
          for (int j = 0; j < 2; ++j) dp[i][j] += dot4(vv, gv[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = tx + 16 * j;
          const float pt = seen(q0 + c, k0 + ty + 16 * i, p) ? expf(s[i][j] * p.scale - Ls[c]) : 0.f;
          Ps[(ty + 16 * i) * PS + c] = pt;
          Ss[(ty + 16 * i) * PS + c] = pt * (dp[i][j] - Dl[c]);
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q
#pragma unroll 2
      for (int c = 0; c < BQ; c += 4) {
        float pr[RI][4], sr[RI][4];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float4 p4 = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * PS + c]);
          const float4 s4 = *reinterpret_cast<const float4*>(&Ss[(ty + 16 * i) * PS + c]);
          pr[i][0] = p4.x; pr[i][1] = p4.y; pr[i][2] = p4.z; pr[i][3] = p4.w;
          sr[i][0] = s4.x; sr[i][1] = s4.y; sr[i][2] = s4.z; sr[i][3] = s4.w;
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
          for (int j = 0; j < CV; ++j) {
            const float gq = Gs[(c + cc) * RV + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < RI; ++i) dv[i][j] = fmaf(pr[i][cc], gq, dv[i][j]);
          }
#pragma unroll
          for (int j = 0; j < CQ; ++j) {
            const float qq = Qs[(c + cc) * RQ + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < RI; ++i) dk[i][j] = fmaf(sr[i][cc], qq, dk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k < p.Sk) {
      T* dkp = (T*)row_ptr<T>(p, T_DK, b, hk, k);
      T* dvp = (T*)row_ptr<T>(p, T_DV, b, hk, k);
#pragma unroll
      for (int j = 0; j < CQ; ++j) dkp[tx + 16 * j] = from_float<T>(dk[i][j] * p.scale);
#pragma unroll
      for (int j = 0; j < CV; ++j) dvp[tx + 16 * j] = from_float<T>(dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ of one q tile of BQ = 64 rows.  Thread (ty, tx) owns q rows ty + 16 i
// (i < 4) and, of a kv tile of BKV = 32 rows, columns tx + 16 j (j < 2) of S
// and dP, and columns tx + 16 j (j < DQ / 16) of dQ.

template <int DQ, int DV> struct DqSmem {
  static constexpr int BQ = 64, BKV = 32;
  static constexpr int RQ = DQ + 4;
  static constexpr int RV = DV + 4;
  static constexpr int PS = BKV + 4;
  static constexpr int FLOATS = BQ * (RQ + RV) + BKV * (RQ + RV) + BQ * PS;
};

template <typename T, int DQ, int DV>
__global__ void __launch_bounds__(FB_THREADS) flash_bwd_dq_kernel(const BwdParams p) {
  using Sm = DqSmem<DQ, DV>;
  constexpr int BQ = Sm::BQ, BKV = Sm::BKV, RQ = Sm::RQ, RV = Sm::RV, PS = Sm::PS;
  constexpr int CQ = DQ / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + BQ * RQ;        // dO
  float* Ks = Gs + BQ * RV;
  float* Vs = Ks + BKV * RQ;
  float* Ss = Vs + BKV * RV;       // dS

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;   // last (heaviest under causal) q tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * BQ;

  load_tile<T, DQ, BQ, RQ>(Qs, p, T_Q, b, h, q0, p.Sq);
  load_tile<T, DV, BQ, RV>(Gs, p, T_DO, b, h, q0, p.Sq);
  float lse[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    const long long at = ((long long)b * p.H + h) * p.Sq + q;
    lse[i] = q < p.Sq ? p.lse[at] : 0.f;
    delta[i] = q < p.Sq ? p.delta[at] : 0.f;
  }
  float dq[4][CQ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CQ; ++j) dq[i][j] = 0.f;

  // kv rows that some row of this q tile can see
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int kv_hi = p.Sk;
  if (p.causal) kv_hi = min(kv_hi, q_last + 1);
  int kv_lo = 0;
  if (p.window > 0) {
    const int first = q0 - p.window + 1;
    if (first > 0) kv_lo = (first / BKV) * BKV;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BKV) {
    __syncthreads();   // the tile before is read to its end (and Q, dO stored)
    load_tile<T, DQ, BKV, RQ>(Ks, p, T_K, b, hk, k0, p.Sk);
    load_tile<T, DV, BKV, RV>(Vs, p, T_V, b, hk, k0, p.Sk);
    __syncthreads();

    // S = Q K^T (over DQ) and dP = dO V^T (over DV)
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) { s[i][0] = s[i][1] = 0.f; dp[i][0] = dp[i][1] = 0.f; }
#pragma unroll 2
    for (int d = 0; d < DQ; d += 4) {
      float4 kv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * RQ + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * RQ + d]);
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] += dot4(qv, kv[j]);
      }
    }
#pragma unroll 2
    for (int d = 0; d < DV; d += 4) {
      float4 vv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) vv[j] = *reinterpret_cast<const float4*>(&Vs[(tx + 16 * j) * RV + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 gv = *reinterpret_cast<const float4*>(&Gs[(ty + 16 * i) * RV + d]);
#pragma unroll
        for (int j = 0; j < 2; ++j) dp[i][j] += dot4(gv, vv[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j;
        const float pv = seen(q0 + ty + 16 * i, k0 + c, p) ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
        Ss[(ty + 16 * i) * PS + c] = pv * (dp[i][j] - delta[i]);
      }
    __syncthreads();

    // dQ += dS K
#pragma unroll 2
    for (int c = 0; c < BKV; c += 4) {
      float sr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 s4 = *reinterpret_cast<const float4*>(&Ss[(ty + 16 * i) * PS + c]);
        sr[i][0] = s4.x; sr[i][1] = s4.y; sr[i][2] = s4.z; sr[i][3] = s4.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          const float kk = Ks[(c + cc) * RQ + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) dq[i][j] = fmaf(sr[i][cc], kk, dq[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q < p.Sq) {
      T* dqp = (T*)row_ptr<T>(p, T_DQ, b, h, q);
#pragma unroll
      for (int j = 0; j < CQ; ++j) dqp[tx + 16 * j] = from_float<T>(dq[i][j] * p.scale);
    }
  }
}


// ===========================================================================
// bf16 at (64, 64), (128, 128), (256, 256) or (192, 128): TMA + wgmma
// ===========================================================================

// Tile plan of the tensor-core kernels for q/k head dim DQ and v head dim DV;
// kernels/flash_attention.py `bwd_tile_plan` mirrors it (and chip_smoke.py
// holds the two against each other).  Up to a head dim of 128 a dK/dV block
// is one warpgroup, two blocks an SM; above it (SPLIT) two warpgroups, one
// block an SM, so that each thread may hold 255 registers (two such blocks
// would cap a thread at 128, and the block needs 171 at (192, 128), 205 at
// 256).  A dQ block is one warpgroup: two an SM up to 128; one at D 256 (its
// shared memory); two at (192, 128) with a ring of one stage, which on an
// H100 ran its dQ kernel 1.42x as fast as one block with two stages.
//
// At D 64 (LEAN) three dK/dV blocks share an SM.  A tile pair's four
// products are short there (2 MFLOP), and a warpgroup's exponentials and
// elementwise work, which none of its own products covers, took as long as
// they did; a third warpgroup an SM covers more of it.  Three blocks cap a
// thread at 168 registers, where the loop in D 128's order spilled (dK, dV,
// S^T, dP^T and P^T's bf16 half live at once), so at D 64 the same loop (at
// its `if constexpr (P::LEAN)` points) takes S^T first, turns it into P^T,
// keeps P^T's bf16 half in registers and its fp32 values in 16 KB of shared
// memory (each thread its own 32), and only then takes dP^T into the
// registers S^T held: 167 registers, no spill, and 66 KB of shared memory,
// three times in an SM.  dS^T is formed from the same fp32 P^T, so dK and dV
// are the same bits.  A dK/dV block of two warpgroups sharing its ring (128 kv
// rows, the products issued in turns), dK/dV split by gradient over two
// warpgroups at two blocks an SM, a warpgroup keeping the next stage's
// products in flight under this stage's elementwise work, deeper rings, a
// dQ stage of 128 kv rows and a dQ block of two warpgroups all ran slower on
// an H100, and were dropped; the first and the third are kept as patches
// against the tree they were written for (kernels/variants/
// k1_bwd64_{pair,pipe}.patch, timed by chip_smoke.py --variant).
template <int DQ, int DV> struct BwdPlan {
  static constexpr bool LEAN = DQ == 64 && DV == 64;   // three dK/dV blocks an SM, P^T staged
  static constexpr int BQ = 64;          // q rows a tile (a dQ block's rows)
  static constexpr int BKV = 64;         // kv rows a tile (a dK/dV block's rows)
  static constexpr int STAGES = 2;       // depth of each kernel's ring
  static constexpr int CH_Q = DQ / 64;   // 128-byte column chunks of a q or k row
  static constexpr int CH_V = DV / 64;   // and of a v or dO row
  static constexpr bool SPLIT = DQ > 128;
  // G > 1: the group's blocks add dK, dV into one fp32 sum a kv head, in head
  // order (`chain_grads`), rather than writing H-sized partials for
  // `flash_bwd_sum_kernel`.  At yi-34b's B1 H56 Hkv8 S2048 the partials were
  // 117 MB written and read back, past the 50 MB L2; the sums are 16.8 MB.
  static constexpr bool CHAIN = DQ == 128 && DV == 128;
  static constexpr int DKDV_THREADS = SPLIT ? 256 : 128;
  static constexpr int DKDV_BLOCKS = SPLIT ? 1 : LEAN ? 3 : 2;
  static constexpr int DQ_THREADS = 128;
  static constexpr int DQ_STAGES = DQ == DV ? STAGES : 1;   // the dQ block's ring
  static constexpr int DQ_BLOCKS = DQ == DV && DQ > 128 ? 1 : 2;
  static constexpr int TQ = 64 * DQ * 2;      // one 64-row bf16 tile of q or k
  static constexpr int TV = 64 * DV * 2;      // of v or dO
  static constexpr int ROWS = 64 * 4;         // lse or delta of a q tile, fp32
  static constexpr int XCHG = SPLIT || LEAN ? 64 * 64 * 4 : 0;   // P^T in fp32 (SPLIT: between WGs)
  static constexpr int BAR_BYTES = 64;
  // dK/dV: K and V of the block, a ring of (Q, dO, lse, delta), the exchange
  static constexpr int SMEM_DKDV = (1 + STAGES) * (TQ + TV) + XCHG + 2 * STAGES * ROWS + BAR_BYTES;
  // dQ: Q and dO of the block, a ring of (K, V)
  static constexpr int SMEM_DQ = (1 + DQ_STAGES) * (TQ + TV) + BAR_BYTES;
  // the group sum's threads a kv row: 8 columns each, of dK and dV both
  // where they share a width, else of one of them
  static constexpr int SUM_C8 = DQ == DV ? DQ / 8 : (DQ + DV) / 8;
  static_assert(BQ == 64 && BKV == 64, "tiles are m64n64 products");
  static_assert(DQ % 64 == 0 && DV % 64 == 0 && DQ >= DV, "128-byte column chunks");
  static_assert(DQ == DV || SPLIT, "two head dims take the split dK/dV block");
  static_assert(DKDV_BLOCKS * (SMEM_DKDV + 1024) <= 233472, "shared memory of an sm_90 SM");
  static_assert(DQ_BLOCKS * (SMEM_DQ + 1024) <= 233472, "shared memory of an sm_90 SM");
  static_assert((STAGES + 1) * 8 <= BAR_BYTES && DQ_STAGES <= STAGES, "barriers");
  // CHAIN: dK and dV staged in fp32 (rows padded by 8) where K, V and the ring were
  static_assert(!CHAIN || (!SPLIT && 64 * (DQ + DV + 16) * 4 <= (1 + STAGES) * (TQ + TV)),
                "the chain's staging");
};

struct WgParams {
  __nv_bfloat16 *dq, *dk, *dv;
  long long dq_st[3], dk_st[3], dv_st[3];   // element strides over (batch, head, seq)
  float *part_dk, *part_dv;   // (B, H, Sk, DQ) and (B, H, Sk, DV) fp32: each q head's dK, dV (G > 1)
  float *sum_dk, *sum_dv;     // CHAIN, G > 1: (B, Hkv, Sk, DQ) and (B, Hkv, Sk, DV) fp32 running sums
  int* turns;                 // CHAIN, G > 1: (B, Hkv, kv tiles), the heads that have added; 0 first
  int n_turns;                // their count (0 where there are none)
  const float* lse2;          // (B, H, Sq_pad): the forward's lse * log2(e), 0 past Sq
  const float* delta;         // (B, H, Sq_pad): rowsum(dO * O), 0 past Sq
  int B, H, Hkv, Sq, Sk, Sq_pad, causal, window;
  float scale, scale_log2;
};

__device__ __forceinline__ bool seen_wg(int q, int k, const WgParams& p) {
  return q < p.Sq && k < p.Sk && (!p.causal || k <= q) && (p.window <= 0 || k > q - p.window);
}

// Whether the 64 x 64 tile pair of q rows from q0 and kv rows from k0 holds a
// pair that a mask or the end of Q or K takes out (uniform over the block).
__device__ __forceinline__ bool tile_edge(int q0, int k0, const WgParams& p) {
  return q0 + 64 > p.Sq || k0 + 64 > p.Sk || (p.causal && k0 + 63 > q0) ||
         (p.window > 0 && k0 <= q0 + 63 - p.window);
}

// The q tiles (first, count) whose rows can see some row of kv tile kt, and
// the kv tiles (first, count) that some row of q tile qt can see.
// kernels/flash_attention.py `bwd_q_tiles` / `bwd_kv_tiles` mirror them.
__device__ __forceinline__ int2 dkdv_q_tiles(int kt, const WgParams& p) {
  const int k_last = min(kt * 64 + 64, p.Sk) - 1;
  const int lo = p.causal ? kt : 0;
  const int hi = p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;
  return make_int2(lo, hi > lo * 64 ? (hi - lo * 64 + 63) / 64 : 0);
}
__device__ __forceinline__ int2 dq_kv_tiles(int qt, const WgParams& p) {
  const int q0 = qt * 64, q_last = min(q0 + 64, p.Sq) - 1;
  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) / 64 : 0;
  const int hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  return make_int2(lo, hi > lo * 64 ? (hi - lo * 64 + 63) / 64 : 0);
}

// The accumulator fragment of an m64n64 product as the A operand of k16
// products over its 64 columns, rounded to bf16 (hopper.cuh: the register A
// operand of k16 has the shape of two n8 blocks of the accumulator).
__device__ __forceinline__ void frag_to_a(uint32_t* a, const float* f) {
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    a[2 * jb] = pack_bf16(f[4 * jb], f[4 * jb + 1]);
    a[2 * jb + 1] = pack_bf16(f[4 * jb + 2], f[4 * jb + 3]);
  }
}

// S^T of one tile pair (kv rows from k0: this thread's rl and rl + 8; q
// columns from q0: cq, cq + 1 of every 8) into P^T = exp2(S^T * scale log2(e)
// - lse log2(e)) in place, 0 where masked; `ls`: the q tile's lse in log2 units.
__device__ __forceinline__ void p_transposed(float* sc, const float* ls, int q0, int k0, int rl,
                                             int cq, const WgParams& p) {
  const bool edge = tile_edge(q0, k0, p);
#pragma unroll
  for (int jb = 0; jb < 8; ++jb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * jb + cq + e;
      const float l2 = ls[c];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * jb + 2 * hh + e;
        float pt = fast_exp2(fmaf(sc[i], p.scale_log2, -l2));
        if (edge && !seen_wg(q0 + c, k0 + rl + 8 * hh, p)) pt = 0.f;
        sc[i] = pt;
      }
    }
}

// Rows rl and rl + 8 of the kv tile at k0 of one gradient (N columns, the
// accumulator fragment `acc`, times `mul`): bf16 into `out` (strides `st`,
// kv head hk) where the block's sums are the gradient (G = 1), else fp32
// into q head h's partial `part` (B, H, Sk, N).
template <int N>
__device__ __forceinline__ void store_grad(const float* acc, float mul, __nv_bfloat16* out,
                                           const long long* st, float* part, int b, int h,
                                           int hk, int k0, int rl, int cq, const WgParams& p) {
  const bool whole = p.H == p.Hkv;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int k = k0 + rl + 8 * hh;
    if (k >= p.Sk) continue;
    if (whole) {
      __nv_bfloat16* op = out + b * st[0] + hk * st[1] + k * st[2];
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
        *reinterpret_cast<uint32_t*>(op + 8 * i + cq) =
            pack_bf16(acc[4 * i + 2 * hh] * mul, acc[4 * i + 2 * hh + 1] * mul);
    } else {
      float* pp = part + (((long long)b * p.H + h) * p.Sk + k) * N;
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
        *reinterpret_cast<float2*>(pp + 8 * i + cq) =
            make_float2(acc[4 * i + 2 * hh] * mul, acc[4 * i + 2 * hh + 1] * mul);
    }
  }
}

// Blocks of a chained group sum (CHAIN, G > 1) in a head's slab: at least so
// many, so that the block of head g starts that many blocks after head g - 1's
// of the same kv tile (which does the same work) and finds its turn come.
#define CHAIN_SLAB 64

// (kv tile, q head, batch) of this dK/dV block.  The one-dimensional grid
// puts the heaviest kv tiles under a causal mask (the first) first: every
// head's kv tile 0, then every head's tile 1, and so on.  Where the group's
// blocks chain their sum, the kv tiles go in chunks of CH, and a chunk's
// blocks go head by head of the group (head g's CH x Hkv x B blocks, then
// head g + 1's): kernels/flash_attention.py `bwd_block_order` mirrors both.
__device__ __forceinline__ int3 dkdv_block(bool chained, const WgParams& p) {
  if (!chained) {
    const int hb = p.H * p.B;
    return make_int3(blockIdx.x / hb, blockIdx.x % hb % p.H, blockIdx.x % hb / p.H);
  }
  const int G = p.H / p.Hkv, HB = p.Hkv * p.B, nkv = (p.Sk + 63) / 64;
  const int CH = min(nkv, (CHAIN_SLAB + HB - 1) / HB);   // kv tiles a chunk
  const int kc = blockIdx.x / (G * CH * HB);
  const int width = min(CH, nkv - kc * CH);             // the last chunk may be narrower
  int r = blockIdx.x % (G * CH * HB);
  const int g = r / (width * HB);
  r %= width * HB;
  const int hk = r % HB % p.Hkv, b = r % HB / p.Hkv;
  return make_int3(kc * CH + r / HB, hk * G + g, b);
}

// The block of head g of its group waits until `turn` reads g: until the
// blocks of heads 0 .. g - 1 of the same kv tile have added their dK and dV
// (one thread; acquire at the device's scope).  A wait that never ends traps,
// so the launch fails instead of hanging.
__device__ __forceinline__ void wait_turn(const int* turn, int g) {
  uint32_t tries = 0;
  while (true) {
    int seen;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(seen) : "l"(turn) : "memory");
    if (seen == g) return;
    if (++tries == (1u << 24)) __trap();
    __nanosleep(64);
  }
}

// CHAIN: rows rl and rl + 8 of one gradient (N columns, the accumulator
// fragment `acc`, times `mul`) into a 64 x N fp32 tile in shared memory,
// rows padded by 8 floats (the fragment's 8 rows a store then fall on 4 sets
// of banks, not one).
template <int N>
__device__ __forceinline__ void stage_grad(float* st, const float* acc, float mul, int rl, int cq) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
      *reinterpret_cast<float2*>(st + (rl + 8 * hh) * (N + 8) + 8 * i + cq) =
          make_float2(__fmul_rn(acc[4 * i + 2 * hh], mul), __fmul_rn(acc[4 * i + 2 * hh + 1], mul));
}

// CHAIN: one gradient's staged tile (`st`, 64 x N) of the kv tile at k0 added
// to kv head hk's running sum `sum` (B, Hkv, Sk, N) by head g of the group,
// a warp a row of 16-byte vectors: g = 0 starts it (0 + x, as the sum
// kernel), the last head writes the total in bf16 into `out` (strides `ost`).
// The product and the sum are rounded apart (no FMA), as the partial's store
// and the sum kernel round them, so the bits are the sum kernel's.  The sums
// go through L2 (ld/st .cg): another SM's block wrote them.  `s` holds the
// loads, all issued before the first add (a gradient at a time: both at once
// made ptxas spill the kernel).
template <int N>
__device__ __forceinline__ void load_sum(float4* s, const float* sum, int b, int hk, int k0, int g,
                                         const WgParams& p) {
  constexpr int V4 = N / 4;   // 16-byte vectors a row
#pragma unroll
  for (int k = 0; k < 64 * V4 / 128; ++k) {
    const int f = threadIdx.x + 128 * k, row = f / V4;
    const float4* at = reinterpret_cast<const float4*>(
        sum + (((long long)b * p.Hkv + hk) * p.Sk + k0 + row) * N) + f % V4;
    s[k] = g > 0 && k0 + row < p.Sk ? __ldcg(at) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}
template <int N>
__device__ __forceinline__ void add_sum(const float4* s, const float* st, float* sum,
                                        __nv_bfloat16* out, const long long* ost, int b, int hk,
                                        int k0, bool last, const WgParams& p) {
  constexpr int V4 = N / 4;
#pragma unroll
  for (int k = 0; k < 64 * V4 / 128; ++k) {
    const int f = threadIdx.x + 128 * k, row = f / V4, c4 = f % V4;
    if (k0 + row >= p.Sk) continue;
    const float4 x = *reinterpret_cast<const float4*>(st + row * (N + 8) + 4 * c4);
    const float4 v = make_float4(__fadd_rn(s[k].x, x.x), __fadd_rn(s[k].y, x.y),
                                 __fadd_rn(s[k].z, x.z), __fadd_rn(s[k].w, x.w));
    if (last)
      *reinterpret_cast<uint2*>(out + b * ost[0] + hk * ost[1] + (k0 + row) * ost[2] + 4 * c4) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    else
      __stcg(reinterpret_cast<float4*>(sum + (((long long)b * p.Hkv + hk) * p.Sk + k0 + row) * N) +
                 c4, v);
  }
}

// CHAIN (one warpgroup a block), G > 1: this block's dK and dV, q head h's,
// added in head order into kv head hk's running sums, which the last head's
// block writes as dK and dV.  The block stages both in shared memory (`stage`,
// the ring's, read to its end), waits for its turn, then adds a warp a row.
// A block waits only on the block of head g - 1 of the same (batch, kv tile),
// which comes a head's slab (CHAIN_SLAB blocks or more) before it in the
// one-dimensional grid (`dkdv_block`); blocks start in grid order, so that
// block is resident or done, and never waits on this one: no wait is
// circular.  With heads varying fastest the G blocks of a tile started
// together, finished together and then waited on each other's adds, each a
// thread's fragment of scattered 8-byte loads (yi-34b's backward took 1.67x
// the partials' time on an H100; 1.39x with the slabs: kernels/variants/
// k1_bwd128_{fastest,fragment}.patch).  The release after
// every thread's writes and a fence, the acquire before any thread's reads,
// give head g the sum that head g - 1 left.
template <int DQ, int DV>
__device__ __forceinline__ void chain_grads(const float* dk, const float* dv, float* stage, int b,
                                            int h, int hk, int kt, int rl, int cq,
                                            const WgParams& p) {
  const int G = p.H / p.Hkv, g = h - hk * G, k0 = kt * 64;
  float* sk = stage;
  float* sv = stage + 64 * (DQ + 8);
  stage_grad<DQ>(sk, dk, p.scale, rl, cq);
  stage_grad<DV>(sv, dv, 1.f, rl, cq);
  int* turn = p.turns + ((long long)b * p.Hkv + hk) * ((p.Sk + 63) / 64) + kt;
  if (threadIdx.x == 0) wait_turn(turn, g);
  __syncthreads();   // the tiles staged, and head g - 1's sums in place
  const bool last = g == G - 1;
  {
    float4 s_k[64 * DQ / 512];
    load_sum<DQ>(s_k, p.sum_dk, b, hk, k0, g, p);
    add_sum<DQ>(s_k, sk, p.sum_dk, p.dk, p.dk_st, b, hk, k0, last, p);
  }
  {
    float4 s_v[64 * DV / 512];
    load_sum<DV>(s_v, p.sum_dv, b, hk, k0, g, p);
    add_sum<DV>(s_v, sv, p.sum_dv, p.dv, p.dv_st, b, hk, k0, last, p);
  }
  if (last) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(turn), "r"(g + 1) : "memory");
}

// delta and the lse in log2 units of the (B, H, Sq_pad) rows: DV/8 threads a
// row, 16-byte loads of O and dO; rows past Sq get 0 in both, so that a q
// tile's 64 values of either are one aligned bulk copy.  It also sets the
// chain's turns to 0 (it runs before the dK/dV kernel, on the same stream).
template <int DV>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_wg_kernel(const BwdParams f, const WgParams p, float* delta, float* lse2) {
  constexpr int LANES = DV / 8;   // threads a row: 32, 16 or 8, within one warp
  const long long gt = (long long)blockIdx.x * 256 + threadIdx.x;
  for (long long i = gt; i < p.n_turns; i += (long long)gridDim.x * 256) p.turns[i] = 0;
  const long long row = gt / LANES;
  const int part = (int)(gt % LANES);
  const bool live = row < (long long)p.B * p.H * p.Sq_pad;
  const int s = (int)(row % p.Sq_pad);
  const int h = (int)((row / p.Sq_pad) % p.H);
  const int b = (int)(row / ((long long)p.Sq_pad * p.H));
  float acc = 0.f;
  if (live && s < p.Sq) {
    const uint4 o = *reinterpret_cast<const uint4*>(row_ptr<__nv_bfloat16>(f, T_O, b, h, s) + 8 * part);
    const uint4 g = *reinterpret_cast<const uint4*>(row_ptr<__nv_bfloat16>(f, T_DO, b, h, s) + 8 * part);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(o2[e]), c = __bfloat1622float2(g2[e]);
      acc += a.x * c.x + a.y * c.y;
    }
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && part == 0) {
    const bool in = s < p.Sq;
    delta[row] = in ? acc : 0.f;
    lse2[row] = in ? f.lse[((long long)b * p.H + h) * p.Sq + s] * 1.4426950408889634f : 0.f;
  }
}

// Named barriers of the split dK/dV block (0 is __syncthreads).
#define BAR_P 1      // warpgroup 0 has written P^T of the tile
#define BAR_TILE 2   // both warpgroups are done with the tile's ring stage

// One block a (batch, q head, kv tile): dK and dV of the tile from this q
// head alone.  Thread (warp w, lane l) of a warpgroup holds kv rows
// 16w + l/4 (+ 8) of the tile and q columns 8j + 2(l%4) (+ 1) of S^T and
// dP^T, and the same rows of dK and dV in columns 8i + 2(l%4) (+ 1).
//
// One warpgroup (up to a head dim of 128) runs all four products.  Above it
// dK and dV of 64 rows alone are 2 x 64 x 256 fp32 / 128 threads = 256
// registers a thread at D 256, so the block has two warpgroups, split by
// gradient: warpgroup 0 owns dV, computes S^T = K Q^T and P^T, hands P^T in
// fp32 to warpgroup 1 through shared memory behind a named barrier and runs
// dV += P^T dO; warpgroup 1 owns dK, computes dP^T = V dO^T, forms dS^T from
// that P^T and runs dK += dS^T Q.  The split keeps every product whole-width
// (a split by columns would cut (192, 128)'s dK in halves of 96, inside a
// 64-column swizzle chunk), passes one tile in one direction, and balances the
// tensor-core work for any widths: S^T + dV and dP^T + dK are both 64 (DQ +
// DV) multiply-adds a q row.  Registers a thread: dV or dK (128 at D 256,
// 64 or 96 at (192, 128)), S^T or dP^T (32) and its bf16 half (16).
template <int DQ, int DV>
__global__ void __launch_bounds__(BwdPlan<DQ, DV>::DKDV_THREADS, BwdPlan<DQ, DV>::DKDV_BLOCKS)
    flash_bwd_dkdv_wg_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo, const WgParams p) {
  using P = BwdPlan<DQ, DV>;
  constexpr int ST = P::STAGES, TQ = P::TQ, TV = P::TV;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  if (smem_u32(smem_raw) & 1023) __trap();
  uint8_t* k_s = smem_raw;                 // [CH_Q][64 rows][128 B]
  uint8_t* v_s = k_s + TQ;                 // [CH_V][64 rows][128 B]
  uint8_t* q_s = v_s + TV;                 // [ST] tiles of TQ
  uint8_t* g_s = q_s + ST * TQ;            // dO, [ST] tiles of TV
  float* x_s = reinterpret_cast<float*>(g_s + ST * TV);       // P^T, [32][128 threads] (SPLIT, LEAN)
  float* lse_s = x_s + P::XCHG / 4;                            // [ST][64]
  float* dl_s = lse_s + ST * 64;                               // [ST][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(dl_s + ST * 64);
  uint64_t* kv_full = full + ST;

  // every head's kv tile 0 first: under a causal mask the first kv tiles see the most q rows
  const int3 blk = dkdv_block(P::CHAIN && p.H > p.Hkv, p);
  const int kt = blk.x, h = blk.y, b = blk.z;
  const int hk = h / (p.H / p.Hkv);
  const int k0 = kt * 64;
  const int2 qr = dkdv_q_tiles(kt, p);
  const int q_first = qr.x * 64, n = qr.y;
  const long long row0 = ((long long)b * p.H + h) * p.Sq_pad;
  const int t = threadIdx.x;

  // thread 0: q tile j of the walk into stage j % ST
  auto load_q = [&](int j) {
    const int s = j % ST, q0 = q_first + j * 64;
    mbar_arrive_expect_tx(&full[s], TQ + TV + 2 * P::ROWS);
#pragma unroll
    for (int c = 0; c < P::CH_Q; ++c)
      tma_load_4d(q_s + s * TQ + c * 64 * 128, &tq, &full[s], c * 64, q0, h, b);
#pragma unroll
    for (int c = 0; c < P::CH_V; ++c)
      tma_load_4d(g_s + s * TV + c * 64 * 128, &tdo, &full[s], c * 64, q0, h, b);
    bulk_load(lse_s + s * 64, p.lse2 + row0 + q0, P::ROWS, &full[s]);
    bulk_load(dl_s + s * 64, p.delta + row0 + q0, P::ROWS, &full[s]);
  };
  if (t == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) mbar_init(&full[s], 1);
    mbar_init(kv_full, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (t == 0 && n > 0) {
    mbar_arrive_expect_tx(kv_full, TQ + TV);
#pragma unroll
    for (int c = 0; c < P::CH_Q; ++c) tma_load_4d(k_s + c * 64 * 128, &tk, kv_full, c * 64, k0, hk, b);
#pragma unroll
    for (int c = 0; c < P::CH_V; ++c) tma_load_4d(v_s + c * 64 * 128, &tv, kv_full, c * 64, k0, hk, b);
    for (int j = 0; j < n && j < ST; ++j) load_q(j);
  }

  // warp-uniform by construction (a broadcast): the warpgroup's role
  const int wg = P::SPLIT ? __shfl_sync(0xffffffffu, t / 128, 0) : 0;
  const int tw = t & 127, warp = tw >> 5, lane = tw & 31;
  const int rl = warp * 16 + (lane >> 2);   // this thread's kv rows in the tile: rl, rl + 8
  const int cq = 2 * (lane & 3);            // and columns cq, cq + 1 of every 8
  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
  if (n > 0) mbar_wait(kv_full, 0);

  if constexpr (!P::SPLIT) {
    float dk[DQ / 2], dv[DV / 2];
#pragma unroll
    for (int i = 0; i < DQ / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;
    for (int j = 0; j < n; ++j) {
      const int s = j % ST, q0 = q_first + j * 64;
      const uint32_t q_addr = smem_u32(q_s + s * TQ), g_addr = smem_u32(g_s + s * TV);
      const float* dls = dl_s + s * 64;
      float sc[32], dp[32];
      uint32_t pa[16], sa[16];
      mbar_wait(&full[s], (j / ST) & 1);
      issue_qk<DQ, 64>(sc, k_addr, q_addr);   // S^T = K Q^T
      if constexpr (!P::LEAN) issue_qk<DV, 64>(dp, v_addr, g_addr);   // dP^T = V dO^T
      wgmma_wait<0>();
      fence_all<32>(sc);
      if constexpr (!P::LEAN) fence_all<32>(dp);
      p_transposed(sc, lse_s + s * 64, q0, k0, rl, cq, p);
      frag_to_a(pa, sc);
      if constexpr (P::LEAN) {
        // P^T's fp32 values wait in shared memory, and dP^T takes S^T's registers (BwdPlan)
#pragma unroll
        for (int i = 0; i < 32; ++i) x_s[i * 128 + t] = sc[i];
        issue_qk<DV, 64>(dp, v_addr, g_addr);   // dP^T = V dO^T
        wgmma_wait<0>();
        fence_all<32>(dp);
      } else {
        issue_pv<DV, 64>(dv, pa, g_addr);     // dV += P^T dO, dO read MN-major
      }
      // dS^T = P^T (dP^T - delta), while that product runs (LEAN: P^T read back in fp32)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = dls[8 * jb + cq + e];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 4 * jb + 2 * hh + e;
            dp[i] = (P::LEAN ? x_s[i * 128 + t] : sc[i]) * (dp[i] - dl);
          }
        }
      frag_to_a(sa, dp);
      if constexpr (P::LEAN) issue_pv<DV, 64>(dv, pa, g_addr);   // dV += P^T dO
      issue_pv<DQ, 64>(dk, sa, q_addr);       // dK += dS^T Q, Q read MN-major
      wgmma_wait<0>();
      fence_all<DV / 2>(dv);
      fence_all<DQ / 2>(dk);
      __syncthreads();                        // every warp is done with stage s
      if (t == 0 && j + ST < n) load_q(j + ST);
    }
    if constexpr (P::CHAIN) {
      if (p.H > p.Hkv) {
        chain_grads<DQ, DV>(dk, dv, reinterpret_cast<float*>(smem_raw), b, h, hk, kt, rl, cq, p);
        return;
      }
    }
    store_grad<DQ>(dk, p.scale, p.dk, p.dk_st, p.part_dk, b, h, hk, k0, rl, cq, p);
    store_grad<DV>(dv, 1.f, p.dv, p.dv_st, p.part_dv, b, h, hk, k0, rl, cq, p);
  } else if (wg == 0) {
    // ---- P^T and dV ----
    float dv[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;
    for (int j = 0; j < n; ++j) {
      const int s = j % ST, q0 = q_first + j * 64;
      const uint32_t q_addr = smem_u32(q_s + s * TQ), g_addr = smem_u32(g_s + s * TV);
      float sc[32];
      uint32_t pa[16];
      mbar_wait(&full[s], (j / ST) & 1);
      issue_qk<DQ, 64>(sc, k_addr, q_addr);   // S^T = K Q^T
      wgmma_wait<0>();
      fence_all<32>(sc);
      p_transposed(sc, lse_s + s * 64, q0, k0, rl, cq, p);
#pragma unroll
      for (int i = 0; i < 32; ++i) x_s[i * 128 + tw] = sc[i];
      named_bar_arrive(BAR_P, 256);           // P^T to warpgroup 1
      frag_to_a(pa, sc);
      issue_pv<DV, 64>(dv, pa, g_addr);       // dV += P^T dO, dO read MN-major
      wgmma_wait<0>();
      fence_all<DV / 2>(dv);
      named_bar_sync(BAR_TILE, 256);          // stage s and x_s are read to their end
      if (t == 0 && j + ST < n) load_q(j + ST);
    }
    store_grad<DV>(dv, 1.f, p.dv, p.dv_st, p.part_dv, b, h, hk, k0, rl, cq, p);
  } else {
    // ---- dP^T, dS^T and dK ----
    float dk[DQ / 2];
#pragma unroll
    for (int i = 0; i < DQ / 2; ++i) dk[i] = 0.f;
    for (int j = 0; j < n; ++j) {
      const int s = j % ST;
      const uint32_t q_addr = smem_u32(q_s + s * TQ), g_addr = smem_u32(g_s + s * TV);
      const float* dls = dl_s + s * 64;
      float dp[32];
      uint32_t sa[16];
      mbar_wait(&full[s], (j / ST) & 1);
      issue_qk<DV, 64>(dp, v_addr, g_addr);   // dP^T = V dO^T
      wgmma_wait<0>();
      fence_all<32>(dp);
      named_bar_sync(BAR_P, 256);             // P^T from warpgroup 0
      // dS^T = P^T (dP^T - delta), P^T in fp32 as warpgroup 0 formed it
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = dls[8 * jb + cq + e];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 4 * jb + 2 * hh + e;
            dp[i] = x_s[i * 128 + tw] * (dp[i] - dl);
          }
        }
      frag_to_a(sa, dp);
      issue_pv<DQ, 64>(dk, sa, q_addr);       // dK += dS^T Q, Q read MN-major
      wgmma_wait<0>();
      fence_all<DQ / 2>(dk);
      named_bar_sync(BAR_TILE, 256);
    }
    store_grad<DQ>(dk, p.scale, p.dk, p.dk_st, p.part_dk, b, h, hk, k0, rl, cq, p);
  }
}

// dK, dV of each kv head: the G q heads' fp32 partials summed in head order
// (the same order on every run) and rounded to bf16; 8 columns a thread, of
// dK and dV both where they share a width, else of one of them.
template <int DQ, int DV>
__global__ void __launch_bounds__(256) flash_bwd_sum_kernel(const WgParams p) {
  constexpr bool BOTH = DQ == DV;
  constexpr int C8 = BwdPlan<DQ, DV>::SUM_C8;
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (long long)p.B * p.Hkv * p.Sk * C8) return;
  const int d8 = (int)(idx % C8) * 8;
  const int k = (int)((idx / C8) % p.Sk);
  const int hk = (int)((idx / ((long long)C8 * p.Sk)) % p.Hkv);
  const int b = (int)(idx / ((long long)C8 * p.Sk * p.Hkv));
  const int G = p.H / p.Hkv;
  const bool of_k = BOTH || d8 < DQ, of_v = BOTH || d8 >= DQ;
  const int v8 = BOTH ? d8 : d8 - DQ;
  float sk[8], sv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sk[e] = 0.f;
    sv[e] = 0.f;
  }
  for (int g = 0; g < G; ++g) {
    const long long row = ((long long)b * p.H + hk * G + g) * p.Sk + k;
    if (of_k) {
      const float4 k0 = *reinterpret_cast<const float4*>(p.part_dk + row * DQ + d8);
      const float4 k1 = *reinterpret_cast<const float4*>(p.part_dk + row * DQ + d8 + 4);
      sk[0] += k0.x; sk[1] += k0.y; sk[2] += k0.z; sk[3] += k0.w;
      sk[4] += k1.x; sk[5] += k1.y; sk[6] += k1.z; sk[7] += k1.w;
    }
    if (of_v) {
      const float4 v0 = *reinterpret_cast<const float4*>(p.part_dv + row * DV + v8);
      const float4 v1 = *reinterpret_cast<const float4*>(p.part_dv + row * DV + v8 + 4);
      sv[0] += v0.x; sv[1] += v0.y; sv[2] += v0.z; sv[3] += v0.w;
      sv[4] += v1.x; sv[5] += v1.y; sv[6] += v1.z; sv[7] += v1.w;
    }
  }
  if (of_k)
    *reinterpret_cast<uint4*>(p.dk + b * p.dk_st[0] + hk * p.dk_st[1] + k * p.dk_st[2] + d8) =
        make_uint4(pack_bf16(sk[0], sk[1]), pack_bf16(sk[2], sk[3]), pack_bf16(sk[4], sk[5]),
                   pack_bf16(sk[6], sk[7]));
  if (of_v)
    *reinterpret_cast<uint4*>(p.dv + b * p.dv_st[0] + hk * p.dv_st[1] + k * p.dv_st[2] + v8) =
        make_uint4(pack_bf16(sv[0], sv[1]), pack_bf16(sv[2], sv[3]), pack_bf16(sv[4], sv[5]),
                   pack_bf16(sv[6], sv[7]));
}

// One block a (batch, q head, q tile): dQ of the tile.  Thread (warp w, lane
// l) holds q rows 16w + l/4 (+ 8) of the tile, kv columns 8j + 2(l%4) (+ 1)
// of S and dP, and the same rows of dQ.  One warpgroup at every width: at D
// 256 dQ (128), S and dP (64) and dS's bf16 half (16) fit a thread's 255
// registers, with one block an SM; at (192, 128) two blocks of a one-stage
// ring share an SM.
template <int DQ, int DV>
__global__ void __launch_bounds__(BwdPlan<DQ, DV>::DQ_THREADS, BwdPlan<DQ, DV>::DQ_BLOCKS)
    flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo, const WgParams p) {
  using P = BwdPlan<DQ, DV>;
  constexpr int ST = P::DQ_STAGES, TQ = P::TQ, TV = P::TV;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  if (smem_u32(smem_raw) & 1023) __trap();
  uint8_t* q_s = smem_raw;                 // [CH_Q][64 rows][128 B]
  uint8_t* g_s = q_s + TQ;                 // dO, [CH_V][64 rows][128 B]
  uint8_t* k_s = g_s + TV;                 // [ST] tiles of TQ
  uint8_t* v_s = k_s + ST * TQ;            // [ST] tiles of TV
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + ST * TV);
  uint64_t* qg_full = full + ST;

  // every head's last q tile first: under a causal mask the last q tiles see the most keys
  const int hb = p.H * p.B, nq = (p.Sq + 63) / 64;
  const int qt = nq - 1 - (int)(blockIdx.x / hb);
  const int h = blockIdx.x % hb % p.H, b = blockIdx.x % hb / p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * 64;
  const int2 kr = dq_kv_tiles(qt, p);
  const int k_first = kr.x * 64, n = kr.y;
  const int t = threadIdx.x;

  // thread 0: kv tile j of the walk into stage j % ST
  auto load_kv = [&](int j) {
    const int s = j % ST, k0 = k_first + j * 64;
    mbar_arrive_expect_tx(&full[s], TQ + TV);
#pragma unroll
    for (int c = 0; c < P::CH_Q; ++c)
      tma_load_4d(k_s + s * TQ + c * 64 * 128, &tk, &full[s], c * 64, k0, hk, b);
#pragma unroll
    for (int c = 0; c < P::CH_V; ++c)
      tma_load_4d(v_s + s * TV + c * 64 * 128, &tv, &full[s], c * 64, k0, hk, b);
  };
  if (t == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) mbar_init(&full[s], 1);
    mbar_init(qg_full, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (t == 0 && n > 0) {
    mbar_arrive_expect_tx(qg_full, TQ + TV);
#pragma unroll
    for (int c = 0; c < P::CH_Q; ++c) tma_load_4d(q_s + c * 64 * 128, &tq, qg_full, c * 64, q0, h, b);
#pragma unroll
    for (int c = 0; c < P::CH_V; ++c) tma_load_4d(g_s + c * 64 * 128, &tdo, qg_full, c * 64, q0, h, b);
    for (int j = 0; j < n && j < ST; ++j) load_kv(j);
  }

  const int warp = t >> 5, lane = t & 31;
  const int r0 = q0 + warp * 16 + (lane >> 2);   // this thread's q rows: r0 and r0 + 8
  const int cq = 2 * (lane & 3);                 // and columns cq, cq + 1 of every 8
  const long long row0 = ((long long)b * p.H + h) * p.Sq_pad;
  float l2[2], dl[2];   // rows past Sq read the padding's 0: their P is masked anyway
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l2[hh] = p.lse2[row0 + r0 + 8 * hh];
    dl[hh] = p.delta[row0 + r0 + 8 * hh];
  }
  float dq[DQ / 2];
#pragma unroll
  for (int i = 0; i < DQ / 2; ++i) dq[i] = 0.f;
  const uint32_t q_addr = smem_u32(q_s), g_addr = smem_u32(g_s);
  if (n > 0) mbar_wait(qg_full, 0);

  for (int j = 0; j < n; ++j) {
    const int s = j % ST, k0 = k_first + j * 64;
    const uint32_t k_addr = smem_u32(k_s + s * TQ), v_addr = smem_u32(v_s + s * TV);
    float sc[32], dp[32];
    uint32_t sa[16];
    mbar_wait(&full[s], (j / ST) & 1);
    issue_qk<DQ, 64>(sc, q_addr, k_addr);   // S = Q K^T
    issue_qk<DV, 64>(dp, g_addr, v_addr);   // dP = dO V^T
    wgmma_wait<0>();
    fence_all<32>(sc);
    fence_all<32>(dp);
    const bool edge = tile_edge(q0, k0, p);
    // dS = P (dP - delta) with P = exp2(S * scale log2(e) - lse log2(e)), 0 where masked
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jb + 2 * hh + e;
          float pt = fast_exp2(fmaf(sc[i], p.scale_log2, -l2[hh]));
          if (edge && !seen_wg(r0 + 8 * hh, k0 + 8 * jb + cq + e, p)) pt = 0.f;
          dp[i] = pt * (dp[i] - dl[hh]);
        }
    frag_to_a(sa, dp);
    issue_pv<DQ, 64>(dq, sa, k_addr);       // dQ += dS K, K read MN-major
    wgmma_wait<0>();
    fence_all<DQ / 2>(dq);
    __syncthreads();                        // every warp is done with stage s
    if (t == 0 && j + ST < n) load_kv(j + ST);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int q = r0 + 8 * hh;
    if (q >= p.Sq) continue;
    __nv_bfloat16* dqp = p.dq + b * p.dq_st[0] + h * p.dq_st[1] + q * p.dq_st[2];
#pragma unroll
    for (int i = 0; i < DQ / 8; ++i)
      *reinterpret_cast<uint32_t*>(dqp + 8 * i + cq) =
          pack_bf16(dq[4 * i + 2 * hh] * p.scale, dq[4 * i + 2 * hh + 1] * p.scale);
  }
}

// ---- host side ------------------------------------------------------------

template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the (q/k, v) head dims of both paths: one head dim, or MLA's
#define BWD_DIMS(X) X(64, 64) X(128, 128) X(256, 256) X(192, 128)

// Whether the tensor-core kernels at (D, Dv) chain the group's sum (BwdPlan::CHAIN).
static bool chains(int D, int Dv) {
#define CH(dq, dv) if (D == dq && Dv == dv) return BwdPlan<dq, dv>::CHAIN;
  BWD_DIMS(CH)
#undef CH
  return false;
}

// The workspace of a launch, carved in this order: the FMA path's delta of
// (B, H, Sq) rows; or the tensor-core path's delta and lse (log2 units) of
// (B, H, Sq_pad) rows, then for G > 1 either (CHAIN) each kv head's running
// sums of dK (B, Hkv, Sk, D) and dV (B, Hkv, Sk, Dv), fp32, and the turns, an
// int a (batch, kv head, kv tile), or each q head's partial dK (B, H, Sk, D)
// and dV (B, H, Sk, Dv), fp32.  Every part starts on 256 bytes.
// kernels/flash_attention.py `bwd_workspace_bytes` mirrors the total.
struct BwdWs {
  long long lse2, part, turns, n_turns, total;
};
static BwdWs bwd_workspace(int B, int H, int Hkv, int Sq, int Sk, int D, int Dv, bool wg) {
  if (!wg) return BwdWs{0, 0, 0, 0, (long long)B * H * Sq * 4};
  const long long rows = (long long)B * H * ((Sq + 63) / 64 * 64) * 4;
  if (H == Hkv) return BwdWs{rows, 2 * rows, 2 * rows, 0, 2 * rows};
  if (chains(D, Dv)) {
    const long long sums = (long long)B * Hkv * Sk * (D + Dv) * 4;
    const long long n_turns = (long long)B * Hkv * ((Sk + 63) / 64);
    return BwdWs{rows, 2 * rows, 2 * rows + sums, n_turns,
                 2 * rows + sums + (n_turns * 4 + 255) / 256 * 256};
  }
  const long long part = (long long)B * H * Sk * (D + Dv) * 4;
  return BwdWs{rows, 2 * rows, 2 * rows + part, 0, 2 * rows + part};
}

// kv rows a dK/dV block of the FMA kernels: 64 up to a q/k head dim of 128,
// else 32, so that dK and dV stay at 64 registers a thread at D = 256 (40 at
// MLA's (192, 128)); kernels/flash_attention.py `bwd_fma_plan` mirrors it
template <int DQ> struct DkdvRows { static constexpr int value = DQ <= 128 ? 64 : 32; };

template <int DQ, int DV> struct FmaPlan {
  static constexpr int BKV = DkdvRows<DQ>::value;
  static constexpr size_t DKDV_BYTES = (size_t)DkdvSmem<DQ, DV, BKV>::FLOATS * sizeof(float);
  static constexpr size_t DQ_BYTES = (size_t)DqSmem<DQ, DV>::FLOATS * sizeof(float);
};

template <typename T, int DQ, int DV>
static cudaError_t run_bwd(const BwdParams& p, int B, cudaStream_t s) {
  using F = FmaPlan<DQ, DV>;
  constexpr int BKV = F::BKV;
  static bool attr_set = false;
  cudaError_t e;
  if (!attr_set) {
    if ((e = allow_smem(flash_bwd_dkdv_kernel<T, DQ, DV, BKV>, F::DKDV_BYTES)) != cudaSuccess) return e;
    if ((e = allow_smem(flash_bwd_dq_kernel<T, DQ, DV>, F::DQ_BYTES)) != cudaSuccess) return e;
    attr_set = true;
  }
  const long long rows = (long long)B * p.H * p.Sq;
  const int per_block = FB_THREADS / 32;
  flash_bwd_delta_kernel<T, DV><<<(unsigned)((rows + per_block - 1) / per_block), FB_THREADS, 0, s>>>(p, B);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 g_kv((p.Sk + BKV - 1) / BKV, p.Hkv, B);
  flash_bwd_dkdv_kernel<T, DQ, DV, BKV><<<g_kv, FB_THREADS, F::DKDV_BYTES, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  constexpr int BQ = DqSmem<DQ, DV>::BQ;
  const dim3 g_q((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_bwd_dq_kernel<T, DQ, DV><<<g_q, FB_THREADS, F::DQ_BYTES, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t run_bwd_d(const BwdParams& p, int B, int D, int Dv, cudaStream_t s) {
#define RUN(dq, dv) if (D == dq && Dv == dv) return run_bwd<T, dq, dv>(p, B, s);
  BWD_DIMS(RUN)
#undef RUN
  return cudaErrorInvalidValue;
}

template <int DQ, int DV>
static cudaError_t run_bwd_wg(const BwdParams& f, int B, uint8_t* ws, cudaStream_t s) {
  using P = BwdPlan<DQ, DV>;
  static bool attr_set = false;
  cudaError_t e;
  if (!attr_set) {
    if ((e = allow_smem(flash_bwd_dkdv_wg_kernel<DQ, DV>, P::SMEM_DKDV)) != cudaSuccess) return e;
    if ((e = allow_smem(flash_bwd_dq_wg_kernel<DQ, DV>, P::SMEM_DQ)) != cudaSuccess) return e;
    attr_set = true;
  }
  const BwdWs w = bwd_workspace(B, f.H, f.Hkv, f.Sq, f.Sk, DQ, DV, true);
  WgParams p;
  p.dq = (__nv_bfloat16*)f.t[T_DQ];
  p.dk = (__nv_bfloat16*)f.t[T_DK];
  p.dv = (__nv_bfloat16*)f.t[T_DV];
  for (int j = 0; j < 3; ++j) {
    p.dq_st[j] = f.st[T_DQ][j];
    p.dk_st[j] = f.st[T_DK][j];
    p.dv_st[j] = f.st[T_DV][j];
  }
  p.B = B; p.H = f.H; p.Hkv = f.Hkv; p.Sq = f.Sq; p.Sk = f.Sk;
  p.Sq_pad = (f.Sq + 63) / 64 * 64;
  p.causal = f.causal; p.window = f.window;
  p.scale = f.scale;
  p.scale_log2 = f.scale * 1.4426950408889634f;
  float* delta = reinterpret_cast<float*>(ws);
  float* lse2 = reinterpret_cast<float*>(ws + w.lse2);
  p.delta = delta;
  p.lse2 = lse2;
  const bool grouped = f.H > f.Hkv, partials = grouped && !P::CHAIN;
  p.part_dk = partials ? reinterpret_cast<float*>(ws + w.part) : nullptr;
  p.part_dv = partials ? p.part_dk + (long long)B * f.H * f.Sk * DQ : nullptr;
  p.sum_dk = grouped && P::CHAIN ? reinterpret_cast<float*>(ws + w.part) : nullptr;
  p.sum_dv = grouped && P::CHAIN ? p.sum_dk + (long long)B * f.Hkv * f.Sk * DQ : nullptr;
  p.turns = grouped && P::CHAIN ? reinterpret_cast<int*>(ws + w.turns) : nullptr;
  p.n_turns = (int)w.n_turns;
  CUtensorMap tq, tk, tv, tdo;
  const long long* st = &f.st[0][0];
  if (!make_map(&tq, f.t[T_Q], B, f.H, f.Sq, DQ, st[3 * T_Q], st[3 * T_Q + 1], st[3 * T_Q + 2], 64) ||
      !make_map(&tk, f.t[T_K], B, f.Hkv, f.Sk, DQ, st[3 * T_K], st[3 * T_K + 1], st[3 * T_K + 2], 64) ||
      !make_map(&tv, f.t[T_V], B, f.Hkv, f.Sk, DV, st[3 * T_V], st[3 * T_V + 1], st[3 * T_V + 2], 64) ||
      !make_map(&tdo, f.t[T_DO], B, f.H, f.Sq, DV, st[3 * T_DO], st[3 * T_DO + 1], st[3 * T_DO + 2], 64))
    return cudaErrorInvalidValue;

  const long long lanes = (long long)B * f.H * p.Sq_pad * (DV / 8);
  flash_bwd_delta_wg_kernel<DV><<<(unsigned)((lanes + 255) / 256), 256, 0, s>>>(f, p, delta, lse2);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int hb = f.H * B;
  flash_bwd_dkdv_wg_kernel<DQ, DV>
      <<<((f.Sk + 63) / 64) * hb, P::DKDV_THREADS, P::SMEM_DKDV, s>>>(tq, tk, tv, tdo, p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (partials) {
    const long long threads = (long long)B * f.Hkv * f.Sk * P::SUM_C8;
    flash_bwd_sum_kernel<DQ, DV><<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  flash_bwd_dq_wg_kernel<DQ, DV>
      <<<((f.Sq + 63) / 64) * hb, P::DQ_THREADS, P::SMEM_DQ, s>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

// The tensor-core path reads through TMA and writes 8 bf16 at a time: every
// base on 16 bytes, every stride a multiple of 8 elements.
static bool tc_aligned(const BwdParams& p) {
  for (int i = 0; i < T_N; ++i) {
    if (reinterpret_cast<uintptr_t>(p.t[i]) % 16) return false;
    for (int j = 0; j < 3; ++j)
      if (p.st[i][j] % 8) return false;
  }
  return true;
}

// bf16 at every pair of head dims the kernels take, with aligned views
static bool takes_wg(int D, int Dv, int dtype, bool aligned) {
  bool dims = false;
#define ONE(dq, dv) dims = dims || (D == dq && Dv == dv);
  BWD_DIMS(ONE)
#undef ONE
  return dtype == DT_BF16 && dims && aligned;
}

// Bytes of workspace a launch of these shapes needs (`aligned`: what
// tc_aligned finds for its operands).  The wrapper allocates it.
extern "C" long long flash_attention_bwd_workspace(int B, int H, int Hkv, int Sq, int Sk, int D,
                                                   int Dv, int dtype, int aligned) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Sk <= 0) return 0;
  return bwd_workspace(B, H, Hkv, Sq, Sk, D, Dv, takes_wg(D, Dv, dtype, aligned != 0)).total;
}

// ptrs[8]: q, k, v, o, dO, dq, dk, dv, each (B, heads, S, head dim) of
// dtype, q, k, dq and dk at D, v, o, dO and dv at Dv; strides[24]: their
// element strides over (batch, head, seq), each a multiple of 4, stride 1
// over the head dim; lse: (B, H, Sq) fp32 from the forward's LSE variant;
// ws: `ws_bytes` of scratch, at least what flash_attention_bwd_workspace
// gives.  Launches the delta, dK/dV, (for the tensor-core path with G > 1,
// but at D 128) sum and dQ kernels in that order on `stream`.  Returns
// cudaGetLastError().
extern "C" int flash_attention_bwd_launch(void* const* ptrs, const long long* strides,
                                          const float* lse, void* ws, long long ws_bytes, int B,
                                          int H, int Hkv, int Sq, int Sk, int D, int Dv,
                                          int causal, int window, float scale, int dtype,
                                          void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (Hkv <= 0 || H % Hkv) return (int)cudaErrorInvalidValue;
  BwdParams p;
  for (int i = 0; i < T_N; ++i) {
    p.t[i] = ptrs[i];
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  }
  p.lse = lse;
  p.delta = reinterpret_cast<float*>(ws);
  p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.causal = causal; p.window = window; p.scale = scale;
  const bool wg = takes_wg(D, Dv, dtype, tc_aligned(p));
  if (ws == nullptr || ws_bytes < bwd_workspace(B, H, Hkv, Sq, Sk, D, Dv, wg).total)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (wg) {
    uint8_t* w = reinterpret_cast<uint8_t*>(ws);
#define RUN(dq, dv) if (D == dq && Dv == dv) return (int)run_bwd_wg<dq, dv>(p, B, w, s);
    BWD_DIMS(RUN)
#undef RUN
  }
  if (dtype == DT_F32) return (int)run_bwd_d<float>(p, B, D, Dv, s);
  if (dtype == DT_BF16) return (int)run_bwd_d<__nv_bfloat16>(p, B, D, Dv, s);
  return (int)cudaErrorInvalidValue;
}

// The FMA kernels' plan for (D, Dv): {kv rows a dK/dV block, dK/dV
// shared-memory bytes, dQ shared-memory bytes} into out[3].  Returns 0, or
// -1 for dims the FMA kernels do not take.
extern "C" int flash_attention_bwd_fma_plan(int D, int Dv, int* out) {
#define PLAN(dq, dv)                                                         \
  if (D == dq && Dv == dv) {                                                 \
    out[0] = FmaPlan<dq, dv>::BKV;                                           \
    out[1] = (int)FmaPlan<dq, dv>::DKDV_BYTES;                               \
    out[2] = (int)FmaPlan<dq, dv>::DQ_BYTES;                                 \
    return 0;                                                                \
  }
  BWD_DIMS(PLAN)
#undef PLAN
  return -1;
}

// The tensor-core kernels' plan for (D, Dv): {q rows, kv rows, dK/dV ring
// stages, dK/dV threads, dK/dV blocks an SM, dQ ring stages, dQ threads, dQ
// blocks an SM, dK/dV shared-memory bytes, dQ shared-memory bytes} into
// out[10].  Returns 0, or -1 for dims the tensor-core path does not take.
extern "C" int flash_attention_bwd_plan(int D, int Dv, int* out) {
#define PLAN(dq, dv)                                                         \
  if (D == dq && Dv == dv) {                                                 \
    using P = BwdPlan<dq, dv>;                                               \
    out[0] = P::BQ; out[1] = P::BKV; out[2] = P::STAGES;                     \
    out[3] = P::DKDV_THREADS; out[4] = P::DKDV_BLOCKS;                       \
    out[5] = P::DQ_STAGES; out[6] = P::DQ_THREADS; out[7] = P::DQ_BLOCKS;    \
    out[8] = P::SMEM_DKDV; out[9] = P::SMEM_DQ;                              \
    return 0;                                                                \
  }
  BWD_DIMS(PLAN)
#undef PLAN
  return -1;
}
