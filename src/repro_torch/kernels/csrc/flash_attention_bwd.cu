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
// recomputing P from the scores rather than storing it.  The split follows
// the usual one, so that nothing needs atomics and every sum is taken in the
// same order on every run:
//
//   * the dK/dV kernel: one block a (batch, kv head, kv tile), looping over
//     the q tiles of all G heads of its group that can see the tile, with dK
//     and dV of the tile in registers;
//   * the dQ kernel: one block a (batch, q head, q tile), looping over the kv
//     tiles the tile can see, with dQ in registers.
//
// On this card the backward is bound by operations (about 2.5 times the
// forward's: five products of a tile pair against the forward's two).  Two
// versions of the dK/dV and dQ kernels:
//
//   * bf16 with D = 64 or 128 and 16-byte aligned operands (the train
//     path's): tensor cores through `mma.sync` m16n8k16 (bf16 in, fp32
//     accumulate), four warps a block, each warp owning 16 rows of the
//     output tile.  The tiles are staged in shared memory as bf16, row-major
//     for the products' A operands and for B operands read along D, and
//     transposed (D-major) for the B operands read along the sequence (dO
//     and Q in dV += P^T dO and dK += dS^T Q, K in dQ += dS K), with rows
//     padded by 8 elements so that a warp's fragment loads hit 32 banks.
//     S and dP stay in the accumulator fragments; P and dS are rounded to
//     bf16 and reused in registers as the next product's A operand (the
//     forward rounds P before P V in the same way).  The loads are plain
//     16-byte loads with no pipelining: a TMA/wgmma design is later work.
//   * otherwise (fp32, D = 256, unaligned views): fp32 FMAs over tiles
//     widened to fp32 in shared memory, the forward's FMA kernel's thread
//     layout (16 x 16 threads, 4 rows x D/16 columns a thread).  TF32 tensor
//     cores would keep about three decimal digits and miss the fp32
//     tolerance; at D = 256 a warp's dK and dV of 16 rows would need 256
//     registers a thread.
//
// A fully masked row keeps the forward's convention: its output is 0, and
// so is every gradient it sends.
//
// Layout: every tensor (B, heads, S, D) with free strides over its first
// three dims (multiples of 4 elements) and stride 1 over D; lse and delta
// (B, H, Sq) contiguous fp32.
#include "common.cuh"

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
// delta = rowsum(dO * O): one warp a row.

template <typename T, int D>
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
  for (int d = lane * 4; d < D; d += 128) acc += dot4(load4<T>(op + d), load4<T>(gp + d));
  acc = warp_sum(acc);
  if (lane == 0) p.delta[row] = acc;
}

// ---------------------------------------------------------------------------
// dK, dV of one kv tile of BKV rows.  Thread (ty, tx) owns kv rows ty + 16 i
// (i < BKV / 16) and, of a q tile of BQ = 32 rows, columns tx + 16 j (j < 2)
// of S^T and dP^T, and columns tx + 16 j (j < D / 16) of dK and dV.

template <int D, int BKV> struct DkdvSmem {
  static constexpr int BQ = 32;
  static constexpr int RS = D + 4;    // row stride of the K, V, Q, dO tiles: (RS / 4) odd
  static constexpr int PS = BQ + 4;   // row stride of P^T and dS^T
  static constexpr int FLOATS = 2 * BKV * RS + 2 * BQ * RS + 2 * BKV * PS + 2 * BQ;
};

template <typename T, int D, int BKV>
__global__ void __launch_bounds__(FB_THREADS) flash_bwd_dkdv_kernel(const BwdParams p) {
  using Sm = DkdvSmem<D, BKV>;
  constexpr int BQ = Sm::BQ, RS = Sm::RS, PS = Sm::PS;
  constexpr int RI = BKV / 16, DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BKV * RS;
  float* Qs = Vs + BKV * RS;
  float* Gs = Qs + BQ * RS;        // dO
  float* Ps = Gs + BQ * RS;        // P^T
  float* Ss = Ps + BKV * PS;       // dS^T
  float* Ls = Ss + BKV * PS;       // lse of the q tile's rows
  float* Dl = Ls + BQ;             // delta of the q tile's rows

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BKV;   // the first kv tiles see the most q rows under a causal mask
  const int G = p.H / p.Hkv;

  load_tile<T, D, BKV, RS>(Ks, p, T_K, b, hk, k0, p.Sk);
  load_tile<T, D, BKV, RS>(Vs, p, T_V, b, hk, k0, p.Sk);

  float dk[RI][DC], dv[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) { dk[i][j] = 0.f; dv[i][j] = 0.f; }

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
      load_tile<T, D, BQ, RS>(Qs, p, T_Q, b, h, q0, p.Sq);
      load_tile<T, D, BQ, RS>(Gs, p, T_DO, b, h, q0, p.Sq);
      if (threadIdx.x < BQ) {
        const int q = q0 + threadIdx.x;
        Ls[threadIdx.x] = q < p.Sq ? lse[q] : 0.f;
        Dl[threadIdx.x] = q < p.Sq ? delta[q] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T
      float s[RI][2], dp[RI][2];
#pragma unroll
      for (int i = 0; i < RI; ++i) { s[i][0] = s[i][1] = 0.f; dp[i][0] = dp[i][1] = 0.f; }
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 qv[2], gv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          qv[j] = *reinterpret_cast<const float4*>(&Qs[(tx + 16 * j) * RS + d]);
          gv[j] = *reinterpret_cast<const float4*>(&Gs[(tx + 16 * j) * RS + d]);
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float4 kv = *reinterpret_cast<const float4*>(&Ks[(ty + 16 * i) * RS + d]);
          const float4 vv = *reinterpret_cast<const float4*>(&Vs[(ty + 16 * i) * RS + d]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s[i][j] += dot4(kv, qv[j]);
            dp[i][j] += dot4(vv, gv[j]);
          }
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
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            const float gq = Gs[(c + cc) * RS + tx + 16 * j];
            const float qq = Qs[(c + cc) * RS + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < RI; ++i) {
              dv[i][j] = fmaf(pr[i][cc], gq, dv[i][j]);
              dk[i][j] = fmaf(sr[i][cc], qq, dk[i][j]);
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
      for (int j = 0; j < DC; ++j) {
        dkp[tx + 16 * j] = from_float<T>(dk[i][j] * p.scale);
        dvp[tx + 16 * j] = from_float<T>(dv[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ of one q tile of BQ = 64 rows.  Thread (ty, tx) owns q rows ty + 16 i
// (i < 4) and, of a kv tile of BKV = 32 rows, columns tx + 16 j (j < 2) of S
// and dP, and columns tx + 16 j (j < D / 16) of dQ.

template <int D> struct DqSmem {
  static constexpr int BQ = 64, BKV = 32;
  static constexpr int RS = D + 4;
  static constexpr int PS = BKV + 4;
  static constexpr int FLOATS = 2 * BQ * RS + 2 * BKV * RS + BQ * PS;
};

template <typename T, int D>
__global__ void __launch_bounds__(FB_THREADS) flash_bwd_dq_kernel(const BwdParams p) {
  using Sm = DqSmem<D>;
  constexpr int BQ = Sm::BQ, BKV = Sm::BKV, RS = Sm::RS, PS = Sm::PS;
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + BQ * RS;        // dO
  float* Ks = Gs + BQ * RS;
  float* Vs = Ks + BKV * RS;
  float* Ss = Vs + BKV * RS;       // dS

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;   // last (heaviest under causal) q tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * BQ;

  load_tile<T, D, BQ, RS>(Qs, p, T_Q, b, h, q0, p.Sq);
  load_tile<T, D, BQ, RS>(Gs, p, T_DO, b, h, q0, p.Sq);
  float lse[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    const long long at = ((long long)b * p.H + h) * p.Sq + q;
    lse[i] = q < p.Sq ? p.lse[at] : 0.f;
    delta[i] = q < p.Sq ? p.delta[at] : 0.f;
  }
  float dq[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dq[i][j] = 0.f;

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
    load_tile<T, D, BKV, RS>(Ks, p, T_K, b, hk, k0, p.Sk);
    load_tile<T, D, BKV, RS>(Vs, p, T_V, b, hk, k0, p.Sk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) { s[i][0] = s[i][1] = 0.f; dp[i][0] = dp[i][1] = 0.f; }
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kv[2], vv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * RS + d]);
        vv[j] = *reinterpret_cast<const float4*>(&Vs[(tx + 16 * j) * RS + d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * RS + d]);
        const float4 gv = *reinterpret_cast<const float4*>(&Gs[(ty + 16 * i) * RS + d]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] += dot4(qv, kv[j]);
          dp[i][j] += dot4(gv, vv[j]);
        }
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
        for (int j = 0; j < DC; ++j) {
          const float kk = Ks[(c + cc) * RS + tx + 16 * j];
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
      for (int j = 0; j < DC; ++j) dqp[tx + 16 * j] = from_float<T>(dq[i][j] * p.scale);
    }
  }
}

// ===========================================================================
// bf16, D = 64 or 128: tensor cores through mma.sync
// ===========================================================================

#define TB_THREADS 128   // four warps

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment (16 x 16, row-major) at rows r0.., cols c0.. of a bf16 tile
// of row stride `st`: rows r0 + g and r0 + g + 8, cols c0 + 2t and c0 + 2t + 8.
__device__ __forceinline__ void frag_a(uint32_t* a, const __nv_bfloat16* tile, int st, int r0,
                                       int c0, int g, int t) {
  a[0] = ld32(tile + (r0 + g) * st + c0 + 2 * t);
  a[1] = ld32(tile + (r0 + g + 8) * st + c0 + 2 * t);
  a[2] = ld32(tile + (r0 + g) * st + c0 + 2 * t + 8);
  a[3] = ld32(tile + (r0 + g + 8) * st + c0 + 2 * t + 8);
}

// The B fragment (16 x 8, k x n) whose column n is row n0 + g of a tile
// stored n-major (k contiguous), k from k0: elements k0 + 2t.. and k0 + 2t + 8..
__device__ __forceinline__ void frag_b(uint32_t* b, const __nv_bfloat16* tile, int st, int n0,
                                       int k0, int g, int t) {
  b[0] = ld32(tile + (n0 + g) * st + k0 + 2 * t);
  b[1] = ld32(tile + (n0 + g) * st + k0 + 2 * t + 8);
}

// Accumulator fragments c[j] (16 x 8 each, j = 2kk and 2kk + 1) as the A
// fragment of a product over their 16 columns, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c0, const float* c1) {
  a[0] = pack2(c0[0], c0[1]);
  a[1] = pack2(c0[2], c0[3]);
  a[2] = pack2(c1[0], c1[1]);
  a[3] = pack2(c1[2], c1[3]);
}

// rows [r0, r0 + R) of one (batch, head) of bf16 tensor `which` -> shared
// memory, row-major with row stride RS and, if `tr`, also transposed (D rows
// of stride TS); rows past `n` as zeros.  16-byte loads (the operand is
// 16-byte aligned with strides that are multiples of 8 elements).  Adjacent
// threads take adjacent rows of one 8-column chunk, so that the transposed
// 2-byte stores of a warp fall in adjacent words and the row-major 16-byte
// stores (each padded row four banks on from the one before) in distinct banks.
template <int D, int R, int RS, int TS>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, __nv_bfloat16* tr, const BwdParams& p,
                                      int which, int b, int h, int r0, int n) {
  for (int c = threadIdx.x; c < R * (D / 8); c += TB_THREADS) {
    const int r = c % R, d8 = (c / R) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(row_ptr<__nv_bfloat16>(p, which, b, h, r0 + r) + d8);
    *reinterpret_cast<uint4*>(dst + r * RS + d8) = val;
    if (tr != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) tr[(d8 + i) * TS + r] = e[i];
    }
  }
}

template <int D> struct TcDkdv {
  static constexpr int BKV = 64, BQ = 32;
  static constexpr int RS = D + 8;    // row stride of K, V, Q, dO (elements)
  static constexpr int TS = BQ + 8;   // row stride of Q^T and dO^T
  static constexpr int ELEMS = 2 * BKV * RS + 2 * BQ * RS + 2 * D * TS;
  static constexpr int BYTES = ELEMS * 2 + 2 * BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(TB_THREADS) flash_bwd_dkdv_tc_kernel(const BwdParams p) {
  using T = TcDkdv<D>;
  constexpr int BKV = T::BKV, BQ = T::BQ, RS = T::RS, TS = T::TS;
  extern __shared__ __align__(16) uint8_t smem_tc[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* Vs = Ks + BKV * RS;
  __nv_bfloat16* Qs = Vs + BKV * RS;
  __nv_bfloat16* Gs = Qs + BQ * RS;      // dO
  __nv_bfloat16* Qt = Gs + BQ * RS;      // Q^T
  __nv_bfloat16* Gt = Qt + D * TS;       // dO^T
  float* Ls = reinterpret_cast<float*>(Gt + D * TS);
  float* Dl = Ls + BQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BKV;   // the first kv tiles see the most q rows under a causal mask
  const int G = p.H / p.Hkv;
  const int wr = warp * 16;          // this warp's kv rows in the tile

  stage<D, BKV, RS, 1>(Ks, nullptr, p, T_K, b, hk, k0, p.Sk);
  stage<D, BKV, RS, 1>(Vs, nullptr, p, T_V, b, hk, k0, p.Sk);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) { dk[n][e] = 0.f; dv[n][e] = 0.f; }

  const int q_lo = p.causal ? (k0 / BQ) * BQ : 0;
  int q_hi = p.Sq;
  if (p.window > 0) q_hi = min(q_hi, k0 + BKV - 1 + p.window);

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
    const float* delta = p.delta + ((long long)b * p.H + h) * p.Sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();   // the tile before is read to its end (and K, V staged)
      stage<D, BQ, RS, TS>(Qs, Qt, p, T_Q, b, h, q0, p.Sq);
      stage<D, BQ, RS, TS>(Gs, Gt, p, T_DO, b, h, q0, p.Sq);
      if (threadIdx.x < BQ) {
        const int q = q0 + threadIdx.x;
        Ls[threadIdx.x] = q < p.Sq ? lse[q] : 0.f;
        Dl[threadIdx.x] = q < p.Sq ? delta[q] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x BQ q columns a warp
      float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) { s[j][e] = 0.f; dp[j][e] = 0.f; }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        frag_a(ak, Ks, RS, wr, 16 * kk, g, t);
        frag_a(av, Vs, RS, wr, 16 * kk, g, t);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          uint32_t bq[2], bg[2];
          frag_b(bq, Qs, RS, 8 * j, 16 * kk, g, t);
          frag_b(bg, Gs, RS, 8 * j, 16 * kk, g, t);
          mma_bf16(s[j], ak, bq);
          mma_bf16(dp[j], av, bg);
        }
      }
      // P^T = exp(scale S^T - lse) where seen, dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kv = k0 + wr + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
          const float pt = seen(q0 + c, kv, p) ? expf(s[j][e] * p.scale - Ls[c]) : 0.f;
          s[j][e] = pt;
          dp[j][e] = pt * (dp[j][e] - Dl[c]);
        }
      // dV += P^T dO and dK += dS^T Q, P^T and dS^T as A fragments
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        acc_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t bg[2], bq[2];
          frag_b(bg, Gt, TS, 8 * n, 16 * kk, g, t);
          frag_b(bq, Qt, TS, 8 * n, 16 * kk, g, t);
          mma_bf16(dv[n], pa, bg);
          mma_bf16(dk[n], sa, bq);
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kv = k0 + wr + g + 8 * half;
    if (kv < p.Sk) {
      __nv_bfloat16* dkp = (__nv_bfloat16*)row_ptr<__nv_bfloat16>(p, T_DK, b, hk, kv);
      __nv_bfloat16* dvp = (__nv_bfloat16*)row_ptr<__nv_bfloat16>(p, T_DV, b, hk, kv);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(dkp + col) =
            pack2(dk[n][2 * half] * p.scale, dk[n][2 * half + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvp + col) = pack2(dv[n][2 * half], dv[n][2 * half + 1]);
      }
    }
  }
}

template <int D> struct TcDq {
  static constexpr int BQ = 64, BKV = 32;
  static constexpr int RS = D + 8;     // row stride of Q, dO, K, V
  static constexpr int TS = BKV + 8;   // row stride of K^T
  static constexpr int BYTES = (2 * BQ * RS + 2 * BKV * RS + D * TS) * 2;
};

template <int D>
__global__ void __launch_bounds__(TB_THREADS) flash_bwd_dq_tc_kernel(const BwdParams p) {
  using T = TcDq<D>;
  constexpr int BQ = T::BQ, BKV = T::BKV, RS = T::RS, TS = T::TS;
  extern __shared__ __align__(16) uint8_t smem_tc[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* Gs = Qs + BQ * RS;      // dO
  __nv_bfloat16* Ks = Gs + BQ * RS;
  __nv_bfloat16* Vs = Ks + BKV * RS;
  __nv_bfloat16* Kt = Vs + BKV * RS;     // K^T

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;   // last (heaviest under causal) q tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * BQ, wr = warp * 16;

  stage<D, BQ, RS, 1>(Qs, nullptr, p, T_Q, b, h, q0, p.Sq);
  stage<D, BQ, RS, 1>(Gs, nullptr, p, T_DO, b, h, q0, p.Sq);
  float lse[2], delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + wr + g + 8 * half;
    const long long at = ((long long)b * p.H + h) * p.Sq + q;
    lse[half] = q < p.Sq ? p.lse[at] : 0.f;
    delta[half] = q < p.Sq ? p.delta[at] : 0.f;
  }
  __syncthreads();
  // this warp's 16 rows of Q and dO as A fragments, kept for the whole loop
  uint32_t qa[D / 16][4], ga[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    frag_a(qa[kk], Qs, RS, wr, 16 * kk, g, t);
    frag_a(ga[kk], Gs, RS, wr, 16 * kk, g, t);
  }
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int kv_hi = p.Sk;
  if (p.causal) kv_hi = min(kv_hi, q_last + 1);
  int kv_lo = 0;
  if (p.window > 0) {
    const int first = q0 - p.window + 1;
    if (first > 0) kv_lo = (first / BKV) * BKV;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BKV) {
    __syncthreads();   // the tile before is read to its end
    stage<D, BKV, RS, TS>(Ks, Kt, p, T_K, b, hk, k0, p.Sk);
    stage<D, BKV, RS, 1>(Vs, nullptr, p, T_V, b, hk, k0, p.Sk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 q rows x BKV kv columns a warp
    float s[BKV / 8][4], dp[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) { s[j][e] = 0.f; dp[j][e] = 0.f; }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        uint32_t bk[2], bv[2];
        frag_b(bk, Ks, RS, 8 * j, 16 * kk, g, t);
        frag_b(bv, Vs, RS, 8 * j, 16 * kk, g, t);
        mma_bf16(s[j], qa[kk], bk);
        mma_bf16(dp[j], ga[kk], bv);
      }
    // dS = P (dP - delta) with P = exp(scale S - lse) where seen
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int q = q0 + wr + g + 8 * half, kv = k0 + 8 * j + 2 * t + (e & 1);
        const float pv = seen(q, kv, p) ? expf(s[j][e] * p.scale - lse[half]) : 0.f;
        dp[j][e] = pv * (dp[j][e] - delta[half]);
      }
    // dQ += dS K, dS as A fragments, K through its transposed copy
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t sa[4];
      acc_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bk[2];
        frag_b(bk, Kt, TS, 8 * n, 16 * kk, g, t);
        mma_bf16(dq[n], sa, bk);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + wr + g + 8 * half;
    if (q < p.Sq) {
      __nv_bfloat16* dqp = (__nv_bfloat16*)row_ptr<__nv_bfloat16>(p, T_DQ, b, h, q);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dqp + 8 * n + 2 * t) =
            pack2(dq[n][2 * half] * p.scale, dq[n][2 * half + 1] * p.scale);
    }
  }
}

// ---- host side ------------------------------------------------------------

template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// kv rows a dK/dV block: 64, or 32 at D = 256 so that dK and dV stay at 64
// registers a thread
template <int D> struct DkdvRows { static constexpr int value = D < 256 ? 64 : 32; };

template <typename T, int D>
static cudaError_t run_bwd(const BwdParams& p, int B, cudaStream_t s) {
  constexpr int BKV = DkdvRows<D>::value;
  constexpr size_t dkdv_bytes = (size_t)DkdvSmem<D, BKV>::FLOATS * sizeof(float);
  constexpr size_t dq_bytes = (size_t)DqSmem<D>::FLOATS * sizeof(float);
  static bool attr_set = false;
  cudaError_t e;
  if (!attr_set) {
    if ((e = allow_smem(flash_bwd_dkdv_kernel<T, D, BKV>, dkdv_bytes)) != cudaSuccess) return e;
    if ((e = allow_smem(flash_bwd_dq_kernel<T, D>, dq_bytes)) != cudaSuccess) return e;
    attr_set = true;
  }
  const long long rows = (long long)B * p.H * p.Sq;
  const int per_block = FB_THREADS / 32;
  flash_bwd_delta_kernel<T, D><<<(unsigned)((rows + per_block - 1) / per_block), FB_THREADS, 0, s>>>(p, B);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 g_kv((p.Sk + BKV - 1) / BKV, p.Hkv, B);
  flash_bwd_dkdv_kernel<T, D, BKV><<<g_kv, FB_THREADS, dkdv_bytes, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 g_q((p.Sq + DqSmem<D>::BQ - 1) / DqSmem<D>::BQ, p.H, B);
  flash_bwd_dq_kernel<T, D><<<g_q, FB_THREADS, dq_bytes, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t run_bwd_d(const BwdParams& p, int B, int D, cudaStream_t s) {
  switch (D) {
    case 64: return run_bwd<T, 64>(p, B, s);
    case 128: return run_bwd<T, 128>(p, B, s);
    case 256: return run_bwd<T, 256>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
static cudaError_t run_bwd_tc(const BwdParams& p, int B, cudaStream_t s) {
  static bool attr_set = false;
  cudaError_t e;
  if (!attr_set) {
    if ((e = allow_smem(flash_bwd_dkdv_tc_kernel<D>, TcDkdv<D>::BYTES)) != cudaSuccess) return e;
    if ((e = allow_smem(flash_bwd_dq_tc_kernel<D>, TcDq<D>::BYTES)) != cudaSuccess) return e;
    attr_set = true;
  }
  const long long rows = (long long)B * p.H * p.Sq;
  const int per_block = FB_THREADS / 32;
  flash_bwd_delta_kernel<__nv_bfloat16, D>
      <<<(unsigned)((rows + per_block - 1) / per_block), FB_THREADS, 0, s>>>(p, B);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 g_kv((p.Sk + TcDkdv<D>::BKV - 1) / TcDkdv<D>::BKV, p.Hkv, B);
  flash_bwd_dkdv_tc_kernel<D><<<g_kv, TB_THREADS, TcDkdv<D>::BYTES, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 g_q((p.Sq + TcDq<D>::BQ - 1) / TcDq<D>::BQ, p.H, B);
  flash_bwd_dq_tc_kernel<D><<<g_q, TB_THREADS, TcDq<D>::BYTES, s>>>(p);
  return cudaGetLastError();
}

// The tensor-core kernels read and write 16 bytes at a time (8 bf16).
static bool tc_aligned(const BwdParams& p) {
  for (int i = 0; i < T_N; ++i) {
    if (reinterpret_cast<uintptr_t>(p.t[i]) % 16) return false;
    for (int j = 0; j < 3; ++j)
      if (p.st[i][j] % 8) return false;
  }
  return true;
}

// ptrs[8]: q, k, v, o, dO, dq, dk, dv, each (B, heads, S, D) of dtype;
// strides[24]: their element strides over (batch, head, seq), each a
// multiple of 4, stride 1 over D; lse: (B, H, Sq) fp32 from the forward's LSE
// variant; delta: (B, H, Sq) fp32 scratch.  Launches the delta, dK/dV and dQ
// kernels in that order on `stream`.  Returns cudaGetLastError().
extern "C" int flash_attention_bwd_launch(void* const* ptrs, const long long* strides,
                                          const float* lse, float* delta, int B, int H, int Hkv,
                                          int Sq, int Sk, int D, int causal, int window,
                                          float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (Hkv <= 0 || H % Hkv) return (int)cudaErrorInvalidValue;
  BwdParams p;
  for (int i = 0; i < T_N; ++i) {
    p.t[i] = ptrs[i];
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  }
  p.lse = lse;
  p.delta = delta;
  p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.causal = causal; p.window = window; p.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F32) return (int)run_bwd_d<float>(p, B, D, s);
  if (dtype == DT_BF16 && tc_aligned(p)) {
    if (D == 64) return (int)run_bwd_tc<64>(p, B, s);
    if (D == 128) return (int)run_bwd_tc<128>(p, B, s);
  }
  if (dtype == DT_BF16) return (int)run_bwd_d<__nv_bfloat16>(p, B, D, s);
  return (int)cudaErrorInvalidValue;
}
