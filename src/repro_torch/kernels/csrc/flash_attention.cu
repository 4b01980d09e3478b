// Flash-attention forward (online softmax), GQA, causal / sliding-window masks.
//
// Replaces the TPU kernel `_flash_kernel` of src/repro/kernels/flash_attention.py
// (driven by `flash_attention`).  That kernel gets its KV loop from a
// sequential innermost grid axis with (m, l, acc) kept in scratch between
// grid steps.  Here blocks run in parallel and in no order, so one block
// owns one (batch, q head, 64-row q tile) and walks the KV tiles itself,
// with (m, l, acc) in registers.
//
// On this card the function is bound by operations (4*Sq*Sk*D a head, half
// of it under a causal mask, against Sq*D + 2*Sk*D elements moved).  This
// first version does both products as fp32 FMAs, as the reference widens its
// inputs to fp32 before both dots; it does not use the tensor cores, so its
// ceiling is the card's fp32 rate.  What it does about the bound: KV tiles
// that the causal or window mask kills entirely are skipped, the heaviest q
// tiles (the last ones under a causal mask) are scheduled first, K and Q are
// read from shared memory as 16-byte vectors on a padded, conflict-free
// stride, and each thread keeps a 4 x (D/16) tile of the output in registers.
//
// Layout: q (B,H,Sq,D), k/v (B,Hkv,Sk,D), o (B,H,Sq,D), each with free
// strides over its first three dims and stride 1 over D, so the model's
// (B,S,H,D) tensors are read where they lie.
#include "common.cuh"

#define FA_THREADS 256
#define FA_BQ 64     // q rows a block
#define FA_BK 32     // kv rows a tile

struct FlashParams {
  const void* q; const void* k; const void* v; void* o;
  int H, Hkv, Sq, Sk;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int causal, window;
  float scale;
};

template <int D> struct FlashSmem {
  static constexpr int QS = D + 4;      // row stride of Qs and Ks (floats): 16-B aligned, and
                                        // (QS/4) odd, so 8 rows hit 8 distinct 16-B bank groups
  static constexpr int PS = FA_BK + 4;  // row stride of Ps
  static constexpr int FLOATS = FA_BQ * QS + FA_BK * QS + FA_BK * D + FA_BQ * PS;
};

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS) flash_fwd_kernel(const FlashParams p) {
  constexpr int QS = FlashSmem<D>::QS, PS = FlashSmem<D>::PS;
  constexpr int DC = D / 16;   // output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + FA_BQ * QS;
  float* Vs = Ks + FA_BK * QS;
  float* Ps = Vs + FA_BK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // S columns tx + 16 j, O columns tx + 16 j
  const int ty = tid >> 4;   // rows ty + 16 i
  const int qt = gridDim.x - 1 - blockIdx.x;   // last (heaviest under causal) q tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * FA_BQ;

  const T* qp = (const T*)p.q + b * p.q_sb + h * p.q_sh;
  const T* kp = (const T*)p.k + b * p.k_sb + hk * p.k_sh;
  const T* vp = (const T*)p.v + b * p.v_sb + hk * p.v_sh;
  T* op = (T*)p.o + b * p.o_sb + h * p.o_sh;

  // Q tile -> shared memory, fp32, rows past Sq as zeros.
  for (int c = tid; c < FA_BQ * (D / 4); c += FA_THREADS) {
    const int r = c / (D / 4), d4 = (c % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.Sq) val = load4<T>(qp + (long long)(q0 + r) * p.q_ss + d4);
    *reinterpret_cast<float4*>(&Qs[r * QS + d4]) = val;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED_SCORE;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  // KV range that some row of this q tile can see.
  const int q_last = min(q0 + FA_BQ, p.Sq) - 1;
  int kv_hi = p.Sk;
  if (p.causal) kv_hi = min(kv_hi, q_last + 1);
  int kv_lo = 0;
  if (p.window > 0) {
    const int first = q0 - p.window + 1;
    if (first > 0) kv_lo = (first / FA_BK) * FA_BK;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += FA_BK) {
    __syncthreads();   // the tile before is read to its end
    // K and V tiles -> shared memory, rows past Sk as zeros.
    for (int c = tid; c < FA_BK * (D / 4); c += FA_THREADS) {
      const int r = c / (D / 4), d4 = (c % (D / 4)) * 4;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (k0 + r < p.Sk) {
        kv4 = load4<T>(kp + (long long)(k0 + r) * p.k_ss + d4);
        vv4 = load4<T>(vp + (long long)(k0 + r) * p.v_ss + d4);
      }
      *reinterpret_cast<float4*>(&Ks[r * QS + d4]) = kv4;
      *reinterpret_cast<float4*>(&Vs[r * D + d4]) = vv4;
    }
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, columns tx + 16 j.
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) { s[i][0] = 0.f; s[i][1] = 0.f; }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Mask by absolute position, online softmax over the 16 lanes of a row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      bool ok[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        ok[j] = (q_pos < p.Sq) && (k_pos < p.Sk);
        if (p.causal) ok[j] = ok[j] && (k_pos <= q_pos);
        if (p.window > 0) ok[j] = ok[j] && (k_pos > q_pos - p.window);
        s[i][j] = ok[j] ? s[i][j] * p.scale : MASKED_SCORE;
      }
      float mx = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(fmaxf(m[i], mx), MAX_FLOOR);
      const float corr = expf(m[i] - m_new);
      const float p0 = ok[0] ? expf(s[i][0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(s[i][1] - m_new) : 0.f;
      float rs = p0 + p1;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
      Ps[(ty + 16 * i) * PS + tx] = p0;
      Ps[(ty + 16 * i) * PS + tx + 16] = p1;
    }
    __syncthreads();

    // acc += P V for rows ty + 16 i, columns tx + 16 j.
#pragma unroll 2
    for (int t = 0; t < FA_BK; t += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * PS + t]);
        pr[i][0] = p4.x; pr[i][1] = p4.y; pr[i][2] = p4.z; pr[i][3] = p4.w;
      }
#pragma unroll
      for (int tt = 0; tt < 4; ++tt)
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          const float vv = Vs[(t + tt) * D + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i][tt], vv, acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + ty + 16 * i;
    if (q_pos < p.Sq) {
      const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DC; ++j)
        op[(long long)q_pos * p.o_ss + tx + 16 * j] = from_float<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int D>
static cudaError_t launch(const FlashParams& p, int B, cudaStream_t stream) {
  constexpr size_t bytes = (size_t)FlashSmem<D>::FLOATS * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + FA_BQ - 1) / FA_BQ, p.H, B);
  flash_fwd_kernel<T, D><<<grid, FA_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_d(const FlashParams& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    case 256: return launch<T, 256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Strides are in elements.  D must be 64, 128 or 256; every pointer and every
// stride a multiple of four elements.  Returns cudaGetLastError().
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int Sq,
    int Sk, int D, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int causal, int window, float scale,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  FlashParams p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.causal = causal; p.window = window; p.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F32) return (int)launch_d<float>(p, B, D, s);
  if (dtype == DT_BF16) return (int)launch_d<__nv_bfloat16>(p, B, D, s);
  return (int)cudaErrorInvalidValue;
}
