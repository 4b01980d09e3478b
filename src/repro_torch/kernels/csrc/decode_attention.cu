// Split-KV single-token attention (flash-decode) and the combine of its splits.
//
// Replaces the TPU kernel `_decode_kernel` of src/repro/kernels/decode_attention.py
// and the array code that merges its partial results (`decode_attention`,
// the lines after the pallas_call).
//
// On this card the function is bound by bytes: every valid K and V row is
// read once for 4*G*D operations, far below the card's operations-per-byte
// ridge.  So the design is about reading the cache once, in whole 32-byte
// sectors, with enough blocks in flight: the cache is read where it lies
// through strides (the model keeps it as (B,T,Hkv,D); no transposed copy is
// made), the KV length is cut into splits so that B*Hkv*splits blocks cover
// the card at small batch, rows at or past kv_valid_len[b] are never read,
// and the G query heads of one KV head share each K/V row that is loaded.
// G is 1 to 8 in the supported models, below any tensor-core tile, so both
// products are multiply-and-reduce in fp32: a warp takes one cache row at a
// time, lane L holding elements L, L+32, ... of it, and keeps an online
// softmax (m, l, acc) per query head; the block's warps are merged in shared
// memory at the end.
//
// Partial results use the reference's layout: o (B,Hkv,ns,G,D) normalised,
// m and l (B,Hkv,ns,G), all fp32.  A split with no valid row writes
// (o=0, m=-1e30, l=0) without touching K or V.
#include "common.cuh"

#define DEC_THREADS 256
#define DEC_WARPS (DEC_THREADS / 32)
#define DEC_MAXG 8

struct DecodeParams {
  const void* q; const void* k; const void* v; const int* valid;
  float* o_part; float* m_part; float* l_part;
  int H, Hkv, G, T, ns, chunk;
  long long k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  float scale;
};

// EPL elements a lane: D = 32 * EPL.
template <typename T, int EPL>
__global__ void __launch_bounds__(DEC_THREADS) decode_partial_kernel(const DecodeParams p) {
  constexpr int D = 32 * EPL;
  extern __shared__ __align__(16) float smem[];
  const int G = p.G;
  float* qs = smem;                        // G * D
  float* wacc = qs + G * D;                // DEC_WARPS * G * D
  float* wm = wacc + DEC_WARPS * G * D;    // DEC_WARPS * G
  float* wl = wm + DEC_WARPS * G;          // DEC_WARPS * G

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;

  const T* qp = (const T*)p.q + ((long long)b * p.H + (long long)hk * G) * D;   // (G, D) contiguous
  for (int idx = tid; idx < G * D; idx += DEC_THREADS) qs[idx] = to_float<T>(qp[idx]);
  __syncthreads();

  float qr[DEC_MAXG][EPL], acc[DEC_MAXG][EPL], m[DEC_MAXG], l[DEC_MAXG];
#pragma unroll
  for (int g = 0; g < DEC_MAXG; ++g) {
    m[g] = MASKED_SCORE;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      acc[g][j] = 0.f;
      qr[g][j] = g < G ? qs[g * D + lane + 32 * j] : 0.f;
    }
  }

  const int t0 = split * p.chunk;
  const int t1 = min(min(t0 + p.chunk, p.T), p.valid[b]);
  const T* kp = (const T*)p.k + b * p.k_sb + hk * p.k_sh;
  const T* vp = (const T*)p.v + b * p.v_sb + hk * p.v_sh;

  for (int t = t0 + warp; t < t1; t += DEC_WARPS) {
    const T* kr = kp + (long long)t * p.k_st;
    const T* vr = vp + (long long)t * p.v_st;
    float kf[EPL], vf[EPL];
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      kf[j] = to_float<T>(kr[lane + 32 * j]);
      vf[j] = to_float<T>(vr[lane + 32 * j]);
    }
#pragma unroll
    for (int g = 0; g < DEC_MAXG; ++g) {
      if (g < G) {   // uniform over the block
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < EPL; ++j) dot = fmaf(qr[g][j], kf[j], dot);
        const float s = warp_sum(dot) * p.scale;
        const float m_new = fmaxf(m[g], s);
        const float corr = expf(m[g] - m_new);
        const float pe = expf(s - m_new);
        l[g] = l[g] * corr + pe;
        m[g] = m_new;
#pragma unroll
        for (int j = 0; j < EPL; ++j) acc[g][j] = fmaf(pe, vf[j], acc[g][j] * corr);
      }
    }
  }

  // Merge the warps of the block.
#pragma unroll
  for (int g = 0; g < DEC_MAXG; ++g) {
    if (g < G) {
      if (lane == 0) { wm[warp * G + g] = m[g]; wl[warp * G + g] = l[g]; }
#pragma unroll
      for (int j = 0; j < EPL; ++j) wacc[(warp * G + g) * D + lane + 32 * j] = acc[g][j];
    }
  }
  __syncthreads();

  const long long part = ((long long)b * p.Hkv + hk) * p.ns + split;   // index over (B,Hkv,ns)
  for (int idx = tid; idx < G * D; idx += DEC_THREADS) {
    const int g = idx / D, d = idx % D;
    float mm = MAX_FLOOR;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) mm = fmaxf(mm, wm[w * G + g]);
    float ll = 0.f, oo = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float e = expf(wm[w * G + g] - mm);
      ll += wl[w * G + g] * e;
      oo += wacc[(w * G + g) * D + d] * e;
    }
    p.o_part[(part * G + g) * D + d] = oo / fmaxf(ll, 1e-30f);
    if (d == 0) { p.m_part[part * G + g] = mm; p.l_part[part * G + g] = ll; }
  }
}

// out[b, hk*G+g, :] = sum_s o_s w_s / max(sum_s w_s, 1e-30), w_s = l_s exp(m_s - max_s m_s).
// One block for each (b, hk, g).
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ o_part,
                                      const float* __restrict__ m_part,
                                      const float* __restrict__ l_part, T* __restrict__ out,
                                      int G, int ns, int D) {
  const long long bh = blockIdx.x;   // over (B, Hkv)
  const int g = blockIdx.y;
  float mm = m_part[(bh * ns) * G + g];
  for (int s = 1; s < ns; ++s) mm = fmaxf(mm, m_part[(bh * ns + s) * G + g]);
  float denom = 0.f;
  for (int s = 0; s < ns; ++s) {
    const long long i = (bh * ns + s) * G + g;
    denom += l_part[i] * expf(m_part[i] - mm);
  }
  const float inv = 1.0f / fmaxf(denom, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f;
    for (int s = 0; s < ns; ++s) {
      const long long i = (bh * ns + s) * G + g;
      num += o_part[i * D + d] * (l_part[i] * expf(m_part[i] - mm));
    }
    out[(bh * G + g) * D + d] = from_float<T>(num * inv);
  }
}

template <typename T, int EPL>
static cudaError_t launch_partial(const DecodeParams& p, int B, cudaStream_t stream) {
  const int D = 32 * EPL;
  const size_t bytes =
      ((size_t)p.G * D * (1 + DEC_WARPS) + 2 * (size_t)DEC_WARPS * p.G) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(decode_partial_kernel<T, EPL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.ns, p.Hkv, B);
  decode_partial_kernel<T, EPL><<<grid, DEC_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_partial_d(const DecodeParams& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_partial<T, 2>(p, B, stream);
    case 128: return launch_partial<T, 4>(p, B, stream);
    case 256: return launch_partial<T, 8>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// q (B,H,D) contiguous; k/v (B,Hkv,T,D) with strides in elements over their
// first three dims and stride 1 over D; valid (B,) int32; partials fp32 in the
// layout above, split s covering rows [s*chunk, (s+1)*chunk).  D is 64, 128
// or 256, G = H/Hkv at most 8.  Returns cudaGetLastError().
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* valid, void* o_part,
    void* m_part, void* l_part, int B, int H, int Hkv, int T, int D, int ns, int chunk,
    long long k_sb, long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  DecodeParams p;
  p.q = q; p.k = k; p.v = v; p.valid = (const int*)valid;
  p.o_part = (float*)o_part; p.m_part = (float*)m_part; p.l_part = (float*)l_part;
  p.H = H; p.Hkv = Hkv; p.G = H / Hkv; p.T = T; p.ns = ns; p.chunk = chunk;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.scale = scale;
  if (p.G < 1 || p.G > DEC_MAXG) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F32) return (int)launch_partial_d<float>(p, B, D, s);
  if (dtype == DT_BF16) return (int)launch_partial_d<__nv_bfloat16>(p, B, D, s);
  return (int)cudaErrorInvalidValue;
}

// partials as above; out (B,H,D) contiguous of `dtype`.  Returns cudaGetLastError().
extern "C" int decode_combine_launch(const void* o_part, const void* m_part,
                                     const void* l_part, void* out, int B, int Hkv, int G,
                                     int ns, int D, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0) return 0;
  const dim3 grid(B * Hkv, G);
  const int threads = D < 128 ? 64 : 128;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F32)
    decode_combine_kernel<float><<<grid, threads, 0, s>>>(
        (const float*)o_part, (const float*)m_part, (const float*)l_part, (float*)out, G, ns, D);
  else if (dtype == DT_BF16)
    decode_combine_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        (const float*)o_part, (const float*)m_part, (const float*)l_part,
        (__nv_bfloat16*)out, G, ns, D);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
