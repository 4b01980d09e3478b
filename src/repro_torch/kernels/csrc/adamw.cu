// AdamW update of one parameter tensor, fused: p, g, m, v in, p, m, v out.
//
// Not the port of a TPU kernel: the reference's AdamW
// (src/repro/training/optimizer.py `adamw`) is array code that XLA fuses
// into one pass over each leaf.  Eager PyTorch runs the same arithmetic as
// about twenty elementwise launches a leaf, each reading and writing whole
// fp32 tensors (measured on an H100: 232 ms a step for phi4-mini's 3.8 B
// parameters, against 23 ms for one pass).  This kernel is that one pass.
//
// On this card it is bound by bytes: each element reads p and g (bf16 or
// fp32) and m and v (fp32) once and writes p, m and v once, with about
// fifteen operations.  One thread takes four consecutive elements (16-byte
// loads of m and v) in a grid-stride loop.
//
// The arithmetic is the reference's, in its order, rounded after every
// operation (__fmul_rn, __fadd_rn, ... keep nvcc from contracting a product
// and a sum into an FMA), so the result equals the unfused PyTorch version
// (kernels/adamw.py `adamw_update_plain`) bit for bit:
//
//   m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
//   u = (m / c1) / (sqrt(v / c2) + eps) + wd p;  p = p - lr u
//
// with g and p widened to fp32 and p rounded back to its type.  lr, c1 and c2
// are read from device memory (0-d tensors the step computed), so nothing
// synchronises with the host.
#include "common.cuh"

#define ADAMW_THREADS 256

struct AdamwScalars {
  float b1, omb1, b2, omb2, eps, wd;   // omb = 1 - b, rounded to fp32 as PyTorch rounds it
};

__device__ __forceinline__ void adamw_one(float g, float& m, float& v, float& p, float lr,
                                          float c1, float c2, const AdamwScalars& s) {
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(g, s.omb1));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(g, g), s.omb2));
  float u = __fdiv_rn(__fdiv_rn(m, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), s.eps));
  u = __fadd_rn(u, __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(u, lr));
}

template <typename T> __device__ __forceinline__ void store4(T* dst, float4 v);
template <> __device__ __forceinline__ void store4<float>(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
}

// VEC = 4: every base aligned to four elements (16 bytes for m and v); the
// last n % 4 elements go one at a time.  VEC = 1: one element a step.
template <typename TP, typename TG, int VEC>
__global__ void __launch_bounds__(ADAMW_THREADS)
adamw_kernel(TP* __restrict__ p, const TG* __restrict__ g, float* __restrict__ m,
             float* __restrict__ v, long long n, const float* __restrict__ lr_p,
             const float* __restrict__ c1_p, const float* __restrict__ c2_p,
             const AdamwScalars s) {
  const float lr = *lr_p, c1 = *c1_p, c2 = *c2_p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long chunks = n / VEC;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < chunks; c += stride) {
    const long long i = c * VEC;
    if constexpr (VEC == 4) {
      const float4 gg = load4<TG>(g + i);
      float4 pp = load4<TP>(p + i);
      float4 mm = *reinterpret_cast<const float4*>(m + i);
      float4 vv = *reinterpret_cast<const float4*>(v + i);
      adamw_one(gg.x, mm.x, vv.x, pp.x, lr, c1, c2, s);
      adamw_one(gg.y, mm.y, vv.y, pp.y, lr, c1, c2, s);
      adamw_one(gg.z, mm.z, vv.z, pp.z, lr, c1, c2, s);
      adamw_one(gg.w, mm.w, vv.w, pp.w, lr, c1, c2, s);
      *reinterpret_cast<float4*>(m + i) = mm;
      *reinterpret_cast<float4*>(v + i) = vv;
      store4<TP>(p + i, pp);
    } else {
      float pf = to_float<TP>(p[i]), mf = m[i], vf = v[i];
      adamw_one(to_float<TG>(g[i]), mf, vf, pf, lr, c1, c2, s);
      m[i] = mf;
      v[i] = vf;
      p[i] = from_float<TP>(pf);
    }
  }
  if (VEC > 1 && blockIdx.x == 0 && threadIdx.x < n - chunks * VEC) {   // the tail
    const long long i = chunks * VEC + threadIdx.x;
    float pf = to_float<TP>(p[i]), mf = m[i], vf = v[i];
    adamw_one(to_float<TG>(g[i]), mf, vf, pf, lr, c1, c2, s);
    m[i] = mf;
    v[i] = vf;
    p[i] = from_float<TP>(pf);
  }
}

template <typename TP, typename TG, int VEC>
static cudaError_t run(void* p, const void* g, float* m, float* v, long long n, const float* lr,
                       const float* c1, const float* c2, const AdamwScalars& s, int blocks,
                       cudaStream_t stream) {
  adamw_kernel<TP, TG, VEC><<<blocks, ADAMW_THREADS, 0, stream>>>(
      (TP*)p, (const TG*)g, m, v, n, lr, c1, c2, s);
  return cudaGetLastError();
}

template <typename TP, typename TG>
static cudaError_t run_vec(void* p, const void* g, float* m, float* v, long long n,
                           const float* lr, const float* c1, const float* c2,
                           const AdamwScalars& s, int vec, int blocks, cudaStream_t stream) {
  if (vec == 4) return run<TP, TG, 4>(p, g, m, v, n, lr, c1, c2, s, blocks, stream);
  if (vec == 1) return run<TP, TG, 1>(p, g, m, v, n, lr, c1, c2, s, blocks, stream);
  return cudaErrorInvalidValue;
}

// p: n elements of p_dtype; g: n of g_dtype; m, v: n fp32; lr, c1, c2: one
// fp32 each in device memory.  vec 4 needs p, g, m, v aligned to four
// elements; `blocks` blocks of 256 threads walk the elements.  Updates p, m,
// v in place on `stream`.  Returns cudaGetLastError().
extern "C" int adamw_launch(void* p, const void* g, float* m, float* v, long long n,
                            const float* lr, const float* c1, const float* c2, float b1,
                            float omb1, float b2, float omb2, float eps, float wd, int p_dtype,
                            int g_dtype, int vec, int blocks, void* stream) {
  if (n <= 0) return 0;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  const AdamwScalars s{b1, omb1, b2, omb2, eps, wd};
  cudaStream_t st = (cudaStream_t)stream;
  if (p_dtype == DT_F32 && g_dtype == DT_F32)
    return (int)run_vec<float, float>(p, g, m, v, n, lr, c1, c2, s, vec, blocks, st);
  if (p_dtype == DT_BF16 && g_dtype == DT_BF16)
    return (int)run_vec<__nv_bfloat16, __nv_bfloat16>(p, g, m, v, n, lr, c1, c2, s, vec,
                                                      blocks, st);
  if (p_dtype == DT_BF16 && g_dtype == DT_F32)
    return (int)run_vec<__nv_bfloat16, float>(p, g, m, v, n, lr, c1, c2, s, vec, blocks, st);
  if (p_dtype == DT_F32 && g_dtype == DT_BF16)
    return (int)run_vec<float, __nv_bfloat16>(p, g, m, v, n, lr, c1, c2, s, vec, blocks, st);
  return (int)cudaErrorInvalidValue;
}
