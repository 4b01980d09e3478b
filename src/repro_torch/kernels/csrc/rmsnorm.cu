// RMSNorm with an optional residual add inside the kernel.
//
// Replaces the TPU kernel `_rmsnorm_kernel` of src/repro/kernels/rmsnorm.py
// (driven by `rmsnorm`), which tiles 128 rows a grid step and adds the
// residual in array code before the call.
//
// On this card the function is bound by bytes: each x (and residual) element
// is read once and each output element written once, with about four
// operations an element.  So: one block a row, the row widened to fp32 and
// kept in shared memory between the sum of squares and the scaling pass (one
// read of device memory, one write), and the residual summed in the same
// pass instead of in a pass of its own.  The sum is rounded to x's type
// before it is squared, as the array add of the reference rounds it.
#include "common.cuh"

#define RMS_THREADS 256

template <typename TX, typename TW>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_kernel(const TX* __restrict__ x, const TX* __restrict__ res,
               const TW* __restrict__ w, TX* __restrict__ out, int D, float eps,
               int offset) {
  extern __shared__ __align__(16) float row[];   // D floats
  __shared__ float red[RMS_THREADS / 32];
  const size_t base = (size_t)blockIdx.x * (size_t)D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += RMS_THREADS) {
    float v = to_float<TX>(x[base + d]);
    if (res != nullptr) v = to_float<TX>(from_float<TX>(v + to_float<TX>(res[base + d])));
    row[d] = v;
    ss += v * v;
  }
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < RMS_THREADS / 32 ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float rs = 1.0f / sqrtf(red[0] / (float)D + eps);
  for (int d = threadIdx.x; d < D; d += RMS_THREADS) {
    float scale = to_float<TW>(w[d]);
    if (offset) scale = 1.0f + scale;
    out[base + d] = from_float<TX>(row[d] * rs * scale);   // row[d] is this thread's own
  }
}

template <typename TX, typename TW>
static cudaError_t launch(const void* x, const void* res, const void* w, void* out,
                          int rows, int D, float eps, int offset, cudaStream_t stream) {
  rmsnorm_kernel<TX, TW><<<rows, RMS_THREADS, (size_t)D * sizeof(float), stream>>>(
      (const TX*)x, (const TX*)res, (const TW*)w, (TX*)out, D, eps, offset);
  return cudaGetLastError();
}

// x, res (may be null), out: (rows, D) contiguous, of x_dtype; w: (D,) of
// w_dtype.  D * 4 bytes must fit the 48 KB of shared memory a block gets
// without opting in.  Returns cudaGetLastError().
extern "C" int rmsnorm_launch(const void* x, const void* res, const void* w, void* out,
                              int rows, int D, float eps, int offset, int x_dtype,
                              int w_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows <= 0) return 0;
  if (x_dtype == DT_F32 && w_dtype == DT_F32)
    return (int)launch<float, float>(x, res, w, out, rows, D, eps, offset, s);
  if (x_dtype == DT_F32 && w_dtype == DT_BF16)
    return (int)launch<float, __nv_bfloat16>(x, res, w, out, rows, D, eps, offset, s);
  if (x_dtype == DT_BF16 && w_dtype == DT_F32)
    return (int)launch<__nv_bfloat16, float>(x, res, w, out, rows, D, eps, offset, s);
  if (x_dtype == DT_BF16 && w_dtype == DT_BF16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, res, w, out, rows, D, eps, offset, s);
  return (int)cudaErrorInvalidValue;
}
