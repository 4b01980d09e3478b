// RMSNorm of rows, optionally of x + residual with the rounded sum written too.
//
// Replaces the TPU kernel `_rmsnorm_kernel` of src/repro/kernels/rmsnorm.py
// (driven by `rmsnorm`, which adds the residual in array code before the call
// and keeps a 128-row tile in VMEM).
//
// On this card the function is bound by bytes: each element of x (and of the
// residual) is read once and each output (and sum) element written once, with
// about five operations an element.  At the decode shape (8 rows of 3072) the
// bytes take a few nanoseconds, so the time there is latency: one round trip
// to device memory, one reduction, one store.  The design:
//
//   * One block a row; each thread holds its part of the row in registers:
//     C chunks of one 16-byte vector (8 bf16 or 4 fp32 values), thread t
//     taking vectors t, t + threads, ...  Every load of x, of the residual
//     and of w is issued before any value is used, so the whole row is in
//     flight at once (384 threads of one vector carry a 6 KB bf16 row).  No
//     shared-memory copy of the row: the length is limited by registers only.
//   * w is read in 16-byte vectors as well (an fp32 w beside a bf16 x: two
//     vectors per 8 elements).
//   * The sum of squares: one warp-shuffle tree, one exchange of the warps'
//     partials through a small shared array, one __syncthreads.
//   * 16-byte stores of the sum and of the output.
//   * The plan (threads, chunks, vector) is `rms_plan` below, mirrored on the
//     host by kernels/rmsnorm.py `launch_plan`; `rmsnorm_plan` reports it.
//   * A scalar variant (vector 1) of the same arithmetic takes a D that is
//     not a multiple of the vector, or a base that is not 16-byte aligned.
//
// Arithmetic as the reference: fp32 statistics, x * (1/sqrt(mean + eps)) *
// scale with scale = w or 1 + w, output rounded to x's type.  With a residual
// the sum is rounded to x's type before it is squared (and written), as the
// reference's array add rounds it.
//
// The backward (`rmsnorm_bwd_kernel`; the TPU kernel has none, the reference
// differentiates its plain rmsnorm) is bound by bytes as well: it reads x (the
// rounded sum where there was a residual), dy, w and, for add_rmsnorm, the
// gradient ds of the written sum, and writes dx.  With x^ = x * rstd and
// w' = w or 1 + w:
//
//   dx = rstd * (w' dy - x^ * mean(w' dy x^)) (+ ds),   dw = sum over rows of dy x^
//
// The row in registers as 16-byte vectors, as in the forward, but in blocks
// of 128 threads where a row fits in three chunks of them (`rms_bwd_plan`);
// `parts` blocks walk the rows blockIdx.x, blockIdx.x + parts, ...  A row's x, dy and ds are loaded as read once (evict first), the
// two sums are exchanged through one of two shared arrays in turn, so a row
// takes one __syncthreads, and each block keeps its share of dw in fp32
// registers and writes it as one fp32 row with 16-byte stores;
// `rmsnorm_dw_kernel` then sums the `parts` rows with the whole card: one
// block a strip of DW_COLS columns, DW_LANES threads down each column taking
// every DW_LANES-th row in order, then a fixed tree over the lanes.  No
// atomics: the result is the same on every run.  Measured on an H100 at
// R2048 D3072 bf16: the sum over 192 blocks in place of 12 took most of the
// gain, then four smaller blocks an SM in place of two of 384 threads; the
// next row's loads issued before this row's reduction were no faster.
#include "common.cuh"

#define RMS_MAX_THREADS 512

template <int BYTES> struct WordOf;
template <> struct WordOf<16> { using type = uint4; };
template <> struct WordOf<8> { using type = uint2; };
template <> struct WordOf<4> { using type = uint32_t; };
template <> struct WordOf<2> { using type = uint16_t; };

// N consecutive elements of T as raw bits in registers, moved by the widest
// loads and stores their size allows (16 bytes at most).
template <typename T, int N>
struct Bits {
  static constexpr int BYTES = (int)sizeof(T) * N;
  static constexpr int WB = BYTES >= 16 ? 16 : BYTES;
  using Word = typename WordOf<WB>::type;
  Word w[BYTES / WB];

  __device__ __forceinline__ void load(const T* p) {
    const Word* q = reinterpret_cast<const Word*>(p);
#pragma unroll
    for (int i = 0; i < BYTES / WB; ++i) w[i] = q[i];
  }
  // The same, marked as read once (evict first): the backward's rows.
  __device__ __forceinline__ void load_once(const T* p) {
    const Word* q = reinterpret_cast<const Word*>(p);
#pragma unroll
    for (int i = 0; i < BYTES / WB; ++i) w[i] = __ldcs(q + i);
  }
  __device__ __forceinline__ void store(T* p) const {
    Word* q = reinterpret_cast<Word*>(p);
#pragma unroll
    for (int i = 0; i < BYTES / WB; ++i) q[i] = w[i];
  }
  __device__ __forceinline__ float get(int i) const {
    return to_float<T>(reinterpret_cast<const T*>(w)[i]);
  }
  __device__ __forceinline__ void set(int i, float v) {
    reinterpret_cast<T*>(w)[i] = from_float<T>(v);
  }
};

template <typename TX, typename TW, int VEC, int C>
__global__ void __launch_bounds__(RMS_MAX_THREADS)
rmsnorm_kernel(const TX* __restrict__ x, const TX* __restrict__ res,
               const TW* __restrict__ w, TX* __restrict__ out, TX* __restrict__ sum_out,
               int D, float eps, int offset) {
  __shared__ float red[RMS_MAX_THREADS / 32];
  const int n = D / VEC;                                  // vectors a row
  const size_t base = (size_t)blockIdx.x * (size_t)D;
  Bits<TX, VEC> v[C], r[C];
  Bits<TW, VEC> wv[C];

  // every load first: x, the residual, w
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < n) v[c].load(x + base + (size_t)i * VEC);
  }
  if (res != nullptr) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = threadIdx.x + c * blockDim.x;
      if (i < n) r[c].load(res + base + (size_t)i * VEC);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < n) wv[c].load(w + (size_t)i * VEC);
  }

  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < n) {
      if (res != nullptr) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[c].set(e, v[c].get(e) + r[c].get(e));   // rounded to TX
        if (sum_out != nullptr) v[c].store(sum_out + base + (size_t)i * VEC);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = v[c].get(e);
        ss += f * f;
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  ss = warp_sum(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f);
  const float rs = 1.0f / sqrtf(ss / (float)D + eps);

#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < n) {
      Bits<TX, VEC> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float scale = wv[c].get(e);
        if (offset) scale = 1.0f + scale;
        o.set(e, v[c].get(e) * rs * scale);
      }
      o.store(out + base + (size_t)i * VEC);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward.

#define DW_COLS 16    // columns of dw a block of the sum
#define DW_LANES 32   // threads down each column

template <typename TX, typename TW, int VEC, int C>
__global__ void __launch_bounds__(RMS_MAX_THREADS)
rmsnorm_bwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   const TX* __restrict__ dy, const TX* __restrict__ ds, TX* __restrict__ dx,
                   float* __restrict__ dw_part, int rows, int D, float eps, int offset) {
  __shared__ float red[2][2][RMS_MAX_THREADS / 32];   // [row parity][sum x^2, sum w' dy x][warp]
  const int n = D / VEC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  Bits<TW, VEC> wv[C];
  float dw[C][VEC];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < n) wv[c].load(w + (size_t)i * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) dw[c][e] = 0.f;
  }

  for (int row = blockIdx.x, it = 0; row < rows; row += gridDim.x, ++it) {
    const size_t base = (size_t)row * (size_t)D;
    Bits<TX, VEC> xv[C], gv[C], sv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = threadIdx.x + c * blockDim.x;
      if (i < n) {
        xv[c].load_once(x + base + (size_t)i * VEC);
        gv[c].load_once(dy + base + (size_t)i * VEC);
        if (ds != nullptr) sv[c].load_once(ds + base + (size_t)i * VEC);
      }
    }
    float ss = 0.f, gx = 0.f;   // sum of x^2, sum of w' dy x
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = threadIdx.x + c * blockDim.x;
      if (i < n) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = xv[c].get(e);
          const float sc = offset ? 1.0f + wv[c].get(e) : wv[c].get(e);
          ss += f * f;
          gx += sc * gv[c].get(e) * f;
        }
      }
    }
    ss = warp_sum(ss);
    gx = warp_sum(gx);
    float (*rd)[RMS_MAX_THREADS / 32] = red[it & 1];
    if (lane == 0) { rd[0][warp] = ss; rd[1][warp] = gx; }
    // one barrier a row: a warp writes the other array next row, and this one
    // again only once every warp has passed next row's barrier
    __syncthreads();
    ss = warp_sum(lane < warps ? rd[0][lane] : 0.f);
    gx = warp_sum(lane < warps ? rd[1][lane] : 0.f);
    const float rs = 1.0f / sqrtf(ss / (float)D + eps);
    const float k = rs * rs * gx / (float)D;   // x^ * mean(w' dy x^) = x * k * rs
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = threadIdx.x + c * blockDim.x;
      if (i < n) {
        Bits<TX, VEC> o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = xv[c].get(e), g = gv[c].get(e);
          const float sc = offset ? 1.0f + wv[c].get(e) : wv[c].get(e);
          float v = rs * (sc * g - f * k);
          if (ds != nullptr) v += sv[c].get(e);
          o.set(e, v);
          dw[c][e] += g * f * rs;
        }
        o.store(dx + base + (size_t)i * VEC);
      }
    }
  }

  float* part = dw_part + (size_t)blockIdx.x * (size_t)D;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < n) {
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int q = 0; q < VEC / 4; ++q)
          *reinterpret_cast<float4*>(part + (size_t)i * VEC + 4 * q) =
              make_float4(dw[c][4 * q], dw[c][4 * q + 1], dw[c][4 * q + 2], dw[c][4 * q + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) part[(size_t)i * VEC + e] = dw[c][e];
      }
    }
  }
}

// dw[d] = the sum over the `parts` rows of dw_part[., d]: lane ty of a column
// sums rows ty, ty + DW_LANES, ... in order, then the lanes' sums are added
// in a fixed tree.
template <typename TW>
__global__ void __launch_bounds__(DW_COLS * DW_LANES)
rmsnorm_dw_kernel(const float* __restrict__ dw_part, TW* __restrict__ dw, int parts, int D) {
  __shared__ float sums[DW_LANES][DW_COLS + 1];
  const int tx = threadIdx.x % DW_COLS, ty = threadIdx.x / DW_COLS;
  const int d = blockIdx.x * DW_COLS + tx;
  float acc = 0.f;
  if (d < D) {
#pragma unroll 4
    for (int r = ty; r < parts; r += DW_LANES) acc += dw_part[(size_t)r * D + d];
  }
  sums[ty][tx] = acc;
  __syncthreads();
#pragma unroll
  for (int half = DW_LANES / 2; half > 0; half >>= 1) {
    if (ty < half) sums[ty][tx] += sums[ty + half][tx];
    __syncthreads();
  }
  if (ty == 0 && d < D) dw[d] = from_float<TW>(sums[0][tx]);
}

// ---------------------------------------------------------------------------
// The plan: threads a block, chunks a thread, elements a load.

static const int kVecChunks[] = {1, 2, 3, 4, 6, 8};         // vector variant
static const int kScalarChunks[] = {1, 2, 4, 8, 16, 32};     // scalar variant

struct RmsPlan {
  int threads, chunks, vector;
};

// The fewest chunks a thread whose block, rounded up to whole warps, stays
// within RMS_MAX_THREADS.  threads == 0: D is past what the registers hold.
static RmsPlan rms_plan(int D, int itemsize, int aligned) {
  const int vec = 16 / itemsize;
  RmsPlan p{0, 0, (aligned && D % vec == 0) ? vec : 1};
  const int n = D / p.vector;
  const int* chunks = p.vector > 1 ? kVecChunks : kScalarChunks;
  for (int k = 0; k < 6; ++k) {
    const int c = chunks[k];
    const int t = ((n + c - 1) / c + 31) / 32 * 32;
    if (t <= RMS_MAX_THREADS) {
      p.threads = t;
      p.chunks = c;
      return p;
    }
  }
  return p;
}

struct RmsArgs {
  const void *x, *res, *w;
  void *out, *sum_out;
  int rows, D;
  float eps;
  int offset, threads;
};

template <typename TX, typename TW, int VEC, int C>
static cudaError_t run(const RmsArgs& a, cudaStream_t s) {
  rmsnorm_kernel<TX, TW, VEC, C><<<a.rows, a.threads, 0, s>>>(
      (const TX*)a.x, (const TX*)a.res, (const TW*)a.w, (TX*)a.out, (TX*)a.sum_out, a.D, a.eps,
      a.offset);
  return cudaGetLastError();
}

struct RmsBwdArgs {
  const void *x, *w, *dy, *ds;
  void *dx, *dw;
  float* dw_part;
  int rows, D;
  float eps;
  int offset, threads, parts;
};

template <typename TX, typename TW, int VEC, int C>
static cudaError_t run(const RmsBwdArgs& a, cudaStream_t s) {
  rmsnorm_bwd_kernel<TX, TW, VEC, C><<<a.parts, a.threads, 0, s>>>(
      (const TX*)a.x, (const TW*)a.w, (const TX*)a.dy, (const TX*)a.ds, (TX*)a.dx, a.dw_part,
      a.rows, a.D, a.eps, a.offset);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rmsnorm_dw_kernel<TW>
      <<<(a.D + DW_COLS - 1) / DW_COLS, DW_COLS * DW_LANES, 0, s>>>(a.dw_part, (TW*)a.dw, a.parts, a.D);
  return cudaGetLastError();
}

#define RMS_CASE(C) \
  case C:           \
    return run<TX, TW, VEC, C>(a, s);

template <typename TX, typename TW, int VEC, typename A>
static cudaError_t dispatch(const A& a, int chunks, cudaStream_t s) {
  if constexpr (VEC > 1) {
    switch (chunks) { RMS_CASE(1) RMS_CASE(2) RMS_CASE(3) RMS_CASE(4) RMS_CASE(6) RMS_CASE(8) }
  } else {
    switch (chunks) { RMS_CASE(1) RMS_CASE(2) RMS_CASE(4) RMS_CASE(8) RMS_CASE(16) RMS_CASE(32) }
  }
  return cudaErrorInvalidValue;
}

template <typename TX, typename TW, typename A>
static cudaError_t dispatch_vector(const A& a, int chunks, int vector, cudaStream_t s) {
  constexpr int VEC = 16 / (int)sizeof(TX);
  if (vector == VEC) return dispatch<TX, TW, VEC>(a, chunks, s);
  if (vector == 1) return dispatch<TX, TW, 1>(a, chunks, s);
  return cudaErrorInvalidValue;
}

template <typename A>
static cudaError_t dispatch_types(const A& a, int x_dtype, int w_dtype, int chunks, int vector,
                                  cudaStream_t s) {
  if (x_dtype == DT_F32 && w_dtype == DT_F32)
    return dispatch_vector<float, float>(a, chunks, vector, s);
  if (x_dtype == DT_F32 && w_dtype == DT_BF16)
    return dispatch_vector<float, __nv_bfloat16>(a, chunks, vector, s);
  if (x_dtype == DT_BF16 && w_dtype == DT_F32)
    return dispatch_vector<__nv_bfloat16, float>(a, chunks, vector, s);
  if (x_dtype == DT_BF16 && w_dtype == DT_BF16)
    return dispatch_vector<__nv_bfloat16, __nv_bfloat16>(a, chunks, vector, s);
  return cudaErrorInvalidValue;
}

// out[0..2] = the plan for rows of D of x_dtype (aligned: x, residual and w
// start on 16 bytes).  Returns 0, or cudaErrorInvalidValue past the limit.
extern "C" int rmsnorm_plan(int D, int x_dtype, int aligned, int* out) {
  if (D <= 0 || (x_dtype != DT_F32 && x_dtype != DT_BF16)) return (int)cudaErrorInvalidValue;
  const RmsPlan p = rms_plan(D, x_dtype == DT_F32 ? 4 : 2, aligned);
  out[0] = p.threads;
  out[1] = p.chunks;
  out[2] = p.vector;
  return p.threads > 0 ? 0 : (int)cudaErrorInvalidValue;
}

// x, res (may be null), out, sum_out (may be null; needs res): (rows, D)
// contiguous, of x_dtype; w: (D,) of w_dtype.  (threads, chunks, vector) is a
// plan the kernel is built for that covers D; vector > 1 needs every base
// 16-byte aligned.  Returns cudaGetLastError().
extern "C" int rmsnorm_launch(const void* x, const void* res, const void* w, void* out,
                              void* sum_out, int rows, int D, float eps, int offset,
                              int x_dtype, int w_dtype, int threads, int chunks, int vector,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows <= 0) return 0;
  if (threads < 32 || threads > RMS_MAX_THREADS || threads % 32 || vector < 1 || D % vector ||
      (long long)threads * chunks * vector < D || (sum_out != nullptr && res == nullptr))
    return (int)cudaErrorInvalidValue;
  const RmsArgs a{x, res, w, out, sum_out, rows, D, eps, offset, threads};
  return (int)dispatch_types(a, x_dtype, w_dtype, chunks, vector, s);
}

// The backward's plan.  Where a row fits in at most kBwdChunks chunks of a
// block of at most kBwdThreads threads, that block (the fewest chunks), and
// kBwdPartsSmall of them: four such blocks share an SM of an H100 (128
// registers a thread at 3 chunks).  Otherwise the forward's plan and
// kBwdParts blocks, two an SM.  At R2048 D3072 bf16 on an H100, 128 x 3 on
// 528 blocks took 0.0212 ms with the sum's gradient, the forward's 384 x 1 on
// 256 blocks 0.0225.  Each block writes one row of partial dw.
static const int kBwdThreads = 128, kBwdChunks = 3;
static const int kBwdPartsSmall = 528, kBwdParts = 256;

static RmsPlan rms_bwd_plan(int D, int itemsize, int aligned) {
  const int vec = 16 / itemsize;
  const int vector = (aligned && D % vec == 0) ? vec : 1;
  const int n = D / vector;
  const int* chunks = vector > 1 ? kVecChunks : kScalarChunks;
  for (int k = 0; k < 6 && chunks[k] <= kBwdChunks; ++k) {
    const int t = ((n + chunks[k] - 1) / chunks[k] + 31) / 32 * 32;
    if (t <= kBwdThreads) return RmsPlan{t, chunks[k], vector};
  }
  return rms_plan(D, itemsize, aligned);
}

// out[0..4] = the backward's plan for `rows` rows of D (aligned as for
// rmsnorm_plan): threads, chunks, vector, the blocks that walk the rows
// (`parts`, at most `rows`) and the blocks of the dw sum.  Returns 0, or
// cudaErrorInvalidValue past the limit.
extern "C" int rmsnorm_bwd_plan(int D, int x_dtype, int aligned, int rows, int* out) {
  if (D <= 0 || (x_dtype != DT_F32 && x_dtype != DT_BF16)) return (int)cudaErrorInvalidValue;
  const RmsPlan p = rms_bwd_plan(D, x_dtype == DT_F32 ? 4 : 2, aligned);
  const int cap = p.threads <= kBwdThreads ? kBwdPartsSmall : kBwdParts;
  out[0] = p.threads;
  out[1] = p.chunks;
  out[2] = p.vector;
  out[3] = rows < cap ? (rows > 0 ? rows : 1) : cap;
  out[4] = (D + DW_COLS - 1) / DW_COLS;
  return p.threads > 0 ? 0 : (int)cudaErrorInvalidValue;
}

// Backward.  x (the normalised input: the rounded sum where the forward had a
// residual), dy, ds (may be null: add_rmsnorm's gradient of the written sum),
// dx: (rows, D) contiguous, of x_dtype; w, dw: (D,) of w_dtype; dw_part:
// (parts, D) fp32 scratch.  (threads, chunks, vector) is a plan the kernel is
// built for that covers D (rmsnorm_bwd_plan's); `parts` blocks walk the rows,
// 1 <= parts <= rows.  Launches the
// row kernel and the dw reduction.  Returns cudaGetLastError().
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w, const void* dy, const void* ds,
                                  void* dx, void* dw, float* dw_part, int rows, int D, float eps,
                                  int offset, int x_dtype, int w_dtype, int threads, int chunks,
                                  int vector, int parts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows <= 0) return 0;
  if (threads < 32 || threads > RMS_MAX_THREADS || threads % 32 || vector < 1 || D % vector ||
      (long long)threads * chunks * vector < D || parts < 1 || parts > rows)
    return (int)cudaErrorInvalidValue;
  const RmsBwdArgs a{x, w, dy, ds, dx, dw, dw_part, rows, D, eps, offset, threads, parts};
  return (int)dispatch_types(a, x_dtype, w_dtype, chunks, vector, s);
}
