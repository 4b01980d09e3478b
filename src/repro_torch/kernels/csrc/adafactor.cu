// Adafactor's update of one layer group: g and p of every layer in, the
// factored second moments (vr, vc) or the plain one (v) and p out, in place.
//
// Not the port of a TPU kernel: the reference's Adafactor
// (src/repro/training/optimizer.py `adafactor`) is array code that XLA fuses
// into a few passes over each stacked leaf.  Eager PyTorch runs it as about
// forty fp32 elementwise and reduction launches a leaf, each reading and
// writing whole fp32 temporaries, after copying the group's layers into one
// stacked tensor (kernels/adafactor.py `adafactor_update_plain`).  These
// kernels take the layers where they lie (an array of pointers passed by
// value) and keep the reference's stacked semantics: a factored group is M
// matrices of R x C (the stacked array's last two dims), its row means go to
// vr, its column means to vc, vr's mean over each matrix's rows scales it,
// and the RMS of u and of p run over the whole group.
//
// On this card they are bound by bytes.  The clip divides by the RMS of the
// whole update, so every u must be known before any is applied, and an exact
// design reads g three times and p twice and writes p once:
//
//   factored:   (a) stats   read g, p: vr, column partials of row slabs,
//                           sums of p^2                              af_stats_kernel
//               (a2) cols   the slabs' column partials summed: vc, and
//                           vr's mean a matrix (only where a matrix
//                           has more than one slab)                  af_cols_kernel
//               (b) usq     read g: sums of u^2                      af_usq_kernel
//               (s) scalars the clip divisor, lr x RMS(p), lr x wd   af_scalars_kernel
//               (c) apply   read g, p, write p                       af_apply_kernel
//   plain (1-D, a last dim of 1, 0-d):
//               (a+b) read g, p, v: v, sums of u^2 and of p^2       af_v_kernel
//               (s), then (c) read g, v, p, write p                 af_vapply_kernel
//
// A block of 256 threads (8 warps) takes a slab of SR consecutive rows of
// one matrix across all of its columns, in chunks of 32 x VEC columns: lane
// l holds columns l VEC .. l VEC + VEC - 1 of the chunk (one 16-byte vector
// where the layers are aligned), warp w the slab's rows w, w + 8, ...  A
// grid-stride loop runs over the slabs (kernels/adafactor.py `launch_plan`
// picks SR: about four slabs an SM, as long as the column workspace, M x
// slabs x C floats, stays under 10 MiB; (b) and (c) keep no column partials
// and walk slabs of their own, SR2 rows, about four an SM whatever C is).
//
// Every sum runs in one fixed order, with no atomics, so two runs give the
// same bits, and none is a long sequential fp32 loop.  Trees add adjacent
// pairs level by level ((x0 + x1) + (x2 + x3)) + ...; a warp's tree is the
// xor butterfly with offsets 1, 2, 4, 8, 16, which is that tree in every
// lane.  A column's sum: each warp's rows in order (SR / 8 of them), a tree
// over the 8 warps, a tree over the slabs.  A row's: a tree over each chunk
// (the lane's VEC values, then the warp), the chunks in order.  u^2 and p^2:
// each thread's values in order (a tree over each vector), a tree over the
// warp, over the block, then over the partials (af_scalars_kernel: 1024
// threads each add every 1024th partial in order, then a tree).
// tests/test_torch_adafactor.py emulates this plan in float32.
//
// The elementwise arithmetic is the plain version's, in its order, rounded
// after every operation (__fmul_rn, __fadd_rn, __fdiv_rn keep nvcc from
// contracting a product and a sum into an FMA; rsqrtf is what PyTorch's
// CUDA rsqrt calls), with g and p widened to fp32 and p rounded back to its
// type.  lr and beta2 are read from device memory (0-d tensors the step
// computed), so nothing synchronises with the host.
#include "common.cuh"

#define AF_THREADS 256
#define AF_WARPS 8
#define AF_MAX_LAYERS 128      // kernels/adafactor.py MAX_LAYERS
#define AF_MAX_SLAB 1024       // kernels/adafactor.py MAX_SLAB_ROWS
#define AF_SCALAR_THREADS 1024 // kernels/adafactor.py SCALAR_THREADS

// By value, as a __grid_constant__ parameter: no copy of the pointers to the
// card, and a layer's pointer is read from the parameter space in place.
struct AfLayers {
  const void* g[AF_MAX_LAYERS];
  void* p[AF_MAX_LAYERS];
};

struct AfShape {
  long long n;      // elements a layer
  long long rpl;    // factored: rows a layer (n / C)
  long long M, R, C;
  long long slabs;  // factored: M x S; plain: unused
  int SR, S;        // factored: rows a slab, slabs a matrix, of (a)
  long long slabs2; // factored: M x S2
  int SR2, S2;      // and of (b) and (c), which keep no column partials
  float N;          // elements of the group, as PyTorch's mean divides by them
};

struct AfScalars {
  float eps1, eps2, clip, wd;
};

__device__ __forceinline__ float clamp_min(float x, float lo) {   // torch.clamp(x, min=lo)
  return x < lo ? lo : x;                                        // (a NaN stays NaN)
}

template <typename T, int VEC>
__device__ __forceinline__ void loadv(const T* src, float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = to_float<T>(src[0]);
  } else if constexpr (VEC == 4) {
    const float4 f = load4<T>(src);
    x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
  } else if constexpr (sizeof(T) == 2) {   // 8 bf16: one 16-byte load
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {                                  // 8 fp32: two 16-byte loads
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename T, int VEC>
__device__ __forceinline__ void storev(T* dst, const float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    dst[0] = from_float<T>(x[0]);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      reinterpret_cast<float4*>(dst)[i / 4] = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  } else if constexpr (VEC == 4) {
    uint2 raw;
    raw.x = pack_bf16(x[0], x[1]);
    raw.y = pack_bf16(x[2], x[3]);
    *reinterpret_cast<uint2*>(dst) = raw;
  } else {
    uint4 raw;
    raw.x = pack_bf16(x[0], x[1]);
    raw.y = pack_bf16(x[2], x[3]);
    raw.z = pack_bf16(x[4], x[5]);
    raw.w = pack_bf16(x[6], x[7]);
    *reinterpret_cast<uint4*>(dst) = raw;
  }
}

// Adjacent pairs, level by level (the order every sum here keeps).
template <int VEC>
__device__ __forceinline__ float vec_tree(const float (&x)[VEC]) {
  float t[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) t[i] = x[i];
#pragma unroll
  for (int w = 1; w < VEC; w <<= 1)
#pragma unroll
    for (int i = 0; i + w < VEC; i += 2 * w) t[i] = __fadd_rn(t[i], t[i + w]);
  return t[0];
}

// The same tree over a warp's 32 values, in every lane.
__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The tree over a block's 8 warps' values; the result in thread 0 (all
// threads call it; it ends with a barrier, so `red` may be reused).
__device__ __forceinline__ float block_tree(float v, float* red) {
  v = warp_tree(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float out = 0.f;
  if (threadIdx.x == 0) {
    float t[AF_WARPS];
#pragma unroll
    for (int i = 0; i < AF_WARPS; ++i) t[i] = red[i];
    out = vec_tree<AF_WARPS>(t);
  }
  __syncthreads();
  return out;
}

// In place over a[0 .. n) in shared memory, the sum left in a[0].
__device__ __forceinline__ void shared_tree(float* a, int n) {
  for (int w = 1; w < n; w <<= 1) {
    for (int i = threadIdx.x * 2 * w; i + w < n; i += AF_THREADS * 2 * w)
      a[i] = __fadd_rn(a[i], a[i + w]);
    __syncthreads();
  }
}

// In place over a[0], a[stride], ... a[(n - 1) stride] by one thread.
__device__ __forceinline__ float strided_tree(float* a, long long n, long long stride) {
  for (long long w = 1; w < n; w <<= 1)
    for (long long i = 0; i + w < n; i += 2 * w)
      a[i * stride] = __fadd_rn(a[i * stride], a[(i + w) * stride]);
  return a[0];
}

// beta2 x s + (1 - beta2) x mean, as the plain version rounds it.
__device__ __forceinline__ float ema(float b, float omb, float s, float mean) {
  return __fadd_rn(__fmul_rn(b, s), __fmul_rn(omb, mean));
}

// u = rsqrt(max(d, eps1)) x g (the factored form) or g x rsqrt(max(v, eps1)).
__device__ __forceinline__ float u_of(float g, float d, float eps1) {
  return __fmul_rn(rsqrtf(clamp_min(d, eps1)), g);
}

// p - (lr scale) (u / clip divisor) - (lr wd) p; s = {clip divisor, lr
// scale, lr wd}.  u / 1 is u, so the division is made only where the clip
// bites (a branch the whole grid takes alike).
__device__ __forceinline__ float apply_one(float p, float u, const float (&s)[3]) {
  if (s[0] != 1.f) u = __fdiv_rn(u, s[0]);
  const float t = __fmul_rn(u, s[1]);
  return __fsub_rn(__fsub_rn(p, t), __fmul_rn(s[2], p));
}

// ---------------------------------------------------------------------------
// factored groups
// ---------------------------------------------------------------------------

// Where a slab's rows lie: every row of a matrix in one layer (a layer holds
// n / C = rpl rows, a multiple of R), or a row a layer (rpl = 1: a stack of
// 1-D layers, the reference's (L, D) matrix).  Found once a slab, so no row
// pays a 64-bit division.
struct SlabAt {
  long long layer, row;   // the slab's first row: its layer, its row in the layer
  bool row_a_layer;
};

__device__ __forceinline__ SlabAt slab_at(const AfShape& sh, long long q0) {
  if (sh.rpl == 1) return SlabAt{q0, 0, true};
  const long long layer = q0 / sh.rpl;
  return SlabAt{layer, q0 - layer * sh.rpl, false};
}

// Columns c0.. of the slab's row j.
template <typename T>
__device__ __forceinline__ T* row_ptr(void* const* ptrs, const AfShape& sh, const SlabAt& at,
                                      int j, long long c0) {
  if (at.row_a_layer) return reinterpret_cast<T*>(ptrs[at.layer + j]) + c0;
  return reinterpret_cast<T*>(ptrs[at.layer]) + (at.row + j) * sh.C + c0;
}

// Rows a warp of (b) has in flight: it loads AF_U_USQ rows (j, j + 8, ...)
// before it adds any, so its sum keeps the rows' order.  (a) and (c) take
// one row at a time.
#define AF_U_USQ 2

template <typename TG, typename TP, int VEC>
__global__ void __launch_bounds__(AF_THREADS)
af_stats_kernel(const __grid_constant__ AfLayers lay, const AfShape sh, float* __restrict__ vr,
                float* __restrict__ vc, float* __restrict__ colpart, float* __restrict__ vrpart,
                float* __restrict__ rmean, float* __restrict__ ppart,
                const float* __restrict__ beta2_p, const AfScalars sc) {
  constexpr int CW = 32 * VEC;
  __shared__ float rowacc[AF_MAX_SLAB];
  __shared__ float colbuf[AF_WARPS][CW];
  __shared__ float red[AF_WARPS];
  const float b = *beta2_p, omb = __fsub_rn(1.f, b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long C = sh.C, R = sh.R;
  const int chunks = (int)((C + CW - 1) / CW);
  void* const* gp = (void* const*)lay.g;
  for (long long slab = blockIdx.x; slab < sh.slabs; slab += gridDim.x) {
    const long long m = slab / sh.S;
    const long long r0 = (slab - m * sh.S) * sh.SR;
    const int nr = (int)min((long long)sh.SR, R - r0);
    const SlabAt at = slab_at(sh, m * R + r0);
    float pacc = 0.f;
    for (int k = 0; k < chunks; ++k) {
      const long long c0 = (long long)k * CW + lane * VEC;
      const bool active = c0 < C;
      float cacc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) cacc[i] = 0.f;
      for (int j = warp; j < nr; j += AF_WARPS) {
        float x[VEC] = {}, pv[VEC] = {};
        if (active) {
          loadv<TG, VEC>(row_ptr<const TG>(gp, sh, at, j, c0), x);
          loadv<TP, VEC>(row_ptr<TP>(lay.p, sh, at, j, c0), pv);
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          x[i] = active ? __fadd_rn(__fmul_rn(x[i], x[i]), sc.eps1) : 0.f;
          pv[i] = __fmul_rn(pv[i], pv[i]);
          cacc[i] = __fadd_rn(cacc[i], x[i]);
        }
        const float rs = warp_tree(vec_tree<VEC>(x));
        pacc = __fadd_rn(pacc, vec_tree<VEC>(pv));
        if (lane == 0) rowacc[j] = k == 0 ? rs : __fadd_rn(rowacc[j], rs);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) colbuf[warp][lane * VEC + i] = cacc[i];
      __syncthreads();
      for (int t = threadIdx.x; t < CW; t += AF_THREADS) {
        const long long c = (long long)k * CW + t;
        if (c < C) {
          float v[AF_WARPS];
#pragma unroll
          for (int w = 0; w < AF_WARPS; ++w) v[w] = colbuf[w][t];
          const float sum = vec_tree<AF_WARPS>(v);
          if (sh.S == 1)
            vc[m * C + c] = ema(b, omb, vc[m * C + c], __fdiv_rn(sum, (float)R));
          else
            colpart[slab * C + c] = sum;
        }
      }
      __syncthreads();
    }
    for (int j = threadIdx.x; j < nr; j += AF_THREADS) {
      const long long q = m * R + r0 + j;
      const float v = ema(b, omb, vr[q], __fdiv_rn(rowacc[j], (float)C));
      vr[q] = v;
      rowacc[j] = v;
    }
    __syncthreads();
    shared_tree(rowacc, nr);
    const float ps = block_tree(pacc, red);
    if (threadIdx.x == 0) {
      ppart[slab] = ps;
      if (sh.S == 1)
        rmean[m] = clamp_min(__fdiv_rn(rowacc[0], (float)R), sc.eps1);
      else
        vrpart[slab] = rowacc[0];
    }
    __syncthreads();
  }
}

// A matrix's column sums over its slabs, and its vr mean (S > 1 only).
__global__ void __launch_bounds__(AF_THREADS)
af_cols_kernel(const AfShape sh, float* __restrict__ vc, float* __restrict__ colpart,
               float* __restrict__ vrpart, float* __restrict__ rmean,
               const float* __restrict__ beta2_p, const AfScalars sc) {
  const float b = *beta2_p, omb = __fsub_rn(1.f, b);
  const long long col_blocks = (sh.C + AF_THREADS - 1) / AF_THREADS;
  for (long long blk = blockIdx.x; blk < sh.M * col_blocks; blk += gridDim.x) {
    const long long m = blk / col_blocks;
    const long long c = (blk - m * col_blocks) * AF_THREADS + threadIdx.x;
    if (c < sh.C) {
      const float sum = strided_tree(colpart + m * sh.S * sh.C + c, sh.S, sh.C);
      vc[m * sh.C + c] = ema(b, omb, vc[m * sh.C + c], __fdiv_rn(sum, (float)sh.R));
    }
    if (blk == m * col_blocks && threadIdx.x == 0) {
      const float sum = strided_tree(vrpart + m * sh.S, sh.S, 1);
      rmean[m] = clamp_min(__fdiv_rn(sum, (float)sh.R), sc.eps1);
    }
  }
}

template <typename TG, int VEC>
__global__ void __launch_bounds__(AF_THREADS)
af_usq_kernel(const __grid_constant__ AfLayers lay, const AfShape sh,
              const float* __restrict__ vr, const float* __restrict__ vc,
              const float* __restrict__ rmean, float* __restrict__ upart, const AfScalars sc) {
  constexpr int CW = 32 * VEC;
  __shared__ float red[AF_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long C = sh.C, R = sh.R;
  const int chunks = (int)((C + CW - 1) / CW);
  void* const* gp = (void* const*)lay.g;
  for (long long slab = blockIdx.x; slab < sh.slabs2; slab += gridDim.x) {
    const long long m = slab / sh.S2;
    const long long r0 = (slab - m * sh.S2) * sh.SR2;
    const int nr = (int)min((long long)sh.SR2, R - r0);
    const SlabAt at = slab_at(sh, m * R + r0);
    const float rm = rmean[m];
    float uacc = 0.f;
    for (int k = 0; k < chunks; ++k) {
      const long long c0 = (long long)k * CW + lane * VEC;
      const bool active = c0 < C;
      float cv[VEC] = {};
      if (active) loadv<float, VEC>(vc + m * C + c0, cv);
      for (int j0 = warp; j0 < nr; j0 += AF_U_USQ * AF_WARPS) {
        float x[AF_U_USQ][VEC] = {}, rv[AF_U_USQ];
#pragma unroll
        for (int u = 0; u < AF_U_USQ; ++u) {
          const int j = j0 + u * AF_WARPS;
          rv[u] = j < nr ? vr[m * R + r0 + j] : 1.f;
          if (active && j < nr) loadv<TG, VEC>(row_ptr<const TG>(gp, sh, at, j, c0), x[u]);
        }
#pragma unroll
        for (int u = 0; u < AF_U_USQ; ++u) {
          if (j0 + u * AF_WARPS >= nr) break;
          const float rf = __fdiv_rn(rv[u], rm);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float v = u_of(x[u][i], __fmul_rn(rf, cv[i]), sc.eps1);
            x[u][i] = active ? __fmul_rn(v, v) : 0.f;
          }
          uacc = __fadd_rn(uacc, vec_tree<VEC>(x[u]));
        }
      }
    }
    const float us = block_tree(uacc, red);
    if (threadIdx.x == 0) upart[slab] = us;
  }
}

template <typename TG, typename TP, int VEC>
__global__ void __launch_bounds__(AF_THREADS)
af_apply_kernel(const __grid_constant__ AfLayers lay, const AfShape sh,
                const float* __restrict__ vr, const float* __restrict__ vc,
                const float* __restrict__ rmean, const float* __restrict__ scal,
                const AfScalars sc) {
  constexpr int CW = 32 * VEC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long C = sh.C, R = sh.R;
  const int chunks = (int)((C + CW - 1) / CW);
  const float s[3] = {scal[0], scal[1], scal[2]};
  void* const* gp = (void* const*)lay.g;
  for (long long slab = blockIdx.x; slab < sh.slabs2; slab += gridDim.x) {
    const long long m = slab / sh.S2;
    const long long r0 = (slab - m * sh.S2) * sh.SR2;
    const int nr = (int)min((long long)sh.SR2, R - r0);
    const SlabAt at = slab_at(sh, m * R + r0);
    const float rm = rmean[m];
    for (int k = 0; k < chunks; ++k) {
      const long long c0 = (long long)k * CW + lane * VEC;
      if (c0 >= C) continue;
      float cv[VEC];
      loadv<float, VEC>(vc + m * C + c0, cv);
      for (int j = warp; j < nr; j += AF_WARPS) {
        const float rf = __fdiv_rn(vr[m * R + r0 + j], rm);
        TP* pp = row_ptr<TP>(lay.p, sh, at, j, c0);
        float x[VEC], pv[VEC];
        loadv<TG, VEC>(row_ptr<const TG>(gp, sh, at, j, c0), x);
        loadv<TP, VEC>(pp, pv);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          pv[i] = apply_one(pv[i], u_of(x[i], __fmul_rn(rf, cv[i]), sc.eps1), s);
        storev<TP, VEC>(pp, pv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// groups that are not factored: flat over the group's L x n elements
// ---------------------------------------------------------------------------

template <typename TG, typename TP, int VEC>
__global__ void __launch_bounds__(AF_THREADS)
af_v_kernel(const __grid_constant__ AfLayers lay, const AfShape sh, long long total, float* __restrict__ v,
            float* __restrict__ upart, float* __restrict__ ppart,
            const float* __restrict__ beta2_p, const AfScalars sc) {
  __shared__ float red[AF_WARPS];
  const float b = *beta2_p, omb = __fsub_rn(1.f, b);
  float uacc = 0.f, pacc = 0.f;
  const long long stride = (long long)gridDim.x * AF_THREADS;
  for (long long i = (long long)blockIdx.x * AF_THREADS + threadIdx.x; i * VEC < total;
       i += stride) {
    const long long e = i * VEC, layer = e / sh.n, off = e - layer * sh.n;
    float x[VEC], pv[VEC], vv[VEC];
    loadv<TG, VEC>(reinterpret_cast<const TG*>(lay.g[layer]) + off, x);
    loadv<TP, VEC>(reinterpret_cast<const TP*>(lay.p[layer]) + off, pv);
    loadv<float, VEC>(v + e, vv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      vv[j] = ema(b, omb, vv[j], __fadd_rn(__fmul_rn(x[j], x[j]), sc.eps1));
      const float u = u_of(x[j], vv[j], sc.eps1);
      x[j] = __fmul_rn(u, u);
      pv[j] = __fmul_rn(pv[j], pv[j]);
    }
    storev<float, VEC>(v + e, vv);
    uacc = __fadd_rn(uacc, vec_tree<VEC>(x));
    pacc = __fadd_rn(pacc, vec_tree<VEC>(pv));
  }
  const float us = block_tree(uacc, red);
  const float ps = block_tree(pacc, red);
  if (threadIdx.x == 0) {
    upart[blockIdx.x] = us;
    ppart[blockIdx.x] = ps;
  }
}

template <typename TG, typename TP, int VEC>
__global__ void __launch_bounds__(AF_THREADS)
af_vapply_kernel(const __grid_constant__ AfLayers lay, const AfShape sh, long long total,
                 const float* __restrict__ v, const float* __restrict__ scal,
                 const AfScalars sc) {
  const float s[3] = {scal[0], scal[1], scal[2]};
  const long long stride = (long long)gridDim.x * AF_THREADS;
  for (long long i = (long long)blockIdx.x * AF_THREADS + threadIdx.x; i * VEC < total;
       i += stride) {
    const long long e = i * VEC, layer = e / sh.n, off = e - layer * sh.n;
    float x[VEC], pv[VEC], vv[VEC];
    TP* pp = reinterpret_cast<TP*>(lay.p[layer]) + off;
    loadv<TG, VEC>(reinterpret_cast<const TG*>(lay.g[layer]) + off, x);
    loadv<TP, VEC>(pp, pv);
    loadv<float, VEC>(v + e, vv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) pv[j] = apply_one(pv[j], u_of(x[j], vv[j], sc.eps1), s);
    storev<TP, VEC>(pp, pv);
  }
}

// ---------------------------------------------------------------------------
// the step's scalars from the partials
// ---------------------------------------------------------------------------

// scal[0] = max(sqrt(mean(u^2) + eps1) / clip, 1), scal[1] = lr x max(sqrt(mean(p^2)), eps2),
// scal[2] = lr x wd.  One block of AF_SCALAR_THREADS.
__global__ void __launch_bounds__(AF_SCALAR_THREADS)
af_scalars_kernel(const float* __restrict__ upart, long long uparts,
                  const float* __restrict__ ppart, long long pparts, float N,
                  float* __restrict__ scal, const float* __restrict__ lr_p, const AfScalars sc) {
  __shared__ float us[AF_SCALAR_THREADS], ps[AF_SCALAR_THREADS];
  float u = 0.f, p = 0.f;
  for (long long i = threadIdx.x; i < uparts; i += AF_SCALAR_THREADS) u = __fadd_rn(u, upart[i]);
  for (long long i = threadIdx.x; i < pparts; i += AF_SCALAR_THREADS) p = __fadd_rn(p, ppart[i]);
  us[threadIdx.x] = u;
  ps[threadIdx.x] = p;
  __syncthreads();
  for (int w = 1; w < AF_SCALAR_THREADS; w <<= 1) {
    const int i = threadIdx.x * 2 * w;
    if (i + w < AF_SCALAR_THREADS) {
      us[i] = __fadd_rn(us[i], us[i + w]);
      ps[i] = __fadd_rn(ps[i], ps[i + w]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float lr = *lr_p;
    const float rms_u = __fsqrt_rn(__fadd_rn(__fdiv_rn(us[0], N), sc.eps1));
    const float scale = clamp_min(__fsqrt_rn(__fdiv_rn(ps[0], N)), sc.eps2);
    scal[0] = clamp_min(__fdiv_rn(rms_u, sc.clip), 1.f);
    scal[1] = __fmul_rn(lr, scale);
    scal[2] = __fmul_rn(lr, sc.wd);
  }
}

// ---------------------------------------------------------------------------
// the C entry
// ---------------------------------------------------------------------------

struct AfLaunch {
  AfLayers lay;
  AfShape sh;
  AfScalars sc;
  float *v, *vc, *ws;
  const float *lr, *beta2;
  long long parts;     // partial sums of p^2: slabs of (a), or blocks of af_v_kernel
  long long uparts;    // of u^2: slabs of (b), or blocks of af_v_kernel
  int grid, grid2;     // blocks of (a); of (b) and (c)
  cudaStream_t stream;
};

// The workspace's parts, in floats: scalars (4), vr means (M), p^2 partials
// (M S), u^2 partials (M S2), then for S > 1 vr's slab sums (M S) and the
// column partials (M S x C).
template <typename TG, typename TP, int VEC>
static cudaError_t run_factored(const AfLaunch& a) {
  float* scal = a.ws;
  float* rmean = scal + 4;
  float* ppart = rmean + a.sh.M;
  float* upart = ppart + a.parts;
  float* vrpart = upart + a.uparts;
  float* colpart = vrpart + a.parts;
  af_stats_kernel<TG, TP, VEC><<<a.grid, AF_THREADS, 0, a.stream>>>(
      a.lay, a.sh, a.v, a.vc, colpart, vrpart, rmean, ppart, a.beta2, a.sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.sh.S > 1) {
    const long long work = a.sh.M * ((a.sh.C + AF_THREADS - 1) / AF_THREADS);
    const int grid = (int)min(work, (long long)a.grid * 4);
    af_cols_kernel<<<grid, AF_THREADS, 0, a.stream>>>(a.sh, a.vc, colpart, vrpart, rmean,
                                                       a.beta2, a.sc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  af_usq_kernel<TG, VEC><<<a.grid2, AF_THREADS, 0, a.stream>>>(a.lay, a.sh, a.v, a.vc, rmean,
                                                              upart, a.sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  af_scalars_kernel<<<1, AF_SCALAR_THREADS, 0, a.stream>>>(upart, a.uparts, ppart, a.parts,
                                                           a.sh.N, scal, a.lr, a.sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  af_apply_kernel<TG, TP, VEC><<<a.grid2, AF_THREADS, 0, a.stream>>>(a.lay, a.sh, a.v, a.vc,
                                                                     rmean, scal, a.sc);
  return cudaGetLastError();
}

// The workspace's parts: scalars (4), u^2 and p^2 partials (one a block).
template <typename TG, typename TP, int VEC>
static cudaError_t run_plain(const AfLaunch& a, long long total) {
  float* scal = a.ws;
  float* ppart = scal + 4;
  float* upart = ppart + a.parts;
  af_v_kernel<TG, TP, VEC><<<a.grid, AF_THREADS, 0, a.stream>>>(a.lay, a.sh, total, a.v, upart,
                                                               ppart, a.beta2, a.sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  af_scalars_kernel<<<1, AF_SCALAR_THREADS, 0, a.stream>>>(upart, a.uparts, ppart, a.parts,
                                                           a.sh.N, scal, a.lr, a.sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  af_vapply_kernel<TG, TP, VEC><<<a.grid, AF_THREADS, 0, a.stream>>>(a.lay, a.sh, total, a.v,
                                                                     scal, a.sc);
  return cudaGetLastError();
}

template <typename TG, typename TP>
static cudaError_t run_types(const AfLaunch& a, int factored, int vec, long long total) {
  if (factored) {
    if (vec == 1) return run_factored<TG, TP, 1>(a);
    if (vec == 4) return run_factored<TG, TP, 4>(a);
    if constexpr (sizeof(TG) == 2 && sizeof(TP) == 2)
      if (vec == 8) return run_factored<TG, TP, 8>(a);
    return cudaErrorInvalidValue;
  }
  if (vec == 1) return run_plain<TG, TP, 1>(a, total);
  if (vec == 4) return run_plain<TG, TP, 4>(a, total);
  return cudaErrorInvalidValue;
}

// g_ptrs, p_ptrs: the group's `layers` layers of n elements each (g of
// g_dtype, p of p_dtype: g in p's dtype, or fp32 g for bf16 p as gradient
// accumulation gives it), contiguous.  Factored (M matrices of R x C, n a
// multiple of C): v = vr (M R floats), vc (M C floats), slab_rows rows a
// slab of (a), `slabs` a matrix, on `grid` blocks; slab_rows2, slabs2 and
// grid2 those of (b) and (c); else v (layers x n floats), vc unused, and
// `grid` blocks walk the elements.  ws: the workspace (kernels/adafactor.py
// `launch_plan`).  lr, beta2: one fp32 each
// in device memory.  vec: elements a thread loads at once (8: bf16 g and p
// aligned to 16 bytes; 4: aligned to four elements; 1).  `grid` blocks of
// 256 threads walk the slabs (or the elements).  Launches the passes on
// `stream` and returns cudaGetLastError().
extern "C" int adafactor_launch(const void* const* g_ptrs, void* const* p_ptrs, int layers,
                                long long n, long long M, long long R, long long C, int factored,
                                int slab_rows, int slabs, int grid, int slab_rows2, int slabs2,
                                int grid2, int vec, int p_dtype,
                                int g_dtype, float* v, float* vc, float* ws, const float* lr,
                                const float* beta2, float eps1, float eps2, float clip, float wd,
                                void* stream) {
  if (layers < 1 || layers > AF_MAX_LAYERS || n <= 0 || grid < 1) return (int)cudaErrorInvalidValue;
  if (factored && (C <= 0 || R <= 0 || M <= 0 || n % C != 0 || slab_rows < 1
                   || (n / C != 1 && (n / C) % R != 0)
                   || slab_rows > AF_MAX_SLAB || (long long)slab_rows * slabs < R
                   || (long long)slab_rows * (slabs - 1) >= R || slab_rows2 < 1
                   || slab_rows2 > AF_MAX_SLAB || (long long)slab_rows2 * slabs2 < R
                   || (long long)slab_rows2 * (slabs2 - 1) >= R || grid2 < 1))
    return (int)cudaErrorInvalidValue;
  AfLaunch a;
  for (int i = 0; i < layers; ++i) {
    a.lay.g[i] = g_ptrs[i];
    a.lay.p[i] = p_ptrs[i];
  }
  for (int i = layers; i < AF_MAX_LAYERS; ++i) {
    a.lay.g[i] = nullptr;
    a.lay.p[i] = nullptr;
  }
  const long long total = (long long)layers * n;
  a.sh.n = n;
  a.sh.rpl = factored ? n / C : 0;
  a.sh.M = M;
  a.sh.R = R;
  a.sh.C = C;
  a.sh.SR = slab_rows;
  a.sh.S = slabs;
  a.sh.slabs = factored ? M * slabs : 0;
  a.sh.SR2 = slab_rows2;
  a.sh.S2 = slabs2;
  a.sh.slabs2 = factored ? M * slabs2 : 0;
  a.sh.N = (float)total;
  a.sc = AfScalars{eps1, eps2, clip, wd};
  a.v = v;
  a.vc = vc;
  a.ws = ws;
  a.lr = lr;
  a.beta2 = beta2;
  a.parts = factored ? M * slabs : grid;
  a.uparts = factored ? M * slabs2 : grid;
  a.grid = grid;
  a.grid2 = factored ? grid2 : grid;
  a.stream = (cudaStream_t)stream;
  if (g_dtype == DT_BF16 && p_dtype == DT_BF16)
    return (int)run_types<__nv_bfloat16, __nv_bfloat16>(a, factored, vec, total);
  if (g_dtype == DT_F32 && p_dtype == DT_F32)
    return (int)run_types<float, float>(a, factored, vec, total);
  if (g_dtype == DT_F32 && p_dtype == DT_BF16)
    return (int)run_types<float, __nv_bfloat16>(a, factored, vec, total);
  return (int)cudaErrorInvalidValue;
}
