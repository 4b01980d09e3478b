// Split-KV single-token attention (flash-decode) with the combine of its
// splits fused in.
//
// Replaces the TPU kernel `_decode_kernel` of src/repro/kernels/decode_attention.py
// and the array code that merges its partial results (`decode_attention`,
// the lines after the pallas_call).
//
// On this card the function is bound by bytes: every valid K and V row is
// read once for 4*G*D operations (G <= 16 q heads a kv head), far below the
// card's operations-per-byte ridge.  So the CUDA cores do the arithmetic (no
// tensor core is needed) and the design is about keeping bytes in flight:
//   * 16-byte loads: a row of D elements is read by D*size/16 lanes (16 lanes
//     for bf16 at D = 128, so one load instruction of a warp covers 2 rows);
//   * each lane issues the K and V loads of NI rows (4 for one vector a row)
//     before it uses any of them, and the loads of the next NI rows before
//     it uses these, then computes the NI x G scores (the dot of a row is
//     summed over its lanes by xor shuffles) and makes ONE online-softmax
//     update a head for those rows;
//   * the wrapper cuts T into splits so that B*HB*splits blocks (HB head
//     blocks: Hkv, or 2*Hkv where a group is split, below) fill the
//     card once at this kernel's measured occupancy, each split a whole
//     number of the block's iterations;
//   * the kernel is instantiated for each group size G, so registers hold
//     exactly G heads;
//   * a group of 16 (recurrentgemma's MQA, G = 16 at D = 256) is split over
//     two blocks of 8 heads (`heads_a_block`): 16 heads would need 64 KB of
//     static shared memory for the block's merge (48 KB is the static limit)
//     and 256 registers a thread for q and the accumulators alone.  Each of
//     the two blocks reads the kv head's rows; they run side by side, so the
//     second read is mostly served by L2.  The combine is keyed on the
//     (batch, head block), so the 8-head kernel runs unchanged.
// The cache is read where it lies through strides (the model keeps it as
// (B,T,Hkv,D); no transposed copy), and rows at or past kv_valid_len[b],
// which stays on the device, are never read.
//
// The combine is fused: every block writes its partial (acc, m, l) to
// scratch, and the last block of a (b, head block) to finish, found by an atomic
// counter after a __threadfence, merges the splits, writes the output in q's
// dtype and resets the counter to 0 for the next launch.  With one split the
// block writes the output directly.  One launch a layer a decode step.
#include "common.cuh"

#define DEC_WARPS 4
#define DEC_THREADS (32 * DEC_WARPS)

// Rows one lane keeps in flight, per (element size, D); mirrored by
// kernels/decode_attention.py `rows_per_iter`.
template <typename T, int D> struct DecPlan {
  static constexpr int VEC = 16 / (int)sizeof(T);        // elements a 16-byte load
  static constexpr int LPR = D / VEC < 32 ? D / VEC : 32;  // lanes a row
  static constexpr int RPW = 32 / LPR;                   // rows a warp-wide load
  static constexpr int NV = D / (VEC * LPR);             // loads a lane a row
  static constexpr int NI = 4 / NV;                      // rows a lane an iteration
  static constexpr int EPL = NV * VEC;                   // elements a lane a row
  static constexpr int ROWS_WARP = NI * RPW;
  static constexpr int ROWS_ITER = ROWS_WARP * DEC_WARPS;  // rows a block an iteration
  static constexpr int STREAMS = DEC_WARPS * RPW;        // softmax states a block
};

struct DecodeParams {
  const void* q; const void* k; const void* v; const int* valid; void* out;
  float* part_acc; float* part_m; float* part_l; int* counter;
  int H, Hkv, T, ns, chunk;
  int blocks_a_kv_head;   // gridDim.y / Hkv: 2 where a group of 16 is split, else 1
  long long k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  float scale_log2;   // softmax scale * log2(e)
};

template <typename T> __device__ __forceinline__ void unpack16(const uint4& r, float* f);
template <> __device__ __forceinline__ void unpack16<float>(const uint4& r, float* f) {
  f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& r, float* f) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);              // element 2i: the low half
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int G, int D>
__global__ void __launch_bounds__(DEC_THREADS) decode_kernel(const DecodeParams p) {
  using P = DecPlan<T, D>;
  constexpr int VEC = P::VEC, LPR = P::LPR, RPW = P::RPW, NV = P::NV, NI = P::NI, EPL = P::EPL;
  constexpr int NS = P::STREAMS;
  __shared__ float s_m[NS * G], s_l[NS * G];
  __shared__ __align__(16) float s_acc[NS * G * D];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / LPR, lir = lane % LPR;   // row of the warp-wide load, lane in the row
  // blockIdx.y is the head block: the G q heads hy*G .. hy*G+G-1, all of kv
  // head hy / blocks_a_kv_head
  const int split = blockIdx.x, hy = blockIdx.y, b = blockIdx.z;
  const int hk = hy / p.blocks_a_kv_head;

  // The G q heads of this block, pre-scaled so that a dot is a log2 score.
  float qf[G][EPL];
  const T* qp = (const T*)p.q + ((long long)b * p.H + (long long)hy * G) * D;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      unpack16<T>(__ldg(reinterpret_cast<const uint4*>(qp + g * D + (v * LPR + lir) * VEC)),
                  &qf[g][v * VEC]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qf[g][v * VEC + e] *= p.scale_log2;
    }

  float acc[G][EPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = MAX_FLOOR;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const int t0 = split * p.chunk;
  const int t1 = min(min(t0 + p.chunk, p.T), p.valid[b]);
  const T* kp = (const T*)p.k + b * p.k_sb + hk * p.k_sh;
  const T* vp = (const T*)p.v + b * p.v_sb + hk * p.v_sh;

  // This warp's rows of an iteration, as raw 16-byte vectors (zeros past t1).
  auto fetch = [&](int base, uint4 (&kd)[NI][NV], uint4 (&vd)[NI][NV]) {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int t = base + i * RPW + sub;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int off = (v * LPR + lir) * VEC;
        if (t < t1) {
          kd[i][v] = __ldg(reinterpret_cast<const uint4*>(kp + (long long)t * p.k_st + off));
          vd[i][v] = __ldg(reinterpret_cast<const uint4*>(vp + (long long)t * p.v_st + off));
        } else {
          kd[i][v] = make_uint4(0u, 0u, 0u, 0u);
          vd[i][v] = kd[i][v];
        }
      }
    }
  };

  uint4 kr[NI][NV], vr[NI][NV];
  int base = t0 + warp * P::ROWS_WARP;
  fetch(base, kr, vr);
  for (; base < t1; base += P::ROWS_ITER) {
    // The next iteration's loads go out before this one's rows are used, so
    // a warp keeps two iterations of rows in flight.
    uint4 kn[NI][NV], vn[NI][NV];
    fetch(base + P::ROWS_ITER, kn, vn);
    // ... then the NI x G scores, each summed over the LPR lanes of its row ...
    float sc[NI][G];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float kf[EPL];
#pragma unroll
      for (int v = 0; v < NV; ++v) unpack16<T>(kr[i][v], &kf[v * VEC]);
      const bool ok = base + i * RPW + sub < t1;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qf[g][e], kf[e], dot);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        sc[i][g] = ok ? dot : -INFINITY;
      }
    }
    // ... and one online-softmax update a head for the NI rows.
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = sc[0][g];
#pragma unroll
      for (int i = 1; i < NI; ++i) mx = fmaxf(mx, sc[i][g]);
      const float mn = fmaxf(m[g], mx);   // >= MAX_FLOOR: finite
      const float corr = fast_exp2(m[g] - mn);
      m[g] = mn;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        sc[i][g] = fast_exp2(sc[i][g] - mn);   // a masked row gives exactly 0
        sum += sc[i][g];
      }
      l[g] = l[g] * corr + sum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float vf[EPL];
#pragma unroll
      for (int v = 0; v < NV; ++v) unpack16<T>(vr[i][v], &vf[v * VEC]);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(sc[i][g], vf[e], acc[g][e]);
    }
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        kr[i][v] = kn[i][v];
        vr[i][v] = vn[i][v];
      }
  }

  // Merge the block's softmax states (one per warp and row of a warp-wide load).
  const int st = warp * RPW + sub;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lir == 0) { s_m[st * G + g] = m[g]; s_l[st * G + g] = l[g]; }
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        s_acc[(st * G + g) * D + (v * LPR + lir) * VEC + e] = acc[g][v * VEC + e];
  }
  __syncthreads();

  const long long bh = (long long)b * gridDim.y + hy;   // (batch, head block)
  T* out = (T*)p.out + (bh * G) * D;            // (G, D) rows of this head block
  const long long part = bh * p.ns + split;     // index over (B, head blocks, ns)
  for (int idx = tid; idx < G * D; idx += DEC_THREADS) {
    const int g = idx / D, d = idx % D;
    float mm = MAX_FLOOR;
#pragma unroll
    for (int s = 0; s < NS; ++s) mm = fmaxf(mm, s_m[s * G + g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float w = fast_exp2(s_m[s * G + g] - mm);
      ll += s_l[s * G + g] * w;
      aa += s_acc[(s * G + g) * D + d] * w;
    }
    if (p.ns == 1) {
      out[idx] = from_float<T>(aa / fmaxf(ll, 1e-30f));
    } else {
      p.part_acc[(part * G + g) * D + d] = aa;
      if (d == 0) { p.part_m[part * G + g] = mm; p.part_l[part * G + g] = ll; }
    }
  }
  if (p.ns == 1) return;

  // The last block of this (b, head block) to finish merges the splits.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&p.counter[bh], 1) == p.ns - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long part0 = bh * p.ns;
  for (int idx = tid; idx < G * D; idx += DEC_THREADS) {
    const int g = idx / D, d = idx % D;
    float mm = MAX_FLOOR;
    for (int s = 0; s < p.ns; ++s) mm = fmaxf(mm, __ldcg(&p.part_m[(part0 + s) * G + g]));
    float ll = 0.f, aa = 0.f;
    for (int s = 0; s < p.ns; ++s) {
      const long long i = (part0 + s) * G + g;
      const float w = fast_exp2(__ldcg(&p.part_m[i]) - mm);
      ll += __ldcg(&p.part_l[i]) * w;
      aa += __ldcg(&p.part_acc[i * D + d]) * w;
    }
    out[idx] = from_float<T>(aa / fmaxf(ll, 1e-30f));
  }
  if (tid == 0) p.counter[bh] = 0;   // ready for the next launch
}

// ---- dispatch --------------------------------------------------------------

template <typename T, int G>
static const void* kernel_for_d(int D) {
  switch (D) {
    case 64: return (const void*)decode_kernel<T, G, 64>;
    case 128: return (const void*)decode_kernel<T, G, 128>;
    case 256: return (const void*)decode_kernel<T, G, 256>;
    default: return nullptr;
  }
}

// Q heads a block for a group of G: 8 for a group of 16, split over two
// blocks; else the whole group.  Mirrored by kernels/decode_attention.py
// `heads_a_block`.
static int heads_a_block(int G) { return G == 16 ? 8 : G; }

// The heads a block of the supported models (gemma-7b 1, phi4-mini 3,
// qwen2.5-32b 5, yi-34b 7, recurrentgemma-9b's 16 as two blocks of 8) and 2
// for the edge cases.
template <typename T>
static const void* kernel_for_g(int G, int D) {
  switch (G) {
    case 1: return kernel_for_d<T, 1>(D);
    case 2: return kernel_for_d<T, 2>(D);
    case 3: return kernel_for_d<T, 3>(D);
    case 5: return kernel_for_d<T, 5>(D);
    case 7: return kernel_for_d<T, 7>(D);
    case 8: return kernel_for_d<T, 8>(D);
    default: return nullptr;
  }
}

// The kernel for a group of G q heads a kv head (instantiated for the heads
// a block of that group).
static const void* find_kernel(int dtype, int G, int D) {
  const int gb = heads_a_block(G);
  if (dtype == DT_F32) return kernel_for_g<float>(gb, D);
  if (dtype == DT_BF16) return kernel_for_g<__nv_bfloat16>(gb, D);
  return nullptr;
}

static int rows_per_iter(int dtype, int D) {
  if (dtype == DT_F32) {
    switch (D) {
      case 64: return DecPlan<float, 64>::ROWS_ITER;
      case 128: return DecPlan<float, 128>::ROWS_ITER;
      case 256: return DecPlan<float, 256>::ROWS_ITER;
    }
  } else if (dtype == DT_BF16) {
    switch (D) {
      case 64: return DecPlan<__nv_bfloat16, 64>::ROWS_ITER;
      case 128: return DecPlan<__nv_bfloat16, 128>::ROWS_ITER;
      case 256: return DecPlan<__nv_bfloat16, 256>::ROWS_ITER;
    }
  }
  return 0;
}

// Q heads a block for a group of G (0 where no kernel takes G).
extern "C" int decode_attention_heads_a_block(int G) {
  return find_kernel(DT_BF16, G, 64) == nullptr ? 0 : heads_a_block(G);
}

// For (G, D, dtype) on the current device: out[0] = resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] = rows a block
// reads an iteration, out[2] = threads a block.  Returns a CUDA error code.
extern "C" int decode_attention_plan(int G, int D, int dtype, int* out) {
  const void* fn = find_kernel(dtype, G, D);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, DEC_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = rows_per_iter(dtype, D);
  out[2] = DEC_THREADS;
  return 0;
}

// q (B,H,D) contiguous; k/v (B,Hkv,T,D) with strides in elements over their
// first three dims and stride 1 over D, every row 16-byte aligned; valid (B,)
// int32; out (B,H,D) contiguous of `dtype`.  With HB = H / heads_a_block(G)
// head blocks (Hkv unless a group is split), scratch: part_acc
// (B,HB,ns,H/HB,D), part_m and part_l (B,HB,ns,H/HB) fp32, counter (B*HB)
// int32 that must be 0 (the kernel leaves it 0).  Split s covers rows
// [s*chunk, (s+1)*chunk).  Returns cudaGetLastError().
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* valid, void* out, void* part_acc,
    void* part_m, void* part_l, void* counter, int B, int H, int Hkv, int T, int D, int ns,
    int chunk, long long k_sb, long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (Hkv <= 0 || H % Hkv) return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  const void* fn = find_kernel(dtype, G, D);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const int per_kv = G / heads_a_block(G);
  DecodeParams p;
  p.q = q; p.k = k; p.v = v; p.valid = (const int*)valid; p.out = out;
  p.part_acc = (float*)part_acc; p.part_m = (float*)part_m; p.part_l = (float*)part_l;
  p.counter = (int*)counter;
  p.H = H; p.Hkv = Hkv; p.T = T; p.ns = ns; p.chunk = chunk;
  p.blocks_a_kv_head = per_kv;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.scale_log2 = scale * 1.4426950408889634f;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchKernel(fn, dim3(ns, Hkv * per_kv, B), dim3(DEC_THREADS), args, 0,
                                         (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
