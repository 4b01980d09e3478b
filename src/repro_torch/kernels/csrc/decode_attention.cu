// Split-KV single-token attention (flash-decode) with the combine of its
// splits fused in.
//
// Replaces the TPU kernel `_decode_kernel` of src/repro/kernels/decode_attention.py
// and the array code that merges its partial results (`decode_attention`,
// the lines after the pallas_call).
//
// On this card the function is bound by bytes: every valid K and V row is
// read once for 4*G*D operations (G <= 16 q heads a kv head), far below the
// card's operations-per-byte ridge.  The design is about keeping bytes in
// flight on enough SMs, and keeping the splits' partial results small
// beside the rows they read.  Two kernels, one launch a call either way:
//
//   * bf16 with a group of 5, 7, 8 or 16 (qwen2.5-32b, qwen2-vl and yi-34b,
//     recurrentgemma's MQA): `decode_tc_kernel`, one block a (batch, kv
//     head, split) holding the whole group.
//       - The group is padded to the 16 rows of `mma.sync.m16n8k16` (bf16 in,
//         fp32 out).  S = Q K^T runs on the tensor cores with Q's A fragments
//         in registers for the whole block and K's B fragments from shared
//         memory by `ldmatrix`; padded rows are computed and never written.
//         The tensor cores are there to take the per-head scalar state out
//         of each lane's registers, not for their rate.
//       - The 4 warps split D: a warp holds Q's fragments of its D/4 columns
//         (16 registers a thread at D 256), computes S over those columns of
//         the depth and hands its part to the others through shared memory;
//         each warp sums the four parts in warp order, so all hold the same S
//         and make the same softmax, and then computes P V for the D/4
//         columns of O it owns (the fp32 O of 16 x D split over the warps: 32
//         registers a thread at D 256).  The kv head's rows are read once (an
//         fp32 group of 16 is two blocks of 8 heads, each reading them).
//       - P enters P V as two bf16 products, its bf16 rounding and the
//         remainder, so P is carried to about 16 bits and V (bf16) exactly:
//         the error of a one-term bf16 P (2^-9 relative) does not reach the
//         output.
//       - K and V reach shared memory by `cp.async` (16 bytes, .cg) in a
//         ring of TC_STAGES stages of 32 rows (16 KB of K and 16 KB of V at D
//         256), read through the cache's strides; the loads of the next
//         stages are in flight while a stage is used.  Two blocks an SM at D
//         256, three at D 128.
//   * fp32 at every group, and bf16 at a group of 1, 2 or 3: `decode_kernel`
//     on the CUDA cores, one block a (batch, head block, split):
//       - 16-byte loads: a row of D elements is read by D*size/16 lanes;
//         each lane issues the K and V loads of NI rows before it uses any of
//         them, and the loads of the next NI rows before it uses these, then
//         computes the NI x G scores (summed over the row's lanes by xor
//         shuffles) and makes ONE online-softmax update a head for them;
//       - the kernel is instantiated for each group size, so registers hold
//         exactly G heads; a group of 16 in fp32 runs as two blocks of 8
//         heads a kv head (`heads_a_block`), whose registers and static
//         shared memory the 8-head kernel fits.
//
// Splits (`split_plan`, mirrored by kernels/decode_attention.py): as many
// as fill the card once at the kernel's measured occupancy, but no split
// under SPLIT_FLOOR rows and no more than MAX_SPLITS, each a whole number of
// the kernel's rows an iteration (or a ring stage).  Without the floor a
// single sequence (B1) took one split a few rows wide on every block the
// card holds (128 splits of 16 rows at recurrentgemma's B1 D 256), whose
// fp32 partials were as many bytes as the cache and took one block 0.20 ms
// to merge.  The floor keeps a split's partial (G*D*4 bytes) a small share
// of the K and V rows it reads (chunk*D*2 bytes each).
//
// The cache is read where it lies through strides (the model keeps it as
// (B,T,Hkv,D); no transposed copy), and rows at or past kv_valid_len[b],
// which stays on the device, are never read.
//
// The combine is fused: every block writes its partial (acc, m, l) to
// scratch, and the last block of a (b, head block) to finish, found by an
// atomic counter after a __threadfence, merges the splits (`merge_splits`):
// each (head, split) weight once into shared memory, then every thread sums
// its (head, 4 columns) over the splits in split order, with the loads of
// several splits in flight (a second run gives the same bits).  It writes
// the output in q's dtype and resets the counter to 0 for the next launch.
// With one split the block writes the output directly.  One block merges:
// spreading the merge over a cluster's blocks (distributed shared memory,
// then the last cluster) measured no faster at the floor's plans, because
// its barriers and the splits padded to whole clusters cost what the spread
// saved.
#include "common.cuh"

#define DEC_WARPS 4
#define DEC_THREADS (32 * DEC_WARPS)
#define TC_STAGES 3        // ring stages of the tensor-core kernel
// Least rows a split, and most splits a (batch, head block); mirrored by
// kernels/decode_attention.py `SPLIT_FLOOR` and `MAX_SPLITS`.
#define SPLIT_FLOOR 128
#define MAX_SPLITS 256

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

// The tensor-core kernel's tiles at head dim D; ROWS is mirrored by
// kernels/decode_attention.py `STAGE_ROWS`.
template <int D> struct TcPlan {
  static constexpr int ROWS = 32;                   // kv rows a ring stage
  static constexpr int LD = D + 8;                  // a row in shared memory, padded 16 bytes:
                                                    // ldmatrix's 8 rows hit 8 bank groups
  static constexpr int TILE = ROWS * LD;            // elements of a stage's K (or V)
  static constexpr int RING = TC_STAGES * 2 * TILE * 2;   // bytes of the ring
  static constexpr int NT_S = ROWS / 8;             // n tiles of a stage's scores
  static constexpr int SRED = DEC_WARPS * NT_S * 32 * 16;  // bytes: each warp's part of S
  static constexpr int SMEM = RING + SRED;          // dynamic shared memory of a block
  static constexpr int DW = D / DEC_WARPS;          // columns of Q and K, and of O, a warp owns
  static constexpr int NT_O = DW / 8;               // O's n tiles of 8 a warp
  static constexpr int KS_W = DW / 16;              // k steps of a warp's part of Q K^T
  static constexpr int KS_P = ROWS / 16;            // k steps of P V
  static constexpr int CPR = D / 8;                 // 16-byte chunks a row
};

struct DecodeParams {
  const void* q; const void* k; const void* v; const int* valid; void* out;
  float* part_acc; float* part_m; float* part_l; int* counter;
  int H, Hkv, T, ns, chunk;
  int blocks_a_kv_head;   // gridDim.y / Hkv: 2 where an fp32 group of 16 is split, else 1
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Four consecutive outputs in T's type.
__device__ __forceinline__ void store4(float* p, float4 a) {
  *reinterpret_cast<float4*>(p) = a;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 a) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a.x, a.y), hi = __floats2bfloat162_rn(a.z, a.w);
  uint2 r;
  r.x = *reinterpret_cast<const uint32_t*>(&lo);
  r.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = r;
}

// The last block of (batch, head block) `bh` merges its splits' partials
// into `out` (the block's G rows of D).  `w`: shared memory for ns*G floats.
// Each (head, split) weight 2^(m - max m) / sum_s l 2^(m - max m) is made
// once, by a warp a head; then every thread sums its (head, 4 columns) over
// the splits in split order.  The loads of U splits' partials (INFLIGHT
// 16-byte loads a thread) are kept in flight, the first U while the weights
// are made, each slot refilled with the split U further on as soon as it is
// summed.
template <typename T, int G, int D, int INFLIGHT>
__device__ __forceinline__ void merge_splits(const DecodeParams& p, long long bh, float* w, T* out) {
  constexpr int C4 = D / 4, N4 = G * C4, NO = (N4 + DEC_THREADS - 1) / DEC_THREADS;
  constexpr int U = NO >= INFLIGHT ? 1 : INFLIGHT / NO;
  constexpr int MJ = MAX_SPLITS / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long part0 = bh * p.ns;
  const float4* src = reinterpret_cast<const float4*>(p.part_acc) + part0 * N4;
  auto mine = [&](int j) { return N4 % DEC_THREADS == 0 || tid + j * DEC_THREADS < N4; };
  float4 x[U][NO];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int j = 0; j < NO; ++j)
      if (mine(j) && u < p.ns) x[u][j] = __ldcg(src + (long long)u * N4 + tid + j * DEC_THREADS);
  for (int g = warp; g < G; g += DEC_WARPS) {
    float mv[MJ], lv[MJ], mm = MAX_FLOOR;
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int s = lane + 32 * j;
      mv[j] = MAX_FLOOR;
      lv[j] = 0.f;
      if (s < p.ns) {
        mv[j] = __ldcg(&p.part_m[(part0 + s) * G + g]);
        lv[j] = __ldcg(&p.part_l[(part0 + s) * G + g]);
      }
      mm = fmaxf(mm, mv[j]);
    }
    mm = warp_max(mm);
    float ll = 0.f;
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      mv[j] = fast_exp2(mv[j] - mm);
      ll += lv[j] * mv[j];
    }
    const float inv = 1.f / fmaxf(warp_sum(ll), 1e-30f);
#pragma unroll
    for (int j = 0; j < MJ; ++j)
      if (lane + 32 * j < p.ns) w[(lane + 32 * j) * G + g] = mv[j] * inv;
  }
  __syncthreads();
  float4 a[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < p.ns; s0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int idx = tid + j * DEC_THREADS;
        if (mine(j) && s0 + u < p.ns) {
          const float ww = w[(s0 + u) * G + idx / C4];
          a[j].x = fmaf(ww, x[u][j].x, a[j].x);
          a[j].y = fmaf(ww, x[u][j].y, a[j].y);
          a[j].z = fmaf(ww, x[u][j].z, a[j].z);
          a[j].w = fmaf(ww, x[u][j].w, a[j].w);
        }
        if (mine(j) && s0 + U + u < p.ns)
          x[u][j] = __ldcg(src + (long long)(s0 + U + u) * N4 + idx);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int idx = tid + j * DEC_THREADS;
    if (mine(j)) store4(out + (idx / C4) * D + (idx % C4) * 4, a[j]);
  }
  if (tid == 0) p.counter[bh] = 0;   // ready for the next launch
}

// ---- the CUDA-core kernel: fp32, and bf16 at a group of 1-3 ----------------

template <typename T, int G, int D>
__global__ void __launch_bounds__(DEC_THREADS) decode_kernel(const DecodeParams p) {
  using P = DecPlan<T, D>;
  constexpr int VEC = P::VEC, LPR = P::LPR, RPW = P::RPW, NV = P::NV, NI = P::NI, EPL = P::EPL;
  constexpr int NS = P::STREAMS;
  static_assert(NS * D >= MAX_SPLITS, "the merge's weights live in s_acc");
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
  merge_splits<T, G, D, 16>(p, bh, s_acc, out);
}

// ---- the tensor-core kernel: bf16 at a group of 5, 7, 8 or 16 ---------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// d += a b: a 16 x 16 bf16 (4 registers), b 16 x 8 bf16 (2), d 16 x 8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as a bf16 pair, and the pair of what that rounding left out.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

template <int G, int D>
__global__ void __launch_bounds__(DEC_THREADS) decode_tc_kernel(const DecodeParams p) {
  using P = TcPlan<D>;
  static_assert(G <= 16 && P::NT_S % 2 == 0 && P::NT_O % 2 == 0 && P::KS_W >= 1 &&
                (P::ROWS * P::CPR) % DEC_THREADS == 0, "tile shapes");
  static_assert(MAX_SPLITS * 16 * 4 <= P::SMEM, "the merge's weights live in the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float4* sred = reinterpret_cast<float4*>(smem + P::RING);   // (warp, n tile, lane)
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane >> 2, c2 = (lane & 3) * 2;   // a fragment's row (head) and column pair
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int wcol = warp * P::DW;                  // this warp's columns of D

  // Q's A fragments over this warp's columns, the group padded to 16 rows with zeros.
  uint32_t qa[P::KS_W][4];
  const __nv_bfloat16* qp =
      (const __nv_bfloat16*)p.q + ((long long)b * p.H + (long long)hk * G) * D + wcol;
  auto q32 = [&](int g, int col) -> uint32_t {
    return g < G ? __ldg(reinterpret_cast<const unsigned int*>(qp + g * D + col)) : 0u;
  };
#pragma unroll
  for (int ks = 0; ks < P::KS_W; ++ks) {
    qa[ks][0] = q32(r, ks * 16 + c2);
    qa[ks][1] = q32(r + 8, ks * 16 + c2);
    qa[ks][2] = q32(r, ks * 16 + 8 + c2);
    qa[ks][3] = q32(r + 8, ks * 16 + 8 + c2);
  }

  const int t0 = split * p.chunk;
  const int t1 = min(min(t0 + p.chunk, p.T), p.valid[b]);
  const int ntiles = t1 > t0 ? (t1 - t0 + P::ROWS - 1) / P::ROWS : 0;
  const __nv_bfloat16* kp = (const __nv_bfloat16*)p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vp = (const __nv_bfloat16*)p.v + b * p.v_sb + hk * p.v_sh;

  // Stage `it % TC_STAGES` <- rows t0 + it*ROWS ... of K and V (zeros past t1).
  auto load_tile = [&](int it) {
    __nv_bfloat16* ks = ring + (it % TC_STAGES) * 2 * P::TILE;
    __nv_bfloat16* vs = ks + P::TILE;
    const int base = t0 + it * P::ROWS;
#pragma unroll
    for (int j = 0; j < P::ROWS * P::CPR / DEC_THREADS; ++j) {
      const int row = (tid + j * DEC_THREADS) / P::CPR, ch = (tid + j * DEC_THREADS) % P::CPR;
      const bool ok = base + row < t1;
      const long long t = ok ? base + row : 0;
      cp_async16(ks + row * P::LD + ch * 8, kp + t * p.k_st + ch * 8, ok);
      cp_async16(vs + row * P::LD + ch * 8, vp + t * p.v_st + ch * 8, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < ntiles) load_tile(s);
    cp_async_commit();
  }

  float o[P::NT_O][4];   // rows r, r + 8 of this warp's D/4 columns
#pragma unroll
  for (int n = 0; n < P::NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = MAX_FLOOR, m1 = MAX_FLOOR, l0 = 0.f, l1 = 0.f;   // rows r and r + 8; l this lane's

  for (int it = 0; it < ntiles; ++it) {
    if (it + TC_STAGES - 1 < ntiles) load_tile(it + TC_STAGES - 1);
    cp_async_commit();
    cp_async_wait<TC_STAGES - 1>();
    __syncthreads();
    const __nv_bfloat16* ks = ring + (it % TC_STAGES) * 2 * P::TILE;
    const __nv_bfloat16* vs = ks + P::TILE;

    // This warp's part of S = Q K^T (its D/4 columns of the depth), to shared
    // memory; then each warp sums the four parts in warp order, so every warp
    // holds the same S.
    float s[P::NT_S][4];
#pragma unroll
    for (int n = 0; n < P::NT_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < P::KS_W; ++kk)
#pragma unroll
      for (int n = 0; n < P::NT_S; n += 2) {
        uint32_t kb[4];   // rows of n tiles n and n + 1, 16 columns of the depth
        ldmatrix_x4(kb, ks + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * P::LD + wcol +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[n], qa[kk], kb[0], kb[1]);
        mma_bf16(s[n + 1], qa[kk], kb[2], kb[3]);
      }
#pragma unroll
    for (int n = 0; n < P::NT_S; ++n)
      sred[(warp * P::NT_S + n) * 32 + lane] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < P::NT_S; ++n) {
      float4 t = sred[n * 32 + lane];
#pragma unroll
      for (int w2 = 1; w2 < DEC_WARPS; ++w2) {
        const float4 u = sred[(w2 * P::NT_S + n) * 32 + lane];
        t.x += u.x; t.y += u.y; t.z += u.z; t.w += u.w;
      }
      s[n][0] = t.x; s[n][1] = t.y; s[n][2] = t.z; s[n][3] = t.w;
    }

    // In log2 units, masked past t1; the online softmax of rows r and r + 8.
    const int base = t0 + it * P::ROWS;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < P::NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = base + n * 8 + c2 + e < t1;
        s[n][e] = ok ? s[n][e] * p.scale_log2 : -INFINITY;
        s[n][2 + e] = ok ? s[n][2 + e] * p.scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {   // over the 4 lanes of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);   // >= MAX_FLOOR: finite
    const float corr0 = fast_exp2(m0 - mn0), corr1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < P::NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = fast_exp2(s[n][e] - mn0);   // a masked row gives exactly 0
        s[n][2 + e] = fast_exp2(s[n][2 + e] - mn1);
        sum0 += s[n][e];
        sum1 += s[n][2 + e];
      }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int n = 0; n < P::NT_O; ++n) {
      o[n][0] *= corr0; o[n][1] *= corr0;
      o[n][2] *= corr1; o[n][3] *= corr1;
    }

    // O += P V over this warp's columns, P as its bf16 rounding plus the remainder.
#pragma unroll
    for (int kk = 0; kk < P::KS_P; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16x2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16x2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < P::NT_O; n += 2) {
        uint32_t vb[4];   // rows kk*16 .. +15, columns of n tiles n and n + 1
        ldmatrix_x4_trans(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P::LD +
                                  wcol + n * 8 + (lane >> 4) * 8);
        mma_bf16(o[n], ph, vb[0], vb[1]);
        mma_bf16(o[n], pl, vb[0], vb[1]);
        mma_bf16(o[n + 1], ph, vb[2], vb[3]);
        mma_bf16(o[n + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();   // the stage and the parts of S are written again in the next iteration
  }
  cp_async_wait<0>();
#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }

  const long long bh = (long long)b * p.Hkv + hk;   // (batch, kv head)
  __nv_bfloat16* out = (__nv_bfloat16*)p.out + bh * G * D;
  const int col0 = wcol + c2;
  if (p.ns == 1) {
    const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int n = 0; n < P::NT_O; ++n) {
      if (r < G)
        *reinterpret_cast<__nv_bfloat162*>(out + r * D + col0 + n * 8) =
            __floats2bfloat162_rn(o[n][0] * i0, o[n][1] * i0);
      if (r + 8 < G)
        *reinterpret_cast<__nv_bfloat162*>(out + (r + 8) * D + col0 + n * 8) =
            __floats2bfloat162_rn(o[n][2] * i1, o[n][3] * i1);
    }
    return;
  }

  const long long part = bh * p.ns + split;
  float* pa = p.part_acc + part * G * D;
#pragma unroll
  for (int n = 0; n < P::NT_O; ++n) {
    if (r < G) *reinterpret_cast<float2*>(pa + r * D + col0 + n * 8) = make_float2(o[n][0], o[n][1]);
    if (r + 8 < G)
      *reinterpret_cast<float2*>(pa + (r + 8) * D + col0 + n * 8) = make_float2(o[n][2], o[n][3]);
  }
  if (warp == 0 && (lane & 3) == 0) {
    if (r < G) { p.part_m[part * G + r] = m0; p.part_l[part * G + r] = l0; }
    if (r + 8 < G) { p.part_m[part * G + r + 8] = m1; p.part_l[part * G + r + 8] = l1; }
  }

  // The last block of this (b, kv head) to finish merges the splits.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&p.counter[bh], 1) == p.ns - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // two blocks an SM at D 256 leave room for 32 loads in flight a thread
  merge_splits<__nv_bfloat16, G, D, D >= 256 ? 32 : 16>(p, bh, reinterpret_cast<float*>(smem), out);
}

// ---- dispatch --------------------------------------------------------------

// Which kernel a (dtype, G) takes: the tensor-core one for bf16 at a group of
// 5, 7, 8 or 16.  Mirrored by kernels/decode_attention.py `kernel_path`.
static bool tc_path(int dtype, int G) {
  return dtype == DT_BF16 && (G == 5 || G == 7 || G == 8 || G == 16);
}

// Q heads a block for a group of G: the whole group, but 8 for an fp32 group
// of 16, split over two blocks.  Mirrored by kernels/decode_attention.py
// `heads_a_block`.
static int heads_a_block(int dtype, int G) { return G == 16 && !tc_path(dtype, G) ? 8 : G; }

template <typename T, int G>
static const void* kernel_for_d(int D) {
  switch (D) {
    case 64: return (const void*)decode_kernel<T, G, 64>;
    case 128: return (const void*)decode_kernel<T, G, 128>;
    case 256: return (const void*)decode_kernel<T, G, 256>;
    default: return nullptr;
  }
}

template <int G>
static const void* tc_kernel_for_d(int D) {
  switch (D) {
    case 64: return (const void*)decode_tc_kernel<G, 64>;
    case 128: return (const void*)decode_tc_kernel<G, 128>;
    case 256: return (const void*)decode_tc_kernel<G, 256>;
    default: return nullptr;
  }
}

static int tc_smem(int D) {
  switch (D) {
    case 64: return TcPlan<64>::SMEM;
    case 128: return TcPlan<128>::SMEM;
    case 256: return TcPlan<256>::SMEM;
    default: return 0;
  }
}

// The CUDA-core kernel at the heads a block of the supported models
// (gemma-7b 1, phi4-mini 3; in fp32 also qwen2.5-32b 5, yi-34b and
// qwen2-vl 7, recurrentgemma-9b's 16 as two blocks of 8) and 2 for the edge
// cases; bf16 at 5, 7 and 8 takes the tensor-core kernel.
template <typename T>
static const void* kernel_for_g(int G, int D) {
  switch (G) {
    case 1: return kernel_for_d<T, 1>(D);
    case 2: return kernel_for_d<T, 2>(D);
    case 3: return kernel_for_d<T, 3>(D);
    default: return nullptr;
  }
}
template <>
const void* kernel_for_g<float>(int G, int D) {
  switch (G) {
    case 1: return kernel_for_d<float, 1>(D);
    case 2: return kernel_for_d<float, 2>(D);
    case 3: return kernel_for_d<float, 3>(D);
    case 5: return kernel_for_d<float, 5>(D);
    case 7: return kernel_for_d<float, 7>(D);
    case 8: return kernel_for_d<float, 8>(D);
    default: return nullptr;
  }
}

static const void* tc_kernel_for_g(int G, int D) {
  switch (G) {
    case 5: return tc_kernel_for_d<5>(D);
    case 7: return tc_kernel_for_d<7>(D);
    case 8: return tc_kernel_for_d<8>(D);
    case 16: return tc_kernel_for_d<16>(D);
    default: return nullptr;
  }
}

// The kernel for a group of G q heads a kv head (instantiated for the heads
// a block of that group), and its dynamic shared memory in bytes.  The
// tensor-core kernels are allowed their ring above 48 KB at first use.
static const void* find_kernel(int dtype, int G, int D, int* smem) {
  *smem = 0;
  if (tc_path(dtype, G)) {
    const void* fn = tc_kernel_for_g(G, D);
    if (fn == nullptr) return nullptr;
    *smem = tc_smem(D);
    static bool ready[16][17][3] = {};   // (device, G, D) allowed its ring
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16) return nullptr;
    bool& done = ready[dev][G][D == 64 ? 0 : D == 128 ? 1 : 2];
    if (!done) {
      if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem) !=
          cudaSuccess)
        return nullptr;
      done = true;
    }
    return fn;
  }
  const int gb = heads_a_block(dtype, G);
  if (dtype == DT_F32) return kernel_for_g<float>(gb, D);
  if (dtype == DT_BF16) return kernel_for_g<__nv_bfloat16>(gb, D);
  return nullptr;
}

// Rows a block reads an iteration (the CUDA-core kernel) or a ring stage
// (the tensor-core kernel): a split is a whole number of them.
static int plan_rows(int dtype, int G, int D) {
  if (tc_path(dtype, G)) {
    switch (D) {
      case 64: return TcPlan<64>::ROWS;
      case 128: return TcPlan<128>::ROWS;
      case 256: return TcPlan<256>::ROWS;
    }
  } else if (dtype == DT_F32) {
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

// Q heads a block for a group of G in `dtype` (0 where no kernel takes G).
extern "C" int decode_attention_heads_a_block(int G, int dtype) {
  if (dtype != DT_F32 && dtype != DT_BF16) return 0;
  if (!tc_path(dtype, G) && kernel_for_g<float>(heads_a_block(dtype, G), 64) == nullptr) return 0;
  return heads_a_block(dtype, G);
}

// For (G, D, dtype) on the current device: out[0] = resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] = rows a block
// reads an iteration or a ring stage, out[2] = threads a block, out[3] = the
// path (1 the tensor-core kernel, 0 the CUDA-core one), out[4] = q heads a
// block, out[5] = dynamic shared memory in bytes.  Returns a CUDA error code.
extern "C" int decode_attention_plan(int G, int D, int dtype, int* out) {
  int smem = 0;
  const void* fn = find_kernel(dtype, G, D, &smem);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, DEC_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = plan_rows(dtype, G, D);
  out[2] = DEC_THREADS;
  out[3] = tc_path(dtype, G) ? 1 : 0;
  out[4] = heads_a_block(dtype, G);
  out[5] = smem;
  return 0;
}

// (splits, rows a split) for a cache of T rows read by B*HB blocks a split
// (HB head blocks a sequence) on a card of sm_count SMs holding
// blocks_per_sm of them: the splits fill the card once, but none is under
// SPLIT_FLOOR rows and at most MAX_SPLITS; a split is a whole number of
// `rows`.  Mirrored by kernels/decode_attention.py `split_plan`.
extern "C" void decode_attention_split_plan(int B, int HB, int T, int sm_count,
                                            int blocks_per_sm, int rows, int* out) {
  T = T > 1 ? T : 1;
  const int pairs = B * HB > 1 ? B * HB : 1;
  int ns = (sm_count * blocks_per_sm) / pairs;
  ns = ns < T / SPLIT_FLOOR ? ns : T / SPLIT_FLOOR;
  ns = ns < MAX_SPLITS ? ns : MAX_SPLITS;
  const int most = (T + rows - 1) / rows;
  ns = ns < most ? ns : most;
  ns = ns > 1 ? ns : 1;
  int chunk = (T + ns - 1) / ns;
  chunk = (chunk + rows - 1) / rows * rows;
  out[0] = (T + chunk - 1) / chunk;
  out[1] = chunk;
}

// q (B,H,D) contiguous; k/v (B,Hkv,T,D) with strides in elements over their
// first three dims and stride 1 over D, every row 16-byte aligned; valid (B,)
// int32; out (B,H,D) contiguous of `dtype`.  With HB = H / heads_a_block head
// blocks (Hkv unless an fp32 group is split), scratch: part_acc
// (B,HB,ns,H/HB,D), part_m and part_l (B,HB,ns,H/HB) fp32, counter (B*HB)
// int32 that must be 0 (the kernel leaves it 0).  Split s covers rows
// [s*chunk, (s+1)*chunk); ns is at most MAX_SPLITS.  Returns
// cudaGetLastError().
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* valid, void* out, void* part_acc,
    void* part_m, void* part_l, void* counter, int B, int H, int Hkv, int T, int D, int ns,
    int chunk, long long k_sb, long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (Hkv <= 0 || H % Hkv || ns < 1 || ns > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  int smem = 0;
  const void* fn = find_kernel(dtype, G, D, &smem);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const int per_kv = G / heads_a_block(dtype, G);
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
  const cudaError_t e = cudaLaunchKernel(fn, dim3(ns, Hkv * per_kv, B), dim3(DEC_THREADS), args,
                                         (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
