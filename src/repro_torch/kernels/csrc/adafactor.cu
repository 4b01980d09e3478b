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
// whole update, so every u must be known before any is applied.  Its sum of
// squares needs no pass of its own: where denom = vr_i / m x vc_j >= eps1
// (m = max(mean(vr), eps1)), u_ij^2 = g_ij^2 / denom, so
//   sum u^2 = m x sum_j (1 / vc_j) x W_j,   W_j = sum_i g_ij^2 / vr_i,
// and vr_i is complete once row i is read.  The statistics pass keeps W_j
// beside the column sums, and a guard proves that no clamp bites: over the
// rows and columns that hold a nonzero g^2, fl(fl(min vr / m) x vc_j) >=
// eps1 (rounded division and product are monotone; an element whose g^2 is 0
// adds 0 to both forms).  Where the guard fails, the u^2 pass runs.  So the
// design reads g twice and p twice and writes p once:
//
//   factored, tiles of at least 32 KB fit the stages (af_rows_kernel; 3 launches):
//     (a) stats   tiles of rows of g and p, and the rows' vr, staged in shared
//                 memory by TMA (cp.async.bulk, and cp.async for vr, into a
//                 ring of stages on mbarriers): vr, column sums of g^2 + eps1
//                 and of W, sums of p^2, the guard's least vr; where a matrix
//                 spans several slabs, a grid-wide barrier (the launch is
//                 cooperative) and the column sums spread over the grid: vc,
//                 vr's mean, m x sum_j W_j / vc_j, the guard; the last block
//                 to finish: the clip divisor, lr x RMS(p), lr x wd
//     (b) usq     returns at once where the guard held; else reads g: sums
//                 of u^2, and its last block the scalars again  af_usq_kernel
//     (c) apply   read g, p, write p                            af_apply_kernel
//   factored, a row wider than the stages (an lm head), tiles under 32 KB
//     (many small matrices), or a base or row not 16-byte aligned (TMA needs
//     it; 3 launches): the statistics by chunks (af_wide_kernel:
//     rows in chunks, one warp a row, so no W; the column sums after a
//     grid-wide barrier), (b) always, (c)
//   plain (1-D, a last dim of 1, 0-d; 2 launches):
//     (a+b) read g, p, v: v, sums of u^2 and of p^2, the scalars  af_v_kernel
//     (c)   read g, v, p, write p                                af_vapply_kernel
//
// af_rows_kernel.  One block of 512 threads (16 warps) an SM takes slabs of
// SR consecutive rows of one matrix across all of its columns, in tiles of TR
// rows; thread 0 keeps ST tiles in flight.  Row pass: a warp a row (TR >= 16:
// rows w, w + 16, ...), or WPR = 16 / TR warps a row (TR = 1, 2, 4, 8), each
// warp the chunks s, s + WPR, ... of 32 x VEC columns; lane l holds columns l
// VEC .. l VEC + VEC - 1 of a chunk; thread j then forms row j's vr and 1 /
// vr.  Column pass: LANES threads across the columns (column vectors cl, cl
// + LANES, ..., at most AF_MAX_KC a thread, their sums in registers), 512 /
// LANES row groups (rows rg, rg + RG, ...).  A matrix of one slab (S = 1) is
// finished by its block; otherwise every slab writes its column sums and the
// grid adds them: an item is 32 columns of one matrix, warp w adding the
// slabs w, w + 16, ...  kernels/adafactor.py `launch_plan` picks SR (about
// one slab a block, the column workspace M x S x C x 2 floats under 16 MiB),
// TR (as many rows as fit two stages) and ST (as many stages as fit).  The
// tile's size, not the stages' count, sets its speed: a tile costs about the
// same fixed time whatever its bytes.  (b) and (c) walk slabs of their own
// (SR2 rows, about four an SM).
//
// Every sum runs in one fixed order, with no atomics, so two runs give the
// same bits.  Trees add adjacent pairs level by level ((x0 + x1) + (x2 + x3))
// + ...; a warp's tree is the xor butterfly with offsets 1, 2, 4, 8, 16,
// which is that tree in every lane, and a block's tree over its warps is the
// tree over 16 with the missing warps 0, so a block's tree is the tree over
// its threads.  A row's sum: each lane's chunks in a chain (a tree over each
// vector), a tree over the warp, a tree over its WPR warps.  A column's: each
// row group's rows of the slab in a chain, a tree over the row groups, then
// (S > 1) each warp's slabs in a chain and a tree over the 16 warps.  W
// likewise (g^2 x (1 / vr_i) added only where g^2 > 0, from -0, so a column
// whose W keeps its sign bit holds no nonzero g^2).  vr's mean: thread j's
// rows j of each tile in a chain, a tree over the block, then (S > 1) lane
// l's slabs l, l + 32, ... and a tree over the warp.  p^2: each thread's
// values in order, a tree over the block a slab.  A matrix's u^2 terms (S =
// 1): one row group, thread t its column vectors in order; more, thread t the
// elements t, t + 512, ... (element ce / CV of column vector ce % CV); a
// tree over the block.  The partials of p^2 (a slab each) and of u^2 (an
// item or a matrix each) then: thread t adds every NT-th from t in a chain,
// a tree over the block's NT threads.  The atomics here count blocks (a
// grid-wide barrier, the last block to finish) and order nothing that is
// summed.  tests/test_torch_adafactor.py emulates this plan in float32.
//
// The elementwise arithmetic is the plain version's, in its order, rounded
// after every operation (__fmul_rn, __fadd_rn, __fdiv_rn keep nvcc from
// contracting a product and a sum into an FMA; rsqrtf is what PyTorch's
// CUDA rsqrt calls), with g and p widened to fp32 and p rounded back to its
// type.  lr and beta2 are read from device memory (0-d tensors the step
// computed), so nothing synchronises with the host.
#include "common.cuh"
#include "hopper.cuh"

#define AF_THREADS 256
#define AF_WARPS 8
#define AF_MAX_LAYERS 128      // kernels/adafactor.py MAX_LAYERS
#define AF_MAX_SLAB 1024       // kernels/adafactor.py MAX_SLAB_ROWS (the wide walk)
#define AF_MAX_TILE 256        // kernels/adafactor.py MAX_TILE_ROWS
#define AF_MAX_STAGES 8
#define AF_BULK_PIECE 32768u   // bytes a bulk copy at most
#define AF_ROWS_THREADS 512    // af_rows_kernel's block: one an SM
#define AF_MAX_KC 4            // column vectors a thread of af_rows_kernel at most
#define AF_SPIN_LIMIT (1u << 26)

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

// af_rows_kernel's tiles: TR rows a tile, ST stages, WPR warps a row in the
// row pass, LANES threads across the columns and KC column vectors a thread
// in the column pass; a stage holds TR rows of g, then (at p_off) TR of p,
// then (at vr_off) their vr.
struct AfRows {
  int TR, ST, WPR, LANES, KC;
  int stage_bytes, p_off, vr_off;
};

// The workspace (kernels/adafactor.py `launch_plan` sizes it): scal = {clip
// divisor, lr x RMS(p) (at least eps2), lr x wd, 1 where the statistics'
// sum of u^2 stands (the guard held) else 0}, vr's mean a matrix, partials.
struct AfWork {
  float *scal, *rmean, *ppart, *upart, *ufail, *upart2, *vrpart, *minvr, *colpart, *wpart;
  long long nparts, nu, nu2;   // entries of ppart, of upart and ufail, of upart2
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

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
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

// NS trees, NM minimums and an or over the block at once (red: AF_RED
// floats); the results in thread 0; ends with a barrier.  A block of 8 or 16
// warps: the tree over its warps is the tree over 16 with the missing ones 0
// (adding 0 changes no bits), so a block's tree is the tree over its threads.
#define AF_MAX_WARPS 16
#define AF_RED 96

template <int NS, int NM>
struct BlockRed {
  float s[NS], mn[NM];
  bool any;
};

template <int NS, int NM>
__device__ __forceinline__ BlockRed<NS, NM> block_reduce(const float (&s)[NS],
                                                         const float (&mn)[NM], bool any,
                                                         float* red, int nt) {
  static_assert((NS + NM + 1) * AF_MAX_WARPS <= AF_RED, "room for the warps' values");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = nt >> 5;
  float v[NS + NM];
#pragma unroll
  for (int i = 0; i < NS; ++i) v[i] = warp_tree(s[i]);
#pragma unroll
  for (int i = 0; i < NM; ++i) v[NS + i] = warp_min(mn[i]);
  any = __any_sync(0xffffffffu, any);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NS + NM; ++i) red[i * AF_MAX_WARPS + warp] = v[i];
    red[(NS + NM) * AF_MAX_WARPS + warp] = any ? 1.f : 0.f;
  }
  __syncthreads();
  BlockRed<NS, NM> r{};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float a[AF_MAX_WARPS];
#pragma unroll
      for (int k = 0; k < AF_MAX_WARPS; ++k) a[k] = k < nw ? red[i * AF_MAX_WARPS + k] : 0.f;
      r.s[i] = vec_tree<AF_MAX_WARPS>(a);
    }
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      r.mn[i] = red[(NS + i) * AF_MAX_WARPS];
      for (int k = 1; k < nw; ++k) r.mn[i] = fminf(r.mn[i], red[(NS + i) * AF_MAX_WARPS + k]);
    }
    r.any = false;
    for (int k = 0; k < nw; ++k) r.any |= red[(NS + NM) * AF_MAX_WARPS + k] != 0.f;
  }
  __syncthreads();
  return r;
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
// across blocks: a grid-wide barrier (cooperative launches only) and the
// last block to finish
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid arrives before any leaves.  The counter's low 31
// bits start at 0 and end at 0: block 0 adds 2^31 - (grid - 1), every other
// block 1, so the top bit flips exactly when the last block arrives.  A wait
// that never ends traps, so the launch fails instead of hanging.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, add);
    unsigned tries = 0;
    while (((old ^ ld_acquire(bar)) & 0x80000000u) == 0)
      if (++tries == AF_SPIN_LIMIT) __trap();
    __threadfence();
  }
  __syncthreads();
}

// True in every thread of the last block to get here (the counter, left at
// 0, is reset by that block: `done_last`).
__device__ __forceinline__ bool last_block(unsigned* ctr) {
  __shared__ int s_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(ctr, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  const bool last = s_last != 0;
  if (last) __threadfence();
  return last;
}

// The step's scalars from the partials (the last block, of nt threads): u^2
// and p^2 summed (thread t every nt-th partial from t in a chain, a tree over
// the nt threads),
// scal[0] = max(sqrt(mean(u^2) + eps1) / clip, 1), scal[1] = lr x
// max(sqrt(mean(p^2)), eps2), scal[2] = lr x wd, scal[3] = `guard` (or, where
// `guard` < 0, 1 unless a partial's fail flag is set).
__device__ void finish_scalars(const float* upart, long long nu, const float* ufail,
                               const float* ppart, long long np, float N, const float* lr_p,
                               const AfScalars& sc, float guard, float* scal, float* red,
                               int nt) {
  float u = 0.f, p = 0.f;
  bool fail = false;
  for (long long i = threadIdx.x; i < nu; i += nt) {
    u = __fadd_rn(u, __ldcg(upart + i));
    if (ufail != nullptr) fail |= __ldcg(ufail + i) != 0.f;
  }
  for (long long i = threadIdx.x; i < np; i += nt) p = __fadd_rn(p, __ldcg(ppart + i));
  const BlockRed<2, 1> r = block_reduce<2, 1>({u, p}, {0.f}, fail, red, nt);
  if (threadIdx.x == 0) {
    const float lr = *lr_p;
    const float rms_u = __fsqrt_rn(__fadd_rn(__fdiv_rn(r.s[0], N), sc.eps1));
    const float scale = clamp_min(__fsqrt_rn(__fdiv_rn(r.s[1], N)), sc.eps2);
    scal[0] = clamp_min(__fdiv_rn(rms_u, sc.clip), 1.f);
    scal[1] = __fmul_rn(lr, scale);
    scal[2] = __fmul_rn(lr, sc.wd);
    scal[3] = guard >= 0.f ? guard : (r.any ? 0.f : 1.f);
  }
}

// ---------------------------------------------------------------------------
// factored groups
// ---------------------------------------------------------------------------

// Where a slab's rows lie: every row of a matrix in one layer (a layer holds
// n / C = rpl rows, a multiple of R), or a row a layer (rpl = 1: a stack of
// 1-D layers, the reference's (L, D) matrix).  Found once a slab or tile, so
// no row pays a 64-bit division.
struct SlabAt {
  long long layer, row;   // the first row: its layer, its row in the layer
  bool row_a_layer;
};

__device__ __forceinline__ SlabAt slab_at(const AfShape& sh, long long q0) {
  if (sh.rpl == 1) return SlabAt{q0, 0, true};
  const long long layer = q0 / sh.rpl;
  return SlabAt{layer, q0 - layer * sh.rpl, false};
}

// Columns c0.. of row j from the slab's (or tile's) first row.
template <typename T>
__device__ __forceinline__ T* row_ptr(void* const* ptrs, const AfShape& sh, const SlabAt& at,
                                      int j, long long c0) {
  if (at.row_a_layer) return reinterpret_cast<T*>(ptrs[at.layer + j]) + c0;
  return reinterpret_cast<T*>(ptrs[at.layer]) + (at.row + j) * sh.C + c0;
}

// A tile: its slab, matrix, first row in the matrix (and where that row
// lies), its index in the slab and its rows (0 past the matrix's last row).
struct TileAt {
  long long slab, m, row;
  SlabAt at;
  int t, n;
};

// A block's walk over its tiles: slabs blockIdx.x, + gridDim.x, ..., TPS
// tiles a slab, one tile at a time (the divisions once a slab).
struct TileWalk {
  long long slab, m, r0, end;
  SlabAt at;
  int t;

  __device__ __forceinline__ void start(const AfShape& sh, long long s) {
    slab = s;
    m = s / sh.S;
    r0 = (s - m * sh.S) * sh.SR;
    end = min(r0 + (long long)sh.SR, sh.R);
    at = slab_at(sh, m * sh.R + r0);
    t = 0;
  }
  __device__ __forceinline__ void next(const AfShape& sh, int TPS) {
    if (++t == TPS) start(sh, slab + gridDim.x);
  }
  __device__ __forceinline__ TileAt tile(int TR) const {
    const long long off = (long long)t * TR, row = r0 + off;
    SlabAt a = at;
    if (a.row_a_layer) a.layer += off;
    else a.row += off;
    return TileAt{slab, m, row, a, t, (int)max(0LL, min((long long)TR, end - row))};
  }
};

// 4 bytes from global to shared memory, asynchronously (cp.async); the
// arrive makes `bar` count one arrival once every cp.async this thread has
// issued has landed (the barrier's count includes it: .noinc).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  for (uint32_t o = 0; o < bytes; o += AF_BULK_PIECE)
    bulk_load(static_cast<char*>(dst) + o, static_cast<const char*>(src) + o,
              min(AF_BULK_PIECE, bytes - o), bar);
}

// One thread: the tile's rows of g and p into `stage` by TMA, and their vr
// (cp.async); completion on `bar` (a tile of no rows completes at once).
template <typename TG, typename TP>
__device__ __forceinline__ void issue_tile(const AfLayers& lay, const AfShape& sh,
                                           const AfRows& rw, const TileAt& ta, const float* vr,
                                           unsigned char* stage, uint64_t* bar) {
  const long long C = sh.C;
  const uint32_t gb = (uint32_t)(ta.n * C * (long long)sizeof(TG));
  const uint32_t pb = (uint32_t)(ta.n * C * (long long)sizeof(TP));
  mbar_arrive_expect_tx(bar, gb + pb);
  float* svr = reinterpret_cast<float*>(stage + rw.vr_off);
  for (int j = 0; j < ta.n; ++j) cp_async4(svr + j, vr + ta.m * sh.R + ta.row + j);
  cp_async_arrive(bar);
  if (ta.n == 0) return;
  const SlabAt& at = ta.at;
  unsigned char* sp = stage + rw.p_off;
  if (!at.row_a_layer) {
    bulk_copy(stage, static_cast<const TG*>(lay.g[at.layer]) + at.row * C, gb, bar);
    bulk_copy(sp, static_cast<const TP*>(lay.p[at.layer]) + at.row * C, pb, bar);
  } else {
    const uint32_t rg = (uint32_t)(C * sizeof(TG)), rp = (uint32_t)(C * sizeof(TP));
    for (int j = 0; j < ta.n; ++j) {
      bulk_copy(stage + (size_t)j * rg, lay.g[at.layer + j], rg, bar);
      bulk_copy(sp + (size_t)j * rp, lay.p[at.layer + j], rp, bar);
    }
  }
}

template <typename TG, typename TP, int VEC, int KCM>
__global__ void __launch_bounds__(AF_ROWS_THREADS, 1)
af_rows_kernel(const __grid_constant__ AfLayers lay, const AfShape sh, const AfRows rw,
               float* __restrict__ vr, float* __restrict__ vc, const AfWork w,
               const float* __restrict__ beta2_p, const float* __restrict__ lr_p,
               const AfScalars sc, unsigned* __restrict__ ctr) {
  constexpr int NT = AF_ROWS_THREADS, NW = NT / 32, CW = 32 * VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int TR = rw.TR, ST = rw.ST, WPR = rw.WPR, LANES = rw.LANES, KC = rw.KC;
  const int RG = NT / LANES, rg = tid / LANES, cl = tid - rg * LANES;
  const long long R = sh.R;
  const int C = (int)sh.C;   // a row fits a stage: tile-local offsets are 32-bit
  const int CV = C / VEC;
  const int chunks = (C + CW - 1) / CW;
  // shared memory: the stages; where RG > 1, the row groups' sums at a slab's
  // end (NT VEC floats each of the column sums and W); a tile's row values
  float* tacc = reinterpret_cast<float*>(smem + (size_t)ST * rw.stage_bytes);
  const int taccn = RG > 1 ? NT * VEC : 0;
  const int TR16 = max(TR, NW);
  float* seg = tacc + 2 * taccn;       // [TR16]: a row's sum by its WPR warps
  float* segnz = seg + TR16;           // [TR16]: whether the part holds a nonzero g^2
  float* rowinv = segnz + TR16;        // [TR]: 1 / a row's new vr
  float* red = rowinv + TR;            // [AF_RED]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(red + AF_RED) + 7) & ~uintptr_t(7));   // [ST]: a tile is in

  const float b = *beta2_p, omb = __fsub_rn(1.f, b);
  const int TPS = (sh.SR + TR - 1) / TR;
  const long long mine = (long long)blockIdx.x < sh.slabs
      ? (sh.slabs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long ntiles = mine * TPS;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) mbar_init(&full[s], 2);   // the TMA's and the cp.async's
    fence_barrier_init();
  }
  __syncthreads();
  __shared__ TileWalk pw;   // (thread 0) the next tile to ask for
  TileWalk cur;             // the tile consumed
  cur.start(sh, blockIdx.x);
  auto issue = [&](int s) {   // thread 0: the next tile into stage s
    TileWalk x = pw;
    const TileAt t = x.tile(TR);
    issue_tile<TG, TP>(lay, sh, rw, t, vr, smem + (size_t)s * rw.stage_bytes, &full[s]);
    x.next(sh, TPS);
    pw = x;
  };
  if (tid == 0) {
    pw = cur;
    for (long long q = 0; q < min((long long)ST, ntiles); ++q) issue((int)q);
  }
  // this thread's columns (cl + kc LANES): sums over its row group's rows of the slab
  float ca[KCM][VEC], wa[KCM][VEC];
  float pacc = 0.f, vrc = 0.f, mnv = INFINITY;
  for (long long q = 0; q < ntiles; ++q) {
    const TileAt ta = cur.tile(TR);
    const int s = (int)(q % ST);
    unsigned char* stage = smem + (size_t)s * rw.stage_bytes;
    const float* svr = reinterpret_cast<const float*>(stage + rw.vr_off);
    if (ta.t == 0) {    // a new slab
#pragma unroll
      for (int kc = 0; kc < KCM; ++kc)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ca[kc][e] = 0.f;
          wa[kc][e] = -0.f;
        }
    }
    mbar_wait(&full[s], (uint32_t)((q / ST) & 1));
    const TG* tg = reinterpret_cast<const TG*>(stage);
    const TP* tp = reinterpret_cast<const TP*>(stage + rw.p_off);

    // row pass: each row's sum of g^2 + eps1 by its warps (and its largest
    // g^2), p^2 in each thread's chain
    {
      const int j0 = WPR == 1 ? warp : warp / WPR;
      const int sgi = warp - j0 * WPR;
      const int js = WPR == 1 ? NW : TR;
      for (int j = j0; j < ta.n; j += js) {
        float rs = 0.f, mx = 0.f;
        for (int k = sgi; k < chunks; k += WPR) {
          const int c0 = k * CW + lane * VEC;
          if (c0 < C) {
            float x[VEC], pv[VEC];
            loadv<TG, VEC>(tg + j * C + c0, x);
            loadv<TP, VEC>(tp + j * C + c0, pv);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const float g2 = __fmul_rn(x[e], x[e]);
              mx = fmaxf(mx, g2);
              x[e] = __fadd_rn(g2, sc.eps1);
              pv[e] = __fmul_rn(pv[e], pv[e]);
            }
            rs = __fadd_rn(rs, vec_tree<VEC>(x));
            pacc = __fadd_rn(pacc, vec_tree<VEC>(pv));
          }
        }
        rs = warp_tree(rs);
        const bool nz = __any_sync(0xffffffffu, mx > 0.f);
        if (lane == 0) {
          seg[j * WPR + sgi] = rs;
          segnz[j * WPR + sgi] = nz ? 1.f : 0.f;
        }
      }
    }
    __syncthreads();
    if (tid < ta.n) {   // thread j: row j's new vr (to the state), 1 / vr, the slab's chains
      float t[AF_MAX_WARPS];
      bool nz = false;
#pragma unroll
      for (int i = 0; i < AF_MAX_WARPS; ++i) {
        t[i] = i < WPR ? seg[tid * WPR + i] : 0.f;
        nz |= i < WPR && segnz[tid * WPR + i] != 0.f;
      }
      const float v = ema(b, omb, svr[tid], __fdiv_rn(vec_tree<AF_MAX_WARPS>(t), (float)C));
      vr[ta.m * R + ta.row + tid] = v;
      rowinv[tid] = __frcp_rn(v);
      vrc = __fadd_rn(vrc, v);
      if (nz) mnv = fminf(mnv, v);
    }
    __syncthreads();

    // column pass: g^2 + eps1 and g^2 x (1 / vr_i) into this thread's columns' sums
    for (int j = rg; j < ta.n; j += RG) {
      const float inv = rowinv[j];
#pragma unroll
      for (int kc = 0; kc < KCM; ++kc) {
        const int cv = cl + kc * LANES;
        if (kc < KC && cv < CV) {
          float x[VEC];
          loadv<TG, VEC>(tg + j * C + cv * VEC, x);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float g2 = __fmul_rn(x[e], x[e]);
            ca[kc][e] = __fadd_rn(ca[kc][e], __fadd_rn(g2, sc.eps1));
            if (g2 > 0.f) wa[kc][e] = __fadd_rn(wa[kc][e], __fmul_rn(g2, inv));
          }
        }
      }
    }
    __syncthreads();    // the stage and the tile's rows are free
    if (tid == 0 && q + ST < ntiles) issue(s);

    if (ta.t == TPS - 1) {   // the slab's end: its columns
      float uc = 0.f, mvc = INFINITY;
      // a column's sums, written (S > 1), or its vc, u^2 term and guard (S = 1)
      auto column = [&](long long c, float cs, float W, float old) {
        if (sh.S > 1) {
          w.colpart[ta.slab * C + c] = cs;
          w.wpart[ta.slab * C + c] = W;
        } else {
          const float v = ema(b, omb, old, __fdiv_rn(cs, (float)R));
          vc[ta.m * C + c] = v;
          uc = __fadd_rn(uc, __fdiv_rn(W, v));
          if (!signbit(W)) mvc = fminf(mvc, v);
        }
      };
      if (RG == 1) {     // a thread's columns are whole: cl + kc LANES, element by element
#pragma unroll
        for (int kc = 0; kc < KCM; ++kc) {
          const int cv = cl + kc * LANES;
          if (kc < KC && cv < CV)
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const long long c = (long long)cv * VEC + e;
              column(c, ca[kc][e], wa[kc][e], sh.S > 1 ? 0.f : vc[ta.m * C + c]);
            }
        }
      } else {           // KC = 1: a tree over the row groups, element ce = e CV + cv a thread
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          tacc[(rg * VEC + e) * LANES + cl] = ca[0][e];
          tacc[taccn + (rg * VEC + e) * LANES + cl] = wa[0][e];
        }
        __syncthreads();
        for (int ce = tid; ce < CV * VEC; ce += NT) {
          const int e = ce / CV, cv = ce - e * CV;
          for (int d = 1; d < RG; d <<= 1)
            for (int g = 0; g + d < RG; g += 2 * d) {
              const int a0 = (g * VEC + e) * LANES + cv, a1 = ((g + d) * VEC + e) * LANES + cv;
              tacc[a0] = __fadd_rn(tacc[a0], tacc[a1]);
              tacc[taccn + a0] = __fadd_rn(tacc[taccn + a0], tacc[taccn + a1]);
            }
          const long long c = (long long)cv * VEC + e;
          column(c, tacc[e * LANES + cv], tacc[taccn + e * LANES + cv], vc[ta.m * C + c]);
        }
      }
      const BlockRed<3, 2> rr = block_reduce<3, 2>({vrc, pacc, uc}, {mnv, mvc}, false, red, NT);
      if (tid == 0) {
        w.ppart[ta.slab] = rr.s[1];
        if (sh.S > 1) {
          w.vrpart[ta.slab] = rr.s[0];
          w.minvr[ta.slab] = rr.mn[0];
        } else {   // the guard at the least vc of a column holding a nonzero g^2
          const float rm = clamp_min(__fdiv_rn(rr.s[0], (float)R), sc.eps1);
          w.rmean[ta.m] = rm;
          w.upart[ta.m] = __fmul_rn(rm, rr.s[2]);
          w.ufail[ta.m] = __fmul_rn(__fdiv_rn(rr.mn[0], rm), rr.mn[1]) < sc.eps1 ? 1.f : 0.f;
        }
      }
      pacc = 0.f;
      vrc = 0.f;
      mnv = INFINITY;
    }
    cur.next(sh, TPS);
  }

  if (sh.S > 1) {
    // the column sums over the slabs, spread over the grid: 32 columns of
    // one matrix an item, warp w the slabs w, w + NW, ... (the stages are free)
    grid_barrier(&ctr[0]);
    float* tcol = reinterpret_cast<float*>(smem);   // [NW][32]
    float* tw = tcol + NT;
    const long long groups = (C + 31) / 32, items = sh.M * groups;
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const long long m = it / groups, grp = it - m * groups;
      const long long c = grp * 32 + lane;
      const bool active = c < C;
      float cs = 0.f, ws = -0.f;
      if (active)
        for (long long s = warp; s < sh.S; s += NW) {
          const long long o = (m * sh.S + s) * C + c;
          cs = __fadd_rn(cs, __ldcg(w.colpart + o));
          ws = __fadd_rn(ws, __ldcg(w.wpart + o));
        }
      tcol[tid] = cs;
      tw[tid] = ws;
      __syncthreads();
      if (warp == 0) {
        float a[NW], bw[NW];
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          a[i] = tcol[i * 32 + lane];
          bw[i] = tw[i * 32 + lane];
        }
        const float colsum = vec_tree<NW>(a), W = vec_tree<NW>(bw);
        float vs = 0.f, mv = INFINITY;
        for (long long s = lane; s < sh.S; s += 32) {
          vs = __fadd_rn(vs, __ldcg(w.vrpart + m * sh.S + s));
          mv = fminf(mv, __ldcg(w.minvr + m * sh.S + s));
        }
        vs = warp_tree(vs);
        mv = warp_min(mv);
        const float rm = clamp_min(__fdiv_rn(vs, (float)R), sc.eps1);
        float term = 0.f;
        bool fail = false;
        if (active) {
          const float v = ema(b, omb, vc[m * C + c], __fdiv_rn(colsum, (float)R));
          vc[m * C + c] = v;
          term = __fdiv_rn(W, v);
          fail = !signbit(W) && __fmul_rn(__fdiv_rn(mv, rm), v) < sc.eps1;
        }
        term = warp_tree(term);
        fail = __any_sync(0xffffffffu, fail);
        if (lane == 0) {
          w.upart[it] = __fmul_rn(rm, term);
          w.ufail[it] = fail ? 1.f : 0.f;
          if (grp == 0) w.rmean[m] = rm;
        }
      }
      __syncthreads();
    }
  }
  if (last_block(&ctr[1])) {
    finish_scalars(w.upart, w.nu, w.ufail, w.ppart, w.nparts, sh.N, lr_p, sc, -1.f, w.scal, red,
                   NT);
    if (tid == 0) ctr[1] = 0;
  }
}

// Rows wider than a stage: a slab's rows in chunks of 32 x VEC columns, one
// warp a row, a row's sum complete only after its last chunk (so no W); vr's
// slab sums and the column partials, then (S > 1) after a grid-wide barrier
// the column sums: vc and vr's mean a matrix.
template <typename TG, typename TP, int VEC>
__global__ void __launch_bounds__(AF_THREADS)
af_wide_kernel(const __grid_constant__ AfLayers lay, const AfShape sh, float* __restrict__ vr,
               float* __restrict__ vc, const AfWork w, const float* __restrict__ beta2_p,
               const AfScalars sc, unsigned* __restrict__ ctr) {
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
          for (int i = 0; i < AF_WARPS; ++i) v[i] = colbuf[i][t];
          const float sum = vec_tree<AF_WARPS>(v);
          if (sh.S == 1)
            vc[m * C + c] = ema(b, omb, vc[m * C + c], __fdiv_rn(sum, (float)R));
          else
            w.colpart[slab * C + c] = sum;
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
      w.ppart[slab] = ps;
      if (sh.S == 1)
        w.rmean[m] = clamp_min(__fdiv_rn(rowacc[0], (float)R), sc.eps1);
      else
        w.vrpart[slab] = rowacc[0];
    }
    __syncthreads();
  }
  if (sh.S == 1) return;
  grid_barrier(&ctr[0]);
  // a matrix's column sums over its slabs, and its vr mean
  const long long col_blocks = (C + AF_THREADS - 1) / AF_THREADS;
  for (long long blk = blockIdx.x; blk < sh.M * col_blocks; blk += gridDim.x) {
    const long long m = blk / col_blocks;
    const long long c = (blk - m * col_blocks) * AF_THREADS + threadIdx.x;
    if (c < C) {
      const float sum = strided_tree(w.colpart + m * sh.S * C + c, sh.S, C);
      vc[m * C + c] = ema(b, omb, vc[m * C + c], __fdiv_rn(sum, (float)R));
    }
    if (blk == m * col_blocks && threadIdx.x == 0) {
      const float sum = strided_tree(w.vrpart + m * sh.S, sh.S, 1);
      w.rmean[m] = clamp_min(__fdiv_rn(sum, (float)R), sc.eps1);
    }
  }
}

// Rows a warp of (b) has in flight: it loads AF_U_USQ rows (j, j + 8, ...)
// before it adds any, so its sum keeps the rows' order.  (c) takes one row
// at a time (two or four in flight ran no faster at the embedding).
#define AF_U_USQ 2

// (b): where the statistics' sum of u^2 stands (scal[3] = 1) it returns at
// once; else (or `force`, the wide walk) the sums of u^2 a slab, and the
// last block the scalars.
template <typename TG, int VEC>
__global__ void __launch_bounds__(AF_THREADS)
af_usq_kernel(const __grid_constant__ AfLayers lay, const AfShape sh,
              const float* __restrict__ vr, const float* __restrict__ vc, const AfWork w,
              int force, const float* __restrict__ lr_p, const AfScalars sc,
              unsigned* __restrict__ ctr) {
  if (!force && w.scal[3] != 0.f) return;
  constexpr int CW = 32 * VEC;
  __shared__ float red[AF_RED];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long C = sh.C, R = sh.R;
  const int chunks = (int)((C + CW - 1) / CW);
  void* const* gp = (void* const*)lay.g;
  for (long long slab = blockIdx.x; slab < sh.slabs2; slab += gridDim.x) {
    const long long m = slab / sh.S2;
    const long long r0 = (slab - m * sh.S2) * sh.SR2;
    const int nr = (int)min((long long)sh.SR2, R - r0);
    const SlabAt at = slab_at(sh, m * R + r0);
    const float rm = w.rmean[m];
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
    if (threadIdx.x == 0) w.upart2[slab] = us;
  }
  if (last_block(&ctr[2])) {
    finish_scalars(w.upart2, w.nu2, nullptr, w.ppart, w.nparts, sh.N, lr_p, sc, 0.f, w.scal,
                   red, AF_THREADS);
    if (threadIdx.x == 0) ctr[2] = 0;
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
af_v_kernel(const __grid_constant__ AfLayers lay, const AfShape sh, long long total,
            float* __restrict__ v, const AfWork w, const float* __restrict__ beta2_p,
            const float* __restrict__ lr_p, const AfScalars sc, unsigned* __restrict__ ctr) {
  __shared__ float red[AF_RED];
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
  const BlockRed<2, 1> r = block_reduce<2, 1>({uacc, pacc}, {0.f}, false, red, AF_THREADS);
  if (threadIdx.x == 0) {
    w.upart[blockIdx.x] = r.s[0];
    w.ppart[blockIdx.x] = r.s[1];
  }
  if (last_block(&ctr[3])) {
    finish_scalars(w.upart, w.nu, nullptr, w.ppart, w.nparts, sh.N, lr_p, sc, 1.f, w.scal, red,
                   AF_THREADS);
    if (threadIdx.x == 0) ctr[3] = 0;
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
// the C entry
// ---------------------------------------------------------------------------

enum AfPath { AF_PLAIN = 0, AF_ROWS = 1, AF_WIDE = 2 };

struct AfLaunch {
  AfLayers lay;
  AfShape sh;
  AfRows rw;
  AfScalars sc;
  AfWork w;
  float *v, *vc;
  const float *lr, *beta2;
  unsigned* ctr;
  int grid, grid2, sms, smem;
  cudaStream_t stream;
};

// Launches KERNEL with `args`; `coop`: cooperatively (every block resident
// at once, as a grid-wide barrier needs), the grid cut to what the card holds
// (no sum depends on the grid).  Dynamic shared memory above 48 KB is
// allowed once a kernel, its occupancy asked once a size.
template <auto KERNEL>
static cudaError_t launch(int grid, int smem, bool coop, const AfLaunch& a, void** args,
                          int threads = AF_THREADS) {
  static int allowed = 48 * 1024, occ_smem = -1, occ = 0;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  if (coop) {
    if (occ_smem != smem) {
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, KERNEL,
                                                                          threads, smem);
      if (e != cudaSuccess) return e;
      occ_smem = smem;
    }
    if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
    return cudaLaunchCooperativeKernel((const void*)KERNEL, min(grid, occ * a.sms), threads,
                                       args, smem, a.stream);
  }
  return cudaLaunchKernel((const void*)KERNEL, grid, threads, args, smem, a.stream);
}

template <typename TG, typename TP, int VEC>
static cudaError_t run_factored(AfLaunch& a, int path) {
  AfLaunch* p = &a;
  int force = path == AF_WIDE;
  cudaError_t err;
  if (path == AF_ROWS) {
    void* args[] = {&p->lay, &p->sh, &p->rw, &p->v, &p->vc, &p->w, &p->beta2, &p->lr, &p->sc,
                    &p->ctr};
    const bool coop = a.sh.S > 1;
    // the column registers a thread holds: KC vectors exactly for bf16 g and p
    // (every group of the models' trees), AF_MAX_KC otherwise
    constexpr int NT = AF_ROWS_THREADS;
    if constexpr (VEC == 8) {
      switch (a.rw.KC) {
        case 1: err = launch<af_rows_kernel<TG, TP, VEC, 1>>(a.grid, a.smem, coop, a, args, NT); break;
        case 2: err = launch<af_rows_kernel<TG, TP, VEC, 2>>(a.grid, a.smem, coop, a, args, NT); break;
        case 3: err = launch<af_rows_kernel<TG, TP, VEC, 3>>(a.grid, a.smem, coop, a, args, NT); break;
        default:
          err = launch<af_rows_kernel<TG, TP, VEC, AF_MAX_KC>>(a.grid, a.smem, coop, a, args, NT);
      }
    } else {
      err = launch<af_rows_kernel<TG, TP, VEC, AF_MAX_KC>>(a.grid, a.smem, coop, a, args, NT);
    }
  } else {
    void* args[] = {&p->lay, &p->sh, &p->v, &p->vc, &p->w, &p->beta2, &p->sc, &p->ctr};
    err = launch<af_wide_kernel<TG, TP, VEC>>(a.grid, 0, a.sh.S > 1, a, args);
  }
  if (err != cudaSuccess) return err;
  {
    void* args[] = {&p->lay, &p->sh, &p->v, &p->vc, &p->w, &force, &p->lr, &p->sc, &p->ctr};
    if ((err = launch<af_usq_kernel<TG, VEC>>(a.grid2, 0, false, a, args)) != cudaSuccess)
      return err;
  }
  void* args[] = {&p->lay, &p->sh, &p->v, &p->vc, &p->w.rmean, &p->w.scal, &p->sc};
  return launch<af_apply_kernel<TG, TP, VEC>>(a.grid2, 0, false, a, args);
}

template <typename TG, typename TP, int VEC>
static cudaError_t run_plain(AfLaunch& a, long long total) {
  AfLaunch* p = &a;
  void* args[] = {&p->lay, &p->sh, &total, &p->v, &p->w, &p->beta2, &p->lr, &p->sc, &p->ctr};
  cudaError_t err = launch<af_v_kernel<TG, TP, VEC>>(a.grid, 0, false, a, args);
  if (err != cudaSuccess) return err;
  void* args2[] = {&p->lay, &p->sh, &total, &p->v, &p->w.scal, &p->sc};
  return launch<af_vapply_kernel<TG, TP, VEC>>(a.grid, 0, false, a, args2);
}

template <typename TG, typename TP>
static cudaError_t run_types(AfLaunch& a, int path, int vec, long long total) {
  if (path != AF_PLAIN) {
    if (vec == 1) return run_factored<TG, TP, 1>(a, path);
    if (vec == 4) return run_factored<TG, TP, 4>(a, path);
    if constexpr (sizeof(TG) == 2 && sizeof(TP) == 2)
      if (vec == 8) return run_factored<TG, TP, 8>(a, path);
    return cudaErrorInvalidValue;
  }
  if (vec == 1) return run_plain<TG, TP, 1>(a, total);
  if (vec == 4) return run_plain<TG, TP, 4>(a, total);
  return cudaErrorInvalidValue;
}

// The shared memory af_rows_kernel takes (kernels/adafactor.py `rows_smem`).
static long long rows_smem(const AfRows& rw, int vec) {
  const int NW = AF_ROWS_THREADS / 32, TR16 = rw.TR > NW ? rw.TR : NW;
  const long long taccn = rw.LANES < AF_ROWS_THREADS ? (long long)AF_ROWS_THREADS * vec : 0;
  return (long long)rw.ST * rw.stage_bytes + 4LL * (2 * taccn + 2 * TR16 + rw.TR + AF_RED) + 8
         + 8LL * rw.ST;
}

// g_ptrs, p_ptrs: the group's `layers` layers of n elements each (g of
// g_dtype, p of p_dtype: g in p's dtype, or fp32 g for bf16 p as gradient
// accumulation gives it), contiguous.  path: AF_PLAIN (v: layers x n floats,
// `grid` blocks walk the elements), AF_ROWS or AF_WIDE (M matrices of R x C,
// n a multiple of C; v = vr (M R floats), vc (M C floats); slab_rows rows a
// slab of (a), `slabs` a matrix, on `grid` blocks at most; slab_rows2,
// slabs2 and grid2 those of (b) and (c)); AF_ROWS also tile_rows, stages,
// lanes and kc (AfRows), and every base and row 16-byte aligned (TMA).  ws:
// the workspace, ctr: 4 counters left at 0 (kernels/adafactor.py
// `launch_plan`, `counters`).  lr, beta2: one fp32 each in device memory.
// vec: elements a thread loads at once (8: bf16 g and p aligned to 16
// bytes; 4: aligned to four elements; 1).  Launches the passes on `stream`
// and returns the first error.
extern "C" int adafactor_launch(const void* const* g_ptrs, void* const* p_ptrs, int layers,
                                long long n, long long M, long long R, long long C, int path,
                                int slab_rows, int slabs, int grid, int slab_rows2, int slabs2,
                                int grid2, int vec, int tile_rows, int stages, int lanes, int kc,
                                int sms, int p_dtype, int g_dtype, float* v, float* vc,
                                float* ws, unsigned* ctr, const float* lr, const float* beta2,
                                float eps1, float eps2, float clip, float wd, void* stream) {
  if (layers < 1 || layers > AF_MAX_LAYERS || n <= 0 || grid < 1 || sms < 1 || path < 0
      || path > 2)
    return (int)cudaErrorInvalidValue;
  const bool fac = path != AF_PLAIN;
  if (fac && (C <= 0 || R <= 0 || M <= 0 || n % C != 0 || slab_rows < 1 || C % vec != 0
              || (n / C != 1 && (n / C) % R != 0)
              || (long long)slab_rows * slabs < R || (long long)slab_rows * (slabs - 1) >= R
              || slab_rows2 < 1 || slab_rows2 > AF_MAX_SLAB || (long long)slab_rows2 * slabs2 < R
              || (long long)slab_rows2 * (slabs2 - 1) >= R || grid2 < 1))
    return (int)cudaErrorInvalidValue;
  if (path == AF_WIDE && slab_rows > AF_MAX_SLAB) return (int)cudaErrorInvalidValue;
  AfLaunch a;
  if (path == AF_ROWS) {
    const int RG = lanes > 0 ? AF_ROWS_THREADS / lanes : 0, NW = AF_ROWS_THREADS / 32;
    if (tile_rows < 1 || tile_rows > AF_MAX_TILE || stages < 2 || stages > AF_MAX_STAGES
        || lanes < 1 || RG * lanes != AF_ROWS_THREADS || (long long)lanes * kc * vec < C
        || kc < 1 || kc > AF_MAX_KC || (RG > 1 && kc != 1)
        || (tile_rows < NW && NW % tile_rows != 0))
      return (int)cudaErrorInvalidValue;
    const int sg = g_dtype == DT_BF16 ? 2 : 4, sp = p_dtype == DT_BF16 ? 2 : 4;
    if ((C * sg) % 16 != 0 || (C * sp) % 16 != 0) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < layers; ++i)
      if (reinterpret_cast<uintptr_t>(g_ptrs[i]) % 16 || reinterpret_cast<uintptr_t>(p_ptrs[i]) % 16)
        return (int)cudaErrorInvalidValue;
    // a stage: the tile's rows of g, of p, and their vr, each part 16-byte aligned
    const long long gb = ((long long)tile_rows * C * sg + 15) / 16 * 16;
    const long long pb = ((long long)tile_rows * C * sp + 15) / 16 * 16;
    const long long rb = ((long long)tile_rows * 4 + 15) / 16 * 16;
    a.rw = AfRows{tile_rows, stages, tile_rows >= NW ? 1 : NW / tile_rows, lanes, kc,
                  (int)(gb + pb + rb), (int)gb, (int)(gb + pb)};
    const long long smem = rows_smem(a.rw, vec);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    a.smem = (int)smem;
  } else {
    a.rw = AfRows{};
    a.smem = 0;
  }
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
  a.sh.rpl = fac ? n / C : 0;
  a.sh.M = M;
  a.sh.R = R;
  a.sh.C = C;
  a.sh.SR = slab_rows;
  a.sh.S = slabs;
  a.sh.slabs = fac ? M * slabs : 0;
  a.sh.SR2 = slab_rows2;
  a.sh.S2 = slabs2;
  a.sh.slabs2 = fac ? M * slabs2 : 0;
  a.sh.N = (float)total;
  a.sc = AfScalars{eps1, eps2, clip, wd};
  a.v = v;
  a.vc = vc;
  a.lr = lr;
  a.beta2 = beta2;
  a.ctr = ctr;
  a.grid = grid;
  a.grid2 = fac ? grid2 : grid;
  a.sms = sms;
  a.stream = (cudaStream_t)stream;
  // the workspace, in floats: scal (4), vr's means (M); plain: p^2 and u^2
  // partials a block; factored: p^2 a slab of (a) (M S), u^2 an item (rows,
  // S > 1: M ceil(C / 32)) or a matrix (rows, S = 1: M) and a fail flag
  // each (rows only), u^2 a slab of (b) (M S2), then (S > 1) vr's slab sums
  // (M S), the least vr a slab (rows: M S), the column partials (M S x C)
  // and W's (rows: M S x C)
  AfWork& w = a.w;
  w = AfWork{};
  w.scal = ws;
  if (!fac) {
    w.ppart = ws + 4;
    w.upart = w.ppart + grid;
    w.nparts = w.nu = grid;
    return (int)(g_dtype == DT_BF16 && p_dtype == DT_BF16
                     ? run_types<__nv_bfloat16, __nv_bfloat16>(a, path, vec, total)
                 : g_dtype == DT_F32 && p_dtype == DT_F32
                     ? run_types<float, float>(a, path, vec, total)
                 : g_dtype == DT_F32 && p_dtype == DT_BF16
                     ? run_types<float, __nv_bfloat16>(a, path, vec, total)
                     : cudaErrorInvalidValue);
  }
  const long long ms = M * slabs;
  w.rmean = ws + 4;
  w.ppart = w.rmean + M;
  w.nparts = ms;
  float* next = w.ppart + ms;
  if (path == AF_ROWS) {
    w.nu = slabs > 1 ? M * ((C + 31) / 32) : M;
    w.upart = next;
    w.ufail = w.upart + w.nu;
    next = w.ufail + w.nu;
  }
  w.upart2 = next;
  w.nu2 = M * slabs2;
  next = w.upart2 + w.nu2;
  if (slabs > 1) {
    w.vrpart = next;
    next += ms;
    if (path == AF_ROWS) {
      w.minvr = next;
      next += ms;
    }
    w.colpart = next;
    next += ms * C;
    if (path == AF_ROWS) w.wpart = next;
  }
  if (g_dtype == DT_BF16 && p_dtype == DT_BF16)
    return (int)run_types<__nv_bfloat16, __nv_bfloat16>(a, path, vec, total);
  if (g_dtype == DT_F32 && p_dtype == DT_F32)
    return (int)run_types<float, float>(a, path, vec, total);
  if (g_dtype == DT_F32 && p_dtype == DT_BF16)
    return (int)run_types<float, __nv_bfloat16>(a, path, vec, total);
  return (int)cudaErrorInvalidValue;
}
