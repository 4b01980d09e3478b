// Hopper (sm_90a) building blocks, written as inline PTX: shared-memory
// barriers (mbarrier), TMA tile loads, wgmma descriptors and products, and
// register rebalancing between warpgroups; the tile products built from them
// and the host's tensor maps.  Used by flash_attention.cu (the forward) and
// flash_attention_bwd.cu (the backward).
//
// Conventions.  Every tile that wgmma reads lies in shared memory as rows of
// 128 bytes (64 bf16), written by TMA with CU_TENSOR_MAP_SWIZZLE_128B, in
// regions aligned to 1024 bytes (one swizzle atom: 8 rows of 128 bytes).
// A wider row is cut into 64-element column chunks, each chunk a region of
// its own.
#pragma once

#include <cuda.h>   // CUtensorMap (the type only: nothing links against libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that never
// ends (a broken pipeline) traps, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  uint32_t tries = 0;
  do {
    if (++tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -----------------------------------------------------------------

// One box of a 4-D tensor map into shared memory; completion is reported to
// `bar` as transaction bytes.  Coordinates are in elements, innermost first;
// what lies outside the tensor arrives as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) of global memory from 16-byte aligned `src` into
// shared memory, completion reported to `bar` as transaction bytes: a bulk
// copy without a tensor map.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- named barriers between warpgroups -------------------------------------

// Barrier `id` (1-15; 0 is __syncthreads) of `threads` threads: sync waits for
// all of them, arrive counts this thread in and goes on.  What a thread wrote
// to shared memory before it arrived is seen by a thread after its sync.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- register rebalancing between warpgroups ------------------------------

template <int N> __device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading-dimension byte offset (LBO) and stride-dimension byte offset (SBO),
// each in 16-byte units, layout type 1 (SWIZZLE_128B) in bits 62-63.
//   K-major operand (K contiguous): SBO = 1024 (next group of 8 rows), LBO unused;
//     the next 16 values of K start 32 bytes further inside the swizzle atom.
//   MN-major operand (MN contiguous): LBO = distance to the next 64-element
//     chunk of MN, SBO = 1024 (next group of 8 rows of K).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t smem_addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous products (which would force it to serialise them).
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// Accumulator fragment of m64nNk16 (N/2 floats a thread), warp w of the
// warpgroup, lane l:  d[4j + 2h + e] is row 16w + l/4 + 8h, column
// 8j + 2(l%4) + e.  The register A operand of k16 has the same shape as two
// n8 blocks of it: {d[8k..8k+7]} of S, rounded to bf16 pairs, is the A
// fragment of the k-th 16 columns.

#define WG_F4(i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define WG_F16(i) WG_F4(i), WG_F4((i) + 4), WG_F4((i) + 8), WG_F4((i) + 12)
#define WG_F32(i) WG_F16(i), WG_F16((i) + 16)
#define WG_F64(i) WG_F32(i), WG_F32((i) + 32)
#define WG_F128(i) WG_F64(i), WG_F64((i) + 64)

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]; A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_F32(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]; A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F64(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]; A from registers (bf16 pairs), B from
// shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]; A from registers (bf16 pairs), B from
// shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_F64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 192] (+)= A[64 x 16] * B[16 x 192]; A from registers (bf16 pairs), B from
// shared memory, MN-major (transposed): the backward's dK += dS^T Q and dQ += dS K
// at MLA's q/k head dim.
__device__ __forceinline__ void wgmma_rs_n192(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : WG_F64(0), WG_F32(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 256] (+)= A[64 x 16] * B[16 x 256]; A from registers (bf16 pairs), B from
// shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_F128(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef WG_F4
#undef WG_F16
#undef WG_F32
#undef WG_F64
#undef WG_F128

// ---- tile products ----------------------------------------------------------

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db, int acc) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256, "wgmma_rs widths");
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, acc);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db, acc);
  else if constexpr (N == 192) wgmma_rs_n192(d, a, db, acc);
  else wgmma_rs_n256(d, a, db, acc);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N, typename R> __device__ __forceinline__ void fence_all(R* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}

// S = Q K^T of one tile: D/16 products m64 n(BK) k16, both operands K-major
// (64 rows of Q, BK of K, D each).  Any A B^T of two such tiles: the
// backward's S^T = K Q^T, dP^T = V dO^T, dP = dO V^T.
template <int D, int BK>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t q_addr, uint32_t k_addr) {
  static_assert(BK == 64 || BK == 128, "S tiles are m64n64 or m64n128");
  fence_all<BK / 2>(sc);
  wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const uint32_t off = (kd % 4) * 32;   // 16 values further inside the swizzle atom
    const uint64_t da = gmma_desc(q_addr + (kd / 4) * 64 * 128 + off, 16, 1024);
    const uint64_t db = gmma_desc(k_addr + (kd / 4) * BK * 128 + off, 16, 1024);
    if constexpr (BK == 64) wgmma_ss_n64(sc, da, db, kd > 0);
    else wgmma_ss_n128(sc, da, db, kd > 0);
  }
  wgmma_commit();
}

// O += P V of one tile: BK/16 products m64 n(D) k16, P from registers, V
// (BK x D) through a transposed (MN-major) descriptor.  Also the backward's
// dV += P^T dO, dK += dS^T Q and dQ += dS K.
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float* o, uint32_t* pa, uint32_t v_addr) {
  fence_all<D / 2>(o);
  fence_all<BK / 4>(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = gmma_desc(v_addr + kk * 16 * 128, BK * 128, 1024);
    wgmma_rs<D>(o, &pa[4 * kk], db, 1);
  }
  wgmma_commit();
}

// ---- host side: tensor maps -------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A bf16 (B, heads, S, D) view with element strides (sb, sh, ss) as a 4-D map
// over (D, S, heads, B), read in boxes of 64 x `rows`, 128-byte swizzle.
static bool make_map(CUtensorMap* map, const void* ptr, int B, int heads, int S, int D,
                     long long sb, long long sh, long long ss, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
