// Flash-attention forward (online softmax), GQA, causal / sliding-window masks.
//
// Replaces the TPU kernel `_flash_kernel` of src/repro/kernels/flash_attention.py
// (driven by `flash_attention`).  That kernel gets its KV loop from a
// sequential innermost grid axis with (m, l, acc) kept in scratch between
// grid steps.  Here blocks run in parallel and in no order, so one block
// owns one (batch, q head, q tile) and walks the KV tiles itself, with
// (m, l, acc) in registers.
//
// On this card the function is bound by operations (4*Sq*Sk*D a head, half
// of it under a causal mask, against Sq*D + 2*Sk*D elements moved), so the
// bf16 path is built around the tensor cores:
//
//   * bf16 (`flash_fwd_tc_kernel`): a warp-specialised block.  Warpgroup 0
//     is the producer (at D = 64 one warp after the consumer warpgroup):
//     one thread issues TMA loads (Q once; K and V tiles into a ring of
//     STAGES stages, each with a full barrier for K, one for V and an empty
//     barrier), and the warpgroup gives registers to the consumer
//     (setmaxnreg).  At D = 128 (`flash_fwd_tc2_kernel`) two consumer
//     warpgroups share the ring and take turns at the tensor cores (TcPlan
//     says why).  A consumer warpgroup owns 64 q rows:
//     S = Q K^T by wgmma with both operands in shared memory (128-byte
//     swizzle, K-major), the online softmax on the accumulator fragment in
//     registers (exp2 with scale * log2(e) folded in, a row's max and sum
//     over the 4 threads of a quad, masks only on tiles that straddle the
//     causal diagonal, the window edge or the end of K), then O += P V by a
//     second wgmma with P rounded to bf16 in registers as its A operand and V
//     read through a transposed (MN-major) descriptor.  O stays in fp32
//     registers.  The one numeric difference from the fp32 reference is P's
//     rounding to bf16 before P V.
//   * float32 (`flash_fwd_kernel`): fp32 FMAs.  TF32 tensor cores would keep
//     about three decimal digits and miss the float32 tolerance of 2e-5, so
//     this path stays on the CUDA cores.
//
// Both paths skip KV tiles that the causal or window mask kills entirely and
// schedule the heaviest q tiles (the last ones under a causal mask) first:
// of each head, or at D 128 and D 256 on the tensor cores of all heads
// (TcPlan).
//
// Each kernel has a compile-time variant (LSE = true) that also writes the
// row log-sum-exp of the scaled scores, (B, H, Sq) in fp32, for the backward
// kernels of flash_attention_bwd.cu.  It differs only in the epilogue; the
// serving path launches the LSE = false instantiation, which is the kernel
// as it was.
//
// Head dims: one D for q, k and v (64, 128 or 256), or MLA's prefill, whose
// q and k have a head dim DQK = 192 (128 of the latent's up projection and
// 64 rotary) and v a head dim DV = 128.  Every kernel is a template over
// (DQK, DV); a single-D instantiation is (D, D) and compiles to the kernel
// it was before MLA.  At (192, 128) the bf16 kernel is the one-consumer one
// with a longer contraction than D = 128's: S = Q K^T runs 12 wgmma k-steps
// of 16 where D = 128 runs 8, Q and each K tile arrive as three 64-column TMA
// boxes, V as two, and O += P V keeps N = 128 and its accumulators (64 x 128
// fp32 a warpgroup), so the consumer's registers are those of D = 128.  Its K/V
// ring has two stages (104 KB of shared memory, two blocks an SM): on an
// H100 that ran 1.5x as fast as three stages (144 KB, one block an SM).
//
// Layout: q (B,H,Sq,DQK), k (B,Hkv,Sk,DQK), v (B,Hkv,Sk,DV), o (B,H,Sq,DV),
// each with free strides over its first three dims and stride 1 over the
// head dim, so the model's (B,S,H,D) tensors are read where they lie: the
// bf16 path's tensor maps are 4-D over (D, S, H, B) with the view's own
// strides.
#include "common.cuh"
#include "hopper.cuh"

// ===========================================================================
// float32: FMA kernel
// ===========================================================================

#define FA_THREADS 256
#define FA_BQ 64     // q rows a block
#define FA_BK 32     // kv rows a tile

struct FlashParams {
  const void* q; const void* k; const void* v; void* o;
  float* lse;   // (B, H, Sq) contiguous, written by the LSE variant only
  int H, Hkv, Sq, Sk;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int causal, window;
  float scale;
};

template <int DQK, int DV> struct FlashSmem {
  static constexpr int QS = DQK + 4;    // row stride of Qs and Ks (floats): 16-B aligned, and
                                        // (QS/4) odd, so 8 rows hit 8 distinct 16-B bank groups
  static constexpr int PS = FA_BK + 4;  // row stride of Ps
  static constexpr int FLOATS = FA_BQ * QS + FA_BK * QS + FA_BK * DV + FA_BQ * PS;
};

template <typename T, int DQK, int DV, bool LSE>
__global__ void __launch_bounds__(FA_THREADS) flash_fwd_kernel(const FlashParams p) {
  constexpr int QS = FlashSmem<DQK, DV>::QS, PS = FlashSmem<DQK, DV>::PS;
  constexpr int DC = DV / 16;  // output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + FA_BQ * QS;
  float* Vs = Ks + FA_BK * QS;
  float* Ps = Vs + FA_BK * DV;

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
  for (int c = tid; c < FA_BQ * (DQK / 4); c += FA_THREADS) {
    const int r = c / (DQK / 4), d4 = (c % (DQK / 4)) * 4;
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
    // K and V tiles -> shared memory, rows past Sk as zeros: in one pass
    // where they share a head dim, else V in a pass of its own.
    for (int c = tid; c < FA_BK * (DQK / 4); c += FA_THREADS) {
      const int r = c / (DQK / 4), d4 = (c % (DQK / 4)) * 4;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (k0 + r < p.Sk) {
        kv4 = load4<T>(kp + (long long)(k0 + r) * p.k_ss + d4);
        if constexpr (DQK == DV) vv4 = load4<T>(vp + (long long)(k0 + r) * p.v_ss + d4);
      }
      *reinterpret_cast<float4*>(&Ks[r * QS + d4]) = kv4;
      if constexpr (DQK == DV) *reinterpret_cast<float4*>(&Vs[r * DV + d4]) = vv4;
    }
    if constexpr (DQK != DV) {
      for (int c = tid; c < FA_BK * (DV / 4); c += FA_THREADS) {
        const int r = c / (DV / 4), d4 = (c % (DV / 4)) * 4;
        float4 vv4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + r < p.Sk) vv4 = load4<T>(vp + (long long)(k0 + r) * p.v_ss + d4);
        *reinterpret_cast<float4*>(&Vs[r * DV + d4]) = vv4;
      }
    }
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, columns tx + 16 j.
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) { s[i][0] = 0.f; s[i][1] = 0.f; }
#pragma unroll 4
    for (int d = 0; d < DQK; d += 4) {
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
          const float vv = Vs[(t + tt) * DV + tx + 16 * j];
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
      if constexpr (LSE) {
        // m is in natural units of the scaled score; l its row's sum
        if (tx == 0) p.lse[((long long)b * p.H + h) * p.Sq + q_pos] = m[i] + logf(fmaxf(l[i], 1e-30f));
      }
    }
  }
}


// ===========================================================================
// bf16: TMA + wgmma kernel
// ===========================================================================

// Tile plan of the bf16 kernels; kernels/flash_attention.py `tile_plan`
// mirrors it (and chip_smoke.py holds the two against each other).  One
// consumer warpgroup of 64 q rows a block (`flash_fwd_tc_kernel`): at D 128
// and (192, 128) two such blocks share an SM, and at D = 256 a block of two
// ran out of registers.
//
// At D = 128 where q and k both hold PAIR_MIN_KEYS rows or more (PAIR,
// `flash_fwd_tc2_kernel`) a block is two consumer warpgroups of 64 q rows
// each (128 q rows) that share each K/V stage and issue their products in
// turns, ordered by named barriers, so that one warpgroup's softmax runs
// while the tensor cores work through the other's products: with one
// consumer warpgroup a block, two blocks an SM, the consumer ran S = Q K^T,
// waited, ran the softmax with its tensor cores idle, then P V, and only the
// other block, in no order, could cover that time (a block of two consumers
// without that order lost to it by 8-12 % at the serving shapes on an H100).
// The kv tiles are 128 rows, which halves the work around the products a
// key (barrier round trips, waits, the row maxima's shuffles, O's
// rescaling), in a ring of three stages of 64 KB; a producer warpgroup loads
// them and gives registers to the consumers (setmaxnreg 24 / 240): 384
// threads, one block an SM.  ptxas keeps a thread under the launch bounds'
// share (168) whatever setmaxnreg later moves, and the consumer fits in it
// (O is 64 registers, S 64 and P 32).  A row's maximum runs over 128 keys a
// step, so the output is not the 64-row plan's bits.  Timed in turns against
// the one-consumer plan of 64-row tiles on an H100 (kernels/variants/
// k1_fwd128_*.patch, PERF.md), at
// yi-34b's S2048 prefill: this plan 0.91 of its time; the flat grid alone
// 0.96; two consumers of 64-row tiles 1.20; two consumers without producer
// warps (256 threads, a consumer thread refilling the ring) 0.97, and 0.98
// with each consumer's next S = Q K^T issued before its P V; the producer
// plan so overlapped 1.19.  Shorter sequences take the one-consumer plan on
// the flat grid, which keeps the one-consumer plan's bits.
//
// At D = 256 (FLAT) the grid is one-dimensional, every head's last q tile
// first, then every head's tile before it, and so on: one block fills an SM
// there, and under a causal mask the grid of (q tile, head) put the heavy
// last tiles of the later heads behind the light tiles of the first ones, so
// that a heavy tile started late and ran alone at the end (heaviest first
// over the whole grid ran recurrentgemma's S1000 prefill in 0.79 of the time
// on an H100).  A block of two consumers of 64 q rows sharing each K/V stage
// (128 q rows, their products issued in turns), and one consumer issuing the
// next tile's S = Q K^T before this tile's P V to compute the next softmax
// under it, both ran slower at D 256 on an H100 and were dropped; they are
// kept as patches against the tree they were written for (kernels/variants/
// k1_fwd256_{pingpong,overlap}.patch, timed by chip_smoke.py --variant).
//
// At D = 64 (LEAN) a 64 x 64 tile's softmax (4,096 exponentials on the SM's
// special-function units) takes as long as its two products on the tensor
// cores, and the per-tile work around them (the barrier round trips, the
// waits, the row maxima's shuffles, O's rescaling) is no smaller than at D
// 128: so the plan there takes kv tiles of 128 rows, which halves that work
// a key, and three blocks an SM.  S is then 64 registers a thread and P 32,
// O 32: the producer is one warp after the consumer warpgroup (160 threads),
// which leaves a consumer thread ptxas's cap of 128 registers at three
// blocks an SM, where a producer warpgroup leaves it 80 (ptxas keeps a
// thread under the launch bounds' cap whatever setmaxnreg later moves), and
// the ring two stages of 32 KB.  A row's maximum now runs over 128 keys a
// step, so the output is not the 64-row plan's bits.  Tried and slower on an
// H100 (kernels/variants/k1_fwd64_*.patch): three blocks of 64-row tiles,
// with a producer warp or with a producer warpgroup and setmaxnreg 24 / 136
// (which spilled), the consumer computing tile j's softmax under tile j - 1's
// P V (ptxas serialised its products), and 128-row tiles at two blocks an SM.
template <int DQK, int DV, bool PAIRED = false> struct TcPlan {
  static_assert(!PAIRED || (DQK == 128 && DV == 128), "two consumer warpgroups at D 128 only");
  static constexpr bool PAIR = PAIRED;   // two consumer warpgroups in turns
  static constexpr bool FLAT = DQK == DV && (DQK == 128 || DQK == 256);   // heaviest q tiles first, all heads
  static constexpr bool LEAN = DQK == 64 && DV == 64;
  static constexpr int BQ = PAIR ? 128 : 64;        // q rows a block
  static constexpr int BK = LEAN || PAIR ? 128 : 64;        // kv rows a tile
  static constexpr int STAGES = PAIR ? 3 : DQK != DV || LEAN ? 2 : 3;  // K/V ring depth
  static constexpr int CH_QK = DQK / 64; // 128-byte column chunks of Q and K
  static constexpr int CH_V = DV / 64;   // and of V
  // A producer warpgroup before the consumer warpgroups, or (LEAN) one
  // producer warp after the consumer: warpgroup PRODUCER_WG holds the producer.
  static constexpr int PRODUCER_WARPS = LEAN ? 1 : 4;
  static constexpr int PRODUCER_WG = PRODUCER_WARPS == 4 ? 0 : 1;
  static constexpr int CONSUMERS = PAIR ? 2 : 1;   // warpgroups of 64 q rows
  static constexpr int THREADS = 128 * CONSUMERS + 32 * PRODUCER_WARPS;
  static constexpr int Q_BYTES = BQ * DQK * 2;
  static constexpr int K_BYTES = BK * DQK * 2;  // K of one stage
  static constexpr int V_BYTES = BK * DV * 2;   // V of one stage
  static constexpr int BAR_BYTES = 256;
  static constexpr int SMEM = Q_BYTES + STAGES * (K_BYTES + V_BYTES) + BAR_BYTES;
  // Three blocks an SM at D = 64, else two where they fit (each with 1 KB
  // reserved, in an SM's 228 KB); D = 256 and PAIR take one, so that ptxas
  // may give a thread up to 255 registers.
  static constexpr int MIN_BLOCKS = LEAN ? 3 : 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
  // Registers moved from the producer warpgroup to the consumers with
  // setmaxnreg, where the launch bounds cap a thread at 128 (40 + 216 = 2 *
  // 128) or, PAIR, at 168 (24 + 2 * 240 = 3 * 168).
  static constexpr bool REBALANCE = PRODUCER_WARPS == 4 && (MIN_BLOCKS == 2 || PAIR);
  static constexpr int PRODUCER_REGS = PAIR ? 24 : 40;
  static constexpr int CONSUMER_REGS = PAIR ? 240 : 216;
  // MIN_BLOCKS blocks, with 1 KB reserved for each, in an SM's 228 KB.
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 233472, "shared memory of an sm_90 SM");
  static_assert((3 * STAGES + 1) * 8 <= BAR_BYTES, "barriers");
  static_assert(!PAIR || MIN_BLOCKS == 1, "the two-consumer block fills an SM");
};

// D 128 takes the two-consumer plan where q and k both hold at least so many
// rows (12 kv tiles of 128), else the one-consumer plan of 64-row tiles on the
// flat grid: on an H100 the two-consumer block ran the dense models' S2048
// train shapes in 0.80-0.91 of the time of the one-consumer plan on a grid
// of (q tile, head), and the one-consumer plan on the flat grid in 0.85-0.96,
// but at S1000 the flat grid won (0.76-0.97 against 0.80-0.99),
// and at S333 or with fewer blocks than SMs the 128-row blocks left SMs idle
// (1.28x); kernels/flash_attention.py `PAIR_MIN_KEYS` mirrors it.
#define PAIR_MIN_KEYS 1536
static bool pairs(int Dqk, int Dv, int Sq, int Sk) {
  return Dqk == 128 && Dv == 128 && Sq >= PAIR_MIN_KEYS && Sk >= PAIR_MIN_KEYS;
}

struct TcParams {
  __nv_bfloat16* o;
  float* lse;   // (B, H, Sq) contiguous, written by the LSE variant only
  long long o_sb, o_sh, o_ss;
  int H, Hkv, Sq, Sk, causal, window;
  float scale_log2;   // softmax scale * log2(e)
};

__device__ __forceinline__ bool visible(int q, int k, const TcParams& p) {
  return k < p.Sk && (!p.causal || k <= q) && (p.window <= 0 || k > q - p.window);
}

// Running max (log2 units) and this thread's share of the running sum of
// its two rows.
struct Rows { float m0, m1, l0, l1; };

// Online softmax of one S tile held as the accumulator fragment: masks it
// where `edge`, updates the rows' max and sum, writes P = exp2(S * scale_log2
// - m) as bf16 pairs in the A-operand layout, and returns the factors by
// which O must be rescaled (a row's max and sum over the 4 threads of a
// quad: two shuffles each; the sum's quad total is taken at the end).
template <int BK>
__device__ __forceinline__ float2 softmax_tile(float* sc, uint32_t* pa, int k0, int r0, int cq,
                                               bool edge, const TcParams& p, Rows& rw) {
  if (edge) {
#pragma unroll
    for (int jb = 0; jb < BK / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * jb + cq + e;
        if (!visible(r0, col, p)) sc[4 * jb + e] = -INFINITY;
        if (!visible(r0 + 8, col, p)) sc[4 * jb + 2 + e] = -INFINITY;
      }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int jb = 0; jb < BK / 8; ++jb) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * jb], sc[4 * jb + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * jb + 2], sc[4 * jb + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // New maxima in log2 units (the scale is positive); >= MAX_FLOOR, so finite.
  const float mn0 = fmaxf(rw.m0, mx0 * p.scale_log2), mn1 = fmaxf(rw.m1, mx1 * p.scale_log2);
  const float c0 = fast_exp2(rw.m0 - mn0), c1 = fast_exp2(rw.m1 - mn1);
  rw.m0 = mn0;
  rw.m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int jb = 0; jb < BK / 8; ++jb) {
    const float p00 = fast_exp2(fmaf(sc[4 * jb], p.scale_log2, -mn0));
    const float p01 = fast_exp2(fmaf(sc[4 * jb + 1], p.scale_log2, -mn0));
    const float p10 = fast_exp2(fmaf(sc[4 * jb + 2], p.scale_log2, -mn1));
    const float p11 = fast_exp2(fmaf(sc[4 * jb + 3], p.scale_log2, -mn1));
    rs0 += p00 + p01;
    rs1 += p10 + p11;
    pa[2 * jb] = pack_bf16(p00, p01);
    pa[2 * jb + 1] = pack_bf16(p10, p11);
  }
  rw.l0 = rw.l0 * c0 + rs0;
  rw.l1 = rw.l1 * c1 + rs1;
  return make_float2(c0, c1);
}

template <int D> __device__ __forceinline__ void scale_rows(float* o, float2 c) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    o[4 * i] *= c.x;
    o[4 * i + 1] *= c.x;
    o[4 * i + 2] *= c.y;
    o[4 * i + 3] *= c.y;
  }
}

// Epilogue of a consumer warpgroup: O / max(l, 1e-30), rounded to bf16, into
// the strided output at this thread's rows r0 and r0 + 8 (those below Sq),
// and for LSE the rows' log-sum-exp.
template <int DV, bool LSE>
__device__ __forceinline__ void store_rows(const float* o, const Rows& rows, int r0, int cq, int b,
                                           int h, const TcParams& p) {
  float l0 = rows.l0, l1 = rows.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* op = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) {
    const int col = 8 * i + cq;
    if (r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(op + (long long)r0 * p.o_ss + col) =
          pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    if (r0 + 8 < p.Sq)
      *reinterpret_cast<uint32_t*>(op + (long long)(r0 + 8) * p.o_ss + col) =
          pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
  }
  if constexpr (LSE) {
    // the rows' max is in log2 units of the scaled score: lse = (m + log2 l) ln 2
    if ((threadIdx.x & 3) == 0) {
      float* lp = p.lse + ((long long)b * p.H + h) * p.Sq;
      if (r0 < p.Sq) lp[r0] = (rows.m0 + log2f(fmaxf(l0, 1e-30f))) * 0.6931471805599453f;
      if (r0 + 8 < p.Sq) lp[r0 + 8] = (rows.m1 + log2f(fmaxf(l1, 1e-30f))) * 0.6931471805599453f;
    }
  }
}

template <int DQK, int DV, bool LSE>
__global__ void __launch_bounds__(TcPlan<DQK, DV>::THREADS, TcPlan<DQK, DV>::MIN_BLOCKS)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const TcParams p) {
  using P = TcPlan<DQK, DV>;
  constexpr int BK = P::BK, ST = P::STAGES;
  // 128-byte swizzled tiles want 1024-byte aligned regions.
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  if (smem_u32(smem_raw) & 1023) __trap();
  uint8_t* q_s = smem_raw;                      // [CH_QK][64 rows][128 B]
  uint8_t* k_s = q_s + P::Q_BYTES;              // [ST][CH_QK][BK rows][128 B]
  uint8_t* v_s = k_s + ST * P::K_BYTES;         // [ST][CH_V][BK rows][128 B]
  uint64_t* full_k = reinterpret_cast<uint64_t*>(v_s + ST * P::V_BYTES);
  uint64_t* full_v = full_k + ST;
  uint64_t* empty = full_v + ST;
  uint64_t* q_full = empty + ST;

  // last (heaviest under causal) q tiles first: of each head, or (FLAT) of all heads
  const int nq = (p.Sq + P::BQ - 1) / P::BQ, hb = P::FLAT ? gridDim.x / nq : 1;
  const int qt = P::FLAT ? nq - 1 - (int)(blockIdx.x / hb) : gridDim.x - 1 - blockIdx.x;
  const int h = P::FLAT ? blockIdx.x % hb % p.H : blockIdx.y;
  const int b = P::FLAT ? blockIdx.x % hb / p.H : blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * P::BQ;

  // KV range that some row of this q tile can see.
  const int q_last = min(q0 + P::BQ, p.Sq) - 1;
  int kv_hi = p.Sk;
  if (p.causal) kv_hi = min(kv_hi, q_last + 1);
  int kv_lo = 0;
  if (p.window > 0) {
    const int first = q0 - p.window + 1;
    if (first > 0) kv_lo = (first / BK) * BK;
  }
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 4);   // lane 0 of every consumer warp
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // Warp-uniform by construction (a broadcast), so that ptxas may treat the
  // two roles as regions of their own for setmaxnreg.
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == P::PRODUCER_WG) {
    // ---------------- producer ----------------
    if constexpr (P::REBALANCE) reg_dealloc<P::PRODUCER_REGS>();
    if (threadIdx.x == P::PRODUCER_WG * 128) {
      mbar_arrive_expect_tx(q_full, P::Q_BYTES);
#pragma unroll
      for (int c = 0; c < P::CH_QK; ++c)
        tma_load_4d(q_s + c * 64 * 128, &tq, q_full, c * 64, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(&empty[s], ((j / ST) - 1) & 1);
        const int k0 = kv_lo + j * BK;
        mbar_arrive_expect_tx(&full_k[s], P::K_BYTES);
#pragma unroll
        for (int c = 0; c < P::CH_QK; ++c)
          tma_load_4d(k_s + s * P::K_BYTES + c * BK * 128, &tk, &full_k[s], c * 64, k0, hk, b);
        mbar_arrive_expect_tx(&full_v[s], P::V_BYTES);
#pragma unroll
        for (int c = 0; c < P::CH_V; ++c)
          tma_load_4d(v_s + s * P::V_BYTES + c * BK * 128, &tv, &full_v[s], c * 64, k0, hk, b);
      }
    }
  } else {
    // ---------------- consumer: the 64 q rows ----------------
    if constexpr (P::REBALANCE) reg_alloc<P::CONSUMER_REGS>();
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const int r0 = q0 + warp * 16 + (lane >> 2);   // this thread's rows: r0 and r0 + 8
    const int cq = 2 * (lane & 3);                 // and columns cq, cq + 1 of every 8
    // Whether a tile needs the mask: it straddles the causal diagonal, the
    // window edge or the end of K (uniform over the warpgroup).
    auto edge = [&](int k0) {
      return (k0 + BK > p.Sk) || (p.causal && k0 + BK - 1 > q0) ||
             (p.window > 0 && k0 <= q0 + 63 - p.window);
    };
    auto k_addr = [&](int s) { return smem_u32(k_s + s * P::K_BYTES); };
    auto v_addr = [&](int s) { return smem_u32(v_s + s * P::V_BYTES); };

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    Rows rows{MAX_FLOOR, MAX_FLOOR, 0.f, 0.f};

    const uint32_t q_addr = smem_u32(q_s);
    mbar_wait(q_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST;
      const uint32_t par = (j / ST) & 1;
      const int k0 = kv_lo + j * BK;
      float sc[BK / 2];
      uint32_t pa[BK / 4];
      mbar_wait(&full_k[s], par);
      issue_qk<DQK, BK>(sc, q_addr, k_addr(s));
      wgmma_wait<0>();
      fence_all<BK / 2>(sc);
      scale_rows<DV>(o, softmax_tile<BK>(sc, pa, k0, r0, cq, edge(k0), p, rows));
      mbar_wait(&full_v[s], par);
      issue_pv<DV, BK>(o, pa, v_addr(s));
      wgmma_wait<0>();
      fence_all<DV / 2>(o);
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    store_rows<DV, LSE>(o, rows, r0, cq, b, h, p);
  }
}

// Named barriers of the two-consumer kernel (0 is __syncthreads): consumer w
// waits at FWD_TURN + w for its turn to issue products.
#define FWD_TURN 1

// PAIR: two consumer warpgroups of 64 q rows each share a block's K/V ring
// (TcPlan says why).  The block walks the kv tiles that some row of its 128
// sees (from consumer 0's first to consumer 1's last), and each consumer
// runs the one-consumer kernel's arithmetic over every tile of that walk.  A
// tile outside a consumer's own walk (under a window, consumer 0's causal
// diagonal) hides every key from its rows, takes the mask (`edge`), and
// leaves its max, sum and O as they were (a factor of exactly 1, P exactly
// 0).  Products under a branch made ptxas serialise every wgmma of a kernel,
// so no product is skipped.  Ping-pong: a consumer issues its S = Q K^T, and
// later its O += P V, only in its turn, and passes the turn on right after
// the issue, so that one consumer's softmax runs while the tensor cores work
// through the other's products; each takes two turns a tile, so the turns
// stay paired and consumer 0 leads by about half a tile.  The producer
// warpgroup's first thread loads Q (both halves; rows past Sq arrive as
// zeros) and the K/V tiles, each into the stage that the eight consumer warps
// have released (its empty barrier).
template <int DQK, int DV, bool LSE>
__global__ void __launch_bounds__(TcPlan<DQK, DV, true>::THREADS, 1)
    flash_fwd_tc2_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const TcParams p) {
  using P = TcPlan<DQK, DV, true>;
  static_assert(P::FLAT && P::REBALANCE && P::THREADS == 384, "the two-consumer plan");
  constexpr int BK = P::BK, ST = P::STAGES, QW = 64 * DQK * 2;   // one consumer's Q bytes
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  if (smem_u32(smem_raw) & 1023) __trap();
  uint8_t* q_s = smem_raw;                      // [2][CH_QK][64 rows][128 B]
  uint8_t* k_s = q_s + P::Q_BYTES;              // [ST][CH_QK][BK rows][128 B]
  uint8_t* v_s = k_s + ST * P::K_BYTES;         // [ST][CH_V][BK rows][128 B]
  uint64_t* full_k = reinterpret_cast<uint64_t*>(v_s + ST * P::V_BYTES);
  uint64_t* full_v = full_k + ST;
  uint64_t* empty = full_v + ST;
  uint64_t* q_full = empty + ST;

  // every head's last (heaviest under causal) q tile first
  const int nq = (p.Sq + P::BQ - 1) / P::BQ, hb = gridDim.x / nq;   // (q head, batch) pairs
  const int qt = nq - 1 - (int)(blockIdx.x / hb);
  const int h = blockIdx.x % hb % p.H, b = blockIdx.x % hb / p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * P::BQ;

  // KV range that some row of the block can see.
  const int q_last = min(q0 + P::BQ, p.Sq) - 1;
  int kv_hi = p.Sk;
  if (p.causal) kv_hi = min(kv_hi, q_last + 1);
  int kv_lo = 0;
  if (p.window > 0) {
    const int first = q0 - p.window + 1;
    if (first > 0) kv_lo = (first / BK) * BK;
  }
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;
  // tile j of the walk into stage j % ST (the producer's first thread)
  auto load_kv = [&](int j) {
    const int s = j % ST, k0 = kv_lo + j * BK;
    mbar_arrive_expect_tx(&full_k[s], P::K_BYTES);
#pragma unroll
    for (int c = 0; c < P::CH_QK; ++c)
      tma_load_4d(k_s + s * P::K_BYTES + c * BK * 128, &tk, &full_k[s], c * 64, k0, hk, b);
    mbar_arrive_expect_tx(&full_v[s], P::V_BYTES);
#pragma unroll
    for (int c = 0; c < P::CH_V; ++c)
      tma_load_4d(v_s + s * P::V_BYTES + c * BK * 128, &tv, &full_v[s], c * 64, k0, hk, b);
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 8);   // lane 0 of every consumer warp
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // Warp-uniform by construction (a broadcast), so that ptxas may treat the
  // roles as regions of their own for setmaxnreg.
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == 0) {
    // ---------------- producer ----------------
    reg_dealloc<P::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, 2 * QW);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int c = 0; c < P::CH_QK; ++c)
          tma_load_4d(q_s + w * QW + c * 64 * 128, &tq, q_full, c * 64, q0 + 64 * w, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        if (j >= ST) mbar_wait(&empty[j % ST], ((j / ST) - 1) & 1);
        load_kv(j);
      }
    }
    return;
  }
  reg_alloc<P::CONSUMER_REGS>();

  // consumer wg: q rows qw .. qw + 63
  const int wg = role - 1;
  const int qw = q0 + 64 * wg;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int r0 = qw + warp * 16 + (lane >> 2);   // this thread's rows: r0 and r0 + 8
  const int cq = 2 * (lane & 3);                 // and columns cq, cq + 1 of every 8
  // Whether a tile needs the mask for this consumer's rows: it straddles the
  // causal diagonal, the window edge or the end of K (uniform over the warpgroup).
  auto edge = [&](int k0) {
    return (k0 + BK > p.Sk) || (p.causal && k0 + BK - 1 > qw) ||
           (p.window > 0 && k0 <= qw + 63 - p.window);
  };
  auto k_addr = [&](int s) { return smem_u32(k_s + s * P::K_BYTES); };
  auto v_addr = [&](int s) { return smem_u32(v_s + s * P::V_BYTES); };
  const int turn = FWD_TURN + wg, other = FWD_TURN + 1 - wg;

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  Rows rows{MAX_FLOOR, MAX_FLOOR, 0.f, 0.f};

  const uint32_t q_addr = smem_u32(q_s + wg * QW);
  mbar_wait(q_full, 0);
  if (wg == 1) named_bar_arrive(FWD_TURN, 256);   // consumer 0 takes the first turn

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % ST;
    const uint32_t par = (j / ST) & 1;
    const int k0 = kv_lo + j * BK;
    float sc[BK / 2];
    uint32_t pa[BK / 4];
    mbar_wait(&full_k[s], par);
    named_bar_sync(turn, 256);
    issue_qk<DQK, BK>(sc, q_addr, k_addr(s));
    named_bar_arrive(other, 256);
    wgmma_wait<0>();
    fence_all<BK / 2>(sc);
    scale_rows<DV>(o, softmax_tile<BK>(sc, pa, k0, r0, cq, edge(k0), p, rows));
    mbar_wait(&full_v[s], par);
    named_bar_sync(turn, 256);
    issue_pv<DV, BK>(o, pa, v_addr(s));
    named_bar_arrive(other, 256);
    wgmma_wait<0>();
    fence_all<DV / 2>(o);
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (wg == 0) named_bar_sync(FWD_TURN, 256);     // the turn consumer 1 passed last
  store_rows<DV, LSE>(o, rows, r0, cq, b, h, p);
}

// ---- host side ------------------------------------------------------------

// The kernel of a plan: one consumer warpgroup a block, or (PAIR) two.
template <int DQK, int DV, bool PAIRED, bool LSE> static auto tc_kernel() {
  if constexpr (PAIRED) return flash_fwd_tc2_kernel<DQK, DV, LSE>;
  else return flash_fwd_tc_kernel<DQK, DV, LSE>;
}

template <int DQK, int DV, bool PAIRED, bool LSE>
static cudaError_t launch_plan(const FlashParams& f, int B, cudaStream_t stream) {
  using P = TcPlan<DQK, DV, PAIRED>;
  const auto kernel = tc_kernel<DQK, DV, PAIRED, LSE>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         P::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  CUtensorMap tq, tk, tv;   // Q in boxes of 64 rows: one a consumer warpgroup
  if (!make_map(&tq, f.q, B, f.H, f.Sq, DQK, f.q_sb, f.q_sh, f.q_ss, 64) ||
      !make_map(&tk, f.k, B, f.Hkv, f.Sk, DQK, f.k_sb, f.k_sh, f.k_ss, P::BK) ||
      !make_map(&tv, f.v, B, f.Hkv, f.Sk, DV, f.v_sb, f.v_sh, f.v_ss, P::BK))
    return cudaErrorInvalidValue;
  TcParams p;
  p.o = (__nv_bfloat16*)f.o;
  p.lse = f.lse;
  p.o_sb = f.o_sb; p.o_sh = f.o_sh; p.o_ss = f.o_ss;
  p.H = f.H; p.Hkv = f.Hkv; p.Sq = f.Sq; p.Sk = f.Sk;
  p.causal = f.causal; p.window = f.window;
  p.scale_log2 = f.scale * 1.4426950408889634f;
  const int nq = (f.Sq + P::BQ - 1) / P::BQ;
  const dim3 grid = P::FLAT ? dim3(nq * f.H * B) : dim3(nq, f.H, B);
  kernel<<<grid, P::THREADS, P::SMEM, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <int DQK, int DV, bool LSE>
static cudaError_t launch_tc(const FlashParams& f, int B, cudaStream_t stream) {
  if constexpr (DQK == 128 && DV == 128)
    if (pairs(DQK, DV, f.Sq, f.Sk)) return launch_plan<DQK, DV, true, LSE>(f, B, stream);
  return launch_plan<DQK, DV, false, LSE>(f, B, stream);
}

template <bool LSE>
static cudaError_t launch_tc_d(const FlashParams& f, int B, int Dqk, int Dv, cudaStream_t stream) {
  if (Dqk == 192 && Dv == 128) return launch_tc<192, 128, LSE>(f, B, stream);
  if (Dqk != Dv) return cudaErrorInvalidValue;
  switch (Dqk) {
    case 64: return launch_tc<64, 64, LSE>(f, B, stream);
    case 128: return launch_tc<128, 128, LSE>(f, B, stream);
    case 256: return launch_tc<256, 256, LSE>(f, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int DQK, int DV, bool LSE>
static cudaError_t launch_fma(const FlashParams& p, int B, cudaStream_t stream) {
  constexpr size_t bytes = (size_t)FlashSmem<DQK, DV>::FLOATS * sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<float, DQK, DV, LSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((p.Sq + FA_BQ - 1) / FA_BQ, p.H, B);
  flash_fwd_kernel<float, DQK, DV, LSE><<<grid, FA_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool LSE>
static cudaError_t launch_fma_d(const FlashParams& p, int B, int Dqk, int Dv, cudaStream_t stream) {
  if (Dqk == 192 && Dv == 128) return launch_fma<192, 128, LSE>(p, B, stream);
  if (Dqk != Dv) return cudaErrorInvalidValue;
  switch (Dqk) {
    case 64: return launch_fma<64, 64, LSE>(p, B, stream);
    case 128: return launch_fma<128, 128, LSE>(p, B, stream);
    case 256: return launch_fma<256, 256, LSE>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Strides are in elements.  (Dqk, Dv): (64, 64), (128, 128), (256, 256) or
// (192, 128); every pointer and every stride 16-byte aligned (TMA's rule for
// the bf16 path).  lse: null, or a contiguous (B, H, Sq) fp32 tensor that the
// LSE variant fills.  Returns cudaGetLastError().
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Hkv, int Sq,
    int Sk, int Dqk, int Dv, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int causal, int window, float scale,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  FlashParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.causal = causal; p.window = window; p.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return (int)(lse ? launch_fma_d<true>(p, B, Dqk, Dv, s) : launch_fma_d<false>(p, B, Dqk, Dv, s));
  if (dtype == DT_BF16)
    return (int)(lse ? launch_tc_d<true>(p, B, Dqk, Dv, s) : launch_tc_d<false>(p, B, Dqk, Dv, s));
  return (int)cudaErrorInvalidValue;
}

// The bf16 kernel's plan for (Dqk, Dv) where q holds Sq rows and k Sk: {q
// rows, kv rows, stages, threads, blocks an SM, shared-memory bytes, flat
// grid} into out[7].  Returns 0, or -1 for dims the kernel does not take.
template <int DQK, int DV, bool PAIRED = false> static void plan_of(int* out) {
  using P = TcPlan<DQK, DV, PAIRED>;
  out[0] = P::BQ; out[1] = P::BK; out[2] = P::STAGES; out[3] = P::THREADS;
  out[4] = P::MIN_BLOCKS; out[5] = P::SMEM; out[6] = P::FLAT;
}
extern "C" int flash_attention_plan(int Dqk, int Dv, int Sq, int Sk, int* out) {
  if (Dqk == 192 && Dv == 128) { plan_of<192, 128>(out); return 0; }
  if (Dqk != Dv) return -1;
  switch (Dqk) {
    case 64: plan_of<64, 64>(out); return 0;
    case 128:
      if (pairs(Dqk, Dv, Sq, Sk)) plan_of<128, 128, true>(out);
      else plan_of<128, 128>(out);
      return 0;
    case 256: plan_of<256, 256>(out); return 0;
    default: return -1;
  }
}
