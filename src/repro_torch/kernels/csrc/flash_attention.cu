// Causal GQA flash-attention forward with an optional sliding window,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (wrapper flash_attention, body _flash_kernel): the same function,
// out = softmax(mask(q k^T)) v with q pre-scaled, query head h reading
// kv head h / (H / KV), m, l and the accumulator in fp32, and tiles that
// lie wholly outside the causal band or the window skipped.  Any S (the
// ragged last tile is masked) and any head dim that is a multiple of 8
// from 32 to 256.
//
// What bounds it.  A live (query, key) pair costs 4*D FLOPs: a global
// layer of the gemma3-4b or olmoe-1b-7b prefill (B 4, S 4096, H*D 2048)
// is ~275 GFLOP (~0.28 ms at 989 TFLOP/s bf16), while its ~200 MB of
// q/k/v/o traffic takes ~0.06 ms at 3.35 TB/s.  So the kernel is bound by
// the tensor cores, and only wgmma reaches their full rate on this card.
// Measured on an H100 (PERF.md, testing/flash_split.py), what keeps it
// from that bound is the softmax beside the products (ex2 runs at 1/64 of
// the tensor cores' rate, and its share grows as D shrinks), each query
// tile's fixed cost, and the K/V stream from L2 when CTAs that read the
// same K/V run far apart in time.
//
// Both bf16 kernels run three warpgroups a CTA: the last is the producer,
// one thread of which issues TMA copies of Q and of each K and V tile into
// a ring of stages, each guarded by "full" and "empty" mbarriers; the
// other two are consumers, each owning 64 query rows of a 128-row query
// tile, so every K/V stage serves 128 rows.  setmaxnreg moves registers
// from the producer to the consumers.  Tensor maps view q, k and v with
// their real strides as 4-D (D, heads, S, B) arrays in boxes of 64
// columns (128 bytes, the 128-byte swizzle's limit); columns past D and
// rows past S arrive as zeros, so D 120 is padded to 128, D 160 to 192,
// and a ragged last tile is masked.  P = softmax's probabilities is
// packed to bf16 in the accumulator's own layout, which is the register
// layout of wgmma's A operand, and O += P V reads V MN-major through the
// descriptor's transpose bit.  m and l stay in fp32 registers; exp runs
// as ex2 on log2-scaled scores; only tiles that straddle the diagonal,
// the window edge or S apply the per-element mask, and KV tiles wholly
// outside a query tile's band are never loaded.
//
// D <= 128 (flash_fwd_bf16_pp), the FlashAttention-3 pattern:
//  * Persistent: one CTA an SM walks work units (a query tile of one batch
//    row and head), the next taken from a counter in global memory (the
//    wrapper's zeroed workspace).  Units come in sections of heads whose
//    K and V fit 32 MB of L2, longest query tiles first and heads inner,
//    so that the CTAs reading a K/V tile run at the same time.
//  * KV tiles of 128 keys: S = Q K^T is a chain of m64n128k16 with Q
//    (loaded into registers once a unit, which frees its buffer for the
//    next unit's Q) and K in shared memory; O += P V is m64n128k16 at
//    D 128.
//  * Within a warpgroup, Q K_j^T and P_{j-1} V_{j-1} are issued together
//    and tile j's softmax runs while P_{j-1} V_{j-1} is on the tensor
//    cores (wgmma.wait_group 1, then 0).  Between the two warpgroups,
//    named barriers order the issues (ping-pong), so that one
//    warpgroup's softmax overlaps the other's products.  Producer 24
//    registers, consumers 240.
//  * O is rescaled only when some row of the warp has a new max.
// D > 128 (flash_fwd_bf16): one CTA per 128-row query tile, KV tiles of
// 64 keys (2 stages at D 256), m64n64k16 products with Q in shared
// memory, each warpgroup's steps in series; a tile wholly masked for one
// warpgroup's rows is skipped by it; the grid walks the query tiles from
// the last (the most KV tiles) to the first.  Producer 40 registers,
// consumers 232.
//
// FLASH_SPLIT_* macros build variants with a part switched off, for
// timing only (testing/flash_split.py); the wrapper never sets them.
// The fp32 kernel (flash_fwd_f32) is a SIMT kernel with fp32 FMAs
// (tensor-core TF32 would miss the 2e-5 tolerance): Q, K and V tiles in
// shared memory as fp32, D padded to a multiple of 64 with zeros; each of
// 256 threads owns a 4 x (BK/16) score patch and a 4 x (D/16) slice of
// the accumulator.
//
// Plain C interface, loaded with ctypes; launches go on the caller's
// stream and the function returns a cudaError_t.  The tensor maps are
// encoded on the host with cuTensorMapEncodeTiled, reached through the
// runtime's cudaGetDriverEntryPoint (no link against libcuda).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;   // m's initial value, as in the TPU kernel
constexpr int kBQ = 64;             // fp32: query rows per CTA
constexpr int kBK = 64;             // keys per KV tile (both kernels)

__device__ __forceinline__ bool live(int qp, int kp, int window) {
  return kp <= qp && (window == 0 || qp - kp < window);
}

// ------------------------------------------------------------------ fp32

template <int DP>
__global__ void __launch_bounds__(256)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              int S, int H, int KV, int D, int window) {
  constexpr int NT = 256;
  constexpr int LD = DP + 1;       // padded rows: column reads hit distinct banks
  constexpr int LDP = kBK + 1;
  constexpr int RPT = kBQ / 16;    // query rows per thread
  constexpr int CPT = kBK / 16;    // score columns per thread
  constexpr int DPT = DP / 16;     // output columns per thread
  static_assert(kBQ * 4 == NT, "softmax phase maps 4 threads to a row");

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;
  float* m_s = Ps + kBQ * LDP;
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_row = (size_t)H * D, kv_row = (size_t)KV * D;
  const float* qb = q + (size_t)b * S * q_row + (size_t)h * D;
  const float* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const float* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;
  float* ob = o + (size_t)b * S * q_row + (size_t)h * D;

  for (int i = tid; i < kBQ * DP; i += NT) {
    const int r = i / DP, c = i % DP, qp = q0 + r;
    Qs[r * LD + c] = qp < S && c < D ? qb[(size_t)qp * q_row + c] : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegBig;
    l_s[tid] = 0.f;
  }

  const int rg = tid / 16, cg = tid % 16;
  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt0 = (window ? max(0, q0 - window + 1) : 0) / kBK;
  const int kt1 = q_last / kBK + 1;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kBK * DP; i += NT) {
      const int r = i / DP, c = i % DP, kp = k0 + r;
      const bool ok = kp < S && c < D;
      Ks[r * LD + c] = ok ? kb[(size_t)kp * kv_row + c] : 0.f;
      Vs[r * LD + c] = ok ? vb[(size_t)kp * kv_row + c] : 0.f;
    }
    __syncthreads();

    // scores: rows 4*rg.., columns cg + 16*j
    float sc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(rg * RPT + i) * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(cg + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = rg * RPT + i, c = cg + 16 * j;
        const int kp = k0 + c;
        Ps[r * LDP + c] =
            (kp < S && live(q0 + r, kp, window)) ? sc[i][j] : -INFINITY;
      }
    __syncthreads();

    // online softmax: four neighbouring lanes share a row
    {
      const int r = tid / 4, sub = tid % 4;
      float mx = -INFINITY;
      for (int c = sub; c < kBK; c += 4) mx = fmaxf(mx, Ps[r * LDP + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = sub; c < kBK; c += 4) {
        const float s = Ps[r * LDP + c];
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        Ps[r * LDP + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (sub == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float corr = c_s[rg * RPT + i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < kBK; ++c) {
      float p[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) p[i] = Ps[(rg * RPT + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[c * LD + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg * RPT + i, qp = q0 + r;
    if (qp >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int c = cg + 16 * j;
      if (c < D) ob[(size_t)qp * q_row + c] = acc[i][j] / l;
    }
  }
}

// ------------------------------------------------ bf16: Hopper primitives

constexpr int kWgRows = 64;                  // query rows of a consumer warpgroup
constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kHBQ = kWgRows * kConsumers;   // query rows per CTA
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBoxCols = 64;                 // bf16 columns of a 128-byte box
constexpr int kBoxBytes = 64 * 128;          // a box: 64 rows of 128 bytes
constexpr int kSmemLimit = 232448;           // opt-in shared memory a block
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void st_shared(uint32_t addr, int v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ int ld_shared(uint32_t addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* tm,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a tile in the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

// MN-major operand (V read as B of P V): the 16 keys of a k16 step are two
// 8-row groups 1024 bytes apart; an n64 product stays inside one box.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return sw128_desc(addr, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of wgmma's registers across the
// asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B, m64n64k16, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, m64n64k16, A (bf16 pairs) in registers, B MN-major in shared
// memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
#ifdef FLASH_SPLIT_NO_EX2
  return x * 0.5f;
#else
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
#endif
}

#ifdef FLASH_SPLIT_NO_QK
// A value the compiler cannot fold (the variant's scores).
__device__ __forceinline__ float opaque(float x) {
  asm volatile("mov.b32 %0, %0;\n" : "+f"(x));
  return x;
}
#endif

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&t);
}

// Shared-memory plan of the bf16 kernel for NBOX 64-column boxes of D:
// Q for both consumers, then the K and V rings, then the mbarriers.
template <int NBOX>
struct Plan {
  static constexpr int kTile = NBOX * kBoxBytes;        // 64 rows of Q, K or V
  static constexpr int kQ = kConsumers * kTile;
  static constexpr int kFit = (kSmemLimit - 2048 - kQ) / (2 * kTile);
#ifdef FLASH_SPLIT_STAGES
  static constexpr int kCap = FLASH_SPLIT_STAGES;
#else
  static constexpr int kCap = 4;
#endif
  static constexpr int kStages = kFit < kCap ? kFit : kCap;
  static constexpr int kBarriers = 3 * kStages + 1;
  static constexpr int kBytes = 1024 + kQ + 2 * kStages * kTile + 8 * kBarriers;
  static_assert(kStages >= 2, "a ring of at least two K/V stages");
  static_assert(kBytes <= kSmemLimit, "shared memory");
};

// ------------------------------------------------------------------ bf16

template <int NBOX>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               __nv_bfloat16* __restrict__ o, int B, int S, int H, int KV,
               int D, int window) {
  using P = Plan<NBOX>;
  constexpr int ST = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t sQ = base;                        // [consumer][box][64][64]
  const uint32_t sK = sQ + P::kQ;                  // [stage][box][64][64]
  const uint32_t sV = sK + ST * P::kTile;
  const uint32_t bars = sV + ST * P::kTile;        // full_k, full_v, empty, q
  const uint32_t q_full = bars + 8 * (3 * ST);

  // longest query tiles first: the last tile has the most KV tiles
  const int nq = (S + kHBQ - 1) / kHBQ;
#if defined(FLASH_SPLIT_ORDER) && FLASH_SPLIT_ORDER == 1
  // each (batch row, head)'s query tiles one after another
  const int hb = (int)(blockIdx.x / (unsigned)nq);
  const int qt = nq - 1 - (int)(blockIdx.x % (unsigned)nq);
#elif defined(FLASH_SPLIT_ORDER) && FLASH_SPLIT_ORDER == 2
  // sections of G heads whose K and V fit 32 MB of L2; in a section the
  // longest query tiles first, heads inner
  const long long kv_bytes = (long long)S * NBOX * kBoxCols * 4 / (H / KV);
  const int G = (int)min((long long)H * B,
                         max(1LL, (32LL << 20) / max(kv_bytes, 1LL)));
  const int sec = (int)(blockIdx.x / (unsigned)(G * nq));
  const int within = (int)(blockIdx.x % (unsigned)(G * nq));
  const int g = min(G, H * B - sec * G);
  const int hb = sec * G + within % g;
  const int qt = nq - 1 - within / g;
#else
  const int hb = (int)(blockIdx.x % (unsigned)(H * B));
  const int qt = nq - 1 - (int)(blockIdx.x / (unsigned)(H * B));
#endif
  const int h = hb % H, b = hb / H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kHBQ;
#ifdef FLASH_SPLIT_ONE_TILE
  const int kt0 = (min(q0 + kHBQ, S) - 1) / kBK;
#else
  const int kt0 = (window ? max(0, q0 - window + 1) : 0) / kBK;
#endif
  const int kt1 = (min(q0 + kHBQ, S) - 1) / kBK + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bars + 8 * s, 1);                  // K full: the producer
      mbar_init(bars + 8 * (ST + s), 1);           // V full: the producer
      mbar_init(bars + 8 * (2 * ST + s), 4 * kConsumers);  // empty: a warp each
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      const int n_q = q0 + kWgRows < S ? kConsumers : 1;
      mbar_expect_tx(q_full, n_q * P::kTile);
      for (int w = 0; w < n_q; ++w)
        for (int bx = 0; bx < NBOX; ++bx)
          tma_load_4d(sQ + (w * NBOX + bx) * kBoxBytes, &tm_q, q_full,
                      bx * kBoxCols, h, q0 + w * kWgRows, b);
      for (int i = 0, kt = kt0; kt < kt1; ++i, ++kt) {
        const int st = i % ST;
        const uint32_t ph = (uint32_t)(i / ST) & 1u;
        mbar_wait(bars + 8 * (2 * ST + st), ph ^ 1u);   // the stage is free
        const uint32_t fk = bars + 8 * st, fv = bars + 8 * (ST + st);
        mbar_expect_tx(fk, P::kTile);
        for (int bx = 0; bx < NBOX; ++bx)
          tma_load_4d(sK + st * P::kTile + bx * kBoxBytes, &tm_k, fk,
                      bx * kBoxCols, kvh, kt * kBK, b);
        mbar_expect_tx(fv, P::kTile);
        for (int bx = 0; bx < NBOX; ++bx)
          tma_load_4d(sV + st * P::kTile + bx * kBoxBytes, &tm_v, fv,
                      bx * kBoxCols, kvh, kt * kBK, b);
      }
    }
  } else {
    // ------------------------------------------------------- consumer
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, qd = lane % 4;
    const int r0 = q0 + wg * kWgRows;              // this warpgroup's rows
    const int r_last = min(r0 + kWgRows, S) - 1;
    const int row0 = r0 + warp * 16 + g;           // this thread's rows: row0, row0 + 8
    const uint32_t sQw = sQ + wg * P::kTile;

    float oacc[NBOX][32];
#pragma unroll
    for (int c = 0; c < NBOX; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) oacc[c][e] = 0.f;
    float m_r[2] = {kNegBig, kNegBig};             // log2 domain
    float l_r[2] = {0.f, 0.f};                     // this lane's columns only

    mbar_wait(q_full, 0);
    for (int i = 0, kt = kt0; kt < kt1; ++i, ++kt) {
      const int st = i % ST;
      const uint32_t ph = (uint32_t)(i / ST) & 1u;
      const int k0 = kt * kBK;
      const bool dead = r0 > r_last || k0 > r_last ||
                        (window && k0 + kBK - 1 < r0 - window + 1);
      mbar_wait(bars + 8 * st, ph);                // K has landed
#ifdef FLASH_SPLIT_LOADS_ONLY
      mbar_wait(bars + 8 * (ST + st), ph);
      if (false) {
#else
      if (!dead) {
#endif
        // ---------------------------------------------- S = Q K^T
        float sacc[32];
#ifdef FLASH_SPLIT_NO_QK
#pragma unroll
        for (int e = 0; e < 32; ++e) sacc[e] = opaque(0.01f * e);
#else
#pragma unroll
        for (int e = 0; e < 32; ++e) sacc[e] = 0.f;
        fence_regs(sacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NBOX * 4; ++kk) {
          const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
          wgmma_ss(sacc, desc_kmajor(sQw + off),
                   desc_kmajor(sK + st * P::kTile + off), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sacc);
#endif

        // ------------------------- mask (edge tiles only), online softmax
#ifdef FLASH_SPLIT_NO_SOFTMAX
        uint32_t pa[4][4];
        float corr[2] = {1.f, 1.f};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(sacc[4 * j], sacc[4 * j + 1]);
          pa[j / 2][(j % 2) * 2 + 1] =
              pack_bf16(sacc[4 * j + 2], sacc[4 * j + 3]);
        }
#else
        const bool edge = k0 + kBK - 1 > r0 || k0 + kBK > S ||
                          (window && k0 < r_last - window + 1);
        if (edge) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kp = k0 + j * 8 + 2 * qd + (e & 1);
              const int qp = row0 + 8 * (e >> 1);
              if (!(kp < S && live(qp, kp, window))) sacc[4 * j + e] = -INFINITY;
            }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], sacc[4 * j + e]);
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_r[r], mx[r] * kLog2e);
          corr[r] = ex2(m_r[r] - m_new);
          m_r[r] = m_new;
          l_r[r] *= corr[r];
        }
        uint32_t pa[4][4];                         // P as A of 4 k16 slices
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = ex2(fmaf(sacc[4 * j + e], kLog2e, -m_r[e >> 1]));
            l_r[e >> 1] += p[e];
          }
          pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
          pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
        }
#endif
#pragma unroll
        for (int c = 0; c < NBOX; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            oacc[c][4 * j + 0] *= corr[0];
            oacc[c][4 * j + 1] *= corr[0];
            oacc[c][4 * j + 2] *= corr[1];
            oacc[c][4 * j + 3] *= corr[1];
          }

        // ---------------------------------------------- O += P V
        mbar_wait(bars + 8 * (ST + st), ph);       // V has landed
#ifdef FLASH_SPLIT_NO_PV
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(pa[kk][e]));
#else
#pragma unroll
        for (int c = 0; c < NBOX; ++c) fence_regs(oacc[c]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int c = 0; c < NBOX; ++c)
            wgmma_rs(oacc[c], pa[kk],
                     desc_mnmajor(sV + st * P::kTile + c * kBoxBytes +
                                  kk * 16 * 128));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < NBOX; ++c) fence_regs(oacc[c]);
#endif
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (2 * ST + st));   // release the stage
    }

    // ----------------------------------------------------- epilogue
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int qp = row0 + 8 * r;
      if (qp >= S) continue;
      __nv_bfloat16* orow = o + (((size_t)b * S + qp) * H + h) * D;
#pragma unroll
      for (int c = 0; c < NBOX; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c * kBoxCols + j * 8 + 2 * qd;
          if (col < D)
            *reinterpret_cast<uint32_t*>(orow + col) =
                pack_bf16(oacc[c][4 * j + 2 * r] * inv,
                          oacc[c][4 * j + 2 * r + 1] * inv);
        }
    }
  }
}

// ------------------------------------------- bf16, D <= 128: persistent

constexpr int kPBN = 128;                    // keys per KV tile
constexpr int kPBoxBytes = 128 * 128;        // a box: 128 rows of 128 bytes
constexpr long long kL2Section = 32LL << 20; // K and V bytes of a section

__device__ __forceinline__ void named_sync(int id) {
#ifndef FLASH_SPLIT_NO_PINGPONG
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
#endif
}
__device__ __forceinline__ void named_arrive(int id) {
#ifndef FLASH_SPLIT_NO_PINGPONG
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
#endif
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs_u(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// d (+)= A B, m64n128k16, A (bf16 pairs) in registers, B in shared memory:
// K-major (TNSP_B 0, K of Q K^T) or MN-major (TNSP_B 1, V of P V: D's two
// 64-column boxes the descriptor's leading byte offset apart).
template <int TNSP_B>
__device__ __forceinline__ void wgmma_rs128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TNSP_B));
}

// Shared-memory plan of the persistent kernel for NBOX 64-column boxes of
// D: Q (128 rows), then the K and V rings of 128-key tiles, then the
// mbarriers, the unit Q was loaded for and a word a consumer thread.
template <int NBOX>
struct PPlan {
  static constexpr int kTile = NBOX * kPBoxBytes;       // 128 rows
  static constexpr int kFit = (kSmemLimit - 2048 - kTile) / (2 * kTile);
#ifdef FLASH_SPLIT_STAGES
  static constexpr int kCap = FLASH_SPLIT_STAGES;
#else
  static constexpr int kCap = 4;
#endif
  static constexpr int kStages = kFit < kCap ? kFit : kCap;
  static constexpr int kBarriers = 4 * kStages + 2;
  static constexpr int kBytes =
      1024 + kTile + 2 * kStages * kTile + 8 * kBarriers + 16 + 4 * 256;
  static_assert(kStages >= 2, "a ring of at least two K/V stages");
  static_assert(kBytes <= kSmemLimit, "shared memory");
};

// This thread's part of the warpgroup's 64 rows of Q as wgmma A fragments,
// one k16 slice of D each, read from the 128-byte-swizzled tile: row R
// (of the tile's 128) and R + 8, columns 2 qd.. of each 8-column half.
template <int NBOX>
__device__ __forceinline__ void load_q(uint32_t (&qa)[NBOX * 4][4],
                                       uint32_t sQ, int R, int qd) {
#pragma unroll
  for (int kk = 0; kk < NBOX * 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = R + 8 * (e & 1), chunk = 2 * (kk % 4) + (e >> 1);
      qa[kk][e] = (uint32_t)ld_shared(sQ + (kk / 4) * kPBoxBytes + row * 128 +
                                      ((chunk ^ (row & 7)) << 4) + 4 * qd);
    }
}

// S = Q K^T of one stage (committed, not waited for), Q from registers.
template <int NBOX>
__device__ __forceinline__ void issue_qk(float (&s)[64],
                                         uint32_t (&qa)[NBOX * 4][4],
                                         uint32_t sKst) {
#ifdef FLASH_SPLIT_NO_QK
#pragma unroll
  for (int e = 0; e < 64; ++e) s[e] = opaque(0.01f * e);
#else
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NBOX * 4; ++kk)
    wgmma_rs128<0>(s, qa[kk],
                   desc_kmajor(sKst + (kk / 4) * kPBoxBytes + (kk % 4) * 32),
                   kk > 0);
  wgmma_commit();
#endif
}

// O += P V of one stage (committed, not waited for).
template <int NBOX>
__device__ __forceinline__ void issue_pv(float (&oacc)[NBOX * 32],
                                         uint32_t (&pa)[8][4], uint32_t sVst) {
#ifdef FLASH_SPLIT_NO_PV
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(pa[kk][e]));
#else
  fence_regs(oacc);
  fence_regs_u(pa);
  wgmma_fence();
#ifndef FLASH_SPLIT_PV_N64
  if constexpr (NBOX == 2) {
    // one m64n128k16 a k16 slice: D's two boxes are the MN-major atoms,
    // kPBoxBytes apart
#pragma unroll
    for (int kk = 0; kk < kPBN / 16; ++kk)
      wgmma_rs128<1>(oacc, pa[kk],
                     sw128_desc(sVst + kk * 16 * 128, kPBoxBytes, 1024), 1);
  } else
#endif
  {
#pragma unroll
    for (int kk = 0; kk < kPBN / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NBOX; ++c)
        wgmma_rs(*reinterpret_cast<float(*)[32]>(oacc + 32 * c), pa[kk],
                 desc_mnmajor(sVst + c * kPBoxBytes + kk * 16 * 128));
  }
  wgmma_commit();
#endif
}

// Mask (edge tiles only) and online softmax of one 128-key tile's scores
// from key k0 for the warpgroup's rows r0..r_last: s becomes P in fp32,
// corr the factor for O.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m_r)[2],
                                             float (&l_r)[2],
                                             float (&corr)[2], int k0,
                                             int r0, int r_last, int row0,
                                             int qd, int S, int window) {
#ifdef FLASH_SPLIT_NO_SOFTMAX
  corr[0] = corr[1] = 1.f;
#else
  const bool edge = k0 + kPBN - 1 > r0 || k0 + kPBN > S ||
                    (window && k0 < r_last - window + 1);
  if (edge) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + j * 8 + 2 * qd + (e & 1);
        const int qp = row0 + 8 * (e >> 1);
        if (!(kp < S && live(qp, kp, window))) s[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_r[r], mx[r] * kLog2e);
    corr[r] = ex2(m_r[r] - m_new);
    m_r[r] = m_new;
    l_r[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], kLog2e, -m_r[e >> 1]));
      l_r[e >> 1] += s[4 * j + e];
    }
#endif
}

// P (fp32, the accumulator's layout) packed to bf16 as wgmma's A operand.
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

// O *= corr, row by row; skipped where no row of the warp has a new max
// (then corr is exactly 1), as it is for most tiles once the max settles.
template <int NBOX>
__device__ __forceinline__ void scale_o(float (&oacc)[NBOX * 32],
                                        const float (&corr)[2]) {
  if (!__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) return;
#pragma unroll
  for (int j = 0; j < NBOX * 8; ++j) {
    oacc[4 * j + 0] *= corr[0];
    oacc[4 * j + 1] *= corr[0];
    oacc[4 * j + 2] *= corr[1];
    oacc[4 * j + 3] *= corr[1];
  }
}

// A warp's arrival on an mbarrier, once all its lanes are past their reads.
__device__ __forceinline__ void release_warp(int lane, uint32_t bar) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// The u-th work unit (one 128-row query tile of one batch row and head) in
// the order the CTAs walk them: sections of G heads whose K and V fit
// kL2Section bytes of L2, in a section the longest query tiles first and
// the heads inner, so that the CTAs reading one K/V tile run at once.
struct Unit {
  int b, h, q0, kt0, kt1;
};

__device__ __forceinline__ Unit unit_of(int u, int nq, int H, int B, int G,
                                        int S, int window) {
  const int HB = H * B;
#if defined(FLASH_SPLIT_ORDER) && FLASH_SPLIT_ORDER == 0
  const int hb = u % HB, qt = nq - 1 - u / HB;
#elif defined(FLASH_SPLIT_ORDER) && FLASH_SPLIT_ORDER == 1
  const int hb = u / nq, qt = nq - 1 - u % nq;
#else
  const int sec = u / (G * nq), within = u % (G * nq);
  const int g = min(G, HB - sec * G);
  const int hb = sec * G + within % g, qt = nq - 1 - within / g;
#endif
  Unit w;
  w.b = hb / H;
  w.h = hb % H;
  w.q0 = qt * kHBQ;
  w.kt1 = (min(w.q0 + kHBQ, S) - 1) / kPBN + 1;
#ifdef FLASH_SPLIT_ONE_TILE
  w.kt0 = w.kt1 - 1;
#else
  w.kt0 = (window ? max(0, w.q0 - window + 1) : 0) / kPBN;
#endif
  return w;
}


template <int NBOX>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_pp(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  __nv_bfloat16* __restrict__ o, int B, int S, int H, int KV,
                  int D, int window, int G, int* __restrict__ next_unit) {
  // next_unit[0]: units taken past the first wave; [1]: CTAs done
  using P = PPlan<NBOX>;
  constexpr int ST = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t sQ = base;                        // [box][128][64]
  const uint32_t sK = sQ + P::kTile;               // [stage][box][128][64]
  const uint32_t sV = sK + ST * P::kTile;
  const uint32_t bars = sV + ST * P::kTile;
  // k full, v full, k empty, v empty (a stage each), q full, q empty
  const uint32_t k_full = bars, v_full = bars + 8 * ST;
  const uint32_t k_empty = bars + 16 * ST, v_empty = bars + 24 * ST;
  const uint32_t q_full = bars + 32 * ST, q_empty = q_full + 8;
  const uint32_t unit_slot = q_empty + 8;          // the unit Q was loaded for
  const uint32_t pin = unit_slot + 16 + 4 * threadIdx.x;  // see the consumer

  const int nq = (S + kHBQ - 1) / kHBQ;
  const int total = nq * H * B;
  const int group = H / KV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + 8 * s, 1);                // the producer
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4 * kConsumers);  // a warp each
      mbar_init(v_empty + 8 * s, 4 * kConsumers);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      int it = 0;
      for (int t = 0, u = (int)blockIdx.x;; ++t) {
        mbar_wait(q_empty, (uint32_t)(t & 1) ^ 1u);  // Q is in registers
        if (u >= total) {                          // tell the consumers: done
          st_shared(unit_slot, -1);
          mbar_arrive(q_full);
          // the last CTA out zeroes the counters for the stream's next
          // launch: every other CTA has taken its last unit by then
          __threadfence();
          if (atomicAdd(next_unit + 1, 1) == (int)gridDim.x - 1) {
            next_unit[0] = 0;
            next_unit[1] = 0;
          }
          break;
        }
        st_shared(unit_slot, u);
        const Unit w = unit_of(u, nq, H, B, G, S, window);
        const int kvh = w.h / group;
#ifdef FLASH_SPLIT_NO_LOADS
        mbar_arrive(q_full);
#else
        mbar_expect_tx(q_full, P::kTile);
        for (int bx = 0; bx < NBOX; ++bx)
          tma_load_4d(sQ + bx * kPBoxBytes, &tm_q, q_full, bx * kBoxCols, w.h,
                      w.q0, w.b);
#endif
        // the next unit: the first free one (its latency hides behind K, V)
        u = (int)gridDim.x + atomicAdd(next_unit, 1);
        for (int kt = w.kt0; kt < w.kt1; ++kt, ++it) {
          const int st = it % ST;
          const uint32_t ph = (uint32_t)(it / ST) & 1u;
          mbar_wait(k_empty + 8 * st, ph ^ 1u);
#ifdef FLASH_SPLIT_NO_LOADS
          mbar_arrive(k_full + 8 * st);
#else
          mbar_expect_tx(k_full + 8 * st, P::kTile);
          for (int bx = 0; bx < NBOX; ++bx)
            tma_load_4d(sK + st * P::kTile + bx * kPBoxBytes, &tm_k,
                        k_full + 8 * st, bx * kBoxCols, kvh, kt * kPBN, w.b);
#endif
          mbar_wait(v_empty + 8 * st, ph ^ 1u);
#ifdef FLASH_SPLIT_NO_LOADS
          mbar_arrive(v_full + 8 * st);
#else
          mbar_expect_tx(v_full + 8 * st, P::kTile);
          for (int bx = 0; bx < NBOX; ++bx)
            tma_load_4d(sV + st * P::kTile + bx * kPBoxBytes, &tm_v,
                        v_full + 8 * st, bx * kBoxCols, kvh, kt * kPBN, w.b);
#endif
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumer
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, qd = lane % 4;
    // Ping-pong: a warpgroup issues its products only after the other has
    // issued its own (named barrier 1 + wg); consumer 0 goes first.
    const int own_bar = 1 + wg, other_bar = 2 - wg;
    if (wg == 1) named_arrive(1);

    int it = 0;
    for (int t = 0;; ++t) {
      mbar_wait(q_full, (uint32_t)(t & 1));
      const int u = ld_shared(unit_slot);
      if (u < 0) break;
      const Unit w = unit_of(u, nq, H, B, G, S, window);
      const int n = w.kt1 - w.kt0;
#ifdef FLASH_SPLIT_LOADS_ONLY
      for (int j = 0; j < n; ++j, ++it) {
        const int st = it % ST;
        const uint32_t ph = (uint32_t)(it / ST) & 1u;
        mbar_wait(k_full + 8 * st, ph);
        release_warp(lane, k_empty + 8 * st);
        mbar_wait(v_full + 8 * st, ph);
        release_warp(lane, v_empty + 8 * st);
      }
      release_warp(lane, q_empty);
      continue;
#endif
      const int r0 = w.q0 + wg * kWgRows;          // this warpgroup's rows
      const int r_last = min(r0 + kWgRows, S) - 1;
      const int row0 = r0 + warp * 16 + g;         // this thread's: row0, row0 + 8

      float oacc[NBOX * 32];                       // box c: [32 c, 32 c + 32)
#pragma unroll
      for (int e = 0; e < NBOX * 32; ++e) oacc[e] = 0.f;
      float m_r[2] = {kNegBig, kNegBig};           // log2 domain
      float l_r[2] = {0.f, 0.f};                   // this lane's columns only
      float s[64];                                 // scores, then P in fp32
      uint32_t pa[8][4];                           // P as A of 8 k16 slices
      uint32_t qa[NBOX * 4][4];                    // Q as A of NBOX * 4 slices
      load_q<NBOX>(qa, sQ, wg * kWgRows + warp * 16 + g, qd);
      release_warp(lane, q_empty);                 // the next unit's Q may come

      // the first KV tile: Q K^T, then its softmax
      {
        const int st = it % ST;
        mbar_wait(k_full + 8 * st, (uint32_t)(it / ST) & 1u);
        named_sync(own_bar);
        issue_qk<NBOX>(s, qa, sK + st * P::kTile);
        named_arrive(other_bar);
        wgmma_wait<0>();
        fence_regs(s);
        release_warp(lane, k_empty + 8 * st);
        float corr[2];
        softmax_tile(s, m_r, l_r, corr, w.kt0 * kPBN, r0, r_last, row0, qd,
                     S, window);
        pack_p(s, pa);
      }
      // each further tile j: Q K_j^T and P_{j-1} V_{j-1} in flight together;
      // tile j's softmax runs while P_{j-1} V_{j-1} is on the tensor cores
      for (int j = 1; j < n; ++j) {
        const int sp = (it + j - 1) % ST, st = (it + j) % ST;
        mbar_wait(k_full + 8 * st, (uint32_t)((it + j) / ST) & 1u);
        mbar_wait(v_full + 8 * sp, (uint32_t)((it + j - 1) / ST) & 1u);
        named_sync(own_bar);
        issue_qk<NBOX>(s, qa, sK + st * P::kTile);
        issue_pv<NBOX>(oacc, pa, sV + sp * P::kTile);
        named_arrive(other_bar);
#ifdef FLASH_SPLIT_NO_PV
        wgmma_wait<0>();
#else
        wgmma_wait<1>();                           // Q K_j^T is done
#endif
        fence_regs(s);
        release_warp(lane, k_empty + 8 * st);
        float corr[2];
        softmax_tile(s, m_r, l_r, corr, (w.kt0 + j) * kPBN, r0, r_last,
                     row0, qd, S, window);
        // ptxas would hoist the wait below above the softmax, which then
        // no longer runs in the shadow of P_{j-1} V_{j-1}; a store of the
        // row sums (never read) has to precede the wait and pins it
        st_shared(pin, __float_as_int(l_r[0] + l_r[1]));
        wgmma_wait<0>();                           // P_{j-1} V_{j-1} is done
        fence_regs(oacc);
        fence_regs_u(pa);
        release_warp(lane, v_empty + 8 * sp);
        scale_o<NBOX>(oacc, corr);
        pack_p(s, pa);
      }
      // the last P V
      {
        const int st = (it + n - 1) % ST;
        mbar_wait(v_full + 8 * st, (uint32_t)((it + n - 1) / ST) & 1u);
        named_sync(own_bar);
        issue_pv<NBOX>(oacc, pa, sV + st * P::kTile);
        named_arrive(other_bar);
        wgmma_wait<0>();
        fence_regs(oacc);
        fence_regs_u(pa);
        release_warp(lane, v_empty + 8 * st);
      }
      it += n;

      // --------------------------------------------------- epilogue
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_r[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / fmaxf(l, 1e-30f);
        const int qp = row0 + 8 * r;
#ifdef FLASH_SPLIT_NO_STORE
        if (qp < S + 1000000) {                    // keep O live, store nothing
          asm volatile("" ::"f"(inv));
          fence_regs(oacc);
          continue;
        }
#endif
        if (qp >= S) continue;
        __nv_bfloat16* orow = o + (((size_t)w.b * S + qp) * H + w.h) * D;
#pragma unroll
        for (int c = 0; c < NBOX; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = c * kBoxCols + j * 8 + 2 * qd;
            if (col < D)
              *reinterpret_cast<uint32_t*>(orow + col) =
                  pack_bf16(oacc[32 * c + 4 * j + 2 * r] * inv,
                            oacc[32 * c + 4 * j + 2 * r + 1] * inv);
          }
      }
    }
    if (wg == 0) named_sync(own_bar);              // consumer 1's last arrive
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (D, heads, S, B) bf16 view of a contiguous (B, S, heads, D) tensor, in
// boxes of 64 columns by `rows` rows of one head, 128-byte swizzled; reads
// out of bounds (columns past D, rows past S) fill zeros.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
             int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NBOX>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int KV, int D, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, S, H, D, 64);
  if (!err) err = make_map(&tk, k, B, S, KV, D, 64);
  if (!err) err = make_map(&tv, v, B, S, KV, D, 64);
  if (err) return err;
  const int smem = Plan<NBOX>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16<NBOX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long ctas = (long long)((S + kHBQ - 1) / kHBQ) * H * B;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_fwd_bf16<NBOX><<<(unsigned)ctas, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, S, H, KV, D, window);
  return (int)cudaGetLastError();
}

template <int NBOX>
int launch_bf16_pp(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KV, int D, int window,
                   int* next_unit, cudaStream_t stream) {
  if (!next_unit) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, S, H, D, kPBN);
  if (!err) err = make_map(&tk, k, B, S, KV, D, kPBN);
  if (!err) err = make_map(&tv, v, B, S, KV, D, kPBN);
  if (err) return err;
  const int smem = PPlan<NBOX>::kBytes;
  // the shared-memory opt-in and the SM count, once a device (a launch's
  // host time counts while the card waits for it)
  static int sms_of[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sms_of[dev]) {
    int sms = 0;
    e = cudaFuncSetAttribute(flash_fwd_bf16_pp<NBOX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sms_of[dev] = sms;
  }
  const int sms = sms_of[dev];
  const long long units = (long long)((S + kHBQ - 1) / kHBQ) * H * B;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // heads a section: their K and V (D padded to whole boxes) fit kL2Section
  const long long kv_head = (long long)S * NBOX * kBoxCols * 2 * 2;
  long long G = kL2Section * (H / KV) / kv_head;
  G = G < 1 ? 1 : (G > (long long)H * B ? (long long)H * B : G);
  const int grid = (int)(units < sms ? units : sms);
  flash_fwd_bf16_pp<NBOX><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, S, H, KV, D, window,
      (int)G, next_unit);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KV, int D, int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((kBQ + 2 * kBK) * (DP + 1) + kBQ * (kBK + 1) + 3 * kBQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_f32<DP><<<grid, 256, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, D,
      window);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B,S,H,D), k and v: (B,S,KV,D), o: (B,S,H,D), all contiguous and
// 16-byte aligned; D a multiple of 8 from 32 to 256.  dtype 0 = float32,
// 1 = bfloat16.  workspace: two int32 holding 0, the bf16 kernel's
// counters at D <= 128 (unread otherwise), which the kernel leaves at 0:
// one workspace a stream.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int H, int KV, int D,
                                   int window, int dtype, void* stream,
                                   void* workspace) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (KV <= 0 || H % KV != 0 || window < 0) return (int)cudaErrorInvalidValue;
  if (D % 8 != 0 || D < 32 || D > 256) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int boxes = (D + kBoxCols - 1) / kBoxCols;   // 64-column blocks of D
  if (dtype == 0) {
    switch (boxes) {
      case 1: return launch_f32<64>(q, k, v, o, B, S, H, KV, D, window, st);
      case 2: return launch_f32<128>(q, k, v, o, B, S, H, KV, D, window, st);
      case 3: return launch_f32<192>(q, k, v, o, B, S, H, KV, D, window, st);
      default: return launch_f32<256>(q, k, v, o, B, S, H, KV, D, window, st);
    }
  }
  switch (boxes) {
#ifdef FLASH_SPLIT_OLD
    case 1: return launch_bf16<1>(q, k, v, o, B, S, H, KV, D, window, st);
    case 2: return launch_bf16<2>(q, k, v, o, B, S, H, KV, D, window, st);
#else
    case 1:
      return launch_bf16_pp<1>(q, k, v, o, B, S, H, KV, D, window,
                               static_cast<int*>(workspace), st);
    case 2:
      return launch_bf16_pp<2>(q, k, v, o, B, S, H, KV, D, window,
                               static_cast<int*>(workspace), st);
#endif
    case 3: return launch_bf16<3>(q, k, v, o, B, S, H, KV, D, window, st);
    default: return launch_bf16<4>(q, k, v, o, B, S, H, KV, D, window, st);
  }
}
