// sLSTM recurrence forward (xLSTM scalar memory), written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/slstm_step.py
// (wrapper slstm_step_scan, body _slstm_kernel): the same function.  Per
// (batch row, head) and time step, four recurrent matvecs h R^T (one per
// gate z, i, f, o; R[h, out, in]) are added to the gates' pre-activations;
// then z = tanh, o = sigmoid, the log-sigmoid forget gate, the
// m-stabilised exponential gates, n floored at 1e-6 and h = o c / n.  The
// state c, n, m, h and the R products are fp32, as in the TPU kernel.
//
// What bounds it.  At the xlstm-125m shape (B 8, S 4096, H 4, D 192,
// bf16) gates, out and R are 201 + 50 + 1.2 MB (~0.075 ms at 3.35 TB/s)
// and the matvecs B*H*S*8*D^2 ~ 39 GFLOP: bytes bound it, at ~0.075 ms.
// Neither is what bounds it in practice: each (batch row, head) is one
// chain of S dependent steps, and each step needs all D values of the
// previous h before any of its 4 D^2 multiply-adds.  The latency of one
// step sets the time: its products, its gate functions and the exchange of
// h between the CTAs that share the work.
//
// Design: a thread-block cluster per recurrence, R on chip for the whole
// sequence, h exchanged through distributed shared memory.
//  * The 4 D gate rows of a head are split by output unit over a cluster
//    of C CTAs (CTA r owns units [r U, (r + 1) U), U = D / C, all four
//    gates of each).  h lives in shared memory, double-buffered: step t
//    reads buffer t & 1.  Each CTA writes the h_{t+1} values of its units
//    into the other buffer of every CTA of the cluster with st.async,
//    whose bytes complete a transaction count on the receiver's mbarrier
//    for that buffer; a CTA waits on its own mbarrier, so no barrier
//    spans the cluster.  Double buffering makes the writes safe: a CTA
//    writes buffer (t + 1) & 1 of a peer only after receiving that peer's
//    h_t, which the peer sends after its last read of that buffer.
//  * bf16 (the model's path), slstm_mma_kernel: the products run on the
//    tensor cores.  A cluster serves one head and 4 batch rows: h of the
//    4 rows is the n 8 operand of mma m16n8k16, columns 2 q and 2 q + 1
//    holding the bf16 hi and lo parts of row q's h, so each product is
//    exact to 2^-17 of h and R (bf16) is read once for all 4 rows.  Warp
//    w keeps the 8 units 8 w .. 8 w + 7 of its CTA as two 16-row tiles of
//    R (rows z, i | f, o of 4 units) in A-fragment registers (96 at
//    D 192); B fragments come from the h buffer by ldmatrix.trans.  Each
//    lane then owns one (unit, batch row): one shuffle gathers its four
//    gate sums, and the quad's four (hi, lo) pairs leave as one 16-byte
//    st.async per peer.  C is the smallest of 1, 2, 4 that keeps a CTA
//    at 256 threads or fewer (kernels/slstm_step.py, mma_cluster): at
//    xlstm-125m's B 8, H 4, D 192, 8 clusters of 4 CTAs.
//  * fp32, slstm_cluster_kernel: SIMT fp32 FMAs (tensor-core TF32 or
//    split bf16 products would miss the 1e-5 tolerance).  A cluster
//    serves one (batch row, head).  Thread (unit u, part p) keeps its
//    unit's four R rows over chunks p, p + P, ... of 4 d values in fp32
//    registers; the P partial sums meet through warp shuffles.  C is the
//    smallest power of two (at most 8) that keeps a CTA's slice of R
//    within 36,864 registers (kernels/slstm_step.py, cluster_split).
//  * Gate pre-activations are loaded four steps ahead into registers; the
//    gate functions run on the SFU (__expf, __logf, __fdividef: absolute
//    errors of a few 1e-7), and the two exponential gates take one exp.
//  * Plain C interface, loaded with ctypes; the launch goes on the
//    caller's stream (cudaLaunchKernelEx with the cluster dimension) and
//    the functions return a cudaError_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;   // m's initial value, as in the TPU kernel

// The gate functions on the SFU's exp2 and log2 (__expf, __logf) with
// division by __fdividef: absolute errors of a few 1e-7, inside the fp32
// tolerance of 1e-5, at a fraction of the accurate versions' latency,
// which every step of the chain pays.
__device__ __forceinline__ float tanh_f(float x) {
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}

// log(sigmoid(x)) = min(x, 0) - log1p(exp(-|x|)), as jax.nn.log_sigmoid
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - __logf(1.f + __expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// One step of a unit's state (c, n, m) from its four pre-activations;
// returns h.  With d = lf + m - i, m_new = max(lf + m, i) makes one of the
// two exponential gates exp(0) = 1 and the other exp(-|d|): one exp.
__device__ __forceinline__ float cell(float z_pre, float i_pre, float f_pre,
                                      float o_pre, float& c, float& n,
                                      float& m) {
  const float lf = log_sigmoid(f_pre);
  const float d = lf + m - i_pre;
  const float e = __expf(-fabsf(d));
  const float fgate = d >= 0.f ? 1.f : e;       // exp(lf + m - m_new)
  const float igate = d >= 0.f ? e : 1.f;       // exp(i - m_new)
  m = d >= 0.f ? lf + m : i_pre;
  c = fgate * c + igate * tanh_f(z_pre);
  n = fmaxf(fgate * n + igate, 1e-6f);
  return sigmoid(o_pre) * __fdividef(c, n);
}

// Four consecutive bf16 values (one 8-byte load), kept raw until used.
__device__ __forceinline__ uint2 load_bf4(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ float4 bf4_to_f4(uint2 x) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load_f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address in CTA `peer` of the cluster of a shared-memory address.
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, uint32_t peer) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(peer));
  return remote;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// One arrival that also expects `bytes` of st.async data this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Store v at `remote` in a peer CTA and count its 4 bytes on the peer's
// mbarrier `remote_bar`.
__device__ __forceinline__ void st_async(uint32_t remote, float v,
                                         uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];\n" ::"r"(remote), "r"(__float_as_uint(v)), "r"(remote_bar)
      : "memory");
}

// Buffer 1 receives h_1, h_3, ...; buffer 0 h_2, h_4, ...: one mbarrier
// each, armed (one arrival plus the bytes of a step) for every h a peer
// will send.  Thread 0 arms the first two phases.
__device__ __forceinline__ void arm(uint32_t bars, int S, uint32_t tx) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    if (S > 1) mbar_expect_tx(bars + 8, tx);
    if (S > 2) mbar_expect_tx(bars, tx);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Before step t: wait for h_t, then (thread 0) arm its buffer for h_{t+2}.
__device__ __forceinline__ void wait_h(uint32_t bars, int t, int S,
                                       uint32_t tx) {
  if (t == 0) return;                            // h_0 = 0 is in place
  const uint32_t bar = bars + 8 * (t & 1);
  mbar_wait(bar, ((t - 1) >> 1) & 1);
  if (threadIdx.x == 0 && t + 2 < S) mbar_expect_tx(bar, tx);
}

// fp32: a cluster of C CTAs per (batch row, head), SIMT products.
template <int NCH>
__global__ void __launch_bounds__(NCH <= 4 ? 512 : 384, 1)
slstm_cluster_kernel(const float* __restrict__ gates,
                     const float* __restrict__ rz, const float* __restrict__ ri,
                     const float* __restrict__ rf, const float* __restrict__ ro,
                     float* __restrict__ out, int S, int H, int D, int C,
                     int P) {
  constexpr int kAhead = 4;                     // steps of gates loaded ahead
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunks = P * NCH;                   // >= D / 4; the rest stay 0
  const uint32_t bars = (uint32_t)__cvta_generic_to_shared(smem);  // 2 mbarriers
  float4* hbuf = reinterpret_cast<float4*>(smem + 16);  // [2][chunks]
  const uint32_t rank = cluster_rank();
  const int head = blockIdx.x / C, b = blockIdx.y;
  const int U = D / C;
  const int u = threadIdx.x / P, p = threadIdx.x % P;
  const int e = (int)rank * U + u;              // this thread's output unit
  const uint32_t tx = 4u * D;                   // h bytes a CTA receives a step

  // this unit's four R rows over chunks p, p + P, ... of d
  float4 r[4][NCH];
  const float* rows[4] = {rz, ri, rf, ro};
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int ch = p + P * c;
      r[g][c] = 4 * ch < D
          ? load_f4(rows[g] + ((size_t)head * D + e) * D + 4 * ch)
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  for (int i = threadIdx.x; i < 2 * chunks; i += blockDim.x)
    hbuf[i] = make_float4(0.f, 0.f, 0.f, 0.f);  // h_0 = 0, padding = 0
  arm(bars, S, tx);
  cluster_sync();   // every CTA of the cluster runs, its barriers armed

  // lane p writes this unit's h to CTA p
  const uint32_t h_self = (uint32_t)__cvta_generic_to_shared(hbuf) + 4 * e;
  const uint32_t h_peer = peer_addr(h_self, (uint32_t)(p % C));
  const uint32_t bar_peer = peer_addr(bars, (uint32_t)(p % C));
  const size_t g_step = (size_t)H * D * 4, o_step = (size_t)H * D;
  const float* gp = gates + (((size_t)b * S * H + head) * D + e) * 4;
  float* op = out + ((size_t)b * S * H + head) * D + e;
  float4 ahead[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    if (j < S) ahead[j] = load_f4(gp + (size_t)j * g_step);

  float c_s = 0.f, n_s = 0.f, m_s = kNegBig;
  for (int t0 = 0; t0 < S; t0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int t = t0 + j;
      if (t >= S) break;                         // the same for every thread
      const int buf = t & 1;
      wait_h(bars, t, S, tx);
      const float4 gx = ahead[j];
      if (t + kAhead < S) ahead[j] = load_f4(gp + (size_t)(t + kAhead) * g_step);

      const float4* hv = hbuf + buf * chunks;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 h4 = hv[p + P * c];
        a0 = dot4(h4, r[0][c], a0);
        a1 = dot4(h4, r[1][c], a1);
        a2 = dot4(h4, r[2][c], a2);
        a3 = dot4(h4, r[3][c], a3);
      }
      for (int off = P / 2; off; off >>= 1) {
        a0 += __shfl_xor_sync(0xffffffffu, a0, off);
        a1 += __shfl_xor_sync(0xffffffffu, a1, off);
        a2 += __shfl_xor_sync(0xffffffffu, a2, off);
        a3 += __shfl_xor_sync(0xffffffffu, a3, off);
      }
      const float hn = cell(gx.x + a0, gx.y + a1, gx.z + a2, gx.w + a3, c_s,
                            n_s, m_s);
      if (p < C && t + 1 < S)
        st_async(h_peer + (buf ^ 1) * chunks * 16, hn, bar_peer + 8 * (buf ^ 1));
      if (p == 0) op[(size_t)t * o_step] = hn;
    }
  }
  cluster_sync();   // no CTA leaves while a peer may still write to it
}

// ------------------------------------------- bf16: the step on tensor cores

constexpr int kMmaRows = 4;   // batch rows a cluster carries: hi, lo of each = n 8

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// Store 16 bytes at `remote` in a peer CTA, counted on its mbarrier.
__device__ __forceinline__ void st_async_v4(uint32_t remote, uint4 v,
                                            uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(remote), "r"(v.x), "r"(v.y),
      "r"(v.z), "r"(v.w), "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A cluster of C CTAs per (head, 4 batch rows).  Warp w of a CTA owns the
// local units 8 w .. 8 w + 7 as two m16 tiles of R (rows z, i, f, o of four
// units each), held as bf16 A fragments for the whole sequence.  h_t of the
// 4 rows is the n 8 operand: columns 2 q and 2 q + 1 are the bf16 hi and
// lo parts of row q, so each product is fp32-accurate to 2^-17 of h.
template <int KP>   // pairs of k16 steps: ceil(D / 32)
__global__ void __launch_bounds__(256, 1)
slstm_mma_kernel(const __nv_bfloat16* __restrict__ gates,
                 const __nv_bfloat16* __restrict__ rz,
                 const __nv_bfloat16* __restrict__ ri,
                 const __nv_bfloat16* __restrict__ rf,
                 const __nv_bfloat16* __restrict__ ro,
                 __nv_bfloat16* __restrict__ out, int B, int S, int H, int D,
                 int C) {
  constexpr int KS = 2 * KP;
  constexpr int kBuf = 16 * KS * 16;            // bytes: 16 KS k rows of 8 bf16
  constexpr int kAhead = 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bars = (uint32_t)__cvta_generic_to_shared(smem);  // 2 mbarriers
  const uint32_t hb = bars + 16;                // [2][16 KS][8] bf16
  const uint32_t rank = cluster_rank();
  const int head = blockIdx.x / C, b0 = blockIdx.y * kMmaRows;
  const int U = D / C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int ul = 8 * warp + g;                  // this lane's unit, local
  const bool unit_ok = ul < U;                  // the last warp may pad
  const int e = (int)rank * U + min(ul, U - 1);
  const int b = min(b0 + q, B - 1);             // a missing row repeats the last
  const uint32_t tx = 16u * D;                  // h bytes a CTA receives a step

  // A fragments: row g of tile t is gate z (g < 4) or i of unit 4 t + g % 4,
  // row g + 8 gate f or o of the same unit
  uint32_t a[2][KS][4];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int ut = 8 * warp + 4 * t + g % 4;
    const bool ok = ut < U;
    const size_t row = ((size_t)head * D + rank * U + min(ut, U - 1)) * D;
    const __nv_bfloat16* top = (g < 4 ? rz : ri) + row;
    const __nv_bfloat16* bot = (g < 4 ? rf : ro) + row;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int k = 16 * kk + 8 * h2 + 2 * q;
        a[t][kk][2 * h2] = ok && k < D ? ld_pair(top + k) : 0u;
        a[t][kk][2 * h2 + 1] = ok && k < D ? ld_pair(bot + k) : 0u;
      }
  }
  for (int i = threadIdx.x; i < 2 * kBuf / 16; i += blockDim.x)
    *reinterpret_cast<uint4*>(smem + 16 + 16 * i) = make_uint4(0, 0, 0, 0);
  arm(bars, S, tx);
  cluster_sync();   // every CTA of the cluster runs, its barriers armed

  // lane q writes this unit's 16 bytes to CTA q of the cluster
  const uint32_t h_peer = peer_addr(hb + 16 * e, (uint32_t)(q % C));
  const uint32_t bar_peer = peer_addr(bars, (uint32_t)(q % C));
  const size_t g_step = (size_t)H * D * 4, o_step = (size_t)H * D;
  const __nv_bfloat16* gp = gates + (((size_t)b * S * H + head) * D + e) * 4;
  __nv_bfloat16* op = out + ((size_t)b * S * H + head) * D + e;
  const bool store = unit_ok && b0 + q < B;
  uint2 ahead[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    if (j < S) ahead[j] = load_bf4(gp + (size_t)j * g_step);

  float c_s = 0.f, n_s = 0.f, m_s = kNegBig;
  for (int t0 = 0; t0 < S; t0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int t = t0 + j;
      if (t >= S) break;                         // the same for every thread
      const int buf = t & 1;
      wait_h(bars, t, S, tx);
      const float4 gx = bf4_to_f4(ahead[j]);
      if (t + kAhead < S) ahead[j] = load_bf4(gp + (size_t)(t + kAhead) * g_step);

      // the two tiles' products, each over two chains of k steps
      float acc[2][2][4];
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[t2][c][i] = 0.f;
#pragma unroll
      for (int jp = 0; jp < KP; ++jp) {
        uint32_t b00, b01, b10, b11;
        ldsm_x4_trans(hb + buf * kBuf + (32 * jp + lane) * 16, b00, b01, b10,
                      b11);
#pragma unroll
        for (int t2 = 0; t2 < 2; ++t2) {
          mma_bf16(acc[t2][0], a[t2][2 * jp], b00, b01);
          mma_bf16(acc[t2][1], a[t2][2 * jp + 1], b10, b11);
        }
      }
      // row g: columns 2 q (hi) + 2 q + 1 (lo); row g + 8 likewise
      float top[2], bot[2];
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2) {
        top[t2] = (acc[t2][0][0] + acc[t2][0][1]) + (acc[t2][1][0] + acc[t2][1][1]);
        bot[t2] = (acc[t2][0][2] + acc[t2][0][3]) + (acc[t2][1][2] + acc[t2][1][3]);
      }
      // lanes g < 4 take tile 0's unit g, lanes g >= 4 tile 1's unit g - 4:
      // both are local unit 8 warp + g
      const bool low = g < 4;
      const float r0 = __shfl_xor_sync(0xffffffffu, low ? top[1] : top[0], 16);
      const float r1 = __shfl_xor_sync(0xffffffffu, low ? bot[1] : bot[0], 16);
      const float hn = cell(gx.x + (low ? top[0] : r0),
                            gx.y + (low ? r0 : top[1]),
                            gx.z + (low ? bot[0] : r1),
                            gx.w + (low ? r1 : bot[1]), c_s, n_s, m_s);
      if (store) op[(size_t)t * o_step] = __float2bfloat16(hn);

      // h_{t+1}[e] of the 4 rows as (hi, lo) pairs: the quad's 16 bytes
      const __nv_bfloat16 hi = __float2bfloat16(hn);
      const __nv_bfloat16 lo = __float2bfloat16(hn - __bfloat162float(hi));
      const uint32_t word = (uint32_t)__bfloat16_as_ushort(hi) |
                            ((uint32_t)__bfloat16_as_ushort(lo) << 16);
      uint4 v;
      v.x = __shfl_sync(0xffffffffu, word, lane & ~3);
      v.y = __shfl_sync(0xffffffffu, word, (lane & ~3) | 1);
      v.z = __shfl_sync(0xffffffffu, word, (lane & ~3) | 2);
      v.w = __shfl_sync(0xffffffffu, word, (lane & ~3) | 3);
      if (unit_ok && q < C && t + 1 < S)
        st_async_v4(h_peer + (buf ^ 1) * kBuf, v, bar_peer + 8 * (buf ^ 1));
    }
  }
  cluster_sync();   // no CTA leaves while a peer may still write to it
}

// Launch `kernel` on clusters of C CTAs along x; check the launch.
template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, dim3 grid, int threads, size_t smem, int C,
                    cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int KP>
int launch_mma(const void* gates, const void* rz, const void* ri,
               const void* rf, const void* ro, void* out, int B, int S, int H,
               int D, int C, cudaStream_t stream) {
  using T = __nv_bfloat16;
  return launch_clusters(
      slstm_mma_kernel<KP>, dim3(H * C, (B + kMmaRows - 1) / kMmaRows, 1),
      32 * ((D / C + 7) / 8), 16 + 2 * 16 * (2 * KP) * 16, C, stream,
      static_cast<const T*>(gates), static_cast<const T*>(rz),
      static_cast<const T*>(ri), static_cast<const T*>(rf),
      static_cast<const T*>(ro), static_cast<T*>(out), B, S, H, D, C);
}

template <int NCH>
int launch_simt(const void* gates, const void* rz, const void* ri,
                const void* rf, const void* ro, void* out, int B, int S, int H,
                int D, int C, int P, cudaStream_t stream) {
  using T = float;
  return launch_clusters(
      slstm_cluster_kernel<NCH>, dim3(H * C, B, 1), (D / C) * P,
      16 + 2 * (size_t)P * NCH * sizeof(float4), C, stream,
      static_cast<const T*>(gates), static_cast<const T*>(rz),
      static_cast<const T*>(ri), static_cast<const T*>(rf),
      static_cast<const T*>(ro), static_cast<T*>(out), S, H, D, C, P);
}

}  // namespace

// fp32: gates (B,S,H,D,4), R (H,D,D) as R[h, out, in], out (B,S,H,D),
// contiguous, starting on 16-byte boundaries.  A cluster of C CTAs per
// (batch row, head), each of (D / C) * P threads, P parts of NCH chunks
// of 4 d values covering D.  Returns a cudaError_t (0 on success).
extern "C" int slstm_step_f32(const void* gates, const void* rz,
                              const void* ri, const void* rf, const void* ro,
                              void* out, int B, int S, int H, int D, int C,
                              int P, int NCH, void* stream) {
  if (D <= 0 || D % 4 != 0 || C < 1 || C > 8 || D % C != 0 || P < 1 ||
      P > 32 || (P & (P - 1)) != 0 || C > P || 4 * P * NCH < D)
    return (int)cudaErrorInvalidValue;
  const int threads = (D / C) * P;
  if (threads % 32 != 0 || threads > (NCH <= 4 ? 512 : 384))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (NCH) {
#define SLSTM_SIMT(n) \
  case n: return launch_simt<n>(gates, rz, ri, rf, ro, out, B, S, H, D, C, P, s);
    SLSTM_SIMT(1)
    SLSTM_SIMT(2)
    SLSTM_SIMT(3)
    SLSTM_SIMT(4)
    SLSTM_SIMT(5)
    SLSTM_SIMT(6)
#undef SLSTM_SIMT
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16: the same tensors in bfloat16, starting on 8-byte boundaries; D a
// multiple of 16 up to 256; a cluster of C (1, 2 or 4, dividing D) CTAs
// per head and 4 batch rows, each of 32 * ceil(D / C / 8) threads (at
// most 256).  Returns a cudaError_t (0 on success).
extern "C" int slstm_step_bf16(const void* gates, const void* rz,
                               const void* ri, const void* rf, const void* ro,
                               void* out, int B, int S, int H, int D, int C,
                               void* stream) {
  if (D <= 0 || D % 16 != 0 || D > 256 || (C != 1 && C != 2 && C != 4) ||
      D % C != 0 || 32 * ((D / C + 7) / 8) > 256)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
#define SLSTM_MMA(n) \
  case n: return launch_mma<n>(gates, rz, ri, rf, ro, out, B, S, H, D, C, s);
    SLSTM_MMA(1)
    SLSTM_MMA(2)
    SLSTM_MMA(3)
    SLSTM_MMA(4)
    SLSTM_MMA(5)
    SLSTM_MMA(6)
    SLSTM_MMA(7)
    SLSTM_MMA(8)
#undef SLSTM_MMA
    default: return (int)cudaErrorInvalidValue;
  }
}
