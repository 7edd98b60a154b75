// Chunkwise-parallel mLSTM forward (xLSTM matrix memory), written by hand
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_chunk.py
// (wrapper mlstm_chunk, body _mlstm_kernel): the same function, the
// chunkwise form of the mLSTM.  Per (batch row, head) the sequence is cut
// into chunks of L steps; across chunks it carries the matrix memory C
// (D x D), the normaliser n (D) and the stabiliser m, all fp32.  Per chunk:
// the log-sigmoid cumulative sum of the forget gates, the masked log-decay
// matrix, a row stabiliser max(intra, inter), the intra-chunk term
// (q k^T * decay) v plus the inter-chunk term q C, divided by
// max(|n_total|, exp(-m)), and the rank-L update of C and n.
//
// What bounds it.  At the xlstm-125m shape (B 8, S 4096, H 4, D 384,
// bf16) the inputs and output are 4 x 100.7 MB (~0.12 ms at 3.35 TB/s),
// while the chunkwise form does B*H*S*(4*L*D + 4*D^2) ~ 90 GFLOP at L 64,
// all of it matrix products: ~0.09 ms on the bf16 tensor cores (989
// TFLOP/s).  So bytes bound it, at ~0.12 ms.
//
// bf16 design (mlstm_mma_kernel): the products on the tensor cores.
//  * A CTA owns a (batch row, head, value tile of VT columns) and walks
//    the chunks in order, keeping its D x VT slice of C as fp32 mma
//    accumulators in registers.  VT is 96 where D allows it (12 warps),
//    else 64 (8 warps) or 32 (4 warps): at the shape above 4 x 4 x 8 =
//    128 CTAs, one wave on 132 SMs.  Each CTA computes the chunk's L x L
//    scores itself, D / VT times over a (batch row, head): 4 times at
//    D 384 rather than the 6 of a 64-column tile.
//  * Every product runs on mma.sync m16n8k16 with bf16 operands and fp32
//    accumulators: q k^T, q C, P v and (w k)^T v.  The transposed operands
//    (k^T in the C update, C and v as the k-major B operands) come from
//    ldmatrix.trans, so nothing is transposed in memory.  The operands
//    that are not inputs go in as two bf16 parts, hi + lo (two products
//    each, exact to ~2^-17): the decayed scores P, the copy of the old C
//    that q C reads, and w v, v scaled by its state-update weight once a
//    chunk, for the C update k^T (w v).  The output divides by n_total,
//    which can be far smaller than the terms, and one bf16 rounding of
//    any of the three puts the kernel outside the bf16 tolerance, at the
//    xlstm-125m kernel shape (P, C) or on the model's own activations
//    (w v), as a CPU model of the roundings shows.
//  * fp32 throughout for the gates (cumulative log-sigmoid sum, row
//    stabiliser, decay exponentials), the row sums of the decayed scores,
//    q n and n itself, and C across chunks: C <- decay C + (w k)^T v is
//    one scale and one accumulation into the same registers.
//  * The head dim streams through shared memory in slabs of 32: a 3-stage
//    ring of (q, k) slabs filled by cp.async two slabs ahead, across chunk
//    boundaries, with the next chunk's v tile riding with a chunk's first
//    slab (four v buffers), so that a chunk's v is there when its gates
//    are.  One barrier a slab.  In a slab each warp first
//    writes its tiles of that slab's old C as bf16 (two buffers), then
//    adds the slab's part of the scores and of q C, then updates the
//    slab's rows of C and n.
//  * A ragged last chunk is masked: steps past S read i = -inf (they
//    write nothing into C or n), f with no decay, and zero q, k, v (the
//    cp.async zero-fill); their rows are never stored.  So S need not be
//    a multiple of L.
//  * q, k and v are read by strides in their (B, S, H, D) layout, 16
//    bytes a copy (unit-stride head dim, 16-byte strides); i and f by any
//    strides; the output is written contiguous.
//
// fp32 design (mlstm_simt_kernel): the products as SIMT fp32
// FMAs from shared memory, C tiled over the value dim (grid D / VT x H x
// B, a CTA's D x VT slice of C in shared memory), the head dim streamed
// through shared memory in slabs of 32, stored transposed.  About 1% of
// the bound; fp32 inputs are off the model's path.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream and the function returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;      // chunk length
constexpr int kDS = 32;     // head-dim slab streamed through shared memory
constexpr int kNT = 256;    // threads per CTA
constexpr float kNegBig = -1e30f;   // m's initial value, as in the TPU kernel

struct Strides {
  long long b, s, h;        // in elements; the head dim is unit-stride
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* i;
  const void* f;
  void* o;
  Strides sq, sk, sv, si, sf;
  int S, H, D;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// log(sigmoid(x)) = min(x, 0) - log1p(exp(-|x|)), as jax.nn.log_sigmoid
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// Four (or two) consecutive values of a row, to and from T.
template <int W> struct Vec;
template <> struct Vec<4> {
  float v[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};
template <> struct Vec<2> {
  float v[2];
  __device__ __forceinline__ void load(const float* p) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
};

// Four consecutive fp32 elements of global memory (16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}

template <int W>
__device__ __forceinline__ void store(float* p, const float (&x)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
template <typename T, int VT>
__global__ void __launch_bounds__(kNT) mlstm_simt_kernel(Args a) {
  constexpr int CW = VT / 16;   // contiguous output columns per thread
  constexpr int LDT = kL + 4;   // rows of the transposed tiles: 16-byte
                                // aligned, and 4 banks apart
  const int D = a.D;

  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;              // D x VT: this CTA's slice of C
  float* ns = Cs + D * VT;       // D
  float* Qt = ns + D;            // kDS x LDT: q slab transposed, pre-scaled
  float* Kt = Qt + kDS * LDT;    // kDS x LDT: k slab transposed
  float* Vs = Kt + kDS * LDT;    // L x VT: the chunk's v tile
  float* Pt = Vs + kL * VT;      // L x LDT: decayed scores, transposed [j][i]
  float* cum_s = Pt + kL * LDT;  // inclusive cumsum of log sigmoid(f)
  float* it_s = cum_s + kL;      // input-gate pre-activations
  float* a_s = it_s + kL;        // it_j + g - cum_j
  float* w_s = a_s + kL;         // exp(a_j - m_next): state-update weights
  float* mi_s = w_s + kL;        // row stabiliser
  float* iw_s = mi_s + kL;       // inter-chunk weight
  float* den_s = iw_s + kL;      // denominator

  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * VT, h = blockIdx.y, b = blockIdx.z;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h + v0;
  const T* ig = static_cast<const T*>(a.i) + b * a.si.b + h * a.si.h;
  const T* fg = static_cast<const T*>(a.f) + b * a.sf.b + h * a.sf.h;
  const size_t o_row = (size_t)a.H * D;
  T* o = static_cast<T*>(a.o) + (size_t)b * a.S * o_row + (size_t)h * D + v0;

  for (int x = tid; x < D * VT; x += kNT) Cs[x] = 0.f;
  for (int x = tid; x < D; x += kNT) ns[x] = 0.f;
  float m_prev = kNegBig;

  // score patch: rows 4 rg .. 4 rg + 3, columns 4 cg .. 4 cg + 3; value
  // patch: the same rows, columns CW cg ..; C-update patch: head-dim rows
  // 2 rg, 2 rg + 1 of the slab, the same value columns
  const int rg = tid / 16, cg = tid % 16;

  for (int c0 = 0; c0 < a.S; c0 += kL) {
    const int Lc = min(kL, a.S - c0);

    // ---- the chunk's gates (log sigmoid(f) into cum_s) and V tile
    if (tid < kL) {
      const bool ok = tid < Lc;
      const long long t = c0 + tid;
      it_s[tid] = ok ? to_f(ig[t * a.si.s]) : -INFINITY;
      cum_s[tid] = ok ? log_sigmoid(to_f(fg[t * a.sf.s])) : 0.f;
    }
    for (int x = tid; x < kL * VT / 4; x += kNT) {
      const int j = x / (VT / 4), c = (x % (VT / 4)) * 4;
      float t4[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < Lc) load4(v + (long long)(c0 + j) * a.sv.s + c, t4);
      store<4>(Vs + j * VT + c, t4);
    }
    __syncthreads();

    // inclusive cumsum of the 64 log forget gates: warp 0, two a lane
    if (tid < 32) {
      const float x0 = cum_s[2 * tid], x1 = cum_s[2 * tid + 1];
      float s = x0 + x1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, s, off);
        if (tid >= off) s += y;
      }
      float excl = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) excl = 0.f;
      cum_s[2 * tid] = excl + x0;
      cum_s[2 * tid + 1] = excl + x0 + x1;
    }
    __syncthreads();

    // ---- row statistics: thread i < L owns row i
    const float g = cum_s[kL - 1];   // the chunk's total log decay
    if (tid < kL) {
      const float ci = cum_s[tid];
      float m_intra = -INFINITY;
      for (int j = 0; j <= tid; ++j)
        m_intra = fmaxf(m_intra, ci - cum_s[j] + it_s[j]);
      const float m_inter = ci + m_prev;
      const float mi = fmaxf(fmaxf(m_intra, m_inter), kNegBig);
      mi_s[tid] = mi;
      iw_s[tid] = expf(m_inter - mi);
      a_s[tid] = it_s[tid] + g - ci;
    }
    __syncthreads();
    float a_max = -INFINITY;
    for (int j = 0; j < kL; ++j) a_max = fmaxf(a_max, a_s[j]);
    const float m_next = fmaxf(g + m_prev, a_max);
    const float decay = expf(g + m_prev - m_next);
    if (tid < kL) w_s[tid] = expf(a_s[tid] - m_next);   // read after a barrier

    // ---- stream the head dim: scores, q C and q n, then the C, n update
    float sacc[4][4], hacc[4][CW];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sacc[ii][jj] = 0.f;
#pragma unroll
      for (int jj = 0; jj < CW; ++jj) hacc[ii][jj] = 0.f;
    }
    float n_inter = 0.f;
    for (int d0 = 0; d0 < D; d0 += kDS) {
      // rows of q and k, four head-dim values a load, stored transposed
      for (int x = tid; x < kL * kDS / 4; x += kNT) {
        const int j = x / (kDS / 4), c = (x % (kDS / 4)) * 4;
        float tq[4] = {0.f, 0.f, 0.f, 0.f}, tk[4] = {0.f, 0.f, 0.f, 0.f};
        if (j < Lc) {
          load4(q + (long long)(c0 + j) * a.sq.s + d0 + c, tq);
          load4(k + (long long)(c0 + j) * a.sk.s + d0 + c, tk);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          Qt[(c + e) * LDT + j] = tq[e] * a.scale;
          Kt[(c + e) * LDT + j] = tk[e];
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < kDS; ++dd) {
        Vec<4> qv, kv;
        Vec<CW> cv;
        qv.load(Qt + dd * LDT + 4 * rg);
        kv.load(Kt + dd * LDT + 4 * cg);
        cv.load(Cs + (d0 + dd) * VT + CW * cg);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            sacc[ii][jj] = fmaf(qv.v[ii], kv.v[jj], sacc[ii][jj]);
#pragma unroll
          for (int jj = 0; jj < CW; ++jj)
            hacc[ii][jj] = fmaf(qv.v[ii], cv.v[jj], hacc[ii][jj]);
        }
      }
      if (tid < kL)
        for (int dd = 0; dd < kDS; ++dd)
          n_inter = fmaf(Qt[dd * LDT + tid], ns[d0 + dd], n_inter);
      __syncthreads();   // the old C and n rows of this slab are read

      // rank-L update of the slab's rows: C += (w k)^T v, n += (w k)^T 1
      float cacc[2][CW], nacc[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < CW; ++c) cacc[r][c] = 0.f;
      const float* k0p = Kt + (2 * rg) * LDT;
#pragma unroll 4
      for (int j = 0; j < kL; ++j) {
        const float w = w_s[j];
        const float kw0 = k0p[j] * w, kw1 = k0p[LDT + j] * w;
        Vec<CW> vv;
        vv.load(Vs + j * VT + CW * cg);
        nacc[0] += kw0;
        nacc[1] += kw1;
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          cacc[0][c] = fmaf(kw0, vv.v[c], cacc[0][c]);
          cacc[1][c] = fmaf(kw1, vv.v[c], cacc[1][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float* cp = Cs + (d0 + 2 * rg + r) * VT + CW * cg;
        float nv[CW];
        Vec<CW> old;
        old.load(cp);
#pragma unroll
        for (int c = 0; c < CW; ++c) nv[c] = decay * old.v[c] + cacc[r][c];
        store<CW>(cp, nv);
        if (cg == 0) ns[d0 + 2 * rg + r] = decay * ns[d0 + 2 * rg + r] + nacc[r];
      }
      __syncthreads();   // before the next slab overwrites Qt and Kt
    }

    // ---- intra-chunk term: decayed scores, their row sums, times V
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * cg + jj;
      float col[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = 4 * rg + ii;
        col[ii] = j <= i ? sacc[ii][jj] *
                               expf(cum_s[i] - cum_s[j] + it_s[j] - mi_s[i])
                         : 0.f;
      }
      store<4>(Pt + j * LDT + 4 * rg, col);
    }
    __syncthreads();
    if (tid < kL) {
      float rs = 0.f;
      for (int j = 0; j < kL; ++j) rs += Pt[j * LDT + tid];
      const float n_total = rs + n_inter * iw_s[tid];
      den_s[tid] = fmaxf(fabsf(n_total), expf(-mi_s[tid]));
    }
    float oacc[4][CW];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < CW; ++jj) oacc[ii][jj] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kL; ++j) {
      Vec<4> p;
      Vec<CW> vv;
      p.load(Pt + j * LDT + 4 * rg);
      vv.load(Vs + j * VT + CW * cg);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < CW; ++jj)
          oacc[ii][jj] = fmaf(p.v[ii], vv.v[jj], oacc[ii][jj]);
    }
    __syncthreads();   // den_s is written
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int i = 4 * rg + ii;
      if (i >= Lc) continue;
      const float iw = iw_s[i], den = den_s[i];
      float r[CW];
#pragma unroll
      for (int jj = 0; jj < CW; ++jj)
        r[jj] = (oacc[ii][jj] + hacc[ii][jj] * iw) / den;
      store<CW>(o + (size_t)(c0 + i) * o_row + CW * cg, r);
    }
    m_prev = m_next;
    __syncthreads();   // the next chunk rewrites the gate vectors and Vs
  }
}

template <typename T, int VT>
int launch_simt(const Args& a, int B, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)a.D * VT + a.D + 2 * kDS * (kL + 4) +
                       kL * VT + kL * (kL + 4) + 7 * kL);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_simt_kernel<T, VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.D / VT, a.H, B);
  mlstm_simt_kernel<T, VT><<<grid, kNT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}


// ------------------------------------- bf16: the products on tensor cores

using bf16 = __nv_bfloat16;
constexpr int kSlab = 32;        // head-dim rows a pipeline stage carries
constexpr int kQLD = kSlab + 8;  // q, k slab row: 80 bytes, so that the 8
                                 // rows an ldmatrix reads hit 8 bank groups
constexpr int kPLD = kL + 8;     // P row
constexpr int kStages = 3;       // q, k slabs in flight: two ahead

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, zero-filled where !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// c += a b: m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}
// (x0, x1) as a bf16 pair hi and the bf16 pair lo of what hi misses:
// hi + lo carries x to ~2^-17 of |x|
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h2);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack_bf16(x0 - back.x, x1 - back.y);
}

// NV: value tile 32 NV columns, 4 NV warps; NS: head-dim slabs, D / 32.
//
// Warp w's tiles:
//  * q C and the output: rows 16 (w / NV) .., columns 32 (w % NV) .. of
//    the chunk's L x VT block (4 n8 tiles);
//  * the scores q k^T: the same rows, key columns 32 b .. for b = w % NV
//    when that is 0 or 1 (NV 1: both blocks, NV 3: none for w % 3 == 2);
//  * C: in every slab of 32 head-dim rows, rows 16 (w & 1) .. and columns
//    16 (w >> 1) .. (two n8 tiles) of the value tile: NS x 2 fp32
//    accumulator tiles, the CTA's whole D x VT slice of C.  The slab loop
//    is unrolled, so that every index into creg is static and C stays in
//    registers.
template <int NV, int NS>
__global__ void __launch_bounds__(128 * NV, 1) mlstm_mma_kernel(Args a) {
  constexpr int VT = 32 * NV, NT = 128 * NV;
  constexpr int VLD = VT + 8;           // v and C-copy rows, as kQLD
  constexpr int SB = NV == 1 ? 2 : 1;   // score column blocks a warp
  const int D = NS * kSlab, ns = NS, S = a.S;
  const int nchunks = (S + kL - 1) / kL, total = nchunks * ns;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // kStages x (q, k) slabs
  bf16* vbuf = ring + kStages * 2 * kL * kQLD;      // 4 x L x VT: v tiles
  bf16* vw = vbuf + 4 * kL * VLD;       // (hi, lo) x L x VT: w v, the C
                                        // update's B
  bf16* cbuf = vw + 2 * kL * VLD;       // 2 x (hi, lo) x 32 x VT: old C
  bf16* pbuf = cbuf + 4 * kSlab * VLD;  // (hi, lo) x L x L: decayed scores
  float* nbuf = reinterpret_cast<float*>(pbuf + 2 * kL * kPLD);  // 2 x D: n
  float* cum_s = nbuf + 2 * D;    // inclusive cumsum of log sigmoid(f)
  float* it_s = cum_s + kL;       // input-gate pre-activations
  float* mi_s = it_s + kL;        // row stabiliser
  float* iw_s = mi_s + kL;        // inter-chunk weight
  float* w_s = iw_s + kL;         // state-update weights
  float* qn_s = w_s + kL;         // q n, scaled
  float* rs_s = qn_s + kL;        // 2 x L: row sums of two column blocks
  float* sc_s = rs_s + 2 * kL;    // decay, m_next

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int v0 = blockIdx.x * VT, h = blockIdx.y, b = blockIdx.z;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h + v0;
  const bf16* ig = static_cast<const bf16*>(a.i) + b * a.si.b + h * a.si.h;
  const bf16* fg = static_cast<const bf16*>(a.f) + b * a.sf.b + h * a.sf.h;
  const size_t o_row = (size_t)a.H * D;
  bf16* o = static_cast<bf16*>(a.o) + (size_t)b * S * o_row + (size_t)h * D + v0;

  // v tile of chunk c into buffer c % 4
  auto fetch_v = [&](int c) {
    const uint32_t vd = smem_u32(vbuf + (c % 4) * kL * VLD);
    for (int x = tid; x < kL * VT / 8; x += NT) {
      const int j = x / (VT / 8), part = (x % (VT / 8)) * 8;
      const long long tt = (long long)c * kL + j;
      const bool ok = tt < S;
      cp_async16(vd + (j * VLD + part) * 2, v + (ok ? tt : 0) * a.sv.s + part,
                 ok);
    }
  };
  // the q, k slabs of global slab t (chunk t / ns, head-dim slab t % ns),
  // and with a chunk's first slab the next chunk's v tile (the first also
  // chunk 0's); always one commit group
  auto fetch = [&](int t) {
    if (t < total) {
      const int c = t / ns, s = t - c * ns;
      const uint32_t qd = smem_u32(ring + (t % kStages) * 2 * kL * kQLD);
      const uint32_t kd = qd + kL * kQLD * 2;
      for (int x = tid; x < kL * kSlab / 8; x += NT) {
        const int j = x / (kSlab / 8), part = (x % (kSlab / 8)) * 8;
        const long long tt = (long long)c * kL + j;
        const bool ok = tt < S;
        const long long r = ok ? tt : 0;
        const uint32_t off = (j * kQLD + part) * 2;
        cp_async16(qd + off, q + r * a.sq.s + s * kSlab + part, ok);
        cp_async16(kd + off, k + r * a.sk.s + s * kSlab + part, ok);
      }
      if (t == 0) fetch_v(0);
      if (s == 0 && c + 1 < nchunks) fetch_v(c + 1);
    }
    cp_async_commit();
  };

  // gates of chunk c into warp 0's registers (steps 2 lane, 2 lane + 1)
  float gi[2], gf[2];
  auto load_gates = [&](int c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long t = (long long)c * kL + 2 * lane + e;
      gi[e] = t < S ? to_f(ig[t * a.si.s]) : -INFINITY;
      gf[e] = t < S ? to_f(fg[t * a.sf.s]) : INFINITY;   // no decay
    }
  };

  fetch(0);
  fetch(1);
  if (warp == 0) load_gates(0);
  for (int x = tid; x < D; x += NT) nbuf[x] = 0.f;
  float creg[NS][2][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int ti = 0; ti < 2; ++ti)
#pragma unroll
      for (int e = 0; e < 4; ++e) creg[s][ti][e] = 0.f;
  float m_prev = kNegBig;

  const int rb = warp / NV, vb = warp % NV;    // output tile
  const bool scorer = NV == 1 || vb < 2;
  const int cm = warp & 1, cn = 2 * (warp >> 1);   // C tiles of a slab
  const int g8 = lane / 8, r8 = lane % 8;          // ldmatrix address roles
  const int row0 = 16 * rb + lane / 4, col2 = 2 * (lane % 4);

#pragma unroll 1
  for (int c = 0; c < nchunks; ++c) {
    const float* ncur = nbuf + (c & 1) * D;
    float* nnext = nbuf + ((c + 1) & 1) * D;
    const bf16* vt = vbuf + (c % 4) * kL * VLD;

    // ---- the chunk's gate statistics (warp 0; two steps a lane)
    cp_async_wait<1>();   // this chunk's v (it came with slab c ns - ns)
    __syncthreads();      // the last chunk's output has read the stats
    if (warp == 0) {
      float it[2], lf[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        it[e] = gi[e];
        lf[e] = gf[e] == INFINITY ? 0.f : log_sigmoid(gf[e]);
      }
      float s = lf[0] + lf[1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += y;
      }
      float ex = __shfl_up_sync(0xffffffffu, s, 1);
      if (lane == 0) ex = 0.f;
      const float cum[2] = {ex + lf[0], ex + lf[0] + lf[1]};
      const float g = __shfl_sync(0xffffffffu, cum[1], 31);
      // m_intra_i = max_{j <= i} (cum_i - cum_j + it_j): a prefix max
      const float x0 = it[0] - cum[0], x1 = it[1] - cum[1];
      float pm = fmaxf(x0, x1);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, pm, off);
        if (lane >= off) pm = fmaxf(pm, y);
      }
      float pex = __shfl_up_sync(0xffffffffu, pm, 1);
      if (lane == 0) pex = -INFINITY;
      const float pmx[2] = {fmaxf(pex, x0), pm};
      float amax = fmaxf(it[0] + g - cum[0], it[1] + g - cum[1]);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float m_next = fmaxf(g + m_prev, amax);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 2 * lane + e;
        const float m_inter = cum[e] + m_prev;
        const float mi = fmaxf(fmaxf(cum[e] + pmx[e], m_inter), kNegBig);
        cum_s[j] = cum[e];
        it_s[j] = it[e];
        mi_s[j] = mi;
        iw_s[j] = expf(m_inter - mi);
        w_s[j] = expf(it[e] + g - cum[e] - m_next);
      }
      if (lane == 0) {
        sc_s[0] = expf(g + m_prev - m_next);
        sc_s[1] = m_next;
      }
      if (c + 1 < nchunks) load_gates(c + 1);
    }
    __syncthreads();
    const float decay = sc_s[0];
    m_prev = sc_s[1];
    // w v as bf16 hi + lo, the B operand of the C update (read after the
    // first slab's barrier)
    for (int x = tid; x < kL * VT / 2; x += NT) {
      const int j = x / (VT / 2), col = (x % (VT / 2)) * 2;
      const float2 f2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vt + j * VLD + col));
      const float w = w_s[j];
      split_pair(w * f2.x, w * f2.y,
                 *reinterpret_cast<uint32_t*>(vw + j * VLD + col),
                 *reinterpret_cast<uint32_t*>(vw + (kL + j) * VLD + col));
    }

    float sacc[SB][4][4], hacc[4][4], qn = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hacc[nt][e] = 0.f;
#pragma unroll
        for (int sb = 0; sb < SB; ++sb) sacc[sb][nt][e] = 0.f;
      }

    // ---- the head dim, slab by slab: scores, q C, q n; then C and n
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int t = c * ns + s;
      bf16* cb = cbuf + (t & 1) * 2 * kSlab * VLD;   // hi, then lo
      // this warp's tiles of the old C, as bf16 hi + lo, for q C
#pragma unroll
      for (int ti = 0; ti < 2; ++ti)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int x = (16 * cm + lane / 4 + 8 * hf) * VLD + 8 * (cn + ti) +
                        col2;
          split_pair(creg[s][ti][2 * hf], creg[s][ti][2 * hf + 1],
                     *reinterpret_cast<uint32_t*>(cb + x),
                     *reinterpret_cast<uint32_t*>(cb + kSlab * VLD + x));
        }
      cp_async_wait<1>();   // slab t is here
      __syncthreads();
      fetch(t + 2);
      const bf16* qs = ring + (t % kStages) * 2 * kL * kQLD;
      const bf16* ks = qs + kL * kQLD;

#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk) {
        uint32_t af[4];
        ldsm_x4(smem_u32(qs + (16 * rb + lane % 16) * kQLD + 16 * kk +
                         8 * (lane / 16)), af);
        if (scorer) {
#pragma unroll
          for (int sb = 0; sb < SB; ++sb) {
            const int blk = NV == 1 ? sb : vb;
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              uint32_t bf[4];   // k rows are the n index: no transpose
              ldsm_x4(smem_u32(ks + (32 * blk + 16 * np + 8 * (g8 >> 1) + r8)
                                        * kQLD + 16 * kk + 8 * (g8 & 1)), bf);
              mma(sacc[sb][2 * np], af, bf[0], bf[1]);
              mma(sacc[sb][2 * np + 1], af, bf[2], bf[3]);
            }
          }
        }
#pragma unroll
        for (int np = 0; np < 2; ++np)
#pragma unroll
          for (int part = 0; part < 2; ++part) {   // C's hi, then lo
            uint32_t bf[4];     // C rows are the k index: transposed
            ldsm_x4_t(smem_u32(cb + part * kSlab * VLD +
                               (16 * kk + 8 * (g8 & 1) + r8) * VLD +
                               32 * vb + 16 * np + 8 * (g8 >> 1)), bf);
            mma(hacc[2 * np], af, bf[0], bf[1]);
            mma(hacc[2 * np + 1], af, bf[2], bf[3]);
          }
      }

      // q n and the slab's n update, fp32, 128 threads each (NV 1: the
      // same 128 for both).  q n: row tid / 2, half tid % 2 of the slab's
      // head dim, kept per thread and summed over the pair at the end.
      if (tid < 128) {
        const int i = tid >> 1, d0 = 16 * (tid & 1);
        const uint4* qr = reinterpret_cast<const uint4*>(qs + i * kQLD + d0);
        const float4* nr = reinterpret_cast<const float4*>(ncur + s * kSlab + d0);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const uint4 u = qr[x];
          const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
          const float4 n0 = nr[2 * x], n1 = nr[2 * x + 1];
          const float nv[8] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            const float2 f2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&w4[y]));
            qn = fmaf(f2.x, nv[2 * y], qn);
            qn = fmaf(f2.y, nv[2 * y + 1], qn);
          }
        }
      }
      // n update: head-dim pair 2 (u / 8), steps u % 8 + 8 x, summed over
      // the 8 lanes of a pair
      if (NV == 1 || (tid >= 128 && tid < 256)) {
        const int u = tid % 128, dp = 2 * (u >> 3), jq = u & 7;
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
        for (int x = 0; x < kL / 8; ++x) {
          const int j = jq + 8 * x;
          const float w = w_s[j];
          const float2 k2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(ks + j * kQLD + dp));
          acc0 = fmaf(w, k2.x, acc0);
          acc1 = fmaf(w, k2.y, acc1);
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) {
          acc0 += __shfl_xor_sync(0xffffffffu, acc0, off);
          acc1 += __shfl_xor_sync(0xffffffffu, acc1, off);
        }
        if (jq == 0) {
          const int d = s * kSlab + dp;
          nnext[d] = fmaf(decay, ncur[d], acc0);
          nnext[d + 1] = fmaf(decay, ncur[d + 1], acc1);
        }
      }

      // C <- decay C + k^T (w v): A = k^T (transposed)
#pragma unroll
      for (int ti = 0; ti < 2; ++ti)
#pragma unroll
        for (int e = 0; e < 4; ++e) creg[s][ti][e] *= decay;
#pragma unroll
      for (int kk = 0; kk < kL / 16; ++kk) {
        uint32_t af[4];
        ldsm_x4_t(smem_u32(ks + (16 * kk + 8 * (g8 >> 1) + r8) * kQLD +
                           16 * cm + 8 * (g8 & 1)), af);
#pragma unroll
        for (int part = 0; part < 2; ++part) {   // w v's hi, then lo
          uint32_t bf[4];
          ldsm_x4_t(smem_u32(vw + (part * kL + 16 * kk + 8 * (g8 & 1) + r8) *
                                      VLD + 8 * cn + 8 * (g8 >> 1)), bf);
          mma(creg[s][0], af, bf[0], bf[1]);
          mma(creg[s][1], af, bf[2], bf[3]);
        }
      }
    }

    // ---- the decayed scores into P (bf16 hi + lo), row sums in fp32
    if (scorer) {
#pragma unroll
      for (int sb = 0; sb < SB; ++sb) {
        const int blk = NV == 1 ? sb : vb;
        float rsum[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = row0 + 8 * hf;
            const int j = 32 * blk + 8 * nt + col2;
            float p[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              p[e] = j + e <= i
                         ? sacc[sb][nt][2 * hf + e] * a.scale *
                               expf(cum_s[i] - cum_s[j + e] + it_s[j + e] -
                                    mi_s[i])
                         : 0.f;
            rsum[hf] += p[0] + p[1];
            split_pair(p[0], p[1],
                       *reinterpret_cast<uint32_t*>(pbuf + i * kPLD + j),
                       *reinterpret_cast<uint32_t*>(pbuf + (kL + i) * kPLD + j));
          }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          rsum[hf] += __shfl_xor_sync(0xffffffffu, rsum[hf], 1);
          rsum[hf] += __shfl_xor_sync(0xffffffffu, rsum[hf], 2);
          if (lane % 4 == 0) rs_s[blk * kL + row0 + 8 * hf] = rsum[hf];
        }
      }
    }
    if (tid < 128) {   // the two halves of each row's q n
      qn += __shfl_xor_sync(0xffffffffu, qn, 1);
      if (!(tid & 1)) qn_s[tid >> 1] = qn * a.scale;
    }
    __syncthreads();

    // ---- intra-chunk term P v, plus the inter-chunk term, over n_total
    float oacc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk) {
      uint32_t ah[4], al[4];   // P's hi and lo
      const int x = (16 * rb + lane % 16) * kPLD + 16 * kk + 8 * (lane / 16);
      ldsm_x4(smem_u32(pbuf + x), ah);
      ldsm_x4(smem_u32(pbuf + kL * kPLD + x), al);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldsm_x4_t(smem_u32(vt + (16 * kk + 8 * (g8 & 1) + r8) * VLD +
                           32 * vb + 16 * np + 8 * (g8 >> 1)), bf);
        mma(oacc[2 * np], ah, bf[0], bf[1]);
        mma(oacc[2 * np + 1], ah, bf[2], bf[3]);
        mma(oacc[2 * np], al, bf[0], bf[1]);
        mma(oacc[2 * np + 1], al, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = row0 + 8 * hf;
      if ((long long)c * kL + i >= S) continue;
      const float iw = iw_s[i];
      const float n_total = rs_s[i] + rs_s[kL + i] + qn_s[i] * iw;
      const float inv = 1.f / fmaxf(fabsf(n_total), expf(-mi_s[i]));
      const float hw = a.scale * iw;
      bf16* orow = o + ((size_t)c * kL + i) * o_row + 32 * vb + col2;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<uint32_t*>(orow + 8 * nt) = pack_bf16(
            (oacc[nt][2 * hf] + hacc[nt][2 * hf] * hw) * inv,
            (oacc[nt][2 * hf + 1] + hacc[nt][2 * hf + 1] * hw) * inv);
    }
  }
  cp_async_wait<0>();
}

template <int NV, int NS>
int launch_mma(const Args& a, int B, cudaStream_t stream) {
  constexpr int VT = 32 * NV, VLD = VT + 8;
  const size_t smem =
      2 * ((size_t)kStages * 2 * kL * kQLD + 6 * kL * VLD + 4 * kSlab * VLD +
           2 * kL * kPLD) +
      sizeof(float) * ((size_t)2 * a.D + 8 * kL + 2);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_mma_kernel<NV, NS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.D / VT, a.H, B);
  mlstm_mma_kernel<NV, NS><<<grid, 128 * NV, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The value tile: 96 columns where D is a multiple of 96 and its slice of
// C fits the registers of 12 warps (D <= 384), else 64, else 32.
int launch_bf16(const Args& a, int B, cudaStream_t s) {
  switch (a.D / kSlab) {
    case 1: return launch_mma<1, 1>(a, B, s);
    case 2: return launch_mma<2, 2>(a, B, s);
    case 3: return launch_mma<3, 3>(a, B, s);
    case 4: return launch_mma<2, 4>(a, B, s);
    case 5: return launch_mma<1, 5>(a, B, s);
    case 6: return launch_mma<3, 6>(a, B, s);
    case 7: return launch_mma<1, 7>(a, B, s);
    case 8: return launch_mma<2, 8>(a, B, s);
    case 9: return launch_mma<3, 9>(a, B, s);
    case 10: return launch_mma<2, 10>(a, B, s);
    case 11: return launch_mma<1, 11>(a, B, s);
    case 12: return launch_mma<3, 12>(a, B, s);
    case 13: return launch_mma<1, 13>(a, B, s);
    case 14: return launch_mma<2, 14>(a, B, s);
    case 15: return launch_mma<1, 15>(a, B, s);
    case 16: return launch_mma<2, 16>(a, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: (B,S,H,D), i, f: (B,S,H), each read by the strides given
// (15 values: b, s and h strides of q, k, v, i, f in elements; the head
// dim unit-stride; q, k and v 16-byte aligned, with strides of whole 16
// bytes); o: (B,S,H,D) contiguous.  scale = D**-0.5.  dtype
// 0 = float32, 1 = bfloat16, the same for all.  Returns a cudaError_t
// (0 on success).
extern "C" int mlstm_chunk_fwd(const void* q, const void* k, const void* v,
                               const void* i, const void* f, void* o,
                               const long long* strides, int B, int S, int H,
                               int D, float scale, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (D <= 0 || D % 32 != 0 || D > 512) return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  Args a;
  a.q = q; a.k = k; a.v = v; a.i = i; a.f = f; a.o = o;
  Strides* st[5] = {&a.sq, &a.sk, &a.sv, &a.si, &a.sf};
  for (int t = 0; t < 5; ++t) {
    st[t]->b = strides[3 * t];
    st[t]->s = strides[3 * t + 1];
    st[t]->h = strides[3 * t + 2];
  }
  a.S = S; a.H = H; a.D = D; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D % 64 == 0 ? launch_simt<float, 64>(a, B, s)
                       : launch_simt<float, 32>(a, B, s);
  return launch_bf16(a, B, s);
}
