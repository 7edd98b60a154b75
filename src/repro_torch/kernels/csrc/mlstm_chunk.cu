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
// max(|n_total|, exp(-m)), and the rank-L update of C and n.  All math is
// fp32, whatever the input type, as in the TPU kernel.
//
// What bounds it.  At the xlstm-125m shape (B 8, S 4096, H 4, D 384,
// bf16) the inputs and output are 4 x 100.7 MB (~0.12 ms at 3.35 TB/s),
// while the chunkwise form does B*H*S*(4*L*D + 4*D^2) ~ 90 GFLOP at L 64,
// all of it matrix products: ~0.09 ms on the bf16 tensor cores (989
// TFLOP/s), which the bf16 tolerance admits.  So bytes bound it, at
// ~0.12 ms.  This first version runs the products as SIMT fp32 FMAs from
// shared memory, about 1% of that bound; tensor-core products (mma/wgmma)
// are later work.
//
// Design (rethought for the card, not carried over block by block):
//  * On the TPU the chunk axis is a sequential grid axis with C, n and m
//    in VMEM.  Here one CTA owns a (batch row, head, value tile) and loops
//    over the chunks itself.
//  * At D 384, C is 576 KiB in fp32, beyond a CTA's 227 KiB.  So C is
//    tiled over the value dim: grid (D / VT, H, B), each CTA keeping its
//    D x VT slice of C (96 KiB at VT 64) and its own copy of n and m,
//    which do not depend on the value tile.  Each CTA recomputes the
//    chunk's L x L score and decay matrix from the full-D q and k: that is
//    redundant across value tiles, and accepted for now.
//  * q and k are never held whole: the head dim is streamed through
//    shared memory in slabs of 32, stored transposed.  Each slab adds to
//    the L x L scores and to q C, both kept in registers (a thread owns 4
//    rows by 4 consecutive columns), and then the slab's rows of C and n
//    get their rank-L update (a thread owns 2 rows by 4 columns, with n
//    folded in), which only the slab's own rows of the old C were needed
//    for.  Every read in these loops is a 16-byte vector from shared
//    memory.  At D 384 the CTA holds ~150 KB of shared memory.
//  * q, k, v, i and f are read by strides in their (B, S, H, ...) layout
//    (no transposes), q, k and v four values a load; the output is
//    written contiguous.
//  * A ragged last chunk is masked: steps past S read i = -inf (they write
//    nothing into C or n), f with no decay, and zero q, k, v; their rows
//    are never stored.  So S need not be a multiple of L.
//  * Plain C interface, loaded with ctypes; the launch goes on the
//    caller's stream and the function returns cudaGetLastError().
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

// Four consecutive elements of global memory (16- or 8-byte aligned).
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

template <int W>
__device__ __forceinline__ void store(float* p, const float (&x)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
template <int W>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&x)[W]) {
  __nv_bfloat162 t[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i)
    t[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  if constexpr (W == 4)
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(t);
  else
    *reinterpret_cast<__nv_bfloat162*>(p) = t[0];
}

template <typename T, int VT>
__global__ void __launch_bounds__(kNT) mlstm_chunk_kernel(Args a) {
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
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)a.D * VT + a.D + 2 * kDS * (kL + 4) +
                       kL * VT + kL * (kL + 4) + 7 * kL);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel<T, VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.D / VT, a.H, B);
  mlstm_chunk_kernel<T, VT><<<grid, kNT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (B,S,H,D), i, f: (B,S,H), each read by the strides given
// (15 values: b, s and h strides of q, k, v, i, f in elements; the head
// dim unit-stride); o: (B,S,H,D) contiguous.  scale = D**-0.5.  dtype
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
    return D % 64 == 0 ? launch<float, 64>(a, B, s) : launch<float, 32>(a, B, s);
  return D % 64 == 0 ? launch<__nv_bfloat16, 64>(a, B, s)
                     : launch<__nv_bfloat16, 32>(a, B, s);
}
