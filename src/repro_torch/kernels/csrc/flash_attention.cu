// Causal GQA flash-attention forward with an optional sliding window,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (wrapper flash_attention, body _flash_kernel): the same function,
// out = softmax(mask(q k^T)) v with q pre-scaled, query head h reading
// kv head h / (H / KV), m, l and the accumulator in fp32, and tiles that
// lie wholly outside the causal band or the window skipped.
//
// What bounds it.  At the gemma3-4b prefill shape (B 4, S 4096, H 8,
// KV 4, D 256, bf16) a live (query, key) pair costs 4*D FLOPs: a global
// layer is ~275 GFLOP (~0.28 ms at 989 TFLOP/s bf16), a window-1024
// layer ~120 GFLOP (~0.12 ms), while the ~200 MB of q/k/v/o traffic
// takes ~0.06 ms at 3.35 TB/s.  So the kernel is compute-bound, and the
// products belong on the tensor cores.
//
// Design (rethought for the card, not carried over block by block):
//  * One CTA per (query tile of 64 rows, query head, batch row).  A loop
//    over KV tiles inside the CTA takes the place of the TPU grid's
//    sequential kv dimension; the loop only visits tiles that meet the
//    causal band and the window, so at S 4096 / window 1024 most tiles
//    are never loaded.
//  * bf16: four warps, each owning 16 query rows, run both products on
//    the tensor cores with mma.sync m16n8k16 (bf16 in, fp32 out).  The
//    score fragment is rescaled in registers and reused directly as the
//    A operand of P.V (FlashAttention-2 register layout), so P never
//    touches shared memory.  V is stored transposed in shared memory so
//    that its B fragments are 32-bit loads.  Row statistics m and l stay
//    in registers; l is reduced across the four lanes of a row at the
//    end.  Shared memory at D 256 is ~104 KB (dynamic, above 48 KB).
//  * fp32: a SIMT kernel with fp32 FMAs (tensor-core TF32 would miss the
//    2e-5 tolerance).  Q, K and V tiles live in shared memory as fp32;
//    each of 256 threads owns a 4 x (BK/16) score patch and a
//    4 x (D/16) slice of the accumulator.
//  * The ragged last tile is masked in the kernel (rows beyond S load
//    zeros and are never stored), so S need not be a multiple of 64.
//  * Plain C interface, loaded with ctypes; launches go on the caller's
//    stream and the function returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;   // m's initial value, as in the TPU kernel
constexpr int kBQ = 64;             // query rows per CTA
constexpr int kBK = 64;             // keys per KV tile

// First and one-past-last KV tile that can hold a live key for query
// rows [q0, q_last].
__device__ __forceinline__ void kv_tiles(int q0, int q_last, int window,
                                         int& kt0, int& kt1) {
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  kt0 = k_lo / kBK;
  kt1 = q_last / kBK + 1;
}

__device__ __forceinline__ bool live(int qp, int kp, int window) {
  return kp <= qp && (window == 0 || qp - kp < window);
}

// ------------------------------------------------------------------ fp32

template <int D>
__global__ void __launch_bounds__(256)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              int S, int H, int KV, int window) {
  constexpr int NT = 256;
  constexpr int LD = D + 1;        // padded rows: column reads hit distinct banks
  constexpr int LDP = kBK + 1;
  constexpr int RPT = kBQ / 16;    // query rows per thread
  constexpr int CPT = kBK / 16;    // score columns per thread
  constexpr int DPT = D / 16;      // output columns per thread
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

  for (int i = tid; i < kBQ * D; i += NT) {
    const int r = i / D, c = i % D, qp = q0 + r;
    Qs[r * LD + c] = qp < S ? qb[(size_t)qp * q_row + c] : 0.f;
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

  int kt0, kt1;
  kv_tiles(q0, min(q0 + kBQ, S) - 1, window, kt0, kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += NT) {
      const int r = i / D, c = i % D, kp = k0 + r;
      const bool ok = kp < S;
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
    for (int j = 0; j < DPT; ++j)
      ob[(size_t)qp * q_row + cg + 16 * j] = acc[i][j] / l;
  }
}

// ------------------------------------------------------------------ bf16

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int S, int H, int KV,
               int window) {
  constexpr int NT = 128;
  constexpr int LDQ = D + 8;       // +16 bytes: fragment loads hit distinct banks
  constexpr int LDV = kBK + 8;
  constexpr int NK = kBK / 8;      // score n-tiles per warp
  constexpr int ND = D / 8;        // output n-tiles per warp
  constexpr int C8 = D / 8;        // 16-byte chunks per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * LDQ;
  __nv_bfloat16* Vt = Ks + kBK * LDQ;    // transposed: Vt[d][key]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_row = (size_t)H * D, kv_row = (size_t)KV * D;
  const __nv_bfloat16* qb = q + (size_t)b * S * q_row + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;
  __nv_bfloat16* ob = o + (size_t)b * S * q_row + (size_t)h * D;

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < kBQ * C8; i += NT) {
    const int r = i / C8, c = (i % C8) * 8, qp = q0 + r;
    *reinterpret_cast<uint4*>(&Qs[r * LDQ + c]) =
        qp < S ? *reinterpret_cast<const uint4*>(&qb[(size_t)qp * q_row + c])
               : zero;
  }

  const int wq0 = q0 + warp * 16;          // this warp's first query row
  const int row0 = wq0 + g, row1 = row0 + 8;
  float m_r[2] = {kNegBig, kNegBig};
  float l_r[2] = {0.f, 0.f};               // partial: this lane's columns only
  float oacc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;

  int kt0, kt1;
  kv_tiles(q0, min(q0 + kBQ, S) - 1, window, kt0, kt1);
  const int wq_last = min(wq0 + 15, S - 1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kBK * C8; i += NT) {
      const int r = i / C8, c = (i % C8) * 8, kp = k0 + r;
      *reinterpret_cast<uint4*>(&Ks[r * LDQ + c]) =
          kp < S ? *reinterpret_cast<const uint4*>(&kb[(size_t)kp * kv_row + c])
                 : zero;
    }
    // V transposed; consecutive threads take consecutive keys so the
    // scalar stores fall in distinct banks
    for (int i = tid; i < kBK * C8; i += NT) {
      const int r = i % kBK, c = (i / kBK) * 8, kp = k0 + r;
      uint4 raw = kp < S
          ? *reinterpret_cast<const uint4*>(&vb[(size_t)kp * kv_row + c])
          : zero;
      const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c + e) * LDV + r] = e8[e];
    }
    __syncthreads();

    // skip a tile that is wholly masked for this warp's 16 rows
    if (wq0 >= S || k0 > wq_last ||
        (window && k0 + kBK - 1 < wq0 - window + 1))
      continue;

    float sacc[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
    const __nv_bfloat16* qa = &Qs[(warp * 16 + g) * LDQ + 2 * t];
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a0 = ld32(qa + kk * 16);
      const uint32_t a1 = ld32(qa + 8 * LDQ + kk * 16);
      const uint32_t a2 = ld32(qa + kk * 16 + 8);
      const uint32_t a3 = ld32(qa + 8 * LDQ + kk * 16 + 8);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const __nv_bfloat16* kbp = &Ks[(j * 8 + g) * LDQ + kk * 16 + 2 * t];
        mma_bf16(sacc[j], a0, a1, a2, a3, ld32(kbp), ld32(kbp + 8));
      }
    }

    // mask, then online softmax on rows row0 (e 0,1) and row1 (e 2,3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + j * 8 + 2 * t + (e & 1);
        const int qp = e < 2 ? row0 : row1;
        if (!(kp < S && live(qp, kp, window))) sacc[j][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sacc[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      corr[r] = __expf(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = sacc[j][e];
        const float p = s == -INFINITY ? 0.f : __expf(s - m_r[e >> 1]);
        sacc[j][e] = p;
        l_r[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      oacc[j][0] *= corr[0];
      oacc[j][1] *= corr[0];
      oacc[j][2] *= corr[1];
      oacc[j][3] *= corr[1];
    }

    // O += P V: the score fragments of key n-tiles 2kk, 2kk+1 are the
    // A fragment of the k16 slice kk
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
      const uint32_t a1 = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
      const uint32_t a2 = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const __nv_bfloat16* vbp = &Vt[(j * 8 + g) * LDV + kk * 16 + 2 * t];
        mma_bf16(oacc[j], a0, a1, a2, a3, ld32(vbp), ld32(vbp + 8));
      }
    }
  }

  float l_tot[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_tot[r] = 1.f / fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r ? row1 : row0;
    if (qp >= S) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const uint32_t w = pack_bf16(oacc[j][2 * r] * l_tot[r],
                                   oacc[j][2 * r + 1] * l_tot[r]);
      *reinterpret_cast<uint32_t*>(&ob[(size_t)qp * q_row + j * 8 + 2 * t]) = w;
    }
  }
}

template <typename Kern, typename T>
int launch(Kern kern, int threads, size_t smem, const void* q, const void* k,
           const void* v, void* o, int B, int S, int H, int KV, int window,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, window);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(int dtype, const void* q, const void* k, const void* v, void* o,
             int B, int S, int H, int KV, int window, cudaStream_t stream) {
  if (dtype == 0) {
    const size_t smem =
        sizeof(float) * ((kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 1) + 3 * kBQ);
    return launch<decltype(&flash_fwd_f32<D>), float>(
        flash_fwd_f32<D>, 256, smem, q, k, v, o, B, S, H, KV, window, stream);
  }
  const size_t smem = sizeof(__nv_bfloat16) *
                      ((kBQ + kBK) * (D + 8) + D * (kBK + 8));
  return launch<decltype(&flash_fwd_bf16<D>), __nv_bfloat16>(
      flash_fwd_bf16<D>, 128, smem, q, k, v, o, B, S, H, KV, window, stream);
}

}  // namespace

// q: (B,S,H,D), k and v: (B,S,KV,D), o: (B,S,H,D), all contiguous and
// 16-byte aligned.  dtype 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int H, int KV, int D,
                                   int window, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (KV <= 0 || H % KV != 0 || window < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return dispatch<32>(dtype, q, k, v, o, B, S, H, KV, window, st);
    case 64: return dispatch<64>(dtype, q, k, v, o, B, S, H, KV, window, st);
    case 128: return dispatch<128>(dtype, q, k, v, o, B, S, H, KV, window, st);
    case 256: return dispatch<256>(dtype, q, k, v, o, B, S, H, KV, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
