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
// and the matvecs B*H*S*8*D^2 ~ 39 GFLOP (~0.04 ms on the bf16 tensor
// cores, ~0.6 ms at 67 TFLOP/s fp32): bytes bound it, at ~0.075 ms.
// Neither is what bounds it in practice: each (batch row, head) is one
// chain of S dependent steps, and every step must read the head's four
// D x D matrices (288 KiB in bf16) from wherever they are kept.  That
// chain is what the roofline does not see.
//
// Design (this PR's simple one):
//  * On the TPU the grid's sequence axis runs in order with c, n, m, h and
//    all four R in VMEM.  Here one CTA owns a (batch row, head) and loops
//    over t itself, with 2*D threads, one per (output unit e, pair of
//    gates): tid = 2 e + gp computes the rows of gates 2 gp and 2 gp + 1,
//    so every load of h serves two rows.
//  * R does not fit one CTA's shared memory (576 KiB fp32, 288 KiB bf16
//    at D 192).  A first pass packs it as [h][d/2][4 e + g][2], so that
//    each step's reads of it are unit-stride across the CTA and two d
//    values of two rows a load.  Each thread keeps the first pairs of its
//    two rows in registers (48 values a row in bf16, 24 in fp32; 128
//    registers a thread at 512 threads), the next pairs that fit
//    (~227 KiB) stay in shared memory for the whole sequence, and the
//    rest, if any, is read each step through L2, where it stays resident
//    (it is shared by the B rows of a head).  At bf16 D 192 the whole of
//    R is on chip.
//  * h lives in shared memory, double-buffered: a step reads h_t (four
//    values a load) from one buffer and writes h_{t+1} to the other, so
//    one barrier a step is enough.  The four gate sums of a unit sit in
//    two neighbouring lanes and meet through warp shuffles; both lanes
//    keep c, n, m in registers.  The next step's gate
//    pre-activation is loaded ahead.
//  * The redesign for this card -- a cluster of CTAs per head, splitting
//    the output units and exchanging h each step through distributed
//    shared memory, with all of R in registers -- is later work.
//  * Plain C interface, loaded with ctypes; the launches go on the
//    caller's stream and the function returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;   // m's initial value, as in the TPU kernel

template <typename T> struct Pair;   // two consecutive T, one load
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float2 to_f2(float2 x) { return x; }
__device__ __forceinline__ float2 to_f2(__nv_bfloat162 x) {
  return __bfloat1622float2(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// log(sigmoid(x)) = min(x, 0) - log1p(exp(-|x|)), as jax.nn.log_sigmoid
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// packed[h][d / 2][4 e + g][d % 2] = R_g[h][e][d]
template <typename T>
__global__ void pack_r(const T* __restrict__ rz, const T* __restrict__ ri,
                       const T* __restrict__ rf, const T* __restrict__ ro,
                       T* __restrict__ packed, int H, int D) {
  const long long n = (long long)H * D * D;
  for (long long x = blockIdx.x * (long long)blockDim.x + threadIdx.x; x < n;
       x += (long long)gridDim.x * blockDim.x) {
    const int d = (int)(x % D);
    const long long he = x / D;
    const int e = (int)(he % D), h = (int)(he / D);
    const long long at =
        (((long long)h * (D / 2) + d / 2) * (4 * D) + 4 * e) * 2 + (d & 1);
    packed[at] = rz[x];
    packed[at + 2] = ri[x];
    packed[at + 4] = rf[x];
    packed[at + 6] = ro[x];
  }
}

// The pairs of each of its two R rows a thread keeps in registers:
// 48 registers either way.
template <typename T> struct RegPairs { static constexpr int value = 24; };
template <> struct RegPairs<float> { static constexpr int value = 12; };

// Two adjacent pairs of T (one 8- or 16-byte load) as float2s.
__device__ __forceinline__ void load2x2(const float2* p, float2& a,
                                        float2& b) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  a = make_float2(t.x, t.y);
  b = make_float2(t.z, t.w);
}
__device__ __forceinline__ void load2x2(const __nv_bfloat162* p, float2& a,
                                        float2& b) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
}

// acc += h[2p .. 2p+3] . (r0, r1), two independent sums
__device__ __forceinline__ void dot4(float4 hv, float2 r0, float2 r1,
                                     float& a0, float& a1) {
  a0 = fmaf(hv.x, r0.x, a0);
  a1 = fmaf(hv.y, r0.y, a1);
  a0 = fmaf(hv.z, r1.x, a0);
  a1 = fmaf(hv.w, r1.y, a1);
}

template <typename T>
__global__ void __launch_bounds__(512)
slstm_scan_kernel(const T* __restrict__ gates, const T* __restrict__ packed,
                  T* __restrict__ out, int S, int H, int D, int p_reg,
                  int p_smem) {
  using T2 = typename Pair<T>::type;
  constexpr int RP = RegPairs<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hbuf = reinterpret_cast<float*>(smem_raw);     // 2 x D
  T2* Rs = reinterpret_cast<T2*>(hbuf + 2 * D);         // p_smem x 4D pairs

  // thread = (output unit e, gates 2 gp and 2 gp + 1): its two R rows
  // are the adjacent pairs at col and col + 1 of every packed pair row
  const int row = 4 * D, nt = 2 * D;
  const int tid = threadIdx.x, e = tid >> 1, gp = tid & 1;
  const int col = 4 * e + 2 * gp;
  const int lane = tid & 31, mate = lane & ~1;
  const int h = blockIdx.x, b = blockIdx.y;
  const int P = D / 2;
  const int p_glob = p_reg + p_smem;    // first pair read through L2
  const T2* __restrict__ Rg =
      reinterpret_cast<const T2*>(packed) + (size_t)h * P * row;
  T2 ra[RP], rb[RP];
#pragma unroll
  for (int p = 0; p < RP; ++p)
    if (p < p_reg) {
      ra[p] = Rg[p * row + col];
      rb[p] = Rg[p * row + col + 1];
    }
  for (int x = tid; x < p_smem * row; x += nt) Rs[x] = Rg[p_reg * row + x];
  if (tid < D) hbuf[tid] = 0.f;
  __syncthreads();

  // this thread's two gate pre-activations of a step are adjacent
  const size_t g_step = (size_t)H * D * 4;
  const size_t o_step = (size_t)H * D;
  const T2* gptr = reinterpret_cast<const T2*>(
      gates + (((size_t)b * S * H + h) * D + e) * 4 + 2 * gp);
  T* op = out + ((size_t)b * S * H + h) * D + e;
  float c = 0.f, n = 0.f, m = kNegBig;
  float2 gx_next = to_f2(gptr[0]);
  for (int t = 0; t < S; ++t) {
    const float2 gx = gx_next;
    if (t + 1 < S) gx_next = to_f2(gptr[(size_t)(t + 1) * (g_step / 2)]);
    // pairs 2q, 2q+1 of h are hc[q]; p_reg, p_smem and P are even
    const float4* hc = reinterpret_cast<const float4*>(hbuf + (t & 1) * D);
    float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
    for (int p = 0; p < RP; p += 2)
      if (p < p_reg) {
        const float4 hv = hc[p / 2];
        dot4(hv, to_f2(ra[p]), to_f2(ra[p + 1]), a0, a1);
        dot4(hv, to_f2(rb[p]), to_f2(rb[p + 1]), b0, b1);
      }
#pragma unroll 2
    for (int p = 0; p < p_smem; p += 2) {
      const float4 hv = hc[(p_reg + p) / 2];
      float2 r0a, r0b, r1a, r1b;
      load2x2(Rs + p * row + col, r0a, r0b);
      load2x2(Rs + (p + 1) * row + col, r1a, r1b);
      dot4(hv, r0a, r1a, a0, a1);
      dot4(hv, r0b, r1b, b0, b1);
    }
#pragma unroll 2
    for (int p = p_glob; p < P; p += 2) {
      const float4 hv = hc[p / 2];
      float2 r0a, r0b, r1a, r1b;
      load2x2(Rg + (size_t)p * row + col, r0a, r0b);
      load2x2(Rg + (size_t)(p + 1) * row + col, r1a, r1b);
      dot4(hv, r0a, r1a, a0, a1);
      dot4(hv, r0b, r1b, b0, b1);
    }
    const float pre_a = gx.x + (a0 + a1), pre_b = gx.y + (b0 + b1);
    // unit e: (z, i) in the even lane of the pair, (f, o) in the odd one
    const float z_pre = __shfl_sync(0xffffffffu, pre_a, mate);
    const float i_pre = __shfl_sync(0xffffffffu, pre_b, mate);
    const float f_pre = __shfl_sync(0xffffffffu, pre_a, mate + 1);
    const float o_pre = __shfl_sync(0xffffffffu, pre_b, mate + 1);
    const float z = tanhf(z_pre);
    const float lf = log_sigmoid(f_pre);
    const float m_new = fmaxf(lf + m, i_pre);
    const float fgate = expf(lf + m - m_new);
    const float igate = expf(i_pre - m_new);
    c = fgate * c + igate * z;
    n = fmaxf(fgate * n + igate, 1e-6f);
    m = m_new;
    const float hn = sigmoid(o_pre) * c / n;
    if (gp == 0) {
      hbuf[((t + 1) & 1) * D + e] = hn;
      op[(size_t)t * o_step] = from_f<T>(hn);
    }
    __syncthreads();   // h_{t+1} is complete; h_t's readers are done
  }
}

template <typename T>
int run(const void* gates, const void* rz, const void* ri, const void* rf,
        const void* ro, void* packed, void* out, int B, int S, int H, int D,
        cudaStream_t stream) {
  using T2 = typename Pair<T>::type;
  const long long n = (long long)H * D * D;
  const int pack_blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  pack_r<T><<<pack_blocks, 256, 0, stream>>>(
      static_cast<const T*>(rz), static_cast<const T*>(ri),
      static_cast<const T*>(rf), static_cast<const T*>(ro),
      static_cast<T*>(packed), H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int dev = 0, max_smem = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int P = D / 2;
  const int p_reg = RegPairs<T>::value < P ? RegPairs<T>::value : P;
  const size_t fixed = 2 * (size_t)D * sizeof(float);
  const size_t pair_row = (size_t)4 * D * sizeof(T2);
  long long fit = ((long long)max_smem - (long long)fixed) / (long long)pair_row;
  fit &= ~1LL;                                   // whole pairs of pairs
  const int p_smem = (int)(fit < P - p_reg ? (fit < 0 ? 0 : fit) : P - p_reg);
  const size_t smem = fixed + (size_t)p_smem * pair_row;
  err = cudaFuncSetAttribute(slstm_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  slstm_scan_kernel<T><<<dim3(H, B), 2 * D, smem, stream>>>(
      static_cast<const T*>(gates), static_cast<const T*>(packed),
      static_cast<T*>(out), S, H, D, p_reg, p_smem);
  return (int)cudaGetLastError();
}

}  // namespace

// gates: (B,S,H,D,4) contiguous; rz, ri, rf, ro: (H,D,D) contiguous, as
// R[h, out, in]; packed: scratch of H*D*D*4 elements; out: (B,S,H,D)
// contiguous.  dtype 0 = float32, 1 = bfloat16, the same for all.
// D a multiple of 16 (whole warps) up to 256.  Returns a cudaError_t
// (0 on success).
extern "C" int slstm_step_fwd(const void* gates, const void* rz,
                              const void* ri, const void* rf, const void* ro,
                              void* packed, void* out, int B, int S, int H,
                              int D, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (D <= 0 || D % 16 != 0 || D > 256) return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(gates, rz, ri, rf, ro, packed, out, B, S, H, D, s);
  return run<__nv_bfloat16>(gates, rz, ri, rf, ro, packed, out, B, S, H, D, s);
}
