// RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t (h_0 = 0), written by
// hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py (wrapper
// rglru_scan, body _rglru_kernel): the same function.  a, b and h are
// (B, S, R), row-major; the carry is fp32, each h_t is written in the
// inputs' dtype (fp32 or bf16), as in the TPU kernel.
//
// What bounds it.  The work is elementwise: two operations a step and
// channel, nothing for the tensor cores.  At recurrentgemma-2b's prefill
// shape (B 4, S 4096, R 2560, bf16) a and b are read once and h written
// once, 3 * 4 * 4096 * 2560 * 2 B = 251.7 MB, ~0.075 ms at 3.35 TB/s:
// bytes bound it.  What stands between the kernel and that bound is
// latency: each channel is one chain of S dependent steps, and B * R =
// 10,240 channels are few threads for the card.
//
// Design (this PR's simple one):
//  * On the TPU the grid's sequence axis runs in order, with h carried in
//    VMEM scratch from one sequence block to the next.  Here nothing
//    carries over between blocks, so each thread walks the whole sequence
//    of its channels itself, the carry in registers: one thread a pair of
//    neighbouring channels of one batch row (one channel where R is odd
//    or a pointer is not aligned to a pair), so that a warp's loads and
//    stores are unit-stride across channels.
//  * Blocks are one warp, so that the B * R / 2 threads spread over all
//    132 SMs (160 blocks at the shape above).
//  * The loads of a and b do not depend on h.  Each thread loads the next
//    U steps of both into registers before it runs the current U steps'
//    dependent chain, so 2 * U loads a thread are in flight while it
//    computes (U = 32 for bf16, 16 for fp32 pairs: 1.3 MB in flight over
//    the card at the shape above).
//  * Any S >= 1 and any R >= 1: the steps past S are masked, and the
//    threads past the last channel return.
//  * The design that fills the card -- a chunked scan over S (per chunk
//    the product of a and the local h_end, a carry across chunks, a
//    fix-up of each chunk) -- is later work.
//  * Plain C interface, loaded with ctypes; the launch goes on the
//    caller's stream and the function returns cudaGetLastError().
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;   // one warp a block

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {   // V neighbouring channels, one load
  T x[V];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// T: element type; V: channels a thread (R % V == 0, pointers aligned to
// V elements); U: steps loaded ahead.
template <typename T, int V, int U>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ h, int B, int S, int R) {
  using P = Pack<T, V>;
  const int groups = R / V;
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (gid >= (long long)B * groups) return;
  const long long row = gid / groups;
  const int col = (int)(gid - row * groups) * V;
  const size_t base = (size_t)row * S * R + col;
  const size_t step = (size_t)groups;           // Packs from t to t + 1
  const P* __restrict__ pa = reinterpret_cast<const P*>(a + base);
  const P* __restrict__ pb = reinterpret_cast<const P*>(b + base);
  P* __restrict__ ph = reinterpret_cast<P*>(h + base);

  P ca[U], cb[U], na[U], nb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < S) {
      ca[u] = pa[u * step];
      cb[u] = pb[u * step];
    }
  }
  float carry[V];
#pragma unroll
  for (int v = 0; v < V; ++v) carry[v] = 0.f;

#pragma unroll 1
  for (int t0 = 0; t0 < S; t0 += U) {
    const int tn = t0 + U;
    // the next U steps' inputs, issued before this chunk's chain
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (tn + u < S) {
        na[u] = pa[(size_t)(tn + u) * step];
        nb[u] = pb[(size_t)(tn + u) * step];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        P o;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          carry[v] = fmaf(to_f(ca[u].x[v]), carry[v], to_f(cb[u].x[v]));
          o.x[v] = from_f<T>(carry[v]);
        }
        ph[(size_t)(t0 + u) * step] = o;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
}

template <typename T, int V, int U>
cudaError_t launch(const void* a, const void* b, void* h, int B, int S, int R,
                   cudaStream_t stream) {
  const long long threads = (long long)B * (R / V);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  rglru_scan_kernel<T, V, U><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      B, S, R);
  return cudaGetLastError();
}

bool aligned(const void* a, const void* b, const void* h, size_t n) {
  return (uintptr_t)a % n == 0 && (uintptr_t)b % n == 0 &&
         (uintptr_t)h % n == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, b and h alike).  Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, int B,
                              int S, int R, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pairs = R % 2 == 0;
  if (dtype == 0) {
    if (pairs && aligned(a, b, h, 2 * sizeof(float)))
      return (int)launch<float, 2, 16>(a, b, h, B, S, R, st);
    return (int)launch<float, 1, 32>(a, b, h, B, S, R, st);
  }
  if (dtype == 1) {
    if (pairs && aligned(a, b, h, 2 * sizeof(__nv_bfloat16)))
      return (int)launch<__nv_bfloat16, 2, 32>(a, b, h, B, S, R, st);
    return (int)launch<__nv_bfloat16, 1, 32>(a, b, h, B, S, R, st);
  }
  return (int)cudaErrorInvalidValue;
}
