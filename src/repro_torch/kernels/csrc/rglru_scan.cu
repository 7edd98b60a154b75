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
// bytes bound it.  To reach that rate the card needs some megabytes of
// loads in flight, so the scan must give many threads independent work,
// though each channel is one chain of S dependent steps.
//
// Design: a chunked scan inside each CTA.
//  * A CTA owns one batch row and a block of neighbouring channels, a lane
//    a few of them, so that a warp's accesses to one step are unit-stride.
//    It walks S in segments of W * U steps, and in each segment warp w
//    owns the U consecutive steps w U .. w U + U - 1.
//  * a and b are read from device memory once.  Where rows are whole
//    16-byte units and the pointers 16-byte aligned (the model's case),
//    rglru_stream_kernel takes them: 128 channels a CTA in bf16 (64 in
//    fp32, the same 256-byte rows), W = 4 warps of U = 16 steps, and each
//    segment's 64-step tiles of a and b arrive by cp.async in a 4-stage
//    ring, three segments ahead of the one being scanned (96 KB in flight
//    a CTA; at the shape above 80 CTAs, one an SM).  Its rows of 256
//    bytes give the memory system longer runs than 64-channel blocks
//    would (rows of 128 bytes, 160 CTAs of 8 warps).  Other shapes (odd R,
//    a pointer off by one channel) take rglru_scan_kernel: 64 channels and
//    8 warps of U steps a CTA, each warp loading its next U steps into
//    registers (as pairs where R is even and pairs align, else one
//    channel a lane) while it works on the current ones.
//  * Per segment: (1) each warp folds its U steps from h = 0 into the pair
//    (P, H) = (prod a, local h at its last step), fp32, into shared
//    memory; (2) after one barrier, every warp folds the pairs of warps
//    0 .. W-1 in order from the segment's carry-in, h <- P h + H, which
//    gives its own h_in at warp w and the next segment's carry-in at the
//    end (each warp computes that carry itself, so nothing else is
//    shared); (3) each warp re-runs its U steps from its h_in and writes
//    h.
//  * h = P h_in + H never divides by P, so a product of a that
//    underflows to 0 is harmless.
//  * Any S >= 1 and any R >= 1: steps past S and channels past R are
//    masked and never stored.
//  * Plain C interface, loaded with ctypes; the launch goes on the
//    caller's stream and the function returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // W: warps of a CTA, each a run of U steps

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

// T: element type; V: channels a lane (R % V == 0, pointers aligned to
// V elements); U: steps a warp in each segment.
template <typename T, int V, int U>
__global__ void __launch_bounds__(kWarps * 32, 2)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ h, int S, int R) {
  using P = Pack<T, V>;
  constexpr int SEG = kWarps * U;           // steps of a segment
  // (prod a, local h), by segment parity: one barrier a segment
  __shared__ float2 pairs[2][kWarps][32 * V];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int groups = R / V;                 // Packs in a step
  const int col = blockIdx.x * 32 + lane;   // this lane's Pack in a step
  const bool live = col < groups;
  const size_t base = (size_t)blockIdx.y * S * groups + col;
  const P* __restrict__ pa = reinterpret_cast<const P*>(a) + base;
  const P* __restrict__ pb = reinterpret_cast<const P*>(b) + base;
  P* __restrict__ ph = reinterpret_cast<P*>(h) + base;

  // a step past S (or a lane past R) is the identity (1, 0)
  auto load = [&](int t0, P (&ca)[U], P (&cb)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (live && t < S) {
        ca[u] = pa[(size_t)t * groups];
        cb[u] = pb[(size_t)t * groups];
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          ca[u].x[v] = from_f<T>(1.f);
          cb[u].x[v] = from_f<T>(0.f);
        }
      }
    }
  };

  P ca[U], cb[U], na[U], nb[U];
  load(warp * U, ca, cb);
  float carry[V];
#pragma unroll
  for (int v = 0; v < V; ++v) carry[v] = 0.f;

#pragma unroll 1
  for (int s0 = 0, seg = 0; s0 < S; s0 += SEG, ++seg) {
    const int t0 = s0 + warp * U;
    if (s0 + SEG < S) load(t0 + SEG, na, nb);   // the next segment's inputs

    // (1) this warp's steps folded from h = 0
    float prod[V], loc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      prod[v] = 1.f;
      loc[v] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float av = to_f(ca[u].x[v]);
        loc[v] = fmaf(av, loc[v], to_f(cb[u].x[v]));
        prod[v] *= av;
      }
    float2* mine = pairs[seg & 1][warp];
#pragma unroll
    for (int v = 0; v < V; ++v)
      mine[lane * V + v] = make_float2(prod[v], loc[v]);
    __syncthreads();

    // (2) the carry through warps 0 .. W-1: h_in at this warp, and the
    // next segment's carry-in after the last
    float hin[V];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp)
#pragma unroll
        for (int v = 0; v < V; ++v) hin[v] = carry[v];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float2 pr = pairs[seg & 1][w][lane * V + v];
        carry[v] = fmaf(pr.x, carry[v], pr.y);
      }
    }

    // (3) this warp's steps from the true h_in
#pragma unroll
    for (int u = 0; u < U; ++u) {
      P o;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        hin[v] = fmaf(to_f(ca[u].x[v]), hin[v], to_f(cb[u].x[v]));
        o.x[v] = from_f<T>(hin[v]);
      }
      if (live && t0 + u < S) ph[(size_t)(t0 + u) * groups] = o;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
}


// ------------------------------- aligned rows: the segments by cp.async

constexpr int kSWarps = 4;       // warps of a CTA
constexpr int kSU = 16;          // steps a warp in each segment
constexpr int kSSeg = kSWarps * kSU;
constexpr int kSStages = 4;      // segments in shared memory: three ahead

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
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kSStages - 2) : "memory");
}

// The same scan with a and b staged in shared memory: rows of R elements
// are whole 16-byte units and the pointers 16-byte aligned, so a
// segment's kSSeg x CW tiles of a and b arrive by cp.async, three
// segments ahead of the one the warps work on; rows past S and channels
// past R are zero-filled and never stored.  A lane holds CW / 32
// neighbouring channels (8 bytes).
template <typename T, int CW>
__global__ void __launch_bounds__(kSWarps * 32, 1)
rglru_stream_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ h, int S, int R) {
  constexpr int V = CW / 32;
  using P = Pack<T, V>;
  constexpr int CPR = CW * (int)sizeof(T) / 16;   // 16-byte units a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);   // stages x (a, b) x kSSeg x CW
  __shared__ float2 pairs[kSWarps][CW];        // (prod a, local h)

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c0 = blockIdx.x * CW;
  const size_t base = (size_t)blockIdx.y * S * R + c0;
  const int nseg = (S + kSSeg - 1) / kSSeg;

  auto fetch = [&](int sg) {
    if (sg < nseg) {
      const T* sa = ring + (sg % kSStages) * 2 * kSSeg * CW;
      const uint32_t da = smem_u32(sa), db = smem_u32(sa + kSSeg * CW);
      for (int x = tid; x < kSSeg * CPR; x += kSWarps * 32) {
        const int r = x / CPR, col = (x % CPR) * (16 / (int)sizeof(T));
        const int t = sg * kSSeg + r;
        const bool ok = t < S && c0 + col < R;
        const size_t off = ok ? base + (size_t)t * R + col : 0;
        const uint32_t d = (r * CW + col) * (int)sizeof(T);
        cp_async16(da + d, a + off, ok);
        cp_async16(db + d, b + off, ok);
      }
    }
    cp_async_commit();
  };

  for (int sg = 0; sg < kSStages - 1; ++sg) fetch(sg);
  const int ch = V * lane;
  const bool live = c0 + ch < R;
  P* __restrict__ ph = reinterpret_cast<P*>(h + base + ch);
  float carry[V];
#pragma unroll
  for (int v = 0; v < V; ++v) carry[v] = 0.f;
#pragma unroll 1
  for (int sg = 0; sg < nseg; ++sg) {
    cp_async_wait_ahead();   // segment sg is here
    __syncthreads();
    fetch(sg + kSStages - 1);
    const T* sa = ring + (sg % kSStages) * 2 * kSSeg * CW + warp * kSU * CW + ch;
    const T* sb = sa + kSSeg * CW;
    float prod[V], loc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      prod[v] = 1.f;
      loc[v] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < kSU; ++u) {
      const P pa = *reinterpret_cast<const P*>(sa + u * CW);
      const P pb = *reinterpret_cast<const P*>(sb + u * CW);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float av = to_f(pa.x[v]);
        loc[v] = fmaf(av, loc[v], to_f(pb.x[v]));
        prod[v] *= av;
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      pairs[warp][ch + v] = make_float2(prod[v], loc[v]);
    __syncthreads();
    float hin[V];
#pragma unroll
    for (int w = 0; w < kSWarps; ++w) {
      if (w == warp)
#pragma unroll
        for (int v = 0; v < V; ++v) hin[v] = carry[v];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float2 pr = pairs[w][ch + v];
        carry[v] = fmaf(pr.x, carry[v], pr.y);
      }
    }
    const int t0 = sg * kSSeg + warp * kSU;
#pragma unroll
    for (int u = 0; u < kSU; ++u) {
      const P pa = *reinterpret_cast<const P*>(sa + u * CW);
      const P pb = *reinterpret_cast<const P*>(sb + u * CW);
      P o;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        hin[v] = fmaf(to_f(pa.x[v]), hin[v], to_f(pb.x[v]));
        o.x[v] = from_f<T>(hin[v]);
      }
      if (live && t0 + u < S) ph[(size_t)(t0 + u) * (R / V)] = o;
    }
  }
}

template <typename T, int CW>
cudaError_t launch_stream(const void* a, const void* b, void* h, int B, int S,
                          int R, cudaStream_t stream) {
  const int smem = kSStages * 2 * kSSeg * CW * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      rglru_stream_kernel<T, CW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  rglru_stream_kernel<T, CW><<<dim3((R + CW - 1) / CW, B), kSWarps * 32,
                               smem, stream>>>(static_cast<const T*>(a),
                                               static_cast<const T*>(b),
                                               static_cast<T*>(h), S, R);
  return cudaGetLastError();
}

template <typename T, int V, int U>
cudaError_t launch(const void* a, const void* b, void* h, int B, int S, int R,
                   cudaStream_t stream) {
  const int blocks = (R / V + 31) / 32;
  if (B > 65535) return cudaErrorInvalidValue;
  rglru_scan_kernel<T, V, U><<<dim3(blocks, B), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      S, R);
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
    if (R % 4 == 0 && aligned(a, b, h, 16))
      return (int)launch_stream<float, 64>(a, b, h, B, S, R, st);
    if (pairs && aligned(a, b, h, 2 * sizeof(float)))
      return (int)launch<float, 2, 8>(a, b, h, B, S, R, st);
    return (int)launch<float, 1, 16>(a, b, h, B, S, R, st);
  }
  if (dtype == 1) {
    if (R % 8 == 0 && aligned(a, b, h, 16))
      return (int)launch_stream<__nv_bfloat16, 128>(a, b, h, B, S, R, st);
    if (pairs && aligned(a, b, h, 2 * sizeof(__nv_bfloat16)))
      return (int)launch<__nv_bfloat16, 2, 16>(a, b, h, B, S, R, st);
    return (int)launch<__nv_bfloat16, 1, 16>(a, b, h, B, S, R, st);
  }
  return (int)cudaErrorInvalidValue;
}
