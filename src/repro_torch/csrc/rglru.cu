// RG-LRU sequence scan (K6) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rglru_scan (body _rglru_kernel) of
// src/repro/kernels/rglru/kernel.py: h_t = a_t * h_{t-1} + b_t along S for
// every (batch, channel) of (B, S, W) inputs, the carry held in fp32 and each
// output rounded once to the input dtype.
//
// What bounds it on this card: bytes.  Two flops per element against at
// least 3 * s bytes (a and b read, h written), far below the ridge.  The TPU
// marches time over 128-lane channel tiles, one (b, w tile) per grid row; on
// Hopper one thread per channel gives B * W / 32 warps (512 at the
// recurrentgemma-9b width, B = 4), under four per SM: too few loads in flight
// to stream from HBM.  So S is split into chunks of `chunk` steps and the
// scan runs in three launches (a chunked scan):
//
//   rglru_summary  per (b, chunk, channel): the chunk's scan from h = 0 (its
//                  last value H) and the product P of its a, both fp32;
//   rglru_carry    per (b, channel): walks the chunks in order, replacing H of
//                  chunk c by the carry into it, h_{c-1} = P_{c-1} h + H_{c-1};
//   rglru_apply    per (b, chunk, channel): rescans the chunk from its carry
//                  and writes h in the input dtype.
//
// Threads own one channel each, so a warp reads 32 neighbouring channels of
// one time step (coalesced); the time loop is unrolled so that the loads of
// several steps are in flight at once.  The price of the split is bytes: a
// and b are read twice (5 * s bytes per element instead of 3 * s), plus
// 2 * B * n_chunks * W floats of summaries.  A single pass with decoupled
// look-back between consecutive chunks would avoid the second read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// grid (ceil(W / blockDim.x), n_chunks, B).  P and H: (B, n_chunks, W) fp32.
template <typename T>
__global__ void rglru_summary(const T* __restrict__ a, const T* __restrict__ b,
                              float* __restrict__ P, float* __restrict__ H, int S, int W,
                              int chunk) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const int c = blockIdx.y;
  const int bi = blockIdx.z;
  const int t0 = c * chunk;
  const int t1 = min(t0 + chunk, S);
  const size_t base = ((size_t)bi * S) * W + w;
  float h = 0.f, p = 1.f;
  int t = t0;
  for (; t + kUnroll <= t1; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = to_float(__ldcs(a + base + (size_t)(t + u) * W));
      bv[u] = to_float(__ldcs(b + base + (size_t)(t + u) * W));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = av[u] * h + bv[u];
      p *= av[u];
    }
  }
  for (; t < t1; ++t) {
    const float av = to_float(a[base + (size_t)t * W]);
    h = av * h + to_float(b[base + (size_t)t * W]);
    p *= av;
  }
  const size_t s = ((size_t)bi * gridDim.y + c) * W + w;
  P[s] = p;
  H[s] = h;
}

// grid (ceil(W / blockDim.x), B).  Replaces H[b, c, w] by the carry into
// chunk c (0 for the first chunk).
__global__ void rglru_carry(const float* __restrict__ P, float* __restrict__ H, int W,
                            int n_chunks) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * n_chunks * W + w;
  float h = 0.f;
  int c = 0;
  for (; c + kUnroll <= n_chunks; c += kUnroll) {
    float pv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      pv[u] = P[base + (size_t)(c + u) * W];
      hv[u] = H[base + (size_t)(c + u) * W];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      H[base + (size_t)(c + u) * W] = h;
      h = pv[u] * h + hv[u];
    }
  }
  for (; c < n_chunks; ++c) {
    const float hv = H[base + (size_t)c * W];
    H[base + (size_t)c * W] = h;
    h = P[base + (size_t)c * W] * h + hv;
  }
}

// grid as rglru_summary: rescan each chunk from its carry and write h.
template <typename T>
__global__ void rglru_apply(const T* __restrict__ a, const T* __restrict__ b,
                            const float* __restrict__ carry, T* __restrict__ out, int S, int W,
                            int chunk) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const int c = blockIdx.y;
  const int bi = blockIdx.z;
  const int t0 = c * chunk;
  const int t1 = min(t0 + chunk, S);
  const size_t base = ((size_t)bi * S) * W + w;
  float h = carry[((size_t)bi * gridDim.y + c) * W + w];
  int t = t0;
  for (; t + kUnroll <= t1; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = to_float(__ldcs(a + base + (size_t)(t + u) * W));
      bv[u] = to_float(__ldcs(b + base + (size_t)(t + u) * W));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = av[u] * h + bv[u];
      __stcs(out + base + (size_t)(t + u) * W, from_float<T>(h));
    }
  }
  for (; t < t1; ++t) {
    h = to_float(a[base + (size_t)t * W]) * h + to_float(b[base + (size_t)t * W]);
    out[base + (size_t)t * W] = from_float<T>(h);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* out, float* P, float* H, int B, int S,
                   int W, int chunk, int threads, cudaStream_t s) {
  const int n_chunks = (S + chunk - 1) / chunk;
  const int wb = (W + threads - 1) / threads;
  const dim3 grid(wb, n_chunks, B);
  const auto* ta = static_cast<const T*>(a);
  const auto* tb = static_cast<const T*>(b);
  rglru_summary<T><<<grid, threads, 0, s>>>(ta, tb, P, H, S, W, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_carry<<<dim3(wb, B), threads, 0, s>>>(P, H, W, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_apply<T><<<grid, threads, 0, s>>>(ta, tb, H, static_cast<T*>(out), S, W, chunk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  a, b, out: contiguous (B, S, W); P and
// H: scratch of B * ceil(S / chunk) * W floats each; `threads` channels per
// CTA (a multiple of 32, at most 1024).  Returns the first cudaError_t met.
extern "C" int rglru_scan(int dtype, const void* a, const void* b, void* out, void* P, void* H,
                          int B, int S, int W, int chunk, int threads, void* stream) {
  if (B < 1 || S < 1 || W < 1 || chunk < 1 || threads < 32 || threads > 1024 ||
      threads % 32 || B > 65535 || (S + chunk - 1) / chunk > 65535)
    return cudaErrorInvalidValue;
  auto* p = static_cast<float*>(P);
  auto* h = static_cast<float*>(H);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, out, p, h, B, S, W, chunk, threads, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, out, p, h, B, S, W, chunk, threads, s);
  return cudaErrorInvalidValue;
}
