// RG-LRU sequence scan (K6) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rglru_scan (body _rglru_kernel) of
// src/repro/kernels/rglru/kernel.py: h_t = a_t * h_{t-1} + b_t along S for
// every (batch, channel) of (B, S, W) inputs, the carry held in fp32 and each
// output rounded once to the input dtype.
//
// What bounds it on this card: bytes.  Two flops per element against 3 * s
// bytes (a and b read, h written), far below the ridge.  The TPU marches time
// over 128-lane channel tiles, one (b, w tile) per grid row; so does this
// kernel, in one pass that reads a and b once and needs no scratch.  A CTA
// owns `cw` channels (at most 128) of one batch row, one thread per channel,
// and keeps the carry in a register for the whole of S.  At the
// recurrentgemma-9b width (B = 4, W = 4096) that is 128 CTAs, one wave of
// 132 SMs: channels are plenty, and what one thread per channel lacks is
// bytes in flight.  So a producer warp streams (steps x cw) tiles of a and b
// by TMA into a ring of kStages stages (32 KB a stage at 32 steps of 128 fp32
// channels), and the consumers walk each stage step by step (fmaf) and write
// h with coalesced stores: each SM needs ~25 GB/s, which four stages of
// ~1.5 us latency cover (Little's law).
//
// Rows whose byte length is not a multiple of 16 (bf16 W = 100) are no TMA
// box; there every thread reads its channel with plain loads, several steps
// ahead (rglru_plain), still one pass.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kStages = 4;
constexpr int kMaxTile = 128;   // channels a CTA
constexpr int kMaxSteps = 32;   // steps a stage
constexpr int kUnroll = 8;      // steps of plain loads in flight

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

// grid (ceil(W / cw), B); cw + 32 threads (cw a multiple of 32, at most
// kMaxTile): consumers 0 .. cw - 1, then the producer warp.
template <typename T>
__global__ void __launch_bounds__(kMaxTile + 32)
    rglru_ring(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
               T* __restrict__ out, int S, int W, int steps) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int cw = blockDim.x - 32;
  const int tile = steps * cw;  // elements of one array in a stage
  T* as = reinterpret_cast<T*>(smem);            // [kStages][steps][cw]
  T* bs = as + kStages * tile;
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + kStages * tile);
  uint64_t* empty = full + kStages;
  const int w0 = blockIdx.x * cw, bi = blockIdx.y;
  const int n_st = (S + steps - 1) / steps;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], cw / 32);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= cw) {
    if (threadIdx.x == cw) {
      for (int i = 0; i < n_st; ++i) {
        const int s = i % kStages;
        sm90::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * tile * sizeof(T));
        sm90::tma_load_4d(as + s * tile, &tma, &full[s], w0, i * steps, bi, 0);
        sm90::tma_load_4d(bs + s * tile, &tmb, &full[s], w0, i * steps, bi, 0);
      }
    }
    return;
  }
  const int t = threadIdx.x;
  const int w = w0 + t;
  T* o = out + (size_t)bi * S * W + w;
  float h = 0.f;
  for (int i = 0; i < n_st; ++i) {
    const int s = i % kStages;
    sm90::mbar_wait(&full[s], (i / kStages) & 1);
    const T* a = as + s * tile + t;
    const T* b = bs + s * tile + t;
    const int n = min(steps, S - i * steps);
    T* oi = o + (size_t)i * steps * W;
    if (w < W) {
#pragma unroll kUnroll
      for (int u = 0; u < n; ++u) {
        h = fmaf(to_float(a[u * cw]), h, to_float(b[u * cw]));
        __stcs(oi + (size_t)u * W, from_float<T>(h));
      }
    }
    __syncwarp();
    if (t % 32 == 0) sm90::mbar_arrive(&empty[s]);
  }
}

// grid (ceil(W / cw), B), cw threads: plain loads, kUnroll steps ahead.
template <typename T>
__global__ void __launch_bounds__(kMaxTile)
    rglru_plain(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out, int S,
                int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * S * W + w;
  float h = 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = to_float(__ldcs(a + base + (size_t)(t + u) * W));
      bv[u] = to_float(__ldcs(b + base + (size_t)(t + u) * W));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = fmaf(av[u], h, bv[u]);
      __stcs(out + base + (size_t)(t + u) * W, from_float<T>(h));
    }
  }
  for (; t < S; ++t) {
    h = fmaf(to_float(a[base + (size_t)t * W]), h, to_float(b[base + (size_t)t * W]));
    out[base + (size_t)t * W] = from_float<T>(h);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* out, int B, int S, int W, int cw,
                   int steps, cudaStream_t s) {
  const dim3 grid((W + cw - 1) / cw, B);
  const bool boxes = ((size_t)W * sizeof(T)) % 16 == 0 && (uintptr_t)a % 16 == 0 &&
                     (uintptr_t)b % 16 == 0;
  if (!boxes) {
    rglru_plain<T><<<grid, cw, 0, s>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                       static_cast<T*>(out), S, W);
    return cudaGetLastError();
  }
  const CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long dims[4] = {W, S, B, 1};
  const long long strides[3] = {W, (long long)S * W, (long long)B * S * W};
  CUtensorMap tma, tmb;
  if (!sm90::tile_map(&tma, type, sizeof(T), a, dims, strides, {cw, steps, 1, 1},
                      CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !sm90::tile_map(&tmb, type, sizeof(T), b, dims, strides, {cw, steps, 1, 1},
                      CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)kStages * steps * cw * sizeof(T) + 2 * kStages * sizeof(uint64_t);
  const cudaError_t err =
      cudaFuncSetAttribute(rglru_ring<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  rglru_ring<T><<<grid, cw + 32, smem, s>>>(tma, tmb, static_cast<T*>(out), S, W, steps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  a, b, out: contiguous (B, S, W).  cw
// channels a CTA (a multiple of 32, at most 128), `steps` time steps a
// stage (1 .. 32).  One launch; returns its cudaError_t.
extern "C" int rglru_scan(int dtype, const void* a, const void* b, void* out, int B, int S,
                          int W, int cw, int steps, void* stream) {
  if (B < 1 || S < 1 || W < 1 || cw < 32 || cw > kMaxTile || cw % 32 || steps < 1 ||
      steps > kMaxSteps || B > 65535)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, out, B, S, W, cw, steps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, out, B, S, W, cw, steps, s);
  return cudaErrorInvalidValue;
}
