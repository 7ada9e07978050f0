// The MoE layer's einsum combine for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference combines with an XLA einsum
// (src/repro/models/moe.py, forward_einsum), and the port's plain version
// (kernels/moe_combine/ops.py, combine_ref) gathers every (token, slot) pair's
// expert row, widens it to f32, weights it and sums over the k slots: some
// seven passes over (T, k, d) tensors.  Where a layer holds a share of the
// experts, almost all of those rows are the appended zero row.
//
//   out[t] = round(sum over j < k with slot[t, j] < rows of
//                  f32(y[slot[t, j]]) * f32(w[t, j]))
//
// in slot order, each product and sum rounded to f32 (no contraction into an
// FMA), the result rounded once to y's dtype: the plain version's rounding.
// A slot at `rows` or past it is the zero row; its term is exactly zero, so it
// is skipped and none of its bytes are read.
//
// What bounds it on this card: bytes.  Two flops an element of a live row
// against its bytes, far below the ridge.  The least traffic is the live rows
// read once, the output written once and each token's slots and weights read
// once; so one pass does just that.  One CTA a token: its first warp loads the
// token's k slots and weights together and compacts the live ones, in slot
// order, into shared memory (a ballot); every thread then owns kVecs 16-byte
// vectors of the row, adds the live rows' products into f32 registers and
// stores the rounded sum once.  No f32 intermediate reaches device memory and
// no atomics: the result does not depend on any order of the device's work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVecs = 4;       // 16-byte vectors a thread, per pass over a row
constexpr int kMaxSlots = 64;  // slots a token, at most

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// The elements of a 16-byte vector, widened to f32 (exactly), and back,
// rounded to nearest even.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void widen(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 narrow(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void widen(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint32_t pair(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static uint4 narrow(const float* f) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]), pair(f[6], f[7]));
  }
};

// grid (T), kThreads threads: y (rows + 1, d), slot and w (T, k), out (T, d).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_combine_rows(const T* __restrict__ y, const int64_t* __restrict__ slot,
                     const T* __restrict__ w, T* __restrict__ out, int64_t rows, int k, int d) {
  using P = Pack<T>;
  __shared__ int64_t live_row[kMaxSlots];
  __shared__ float live_w[kMaxSlots];
  __shared__ int n_live;
  const int64_t t = blockIdx.x;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int j = j0 + lane;
      int64_t s = 0;
      float wj = 0.f;
      bool live = false;
      if (j < k) {
        s = slot[t * k + j];
        wj = to_float(w[t * k + j]);
        live = static_cast<uint64_t>(s) < static_cast<uint64_t>(rows);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int at = n + __popc(ballot & ((1u << lane) - 1u));
        live_row[at] = s;
        live_w[at] = wj;
      }
      n += __popc(ballot);
    }
    if (lane == 0) n_live = n;
  }
  __syncthreads();
  const int n = n_live;
  const int nvec = d / P::N;
  uint4* o = reinterpret_cast<uint4*>(out + t * d);
  for (int base = threadIdx.x; base < nvec; base += kThreads * kVecs) {
    float acc[kVecs][P::N];
#pragma unroll
    for (int u = 0; u < kVecs; ++u)
#pragma unroll
      for (int e = 0; e < P::N; ++e) acc[u][e] = 0.f;
    for (int i = 0; i < n; ++i) {
      const uint4* row = reinterpret_cast<const uint4*>(y + live_row[i] * d);
      const float wi = live_w[i];
      uint4 v[kVecs];
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int c = base + u * kThreads;
        if (c < nvec) v[u] = __ldg(row + c);
      }
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        if (base + u * kThreads < nvec) {
          float f[P::N];
          P::widen(v[u], f);
#pragma unroll
          for (int e = 0; e < P::N; ++e) acc[u][e] = __fadd_rn(acc[u][e], __fmul_rn(f[e], wi));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int c = base + u * kThreads;
      if (c < nvec) o[c] = P::narrow(acc[u]);
    }
  }
}

template <typename T>
int launch(const void* y, const void* slot, const void* w, void* out, long long rows, long long T_,
           int k, int d, cudaStream_t s) {
  if (d % Pack<T>::N) return cudaErrorInvalidValue;
  moe_combine_rows<T><<<static_cast<unsigned>(T_), kThreads, 0, s>>>(
      static_cast<const T*>(y), static_cast<const int64_t*>(slot), static_cast<const T*>(w),
      static_cast<T*>(out), rows, k, d);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  y (rows + 1, d), its last row zero; slot
// (T, k) int64; w (T, k) and out (T, d) in y's dtype; all contiguous, y and
// out 16-byte aligned.
extern "C" int moe_combine(int dtype, const void* y, const void* slot, const void* w, void* out,
                           long long rows, long long T, int k, int d, void* stream) {
  if (rows < 0 || T < 1 || T > 0x7fffffffLL || k < 0 || k > kMaxSlots || d < 1)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(y, slot, w, out, rows, T, k, d, s);
  if (dtype == 1) return launch<__nv_bfloat16>(y, slot, w, out, rows, T, k, d, s);
  return cudaErrorInvalidValue;
}
