// The paper's SIV sum microbenchmarks (K1-K3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels aligned_sum, strided_sum and gather_sum of
// src/repro/kernels/membench/kernel.py (bodies _sum_kernel and
// _sum_kernel_prefetch): output block i of `block` elements is the sum over
// the g inputs of input block src(i), where src(i) = i (aligned), i * delta
// (strided: contiguous runs of `block` elements with the stride taken at block
// granularity, the Eq. 8 picture) or idx[i] (gather: a block index that is
// data on the device).
//
// What bounds it on this card: bytes.  Each output element costs g loads and
// one store against g - 1 adds, so the kernels sit far below the ridge and the
// only thing that matters is the access pattern they issue, which is also
// what they exist to measure.  The design states that pattern directly: one
// CTA per output block, neighbouring threads on neighbouring 16-byte vectors,
// all g loads of a vector issued before any add so that g requests are in
// flight per thread, and for the gather the CTA reads its own index from
// device memory (no host sync, the scalar-prefetch analogue).  The sum runs
// in fp32 in the order x0 + x1 + ... and is stored in the input dtype, which
// makes the result bit-equal to the plain PyTorch version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxInputs = 8;
constexpr int kMaxThreads = 256;

struct Inputs {
  const uint4* p[kMaxInputs];
};

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 t = __bfloat1622float2(h[k]);
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    return v;
  }
};

// mode 0: src = i; mode 1: src = i * delta; mode 2: src = idx[i].
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    sum_blocks(Inputs xs, int n_in, uint4* __restrict__ out, int vecs_per_block,
               int mode, long long delta, const int32_t* __restrict__ idx,
               long long n_in_blocks) {
  constexpr int N = Vec<T>::N;
  const long long i = blockIdx.x;
  const long long src = mode == 0 ? i : mode == 1 ? i * delta : (long long)idx[i];
  uint4* dst = out + i * vecs_per_block;
  if (src < 0 || src >= n_in_blocks) {
    // A gather index outside the inputs: NaN, never a read out of bounds.
    float nan[N];
#pragma unroll
    for (int k = 0; k < N; ++k) nan[k] = __int_as_float(0x7fc00000);
    for (int e = threadIdx.x; e < vecs_per_block; e += blockDim.x) dst[e] = Vec<T>::pack(nan);
    return;
  }
  const long long base = src * vecs_per_block;
  for (int e = threadIdx.x; e < vecs_per_block; e += blockDim.x) {
    uint4 raw[kMaxInputs];
#pragma unroll
    for (int g = 0; g < kMaxInputs; ++g)
      if (g < n_in) raw[g] = __ldcs(xs.p[g] + base + e);
    float acc[N];
    Vec<T>::unpack(raw[0], acc);
#pragma unroll
    for (int g = 1; g < kMaxInputs; ++g) {
      if (g < n_in) {
        float x[N];
        Vec<T>::unpack(raw[g], x);
#pragma unroll
        for (int k = 0; k < N; ++k) acc[k] += x[k];
      }
    }
    __stcs(dst + e, Vec<T>::pack(acc));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `inputs` is a host array of n_in device
// pointers, each 16-byte aligned; `block` elements make a whole number of
// 16-byte vectors.  Launches on `stream`; returns the launch's cudaError_t.
extern "C" int membench_sum(int mode, int dtype, const void* const* inputs, int n_in,
                            void* out, long long n_out_blocks, int block, long long delta,
                            const void* idx, long long n_in_blocks, void* stream) {
  if (n_in < 1 || n_in > kMaxInputs || n_out_blocks < 1) return cudaErrorInvalidValue;
  Inputs xs{};
  for (int g = 0; g < n_in; ++g) xs.p[g] = static_cast<const uint4*>(inputs[g]);
  const int elem = dtype == 0 ? 4 : 2;
  const int vecs = block * elem / 16;
  const int threads = vecs < kMaxThreads ? vecs : kMaxThreads;
  const dim3 grid(static_cast<unsigned>(n_out_blocks));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* o = static_cast<uint4*>(out);
  if (dtype == 0) {
    sum_blocks<float><<<grid, threads, 0, s>>>(xs, n_in, o, vecs, mode, delta, ix, n_in_blocks);
  } else if (dtype == 1) {
    sum_blocks<__nv_bfloat16><<<grid, threads, 0, s>>>(xs, n_in, o, vecs, mode, delta, ix,
                                                       n_in_blocks);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
