// One-token GQA decode attention (K4) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decode_attention (body _decode_kernel) of
// src/repro/kernels/decode_attention/kernel.py: G grouped query heads per KV
// head attend over a (B, S, Hkv, D) cache; positions >= kv_len (a device
// scalar) are masked, an optional tanh softcap bounds the scores, the softmax
// runs online in fp32 (m, l, acc) and the denominator is clamped at 1e-30.
//
// What bounds it on this card: bytes.  Each step streams the whole K/V cache
// once with no reuse, about 2G flops per cache element, far below the ridge.
// The TPU grid walks S in order for every (b, kv head); on Hopper that would
// give B * Hkv CTAs, 32 for the qwen2-7b decode shape, and leave 100 of 132
// SMs idle.  So S is split across CTAs instead (flash-decoding): grid
// (B * Hkv * head chunks, n_split), with n_split chosen by the wrapper for
// several CTAs per SM, and decode_merge combines the splits' partial
// (m, l, acc), divides by max(l, 1e-30) and casts to the output dtype.
// Nothing is staged in shared memory: cache rows go straight from 16-byte
// loads into registers, and rows past kv_len (read on the device, no host
// sync) are never read.  Two split kernels, chosen by dtype and head size:
//
// * decode_split_mma (bfloat16, D a multiple of 64, the model path): Q·Kᵀ and
//   P·V run on the tensor cores (mma.sync m16n8k16, fp32 accumulate), 16
//   cache rows per warp step.  The dot product and the output channels may
//   be taken in any order, so each lane's operand fragments are chosen to be
//   the 16-byte runs it loads: K fragments need no shuffling at all, V
//   fragments one byte-permute per pair of values.  Per 8 KB of cache a warp
//   issues ~200 instructions, so the loads, not the arithmetic, set the pace.
// * decode_split (float32, or D < 64): CUDA cores.  A lane owns one 16-byte
//   slice of a cache row and keeps q and the accumulator for up to 8 heads in
//   registers; the lanes of a row reduce their dot products with shuffles.
//
// Scores are kept in log2 units (scaled by log2 e) so each exponential is one
// exp2f.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;                // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;                 // heads per CTA, CUDA-core kernel
constexpr int kMmaG = 16;                // heads per CTA, tensor-core kernel (M = 16)
constexpr int kUnroll = 4;               // row groups a warp loads per step
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void unpack(const uint4& v, float* f, float) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(const uint4& v, float* f, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// m16n8k16 bf16 tensor-core product, fp32 accumulate in place: d += a b.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Word i of a 16-byte vector (i a compile-time constant once unrolled).
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Merge the kWarps per-warp states (m, l, acc) a CTA left in shared memory
// and write its partial for heads [0, Gc) at partial index `part`.
template <int HG, int D>
__device__ __forceinline__ void write_partial(const float (&sm_acc)[kWarps][HG][D],
                                              const float (&sm_m)[kWarps][HG],
                                              const float (&sm_l)[kWarps][HG], int Gc,
                                              size_t part, float* __restrict__ m_part,
                                              float* __restrict__ l_part,
                                              float* __restrict__ acc_part) {
  for (int e = threadIdx.x; e < Gc * D; e += kThreads) {
    const int g = e / D;
    const int d = e % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(sm_m[w][g] - mx);
      lsum += wt * sm_l[w][g];
      a += wt * sm_acc[w][g][d];
    }
    acc_part[(part + g) * D + d] = a;
    if (d == 0) {
      m_part[part + g] = mx;
      l_part[part + g] = lsum;
    }
  }
}

// q: (B, Hkv, G, D); k, v: (B, S, Hkv, D).  blockIdx.x = (b * Hkv + h) * n_gc
// + head chunk, blockIdx.y = split; the CTA covers cache rows [split * chunk,
// min((split + 1) * chunk, kv_len)) for heads [gc * kMaxG, gc * kMaxG + Gc).
// Partials are indexed by ((b * Hkv + h) * n_split + split) * G + head.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    decode_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int32_t* __restrict__ kv_len, float* __restrict__ m_part,
                 float* __restrict__ l_part, float* __restrict__ acc_part, int S, int Hkv,
                 int G, int n_gc, int chunk, float scale, float softcap) {
  constexpr int VEC = 16 / sizeof(T);    // channels per 16-byte load
  constexpr int LPR = D / VEC;           // lanes per cache row
  constexpr int RPW = 32 / LPR;          // rows one warp load covers
  constexpr int STEP = RPW * kUnroll;    // rows per warp per step
  __shared__ float sm_acc[kWarps][kMaxG][D];
  __shared__ float sm_m[kWarps][kMaxG];
  __shared__ float sm_l[kWarps][kMaxG];

  const int bh = blockIdx.x / n_gc;
  const int g0 = (blockIdx.x % n_gc) * kMaxG;
  const int Gc = min(kMaxG, G - g0);
  const int split = blockIdx.y;
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int len = max(0, min(kv_len[0], S));
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPR;            // which row of a warp load
  const int c = (lane % LPR) * VEC;      // first channel of this lane

  float qr[kMaxG][VEC], acc[kMaxG][VEC], m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    float t[VEC];
    if (g < Gc) {
      unpack(*reinterpret_cast<const uint4*>(q + ((size_t)bh * G + g0 + g) * D + c), t, T());
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) t[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      qr[g][j] = t[j] * scale;
      acc[g][j] = 0.f;
    }
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const size_t row_stride = (size_t)Hkv * D;
  const T* kb = k + ((size_t)b * S * Hkv + h) * D + c;
  const T* vb = v + ((size_t)b * S * Hkv + h) * D + c;

  for (int base = start + warp * STEP; base < end; base += kWarps * STEP) {
    uint4 kr[kUnroll], vr[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = base + u * RPW + sub;
      live[u] = row < end;
      if (live[u]) {
        kr[u] = __ldcs(reinterpret_cast<const uint4*>(kb + row * row_stride));
        vr[u] = __ldcs(reinterpret_cast<const uint4*>(vb + row * row_stride));
      } else {
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    // Scores: partial dot products over this lane's channels, then summed
    // across the LPR lanes of the row.
    float s[kUnroll][kMaxG];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[VEC];
      unpack(kr[u], kf, T());
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) d += qr[g][j] * kf[j];
        s[u][g] = d;
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off /= 2) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) s[u][g] += __shfl_xor_sync(kFull, s[u][g], off);
      }
    }
    // Online softmax over this step's rows: rescale once, then accumulate.
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      float mt = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float x = s[u][g];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        x *= kLog2e;
        s[u][g] = x;
        if (live[u]) mt = fmaxf(mt, x);
      }
      const float alpha = exp2f(m[g] - mt);
      m[g] = mt;
      l[g] *= alpha;
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[g][j] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float vf[VEC];
      unpack(vr[u], vf, T());
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        const float p = live[u] ? exp2f(s[u][g] - m[g]) : 0.f;
        l[g] += p;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[g][j] += p * vf[j];
      }
    }
  }

  // Merge the RPW row groups of the warp (each ran its own online softmax).
#pragma unroll
  for (int off = LPR; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = exp2f(m[g] - mn);
      const float ao = exp2f(mo - mn);
      l[g] = l[g] * a + lo * ao;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float x = __shfl_xor_sync(kFull, acc[g][j], off);
        acc[g][j] = acc[g][j] * a + x * ao;
      }
      m[g] = mn;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) sm_acc[warp][g][c + j] = acc[g][j];
      if (c == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  write_partial<kMaxG, D>(sm_acc, sm_m, sm_l, Gc,
                          ((size_t)bh * gridDim.y + split) * G + g0, m_part, l_part,
                          acc_part);
}

// Tensor-core split kernel: bfloat16, D % 64 == 0, up to 16 heads per CTA.
// mma.sync m16n8k16 fragments (PTX ISA): lane = 4 * gid + tig; A (16 x 16):
// a0 (row gid, k 2tig..+1), a1 (row gid+8), a2 (row gid, k 2tig+8..+9), a3;
// B (16 x 8): b0 (k 2tig..+1, col gid), b1 (k 2tig+8..+9, col gid);
// C (16 x 8): c0, c1 (row gid, col 2tig, 2tig+1), c2, c3 (row gid+8).
// S = Q Kᵀ takes heads as rows, a warp step's 16 cache rows as two 8-column
// tiles and channels as k, mapped so that lane (gid, tig) loads K row
// gid of each tile at channels [32i + 8tig, +8): the loaded words are b0 and
// b1 as they stand.  O += P V takes those 16 rows as k, so lane (gid, tig)
// loads V rows 2tig, 2tig+1, 8+2tig, 9+2tig at channels [64j + 8gid, +8),
// and output channel 64j + 8n + c of n-tile 8j + c is column n.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    decode_split_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ kv_len,
                     float* __restrict__ m_part, float* __restrict__ l_part,
                     float* __restrict__ acc_part, int S, int Hkv, int G, int n_gc, int chunk,
                     float scale, float softcap) {
  constexpr int KL = D / 32;             // 16-byte K loads per lane per tile
  constexpr int VL = D / 64;             // 16-byte V loads per lane per row
  constexpr int KS = D / 16;             // k steps of Q Kᵀ
  constexpr int NT = D / 8;              // n tiles of P V
  __shared__ float sm_acc[kWarps][kMmaG][D];
  __shared__ float sm_m[kWarps][kMmaG];
  __shared__ float sm_l[kWarps][kMmaG];

  const int bh = blockIdx.x / n_gc;
  const int g0 = (blockIdx.x % n_gc) * kMmaG;
  const int Gc = min(kMmaG, G - g0);
  const int split = blockIdx.y;
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int len = max(0, min(kv_len[0], S));
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;

  // Q as A fragments (heads gid and gid + 8; absent heads are zero rows).
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q + ((size_t)bh * G + g0) * D);
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int w = (32 * (ks / 2) + 8 * tig + 4 * (ks % 2)) / 2;
    qa[ks][0] = gid < Gc ? q32[gid * (D / 2) + w] : 0u;
    qa[ks][2] = gid < Gc ? q32[gid * (D / 2) + w + 1] : 0u;
    qa[ks][1] = gid + 8 < Gc ? q32[(gid + 8) * (D / 2) + w] : 0u;
    qa[ks][3] = gid + 8 < Gc ? q32[(gid + 8) * (D / 2) + w + 1] : 0u;
  }
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const size_t row_stride = (size_t)Hkv * D;
  const __nv_bfloat16* kb = k + ((size_t)b * S * Hkv + h) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * S * Hkv + h) * D;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int base = start + warp * 16; base < end; base += kWarps * 16) {
    uint4 kr[2][KL], vr[4][VL];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int row = base + 8 * t + gid;
#pragma unroll
      for (int i = 0; i < KL; ++i)
        kr[t][i] = row < end ? __ldcs(reinterpret_cast<const uint4*>(
                                   kb + row * row_stride + 32 * i + 8 * tig))
                             : zero;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = base + 8 * (r / 2) + 2 * tig + r % 2;
#pragma unroll
      for (int j = 0; j < VL; ++j)
        vr[r][j] = row < end ? __ldcs(reinterpret_cast<const uint4*>(
                                   vb + row * row_stride + 64 * j + 8 * gid))
                             : zero;
    }
    // S = Q Kᵀ for the two 8-row tiles.
    float s[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        mma_bf16(s[t], qa[ks], word(kr[t][ks / 2], 2 * (ks % 2)),
                 word(kr[t][ks / 2], 2 * (ks % 2) + 1));
      }
    }
    // Scale, cap and mask; online softmax for head rows gid (hr 0), gid+8.
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[t][e] = base + 8 * t + 2 * tig + e % 2 < end ? x * kLog2e : kNegInf;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mt = fmaxf(fmaxf(s[0][2 * hr], s[0][2 * hr + 1]),
                       fmaxf(s[1][2 * hr], s[1][2 * hr + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 2));
      const float mn = fmaxf(m[hr], mt);
      const float alpha = exp2f(m[hr] - mn);
      m[hr] = mn;
      l[hr] *= alpha;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[nt][2 * hr] *= alpha;
        acc[nt][2 * hr + 1] *= alpha;
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          s[t][e] = exp2f(s[t][e] - mn);
          l[hr] += s[t][e];
        }
      }
    }
    // O += P V, P from the S accumulators as bf16 A fragments.
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = nt / 8;
      const int w = (nt % 8) / 2;
      const unsigned sel = nt % 2 ? 0x7632u : 0x5410u;
      const uint32_t b0 = __byte_perm(word(vr[0][j], w), word(vr[1][j], w), sel);
      const uint32_t b1 = __byte_perm(word(vr[2][j], w), word(vr[3][j], w), sel);
      mma_bf16(acc[nt], pa, b0, b1);
    }
  }

  // Each lane summed l over its own columns; the 4 lanes of a row share m.
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(kFull, l[hr], 1);
    l[hr] += __shfl_xor_sync(kFull, l[hr], 2);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sm_acc[warp][gid + 8 * (e / 2)][64 * (nt / 8) + 8 * (2 * tig + e % 2) + nt % 8] =
          acc[nt][e];
  }
  if (tig == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      sm_m[warp][gid + 8 * hr] = m[hr];
      sm_l[warp][gid + 8 * hr] = l[hr];
    }
  }
  __syncthreads();
  write_partial<kMmaG, D>(sm_acc, sm_m, sm_l, Gc,
                          ((size_t)bh * gridDim.y + split) * G + g0, m_part, l_part,
                          acc_part);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_merge(const float* __restrict__ m_part, const float* __restrict__ l_part,
                 const float* __restrict__ acc_part, T* __restrict__ out, int n_split, int G,
                 int D) {
  const size_t base = (size_t)blockIdx.x * n_split;
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D;
    float mx = kNegInf;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, m_part[(base + s) * G + g]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = exp2f(m_part[(base + s) * G + g] - mx);
      l += w * l_part[(base + s) * G + g];
      a += w * acc_part[(base + s) * G * D + e];
    }
    out[(size_t)blockIdx.x * G * D + e] = from_float<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_len,
                   void* out, float* m_part, float* l_part, float* acc_part, int B, int S,
                   int Hkv, int G, int n_split, int chunk, float scale, float softcap,
                   cudaStream_t s) {
  const auto* kv = static_cast<const int32_t*>(kv_len);
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D % 64 == 0) {
    const int n_gc = (G + kMmaG - 1) / kMmaG;
    decode_split_mma<D><<<dim3(B * Hkv * n_gc, n_split), kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv,
        m_part, l_part, acc_part, S, Hkv, G, n_gc, chunk, scale, softcap);
  } else {
    const int n_gc = (G + kMaxG - 1) / kMaxG;
    decode_split<T, D><<<dim3(B * Hkv * n_gc, n_split), kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv,
        m_part, l_part, acc_part, S, Hkv, G, n_gc, chunk, scale, softcap);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge<T><<<B * Hkv, kThreads, 0, s>>>(m_part, l_part, acc_part, static_cast<T*>(out),
                                                n_split, G, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, const void* kv_len,
                       void* out, float* m, float* l, float* acc, int B, int S, int Hkv,
                       int G, int n_split, int chunk, float scale, float softcap,
                       cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, kv_len, out, m, l, acc, B, S, Hkv, G, n_split, chunk,
                           scale, softcap, s);
    case 32:
      return launch<T, 32>(q, k, v, kv_len, out, m, l, acc, B, S, Hkv, G, n_split, chunk,
                           scale, softcap, s);
    case 64:
      return launch<T, 64>(q, k, v, kv_len, out, m, l, acc, B, S, Hkv, G, n_split, chunk,
                           scale, softcap, s);
    case 128:
      return launch<T, 128>(q, k, v, kv_len, out, m, l, acc, B, S, Hkv, G, n_split, chunk,
                            scale, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {16, 32, 64, 128}.  Scratch m_part
// and l_part hold B*Hkv*n_split*G floats, acc_part B*Hkv*n_split*G*D; split s
// covers cache rows [s*chunk, (s+1)*chunk).  Launches decode_split then
// decode_merge on `stream`; returns the first cudaError_t met.
extern "C" int decode_attention(int dtype, int D, const void* q, const void* k, const void* v,
                                const void* kv_len, void* out, void* m_part, void* l_part,
                                void* acc_part, int B, int S, int Hkv, int G, int n_split,
                                int chunk, float scale, float softcap, void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || chunk < 1 || n_split < 1 || n_split > 65535)
    return cudaErrorInvalidValue;
  auto* m = static_cast<float*>(m_part);
  auto* l = static_cast<float*>(l_part);
  auto* acc = static_cast<float*>(acc_part);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, kv_len, out, m, l, acc, B, S, Hkv, G, n_split, chunk,
                             scale, softcap, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, kv_len, out, m, l, acc, B, S, Hkv, G,
                                     n_split, chunk, scale, softcap, s);
  return cudaErrorInvalidValue;
}
