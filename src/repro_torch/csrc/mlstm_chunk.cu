// Chunkwise mLSTM (K7) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mlstm_chunk (body _mlstm_kernel) of
// src/repro/kernels/mlstm_chunk/kernel.py.  Per (b, h) and chunk of c rows,
// with cum = cumsum(lf) and total = cum[c-1] inside the chunk:
//
//   inter = (q e^cum) C,   s = (q kᵀ) ∘ w,  w_ij = e^(cum_i - cum_j + li_j) (i >= j)
//   h     = (inter + s v) / max(|(q e^cum) n + rowsum(s)|, 1)
//   C    <- C e^total + (k e^(total - cum + li))ᵀ v,   n likewise with v = 1
//
// in fp32 whatever the input dtype, the output rounded once.
//
// What bounds it on this card: operations.  About 4 dh² + 2 (c + 1) dh flops
// per row (the causal mask leaves (c + 1) / 2 keys a row on average) against
// 8 dh bytes of q, k, v and h (bf16): ~ 600 flops per byte at the
// xlstm-1.3b width (dh = 1024, c = 256), far above the ridge.  This
// first version runs every product on the CUDA cores in fp32, as the
// reference computes it, so its floor is the fp32 rate, not the tensor cores'.
//
// The TPU keeps C (dh x dh fp32) and n in VMEM across the sequential chunk
// axis.  At dh = 1024 C is 4 MiB per (b, h), about 18 times a CTA's shared
// memory, so the design cannot be carried over.  Instead:
//
//   mlstm_scores  one CTA per (b, h, chunk, 64 x 64 tile of the causal
//                 lower triangle) writes s = (q kᵀ) ∘ w to scratch in fp32
//                 (c² floats per chunk).  Everything the value columns share
//                 is computed once here instead of once per column slab.
//   mlstm_state   one CTA per (b, h, slab of kBV = 32 value columns) owns
//                 C[:, slab] in shared memory (128 KB at dh = 1024) and walks
//                 the chunks in order.  n has dh floats; every CTA of a (b, h)
//                 keeps its own copy, and the denominator comes from n and
//                 rowsum(s) without any dh x dh work.  Each thread keeps an
//                 8 x 4 tile of every product in registers, so a step reads
//                 three 16-byte shared words for 32 multiply-adds.  The grid is
//                 B * H * dh / 32 CTAs: 256, two waves of one CTA per SM, at
//                 the xlstm-1.3b shape (B = 2).
//
// All decay exponents are <= 0 (log gates), so no overflow guard is needed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // rows and columns of an s tile
constexpr int kDK = 32;         // contraction step over dh
constexpr int kBV = 32;         // value columns per state CTA
constexpr int kMaxChunk = 256;
constexpr int kPad = 4;         // floats of padding per shared row
constexpr int kKD = 256;        // dh rows per step of the state update

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

// Inclusive cumsum of x[0..c) into cum[0..c) (c <= kMaxChunk, all kThreads
// threads call it); warp_tot holds kThreads / 32 floats of scratch.
__device__ void chunk_cumsum(const float* __restrict__ x, float* __restrict__ cum,
                             float* __restrict__ warp_tot, int c) {
  const int t = threadIdx.x;
  const int lane = t % 32, warp = t / 32;
  float v = t < c ? x[t] : 0.f;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base += warp_tot[w];
  if (t < c) cum[t] = v + base;
  __syncthreads();
}

// Gate pointer arithmetic: element (b, h, s) of a (B, H, S) view.
struct Gates {
  const float* li;
  const float* lf;
  long long sb, sh, ss;
};

// grid (n_pairs, n_chunks, B * H); pair p enumerates the tiles (ti, tj) of
// the lower triangle, tj <= ti, row by row.  s_buf: (B * H, n_chunks, c, c).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlstm_scores(const T* __restrict__ q, const T* __restrict__ k, Gates g,
                 float* __restrict__ s_buf, int H, int dh, int c, long long sb, long long sh,
                 long long ss) {
  __shared__ __align__(16) float qs[kDK][kTile + kPad];
  __shared__ __align__(16) float ks[kDK][kTile + kPad];
  __shared__ float lf_s[kMaxChunk], cum[kMaxChunk], li_s[kMaxChunk], warp_tot[kThreads / 32];

  int ti = 0, p = blockIdx.x;
  while (p > ti) p -= ++ti;
  const int tj = p;
  const int ch = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int t = threadIdx.x;
  const long long row0 = (long long)ch * c;

  const long long gbase = b * g.sb + h * g.sh;
  if (t < c) {
    lf_s[t] = g.lf[gbase + (row0 + t) * g.ss];
    li_s[t] = g.li[gbase + (row0 + t) * g.ss];
  }
  __syncthreads();
  chunk_cumsum(lf_s, cum, warp_tot, c);

  const T* qb = q + b * sb + h * sh + row0 * ss;
  const T* kb = k + b * sb + h * sh + row0 * ss;
  const int tx = t % 16, ty = t / 16;
  float acc[4][4] = {};
  for (int d0 = 0; d0 < dh; d0 += kDK) {
    const int d = t % kDK;
#pragma unroll
    for (int r = t / kDK; r < kTile; r += kThreads / kDK) {
      const int i = ti * kTile + r, j = tj * kTile + r;
      const bool dl = d0 + d < dh;
      qs[d][r] = dl && i < c ? to_float(qb[i * ss + d0 + d]) : 0.f;
      ks[d][r] = dl && j < c ? to_float(kb[j * ss + d0 + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int dd = 0; dd < kDK; ++dd) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[dd][ty * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&ks[dd][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] += av[x] * bv[y];
    }
    __syncthreads();
  }
  float* out = s_buf + ((size_t)bh * gridDim.y + ch) * c * c;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int i = ti * kTile + ty * 4 + x;
    if (i >= c) continue;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int j = tj * kTile + tx * 4 + y;
      if (j >= c) continue;
      out[(size_t)i * c + j] = j <= i ? acc[x][y] * expf(cum[i] - cum[j] + li_s[j]) : 0.f;
    }
  }
}

// mlstm_state's threads form a 32 x 8 grid: thread (tr, tc) = (t / 8, t % 8)
// owns an 8 x 4 register tile, rows 8 tr.. (chunk rows, or dh rows of the C
// slab) by columns 4 tc.. of the slab, so each step of a product reads three
// 16-byte shared words for 32 fused multiply-adds.
constexpr int kLR = kMaxChunk + kPad;  // row stride of tiles indexed by chunk or dh row
constexpr int kSJ = 16;                // s columns per step of the intra-chunk product
static_assert(kThreads == 256 && kBV == 32 && kKD == 256 && kMaxChunk == 256,
              "mlstm_state's thread grid");

// Shared memory of mlstm_state, in floats, for head size dh.  The work tile
// (qs [kDK][kLR] | St [kSJ][kLR] | Kt [kDK][kLR]) comes first and the C slab
// next, so both stay 16-byte aligned.
constexpr int kWork = kDK * kLR;
__host__ __device__ constexpr size_t state_smem_floats(int dh) {
  return kWork                       // work tile
         + (size_t)dh * kBV           // C slab
         + (size_t)kMaxChunk * kBV    // v slab of the chunk
         + 4 * kMaxChunk              // lf / cum / e^cum / decay to end
         + kThreads / 32              // scan scratch
         + dh;                        // n
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[x][y] += a[x] * b[y] for the 8 rows a0, a1 and the 4 columns b.
__device__ __forceinline__ void outer8x4(float (&acc)[8][4], float4 a0, float4 a1, float4 b) {
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int x = 0; x < 8; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] += a[x] * bv[y];
}

// grid (ceil(dh / kBV), B * H).  Walks the chunks in order; see the header.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_state(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                Gates g, const float* __restrict__ s_buf, T* __restrict__ out, int H, int dh,
                int c, int n_chunks, long long sb, long long sh, long long ss) {
  extern __shared__ __align__(16) float smem[];
  float* work = smem;
  float* Cs = work + kWork;                   // [dh][kBV]
  float* vs = Cs + (size_t)dh * kBV;          // [kMaxChunk][kBV]
  float* cum = vs + kMaxChunk * kBV;          // [kMaxChunk]
  float* ecum = cum + kMaxChunk;              // e^cum
  float* dte = ecum + kMaxChunk;              // e^(total - cum + li)
  float* tmp = dte + kMaxChunk;               // lf
  float* warp_tot = tmp + kMaxChunk;          // [kThreads / 32]
  float* ns = warp_tot + kThreads / 32;       // [dh]
  const int t = threadIdx.x;
  const int lane = t % 32, warp = t / 32;
  const int r8 = (t / 8) * 8, c4 = (t % 8) * 4;  // first row and column of the tile
  const int col0 = blockIdx.x * kBV;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const T* qb = q + b * sb + h * sh;
  const T* kb = k + b * sb + h * sh;
  const T* vb = v + b * sb + h * sh;
  T* ob = out + b * sb + h * sh;
  const long long gbase = b * g.sb + h * g.sh;
  const int c8 = (c + 7) / 8 * 8;  // chunk rows the tiles fill (zero past c)

  for (int i = t; i < dh * kBV; i += kThreads) Cs[i] = 0.f;
  for (int i = t; i < dh; i += kThreads) ns[i] = 0.f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const long long row0 = (long long)ch * c;
    __syncthreads();  // the previous chunk's readers of tmp, vs, Cs, ns are done
    if (t < c) tmp[t] = g.lf[gbase + (row0 + t) * g.ss];
    __syncthreads();
    chunk_cumsum(tmp, cum, warp_tot, c);
    const float total = cum[c - 1];
    if (t < c) {
      const float li = g.li[gbase + (row0 + t) * g.ss];
      ecum[t] = expf(cum[t]);
      dte[t] = expf(total - cum[t] + li);
    }
    for (int r = warp; r < c; r += kThreads / 32)
      vs[r * kBV + lane] = col0 + lane < dh ? to_float(vb[(row0 + r) * ss + col0 + lane]) : 0.f;
    __syncthreads();

    float acc[8][4] = {};
    float den[8] = {};
    // (q e^cum) C[:, slab] and (q e^cum) . n, kDK rows of dh a step.
    float* qs = work;  // [kDK][kLR], q e^cum transposed
    for (int d0 = 0; d0 < dh; d0 += kDK) {
      {
        const int d = t % kDK;
        for (int r = t / kDK; r < c8; r += kThreads / kDK)
          qs[d * kLR + r] =
              r < c && d0 + d < dh ? to_float(qb[(row0 + r) * ss + d0 + d]) * ecum[r] : 0.f;
      }
      __syncthreads();
      if (r8 < c) {
#pragma unroll 8
        for (int dd = 0; dd < kDK; ++dd)
          outer8x4(acc, ld4(&qs[dd * kLR + r8]), ld4(&qs[dd * kLR + r8 + 4]),
                   ld4(&Cs[(size_t)min(d0 + dd, dh - 1) * kBV + c4]));
        // the denominator over this thread's 4 of the step's kDK rows of dh
#pragma unroll
        for (int dd = c4; dd < c4 + 4; ++dd) {
          const float nd = d0 + dd < dh ? ns[d0 + dd] : 0.f;
#pragma unroll
          for (int x = 0; x < 8; ++x) den[x] += qs[dd * kLR + r8 + x] * nd;
        }
      }
      __syncthreads();
    }
    // s v and rowsum(s), kSJ chunk columns a step; column j counts for rows >= j.
    const float* s_chunk = s_buf + ((size_t)bh * n_chunks + ch) * c * c;
    float* St = work;  // [kSJ][kLR], s transposed: St[j][r]
    for (int j0 = 0; j0 < c; j0 += kSJ) {
      {
        const int j = t % kSJ;
        for (int r = t / kSJ; r < c8; r += kThreads / kSJ)
          St[j * kLR + r] = r < c && j0 + j <= r ? s_chunk[(size_t)r * c + j0 + j] : 0.f;
      }
      __syncthreads();
      if (r8 < c && r8 + 7 >= j0) {
        const int jn = min(kSJ, c - j0);
        for (int jj = 0; jj < jn; ++jj)
          outer8x4(acc, ld4(&St[jj * kLR + r8]), ld4(&St[jj * kLR + r8 + 4]),
                   ld4(&vs[(j0 + jj) * kBV + c4]));
#pragma unroll
        for (int jj = c4 / 2; jj < c4 / 2 + 2; ++jj)
#pragma unroll
          for (int x = 0; x < 8; ++x) den[x] += St[jj * kLR + r8 + x];
      }
      __syncthreads();
    }
    // The 8 threads of a row group (neighbouring lanes) hold its partials.
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      den[x] += __shfl_xor_sync(0xffffffffu, den[x], 1);
      den[x] += __shfl_xor_sync(0xffffffffu, den[x], 2);
      den[x] += __shfl_xor_sync(0xffffffffu, den[x], 4);
    }
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int r = r8 + x;
      if (r >= c) continue;
      const float inv = 1.f / fmaxf(fabsf(den[x]), 1.f);
#pragma unroll
      for (int y = 0; y < 4; ++y)
        if (col0 + c4 + y < dh)
          ob[(row0 + r) * ss + col0 + c4 + y] = from_float<T>(acc[x][y] * inv);
    }

    // C <- C e^total + (k e^(total - cum + li))ᵀ v; n likewise.
    const float decay = expf(total);
    float* Kt = work;  // [kDK][kLR]: k e^(total - cum + li), chunk rows by dh rows
    for (int dt0 = 0; dt0 < dh; dt0 += kKD) {
      float acc2[8][4];
      float nacc[8] = {};
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int d = dt0 + r8 + x;
        const float4 cv =
            d < dh ? ld4(&Cs[(size_t)d * kBV + c4]) : make_float4(0.f, 0.f, 0.f, 0.f);
        acc2[x][0] = cv.x * decay;
        acc2[x][1] = cv.y * decay;
        acc2[x][2] = cv.z * decay;
        acc2[x][3] = cv.w * decay;
      }
      for (int j0 = 0; j0 < c; j0 += kDK) {
        for (int j = 0; j < kDK; ++j) {
          const int jr = j0 + j;
          Kt[j * kLR + t] = jr < c && dt0 + t < dh
                                ? to_float(kb[(row0 + jr) * ss + dt0 + t]) * dte[jr]
                                : 0.f;
        }
        __syncthreads();
        const int jn = min(kDK, c - j0);
        for (int j = 0; j < jn; ++j)
          outer8x4(acc2, ld4(&Kt[j * kLR + r8]), ld4(&Kt[j * kLR + r8 + 4]),
                   ld4(&vs[(j0 + j) * kBV + c4]));
#pragma unroll
        for (int j = c4; j < c4 + 4; ++j)
#pragma unroll
          for (int x = 0; x < 8; ++x) nacc[x] += Kt[j * kLR + r8 + x];
        __syncthreads();
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int d = dt0 + r8 + x;
        if (d < dh)
          *reinterpret_cast<float4*>(&Cs[(size_t)d * kBV + c4]) =
              make_float4(acc2[x][0], acc2[x][1], acc2[x][2], acc2[x][3]);
        nacc[x] += __shfl_xor_sync(0xffffffffu, nacc[x], 1);
        nacc[x] += __shfl_xor_sync(0xffffffffu, nacc[x], 2);
        nacc[x] += __shfl_xor_sync(0xffffffffu, nacc[x], 4);
        if (c4 == 0 && d < dh) ns[d] = ns[d] * decay + nacc[x];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, Gates g, float* s_buf,
                   void* out, int B, int H, int dh, int c, int n_chunks, long long sb,
                   long long sh, long long ss, cudaStream_t s) {
  const auto* tq = static_cast<const T*>(q);
  const auto* tk = static_cast<const T*>(k);
  const int nt = (c + kTile - 1) / kTile;
  mlstm_scores<T><<<dim3(nt * (nt + 1) / 2, n_chunks, B * H), kThreads, 0, s>>>(
      tq, tk, g, s_buf, H, dh, c, sb, sh, ss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = state_smem_floats(dh) * sizeof(float);
  err = cudaFuncSetAttribute(mlstm_state<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  mlstm_state<T><<<dim3((dh + kBV - 1) / kBV, B * H), kThreads, smem, s>>>(
      tq, tk, static_cast<const T*>(v), g, s_buf, static_cast<T*>(out), H, dh, c, n_chunks, sb,
      sh, ss);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out); li, lf float32.
// q, k, v, out: (B, H, S, dh) views with element strides (sb, sh, ss, 1);
// li, lf: (B, H, S) views with strides (gsb, gsh, gss).  S = n_chunks * c,
// c <= 256, dh <= 1024.  s_buf: B * H * n_chunks * c * c floats of scratch.
extern "C" int mlstm_chunk(int dtype, const void* q, const void* k, const void* v,
                           const void* li, const void* lf, void* out, void* s_buf, int B,
                           int H, int dh, int c, int n_chunks, long long sb, long long sh,
                           long long ss, long long gsb, long long gsh, long long gss,
                           void* stream) {
  if (B < 1 || H < 1 || dh < 1 || dh > 1024 || c < 1 || c > kMaxChunk || n_chunks < 1 ||
      n_chunks > 65535 || B * H > 65535)
    return cudaErrorInvalidValue;
  const Gates g{static_cast<const float*>(li), static_cast<const float*>(lf), gsb, gsh, gss};
  auto* sbuf = static_cast<float*>(s_buf);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, g, sbuf, out, B, H, dh, c, n_chunks, sb, sh, ss, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, g, sbuf, out, B, H, dh, c, n_chunks, sb, sh, ss, st);
  return cudaErrorInvalidValue;
}
