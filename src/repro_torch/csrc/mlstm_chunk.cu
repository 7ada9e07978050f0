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
// with fp32 accumulation whatever the input dtype, the output rounded once.
//
// What bounds it on this card: operations.  About 4 dh² + 2 (c + 1) dh flops
// per row (the causal mask leaves (c + 1) / 2 keys a row on average) against
// 8 dh bytes of q, k, v and h (bf16): ~ 600 flops per byte at the
// xlstm-1.3b width (dh = 1024, c = 256), far above the ridge, so the floor
// is the tensor cores' rate, and only wgmma reaches it.
//
// The TPU keeps C (dh x dh fp32) and n in VMEM across the sequential chunk
// axis.  At dh = 1024 C is 4 MiB per (b, h), about 18 times a CTA's shared
// memory, so that design cannot be carried over.  Only C and n carry across
// chunks, and their recurrence is linear, so the work splits into products
// that are all tensor-core shaped (the chunkwise form of Mamba-2's SSD and
// the TFLA mLSTM kernels).  Two paths, chosen by the wrapper by shape
// (`kernel_path` in ops.py):
//
// * bfloat16 with dh and c multiples of 64 (the model path): three launches
//   on wgmma, each with a TMA producer warp feeding 128-byte swizzled
//   64 x 64 boxes through a ring of mbarrier-guarded stages, in the order
//   state, scores, output.
//     mlstm_wg_state   one CTA per (b h, 128 rows x 256 columns of C): two
//                      consumer warpgroups keep the tile in their
//                      accumulators (fp32, m64n256) and walk the chunks; per
//                      chunk they store the entering C_j (bf16, through
//                      shared memory and TMA bulk stores, which the CTA's
//                      barriers do not wait for), scale by e^total, and add
//                      (k e^(total - cum + li))ᵀ v, k's rows scaled in shared
//                      memory (rounded to bf16) as the MN-major A operand and
//                      v the MN-major B.  The CTAs of the first column tile
//                      also sum n (fp32, unrounded) on the CUDA cores.  The
//                      last chunk's update feeds no output.
//     mlstm_wg_scores  one CTA per (b h, chunk, 64 query rows): s = (q kᵀ) ∘ w
//                      over the causal key tiles, written as bf16 (the s v
//                      operand), and the denominator e^cum (q · n_j) +
//                      rowsum(s) in fp32 from the unrounded s, the q · n dot
//                      on the CUDA cores under the products.
//     mlstm_wg_out     one CTA per (b h, chunk, 128 rows, 128 columns), the
//                      column tile fastest so that a chunk's CTAs share q, s
//                      and v in L2: the accumulators start as q C_j[:, cols]
//                      (q K-major, the stored state MN-major), take e^cum per
//                      row (exact: diag(e^cum)(q C) = (q e^cum) C, so q is
//                      never rounded), then add s v over the live key tiles,
//                      and each row is divided by max(|den|, 1).
//   Every mainloop waits for its products unconditionally before it reads
//   the accumulators: a wait chosen at run time makes ptxas serialize every
//   wgmma (its C7514/C7518 notes).  At the xlstm-1.3b shape the states are
//   ~0.25 GB written and read again, the design's price for keeping C out of
//   one CTA; PERF.md has the measured split.
//   The bf16 operands C_j, s and k e^(...) each round a term by at most
//   2^-9; chip_smoke.py bounds the result by that reach (its mlstm_card).
// * float32, and other bfloat16 shapes: the CUDA-core kernels below
//   (mlstm_scores, mlstm_state), fp32 throughout.
//
// All decay exponents of live terms are <= 0 (log gates), so no overflow
// guard is needed.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

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


// ---------------------------------------------------------------------------
// tensor-core kernels (bfloat16, dh and c multiples of 64)
// ---------------------------------------------------------------------------

constexpr int kWg = 128;                 // threads of a warpgroup
constexpr int kBox = 64 * 128;           // bytes of a 64 x 64 bf16 box, 128-byte swizzled
constexpr int kMaxKt = kMaxChunk / 64;   // key tiles of a chunk
// Columns a CTA owns: of C in the state kernel, of the output in the output
// kernel; each warpgroup's accumulators are 64 rows by that (m64nNk16).
// 256 columns cut the state kernel's loads per product (and time, by 8 %)
// against 128; the output kernel was no faster at 256 and keeps two CTAs a
// SM at 128.
constexpr int kN = 256;
constexpr int kNB = kN / 64;
constexpr int kON = 128;
constexpr int kONB = kON / 64;
constexpr int kScoreStages = 2;
constexpr int kScoreStageBytes = (1 + kMaxKt) * kBox;  // q, then the key tiles
// A stage of the state and output kernels: two boxes of the A operand (k
// for both groups' 64 rows of d; q or s for 128 rows), then the B
// operand's column boxes (v or C).
constexpr int kStateStages = 3;
constexpr int kOutStages = 3;
constexpr int kStateStageBytes = (2 + kNB) * kBox;
constexpr int kOutStageBytes = (2 + kONB) * kBox;

struct WgParams {
  Gates g;
  int H, S, dh, c, n_chunks;
  __nv_bfloat16* s_buf;   // (B H, n_chunks, c, c): s, zero above the diagonal of live tiles
  float* den;             // (B H, S): e^cum (q · n) + rowsum(s)
  __nv_bfloat16* states;  // (B H, n_states, dh, dh): C entering chunk j at j - 1
  float* n_buf;           // (B H, n_states, dh): n likewise
  __nv_bfloat16* out;
  long long sb, sh, ss;   // q, k, v, out element strides
  int n_states;           // max(n_chunks - 1, 1)
};

// The log gates of chunk rows [row0, row0 + c) of one (b, h) that one lane
// of a warp holds: rows 8 lane .. 8 lane + 7 (c <= 256).
struct LaneGates {
  float lf[8], li[8];
};

__device__ __forceinline__ void load_gates(const Gates& g, long long gbase, long long row0,
                                           int c, LaneGates& lg) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int r = lane * 8 + e;
    lg.lf[e] = r < c ? g.lf[gbase + (row0 + r) * g.ss] : 0.f;
    lg.li[e] = r < c ? g.li[gbase + (row0 + r) * g.ss] : 0.f;
  }
}

// cum = cumsum(lf) and li of the chunk into shared memory, by one warp.
__device__ void scan_gates(const LaneGates& lg, int c, float* __restrict__ cum,
                           float* __restrict__ li_s) {
  const int lane = threadIdx.x % 32;
  float x[8];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    run += lg.lf[e];
    x[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const float base = incl - run;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int r = lane * 8 + e;
    if (r < c) {
      cum[r] = x[e] + base;
      li_s[r] = lg.li[e];
    }
  }
}

__device__ void warp_gates(const Gates& g, long long gbase, long long row0, int c,
                           float* __restrict__ cum, float* __restrict__ li_s) {
  LaneGates lg;
  load_gates(g, gbase, row0, c, lg);
  scan_gates(lg, c, cum, li_s);
}

// Byte offset of 16-byte chunk cc of row r in a 128-byte swizzled box.
__device__ __forceinline__ int swz(int r, int cc) { return r * 128 + ((cc ^ (r & 7)) << 4); }

__device__ __forceinline__ uint8_t* align1024(uint8_t* raw) {
  return raw + ((1024 - (sm90::smem_addr(raw) & 1023)) & 1023);
}

// Stores a warpgroup's 64 x kON fp32 accumulator tile (the wgmma fragment
// layout) as bf16 at dst (row stride ld, 16-byte aligned rows), columns
// below `cols` (a multiple of 32) only.  A lane holds two columns of its
// row in each 8-column group; a 4 x 4 transpose inside each quad of lanes
// (shuffles) gives every lane 8 whole columns, one 16-byte store, so that a
// warp instruction writes 64 bytes of each of 8 rows.
__device__ __forceinline__ void store_tile(const float (&acc)[kON / 2], __nv_bfloat16* dst,
                                           long long ld, int cols) {
  const int warp = (threadIdx.x % kWg) / 32, lane = threadIdx.x % 32;
  const int q = lane % 4, r = 16 * warp + lane / 4;
#pragma unroll
  for (int g = 0; g < kON / 32; ++g) {  // column groups 4 g .. 4 g + 3 of 8 columns
    if (32 * g >= cols) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      uint32_t in[4], out[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * (4 * g + k) + 2 * hr],
                                                       acc[4 * (4 * g + k) + 2 * hr + 1]);
        in[k] = *reinterpret_cast<const uint32_t*>(&v);
      }
      // round k: lane q sends its words of group (q + k) & 3 and receives
      // lane ((q - k) & 3)'s words of group q
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int si = (q + k) & 3, di = (q - k) & 3;
        const uint32_t send = si == 0 ? in[0] : si == 1 ? in[1] : si == 2 ? in[2] : in[3];
        const uint32_t got = __shfl_sync(0xffffffffu, send, (lane & ~3) | di);
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (x == di) out[x] = got;
      }
      *reinterpret_cast<uint4*>(dst + (r + 8 * hr) * ld + 32 * g + 8 * q) =
          make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
}

// grid (ceil(dh / kN) column tiles, ceil(dh / 128) row tiles, B H);
// 2 * kWg + 32 threads.  Needs n_chunks >= 2.
__global__ void __launch_bounds__(2 * kWg + 32, 1)
    mlstm_wg_state(const WgParams p, const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv,
                   const __grid_constant__ CUtensorMap tmc) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);                        // [stages][k0 k1 v0 ..]
  uint8_t* stage_c = ring + kStateStages * kStateStageBytes;  // [2 groups][kNB boxes]: C_j
  float* dte_s = reinterpret_cast<float*>(stage_c + 2 * kNB * kBox);  // [2][kMaxChunk]
  float* cum_t = dte_s + 2 * kMaxChunk;                         // [kMaxChunk], warp 0's
  float* li_t = cum_t + kMaxChunk;                              // [kMaxChunk]
  float* red = li_t + kMaxChunk;                                // [2 groups][4 warps][64]
  float* n_s = red + 2 * 4 * 64;                                // [128]
  float* tot_s = n_s + 128;                                     // [2]
  uint64_t* full = reinterpret_cast<uint64_t*>(tot_s + 2);
  uint64_t* empty = full + kStateStages;

  const int et = blockIdx.x, dt = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.H, h = bh % p.H;
  const int nd = min(2, (p.dh - 128 * dt) / 64);  // d blocks of the tile: active groups
  const int ne = min(kNB, (p.dh - kN * et) / 64);  // e blocks
  const int n_sub = p.c / 64;
  const int n_it = (p.n_chunks - 1) * n_sub;      // 64-row steps of chunks 0 .. n - 2
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStateStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * nd);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWg) {
    // ---- producer: k (d blocks of the tile) and v (e blocks), 64 rows a stage.
    if (threadIdx.x == 2 * kWg) {
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStateStages;
        sm90::mbar_wait(&empty[s], ((it / kStateStages) & 1) ^ 1);
        uint8_t* st = ring + s * kStateStageBytes;
        const int row = (it / n_sub) * p.c + 64 * (it % n_sub);
        sm90::mbar_arrive_expect_tx(&full[s], (nd + ne) * kBox);
        for (int x = 0; x < nd; ++x)
          sm90::tma_load_4d(st + x * kBox, &tmk, &full[s], 128 * dt + 64 * x, row, h, b);
        for (int x = 0; x < ne; ++x)
          sm90::tma_load_4d(st + (2 + x) * kBox, &tmv, &full[s], kN * et + 64 * x, row, h, b);
      }
    }
    return;
  }
  const int w = threadIdx.x / kWg;
  if (w >= nd) return;
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  const bool with_n = et == 0;
  const long long gbase = b * p.g.sb + h * p.g.sh;
  // this thread scales 16-byte chunk cc (8 columns of d) of rows r0, r0 + 16, ...
  const int cc = tid % 8, r0 = tid / 8;
  float* n_w = n_s + 64 * w;
  if (tid < 64) n_w[tid] = 0.f;

  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  // C and n entering chunk j + 1: C through this group's kNB swizzled boxes
  // and TMA bulk stores (one thread waits, before the boxes are written
  // again, until the previous chunk's stores have read them).
  uint8_t* my_c = stage_c + kNB * w * kBox;
  auto store_state = [&](int j) {
    if (tid == 0) sm90::bulk_wait<0, true>();
    sm90::bar_sync(2 + w, kWg);
    const int r = 16 * warp + lane / 4, q = lane % 4;
#pragma unroll
    for (int jj = 0; jj < kN / 8; ++jj)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r + 8 * hr;
        *reinterpret_cast<__nv_bfloat162*>(my_c + (jj / 8) * kBox + swz(row, jj % 8) + 4 * q) =
            __floats2bfloat162_rn(acc[4 * jj + 2 * hr], acc[4 * jj + 2 * hr + 1]);
      }
    sm90::fence_proxy_async();
    sm90::bar_sync(2 + w, kWg);
    if (tid == 0) {
      for (int x = 0; x < ne; ++x)
        sm90::tma_store_4d(&tmc, my_c + x * kBox, kN * et + 64 * x, 128 * dt + 64 * w, j, bh);
      sm90::bulk_commit();
    }
    if (with_n && tid < 64)
      p.n_buf[((size_t)bh * p.n_states + j) * p.dh + 128 * dt + 64 * w + tid] = n_w[tid];
  };

  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[it % kStateStages]);
  };
  // warp 0 loads each chunk's gates while the previous chunk runs
  LaneGates lg;
  if (w == 0 && warp == 0) load_gates(p.g, gbase, 0, p.c, lg);
  for (int ch = 0; ch < p.n_chunks - 1; ++ch) {
    float* dte = dte_s + (ch & 1) * kMaxChunk;
    if (w == 0 && warp == 0) {
      scan_gates(lg, p.c, cum_t, li_t);
      if (ch + 1 < p.n_chunks - 1) load_gates(p.g, gbase, (long long)(ch + 1) * p.c, p.c, lg);
      __syncwarp();
      const float total = cum_t[p.c - 1];
      for (int r = lane; r < p.c; r += 32) dte[r] = expf(total - cum_t[r] + li_t[r]);
      if (lane == 0) tot_s[ch & 1] = total;
    }
    sm90::bar_sync(1, kWg * nd);
    if (ch > 0) store_state(ch - 1);
    const float decay = expf(tot_s[ch & 1]);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] *= decay;
    if (with_n && tid < 64) n_w[tid] *= decay;

    float nsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int sub = 0; sub < n_sub; ++sub) {
      const int it = ch * n_sub + sub;
      const int s = it % kStateStages;
      sm90::mbar_wait(&full[s], (it / kStateStages) & 1);
      uint8_t* st = ring + s * kStateStageBytes;
      uint8_t* kt = st + w * kBox;
      // k rows times e^(total - cum + li), rounded to bf16 in place
      for (int r = r0; r < 64; r += 16) {
        uint4* ptr = reinterpret_cast<uint4*>(kt + swz(r, cc));
        uint4 val = *ptr;
        const float f = dte[64 * sub + r];
        __nv_bfloat162* e2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float2 kv = __bfloat1622float2(e2[x]);
          const float a = kv.x * f, c2 = kv.y * f;
          nsum[2 * x] += a;
          nsum[2 * x + 1] += c2;
          e2[x] = __floats2bfloat162_rn(a, c2);
        }
        *ptr = val;
      }
      sm90::fence_proxy_async();
      sm90::bar_sync(2 + w, kWg);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss<kN, 1, 1>(acc, sm90::desc_sw128(kt + kk * 2048, kBox, 1024),
                                  sm90::desc_sw128(st + 2 * kBox + kk * 2048, kBox, 1024), 1);
      sm90::wgmma_commit();
      // at most this stage's products stay in flight while the next stage is
      // awaited and scaled; the accumulators are read only after the chunk's
      // last wait below (an unconditional one, or ptxas serializes them)
      sm90::wgmma_wait<1>();
      if (sub > 0) release(it - 1);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
    release(ch * n_sub + n_sub - 1);
    if (with_n) {
      // the 16 threads of chunk cc: four lanes of each warp, then the warps
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        nsum[x] += __shfl_xor_sync(0xffffffffu, nsum[x], 8);
        nsum[x] += __shfl_xor_sync(0xffffffffu, nsum[x], 16);
      }
      float* rw = red + (w * 4 + warp) * 64;
      if (lane < 8)
#pragma unroll
        for (int x = 0; x < 8; ++x) rw[8 * cc + x] = nsum[x];
      sm90::bar_sync(2 + w, kWg);
      if (tid < 64) {
        const float* rg = red + w * 4 * 64;
        n_w[tid] += (rg[tid] + rg[64 + tid]) + (rg[128 + tid] + rg[192 + tid]);
      }
    }
  }
  store_state(p.n_chunks - 2);
  if (tid == 0) sm90::bulk_wait<0, false>();
}

// grid (c / 64 row blocks, n_chunks, B H); kWg + 32 threads.
__global__ void __launch_bounds__(kWg + 32, 1)
    mlstm_wg_scores(const WgParams p, const __grid_constant__ CUtensorMap tmq,
                    const __grid_constant__ CUtensorMap tmk) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);                          // [stages][q, k tiles]
  float* n_s = reinterpret_cast<float*>(ring + kScoreStages * kScoreStageBytes);  // [dh]
  float* cum = n_s + p.dh;                                      // [kMaxChunk]
  float* li_s = cum + kMaxChunk;                                // [kMaxChunk]
  float* qn_s = li_s + kMaxChunk;                               // [64]
  uint64_t* full = reinterpret_cast<uint64_t*>(qn_s + 64);
  uint64_t* empty = full + kScoreStages;

  const int rb = blockIdx.x, ch = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.H, h = bh % p.H;
  const int nkt = rb + 1;  // key tiles of the causal range
  const int n_db = p.dh / 64;
  const int row0 = ch * p.c;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kScoreStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kWg) {
    // ---- producer: q rows and the causal k tiles, 64 columns of dh a stage.
    if (threadIdx.x == kWg) {
      for (int db = 0; db < n_db; ++db) {
        const int s = db % kScoreStages;
        sm90::mbar_wait(&empty[s], ((db / kScoreStages) & 1) ^ 1);
        uint8_t* st = ring + s * kScoreStageBytes;
        sm90::mbar_arrive_expect_tx(&full[s], (1 + nkt) * kBox);
        sm90::tma_load_4d(st, &tmq, &full[s], 64 * db, row0 + 64 * rb, h, b);
        for (int tj = 0; tj < nkt; ++tj)
          sm90::tma_load_4d(st + (1 + tj) * kBox, &tmk, &full[s], 64 * db, row0 + 64 * tj, h, b);
      }
    }
    return;
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool inter = ch > 0;
  if (warp == 0) warp_gates(p.g, b * p.g.sb + h * p.g.sh, row0, p.c, cum, li_s);
  if (inter)
    for (int d = tid; d < p.dh; d += kWg)
      n_s[d] = p.n_buf[((size_t)bh * p.n_states + ch - 1) * p.dh + d];
  sm90::bar_sync(1, kWg);

  // the key tiles' accumulators, 32 a tile
  float acc[4 * kMaxKt * 8];
#pragma unroll
  for (int i = 0; i < 4 * kMaxKt * 8; ++i) acc[i] = 0.f;
  float qn = 0.f;
  const int qr = tid / 2, qc = 4 * (tid % 2);  // q · n: row, first 16-byte chunk
  auto release = [&](int db) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[db % kScoreStages]);
  };
  for (int db = 0; db < n_db; ++db) {
    const int s = db % kScoreStages;
    sm90::mbar_wait(&full[s], (db / kScoreStages) & 1);
    const uint8_t* st = ring + s * kScoreStageBytes;
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t da = sm90::desc_sw128(st + ks * 32, 16, 1024);
#pragma unroll
      for (int tj = 0; tj < kMaxKt; ++tj)
        if (tj < nkt)
          sm90::wgmma_ss<64>(*reinterpret_cast<float(*)[32]>(acc + 32 * tj), da,
                             sm90::desc_sw128(st + (1 + tj) * kBox + ks * 32, 16, 1024),
                             db > 0 || ks > 0);
    }
    sm90::wgmma_commit();
    if (inter) {
      const float* nd = n_s + 64 * db;
#pragma unroll
      for (int x = qc; x < qc + 4; ++x) {
        const uint4 val = *reinterpret_cast<const uint4*>(st + swz(qr, x));
        const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&val);
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const float2 qv = __bfloat1622float2(e2[y]);
          qn += qv.x * nd[8 * x + 2 * y] + qv.y * nd[8 * x + 2 * y + 1];
        }
      }
    }
    // Each stage is waited for and released at once: with two stages,
    // keeping its products in flight into the next step delays the
    // producer's refill (measured slower, 0.119 against 0.076 ms).  The
    // products under `tj < nkt` make ptxas inject warpgroup arrives, cheaper
    // than issuing all four tiles' products (0.115 ms).
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
    release(db);
  }

  qn += __shfl_xor_sync(0xffffffffu, qn, 1);
  if (tid % 2 == 0) qn_s[qr] = qn;
  sm90::bar_sync(1, kWg);
  // s = (q kᵀ) ∘ w, zero above the diagonal, as bf16; rowsum(s) in fp32.
  const int r = 16 * warp + lane / 4;
  float rs[2] = {0.f, 0.f};
  __nv_bfloat16* s_out = p.s_buf + ((size_t)bh * p.n_chunks + ch) * p.c * p.c;
#pragma unroll
  for (int tj = 0; tj < kMaxKt; ++tj) {
    if (tj >= nkt) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = 64 * rb + r + 8 * hr;
        const int j = 64 * tj + 8 * jj + 2 * (lane % 4);
        const float* a = acc + 4 * (8 * tj + jj) + 2 * hr;
        const float s0 = j <= i ? a[0] * expf(cum[i] - cum[j] + li_s[j]) : 0.f;
        const float s1 = j + 1 <= i ? a[1] * expf(cum[i] - cum[j + 1] + li_s[j + 1]) : 0.f;
        rs[hr] += s0 + s1;
        *reinterpret_cast<__nv_bfloat162*>(s_out + (size_t)i * p.c + j) =
            __floats2bfloat162_rn(s0, s1);
      }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
    rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
    const int i = 64 * rb + r + 8 * hr;
    if (lane % 4 == 0)
      p.den[(size_t)bh * p.S + row0 + i] = expf(cum[i]) * qn_s[r + 8 * hr] + rs[hr];
  }
}

// grid B H * n_chunks * ceil(c / 128) row tiles * ceil(dh / kN) column
// tiles; 2 * kWg + 32 threads.  Group w owns rows 64 w .. of the tile.
__global__ void __launch_bounds__(2 * kWg + 32, 1)
    mlstm_wg_out(const WgParams p, const __grid_constant__ CUtensorMap tmq,
                 const __grid_constant__ CUtensorMap tmv, const __grid_constant__ CUtensorMap tms,
                 const __grid_constant__ CUtensorMap tmc) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);              // [stages][q or s (128 rows), C or v]
  float* ecum = reinterpret_cast<float*>(ring + kOutStages * kOutStageBytes);  // [kMaxChunk]
  float* li_s = ecum + kMaxChunk;                   // [kMaxChunk]: li, which warp_gates writes
  uint64_t* full = reinterpret_cast<uint64_t*>(li_s + kMaxChunk);
  uint64_t* empty = full + kOutStages;

  // column tile fastest, so the CTAs of one chunk share its q rows, s and
  // v in L2, and the two row tiles its state columns
  const int n_ct = (p.dh + kON - 1) / kON, n_rt = (p.c + 127) / 128;
  const int ct = blockIdx.x % n_ct, rt = blockIdx.x / n_ct % n_rt;
  const int ch = blockIdx.x / (n_ct * n_rt) % p.n_chunks;
  const int bh = blockIdx.x / (n_ct * n_rt * p.n_chunks);
  const int b = bh / p.H, h = bh % p.H;
  const int nw = min(2, (p.c - 128 * rt) / 64);    // row blocks of the tile: active groups
  const int ne = min(kONB, (p.dh - kON * ct) / 64);  // column blocks
  const int n_a = ch > 0 ? p.dh / 64 : 0;          // steps of q C
  const int n_b = min(p.c, 128 * (rt + 1)) / 64;   // key tiles of s v
  const int row0 = ch * p.c;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kOutStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * nw);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWg) {
    // ---- producer: (q, C) over dh, then (s, v) over the live keys.
    if (threadIdx.x == 2 * kWg) {
      for (int it = 0; it < n_a + n_b; ++it) {
        const int s = it % kOutStages;
        sm90::mbar_wait(&empty[s], ((it / kOutStages) & 1) ^ 1);
        uint8_t* st = ring + s * kOutStageBytes;
        sm90::mbar_arrive_expect_tx(&full[s], (2 + ne) * kBox);
        if (it < n_a) {
          sm90::tma_load_4d(st, &tmq, &full[s], 64 * it, row0 + 128 * rt, h, b);
          for (int x = 0; x < ne; ++x)
            sm90::tma_load_4d(st + (2 + x) * kBox, &tmc, &full[s], kON * ct + 64 * x, 64 * it,
                              ch - 1, bh);
        } else {
          const int kb = it - n_a;
          sm90::tma_load_4d(st, &tms, &full[s], 64 * kb, 128 * rt, ch, bh);
          for (int x = 0; x < ne; ++x)
            sm90::tma_load_4d(st + (2 + x) * kBox, &tmv, &full[s], kON * ct + 64 * x,
                              row0 + 64 * kb, h, b);
        }
      }
    }
    return;
  }
  const int w = threadIdx.x / kWg;
  if (w >= nw) return;
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  if (w == 0 && warp == 0) {
    warp_gates(p.g, b * p.g.sb + h * p.g.sh, row0, p.c, ecum, li_s);
    __syncwarp();
    for (int r = lane; r < p.c; r += 32) ecum[r] = expf(ecum[r]);
  }
  sm90::bar_sync(1, kWg * nw);
  const int rb = 2 * rt + w;  // this group's 64-row block of the chunk

  float acc[kON / 2];
#pragma unroll
  for (int i = 0; i < kON / 2; ++i) acc[i] = 0.f;
  const int r = 16 * warp + lane / 4;
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[it % kOutStages]);
  };
  // One pass of products over stages [first, last), at most one stage's in
  // flight while the next is awaited; the accumulators are read only after
  // the pass's last, unconditional wait (else ptxas serializes them).
  auto pass = [&](int first, int last) {
    for (int it = first; it < last; ++it) {
      const int s = it % kOutStages;
      sm90::mbar_wait(&full[s], (it / kOutStages) & 1);
      const uint8_t* st = ring + s * kOutStageBytes;
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        sm90::wgmma_ss<kON, 0, 1>(acc, sm90::desc_sw128(st + w * kBox + ks * 32, 16, 1024),
                                  sm90::desc_sw128(st + 2 * kBox + ks * 2048, kBox, 1024),
                                  it > 0 || ks > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (it > first) release(it - 1);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
    if (last > first) release(last - 1);
  };
  // q C_j over dh, then diag(e^cum) for the inter-chunk term of each row
  pass(0, n_a);
  if (n_a > 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float f = ecum[64 * rb + r + 8 * hr];
#pragma unroll
      for (int jj = 0; jj < kON / 8; ++jj) {
        acc[4 * jj + 2 * hr] *= f;
        acc[4 * jj + 2 * hr + 1] *= f;
      }
    }
  }
  // s v over this group's key tiles 0 .. rb; the other group's last tile,
  // if any, is only awaited and released
  pass(n_a, n_a + rb + 1);
  for (int it = n_a + rb + 1; it < n_a + n_b; ++it) {
    sm90::mbar_wait(&full[it % kOutStages], (it / kOutStages) & 1);
    release(it);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = 64 * rb + r + 8 * hr;
    const float inv = 1.f / fmaxf(fabsf(p.den[(size_t)bh * p.S + row0 + i]), 1.f);
#pragma unroll
    for (int jj = 0; jj < kON / 8; ++jj) {
      acc[4 * jj + 2 * hr] *= inv;
      acc[4 * jj + 2 * hr + 1] *= inv;
    }
  }
  store_tile(acc, p.out + b * p.sb + h * p.sh + (long long)(row0 + 64 * rb) * p.ss + kON * ct,
             p.ss, 64 * ne);
}

size_t state_smem() {
  return 1024 + (size_t)kStateStages * kStateStageBytes + 2 * kNB * kBox +
         (2 * kMaxChunk + 2 * kMaxChunk + 2 * 4 * 64 + 128 + 2) * sizeof(float) +
         2 * kStateStages * sizeof(uint64_t) + 8;
}

size_t scores_smem(int dh) {
  return 1024 + (size_t)kScoreStages * kScoreStageBytes +
         ((size_t)dh + 2 * kMaxChunk + 64) * sizeof(float) + 2 * kScoreStages * sizeof(uint64_t);
}

size_t out_smem() {
  return 1024 + (size_t)kOutStages * kOutStageBytes + 2 * kMaxChunk * sizeof(float) +
         2 * kOutStages * sizeof(uint64_t);
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v, WgParams p, int B,
                         cudaStream_t s) {
  const int BH = B * p.H;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const long long qkv_dims[4] = {p.dh, p.S, p.H, B};
  const long long qkv_str[3] = {p.ss, p.sh, p.sb};
  const long long cc = (long long)p.c * p.c;
  CUtensorMap tmq64, tmq128, tmk, tmv, tms, tmc;
  if (!sm90::tile_map(&tmq64, bf, 2, q, qkv_dims, qkv_str, {64, 64, 1, 1}, sw) ||
      !sm90::tile_map(&tmq128, bf, 2, q, qkv_dims, qkv_str, {64, 128, 1, 1}, sw) ||
      !sm90::tile_map(&tmk, bf, 2, k, qkv_dims, qkv_str, {64, 64, 1, 1}, sw) ||
      !sm90::tile_map(&tmv, bf, 2, v, qkv_dims, qkv_str, {64, 64, 1, 1}, sw) ||
      !sm90::tile_map(&tms, bf, 2, p.s_buf, {p.c, p.c, p.n_chunks, BH},
                      {p.c, cc, p.n_chunks * cc}, {64, 128, 1, 1}, sw) ||
      !sm90::tile_map(&tmc, bf, 2, p.states, {p.dh, p.dh, p.n_states, BH},
                      {p.dh, (long long)p.dh * p.dh, (long long)p.n_states * p.dh * p.dh},
                      {64, 64, 1, 1}, sw))
    return cudaErrorInvalidValue;
  const int tiles = (p.dh + 127) / 128, n_tiles = (p.dh + kN - 1) / kN;
  const int n_out_tiles = (p.dh + kON - 1) / kON;
  cudaError_t err;
  if (p.n_chunks > 1) {
    if ((err = set_smem((const void*)mlstm_wg_state, state_smem())) != cudaSuccess) return err;
    mlstm_wg_state<<<dim3(n_tiles, tiles, BH), 2 * kWg + 32, state_smem(), s>>>(p, tmk, tmv,
                                                                               tmc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t ss = scores_smem(p.dh);
  if ((err = set_smem((const void*)mlstm_wg_scores, ss)) != cudaSuccess) return err;
  mlstm_wg_scores<<<dim3(p.c / 64, p.n_chunks, BH), kWg + 32, ss, s>>>(p, tmq64, tmk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem((const void*)mlstm_wg_out, out_smem())) != cudaSuccess) return err;
  mlstm_wg_out<<<n_out_tiles * ((p.c + 127) / 128) * p.n_chunks * BH, 2 * kWg + 32, out_smem(),
                 s>>>(
      p, tmq128, tmv, tms, tmc);
  return cudaGetLastError();
}

}  // namespace

// path: 0 = CUDA cores (mlstm_scores, mlstm_state; float32 or bfloat16),
// 1 = tensor cores (bfloat16, dh and c multiples of 64); dtype: 0 = float32,
// 1 = bfloat16 (q, k, v and out); li, lf float32.  q, k, v, out: (B, H, S,
// dh) views with element strides (sb, sh, ss, 1); li, lf: (B, H, S) views
// with strides (gsb, gsh, gss).  S = n_chunks * c, c <= 256, dh <= 1024.
// Scratch: path 0 takes s_buf as B H n_chunks c² floats; path 1 takes
// s_buf as B H n_chunks c² bf16, den as B H S floats, states as B H
// n_states dh² bf16 and n_buf as B H n_states dh floats, n_states =
// max(n_chunks - 1, 1), and needs 16-byte aligned bases and strides.
extern "C" int mlstm_chunk(int path, int dtype, const void* q, const void* k, const void* v,
                           const void* li, const void* lf, void* out, void* s_buf, void* den,
                           void* states, void* n_buf, int B, int H, int dh, int c,
                           int n_chunks, long long sb, long long sh, long long ss, long long gsb,
                           long long gsh, long long gss, void* stream) {
  if (B < 1 || H < 1 || dh < 1 || dh > 1024 || c < 1 || c > kMaxChunk || n_chunks < 1 ||
      n_chunks > 65535 || B * H > 65535)
    return cudaErrorInvalidValue;
  const Gates g{static_cast<const float*>(li), static_cast<const float*>(lf), gsb, gsh, gss};
  const auto st = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != 1 || dh % 64 || c % 64) return cudaErrorInvalidValue;
    const WgParams p{g, H, n_chunks * c, dh, c, n_chunks,
                     static_cast<__nv_bfloat16*>(s_buf), static_cast<float*>(den),
                     static_cast<__nv_bfloat16*>(states), static_cast<float*>(n_buf),
                     static_cast<__nv_bfloat16*>(out), sb, sh, ss, n_chunks > 1 ? n_chunks - 1 : 1};
    return launch_wgmma(q, k, v, p, B, st);
  }
  auto* sbuf = static_cast<float*>(s_buf);
  if (path == 0 && dtype == 0)
    return launch<float>(q, k, v, g, sbuf, out, B, H, dh, c, n_chunks, sb, sh, ss, st);
  if (path == 0 && dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, g, sbuf, out, B, H, dh, c, n_chunks, sb, sh, ss, st);
  return cudaErrorInvalidValue;
}
