// Forward GQA flash attention (K5) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention (body _attn_kernel) of
// src/repro/kernels/flash_attention/kernel.py: q (Sq rows) attends over
// k, v (Skv rows) per head, query head g of a group reading kv head g / G;
// causal (key <= query), sliding window (key > query - window) and key <
// Skv masks, an optional tanh softcap on the scaled scores, online softmax in
// fp32 (m, l, acc), the denominator clamped at 1e-30.  Masked scores are
// -1e30 and weigh 0, so a row whose keys are all masked gives 0.
//
// What bounds it on this card: operations for the model path (bf16, causal,
// S = 4096: ~ 2000 flops per byte, above the ridge), so the tensor cores set
// the floor.  The TPU grid is (B, Hq, q blocks, kv blocks) with kv sequential
// and (m, l, acc) in VMEM; on Hopper one CTA walks its kv tiles in a loop.
// A CTA owns a block of rows (128 on the tensor cores, 64 at D = 256) of the
// flattened (position, head-in-group) index R = pos * G + g of one (b, kv
// head): in the model layout (B, S, H, D) the G heads of a group are
// adjacent, so every K/V tile a CTA loads serves all G query heads of the
// group at once.  kv tiles that are wholly masked (past
// the causal diagonal, outside the window, past Skv) are never loaded, as
// pl.when(live) skips them on the TPU; CTAs are issued longest first.
// Ragged Sq and Skv are masked here; D is never padded.  Two kernels, chosen
// by dtype and head size:
//
// * flash_mma (bfloat16, D in {64, 128, 256}, the model path): four warps
//   of 32 rows (two m16 tiles; 16 rows at D = 256, for registers), as
//   FlashAttention-2 lays out mma.sync: Q·Kᵀ and P·V on the tensor cores
//   (m16n8k16, fp32 accumulate), each K and V fragment feeding every m16
//   tile of the warp; scores in log2 units so each exponential is one ex2.approx,
//   and no per-element mask on a tile that is wholly live for a warp's rows.
//   K/V tiles of 32 keys are double-buffered in shared memory with cp.async,
//   rows padded by 16 bytes so that the ldmatrix fragment loads (transposed
//   for V) hit distinct banks.  Simple first: no wgmma or TMA yet.
// * flash_simt (float32, or D < 64): CUDA cores, fp32 throughout; one lane per
//   key for the scores, one lane per channel for P·V, 4 rows per warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Sq, Skv, Hkv, G;
  long long qsb, qsh, qss;  // q and out strides (batch, head, position)
  long long ksb, ksh, kss;  // k and v strides
  int causal, window;       // window <= 0: none
  float scale, softcap;     // softcap <= 0: none
};

// Key range [lo, hi) that rows of positions [pos_lo, pos_hi] may see.
__device__ __forceinline__ void key_range(const Params& p, int pos_lo, int pos_hi, int& lo,
                                          int& hi) {
  hi = p.causal ? min(p.Skv, pos_hi + 1) : p.Skv;
  lo = p.window > 0 ? max(0, pos_lo - p.window + 1) : 0;
}

__device__ __forceinline__ bool key_live(const Params& p, int pos, int key) {
  return key < p.Skv && (!p.causal || key <= pos) && (p.window <= 0 || key > pos - p.window);
}

// 2^x on the special-function unit (ex2.approx: ~2 ulp, subnormal results
// flush to 0), for every element of the softmax; the precise exp2f is a
// longer sequence.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh softcap, out of line: inlined, the precise tanhf doubled the body of
// the unrolled score loop, and the loop's code size set the kernel's pace
// even where no cap is used.
__device__ __noinline__ float capped(float x, float cap) { return tanhf(x / cap) * cap; }

// Score in log2 units after scale and softcap.
__device__ __forceinline__ float logit2(const Params& p, float s) {
  float x = s * p.scale;
  if (p.softcap > 0.f) x = capped(x, p.softcap);
  return x * kLog2e;
}

// ---------------------------------------------------------------------------
// tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaKeys = 32;              // keys per kv tile
constexpr int kMmaNT = kMmaKeys / 8;      // n-tiles of S per tile

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16-byte asynchronous copy; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// bf16 per shared row: 16 bytes of padding keep fragment loads conflict-free.
template <int D>
__host__ __device__ constexpr int mma_stride() { return D + 8; }

// m16 row tiles per warp: two where their accumulators fit in registers.
template <int D>
__host__ __device__ constexpr int mma_mtiles() { return D <= 128 ? 2 : 1; }

template <int D>
__host__ __device__ constexpr int mma_rows() { return kMmaWarps * 16 * mma_mtiles<D>(); }

template <int D>
constexpr size_t mma_smem_bytes() {
  return (size_t)(mma_rows<D>() + 4 * kMmaKeys) * mma_stride<D>() * sizeof(__nv_bfloat16);
}

// grid (ceil(Sq * G / mma_rows<D>()), B * Hkv), kMmaWarps * 32 threads.
template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32) flash_mma(const Params p) {
  constexpr int MT = mma_mtiles<D>();
  constexpr int ROWS = mma_rows<D>();
  constexpr int LD = mma_stride<D>();
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int NB = 4;       // V fragments in flight
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  __nv_bfloat16* Qs = sm;                            // [ROWS][LD]
  __nv_bfloat16* Ks = Qs + ROWS * LD;                // [2][kMmaKeys][LD]
  __nv_bfloat16* Vs = Ks + 2 * kMmaKeys * LD;        // [2][kMmaKeys][LD]

  const int n_rows = p.Sq * p.G;
  const int R0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / p.Hkv, h = bh % p.Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int w0 = warp * 16 * MT;  // first row of this warp in the CTA

  const auto* q = static_cast<const __nv_bfloat16*>(p.q);
  const auto* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.ksb + h * p.ksh;
  const auto* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.ksb + h * p.ksh;

  // Q rows into shared memory (absent rows are zero).
  for (int e = tid; e < ROWS * CH; e += kMmaWarps * 32) {
    const int r = e / CH, c = e % CH;
    const int R = R0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (R < n_rows) {
      const int pos = R / p.G, g = R % p.G;
      val = *reinterpret_cast<const uint4*>(q + b * p.qsb + (long long)(h * p.G + g) * p.qsh +
                                            pos * p.qss + c * 8);
    }
    *reinterpret_cast<uint4*>(Qs + r * LD + c * 8) = val;
  }

  int k_lo, k_hi;  // R0 < n_rows: the grid holds no empty CTA
  key_range(p, R0 / p.G, (min(R0 + ROWS, n_rows) - 1) / p.G, k_lo, k_hi);
  const int t_lo = k_lo / kMmaKeys;
  const int t_hi = k_hi > k_lo ? (k_hi + kMmaKeys - 1) / kMmaKeys : t_lo;

  auto load_kv = [&](int stage, int tile) {
    __nv_bfloat16* kd = Ks + stage * kMmaKeys * LD;
    __nv_bfloat16* vd = Vs + stage * kMmaKeys * LD;
    for (int e = tid; e < kMmaKeys * CH; e += kMmaWarps * 32) {
      const int r = e / CH, c = e % CH;
      const int key = tile * kMmaKeys + r;
      const bool ok = key < p.Skv;
      const long long off = ok ? key * p.kss + c * 8 : 0;
      cp_async16(kd + r * LD + c * 8, kg + off, ok ? 16 : 0);
      cp_async16(vd + r * LD + c * 8, vg + off, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  // Rows of this lane: w0 + 16 * mt + gid + 8 * hr.
  int pos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) pos[mt][hr] = (R0 + w0 + 16 * mt + gid + 8 * hr) / p.G;

  float o[MT][D / 8][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      o[mt][nt][0] = o[mt][nt][1] = o[mt][nt][2] = o[mt][nt][3] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }

  // ldmatrix row addresses of this lane: Q as A fragments (rows gid, gid + 8;
  // k 0-7, 8-15), K as B fragments of two n-tiles (keys; k 0-7, 8-15), V
  // transposed as B fragments of two n-tiles (keys as k; channels).
  const int q_row = w0 + lane % 8 + 8 * ((lane / 8) % 2), q_col = 8 * (lane / 16);
  const int k_row = lane % 8 + 8 * (lane / 16), k_col = 8 * ((lane / 8) % 2);
  const int v_row = lane % 8 + 8 * ((lane / 8) % 2), v_col = 8 * (lane / 16);
  // Positions of this warp's rows, for the test of a wholly live tile.
  const int w_lo = (R0 + w0) / p.G, w_hi = (R0 + w0 + 16 * MT - 1) / p.G;
  if (t_lo < t_hi) load_kv(0, t_lo);
  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t + 1 < t_hi) {
      load_kv(stage ^ 1, t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = Ks + stage * kMmaKeys * LD;
    const __nv_bfloat16* vt = Vs + stage * kMmaKeys * LD;

    // S = Q Kᵀ: MT m16 tiles x kMmaKeys keys per warp.  Each step issues its
    // fragment loads before its products (the asm statements keep their
    // source order), and each K fragment feeds MT products.
    float s[MT][kMmaNT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kMmaNT; ++nt)
        s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[MT][4], bk[kMmaNT / 2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], Qs + (q_row + 16 * mt) * LD + ks * 16 + q_col);
#pragma unroll
      for (int np = 0; np < kMmaNT / 2; ++np)
        ldmatrix_x4(bk[np], kt + (np * 16 + k_row) * LD + ks * 16 + k_col);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int np = 0; np < kMmaNT / 2; ++np) {
          mma_bf16(s[mt][2 * np], a[mt][0], a[mt][1], a[mt][2], a[mt][3], bk[np][0], bk[np][1]);
          mma_bf16(s[mt][2 * np + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], bk[np][2],
                   bk[np][3]);
        }
    }
    // Scale, cap, mask (a masked score is exactly kNegInf, which no live
    // score reaches); online softmax per row (4 lanes share a row).
    const int k_last = t * kMmaKeys + kMmaKeys - 1;
    const bool full = k_last < p.Skv && (!p.causal || k_last <= w_lo) &&
                      (p.window <= 0 || t * kMmaKeys > w_hi - p.window);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kMmaNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t * kMmaKeys + nt * 8 + 2 * tig + (e % 2);
          s[mt][nt][e] = full || key_live(p, pos[mt][e / 2], key) ? logit2(p, s[mt][nt][e])
                                                                  : kNegInf;
        }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = m[mt][hr];
#pragma unroll
        for (int nt = 0; nt < kMmaNT; ++nt)
          mx = fmaxf(mx, fmaxf(s[mt][nt][2 * hr], s[mt][nt][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float alpha = fast_exp2(m[mt][hr] - mx);
        m[mt][hr] = mx;
        l[mt][hr] *= alpha;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          o[mt][nt][2 * hr] *= alpha;
          o[mt][nt][2 * hr + 1] *= alpha;
        }
#pragma unroll
        for (int nt = 0; nt < kMmaNT; ++nt) {
#pragma unroll
          for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
            s[mt][nt][e] = s[mt][nt][e] > kNegInf ? fast_exp2(s[mt][nt][e] - mx) : 0.f;
            l[mt][hr] += s[mt][nt][e];
          }
        }
      }
    }
    // O += P V: P from the S accumulators as bf16 A fragments, 16 keys a
    // step; each V fragment feeds MT products.
#pragma unroll
    for (int kk = 0; kk < kMmaNT / 2; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dn0 = 0; dn0 < D / 16; dn0 += NB) {
        uint32_t bv[NB][4];
#pragma unroll
        for (int u = 0; u < NB; ++u)
          ldmatrix_x4_trans(bv[u], vt + (kk * 16 + v_row) * LD + (dn0 + u) * 16 + v_col);
#pragma unroll
        for (int u = 0; u < NB; ++u)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][2 * (dn0 + u)], pa[mt][0], pa[mt][1], pa[mt][2], pa[mt][3], bv[u][0],
                     bv[u][1]);
            mma_bf16(o[mt][2 * (dn0 + u) + 1], pa[mt][0], pa[mt][1], pa[mt][2], pa[mt][3],
                     bv[u][2], bv[u][3]);
          }
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  auto* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float lt = l[mt][hr];
      lt += __shfl_xor_sync(kFull, lt, 1);
      lt += __shfl_xor_sync(kFull, lt, 2);
      const int R = R0 + w0 + 16 * mt + gid + 8 * hr;
      if (R >= n_rows) continue;
      const int g = R % p.G;
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      uint32_t* orow = reinterpret_cast<uint32_t*>(
          out + b * p.qsb + (long long)(h * p.G + g) * p.qsh + pos[mt][hr] * p.qss);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        orow[nt * 4 + tig] = pack_bf16(o[mt][nt][2 * hr] * inv, o[mt][nt][2 * hr + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kSimtWarps = 4;
constexpr int kSimtRowsPerWarp = 4;
constexpr int kSimtRows = kSimtWarps * kSimtRowsPerWarp;  // rows per CTA
constexpr int kSimtKeys = 32;                             // keys per kv tile (one per lane)

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

template <int D>
constexpr size_t simt_smem_bytes() {
  return ((size_t)kSimtRows * D + kSimtKeys * (D + 1) + kSimtKeys * D) * sizeof(float);
}

// grid (ceil(Sq * G / kSimtRows), B * Hkv), kSimtWarps * 32 threads.
template <typename T, int D>
__global__ void __launch_bounds__(kSimtWarps * 32) flash_simt(const Params p) {
  constexpr int DPL = (D + 31) / 32;  // channels per lane
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                          // [kSimtRows][D]
  float* Ks = Qs + kSimtRows * D;           // [kSimtKeys][D + 1]
  float* Vs = Ks + kSimtKeys * (D + 1);     // [kSimtKeys][D]

  const int n_rows = p.Sq * p.G;
  const int R0 = (gridDim.x - 1 - blockIdx.x) * kSimtRows;
  const int bh = blockIdx.y;
  const int b = bh / p.Hkv, h = bh % p.Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const auto* q = static_cast<const T*>(p.q);
  const T* kg = static_cast<const T*>(p.k) + b * p.ksb + h * p.ksh;
  const T* vg = static_cast<const T*>(p.v) + b * p.ksb + h * p.ksh;

  for (int e = tid; e < kSimtRows * D; e += kSimtWarps * 32) {
    const int r = e / D, d = e % D;
    const int R = R0 + r;
    float val = 0.f;
    if (R < n_rows) {
      const int pos = R / p.G, g = R % p.G;
      val = to_float(q[b * p.qsb + (long long)(h * p.G + g) * p.qsh + pos * p.qss + d]);
    }
    Qs[e] = val;
  }
  int k_lo, k_hi;
  key_range(p, R0 / p.G, (min(R0 + kSimtRows, n_rows) - 1) / p.G, k_lo, k_hi);

  int pos[kSimtRowsPerWarp];
  float m[kSimtRowsPerWarp], l[kSimtRowsPerWarp], acc[kSimtRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kSimtRowsPerWarp; ++r) {
    pos[r] = (R0 + warp * kSimtRowsPerWarp + r) / p.G;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = (k_lo / kSimtKeys) * kSimtKeys; k0 < k_hi; k0 += kSimtKeys) {
    __syncthreads();  // the previous tile's readers are done (and Qs is written)
    for (int e = tid; e < kSimtKeys * D; e += kSimtWarps * 32) {
      const int j = e / D, d = e % D;
      const int key = k0 + j;
      const bool ok = key < p.Skv;
      Ks[j * (D + 1) + d] = ok ? to_float(kg[key * p.kss + d]) : 0.f;
      Vs[j * D + d] = ok ? to_float(vg[key * p.kss + d]) : 0.f;
    }
    __syncthreads();
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kSimtRowsPerWarp; ++r) {
      const float* qr = Qs + (warp * kSimtRowsPerWarp + r) * D;
      float sc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) sc += qr[d] * Ks[lane * (D + 1) + d];
      const bool live = key_live(p, pos[r], key);
      const float x = live ? logit2(p, sc) : kNegInf;
      float mt = x;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
      mt = fmaxf(mt, m[r]);
      const float alpha = fast_exp2(m[r] - mt);
      m[r] = mt;
      const float pr = live ? fast_exp2(x - mt) : 0.f;
      float ps = pr;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) ps += __shfl_xor_sync(kFull, ps, off);
      l[r] = l[r] * alpha + ps;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      for (int j = 0; j < kSimtKeys; ++j) {
        const float pj = __shfl_sync(kFull, pr, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[r][i] += pj * Vs[j * D + d];
        }
      }
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < kSimtRowsPerWarp; ++r) {
    const int R = R0 + warp * kSimtRowsPerWarp + r;
    if (R >= n_rows) continue;
    const int g = R % p.G;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = out + b * p.qsb + (long long)(h * p.G + g) * p.qsh + pos[r] * p.qss;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = from_float<T>(acc[r][i] * inv);
    }
  }
}

template <int D>
cudaError_t launch_mma(const Params& p, int B, cudaStream_t s) {
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(flash_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq * p.G + mma_rows<D>() - 1) / mma_rows<D>(), B * p.Hkv);
  flash_mma<D><<<grid, kMmaWarps * 32, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_simt(const Params& p, int B, cudaStream_t s) {
  const size_t smem = simt_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_simt<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq * p.G + kSimtRows - 1) / kSimtRows, B * p.Hkv);
  flash_simt<T, D><<<grid, kSimtWarps * 32, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_simt(const Params& p, int D, int B, cudaStream_t s) {
  switch (D) {
    case 16: return launch_simt<T, 16>(p, B, s);
    case 32: return launch_simt<T, 32>(p, B, s);
    case 64: return launch_simt<T, 64>(p, B, s);
    case 128: return launch_simt<T, 128>(p, B, s);
    case 256: return launch_simt<T, 256>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {16, 32, 64, 128, 256}.  q and out:
// (B, Hq = Hkv * G, Sq, D) views with element strides (qsb, qsh, qss, 1); k
// and v: (B, Hkv, Skv, D) views with strides (ksb, ksh, kss, 1).  bfloat16
// with D >= 64 takes the tensor-core kernel, which needs 16-byte aligned
// rows.  window <= 0 means no window, softcap <= 0 no cap.
extern "C" int flash_attention(int dtype, int D, const void* q, const void* k, const void* v,
                               void* out, int B, int Hkv, int G, int Sq, int Skv, long long qsb,
                               long long qsh, long long qss, long long ksb, long long ksh,
                               long long kss, int causal, int window, float scale, float softcap,
                               void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || Sq < 1 || Skv < 1 || B * Hkv > 65535)
    return cudaErrorInvalidValue;
  const Params p{q, k, v, out, Sq, Skv, Hkv, G, qsb, qsh, qss, ksb, ksh, kss,
                 causal, window, scale, softcap};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
      case 64: return launch_mma<64>(p, B, s);
      case 128: return launch_mma<128>(p, B, s);
      case 256: return launch_mma<256>(p, B, s);
      default: return dispatch_simt<__nv_bfloat16>(p, D, B, s);
    }
  }
  if (dtype == 0) return dispatch_simt<float>(p, D, B, s);
  return cudaErrorInvalidValue;
}
