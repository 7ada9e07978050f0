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
// the floor, and only wgmma reaches their full rate.  The TPU grid is (B, Hq,
// q blocks, kv blocks) with kv sequential and (m, l, acc) in VMEM; on Hopper
// one CTA walks its kv tiles in a loop.  A CTA owns 128 rows of the
// flattened (position, head-in-group) index R = pos * G + g of one (b, kv
// head): in the model layout (B, S, H, D) the G heads of a group are
// adjacent, so every K/V tile a CTA loads serves all G query heads of the
// group at once.  kv tiles that are wholly masked (past the causal diagonal,
// outside the window, past Skv) are never loaded, as pl.when(live) skips
// them on the TPU; CTAs are issued longest first.  Ragged Sq and Skv are
// masked here, and no tensor is ever padded: a head size between the tile
// widths (80, stablelm-3b's) runs the next instance (128), whose columns
// past D the TMA fills with zeros in K and V, the Q loads leave zero and
// the output stores skip.  Two kernels, chosen by dtype and head size (the
// wrapper names the path, `kernel_path` in ops.py):
//
// * flash_wgmma (bfloat16, D in {64, 80, 128, 256}, the model path), laid out as
//   FlashAttention-3: three warpgroups.  The producer warpgroup gives up its
//   registers (setmaxnreg) and one thread issues TMA loads of K and V tiles
//   (128 keys; 64 at D = 256) into a ring of 3 stages (2 at D = 256),
//   128-byte swizzled, each tile as D / 64 boxes of 64 columns, with full
//   and empty mbarriers.  Two
//   consumer warpgroups own 64 rows each: S = Q Kᵀ is wgmma with both
//   operands in shared memory (Q loaded once, by plain 16-byte loads into the
//   same swizzle, since a block of flattened rows is no TMA box when G does
//   not divide 128); O += P V is wgmma with P, rounded to bf16, in
//   registers as the A operand and V read MN-major.  The two consumers take
//   turns at the tensor cores for S (named barriers), so one group's
//   softmax runs under the other's products.  (Issuing S_i together with
//   P_{i-1} V_{i-1}, FlashAttention-3's overlap inside a group, spilled with
//   P in registers and was slower with P staged in shared memory.)
//   Causal, window and softcap are template flags; the per-element mask runs
//   only on tiles that cross the diagonal, the window edge or Skv, where a
//   masked score is -inf.  Scores are in log2 units and every exponential is
//   one ex2.approx; the softcap's tanh is 1 - 2 / (2^(2x log2 e) + 1), one
//   more ex2 and a division.  O is staged in shared memory (over this
//   group's Q rows) and written back in 16-byte stores.
// * flash_simt (float32, or D < 64): CUDA cores, fp32 throughout; one lane per
//   key for the scores, one lane per channel for P·V, 4 rows per warp.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kInf = __builtin_huge_valf();
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Sq, Skv, Hkv, G;
  int dq;                   // head size of q, k, v, out (<= the kernel's D)
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

// tanh(x) = 1 - 2 / (e^(2x) + 1): absolute error ~1e-7 (ex2.approx and a
// fast division), against 2^-11 relative for tanh.approx, which a cap of
// 50 would turn into a logit error of ~0.02.
__device__ __forceinline__ float fast_tanh(float x) {
  return 1.f - __fdividef(2.f, fast_exp2(2.f * kLog2e * x) + 1.f);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// wgmma kernel
// ---------------------------------------------------------------------------

constexpr int kRows = 128;            // flattened rows per CTA, 64 per consumer
constexpr int kWgThreads = 128;
// Two consumer warpgroups (warps 0-7), then the producer warpgroup, which
// hands its registers to the consumers (setmaxnreg): 384 threads launch at
// 168 registers each (three warps on each quarter of the SM's register
// file), and 128 * 24 + 256 * 240 = 384 * 168.
constexpr int kThreads = 3 * kWgThreads;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// Named barriers (0 is __syncthreads): 1 + w lets consumer w issue its
// products, 3 + w joins consumer w's own threads.
constexpr int kTurnBar = 1;
constexpr int kGroupBar = 3;

template <int D>
struct WgCfg {
  static constexpr int BN = D <= 128 ? 128 : 64;    // keys per tile
  // K/V ring depth: three tiles where they fit beside Q (D <= 128), two at
  // D = 256 (Q alone is 64 KB).
  static constexpr int STAGES = D <= 128 ? 3 : 2;
  static constexpr int NC = D / 64;                 // 64-column (128-byte) blocks
  static constexpr int Q_BLOCK = kRows * 128;       // bytes of one column block of Q
  static constexpr int KV_BLOCK = BN * 128;         // ... of K or V
  static constexpr int KV_TILE = NC * KV_BLOCK;     // one tile of K (or V)
  static constexpr int Q_BYTES = NC * Q_BLOCK;
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_TILE;
  // 1024 bytes of slack to align the swizzled tiles, then the barriers.
  static constexpr size_t SMEM = 1024 + BAR_OFF + 3 * STAGES * sizeof(uint64_t);
};

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile whose
// column blocks are `block` bytes apart.
__device__ __forceinline__ int swz(int r, int c, int block) {
  return (c / 8) * block + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

// Built with -DFLASH_TIMING (tools/flash_cta_timing.py), every CTA of the
// wgmma kernel below records its start and end (%globaltimer, ns), its
// number of kv tiles and its SM, for the first 8192 CTAs of a launch.
#ifdef FLASH_TIMING
__device__ unsigned long long g_timing[4 * 8192];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#endif

// grid (ceil(Sq * G / kRows), B * Hkv), kThreads threads.
template <int D, bool CAUSAL, bool WINDOW, bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma(const Params p, const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv) {
  using C = WgCfg<D>;
  constexpr int BN = C::BN;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // Swizzled tiles start on 1024 bytes; offsetting the shared array itself
  // (not a generic address) keeps every access a shared-memory one.
  uint8_t* sm = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = sm;                                   // [NC][kRows][128 B]
  uint8_t* Ks = Qs + C::Q_BYTES;                      // [STAGES][NC][BN][128 B]
  uint8_t* Vs = Ks + C::STAGES * C::KV_TILE;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* full_v = full_k + C::STAGES;
  uint64_t* empty = full_v + C::STAGES;

  const int n_rows = p.Sq * p.G;
  const int R0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest rows first
  const int b = blockIdx.y / p.Hkv, h = blockIdx.y % p.Hkv;
  int k_lo, k_hi;  // R0 < n_rows: the grid holds no empty CTA
  key_range(p, R0 / p.G, (min(R0 + kRows, n_rows) - 1) / p.G, k_lo, k_hi);
  const int t_lo = k_lo / BN;
  const int n_tiles = k_hi > k_lo ? (k_hi + BN - 1) / BN - t_lo : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::mbar_init(&full_k[s], 1);
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
#ifdef FLASH_TIMING
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0 && cta < 8192) {
    unsigned smid;
    asm volatile("mov.u32 %0, %smid;" : "=r"(smid));
    g_timing[4 * cta] = gtime();
    g_timing[4 * cta + 2] = n_tiles;
    g_timing[4 * cta + 3] = smid;
  }
#endif

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring of K and V tiles full.
    sm90::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 2 * kWgThreads) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::STAGES;
        sm90::mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
        const int key0 = (t_lo + i) * BN;
        sm90::mbar_arrive_expect_tx(&full_k[s], C::KV_TILE);
#pragma unroll
        for (int c = 0; c < C::NC; ++c)
          sm90::tma_load_4d(Ks + s * C::KV_TILE + c * C::KV_BLOCK, &tmk, &full_k[s], 64 * c,
                            key0, h, b);
        sm90::mbar_arrive_expect_tx(&full_v[s], C::KV_TILE);
#pragma unroll
        for (int c = 0; c < C::NC; ++c)
          sm90::tma_load_4d(Vs + s * C::KV_TILE + c * C::KV_BLOCK, &tmv, &full_v[s], 64 * c,
                            key0, h, b);
      }
    }
  } else {
    // ---- consumers: group w owns rows [64w, 64w + 64) of the CTA.
    sm90::reg_alloc<kConsumerRegs>();
    const int w = wg;
    const int tid = threadIdx.x - wg * kWgThreads;
    const int warp = tid / 32, lane = tid % 32;
    const auto* q = static_cast<const __nv_bfloat16*>(p.q);

    // Q rows into shared memory, swizzled as TMA would (absent rows zero).
    for (int e = tid; e < 64 * D / 8; e += kWgThreads) {
      const int r = 64 * w + e / (D / 8), c = e % (D / 8);
      const int R = R0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (R < n_rows && 8 * c < p.dq)
        val = *reinterpret_cast<const uint4*>(q + b * p.qsb +
                                              (long long)(h * p.G + R % p.G) * p.qsh +
                                              (long long)(R / p.G) * p.qss + c * 8);
      *reinterpret_cast<uint4*>(Qs + swz(r, c, C::Q_BLOCK)) = val;
    }
    sm90::fence_proxy_async();
    sm90::bar_sync(kGroupBar + w, kWgThreads);

    // Rows of this thread: 64w + 16 warp + lane / 4 (+ 8).
    const int row0 = 64 * w + 16 * warp + lane / 4;
    const int pos[2] = {(R0 + row0) / p.G, (R0 + row0 + 8) / p.G};
    const int w_lo = (R0 + 64 * w) / p.G, w_hi = (R0 + 64 * w + 63) / p.G;
    const float sl2 = CAP ? p.scale / p.softcap : p.scale * kLog2e;
    const float cl2 = p.softcap * kLog2e;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // Running max (log2 units; -inf until a live key) and sum of each row.
    float m[2] = {-kInf, -kInf}, l[2] = {0.f, 0.f};
    const float f = CAP ? 1.f : sl2;  // score -> log2 units, after the cap
    const uint8_t* q_w = Qs + 64 * w * 128;
    float sc[BN / 2];                 // S of the current tile, then its P
    float alpha[2];

    // Cap, and mask only where the tile crosses an edge of this group's rows
    // (a masked score is -inf and weighs 0); then the online softmax per row
    // (the 4 lanes of a quad share a row): P into sc, alpha for O.
    auto softmax = [&](int i) {
      const int key0 = (t_lo + i) * BN;
      const int k_last = key0 + BN - 1;
      const bool edge = k_last >= p.Skv || (CAUSAL && k_last > w_lo) ||
                        (WINDOW && key0 <= w_hi - p.window);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e];
          if (CAP) x = fast_tanh(x * sl2) * cl2;
          if (edge) {
            const int key = key0 + 8 * j + 2 * (lane % 4) + (e % 2);
            const int ps = pos[e / 2];
            const bool live = key < p.Skv && (!CAUSAL || key <= ps) &&
                              (!WINDOW || key > ps - p.window);
            x = live ? x : -kInf;
          }
          sc[4 * j + e] = x;
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        // four partial maxima and sums: short dependency chains
        float t4[4] = {-kInf, -kInf, -kInf, -kInf};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          t4[j % 4] = fmaxf(t4[j % 4], fmaxf(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1]));
        float t = fmaxf(fmaxf(t4[0], t4[1]), fmaxf(t4[2], t4[3]));
        t = fmaxf(t, __shfl_xor_sync(kFull, t, 1));
        t = fmaxf(t, __shfl_xor_sync(kFull, t, 2));
        const float mx = fmaxf(m[hr], t * f);
        const float base = mx == -kInf ? 0.f : mx;
        alpha[hr] = fast_exp2(m[hr] - base);
        m[hr] = mx;
        float ls[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
            sc[4 * j + e] = fast_exp2(fmaf(sc[4 * j + e], f, -base));
            ls[j % 4] += sc[4 * j + e];
          }
        l[hr] = l[hr] * alpha[hr] + ((ls[0] + ls[1]) + (ls[2] + ls[3]));
      }
    };

    // Each tile: one turn at the tensor cores for S_i = Q K_iᵀ (both
    // K-major: k step ks is 32 bytes into column block ks / 4); the group
    // computes P_i while the other group takes its turn, then O += P_i V_i
    // with P_i as the A operand in registers and V MN-major (k step kk is
    // 16 rows, 2048 bytes, down each column block).
    if (w == 1 && n_tiles > 0) sm90::bar_arrive(kTurnBar, 2 * kWgThreads);  // group 0 first
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % C::STAGES;
      const uint32_t ph = (i / C::STAGES) & 1;
      const uint8_t* kt = Ks + s * C::KV_TILE;
      const uint8_t* vt = Vs + s * C::KV_TILE;
      sm90::mbar_wait(&full_k[s], ph);
      sm90::bar_sync(kTurnBar + w, 2 * kWgThreads);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        sm90::wgmma_ss<BN>(
            sc, sm90::desc_sw128(q_w + (ks / 4) * C::Q_BLOCK + (ks % 4) * 32, 16, 1024),
            sm90::desc_sw128(kt + (ks / 4) * C::KV_BLOCK + (ks % 4) * 32, 16, 1024), ks > 0);
      sm90::wgmma_commit();
      if (!(w == 1 && i == n_tiles - 1)) sm90::bar_arrive(kTurnBar + 1 - w, 2 * kWgThreads);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(sc);
      softmax(i);
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      sm90::mbar_wait(&full_v[s], ph);
      sm90::fence_operands(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        sm90::wgmma_rs<D>(o, pa[kk], sm90::desc_sw128(vt + kk * 2048, C::KV_BLOCK, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(o);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }

    // O / l into this group's Q rows (no wgmma reads them any more), then
    // out in 16-byte stores.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float lt = l[hr];
      lt += __shfl_xor_sync(kFull, lt, 1);
      lt += __shfl_xor_sync(kFull, lt, 2);
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      const int r = row0 + 8 * hr;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(Qs + swz(r, j, C::Q_BLOCK) + 4 * (lane % 4)) =
            pack_bf16(o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
    }
    sm90::bar_sync(kGroupBar + w, kWgThreads);
    auto* out = static_cast<__nv_bfloat16*>(p.out);
    for (int e = tid; e < 64 * D / 8; e += kWgThreads) {
      const int r = 64 * w + e / (D / 8), c = e % (D / 8);
      const int R = R0 + r;
      if (R < n_rows && 8 * c < p.dq)
        *reinterpret_cast<uint4*>(out + b * p.qsb + (long long)(h * p.G + R % p.G) * p.qsh +
                                  (long long)(R / p.G) * p.qss + c * 8) =
            *reinterpret_cast<const uint4*>(Qs + swz(r, c, C::Q_BLOCK));
    }
#ifdef FLASH_TIMING
    if (threadIdx.x == 0 && cta < 8192) g_timing[4 * cta + 1] = gtime();
#endif
  }
}

// ---------------------------------------------------------------------------
// CUDA-core kernel
// ---------------------------------------------------------------------------

// tanh softcap of the CUDA-core kernel, out of line: inlined, the precise
// tanhf doubles the body of the score loop even where no cap is used.
__device__ __noinline__ float capped(float x, float cap) { return tanhf(x / cap) * cap; }

// Score in log2 units after scale and softcap.
__device__ __forceinline__ float logit2(const Params& p, float s) {
  float x = s * p.scale;
  if (p.softcap > 0.f) x = capped(x, p.softcap);
  return x * kLog2e;
}

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

// Tensor map of a (B, Hkv, Skv, D) bf16 view with element strides (sb, sh,
// ss, 1): boxes of 64 channels (128 bytes, 128-byte swizzle) by `rows` keys;
// keys past Skv, and channels past D where the kernel's tile is wider, read
// as zeros.
bool kv_map(CUtensorMap* map, const void* base, int B, int Hkv, int Skv, int D, long long sb,
            long long sh, long long ss, int rows) {
  return sm90::tile_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, {D, Skv, Hkv, B},
                       {ss, sh, sb}, {64, rows, 1, 1}, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D, bool CAUSAL, bool WINDOW, bool CAP>
cudaError_t launch_wgmma(const Params& p, int B, cudaStream_t s) {
  using C = WgCfg<D>;
  CUtensorMap tmk, tmv;
  if (!kv_map(&tmk, p.k, B, p.Hkv, p.Skv, p.dq, p.ksb, p.ksh, p.kss, C::BN) ||
      !kv_map(&tmv, p.v, B, p.Hkv, p.Skv, p.dq, p.ksb, p.ksh, p.kss, C::BN))
    return cudaErrorInvalidValue;
  const auto kernel = flash_wgmma<D, CAUSAL, WINDOW, CAP>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq * p.G + kRows - 1) / kRows, B * p.Hkv);
  kernel<<<grid, kThreads, C::SMEM, s>>>(p, tmk, tmv);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_wgmma(const Params& p, int B, cudaStream_t s) {
  const bool c = p.causal, w = p.window > 0, cap = p.softcap > 0.f;
  if (c && !w && !cap) return launch_wgmma<D, true, false, false>(p, B, s);
  if (c && !w && cap) return launch_wgmma<D, true, false, true>(p, B, s);
  if (c && w && !cap) return launch_wgmma<D, true, true, false>(p, B, s);
  if (c && w && cap) return launch_wgmma<D, true, true, true>(p, B, s);
  if (!c && !w && !cap) return launch_wgmma<D, false, false, false>(p, B, s);
  if (!c && !w && cap) return launch_wgmma<D, false, false, true>(p, B, s);
  if (!c && w && !cap) return launch_wgmma<D, false, true, false>(p, B, s);
  return launch_wgmma<D, false, true, true>(p, B, s);
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
    case 80: return launch_simt<T, 80>(p, B, s);
    case 128: return launch_simt<T, 128>(p, B, s);
    case 256: return launch_simt<T, 256>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// path: 0 = flash_simt (float32 or bfloat16, D in {16, 32, 64, 80, 128, 256}),
// 1 = flash_wgmma (bfloat16, D in {64, 80, 128, 256}); dtype: 0 = float32, 1 =
// bfloat16.  q and out: (B, Hq = Hkv * G, Sq, D) views with element strides
// (qsb, qsh, qss, 1); k and v: (B, Hkv, Skv, D) views with strides (ksb, ksh,
// kss, 1).  The wgmma path needs 16-byte aligned bases and strides.  window
// <= 0 means no window, softcap <= 0 no cap.
extern "C" int flash_attention(int path, int dtype, int D, const void* q, const void* k,
                               const void* v, void* out, int B, int Hkv, int G, int Sq, int Skv,
                               long long qsb, long long qsh, long long qss, long long ksb,
                               long long ksh, long long kss, int causal, int window,
                               float scale, float softcap, void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || Sq < 1 || Skv < 1 || B * Hkv > 65535)
    return cudaErrorInvalidValue;
  const Params p{q, k, v, out, Sq, Skv, Hkv, G, D, qsb, qsh, qss, ksb, ksh, kss,
                 causal, window, scale, softcap};
  const auto s = static_cast<cudaStream_t>(stream);
  if (path == 1 && dtype == 1) {
    switch (D) {
      case 64: return dispatch_wgmma<64>(p, B, s);
      case 80:  // the 128-column instance; columns 80..127 are zeros
      case 128: return dispatch_wgmma<128>(p, B, s);
      case 256: return dispatch_wgmma<256>(p, B, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (path == 0 && dtype == 1) return dispatch_simt<__nv_bfloat16>(p, D, B, s);
  if (path == 0 && dtype == 0) return dispatch_simt<float>(p, D, B, s);
  return cudaErrorInvalidValue;
}

#ifdef FLASH_TIMING
// Copies the CTA records of the last launch (4 * 8192 uint64) to `dst`.
extern "C" int flash_timing(void* dst) {
  return cudaMemcpyFromSymbol(dst, g_timing, sizeof(g_timing));
}
#endif
