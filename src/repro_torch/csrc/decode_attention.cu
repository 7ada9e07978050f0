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
// SMs idle.  So S is split across CTAs instead (flash-decoding): split s of
// n_split covers the 16-row stages [s * n_stages / n_split, (s + 1) * n_stages
// / n_split) of the cache, n_split chosen by the wrapper (`_plan` in ops.py)
// so that the grid fills whole waves of the SMs; decode_merge combines the
// splits' partial (m, l, acc), divides by max(l, 1e-30) and casts to the
// output dtype.  Rows past kv_len (read on the device, no host sync) are
// never read.  Two split kernels, chosen by dtype and head size (the wrapper
// names the path, `kernel_path` in ops.py):
//
// * decode_bulk (bfloat16, D in {64, 128, 256}, the model path): one CTA
//   per (batch row, split, group of HC kv heads; all Hkv where the stages
//   fit).  For one b a run of positions of all heads is one contiguous run
//   of bytes, so at D 64/128 one producer thread streams K and V with 1-D
//   bulk copies
//   (no tensor map; one copy per stage, or one per row when HC < Hkv) into
//   a ring of 16-row stages with full and empty mbarriers: with 4 stages of
//   32 KB at qwen2-7b, 128 KB per SM stays in flight whatever the consumers
//   do, and every cache row is fetched once, whole.  One consumer warp per
//   kv head runs Q·Kᵀ and P·V on the tensor cores (mma.sync m16n8k16, fp32
//   accumulate; 16 query heads as M) from shared memory, and writes its
//   split's partial for its head.  The softcap is a template flag.  At D
//   256 (recurrentgemma-9b's local attention, one kv head) one warp would
//   need 256 registers, so four warps share the head (BulkCfg): each
//   computes the whole score tile from its Q fragments and K read with
//   ldmatrix and owns 64 channels of P·V.  Rows lie 528 bytes apart, so the
//   ldmatrix reads meet no bank conflict, filled by the producer warp with
//   cp.async (K's rows, then V's), a row an instruction; 8 stages of 17 KB
//   make one CTA an SM, so the B 128 ring is one split and the kernel
//   writes the output without decode_merge.
// * decode_split (float32, or bfloat16 at D in {16, 32, 80}): CUDA
//   cores.  A lane owns one or two 16-byte slices of a cache row (RowLayout)
//   and keeps q and the accumulator for up to 8 heads in registers; the
//   lanes of a row, a power of two, reduce their dot products with shuffles.
//   A head size that is no power of two (80) leaves the lanes past its last
//   slice idle, so the cache is read as it lies, never padded.
//
// Scores are kept in log2 units (scaled by log2 e) so each exponential is one
// exp2f.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kWarps = 4;                // warps per CTA, decode_split
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;                 // heads per CTA, CUDA-core kernel
constexpr int kMmaG = 16;                // query heads per warp, tensor cores (M = 16)
constexpr int kUnroll = 4;               // row groups a warp loads per step
constexpr int kStageRows = 16;           // cache rows per stage (ops.STAGE_ROWS)
constexpr int kBulkStages = 4;           // ring depth of decode_bulk at D 64/128 (ops.BULK_STAGES)
constexpr int kWideStages = 8;           // ... at D 256: 135 KB, one CTA an SM
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// Cache rows [lo, hi) of split `split` of n_split over n_stages stages.
__device__ __forceinline__ void split_rows(int split, int n_split, int n_stages, int& lo,
                                           int& hi) {
  lo = (int)((long long)split * n_stages / n_split) * kStageRows;
  hi = (int)((long long)(split + 1) * n_stages / n_split) * kStageRows;
}

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

// ldmatrix: four 8 x 8 matrices of 16-bit values from shared memory; lanes
// 8i..8i+7 give the addresses of the 8 rows (16 bytes each) of matrix i,
// and r[i] receives this lane's pair of matrix i: row lane / 4, columns
// 2 (lane % 4) and +1, or with .trans column lane / 4, rows 2 (lane % 4)
// and +1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_addr(p))
               : "memory");
}

// Shape of decode_bulk<D>.  At D 64/128 one consumer warp takes a kv head
// and its rows lie in shared memory as the bulk copy leaves them.  At D 256
// one warp's whole-head Q, accumulator and K fragments would take 256
// registers, so W = 4 warps share a head, each owning 64 output channels
// (a 32-register accumulator) and each computing the whole score tile
// from its Q fragments (64 registers) and K read with ldmatrix.  Rows lie
// 528 bytes apart, so that the 8 rows of an ldmatrix fall in 8 different
// 16-byte bank groups.  A 1-D bulk copy cannot pad, and a bulk copy per
// row bounded the ring (32 copies a stage), so the producer warp fills
// the rows with cp.async, 16 bytes a lane and a row an instruction.  A CTA
// takes one kv head and a ring of 8 stages (135 KB, one CTA an SM): the
// B 128 ring is then one split, and the kernel writes the output itself.
template <int D>
struct BulkCfg {
  static constexpr bool WIDE = D == 256;
  static constexpr int W = WIDE ? 4 : 1;                  // consumer warps a kv head
  static constexpr int PAD = WIDE ? 16 : 0;               // bytes after each row
  static constexpr int THREADS = WIDE ? 32 * 5 : 32 * 9;  // most threads a CTA has
  static constexpr int STAGES = WIDE ? kWideStages : kBulkStages;  // ring depth
  static constexpr int MAX_HC = WIDE ? 1 : 8;             // kv heads a CTA
};

// Dynamic shared memory of decode_bulk<D> at HC kv heads a CTA: the K/V
// ring, then the full and empty barriers.
template <int D>
constexpr size_t bulk_smem(int HC) {
  using C = BulkCfg<D>;
  return (size_t)C::STAGES * 2 * kStageRows * (HC * D * 2 + C::PAD) +
         2 * C::STAGES * sizeof(uint64_t);
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

// Smallest power of two >= n (n >= 1).
constexpr int pow2_ceil(int n) { return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2); }

// How decode_split lays a cache row of D channels of T over a warp.  A row
// is NVEC 16-byte slices; a lane owns NV of them (slices li, li + LPR, ...
// of its row, li its lane in the row), so that LPR, the lanes of a row, is
// a power of two (the shuffle reductions need one) that the warp divides
// into RPW rows.  Where NVEC is no power of two, the slices past NVEC are
// absent: D = 80 in bf16 is 10 slices on 16 lanes, two rows a warp; in
// fp32 20 slices on 32 lanes.  Wider rows take two slices a lane (fp32 at
// D = 256: 64 slices), so that no lane holds more than 8 channels per head.
template <typename T, int D>
struct RowLayout {
  static constexpr int VEC = 16 / sizeof(T);               // channels per slice
  static constexpr int NVEC = D / VEC;                     // slices per row
  static constexpr int NV = (NVEC + 31) / 32;              // slices per lane
  static constexpr int LPR = pow2_ceil((NVEC + NV - 1) / NV);  // lanes per row
  static constexpr int RPW = 32 / LPR;                     // rows per warp load
  static constexpr int CPL = NV * VEC;                     // channels per lane
  static constexpr int UNROLL = kUnroll / NV;              // warp loads per step
  static_assert(D % VEC == 0 && LPR * NV >= NVEC && LPR <= 32, "row layout");
};

// q: (B, Hkv, G, D); k, v: (B, S, Hkv, D).  blockIdx.x = (b * Hkv + h) * n_gc
// + head chunk, blockIdx.y = split; the CTA covers the cache rows of its
// split (split_rows) below kv_len for heads [gc * HG, gc * HG + Gc): HG = 1
// for MHA (G = 1), else kMaxG, so that a lone head does not pay for eight.
// Partials are indexed by ((b * Hkv + h) * n_split + split) * G + head.
template <typename T, int D, int HG>
__global__ void __launch_bounds__(kThreads, 2)
    decode_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int32_t* __restrict__ kv_len, float* __restrict__ m_part,
                 float* __restrict__ l_part, float* __restrict__ acc_part, int S, int Hkv,
                 int G, int n_gc, int n_stages, float scale, float softcap) {
  using L = RowLayout<T, D>;
  constexpr int VEC = L::VEC, NV = L::NV, LPR = L::LPR, RPW = L::RPW, CPL = L::CPL;
  constexpr int UNR = L::UNROLL;
  constexpr int STEP = RPW * UNR;        // rows per warp per step
  __shared__ float sm_acc[kWarps][HG][D];
  __shared__ float sm_m[kWarps][HG];
  __shared__ float sm_l[kWarps][HG];

  const int bh = blockIdx.x / n_gc;
  const int g0 = (blockIdx.x % n_gc) * HG;
  const int Gc = min(HG, G - g0);
  const int split = blockIdx.y;
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int len = max(0, min(kv_len[0], S));
  int start, end;
  split_rows(split, gridDim.y, n_stages, start, end);
  end = min(end, len);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPR;            // which row of a warp load
  const int li = lane % LPR;             // this lane's place in its row
  bool own[NV];                          // slice li + j * LPR exists
#pragma unroll
  for (int j = 0; j < NV; ++j) own[j] = li + j * LPR < L::NVEC;

  float qr[HG][CPL], acc[HG][CPL], m[HG], l[HG];
#pragma unroll
  for (int g = 0; g < HG; ++g) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float t[VEC];
      if (g < Gc && own[j]) {
        unpack(*reinterpret_cast<const uint4*>(q + ((size_t)bh * G + g0 + g) * D +
                                               (li + j * LPR) * VEC),
               t, T());
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) t[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        qr[g][j * VEC + e] = t[e] * scale;
        acc[g][j * VEC + e] = 0.f;
      }
    }
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const size_t row_stride = (size_t)Hkv * D;
  const T* kb = k + ((size_t)b * S * Hkv + h) * D + li * VEC;
  const T* vb = v + ((size_t)b * S * Hkv + h) * D + li * VEC;

  for (int base = start + warp * STEP; base < end; base += kWarps * STEP) {
    uint4 kr[UNR][NV], vr[UNR][NV];
    bool live[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int row = base + u * RPW + sub;
      live[u] = row < end;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (live[u] && own[j]) {
          const size_t off = row * row_stride + j * LPR * VEC;
          kr[u][j] = __ldcs(reinterpret_cast<const uint4*>(kb + off));
          vr[u][j] = __ldcs(reinterpret_cast<const uint4*>(vb + off));
        } else {
          kr[u][j] = vr[u][j] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    // Scores: partial dot products over this lane's channels, then summed
    // across the LPR lanes of the row.
    float s[UNR][HG];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      float kf[CPL];
#pragma unroll
      for (int j = 0; j < NV; ++j) unpack(kr[u][j], kf + j * VEC, T());
#pragma unroll
      for (int g = 0; g < HG; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < CPL; ++e) d += qr[g][e] * kf[e];
        s[u][g] = d;
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off /= 2) {
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
#pragma unroll
        for (int g = 0; g < HG; ++g) s[u][g] += __shfl_xor_sync(kFull, s[u][g], off);
      }
    }
    // Online softmax over this step's rows: rescale once, then accumulate.
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      float mt = m[g];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
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
      for (int e = 0; e < CPL; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      float vf[CPL];
#pragma unroll
      for (int j = 0; j < NV; ++j) unpack(vr[u][j], vf + j * VEC, T());
#pragma unroll
      for (int g = 0; g < HG; ++g) {
        const float p = live[u] ? exp2f(s[u][g] - m[g]) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < CPL; ++e) acc[g][e] += p * vf[e];
      }
    }
  }

  // Merge the RPW row groups of the warp (each ran its own online softmax).
#pragma unroll
  for (int off = LPR; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = exp2f(m[g] - mn);
      const float ao = exp2f(mo - mn);
      l[g] = l[g] * a + lo * ao;
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        const float x = __shfl_xor_sync(kFull, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + x * ao;
      }
      m[g] = mn;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < HG; ++g) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (!own[j]) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          sm_acc[warp][g][(li + j * LPR) * VEC + e] = acc[g][j * VEC + e];
      }
      if (li == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  write_partial<HG, D>(sm_acc, sm_m, sm_l, Gc,
                          ((size_t)bh * gridDim.y + split) * G + g0, m_part, l_part,
                          acc_part);
}

// tanh(x) = 1 - 2 / (e^(2x) + 1), absolute error ~1e-7.
__device__ __forceinline__ float fast_tanh(float x) {
  return 1.f - __fdividef(2.f, exp2f(2.f * kLog2e * x) + 1.f);
}

// Bulk-copy kernel: bfloat16, D in {64, 128}.  grid (n_split, B, n_hc * n_gc),
// HC + 1 warps: warps 0..HC-1 consume kv heads h0 + warp, warp HC produces.
// Stage s of the ring holds K then V of kStageRows cache rows, each row the
// HC heads' D channels (HC * D * 2 bytes).  mma.sync m16n8k16 fragments (PTX
// ISA): lane = 4 * gid + tig; A (16 x 16): a0 (row gid, k 2tig..+1), a1 (row
// gid+8), a2 (row gid, k 2tig+8..+9), a3; B (16 x 8): b0 (k 2tig..+1, col
// gid), b1 (k 2tig+8..+9, col gid); C (16 x 8): c0, c1 (row gid, col 2tig,
// 2tig+1), c2, c3 (row gid+8).  S = Q Kᵀ takes heads as rows, a stage's 16
// rows as two 8-column tiles and channels as k, mapped so that lane (gid,
// tig) reads K row gid of each tile at channels [32i + 8tig, +8): the words
// it reads are b0 and b1 as they stand.  O += P V takes those 16 rows as k,
// so lane (gid, tig) reads V rows 2tig, 2tig+1, 8+2tig, 9+2tig at channels
// [64j + 8gid, +8), and output channel 64j + 8n + c of n-tile 8j + c is
// column n.
//
// At D 256 (BulkCfg::WIDE) warps 0..3 consume kv head h0, warp 4 produces
// into rows srow = 528 bytes apart.  Lane (gid, tig) holds Q as A fragments
// at channels 16 ks + 2 tig (+1, +8, +9) and reads with ldmatrix: K row 8
// (i / 2) + lane % 8 at the k step's column half i % 2, i = lane / 8 (b0,
// b1 of both 8-row tiles); V, transposed, row 8 (i % 2) + lane % 8 at
// channels 64 cw + 16 j + 8 (i / 2) (b0, b1 of n tiles 2j, 2j + 1 of warp
// cw's 64 channels).  Channels keep their order: output channel 64 cw + 8
// nt + c is column c of n tile nt.  A grid of one split writes the output
// itself (out, divided by l, in bf16); else the split's partial.
template <int D, bool CAP>
__global__ void __launch_bounds__(BulkCfg<D>::THREADS, 1)
    decode_bulk(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ kv_len,
                float* __restrict__ m_part, float* __restrict__ l_part,
                float* __restrict__ acc_part, __nv_bfloat16* __restrict__ out, int S, int Hkv,
                int G, int HC, int n_gc, int n_stages, float scale, float softcap) {
  using C = BulkCfg<D>;
  constexpr int KL = D / 32;             // 16-byte K reads per lane per tile
  constexpr int VL = D / 64;             // 16-byte V reads per lane per row
  constexpr int KS = D / 16;             // k steps of Q Kᵀ
  constexpr int NT = D / 8 / C::W;       // n tiles of P V per warp
  extern __shared__ __align__(128) uint8_t smem[];
  const int row_bytes = HC * D * 2;          // a cache row of the HC heads
  const int srow = row_bytes + C::PAD;       // ... as it lies in shared memory
  const int stage_bytes = kStageRows * srow;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * 2 * stage_bytes);
  uint64_t* empty = full + C::STAGES;

  const int split = blockIdx.x, n_split = gridDim.x, b = blockIdx.y;
  const int h0 = (blockIdx.z / n_gc) * HC;
  const int g0 = (blockIdx.z % n_gc) * kMmaG;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = max(0, min(kv_len[0], S));
  int start, end;
  split_rows(split, n_split, n_stages, start, end);
  end = min(end, len);
  const int n = end > start ? (end - start + kStageRows - 1) / kStageRows : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::mbar_init(&full[s], C::WIDE ? 32 : 1);  // D 256: every producer lane
      sm90::mbar_init(&empty[s], C::W * HC);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == C::W * HC) {
    // ---- producer warp: streams the split's rows, stage by stage.  D 64 /
    // 128: lane 0 waits for the slot, arms its barrier and issues one bulk
    // copy per stage (or per row when HC < Hkv).  D 256: after lane 0's
    // wait, lane j copies bytes [16 j, 16 j + 16) of each row (cp.async),
    // and every lane's copies arrive on the stage's barrier when they land.
    for (int i = 0; i < n; ++i) {
      const int s = i % C::STAGES;
      const int row0 = start + i * kStageRows;
      const int rows = min(kStageRows, end - row0);
      uint8_t* kd = smem + s * 2 * stage_bytes;
      uint8_t* vd = kd + stage_bytes;
      const size_t off = ((size_t)(b * S + row0) * Hkv + h0) * D;
      if (lane == 0) sm90::mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
      __syncwarp();
      if constexpr (C::WIDE) {
        // K's rows, then V's: with a row of K and a row of V asked for in
        // turn, the time depended on where V lay from K in memory
        for (int r = 0; r < rows; ++r)
          sm90::cp_async16(kd + r * srow + 16 * lane, k + off + (size_t)r * Hkv * D + 8 * lane);
        for (int r = 0; r < rows; ++r)
          sm90::cp_async16(vd + r * srow + 16 * lane, v + off + (size_t)r * Hkv * D + 8 * lane);
        sm90::cp_async_mbar_arrive(&full[s]);
      } else if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&full[s], 2 * rows * row_bytes);
        if (HC == Hkv) {
          sm90::bulk_load(kd, k + off, rows * row_bytes, &full[s]);
          sm90::bulk_load(vd, v + off, rows * row_bytes, &full[s]);
        } else {
          for (int r = 0; r < rows; ++r) {
            sm90::bulk_load(kd + r * row_bytes, k + off + (size_t)r * Hkv * D, row_bytes,
                            &full[s]);
            sm90::bulk_load(vd + r * row_bytes, v + off + (size_t)r * Hkv * D, row_bytes,
                            &full[s]);
          }
        }
      }
    }
    return;
  }

  if constexpr (C::WIDE) {
    // ---- consumer warp cw of kv head h0: the whole score tile, and P V
    // for output channels [64 cw, 64 cw + 64).  The four warps run the
    // same products in the same order on the same data, so their scores,
    // m and l agree bit for bit.
    const int cw = warp;
    const int Gc = min(kMmaG, G - g0);
    const int gid = lane / 4, tig = lane % 4;
    const int i8 = lane / 8, r8 = lane % 8;
    const size_t bh = (size_t)b * Hkv + h0;
    // Q as A fragments (heads gid and gid + 8; absent heads are zero rows).
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q + (bh * G + g0) * D);
    uint32_t qa[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int w = 8 * ks + tig;
      qa[ks][0] = gid < Gc ? q32[gid * (D / 2) + w] : 0u;
      qa[ks][2] = gid < Gc ? q32[gid * (D / 2) + w + 4] : 0u;
      qa[ks][1] = gid + 8 < Gc ? q32[(gid + 8) * (D / 2) + w] : 0u;
      qa[ks][3] = gid + 8 < Gc ? q32[(gid + 8) * (D / 2) + w + 4] : 0u;
    }
    const int k_row = 8 * (i8 / 2) + r8, k_col = 16 * (i8 % 2);
    const int v_row = 8 * (i8 % 2) + r8, v_col = 128 * cw + 16 * (i8 / 2);
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    for (int i = 0; i < n; ++i) {
      const int s = i % C::STAGES;
      const int live = min(kStageRows, end - start - i * kStageRows);  // >= 1
      const uint8_t* kt = smem + s * 2 * stage_bytes;
      const uint8_t* vt = kt + stage_bytes;
      sm90::mbar_wait(&full[s], (i / C::STAGES) & 1);
      // Rows past `live` were not copied this round: read row live - 1 in
      // their place (finite; their scores are masked and their P is 0).
      const uint8_t* k_lane = kt + min(k_row, live - 1) * srow + k_col;
      // Even and odd k steps accumulate apart: four independent chains of
      // products, summed once.
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float so[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kb = 0; kb < KS; kb += 4) {
        uint32_t kf[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) ldsm_x4(kf[j], k_lane + 32 * (kb + j));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_bf16(j % 2 ? so[0] : sc[0], qa[kb + j], kf[j][0], kf[j][1]);
          mma_bf16(j % 2 ? so[1] : sc[1], qa[kb + j], kf[j][2], kf[j][3]);
        }
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[t][e] += so[t][e];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[t][e] * scale;
          if (CAP) x = fast_tanh(x / softcap) * softcap;
          sc[t][e] = 8 * t + 2 * tig + e % 2 < live ? x * kLog2e : kNegInf;
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mt = fmaxf(fmaxf(sc[0][2 * hr], sc[0][2 * hr + 1]),
                         fmaxf(sc[1][2 * hr], sc[1][2 * hr + 1]));
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
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
            sc[t][e] = exp2f(sc[t][e] - mn);
            l[hr] += sc[t][e];
          }
      }
      uint32_t vf[NT / 2][4];
      const uint8_t* v_lane = vt + min(v_row, live - 1) * srow + v_col;
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) ldsm_x4_trans(vf[j], v_lane + 32 * j);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);  // the stage is in registers
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                              pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        mma_bf16(acc[2 * j], pa, vf[j][0], vf[j][1]);
        mma_bf16(acc[2 * j + 1], pa, vf[j][2], vf[j][3]);
      }
    }

    const size_t part = (bh * n_split + split) * G + g0;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(kFull, l[hr], 1);
      l[hr] += __shfl_xor_sync(kFull, l[hr], 2);
      const int g = gid + 8 * hr;
      if (g >= Gc) continue;
      if (n_split == 1) {  // decode_merge's arithmetic for one split
        const float inv = 1.f / fmaxf(l[hr], 1e-30f);
        __nv_bfloat16* o = out + (bh * G + g0 + g) * D + 64 * cw + 2 * tig;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          *reinterpret_cast<uint32_t*>(o + 8 * nt) =
              pack_bf16(acc[nt][2 * hr] * inv, acc[nt][2 * hr + 1] * inv);
        continue;
      }
      float* o = acc_part + (part + g) * D + 64 * cw + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(o + 8 * nt) = make_float2(acc[nt][2 * hr], acc[nt][2 * hr + 1]);
      if (cw == 0 && tig == 0) {
        m_part[part + g] = m[hr];
        l_part[part + g] = l[hr];
      }
    }
  } else {
  // ---- consumer warp: kv head h, query heads [g0, g0 + Gc).
  const int h = h0 + warp;
  const int Gc = min(kMmaG, G - g0);
  const int gid = lane / 4, tig = lane % 4;
  const size_t bh = (size_t)b * Hkv + h;
  // Q as A fragments (heads gid and gid + 8; absent heads are zero rows).
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q + (bh * G + g0) * D);
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
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = 0; i < n; ++i) {
    const int s = i % C::STAGES;
    const int live = min(kStageRows, end - start - i * kStageRows);  // >= 1
    const uint8_t* kt = smem + s * 2 * stage_bytes + warp * D * 2;
    const uint8_t* vt = kt + stage_bytes;
    sm90::mbar_wait(&full[s], (i / C::STAGES) & 1);
    // Rows past `live` were not copied this round: read as zeros.  K now,
    // V after the softmax, so that the two are never live together.
    uint4 kr[2][KL];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int row = 8 * t + gid;
#pragma unroll
      for (int c = 0; c < KL; ++c)
        kr[t][c] = row < live ? *reinterpret_cast<const uint4*>(
                                    kt + row * row_bytes + (32 * c + 8 * tig) * 2)
                              : zero;
    }
    // S = Q Kᵀ for the two 8-row tiles.
    float sc[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_bf16(sc[t], qa[ks], word(kr[t][ks / 2], 2 * (ks % 2)),
                 word(kr[t][ks / 2], 2 * (ks % 2) + 1));
    }
    // Scale, cap and mask; online softmax for head rows gid (hr 0), gid+8.
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[t][e] * scale;
        if (CAP) x = fast_tanh(x / softcap) * softcap;
        sc[t][e] = 8 * t + 2 * tig + e % 2 < live ? x * kLog2e : kNegInf;
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mt = fmaxf(fmaxf(sc[0][2 * hr], sc[0][2 * hr + 1]),
                       fmaxf(sc[1][2 * hr], sc[1][2 * hr + 1]));
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
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          sc[t][e] = exp2f(sc[t][e] - mn);
          l[hr] += sc[t][e];
        }
    }
    uint4 vr[4][VL];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 8 * (r / 2) + 2 * tig + r % 2;
#pragma unroll
      for (int j = 0; j < VL; ++j)
        vr[r][j] = row < live ? *reinterpret_cast<const uint4*>(
                                    vt + row * row_bytes + (64 * j + 8 * gid) * 2)
                              : zero;
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);  // the stage is in registers
    // O += P V, P from the S accumulators as bf16 A fragments.
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
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

  // This warp's partial for its head: each lane summed l over its own
  // columns; the 4 lanes of a row share m.
  const size_t part = (bh * n_split + split) * G + g0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(kFull, l[hr], 1);
    l[hr] += __shfl_xor_sync(kFull, l[hr], 2);
    const int g = gid + 8 * hr;
    if (g >= Gc) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 2 * hr; e < 2 * hr + 2; ++e)
        acc_part[(part + g) * D + 64 * (nt / 8) + 8 * (2 * tig + e % 2) + nt % 8] = acc[nt][e];
    if (tig == 0) {
      m_part[part + g] = m[hr];
      l_part[part + g] = l[hr];
    }
  }
  }
}

// One CTA per (b * Hkv + h, query head g), one thread per 4 channels: the
// splits' partials of one head are merged with coalesced 16-byte reads.
template <typename T>
__global__ void __launch_bounds__(64)
    decode_merge(const float* __restrict__ m_part, const float* __restrict__ l_part,
                 const float* __restrict__ acc_part, T* __restrict__ out, int n_part, int G,
                 int D) {
  const int g = blockIdx.y, d = 4 * threadIdx.x;
  const size_t base = (size_t)blockIdx.x * n_part * G + g;  // partial s at base + s * G
  float mx = kNegInf;
  for (int s = 0; s < n_part; ++s) mx = fmaxf(mx, m_part[base + s * G]);
  float l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = 0; s < n_part; ++s) {
    const float w = exp2f(m_part[base + s * G] - mx);
    const float4 x = *reinterpret_cast<const float4*>(acc_part + (base + s * G) * D + d);
    l += w * l_part[base + s * G];
    a.x += w * x.x;
    a.y += w * x.y;
    a.z += w * x.z;
    a.w += w * x.w;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* o = out + ((size_t)blockIdx.x * G + g) * D + d;
  o[0] = from_float<T>(a.x * inv);
  o[1] = from_float<T>(a.y * inv);
  o[2] = from_float<T>(a.z * inv);
  o[3] = from_float<T>(a.w * inv);
}

template <typename T>
cudaError_t launch_merge(const float* m_part, const float* l_part, const float* acc_part,
                         void* out, int B, int Hkv, int G, int D, int n_split, cudaStream_t s) {
  decode_merge<T><<<dim3(B * Hkv, G), D / 4, 0, s>>>(
      m_part, l_part, acc_part, static_cast<T*>(out), n_split, G, D);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_split(const void* q, const void* k, const void* v, const int32_t* kv_len,
                         void* out, float* m_part, float* l_part, float* acc_part, int B,
                         int S, int Hkv, int G, int n_split, int n_stages, float scale,
                         float softcap, cudaStream_t s) {
  const int n_gc = (G + kMaxG - 1) / kMaxG;  // G == 1 gives 1 with either HG
  const auto kernel = G == 1 ? decode_split<T, D, 1> : decode_split<T, D, kMaxG>;
  kernel<<<dim3(B * Hkv * n_gc, n_split), kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_len,
      m_part, l_part, acc_part, S, Hkv, G, n_gc, n_stages, scale, softcap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge<T>(m_part, l_part, acc_part, out, B, Hkv, G, D, n_split, s);
}

template <int D, bool CAP>
cudaError_t launch_bulk(const void* q, const void* k, const void* v, const int32_t* kv_len,
                        void* out, float* m_part, float* l_part, float* acc_part, int B, int S,
                        int Hkv, int G, int HC, int n_split, int n_stages, float scale,
                        float softcap, cudaStream_t s) {
  using C = BulkCfg<D>;
  if (HC < 1 || HC > C::MAX_HC || Hkv % HC) return cudaErrorInvalidValue;
  const int n_gc = (G + kMmaG - 1) / kMmaG;
  const size_t smem = bulk_smem<D>(HC);
  const auto kernel = decode_bulk<D, CAP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_split, B, Hkv / HC * n_gc), 32 * (C::W * HC + 1), smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_len, m_part, l_part, acc_part,
      static_cast<__nv_bfloat16*>(out), S, Hkv, G, HC, n_gc, n_stages, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess || (C::WIDE && n_split == 1)) return err;  // written by the kernel
  return launch_merge<__nv_bfloat16>(m_part, l_part, acc_part, out, B, Hkv, G, D, n_split,
                                     s);
}

template <typename T>
cudaError_t dispatch_split(int D, const void* q, const void* k, const void* v,
                           const int32_t* kv_len, void* out, float* m, float* l, float* acc,
                           int B, int S, int Hkv, int G, int n_split, int n_stages,
                           float scale, float softcap, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_split<T, 16>(q, k, v, kv_len, out, m, l, acc, B, S, Hkv, G, n_split,
                                 n_stages, scale, softcap, s);
    case 32:
      return launch_split<T, 32>(q, k, v, kv_len, out, m, l, acc, B, S, Hkv, G, n_split,
                                 n_stages, scale, softcap, s);
    case 64:
      return launch_split<T, 64>(q, k, v, kv_len, out, m, l, acc, B, S, Hkv, G, n_split,
                                 n_stages, scale, softcap, s);
    case 80:
      return launch_split<T, 80>(q, k, v, kv_len, out, m, l, acc, B, S, Hkv, G, n_split,
                                 n_stages, scale, softcap, s);
    case 128:
      return launch_split<T, 128>(q, k, v, kv_len, out, m, l, acc, B, S, Hkv, G, n_split,
                                  n_stages, scale, softcap, s);
    case 256:
      return launch_split<T, 256>(q, k, v, kv_len, out, m, l, acc, B, S, Hkv, G, n_split,
                                  n_stages, scale, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// CTAs of decode_bulk<D> (no cap) that one SM of this card holds at HC kv
// heads a CTA, from the CUDA occupancy calculator.
template <int D>
cudaError_t bulk_residency(int HC, int* ctas) {
  using C = BulkCfg<D>;
  if (HC < 1 || HC > C::MAX_HC) return cudaErrorInvalidValue;
  const auto kernel = decode_bulk<D, false>;
  const size_t smem = bulk_smem<D>(HC);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, 32 * (C::W * HC + 1),
                                                       smem);
}

template <int D>
cudaError_t dispatch_bulk(const void* q, const void* k, const void* v, const int32_t* kv_len,
                          void* out, float* m, float* l, float* acc, int B, int S, int Hkv,
                          int G, int HC, int n_split, int n_stages, float scale, float softcap,
                          cudaStream_t s) {
  if (softcap > 0.f)
    return launch_bulk<D, true>(q, k, v, kv_len, out, m, l, acc, B, S, Hkv, G, HC, n_split,
                                n_stages, scale, softcap, s);
  return launch_bulk<D, false>(q, k, v, kv_len, out, m, l, acc, B, S, Hkv, G, HC, n_split,
                               n_stages, scale, softcap, s);
}

}  // namespace

// path: 0 = decode_split (float32 or bfloat16, D in {16, 32, 64, 80, 128, 256}), 1 =
// decode_bulk (bfloat16, D in {64, 128, 256}; HC kv heads per CTA, a divisor of
// Hkv, at most 8, 1 at D 256, and 16-byte aligned caches); dtype: 0 = float32, 1 =
// bfloat16.  Scratch m_part and l_part hold B*Hkv*n_split*G floats,
// acc_part B*Hkv*n_split*G*D; split s covers the 16-row stages [s * n_stages /
// n_split, (s + 1) * n_stages / n_split).  Launches the split kernel then
// decode_merge on `stream`; returns the first cudaError_t met.
extern "C" int decode_attention(int path, int dtype, int D, const void* q, const void* k,
                                const void* v, const void* kv_len, void* out, void* m_part,
                                void* l_part, void* acc_part, int B, int S, int Hkv, int G,
                                int HC, int n_split, int n_stages, float scale, float softcap,
                                void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || G < 1 || n_stages < 1 || n_split < 1 ||
      n_split > 65535 || n_split > n_stages)
    return cudaErrorInvalidValue;
  auto* m = static_cast<float*>(m_part);
  auto* l = static_cast<float*>(l_part);
  auto* acc = static_cast<float*>(acc_part);
  const auto* kv = static_cast<const int32_t*>(kv_len);
  const auto s = static_cast<cudaStream_t>(stream);
  if (path == 1 && dtype == 1) {
    switch (D) {
      case 64:
        return dispatch_bulk<64>(q, k, v, kv, out, m, l, acc, B, S, Hkv, G, HC, n_split,
                                 n_stages, scale, softcap, s);
      case 128:
        return dispatch_bulk<128>(q, k, v, kv, out, m, l, acc, B, S, Hkv, G, HC, n_split,
                                  n_stages, scale, softcap, s);
      case 256:
        return dispatch_bulk<256>(q, k, v, kv, out, m, l, acc, B, S, Hkv, G, HC, n_split,
                                  n_stages, scale, softcap, s);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (path == 0 && dtype == 0)
    return dispatch_split<float>(D, q, k, v, kv, out, m, l, acc, B, S, Hkv, G, n_split,
                                 n_stages, scale, softcap, s);
  if (path == 0 && dtype == 1)
    return dispatch_split<__nv_bfloat16>(D, q, k, v, kv, out, m, l, acc, B, S, Hkv, G,
                                         n_split, n_stages, scale, softcap, s);
  return cudaErrorInvalidValue;
}

// CTAs of decode_bulk<D> one SM holds at HC kv heads a CTA, into *ctas.
extern "C" int decode_bulk_residency(int D, int HC, int* ctas) {
  switch (D) {
    case 64: return bulk_residency<64>(HC, ctas);
    case 128: return bulk_residency<128>(HC, ctas);
    case 256: return bulk_residency<256>(HC, ctas);
    default: return cudaErrorInvalidValue;
  }
}
