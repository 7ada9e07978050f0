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
// masked here, and no tensor is ever padded.  Two kernels, chosen by dtype
// and head size (the wrapper names the path, `kernel_path` in ops.py):
//
// * flash_wgmma (bfloat16, D in {64, 80, 128, 192, 256}, the model path), laid out as
//   FlashAttention-3.  At D = 256 its layout is its own (Wg256 below: two
//   warpgroups and no producer, 64-key tiles, persistent CTAs); at D = 64,
//   80 and 128, three warpgroups.  The producer warpgroup gives up its
//   registers (setmaxnreg) and one thread issues TMA loads of K and V tiles
//   (128 keys) into a ring of 3 stages,
//   128-byte swizzled, each tile as D / 64 boxes of 64 columns, with full
//   and empty mbarriers.  D = 80 (stablelm-3b, hubert-xlarge) adds a tail
//   block: columns 64-79 as a second box of 16 columns (32 bytes) under the
//   32-byte swizzle, exactly one swizzle atom, so that Q·Kᵀ takes 5 k steps
//   (4 over the 128-byte block, 1 over the tail) and P·V an m64n64k16 and
//   an m64n16k16 product: no product touches a column past D, and a tile
//   is 20 KB, not the 32 KB of the 128-column instance.  Fewer products
//   alone gained ~10 %: at D = 80 a tile's softmax costs as much as at 128,
//   so the instance also overlaps S_{i+1} with P_i V_i inside each group
//   (WgCfg::OVERLAP; the registers allow it at 80, not at 128) and keeps
//   one CTA on each SM walking item after item (WgCfg::PERSISTENT), so that
//   a CTA's start, a quarter of stablelm-3b's time, is paid once an SM.
//   Two
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
//   D = 192 is latent attention's pair (DeepSeek-V3's MLA prefill): q and k
//   of 192 columns (128 without position, 64 rotated), v and the output of
//   128, as FlashAttention-3 instantiates it.  Q and K tiles are three
//   64-column blocks, V and O two; S and O are the D = 128 instance's
//   accumulators, and Q·Kᵀ takes 12 k steps where D = 128 takes 8.  Two K/V
//   stages: three would be 48 KB of Q and 3 x 80 KB of K and V, more than a
//   CTA's 227 KB; two are 208 KB.  Padding q and k to 256 and v to 256 would
//   do 1.6 times the work.
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
// How far (log2 units) a row's scores may rise above its running max before
// flash_wgmma at D = 256 rescales O (FlashAttention-4's lazy rescale).
constexpr float kRescale = 8.f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Sq, Skv, Hkv, G;
  int BH;                   // B * Hkv
  int dq;                   // head size of q and k (the kernel's D)
  long long qsb, qsh, qss;  // q and out strides (batch, head, position)
  long long ksb, ksh, kss;  // k and v strides
  int causal, window;       // window <= 0: none
  float scale, softcap;     // softcap <= 0: none
  // head size of v and out (WgCfg::DV), and their strides, which the
  // instances of WgCfg read; flash_simt and Wg256 read k's strides for v
  // and q's for out, and take p only where they are the same
  // (same_layouts)
  int dv;
  long long vsb, vsh, vss, osb, osh, oss;
};

// Whether v and out have q's and k's head size and k's and q's strides:
// what the instances that read no strides of their own for them take.
bool same_layouts(const Params& p) {
  return p.dv == p.dq && p.vsb == p.ksb && p.vsh == p.ksh && p.vss == p.kss && p.osb == p.qsb &&
         p.osh == p.qsh && p.oss == p.qss;
}

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

// Byte offset of 16-byte chunk c of row r in a tile swizzled as TMA and
// wgmma swizzle it: rows of `width` bytes (128 or 32), column blocks
// `block` bytes apart, and the chunk's place in its row XORed with address
// bits 7.. of the row (r % 8 at 128 bytes, bit 2 of r at 32).
__device__ __forceinline__ int swz(int r, int c, int block, int width) {
  const int n = width / 16;  // chunks a row
  return (c / n) * block + r * width + (((c % n) ^ ((r * width >> 7) % n)) << 4);
}

// D = 64, 80, 128 and 192 (v and O of 128); D = 256 takes Wg256 below.
template <int D>
struct WgCfg {
  static_assert(D <= 128 || D == 192, "flash_wgmma: D = 256 takes Wg256");
  static constexpr int BN = 128;                    // keys per tile
  // Head size of V and O: D, but 128 beside the 192 of Q and K.
  static constexpr int DV = D == 192 ? 128 : D;
  // K/V ring depth: three tiles beside Q (at D = 80 four were slower); two
  // at D = 192, where three do not fit.
  static constexpr int STAGES = D == 192 ? 2 : 3;
  static constexpr int NC = D / 64;                 // 64-column (128-byte) blocks of Q, K
  static constexpr int NV = DV / 64;                // ... of V, O
  // Columns past the 64-column blocks: one 16-column (32-byte) block under
  // the 32-byte swizzle at D = 80, one swizzle atom wide.
  static constexpr int TAIL = D % 64;
  // Whether a group issues S_i with P_{i-1} V_{i-1} (FlashAttention-3's
  // overlap inside a group): at D = 80 the second score tile fits beside
  // P and O (64 + 32 + 40 registers); at D = 128 it spilled.
  static constexpr bool OVERLAP = D == 80;
  // Whether a CTA stays on its SM and takes item after item, so that the
  // ring streams on from one item's tiles to the next's and each item's
  // start (the first tiles' latency, the CTA's launch) is hidden: at D = 80
  // it was a quarter of stablelm-3b's time.
  static constexpr bool PERSISTENT = D == 80;
  static_assert(TAIL == 0 || TAIL == 16, "flash_wgmma: D is 64 NC or 64 NC + 16");
  static constexpr int Q_BLOCK = kRows * 128;       // bytes of one column block of Q
  static constexpr int KV_BLOCK = BN * 128;         // ... of K or V
  static constexpr int KV_TAIL = BN * TAIL * 2;     // ... of K's or V's tail block
  static constexpr int K_TILE = NC * KV_BLOCK + KV_TAIL;  // one tile of K
  static constexpr int V_TILE = NV * KV_BLOCK + KV_TAIL;  // ... of V
  static constexpr int Q_BYTES = NC * Q_BLOCK + kRows * TAIL * 2;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * (K_TILE + V_TILE);
  // 1024 bytes of slack to align the swizzled tiles, then the barriers.
  static constexpr size_t SMEM = 1024 + BAR_OFF + 3 * STAGES * sizeof(uint64_t);
  static_assert(SMEM <= 232448, "flash_wgmma: more shared memory than a CTA may have");

  // Byte offset of 16-byte chunk c of row r of Q (and of O, staged over
  // it): the 128-byte-swizzled blocks, then the tail block's 32-byte rows.
  static __device__ __forceinline__ int q_off(int r, int c) {
    return c < 8 * NC ? swz(r, c, Q_BLOCK, 128) : NC * Q_BLOCK + swz(r, c - 8 * NC, 0, 32);
  }
};

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

// ---------------------------------------------------------------------------
// wgmma kernel at D = 256
// ---------------------------------------------------------------------------

// recurrentgemma-9b's local attention: 16 query heads over one kv head of
// 256, window 2048.  O is 128 fp32 registers a consumer thread, and the
// layout of the smaller head sizes does not carry over.  There a producer
// warpgroup launches the CTA at 168 registers a thread (384 threads) and
// setmaxnreg hands the consumers 240, but ptxas budgets the registers
// live across a wgmma at the launch's 168: O alone is 128, so it
// serialized every wgmma and spilled (C7512).  Here (FlashAttention-3's
// hdim-256 forward on local attention: 128 rows, 64-key tiles):
// * two consumer warpgroups and no producer: 256 threads launch at up to
//   255 registers.  Thread 0 of each group feeds one ring, each refill
//   right after its own group's release of a stage: group 0 K, two tiles
//   ahead (group 1 has released the stage by then), group 1 V, two ahead
//   (group 0 released it first).  Each keeps its place in the tile stream
//   in registers, and a tile is one TMA box (the four 64-column blocks as
//   a box dimension): the feeding warp is on the critical path, and a feed
//   kept in shared memory (whose accesses queue behind the wgmmas' operand
//   traffic) or four boxes a tile slowed it;
// * S_i is issued in one turn with P_{i-1} V_{i-1}, and the softmax of S_i
//   runs under that product (O 128 + S 32 + P 16 registers in flight);
//   the first k step of each S writes its accumulators without reading
//   them, so that the last tile's P is dead before it;
// * a row's running max moves only when a tile's scores exceed it by more
//   than kRescale (FlashAttention-4's lazy rescale), so that most tiles
//   skip the 128 multiplies on O;
// * K and V have rings of their own, 3 and 2 tiles deep, with their own
//   empty barriers: a K tile is released once both groups' S has read it,
//   a V tile once their P V has.  Shared memory: Q 64 KB + 3 x 32 KB of K
//   + 2 x 32 KB of V = 224 KB, 12 barriers and 1 KB of alignment slack,
//   230,496 of the 232,448 bytes a CTA may have;
// * one CTA an SM takes item after item (dealt in rounds, each round in
//   the reverse order of the one before, longest rows first, so that the
//   CTAs' shares of tiles are even), the rings stream on across items, and
//   each group loads its next item's Q rows under its last P V: by TMA
//   where its 64 rows are one box of whole positions (G divides 64, or G
//   = 128), else by 16-byte loads;
// * O / l is stored from the registers (no shared memory is free for it).
struct Wg256 {
  static constexpr int BN = 64;                    // keys per tile
  static constexpr int NC = 4;                     // 64-column (128-byte) blocks
  static constexpr int K_STAGES = 3;
  static constexpr int V_STAGES = 2;
  static constexpr int Q_BLOCK = kRows * 128;      // one column block of Q, 16 KB
  static constexpr int KV_BLOCK = BN * 128;        // ... of a K or V tile, 8 KB
  static constexpr int TILE = NC * KV_BLOCK;       // a K or V tile, 32 KB
  static constexpr int K_OFF = NC * Q_BLOCK;
  static constexpr int V_OFF = K_OFF + K_STAGES * TILE;
  static constexpr int BAR_OFF = V_OFF + V_STAGES * TILE;
  // full and empty of each stage, and one Q barrier a consumer group
  static constexpr int N_BARS = 2 * (K_STAGES + V_STAGES) + 2;
  static constexpr size_t SMEM = 1024 + BAR_OFF + N_BARS * sizeof(uint64_t);
  static_assert(SMEM <= 232448, "Wg256: more shared memory than a CTA may have");
};

// Whether a consumer group's 64 rows of Q are one TMA box of whole
// positions (G heads each), or half of one position's heads (G = 128).
__host__ __device__ __forceinline__ bool q_by_tma(int G) { return 64 % G == 0 || G == 128; }

template <bool CAUSAL, bool WINDOW, bool CAP>
__device__ __forceinline__ void flash256(const Params& p, const CUtensorMap* tmk,
                                         const CUtensorMap* tmv, const CUtensorMap* tmq) {
  using C = Wg256;
  constexpr int BN = C::BN;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = sm;                                   // [NC][kRows][128 B]
  uint8_t* Ks = sm + C::K_OFF;                        // [K_STAGES][NC][BN][128 B]
  uint8_t* Vs = sm + C::V_OFF;                        // [V_STAGES][NC][BN][128 B]
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* empty_k = full_k + C::K_STAGES;
  uint64_t* full_v = empty_k + C::K_STAGES;
  uint64_t* empty_v = full_v + C::V_STAGES;
  uint64_t* q_full = empty_v + C::V_STAGES;

  const int n_rows = p.Sq * p.G;
  const int n_rb = (n_rows + kRows - 1) / kRows;
  const int n_items = n_rb * p.BH;
  struct Item {
    int R0, b, h, t_lo, n_tiles;
  };
  // Item k of this CTA (false past the last): round k of gridDim.x items,
  // in this CTA's place or, in odd rounds, the mirror of it.
  auto item = [&](int k, Item& x) -> bool {
    const int idx = k * gridDim.x + ((k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
    if (idx >= n_items) return false;
    const int rb = idx / p.BH, bh = idx % p.BH;
    x.R0 = (n_rb - 1 - rb) * kRows;
    x.b = bh / p.Hkv;
    x.h = bh % p.Hkv;
    int k_lo, k_hi;
    key_range(p, x.R0 / p.G, (min(x.R0 + kRows, n_rows) - 1) / p.G, k_lo, k_hi);
    x.t_lo = k_lo / BN;
    x.n_tiles = k_hi > k_lo ? (k_hi + BN - 1) / BN - x.t_lo : 0;
    return true;
  };

  // A feed of one ring: the next tile's item (k, x) and place in it (i),
  // and the tiles issued (t), in the feeding thread's registers.
  struct Feed {
    int k = -1, i = 0, t = 0;
    Item x;
  };
  // f.x: the next item after f.k with any tile (n_tiles 0 past the last).
  auto seek = [&](Feed& f) {
    f.i = 0;
    do {
      if (!item(++f.k, f.x)) {
        f.x.n_tiles = 0;
        return;
      }
    } while (f.x.n_tiles == 0);
  };
  // The next tile of `f` into its stage of `ring`, once both groups have
  // released the stage: one box, (64 columns, BN keys, 4 column blocks).
  auto feed = [&](Feed& f, const CUtensorMap* map, uint8_t* ring, uint64_t* full, uint64_t* empty,
                  int stages) {
    if (f.i >= f.x.n_tiles) return;
    const int s = f.t % stages;
    sm90::mbar_wait(&empty[s], ((f.t / stages) & 1) ^ 1);
    sm90::mbar_arrive_expect_tx(&full[s], C::TILE);
    sm90::tma_load_5d(ring + s * C::TILE, map, &full[s], 0, (f.x.t_lo + f.i) * BN, 0, f.x.h,
                      f.x.b);
    ++f.t;
    if (++f.i >= f.x.n_tiles) seek(f);
  };
  Feed fd;  // group 0's thread 0 feeds K, group 1's V
  const bool k_feeder = threadIdx.x == 0, v_feeder = threadIdx.x == kWgThreads;
  auto feed_k = [&]() { feed(fd, tmk, Ks, full_k, empty_k, C::K_STAGES); };
  auto feed_v = [&]() { feed(fd, tmv, Vs, full_v, empty_v, C::V_STAGES); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::K_STAGES; ++s) {
      sm90::mbar_init(&full_k[s], 1);
      sm90::mbar_init(&empty_k[s], 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < C::V_STAGES; ++s) {
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty_v[s], 8);
    }
    sm90::mbar_init(&q_full[0], 1);
    sm90::mbar_init(&q_full[1], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
#ifdef FLASH_TIMING
  const int cta = blockIdx.x;
  if (threadIdx.x == 0 && cta < 8192) {
    unsigned smid;
    asm volatile("mov.u32 %0, %smid;" : "=r"(smid));
    int tiles = 0;
    Item x;
    for (int k = 0; item(k, x); ++k) tiles += x.n_tiles;
    g_timing[4 * cta] = gtime();
    g_timing[4 * cta + 2] = tiles;
    g_timing[4 * cta + 3] = smid;
  }
#endif
  if (k_feeder || v_feeder) {  // each ring's first two tiles
    seek(fd);
    for (int j = 0; j < 2; ++j) {
      if (k_feeder)
        feed_k();
      else
        feed_v();
    }
  }

  // ---- consumers: group w owns rows [64w, 64w + 64) of each item.
  const int w = __shfl_sync(kFull, threadIdx.x / kWgThreads, 0);  // warp-uniform
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  // Rows of this thread: 64w + 16 warp + lane / 4 (+ 8).
  const int row0 = 64 * w + 16 * warp + lane / 4;
  const float sl2 = CAP ? p.scale / p.softcap : p.scale * kLog2e;
  const float cl2 = p.softcap * kLog2e;
  const float f = CAP ? 1.f : sl2;  // score -> log2 units, after the cap
  const bool q_tma = q_by_tma(p.G);
  const uint64_t dq = sm90::desc_sw128(Qs + 64 * w * 128, 16, 1024);

  float o[128];
  float sc[BN / 2];  // S of the current tile, then its P
  uint32_t pa[BN / 16][4];
  float m[2], l[2], alpha[2];
  int pos[2], w_lo, w_hi;
  int R0, b, h, t_lo, n_tiles;
  int kt = 0;  // ring index of the item's first tile

  // This group's 64 Q rows of item x (absent rows zero), swizzled as TMA
  // swizzles them: by TMA (completing on q_full[w]) or by 16-byte loads.
  auto load_q = [&](const Item& x) {
    if (q_tma) {
      if (tid == 0) {
        const int R = x.R0 + 64 * w;
        sm90::mbar_arrive_expect_tx(&q_full[w], 64 * 256 * 2);
#pragma unroll
        for (int c = 0; c < C::NC; ++c)
          sm90::tma_load_5d(Qs + c * C::Q_BLOCK + 64 * w * 128, tmq, &q_full[w], 64 * c,
                            R % p.G, R / p.G, x.h, x.b);
      }
    } else {
      const auto* q = static_cast<const __nv_bfloat16*>(p.q);
      for (int e = tid; e < 64 * 32; e += kWgThreads) {
        const int r = 64 * w + e / 32, c = e % 32;
        const int R = x.R0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (R < n_rows)
          val = *reinterpret_cast<const uint4*>(q + x.b * p.qsb +
                                                (long long)(x.h * p.G + R % p.G) * p.qsh +
                                                (long long)(R / p.G) * p.qss + c * 8);
        *reinterpret_cast<uint4*>(Qs + swz(r, c, C::Q_BLOCK, 128)) = val;
      }
      sm90::fence_proxy_async();
      sm90::bar_sync(kGroupBar + w, kWgThreads);
    }
  };

  // Cap, and mask only where the tile crosses an edge of this group's rows
  // (a masked score is -inf and weighs 0); then the online softmax per row
  // (the 4 lanes of a quad share a row): P into sc, alpha for O.  A row's
  // running max m moves only when the tile's max exceeds it by more than
  // kRescale (log2 units), so that most tiles leave O as it is: P and l
  // are taken against the same m, so O / l is unchanged, and P stays below
  // 2^kRescale.
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
      float t4[4] = {-kInf, -kInf, -kInf, -kInf};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        t4[j % 4] = fmaxf(t4[j % 4], fmaxf(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1]));
      float t = fmaxf(fmaxf(t4[0], t4[1]), fmaxf(t4[2], t4[3]));
      t = fmaxf(t, __shfl_xor_sync(kFull, t, 1));
      t = fmaxf(t, __shfl_xor_sync(kFull, t, 2));
      const float mx = t * f;
      alpha[hr] = 1.f;
      if (mx > m[hr] + kRescale) {  // and where m is -inf and a key is live
        alpha[hr] = fast_exp2(m[hr] - mx);
        m[hr] = mx;
      }
      const float base = m[hr] == -kInf ? 0.f : m[hr];
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

  // S_i = Q K_iᵀ (both K-major: k step ks is 32 bytes into column block
  // ks / 4); O += P_i V_i with P_i as the A operand in registers and V
  // MN-major (k step kk is 16 rows, 2048 bytes down each column block).
  auto issue_s = [&](int i) {
    const uint64_t dk =
        sm90::desc_sw128(Ks + ((kt + i) % C::K_STAGES) * C::TILE, 16, 1024);
    sm90::wgmma_ss_first64(sc, dq, dk);
#pragma unroll
    for (int ks = 1; ks < 4 * C::NC; ++ks)
      sm90::wgmma_ss<BN>(sc, dq + (((ks / 4) * C::Q_BLOCK + (ks % 4) * 32) >> 4),
                         dk + (((ks / 4) * C::KV_BLOCK + (ks % 4) * 32) >> 4), 1);
    sm90::wgmma_commit();
  };
  auto issue_pv = [&](int i) {
    const uint8_t* vt = Vs + ((kt + i) % C::V_STAGES) * C::TILE;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      sm90::wgmma_rs<256>(o, pa[kk], sm90::desc_sw128(vt + kk * 2048, C::KV_BLOCK, 1024));
    sm90::wgmma_commit();
  };
  // P (the softmax's sc) into bf16 A fragments; O scaled by alpha where a
  // row of the warp moved its max.
  auto take_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    if (__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }
  };
  auto wait_k = [&](int i) {
    const int t = kt + i;
    sm90::mbar_wait(&full_k[t % C::K_STAGES], (t / C::K_STAGES) & 1);
  };
  auto wait_v = [&](int i) {
    const int t = kt + i;
    sm90::mbar_wait(&full_v[t % C::V_STAGES], (t / C::V_STAGES) & 1);
  };
  auto release_k = [&](int i) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty_k[(kt + i) % C::K_STAGES]);
  };
  auto release_v = [&](int i) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty_v[(kt + i) % C::V_STAGES]);
  };

  Item x;
  item(0, x);  // the grid holds no more CTAs than items
  load_q(x);
  for (int k = 0;; ++k) {
    R0 = x.R0;
    b = x.b;
    h = x.h;
    t_lo = x.t_lo;
    n_tiles = x.n_tiles;
    pos[0] = (R0 + row0) / p.G;
    pos[1] = (R0 + row0 + 8) / p.G;
    w_lo = (R0 + 64 * w) / p.G;
    w_hi = (R0 + 64 * w + 63) / p.G;
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    m[0] = m[1] = -kInf;
    l[0] = l[1] = 0.f;
    if (q_tma) sm90::mbar_wait(&q_full[w], k & 1);

    // The two groups take turns at the tensor cores (named barriers), n_tiles
    // + 1 turns each an item: S_0, then S_i with P_{i-1} V_{i-1}, then the
    // last P V.  Group 1's last turn passes none back; group 1 lets group 0
    // start each item.
    bool more;
    if (n_tiles > 0) {
      if (w == 1) sm90::bar_arrive(kTurnBar, 2 * kWgThreads);
      wait_k(0);
      sm90::bar_sync(kTurnBar + w, 2 * kWgThreads);
      sm90::wgmma_fence();
      issue_s(0);
      sm90::bar_arrive(kTurnBar + 1 - w, 2 * kWgThreads);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(sc);
      release_k(0);
      if (k_feeder) feed_k();
      softmax(0);
      take_p();
      for (int i = 1; i < n_tiles; ++i) {
        wait_k(i);
        wait_v(i - 1);
        sm90::fence_operands(o);
        sm90::bar_sync(kTurnBar + w, 2 * kWgThreads);
        sm90::wgmma_fence();
        issue_s(i);
        issue_pv(i - 1);
        sm90::bar_arrive(kTurnBar + 1 - w, 2 * kWgThreads);
        sm90::wgmma_wait<1>();
        sm90::fence_operands(sc);
        release_k(i);
        if (k_feeder) feed_k();
        softmax(i);
        sm90::wgmma_wait<0>();
        sm90::fence_operands(o);
        release_v(i - 1);
        if (v_feeder) feed_v();
        take_p();
      }
      wait_v(n_tiles - 1);
      sm90::fence_operands(o);
      sm90::bar_sync(kTurnBar + w, 2 * kWgThreads);
      sm90::wgmma_fence();
      issue_pv(n_tiles - 1);
      if (w == 0) sm90::bar_arrive(kTurnBar + 1, 2 * kWgThreads);
      // The next item's Q over this group's rows, which no S reads any more.
      more = item(k + 1, x);
      if (more) load_q(x);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(o);
      release_v(n_tiles - 1);
      if (v_feeder) feed_v();
    } else {
      more = item(k + 1, x);
      if (more) load_q(x);
    }
    kt += n_tiles;

    // O / l, straight from the registers: the 4 lanes of a quad hold 16
    // consecutive bytes of a row for each 8 columns.
    auto* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float lt = l[hr];
      lt += __shfl_xor_sync(kFull, lt, 1);
      lt += __shfl_xor_sync(kFull, lt, 2);
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      const int R = R0 + row0 + 8 * hr;
      if (R < n_rows) {
        __nv_bfloat16* dst = out + b * p.qsb + (long long)(h * p.G + R % p.G) * p.qsh +
                             (long long)(R / p.G) * p.qss + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < 32; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
      }
    }
    if (!more) break;
  }
#ifdef FLASH_TIMING
  if (threadIdx.x == 0 && cta < 8192) g_timing[4 * cta + 1] = gtime();
#endif
}

// grid (ceil(Sq * G / kRows), B * Hkv), kThreads threads: one work item (a
// block of kRows flattened rows of one (b, kv head)) a CTA; with
// WgCfg::PERSISTENT, grid (min(items, SMs), 1) and each CTA takes items
// blockIdx.x, + gridDim.x, ...  Items are dealt longest rows first.
// tmk, tmv: K and V in 64-column boxes; tmk_tail, tmv_tail: their 16-column
// tail (D = 80), read only where WgCfg<D>::TAIL.  D = 256 runs flash256:
// grid (min(items, SMs), 1), 2 * kWgThreads threads; tmk and tmv in whole
// tiles, tmq its Q boxes.
template <int D, bool CAUSAL, bool WINDOW, bool CAP>
__global__ void __launch_bounds__(D == 256 ? 2 * kWgThreads : kThreads, 1)
    flash_wgmma(const Params p, const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv,
                const __grid_constant__ CUtensorMap tmk_tail,
                const __grid_constant__ CUtensorMap tmv_tail,
                const __grid_constant__ CUtensorMap tmq) {
  if constexpr (D == 256) {
    flash256<CAUSAL, WINDOW, CAP>(p, &tmk, &tmv, &tmq);
  } else {
    using C = WgCfg<D>;
    constexpr int BN = C::BN;
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    // Swizzled tiles start on 1024 bytes; offsetting the shared array itself
    // (not a generic address) keeps every access a shared-memory one.
    uint8_t* sm = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
    uint8_t* Qs = sm;                                   // [NC][kRows][128 B], [kRows][32 B]
    uint8_t* Ks = Qs + C::Q_BYTES;                      // [STAGES][NC][BN][128 B], [BN][32 B]
    uint8_t* Vs = Ks + C::STAGES * C::K_TILE;
    uint64_t* full_k = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
    uint64_t* full_v = full_k + C::STAGES;
    uint64_t* empty = full_v + C::STAGES;

    const int n_rows = p.Sq * p.G;
    const int n_rb = (n_rows + kRows - 1) / kRows;
    // Work item k of this CTA (false past the last): its first row R0, (b,
    // h) and kv tiles [t_lo, t_lo + n_tiles).  R0 ... n_tiles below are the
    // item in hand.
    struct Item {
      int R0, b, h, t_lo, n_tiles;
    };
    auto item = [&](int k, Item& x) -> bool {
      int rb, bh;
      if constexpr (C::PERSISTENT) {
        const int idx = blockIdx.x + k * gridDim.x;
        if (idx >= n_rb * p.BH) return false;
        rb = idx / p.BH;
        bh = idx % p.BH;
      } else {
        if (k > 0) return false;
        rb = blockIdx.x;
        bh = blockIdx.y;
      }
      x.R0 = (n_rb - 1 - rb) * kRows;  // longest rows first; R0 < n_rows
      x.b = bh / p.Hkv;
      x.h = bh % p.Hkv;
      int k_lo, k_hi;
      key_range(p, x.R0 / p.G, (min(x.R0 + kRows, n_rows) - 1) / p.G, k_lo, k_hi);
      x.t_lo = k_lo / BN;
      x.n_tiles = k_hi > k_lo ? (k_hi + BN - 1) / BN - x.t_lo : 0;
      return true;
    };
    int R0, b, h, t_lo, n_tiles;
    auto take = [&](const Item& x) {
      R0 = x.R0;
      b = x.b;
      h = x.h;
      t_lo = x.t_lo;
      n_tiles = x.n_tiles;
    };

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
      int tiles = 0;
      Item x;
      for (int k = 0; item(k, x); ++k) tiles += x.n_tiles;
      g_timing[4 * cta] = gtime();
      g_timing[4 * cta + 2] = tiles;
      g_timing[4 * cta + 3] = smid;
    }
#endif

    const int wg = threadIdx.x / kWgThreads;
    if (wg == 2) {
      // ---- producer: one thread keeps the ring of K and V tiles full, item
      // after item (ring position `it` runs on across items).
      sm90::reg_dealloc<kProducerRegs>();
      if (threadIdx.x == 2 * kWgThreads) {
        int it = 0;
        Item x;
        for (int k = 0; item(k, x); ++k) {
          take(x);
          for (int i = 0; i < n_tiles; ++i, ++it) {
            const int s = it % C::STAGES;
            sm90::mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
            const int key0 = (t_lo + i) * BN;
            sm90::mbar_arrive_expect_tx(&full_k[s], C::K_TILE);
#pragma unroll
            for (int c = 0; c < C::NC; ++c)
              sm90::tma_load_4d(Ks + s * C::K_TILE + c * C::KV_BLOCK, &tmk, &full_k[s], 64 * c,
                                key0, h, b);
            if constexpr (C::TAIL > 0)
              sm90::tma_load_4d(Ks + s * C::K_TILE + C::NC * C::KV_BLOCK, &tmk_tail, &full_k[s],
                                64 * C::NC, key0, h, b);
            sm90::mbar_arrive_expect_tx(&full_v[s], C::V_TILE);
#pragma unroll
            for (int c = 0; c < C::NV; ++c)
              sm90::tma_load_4d(Vs + s * C::V_TILE + c * C::KV_BLOCK, &tmv, &full_v[s], 64 * c,
                                key0, h, b);
            if constexpr (C::TAIL > 0)
              sm90::tma_load_4d(Vs + s * C::V_TILE + C::NV * C::KV_BLOCK, &tmv_tail, &full_v[s],
                                64 * C::NV, key0, h, b);
          }
        }
      }
    } else {
      // ---- consumers: group w owns rows [64w, 64w + 64) of each item.
      sm90::reg_alloc<kConsumerRegs>();
      const int w = wg;
      const int tid = threadIdx.x - wg * kWgThreads;
      const int warp = tid / 32, lane = tid % 32;
      const auto* q = static_cast<const __nv_bfloat16*>(p.q);
      // Rows of this thread: 64w + 16 warp + lane / 4 (+ 8).
      const int row0 = 64 * w + 16 * warp + lane / 4;
      const float sl2 = CAP ? p.scale / p.softcap : p.scale * kLog2e;
      const float cl2 = p.softcap * kLog2e;
      const float f = CAP ? 1.f : sl2;  // score -> log2 units, after the cap
      const uint8_t* q_w = Qs + 64 * w * 128;
      const uint8_t* q_tail = Qs + C::NC * C::Q_BLOCK + 64 * w * 32;

      // O over the 64-column blocks and over the tail block; oc(i) is
      // element i of the whole row of DV / 2 (constant i once unrolled).
      float o[32 * C::NV], ot[C::TAIL > 0 ? C::TAIL / 2 : 1];
      auto oc = [&](int i) -> float& { return i < 32 * C::NV ? o[i] : ot[i - 32 * C::NV]; };
      // Running max (log2 units; -inf until a live key) and sum of each row.
      float m[2], l[2];
      float sc[BN / 2];                 // S of the current tile, then its P
      float alpha[2];
      int pos[2], w_lo, w_hi;

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

      // S_i = Q K_iᵀ (both K-major: k step ks is 32 bytes into column block
      // ks / 4, and the tail block is one k step); O += P_i V_i with P_i as
      // the A operand in registers and V MN-major (k step kk is 16 rows, 2048
      // bytes down each column block, 512 down the tail block).  `it` is the
      // ring position of the item's first tile.
      int it = 0;
      uint32_t pa[BN / 16][4];
      auto issue_s = [&](int i) {
        const uint8_t* kt = Ks + ((it + i) % C::STAGES) * C::K_TILE;
#pragma unroll
        for (int ks = 0; ks < 4 * C::NC; ++ks)
          sm90::wgmma_ss<BN>(
              sc, sm90::desc_sw128(q_w + (ks / 4) * C::Q_BLOCK + (ks % 4) * 32, 16, 1024),
              sm90::desc_sw128(kt + (ks / 4) * C::KV_BLOCK + (ks % 4) * 32, 16, 1024), ks > 0);
        if constexpr (C::TAIL > 0)
          sm90::wgmma_ss<BN>(sc, sm90::desc_sw32(q_tail, 16, 256),
                             sm90::desc_sw32(kt + C::NC * C::KV_BLOCK, 16, 256), 1);
        sm90::wgmma_commit();
      };
      auto issue_pv = [&](int i) {
        const uint8_t* vt = Vs + ((it + i) % C::STAGES) * C::V_TILE;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          sm90::wgmma_rs<64 * C::NV>(o, pa[kk],
                                     sm90::desc_sw128(vt + kk * 2048, C::KV_BLOCK, 1024));
          if constexpr (C::TAIL > 0)
            sm90::wgmma_rs<C::TAIL>(
                ot, pa[kk], sm90::desc_sw32(vt + C::NV * C::KV_BLOCK + kk * 512, C::KV_TAIL, 256));
        }
        sm90::wgmma_commit();
      };
      // P (the softmax's sc) into bf16 A fragments; O scaled by alpha.
      auto take_p = [&]() {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
#pragma unroll
        for (int j = 0; j < C::DV / 8; ++j) {
          oc(4 * j) *= alpha[0];
          oc(4 * j + 1) *= alpha[0];
          oc(4 * j + 2) *= alpha[1];
          oc(4 * j + 3) *= alpha[1];
        }
      };
      auto wait_o = [&]() {
        sm90::wgmma_wait<0>();
        sm90::fence_operands(o);
        sm90::fence_operands(ot);
      };
      auto wait_k = [&](int i) {
        sm90::mbar_wait(&full_k[(it + i) % C::STAGES], ((it + i) / C::STAGES) & 1);
      };
      auto wait_v = [&](int i) {
        sm90::mbar_wait(&full_v[(it + i) % C::STAGES], ((it + i) / C::STAGES) & 1);
      };
      auto release = [&](int i) {
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[(it + i) % C::STAGES]);
      };

      // 16-byte chunk e of this group's Q rows of item x (absent rows zero),
      // and where it lies in shared memory, swizzled as TMA would.
      auto q_chunk = [&](const Item& x, int e) {
        const int r = 64 * w + e / (D / 8), c = e % (D / 8);
        const int R = x.R0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (R < n_rows)
          val = *reinterpret_cast<const uint4*>(q + x.b * p.qsb +
                                                (long long)(x.h * p.G + R % p.G) * p.qsh +
                                                (long long)(R / p.G) * p.qss + c * 8);
        return val;
      };
      auto q_at = [&](int e) { return Qs + C::q_off(64 * w + e / (D / 8), e % (D / 8)); };

      Item x;
      item(0, x);
      take(x);
      for (int e = tid; e < 64 * D / 8; e += kWgThreads)
        *reinterpret_cast<uint4*>(q_at(e)) = q_chunk(x, e);
      sm90::fence_proxy_async();
      sm90::bar_sync(kGroupBar + w, kWgThreads);
      for (int k = 0;; ++k) {

        pos[0] = (R0 + row0) / p.G;
        pos[1] = (R0 + row0 + 8) / p.G;
        w_lo = (R0 + 64 * w) / p.G;
        w_hi = (R0 + 64 * w + 63) / p.G;
#pragma unroll
        for (int i = 0; i < C::DV / 2; ++i) oc(i) = 0.f;
        m[0] = m[1] = -kInf;
        l[0] = l[1] = 0.f;

        // The two groups take turns at the tensor cores (named barriers): a
        // group issues its products in its turn, so that its softmax runs
        // under the other group's.  A group takes n_tiles turns an item
        // (n_tiles + 1 with the overlap); group 1's last passes none back.
        if (w == 1 && n_tiles > 0) sm90::bar_arrive(kTurnBar, 2 * kWgThreads);  // group 0 first
        if constexpr (C::OVERLAP) {
          // FlashAttention-3's overlap inside the group: S_i is issued in
          // one turn with P_{i-1} V_{i-1}, and the softmax of S_i runs under
          // that product; a stage is released once its V has been read.
          if (n_tiles > 0) {
            wait_k(0);
            sm90::bar_sync(kTurnBar + w, 2 * kWgThreads);
            sm90::wgmma_fence();
            issue_s(0);
            sm90::bar_arrive(kTurnBar + 1 - w, 2 * kWgThreads);
            sm90::wgmma_wait<0>();
            sm90::fence_operands(sc);
            softmax(0);
            take_p();
            for (int i = 1; i < n_tiles; ++i) {
              wait_k(i);
              wait_v(i - 1);
              sm90::fence_operands(o);
              sm90::fence_operands(ot);
              sm90::bar_sync(kTurnBar + w, 2 * kWgThreads);
              sm90::wgmma_fence();
              issue_s(i);
              issue_pv(i - 1);
              sm90::bar_arrive(kTurnBar + 1 - w, 2 * kWgThreads);
              sm90::wgmma_wait<1>();
              sm90::fence_operands(sc);
              softmax(i);
              wait_o();
              release(i - 1);
              take_p();
            }
            wait_v(n_tiles - 1);
            sm90::fence_operands(o);
            sm90::fence_operands(ot);
            sm90::bar_sync(kTurnBar + w, 2 * kWgThreads);
            sm90::wgmma_fence();
            issue_pv(n_tiles - 1);
            if (w == 0) sm90::bar_arrive(kTurnBar + 1, 2 * kWgThreads);
            wait_o();
            release(n_tiles - 1);
          }
        } else {
          // One turn a tile for S_i; the group computes P_i while the other
          // group takes its turn, then O += P_i V_i.
          for (int i = 0; i < n_tiles; ++i) {
            wait_k(i);
            sm90::bar_sync(kTurnBar + w, 2 * kWgThreads);
            sm90::wgmma_fence();
            issue_s(i);
            if (!(w == 1 && i == n_tiles - 1)) sm90::bar_arrive(kTurnBar + 1 - w, 2 * kWgThreads);
            sm90::wgmma_wait<0>();
            sm90::fence_operands(sc);
            softmax(i);
            take_p();
            wait_v(i);
            sm90::fence_operands(o);
            sm90::fence_operands(ot);
            sm90::wgmma_fence();
            issue_pv(i);
            wait_o();
            release(i);
          }
        }
        it += n_tiles;

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
          for (int j = 0; j < C::DV / 8; ++j)
            *reinterpret_cast<uint32_t*>(Qs + C::q_off(r, j) + 4 * (lane % 4)) =
                pack_bf16(oc(4 * j + 2 * hr) * inv, oc(4 * j + 2 * hr + 1) * inv);
        }
        sm90::bar_sync(kGroupBar + w, kWgThreads);
        auto* out = static_cast<__nv_bfloat16*>(p.out);
        for (int e = tid; e < 64 * C::DV / 8; e += kWgThreads) {
          const int r = 64 * w + e / (C::DV / 8), c = e % (C::DV / 8);
          const int R = R0 + r;
          if (R < n_rows)
            *reinterpret_cast<uint4*>(out + b * p.osb + (long long)(h * p.G + R % p.G) * p.osh +
                                      (long long)(R / p.G) * p.oss + c * 8) =
                *reinterpret_cast<const uint4*>(Qs + C::q_off(r, c));
        }
        if constexpr (!C::PERSISTENT) break;
        if (!item(k + 1, x)) break;
        // The next item's Q over these rows, once the group's stores have
        // read them.
        take(x);
        sm90::bar_sync(kGroupBar + w, kWgThreads);
        for (int e = tid; e < 64 * D / 8; e += kWgThreads)
          *reinterpret_cast<uint4*>(q_at(e)) = q_chunk(x, e);
        sm90::fence_proxy_async();
        sm90::bar_sync(kGroupBar + w, kWgThreads);
      }
#ifdef FLASH_TIMING
      if (threadIdx.x == 0 && cta < 8192) g_timing[4 * cta + 1] = gtime();
#endif
    }
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
// ss, 1): boxes of `cols` channels by `rows` keys, 64 channels (128 bytes)
// under the 128-byte swizzle or 16 (32 bytes) under the 32-byte one; keys
// past Skv read as zeros.
bool kv_map(CUtensorMap* map, const void* base, int B, int Hkv, int Skv, int D, long long sb,
            long long sh, long long ss, int rows, int cols) {
  return sm90::tile_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, {D, Skv, Hkv, B},
                       {ss, sh, sb}, {cols, rows, 1, 1},
                       cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B);
}

// SMs of the current device: the persistent grids' size.
cudaError_t device_sms(int& sms) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
}

template <int D, bool CAUSAL, bool WINDOW, bool CAP>
cudaError_t launch_wgmma(const Params& p, int B, cudaStream_t s) {
  if (p.dq != D) return cudaErrorInvalidValue;
  const auto kernel = flash_wgmma<D, CAUSAL, WINDOW, CAP>;
  const int n_items = (p.Sq * p.G + kRows - 1) / kRows * B * p.Hkv;
  int sms;
  cudaError_t err;
  if constexpr (D == 256) {
    using C = Wg256;
    if (!same_layouts(p)) return cudaErrorInvalidValue;
    // K and V as (64 columns, Skv, 4 column blocks, Hkv, B), a tile one box
    // that lands as the four 64-column blocks one after another; Q as (D,
    // G, Sq, Hkv, B), one box a consumer group's 64 rows: 64 / G whole
    // positions, or half the heads of one at G = 128 (where no box fits,
    // the kernel loads Q itself).
    CUtensorMap tmk, tmv, tmq;
    const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
    if (!sm90::tile_map(&tmk, bf16, 2, p.k, {64, p.Skv, C::NC, p.Hkv, B},
                        {p.kss, 64, p.ksh, p.ksb}, {64, C::BN, C::NC, 1, 1}, sw) ||
        !sm90::tile_map(&tmv, bf16, 2, p.v, {64, p.Skv, C::NC, p.Hkv, B},
                        {p.kss, 64, p.ksh, p.ksb}, {64, C::BN, C::NC, 1, 1}, sw))
      return cudaErrorInvalidValue;
    tmq = tmk;
    const int gb = p.G < 64 ? p.G : 64;
    if (q_by_tma(p.G) &&
        !sm90::tile_map(&tmq, bf16, 2, p.q, {D, p.G, p.Sq, p.Hkv, B},
                        {p.qsh, p.qss, p.G * p.qsh, p.qsb}, {64, gb, 64 / gb, 1, 1}, sw))
      return cudaErrorInvalidValue;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)C::SMEM)) != cudaSuccess ||
        (err = device_sms(sms)) != cudaSuccess)
      return err;
    kernel<<<n_items < sms ? n_items : sms, 2 * kWgThreads, C::SMEM, s>>>(p, tmk, tmv, tmk, tmv,
                                                                         tmq);
  } else {
    using C = WgCfg<D>;
    if (p.dv != C::DV) return cudaErrorInvalidValue;
    CUtensorMap tmk, tmv, tmk_tail, tmv_tail;
    if (!kv_map(&tmk, p.k, B, p.Hkv, p.Skv, D, p.ksb, p.ksh, p.kss, C::BN, 64) ||
        !kv_map(&tmv, p.v, B, p.Hkv, p.Skv, C::DV, p.vsb, p.vsh, p.vss, C::BN, 64))
      return cudaErrorInvalidValue;
    tmk_tail = tmk;
    tmv_tail = tmv;
    if (C::TAIL > 0 &&
        (!kv_map(&tmk_tail, p.k, B, p.Hkv, p.Skv, D, p.ksb, p.ksh, p.kss, C::BN, C::TAIL) ||
         !kv_map(&tmv_tail, p.v, B, p.Hkv, p.Skv, C::DV, p.vsb, p.vsh, p.vss, C::BN, C::TAIL)))
      return cudaErrorInvalidValue;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)C::SMEM)) != cudaSuccess)
      return err;
    dim3 grid((p.Sq * p.G + kRows - 1) / kRows, B * p.Hkv);
    if (C::PERSISTENT) {
      if ((err = device_sms(sms)) != cudaSuccess) return err;
      grid = dim3(n_items < sms ? n_items : sms, 1);
    }
    kernel<<<grid, kThreads, C::SMEM, s>>>(p, tmk, tmv, tmk_tail, tmv_tail, tmk);
  }
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

// D = 192 (latent attention's prefill) builds the causal and the full
// instances only: no window and no cap.
cudaError_t dispatch_wgmma192(const Params& p, int B, cudaStream_t s) {
  if (p.window > 0 || p.softcap > 0.f) return cudaErrorInvalidValue;
  if (p.causal) return launch_wgmma<192, true, false, false>(p, B, s);
  return launch_wgmma<192, false, false, false>(p, B, s);
}

template <typename T, int D>
cudaError_t launch_simt(const Params& p, int B, cudaStream_t s) {
  if (!same_layouts(p)) return cudaErrorInvalidValue;
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
// 1 = flash_wgmma (bfloat16, D in {64, 80, 128, 192, 256}); dtype: 0 = float32,
// 1 = bfloat16.  q: (B, Hq = Hkv * G, Sq, D) views with element strides (qsb,
// qsh, qss, 1); k: (B, Hkv, Skv, D) views with strides (ksb, ksh, kss, 1); v:
// (B, Hkv, Skv, Dv) with strides (vsb, vsh, vss, 1); out: (B, Hq, Sq, Dv)
// with strides (osb, osh, oss, 1).  Dv is the instance's: 128 on the wgmma
// path at D = 192 (WgCfg::DV), D elsewhere; flash_simt and the D = 256
// instance take v in k's layout and out in q's alone.  The wgmma path needs
// 16-byte aligned bases and strides.  window <= 0 means no
// window, softcap <= 0 no cap.
extern "C" int flash_attention(int path, int dtype, int D, int Dv, const void* q, const void* k,
                               const void* v, void* out, int B, int Hkv, int G, int Sq, int Skv,
                               long long qsb, long long qsh, long long qss, long long ksb,
                               long long ksh, long long kss, long long vsb, long long vsh,
                               long long vss, long long osb, long long osh, long long oss,
                               int causal, int window, float scale, float softcap, void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || Sq < 1 || Skv < 1 || B * Hkv > 65535)
    return cudaErrorInvalidValue;
  const Params p{q, k, v, out, Sq, Skv, Hkv, G, B * Hkv, D, qsb, qsh, qss, ksb, ksh, kss,
                 causal, window, scale, softcap, Dv, vsb, vsh, vss, osb, osh, oss};
  const auto s = static_cast<cudaStream_t>(stream);
  if (path == 1 && dtype == 1) {
    switch (D) {
      case 64: return dispatch_wgmma<64>(p, B, s);
      case 80: return dispatch_wgmma<80>(p, B, s);
      case 128: return dispatch_wgmma<128>(p, B, s);
      case 192: return dispatch_wgmma192(p, B, s);
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
