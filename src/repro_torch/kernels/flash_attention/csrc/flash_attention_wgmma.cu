// Flash attention forward on Hopper's tensor cores (sm_90a): the bf16 lane
// for (key, value) head dims (64, 64), (128, 128), (256, 256) and
// (192, 128), exported through a plain C interface and
// bound to PyTorch with ctypes (repro_torch/kernels/flash_attention/
// flash_attention.py, which picks this lane or the CUDA-core one in
// flash_attention.cu).
//
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / G, j]) v[b, h / G, j]
//   q (B, H, S, DK), k (B, Hkv, T, DK), v (B, Hkv, T, DV), bf16,
//   contiguous, 16-byte aligned; o (B, H, S, DV) bf16; G = H / Hkv.
//
// The same function as the CUDA-core lane and as the plain version, the
// JAX package's _mask (models/attention.py): causal masking aligned
// top-left (row i sees columns j <= i) for any S and T, widened by a
// prefix (PaliGemma's prefix-LM: every row also sees the columns
// j < prefix), then an optional local window (row i keeps columns
// j > i - window, RecurrentGemma's local_attn layers); masked scores
// -1e30, a row whose denominator is 0 divides by 1. (192, 128) is
// DeepSeek-V3's multi-head latent attention: 128 + 64 rope dims of q and
// k against 128 of v.
//
// Replaces repro/kernels/flash_attention/flash_attention.py::_kernel, which
// walks a sequential (B, H, nq, nk) grid and carries the running max,
// denominator and accumulator in VMEM scratch from one kv step to the next.
//
// What bounds it: operations. At the Yi-6B prefill shape (B = 1, H = 32,
// Hkv = 4, S = T = 2048, D = 128, causal) the work is 34.4 GFLOP (4 H D
// per allowed query-key pair) against 0.05 GB of q, k, v and o: 0.0348 ms
// at the 989 TFLOP/s of dense bf16 on the tensor cores, 0.016 ms of bytes
// at 3.35 TB/s. DeepSeek-V3's MLA prefill (B = 1, H = Hkv = 128,
// S = T = 2048, DK = 192, DV = 128: 2 (DK + DV) = 640 FLOP a pair and
// head) is 171.9 GFLOP, 0.174 ms; PaliGemma-3B's (H = 8, Hkv = 1, D = 256,
// a 256-position prefix) 17.5 GFLOP, 0.0177 ms. So both products run on
// the tensor cores in bf16, and the loads are taken off the threads that
// issue them:
//
// * One thread block per (b, h, 128-row q tile), 384 threads in three
//   warpgroups. Warpgroup 0 is the producer: it gives up registers
//   (setmaxnreg 24) and one of its threads issues every TMA copy. The two
//   consumer warpgroups (setmaxnreg 240) own 64 query rows each. A
//   384-thread block caps every thread at 168 registers as compiled, even
//   under setmaxnreg (and so does a 288-thread block with a producer
//   warp: a partition of the register file holds three of its nine
//   warps); at D = 256 a consumer's 128 floats of O beside S and P need
//   more, so that head dim takes one consumer warpgroup: 256 threads, a
//   64-row q tile, up to 255 registers a thread and no setmaxnreg.
// * TMA with 3-D tensor maps, (DK, S, B*H) for q, (DV, S, B*H) for o,
//   (DK, T, B*Hkv) for k and (DV, T, B*Hkv) for v, so a box never crosses
//   into another head: rows past S or T load as zeros and the store of o
//   drops rows >= S. A bf16 row of 128 columns is 256 bytes, more than
//   the 128-byte swizzle span, so every tile is loaded as panels of 64
//   columns: DK / 64 for q and k, DV / 64 for v and o.
// * A ring of 2 stages of kBK kv rows (K and V), each with a full barrier
//   for K, one for V and an empty barrier; a consumer starts q k^T as
//   soon as K has landed. kBK = 128 at D = 64 and 128; shared memory at
//   D = 128: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB. At D = 256 two
//   stages of 128 rows would take 256 KB beside Q, over the 227 KB a
//   block may use, so kBK = 64 there: Q (64 rows) 32 KB + 2 x (K 32 KB +
//   V 32 KB) = 160 KB, and K and V have an empty barrier each (below); a
//   third stage (224 KB) read no faster on an H100. At (192, 128): Q
//   48 KB + 2 x (K 48 KB + V 32 KB) = 208 KB, so two consumers and
//   kBK = 128 as at D = 128.
// * S = Q K^T is wgmma m64n{kBK}k16 with both operands in shared memory
//   (K-major: DK contiguous as stored), DK / 16 k-steps (12 at DK = 192).
//   O += P V is wgmma m64n{DV}k16 with P from registers: the f32
//   accumulator of S, rounded to bf16 and packed in pairs, is already the
//   register layout of the next product's A operand. V is read MN-major
//   (DV contiguous) with the transpose bit set.
// * The order of a consumer's products and softmax, a template switch
//   (Layout::kSchedule). What bounds the two redesigned pairs of head
//   dims is the consumers' products and softmax, not the loads: on an
//   H100, builds of this kernel with the products and softmax left out
//   ran markedly faster than the whole, and builds with the loads left
//   out almost as long.
//   - (64, 64) and (128, 128), kSerial: a tile's S, wait, softmax, P V,
//     wait; the two consumers run freely.
//   - (192, 128), kPingPong (DeepSeek-V3's MLA): the serial steps, the
//     two consumers taking turns at the tensor cores by two named
//     barriers, so that one's softmax runs under the other's products.
//     A turn is P V of one tile and S of the next; P is dead before S is
//     issued, so a thread holds no more than the serial schedule's 168
//     registers. The overlapped order below needs S and P at once (64 +
//     32 beside O's 64) and spilled there, serialising every wgmma; at
//     kBK = 64 it fit but read slower (S's m64n64 products read twice
//     the shared memory per operation).
//   - (256, 256), kOverlapped (RecurrentGemma-2B, PaliGemma-3B; one
//     consumer, so nothing else fills the tensor cores during its
//     softmax): FlashAttention-3's intra-warpgroup overlap, S of tile j
//     and P V of tile j - 1 issued together and tile j's softmax run
//     under P V. O 128 + S 32 floats + P 16 registers; 207 as compiled.
//     Issuing S of tile j + 1 before tile j's softmax as well (two S
//     sets, 208 registers of values) spilled at 255.
//   Both redesigned schedules take exp2 as ex2.approx.ftz. Every schedule
//   adds a row's tiles into O in kv order, O rescaled before the next
//   tile's P V, so the function is the same, bit for bit, with and
//   without the log-sum-exp, and a window wider than the sequence or a
//   prefix of 1 changes no bit.
// * The softmax stays in f32 registers: the 4 threads that share a row in
//   the accumulator layout reduce its max and sum by shuffles; exp2f on
//   scores pre-scaled by scale * log2(e); O is rescaled only when a row's
//   max moves. The causal and column (j >= T) masks are applied only on
//   tiles that cross the diagonal or the tail; causal blocks skip whole
//   tiles past their last row. Blocks run in groups of heads whose k and
//   v fit in L2 together (hopper.cuh's block_tile), the longest tiles of
//   a group first: at DeepSeek-V3's 128 kv heads k and v are 168 MB, and
//   an order that runs every head's q tile t before any head's t - 1
//   reads them from device memory once per q tile (0.517 ms a prefill,
//   0.342 in groups of 19 heads; H100 80GB HBM3 at 700 W,
//   tools/time_flash.py); where every head's k and v fit, the group is
//   all heads, longest tiles first. With a
//   prefix the kv loop runs to the later of the tile of the last row and
//   the tile of column prefix - 1, and the diagonal's mask spares the
//   columns j < prefix: a tile wholly inside the prefix is not masked.
//   With a window, a q tile starting at row q0 begins its kv loop at the
//   tile of column max(0, q0 - window + 1), and the window's mask is
//   applied only on the tiles that cross its lower edge; window = 0 (none)
//   and prefix = 0 keep the causal path's loop bounds and masks as they
//   were.
// * Epilogue: O / l in bf16 is staged, swizzled, over the warpgroup's own
//   rows of the Q tile (DV <= DK: its DV / 64 panels fit in Q's) and
//   written with one TMA store per panel. For training (the LSE
//   instantiations) each row's base-2 log-sum-exp goes to a float32
//   (B, H, S) array too, which the tensor-core backward
//   (flash_attention_bwd_wgmma.cu) reads in place of rebuilding it.
//
// The tensor maps are encoded on the host at every call; the driver's
// cuTensorMapEncodeTiled is taken through cudaGetDriverEntryPointByVersion,
// so the library is not linked against libcuda.

#include <cstdint>

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kPanel = 64;     // bf16 columns per 128-byte swizzled panel
constexpr int kPanelRow = 128; // bytes per panel row
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// How a consumer warpgroup orders its products and its softmax (see the
// note at the top).
enum Schedule { kSerial, kPingPong, kOverlapped };

// The ping-pong's named barriers: consumer c waits on kTurn + c for its
// turn at the tensor cores (ids 1 and 2 are the epilogue's)
constexpr int kTurn = 3;

template <int DK, int DV>
struct Layout {
  static constexpr Schedule kSchedule =
      DK == 256 ? kOverlapped : DK == 192 ? kPingPong : kSerial;
  // consumer warpgroups of 64 q rows each: one at D = 256, where a thread
  // needs more registers than a 384-thread block leaves it
  static constexpr int kConsumers = DK == 256 ? 1 : 2;
  static constexpr int kThreads = 128 * (1 + kConsumers);  // + producer
  static constexpr int kBQ = 64 * kConsumers;   // q rows per block
  // kv rows per ring stage: two stages of 128 rows do not fit at D = 256
  static constexpr int kBK = DK == 256 ? 64 : 128;
  static constexpr int kStages = 2;
  // the overlapped schedule reads K of one tile and V of the one before at
  // once, so it frees K once S has run and V once P V has; the others
  // free a stage's K and V together
  static constexpr bool kSplitRelease = kSchedule == kOverlapped;
  // the redesigned schedules take exp2 as the SFU's ex2.approx.ftz: exp2f
  // adds a denormal range check to every score
  static constexpr bool kFastExp = kSchedule != kSerial;
  static constexpr int kPanelsK = DK / kPanel;  // of q and k
  static constexpr int kPanelsV = DV / kPanel;  // of v and o
  static constexpr int kQBytes = kBQ * DK * 2;
  static constexpr int kKBytes = kBK * DK * 2;  // one K tile
  static constexpr int kVBytes = kBK * DV * 2;  // one V tile
  // Q | K[kStages] | V[kStages] | barriers, each tile 1024-byte aligned;
  // panel p of a tile of R rows starts at p * R * 128
  static constexpr int kQOff = 0;
  static constexpr int kKOff = kQOff + kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKBytes;
  static constexpr int kBarOff = kVOff + kStages * kVBytes;
  static constexpr int kBars = 1 + (kSplitRelease ? 4 : 3) * kStages;
  static constexpr int kSmem = kBarOff + 8 * kBars + 1024;  // align slack
  static_assert(DV <= DK, "o is staged over the q tile");
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db, 1);
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db, 1);
}

template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n256(o, a, db, 1);
}

// One k-step of S = Q K^T over a kv tile of BK rows.
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&s)[BK / 2], uint64_t da,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_qk<128>(float (&s)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  wgmma_ss_n128(s, da, db, scale_d);
}

template <>
__device__ __forceinline__ void wgmma_qk<64>(float (&s)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_ss_n64(s, da, db, scale_d);
}

// 2^x on the SFU, subnormal results flushed to 0 (p below 2^-126 of its
// row's max).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// What one consumer warpgroup's kv loop reads: the ring, its barriers,
// the loop's bounds and the masks' arguments.
template <int DK, int DV>
struct Ring {
  using L = Layout<DK, DV>;
  __device__ __forceinline__ static float exp2_(float x) {
    if constexpr (L::kFastExp)
      return ex2_ftz(x);
    else
      return exp2f(x);
  }
  // bars: q_full, then by stage k_full, v_full, empty (K, or K and V
  // where they are freed at once), v_empty
  uint32_t sK, sV, bars;
  uint64_t dq;            // this warpgroup's rows of Q
  int kt0, n_kv;          // the loop's first and last + 1 kv tiles
  int r0, row0, col0;     // the warpgroup's first row; a thread's (below)
  int T, causal, window, prefix;
  float scale_log2;

  __device__ __forceinline__ uint32_t k_full(int st) const {
    return bars + 8u * (1 + st);
  }
  __device__ __forceinline__ uint32_t v_full(int st) const {
    return bars + 8u * (1 + L::kStages + st);
  }
  __device__ __forceinline__ uint32_t empty(int st) const {
    return bars + 8u * (1 + 2 * L::kStages + st);
  }
  __device__ __forceinline__ uint32_t v_empty(int st) const {
    return bars + 8u * (1 + 3 * L::kStages + st);
  }
  // the ring's stage and phase of kv tile kt, counted from kt0
  __device__ __forceinline__ int stage(int kt) const {
    return (kt - kt0) % L::kStages;
  }
  __device__ __forceinline__ uint32_t parity(int kt) const {
    return ((kt - kt0) / L::kStages) & 1;
  }

  // S = Q K^T of tile kt, once its K has landed: DK / 16 k-steps, 4 per
  // 64-column panel; one commit group
  __device__ __forceinline__ void issue_qk(float (&s)[L::kBK / 2],
                                           int kt) const {
    constexpr int kBK = L::kBK;
    const int st = stage(kt);
    const uint64_t dk = make_desc(sK + st * L::kKBytes, 16, 1024);
    mbar_wait(k_full(st), parity(kt));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {
      const uint32_t qoff = (ks / 4) * L::kBQ * kPanelRow + (ks % 4) * 32;
      const uint32_t koff = (ks / 4) * kBK * kPanelRow + (ks % 4) * 32;
      wgmma_qk<kBK>(s, dq + (qoff >> 4), dk + (koff >> 4), ks > 0);
    }
    wgmma_commit();
  }

  // O += P V of tile kt, once its V has landed: kBK / 16 k-steps of 16 kv
  // rows (2048 bytes) each; the DV / 64 panels of V are kBK * 128 bytes
  // apart (LBO). One commit group
  __device__ __forceinline__ void issue_pv(float (&o)[DV / 2],
                                           const uint32_t (&pa)[L::kBK / 16]
                                                               [4],
                                           int kt) const {
    constexpr int kBK = L::kBK;
    const int st = stage(kt);
    const uint64_t dv = make_desc(sV + st * L::kVBytes, kBK * kPanelRow,
                                  1024);
    mbar_wait(v_full(st), parity(kt));
    wgmma_fence();
    fence_operands(o);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_pv<DV>(o, pa[kk], dv + ((kk * 16 * kPanelRow) >> 4));
    wgmma_commit();
  }

  // The masks of tile kt, only where it crosses the kv tail or the
  // diagonal past the prefix (columns j < prefix are seen by every row),
  // and the window's, only where it crosses its lower edge for one of the
  // warpgroup's 64 rows. A row may see no column of such a tile: its p are
  // then 1 over a max of -1e30, and the next tile's real max rescales them
  // to 0 (every row sees its own column)
  template <bool PREFIX>
  __device__ __forceinline__ void mask(float (&s)[L::kBK / 2],
                                       int kt) const {
    constexpr int kBK = L::kBK;
    const int k0 = kt * kBK;
    if (k0 + kBK > T ||
        (causal && k0 + kBK - 1 > r0 && (!PREFIX || k0 + kBK > prefix))) {
#pragma unroll
      for (int r = 0; r < kBK / 2; ++r) {
        const int col = k0 + 8 * (r / 4) + col0 + (r % 2);
        const int row = row0 + 8 * ((r % 4) / 2);
        if (col >= T || (causal && col > row && (!PREFIX || col >= prefix)))
          s[r] = kNegInf;
      }
    }
    if (window > 0 && k0 <= r0 + 63 - window) {
#pragma unroll
      for (int r = 0; r < kBK / 2; ++r) {
        const int col = k0 + 8 * (r / 4) + col0 + (r % 2);
        const int row = row0 + 8 * ((r % 4) / 2);
        if (col <= row - window) s[r] = kNegInf;
      }
    }
  }

  // Online softmax of one masked tile: s becomes p, m and l move on;
  // alpha is the factor O's rows take, and the result whether any of this
  // thread's rows' max moved. A row's 4 threads are lanes 4 (lane / 4) +
  // [0, 4)
  __device__ __forceinline__ bool softmax(float (&s)[L::kBK / 2],
                                          float (&m)[2], float (&l)[2],
                                          float (&alpha)[2]) const {
    constexpr int kBK = L::kBK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int r = 0; r < kBK / 2; ++r)
      mx[(r % 4) / 2] = fmaxf(mx[(r % 4) / 2], s[r]);
    float msc[2], rsum[2] = {0.f, 0.f};
    bool moved = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2_((m[h] - mx[h]) * scale_log2);
      moved |= mx[h] != m[h];
      m[h] = mx[h];
      // a row that has seen only masked columns (a window's first tile)
      // takes p = exp2(-1e30 scale) = 0: with msc = -1e30 scale, the fma
      // below would leave the product's rounding error, up to 2^72
      msc[h] = mx[h] == kNegInf ? 0.f : mx[h] * scale_log2;
    }
#pragma unroll
    for (int r = 0; r < kBK / 2; ++r) {
      const float p = exp2_(fmaf(s[r], scale_log2, -msc[(r % 4) / 2]));
      s[r] = p;
      rsum[(r % 4) / 2] += p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rsum[h];
    return moved;
  }
};

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < N; ++r) o[r] *= alpha[(r % 4) / 2];
}

// P in bf16: k-step kk of P V takes accumulator columns [16 kk, 16 kk +
// 16), registers 8 kk .. 8 kk + 7
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// kSerial: each tile's S, its softmax and its P V in turn, each product
// waited for before the next step; the two consumers run freely.
// kPingPong (TURNS): the same steps, the two consumers taking turns at the
// tensor cores. Consumer c's turn is a named barrier (kTurn + c) that the
// other consumer arrives on once it has issued its products: in its turn
// a consumer issues P V of its last tile and, once that has run, S of its
// next, then hands the turn over and runs that tile's softmax while the
// other consumer's products run. P is dead before S is issued, so a
// thread holds no more than the serial schedule does. Each takes n + 1
// turns over n tiles; consumer 0 takes the first, so consumer 1 lets it
// pass at the start, and consumer 0 hands over once more at the end.
template <bool PREFIX, bool TURNS, int DK, int DV>
__device__ __forceinline__ void kv_serial(const Ring<DK, DV>& x, int c,
                                          float (&o)[DV / 2], float (&m)[2],
                                          float (&l)[2]) {
  constexpr int kBK = Layout<DK, DV>::kBK;
  const int mine = kTurn + c, other = kTurn + 1 - c;
  if constexpr (TURNS) {
    if (c == 1) named_barrier_arrive(other, 256);
    named_barrier(mine, 256);
  }
  for (int kt = x.kt0; kt < x.n_kv; ++kt) {
    float s[kBK / 2];
    x.issue_qk(s, kt);
    if constexpr (TURNS) named_barrier_arrive(other, 256);
    wgmma_wait<0>();
    fence_operands(s);
    x.template mask<PREFIX>(s, kt);
    float alpha[2];
    if (x.softmax(s, m, l, alpha)) rescale(o, alpha);
    uint32_t pa[kBK / 16][4];
    pack_p<kBK>(pa, s);
    if constexpr (TURNS) named_barrier(mine, 256);
    x.issue_pv(o, pa, kt);
    wgmma_wait<0>();
    fence_operands(o);
    mbar_arrive(x.empty(x.stage(kt)));
  }
  if constexpr (TURNS) {
    if (c == 0) named_barrier_arrive(other, 256);
  }
}

// kOverlapped, one consumer (FlashAttention-3's intra-warpgroup overlap):
// it issues S of tile j and P V of tile j - 1 together, then runs tile
// j's softmax while P V runs. O is rescaled between the two P Vs, so tiles
// are added into O in kv order and rescaled as the serial schedule does.
// Every wait is in straight-line code: ptxas serialises every wgmma of a
// kernel where a path may read an accumulator or P before the wait that
// retires its product.
template <bool PREFIX, int DK, int DV>
__device__ __forceinline__ void kv_overlapped(const Ring<DK, DV>& x,
                                              float (&o)[DV / 2],
                                              float (&m)[2], float (&l)[2]) {
  constexpr int kBK = Layout<DK, DV>::kBK;
  float s[kBK / 2], alpha[2];
  uint32_t pa[kBK / 16][4];
  x.issue_qk(s, x.kt0);
  wgmma_wait<0>();
  fence_operands(s);
  mbar_arrive(x.empty(x.stage(x.kt0)));
  x.template mask<PREFIX>(s, x.kt0);
  x.softmax(s, m, l, alpha);  // O is 0: nothing to rescale
  pack_p<kBK>(pa, s);
  for (int kt = x.kt0 + 1; kt < x.n_kv; ++kt) {
    x.issue_qk(s, kt);
    x.issue_pv(o, pa, kt - 1);
    wgmma_wait<1>();  // S of tile kt has run
    fence_operands(s);
    mbar_arrive(x.empty(x.stage(kt)));
    x.template mask<PREFIX>(s, kt);
    const bool moved = x.softmax(s, m, l, alpha);
    wgmma_wait<0>();  // and P V of tile kt - 1
    fence_operands(o);
    fence_operands(pa);
    mbar_arrive(x.v_empty(x.stage(kt - 1)));
    if (moved) rescale(o, alpha);
    pack_p<kBK>(pa, s);
  }
  x.issue_pv(o, pa, x.n_kv - 1);
  wgmma_wait<0>();
  fence_operands(o);
}

// PREFIX: a prefix-LM mask (prefix > 0) is compiled apart, so that the
// causal path's loop bounds and masks stay as they were without one (its
// tests cost the causal path 4% at D = 256, H100 80GB HBM3 at 700 W,
// tools/time_flash.py). LSE: the training forward also writes each row's
// base-2 log-sum-exp of the scaled scores, m scale log2(e) + log2(l), as
// float32 (B, H, S) into `lse` for the backward; inference compiles
// without it and leaves `lse` unread.
template <int DK, int DV, bool PREFIX, bool LSE>
__global__ void __launch_bounds__(Layout<DK, DV>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o,
                       float* __restrict__ lse, int H, int Hkv, int S, int T,
                       float scale_log2, int causal, int window, int prefix,
                       int group) {
  using L = Layout<DK, DV>;
  constexpr int kBK = L::kBK;
  constexpr int kBQ = L::kBQ;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQOff;
  const uint32_t sK = base + L::kKOff;
  const uint32_t sV = base + L::kVOff;
  const uint32_t q_full = base + L::kBarOff;
  auto k_full = [&](int st) { return q_full + 8u * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8u * (1 + kStages + st); };
  auto empty = [&](int st) { return q_full + 8u * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) {
    return q_full + 8u * (1 + 3 * kStages + st);
  };

  const int nq = (S + kBQ - 1) / kBQ;
  int qt, bh;  // bh = b * H + h; neighbours share a kv head
  block_tile(nq, gridDim.x / nq, group, causal, qt, bh);
  const int bhk = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int q0 = qt * kBQ;
  const int nk = (T + kBK - 1) / kBK;
  // causal: up to the tile of the block's last row or of the prefix's last
  // column, whichever is later
  const int last = PREFIX ? max(q0 + kBQ - 1, prefix - 1) : q0 + kBQ - 1;
  const int n_kv = causal ? min(nk, last / kBK + 1) : nk;
  // the first kv tile the window reaches (0 without a window); the ring's
  // stage and phase count from it
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      // every consumer thread releases
      mbar_init(empty(st), L::kConsumers * 128);
      if constexpr (L::kSplitRelease)
        mbar_init(v_empty(st), L::kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    if constexpr (L::kConsumers == 2) reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int p = 0; p < L::kPanelsK; ++p)
        tma_load_3d(sQ + p * kBQ * kPanelRow, &tm_q, q_full, p * kPanel, q0,
                    bh);
      for (int kt = kt0; kt < n_kv; ++kt) {
        const int st = (kt - kt0) % kStages;
        // the first round finds every stage empty (parity 1 passes)
        const uint32_t parity = (((kt - kt0) / kStages) & 1) ^ 1;
        mbar_wait(empty(st), parity);
        const uint32_t k_dst = sK + st * L::kKBytes;
        const uint32_t v_dst = sV + st * L::kVBytes;
        mbar_expect_tx(k_full(st), L::kKBytes);
#pragma unroll
        for (int p = 0; p < L::kPanelsK; ++p)
          tma_load_3d(k_dst + p * kBK * kPanelRow, &tm_k, k_full(st),
                      p * kPanel, kt * kBK, bhk);
        if constexpr (L::kSplitRelease) mbar_wait(v_empty(st), parity);
        mbar_expect_tx(v_full(st), L::kVBytes);
#pragma unroll
        for (int p = 0; p < L::kPanelsV; ++p)
          tma_load_3d(v_dst + p * kBK * kPanelRow, &tm_v, v_full(st),
                      p * kPanel, kt * kBK, bhk);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (L::kConsumers == 2) reg_alloc<kConsumerRegs>();
    const int c = wg - 1;  // this warpgroup's rows: q0 + 64 c + [0, 64)
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    // accumulator layout: register r of a thread sits at row
    // 16 warp + lane / 4 + 8 ((r % 4) / 2), column 8 (r / 4) + 2 (lane % 4)
    // + r % 2 of the warpgroup's 64-row tile
    const int row0 = q0 + 64 * c + 16 * warp + lane / 4;
    const int col0 = 2 * (lane % 4);
    const Ring<DK, DV> x{sK,         sV,     q_full,
                         make_desc(sQ + 64 * c * kPanelRow, 16, 1024),
                         kt0,        n_kv,   q0 + 64 * c,
                         row0,       col0,   T,
                         causal,     window, prefix,
                         scale_log2};

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    if constexpr (L::kSchedule == kOverlapped)
      kv_overlapped<PREFIX>(x, o, m, l);
    else
      kv_serial<PREFIX, L::kSchedule == kPingPong>(x, c, o, m, l);

    // epilogue: O / l in bf16, staged 128B-swizzled over this warpgroup's
    // rows of the Q tile (no other warpgroup reads them), one TMA store of
    // a 64 x 64 box per panel
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = l[h] == 0.f ? 1.f : 1.f / l[h];
    }
    if constexpr (LSE) {
      // a row's 4 threads hold the same m and l; one writes
      if ((lane & 3) == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row < S)
            lse[(long long)bh * S + row] =
                l[h] > 0.f ? m[h] * scale_log2 + log2f(l[h]) : 0.f;
        }
      }
    }
    const uint32_t so = sQ + 64 * c * kPanelRow;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + col0;  // within DV
      const uint32_t panel = so + (col / kPanel) * kBQ * kPanelRow;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * warp + lane / 4 + 8 * h;  // within the 64
        const uint32_t chunk = ((col % kPanel) / 8) ^ (row % 8);
        st_shared_u32(panel + row * kPanelRow + chunk * 16 + (col % 8) * 2,
                      pack_bf16(o[4 * j + 2 * h] * inv[h],
                                o[4 * j + 2 * h + 1] * inv[h]));
      }
    }
    fence_proxy_async();
    named_barrier(1 + c, 128);
    if (tid == 0 && q0 + 64 * c < S) {
#pragma unroll
      for (int p = 0; p < L::kPanelsV; ++p)
        tma_store_3d(&tm_o, so + p * kBQ * kPanelRow, p * kPanel,
                     q0 + 64 * c, bh);
      tma_store_commit_and_wait();
    }
  }
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int S, int T, float scale, bool causal,
           int window, int prefix, cudaStream_t stream) {
  using L = Layout<DK, DV>;
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kErrNoEncode;
  CUtensorMap tq, tk, tv, to;
  int err = encode(fn, &tq, q, DK, S, B * H, L::kBQ);
  if (!err) err = encode(fn, &tk, k, DK, T, B * Hkv, L::kBK);
  if (!err) err = encode(fn, &tv, v, DV, T, B * Hkv, L::kBK);
  if (!err) err = encode(fn, &to, o, DV, S, B * H, 64);
  if (err) return err;
  constexpr int smem = L::kSmem;
  auto kernel =
      lse != nullptr
          ? (prefix > 0 ? flash_fwd_wgmma_kernel<DK, DV, true, true>
                        : flash_fwd_wgmma_kernel<DK, DV, false, true>)
          : (prefix > 0 ? flash_fwd_wgmma_kernel<DK, DV, true, false>
                        : flash_fwd_wgmma_kernel<DK, DV, false, false>);
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  const int nq = (S + L::kBQ - 1) / L::kBQ;
  if ((long long)nq * B * H > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int group = l2_heads(B * H, H / Hkv, T, DK, DV, 2);
  kernel<<<nq * B * H, L::kThreads, smem, stream>>>(
      tq, tk, tv, to, lse, H, Hkv, S, T, scale * kLog2e, causal ? 1 : 0,
      window, prefix, group);
  return (int)cudaGetLastError();
}

// Registers, shared bytes (static and a launch's dynamic), local (spilled)
// bytes and resident blocks an SM of one instantiation, into out[0 .. 3].
template <int DK, int DV, bool PREFIX, bool LSE>
bool attrs(int* out) {
  using L = Layout<DK, DV>;
  const void* fn =
      reinterpret_cast<const void*>(flash_fwd_wgmma_kernel<DK, DV, PREFIX, LSE>);
  cudaFuncAttributes a;
  int blocks = 0;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::kSmem) != cudaSuccess ||
      cudaFuncGetAttributes(&a, fn) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, L::kThreads,
                                                    L::kSmem) != cudaSuccess)
    return false;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes + L::kSmem;
  out[2] = (int)a.localSizeBytes;
  out[3] = blocks;
  return true;
}

template <int DK, int DV>
bool attrs_of(int variant, int* out) {
  switch (variant) {
    case 0: return attrs<DK, DV, false, false>(out);
    case 1: return attrs<DK, DV, true, false>(out);
    case 2: return attrs<DK, DV, false, true>(out);
    default: return attrs<DK, DV, true, true>(out);
  }
}

}  // namespace

extern "C" {

// Registers, shared bytes (static and a launch's dynamic), local (spilled)
// bytes and resident blocks an SM (out[0 .. 3]) of instantiation i: the
// (DK, DV) pair i / 4 of (64, 64), (128, 128), (256, 256), (192, 128),
// and i % 4 the variant: 0 inference, 1 with a prefix, 2 with the
// log-sum-exp, 3 both. Returns its name ("256x256", "256x256 prefix",
// "256x256 lse", "256x256 prefix lse"), or null past the last or where
// the runtime refuses the query.
const char* flash_attention_wgmma_kernel_attrs(int i, int* out) {
  static const char* const kNames[16] = {
      "64x64", "64x64 prefix", "64x64 lse", "64x64 prefix lse",
      "128x128", "128x128 prefix", "128x128 lse", "128x128 prefix lse",
      "256x256", "256x256 prefix", "256x256 lse", "256x256 prefix lse",
      "192x128", "192x128 prefix", "192x128 lse", "192x128 prefix lse"};
  if (i < 0 || i >= 16) return nullptr;
  bool ok;
  switch (i / 4) {
    case 0: ok = attrs_of<64, 64>(i % 4, out); break;
    case 1: ok = attrs_of<128, 128>(i % 4, out); break;
    case 2: ok = attrs_of<256, 256>(i % 4, out); break;
    default: ok = attrs_of<192, 128>(i % 4, out); break;
  }
  return ok ? kNames[i] : nullptr;
}

// Returns 0 on success, a cudaError_t after the launch, or an error of the
// tensor-map encode (see flash_attention_wgmma_error_string). The caller
// checks shapes, types and alignment: bf16, (DK, DV) in {(64, 64),
// (128, 128), (256, 256), (192, 128)}, H % Hkv == 0, S, T >= 1,
// contiguous tensors on 16-byte boundaries; window 0 (none) or >= 1 with
// S <= T + window - 1; prefix >= 0 (0: none; read only when causal);
// lse null, or B * H * S floats that take each row's base-2 log-sum-exp.
int flash_attention_wgmma_launch(const void* q, const void* k,
                                 const void* v, void* o, void* lse, int B,
                                 int H, int Hkv, int S, int T, int DK,
                                 int DV, float scale, int causal, int window,
                                 int prefix, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || S < 1 || T < 1 ||
      window < 0 || (window > 0 && S > T + window - 1) || prefix < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  float* l = static_cast<float*>(lse);
  if (DK == 64 && DV == 64)
    return launch<64, 64>(q, k, v, o, l, B, H, Hkv, S, T, scale, c,
                          window, prefix, s);
  if (DK == 128 && DV == 128)
    return launch<128, 128>(q, k, v, o, l, B, H, Hkv, S, T, scale, c,
                            window, prefix, s);
  if (DK == 256 && DV == 256)
    return launch<256, 256>(q, k, v, o, l, B, H, Hkv, S, T, scale, c,
                            window, prefix, s);
  if (DK == 192 && DV == 128)
    return launch<192, 128>(q, k, v, o, l, B, H, Hkv, S, T, scale, c,
                            window, prefix, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_wgmma_error_string(int err) {
  if (err == kErrNoEncode)
    return "the driver has no cuTensorMapEncodeTiled entry point";
  if (err >= kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
