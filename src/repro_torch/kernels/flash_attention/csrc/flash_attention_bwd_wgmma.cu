// Flash attention backward on Hopper's tensor cores (sm_90a): the bf16 lane
// of the gradient at (key, value) head dims (64, 64), (128, 128) and
// (256, 256), exported through a plain C interface and bound to PyTorch
// with ctypes (repro_torch/kernels/flash_attention/flash_attention.py,
// flash_attention_bwd, which picks this lane or the CUDA-core one in
// flash_attention_bwd.cu by `bwd_lane`).
//
//   o = softmax(scale * q k^T) v, masked; given o, dO = dL/do and, where
//   the forward saved it, each row's base-2 log-sum-exp lse:
//   P     = exp2(scale log2(e) q_i . k_j - lse_i)      (the forward's weights)
//   dP    = dO v^T
//   Delta = rowsum(dO o)                                (= rowsum(P dP))
//   dS    = P (dP - Delta)
//   dq = scale dS k,   dk = scale dS^T q,   dv = P^T dO
//
//   q (B, H, S, D), k, v (B, Hkv, T, D), o, dO (B, H, S, D), bf16,
//   contiguous, 16-byte aligned; lse (B, H, S) float32 or null; dq, dk, dv
//   bf16 in the layouts of q, k and v. G = H / Hkv query heads read kv
//   head h / G in place, so dk and dv of a kv head sum over its G heads.
//   Masking is the forward's (the JAX package's _mask): causal aligned
//   top-left for any S and T, widened by a prefix, an optional window, and
//   the ragged tails of q and kv masked in the kernel.
//
// Replaces no TPU kernel: the Pallas flash kernel (repro/kernels/
// flash_attention/flash_attention.py) has no backward, and the JAX package
// differentiates its jnp flash loop (models/attention.py::flash_attn_jnp)
// by XLA. It is the tensor-core redesign of flash_attention_bwd.cu, which
// stays as the lane of float32 and of bf16 at other head dims.
//
// What bounds it: operations. The gradient's own work is 4 (Dk + Dv) FLOP
// a visible (query, key) pair (dP, dS k, dS^T q, P^T dO): at SmolLM-360M's
// training shape (B = 8, H = 15, Hkv = 5, S = T = 2048, D = 64, causal)
// 1.289e11 FLOP, 0.130 ms at bf16's 989 TFLOP/s, against 0.03 ms of bytes;
// at RecurrentGemma-2B's (B = 1, H = 10, Hkv = 1, S = T = 4096, D = 256,
// window 2048: 6,292,480 pairs a head) 1.289e11 FLOP, 0.130 ms. So every
// product runs on the tensor cores (wgmma, bf16 operands, f32 sums) and
// the tiles arrive by TMA into shared-memory rings, as in the forward
// (flash_attention_wgmma.cu), in three launches on one stream. A block is
// a producer warpgroup (one thread issues every TMA copy) and consumers(D)
// consumer warpgroups of 64 rows (launch B) or 64 keys (launch A) each:
// two at D = 64 and 128 (384 threads; setmaxnreg gives the producer 24
// registers and each consumer 240), one at D = 256 (256 threads, up to 255
// registers a thread, no setmaxnreg). At D = 256 a 64-row f32 accumulator
// is 128 registers a thread, and a 384-thread block caps ptxas at 168 (as
// in the forward), so one consumer warpgroup a block; and the 128-row
// tiles of the two-consumer layouts would not fit in shared memory there
// either (launch B: Q and dO 2 x 64 KB beside a ring of K and V, 4 x
// 32 KB).
//
// * Launch B, dq (flash_bwd_dq_wgmma_kernel), first. One block per
//   (b, h, q tile of 64 consumers(D) rows), ordered as the forward's
//   (hopper.cuh's block_tile). Q and dO of the tile are resident; K and V
//   stream through a 2-stage ring of 64 keys (128-key stages spill at
//   D = 64: S and dP would be 64 + 64 floats a thread beside dQ's; at
//   D = 256: Q, dO 32 KB each + 2 x (K, V 32 KB each) = 192 KB, and a
//   consumer thread holds dQ's 128 floats beside 32 + 32 of S and dP).
//   Each consumer forms its
//   rows' Delta from o and dO in device memory (the 4 threads of a row
//   read interleaved 16-byte chunks, then two shuffles), and takes the
//   rows' lse from the forward or, without one, rebuilds it by a first
//   pass over the kv tiles: S = Q K^T only and an online max and sum, one
//   product a pair on the tensor cores (K alone arrives through the ring).
//   Per kv tile: S = Q K^T and dP = dO V^T (both operands in shared
//   memory, K-major as stored) in two commit groups, P from S while dP is
//   still running, dS = P (dP - Delta) rounded to bf16 and packed as the
//   register A operand (the accumulator layout is the A layout, as the
//   forward feeds P to P V), dQ += dS K with K read MN-major (transpose
//   bit), as the forward reads V. dQ scale in bf16 leaves through the
//   Q tile's own rows by TMA. The block also writes its rows' lse and
//   Delta, f32, into a workspace padded to 128 rows a head, for launch A.
// * Launch A, dk and dv (flash_bwd_dkv_wgmma_kernel). One block per
//   (b, kv head, head split, key tile of 64 consumers(D) keys), longest
//   first (causal: tile 0 sees every q row); each consumer owns 64
//   keys. K and V of the tile stay in shared memory; Q, dO (64 rows) and
//   their rows' lse and Delta (two 256-byte bulk copies from the
//   workspace) stream through a 2-stage ring, over the split's query heads
//   and the q tiles that see the tile (from the diagonal's tile unless the
//   prefix reaches the key tile, to the window's last row). Per q tile:
//   S^T = K Q^T and dP^T = V dO^T in two commit groups; P^T = exp2(S^T c -
//   lse) and dS^T = P^T (dP^T - Delta) in f32 registers; dV += P^T dO and
//   dK += dS^T Q with P^T and dS^T as bf16 register A operands and dO and
//   Q read MN-major. At D = 128 dK and dV would be 64 + 64 floats a
//   thread beside 32 + 32 of S^T and dP^T, more than a thread of a
//   384-thread block gets (a one-pass build spills and runs slower on an
//   H100), and at D = 256 they would be 128 + 128, more than the 255 a
//   thread may have; so there the q tiles stream twice, dK
//   accumulated in the first pass and dV in the second (one more S^T
//   product a pair; column halves of dK and dV, one a pass, would
//   recompute both S^T and dP^T in each pass). dK scale and dV leave
//   through the V and K tiles' own rows by TMA (in the two-pass order, V
//   is done with when dK is). (192, 128), DeepSeek-V3's MLA, stays on
//   the CUDA-core lane: no path of the port trains it.
// * Grid size: a head split divides the G query heads of a kv head among
//   `nsplit` blocks, the least divisor of G that gives launch A at least
//   two blocks an SM (264 on an H100), else G. With one split dk and dv
//   are written in bf16 directly; with more, each block writes float32
//   partials into the workspace and launch C (flash_bwd_dkv_sum_kernel)
//   adds them in split order and rounds. SmolLM-360M (B Hkv = 40, 16 key
//   tiles: 640 blocks) and Whisper-base take one split; Yi-6B's timed
//   shape (B Hkv = 4: 64 blocks on 132 SMs) takes 8; RecurrentGemma-2B's
//   (one kv head, G = 10, 64 key tiles of 64 at T = 4096) takes 5.
// * Windows: launch B's kv loop starts at the tile of the window's first
//   column for the block's first row, and launch A's q loop stops at the
//   tile of the window's last row for the block's last key, so the tiles
//   wholly outside the window (half the causal ones at RecurrentGemma-2B's
//   shape) are never loaded or computed.
// * Deterministic, no atomics: every output element is written by one
//   thread and summed in a fixed order, so two runs agree bit for bit.
//   FA2/FA3 do 5 products a pair, accumulating dq by atomics in launch
//   A; recomputing S and dP in launch B costs 7 products a pair instead
//   (2 (4 Dk + 3 Dv) FLOP, 1.75x the gradient's own 4 (Dk + Dv); 8 in the
//   two-pass order) and keeps repeats bit for bit.
// * Masks only where a tile crosses the causal diagonal past the prefix,
//   the window's lower edge or a ragged tail. A consumer runs the products
//   of a tile none of its pairs sees too (the mask zeroes it): a wgmma
//   under a branch on the consumer's rows is a divergent path to ptxas,
//   which then serialises every wgmma of the kernel. P is 2^x by the
//   SFU's ex2.approx.ftz (exp2f ran slower).
// * Tried on an H100 and dropped (slower, or no gain): issuing a tile's
//   S and dP before waiting for the tile before's last products, launch
//   A's blocks in groups of heads whose Q and dO fit in L2, rings of 3 or
//   4 stages, 128-key stages in launch B, and a producer warp in place of
//   the producer warpgroup. At D = 256: two consumer warpgroups sharing
//   launch A's 64 keys, one accumulating dK and one dV over one stream of
//   q tiles (half the Q and dO traffic of the two passes): ptxas compiles
//   a 384-thread block to 168 registers a thread even under setmaxnreg,
//   so it spilled and serialised every wgmma. A block's tiles come from
//   L2 at 3.7-4.2 TB/s at RecurrentGemma-2B's shape on an H100
//   (chip_smoke.py's "its launches" line): the next step is TMA multicast
//   across a
//   cluster of blocks that read the same K and V (launch B: the q heads
//   of one kv head) or the same Q and dO (launch A: neighbouring key
//   tiles).

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kPanel = 64;     // bf16 columns per 128-byte swizzled panel
constexpr int kPanelRow = 128; // bytes per panel row
constexpr int kStages = 2;     // ring stages (3 or 4 gained nothing)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kRowPad = 128;   // the workspace's rows a head: S padded
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Consumer warpgroups a block: one at D = 256, where a thread's 128 floats
// of one accumulator beside S and dP need more registers than a 384-thread
// block leaves it; two elsewhere.
__host__ __device__ constexpr int consumers(int D) { return D == 256 ? 1 : 2; }
__host__ __device__ constexpr int block_threads(int D) { return 128 * (1 + consumers(D)); }

// Launch B: Q | dO | K[kStages] | V[kStages] | barriers, each tile
// 1024-byte aligned; panel p of a tile of R rows starts at p * R * 128.
template <int D>
struct DqLayout {
  static constexpr int kBQ = 64 * consumers(D); // q rows a block
  static constexpr int kBK = 64;                // keys a ring stage
  static constexpr int kPanels = D / kPanel;
  static constexpr int kQBytes = kBQ * D * 2;   // Q, and dO
  static constexpr int kKBytes = kBK * D * 2;   // one K or V tile
  static constexpr int kQOff = 0;
  static constexpr int kDoOff = kQOff + kQBytes;
  static constexpr int kKOff = kDoOff + kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKBytes;
  static constexpr int kBarOff = kVOff + kStages * kKBytes;
  static constexpr int kBars = 1 + 3 * kStages;
  static constexpr int kSmem = kBarOff + 8 * kBars + 1024;  // align slack
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

// Launch A: K | V | Q[kStages] | dO[kStages] | lse, Delta[kStages] |
// barriers.
template <int D>
struct DkvLayout {
  static constexpr int kBK = 64 * consumers(D); // keys a block
  static constexpr int kBQ = 64;                // q rows a ring stage
  static constexpr int kPanels = D / kPanel;
  static constexpr int kKBytes = kBK * D * 2;   // K, and V
  static constexpr int kQBytes = kBQ * D * 2;   // one Q or dO tile
  static constexpr int kLdBytes = 2 * kBQ * 4;  // lse then Delta
  static constexpr int kKOff = 0;
  static constexpr int kVOff = kKOff + kKBytes;
  static constexpr int kQOff = kVOff + kKBytes;
  static constexpr int kDoOff = kQOff + kStages * kQBytes;
  static constexpr int kLdOff = kDoOff + kStages * kQBytes;
  static constexpr int kBarOff = kLdOff + kStages * kLdBytes;
  static constexpr int kBars = 1 + 2 * kStages;
  static constexpr int kSmem = kBarOff + 8 * kBars + 1024;
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

// 2^x by the SFU's approximation with subnormal results flushed to 0 (the
// weights P lie in [0, 1]; one below 2^-126 weighs nothing).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Whether query `row` sees key `col`.
__device__ __forceinline__ bool visible(int row, int col, int S, int T,
                                        int causal, int window,
                                        int prefix) {
  return row < S && col < T && (!causal || col <= row || col < prefix) &&
         (window == 0 || col > row - window);
}

// One k-step of a product whose B operand is N rows of a tile read
// K-major: m64 n{N} k16, both operands in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  wgmma_ss_n128(d, da, db, scale_d);
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_ss_n64(d, da, db, scale_d);
}

// One k-step of d (m64 n{D}) += a (registers) * b (shared memory,
// MN-major).
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db, 1);
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(d, a, db, 1);
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n256(d, a, db, 1);
}

// d = A B^T over D columns: A's 64 rows and B's N rows, both K-major in
// tiles of a_rows and b_rows rows (the panel strides), D / 16 k-steps.
template <int N, int D>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint64_t da,
                                           int a_rows, uint64_t db,
                                           int b_rows) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t aoff = (ks / 4) * a_rows * kPanelRow + (ks % 4) * 32;
    const uint32_t boff = (ks / 4) * b_rows * kPanelRow + (ks % 4) * 32;
    wgmma_ss<N>(d, da + (aoff >> 4), db + (boff >> 4), ks > 0);
  }
}

// Stage a warpgroup's 64 x D accumulator, times `mult`, in bf16 over 64
// rows of a 128B-swizzled tile (panel stride tile_rows * 128), for a TMA
// store of one 64 x 64 box per panel.
template <int D>
__device__ __forceinline__ void stage_bf16(uint32_t dst, int tile_rows,
                                           const float (&acc)[D / 2],
                                           float mult, int warp, int lane) {
  const int col0 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + col0;
    const uint32_t panel = dst + (col / kPanel) * tile_rows * kPanelRow;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + lane / 4 + 8 * h;
      const uint32_t chunk = ((col % kPanel) / 8) ^ (row % 8);
      st_shared_u32(panel + row * kPanelRow + chunk * 16 + (col % 8) * 2,
                    pack_bf16(acc[4 * j + 2 * h] * mult,
                              acc[4 * j + 2 * h + 1] * mult));
    }
  }
}

// ---------------------------------------------------------- launch B: dq
template <int D>
__global__ void __launch_bounds__(block_threads(D), 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_dq,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse_in,
                          float* __restrict__ ws_lse,
                          float* __restrict__ ws_delta, int H, int Hkv,
                          int S, int T, int s_pad, float scale,
                          float scale_log2, int causal, int window,
                          int prefix, int group) {
  using L = DqLayout<D>;
  constexpr int kBK = L::kBK;
  constexpr int kBQ = L::kBQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQOff;
  const uint32_t sDo = base + L::kDoOff;
  const uint32_t sK = base + L::kKOff;
  const uint32_t sV = base + L::kVOff;
  const uint32_t q_full = base + L::kBarOff;
  auto k_full = [&](int st) { return q_full + 8u * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8u * (1 + kStages + st); };
  auto empty = [&](int st) { return q_full + 8u * (1 + 2 * kStages + st); };

  const int nq = (S + kBQ - 1) / kBQ;
  int qt, bh;  // bh = b * H + h
  block_tile(nq, gridDim.x / nq, group, causal, qt, bh);
  const int bhk = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int q0 = qt * kBQ;
  const int nk = (T + kBK - 1) / kBK;
  const int last = max(q0 + kBQ - 1, prefix - 1);
  const int n_kv = causal ? min(nk, last / kBK + 1) : nk;
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  const bool rebuild = lse_in == nullptr;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      // every consumer thread releases
      mbar_init(empty(st), consumers(D) * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    if constexpr (consumers(D) == 2) reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::kQBytes);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p) {
        tma_load_3d(sQ + p * kBQ * kPanelRow, &tm_q, q_full, p * kPanel, q0,
                    bh);
        tma_load_3d(sDo + p * kBQ * kPanelRow, &tm_do, q_full, p * kPanel,
                    q0, bh);
      }
      // the rebuild pass (K alone), then the gradient's pass (K and V)
      int it = 0;
      for (int pass = rebuild ? 0 : 1; pass < 2; ++pass) {
        for (int kt = kt0; kt < n_kv; ++kt, ++it) {
          const int st = it % kStages;
          mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(k_full(st), L::kKBytes);
#pragma unroll
          for (int p = 0; p < L::kPanels; ++p)
            tma_load_3d(sK + st * L::kKBytes + p * kBK * kPanelRow, &tm_k,
                        k_full(st), p * kPanel, kt * kBK, bhk);
          if (pass == 1) {
            mbar_expect_tx(v_full(st), L::kKBytes);
#pragma unroll
            for (int p = 0; p < L::kPanels; ++p)
              tma_load_3d(sV + st * L::kKBytes + p * kBK * kPanelRow, &tm_v,
                          v_full(st), p * kPanel, kt * kBK, bhk);
          }
        }
      }
    }
    return;
  }
  // ----------------------------------------------------------- consumers
  if constexpr (consumers(D) == 2) reg_alloc<kConsumerRegs>();
  const int c = wg - 1;  // rows q0 + 64 c + [0, 64)
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  // accumulator layout: register r of a thread sits at row
  // 16 warp + lane / 4 + 8 ((r % 4) / 2), column 8 (r / 4) + 2 (lane % 4)
  // + r % 2 of the warpgroup's 64-row tile
  const int qc0 = q0 + 64 * c;
  const int row0 = qc0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const bool active = qc0 < S;
  const long long head_row = (long long)bh * S;

  // Delta of this thread's two rows: the row's 4 threads read its 16-byte
  // chunks lane % 4, lane % 4 + 4, .., then add across by two shuffles
  float delta[2], lse[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    float acc = 0.f;
    if (row < S) {
      const uint4* orow =
          reinterpret_cast<const uint4*>(o + (head_row + row) * D);
      const uint4* drow =
          reinterpret_cast<const uint4*>(dout + (head_row + row) * D);
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const uint4 a = orow[lane % 4 + 4 * i];
        const uint4 b = drow[lane % 4 + 4 * i];
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 af = __bfloat1622float2(a2[e]);
          const float2 bf = __bfloat1622float2(b2[e]);
          acc = fmaf(af.x, bf.x, acc);
          acc = fmaf(af.y, bf.y, acc);
        }
      }
      if (!rebuild) lse[h] = lse_in[head_row + row];
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    delta[h] = acc;
  }

  const uint64_t dq_a = make_desc(sQ + 64 * c * kPanelRow, 16, 1024);
  const uint64_t ddo_a = make_desc(sDo + 64 * c * kPanelRow, 16, 1024);
  mbar_wait(q_full, 0);

  int it = 0;
  if (rebuild) {
    // each row's max (raw score) and its threads' sums of exp2, online
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    for (int kt = kt0; kt < n_kv; ++kt, ++it) {
      const int st = it % kStages;
      const int k0 = kt * kBK;
      mbar_wait(k_full(st), (it / kStages) & 1);
      {
        float s[kBK / 2];
        wgmma_fence();
        product_ss<kBK, D>(s, dq_a, kBQ,
                           make_desc(sK + st * L::kKBytes, 16, 1024), kBK);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(s);
        const bool edge = k0 + kBK > T ||
                          (causal && k0 + kBK - 1 > qc0 && k0 + kBK > prefix) ||
                          (window > 0 && k0 <= qc0 + 63 - window);
        if (edge) {
#pragma unroll
          for (int r = 0; r < kBK / 2; ++r) {
            const int col = k0 + 8 * (r / 4) + col0 + (r % 2);
            const int row = row0 + 8 * ((r % 4) / 2);
            if (col >= T || (causal && col > row && col >= prefix) ||
                (window > 0 && col <= row - window))
              s[r] = kNegInf;
          }
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int r = 0; r < kBK / 2; ++r)
          mx[(r % 4) / 2] = fmaxf(mx[(r % 4) / 2], s[r]);
        float msc[2], rsum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          l[h] *= exp2f((m[h] - mx[h]) * scale_log2);
          m[h] = mx[h];
          msc[h] = mx[h] == kNegInf ? 0.f : mx[h] * scale_log2;
        }
#pragma unroll
        for (int r = 0; r < kBK / 2; ++r)
          rsum[(r % 4) / 2] += exp2f(fmaf(s[r], scale_log2, -msc[(r % 4) / 2]));
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] += rsum[h];
      }
      mbar_arrive(empty(st));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      lse[h] = l[h] > 0.f ? m[h] * scale_log2 + log2f(l[h]) : 0.f;
    }
  }
  // the rows' lse and Delta for launch A (rows >= S: 0)
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const long long at = (long long)bh * s_pad + row;
      ws_lse[at] = row < S ? lse[h] : 0.f;
      ws_delta[at] = row < S ? delta[h] : 0.f;
    }
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int kt = kt0; kt < n_kv; ++kt, ++it) {
    const int st = it % kStages;
    const int k0 = kt * kBK;
    mbar_wait(k_full(st), (it / kStages) & 1);
    // v_full is armed only in this pass: its j-th use of stage st
    mbar_wait(v_full(st), ((kt - kt0) / kStages) & 1);
    {
      const uint32_t k_tile = sK + st * L::kKBytes;
      const uint32_t v_tile = sV + st * L::kKBytes;
      float s[kBK / 2], dp[kBK / 2];
      wgmma_fence();
      product_ss<kBK, D>(s, dq_a, kBQ, make_desc(k_tile, 16, 1024), kBK);
      wgmma_commit();
      product_ss<kBK, D>(dp, ddo_a, kBQ, make_desc(v_tile, 16, 1024), kBK);
      wgmma_commit();
      wgmma_wait<1>();
      fence_operands(s);
      const bool edge = k0 + kBK > T || qc0 + 64 > S ||
                        (causal && k0 + kBK - 1 > qc0 && k0 + kBK > prefix) ||
                        (window > 0 && k0 <= qc0 + 63 - window);
#pragma unroll
      for (int r = 0; r < kBK / 2; ++r) {
        float p = ex2(fmaf(s[r], scale_log2, -lse[(r % 4) / 2]));
        if (edge && !visible(row0 + 8 * ((r % 4) / 2),
                             k0 + 8 * (r / 4) + col0 + (r % 2), S, T, causal,
                             window, prefix))
          p = 0.f;
        s[r] = p;
      }
      wgmma_wait<0>();
      fence_operands(dp);
      // dS in bf16: k-step kk of dS K takes columns [16 kk, 16 kk + 16),
      // registers 8 kk .. 8 kk + 7
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kk + 2 * e;
          const float dl = delta[(i % 4) / 2];
          pa[kk][e] = pack_bf16(s[i] * (dp[i] - dl),
                                s[i + 1] * (dp[i + 1] - dl));
        }
      // dQ += dS K: K read MN-major, its D / 64 panels kBK * 128 bytes
      // apart, a k-step of 16 keys 2048 bytes
      const uint64_t kb = make_desc(k_tile, kBK * kPanelRow, 1024);
      wgmma_fence();
      fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<D>(acc, pa[kk], kb + ((kk * 16 * kPanelRow) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
    }
    mbar_arrive(empty(st));
  }

  // epilogue: dQ scale in bf16 over this warpgroup's rows of the Q tile
  if (active) {
    const uint32_t so = sQ + 64 * c * kPanelRow;
    stage_bf16<D>(so, kBQ, acc, scale, warp, lane);
    fence_proxy_async();
    named_barrier(1 + c, 128);
    if (tid == 0) {
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
        tma_store_3d(&tm_dq, so + p * kBQ * kPanelRow, p * kPanel, qc0, bh);
      tma_store_commit_and_wait();
    }
  }
}

// ------------------------------------------------------ launch A: dk, dv
// One q tile of launch A for one consumer: S^T = K Q^T, P^T and, for dK,
// dP^T = V dO^T and dS^T; then dV += P^T dO (DV) and dK += dS^T Q (DK).
template <int D, bool DK, bool DV>
__device__ __forceinline__ void dkv_step(
    float (&dk)[D / 2], float (&dv)[D / 2], uint64_t k_a, uint64_t v_a,
    uint32_t q_tile, uint32_t do_tile, const float* ls, const float* dl,
    int q0, int key0, int col0, bool edge, int S, int T, float scale_log2,
    int causal, int window, int prefix) {
  using L = DkvLayout<D>;
  constexpr int kBQ = L::kBQ;
  float s[kBQ / 2], dp[kBQ / 2];
  wgmma_fence();
  product_ss<kBQ, D>(s, k_a, L::kBK, make_desc(q_tile, 16, 1024), kBQ);
  wgmma_commit();
  if constexpr (DK) {
    product_ss<kBQ, D>(dp, v_a, L::kBK, make_desc(do_tile, 16, 1024), kBQ);
    wgmma_commit();
    wgmma_wait<1>();
  } else {
    wgmma_wait<0>();
  }
  fence_operands(s);
#pragma unroll
  for (int r = 0; r < kBQ / 2; ++r) {
    const int qi = 8 * (r / 4) + col0 + (r % 2);
    float p = ex2(fmaf(s[r], scale_log2, -ls[qi]));
    if (edge && !visible(q0 + qi, key0 + 8 * ((r % 4) / 2), S, T, causal,
                         window, prefix))
      p = 0.f;
    s[r] = p;
  }
  if constexpr (DK) {
    wgmma_wait<0>();
    fence_operands(dp);
  }
  // P^T and dS^T in bf16 as register A operands: k-step kk takes the
  // queries [16 kk, 16 kk + 16), registers 8 kk .. 8 kk + 7
  uint32_t pa[kBQ / 16][4], pb[kBQ / 16][4];
#pragma unroll
  for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 8 * kk + 2 * e;
      const int qi = 8 * (r / 4) + col0;  // r even: queries qi, qi + 1
      if constexpr (DV) pa[kk][e] = pack_bf16(s[r], s[r + 1]);
      if constexpr (DK)
        pb[kk][e] = pack_bf16(s[r] * (dp[r] - dl[qi]),
                              s[r + 1] * (dp[r + 1] - dl[qi + 1]));
    }
  // dV += P^T dO and dK += dS^T Q: dO and Q read MN-major, their D / 64
  // panels kBQ * 128 bytes apart, a k-step of 16 queries 2048 bytes
  wgmma_fence();
  if constexpr (DV) {
    const uint64_t do_b = make_desc(do_tile, kBQ * kPanelRow, 1024);
    fence_operands(dv);
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_rs<D>(dv, pa[kk], do_b + ((kk * 16 * kPanelRow) >> 4));
  }
  if constexpr (DK) {
    const uint64_t q_b = make_desc(q_tile, kBQ * kPanelRow, 1024);
    fence_operands(dk);
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_rs<D>(dk, pb[kk], q_b + ((kk * 16 * kPanelRow) >> 4));
  }
  wgmma_commit();
  wgmma_wait<0>();
  if constexpr (DV) fence_operands(dv);
  if constexpr (DK) fence_operands(dk);
}

// Write a consumer's 64 keys of dk or dv (acc times mult): in bf16 staged
// over rows `stage` of a K or V tile and stored by TMA, or as float32
// partials at `pout` (rows of D floats, keys < T).
template <int D>
__device__ __forceinline__ void dkv_store(const float (&acc)[D / 2],
                                          float mult, bool partial,
                                          uint32_t stage,
                                          const CUtensorMap* tm, int kc0,
                                          int bhk, float* pout, int key0,
                                          int T, int c, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  if (!partial) {
    stage_bf16<D>(stage, DkvLayout<D>::kBK, acc, mult, warp, lane);
    fence_proxy_async();
    named_barrier(1 + c, 128);
    if (tid == 0) {
#pragma unroll
      for (int p = 0; p < D / kPanel; ++p)
        tma_store_3d(tm, stage + p * DkvLayout<D>::kBK * kPanelRow,
                     p * kPanel, kc0, bhk);
      tma_store_commit_and_wait();
    }
    return;
  }
  const int col0 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 8 * h;
      if (key < T)
        *reinterpret_cast<float2*>(pout + (long long)key * D + 8 * j +
                                   col0) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// TWO_PASS (at D = 128 and 256, see the note at the top): the q tiles
// stream twice, dK accumulated in the first pass and dV in the second, so
// that a consumer thread never holds both.
constexpr bool two_pass(int D) { return D >= 128; }

template <int D, bool TWO_PASS>
__global__ void __launch_bounds__(block_threads(D), 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_dk,
                           const __grid_constant__ CUtensorMap tm_dv,
                           const float* __restrict__ ws_lse,
                           const float* __restrict__ ws_delta,
                           float* __restrict__ part, int H, int Hkv, int S,
                           int T, int s_pad, int nsplit, float scale,
                           float scale_log2, int causal, int window,
                           int prefix) {
  using L = DkvLayout<D>;
  constexpr int kBK = L::kBK;
  constexpr int kBQ = L::kBQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base + L::kKOff;
  const uint32_t sV = base + L::kVOff;
  const uint32_t sQ = base + L::kQOff;
  const uint32_t sDo = base + L::kDoOff;
  const uint32_t sLd = base + L::kLdOff;
  const float* ld_ptr =
      reinterpret_cast<const float*>(smem_raw + (sLd - raw));
  const uint32_t kv_full = base + L::kBarOff;
  auto full = [&](int st) { return kv_full + 8u * (1 + st); };
  auto empty = [&](int st) { return kv_full + 8u * (1 + kStages + st); };

  // block: (key tile, b * Hkv + g, split), key tiles slowest, the first
  // (which causal rows see most) first
  const int nk = (T + kBK - 1) / kBK;
  const int per_tile = gridDim.x / nk;  // B * Hkv * nsplit
  const int kt = blockIdx.x / per_tile;
  const int bhk = (blockIdx.x % per_tile) / nsplit;
  const int split = blockIdx.x % nsplit;
  const int b = bhk / Hkv, g = bhk % Hkv;
  const int G = H / Hkv, gs = G / nsplit;
  const int h0 = b * H + g * G + split * gs;  // first q head (b * H + h)
  const int k0 = kt * kBK;
  // the q tiles whose rows see a key of this tile
  const int nq = (S + kBQ - 1) / kBQ;
  const int qt0 = causal && k0 >= prefix ? k0 / kBQ : 0;
  int qt1 = nq;
  if (window > 0) qt1 = min(nq, (min(k0 + kBK, T) - 1 + window - 1) / kBQ + 1);
  const int n_q = max(0, qt1 - qt0);
  const int total = gs * n_q;  // q tiles a pass

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), consumers(D) * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    if constexpr (consumers(D) == 2) reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKBytes);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p) {
        tma_load_3d(sK + p * kBK * kPanelRow, &tm_k, kv_full, p * kPanel,
                    k0, bhk);
        tma_load_3d(sV + p * kBK * kPanelRow, &tm_v, kv_full, p * kPanel,
                    k0, bhk);
      }
      for (int i = 0; i < (TWO_PASS ? 2 : 1) * total; ++i) {
        const int t = i % total;
        const int bh = h0 + t / n_q;
        const int q0 = (qt0 + t % n_q) * kBQ;
        const int st = i % kStages;
        mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * L::kQBytes + L::kLdBytes);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_3d(sQ + st * L::kQBytes + p * kBQ * kPanelRow, &tm_q,
                      full(st), p * kPanel, q0, bh);
          tma_load_3d(sDo + st * L::kQBytes + p * kBQ * kPanelRow, &tm_do,
                      full(st), p * kPanel, q0, bh);
        }
        const long long at = (long long)bh * s_pad + q0;
        bulk_load(sLd + st * L::kLdBytes, ws_lse + at, kBQ * 4, full(st));
        bulk_load(sLd + st * L::kLdBytes + kBQ * 4, ws_delta + at, kBQ * 4,
                  full(st));
      }
    }
    return;
  }
  // ----------------------------------------------------------- consumers
  if constexpr (consumers(D) == 2) reg_alloc<kConsumerRegs>();
  const int c = wg - 1;  // keys k0 + 64 c + [0, 64)
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  // accumulator layout of S^T: rows are keys, columns queries
  const int kc0 = k0 + 64 * c;
  const int key0 = kc0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const uint64_t k_a = make_desc(sK + 64 * c * kPanelRow, 16, 1024);
  const uint64_t v_a = make_desc(sV + 64 * c * kPanelRow, 16, 1024);
  const bool partial = nsplit > 1;
  // float32 partials (nsplit, B * Hkv, T, D) of dk then of dv
  float* pk = part + ((long long)split * (per_tile / nsplit) + bhk) * T * D;
  float* pv = pk + (long long)per_tile * T * D;
  // where a consumer writes: its rows of the V tile take dK (V is read
  // last by dP^T), its rows of the K tile dV
  const uint32_t own_k = sK + 64 * c * kPanelRow;
  const uint32_t own_v = sV + 64 * c * kPanelRow;
  mbar_wait(kv_full, 0);

  // one pass over the q tiles, i from i0 to i0 + total (ring position i)
  auto pass = [&](auto want_dk, auto want_dv, float (&dk)[D / 2],
                  float (&dv)[D / 2], int i0) {
    for (int i = i0; i < i0 + total; ++i) {
      const int t = i - i0;
      const int q0 = (qt0 + t % n_q) * kBQ;
      const int st = i % kStages;
      mbar_wait(full(st), (i / kStages) & 1);
      const bool edge = q0 + kBQ > S || kc0 + 64 > T ||
                        (causal && kc0 + 63 > q0 && kc0 + 64 > prefix) ||
                        (window > 0 && kc0 <= q0 + kBQ - 1 - window);
      const float* ls = ld_ptr + st * (L::kLdBytes / 4);
      dkv_step<D, decltype(want_dk)::value, decltype(want_dv)::value>(
          dk, dv, k_a, v_a, sQ + st * L::kQBytes, sDo + st * L::kQBytes, ls,
          ls + kBQ, q0, key0, col0, edge, S, T, scale_log2, causal, window,
          prefix);
      mbar_arrive(empty(st));
    }
  };
  using Yes = std::true_type;
  using No = std::false_type;

  if constexpr (TWO_PASS) {
    {
      float dk[D / 2];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) dk[j] = 0.f;
      pass(Yes{}, No{}, dk, dk, 0);
      if (kc0 < T)
        dkv_store<D>(dk, scale, partial, own_v, &tm_dk, kc0, bhk, pk, key0,
                     T, c, tid);
    }
    float dv[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dv[j] = 0.f;
    pass(No{}, Yes{}, dv, dv, total);
    if (kc0 < T)
      dkv_store<D>(dv, 1.f, partial, own_k, &tm_dv, kc0, bhk, pv, key0, T,
                   c, tid);
  } else {
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      dk[j] = 0.f;
      dv[j] = 0.f;
    }
    pass(Yes{}, Yes{}, dk, dv, 0);
    if (kc0 < T) {
      dkv_store<D>(dk, scale, partial, own_v, &tm_dk, kc0, bhk, pk, key0, T,
                   c, tid);
      dkv_store<D>(dv, 1.f, partial, own_k, &tm_dv, kc0, bhk, pv, key0, T,
                   c, tid);
    }
  }
}

// ------------------------------------------- launch C: the splits' sum
// dk = scale sum_s part_dk[s], dv = sum_s part_dv[s], in split order; n
// elements of each, 4 a thread.
__global__ void flash_bwd_dkv_sum_kernel(const float* __restrict__ part,
                                         __nv_bfloat16* __restrict__ dk,
                                         __nv_bfloat16* __restrict__ dv,
                                         long long n, int nsplit,
                                         float scale) {
  const long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const float* pv = part + (long long)nsplit * n;
  float4 a = *reinterpret_cast<const float4*>(part + i);
  float4 b = *reinterpret_cast<const float4*>(pv + i);
  for (int s = 1; s < nsplit; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(part + s * n + i);
    const float4 y = *reinterpret_cast<const float4*>(pv + s * n + i);
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    b.x += y.x; b.y += y.y; b.z += y.z; b.w += y.w;
  }
  __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(dk + i);
  __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(dv + i);
  k2[0] = __floats2bfloat162_rn(a.x * scale, a.y * scale);
  k2[1] = __floats2bfloat162_rn(a.z * scale, a.w * scale);
  v2[0] = __floats2bfloat162_rn(b.x, b.y);
  v2[1] = __floats2bfloat162_rn(b.z, b.w);
}

// Head splits of launch A: the least divisor of G giving at least two
// blocks an SM, else G (key tiles of 64 consumers(D) keys).
int head_splits(int B, int Hkv, int G, int T, int D) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int bk = 64 * consumers(D);
  const long long tiles = (long long)((T + bk - 1) / bk) * B * Hkv;
  for (int s = 1; s < G; ++s)
    if (G % s == 0 && tiles * s >= 2ll * sms) return s;
  return G;
}

long long s_padded(int S) {
  return (long long)(S + kRowPad - 1) / kRowPad * kRowPad;
}

long long workspace_bytes(int B, int H, int Hkv, int S, int T, int D) {
  const int nsplit = head_splits(B, Hkv, H / Hkv, T, D);
  long long bytes = 2ll * B * H * s_padded(S) * 4;
  if (nsplit > 1) bytes += 2ll * nsplit * B * Hkv * T * D * 4;
  return bytes;
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* work;
  int B, H, Hkv, S, T;
  float scale;
  int causal, window, prefix;
  cudaStream_t stream;
};

template <int D>
int launch(const Args& a) {
  using LB = DqLayout<D>;
  using LA = DkvLayout<D>;
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kErrNoEncode;
  const int BH = a.B * a.H, BHkv = a.B * a.Hkv;
  CUtensorMap tq, tk, tv, tdo, tdq, tqa, tka, tva, tdoa, tdk, tdv;
  int err = encode(fn, &tq, a.q, D, a.S, BH, LB::kBQ);
  if (!err) err = encode(fn, &tdo, a.dout, D, a.S, BH, LB::kBQ);
  if (!err) err = encode(fn, &tk, a.k, D, a.T, BHkv, LB::kBK);
  if (!err) err = encode(fn, &tv, a.v, D, a.T, BHkv, LB::kBK);
  if (!err) err = encode(fn, &tdq, a.dq, D, a.S, BH, 64);
  if (!err) err = encode(fn, &tqa, a.q, D, a.S, BH, LA::kBQ);
  if (!err) err = encode(fn, &tdoa, a.dout, D, a.S, BH, LA::kBQ);
  if (!err) err = encode(fn, &tka, a.k, D, a.T, BHkv, LA::kBK);
  if (!err) err = encode(fn, &tva, a.v, D, a.T, BHkv, LA::kBK);
  if (!err) err = encode(fn, &tdk, a.dk, D, a.T, BHkv, 64);
  if (!err) err = encode(fn, &tdv, a.dv, D, a.T, BHkv, 64);
  if (err) return err;

  const int s_pad = (int)s_padded(a.S);
  float* ws_lse = a.work;
  float* ws_delta = ws_lse + (long long)BH * s_pad;
  float* part = ws_delta + (long long)BH * s_pad;
  const int G = a.H / a.Hkv;
  const int nsplit = head_splits(a.B, a.Hkv, G, a.T, D);
  const float scale_log2 = a.scale * kLog2e;

  auto* kb = flash_bwd_dq_wgmma_kernel<D>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kb, cudaFuncAttributeMaxDynamicSharedMemorySize, LB::kSmem);
  if (cerr != cudaSuccess) return (int)cerr;
  const long long nq = (a.S + LB::kBQ - 1) / LB::kBQ;
  const long long nk = (a.T + LA::kBK - 1) / LA::kBK;
  if (nq * BH > 0x7fffffff || nk * BHkv * nsplit > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int group = l2_heads(BH, G, a.T, D, D, 2);
  kb<<<(int)(nq * BH), block_threads(D), LB::kSmem, a.stream>>>(
      tq, tk, tv, tdo, tdq, static_cast<const __nv_bfloat16*>(a.o),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, ws_lse, ws_delta,
      a.H, a.Hkv, a.S, a.T, s_pad, a.scale, scale_log2, a.causal, a.window,
      a.prefix, group);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;

  auto* ka = flash_bwd_dkv_wgmma_kernel<D, two_pass(D)>;
  cerr = cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              LA::kSmem);
  if (cerr != cudaSuccess) return (int)cerr;
  ka<<<(int)(nk * BHkv * nsplit), block_threads(D), LA::kSmem,
       a.stream>>>(
      tqa, tka, tva, tdoa, tdk, tdv, ws_lse, ws_delta, part, a.H, a.Hkv,
      a.S, a.T, s_pad, nsplit, a.scale, scale_log2, a.causal, a.window,
      a.prefix);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess || nsplit == 1) return (int)cerr;

  const long long n = (long long)BHkv * a.T * D;
  const int threads = 256;
  const long long blocks = (n / 4 + threads - 1) / threads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_bwd_dkv_sum_kernel<<<(int)blocks, threads, 0, a.stream>>>(
      part, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), n, nsplit, a.scale);
  return (int)cudaGetLastError();
}

bool valid(int B, int H, int Hkv, int S, int T, int Dk, int Dv) {
  return B >= 1 && H >= 1 && Hkv >= 1 && H % Hkv == 0 && S >= 1 && T >= 1 &&
         Dk == Dv && (Dk == 64 || Dk == 128 || Dk == 256);
}

}  // namespace

extern "C" {

// Bytes of the float32 workspace a call takes: each row's lse and Delta
// (2 B H S', S padded to a multiple of 128) and, where launch A splits the
// heads of a group, dk and dv partials (2 nsplit B Hkv T D). -1 for
// shapes the lane does not take. Reads the current device's SM count.
long long flash_attention_bwd_wgmma_workspace_bytes(int B, int H, int Hkv,
                                                    int S, int T, int Dk,
                                                    int Dv) {
  if (!valid(B, H, Hkv, S, T, Dk, Dv)) return -1;
  return workspace_bytes(B, H, Hkv, S, T, Dk);
}

// Two or three launches on `stream`; returns 0 on success, a cudaError_t
// after a launch, or an error of the tensor-map encode (see
// flash_attention_bwd_wgmma_error_string). The caller checks shapes: bf16,
// (Dk, Dv) in {(64, 64), (128, 128), (256, 256)}, H % Hkv == 0, S, T >= 1, contiguous
// tensors on 16-byte boundaries; window 0 (none) or >= 1 with
// S <= T + window - 1; prefix >= 0 (0: none; read only when causal); lse
// null (rebuilt) or B * H * S floats from the forward; the workspace of
// flash_attention_bwd_wgmma_workspace_bytes.
int flash_attention_bwd_wgmma_launch(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, const void* lse,
                                     void* dq, void* dk, void* dv,
                                     void* workspace, int B, int H, int Hkv,
                                     int S, int T, int Dk, int Dv,
                                     float scale, int causal, int window,
                                     int prefix, void* stream) {
  if (!valid(B, H, Hkv, S, T, Dk, Dv) || window < 0 ||
      (window > 0 && S > T + window - 1) || prefix < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
               static_cast<float*>(workspace), B, H, Hkv, S, T, scale,
               causal != 0 ? 1 : 0, window, causal != 0 ? prefix : 0,
               static_cast<cudaStream_t>(stream)};
  return Dk == 64    ? launch<64>(a)
         : Dk == 128 ? launch<128>(a)
                     : launch<256>(a);
}

const char* flash_attention_bwd_wgmma_error_string(int err) {
  if (err == kErrNoEncode)
    return "the driver has no cuTensorMapEncodeTiled entry point";
  if (err >= kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
