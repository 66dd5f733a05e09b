// Block-CSR SpMV for Hopper (sm_90a), exported through a plain C interface
// and bound to PyTorch with ctypes (repro_torch/kernels/bsr_spmv/bsr_spmv.py).
//
//   y[i] = sum_{k < count[i]} blocks[i, k] @ x[blk_cols[i, k]]
//   blocks (nbr, K, bm, bn) f32, blk_cols (nbr, K) i32, count (nbr,) i32,
//   x (nbc, bn, nv) f32 or f16  ->  y (nbr, bm, nv) f32
//
// Replaces repro/kernels/bsr_spmv/bsr_spmv.py::_kernel (line 36,
// accum="f32") and ::_kernel_kahan (line 50, accum="kahan"). The TPU kernel
// walks a sequential (nbr, K) grid and accumulates in the output VMEM
// block; here one thread block owns a block-row from its first slot to its
// last, so nothing carries across thread blocks and no atomics are needed.
//
// What bounds it: device-memory bytes. A slot's product is bm*bn*nv f32
// FMAs on bm*bn*4 block bytes, at most 4 FLOP per byte at nv <= 8, while
// the H100's f32 ridge is 67 TFLOP/s / 3.35 TB/s = 20 FLOP per byte. Every
// float is multiplied in full f32 on the CUDA cores: no tensor cores, no
// TF32, which would buy nothing here and change the numbers. So the design
// is about the block stream:
//
//  * Padded slots are never read. build_bsr pads every block-row to K with
//    all-zero blocks at column 0 after its real slots (ops.py::slot_counts
//    checks that rule on the host and derives count[i]); the kernel stops
//    at count[i]. On the Stanford-Web replica that is 30-40% of the layout.
//  * A bulk-copy ring keeps the bytes in flight. A block-row's real slots
//    are contiguous, so one thread of a producer warp copies up to 8 KB of
//    them (16 KB at bm = 64) into a shared-memory stage with one
//    cp.async.bulk, completed on the stage's mbarrier, with an L2
//    evict-first hint: the blocks are read once and are far larger than
//    L2, while x (1.1 MB at nv = 1, 9 MB at nv = 8) and blk_cols stay there
//    for the gathers. The other producer lanes copy the stage's block
//    columns with 4-byte cp.async, tracked by the same mbarrier. The ring
//    holds 64 KB of blocks per thread block and three thread blocks fit on
//    an SM, so up to 192 KB are in flight per SM, where by Little's law
//    3.35 TB/s over 132 SMs at ~1.5 us of loaded latency needs ~40 KB: the
//    rest covers the consumers' time per stage.
//  * Four consumer warps read each stage from shared memory with 16-byte
//    loads, neighbouring lanes on neighbouring addresses, and split the
//    block's rows between them, so that every warp sees every slot in
//    order (the Kahan lane needs that). Lane (n4, ml, b) of warp w takes
//    float4 column n4 of R rows of block b of each pass: its x operand is
//    the 4 x nv slice x[c, 4*n4 .. 4*n4 + 3, :], read once per block for
//    its R rows, and the f32 lane reduces a row with warp shuffles once,
//    at the block-row's end. At nv >= 4 those x reads, not the blocks,
//    bound the kernel (each x value is read by every lane of its column
//    that holds other rows), so there the f32 lane gives a lane up to 8
//    rows, and at bm = 8, nv = 8, where a block's x slice is as large as
//    the block, the producer also bulk-copies each slot's x slice into the
//    stage, two stages after the block copy, once the block columns it
//    needs have reached its registers.
//  * A persistent grid, one thread block per resident slot on every SM,
//    walks the block-rows round-robin: real counts range from 0 to K, and
//    the producer only issues the stages a row has (none for an empty row).
//  * Every mbarrier wait traps after ~2^34 cycles instead of hanging.
//
// Kahan lane: compensation runs across the slots in order, as
// _kernel_kahan does; the dot inside one block is a plain f32 sum, reduced
// across its lanes with shuffles before the compensated step. The steps
// use __fadd_rn/__fsub_rn so that nvcc cannot contract or reorder them. A
// Kahan step on a zero product is not the identity (y = -c; t = s + y
// folds the compensation into the sum), and the plain version sums all K
// slots, so after a row's real slots the kernel replays its K - count zero
// steps in registers, reading nothing; it stops early once a step leaves
// the sum unchanged, from which point every further step is the identity.
//
// Shapes outside the ring path (bm != bn, bm not in {8, 16, 32, 64}, nv
// not in {1, 2, 4, 8}, or operands off 16-byte boundaries) take a generic
// path: one thread per output element looping over its row's real slots
// with scalar loads, with the same count skip and zero-step replay.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------ PTX building blocks
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Arrive and announce `bytes` of bulk-copy traffic that completes the phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}

// Wait for the phase of parity `parity`. A wait of more than 2^34 cycles
// (about 10 s) can only be a pipeline fault: it traps, so that the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// An L2 policy under which the lines a copy brings in are evicted first.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// An L2 policy under which the lines a copy brings in are evicted last.
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, counted on `bar` in bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// 4-byte asynchronous copy global -> shared.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// Make `bar` wait for this thread's earlier cp.async copies: the pending
// count rises by one now and falls when they have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// ------------------------------------------------------------- arithmetic
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ void kahan_step(float& acc, float& comp,
                                           float prod) {
  const float yk = __fsub_rn(prod, comp);
  const float t = __fadd_rn(acc, yk);
  comp = __fsub_rn(__fsub_rn(t, acc), yk);
  acc = t;
}

// The `n` zero-product steps of the slots past a row's count. Once a step
// leaves the sum unchanged, the state (acc, comp) is a fixed point.
__device__ __forceinline__ void kahan_replay(float& acc, float& comp,
                                             int n) {
  for (int k = 0; k < n; ++k) {
    const float yk = __fsub_rn(0.f, comp);
    const float t = __fadd_rn(acc, yk);
    if (t == acc) break;
    comp = __fsub_rn(__fsub_rn(t, acc), yk);
    acc = t;
  }
}

__device__ __forceinline__ int clamp_count(const int* counts, long long row,
                                           int K) {
  if (counts == nullptr) return K;
  const int c = counts[row];
  return c < 0 ? 0 : (c > K ? K : c);
}

// ------------------------------------------------------------- ring path
constexpr int kConsumerWarps = 4;
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr int kRingBytes = 64 * 1024;
constexpr int kFirst = 1, kLast = 2;

template <bool KAHAN, typename XT, int BM, int NV>
struct Ring {
  static constexpr int kBlockBytes = BM * BM * 4;
  static constexpr int kStageBlocks =
      kBlockBytes >= 8192 ? 1 : 8192 / kBlockBytes;  // 32, 8, 2, 1
  static constexpr int kStageBytes = kStageBlocks * kBlockBytes;
  // Where a block's x slice is as large as the block (bm = 8 at nv = 8),
  // the slices travel through the stage too, one bulk copy each, in slots
  // padded by 16 bytes so that reads of neighbouring blocks' slices fall in
  // other banks.
  static constexpr int kXBytes = BM * NV * (int)sizeof(XT);
  static constexpr bool kStageX = kXBytes >= kBlockBytes;
  static constexpr int kXSlot = kStageX ? kXBytes + 16 : 0;
  static constexpr int kStages =
      (kRingBytes + (kStageX ? 8192 : 0)) /
      (kStageBytes + kStageBlocks * kXSlot);  // 8, 8, 8, 4 unstaged
  // [stages][kStageBytes] | x [stages][kStageBlocks][kXSlot]
  // | meta int4 [stages] | cols int [stages][32]
  // | full u64 [stages] | empty u64 [stages]
  static constexpr int kXOff = kStages * kStageBytes;
  static constexpr int kMetaOff = kXOff + kStages * kStageBlocks * kXSlot;
  static constexpr int kColsOff = kMetaOff + kStages * 16;
  static constexpr int kBarOff = kColsOff + kStages * 32 * 4;
  static constexpr int kSmem = kBarOff + 2 * 8 * kStages;

  // consumer lane map: NC float4 columns per block row; MW rows per warp,
  // ML of them side by side, R = MW / ML per lane; BP blocks side by side.
  // A lane reads 4 x nv values of x per block and uses them for its R
  // rows. R is the fewest rows that fill a warp with whole block rows,
  // except in the f32 lane from nv = 4 and bm = 16 up, where the x reads
  // would outgrow the block's: there a lane takes up to 8 rows. (The
  // Kahan lane shuffles every product, so more rows per lane cost it more
  // than the x reads they save; at bm = 8 they cost bank conflicts.)
  static constexpr int NC = BM / 4;
  static constexpr int MW = BM / kConsumerWarps;
  static constexpr int R =
      !KAHAN && NV >= 4 && BM >= 16 ? (MW < 8 ? MW : 8)
                                    : MW / (MW < 32 / NC ? MW : 32 / NC);
  static constexpr int ML = MW / R;
  static constexpr int BP = 32 / (NC * ML);
  static constexpr int F = BM * BM / 4;  // float4 per block
  static_assert(kStageBlocks <= 32, "one column per producer lane");
  static_assert(kStages >= 3, "x copies trail their stage by two stages");
  static_assert(BP * NC * ML == 32 && R * ML == MW, "lane map");
};

// Read-only global load (GLOBAL) or shared-memory load of one vector.
template <bool GLOBAL, typename T>
__device__ __forceinline__ T load_vec(const T* p) {
  if constexpr (GLOBAL) return __ldg(p);
  return *p;
}

// The 4 x NV slice x[c, 4*n4 .. 4*n4 + 3, :] (contiguous), as floats, from
// global memory (GLOBAL) or from its copy in a stage.
template <bool GLOBAL, typename XT, int NV>
__device__ __forceinline__ void load_x(const XT* __restrict__ p,
                                       float (&xs)[4][NV]) {
  if constexpr (std::is_same<XT, float>::value) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float4 f = load_vec<GLOBAL>(q + i);
      const float e[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        xs[(4 * i + t) / NV][(4 * i + t) % NV] = e[t];
    }
  } else if constexpr (NV == 1) {
    const uint2 u = load_vec<GLOBAL>(reinterpret_cast<const uint2*>(p));
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
    xs[0][0] = a.x; xs[1][0] = a.y; xs[2][0] = b.x; xs[3][0] = b.y;
  } else {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) {
      const uint4 u = load_vec<GLOBAL>(q + i);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 f =
            __half22float2(*reinterpret_cast<const __half2*>(&w[h]));
        const int e = 8 * i + 2 * h;
        xs[e / NV][e % NV] = f.x;
        xs[(e + 1) / NV][(e + 1) % NV] = f.y;
      }
    }
  }
}

// Two blocks per SM cap a thread at 168 registers; a lane that holds 64
// sums (and 64 compensations) takes one, uncapped.
template <bool KAHAN, typename XT, int BM, int NV>
__global__ void __launch_bounds__(kThreads,
                                  Ring<KAHAN, XT, BM, NV>::R * NV >= 64 ? 1
                                                                    : 2)
bsr_spmv_ring_kernel(const float* __restrict__ blocks,
                     const int* __restrict__ blk_cols,
                     const int* __restrict__ counts,
                     const XT* __restrict__ x, float* __restrict__ y,
                     long long nbr, int K) {
  using L = Ring<KAHAN, XT, BM, NV>;
  extern __shared__ __align__(1024) unsigned char smem[];
  int4* meta = reinterpret_cast<int4*>(smem + L::kMetaOff);
  int* cols = reinterpret_cast<int*>(smem + L::kColsOff);
  const uint32_t bars = smem_addr(smem + L::kBarOff);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (L::kStages + s); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), L::kStageX ? 2 : 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: block-rows blockIdx.x + j * gridDim.x, 32 at a time
    const uint64_t stream_once = evict_first_policy();
    const uint64_t keep = evict_last_policy();
    int s = 0;
    uint32_t ph = 0;
    // staged x: the copies of a stage's x slices need its block columns in
    // registers, so they are issued two stages later, once those loads
    // have landed; the stage's full barrier waits for both arrivals
    int pending = 0, ps0 = 0, pn0 = 0, pc0 = 0, ps1 = 0, pn1 = 0, pc1 = 0;
    auto issue_x = [&](int st, int nb, int col) {
      if (lane == 0) {
        if (nb > 0)
          mbar_expect_tx(full(st), nb * L::kXBytes);
        else
          mbar_arrive(full(st));
      }
      __syncwarp();
      if (lane < nb)
        bulk_load(smem_addr(smem + L::kXOff +
                            (st * L::kStageBlocks + lane) * L::kXSlot),
                  x + (long long)col * (BM * NV), L::kXBytes, full(st),
                  keep);
    };
    const long long step = gridDim.x;
    for (long long base = blockIdx.x; base < nbr; base += 32 * step) {
      const long long mine = base + lane * step;
      const int my_cnt = mine < nbr ? clamp_count(counts, mine, K) : 0;
      for (int l = 0; l < 32; ++l) {
        const long long row = base + l * step;
        if (row >= nbr) break;
        const int cnt = __shfl_sync(kFull, my_cnt, l);
        int s0 = 0;
        do {
          const int nb = min(L::kStageBlocks, cnt - s0);
          const int flags = (s0 == 0 ? kFirst : 0) |
                            (s0 + nb == cnt ? kLast : 0);
          mbar_wait(empty(s), ph ^ 1);
          const long long slot = row * K + s0;
          int col = 0;
          if constexpr (L::kStageX) {
            if (lane < nb) col = __ldg(blk_cols + slot + lane);
          } else if (lane < nb) {
            cp_async_4(smem_addr(cols + 32 * s + lane), blk_cols + slot + lane);
            cp_async_arrive(full(s));
          }
          __syncwarp();
          if (lane == 0) {
            meta[s] = make_int4((int)row, nb, flags, cnt);
            if (nb > 0) {
              mbar_expect_tx(full(s), nb * L::kBlockBytes);
              bulk_load(smem_addr(smem + s * L::kStageBytes),
                        blocks + slot * (BM * BM), nb * L::kBlockBytes,
                        full(s), stream_once);
            } else {
              mbar_arrive(full(s));
            }
          }
          if constexpr (L::kStageX) {
            if (pending == 2) {
              issue_x(ps0, pn0, pc0);
              ps0 = ps1; pn0 = pn1; pc0 = pc1;
              ps1 = s; pn1 = nb; pc1 = col;
            } else if (pending == 1) {
              ps1 = s; pn1 = nb; pc1 = col;
              pending = 2;
            } else {
              ps0 = s; pn0 = nb; pc0 = col;
              pending = 1;
            }
          }
          if (++s == L::kStages) { s = 0; ph ^= 1; }
          s0 += nb;
        } while (s0 < cnt);
      }
    }
    if constexpr (L::kStageX) {
      if (pending > 0) issue_x(ps0, pn0, pc0);
      if (pending > 1) issue_x(ps1, pn1, pc1);
    }
    mbar_wait(empty(s), ph ^ 1);
    if (lane == 0) {
      meta[s] = make_int4(-1, 0, 0, 0);
      mbar_arrive(full(s));
      if constexpr (L::kStageX) mbar_arrive(full(s));
    }
    return;
  }

  // ---- consumers
  const int n4 = lane % L::NC;
  const int ml = (lane / L::NC) % L::ML;
  const int bp = lane / (L::NC * L::ML);
  const int m0 = warp * L::MW + ml;  // row m of pass r is m0 + r * ML
  float acc[L::R][NV], comp[L::R][NV];
  int s = 0;
  uint32_t ph = 0;
  for (;;) {
    mbar_wait(full(s), ph);
    const int4 md = meta[s];
    const int row = md.x, nb = md.y, flags = md.z, cnt = md.w;
    if (row < 0) break;
    if (flags & kFirst) {
#pragma unroll
      for (int r = 0; r < L::R; ++r)
#pragma unroll
        for (int v = 0; v < NV; ++v) acc[r][v] = comp[r][v] = 0.f;
    }
    const float4* stage = reinterpret_cast<const float4*>(
        smem + s * L::kStageBytes);
    const int* scols = cols + 32 * s;
    for (int j0 = 0; j0 < nb; j0 += L::BP) {
      const int j = j0 + bp;
      const bool ok = j < nb;
      float xs[4][NV];
      if (ok && L::kStageX) {
        load_x<false, XT, NV>(
            reinterpret_cast<const XT*>(
                smem + L::kXOff + (s * L::kStageBlocks + j) * L::kXSlot) +
                4 * n4 * NV,
            xs);
      } else if (ok) {
        load_x<true, XT, NV>(x + ((long long)scols[j] * BM + 4 * n4) * NV,
                             xs);
      } else {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int v = 0; v < NV; ++v) xs[n][v] = 0.f;
      }
      const float4* blk = stage + j * L::F + m0 * L::NC + n4;
#pragma unroll
      for (int r = 0; r < L::R; ++r) {
        const float4 b = ok ? blk[r * L::ML * L::NC]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        if (!KAHAN) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            float a = acc[r][v];
            a = fmaf(b.x, xs[0][v], a);
            a = fmaf(b.y, xs[1][v], a);
            a = fmaf(b.z, xs[2][v], a);
            a = fmaf(b.w, xs[3][v], a);
            acc[r][v] = a;
          }
        } else {
          // this block row's dot, reduced over its NC lanes, then one
          // compensated step per block of the pass, in slot order
          float d[NV];
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            float a = b.x * xs[0][v];
            a = fmaf(b.y, xs[1][v], a);
            a = fmaf(b.z, xs[2][v], a);
            d[v] = fmaf(b.w, xs[3][v], a);
          }
#pragma unroll
          for (int o = 1; o < L::NC; o <<= 1)
#pragma unroll
            for (int v = 0; v < NV; ++v)
              d[v] += __shfl_xor_sync(kFull, d[v], o);
#pragma unroll
          for (int q = 0; q < L::BP; ++q) {
            if (j0 + q >= nb) break;
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              const float p = L::BP == 1
                  ? d[v]
                  : __shfl_sync(kFull, d[v],
                                q * L::NC * L::ML + lane % (L::NC * L::ML));
              kahan_step(acc[r][v], comp[r][v], p);
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    if (++s == L::kStages) { s = 0; ph ^= 1; }
    if (!(flags & kLast)) continue;

    // ---- the block-row is complete: reduce (f32) or replay (Kahan), store
    float* yrow = y + (long long)row * BM * NV;
#pragma unroll
    for (int r = 0; r < L::R; ++r) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float a = acc[r][v];
        if (!KAHAN) {
#pragma unroll
          for (int o = 1; o < L::NC; o <<= 1)
            a += __shfl_xor_sync(kFull, a, o);
#pragma unroll
          for (int o = L::NC * L::ML; o < 32; o <<= 1)
            a += __shfl_xor_sync(kFull, a, o);
        } else {
          float c = comp[r][v];
          kahan_replay(a, c, K - cnt);
        }
        if (n4 == 0 && bp == 0) yrow[(m0 + r * L::ML) * NV + v] = a;
      }
    }
  }
}

// Launches the ring kernel on a persistent grid: as many blocks as fit on
// every SM at once (queried once per device), at most one per block-row.
template <bool KAHAN, typename XT, int BM, int NV>
int launch_ring(const void* blocks, const void* blk_cols, const void* counts,
                const void* x, void* y, long long nbr, int K,
                cudaStream_t stream) {
  constexpr int smem = Ring<KAHAN, XT, BM, NV>::kSmem;
  constexpr int kMaxDevices = 64;
  static int grid_of[kMaxDevices] = {0};
  auto kernel = bsr_spmv_ring_kernel<KAHAN, XT, BM, NV>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  if (grid_of[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid_of[dev] = per_sm * sms;
  }
  const long long grid = nbr < grid_of[dev] ? nbr : grid_of[dev];
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(blk_cols),
      static_cast<const int*>(counts), static_cast<const XT*>(x),
      static_cast<float*>(y), nbr, K);
  return (int)cudaGetLastError();
}

template <bool KAHAN, typename XT, int BM>
int ring_nv(int nv, const void* blocks, const void* blk_cols,
            const void* counts, const void* x, void* y, long long nbr, int K,
            cudaStream_t s) {
  switch (nv) {
    case 1: return launch_ring<KAHAN, XT, BM, 1>(blocks, blk_cols, counts,
                                                 x, y, nbr, K, s);
    case 2: return launch_ring<KAHAN, XT, BM, 2>(blocks, blk_cols, counts,
                                                 x, y, nbr, K, s);
    case 4: return launch_ring<KAHAN, XT, BM, 4>(blocks, blk_cols, counts,
                                                 x, y, nbr, K, s);
    case 8: return launch_ring<KAHAN, XT, BM, 8>(blocks, blk_cols, counts,
                                                 x, y, nbr, K, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool KAHAN, typename XT>
int ring_bm(int bm, int nv, const void* blocks, const void* blk_cols,
            const void* counts, const void* x, void* y, long long nbr, int K,
            cudaStream_t s) {
  switch (bm) {
    case 8: return ring_nv<KAHAN, XT, 8>(nv, blocks, blk_cols, counts, x, y,
                                         nbr, K, s);
    case 16: return ring_nv<KAHAN, XT, 16>(nv, blocks, blk_cols, counts, x,
                                           y, nbr, K, s);
    case 32: return ring_nv<KAHAN, XT, 32>(nv, blocks, blk_cols, counts, x,
                                           y, nbr, K, s);
    case 64: return ring_nv<KAHAN, XT, 64>(nv, blocks, blk_cols, counts, x,
                                           y, nbr, K, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------- generic path
constexpr int kGenericThreads = 256;

template <bool KAHAN, typename XT>
__global__ void __launch_bounds__(kGenericThreads)
bsr_spmv_generic_kernel(const float* __restrict__ blocks,
                        const int* __restrict__ blk_cols,
                        const int* __restrict__ counts,
                        const XT* __restrict__ x, float* __restrict__ y,
                        long long n_out, int K, int bm, int bn, int nv) {
  const long long g = (long long)blockIdx.x * kGenericThreads + threadIdx.x;
  if (g >= n_out) return;
  const int v = (int)(g % nv);
  const long long r = g / nv;  // padded row: i * bm + m
  const long long i = r / bm;
  const int m = (int)(r - i * bm);
  const int cnt = clamp_count(counts, i, K);
  float acc = 0.f, comp = 0.f;
  for (int k = 0; k < cnt; ++k) {
    const long long slot = i * K + k;
    const float* brow = blocks + (slot * bm + m) * (long long)bn;
    const XT* xc = x + (long long)blk_cols[slot] * bn * nv + v;
    float prod = 0.f;
    for (int n = 0; n < bn; ++n)
      prod = fmaf(brow[n], to_f32(xc[(long long)n * nv]), prod);
    if (KAHAN)
      kahan_step(acc, comp, prod);
    else
      acc = __fadd_rn(acc, prod);
  }
  if (KAHAN) kahan_replay(acc, comp, K - cnt);
  y[g] = acc;
}

template <bool KAHAN, typename XT>
int launch_generic(const void* blocks, const void* blk_cols,
                   const void* counts, const void* x, void* y, long long nbr,
                   int K, int bm, int bn, int nv, cudaStream_t stream) {
  const long long n_out = nbr * bm * (long long)nv;
  const long long grid = (n_out + kGenericThreads - 1) / kGenericThreads;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  bsr_spmv_generic_kernel<KAHAN, XT><<<(unsigned)grid, kGenericThreads, 0,
                                       stream>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(blk_cols),
      static_cast<const int*>(counts), static_cast<const XT*>(x),
      static_cast<float*>(y), n_out, K, bm, bn, nv);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// 1 where the ring path serves these operands, 0 where the generic path
// does.
int bsr_spmv_ring_path(int bm, int bn, int nv, const void* blocks,
                       const void* x) {
  return bm == bn && (bm == 8 || bm == 16 || bm == 32 || bm == 64) &&
         (nv == 1 || nv == 2 || nv == 4 || nv == 8) && aligned16(blocks) &&
         aligned16(x);
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// caller checks shapes, types, devices and contiguity, and guarantees
// 0 <= blk_cols < nbc. `counts` is the (nbr,) count of real slots per
// block-row (clamped to [0, K]); null means all K slots are read.
int bsr_spmv_launch(const void* blocks, const void* blk_cols,
                    const void* counts, const void* x, void* y,
                    long long nbr, int K, int bm, int bn, int nv, int x_half,
                    int kahan, void* stream) {
  if (nbr <= 0 || K < 0 || bm <= 0 || bn <= 0 || nv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bsr_spmv_ring_path(bm, bn, nv, blocks, x)) {
    if (kahan)
      return x_half ? ring_bm<true, __half>(bm, nv, blocks, blk_cols, counts,
                                            x, y, nbr, K, s)
                    : ring_bm<true, float>(bm, nv, blocks, blk_cols, counts,
                                           x, y, nbr, K, s);
    return x_half ? ring_bm<false, __half>(bm, nv, blocks, blk_cols, counts,
                                           x, y, nbr, K, s)
                  : ring_bm<false, float>(bm, nv, blocks, blk_cols, counts,
                                          x, y, nbr, K, s);
  }
  if (kahan)
    return x_half ? launch_generic<true, __half>(blocks, blk_cols, counts, x,
                                                 y, nbr, K, bm, bn, nv, s)
                  : launch_generic<true, float>(blocks, blk_cols, counts, x,
                                                y, nbr, K, bm, bn, nv, s);
  return x_half ? launch_generic<false, __half>(blocks, blk_cols, counts, x,
                                                y, nbr, K, bm, bn, nv, s)
                : launch_generic<false, float>(blocks, blk_cols, counts, x, y,
                                               nbr, K, bm, bn, nv, s);
}

const char* bsr_spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
