// Flash attention forward for Hopper (sm_90a) on the CUDA cores: the lane
// for float32 inputs and for bf16 at head dims other than the tensor-core
// pairs (64, 64), (128, 128), (256, 256) and (192, 128) (the smoke
// configs' 12-32), which go to flash_attention_wgmma.cu. Exported through a plain C
// interface and bound to PyTorch with ctypes
// (repro_torch/kernels/flash_attention/flash_attention.py, whose
// kernel_lane picks the lane).
//
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / G, j]) v[b, h / G, j]
//   q (B, H, S, Dk), k (B, Hkv, T, Dk), v (B, Hkv, T, Dv), float or bf16,
//   contiguous; o (B, H, S, Dv) in q's type; G = H / Hkv. When asked (lse
//   not null), also each row's base-2 log-sum-exp of its scaled scores,
//   lse[b, h, i] = log2(sum_j exp2(scale log2(e) q . k_j)) (B, H, S)
//   float32, the tensor-core lane's definition, for the backward
//   (flash_attention_bwd.cu). Asking for it leaves o as it is, bit for bit.
//
// Causal masking is aligned top-left: row i sees columns j <= i, for any S
// and T, and with a prefix (a prefix-LM) every column j < prefix too; an
// optional local window then keeps columns j > i - window (the JAX
// package's _mask). Dv may differ from Dk (DeepSeek-V3's multi-head latent
// attention: Dk = 192, Dv = 128; its smoke config 24 and 16). Columns
// j >= T (the ragged tail of the last kv tile)
// and rows i >= S (the ragged tail of the last q tile) are masked inside
// the kernel, so S and T need not be multiples of the tiles.
//
// Replaces repro/kernels/flash_attention/flash_attention.py::_kernel, which
// walks a sequential (B, H, nq, nk) grid and carries the running max,
// denominator and accumulator in VMEM scratch from one kv step to the next.
// Here one thread block owns one (b, h, q tile) and loops over the kv tiles
// itself, so nothing carries across blocks. The block reads kv head h / G
// in place: kv is never repeated in memory. Causal blocks skip the kv tiles
// that lie wholly past their last row and the prefix, as the TPU kernel's
// pl.when does, and are scheduled longest first across all heads; with a
// window, a block starts at the first kv tile its window reaches.
//
// Arithmetic: q k^T and p v are f32 FMAs on the CUDA cores (no mma, wgmma
// or TF32: this lane computes the float32 function), and the running max,
// denominator and accumulator stay in f32 registers. The softmax uses
// exp2f on scores pre-multiplied by scale * log2(e) (the same function as
// exp on the unscaled scores, up to rounding). Masked scores are -1e30, as
// in the TPU kernel, and a row whose denominator is 0 divides by 1.
//
// What bounds it: operations. At the Yi-6B prefill shape (B=1, H=32,
// Hkv=4, S=T=2048, D=128, causal) the work is 34 GFLOP against 0.1 GB of
// float32 q, k, v and o: 0.51 ms at the CUDA cores' 67 TFLOP/s. So the
// design is about keeping the FMA pipe fed:
//
// * Geometry: one block of 256 threads (8 warps, 2 per SM scheduler) per
//   128-row q tile, kv tiles of 128 keys; at D = 128 in float32 the block
//   takes 227,328 bytes of shared memory, so one block is resident per SM,
//   with up to 255 registers a thread. Blocks are launched longest first
//   across all heads (hopper.cuh's block_tile with one group: the FMAs
//   bound this lane, so the tensor-core lane's grouping of heads by L2
//   buys it nothing; at DeepSeek-V3's MLA prefill it read 5.81 ms
//   against 5.58, H100 80GB HBM3 at 700 W, tools/time_flash.py).
// * Shared memory: the q tile (128 x DKP: 67,584 bytes), a ring of two
//   chunk buffers (34,816 bytes each), the tile of probabilities p
//   (128 x 144 floats: 73,728 bytes) and each thread's running max and
//   share of the denominator for its 8 rows (16,384 bytes), kept out of
//   the registers that the 8 x 8 score and output tiles fill. Dk is padded
//   up to DKP in {64, 128, 192, 256} and Dv up to DVP in {64, 128, 256}
//   with zeros (DKP = DVP but at (192, 128)); tiles keep the inputs' type
//   with rows 16 bytes longer than their data (16-byte reads of 8
//   neighbouring rows fall in distinct banks).
// * Chunks: each kv tile streams through the ring as DKP / 64 k chunks
//   (128 keys x 64 of d) and two v chunks (64 keys x DVP), 32 KB each in
//   float32: q k^T sums over the k chunks, p v over the v chunks.
// * Copies: chunks go from global to shared memory by 16-byte cp.async
//   (.cg, zero-filled past the tensor's edge) one chunk ahead of their use:
//   chunk n + 1 lands while chunk n is computed on. bf16 chunks are copied
//   raw and widened to f32 when read into registers. Unaligned operands
//   (Dk or Dv not a multiple of 16 bytes, or a pointer off a 16-byte
//   boundary) take the same loop with synchronous loads.
// * Barriers: one block-wide barrier per chunk (chunk n has landed and
//   everyone is done with chunk n - 1's buffer): 4 per 128 keys at
//   DKP = 128. The rows of p a thread reads are written by its own
//   half-warp, so p needs only __syncwarp. The loop over a tile's chunks
//   is unrolled, so the scores are dead while p v runs.
// * Register tiles: thread (ty, tx), ty = tid / 16 and tx = tid % 16, owns
//   rows ty + 16 i (i < 8). In q k^T it holds 8 x 8 scores (keys
//   tx + 16 j), 16 16-byte shared-memory reads for 256 FMAs per 4-wide d
//   step; in p v 8 x DVP/16 outputs (columns 4 tx + 64 c + e), 16 reads
//   for 256 FMAs per 4 keys at DKP = 128. The 8 q and p reads of a step
//   are broadcasts: a warp reads 2 distinct rows. Shared memory delivers
//   128 bytes a cycle to an SM, so a warp's 16-byte read holds it for up
//   to 4 cycles, and a step's 16 reads hold it about as long as its 256
//   FMAs hold the SM's four FMA pipes: the two have to overlap, and the
//   8 x 8 tile (255 registers with the output's) is as large as fits.
// * The output rescale runs only for a row whose max moved, and the causal,
//   tail and window masks only on the tiles that cross the diagonal (past
//   the prefix), the tail or the window's lower edge.
// * Head dims above 128 (DKP or DVP = 256): a q tile of 128 rows would
//   take 133 KB of shared memory in float32 and 128 output registers a
//   thread, so the block takes 64 rows (4 a thread) and v chunks of 32
//   keys: 181,248 bytes of shared memory in float32. At (192, 128) the q
//   tile of 128 rows alone would take 100 KB, so it takes 64 rows too,
//   with three k chunks and v chunks of 64 keys: 164,864 bytes.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 128;             // keys per kv tile
constexpr int kChunk = 64;           // d columns of a k chunk
constexpr int kCols = kBK / 16;      // scores per thread and row: 8
constexpr int kLDP = kBK + 16;       // p's row stride: rows ty, ty + 1 of a
                                     // warp write disjoint banks
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The q tile and the v chunks by padded head dims: 128 q rows (8 a
// thread) up to 128, 64 rows (4 a thread) above, where the larger tiles
// overflow shared memory; v chunks of 64 keys up to DVP = 128, 32 at 256.
template <int DKP, int DVP>
struct Tile {
  static constexpr int kBQ = DKP > 128 || DVP > 128 ? 64 : 128;
  static constexpr int kRows = kBQ / 16;               // rows per thread
  static constexpr int kVC = DVP == 256 ? 32 : 64;     // keys of a v chunk
};

// Row strides in elements: the data plus 16 bytes.
template <typename T, int COLS>
__host__ __device__ constexpr int ld() {
  return COLS + 16 / (int)sizeof(T);
}

// Elements of one ring buffer: a k chunk (kBK x kChunk) or a v chunk
// (kVC x DVP), whichever is larger.
template <typename T, int DKP, int DVP>
__host__ __device__ constexpr int chunk_elems() {
  constexpr int kv = Tile<DKP, DVP>::kVC * ld<T, DVP>();
  return kBK * ld<T, kChunk>() > kv ? kBK * ld<T, kChunk>() : kv;
}

template <typename T, int DKP, int DVP>
constexpr int smem_bytes() {
  using Tl = Tile<DKP, DVP>;
  return (Tl::kBQ * ld<T, DKP>() + 2 * chunk_elems<T, DKP, DVP>()) *
             (int)sizeof(T) +
         (Tl::kBQ * kLDP + 2 * Tl::kRows * kThreads) * (int)sizeof(float);
}

// Four neighbouring elements of a shared-memory tile, widened to f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Copy the block [row0, row0 + ROWS) x [col0, col0 + COLS) of an (n, D)
// matrix into a (ROWS, COLS) tile of row stride LD, zero outside the
// matrix. vec (D a multiple of 16 bytes, the matrix on a 16-byte
// boundary): 16-byte cp.async chunks, which the caller commits and waits
// for; else synchronous element loads.
template <int ROWS, int COLS, int LD, typename T>
__device__ __forceinline__ void copy_block(T* tile, const T* src, int row0,
                                           int n, int col0, int D,
                                           bool vec) {
  if (vec) {
    constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16 bytes
    constexpr int CH = COLS / EPC;            // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += kThreads) {
      const int r = idx / CH, c = (idx % CH) * EPC;
      const bool ok = row0 + r < n && col0 + c < D;
      const T* from = ok ? src + (long long)(row0 + r) * D + col0 + c : src;
      hopper::cp_async16(hopper::smem_addr(tile + r * LD + c), from,
                         ok ? 16u : 0u);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * COLS; idx += kThreads) {
      const int r = idx / COLS, c = idx % COLS;
      tile[r * LD + c] = (row0 + r < n && col0 + c < D)
                             ? src[(long long)(row0 + r) * D + col0 + c]
                             : from_float<T>(0.f);
    }
  }
}

// Issue the copy of chunk `ph` of kv tile `kt` into `buf`: k chunks
// ph < DKP / kChunk (all kBK keys, d columns [ph * kChunk, + kChunk) of
// Dk), then v chunks (kVC keys, all Dv).
template <int DKP, int DVP, typename T>
__device__ __forceinline__ void copy_chunk(T* buf, const T* kg, const T* vg,
                                           int kt, int ph, int Tk, int Dk,
                                           int Dv, bool vec) {
  constexpr int NKC = DKP / kChunk;
  constexpr int VC = Tile<DKP, DVP>::kVC;
  if (ph < NKC)
    copy_block<kBK, kChunk, ld<T, kChunk>()>(buf, kg, kt * kBK, Tk,
                                             ph * kChunk, Dk, vec);
  else
    copy_block<VC, DVP, ld<T, DVP>()>(
        buf, vg, kt * kBK + (ph - NKC) * VC, Tk, 0, Dv, vec);
}

// Store the first n (<= 4) of v; the loops are unrolled so that v stays in
// registers (a dynamic index would put it in local memory).
__device__ __forceinline__ void store4(float* dst, const float (&v)[4], int n,
                                       bool vec) {
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) dst[e] = v[e];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst,
                                       const float (&v)[4], int n, bool vec) {
  if (vec && n == 4) {
    __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
    d2[0] = __floats2bfloat162_rn(v[0], v[1]);
    d2[1] = __floats2bfloat162_rn(v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) dst[e] = __float2bfloat16_rn(v[e]);
  }
}

// One kv tile's online softmax for the thread's ROWS rows: scale (and,
// where MASK, mask) the scores, move the running max, rescale the output and
// denominator of a row whose max moved, and write p to the thread's slots
// of the shared p tile. The running max and the thread's share of the
// denominator of row i are ms[i * kThreads] and ls[i * kThreads]: they
// wait in shared memory, not in registers, while q k^T runs.
template <bool MASK, int ROWS, int NO>
__device__ __forceinline__ void softmax_tile(
    float (&s)[ROWS][kCols], float* ms, float* ls, float (&acc)[ROWS][NO],
    float* ps, int ty, int tx, int q0, int k0, int Tk, bool causal,
    int window, int prefix, float scale_log2) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    float m = ms[i * kThreads], l = ls[i * kThreads];
    const int row = q0 + ty + 16 * i;
    float mt = kNegInf;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool ok =
          !MASK || (col < Tk && (!causal || col <= row || col < prefix) &&
                    (window == 0 || col > row - window));
      s[i][j] = ok ? s[i][j] * scale_log2 : kNegInf;
      mt = fmaxf(mt, s[i][j]);
    }
    // the 16 threads of a row are the 16 lanes of a half-warp
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
    if (mt > m) {
      const float alpha = exp2f(m - mt);
      m = mt;
      l *= alpha;
#pragma unroll
      for (int c = 0; c < NO; ++c) acc[i][c] *= alpha;
    }
    float rowsum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float p = exp2f(s[i][j] - m);
      ps[(ty + 16 * i) * kLDP + tx + 16 * j] = p;
      rowsum += p;
    }
    // l is this thread's share of the denominator (its 8 keys of each
    // tile); the shares are summed across the half-warp at the end
    ms[i * kThreads] = m;
    ls[i * kThreads] = l + rowsum;
  }
}

template <typename T, int DKP, int DVP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv,
                 int S, int Tk, int Dk, int Dv, float scale_log2, bool causal,
                 int window, int prefix, int group, bool vec) {
  using Tl = Tile<DKP, DVP>;
  constexpr int kBQ = Tl::kBQ;
  constexpr int kRows = Tl::kRows;
  constexpr int VC = Tl::kVC;
  constexpr int LDQ = ld<T, DKP>();     // q tile
  constexpr int LDV = ld<T, DVP>();     // v chunks
  constexpr int LDK = ld<T, kChunk>();  // k chunks
  constexpr int NKC = DKP / kChunk;     // k chunks per kv tile
  constexpr int NP = NKC + kBK / VC;    // chunks per kv tile
  constexpr int NC = DVP / 64;   // float4 output groups per thread and row
  constexpr int NO = 4 * NC;     // outputs per thread and row
  constexpr int kRing = chunk_elems<T, DKP, DVP>();
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);
  T* const ring = qs + kBQ * LDQ;  // chunk n is in ring + slot(n)
  auto slot = [](int n) { return (n & 1) * kRing; };
  float* ps = reinterpret_cast<float*>(qs + kBQ * LDQ + 2 * kRing);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float* ms = ps + kBQ * kLDP + tid;  // this thread's running max, and
  float* ls = ms + kRows * kThreads;  // share of the denominator, per row

  const int nq = (S + kBQ - 1) / kBQ;
  int qt, bh;
  hopper::block_tile(nq, gridDim.x / nq, group, causal, qt, bh);
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBQ;
  const long long kvh = (long long)b * Hkv + hk;
  const T* kg = k + kvh * Tk * Dk;
  const T* vg = v + kvh * Tk * Dv;

  int n_kv = (Tk + kBK - 1) / kBK;
  // causal: up to the tile of the block's last row or of the prefix's
  // last column, whichever is later
  if (causal) n_kv = min(n_kv, max(q0 + kBQ - 1, prefix - 1) / kBK + 1);
  // the first kv tile the window reaches (0 without a window)
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  copy_block<kBQ, DKP, LDQ>(qs, q + (long long)bh * S * Dk, q0, S, 0, Dk,
                            vec);
  copy_chunk<DKP, DVP>(ring, kg, vg, kt0, 0, Tk, Dk, Dv, vec);
  hopper::cp_async_commit();

  float acc[kRows][NO];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    ms[i * kThreads] = kNegInf;
    ls[i * kThreads] = 0.f;
#pragma unroll
    for (int c = 0; c < NO; ++c) acc[i][c] = 0.f;
  }

  int n = 0;  // chunks consumed
  for (int kt = kt0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;

#pragma unroll
    for (int ph = 0; ph < NP; ++ph, ++n) {
      // chunk n has landed (and, at n = 0, q); every thread is done with
      // chunk n - 1, whose buffer the next copy fills
      hopper::cp_async_wait_all();
      __syncthreads();
      if (ph + 1 < NP)
        copy_chunk<DKP, DVP>(ring + slot(n + 1), kg, vg, kt, ph + 1, Tk, Dk,
                             Dv, vec);
      else if (kt + 1 < n_kv)
        copy_chunk<DKP, DVP>(ring + slot(n + 1), kg, vg, kt + 1, 0, Tk, Dk,
                             Dv, vec);
      hopper::cp_async_commit();
      const T* buf = ring + slot(n);

      if (ph < NKC) {
        // s[i][j] += q[row ty + 16 i, d] . k[key tx + 16 j, d] over this
        // chunk's 64 d
        const T* qc = qs + ph * kChunk;
#pragma unroll 2
        for (int d = 0; d < kChunk; d += 4) {
          float4 a[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            a[i] = load4(qc + (ty + 16 * i) * LDQ + d);
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const float4 bk = load4(buf + (tx + 16 * j) * LDK + d);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              s[i][j] = fmaf(a[i].x, bk.x, s[i][j]);
              s[i][j] = fmaf(a[i].y, bk.y, s[i][j]);
              s[i][j] = fmaf(a[i].z, bk.z, s[i][j]);
              s[i][j] = fmaf(a[i].w, bk.w, s[i][j]);
            }
          }
        }
        if (ph + 1 == NKC) {
          // masks only where the tile crosses the tail, the diagonal
          // past the prefix or the window's lower edge
          const bool mask =
              k0 + kBK > Tk ||
              (causal && k0 + kBK - 1 > q0 && k0 + kBK > prefix) ||
              (window > 0 && k0 <= q0 + kBQ - 1 - window);
          if (mask)
            softmax_tile<true>(s, ms, ls, acc, ps, ty, tx, q0, k0, Tk,
                               causal, window, prefix, scale_log2);
          else
            softmax_tile<false>(s, ms, ls, acc, ps, ty, tx, q0, k0, Tk,
                                causal, window, prefix, scale_log2);
          __syncwarp();  // p's rows of this half-warp are written
        }
      } else {
        // acc += p v over this chunk's VC keys
        const float* pc = ps + (ph - NKC) * VC;
#pragma unroll 2
        for (int kk = 0; kk < VC; kk += 4) {
          float4 p4[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            p4[i] = load4(pc + (ty + 16 * i) * kLDP + kk);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const T* vrow = buf + (kk + e) * LDV + tx * 4;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const float4 vv = load4(vrow + 64 * c);
#pragma unroll
              for (int i = 0; i < kRows; ++i) {
                const float pe = e == 0 ? p4[i].x : e == 1 ? p4[i].y
                               : e == 2 ? p4[i].z : p4[i].w;
                acc[i][4 * c + 0] = fmaf(pe, vv.x, acc[i][4 * c + 0]);
                acc[i][4 * c + 1] = fmaf(pe, vv.y, acc[i][4 * c + 1]);
                acc[i][4 * c + 2] = fmaf(pe, vv.z, acc[i][4 * c + 2]);
                acc[i][4 * c + 3] = fmaf(pe, vv.w, acc[i][4 * c + 3]);
              }
            }
          }
        }
      }
    }
    __syncwarp();  // p's rows are read before the next tile writes them
  }

  // normalise and write rows < S, columns < Dv
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float li = ls[i * kThreads];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    li += __shfl_xor_sync(0xffffffffu, li, 8);
    const int row = q0 + ty + 16 * i;
    // the running max is the row's own (reduced over its 16 threads)
    if (lse != nullptr && tx == 0 && row < S)
      lse[(long long)bh * S + row] =
          li > 0.f ? ms[i * kThreads] + log2f(li) : 0.f;
    if (li == 0.f) li = 1.f;
    if (row >= S) continue;
    T* orow = o + ((long long)bh * S + row) * Dv;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx * 4 + 64 * c;
      if (col >= Dv) continue;
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = acc[i][4 * c + e] / li;
      store4(orow + col, out, min(4, Dv - col), vec);
    }
  }
}

template <typename T, int DKP, int DVP>
cudaError_t prepare() {
  return cudaFuncSetAttribute(flash_fwd_kernel<T, DKP, DVP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<T, DKP, DVP>());
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, H, Hkv, S, Tk, Dk, Dv;
  float scale;
  bool causal;
  int window, prefix;
  bool vec;
  cudaStream_t stream;
};

template <typename T, int DKP, int DVP>
cudaError_t launch(const Args& a) {
  cudaError_t err = prepare<T, DKP, DVP>();
  if (err != cudaSuccess) return err;
  constexpr int kBQ = Tile<DKP, DVP>::kBQ;
  const int nq = (a.S + kBQ - 1) / kBQ;
  if ((long long)nq * a.B * a.H > 0x7fffffff) return cudaErrorInvalidValue;
  const int group = a.B * a.H;  // one group: every head's longest first
  flash_fwd_kernel<T, DKP, DVP>
      <<<nq * a.B * a.H, kThreads, smem_bytes<T, DKP, DVP>(), a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.H,
          a.Hkv, a.S, a.Tk, a.Dk, a.Dv, a.scale * kLog2e, a.causal,
          a.window, a.prefix, group, a.vec);
  return cudaGetLastError();
}

template <typename T, int DKP, int DVP>
cudaError_t info(int* out) {
  cudaError_t err = prepare<T, DKP, DVP>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_fwd_kernel<T, DKP, DVP>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, flash_fwd_kernel<T, DKP, DVP>, kThreads,
      smem_bytes<T, DKP, DVP>());
  if (err != cudaSuccess) return err;
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = smem_bytes<T, DKP, DVP>();
  return cudaSuccess;
}

// The instantiation that head dims (Dk, Dv) take: (192, 128) where
// 128 < Dk <= 192 and Dv <= 128, else both padded to the larger's
// 64, 128 or 256.
struct Launch {
  const Args& a;
  template <typename T, int DKP, int DVP>
  cudaError_t operator()() const { return launch<T, DKP, DVP>(a); }
};

struct Info {
  int* out;
  template <typename T, int DKP, int DVP>
  cudaError_t operator()() const { return info<T, DKP, DVP>(out); }
};

template <typename T, typename Fn>
cudaError_t by_dims(int Dk, int Dv, const Fn& fn) {
  if (Dk > 128 && Dk <= 192 && Dv <= 128)
    return fn.template operator()<T, 192, 128>();
  const int d = Dk > Dv ? Dk : Dv;
  if (d <= 64) return fn.template operator()<T, 64, 64>();
  if (d <= 128) return fn.template operator()<T, 128, 128>();
  return fn.template operator()<T, 256, 256>();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). The caller
// checks shapes: H % Hkv == 0, 1 <= Dk, Dv <= 256, S, T >= 1, contiguous
// tensors; window 0 (none) or >= 1 with S <= T + window - 1; prefix >= 0
// (0: none; read only when causal); vec = Dk and Dv are multiples of 16
// bytes' worth of elements and every pointer is 16-byte aligned; lse null,
// or B * H * S floats that take each row's base-2 log-sum-exp.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse, int B, int H, int Hkv, int S,
                           int T,
                           int Dk, int Dv, float scale, int causal,
                           int window, int prefix, int bf16, int vec,
                           void* stream) {
  if (H <= 0 || Hkv <= 0 || H % Hkv != 0 || Dk < 1 || Dk > 256 || Dv < 1 ||
      Dv > 256 || S < 1 || T < 1 || B < 1 || window < 0 ||
      (window > 0 && S > T + window - 1) || prefix < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q,     k,      v,        o,  static_cast<float*>(lse),
               B,     H,      Hkv,      S,  T,
               Dk,    Dv,     scale,    causal != 0,
               window, prefix, vec != 0, static_cast<cudaStream_t>(stream)};
  const Launch go{a};
  const cudaError_t err = bf16 ? by_dims<__nv_bfloat16>(Dk, Dv, go)
                               : by_dims<float>(Dk, Dv, go);
  return (int)err;
}

// The kernel that head dims (Dk, Dv) and the type take, as compiled and
// placed on the current device: out[0] resident blocks per SM, out[1]
// threads per block, out[2] registers per thread, out[3] local (spill)
// bytes per thread, out[4] dynamic shared memory per block. Returns a
// cudaError_t.
int flash_attention_kernel_info(int Dk, int Dv, int bf16, int* out) {
  if (Dk < 1 || Dk > 256 || Dv < 1 || Dv > 256)
    return (int)cudaErrorInvalidValue;
  const Info go{out};
  const cudaError_t err = bf16 ? by_dims<__nv_bfloat16>(Dk, Dv, go)
                               : by_dims<float>(Dk, Dv, go);
  return (int)err;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
