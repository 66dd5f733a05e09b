// Flash attention backward for Hopper (sm_90a) on the CUDA cores: dq, dk
// and dv of the function that the forward lanes compute
// (flash_attention.cu, flash_attention_wgmma.cu). Exported through a plain
// C interface and bound to PyTorch with ctypes
// (repro_torch/kernels/flash_attention/flash_attention.py,
// flash_attention_bwd), reached through the torch.autograd.Function of
// repro_torch/kernels/flash_attention/ops.py. The lane of float32, and of
// bf16 at head dims other than the tensor-core backward's (64, 64),
// (128, 128) and (256, 256) (flash_attention_bwd_wgmma.cu).
//
//   o = softmax(scale * q k^T) v, masked; given o, dO = dL/do and, where
//   the forward saved it, each row's base-2 log-sum-exp lse:
//   P     = exp2(scale log2(e) q_i . k_j - lse_i)  (the forward's weights)
//   dP    = dO v^T
//   Delta = rowsum(dO o)                           (= rowsum(P dP))
//   dS    = P (dP - Delta)
//   dq = scale dS k,   dk = scale dS^T q,   dv = P^T dO
//
//   q (B, H, S, Dk), k (B, Hkv, T, Dk), v (B, Hkv, T, Dv), o and dO
//   (B, H, S, Dv), float or bf16, contiguous; lse (B, H, S) float32 or
//   null; dq, dk, dv in the inputs' type and layout. G = H / Hkv query
//   heads read kv head h / G in place, so dk and dv of kv head g sum over
//   its G query heads.
//
// Masking is the forward's (the JAX package's _mask): causal aligned
// top-left (row i sees columns j <= i, any S and T), with a prefix every
// column j < prefix too, an optional window keeping j > i - window, and the
// ragged tails of the last q and kv tiles masked inside the kernel.
//
// Replaces no TPU kernel: the Pallas flash kernel
// (repro/kernels/flash_attention/flash_attention.py) has no backward, and
// the JAX package differentiates its jnp flash loop (models/attention.py::
// flash_attn_jnp) with XLA's autodiff. The port's forward is a CUDA kernel
// called through ctypes, which autograd cannot see through, so training
// needs this kernel.
//
// Deterministic: no atomics. Every output element is written by one thread
// and summed in a fixed order, so two runs agree bit for bit. All
// arithmetic is f32 FMAs on the CUDA cores (no mma or TF32: this lane
// computes the float32 function).
//
// What bounds it: operations. The gradient's own work is 4 (Dk + Dv) flops
// a (query, key) pair (dP, dS k, dS^T q, P^T dO); this design also
// recomputes q k^T in both launches and dO v^T in the second, 2 (4 Dk +
// 3 Dv) flops a pair in all, on the CUDA cores (67 TFLOP/s). So, as in the
// forward lane (flash_attention.cu), the design is about keeping the FMA
// pipe fed from shared memory:
//
// * Launch 1 (dq), one block of 256 threads per (b, h, q tile of kBQ1
//   rows): Q and dO of the tile stay in shared memory; kv tiles of 128
//   keys stream through a two-buffer ring as chunks, each copied while the
//   one before is computed on: K in d-chunks (S = Q K^T), V in d-chunks
//   (dP = dO V^T), then K in key-chunks (dq += dS K). P goes to a shared
//   tile after the S chunks, dS = P (dP - Delta) over it after the dP
//   chunks. The block forms Delta from o and dO, in the order and rounding
//   of dP's sums (so that dP - Delta is exactly 0 where it is in exact
//   arithmetic, as for a row that sees one key), and writes it to a
//   workspace for launch 2. Given the forward's lse, P reads it; without
//   one, a first pass over the K d-chunks rebuilds it (each thread's
//   running max and sum over its columns, combined over the row's 16
//   threads), writes it to the workspace, and the main pass follows.
// * Launch 2 (dk, dv), one block per (b, kv head g, kv tile of kBK2 keys):
//   K and V of the tile stay in shared memory; the group's G heads' q
//   tiles of 128 rows stream through the ring: Q in d-chunks (S^T =
//   K Q^T), dO in d-chunks (dP^T = V dO^T), dO in row-chunks (dv += P^T
//   dO), then Q in row-chunks (dk += dS^T Q). P^T goes to a shared tile,
//   and dS^T replaces it there once dv has read it, so one tile of
//   128 + 16 columns serves both.
// * Register tiles: thread (ty, tx), ty = tid / 16 and tx = tid % 16, owns
//   rows ty + 16 i of a score tile (queries in launch 1, keys in launch 2)
//   and its columns tx + 16 j, j < 8: 8 x 8 scores where kBQ1 or kBK2 is
//   128, 16 shared-memory reads for 256 FMAs a 4-wide d step, as in the
//   forward. The row operand's reads are broadcasts (a warp reads 2 rows).
//   In the products over a tile's columns (dq, dk, dv) a head dim of 64 or
//   192 keeps that layout (columns 4 tx + 64 c + e of rows ty + 16 i),
//   and 128 or 256 lays a warp along 128 columns of one row (columns
//   4 lane + 128 c + e of rows warp + 8 i): at 256, 8 x 8 outputs a thread
//   in launch 1 and 4 x 8 in launch 2 where 4 x 16 and 2 x 16 took a
//   quarter more shared-memory reads. Only one score tile is in registers
//   at a time: P leaves for shared memory before dP is formed, so launch
//   2 at D = 64 holds dk, dv (64), dP^T (64) and the operands.
// * Inputs keep their own type in shared memory, with rows 16 bytes longer
//   than their data (the 16-byte reads of 8 neighbouring rows fall in
//   distinct banks); bf16 is copied raw and widened to f32 when read into
//   registers. Copies are 16-byte cp.async (.cg, zero-filled past the
//   tensor's edge); unaligned operands (Dk or Dv not a multiple of 16
//   bytes, or a pointer off a 16-byte boundary) take the same loop with
//   synchronous loads. The score tile's rows are 128 + 16 floats, so rows
//   ty and ty + 1 of a warp write disjoint banks. A chunk's barrier orders
//   the score tile's writes before the products that read it; dS^T
//   overwrites P^T in place once every thread that reads P^T's rows (its
//   own half-warp in the 64-column layout) has read them.
// * Tile sizes by padded head dims (DKP, DVP in {64, 128, 192, 256},
//   zero-padded; (192, 128) its own, else both the larger's): launch 1
//   takes 128 rows while both are 64, else 64 (8 or 4 rows a thread);
//   launch 2 takes 128 keys while both are 64, 64 up to 192 and 32 at 256
//   (8, 4 or 2 keys a thread: dk and dv are 4 (DKP + DVP) / 64 floats a
//   key, and at 256 a 32-key tile also keeps RecurrentGemma-2B's one kv
//   head at 128 blocks). d-chunks are 64 columns (32 in launch 1 at 256,
//   where Q and dO of 64 rows fill 133 KB), row-chunks as many rows as fit
//   in a ring buffer. At D = 64 in float32 each launch takes 214,016 bytes
//   of shared memory: one block per SM.
// * The masks (causal past the prefix, window, ragged tails) run only on
//   the tiles that cross an edge; a q tile's kv loop starts at the first
//   tile its window reaches and ends at the last one it sees, and a kv
//   tile's q loop likewise. Blocks run longest first: launch 1 from the
//   last q tile (causal rows see the most keys), launch 2 from the first
//   kv tile.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK1 = 128;        // keys of a kv tile in launch 1
constexpr int kBQ2 = 128;        // rows of a q tile in launch 2
constexpr int kCols = 8;         // score columns a thread: 128 / 16
constexpr int kLDP = 128 + 16;   // the score tile's row stride in floats
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Threads along the columns of an accumulated tile (dq, dk or dv) of DP
// columns: 32 where DP is a multiple of 128 (a warp over 128 columns of
// one row, each thread 4 columns in groups 128 apart; the rows 8 apart),
// else 16 (a half-warp over 64 columns; two rows a warp, 16 apart).
template <int DP>
__host__ __device__ constexpr int acc_nx() {
  return DP % 128 == 0 ? 32 : 16;
}

// Row strides in elements: the data plus 16 bytes.
template <typename T, int COLS>
__host__ __device__ constexpr int ld() {
  return COLS + 16 / (int)sizeof(T);
}

// The most rows (128, 64, 32 or 16) of COLS columns that fit in `elems`.
template <typename T, int COLS>
__host__ __device__ constexpr int rows_in(int elems) {
  int r = 128;
  while (r > 16 && r * ld<T, COLS>() > elems) r /= 2;
  return r;
}

// The tiles and chunk schedules of both launches by type and padded head
// dims.
template <typename T, int DKP, int DVP>
struct Geo {
  static constexpr int kMax = DKP > DVP ? DKP : DVP;
  // launch 1: q tiles of kBQ1 rows (kR1 a thread); per kv tile kNKD1 K
  // d-chunks and kNVD1 V d-chunks of 128 keys x kCD1 columns, then kNKC1
  // K key-chunks of kKC1 keys x DKP
  static constexpr int kBQ1 = kMax <= 64 ? 128 : 64;
  static constexpr int kR1 = kBQ1 / 16;
  static constexpr int kCD1 = kMax == 256 ? 32 : 64;
  static constexpr int kSlot1 = kBK1 * ld<T, kCD1>();  // a ring buffer
  static constexpr int kKC1 = rows_in<T, DKP>(kSlot1);
  static constexpr int kNKD1 = DKP / kCD1, kNVD1 = DVP / kCD1;
  static constexpr int kNKC1 = kBK1 / kKC1;
  // launch 2: kv tiles of kBK2 keys (kR2 a thread); per q tile kNKD2 Q
  // d-chunks and kNVD2 dO d-chunks of 128 rows x 64 columns, then kNQV dO
  // row-chunks of kQCV rows x DVP and kNQK Q row-chunks of kQCK rows x DKP
  static constexpr int kBK2 = kMax <= 64 ? 128 : kMax <= 192 ? 64 : 32;
  static constexpr int kR2 = kBK2 / 16;
  static constexpr int kCD2 = 64;
  static constexpr int kSlot2 = kBQ2 * ld<T, kCD2>();
  static constexpr int kQCV = rows_in<T, DVP>(kSlot2);
  static constexpr int kQCK = rows_in<T, DKP>(kSlot2);
  static constexpr int kNKD2 = DKP / kCD2, kNVD2 = DVP / kCD2;
  static constexpr int kNQV = kBQ2 / kQCV, kNQK = kBQ2 / kQCK;
  static_assert(kKC1 * ld<T, DKP>() <= kSlot1 &&
                    kQCV * ld<T, DVP>() <= kSlot2 &&
                    kQCK * ld<T, DKP>() <= kSlot2,
                "a row-chunk overflows a ring buffer");
};

// Shared memory of launch 1: Q and dO of the q tile, the ring, the score
// tile, each row's lse and Delta.
template <typename T, int DKP, int DVP>
constexpr int dq_smem_bytes() {
  using G = Geo<T, DKP, DVP>;
  return (G::kBQ1 * (ld<T, DKP>() + ld<T, DVP>()) + 2 * G::kSlot1) *
             (int)sizeof(T) +
         (G::kBQ1 * kLDP + 2 * G::kBQ1) * (int)sizeof(float);
}

// Shared memory of launch 2: K and V of the kv tile, the ring, the score
// tile (P^T, then dS^T), the q tile's rows' lse and Delta.
template <typename T, int DKP, int DVP>
constexpr int dkv_smem_bytes() {
  using G = Geo<T, DKP, DVP>;
  return (G::kBK2 * (ld<T, DKP>() + ld<T, DVP>()) + 2 * G::kSlot2) *
             (int)sizeof(T) +
         (G::kBK2 * kLDP + 2 * kBQ2) * (int)sizeof(float);
}

// the most dynamic shared memory a block may take on an H100
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four neighbouring elements (of a shared-memory tile, or of a row in
// device memory on a 16-byte (float) or 8-byte (bf16) boundary), widened
// to f32.
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

// s[i][j] += sum over CD columns of a[ty + 16 i][.] * b[tx + 16 j][.]: a is
// the resident tile (at the chunk's first column), b the chunk.
template <int RA, int CD, int LDA, int LDB, typename T>
__device__ __forceinline__ void dot_chunk(float (&s)[RA][kCols], const T* a,
                                          const T* b, int ty, int tx) {
#pragma unroll 2
  for (int d = 0; d < CD; d += 4) {
    float4 av[RA];
#pragma unroll
    for (int i = 0; i < RA; ++i) av[i] = load4(a + (ty + 16 * i) * LDA + d);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float4 bv = load4(b + (tx + 16 * j) * LDB + d);
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        s[i][j] = fmaf(av[i].x, bv.x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv.y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv.z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv.w, s[i][j]);
      }
    }
  }
}

// out[i][4 c + e] += sum_kk w[ay + RS i][kk] * m[kk][4 ax + 4 NX c + e]
// over the KC rows of a row-chunk m (row stride LDM, DP columns): thread
// (ay, ax) = (tid / NX, tid % NX), NX = acc_nx<DP>(), RS = 256 / NX; w is
// the score tile at the chunk's first column.
template <int R, int DP, int KC, int LDM, typename T>
__device__ __forceinline__ void acc_chunk(float (&out)[R][DP / acc_nx<DP>()],
                                          const float* w, const T* m,
                                          int tid) {
  constexpr int NX = acc_nx<DP>(), RS = kThreads / NX, NC = DP / (4 * NX);
  const int ay = tid / NX, ax = tid % NX;
#pragma unroll 2
  for (int kk = 0; kk < KC; kk += 4) {
    float4 wv[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      wv[i] = *reinterpret_cast<const float4*>(w + (ay + RS * i) * kLDP + kk);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const T* mrow = m + (kk + e) * LDM + 4 * ax;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 mv = load4(mrow + 4 * NX * c);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float we = e == 0 ? wv[i].x : e == 1 ? wv[i].y
                         : e == 2 ? wv[i].z : wv[i].w;
          out[i][4 * c + 0] = fmaf(we, mv.x, out[i][4 * c + 0]);
          out[i][4 * c + 1] = fmaf(we, mv.y, out[i][4 * c + 1]);
          out[i][4 * c + 2] = fmaf(we, mv.z, out[i][4 * c + 2]);
          out[i][4 * c + 3] = fmaf(we, mv.w, out[i][4 * c + 3]);
        }
      }
    }
  }
}

// Whether row (query) `row` sees column (key) `col`.
__device__ __forceinline__ bool visible(int row, int col, int S, int Tk,
                                        bool causal, int window,
                                        int prefix) {
  return row < S && col < Tk && (!causal || col <= row || col < prefix) &&
         (window == 0 || col > row - window);
}

// Whether the tile of rows [q0, q0 + nr) and columns [k0, k0 + nc) crosses
// an edge of the mask: the tails, the diagonal past the prefix, the
// window's lower edge.
__device__ __forceinline__ bool tile_masked(int q0, int nr, int k0, int nc,
                                            int S, int Tk, bool causal,
                                            int window, int prefix) {
  return k0 + nc > Tk || q0 + nr > S ||
         (causal && k0 + nc - 1 > q0 && k0 + nc > prefix) ||
         (window > 0 && k0 <= q0 + nr - 1 - window);
}

// Launch 1's P = exp2(s c2 - lse_row), masked where MASK, into the
// thread's slots of the score tile (rows: queries, columns: keys).
template <bool MASK, int R>
__device__ __forceinline__ void probs_rows(const float (&s)[R][kCols],
                                           float* ps, const float* lse_s,
                                           float c2, int q0, int k0, int S,
                                           int Tk, bool causal, int window,
                                           int prefix, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    const float lr = lse_s[r];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + 16 * j;
      const bool ok =
          !MASK || visible(q0 + r, k0 + col, S, Tk, causal, window, prefix);
      ps[r * kLDP + col] = ok ? exp2f(fmaf(s[i][j], c2, -lr)) : 0.f;
    }
  }
}

// Launch 2's P^T = exp2(s c2 - lse_column), masked where MASK, into the
// thread's slots of the score tile (rows: keys, columns: queries).
template <bool MASK, int R>
__device__ __forceinline__ void probs_cols(const float (&s)[R][kCols],
                                           float* pts, const float* lse_s,
                                           float c2, int q0, int k0, int S,
                                           int Tk, bool causal, int window,
                                           int prefix, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int qc = tx + 16 * j;
      const bool ok =
          !MASK || visible(q0 + qc, k0 + r, S, Tk, causal, window, prefix);
      pts[r * kLDP + qc] = ok ? exp2f(fmaf(s[i][j], c2, -lse_s[qc])) : 0.f;
    }
  }
}

// Write rows ay + RS i (< n) and columns 4 ax + 4 NX c + e (< D) of an
// accumulated tile (acc_chunk's layout), times `mult`, into rows
// [row0, ..) of an (n, D) matrix.
template <int R, int DP, typename T>
__device__ __forceinline__ void store_tile(
    T* dst, const float (&acc)[R][DP / acc_nx<DP>()], float mult, int row0,
    int n, int D, int tid) {
  constexpr int NX = acc_nx<DP>(), RS = kThreads / NX, NC = DP / (4 * NX);
  const int ay = tid / NX, ax = tid % NX;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + ay + RS * i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * ax + 4 * NX * c + e;
        if (col < D)
          dst[(long long)row * D + col] =
              from_float<T>(acc[i][4 * c + e] * mult);
      }
  }
}

// Launch 1: dq, and each row's Delta (and, when REBUILD, its base-2
// log-sum-exp) into the workspace (B * H * S floats each). REBUILD: no lse
// was given (lse_in is null).
template <typename T, int DKP, int DVP, bool REBUILD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse_in, T* __restrict__ dq,
                    float* __restrict__ ws_lse, float* __restrict__ ws_delta,
                    int BH, int H, int Hkv, int S, int Tk, int Dk, int Dv,
                    float scale, bool causal, int window, int prefix,
                    bool vec) {
  using G = Geo<T, DKP, DVP>;
  constexpr int BQ = G::kBQ1, R = G::kR1, CD = G::kCD1, KC = G::kKC1;
  constexpr int NKD = G::kNKD1, NVD = G::kNVD1, NKC = G::kNKC1;
  constexpr int NP = NKD + NVD + NKC;  // chunks a kv tile
  constexpr int LDQ = ld<T, DKP>(), LDO = ld<T, DVP>(), LDC = ld<T, CD>();
  // dq's layout (acc_chunk): AR rows a thread, AC columns
  constexpr int AR = BQ * acc_nx<DKP>() / kThreads, AC = DKP / acc_nx<DKP>();
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);
  T* dos = qs + BQ * LDQ;
  T* const ring = dos + BQ * LDO;  // chunk n is in ring + (n & 1) * kSlot1
  float* ps = reinterpret_cast<float*>(ring + 2 * G::kSlot1);
  float* lse_s = ps + BQ * kLDP;
  float* delta_s = lse_s + BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float c2 = scale * kLog2e;

  const int nq = (S + BQ - 1) / BQ;
  const int t = blockIdx.x / BH, bh = blockIdx.x % BH;
  const int qt = causal ? nq - 1 - t : t;  // longest first
  const int b = bh / H, h = bh % H;
  const int q0 = qt * BQ;
  const long long kvh = (long long)b * Hkv + h / (H / Hkv);
  const T* kg = k + kvh * Tk * Dk;
  const T* vg = v + kvh * Tk * Dv;
  const long long qrow0 = (long long)bh * S;  // row 0 of this head

  int n_kv = (Tk + kBK1 - 1) / kBK1;
  // causal: up to the tile of the block's last row or of the prefix's
  // last column, whichever is later; a window starts at its first tile
  if (causal) n_kv = min(n_kv, max(q0 + BQ - 1, prefix - 1) / kBK1 + 1);
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / kBK1 : 0;
  const int tiles = max(0, n_kv - kt0);
  const int n_stat = REBUILD ? tiles * NKD : 0;  // the rebuild's chunks
  const int total = n_stat + tiles * NP;

  // Chunk n: the rebuild's K d-chunks, then per kv tile its K d-chunks, V
  // d-chunks and K key-chunks.
  auto fetch = [&](int n) {
    T* buf = ring + (n & 1) * G::kSlot1;
    int kt, p;
    if (n < n_stat) {
      kt = kt0 + n / NKD;
      p = n % NKD;
    } else {
      kt = kt0 + (n - n_stat) / NP;
      p = (n - n_stat) % NP;
    }
    const int k0 = kt * kBK1;
    if (p < NKD)
      copy_block<kBK1, CD, LDC>(buf, kg, k0, Tk, p * CD, Dk, vec);
    else if (p < NKD + NVD)
      copy_block<kBK1, CD, LDC>(buf, vg, k0, Tk, (p - NKD) * CD, Dv, vec);
    else
      copy_block<KC, DKP, LDQ>(buf, kg, k0 + (p - NKD - NVD) * KC, Tk, 0,
                               Dk, vec);
  };
  copy_block<BQ, DKP, LDQ>(qs, q + qrow0 * Dk, q0, S, 0, Dk, vec);
  copy_block<BQ, DVP, LDO>(dos, dout + qrow0 * Dv, q0, S, 0, Dv, vec);
  if (total > 0) fetch(0);
  hopper::cp_async_commit();
  int n = 0;  // chunks consumed
  // Wait for chunk n (and, at n = 0, Q and dO), let every thread finish
  // with chunk n - 1, whose buffer then takes chunk n + 1.
  auto next = [&]() -> const T* {
    hopper::cp_async_wait_all();
    __syncthreads();
    if (n + 1 < total) fetch(n + 1);
    hopper::cp_async_commit();
    return ring + (n++ & 1) * G::kSlot1;
  };

  // Delta of each row from o and dO in device memory, one thread a row, in
  // the order and rounding of dP's sums (an fmaf chain over d ascending),
  // so that where dP - Delta is 0 in exact arithmetic (a row that sees one
  // key: o is that key's v) it is 0 here too; and the given lse
  if (tid < BQ) {
    const int row = q0 + tid;
    float acc = 0.f;
    if (row < S) {
      const T* orow = o + (qrow0 + row) * Dv;
      const T* drow = dout + (qrow0 + row) * Dv;
      if (vec) {
#pragma unroll 4
        for (int c = 0; c < Dv; c += 4) {
          const float4 a = load4(orow + c), d = load4(drow + c);
          acc = fmaf(a.x, d.x, acc);
          acc = fmaf(a.y, d.y, acc);
          acc = fmaf(a.z, d.z, acc);
          acc = fmaf(a.w, d.w, acc);
        }
      } else {
        for (int c = 0; c < Dv; ++c)
          acc = fmaf(to_float(orow[c]), to_float(drow[c]), acc);
      }
    }
    delta_s[tid] = acc;
    if (!REBUILD) lse_s[tid] = row < S ? lse_in[qrow0 + row] : 0.f;
  }

  if constexpr (REBUILD) {
    // each thread's running max and sum of exp2 over its columns
    float m[R], l[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
    }
    for (int kt = kt0; kt < n_kv; ++kt) {
      const int k0 = kt * kBK1;
      float s[R][kCols];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
      for (int c = 0; c < NKD; ++c) {
        const T* buf = next();
        dot_chunk<R, CD, LDQ, LDC>(s, qs + c * CD, buf, ty, tx);
      }
      const bool mask =
          tile_masked(q0, BQ, k0, kBK1, S, Tk, causal, window, prefix);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = q0 + ty + 16 * i;
        float mt = kNegInf;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const bool ok = !mask || visible(row, k0 + tx + 16 * j, S, Tk,
                                           causal, window, prefix);
          s[i][j] = ok ? s[i][j] * c2 : kNegInf;
          mt = fmaxf(mt, s[i][j]);
        }
        if (mt > m[i]) {
          l[i] *= exp2f(m[i] - mt);
          m[i] = mt;
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (s[i][j] > kNegInf) l[i] += exp2f(s[i][j] - m[i]);
      }
    }
    // combine the row's 16 threads: lse = M + log2(sum l exp2(m - M))
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mm = m[i];
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 1));
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 2));
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 4));
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 8));
      float ll = l[i] > 0.f ? l[i] * exp2f(m[i] - mm) : 0.f;
      ll += __shfl_xor_sync(0xffffffffu, ll, 1);
      ll += __shfl_xor_sync(0xffffffffu, ll, 2);
      ll += __shfl_xor_sync(0xffffffffu, ll, 4);
      ll += __shfl_xor_sync(0xffffffffu, ll, 8);
      const int r = ty + 16 * i;
      if (tx == 0) {
        // a row that sees no column (a padded row past S) keeps 0
        const float lr = ll > 0.f ? mm + log2f(ll) : 0.f;
        lse_s[r] = lr;
        if (q0 + r < S) ws_lse[qrow0 + q0 + r] = lr;
      }
    }
  }

  float acc[AR][AC];
#pragma unroll
  for (int i = 0; i < AR; ++i)
#pragma unroll
    for (int c = 0; c < AC; ++c) acc[i][c] = 0.f;
  for (int kt = kt0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK1;
    const bool mask =
        tile_masked(q0, BQ, k0, kBK1, S, Tk, causal, window, prefix);
    {
      float s[R][kCols];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
      for (int c = 0; c < NKD; ++c) {
        const T* buf = next();
        dot_chunk<R, CD, LDQ, LDC>(s, qs + c * CD, buf, ty, tx);
      }
      if (mask)
        probs_rows<true>(s, ps, lse_s, c2, q0, k0, S, Tk, causal, window,
                         prefix, ty, tx);
      else
        probs_rows<false>(s, ps, lse_s, c2, q0, k0, S, Tk, causal, window,
                          prefix, ty, tx);
    }
    {
      float dp[R][kCols];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) dp[i][j] = 0.f;
      for (int c = 0; c < NVD; ++c) {
        const T* buf = next();
        dot_chunk<R, CD, LDO, LDC>(dp, dos + c * CD, buf, ty, tx);
      }
      // dS = P (dP - Delta) over the thread's own slots of P
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = ty + 16 * i;
        const float dr = delta_s[r];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float* at = ps + r * kLDP + tx + 16 * j;
          *at = *at * (dp[i][j] - dr);
        }
      }
    }
    for (int c = 0; c < NKC; ++c) {  // next()'s barrier: dS is written
      const T* buf = next();
      acc_chunk<AR, DKP, KC, LDQ>(acc, ps + c * KC, buf, tid);
    }
  }
  hopper::cp_async_wait_all();  // a block with no kv tile waits for Q, dO
  __syncthreads();              // delta_s is written
  store_tile<AR, DKP>(dq + qrow0 * Dk, acc, scale, q0, S, Dk, tid);
  if (tid < BQ && q0 + tid < S) ws_delta[qrow0 + q0 + tid] = delta_s[tid];
}

// Launch 2: dk and dv of one kv tile of kv head g, summed over the G query
// heads of its group and the q tiles that see the tile.
template <typename T, int DKP, int DVP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int BHkv, int H, int Hkv, int S,
                     int Tk, int Dk, int Dv, float scale, bool causal,
                     int window, int prefix, bool vec) {
  using G = Geo<T, DKP, DVP>;
  constexpr int BK = G::kBK2, R = G::kR2, CD = G::kCD2;
  constexpr int QCV = G::kQCV, QCK = G::kQCK;
  constexpr int NKD = G::kNKD2, NVD = G::kNVD2, NQV = G::kNQV, NQK = G::kNQK;
  constexpr int NP = NKD + NVD + NQV + NQK;  // chunks a q tile
  constexpr int LDK = ld<T, DKP>(), LDV = ld<T, DVP>(), LDC = ld<T, CD>();
  // dk's and dv's layouts (acc_chunk): KR, VR rows a thread, KCOL, VCOL
  // columns
  constexpr int KR = BK * acc_nx<DKP>() / kThreads, KCOL = DKP / acc_nx<DKP>();
  constexpr int VR = BK * acc_nx<DVP>() / kThreads, VCOL = DVP / acc_nx<DVP>();
  extern __shared__ float4 smem4[];
  T* ks = reinterpret_cast<T*>(smem4);
  T* vs = ks + BK * LDK;
  T* const ring = vs + BK * LDV;  // chunk n is in ring + (n & 1) * kSlot2
  float* pts = reinterpret_cast<float*>(ring + 2 * G::kSlot2);
  float* lse_s = pts + BK * kLDP;  // the q tile's rows' lse
  float* delta_s = lse_s + kBQ2;   // and Delta
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float c2 = scale * kLog2e;
  const int G_ = H / Hkv;

  const int kt = blockIdx.x / BHkv, bg = blockIdx.x % BHkv;  // longest first
  const int b = bg / Hkv, g = bg % Hkv;
  const int k0 = kt * BK;
  const long long kvh = (long long)b * Hkv + g;

  // the q tiles whose rows see a column of this tile
  const int nq = (S + kBQ2 - 1) / kBQ2;
  const int qt0 = causal && k0 >= prefix ? k0 / kBQ2 : 0;
  int qt1 = nq;
  if (window > 0) {
    const int c_max = min(k0 + BK, Tk) - 1;
    qt1 = min(nq, (c_max + window - 1) / kBQ2 + 1);
  }
  const int nqt = max(0, qt1 - qt0);
  const int tiles = G_ * nqt;  // (head, q tile) pairs, head-major
  const int total = tiles * NP;
  auto row0 = [&](int tile) {  // the tile's head's row 0
    return ((long long)b * H + g * G_ + tile / nqt) * S;
  };

  // Chunk n: per q tile its Q d-chunks, dO d-chunks, dO row-chunks and Q
  // row-chunks.
  auto fetch = [&](int n) {
    T* buf = ring + (n & 1) * G::kSlot2;
    const int tile = n / NP, p = n % NP;
    const long long r0 = row0(tile);
    const int q0 = (qt0 + tile % nqt) * kBQ2;
    if (p < NKD)
      copy_block<kBQ2, CD, LDC>(buf, q + r0 * Dk, q0, S, p * CD, Dk, vec);
    else if (p < NKD + NVD)
      copy_block<kBQ2, CD, LDC>(buf, dout + r0 * Dv, q0, S, (p - NKD) * CD,
                                Dv, vec);
    else if (p < NKD + NVD + NQV)
      copy_block<QCV, DVP, LDV>(buf, dout + r0 * Dv,
                                q0 + (p - NKD - NVD) * QCV, S, 0, Dv, vec);
    else
      copy_block<QCK, DKP, LDK>(buf, q + r0 * Dk,
                                q0 + (p - NKD - NVD - NQV) * QCK, S, 0, Dk,
                                vec);
  };
  // lse and Delta of the tile's q rows (rows >= S: 0)
  auto load_rows = [&](int tile) {
    if (tid < kBQ2) {
      const int row = (qt0 + tile % nqt) * kBQ2 + tid;
      const bool in = row < S;
      const long long at = row0(tile) + row;
      lse_s[tid] = in ? lse[at] : 0.f;
      delta_s[tid] = in ? delta[at] : 0.f;
    }
  };
  copy_block<BK, DKP, LDK>(ks, k + kvh * Tk * Dk, k0, Tk, 0, Dk, vec);
  copy_block<BK, DVP, LDV>(vs, v + kvh * Tk * Dv, k0, Tk, 0, Dv, vec);
  if (total > 0) {
    fetch(0);
    load_rows(0);
  }
  hopper::cp_async_commit();
  int n = 0;  // chunks consumed
  auto next = [&]() -> const T* {
    hopper::cp_async_wait_all();
    __syncthreads();
    if (n + 1 < total) fetch(n + 1);
    hopper::cp_async_commit();
    return ring + (n++ & 1) * G::kSlot2;
  };

  float dka[KR][KCOL], dva[VR][VCOL];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int c = 0; c < KCOL; ++c) dka[i][c] = 0.f;
#pragma unroll
  for (int i = 0; i < VR; ++i)
#pragma unroll
    for (int c = 0; c < VCOL; ++c) dva[i][c] = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    const int q0 = (qt0 + tile % nqt) * kBQ2;
    const bool mask =
        tile_masked(q0, kBQ2, k0, BK, S, Tk, causal, window, prefix);
    {
      // keys ty + 16 i of the kv tile against queries tx + 16 j
      float s[R][kCols];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
      for (int c = 0; c < NKD; ++c) {
        const T* buf = next();
        dot_chunk<R, CD, LDK, LDC>(s, ks + c * CD, buf, ty, tx);
      }
      if (mask)
        probs_cols<true>(s, pts, lse_s, c2, q0, k0, S, Tk, causal, window,
                         prefix, ty, tx);
      else
        probs_cols<false>(s, pts, lse_s, c2, q0, k0, S, Tk, causal, window,
                          prefix, ty, tx);
    }
    float dp[R][kCols];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) dp[i][j] = 0.f;
    for (int c = 0; c < NVD; ++c) {
      const T* buf = next();
      dot_chunk<R, CD, LDV, LDC>(dp, vs + c * CD, buf, ty, tx);
    }
    for (int c = 0; c < NQV; ++c) {
      const T* buf = next();
      acc_chunk<VR, DVP, QCV, LDV>(dva, pts + c * QCV, buf, tid);
    }
    // every thread that reads P^T's rows (its own half-warp in the
    // 16-column layout) has read them
    if constexpr (acc_nx<DVP>() == 16)
      __syncwarp();
    else
      __syncthreads();
    // dS^T = P^T (dP^T - Delta) over the thread's own slots
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int qc = tx + 16 * j;
        float* at = pts + r * kLDP + qc;
        *at = *at * (dp[i][j] - delta_s[qc]);
      }
    }
    for (int c = 0; c < NQK; ++c) {
      const T* buf = next();
      // every thread is past this tile's reads of lse_s and delta_s
      if (c == NQK - 1 && tile + 1 < tiles) load_rows(tile + 1);
      acc_chunk<KR, DKP, QCK, LDK>(dka, pts + c * QCK, buf, tid);
    }
  }
  hopper::cp_async_wait_all();  // a block that no row sees waits for K, V
  store_tile<KR, DKP>(dk + kvh * Tk * Dk, dka, scale, k0, Tk, Dk, tid);
  store_tile<VR, DVP>(dv + kvh * Tk * Dv, dva, 1.f, k0, Tk, Dv, tid);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // null: rebuilt in launch 1
  void *dq, *dk, *dv;
  float *ws_lse, *ws_delta;
  int B, H, Hkv, S, Tk, Dk, Dv;
  float scale;
  bool causal;
  int window, prefix;
  bool vec;
  cudaStream_t stream;
};

template <typename T, int DKP, int DVP>
cudaError_t launch(const Args& a) {
  using G = Geo<T, DKP, DVP>;
  static_assert(dq_smem_bytes<T, DKP, DVP>() <= kMaxSmem &&
                    dkv_smem_bytes<T, DKP, DVP>() <= kMaxSmem,
                "a launch overflows shared memory");
  auto* k1 = a.lse != nullptr ? flash_bwd_dq_kernel<T, DKP, DVP, false>
                              : flash_bwd_dq_kernel<T, DKP, DVP, true>;
  auto* k2 = flash_bwd_dkv_kernel<T, DKP, DVP>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_smem_bytes<T, DKP, DVP>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_smem_bytes<T, DKP, DVP>());
  if (err != cudaSuccess) return err;
  const long long nq = (a.S + G::kBQ1 - 1) / G::kBQ1;
  const long long nk = (a.Tk + G::kBK2 - 1) / G::kBK2;
  const long long BH = (long long)a.B * a.H, BHkv = (long long)a.B * a.Hkv;
  if (nq * BH > 0x7fffffff || nk * BHkv > 0x7fffffff)
    return cudaErrorInvalidValue;
  k1<<<(int)(nq * BH), kThreads, dq_smem_bytes<T, DKP, DVP>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), a.lse, static_cast<T*>(a.dq), a.ws_lse,
      a.ws_delta, (int)BH, a.H, a.Hkv, a.S, a.Tk, a.Dk, a.Dv, a.scale,
      a.causal, a.window, a.prefix, a.vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<(int)(nk * BHkv), kThreads, dkv_smem_bytes<T, DKP, DVP>(),
       a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      a.lse != nullptr ? a.lse : a.ws_lse, a.ws_delta,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), (int)BHkv, a.H, a.Hkv,
      a.S, a.Tk, a.Dk, a.Dv, a.scale, a.causal, a.window, a.prefix, a.vec);
  return cudaGetLastError();
}

// The instantiation that head dims (Dk, Dv) take, as in the forward:
// (192, 128) where 128 < Dk <= 192 and Dv <= 128, else both padded to the
// larger's 64, 128 or 256.
template <typename T>
cudaError_t by_dims(const Args& a) {
  if (a.Dk > 128 && a.Dk <= 192 && a.Dv <= 128)
    return launch<T, 192, 128>(a);
  const int d = a.Dk > a.Dv ? a.Dk : a.Dv;
  if (d <= 64) return launch<T, 64, 64>(a);
  if (d <= 128) return launch<T, 128, 128>(a);
  return launch<T, 256, 256>(a);
}

}  // namespace

extern "C" {

// Two launches on `stream`; returns cudaGetLastError() after them (0 on
// success). The caller checks shapes: H % Hkv == 0, 1 <= Dk, Dv <= 256,
// B, S, T >= 1, contiguous tensors; window 0 (none) or >= 1 with
// S <= T + window - 1; prefix >= 0 (0: none; read only when causal); lse
// null (rebuilt) or the forward's (B, H, S) float32; vec = Dk and Dv are
// multiples of 16 bytes' worth of elements and q, k, v, o and dout are
// 16-byte aligned. The workspace holds 2 * B * H * S floats.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* dq, void* dk, void* dv,
                               void* workspace, int B, int H, int Hkv, int S,
                               int T, int Dk, int Dv, float scale,
                               int causal, int window, int prefix, int bf16,
                               int vec, void* stream) {
  if (H <= 0 || Hkv <= 0 || H % Hkv != 0 || Dk < 1 || Dk > 256 || Dv < 1 ||
      Dv > 256 || S < 1 || T < 1 || B < 1 || window < 0 ||
      (window > 0 && S > T + window - 1) || prefix < 0)
    return (int)cudaErrorInvalidValue;
  float* ws_lse = static_cast<float*>(workspace);
  float* ws_delta = ws_lse + (long long)B * H * S;
  const Args a{q,  k,  v,  o,  dout, static_cast<const float*>(lse),
               dq, dk, dv, ws_lse, ws_delta,
               B,  H,  Hkv, S, T, Dk, Dv,
               scale, causal != 0, window, prefix, vec != 0,
               static_cast<cudaStream_t>(stream)};
  const cudaError_t err = bf16 ? by_dims<__nv_bfloat16>(a) : by_dims<float>(a);
  return (int)err;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
