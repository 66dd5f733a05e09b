// The Mamba-2 SSD chunked scan for Hopper (sm_90a), chunk-parallel with its
// products on the tensor cores, and its one-step form for decode; exported
// through a plain C interface and bound to PyTorch with ctypes
// (repro_torch/kernels/ssd_scan/ssd_scan.py).
//
//   x (B, S, H, P) float or bf16; b, c (B, S, N) in x's type, shared by the
//   heads (n_groups = 1); dt (B, S, H) float32 after softplus; a_log (H,)
//   float32, A = -exp(a_log); h0 (B, H, P, N) float32 or null (zeros).
//   y (B, S, H, P) in x's type; h (B, H, P, N) float32, the final state.
//
// Per chunk of Q steps (the last one ragged), with cum the inclusive
// prefix sum of dt * A inside the chunk:
//   y[t]  = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//         + exp(cum_t) C_t . h_in
//   h_out = exp(cum_last) h_in + sum_s exp(cum_last - cum_s) dt_s x_s B_s^T
//
// Replaces no TPU kernel: the JAX package runs this as XLA ops, a lax.scan
// of einsums over the chunks (repro/models/ssm.py:59-110, `_ssd_scan`).
// It gets a kernel because it is every Mamba2 layer's time mixing.
//
// What bounds it: operations. At the Mamba2-2.7B prefill shape (B = 1,
// S = 2048, H = 80, P = 64, N = 128, Q = 256) the causal work is 8.13
// GFLOP (y's intra-chunk half, y's inter-chunk term and the chunk states,
// 2.7 G each, and C B^T) against about 0.05 GB moved. The SSD algorithm of
// the Mamba-2 paper (arXiv:2405.21060, section 6): only the state carry
// between chunks is sequential, so a prefill call is three launches:
//
// * ssd_chunk_kernel, one block per (b, chunk, h) and one per 64 x 64 tile
//   of C B^T on or below the diagonal of each (b, chunk) (shared by the
//   heads, so formed once): cum, the chunk's own state s_c = sum_s
//   exp(cum_last - cum_s) dt_s x_s B_s^T from a zero start, into a
//   (B, nc, H, P, N) float32 workspace; cum into a (B, nc, H, Qs) one, C
//   B^T into (B, nc, Qs, Qs), Qs the chunk rounded up to 32. 720 blocks
//   of 256 threads at 1 x 2048.
// * ssd_carry_kernel, elementwise and bound by bytes: h_c = exp(cum_last,c)
//   h_{c-1} + s_c over the chunks in order, from h0, 4 elements a thread;
//   each chunk's slot of the workspace is overwritten with its incoming
//   state, and the last state is the output h.
// * ssd_y_kernel, one block of 16 warps per (b, chunk, h): y = exp(cum)
//   (C @ h_in^T) + W @ x, W = (C B^T) exp(cum_t - cum_s) dt_s below the
//   diagonal, formed once per element as its panel is stored to shared
//   memory. Warp w takes the row tiles w % 8 and 15 - w % 8 (16 rows each:
//   the causal work is the same for each pair) and half of the columns p.
//   640 blocks at 1 x 2048. A bf16 y leaves through shared memory, 16
//   bytes a thread along its rows.
// Every operand panel is staged through registers as 16-byte loads (P and
// N multiples of 8: the wrapper pads them with zeros), the next panel's
// loads in flight while the current one is multiplied.
//
// cum is summed step by step by one thread, in the plain version's order
// (its cumsum keeps one running sum a column), while the block's first
// panels load. cum reaches -100 to -250, where a float32 ulp is 1e-5, and
// every decay is an exp of a difference of two cums, so the order of that
// sum shows in every product: with a warp-parallel prefix, Mamba2-2.7B's
// float32 forward through this kernel lay further from the plain forward
// at its last position than the 1e-4 that chip_smoke.py holds it to;
// summed in order it lies well inside, and the sum costs no time that the
// call shows.
//
// With bf16 x, b, c (the models' dtype) the products run on the tensor
// cores as mma.sync m16n8k8 in TF32 with a float32 accumulator. TF32 keeps
// 10 mantissa bits; a bf16 value is exact in it, and a float32 operand is
// split, v = hi + lo with hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v -
// hi), so a product with one float32 operand is hi.b + lo.b:
//   product          operands              TF32 products
//   C B^T            C, B                  1 (exact)
//   chunk state      (x tail)^T, B         2 (B exact)
//   y, inter-chunk   C, h_in^T             2 (C exact)
//   y, intra-chunk   W, x                  2 (x exact)
// The products of one k step go into a zeroed accumulator that is added
// to the running sum with a float32 add: the tensor cores round their own
// sums toward zero, which over a whole reduction biases it.
// With float32 x, b, c the same blocks and tiles form every product on the
// CUDA cores (fma_k8), each output a chain of fmaf in k order from zero,
// as a float32 GEMM sums, W formed element by element as the plain version
// forms it, and y_intra and y_inter summed apart and then added, as the
// plain version adds them. Rounding as the plain einsums round is what the
// float32 path is for: Mamba2-2.7B's float32 forward under random weights
// carries a one-ulp change in its scans' outputs far at the first
// positions of a sequence (2.15e-3 of the largest logit at 4 x 128, 1.35e-3
// at 1 x 2048, measured on one H100), so 3xTF32 products (hi.lo' + lo.hi'
// + hi.hi'), within float32's rounding of each scan, left that forward
// 1.02e-3 from the plain one where chip_smoke.py holds it to 1e-4.
// Why mma.sync and not wgmma: each split needs an operand's hi and lo
// halves, which mma.sync forms in registers from one shared-memory read,
// while wgmma reads TF32 B (and A, to avoid a register layout of its own)
// from shared memory, K-major, so every split operand would be staged
// twice and transposed first (x is p-major, the state n-major); the tiles
// are small (16 rows of 32 to 128 columns a warp, K <= 256), and at these
// sizes the chunk kernels are bound by their staging and their
// instructions as much as by the products.
// exp(cum_t - cum_s) is never factored into exp(cum_t) exp(-cum_s): cum
// reaches -100 to -250 inside a chunk and exp(-cum_s) overflows (see
// store_w for the split that is safe).
//
// * ssd_step_kernel, the decode step (S = 1), one launch and no
//   workspace: h' = h exp(dt A) + dt x_p B_n and y_p = sum_n C_n h'_pn,
//   one block per (b, h, 16 rows p), a warp a row, the state streamed in
//   and out once with 16-byte loads (N % 4 == 0): bound by the state's
//   bytes, 2 x 10.49 MB at Mamba2-2.7B's B = 4.
//
// * The backward (launch_bwd, seven launches named ssd_bwd_*), the
//   gradient of the function above given dy and d h_last, which the JAX
//   package takes by autodiff of _ssd_scan. Per chunk, with L its last
//   step, g the gradient of h_out and u_s = g B_s:
//     g_in  = exp(cum_L) g + sum_t exp(cum_t) dy_t^T C_t
//     dx_s  = sum_{t >= s} W[t][s] dy_t + exp(cum_L - cum_s) dt_s u_s
//     dCB   = sum_h (dy_t . x_s) exp(cum_t - cum_s) dt_s, s <= t
//     dC_t  = sum_s dCB[t][s] B_s + sum_h exp(cum_t) dy_t h_in
//     dB_s  = sum_t dCB[t][s] C_t + sum_h exp(cum_L - cum_s) dt_s x_s^T g
//   and dcum from every exp, reverse-summed in the chunk to d(dt A) for
//   ddt and da_log (ssd_scan_bwd_ref writes the whole of it out). The
//   forward's chunk states are recomputed rather than saved (the first two
//   launches), so the forward's interface is as it was. B and C are shared
//   by the heads, so the Q x Q score gradient is summed over the heads
//   before it meets them: ssd_bwd_dcb_kernel forms dy_t . x_s again for
//   each head of a group and adds the heads in registers, so no head's
//   Q x Q array reaches device memory.
//   With bf16 x, b, c (what training runs) every product runs as bf16
//   mma.sync m16n8k16 with float32 sums: bf16 products are exact, and a
//   float32 operand is split into bf16 parts as it is read, a product
//   each (split_bf): in three (float32's own rounding) where the product
//   reaches a float32 result, ddt, da_log or dh0 (x tail, dy exp(cum), and
//   h_in and g against dy or x), in two (2^-17 of the value, inside the
//   bf16 rounding) where it reaches only dx, dB or dC (W, dCB, and g
//   against B). Operands come through cp.async rings in their own type,
//   sums over a tile's rows and columns run as shuffles in a fixed order,
//   and what costs a launch a barrier is finished after the next step's.
//   The bf16 lane has its own chunk kernel
//   (the forward's keeps its code), and its dB, dC launch (the product of
//   depth H P cut into pieces of 20 heads, added in order by the last
//   launch) runs before the main launch, because its dC blocks form z = dy
//   h_in^T for dC anyway and give main y's inter-chunk term of dcum, and
//   its dB blocks, forming z = x g^T, the state's term dtail. The
//   carries and the score gradient's launch serve both lanes. With float32
//   x, b, c the chunk, main and dB, dC launches are the first design's
//   (tile_prod: fmaf chains in k order). da_log is summed a term at a
//   time, each with a small weight where the term is not small (see
//   ssd_scan_bwd_ref), not as sum_t dcum_t cum_t, which cancels terms of
//   |cum| up to hundreds.
//
// P <= 64, N <= 128, Q <= 256 (Mamba2-2.7B's 64, 128, 256); smaller sizes
// are masked. Every sum runs in a fixed order: a call gives the same bits
// each time.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // 8 warps
constexpr int kMaxP = 64;           // head dim
constexpr int kMaxN = 128;          // state dim
constexpr int kMaxQ = 256;          // chunk (== kThreads: a thread a step)
constexpr int kTile = 64;           // a C B^T tile
constexpr int kPanel = 32;          // reduction panel
// row strides of the shared panels, chosen so that a warp's fragment
// reads hit 32 different banks: a [row][k] panel 4 mod 32, an x panel
// [s][p] and a B panel [s][n] 8 mod 32
constexpr int kLD = kPanel + 4;
constexpr int kLDP = kMaxP + 8;
constexpr int kLDN = kMaxN + 8;
constexpr int kStepRows = 16;       // rows p of a decode-step block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes of T in a register: 4 floats or 8 bf16
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  float4 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void zero() { raw = make_float4(0, 0, 0, 0); }
  // floats 4 i .. 4 i + 3
  __device__ __forceinline__ float4 quad(int) const { return raw; }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { raw = make_uint4(0, 0, 0, 0); }
  // a bf16 is the high half of its float32: element 2 k is word k's low
  // 16 bits, element 2 k + 1 its high ones
  __device__ __forceinline__ float4 quad(int i) const {
    const uint32_t w0 = i == 0 ? raw.x : raw.z, w1 = i == 0 ? raw.y : raw.w;
    return make_float4(__uint_as_float(w0 << 16),
                       __uint_as_float(w0 & 0xffff0000u),
                       __uint_as_float(w1 << 16),
                       __uint_as_float(w1 & 0xffff0000u));
  }
};

// An R x C panel of a row-major matrix of T, C a multiple of 16 bytes'
// worth of T, staged through the registers of the block's NT threads: load()
// issues one 16-byte load per vector a thread holds (kCount of them), so
// that the next panel is in flight while the last one is computed on;
// store() writes the panel to shared memory as float rows of stride lds.
// row(r) gives the pointer of row r's first column, or null for a row that
// reads as zeros; columns at or past ccap read as zeros (ccap a multiple of
// the vector: the wrapper keeps P and N multiples of 8).
template <typename T, int R, int C, int NT = kThreads>
struct Panel {
  static constexpr int kV = Vec<T>::kN;
  static constexpr int kPerRow = C / kV;
  static constexpr int kTotal = R * kPerRow;
  static constexpr int kCount = (kTotal + NT - 1) / NT;
  Vec<T> v[kCount];

  // the vector a thread holds as v[i]: at row r, columns c .. c + kV - 1;
  // false past the panel's end
  __device__ __forceinline__ static bool at(int i, int& r, int& c) {
    const int vi = threadIdx.x + NT * i;
    r = vi / kPerRow;
    c = (vi % kPerRow) * kV;
    return kTotal % NT == 0 || vi < kTotal;
  }
  template <typename Row>
  __device__ __forceinline__ void load(Row row, int ccap) {
#pragma unroll
    for (int i = 0; i < kCount; ++i) {
      int r, c;
      const T* p = at(i, r, c) ? row(r) : nullptr;
      if (p != nullptr && c < ccap)
        v[i].load(p + c);
      else
        v[i].zero();
    }
  }
  // scale: null, or a float a row (shared memory) to multiply it by
  __device__ __forceinline__ void store(float* dst, int lds,
                                        const float* scale = nullptr) const {
#pragma unroll
    for (int i = 0; i < kCount; ++i) {
      int r, c;
      if (!at(i, r, c)) continue;
      const float f = scale != nullptr ? scale[r] : 1.f;
#pragma unroll
      for (int k = 0; k < kV / 4; ++k) {
        float4 q = v[i].quad(k);
        if (scale != nullptr) {
          q.x *= f;
          q.y *= f;
          q.z *= f;
          q.w *= f;
        }
        *reinterpret_cast<float4*>(dst + r * lds + c + 4 * k) = q;
      }
    }
  }
};

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// M fragment values as TF32 operands: hi, and lo = the rest, where split;
// unsplit values are passed as they are (exact in TF32: bf16's).
template <int M, bool kSplit>
struct Tf32 {
  uint32_t hi[M], lo[M];
  __device__ __forceinline__ void set(const float (&v)[M]) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if constexpr (kSplit) {
        hi[i] = tf32(v[i]);
        lo[i] = tf32(v[i] - __uint_as_float(hi[i]));
      } else {
        hi[i] = __float_as_uint(v[i]);
        lo[i] = 0u;
      }
    }
  }
};

// d += a b, one m16n8k8 TF32 product with a float32 accumulator.
// Fragments (lane = 4 g + q): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4),
// a3 (g + 8, q + 4); b0 (k = q, n = g), b1 (k = q + 4, n = g);
// d0, d1 (g, 2q, 2q + 1), d2, d3 (g + 8, 2q, 2q + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b with the split operands: the small products first, into a
// zeroed accumulator that is then added to d with a float32 add. The
// tensor cores' own accumulation rounds toward zero, which, carried
// across a whole reduction, biases the sum; here it spans one k step.
template <bool kSA, bool kSB>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const Tf32<4, kSA>& a,
                                          const Tf32<2, kSB>& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (kSA) mma(t, a.lo, b.hi);
  if constexpr (kSB) mma(t, a.hi, b.lo);
  mma(t, a.hi, b.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// d += a b over one k step of 8 on the CUDA cores, the float32 path's
// product: the lane's four outputs of the m16n8 tile (rows g, g + 8,
// columns 2q, 2q + 1: the layout of mma's d) each a chain of fmaf in k
// order, from a zero start, as a float32 GEMM sums its reduction (see the
// note at the top). a(r, k) and b(k, n) read the tile's operands.
template <typename FA, typename FB>
__device__ __forceinline__ void fma_k8(float (&d)[4], int g, int q, FA a,
                                       FB b) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float a0 = a(g, k), a1 = a(g + 8, k);
    const float b0 = b(k, 2 * q), b1 = b(k, 2 * q + 1);
    d[0] = fmaf(a0, b0, d[0]);
    d[1] = fmaf(a0, b1, d[1]);
    d[2] = fmaf(a1, b0, d[2]);
    d[3] = fmaf(a1, b1, d[3]);
  }
}

template <typename T>
constexpr bool kF32 = sizeof(T) == 4;   // the CUDA-core float32 path

// the row stride of C B^T and cum's workspace: Q rounded up to a panel
__host__ __device__ __forceinline__ int q_stride(int Q) {
  return (Q + kPanel - 1) / kPanel * kPanel;
}

struct CbSmem {
  float cs[kTile][kLD];         // C rows [t][n]
  float bs[kTile][kLD];         // B rows [s][n]
};
struct StateSmem {
  float cum[kMaxQ];
  float tail[kMaxQ];            // exp(cum_last - cum_s) dt_s
  float xs[kPanel][kLDP];       // x tail, [s][p]
  float bs[kPanel][kLDN];       // B, [s][n]
};
union ChunkSmem {
  CbSmem cb;
  StateSmem st;
};

// One 64 x 64 tile (number k of the tiles on or below the diagonal, row by
// row) of a chunk's C B^T, zero past its qc steps; row stride Qs.
template <typename T>
__device__ __forceinline__ void cb_tile(CbSmem& sm, const T* __restrict__ bm,
                                        const T* __restrict__ cm,
                                        float* __restrict__ out,
                                        long long row0, int k, int qc, int N,
                                        int Q) {
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
  const int t0 = ti * kTile, s0 = (k - ti * (ti + 1) / 2) * kTile;
  const int Qs = q_stride(Q);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int mr = (warp & 3) * 16;   // the warp's 16 rows t
  const int nr = (warp >> 2) * 32;  // and 32 columns s: 4 n-tiles
  float acc[4][4] = {};
  Panel<T, kTile, kPanel> pc, pb;
  auto load = [&](int n0) {
    pc.load([&](int r) { return t0 + r < qc ? cm + (row0 + t0 + r) * N + n0
                                            : nullptr; }, N - n0);
    pb.load([&](int r) { return s0 + r < qc ? bm + (row0 + s0 + r) * N + n0
                                            : nullptr; }, N - n0);
  };
  load(0);
  for (int n0 = 0; n0 < N; n0 += kPanel) {
    __syncthreads();
    pc.store(&sm.cs[0][0], kLD);
    pb.store(&sm.bs[0][0], kLD);
    __syncthreads();
    if (n0 + kPanel < N) load(n0 + kPanel);
#pragma unroll
    for (int k8 = 0; k8 < kPanel; k8 += 8) {
      if constexpr (kF32<T>) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          fma_k8(acc[j], g, q,
                 [&](int r, int k) { return sm.cs[mr + r][k8 + k]; },
                 [&](int k, int n) { return sm.bs[nr + 8 * j + n][k8 + k]; });
        continue;
      }
      const float av[4] = {sm.cs[mr + g][k8 + q], sm.cs[mr + g + 8][k8 + q],
                           sm.cs[mr + g][k8 + q + 4],
                           sm.cs[mr + g + 8][k8 + q + 4]};
      Tf32<4, false> a;
      a.set(av);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bv[2] = {sm.bs[nr + 8 * j + g][k8 + q],
                             sm.bs[nr + 8 * j + g][k8 + q + 4]};
        Tf32<2, false> bf;
        bf.set(bv);
        mma_split(acc[j], a, bf);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = s0 + nr + 8 * j + 2 * q;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + mr + g + 8 * half;
      if (t >= Q) continue;
      if (s < Q) out[(long long)t * Qs + s] = acc[j][2 * half];
      if (s + 1 < Q) out[(long long)t * Qs + s + 1] = acc[j][2 * half + 1];
    }
  }
}

// A block of grid (H + tiles [+ H], nc, B): blocks below H form the chunk
// state of head blockIdx.x, the next `tiles` a tile of C B^T; in the
// backward's launch (kBwd) the last H form the chunk's r =
// sum_t exp(cum_t) dy_t^T C_t of head blockIdx.x - H - tiles into rw, the
// chunk state's product with dy for x, C for B and exp(cum_t) for the
// tail. kBwd is a template argument, so the forward's code has no test of
// it.
template <typename T, bool kBwd>
__device__ __forceinline__ void chunk_block(
    ChunkSmem& smu, const T* __restrict__ x, const T* __restrict__ bm,
    const T* __restrict__ cm, const float* __restrict__ dt,
    const float* __restrict__ a_log, float* __restrict__ cb,
    float* __restrict__ cumw, float* __restrict__ st,
    const T* __restrict__ dy, float* __restrict__ rw, int S, int H, int P,
    int N, int Q, int nc) {
  const int ci = blockIdx.y, b = blockIdx.z;
  const int qc = min(Q, S - ci * Q);          // the chunk's real steps
  const int Qs = q_stride(Q);
  const long long row0 = (long long)b * S + (long long)ci * Q;
  const int nt = (Q + kTile - 1) / kTile, tiles = nt * (nt + 1) / 2;
  const bool rblk = kBwd && blockIdx.x >= H + tiles;
  if (blockIdx.x >= H && !rblk) {
    cb_tile<T>(smu.cb, bm, cm, cb + ((long long)b * nc + ci) * Qs * Qs, row0,
               blockIdx.x - H, qc, N, Q);
    return;
  }
  StateSmem& sm = smu.st;
  const int h = rblk ? blockIdx.x - H - tiles : blockIdx.x;
  const T* __restrict__ xs = rblk ? dy : x;   // rows [s][p]
  const T* __restrict__ ns = rblk ? cm : bm;  // rows [s][n]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const long long bch = ((long long)b * nc + ci) * H + h;

  // the first panels' loads go out before the prefix sum
  Panel<T, kPanel, kMaxP> px;
  Panel<T, kPanel, kMaxN> pb;
  auto load = [&](int s0) {
    px.load([&](int r) { return s0 + r < qc
                                    ? xs + ((row0 + s0 + r) * H + h) * P
                                    : nullptr; }, P);
    pb.load([&](int r) { return s0 + r < qc ? ns + (row0 + s0 + r) * N
                                            : nullptr; }, N);
  };
  load(0);

  // cum: dt A formed by all threads, then summed step by step by one, in
  // the plain version's order (see the note at the top), while the first
  // panels' loads are in flight
  const float A = -expf(a_log[h]);
  const float dtv = tid < qc ? dt[(row0 + tid) * H + h] : 0.f;
  sm.cum[tid] = dtv * A;
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
#pragma unroll 16
    for (int t = 0; t < kMaxQ; t += 4) {
      float4 v4 = *reinterpret_cast<const float4*>(&sm.cum[t]);
      run += v4.x;
      v4.x = run;
      run += v4.y;
      v4.y = run;
      run += v4.z;
      v4.z = run;
      run += v4.w;
      v4.w = run;
      *reinterpret_cast<float4*>(&sm.cum[t]) = v4;
    }
  }
  __syncthreads();
  const float v = sm.cum[tid];   // past qc it stays at cum[qc - 1], as
                                 // padding does
  if (tid < Qs && !rblk) cumw[bch * Qs + tid] = v;
  const float cum_last = sm.cum[qc - 1];
  sm.tail[tid] = tid >= qc ? 0.f : rblk ? expf(v) : expf(cum_last - v) * dtv;

  // s_c[p][n] = sum_s (x[s][p] tail[s]) B[s][n]: 4 tiles of 16 rows p by
  // 2 of 64 columns n, a warp each
  const int mr = (warp & 3) * 16, nr = (warp >> 2) * 64;
  float acc[8][4] = {};
  for (int s0 = 0; s0 < qc; s0 += kPanel) {
    __syncthreads();     // tail written; the last panel's reads done
    px.store(&sm.xs[0][0], kLDP, sm.tail + s0);
    pb.store(&sm.bs[0][0], kLDN);
    __syncthreads();
    if (s0 + kPanel < qc) load(s0 + kPanel);
#pragma unroll
    for (int k8 = 0; k8 < kPanel; k8 += 8) {
      if constexpr (kF32<T>) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          fma_k8(acc[j], g, q,
                 [&](int r, int k) { return sm.xs[k8 + k][mr + r]; },
                 [&](int k, int n) { return sm.bs[k8 + k][nr + 8 * j + n]; });
        continue;
      }
      const float av[4] = {sm.xs[k8 + q][mr + g], sm.xs[k8 + q][mr + g + 8],
                           sm.xs[k8 + q + 4][mr + g],
                           sm.xs[k8 + q + 4][mr + g + 8]};
      Tf32<4, true> a;
      a.set(av);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float bv[2] = {sm.bs[k8 + q][nr + 8 * j + g],
                             sm.bs[k8 + q + 4][nr + 8 * j + g]};
        Tf32<2, false> bf;
        bf.set(bv);
        mma_split(acc[j], a, bf);
      }
    }
  }
  float* out = (rblk ? rw : st) + bch * P * N;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = nr + 8 * j + 2 * q;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = mr + g + 8 * half;
      if (p < P && n < N)
        *reinterpret_cast<float2*>(out + p * N + n) =
            make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// the chunk kernels' least blocks an SM: with bf16 operands 3 (80
// registers a thread; unasked, ptxas gives 103 and 2 blocks an SM, 2.5%
// slower at Mamba2-2.7B's shape on an H100); with float32 ones 1 (128
// registers, 2 blocks an SM)
template <typename T>
constexpr int kChunkBlocks = kF32<T> ? 1 : 3;

template <typename T>
__global__ void __launch_bounds__(kThreads, kChunkBlocks<T>)
ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                 const T* __restrict__ cm, const float* __restrict__ dt,
                 const float* __restrict__ a_log, float* __restrict__ cb,
                 float* __restrict__ cumw, float* __restrict__ st, int S,
                 int H, int P, int N, int Q, int nc) {
  __shared__ __align__(16) ChunkSmem smu;
  chunk_block<T, false>(smu, x, bm, cm, dt, a_log, cb, cumw, st, nullptr,
                        nullptr, S, H, P, N, Q, nc);
}

// the float32 lane's first backward launch: the same blocks and H more
// (see chunk_block), under its own name so that a profile tells it apart
template <typename T>
__global__ void __launch_bounds__(kThreads, kChunkBlocks<T>)
ssd_bwd_chunk_f32_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ dt,
                     const float* __restrict__ a_log, float* __restrict__ cb,
                     float* __restrict__ cumw, float* __restrict__ st,
                     const T* __restrict__ dy, float* __restrict__ rw, int S,
                     int H, int P, int N, int Q, int nc) {
  __shared__ __align__(16) ChunkSmem smu;
  chunk_block<T, true>(smu, x, bm, cm, dt, a_log, cb, cumw, st, dy, rw, S, H,
                       P, N, Q, nc);
}

// Four elements (b, h, p, n .. n + 3) of the state a thread: walks the
// chunks in order, 8 at a time (their loads issued together), leaving each
// chunk's incoming state in its workspace slot, and the final state in
// h_out where kOut (the backward's recomputation has no use for it).
constexpr int kCarryGroup = 8;
template <bool kOut>
__device__ __forceinline__ void carry_block(
    const float* __restrict__ cumw, const float* __restrict__ h0,
    float* __restrict__ st, float* __restrict__ h_out, int B, int S, int H,
    int P, int N, int Q, int nc) {
  const long long PN = (long long)P * N;
  const long long e = 4 * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (e >= (long long)B * H * PN) return;
  const long long bh = e / PN, r = e % PN;
  const long long b = bh / H, h = bh % H;
  const int Qs = q_stride(Q);
  float4 hc = h0 != nullptr ? *reinterpret_cast<const float4*>(h0 + e)
                            : make_float4(0, 0, 0, 0);
  for (int c0 = 0; c0 < nc; c0 += kCarryGroup) {
    float4 sv[kCarryGroup];
    float dec[kCarryGroup];
#pragma unroll
    for (int i = 0; i < kCarryGroup; ++i) {
      const int ci = c0 + i;
      if (ci >= nc) break;
      const long long bch = (b * nc + ci) * H + h;
      sv[i] = *reinterpret_cast<const float4*>(st + bch * PN + r);
      dec[i] = cumw[bch * Qs + min(Q, S - ci * Q) - 1];
    }
#pragma unroll
    for (int i = 0; i < kCarryGroup; ++i) {
      const int ci = c0 + i;
      if (ci >= nc) break;
      const long long bch = (b * nc + ci) * H + h;
      *reinterpret_cast<float4*>(st + bch * PN + r) = hc;
      // h exp(cum_last), then + s_c: two roundings, as the plain
      // version's h * exp(.) + dh (an fma would round once)
      const float d = expf(dec[i]);
      hc = make_float4(__fadd_rn(__fmul_rn(hc.x, d), sv[i].x),
                       __fadd_rn(__fmul_rn(hc.y, d), sv[i].y),
                       __fadd_rn(__fmul_rn(hc.z, d), sv[i].z),
                       __fadd_rn(__fmul_rn(hc.w, d), sv[i].w));
    }
  }
  if constexpr (kOut) *reinterpret_cast<float4*>(h_out + e) = hc;
}

__global__ void __launch_bounds__(kThreads)
ssd_carry_kernel(const float* __restrict__ cumw,
                 const float* __restrict__ h0, float* __restrict__ st,
                 float* __restrict__ h_out, int B, int S, int H, int P, int N,
                 int Q, int nc) {
  carry_block<true>(cumw, h0, st, h_out, B, S, H, P, N, Q, nc);
}

// the backward's recomputation of the incoming states, under its own name
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_kernel(const float* __restrict__ cumw,
                     const float* __restrict__ h0, float* __restrict__ st,
                     int B, int S, int H, int P, int N, int Q, int nc) {
  carry_block<false>(cumw, h0, st, nullptr, B, S, H, P, N, Q, nc);
}

struct InterSmem {
  float cs[kMaxQ][kLD];         // C [t][n]
  float hs[kMaxP][kLD];         // h_in [p][n]
};
struct IntraSmem {
  float ws[kMaxQ][kLD];         // W [t][s]
  float xs[kPanel][kLDP];       // x [s][p]
};
struct YSmem {
  float cum[kMaxQ];
  float dt[kMaxQ];
  float fcol[kPanel];           // exp(cum_piv - cum_s) dt_s of a panel
  float erow[kMaxQ];            // exp(cum_t - cum_piv) of its rows below
  union {
    InterSmem in;
    IntraSmem ra;
    unsigned short ys[kMaxQ][kMaxP + 8];  // a bf16 y tile on its way out
  } u;
};

constexpr int kYThreads = 512;  // 16 warps

// The W panel of steps s0 .. s0 + 31 into shared memory, formed once as
// it is stored: W[t][s] = (C B^T)[t][s] exp(cum_t - cum_s) dt_s for
// s <= t < qc, else 0. exp(cum_t - cum_s) is never factored into
// exp(cum_t) exp(-cum_s), which overflows. Where cum does not rise in the
// chunk (dt >= 0, as after softplus: `mono`), a row t below the panel's
// last step piv takes exp(cum_t - cum_piv) exp(cum_piv - cum_s), two
// factors in (0, 1] with s <= piv < t (erow, and fcol times dt_s): one
// exp a row instead of one an element. Rows above the panel are never read
// and are left as they are.
__device__ __forceinline__ void store_w(
    const Panel<float, kMaxQ, kPanel, kYThreads>& pw, YSmem& sm, int s0,
    int qc, bool mono) {
  const int piv = min(s0 + kPanel, qc) - 1;
#pragma unroll
  for (int i = 0; i < pw.kCount; ++i) {
    int t, c;
    pw.at(i, t, c);
    if (t < s0) continue;
    const float4 v = pw.v[i].quad(0);
    const float e[4] = {v.x, v.y, v.z, v.w};
    float w[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < qc && mono && t > piv) {
      const float er = sm.erow[t];
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = e[k] * er * sm.fcol[c + k];
    } else if (t < qc) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = s0 + c + k;
        if (s <= t) w[k] = e[k] * expf(sm.cum[t] - sm.cum[s]) * sm.dt[s];
      }
    }
    *reinterpret_cast<float4*>(&sm.u.ra.ws[t][c]) =
        make_float4(w[0], w[1], w[2], w[3]);
  }
}

// grid (H, nc, B): y of one (b, chunk, h), after the carry. Warp w takes
// the row tiles w % 8 and 15 - w % 8 (16 rows t each: the causal work is
// the same for each pair) and the columns p of its half, w / 8.
template <typename T>
__global__ void __launch_bounds__(kYThreads)
ssd_y_kernel(const T* __restrict__ x, const T* __restrict__ cm,
             const float* __restrict__ dt, const float* __restrict__ cb,
             const float* __restrict__ cumw, const float* __restrict__ st,
             int has_h0, T* __restrict__ y, int S, int H, int P, int N, int Q,
             int nc) {
  extern __shared__ float4 ysmem[];
  YSmem& sm = *reinterpret_cast<YSmem*>(ysmem);
  const int h = blockIdx.x, ci = blockIdx.y, b = blockIdx.z;
  const int qc = min(Q, S - ci * Q);
  const int Qs = q_stride(Q);
  const long long row0 = (long long)b * S + (long long)ci * Q;
  const long long bch = ((long long)b * nc + ci) * H + h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const bool inter = ci > 0 || has_h0;   // else the incoming state is zero
  const float* hin = st + bch * P * N;
  const float* cbc = cb + ((long long)b * nc + ci) * Qs * Qs;

  Panel<T, kMaxQ, kPanel, kYThreads> pc;        // C [t][n0 ..]
  Panel<float, kMaxP, kPanel, kYThreads> ph;    // h_in [p][n0 ..]
  Panel<float, kMaxQ, kPanel, kYThreads> pw;    // C B^T [t][s0 ..]
  Panel<T, kPanel, kMaxP, kYThreads> px;        // x [s0 ..][p]
  auto load_inter = [&](int n0) {
    pc.load([&](int r) { return r < qc ? cm + (row0 + r) * N + n0
                                       : nullptr; }, N - n0);
    ph.load([&](int p) { return p < P ? hin + p * N + n0 : nullptr; },
            N - n0);
  };
  auto load_intra = [&](int s0) {
    // rows above the panel are never read
    pw.load([&](int r) { return r >= s0 && r < qc
                                    ? cbc + (long long)r * Qs + s0
                                    : nullptr; }, kPanel);
    px.load([&](int r) { return s0 + r < qc
                                    ? x + ((row0 + s0 + r) * H + h) * P
                                    : nullptr; }, P);
  };
  if (inter)
    load_inter(0);
  else
    load_intra(0);
  float dtv = 0.f;
  if (tid < kMaxQ) {
    dtv = tid < qc ? dt[(row0 + tid) * H + h] : 0.f;
    sm.cum[tid] = tid < Qs ? cumw[bch * Qs + tid] : 0.f;
    sm.dt[tid] = dtv;
  }
  // cum never rises; the float32 path forms every W element unfactored
  const bool mono = __syncthreads_and(!(dtv < 0.f)) && !kF32<T>;

  const int mt[2] = {warp % 8, 15 - warp % 8};
  const int n8 = (warp / 8) * 4;         // the warp's 4 n-tiles (p / 8)
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) live[i] = 16 * mt[i] < qc;
  float acc[2][4][4] = {};

  // y_inter = exp(cum_t) (C_t . h_in)
  if (inter) {
    for (int n0 = 0; n0 < N; n0 += kPanel) {
      __syncthreads();
      pc.store(&sm.u.in.cs[0][0], kLD);
      ph.store(&sm.u.in.hs[0][0], kLD);
      __syncthreads();
      if (n0 + kPanel < N)
        load_inter(n0 + kPanel);
      else
        load_intra(0);
#pragma unroll
      for (int k8 = 0; k8 < kPanel; k8 += 8) {
        if constexpr (kF32<T>) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (!live[i]) continue;
            const int r0 = 16 * mt[i];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              fma_k8(acc[i][j], g, q,
                     [&](int r, int k) { return sm.u.in.cs[r0 + r][k8 + k]; },
                     [&](int k, int p) {
                       return sm.u.in.hs[8 * (n8 + j) + p][k8 + k];
                     });
          }
          continue;
        }
        Tf32<2, true> bf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = 8 * (n8 + j) + g;
          const float bv[2] = {sm.u.in.hs[p][k8 + q], sm.u.in.hs[p][k8 + q + 4]};
          bf[j].set(bv);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (!live[i]) continue;
          const int r = 16 * mt[i] + g;
          const float av[4] = {sm.u.in.cs[r][k8 + q],
                               sm.u.in.cs[r + 8][k8 + q],
                               sm.u.in.cs[r][k8 + q + 4],
                               sm.u.in.cs[r + 8][k8 + q + 4]};
          Tf32<4, false> a;
          a.set(av);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_split(acc[i][j], a, bf[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * mt[i] + g;
      const float e0 = expf(sm.cum[r]), e1 = expf(sm.cum[r + 8]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j][0] *= e0;
        acc[i][j][1] *= e0;
        acc[i][j][2] *= e1;
        acc[i][j][3] *= e1;
      }
    }
    if constexpr (kF32<T>) {
      // the float32 path sums y_intra on its own and adds y_inter last, as
      // the plain version does: y_inter waits in y, each element read back
      // by the thread that wrote it
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = 8 * (n8 + j) + 2 * q;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = 16 * mt[i] + g + 8 * half;
            if (live[i] && t < qc && p < P)
              *reinterpret_cast<float2*>(y + ((row0 + t) * H + h) * P + p) =
                  make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
            acc[i][j][2 * half] = acc[i][j][2 * half + 1] = 0.f;
          }
        }
      }
    }
  }

  // y_intra = W @ x over panels of 32 steps s
  for (int s0 = 0; s0 < qc; s0 += kPanel) {
    __syncthreads();
    {
      const int piv = min(s0 + kPanel, qc) - 1, s = s0 + tid;
      if (tid < kPanel)
        sm.fcol[tid] = s <= piv ? expf(sm.cum[piv] - sm.cum[s]) * sm.dt[s]
                                : 0.f;
      else if (mono && tid - kPanel > piv && tid - kPanel < qc)
        sm.erow[tid - kPanel] = expf(sm.cum[tid - kPanel] - sm.cum[piv]);
    }
    __syncthreads();
    store_w(pw, sm, s0, qc, mono);
    px.store(&sm.u.ra.xs[0][0], kLDP);
    __syncthreads();
    if (s0 + kPanel < qc) load_intra(s0 + kPanel);
#pragma unroll
    for (int k8 = 0; k8 < kPanel; k8 += 8) {
      if (s0 + k8 > 16 * mt[1] + 15) break;   // above both tiles' rows
      if constexpr (kF32<T>) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r0 = 16 * mt[i];
          if (!live[i] || s0 + k8 > r0 + 15) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            fma_k8(acc[i][j], g, q,
                   [&](int r, int k) { return sm.u.ra.ws[r0 + r][k8 + k]; },
                   [&](int k, int p) {
                     return sm.u.ra.xs[k8 + k][8 * (n8 + j) + p];
                   });
        }
        continue;
      }
      Tf32<2, false> bf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 8 * (n8 + j) + g;
        const float bv[2] = {sm.u.ra.xs[k8 + q][p], sm.u.ra.xs[k8 + q + 4][p]};
        bf[j].set(bv);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r0 = 16 * mt[i];
        if (!live[i] || s0 + k8 > r0 + 15) continue;
        const int ta = r0 + g, tb = ta + 8;
        const float av[4] = {sm.u.ra.ws[ta][k8 + q], sm.u.ra.ws[tb][k8 + q],
                             sm.u.ra.ws[ta][k8 + q + 4],
                             sm.u.ra.ws[tb][k8 + q + 4]};
        Tf32<4, true> a;
        a.set(av);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_split(acc[i][j], a, bf[j]);
      }
    }
  }

  // y: float32 pairs straight out (4 lanes fill a 32-byte sector); bf16
  // through shared memory, then 16 bytes a thread along the rows
  if constexpr (kF32<T>) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!live[i]) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 8 * (n8 + j) + 2 * q;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = 16 * mt[i] + g + 8 * half;
          if (t >= qc || p >= P) continue;
          float2* yp =
              reinterpret_cast<float2*>(y + ((row0 + t) * H + h) * P + p);
          float2 v = make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
          if (inter) {
            const float2 e = *yp;     // y_inter, this thread's own write
            v.x += e.x;
            v.y += e.y;
          }
          *yp = v;
        }
      }
    }
  } else {
    __syncthreads();                     // the last panel's reads done
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!live[i]) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 8 * (n8 + j) + 2 * q;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<__nv_bfloat162*>(
              &sm.u.ys[16 * mt[i] + g + 8 * half][p]) =
              __floats2bfloat162_rn(acc[i][j][2 * half],
                                    acc[i][j][2 * half + 1]);
      }
    }
    __syncthreads();
    constexpr int kPerRow = kMaxP / 8;   // 16-byte pieces of a row
    for (int idx = tid; idx < kMaxQ * kPerRow; idx += kYThreads) {
      const int t = idx / kPerRow, p = (idx % kPerRow) * 8;
      if (t < qc && p < P)
        *reinterpret_cast<uint4*>(y + ((row0 + t) * H + h) * P + p) =
            *reinterpret_cast<const uint4*>(&sm.u.ys[t][p]);
    }
  }
}

// The decode step, S = 1: grid (ceil(P / 16), H, B), 4 warps of 4 rows p.
// A lane holds 4 columns n: 4 lane .. 4 lane + 3 (kVec, one 16-byte load
// a row) or lane + 32 i.
template <typename T, bool kVec>
__global__ void __launch_bounds__(128)
ssd_step_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ dt,
                const float* __restrict__ a_log,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_out, int H, int P, int N) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = blockIdx.x * kStepRows + 4 * warp;
  const long long bh = (long long)b * H + h;
  const float dtv = dt[bh];
  const float decay = expf(dtv * -expf(a_log[h]));
  int nn[4];
  float bv[4], cv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    nn[i] = kVec ? 4 * lane + i : lane + 32 * i;
    bv[i] = nn[i] < N ? to_f(bm[(long long)b * N + nn[i]]) : 0.f;
    cv[i] = nn[i] < N ? to_f(cm[(long long)b * N + nn[i]]) : 0.f;
  }
  float hv[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + r;
    const long long o = (bh * P + p) * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) hv[r][i] = 0.f;
    if (p >= P || h0 == nullptr) continue;
    if constexpr (kVec) {
      if (nn[0] < N) {
        const float4 v = *reinterpret_cast<const float4*>(h0 + o + nn[0]);
        hv[r][0] = v.x;
        hv[r][1] = v.y;
        hv[r][2] = v.z;
        hv[r][3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (nn[i] < N) hv[r][i] = h0[o + nn[i]];
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + r;
    if (p >= P) break;
    const long long o = (bh * P + p) * N;
    const float coef = dtv * to_f(x[bh * P + p]);
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hv[r][i] = hv[r][i] * decay + coef * bv[i];
      part += cv[i] * hv[r][i];
    }
    if constexpr (kVec) {
      if (nn[0] < N)
        *reinterpret_cast<float4*>(h_out + o + nn[0]) =
            make_float4(hv[r][0], hv[r][1], hv[r][2], hv[r][3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (nn[i] < N) h_out[o + nn[i]] = hv[r][i];
    }
#pragma unroll
    for (int o2 = 16; o2 > 0; o2 >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o2);
    if (lane == 0) y[bh * P + p] = from_f<T>(part);
  }
}

struct Work {
  float *st, *cb, *cum;
};

Work carve(void* work, int B, int S, int H, int P, int N, int Q) {
  const long long nc = (S + Q - 1) / Q, Qs = q_stride(Q);
  Work w;
  w.st = static_cast<float*>(work);
  w.cb = w.st + (long long)B * nc * H * P * N;
  w.cum = w.cb + (long long)B * nc * Qs * Qs;
  return w;
}

template <typename T>
cudaError_t launch(const void* x, const void* bm, const void* cm,
                   const float* dt, const float* a_log, const float* h0,
                   void* work, void* y, float* h_out, int B, int S, int H,
                   int P, int N, int Q, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  T* yt = static_cast<T*>(y);
  if (S == 1) {
    const dim3 grid((P + kStepRows - 1) / kStepRows, H, B);
    const bool vec = N % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(h0) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(h_out) % 16 == 0;
    if (vec)
      ssd_step_kernel<T, true><<<grid, 128, 0, stream>>>(
          xt, bt, ct, dt, a_log, h0, yt, h_out, H, P, N);
    else
      ssd_step_kernel<T, false><<<grid, 128, 0, stream>>>(
          xt, bt, ct, dt, a_log, h0, yt, h_out, H, P, N);
    return cudaGetLastError();
  }
  const int nc = (S + Q - 1) / Q;
  const int nt = (Q + kTile - 1) / kTile;
  const Work w = carve(work, B, S, H, P, N, Q);
  ssd_chunk_kernel<T><<<dim3(H + nt * (nt + 1) / 2, nc, B), kThreads, 0,
                        stream>>>(xt, bt, ct, dt, a_log, w.cb, w.cum, w.st, S,
                                  H, P, N, Q, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long quads = (long long)B * H * P * N / 4;
  ssd_carry_kernel<<<(unsigned)((quads + kThreads - 1) / kThreads), kThreads,
                     0, stream>>>(w.cum, h0, w.st, h_out, B, S, H, P, N, Q,
                                  nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem = (int)sizeof(YSmem);
  err = cudaFuncSetAttribute(ssd_y_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  ssd_y_kernel<T><<<dim3(H, nc, B), kYThreads, smem, stream>>>(
      xt, ct, dt, w.cb, w.cum, w.st, h0 != nullptr, yt, S, H, P, N, Q, nc);
  return cudaGetLastError();
}

// ===================================================================== the
// backward: the gradient of the chunked scan (see the note at the top of
// the backward's launch, `launch_bwd`)

// acc (the warp's 16 rows r0 .. r0 + 15 by 32 columns c0 .. c0 + 31 of a
// 64 x 64 output tile, four m16n8 tiles in mma's layout) += sum over
// k0 <= k < k1 (multiples of 8) of a(r, k) b(k, n). bf16 operands: split
// TF32 mma.sync, kSA / kSB marking an operand that is float32 (split) and
// not exact in TF32; float32 operands: fmaf chains in k order.
template <typename T, bool kSA, bool kSB, typename FA, typename FB>
__device__ __forceinline__ void tile_prod(float (&acc)[4][4], int r0, int c0,
                                          int k0, int k1, FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  for (int k8 = k0; k8 < k1; k8 += 8) {
    if constexpr (kF32<T>) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        fma_k8(acc[j], g, q, [&](int r, int k) { return a(r0 + r, k8 + k); },
               [&](int k, int n) { return b(k8 + k, c0 + 8 * j + n); });
    } else {
      const float av[4] = {a(r0 + g, k8 + q), a(r0 + g + 8, k8 + q),
                           a(r0 + g, k8 + q + 4), a(r0 + g + 8, k8 + q + 4)};
      Tf32<4, kSA> ta;
      ta.set(av);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = c0 + 8 * j + g;
        const float bv[2] = {b(k8 + q, n), b(k8 + q + 4, n)};
        Tf32<2, kSB> tb;
        tb.set(bv);
        mma_split(acc[j], ta, tb);
      }
    }
  }
}

// element e of m16n8 tile j of a warp's 16 x 32 piece: its row and column
// in the 64 x 64 tile
__device__ __forceinline__ int acc_row(int r0, int e) {
  return r0 + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int c0, int j, int e) {
  return c0 + 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}

// The state gradient carried from the last chunk to the first: four
// elements (b, h, p, n .. n + 3) a thread, g = dh_last (or 0), and for
// each chunk from the last, its slot of rw (holding r_c = sum_t
// exp(cum_t) dy_t^T C_t) is overwritten with g, the gradient of the
// chunk's outgoing state, and g = exp(cum_last) g + r_c, that of its
// incoming state; dh0 (or null) gets the first chunk's. ssd_carry_kernel
// run backward.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_carry_kernel(const float* __restrict__ cumw,
                     const float* __restrict__ dh_last, float* __restrict__ rw,
                     float* __restrict__ dh0, int B, int S, int H, int P,
                     int N, int Q, int nc) {
  const long long PN = (long long)P * N;
  const long long e = 4 * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (e >= (long long)B * H * PN) return;
  const long long bh = e / PN, r = e % PN;
  const long long b = bh / H, h = bh % H;
  const int Qs = q_stride(Q);
  float4 gc = dh_last != nullptr
                  ? *reinterpret_cast<const float4*>(dh_last + e)
                  : make_float4(0, 0, 0, 0);
  for (int c1 = nc; c1 > 0; c1 -= kCarryGroup) {
    float4 rv[kCarryGroup];
    float dec[kCarryGroup];
#pragma unroll
    for (int i = 0; i < kCarryGroup; ++i) {
      const int ci = c1 - 1 - i;
      if (ci < 0) break;
      const long long bch = (b * nc + ci) * H + h;
      rv[i] = *reinterpret_cast<const float4*>(rw + bch * PN + r);
      dec[i] = cumw[bch * Qs + min(Q, S - ci * Q) - 1];
    }
#pragma unroll
    for (int i = 0; i < kCarryGroup; ++i) {
      const int ci = c1 - 1 - i;
      if (ci < 0) break;
      const long long bch = (b * nc + ci) * H + h;
      *reinterpret_cast<float4*>(rw + bch * PN + r) = gc;
      // g exp(cum_last), then + r_c: two roundings, as the plain version
      const float d = expf(dec[i]);
      gc = make_float4(__fadd_rn(__fmul_rn(gc.x, d), rv[i].x),
                       __fadd_rn(__fmul_rn(gc.y, d), rv[i].y),
                       __fadd_rn(__fmul_rn(gc.z, d), rv[i].z),
                       __fadd_rn(__fmul_rn(gc.w, d), rv[i].w));
    }
  }
  if (dh0 != nullptr) *reinterpret_cast<float4*>(dh0 + e) = gc;
}

constexpr int kBT = 64;             // the backward's (t, s) and (row, p) tiles
constexpr int kLT = kBT + 4;        // [row][k] tiles: stride 4 mod 32
constexpr int kLK = kBT + 8;        // [k][row] tiles: stride 8 mod 32
constexpr int kLNB = kMaxN + 4;     // [row][n] rows of B, C, g or h_in

struct BwdTiles {
  float dy[kBT][kLT];           // dy [t][p]
  float xs[kBT][kLT];           // x [s][p]
  float cb[kBT][kLT];           // C B^T [t][s]
  float w[kBT][kLK];            // W [t][s]
  float m[kBT][kLT];            // dW W [t][s]
  float xd[kBT][kLT];           // dW (C B^T) exp(cum_t - cum_s) [t][s]
};
struct BwdRows {
  float rows[kBT][kLNB];        // C [t][n] or B [s][n]
  float st[kMaxP][kLNB];        // h_in or g [p][n]
};
struct BwdSmem {
  float cum[kMaxQ], dt[kMaxQ];
  float tle[kMaxQ];             // exp(cum_last - cum_s)
  float rowm[kMaxQ];            // sum_s dW W [t][s], then d(dt A)
  float colm[kMaxQ];            // sum_t dW W [t][s]
  float ddt[kMaxQ];             // sum_t dW (C B^T) exp(cum_t - cum_s)
  float dinter[kMaxQ];          // exp(cum_t) dy_t . (h_in C_t)
  float dtail[kMaxQ];           // x_s . u_s
  float rowc[kMaxQ];            // sum_s dW W [t][s] (cum_t - cum_s)
  float red[2][kBT];            // the two column halves' row sums
  float gh[kThreads];
  union {
    BwdTiles t;
    BwdRows r;
  } u;
};

// sum over the warp's columns of f(row, col, element) for each of its two
// rows a lane holds, into red[column half][row]: a sum over the lane's
// eight columns, then over the four lanes of a row (shfl), in that order
template <typename F>
__device__ __forceinline__ void row_dot(float (&red)[2][kBT], int r0, int c0,
                                        F f) {
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      rs[e >> 1] += f(acc_row(r0, e), acc_col(c0, j, e), j, e);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
  }
  if ((threadIdx.x & 3) == 0) {
    red[c0 / 32][acc_row(r0, 0)] = rs[0];
    red[c0 / 32][acc_row(r0, 2)] = rs[1];
  }
}

// The float32 lane's main launch, grid (H, nc, B), 256 threads: one (b,
// chunk, head), after the forward's chunk states and carry (st: each
// chunk's h_in) and the state gradient's carry (rw: each chunk's g, the
// gradient of its h_out). Writes dx and ddt of its steps and its sum over
// its steps of d(dt A) dt into dal. Every product a chain of fmaf in k
// order (tile_prod), staged through float shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_main_f32_kernel(const T* __restrict__ x, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ dt,
               const float* __restrict__ a_log, const T* __restrict__ dy,
               const float* __restrict__ cb, const float* __restrict__ cumw,
               const float* __restrict__ st, const float* __restrict__ rw,
               float* __restrict__ dal, T* __restrict__ dx,
               float* __restrict__ ddt, int S, int H, int P, int N, int Q,
               int nc) {
  extern __shared__ float4 bwd_smem[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(bwd_smem);
  const int h = blockIdx.x, ci = blockIdx.y, b = blockIdx.z;
  const int qc = min(Q, S - ci * Q);
  const int Qs = q_stride(Q);
  const long long row0 = (long long)b * S + (long long)ci * Q;
  const long long bch = ((long long)b * nc + ci) * H + h;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
  const float* hin = st + bch * P * N;
  const float* gout = rw + bch * P * N;
  const float* cbc = cb + ((long long)b * nc + ci) * Qs * Qs;
  const float A = -expf(a_log[h]);
  auto xrow = [&](auto* base, int t) {   // row t of x, dy or dx
    return base + ((row0 + t) * H + h) * P;
  };

  // a thread a step (kThreads == kMaxQ)
  sm.cum[tid] = tid < qc ? cumw[bch * Qs + tid] : 0.f;
  sm.dt[tid] = tid < qc ? dt[(row0 + tid) * H + h] : 0.f;
  sm.rowm[tid] = sm.colm[tid] = sm.ddt[tid] = 0.f;
  sm.dinter[tid] = sm.dtail[tid] = sm.rowc[tid] = 0.f;
  float part = 0.f;
  for (int e = tid; e < P * N; e += kThreads) part += gout[e] * hin[e];
  sm.gh[tid] = part;
  __syncthreads();
  const float cum_last = sm.cum[qc - 1];
  sm.tle[tid] = tid < qc ? expf(cum_last - sm.cum[tid]) : 0.f;
  for (int k = kThreads / 2; k > 0; k >>= 1) {   // sum g . h_in, a tree
    if (tid < k) sm.gh[tid] += sm.gh[tid + k];
    __syncthreads();
  }
  const float gh = sm.gh[0];
  const int nt = (qc + kBT - 1) / kBT;

  // inter-chunk: dinter_t = exp(cum_t) dy_t . v_t, v_t[p] = C_t . h_in[p]
  {
    Panel<float, kMaxP, kMaxN> ph;
    ph.load([&](int p) { return p < P ? hin + (long long)p * N : nullptr; },
            N);
    ph.store(&sm.u.r.st[0][0], kLNB);
  }
  for (int ti = 0; ti < nt; ++ti) {
    const int t0 = ti * kBT;
    __syncthreads();
    {
      Panel<T, kBT, kMaxN> pc;
      pc.load([&](int r) { return t0 + r < qc ? cm + (row0 + t0 + r) * N
                                              : nullptr; }, N);
      pc.store(&sm.u.r.rows[0][0], kLNB);
    }
    __syncthreads();
    float v[4][4] = {};
    tile_prod<T, false, true>(
        v, r0, c0, 0, N, [&](int r, int k) { return sm.u.r.rows[r][k]; },
        [&](int k, int n) { return sm.u.r.st[n][k]; });
    row_dot(sm.red, r0, c0, [&](int r, int p, int j, int e) {
      const int t = t0 + r;
      return t < qc && p < P ? to_f(xrow(dy, t)[p]) * v[j][e] : 0.f;
    });
    __syncthreads();
    if (tid < kBT && t0 + tid < qc)
      sm.dinter[t0 + tid] =
          expf(sm.cum[t0 + tid]) * (sm.red[0][tid] + sm.red[1][tid]);
  }

  // intra-chunk, by tiles (t, s) on or below the diagonal: s tiles in
  // order, each over its t tiles in order, dx of the s tile summed over
  // them in the warps' registers
  for (int si = 0; si < nt; ++si) {
    const int s0 = si * kBT;
    float dxa[4][4] = {};
    for (int ti = si; ti < nt; ++ti) {
      const int t0 = ti * kBT;
      __syncthreads();
      {
        Panel<T, kBT, kMaxP> pd, px;
        Panel<float, kBT, kBT> pw;
        pd.load([&](int r) { return t0 + r < qc ? xrow(dy, t0 + r)
                                                : nullptr; }, P);
        px.load([&](int r) { return s0 + r < qc ? xrow(x, s0 + r)
                                                : nullptr; }, P);
        pw.load([&](int r) { return t0 + r < qc
                                        ? cbc + (long long)(t0 + r) * Qs + s0
                                        : nullptr; }, min(kBT, Qs - s0));
        pd.store(&sm.u.t.dy[0][0], kLT);
        px.store(&sm.u.t.xs[0][0], kLT);
        pw.store(&sm.u.t.cb[0][0], kLT);
      }
      __syncthreads();
      // dW[t][s] = dy_t . x_s
      float dw[4][4] = {};
      tile_prod<T, false, false>(
          dw, r0, c0, 0, P, [&](int r, int k) { return sm.u.t.dy[r][k]; },
          [&](int k, int n) { return sm.u.t.xs[n][k]; });
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tl = acc_row(r0, e), sl = acc_col(c0, j, e);
          const int t = t0 + tl, s = s0 + sl;
          float wv = 0.f, mv = 0.f, xv = 0.f;
          if (s <= t && t < qc) {
            const float L = expf(sm.cum[t] - sm.cum[s]);
            const float ld = L * sm.dt[s], cbv = sm.u.t.cb[tl][sl];
            const float d = dw[j][e];
            wv = cbv * ld;
            mv = d * wv;
            xv = d * cbv * L;
          }
          sm.u.t.w[tl][sl] = wv;
          sm.u.t.m[tl][sl] = mv;
          sm.u.t.xd[tl][sl] = xv;
        }
      }
      __syncthreads();
      // the rows' and columns' sums, each by one thread in order
      if (tid < kBT) {
        const float ct = sm.cum[t0 + tid];
        float a = 0.f, w = 0.f;
        for (int k = 0; k < kBT; ++k) {
          a += sm.u.t.m[tid][k];
          w += sm.u.t.m[tid][k] * (ct - sm.cum[s0 + k]);
        }
        sm.rowm[t0 + tid] += a;
        sm.rowc[t0 + tid] += w;
      } else if (tid < 2 * kBT) {
        const int i = tid - kBT;
        float a = 0.f;
        for (int k = 0; k < kBT; ++k) a += sm.u.t.m[k][i];
        sm.colm[s0 + i] += a;
      } else if (tid < 3 * kBT) {
        const int i = tid - 2 * kBT;
        float a = 0.f;
        for (int k = 0; k < kBT; ++k) a += sm.u.t.xd[k][i];
        sm.ddt[s0 + i] += a;
      }
      // dx[s][p] += sum_t W[t][s] dy[t][p]
      tile_prod<T, true, false>(
          dxa, r0, c0, 0, kBT, [&](int r, int k) { return sm.u.t.w[k][r]; },
          [&](int k, int n) { return sm.u.t.dy[k][n]; });
    }
    // the state's term: u[s][p] = B_s . g[p], dtail_s = x_s . u_s,
    // dx_s = sum_t W[t][s] dy_t + tail_s u_s
    __syncthreads();
    {
      Panel<T, kBT, kMaxN> pb;
      Panel<float, kMaxP, kMaxN> pg;
      pb.load([&](int r) { return s0 + r < qc ? bm + (row0 + s0 + r) * N
                                              : nullptr; }, N);
      pg.load([&](int p) { return p < P ? gout + (long long)p * N : nullptr; },
              N);
      pb.store(&sm.u.r.rows[0][0], kLNB);
      pg.store(&sm.u.r.st[0][0], kLNB);
    }
    __syncthreads();
    float u[4][4] = {};
    tile_prod<T, false, true>(
        u, r0, c0, 0, N, [&](int r, int k) { return sm.u.r.rows[r][k]; },
        [&](int k, int n) { return sm.u.r.st[n][k]; });
    row_dot(sm.red, r0, c0, [&](int r, int p, int j, int e) {
      const int s = s0 + r;
      return s < qc && p < P ? to_f(xrow(x, s)[p]) * u[j][e] : 0.f;
    });
    __syncthreads();
    if (tid < kBT && s0 + tid < qc)
      sm.dtail[s0 + tid] = sm.red[0][tid] + sm.red[1][tid];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = s0 + acc_row(r0, e), p = acc_col(c0, j, e);
        if (s < qc && p < P)
          xrow(dx, s)[p] =
              from_f<T>(dxa[j][e] + sm.tle[s] * sm.dt[s] * u[j][e]);
      }
    }
  }
  __syncthreads();

  // dcum, and its reverse cumsum d(dt A), by one thread in order
  if (tid == 0) {
    float ts = 0.f;
    for (int s = 0; s < qc; ++s) ts += sm.tle[s] * sm.dt[s] * sm.dtail[s];
    float run = 0.f;
    for (int t = qc - 1; t >= 0; --t) {
      float d = sm.rowm[t] - sm.colm[t];
      d = d + sm.dinter[t];
      d = d - sm.tle[t] * sm.dt[t] * sm.dtail[t];
      if (t == qc - 1) d = d + (ts + expf(cum_last) * gh);
      run += d;
      sm.rowm[t] = run;
    }
    // the chunk's part of da_log = sum_t dcum_t cum_t, a term at a time
    // with weights that are small where the term is not (see
    // `ssd_scan_bwd_ref`): the intra, inter and state terms' sums apart
    float pm = 0.f, pi = 0.f, pt = 0.f;
    for (int t = 0; t < qc; ++t) {
      pm += sm.rowc[t];
      pi += sm.dinter[t] * sm.cum[t];
      pt += sm.tle[t] * sm.dt[t] * sm.dtail[t] * (cum_last - sm.cum[t]);
    }
    dal[bch] = ((pm + pi) + pt) + expf(cum_last) * gh * cum_last;
  }
  __syncthreads();
  if (tid < qc)
    ddt[(row0 + tid) * H + h] =
        (sm.ddt[tid] + sm.tle[tid] * sm.dtail[tid]) + sm.rowm[tid] * A;
}

struct DbcSmem {
  float sc[kBT];                // a row's scale
  float a[kBT][kLK];            // dCB panel, or exp(cum) dy / tail x [row][p]
  float bb[kBT][kLK];           // B or C rows [k][n], or h_in / g [p][n]
};

// dC (kB false) or dB (kB true) of 64 rows (t0 .. t0 + 63) and 64 columns
// (n0 ..) of one (b, chunk):
//   dC_t = sum_s dCB[t][s] B_s + sum_h sum_p exp(cum_t) dy_t[p] h_in[h][p]
//   dB_s = sum_t dCB[t][s] C_t + sum_h sum_p tail_s x_s[p] g[h][p]
// each sum a chain in its own accumulator (the heads' in (h, p) order),
// the two added last.
template <typename T, bool kB>
__device__ __forceinline__ void dbc_tile(
    DbcSmem& sm, const T* __restrict__ x, const T* __restrict__ bm,
    const T* __restrict__ cm, const float* __restrict__ dt,
    const T* __restrict__ dy, const float* __restrict__ dcb,
    const float* __restrict__ cumw, const float* __restrict__ st,
    const float* __restrict__ rw, T* __restrict__ out, int S, int H, int P,
    int N, int Q, int nc, int b, int ci, int t0, int n0) {
  const int qc = min(Q, S - ci * Q), Qs = q_stride(Q);
  const long long row0 = (long long)b * S + (long long)ci * Q;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
  const float* dcbc = dcb + ((long long)b * nc + ci) * Qs * Qs;
  const T* rows = kB ? cm : bm;     // the rows the dCB panel multiplies
  float acc[4][4] = {}, acc2[4][4] = {};
  // dC: k = s from 0 to the tile's last row; dB: k = t from t0 to qc
  const int k_lo = kB ? t0 : 0, k_hi = kB ? qc : min(t0 + kBT, qc);
  for (int k0 = k_lo; k0 < k_hi; k0 += kBT) {
    __syncthreads();
    {
      // dC: dCB[t0 + r][k0 ..]; dB: dCB[k0 + r][t0 ..] ([k][row])
      const int pr = kB ? k0 : t0, pc = kB ? t0 : k0;
      Panel<float, kBT, kBT> pd;
      Panel<T, kBT, kBT> pn;
      pd.load([&](int r) { return pr + r < qc
                                      ? dcbc + (long long)(pr + r) * Qs + pc
                                      : nullptr; }, min(kBT, Qs - pc));
      pn.load([&](int r) { return k0 + r < qc ? rows + (row0 + k0 + r) * N
                                                        + n0
                                              : nullptr; }, N - n0);
      pd.store(&sm.a[0][0], kLK);
      pn.store(&sm.bb[0][0], kLK);
    }
    __syncthreads();
    tile_prod<T, true, false>(
        acc, r0, c0, 0, kBT,
        [&](int r, int k) { return kB ? sm.a[k][r] : sm.a[r][k]; },
        [&](int k, int n) { return sm.bb[k][n]; });
  }
  const T* xs = kB ? x : dy;
  const float* sts = kB ? rw : st;
  for (int h = 0; h < H; ++h) {
    const long long bch = ((long long)b * nc + ci) * H + h;
    __syncthreads();
    if (tid < kBT) {
      const int t = t0 + tid;
      float v = 0.f;
      if (t < qc) {
        const float cum = cumw[bch * Qs + t];
        v = kB ? expf(cumw[bch * Qs + qc - 1] - cum) * dt[(row0 + t) * H + h]
               : expf(cum);
      }
      sm.sc[tid] = v;
    }
    __syncthreads();
    {
      Panel<T, kBT, kMaxP> pa;
      Panel<float, kMaxP, kBT> ps;
      pa.load([&](int r) { return t0 + r < qc
                                      ? xs + ((row0 + t0 + r) * H + h) * P
                                      : nullptr; }, P);
      ps.load([&](int p) { return p < P ? sts + bch * P * N + (long long)p * N
                                                + n0
                                        : nullptr; }, N - n0);
      pa.store(&sm.a[0][0], kLK, sm.sc);
      ps.store(&sm.bb[0][0], kLK);
    }
    __syncthreads();
    tile_prod<T, true, true>(
        acc2, r0, c0, 0, P, [&](int r, int k) { return sm.a[r][k]; },
        [&](int k, int n) { return sm.bb[k][n]; });
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + acc_row(r0, e), n = n0 + acc_col(c0, j, e);
      if (t < qc && n < N)
        out[(row0 + t) * N + n] = from_f<T>(acc[j][e] + acc2[j][e]);
    }
  }
}

// The float32 lane's dB and dC, grid (4 x row tiles, nc, B): block x =
// 4 tile + 2 half + which, which 0 dC, 1 dB, columns n of the half 64 at a
// time
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dbc_f32_kernel(const T* __restrict__ x, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ dt,
               const T* __restrict__ dy, const float* __restrict__ dcb,
               const float* __restrict__ cumw, const float* __restrict__ st,
               const float* __restrict__ rw, T* __restrict__ db,
               T* __restrict__ dc, int S, int H, int P, int N, int Q, int nc) {
  __shared__ __align__(16) DbcSmem sm;
  const int t0 = (blockIdx.x / 4) * kBT, n0 = ((blockIdx.x / 2) % 2) * kBT;
  const int ci = blockIdx.y, b = blockIdx.z;
  if (n0 >= N || t0 >= min(Q, S - ci * Q)) return;
  if (blockIdx.x % 2)
    dbc_tile<T, true>(sm, x, bm, cm, dt, dy, dcb, cumw, st, rw, db, S, H, P,
                      N, Q, nc, b, ci, t0, n0);
  else
    dbc_tile<T, false>(sm, x, bm, cm, dt, dy, dcb, cumw, st, rw, dc, S, H, P,
                       N, Q, nc, b, ci, t0, n0);
}

// ------------------------------------------------------------------ the
// bf16 lane's tensor-core pieces: mma.sync m16n8k16 in bf16 with a float32
// accumulator, operands staged by cp.async in their own type

// d += a b, one m16n8k16 bf16 product with a float32 accumulator.
// Fragments (lane = 4 g + q), two bf16 a register, the lower k in the low
// half: a0 (g, 2q..), a1 (g + 8, 2q..), a2 (g, 2q + 8..), a3 (g + 8,
// 2q + 8..); b0 (k = 2q.., n = g), b1 (k = 2q + 8.., n = g); d as mma's.
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values (a at the lower k) as kParts bf16 pairs that sum to
// them: the first the pair rounded, each next one the rest rounded (a - hi
// is exact in float32). Two parts hold a value to about 2^-17 of itself,
// three to float32's own rounding. A product of a bf16 value with such a
// split, one mma a part, is as exact as the split.
template <int kParts>
__device__ __forceinline__ void split_bf(float a, float b,
                                         uint32_t (&parts)[kParts]) {
#pragma unroll
  for (int i = 0; i < kParts; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    parts[i] = *reinterpret_cast<const uint32_t*>(&v);
    const float2 f = __bfloat1622float2(v);
    a -= f.x;
    b -= f.y;
  }
}

// two bf16 of shared memory as one register
__device__ __forceinline__ uint32_t ld32(const unsigned short* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// the bf16 at the lower and at the higher address of such a register
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// four 8 x 8 bf16 matrices, transposed: lanes 8 i .. 8 i + 7 give the
// rows of matrix i; a lane gets (2q, g) and (2q + 1, g) of each, the b
// fragment of a [k][n] row-major tile
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const unsigned short* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 (4) bytes from global to shared memory without the registers, zeros
// where !ok (src then only has to be a valid address)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most kPending of this thread's latest groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// R rows of kRowBytes bytes into shared memory (row stride ld bytes), by
// the block's threads, 16 bytes a copy: row r from row(r) (null: zeros),
// its bytes at or past cap zeros (cap a multiple of 16). `any` is a valid
// global address for the copies that read nothing.
template <int R, int kRowBytes, typename Row>
__device__ __forceinline__ void stage_rows(void* dst, int ld, Row row,
                                           int cap, const void* any) {
  constexpr int kPer = kRowBytes / 16, kTotal = R * kPer;
  char* d = static_cast<char*>(dst);
  for (int i = threadIdx.x; i < kTotal; i += kThreads) {
    const int r = i / kPer, c = (i % kPer) * 16;
    const char* src = reinterpret_cast<const char*>(row(r));
    const bool ok = src != nullptr && c < cap;
    cp16(d + r * ld + c, ok ? static_cast<const void*>(src + c) : any, ok);
  }
}

// the same total in every lane of the warp (a butterfly: the partners add
// the same two values)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// row strides of the bf16 lane's shared tiles, chosen so that a warp's
// fragment reads and ldmatrix rows hit 32 different banks
constexpr int kLX = kBT + 8;        // bf16 [row][p] tiles: 36 words a row
constexpr int kLC = kMaxN + 8;      // bf16 [row][n] tiles: 68 words a row
constexpr int kLW = kBT + 4;        // float [t][s] C B^T tiles
constexpr int kLG = kMaxN + 8;      // float [p][n] g (float2 reads)
constexpr int kLF = kMaxN + 4;      // float [p][n] h_in or g (float reads)
// the largest exponent of a factor of exp(cum_t - cum_s) split at a pivot
// step between s and t: both factors and their product stay finite
constexpr float kFactorMax = 40.f;

// ------------------------------------------------------------- the bf16
// lane's first launch

// a K panel of 64 steps: the rows that take the step's scale ([s][p], x or
// dy) and the rows they meet ([s][n], B or C)
struct ChunkStage {
  unsigned short a[kBT][kLX];
  unsigned short r[kBT][kLC];
};
union Chunk16Smem {
  struct {
    float cum[kMaxQ];
    float sc[kMaxQ];               // tail_s (state) or exp(cum_t) (r)
    ChunkStage stage[2];
  } st;
  struct {
    unsigned short c[kBT][kLC];    // C [t][n]
    unsigned short b[kBT][kLC];    // B [s][n]
  } cb;
};

// The bf16 lane's first backward launch, grid (2H + tiles, nc, B), the
// blocks of chunk_block's backward launch: below H, head h's cum (summed
// by one thread in order, as the forward sums it) into cumw and its chunk
// state s_c = sum_s tail_s x_s^T B_s from a zero start into st; the next
// `tiles`, a 64 x 64 tile of C B^T (exact bf16 products); the last H, head
// h's r_c = sum_t exp(cum_t) dy_t^T C_t into rw. On bf16 mma.sync: the
// scaled rows (x tail, dy exp(cum)) split in three bf16 parts, both operands
// through ldmatrix.trans from K panels of 64 steps in a two-stage cp.async
// ring, 16 rows p by 64 n a warp; 3 blocks an SM (<= 85 registers).
__global__ void __launch_bounds__(kThreads, 3)
ssd_bwd_chunk_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ bm,
                     const __nv_bfloat16* __restrict__ cm,
                     const float* __restrict__ dt,
                     const float* __restrict__ a_log, float* __restrict__ cb,
                     float* __restrict__ cumw, float* __restrict__ st,
                     const __nv_bfloat16* __restrict__ dy,
                     float* __restrict__ rw, int S, int H, int P, int N,
                     int Q, int nc) {
  extern __shared__ float4 chunk_smem[];
  Chunk16Smem& sm = *reinterpret_cast<Chunk16Smem*>(chunk_smem);
  const int ci = blockIdx.y, b = blockIdx.z;
  const int qc = min(Q, S - ci * Q), Qs = q_stride(Q);
  const long long row0 = (long long)b * S + (long long)ci * Q;
  const int nt = (Q + kTile - 1) / kTile, tiles = nt * (nt + 1) / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  if (blockIdx.x >= H && blockIdx.x < H + tiles) {
    const int k = blockIdx.x - H;
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
    const int t0 = ti * kTile, s0 = (k - ti * (ti + 1) / 2) * kTile;
    stage_rows<kBT, kMaxN * 2>(&sm.cb.c[0][0], kLC * 2, [&](int r) {
      return t0 + r < qc ? cm + (row0 + t0 + r) * N : nullptr; }, N * 2, cm);
    stage_rows<kBT, kMaxN * 2>(&sm.cb.b[0][0], kLC * 2, [&](int r) {
      return s0 + r < qc ? bm + (row0 + s0 + r) * N : nullptr; }, N * 2, bm);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    const int mr = (warp & 3) * 16, nr = (warp >> 2) * 32;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < N; k0 += 16) {
      const uint32_t a[4] = {ld32(&sm.cb.c[mr + g][k0 + 2 * q]),
                             ld32(&sm.cb.c[mr + g + 8][k0 + 2 * q]),
                             ld32(&sm.cb.c[mr + g][k0 + 8 + 2 * q]),
                             ld32(&sm.cb.c[mr + g + 8][k0 + 8 + 2 * q])};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned short* br = &sm.cb.b[nr + 8 * j + g][k0 + 2 * q];
        mma16(acc[j], a, ld32(br), ld32(br + 8));
      }
    }
    float* out = cb + ((long long)b * nc + ci) * Qs * Qs;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + nr + 8 * j + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t0 + mr + g + 8 * half;
        if (t >= Q) continue;
        if (s < Q) out[(long long)t * Qs + s] = acc[j][2 * half];
        if (s + 1 < Q) out[(long long)t * Qs + s + 1] = acc[j][2 * half + 1];
      }
    }
    return;
  }
  const bool rblk = blockIdx.x >= H + tiles;
  const int h = rblk ? blockIdx.x - H - tiles : blockIdx.x;
  const __nv_bfloat16* as = rblk ? dy : x;   // rows [s][p]
  const __nv_bfloat16* rs = rblk ? cm : bm;  // rows [s][n]
  const long long bch = ((long long)b * nc + ci) * H + h;
  auto issue = [&](int k) {                  // the K panel of steps 64 k ..
    if (kBT * k < qc) {
      ChunkStage& sg = sm.st.stage[k & 1];
      const int s0 = kBT * k;
      stage_rows<kBT, kBT * 2>(&sg.a[0][0], kLX * 2, [&](int r) {
        return s0 + r < qc ? as + ((row0 + s0 + r) * H + h) * P : nullptr; },
        P * 2, as);
      stage_rows<kBT, kMaxN * 2>(&sg.r[0][0], kLC * 2, [&](int r) {
        return s0 + r < qc ? rs + (row0 + s0 + r) * N : nullptr; }, N * 2,
        rs);
    }
    cp_commit();
  };
  issue(0);

  // cum: dt A formed by all threads, then summed step by step by one, as
  // chunk_block sums it, while the first panel's copies are in flight
  const float A = -expf(a_log[h]);
  const float dtv = tid < qc ? dt[(row0 + tid) * H + h] : 0.f;
  sm.st.cum[tid] = dtv * A;
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
#pragma unroll 16
    for (int t = 0; t < kMaxQ; t += 4) {
      float4 v4 = *reinterpret_cast<const float4*>(&sm.st.cum[t]);
      run += v4.x;
      v4.x = run;
      run += v4.y;
      v4.y = run;
      run += v4.z;
      v4.z = run;
      run += v4.w;
      v4.w = run;
      *reinterpret_cast<float4*>(&sm.st.cum[t]) = v4;
    }
  }
  __syncthreads();
  const float v = sm.st.cum[tid];
  if (tid < Qs && !rblk) cumw[bch * Qs + tid] = v;
  const float cum_last = sm.st.cum[qc - 1];
  sm.st.sc[tid] = tid >= qc ? 0.f : rblk ? expf(v) : expf(cum_last - v) * dtv;

  // the product, 16 rows p by 64 n a warp
  const int wr = 16 * (warp & 3), wn = 64 * (warp >> 2);
  const int mi = lane >> 3;
  float acc[8][4] = {};
  const int np = (qc + kBT - 1) / kBT;
  for (int k = 0; k < np; ++k) {
    cp_wait<0>();
    __syncthreads();        // panel k in (and sc); panel k - 1 read
    issue(k + 1);
    const ChunkStage& sg = sm.st.stage[k & 1];
    const int s0 = kBT * k;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int kr = 16 * kk;
      if (s0 + kr >= qc) break;          // past qc the panel is zeros
      // a: the scaled rows as (p, k = s) fragments, split in three
      // (hi, mid, lo): the states feed ddt, da_log and dh0, float32
      uint32_t ar[4], ap[3][4];
      ldsm_x4_trans(ar, &sg.a[kr + 8 * (mi >> 1) + (lane & 7)]
                             [wr + 8 * (mi & 1)]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kc = s0 + kr + 2 * q + 8 * (r >> 1);
        uint32_t pr[3];
        split_bf<3>(bf_lo(ar[r]) * sm.st.sc[kc],
                    bf_hi(ar[r]) * sm.st.sc[kc + 1], pr);
#pragma unroll
        for (int i = 0; i < 3; ++i) ap[i][r] = pr[i];
      }
      const int krow = kr + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (wn + 16 * jp >= N) break;
        uint32_t bq[4];
        ldsm_x4_trans(bq, &sg.r[krow][wn + 16 * jp + 8 * (lane >> 4)]);
#pragma unroll
        for (int i = 2; i >= 0; --i) {     // the smallest part first
          mma16(acc[2 * jp], ap[i], bq[0], bq[1]);
          mma16(acc[2 * jp + 1], ap[i], bq[2], bq[3]);
        }
      }
    }
  }
  float* out = (rblk ? rw : st) + bch * P * N;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = wn + 8 * j + 2 * q;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = wr + g + 8 * half;
      if (p < P && n < N)
        *reinterpret_cast<float2*>(out + p * N + n) =
            make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// ------------------------------------------------------------- the heads'
// score gradient, summed on chip

constexpr int kDcbStages = 3;
// the bf16 lane's head groups (their sums added by the dB, dC launch)
constexpr int kDcbGroups = 2;

// an operand element as shared memory holds it: float, or a bf16's bits
template <typename T>
struct Raw {
  using type = float;
};
template <>
struct Raw<__nv_bfloat16> {
  using type = unsigned short;
};

// one head's operands of a (t, s) tile
template <typename T>
struct DcbStage {
  static constexpr int kLD = kF32<T> ? kBT + 4 : kBT + 8;
  typename Raw<T>::type dy[kBT][kLD];   // dy [t][p]
  typename Raw<T>::type xs[kBT][kLD];   // x [s][p]
  float cum_t[kBT], cum_s[kBT], dt_s[kBT];
};

// the dcb launch's least blocks an SM: bf16 3 (<= 85 registers), float32
// 2 (its stages take 107 KB)
template <typename T>
constexpr int kDcbBlocks = kF32<T> ? 2 : 3;

// grid (tiles x groups, nc, B): block x = group * tiles + tile, tile the
// 64 x 64 tile of (t, s) on or below the diagonal numbered row by row (as
// cb_tile's), the heads of the group H grp / groups .. H (grp + 1) /
// groups: that group's part of
//   dCB[t][s] = sum_h (dy_t . x_s) exp(cum_t - cum_s) dt_s,  s <= t < qc,
// zero elsewhere in the tile, into dcbp[grp][b][chunk] (Qs x Qs), the
// heads added in order in registers. dy_t . x_s: bf16 m16n8k16 (products
// exact, summed in float32), or with float32 operands fmaf chains in p
// order (tile_prod's order). The heads' operands come
// through a ring of kDcbStages stages. With bf16 operands exp(cum_t -
// cum_s) is the fast exp (off by a few float32 ulps times |cum_t - cum_s|:
// dCB meets only the bf16 dB and dC).
template <typename T>
__global__ void __launch_bounds__(kThreads, kDcbBlocks<T>)
ssd_bwd_dcb_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ dt,
                   const float* __restrict__ cumw, float* __restrict__ dcbp,
                   int B, int S, int H, int P, int Q, int nc, int groups) {
  extern __shared__ float4 dcb_smem[];
  DcbStage<T>* stg = reinterpret_cast<DcbStage<T>*>(dcb_smem);
  const int ntl = (Q + kBT - 1) / kBT, tiles = ntl * (ntl + 1) / 2;
  const int tile = blockIdx.x % tiles, grp = blockIdx.x / tiles;
  const int ci = blockIdx.y, b = blockIdx.z;
  const int qc = min(Q, S - ci * Q), Qs = q_stride(Q);
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
  const int t0 = ti * kBT, s0 = (tile - ti * (ti + 1) / 2) * kBT;
  if (t0 >= qc) return;
  const int h0 = H * grp / groups, nh = H * (grp + 1) / groups - h0;
  const long long row0 = (long long)b * S + (long long)ci * Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
  constexpr int kLD = DcbStage<T>::kLD;

  auto issue = [&](int i) {     // head h0 + i into stage i % kDcbStages
    if (i < nh) {
      DcbStage<T>& sg = stg[i % kDcbStages];
      const int h = h0 + i;
      const long long bch = ((long long)b * nc + ci) * H + h;
      stage_rows<kBT, kBT * (int)sizeof(T)>(
          &sg.dy[0][0], kLD * (int)sizeof(T), [&](int r) {
            return t0 + r < qc ? dy + ((row0 + t0 + r) * H + h) * P
                               : nullptr; }, P * (int)sizeof(T), dy);
      stage_rows<kBT, kBT * (int)sizeof(T)>(
          &sg.xs[0][0], kLD * (int)sizeof(T), [&](int r) {
            return s0 + r < qc ? x + ((row0 + s0 + r) * H + h) * P
                               : nullptr; }, P * (int)sizeof(T), x);
      if (tid < 16) {
        const int t = t0 + 4 * tid;
        cp16(&sg.cum_t[4 * tid], t < Qs ? cumw + bch * Qs + t : cumw, t < Qs);
      } else if (tid < 32) {
        const int s = s0 + 4 * (tid - 16);
        cp16(&sg.cum_s[4 * (tid - 16)], s < Qs ? cumw + bch * Qs + s : cumw,
             s < Qs);
      } else if (tid < 32 + kBT) {
        const int s = s0 + tid - 32;
        cp4(&sg.dt_s[tid - 32], s < qc ? dt + (row0 + s) * H + h : dt,
            s < qc);
      }
    }
    cp_commit();
  };

  float acc[4][4] = {};
#pragma unroll
  for (int i = 0; i < kDcbStages - 1; ++i) issue(i);
  for (int i = 0; i < nh; ++i) {
    cp_wait<kDcbStages - 2>();
    __syncthreads();            // head i's operands in; head i - 1's read
    issue(i + kDcbStages - 1);
    const DcbStage<T>& sg = stg[i % kDcbStages];
    float d[4][4] = {};
    if constexpr (kF32<T>) {
      for (int k8 = 0; k8 < P; k8 += 8) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          fma_k8(d[j], g, q, [&](int r, int k) { return sg.dy[r0 + r][k8 + k]; },
                 [&](int k, int n) { return sg.xs[c0 + 8 * j + n][k8 + k]; });
      }
    } else {
#pragma unroll
      for (int k0 = 0; k0 < kMaxP; k0 += 16) {
        if (k0 >= P) break;      // past P the tiles hold zeros
        const uint32_t a[4] = {ld32(&sg.dy[r0 + g][k0 + 2 * q]),
                               ld32(&sg.dy[r0 + g + 8][k0 + 2 * q]),
                               ld32(&sg.dy[r0 + g][k0 + 8 + 2 * q]),
                               ld32(&sg.dy[r0 + g + 8][k0 + 8 + 2 * q])};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned short* xr = &sg.xs[c0 + 8 * j + g][k0];
          mma16(d[j], a, ld32(xr + 2 * q), ld32(xr + 8 + 2 * q));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tl = acc_row(r0, e), sl = acc_col(c0, j, e);
        if (s0 + sl <= t0 + tl && t0 + tl < qc) {
          const float a = sg.cum_t[tl] - sg.cum_s[sl];
          const float ld = (kF32<T> ? expf(a) : __expf(a)) * sg.dt_s[sl];
          acc[j][e] += __fmul_rn(d[j][e], ld);
        }
      }
    }
  }
  float* out = dcbp + (((long long)grp * B + b) * nc + ci) * Qs * Qs;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = s0 + acc_col(c0, j, 0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + acc_row(r0, 2 * half);
      if (t < Qs && s < Qs)
        *reinterpret_cast<float2*>(out + (long long)t * Qs + s) =
            make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// ------------------------------------------------------------- the bf16
// lane's main launch

// one step's operands in its two-stage ring
union MainStage {
  struct {
    unsigned short x[kBT][kLX];   // x of an s tile [s][p]
    unsigned short b[kBT][kLC];   // B of it [s][n]
  } st;                           // the state's term
  struct {
    unsigned short dy[kBT][kLX];  // dy of a t tile [t][p]
    float cb[kBT][kLW];           // C B^T [t][s] of the (t, s) tile
  } ra;                           // the intra-chunk terms
  float xch[8][4][32][4];         // dx's halves between the warps
};
struct MainSmem {
  MainStage stage[2];
  unsigned short xs[kBT][kLX];    // x of the s tile [s][p]
  float gf[kMaxP][kLG];           // g [p][n]
  float cum[kMaxQ], dt[kMaxQ];
  float tle[kMaxQ];               // exp(cum_last - cum_s)
  float rowm[kMaxQ];              // sum_s dW W [t][s]
  float rowc[kMaxQ];              // sum_s dW W [t][s] (cum_t - cum_s)
  float colm[kMaxQ];              // sum_t dW W [t][s]
  float ddt[kMaxQ];               // sum_t dW (C B^T) exp(cum_t - cum_s)
  float dinter[kMaxQ];            // exp(cum_t) dy_t . (h_in C_t)
  float dtail[kMaxQ];             // x_s . u_s = B_s . (x_s g)
  float red[2][4][2][kBT];        // the warps' partial sums of a step's
                                  // rows, by the step's parity
  float redc[2][2][kBT];          // and of an s tile's columns
  float part[8][4], part2[8];     // the warps' sums in the closing
};

// The bf16 lane's main launch, grid (H, nc, B), 256 threads, one (b, chunk,
// head) (the float32 lane's computes the same): dx, ddt and the chunk's
// part of da_log, after the carries (h_in in st, g in rw) and the dB, dC
// launch (dinw: dinter_t = exp(cum_t) dy_t . (h_in C_t), formed there
// beside dC's term over the heads; dtw: dtail_s = x_s . u_s, beside dB's).
// A
// sequence of steps, each one tile's operands staged by cp.async into a
// two-stage ring while the last step's are multiplied; for each s tile:
//   state: u = B g^T over the warp's half of n, 16 rows s by 64 p, g
//     split in two bf16 parts as it is read (u reaches only dx here);
//     the warp's dx accumulator starts at tail_s u_s;
//     x stays in shared memory for the s tile;
//   intra, a t tile at a time from the diagonal: dW^T = x dy^T (16 rows s
//     by 32 t a warp), W, M = dW W and dW (C B^T) L elementwise, their
//     sums over s (butterflies over the lanes, then the four warps of a
//     column in order) and over t (a lane's chain across the t tiles,
//     summed over the lanes and the two warps of a row at the s tile's
//     end); dx += W^T dy with W from the product's own registers (split in
//     two bf16 parts) and dy through ldmatrix.trans; at the s tile's end
//     the two warps of a row add their halves (t's first half first).
// A step's sums over its warps are finished after the next step's barrier
// (`finish`), so a step waits at one barrier. The closing: dcum, its
// reverse cumsum by warp scans, ddt and da_log's three sums, a term at a
// time (see ssd_scan_bwd_ref), all in a fixed order. No register array is
// indexed at run time: one that is goes to local memory (the dx
// accumulator there cost this launch over a quarter of its time).
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_main_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ bm,
                    const __nv_bfloat16* __restrict__ cm,
                    const float* __restrict__ dt,
                    const float* __restrict__ a_log,
                    const __nv_bfloat16* __restrict__ dy,
                    const float* __restrict__ cb,
                    const float* __restrict__ cumw,
                    const float* __restrict__ st,
                    const float* __restrict__ rw,
                    const float* __restrict__ dinw,
                    const float* __restrict__ dtw, float* __restrict__ dal,
                    __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
                    int S, int H, int P, int N, int Q, int nc) {
  extern __shared__ float4 main_smem[];
  MainSmem& sm = *reinterpret_cast<MainSmem*>(main_smem);
  const int h = blockIdx.x, ci = blockIdx.y, b = blockIdx.z;
  const int qc = min(Q, S - ci * Q), Qs = q_stride(Q);
  const long long row0 = (long long)b * S + (long long)ci * Q;
  const long long bch = ((long long)b * nc + ci) * H + h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wr = 16 * (warp & 3);     // the warp's 16 rows (t, then s)
  const int hw = warp >> 2, wc = 32 * hw;   // its half of the columns
  const float* hs = st + bch * P * N;   // h_in [p][n]
  const float* gs = rw + bch * P * N;   // g [p][n]
  const float* cbc = cb + ((long long)b * nc + ci) * Qs * Qs;
  const int nt = (qc + kBT - 1) / kBT;
  const int nsteps = nt + nt * (nt + 1) / 2;
  auto xrow = [&](const __nv_bfloat16* base, int t) {   // row t of x or dy
    return base + ((row0 + t) * H + h) * P;
  };
  // step k: kind 1 state (s tile i), 2 intra (s tile i, t tile j)
  auto decode = [&](int k, int& kind, int& i, int& j) {
    for (i = 0; k >= nt - i + 1; ++i) k -= nt - i + 1;
    kind = k == 0 ? 1 : 2;
    j = i + k - 1;
  };
  auto issue = [&](int k) {
    if (k < nsteps) {
      int kind, i, j;
      decode(k, kind, i, j);
      MainStage& sg = sm.stage[k & 1];
      if (kind == 1) {
        const int s0 = kBT * i;
        stage_rows<kBT, kBT * 2>(&sg.st.x[0][0], kLX * 2, [&](int r) {
          return s0 + r < qc ? xrow(x, s0 + r) : nullptr; }, P * 2, x);
        stage_rows<kBT, kMaxN * 2>(&sg.st.b[0][0], kLC * 2, [&](int r) {
          return s0 + r < qc ? bm + (row0 + s0 + r) * N : nullptr; },
          N * 2, bm);
      } else {
        const int s0 = kBT * i, t0 = kBT * j;
        stage_rows<kBT, kBT * 2>(&sg.ra.dy[0][0], kLX * 2, [&](int r) {
          return t0 + r < qc ? xrow(dy, t0 + r) : nullptr; }, P * 2, dy);
        stage_rows<kBT, kBT * 4>(&sg.ra.cb[0][0], kLW * 4, [&](int r) {
          return t0 + r < qc ? cbc + (long long)(t0 + r) * Qs + s0
                             : nullptr; }, (Qs - s0) * 4, cb);
      }
    }
    cp_commit();
  };
  // g goes out with the first step's operands
  stage_rows<kMaxP, kMaxN * 4>(&sm.gf[0][0], kLG * 4, [&](int p) {
    return p < P ? gs + (long long)p * N : nullptr; }, N * 4, rw);
  issue(0);
  const float A = -expf(a_log[h]);
  sm.cum[tid] = tid < qc ? cumw[bch * Qs + tid] : 0.f;   // a thread a step
  sm.dt[tid] = tid < qc ? dt[(row0 + tid) * H + h] : 0.f;
  sm.rowm[tid] = sm.rowc[tid] = sm.colm[tid] = sm.ddt[tid] = 0.f;
  sm.dinter[tid] = tid < qc ? dinw[bch * Qs + tid] : 0.f;
  sm.dtail[tid] = tid < qc ? dtw[bch * Qs + tid] : 0.f;
  // g . h_in: each thread's part in order, then the warps' in order
  float gh = 0.f;
  for (int e = 4 * tid; e < P * N; e += 4 * kThreads) {
    const float4 a = *reinterpret_cast<const float4*>(hs + e);
    const float4 u = *reinterpret_cast<const float4*>(gs + e);
    gh += u.x * a.x;
    gh += u.y * a.y;
    gh += u.z * a.z;
    gh += u.w * a.w;
  }
  gh = warp_sum(gh);
  if (lane == 0) sm.part[warp][0] = gh;
  __syncthreads();
  const float cum_last = sm.cum[qc - 1];
  sm.tle[tid] = tid < qc ? expf(cum_last - sm.cum[tid]) : 0.f;
  gh = 0.f;
#pragma unroll
  for (int w = 0; w < 8; ++w) gh += sm.part[w][0];

  // an intra step k's sums over the warps, from red[k & 1], by the
  // threads of its 64 rows t: rowm and rowc
  auto finish = [&](int k) {
    int kind, i, j;
    decode(k, kind, i, j);
    const float(*rd)[2][kBT] = sm.red[k & 1];
    const int r = kBT * j + tid;
    if (kind == 1 || tid >= kBT || r >= qc) return;
    sm.rowm[r] += ((rd[0][0][tid] + rd[1][0][tid]) + rd[2][0][tid]) +
                  rd[3][0][tid];
    sm.rowc[r] += ((rd[0][1][tid] + rd[1][1][tid]) + rd[2][1][tid]) +
                  rd[3][1][tid];
  };

  float acc[8][4];      // dx of the s tile: the warp's 16 rows s by 64 p
  float cs[2], dts[2];  // cum and dt of the two rows s a lane holds
  float fs[2];          // exp(cum_piv - cum_s), piv the s tile's last step
  bool fok;             // fs is finite and safe to multiply
  float cm2[2], dd2[2]; // their sums over t of M and of dW (C B^T) L

  for (int k = 0; k < nsteps; ++k) {
    int kind, i, j;
    decode(k, kind, i, j);
    cp_wait<0>();
    __syncthreads();          // step k's operands in; step k - 1's read
    if (k > 0) finish(k - 1);
    float(*rd)[2][kBT] = sm.red[k & 1];
    issue(k + 1);
    const MainStage& sg = sm.stage[k & 1];

    if (kind == 1) {
      // u = B g^T over the warp's half of n (its dx accumulator), then
      // the accumulator times tail_s
      const int s0 = kBT * i;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
      const int n1 = min(N, 64 * hw + 64);
      for (int k0 = 64 * hw; k0 < n1; k0 += 16) {
        const uint32_t a[4] = {ld32(&sg.st.b[wr + g][k0 + 2 * q]),
                               ld32(&sg.st.b[wr + g + 8][k0 + 2 * q]),
                               ld32(&sg.st.b[wr + g][k0 + 8 + 2 * q]),
                               ld32(&sg.st.b[wr + g + 8][k0 + 8 + 2 * q])};
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float* gr = &sm.gf[8 * jj + g][k0 + 2 * q];
          const float2 v0 = *reinterpret_cast<const float2*>(gr);
          const float2 v1 = *reinterpret_cast<const float2*>(gr + 8);
          uint32_t b0[2], b1[2];
          split_bf<2>(v0.x, v0.y, b0);
          split_bf<2>(v1.x, v1.y, b1);
          float t4[4] = {0.f, 0.f, 0.f, 0.f};
          mma16(t4, a, b0[1], b1[1]);
          mma16(t4, a, b0[0], b1[0]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[jj][e] += t4[e];
        }
      }
      // x stays for the s tile's intra steps
      for (int c = tid; c < kBT * kBT / 8; c += kThreads)
        *reinterpret_cast<uint4*>(&sm.xs[c / 8][8 * (c % 8)]) =
            *reinterpret_cast<const uint4*>(&sg.st.x[c / 8][8 * (c % 8)]);
      const float piv = sm.cum[s0 + kBT - 1];
      fok = true;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = s0 + wr + g + 8 * half;
        cs[half] = sm.cum[s];
        dts[half] = sm.dt[s];
        fok = fok && piv - cs[half] <= kFactorMax;
        fs[half] = expf(fok ? piv - cs[half] : 0.f);
        const float tail = sm.tle[s] * sm.dt[s];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          acc[jj][2 * half] *= tail;
          acc[jj][2 * half + 1] *= tail;
        }
        cm2[half] = dd2[half] = 0.f;
      }
    } else {
      const int s0 = kBT * i, t0 = kBT * j;
      // dW^T = x dy^T: 16 rows s by 32 t a warp
      float d[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk >= P) break;    // past P the tiles hold zeros
        const uint32_t xa[4] = {ld32(&sm.xs[wr + g][16 * kk + 2 * q]),
                                ld32(&sm.xs[wr + g + 8][16 * kk + 2 * q]),
                                ld32(&sm.xs[wr + g][16 * kk + 8 + 2 * q]),
                                ld32(&sm.xs[wr + g + 8][16 * kk + 8 + 2 * q])};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const unsigned short* dr = &sg.ra.dy[wc + 8 * jj + g][16 * kk];
          mma16(d[jj], xa, ld32(dr + 2 * q), ld32(dr + 8 + 2 * q));
        }
      }
      // W = (C B^T) L dt_s, M = dW W, dW (C B^T) L, L = exp(cum_t -
      // cum_s), for s <= t < qc; d keeps W for W^T dy. Below the diagonal
      // tile L = exp(cum_t - cum_piv) fs, both factors in (0, 1] where cum
      // falls (dt >= 0): one exp a column instead of one an element.
      const bool below = j > i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float rm[2], rc[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int tl = wc + 8 * jj + 2 * q + e, t = t0 + tl;
          const float ct = sm.cum[t];
          const float ea = ct - sm.cum[s0 + kBT - 1];
          const bool fact = below && fok && ea <= kFactorMax;
          const float et = expf(fact ? ea : 0.f);
          float m2 = 0.f, c2 = 0.f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int sl = wr + g + 8 * half;
            float w = 0.f;
            if (s0 + sl <= t && t < qc) {
              const float L = fact ? et * fs[half] : expf(ct - cs[half]);
              const float ld = L * dts[half], cbv = sg.ra.cb[tl][sl];
              const float dv = d[jj][2 * half + e];
              w = cbv * ld;
              const float m = dv * w;
              m2 += m;
              c2 += m * (ct - cs[half]);
              cm2[half] += m;
              dd2[half] += dv * cbv * L;
            }
            d[jj][2 * half + e] = w;
          }
          rm[e] = m2;
          rc[e] = c2;
        }
        // the column's sums over the warp's rows s: a butterfly over g
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            rm[e] += __shfl_xor_sync(0xffffffffu, rm[e], o);
            rc[e] += __shfl_xor_sync(0xffffffffu, rc[e], o);
          }
          if (g == 0) {
            const int tl = wc + 8 * jj + 2 * q + e;
            rd[warp & 3][0][tl] = rm[e];
            rd[warp & 3][1][tl] = rc[e];
          }
        }
      }
      // dx += W^T dy: W from d (rows s, k = t), split in two bf16 parts;
      // dy [t][p] through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ahi[4], alo[4], pr[2];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          split_bf<2>(d[2 * kk + (r >> 1)][2 * (r & 1)],
                      d[2 * kk + (r >> 1)][2 * (r & 1) + 1], pr);
          ahi[r] = pr[0];
          alo[r] = pr[1];
        }
        const int tk = wc + 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (16 * jp >= P) break;
          uint32_t bq[4];
          ldsm_x4_trans(bq, &sg.ra.dy[tk][16 * jp + 8 * (lane >> 4)]);
          mma16(acc[2 * jp], alo, bq[0], bq[1]);
          mma16(acc[2 * jp], ahi, bq[0], bq[1]);
          mma16(acc[2 * jp + 1], alo, bq[2], bq[3]);
          mma16(acc[2 * jp + 1], ahi, bq[2], bq[3]);
        }
      }
      if (j == nt - 1) {
        // the s tile's end: the columns' sums over the lanes and the two
        // warps of a row; dx's halves exchanged through this stage, its
        // reads done
        __syncthreads();
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          cm2[half] += __shfl_xor_sync(0xffffffffu, cm2[half], 1);
          cm2[half] += __shfl_xor_sync(0xffffffffu, cm2[half], 2);
          dd2[half] += __shfl_xor_sync(0xffffffffu, dd2[half], 1);
          dd2[half] += __shfl_xor_sync(0xffffffffu, dd2[half], 2);
        }
        if (q == 0) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            sm.redc[hw][0][wr + g + 8 * half] = cm2[half];
            sm.redc[hw][1][wr + g + 8 * half] = dd2[half];
          }
        }
        MainStage& xs = sm.stage[k & 1];
        float4* mine = reinterpret_cast<float4*>(&xs.xch[warp][0][0][0]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {   // the tiles p the partner owns
          mine[32 * jj + lane] =
              hw == 0 ? make_float4(acc[4 + jj][0], acc[4 + jj][1],
                                    acc[4 + jj][2], acc[4 + jj][3])
                      : make_float4(acc[jj][0], acc[jj][1], acc[jj][2],
                                    acc[jj][3]);
        }
        __syncthreads();
        if (tid < kBT && s0 + tid < qc) {
          sm.colm[s0 + tid] = sm.redc[0][0][tid] + sm.redc[1][0][tid];
          sm.ddt[s0 + tid] = sm.redc[0][1][tid] + sm.redc[1][1][tid];
        }
        const float4* theirs =
            reinterpret_cast<const float4*>(&xs.xch[warp ^ 4][0][0][0]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {   // the tiles p this warp owns
          const float4 o = theirs[32 * jj + lane];
          const float ov[4] = {o.x, o.y, o.z, o.w};
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)   // t's first half first
            v[e] = hw == 0 ? acc[jj][e] + ov[e] : ov[e] + acc[4 + jj][e];
          const int p = 8 * (jj + 4 * hw) + 2 * q;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int s = s0 + wr + g + 8 * half;
            if (s < qc && p < P)
              *reinterpret_cast<__nv_bfloat162*>(
                  dx + ((row0 + s) * H + h) * P + p) =
                  __floats2bfloat162_rn(v[2 * half], v[2 * half + 1]);
          }
        }
      }
    }
  }
  __syncthreads();
  finish(nsteps - 1);
  __syncthreads();

  // the closing, a thread a step t: dcum, d(dt A) = its reverse cumsum,
  // ddt, and the chunk's part of da_log as three sums of weighted terms
  const int t = tid;
  const float term = t < qc ? sm.tle[t] * sm.dt[t] * sm.dtail[t] : 0.f;
  float r4[4] = {term, t < qc ? sm.rowc[t] : 0.f,
                 t < qc ? sm.dinter[t] * sm.cum[t] : 0.f,
                 term * (cum_last - sm.cum[t])};
#pragma unroll
  for (int u = 0; u < 4; ++u) r4[u] = warp_sum(r4[u]);
  if (lane == 0)
#pragma unroll
    for (int u = 0; u < 4; ++u) sm.part[warp][u] = r4[u];
  __syncthreads();
  float tot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int w = 0; w < 8; ++w)
#pragma unroll
    for (int u = 0; u < 4; ++u) tot[u] += sm.part[w][u];
  float dc = 0.f;
  if (t < qc) {
    dc = sm.rowm[t] - sm.colm[t];
    dc = dc + sm.dinter[t];
    dc = dc - term;
    if (t == qc - 1) dc = dc + (tot[0] + expf(cum_last) * gh);
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {   // sum over the lanes from this one
    const float y = __shfl_down_sync(0xffffffffu, dc, o);
    if (lane + o < 32) dc += y;
  }
  if (lane == 0) sm.part2[warp] = dc;
  __syncthreads();
  float later = 0.f;                   // the later warps', the last first
  for (int w = 7; w > warp; --w) later += sm.part2[w];
  const float run = dc + later;
  if (t < qc)
    ddt[(row0 + t) * H + h] =
        (sm.ddt[t] + sm.tle[t] * sm.dtail[t]) + run * A;
  if (tid == 0)
    dal[bch] = ((tot[1] + tot[2]) + tot[3]) + expf(cum_last) * gh * cum_last;
}

// --------------------------------------------------- the bf16 lane's dB, dC

constexpr int kDbcHeads = 20;       // heads a piece of the dB, dC launch

// one step's operands in the dB, dC launch's two-stage ring
constexpr int kDbcK = 32;           // steps of a score-gradient K panel
constexpr int kLD3 = kDbcK + 8;     // float [t][s] dCB panels (read
                                    // transposed, for dB, on 16 banks)
union DbcStage {
  struct {
    unsigned short a[kBT][kLX];  // dy (dC) or x (dB) of the rows [r][p]
    float cum[kBT];              // cum of the rows
    float dt[kBT];               // dt of the rows (dB)
    float last[4];               // cum at the chunk's last step (dB)
    float f[kMaxP][kLF];         // h_in (dC) or g (dB) [p][n]
  } hd;                          // a head
  struct {
    float d[kDcbGroups][kBT][kLD3];  // dCB's groups, 64 rows by 32 [t][s]
    unsigned short r[kBT][kLC];      // B (dC) or C (dB) [k][n]
  } in;                              // the score gradient's term
};
struct Dbc16Smem {
  DbcStage stage[2];
  unsigned short c[kBT][kLC];    // C (dC) or B (dB) of the rows
  float red[2][4][kBT];          // the n quarters' parts of dinter, dtail
};

// grid (2 x row tiles x pieces, nc, B): block x = 2 (piece x row tiles +
// tile) + which, which 0 dC, 1 dB, of the tile's 64 rows and all n:
//   dC_t = sum_s dCB[t][s] B_s + sum_h exp(cum_t) sum_p dy_t[p] h_in[h][p]
//   dB_s = sum_t dCB[t][s] C_t + sum_h tail_s sum_p x_s[p] g[h][p]
// piece 0 takes the score gradient's term (dCB the sum of its groups, in
// order, times B or C, K panels of 32 steps), piece p > 0 the heads
// 20 (p - 1) .. 20 p - 1 (a product of depth 20 P), into part[2 p + which]
// (B x S x N float32), which ssd_bwd_finish_kernel adds in order. The dC
// blocks also give y's inter-chunk term of dcum, dinter_t = exp(cum_t)
// C_t . z_t with z = dy h_in^T over p (their own product), into dinw, and
// the dB blocks the state's, dtail_s = B_s . z_s with z = x g^T, into dtw
// (B x nc x H x Qs): each n quarter's part times exp(cum_t), the quarters
// added in order after the next step's barrier. 8 warps of 32 rows by 32
// n; every operand through a two-stage cp.async ring, bf16 m16n8k16: the
// float32 operands split into bf16 parts as they are read, dCB in two (it
// meets only the bf16 dB and dC), h_in and g in three (z gives dinter and
// dtail, which ddt and da_log take); a head's product of dy or x with h_in
// or g formed apart and added times the rows' scales.
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dbc_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ bm,
                   const __nv_bfloat16* __restrict__ cm,
                   const float* __restrict__ dt,
                   const __nv_bfloat16* __restrict__ dy,
                   const float* __restrict__ dcbp,
                   const float* __restrict__ cumw,
                   const float* __restrict__ st,
                   const float* __restrict__ rw,
                   float* __restrict__ part, float* __restrict__ dinw,
                   float* __restrict__ dtw, int B, int S, int H, int P,
                   int N, int Q, int nc) {
  extern __shared__ float4 dbc_smem[];
  Dbc16Smem& sm = *reinterpret_cast<Dbc16Smem*>(dbc_smem);
  const int nrt = (Q + kBT - 1) / kBT;
  const bool kb = blockIdx.x & 1;     // dB
  const int tile = (blockIdx.x >> 1) % nrt, piece = (blockIdx.x >> 1) / nrt;
  const int ci = blockIdx.y, b = blockIdx.z;
  const int qc = min(Q, S - ci * Q), Qs = q_stride(Q);
  const int t0 = tile * kBT;
  if (t0 >= qc) return;
  const long long row0 = (long long)b * S + (long long)ci * Q;
  const int h_lo = piece > 0 ? kDbcHeads * (piece - 1) : 0;
  const int h_hi = piece > 0 ? min(H, h_lo + kDbcHeads) : 0;
  // the score gradient's panels (piece 0): dC over s up to the tile's last
  // row, dB over t from its first
  const int nd = piece > 0 ? 0
                 : kb ? (qc - t0 + kDbcK - 1) / kDbcK
                      : (min(t0 + kBT, qc) + kDbcK - 1) / kDbcK;
  const int nsteps = nd + h_hi - h_lo;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wr = 32 * (warp & 1), wn = 32 * (warp >> 1);
  const __nv_bfloat16* rows = kb ? cm : bm;   // what dCB meets
  const __nv_bfloat16* as = kb ? x : dy;
  const float* fs = kb ? rw : st;     // g or h_in
  const long long gstride = (long long)B * nc * Qs * Qs;
  const float* dcbc = dcbp + ((long long)b * nc + ci) * Qs * Qs;
  auto bch_of = [&](int k) {          // (b, chunk, head) of head step k
    return ((long long)b * nc + ci) * H + h_lo + k - nd;
  };

  auto issue = [&](int k) {
    if (k < nsteps) {
      DbcStage& sg = sm.stage[k & 1];
      if (k < nd) {
        // dC: dCB[t0 + r][k0 ..] and B rows k0 ..; dB: dCB[k0 + r][t0 ..]
        // and C rows k0 .., 32 steps k0 .. at a time
        const int k0 = kb ? t0 + kDbcK * k : kDbcK * k;
        const int pr = kb ? k0 : t0, pc = kb ? t0 : k0;
#pragma unroll
        for (int gi = 0; gi < kDcbGroups; ++gi) {
          // dC: 64 rows t of kDbcK s; dB: kDbcK rows t of 64 s, as
          // kBT / kDbcK blocks of kDbcK columns, one under the other
          const float* src = dcbc + gi * gstride + (long long)pr * Qs + pc;
          if (kb) {
#pragma unroll
            for (int c = 0; c < kBT / kDbcK; ++c)
              stage_rows<kDbcK, kDbcK * 4>(
                  &sg.in.d[gi][c * kDbcK][0], kLD3 * 4, [&](int r) {
                    return pr + r < qc ? src + (long long)r * Qs + c * kDbcK
                                       : nullptr; },
                  (Qs - pc - c * kDbcK) * 4, dcbp);
          } else {
            stage_rows<kBT, kDbcK * 4>(&sg.in.d[gi][0][0], kLD3 * 4,
                                       [&](int r) {
              return pr + r < qc ? src + (long long)r * Qs : nullptr; },
              (Qs - pc) * 4, dcbp);
          }
        }
        stage_rows<kDbcK, kMaxN * 2>(&sg.in.r[0][0], kLC * 2, [&](int r) {
          return k0 + r < qc ? rows + (row0 + k0 + r) * N : nullptr; },
          N * 2, rows);
      } else {
        const int h = h_lo + k - nd;
        const long long bch = bch_of(k);
        stage_rows<kBT, kBT * 2>(&sg.hd.a[0][0], kLX * 2, [&](int r) {
          return t0 + r < qc ? as + ((row0 + t0 + r) * H + h) * P
                             : nullptr; }, P * 2, as);
        stage_rows<kMaxP, kMaxN * 4>(&sg.hd.f[0][0], kLF * 4, [&](int p) {
          return p < P ? fs + bch * P * N + (long long)p * N : nullptr; },
          N * 4, fs);
        if (tid < 16) {
          const int t = t0 + 4 * tid;
          cp16(&sg.hd.cum[4 * tid], t < Qs ? cumw + bch * Qs + t : cumw,
               t < Qs);
        } else if (kb && tid < 16 + kBT) {
          const int t = t0 + tid - 16;
          cp4(&sg.hd.dt[tid - 16], t < qc ? dt + (row0 + t) * H + h : dt,
              t < qc);
        } else if (kb && tid == 16 + kBT) {
          cp4(&sg.hd.last[0], cumw + bch * Qs + qc - 1, true);
        }
      }
    }
    cp_commit();
  };
  // head step k's dinter (dC) or dtail (dB): the n quarters' parts added
  // in order
  auto finish = [&](int k) {
    if (k < nd || tid >= kBT || t0 + tid >= Qs) return;
    const float(*rd)[kBT] = sm.red[k & 1];
    (kb ? dtw : dinw)[bch_of(k) * Qs + t0 + tid] =
        ((rd[0][tid] + rd[1][tid]) + rd[2][tid]) + rd[3][tid];
  };

  if (piece > 0) {             // the rows' own C (dC) or B (dB)
    const __nv_bfloat16* own = kb ? bm : cm;
    stage_rows<kBT, kMaxN * 2>(&sm.c[0][0], kLC * 2, [&](int r) {
      return t0 + r < qc ? own + (row0 + t0 + r) * N : nullptr; }, N * 2,
      own);
  }
  float acc[2][4][4] = {};
  issue(0);
  for (int k = 0; k < nsteps; ++k) {
    cp_wait<0>();
    __syncthreads();          // step k's operands in; step k - 1's read
    if (k > 0) finish(k - 1);
    issue(k + 1);
    const DbcStage& sg = sm.stage[k & 1];
    if (k < nd) {
#pragma unroll
      for (int kk = 0; kk < kDbcK / 16; ++kk) {
        // a: dCB (dC [t][s], dB [s][t] read from [t][s]), the groups
        // added in order, split in two
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int rr = wr + 16 * mi + g + 8 * (r & 1);
            const int cc = 16 * kk + 2 * q + 8 * (r >> 1);
            float v0 = 0.f, v1 = 0.f;
#pragma unroll
            for (int gi = 0; gi < kDcbGroups; ++gi) {
              if (kb) {   // row cc of t, column rr of s: its column block
                const float* dd = &sg.in.d[gi][0][0] + (rr / kDbcK) * kDbcK
                                  * kLD3 + rr % kDbcK;
                v0 += dd[cc * kLD3];
                v1 += dd[(cc + 1) * kLD3];
              } else {
                const float2 f =
                    *reinterpret_cast<const float2*>(&sg.in.d[gi][rr][cc]);
                v0 += f.x;
                v1 += f.y;
              }
            }
            uint32_t pr[2];
            split_bf<2>(v0, v1, pr);
            ahi[mi][r] = pr[0];
            alo[mi][r] = pr[1];
          }
        }
        const int kr = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int n0 = wn + 16 * np;
          if (n0 >= N) break;
          uint32_t bq[4];
          ldsm_x4_trans(bq, &sg.in.r[kr][n0 + 8 * (lane >> 4)]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma16(acc[mi][2 * np], alo[mi], bq[0], bq[1]);
            mma16(acc[mi][2 * np], ahi[mi], bq[0], bq[1]);
            mma16(acc[mi][2 * np + 1], alo[mi], bq[2], bq[3]);
            mma16(acc[mi][2 * np + 1], ahi[mi], bq[2], bq[3]);
          }
        }
      }
    } else {
      // the rows' scales: dC exp(cum_t), dB exp(cum_last - cum_s) dt_s
      float sc[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rl = wr + 16 * mi + g + 8 * half;
          sc[mi][half] =
              t0 + rl >= qc ? 0.f
              : kb ? expf(sg.hd.last[0] - sg.hd.cum[rl]) * sg.hd.dt[rl]
                   : expf(sg.hd.cum[rl]);
        }
      }
      // z = a f over the head's p (a exact in bf16, f split in three
      // bf16 parts as it is read), then acc += the rows' scales times z
      float z[2][4][4] = {};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk >= P) break;      // past P the tiles hold zeros
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a[mi][r] = ld32(&sg.hd.a[wr + 16 * mi + g + 8 * (r & 1)]
                                    [16 * kk + 2 * q + 8 * (r >> 1)]);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int n0 = wn + 16 * np;
          if (n0 >= N) break;
          // b fragments: r & 1 the k half, r >> 1 the 8 columns n
          uint32_t bp[3][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int kf = 16 * kk + 8 * (r & 1) + 2 * q;
            const int nf = n0 + 8 * (r >> 1) + g;
            uint32_t pr[3];
            split_bf<3>(sg.hd.f[kf][nf], sg.hd.f[kf + 1][nf], pr);
#pragma unroll
            for (int i = 0; i < 3; ++i) bp[i][r] = pr[i];
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
            for (int i = 2; i >= 0; --i) {   // the smallest part first
              mma16(z[mi][2 * np], a[mi], bp[i][0], bp[i][1]);
              mma16(z[mi][2 * np + 1], a[mi], bp[i][2], bp[i][3]);
            }
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mi][nj][e] += sc[mi][e >> 1] * z[mi][nj][e];
      {
        // this warp's n of dinter, exp(cum_t) C_t . z_t (dC), or of
        // dtail, B_s . z_s (dB)
        float (*rd)[kBT] = sm.red[k & 1];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int rl = wr + 16 * mi + g + 8 * half;
            float rs = 0.f;
#pragma unroll
            for (int nj = 0; nj < 4; ++nj) {
              const uint32_t w = ld32(&sm.c[rl][wn + 8 * nj + 2 * q]);
              rs += bf_lo(w) * z[mi][nj][2 * half];
              rs += bf_hi(w) * z[mi][nj][2 * half + 1];
            }
            rs += __shfl_xor_sync(0xffffffffu, rs, 1);
            rs += __shfl_xor_sync(0xffffffffu, rs, 2);
            if (q == 0) rd[warp >> 1][rl] = kb ? rs : sc[mi][half] * rs;
          }
        }
      }
    }
  }
  __syncthreads();
  finish(nsteps - 1);
  float* out = part + ((long long)(2 * piece + kb) * B * S + row0) * N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int n = wn + 8 * nj + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t0 + wr + 16 * mi + g + 8 * half;
        if (t < qc && n < N)
          *reinterpret_cast<float2*>(out + (long long)t * N + n) =
              make_float2(acc[mi][nj][2 * half], acc[mi][nj][2 * half + 1]);
      }
    }
  }
}

// The last launch. Blocks below `eblocks` (the bf16 lane's): dC then dB,
// four elements a thread, each the sum of the pieces' parts in order
// (piece 0, the score gradient's term, first), rounded to bf16. The blocks
// past them: da_log[h], the sum over (b, chunk), in order, of the chunks'
// parts (both lanes).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_finish_kernel(const float* __restrict__ part, int pieces,
                      T* __restrict__ db, T* __restrict__ dc,
                      const float* __restrict__ dal, float* __restrict__ da,
                      int B, int S, int H, int N, int nc, int eblocks) {
  if ((int)blockIdx.x >= eblocks) {
    const int h = (blockIdx.x - eblocks) * kThreads + threadIdx.x;
    if (h >= H) return;
    float acc = 0.f;
    for (long long i = 0; i < (long long)B * nc; ++i) acc += dal[i * H + h];
    da[h] = acc;
    return;
  }
  if constexpr (!kF32<T>) {
    const long long n = (long long)B * S * N;
    const long long e = 4 * ((long long)blockIdx.x * kThreads + threadIdx.x);
    if (e >= 2 * n) return;
    const int which = e >= n;         // 0 dC, 1 dB
    const long long r = e - which * n;
    float4 v = *reinterpret_cast<const float4*>(part + which * n + r);
    for (int p = 1; p < pieces; ++p) {
      const float4 u =
          *reinterpret_cast<const float4*>(part + (2LL * p + which) * n + r);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    __nv_bfloat162 o[2] = {__floats2bfloat162_rn(v.x, v.y),
                           __floats2bfloat162_rn(v.z, v.w)};
    *reinterpret_cast<uint2*>((which ? db : dc) + r) =
        *reinterpret_cast<const uint2*>(o);
  }
}

// pieces of the bf16 lane's dB, dC launch: the score gradient's term and
// the heads' groups
__host__ __device__ __forceinline__ int dbc_pieces(int H) {
  return 1 + (H + kDbcHeads - 1) / kDbcHeads;
}

struct BwdWork {
  float *st, *rw, *cb, *cum, *dinter, *dtail, *dcb, *part, *dal;
};

// the backward's workspace, float32: the chunk states, then h_in, and r_c,
// then g (B x nc x H x P x N each), C B^T (B x nc x Qs x Qs), cum, dinter
// and dtail (B x nc x H x Qs each), the score gradient's head groups
// (kDcbGroups x B x nc x Qs x Qs), the dB, dC pieces (2 x pieces x B x S x
// N; the bf16 lane's) and the chunks' parts of da_log (B x nc x H), each
// on a 16-byte boundary but the last
BwdWork carve_bwd(void* work, int B, int S, int H, int P, int N, int Q) {
  const long long nc = (S + Q - 1) / Q, Qs = q_stride(Q);
  const long long state = (long long)B * nc * H * P * N;
  BwdWork w;
  w.st = static_cast<float*>(work);
  w.rw = w.st + state;
  w.cb = w.rw + state;
  w.cum = w.cb + B * nc * Qs * Qs;
  w.dinter = w.cum + B * nc * H * Qs;
  w.dtail = w.dinter + B * nc * H * Qs;
  w.dcb = w.dtail + B * nc * H * Qs;
  w.part = w.dcb + kDcbGroups * B * nc * Qs * Qs;
  w.dal = w.part + 2LL * dbc_pieces(H) * B * S * N;
  return w;
}

long long bwd_workspace_floats(int B, int S, int H, int P, int N, int Q) {
  const BwdWork w = carve_bwd(nullptr, B, S, H, P, N, Q);
  const long long nc = (S + Q - 1) / Q;
  return (w.dal - w.st) + B * nc * H;
}

// The backward, seven launches, every sum in a fixed order (no atomics),
// each kernel's name beginning ssd_bwd_:
// 1. ssd_bwd_chunk_kernel (bf16: its own, on bf16 mma.sync) or
//    ssd_bwd_chunk_f32_kernel (the forward's chunk kernel), with H more
//    blocks than the forward's: cum, C B^T, each chunk's state from zero
//    and r_c = sum_t exp(cum_t) dy_t^T C_t;
// 2. ssd_bwd_state_kernel, the forward's carry: each chunk's h_in
//    (recomputed, not saved: the forward's interface stays as it is);
// 3. ssd_bwd_carry_kernel: each chunk's g from dh_last, and dh0;
// 4. ssd_bwd_dcb_kernel, a block per (b, chunk, 64 x 64 tile, head
//    group): the score gradient dCB summed over the group's heads on chip
//    (dW formed again, not saved: no Q x Q array a head in device memory);
// 5. bf16: ssd_bwd_dbc_kernel, dB and dC in pieces of 20 heads, dinter
//    (y's inter-chunk term of dcum) beside dC's term over the heads and
//    dtail (the state's) beside dB's;
//    float32: ssd_bwd_main_f32_kernel, a block per (b, chunk, head): dx,
//    ddt and the chunk's part of da_log;
// 6. bf16: ssd_bwd_main_kernel, the same per (b, chunk, head); float32:
//    ssd_bwd_dbc_f32_kernel, dB and dC;
// 7. ssd_bwd_finish_kernel: the bf16 lane's pieces of dB and dC added, and
//    da_log.
template <typename T>
cudaError_t launch_bwd(const void* x, const void* bm, const void* cm,
                       const float* dt, const float* a_log, const float* h0,
                       const void* dy, const float* dh_last, void* work,
                       void* dx, void* db, void* dc, float* ddt, float* da,
                       float* dh0, int B, int S, int H, int P, int N, int Q,
                       cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  const T* dyt = static_cast<const T*>(dy);
  const int nc = (S + Q - 1) / Q;
  const int nt = (Q + kTile - 1) / kTile;
  const BwdWork w = carve_bwd(work, B, S, H, P, N, Q);
  const dim3 chunk_grid(2 * H + nt * (nt + 1) / 2, nc, B);
  cudaError_t err;
  if constexpr (kF32<T>) {
    ssd_bwd_chunk_f32_kernel<T><<<chunk_grid, kThreads, 0, stream>>>(
        xt, bt, ct, dt, a_log, w.cb, w.cum, w.st, dyt, w.rw, S, H, P, N, Q,
        nc);
  } else {
    constexpr int csmem = (int)sizeof(Chunk16Smem);
    err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               csmem);
    if (err != cudaSuccess) return err;
    ssd_bwd_chunk_kernel<<<chunk_grid, kThreads, csmem, stream>>>(
        xt, bt, ct, dt, a_log, w.cb, w.cum, w.st, dyt, w.rw, S, H, P, N, Q,
        nc);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long quads = (long long)B * H * P * N / 4;
  const unsigned carry_blocks = (unsigned)((quads + kThreads - 1) / kThreads);
  ssd_bwd_state_kernel<<<carry_blocks, kThreads, 0, stream>>>(
      w.cum, h0, w.st, B, S, H, P, N, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_carry_kernel<<<carry_blocks, kThreads, 0, stream>>>(
      w.cum, dh_last, w.rw, dh0, B, S, H, P, N, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int groups = kF32<T> ? 1 : kDcbGroups;
  constexpr int dcb_smem = kDcbStages * (int)sizeof(DcbStage<T>);
  err = cudaFuncSetAttribute(ssd_bwd_dcb_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dcb_smem);
  if (err != cudaSuccess) return err;
  ssd_bwd_dcb_kernel<T><<<dim3(groups * nt * (nt + 1) / 2, nc, B), kThreads,
                          dcb_smem, stream>>>(xt, dyt, dt, w.cum, w.dcb, B, S,
                                              H, P, Q, nc, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  int eblocks = 0, pieces = 0;
  if constexpr (kF32<T>) {
    constexpr int smem = (int)sizeof(BwdSmem);
    err = cudaFuncSetAttribute(ssd_bwd_main_f32_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    ssd_bwd_main_f32_kernel<T><<<dim3(H, nc, B), kThreads, smem, stream>>>(
        xt, bt, ct, dt, a_log, dyt, w.cb, w.cum, w.st, w.rw, w.dal,
        static_cast<T*>(dx), ddt, S, H, P, N, Q, nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ssd_bwd_dbc_f32_kernel<T><<<dim3(4 * ((Q + kBT - 1) / kBT), nc, B),
                                kThreads, 0, stream>>>(
        xt, bt, ct, dt, dyt, w.dcb, w.cum, w.st, w.rw, static_cast<T*>(db),
        static_cast<T*>(dc), S, H, P, N, Q, nc);
  } else {
    // dB and dC first: their dC blocks give main its dinter
    pieces = dbc_pieces(H);
    constexpr int dsmem = (int)sizeof(Dbc16Smem);
    err = cudaFuncSetAttribute(ssd_bwd_dbc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dsmem);
    if (err != cudaSuccess) return err;
    ssd_bwd_dbc_kernel<<<dim3(2 * ((Q + kBT - 1) / kBT) * pieces, nc, B),
                         kThreads, dsmem, stream>>>(
        xt, bt, ct, dt, dyt, w.dcb, w.cum, w.st, w.rw, w.part, w.dinter,
        w.dtail, B, S, H, P, N, Q, nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    constexpr int smem = (int)sizeof(MainSmem);
    err = cudaFuncSetAttribute(ssd_bwd_main_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    ssd_bwd_main_kernel<<<dim3(H, nc, B), kThreads, smem, stream>>>(
        xt, bt, ct, dt, a_log, dyt, w.cb, w.cum, w.st, w.rw, w.dinter,
        w.dtail, w.dal, static_cast<T*>(dx), ddt, S, H, P, N, Q, nc);
    const long long quads2 = 2LL * B * S * N / 4;
    eblocks = (int)((quads2 + kThreads - 1) / kThreads);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_finish_kernel<T><<<eblocks + (H + kThreads - 1) / kThreads,
                             kThreads, 0, stream>>>(
      w.part, pieces, static_cast<T*>(db), static_cast<T*>(dc), w.dal, da, B,
      S, H, N, nc, eblocks);
  return cudaGetLastError();
}

// the name, function, dynamic shared bytes and threads of kernel i of the
// scan with x of type T: 0 the forward's chunk kernel, then the
// backward's in launch order; false past the last
template <typename T>
bool kernel_at(int i, const char** name, const void** fn, int* smem,
               int* threads) {
  *threads = kThreads;
  *smem = 0;
  switch (i) {
    case 0:
      *name = "ssd_chunk_kernel";
      *fn = reinterpret_cast<const void*>(ssd_chunk_kernel<T>);
      return true;
    case 1:
      if constexpr (kF32<T>) {
        *name = "ssd_bwd_chunk_f32_kernel";
        *fn = reinterpret_cast<const void*>(ssd_bwd_chunk_f32_kernel<T>);
      } else {
        *name = "ssd_bwd_chunk_kernel";
        *fn = reinterpret_cast<const void*>(ssd_bwd_chunk_kernel);
        *smem = (int)sizeof(Chunk16Smem);
      }
      return true;
    case 2:
      *name = "ssd_bwd_state_kernel";
      *fn = reinterpret_cast<const void*>(ssd_bwd_state_kernel);
      return true;
    case 3:
      *name = "ssd_bwd_carry_kernel";
      *fn = reinterpret_cast<const void*>(ssd_bwd_carry_kernel);
      return true;
    case 4:
      *name = "ssd_bwd_dcb_kernel";
      *fn = reinterpret_cast<const void*>(ssd_bwd_dcb_kernel<T>);
      *smem = kDcbStages * (int)sizeof(DcbStage<T>);
      return true;
    case 5:
      if constexpr (kF32<T>) {
        *name = "ssd_bwd_main_f32_kernel";
        *fn = reinterpret_cast<const void*>(ssd_bwd_main_f32_kernel<T>);
        *smem = (int)sizeof(BwdSmem);
      } else {
        *name = "ssd_bwd_dbc_kernel";
        *fn = reinterpret_cast<const void*>(ssd_bwd_dbc_kernel);
        *smem = (int)sizeof(Dbc16Smem);
      }
      return true;
    case 6:
      if constexpr (kF32<T>) {
        *name = "ssd_bwd_dbc_f32_kernel";
        *fn = reinterpret_cast<const void*>(ssd_bwd_dbc_f32_kernel<T>);
      } else {
        *name = "ssd_bwd_main_kernel";
        *fn = reinterpret_cast<const void*>(ssd_bwd_main_kernel);
        *smem = (int)sizeof(MainSmem);
      }
      return true;
    case 7:
      *name = "ssd_bwd_finish_kernel";
      *fn = reinterpret_cast<const void*>(ssd_bwd_finish_kernel<T>);
      return true;
    default:
      return false;
  }
}
bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Bytes of the workspace a call needs (float32: the chunk states
// B x nc x H x P x N, C B^T B x nc x Qs x Qs and cum B x nc x H x Qs, Qs
// the chunk rounded up to 32); none for the decode step (S = 1).
long long ssd_scan_workspace_bytes(int B, int S, int H, int P, int N,
                                   int Q) {
  if (S <= 1) return 0;
  const long long nc = (S + Q - 1) / Q, Qs = q_stride(Q);
  return 4LL * B * nc * ((long long)H * P * N + Qs * Qs + (long long)H * Qs);
}

// Returns 0 or the cudaError_t of the first launch that failed. The caller
// checks shapes and types: contiguous tensors, 1 <= P <= 64,
// 1 <= N <= 128, 1 <= Q <= 256, S >= 1; for S > 1 also P and N multiples
// of 8 and x, b, c, h0 on 16-byte boundaries (the wrapper pads and copies
// to make them so); work holds ssd_scan_workspace_bytes(B, S, H, P, N, Q)
// bytes; h0 may be null.
int ssd_scan_launch(const void* x, const void* bm, const void* cm,
                    const void* dt, const void* a_log, const void* h0,
                    void* work, void* y, void* h_out, int B, int S, int H,
                    int P, int N, int Q, int bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      Q < 1 || Q > kMaxQ || H > 65535 || B > 65535 ||
      (S + Q - 1) / Q > 65535)
    return (int)cudaErrorInvalidValue;
  if (S > 1 && (P % 8 != 0 || N % 8 != 0 || !aligned16(x) ||
                !aligned16(bm) || !aligned16(cm) || !aligned16(h0) ||
                !aligned16(work) || !aligned16(h_out)))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* alf = static_cast<const float*>(a_log);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h_out);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, bm, cm, dtf, alf, h0f, work, y, hf, B,
                                   S, H, P, N, Q, s)
           : launch<float>(x, bm, cm, dtf, alf, h0f, work, y, hf, B, S, H, P,
                           N, Q, s);
  return (int)err;
}

// Bytes of the backward's workspace (carve_bwd: the chunk states and the
// state gradients, B x nc x H x P x N floats each; C B^T and the score
// gradient's two head groups, B x nc x Qs x Qs each; cum, dinter and
// dtail, B x nc x H x Qs each; the dB, dC pieces, 2 x pieces x B x S x N; the
// chunks' parts of da_log, B x nc x H).
long long ssd_scan_bwd_workspace_bytes(int B, int S, int H, int P, int N,
                                       int Q) {
  return 4 * bwd_workspace_floats(B, S, H, P, N, Q);
}

// The gradient of the scan (`ssd_scan_bwd_ref`): dy in x's type (B, S, H,
// P), dh_last (B, H, P, N) float32 or null (zero), h0 as in the forward;
// dx (x's type), db, dc (B, S, N, x's type), ddt (B, S, H) float32, da
// (H) float32, dh0 (B, H, P, N) float32 or null. Returns 0 or the
// cudaError_t of the first launch that failed. The caller checks shapes
// and types: contiguous tensors, P and N multiples of 8 (<= 64, <= 128),
// 1 <= Q <= 256, S >= 1, every pointer on a 16-byte boundary, work holding
// ssd_scan_bwd_workspace_bytes(B, S, H, P, N, Q) bytes.
int ssd_scan_bwd_launch(const void* x, const void* bm, const void* cm,
                        const void* dt, const void* a_log, const void* h0,
                        const void* dy, const void* dh_last, void* work,
                        void* dx, void* db, void* dc, void* ddt, void* da,
                        void* dh0, int B, int S, int H, int P, int N, int Q,
                        int bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      Q < 1 || Q > kMaxQ || H > 65535 || B > 65535 ||
      (S + Q - 1) / Q > 65535)
    return (int)cudaErrorInvalidValue;
  if (P % 8 != 0 || N % 8 != 0 || !aligned16(x) || !aligned16(bm) ||
      !aligned16(cm) || !aligned16(h0) || !aligned16(dy) ||
      !aligned16(dh_last) || !aligned16(work) || !aligned16(dh0))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* alf = static_cast<const float*>(a_log);
  const float* h0f = static_cast<const float*>(h0);
  const float* dhf = static_cast<const float*>(dh_last);
  float* ddtf = static_cast<float*>(ddt);
  float* daf = static_cast<float*>(da);
  float* dh0f = static_cast<float*>(dh0);
  const cudaError_t err =
      bf16 ? launch_bwd<__nv_bfloat16>(x, bm, cm, dtf, alf, h0f, dy, dhf,
                                       work, dx, db, dc, ddtf, daf, dh0f, B,
                                       S, H, P, N, Q, s)
           : launch_bwd<float>(x, bm, cm, dtf, alf, h0f, dy, dhf, work, dx,
                               db, dc, ddtf, daf, dh0f, B, S, H, P, N, Q, s);
  return (int)err;
}

// Registers, shared bytes (static and a launch's dynamic), local (spilled)
// bytes and resident blocks an SM (out[0 .. 3]) of kernel i of the scan
// with bf16 (else float32) x: 0 the forward's chunk kernel, then the
// backward's in launch order. Returns its name, or null past the last or
// where the runtime refuses the query.
const char* ssd_scan_kernel_attrs(int i, int bf16, int* out) {
  const char* name;
  const void* fn;
  int smem, threads;
  if (!(bf16 ? kernel_at<__nv_bfloat16>(i, &name, &fn, &smem, &threads)
             : kernel_at<float>(i, &name, &fn, &smem, &threads)))
    return nullptr;
  cudaFuncAttributes a;
  int blocks = 0;
  if ((smem > 0 &&
       cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            smem) != cudaSuccess) ||
      cudaFuncGetAttributes(&a, fn) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                    smem) != cudaSuccess)
    return nullptr;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes + smem;
  out[2] = (int)a.localSizeBytes;
  out[3] = blocks;
  return name;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
