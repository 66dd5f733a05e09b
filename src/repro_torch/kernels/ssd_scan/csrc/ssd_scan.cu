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
//   forward's chunk states are recomputed (its first two launches, under
//   their own names) rather than saved, so the forward's interface is as
//   it was. B and C are shared by the heads, so the Q x Q score gradient
//   is summed over the heads (ssd_bwd_dcb_kernel) before it meets them,
//   once for all heads as C B^T is in the forward. The products use the
//   forward's routes: split TF32 mma.sync with bf16 operands, fmaf chains
//   in k order with float32 ones (tile_prod). da_log is summed a term at
//   a time, each with a small weight where the term is not small (see
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

// the backward's first launch: the same blocks and H more (see
// chunk_block), under its own name so that a profile tells it apart
template <typename T>
__global__ void __launch_bounds__(kThreads, kChunkBlocks<T>)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ bm,
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

// grid (H, nc, B), 256 threads: one (b, chunk, head), after the forward's
// chunk states and carry (st: each chunk's h_in) and the state gradient's
// carry (rw: each chunk's g, the gradient of its h_out). Writes dx and ddt
// of its steps, its dCB_h = dW exp(cum_t - cum_s) dt_s (s <= t) into
// dcbh, and its sum over its steps of d(dt A) dt into dal.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_main_kernel(const T* __restrict__ x, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ dt,
               const float* __restrict__ a_log, const T* __restrict__ dy,
               const float* __restrict__ cb, const float* __restrict__ cumw,
               const float* __restrict__ st, const float* __restrict__ rw,
               float* __restrict__ dcbh, float* __restrict__ dal,
               T* __restrict__ dx, float* __restrict__ ddt, int S, int H,
               int P, int N, int Q, int nc) {
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
  float* dcb = dcbh + bch * Qs * Qs;
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
            dcb[(long long)t * Qs + s] = d * ld;
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

// dCB[b][chunk][t][s] = sum_h dCB_h, heads in order, for s <= t < qc; 0
// elsewhere. Elementwise over B x nc x Qs x Qs.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dcb_kernel(const float* __restrict__ dcbh, float* __restrict__ dcb,
                   int B, int S, int H, int Q, int nc) {
  const long long QQ = (long long)q_stride(Q) * q_stride(Q);
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)B * nc * QQ) return;
  const long long bc = e / QQ, r = e % QQ;
  const int Qs = q_stride(Q), t = (int)(r / Qs), s = (int)(r % Qs);
  const int ci = (int)(bc % nc), qc = min(Q, S - ci * Q);
  float acc = 0.f;
  if (s <= t && t < qc)
    for (int h = 0; h < H; ++h) acc += dcbh[(bc * H + h) * QQ + r];
  dcb[e] = acc;
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

// grid (4 x row tiles, nc, B): block x = 4 tile + 2 half + which, which 0
// dC, 1 dB, columns n of the half 64 at a time
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dbc_kernel(const T* __restrict__ x, const T* __restrict__ bm,
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

// da_log[h] = the sum over (b, chunk), in order, of the chunks' parts
__global__ void ssd_bwd_dalog_kernel(const float* __restrict__ dal,
                                 float* __restrict__ da, int B, int H,
                                 int nc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float acc = 0.f;
  for (long long i = 0; i < (long long)B * nc; ++i) acc += dal[i * H + h];
  da[h] = acc;
}

struct BwdWork {
  float *st, *rw, *cb, *cum, *dcbh, *dcb, *dal;
};

BwdWork carve_bwd(void* work, int B, int S, int H, int P, int N, int Q) {
  const long long nc = (S + Q - 1) / Q, Qs = q_stride(Q);
  const long long state = (long long)B * nc * H * P * N;
  BwdWork w;
  w.st = static_cast<float*>(work);
  w.rw = w.st + state;
  w.cb = w.rw + state;
  w.cum = w.cb + B * nc * Qs * Qs;
  w.dcbh = w.cum + B * nc * H * Qs;
  w.dcb = w.dcbh + B * nc * H * Qs * Qs;
  w.dal = w.dcb + B * nc * Qs * Qs;
  return w;
}

long long bwd_workspace_floats(int B, int S, int H, int P, int N, int Q) {
  const long long nc = (S + Q - 1) / Q, Qs = q_stride(Q);
  return 2 * (long long)B * nc * H * P * N + 2 * B * nc * Qs * Qs +
         B * nc * H * Qs + B * nc * H * Qs * Qs + B * nc * H;
}

// The backward, seven launches, every sum in a fixed order (no atomics),
// each kernel's name beginning ssd_bwd_:
// 1. ssd_bwd_chunk_kernel, the forward's chunk kernel with H more blocks:
//    cum, C B^T, each chunk's state from zero and r_c = sum_t exp(cum_t)
//    dy_t^T C_t;
// 2. ssd_bwd_state_kernel, the forward's carry: each chunk's h_in
//    (recomputed, not saved: the forward's interface stays as it is);
// 3. ssd_bwd_carry_kernel: each chunk's g from dh_last, and dh0;
// 4. ssd_bwd_main_kernel, a block per (b, chunk, head): dx, ddt, dCB_h
//    and the chunk's part of da_log;
// 5. ssd_bwd_dcb_kernel: dCB = sum over the heads of dCB_h, so that the
//    Q x Q score gradient meets B and C once, not once a head;
// 6. ssd_bwd_dbc_kernel: dB and dC;
// 7. ssd_bwd_dalog_kernel: da_log.
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
  ssd_bwd_chunk_kernel<T><<<dim3(2 * H + nt * (nt + 1) / 2, nc, B),
                            kThreads, 0, stream>>>(
      xt, bt, ct, dt, a_log, w.cb, w.cum, w.st, dyt, w.rw, S, H, P, N, Q, nc);
  cudaError_t err = cudaGetLastError();
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
  constexpr int smem = (int)sizeof(BwdSmem);
  err = cudaFuncSetAttribute(ssd_bwd_main_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  ssd_bwd_main_kernel<T><<<dim3(H, nc, B), kThreads, smem, stream>>>(
      xt, bt, ct, dt, a_log, dyt, w.cb, w.cum, w.st, w.rw, w.dcbh, w.dal,
      static_cast<T*>(dx), ddt, S, H, P, N, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long qq = (long long)B * nc * q_stride(Q) * q_stride(Q);
  ssd_bwd_dcb_kernel<<<(unsigned)((qq + kThreads - 1) / kThreads), kThreads,
                       0, stream>>>(w.dcbh, w.dcb, B, S, H, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_dbc_kernel<T><<<dim3(4 * ((Q + kBT - 1) / kBT), nc, B), kThreads, 0,
                      stream>>>(xt, bt, ct, dt, dyt, w.dcb, w.cum, w.st, w.rw,
                                static_cast<T*>(db), static_cast<T*>(dc), S,
                                H, P, N, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_dalog_kernel<<<(H + 127) / 128, 128, 0, stream>>>(w.dal, da, B, H,
                                                        nc);
  return cudaGetLastError();
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

// Bytes of the backward's workspace (float32): the forward's chunk states
// and the state gradients B x nc x H x P x N each, C B^T and dCB
// B x nc x Qs x Qs each, cum B x nc x H x Qs, a final state B x H x P x N,
// the heads' dCB_h B x nc x H x Qs x Qs and the chunks' parts of da_log
// B x nc x H.
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

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
