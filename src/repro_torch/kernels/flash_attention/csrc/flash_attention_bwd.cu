// Flash attention backward for Hopper (sm_90a) on the CUDA cores: dq, dk
// and dv of the function that the forward lanes compute
// (flash_attention.cu, flash_attention_wgmma.cu). Exported through a plain
// C interface and bound to PyTorch with ctypes
// (repro_torch/kernels/flash_attention/flash_attention.py,
// flash_attention_bwd), reached through the torch.autograd.Function of
// repro_torch/kernels/flash_attention/ops.py.
//
//   o = softmax(scale * q k^T) v, masked; given o and dO = dL/do:
//   P     = softmax_j(scale * q_i . k_j)          (the forward's weights)
//   dP    = dO v^T
//   Delta = rowsum(dO o)                           (= rowsum(P dP))
//   dS    = P (dP - Delta)
//   dq = scale dS k,   dk = scale dS^T q,   dv = P^T dO
//
//   q (B, H, S, Dk), k (B, Hkv, T, Dk), v (B, Hkv, T, Dv), o and dO
//   (B, H, S, Dv), float or bf16, contiguous; dq, dk, dv in the inputs'
//   type and layout. G = H / Hkv query heads read kv head h / G in place,
//   so dk and dv of kv head g sum over its G query heads.
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
// Design: simple and right first, deterministic (no atomics: every output
// element is written by one thread, summed in a fixed order, so two runs
// agree bit for bit), all arithmetic in f32 FMAs on the CUDA cores.
//
// * Launch 1, one block per (b, h, q tile of kB rows). A first pass over
//   the kv tiles the rows see rebuilds each row's max and log-sum-exp
//   (each thread keeps its own running max and sum over its columns; the
//   16 threads of a row combine them once at the end). The block also
//   forms Delta from o and dO. A second pass recomputes P, forms dP and
//   dS and accumulates dq in registers. The block writes each row's
//   log-sum-exp and Delta to a workspace for launch 2.
// * Launch 2, one block per (b, kv head g, kv tile of kB keys), k and v of
//   the tile held in shared memory. It loops over the group's G heads and
//   over the q tiles that see the tile, recomputes P^T and dP^T with the
//   workspace's log-sum-exp and Delta, and accumulates dk and dv in
//   registers.
// * Tiles: kB = 64 rows and keys at padded head dims up to 128, 32 above
//   (DKP, DVP in {64, 128, 192, 256}, zero-padded). Every tile is float32
//   in shared memory with rows 16 bytes longer than their data (the float4
//   reads of 8 neighbouring rows fall in distinct banks), filled by
//   element loads that widen bf16 to f32. Thread (ty, tx), ty = tid / 16
//   and tx = tid % 16, owns rows ty + 16 i and, in a score tile, columns
//   tx + 16 j; in an output tile the columns 4 tx + 64 c + e.
// * Blocks run longest first: launch 1 from the last q tile (causal rows
//   see the most keys), launch 2 from the first kv tile.
//
// What bounds it: operations. The gradient's own work is 4 (Dk + Dv) flops
// a (query, key) pair (dP, dS k, dS^T q and P^T dO); this design also
// recomputes q k^T twice and dO v^T once, 2 (5 Dk + 3 Dv) flops a pair
// in all, on the CUDA cores (67 TFLOP/s). bf16 at head dims (64, 64) and
// (128, 128) takes the tensor-core lane instead
// (flash_attention_bwd_wgmma.cu, with the forward's log-sum-exp); this
// kernel is the lane of float32 and of bf16 at other head dims.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Rows of a q tile and keys of a kv tile: 64 while both padded head dims
// are <= 128, else 32 (four float32 tiles of 64 x 260 would overflow
// shared memory).
template <int DKP, int DVP>
struct BwdTile {
  static constexpr int kB = DKP > 128 || DVP > 128 ? 32 : 64;
  static constexpr int kNR = kB / 16;     // rows (and score columns) a thread
  static constexpr int kLDK = DKP + 4;    // row strides in floats
  static constexpr int kLDV = DVP + 4;
  static constexpr int kLDP = kB + 4;
};

// Blocks an SM that __launch_bounds__ asks for: two at (64, 64) (256
// threads x 2 at <= 128 registers; shared memory takes two), else one.
constexpr int min_blocks(int dkp, int dvp) {
  return dkp <= 64 && dvp <= 64 ? 2 : 1;
}

template <int DKP, int DVP>
constexpr int dq_smem_bytes() {
  using Tl = BwdTile<DKP, DVP>;
  // q, k (DKP), dO, v (DVP), dS, and each row's log-sum-exp and Delta
  return (Tl::kB * (2 * Tl::kLDK + 2 * Tl::kLDV + Tl::kLDP) + 2 * Tl::kB) *
         (int)sizeof(float);
}

template <int DKP, int DVP>
constexpr int dkv_smem_bytes() {
  using Tl = BwdTile<DKP, DVP>;
  // k, q (DKP), v, dO (DVP), P^T, dS^T, and the q rows' log-sum-exp and
  // Delta
  return (Tl::kB * (2 * Tl::kLDK + 2 * Tl::kLDV + 2 * Tl::kLDP) +
          2 * Tl::kB) *
         (int)sizeof(float);
}

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

// Copy rows [row0, row0 + ROWS) of an (n, D) matrix into a float tile of
// COLS columns and row stride LD, zero outside the matrix (rows >= n,
// columns >= D).
template <int ROWS, int COLS, int LD, typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* src,
                                          int row0, int n, int D) {
  for (int idx = threadIdx.x; idx < ROWS * COLS; idx += kThreads) {
    const int r = idx / COLS, c = idx % COLS;
    tile[r * LD + c] = (row0 + r < n && c < D)
                           ? to_float(src[(long long)(row0 + r) * D + c])
                           : 0.f;
  }
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over DP columns of
// two tiles of row stride LD.
template <int NR, int DP, int LD>
__device__ __forceinline__ void dot_tile(float (&s)[NR][NR], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NR; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 av[NR], bv[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < NR; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// out[i][4 c + e] += sum_kk w[ty + 16 i][kk] * m[kk][4 tx + 64 c + e] over
// the KB rows of m: w is a score tile (row stride LDW), m a q, k or dO
// tile (row stride LDM) of 64 NC columns.
template <int NR, int NC, int KB, int LDW, int LDM>
__device__ __forceinline__ void acc_tile(float (&out)[NR][4 * NC],
                                         const float* w, const float* m,
                                         int ty, int tx) {
#pragma unroll 2
  for (int kk = 0; kk < KB; kk += 4) {
    float4 wv[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i)
      wv[i] = *reinterpret_cast<const float4*>(w + (ty + 16 * i) * LDW + kk);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* mrow = m + (kk + e) * LDM + 4 * tx;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 mv = *reinterpret_cast<const float4*>(mrow + 64 * c);
#pragma unroll
        for (int i = 0; i < NR; ++i) {
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

// Write rows ty + 16 i (< n) and columns 4 tx + 64 c + e (< D) of an
// accumulated tile, times `mult`, into rows [row0, ..) of an (n, D)
// matrix.
template <int NR, int NC, typename T>
__device__ __forceinline__ void store_tile(T* dst, const float (&acc)[NR][4 * NC],
                                           float mult, int row0, int n,
                                           int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * c + e;
        if (col < D)
          dst[(long long)row * D + col] =
              from_float<T>(acc[i][4 * c + e] * mult);
      }
  }
}

// Launch 1: dq, and each row's log-sum-exp (base 2, of the scores times
// scale * log2(e)) and Delta into `lse` and `delta` (B * H * S floats).
template <typename T, int DKP, int DVP>
__global__ void __launch_bounds__(kThreads, min_blocks(DKP, DVP))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, T* __restrict__ dq,
                    float* __restrict__ lse, float* __restrict__ delta,
                    int BH, int H, int Hkv, int S, int Tk, int Dk, int Dv,
                    float scale, bool causal, int window, int prefix) {
  using Tl = BwdTile<DKP, DVP>;
  constexpr int kB = Tl::kB, NR = Tl::kNR;
  constexpr int LDK = Tl::kLDK, LDV = Tl::kLDV, LDP = Tl::kLDP;
  constexpr int NCK = DKP / 64;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kB * LDK;
  float* dos = ks + kB * LDK;
  float* vs = dos + kB * LDV;
  float* ps = vs + kB * LDV;      // dS
  float* lse_s = ps + kB * LDP;   // the rows' log-sum-exp, then Delta
  float* delta_s = lse_s + kB;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float c2 = scale * kLog2e;

  const int nq = (S + kB - 1) / kB;
  const int t = blockIdx.x / BH, bh = blockIdx.x % BH;
  const int qt = causal ? nq - 1 - t : t;  // longest first
  const int b = bh / H, h = bh % H;
  const int g = h / (H / Hkv);
  const int q0 = qt * kB;
  const long long kvh = (long long)b * Hkv + g;
  const T* kg = k + kvh * Tk * Dk;
  const T* vg = v + kvh * Tk * Dv;
  const long long qrow0 = (long long)bh * S;  // row 0 of this head

  int n_kv = (Tk + kB - 1) / kB;
  if (causal) n_kv = min(n_kv, max(q0 + kB - 1, prefix - 1) / kB + 1);
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / kB : 0;

  load_tile<kB, DKP, LDK>(qs, q + qrow0 * Dk, q0, S, Dk);
  load_tile<kB, DVP, LDV>(dos, dout + qrow0 * Dv, q0, S, Dv);
  // Delta of each row from o and dO in global memory: the 16 threads of
  // row ty + 16 i take columns tx, tx + 16, ..
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int row = q0 + ty + 16 * i;
    float acc = 0.f;
    if (row < S) {
      const T* orow = o + (qrow0 + row) * Dv;
      const T* drow = dout + (qrow0 + row) * Dv;
      for (int c = tx; c < Dv; c += 16)
        acc = fmaf(to_float(orow[c]), to_float(drow[c]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    acc += __shfl_xor_sync(0xffffffffu, acc, 8);
    if (tx == 0) delta_s[ty + 16 * i] = acc;
  }

  // pass 1: each row's max and sum of exp2, per thread over its columns
  float m[NR], l[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int kt = kt0; kt < n_kv; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // everyone is done with the last tile
    load_tile<kB, DKP, LDK>(ks, kg, k0, Tk, Dk);
    __syncthreads();
    float s[NR][NR];
    dot_tile<NR, DKP, LDK>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        if (!visible(row, k0 + tx + 16 * j, S, Tk, causal, window, prefix))
          continue;
        const float x = s[i][j] * c2;
        if (x > m[i]) {
          l[i] = l[i] * exp2f(m[i] - x) + 1.f;
          m[i] = x;
        } else {
          l[i] += exp2f(x - m[i]);
        }
      }
    }
  }
  // combine the 16 threads of each row: lse = M + log2(sum l exp2(m - M))
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    float mm = m[i];
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 1));
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 2));
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 4));
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 8));
    float ll = l[i] * exp2f(m[i] - mm);
    ll += __shfl_xor_sync(0xffffffffu, ll, 1);
    ll += __shfl_xor_sync(0xffffffffu, ll, 2);
    ll += __shfl_xor_sync(0xffffffffu, ll, 4);
    ll += __shfl_xor_sync(0xffffffffu, ll, 8);
    // a row that sees no column (a padded row past S) keeps 0
    if (tx == 0) lse_s[ty + 16 * i] = ll > 0.f ? mm + log2f(ll) : 0.f;
  }

  // pass 2: dS and dq
  float acc[NR][4 * NCK];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NCK; ++c) acc[i][c] = 0.f;
  for (int kt = kt0; kt < n_kv; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the last tile's k and dS are read; lse_s written
    load_tile<kB, DKP, LDK>(ks, kg, k0, Tk, Dk);
    load_tile<kB, DVP, LDV>(vs, vg, k0, Tk, Dv);
    __syncthreads();
    float s[NR][NR], dp[NR][NR];
    dot_tile<NR, DKP, LDK>(s, qs, ks, ty, tx);
    dot_tile<NR, DVP, LDV>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = ty + 16 * i;
      const float lr = lse_s[r], dr = delta_s[r];
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = visible(q0 + r, col, S, Tk, causal, window, prefix)
                            ? exp2f(s[i][j] * c2 - lr)
                            : 0.f;
        ps[r * LDP + tx + 16 * j] = p * (dp[i][j] - dr);
      }
    }
    __syncthreads();
    acc_tile<NR, NCK, kB, LDP, LDK>(acc, ps, ks, ty, tx);
  }
  store_tile<NR, NCK>(dq + qrow0 * Dk, acc, scale, q0, S, Dk, ty, tx);
  // each row's log-sum-exp and Delta for launch 2
  if (tid < kB && q0 + tid < S) {
    lse[qrow0 + q0 + tid] = lse_s[tid];
    delta[qrow0 + q0 + tid] = delta_s[tid];
  }
}

// Launch 2: dk and dv of one kv tile of kv head g, summed over the G query
// heads of its group and the q tiles that see the tile.
template <typename T, int DKP, int DVP>
__global__ void __launch_bounds__(kThreads, min_blocks(DKP, DVP))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int BHkv, int H, int Hkv, int S,
                     int Tk, int Dk, int Dv, float scale, bool causal,
                     int window, int prefix) {
  using Tl = BwdTile<DKP, DVP>;
  constexpr int kB = Tl::kB, NR = Tl::kNR;
  constexpr int LDK = Tl::kLDK, LDV = Tl::kLDV, LDP = Tl::kLDP;
  constexpr int NCK = DKP / 64, NCV = DVP / 64;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* qs = ks + kB * LDK;
  float* vs = qs + kB * LDK;
  float* dos = vs + kB * LDV;
  float* pts = dos + kB * LDV;    // P^T (keys x queries)
  float* dst = pts + kB * LDP;    // dS^T
  float* lse_s = dst + kB * LDP;  // the q tile's rows' log-sum-exp
  float* delta_s = lse_s + kB;    // and Delta
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float c2 = scale * kLog2e;
  const int G = H / Hkv;

  const int kt = blockIdx.x / BHkv, bg = blockIdx.x % BHkv;  // longest first
  const int b = bg / Hkv, g = bg % Hkv;
  const int k0 = kt * kB;
  const long long kvh = (long long)b * Hkv + g;
  load_tile<kB, DKP, LDK>(ks, k + kvh * Tk * Dk, k0, Tk, Dk);
  load_tile<kB, DVP, LDV>(vs, v + kvh * Tk * Dv, k0, Tk, Dv);

  // the q tiles whose rows see a column of this tile
  const int nq = (S + kB - 1) / kB;
  const int qt0 = causal && k0 >= prefix ? k0 / kB : 0;
  int qt1 = nq;
  if (window > 0) {
    const int c_max = min(k0 + kB, Tk) - 1;
    qt1 = min(nq, (c_max + window - 1) / kB + 1);
  }

  float dka[NR][4 * NCK], dva[NR][4 * NCV];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * NCK; ++c) dka[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NCV; ++c) dva[i][c] = 0.f;
  }
  for (int hh = 0; hh < G; ++hh) {
    const long long qrow0 = ((long long)b * H + g * G + hh) * S;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // the last q tile's q, dO, P^T and dS^T are read
      load_tile<kB, DKP, LDK>(qs, q + qrow0 * Dk, q0, S, Dk);
      load_tile<kB, DVP, LDV>(dos, dout + qrow0 * Dv, q0, S, Dv);
      if (tid < kB) {
        const bool in = q0 + tid < S;
        lse_s[tid] = in ? lse[qrow0 + q0 + tid] : 0.f;
        delta_s[tid] = in ? delta[qrow0 + q0 + tid] : 0.f;
      }
      __syncthreads();
      // keys ty + 16 i of the tile against queries tx + 16 j
      float s[NR][NR], dp[NR][NR];
      dot_tile<NR, DKP, LDK>(s, ks, qs, ty, tx);
      dot_tile<NR, DVP, LDV>(dp, vs, dos, ty, tx);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const int qc = tx + 16 * j;
          const float p =
              visible(q0 + qc, k0 + r, S, Tk, causal, window, prefix)
                  ? exp2f(s[i][j] * c2 - lse_s[qc])
                  : 0.f;
          pts[r * LDP + qc] = p;
          dst[r * LDP + qc] = p * (dp[i][j] - delta_s[qc]);
        }
      }
      __syncthreads();
      acc_tile<NR, NCV, kB, LDP, LDV>(dva, pts, dos, ty, tx);
      acc_tile<NR, NCK, kB, LDP, LDK>(dka, dst, qs, ty, tx);
    }
  }
  store_tile<NR, NCK>(dk + kvh * Tk * Dk, dka, scale, k0, Tk, Dk, ty, tx);
  store_tile<NR, NCV>(dv + kvh * Tk * Dv, dva, 1.f, k0, Tk, Dv, ty, tx);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;
  int B, H, Hkv, S, Tk, Dk, Dv;
  float scale;
  bool causal;
  int window, prefix;
  cudaStream_t stream;
};

template <typename T, int DKP, int DVP>
cudaError_t launch(const Args& a) {
  constexpr int kB = BwdTile<DKP, DVP>::kB;
  auto* k1 = flash_bwd_dq_kernel<T, DKP, DVP>;
  auto* k2 = flash_bwd_dkv_kernel<T, DKP, DVP>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_smem_bytes<DKP, DVP>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_smem_bytes<DKP, DVP>());
  if (err != cudaSuccess) return err;
  const long long nq = (a.S + kB - 1) / kB, nk = (a.Tk + kB - 1) / kB;
  const long long BH = (long long)a.B * a.H, BHkv = (long long)a.B * a.Hkv;
  if (nq * BH > 0x7fffffff || nk * BHkv > 0x7fffffff)
    return cudaErrorInvalidValue;
  k1<<<(int)(nq * BH), kThreads, dq_smem_bytes<DKP, DVP>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<T*>(a.dq), a.lse, a.delta,
      (int)BH, a.H, a.Hkv, a.S, a.Tk, a.Dk, a.Dv, a.scale, a.causal,
      a.window, a.prefix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<(int)(nk * BHkv), kThreads, dkv_smem_bytes<DKP, DVP>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), (int)BHkv, a.H,
      a.Hkv, a.S, a.Tk, a.Dk, a.Dv, a.scale, a.causal, a.window, a.prefix);
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
// S <= T + window - 1; prefix >= 0 (0: none; read only when causal). The
// workspace holds 2 * B * H * S floats.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout, void* dq,
                               void* dk, void* dv, void* workspace, int B,
                               int H, int Hkv, int S, int T, int Dk, int Dv,
                               float scale, int causal, int window,
                               int prefix, int bf16, void* stream) {
  if (H <= 0 || Hkv <= 0 || H % Hkv != 0 || Dk < 1 || Dk > 256 || Dv < 1 ||
      Dv > 256 || S < 1 || T < 1 || B < 1 || window < 0 ||
      (window > 0 && S > T + window - 1) || prefix < 0)
    return (int)cudaErrorInvalidValue;
  float* lse = static_cast<float*>(workspace);
  float* delta = lse + (long long)B * H * S;
  const Args a{q,  k,  v,   o,     dout, dq, dk, dv, lse, delta,
               B,  H,  Hkv, S,     T,    Dk, Dv, scale, causal != 0,
               window, prefix, static_cast<cudaStream_t>(stream)};
  const cudaError_t err =
      bf16 ? by_dims<__nv_bfloat16>(a) : by_dims<float>(a);
  return (int)err;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
