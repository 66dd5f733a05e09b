// CSR segment sum for Hopper (sm_90a), exported through a plain C interface
// and bound to PyTorch with ctypes (repro_torch/kernels/csr_spmv/csr_spmv.py).
//
//   y[r, j] = sum_{e in [indptr[r], indptr[r+1])} w[e] * x[src[e], j]
//   indptr (n_rows + 1,) i64, src (nnz,) i32, w (nnz,) T, x (n_cols, nv) T
//   -> y (n_rows, nv) T, with T float or double
//
// Replaces no TPU kernel: the JAX package computes this product as an XLA
// gather plus `jax.ops.segment_sum` (repro/graph/csr.py:152-161, pt_matvec
// and pt_matvec_block), and the port's plain version is `index_select` plus
// `index_add_`, whose atomics add in an order that changes from run to run
// on the card. The edge list of P^T is sorted by destination row and has an
// indptr, so one warp can own a row and no two threads ever write one
// output: no atomics.
//
// The sum order is fixed by the edge positions alone. Lane l of the row's
// warp adds the edges e = start + l, start + l + 32, ... in ascending
// order, each with one fused multiply-add from +0, and the 32 partial sums
// meet in a butterfly of round-to-nearest adds (the same tree on every
// lane, and every add commutative, so every lane holds the same bits).
// Columns are independent: column j's arithmetic is the same whatever nv
// is and whichever pass of columns it falls in, so lane j of an nv-wide
// call equals the 1-wide call on lane j bit for bit, and every run gives
// the same bits. The explicit __fma_rn / __dadd_rn calls keep nvcc from
// contracting or reordering any of it.
//
// What bounds it: device-memory bytes. Each edge moves its source index and
// weight (8 bytes in f32, 12 in f64) and gathers nv values of x for one
// FMA each, so it does at most 1 FLOP per 4 bytes against the H100's ridge
// of 20. The design is the simple one: 8 warps a block, a warp a row, the
// columns in passes of 8, 4, 2 and 1. A row's walk is a chain of dependent
// loads (indices, then the gathers), so each lane loads the indices and
// weights of a batch of edges before the batch's gathers: 16 edges at one
// column, then 4, then 1 for the tail, keeping up to 16 gathers in flight
// per lane without changing the order of the adds (a first design with 4
// took 0.82 ms at Stanford-Web, 0.75 ms of it the hub row alone).
// Rows of the Stanford-Web replica hold 8 edges on average, so most of a
// warp idles; and the longest row (hub page 193939, 79,727 in-links) is
// one warp's serial walk of 2,492 steps. Both are work for a later design
// (split long rows over a block, pack short rows several to a warp) that
// keeps the fixed order.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// Adds a lane's edges e, e + 32, ... to acc (NC columns from col0) in
// batches of U while a whole batch fits before `end`: the batch's indices
// and weights first, then its gathers, then its FMAs in ascending edge
// order. Returns the first edge it did not add.
template <typename T, int NC, int U>
__device__ __forceinline__ long long walk(long long e, long long end,
                                          const int* __restrict__ src,
                                          const T* __restrict__ w,
                                          const T* __restrict__ x, int nv,
                                          int col0, T (&acc)[NC]) {
  for (; e + 32 * (U - 1) < end; e += 32 * U) {
    int s[U];
    T ww[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] = __ldg(src + e + 32 * u);
      ww[u] = __ldg(w + e + 32 * u);
    }
    T xv[U][NC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T* xr = x + (long long)s[u] * nv + col0;
#pragma unroll
      for (int j = 0; j < NC; ++j) xv[u][j] = __ldg(xr + j);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[j] = fma_rn(ww[u], xv[u][j], acc[j]);
    }
  }
  return e;
}

// One warp's pass over row `row` for NC columns from col0. Up to 16 gathers
// a lane are in flight (16 edges at one column, 4 at four or eight), then
// 4 edges, then 1 on the row's tail; the order of the adds is the same
// whatever the batches, so it does not depend on NC.
template <typename T, int NC>
__device__ __forceinline__ void row_pass(long long start, long long end,
                                         int lane,
                                         const int* __restrict__ src,
                                         const T* __restrict__ w,
                                         const T* __restrict__ x,
                                         T* __restrict__ yr, int nv,
                                         int col0) {
  constexpr int kDeep = 16 / NC > 4 ? 16 / NC : 4;
  T acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = T(0);
  long long e = start + lane;
  e = walk<T, NC, kDeep>(e, end, src, w, x, nv, col0, acc);
  if (kDeep > 4) e = walk<T, NC, 4>(e, end, src, w, x, nv, col0, acc);
  walk<T, NC, 1>(e, end, src, w, x, nv, col0, acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < NC; ++j)
      acc[j] = add_rn(acc[j], __shfl_xor_sync(0xffffffffu, acc[j], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NC; ++j) yr[col0 + j] = acc[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const long long* __restrict__ indptr,
                const int* __restrict__ src, const T* __restrict__ w,
                const T* __restrict__ x, T* __restrict__ y, long long n_rows,
                int nv) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const long long start = indptr[row], end = indptr[row + 1];
  T* yr = y + row * nv;
  // passes of 8, then 4, 2 and 1 columns (warp-uniform branches)
  int col0 = 0;
  for (; nv - col0 >= 8; col0 += 8)
    row_pass<T, 8>(start, end, lane, src, w, x, yr, nv, col0);
  if (nv - col0 >= 4) {
    row_pass<T, 4>(start, end, lane, src, w, x, yr, nv, col0);
    col0 += 4;
  }
  if (nv - col0 >= 2) {
    row_pass<T, 2>(start, end, lane, src, w, x, yr, nv, col0);
    col0 += 2;
  }
  if (nv - col0 >= 1) row_pass<T, 1>(start, end, lane, src, w, x, yr, nv, col0);
}

template <typename T>
int launch(const void* indptr, const void* src, const void* w, const void* x,
           void* y, long long n_rows, int nv, cudaStream_t stream) {
  const long long grid = (n_rows + kWarps - 1) / kWarps;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  csr_spmv_kernel<T><<<(unsigned)grid, kThreads, 0, stream>>>(
      static_cast<const long long*>(indptr), static_cast<const int*>(src),
      static_cast<const T*>(w), static_cast<const T*>(x), static_cast<T*>(y),
      n_rows, nv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// caller checks shapes, types, devices and contiguity, and guarantees that
// indptr ascends from 0 to nnz and that 0 <= src < n_cols.
int csr_spmv_launch(const void* indptr, const void* src, const void* w,
                    const void* x, void* y, long long n_rows, int nv,
                    int dbl, void* stream) {
  if (n_rows <= 0 || nv <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dbl ? launch<double>(indptr, src, w, x, y, n_rows, nv, s)
             : launch<float>(indptr, src, w, x, y, n_rows, nv, s);
}

const char* csr_spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
