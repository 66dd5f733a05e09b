// CSR segment sum for Hopper (sm_90a), exported through a plain C interface
// and bound to PyTorch with ctypes (repro_torch/kernels/csr_spmv/csr_spmv.py).
//
//   y[r, j] = sum_{e in [indptr[r], indptr[r+1])} w[e] * x[src[e], j]
//   indptr (n_rows + 1,) i64, src (nnz,) i32, w (nnz,) T, x (n_cols, nv) T
//
// Three lanes of one design:
//   f32 / f64  T = float / double, summed in T, y (n_rows, nv) T written
//   hub        T = float, each product and the sum in double, and the sum
//              rounded once to float and ADDED INTO y[row_map[r], j] in
//              place (y is the block kernel's float32 output; this is
//              `y + hub.to(float32)` of kernels/bsr_spmv/ops.py with the
//              float64 sum taken in a fixed order instead of atomic order)
//
// Replaces no TPU kernel: the JAX package computes this product as an XLA
// gather plus `jax.ops.segment_sum` (repro/graph/csr.py:152-161), and its
// hub rows likewise (repro/kernels/bsr_spmv/ops.py:309-318).
// The port's plain versions are `index_select` plus `index_add_`, whose
// atomics add in an order that changes from run to run on the card.
//
// What bounds it: device-memory bytes. Each edge moves its source index and
// weight once (8 bytes in f32, 12 in f64) and gathers nv values of x for
// one FMA each: at most 1 FLOP per 4 bytes against the H100's ridge of 20.
// x itself (1.1 MB at Stanford-Web, nv = 1, float32) stays in the 50 MB L2,
// so the gathers cost L2 latency, not HBM bytes. What keeps a kernel from
// that bound is the shape of a web graph's rows: 94% of Stanford-Web's
// edges sit in rows of 1-32 in-links (8 on average), and one row holds
// 79,727. A warp a row (this kernel's first design) idles most lanes on
// the short rows and walks the long row serially on one warp.
//
// The design balances edges, not rows (the merge-based family of Merrill
// and Garland, SC 2016). Block b owns the chunk of kChunk = 2048
// consecutive edges from b * kChunk, so every block does the same work
// whatever the rows; thread t owns the chunk's kV = 8 consecutive edges
// from t * kV. A block
//   1. loads its threads' indices and weights (16-byte loads where the
//      operands allow them) and, with two warps, finds the first rows
//      starting at or after its chunk's two ends (a 32-way search of
//      indptr, four rounds at Stanford-Web); it stages the indptr of the
//      rows that touch the chunk in shared memory when they fit;
//   2. per pass of up to 4 columns: each thread gathers its 8 edges' x
//      (all loads in flight before the first FMA) and walks them in edge
//      order, one fused multiply-add each into its row's piece; a row that
//      ends inside the run is written out, the piece still open at the run's
//      end is carried;
//   3. combines the carried pieces with a segmented inclusive scan over the
//      block's 256 threads (shuffles within a warp, then the warps' totals
//      folded in warp order), which gives every row that ends in the chunk
//      its sum there;
//   4. a row that crosses the chunk's end leaves its chunk total in a
//      workspace the wrapper allocates, one slot a chunk for the row coming
//      in and one for the row going out; a second launch, one thread a
//      crossing row and column, adds them in chunk order and writes y. The
//      hub row's 79,727 edges so spread over 39 blocks.
// Empty rows are zeroed by the block whose chunk holds their position
// (the f32 and f64 lanes; the hub lane adds nothing to them).
//
// The order it fixes: the sum of row r, column j is, in this order, the
// FMA chains of r's pieces in each thread's run (edge order, from +0), the
// scan's tree over the runs of one chunk (its shape set by thread indices,
// that is by edge positions), then the chunks' totals from left to right.
// It depends on indptr, the edge positions and the constants above, never
// on nv, the pass a column falls in, the grid's schedule or the run: two
// runs give the same bits, and lane j of an nv-wide call gives the bits of
// the 1-wide call on lane j. No atomics touch data. The explicit
// __fmaf_rn / __fma_rn / __fadd_rn / __dadd_rn calls keep nvcc from
// contracting or reordering any of it.
#include <cuda_runtime.h>

#include <climits>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kV = 8;                     // consecutive edges a thread
constexpr int kChunk = kThreads * kV;     // consecutive edges a block
constexpr int kWindow = kChunk + 2;       // indptr entries staged
constexpr int kMaxCols = 4;               // columns a pass

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

// 16-byte vectors of each operand type
template <typename T> struct Vec16;
template <> struct Vec16<int> { using type = int4; };
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

// kV consecutive values from p: 16-byte loads when `vec` (p 16-byte
// aligned and all kV there), else one by one up to n, zeros past it.
template <typename T>
__device__ __forceinline__ void load_run(const T* __restrict__ p, int n,
                                         bool vec, T (&out)[kV]) {
  using V = typename Vec16<T>::type;
  constexpr int kPer = sizeof(V) / sizeof(T);
  if (vec && n == kV) {
    const V* vp = reinterpret_cast<const V*>(p);
#pragma unroll
    for (int i = 0; i < kV / kPer; ++i) {
      const V v = __ldg(vp + i);
      memcpy(&out[i * kPer], &v, sizeof(V));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kV; ++k) out[k] = k < n ? __ldg(p + k) : T(0);
  }
}

// The first i in [0, n) with a[i] >= key, or n, found by one warp: each
// round probes 32 evenly spaced entries and keeps the stretch between the
// last probe below key and the first at or above it.
__device__ long long warp_lower_bound(const long long* __restrict__ a,
                                      long long n, long long key, int lane) {
  long long lo = 0, hi = n;        // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long idx = lo + (lane + 1) * step - 1;
    const bool ge = idx >= hi || __ldg(a + idx) >= key;
    const unsigned m = __ballot_sync(0xffffffffu, ge);
    if (m == 0) return hi;         // every probe, hi - 1 among them, < key
    const int f = __ffs(m) - 1;
    const long long new_hi = lo + (f + 1) * step - 1;
    lo = f == 0 ? lo : lo + f * step;
    hi = new_hi < hi ? new_hi : hi;
  }
  const long long idx = lo + lane;
  const bool ge = idx >= hi || __ldg(a + idx) >= key;
  const unsigned m = __ballot_sync(0xffffffffu, ge);
  return m == 0 ? hi : lo + (__ffs(m) - 1);
}

// Where a row's sum goes: y[r, j] = v (f32, f64), or
// y[row_map[r], j] += float(v) in place (hub).
template <typename T, typename Acc, bool kHub>
struct Out {
  T* y;
  const int* row_map;
  int nv;
  __device__ __forceinline__ void put(long long r, int j, Acc v) const {
    if constexpr (kHub) {
      float* p = y + (long long)__ldg(row_map + r) * nv + j;
      *p = __fadd_rn(*p, __double2float_rn(v));
    } else {
      y[r * nv + j] = v;
    }
  }
};

// What a chunk's threads share.
struct Chunk {
  long long c, e0, e1;   // the chunk and its edges [e0, e1)
  long long lo_r, r_w;   // the rows that hold its edges: [lo_r, r_w)
  long long es;          // this thread's first edge
  int ne;                // this thread's edges (0..kV)
  long long r0;          // the row of edge es
  bool in_smem;          // indptr[lo_r .. r_w] staged in shared memory
  const long long* indptr;
  const long long* win;
  __device__ __forceinline__ long long ip(long long r) const {
    return in_smem ? win[r - lo_r] : __ldg(indptr + r);
  }
};

// One pass over columns col0 .. col0 + NC - 1: steps 2 and 3 of the note.
template <typename T, typename Acc, bool kHub, int NC>
__device__ __forceinline__ void column_pass(
    const Chunk& ch, const int (&s)[kV], const T (&ww)[kV],
    const T* __restrict__ x, int nv, int col0,
    const Out<T, Acc, kHub>& out, Acc* __restrict__ part_in,
    Acc* __restrict__ part_out, long long* __restrict__ cross,
    Acc (*s_wv)[kMaxCols], int* s_wf) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // every gather of the run in flight before the first FMA
  T xv[kV][NC];
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const T* xr = x + (long long)s[k] * nv + col0;
#pragma unroll
    for (int j = 0; j < NC; ++j) xv[k][j] = k < ch.ne ? __ldg(xr + j) : T(0);
  }
  Acc acc[NC], first[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = first[j] = Acc(0);
  bool deferred = false;           // the run's first row began before it
  long long d_row = 0, d_start = 0;
  long long r = ch.r0, rs = 0, re = 0;
  if (ch.ne > 0) {
    rs = ch.ip(r);
    re = ch.ip(r + 1);
  }
  // closes row r's piece at a row end inside the run
  auto close = [&]() {
    if (rs < ch.es) {              // only the run's first row: needs the
      deferred = true;             // pieces before the run (step 3)
      d_row = r;
      d_start = rs;
#pragma unroll
      for (int j = 0; j < NC; ++j) first[j] = acc[j];
    } else {
#pragma unroll
      for (int j = 0; j < NC; ++j) out.put(r, col0 + j, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] = Acc(0);
  };
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    if (k < ch.ne) {
      const long long e = ch.es + k;
      if (e >= re) {
        close();
        do {                       // the next row with edges
          ++r;
          rs = re;
          re = ch.ip(r + 1);
        } while (e >= re);
      }
#pragma unroll
      for (int j = 0; j < NC; ++j)
        acc[j] = fma_rn(Acc(ww[k]), Acc(xv[k][j]), acc[j]);
    }
  }
  const bool open = ch.ne > 0 && re > ch.es + ch.ne;
  if (ch.ne > 0 && !open) close();
  // step 3: segmented inclusive scan of the carried pieces; a flag starts
  // a segment (the carried row began in this run, or nothing is carried)
  bool f = !open || rs >= ch.es;
  Acc v[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) v[j] = acc[j];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const bool of = __shfl_up_sync(0xffffffffu, (int)f, off) != 0;
    Acc ov[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) ov[j] = __shfl_up_sync(0xffffffffu, v[j], off);
    if (lane >= off) {
      if (!f) {
#pragma unroll
        for (int j = 0; j < NC; ++j) v[j] = add_rn(ov[j], v[j]);
      }
      f = f || of;
    }
  }
  if (lane == 31) {
    s_wf[warp] = f;
#pragma unroll
    for (int j = 0; j < NC; ++j) s_wv[warp][j] = v[j];
  }
  __syncthreads();
  // the previous warps' totals, folded in warp order
  Acc pre[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) pre[j] = s_wv[0][j];
  for (int u = 1; u < warp; ++u) {
#pragma unroll
    for (int j = 0; j < NC; ++j)
      pre[j] = s_wf[u] ? s_wv[u][j] : add_rn(pre[j], s_wv[u][j]);
  }
  if (warp > 0 && !f) {
#pragma unroll
    for (int j = 0; j < NC; ++j) v[j] = add_rn(pre[j], v[j]);
  }
  // the pieces before this run: thread tid - 1's inclusive value
  Acc ex[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    ex[j] = __shfl_up_sync(0xffffffffu, v[j], 1);
    if (lane == 0) ex[j] = pre[j];
  }
  if (deferred) {
    // the row began before this run (tid > 0), or before the chunk
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const Acc tot = tid == 0 ? first[j] : add_rn(ex[j], first[j]);
      if (d_start < ch.e0)
        part_in[ch.c * nv + col0 + j] = tot;
      else
        out.put(d_row, col0 + j, tot);
    }
  }
  // the thread holding the chunk's last edge: the row crossing its end
  if (tid == (int)((ch.e1 - 1 - ch.e0) / kV)) {
    if (open) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (rs < ch.e0)
          part_in[ch.c * nv + col0 + j] = v[j];
        else
          part_out[ch.c * nv + col0 + j] = v[j];
      }
      if (col0 == 0) cross[ch.c] = rs < ch.e0 ? -1 : r;
    } else if (col0 == 0) {
      cross[ch.c] = -1;
    }
  }
  __syncthreads();                 // s_wv, s_wf are reused by the next pass
}

template <typename T, typename Acc, bool kHub, int kCols>
__global__ void __launch_bounds__(kThreads)
csr_chunk_kernel(const long long* __restrict__ indptr,
                 const int* __restrict__ src, const T* __restrict__ w,
                 const T* __restrict__ x, Out<T, Acc, kHub> out,
                 Acc* __restrict__ part_in, Acc* __restrict__ part_out,
                 long long* __restrict__ cross, long long n_rows,
                 long long nnz, int nv, int vec) {
  __shared__ long long s_win[kWindow];
  __shared__ long long s_bounds[2];
  __shared__ Acc s_wv[kWarps][kMaxCols];
  __shared__ int s_wf[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Chunk ch;
  ch.c = blockIdx.x;
  ch.e0 = ch.c * kChunk;
  ch.e1 = ch.e0 + kChunk < nnz ? ch.e0 + kChunk : nnz;
  ch.es = ch.e0 + (long long)tid * kV;
  ch.ne = ch.e1 - ch.es >= kV ? kV : (ch.e1 > ch.es ? (int)(ch.e1 - ch.es)
                                                     : 0);
  ch.indptr = indptr;
  ch.win = s_win;
  // step 1: this thread's indices and weights, then the row bounds
  int s[kV];
  T ww[kV];
  load_run(src + ch.es, ch.ne, vec != 0, s);
  load_run(w + ch.es, ch.ne, vec != 0, ww);
  if (warp < 2) {
    const long long r = warp_lower_bound(indptr, n_rows,
                                         warp == 0 ? ch.e0 : ch.e1, lane);
    if (lane == 0) s_bounds[warp] = r;
  }
  __syncthreads();
  const long long r_a = s_bounds[0];  // the first row starting in the chunk
  ch.r_w = s_bounds[1];               // the first row starting past it
  ch.lo_r = r_a > 0 ? r_a - 1 : 0;
  const long long n_win = ch.r_w + 1 - ch.lo_r;
  ch.in_smem = n_win <= kWindow;
  if (ch.in_smem) {
    for (long long i = tid; i < n_win; i += kThreads)
      s_win[i] = __ldg(indptr + ch.lo_r + i);
  }
  if constexpr (!kHub) {
    // empty rows whose position lies in this chunk (the last chunk: all
    // rows from its start on)
    const long long r_z = ch.c == gridDim.x - 1 ? n_rows : ch.r_w;
    for (long long r = r_a + tid; r < r_z; r += kThreads) {
      if (__ldg(indptr + r) == __ldg(indptr + r + 1)) {
        for (int j = 0; j < nv; ++j) out.y[r * nv + j] = T(0);
      }
    }
  }
  __syncthreads();
  if (ch.e1 <= ch.e0) return;         // no edges (nnz = 0)
  // the row of this thread's first edge: the last row in [lo_r, r_w)
  // starting at or before es
  ch.r0 = ch.lo_r;
  if (ch.ne > 0) {
    long long lo = ch.lo_r, hi = ch.r_w - 1;
    while (lo < hi) {
      const long long mid = (lo + hi + 1) >> 1;
      if (ch.ip(mid) <= ch.es)
        lo = mid;
      else
        hi = mid - 1;
    }
    ch.r0 = lo;
  }
  // passes of kCols columns, then of 2 and 1 (block-uniform); kCols is
  // the widest pass nv allows, so a narrow call holds no wide pass's
  // registers
  int col0 = 0;
  for (; nv - col0 >= kCols; col0 += kCols)
    column_pass<T, Acc, kHub, kCols>(ch, s, ww, x, nv, col0, out, part_in,
                                     part_out, cross, s_wv, s_wf);
  if constexpr (kCols > 2) {
    if (nv - col0 >= 2) {
      column_pass<T, Acc, kHub, 2>(ch, s, ww, x, nv, col0, out, part_in,
                                   part_out, cross, s_wv, s_wf);
      col0 += 2;
    }
  }
  if constexpr (kCols > 1) {
    if (nv - col0 >= 1)
      column_pass<T, Acc, kHub, 1>(ch, s, ww, x, nv, col0, out, part_in,
                                   part_out, cross, s_wv, s_wf);
  }
}

// Step 4: every row crossing a chunk's end, one thread a (row, column): the
// chunk totals from left to right.
template <typename T, typename Acc, bool kHub>
__global__ void __launch_bounds__(kThreads)
csr_combine_kernel(const long long* __restrict__ indptr,
                   Out<T, Acc, kHub> out, const Acc* __restrict__ part_in,
                   const Acc* __restrict__ part_out,
                   const long long* __restrict__ cross, long long n_chunks,
                   int nv) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (n_chunks - 1) * nv) return;
  const long long c = i / nv;
  const int j = (int)(i % nv);
  const long long r = cross[c];
  if (r < 0) return;
  const long long c_end = (__ldg(indptr + r + 1) - 1) / kChunk;
  Acc v = part_out[c * nv + j];
  for (long long cc = c + 1; cc <= c_end; ++cc)
    v = add_rn(v, part_in[cc * nv + j]);
  out.put(r, j, v);
}

long long chunks_of(long long nnz) {
  return nnz > 0 ? (nnz + kChunk - 1) / kChunk : 1;
}

long long workspace_bytes(long long nnz, int nv, int acc_bytes) {
  return chunks_of(nnz) * (8 + 2LL * nv * acc_bytes);
}

template <typename T, typename Acc, bool kHub>
int launch(const void* indptr, const void* src, const void* w, const void* x,
           void* y, const void* row_map, void* work, long long work_bytes,
           long long n_rows, long long nnz, int nv, int vec,
           cudaStream_t stream) {
  const long long n_chunks = chunks_of(nnz);
  if (n_chunks > INT_MAX ||
      work_bytes < workspace_bytes(nnz, nv, (int)sizeof(Acc)))
    return (int)cudaErrorInvalidValue;
  // workspace: the crossing rows (i64), then the pieces in and out
  long long* cross = static_cast<long long*>(work);
  Acc* part_in = reinterpret_cast<Acc*>(cross + n_chunks);
  Acc* part_out = part_in + n_chunks * nv;
  Out<T, Acc, kHub> out{static_cast<T*>(y), static_cast<const int*>(row_map),
                        nv};
  const long long* ip = static_cast<const long long*>(indptr);
  auto chunk_kernel = nv >= kMaxCols ? csr_chunk_kernel<T, Acc, kHub, 4>
                      : nv >= 2      ? csr_chunk_kernel<T, Acc, kHub, 2>
                                     : csr_chunk_kernel<T, Acc, kHub, 1>;
  chunk_kernel<<<(unsigned)n_chunks, kThreads, 0, stream>>>(
      ip, static_cast<const int*>(src), static_cast<const T*>(w),
      static_cast<const T*>(x), out, part_in, part_out, cross, n_rows, nnz,
      nv, vec);
  int err = (int)cudaGetLastError();
  if (err != 0 || n_chunks == 1) return err;
  const long long threads = (n_chunks - 1) * nv;
  const long long grid = (threads + kThreads - 1) / kThreads;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  csr_combine_kernel<T, Acc, kHub><<<(unsigned)grid, kThreads, 0, stream>>>(
      ip, out, part_in, part_out, cross, n_chunks, nv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the workspace a launch of `lane` needs for nnz edges and nv
// columns: per chunk of kChunk edges (at least one), the row crossing its
// end (int64) and two partial sums a column (the row coming in, the row
// going out) in the lane's accumulator type. -1 for a bad argument.
long long csr_spmv_workspace_bytes(long long nnz, int nv, int lane) {
  if (nnz < 0 || nv <= 0 || lane < 0 || lane > 2) return -1;
  return workspace_bytes(nnz, nv, lane == 0 ? 4 : 8);
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched). lane
// 0 = f32, 1 = f64, 2 = hub (float32 operands, float64 sum added into
// y[row_map[r]]). `work` holds at least csr_spmv_workspace_bytes(nnz, nv,
// lane) bytes; `vec` says src and w are 16-byte aligned. The caller checks shapes, types, devices and
// contiguity, and guarantees that indptr ascends from 0 to nnz, that
// 0 <= src < x's rows and that row_map holds valid rows of y.
int csr_spmv_launch(const void* indptr, const void* src, const void* w,
                    const void* x, void* y, const void* row_map, void* work,
                    long long work_bytes, long long n_rows, long long nnz,
                    int nv, int lane, int vec, void* stream) {
  if (n_rows <= 0 || nv <= 0 || nnz < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lane) {
    case 0:
      return launch<float, float, false>(indptr, src, w, x, y, row_map, work,
                                         work_bytes, n_rows, nnz, nv, vec, s);
    case 1:
      return launch<double, double, false>(indptr, src, w, x, y, row_map,
                                           work, work_bytes, n_rows, nnz, nv,
                                           vec, s);
    case 2:
      if (row_map == nullptr) return (int)cudaErrorInvalidValue;
      return launch<float, double, true>(indptr, src, w, x, y, row_map, work,
                                         work_bytes, n_rows, nnz, nv, vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* csr_spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
