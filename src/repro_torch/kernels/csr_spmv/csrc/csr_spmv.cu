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
// The hub lane (csr_hub_kernel) is the same design in one launch, sized
// to the hub side: ~160,000 in-links at Stanford-Web, under one wave in
// blocks of 2,048 edges, which left each block's chain of dependent loads
// and a second launch as the whole time. Its blocks own 512 edges (128
// threads of 4), so some 310 run at once; step 1 probes indptr at 128
// points in one round of loads (the first pass's x gathers in flight with
// it) and stages the chunk's rows' indptr and row_map; step 4 runs in the
// same launch: each chunk a crossing row touches counts itself in that
// row's count (at the row's first chunk), the chunk that completes the
// count adds the row's pieces in chunk order (32 contiguous ranges, each
// left to right, then the ranges left to right), puts the count back to 0
// and adds the sum into y. The counts live in a workspace the wrapper
// keeps for each device and stream, zero between calls: no memset.
//
// The order it fixes: the sum of row r, column j is, in this order, the
// FMA chains of r's pieces in each thread's run (edge order, from +0), the
// scan's tree over the runs of one chunk (its shape set by thread indices,
// that is by edge positions), then the chunks' totals from left to right
// (the hub lane: in its ranges). It depends on indptr, the edge positions
// and the constants above, never on nv, the pass a column falls in, the
// grid's schedule or the run: two runs give the same bits, and lane j of
// an nv-wide call gives the bits of the 1-wide call on lane j. No atomics
// touch data. The explicit
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
// the hub lane: a block 512 edges, a thread 4, so that the hub rows'
// ~160,000 in-links at Stanford-Web spread over ~310 blocks
constexpr int kHubThreads = 128;
constexpr int kHubWarps = kHubThreads / 32;
constexpr int kHubV = 4;
constexpr int kHubChunk = kHubThreads * kHubV;
// the rows of a block's window: its chunk's, two more, and two stretches
// of the probe (up to 8,192 rows of indptr: up to 64 rows a stretch)
constexpr int kHubWindow = kHubChunk + 2 + 2 * 64;

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

// NV consecutive values from p: 16-byte loads when `vec` (p 16-byte
// aligned and all NV there), else one by one up to n, zeros past it.
template <typename T, int NV = kV>
__device__ __forceinline__ void load_run(const T* __restrict__ p, int n,
                                         bool vec, T (&out)[NV]) {
  using V = typename Vec16<T>::type;
  constexpr int kPer = sizeof(V) / sizeof(T);
  if (vec && n == NV) {
    const V* vp = reinterpret_cast<const V*>(p);
#pragma unroll
    for (int i = 0; i < NV / kPer; ++i) {
      const V v = __ldg(vp + i);
      memcpy(&out[i * kPer], &v, sizeof(V));
    }
  } else {
#pragma unroll
    for (int k = 0; k < NV; ++k) out[k] = k < n ? __ldg(p + k) : T(0);
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
// y[row_map[r], j] += float(v) in place (hub; row_map[r] from `win`, the
// map of rows [lo, lo + n) staged in shared memory, where r lies there).
template <typename T, typename Acc, bool kHub>
struct Out {
  T* y;
  const int* row_map;
  int nv;
  __device__ __forceinline__ void put(long long r, int j, Acc v) const {
    y[r * nv + j] = v;
  }
};

template <>
struct Out<float, double, true> {
  float* y;
  const int* row_map;
  int nv;
  const int* win;          // row_map of rows [lo, lo + n)
  long long lo, n;
  __device__ __forceinline__ float* at(long long r, int j) const {
    const long long m = r - lo >= 0 && r - lo < n ? win[r - lo]
                                                  : __ldg(row_map + r);
    return y + m * nv + j;
  }
  __device__ __forceinline__ void put(long long r, int j, double v) const {
    float* p = at(r, j);
    *p = __fadd_rn(*p, __double2float_rn(v));
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

// The gathers of a pass: x's rows of a thread's NV edges, columns col0 ..
// col0 + NC - 1, all in flight before the first is used.
template <typename T, int NC, int NV>
__device__ __forceinline__ void gather(const Chunk& ch, const int (&s)[NV],
                                       const T* __restrict__ x, int nv,
                                       int col0, T (&xv)[NV][NC]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const T* xr = x + (long long)s[k] * nv + col0;
#pragma unroll
    for (int j = 0; j < NC; ++j) xv[k][j] = k < ch.ne ? __ldg(xr + j) : T(0);
  }
}

// One pass over columns col0 .. col0 + NC - 1: steps 2 and 3 of the note,
// a thread NV edges. kPre: the pass's gathers are `xpre`, made earlier by
// the caller (the hub lane's first pass, whose gathers fly with its row
// search).
template <typename T, typename Acc, bool kHub, int NC, int NV = kV,
          bool kPre = false>
__device__ __forceinline__ void column_pass(
    const Chunk& ch, const int (&s)[NV], const T (&ww)[NV],
    const T* __restrict__ x, int nv, int col0,
    const Out<T, Acc, kHub>& out, Acc* __restrict__ part_in,
    Acc* __restrict__ part_out, long long* __restrict__ cross,
    Acc (*s_wv)[kMaxCols], int* s_wf, T (*xpre)[NC] = nullptr) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // every gather of the run in flight before the first FMA
  T xv[NV][NC];
  if constexpr (kPre) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int j = 0; j < NC; ++j) xv[k][j] = xpre[k][j];
    }
  } else {
    gather(ch, s, x, nv, col0, xv);
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
  for (int k = 0; k < NV; ++k) {
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
  if (tid == (int)((ch.e1 - 1 - ch.e0) / NV)) {
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

// The row of edge e of the chunk: the last row in [lo_r, r_w) starting at
// or before e.
__device__ __forceinline__ long long row_of(const Chunk& ch, long long e) {
  long long lo = ch.lo_r, hi = ch.r_w - 1;
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if (ch.ip(mid) <= e)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// The f32 and f64 lanes: a block the chunk of kChunk edges from
// blockIdx.x * kChunk, a thread kV of them.
template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
csr_chunk_kernel(const long long* __restrict__ indptr,
                 const int* __restrict__ src, const T* __restrict__ w,
                 const T* __restrict__ x, Out<T, T, false> out,
                 T* __restrict__ part_in, T* __restrict__ part_out,
                 long long* __restrict__ cross, long long n_rows,
                 long long nnz, int nv, int vec) {
  __shared__ long long s_win[kWindow];
  __shared__ long long s_bounds[2];
  __shared__ T s_wv[kWarps][kMaxCols];
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
  // empty rows whose position lies in this chunk (the last chunk: all
  // rows from its start on)
  const long long r_z = ch.c == gridDim.x - 1 ? n_rows : ch.r_w;
  for (long long r = r_a + tid; r < r_z; r += kThreads) {
    if (__ldg(indptr + r) == __ldg(indptr + r + 1)) {
      for (int j = 0; j < nv; ++j) out.y[r * nv + j] = T(0);
    }
  }
  __syncthreads();
  if (ch.e1 <= ch.e0) return;         // no edges (nnz = 0)
  // the row of this thread's first edge
  ch.r0 = ch.ne > 0 ? row_of(ch, ch.es) : ch.lo_r;
  // passes of kCols columns, then of 2 and 1 (block-uniform); kCols is
  // the widest pass nv allows, so a narrow call holds no wide pass's
  // registers
  int col0 = 0;
  for (; nv - col0 >= kCols; col0 += kCols)
    column_pass<T, T, false, kCols>(ch, s, ww, x, nv, col0, out, part_in,
                                    part_out, cross, s_wv, s_wf);
  if constexpr (kCols > 2) {
    if (nv - col0 >= 2) {
      column_pass<T, T, false, 2>(ch, s, ww, x, nv, col0, out, part_in,
                                  part_out, cross, s_wv, s_wf);
      col0 += 2;
    }
  }
  if constexpr (kCols > 1) {
    if (nv - col0 >= 1)
      column_pass<T, T, false, 1>(ch, s, ww, x, nv, col0, out, part_in,
                                  part_out, cross, s_wv, s_wf);
  }
}

// Step 4: every row crossing a chunk's end, one thread a (row, column): the
// chunk totals from left to right.
template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_combine_kernel(const long long* __restrict__ indptr,
                   Out<T, T, false> out, const T* __restrict__ part_in,
                   const T* __restrict__ part_out,
                   const long long* __restrict__ cross, long long n_chunks,
                   int nv) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (n_chunks - 1) * nv) return;
  const long long c = i / nv;
  const int j = (int)(i % nv);
  const long long r = cross[c];
  if (r < 0) return;
  const long long c_end = (__ldg(indptr + r + 1) - 1) / kChunk;
  T v = part_out[c * nv + j];
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

template <typename T>
int launch(const void* indptr, const void* src, const void* w, const void* x,
           void* y, void* work, long long work_bytes, long long n_rows,
           long long nnz, int nv, int vec, cudaStream_t stream) {
  const long long n_chunks = chunks_of(nnz);
  if (n_chunks > INT_MAX ||
      work_bytes < workspace_bytes(nnz, nv, (int)sizeof(T)))
    return (int)cudaErrorInvalidValue;
  // workspace: the crossing rows (i64), then the pieces in and out
  long long* cross = static_cast<long long*>(work);
  T* part_in = reinterpret_cast<T*>(cross + n_chunks);
  T* part_out = part_in + n_chunks * nv;
  Out<T, T, false> out{static_cast<T*>(y), nullptr, nv};
  const long long* ip = static_cast<const long long*>(indptr);
  auto chunk_kernel = nv >= kMaxCols ? csr_chunk_kernel<T, 4>
                      : nv >= 2      ? csr_chunk_kernel<T, 2>
                                     : csr_chunk_kernel<T, 1>;
  chunk_kernel<<<(unsigned)n_chunks, kThreads, 0, stream>>>(
      ip, static_cast<const int*>(src), static_cast<const T*>(w),
      static_cast<const T*>(x), out, part_in, part_out, cross, n_rows, nnz,
      nv, vec);
  int err = (int)cudaGetLastError();
  if (err != 0 || n_chunks == 1) return err;
  const long long threads = (n_chunks - 1) * nv;
  const long long grid = (threads + kThreads - 1) / kThreads;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  csr_combine_kernel<T><<<(unsigned)grid, kThreads, 0, stream>>>(
      ip, out, part_in, part_out, cross, n_chunks, nv);
  return (int)cudaGetLastError();
}

// *p += 1 at gpu scope, acquire and release; returns the old value
__device__ __forceinline__ int add_acq_rel(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old) : "l"(p) : "memory");
  return old;
}

// The hub lane's step 1 (p: this thread's `hub_probe`): the block's
// threads probe indptr at kHubThreads
// even steps over [0, n_rows], which puts the first row starting at or
// after each chunk end in a stretch of one step; the window from the row
// before e0's stretch to the end of e1's is staged (when it fits:
// kHubWindow entries, with the rows' row_map in s_map), and r_w found in
// it. One round of loads where the other lanes' warp search takes one a
// 32-fold narrowing. Returns the rows of s_map.
__device__ __forceinline__ long long hub_step(long long n_rows) {
  return (n_rows + kHubThreads - 1) / kHubThreads;
}

// this thread's probe: indptr at the end of its step
__device__ __forceinline__ long long hub_probe(
    const long long* __restrict__ indptr, long long n_rows) {
  return __ldg(indptr + min((threadIdx.x + 1) * hub_step(n_rows), n_rows));
}

__device__ __forceinline__ long long hub_rows(
    Chunk& ch, const long long* __restrict__ indptr,
    const int* __restrict__ row_map, long long n_rows, long long p,
    long long* s_win, int* s_map) {
  const int tid = threadIdx.x;
  const long long step = hub_step(n_rows);
  const int i0 = __syncthreads_count(p < ch.e0);
  const int i1 = __syncthreads_count(p < ch.e1);
  // the first row at or after e lies in [lo_of(i), hi_of(i)]: probe i is
  // the first at or past e (the last probe, indptr[n_rows] = nnz, is)
  auto lo_of = [&](int i) { return i == 0 ? 0LL : min(i * step, n_rows) + 1; };
  auto hi_of = [&](int i) { return min((i + 1) * step, n_rows); };
  const long long base = max(lo_of(i0) - 1, 0LL), top = hi_of(i1);
  const long long n_win = top + 1 - base;
  const long long n_map = min(top, n_rows - 1) + 1 - base;
  ch.lo_r = base;
  ch.in_smem = n_win <= kHubWindow;
  if (ch.in_smem) {
    for (long long i = tid; i < n_win; i += kHubThreads) {
      s_win[i] = __ldg(indptr + base + i);
      if (i < n_map) s_map[i] = __ldg(row_map + base + i);
    }
  }
  __syncthreads();
  long long lo = lo_of(i1), hi = hi_of(i1);
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (ch.ip(mid) >= ch.e1)
      hi = mid;
    else
      lo = mid + 1;
  }
  ch.r_w = lo;
  return ch.in_smem ? n_map : 0;
}

// The hub lane: one launch sized to the hub side, a block the chunk of
// kHubChunk edges from blockIdx.x * kHubChunk, a thread kHubV of them;
// steps 1-3 as the other lanes (the rows ending in the chunk added into
// y[row_map] by the block), then step 4 inside the launch: each chunk a
// row crossing a chunk's end touches counts itself in that row's count
// (count[c0], c0 its first chunk; the workspace holds them at zero
// between calls), and the chunk whose count completes the row adds its
// pieces in chunk order, sets the count back to zero and adds the sum
// into y. The pieces: 32 contiguous ranges of ceil(n / 32) (a lane each,
// a warp a column), each from its first piece left to right, then the
// ranges left to right; every piece and y requested before the first add.
template <int kCols>
__global__ void __launch_bounds__(kHubThreads)
csr_hub_kernel(const long long* __restrict__ indptr,
               const int* __restrict__ src, const float* __restrict__ w,
               const float* __restrict__ x, Out<float, double, true> out,
               double* __restrict__ part_in, double* __restrict__ part_out,
               long long* __restrict__ cross, int* __restrict__ count,
               long long n_rows, long long nnz, int nv, int vec) {
  __shared__ long long s_win[kHubWindow];
  __shared__ int s_map[kHubWindow];
  __shared__ double s_wv[kHubWarps][kMaxCols];
  __shared__ int s_wf[kHubWarps];
  __shared__ long long s_rows[2];    // crossing rows this block completes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Chunk ch;
  ch.c = blockIdx.x;
  ch.e0 = ch.c * kHubChunk;
  ch.e1 = ch.e0 + kHubChunk < nnz ? ch.e0 + kHubChunk : nnz;
  ch.es = ch.e0 + (long long)tid * kHubV;
  ch.ne = ch.e1 - ch.es >= kHubV ? kHubV
          : (ch.e1 > ch.es ? (int)(ch.e1 - ch.es) : 0);
  ch.indptr = indptr;
  ch.win = s_win;
  int s[kHubV];
  float ww[kHubV];
  load_run(src + ch.es, ch.ne, vec != 0, s);
  load_run(w + ch.es, ch.ne, vec != 0, ww);
  // the probe, then the first pass's gathers, in flight while the rows
  // are found
  const long long probe = hub_probe(indptr, n_rows);
  float xv[kHubV][kCols];
  gather(ch, s, x, nv, 0, xv);
  out.win = s_map;
  out.n = hub_rows(ch, indptr, out.row_map, n_rows, probe, s_win, s_map);
  out.lo = ch.lo_r;
  if (ch.e1 <= ch.e0) return;         // no edges (nnz = 0)
  ch.r0 = ch.ne > 0 ? row_of(ch, ch.es) : ch.lo_r;
  column_pass<float, double, true, kCols, kHubV, true>(
      ch, s, ww, x, nv, 0, out, part_in, part_out, cross, s_wv, s_wf, xv);
  int col0 = kCols;
  for (; nv - col0 >= kCols; col0 += kCols)
    column_pass<float, double, true, kCols, kHubV>(
        ch, s, ww, x, nv, col0, out, part_in, part_out, cross, s_wv, s_wf);
  if constexpr (kCols > 2) {
    if (nv - col0 >= 2) {
      column_pass<float, double, true, 2, kHubV>(
          ch, s, ww, x, nv, col0, out, part_in, part_out, cross, s_wv, s_wf);
      col0 += 2;
    }
  }
  if constexpr (kCols > 1) {
    if (nv - col0 >= 1)
      column_pass<float, double, true, 1, kHubV>(
          ch, s, ww, x, nv, col0, out, part_in, part_out, cross, s_wv, s_wf);
  }
  // step 4: the barrier orders the block's pieces before its count, whose
  // add releases them to the gpu (and acquires the other chunks')
  __syncthreads();
  if (tid < 2) {
    // thread 0: the row coming in (it began before the chunk); thread 1:
    // the row going out (it began in the chunk and crosses its end); one
    // row where a row spans the chunk
    const long long r = tid == 0 ? (ch.ip(ch.r0) < ch.e0 ? ch.r0 : -1)
                                 : cross[ch.c];
    s_rows[tid] = -1;
    if (r >= 0) {
      const long long c0 = ch.ip(r) / kHubChunk;
      const long long c1 = (ch.ip(r + 1) - 1) / kHubChunk;
      if (add_acq_rel(count + c0) == (int)(c1 - c0)) {
        count[c0] = 0;               // every chunk of the row is in
        s_rows[tid] = r;
      }
    }
  }
  __syncthreads();
  for (int i = 0; i < 2; ++i) {
    const long long r = s_rows[i];
    if (r < 0) continue;
    const long long c0 = ch.ip(r) / kHubChunk;
    const int n = (int)((ch.ip(r + 1) - 1) / kHubChunk - c0) + 1;
    const int per = (n + 31) / 32, ranges = (n + per - 1) / per;
    for (int j = warp; j < nv; j += kHubWarps) {
      float* yp = out.at(r, j);
      const float y0 = lane == 0 ? *yp : 0.f;
      // piece q: part_out of the first chunk, part_in of the later ones
      auto piece = [&](int q) {
        return q == 0 ? __ldcg(part_out + c0 * nv + j)
                      : __ldcg(part_in + (c0 + q) * nv + j);
      };
      const int q0 = lane * per, q1 = min(n, q0 + per);
      double v = 0.0;
      for (int qb = q0; qb < q1; qb += 8) {
        double pc[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) pc[k] = qb + k < q1 ? piece(qb + k) : 0.0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (qb + k < q1) v = qb + k == q0 ? pc[k] : __dadd_rn(v, pc[k]);
        }
      }
      double t = v;
#pragma unroll
      for (int l = 1; l < 32; ++l) {
        const double o = __shfl_sync(0xffffffffu, v, l);
        if (l < ranges) t = __dadd_rn(t, o);
      }
      if (lane == 0) *yp = __fadd_rn(y0, __double2float_rn(t));
    }
  }
}

long long hub_chunks_of(long long nnz) {
  return nnz > 0 ? (nnz + kHubChunk - 1) / kHubChunk : 1;
}

// The hub lane's workspace for `chunks` chunks and nv columns: the counts
// (int32, first, so that a buffer kept between calls keeps them at its
// front), the crossing rows (i64), the pieces in and out (double).
long long hub_work_bytes(long long chunks, int nv) {
  return (4 * chunks + 7) / 8 * 8 + chunks * (8 + 16LL * nv);
}

}  // namespace

extern "C" {

// Bytes of the workspace a launch of `lane` (0 = f32, 1 = f64) needs for
// nnz edges and nv columns: per chunk of kChunk edges (at least one), the
// row crossing its end (int64) and two partial sums a column (the row
// coming in, the row going out) in the lane's type. -1 for a bad argument.
long long csr_spmv_workspace_bytes(long long nnz, int nv, int lane) {
  if (nnz < 0 || nv <= 0 || lane < 0 || lane > 1) return -1;
  return workspace_bytes(nnz, nv, lane == 0 ? 4 : 8);
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched). lane
// 0 = f32, 1 = f64. `work` holds at least csr_spmv_workspace_bytes(nnz,
// nv, lane) bytes; `vec` says src and w are 16-byte aligned. The caller
// checks shapes, types, devices and contiguity, and guarantees that
// indptr ascends from 0 to nnz and that 0 <= src < x's rows.
int csr_spmv_launch(const void* indptr, const void* src, const void* w,
                    const void* x, void* y, void* work, long long work_bytes,
                    long long n_rows, long long nnz, int nv, int lane,
                    int vec, void* stream) {
  if (n_rows <= 0 || nv <= 0 || nnz < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lane) {
    case 0:
      return launch<float>(indptr, src, w, x, y, work, work_bytes, n_rows,
                           nnz, nv, vec, s);
    case 1:
      return launch<double>(indptr, src, w, x, y, work, work_bytes, n_rows,
                            nnz, nv, vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The hub lane's chunks for nnz edges (at least one), and the bytes of a
// workspace for `chunks` chunks and nv columns (its counts at the front,
// to be zero before the first call; every call leaves them at zero).
long long csr_spmv_hub_chunks(long long nnz) {
  return nnz < 0 ? -1 : hub_chunks_of(nnz);
}

long long csr_spmv_hub_workspace_bytes(long long chunks, int nv) {
  if (chunks <= 0 || nv <= 0) return -1;
  return hub_work_bytes(chunks, nv);
}

// y[row_map[r], j] += float(the float64 sum of row r's float32 products),
// one launch on `stream`; returns cudaGetLastError(). `work` is a
// workspace laid out for work_chunks >= csr_spmv_hub_chunks(nnz) chunks
// and work_nv >= nv columns (csr_spmv_hub_workspace_bytes) whose counts
// are zero; no other launch may use it until this one ends (a buffer for
// each stream). The caller checks as for csr_spmv_launch, and that
// row_map holds distinct valid rows of y.
int csr_spmv_hub_launch(const void* indptr, const void* src, const void* w,
                        const void* x, void* y, const void* row_map,
                        void* work, long long work_chunks, int work_nv,
                        long long n_rows, long long nnz, int nv, int vec,
                        void* stream) {
  const long long chunks = hub_chunks_of(nnz);
  if (n_rows <= 0 || nv <= 0 || nnz < 0 || row_map == nullptr ||
      chunks > INT_MAX || work_chunks < chunks || work_nv < nv)
    return (int)cudaErrorInvalidValue;
  int* count = static_cast<int*>(work);
  long long* cross = reinterpret_cast<long long*>(
      static_cast<char*>(work) + (4 * work_chunks + 7) / 8 * 8);
  double* part_in = reinterpret_cast<double*>(cross + work_chunks);
  double* part_out = part_in + work_chunks * work_nv;
  Out<float, double, true> out{static_cast<float*>(y),
                               static_cast<const int*>(row_map), nv};
  auto kernel = nv >= kMaxCols ? csr_hub_kernel<4>
                : nv >= 2      ? csr_hub_kernel<2>
                               : csr_hub_kernel<1>;
  kernel<<<(unsigned)chunks, kHubThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(indptr), static_cast<const int*>(src),
      static_cast<const float*>(w), static_cast<const float*>(x), out,
      part_in, part_out, cross, count, n_rows, nnz, nv, vec);
  return (int)cudaGetLastError();
}

const char* csr_spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
