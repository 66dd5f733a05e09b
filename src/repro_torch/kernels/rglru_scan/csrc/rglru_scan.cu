// The RG-LRU gates and linear recurrence of RecurrentGemma (Griffin) for
// Hopper (sm_90a), fused into one pass, exported through a plain C
// interface and bound to PyTorch with ctypes
// (repro_torch/kernels/rglru_scan/rglru_scan.py).
//
//   u (B, S, W) float or bf16, the causal conv's output; ga = u @ w_a and
//   gi = u @ w_i (B, S, W) float32 (the products stay cuBLAS's); b_a, b_i,
//   lam (W,) float32; h0 (B, W) float32 or null (zeros).
//   h (B, S, W) float32 with h_t = a_t h_{t-1} + b_t, where
//     r = sigmoid(ga + b_a), i = sigmoid(gi + b_i),
//     log_a = 8 r log_sigmoid(lam), a = exp(log_a),
//     b = sqrt(max(1 - exp(2 log_a), 1e-12)) (i u),
//   the JAX package's _lru_coeffs (repro/models/rglru.py:44-53), all in
//   float32.
//
// Replaces no TPU kernel: the JAX package runs the recurrence as
// jax.lax.associative_scan (rglru.py:70-75), which XLA compiles. PyTorch
// has no library form of it: a loop over S launches S kernels a layer, and
// a cumulative sum of log a overflows as a -> 0. So it gets a kernel.
//
// What bounds it: bytes. Each element reads u (2 bytes in bf16), ga and
// gi (4 each) and writes h (4): 14 bytes against some 20 flops, far below
// the card's ~20 flops a byte in float32. The design moves those 14 bytes
// once, in one launch (rglru_scan_kernel), and fills the card at B = 1:
//
// * Time is cut into chunks of 64 steps. A block owns one (b, chunk, 32
//   channels): 8 warps, a segment of 8 steps each, a lane a channel, so a
//   warp's load covers one row of 128 bytes (64 in bf16). Each thread
//   issues its 24 loads at once, then computes its steps' (a, b) once and
//   holds them in registers: 5,120 blocks at RecurrentGemma-2B's B = 1,
//   S = 4096, W = 2560, four on an SM (64 registers a thread).
// * The block folds its segments' composites (the product of a, and h
//   from a zero start) in order into the chunk's composite and publishes
//   it as one 64-bit word (a, h), which is its own flag: the caller fills
//   the words with ones, a value no composite takes. Up to 64 chunks
//   (S <= 4096) a chunk's carry-in is h0 folded through every earlier
//   chunk's composite, at most 8 words a warp. Past that the chunks form
//   groups of G = ceil(sqrt(nch)) (group_size; a kernel instantiation of
//   its own), and the last chunk of a group also folds the group's
//   composites in order and publishes the group's, before it waits on
//   anything else. A chunk's carry-in is then h0 folded through the
//   composites of the groups before the last one, then those of every
//   chunk since: fewer than 3 sqrt(nch) words (read 8 at a time, and read
//   again until set), which the 8 warps fold as contiguous ranges, the
//   ranges then folded in order. A group's composite is read only from two
//   groups on, when its fold is as a rule long done. A
//   fixed order for each chunk, so the same bits on every call, whichever
//   block finishes first (a decoupled look-back would combine in the order
//   the words happen to arrive), and the reads grow as nch^1.5 and not as
//   nch^2: at RecurrentGemma's W = 2560, 41 MB at 1 x 4096 (64 chunks,
//   one group) and 0.46 GB at 1 x 32768 (2.68 GB folding every earlier
//   chunk) against the scan's own 1.17 GB, from L2.
// * Blocks take their unit from a ticket (an atomic counter) in the order
//   they start, chunk by chunk, so a block waits only on blocks that are
//   already running or done: no deadlock, however many are resident.
// * Each segment's carry-in is the chunk's carry folded through the
//   segments before it; it runs its 8 steps from there and writes h. The
//   recurrence runs step after step from each carry, so its rounding
//   differs from the associative scan's (a log-depth tree of products) by
//   a few float32 ulps.
// * rglru_step_kernel, S = 1 (a decode step): one thread a (b, w),
//   h = a h0 + b; one launch and no workspace.
//
// The backward (rglru_scan_bwd_kernel, training) replaces no TPU kernel
// either: the JAX package differentiates _lru_coeffs and the associative
// scan with XLA's autodiff. Given dh it computes du, dga, dgi, and db_a,
// db_i, dlam (sums over B and S) and dh0, from the reverse recurrence
// g_t = dh_t + a_{t+1} g_{t+1}. Bytes bound it too: u, ga, gi, dh and the
// forward's h read, du, dga and dgi written, 28 bytes an element with bf16
// u against some 45 flops. So it is the forward's one pass run in reverse:
// the reverse step x -> a_t (x + dh_t), x the carry a_{t+1} g_{t+1}, is
// an affine map as the forward's step is, so the same composites, words
// and fold (carry_in) carry it, in the same order, the blocks taking
// chunks by ticket from the last; each thread reads h_{t-1} from the
// forward's output instead of running the forward again. Its blocks hold
// little in registers: a block owns 32 channels of a chunk, 256 threads
// (a thread a channel of a segment), and stages its tile in shared memory
// by 16-byte cp.async copies, a warp four rows of 128 bytes at once, ga
// and dh first (the chunk's composite needs only those), then u, gi and
// h_{t-1}, whose copies land while the block folds the later chunks'
// composites. Four blocks an SM (36 KB of tile each with bf16 u, 64
// registers a thread, no spills); 64-channel blocks of 512 threads, rows
// of 256 bytes, fit two an SM and ran slower at 1 x 4096 x 2560. The
// bias and lam gradients are sums over every step: each block writes its
// 64 steps' sums, and the last block of each channel tile to finish (a
// count, which adds no value) adds them in a fixed order, in the same
// launch: no atomic adds a value and the bits repeat. One launch a call: the words are all ones (a value no set word
// takes) when it starts, and it leaves them so, the last block of each
// channel tile putting the tile's words back, so the wrapper keeps them
// between calls and fills them once.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kC = 8.0f;      // Griffin's fixed gate exponent
constexpr int kCw = 32;         // channels a block: a lane each
constexpr int kG = 8;           // segments a chunk: a warp each
constexpr int kL = 8;           // steps a segment
constexpr int kThreads = kCw * kG;
constexpr int kChunk = kG * kL;
constexpr int kStepThreads = 256;
constexpr int kFold = 8;        // earlier chunks' composites a load batch
constexpr int kTicketBytes = 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// a and b of one step from its loaded inputs: the JAX package's
// _lru_coeffs
__device__ __forceinline__ void coeffs(float u, float ga, float gi, float b_a,
                                       float b_i, float log_a0, float& a,
                                       float& b) {
  const float r = sigmoid(ga + b_a);
  const float i = sigmoid(gi + b_i);
  const float log_a = kC * r * log_a0;
  a = expf(log_a);
  const float mult = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
  b = mult * (i * u);
}

// A chunk's composite, published as one 64-bit word: (h, a) = (high,
// low). The caller fills the words with ones first; a composite's a is
// >= 0, so its low half never reads 0xffffffff.
constexpr unsigned long long kUnset = ~0ull;

__device__ __forceinline__ unsigned long long pack(float a, float h) {
  return (unsigned long long)__float_as_uint(h) << 32 | __float_as_uint(a);
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// folds words i0 .. i1 - 1 of a list (addr(i): word i's address) in
// order into (ra, rh), reading 8 at a time, each again until it is set
template <typename Addr>
__device__ __forceinline__ void fold_words(int i0, int i1, bool live,
                                           Addr addr, float& ra,
                                           float& rh) {
  for (int kk0 = i0; kk0 < i1; kk0 += kFold) {
    unsigned long long v[kFold];
#pragma unroll
    for (int i = 0; i < kFold; ++i)
      v[i] = live && kk0 + i < i1 ? peek(addr(kk0 + i)) : pack(1.f, 0.f);
#pragma unroll
    for (int i = 0; i < kFold; ++i) {
      while (v[i] == kUnset) v[i] = peek(addr(kk0 + i));
      const float pa = __uint_as_float((unsigned)v[i]);
      const float ph = __uint_as_float((unsigned)(v[i] >> 32));
      rh = fmaf(pa, rh, ph);
      ra *= pa;
    }
  }
}

// The carry into segment j of chunk k, both counted in the order the
// scan runs, from each segment's composite (A, hs) (the product of its a,
// and its state from a zero start): the chunk's composite, its segments
// folded in order, published as one word at cp[k W]; for the last chunk
// of a group the group's composite too, at gp[(k / G) W], before it waits
// on any other group (only chunks two groups on read it); then hin (the
// state before the scan's first step, read by warp 0) folded through the
// composites of the groups before the last one and then those of the
// chunks since (the last group's and its own group's earlier ones): warp
// j folds a contiguous range of that list and the 8 ranges are folded in
// order, a fixed order for a given k; then through the chunk's segments
// before j. Every thread of the block calls it (it synchronises).
// kGrouped false: one group (G = nch), compiled without the groups' code.
template <bool kGrouped>
__device__ __forceinline__ float carry_in(float A, float hs, float hin,
                                          int k, int j, int c, bool live,
                                          int G, int nch,
                                          unsigned long long* cp,
                                          unsigned long long* gp,
                                          long long W) {
  __shared__ float seg_a[kG][kCw], seg_h[kG][kCw];   // the segments
  __shared__ float rng_a[kG][kCw], rng_h[kG][kCw];   // ranges of chunks
  __shared__ float carry[kCw];
  seg_a[j][c] = A;
  seg_h[j][c] = hs;
  __syncthreads();
  if (j == 0 && live) {
    float ca = 1.f, ch = 0.f;
#pragma unroll
    for (int s = 0; s < kG; ++s) {
      ch = fmaf(seg_a[s][c], ch, seg_h[s][c]);
      ca *= seg_a[s][c];
    }
    publish(cp + k * W, pack(ca, ch));
  }
  const int ngr = (nch + G - 1) / G, gk = k / G;
  float ra = 1.f, rh = 0.f;
  if (kGrouped && j == 0 && live && k == gk * G + G - 1 && gk + 2 < ngr) {
    fold_words(gk * G, k + 1, live,
               [&](int kk) { return cp + kk * W; }, ra, rh);
    publish(gp + gk * W, pack(ra, rh));
    ra = 1.f;
    rh = 0.f;
  }
  const int ng = kGrouped ? max(gk - 1, 0) : 0, c0 = ng * G;
  const int m = ng + (k - c0);
  const int per = (m + kG - 1) / kG, i1 = min(m, (j + 1) * per);
  fold_words(j * per, i1, live, [&](int i) {
    return kGrouped && i < ng ? gp + i * W : cp + (c0 + i - ng) * W;
  }, ra, rh);
  rng_a[j][c] = ra;
  rng_h[j][c] = rh;
  __syncthreads();
  if (j == 0) {
    float h = hin;
#pragma unroll
    for (int r = 0; r < kG; ++r) h = fmaf(rng_a[r][c], h, rng_h[r][c]);
    carry[c] = h;
  }
  __syncthreads();
  float h = carry[c];
  for (int s = 0; s < j; ++s) h = fmaf(seg_a[s][c], h, seg_h[s][c]);
  return h;
}

// One block a (b, chunk, 32 channels), taken by ticket in the order the
// blocks start: chunk by chunk, so every ticket of chunk k - 1 is below
// every ticket of chunk k. comp (B, nch, W): the chunks' composites; grp
// (B, ngr, W): the composites of the groups of G chunks; comp, grp and the
// ticket filled with ones by the caller (the ticket then counts from -1).
template <typename T, bool kGrouped>
__global__ void __launch_bounds__(kThreads, 4)
rglru_scan_kernel(const T* __restrict__ u, const float* __restrict__ ga,
                  const float* __restrict__ gi,
                  const float* __restrict__ b_a,
                  const float* __restrict__ b_i,
                  const float* __restrict__ lam,
                  const float* __restrict__ h0, float* __restrict__ out,
                  unsigned long long* __restrict__ comp,
                  unsigned long long* __restrict__ grp,
                  int* __restrict__ ticket, int B, int S, int W, int G) {
  __shared__ int order;
  if (threadIdx.x == 0) order = atomicAdd(ticket, 1) + 1;
  __syncthreads();
  const int tiles = (W + kCw - 1) / kCw;
  const int nch = (S + kChunk - 1) / kChunk;
  const int k = order / (tiles * B), tile = order % (tiles * B) / B,
            b = order % B;
  const int c = threadIdx.x % kCw, j = threadIdx.x / kCw;
  const int w = tile * kCw + c;
  const bool live = w < W;
  const int t0 = k * kChunk + j * kL;
  const long long base = (long long)b * S * W + w;

  float vu[kL], vga[kL], vgi[kL];
#pragma unroll
  for (int i = 0; i < kL; ++i) {
    const bool ok = live && t0 + i < S;
    const long long idx = base + (long long)(t0 + i) * W;
    vu[i] = ok ? to_f(u[idx]) : 0.f;
    vga[i] = ok ? ga[idx] : 0.f;
    vgi[i] = ok ? gi[idx] : 0.f;
  }
  const float ba = live ? b_a[w] : 0.f, bi = live ? b_i[w] : 0.f;
  const float la0 = live ? log_sigmoid(lam[w]) : 0.f;
  const float hin = j == 0 && live && h0 != nullptr
                        ? h0[(long long)b * W + w] : 0.f;
  float a[kL], bb[kL];
#pragma unroll
  for (int i = 0; i < kL; ++i) {
    if (live && t0 + i < S) {
      coeffs(vu[i], vga[i], vgi[i], ba, bi, la0, a[i], bb[i]);
    } else {
      a[i] = 1.f;           // past the end: the identity step
      bb[i] = 0.f;
    }
  }
  float A = 1.f, hs = 0.f;
#pragma unroll
  for (int i = 0; i < kL; ++i) {
    hs = fmaf(a[i], hs, bb[i]);
    A *= a[i];
  }
  const int ngr = (nch + G - 1) / G;
  float h = carry_in<kGrouped>(A, hs, hin, k, j, c, live, G, nch,
                               comp + (long long)b * nch * W + w,
                               grp + (long long)b * ngr * W + w, W);
#pragma unroll
  for (int i = 0; i < kL; ++i) {
    h = fmaf(a[i], h, bb[i]);
    if (live && t0 + i < S) out[base + (long long)(t0 + i) * W] = h;
  }
}

// S = 1: one thread a (b, w)
template <typename T>
__global__ void __launch_bounds__(kStepThreads)
rglru_step_kernel(const T* __restrict__ u, const float* __restrict__ ga,
                  const float* __restrict__ gi,
                  const float* __restrict__ b_a,
                  const float* __restrict__ b_i,
                  const float* __restrict__ lam,
                  const float* __restrict__ h0, float* __restrict__ out,
                  int B, int W) {
  const long long e = (long long)blockIdx.x * kStepThreads + threadIdx.x;
  if (e >= (long long)B * W) return;
  const int w = (int)(e % W);
  float a, bb;
  coeffs(to_f(u[e]), ga[e], gi[e], b_a[w], b_i[w], log_sigmoid(lam[w]), a,
         bb);
  out[e] = fmaf(a, h0 != nullptr ? h0[e] : 0.f, bb);
}

__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// 16 bytes from global to shared memory without the registers, zeros
// where !ok (src then only has to be a valid address)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
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

// A backward block's tile of its chunk, in shared memory: row r of each
// is step t0 + r, but hp's, which is h_{t0 + r - 1}.
template <typename T>
struct BwdTile {
  float ga[kChunk][kCw], dh[kChunk][kCw];
  float gi[kChunk][kCw], hp[kChunk][kCw];
  T u[kChunk][kCw];
};

// Rows t_first .. t_first + kChunk - 1 of a (S, W) slab (`rows`, a batch
// entry's first row), channels w0 .. w0 + kCw - 1, into dst by the
// block's threads: row -1 is `before` (null: zeros), rows past S and
// channels past W zeros. With `vec` (16-byte aligned rows, W a multiple of
// 8) 16-byte cp.async copies, a warp four rows at once (eight in bf16);
// else loads and stores, an element each.
template <typename E>
__device__ __forceinline__ void stage_tile(E (*dst)[kCw],
                                           const E* __restrict__ rows,
                                           const E* __restrict__ before,
                                           int t_first, int S, int W,
                                           int w0, bool vec) {
  auto row_at = [&](int r) -> const E* {
    const int t = t_first + r;
    return t < 0 ? before : t < S ? rows + (long long)t * W : nullptr;
  };
  if (vec) {
    constexpr int kPer = 16 / sizeof(E), kPerRow = kCw / kPer;
    for (int q = threadIdx.x; q < kChunk * kPerRow; q += kThreads) {
      const int r = q / kPerRow, col = q % kPerRow * kPer;
      const E* p = row_at(r);
      const bool ok = p != nullptr && w0 + col < W;
      cp16(&dst[r][col], ok ? p + w0 + col : rows, ok);
    }
  } else {
    for (int q = threadIdx.x; q < kChunk * kCw; q += kThreads) {
      const int r = q / kCw, col = q % kCw;
      const E* p = row_at(r);
      if (p != nullptr && w0 + col < W)
        dst[r][col] = p[w0 + col];
      else
        from_f(0.f, &dst[r][col]);
    }
  }
}

// The backward: the forward's chunks and fold run in reverse. The
// gradient g_t = dh_t + a_{t+1} g_{t+1} enters step t as the carry
// x = a_{t+1} g_{t+1} and leaves it as a_t (dh_t + x): the affine map
// x -> a_t x + a_t dh_t, the forward's form, so `carry_in` folds it with
// chunks and segments counted from the end (chunk kr = nch - 1 - k,
// segment kG - 1 - j). A block owns (b, a chunk of 64 steps, 32
// channels), the forward's shape, taken by ticket from the last chunk;
// thread (j, c) runs segment j's 8 steps of channel c. It stages the
// tile in shared memory
// by cp.async in two groups: ga and dh, all the chunk's composite needs,
// then u, gi and h_{t-1}, which arrive while the block folds the later
// chunks' composites and hold no registers meanwhile. It runs its steps
// from the last with the carry and writes du, dga and dgi. The sums of
// dga, dgi and d(log a) r over its 64 steps go to part (3, B, nch, W),
// over the steps from the last, then over the segments in order; the
// last block of a channel tile to finish (its count in `done` counts from
// -1) adds the tile's B nch rows of each in order, the threads of segment
// j a contiguous range, the 8 ranges then in order, and writes db_a, db_i
// and dlam. No atomics but the ticket and the counts. The flags (the
// ticket, the counts and the words) are all ones when a call starts, and
// the call leaves them so: the last ticket puts the ticket back, the last
// block of a tile its count and, every block of the tile having folded,
// the tile's words; so the caller keeps them between calls and fills
// them once.
template <typename T, bool kGrouped>
__global__ void __launch_bounds__(kThreads, 4)
rglru_scan_bwd_kernel(const T* __restrict__ u, const float* __restrict__ ga,
                      const float* __restrict__ gi,
                      const float* __restrict__ b_a,
                      const float* __restrict__ b_i,
                      const float* __restrict__ lam,
                      const float* __restrict__ h0,
                      const float* __restrict__ h,
                      const float* __restrict__ dh, T* __restrict__ du,
                      float* __restrict__ dga, float* __restrict__ dgi,
                      float* __restrict__ d_ba, float* __restrict__ d_bi,
                      float* __restrict__ d_lam, float* __restrict__ dh0,
                      float* __restrict__ part,
                      unsigned long long* __restrict__ comp,
                      unsigned long long* __restrict__ grp,
                      int* __restrict__ ticket, int* __restrict__ done,
                      int B, int S, int W, int G, int vec) {
  __shared__ __align__(16) BwdTile<T> tl;
  __shared__ float red[3][kG][kCw];
  __shared__ int order, last;
  const int tiles = (W + kCw - 1) / kCw;
  const int nch = (S + kChunk - 1) / kChunk;
  if (threadIdx.x == 0) {
    order = atomicAdd(ticket, 1) + 1;
    // the last ticket: every block has taken its own, so the ticket goes
    // back to -1 for the next call
    if (order == B * nch * tiles - 1) atomicExch(ticket, -1);
  }
  __syncthreads();
  const int kr = order / (tiles * B), tile = order % (tiles * B) / B,
            b = order % B;
  const int k = nch - 1 - kr;
  const int c = threadIdx.x % kCw, j = threadIdx.x / kCw;
  const int w0 = tile * kCw, w = w0 + c;
  const bool live = w < W;
  const int t0 = k * kChunk, s0 = j * kL;
  const long long rows = (long long)b * S * W;

  stage_tile(tl.ga, ga + rows, (const float*)nullptr, t0, S, W, w0, vec);
  stage_tile(tl.dh, dh + rows, (const float*)nullptr, t0, S, W, w0, vec);
  cp_commit();
  stage_tile(tl.u, u + rows, (const T*)nullptr, t0, S, W, w0, vec);
  stage_tile(tl.gi, gi + rows, (const float*)nullptr, t0, S, W, w0, vec);
  stage_tile(tl.hp, h + rows,
             h0 != nullptr ? h0 + (long long)b * W : nullptr, t0 - 1, S, W,
             w0, vec);
  cp_commit();
  const float ba = live ? b_a[w] : 0.f, bi = live ? b_i[w] : 0.f;
  const float la0 = live ? log_sigmoid(lam[w]) : 0.f;
  cp_wait<1>();
  __syncthreads();
  // a of each step (past the end: the identity step), and its gate r
  // stored over ga, which the pass reads for it
  float a[kL];
#pragma unroll
  for (int i = 0; i < kL; ++i) {
    a[i] = 1.f;
    if (live && t0 + s0 + i < S) {
      const float rr = sigmoid(tl.ga[s0 + i][c] + ba);
      tl.ga[s0 + i][c] = rr;
      a[i] = expf(kC * rr * la0);
    }
  }
  float A = 1.f, xs = 0.f;
#pragma unroll
  for (int i = kL - 1; i >= 0; --i) {
    xs = fmaf(a[i], xs, a[i] * tl.dh[s0 + i][c]);
    A *= a[i];
  }
  const int ngr = (nch + G - 1) / G;
  float x = carry_in<kGrouped>(
      A, xs, 0.f, kr, kG - 1 - j, c, live, G, nch,
      comp + (long long)b * nch * W + w, grp + (long long)b * ngr * W + w,
      W);
  cp_wait<0>();
  __syncthreads();

  float sa = 0.f, si = 0.f, sl = 0.f;
#pragma unroll
  for (int i = kL - 1; i >= 0; --i) {
    const int r = s0 + i;
    if (live && t0 + r < S) {
      const long long idx = rows + (long long)(t0 + r) * W + w;
      const float vdh = tl.dh[r][c], vu = to_f(tl.u[r][c]);
      const float g = vdh + x;
      const float rr = tl.ga[r][c];
      const float ii = sigmoid(tl.gi[r][c] + bi);
      const float a2 = expf(2.f * (kC * rr * la0));
      const float one_minus = 1.f - a2;
      const float m = sqrtf(fmaxf(one_minus, 1e-12f));
      const float dm = one_minus >= 1e-12f ? -a2 / m : 0.f;
      const float dlog_a = g * tl.hp[r][c] * a[i] + g * ii * vu * dm;
      const float vdga = dlog_a * kC * la0 * rr * (1.f - rr);
      const float vdgi = g * m * vu * ii * (1.f - ii);
      from_f(g * m * ii, du + idx);
      dga[idx] = vdga;
      dgi[idx] = vdgi;
      sa += vdga;
      si += vdgi;
      sl += dlog_a * rr;
      x = a[i] * g;
    }
  }
  if (t0 + s0 == 0 && live && dh0 != nullptr) dh0[(long long)b * W + w] = x;
  red[0][j][c] = sa;
  red[1][j][c] = si;
  red[2][j][c] = sl;
  __syncthreads();
  if (j < 3 && live) {
    float s = 0.f;
#pragma unroll
    for (int jj = 0; jj < kG; ++jj) s += red[j][jj][c];
    part[(((long long)j * B + b) * nch + k) * W + w] = s;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(done + tile, 1) + 1 == B * nch - 1;
    if (last) atomicExch(done + tile, -1);   // back for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every block of the tile has folded: its words go back to unset for
  // the next call, the chunks' (B nch rows of W) and then the groups'
  for (long long q = threadIdx.x; q < (long long)B * (nch + ngr) * kCw;
       q += kThreads) {
    const int wq = w0 + (int)(q % kCw);
    if (wq < W) comp[q / kCw * W + wq] = kUnset;
  }
  // db_a, db_i and dlam = (the sum of d(log a) r) 8 sigmoid(-lam) over
  // part's R = B nch rows of each, read past L1
  const int R = B * nch, per = (R + kG - 1) / kG, r0 = j * per,
            r1 = min(R, r0 + per);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    float s = 0.f;
    if (live)
      for (int r = r0; r < r1; ++r)
        s += __ldcg(part + ((long long)q * R + r) * W + w);
    red[q][j][c] = s;
  }
  __syncthreads();
  if (j < 3 && live) {
    float s = 0.f;
#pragma unroll
    for (int jj = 0; jj < kG; ++jj) s += red[j][jj][c];
    if (j == 0) d_ba[w] = s;
    else if (j == 1) d_bi[w] = s;
    else d_lam[w] = s * kC * sigmoid(-lam[w]);
  }
}

// G, the chunks a group. Up to kG kFold = 64 chunks, one group: a chunk's
// carry-in folds every earlier chunk, at most 8 words a warp, one batch of
// loads (and no chunk does a group's fold). Past that ceil(sqrt(nch)), so
// that a chunk's carry-in folds fewer than 3 sqrt(nch) words.
int group_size(int S) {
  const int nch = (S + kChunk - 1) / kChunk;
  if (nch <= kG * kFold) return nch;
  int G = 1;
  while (G * G < nch) ++G;
  return G;
}

template <typename T>
cudaError_t launch(const void* u, const float* ga, const float* gi,
                   const float* b_a, const float* b_i, const float* lam,
                   const float* h0, float* out, void* work, int B, int S,
                   int W, cudaStream_t stream) {
  const T* ut = static_cast<const T*>(u);
  if (S == 1) {
    const long long n = (long long)B * W;
    rglru_step_kernel<T><<<(unsigned)((n + kStepThreads - 1) / kStepThreads),
                           kStepThreads, 0, stream>>>(ut, ga, gi, b_a, b_i,
                                                      lam, h0, out, B, W);
    return cudaGetLastError();
  }
  const long long nch = (S + kChunk - 1) / kChunk;
  const long long tiles = (W + kCw - 1) / kCw;
  const int G = group_size(S);
  int* ticket = static_cast<int*>(work);
  auto* comp = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(work) + kTicketBytes);
  auto kernel = G < nch ? rglru_scan_kernel<T, true>
                        : rglru_scan_kernel<T, false>;
  kernel<<<(unsigned)(B * nch * tiles), kThreads, 0, stream>>>(
      ut, ga, gi, b_a, b_i, lam, h0, out, comp, comp + B * nch * W, ticket, B,
      S, W, G);
  return cudaGetLastError();
}

// The backward's flags: the ticket, the chunk and group composites and a
// count for each channel tile.
long long bwd_flag_bytes(int B, int S, int W) {
  const long long nch = (S + kChunk - 1) / kChunk;
  const int G = group_size(S);
  const long long ngr = (nch + G - 1) / G;
  const long long tiles = (W + kCw - 1) / kCw;
  return kTicketBytes + 8LL * B * (nch + ngr) * W +
         (4 * tiles + 15) / 16 * 16;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch_bwd(const void* u, const float* ga, const float* gi,
                       const float* b_a, const float* b_i, const float* lam,
                       const float* h0, const float* h, const float* dh,
                       void* flags, float* part, void* du, float* dga,
                       float* dgi, float* d_ba, float* d_bi, float* d_lam,
                       float* dh0, int B, int S, int W, cudaStream_t stream) {
  const long long nch = (S + kChunk - 1) / kChunk;
  const long long tiles = (W + kCw - 1) / kCw;
  const int G = group_size(S);
  const long long ngr = (nch + G - 1) / G;
  int* ticket = static_cast<int*>(flags);
  auto* comp = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(flags) + kTicketBytes);
  int* done = reinterpret_cast<int*>(comp + B * (nch + ngr) * W);
  // 16-byte copies where every staged row starts on 16 bytes
  const bool vec = W % 8 == 0 && aligned16(u) && aligned16(ga) &&
                   aligned16(gi) && aligned16(h) && aligned16(dh) &&
                   aligned16(h0);
  auto kernel = G < nch ? rglru_scan_bwd_kernel<T, true>
                        : rglru_scan_bwd_kernel<T, false>;
  kernel<<<(unsigned)(B * nch * tiles), kThreads, 0, stream>>>(
      static_cast<const T*>(u), ga, gi, b_a, b_i, lam, h0, h, dh,
      static_cast<T*>(du), dga, dgi, d_ba, d_bi, d_lam, dh0, part, comp,
      comp + B * nch * W, ticket, done, B, S, W, G, (int)vec);
  return cudaGetLastError();
}

// Kernel i of the file (the forward with float32 and bf16 u, one group
// and grouped; the step kernel; the backward as the forward): its name
// and threads a block, or false past the last.
bool kernel_at(int i, const char** name, const void** fn, int* threads) {
  struct Entry {
    const char* name;
    const void* fn;
    int threads;
  };
  using bf = __nv_bfloat16;
  const Entry all[] = {
      {"rglru_scan_kernel<float>", (const void*)rglru_scan_kernel<float, false>,
       kThreads},
      {"rglru_scan_kernel<float, grouped>",
       (const void*)rglru_scan_kernel<float, true>, kThreads},
      {"rglru_scan_kernel<bf16>", (const void*)rglru_scan_kernel<bf, false>,
       kThreads},
      {"rglru_scan_kernel<bf16, grouped>",
       (const void*)rglru_scan_kernel<bf, true>, kThreads},
      {"rglru_step_kernel<float>", (const void*)rglru_step_kernel<float>,
       kStepThreads},
      {"rglru_step_kernel<bf16>", (const void*)rglru_step_kernel<bf>,
       kStepThreads},
      {"rglru_scan_bwd_kernel<float>",
       (const void*)rglru_scan_bwd_kernel<float, false>, kThreads},
      {"rglru_scan_bwd_kernel<float, grouped>",
       (const void*)rglru_scan_bwd_kernel<float, true>, kThreads},
      {"rglru_scan_bwd_kernel<bf16>",
       (const void*)rglru_scan_bwd_kernel<bf, false>, kThreads},
      {"rglru_scan_bwd_kernel<bf16, grouped>",
       (const void*)rglru_scan_bwd_kernel<bf, true>, kThreads},
  };
  if (i < 0 || i >= (int)(sizeof(all) / sizeof(all[0]))) return false;
  *name = all[i].name;
  *fn = all[i].fn;
  *threads = all[i].threads;
  return true;
}

}  // namespace

extern "C" {

// Bytes of the workspace a call needs, all of it to be filled with ones
// by the caller: the ticket counter (in 16 bytes), then the chunks'
// composites (64 bits, B x nch x W) and the groups' (B x ngr x W); none at
// S = 1.
long long rglru_scan_workspace_bytes(int B, int S, int W) {
  if (S <= 1) return 0;
  const long long nch = (S + kChunk - 1) / kChunk;
  const int G = group_size(S);
  const long long ngr = (nch + G - 1) / G;
  return kTicketBytes + 8LL * B * (nch + ngr) * W;
}

// Returns 0 or the cudaError_t of the launch. The caller checks shapes and
// types: contiguous tensors, S, W, B >= 1; h0 may be null; work holds
// rglru_scan_workspace_bytes(B, S, W) bytes, filled with ones. One launch
// a call.
int rglru_scan_launch(const void* u, const void* ga, const void* gi,
                      const void* b_a, const void* b_i, const void* lam,
                      const void* h0, void* work, void* out, int B, int S,
                      int W, int bf16, void* stream) {
  if (B < 1 || S < 1 || W < 1 || (S > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* o = static_cast<float*>(out);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(u, f(ga), f(gi), f(b_a), f(b_i), f(lam),
                                   f(h0), o, work, B, S, W, s)
           : launch<float>(u, f(ga), f(gi), f(b_a), f(b_i), f(lam), f(h0), o,
                           work, B, S, W, s);
  return (int)err;
}

// The backward's flags (the ticket, the composites and the channel tiles'
// counts), which the caller fills with ones once and every call leaves
// so, and its partial sums (3, B, nch, W) float32, which need no filling:
// bytes of each.
long long rglru_scan_bwd_flag_bytes(int B, int S, int W) {
  return bwd_flag_bytes(B, S, W);
}

long long rglru_scan_bwd_part_bytes(int B, int S, int W) {
  return 12LL * B * ((S + kChunk - 1) / kChunk) * W;
}

// The gradient of rglru_scan_launch's h from dh (B, S, W) float32 and the
// forward's output h: du (u's type), dga, dgi (B, S, W), d_ba, d_bi,
// d_lam (W,) float32 and, where h0 is given, dh0 (B, W). `flags` holds
// at least rglru_scan_bwd_flag_bytes(B, S, W) bytes, all ones (as the
// call leaves them; no other launch may use them until it ends: a buffer
// for each stream), `part` rglru_scan_bwd_part_bytes. Returns 0 or the
// cudaError_t of the launch; one launch a call.
int rglru_scan_bwd_launch(const void* u, const void* ga, const void* gi,
                          const void* b_a, const void* b_i, const void* lam,
                          const void* h0, const void* h, const void* dh,
                          void* flags, void* part, void* du, void* dga,
                          void* dgi, void* d_ba, void* d_bi, void* d_lam,
                          void* dh0, int B, int S, int W, int bf16,
                          void* stream) {
  if (B < 1 || S < 1 || W < 1 || flags == nullptr || part == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  const cudaError_t err =
      bf16 ? launch_bwd<__nv_bfloat16>(
                 u, f(ga), f(gi), f(b_a), f(b_i), f(lam), f(h0), f(h),
                 f(dh), flags, o(part), du, o(dga), o(dgi), o(d_ba),
                 o(d_bi), o(d_lam), o(dh0), B, S, W, s)
           : launch_bwd<float>(
                 u, f(ga), f(gi), f(b_a), f(b_i), f(lam), f(h0), f(h),
                 f(dh), flags, o(part), du, o(dga), o(dgi), o(d_ba),
                 o(d_bi), o(d_lam), o(dh0), B, S, W, s);
  return (int)err;
}

// Registers, shared bytes, local (spilled) bytes and resident blocks an
// SM (out[0 .. 3]) of kernel i (`kernel_at`). Returns
// its name, or null past the last or where the runtime refuses the query.
const char* rglru_scan_kernel_attrs(int i, int* out) {
  const char* name;
  const void* fn;
  int threads;
  if (!kernel_at(i, &name, &fn, &threads)) return nullptr;
  cudaFuncAttributes a;
  int blocks = 0;
  if (cudaFuncGetAttributes(&a, fn) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                    0) != cudaSuccess)
    return nullptr;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = blocks;
  return name;
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
