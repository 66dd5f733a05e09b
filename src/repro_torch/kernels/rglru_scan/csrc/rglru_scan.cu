// The RG-LRU gates and linear recurrence of RecurrentGemma (Griffin) for
// Hopper (sm_90a), fused, exported through a plain C interface and bound
// to PyTorch with ctypes (repro_torch/kernels/rglru_scan/rglru_scan.py).
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
// gi (4 each) and writes h (4): 14 bytes against some 30 flops, far below
// the card's ~20 flops a byte in float32. A simple design that is right,
// a chunked scan in two launches, so that B x W = 2,560 channels at B = 1
// (RecurrentGemma-2B) still fill the card:
//
// * Time is cut into nch chunks of L steps (nch <= 64). One thread owns a
//   (b, chunk, w): neighbouring threads take neighbouring channels, so
//   every load and store is coalesced along W.
// * rglru_chunk_kernel: each chunk's composite over its steps, the
//   product of its a and its local h from a zero start, into a workspace.
// * rglru_scan_kernel: each chunk's carry-in, h0 folded through the
//   composites of the chunks before it in order, then the chunk's steps
//   again from the carry, writing h. The gates are computed twice (once a
//   pass), the inputs read twice.
// The recurrence runs step after step from the carry, so its rounding
// differs from the associative scan's (a log-depth tree of products) by a
// few float32 ulps.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kC = 8.0f;   // Griffin's fixed gate exponent

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// a and b of one step: the JAX package's _lru_coeffs
template <typename T>
__device__ __forceinline__ void coeffs(const T* __restrict__ u,
                                       const float* __restrict__ ga,
                                       const float* __restrict__ gi,
                                       long long idx, float b_a, float b_i,
                                       float log_a0, float& a, float& b) {
  const float r = sigmoid(ga[idx] + b_a);
  const float i = sigmoid(gi[idx] + b_i);
  const float log_a = kC * r * log_a0;
  a = expf(log_a);
  const float mult = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
  b = mult * (i * to_f(u[idx]));
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_chunk_kernel(const T* __restrict__ u, const float* __restrict__ ga,
                   const float* __restrict__ gi,
                   const float* __restrict__ b_a,
                   const float* __restrict__ b_i,
                   const float* __restrict__ lam, float* __restrict__ agg_a,
                   float* __restrict__ agg_h, int S, int W, int L) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const int ch = blockIdx.y, b = blockIdx.z, nch = gridDim.y;
  const float ba = b_a[w], bi = b_i[w], la0 = log_sigmoid(lam[w]);
  const int t1 = min(S, (ch + 1) * L);
  float A = 1.f, h = 0.f;
  for (int t = ch * L; t < t1; ++t) {
    float a, bb;
    coeffs(u, ga, gi, ((long long)b * S + t) * W + w, ba, bi, la0, a, bb);
    h = fmaf(a, h, bb);
    A *= a;
  }
  const long long o = ((long long)b * nch + ch) * W + w;
  agg_a[o] = A;
  agg_h[o] = h;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ u, const float* __restrict__ ga,
                  const float* __restrict__ gi,
                  const float* __restrict__ b_a,
                  const float* __restrict__ b_i,
                  const float* __restrict__ lam,
                  const float* __restrict__ h0,
                  const float* __restrict__ agg_a,
                  const float* __restrict__ agg_h, float* __restrict__ out,
                  int S, int W, int L) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const int ch = blockIdx.y, b = blockIdx.z, nch = gridDim.y;
  float h = h0 != nullptr ? h0[(long long)b * W + w] : 0.f;
  for (int c = 0; c < ch; ++c) {
    const long long o = ((long long)b * nch + c) * W + w;
    h = fmaf(agg_a[o], h, agg_h[o]);
  }
  const float ba = b_a[w], bi = b_i[w], la0 = log_sigmoid(lam[w]);
  const int t1 = min(S, (ch + 1) * L);
  for (int t = ch * L; t < t1; ++t) {
    const long long idx = ((long long)b * S + t) * W + w;
    float a, bb;
    coeffs(u, ga, gi, idx, ba, bi, la0, a, bb);
    h = fmaf(a, h, bb);
    out[idx] = h;
  }
}

// Steps per chunk: at most 64 chunks, so that the carry walk stays short.
int chunk_len(int S) { return (S + 63) / 64; }

template <typename T>
cudaError_t launch(const void* u, const float* ga, const float* gi,
                   const float* b_a, const float* b_i, const float* lam,
                   const float* h0, float* work, float* out, int B, int S,
                   int W, cudaStream_t stream) {
  const int L = chunk_len(S);
  const int nch = (S + L - 1) / L;
  const dim3 grid((W + kThreads - 1) / kThreads, nch, B);
  float* agg_a = work;
  float* agg_h = work + (long long)B * nch * W;
  if (nch > 1) {
    rglru_chunk_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(u), ga, gi, b_a, b_i, lam, agg_a, agg_h, S, W,
        L);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), ga, gi, b_a, b_i, lam, h0, agg_a, agg_h, out,
      S, W, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the chunk composites' workspace a call needs.
long long rglru_scan_workspace_bytes(int B, int S, int W) {
  const int L = chunk_len(S);
  const long long nch = (S + L - 1) / L;
  return 2 * (long long)B * nch * W * 4;
}

// Returns 0 or the cudaError_t of the first launch that failed. The caller
// checks shapes and types: contiguous tensors, S, W, B >= 1; work holds
// rglru_scan_workspace_bytes(B, S, W) bytes; h0 may be null.
int rglru_scan_launch(const void* u, const void* ga, const void* gi,
                      const void* b_a, const void* b_i, const void* lam,
                      const void* h0, void* work, void* out, int B, int S,
                      int W, int bf16, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* wk = static_cast<float*>(work);
  float* o = static_cast<float*>(out);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(u, f(ga), f(gi), f(b_a), f(b_i), f(lam),
                                   f(h0), wk, o, B, S, W, s)
           : launch<float>(u, f(ga), f(gi), f(b_a), f(b_i), f(lam), f(h0),
                           wk, o, B, S, W, s);
  return (int)err;
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
