// The Mamba-2 SSD chunked scan for Hopper (sm_90a) on the CUDA cores,
// exported through a plain C interface and bound to PyTorch with ctypes
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
// Every product and sum is float32, as in the JAX package.
//
// Replaces no TPU kernel: the JAX package runs this as XLA ops, a lax.scan
// of einsums over the chunks (repro/models/ssm.py:59-110, `_ssd_scan`).
// It gets a kernel because it is every Mamba2 layer's time mixing: at
// 2048 tokens its float32 work is as large as the layer's bf16 products,
// and a plain rendering materialises a (B, Q, Q, H) decay tensor a chunk.
//
// What bounds it: operations. At the Mamba2-2.7B prefill shape (B = 1,
// S = 2048, H = 80, P = 64, N = 128, Q = 256) the causal work is about
// 8.1 GFLOP (y's intra-chunk half, y's inter-chunk term and the state
// update, 2.7 G each, and C B^T) against about 0.05 GB moved: 0.12 ms at
// the CUDA cores' 67 TFLOP/s, 0.015 ms of bytes. A simple design that is
// right, in two launches:
//
// * ssd_cb_kernel: C B^T of every chunk, (B, nc, Q, Q) float32, into a
//   workspace the wrapper allocates: the heads share it, so it is formed
//   once and not once per head. One block per 64 x 64 tile on or below
//   the diagonal.
// * ssd_chunk_scan_kernel: one block of 256 threads per (b, h), walking
//   the chunks in order with the (P, N) state in shared memory (64 x 129
//   floats). For each chunk: one thread forms cum (sequentially, as the
//   JAX package's cumsum does on the CPU); y in 64-row tiles as one
//   product [W | exp(cum) C] @ [x ; h^T], W = (C B^T) exp(cum_t - cum_s)
//   dt_s below the diagonal formed panel by panel in shared memory (the
//   panels past a tile's last row are skipped); then the state update
//   (x * tail)^T @ B. Each thread holds a 4 x 4 tile of y or a 4 x 8 tile
//   of the state, f32 FMAs on operands from shared memory.
// * At B = 1 that is 80 blocks on the H100's 132 SMs; P <= 64, N <= 128,
//   Q <= 256 (Mamba2-2.7B's 64, 128, 256); smaller sizes are masked.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxP = 64;    // head dim
constexpr int kMaxN = 128;   // state dim
constexpr int kMaxQ = 256;   // chunk
constexpr int kTile = 64;    // rows of a y tile and of a C B^T tile
constexpr int kPanel = 32;   // reduction panel
constexpr int kLDH = kMaxN + 1;   // the state's row stride (odd: no bank
                                  // conflicts reading h^T)

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

// cb[b, ci, t, s] = C[t] . B[s] over the chunk's rows, zero past S.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
              float* __restrict__ cb, int S, int N, int Q, int nc) {
  const int nt = (Q + kTile - 1) / kTile;
  const int ti = blockIdx.x / nt, si = blockIdx.x % nt;
  if (si > ti) return;  // above the diagonal: never read
  const int ci = blockIdx.y, b = blockIdx.z;
  const int t0 = ti * kTile, s0 = si * kTile;
  __shared__ float cs[kTile][kPanel + 1];
  __shared__ float bs[kTile][kPanel + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long row0 = (long long)b * S + (long long)ci * Q;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += kPanel) {
    for (int idx = tid; idx < kTile * kPanel; idx += kThreads) {
      const int r = idx / kPanel, k = idx % kPanel, n = n0 + k;
      const int t = t0 + r, s = s0 + r;
      const bool nok = n < N;
      cs[r][k] = nok && t < Q && ci * Q + t < S
                     ? to_f(cm[(row0 + t) * N + n]) : 0.f;
      bs[r][k] = nok && s < Q && ci * Q + s < S
                     ? to_f(bm[(row0 + s) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kPanel; ++k) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = cs[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = bs[tx + 16 * j][k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = cb + ((long long)b * nc + ci) * Q * Q;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + ty + 16 * i, s = s0 + tx + 16 * j;
      if (t < Q && s < Q) out[(long long)t * Q + s] = acc[i][j];
    }
}

struct Smem {
  float h[kMaxP * kLDH];        // the state h[p][n]
  float cum[kMaxQ];             // inclusive prefix of dt * A in the chunk
  float dt[kMaxQ];
  float a[kTile][kPanel + 1];   // A panel of y: W or exp(cum) C
  float xs[kPanel][kMaxP];      // x panel [s][p] (scaled by tail in the
                                // state update)
  float bs[kPanel][kMaxN];      // B panel [s][n] of the state update
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                      const T* __restrict__ cm, const float* __restrict__ dt,
                      const float* __restrict__ a_log,
                      const float* __restrict__ h0,
                      const float* __restrict__ cb, T* __restrict__ y,
                      float* __restrict__ h_out, int S, int H, int P, int N,
                      int Q, int nc) {
  extern __shared__ float4 smem4[];
  Smem& sm = *reinterpret_cast<Smem*>(smem4);
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float A = -expf(a_log[h]);
  const long long bh = (long long)b * H + h;

  for (int idx = tid; idx < kMaxP * kLDH; idx += kThreads) {
    const int p = idx / kLDH, n = idx % kLDH;
    sm.h[idx] = h0 != nullptr && p < P && n < N
                    ? h0[(bh * P + p) * N + n] : 0.f;
  }

  for (int ci = 0; ci < nc; ++ci) {
    const int base = ci * Q;                 // first step of the chunk
    const int qc = min(Q, S - base);         // its real steps
    const long long row0 = (long long)b * S + base;
    const float* cbc = cb + ((long long)b * nc + ci) * Q * Q;
    __syncthreads();  // the last chunk's state update is done
    for (int t = tid; t < Q; t += kThreads)
      sm.dt[t] = t < qc ? dt[(row0 + t) * H + h] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int t = 0; t < qc; ++t) {
        run += sm.dt[t] * A;
        sm.cum[t] = run;
      }
    }
    __syncthreads();
    const float cum_last = sm.cum[qc - 1];

    // ---- y, in tiles of 64 rows: [W | exp(cum) C] @ [x ; h^T]
    for (int t0 = 0; t0 < qc; t0 += kTile) {
      float acc[4][4] = {};
      const int s_end = min(qc, t0 + kTile);  // causal: s <= t < t0 + 64
      for (int s0 = 0; s0 < s_end; s0 += kPanel) {
        for (int idx = tid; idx < kTile * kPanel; idx += kThreads) {
          const int r = idx / kPanel, k = idx % kPanel;
          const int t = t0 + r, s = s0 + k;
          float w = 0.f;
          if (s <= t && t < qc)
            w = cbc[(long long)t * Q + s] * expf(sm.cum[t] - sm.cum[s]) *
                sm.dt[s];
          sm.a[r][k] = w;
        }
        for (int idx = tid; idx < kPanel * kMaxP; idx += kThreads) {
          const int k = idx / kMaxP, p = idx % kMaxP, s = s0 + k;
          sm.xs[k][p] = s < qc && p < P
                            ? to_f(x[((row0 + s) * H + h) * P + p]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kPanel; ++k) {
          float a[4], v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = sm.a[ty + 16 * i][k];
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = sm.xs[k][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
        }
        __syncthreads();
      }
      for (int n0 = 0; n0 < N; n0 += kPanel) {
        for (int idx = tid; idx < kTile * kPanel; idx += kThreads) {
          const int r = idx / kPanel, k = idx % kPanel;
          const int t = t0 + r, n = n0 + k;
          sm.a[r][k] = t < qc && n < N
                           ? expf(sm.cum[t]) * to_f(cm[(row0 + t) * N + n])
                           : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kPanel; ++k) {
          float a[4], v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = sm.a[ty + 16 * i][k];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = sm.h[(tx + 16 * j) * kLDH + n0 + k];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= qc) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) y[((row0 + t) * H + h) * P + p] = from_f<T>(acc[i][j]);
        }
      }
    }

    // ---- the state: h = exp(cum_last) h + (x * tail)^T @ B
    float acc[4][8] = {};
    for (int s0 = 0; s0 < qc; s0 += kPanel) {
      for (int idx = tid; idx < kPanel * kMaxP; idx += kThreads) {
        const int k = idx / kMaxP, p = idx % kMaxP, s = s0 + k;
        sm.xs[k][p] = s < qc && p < P
                          ? to_f(x[((row0 + s) * H + h) * P + p]) *
                                (expf(cum_last - sm.cum[s]) * sm.dt[s])
                          : 0.f;
      }
      for (int idx = tid; idx < kPanel * kMaxN; idx += kThreads) {
        const int k = idx / kMaxN, n = idx % kMaxN, s = s0 + k;
        sm.bs[k][n] = s < qc && n < N ? to_f(bm[(row0 + s) * N + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kPanel; ++k) {
        float a[4], v[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sm.xs[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = sm.bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
      }
      __syncthreads();
    }
    const float decay = expf(cum_last);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* hp = &sm.h[(ty + 16 * i) * kLDH + tx + 16 * j];
        *hp = *hp * decay + acc[i][j];
      }
  }
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N, n = idx % N;
    h_out[(bh * P + p) * N + n] = sm.h[p * kLDH + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* bm, const void* cm,
                   const float* dt, const float* a_log, const float* h0,
                   float* cb, void* y, float* h_out, int B, int S, int H,
                   int P, int N, int Q, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const int nt = (Q + kTile - 1) / kTile;
  ssd_cb_kernel<T><<<dim3(nt * nt, nc, B), kThreads, 0, stream>>>(
      static_cast<const T*>(bm), static_cast<const T*>(cm), cb, S, N, Q, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = ssd_chunk_scan_kernel<T>;
  constexpr int smem = (int)sizeof(Smem);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), dt, a_log, h0, cb, static_cast<T*>(y), h_out,
      S, H, P, N, Q, nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the C B^T workspace a call needs (float32, B x nc x Q x Q).
long long ssd_scan_workspace_bytes(int B, int S, int Q) {
  const long long nc = (S + Q - 1) / Q;
  return (long long)B * nc * Q * Q * 4;
}

// Returns 0 or the cudaError_t of the first launch that failed. The caller
// checks shapes and types: contiguous tensors, 1 <= P <= 64,
// 1 <= N <= 128, 1 <= Q <= 256, S >= 1; cb holds
// ssd_scan_workspace_bytes(B, S, Q) bytes; h0 may be null.
int ssd_scan_launch(const void* x, const void* bm, const void* cm,
                    const void* dt, const void* a_log, const void* h0,
                    void* cb, void* y, void* h_out, int B, int S, int H,
                    int P, int N, int Q, int bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      Q < 1 || Q > kMaxQ || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* alf = static_cast<const float*>(a_log);
  const float* h0f = static_cast<const float*>(h0);
  float* cbf = static_cast<float*>(cb);
  float* hf = static_cast<float*>(h_out);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, bm, cm, dtf, alf, h0f, cbf, y, hf, B,
                                   S, H, P, N, Q, s)
           : launch<float>(x, bm, cm, dtf, alf, h0f, cbf, y, hf, B, S, H, P,
                           N, Q, s);
  return (int)err;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
