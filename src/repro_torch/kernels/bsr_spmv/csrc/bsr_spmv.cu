// Block-CSR SpMV for Hopper (sm_90a), exported through a plain C interface
// and bound to PyTorch with ctypes (repro_torch/kernels/bsr_spmv/bsr_spmv.py).
//
//   y[i] = sum_k blocks[i, k] @ x[blk_cols[i, k]]
//   blocks (nbr, K, bm, bn) f32, blk_cols (nbr, K) i32,
//   x (nbc, bn, nv) f32 or f16  ->  y (nbr, bm, nv) f32
//
// Replaces repro/kernels/bsr_spmv/bsr_spmv.py::_kernel (accum="f32") and
// ::_kernel_kahan (accum="kahan"). The TPU kernel walks a sequential
// (nbr, K) grid and accumulates in the output VMEM block; here every output
// element (block-row i, row m, lane v) is one thread that loops over the K
// slots itself, so nothing carries across thread blocks and no atomics are
// needed. Zero-padded slots point at block column 0 with an all-zero block
// and are simply computed.
//
// What bounds it: device-memory bytes. At bm = bn = 32 on the Stanford-Web
// replica one apply reads 1.19 GB of blocks (about 0.36 ms at 3.35 TB/s);
// the blocks are 1.2% full, so that is roughly 40x the 28 MB a CSR matvec
// would move (12 B/nnz). The design keeps the block stream at full rate:
// threads are laid out with the lane v fastest, then the row m, so a warp
// reads whole block rows with 16-byte loads and the x slice it needs is one
// broadcast sector. Every float is multiplied in full f32 on the CUDA cores
// (no TF32). Making it faster (cp.async/TMA rings, tensor cores, fusing the
// hub segment-sum into the epilogue) is later work.
//
// Kahan lane: compensation runs across the K slots only, as _kernel_kahan
// does; the dot inside one block is a plain f32 sum. The compensation steps
// use __fadd_rn/__fsub_rn so that nvcc cannot contract or reorder them.

#include <climits>
#include <cstdint>

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <bool KAHAN, typename XT>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_kernel(const float* __restrict__ blocks,
                const int* __restrict__ blk_cols,
                const XT* __restrict__ x, float* __restrict__ y,
                long long n_out, int K, int bm, int bn, int nv, bool vec4) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_out) return;
  const int v = (int)(g % nv);
  const long long r = g / nv;  // padded row: i * bm + m
  const long long i = r / bm;
  const int m = (int)(r - i * bm);

  float acc = 0.f;
  float comp = 0.f;
  for (int k = 0; k < K; ++k) {
    const long long slot = i * K + k;
    const long long c = blk_cols[slot];
    const float* brow = blocks + (slot * bm + m) * (long long)bn;
    const XT* xc = x + c * bn * nv + v;
    float prod = 0.f;
    if (vec4) {
      const float4* b4 = reinterpret_cast<const float4*>(brow);
#pragma unroll 4
      for (int q = 0; q < bn / 4; ++q) {
        const float4 b = b4[q];
        const XT* xq = xc + (long long)(4 * q) * nv;
        prod = fmaf(b.x, to_f32(xq[0]), prod);
        prod = fmaf(b.y, to_f32(xq[nv]), prod);
        prod = fmaf(b.z, to_f32(xq[2 * nv]), prod);
        prod = fmaf(b.w, to_f32(xq[3 * nv]), prod);
      }
    } else {
      for (int n = 0; n < bn; ++n)
        prod = fmaf(brow[n], to_f32(xc[(long long)n * nv]), prod);
    }
    if (KAHAN) {
      const float yk = __fsub_rn(prod, comp);
      const float t = __fadd_rn(acc, yk);
      comp = __fsub_rn(__fsub_rn(t, acc), yk);
      acc = t;
    } else {
      acc = __fadd_rn(acc, prod);
    }
  }
  y[g] = acc;
}

template <bool KAHAN, typename XT>
void launch(const void* blocks, const void* blk_cols, const void* x, void* y,
            long long n_out, int K, int bm, int bn, int nv, bool vec4,
            unsigned grid, cudaStream_t stream) {
  bsr_spmv_kernel<KAHAN, XT><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(blk_cols),
      static_cast<const XT*>(x), static_cast<float*>(y), n_out, K, bm, bn, nv,
      vec4);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// caller checks shapes, types, devices and contiguity, and guarantees
// 0 <= blk_cols < nbc.
extern "C" int bsr_spmv_launch(const void* blocks, const void* blk_cols,
                               const void* x, void* y, long long nbr, int K,
                               int bm, int bn, int nv, int x_half, int kahan,
                               void* stream) {
  const long long n_out = nbr * bm * (long long)nv;
  const long long grid = (n_out + kThreads - 1) / kThreads;
  if (n_out <= 0 || grid > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool vec4 = bn % 4 == 0 &&
                    reinterpret_cast<std::uintptr_t>(blocks) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = (unsigned)grid;
  if (kahan) {
    if (x_half)
      launch<true, __half>(blocks, blk_cols, x, y, n_out, K, bm, bn, nv, vec4,
                           g, s);
    else
      launch<true, float>(blocks, blk_cols, x, y, n_out, K, bm, bn, nv, vec4,
                          g, s);
  } else {
    if (x_half)
      launch<false, __half>(blocks, blk_cols, x, y, n_out, K, bm, bn, nv,
                            vec4, g, s);
    else
      launch<false, float>(blocks, blk_cols, x, y, n_out, K, bm, bn, nv, vec4,
                           g, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bsr_spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
