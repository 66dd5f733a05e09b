// Flash attention forward for Hopper (sm_90a) on the CUDA cores: the lane
// for float32 inputs and for bf16 at head dims other than 64 and 128 (the
// smoke configs' 12-20). bf16 at D = 64 or 128 goes to the tensor-core
// kernel, flash_attention_wgmma.cu. Exported through a plain C interface
// and bound to PyTorch with ctypes
// (repro_torch/kernels/flash_attention/flash_attention.py, whose
// kernel_lane picks the lane).
//
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / G, j]) v[b, h / G, j]
//   q (B, H, S, D), k and v (B, Hkv, T, D), float or bf16, contiguous;
//   o (B, H, S, D) in q's type; G = H / Hkv.
//
// Causal masking is aligned top-left: row i sees columns j <= i, for any S
// and T. Columns j >= T (the ragged tail of the last kv tile) and rows
// i >= S (the ragged tail of the last q tile) are masked inside the kernel,
// so S and T need not be multiples of the tiles.
//
// Replaces repro/kernels/flash_attention/flash_attention.py::_kernel, which
// walks a sequential (B, H, nq, nk) grid and carries the running max,
// denominator and accumulator in VMEM scratch from one kv step to the next.
// Here one thread block owns one (b, h, q tile) and loops over the kv tiles
// itself, so nothing carries across blocks. The block reads kv head h / G
// in place: kv is never repeated in memory. Causal blocks skip the kv tiles
// that lie wholly past their last row, as the TPU kernel's pl.when does,
// and are scheduled longest first.
//
// Arithmetic: every tile is widened to float32 in shared memory; the scores
// q k^T and the product p v are f32 FMAs on the CUDA cores, and the running
// max, denominator and accumulator stay in f32 registers. The softmax uses
// exp2f on scores pre-multiplied by scale * log2(e) (the same function as
// exp on the unscaled scores, up to rounding). Masked scores are -1e30, as
// in the TPU kernel, and a row whose denominator is 0 divides by 1.
//
// What bounds it: operations. At the Yi-6B prefill shape (B=1, H=32,
// Hkv=4, S=T=2048, D=128, causal) the work is 34 GFLOP against 0.1 GB of
// float32 q, k, v and o: 0.5 ms on the CUDA cores in f32 (67 TFLOP/s).
// The arithmetic stays in f32 so that the float32 lane computes the
// float32 function (no bf16 or TF32 rounding): each thread holds a 4 x 8
// block of scores and a 4 x (D/8) block of the output, so that every
// 16-byte shared-memory load feeds 4 or 8 FMAs.
//
// Tiles: BQ = BK = 64 rows, 128 threads (16 row groups x 8 column groups).
// Thread (ty, tx) owns rows ty + 16 i (i < 4), score columns tx + 8 j
// (j < 8), and output columns tx * 4 + 32 c + e (c < D/32, e < 4). Shared
// memory holds the q, k and v tiles (row stride D + 4 floats: conflict-free
// 16-byte loads) and the tile of probabilities p (row stride BK + 8).
// D is padded up to DPAD in {32, 64, 128} with zeros.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kLDP = kBK + 8;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DPAD>
constexpr int smem_floats() {
  return kBQ * (DPAD + 4) + 2 * kBK * (DPAD + 4) + kBQ * kLDP;
}

__device__ __forceinline__ float4 widen4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Load rows [row0, row0 + ROWS) of a (n, D) matrix into a (ROWS, DPAD)
// f32 tile of row stride LD, zero outside the matrix. vec: D is a multiple
// of the 16-byte vector and the matrix is 16-byte aligned.
template <int ROWS, int DPAD>
__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          int row0, int n, int D, bool vec) {
  constexpr int LD = DPAD + 4;
  if (vec) {
    constexpr int CH = DPAD / 4;
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += kThreads) {
      const int r = idx / CH, c = (idx % CH) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < n && c < D)
        val = *reinterpret_cast<const float4*>(
            src + (long long)(row0 + r) * D + c);
      *reinterpret_cast<float4*>(tile + r * LD + c) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DPAD; idx += kThreads) {
      const int r = idx / DPAD, c = idx % DPAD;
      tile[r * LD + c] = (row0 + r < n && c < D)
                             ? src[(long long)(row0 + r) * D + c] : 0.f;
    }
  }
}

template <int ROWS, int DPAD>
__device__ __forceinline__ void load_tile(float* tile,
                                          const __nv_bfloat16* src, int row0,
                                          int n, int D, bool vec) {
  constexpr int LD = DPAD + 4;
  if (vec) {
    constexpr int CH = DPAD / 8;
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += kThreads) {
      const int r = idx / CH, c = (idx % CH) * 8;
      float out[8];
      if (row0 + r < n && c < D) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            src + (long long)(row0 + r) * D + c);
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          out[2 * e] = f.x;
          out[2 * e + 1] = f.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) out[e] = 0.f;
      }
      *reinterpret_cast<float4*>(tile + r * LD + c) =
          make_float4(out[0], out[1], out[2], out[3]);
      *reinterpret_cast<float4*>(tile + r * LD + c + 4) =
          make_float4(out[4], out[5], out[6], out[7]);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DPAD; idx += kThreads) {
      const int r = idx / DPAD, c = idx % DPAD;
      tile[r * LD + c] =
          (row0 + r < n && c < D)
              ? __bfloat162float(src[(long long)(row0 + r) * D + c]) : 0.f;
    }
  }
}

// Store the first n (<= 4) of v; the loops are unrolled so that v stays in
// registers (a dynamic index would put it in local memory).
__device__ __forceinline__ void store4(float* dst, const float (&v)[4], int n,
                                       bool vec) {
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) dst[e] = v[e];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst,
                                       const float (&v)[4], int n, bool vec) {
  if (vec && n == 4) {
    __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
    d2[0] = __floats2bfloat162_rn(v[0], v[1]);
    d2[1] = __floats2bfloat162_rn(v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) dst[e] = __float2bfloat16_rn(v[e]);
  }
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
                 int S, int Tk, int D, float scale_log2, bool causal,
                 bool vec) {
  constexpr int LD = DPAD + 4;
  constexpr int NC = DPAD / 32;  // float4 output groups per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* ps = vs + kBK * LD;

  const int nq = (S + kBQ - 1) / kBQ;
  // causal q tiles near the end do the most work: launch them first
  const int qt = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBQ;
  const long long q_off = ((long long)b * H + h) * S * D;
  const long long kv_off = ((long long)b * Hkv + hk) * Tk * D;

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;

  load_tile<kBQ, DPAD>(qs, q + q_off, q0, S, D, vec);

  float acc[4][NC * 4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (Tk + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, (q0 + kBQ - 1) / kBK + 1);

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every thread is done with the previous k, v, p
    load_tile<kBK, DPAD>(ks, k + kv_off, k0, Tk, D, vec);
    load_tile<kBK, DPAD>(vs, v + kv_off, k0, Tk, D, vec);
    __syncthreads();

    // scores s[i][j] = q[row i] . k[col j]
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DPAD; d += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = widen4(qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 bk = widen4(ks + (tx + 8 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(a[i].x, bk.x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk.y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk.z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk.w, s[i][j]);
        }
      }
    }

    // online softmax over this tile; the 8 threads of a row group share
    // their row maxima by shuffles (they are 8 neighbouring lanes)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 8 * j;
        const bool ok = col < Tk && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] * scale_log2 : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        ps[(ty + 16 * i) * kLDP + tx + 8 * j] = p;
        rowsum += p;
      }
      // l[i] is this thread's share of the denominator (its 8 columns);
      // the shares are summed across the row group at the end
      l[i] = l[i] * alpha + rowsum;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p v
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = widen4(ps + (ty + 16 * i) * kLDP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = vs + (kk + e) * LD + tx * 4;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = widen4(vrow + 32 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pe = e == 0 ? p4[i].x : e == 1 ? p4[i].y
                           : e == 2 ? p4[i].z : p4[i].w;
            acc[i][4 * c + 0] = fmaf(pe, vv.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(pe, vv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(pe, vv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(pe, vv.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
  }

  // normalise and write rows < S, columns < D
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    if (li == 0.f) li = 1.f;
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    T* orow = o + q_off + (long long)row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx * 4 + 32 * c;
      if (col >= D) continue;
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = acc[i][4 * c + e] / li;
      store4(orow + col, out, min(4, D - col), vec);
    }
  }
}

template <typename T, int DPAD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int S, int Tk, int D, float scale,
                   bool causal, bool vec, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<DPAD>();
  auto kernel = flash_fwd_kernel<T, DPAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, S, Tk, D,
      scale * kLog2e, causal, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int Hkv, int S, int Tk, int D,
                       float scale, bool causal, bool vec,
                       cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, B, H, Hkv, S, Tk, D, scale, causal, vec,
                         stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, H, Hkv, S, Tk, D, scale, causal, vec,
                         stream);
  return launch<T, 128>(q, k, v, o, B, H, Hkv, S, Tk, D, scale, causal, vec,
                        stream);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). The caller
// checks shapes: H % Hkv == 0, 1 <= D <= 128, S, T >= 1, contiguous
// tensors; vec = D is a multiple of 16 bytes' worth of elements and every
// pointer is 16-byte aligned.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int Hkv, int S, int T,
                           int D, float scale, int causal, int bf16, int vec,
                           void* stream) {
  if (H <= 0 || Hkv <= 0 || H % Hkv != 0 || D < 1 || D > 128 || S < 1 ||
      T < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, T, D, scale,
                                       causal != 0, vec != 0, s)
           : dispatch_d<float>(q, k, v, o, B, H, Hkv, S, T, D, scale,
                               causal != 0, vec != 0, s);
  return (int)err;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
