// Per-sample-weight 3x3 stride-2 convolution with padding 1: the dynamic
// conv at the heart of ODConv. For every sample b,
//     out[b] = conv2d(x[b], wmix[b])
// with x (B, H, W, Cin) NHWC, wmix (B, 3, 3, Cin, Cout) and out
// (B, H/2, W/2, Cout), accumulated in f32.
//
// Replaces yolosomi_tpu/ops/odconv_pallas.py::odconv_s2_pallas (the TPU
// kernel). Its plain PyTorch version is odconv_s2_reference in
// yolosomi_tpu_torch/ops/odconv.py.
//
// Design: a per-sample implicit GEMM. For sample b, M = oh*ow output
// pixels, N = Cout, K = 9*Cin. A[m, k] is gathered from x on the fly
// (iy = 2*oy + ky - 1, ix = 2*ox + kx - 1, zero outside the image), so the
// patch matrix never exists in device memory; B is wmix[b] viewed as
// (9*Cin, Cout), row-major as stored. The TPU kernel's parity planes,
// double-buffered row band and 2-plane channel packing were answers to
// VMEM tiling and 128-lane alignment; on Hopper the stride-2 gather is
// address arithmetic, and the kernel masks ragged edges itself, so any
// Cin and Cout are taken.
//
// The batch is a grid axis, grid = (ceil(M/64), ceil(Cout/64), B): every
// sample has its own B matrix, so nothing is shared across samples and a
// block never needs another sample's weights.
//
// Two paths: f32 with FMA in registers (a 4x4 micro-tile per thread), and
// bf16 on the tensor cores through nvcuda::wmma (16x16x16 fragments, f32
// accumulators). Both stage 64x32 A and 32x64 B tiles in shared memory.
// No TMA, wgmma or persistent schedule yet.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM), per image
// in bf16, bytes = x + out + w read/written once:
//   site    FLOPs        at 989 TF/s   bytes     at 3.35 TB/s   bound by
//   row 1   3.77 GFLOP   3.8 us        19.8 MB   5.9 us         bytes
//   row 26  7.55 GFLOP   7.6 us        17.6 MB   5.2 us         operations
//   row 29  1.89 GFLOP   1.9 us         5.3 MB   1.6 us         operations
//   row 32  0.94 GFLOP   1.0 us         4.2 MB   1.3 us         bytes
// (rows of configs/models/yolo-somi.yaml at 640 px: Cin 64/256/256/512,
// Cout 128/256/256/256, input 320/160/80/40 px square).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

namespace {

constexpr int BM = 64;  // output pixels per block
constexpr int BN = 64;  // output channels per block
constexpr int BK = 32;  // reduction chunk staged through shared memory

struct Shape {
  int H, W, Cin, Cout, OW, M, K;
};

__device__ __forceinline__ float zero_of(float) { return 0.0f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) { return __float2bfloat16(0.0f); }

// A[m, k] of one sample: the input value under tap (ky, kx) = (k / Cin) of
// output pixel m, channel k % Cin; zero in the padding and past the edges.
template <typename T>
__device__ __forceinline__ T load_a(const T* __restrict__ xb, const Shape& s, int m, int k) {
  if (m >= s.M || k >= s.K) return zero_of(T());
  const int tap = k / s.Cin;
  const int ci = k - tap * s.Cin;
  const int ky = tap / 3;
  const int kx = tap - ky * 3;
  const int oy = m / s.OW;
  const int ox = m - oy * s.OW;
  const int iy = 2 * oy + ky - 1;
  const int ix = 2 * ox + kx - 1;
  if (iy < 0 || iy >= s.H || ix < 0 || ix >= s.W) return zero_of(T());
  return xb[(static_cast<size_t>(iy) * s.W + ix) * s.Cin + ci];
}

template <typename T>
__device__ __forceinline__ T load_b(const T* __restrict__ wb, const Shape& s, int k, int n) {
  if (k >= s.K || n >= s.Cout) return zero_of(T());
  return wb[static_cast<size_t>(k) * s.Cout + n];
}

// f32: 256 threads, each owns rows ty + 16*i and columns tx + 16*j.
__global__ void __launch_bounds__(256)
odconv_s2_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
                     Shape s) {
  __shared__ float As[BK][BM + 4];  // transposed: As[k][m]
  __shared__ float Bs[BK][BN + 4];
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const float* xb = x + static_cast<size_t>(b) * s.H * s.W * s.Cin;
  const float* wb = w + static_cast<size_t>(b) * s.K * s.Cout;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < s.K; k0 += BK) {
    // k fastest across threads: consecutive threads read consecutive channels
    for (int i = tid; i < BM * BK; i += 256) {
      const int mm = i / BK, kk = i % BK;
      As[kk][mm] = load_a(xb, s, m0 + mm, k0 + kk);
    }
    for (int i = tid; i < BK * BN; i += 256) {
      const int kk = i / BN, nn = i % BN;
      Bs[kk][nn] = load_b(wb, s, k0 + kk, n0 + nn);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* ob = out + static_cast<size_t>(b) * s.M * s.Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < s.M && n < s.Cout) ob[static_cast<size_t>(m) * s.Cout + n] = acc[i][j];
    }
  }
}

// bf16: 128 threads = 4 warps in a 2x2 layout, each warp a 32x32 sub-tile
// of 2x2 wmma fragments. Row pads keep fragment pointers 32-byte aligned.
constexpr int A_LD = BK + 8;
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;

__global__ void __launch_bounds__(128)
odconv_s2_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      __nv_bfloat16* __restrict__ out, Shape s) {
  namespace wmma = nvcuda::wmma;
  __shared__ __align__(128) __nv_bfloat16 As[BM][A_LD];  // As[m][k]
  __shared__ __align__(128) __nv_bfloat16 Bs[BK][B_LD];  // Bs[k][n]
  __shared__ __align__(128) float Cs[BM][C_LD];
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * s.H * s.W * s.Cin;
  const __nv_bfloat16* wb = w + static_cast<size_t>(b) * s.K * s.Cout;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.0f);

  for (int k0 = 0; k0 < s.K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += 128) {
      const int mm = i / BK, kk = i % BK;
      As[mm][kk] = load_a(xb, s, m0 + mm, k0 + kk);
    }
    for (int i = tid; i < BK * BN; i += 128) {
      const int kk = i / BN, nn = i % BN;
      Bs[kk][nn] = load_b(wb, s, k0 + kk, n0 + nn);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bf[j], &Bs[kk][wn * 32 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], bf[j], c[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16], c[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  __nv_bfloat16* ob = out + static_cast<size_t>(b) * s.M * s.Cout;
  for (int i = tid; i < BM * BN; i += 128) {
    const int mm = i / BN, nn = i % BN;
    const int m = m0 + mm, n = n0 + nn;
    if (m < s.M && n < s.Cout) ob[static_cast<size_t>(m) * s.Cout + n] = __float2bfloat16(Cs[mm][nn]);
  }
}

Shape make_shape(int H, int W, int Cin, int Cout) {
  Shape s;
  s.H = H;
  s.W = W;
  s.Cin = Cin;
  s.Cout = Cout;
  s.OW = W / 2;
  s.M = (H / 2) * (W / 2);
  s.K = 9 * Cin;
  return s;
}

dim3 make_grid(const Shape& s, int B) { return dim3((s.M + BM - 1) / BM, (s.Cout + BN - 1) / BN, B); }

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous tensors; `stream` is a cudaStream_t. Each returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int odconv_s2_f32(const void* x, const void* w, void* out, int B, int H, int W, int Cin, int Cout,
                             void* stream) {
  const Shape s = make_shape(H, W, Cin, Cout);
  odconv_s2_f32_kernel<<<make_grid(s, B), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int odconv_s2_bf16(const void* x, const void* w, void* out, int B, int H, int W, int Cin, int Cout,
                              void* stream) {
  const Shape s = make_shape(H, W, Cin, Cout);
  odconv_s2_bf16_kernel<<<make_grid(s, B), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), s);
  return static_cast<int>(cudaGetLastError());
}
