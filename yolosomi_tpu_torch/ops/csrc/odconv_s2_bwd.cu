// The backward of odconv_s2 (csrc/odconv_s2.cu): the per-sample-weight
// 3x3 stride-2 convolution with padding 1,
//     y[b, oy, ox, co] = sum_{ky,kx,ci} x[b, 2oy+ky-1, 2ox+kx-1, ci] * wmix[b, ky, kx, ci, co]
// with x (B, H, W, Cin) NHWC, wmix (B, 3, 3, Cin, Cout), y (B, H/2, W/2, Cout).
//
// Two kernels, f32 accumulation, f32 or bf16 operands:
//
// dx[b, iy, ix, ci] = sum over the taps (ky, kx) with iy+1-ky and ix+1-kx
//   even and oy = (iy+1-ky)/2, ox = (ix+1-kx)/2 inside the output, and over
//   co, of dy[b, oy, ox, co] * wmix[b, ky, kx, ci, co].
//   The pixels fall into four parity classes of (iy % 2, ix % 2): an even
//   row takes tap ky = 1 (oy = iy/2), an odd row ky = 0 (oy = (iy+1)/2, when
//   inside) and ky = 2 (oy = (iy-1)/2); columns alike. So the classes take
//   1, 2, 2 and 4 taps, and each class is a GEMM of its H/2 x W/2 pixels by
//   Cin with K = taps * Cout: A[m, (t, co)] = dy at pixel m's tap t,
//   B[(t, co), ci] = wmix[b, t, ci, co]. No zero-stuffed dy is formed and
//   no multiply by a structural zero is made.
//
// dwmix[b, ky, kx, ci, co] = sum_{oy, ox} x[b, 2oy+ky-1, 2ox+kx-1, ci] * dy[b, oy, ox, co]
//   per sample a GEMM of M = 9*Cin rows (tap, ci) by N = Cout over the
//   P = (H/2)*(W/2) output pixels: the transposed patch matrix of x times
//   dy. The reduction is long (25 600 pixels at the flagship's row 1, 640
//   px), so it is cut into `split` parts of whole 32-pixel steps; each part
//   writes f32 partial sums to a workspace, and odconv_s2_bwd_reduce adds
//   the parts in a fixed order. No float atomics: two calls give the same
//   bits.
//
// Replaces XLA's VJP of the JAX package's batch-grouped vmap conv
// (yolosomi_tpu/models/layers.py:874-875: the Pallas kernel
// odconv_s2_pallas, yolosomi_tpu/ops/odconv_pallas.py:111, has no VJP, so
// JAX trains ODConv through the vmap conv). Plain PyTorch versions:
// autograd of odconv_s2_reference (ops/odconv.py).
//
// Bound on an H100 SXM: each kernel does the forward's 2*B*M*Cout*9*Cin
// FLOPs, 113.2 GFLOP for a b8 step of the flagship at 640 px (rows 1, 26,
// 29, 32), and reads and writes 36-77 MB a step; on the tensor cores it
// would be bound by operations (0.11 ms at 989 TFLOP/s). These kernels are
// the simple first form: 64x64 output tiles, 32-deep K steps staged
// through shared memory as f32, a 4x4 FMA micro-tile per thread (256
// threads), scalar loads. They are bound by the FMA pipes and shared-memory
// traffic (at best 67 TFLOP/s of f32 FMA); a tensor-core version of the
// forward's wgmma family is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BM = 64;  // output rows per block
constexpr int BN = 64;  // output columns per block
constexpr int BK = 32;  // reduction step staged through shared memory
constexpr int THREADS = 256;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// acc[i][j] += sum_kk As[kk][ty + 16i] * Bs[kk][tx + 16j]
__device__ __forceinline__ void fma_tile(float (&acc)[4][4], const float (*As)[BM + 1], const float (*Bs)[BN + 1],
                                         int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

struct Dims {
  int B, H, W, Cin, Cout, OH, OW;
};

// ---------------------------------------------------------------------------
// dx
// ---------------------------------------------------------------------------

// grid (ceil(OH*OW / BM), ceil(Cin / BN), B * 4): blockIdx.z = b * 4 + class,
// class = 2 * (iy % 2) + (ix % 2). Pixel m of a class is (qy, qx) =
// (m / OW, m % OW), iy = 2 qy + py, ix = 2 qx + px.
template <typename T>
__global__ void __launch_bounds__(THREADS)
odconv_s2_dx_kernel(const T* __restrict__ dy, const T* __restrict__ w, T* __restrict__ dx, Dims d) {
  __shared__ float As[BK][BM + 1];  // As[k][m]
  __shared__ float Bs[BK][BN + 1];  // Bs[k][n]
  const int b = blockIdx.z / 4;
  const int py = (blockIdx.z % 4) / 2;
  const int px = blockIdx.z % 2;
  const int M = d.OH * d.OW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* dyb = dy + static_cast<size_t>(b) * M * d.Cout;
  const T* wb = w + static_cast<size_t>(b) * 9 * d.Cin * d.Cout;

  // this class's taps: rows ky with their output-row shift (oy = qy + sy)
  const int nty = py ? 2 : 1, ntx = px ? 2 : 1;
  const int kys[2] = {py ? 0 : 1, 2}, sys[2] = {py ? 1 : 0, 0};
  const int kxs[2] = {px ? 0 : 1, 2}, sxs[2] = {px ? 1 : 0, 0};

  // A loader: k (= co) fastest across threads; each thread keeps one row
  // (pixel) for all its loads of a step, rows kk_row + 8 * r
  const int a_k = tid % BK;
  const int a_r0 = tid / BK;  // 0..7
  // B loader: k (= co) fastest, for coalesced reads of wmix's co axis
  const int b_k = tid % BK;
  const int b_n0 = tid / BK;  // 0..7

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int ty_i = 0; ty_i < nty; ++ty_i) {
    for (int tx_i = 0; tx_i < ntx; ++tx_i) {
      const int ky = kys[ty_i], kx = kxs[tx_i];
      const int tap = ky * 3 + kx;
      for (int c0 = 0; c0 < d.Cout; c0 += BK) {
        const int co = c0 + a_k;
#pragma unroll
        for (int r = 0; r < BM / 8; ++r) {
          const int mm = a_r0 + 8 * r;
          const int m = m0 + mm;
          float v = 0.0f;
          if (m < M && co < d.Cout) {
            const int qy = m / d.OW, qx = m - (m / d.OW) * d.OW;
            const int oy = qy + sys[ty_i], ox = qx + sxs[tx_i];
            if (oy < d.OH && ox < d.OW) v = load(dyb + (static_cast<size_t>(oy) * d.OW + ox) * d.Cout + co);
          }
          As[a_k][mm] = v;
        }
        const int cob = c0 + b_k;
#pragma unroll
        for (int r = 0; r < BN / 8; ++r) {
          const int nn = b_n0 + 8 * r;
          const int ci = n0 + nn;
          float v = 0.0f;
          if (ci < d.Cin && cob < d.Cout) v = load(wb + (static_cast<size_t>(tap) * d.Cin + ci) * d.Cout + cob);
          Bs[b_k][nn] = v;
        }
        __syncthreads();
        fma_tile(acc, As, Bs, tx, ty);
        __syncthreads();
      }
    }
  }

  T* dxb = dx + static_cast<size_t>(b) * d.H * d.W * d.Cin;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const int qy = m / d.OW, qx = m - (m / d.OW) * d.OW;
    const size_t pix = static_cast<size_t>(2 * qy + py) * d.W + (2 * qx + px);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = n0 + tx + 16 * j;
      if (ci < d.Cin) store(dxb + pix * d.Cin + ci, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// dwmix
// ---------------------------------------------------------------------------

// grid (ceil(9*Cin / BM), ceil(Cout / BN), B * split): blockIdx.z =
// part * B + b. Rows r = tap * Cin + ci, columns co, the reduction over the
// pixels [p0, p1) of this part. `out` is f32 partial sums (split > 1,
// (split, B, 9*Cin, Cout)) or dwmix itself (split == 1).
template <typename T, typename O>
__global__ void __launch_bounds__(THREADS)
odconv_s2_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy, O* __restrict__ out, Dims d,
                    int pix_per_split) {
  __shared__ float As[BK][BM + 1];  // As[p][r]
  __shared__ float Bs[BK][BN + 1];  // Bs[p][co]
  const int b = blockIdx.z % d.B;
  const int part = blockIdx.z / d.B;
  const int P = d.OH * d.OW;
  const int R = 9 * d.Cin;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int p0 = part * pix_per_split;
  const int p1 = min(P, p0 + pix_per_split);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* xb = x + static_cast<size_t>(b) * d.H * d.W * d.Cin;
  const T* dyb = dy + static_cast<size_t>(b) * P * d.Cout;

  // A loader: a fixed row (tap, ci) per thread, ci fastest across threads
  const int a_r = tid % BM;
  const int a_p0 = tid / BM;  // 0..3
  const int row = r0 + a_r;
  const bool row_ok = row < R;
  const int tap = row_ok ? row / d.Cin : 0;
  const int ci = row - tap * d.Cin;
  const int ky = tap / 3, kx = tap - (tap / 3) * 3;
  // B loader: a fixed column co per thread
  const int b_n = tid % BN;
  const int b_p0 = tid / BN;  // 0..3
  const int col = n0 + b_n;
  const bool col_ok = col < d.Cout;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int pb = p0; pb < p1; pb += BK) {
#pragma unroll
    for (int s = 0; s < BK / 4; ++s) {
      const int kk = a_p0 + 4 * s;
      const int p = pb + kk;
      float v = 0.0f;
      if (row_ok && p < p1) {
        const int oy = p / d.OW, ox = p - (p / d.OW) * d.OW;
        const int iy = 2 * oy + ky - 1, ix = 2 * ox + kx - 1;
        if (static_cast<unsigned>(iy) < static_cast<unsigned>(d.H) &&
            static_cast<unsigned>(ix) < static_cast<unsigned>(d.W))
          v = load(xb + (static_cast<size_t>(iy) * d.W + ix) * d.Cin + ci);
      }
      As[kk][a_r] = v;
    }
#pragma unroll
    for (int s = 0; s < BK / 4; ++s) {
      const int kk = b_p0 + 4 * s;
      const int p = pb + kk;
      Bs[kk][b_n] = (col_ok && p < p1) ? load(dyb + static_cast<size_t>(p) * d.Cout + col) : 0.0f;
    }
    __syncthreads();
    fma_tile(acc, As, Bs, tx, ty);
    __syncthreads();
  }

  O* ob = out + (static_cast<size_t>(part) * d.B + b) * R * d.Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < d.Cout) store(ob + static_cast<size_t>(r) * d.Cout + c, acc[i][j]);
    }
  }
}

// out[i] = sum over the parts of ws[part * total + i], in part order
template <typename O>
__global__ void __launch_bounds__(THREADS)
odconv_s2_bwd_reduce(const float* __restrict__ ws, O* __restrict__ out, int split, size_t total) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = 0.0f;
  for (int s = 0; s < split; ++s) acc += __ldg(ws + s * total + i);
  store(out + i, acc);
}

Dims make_dims(int B, int H, int W, int Cin, int Cout) { return Dims{B, H, W, Cin, Cout, H / 2, W / 2}; }

template <typename T>
int launch_dx(const void* dy, const void* w, void* dx, int B, int H, int W, int Cin, int Cout, cudaStream_t st) {
  const Dims d = make_dims(B, H, W, Cin, Cout);
  const int M = d.OH * d.OW;
  if (B == 0 || M == 0 || Cin == 0) return 0;
  const dim3 grid((M + BM - 1) / BM, (Cin + BN - 1) / BN, B * 4);
  odconv_s2_dx_kernel<T><<<grid, THREADS, 0, st>>>(static_cast<const T*>(dy), static_cast<const T*>(w),
                                                   static_cast<T*>(dx), d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dw(const void* x, const void* dy, void* dw, void* ws, int B, int H, int W, int Cin, int Cout, int split,
              cudaStream_t st) {
  const Dims d = make_dims(B, H, W, Cin, Cout);
  const int P = d.OH * d.OW;
  const int R = 9 * Cin;
  if (split < 1 || (split > 1 && ws == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || R == 0 || Cout == 0) return 0;
  const int steps = (P + BK - 1) / BK;
  const int pix_per_split = ((steps + split - 1) / split) * BK;
  const dim3 grid((R + BM - 1) / BM, (Cout + BN - 1) / BN, B * split);
  if (split == 1) {
    odconv_s2_dw_kernel<T, T><<<grid, THREADS, 0, st>>>(static_cast<const T*>(x), static_cast<const T*>(dy),
                                                        static_cast<T*>(dw), d, pix_per_split);
    return static_cast<int>(cudaGetLastError());
  }
  odconv_s2_dw_kernel<T, float><<<grid, THREADS, 0, st>>>(static_cast<const T*>(x), static_cast<const T*>(dy),
                                                          static_cast<float*>(ws), d, pix_per_split);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const size_t total = static_cast<size_t>(B) * R * Cout;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  odconv_s2_bwd_reduce<T><<<blocks, THREADS, 0, st>>>(static_cast<const float*>(ws), static_cast<T*>(dw), split,
                                                      total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous tensors: dy (B, H/2, W/2, Cout), wmix (B, 3, 3, Cin, Cout),
// x and dx (B, H, W, Cin), dwmix (B, 3, 3, Cin, Cout); `stream` is a
// cudaStream_t. Each returns cudaGetLastError() after its launches.
extern "C" int odconv_s2_dx_f32(const void* dy, const void* w, void* dx, int B, int H, int W, int Cin, int Cout,
                                void* stream) {
  return launch_dx<float>(dy, w, dx, B, H, W, Cin, Cout, static_cast<cudaStream_t>(stream));
}

extern "C" int odconv_s2_dx_bf16(const void* dy, const void* w, void* dx, int B, int H, int W, int Cin, int Cout,
                                 void* stream) {
  return launch_dx<__nv_bfloat16>(dy, w, dx, B, H, W, Cin, Cout, static_cast<cudaStream_t>(stream));
}

// `split` parts of the pixel reduction, each ceil(ceil(P/32)/split) 32-pixel
// steps; for split > 1, `ws` holds split*B*9*Cin*Cout floats.
extern "C" int odconv_s2_dw_f32(const void* x, const void* dy, void* dw, void* ws, int B, int H, int W, int Cin,
                                int Cout, int split, void* stream) {
  return launch_dw<float>(x, dy, dw, ws, B, H, W, Cin, Cout, split, static_cast<cudaStream_t>(stream));
}

extern "C" int odconv_s2_dw_bf16(const void* x, const void* dy, void* dw, void* ws, int B, int H, int W, int Cin,
                                 int Cout, int split, void* stream) {
  return launch_dw<__nv_bfloat16>(x, dy, dw, ws, B, H, W, Cin, Cout, split, static_cast<cudaStream_t>(stream));
}
