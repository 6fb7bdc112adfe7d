// conv_int8: an int8 x int8 -> int32 convolution with a per-output-channel
// dequant, for every ConvRaw that int8 serving quantizes.
//
// Replaces, on the GPU, the JAX package's int8 conv, which is XLA and not
// Pallas: `jax.lax.conv_general_dilated(x_q, w_q, ...,
// preferred_element_type=jnp.int32)` followed by
// `y.astype(f32) * (s_a * w_scale) + bias` in ConvRaw._int8_forward
// (yolosomi_tpu/models/layers.py:238-246). PyTorch has no int8 convolution
// on CUDA (F.conv2d refuses int8 tensors there), so the port brings its
// own. The plain version is conv_int8_reference in
// yolosomi_tpu_torch/ops/int8.py: an im2col and a product in float64, exact
// for these sums (at most 7*7*1024 products of 127*127, far below 2**53).
//
//   x (B, H, W, C) int8 NHWC, w (N, kh, kw, C/groups) int8 (OHWI: the
//   reduction axis contiguous), scale (N,) f32 = s_a * w_scale, bias (N,)
//   f32 or null -> out (B, Ho, Wo, N): int32 accumulators (OUT_I32), or
//   float(acc) * scale + bias (two roundings, no FMA: the plain version's
//   and XLA's mul then add) stored as f32 or bf16 (round to nearest even).
//
// What bounds it on an H100: at the flagship's serving shapes (640 px,
// batch 8) most ConvRaws are 1x1 or 3x3 convs with K = kh*kw*C of 64 to
// 4608 and N of 20 to 1024. Their operations run at the dense int8
// tensor-core rate (1,979 TOP/s); their bytes are one int8 read of x and
// one f32/bf16 write of the output. Most are bound by bytes (a 1x1 conv of
// 64 channels is 2*64 operations per 64+2*64 bytes); the 3x3 convs of 256
// channels and more are bound by operations. chip_smoke.py prints each
// shape's bound.
//
// Design (a first, simple kernel: correct before fast):
// - groups == 1: an implicit GEMM, M = B*Ho*Wo output pixels, N output
//   channels, K = kh*kw*C in (ky, kx, c) order. A block of 128 threads
//   (4 warps, 2 x 2) computes a 64 x 64 output tile; each warp 32 x 32 as
//   2 x 4 mma.sync.m16n8k32 s8 products per 32 of K, int32 accumulators in
//   registers. The K loop steps by 64 through two shared-memory buffers of
//   64 rows of A (pixels) and B (channels), each row 64 bytes padded to 80
//   so the fragment loads are free of bank conflicts. The next step's
//   tiles are loaded into registers while the tensor cores work on this
//   one. Where C is a multiple of 16 (and x and w are 16-byte aligned) a
//   thread gathers 16 bytes of one tap at a time (VEC); else, for the
//   first conv's C = 3 and the EMA-CBAM spatial gate's narrow input, byte
//   by byte, each byte's tap decoded on its own. Padding and the ragged
//   edges of M, N and K load zeros.
// - groups > 1 (SEAM's depthwise convs, grouped Bottlenecks): a direct
//   loop, one thread per output value, channels fastest, so a depthwise
//   conv's loads of x are coalesced. These convs do 9 products per output
//   and are bound by bytes.
// What remains for a later PR: wgmma with TMA-fed tiles, the quantize
// (x / s_a, round, clip) fused into the A load instead of a separate pass
// over x in PyTorch, and the next layer's BatchNorm and SiLU fused into
// the epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int OUT_F32 = 0;
constexpr int OUT_BF16 = 1;
constexpr int OUT_I32 = 2;

constexpr int BM = 64;        // output pixels per block tile
constexpr int BN = 64;        // output channels per block tile
constexpr int BK = 64;        // reduction bytes per K step
constexpr int ROW = BK + 16;  // padded shared-memory row: 20 words, conflict-free fragment loads
constexpr int GEMM_THREADS = 128;
constexpr int DIRECT_THREADS = 256;

struct ConvShape {
  int B, H, W, C;   // input NHWC
  int Ho, Wo, N;    // output
  int kh, kw, sh, sw, ph, pw, dh, dw, groups;
  int K;            // kh * kw * C / groups
  int M;            // B * Ho * Wo
};

// One output value's epilogue: the raw accumulator, or its dequant.
template <int OUT>
__device__ __forceinline__ void store_out(void* out, size_t i, int acc, const float* scale, const float* bias,
                                          int n) {
  if constexpr (OUT == OUT_I32) {
    static_cast<int*>(out)[i] = acc;
  } else {
    float v = __fmul_rn(__int2float_rn(acc), scale[n]);
    if (bias != nullptr) v = __fadd_rn(v, bias[n]);
    if constexpr (OUT == OUT_F32) {
      static_cast<float*>(out)[i] = v;
    } else {
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
    }
  }
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The input pixel a row of the A tile gathers from: its image, and the
// top-left corner of its receptive field (before dilation), or live =
// false past the last output pixel.
struct RowOrigin {
  const int8_t* img;
  int iy0, ix0;
  bool live;
};

__device__ __forceinline__ RowOrigin row_origin(const int8_t* x, const ConvShape& s, int m) {
  RowOrigin r{x, 0, 0, m < s.M};
  if (r.live) {
    const int hw = s.Ho * s.Wo;
    const int b = m / hw;
    const int rem = m - b * hw;
    const int oy = rem / s.Wo;
    const int ox = rem - oy * s.Wo;
    r.img = x + static_cast<size_t>(b) * s.H * s.W * s.C;
    r.iy0 = oy * s.sh - s.ph;
    r.ix0 = ox * s.sw - s.pw;
  }
  return r;
}

// A's byte at reduction index k of a row (0 off the map or past K).
__device__ __forceinline__ int8_t a_byte(const RowOrigin& r, const ConvShape& s, int k) {
  if (!r.live || k >= s.K) return 0;
  const int tap = k / s.C;
  const int c = k - tap * s.C;
  const int ky = tap / s.kw;
  const int iy = r.iy0 + ky * s.dh;
  const int ix = r.ix0 + (tap - ky * s.kw) * s.dw;
  if (iy < 0 || iy >= s.H || ix < 0 || ix >= s.W) return 0;
  return r.img[(static_cast<size_t>(iy) * s.W + ix) * s.C + c];
}

// 16 bytes of A from reduction index k on: one tap's channels (VEC, C a
// multiple of 16) or 16 bytes decoded one by one.
template <bool VEC>
__device__ __forceinline__ uint4 load_a(const RowOrigin& r, const ConvShape& s, int k) {
  if constexpr (VEC) {
    if (!r.live || k >= s.K) return make_uint4(0, 0, 0, 0);
    const int tap = k / s.C;
    const int c = k - tap * s.C;
    const int ky = tap / s.kw;
    const int iy = r.iy0 + ky * s.dh;
    const int ix = r.ix0 + (tap - ky * s.kw) * s.dw;
    if (iy < 0 || iy >= s.H || ix < 0 || ix >= s.W) return make_uint4(0, 0, 0, 0);
    return *reinterpret_cast<const uint4*>(r.img + (static_cast<size_t>(iy) * s.W + ix) * s.C + c);
  } else {
    uint4 v;
    int8_t* bytes = reinterpret_cast<int8_t*>(&v);
#pragma unroll
    for (int j = 0; j < 16; ++j) bytes[j] = a_byte(r, s, k + j);
    return v;
  }
}

// 16 bytes of B (output channel n's weights) from reduction index k on.
template <bool VEC>
__device__ __forceinline__ uint4 load_b(const int8_t* w, const ConvShape& s, int n, int k) {
  if (n >= s.N) return make_uint4(0, 0, 0, 0);
  const int8_t* row = w + static_cast<size_t>(n) * s.K;
  if constexpr (VEC) {
    if (k >= s.K) return make_uint4(0, 0, 0, 0);
    return *reinterpret_cast<const uint4*>(row + k);
  } else {
    uint4 v;
    int8_t* bytes = reinterpret_cast<int8_t*>(&v);
#pragma unroll
    for (int j = 0; j < 16; ++j) bytes[j] = k + j < s.K ? row[k + j] : 0;
    return v;
  }
}

template <int OUT, bool VEC>
__global__ void __launch_bounds__(GEMM_THREADS)
conv_int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                      const float* __restrict__ bias, void* __restrict__ out, ConvShape s) {
  __shared__ __align__(16) int8_t sA[2][BM][ROW];
  __shared__ __align__(16) int8_t sB[2][BN][ROW];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // groupID of the mma fragments
  const int tig = lane & 3;  // thread in group
  const int wm = warp >> 1;  // the warp's 32 rows
  const int wn = warp & 1;   // the warp's 32 columns
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // this thread loads rows `lr` and `lr + 32` of both tiles, 16 bytes at
  // reduction offset `lk` of each K step
  const int lr = tid >> 2;
  const int lk = (tid & 3) * 16;
  const RowOrigin ra0 = row_origin(x, s, m0 + lr);
  const RowOrigin ra1 = row_origin(x, s, m0 + lr + 32);

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  const int steps = (s.K + BK - 1) / BK;
  uint4 a0 = load_a<VEC>(ra0, s, lk), a1 = load_a<VEC>(ra1, s, lk);
  uint4 b0 = load_b<VEC>(w, s, n0 + lr, lk), b1 = load_b<VEC>(w, s, n0 + lr + 32, lk);
  *reinterpret_cast<uint4*>(&sA[0][lr][lk]) = a0;
  *reinterpret_cast<uint4*>(&sA[0][lr + 32][lk]) = a1;
  *reinterpret_cast<uint4*>(&sB[0][lr][lk]) = b0;
  *reinterpret_cast<uint4*>(&sB[0][lr + 32][lk]) = b1;
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    const bool more = t + 1 < steps;
    if (more) {  // the next step's loads in flight during this step's products
      const int k = (t + 1) * BK + lk;
      a0 = load_a<VEC>(ra0, s, k);
      a1 = load_a<VEC>(ra1, s, k);
      b0 = load_b<VEC>(w, s, n0 + lr, k);
      b1 = load_b<VEC>(w, s, n0 + lr + 32, k);
    }
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + g;
        af[i][0] = *reinterpret_cast<const uint32_t*>(&sA[buf][r][ks + tig * 4]);
        af[i][1] = *reinterpret_cast<const uint32_t*>(&sA[buf][r + 8][ks + tig * 4]);
        af[i][2] = *reinterpret_cast<const uint32_t*>(&sA[buf][r][ks + 16 + tig * 4]);
        af[i][3] = *reinterpret_cast<const uint32_t*>(&sA[buf][r + 8][ks + 16 + tig * 4]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn * 32 + j * 8 + g;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(&sB[buf][c][ks + tig * 4]);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(&sB[buf][c][ks + 16 + tig * 4]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    if (more) {  // the other buffer: last read in step t - 1, before the barrier that ended it
      *reinterpret_cast<uint4*>(&sA[buf ^ 1][lr][lk]) = a0;
      *reinterpret_cast<uint4*>(&sA[buf ^ 1][lr + 32][lk]) = a1;
      *reinterpret_cast<uint4*>(&sB[buf ^ 1][lr][lk]) = b0;
      *reinterpret_cast<uint4*>(&sB[buf ^ 1][lr + 32][lk]) = b1;
    }
    __syncthreads();
  }

  // accumulator (i, j): rows g and g + 8 of the warp's m16 tile i, columns
  // 2 * tig and 2 * tig + 1 of its n8 tile j
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 32 + i * 16 + g + half * 8;
      if (m >= s.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = n0 + wn * 32 + j * 8 + tig * 2 + q;
          if (n < s.N) store_out<OUT>(out, static_cast<size_t>(m) * s.N + n, acc[i][j][half * 2 + q], scale, bias, n);
        }
      }
    }
  }
}

// groups > 1: one thread per output value (pixel m, channel n), channels
// fastest; the sum over the taps and the group's C/groups input channels.
template <int OUT>
__global__ void __launch_bounds__(DIRECT_THREADS)
conv_int8_direct_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                        const float* __restrict__ bias, void* __restrict__ out, ConvShape s) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * DIRECT_THREADS + threadIdx.x;
  if (idx >= static_cast<size_t>(s.M) * s.N) return;
  const int n = static_cast<int>(idx % s.N);
  const int m = static_cast<int>(idx / s.N);
  const int cin_g = s.C / s.groups;
  const int c0 = (n / (s.N / s.groups)) * cin_g;
  const RowOrigin r = row_origin(x, s, m);
  const int8_t* wn = w + static_cast<size_t>(n) * s.K;
  int acc = 0;
  for (int ky = 0; ky < s.kh; ++ky) {
    const int iy = r.iy0 + ky * s.dh;
    if (iy < 0 || iy >= s.H) continue;
    for (int kx = 0; kx < s.kw; ++kx) {
      const int ix = r.ix0 + kx * s.dw;
      if (ix < 0 || ix >= s.W) continue;
      const int8_t* xp = r.img + (static_cast<size_t>(iy) * s.W + ix) * s.C + c0;
      const int8_t* wp = wn + (ky * s.kw + kx) * cin_g;
      for (int c = 0; c < cin_g; ++c) acc += static_cast<int>(xp[c]) * static_cast<int>(wp[c]);
    }
  }
  store_out<OUT>(out, idx, acc, scale, bias, n);
}

template <int OUT>
int launch(const int8_t* x, const int8_t* w, const float* scale, const float* bias, void* out, const ConvShape& s,
           int vec, cudaStream_t stream) {
  if (s.groups == 1) {
    const dim3 grid((s.M + BM - 1) / BM, (s.N + BN - 1) / BN);
    if (vec) {
      conv_int8_gemm_kernel<OUT, true><<<grid, GEMM_THREADS, 0, stream>>>(x, w, scale, bias, out, s);
    } else {
      conv_int8_gemm_kernel<OUT, false><<<grid, GEMM_THREADS, 0, stream>>>(x, w, scale, bias, out, s);
    }
  } else {
    const size_t total = static_cast<size_t>(s.M) * s.N;
    const unsigned blocks = static_cast<unsigned>((total + DIRECT_THREADS - 1) / DIRECT_THREADS);
    conv_int8_direct_kernel<OUT><<<blocks, DIRECT_THREADS, 0, stream>>>(x, w, scale, bias, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (ctypes). Contiguous tensors; x and w int8, scale and bias
// float32 (bias may be null; scale is unused and may be null for
// out_kind 2), out float32 (0), bfloat16 (1) or int32 (2). `vec`: the
// 16-byte gathers (C % 16 == 0, groups == 1, x and w 16-byte aligned).
// `stream` is a cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int conv_int8(const void* x, const void* w, const void* scale, const void* bias, void* out, int B, int H,
                         int W, int C, int Ho, int Wo, int N, int kh, int kw, int sh, int sw, int ph, int pw, int dh,
                         int dw, int groups, int out_kind, int vec, void* stream) {
  const ConvShape s{B, H, W, C, Ho, Wo, N, kh, kw, sh, sw, ph, pw, dh, dw, groups, kh * kw * (C / groups),
                    B * Ho * Wo};
  if (s.M == 0 || s.N == 0) return static_cast<int>(cudaGetLastError());
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  const auto* bp = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case OUT_F32: return launch<OUT_F32>(xp, wp, sp, bp, out, s, vec, st);
    case OUT_BF16: return launch<OUT_BF16>(xp, wp, sp, bp, out, s, vec, st);
    case OUT_I32: return launch<OUT_I32>(xp, wp, sp, bp, out, s, vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
