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
// Both paths are a per-sample implicit GEMM. For sample b, M = oh*ow output
// pixels, N = Cout, K = 9*Cin. A[m, k] is gathered from x on the fly
// (iy = 2*oy + ky - 1, ix = 2*ox + kx - 1, zero outside the image), so the
// patch matrix never exists in device memory; B is wmix[b] viewed as
// (9*Cin, Cout), row-major as stored. Every sample has its own B matrix, so
// the batch is a grid axis and nothing is shared across samples. The TPU
// kernel's parity planes, double-buffered row band and 2-plane channel
// packing were answers to VMEM tiling and 128-lane alignment; on Hopper the
// stride-2 gather is address arithmetic.
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
//
// bf16 (the serving path): a wgmma GEMM fed by an asynchronous ring.
// - A is copied into shared memory 16 bytes (8 channels) at a time with
//   cp.async; Cin % 8 == 0 keeps each vector inside one tap. A thread's
//   vectors always sit in one column of the tile, so it carries (tap,
//   channel) from K step to K step by addition, with no division; the
//   output pixel of each of its rows is decoded once. Padding, ragged M and
//   the end of K use cp.async's zero-fill form (src-size 0), not branches.
// - B tiles are plain row-major boxes of wmix[b] (N-major for wgmma),
//   through the same ring.
// - Shared memory holds both in wgmma's 128-byte-swizzled layout, K step
//   64 (one 128-byte swizzle atom a row); each warpgroup multiplies its 64
//   rows with wgmma.mma_async m64nNk16 (bf16 in, f32 accumulators in
//   registers), operands read through shared-memory descriptors.
// - A ring of STAGES stages, DIST of them loaded ahead: a stage's loads are
//   in flight while earlier stages are multiplied; one barrier per K step;
//   fence.proxy.async hands cp.async's writes to wgmma.
// - Two tile configurations, chosen per call by ops/odconv.py::_plan:
//   128x128 (2 warpgroups, 3 stages, 2 blocks an SM) where Cout <= 128,
//   128x256 (4 stages, one wgmma group left in flight) where Cout > 128.
//   Where the tiles leave the card under-filled (row 32: 32 tiles), K is
//   split; the parts write f32 partial sums to a workspace that
//   odconv_s2_splitk_reduce adds in a fixed order: no atomics, the same
//   bits every run.
// - The epilogue rounds the accumulators to bf16 in registers, swaps them
//   within each lane quad so that every lane holds 8 consecutive channels
//   of one row, and writes 16-byte vectors straight to `out`.
// No TMA (the A gather is not a box) and no persistent schedule yet.
//
// f32 (the parity check's path): FMA in registers, a 4x4 micro-tile per
// thread over 64x32 and 32x64 shared tiles, scalar gathers; any Cin, Cout.

#include "sm90_gemm.cuh"

namespace {

struct Shape {
  int H, W, Cin, Cout, OW, M, K;
};

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

// ---------------------------------------------------------------------------
// f32
// ---------------------------------------------------------------------------

constexpr int F_BM = 64;  // output pixels per block
constexpr int F_BN = 64;  // output channels per block
constexpr int F_BK = 32;  // reduction chunk staged through shared memory

// A[m, k] of one sample: the input value under tap (ky, kx) = (k / Cin) of
// output pixel m, channel k % Cin; zero in the padding and past the edges.
__device__ __forceinline__ float load_a(const float* __restrict__ xb, const Shape& s, int m, int k) {
  if (m >= s.M || k >= s.K) return 0.0f;
  const int tap = k / s.Cin;
  const int ci = k - tap * s.Cin;
  const int ky = tap / 3;
  const int kx = tap - ky * 3;
  const int oy = m / s.OW;
  const int ox = m - oy * s.OW;
  const int iy = 2 * oy + ky - 1;
  const int ix = 2 * ox + kx - 1;
  if (iy < 0 || iy >= s.H || ix < 0 || ix >= s.W) return 0.0f;
  return xb[(static_cast<size_t>(iy) * s.W + ix) * s.Cin + ci];
}

__device__ __forceinline__ float load_b(const float* __restrict__ wb, const Shape& s, int k, int n) {
  if (k >= s.K || n >= s.Cout) return 0.0f;
  return wb[static_cast<size_t>(k) * s.Cout + n];
}

// 256 threads, each owns rows ty + 16*i and columns tx + 16*j.
__global__ void __launch_bounds__(256)
odconv_s2_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
                     Shape s) {
  __shared__ float As[F_BK][F_BM + 4];  // transposed: As[k][m]
  __shared__ float Bs[F_BK][F_BN + 4];
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * F_BM;
  const int n0 = blockIdx.y * F_BN;
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

  for (int k0 = 0; k0 < s.K; k0 += F_BK) {
    // k fastest across threads: consecutive threads read consecutive channels
    for (int i = tid; i < F_BM * F_BK; i += 256) {
      const int mm = i / F_BK, kk = i % F_BK;
      As[kk][mm] = load_a(xb, s, m0 + mm, k0 + kk);
    }
    for (int i = tid; i < F_BK * F_BN; i += 256) {
      const int kk = i / F_BN, nn = i % F_BN;
      Bs[kk][nn] = load_b(wb, s, k0 + kk, n0 + nn);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
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

// ---------------------------------------------------------------------------
// bf16: cp.async ring + wgmma (building blocks in sm90_gemm.cuh)
// ---------------------------------------------------------------------------

struct GemmArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  __nv_bfloat16* out;
  float* ws;  // split-K partial sums (split, B, M, Cout); unused when split == 1
  Shape s;
  int B;
  int split;
  int kt_per_split;  // K steps per split
};

// A warp's 16-row strip of the accumulators, rows row0 .. row0+15 and
// columns col0 .. col0 + 8*NJ - 1, to out in bf16 (split == 1) or to the
// split's f32 partial sums.
template <int NJ>
__device__ __forceinline__ void store_strip(const float (*acc)[4], const GemmArgs& a, int b, int split, int row0,
                                            int col0) {
  const Shape& s = a.s;
  if (a.split == 1) {
    const int lane = threadIdx.x % 32;
    const int m = row0 + lane / 4 + 8 * ((lane % 4) & 1);  // the row store_bf16_row gives this lane
    store_bf16_row<NJ>(acc, m < s.M ? a.out + (static_cast<size_t>(b) * s.M + m) * s.Cout : nullptr, col0, s.Cout);
  } else {
    store_f32_strip<NJ>(acc, a.ws + (static_cast<size_t>(split) * a.B + b) * s.M * s.Cout, s.Cout, row0, s.M, col0,
                        s.Cout);
  }
}

// Block tile 128 x BN (two warpgroups, 64 rows each), K step 64: one
// 128-byte swizzle atom per row of A (K-major) and per 64 columns of B
// (N-major, as wmix is stored). DIST = 2 stages are loaded ahead; the wgmma
// of STAGES - DIST - 1 earlier stages may still run while a stage loads.
template <int BN_, int STAGES_>
struct Tile {
  static constexpr int BM = 128, BN = BN_, BK = 64, STAGES = STAGES_, DIST = 2, THREADS = 256;
  // A stage: [BM][64] swizzled; B stage: BN/64 panels [64 k][64 n] swizzled
  static constexpr int A_STAGE = BM * BK, B_STAGE = BK * BN;            // elements, multiples of 512
  static constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) * 2 + 1024;  // + room to align to 1024
  static constexpr int A_ITERS = BM * 8 / THREADS, B_ITERS = BK * BN / 8 / THREADS;
  static constexpr int A_ROW_STEP = THREADS / 8, B_VPR = BN / 8, B_ROW_STEP = THREADS / B_VPR;
  static_assert(BN % 64 == 0 && BK * BN / 8 % THREADS == 0 && THREADS % B_VPR == 0, "loader shape");
  static_assert(STAGES > DIST, "ring depth");
};

// The configurations ops/odconv.py::_plan chooses from (keep the two in
// step: the card tests compare _smem_bytes with odconv_s2_bf16_smem).
// 128x128 where Cout <= 128 (two blocks fit an SM, so one block's loads and
// barrier overlap the other's products); 128x256 where Cout > 128 (A is
// gathered once for 256 output channels; one block an SM, so a deeper ring
// and one wgmma group kept in flight instead).
using Tile0 = Tile<128, 3>;
using Tile1 = Tile<256, 4>;

template <class T>
__global__ void __launch_bounds__(T::THREADS)
odconv_s2_bf16_wgmma_kernel(GemmArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw + (((raw + 1023u) & ~1023u) - raw));
  __nv_bfloat16* Bs = As + T::STAGES * T::A_STAGE;
  const Shape& s = a.s;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int b = blockIdx.z % a.B;
  const int split = blockIdx.z / a.B;
  const int nk_total = (s.K + T::BK - 1) / T::BK;
  const int kt0 = split * a.kt_per_split;
  const int nk = min(nk_total, kt0 + a.kt_per_split) - kt0;
  const __nv_bfloat16* xb = a.x + static_cast<size_t>(b) * s.H * s.W * s.Cin;
  const __nv_bfloat16* wb = a.w + static_cast<size_t>(b) * s.K * s.Cout;

  // A loader: this thread's rows and their input-pixel origins, decoded
  // once; a fixed column of 16-byte vectors, (tap, ci) carried from stage
  // to stage
  const int a_vc = tid % 8;
  const int a_row = tid / 8;
  int a_iy0[T::A_ITERS], a_ix0[T::A_ITERS];
  bool a_ok[T::A_ITERS];
#pragma unroll
  for (int i = 0; i < T::A_ITERS; ++i) {
    const int m = m0 + a_row + i * T::A_ROW_STEP;
    const int oy = m / s.OW;
    a_ok[i] = m < s.M;
    a_iy0[i] = 2 * oy - 1;
    a_ix0[i] = 2 * (m - oy * s.OW) - 1;
  }
  int a_k = kt0 * T::BK + a_vc * 8;  // the k of this thread's vector in the next stage to load
  int tap = a_k / s.Cin;
  int ci = a_k - tap * s.Cin;
  // B loader: a fixed 8-channel column of the tile
  const int b_vc = tid % T::B_VPR;
  const int b_row = tid / T::B_VPR;
  const bool b_nok = n0 + b_vc * 8 < s.Cout;

  auto load_stage = [&](int slot, int kt) {
    __nv_bfloat16* as = As + slot * T::A_STAGE;
    __nv_bfloat16* bs = Bs + slot * T::B_STAGE;
    const bool k_ok = a_k < s.K;
    const int ky = tap >= 6 ? 2 : (tap >= 3 ? 1 : 0);
    const int kx = tap - 3 * ky;
#pragma unroll
    for (int i = 0; i < T::A_ITERS; ++i) {
      const int r = a_row + i * T::A_ROW_STEP;
      const int iy = a_iy0[i] + ky;
      const int ix = a_ix0[i] + kx;
      const bool ok = k_ok && a_ok[i] && static_cast<unsigned>(iy) < static_cast<unsigned>(s.H) &&
                      static_cast<unsigned>(ix) < static_cast<unsigned>(s.W);
      const __nv_bfloat16* src = ok ? xb + (static_cast<size_t>(iy) * s.W + ix) * s.Cin + ci : xb;
      cp_async16(as + swizzled(r, a_vc), src, ok);
    }
    a_k += T::BK;
    ci += T::BK;
    while (ci >= s.Cin) {
      ci -= s.Cin;
      ++tap;
    }
#pragma unroll
    for (int i = 0; i < T::B_ITERS; ++i) {
      const int r = b_row + i * T::B_ROW_STEP;
      const int k = kt * T::BK + r;
      const bool ok = b_nok && k < s.K;
      const __nv_bfloat16* src = ok ? wb + static_cast<size_t>(k) * s.Cout + n0 + b_vc * 8 : wb;
      cp_async16(bs + (b_vc / 8) * (T::BK * 64) + swizzled(r, b_vc % 8), src, ok);
    }
  };

  float acc[T::BN / 2];
#pragma unroll
  for (int r = 0; r < T::BN / 2; ++r) acc[r] = 0.0f;

#pragma unroll
  for (int st = 0; st < T::DIST; ++st) {
    if (st < nk) load_stage(st, kt0 + st);
    cp_async_commit();
  }

  for (int it = 0; it < nk; ++it) {
    cp_async_wait<T::DIST - 1>();
    fence_proxy_async();
    // stage `it` is in shared memory; the wgmma that read the slot loaded
    // next (stage it + DIST - STAGES) has finished in every warpgroup
    __syncthreads();
    const int next = it + T::DIST;
    if (next < nk) load_stage(next % T::STAGES, kt0 + next);
    cp_async_commit();

    const __nv_bfloat16* as = As + (it % T::STAGES) * T::A_STAGE + wg * 64 * T::BK;
    const __nv_bfloat16* bs = Bs + (it % T::STAGES) * T::B_STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::BK / 16; ++kk) {
      // A: 8-row groups 1024 bytes apart, k16 step = 32 bytes inside the
      // atom; B: 8-k-row groups 1024 bytes apart, the second 64 columns
      // one panel (BK*128 bytes) on, k16 step = two groups
      Wgmma<T::BN, 0, 1>::k16(acc, gmma_desc(as + kk * 16, 16, 1024), gmma_desc(bs + kk * 16 * 64, T::BK * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait<T::STAGES - T::DIST - 1>();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  // warp w of the warpgroup holds rows 16w .. 16w+15 of its 64, as BN/8
  // fragments of 4 registers
  store_strip<T::BN / 8>(reinterpret_cast<const float(*)[4]>(acc), a, b, split, m0 + wg * 64 + (tid % 128) / 32 * 16,
                         n0);
}

// out = sum over the splits of ws (split, total), in split order; 8
// elements a thread, 16-byte bf16 stores. total % 8 == 0.
__global__ void __launch_bounds__(256)
odconv_s2_splitk_reduce(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out, int split, size_t total) {
  splitk_sum8(ws, out, split, total);
}

template <class T, class Kernel>
int launch(Kernel kernel, GemmArgs a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nk = (a.s.K + T::BK - 1) / T::BK;
  a.kt_per_split = (nk + a.split - 1) / a.split;
  const dim3 grid((a.s.M + T::BM - 1) / T::BM, (a.s.Cout + T::BN - 1) / T::BN, a.B * a.split);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_cfg(int cfg, const GemmArgs& a, cudaStream_t st) {
  switch (cfg) {
    case 0: return launch<Tile0>(odconv_s2_bf16_wgmma_kernel<Tile0>, a, st);
    case 1: return launch<Tile1>(odconv_s2_bf16_wgmma_kernel<Tile1>, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous tensors; `stream` is a cudaStream_t. Each returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int odconv_s2_f32(const void* x, const void* w, void* out, int B, int H, int W, int Cin, int Cout,
                             void* stream) {
  const Shape s = make_shape(H, W, Cin, Cout);
  const dim3 grid((s.M + F_BM - 1) / F_BM, (s.Cout + F_BN - 1) / F_BN, B);
  odconv_s2_f32_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of tile configuration `cfg` in bytes, or -1 if there is none.
extern "C" int odconv_s2_bf16_smem(int cfg) {
  switch (cfg) {
    case 0: return Tile0::SMEM;
    case 1: return Tile1::SMEM;
    default: return -1;
  }
}

// bf16 with the launch plan of ops/odconv.py::_plan: tile configuration
// `cfg`, K cut into `split` parts of ceil(ceil(K/64)/split) K steps each.
// Needs Cin % 8 == 0, Cout % 8 == 0 and 16-byte-aligned pointers; for
// split > 1, `ws` holds split*B*(H/2)*(W/2)*Cout floats.
extern "C" int odconv_s2_bf16(const void* x, const void* w, void* out, void* ws, int B, int H, int W, int Cin,
                              int Cout, int cfg, int split, void* stream) {
  const Shape s = make_shape(H, W, Cin, Cout);
  if (Cin % 8 != 0 || Cout % 8 != 0 || split < 1 || (split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || s.M == 0 || Cout == 0) return 0;
  const GemmArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
                  static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), s, B, split, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = launch_cfg(cfg, a, st);
  if (rc != 0 || split == 1) return rc;
  const size_t total = static_cast<size_t>(B) * s.M * Cout;
  const unsigned blocks = static_cast<unsigned>((total / 8 + 255) / 256);
  odconv_s2_splitk_reduce<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                                  static_cast<__nv_bfloat16*>(out), split, total);
  return static_cast<int>(cudaGetLastError());
}
