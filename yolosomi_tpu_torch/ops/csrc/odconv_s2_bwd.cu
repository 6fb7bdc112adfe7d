// The backward of odconv_s2 (csrc/odconv_s2.cu): the per-sample-weight
// 3x3 stride-2 convolution with padding 1,
//     y[b, oy, ox, co] = sum_{ky,kx,ci} x[b, 2oy+ky-1, 2ox+kx-1, ci] * wmix[b, ky, kx, ci, co]
// with x (B, H, W, Cin) NHWC, wmix (B, 3, 3, Cin, Cout), y (B, H/2, W/2, Cout).
//
// Replaces XLA's VJP of the JAX package's batch-grouped vmap conv
// (yolosomi_tpu/models/layers.py:874-875: the Pallas kernel
// odconv_s2_pallas, yolosomi_tpu/ops/odconv_pallas.py:111, has no VJP, so
// JAX trains ODConv through the vmap conv). Plain PyTorch versions:
// autograd of odconv_s2_reference (ops/odconv.py).
//
// Two gradients, each a GEMM per sample, accumulated in f32:
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
//   px), so where the output tiles do not fill the card it is cut into
//   `split` parts of whole K steps; each part writes f32 partial sums to a
//   workspace and a second pass adds the parts in a fixed order. No float
//   atomics: two calls give the same bits.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM): each
// gradient does the forward's 2*B*M*Cout*9*Cin FLOPs, 113.2 GFLOP for a b8
// step of the flagship at 640 px (rows 1, 26, 29, 32), and reads and
// writes 36-77 MB a step: bound by operations, 0.114 ms at 989 TFLOP/s.
// So the tensor cores must be fed; the f32 FMA pipes (67 TFLOP/s at best,
// and the first form of these kernels reached 15) cannot be the path.
//
// bf16 (the training path): tensor-core implicit GEMMs of the forward's
// family (building blocks in sm90_gemm.cuh). Operands are copied into
// shared memory 16 bytes (8 channels) at a time with cp.async through a
// ring of STAGES stages (DIST loaded ahead), zero-filled (src-size 0) in the
// padding, past ragged M, N and K edges; shared memory holds them in
// wgmma's 128-byte-swizzled layout, K step 64; each warpgroup multiplies
// its 64 rows with wgmma.mma_async m64nNk16 (bf16 in, f32 accumulators in
// registers); the epilogue rounds to bf16 and writes 16-byte vectors.
// Block tiles are 128 x BN, chosen per call by ops/odconv.py (_dx_plan,
// _dw_plan; keep the tile tables there in step with the ones below).
// - dx: per (sample, parity class) a GEMM of the class's pixels by Cin.
//   A = dy gathered at the class's taps, co contiguous: K-major. B[(t, co),
//   ci] = wmix[b, t, ci, co], co contiguous: K-major as well, wgmma's
//   non-transposed B (the forward's B is N-major). A's and B's loaders share
//   one 16-byte column, so one (t, co) carried by addition addresses both,
//   and each A row's class pixel is decoded once. BN = 64, 128 or 256 (up
//   to Cin). The grid runs each sample's 4-tap class first and its 1-tap
//   class last (K in the ratio 4:2:2:1), so light blocks fill the tail of
//   the wave. The epilogue writes row m to pixel (2qy+py, 2qx+px): Cin
//   contiguous channels, 16-byte stores.
// - dwmix: A[(tap, ci), p] is 8 channels ci of one pixel a vector, so its
//   (tap, ci) rows are contiguous: A is M-major in shared memory and wgmma
//   reads it transposed (imm-trans-a, which bf16 allows from shared
//   memory). B = dy as stored, N-major (the forward's B). Each thread's 8
//   rows (tap, ci) are decoded once (Cin % 8 == 0 keeps them in one tap,
//   also where a 128-row tile spans two taps). BN = 128 or 256 (Cout).
// What bounds them then: the tensor cores where the tiles fill the card; at
// row 1, dx's N = Cin = 64 gives m64n64 products that read 4 KB of
// shared memory for 131 kFLOP (shared-memory bandwidth about matches the
// tensor rate), and dwmix has 40 output tiles over a 25 600-pixel
// reduction (hence the split and its f32 workspace); at rows 26 and 29
// 144 dwmix tiles make 1.09 waves of 132 SMs.
//
// f32 (the parity path): the simple first form, kept as it was: 64x64
// output tiles, 32-deep K steps staged through shared memory, a 4x4 FMA
// micro-tile per thread (256 threads), scalar loads; any Cin and Cout.
// Where dwmix's reduction is not split its result equals cuDNN's bits.

#include "sm90_gemm.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: FMA tiles
// ---------------------------------------------------------------------------

constexpr int BM = 64;  // output rows per block
constexpr int BN = 64;  // output columns per block
constexpr int BK = 32;  // reduction step staged through shared memory
constexpr int THREADS = 256;

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

// grid (ceil(OH*OW / BM), ceil(Cin / BN), B * 4): blockIdx.z = b * 4 + class,
// class = 2 * (iy % 2) + (ix % 2). Pixel m of a class is (qy, qx) =
// (m / OW, m % OW), iy = 2 qy + py, ix = 2 qx + px.
__global__ void __launch_bounds__(THREADS)
odconv_s2_dx_kernel(const float* __restrict__ dy, const float* __restrict__ w, float* __restrict__ dx, Dims d) {
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
  const float* dyb = dy + static_cast<size_t>(b) * M * d.Cout;
  const float* wb = w + static_cast<size_t>(b) * 9 * d.Cin * d.Cout;

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
            if (oy < d.OH && ox < d.OW) v = __ldg(dyb + (static_cast<size_t>(oy) * d.OW + ox) * d.Cout + co);
          }
          As[a_k][mm] = v;
        }
        const int cob = c0 + b_k;
#pragma unroll
        for (int r = 0; r < BN / 8; ++r) {
          const int nn = b_n0 + 8 * r;
          const int ci = n0 + nn;
          float v = 0.0f;
          if (ci < d.Cin && cob < d.Cout) v = __ldg(wb + (static_cast<size_t>(tap) * d.Cin + ci) * d.Cout + cob);
          Bs[b_k][nn] = v;
        }
        __syncthreads();
        fma_tile(acc, As, Bs, tx, ty);
        __syncthreads();
      }
    }
  }

  float* dxb = dx + static_cast<size_t>(b) * d.H * d.W * d.Cin;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const int qy = m / d.OW, qx = m - (m / d.OW) * d.OW;
    const size_t pix = static_cast<size_t>(2 * qy + py) * d.W + (2 * qx + px);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = n0 + tx + 16 * j;
      if (ci < d.Cin) dxb[pix * d.Cin + ci] = acc[i][j];
    }
  }
}

// grid (ceil(9*Cin / BM), ceil(Cout / BN), B * split): blockIdx.z =
// part * B + b. Rows r = tap * Cin + ci, columns co, the reduction over the
// pixels [p0, p1) of this part. `out` is the part's partial sums (split >
// 1, (split, B, 9*Cin, Cout)) or dwmix itself (split == 1).
__global__ void __launch_bounds__(THREADS)
odconv_s2_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy, float* __restrict__ out, Dims d,
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
  const float* xb = x + static_cast<size_t>(b) * d.H * d.W * d.Cin;
  const float* dyb = dy + static_cast<size_t>(b) * P * d.Cout;

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
          v = __ldg(xb + (static_cast<size_t>(iy) * d.W + ix) * d.Cin + ci);
      }
      As[kk][a_r] = v;
    }
#pragma unroll
    for (int s = 0; s < BK / 4; ++s) {
      const int kk = b_p0 + 4 * s;
      const int p = pb + kk;
      Bs[kk][b_n] = (col_ok && p < p1) ? __ldg(dyb + static_cast<size_t>(p) * d.Cout + col) : 0.0f;
    }
    __syncthreads();
    fma_tile(acc, As, Bs, tx, ty);
    __syncthreads();
  }

  float* ob = out + (static_cast<size_t>(part) * d.B + b) * R * d.Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < d.Cout) ob[static_cast<size_t>(r) * d.Cout + c] = acc[i][j];
    }
  }
}

// out[i] = sum over the parts of ws[part * total + i], in part order
__global__ void __launch_bounds__(THREADS)
odconv_s2_bwd_reduce(const float* __restrict__ ws, float* __restrict__ out, int split, size_t total) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = 0.0f;
  for (int s = 0; s < split; ++s) acc += __ldg(ws + s * total + i);
  out[i] = acc;
}

Dims make_dims(int B, int H, int W, int Cin, int Cout) { return Dims{B, H, W, Cin, Cout, H / 2, W / 2}; }

int launch_dx_f32(const void* dy, const void* w, void* dx, int B, int H, int W, int Cin, int Cout, cudaStream_t st) {
  const Dims d = make_dims(B, H, W, Cin, Cout);
  const int M = d.OH * d.OW;
  if (B == 0 || M == 0 || Cin == 0) return 0;
  const dim3 grid((M + BM - 1) / BM, (Cin + BN - 1) / BN, B * 4);
  odconv_s2_dx_kernel<<<grid, THREADS, 0, st>>>(static_cast<const float*>(dy), static_cast<const float*>(w),
                                                static_cast<float*>(dx), d);
  return static_cast<int>(cudaGetLastError());
}

int launch_dw_f32(const void* x, const void* dy, void* dw, void* ws, int B, int H, int W, int Cin, int Cout, int split,
                  cudaStream_t st) {
  const Dims d = make_dims(B, H, W, Cin, Cout);
  const int P = d.OH * d.OW;
  const int R = 9 * Cin;
  if (split < 1 || (split > 1 && ws == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || R == 0 || Cout == 0) return 0;
  const int steps = (P + BK - 1) / BK;
  const int pix_per_split = ((steps + split - 1) / split) * BK;
  const dim3 grid((R + BM - 1) / BM, (Cout + BN - 1) / BN, B * split);
  odconv_s2_dw_kernel<<<grid, THREADS, 0, st>>>(static_cast<const float*>(x), static_cast<const float*>(dy),
                                                static_cast<float*>(split == 1 ? dw : ws), d, pix_per_split);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || split == 1) return rc;
  const size_t total = static_cast<size_t>(B) * R * Cout;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  odconv_s2_bwd_reduce<<<blocks, THREADS, 0, st>>>(static_cast<const float*>(ws), static_cast<float*>(dw), split,
                                                   total);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: cp.async ring + wgmma
// ---------------------------------------------------------------------------

// Block tile 128 x BN_ (two warpgroups, 64 rows each), K step 64: one
// 128-byte swizzle row. STAGES_ stages in the ring, DIST = 2 of them loaded
// ahead, so the wgmma of STAGES_ - DIST - 1 earlier stages may still run
// while a stage loads. PER_SM_ blocks fit one SM: their shared memory, and
// registers capped by the launch bounds.
template <int BN_, int STAGES_, int PER_SM_>
struct Tile {
  static constexpr int BM = 128, BN = BN_, BK = 64, STAGES = STAGES_, DIST = 2, PER_SM = PER_SM_, THREADS = 256;
  static constexpr int A_STAGE = BM * BK, B_STAGE = BK * BN;            // elements, multiples of 512
  static constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) * 2 + 1024;  // + room to align to 1024
  static_assert(BN % 64 == 0 && STAGES > DIST, "tile shape");
};

// The configurations of ops/odconv.py's _DX_TILES and _DW_TILES (keep them
// in step: the card tests compare _bwd_smem_bytes with
// odconv_s2_bwd_bf16_smem). dx: BN up to Cin; dwmix: BN up to Cout. 128 x
// 64 and 128 x 128 tiles fit two blocks an SM, so one block's loads and
// barrier overlap the other's products; 128 x 256 tiles fit one, with a
// deeper ring and one wgmma group left in flight.
using DxTile0 = Tile<64, 4, 2>;
using DxTile1 = Tile<128, 3, 2>;
using DxTile2 = Tile<256, 4, 1>;
using DwTile0 = Tile<128, 3, 2>;
using DwTile1 = Tile<256, 4, 1>;

// The ring every bf16 kernel runs: `load(slot, kt)` issues stage kt's
// cp.async copies into ring slot `slot`, `mma(slot)` issues the wgmma of
// the stage in that slot. One barrier per K step: after it, stage `it` is
// in shared memory and the wgmma that read the slot loaded next (stage
// it + DIST - STAGES) has finished in every warpgroup.
template <class T, class Load, class Mma>
__device__ __forceinline__ void run_ring(int nk, Load&& load, Mma&& mma) {
#pragma unroll
  for (int st = 0; st < T::DIST; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<T::DIST - 1>();
    fence_proxy_async();
    __syncthreads();
    const int next = it + T::DIST;
    if (next < nk) load(next % T::STAGES, next);
    cp_async_commit();
    wgmma_fence();
    mma(it % T::STAGES);
    wgmma_commit();
    wgmma_wait<T::STAGES - T::DIST - 1>();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
}

// The ring's two operand arrays in dynamic shared memory, aligned to the
// swizzle's 1024 bytes.
__device__ __forceinline__ __nv_bfloat16* ring_base(unsigned char* smem_raw) {
  const uint32_t raw = smem_addr(smem_raw);
  return reinterpret_cast<__nv_bfloat16*>(smem_raw + (((raw + 1023u) & ~1023u) - raw));
}

struct DxArgs {
  const __nv_bfloat16* dy;  // (B, OH, OW, Cout)
  const __nv_bfloat16* w;   // (B, 3, 3, Cin, Cout)
  __nv_bfloat16* dx;        // (B, H, W, Cin)
  Dims d;
};

// grid (ceil(OH*OW / 128), ceil(Cin / BN), B * 4): blockIdx.z = 4 b + rank,
// ranks 0-3 the classes (py, px) = (1, 1), (1, 0), (0, 1), (0, 0), with 4,
// 2, 2 and 1 taps. Pixel m of a class is (qy, qx) = (m / OW, m % OW).
template <class T>
__global__ void __launch_bounds__(T::THREADS, T::PER_SM) odconv_s2_dx_wgmma_kernel(DxArgs a) {
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* As = ring_base(smem_raw);
  __nv_bfloat16* Bs = As + T::STAGES * T::A_STAGE;
  const Dims& d = a.d;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int b = blockIdx.z / 4;
  const int cls = 3 - blockIdx.z % 4;
  const int py = cls >> 1, px = cls & 1;
  const int ntx = 1 + px;
  const int ntaps = (1 + py) * ntx;
  const int M = d.OH * d.OW;
  const int nk = (ntaps * d.Cout + T::BK - 1) / T::BK;
  const __nv_bfloat16* dyb = a.dy + static_cast<size_t>(b) * M * d.Cout;
  const __nv_bfloat16* wb = a.w + static_cast<size_t>(b) * 9 * d.Cin * d.Cout;

  // Both loaders: 16-byte column vc of rows `row` + 32 i (A: BM pixels, B:
  // BN input channels), so the two vectors of a stage share k = (t, co)
  constexpr int A_ITERS = T::BM / 32, B_ITERS = T::BN / 32;
  const int vc = tid % 8;
  const int row = tid / 8;
  int a_qy[A_ITERS], a_qx[A_ITERS];  // each A row's class pixel; qy = OH (outside) past M
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int m = m0 + row + 32 * i;
    const int qy = m / d.OW;
    a_qy[i] = m < M ? qy : d.OH;
    a_qx[i] = m < M ? m - qy * d.OW : 0;
  }
  int t = 0, co = vc * 8;  // tap index in the class and channel of this thread's vector in the next stage to load
  while (co >= d.Cout) {
    co -= d.Cout;
    ++t;
  }

  auto load = [&](int slot, int) {
    __nv_bfloat16* as = As + slot * T::A_STAGE;
    __nv_bfloat16* bs = Bs + slot * T::B_STAGE;
    const bool k_ok = t < ntaps;
    // tap t = (ty, tx) of the class; an odd input row takes ky = 0 (oy =
    // qy + 1) and ky = 2 (oy = qy), an even one ky = 1 (oy = qy)
    const int ty = t / ntx, tx = t - ty * ntx;
    const int ky = py ? 2 * ty : 1, sy = py & (ty ^ 1);
    const int kx = px ? 2 * tx : 1, sx = px & (tx ^ 1);
    const int tap = ky * 3 + kx;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int oy = a_qy[i] + sy, ox = a_qx[i] + sx;
      const bool ok = k_ok && oy < d.OH && ox < d.OW;
      const __nv_bfloat16* src = ok ? dyb + (static_cast<size_t>(oy) * d.OW + ox) * d.Cout + co : dyb;
      cp_async16(as + swizzled(row + 32 * i, vc), src, ok);
    }
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const int n = n0 + row + 32 * i;
      const bool ok = k_ok && n < d.Cin;
      const __nv_bfloat16* src = ok ? wb + (static_cast<size_t>(tap) * d.Cin + n) * d.Cout + co : wb;
      cp_async16(bs + swizzled(row + 32 * i, vc), src, ok);
    }
    co += T::BK;
    while (co >= d.Cout) {
      co -= d.Cout;
      ++t;
    }
  };

  float acc[T::BN / 2];
#pragma unroll
  for (int r = 0; r < T::BN / 2; ++r) acc[r] = 0.0f;

  run_ring<T>(nk, load, [&](int slot) {
    // A and B K-major: rows of 64 k, 8-row groups 1024 bytes apart, the
    // k16 step 32 bytes into the swizzle row
    const __nv_bfloat16* as = As + slot * T::A_STAGE + wg * 64 * T::BK;
    const __nv_bfloat16* bs = Bs + slot * T::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < T::BK / 16; ++kk)
      Wgmma<T::BN, 0, 0>::k16(acc, gmma_desc(as + kk * 16, 16, 1024), gmma_desc(bs + kk * 16, 16, 1024));
  });

  // this lane's row of the strip (store_bf16_row) and its input pixel
  const int lane = tid % 32;
  const int m = m0 + wg * 64 + (tid % 128) / 32 * 16 + lane / 4 + 8 * ((lane % 4) & 1);
  __nv_bfloat16* out = nullptr;
  if (m < M) {
    const int qy = m / d.OW, qx = m - (m / d.OW) * d.OW;
    out = a.dx + ((static_cast<size_t>(b) * d.H + 2 * qy + py) * d.W + 2 * qx + px) * d.Cin;
  }
  store_bf16_row<T::BN / 8>(reinterpret_cast<const float(*)[4]>(acc), out, n0, d.Cin);
}

struct DwArgs {
  const __nv_bfloat16* x;   // (B, H, W, Cin)
  const __nv_bfloat16* dy;  // (B, OH, OW, Cout)
  __nv_bfloat16* dw;        // (B, 9 * Cin, Cout)
  float* ws;                // (split, B, 9 * Cin, Cout) partial sums; unused when split == 1
  Dims d;
  int split;
  int kt_per_split;  // K steps (64 pixels) per part
};

// grid (ceil(9*Cin / 128), ceil(Cout / BN), B * split): blockIdx.z =
// part * B + b. Rows r = tap * Cin + ci, columns co, the reduction over
// the part's pixels.
template <class T>
__global__ void __launch_bounds__(T::THREADS, T::PER_SM) odconv_s2_dw_wgmma_kernel(DwArgs a) {
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* As = ring_base(smem_raw);
  __nv_bfloat16* Bs = As + T::STAGES * T::A_STAGE;
  const Dims& d = a.d;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int R = 9 * d.Cin;
  const int P = d.OH * d.OW;
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int b = blockIdx.z % d.B;
  const int part = blockIdx.z / d.B;
  const int kt0 = part * a.kt_per_split;
  const int nk = min((P + T::BK - 1) / T::BK, kt0 + a.kt_per_split) - kt0;
  const __nv_bfloat16* xb = a.x + static_cast<size_t>(b) * d.H * d.W * d.Cin;
  const __nv_bfloat16* dyb = a.dy + static_cast<size_t>(b) * P * d.Cout;

  // A loader (M-major): 16-byte column ac holds rows m0 + 8 ac .. +7 =
  // (tap, ci .. ci + 7), decoded once; pixels `a_row` + 16 i of the stage.
  // Columns 0-7 fill warpgroup 0's 64-row panel, 8-15 warpgroup 1's.
  constexpr int A_ITERS = T::BK / 16;
  const int ac = tid % 16;
  const int a_row = tid / 16;
  const int r = m0 + ac * 8;
  const bool r_ok = r < R;
  const int tap = r / d.Cin;
  const int ci = r - tap * d.Cin;
  const int ky = tap / 3, kx = tap - (tap / 3) * 3;
  // B loader (N-major, dy as stored): a fixed 16-byte column of the tile
  constexpr int B_VPR = T::BN / 8, B_ROW_STEP = T::THREADS / B_VPR, B_ITERS = T::BK / B_ROW_STEP;
  const int bc = tid % B_VPR;
  const int b_row = tid / B_VPR;
  const bool c_ok = n0 + bc * 8 < d.Cout;

  auto load = [&](int slot, int kt) {
    __nv_bfloat16* as = As + slot * T::A_STAGE + (ac / 8) * (64 * T::BK);
    __nv_bfloat16* bs = Bs + slot * T::B_STAGE;
    const int p0 = (kt0 + kt) * T::BK;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int rr = a_row + 16 * i;
      const int p = p0 + rr;
      const int oy = p / d.OW, ox = p - (p / d.OW) * d.OW;
      const int iy = 2 * oy + ky - 1, ix = 2 * ox + kx - 1;
      const bool ok = r_ok && p < P && static_cast<unsigned>(iy) < static_cast<unsigned>(d.H) &&
                      static_cast<unsigned>(ix) < static_cast<unsigned>(d.W);
      const __nv_bfloat16* src = ok ? xb + (static_cast<size_t>(iy) * d.W + ix) * d.Cin + ci : xb;
      cp_async16(as + swizzled(rr, ac % 8), src, ok);
    }
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const int rr = b_row + B_ROW_STEP * i;
      const int p = p0 + rr;
      const bool ok = c_ok && p < P;
      const __nv_bfloat16* src = ok ? dyb + static_cast<size_t>(p) * d.Cout + n0 + bc * 8 : dyb;
      cp_async16(bs + (bc / 8) * (64 * T::BK) + swizzled(rr, bc % 8), src, ok);
    }
  };

  float acc[T::BN / 2];
#pragma unroll
  for (int i = 0; i < T::BN / 2; ++i) acc[i] = 0.0f;

  run_ring<T>(nk, load, [&](int slot) {
    // A and B MN-major: panels of 64 rows (m or n) by the stage's 64 k,
    // 8-k groups 1024 bytes apart, the k16 step two groups; B's next 64
    // columns one panel (64 * BK * 2 bytes) on. A's 64 rows are one panel.
    const __nv_bfloat16* as = As + slot * T::A_STAGE + wg * 64 * T::BK;
    const __nv_bfloat16* bs = Bs + slot * T::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < T::BK / 16; ++kk)
      Wgmma<T::BN, 1, 1>::k16(acc, gmma_desc(as + kk * 16 * 64, 128 * T::BK, 1024),
                              gmma_desc(bs + kk * 16 * 64, 128 * T::BK, 1024));
  });

  const float(*frag)[4] = reinterpret_cast<const float(*)[4]>(acc);
  const int row0 = m0 + wg * 64 + (tid % 128) / 32 * 16;
  if (a.split == 1) {
    const int lane = tid % 32;
    const int m = row0 + lane / 4 + 8 * ((lane % 4) & 1);  // the row store_bf16_row gives this lane
    store_bf16_row<T::BN / 8>(frag, m < R ? a.dw + (static_cast<size_t>(b) * R + m) * d.Cout : nullptr, n0, d.Cout);
  } else {
    store_f32_strip<T::BN / 8>(frag, a.ws + (static_cast<size_t>(part) * d.B + b) * R * d.Cout, d.Cout, row0, R, n0,
                               d.Cout);
  }
}

// dwmix = sum of the parts in part order (split-K's second pass)
__global__ void __launch_bounds__(256)
odconv_s2_bwd_reduce_bf16(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out, int split, size_t total) {
  splitk_sum8(ws, out, split, total);
}

template <class T, class Args>
int launch_tile(void (*kernel)(Args), const Args& a, dim3 grid, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, T::THREADS, T::SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_dx_bf16(const DxArgs& a, cudaStream_t st) {
  const dim3 grid((a.d.OH * a.d.OW + T::BM - 1) / T::BM, (a.d.Cin + T::BN - 1) / T::BN, a.d.B * 4);
  return launch_tile<T>(odconv_s2_dx_wgmma_kernel<T>, a, grid, st);
}

template <class T>
int launch_dw_bf16(DwArgs a, cudaStream_t st) {
  const int nk = (a.d.OH * a.d.OW + T::BK - 1) / T::BK;
  a.kt_per_split = (nk + a.split - 1) / a.split;
  const dim3 grid((9 * a.d.Cin + T::BM - 1) / T::BM, (a.d.Cout + T::BN - 1) / T::BN, a.d.B * a.split);
  return launch_tile<T>(odconv_s2_dw_wgmma_kernel<T>, a, grid, st);
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous tensors: dy (B, H/2, W/2, Cout), wmix (B, 3, 3, Cin, Cout),
// x and dx (B, H, W, Cin), dwmix (B, 3, 3, Cin, Cout); `stream` is a
// cudaStream_t. Each returns cudaGetLastError() after its launches.
extern "C" int odconv_s2_dx_f32(const void* dy, const void* w, void* dx, int B, int H, int W, int Cin, int Cout,
                                void* stream) {
  return launch_dx_f32(dy, w, dx, B, H, W, Cin, Cout, static_cast<cudaStream_t>(stream));
}

// `split` parts of the pixel reduction, each ceil(ceil(P/32)/split) 32-pixel
// steps; for split > 1, `ws` holds split*B*9*Cin*Cout floats.
extern "C" int odconv_s2_dw_f32(const void* x, const void* dy, void* dw, void* ws, int B, int H, int W, int Cin,
                                int Cout, int split, void* stream) {
  return launch_dw_f32(x, dy, dw, ws, B, H, W, Cin, Cout, split, static_cast<cudaStream_t>(stream));
}

// Shared memory of tile configuration `cfg` of `kernel` (0 dx, 1 dwmix) in
// bytes, or -1 if there is none.
extern "C" int odconv_s2_bwd_bf16_smem(int kernel, int cfg) {
  if (kernel == 0) {
    switch (cfg) {
      case 0: return DxTile0::SMEM;
      case 1: return DxTile1::SMEM;
      case 2: return DxTile2::SMEM;
    }
  } else if (kernel == 1) {
    switch (cfg) {
      case 0: return DwTile0::SMEM;
      case 1: return DwTile1::SMEM;
    }
  }
  return -1;
}

// bf16 dx with tile configuration `cfg` of ops/odconv.py::_dx_plan. Needs
// Cin % 8 == 0, Cout % 8 == 0 and 16-byte-aligned pointers.
extern "C" int odconv_s2_dx_bf16(const void* dy, const void* w, void* dx, int B, int H, int W, int Cin, int Cout,
                                 int cfg, void* stream) {
  if (Cin % 8 != 0 || Cout % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const DxArgs a{static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(w),
                 static_cast<__nv_bfloat16*>(dx), make_dims(B, H, W, Cin, Cout)};
  if (B == 0 || a.d.OH * a.d.OW == 0 || Cin == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cfg) {
    case 0: return launch_dx_bf16<DxTile0>(a, st);
    case 1: return launch_dx_bf16<DxTile1>(a, st);
    case 2: return launch_dx_bf16<DxTile2>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 dwmix with the plan of ops/odconv.py::_dw_plan: tile configuration
// `cfg`, the pixel reduction cut into `split` parts of
// ceil(ceil(P/64)/split) 64-pixel steps. Needs Cin % 8 == 0, Cout % 8 == 0
// and 16-byte-aligned pointers; for split > 1, `ws` holds
// split*B*9*Cin*Cout floats.
extern "C" int odconv_s2_dw_bf16(const void* x, const void* dy, void* dw, void* ws, int B, int H, int W, int Cin,
                                 int Cout, int cfg, int split, void* stream) {
  if (Cin % 8 != 0 || Cout % 8 != 0 || split < 1 || (split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const DwArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
                 static_cast<__nv_bfloat16*>(dw), static_cast<float*>(ws), make_dims(B, H, W, Cin, Cout), split, 0};
  if (B == 0 || Cin == 0 || Cout == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (cfg) {
    case 0: rc = launch_dw_bf16<DwTile0>(a, st); break;
    case 1: rc = launch_dw_bf16<DwTile1>(a, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0 || split == 1) return rc;
  const size_t total = static_cast<size_t>(B) * 9 * Cin * Cout;
  const unsigned blocks = static_cast<unsigned>((total / 8 + 255) / 256);
  odconv_s2_bwd_reduce_bf16<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(dw),
                                                    split, total);
  return static_cast<int>(cudaGetLastError());
}
