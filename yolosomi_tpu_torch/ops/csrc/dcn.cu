// Deformable sampling for DCNv3 and DCNv2: bilinear samples of an NHWC
// feature map at learned, data-dependent positions, zeros outside the map.
//
// Replaces, on the GPU:
// - tools/probe_pallas_gather.py:27 (`probe`, kernels k_take, k_tala0,
//   k_tala1): the row, sublane and lane gathers that a TPU kernel would
//   need for this sampling. On the TPU they failed or hung in Mosaic, so
//   the JAX package kept the sampling as XLA gathers;
// - yolosomi_tpu/ops/dcn.py: `_bilinear_gather` + `dcnv3_core` (:34-124)
//   and DCNv2's modulated sampling (:209-233).
// On Hopper a data-dependent gather is an ordinary load, so each kernel
// performs those gathers directly. The plain PyTorch versions are
// dcnv3_core_reference and dcnv2_im2col_reference in
// yolosomi_tpu_torch/ops/dcn.py.
//
// dcnv3_core: value (N,H,W,G*Cg), offset (N,Ho,Wo,G*P*2) with (x, y)
//   interleaved per (g, p), mask (N,Ho,Wo,G*P) softmax'd over P ->
//   out (N,Ho,Wo,G*Cg) = sum_p mask * bilinear(value, point p). Point
//   p = ix*kh + iy (the kernel's y index fastest, dcn.py:94-102); its pixel
//   coordinate on the unpadded map is
//     px = (dil_w*(kw-1))/2 + ox*s_w - pad_w + (gx + off_x)*offset_scale
//   with gx = -(dil_w*(kw-1))/2 + ix*dil_w, the closed form of the JAX
//   package's round trip through coordinates normalised over the padded
//   canvas (both are exact in real arithmetic; f32 rounding differs in
//   the last bits). With a row origin row0 (a strip of a spatially sharded
//   map, value the whole map) output row oy is row row0 + oy of the whole
//   output: py = (dil_h*(kh-1))/2 + (row0 + oy)*s_h - pad_h + ...
// dcnv2_im2col: x (N,H,W,C), offset_y, offset_x, mask (N,Ho,Wo,P) ->
//   cols (N, Ho*Wo, P*C), cols[n, pix, p*C + c] = mask * bilinear(x, point
//   p), p = ky*k + kx, py = (row0 + oy)*s - pad + ky + dy (row0 0, or a
//   strip's first output row, x the whole map). The product with the
//   (P*C, c2) weight is a plain large matmul left to torch.matmul.
//
// By their arithmetic both kernels are bound by bytes on an H100: per
// output value they read 4 corners per point and do 2 flops per corner,
// far below the card's operations-per-byte balance. At the serving shapes
// (640 px, batch 8, bf16) the least traffic is:
//   dcnv3_core row 10, (8,20,20,1024), G 8, P 9: 14.5 MB in + out
//   dcnv2_im2col row 6, x (8,40,40,256): 6.6 MB in, 59.0 MB of columns
//   dcnv2_im2col row 8, x (8,20,20,512): 3.3 MB in, 29.5 MB of columns
//
// Both kernels share one design: a lane group (a power of two of threads,
// at most a warp) per unit of output, the unit's sampling points decoded
// once each, by one lane, in registers, and broadcast to the group by
// __shfl_sync: no shared memory, no barrier, no division per element. Each
// lane reads VEC channels (16 bytes: 8 bf16 or 4 f32) from each corner and
// accumulates in f32; where the channel count is not a multiple of VEC or
// a tensor is not 16-byte aligned the same kernel runs with VEC = 1.
//
// dcnv3_core: a group of LANES threads per (pixel, group) item writes its
// Cg channels (at row 10, Cg 128: 16 lanes in bf16, 32 in f32, one 16-byte
// store each). Lane l decodes the item's points l, l + LANES, ... (rounds
// of LANES points where P > LANES): the (x, y) offset pair in one load, the
// mask, the four corners and the mask-folded weights. The group walks the
// points in order, so each channel sums point-major and corner-minor as
// the plain loop does, and rounds once. A block holds consecutive output
// pixels of one group, whose sampling windows overlap (faster than the
// groups of one pixel, most in f32). Corners off the map load nothing and
// add 0 * 0, so the FMAs run without branches. The output is stored
// plainly: the next layer (output_proj) reads it from L2. What remains: at
// row 10 the sampling loop is bound by its instructions, not by bytes --
// per lane and point 8 shuffles, 4 addresses, 4 loads, and per bf16 corner
// 8 unpacks and 8 FMAs -- so with every corner read an L1 hit it runs
// within ~15% of its time, though the valid corners read 189 MB (bf16),
// 13x the bytes the HBM bound counts (PERF.md).
//
// dcnv2_im2col: a group of LANES threads (a warp where C/VEC >= 32, fewer
// for narrow maps) writes the columns of up to V2_PAIRS = 4 (pixel, point)
// pairs, one pair after the other. Lane j decodes pair j's (n, oy, ox, p)
// from its index, loads its offsets and mask (coalesced) and computes its
// four corner rows and mask-weighted bilinear weights, which the group
// shares by shuffle. (A group per pair would decode 32 times over; a group
// per 32 pairs left 113 blocks for the card at row 8.) Each lane writes 16
// bytes of the columns with a streaming store (st.global.cs: the 59 MB of
// columns at row 6 exceed the 50 MB L2 and are read once, by the matmul).
// A warp's stores are 512 consecutive bytes. What remains: the corner
// reads hit L2 four times per column value (x fits in L2), and the column
// matrix itself is written to HBM and read back by the matmul instead of
// being fed straight to the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dcn_common.cuh"

namespace {

constexpr int V3_THREADS = 256;  // dcnv3_core: threads per block (ops/dcn.py::_V3_THREADS)
constexpr int V2_THREADS = 256;  // dcnv2_im2col: threads per block (ops/dcn.py::_V2_THREADS)
constexpr int V2_PAIRS = 4;      // dcnv2_im2col: most pairs a group writes (ops/dcn.py::_V2_PAIRS)

// The shared bilinear sampler (align_corners=False: pixel centres at
// 0..W-1). Corner k = (dx, dy) = (k & 1, k >> 1), in the JAX package's
// order; a corner counts only inside [0, W-1] x [0, H-1] (dcn.py:50),
// otherwise its index is -1 and its weight 0. Weights are multiplied by
// `scale` (the point's mask).
__device__ __forceinline__ void bilinear_taps(float px, float py, int H, int W, float scale, int* idx,
                                              float* w) {
  const float x0f = floorf(px);
  const float y0f = floorf(py);
  const float fx = px - x0f;
  const float fy = py - y0f;
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dx = k & 1;
    const int dy = k >> 1;
    const int xc = x0 + dx;
    const int yc = y0 + dy;
    const bool inside = xc >= 0 && xc <= W - 1 && yc >= 0 && yc <= H - 1;
    idx[k] = inside ? yc * W + xc : -1;
    w[k] = inside ? (dx ? fx : 1.0f - fx) * (dy ? fy : 1.0f - fy) * scale : 0.0f;
  }
}


// A group of `lanes` threads writes the Cg channels of one (pixel, group)
// item; lane l covers the VEC-vectors l, l + lanes, ... of them. Block b
// holds V3_THREADS / lanes consecutive pixels, from tile b / G on, of
// group b % G. For each round of `lanes` points, lane l decodes point
// r0 + l (p = ix*kh + iy): its corners as element offsets into the item's
// image (row * C, -1 off the map; launch_v3 bounds H*W*C below 2**31) and
// its weights, the mask folded in. The group then walks the round's points
// in order, point j's corners shuffled from lane j. Every lane of the warp
// joins every shuffle: the loop counts depend only on P, Cg and lanes, and
// a lane with no item (past the last pixel) or no channels only skips its
// loads and its store.
template <typename T, int VEC>
__global__ void __launch_bounds__(V3_THREADS)
dcnv3_core_kernel(const T* __restrict__ value, const T* __restrict__ offset, const T* __restrict__ mask,
                  T* __restrict__ out, V3Shape s, int lanes, bool pair) {
  const int P = s.kh * s.kw;
  const int C = s.G * s.Cg;
  const int npix = s.N * s.Ho * s.Wo;
  const int lane = threadIdx.x & (lanes - 1);
  const int tile = blockIdx.x / s.G;
  const int g = blockIdx.x - tile * s.G;
  const int pix = tile * (V3_THREADS / lanes) + threadIdx.x / lanes;
  const bool live = pix < npix;
  const int ox = pix % s.Wo;
  const int oy = (pix / s.Wo) % s.Ho;
  const int n = pix / (s.Wo * s.Ho);
  const int half_x = (s.dw * (s.kw - 1)) / 2;
  const int half_y = (s.dh * (s.kh - 1)) / 2;
  const float cx = static_cast<float>(half_x + ox * s.sw - s.pw);
  const float cy = static_cast<float>(half_y + (s.row0 + oy) * s.sh - s.ph);
  const size_t q0 = (static_cast<size_t>(pix) * s.G + g) * P;  // the item's first point
  const T* img = value + static_cast<size_t>(n) * s.H * s.W * C + g * s.Cg;
  for (int c0 = 0; c0 < s.Cg; c0 += lanes * VEC) {
    const int v = c0 + lane * VEC;
    const bool on = live && v < s.Cg;
    const T* src = img + v;  // this lane's channels of the item's image
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    for (int r0 = 0; r0 < P; r0 += lanes) {
      int idx[4] = {-1, -1, -1, -1};
      float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int p = r0 + lane;
      if (live && p < P) {
        const int ix = p / s.kh;
        const int iy = p - ix * s.kh;
        const float2 o = load_pair(offset + 2 * (q0 + p), pair);
        const float px = cx + (static_cast<float>(ix * s.dw - half_x) + o.x) * s.offset_scale;
        const float py = cy + (static_cast<float>(iy * s.dh - half_y) + o.y) * s.offset_scale;
        bilinear_taps(px, py, s.H, s.W, to_f32(__ldg(mask + q0 + p)), idx, w);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (idx[k] >= 0) idx[k] *= C;
      }
      const int points = min(lanes, P - r0);
      for (int j = 0; j < points; ++j) {
        // a corner off the map has weight 0 and reads nothing: its FMA adds
        // 0 * 0, so every lane runs the same FMAs without a branch
        typename Vec<T, VEC>::Raw raw[4] = {};
        float wj[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ij = __shfl_sync(FULL_WARP, idx[k], j, lanes);
          wj[k] = __shfl_sync(FULL_WARP, w[k], j, lanes);
          if (on && ij >= 0) raw[k] = Vec<T, VEC>::load(src + ij);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) Vec<T, VEC>::fma(acc, wj[k], raw[k]);
      }
    }
    if (on) Vec<T, VEC>::store(out + static_cast<size_t>(pix) * C + g * s.Cg + v, acc, false);
  }
}

// A group of LANES threads writes the columns of PAIRS = min(LANES,
// V2_PAIRS) consecutive (pixel, point) pairs, first = group * PAIRS on.
// Lane l < PAIRS decodes pair q = first + l: (pix, p) = (q / P, q % P) with
// pix = (n*Ho + oy)*Wo + ox, so the pair's offsets and mask sit at q (one
// coalesced load) and its columns at cols[q*C .. q*C + C). It computes the
// point's corners and weights once, as absolute rows of x (n*H*W + yc*W +
// xc). Then the group walks its pairs: pair j's corners come from lane j by
// shuffle, and lane l covers the VEC-vectors l, l + LANES, ... of its C
// columns.
template <typename T, int VEC, int LANES>
__global__ void __launch_bounds__(V2_THREADS)
dcnv2_im2col_kernel(const T* __restrict__ x, const T* __restrict__ offset_y, const T* __restrict__ offset_x,
                    const T* __restrict__ mask, T* __restrict__ cols, V2Shape s) {
  constexpr int PAIRS = LANES < V2_PAIRS ? LANES : V2_PAIRS;
  const int P = s.k * s.k;
  const int pairs = s.N * s.Ho * s.Wo * P;
  const int lane = threadIdx.x % LANES;
  const int first = (blockIdx.x * V2_THREADS + threadIdx.x) / LANES * PAIRS;
  const int q = first + lane;  // the pair this lane decodes, if lane < PAIRS
  int row[4] = {-1, -1, -1, -1};
  float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (lane < PAIRS && q < pairs) {
    const int p = q % P;
    const int pix = q / P;
    const int ox = pix % s.Wo;
    const int oy = (pix / s.Wo) % s.Ho;
    const int n = pix / (s.Wo * s.Ho);
    const int ky = p / s.k;  // p = ky*k + kx
    const int kx = p - ky * s.k;
    const float py = static_cast<float>((s.row0 + oy) * s.stride - s.pad + ky) + to_f32(offset_y[q]);
    const float px = static_cast<float>(ox * s.stride - s.pad + kx) + to_f32(offset_x[q]);
    bilinear_taps(px, py, s.H, s.W, to_f32(mask[q]), row, w);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (row[c] >= 0) row[c] += n * s.H * s.W;
  }
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    int rj[4];
    float wj[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      rj[c] = LANES == 1 ? row[c] : __shfl_sync(FULL_WARP, row[c], j, LANES);
      wj[c] = LANES == 1 ? w[c] : __shfl_sync(FULL_WARP, w[c], j, LANES);
    }
    if (first + j >= pairs) continue;  // the same for the whole group, after its shuffles
    T* dst = cols + static_cast<size_t>(first + j) * s.C;
    for (int v = lane * VEC; v < s.C; v += LANES * VEC) {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (rj[c] >= 0) Vec<T, VEC>::fma(acc, wj[c], Vec<T, VEC>::load(x + static_cast<size_t>(rj[c]) * s.C + v));
      Vec<T, VEC>::store(dst + v, acc, true);
    }
  }
}

// `vec` is 1 or 16 / sizeof(T) (then Cg % vec == 0 and value, out 16-byte
// aligned); `lanes` a power of two up to 32: ops/dcn.py::_v3_geometry.
template <typename T>
int launch_v3(const void* value, const void* offset, const void* mask, void* out, V3Shape s, int vec, int lanes,
              void* stream) {
  constexpr int FULL = 16 / sizeof(T);
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  // the kernel's corner offsets (row * C) and block count are 32-bit
  const int per_block = V3_THREADS / lanes;
  const long long tiles = (static_cast<long long>(s.N) * s.Ho * s.Wo + per_block - 1) / per_block;
  if (static_cast<long long>(s.H) * s.W * s.G * s.Cg >= (1LL << 31) || tiles * s.G >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles * s.G == 0 || s.Cg == 0) return static_cast<int>(cudaGetLastError());
  const int blocks = static_cast<int>(tiles * s.G);
  const bool pair = reinterpret_cast<uintptr_t>(offset) % (2 * sizeof(T)) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* v = static_cast<const T*>(value);
  const T* o = static_cast<const T*>(offset);
  const T* m = static_cast<const T*>(mask);
  T* y = static_cast<T*>(out);
  if (vec == 1)
    dcnv3_core_kernel<T, 1><<<blocks, V3_THREADS, 0, st>>>(v, o, m, y, s, lanes, pair);
  else if (vec == FULL && s.Cg % FULL == 0)
    dcnv3_core_kernel<T, FULL><<<blocks, V3_THREADS, 0, st>>>(v, o, m, y, s, lanes, pair);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, int LANES>
int launch_v2_lanes(const void* x, const void* offset_y, const void* offset_x, const void* mask, void* cols,
                    V2Shape s, cudaStream_t stream) {
  constexpr int PAIRS = LANES < V2_PAIRS ? LANES : V2_PAIRS;
  // pairs * C < 2**31 (the wrapper bounds the columns), and a group of
  // LANES threads moves PAIRS * C / VEC >= PAIRS * LANES / 2 vectors, so
  // threads < 2**31 too
  const int pairs = s.N * s.Ho * s.Wo * s.k * s.k;
  const int threads = (pairs + PAIRS - 1) / PAIRS * LANES;
  if (pairs > 0)
    dcnv2_im2col_kernel<T, VEC, LANES><<<(threads + V2_THREADS - 1) / V2_THREADS, V2_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(offset_y), static_cast<const T*>(offset_x),
        static_cast<const T*>(mask), static_cast<T*>(cols), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_v2_vec(const void* x, const void* offset_y, const void* offset_x, const void* mask, void* cols,
                  V2Shape s, int lanes, cudaStream_t stream) {
  switch (lanes) {
    case 1: return launch_v2_lanes<T, VEC, 1>(x, offset_y, offset_x, mask, cols, s, stream);
    case 2: return launch_v2_lanes<T, VEC, 2>(x, offset_y, offset_x, mask, cols, s, stream);
    case 4: return launch_v2_lanes<T, VEC, 4>(x, offset_y, offset_x, mask, cols, s, stream);
    case 8: return launch_v2_lanes<T, VEC, 8>(x, offset_y, offset_x, mask, cols, s, stream);
    case 16: return launch_v2_lanes<T, VEC, 16>(x, offset_y, offset_x, mask, cols, s, stream);
    case 32: return launch_v2_lanes<T, VEC, 32>(x, offset_y, offset_x, mask, cols, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// `vec` is 1 or 16 / sizeof(T) (then C % vec == 0 and x, cols 16-byte
// aligned); `lanes` a power of two up to 32: ops/dcn.py::_v2_geometry.
template <typename T>
int launch_v2(const void* x, const void* offset_y, const void* offset_x, const void* mask, void* cols, V2Shape s,
              int vec, int lanes, void* stream) {
  constexpr int FULL = 16 / sizeof(T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 1) return launch_v2_vec<T, 1>(x, offset_y, offset_x, mask, cols, s, lanes, st);
  if (vec == FULL && s.C % FULL == 0)
    return launch_v2_vec<T, FULL>(x, offset_y, offset_x, mask, cols, s, lanes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

V3Shape v3_shape(int N, int H, int W, int G, int Cg, int Ho, int Wo, int kh, int kw, int sh, int sw, int ph, int pw,
                 int dh, int dw, float offset_scale, int row0) {
  return V3Shape{N, H, W, G, Cg, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw, offset_scale, row0};
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous tensors; `stream` is a cudaStream_t. Each returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int dcnv3_core_f32(const void* value, const void* offset, const void* mask, void* out, int N, int H,
                              int W, int G, int Cg, int Ho, int Wo, int kh, int kw, int sh, int sw, int ph, int pw,
                              int dh, int dw, float offset_scale, int row0, int vec, int lanes, void* stream) {
  return launch_v3<float>(value, offset, mask, out,
                          v3_shape(N, H, W, G, Cg, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw, offset_scale, row0), vec,
                          lanes, stream);
}

extern "C" int dcnv3_core_bf16(const void* value, const void* offset, const void* mask, void* out, int N, int H,
                               int W, int G, int Cg, int Ho, int Wo, int kh, int kw, int sh, int sw, int ph, int pw,
                               int dh, int dw, float offset_scale, int row0, int vec, int lanes, void* stream) {
  return launch_v3<__nv_bfloat16>(value, offset, mask, out,
                                  v3_shape(N, H, W, G, Cg, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw, offset_scale, row0),
                                  vec, lanes, stream);
}

extern "C" int dcnv2_im2col_f32(const void* x, const void* offset_y, const void* offset_x, const void* mask,
                                void* cols, int N, int H, int W, int C, int Ho, int Wo, int k, int stride, int pad,
                                int row0, int vec, int lanes, void* stream) {
  return launch_v2<float>(x, offset_y, offset_x, mask, cols, V2Shape{N, H, W, C, Ho, Wo, k, stride, pad, row0}, vec,
                          lanes, stream);
}

extern "C" int dcnv2_im2col_bf16(const void* x, const void* offset_y, const void* offset_x, const void* mask,
                                 void* cols, int N, int H, int W, int C, int Ho, int Wo, int k, int stride, int pad,
                                 int row0, int vec, int lanes, void* stream) {
  return launch_v2<__nv_bfloat16>(x, offset_y, offset_x, mask, cols,
                                  V2Shape{N, H, W, C, Ho, Wo, k, stride, pad, row0}, vec, lanes, stream);
}
