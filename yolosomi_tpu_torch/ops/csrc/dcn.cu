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
//   the last bits).
// dcnv2_im2col: x (N,H,W,C), offset_y, offset_x, mask (N,Ho,Wo,P) ->
//   cols (N, Ho*Wo, P*C), cols[n, pix, p*C + c] = mask * bilinear(x, point
//   p), p = ky*k + kx, py = oy*s - pad + ky + dy. The product with the
//   (P*C, c2) weight is a plain large matmul left to torch.matmul.
//
// Both kernels are bound by bytes on an H100: per output value they read
// 4 corners per point and do 2 flops per corner, far below the card's
// operations-per-byte balance. At the serving shapes (640 px, batch 8,
// bf16) the least traffic is:
//   dcnv3_core row 10, (8,20,20,1024), G 8, P 9: 14.5 MB in + out
//   dcnv2_im2col row 6, x (8,40,40,256): 6.6 MB in, 59.0 MB of columns
//   dcnv2_im2col row 8, x (8,20,20,512): 3.3 MB in, 29.5 MB of columns
//
// dcnv3_core: one block per PIX output pixels. Phase 1 computes each
// sampling point's four corner indices and weights once (the mask folded
// into the weights) into shared memory. Phase 2 runs the threads along the
// channels, so the NHWC corner reads and the output writes of a warp are
// consecutive addresses; every thread accumulates in f32 and rounds once
// to the output dtype. What it leaves on the table: scalar loads, corner
// reads that reach L2 once per point, an integer division per element.
//
// dcnv2_im2col: a group of LANES threads (a warp where C/VEC >= 32, fewer
// for narrow maps) writes the columns of up to V2_PAIRS = 4 (pixel, point)
// pairs, one pair after the other. Lane j decodes pair j's (n, oy, ox, p)
// from its index, loads its offsets and mask (coalesced) and computes its
// four corner rows and mask-weighted bilinear weights in registers, which
// __shfl_sync then broadcasts to the group: no shared memory, no barrier,
// no division per element. (A group per pair would decode 32 times over;
// a group per 32 pairs left 113 blocks for the card at row 8.) Each lane
// reads VEC channels (16 bytes: 8 bf16 or 4 f32) from each of the four
// corners, accumulates in f32 and writes 16 bytes of the columns with a
// streaming store (st.global.cs: the 59 MB of columns at row 6 exceed the
// 50 MB L2 and are read once, by the matmul). A warp's stores are 512
// consecutive bytes. Where C % VEC != 0 or x is not 16-byte aligned the
// same kernel runs with VEC = 1. What remains: the corner reads hit L2
// four times per column value (x fits in L2), and the column matrix itself
// is written to HBM and read back by the matmul instead of being fed
// straight to the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int PIX = 4;           // dcnv3_core: output pixels per block
constexpr int THREADS = 256;     // dcnv3_core: threads per block
constexpr int V2_THREADS = 256;  // dcnv2_im2col: threads per block (ops/dcn.py::_V2_THREADS)
constexpr int V2_PAIRS = 4;      // dcnv2_im2col: most pairs a group writes (ops/dcn.py::_V2_PAIRS)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

struct V3Shape {
  int N, H, W, G, Cg, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw;
  float offset_scale;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
dcnv3_core_kernel(const T* __restrict__ value, const T* __restrict__ offset, const T* __restrict__ mask,
                  T* __restrict__ out, V3Shape s) {
  extern __shared__ int smem_v3[];
  const int P = s.kh * s.kw;
  const int GP = s.G * P;
  const int C = s.G * s.Cg;
  const int npix = s.N * s.Ho * s.Wo;
  const int pix0 = blockIdx.x * PIX;
  int* sidx = smem_v3;                                         // [PIX][GP][4]
  float* sw = reinterpret_cast<float*>(smem_v3 + PIX * GP * 4);  // [PIX][GP][4]

  const int half_x = (s.dw * (s.kw - 1)) / 2;
  const int half_y = (s.dh * (s.kh - 1)) / 2;
  for (int t = threadIdx.x; t < PIX * GP; t += blockDim.x) {
    const int pix = pix0 + t / GP;
    if (pix >= npix) continue;
    const int gp = t - (t / GP) * GP;
    const int p = gp % P;
    const int ix = p / s.kh;  // p = ix*kh + iy
    const int iy = p - ix * s.kh;
    const int ox = pix % s.Wo;
    const int oy = (pix / s.Wo) % s.Ho;
    const size_t base = static_cast<size_t>(pix) * GP + gp;
    const float off_x = to_f32(offset[2 * base]);
    const float off_y = to_f32(offset[2 * base + 1]);
    const float m = to_f32(mask[base]);
    const float px = static_cast<float>(half_x + ox * s.sw - s.pw) +
                     (static_cast<float>(ix * s.dw - half_x) + off_x) * s.offset_scale;
    const float py = static_cast<float>(half_y + oy * s.sh - s.ph) +
                     (static_cast<float>(iy * s.dh - half_y) + off_y) * s.offset_scale;
    bilinear_taps(px, py, s.H, s.W, m, sidx + 4 * t, sw + 4 * t);
  }
  __syncthreads();

  for (int t = threadIdx.x; t < PIX * C; t += blockDim.x) {
    const int pp = t / C;
    const int pix = pix0 + pp;
    if (pix >= npix) continue;
    const int c = t - pp * C;
    const int g = c / s.Cg;
    const int n = pix / (s.Ho * s.Wo);
    const T* img = value + static_cast<size_t>(n) * s.H * s.W * C + c;
    const int* idx = sidx + 4 * (pp * GP + g * P);
    const float* w = sw + 4 * (pp * GP + g * P);
    float acc = 0.0f;
    for (int q = 0; q < 4 * P; ++q) {
      const int i = idx[q];
      if (i >= 0) acc = fmaf(w[q], to_f32(img[static_cast<size_t>(i) * C]), acc);
    }
    store(out + static_cast<size_t>(pix) * C + c, acc);
  }
}

struct V2Shape {
  int N, H, W, C, Ho, Wo, k, stride, pad;
};

// VEC channels of one corner, or of one column run, as f32
template <typename T, int VEC>
struct Vec;

template <typename T>
struct Vec<T, 1> {
  __device__ __forceinline__ static void fma(float* acc, float w, const T* p) {
    acc[0] = fmaf(w, to_f32(__ldg(p)), acc[0]);
  }
  __device__ __forceinline__ static void store(T* p, const float* v) { ::store(p, v[0]); }
};

template <>
struct Vec<float, 4> {
  __device__ __forceinline__ static void fma(float* acc, float w, const float* p) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    acc[0] = fmaf(w, v.x, acc[0]);
    acc[1] = fmaf(w, v.y, acc[1]);
    acc[2] = fmaf(w, v.z, acc[2]);
    acc[3] = fmaf(w, v.w, acc[3]);
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void fma(float* acc, float w, const __nv_bfloat16* p) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
      acc[2 * i] = fmaf(w, f.x, acc[2 * i]);
      acc[2 * i + 1] = fmaf(w, f.y, acc[2 * i + 1]);
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    unsigned words[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      words[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(words[0], words[1], words[2], words[3]));
  }
};

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
    const float py = static_cast<float>(oy * s.stride - s.pad + ky) + to_f32(offset_y[q]);
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
      rj[c] = LANES == 1 ? row[c] : __shfl_sync(0xffffffffu, row[c], j, LANES);
      wj[c] = LANES == 1 ? w[c] : __shfl_sync(0xffffffffu, w[c], j, LANES);
    }
    if (first + j >= pairs) continue;  // the same for the whole group, after its shuffles
    T* dst = cols + static_cast<size_t>(first + j) * s.C;
    for (int v = lane * VEC; v < s.C; v += LANES * VEC) {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (rj[c] >= 0) Vec<T, VEC>::fma(acc, wj[c], x + static_cast<size_t>(rj[c]) * s.C + v);
      Vec<T, VEC>::store(dst + v, acc);
    }
  }
}

int blocks_for(int npix) { return (npix + PIX - 1) / PIX; }

template <typename T>
int launch_v3(const void* value, const void* offset, const void* mask, void* out, V3Shape s, void* stream) {
  const int npix = s.N * s.Ho * s.Wo;
  const size_t smem = static_cast<size_t>(PIX) * s.G * s.kh * s.kw * 4 * (sizeof(int) + sizeof(float));
  if (npix > 0)
    dcnv3_core_kernel<T><<<blocks_for(npix), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(value), static_cast<const T*>(offset), static_cast<const T*>(mask),
        static_cast<T*>(out), s);
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
                 int dh, int dw, float offset_scale) {
  return V3Shape{N, H, W, G, Cg, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw, offset_scale};
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous tensors; `stream` is a cudaStream_t. Each returns
// cudaGetLastError() after the launch (0 on success). The caller keeps
// dcnv3_core's shared memory, PIX * G * kh * kw * 32 bytes, under 48 KB.
extern "C" int dcnv3_core_f32(const void* value, const void* offset, const void* mask, void* out, int N, int H,
                              int W, int G, int Cg, int Ho, int Wo, int kh, int kw, int sh, int sw, int ph, int pw,
                              int dh, int dw, float offset_scale, void* stream) {
  return launch_v3<float>(value, offset, mask, out,
                          v3_shape(N, H, W, G, Cg, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw, offset_scale), stream);
}

extern "C" int dcnv3_core_bf16(const void* value, const void* offset, const void* mask, void* out, int N, int H,
                               int W, int G, int Cg, int Ho, int Wo, int kh, int kw, int sh, int sw, int ph, int pw,
                               int dh, int dw, float offset_scale, void* stream) {
  return launch_v3<__nv_bfloat16>(value, offset, mask, out,
                                  v3_shape(N, H, W, G, Cg, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw, offset_scale),
                                  stream);
}

extern "C" int dcnv2_im2col_f32(const void* x, const void* offset_y, const void* offset_x, const void* mask,
                                void* cols, int N, int H, int W, int C, int Ho, int Wo, int k, int stride, int pad,
                                int vec, int lanes, void* stream) {
  return launch_v2<float>(x, offset_y, offset_x, mask, cols, V2Shape{N, H, W, C, Ho, Wo, k, stride, pad}, vec,
                          lanes, stream);
}

extern "C" int dcnv2_im2col_bf16(const void* x, const void* offset_y, const void* offset_x, const void* mask,
                                 void* cols, int N, int H, int W, int C, int Ho, int Wo, int k, int stride, int pad,
                                 int vec, int lanes, void* stream) {
  return launch_v2<__nv_bfloat16>(x, offset_y, offset_x, mask, cols, V2Shape{N, H, W, C, Ho, Wo, k, stride, pad},
                                  vec, lanes, stream);
}
