// Gradients of the deformable sampling kernels of dcn.cu: dcnv2_im2col_bwd
// and dcnv3_core_bwd.
//
// Replaces, on the GPU, XLA's VJP of the JAX package's gathers
// (yolosomi_tpu/ops/dcn.py:34-56 `_bilinear_gather`, :59-124 `dcnv3_core`,
// :209-233 DCNv2's sampling), through which the JAX package trains its DCN
// variant ("autodiff gives the backward for free", dcn.py:12-15). There is
// no Pallas kernel behind it. The plain versions are
// dcnv2_im2col_backward_reference and dcnv3_core_backward_reference in
// yolosomi_tpu_torch/ops/dcn.py: autograd of the plain forwards.
//
// The math, per sampling point (px, py) with mask m and upstream gradient
// g_c on each channel c: corners (x0, y0) = floor(p), fx = px - x0,
// fy = py - y0, v_k the value at corner k = (dx, dy) = (k & 1, k >> 1),
// read as 0 off the map, w_k = (dx ? fx : 1 - fx) * (dy ? fy : 1 - fy):
//   dmask     = sum_c g_c * sum_k w_k v_k
//   doffset_x = s * m * sum_c g_c * ((1 - fy)(v10 - v00) + fy (v11 - v01))
//   doffset_y = s * m * sum_c g_c * ((1 - fx)(v01 - v00) + fx (v11 - v10))
//   dinput[corner k] += m * w_k * g_c
// with s = dp / doffset: 1 for DCNv2, offset_scale for DCNv3. At an integer
// coordinate (every point at the zero-initialised offset heads) this is the
// one-sided derivative over floor(p) and floor(p) + 1, which is JAX's: its
// |x| has derivative +1 at 0. An off-map corner adds nothing to dinput but
// its 0 still enters doffset. DCNv3's padding is virtual: only on-map
// pixels get a gradient, as the VJP of jnp.pad gives.
//
// Design: each kernel keeps its forward's geometry. A lane group (a power
// of two of threads, at most a warp) takes one (pixel, point) pair of DCNv2
// or one (pixel, group) item of DCNv3; its lanes take 16-byte vectors of
// the channels (8 bf16 or 4 f32; one channel where C or a pointer does not
// allow it) and accumulate in f32. The offset and mask sums reduce over the
// group with xor shuffles. The input gradient is a scatter into
// data-dependent corners, so it is accumulated with f32 atomics (a float4
// reduction per 4 channels, sm_90) into a zeroed f32 buffer that the wrapper
// casts once to the input's dtype. Corners off the map or of weight 0 (3 of
// 4 at an integer point) scatter nothing. The adds land in an order that
// varies from run to run, so dinput is not bitwise repeatable (dmask and
// doffset are: each is one lane's fixed-order sum).
//
// Bound: the least traffic reads dcols / dout, the input, offsets and mask
// once and writes dinput, doffset and dmask once: at 640 px, b8, bf16, row
// 6 of yolo-somi-dcn moves ~73 MB a launch (59 MB of dcols), row 8 ~37 MB,
// row 10 (DCNv3) ~14.7 MB. The scatter is what holds the kernels back: at
// row 6, 4 corners x N*Ho*Wo*P*C = 118 M f32 adds a launch, 29.5 M float4
// reductions, resolved in the L2's atomic units; the measured times are in
// PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dcn_common.cuh"

namespace {

constexpr int BWD_THREADS = 256;  // threads per block of both kernels (ops/dcn.py::_BWD_THREADS)

// dst[0 .. VEC) += v[0 .. VEC) with f32 atomics: float4 reductions where
// VEC allows (dst 16-byte aligned: the wrapper's buffer, C a multiple of VEC)
template <int VEC>
__device__ __forceinline__ void red_add(float* dst, const float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      atomicAdd(reinterpret_cast<float4*>(dst + i), make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) atomicAdd(dst + i, v[i]);
  }
}

// One lane's share of a point's gradient over VEC channels: g the upstream
// gradient, val the four corners' values (0 off the map), the weights
// w_k and the bilinear fractions; adds to the point's three sums
// (dmask, and doffset_x / doffset_y before the factor s * m).
template <int VEC>
__device__ __forceinline__ void point_sums(const float* g, float (*val)[VEC], const float* w, float fx,
                                           float fy, float& sm, float& ax, float& ay) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float v00 = val[0][e], v10 = val[1][e], v01 = val[2][e], v11 = val[3][e];
    const float sample = w[0] * v00 + w[1] * v10 + w[2] * v01 + w[3] * v11;
    sm = fmaf(g[e], sample, sm);
    ax = fmaf(g[e], (1.0f - fy) * (v10 - v00) + fy * (v11 - v01), ax);
    ay = fmaf(g[e], (1.0f - fx) * (v01 - v00) + fx * (v11 - v10), ay);
  }
}

// The four corners of (px, py): offsets `stride * (yc * W + xc) + base` of
// the corners on the H x W map (-1 off it), the fractions fx, fy, and the
// bilinear weights w_k (0 off the map)
__device__ __forceinline__ void corners(float px, float py, int H, int W, long long stride, long long base,
                                        long long* idx, float* w, float& fx, float& fy) {
  const float x0f = floorf(px);
  const float y0f = floorf(py);
  fx = px - x0f;
  fy = py - y0f;
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dx = k & 1;
    const int dy = k >> 1;
    const int xc = x0 + dx;
    const int yc = y0 + dy;
    const bool inside = xc >= 0 && xc <= W - 1 && yc >= 0 && yc <= H - 1;
    idx[k] = inside ? base + stride * (static_cast<long long>(yc) * W + xc) : -1;
    w[k] = inside ? (dx ? fx : 1.0f - fx) * (dy ? fy : 1.0f - fy) : 0.0f;
  }
}

__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_WARP, v, o, lanes);
  return v;
}

// A group of `lanes` threads per (pixel, point) pair q = (pix, p),
// pix = (n*Ho + oy)*Wo + ox, p = ky*k + kx: its offsets and mask sit at q
// and its columns at dcols[q*C .. q*C + C). Every lane decodes the pair
// (the same addresses: one transaction); lane l takes the VEC-vectors l,
// l + lanes, ... of the C channels, scatters its share of dx and sums its
// share of the pair's three gradients, which the group reduces; lane 0
// stores them. Every lane of the warp joins every shuffle.
template <typename T, int VEC>
__global__ void __launch_bounds__(BWD_THREADS)
dcnv2_im2col_bwd_kernel(const T* __restrict__ x, const T* __restrict__ offset_y, const T* __restrict__ offset_x,
                        const T* __restrict__ mask, const T* __restrict__ dcols, float* __restrict__ dx,
                        T* __restrict__ doffset_y, T* __restrict__ doffset_x, T* __restrict__ dmask, V2Shape s,
                        int lanes) {
  const int P = s.k * s.k;
  const long long pairs = static_cast<long long>(s.N) * s.Ho * s.Wo * P;
  const long long t = static_cast<long long>(blockIdx.x) * BWD_THREADS + threadIdx.x;
  const int lane = threadIdx.x & (lanes - 1);
  const bool live = t / lanes < pairs;
  const long long q = live ? t / lanes : 0;
  const int p = static_cast<int>(q % P);
  const long long pix = q / P;
  const int ox = static_cast<int>(pix % s.Wo);
  const int oy = static_cast<int>((pix / s.Wo) % s.Ho);
  const long long n = pix / (static_cast<long long>(s.Wo) * s.Ho);
  const int ky = p / s.k;
  const int kx = p - ky * s.k;
  const float py = static_cast<float>(oy * s.stride - s.pad + ky) + to_f32(offset_y[q]);
  const float px = static_cast<float>(ox * s.stride - s.pad + kx) + to_f32(offset_x[q]);
  const float m = to_f32(mask[q]);
  long long idx[4];
  float w[4], fx, fy;
  corners(px, py, s.H, s.W, s.C, n * s.H * s.W * s.C, idx, w, fx, fy);
  float sm = 0.0f, ax = 0.0f, ay = 0.0f;
  if (live) {
    const T* g_row = dcols + q * s.C;
    for (int v = lane * VEC; v < s.C; v += lanes * VEC) {
      float g[VEC];
      Vec<T, VEC>::unpack(Vec<T, VEC>::load(g_row + v), g);
      float val[4][VEC];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (idx[k] >= 0) {
          Vec<T, VEC>::unpack(Vec<T, VEC>::load(x + idx[k] + v), val[k]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) val[k][e] = 0.0f;
        }
      }
      point_sums<VEC>(g, val, w, fx, fy, sm, ax, ay);
      if (dx != nullptr) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (idx[k] < 0 || w[k] == 0.0f) continue;
          float add[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) add[e] = m * w[k] * g[e];
          red_add<VEC>(dx + idx[k] + v, add);
        }
      }
    }
  }
  sm = group_sum(sm, lanes);
  ax = group_sum(ax, lanes);
  ay = group_sum(ay, lanes);
  if (live && lane == 0) {
    store(dmask + q, sm);
    store(doffset_x + q, m * ax);
    store(doffset_y + q, m * ay);
  }
}

// The forward's geometry: a group of `lanes` threads per (pixel, group)
// item, lane l taking the VEC-vectors l, l + lanes, ... of its Cg channels;
// block b holds BWD_THREADS / lanes consecutive pixels, from tile b / G on,
// of group b % G. For each round of `lanes` points, lane l decodes point
// r0 + l (p = ix*kh + iy) in the forward's closed form; the group walks the
// round's points in order, point j's corners shuffled from lane j, each
// lane scattering its share of dvalue and summing its share of the point's
// three gradients; the group's sums land in lane j, which stores them
// after the round. Every lane of the warp joins every shuffle.
template <typename T, int VEC>
__global__ void __launch_bounds__(BWD_THREADS)
dcnv3_core_bwd_kernel(const T* __restrict__ value, const T* __restrict__ offset, const T* __restrict__ mask,
                      const T* __restrict__ dout, float* __restrict__ dvalue, T* __restrict__ doffset,
                      T* __restrict__ dmask, V3Shape s, int lanes, bool pair) {
  const int P = s.kh * s.kw;
  const int C = s.G * s.Cg;
  const int npix = s.N * s.Ho * s.Wo;
  const int lane = threadIdx.x & (lanes - 1);
  const int tile = blockIdx.x / s.G;
  const int g = blockIdx.x - tile * s.G;
  const int pix = tile * (BWD_THREADS / lanes) + threadIdx.x / lanes;
  const bool live = pix < npix;
  const int ox = pix % s.Wo;
  const int oy = (pix / s.Wo) % s.Ho;
  const int n = pix / (s.Wo * s.Ho);
  const int half_x = (s.dw * (s.kw - 1)) / 2;
  const int half_y = (s.dh * (s.kh - 1)) / 2;
  const float cx = static_cast<float>(half_x + ox * s.sw - s.pw);
  const float cy = static_cast<float>(half_y + oy * s.sh - s.ph);
  const size_t q0 = (static_cast<size_t>(pix) * s.G + g) * P;  // the item's first point
  const long long base = static_cast<long long>(n) * s.H * s.W * C + g * s.Cg;  // the item's image
  const T* g_src = dout + static_cast<size_t>(pix) * C + g * s.Cg;
  for (int r0 = 0; r0 < P; r0 += lanes) {
    long long idx[4] = {-1, -1, -1, -1};
    float w[4] = {0.0f, 0.0f, 0.0f, 0.0f}, fx = 0.0f, fy = 0.0f, m = 0.0f;
    const int p = r0 + lane;
    const bool mine = live && p < P;
    if (mine) {
      const int ix = p / s.kh;
      const int iy = p - ix * s.kh;
      const float2 o = load_pair(offset + 2 * (q0 + p), pair);
      const float px = cx + (static_cast<float>(ix * s.dw - half_x) + o.x) * s.offset_scale;
      const float py = cy + (static_cast<float>(iy * s.dh - half_y) + o.y) * s.offset_scale;
      m = to_f32(__ldg(mask + q0 + p));
      corners(px, py, s.H, s.W, C, base, idx, w, fx, fy);
    }
    float own_m = 0.0f, own_x = 0.0f, own_y = 0.0f;  // this lane's point's gradients
    const int points = min(lanes, P - r0);
    for (int j = 0; j < points; ++j) {
      long long ij[4];
      float wj[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ij[k] = __shfl_sync(FULL_WARP, idx[k], j, lanes);
        wj[k] = __shfl_sync(FULL_WARP, w[k], j, lanes);
      }
      const float fxj = __shfl_sync(FULL_WARP, fx, j, lanes);
      const float fyj = __shfl_sync(FULL_WARP, fy, j, lanes);
      const float mj = __shfl_sync(FULL_WARP, m, j, lanes);
      float sm = 0.0f, ax = 0.0f, ay = 0.0f;
      for (int c0 = 0; c0 < s.Cg; c0 += lanes * VEC) {
        const int v = c0 + lane * VEC;
        if (!live || v >= s.Cg) continue;
        float gv[VEC];
        Vec<T, VEC>::unpack(Vec<T, VEC>::load(g_src + v), gv);
        float val[4][VEC];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (ij[k] >= 0) {
            Vec<T, VEC>::unpack(Vec<T, VEC>::load(value + ij[k] + v), val[k]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) val[k][e] = 0.0f;
          }
        }
        point_sums<VEC>(gv, val, wj, fxj, fyj, sm, ax, ay);
        if (dvalue != nullptr) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (ij[k] < 0 || wj[k] == 0.0f) continue;
            float add[VEC];
#pragma unroll
            for (int e = 0; e < VEC; ++e) add[e] = mj * wj[k] * gv[e];
            red_add<VEC>(dvalue + ij[k] + v, add);
          }
        }
      }
      sm = group_sum(sm, lanes);
      ax = group_sum(ax, lanes);
      ay = group_sum(ay, lanes);
      if (lane == j) {
        own_m = sm;
        own_x = mj * ax * s.offset_scale;
        own_y = mj * ay * s.offset_scale;
      }
    }
    if (mine) {
      store(dmask + q0 + p, own_m);
      store(doffset + 2 * (q0 + p), own_x);
      store(doffset + 2 * (q0 + p) + 1, own_y);
    }
  }
}

// `vec` is 1 or 16 / sizeof(T) (then C % vec == 0 and x, dcols 16-byte
// aligned); `lanes` a power of two up to 32: ops/dcn.py::_v3_geometry of C.
template <typename T>
int launch_v2_bwd(const void* x, const void* offset_y, const void* offset_x, const void* mask, const void* dcols,
                  void* dx, void* doffset_y, void* doffset_x, void* dmask, V2Shape s, int vec, int lanes,
                  void* stream) {
  constexpr int FULL = 16 / sizeof(T);
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = static_cast<long long>(s.N) * s.Ho * s.Wo * s.k * s.k;
  const long long blocks = (pairs * lanes + BWD_THREADS - 1) / BWD_THREADS;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xx = static_cast<const T*>(x);
  const T* oy = static_cast<const T*>(offset_y);
  const T* ox = static_cast<const T*>(offset_x);
  const T* m = static_cast<const T*>(mask);
  const T* g = static_cast<const T*>(dcols);
  float* d = static_cast<float*>(dx);
  T* doy = static_cast<T*>(doffset_y);
  T* dox = static_cast<T*>(doffset_x);
  T* dm = static_cast<T*>(dmask);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec == 1)
    dcnv2_im2col_bwd_kernel<T, 1><<<grid, BWD_THREADS, 0, st>>>(xx, oy, ox, m, g, d, doy, dox, dm, s, lanes);
  else if (vec == FULL && s.C % FULL == 0)
    dcnv2_im2col_bwd_kernel<T, FULL><<<grid, BWD_THREADS, 0, st>>>(xx, oy, ox, m, g, d, doy, dox, dm, s, lanes);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// `vec` is 1 or 16 / sizeof(T) (then Cg % vec == 0 and value, dout 16-byte
// aligned); `lanes` a power of two up to 32: ops/dcn.py::_v3_geometry.
template <typename T>
int launch_v3_bwd(const void* value, const void* offset, const void* mask, const void* dout, void* dvalue,
                  void* doffset, void* dmask, V3Shape s, int vec, int lanes, void* stream) {
  constexpr int FULL = 16 / sizeof(T);
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = BWD_THREADS / lanes;
  const long long tiles = (static_cast<long long>(s.N) * s.Ho * s.Wo + per_block - 1) / per_block;
  if (static_cast<long long>(s.N) * s.Ho * s.Wo * s.G * s.kh * s.kw * 2 >= (1LL << 31) ||
      tiles * s.G >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles * s.G == 0 || s.Cg == 0) return static_cast<int>(cudaGetLastError());
  const int blocks = static_cast<int>(tiles * s.G);
  const bool pair = reinterpret_cast<uintptr_t>(offset) % (2 * sizeof(T)) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* v = static_cast<const T*>(value);
  const T* o = static_cast<const T*>(offset);
  const T* m = static_cast<const T*>(mask);
  const T* g = static_cast<const T*>(dout);
  float* dv = static_cast<float*>(dvalue);
  T* dof = static_cast<T*>(doffset);
  T* dm = static_cast<T*>(dmask);
  if (vec == 1)
    dcnv3_core_bwd_kernel<T, 1><<<blocks, BWD_THREADS, 0, st>>>(v, o, m, g, dv, dof, dm, s, lanes, pair);
  else if (vec == FULL && s.Cg % FULL == 0)
    dcnv3_core_bwd_kernel<T, FULL><<<blocks, BWD_THREADS, 0, st>>>(v, o, m, g, dv, dof, dm, s, lanes, pair);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

V3Shape v3_shape(int N, int H, int W, int G, int Cg, int Ho, int Wo, int kh, int kw, int sh, int sw, int ph, int pw,
                 int dh, int dw, float offset_scale) {
  return V3Shape{N, H, W, G, Cg, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw, offset_scale};
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous tensors (dx / dvalue: a zeroed f32 buffer of the input's
// shape, or null for no input gradient); `stream` is a cudaStream_t. Each
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int dcnv2_im2col_bwd_f32(const void* x, const void* offset_y, const void* offset_x, const void* mask,
                                    const void* dcols, void* dx, void* doffset_y, void* doffset_x, void* dmask, int N,
                                    int H, int W, int C, int Ho, int Wo, int k, int stride, int pad, int vec,
                                    int lanes, void* stream) {
  return launch_v2_bwd<float>(x, offset_y, offset_x, mask, dcols, dx, doffset_y, doffset_x, dmask,
                              V2Shape{N, H, W, C, Ho, Wo, k, stride, pad}, vec, lanes, stream);
}

extern "C" int dcnv2_im2col_bwd_bf16(const void* x, const void* offset_y, const void* offset_x, const void* mask,
                                     const void* dcols, void* dx, void* doffset_y, void* doffset_x, void* dmask,
                                     int N, int H, int W, int C, int Ho, int Wo, int k, int stride, int pad, int vec,
                                     int lanes, void* stream) {
  return launch_v2_bwd<__nv_bfloat16>(x, offset_y, offset_x, mask, dcols, dx, doffset_y, doffset_x, dmask,
                                      V2Shape{N, H, W, C, Ho, Wo, k, stride, pad}, vec, lanes, stream);
}

extern "C" int dcnv3_core_bwd_f32(const void* value, const void* offset, const void* mask, const void* dout,
                                  void* dvalue, void* doffset, void* dmask, int N, int H, int W, int G, int Cg, int Ho,
                                  int Wo, int kh, int kw, int sh, int sw, int ph, int pw, int dh, int dw,
                                  float offset_scale, int vec, int lanes, void* stream) {
  return launch_v3_bwd<float>(value, offset, mask, dout, dvalue, doffset, dmask,
                              v3_shape(N, H, W, G, Cg, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw, offset_scale), vec,
                              lanes, stream);
}

extern "C" int dcnv3_core_bwd_bf16(const void* value, const void* offset, const void* mask, const void* dout,
                                   void* dvalue, void* doffset, void* dmask, int N, int H, int W, int G, int Cg,
                                   int Ho, int Wo, int kh, int kw, int sh, int sw, int ph, int pw, int dh, int dw,
                                   float offset_scale, int vec, int lanes, void* stream) {
  return launch_v3_bwd<__nv_bfloat16>(value, offset, mask, dout, dvalue, doffset, dmask,
                                      v3_shape(N, H, W, G, Cg, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw, offset_scale),
                                      vec, lanes, stream);
}
