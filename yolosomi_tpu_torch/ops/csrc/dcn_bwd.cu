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
// Bound: the least traffic reads dcols / dout, the input, offsets and mask
// once and writes dinput, doffset and dmask once: at 640 px, b8, bf16, row
// 6 of yolo-somi-dcn moves ~73 MB a launch (59 MB of dcols), row 8 ~37 MB,
// row 10 (DCNv3) ~14.7 MB. What held the first kernels back was the input
// gradient's scatter: at row 6, 4 corners x N*Ho*Wo*P*C = 118 M f32 adds a
// launch, each element of the 13 MB dx taking ~36 of them in L2's atomic
// units.
//
// Design: one kernel serves both (DCNv2 is the one-group case with p =
// ky*k + kx and separate offset planes). A block takes a tile of th x tw
// output pixels of one image (and, for DCNv3, one group) and one slice of
// cs channels. Its threads first decode every (pixel, point) pair of the
// tile into a table in shared memory. Around the tile lies a window of
// fh x fw map pixels: the tile's receptive field, its bilinear +1 corner
// and `halo` pixels on each side for the offsets. The block sorts the
// corners that land in the window by window pixel (a count, a scan and a
// fill with integer shared-memory atomics, which are native; Hopper has no
// native f32 add in shared memory, and its compare-and-swap loops cost as
// much as the L2 atomics they would save). Then:
// - lane groups walk the pairs: each pair's offset and mask sums over the
//   slice, and its corners past the window (an offset past the halo)
//   added straight to global memory;
// - lane groups walk the window pixels: each gathers its list of corners
//   in registers (m * w_k * g_c from the table and the upstream gradient)
//   and adds the result to global memory once, with one 16-byte f32
//   reduction per 4 channels.
// Only windows overlap, so an element of dx takes a few global adds
// instead of ~36. In the pair loop a lane takes 16 bytes of channels (8
// bf16 or 4 f32; one channel where the channels or a pointer do not allow
// it); in the gather it takes runs of 4 channels (bf16 two 8-byte runs,
// 4*lanes channels apart), so a warp's 16-byte f32 reductions cover
// contiguous bytes in both dtypes.
//
// doffset and dmask are deterministic: a pair's sums over its slice reduce
// over the lane group with xor shuffles in a fixed order; with one slice
// lane 0 stores them, with several it writes them to an f32 workspace and
// a second kernel adds the slices in order. dinput is not bitwise
// repeatable: a window pixel's list is filled in a varying order, and the
// windows' and spills' global atomics add in a varying order, into a
// zeroed f32 buffer that the wrapper casts once to the input's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dcn_common.cuh"

namespace {

constexpr int BWD_THREADS = 256;    // threads per block (ops/dcn.py::_BWD_THREADS)
constexpr int BWD_BLOCKS = 4;       // blocks an SM the registers must allow (64 a thread)
constexpr int SMEM_BLOCK = 232448;  // the most shared memory an H100 block may take (227 KB)
// 4-byte words of shared memory per (pixel, point) pair of a tile and per
// window pixel (ops/dcn.py::_BWD_PAIR_WORDS, _BWD_PIXEL_WORDS): the pair
// table's 7 and its 4 corners' list entries; a count and a fill cursor
constexpr int PAIR_WORDS = 11;
constexpr int PIXEL_WORDS = 2;

// 4 bf16 channels: an 8-byte load
template <>
struct Vec<__nv_bfloat16, 4> {
  using Raw = uint2;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ static void unpack(Raw u, float* v) {
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  }
};

// A launch plan (ops/dcn.py::_v3_bwd_plan): tiles of th x tw output
// pixels, ty x tx of them a map; slices of cs channels; a window of fh x fw
// map pixels from (tile origin * stride - pad - halo)
struct Tiles {
  int th, tw, cs, halo, fh, fw, ty, tx, slices;
};

// dst[0 .. N) += v[0 .. N) in global memory: 16-byte f32 reductions where
// N is a multiple of 4 (dst 16-byte aligned), else scalar f32 atomics
template <int N>
__device__ __forceinline__ void red_add(float* dst, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      atomicAdd(reinterpret_cast<float4*>(dst + i), make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) atomicAdd(dst + i, v[i]);
  }
}

// The bilinear weight of corner k = (k & 1, k >> 1) at fractions (fx, fy)
__device__ __forceinline__ float corner_weight(int k, float fx, float fy) {
  return ((k & 1) ? fx : 1.0f - fx) * ((k >> 1) ? fy : 1.0f - fy);
}

// A pair's gradients, (sm, ax, ay) summed over all its channels: dmask and
// the offsets' (DCNv2: doffset_y, doffset_x; DCNv3: the (x, y) pairs)
template <bool V3, typename T>
__device__ __forceinline__ void store_sums(T* d_a, T* d_b, T* dmask, long long q, float m, float scale, float sm,
                                           float ax, float ay) {
  store(dmask + q, sm);
  if constexpr (V3) {
    store(d_a + 2 * q, m * ax * scale);
    store(d_a + 2 * q + 1, m * ay * scale);
  } else {
    store(d_a + q, m * ay);
    store(d_b + q, m * ax);
  }
}

// Block b = (((n * G + g) * ty + tile row) * tx + tile column) * slices +
// slice. Its pairs t = p * th*tw + i, the tile's pixel i (row-major)
// fastest, and its window pixels go to lane groups of `lanes` = cs / VEC
// threads, BWD_THREADS / lanes at a time. In the pair loop lane l takes
// channels slice*cs + l*VEC .. + VEC; in the gather the VEC / RUN runs of
// RUN channels at slice*cs + (r*lanes + l)*RUN, r = 0, 1, ... The pair
// loop is warp-uniform: every lane joins every shuffle.
// DCNv2 (V3 false): x (N, H, W, C), off_a / off_b the y / x offsets and
// mask at pair q = pix*P + p, grad = dcols (q*C ..); d_a / d_b doffset_y /
// doffset_x. DCNv3: off_a the (x, y) offsets at 2q, q = (pix*G + g)*P + p,
// p = ix*kh + iy, grad = dout (pix*C + g*Cg ..); d_a doffset.
// `part` (slices > 1): the pairs' partial sums, [slice][3][Q].
template <typename T, int VEC, bool V3>
__device__ __forceinline__ void sampling_bwd(const T* __restrict__ x, const T* __restrict__ off_a,
                                             const T* __restrict__ off_b, const T* __restrict__ mask,
                                             const T* __restrict__ grad, float* __restrict__ dx, T* __restrict__ d_a,
                                             T* __restrict__ d_b, T* __restrict__ dmask, float* __restrict__ part,
                                             const V3Shape& s, const Tiles& pl, bool pair) {
  constexpr int RUN = VEC >= 4 ? 4 : 1;
  constexpr int RUNS = VEC / RUN;
  extern __shared__ int smem[];
  const int P = s.kh * s.kw;
  const int C = s.G * s.Cg;
  const int lanes = pl.cs / VEC;
  const int lane = threadIdx.x & (lanes - 1);
  int b = blockIdx.x;
  const int slice = b % pl.slices;
  b /= pl.slices;
  const int tile_x = b % pl.tx;
  b /= pl.tx;
  const int tile_y = b % pl.ty;
  b /= pl.ty;
  const int g = b % s.G;
  const int n = b / s.G;
  const int oy0 = tile_y * pl.th;
  const int ox0 = tile_x * pl.tw;
  const int y_lo = oy0 * s.sh - s.ph - pl.halo;
  const int x_lo = ox0 * s.sw - s.pw - pl.halo;
  const int wpix = pl.fh * pl.fw;
  const int pairs = pl.th * pl.tw * P;
  int cr[RUNS];  // this lane's runs' first channels in the group, -1 past Cg
#pragma unroll
  for (int r = 0; r < RUNS; ++r) {
    const int c = slice * pl.cs + (r * lanes + lane) * RUN;
    cr[r] = c < s.Cg ? c : -1;
  }
  const int img = n * s.H * s.W * C + g * s.Cg;  // 32-bit offsets: every tensor < 2**31 elements (ops/dcn.py)
  const long long Q = static_cast<long long>(s.N) * s.Ho * s.Wo * s.G * P;
  // shared memory: the pair table (7 words a pair), the window pixels'
  // counts (then their lists' starts, one more for the end) and fill
  // cursors, and the lists (one word a listed corner: t*4 + k)
  int* t_x0 = smem;
  int* t_y0 = t_x0 + pairs;
  float* t_fx = reinterpret_cast<float*>(t_x0 + 2 * pairs);
  float* t_fy = t_fx + pairs;
  float* t_m = t_fx + 2 * pairs;
  int* t_q = t_x0 + 5 * pairs;  // the pair's index, -1 past the map
  int* t_g = t_x0 + 6 * pairs;  // its upstream gradient row
  int* start = t_x0 + 7 * pairs;
  int* fill = start + wpix + 1;
  int* list = fill + wpix;
  // a corner's window pixel, or -1 where it adds nothing (off the map, of
  // weight 0: 3 of 4 at an integer point) or lies past the window (spills)
  auto listed = [&](int x0, int y0, float w, int k, bool& spill) {
    const int xc = x0 + (k & 1);
    const int yc = y0 + (k >> 1);
    const bool adds = w != 0.0f && xc >= 0 && xc <= s.W - 1 && yc >= 0 && yc <= s.H - 1;
    const int wy = yc - y_lo;
    const int wx = xc - x_lo;
    const bool inside = static_cast<unsigned>(wy) < static_cast<unsigned>(pl.fh) &&
                        static_cast<unsigned>(wx) < static_cast<unsigned>(pl.fw);
    spill = adds && !inside;
    return adds && inside ? wy * pl.fw + wx : -1;
  };
  if (dx != nullptr) {
    for (int i = threadIdx.x; i < 2 * wpix + 1; i += BWD_THREADS) start[i] = 0;
    __syncthreads();
  }
  // the table, point fastest: neighbouring threads read neighbouring
  // offsets; each listed corner counted at its window pixel
  for (int u = threadIdx.x; u < pairs; u += BWD_THREADS) {
    const int i = u / P;
    const int p = u - i * P;
    const int t = p * pl.th * pl.tw + i;
    const int oy = oy0 + i / pl.tw;
    const int ox = ox0 + i % pl.tw;
    int q = -1, goff = 0;
    float px = 0.0f, py = 0.0f, m = 0.0f;
    if (oy < s.Ho && ox < s.Wo) {
      const int pix = (n * s.Ho + oy) * s.Wo + ox;
      if constexpr (V3) {
        q = (pix * s.G + g) * P + p;
        const int half_x = (s.dw * (s.kw - 1)) / 2;
        const int half_y = (s.dh * (s.kh - 1)) / 2;
        const int ix = p / s.kh;
        const int iy = p - ix * s.kh;
        const float2 o = load_pair(off_a + 2 * static_cast<long long>(q), pair);
        const float cx = static_cast<float>(half_x + ox * s.sw - s.pw);
        const float cy = static_cast<float>(half_y + oy * s.sh - s.ph);
        px = cx + (static_cast<float>(ix * s.dw - half_x) + o.x) * s.offset_scale;
        py = cy + (static_cast<float>(iy * s.dh - half_y) + o.y) * s.offset_scale;
        goff = pix * C + g * s.Cg;
      } else {
        q = pix * P + p;
        const int ky = p / s.kw;
        const int kx = p - ky * s.kw;
        py = static_cast<float>(oy * s.sh - s.ph + ky) + to_f32(__ldg(off_a + q));
        px = static_cast<float>(ox * s.sw - s.pw + kx) + to_f32(__ldg(off_b + q));
        goff = q * C;
      }
      m = to_f32(__ldg(mask + q));
    }
    const float x0f = floorf(px);
    const float y0f = floorf(py);
    const int x0 = static_cast<int>(x0f);
    const int y0 = static_cast<int>(y0f);
    const float fx = px - x0f;
    const float fy = py - y0f;
    t_x0[t] = x0;
    t_y0[t] = y0;
    t_fx[t] = fx;
    t_fy[t] = fy;
    t_m[t] = m;
    t_q[t] = q;
    t_g[t] = goff;
    if (dx != nullptr && q >= 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bool spill;
        const int wp = listed(x0, y0, corner_weight(k, fx, fy), k, spill);
        if (wp >= 0) atomicAdd(start + wp, 1);
      }
    }
  }
  __syncthreads();
  if (dx != nullptr) {
    // the counts to the lists' starts: an exclusive scan by the first warp
    if (threadIdx.x < 32) {
      const int per = (wpix + 31) / 32;
      const int lo = threadIdx.x * per;
      const int hi = min(lo + per, wpix);
      int sum = 0;
      for (int i = lo; i < hi; ++i) sum += start[i];
      int incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL_WARP, incl, o);
        if (static_cast<int>(threadIdx.x) >= o) incl += v;
      }
      int run = incl - sum;
      for (int i = lo; i < hi; ++i) {
        const int c = start[i];
        start[i] = run;
        run += c;
      }
      if (threadIdx.x == 31) start[wpix] = incl;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < pairs; t += BWD_THREADS) {
      if (t_q[t] < 0) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bool spill;
        const int wp = listed(t_x0[t], t_y0[t], corner_weight(k, t_fx[t], t_fy[t]), k, spill);
        if (wp >= 0) list[start[wp] + atomicAdd(fill + wp, 1)] = t * 4 + k;
      }
    }
  }
  // the pairs: their sums, and their corners past the window
  for (int t0 = 0; t0 < pairs; t0 += BWD_THREADS / lanes) {
    const int t = t0 + static_cast<int>(threadIdx.x) / lanes;
    const int q = t < pairs ? t_q[t] : -1;
    float sm = 0.0f, ax = 0.0f, ay = 0.0f;
    const int cv = slice * pl.cs + lane * VEC;  // the lane's VEC channels in the pair loop
    if (q >= 0 && cv < s.Cg) {
      const int x0 = t_x0[t];
      const int y0 = t_y0[t];
      const float fx = t_fx[t];
      const float fy = t_fy[t];
      const float m = t_m[t];
      const T* g_row = grad + t_g[t];
      float gv[VEC], val[4][VEC], w[4];
      int at[4];  // the corner's element offset in x and dx, -1 off the map
      Vec<T, VEC>::unpack(Vec<T, VEC>::load(g_row + cv), gv);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int xc = x0 + (k & 1);
        const int yc = y0 + (k >> 1);
        const bool inside = xc >= 0 && xc <= s.W - 1 && yc >= 0 && yc <= s.H - 1;
        at[k] = inside ? img + (yc * s.W + xc) * C : -1;
        w[k] = inside ? corner_weight(k, fx, fy) : 0.0f;
        if (inside) {
          Vec<T, VEC>::unpack(Vec<T, VEC>::load(x + at[k] + cv), val[k]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) val[k][e] = 0.0f;
        }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float v00 = val[0][e], v10 = val[1][e], v01 = val[2][e], v11 = val[3][e];
        const float sample = w[0] * v00 + w[1] * v10 + w[2] * v01 + w[3] * v11;
        sm = fmaf(gv[e], sample, sm);
        ax = fmaf(gv[e], (1.0f - fy) * (v10 - v00) + fy * (v11 - v01), ax);
        ay = fmaf(gv[e], (1.0f - fx) * (v01 - v00) + fx * (v11 - v10), ay);
      }
      if (dx != nullptr) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          bool spill;
          listed(x0, y0, w[k], k, spill);
          if (!spill) continue;
          float add[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) add[e] = m * w[k] * gv[e];
          red_add<VEC>(dx + at[k] + cv, add);
        }
      }
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) {
      sm += __shfl_xor_sync(FULL_WARP, sm, o, lanes);
      ax += __shfl_xor_sync(FULL_WARP, ax, o, lanes);
      ay += __shfl_xor_sync(FULL_WARP, ay, o, lanes);
    }
    if (q >= 0 && lane == 0) {
      if (part != nullptr) {
        float* dst = part + static_cast<long long>(slice) * 3 * Q + q;
        dst[0] = sm;
        dst[Q] = ax;
        dst[2 * Q] = ay;
      } else {
        store_sums<V3>(d_a, d_b, dmask, q, t_m[t], s.offset_scale, sm, ax, ay);
      }
    }
  }
  if (dx == nullptr) return;
  __syncthreads();  // every list filled
  // the window pixels: each gathers its corners, then adds to dx once
  for (int wp = threadIdx.x / lanes; wp < wpix; wp += BWD_THREADS / lanes) {
    const int begin = start[wp];
    const int end = start[wp + 1];
    if (begin == end || cr[0] < 0) continue;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    for (int j = begin; j < end; ++j) {
      const int t = list[j] >> 2;
      const float wm = t_m[t] * corner_weight(list[j] & 3, t_fx[t], t_fy[t]);
#pragma unroll
      for (int r = 0; r < RUNS; ++r) {
        if (cr[r] < 0) continue;
        float gv[RUN];
        Vec<T, RUN>::unpack(Vec<T, RUN>::load(grad + t_g[t] + cr[r]), gv);
#pragma unroll
        for (int e = 0; e < RUN; ++e) acc[r * RUN + e] = fmaf(wm, gv[e], acc[r * RUN + e]);
      }
    }
    const int at = img + ((y_lo + wp / pl.fw) * s.W + x_lo + wp % pl.fw) * C;
#pragma unroll
    for (int r = 0; r < RUNS; ++r)
      if (cr[r] >= 0) red_add<RUN>(dx + at + cr[r], acc + r * RUN);
  }
}

// The two kernels, named apart for the profiler
template <typename T, int VEC>
__global__ void __launch_bounds__(BWD_THREADS, BWD_BLOCKS)
dcnv2_im2col_bwd_kernel(const T* x, const T* off_a, const T* off_b, const T* mask, const T* grad, float* dx, T* d_a,
                        T* d_b, T* dmask, float* part, V3Shape s, Tiles pl, bool pair) {
  sampling_bwd<T, VEC, false>(x, off_a, off_b, mask, grad, dx, d_a, d_b, dmask, part, s, pl, pair);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(BWD_THREADS, BWD_BLOCKS)
dcnv3_core_bwd_kernel(const T* x, const T* off_a, const T* off_b, const T* mask, const T* grad, float* dx, T* d_a,
                      T* d_b, T* dmask, float* part, V3Shape s, Tiles pl, bool pair) {
  sampling_bwd<T, VEC, true>(x, off_a, off_b, mask, grad, dx, d_a, d_b, dmask, part, s, pl, pair);
}

// The pairs' sums over the slices, added in slice order, and stored
template <typename T, bool V3>
__device__ __forceinline__ void sums(const float* __restrict__ part, const T* __restrict__ mask, T* __restrict__ d_a,
                                     T* __restrict__ d_b, T* __restrict__ dmask, long long Q, int slices,
                                     float scale) {
  const long long q = static_cast<long long>(blockIdx.x) * BWD_THREADS + threadIdx.x;
  if (q >= Q) return;
  float sm = 0.0f, ax = 0.0f, ay = 0.0f;
  for (int sl = 0; sl < slices; ++sl) {
    const float* src = part + static_cast<long long>(sl) * 3 * Q + q;
    sm += src[0];
    ax += src[Q];
    ay += src[2 * Q];
  }
  store_sums<V3>(d_a, d_b, dmask, q, to_f32(mask[q]), scale, sm, ax, ay);
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
dcnv2_im2col_bwd_sums(const float* part, const T* mask, T* d_a, T* d_b, T* dmask, long long Q, int slices,
                      float scale) {
  sums<T, false>(part, mask, d_a, d_b, dmask, Q, slices, scale);
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
dcnv3_core_bwd_sums(const float* part, const T* mask, T* d_a, T* d_b, T* dmask, long long Q, int slices,
                    float scale) {
  sums<T, true>(part, mask, d_a, d_b, dmask, Q, slices, scale);
}

template <typename T>
using BwdKernel = void (*)(const T*, const T*, const T*, const T*, const T*, float*, T*, T*, T*, float*, V3Shape, Tiles,
                           bool);
template <typename T>
using SumsKernel = void (*)(const float*, const T*, T*, T*, T*, long long, int, float);

// The kernels of DCNv2 (V3 false) or DCNv3
template <typename T, int VEC, bool V3>
BwdKernel<T> bwd_kernel() {
  if constexpr (V3) return dcnv3_core_bwd_kernel<T, VEC>;
  else return dcnv2_im2col_bwd_kernel<T, VEC>;
}

template <typename T, bool V3>
SumsKernel<T> sums_kernel() {
  if constexpr (V3) return dcnv3_core_bwd_sums<T>;
  else return dcnv2_im2col_bwd_sums<T>;
}

// `vec` 1 or 16 / sizeof(T) (then Cg % vec == 0 and x, grad 16-byte
// aligned); `cs` vec times a power of two up to 32; the pair table, the
// window's counts and the lists at most SMEM_BLOCK bytes. part: an f32 workspace of slices * 3 * Q
// floats where the plan has more than one slice, else unused.
template <typename T, bool V3>
int launch_bwd(const void* x, const void* off_a, const void* off_b, const void* mask, const void* grad, void* dx,
               void* d_a, void* d_b, void* dmask, void* part, V3Shape s, int vec, int th, int tw, int cs, int halo,
               int fh, int fw, void* stream) {
  constexpr int FULL = 16 / sizeof(T);
  const int lanes = vec > 0 ? cs / vec : 0;
  if ((vec != 1 && vec != FULL) || cs % vec != 0 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      th < 1 || tw < 1 || halo < 0 || fh < 1 || fw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == FULL && (s.Cg % FULL != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                      reinterpret_cast<uintptr_t>(grad) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long Q = static_cast<long long>(s.N) * s.Ho * s.Wo * s.G * s.kh * s.kw;
  const Tiles pl{th, tw, cs, halo, fh, fw, (s.Ho + th - 1) / th, (s.Wo + tw - 1) / tw, (s.Cg + cs - 1) / cs};
  const long long blocks = static_cast<long long>(s.N) * s.G * pl.ty * pl.tx * pl.slices;
  const size_t smem = (static_cast<size_t>(th) * tw * s.kh * s.kw * PAIR_WORDS + PIXEL_WORDS * fh * fw + 1) * 4;
  if (2 * Q >= (1LL << 31) || blocks >= (1LL << 31) || smem > SMEM_BLOCK || (pl.slices > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0 || Q == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xx = static_cast<const T*>(x);
  const T* oa = static_cast<const T*>(off_a);
  const T* ob = static_cast<const T*>(off_b);
  const T* mk = static_cast<const T*>(mask);
  const T* gr = static_cast<const T*>(grad);
  T* da = static_cast<T*>(d_a);
  T* db = static_cast<T*>(d_b);
  T* dm = static_cast<T*>(dmask);
  float* pt = pl.slices > 1 ? static_cast<float*>(part) : nullptr;
  const bool pair = reinterpret_cast<uintptr_t>(off_a) % (2 * sizeof(T)) == 0;
  const BwdKernel<T> kernel = vec == FULL ? bwd_kernel<T, FULL, V3>() : bwd_kernel<T, 1, V3>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(blocks), BWD_THREADS, smem, st>>>(xx, oa, ob, mk, gr, static_cast<float*>(dx), da,
                                                                    db, dm, pt, s, pl, pair);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || pt == nullptr) return static_cast<int>(e);
  const SumsKernel<T> reduce = sums_kernel<T, V3>();
  reduce<<<static_cast<unsigned>((Q + BWD_THREADS - 1) / BWD_THREADS), BWD_THREADS, 0, st>>>(pt, mk, da, db, dm, Q,
                                                                                           pl.slices, s.offset_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_v2_bwd(const void* x, const void* offset_y, const void* offset_x, const void* mask, const void* dcols,
                  void* dx, void* doffset_y, void* doffset_x, void* dmask, void* part, int N, int H, int W, int C,
                  int Ho, int Wo, int k, int stride, int pad, int vec, int th, int tw, int cs, int halo, int fh,
                  int fw, void* stream) {
  const V3Shape s{N, H, W, 1, C, Ho, Wo, k, k, stride, stride, pad, pad, 1, 1, 1.0f};
  return launch_bwd<T, false>(x, offset_y, offset_x, mask, dcols, dx, doffset_y, doffset_x, dmask, part, s, vec,
                              th, tw, cs, halo, fh, fw, stream);
}

template <typename T>
int launch_v3_bwd(const void* value, const void* offset, const void* mask, const void* dout, void* dvalue,
                  void* doffset, void* dmask, void* part, int N, int H, int W, int G, int Cg, int Ho, int Wo, int kh,
                  int kw, int sh, int sw, int ph, int pw, int dh, int dw, float offset_scale, int vec, int th, int tw,
                  int cs, int halo, int fh, int fw, void* stream) {
  const V3Shape s{N, H, W, G, Cg, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw, offset_scale};
  return launch_bwd<T, true>(value, offset, nullptr, mask, dout, dvalue, doffset, nullptr, dmask, part, s, vec, th,
                             tw, cs, halo, fh, fw, stream);
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous tensors (dx / dvalue: a zeroed f32 buffer of the input's
// shape, or null for no input gradient; part: the plan's f32 workspace or
// null); the plan (vec, th, tw, cs, halo, fh, fw) is ops/dcn.py's
// _v2_bwd_plan / _v3_bwd_plan; `stream` is a cudaStream_t. Each returns
// cudaGetLastError() after its launches (0 on success).
extern "C" int dcnv2_im2col_bwd_f32(const void* x, const void* offset_y, const void* offset_x, const void* mask,
                                    const void* dcols, void* dx, void* doffset_y, void* doffset_x, void* dmask,
                                    void* part, int N, int H, int W, int C, int Ho, int Wo, int k, int stride, int pad,
                                    int vec, int th, int tw, int cs, int halo, int fh, int fw, void* stream) {
  return launch_v2_bwd<float>(x, offset_y, offset_x, mask, dcols, dx, doffset_y, doffset_x, dmask, part, N, H, W, C,
                              Ho, Wo, k, stride, pad, vec, th, tw, cs, halo, fh, fw, stream);
}

extern "C" int dcnv2_im2col_bwd_bf16(const void* x, const void* offset_y, const void* offset_x, const void* mask,
                                     const void* dcols, void* dx, void* doffset_y, void* doffset_x, void* dmask,
                                     void* part, int N, int H, int W, int C, int Ho, int Wo, int k, int stride,
                                     int pad, int vec, int th, int tw, int cs, int halo, int fh, int fw,
                                     void* stream) {
  return launch_v2_bwd<__nv_bfloat16>(x, offset_y, offset_x, mask, dcols, dx, doffset_y, doffset_x, dmask, part, N,
                                      H, W, C, Ho, Wo, k, stride, pad, vec, th, tw, cs, halo, fh, fw, stream);
}

extern "C" int dcnv3_core_bwd_f32(const void* value, const void* offset, const void* mask, const void* dout,
                                  void* dvalue, void* doffset, void* dmask, void* part, int N, int H, int W, int G,
                                  int Cg, int Ho, int Wo, int kh, int kw, int sh, int sw, int ph, int pw, int dh,
                                  int dw, float offset_scale, int vec, int th, int tw, int cs, int halo, int fh,
                                  int fw, void* stream) {
  return launch_v3_bwd<float>(value, offset, mask, dout, dvalue, doffset, dmask, part, N, H, W, G, Cg, Ho, Wo, kh,
                              kw, sh, sw, ph, pw, dh, dw, offset_scale, vec, th, tw, cs, halo, fh, fw, stream);
}

extern "C" int dcnv3_core_bwd_bf16(const void* value, const void* offset, const void* mask, const void* dout,
                                   void* dvalue, void* doffset, void* dmask, void* part, int N, int H, int W, int G,
                                   int Cg, int Ho, int Wo, int kh, int kw, int sh, int sw, int ph, int pw, int dh,
                                   int dw, float offset_scale, int vec, int th, int tw, int cs, int halo, int fh,
                                   int fw, void* stream) {
  return launch_v3_bwd<__nv_bfloat16>(value, offset, mask, dout, dvalue, doffset, dmask, part, N, H, W, G, Cg, Ho,
                                      Wo, kh, kw, sh, sw, ph, pw, dh, dw, offset_scale, vec, th, tw, cs, halo, fh, fw,
                                      stream);
}
