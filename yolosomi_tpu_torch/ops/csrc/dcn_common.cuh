// Pieces shared by the deformable sampling kernels of dcn.cu (the
// forwards) and dcn_bwd.cu (their gradients): the launch shapes, the
// 16-byte channel vectors of f32 and bf16 and their loads, FMAs, unpacking
// and stores, and DCNv3's (x, y) offset pairs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr unsigned FULL_WARP = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// row0: the first output row (a strip of a spatially sharded map: its
// output rows are rows row0 .. row0 + Ho - 1 of the whole output, sampled
// from the whole map x); 0 for the whole output
struct V2Shape {
  int N, H, W, C, Ho, Wo, k, stride, pad;
  int row0;
};

// VEC channels of one corner, or of one output run: `load` reads them
// (through the read-only path), `fma` adds w times them to VEC f32 sums,
// `unpack` widens them to VEC floats.
// `stream` stores with st.global.cs (data read once, later, from HBM);
// VEC = 1 stores plainly either way.
template <typename T, int VEC>
struct Vec;

template <typename T>
struct Vec<T, 1> {
  using Raw = T;
  __device__ __forceinline__ static Raw load(const T* p) { return __ldg(p); }
  __device__ __forceinline__ static void fma(float* acc, float w, Raw r) { acc[0] = fmaf(w, to_f32(r), acc[0]); }
  __device__ __forceinline__ static void unpack(Raw r, float* v) { v[0] = to_f32(r); }
  __device__ __forceinline__ static void store(T* p, const float* v, bool) { ::store(p, v[0]); }
};

template <>
struct Vec<float, 4> {
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ __forceinline__ static void fma(float* acc, float w, Raw v) {
    acc[0] = fmaf(w, v.x, acc[0]);
    acc[1] = fmaf(w, v.y, acc[1]);
    acc[2] = fmaf(w, v.z, acc[2]);
    acc[3] = fmaf(w, v.w, acc[3]);
  }
  __device__ __forceinline__ static void unpack(Raw r, float* v) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v, bool stream) {
    const float4 f = make_float4(v[0], v[1], v[2], v[3]);
    if (stream)
      __stcs(reinterpret_cast<float4*>(p), f);
    else
      *reinterpret_cast<float4*>(p) = f;
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void fma(float* acc, float w, Raw u) {
    const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bf16 -> f32 is the top half of the f32 word: one shift or mask each
      const float2 f = make_float2(__uint_as_float(words[i] << 16), __uint_as_float(words[i] & 0xffff0000u));
      acc[2 * i] = fmaf(w, f.x, acc[2 * i]);
      acc[2 * i + 1] = fmaf(w, f.y, acc[2 * i + 1]);
    }
  }
  __device__ __forceinline__ static void unpack(Raw u, float* v) {
    const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(words[i] << 16);
      v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v, bool stream) {
    unsigned words[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      words[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    const uint4 u = make_uint4(words[0], words[1], words[2], words[3]);
    if (stream)
      __stcs(reinterpret_cast<uint4*>(p), u);
    else
      *reinterpret_cast<uint4*>(p) = u;
  }
};

// dcnv3_core's (x, y) offset pair of one point as f32: one load where the
// pair is aligned to its size (`pair`), else two
__device__ __forceinline__ float2 load_pair(const float* p, bool pair) {
  return pair ? __ldg(reinterpret_cast<const float2*>(p)) : make_float2(__ldg(p), __ldg(p + 1));
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p, bool pair) {
  return pair ? __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)))
              : make_float2(to_f32(__ldg(p)), to_f32(__ldg(p + 1)));
}

// row0 as V2Shape's; the gradient kernels take 0 (brace-initialised)
struct V3Shape {
  int N, H, W, G, Cg, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw;
  float offset_scale;
  int row0;
};

}  // namespace
