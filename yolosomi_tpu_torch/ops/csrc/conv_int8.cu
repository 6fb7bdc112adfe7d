// conv_int8: the int8 convolution of int8 serving, with the activation's
// int8 quantize fused into the kernel's loads of x.
//
// Replaces, on the GPU, the JAX package's int8 conv, which is XLA and not
// Pallas: `x_q = clip(round(x / s_a), -127, 127)`, then
// `jax.lax.conv_general_dilated(x_q, w_q, ..., preferred_element_type=
// jnp.int32)` and `y.astype(f32) * (s_a * w_scale) + bias` in
// ConvRaw._int8_forward (yolosomi_tpu/models/layers.py:192-255, the
// non-fold branch; the conv at :238). PyTorch has no int8 convolution on
// CUDA, so the port brings its own. The plain versions are
// conv_int8_fused_reference and conv_int8_reference in
// yolosomi_tpu_torch/ops/int8.py.
//
//   x: the conv's input as an NHWC view (B, H, W, C), f32, bf16 or (the
//   int8-input entry) int8, channels contiguous, any pixel stride (a
//   channel slice of a wider channels_last tensor is read in place);
//   s_a: f32, one scale or one per input channel; w: the packed int8
//   weights (ops/int8.py::pack_conv_int8_weights); scale (N,) f32, bias
//   (N,) f32 or null -> out (B, Ho, Wo, N): the int32 sums (OUT_I32), or
//   float(acc) * scale + bias (two roundings, no FMA: XLA's mul then add)
//   as f32 or bf16 (round to nearest even).
//   Each x element is quantized as clamp(rint(x / s_a[c]), -127, 127),
//   with IEEE division and round half to even: torch.round(x.float() / s)
//   and jnp.round give the same bits. No int8 copy of x is ever written.
//
// What bounds it on an H100: at the flagship's serving shapes (640 px,
// batch 8) the fused function must read x once in its own dtype (bf16: 2
// bytes an element) and write the output once; the operations run at the
// dense int8 tensor-core rate (1,979 TOP/s). The 1x1 convs and the narrow
// 3x3 ones are bound by bytes, the 3x3 convs of 256 channels and more by
// operations. chip_smoke.py prints each shape's bound.
//
// Design:
// - groups == 1 and N >= 8: an implicit GEMM over M = B*Ho*Wo output pixels
//   and N output channels. K runs over blocks of 128 input channels, each
//   block tap by tap: a stage is one tap of one block, 128 bytes of K, whose
//   channels past C are zero, so a 32-byte wgmma K step never straddles two
//   taps and a tap's channels are multiplied rounded up to 32 (C' =
//   round_up(C, 32): C = 177 costs 8.5% more products, C = 3 a tenth of a
//   step's). The weights are repacked once into that (N, K) layout
//   (ops/int8.py); the int8 quantizer's operand cache keeps them.
//   - A block is one producer warpgroup and one consumer warpgroup (64
//     output pixels: wgmma's M) over a ring of STAGES shared-memory stages,
//     in wgmma's 128-byte-swizzled K-major layout, with full / empty
//     mbarriers; two blocks an SM where BN <= 128.
//   - The tile: th x tw output pixels of one image for a kh x kw conv, 64
//     consecutive pixels for a 1 x 1 one. For each block of 128 channels the
//     producers load the tile's halo of x once (16-byte vectors where the
//     view's alignment allows, else element by element; off the map and past
//     C zeros, not loaded), quantize it in registers without a division or a
//     conversion an element (quant_words) and keep it in shared memory as
//     int8; then for each tap they copy each row's 128 bytes out of the halo
//     into the swizzled stage, fence.proxy.async, and arrive on the stage's
//     full barrier. A 3x3 conv so quantizes each x element about 1.6 times
//     a block instead of 9.
//   - B comes by TMA: a 2-D tensor map over the packed (N, K) matrix, a
//     128 x BN box a stage with the 128-byte swizzle; the hardware zero-
//     fills past N and completes the stage's barrier by bytes.
//   - The consumer: wgmma.mma_async m64nBNk32 s8 x s8 -> s32 from shared
//     memory, as many k32 steps a stage as the block has channels rounded up
//     to 32, one wgmma group in flight; a stage goes back to the producers
//     when the group that read it has finished.
//   - BN follows the layer's N (24, 48, 64, 128, 256: wgmma's int8
//     widths) and the tile the map: ops/int8.py::_conv_int8_plan.
//   - The epilogue dequantizes in registers; bf16 rows go out as 16-byte
//     vectors (a quad of lanes swaps its pairs) where N % 8 == 0, the rest
//     as column pairs.
// - groups > 1 or N < 8: a tiled direct kernel. A block takes a tile of
//   output pixels of one image and a slice of channels, quantizes the tile
//   and its halo of x into shared memory once, then each thread computes
//   PW outputs with __dp4a on 32-bit words of 4 channels:
//   - depthwise (one input channel a group and one output channel):
//     words of 4 channels, PW outputs along W, the 4 channels' taps masked
//     out of one weight word (packed (taps, N)); 8- or 16-byte stores;
//   - any other grouping (the 7x7 and 7x1 gates to one channel, grouped
//     convs): the group's channels padded to a multiple of 4 in shared
//     memory and in the weights (packed (N, taps, Cg4)), a dp4a per word;
//     consecutive threads take consecutive pixels (an odd word stride a
//     pixel in shared memory, so no bank conflicts) and one output channel
//     a warp, so weights are broadcast loads; stores coalesce across the
//     warp.
//   These convs do a handful of products per byte and are bound by bytes.
// There is no fallback: an argument the kernels do not take is an error.
// Left for later: the next layer's BatchNorm and SiLU in the epilogue, a
// persistent warp-specialised schedule.

#include <cuda.h>

#include "sm90_gemm.cuh"

namespace {

constexpr int OUT_F32 = 0;
constexpr int OUT_BF16 = 1;
constexpr int OUT_I32 = 2;
constexpr int X_F32 = 0;
constexpr int X_BF16 = 1;
constexpr int X_I8 = 2;
constexpr int ROUTE_GEMM = 0;
constexpr int ROUTE_DW = 1;
constexpr int ROUTE_DP4 = 2;

constexpr int BK = 128;  // K bytes a stage: one 128-byte swizzle row of A and of B
constexpr int STAGES = 4;
constexpr int DIRECT_THREADS = 256;
constexpr int PW = 4;  // outputs a thread of the direct kernels computes at once

struct Conv {
  const void* x;
  long long sb, sy, sx;  // x's element strides: image, row, pixel (channels contiguous)
  int B, H, W, C, Ho, Wo, N;
  int kh, kw, sh, sw, ph, pw, dh, dw;
  int groups, cin_g, cout_g;
  int M;           // B * Ho * Wo
  int xkind;       // X_F32, X_BF16, X_I8
  int vec;         // 1, or x is read in vectors (every pixel and C aligned to the route's: ops/int8.py::_vec_ok)
  const float* s_a;  // 1 or C activation scales; null for int8 x
  int s_per_channel;
  const int8_t* w;   // packed weights
  // GEMM: a stage holds tps taps of sc bytes (C rounded up to 32, at most
  // 128) of one block of 128 channels; blocks x groups stages of 128 bytes
  // make the packed weights' row K
  int sc, tps, blocks, groups_k, K;
  const float* scale;
  const float* bias;
  void* out;
  int out_kind;
  // output tile th x tw (GEMM: 0 for linear tiles), tiles along W, halo;
  // direct kernels: channel slice (depthwise: channels; else groups),
  // 32-bit words a pixel in shared memory
  int th, tw, cb, tiles_x, halo_h, halo_w, pstr;
};

// ---------------------------------------------------------------------------
// elements, quantize, dequant
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Quantize: clamp(rint(v / s), -127, 127) with v / s the IEEE quotient and
// round half to even, as torch.round(x.float() / s) and jnp.round give it,
// without a division, a float-to-int conversion or a branch per element:
// - y = v * r with r = 1 / s lies within 2 ulp of the quotient;
// - adding and subtracting 1.5 * 2^23 rounds y to an integer, half to even
//   (exact for |y| < 2^22; larger values clamp to +-127 either way);
// - the result is rint(v / s) unless y lies within a few ulp of a tie
//   k + 0.5 (about one value in 10^5): those elements take the division, in
//   a second pass that runs only for a group that has one;
// - the clamped integer q plus 1.5 * 2^23 holds q's two's complement in its
//   low byte.
constexpr float ROUND_MAGIC = 12582912.0f;  // 1.5 * 2^23

__device__ __forceinline__ float round_magic(float y) {
  return __fsub_rn(__fadd_rn(y, ROUND_MAGIC), ROUND_MAGIC);
}

// the low byte of the int8 value of integral q, clamped to +-127
__device__ __forceinline__ uint32_t clamp_byte(float q) {
  return static_cast<uint32_t>(__float_as_int(__fadd_rn(fminf(fmaxf(q, -127.0f), 127.0f), ROUND_MAGIC)));
}

// bytes 0 of four words, packed
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// E elements (a multiple of 4) quantized and packed, 4 a word; s[j], r[j]
// (PC) or s[0], r[0] for every element (s is read only for a tie: it may
// point to device memory)
template <typename T, int E, bool PC>
__device__ __forceinline__ void quant_words(const T* e, const float* s, const float* r, uint32_t* out) {
  if constexpr (sizeof(T) == 1) {
#pragma unroll
    for (int w = 0; w < E / 4; ++w)
      out[w] = (static_cast<uint32_t>(e[4 * w]) & 0xFFu) | ((static_cast<uint32_t>(e[4 * w + 1]) & 0xFFu) << 8) |
               ((static_cast<uint32_t>(e[4 * w + 2]) & 0xFFu) << 16) | (static_cast<uint32_t>(e[4 * w + 3]) << 24);
  } else {
    float q[E];
    uint32_t tie = 0;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float y = __fmul_rn(to_f32(e[j]), r[PC ? j : 0]);
      q[j] = round_magic(y);
      tie |= (__fsub_rn(0.5f, fabsf(__fsub_rn(y, q[j]))) <= fabsf(y) * 1.2e-6f) ? (1u << j) : 0u;
    }
    if (tie != 0) {
#pragma unroll
      for (int j = 0; j < E; ++j)
        if (tie & (1u << j)) q[j] = rintf(__fdiv_rn(to_f32(e[j]), s[PC ? j : 0]));
    }
#pragma unroll
    for (int w = 0; w < E / 4; ++w)
      out[w] = pack_low_bytes(clamp_byte(q[4 * w]), clamp_byte(q[4 * w + 1]), clamp_byte(q[4 * w + 2]),
                              clamp_byte(q[4 * w + 3]));
  }
}

template <int BYTES>
struct VecT;
template <>
struct VecT<1> {
  using T = unsigned char;
};
template <>
struct VecT<2> {
  using T = unsigned short;
};
template <>
struct VecT<4> {
  using T = unsigned int;
};
template <>
struct VecT<8> {
  using T = uint2;
};
template <>
struct VecT<16> {
  using T = uint4;
};

// e[j] = p[j] for j < n (a multiple of VEC), else 0; VEC elements a load
template <typename T, int VEC, int E>
__device__ __forceinline__ void load_elems(T (&e)[E], const T* p, int n) {
  using V = typename VecT<VEC * sizeof(T)>::T;
#pragma unroll
  for (int j = 0; j < E; j += VEC) {
    V v{};
    if (j < n) v = __ldg(reinterpret_cast<const V*>(p + j));
    *reinterpret_cast<V*>(&e[j]) = v;
  }
}

template <int OUT>
__device__ __forceinline__ void store1(void* out, size_t i, int acc, const float* scale, const float* bias, int n) {
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

__device__ __forceinline__ float dequant(int acc, const float* scale, const float* bias, int n) {
  const float v = __fmul_rn(__int2float_rn(acc), scale[n]);
  return bias != nullptr ? __fadd_rn(v, bias[n]) : v;
}

// out[i], out[i + 1] (columns n, n + 1): one 8- or 4-byte store where both
// exist and i is even, else one by one
template <int OUT>
__device__ __forceinline__ void store2(const Conv& c, size_t i, int n, int a0, int a1) {
  if (n + 1 < c.N && (i & 1) == 0) {
    if constexpr (OUT == OUT_I32) {
      *reinterpret_cast<int2*>(static_cast<int*>(c.out) + i) = make_int2(a0, a1);
    } else if constexpr (OUT == OUT_F32) {
      *reinterpret_cast<float2*>(static_cast<float*>(c.out) + i) =
          make_float2(dequant(a0, c.scale, c.bias, n), dequant(a1, c.scale, c.bias, n + 1));
    } else {
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(c.out) + i) =
          __floats2bfloat162_rn(dequant(a0, c.scale, c.bias, n), dequant(a1, c.scale, c.bias, n + 1));
    }
  } else {
    store1<OUT>(c.out, i, a0, c.scale, c.bias, n);
    if (n + 1 < c.N) store1<OUT>(c.out, i + 1, a1, c.scale, c.bias, n + 1);
  }
}

// out[i .. i+3] (channels n .. n+3, nv of them exist): one 16- or 8-byte
// store where all four exist and i is a multiple of 4
template <int OUT>
__device__ __forceinline__ void store4(const Conv& c, size_t i, int n, const int* a, int nv) {
  if (nv == 4 && (i & 3) == 0) {
    if constexpr (OUT == OUT_I32) {
      *reinterpret_cast<int4*>(static_cast<int*>(c.out) + i) = make_int4(a[0], a[1], a[2], a[3]);
    } else if constexpr (OUT == OUT_F32) {
      *reinterpret_cast<float4*>(static_cast<float*>(c.out) + i) =
          make_float4(dequant(a[0], c.scale, c.bias, n), dequant(a[1], c.scale, c.bias, n + 1),
                      dequant(a[2], c.scale, c.bias, n + 2), dequant(a[3], c.scale, c.bias, n + 3));
    } else {
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(c.out) + i) =
          make_uint2(pack_bf16(dequant(a[0], c.scale, c.bias, n), dequant(a[1], c.scale, c.bias, n + 1)),
                     pack_bf16(dequant(a[2], c.scale, c.bias, n + 2), dequant(a[3], c.scale, c.bias, n + 3)));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nv) store1<OUT>(c.out, i + j, a[j], c.scale, c.bias, n + j);
  }
}

// ---------------------------------------------------------------------------
// mbarriers, TMA, int8 wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// box (k0.., n0..) of the tensor map -> dst, completing `bar` by its bytes
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int k0, int n0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(k0), "r"(n0)
      : "memory");
}

// d (the warpgroup's 64 x N int32 fragment) += A (64 x 32) * B (32 x N),
// both int8 and K-major in 128-byte-swizzled shared memory
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<24> {
  static __device__ __forceinline__ void k32(int* d, uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
  }
};

template <>
struct WgmmaS8<48> {
  static __device__ __forceinline__ void k32(int* d, uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
  }
};

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void k32(int* d, uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
  }
};

template <>
struct WgmmaS8<112> {
  static __device__ __forceinline__ void k32(int* d, uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
  }
};

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void k32(int* d, uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
  }
};

template <>
struct WgmmaS8<192> {
  static __device__ __forceinline__ void k32(int* d, uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
  }
};

template <>
struct WgmmaS8<256> {
  static __device__ __forceinline__ void k32(int* d, uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
  }
};

// ---------------------------------------------------------------------------
// groups == 1, N >= 8: implicit GEMM
// ---------------------------------------------------------------------------

// A block: one consumer warpgroup (BM = 64 output pixels: wgmma's M) and
// one producer warpgroup. Two blocks an SM where 128 registers a thread hold
// the accumulators (BN <= 128). (Two consumer warpgroups over 128 rows were
// slower at every flagship shape: the producer's rows a thread double.)
template <int BN_>
struct GemmCfg {
  static constexpr int BM = 64, BN = BN_, THREADS = 256;
  static constexpr int MIN_BLOCKS = BN <= 128 ? 2 : 1;
  static constexpr int A_STAGE = BM * BK, B_STAGE = BN * BK;  // bytes, multiples of 1024
  // the ring, its barriers and room to align to 1024; the halo comes on top
  static constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) + 2 * STAGES * 8 + 1024;
  static_assert(BN % 8 == 0, "tile shape");
};

// The block's 64 rows. Spatial tiles (kh * kw > 1): th x tw output pixels
// of image b from (oy0, ox0), their halo of x halo_h x halo_w pixels;
// linear tiles (1 x 1): 64 consecutive output pixels from m0, the halo
// their 64 input pixels.
struct GemmTile {
  int b, oy0, ox0, m0;
};

__device__ __forceinline__ GemmTile gemm_tile(const Conv& c) {
  GemmTile t{0, 0, 0, 0};
  if (c.th > 0) {
    const int per_image = ((c.Ho + c.th - 1) / c.th) * c.tiles_x;
    t.b = blockIdx.x / per_image;
    const int rest = blockIdx.x - t.b * per_image;
    t.oy0 = rest / c.tiles_x * c.th;
    t.ox0 = (rest % c.tiles_x) * c.tw;
  } else {
    t.m0 = blockIdx.x * 64;
  }
  return t;
}

// output pixel of row r, or -1
__device__ __forceinline__ int row_pixel(const Conv& c, const GemmTile& t, int r) {
  if (c.th > 0) {
    const int oyl = r / c.tw;
    const int oy = t.oy0 + oyl;
    const int ox = t.ox0 + r - oyl * c.tw;
    return r < c.th * c.tw && oy < c.Ho && ox < c.Wo ? (t.b * c.Ho + oy) * c.Wo + ox : -1;
  }
  const int m = t.m0 + r;
  return m < c.M ? m : -1;
}

// halo pixel hp -> x's offset of its channel 0 in elements, or -1 off the map
__device__ __forceinline__ long long halo_offset(const Conv& c, const GemmTile& t, int hp) {
  int b, iy, ix;
  if (c.th > 0) {
    const int hy = hp / c.halo_w;
    b = t.b;
    iy = t.oy0 * c.sh - c.ph + hy;
    ix = t.ox0 * c.sw - c.pw + hp - hy * c.halo_w;
  } else {
    const int m = t.m0 + hp;
    if (m >= c.M) return -1;
    const int hw = c.Ho * c.Wo;
    b = m / hw;
    const int rem = m - b * hw;
    const int oy = rem / c.Wo;
    iy = oy * c.sh - c.ph;
    ix = (rem - oy * c.Wo) * c.sw - c.pw;
  }
  if (static_cast<unsigned>(iy) >= static_cast<unsigned>(c.H) || static_cast<unsigned>(ix) >= static_cast<unsigned>(c.W))
    return -1;
  return b * c.sb + iy * c.sy + ix * c.sx;
}

// The producers quantize 128 channels from c0 of hp_count halo pixels (x's
// offset of each in offs, -1 off the map) into shared memory, 128 bytes a
// pixel (as an A stage: `swizzle`). Only the first `width` bytes of a pixel
// are ever read: item = (pixel, one of its width / 16 chunks of 16
// channels) where that divides 128 threads, else (pixel, one of 8 chunks)
// with the chunks past `width` skipped. A thread's chunk is the same in
// every item, so its per-channel reciprocals are taken once. RB items are
// loaded before they are quantized.
template <typename T, int VEC, int RB>
__device__ __forceinline__ void load_halo_block(const Conv& c, const long long* offs, uint8_t* dst, int hp_count,
                                                int c0, int width, bool swizzle) {
  const int pt = threadIdx.x - 128;
  const int nch = 128 % (width / 16) == 0 ? width / 16 : 8;  // chunks an item row
  const int chunk = pt % nch;
  if (chunk * 16 >= width) return;
  const int ch = c0 + chunk * 16;
  const int nvalid = c.C - ch;  // channels of this thread's chunk that exist
  const T* x = static_cast<const T*>(c.x);
  const bool pc = sizeof(T) != 1 && c.s_per_channel;
  const float* s = pc ? c.s_a + ch : c.s_a;  // read for ties only
  float r[16];
  if (pc) {
#pragma unroll
    for (int j = 0; j < 16; ++j) r[j] = __frcp_rn(j < nvalid ? __ldg(c.s_a + ch + j) : 1.0f);
  } else {
    r[0] = __frcp_rn(sizeof(T) != 1 ? c.s_a[0] : 1.0f);
  }
  const int items = hp_count * nch;
  for (int it0 = pt; it0 < items; it0 += 128 * RB) {
    alignas(16) T e[RB][16];
    bool ok[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int it = it0 + 128 * i;
      const long long off = it < items && nvalid > 0 ? offs[it / nch] : -1;
      ok[i] = off >= 0;
      if (ok[i]) load_elems<T, VEC>(e[i], x + off + ch, nvalid);
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int it = it0 + 128 * i;
      if (it >= items) break;
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (ok[i]) {
        if (pc) {
          quant_words<T, 16, true>(e[i], s, r, reinterpret_cast<uint32_t*>(&q));
        } else {
          quant_words<T, 16, false>(e[i], s, r, reinterpret_cast<uint32_t*>(&q));
        }
      }
      // pixel p, chunk `chunk`; as an A stage, in the swizzled layout
      const int p = it / nch;
      const int at = p * BK + ((swizzle ? chunk ^ (p & 7) : chunk) << 4);
      *reinterpret_cast<uint4*>(dst + at) = q;
    }
  }
}

__device__ __forceinline__ void producers_sync() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

// The producer warpgroup; B by TMA (thread 0) into every stage. Linear
// tiles (1 x 1 convs): a stage a block of 128 channels, quantized straight
// into the swizzled stage. Spatial tiles: for each block of 128 channels,
// the halo once; then a stage a group of tps taps, each row's chunks copied
// out of the halo (zeros for rows past the tile or the map, and past the
// group's taps). T: x's element type; VEC: elements a load.
template <class Cfg, typename T, int VEC>
__device__ __forceinline__ void gemm_producer(const Conv& c, const CUtensorMap* map, uint8_t* As, uint8_t* Bs,
                                              uint8_t* halo, uint64_t* full, uint64_t* empty, int n0) {
  const GemmTile tile = gemm_tile(c);
  const bool linear = c.th == 0;
  const int pt = threadIdx.x - 128;
  const int cc = pt & 7;  // this thread's 16-byte chunk of every row
  const int r0 = pt >> 3;
  int src[4];  // spatial tiles: the halo pixel of each of this thread's rows at tap (0, 0), or -1
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 16 * i;
    const int oyl = linear ? 0 : r / c.tw;
    src[i] = linear || row_pixel(c, tile, r) < 0 ? -1 : oyl * c.sh * c.halo_w + (r - oyl * c.tw) * c.sw;
  }
  const int taps = c.kh * c.kw;
  const int co = (cc * 16) % c.sc;  // this thread's chunk: its channel offset in a tap, its tap in a group
  const int tap_in_group = cc * 16 < c.tps * c.sc ? cc * 16 / c.sc : c.tps;
  // x's offset of every halo pixel, decoded once for all blocks
  const int hp_count = linear ? 64 : c.halo_h * c.halo_w;
  long long* offs = reinterpret_cast<long long*>(halo + (linear ? 0 : hp_count * BK));
  for (int p = pt; p < hp_count; p += 128) offs[p] = halo_offset(c, tile, p);
  producers_sync();
  // stage t's slot free again, and its B on the way
  auto begin_stage = [&](int t) {
    const int slot = t % STAGES;
    mbar_wait(&empty[slot], ((t / STAGES) & 1) ^ 1);
    if (pt == 0) {
      mbar_arrive_expect_tx(&full[slot], Cfg::B_STAGE);
      tma_load_2d(Bs + slot * Cfg::B_STAGE, map, &full[slot], t * BK, n0);
    }
  };
  int t = 0;
  for (int cb = 0; cb < c.blocks; ++cb) {
    int slot = t % STAGES;
    if (linear) {
      begin_stage(t);
    } else {
      producers_sync();  // every copy out of the last block's halo is done
    }
    // items loaded before they are quantized: fewer where two blocks share an SM's registers
    constexpr int RB = sizeof(T) == 4 ? 2 : (Cfg::MIN_BLOCKS == 2 ? 2 : 4);
    load_halo_block<T, VEC, RB>(c, offs, linear ? As + slot * Cfg::A_STAGE : halo, hp_count, cb * BK, c.sc,
                                linear);
    if (!linear) producers_sync();  // the halo is complete
    for (int g = 0; g < c.groups_k; ++g, ++t) {
      slot = t % STAGES;
      if (!linear) {
        begin_stage(t);
        const int tap = g * c.tps + tap_in_group;
        const bool live = tap_in_group < c.tps && tap < taps;
        const int ky = tap / c.kw;
        const int toff = ky * c.dh * c.halo_w + (tap - ky * c.kw) * c.dw;
        uint8_t* as = As + slot * Cfg::A_STAGE;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + 16 * i;
          const uint4 v = live && src[i] >= 0 ? *reinterpret_cast<const uint4*>(halo + (src[i] + toff) * BK + co)
                                              : make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(as + row * BK + ((cc ^ (row & 7)) << 4)) = v;
        }
      }
      fence_proxy_async();  // the stores, visible to wgmma's async proxy
      mbar_arrive(&full[slot]);
    }
  }
}

template <class Cfg, int OUT>
__device__ __forceinline__ void gemm_epilogue(const Conv& c, const GemmTile& tile, int* acc, int n0) {
  const int lane = threadIdx.x % 32;
  const int row = threadIdx.x / 32 * 16 + lane / 4;
  if constexpr (OUT == OUT_BF16 && Cfg::BN % 16 == 0) {
    if (c.N % 8 == 0) {
      // dequantized in place, then each lane writes 8 consecutive channels of one row (16 bytes)
      float* v = reinterpret_cast<float*>(acc);
#pragma unroll
      for (int j = 0; j < Cfg::BN / 8; ++j) {
        const int n = min(n0 + 8 * j + 2 * (lane % 4), c.N - 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[4 * j + 2 * h] = dequant(acc[4 * j + 2 * h], c.scale, c.bias, n);
          v[4 * j + 2 * h + 1] = dequant(acc[4 * j + 2 * h + 1], c.scale, c.bias, n + 1);
        }
      }
      const int m = row_pixel(c, tile, row + 8 * ((lane % 4) & 1));  // the row store_bf16_row gives this lane
      store_bf16_row<Cfg::BN / 8>(reinterpret_cast<const float(*)[4]>(v),
                                  m >= 0 ? static_cast<__nv_bfloat16*>(c.out) + static_cast<size_t>(m) * c.N : nullptr,
                                  n0, c.N);
      return;
    }
  }
  const int m_lo = row_pixel(c, tile, row), m_hi = row_pixel(c, tile, row + 8);
#pragma unroll
  for (int j = 0; j < Cfg::BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane % 4);
    if (n >= c.N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = h ? m_hi : m_lo;
      if (m >= 0) store2<OUT>(c, static_cast<size_t>(m) * c.N + n, n, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <class Cfg>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MIN_BLOCKS)
conv_int8_gemm_kernel(const __grid_constant__ CUtensorMap map, const Conv c) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* As = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* Bs = As + STAGES * Cfg::A_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * Cfg::B_STAGE);
  uint64_t* empty = full + STAGES;
  uint8_t* halo = reinterpret_cast<uint8_t*>(empty + STAGES);
  const int n0 = blockIdx.y * Cfg::BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 128 + 1);  // the producers' arrivals and thread 0's expect_tx
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (c.xkind == X_BF16) {
      if (c.vec > 1) {
        gemm_producer<Cfg, __nv_bfloat16, 8>(c, &map, As, Bs, halo, full, empty, n0);
      } else {
        gemm_producer<Cfg, __nv_bfloat16, 1>(c, &map, As, Bs, halo, full, empty, n0);
      }
    } else if (c.xkind == X_F32) {
      if (c.vec > 1) {
        gemm_producer<Cfg, float, 4>(c, &map, As, Bs, halo, full, empty, n0);
      } else {
        gemm_producer<Cfg, float, 1>(c, &map, As, Bs, halo, full, empty, n0);
      }
    } else {
      if (c.vec > 1) {
        gemm_producer<Cfg, int8_t, 16>(c, &map, As, Bs, halo, full, empty, n0);
      } else {
        gemm_producer<Cfg, int8_t, 1>(c, &map, As, Bs, halo, full, empty, n0);
      }
    }
    return;
  }

  // the consumer warpgroup: as many k32 steps a stage as its taps' channels
  // fill (rounded up to 32)
  int acc[Cfg::BN / 2];
#pragma unroll
  for (int i = 0; i < Cfg::BN / 2; ++i) acc[i] = 0;
  const int taps = c.kh * c.kw;
  int t = 0;
  for (int cb = 0; cb < c.blocks; ++cb) {
    for (int g = 0; g < c.groups_k; ++g, ++t) {
      const int ksteps = c.tps > 1 ? min(c.tps, taps - g * c.tps) * c.sc / 32 : (min(c.sc, c.C - cb * BK) + 31) / 32;
      const int slot = t % STAGES;
      mbar_wait(&full[slot], (t / STAGES) & 1);
      const uint8_t* as = As + slot * Cfg::A_STAGE;
      const uint8_t* bs = Bs + slot * Cfg::B_STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        // 8-row groups 1024 bytes apart; a k32 step is 32 bytes inside the swizzle row
        if (kk < ksteps)
          WgmmaS8<Cfg::BN>::k32(acc, gmma_desc(as + kk * 32, 16, 1024), gmma_desc(bs + kk * 32, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the group of stage t - 1 has finished: its slot goes back to the producers
      if (t > 0) mbar_arrive(&empty[(t - 1) % STAGES]);
    }
  }
  wgmma_wait<0>();
  const GemmTile tile = gemm_tile(c);
  switch (c.out_kind) {
    case OUT_F32: gemm_epilogue<Cfg, OUT_F32>(c, tile, acc, n0); break;
    case OUT_BF16: gemm_epilogue<Cfg, OUT_BF16>(c, tile, acc, n0); break;
    default: gemm_epilogue<Cfg, OUT_I32>(c, tile, acc, n0); break;
  }
}

// ---------------------------------------------------------------------------
// groups > 1 or N < 8: tiled direct kernels
// ---------------------------------------------------------------------------

// 4 channels ch .. ch+3 of one pixel (nv of them exist), quantized into a
// word; whole-vector loads where `vec4` (the 4 are aligned), else one by one
template <typename T>
__device__ __forceinline__ uint32_t load_quant4(const Conv& c, const T* p, int ch, int nv, bool vec4) {
  alignas(16) T e[4] = {};
  if (vec4 && nv == 4) {
    load_elems<T, 4>(e, p, 4);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nv) e[j] = p[j];
  }
  float s[4] = {1.0f, 1.0f, 1.0f, 1.0f}, r[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  if constexpr (sizeof(T) != 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = c.s_per_channel ? (j < nv ? __ldg(c.s_a + ch + j) : 1.0f) : c.s_a[0];
      r[j] = __frcp_rn(s[j]);
    }
  }
  uint32_t word;
  quant_words<T, 4, true>(e, s, r, &word);
  return word;
}

// the block's tile of output pixels and its halo of x
struct Tile {
  int b, oy0, ox0, iy0, ix0;
};

__device__ __forceinline__ Tile block_tile(const Conv& c) {
  Tile t;
  t.b = blockIdx.y;
  t.oy0 = (blockIdx.x / c.tiles_x) * c.th;
  t.ox0 = (blockIdx.x % c.tiles_x) * c.tw;
  t.iy0 = t.oy0 * c.sh - c.ph;
  t.ix0 = t.ox0 * c.sw - c.pw;
  return t;
}

// words [0, words) of every halo pixel: word wi of pixel px holds the 4
// channels chan(wi) .. +3, nv(wi) of them real; off the map zeros
template <typename T, class Chan>
__device__ __forceinline__ void load_halo(const Conv& c, const Tile& t, uint32_t* sx, int words, Chan chan) {
  const T* x = static_cast<const T*>(c.x) + t.b * c.sb;
  const int total = c.halo_h * c.halo_w * words;
  for (int item = threadIdx.x; item < total; item += DIRECT_THREADS) {
    const int px = item / words;
    const int wi = item - px * words;
    const int hy = px / c.halo_w;
    const int iy = t.iy0 + hy;
    const int ix = t.ix0 + px - hy * c.halo_w;
    int ch, nv;
    bool vec4;
    chan(wi, ch, nv, vec4);
    uint32_t word = 0;
    if (nv > 0 && static_cast<unsigned>(iy) < static_cast<unsigned>(c.H) &&
        static_cast<unsigned>(ix) < static_cast<unsigned>(c.W))
      word = load_quant4<T>(c, x + iy * c.sy + ix * c.sx + ch, ch, nv, vec4);
    sx[px * c.pstr + wi] = word;
  }
}

// depthwise (cin_g == cout_g == 1): block = th x tw outputs x cb channels;
// item = (word of 4 channels, run of PW outputs along the tile's rows)
template <typename T, int OUT>
__device__ __forceinline__ void dw_body(const Conv& c, uint32_t* sx) {
  const Tile t = block_tile(c);
  const int c0 = blockIdx.z * c.cb;
  const int nq = c.cb / 4;
  const bool vec4 = c.vec > 1;
  load_halo<T>(c, t, sx, nq, [&](int wi, int& ch, int& nv, bool& v4) {
    ch = c0 + 4 * wi;
    nv = min(4, c.C - ch);
    v4 = vec4;
  });
  __syncthreads();
  const int tile_px = c.th * c.tw;
  const int runs = (tile_px + PW - 1) / PW;
  const int n4 = (c.N + 3) & ~3;  // the packed weights' row: (taps, n4)
  for (int item = threadIdx.x; item < nq * runs; item += DIRECT_THREADS) {
    const int q = item % nq;
    const int run = item / nq;
    const int n = c0 + 4 * q;
    if (n >= c.N) continue;
    int pix[PW], m[PW];
#pragma unroll
    for (int i = 0; i < PW; ++i) {
      const int o = run * PW + i;
      const int oyl = o / c.tw;
      const int oxl = o - oyl * c.tw;
      const bool ok = o < tile_px && t.oy0 + oyl < c.Ho && t.ox0 + oxl < c.Wo;
      pix[i] = ok ? oyl * c.sh * c.halo_w + oxl * c.sw : 0;
      m[i] = ok ? (t.b * c.Ho + t.oy0 + oyl) * c.Wo + t.ox0 + oxl : -1;
    }
    int acc[PW][4];
#pragma unroll
    for (int i = 0; i < PW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int ky = 0; ky < c.kh; ++ky) {
      for (int kx = 0; kx < c.kw; ++kx) {
        const int wq = __ldg(reinterpret_cast<const int*>(c.w + (ky * c.kw + kx) * n4 + n));
        const int toff = ky * c.dh * c.halo_w + kx * c.dw;
#pragma unroll
        for (int i = 0; i < PW; ++i) {
          const int xw = static_cast<int>(sx[(pix[i] + toff) * c.pstr + q]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(xw, wq & static_cast<int>(0xFFu << (8 * j)), acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PW; ++i)
      if (m[i] >= 0) store4<OUT>(c, static_cast<size_t>(m[i]) * c.N + n, n, acc[i], min(4, c.N - n));
  }
}

// any other grouping: block = th x tw outputs x cb groups; each group's
// cin_g channels padded to cg4 (a multiple of 4). item = (output channel,
// run); a run's PW outputs are `runs` pixels apart, so consecutive threads
// take consecutive pixels
template <typename T, int OUT>
__device__ __forceinline__ void dp4_body(const Conv& c, uint32_t* sx) {
  const Tile t = block_tile(c);
  const int cg4 = (c.cin_g + 3) & ~3;
  const int wpg = cg4 / 4;  // words a group a pixel
  const int g0 = blockIdx.z * c.cb;
  const bool vec4 = c.vec > 1 && c.cin_g % 4 == 0;
  load_halo<T>(c, t, sx, c.cb * wpg, [&](int wi, int& ch, int& nv, bool& v4) {
    const int j = wi / wpg;
    const int ci = 4 * (wi - j * wpg);
    ch = (g0 + j) * c.cin_g + ci;
    nv = g0 + j < c.groups ? min(4, c.cin_g - ci) : 0;
    v4 = vec4;
  });
  __syncthreads();
  const int tile_px = c.th * c.tw;
  const int runs = (tile_px + PW - 1) / PW;
  const int nout = min(c.cb, c.groups - g0) * c.cout_g;
  const int taps = c.kh * c.kw;
  const int* w = reinterpret_cast<const int*>(c.w);  // (N, taps, cg4) int8 as words
  for (int item = threadIdx.x; item < nout * runs; item += DIRECT_THREADS) {
    const int nl = item / runs;
    const int run = item - nl * runs;
    const int n = g0 * c.cout_g + nl;
    const int j = nl / c.cout_g;
    int pix[PW], m[PW];
#pragma unroll
    for (int i = 0; i < PW; ++i) {
      const int o = run + i * runs;
      const int oyl = o / c.tw;
      const int oxl = o - oyl * c.tw;
      const bool ok = o < tile_px && t.oy0 + oyl < c.Ho && t.ox0 + oxl < c.Wo;
      pix[i] = ok ? oyl * c.sh * c.halo_w + oxl * c.sw : 0;
      m[i] = ok ? (t.b * c.Ho + t.oy0 + oyl) * c.Wo + t.ox0 + oxl : -1;
    }
    int acc[PW];
#pragma unroll
    for (int i = 0; i < PW; ++i) acc[i] = 0;
    for (int ky = 0; ky < c.kh; ++ky) {
      for (int kx = 0; kx < c.kw; ++kx) {
        const int* wr = w + (static_cast<size_t>(n) * taps + ky * c.kw + kx) * wpg;
        const uint32_t* xr = sx + (ky * c.dh * c.halo_w + kx * c.dw) * c.pstr + j * wpg;
        for (int q = 0; q < wpg; ++q) {
          const int ww = __ldg(wr + q);
#pragma unroll
          for (int i = 0; i < PW; ++i) acc[i] = __dp4a(static_cast<int>(xr[pix[i] * c.pstr + q]), ww, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PW; ++i)
      if (m[i] >= 0) store1<OUT>(c.out, static_cast<size_t>(m[i]) * c.N + n, acc[i], c.scale, c.bias, n);
  }
}

template <int ROUTE, typename T>
__device__ __forceinline__ void direct_out(const Conv& c, uint32_t* sx) {
  switch (c.out_kind) {
    case OUT_F32:
      if constexpr (ROUTE == ROUTE_DW) dw_body<T, OUT_F32>(c, sx); else dp4_body<T, OUT_F32>(c, sx);
      break;
    case OUT_BF16:
      if constexpr (ROUTE == ROUTE_DW) dw_body<T, OUT_BF16>(c, sx); else dp4_body<T, OUT_BF16>(c, sx);
      break;
    default:
      if constexpr (ROUTE == ROUTE_DW) dw_body<T, OUT_I32>(c, sx); else dp4_body<T, OUT_I32>(c, sx);
      break;
  }
}

template <int ROUTE>
__global__ void __launch_bounds__(DIRECT_THREADS) conv_int8_direct_kernel(const Conv c) {
  extern __shared__ uint32_t sx[];
  switch (c.xkind) {
    case X_F32: direct_out<ROUTE, float>(c, sx); break;
    case X_BF16: direct_out<ROUTE, __nv_bfloat16>(c, sx); break;
    default: direct_out<ROUTE, int8_t>(c, sx); break;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int ERR_TENSOR_MAP = 10000;  // + cuTensorMapEncodeTiled's CUresult

template <class Cfg>
int launch_gemm(const Conv& c, int smem, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_TENSOR_MAP;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(c.K), static_cast<cuuint64_t>(c.N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(c.K)};
  const cuuint32_t box[2] = {BK, Cfg::BN};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(c.w), dims, strides, box, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ERR_TENSOR_MAP + static_cast<int>(r);
  const cudaError_t err =
      cudaFuncSetAttribute(conv_int8_gemm_kernel<Cfg>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = c.th > 0 ? c.B * ((c.Ho + c.th - 1) / c.th) * c.tiles_x : (c.M + Cfg::BM - 1) / Cfg::BM;
  const dim3 grid(tiles, (c.N + Cfg::BN - 1) / Cfg::BN);
  conv_int8_gemm_kernel<Cfg><<<grid, Cfg::THREADS, smem, stream>>>(map, c);
  return static_cast<int>(cudaGetLastError());
}

// the tile widths ops/int8.py::_BN_WIDTHS lists, in its order
// (keep the two in step: the card tests compare conv_int8_gemm_smem with it)
#define CONV_INT8_TILES(X) X(0, 24) X(1, 48) X(2, 64) X(3, 128) X(4, 256)

int launch_gemm_cfg(int cfg, const Conv& c, int smem, cudaStream_t st) {
  switch (cfg) {
#define CASE(i, bn) \
  case i: return launch_gemm<GemmCfg<bn>>(c, smem, st);
    CONV_INT8_TILES(CASE)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared memory of GEMM tile configuration `cfg` in bytes, or -1.
extern "C" int conv_int8_gemm_smem(int cfg) {
  switch (cfg) {
#define CASE(i, bn) \
  case i: return GemmCfg<bn>::SMEM;
    CONV_INT8_TILES(CASE)
#undef CASE
    default: return -1;
  }
}

// C interface (ctypes). x: an NHWC view with element strides sb, sy, sx
// and contiguous channels, of kind xkind (0 f32, 1 bf16, 2 int8); vec: 1,
// or every pixel's channels and C are aligned to the route's vectors (16
// bytes for the GEMM, 4 elements for the direct kernels). s_a: 1 or C
// float32 scales (s_per_channel), null for int8 x. w: the weights packed for
// `route` (0 GEMM, 1 depthwise, 2 grouped / narrow). scale, bias (N,)
// float32, bias may be null, scale unused for out_kind 2; out (B, Ho, Wo, N)
// contiguous, float32 (0), bfloat16 (1) or int32 (2). The launch plan of
// ops/int8.py::_conv_int8_plan: GEMM tile configuration `cfg`; output
// tiles th x tw (GEMM: 0, 0 for linear tiles of 64 pixels); direct kernels'
// cb channels (depthwise) or groups a block and pstr words a pixel in shared
// memory; smem bytes. `stream` is a cudaStream_t. Returns
// cudaGetLastError() after the launch, or ERR_TENSOR_MAP + the CUresult
// of cuTensorMapEncodeTiled if the weights' tensor map failed.
extern "C" int conv_int8(const void* x, long long sb, long long sy, long long sx, int xkind, int vec, const void* s_a,
                         int s_per_channel, const void* w, const void* scale, const void* bias, void* out,
                         int out_kind, int B, int H, int W, int C, int Ho, int Wo, int N, int kh, int kw, int sh,
                         int sw, int ph, int pw, int dh, int dw, int groups, int route, int cfg, int th, int tw,
                         int cb, int pstr, int smem, void* stream) {
  Conv c{};
  c.x = x;
  c.sb = sb;
  c.sy = sy;
  c.sx = sx;
  c.B = B;
  c.H = H;
  c.W = W;
  c.C = C;
  c.Ho = Ho;
  c.Wo = Wo;
  c.N = N;
  c.kh = kh;
  c.kw = kw;
  c.sh = sh;
  c.sw = sw;
  c.ph = ph;
  c.pw = pw;
  c.dh = dh;
  c.dw = dw;
  c.groups = groups;
  c.cin_g = C / groups;
  c.cout_g = N / groups;
  c.M = B * Ho * Wo;
  c.xkind = xkind;
  c.vec = vec;
  c.s_a = static_cast<const float*>(s_a);
  c.s_per_channel = s_per_channel;
  c.w = static_cast<const int8_t*>(w);
  c.sc = min(BK, (C + 31) / 32 * 32);
  c.tps = BK % c.sc == 0 ? BK / c.sc : 1;
  c.blocks = (C + BK - 1) / BK;
  c.groups_k = (kh * kw + c.tps - 1) / c.tps;
  c.K = c.blocks * c.groups_k * BK;
  c.scale = static_cast<const float*>(scale);
  c.bias = static_cast<const float*>(bias);
  c.out = out;
  c.out_kind = out_kind;
  c.th = th;
  c.tw = tw;
  c.cb = cb;
  c.pstr = pstr;
  if (c.M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  if (xkind < 0 || xkind > 2 || out_kind < 0 || out_kind > 2 || (xkind != X_I8 && s_a == nullptr) || th < 0 ||
      tw < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (th > 0) {
    c.tiles_x = (Wo + tw - 1) / tw;
    c.halo_h = (th - 1) * sh + (kh - 1) * dh + 1;
    c.halo_w = (tw - 1) * sw + (kw - 1) * dw + 1;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_GEMM) {
    // the halo (spatial tiles) and x's offset of each of its pixels
    const int halo = th > 0 ? c.halo_h * c.halo_w * (BK + 8) : 64 * 8;
    if (groups != 1 || (th > 0) != (kh * kw > 1) || (th > 0 && th * tw > 64) || smem != conv_int8_gemm_smem(cfg) + halo)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_gemm_cfg(cfg, c, smem, st);
  }
  if (th < 1 || tw < 1 || cb < 1 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((Ho + th - 1) / th) * c.tiles_x;
  if (route == ROUTE_DW) {
    const dim3 grid(tiles, B, (C + cb - 1) / cb);
    conv_int8_direct_kernel<ROUTE_DW><<<grid, DIRECT_THREADS, smem, st>>>(c);
  } else if (route == ROUTE_DP4) {
    const dim3 grid(tiles, B, (groups + cb - 1) / cb);
    conv_int8_direct_kernel<ROUTE_DP4><<<grid, DIRECT_THREADS, smem, st>>>(c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
