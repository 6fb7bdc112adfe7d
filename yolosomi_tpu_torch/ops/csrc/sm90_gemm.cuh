// Hopper building blocks shared by the bf16 implicit GEMMs of
// odconv_s2.cu (the forward) and odconv_s2_bwd.cu (its gradients): cp.async
// with zero-fill, the 128-byte-swizzled shared-memory layout and its wgmma
// descriptors, wgmma.mma_async m64nNk16 (bf16 in, f32 accumulators), and
// the epilogue stores of a warp's strip of accumulators. Needs sm_90a.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !ok (src-size 0: nothing
// is read, so `src` only has to be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a[i] for a runtime i < 4, by selects (no local-memory array)
__device__ __forceinline__ uint32_t pick4(const uint32_t* a, int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// 128-byte swizzle (the wgmma operand layout): 16-byte chunk c of the
// 128-byte row r of a 1024-byte-aligned panel sits at chunk c ^ (r % 8).
// Element offset in a panel of rows of 64 bf16.
__device__ __forceinline__ int swizzled(int r, int c) { return r * 64 + ((c ^ (r & 7)) << 3); }

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, 128-byte swizzle. K-major operand (rows of 64 k, one
// swizzle row each): lbo unused, sbo = 1024 (the next 8 rows). MN-major
// operand (panels of 64 m or n by the K rows): lbo = the next panel along
// m or n, sbo = 1024 (the next 8 k).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return ((smem_addr(p) & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// d (the warpgroup's 64xN f32 fragment) += A (64x16) * B (16xN), both read
// from swizzled shared memory through descriptors. TA = 0: A is K-major, 1:
// M-major; TB = 0: B is K-major, 1: N-major (wgmma's imm-trans-a/b).
template <int N, int TA, int TB>
struct Wgmma;

template <int TA, int TB>
struct Wgmma<64, TA, TB> {
  static __device__ __forceinline__ void k16(float* d, uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TA), "n"(TB)
      : "memory");
  }
};

template <int TA, int TB>
struct Wgmma<128, TA, TB> {
  static __device__ __forceinline__ void k16(float* d, uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TA), "n"(TB)
      : "memory");
  }
};

template <int TA, int TB>
struct Wgmma<256, TA, TB> {
  static __device__ __forceinline__ void k16(float* d, uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TA), "n"(TB)
      : "memory");
  }
};

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async's shared-memory writes, made visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// A warp's 16-row strip of wgmma accumulators, NJ fragments of 8 columns
// (lane 4g + q holds rows g and g+8, columns 8j + 2q and 8j + 2q + 1 of
// acc[j]), rounded to bf16. The lanes of each quad swap their pairs so
// that lane q holds all 8 columns of row g + 8*(q&1), fragment j + (q>>1),
// and writes them as one 16-byte vector. `row` is that row's column 0 in
// memory (nullptr: the row is out of range); columns col0 + 8j .. +7 are
// written where col0 + 8j < ncols (ncols % 8 == 0). Every lane of the warp
// must call it (the shuffles are warp-wide).
template <int NJ>
__device__ __forceinline__ void store_bf16_row(const float (*acc)[4], __nv_bfloat16* row, int col0, int ncols) {
  const int lane = threadIdx.x % 32;
  const int q = lane % 4;
#pragma unroll
  for (int j = 0; j < NJ; j += 2) {
    // this lane's four bf16 pairs: (row g | g+8) x (fragment j | j+1)
    const uint32_t v[4] = {pack_bf16(acc[j][0], acc[j][1]), pack_bf16(acc[j][2], acc[j][3]),
                           pack_bf16(acc[j + 1][0], acc[j + 1][1]), pack_bf16(acc[j + 1][2], acc[j + 1][3])};
    // quad transpose: lane q gathers pair q of every lane of its quad
    uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int src = (q + r) & 3;
      const uint32_t got = __shfl_sync(0xffffffffu, pick4(v, (q - r) & 3), (lane & ~3) | src);
#pragma unroll
      for (int t = 0; t < 4; ++t) o[t] = src == t ? got : o[t];
    }
    const int n = col0 + (j + (q >> 1)) * 8;
    if (row != nullptr && n < ncols) *reinterpret_cast<uint4*>(row + n) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// The same strip in f32 to a row-major matrix `out` of `nrows` rows of `ld`
// floats: rows row0 + g and row0 + g + 8, two columns a lane.
template <int NJ>
__device__ __forceinline__ void store_f32_strip(const float (*acc)[4], float* out, size_t ld, int row0, int nrows,
                                                int col0, int ncols) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int q = lane % 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int n = col0 + j * 8 + 2 * q;
    if (n >= ncols) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + g + 8 * h;
      if (m < nrows) *reinterpret_cast<float2*>(out + m * ld + n) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

// out[i .. i+7] = sum over the `split` parts of ws[part * total + i ..], in
// part order, rounded to bf16 (one 16-byte store), for i = 8 * thread.
// Split-K's second pass: no atomics, the same bits every run.
__device__ __forceinline__ void splitk_sum8(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out, int split,
                                            size_t total) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 8;
  if (i >= total) return;
  float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int sp = 0; sp < split; ++sp) {
    const float4* p = reinterpret_cast<const float4*>(ws + sp * total + i);
    const float4 lo = __ldg(p), hi = __ldg(p + 1);
    acc[0] += lo.x;
    acc[1] += lo.y;
    acc[2] += lo.z;
    acc[3] += lo.w;
    acc[4] += hi.x;
    acc[5] += hi.y;
    acc[6] += hi.z;
    acc[7] += hi.w;
  }
  *reinterpret_cast<uint4*>(out + i) = make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                                                  pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7]));
}

}  // namespace
