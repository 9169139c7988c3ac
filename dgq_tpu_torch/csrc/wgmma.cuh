// Tensor-core tile code shared by the flash attention kernel (attention.cu),
// the group-quantized conv (group_conv.cu) and the f32 linear (linear_gemm.cu):
// Hopper's warpgroup matrix multiply (`wgmma`, sm_90a) on bf16 operands that
// lie in shared memory as swizzled sub-tiles, the asynchronous copies that
// fill them, and the fences between the two.
//
// Operand sub-tile. Every shared-memory operand is cut into sub-tiles of R rows
// by 64 bf16 (128 bytes a row, R a multiple of 8), each starting on a 1024-byte
// boundary, under the 128-byte swizzle: the 16-byte chunk c (0..7) of row r
// sits at chunk c ^ (r & 7) of that row (`swz`). It is the layout the hardware
// calls B128, so one descriptor form serves both operand orientations:
//   * K-major (the contraction runs along a row: Q, K, the conv's codes): the
//     16 contraction elements of MMA step ks are bytes 32 ks.. of every row, so
//     the descriptor's start address is the sub-tile's plus 32 ks;
//   * MN-major (the contraction runs down the rows, the row holds 64 output
//     columns: V, the conv's weights; `tnspB = 1`): step ks takes rows
//     16 ks.., start address plus 2048 ks.
// In both, 8 rows are 1024 bytes apart (the stride byte offset); the leading
// byte offset is not read, because no operand here is wider than one 64-element
// swizzle atom. An instruction multiplies a 64 x 16 A tile (four warps, 16 rows
// each) with a 16 x N B tile into a 64 x N f32 accumulator in registers.
//
// Accumulator fragment (m64nN): warp w of the warpgroup, lane l, g = l / 4,
// t = l % 4 hold, for every 8-column block j, d[4j] and d[4j+1] = row 16w + g,
// columns 8j + 2t and + 1; d[4j+2], d[4j+3] = row 16w + g + 8, same columns. An
// A operand in registers (`mma_rs_n64`) has the layout of two neighbouring
// accumulator blocks rounded to bf16 and packed in pairs, which is how the
// attention kernel feeds P to P V without a trip through shared memory.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row `row` inside a swizzled sub-tile
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// shared-memory matrix descriptor: start address, leading byte offset 16
// (unread), stride byte offset 1024, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// 16 bytes from device memory into shared memory without passing through
// registers; `valid` false writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// `wgmma` reads shared memory through the asynchronous proxy: writes made by
// ordinary stores or `cp.async` are ordered before it by this fence, executed by
// the writing thread ahead of the block's barrier.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins registers that an in-flight wgmma reads or writes: placed after
// `mma_wait`, it keeps the compiler from reading an accumulator early or from
// reusing an A-operand register before the multiply has finished.
template <int N> __device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N> __device__ __forceinline__ void pin(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define TC_ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define TC_ACC16(d, i) TC_ACC4(d, i), TC_ACC4(d, i + 4), TC_ACC4(d, i + 8), TC_ACC4(d, i + 12)

// d (64 x 64) = A (64 x 16, shared) B (16 x 64, shared) + (accumulate ? d : 0).
// A is K-major; B is K-major (TNSP_B = 0) or MN-major (TNSP_B = 1).
template <int TNSP_B>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : TC_ACC16(d, 0), TC_ACC16(d, 16)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TNSP_B));
}

// d (64 x 32) = A (64 x 16, shared, K-major) B (16 x 32, shared, K-major) + ...
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : TC_ACC16(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, registers) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TC_ACC16(d, 0), TC_ACC16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- TF32: f32 operands on the tensor cores, three products a product ----
//
// `wgmma` on .tf32 operands reads 32-bit words and ignores their low 13 bits,
// and it takes both operands K-major only (the transpose bits exist for 16-bit
// types alone). One TF32 product keeps 11 significant bits, so an f32 product
// a b is formed as a_big b_small + a_small b_big + a_big b_big in one f32
// accumulator, the two small terms first, with x_big = rna(x) and x_small =
// rna(x - x_big) written as TF32 words (`split_tf32`): what is left out,
// a_small b_small and the rounding of the small parts, is below 2^-21 |a b|.
// A k8 step takes 8 contraction elements, 32 bytes of a 128-byte swizzled row
// (one row holds 32 f32, four steps), so the descriptors are the bf16 ones:
// start address plus 32 ks inside a sub-tile. The A fragment in registers
// (m64nNk8, per warp 16 rows; lane l, g = l / 4, t = l % 4): a[0] = (row g,
// k t), a[1] = (g + 8, t), a[2] = (g, t + 4), a[3] = (g + 8, t + 4).

// x rounded to TF32 (round to nearest, ties away from zero) as an f32 bit
// pattern whose low 13 bits are zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(__fsub_rn(x, __uint_as_float(big)));
}

#define TC_COMMA ,
#define TC_ACC8(d, i) TC_ACC4(d, i), TC_ACC4(d, i + 4)
#define TC_ACC32(d, i) TC_ACC16(d, i), TC_ACC16(d, i + 16)
#define TC_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define TC_REGS20 TC_REGS16 ", %16, %17, %18, %19"
#define TC_REGS32 TC_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define TC_REGS40 TC_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define TC_REGS64                                                                          \
  TC_REGS40 ", %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
            "%55, %56, %57, %58, %59, %60, %61, %62, %63"

// Tf32<N>::ss: d (64 x N) = A (64 x 8, shared) B (8 x N, shared) + (accumulate ? d : 0);
// Tf32<N>::rs: the same with A (64 x 8) in registers; both operands K-major.
// The tensor cores add into the accumulator rounding toward zero, so a long
// chain of adds into one accumulator drifts toward zero by up to an ulp an
// add: the kernels start a fresh accumulator for a short chain (a 32-lane
// chunk of Q K^T, a key tile of P V) and add the chains in f32 registers.
template <int N> struct Tf32;
#define TC_TF32(N, R, REGS, ACCS, IA, IB, IP, IR0, IR1, IR2, IR3, IRB, IRP)                       \
  template <> struct Tf32<N> {                                                                    \
    static __device__ __forceinline__ void ss(float (&d)[R], uint64_t a, uint64_t b,              \
                                              int accumulate) {                                   \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IP ", 0;\n"                              \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " REGS "}, %" #IA    \
                   ", %" #IB ", p, 1, 1;\n}\n"                                                    \
                   : ACCS                                                                         \
                   : "l"(a), "l"(b), "r"(accumulate));                                            \
    }                                                                                             \
    static __device__ __forceinline__ void rs(float (&d)[R], const uint32_t (&a)[4], uint64_t b,  \
                                              int accumulate) {                                   \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IRP ", 0;\n"                             \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " REGS "}, {%" #IR0   \
                   ", %" #IR1 ", %" #IR2 ", %" #IR3 "}, %" #IRB ", p, 1, 1;\n}\n"                   \
                   : ACCS                                                                         \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));        \
    }                                                                                             \
  };
TC_TF32(32, 16, TC_REGS16, TC_ACC16(d, 0), 16, 17, 18, 16, 17, 18, 19, 20, 21)
TC_TF32(40, 20, TC_REGS20, TC_ACC16(d, 0) TC_COMMA TC_ACC4(d, 16), 20, 21, 22, 20, 21, 22, 23, 24, 25)
TC_TF32(64, 32, TC_REGS32, TC_ACC32(d, 0), 32, 33, 34, 32, 33, 34, 35, 36, 37)
TC_TF32(80, 40, TC_REGS40, TC_ACC32(d, 0) TC_COMMA TC_ACC8(d, 32), 40, 41, 42, 40, 41, 42, 43, 44, 45)
TC_TF32(128, 64, TC_REGS64, TC_ACC32(d, 0) TC_COMMA TC_ACC32(d, 32), 64, 65, 66, 64, 65, 66, 67, 68,
        69)
#undef TC_TF32
#undef TC_REGS16
#undef TC_REGS20
#undef TC_REGS32
#undef TC_REGS40
#undef TC_REGS64
#undef TC_ACC8
#undef TC_COMMA
#undef TC_ACC32

#undef TC_ACC4
#undef TC_ACC16

// two f32 rounded to nearest-even bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace tc
