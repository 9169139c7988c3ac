// Fused quantize -> int8 matmul -> dequantize for Hopper (sm_90a): K6.
//
// Replaces the Pallas TPU kernel `_kernel` of dgq_tpu/ops/pallas/int8_matmul.py
// (`quantized_matmul`): the deploy path of every linear and 1x1 conv whose
// activation has one scale per tensor. In one launch it
//   1. quantizes the f32/bf16 activation tile to recentered int8 codes,
//      xq = clip(round_half_even(x / dx) + zx, nb, pb)
//      (zx and the bounds recentered by 2^(a_bits-1): A8 [-128, 127], A6 [-32, 31]),
//   2. multiplies the codes against the packed int8 weight codes on the tensor
//      cores, s8 x s8 -> s32, and sums each row's codes alongside (xsum),
//   3. removes the affine cross terms and dequantizes in f32,
//      y[m, o] = dx*dw[o] * (acc - zx*wsum[o] - zw[o]*xsum[m] + K*zx*zw[o]) + bias[o],
//      written in the activation's dtype.
// dx and zx are read from device memory (they are time-aware tensors), wsum is
// the per-out-channel sum of the weight codes, made once at pack time.
//
// What bounds it on the H100: bytes at most of the main path's shapes (the
// (M, N) output dominates the wide ones: 84 of the 95 MB moved at M = 16384,
// K = 320, N = 2560, against 26.8 GOP; the weight panel the small-M ones:
// 3.6 MB for the 2 rows of SDXL's add_embedding), operations only where K is
// long and M and N wide. The TPU kernel keeps a full-K (BM, K) tile in VMEM
// and its wrapper pads M and N; here a block owns a 128 x 256 output tile,
// walks K in steps of 128 and masks the ragged M, N and K edges itself, so no
// padded copy is made.
//
// The design (tile code in wgmma.cuh):
//   * Multiply: `wgmma.mma_async.m64n256k32.s32.s8.s8`, two warpgroups of 64
//     rows each. A, the activation codes, comes from registers: `cp.async`
//     brings the f32/bf16 x tile into shared memory (rows padded so that a
//     warp's fragment reads hit every bank once), each thread reads the 16
//     values of its A fragment (rows g and g + 8 of its warp, k in groups of
//     4 at 4 t and 16 + 4 t), quantizes them and packs four codes a register,
//     so a code is built once per block and serves 256 columns. xsum is a
//     dp4a of the packed codes per k step, summed over the four lanes of a
//     row at the end.
//   * B, the (N, K) weight codes, is K-major as it lies (what `wgmma` asks of
//     an 8-bit operand): 256 rows of 128 codes a stage, in the 128-byte
//     swizzled sub-tile of wgmma.cuh, so a 32-code k step advances the
//     descriptor by 32 bytes, the bf16 k16 step's byte count. The stages form
//     a ring of three (bf16 x) or two (f32 x: its tile is twice as wide and
//     three would not fit in 227 KB), filled a stage or two ahead.
//   * Output: the s32 tile is staged through shared memory and each thread
//     finishes 16 contiguous bytes of a row (8 bf16 or 4 f32 outputs), so the
//     epilogue's loads of the column vectors and its stores are coalesced.
//   * Split K: where the output tiles are fewer than the SMs, the wrapper's
//     plan (`ops/int8_matmul.py:int8_plan`) cuts K into runs over blockIdx.z.
//     Every split writes its s32 partial tile and row sums to a workspace and
//     takes a ticket from the tile's counter; the block that takes the last
//     ticket adds the other splits' partials to its own, in s32 (exact, so
//     the order the blocks ran in changes no bit; f32 partials would round
//     once |acc| passes 2^24, which K 5120 x 128 x 128 does), resets the
//     counter to 0 for the next call and runs the epilogue. No launch is added.
//
// The quantizer is short: a multiply by 1 / dx, a clamp, and the rounding add
// of 1.5 * 2^23, which leaves the integer in the low mantissa bits. The product
// with the rounded reciprocal can differ from the true quotient by an ulp,
// which changes the code only next to a rounding tie (a half-integer). Near a
// tie a fused multiply-add's residual shows whether the product is the
// rounded quotient itself; a run of 8 values with one it cannot vouch for, and
// any dx or zx the short form cannot take, goes through the true division. So
// the codes are those of `clip(round(x / dx) + zx, nb, pb)` bit for bit. Positions past K get code 0,
// so they add nothing to acc or xsum.
//
// The integer part is exact and the f32 epilogue is written with explicit
// round-to-nearest operations in the order of the plain PyTorch version (no
// fused multiply-add), so the two agree to the last bit.
#include "common.cuh"
#include "wgmma.cuh"
#include <cstdint>

namespace {

constexpr int kThreads = 256;   // two warpgroups
constexpr int BM = 128;         // output rows per block, 64 a warpgroup
constexpr int BN = 256;         // output columns per block
constexpr int BK = 128;         // codes of K per stage: one swizzled 128-byte row of B
constexpr int kStageB = BN * BK;             // weight codes of a stage, bytes
constexpr int kAccPitch = BN + 8;            // ints a row of the staged s32 tile
constexpr int kWsInts = BM * BN + BM;        // a split's partial tile and row sums
constexpr float kMagic = 12582912.f;   // 1.5 * 2^23: x + kMagic rounds x half-to-even
constexpr int kMagicBits = 0x4B400000;  // and holds the integer in its low mantissa bits

// The x tile of a stage: BM rows of BK values, each row padded by 16 values
// (64 bytes f32, 32 bytes bf16), so the eight rows a warp reads at once start
// on distinct banks.
template <typename T> struct XTile {
  static constexpr int kElems16 = 16 / sizeof(T);         // values a 16-byte chunk
  static constexpr int kPitch = (BK + 16) * sizeof(T);    // bytes a row
  static constexpr int kStage = kStageB + BM * kPitch;    // bytes a stage, B then x
  static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
  static constexpr int kSmem = 1024 + kStages * kStage;   // with the 1024-byte alignment
  static_assert(kStage % 1024 == 0, "every stage's B starts on a 1024-byte boundary");
  static_assert(kSmem <= 232448 - 1024, "the ring fits in a block's shared memory");
  static_assert(BM * kAccPitch * 4 <= kStages * kStage, "the s32 tile fits in the ring");
};

// The in-kernel activation quantizer: recentered integer codes of 8 values,
// clip(round_half_even(x / dx) + zx, nb, pb), packed as two words of 4 bytes.
struct Quantizer {
  float dx, zx, nb, pb, inv, lo, hi, margin0, half_dx;
  int bias;

  __device__ Quantizer(float dx_, float zx_, float nb_, float pb_)
      : dx(dx_), zx(zx_), nb(nb_), pb(pb_) {
    inv = __frcp_rn(dx);
    lo = nb - zx;  // clip(round(t) + zx, nb, pb) == round(clip(t, lo, hi)) + zx for integer zx
    hi = pb - zx;
    bias = static_cast<int>(zx) - kMagicBits;
    // |dx| within [2^-100, 2^100]: the residual test below scales it by powers
    // of two without leaving the normal range
    const bool fast = isfinite(inv) && fabsf(dx) >= 0x1p-100f && fabsf(dx) <= 0x1p100f &&
                      zx == rintf(zx) && fabsf(zx) <= 512.f;
    margin0 = fast ? 1.f : -1.f;
    half_dx = 0.5f * fabsf(dx);
  }

  __device__ __forceinline__ int by_division(float x) const {
    return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, dx)) + zx, nb), pb));
  }

  // The short form: r = clip(x * inv) and its rounding, with how far r lies
  // from a tie. x * inv is within 2^-22 |r| of the rounded quotient, so where
  // `near` > 0 round(r) is the code; at or below 0 only the rounded quotient
  // itself says which way it rounds.
  __device__ __forceinline__ int by_reciprocal(float x, float& r, float& near) const {
    r = fminf(fmaxf(__fmul_rn(x, inv), lo), hi);
    const float v = __fadd_rn(r, kMagic);
    const float frac = __fsub_rn(r, __fsub_rn(v, kMagic));  // r - round(r), exact
    near = fmaf(fabsf(r), -0x1p-21f, 0.5f - fabsf(frac));
    return __float_as_int(v) + bias;
  }
  // Near a tie, r may still be the rounded quotient itself (x / dx falls on a
  // half-integer for many bf16 x when dx is a round number such as 0.05): r is
  // the float nearest to x / dx when |x - r dx| < |dx| u / 2, u the spacing of
  // the floats just below |r| (no wider than the one above). The residual
  // comes from one fused multiply-add; the comparison holds for the exact
  // residual whenever it holds for the rounded one, so a true answer is sure.
  // Then round(r) is the code; otherwise the division decides.
  __device__ __forceinline__ bool quotient_is(float x, float r, float near) const {
    const float ar = fabsf(r);  // >= 0.5 where near <= 0: a normal number
    const float u = ar - __int_as_float(__float_as_int(ar) - 1);
    return near > 0.f || fabsf(fmaf(-r, dx, x)) < u * half_dx;
  }

  // codes of v[0..7], of which v[0..3] lie at k.. and v[4..7] at k + 16..: the
  // first n_lo of the one group and n_hi of the other lie inside K, the rest
  // get code 0
  __device__ __forceinline__ uint2 operator()(const float (&v)[8], int n_lo, int n_hi) const {
    int c[8];
    float r[8], near[8], margin = margin0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c[i] = by_reciprocal(v[i], r[i], near[i]);
      margin = fminf(margin, near[i]);
    }
    if (margin <= 0.f) {  // a value near a tie, or a dx or zx the short form cannot take
      bool sure = margin0 > 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) sure = sure && quotient_is(v[i], r[i], near[i]);
      if (!sure) {
#pragma unroll
        for (int i = 0; i < 8; ++i) c[i] = by_division(v[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i] = (i < 4 ? i < n_lo : i - 4 < n_hi) ? c[i] : 0;
    // the low byte of each code, four to a word
    return make_uint2(
        __byte_perm(__byte_perm(c[0], c[1], 0x0040), __byte_perm(c[2], c[3], 0x0040), 0x5410),
        __byte_perm(__byte_perm(c[4], c[5], 0x0040), __byte_perm(c[6], c[7], 0x0040), 0x5410));
  }
};

// 4 consecutive values of a row of the x tile (generic pointer into shared
// memory) -> v[off..off + 3] as f32
__device__ __forceinline__ void read4(const uint8_t* p, float (&v)[8], int off) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[off] = a.x; v[off + 1] = a.y; v[off + 2] = a.z; v[off + 3] = a.w;
}
__device__ __forceinline__ void read4_bf16(const uint8_t* p, float (&v)[8], int off) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);  // a bf16 is the high half of its f32
  v[off] = __uint_as_float(w.x << 16);
  v[off + 1] = __uint_as_float(w.x & 0xffff0000u);
  v[off + 2] = __uint_as_float(w.y << 16);
  v[off + 3] = __uint_as_float(w.y & 0xffff0000u);
}

// The `nvalid` leading elements of a 16-byte chunk, zeros behind them
__device__ __forceinline__ uint4 load_chunk(const int8_t* p, int nvalid) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < nvalid) w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[i])) << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 load_chunk(const float* p, int nvalid) {
  float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < nvalid) v[i] = p[i];
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 load_chunk(const __nv_bfloat16* p, int nvalid) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < nvalid) w[i >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(p[i])) << (16 * (i & 1));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 bytes into shared memory: by cp.async (ASYNC, whole chunks only: nvalid is
// 0 or all of it, and 0 writes zeros without reading), else by an ordinary load
// of the valid elements and a store
template <bool ASYNC, typename E>
__device__ __forceinline__ void fill(uint32_t dst, const E* src, const E* safe, int nvalid,
                                     int full) {
  if constexpr (ASYNC) tc::cp_async16(dst, nvalid > 0 ? src : safe, nvalid == full);
  else tc::st_shared16(dst, load_chunk(src, nvalid));
}

#define K6_R8(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
    "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define K6_R32(d, i) K6_R8(d, i), K6_R8(d, i + 8), K6_R8(d, i + 16), K6_R8(d, i + 24)

// d (64 x 256, s32) += A (64 x 32 s8, registers) B (32 x 256 s8, shared, K-major).
// A fragment: warp w, lane (g, t): a[0] row 16 w + g, k 4 t..4 t + 3 (low byte
// first); a[1] row + 8, same k; a[2], a[3] the same rows at k 16 + 4 t. The
// accumulator has the f32 layout of wgmma.cuh.
__device__ __forceinline__ void mma_s8_n256(int (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p;\n}\n"
      : K6_R32(d, 0), K6_R32(d, 32), K6_R32(d, 64), K6_R32(d, 96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef K6_R8
#undef K6_R32

template <int N> __device__ __forceinline__ void pin(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The per-column vectors of the epilogue. The bias is read in the dtype the
// model holds it in (f32 or bf16, widened exactly here), so a call converts
// nothing before its launch; a null bias adds nothing.
struct Columns {
  const float* wsum;
  const float* dw;
  const float* zw;
  const void* bias;
  int bias_bf16;

  __device__ __forceinline__ float bias_at(int c) const {
    return bias_bf16 ? __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(bias) + c))
                     : __ldg(static_cast<const float*>(bias) + c);
  }
};

// The per-column terms of the epilogue, in the plain version's order: zx
// wsum[o], zw[o], K zx zw[o], dx dw[o] and the bias (0 with none: no add).
struct ColumnTerms {
  float zx_ws, zw, kzz, sc, b;

  __device__ __forceinline__ ColumnTerms(const Columns& col, int c, float dx, float zx,
                                         float kzx) {
    zw = __ldg(col.zw + c);
    zx_ws = __fmul_rn(zx, __ldg(col.wsum + c));
    kzz = __fmul_rn(kzx, zw);
    sc = __fmul_rn(dx, __ldg(col.dw + c));
    b = col.bias != nullptr ? col.bias_at(c) : 0.f;
  }
  __device__ __forceinline__ ColumnTerms() : zx_ws(0.f), zw(0.f), kzz(0.f), sc(0.f), b(0.f) {}

  // one output, no contraction: dx dw (acc - zx wsum - zw xsum + K zx zw) + b
  __device__ __forceinline__ float finish(int acc, float xsr, bool has_bias) const {
    float v = __fsub_rn(static_cast<float>(acc), zx_ws);
    v = __fsub_rn(v, __fmul_rn(zw, xsr));
    v = __fadd_rn(v, kzz);
    const float y = __fmul_rn(sc, v);
    return has_bias ? __fadd_rn(y, b) : y;
  }
};

// ASYNC: the x and weight tiles arrive by cp.async (every row of both starts on
// a 16-byte boundary), else by element loads into the same tiles (same bits).
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(kThreads, 1)
int8_wgmma_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                  const float* __restrict__ dxp, const float* __restrict__ zxp, Columns cols,
                  T* __restrict__ out, int8_t* __restrict__ dbg_codes,
                  float* __restrict__ dbg_xsum, int* __restrict__ ws, int* __restrict__ counters,
                  int m, int n, int k, float nb, float pb, int steps_per_split, int vec_o) {
  using XT = XTile<T>;
  constexpr int NS = XT::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int xs_s[BM];
  __shared__ int last_s;
  const uint32_t align = (1024u - (tc::smem_u32(smem_raw) & 1023u)) & 1023u;
  uint8_t* ring_p = smem_raw + align;  // NS stages of [B 256 x 128 codes][x BM x BK values]
  const uint32_t ring = tc::smem_u32(ring_p);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_steps = (k + BK - 1) / BK;
  const int s_begin = blockIdx.z * steps_per_split;
  const int n_steps = min(k_steps, s_begin + steps_per_split) - s_begin;
  const float dx = *dxp, zx = *zxp;
  const Quantizer quantize(dx, zx, nb, pb);
  const int ra = wg * 64 + warp * 16 + g;  // this thread's fragment rows: ra, ra + 8
  const bool wg_live = m0 + wg * 64 < m;   // the warpgroup holds a row inside M

  // Stage loads. B: thread t copies chunk t % 8 (16 codes) of rows t / 8 + 32 i;
  // x: chunk c of row r for the ids t + 256 i = r * CPR + c.
  constexpr int CPR = BK / XT::kElems16;
  auto load = [&](int step, int stage) {
    const uint32_t sb = ring + stage * XT::kStage;
    const int k0 = step * BK, cc = tid & 7;
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      const int row = (tid >> 3) + 32 * i, gn = n0 + row, gk = k0 + cc * 16;
      fill<ASYNC>(sb + tc::swz(row, cc), wq + (size_t)gn * k + gk, wq,
                  gn < n ? min(16, max(0, k - gk)) : 0, 16);
    }
#pragma unroll
    for (int i = 0; i < BM * CPR / kThreads; ++i) {
      const int id = tid + kThreads * i, row = id / CPR, c = id % CPR;
      const int gm = m0 + row, gk = k0 + c * XT::kElems16;
      fill<ASYNC>(sb + kStageB + row * XT::kPitch + c * 16, x + (size_t)gm * k + gk, x,
                  gm < m ? min(XT::kElems16, max(0, k - gk)) : 0, XT::kElems16);
    }
  };

  // The A fragment of k step ks of a stage: 16 values read, quantized, packed;
  // their codes join the rows' sums. Lane t holds k from kg = step BK + 32 ks +
  // 4 t: the first n_lo of kg.. and n_hi of kg + 16.. lie inside K.
  int xpart[2] = {0, 0};
  auto k_at = [&](int step, int ks) { return step * BK + 32 * ks + 4 * t4; };
  auto fragment = [&](int stage, int step, int ks, uint32_t (&a)[4]) {
    const uint8_t* sx = ring_p + stage * XT::kStage + kStageB;
    const int kl = 32 * ks + 4 * t4, kg = k_at(step, ks);
    const int n_lo = min(4, max(0, k - kg)), n_hi = min(4, max(0, k - kg - 16));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = ra + 8 * h;
      const bool ok = m0 + row < m;
      const uint8_t* p = sx + row * XT::kPitch + kl * sizeof(T);
      float v[8];
      if constexpr (sizeof(T) == 4) {
        read4(p, v, 0);
        read4(p + 16 * sizeof(T), v, 4);
      } else {
        read4_bf16(p, v, 0);
        read4_bf16(p + 16 * sizeof(T), v, 4);
      }
      const uint2 w = quantize(v, ok ? n_lo : 0, ok ? n_hi : 0);
      a[h] = w.x;
      a[2 + h] = w.y;
      xpart[h] = __dp4a(static_cast<int>(w.x), 0x01010101,
                        __dp4a(static_cast<int>(w.y), 0x01010101, xpart[h]));
    }
  };
  // the debug copy of a stage's codes, from the fragments once their multiplies
  // are done (no branch stands between the multiplies)
  auto write_codes = [&](int step, const uint32_t (&a)[BK / 32][4]) {
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const int kg = k_at(step, ks);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (m0 + ra + 8 * h >= m) continue;
        int8_t* dst = dbg_codes + (size_t)(m0 + ra + 8 * h) * k;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (kg + i < k) dst[kg + i] = static_cast<int8_t>((a[ks][h] >> (8 * i)) & 0xff);
          if (kg + 16 + i < k)
            dst[kg + 16 + i] = static_cast<int8_t>((a[ks][2 + h] >> (8 * i)) & 0xff);
        }
      }
    }
  };

  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;

  // Step it multiplies stage it % NS while the stages of the next NS - 1 steps
  // fill. The barrier at the top of a step sees every thread's copies of its
  // stage landed and every warpgroup done with the stage the new loads reuse.
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_steps) load(s_begin + i, i);
    tc::cp_async_commit();
  }
  for (int it = 0; it < n_steps; ++it) {
    const int stage = it % NS;
    tc::cp_async_wait<NS - 2>();
    tc::fence_async_proxy();
    __syncthreads();
    if (it + NS - 1 < n_steps) load(s_begin + it + NS - 1, (it + NS - 1) % NS);
    tc::cp_async_commit();
    if (wg_live) {
      // each k step's multiply starts as soon as its codes are packed, so the
      // next step's quantizing runs under it
      uint32_t a[BK / 32][4];
      const uint32_t sb = ring + stage * XT::kStage;
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks) {
        fragment(stage, s_begin + it, ks, a[ks]);
        tc::mma_fence();
        mma_s8_n256(acc, a[ks], tc::desc(sb + 32 * ks));
        tc::mma_commit();
      }
      tc::mma_wait<0>();
      pin(acc);
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks) tc::pin(a[ks]);
      if (dbg_codes != nullptr && blockIdx.y == 0) write_codes(s_begin + it, a);
    }
  }
  tc::cp_async_wait<0>();
  // each row's code sum: the four lanes t of a row hold a share each
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    xpart[h] += __shfl_xor_sync(0xffffffffu, xpart[h], 1);
    xpart[h] += __shfl_xor_sync(0xffffffffu, xpart[h], 2);
  }

  const bool warp_live = m0 + wg * 64 + warp * 16 < m;  // the warp holds a row inside M
  if (gridDim.z > 1) {
    // write this split's partial (fragment order: coalesced both ways), take a
    // ticket; the last split adds the others' partials to its own
    const int tile = blockIdx.x + gridDim.x * blockIdx.y, splits = gridDim.z;
    int* mine = ws + ((size_t)tile * splits + blockIdx.z) * kWsInts;
    if (warp_live) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        reinterpret_cast<int4*>(mine)[i * kThreads + tid] =
            make_int4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
      if (t4 == 0) {
        mine[BM * BN + ra] = xpart[0];
        mine[BM * BN + ra + 8] = xpart[1];
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last_s = atomicAdd(counters + tile, 1) == splits - 1;
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    if (warp_live) {
      for (int z = 0; z < splits; ++z) {
        if (z == static_cast<int>(blockIdx.z)) continue;
        const int* other = ws + ((size_t)tile * splits + z) * kWsInts;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int4 p = __ldcg(reinterpret_cast<const int4*>(other) + i * kThreads + tid);
          acc[4 * i] += p.x;
          acc[4 * i + 1] += p.y;
          acc[4 * i + 2] += p.z;
          acc[4 * i + 3] += p.w;
        }
        xpart[0] += __ldcg(other + BM * BN + ra);
        xpart[1] += __ldcg(other + BM * BN + ra + 8);
      }
    }
    if (tid == 0) counters[tile] = 0;  // ready for the next call, graph replays included
  }
  if (dbg_xsum != nullptr && blockIdx.y == 0 && t4 == 0) {
    if (m0 + ra < m) dbg_xsum[m0 + ra] = static_cast<float>(xpart[0]);
    if (m0 + ra + 8 < m) dbg_xsum[m0 + ra + 8] = static_cast<float>(xpart[1]);
  }

  // the s32 tile and the row sums into shared memory (every warpgroup is done
  // with the ring)
  __syncthreads();
  int* acc_s = reinterpret_cast<int*>(ring_p);  // [BM][kAccPitch]
  if (warp_live) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      *reinterpret_cast<int2*>(acc_s + ra * kAccPitch + col) = make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(acc_s + (ra + 8) * kAccPitch + col) =
          make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    if (t4 == 0) {
      xs_s[ra] = xpart[0];
      xs_s[ra + 8] = xpart[1];
    }
  }
  __syncthreads();

  // epilogue: 16 contiguous output bytes a thread, neighbouring threads on
  // neighbouring chunks of a row. A thread's chunk of columns is the same in
  // every row it takes (kThreads is a multiple of the chunks a row), so their
  // terms are read once, into registers
  constexpr int EPC = XT::kElems16, CPRO = BN / EPC;
  static_assert(kThreads % CPRO == 0, "a thread keeps its columns from row to row");
  const int c0 = (tid % CPRO) * EPC, col = n0 + c0;
  if (col >= n) return;
  const float kzx = __fmul_rn(static_cast<float>(k), zx);
  const bool has_bias = cols.bias != nullptr;
  ColumnTerms terms[EPC];
#pragma unroll
  for (int e = 0; e < EPC; ++e)
    if (col + e < n) terms[e] = ColumnTerms(cols, col + e, dx, zx, kzx);
  const bool whole = vec_o && col + EPC <= n;
  for (int row = tid / CPRO; row < BM && m0 + row < m; row += kThreads / CPRO) {
    const float xsr = static_cast<float>(xs_s[row]);
    const int* src = acc_s + row * kAccPitch + c0;
    int a[EPC];
#pragma unroll
    for (int e = 0; e < EPC; e += 4) {
      const int4 q = *reinterpret_cast<const int4*>(src + e);
      a[e] = q.x; a[e + 1] = q.y; a[e + 2] = q.z; a[e + 3] = q.w;
    }
    float y[EPC];
#pragma unroll
    for (int e = 0; e < EPC; ++e) y[e] = terms[e].finish(a[e], xsr, has_bias);
    T* dst = out + (size_t)(m0 + row) * n + col;
    if (whole) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (sizeof(T) == 4) w[e] = __float_as_uint(y[e]);
        else w[e] = tc::pack_bf16(y[2 * e], y[2 * e + 1]);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        if (col + e < n) dst[e] = from_f32<T>(y[e]);
    }
  }
}

template <typename T, bool ASYNC>
int launch(const void* x, const int8_t* wq, const float* dx, const float* zx, const Columns& cols,
           void* out, int8_t* dbg_codes, float* dbg_xsum, int* ws, int* counters, int m, int n,
           int k, int a_bits, int splits, int steps_per_split, cudaStream_t stream) {
  using XT = XTile<T>;
  auto kernel = int8_wgmma_kernel<T, ASYNC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, XT::kSmem);
  if (err != cudaSuccess) return err;
  const float off = static_cast<float>(1 << (a_bits - 1));
  const int vec_o = (n * static_cast<int>(sizeof(T))) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((m + BM - 1) / BM), static_cast<unsigned>((n + BN - 1) / BN),
                  static_cast<unsigned>(splits));
  kernel<<<grid, kThreads, XT::kSmem, stream>>>(
      static_cast<const T*>(x), wq, dx, zx, cols, static_cast<T*>(out), dbg_codes,
      dbg_xsum, ws, counters, m, n, k, -off, static_cast<float>((1 << a_bits) - 1) - off,
      steps_per_split, vec_o);
  return cudaGetLastError();
}

// form 1: cp.async tiles, which need every row of x and wq on a 16-byte
// boundary (the wrapper chose it from the same facts; a mismatch is refused, not
// repaired); form 2: element loads. The plan (splits runs of steps_per_split K
// steps of 128) must cover K with no empty run.
template <typename T>
int dispatch(int form, const void* x, const int8_t* wq, const float* dx, const float* zx,
             const Columns& cols, void* out, int8_t* dbg_codes, float* dbg_xsum, int* ws,
             int* counters, int m, int n, int k, int a_bits, int splits, int steps_per_split,
             cudaStream_t stream) {
  if (m < 1 || n < 1 || k < 1 || a_bits < 2 || a_bits > 8) return cudaErrorInvalidValue;
  const long long k_steps = (k + BK - 1) / BK;
  if ((n + BN - 1) / BN > 65535 || splits < 1 || splits > 65535 || steps_per_split < 1 ||
      (long long)splits * steps_per_split < k_steps ||
      (long long)(splits - 1) * steps_per_split >= k_steps ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const bool aligned = k % XTile<T>::kElems16 == 0 && k % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  if (form == 1 && aligned)
    return launch<T, true>(x, wq, dx, zx, cols, out, dbg_codes, dbg_xsum, ws, counters, m, n, k,
                           a_bits, splits, steps_per_split, stream);
  if (form == 2)
    return launch<T, false>(x, wq, dx, zx, cols, out, dbg_codes, dbg_xsum, ws, counters, m, n, k,
                            a_bits, splits, steps_per_split, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface (loaded with ctypes). x: (m, k) f32 (is_bf16 = 0) or bf16 (1);
// wq: (n, k) int8 recentered weight codes, K contiguous; dx, zx: device pointers
// to one f32 each (zx recentered and rounded by the caller); wsum, dw, zw: (n)
// f32; bias: (n) f32 (bias_bf16 = 0) or bf16 (1), or null (no bias); out:
// (m, n) in x's dtype; all
// contiguous. dbg_codes (m, k) int8 and dbg_xsum (m) f32 may be null; when
// given, the kernel also writes the codes it built and their row sums. form: 1
// cp.async tiles, 2 element loads. splits, steps_per_split: the plan of
// `int8_plan`; with splits > 1, ws holds m_tiles * n_tiles * splits * (128 * 256
// + 128) int32 of scratch and counters m_tiles * n_tiles int32 that are 0 (the
// kernel leaves them 0). Returns a cudaError_t.
extern "C" int dgq_int8_matmul(const void* x, const void* wq, const void* dx, const void* zx,
                               const void* wsum, const void* dw, const void* zw,
                               const void* bias, void* out, void* dbg_codes, void* dbg_xsum,
                               void* ws, void* counters, int m, int n, int k, int a_bits,
                               int is_bf16, int bias_bf16, int form, int splits,
                               int steps_per_split, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto wqp = static_cast<const int8_t*>(wq);
  auto dc = static_cast<int8_t*>(dbg_codes);
  auto dxs = static_cast<float*>(dbg_xsum);
  auto wsp = static_cast<int*>(ws);
  auto cnt = static_cast<int*>(counters);
  const Columns cols{f(wsum), f(dw), f(zw), bias, bias_bf16};
  return is_bf16 ? dispatch<__nv_bfloat16>(form, x, wqp, f(dx), f(zx), cols, out, dc, dxs, wsp,
                                           cnt, m, n, k, a_bits, splits, steps_per_split, st)
                 : dispatch<float>(form, x, wqp, f(dx), f(zx), cols, out, dc, dxs, wsp, cnt, m, n,
                                   k, a_bits, splits, steps_per_split, st);
}
