// Fused quantize -> int8 matmul -> dequantize for Hopper (sm_90a): K6.
//
// Replaces the Pallas TPU kernel `_kernel` of dgq_tpu/ops/pallas/int8_matmul.py
// (`quantized_matmul`): the deploy path of every linear and 1x1 conv whose
// activation has one scale per tensor. In one launch it
//   1. quantizes the f32/bf16 activation tile to recentered int8 codes as it
//      loads it,   xq = clip(round_half_even(x / dx) + zx, nb, pb)
//      (zx and the bounds recentered by 2^(a_bits-1): A8 [-128, 127], A6 [-32, 31]),
//   2. multiplies the codes against the packed int8 weight codes on the tensor
//      cores, s8 x s8 -> s32, and sums each row's codes alongside (xsum),
//   3. removes the affine cross terms and dequantizes in f32,
//      y[m, o] = dx*dw[o] * (acc - zx*wsum[o] - zw[o]*xsum[m] + K*zx*zw[o]) + bias[o],
//      written in the activation's dtype.
// dx and zx are read from device memory (they are time-aware tensors), wsum is
// the per-out-channel sum of the weight codes, made once at pack time.
//
// What bounds it on the H100: operations at the wide shapes (M = 16384,
// K = 320, N = 2560 is 2*M*N*K = 26.8 GOP against 23 MB moved), bytes at the
// small-M ones (the time embedding, M = 4). The TPU kernel keeps a full-K
// (BM, K) tile in VMEM and its wrapper pads M and N; here a block owns a
// 64 x 256 output tile, walks K in tiles of 64 through 45 KB of shared memory
// and masks the ragged M, N and K edges itself, so no padded copy is made.
// This first version is right and simple: `mma.sync.m16n8k32` s8 tiles with
// `ldmatrix` fragments, 8 warps of 64 x 32 outputs each, two blocks an SM. The
// next K tile is in flight while the current one is multiplied: its weight
// codes go straight to the other half of a double buffer (`cp.async`), its
// activation values wait in registers to be quantized. `wgmma` s8 and TMA are
// later work.
//
// Every block along N quantizes its activation tile again, and a quantized
// value costs more instructions than the product it feeds, so the tile is wide
// (each code serves 256 columns) and the quantizer is short: a multiply by
// 1 / dx, a clamp, and the rounding add of 1.5 * 2^23, which leaves the integer
// in the low mantissa bits. The product with the rounded reciprocal can differ
// from the true quotient by an ulp, which changes the code only next to a
// rounding tie (a half-integer); a run of 8 values with one that near, and any
// dx or zx the short form cannot take, goes through the true division instead.
// So the codes are those of `clip(round(x / dx) + zx, nb, pb)` bit for bit.
//
// The integer part is exact and the f32 epilogue is written with explicit
// round-to-nearest operations in the order of the plain PyTorch version (no
// fused multiply-add), so the two agree to the last bit.
#include "common.cuh"
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 64;       // output rows per block
constexpr int BN = 256;      // output columns per block
constexpr int BK = 64;       // codes of K per step
constexpr int LD = BK + 16;  // row pitch in bytes: 16-byte aligned, fragment reads conflict-free
constexpr int AR = BM / 32;  // rows of 8 activation values a thread loads per step
constexpr int BR = BN / 64;  // rows of 16 weight codes a thread loads per step
constexpr float kMagic = 12582912.f;   // 1.5 * 2^23: x + kMagic rounds x half-to-even
constexpr int kMagicBits = 0x4B400000;  // and holds the integer in its low mantissa bits

// The in-kernel activation quantizer: recentered integer codes of 8 values,
// clip(round_half_even(x / dx) + zx, nb, pb), packed as two words of 4 bytes.
struct Quantizer {
  float dx, zx, nb, pb, inv, lo, hi, margin0;
  int bias;

  __device__ Quantizer(float dx_, float zx_, float nb_, float pb_)
      : dx(dx_), zx(zx_), nb(nb_), pb(pb_) {
    inv = __frcp_rn(dx);
    lo = nb - zx;  // clip(round(t) + zx, nb, pb) == round(clip(t, lo, hi)) + zx for integer zx
    hi = pb - zx;
    bias = static_cast<int>(zx) - kMagicBits;
    const bool fast = isfinite(inv) && fabsf(inv) >= 1.17549435e-38f && zx == rintf(zx) &&
                      fabsf(zx) <= 512.f;
    margin0 = fast ? 1.f : -1.f;
  }

  __device__ __forceinline__ int by_division(float x) const {
    return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, dx)) + zx, nb), pb));
  }

  // The short form. x * inv is within 2^-22 |r| of the rounded quotient;
  // `margin` goes to 0 or below when r is nearer to a tie than twice that, where
  // only the division says which way the quotient rounds.
  __device__ __forceinline__ int by_reciprocal(float x, float& margin) const {
    const float r = fminf(fmaxf(__fmul_rn(x, inv), lo), hi);
    const float v = __fadd_rn(r, kMagic);
    const float frac = __fsub_rn(r, __fsub_rn(v, kMagic));  // r - round(r), exact
    margin = fminf(margin, fmaf(fabsf(r), -0x1p-21f, 0.5f - fabsf(frac)));
    return __float_as_int(v) + bias;
  }

  // codes of v[0..7]; positions from `nvalid` on hold code 0
  __device__ __forceinline__ uint2 operator()(const float (&v)[8], int nvalid) const {
    int c[8];
    float margin = margin0;
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i] = by_reciprocal(v[i], margin);
    if (margin <= 0.f) {
#pragma unroll
      for (int i = 0; i < 8; ++i) c[i] = by_division(v[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i] = i < nvalid ? c[i] : 0;
    // the low byte of each code, four to a word
    return make_uint2(
        __byte_perm(__byte_perm(c[0], c[1], 0x0040), __byte_perm(c[2], c[3], 0x0040), 0x5410),
        __byte_perm(__byte_perm(c[4], c[5], 0x0040), __byte_perm(c[6], c[7], 0x0040), 0x5410));
  }
};

template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                  float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 8 consecutive elements of a row as f32; elements past `nvalid` are not read.
__device__ __forceinline__ void load8(const float* p, bool vec, int nvalid, float (&v)[8]) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < nvalid ? p[i] : 0.f;
  }
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, bool vec, int nvalid,
                                      float (&v)[8]) {
  if (vec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of the f32 of the same value
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < nvalid ? __bfloat162float(p[i]) : 0.f;
  }
}

// 16 consecutive weight codes of a row; codes past `nvalid` are 0.
__device__ __forceinline__ uint4 load16(const int8_t* p, bool vec, int nvalid) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < nvalid) w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[i])) << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 16-byte blocks of shared memory as mma fragments: lanes 8j..8j+7 give
// the row addresses of block j, and register j of lane l holds bytes 4(l%4)..+3
// of row l/4 of block j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes from device memory to shared memory without passing through registers
__device__ __forceinline__ void cp_async16(int8_t* dst, const int8_t* src) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                   const float* __restrict__ dxp, const float* __restrict__ zxp,
                   const float* __restrict__ wsum, const float* __restrict__ dw,
                   const float* __restrict__ zw, const float* __restrict__ bias,
                   T* __restrict__ out, int8_t* __restrict__ dbg_codes,
                   float* __restrict__ dbg_xsum, int m, int n, int k, float nb, float pb,
                   int vec_a, int vec_b, int vec_o) {
  __shared__ __align__(16) int8_t As[BM * LD];     // activation codes, K contiguous
  __shared__ __align__(16) int8_t Bs[2][BN * LD];  // weight codes, K contiguous, two K tiles
  __shared__ int xs[BM];                           // each row's sum of codes

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const float dx = *dxp, zx = *zxp;
  const Quantizer quantize(dx, zx, nb, pb);

  // loads: A, AR rows x 8 values a thread; B, BR rows x 16 codes a thread
  const int arow = tid >> 3, akc = (tid & 7) * 8;
  const int brow = tid >> 2, bkc = (tid & 3) * 16;
  float av[AR][8];
  int xpart[AR];
#pragma unroll
  for (int r = 0; r < AR; ++r) xpart[r] = 0;

  // rows past M and N and codes past K are 0 and add nothing to acc or xsum
  auto load_a = [&](int k0) {
#pragma unroll
    for (int r = 0; r < AR; ++r) {
      const int gm = m0 + arow + 32 * r, gk = k0 + akc;
      const int nvalid = gm < m ? min(8, k - gk) : 0;  // <= 0: nothing to read
      load8(x + (size_t)gm * k + gk, vec_a && nvalid == 8, nvalid, av[r]);
    }
  };
  auto load_b = [&](int k0, int8_t* tile) {
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const int gn = n0 + brow + 64 * r, gk = k0 + bkc;
      const int nvalid = gn < n ? min(16, k - gk) : 0;
      const int8_t* src = wq + (size_t)gn * k + gk;
      int8_t* dst = &tile[(brow + 64 * r) * LD + bkc];
      if (vec_b && nvalid == 16) cp_async16(dst, src);
      else *reinterpret_cast<uint4*>(dst) = load16(src, false, nvalid);
    }
  };
  // quantize the held activation values into shared memory
  auto store_a = [&](int k0) {
#pragma unroll
    for (int r = 0; r < AR; ++r) {
      const int row = arow + 32 * r, gm = m0 + row, gk = k0 + akc;
      const uint2 w = quantize(av[r], gm < m ? k - gk : 0);
      xpart[r] = __dp4a(static_cast<int>(w.x), 0x01010101,
                        __dp4a(static_cast<int>(w.y), 0x01010101, xpart[r]));
      *reinterpret_cast<uint2*>(&As[row * LD + akc]) = w;
      if (dbg_codes != nullptr && blockIdx.y == 0 && gm < m) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (gk + i < k)
            dbg_codes[(size_t)gm * k + gk + i] =
                static_cast<int8_t>(((i < 4 ? w.x : w.y) >> (8 * (i % 4))) & 0xff);
      }
    }
  };

  // compute: warp wn owns all 64 rows of columns wn*32..+31
  const int lane = tid & 31, wn = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // fragment addresses (see ldmatrix_x4): A rows 16 mi.., both halves of 32 codes;
  // B columns 16 nj.., the same
  const int a_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 16 * (lane >> 4);
  const int b_off = (wn * 32 + (lane & 7) + 8 * (lane >> 4)) * LD + 16 * ((lane >> 3) & 1);
  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int n_tiles = (k + BK - 1) / BK;
  load_b(0, Bs[0]);
  load_a(0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int8_t* bs = Bs[kt & 1];
    store_a(kt * BK);
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < n_tiles) {  // in flight during the products
      load_b((kt + 1) * BK, Bs[(kt + 1) & 1]);
      load_a((kt + 1) * BK);
    }
#pragma unroll
    for (int kb = 0; kb < BK; kb += 32) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) ldmatrix_x4(a[mi], &As[mi * 16 * LD + a_off + kb]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) ldmatrix_x4(b[nj], &bs[nj * 16 * LD + b_off + kb]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], a[mi], b[ni >> 1][2 * (ni & 1)], b[ni >> 1][2 * (ni & 1) + 1]);
    }
    __syncthreads();  // As is consumed before the next step overwrites it
  }

  // each row's code sum: the 8 threads that loaded a row are 8 neighbouring lanes
#pragma unroll
  for (int r = 0; r < AR; ++r) {
    int s = xpart[r];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    if ((tid & 7) == 0) {
      xs[arow + 32 * r] = s;
      const int gm = m0 + arow + 32 * r;
      if (dbg_xsum != nullptr && blockIdx.y == 0 && gm < m) dbg_xsum[gm] = static_cast<float>(s);
    }
  }
  __syncthreads();

  // epilogue, f32, in the plain version's order and without contraction; a
  // thread owns two neighbouring columns of each of its rows
  const float kzx = __fmul_rn(static_cast<float>(k), zx);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + t * 2;
    if (col >= n) continue;
    const bool pair = col + 1 < n;
    float zwc[2], zx_ws[2], kzz[2], sc[2], bc[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = pair ? col + e : col;
      zwc[e] = zw[c];
      bc[e] = bias[c];
      zx_ws[e] = __fmul_rn(zx, wsum[c]);
      kzz[e] = __fmul_rn(kzx, zwc[e]);
      sc[e] = __fmul_rn(dx, dw[c]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mi * 16 + g + 8 * h;
        if (m0 + row >= m) continue;
        const float xsr = static_cast<float>(xs[row]);
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = __fsub_rn(static_cast<float>(acc[mi][ni][2 * h + e]), zx_ws[e]);
          v = __fsub_rn(v, __fmul_rn(zwc[e], xsr));
          v = __fadd_rn(v, kzz[e]);
          y[e] = __fadd_rn(__fmul_rn(sc[e], v), bc[e]);
        }
        T* dst = out + (size_t)(m0 + row) * n + col;
        if (pair && vec_o) {
          store2<T>(dst, y[0], y[1]);
        } else {
          dst[0] = from_f32<T>(y[0]);
          if (pair) dst[1] = from_f32<T>(y[1]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const int8_t* wq, const float* dx, const float* zx, const float* wsum,
           const float* dw, const float* zw, const float* bias, void* out, int8_t* dbg_codes,
           float* dbg_xsum, int m, int n, int k, int a_bits, cudaStream_t stream) {
  if (m < 1 || n < 1 || k < 1 || a_bits < 2 || a_bits > 8) return cudaErrorInvalidValue;
  const long long grid_y = (n + BN - 1) / BN;
  if (grid_y > 65535) return cudaErrorInvalidValue;
  const float off = static_cast<float>(1 << (a_bits - 1));
  const int elems16 = 16 / static_cast<int>(sizeof(T));  // elements per 16 bytes
  const int vec_a = k % elems16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_b = k % 16 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  const int vec_o = n % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const dim3 grid((m + BM - 1) / BM, static_cast<unsigned>(grid_y));
  int8_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), wq, dx, zx, wsum, dw, zw, bias, static_cast<T*>(out), dbg_codes,
      dbg_xsum, m, n, k, -off, static_cast<float>((1 << a_bits) - 1) - off, vec_a, vec_b,
      vec_o);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). x: (m, k) f32 (is_bf16 = 0) or bf16 (1);
// wq: (n, k) int8 recentered weight codes, K contiguous; dx, zx: device pointers
// to one f32 each (zx recentered and rounded by the caller); wsum, dw, zw, bias:
// (n) f32; out: (m, n) in x's dtype; all contiguous. dbg_codes (m, k) int8 and
// dbg_xsum (m) f32 may be null; when given, the kernel also writes the codes it
// built and their row sums. Returns a cudaError_t.
extern "C" int dgq_int8_matmul(const void* x, const void* wq, const void* dx, const void* zx,
                               const void* wsum, const void* dw, const void* zw,
                               const void* bias, void* out, void* dbg_codes, void* dbg_xsum,
                               int m, int n, int k, int a_bits, int is_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto wqp = static_cast<const int8_t*>(wq);
  auto dc = static_cast<int8_t*>(dbg_codes);
  auto dxs = static_cast<float*>(dbg_xsum);
  return is_bf16 ? launch<__nv_bfloat16>(x, wqp, f(dx), f(zx), f(wsum), f(dw), f(zw), f(bias),
                                         out, dc, dxs, m, n, k, a_bits, st)
                 : launch<float>(x, wqp, f(dx), f(zx), f(wsum), f(dw), f(zw), f(bias), out, dc,
                                 dxs, m, n, k, a_bits, st);
}
