// Fused group-quantized conv for Hopper (sm_90a): K5.
//
// Replaces the Pallas TPU kernel `_kernel` of dgq_tpu/ops/pallas/group_conv.py
// (`group_quant_conv`). DGQ's group activation quantization gives every
// (tap, input channel) pair of a kh x kw conv its own scale and zero point, so
// the same input pixel is quantized differently by each tap that reads it and
// no library conv (one input shared by all taps) can express it. The kernel is
// a stride-1 implicit-GEMM conv over NHWC x, with M = B*H'*W' output pixels,
// N = O output channels and K = kh*kw*C: as it loads the A tile of tap t it
// turns each input value into its shifted-clip code
//     code = clip(round_half_even(x * rd[t, c]), -z[t, c], qmax - z[t, c])
// (the zero point stays in the clip bounds, so the codes are integers except
// at the bounds), rounds the code to the tensor dtype as the plain version
// does, and multiplies it against w_t[t, c, :], the weights with dm*dl folded
// in by the wrapper. f32 accumulator, + bias, cast on store. A position
// outside the image is the value 0 quantized like any other: its code is
// clip(0, -z, qmax - z), which is not 0 when z lies outside [0, qmax].
//
// What bounds it on the H100: operations at the wide-image shapes
// (2*kh*kw*C*O flops per output pixel against C + O elements moved), bytes at
// the deep ones (8 x 8 images with 2560 -> 1280 channels: 59 MB of weights for
// 256 pixels a batch entry). Inside the card the tensor-core body is held by
// the traffic from L2: every block reads its tile's whole weight panel and
// every pixel is read by nine taps (a step of 128 x 320 x 64 products pulls
// 56 KB into the SM). Two blocks of a cluster sharing one panel by TMA
// multicast would halve the weights' share; that step is still open, and the
// panel, contiguous and made by the fold, is the one operand here that a
// tensor map fits without more ado. The TPU kernel's weight residency, band
// double-buffers and 8/128 padding answer VMEM and the MXU and do not carry
// over.
//
// One wrapper call is two or three launches:
//   * The weight fold makes w_t = w * dm * dl (f32 product, one rounding to
//     the tensor dtype), rd = 1 / (dm * dl) and z = zm + zl in one launch. It
//     is redone each call because the time-aware dm changes with the step.
//     bf16 weights that lie contiguous as OIHW, as the port holds them, take
//     `fold_oihw_kernel`: a thread turns an 8 x 8 block (8 outputs by 8
//     consecutive channel-tap positions) in its registers and moves 16-byte
//     vectors both ways. Any other weight (f32, HWIO, a strided view) takes
//     `fold_kernel`, which reads w through its strides, a tile of 9 taps x 16
//     channels x 64 outputs at a time through shared memory.
//   * `group_conv_tc_kernel`, bf16 (tile code in wgmma.cuh): a block of two
//     warpgroups owns 128 pixels x 320 output channels (every k x k conv of
//     the UNets has 320, 640 or 1280 outputs, and the wider the tile the fewer
//     times a pixel is quantized again) and walks K in steps of 64 channels of
//     one tap through a ring of two stages. Eight threads load the 64 channels
//     of a pixel as eight 16-byte vectors (coalesced in NHWC; the nine taps
//     re-read a pixel from L2, no band of x is kept in shared memory),
//     quantize them in registers with that step's rd and z (rounding by the
//     add of 1.5 * 2^23, which the full-rate pipe does, where the clip bounds
//     allow it) and store the bf16 codes into the swizzled A stage; the
//     weights of the step go to the B stage by `cp.async` as they lie in
//     memory (MN-major). Step s multiplies (`wgmma`, both operands in shared
//     memory, f32 accumulator in registers) while step s + 1's weights are in
//     flight and its pixels, loaded into registers a step earlier, are
//     quantized. The codes and w_t are the bf16 numbers the plain version
//     multiplies, so only the f32 summation order differs. Where the pixel
//     tiles are too few to fill the card (32 x 32 images and below) the K
//     steps are split over blockIdx.z by the plan the wrapper computes; each
//     split writes its f32 partial tile and `finish_kernel` adds them in split
//     order with the bias, so the result does not depend on the order the
//     blocks ran in.
//   * `group_conv_tf32_kernel`, f32 (3xTF32 on the tensor cores): the bf16
//     body's structure with each f32 product formed from three TF32 products,
//     a tile of 128 pixels x 160 outputs and K steps of 32 channels; its note
//     says why. Its fold writes the weights as two K-major panels, TF32 big
//     and small parts, in place of w_t (`fold_kernel<..., true>`).
//   * `group_conv_kernel`, the first version's body (f32 FMAs on the CUDA
//     cores, 128 x 64 tile, K in chunks of 32): convs too narrow or too oddly
//     placed for 16-byte vectors (C or O no multiple of 8: conv_in's 4
//     channels, conv_out's 4 outputs; x off a 16-byte boundary), both dtypes.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BM = 128;      // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // input channels per step (of one tap)
constexpr int LDA = BM + 4;  // keeps float4 reads aligned

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_conv_kernel(const T* __restrict__ x, const T* __restrict__ w_t,
                  const float* __restrict__ rd, const float* __restrict__ z,
                  const float* __restrict__ bias, T* __restrict__ out, int nb, int h, int w,
                  int c, int o, int kh, int kw, int pad, int ho, int wo, float qmax) {
  __shared__ __align__(16) float As[BK][LDA];  // codes, k-major
  __shared__ __align__(16) float Bs[BK][BN];   // weights, k-major
  __shared__ int pix_b[BM], pix_h[BM], pix_w[BM];  // image (-1: none), row - pad, col - pad

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int m_total = nb * ho * wo;
  if (tid < BM) {
    const int gm = m0 + tid;
    if (gm < m_total) {
      const int b = gm / (ho * wo), rem = gm - b * (ho * wo);
      pix_b[tid] = b;
      pix_h[tid] = rem / wo - pad;
      pix_w[tid] = rem % wo - pad;
    } else {
      pix_b[tid] = -1;
      pix_h[tid] = 0;
      pix_w[tid] = 0;
    }
  }

  const int lane = tid % 32, warp = tid / 32;  // A loads: lane = channel, warp = pixel
  const int ty = tid / 16, tx = tid % 16;      // compute: 8 pixels x 4 channels a thread
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < kh * kw; ++tap) {
    const int ti = tap / kw, tj = tap - ti * kw;
    for (int c0 = 0; c0 < c; c0 += BK) {
      const int cc = c0 + lane;
      const bool c_ok = cc < c;
      const float rdv = c_ok ? rd[(size_t)tap * c + cc] : 0.f;
      const float zv = c_ok ? z[(size_t)tap * c + cc] : 0.f;
      const float lo = -zv, hi = qmax - zv;
      __syncthreads();  // the previous step's tiles are consumed (and pix_* are written)
#pragma unroll 4
      for (int r = 0; r < BM / 8; ++r) {
        const int m = warp + 8 * r;
        const int b = pix_b[m], hi_ = pix_h[m] + ti, wi_ = pix_w[m] + tj;
        float xv = 0.f;  // outside the image: the value 0, quantized below
        if (c_ok && b >= 0 && hi_ >= 0 && hi_ < h && wi_ >= 0 && wi_ < w)
          xv = to_f32<T>(x[(((size_t)b * h + hi_) * w + wi_) * c + cc]);
        float code = fminf(fmaxf(rintf(xv * rdv), lo), hi);
        code = c_ok ? to_f32<T>(from_f32<T>(code)) : 0.f;
        As[lane][m] = code;
      }
#pragma unroll
      for (int r = 0; r < BK * BN / kThreads; ++r) {
        const int idx = tid + r * kThreads;
        const int kk = idx / BN, n = idx - kk * BN;
        const int ck = c0 + kk, col = n0 + n;
        Bs[kk][n] = (ck < c && col < o) ? to_f32<T>(w_t[((size_t)tap * c + ck) * o + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bb[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty * 8 + i;
    if (gm >= m_total) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < o) out[(size_t)gm * o + col] = from_f32<T>(acc[i][j] + bias[col]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w_t, const float* rd, const float* z, const float* bias,
           void* out, int nb, int h, int w, int c, int o, int kh, int kw, int pad, int a_bits,
           cudaStream_t stream) {
  const int ho = h + 2 * pad - kh + 1, wo = w + 2 * pad - kw + 1;
  if (nb < 1 || c < 1 || o < 1 || kh < 1 || kw < 1 || pad < 0 || ho < 1 || wo < 1)
    return cudaErrorInvalidValue;
  const long long m_total = (long long)nb * ho * wo;
  const long long grid_y = (o + BN - 1) / BN;
  if (m_total >= (1LL << 31) || grid_y > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((m_total + BM - 1) / BM), static_cast<unsigned>(grid_y));
  group_conv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_t), rd, z, bias, static_cast<T*>(out),
      nb, h, w, c, o, kh, kw, pad, ho, wo, static_cast<float>((1 << a_bits) - 1));
  return cudaGetLastError();
}

// ---- the tensor-core body, bf16 ----

using bf16 = __nv_bfloat16;
constexpr int TBM = 128;  // output pixels per block, 64 a warpgroup
constexpr int TBN = 320;  // output channels per block: five column blocks of 64
constexpr int TBK = 64;   // input channels per step (of one tap)
constexpr int kStageA = TBM * 128;          // codes [128 pixels][64 channels], K-major
constexpr int kStageB = (TBN / 64) * 8192;  // weights, column blocks of [64 channels][64 outputs]
constexpr int kStage = kStageA + kStageB;
constexpr float kMagic = 12582912.f;  // 1.5 * 2^23: (t + kMagic) - kMagic rounds t half-to-even
constexpr float kMagicMax = 4194302.f;  // ... for |t| <= 2^22; the bounds stay 2 inside

// SPLITK: the block writes its f32 partial tile (split blockIdx.z) instead of
// the finished bf16 outputs.
template <bool SPLITK>
__global__ void __launch_bounds__(kThreads, 1)
group_conv_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_t,
                     const float* __restrict__ rd, const float* __restrict__ z,
                     const float* __restrict__ bias, bf16* __restrict__ out,
                     float* __restrict__ partial, int nb, int h, int w, int c, int o, int kh,
                     int kw, int pad, int ho, int wo, float qmax, int steps_per_split) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int pix_b[TBM], pix_h[TBM], pix_w[TBM];  // image (-1: none), row - pad, col - pad
  const uint32_t ring = (tc::smem_u32(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int m0 = blockIdx.x * TBM, n0 = blockIdx.y * TBN;
  const int m_total = nb * ho * wo;
  if (tid < TBM) {
    const int gm = m0 + tid;
    if (gm < m_total) {
      const int b = gm / (ho * wo), rem = gm - b * (ho * wo);
      pix_b[tid] = b;
      pix_h[tid] = rem / wo - pad;
      pix_w[tid] = rem % wo - pad;
    } else {
      pix_b[tid] = -1;
      pix_h[tid] = 0;
      pix_w[tid] = 0;
    }
  }
  __syncthreads();

  const int c_chunks = (c + TBK - 1) / TBK;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(kh * kw * c_chunks, s_begin + steps_per_split);

  // A side: this thread quantizes channels 8 cc.. of pixels prow + 32 i
  const int cc = tid & 7, prow = tid >> 3;
  uint4 xv[4];
  float rdv[8], zv[8];
  auto load_x = [&](int step) {
    const int tap = step / c_chunks, ch = (step - tap * c_chunks) * TBK + cc * 8;
    const int ti = tap / kw, tj = tap - ti * kw;
    const bool ch_ok = ch < c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = prow + 32 * i;
      const int b = pix_b[m], hi_ = pix_h[m] + ti, wi_ = pix_w[m] + tj;
      xv[i] = make_uint4(0u, 0u, 0u, 0u);  // outside the image: the value 0, quantized below
      if (ch_ok && b >= 0 && hi_ >= 0 && hi_ < h && wi_ >= 0 && wi_ < w)
        xv[i] = __ldg(reinterpret_cast<const uint4*>(x + (((size_t)b * h + hi_) * w + wi_) * c + ch));
    }
#pragma unroll
    for (int e = 0; e < 8; e += 4) {
      float4 r4 = make_float4(0.f, 0.f, 0.f, 0.f), z4 = r4;  // past C: codes of 0
      if (ch_ok) {
        r4 = __ldg(reinterpret_cast<const float4*>(rd + (size_t)tap * c + ch + e));
        z4 = __ldg(reinterpret_cast<const float4*>(z + (size_t)tap * c + ch + e));
      }
      rdv[e] = r4.x; rdv[e + 1] = r4.y; rdv[e + 2] = r4.z; rdv[e + 3] = r4.w;
      zv[e] = z4.x; zv[e + 1] = z4.y; zv[e + 2] = z4.z; zv[e + 3] = z4.w;
    }
  };
  auto store_a = [&](uint32_t stage) {
    // round-half-even by the add of kMagic (the full-rate pipe) is exact for
    // |t| <= 2^22 and leaves any other t outside +-(2^22 - 2), so it gives
    // clip(round(t), -z, qmax - z) whenever both bounds lie inside that; other
    // bounds take rintf
    bool fast = true;
#pragma unroll
    for (int e = 0; e < 8; ++e) fast = fast && fabsf(zv[e]) <= kMagicMax - qmax;
    auto quantize = [&](auto round) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t raw[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
        uint32_t packed[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // a bf16 is the high half of the f32 of the same value
          const float lo = __uint_as_float(raw[e] << 16), hi = __uint_as_float(raw[e] & 0xffff0000u);
          const float c0 = fminf(fmaxf(round(__fmul_rn(lo, rdv[2 * e])), -zv[2 * e]),
                                 qmax - zv[2 * e]);
          const float c1 = fminf(fmaxf(round(__fmul_rn(hi, rdv[2 * e + 1])), -zv[2 * e + 1]),
                                 qmax - zv[2 * e + 1]);
          packed[e] = tc::pack_bf16(c0, c1);
        }
        const int m = prow + 32 * i;
        tc::st_shared16(stage + tc::swz(m, cc),
                        make_uint4(packed[0], packed[1], packed[2], packed[3]));
      }
    };
    if (fast) quantize([](float t) { return __fsub_rn(__fadd_rn(t, kMagic), kMagic); });
    else quantize([](float t) { return rintf(t); });
  };
  // B side: the step's 64 x 320 weights, ten 16-byte chunks a thread
  const uint32_t b_dst0 = kStageA + tc::swz(prow, cc);
  auto load_b = [&](int step, uint32_t stage) {
    const int tap = step / c_chunks, c0 = (step - tap * c_chunks) * TBK;
    const bf16* src0 = w_t + ((size_t)tap * c + c0 + prow) * o + n0 + cc * 8;
#pragma unroll
    for (int i = 0; i < TBN / 32; ++i) {  // rows prow + 32 (i % 2) of column block i / 2
      const int ch = c0 + prow + 32 * (i & 1), col = n0 + (i >> 1) * 64 + cc * 8;
      const bool ok = ch < c && col < o;
      const bf16* src = ok ? src0 + (size_t)(32 * (i & 1)) * o + (i >> 1) * 64 : w_t;
      tc::cp_async16(stage + b_dst0 + (i >> 1) * 8192 + (i & 1) * 4096, src, ok);
    }
  };

  float acc[TBN / 64][32];
#pragma unroll
  for (int cb = 0; cb < TBN / 64; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;

  // Step s multiplies stage s % 2 while the weights of step s + 1 arrive in the
  // other stage and its pixels, loaded into registers a step earlier, are
  // quantized into it; the registers then take the pixels of step s + 2, which
  // so have a whole step to arrive.
  if (s_begin < s_end) {
    load_b(s_begin, ring);
    tc::cp_async_commit();
    load_x(s_begin);
    store_a(ring);
    if (s_begin + 1 < s_end) load_x(s_begin + 1);
  }
  for (int s = s_begin; s < s_end; ++s) {
    const uint32_t cur = ring + ((s - s_begin) & 1) * kStage, nxt = ring + ((s - s_begin + 1) & 1) * kStage;
    tc::cp_async_wait<0>();   // this step's weights have landed
    tc::fence_async_proxy();  // ... and its codes are stored
    __syncthreads();          // for every thread; the other stage is consumed
    const bool more = s + 1 < s_end;
    if (more) load_b(s + 1, nxt);
    tc::cp_async_commit();
    tc::mma_fence();
#pragma unroll
    for (int ks = 0; ks < TBK / 16; ++ks) {
      const uint64_t da = tc::desc(cur + wg * 8192 + ks * 32);
#pragma unroll
      for (int cb = 0; cb < TBN / 64; ++cb)
        tc::mma_ss_n64<1>(acc[cb], da, tc::desc(cur + kStageA + cb * 8192 + ks * 2048), 1);
    }
    tc::mma_commit();
    if (more) store_a(nxt);  // quantized while the products run
    if (s + 2 < s_end) load_x(s + 2);
    tc::mma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < TBN / 64; ++cb) tc::pin(acc[cb]);
  }

  const int r0 = m0 + wg * 64 + warp * 16 + g;
#pragma unroll
  for (int cb = 0; cb < TBN / 64; ++cb)
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      const int col = n0 + cb * 64 + 8 * jb + 2 * t4;  // O is even: col and col + 1 go together
      if (col >= o) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gm = r0 + 8 * half;
        if (gm >= m_total) continue;
        const float a = acc[cb][4 * jb + 2 * half], b = acc[cb][4 * jb + 2 * half + 1];
        if (SPLITK) {
          *reinterpret_cast<float2*>(partial + ((size_t)blockIdx.z * m_total + gm) * o + col) =
              make_float2(a, b);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)gm * o + col) =
              __floats2bfloat162_rn(a + bias[col], b + bias[col + 1]);
        }
      }
    }
}

// out = T(sum over splits, in split order, of partial + bias); two outputs a thread
template <typename T>
__global__ void finish_kernel(const float* __restrict__ partial, const float* __restrict__ bias,
                              T* __restrict__ out, size_t pairs, int o, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const size_t total = pairs * 2;
  float2 sum = *reinterpret_cast<const float2*>(partial + 2 * i);
  for (int s = 1; s < splits; ++s) {
    const float2 p = *reinterpret_cast<const float2*>(partial + s * total + 2 * i);
    sum.x += p.x;
    sum.y += p.y;
  }
  const int col = static_cast<int>((2 * i) % o);
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<__nv_bfloat162*>(out + 2 * i) =
        __floats2bfloat162_rn(sum.x + bias[col], sum.y + bias[col + 1]);
  } else {
    *reinterpret_cast<float2*>(out + 2 * i) = make_float2(sum.x + bias[col], sum.y + bias[col + 1]);
  }
}

int launch_tc(const void* x, const void* w_t, const float* rd, const float* z, const float* bias,
              void* out, float* partial, int nb, int h, int w, int c, int o, int kh, int kw,
              int pad, int a_bits, int splits, int steps_per_split, cudaStream_t stream) {
  const int ho = h + 2 * pad - kh + 1, wo = w + 2 * pad - kw + 1;
  if (nb < 1 || c < 8 || c % 8 || o < 8 || o % 8 || kh < 1 || kw < 1 || pad < 0 || ho < 1 ||
      wo < 1 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w_t) % 16)
    return cudaErrorInvalidValue;
  const long long m_total = (long long)nb * ho * wo;
  const long long steps = (long long)kh * kw * ((c + TBK - 1) / TBK);
  const long long grid_y = (o + TBN - 1) / TBN;
  if (m_total >= (1LL << 31) || grid_y > 65535 || splits < 1 || splits > 65535 ||
      steps_per_split < 1 || (long long)splits * steps_per_split < steps ||
      (long long)(splits - 1) * steps_per_split >= steps || (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  const int smem = 1024 + 2 * kStage;
  const dim3 grid(static_cast<unsigned>((m_total + TBM - 1) / TBM), static_cast<unsigned>(grid_y),
                  static_cast<unsigned>(splits));
  const float qmax = static_cast<float>((1 << a_bits) - 1);
  auto xp = static_cast<const bf16*>(x);
  auto wp = static_cast<const bf16*>(w_t);
  auto op = static_cast<bf16*>(out);
  if (splits == 1) {
    auto kernel = group_conv_tc_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(xp, wp, rd, z, bias, op, nullptr, nb, h, w, c, o, kh,
                                             kw, pad, ho, wo, qmax, steps_per_split);
    return cudaGetLastError();
  }
  auto kernel = group_conv_tc_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(xp, wp, rd, z, bias, op, partial, nb, h, w, c, o, kh, kw,
                                           pad, ho, wo, qmax, steps_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t pairs = static_cast<size_t>(m_total) * o / 2;
  finish_kernel<bf16><<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, stream>>>(
      partial, bias, op, pairs, o, splits);
  return cudaGetLastError();
}

// ---- the tensor-core body, f32: 3xTF32 ----

constexpr int FBN = 160;                     // output channels per block: two blocks of 80
constexpr int FBK = 32;                      // input channels per step (of one tap): one 128-byte row
constexpr int kFStageA = TBM * 128;          // codes [128 pixels][32 channels], one part
constexpr int kFStageB = FBN * 128;          // weights [160 outputs][32 channels], one part
constexpr int kFStage = 2 * kFStageA + 2 * kFStageB;  // big and small of both: 72 KB

// The f32 conv on the tensor cores: `group_conv_tc_kernel`'s structure with
// TF32 operands, each product of f32 numbers formed from three TF32 products
// (wgmma.cuh, `split_tf32`). A is the codes, quantized in registers as the
// bf16 body quantizes them and split into big and small parts: a code is an
// integer of at most 9 bits, which TF32 holds exactly, so its small part is 0
// unless a fractional clip bound (-z or qmax - z) cut it. B is the fold's two
// K-major panels (tap, o, c), big and small (`wgmma` takes a TF32 B operand
// K-major only), copied by `cp.async` as they lie. A step is 32 channels of
// one tap (one 128-byte row of f32); two stages of 128 pixels x 160 outputs in
// both parts are 144 KB. 160 outputs (not the bf16 body's 320) keep two
// stages inside a block's shared memory and the accumulator at 80 registers
// a thread; every UNet conv has 320, 640 or 1280 outputs, so no tile is ragged
// there, and a pixel's codes are formed again for each 160 outputs. Split K
// and the partial tiles are the bf16 body's. One accumulator runs over all of
// a block's K steps (the flash kernel's fresh chains are not needed here):
// the tensor cores' round-toward-zero adds cost at most 5.2e-4 against the
// 2e-3 bound at the deepest shape (16 x 16, 2560 -> 1280 channels, H100), 2.3x
// to 4.5x the TF32 bound there and at the other UNet shapes.
template <bool SPLITK>
__global__ void __launch_bounds__(kThreads, 1)
group_conv_tf32_kernel(const float* __restrict__ x, const float* __restrict__ panels,
                       const float* __restrict__ rd, const float* __restrict__ z,
                       const float* __restrict__ bias, float* __restrict__ out,
                       float* __restrict__ partial, int nb, int h, int w, int c, int o, int kh,
                       int kw, int pad, int ho, int wo, float qmax, int steps_per_split) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int pix_b[TBM], pix_h[TBM], pix_w[TBM];  // image (-1: none), row - pad, col - pad
  const uint32_t ring = (tc::smem_u32(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int m0 = blockIdx.x * TBM, n0 = blockIdx.y * FBN;
  const int m_total = nb * ho * wo;
  if (tid < TBM) {
    const int gm = m0 + tid;
    if (gm < m_total) {
      const int b = gm / (ho * wo), rem = gm - b * (ho * wo);
      pix_b[tid] = b;
      pix_h[tid] = rem / wo - pad;
      pix_w[tid] = rem % wo - pad;
    } else {
      pix_b[tid] = -1;
      pix_h[tid] = 0;
      pix_w[tid] = 0;
    }
  }
  __syncthreads();

  const int c_chunks = (c + FBK - 1) / FBK;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(kh * kw * c_chunks, s_begin + steps_per_split);
  const size_t panel = (size_t)kh * kw * o * c;  // the small panel follows the big one

  // A side: this thread quantizes channels 4 cc.. of pixels prow + 32 i
  const int cc = tid & 7, prow = tid >> 3;
  float4 xv[4], rdv, zv;
  auto load_x = [&](int step) {
    const int tap = step / c_chunks, ch = (step - tap * c_chunks) * FBK + cc * 4;
    const int ti = tap / kw, tj = tap - ti * kw;
    const bool ch_ok = ch < c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = prow + 32 * i;
      const int b = pix_b[m], hi_ = pix_h[m] + ti, wi_ = pix_w[m] + tj;
      xv[i] = make_float4(0.f, 0.f, 0.f, 0.f);  // outside the image: the value 0, quantized below
      if (ch_ok && b >= 0 && hi_ >= 0 && hi_ < h && wi_ >= 0 && wi_ < w)
        xv[i] = __ldg(reinterpret_cast<const float4*>(x + (((size_t)b * h + hi_) * w + wi_) * c + ch));
    }
    rdv = make_float4(0.f, 0.f, 0.f, 0.f);  // past C: codes of 0
    zv = rdv;
    if (ch_ok) {
      rdv = __ldg(reinterpret_cast<const float4*>(rd + (size_t)tap * c + ch));
      zv = __ldg(reinterpret_cast<const float4*>(z + (size_t)tap * c + ch));
    }
  };
  auto store_a = [&](uint32_t stage) {
    const float r4[4] = {rdv.x, rdv.y, rdv.z, rdv.w}, z4[4] = {zv.x, zv.y, zv.z, zv.w};
    bool fast = true;  // as the bf16 body: the add of kMagic where the bounds allow it
#pragma unroll
    for (int e = 0; e < 4; ++e) fast = fast && fabsf(z4[e]) <= kMagicMax - qmax;
    auto quantize = [&](auto round) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x4[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
        uint32_t big[4], small[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float code = fminf(fmaxf(round(__fmul_rn(x4[e], r4[e])), -z4[e]), qmax - z4[e]);
          tc::split_tf32(code, big[e], small[e]);
        }
        const uint32_t dst = stage + tc::swz(prow + 32 * i, cc);
        tc::st_shared16(dst, make_uint4(big[0], big[1], big[2], big[3]));
        tc::st_shared16(dst + kFStageA, make_uint4(small[0], small[1], small[2], small[3]));
      }
    };
    if (fast) quantize([](float t) { return __fsub_rn(__fadd_rn(t, kMagic), kMagic); });
    else quantize([](float t) { return rintf(t); });
  };
  // B side: the step's 160 x 32 weights of both panels, ten 16-byte chunks a thread
  const uint32_t b_dst0 = 2 * kFStageA + tc::swz(prow, cc);
  auto load_b = [&](int step, uint32_t stage) {
    const int tap = step / c_chunks, ch = (step - tap * c_chunks) * FBK + cc * 4;
    const float* src0 = panels + ((size_t)tap * o + n0 + prow) * c + ch;
#pragma unroll
    for (int i = 0; i < FBN / 32; ++i) {  // output rows prow + 32 i
      const bool ok = ch < c && n0 + prow + 32 * i < o;
      const float* src = ok ? src0 + (size_t)(32 * i) * c : panels;
      tc::cp_async16(stage + b_dst0 + i * 4096, src, ok);
      tc::cp_async16(stage + b_dst0 + kFStageB + i * 4096, ok ? src + panel : panels, ok);
    }
  };

  float acc[FBN / 80][40];
#pragma unroll
  for (int cb = 0; cb < FBN / 80; ++cb)
#pragma unroll
    for (int i = 0; i < 40; ++i) acc[cb][i] = 0.f;

  // the bf16 body's pipeline: step s multiplies one stage while the other
  // takes step s + 1's weights and codes
  if (s_begin < s_end) {
    load_b(s_begin, ring);
    tc::cp_async_commit();
    load_x(s_begin);
    store_a(ring);
    if (s_begin + 1 < s_end) load_x(s_begin + 1);
  }
  for (int s = s_begin; s < s_end; ++s) {
    const uint32_t cur = ring + ((s - s_begin) & 1) * kFStage;
    const uint32_t nxt = ring + ((s - s_begin + 1) & 1) * kFStage;
    tc::cp_async_wait<0>();   // this step's weights have landed
    tc::fence_async_proxy();  // ... and its codes are stored
    __syncthreads();          // for every thread; the other stage is consumed
    const bool more = s + 1 < s_end;
    if (more) load_b(s + 1, nxt);
    tc::cp_async_commit();
    tc::mma_fence();
#pragma unroll
    for (int ks = 0; ks < FBK / 8; ++ks) {
      const uint32_t a = cur + wg * 8192 + ks * 32;
      const uint64_t abig = tc::desc(a), asmall = tc::desc(a + kFStageA);
#pragma unroll
      for (int cb = 0; cb < FBN / 80; ++cb) {
        const uint32_t b = cur + 2 * kFStageA + cb * 10240 + ks * 32;
        tc::Tf32<80>::ss(acc[cb], abig, tc::desc(b + kFStageB), 1);
        tc::Tf32<80>::ss(acc[cb], asmall, tc::desc(b), 1);
        tc::Tf32<80>::ss(acc[cb], abig, tc::desc(b), 1);
      }
    }
    tc::mma_commit();
    if (more) store_a(nxt);  // quantized while the products run
    if (s + 2 < s_end) load_x(s + 2);
    tc::mma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < FBN / 80; ++cb) tc::pin(acc[cb]);
  }

  const int r0 = m0 + wg * 64 + warp * 16 + g;
#pragma unroll
  for (int cb = 0; cb < FBN / 80; ++cb)
#pragma unroll
    for (int jb = 0; jb < 10; ++jb) {
      const int col = n0 + cb * 80 + 8 * jb + 2 * t4;  // O is even: col and col + 1 go together
      if (col >= o) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gm = r0 + 8 * half;
        if (gm >= m_total) continue;
        const float a = acc[cb][4 * jb + 2 * half], b = acc[cb][4 * jb + 2 * half + 1];
        if (SPLITK) {
          *reinterpret_cast<float2*>(partial + ((size_t)blockIdx.z * m_total + gm) * o + col) =
              make_float2(a, b);
        } else {
          *reinterpret_cast<float2*>(out + (size_t)gm * o + col) =
              make_float2(a + bias[col], b + bias[col + 1]);
        }
      }
    }
}

int launch_tf32(const void* x, const void* panels, const float* rd, const float* z,
                const float* bias, void* out, float* partial, int nb, int h, int w, int c, int o,
                int kh, int kw, int pad, int a_bits, int splits, int steps_per_split,
                cudaStream_t stream) {
  const int ho = h + 2 * pad - kh + 1, wo = w + 2 * pad - kw + 1;
  if (nb < 1 || c < 8 || c % 8 || o < 8 || o % 8 || kh < 1 || kw < 1 || pad < 0 || ho < 1 ||
      wo < 1 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(panels) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 8)
    return cudaErrorInvalidValue;
  const long long m_total = (long long)nb * ho * wo;
  const long long steps = (long long)kh * kw * ((c + FBK - 1) / FBK);
  const long long grid_y = (o + FBN - 1) / FBN;
  if (m_total >= (1LL << 31) || grid_y > 65535 || splits < 1 || splits > 65535 ||
      steps_per_split < 1 || (long long)splits * steps_per_split < steps ||
      (long long)(splits - 1) * steps_per_split >= steps || (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  const int smem = 1024 + 2 * kFStage;
  const dim3 grid(static_cast<unsigned>((m_total + TBM - 1) / TBM), static_cast<unsigned>(grid_y),
                  static_cast<unsigned>(splits));
  const float qmax = static_cast<float>((1 << a_bits) - 1);
  auto xp = static_cast<const float*>(x);
  auto wp = static_cast<const float*>(panels);
  auto op = static_cast<float*>(out);
  if (splits == 1) {
    auto kernel = group_conv_tf32_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(xp, wp, rd, z, bias, op, nullptr, nb, h, w, c, o, kh,
                                             kw, pad, ho, wo, qmax, steps_per_split);
    return cudaGetLastError();
  }
  auto kernel = group_conv_tf32_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(xp, wp, rd, z, bias, op, partial, nb, h, w, c, o, kh, kw,
                                           pad, ho, wo, qmax, steps_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t pairs = static_cast<size_t>(m_total) * o / 2;
  finish_kernel<float><<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, stream>>>(
      partial, bias, op, pairs, o, splits);
  return cudaGetLastError();
}


// ---- the weight fold ----

constexpr int FT = 9;   // taps per tile
constexpr int FC = 16;  // channels per tile
constexpr int FO = 64;  // outputs per tile

template <typename S> __device__ __forceinline__ float scale_at(const void* p, long long i) {
  return to_f32<S>(static_cast<const S*>(p)[i]);
}

// w: element (t, ch, oc) at w[t * s_t + ch * s_c + oc * s_o]. dm, zm: element
// (t, ch) at [t * s_dt + ch * s_dc]; dl, zl: one element each; all four of type S.
// PANELS (f32): in place of w_t, the two K-major panels the 3xTF32 body reads,
// (tap, o, c) as TF32 big and small parts of w_t's values, the small panel
// taps * o * c elements after the big one at w_t.
template <typename T, typename S, bool PANELS>
__global__ void __launch_bounds__(256)
fold_kernel(const T* __restrict__ w, long long s_t, long long s_c, long long s_o, const void* dm,
            const void* zm, long long s_dt, long long s_dc, const void* dl, const void* zl,
            T* __restrict__ w_t, float* __restrict__ rd, float* __restrict__ z, int taps, int c,
            int o) {
  // tile[output][channel * nt + tap]: a row is the run of an output's weights
  // as OIHW holds it; its pitch is an odd number of 4-byte words, so threads
  // that walk the outputs of one (channel, tap) hit distinct banks
  constexpr int PITCH = FC * FT + (sizeof(T) == 2 ? 2 : 1);
  __shared__ T tile[FO][PITCH];
  const int o0 = blockIdx.x * FO, c0 = blockIdx.y * FC, t0 = blockIdx.z * FT;
  const int nt = min(FT, taps - t0);
  const float dlv = scale_at<S>(dl, 0), zlv = scale_at<S>(zl, 0);
  // read in the order w lies in: outputs innermost (HWIO) or taps innermost (OIHW)
  for (int idx = threadIdx.x; idx < nt * FC * FO; idx += 256) {
    int t, cl, ol;
    if (s_o == 1) {
      ol = idx % FO;
      cl = (idx / FO) % FC;
      t = idx / (FO * FC);
    } else if (nt == FT) {
      t = idx % FT;
      cl = (idx / FT) % FC;
      ol = idx / (FT * FC);
    } else {
      t = idx % nt;
      cl = (idx / nt) % FC;
      ol = idx / (nt * FC);
    }
    if (c0 + cl < c && o0 + ol < o)
      tile[ol][cl * nt + t] = w[(t0 + t) * s_t + (c0 + cl) * s_c + (o0 + ol) * s_o];
  }
  __syncthreads();
  if constexpr (PANELS) {
    float* big = reinterpret_cast<float*>(w_t);
    float* small = big + (size_t)taps * o * c;
    for (int idx = threadIdx.x; idx < nt * FC * FO; idx += 256) {  // channels innermost
      const int cl = idx % FC, ol = (idx / FC) % FO, t = idx / (FC * FO);
      const int ch = c0 + cl, oc = o0 + ol, tap = t0 + t;
      if (ch >= c || oc >= o) continue;
      const float d = __fmul_rn(scale_at<S>(dm, tap * s_dt + ch * s_dc), dlv);
      uint32_t b, sm;
      tc::split_tf32(__fmul_rn(to_f32<T>(tile[ol][cl * nt + t]), d), b, sm);
      const size_t at = ((size_t)tap * o + oc) * c + ch;
      big[at] = __uint_as_float(b);
      small[at] = __uint_as_float(sm);
    }
  } else {
    for (int idx = threadIdx.x; idx < nt * FC * FO; idx += 256) {
      const int ol = idx % FO, cl = (idx / FO) % FC, t = idx / (FO * FC);
      const int ch = c0 + cl, oc = o0 + ol, tap = t0 + t;
      if (ch >= c || oc >= o) continue;
      const float d = __fmul_rn(scale_at<S>(dm, tap * s_dt + ch * s_dc), dlv);
      w_t[((size_t)tap * c + ch) * o + oc] =
          from_f32<T>(__fmul_rn(to_f32<T>(tile[ol][cl * nt + t]), d));
    }
  }
  if (blockIdx.x == 0)
    for (int idx = threadIdx.x; idx < nt * FC; idx += 256) {
      const int cl = idx % FC, tap = t0 + idx / FC, ch = c0 + cl;
      if (ch >= c) continue;
      const float d = __fmul_rn(scale_at<S>(dm, tap * s_dt + ch * s_dc), dlv);
      rd[(size_t)tap * c + ch] = __fdiv_rn(1.f, d);
      z[(size_t)tap * c + ch] = __fadd_rn(scale_at<S>(zm, tap * s_dt + ch * s_dc), zlv);
    }
}

// The same fold for bf16 weights that lie contiguous as OIHW (the port's own
// layout: element (t, ch, oc) at oc * c * taps + ch * taps + t), with c and o
// multiples of 8 and w, w_t on 16-byte boundaries: no shared memory. Along an
// output's row the index k = ch * taps + t is contiguous, so a thread loads the
// 16-byte vector of 8 consecutive k from each of 8 consecutive outputs, turns
// the 8 x 8 block in its registers, scales row k by dm[k] dl, and stores one
// 16-byte vector of 8 outputs for each k. A warp is 8 k-vectors (128 bytes of a
// row) by 4 output octets (64 bytes of a w_t row), so both directions move
// whole 32-byte sectors.
template <typename S>
__global__ void __launch_bounds__(256)
fold_oihw_kernel(const bf16* __restrict__ w, const void* dm, const void* zm, long long s_dt,
                 long long s_dc, const void* dl, const void* zl, bf16* __restrict__ w_t,
                 float* __restrict__ rd, float* __restrict__ z, int taps, int c, int o) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kv = (blockIdx.x * 4 + (warp & 3)) * 8 + (lane & 7);  // vector of 8 k
  const int og = (blockIdx.y * 2 + (warp >> 2)) * 4 + (lane >> 3);  // octet of outputs
  const int kc = c * taps;
  if (kv * 8 >= kc || og * 8 >= o) return;
  const float dlv = scale_at<S>(dl, 0);
  float d[8];
  int dst[8];  // k's row of w_t: tap * c + ch
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int k = kv * 8 + e, ch = k / taps, tap = k - ch * taps;
    d[e] = __fmul_rn(scale_at<S>(dm, tap * s_dt + ch * s_dc), dlv);
    dst[e] = tap * c + ch;
    if (og == 0) {
      rd[dst[e]] = __fdiv_rn(1.f, d[e]);
      z[dst[e]] = __fadd_rn(scale_at<S>(zm, tap * s_dt + ch * s_dc), scale_at<S>(zl, 0));
    }
  }
  uint32_t in[8][4];  // [output][pair of k]
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(w + (size_t)(og * 8 + r) * kc + kv * 8));
    in[r][0] = v.x; in[r][1] = v.y; in[r][2] = v.z; in[r][3] = v.w;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    uint32_t packed[4];
#pragma unroll
    for (int r = 0; r < 8; r += 2) {  // a bf16 is the high half of the f32 of the same value
      const uint32_t a = in[r][e >> 1], b = in[r + 1][e >> 1];
      const float fa = __uint_as_float((e & 1) ? (a & 0xffff0000u) : (a << 16));
      const float fb = __uint_as_float((e & 1) ? (b & 0xffff0000u) : (b << 16));
      packed[r >> 1] = tc::pack_bf16(__fmul_rn(fa, d[e]), __fmul_rn(fb, d[e]));
    }
    *reinterpret_cast<uint4*>(w_t + (size_t)dst[e] * o + og * 8) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

template <typename S>
int launch_fold_oihw(const void* w, const void* dm, const void* zm, long long s_dt, long long s_dc,
                     const void* dl, const void* zl, void* w_t, float* rd, float* z, int taps,
                     int c, int o, cudaStream_t stream) {
  const long long gx = ((long long)c * taps / 8 + 31) / 32, gy = (o / 8 + 7) / 8;
  if (gy > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  fold_oihw_kernel<S><<<grid, 256, 0, stream>>>(static_cast<const bf16*>(w), dm, zm, s_dt, s_dc,
                                               dl, zl, static_cast<bf16*>(w_t), rd, z, taps, c, o);
  return cudaGetLastError();
}

template <typename T, typename S, bool PANELS = false>
int launch_fold(const void* w, long long s_t, long long s_c, long long s_o, const void* dm,
                const void* zm, long long s_dt, long long s_dc, const void* dl, const void* zl,
                void* w_t, float* rd, float* z, int taps, int c, int o, cudaStream_t stream) {
  if (taps < 1 || c < 1 || o < 1) return cudaErrorInvalidValue;
  const long long gy = (c + FC - 1) / FC, gz = (taps + FT - 1) / FT;
  if (gy > 65535 || gz > 65535) return cudaErrorInvalidValue;
  const dim3 grid((o + FO - 1) / FO, static_cast<unsigned>(gy), static_cast<unsigned>(gz));
  fold_kernel<T, S, PANELS><<<grid, 256, 0, stream>>>(static_cast<const T*>(w), s_t, s_c, s_o, dm, zm, s_dt,
                                              s_dc, dl, zl, static_cast<T*>(w_t), rd, z, taps, c, o);
  return cudaGetLastError();
}

// S: the type of dm, zm, dl and zl. The main paths hold them in bf16 with the
// weights (the time-aware dm is one slot of the qstate, picked anew each step),
// so the kernels read either type rather than have the wrapper convert four
// tensors with four more launches before every conv of a host-bound step.
template <typename S>
int fold_dispatch(const void* w, long long s_t, long long s_c, long long s_o, const void* dm,
                  const void* zm, long long s_dt, long long s_dc, const void* dl, const void* zl,
                  void* w_t, void* rd, void* z, int taps, int c, int o, int is_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto rdp = static_cast<float*>(rd);
  auto zp = static_cast<float*>(z);
  if (is_bf16 && s_t == 1 && s_c == taps && s_o == (long long)c * taps && c % 8 == 0 &&
      o % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(w_t) % 16 == 0)
    return launch_fold_oihw<S>(w, dm, zm, s_dt, s_dc, dl, zl, w_t, rdp, zp, taps, c, o, st);
  if (is_bf16)
    return launch_fold<__nv_bfloat16, S>(w, s_t, s_c, s_o, dm, zm, s_dt, s_dc, dl, zl, w_t, rdp, zp,
                                         taps, c, o, st);
  return launch_fold<float, S>(w, s_t, s_c, s_o, dm, zm, s_dt, s_dc, dl, zl, w_t, rdp, zp, taps, c,
                               o, st);
}

}  // namespace

// C interface (loaded with ctypes). Every function returns a cudaError_t.
//
// The conv. x: (b, h, w, c) NHWC; w_t: (kh*kw, c, o), rd, z: (kh*kw, c) f32, as
// dgq_group_conv_fold writes them; bias: (o) f32; out: (b, h', w', o) in x's
// dtype; all contiguous, x/w_t/out f32 (is_bf16 = 0) or bf16 (1). Stride 1.
// form 0: the CUDA-core body (splits must be 1). form 1: the tensor-core body
// (bf16, C and O multiples of 8, x and w_t on 16-byte boundaries); its K steps
// (kh*kw * ceil(c / 64)) go to `splits` blocks of `steps_per_split` steps, and
// with splits > 1 `partial` is (splits, b*h'*w', o) f32 scratch. form 2: the
// f32 tensor-core body (3xTF32), on the same terms; w_t is then the two
// panels dgq_group_conv_fold_panels writes, and a K step is 32 channels
// (kh*kw * ceil(c / 32) steps).
extern "C" int dgq_group_quant_conv(const void* x, const void* w_t, const void* rd, const void* z,
                                    const void* bias, void* out, void* partial, int nb, int h,
                                    int w, int c, int o, int kh, int kw, int pad, int a_bits,
                                    int is_bf16, int form, int splits, int steps_per_split,
                                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto rdp = static_cast<const float*>(rd);
  auto zp = static_cast<const float*>(z);
  auto bp = static_cast<const float*>(bias);
  if (form == 1) {
    if (!is_bf16) return cudaErrorInvalidValue;
    return launch_tc(x, w_t, rdp, zp, bp, out, static_cast<float*>(partial), nb, h, w, c, o, kh,
                     kw, pad, a_bits, splits, steps_per_split, st);
  }
  if (form == 2) {
    if (is_bf16) return cudaErrorInvalidValue;
    return launch_tf32(x, w_t, rdp, zp, bp, out, static_cast<float*>(partial), nb, h, w, c, o, kh,
                       kw, pad, a_bits, splits, steps_per_split, st);
  }
  if (form != 0 || splits != 1) return cudaErrorInvalidValue;
  return is_bf16 ? launch<__nv_bfloat16>(x, w_t, rdp, zp, bp, out, nb, h, w, c, o, kh, kw, pad,
                                         a_bits, st)
                 : launch<float>(x, w_t, rdp, zp, bp, out, nb, h, w, c, o, kh, kw, pad, a_bits,
                                 st);
}

// The weight fold. w: the (kh*kw, c, o) weights through their element strides
// (s_t, s_c, s_o), f32 or bf16 (is_bf16); dm, zm: (kh*kw, c) through (s_dt,
// s_dc); dl, zl: one element each; the four of them f32 or bf16 (scales_bf16).
// Writes w_t (contiguous, w's dtype), rd and z (f32). Strides (1, kh*kw,
// c*kh*kw) with bf16, c and o multiples of 8 and 16-byte-aligned w and w_t pick
// the register-transpose kernel; the bits are the same.
extern "C" int dgq_group_conv_fold(const void* w, long long s_t, long long s_c, long long s_o,
                                   const void* dm, const void* zm, long long s_dt, long long s_dc,
                                   const void* dl, const void* zl, void* w_t, void* rd, void* z,
                                   int taps, int c, int o, int is_bf16, int scales_bf16,
                                   void* stream) {
  if (taps < 1 || c < 1 || o < 1) return cudaErrorInvalidValue;
  return scales_bf16 ? fold_dispatch<__nv_bfloat16>(w, s_t, s_c, s_o, dm, zm, s_dt, s_dc, dl, zl,
                                                    w_t, rd, z, taps, c, o, is_bf16, stream)
                     : fold_dispatch<float>(w, s_t, s_c, s_o, dm, zm, s_dt, s_dc, dl, zl, w_t, rd,
                                            z, taps, c, o, is_bf16, stream);
}

// The fold for the f32 tensor-core body: as dgq_group_conv_fold on f32
// weights, but in place of w_t it writes `panels`, (2, kh*kw, o, c) f32: the
// TF32 big and small parts of w_t's values, transposed to K-major.
extern "C" int dgq_group_conv_fold_panels(const void* w, long long s_t, long long s_c,
                                          long long s_o, const void* dm, const void* zm,
                                          long long s_dt, long long s_dc, const void* dl,
                                          const void* zl, void* panels, void* rd, void* z,
                                          int taps, int c, int o, int scales_bf16, void* stream) {
  if (taps < 1 || c < 1 || o < 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto rdp = static_cast<float*>(rd);
  auto zp = static_cast<float*>(z);
  return scales_bf16 ? launch_fold<float, __nv_bfloat16, true>(w, s_t, s_c, s_o, dm, zm, s_dt, s_dc,
                                                               dl, zl, panels, rdp, zp, taps, c, o,
                                                               st)
                     : launch_fold<float, float, true>(w, s_t, s_c, s_o, dm, zm, s_dt, s_dc, dl,
                                                       zl, panels, rdp, zp, taps, c, o, st);
}
