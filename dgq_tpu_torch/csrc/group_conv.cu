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
// What bounds it on the H100: operations (2*kh*kw*C*O flops per output pixel
// against C + O elements moved). The TPU kernel's weight residency, band
// double-buffers and 8/128 padding answer VMEM and the MXU and do not carry
// over. This first version is right and simple: f32 FMAs on the CUDA cores,
// one block of 256 threads per 128 pixels x 64 output channels, K walked in
// chunks of 32 channels of one tap; a warp loads 32 consecutive channels of a
// pixel (coalesced in NHWC), quantizes them and stores them k-major in shared
// memory; each thread owns 8 pixels x 4 channels of the output tile. Tensor
// cores (the codes are exact in bf16) and asynchronous loads are later work.
#include "common.cuh"

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

}  // namespace

// C interface (loaded with ctypes). x: (b, h, w, c) NHWC; w_t: (kh*kw, c, o),
// the weights times dm*dl, in x's dtype; rd = 1/(dm*dl) and z = zm + zl:
// (kh*kw, c) f32; bias: (o) f32; out: (b, h', w', o) in x's dtype; all
// contiguous, x/w_t/out f32 (is_bf16 = 0) or bf16 (1). Stride 1. Returns a
// cudaError_t.
extern "C" int dgq_group_quant_conv(const void* x, const void* w_t, const void* rd, const void* z,
                                    const void* bias, void* out, int nb, int h, int w, int c,
                                    int o, int kh, int kw, int pad, int a_bits, int is_bf16,
                                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto rdp = static_cast<const float*>(rd);
  auto zp = static_cast<const float*>(z);
  auto bp = static_cast<const float*>(bias);
  return is_bf16 ? launch<__nv_bfloat16>(x, w_t, rdp, zp, bp, out, nb, h, w, c, o, kh, kw, pad,
                                         a_bits, st)
                 : launch<float>(x, w_t, rdp, zp, bp, out, nb, h, w, c, o, kh, kw, pad, a_bits,
                                 st);
}
