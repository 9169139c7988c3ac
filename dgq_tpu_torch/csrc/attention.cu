// Attention kernels for the SD v1.4 deploy path on Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of dgq_tpu/ops/pallas/attention.py:
//   * K1 `_static_uniform_kernel`: softmax attention with the reference's
//     uniform post-softmax quantizer (zero point 0, static delta):
//         P = softmax(Q K^T * scale);  code = min(round(P / delta), 2^b - 1);
//         out = delta * (code @ V)
//     Every UNet self- and cross-attention of the g=1 policy runs it.
//   * K2 `_flash_kernel`: unquantized online-softmax flash attention (the VAE
//     mid-block attention, head_dim 512, and the fp UNet path).
//
// What bounds it on the H100. At the main path's shapes (T = S = 4096,
// head_dim 40..512) attention is compute-bound: QK^T and PV are
// 4*T*S*D flops against (T + 2S)*D elements read. The TPU kernel caches the
// (rows, S) f32 exp blocks of pass 1 in VMEM (up to 8 MB) so pass 2 needs no
// second QK^T; that cache does not fit in the 227 KB of shared memory a block
// may use here, so K1 recomputes Q K^T in pass 2 (as the TPU's `_accum_kernel`
// does) and pays 1.5x the flops of K2.
//
// Design (first version: right and simple, not yet fast). One block of 256
// threads per (batch*head, 16*RM query rows). Q stays in shared memory; K and
// V tiles of 64 keys stream through one shared buffer as f32. Each thread owns
// RM query rows x 4 keys of every score tile (register blocking, float4 reads
// along the head dim) and RM rows x DP/16 columns of the output accumulator,
// which lives in registers, so D = 512 (VAE) needs no accumulator in shared
// memory: it runs with RM = 2. All arithmetic is f32 on the CUDA cores; the
// tensor cores (wgmma) and TMA are later work. Head dims that are not a
// multiple of 16 (SD's 40) are zero-padded in shared memory, not in the
// weights; the ragged key axis (cross-attention S = 77) is masked per column.
// delta is read from device memory, so the per-step time-aware slot costs no
// host synchronisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid: ty picks rows, tx keys/cols
constexpr int kBK = 64;        // keys per tile
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// The 16 threads that share a row group are one half-warp (tid = ty*16 + tx).
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [row0, row0 + nrows) of a (rows_valid, d) row-major matrix -> dst[nrows][DP + 4]
// as f32; rows past rows_valid and columns past d are zero.
template <typename T, int DP>
__device__ void load_tile(float* dst, const T* __restrict__ src, int row0, int nrows,
                          int rows_valid, int d) {
  constexpr int LD = DP + 4;
  for (int idx = threadIdx.x; idx < nrows * DP; idx += kThreads) {
    const int r = idx / DP, c = idx - (idx / DP) * DP;
    const int gr = row0 + r;
    float val = 0.f;
    if (gr < rows_valid && c < d) val = to_f32<T>(src[(size_t)gr * d + c]);
    dst[r * LD + c] = val;
  }
}

// s[i][j] = scale * <Q[ty*RM + i], K[tx + 16*j]>, -inf for keys past s_len.
template <int DP, int RM>
__device__ __forceinline__ void tile_scores(const float* Qs, const float* Ks, int ty, int tx,
                                            int key0, int s_len, float scale,
                                            float (&s)[RM][4]) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DP; d += 4) {
    float4 a[RM], b[4];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = *reinterpret_cast<const float4*>(Qs + (ty * RM + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool valid = key0 + tx + 16 * j < s_len;
#pragma unroll
    for (int i = 0; i < RM; ++i) s[i][j] = valid ? s[i][j] * scale : kNegInf;
  }
}

// acc[i][c] += sum_k P[ty*RM + i][k] * V[k][tx + 16*c]
template <int DP, int RM>
__device__ __forceinline__ void tile_pv(const float* Ps, const float* Vs, int ty, int tx,
                                        float (&acc)[RM][DP / 16]) {
  constexpr int LD = DP + 4, LDP = kBK + 4, NC = DP / 16;
#pragma unroll 2
  for (int kk = 0; kk < kBK; kk += 4) {
    float4 p[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) p[i] = *reinterpret_cast<const float4*>(Ps + (ty * RM + i) * LDP + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[(kk + u) * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float pu = comp(p[i], u);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pu, vv[c], acc[i][c]);
      }
    }
  }
}

// QUANT = false: K2 (flash). QUANT = true: K1 (uniform softmax quantization).
template <typename T, int DP, int RM, bool QUANT>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int t_len, int s_len, int d, float scale,
                 const float* __restrict__ delta_ptr, float max_code) {
  constexpr int BQ = 16 * RM, LD = DP + 4, LDP = kBK + 4, NC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [BQ][LD]
  float* KVs = Qs + BQ * LD;    // [kBK][LD], K then V of the current tile
  float* Ps = KVs + kBK * LD;   // [BQ][LDP]

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* qb = q + (size_t)bh * t_len * d;
  const T* kb = k + (size_t)bh * s_len * d;
  const T* vb = v + (size_t)bh * s_len * d;
  T* ob = o + (size_t)bh * t_len * d;

  load_tile<T, DP>(Qs, qb, q0, BQ, t_len, d);

  float m[RM], l[RM], acc[RM][NC], s[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int n_tiles = (s_len + kBK - 1) / kBK;

  if (QUANT) {
    // pass 1: exact row max m and normalizer l (online over key tiles)
    for (int kt = 0; kt < n_tiles; ++kt) {
      __syncthreads();
      load_tile<T, DP>(KVs, kb, kt * kBK, kBK, s_len, d);
      __syncthreads();
      tile_scores<DP, RM>(Qs, KVs, ty, tx, kt * kBK, s_len, scale, s);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
        const float m_new = fmaxf(m[i], group_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - m_new);
        l[i] = l[i] * expf(m[i] - m_new) + group_sum(sum);
        m[i] = m_new;
      }
    }
  }

  const float delta = QUANT ? *delta_ptr : 1.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    load_tile<T, DP>(KVs, kb, kt * kBK, kBK, s_len, d);
    __syncthreads();
    tile_scores<DP, RM>(Qs, KVs, ty, tx, kt * kBK, s_len, scale, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float* prow = Ps + (ty * RM + i) * LDP;
      if (QUANT) {
        // the final probability, quantized exactly as the plain version does
        // it: clip(round_half_even(p / delta), 0, 2^b - 1); masked keys give 0
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - m[i]) / l[i];
          prow[tx + 16 * j] = fminf(rintf(p / delta), max_code);
        }
      } else {
        float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
        const float m_new = fmaxf(m[i], group_max(mx));
        const float corr = expf(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - m_new);
          prow[tx + 16 * j] = p;
          sum += p;
        }
        l[i] = l[i] * corr + group_sum(sum);
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
      }
    }
    __syncthreads();  // every thread is done with K before V overwrites it
    load_tile<T, DP>(KVs, vb, kt * kBK, kBK, s_len, d);
    __syncthreads();
    tile_pv<DP, RM>(Ps, KVs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= t_len) continue;
    const float f = QUANT ? delta : 1.f / l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) ob[(size_t)row * d + col] = from_f32<T>(acc[i][c] * f);
    }
  }
}

template <typename T, int DP, int RM, bool QUANT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int t_len,
                   int s_len, int d, float scale, const float* delta, float max_code,
                   cudaStream_t stream) {
  constexpr int BQ = 16 * RM;
  const size_t smem = sizeof(float) * (BQ * (DP + 4) + kBK * (DP + 4) + BQ * (kBK + 4));
  auto kernel = attention_kernel<T, DP, RM, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + BQ - 1) / BQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), t_len,
                                           s_len, d, scale, delta, max_code);
  return cudaGetLastError();
}

// Head-dim tiers: SD's 40 -> 48, 80, 160; the VAE's 512 (RM = 2 keeps the
// (32, 512) accumulator in registers and the tiles within 227 KB).
template <typename T, bool QUANT>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh, int t_len,
             int s_len, int d, float scale, const float* delta, float max_code,
             cudaStream_t stream) {
  if (bh < 1 || bh > 65535 || t_len < 1 || s_len < 1 || d < 1) return cudaErrorInvalidValue;
  if (d <= 48) return launch<T, 48, 4, QUANT>(q, k, v, o, bh, t_len, s_len, d, scale, delta, max_code, stream);
  if (d <= 80) return launch<T, 80, 4, QUANT>(q, k, v, o, bh, t_len, s_len, d, scale, delta, max_code, stream);
  if (d <= 160) return launch<T, 160, 4, QUANT>(q, k, v, o, bh, t_len, s_len, d, scale, delta, max_code, stream);
  if (d <= 512) return launch<T, 512, 2, QUANT>(q, k, v, o, bh, t_len, s_len, d, scale, delta, max_code, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface (loaded with ctypes). q: (bh, t, d), k/v: (bh, s, d), o: (bh, t, d),
// all contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1). Returns a cudaError_t.
extern "C" int dgq_flash_attention(const void* q, const void* k, const void* v, void* o, int bh,
                                   int t_len, int s_len, int d, float scale, int is_bf16,
                                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16, false>(q, k, v, o, bh, t_len, s_len, d, scale, nullptr, 0.f, st)
                 : dispatch<float, false>(q, k, v, o, bh, t_len, s_len, d, scale, nullptr, 0.f, st);
}

// delta: device pointer to one f32; codes are clipped to 2^sm_bits - 1.
extern "C" int dgq_uniform_attention(const void* q, const void* k, const void* v, void* o,
                                     int bh, int t_len, int s_len, int d, float scale,
                                     const void* delta, int sm_bits, int is_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const float max_code = static_cast<float>((1 << sm_bits) - 1);
  const float* dp = static_cast<const float*>(delta);
  return is_bf16 ? dispatch<__nv_bfloat16, true>(q, k, v, o, bh, t_len, s_len, d, scale, dp, max_code, st)
                 : dispatch<float, true>(q, k, v, o, bh, t_len, s_len, d, scale, dp, max_code, st);
}
