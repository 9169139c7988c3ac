// Attention kernels for the SD v1.4 and SDXL deploy paths on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of dgq_tpu/ops/pallas/attention.py:
//   * K1 `_static_uniform_kernel` (mode kUniform): softmax attention with the
//     reference's uniform post-softmax quantizer (zero point 0, static delta):
//         P = softmax(Q K^T * scale);  code = min(round(P / delta), 2^b - 1);
//         out = delta * (code @ V)
//     Every UNet self- and cross-attention of the g=1 policy runs it.
//   * K2 `_flash_kernel` (kFlash): unquantized online-softmax flash attention
//     (the VAE mid-block attention, head_dim 512, and the fp UNet path).
//   * K3 `_rt_fused_kernel`, as its two-launch form K3b (`_stats_kernel`,
//     `_stats_kernel_nonpeak`, `_accum_kernel`): the log2 quantizer whose
//     delta is reduced over the whole call. The TPU runs its grid in order, so
//     one call can finish every row's statistics before it quantizes; blocks
//     here run in no order, so it is two launches. `rt_stats` (kStats) finds
//     each row's max m and normalizer l, writes z = m + ln(l), and folds
//     min(l), or under start_peak max(exp(m2 - m) / l) with m2 the row max
//     outside key 0, into one scalar by an atomic on its bit pattern (both
//     are positive floats, so integer order is float order). `quant_accum`
//     (kAccum) reads delta from that scalar, recomputes Q K^T and forms
//         q = clamp(round(log2(delta) + (z - s) / ln 2), 0, ub),
//         ub = min(2^b - 1, exponent_field(delta) - 1),
//         p_q = bitcast(bits(delta) - (q << 23)) = 2^-q * delta
//     without exp or log; ub keeps the exponent subtraction from wrapping.
//     Under start_peak key column 0 keeps its exact exp(s - z).
//   * K4 `_static_quant_kernel` (kStatic): the same statistics and quantizer
//     in one launch with a static delta (`log2`), or uniform codes
//     round(p / delta) with start_peak.
//
// What bounds it on the H100. At the main path's shapes (T = S = 4096,
// head_dim 40..512) attention is bound by operations: Q K^T and P V are
// 4*T*S*D flops against (T + 2S)*D elements read. The TPU kernels cache the
// (rows, S) f32 exp or score blocks of pass 1 in VMEM so pass 2 needs no second
// Q K^T; that cache does not fit in the 227 KB of shared memory a block may use
// here, so K1 and K4 recompute Q K^T in pass 2 (as the TPU's `_accum_kernel`
// does) and pay 1.5x the flops of K2; K3b pays the same over its two launches.
//
// Five bodies.
//
// (a) The bf16 flash mode (K2, K2p) runs on the tensor cores
// (`flash_tc_kernel`, tile code in wgmma.cuh). A block of two warpgroups takes
// 128 query rows of one head, 64 a warpgroup. Q is copied once into swizzled
// shared memory; K and V tiles of 64 keys follow as bf16 through a ring of two
// buffers each, filled by `cp.async` (16-byte copies that write zeros for keys
// past S and lanes past d), so tile j+1 loads while tile j multiplies; up to
// head_dim 64 two blocks share an SM, and one's exponentials run under the
// other's multiplies. S = Q K^T is a `wgmma` with both operands in shared
// memory (K is K-major as it lies in memory) into f32 registers; the row max
// and sum are taken by shuffles within the four lanes that own a row; P is
// rounded to bf16 in registers and is the A operand of the P V `wgmma`, whose
// B operand is the V tile as it lies in memory (MN-major, no transpose); O is
// rescaled in registers and divided by l at the end. The contraction is padded
// to a multiple of 16 and the P V width to a multiple of 64 in shared memory
// (40 -> 48 and 64), never in the weights. At head_dim 512 (the VAE) a 64 x 512
// f32 accumulator is 256 registers a thread for one warpgroup, so there the
// two warpgroups share 64 query rows and each holds 256 of O's columns; both
// compute the whole of S (Q K^T twice, 1.5x the flops, chosen over an exchange
// of P through shared memory for having no barrier inside a tile), and the
// tile is 32 keys so that Q (64 KB) and two stages of K and V (128 KB) fit.
// The copies are `cp.async`, not TMA: a tensor map would have to be encoded on
// the host for every call (q, k and v are fresh tensors each time; what that
// costs has not been measured), on paths whose steps the host already bounds,
// and SD's 40-wide heads would need its out-of-bounds fill for the lanes past
// d. What this leaves on the table: every thread starts copies and waits at a
// block-wide barrier each tile, and a warpgroup's two multiplies and its
// softmax run one after the other, so the tensor cores are busy about a third
// of the time; TMA with `mbarrier`s, a producer warp and warpgroups that take
// turns is the step still open. Taking a quarter of the tile loop's work away
// (the ragged-key mask behind a branch, no O rescale where no row maximum
// moved) changed no time: the loop waits, it is not short of cycles. A view
// whose addresses are not multiples of 16 bytes (or whose head_dim is no
// multiple of 8) cannot take 16-byte copies: the same kernel then fills the
// same tiles with element loads and ordinary stores (`ASYNC = false`), and
// returns the same bits.
//
// (c) The bf16 quantizing modes K1, K3b and K4 (with K1p, K3p, K4p) at
// head_dim <= 192 run `quant_tc_kernel` on the same tile code: one template
// over the mode, whose note below says what each mode computes and what bounds
// it.
//
// (d) The f32 flash mode (K2, K2p) runs on the tensor cores too, each f32
// product formed from three TF32 products (`flash_tf32_kernel`, whose note
// says how).
//
// (e) The f32 quantizing modes K1, K3b and K4 (with K1p, K3p, K4p) at
// head_dim <= 160 run on body (d)'s step machinery (`quant_tf32_kernel`): Q K^T
// as three TF32 products, P V as two, since a quantized probability is one
// TF32 number exactly.
//
// (b) The f32 quantizing modes past head_dim 160 or with uniform codes past
// 2048, and K1 in bf16 past head_dim 192 (the VAE's 512) or with codes past
// 256, keep the first version's body, f32 FMAs on the CUDA cores (the f32
// flash and quantizing entries keep it as form 0 for timing as well):
// one block of 256 threads per (batch*head, 16*RM query rows), Q in shared
// memory, K and V tiles of 64 keys through one shared buffer as f32, each
// thread owning RM query rows x 4 keys of a score tile and RM rows x DP/16
// columns of the output. Head dims that are not a multiple of 16 (SD's 40) are
// zero-padded in shared memory, not in the weights; the ragged key axis
// (cross-attention S = 77) is masked per column. Every delta is read from
// device memory, so neither the per-step time-aware slot nor the real-time
// reduction costs a host synchronisation.
//
// The packed head-slot entries (K1p to K4p: `_fused_attention_packed`, which
// runs the same four TPU bodies with `sub_heads` over (B, T, H*dp) arrays) are
// the same kernels under another `Layout`. What the TPU cuts with a BlockSpec
// lane index (cell j -> batch j / H, slot j % H) is address arithmetic here:
// block (tile, b*H + h) finds row r of head h at
// base + b*batch_stride + r*row_stride + h*slot, so q, k and v are read where
// the projections wrote them and the output is written where `to_out.0` reads
// it, with no transposed copy on either side. Only the d true lanes of a slot
// are loaded and contracted (the folded weights leave the other lanes exact
// zeros, so the sums are the unpacked kernel's bit for bit); the kernel writes
// zeros into lanes d..slot of its output, because `to_out.0` multiplies them
// by zero weights and the buffer comes uninitialised. The TPU's pair mode (two
// 64-wide heads per 128-lane block) is a lane matter with no counterpart: a
// block takes one head whatever its slot.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid: ty picks rows, tx keys/cols
constexpr int kBK = 64;        // keys per tile
constexpr float kNegInf = -1e30f;

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

// rows [row0, row0 + nrows) of a (rows_valid, d) matrix whose rows lie `stride`
// elements apart -> dst[nrows][DP + 4] as f32; rows past rows_valid and columns
// past d are zero.
template <typename T, int DP>
__device__ void load_tile(float* dst, const T* __restrict__ src, long long stride, int row0,
                          int nrows, int rows_valid, int d) {
  constexpr int LD = DP + 4;
  for (int idx = threadIdx.x; idx < nrows * DP; idx += kThreads) {
    const int r = idx / DP, c = idx - (idx / DP) * DP;
    const int gr = row0 + r;
    float val = 0.f;
    if (gr < rows_valid && c < d) val = to_f32<T>(src[gr * stride + c]);
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

enum Mode : int { kFlash = 0, kUniform = 1, kStats = 2, kAccum = 3, kStatic = 4 };

// What the quantizing modes need beyond q, k, v, o.
struct Extra {
  const float* delta;  // kUniform, kStatic: the static delta (one f32 on the device)
  float max_code;      // 2^bits - 1
  float* z;            // (bh, t) row constants m + ln(l): kStats writes, kAccum reads
  int* red;            // the call's reduction scalar (f32 bits): kStats folds, kAccum reads
  int start_peak;      // key column 0 stays unquantized; kStats reduces the non-peak max
  int uniform;         // kStatic: uniform codes instead of log2
};

// Where block y = b * heads + h finds its head: tensor x's rows start at
// x + b * x_batch + h * slot and lie x_row elements apart. The classic layout
// (BH, T, D) is heads = 1 with rows d apart; the packed one (B, T, H * slot) has
// rows H * slot apart. The output's lanes d..o_cols are written as zeros.
struct Layout {
  int heads, slot, o_cols;
  long long q_batch, q_row, k_batch, k_row, v_batch, v_row, o_batch, o_row;
};

Layout classic_layout(int t_len, int s_len, int d) {
  const long long td = (long long)t_len * d, sd = (long long)s_len * d;
  return Layout{1, 0, d, td, d, sd, d, sd, d, td, d};
}

// strides: the eight batch and row strides in Layout's order, in elements
Layout packed_layout(int heads, int slot, const long long* strides) {
  return Layout{heads, slot, slot, strides[0], strides[1], strides[2], strides[3],
                strides[4], strides[5], strides[6], strides[7]};
}

constexpr float kInvLn2 = 1.4426950408889634f;

// K4 (kStatic) carries both passes and the log2 row constants: it may take a
// whole SM's registers (one block) where the other modes fit two blocks' share.
template <typename T, int DP, int RM, int MODE>
__global__ void __launch_bounds__(kThreads, MODE == kStatic ? 1 : 2)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int t_len, int s_len, int d, float scale, Extra ex,
                 Layout lay) {
  constexpr int BQ = 16 * RM, LD = DP + 4, LDP = kBK + 4, NC = DP / 16;
  constexpr bool PASS1 = MODE == kUniform || MODE == kStats || MODE == kStatic;
  constexpr bool LOGQ = MODE == kAccum || MODE == kStatic;  // quantizers on z = m + ln(l)
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [BQ][LD]
  float* KVs = Qs + BQ * LD;    // [kBK][LD], K then V of the current tile
  float* Ps = KVs + kBK * LD;   // [BQ][LDP]

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int batch = bh / lay.heads, head_off = (bh - batch * lay.heads) * lay.slot;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* qb = q + batch * lay.q_batch + head_off;
  const T* kb = k + batch * lay.k_batch + head_off;

  load_tile<T, DP>(Qs, qb, lay.q_row, q0, BQ, t_len, d);

  float m[RM], l[RM], m2[RM], s[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    m2[i] = kNegInf;
    l[i] = 0.f;
  }
  const int n_tiles = (s_len + kBK - 1) / kBK;

  if (PASS1) {
    // pass 1: exact row max m and normalizer l (online over key tiles);
    // kStats under start_peak also m2, the row max outside key column 0
    for (int kt = 0; kt < n_tiles; ++kt) {
      __syncthreads();
      load_tile<T, DP>(KVs, kb, lay.k_row, kt * kBK, kBK, s_len, d);
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
        if (MODE == kStats && ex.start_peak) {
          float mx2 = kNegInf;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (kt * kBK + tx + 16 * j != 0) mx2 = fmaxf(mx2, s[i][j]);
          m2[i] = fmaxf(m2[i], group_max(mx2));
        }
      }
    }
  }

  if (MODE == kStats) {
    // every lane of a row group holds the row's m, l, m2. Rows past t_len
    // (zero queries, l = s_len) must not reach the reduction.
    float red = ex.start_peak ? 0.f : __int_as_float(0x7f800000);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty * RM + i;
      if (row < t_len) {
        if (tx == 0) ex.z[(size_t)bh * t_len + row] = m[i] + logf(l[i]);
        red = ex.start_peak ? fmaxf(red, expf(m2[i] - m[i]) / l[i]) : fminf(red, l[i]);
      }
    }
    const float other = __shfl_xor_sync(0xffffffffu, red, 16);  // the warp's other row group
    red = ex.start_peak ? fmaxf(red, other) : fminf(red, other);
    if ((threadIdx.x & 31) == 0) {
      if (ex.start_peak) atomicMax(ex.red, __float_as_int(red));
      else atomicMin(ex.red, __float_as_int(red));
    }
    return;
  }

  const T* vb = v + batch * lay.v_batch + head_off;
  T* ob = o + batch * lay.o_batch + head_off;
  float acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  float delta = 1.f;
  if (MODE == kUniform || MODE == kStatic) delta = *ex.delta;
  if (MODE == kAccum) {
    const float r = __int_as_float(*ex.red);
    delta = ex.start_peak ? r : 1.f / r;
  }
  // log2 codes straight from the score: -log2(p / delta) is linear in s,
  // log2(delta) + (z - s) / ln 2, so q = round(a_row - s / ln 2)
  float zr[RM], a_row[RM];
  const int d_bits = __float_as_int(delta);
  const float ub = fminf(static_cast<float>((d_bits >> 23) - 1), ex.max_code);
  if (LOGQ) {
    const float log2d = log2f(delta);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty * RM + i;
      if (MODE == kStatic) zr[i] = m[i] + logf(l[i]);
      else zr[i] = row < t_len ? ex.z[(size_t)bh * t_len + row] : 0.f;
      a_row[i] = log2d + zr[i] * kInvLn2;
    }
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    load_tile<T, DP>(KVs, kb, lay.k_row, kt * kBK, kBK, s_len, d);
    __syncthreads();
    tile_scores<DP, RM>(Qs, KVs, ty, tx, kt * kBK, s_len, scale, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float* prow = Ps + (ty * RM + i) * LDP;
      if (MODE == kUniform) {
        // the final probability, quantized exactly as the plain version does
        // it: clip(round_half_even(p / delta), 0, 2^b - 1); masked keys give 0
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - m[i]) / l[i];
          prow[tx + 16 * j] = fminf(rintf(p / delta), ex.max_code);
        }
      } else if (LOGQ) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = kt * kBK + tx + 16 * j;
          float pq;
          if (MODE == kStatic && ex.uniform) {
            const float p = expf(s[i][j] - m[i]) / l[i];
            pq = fminf(rintf(p / delta), ex.max_code) * delta;
          } else {
            const float y = fminf(fmaxf(a_row[i] - s[i][j] * kInvLn2, 0.f), ub);
            pq = __int_as_float(d_bits - (__float2int_rn(y) << 23));
          }
          if (ex.start_peak && col == 0) pq = expf(s[i][j] - zr[i]);
          prow[tx + 16 * j] = col < s_len ? pq : 0.f;
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
    load_tile<T, DP>(KVs, vb, lay.v_row, kt * kBK, kBK, s_len, d);
    __syncthreads();
    tile_pv<DP, RM>(Ps, KVs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= t_len) continue;
    const float f = MODE == kUniform ? delta : (MODE == kFlash ? 1.f / l[i] : 1.f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) ob[row * lay.o_row + col] = from_f32<T>(acc[i][c] * f);
    }
    // a packed slot's padding lanes
    for (int col = d + tx; col < lay.o_cols; col += 16) ob[row * lay.o_row + col] = from_f32<T>(0.f);
  }
}

template <typename T, int DP, int RM, int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int t_len,
                   int s_len, int d, float scale, const Extra& ex, const Layout& lay,
                   cudaStream_t stream) {
  constexpr int BQ = 16 * RM;
  const size_t smem = sizeof(float) * (BQ * (DP + 4) + kBK * (DP + 4) + BQ * (kBK + 4));
  auto kernel = attention_kernel<T, DP, RM, MODE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + BQ - 1) / BQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), t_len,
                                           s_len, d, scale, ex, lay);
  return cudaGetLastError();
}

// Head-dim tiers: SD's 40 -> 48, 80, 160; SDXL's 64; the VAE's 512 (RM = 2 keeps the
// (32, 512) accumulator in registers and the tiles within 227 KB). Only K1
// and K2 are built for the 512 tier: the log2 / start_peak modes run in the
// UNet alone.
template <typename T, int MODE>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh, int t_len,
             int s_len, int d, float scale, const Extra& ex, const Layout& lay,
             cudaStream_t stream) {
  if (bh < 1 || bh > 65535 || t_len < 1 || s_len < 1 || d < 1) return cudaErrorInvalidValue;
  if (lay.heads < 1 || bh % lay.heads || lay.o_cols < d) return cudaErrorInvalidValue;
  if (d <= 48) return launch<T, 48, 4, MODE>(q, k, v, o, bh, t_len, s_len, d, scale, ex, lay, stream);
  if (d <= 64) return launch<T, 64, 4, MODE>(q, k, v, o, bh, t_len, s_len, d, scale, ex, lay, stream);
  if (d <= 80) return launch<T, 80, 4, MODE>(q, k, v, o, bh, t_len, s_len, d, scale, ex, lay, stream);
  if (d <= 160) return launch<T, 160, 4, MODE>(q, k, v, o, bh, t_len, s_len, d, scale, ex, lay, stream);
  if constexpr (MODE == kFlash || MODE == kUniform) {
    if (d <= 512) return launch<T, 512, 2, MODE>(q, k, v, o, bh, t_len, s_len, d, scale, ex, lay, stream);
  }
  return cudaErrorInvalidValue;
}

// ---- (a) flash attention on the tensor cores, bf16 ----

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 256;  // two warpgroups
constexpr float kLog2e = 1.4426950408889634f;

// The `nvalid` (0..8) leading elements of the 16-byte chunk at src go to shared
// memory at dst, zeros behind them. ASYNC takes whole chunks only (nvalid 0 or 8).
template <bool ASYNC>
__device__ __forceinline__ void copy_chunk(uint32_t dst, const bf16* src, int nvalid) {
  if constexpr (ASYNC) {
    tc::cp_async16(dst, src, nvalid == 8);
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < nvalid)
        w[e >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(src[e])) << (16 * (e & 1));
    tc::st_shared16(dst, make_uint4(w[0], w[1], w[2], w[3]));
  }
}

// Rows [row0, row0 + ROWS) and columns [0, 64 NC) of a matrix whose rows lie
// `stride` elements apart -> swizzled sub-tiles at dst, sub-tile (row / 64, c)
// holding columns 64 c..; rows past rows_valid and columns past d are zeros.
// Thread t copies chunk t % 8 of rows t / 8 + 32 rr: every address is the
// thread's first plus a constant (the swizzle repeats every 8 rows).
template <int NC, int ROWS, bool ASYNC>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* __restrict__ src,
                                          long long stride, int row0, int rows_valid, int d) {
  static_assert(ROWS % 32 == 0, "32 rows per pass of 256 threads");
  constexpr int SUBR = ROWS > 64 ? 64 : ROWS;
  const int cc = threadIdx.x & 7, r0 = row0 + (threadIdx.x >> 3);
  const uint32_t dst0 = dst + tc::swz(threadIdx.x >> 3, cc);
  const bf16* src0 = src + r0 * stride + cc * 8;
  const int dcol = d - cc * 8;  // valid elements from this chunk's column on, in sub-tile 0
#pragma unroll
  for (int rr = 0; rr < ROWS / 32; ++rr) {
    const bool row_ok = r0 + 32 * rr < rows_valid;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int nvalid = row_ok ? min(8, max(0, dcol - 64 * c)) : 0;
      const bf16* p = nvalid > 0 ? src0 + 32 * rr * stride + 64 * c : src;
      copy_chunk<ASYNC>(dst0 + ((32 * rr / SUBR) * NC + c) * (SUBR * 128) + (32 * rr % SUBR) * 128,
                        p, nvalid);
    }
  }
}

// 2^x by the special-function unit; results below 2^-126 are 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [row0, row0 + BK) of a K or V tile -> swizzled sub-tiles at buf, sub-tile
// c holding lanes 64 c..; thread (lr, cc) copies chunk cc of rows lr + 32 i from
// p, its chunk of row row0 + lr. Keys past s_len and lanes past d are zeros,
// read from nowhere (`safe` stands in for their address).
template <int NC, int BK, bool ASYNC>
__device__ __forceinline__ void copy_tile(uint32_t buf, uint32_t ld_dst, const bf16* p,
                                          const bf16* safe, long long stride, int row0, int lr,
                                          int cc, int s_len, int d) {
#pragma unroll
  for (int r = 0; r < BK; r += 32) {
    const bool row_ok = row0 + lr + r < s_len;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int nvalid = row_ok ? min(8, max(0, d - cc * 8 - 64 * c)) : 0;
      copy_chunk<ASYNC>(buf + ld_dst + c * (BK * 128) + r * 128,
                        nvalid > 0 ? p + r * stride + 64 * c : safe, nvalid);
    }
  }
}

// Outputs (row, col) and (row, col + 1), within t_len rows and d lanes; one
// 4-byte store where `o_vec` says every pair is aligned.
__device__ __forceinline__ void store_pair(bf16* ob, long long o_row, int row, int col, float a,
                                           float b, int t_len, int d, int o_vec) {
  if (row >= t_len || col >= d) return;
  bf16* dst = ob + row * o_row + col;
  if (o_vec && col + 1 < d) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
  } else {
    dst[0] = __float2bfloat16(a);
    if (col + 1 < d) dst[1] = __float2bfloat16(b);
  }
}

// The same for f32 outputs, one 8-byte store where `o_vec` says so.
__device__ __forceinline__ void store_pair(float* ob, long long o_row, int row, int col, float a,
                                           float b, int t_len, int d, int o_vec) {
  if (row >= t_len || col >= d) return;
  float* dst = ob + row * o_row + col;
  if (o_vec && col + 1 < d) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  } else {
    dst[0] = a;
    if (col + 1 < d) dst[1] = b;
  }
}

// Zeros into a packed slot's padding lanes d..o_cols of rows r0 and r1 (the
// four lanes t4 of a row share them).
template <typename T>
__device__ __forceinline__ void zero_pad_lanes(T* ob, const Layout& lay, int r0, int r1,
                                               int t_len, int d, int t4) {
  for (int col = d + t4; col < lay.o_cols; col += 4) {
    if (r0 < t_len) ob[r0 * lay.o_row + col] = from_f32<T>(0.f);
    if (r1 < t_len) ob[r1 * lay.o_row + col] = from_f32<T>(0.f);
  }
}

// Starts S (64 x BK, f32 fragments) = Q K^T over the first NKS steps of 16 lanes
// and commits the group without waiting: Q sub-tiles at q_s, K sub-tiles at k_s,
// both K-major. S may not be touched before `mma_wait` and `pin`. (No branch
// may stand between the multiplies of a group: the compiler would fence each.)
template <int NKS, int BK>
__device__ __forceinline__ void tile_qk(float (&s)[BK / 2], uint32_t q_s, uint32_t k_s) {
  tc::mma_fence();
#pragma unroll
  for (int kk = 0; kk < NKS; ++kk) {
    const uint64_t da = tc::desc(q_s + (kk / 4) * 8192 + (kk % 4) * 32);
    const uint64_t db = tc::desc(k_s + (kk / 4) * (BK * 128) + (kk % 4) * 32);
    if constexpr (BK == 64) tc::mma_ss_n64<0>(s, da, db, kk > 0);
    else tc::mma_ss_n32(s, da, db, kk > 0);
  }
  tc::mma_commit();
}

// Starts O (64 x 64 NCB) += P V and commits: P as bf16 A fragments in registers
// (BK / 16 steps of 16 keys), V column blocks of 64 at v_s, MN-major as they
// lie in memory.
template <int NCB, int BK>
__device__ __forceinline__ void tile_pv(float (&o)[NCB][32], uint32_t (&p)[BK / 16][4],
                                        uint32_t v_s) {
  tc::mma_fence();
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
      tc::mma_rs_n64(o[cb], p[ks], tc::desc(v_s + cb * (BK * 128) + ks * 2048));
  tc::mma_commit();
}

// NC: 64-lane chunks of the head dim; NKS: steps of 16 lanes the contraction
// takes (ceil(d / 16), or more: the lanes past d are zeros in shared memory);
// BK: keys per tile; SPLIT: the two warpgroups share 64 query rows and halve
// O's columns (head_dim 512); ASYNC: tiles filled by cp.async, else by element
// loads.
template <int NC, int NKS, int BK, bool SPLIT, bool ASYNC>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int t_len, int s_len, int d,
                float scale_log2, Layout lay, int o_vec) {
  constexpr int BQ = SPLIT ? 64 : 128;
  constexpr int NCB = SPLIT ? NC / 2 : NC;  // O column blocks a warpgroup holds
  constexpr int KV_BYTES = NC * BK * 128;   // one K or one V tile
  constexpr int STAGE = 2 * KV_BYTES;
  constexpr int NS = BK / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (tc::smem_u32(smem_raw) + 1023u) & ~1023u;  // [BQ / 64][NC] sub-tiles
  const uint32_t ring = q_s + BQ * NC * 128;                       // 2 stages of K, V tiles

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int batch = bh / lay.heads, head_off = (bh - batch * lay.heads) * lay.slot;
  const bf16* qb = q + batch * lay.q_batch + head_off;
  const bf16* kb = k + batch * lay.k_batch + head_off;
  const bf16* vb = v + batch * lay.v_batch + head_off;
  bf16* ob = o + batch * lay.o_batch + head_off;
  const int n_tiles = (s_len + BK - 1) / BK;
  const int wrow = SPLIT ? 0 : wg;       // this warpgroup's 64-row group of Q
  const int cb0 = SPLIT ? wg * NCB : 0;  // its first column block of O

  // K tile j and V tile j live in buffer j & 1 of their kind. Iteration j
  // multiplies Q K(j)^T first and P V(j) last, so at its top K(j - 1) and
  // V(j - 1) are consumed: it loads K(j + 1) over the one and V(j + 1) over
  // the other, a whole iteration ahead of their use. Thread t copies chunk
  // t % 8 of rows t / 8 + 32 i of every tile; its two source pointers
  // move on a tile at a time, which keeps the address arithmetic out of the loop.
  const int cc = tid & 7, lr = tid >> 3;
  const uint32_t ld_dst = tc::swz(lr, cc);
  const bf16* kp = kb + lr * lay.k_row + cc * 8;
  const bf16* vp = vb + lr * lay.v_row + cc * 8;
  auto load_kv = [&](int tile) {
    const uint32_t buf = ring + (tile & 1) * STAGE;
    copy_tile<NC, BK, ASYNC>(buf, ld_dst, kp, kb, lay.k_row, tile * BK, lr, cc, s_len, d);
    copy_tile<NC, BK, ASYNC>(buf + KV_BYTES, ld_dst, vp, vb, lay.v_row, tile * BK, lr, cc, s_len,
                             d);
    kp += BK * lay.k_row;
    vp += BK * lay.v_row;
  };
  load_rows<NC, BQ, ASYNC>(q_s, qb, lay.q_row, q0, t_len, d);
  load_kv(0);
  tc::cp_async_commit();

  float oacc[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[cb][i] = 0.f;
  // the row statistics, m in units of the raw score; row 0 is 16 warp + g, row
  // 1 eight below
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const uint32_t q_w = q_s + wrow * NC * 8192;

  for (int j = 0; j < n_tiles; ++j) {
    tc::cp_async_wait<0>();   // K(j) and V(j) (and Q) have landed
    tc::fence_async_proxy();
    __syncthreads();          // ... for every thread, and iteration j - 1 is over
    if (j + 1 < n_tiles) load_kv(j + 1);  // in flight during the products
    tc::cp_async_commit();
    const uint32_t st = ring + (j & 1) * STAGE;

    float s[NS];
    tile_qk<NKS, BK>(s, q_w, st);
    tc::mma_wait<0>();
    tc::pin(s);

    // online softmax in base 2: p = 2^(scale_log2 (s - m)), one FMA and one
    // ex2 an element (scale_log2 > 0, so the largest raw score is the row max)
    const int key0 = j * BK;
    const bool ragged = key0 + BK > s_len;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int key = key0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (ragged && key >= s_len) s[i] = kNegInf;
      if (i & 2) mx1 = fmaxf(mx1, s[i]);
      else mx0 = fmaxf(mx0, s[i]);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = ex2((m0 - mn0) * scale_log2), corr1 = ex2((m1 - mn1) * scale_log2);
    const float off0 = -mn0 * scale_log2, off1 = -mn1 * scale_log2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      s[i] = ex2(fmaf(s[i], scale_log2, (i & 2) ? off1 : off0));
      if (i & 2) sum1 += s[i];
      else sum0 += s[i];
    }
    l0 = l0 * corr0 + sum0;  // each lane's share of the row; joined at the end
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[cb][i] *= (i & 2) ? corr1 : corr0;
    // P rounded to bf16 where it sits: two neighbouring 8-key blocks of S are
    // one A fragment of 16 keys
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[ks][r] = tc::pack_bf16(s[8 * ks + 2 * r], s[8 * ks + 2 * r + 1]);
    tile_pv<NCB, BK>(oacc, p, st + KV_BYTES + cb0 * (BK * 128));
    tc::mma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) tc::pin(oacc[cb]);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) tc::pin(p[ks]);
  }

  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
  const int r0 = q0 + wrow * 64 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      const int col = (cb0 + cb) * 64 + 8 * jb + 2 * t4;
      store_pair(ob, lay.o_row, r0, col, oacc[cb][4 * jb] * inv0, oacc[cb][4 * jb + 1] * inv0,
                 t_len, d, o_vec);
      store_pair(ob, lay.o_row, r1, col, oacc[cb][4 * jb + 2] * inv1,
                 oacc[cb][4 * jb + 3] * inv1, t_len, d, o_vec);
    }
  if (!SPLIT || wg == 0) zero_pad_lanes(ob, lay, r0, r1, t_len, d, t4);
}

template <int NC, int NKS, int BK, bool SPLIT, bool ASYNC>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int bh, int t_len,
                      int s_len, int d, float scale, const Layout& lay, int o_vec,
                      cudaStream_t stream) {
  constexpr int BQ = SPLIT ? 64 : 128;
  const int smem = 1024 + BQ * NC * 128 + 2 * 2 * NC * BK * 128;
  auto kernel = flash_tc_kernel<NC, NKS, BK, SPLIT, ASYNC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + BQ - 1) / BQ, bh);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), t_len, s_len, d, scale * kLog2e, lay, o_vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether the tensor-core bodies may fill their tiles by cp.async: every row of
// q, k and v starts on a 16-byte boundary and head_dim is a multiple of 8.
bool async_ok(const void* q, const void* k, const void* v, int d, const Layout& lay) {
  const long long strides[] = {lay.q_batch, lay.q_row, lay.k_batch, lay.k_row, lay.v_batch,
                               lay.v_row, lay.slot};
  for (long long st : strides)
    if (st % 8) return false;
  return d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
}

// pairs of outputs go out as one 4-byte store where every pair is aligned
int out_vec(const void* o, const Layout& lay) {
  return reinterpret_cast<uintptr_t>(o) % 4 == 0 && lay.o_batch % 2 == 0 && lay.o_row % 2 == 0 &&
         lay.slot % 2 == 0;
}

// form 1: tiles by cp.async, which needs `async_ok` (the wrapper chose it from
// the same facts; a mismatch is refused, not repaired). form 2: element loads.
template <bool ASYNC>
int dispatch_tc(const void* q, const void* k, const void* v, void* o, int bh, int t_len,
                int s_len, int d, float scale, const Layout& lay, cudaStream_t stream) {
  if (bh < 1 || bh > 65535 || t_len < 1 || s_len < 1 || d < 1 || d > 512 || !(scale > 0.f))
    return cudaErrorInvalidValue;
  if (lay.heads < 1 || bh % lay.heads || lay.o_cols < d) return cudaErrorInvalidValue;
  if (ASYNC && !async_ok(q, k, v, d, lay)) return cudaErrorInvalidValue;
  const int o_vec = out_vec(o, lay);
  // the main paths' head dims get the exact number of contraction steps, any
  // other the whole tier's
#define DGQ_TC(NC, NKS, BK, SPLIT) \
  return launch_tc<NC, NKS, BK, SPLIT, ASYNC>(q, k, v, o, bh, t_len, s_len, d, scale, lay, o_vec, stream)
  const int nks = (d + 15) / 16;
  if (d <= 64) {
    if (nks == 3) DGQ_TC(1, 3, 64, false);
    DGQ_TC(1, 4, 64, false);
  }
  if (d <= 128) {
    if (nks == 5) DGQ_TC(2, 5, 64, false);
    DGQ_TC(2, 8, 64, false);
  }
  if (d <= 192) {
    if (nks == 10) DGQ_TC(3, 10, 64, false);
    DGQ_TC(3, 12, 64, false);
  }
  DGQ_TC(8, 32, 32, true);
#undef DGQ_TC
}

// Pass 1 of the quantizing modes on the tensor cores (bodies (c) and (e)):
// each lane's share of the statistics of rows r0 = 16 warp + g and r1 = r0 + 8,
// m the raw-score max, l = sum 2^(scale_log2 (s - m)), m2 the raw max outside
// key 0 (rt_stats under start_peak), from the S fragments of 64-key tiles.
struct RowStats {
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, m20 = kNegInf, m21 = kNegInf;

  // S of the keys [key0, key0 + 64); keys past s_len are masked out
  __device__ __forceinline__ void add(float (&s)[32], int key0, int s_len, int t4,
                                      float scale_log2, bool with_m2) {
    if (key0 + 64 > s_len) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (key0 + 8 * (i >> 2) + 2 * t4 + (i & 1) >= s_len) s[i] = kNegInf;
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, s[i]);
      else mx0 = fmaxf(mx0, s[i]);
    }
    const float tm0 = quad_max(mx0), tm1 = quad_max(mx1);
    if (with_m2) {
      if (key0 == 0) {  // key 0 is s[0] (row r0) and s[2] (row r1) of lane t4 = 0
        float a0 = kNegInf, a1 = kNegInf;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (t4 == 0 && (i == 0 || i == 2)) continue;
          if (i & 2) a1 = fmaxf(a1, s[i]);
          else a0 = fmaxf(a0, s[i]);
        }
        m20 = quad_max(a0);
        m21 = quad_max(a1);
      } else {
        m20 = fmaxf(m20, tm0);
        m21 = fmaxf(m21, tm1);
      }
    }
    const float mn0 = fmaxf(m0, tm0), mn1 = fmaxf(m1, tm1);
    const float off0 = -mn0 * scale_log2, off1 = -mn1 * scale_log2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float e = ex2(fmaf(s[i], scale_log2, (i & 2) ? off1 : off0));
      if (i & 2) sum1 += e;
      else sum0 += e;
    }
    l0 = l0 * ex2((m0 - mn0) * scale_log2) + sum0;
    l1 = l1 * ex2((m1 - mn1) * scale_log2) + sum1;
    m0 = mn0;
    m1 = mn1;
  }

  // after the last tile: each row's l, summed over its four lanes
  __device__ __forceinline__ void finish() {
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
  }

  // rt_stats' output: z = scale m + ln l per valid row (lane t4 = 0 writes); the
  // warp's rows fold into one value (min l, or under start_peak max exp(scale
  // (m2 - m)) / l) and one lane folds it into the call's scalar. Rows past
  // t_len (zero queries) stay out of both.
  __device__ __forceinline__ void write(const Extra& ex, int bh, int t_len, int r0, int r1,
                                        int lane, float scale) const {
    const bool v0 = r0 < t_len, v1 = r1 < t_len, sp = ex.start_peak != 0;
    if ((lane & 3) == 0) {
      if (v0) ex.z[(size_t)bh * t_len + r0] = fmaf(m0, scale, logf(l0));
      if (v1) ex.z[(size_t)bh * t_len + r1] = fmaf(m1, scale, logf(l1));
    }
    float red = sp ? 0.f : __int_as_float(0x7f800000);
    if (sp) {
      if (v0) red = fmaxf(red, expf((m20 - m0) * scale) / l0);
      if (v1) red = fmaxf(red, expf((m21 - m1) * scale) / l1);
    } else {
      if (v0) red = fminf(red, l0);
      if (v1) red = fminf(red, l1);
    }
#pragma unroll
    for (int sh = 4; sh < 32; sh <<= 1) {
      const float other = __shfl_xor_sync(0xffffffffu, red, sh);
      red = sp ? fmaxf(red, other) : fminf(red, other);
    }
    if (lane == 0) {
      if (sp) atomicMax(ex.red, __float_as_int(red));
      else atomicMin(ex.red, __float_as_int(red));
    }
  }
};

// ---- (c) the quantizing modes K1, K3b, K4 on the tensor cores, bf16 ----
//
// What they compute, and what that asks of the card. All three recompute
// S = Q K^T with `tile_qk` over the same swizzled tiles in the same order as
// the flash body, so every launch sees S to the bit.
//   * `rt_stats` (kStats) is Q K^T and one exponential an element: m and l
//     online in base 2 (raw-score max, scale_log2 > 0), m2 under start_peak,
//     then z = scale m + ln l and the call's scalar. Its ring holds K tiles
//     alone (no V), and no O lives in registers, so two blocks share an SM and
//     one's exponentials run under the other's multiplies.
//   * `quant_accum` (kAccum) takes no exponential: y = clamp(a_row - s
//     scale_log2, 0, ub) with a_row = log2(delta) + z / ln 2 is one FMA and a
//     clamp, q = round(y) the add of 1.5 2^23, and the A fragment of P V is
//     2^-q as bf16, bits (127 - q) << 7, formed by one integer multiply-add
//     from the rounded float's bits. ub <= exponent_field(delta) - 1 <= 126,
//     so 2^-q is a normal number and every product 2^-q v is exact; delta is
//     applied once to the f32 accumulator at the end (the TPU kernel instead
//     feeds bf16(delta 2^-q), which costs up to 2^-9 a product). Under
//     start_peak key 0 must carry its unquantized exp(s0 - z): its A element
//     is zeroed and exp(s0 - z) V[0, :] is added to the accumulator's rows in
//     f32 after the loop, a rank-1 update. That keeps the largest probability
//     of a row exact, where feeding bf16(p0 / delta) as the TPU kernel does
//     would round it to 8 bits.
//   * K1 (kUniform) runs rt_stats' loop without the reduction (pass 1), then
//     recomputes Q K^T (the TPU kernel's (rows, S) exp cache does not fit in
//     shared memory) and forms code = min(rint(2^(s c - (m c + log2(l delta)))),
//     2^b - 1), c = scale log2 e, one FMA and one exponential an element
//     (pass 2). A code is an integer <= 256, exact in bf16, and is the A
//     fragment of P V; the output is delta acc, as the TPU kernel hoists delta.
//   * K4 (kStatic) is K1's pass 1 and a pass 2 with a static delta read from
//     device memory. `log2`: quant_accum's quantizer, its row constant
//     c = z / ln 2 + log2 delta formed in registers from pass 1's m and l
//     (z = scale m + ln l, as rt_stats would write it), ub = min(
//     exponent_field(delta) - 1, 2^b - 1, 126). The 126 keeps 2^-q a normal
//     bf16; body (b), f32, caps at exponent_field(delta) - 1 alone, so the
//     two differ only for delta >= 2, and only for probabilities under
//     delta 2^-126 (log_max_1 gives delta 1 and calibrated deltas are <= 1).
//     `uniform` (with start_peak): K1's codes. Under start_peak both forms
//     take key 0 by the rank-1 update, as quant_accum does. Since y is formed
//     from register m and l, a bin can flip at a half-integer differently
//     than in body (b): the same share bound as K3b holds it.
// Keys past S: their K rows are zeros in shared memory, so pass 1 masks them
// out of m, l and m2; their V rows are zeros too, so in pass 2 any finite A
// element gives them exactly 0. Rows past T (zero queries) are kept out of z
// and of the call's scalar.
// What bounds them: the exponent unit, not the tensor cores. At SD 64px self
// (BH 32, T = S = 4096) one pass is 5.4e8 exponentials, about 0.13 ms at 16 a
// clock on each of 132 SMs; rt_stats takes one pass, K1 and K4 two; the log2
// quantizer is some five CUDA-core operations an element (about 0.09 ms).
template <int MODE, int NC, int NKS, bool ASYNC>
__global__ void __launch_bounds__(kTcThreads, MODE == kStats ? 2 : 1)
quant_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int t_len, int s_len, int d,
                float scale, float scale_log2, Extra ex, Layout lay, int o_vec) {
  constexpr int BQ = 128, BK = 64, NS = BK / 2;
  constexpr bool PASS1 = MODE != kAccum;  // the row statistics m, l
  constexpr bool PASS2 = MODE != kStats;  // quantize and P V
  constexpr int KV_BYTES = NC * BK * 128;
  constexpr int STAGE = PASS2 ? 2 * KV_BYTES : KV_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (tc::smem_u32(smem_raw) + 1023u) & ~1023u;  // [2][NC] sub-tiles
  const uint32_t ring = q_s + BQ * NC * 128;                       // 2 stages

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int batch = bh / lay.heads, head_off = (bh - batch * lay.heads) * lay.slot;
  const bf16* qb = q + batch * lay.q_batch + head_off;
  const bf16* kb = k + batch * lay.k_batch + head_off;
  const int n_tiles = (s_len + BK - 1) / BK;
  // iterations [0, n1) are pass 1, [n1, total) pass 2, each over the key tiles
  const int n1 = PASS1 ? n_tiles : 0, total = n1 + (PASS2 ? n_tiles : 0);
  const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
  const bool sp = ex.start_peak != 0;

  // iteration it's K tile (and in pass 2 its V tile) go to buffer it & 1;
  // thread t copies chunk t % 8 of rows t / 8 + 32 i, through running pointers
  const int cc = tid & 7, lr = tid >> 3;
  const uint32_t ld_dst = tc::swz(lr, cc);
  const bf16* kp0 = kb + lr * lay.k_row + cc * 8;
  const bf16* kp = kp0;
  const bf16* vb = PASS2 ? v + batch * lay.v_batch + head_off : kb;
  const bf16* vp = PASS2 ? vb + lr * lay.v_row + cc * 8 : kb;
  auto load = [&](int it) {
    if (PASS1 && PASS2 && it == n1) kp = kp0;  // pass 2 starts again at key tile 0
    const int row0 = (it < n1 ? it : it - n1) * BK;
    const uint32_t buf = ring + (it & 1) * STAGE;
    copy_tile<NC, BK, ASYNC>(buf, ld_dst, kp, kb, lay.k_row, row0, lr, cc, s_len, d);
    kp += BK * lay.k_row;
    if (PASS2 && it >= n1) {
      copy_tile<NC, BK, ASYNC>(buf + KV_BYTES, ld_dst, vp, vb, lay.v_row, row0, lr, cc, s_len, d);
      vp += BK * lay.v_row;
    }
  };
  load_rows<NC, BQ, ASYNC>(q_s, qb, lay.q_row, q0, t_len, d);
  load(0);
  tc::cp_async_commit();
  const uint32_t q_w = q_s + wg * NC * 8192;  // this warpgroup's 64 rows of Q

  // Waits for iteration it's tiles, starts the next iteration's loads and
  // leaves S(it) = Q K^T in s. Every tile is consumed within its iteration, so
  // the barrier also frees the buffer the next loads overwrite.
  auto scores = [&](int it, float (&s)[NS]) {
    tc::cp_async_wait<0>();
    tc::fence_async_proxy();
    __syncthreads();
    if (it + 1 < total) load(it + 1);
    tc::cp_async_commit();
    tile_qk<NKS, BK>(s, q_w, ring + (it & 1) * STAGE);
    tc::mma_wait<0>();
    tc::pin(s);
  };

  // pass 1: the row statistics
  RowStats st;
  for (int it = 0; it < n1; ++it) {
    float s[NS];
    scores(it, s);
    st.add(s, it * BK, s_len, t4, scale_log2, MODE == kStats && sp);
  }
  if (PASS1) st.finish();
  const float m0 = st.m0, m1 = st.m1, l0 = st.l0, l1 = st.l1;

  if constexpr (MODE == kStats) {
    st.write(ex, bh, t_len, r0, r1, tid & 31, scale);
  } else {
    // pass 2: per-row constants of the quantizer, then P V over the key tiles.
    // z = scale m + ln l: read from rt_stats' output (kAccum) or formed from
    // pass 1 (kStatic)
    const bool uni = MODE == kUniform || (MODE == kStatic && ex.uniform);
    float delta, c0, c1, ub = 0.f, z0 = 0.f, z1 = 0.f;
    if (MODE == kAccum) {
      const float r = __int_as_float(*ex.red);
      delta = sp ? r : 1.f / r;
      if (r0 < t_len) z0 = ex.z[(size_t)bh * t_len + r0];
      if (r1 < t_len) z1 = ex.z[(size_t)bh * t_len + r1];
    } else {
      delta = *ex.delta;
    }
    if (MODE == kStatic) {
      z0 = fmaf(m0, scale, logf(l0));
      z1 = fmaf(m1, scale, logf(l1));
    }
    if (uni) {
      c0 = -fmaf(m0, scale_log2, log2f(l0 * delta));
      c1 = -fmaf(m1, scale_log2, log2f(l1 * delta));
    } else {
      ub = fminf(fminf(static_cast<float>((__float_as_int(delta) >> 23) - 1), ex.max_code), 126.f);
      const float log2d = log2f(delta);
      c0 = fmaf(z0, kInvLn2, log2d);
      c1 = fmaf(z1, kInvLn2, log2d);
    }
    constexpr float kMagic = 12582912.f;  // 1.5 2^23: x + kMagic rounds x to an integer
    float oacc[NC][32];
#pragma unroll
    for (int cb = 0; cb < NC; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[cb][i] = 0.f;
    float s00 = 0.f, s01 = 0.f;  // start_peak: key 0's raw scores (lane t4 = 0)

    for (int it = n1; it < total; ++it) {
      float s[NS];
      scores(it, s);
      uint32_t p[BK / 16][4];
      // start_peak: key 0 is s[0] (row r0) and s[2] (row r1) of lane t4 = 0; its
      // raw scores are kept for the exact term added after the loop
      const bool peak0 = MODE != kUniform && sp && it == n1 && t4 == 0;
      if (peak0) {
        s00 = s[0];
        s01 = s[2];
      }
      if (uni) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const float e = ex2(fmaf(s[i], scale_log2, (i & 2) ? c1 : c0));
          s[i] = fminf((e + kMagic) - kMagic, ex.max_code);
        }
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            p[ks][r] = tc::pack_bf16(s[8 * ks + 2 * r], s[8 * ks + 2 * r + 1]);
      } else {
        // bits(y + kMagic) = 0x4B400000 + q, and the bf16 2^-q is (127 - q) << 7:
        // a pair (lo, hi) packs as kPair - 2^7 bits(lo) - 2^23 bits(hi) mod 2^32
        constexpr uint32_t kLo = 0x4B40007Fu << 7, kPair = kLo + (0x4B40007Fu << 23);
        uint32_t bits[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const float y = fminf(fmaxf(fmaf(s[i], -scale_log2, (i & 2) ? c1 : c0), 0.f), ub);
          bits[i] = __float_as_uint(y + kMagic);
        }
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            p[ks][r] = kPair - (bits[8 * ks + 2 * r] << 7) - (bits[8 * ks + 2 * r + 1] << 23);
      }
      if (peak0) {  // key 0's A elements: zero, its exact term is added after the loop
        p[0][0] &= 0xffff0000u;
        p[0][1] &= 0xffff0000u;
      }
      tile_pv<NC, BK>(oacc, p, ring + (it & 1) * STAGE + KV_BYTES);
      tc::mma_wait<0>();
#pragma unroll
      for (int cb = 0; cb < NC; ++cb) tc::pin(oacc[cb]);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) tc::pin(p[ks]);
    }

    // out = delta acc (+ exp(s0 - z) V[0, :] under start_peak)
    const bool peak = MODE != kUniform && sp;
    float p00 = 0.f, p01 = 0.f;
    if (peak) {
      const int lead = (tid & 31) & ~3;
      p00 = expf(fmaf(__shfl_sync(0xffffffffu, s00, lead), scale, -z0));
      p01 = expf(fmaf(__shfl_sync(0xffffffffu, s01, lead), scale, -z1));
    }
    bf16* ob = o + batch * lay.o_batch + head_off;
#pragma unroll
    for (int cb = 0; cb < NC; ++cb)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const int col = cb * 64 + 8 * jb + 2 * t4;
        float x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = oacc[cb][4 * jb + i] * delta;
        if (peak) {
          const float va = col < d ? __bfloat162float(vb[col]) : 0.f;
          const float vb1 = col + 1 < d ? __bfloat162float(vb[col + 1]) : 0.f;
          x[0] = fmaf(p00, va, x[0]);
          x[1] = fmaf(p00, vb1, x[1]);
          x[2] = fmaf(p01, va, x[2]);
          x[3] = fmaf(p01, vb1, x[3]);
        }
        store_pair(ob, lay.o_row, r0, col, x[0], x[1], t_len, d, o_vec);
        store_pair(ob, lay.o_row, r1, col, x[2], x[3], t_len, d, o_vec);
      }
    zero_pad_lanes(ob, lay, r0, r1, t_len, d, t4);
  }
}

template <int MODE, int NC, int NKS, bool ASYNC>
cudaError_t launch_quant_tc(const void* q, const void* k, const void* v, void* o, int bh,
                            int t_len, int s_len, int d, float scale, const Extra& ex,
                            const Layout& lay, int o_vec, cudaStream_t stream) {
  constexpr int STAGES_BYTES = 2 * (MODE == kStats ? 1 : 2) * NC * 64 * 128;
  const int smem = 1024 + 128 * NC * 128 + STAGES_BYTES;
  auto kernel = quant_tc_kernel<MODE, NC, NKS, ASYNC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + 127) / 128, bh);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), t_len, s_len, d, scale, scale * kLog2e, ex, lay, o_vec);
  return cudaGetLastError();
}

// The quantizing modes' tensor-core forms (1: cp.async tiles, 2: element
// loads), head_dim <= 192, scale > 0, and for uniform codes (K1, K4 uniform)
// codes exact in bf16 (2^b - 1 <= 256); anything else is refused.
template <int MODE, bool ASYNC>
int dispatch_quant_tc(const void* q, const void* k, const void* v, void* o, int bh, int t_len,
                      int s_len, int d, float scale, const Extra& ex, const Layout& lay,
                      cudaStream_t stream) {
  if (bh < 1 || bh > 65535 || t_len < 1 || s_len < 1 || d < 1 || d > 192 || !(scale > 0.f))
    return cudaErrorInvalidValue;
  if (lay.heads < 1 || bh % lay.heads || lay.o_cols < d) return cudaErrorInvalidValue;
  const bool uniform_codes = MODE == kUniform || (MODE == kStatic && ex.uniform);
  if (uniform_codes && !(ex.max_code <= 256.f)) return cudaErrorInvalidValue;
  if (ASYNC && !async_ok(q, k, MODE == kStats ? k : v, d, lay)) return cudaErrorInvalidValue;
  const int o_vec = MODE == kStats ? 0 : out_vec(o, lay);
#define DGQ_QTC(NC, NKS) \
  return launch_quant_tc<MODE, NC, NKS, ASYNC>(q, k, v, o, bh, t_len, s_len, d, scale, ex, lay, o_vec, stream)
  const int nks = (d + 15) / 16;
  if (d <= 64) {
    if (nks == 3) DGQ_QTC(1, 3);
    DGQ_QTC(1, 4);
  }
  if (d <= 128) {
    if (nks == 5) DGQ_QTC(2, 5);
    DGQ_QTC(2, 8);
  }
  if (nks == 10) DGQ_QTC(3, 10);
  DGQ_QTC(3, 12);
#undef DGQ_QTC
}

// ---- (d) flash attention on the tensor cores, f32: 3xTF32 ----
//
// The f32 flash mode (K2, K2p) as `wgmma` on TF32 operands, each product of
// f32 numbers formed from three TF32 products (wgmma.cuh, `split_tf32`): one
// TF32 product keeps 11 bits, which at the VAE's scores (spread about 4) gives
// errors near 1e-3, ten times the f32 tolerance. A block is one warpgroup and
// takes 64 query rows of one head and one range of O's columns; each key tile
// of BK keys is a sequence of steps through a ring of two shared-memory
// stages:
//   * NCH steps of S = Q K^T, one per 32 lanes of the head dim: the step's Q
//     chunk (64 rows) and K chunk (BK keys), each as TF32 big and small
//     parts, K-major as they lie, `Tf32<BK>::ss` three times a k8 step into
//     a fresh accumulator that is then added to S in f32;
//   * after the last, the online softmax in base 2 (as body (a)), P split
//     into big and small in registers, where it is the A operand of P V;
//   * NPB steps of P V, one per NB of O's columns: V's tile stored
//     transposed (the keys contiguous, the only way `wgmma` takes a TF32 B
//     operand), its keys in the order `key_slot` gives, `Tf32<NB>::rs` three
//     times a k8 step into a fresh accumulator, then O = O corr + P V in f32.
// The fresh accumulators are what keeps the f32 tolerance: the tensor cores
// add rounding toward zero, and at head dim 512 one accumulator over all of
// Q K^T (192 adds) and one over all of P V (three adds a k8 step of 4096 keys)
// drifted to 1.1e-4 from the f32 plain result at the VAE's shape.
// A step's operands are loaded from device memory into registers a step
// ahead, then split and stored into the free stage while the previous step
// multiplies (no copy engine rounds, so no `cp.async`). Q is read again for
// every key tile, from L2: at head dim 512 (the VAE) 64 rows of Q in big and
// small parts are 256 KB, more than a block's shared memory, and they cannot
// stay in registers beside O. There each block holds half of O's columns
// (blockIdx.z; 128 registers a thread) and both halves form the whole of S,
// so Q K^T is done twice (1.5x the minimal flops), and the Q and K chunks of
// a 32-key tile move 192 KB from L2 for 9.4 MFLOP. Below 512 a block holds all
// of O (40 to 160 columns) and a tile is 64 keys. What bounds it is the
// operations, three TF32 products at 495 TFLOP/s; what holds it is the step
// machinery: with one step of prefetch in registers each step waits on its
// own loads, and two or three blocks an SM hide only part of it (on an H100,
// 3.8x the bound at SD's 64px self-attention, faster than the plain version
// and the library call, but 9.4x at the VAE's 512px shape, 2.4x slower than
// the plain version). A `cp.async` ring of raw tiles several steps ahead,
// split in shared memory, is the open step. `VEC`: 16-byte loads where every
// row starts on a 16-byte boundary and head_dim is a multiple of 4; else
// element loads of the same numbers (same bits).
constexpr int kTfThreads = 128;  // one warpgroup

// Where key `key` of a tile goes along P V's contraction: the S accumulator
// leaves keys 2t and 2t + 1 of every 8-key block with lane t, the A fragment
// wants k t and t + 4 there, so each block is contracted in the key order
// 0 2 4 6 1 3 5 7 and V^T is stored in that order.
__device__ __forceinline__ int key_slot(int key) {
  return (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2);
}

// Elements [col, col + 4) of row `row` of a matrix whose rows lie `stride`
// apart, zeros for a row past rows_valid and for lanes past d.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ src, long long stride, int row,
                                        int rows_valid, int col, int d) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows_valid || col >= d) return r;
  const float* p = src + row * stride + col;
  if constexpr (VEC) {
    r = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    r.x = __ldg(p);
    if (col + 1 < d) r.y = __ldg(p + 1);
    if (col + 2 < d) r.z = __ldg(p + 2);
    if (col + 3 < d) r.w = __ldg(p + 3);
  }
  return r;
}

// big and small TF32 parts of four f32 into swizzled chunks at dst and dst + off
__device__ __forceinline__ void store_split4(uint32_t dst, uint32_t off, float4 v) {
  uint32_t b[4], s[4];
  tc::split_tf32(v.x, b[0], s[0]);
  tc::split_tf32(v.y, b[1], s[1]);
  tc::split_tf32(v.z, b[2], s[2]);
  tc::split_tf32(v.w, b[3], s[3]);
  tc::st_shared16(dst, make_uint4(b[0], b[1], b[2], b[3]));
  tc::st_shared16(dst + off, make_uint4(s[0], s[1], s[2], s[3]));
}

__device__ __forceinline__ void st_shared4(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
}

// The step machinery shared by the f32 tensor-core bodies (d) and (e). A key
// tile of BK keys is a sequence of steps: step i < NCH is the 32-lane chunk i
// of Q K^T (64 rows of Q from q0, BK keys of K from key0), step NCH + b the
// NB of O's columns from c0 + b NB of P V (V's BK keys, stored transposed).
// `tf32_load` brings a step's operands into registers (stg), `tf32_store`
// splits them into big and small TF32 parts in a ring stage, `tf32_qk` runs
// a Q K^T step's three products a k8 step into a fresh accumulator. Thread
// (lr, cc) = (tid / 8, tid % 8) takes 16-byte chunk cc of rows lr + 16 p of
// the Q and K chunks; a V block takes key lane + 32 (p % (BK / 32)), lanes
// 4 n4.. of the block, n4 = warp + 4 (p / (BK / 32)).
template <int NCH, int BK, int NB, int NSTG, bool VEC>
__device__ __forceinline__ void tf32_load(float4 (&stg)[NSTG], int j, int i, const float* qb,
                                          const float* kb, const float* vb, const Layout& lay,
                                          int q0, int c0, int t_len, int s_len, int d, int tid) {
  constexpr int NPV = (BK / 32) * ((NB + 15) / 16);
  const int cc = tid & 7, lr = tid >> 3, warp = tid >> 5, lane = tid & 31;
  const int key0 = j * BK;
  if (i < NCH) {
    const int col = 32 * i + 4 * cc;
#pragma unroll
    for (int p = 0; p < 4; ++p) stg[p] = load4<VEC>(qb, lay.q_row, q0 + lr + 16 * p, t_len, col, d);
#pragma unroll
    for (int p = 0; p < BK / 16; ++p)
      stg[4 + p] = load4<VEC>(kb, lay.k_row, key0 + lr + 16 * p, s_len, col, d);
  } else {
    const int cb = c0 + (i - NCH) * NB;
#pragma unroll
    for (int p = 0; p < NPV; ++p) {
      const int n4 = warp + 4 * (p / (BK / 32));
      stg[p] = n4 < NB / 4 ? load4<VEC>(vb, lay.v_row, key0 + lane + 32 * (p % (BK / 32)), s_len,
                                        cb + 4 * n4, d)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// ... split into big and small and stored into the stage at st: the Q and K
// chunks K-major (big at st and st + 16384, small 8192 and BK 128 further), the
// V block as V^T, its keys in `key_slot` order (small PV_HALF further)
template <int NCH, int BK, int NB, int NSTG>
__device__ __forceinline__ void tf32_store(const float4 (&stg)[NSTG], int i, uint32_t st, int tid) {
  constexpr int NPV = (BK / 32) * ((NB + 15) / 16);
  constexpr int PV_HALF = NB * BK * 4;
  const int cc = tid & 7, lr = tid >> 3, warp = tid >> 5, lane = tid & 31;
  if (i < NCH) {
#pragma unroll
    for (int p = 0; p < 4; ++p) store_split4(st + tc::swz(lr + 16 * p, cc), 8192, stg[p]);
#pragma unroll
    for (int p = 0; p < BK / 16; ++p)
      store_split4(st + 16384 + tc::swz(lr + 16 * p, cc), BK * 128, stg[4 + p]);
  } else {
#pragma unroll
    for (int p = 0; p < NPV; ++p) {
      const int n4 = warp + 4 * (p / (BK / 32));
      if (n4 >= NB / 4) continue;
      const int slot = key_slot(lane + 32 * (p % (BK / 32)));
      const float e4[4] = {stg[p].x, stg[p].y, stg[p].z, stg[p].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 4 * n4 + e;  // row n of V^T: sub-tile slot / 32, chunk (slot % 32) / 4
        const uint32_t dst = st + (slot >> 5) * (NB * 128) + n * 128 +
                             ((((slot & 31) >> 2) ^ (n & 7)) << 4) + ((slot & 3) << 2);
        uint32_t big, small;
        tc::split_tf32(e4[e], big, small);
        st_shared4(dst, big);
        st_shared4(dst + PV_HALF, small);
      }
    }
  }
}

// Q K^T chunk i of the stage at cur into a fresh accumulator sc: three TF32
// products a k8 step, the two small terms first
template <int NKS, int BK>
__device__ __forceinline__ void tf32_qk(float (&sc)[BK / 2], uint32_t cur, int i) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (4 * i + u < NKS) {
      const uint64_t qbig = tc::desc(cur + 32 * u), qsmall = tc::desc(cur + 8192 + 32 * u);
      const uint64_t kbig = tc::desc(cur + 16384 + 32 * u);
      const uint64_t ksmall = tc::desc(cur + 16384 + BK * 128 + 32 * u);
      tc::Tf32<BK>::ss(sc, qbig, ksmall, u > 0);
      tc::Tf32<BK>::ss(sc, qsmall, kbig, 1);
      tc::Tf32<BK>::ss(sc, qbig, kbig, 1);
    }
  }
}

// NCH: 32-lane chunks of the head dim; NKS: k8 steps of Q K^T (ceil(d / 8),
// or more: lanes past d are zeros); BK: keys per tile; NB: O columns a P V
// step; NPB: P V steps, so a block holds NB * NPB of O's columns, from
// blockIdx.z * NB * NPB on.
// The 40-column tier runs three blocks an SM in 168 registers (60 bytes of
// spills); the wider tiers take all 255 registers and two blocks.
template <int NCH, int NKS, int BK, int NB, int NPB, bool VEC>
__global__ void __launch_bounds__(kTfThreads, NB * NPB <= 40 ? 3 : 1)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int t_len, int s_len, int d,
                  float scale_log2, Layout lay, int o_vec) {
  static_assert(NKS <= 4 * NCH && BK % 32 == 0 && NB % 8 == 0, "tile shape");
  constexpr int NST = NCH + NPB;                     // steps a key tile
  constexpr int QK_BYTES = (64 + BK) * 256;          // Q and K chunks, big and small
  constexpr int PV_HALF = NB * BK * 4;               // V^T block, big (small follows)
  constexpr int STAGE = QK_BYTES > 2 * PV_HALF ? QK_BYTES : 2 * PV_HALF;
  constexpr int NQK = 4 + BK / 16;                   // float4 a thread: Q and K chunks
  constexpr int NPV = (BK / 32) * ((NB + 15) / 16);  // float4 a thread: a V block
  constexpr int NSTG = NQK > NPV ? NQK : NPV;
  constexpr int NS = BK / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (tc::smem_u32(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * 64, col0 = blockIdx.z * NB * NPB;
  const int batch = bh / lay.heads, head_off = (bh - batch * lay.heads) * lay.slot;
  const float* qb = q + batch * lay.q_batch + head_off;
  const float* kb = k + batch * lay.k_batch + head_off;
  const float* vb = v + batch * lay.v_batch + head_off;
  float* ob = o + batch * lay.o_batch + head_off;
  const int n_tiles = (s_len + BK - 1) / BK;
  const int total = n_tiles * NST;

  float4 stg[NSTG];
  auto load = [&](int j, int i) {
    tf32_load<NCH, BK, NB, NSTG, VEC>(stg, j, i, qb, kb, vb, lay, q0, col0, t_len, s_len, d, tid);
  };
  auto store = [&](int i, uint32_t st) { tf32_store<NCH, BK, NB, NSTG>(stg, i, st, tid); };

  float oacc[NPB][NB / 2];
#pragma unroll
  for (int b = 0; b < NPB; ++b)
#pragma unroll
    for (int x = 0; x < NB / 2; ++x) oacc[b][x] = 0.f;
  // S, this chunk's part of it, and this step's P V: each chain of tensor-core
  // adds starts afresh and is added to S or O in f32 (wgmma.cuh)
  float s[NS], sc[NS], pv[NB / 2];
  uint32_t pb[BK / 8][4], ps[BK / 8][4];  // P's big and small A fragments, one a k8 step
  // the row statistics, m in raw-score units; row 0 is 16 warp + g, row 1 eight below;
  // corr: this tile's rescale of O, applied as each P V step adds to its columns
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, corr0 = 1.f, corr1 = 1.f;

  load(0, 0);
  store(0, ring);
  if (total > 1) load(NST > 1 ? 0 : 1, 1 % NST);

  for (int j = 0; j < n_tiles; ++j) {
#pragma unroll
    for (int i = 0; i < NST; ++i) {
      const int st = j * NST + i;
      const uint32_t cur = ring + (st & 1) * STAGE, nxt = ring + ((st + 1) & 1) * STAGE;
      tc::fence_async_proxy();  // this step's operands are stored ...
      __syncthreads();          // ... by every thread, and the other stage is consumed
      tc::mma_fence();
      if (i < NCH) {
        tf32_qk<NKS, BK>(sc, cur, i);
      } else {
#pragma unroll
        for (int u = 0; u < BK / 8; ++u) {
          const uint32_t vt = cur + (u / 4) * (NB * 128) + (u % 4) * 32;
          tc::Tf32<NB>::rs(pv, pb[u], tc::desc(vt + PV_HALF), u > 0);
          tc::Tf32<NB>::rs(pv, ps[u], tc::desc(vt), 1);
          tc::Tf32<NB>::rs(pv, pb[u], tc::desc(vt), 1);
        }
      }
      tc::mma_commit();
      // the next step's operands go into the other stage while this one multiplies
      if (st + 1 < total) store((i + 1) % NST, nxt);
      if (st + 2 < total) load(j + (i + 2) / NST, (i + 2) % NST);
      tc::mma_wait<0>();
      if (i < NCH) {
        tc::pin(sc);
#pragma unroll
        for (int x = 0; x < NS; ++x) s[x] = i == 0 ? sc[x] : s[x] + sc[x];
      } else {
        tc::pin(pv);
#pragma unroll
        for (int u = 0; u < BK / 8; ++u) {
          tc::pin(pb[u]);
          tc::pin(ps[u]);
        }
#pragma unroll
        for (int x = 0; x < NB / 2; ++x)
          oacc[i - NCH][x] = fmaf(oacc[i - NCH][x], (x & 2) ? corr1 : corr0, pv[x]);
      }
      if (i == NCH - 1) {
        // online softmax in base 2, as body (a); then P into big and small A
        // fragments: keys 2 t4 and 2 t4 + 1 of block u are k t4 and t4 + 4
        const int key0 = j * BK;
        const bool ragged = key0 + BK > s_len;
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int x = 0; x < NS; ++x) {
          const int key = key0 + 8 * (x >> 2) + 2 * t4 + (x & 1);
          if (ragged && key >= s_len) s[x] = kNegInf;
          if (x & 2) mx1 = fmaxf(mx1, s[x]);
          else mx0 = fmaxf(mx0, s[x]);
        }
        const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
        corr0 = ex2((m0 - mn0) * scale_log2);
        corr1 = ex2((m1 - mn1) * scale_log2);
        const float off0 = -mn0 * scale_log2, off1 = -mn1 * scale_log2;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int x = 0; x < NS; ++x) {
          s[x] = ex2(fmaf(s[x], scale_log2, (x & 2) ? off1 : off0));
          if (x & 2) sum1 += s[x];
          else sum0 += s[x];
        }
        l0 = l0 * corr0 + sum0;  // each lane's share of the row; joined at the end
        l1 = l1 * corr1 + sum1;
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int u = 0; u < BK / 8; ++u) {
          tc::split_tf32(s[4 * u], pb[u][0], ps[u][0]);      // (g, key 2 t4)
          tc::split_tf32(s[4 * u + 2], pb[u][1], ps[u][1]);  // (g + 8, key 2 t4)
          tc::split_tf32(s[4 * u + 1], pb[u][2], ps[u][2]);  // (g, key 2 t4 + 1)
          tc::split_tf32(s[4 * u + 3], pb[u][3], ps[u][3]);  // (g + 8, key 2 t4 + 1)
        }
      }
    }
  }

  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int b = 0; b < NPB; ++b)
#pragma unroll
    for (int jb = 0; jb < NB / 8; ++jb) {
      const int col = col0 + b * NB + 8 * jb + 2 * t4;
      store_pair(ob, lay.o_row, r0, col, oacc[b][4 * jb] * inv0, oacc[b][4 * jb + 1] * inv0,
                 t_len, d, o_vec);
      store_pair(ob, lay.o_row, r1, col, oacc[b][4 * jb + 2] * inv1, oacc[b][4 * jb + 3] * inv1,
                 t_len, d, o_vec);
    }
  if (blockIdx.z == 0) zero_pad_lanes(ob, lay, r0, r1, t_len, d, t4);
}

template <int NCH, int NKS, int BK, int NB, int NPB, bool VEC>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o, int bh, int t_len,
                        int s_len, int d, float scale, const Layout& lay, int o_vec,
                        cudaStream_t stream) {
  constexpr int QK_BYTES = (64 + BK) * 256, PV_BYTES = NB * BK * 8;
  const int smem = 1024 + 2 * (QK_BYTES > PV_BYTES ? QK_BYTES : PV_BYTES);
  auto kernel = flash_tf32_kernel<NCH, NKS, BK, NB, NPB, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + 63) / 64, bh, (d + NB * NPB - 1) / (NB * NPB));
  kernel<<<grid, kTfThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), t_len, s_len, d, scale * kLog2e, lay, o_vec);
  return cudaGetLastError();
}

// Whether the f32 tensor-core body may load 16-byte vectors: every row of q,
// k and v starts on a 16-byte boundary and head_dim is a multiple of 4.
bool vec_ok(const void* q, const void* k, const void* v, int d, const Layout& lay) {
  const long long strides[] = {lay.q_batch, lay.q_row, lay.k_batch, lay.k_row, lay.v_batch,
                               lay.v_row, lay.slot};
  for (long long st : strides)
    if (st % 4) return false;
  return d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
}

// form 3: 16-byte loads, which need `vec_ok`; form 4: element loads. Head-dim
// tiers: SD's 40, SDXL's 64, SD's 80 and 160 (two 80-column steps), the VAE's
// 512 (blockIdx.z takes 256 of O's columns in eight 32-column steps, 32-key
// tiles; 32-column steps hold fewer registers than 64-column ones, which
// spilled more).
template <bool VEC>
int dispatch_tf32(const void* q, const void* k, const void* v, void* o, int bh, int t_len,
                  int s_len, int d, float scale, const Layout& lay, cudaStream_t stream) {
  if (bh < 1 || bh > 65535 || t_len < 1 || s_len < 1 || d < 1 || d > 512 || !(scale > 0.f))
    return cudaErrorInvalidValue;
  if (lay.heads < 1 || bh % lay.heads || lay.o_cols < d) return cudaErrorInvalidValue;
  if (VEC && !vec_ok(q, k, v, d, lay)) return cudaErrorInvalidValue;
  const int o_vec = reinterpret_cast<uintptr_t>(o) % 8 == 0 && lay.o_batch % 2 == 0 &&
                    lay.o_row % 2 == 0 && lay.slot % 2 == 0;
#define DGQ_TF(NCH, NKS, BK, NB, NPB) \
  return launch_tf32<NCH, NKS, BK, NB, NPB, VEC>(q, k, v, o, bh, t_len, s_len, d, scale, lay, o_vec, stream)
  if (d <= 40) DGQ_TF(2, 5, 64, 40, 1);
  if (d <= 64) DGQ_TF(2, 8, 64, 64, 1);
  if (d <= 80) DGQ_TF(3, 10, 64, 80, 1);
  if (d <= 160) DGQ_TF(5, 20, 64, 80, 2);
  DGQ_TF(16, 64, 32, 32, 8);
#undef DGQ_TF
}

// ---- (e) the quantizing modes K1, K3b, K4 on the tensor cores, f32: 3xTF32 ----
//
// The f32 entries of the quantizing modes on body (d)'s step machinery: one
// warpgroup and 64 query rows a block, key tiles of 64, a two-stage ring, each
// step's operands split into TF32 parts a step ahead in registers. Pass 1
// (kUniform, kStats, kStatic) is NCH Q K^T steps a key tile and the row
// statistics of body (c) on the f32 S: m on the raw scores, l in base 2, m2
// under start_peak; kStats then writes z = scale m + ln l and folds the call's
// scalar by the same atomic on its bit pattern. Pass 2 (kUniform, kAccum,
// kStatic) recomputes S with the same steps, quantizes it in registers and
// runs NPB P V steps. What each part takes:
//   * S = Q K^T: three TF32 products (`tf32_qk`), a fresh accumulator a
//     32-lane chunk, added in f32, in one instruction sequence for every
//     launch and both passes: quant_accum sees the S from which rt_stats took
//     m, l and z, and pass 2 the S of pass 1, to the bit.
//   * P V: two products, P V_big and P V_small, because P is one TF32 number
//     exactly. A uniform code is an integer <= 2^b - 1 <= 2048, which TF32's
//     11 significant bits hold. A log2 term p_q = 2^-q delta (body (b)'s
//     bitcast(bits(delta) - (q << 23))) is fed as 2^(e - q), e delta's
//     unbiased exponent, bits (exponent_field(delta) - q) << 23: a normal
//     TF32 number for every q <= ub = min(2^b - 1, exponent_field(delta) - 1),
//     body (b)'s bound with no cap at 126 (the bf16 body's cap). The
//     accumulator is multiplied once by delta's significand (delta with
//     exponent field 127), so each term is p_q v exactly as body (b) forms it;
//     uniform codes are multiplied by delta once, as in body (c). Each key
//     tile's P V goes into a fresh accumulator that is added to O in f32: one
//     accumulator over all of P V drifts past 1e-4 (the tensor cores add
//     rounding toward zero, body (d)'s note).
//   * start_peak: key 0's A element is zero and exp(s0 - z) V[0, :] is added
//     in f32 after the loop (body (c)'s rank-1 update), so the row's peak stays
//     exact.
//   * Keys past S have zero K and V rows: pass 1 masks them out of m, l and m2,
//     and in pass 2 their finite A elements meet zero V. Rows past T are kept
//     out of z and of the call's scalar, and are not written.
// What bounds it: three TF32 products for Q K^T and two for P V at 495
// TFLOP/s (K1 and K4 form S twice), and the exponentials (one an element a
// pass; quant_accum none); what holds it is body (d)'s step machinery (each
// step waits on loads issued one step earlier). kStats keeps no O and runs
// three blocks an SM, as do the 40-column tiers of the other modes.
template <int MODE, int NCH, int NKS, int NB, int NPB, bool VEC>
__global__ void __launch_bounds__(kTfThreads, MODE == kStats || NB * NPB <= 40 ? 3 : 1)
quant_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int t_len, int s_len, int d,
                  float scale, float scale_log2, Extra ex, Layout lay, int o_vec) {
  constexpr int BK = 64, NS = BK / 2;
  static_assert(NCH >= 2 && NKS <= 4 * NCH && NB % 8 == 0, "tile shape");
  constexpr bool PASS1 = MODE != kAccum;  // the row statistics m, l
  constexpr bool PASS2 = MODE != kStats;  // quantize and P V
  constexpr int NST = NCH + NPB;          // steps a key tile of pass 2
  constexpr int QK_BYTES = (64 + BK) * 256;
  constexpr int PV_HALF = NB * BK * 4;
  constexpr int STAGE = PASS2 && 2 * PV_HALF > QK_BYTES ? 2 * PV_HALF : QK_BYTES;
  constexpr int NQK = 4 + BK / 16;
  constexpr int NPV = (BK / 32) * ((NB + 15) / 16);
  constexpr int NSTG = PASS2 && NPV > NQK ? NPV : NQK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (tc::smem_u32(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * 64;
  const int batch = bh / lay.heads, head_off = (bh - batch * lay.heads) * lay.slot;
  const float* qb = q + batch * lay.q_batch + head_off;
  const float* kb = k + batch * lay.k_batch + head_off;
  const float* vb = PASS2 ? v + batch * lay.v_batch + head_off : kb;
  const int n_tiles = (s_len + BK - 1) / BK;
  // steps [0, n1) are pass 1 (NCH a key tile), [n1, total) pass 2 (NST a tile)
  const int n1 = PASS1 ? n_tiles * NCH : 0;
  const int total = n1 + (PASS2 ? n_tiles * NST : 0);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
  const bool sp = ex.start_peak != 0;

  float4 stg[NSTG];
  auto load = [&](int j, int i) {
    tf32_load<NCH, BK, NB, NSTG, VEC>(stg, j, i, qb, kb, vb, lay, q0, 0, t_len, s_len, d, tid);
  };
  auto store = [&](int i, uint32_t st) { tf32_store<NCH, BK, NB, NSTG>(stg, i, st, tid); };
  // Step st multiplies from stage st & 1 once every thread has stored into it
  // (`sync`); while it runs, step st + 1's operands are stored into the other
  // stage, which the barrier freed, and step st + 2's (key tile j2, step i2)
  // are loaded (`feed`).
  auto sync = [] {
    tc::fence_async_proxy();
    __syncthreads();
    tc::mma_fence();
  };
  auto feed = [&](int st, int i1, int j2, int i2) {
    if (st + 1 < total) store(i1, ring + ((st + 1) & 1) * STAGE);
    if (st + 2 < total) load(j2, i2);
  };

  float s[NS], sc[NS];
  load(0, 0);
  store(0, ring);
  if (total > 1) load(0, 1);  // NCH >= 2: the second step is chunk 1 of key tile 0

  // pass 1: the row statistics
  RowStats rs;
  if (PASS1) {
    for (int j = 0; j < n_tiles; ++j) {
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int st = j * NCH + i;
        sync();
        tf32_qk<NKS, BK>(sc, ring + (st & 1) * STAGE, i);
        tc::mma_commit();
        // two steps on: key tile j + 1 of this pass, or tile 0 of pass 2
        const int j2 = j + (i + 2) / NCH;
        feed(st, (i + 1) % NCH, j2 < n_tiles ? j2 : j2 - n_tiles, (i + 2) % NCH);
        tc::mma_wait<0>();
        tc::pin(sc);
#pragma unroll
        for (int x = 0; x < NS; ++x) s[x] = i == 0 ? sc[x] : s[x] + sc[x];
      }
      rs.add(s, j * BK, s_len, t4, scale_log2, MODE == kStats && sp);
    }
    rs.finish();
  }
  const float m0 = rs.m0, m1 = rs.m1, l0 = rs.l0, l1 = rs.l1;

  if constexpr (MODE == kStats) {
    rs.write(ex, bh, t_len, r0, r1, lane, scale);
  } else {
    // pass 2: the quantizer's row constants, as body (c) forms them
    const bool uni = MODE == kUniform || (MODE == kStatic && ex.uniform);
    float delta, c0, c1, ub = 0.f, z0 = 0.f, z1 = 0.f;
    if (MODE == kAccum) {
      const float r = __int_as_float(*ex.red);
      delta = sp ? r : 1.f / r;
      if (r0 < t_len) z0 = ex.z[(size_t)bh * t_len + r0];
      if (r1 < t_len) z1 = ex.z[(size_t)bh * t_len + r1];
    } else {
      delta = *ex.delta;
    }
    if (MODE == kStatic) {
      z0 = fmaf(m0, scale, logf(l0));
      z1 = fmaf(m1, scale, logf(l1));
    }
    // log2 terms: A element bits dexp - (q << 23), the accumulator times f =
    // delta's significand; uniform codes: the accumulator times f = delta
    const uint32_t dbits = __float_as_uint(delta), dexp = dbits & 0x7f800000u;
    const float f = uni ? delta : __uint_as_float((dbits & 0x807fffffu) | 0x3f800000u);
    if (uni) {
      c0 = -fmaf(m0, scale_log2, log2f(l0 * delta));
      c1 = -fmaf(m1, scale_log2, log2f(l1 * delta));
    } else {
      ub = fminf(static_cast<float>(static_cast<int>(dbits >> 23) - 1), ex.max_code);
      const float log2d = log2f(delta);
      c0 = fmaf(z0, kInvLn2, log2d);
      c1 = fmaf(z1, kInvLn2, log2d);
    }
    constexpr float kMagic = 12582912.f;  // 1.5 2^23: x + kMagic rounds x to an integer
    float oacc[NPB][NB / 2], pv[NB / 2];
#pragma unroll
    for (int b = 0; b < NPB; ++b)
#pragma unroll
      for (int x = 0; x < NB / 2; ++x) oacc[b][x] = 0.f;
    uint32_t pa[BK / 8][4];       // P's A fragments, one a k8 step
    float s00 = 0.f, s01 = 0.f;  // start_peak: key 0's raw scores (lane t4 = 0)

    for (int j = 0; j < n_tiles; ++j) {
#pragma unroll
      for (int i = 0; i < NST; ++i) {
        const int st = n1 + j * NST + i;
        const uint32_t cur = ring + (st & 1) * STAGE;
        sync();
        if (i < NCH) {
          tf32_qk<NKS, BK>(sc, cur, i);
        } else {
#pragma unroll
          for (int u = 0; u < BK / 8; ++u) {
            const uint32_t vt = cur + (u / 4) * (NB * 128) + (u % 4) * 32;
            tc::Tf32<NB>::rs(pv, pa[u], tc::desc(vt + PV_HALF), u > 0);
            tc::Tf32<NB>::rs(pv, pa[u], tc::desc(vt), 1);
          }
        }
        tc::mma_commit();
        feed(st, (i + 1) % NST, j + (i + 2) / NST, (i + 2) % NST);
        tc::mma_wait<0>();
        if (i < NCH) {
          tc::pin(sc);
#pragma unroll
          for (int x = 0; x < NS; ++x) s[x] = i == 0 ? sc[x] : s[x] + sc[x];
        } else {
          tc::pin(pv);
#pragma unroll
          for (int u = 0; u < BK / 8; ++u) tc::pin(pa[u]);
#pragma unroll
          for (int x = 0; x < NB / 2; ++x) oacc[i - NCH][x] += pv[x];
        }
        if (i == NCH - 1) {
          // S of key tile j is whole: its A fragments, keys 2 t4 and 2 t4 + 1
          // of block u as k t4 and t4 + 4 (V^T is stored in `key_slot` order)
          const bool peak0 = MODE != kUniform && sp && j == 0 && t4 == 0;
          if (peak0) {
            s00 = s[0];
            s01 = s[2];
          }
          uint32_t a[NS];
          if (uni) {
#pragma unroll
            for (int x = 0; x < NS; ++x) {
              const float e = ex2(fmaf(s[x], scale_log2, (x & 2) ? c1 : c0));
              a[x] = __float_as_uint(fminf((e + kMagic) - kMagic, ex.max_code));
            }
          } else {
            // bits(y + kMagic) = 0x4B400000 + q, and (0x4B400000 << 23) is 0 mod 2^32
#pragma unroll
            for (int x = 0; x < NS; ++x) {
              const float y = fminf(fmaxf(fmaf(s[x], -scale_log2, (x & 2) ? c1 : c0), 0.f), ub);
              a[x] = dexp - (__float_as_uint(y + kMagic) << 23);
            }
          }
          if (peak0) {  // key 0's A elements: zero, its exact term is added after the loop
            a[0] = 0u;
            a[2] = 0u;
          }
#pragma unroll
          for (int u = 0; u < BK / 8; ++u) {
            pa[u][0] = a[4 * u];      // (g, key 2 t4)
            pa[u][1] = a[4 * u + 2];  // (g + 8, key 2 t4)
            pa[u][2] = a[4 * u + 1];  // (g, key 2 t4 + 1)
            pa[u][3] = a[4 * u + 3];  // (g + 8, key 2 t4 + 1)
          }
        }
      }
    }

    // out = f acc (+ exp(s0 - z) V[0, :] under start_peak)
    const bool peak = MODE != kUniform && sp;
    float p00 = 0.f, p01 = 0.f;
    if (peak) {
      const int lead = lane & ~3;
      p00 = expf(fmaf(__shfl_sync(0xffffffffu, s00, lead), scale, -z0));
      p01 = expf(fmaf(__shfl_sync(0xffffffffu, s01, lead), scale, -z1));
    }
    float* ob = o + batch * lay.o_batch + head_off;
#pragma unroll
    for (int b = 0; b < NPB; ++b)
#pragma unroll
      for (int jb = 0; jb < NB / 8; ++jb) {
        const int col = b * NB + 8 * jb + 2 * t4;
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = oacc[b][4 * jb + e] * f;
        if (peak) {
          const float va = col < d ? vb[col] : 0.f, vb1 = col + 1 < d ? vb[col + 1] : 0.f;
          x[0] = fmaf(p00, va, x[0]);
          x[1] = fmaf(p00, vb1, x[1]);
          x[2] = fmaf(p01, va, x[2]);
          x[3] = fmaf(p01, vb1, x[3]);
        }
        store_pair(ob, lay.o_row, r0, col, x[0], x[1], t_len, d, o_vec);
        store_pair(ob, lay.o_row, r1, col, x[2], x[3], t_len, d, o_vec);
      }
    zero_pad_lanes(ob, lay, r0, r1, t_len, d, t4);
  }
}

template <int MODE, int NCH, int NKS, int NB, int NPB, bool VEC>
cudaError_t launch_quant_tf32(const void* q, const void* k, const void* v, void* o, int bh,
                              int t_len, int s_len, int d, float scale, const Extra& ex,
                              const Layout& lay, int o_vec, cudaStream_t stream) {
  constexpr int QK_BYTES = 128 * 256, PV_BYTES = MODE == kStats ? 0 : NB * 64 * 8;
  const int smem = 1024 + 2 * (QK_BYTES > PV_BYTES ? QK_BYTES : PV_BYTES);
  auto kernel = quant_tf32_kernel<MODE, NCH, NKS, NB, NPB, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + 63) / 64, bh);
  kernel<<<grid, kTfThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), t_len, s_len, d, scale, scale * kLog2e, ex, lay, o_vec);
  return cudaGetLastError();
}

// The quantizing modes' f32 tensor-core forms (3: 16-byte loads, which need
// `vec_ok`; 4: element loads), head_dim <= 160 (body (d)'s tiers below the
// VAE's), scale > 0, and for uniform codes (K1, K4 uniform) codes exact in TF32
// (2^b - 1 <= 2048); anything else is refused.
template <int MODE, bool VEC>
int dispatch_quant_tf32(const void* q, const void* k, const void* v, void* o, int bh, int t_len,
                        int s_len, int d, float scale, const Extra& ex, const Layout& lay,
                        cudaStream_t stream) {
  if (bh < 1 || bh > 65535 || t_len < 1 || s_len < 1 || d < 1 || d > 160 || !(scale > 0.f))
    return cudaErrorInvalidValue;
  if (lay.heads < 1 || bh % lay.heads || lay.o_cols < d) return cudaErrorInvalidValue;
  const bool uniform_codes = MODE == kUniform || (MODE == kStatic && ex.uniform);
  if (uniform_codes && !(ex.max_code <= 2048.f)) return cudaErrorInvalidValue;
  if (VEC && !vec_ok(q, k, MODE == kStats ? k : v, d, lay)) return cudaErrorInvalidValue;
  const int o_vec = MODE != kStats && reinterpret_cast<uintptr_t>(o) % 8 == 0 &&
                    lay.o_batch % 2 == 0 && lay.o_row % 2 == 0 && lay.slot % 2 == 0;
#define DGQ_QTF(NCH, NKS, NB, NPB) \
  return launch_quant_tf32<MODE, NCH, NKS, NB, NPB, VEC>(q, k, v, o, bh, t_len, s_len, d, scale, ex, lay, o_vec, stream)
  if (d <= 40) DGQ_QTF(2, 5, 40, 1);
  if (d <= 64) DGQ_QTF(2, 8, 64, 1);
  if (d <= 80) DGQ_QTF(3, 10, 80, 1);
  DGQ_QTF(5, 20, 80, 2);
#undef DGQ_QTF
}

// The flash entries: form 0 is body (b) and takes f32 only (the wrapper no
// longer picks it: it stays for timing the first version against body (d));
// forms 1 and 2 are body (a) and take bf16 only; forms 3 and 4 are body (d)
// and take f32 only.
int dispatch_flash(int form, int is_bf16, const void* q, const void* k, const void* v, void* o,
                   int bh, int t_len, int s_len, int d, float scale, const Layout& lay,
                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (form == 0 && !is_bf16)
    return dispatch<float, kFlash>(q, k, v, o, bh, t_len, s_len, d, scale, Extra{}, lay, st);
  if (form == 1 && is_bf16) return dispatch_tc<true>(q, k, v, o, bh, t_len, s_len, d, scale, lay, st);
  if (form == 2 && is_bf16) return dispatch_tc<false>(q, k, v, o, bh, t_len, s_len, d, scale, lay, st);
  if (form == 3 && !is_bf16) return dispatch_tf32<true>(q, k, v, o, bh, t_len, s_len, d, scale, lay, st);
  if (form == 4 && !is_bf16) return dispatch_tf32<false>(q, k, v, o, bh, t_len, s_len, d, scale, lay, st);
  return cudaErrorInvalidValue;
}

// The entries of K1, K3b and K4: form 0 is body (b), in f32 (K1 also in bf16,
// for head dims past 192 and codes past 256; the wrapper picks it in f32 only
// past head_dim 160 or past 2048 codes, and it stays for timing the first
// version against body (e)); forms 1 and 2 are body (c), bf16 only; forms 3
// and 4 are body (e), f32 only.
template <int MODE>
int dispatch_quant(int form, int is_bf16, const void* q, const void* k, const void* v, void* o,
                   int bh, int t_len, int s_len, int d, float scale, const Extra& ex,
                   const Layout& lay, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (form == 0 && !is_bf16)
    return dispatch<float, MODE>(q, k, v, o, bh, t_len, s_len, d, scale, ex, lay, st);
  if constexpr (MODE == kUniform) {
    if (form == 0) return dispatch<bf16, MODE>(q, k, v, o, bh, t_len, s_len, d, scale, ex, lay, st);
  }
  if (form == 1 && is_bf16)
    return dispatch_quant_tc<MODE, true>(q, k, v, o, bh, t_len, s_len, d, scale, ex, lay, st);
  if (form == 2 && is_bf16)
    return dispatch_quant_tc<MODE, false>(q, k, v, o, bh, t_len, s_len, d, scale, ex, lay, st);
  if (form == 3 && !is_bf16)
    return dispatch_quant_tf32<MODE, true>(q, k, v, o, bh, t_len, s_len, d, scale, ex, lay, st);
  if (form == 4 && !is_bf16)
    return dispatch_quant_tf32<MODE, false>(q, k, v, o, bh, t_len, s_len, d, scale, ex, lay, st);
  return cudaErrorInvalidValue;
}

float max_code_of(int sm_bits) { return static_cast<float>((1 << sm_bits) - 1); }

Extra uniform_extra(const void* delta, int sm_bits) {
  Extra ex{};
  ex.delta = static_cast<const float*>(delta);
  ex.max_code = max_code_of(sm_bits);
  return ex;
}

Extra stats_extra(void* z, void* red, int start_peak) {
  Extra ex{};
  ex.z = static_cast<float*>(z);
  ex.red = static_cast<int*>(red);
  ex.start_peak = start_peak;
  return ex;
}

Extra accum_extra(const void* z, const void* red, int sm_bits, int start_peak) {
  Extra ex = stats_extra(const_cast<void*>(z), const_cast<void*>(red), start_peak);
  ex.max_code = max_code_of(sm_bits);
  return ex;
}

Extra static_extra(const void* delta, int sm_bits, int uniform, int start_peak) {
  Extra ex = uniform_extra(delta, sm_bits);
  ex.uniform = uniform;
  ex.start_peak = start_peak;
  return ex;
}

}  // namespace

// C interface (loaded with ctypes). Each function returns a cudaError_t. Tensors
// are f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
//
// Classic layout: q (bh, t, d), k/v (bh, s, d), o (bh, t, d), all contiguous.
// form (every entry): 0 the CUDA-core body, 1 the tensor-core body with
// cp.async tiles, 2 the tensor-core body with element loads (bf16), 3 and 4
// the f32 tensor-core body (3xTF32) with 16-byte and with element loads.
extern "C" int dgq_flash_attention(const void* q, const void* k, const void* v, void* o, int bh,
                                   int t_len, int s_len, int d, float scale, int is_bf16,
                                   int form, void* stream) {
  return dispatch_flash(form, is_bf16, q, k, v, o, bh, t_len, s_len, d, scale,
                        classic_layout(t_len, s_len, d), stream);
}

// delta: device pointer to one f32; codes are clipped to 2^sm_bits - 1.
extern "C" int dgq_uniform_attention(const void* q, const void* k, const void* v, void* o,
                                     int bh, int t_len, int s_len, int d, float scale,
                                     const void* delta, int sm_bits, int is_bf16, int form,
                                     void* stream) {
  return dispatch_quant<kUniform>(form, is_bf16, q, k, v, o, bh, t_len, s_len, d, scale,
                                  uniform_extra(delta, sm_bits), classic_layout(t_len, s_len, d),
                                  stream);
}

// z: (bh, t) f32 out. red: one f32 on the device, set by the caller to +inf
// (start_peak = 0: ends as min l) or 0 (start_peak = 1: ends as the largest
// non-peak probability).
extern "C" int dgq_rt_stats(const void* q, const void* k, void* z, void* red, int bh, int t_len,
                            int s_len, int d, float scale, int start_peak, int is_bf16, int form,
                            void* stream) {
  return dispatch_quant<kStats>(form, is_bf16, q, k, nullptr, nullptr, bh, t_len, s_len, d,
                                scale, stats_extra(z, red, start_peak),
                                classic_layout(t_len, s_len, d), stream);
}

// z, red: as dgq_rt_stats left them (same stream, so the order holds).
extern "C" int dgq_quant_accum(const void* q, const void* k, const void* v, void* o,
                               const void* z, const void* red, int bh, int t_len, int s_len,
                               int d, float scale, int sm_bits, int start_peak, int is_bf16,
                               int form, void* stream) {
  return dispatch_quant<kAccum>(form, is_bf16, q, k, v, o, bh, t_len, s_len, d, scale,
                                accum_extra(z, red, sm_bits, start_peak),
                                classic_layout(t_len, s_len, d), stream);
}

// delta: device pointer to one f32. uniform = 0: log2 codes; 1: uniform codes
// (meant for start_peak = 1; without it dgq_uniform_attention is the kernel).
extern "C" int dgq_static_quant_attention(const void* q, const void* k, const void* v, void* o,
                                          int bh, int t_len, int s_len, int d, float scale,
                                          const void* delta, int sm_bits, int uniform,
                                          int start_peak, int is_bf16, int form, void* stream) {
  return dispatch_quant<kStatic>(form, is_bf16, q, k, v, o, bh, t_len, s_len, d, scale,
                                 static_extra(delta, sm_bits, uniform, start_peak),
                                 classic_layout(t_len, s_len, d), stream);
}

// Packed head-slot layout: q and o (b, t, heads * slot), k/v (b, s, heads * slot),
// the last axis contiguous. Head h of a row is its lanes [h * slot, h * slot + d);
// lanes d..slot of o are written as zeros. strides: host pointer to the batch and
// row strides of q, k, v, o in elements (q_batch, q_row, k_batch, ...; rt_stats
// reads the first four). z stays (b * heads, t). The other arguments are those of
// the classic entry above.
extern "C" int dgq_flash_attention_packed(const void* q, const void* k, const void* v, void* o,
                                          int b, int heads, int t_len, int s_len, int d,
                                          int slot, const long long* strides, float scale,
                                          int is_bf16, int form, void* stream) {
  return dispatch_flash(form, is_bf16, q, k, v, o, b * heads, t_len, s_len, d, scale,
                        packed_layout(heads, slot, strides), stream);
}

extern "C" int dgq_uniform_attention_packed(const void* q, const void* k, const void* v, void* o,
                                            int b, int heads, int t_len, int s_len, int d,
                                            int slot, const long long* strides, float scale,
                                            const void* delta, int sm_bits, int is_bf16, int form,
                                            void* stream) {
  return dispatch_quant<kUniform>(form, is_bf16, q, k, v, o, b * heads, t_len, s_len, d, scale,
                                  uniform_extra(delta, sm_bits),
                                  packed_layout(heads, slot, strides), stream);
}

extern "C" int dgq_rt_stats_packed(const void* q, const void* k, void* z, void* red, int b,
                                   int heads, int t_len, int s_len, int d, int slot,
                                   const long long* strides, float scale, int start_peak,
                                   int is_bf16, int form, void* stream) {
  const long long qk[8] = {strides[0], strides[1], strides[2], strides[3], 0, 0, 0, 0};
  return dispatch_quant<kStats>(form, is_bf16, q, k, nullptr, nullptr, b * heads, t_len, s_len,
                                d, scale, stats_extra(z, red, start_peak),
                                packed_layout(heads, slot, qk), stream);
}

extern "C" int dgq_quant_accum_packed(const void* q, const void* k, const void* v, void* o,
                                      const void* z, const void* red, int b, int heads,
                                      int t_len, int s_len, int d, int slot,
                                      const long long* strides, float scale, int sm_bits,
                                      int start_peak, int is_bf16, int form, void* stream) {
  return dispatch_quant<kAccum>(form, is_bf16, q, k, v, o, b * heads, t_len, s_len, d, scale,
                                accum_extra(z, red, sm_bits, start_peak),
                                packed_layout(heads, slot, strides), stream);
}

extern "C" int dgq_static_quant_attention_packed(const void* q, const void* k, const void* v,
                                                 void* o, int b, int heads, int t_len,
                                                 int s_len, int d, int slot,
                                                 const long long* strides, float scale,
                                                 const void* delta, int sm_bits, int uniform,
                                                 int start_peak, int is_bf16, int form,
                                                 void* stream) {
  return dispatch_quant<kStatic>(form, is_bf16, q, k, v, o, b * heads, t_len, s_len, d, scale,
                                 static_extra(delta, sm_bits, uniform, start_peak),
                                 packed_layout(heads, slot, strides), stream);
}
