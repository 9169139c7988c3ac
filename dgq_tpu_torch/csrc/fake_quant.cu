// Fused activation fake quantization for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the quantize-dequantize of
// an activation to XLA, which fuses it into one pass. Eager PyTorch runs
// `quant/affine.py:fake_quant` as eight launches (the two clip bounds, x /
// delta, the straight-through round's three passes, the clip, delta * q), six
// of which stream the whole activation: 14 bytes moved for every byte
// quantized. `fake_quant_kernel` does it in one pass, one read and one write.
//
// Per element, in f32, in the plain version's order of operations, so that
// the bits are the same:
//     r   = x / delta                     (an IEEE division, as PyTorch's)
//     q   = r + (rint(r) - r)             (ste_round's forward value: it is
//                                          rint(r) but for -0.0 -> +0.0 and
//                                          +-inf -> NaN)
//     q   = clamp(q, nb - zp, pb - zp)    (torch.clamp: a NaN operand wins)
//     out = delta * q
// delta and zp are one value each or a vector over the last axis, read
// through a pointer (a time slot's view) and an element step. A group
// quantizer (DGQ's `GroupQParams`) adds a second factor over axis -2, one
// value or a vector over the quantized rows, and the chain's broadcast
// product and sum make each element's parameters:
//     delta = delta_mid[row] * delta[col],  zp = zp_mid[row] + zp[col].
//
// What bounds it on the H100: bytes (the division is a dozen instructions an
// element against 4 + 4 bytes moved). The input is read through its strides
// and the output written contiguous in the input's logical order, so a
// permuted (b, h, t, d) view of q, k or v comes out as the contiguous tensor
// the attention kernels take. `dispatch` picks the loop from the shape, the
// strides and the address:
//   a contiguous x on a 16-byte boundary: 16-byte vectors over the flat
//     array, a scalar tail (vectors may span rows where one delta and zero
//     point serve every element and no rows pass through);
//   a strided x on a 16-byte boundary whose last axis is unit-stride, whose
//     rows hold whole vectors and whose other strides keep them aligned: the
//     same vectors, each row's address from its index;
//   any other: one element a thread.
// One vector a thread, in blocks of 256, as many blocks as the vectors fill:
// on the H100 that read 87.7% of the bytes bound at the SD GEGLU output, where
// a grid-stride loop over 8 blocks an SM read 74.3% (77.9% with 4 vectors a
// thread loaded before any is quantized).
//
// start_rows: the first rows along axis -2 pass through unquantized,
// widened to f32 (the start-peak key row, which `torch.cat` used to put back).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct FqArgs {
  const void* x;
  float* out;
  const float* delta;
  const float* zp;
  long long delta_step, zp_step;  // 0: one value; else the step over the last axis
  const float* delta_mid;         // null, or the factors over the quantized rows
  const float* zp_mid;
  long long dmid_step, zmid_step;  // 0: one value; else the step over axis -2
  float nb, pb;
  unsigned start_rows;
  unsigned n;                     // elements, < 2^31
  unsigned size[4];               // the logical shape, padded in front to rank 4
  long long stride[4];            // x's element strides
};

__device__ __forceinline__ float quant(float v, float d, float z, float nb, float pb) {
  const float lo = nb - z, hi = pb - z;
  const float r = v / d;
  float q = r + (rintf(r) - r);
  if (!isnan(q)) q = isnan(lo) ? lo : isnan(hi) ? hi : fminf(fmaxf(q, lo), hi);
  return d * q;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// V consecutive elements from logical index e (a multiple of V): e's row
// along axis -2 and column along axis -1 where they are needed, its offset in
// x (e itself where x is contiguous, kFlat), then the quantized values. V > 1
// only where a row holds whole vectors, so the V elements share the row and
// the columns run on. uniform: one delta and one zero point for every
// element, d0 and z0.
template <typename T, int V, bool kFlat>
__device__ __forceinline__ void run(const FqArgs& a, unsigned e, bool need_index, bool uniform,
                                    float d0, float z0) {
  long long off = e;
  unsigned i3 = 0, i2 = 0;
  if (need_index) {
    const unsigned r3 = e / a.size[3];
    i3 = e - r3 * a.size[3];
    const unsigned r2 = r3 / a.size[2];
    i2 = r3 - r2 * a.size[2];
    if (!kFlat) {
      const unsigned i0 = r2 / a.size[1];
      const unsigned i1 = r2 - i0 * a.size[1];
      off = i0 * a.stride[0] + i1 * a.stride[1] + i2 * a.stride[2] + i3 * a.stride[3];
    }
  }
  const Pack<T, V> in = *reinterpret_cast<const Pack<T, V>*>(static_cast<const T*>(a.x) + off);
  const bool pass = i2 < a.start_rows;
  Pack<float, V> res;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float v = to_f32(in.v[k]);
    if (pass) {
      res.v[k] = v;
    } else if (uniform) {
      res.v[k] = quant(v, d0, z0, a.nb, a.pb);
    } else {
      float d = a.delta[(i3 + k) * a.delta_step], z = a.zp[(i3 + k) * a.zp_step];
      if (a.delta_mid) {
        const unsigned row = i2 - a.start_rows;
        d = a.delta_mid[row * a.dmid_step] * d;
        z = a.zp_mid[row * a.zmid_step] + z;
      }
      res.v[k] = quant(v, d, z, a.nb, a.pb);
    }
  }
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<Pack<float, 4>*>(a.out + e + k) =
          *reinterpret_cast<const Pack<float, 4>*>(res.v + k);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) a.out[e + k] = res.v[k];
  }
}

// A thread a vector; in the flat form the threads past the last whole vector
// take the tail's elements, one each.
template <typename T, int V, bool kFlat>
__global__ void __launch_bounds__(kThreads) fake_quant_kernel(FqArgs a) {
  // the flat form needs an element's row and column only for vector
  // parameters or start rows; the strided forms always need its offset
  const bool uniform = a.delta_step == 0 && a.zp_step == 0 && a.dmid_step == 0 &&
                       a.zmid_step == 0;
  const bool need_index = !kFlat || !uniform || a.start_rows > 0;
  float d0 = a.delta[0], z0 = a.zp[0];
  if (a.delta_mid) {
    d0 = a.delta_mid[0] * d0;
    z0 = a.zp_mid[0] + z0;
  }
  const unsigned nvec = a.n / V, v = blockIdx.x * kThreads + threadIdx.x;
  if (v < nvec)
    run<T, V, kFlat>(a, v * V, need_index, uniform, d0, z0);
  else if (kFlat && V > 1 && v - nvec < a.n - nvec * V)
    run<T, 1, true>(a, nvec * V + (v - nvec), need_index, uniform, d0, z0);
}

template <typename T, int V, bool kFlat>
int launch(const FqArgs& a, cudaStream_t st) {
  const unsigned nvec = a.n / V, items = nvec + (kFlat ? a.n - nvec * V : 0);
  fake_quant_kernel<T, V, kFlat><<<(items + kThreads - 1) / kThreads, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const FqArgs& a, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  const bool vector_rows = a.size[3] % kVec == 0;
  bool contiguous = true;
  long long dense = 1;  // the stride of a contiguous tensor (any, where the size is 1)
  for (int i = 3; i >= 0; --i) {
    contiguous &= a.size[i] == 1 || a.stride[i] == dense;
    dense *= a.size[i];
  }
  const bool one_row_each = a.delta_step == 0 && a.zp_step == 0 && a.dmid_step == 0 &&
                            a.zmid_step == 0 && a.start_rows == 0;
  if (aligned && contiguous && (one_row_each || vector_rows)) return launch<T, kVec, true>(a, st);
  bool strided_vector = aligned && vector_rows && a.stride[3] == 1;
  for (int i = 0; i < 3; ++i) strided_vector &= a.size[i] == 1 || a.stride[i] % kVec == 0;
  if (strided_vector) return launch<T, kVec, false>(a, st);
  return launch<T, 1, false>(a, st);
}

}  // namespace

// x: (s0, s1, s2, s3) through the element strides (t0, ..., t3), f32 or bf16
// (is_bf16); out: the same shape, contiguous, f32. delta, zp: f32, one value
// each (step 0) or a vector over the last axis through its step; delta_mid,
// zp_mid: null, or the group factors over the quantized rows (one value each,
// step 0, or a vector through its step). nb, pb: the integer clip bounds. device: the card the tensors and the stream are on
// (made current for the launch). Returns the CUDA error of the launch (0:
// none).
extern "C" int dgq_fake_quant(const void* x, void* out, const void* delta, const void* zp,
                              long long delta_step, long long zp_step, const void* delta_mid,
                              const void* zp_mid, long long dmid_step, long long zmid_step,
                              long long s0, long long s1,
                              long long s2, long long s3, long long t0, long long t1, long long t2,
                              long long t3, int nb, int pb, int start_rows, int is_bf16, int device,
                              void* stream) {
  const long long n = s0 * s1 * s2 * s3;
  if (s0 < 1 || s1 < 1 || s2 < 1 || s3 < 1 || n >= (1ll << 31) || start_rows < 0 ||
      delta_step < 0 || zp_step < 0 || dmid_step < 0 || zmid_step < 0 ||
      (delta_mid == nullptr) != (zp_mid == nullptr) || device < 0)
    return cudaErrorInvalidValue;
  FqArgs a;
  a.x = x;
  a.out = static_cast<float*>(out);
  a.delta = static_cast<const float*>(delta);
  a.zp = static_cast<const float*>(zp);
  a.delta_step = delta_step;
  a.zp_step = zp_step;
  a.delta_mid = static_cast<const float*>(delta_mid);
  a.zp_mid = static_cast<const float*>(zp_mid);
  a.dmid_step = delta_mid ? dmid_step : 0;
  a.zmid_step = zp_mid ? zmid_step : 0;
  a.nb = static_cast<float>(nb);
  a.pb = static_cast<float>(pb);
  a.start_rows = static_cast<unsigned>(start_rows);
  a.n = static_cast<unsigned>(n);
  const long long size[4] = {s0, s1, s2, s3}, stride[4] = {t0, t1, t2, t3};
  for (int i = 0; i < 4; ++i) {
    a.size[i] = static_cast<unsigned>(size[i]);
    a.stride[i] = stride[i];
  }
  int current = 0;
  int rc = cudaGetDevice(&current);
  if (rc == cudaSuccess && current != device) rc = cudaSetDevice(device);
  if (rc == cudaSuccess) {
    auto st = static_cast<cudaStream_t>(stream);
    rc = is_bf16 ? dispatch<__nv_bfloat16>(a, st) : dispatch<float>(a, st);
  }
  if (current != device) cudaSetDevice(current);
  return rc;
}
