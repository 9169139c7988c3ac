// The port's f32 linear, y = x w^T + b, on the tensor cores: each product of
// f32 numbers formed from three TF32 products (`split` below), so the result
// keeps the f32 accuracy of the port's other f32 bodies (K2, K3b, K5) where
// the library's f32 product runs on the CUDA cores.
//
// Replaces no TPU kernel: the JAX package leaves its linears to XLA's dot. It
// is bound by operations at every main-path shape: 2 M N K operations as
// three TF32 products at 495 TFLOP/s, a ceiling of 165 TFLOP/s of f32 work,
// against the 67 TFLOP/s of the f32 cores.
//
// x (M, K) and w (N, K) are both K-major as they lie in memory, which is the
// only orientation `wgmma` takes for TF32 operands, so neither is copied or
// transposed, and no split copy of the weights is kept. A block is persistent
// (one a SM, at most one a tile) and walks the output tiles of 128 rows by BN
// columns (128, or 64 where the 128-wide tiles would leave SMs idle:
// `ops/linear_gemm.py:gemm_plan`), in groups of GROUP row tiles so that the
// blocks in flight share their x and w panels in L2. Three warpgroups:
//   * the producer (warpgroup 2): its first warp is the loader, one thread
//     that keeps TMA loads of raw f32 tiles in flight into a ring of kStages
//     shared-memory stages (x: 128 x 32, w: BN x 32, 128-byte rows under the
//     128-byte swizzle), as far ahead as the consumers free them; its other
//     three warps split each stage's w tile into its TF32 big part (in place)
//     and small part (beside it), once for all the tile's rows, and mark the
//     stage full;
//   * two consumers (warpgroups 0 and 1, 64 rows each): read their x rows of
//     the stage into registers, split them there, and issue a k8 step's three
//     products `Tf32<BN>::rs` (small terms first), then free the stage.
// The tensor cores add into the accumulator rounding toward zero, so a long
// chain of adds drifts toward zero (about an ulp an add: 2304 adds a row at
// K 6144); every stage's 12 products start a fresh chain, which is added to
// the f32 accumulator in registers, rounded to nearest. The two consumers
// take turns at the tensor cores (named barriers): one issues its chain only
// after the other has issued, so the chains queue one behind the other and
// one consumer's wait, adds and next fragments hide under the other's
// products. Ragged M, N and K: TMA fills the rows and columns past the tensor
// with zeros, and the epilogue stores only the rows and columns inside it,
// with the bias added in f32 (one add, as `F.linear` then `+ b`), while the
// producer already loads the next tile.
//
// What each piece bought at SD3's shapes (H100, share of the 3xTF32 bound):
// 38% with one thread of the splitters issuing the loads two stages ahead
// (the loads' latency bounded it); 46% with big's rounding as an integer add
// in place of `cvt.rna.tf32.f32`; 62% to 70% with a loader warp of its own
// and the whole ring in flight; 64% to 74% with small's rounding left to the
// tensor cores (the splitters bound it; a NaN test in the split had cost 1 to
// 5 points); the turns, 1 to 3 points at the FF shapes (K or N 6144) and
// within the noise elsewhere.
#include <cstdint>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BM = 128;                 // output rows a tile: two consumers of 64
constexpr int BK = 32;                  // contraction a stage: one 128-byte row of f32
constexpr int GROUP = 8;                // row tiles walked together (L2 reuse)
constexpr int kThreads = 384;           // consumers 0 and 1, producer 2
constexpr int kSplitters = 96;          // the producer's threads past its loader warp
constexpr int kStageX = BM * BK * 4;    // 16 KB of raw x

template <int BN> struct Plan {
  static constexpr int kStageW = BN * BK * 4;           // one part of w
  static constexpr int kStage = kStageX + 2 * kStageW;  // x, w big (in place), w small
  static constexpr int kStages = BN == 128 ? 4 : 6;     // 192 KB either way
  static constexpr int kSmem = 1024 + kStages * kStage; // the ring, 1024-byte aligned
};

// x = big + small as TF32 words: big = rna(x), rounded as an integer add on
// the bit pattern (the magnitude plus half the dropped unit, cut: the bits of
// `cvt.rna.tf32.f32` on every number, at a fraction of its cost), and small =
// x - big, exact in f32, whose low 13 bits the tensor cores do not read (so
// it is cut to TF32 there, where wgmma.cuh's `split_tf32` rounds it: the
// part left out is below 2^-21 |x| either way). A NaN x gives a NaN small
// part, and so a NaN product, as the library's, even where the add carries
// big's NaN into the sign bit.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));
}

// row tile and column tile of output tile `tile`: groups of GROUP row tiles,
// column by column inside a group
__device__ __forceinline__ void tile_at(int tile, int tiles_m, int tiles_n, int& tm, int& tn) {
  const int group = tile / (GROUP * tiles_n), first = group * GROUP;
  const int rows = min(GROUP, tiles_m - first), r = tile - group * GROUP * tiles_n;
  tm = first + r % rows;
  tn = r / rows;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
linear_tf32x3_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          const float* __restrict__ bias, float* __restrict__ out, int m, int n,
                          int k, int tiles_m, int tiles_n) {
  using P = Plan<BN>;
  extern __shared__ uint8_t smem_raw[];
  // per stage: loaded (the TMA's bytes), full (w split), empty (consumed)
  __shared__ __align__(8) uint64_t bars[3 * P::kStages];
  const uint32_t ring = (tc::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar0 = tc::smem_u32(bars);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      tc::mbar_init(bar0 + 8 * s, 1);
      tc::mbar_init(bar0 + 8 * (P::kStages + s), kSplitters);
      tc::mbar_init(bar0 + 8 * (2 * P::kStages + s), 8);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();
  const int ksteps = (k + BK - 1) / BK, tiles = tiles_m * tiles_n;
  const int my_tiles = tiles > (int)blockIdx.x ? (tiles - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  const int stages = my_tiles * ksteps;

  if (tid >= 256) {
    // ---- producer: loads and the split of w ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid < 256 + 32) {
      // the loader: up to kStages stages ahead, as fast as the consumers free them
      if (tid == 256) {
        for (int j = 0; j < stages; ++j) {
          const int s = j % P::kStages, kt = j % ksteps;
          int tm, tn;
          tile_at(blockIdx.x + (j / ksteps) * gridDim.x, tiles_m, tiles_n, tm, tn);
          tc::mbar_wait(bar0 + 8 * (2 * P::kStages + s), ((j / P::kStages) & 1) ^ 1);
          const uint32_t loaded = bar0 + 8 * s, st = ring + s * P::kStage;
          tc::mbar_expect_tx(loaded, kStageX + P::kStageW);
          tc::tma_load(st, &xmap, loaded, kt * BK, tm * BM);
          tc::tma_load(st + kStageX, &wmap, loaded, kt * BK, tn * BN);
        }
      }
    } else {
      // the splitters: three warps
      const int p = tid - 256 - 32;
      for (int j = 0; j < stages; ++j) {
        const int s = j % P::kStages;
        tc::mbar_wait(bar0 + 8 * s, (j / P::kStages) & 1);
        const uint32_t w = ring + s * P::kStage + kStageX;
#pragma unroll 4
        for (int c = p; c < BN * 8; c += kSplitters) {  // 16-byte chunks, wherever the swizzle put them
          const uint4 v = tc::ld_shared16(w + 16 * c);
          uint4 big, small;
          split(__uint_as_float(v.x), big.x, small.x);
          split(__uint_as_float(v.y), big.y, small.y);
          split(__uint_as_float(v.z), big.z, small.z);
          split(__uint_as_float(v.w), big.w, small.w);
          tc::st_shared16(w + 16 * c, big);
          tc::st_shared16(w + P::kStageW + 16 * c, small);
        }
        tc::fence_async_proxy();  // the products read the parts through the async proxy
        tc::mbar_arrive(bar0 + 8 * (P::kStages + s));
      }
    }
  } else {
    // ---- consumers: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    float acc[BN / 2], chain[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) chain[i] = 0.f;  // each chain's first product overwrites it
    if (wg == 1 && stages > 0) tc::named_arrive(1);  // consumer 0 issues first
    int j = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int tm, tn;
      tile_at(tile, tiles_m, tiles_n, tm, tn);
      for (int kt = 0; kt < ksteps; ++kt, ++j) {
        const int s = j % P::kStages;
        tc::mbar_wait(bar0 + 8 * (P::kStages + s), (j / P::kStages) & 1);
        const uint32_t st = ring + s * P::kStage;
        // this thread's A fragments (rows 16 warp + g and + 8; row & 7 = g):
        // k8 step ks holds columns 8 ks + t4 (chunk 2 ks) and + 4 (chunk 2 ks + 1)
        const uint32_t xrow = st + wg * 8192 + (warp * 16 + g) * 128 + 4 * t4;
        uint32_t abig[4][4], asmall[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint32_t lo = xrow + (((2 * ks) ^ g) << 4), hi = xrow + (((2 * ks + 1) ^ g) << 4);
          split(tc::ld_shared_f32(lo), abig[ks][0], asmall[ks][0]);
          split(tc::ld_shared_f32(lo + 1024), abig[ks][1], asmall[ks][1]);
          split(tc::ld_shared_f32(hi), abig[ks][2], asmall[ks][2]);
          split(tc::ld_shared_f32(hi + 1024), abig[ks][3], asmall[ks][3]);
        }
        const uint32_t wbig = st + kStageX, wsmall = wbig + P::kStageW;
        tc::named_sync(1 + wg);  // the other consumer has issued its chain
        tc::mma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          tc::Tf32<BN>::rs(chain, asmall[ks], tc::desc(wbig + 32 * ks), ks > 0);
          tc::Tf32<BN>::rs(chain, abig[ks], tc::desc(wsmall + 32 * ks), 1);
          tc::Tf32<BN>::rs(chain, abig[ks], tc::desc(wbig + 32 * ks), 1);
        }
        tc::mma_commit();
        if (wg == 0 || j + 1 < stages) tc::named_arrive(2 - wg);  // its turn
        tc::mma_wait<0>();
        tc::pin(chain);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          tc::pin(abig[ks]);
          tc::pin(asmall[ks]);
        }
        __syncwarp();
        if (lane == 0) tc::mbar_arrive(bar0 + 8 * (2 * P::kStages + s));
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = kt ? __fadd_rn(acc[i], chain[i]) : chain[i];
      }
      // epilogue: acc + bias, f32, the rows and columns inside the output
      const int r0 = tm * BM + wg * 64 + warp * 16 + g;
#pragma unroll
      for (int jb = 0; jb < BN / 8; ++jb) {
        const int col = tn * BN + 8 * jb + 2 * t4;  // N is a multiple of 4
        if (col >= n) continue;
        const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r0 + 8 * half;
          if (row >= m) continue;
          const float v0 = acc[4 * jb + 2 * half], v1 = acc[4 * jb + 2 * half + 1];
          *reinterpret_cast<float2*>(out + (size_t)row * n + col) =
              bias ? make_float2(__fadd_rn(v0, b0), __fadd_rn(v1, b1)) : make_float2(v0, v1);
        }
      }
    }
  }
}

// a row-major f32 matrix (rows, k), row stride `stride` elements, read in
// boxes of `box_rows` x 32 under the 128-byte swizzle; zeros past its edges
bool encode(CUtensorMap* map, const void* base, long long rows, int k, long long stride,
            int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(box_rows)};
  return tc::encode_f32(map, base, 2, dims, strides, box);
}

template <int BN>
int launch(const void* x, const void* w, const float* bias, float* out, int m, int n, int k,
           long long x_stride, long long w_stride, int grid, cudaStream_t stream) {
  using P = Plan<BN>;
  CUtensorMap xmap, wmap;
  if (!encode(&xmap, x, m, k, x_stride, BM) || !encode(&wmap, w, n, k, w_stride, BN))
    return cudaErrorInvalidValue;
  static bool sized = false;  // the shared-memory attribute, once a process
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        linear_tf32x3_gemm_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  linear_tf32x3_gemm_kernel<BN><<<grid, kThreads, P::kSmem, stream>>>(
      xmap, wmap, bias, out, m, n, k, (m + BM - 1) / BM, (n + BN - 1) / BN);
  return cudaGetLastError();
}

}  // namespace

// y (m, n) = x (m, k) w (n, k)^T + bias (n, or null), all f32 on the device;
// rows of x and w `x_stride` and `w_stride` elements apart, y contiguous.
// bn: the tile's columns (64 or 128); grid: the persistent blocks. Returns a
// cudaError_t (cudaErrorInvalidValue for what the kernel does not take).
extern "C" int dgq_linear_gemm(const void* x, const void* w, const void* bias, void* out,
                               long long m, int n, int k, long long x_stride, long long w_stride,
                               int bn, int grid, void* stream) {
  if (m < 1 || m >= (1LL << 31) || n < 4 || n % 4 || k < 4 || k % 4 || x_stride < k ||
      x_stride % 4 || w_stride < k || w_stride % 4 || grid < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || reinterpret_cast<uintptr_t>(bias) % 4)
    return cudaErrorInvalidValue;
  auto bp = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  auto op = static_cast<float*>(out);
  const int mi = static_cast<int>(m);
  if (bn == 128) return launch<128>(x, w, bp, op, mi, n, k, x_stride, w_stride, grid, st);
  if (bn == 64) return launch<64>(x, w, bp, op, mi, n, k, x_stride, w_stride, grid, st);
  return cudaErrorInvalidValue;
}
