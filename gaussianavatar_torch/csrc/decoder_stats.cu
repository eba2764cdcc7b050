// H-dstat: the batch statistics of a fused POP decoder stage, for Hopper
// (sm_90a), with a plain C interface (loaded through ctypes by
// gaussianavatar_torch/ops/decoder_stage.py `column_stats`).
//
// One pass over a stage's input x (R, C), float32 or bfloat16, gives its
// column sums (C,) and its Gram x^T x (C, C), both accumulated in float32.
// The fused stage takes the pre-activation's batch mean and variance from
// them and the weights alone (models/decoder.ShapeDecoderFused), so the
// (R, 128) pre-activation is never written. It has no Pallas counterpart:
// the JAX package's ShapeDecoderFused (gaussianavatar_tpu/models/
// decoder.py:199-222) computes the same `jnp.mean` and `einsum` and leaves
// them to XLA.
//
// Deterministic: the rows are cut into n_split fixed ranges; a block sums
// its range's products for one 64 x 64 region of the Gram (and, for the
// regions of the first column, the region's column sums) in a fixed order
// and writes them to `work`; a second kernel adds the n_split partials in
// split order. No atomics, so two runs give the same bits.
//
// What bounds it on the H100: reading x once (a 128-wide bfloat16 stage at
// R = 445,568 is 114 MB, 0.034 ms at 3.35 TB/s) against the Gram's 2 R C^2
// operations (14.6 GFLOP there: 0.015 ms on the bfloat16 tensor cores at
// 989 TFLOP/s, but 0.22 ms in float32 at 67 TFLOP/s). The design: bfloat16
// input takes WMMA bfloat16 products on the tensor cores (exact products,
// float32 accumulation); float32 input (the decoder's first stage, and
// every stage of the float32 decoder) takes FFMA, with no TF32, since the
// plain version is true float32. A simple first version: a block stages 32
// rows of its region's two 64-column slices in shared memory per step, and
// every region block reads its columns again (L2 serves the repeats).
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 11, 445,568
// rows): 0.357 ms for a 128-wide bfloat16 input against the 0.034 ms bound,
// 1.361 ms for the 194-wide skip stage (16 regions re-read the input);
// fusing the statistics into the previous stage's epilogue, 16-byte loads
// and the Gram's symmetric half are the levers left.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegion = 64;  // a block's Gram region: 64 x 64
constexpr int kRows = 32;    // rows staged per step

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename S> __device__ __forceinline__ S from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // exact: v came from a bfloat16
}

// Stage rows [r, r + kRows) of columns [i0, i0 + 64) into As and of
// [j0, j0 + 64) into Bs (zero past the range's end and past C). Each
// thread always loads the same column (256 % 64 == 0), so it adds what it
// loads into `csum`, its share of that column's sum.
template <typename T, typename S, int LD>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, int r, int r_end, int C,
                                           int i0, int j0, S (*As)[LD], S (*Bs)[LD],
                                           float& csum) {
  const int col = threadIdx.x % kRegion;
#pragma unroll
  for (int q = 0; q < kRows * kRegion / kThreads; ++q) {
    const int row = threadIdx.x / kRegion + q * (kThreads / kRegion);
    const int rr = r + row;
    const bool in_rows = rr < r_end;
    float a = 0.f, b = 0.f;
    if (in_rows && i0 + col < C) a = to_float(x[static_cast<size_t>(rr) * C + i0 + col]);
    if (in_rows && j0 + col < C) b = to_float(x[static_cast<size_t>(rr) * C + j0 + col]);
    csum += a;
    As[row][col] = from_float<S>(a);
    Bs[row][col] = from_float<S>(b);
  }
}

// The column sums' partials: the 4 threads of each column, added in a fixed
// order, written by the blocks of the Gram's first column of regions.
__device__ __forceinline__ void write_colsum(float csum, int i0, int C, float* partial,
                                             float* red) {
  red[threadIdx.x] = csum;
  __syncthreads();
  if (threadIdx.x < kRegion && i0 + threadIdx.x < C) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kThreads / kRegion; ++k) s += red[threadIdx.x + k * kRegion];
    partial[static_cast<size_t>(C) * C + i0 + threadIdx.x] = s;
  }
}

// float32 input: FFMA, each thread a 4 x 4 block of the region.
__global__ void __launch_bounds__(kThreads)
stats_partial_f32(const float* __restrict__ x, int R, int C, int rows_per_split,
                  float* __restrict__ work) {
  constexpr int LD = kRegion + 4;
  __shared__ __align__(16) float As[kRows][LD];
  __shared__ __align__(16) float Bs[kRows][LD];
  __shared__ float red[kThreads];
  const int n_reg = (C + kRegion - 1) / kRegion;
  const int i0 = (blockIdx.y / n_reg) * kRegion, j0 = (blockIdx.y % n_reg) * kRegion;
  const int r_begin = blockIdx.x * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float total[4][4] = {};
  float csum = 0.f;
  for (int r = r_begin; r < r_end; r += kRows) {
    stage_rows<float, float, LD>(x, r, r_end, C, i0, j0, As, Bs, csum);
    __syncthreads();
    // each step's 32 products in a sum of their own, then added to the
    // total: no chain of roundings is longer than the rows of one step
    float acc[4][4] = {};
#pragma unroll 8
    for (int k = 0; k < kRows; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) total[i][j] += acc[i][j];
    __syncthreads();
  }
  float* partial = work + static_cast<size_t>(blockIdx.x) * (static_cast<size_t>(C) * C + C);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = j0 + tx * 4 + j;
      if (gi < C && gj < C) partial[static_cast<size_t>(gi) * C + gj] = total[i][j];
    }
  }
  if (j0 == 0) write_colsum(csum, i0, C, partial, red);
}

// bfloat16 input: WMMA 16x16x16 bfloat16 products with float32
// accumulation; 8 warps, each two 16 x 16 tiles of the region. A = x^T is
// the staged slice read column-major, B = x the other slice row-major.
__global__ void __launch_bounds__(kThreads)
stats_partial_bf16(const __nv_bfloat16* __restrict__ x, int R, int C, int rows_per_split,
                   float* __restrict__ work) {
  using namespace nvcuda;
  constexpr int LD = kRegion + 8;   // a multiple of 8 elements, as WMMA needs
  constexpr int LDC = kRegion + 4;
  __shared__ __align__(128) __nv_bfloat16 As[kRows][LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[kRows][LD];
  __shared__ __align__(128) float Cs[kRegion][LDC];
  __shared__ float red[kThreads];
  const int n_reg = (C + kRegion - 1) / kRegion;
  const int i0 = (blockIdx.y / n_reg) * kRegion, j0 = (blockIdx.y % n_reg) * kRegion;
  const int r_begin = blockIdx.x * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  const int warp = threadIdx.x / 32;
  const int fi = warp / 2, fj = (warp % 2) * 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2], total[2];
  wmma::fill_fragment(total[0], 0.f);
  wmma::fill_fragment(total[1], 0.f);
  float csum = 0.f;
  for (int r = r_begin; r < r_end; r += kRows) {
    stage_rows<__nv_bfloat16, __nv_bfloat16, LD>(x, r, r_end, C, i0, j0, As, Bs, csum);
    __syncthreads();
    // each step's products summed on the tensor cores from zero, then
    // added to the total in float32 (round to nearest): the tensor cores'
    // own accumulation, which drifts over long chains, never runs longer
    // than one step
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
    for (int k = 0; k < kRows; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
      wmma::load_matrix_sync(a, &As[k][fi * 16], LD);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, &Bs[k][(fj + q) * 16], LD);
        wmma::mma_sync(acc[q], a, b, acc[q]);
      }
    }
    // the two fragments share the accumulator's layout, element by element
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < acc[q].num_elements; ++e) total[q].x[e] += acc[q].x[e];
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
    wmma::store_matrix_sync(&Cs[fi * 16][(fj + q) * 16], total[q], LDC, wmma::mem_row_major);
  __syncthreads();
  float* partial = work + static_cast<size_t>(blockIdx.x) * (static_cast<size_t>(C) * C + C);
  for (int e = threadIdx.x; e < kRegion * kRegion; e += kThreads) {
    const int gi = i0 + e / kRegion, gj = j0 + e % kRegion;
    if (gi < C && gj < C) partial[static_cast<size_t>(gi) * C + gj] = Cs[e / kRegion][e % kRegion];
  }
  if (j0 == 0) write_colsum(csum, i0, C, partial, red);
}

// The partials of every split, added in split order: Gram then column sums.
__global__ void stats_reduce(const float* __restrict__ work, int n_split, int C,
                             float* __restrict__ colsum, float* __restrict__ gram) {
  const size_t n = static_cast<size_t>(C) * C + C;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int p = 0; p < n_split; ++p) s += work[static_cast<size_t>(p) * n + idx];
  if (idx < static_cast<size_t>(C) * C) {
    gram[idx] = s;
  } else {
    colsum[idx - static_cast<size_t>(C) * C] = s;
  }
}

}  // namespace

// x (R, C) contiguous, float32 (x_bf16 0) or bfloat16 (1); rows cut into
// n_split ranges of rows_per_split (a multiple of 32); work holds
// n_split x (C * C + C) floats. Writes colsum (C,) and gram (C, C), float32.
extern "C" int ga_decoder_stats(const void* x, int x_bf16, int R, int C, int n_split,
                                int rows_per_split, void* work, void* colsum, void* gram,
                                void* stream) {
  if (R < 0 || C <= 0 || n_split <= 0 || rows_per_split <= 0 || rows_per_split % kRows ||
      static_cast<long long>(n_split) * rows_per_split < R) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_reg = (C + kRegion - 1) / kRegion;
  const dim3 grid(n_split, n_reg * n_reg);
  if (x_bf16) {
    stats_partial_bf16<<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x), R, C,
                                                 rows_per_split, static_cast<float*>(work));
  } else {
    stats_partial_f32<<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), R, C,
                                                rows_per_split, static_cast<float*>(work));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(C) * C + C;
  stats_reduce<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(work), n_split, C, static_cast<float*>(colsum),
      static_cast<float*>(gram));
  return static_cast<int>(cudaGetLastError());
}
