// H-dfwd: the forward of a fused POP decoder stage, for Hopper (sm_90a),
// with a plain C interface (loaded through ctypes by
// gaussianavatar_torch/ops/decoder_stage.py `stage_fwd`).
//
// z = act(x Wp + bp) for x (R, C), the BatchNorm-folded weights Wp (C, 128)
// and bias bp (128,): the product accumulates in float32, and the bias and
// the activation (softplus or relu) run in the product's epilogue, so the
// pre-activation is never written. It has no Pallas counterpart: the JAX
// package's ShapeDecoderFused (gaussianavatar_tpu/models/decoder.py:220,
// `actv(inp.astype(cdt) @ Wp + bp)`) leaves the fusion to XLA.
//
// Rounding, as the JAX stage on the CPU and the plain version
// (`stage_fwd_plain`): bfloat16 mode rounds the float32 sum to bfloat16,
// adds the bias in bfloat16, and rounds after every operation of the
// activation (softplus: exp, log1p and the final sum); float32 mode adds
// the bias to the float32 sum and applies the activation in float32. Only
// the product's summation order differs from the plain version's cuBLAS.
//
// What bounds it on the H100: the bytes, reading x and writing z once (a
// 128-wide bfloat16 stage at R = 445,568: 114 + 114 MB, 0.068 ms at 3.35
// TB/s); the product's 2 R C 128 operations (14.6 GFLOP there, 0.015 ms on
// the bfloat16 tensor cores) sit under that. The design: a block keeps Wp
// in shared memory and walks 64-row tiles of x (grid-stride); bfloat16
// mode multiplies on the tensor cores (WMMA 16x16x16 bfloat16, float32
// accumulation; the decoder's first stage casts its float32 input to
// bfloat16 as it loads); float32 mode uses FFMA (no TF32: the plain
// version and the JAX stage are true float32). The epilogue stages the
// accumulators in shared memory and writes z in whole rows. A simple
// first version: no TMA, no wgmma, no overlap of a tile's loads with the
// previous tile's products. Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 11, 445,568 rows, 128 -> 128 bfloat16): 0.292 ms
// against the 0.068 ms bound, where cuBLAS's unfused addmm takes 0.095.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kThreads = 256;
constexpr int kH = 128;      // output columns (the decoder's hsize)
constexpr int kTile = 64;    // rows a block computes per tile
constexpr int kLdW = kH + 8; // bfloat16 Wp's shared-memory row (elements)
constexpr int kLdC = kH + 4; // the float32 accumulators' shared-memory row

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// softplus as jax.nn.softplus computes it: max(u, 0) + log1p(exp(-|u|))
__device__ __forceinline__ float softplus_f32(float u) {
  return fmaxf(u, 0.f) + log1pf(expf(-fabsf(u)));
}
// the same in bfloat16, rounded after every operation (u is a bfloat16)
__device__ __forceinline__ float softplus_bf16(float u) {
  return bf(fmaxf(u, 0.f) + bf(log1pf(bf(expf(-fabsf(u))))));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// bfloat16 mode. Shared memory: Wp (Kp x kLdW bfloat16, Kp = C rounded up
// to 16, zero rows past C), then one region that holds the x tile
// (kTile x (Kp + 8) bfloat16) while the products run and the accumulators
// (kTile x kLdC float32) in the epilogue.
template <typename TX, bool RELU>
__global__ void __launch_bounds__(kThreads)
stage_fwd_bf16(const TX* __restrict__ x, const __nv_bfloat16* __restrict__ Wp,
               const __nv_bfloat16* __restrict__ bp, int R, int C,
               __nv_bfloat16* __restrict__ z) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Kp = (C + 15) / 16 * 16;
  const int ldx = Kp + 8;
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Xs = Ws + static_cast<size_t>(Kp) * kLdW;
  float* Cs = reinterpret_cast<float*>(Xs);

  for (int e = threadIdx.x; e < Kp * kH; e += kThreads) {
    const int k = e / kH, n = e % kH;
    Ws[k * kLdW + n] = k < C ? Wp[static_cast<size_t>(k) * kH + n] : __float2bfloat16_rn(0.f);
  }
  // each thread writes the same two output columns in every tile
  const int col = 2 * (threadIdx.x % (kH / 2));
  const float2 bias = load2(bp + col);

  const int warp = threadIdx.x / 32;
  const int wr = warp % 4, wc = warp / 4;   // rows wr*16.., columns wc*64..
  const int n_tiles = (R + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * kTile;
    const int rows = min(kTile, R - r0);
    // the x tile as bfloat16, two columns a load (C is even), zero past C
    // and past the last row
    for (int e = threadIdx.x; e < kTile * (Kp / 2); e += kThreads) {
      const int row = e / (Kp / 2), c2 = 2 * (e % (Kp / 2));
      float2 v = make_float2(0.f, 0.f);
      if (row < rows && c2 < C) v = load2(x + static_cast<size_t>(r0 + row) * C + c2);
      *reinterpret_cast<__nv_bfloat162*>(Xs + row * ldx + c2) = __floats2bfloat162_rn(v.x, v.y);
    }
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) wmma::fill_fragment(acc[q], 0.f);
    for (int k = 0; k < Kp; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Xs + wr * 16 * ldx + k, ldx);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Ws + k * kLdW + wc * 64 + q * 16, kLdW);
        wmma::mma_sync(acc[q], a, b, acc[q]);
      }
    }
    __syncthreads();   // every warp is done with Xs, which Cs overwrites
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wmma::store_matrix_sync(Cs + wr * 16 * kLdC + wc * 64 + q * 16, acc[q], kLdC,
                              wmma::mem_row_major);
    __syncthreads();

    for (int row = threadIdx.x / (kH / 2); row < rows; row += kThreads / (kH / 2)) {
      float u0 = bf(bf(Cs[row * kLdC + col]) + bias.x);
      float u1 = bf(bf(Cs[row * kLdC + col + 1]) + bias.y);
      if (RELU) {
        u0 = fmaxf(u0, 0.f);
        u1 = fmaxf(u1, 0.f);
      } else {
        u0 = softplus_bf16(u0);
        u1 = softplus_bf16(u1);
      }
      *reinterpret_cast<__nv_bfloat162*>(z + static_cast<size_t>(r0 + row) * kH + col) =
          __floats2bfloat162_rn(u0, u1);
    }
    __syncthreads();   // Cs is the next tile's Xs
  }
}

// float32 mode: FFMA. Shared memory: Wp (C x kH float32), then the x tile
// (kTile x (C + 1) float32). Each thread computes 4 rows x 8 columns: two
// runs of 4 columns, 64 apart, so a warp's float4 reads of a Wp row are
// contiguous.
template <bool RELU>
__global__ void __launch_bounds__(kThreads)
stage_fwd_f32(const float* __restrict__ x, const float* __restrict__ Wp,
              const float* __restrict__ bp, int R, int C, float* __restrict__ z) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ws = reinterpret_cast<float*>(smem);
  float* Xs = Ws + static_cast<size_t>(C) * kH;
  const int ldx = C + 1;
  for (int e = threadIdx.x; e < C * kH; e += kThreads) Ws[e] = Wp[e];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float bias[8];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) bias[h * 4 + j] = bp[h * 64 + tx * 4 + j];

  const int n_tiles = (R + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * kTile;
    const int rows = min(kTile, R - r0);
    for (int e = threadIdx.x; e < kTile * C; e += kThreads) {
      const int row = e / C, c = e % C;
      Xs[row * ldx + c] = row < rows ? x[static_cast<size_t>(r0) * C + e] : 0.f;
    }
    __syncthreads();
    float acc[4][8] = {};
    for (int k = 0; k < C; ++k) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[(ty * 4 + i) * ldx + k];
      const float4 b0 = *reinterpret_cast<const float4*>(Ws + k * kH + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Ws + k * kH + 64 + tx * 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      if (row >= rows) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float u = acc[i][h * 4 + j] + bias[h * 4 + j];
          v[j] = RELU ? fmaxf(u, 0.f) : softplus_f32(u);
        }
        *reinterpret_cast<float4*>(z + static_cast<size_t>(r0 + row) * kH + h * 64 + tx * 4) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();   // the next tile overwrites Xs
  }
}

// One block per SM slot the shared memory leaves, at most one per tile.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int R, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_tiles = (R + kTile - 1) / kTile;
  const int grid = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  if (grid > 0) kernel<<<grid, kThreads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (R, C) contiguous, float32 (x_bf16 0) or bfloat16 (1), C even; Wp
// (C, H) and bp (H,) in the compute dtype (cdt_bf16: bfloat16, else
// float32, which needs float32 x); H must be 128. Writes z (R, H) in the
// compute dtype.
extern "C" int ga_decoder_stage_fwd(const void* x, int x_bf16, const void* Wp, const void* bp,
                                    int cdt_bf16, int relu, int R, int C, int H, void* z,
                                    void* stream) {
  if (R < 0 || C <= 0 || C % 2 || H != kH || (!cdt_bf16 && x_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    const int Kp = (C + 15) / 16 * 16;
    const size_t xs = static_cast<size_t>(kTile) * (Kp + 8) * sizeof(__nv_bfloat16);
    const size_t cs = static_cast<size_t>(kTile) * kLdC * sizeof(float);
    const size_t smem = static_cast<size_t>(Kp) * kLdW * sizeof(__nv_bfloat16) +
                        (xs > cs ? xs : cs);
    const auto* w = static_cast<const __nv_bfloat16*>(Wp);
    const auto* b = static_cast<const __nv_bfloat16*>(bp);
    auto* out = static_cast<__nv_bfloat16*>(z);
    if (x_bf16) {
      const auto* xx = static_cast<const __nv_bfloat16*>(x);
      return relu ? launch(stage_fwd_bf16<__nv_bfloat16, true>, smem, R, s, xx, w, b, R, C, out)
                  : launch(stage_fwd_bf16<__nv_bfloat16, false>, smem, R, s, xx, w, b, R, C, out);
    }
    const auto* xx = static_cast<const float*>(x);
    return relu ? launch(stage_fwd_bf16<float, true>, smem, R, s, xx, w, b, R, C, out)
                : launch(stage_fwd_bf16<float, false>, smem, R, s, xx, w, b, R, C, out);
  }
  const size_t smem = (static_cast<size_t>(C) * kH + static_cast<size_t>(kTile) * (C + 1)) *
                      sizeof(float);
  const auto* xx = static_cast<const float*>(x);
  const auto* w = static_cast<const float*>(Wp);
  const auto* b = static_cast<const float*>(bp);
  auto* out = static_cast<float*>(z);
  return relu ? launch(stage_fwd_f32<true>, smem, R, s, xx, w, b, R, C, out)
              : launch(stage_fwd_f32<false>, smem, R, s, xx, w, b, R, C, out);
}
