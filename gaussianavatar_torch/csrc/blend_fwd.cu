// H-fwd: the tile alpha-blend forward of the Gaussian rasterizer, for Hopper
// (sm_90a), with a plain C interface (loaded through ctypes by
// gaussianavatar_torch/ops/rasterize_tile.py).
//
// Replaces the forward blend kernels of the JAX package, which all compute
// one function: gaussianavatar_tpu/ops/rasterize_tile.py `_fwd_kernel` (the
// sequential 8-unrolled blend) and `_fwd_kernel_vec` (the same function over
// 128-row chunks with an exclusive-cumprod scan), and
// gaussianavatar_tpu/ops/rasterize_ragged.py `_ragged_fwd_kernel` and
// `_ragged_fwd_kernel_vec` (the same with data-dependent per-tile caps).
// On the TPU those need fixed capacities (a tile blends at most K rows) or a
// static chunk budget; here a block walks its tile's whole depth-sorted
// range, and an optional per-tile cap reproduces the capped semantics.
//
// Semantics (gaussianavatar_torch/ops/rasterize_ref.blend_pixels):
//   - pixel coordinates are the integer pixel index (no +0.5);
//   - a row is skipped where power > 0 or alpha < 1/255;
//   - alpha is clamped at 0.99;
//   - a pixel stops BEFORE the row that would take T below 1e-4;
//   - n_contrib is the 1-based rank of the last row blended;
//   - a tile blends min(count, cap) rows.
//
// What bounds it on the H100: per binned (tile, gaussian) pair it reads a
// 4-byte id and a 64-byte parameter row (a gather by id, no locality), and
// per pixel it writes 6 words (rgb, T, n_contrib, done): at the render
// shapes (4 views of 1024^2, ~2.4M pairs) ~160 MB, 0.05 ms at 3.35 TB/s.
// The arithmetic, 16 f32 operations per (row, pixel) pair the alpha test
// cuts (~90% of the pairs walked there) and 26 per pair blended, is ~11
// GFLOP, 0.17 ms at the 67 TFLOP/s FP32 peak: the larger of the two. What
// limits it in practice is latency: the dependent gather of each batch of
// rows, and the serial per-pixel walk (T depends on the previous row),
// with at most two 1024-thread blocks per SM to hide it. This first design
// is simple: one block per tile, one thread per pixel, rows staged through
// shared memory in batches of blockDim, each thread gathering one row by
// its sorted id; the block leaves the tile once every pixel is done
// (__syncthreads_count). Prefetching the next batch (cp.async/TMA) and more
// pixels per thread are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPixels = 1024;  // one thread per pixel, tile side <= 32
constexpr int kRowWords = 16;     // packed row: mx,my | a,b,c | r,g,b | op | valid | pad
// the constants round from double exactly as PyTorch rounds a Python float
// against a float32 tensor
constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kAlphaMax = static_cast<float>(0.99);
constexpr float kTEps = static_cast<float>(1e-4);

__global__ void __launch_bounds__(kMaxPixels)
blend_fwd_kernel(const float* __restrict__ packed,
                 const int* __restrict__ sorted_vals,
                 const int* __restrict__ offsets,
                 const int* __restrict__ caps,   // nullptr = uncapped
                 int n_tiles, int txn, int ts,
                 float* __restrict__ color,      // (G, 3, ts*ts)
                 float* __restrict__ T_out,      // (G, ts*ts)
                 int* __restrict__ ncon_out,     // (G, ts*ts)
                 float* __restrict__ done_out) { // (G, ts*ts)
  __shared__ float s_mx[kMaxPixels], s_my[kMaxPixels];
  __shared__ float s_ca[kMaxPixels], s_cb[kMaxPixels], s_cc[kMaxPixels];
  __shared__ float s_r[kMaxPixels], s_g[kMaxPixels], s_b[kMaxPixels];
  __shared__ float s_op[kMaxPixels];

  const int g = blockIdx.x;         // global tile: view * n_tiles + local tile
  const int tid = threadIdx.x;      // pixel within the tile, row-major
  const int npx = blockDim.x;       // ts * ts
  const int local = g % n_tiles;
  const float px = static_cast<float>((local % txn) * ts + tid % ts);
  const float py = static_cast<float>((local / txn) * ts + tid / ts);

  const int start = offsets[g];
  int count = offsets[g + 1] - start;
  if (caps != nullptr) count = min(count, max(caps[g], 0));

  float T = 1.f, cr = 0.f, cg = 0.f, cb = 0.f;
  int nc = 0;
  bool done = false;
  for (int b0 = 0; b0 < count; b0 += npx) {
    // leave the tile once every pixel has terminated (uniform across the block)
    if (__syncthreads_count(done) == npx) break;
    const int k = b0 + tid;
    if (k < count) {
      const float* p = packed + static_cast<size_t>(sorted_vals[start + k]) * kRowWords;
      s_mx[tid] = p[0];
      s_my[tid] = p[1];
      s_ca[tid] = p[2];
      s_cb[tid] = p[3];
      s_cc[tid] = p[4];
      s_r[tid] = p[5];
      s_g[tid] = p[6];
      s_b[tid] = p[7];
      // an invalid row gets opacity 0: alpha 0 < 1/255 skips it
      s_op[tid] = p[9] > 0.f ? p[8] : 0.f;
    }
    __syncthreads();
    const int nb = min(npx, count - b0);
    for (int j = 0; j < nb && !done; ++j) {
      const float dx = px - s_mx[j];
      const float dy = py - s_my[j];
      const float power = -0.5f * (s_ca[j] * dx * dx + s_cc[j] * dy * dy) - s_cb[j] * dx * dy;
      if (power > 0.f) continue;
      const float alpha = fminf(s_op[j] * expf(power), kAlphaMax);
      if (alpha < kAlphaMin) continue;
      const float test_T = T * (1.f - alpha);
      if (test_T < kTEps) {
        done = true;
        break;
      }
      const float w = alpha * T;
      cr = cr + w * s_r[j];
      cg = cg + w * s_g[j];
      cb = cb + w * s_b[j];
      T = test_T;
      nc = b0 + j + 1;
    }
    __syncthreads();  // the next batch overwrites shared memory
  }

  const size_t base = static_cast<size_t>(g) * npx + tid;
  const size_t cbase = static_cast<size_t>(g) * 3 * npx + tid;
  color[cbase] = cr;
  color[cbase + npx] = cg;
  color[cbase + 2 * npx] = cb;
  T_out[base] = T;
  ncon_out[base] = nc;
  done_out[base] = done ? 1.f : 0.f;
}

}  // namespace

// Launch on `stream` over G = offsets.numel() - 1 tiles of ts x ts pixels.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ga_blend_fwd(const void* packed, const void* sorted_vals,
                            const void* offsets, const void* caps,
                            int G, int n_tiles, int txn, int ts,
                            void* color, void* T_out, void* ncon, void* done,
                            void* stream) {
  if (ts <= 0 || ts * ts > kMaxPixels) return static_cast<int>(cudaErrorInvalidValue);
  if (G > 0) {
    blend_fwd_kernel<<<G, ts * ts, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(packed), static_cast<const int*>(sorted_vals),
        static_cast<const int*>(offsets), static_cast<const int*>(caps),
        n_tiles, txn, ts,
        static_cast<float*>(color), static_cast<float*>(T_out),
        static_cast<int*>(ncon), static_cast<float*>(done));
  }
  return static_cast<int>(cudaGetLastError());
}
