// H-bwd: the gradient of the tile alpha blend of the Gaussian rasterizer, for
// Hopper (sm_90a), with a plain C interface (loaded through ctypes by
// gaussianavatar_torch/ops/rasterize_tile.py, where `BlendTiles` pairs it with
// H-fwd, csrc/blend_fwd.cu, in one autograd Function).
//
// Replaces the backward blend kernels of the JAX package, which all compute
// one function: gaussianavatar_tpu/ops/rasterize_tile.py `_bwd_kernel` (the
// sequential 8-unrolled reverse walk) and `_bwd_kernel_vec` (the same over
// 128-row chunks, ops/blend_vec.vec_bwd_chunk_lean), and
// gaussianavatar_tpu/ops/rasterize_ragged.py `_ragged_bwd_kernel` and
// `_ragged_bwd_kernel_vec` (the same with data-dependent per-tile caps); and
// the harness kernel of scripts/blend_bwd_bench.py, which times that grid.
// On the TPU they write a (tile, slot, 16) slab that XLA scatters back to
// the gaussians; here the kernel writes one 9-float row per (tile, gaussian)
// pair, in sorted order, and the wrapper's index_add_ scatters them.
//
// Semantics (JAX `_bwd_kernel`, rasterize_tile.py:476-522):
//   - a tile walks back to front from its deepest contributor,
//     min(count, max over its pixels of n_contrib); pairs past it get zero;
//   - a row counts for a pixel only if power <= 0, alpha >= 1/255 and
//     k < n_contrib[pixel] (alpha = min(opacity * exp(power), 0.99));
//   - T before a row is rebuilt by division, T / (1 - alpha), from finalT;
//   - the suffix colours ar/ag/ab are carried;
//   - dalpha = ((c - a) . g) * T_before - finalT / (1 - alpha) * gT;
//   - the 0.99 clamp passes its gradient straight through:
//     dpow = gval * opacity * dalpha, d_opacity = gval * dalpha;
//   - per pair, over the tile's pixels: d_mx, d_my, d_ca, d_cb, d_cc,
//     d_r, d_g, d_b, d_op.
//
// What bounds it on the H100: per walked (row, pixel) pair ~74 f32
// operations where the row contributes and 1-17 where it is cut; at the
// training shapes (2 views of 512^2, ~0.2M gaussians each, M=9) that is the
// larger bound, the bytes (one id and one 64-byte row per pair, 24 bytes per
// pixel, 36 bytes per output pair) the smaller. What limits this first
// design in practice is latency: the serial per-pixel walk (T and the suffix
// colours depend on the previous row) and one block reduction per row.
// Design: one block per tile, one thread per pixel; rows staged through
// shared memory in batches of 32, walked in reverse; each row's nine sums
// are taken across the warp with shuffles (skipped where no pixel of the
// warp contributes), the per-warp partials land in shared memory
// (32 warps x 32 rows x 9 floats = 36 KB), and after each batch the block
// adds them in a fixed warp order and writes each pair's row once. Every
// pair belongs to one block, so there are no global atomics, and the fixed
// order makes the kernel deterministic from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPixels = 1024;  // one thread per pixel, tile side <= 32
constexpr int kWarp = 32;
constexpr int kMaxWarps = kMaxPixels / kWarp;
constexpr int kBatch = 32;        // rows staged per batch
constexpr int kChannels = 9;      // d_mx, d_my, d_ca, d_cb, d_cc, d_r, d_g, d_b, d_op
constexpr int kRowWords = 16;     // packed row: mx,my | a,b,c | r,g,b | op | valid | pad
constexpr unsigned kFullMask = 0xffffffffu;
// the constants round from double exactly as PyTorch rounds a Python float
// against a float32 tensor
constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kAlphaMax = static_cast<float>(0.99);

__global__ void __launch_bounds__(kMaxPixels)
blend_bwd_kernel(const float* __restrict__ packed,
                 const int* __restrict__ sorted_vals,
                 const int* __restrict__ offsets,
                 const int* __restrict__ caps,        // nullptr = uncapped
                 int n_tiles, int txn, int ts,
                 const float* __restrict__ finalT,    // (G, ts*ts)
                 const int* __restrict__ ncon,        // (G, ts*ts)
                 const float* __restrict__ grad_color,  // (G, 3, ts*ts)
                 const float* __restrict__ grad_T,    // (G, ts*ts)
                 float* __restrict__ grads) {         // (>= offsets[G], 9), zeroed
  // row batch, one array per used channel: mx, my, ca, cb, cc, r, g, b, op
  __shared__ float s_row[kChannels][kBatch];
  __shared__ float s_part[kMaxWarps][kBatch][kChannels];
  __shared__ int s_maxn;

  const int g = blockIdx.x;         // global tile: view * n_tiles + local tile
  const int tid = threadIdx.x;      // pixel within the tile, row-major
  const int npx = blockDim.x;       // ts * ts, a multiple of 32
  const int nwarps = npx / kWarp;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int local = g % n_tiles;
  const float px = static_cast<float>((local % txn) * ts + tid % ts);
  const float py = static_cast<float>((local / txn) * ts + tid / ts);

  const int start = offsets[g];
  int count = offsets[g + 1] - start;
  if (caps != nullptr) count = min(count, max(caps[g], 0));

  const size_t base = static_cast<size_t>(g) * npx + tid;
  const size_t cbase = static_cast<size_t>(g) * 3 * npx + tid;
  const float fT = finalT[base];
  const int nc = ncon[base];
  const float gr = grad_color[cbase];
  const float gg = grad_color[cbase + npx];
  const float gb = grad_color[cbase + 2 * npx];
  const float gT = grad_T[base];

  if (tid == 0) s_maxn = 0;
  __syncthreads();
  atomicMax(&s_maxn, nc);
  __syncthreads();
  const int end = min(count, s_maxn);

  float T = fT, ar = 0.f, ag = 0.f, ab = 0.f;
  for (int hi = end; hi > 0; hi -= kBatch) {
    const int lo = max(hi - kBatch, 0);
    const int nb = hi - lo;
    if (tid < nb) {
      const float* p = packed + static_cast<size_t>(sorted_vals[start + lo + tid]) * kRowWords;
      for (int c = 0; c < 8; ++c) s_row[c][tid] = p[c];
      // an invalid row gets opacity 0: alpha 0 < 1/255 skips it
      s_row[8][tid] = p[9] > 0.f ? p[8] : 0.f;
    }
    __syncthreads();
    for (int j = nb - 1; j >= 0; --j) {
      const int k = lo + j;
      const float ca = s_row[2][j], cb = s_row[3][j], cc = s_row[4][j];
      const float op = s_row[8][j];
      const float dx = px - s_row[0][j];
      const float dy = py - s_row[1][j];
      const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
      float v[kChannels] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      bool m = false;
      if (power <= 0.f && k < nc) {
        const float gval = expf(power);
        const float alpha = fminf(op * gval, kAlphaMax);
        if (alpha >= kAlphaMin) {
          m = true;
          const float cr = s_row[5][j], cg = s_row[6][j], cbl = s_row[7][j];
          const float one_m = 1.f - alpha;
          const float Tn = T / one_m;        // T before this row
          const float wT = alpha * Tn;
          const float dalpha = ((cr - ar) * gr + (cg - ag) * gg + (cbl - ab) * gb) * Tn
                               + (-fT / one_m) * gT;
          ar = alpha * cr + one_m * ar;      // suffix colours, after their use
          ag = alpha * cg + one_m * ag;
          ab = alpha * cbl + one_m * ab;
          const float dpow = gval * op * dalpha;  // straight through the clamp
          v[0] = dpow * (ca * dx + cb * dy);
          v[1] = dpow * (cb * dx + cc * dy);
          v[2] = -0.5f * dx * dx * dpow;
          v[3] = -dx * dy * dpow;
          v[4] = -0.5f * dy * dy * dpow;
          v[5] = wT * gr;
          v[6] = wT * gg;
          v[7] = wT * gb;
          v[8] = gval * dalpha;
          T = Tn;
        }
      }
      if (__any_sync(kFullMask, m)) {
#pragma unroll
        for (int c = 0; c < kChannels; ++c) {
#pragma unroll
          for (int off = kWarp / 2; off > 0; off >>= 1) {
            v[c] += __shfl_down_sync(kFullMask, v[c], off);
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kChannels; ++c) s_part[warp][j][c] = v[c];
      }
    }
    __syncthreads();
    // one row per pair: the warps' partials added in a fixed order
    for (int i = tid; i < nb * kChannels; i += npx) {
      const int j = i / kChannels;
      const int c = i % kChannels;
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += s_part[w][j][c];
      grads[static_cast<size_t>(start + lo + j) * kChannels + c] = s;
    }
    __syncthreads();  // the next batch overwrites shared memory
  }
}

}  // namespace

// Launch on `stream` over G = offsets.numel() - 1 tiles of ts x ts pixels.
// `grads` (at least offsets[G] rows of 9) must be zeroed: rows past each
// tile's deepest contributor are not written. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ga_blend_bwd(const void* packed, const void* sorted_vals,
                            const void* offsets, const void* caps,
                            int G, int n_tiles, int txn, int ts,
                            const void* finalT, const void* ncon,
                            const void* grad_color, const void* grad_T,
                            void* grads, void* stream) {
  if (ts <= 0 || ts * ts > kMaxPixels || (ts * ts) % kWarp != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (G > 0) {
    blend_bwd_kernel<<<G, ts * ts, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(packed), static_cast<const int*>(sorted_vals),
        static_cast<const int*>(offsets), static_cast<const int*>(caps),
        n_tiles, txn, ts,
        static_cast<const float*>(finalT), static_cast<const int*>(ncon),
        static_cast<const float*>(grad_color), static_cast<const float*>(grad_T),
        static_cast<float*>(grads));
  }
  return static_cast<int>(cudaGetLastError());
}
