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
// GFLOP, 0.17 ms at the 67 TFLOP/s FP32 peak: the larger of the two.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, both designs in one
// run): 0.99-1.01 ms on the render batch against that 0.168 ms bound, where
// the first design (one 1024-thread block per tile, one thread per pixel)
// took 2.70-2.79 ms; 0.73-0.74 ms on the training batch (2.17-2.21 ms)
// against a 0.052 ms bound. What held the first design back, and what this
// design does about each:
//   - at most two 1024-thread blocks per SM, tiles in index order, and on
//     the training batch (512 tiles, under one wave) a tile 7x deeper than
//     the mean walked by one SM: a block of 64 threads now walks one 16x16
//     quadrant of a 32 px tile (a tile of at most 16 px is one block), each
//     thread a 2x2 quad of pixels, up to 16 blocks per SM; the four blocks
//     of a deep tile walk it on four SMs; and the wrapper launches the
//     blocks deepest tile first (its argsort of min(count, cap) is the
//     block order: longest-processing-time first);
//   - a batch as large as the block (1,024 rows), so the block-wide "all
//     done" exit was tested once per 1,024 rows, past the mean tile's
//     depth: batches are now 64 rows, and a quadrant leaves after the
//     first batch at whose end all of its pixels are done;
//   - ten scalar loads per row and no prefetch: the rows of batch i+1 are
//     copied into a double buffer in shared memory as three 16-byte
//     cp.async chunks (the words the blend reads) while batch i is walked,
//     their ids loaded a batch earlier still;
//   - nine scalar shared loads per (row, pixel): the staged row is three
//     float4 in the packed table's own order, (mx, my, ca, cb), (cc, r, g,
//     b), (op, valid, ., .), read by a thread once for its four pixels
//     (re-laid so the gate fits two float4, it would save one broadcast
//     load per row and thread for a barrier per batch). The quad's pixels
//     share two x and two y offsets, so dx, dy, ca dx dx and cc dy dy are
//     computed once per column or row of the quad, in the per-pixel order;
//   - ~90% of the walked pairs are cut by the alpha floor, each after an
//     expf and branches: a row is gated without its expf, by power and a
//     pre-test against a per-row threshold that cuts only what the alpha
//     floor cuts, in straight-line code with one branch per row; and each
//     warp first drops the rows that a per-row bound (row_reaches, in
//     blend_common.cuh) proves cut at every pixel of its 16x8 part of the
//     quadrant: about half of the (row, quadrant) pairs of the render.
// Every decision and every product keeps the plain version's expression
// order (and -fmad=false), so n_contrib, done and T equal it exactly.

#include "blend_common.cuh"

namespace {

using blend::Row;

constexpr int kThreads = 64;   // one thread per 2x2 quad of a sub-tile of side <= 16
constexpr int kPix = 4;        // pixels of a quad: (0,0), (1,0), (0,1), (1,1)
constexpr unsigned kAllDone = (1u << kPix) - 1;
constexpr int kBatch = kThreads;  // rows staged per batch, one per thread
constexpr int kMaxSide = 16;
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kBatch % 32 == 0, "a warp tests a batch's rows 32 at a time");

// A row's gate for a thread's quad, without its expf: the four powers and
// the pixels that pass power <= 0 and the alpha pre-test.
struct Gate {
  float power[kPix];
  unsigned pass;
};

__global__ void __launch_bounds__(kThreads, 12)
blend_fwd_kernel(const float* __restrict__ packed,
                 const int* __restrict__ sorted_vals,
                 const int* __restrict__ offsets,
                 const int* __restrict__ counts,  // (G,) rows each tile blends
                 const int* __restrict__ order,   // (G*Q,) blocks, deepest tile first
                 int nq, int side,                // nq x nq blocks of side x side px per tile
                 int n_tiles, int txn, int ts,
                 float* __restrict__ color,      // (G, 3, ts*ts)
                 float* __restrict__ T_out,      // (G, ts*ts)
                 int* __restrict__ ncon_out,     // (G, ts*ts)
                 float* __restrict__ done_out) { // (G, ts*ts)
  __shared__ Row s_row[2][kBatch];    // double buffer of staged rows
  __shared__ float s_cut[2][kBatch];  // per row: the alpha pre-test threshold

  const int blk = order[blockIdx.x];
  const int Q = nq * nq;
  const int g = blk / Q;            // global tile: view * n_tiles + local tile
  const int q = blk % Q;            // sub-tile within it, row-major
  const int tid = threadIdx.x;
  const int qw = (side + 1) / 2;    // quads per sub-tile row
  const int local = g % n_tiles;
  // the quad's top-left pixel within the tile
  const int lx0 = (q % nq) * side + 2 * (tid % qw);
  const int ly0 = (q / nq) * side + 2 * (tid / qw);
  const int x_end = min((q % nq + 1) * side, ts);  // the sub-tile's pixel bounds
  const int y_end = min((q / nq + 1) * side, ts);
  const bool quad = tid < qw * qw;
  const int lane = tid % 32;
  // the warp's part of the sub-tile: its quads' pixel rows, every column
  const int sub_x = (local % txn) * ts + (q % nq) * side;
  const int sub_y = (local / txn) * ts + (q / nq) * side;
  const int warp_row0 = tid / 32 * 32 / qw;
  const int warp_row1 = min((tid / 32 * 32 + 31) / qw, qw - 1);
  const float wx0 = static_cast<float>(sub_x), wx1 = static_cast<float>(sub_x + 2 * qw - 1);
  const float wy0 = static_cast<float>(sub_y + 2 * warp_row0);
  const float wy1 = static_cast<float>(sub_y + 2 * warp_row1 + 1);
  // the quad's two columns and two rows, as pixel coordinates
  const float qx[2] = {static_cast<float>((local % txn) * ts + lx0),
                       static_cast<float>((local % txn) * ts + lx0 + 1)};
  const float qy[2] = {static_cast<float>((local / txn) * ts + ly0),
                       static_cast<float>((local / txn) * ts + ly0 + 1)};

  float T[kPix], cr[kPix], cg[kPix], cb[kPix];
  int nc[kPix];
  unsigned done = 0u;  // bit u: pixel u has terminated; one outside the sub-tile starts done
#pragma unroll
  for (int u = 0; u < kPix; ++u) {
    T[u] = 1.f;
    cr[u] = cg[u] = cb[u] = 0.f;
    nc[u] = 0;
    if (!(quad && lx0 + u % 2 < x_end && ly0 + u / 2 < y_end)) done |= 1u << u;
  }

  const int start = offsets[g];
  const int count = counts[g];
  const int nbatch = (count + kBatch - 1) / kBatch;
  // thread t stages row t of each batch; `pos` is its sorted position
  auto pos = [&](int i) {
    const int k = i * kBatch + tid;
    return k < count ? start + k : -1;
  };
  auto stage = [&](int buf, int id) {
#pragma unroll
    for (int c = 0; c < blend::kChunks; ++c) blend::stage_chunk(&s_row[buf][tid], packed, id, c);
  };
  // the gate of staged row j, as the per-pixel expression computes it: dx,
  // dy, ca dx dx and cc dy dy once per column or row of the quad
  auto gate = [&](int buf, int j) {
    const Row& r = s_row[buf][j];
    const float4 c0 = r.c[0];  // mx, my, ca, cb
    const float cc = r.c[1].x;
    const float cut = s_cut[buf][j];
    const float dx[2] = {qx[0] - c0.x, qx[1] - c0.x};
    const float dy[2] = {qy[0] - c0.y, qy[1] - c0.y};
    const float axx[2] = {c0.z * dx[0] * dx[0], c0.z * dx[1] * dx[1]};
    const float cyy[2] = {cc * dy[0] * dy[0], cc * dy[1] * dy[1]};
    const float bx[2] = {c0.w * dx[0], c0.w * dx[1]};
    Gate gt;
    gt.pass = 0u;
#pragma unroll
    for (int u = 0; u < kPix; ++u) {
      gt.power[u] = -0.5f * (axx[u % 2] + cyy[u / 2]) - bx[u % 2] * dy[u / 2];
      gt.pass |= static_cast<unsigned>(!(gt.power[u] > 0.f) & !(gt.power[u] < cut)) << u;
    }
    return gt;
  };
  // the exact test and the blend of row j (rank k) for the pixels in `pass`
  auto blend_row = [&](int buf, int j, int k, const Gate& gt, unsigned pass) {
    const Row& r = s_row[buf][j];
    const float op = blend::row_opacity(r);
    const float4 c1 = r.c[1];  // cc, r, g, b
#pragma unroll
    for (int u = 0; u < kPix; ++u) {
      if (!(pass >> u & 1u)) continue;
      const float alpha = fminf(op * expf(gt.power[u]), blend::kAlphaMax);
      if (alpha < blend::kAlphaMin) continue;
      const float test_T = T[u] * (1.f - alpha);
      if (test_T < blend::kTEps) {
        done |= 1u << u;
        continue;
      }
      const float w = alpha * T[u];
      cr[u] = cr[u] + w * c1.y;
      cg[u] = cg[u] + w * c1.z;
      cb[u] = cb[u] + w * c1.w;
      T[u] = test_T;
      nc[u] = k + 1;
    }
  };
  {
    const int p0 = pos(0);
    if (p0 >= 0) stage(0, sorted_vals[p0]);
    blend::cp_async_commit();
  }
  int p_next = pos(1);
  int id_next = p_next >= 0 ? sorted_vals[p_next] : 0;

  for (int i = 0; i < nbatch; ++i) {
    const int buf = i & 1;
    // batch i+1's rows fly while batch i is walked; their buffer was last
    // read in batch i-1, before its closing barrier
    if (p_next >= 0) stage(buf ^ 1, id_next);
    blend::cp_async_commit();
    const int p_cur = pos(i);
    p_next = pos(i + 2);
    id_next = p_next >= 0 ? sorted_vals[p_next] : 0;
    blend::cp_async_wait<1>();  // this thread's copy of batch i has landed
    if (p_cur >= 0) s_cut[buf][tid] = blend::alpha_cut_power(blend::row_opacity(s_row[buf][tid]));
    __syncthreads();            // everyone's has

    const int b0 = i * kBatch;
    const int nb = min(kBatch, count - b0);
    // the rows this warp walks, in order: those that row_reaches does not
    // prove cut at every pixel of its part of the sub-tile; lane l tests
    // rows l and 32 + l, and the ballots are warp-uniform
    unsigned todo[kBatch / 32];
#pragma unroll
    for (int h = 0; h < kBatch / 32; ++h) {
      const int j = 32 * h + lane;
      todo[h] = __ballot_sync(kFullMask, j < nb && blend::row_reaches(s_row[buf][j], s_cut[buf][j],
                                                                      wx0, wx1, wy0, wy1));
    }
#pragma unroll
    for (int h = 0; h < kBatch / 32; ++h) {
      for (unsigned m = todo[h]; m != 0u && done != kAllDone; m &= m - 1) {
        const int j = 32 * h + __ffs(m) - 1;
        const Gate gt = gate(buf, j);
        const unsigned pass = gt.pass & ~done;
        if (pass) blend_row(buf, j, b0 + j, gt, pass);
      }
    }
    // leave the sub-tile once every pixel has terminated (uniform across
    // the block); the barrier also frees buffer `buf` for batch i+2
    if (__syncthreads_count(done == kAllDone) == kThreads) break;
  }
  blend::cp_async_wait<0>();

  const int npx = ts * ts;
#pragma unroll
  for (int u = 0; u < kPix; ++u) {
    const int lx = lx0 + u % 2, ly = ly0 + u / 2;
    if (!(quad && lx < x_end && ly < y_end)) continue;
    const size_t base = static_cast<size_t>(g) * npx + ly * ts + lx;
    const size_t cbase = static_cast<size_t>(g) * 3 * npx + ly * ts + lx;
    color[cbase] = cr[u];
    color[cbase + npx] = cg[u];
    color[cbase + 2 * npx] = cb[u];
    T_out[base] = T[u];
    ncon_out[base] = nc[u];
    done_out[base] = done >> u & 1u ? 1.f : 0.f;
  }
}

}  // namespace

// Launch on `stream` over the blocks of G = offsets.numel() - 1 tiles of
// ts x ts pixels (ts <= 32), nq x nq (nq <= 2) blocks of side x side (<= 16
// x 16) pixels per tile, in the order `order` (G*nq*nq ids, block q of tile
// g being g * nq*nq + q), tile g blending its first counts[g] rows.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ga_blend_fwd(const void* packed, const void* sorted_vals,
                            const void* offsets, const void* counts, const void* order,
                            int n_blocks, int nq, int side, int n_tiles, int txn, int ts,
                            void* color, void* T_out, void* ncon, void* done,
                            void* stream) {
  if (ts <= 0 || ts > 32 || nq < 1 || nq > 2 || side > kMaxSide || nq * side < ts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks > 0) {
    blend_fwd_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(packed), static_cast<const int*>(sorted_vals),
        static_cast<const int*>(offsets), static_cast<const int*>(counts),
        static_cast<const int*>(order), nq, side, n_tiles, txn, ts,
        static_cast<float*>(color), static_cast<float*>(T_out),
        static_cast<int*>(ncon), static_cast<float*>(done));
  }
  return static_cast<int>(cudaGetLastError());
}
