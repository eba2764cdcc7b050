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
//   - a pixel walks back to front; a row counts for it only if power <= 0,
//     alpha >= 1/255 and k < n_contrib[pixel] (alpha = min(opacity *
//     exp(power), 0.99)), so the walk of a tile ends, without changing any
//     sum, at min(count, the deepest n_contrib of its pixels); pairs past
//     that get zero;
//   - T before a row is rebuilt by division, T / (1 - alpha), from finalT;
//   - the suffix colours ar/ag/ab are carried;
//   - dalpha = ((c - a) . g) * T_before - finalT / (1 - alpha) * gT;
//   - the 0.99 clamp passes its gradient straight through:
//     dpow = gval * opacity * dalpha, d_opacity = gval * dalpha;
//   - per pair, over the tile's pixels: d_mx, d_my, d_ca, d_cb, d_cc,
//     d_r, d_g, d_b, d_op.
//
// What bounds it on the H100: per walked (row, pixel) pair ~74 f32
// operations where the row contributes and 13-17 where it is cut; at the
// training shapes (2 views of 512^2, 32 px tiles, ~0.58M binned pairs) the
// operations (~3 GFLOP, 0.045 ms at the 67 TFLOP/s FP32 peak) bound it, the
// bytes (~53 MB, 0.016 ms) less. Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py, both designs in one run): 0.96-0.97 ms on the training
// batch against a 0.039 ms bound, where the first design (one 1024-thread
// block per tile) took 2.91-3.02 ms; 2.26-2.27 ms on the random scene
// (4.34-4.36 ms). What held the first design back, and what this design
// does about each:
//   - one 1024-thread block per SM at 56 registers, 512 blocks in tile
//     order, so a tile 5x deeper than the mean walked alone at the end:
//     a block now walks one 16x16 quadrant of a 32 px tile (a tile of at
//     most 16 px is one block), 256 threads, several blocks per SM, and the
//     wrapper launches the blocks deepest walk first (its argsort of the
//     walk lengths is the block order: longest-processing-time first);
//   - 65% of the walked (row, pixel) pairs lay past their pixel's
//     n_contrib, because every pixel walked down to the tile's deepest: a
//     block walks from its own quadrant's deepest n_contrib (the wrapper's
//     per-block walk ends), and each warp, an 8x4 patch of the quadrant,
//     starts at its own deepest. On the training batch that leaves 222 M
//     of 454 M pairs (16x2 strips would leave 269 M);
//   - a dependent gather of each 32-row batch with nothing in flight: the
//     rows of batch i+1 are copied into a double buffer in shared memory by
//     16-byte cp.async while batch i is walked, and their ids are loaded a
//     batch earlier still;
//   - 97% of the remaining pairs are cut, each after an expf and branches:
//     a warp first drops the rows that a per-row bound (row_reaches, in
//     blend_common.cuh) proves cut at every pixel of its patch (lane l
//     tests row l of the batch; a ballot gives the warp-uniform list of
//     rows to walk: 69% of the training batch's (row, quadrant) pairs go
//     at the quadrant's size already); a row left is gated without its
//     expf, by power and a pre-test against a per-row threshold that cuts
//     only what the alpha floor cuts, in straight-line code, and the warp
//     goes further only where some lane passes (one vote, one uniform
//     branch per row);
//   - lane 0 of every warp stored nine partials per row, then 288 threads
//     added 32 warps: the nine sums go across the warp by shuffles only
//     where some lane contributes, lane 0 stores them only then and marks
//     the row in the warp's bit mask, and after each batch the block adds,
//     per row, the marked warps' partials in a fixed warp order. (Gating
//     two rows per step, and summing by recursive halving, measured
//     slower: PERF.md, Findings.)
// A 32 px tile's four quadrant blocks each write their rows into a slab of
// their own; the last of the four to finish (an integer ticket per tile)
// adds the four slabs in block order into the output. There are no float
// atomics, and two runs are bit-identical. Every per-pixel term keeps the
// plain version's expression order (and -fmad=false), so it equals the
// plain version's bit for bit; only the sums over pixels run in another
// order.

#include "blend_common.cuh"

namespace {

using blend::Row;

constexpr int kThreads = 256;  // one thread per pixel of a block's sub-tile, side <= 16
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kBatch = 32;     // rows staged per batch: one lane, and one mask bit, each
static_assert(kBatch == kWarp, "a warp tests a batch's rows one per lane");
constexpr int kChannels = 9;   // d_mx, d_my, d_ca, d_cb, d_cc, d_r, d_g, d_b, d_op
constexpr int kMaxBlocks = 4;  // blocks per tile: nq <= 2
constexpr unsigned kFullMask = 0xffffffffu;

// A row's gate for a thread's pixel, without its expf: the offsets, the
// power, and whether the pixel passes k < n_contrib, power <= 0 and the
// alpha pre-test.
struct Gate {
  float dx, dy, power;
  bool pass;
};

__global__ void __launch_bounds__(kThreads)
blend_bwd_kernel(const float* __restrict__ packed,
                 const int* __restrict__ sorted_vals,
                 const int* __restrict__ offsets,
                 const int* __restrict__ order,       // (G*Q,) block ids, deepest walk first
                 const int* __restrict__ ends,        // (G*Q,) rows each block walks
                 int nq, int side,                    // nq x nq blocks of side x side px per tile
                 int n_tiles, int txn, int ts,
                 const float* __restrict__ finalT,    // (G, ts*ts)
                 const int* __restrict__ ncon,        // (G, ts*ts)
                 const float* __restrict__ grad_color,  // (G, 3, ts*ts)
                 const float* __restrict__ grad_T,    // (G, ts*ts)
                 float* __restrict__ out,             // (out_rows, 9), zeroed
                 float* __restrict__ slab,            // (Q, out_rows, 9) if Q > 1
                 int* __restrict__ tickets,           // (G,) zeroed, if Q > 1
                 long long out_rows) {
  __shared__ Row s_row[2][kBatch];                 // double buffer of staged rows
  __shared__ float s_cut[2][kBatch];               // per row: the alpha pre-test threshold
  __shared__ float s_part[kWarps][kBatch][kChannels];
  __shared__ unsigned s_mask[kWarps];              // rows of the batch where the warp contributes
  __shared__ bool s_last;

  const int blk = order[blockIdx.x];
  const int end = ends[blk];
  const int Q = nq * nq;
  const int g = blk / Q;            // global tile: view * n_tiles + local tile
  const int q = blk % Q;            // sub-tile within it, row-major
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  // a warp covers an 8x4 patch of the sub-tile, the warps two patches wide
  const int sx = (warp % 2) * 8 + lane % 8;
  const int sy = (warp / 2) * 4 + lane / 8;
  const int lx = (q % nq) * side + sx;
  const int ly = (q / nq) * side + sy;
  const bool live = sx < side && sy < side && lx < ts && ly < ts;
  const int npx = ts * ts;
  const int local = g % n_tiles;
  const float px = static_cast<float>((local % txn) * ts + lx);
  const float py = static_cast<float>((local / txn) * ts + ly);
  // the warp's 8x4 patch, as pixel coordinates of its top-left corner
  const float wx0 = static_cast<float>((local % txn) * ts + (q % nq) * side + (warp % 2) * 8);
  const float wy0 = static_cast<float>((local / txn) * ts + (q / nq) * side + (warp / 2) * 4);
  const int start = offsets[g];

  float fT = 0.f, gr = 0.f, gg = 0.f, gb = 0.f, gT = 0.f;
  int nc = 0;  // a thread outside the tile contributes nothing
  if (live) {
    const size_t base = static_cast<size_t>(g) * npx + ly * ts + lx;
    const size_t cbase = static_cast<size_t>(g) * 3 * npx + ly * ts + lx;
    fT = finalT[base];
    nc = ncon[base];
    gr = grad_color[cbase];
    gg = grad_color[cbase + npx];
    gb = grad_color[cbase + 2 * npx];
    gT = grad_T[base];
  }
  const int wmax = __reduce_max_sync(kFullMask, nc);  // the warp's deepest n_contrib
  // a tile of one block writes the output itself
  float* const dst = (Q == 1 ? out : slab + static_cast<size_t>(q) * out_rows * kChannels)
                     + static_cast<size_t>(start) * kChannels;

  // Batch i stages rows [lo, hi) of the tile, hi = end - i * kBatch,
  // lo = max(hi - kBatch, 0). Threads below kBatch * kChunks each copy one
  // 16-byte chunk of one row; `pos` is the sorted position of that row.
  const int nbatch = (end + kBatch - 1) / kBatch;
  const int lrow = tid / blend::kChunks;
  const int lchunk = tid % blend::kChunks;
  const bool loader = tid < kBatch * blend::kChunks;
  auto pos = [&](int i) {
    if (!loader || i >= nbatch) return -1;
    const int hi = end - i * kBatch;
    const int lo = max(hi - kBatch, 0);
    return lrow < hi - lo ? start + lo + lrow : -1;
  };
  {
    const int p0 = pos(0);
    if (p0 >= 0) blend::stage_chunk(&s_row[0][lrow], packed, sorted_vals[p0], lchunk);
    blend::cp_async_commit();
  }
  int p_next = pos(1);
  int id_next = p_next >= 0 ? sorted_vals[p_next] : 0;

  float T = fT, ar = 0.f, ag = 0.f, ab = 0.f;
  for (int i = 0; i < nbatch; ++i) {
    const int buf = i & 1;
    // batch i+1's rows fly while batch i is walked; their buffer was last
    // read in batch i-1, before that batch's second barrier
    if (p_next >= 0) blend::stage_chunk(&s_row[buf ^ 1][lrow], packed, id_next, lchunk);
    blend::cp_async_commit();
    const int p_cur = pos(i);
    p_next = pos(i + 2);
    id_next = p_next >= 0 ? sorted_vals[p_next] : 0;
    blend::cp_async_wait<1>();  // this thread's copies of batch i have landed
    if (p_cur >= 0 && lchunk == 2) {
      s_cut[buf][lrow] = blend::alpha_cut_power(blend::row_opacity(s_row[buf][lrow]));
    }
    __syncthreads();            // everyone's have; the last batch's partials are read

    const int hi = end - i * kBatch;
    const int lo = max(hi - kBatch, 0);
    unsigned mask = 0u;  // rows of the batch where this warp contributes
    // the gate of staged row j without its expf, in straight-line code
    auto gate = [&](int j) {
      const Row& r = s_row[buf][j];
      const float4 c0 = r.c[0];  // mx, my, ca, cb
      const float cc = r.c[1].x;
      Gate gt;
      gt.dx = px - c0.x;
      gt.dy = py - c0.y;
      gt.power = -0.5f * (c0.z * gt.dx * gt.dx + cc * gt.dy * gt.dy) - c0.w * gt.dx * gt.dy;
      gt.pass = (lo + j < nc) & (gt.power <= 0.f) & !(gt.power < s_cut[buf][j]);
      return gt;
    };
    // the rest of row j's walk for the lanes that pass its gate: the exact
    // alpha test, the gradient terms, their sums over the warp
    auto walk_row = [&](int j, const Gate& gt, bool pass) {
      if (!__any_sync(kFullMask, pass)) return;
      float v[kChannels] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      bool m = false;
      if (pass) {
        const Row& r = s_row[buf][j];
        const float op = blend::row_opacity(r);
        const float gval = expf(gt.power);
        const float alpha = fminf(op * gval, blend::kAlphaMax);
        if (alpha >= blend::kAlphaMin) {
          m = true;
          const float dx = gt.dx, dy = gt.dy;
          const float ca = r.c[0].z, cb = r.c[0].w, cc = r.c[1].x;
          const float cr = r.c[1].y, cg = r.c[1].z, cbl = r.c[1].w;
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
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < kChannels; ++c) s_part[warp][j][c] = v[c];
        }
        mask |= 1u << j;
      }
    };
    // the rows this warp walks, from the back of the batch to its front:
    // those below its deepest n_contrib (rows at or past it change nothing)
    // that row_reaches does not prove cut at every pixel of its patch;
    // lane l tests row l, and the ballot is warp-uniform
    const bool reach = lo + lane < min(hi, wmax) &&
                       blend::row_reaches(s_row[buf][lane], s_cut[buf][lane], wx0, wx0 + 7.f,
                                          wy0, wy0 + 3.f);
    for (unsigned todo = __ballot_sync(kFullMask, reach); todo != 0u;) {
      const int j = 31 - __clz(todo);
      todo &= ~(1u << j);
      const Gate gt = gate(j);
      walk_row(j, gt, gt.pass);
    }
    if (lane == 0) s_mask[warp] = mask;
    __syncthreads();  // the batch's partials are complete; buffer `buf` is free

    // one row per pair: the marked warps' partials added in a fixed order
    for (int idx = tid; idx < (hi - lo) * kChannels; idx += kThreads) {
      const int j = idx / kChannels;
      const int c = idx % kChannels;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (s_mask[w] >> j & 1u) s += s_part[w][j][c];
      }
      dst[static_cast<size_t>(lo + j) * kChannels + c] = s;
    }
  }
  blend::cp_async_wait<0>();
  if (Q == 1) return;

  // The last of the tile's blocks to finish adds their slabs, in block
  // order, below each block's own walk end (past it a block's rows are 0).
  __threadfence();  // this block's slab rows, before its ticket
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tickets[g], 1) == Q - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();  // every block's rows, after the last ticket
  int qend[kMaxBlocks];
  int tile_end = 0;
#pragma unroll
  for (int b = 0; b < kMaxBlocks; ++b) {
    qend[b] = b < Q ? ends[g * Q + b] : 0;
    tile_end = max(tile_end, qend[b]);
  }
  float* const tile_out = out + static_cast<size_t>(start) * kChannels;
  for (int idx = tid; idx < tile_end * kChannels; idx += kThreads) {
    const int k = idx / kChannels;
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < kMaxBlocks; ++b) {
      if (k < qend[b]) {
        s += __ldcg(slab + (static_cast<size_t>(b) * out_rows + start) * kChannels + idx);
      }
    }
    tile_out[idx] = s;
  }
}

}  // namespace

// Launch on `stream` over the blocks of G tiles of ts x ts pixels, nq x nq
// (nq <= 2) blocks of side x side (<= 16 x 16) pixels per tile, in the order
// `order` (G*nq*nq ids, block q of tile g being g * nq*nq + q), block b
// walking its tile's first ends[b] rows. `out` (out_rows >= offsets[G]
// rows of 9) must be zeroed: rows past a tile's deepest block end are not
// written. With nq = 2, `slab` (4, out_rows, 9) holds the blocks' partial
// rows and `tickets` (G ints, zeroed) counts the blocks done per tile; with
// nq = 1 neither is read. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int ga_blend_bwd(const void* packed, const void* sorted_vals,
                            const void* offsets, const void* order, const void* ends,
                            int n_blocks, int nq, int side, int n_tiles, int txn, int ts,
                            const void* finalT, const void* ncon,
                            const void* grad_color, const void* grad_T,
                            void* out, void* slab, void* tickets, long long out_rows,
                            void* stream) {
  if (ts <= 0 || ts > 32 || nq < 1 || nq * nq > kMaxBlocks || side > 16 || nq * side < ts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks > 0) {
    blend_bwd_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(packed), static_cast<const int*>(sorted_vals),
        static_cast<const int*>(offsets), static_cast<const int*>(order),
        static_cast<const int*>(ends), nq, side, n_tiles, txn, ts,
        static_cast<const float*>(finalT), static_cast<const int*>(ncon),
        static_cast<const float*>(grad_color), static_cast<const float*>(grad_T),
        static_cast<float*>(out), static_cast<float*>(slab), static_cast<int*>(tickets),
        out_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
