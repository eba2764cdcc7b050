// H-dstat: the batch statistics of a fused POP decoder stage, for Hopper
// (sm_90a), with a plain C interface (loaded through ctypes by
// gaussianavatar_torch/ops/decoder_stage.py `column_stats`).
//
// One pass over a stage's input x (R, C), float32 or bfloat16, any C >= 1,
// gives its column sums (C,) and its Gram x^T x (C, C), both accumulated in
// float32. The fused stage takes the pre-activation's batch mean and
// variance from them and the weights alone (models/decoder.
// ShapeDecoderFused), so the (R, H) pre-activation is never written. It has
// no Pallas counterpart: the JAX package's ShapeDecoderFused
// (gaussianavatar_tpu/models/decoder.py:199-222) computes the same
// `jnp.mean` and `einsum` and leaves them to XLA.
//
// What bounds it on the H100: reading x once (a 128-wide bfloat16 stage at
// R = 445,568 is 114 MB, 0.034 ms at 3.35 TB/s) against the least work, the
// R C (C + 1) / 2 distinct products and as many additions (7.4 GFLOP there:
// 0.0075 ms on the bfloat16 tensor cores). Float32 input doubles the bytes
// (0.068 ms at 128) and takes three TF32 products a product, 3 R C (C + 1)
// operations at 495 TFLOP/s (0.045 ms at 128, 0.28 ms at the 322-wide skip
// stage of --hsize 256, which its operations bound).
//
// The design (decoder_common.cuh): the rows are cut into slabs (64 rows;
// 32 or 16 for float32 input where 64 do not fit), and split s of n_split (about
// one per SM) takes the slabs s, s + n_split, ... (neighbouring blocks read
// neighbouring rows); a block walks its slabs, which one of its threads
// lands with one cp.async.bulk each into a ring of stages, reissuing a stage
// as soon as every thread has read it. The consumers transpose each slab
// into x^T (C rows of the slab's values, K-major, 128-byte swizzle) in
// shared memory, double buffered where two buffers fit, and wgmma computes
// the 64 x 64 chunks (I, J), I <= J, of the Gram, both operands from x^T: a
// slab's products run while the next slab is transposed. Each slab's sum
// runs on the tensor cores from zero and is then added to float32 running
// totals in registers (the tensor cores' own accumulation drifts over long
// chains). A block is 4 warpgroups of one chunk each (acc and total: 64
// registers), so it computes up to 4 chunks: C <= 128 takes one chunk group
// (3 chunks), C = 194 three (float32 two); the groups of one split are
// neighbouring blocks
// that read the same slabs together, so device memory is read once and L2
// serves the other groups' reads.
//  - bfloat16 input: wgmma m64n64k16; the products are exact.
//  - float32 input (the first stage, and every stage of the float32
//    decoder): 3xTF32 (decoder_common.cuh) on wgmma m64nNk8. The transpose
//    splits each value into tf32 hi and lo, written as two x^T parts; a
//    chunk's slab sum is lo_I^T hi_J + hi_I^T lo_J, then hi_I^T hi_J, from
//    zero. Single-pass TF32 keeps 11 bits of each value, and the Gram's
//    error reaches the BatchNorm variance through e2 - mu^2, which cancels:
//    the float32 contract (the plain version sums in float64) refuses it.
//    A chunk's N is the smallest of 8, 16, 32, 64 that covers its columns
//    below C; a last column chunk of 8 or fewer merges into the one before
//    it (N = 72: A is read once for both) and one 8-wide chunk of the last
//    rows closes the triangle (the first stage's 66 columns take a 64 x 72
//    and a 64 x 8 chunk, not three 64 x 64; the 322-wide skip stage 16
//    chunks, not 21), and a warpgroup without a chunk issues none.
//    x^T (hi and lo) takes 2 x slab x roundup(C, 8) x 4 bytes: at C = 194
//    32-row slabs double buffered, at C = 322 32-row slabs in one buffer.
// The column sums: per slab from zero, then into a float32 total. bfloat16
// input: by the block's first chunk group, in row order from x^T. float32
// input: x^T's row C (in the last chunk's padding) is ones, so the Gram's
// entries (i, C) are the column sums, from the same products (hi 1, lo 0:
// the three products give x's hi + lo).
// Deterministic: every thread's share of the work is fixed, no atomics; a
// second kernel adds the n_split partials in split order and mirrors the
// upper triangle into the lower. Two runs give the same bits.

#include "decoder_common.cuh"

namespace {

using namespace ga_dec;

// four warpgroups of one chunk each (acc and total: 64 registers). No
// producer warp: thread 0 reissues each stage once every thread has read it.
constexpr int kConsumersB = 512;
constexpr int kChunksPerWG = 1;
constexpr int kChunksPerBlock = kConsumersB / 128 * kChunksPerWG;

// chunk number k of the upper triangle of n x n chunks, row by row
__host__ __device__ __forceinline__ void upper_index(int k, int n, int& I, int& J) {
  I = 0;
  while (k >= n - I) {
    k -= n - I;
    ++I;
  }
  J = I + k;
}

struct Cfg {
  int stages;
  size_t stage_bytes;
  size_t xt_bytes;       // one x^T buffer (float32 input: its hi and lo parts)
  int xt_buffers;        // 2, or 1 where two do not fit
  size_t csum_off;       // the column sums' float32 totals (bfloat16 input)
  size_t land_off;
  int n_split;
  int groups;            // chunk groups (blocks per split)
  int slab;              // rows a slab: 64, or 32 (float32 input at wide C)
  int cr;                // float32 input: x^T's rows, roundup(C + 1, 8)
  int by_product;        // float32 input, 2 chunks or 1: warpgroups 0, 2, 3 take one
                         // of chunk 0's three products each (below)
};

// the split's slabs: first, first + n_split, ... below ceil(R / slab)
__device__ __forceinline__ int split_slabs(int R, int split, int n_split, int slab = kTileRows) {
  const int total = (R + slab - 1) / slab;
  return split < total ? (total - split + n_split - 1) / n_split : 0;
}

// ---- bfloat16 input: wgmma m64n64k16 ------------------------------------

// D[c] = the slab's products of this warpgroup's chunks, from zero (a
// warpgroup with no chunk of its own computes chunk (0, 0) and drops it, so
// every warpgroup issues and waits alike)
__device__ __forceinline__ void issue_chunks(float (&acc)[kChunksPerWG][32],
                                             const unsigned char* xb,
                                             const int (&cI)[kChunksPerWG],
                                             const int (&cJ)[kChunksPerWG]) {
#pragma unroll
  for (int c = 0; c < kChunksPerWG; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kChunksPerWG; ++c) {
    const unsigned char* A = xb + cI[c] * 64 * 128;
    const unsigned char* B = xb + cJ[c] * 64 * 128;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_ss_64x64(acc[c], desc_b128(A + 32 * k), desc_b128(B + 32 * k), 1);
  }
  wgmma_commit();
}

// waits for the chunks' products and adds them to the totals
__device__ __forceinline__ void add_chunks(float (&acc)[kChunksPerWG][32],
                                           float (&total)[kChunksPerWG][32]) {
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kChunksPerWG; ++c) {
    fence_acc(acc[c]);
#pragma unroll
    for (int i = 0; i < 32; ++i) total[c][i] += acc[c][i];
  }
}

template <bool SINGLE>   // one x^T buffer (where two do not fit)
__global__ void __launch_bounds__(kConsumersB, 1)
stats_bf16(const __nv_bfloat16* __restrict__ x, int R, int C, Cfg cfg, float* __restrict__ work) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* xt = smem;                        // the x^T buffers
  float* csum = reinterpret_cast<float*>(smem + cfg.csum_off);
  unsigned char* land = smem + cfg.land_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(land + cfg.stages * cfg.stage_bytes);
  const int group = blockIdx.x % cfg.groups, split = blockIdx.x / cfg.groups;
  const int nI = (C + 63) / 64, Cp = nI * 64;
  const int n_chunks = nI * (nI + 1) / 2;
  const int n_slabs = split_slabs(R, split, cfg.n_split);
  const unsigned char* xbytes = reinterpret_cast<const unsigned char*>(x);
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < cfg.stages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (t == 0)
    for (int s = 0; s < cfg.stages && s < n_slabs; ++s)
      land_tile(xbytes, static_cast<size_t>(C) * 2, R, split + s * cfg.n_split,
                land + s * cfg.stage_bytes, &full[s]);
  const int warp = t / 32;
  const int wg = warp / 4;
  const int lane = t % 32, wr = warp % 4;
  // this warpgroup's chunks
  int cI[kChunksPerWG], cJ[kChunksPerWG];
  bool has[kChunksPerWG];
#pragma unroll
  for (int c = 0; c < kChunksPerWG; ++c) {
    const int k = group * kChunksPerBlock + wg * kChunksPerWG + c;
    has[c] = k < n_chunks;
    upper_index(has[c] ? k : 0, nI, cI[c], cJ[c]);
  }
  float total[kChunksPerWG][32], acc[kChunksPerWG][32];
#pragma unroll
  for (int c = 0; c < kChunksPerWG; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) total[c][i] = acc[c][i] = 0.f;
  // column sums: thread t owns columns t, t + kConsumersB, ... (group 0 writes them)
  for (int c = t; c < C; c += kConsumersB) csum[c] = 0.f;
  const bool even = !(C & 1);

  for (int s = 0; s < n_slabs; ++s) {
    const int slot = s % cfg.stages;
    mbar_wait(&full[slot], (s / cfg.stages) & 1);
    const unsigned char* sl = land + slot * cfg.stage_bytes;
    const int rows = min(kTileRows, R - (split + s * cfg.n_split) * kTileRows);
    unsigned char* xb = xt + (SINGLE ? 0 : (s & 1) * cfg.xt_bytes);
    if (SINGLE) {   // the previous slab's products read this buffer
      add_chunks(acc, total);
      named_sync(1, kConsumersB);
    }
    // transpose: task (column pair or column, 8-row group) -> 16 bytes
    if (even) {
      const int pairs = Cp / 2;
      for (int e = t; e < pairs * 8; e += kConsumersB) {
        const int cp = e % pairs, rg = e / pairs;
        uint32_t lo[4] = {0u, 0u, 0u, 0u}, hi[4] = {0u, 0u, 0u, 0u};
        if (2 * cp < C) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = rg * 8 + i;
            const uint32_t v = r < rows
                ? *reinterpret_cast<const uint32_t*>(sl + (static_cast<size_t>(r) * C + 2 * cp) * 2)
                : 0u;
            lo[i / 2] |= (v & 0xFFFFu) << (16 * (i & 1));
            hi[i / 2] |= (v >> 16) << (16 * (i & 1));
          }
        }
        *reinterpret_cast<uint4*>(xb + b128_offset(2 * cp, rg * 8, Cp)) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(xb + b128_offset(2 * cp + 1, rg * 8, Cp)) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
      }
    } else {
      const uint16_t* sv = reinterpret_cast<const uint16_t*>(sl);
      for (int e = t; e < Cp * 8; e += kConsumersB) {
        const int c = e % Cp, rg = e / Cp;
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (c < C) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = rg * 8 + i;
            const uint32_t v = r < rows ? sv[static_cast<size_t>(r) * C + c] : 0u;
            w[i / 2] |= v << (16 * (i & 1));
          }
        }
        *reinterpret_cast<uint4*>(xb + b128_offset(c, rg * 8, Cp)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    // the previous slab's products (they read the other buffer) are done
    // before any warpgroup passes the barrier, which the next slab's
    // transpose into that buffer follows
    if (!SINGLE) add_chunks(acc, total);   // (slab 0 adds the zeros acc starts at)
    fence_proxy_async();
    named_sync(1, kConsumersB);
    // every thread has read the stage: land the slab `stages` on there
    if (t == 0 && s + cfg.stages < n_slabs)
      land_tile(xbytes, static_cast<size_t>(C) * 2, R, split + (s + cfg.stages) * cfg.n_split,
                land + slot * cfg.stage_bytes, &full[slot]);

    // column sums of the slab from x^T, in row order
    if (group == 0) {
      for (int c = t; c < C; c += kConsumersB) {
        float sum = 0.f;
        for (int rg = 0; rg < 8; ++rg) {
          const uint4 v = *reinterpret_cast<const uint4*>(xb + b128_offset(c, rg * 8, Cp));
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sum += __uint_as_float(w[i] << 16);
            sum += __uint_as_float(w[i] & 0xFFFF0000u);
          }
        }
        csum[c] += sum;
      }
    }
    issue_chunks(acc, xb, cI, cJ);   // runs while the next slab lands
  }
  add_chunks(acc, total);

  // this split's partials: the chunks' entries inside C x C, the column sums
  float* partial = work + static_cast<size_t>(split) * (static_cast<size_t>(C) * C + C);
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int c = 0; c < kChunksPerWG; ++c) {
    if (!has[c]) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = cI[c] * 64 + 16 * wr + g + 8 * h;
          const int j = cJ[c] * 64 + 8 * jj + 2 * q + e;
          if (i < C && j < C)
            partial[static_cast<size_t>(i) * C + j] = total[c][4 * jj + 2 * h + e];
        }
  }
  if (group == 0)
    for (int c = t; c < C; c += kConsumersB) partial[static_cast<size_t>(C) * C + c] = csum[c];
}

// ---- float32 input: 3xTF32 on wgmma ---------------------------------------

// the smallest wgmma N (8, 16, 32, 64) that covers chunk J's columns below
// n_cols
__device__ __forceinline__ int chunk_n(int n_cols, int J) {
  const int cols = min(64, n_cols - 64 * J);
  return cols <= 8 ? 8 : cols <= 16 ? 16 : cols <= 32 ? 32 : 64;
}

// The float32 input's chunks of x^T's C + 1 rows (the row of ones
// included): 64-row chunks I against column chunks J, I <= J, row by row;
// where the last 64-column chunk holds 8 columns or fewer (C = 66, 128,
// 194, 322 with the ones row), it merges into the chunk before it (N = 72,
// which reads A once for both), and, where it holds columns of x, one more
// chunk, the last rows against them (N = 8), closes the triangle.
struct TF32Chunks {
  int nI, nJ, merged, closing;
  __host__ __device__ explicit TF32Chunks(int C) {
    const int n_cols = C + 1;
    nI = (n_cols + 63) / 64;
    merged = nI >= 2 && n_cols - 64 * (nI - 1) <= 8;
    closing = merged && n_cols - 64 * (nI - 1) > 1;
    nJ = nI - merged;
  }
  __host__ __device__ int count() const { return nJ * (nJ + 1) / 2 + closing; }
  // chunk k -> its first row, first column and wgmma N
  __device__ void at(int k, int C, int& r0, int& c0, int& N) const {
    if (k < nJ * (nJ + 1) / 2) {
      int I, J;
      upper_index(k, nJ, I, J);
      r0 = 64 * I;
      c0 = 64 * J;
      N = merged && J == nJ - 1 ? 72 : chunk_n(C + 1, J);
    } else {
      r0 = c0 = 64 * (nI - 1);
      N = 8;
    }
  }
};

// D = the slab's 3xTF32 products of the chunk at rows r0, columns c0 (those
// of them in the mask `products`), from zero: lo_I hi_J and hi_I lo_J
// first, hi_I hi_J last (x^T's hi and lo
// parts are `part` bytes apart; a K step is 8 slab rows, 4 steps a panel of
// cr rows of 128 bytes)
template <int N>
__device__ __forceinline__ void chunk_tf32(float (&acc)[36], const unsigned char* xb, size_t part,
                                           int cr, int steps, int r0, int c0, int products) {
  const unsigned char* Ah = xb + r0 * 128;
  const unsigned char* Bh = xb + c0 * 128;
  int accumulate = 0;
#pragma unroll
  for (int which = 0; which < 3; ++which) {
    if (!(products & (1 << which))) continue;
    const unsigned char* A = which == 0 ? Ah + part : Ah;
    const unsigned char* B = which == 1 ? Bh + part : Bh;
    for (int k = 0; k < steps; ++k) {
      const size_t off = static_cast<size_t>(k >> 2) * cr * 128 + 32 * (k & 3);
      wgmma_ss_tf32<N>(acc, desc_b128(A + off), desc_b128(B + off), accumulate);
      accumulate = 1;
    }
  }
}

// waits for the slab's products and adds them to the totals
__device__ __forceinline__ void add_tf32(float (&acc)[36], float (&total)[36]) {
  wgmma_wait<0>();
  fence_acc(acc);
#pragma unroll
  for (int i = 0; i < 36; ++i) total[i] += acc[i];
}

template <bool SINGLE>   // one x^T buffer (where two do not fit)
__global__ void __launch_bounds__(kConsumersB, 1)
stats_tf32(const float* __restrict__ x, int R, int C, Cfg cfg, float* __restrict__ work) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* xt = smem;                        // the x^T buffers
  unsigned char* land = smem + cfg.land_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(land + cfg.stages * cfg.stage_bytes);
  const int group = blockIdx.x % cfg.groups, split = blockIdx.x / cfg.groups;
  const int cr = cfg.cr, slab = cfg.slab, steps = slab / 8;
  const size_t part = cfg.xt_bytes / 2;
  const TF32Chunks chunks(C);
  const int n_slabs = split_slabs(R, split, cfg.n_split, slab);
  const unsigned char* xbytes = reinterpret_cast<const unsigned char*>(x);
  const size_t row_bytes = static_cast<size_t>(C) * 4;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < cfg.stages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (t == 0)
    for (int s = 0; s < cfg.stages && s < n_slabs; ++s)
      land_tile(xbytes, row_bytes, R, split + s * cfg.n_split, land + s * cfg.stage_bytes,
                &full[s], slab);
  const int warp = t / 32, wg = warp / 4;
  const int lane = t % 32, wr = warp % 4;
  // this warpgroup's chunk and products (a warpgroup with none issues no
  // product). With 2 chunks or 1 (C < 72), each chunk's products chain 3
  // slab-deep wgmma a K step on one accumulator, and a chain pays each
  // wgmma's latency: warpgroups 0, 2 and 3 then take chunk 0's lo hi, hi lo
  // and hi hi, three chains a third as long, added at the end.
  int k = group * kChunksPerBlock + wg, products = 7;
  if (cfg.by_product) {
    k = wg == 1 ? 1 : 0;
    products = wg == 1 ? 7 : 1 << (wg == 0 ? 0 : wg - 1);
  }
  const bool has = k < chunks.count();
  int r0 = 0, c0 = 0, cn = 8;
  chunks.at(has ? k : 0, C, r0, c0, cn);
  float total[36], acc[36];   // one chunk a warpgroup, N / 2 of them in use
#pragma unroll
  for (int i = 0; i < 36; ++i) total[i] = acc[i] = 0.f;
  // this thread's first transpose task and the step to its next (no
  // division in the loop)
  const int c_first = t % cr, rg_first = t / cr;
  const int c_step = kConsumersB % cr, rg_step = kConsumersB / cr;

  for (int s = 0; s < n_slabs; ++s) {
    const int slot = s % cfg.stages;
    mbar_wait(&full[slot], (s / cfg.stages) & 1);
    const float* sl = reinterpret_cast<const float*>(land + slot * cfg.stage_bytes);
    const int rows = min(slab, R - (split + s * cfg.n_split) * slab);
    unsigned char* xb = xt + (SINGLE ? 0 : (s & 1) * cfg.xt_bytes);
    if (SINGLE) {   // the previous slab's products read this buffer
      add_tf32(acc, total);
      named_sync(1, kConsumersB);
    }
    // transpose and split: task (column c, 4-row group rg) -> 16 bytes of hi
    // and of lo (x^T's row C is ones, the rows past it zero)
    for (int c = c_first, rg = rg_first; rg < slab / 4;) {
      uint32_t h[4], l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * rg + i;
        const float v = c < C ? sl[static_cast<size_t>(r < rows ? r : 0) * C + c] : 1.f;
        tf32_split(r < rows && c <= C ? v : 0.f, h[i], l[i]);
      }
      const uint32_t off = b128_at(c, 16 * rg, cr);
      *reinterpret_cast<uint4*>(xb + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(xb + part + off) = make_uint4(l[0], l[1], l[2], l[3]);
      c += c_step;
      rg += rg_step;
      if (c >= cr) {
        c -= cr;
        ++rg;
      }
    }
    // the previous slab's products (they read the other buffer) are done
    // before any warpgroup passes the barrier
    if (!SINGLE) add_tf32(acc, total);
    fence_proxy_async();
    named_sync(1, kConsumersB);
    // every thread has read the stage: land the slab `stages` on there
    if (t == 0 && s + cfg.stages < n_slabs)
      land_tile(xbytes, row_bytes, R, split + (s + cfg.stages) * cfg.n_split,
                land + slot * cfg.stage_bytes, &full[slot], slab);
    if (has) {
      wgmma_fence();
      if (cn == 72) chunk_tf32<72>(acc, xb, part, cr, steps, r0, c0, products);
      else if (cn == 64) chunk_tf32<64>(acc, xb, part, cr, steps, r0, c0, products);
      else if (cn == 32) chunk_tf32<32>(acc, xb, part, cr, steps, r0, c0, products);
      else if (cn == 16) chunk_tf32<16>(acc, xb, part, cr, steps, r0, c0, products);
      else chunk_tf32<8>(acc, xb, part, cr, steps, r0, c0, products);
      wgmma_commit();
    }
  }
  add_tf32(acc, total);
  if (cfg.by_product) {
    // warpgroups 2 and 3 hand their products of chunk 0 to warpgroup 0
    // through shared memory, which every product has done reading
    float* handed = reinterpret_cast<float*>(smem);
    const int lt = t % 128;
    named_sync(1, kConsumersB);
    if (wg >= 2)
#pragma unroll
      for (int i = 0; i < 36; ++i) handed[((wg - 2) * 36 + i) * 128 + lt] = total[i];
    named_sync(1, kConsumersB);
    if (wg == 0)
#pragma unroll
      for (int i = 0; i < 36; ++i)
        total[i] = (total[i] + handed[i * 128 + lt]) + handed[(36 + i) * 128 + lt];
  }

  // this split's partials: the chunk's entries inside C x C, the column sums
  float* partial = work + static_cast<size_t>(split) * (static_cast<size_t>(C) * C + C);
  const int g = lane / 4, q = lane % 4;
  if (has && (!cfg.by_product || wg < 2)) {
#pragma unroll
    for (int jj = 0; jj < 9; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = r0 + 16 * wr + g + 8 * h;
          const int j = c0 + 8 * jj + 2 * q + e;
          // entry (i, C) against the row of ones: column i's sum
          if (8 * jj < cn && i < C && j <= C)
            partial[j < C ? static_cast<size_t>(i) * C + j : static_cast<size_t>(C) * C + i] =
                total[4 * jj + 2 * h + e];
        }
  }
}

// The partials of every split added in split order; entry (i, j) of the
// Gram from the upper triangle's (min(i, j), max(i, j)).
__global__ void stats_reduce(const float* __restrict__ work, int n_split, int C,
                             float* __restrict__ colsum, float* __restrict__ gram) {
  const size_t n = static_cast<size_t>(C) * C + C;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  size_t src = idx;
  if (idx < static_cast<size_t>(C) * C) {
    const int i = static_cast<int>(idx / C), j = static_cast<int>(idx % C);
    if (i > j) src = static_cast<size_t>(j) * C + i;
  }
  float s = 0.f;
  for (int p = 0; p < n_split; ++p) s += work[static_cast<size_t>(p) * n + src];
  if (idx < static_cast<size_t>(C) * C) {
    gram[idx] = s;
  } else {
    colsum[idx - static_cast<size_t>(C) * C] = s;
  }
}

template <typename T, typename Kernel>
int launch_stats(Kernel kernel, const void* x, int R, int C, const Cfg& cfg, size_t smem,
                 void* work, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(cfg.n_split * cfg.groups), kConsumersB, smem, s>>>(
      static_cast<const T*>(x), R, C, cfg, static_cast<float*>(work));
  return static_cast<int>(cudaGetLastError());
}

// the blocks a split takes: chunk groups of 4
int chunk_groups(int x_bf16, int C) {
  const int nI = (C + 63) / 64;
  const int n = x_bf16 ? nI * (nI + 1) / 2 : TF32Chunks(C).count();
  return (n + kChunksPerBlock - 1) / kChunksPerBlock;
}

}  // namespace

// The split count for R rows of width C on `sms` SMs (the wrapper sizes
// `work` from it): about one block a SM, each chunk group of a split a
// block, at most one split a slab.
extern "C" int ga_decoder_stats_plan(int x_bf16, int R, int C, int sms, int* n_split) {
  if (R < 0 || C <= 0 || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int slabs = (R + kTileRows - 1) / kTileRows;
  int n = sms / chunk_groups(x_bf16, C);
  n = n < 1 ? 1 : n;
  *n_split = slabs < n ? (slabs < 1 ? 1 : slabs) : n;
  return 0;
}

// x (R, C) contiguous and 16-byte aligned, float32 (x_bf16 0) or bfloat16
// (1), C >= 1 (up to what shared memory holds: about 880 bfloat16, 700
// float32); n_split from
// ga_decoder_stats_plan with the device's SM count; work holds n_split x
// (C * C + C) floats. Writes colsum (C,) and gram (C, C), float32.
extern "C" int ga_decoder_stats(const void* x, int x_bf16, int R, int C, int n_split, void* work,
                                void* colsum, void* gram, void* stream) {
  if (R < 0 || C <= 0 || n_split <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Cfg cfg{};
  cfg.n_split = n_split;
  cfg.groups = chunk_groups(x_bf16, C);
  const size_t budget = kSmemLimit - 1024 - 2 * kMaxStages * sizeof(uint64_t);
  size_t csum_bytes = round_up(static_cast<size_t>(C) * sizeof(float), 1024);
  const int nI = (C + 63) / 64;
  if (x_bf16) {
    cfg.slab = kTileRows;
    cfg.stage_bytes = round_up(static_cast<size_t>(kTileRows) * C * 2, 128);
    cfg.xt_bytes = static_cast<size_t>(nI) * 64 * 128;
    cfg.xt_buffers = 2 * cfg.xt_bytes + csum_bytes + cfg.stage_bytes <= budget ? 2 : 1;
    cfg.csum_off = round_up(cfg.xt_buffers * cfg.xt_bytes, 1024);
  } else {
    // x^T (C + 1 rows: row C is ones, so the Gram's entries (i, C) are the
    // column sums) as hi and lo takes 2 x max(slab, 32) x roundup(C + 1, 8)
    // x 4 bytes a buffer (a panel's rows are 32 values), and a 64-row
    // chunk's products read up to 64 rows past its start (the rows past C
    // feed only entries past C, which are dropped), so the last buffer has
    // that slack behind it. The first layout with 2 ring stages in: 64-row
    // slabs double buffered, 32-row ones, then one buffer; else the first
    // with 1 (16-row slabs in one buffer reach C = 700).
    cfg.cr = (C + 1 + 7) / 8 * 8;
    const size_t slack = static_cast<size_t>((cfg.cr + 63) / 64 * 64 - cfg.cr) * 128;
    csum_bytes = 0;
    bool found = false;
    for (int min_stages = 2; min_stages >= 1 && !found; --min_stages)
      for (int bufs = 2; bufs >= 1 && !found; --bufs)
        for (int slab = kTileRows; slab >= 16 && !found; slab /= 2) {
          const size_t xt = 2 * static_cast<size_t>(slab > 32 ? slab / 32 : 1) * cfg.cr * 128;
          const size_t stage = round_up(static_cast<size_t>(slab) * C * 4, 128);
          const size_t off = round_up(bufs * xt + slack, 1024);
          if (off + min_stages * stage <= budget) {
            cfg.slab = slab;
            cfg.stage_bytes = stage;
            cfg.xt_bytes = xt;
            cfg.xt_buffers = bufs;
            cfg.csum_off = off;
            found = true;
          }
        }
    if (!found) return static_cast<int>(cudaErrorInvalidValue);
  }
  cfg.land_off = cfg.csum_off + csum_bytes;
  if (cfg.land_off + cfg.stage_bytes > budget) return static_cast<int>(cudaErrorInvalidValue);
  const size_t st = (budget - cfg.land_off) / cfg.stage_bytes;
  cfg.stages = static_cast<int>(st < kMaxStages ? st : kMaxStages);
  // chunk 0's products split over three warpgroups where a block has 2
  // chunks or 1 and its x^T and ring can hold the hand-over (2 x 128 x 36
  // floats) at the end
  cfg.by_product = !x_bf16 && TF32Chunks(C).count() <= 2 &&
                   cfg.land_off + cfg.stages * cfg.stage_bytes >= 2 * 128 * 36 * sizeof(float);
  const size_t smem = 1024 + cfg.land_off + cfg.stages * cfg.stage_bytes +
                      kMaxStages * sizeof(uint64_t);
  const int err = x_bf16 ? launch_stats<__nv_bfloat16>(
                              cfg.xt_buffers == 1 ? stats_bf16<true> : stats_bf16<false>, x, R,
                              C, cfg, smem, work, s)
                        : launch_stats<float>(
                              cfg.xt_buffers == 1 ? stats_tf32<true> : stats_tf32<false>, x, R,
                              C, cfg, smem, work, s);
  if (err != 0) return err;
  const long long n = static_cast<long long>(C) * C + C;
  stats_reduce<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(work), n_split, C, static_cast<float*>(colsum),
      static_cast<float*>(gram));
  return static_cast<int>(cudaGetLastError());
}
