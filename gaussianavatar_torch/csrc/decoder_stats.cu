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
// 0.0075 ms on the bfloat16 tensor cores, 0.11 ms in float32 FFMA).
//
// The design (decoder_common.cuh): the rows are cut into 64-row slabs, and
// split s of n_split (about one per SM) takes the slabs s, s + n_split, ...
// (neighbouring blocks read neighbouring rows); a block walks its slabs,
// which one of its threads lands with one cp.async.bulk each into a ring of
// stages, reissuing a stage as soon as every thread has read it. Of the Gram
// it computes only what lies on or above the diagonal:
//  - bfloat16 input: the consumers transpose each slab into x^T (C rows of
//    64 values, K-major, 128-byte swizzle) in shared memory, double
//    buffered, and wgmma m64n64k16 (both operands from shared memory)
//    computes the 64 x 64 chunks (I, J), I <= J, of the Gram; the products
//    are exact, each slab's 64-row sum runs on the tensor cores from zero
//    and is then added to float32 running totals in registers (the tensor
//    cores' own accumulation drifts over long chains). A slab's products run
//    while the next slab is transposed. A block is 4 warpgroups of one chunk
//    each (acc and total: 64 registers), so it computes up to 4 chunks:
//    C <= 128 takes one chunk group (3 chunks), C = 194 three; the groups of
//    one split are neighbouring blocks that read the same slabs together,
//    so device memory is read once and L2 serves the other groups' reads.
//  - float32 input (the first stage, and every stage of the float32
//    decoder): FFMA, with no TF32 (the plain version is true float32): each
//    consumer thread owns one 8 x 8 tile (a, b), a <= b, of the Gram's upper
//    triangle of 8-blocks (T = n(n + 1) / 2 tiles for n = ceil(C / 8)), in
//    groups of at most 128 tiles, and a block's 256 threads deal a slab's
//    rows to `reps` (2-8) replicas of its tiles, added at the end in replica
//    order. Each slab's products run from zero, then add into float32
//    totals.
// The column sums: per slab from zero (in row order), then into a float32
// total, by the block's first chunk group.
// Deterministic: every thread's share of the work is fixed, no atomics; a
// second kernel adds the n_split partials in split order and mirrors the
// upper triangle into the lower. Two runs give the same bits.

#include "decoder_common.cuh"

namespace {

using namespace ga_dec;

// bfloat16: four warpgroups of one chunk each (acc and total: 64
// registers); float32: two of 8 x 8 tiles (128 registers). No producer
// warp: thread 0 reissues each stage once every thread has read it.
constexpr int kConsumersB = 512, kConsumersF = 256;
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
  size_t xt_bytes;       // one x^T buffer (bfloat16 path)
  int xt_buffers;        // 2, or 1 where two do not fit
  size_t csum_off;       // the column sums' float32 totals
  size_t land_off;
  int n_split;
  int groups;            // chunk groups (blocks per split)
  int per;               // float32 path: tiles per group
  int reps;              // float32 path: replicas of the group's tiles
};

// the split's slabs: first, first + n_split, ... below ceil(R / 64)
__device__ __forceinline__ int split_slabs(int R, int split, int n_split) {
  const int total = (R + kTileRows - 1) / kTileRows;
  return split < total ? (total - split + n_split - 1) / n_split : 0;
}

// ---- bfloat16 input: wgmma ------------------------------------------------

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

// ---- float32 input: FFMA ----------------------------------------------------

// 8 values x[row][c0 .. c0 + 7], zero past C; `vec` the rows' alignment
__device__ __forceinline__ void load8f(const float* row, int c0, int C, int vec, float (&v)[8]) {
  if (c0 + 8 <= C) {
    if (vec == 16) {
      const float4 a = *reinterpret_cast<const float4*>(row + c0);
      const float4 b = *reinterpret_cast<const float4*>(row + c0 + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      return;
    }
    if (vec == 8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 p = *reinterpret_cast<const float2*>(row + c0 + 2 * i);
        v[2 * i] = p.x;
        v[2 * i + 1] = p.y;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = c0 + i < C ? row[c0 + i] : 0.f;
}

__global__ void __launch_bounds__(kConsumersF, 1)
stats_f32(const float* __restrict__ x, int R, int C, Cfg cfg, int vec, float* __restrict__ work) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* red = reinterpret_cast<float*>(smem);     // the replicas' totals, at the end
  float* csum = reinterpret_cast<float*>(smem + cfg.csum_off);
  unsigned char* land = smem + cfg.land_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(land + cfg.stages * cfg.stage_bytes);
  const int group = blockIdx.x % cfg.groups, split = blockIdx.x / cfg.groups;
  const int n8 = (C + 7) / 8;
  const int n_tiles = n8 * (n8 + 1) / 2;
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
      land_tile(xbytes, static_cast<size_t>(C) * 4, R, split + s * cfg.n_split,
                land + s * cfg.stage_bytes, &full[s]);
  // this thread's tile and replica
  const int per = cfg.per;
  const int rep = t / per, k = group * per + t % per;
  const bool active = rep < cfg.reps && k < n_tiles;
  int a = 0, b = 0;
  upper_index(active ? k : 0, n8, a, b);
  float total[8][8], acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) total[i][j] = 0.f;
  for (int c = t; c < C; c += kConsumersF) csum[c] = 0.f;

  for (int s = 0; s < n_slabs; ++s) {
    const int slot = s % cfg.stages;
    mbar_wait(&full[slot], (s / cfg.stages) & 1);
    const float* sl = reinterpret_cast<const float*>(land + slot * cfg.stage_bytes);
    const int rows = min(kTileRows, R - (split + s * cfg.n_split) * kTileRows);
    if (active) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
      for (int r = rep; r < rows; r += cfg.reps) {
        float u[8], v[8];
        load8f(sl + static_cast<size_t>(r) * C, 8 * a, C, vec, u);
        load8f(sl + static_cast<size_t>(r) * C, 8 * b, C, vec, v);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(u[i], v[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) total[i][j] += acc[i][j];
    }
    if (group == 0) {
      for (int c = t; c < C; c += kConsumersF) {
        float sum = 0.f;
        for (int r = 0; r < rows; ++r) sum += sl[static_cast<size_t>(r) * C + c];
        csum[c] += sum;
      }
    }
    named_sync(1, kConsumersF);
    if (t == 0 && s + cfg.stages < n_slabs)
      land_tile(xbytes, static_cast<size_t>(C) * 4, R, split + (s + cfg.stages) * cfg.n_split,
                land + slot * cfg.stage_bytes, &full[slot]);
  }

  // the replicas' totals added in replica order (the ring is idle now)
  named_sync(1, kConsumersF);
  if (cfg.reps > 1 && active && rep > 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[((rep - 1) * per + t % per) * 64 + i * 8 + j] = total[i][j];
  }
  named_sync(1, kConsumersF);
  float* partial = work + static_cast<size_t>(split) * (static_cast<size_t>(C) * C + C);
  if (active && rep == 0) {
    for (int p = 1; p < cfg.reps; ++p)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) total[i][j] += red[((p - 1) * per + t) * 64 + i * 8 + j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gi = 8 * a + i, gj = 8 * b + j;
        if (gi < C && gj < C) partial[static_cast<size_t>(gi) * C + gj] = total[i][j];
      }
  }
  if (group == 0)
    for (int c = t; c < C; c += kConsumersF) partial[static_cast<size_t>(C) * C + c] = csum[c];
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

// the blocks a split takes: chunk groups of 4 (bfloat16) or tile groups of
// at most 128 (float32: each tile then has 2 or more replicas)
int chunk_groups(int x_bf16, int C) {
  if (x_bf16) {
    const int nI = (C + 63) / 64;
    return (nI * (nI + 1) / 2 + kChunksPerBlock - 1) / kChunksPerBlock;
  }
  const int n8 = (C + 7) / 8;
  return (n8 * (n8 + 1) / 2 + 127) / 128;
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
// (1), C >= 1 (up to what shared memory holds: about 880); n_split from
// ga_decoder_stats_plan with the device's SM count; work holds n_split x
// (C * C + C) floats. Writes colsum (C,) and gram (C, C), float32.
extern "C" int ga_decoder_stats(const void* x, int x_bf16, int R, int C, int n_split, void* work,
                                void* colsum, void* gram, void* stream) {
  if (R < 0 || C <= 0 || n_split <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int esize = x_bf16 ? 2 : 4;
  Cfg cfg{};
  cfg.stage_bytes = round_up(static_cast<size_t>(kTileRows) * C * esize, 128);
  cfg.n_split = n_split;
  cfg.groups = chunk_groups(x_bf16, C);
  const size_t budget = kSmemLimit - 1024 - 2 * kMaxStages * sizeof(uint64_t);
  const size_t csum_bytes = round_up(static_cast<size_t>(C) * sizeof(float), 1024);
  size_t head;   // x^T buffers or the replicas' totals
  if (x_bf16) {
    const int nI = (C + 63) / 64;
    cfg.reps = 1;
    cfg.xt_bytes = static_cast<size_t>(nI) * 64 * 128;
    cfg.xt_buffers = 2 * cfg.xt_bytes + csum_bytes + cfg.stage_bytes <= budget ? 2 : 1;
    head = cfg.xt_buffers * cfg.xt_bytes;
  } else {
    const int n8 = (C + 7) / 8;
    const int n_tiles = n8 * (n8 + 1) / 2;
    cfg.per = (n_tiles + cfg.groups - 1) / cfg.groups;
    const int reps = kConsumersF / cfg.per;
    cfg.reps = reps > 8 ? 8 : reps;
    cfg.xt_bytes = 0;
    cfg.xt_buffers = 0;
    head = cfg.reps > 1 ? static_cast<size_t>(kConsumersF) * 64 * sizeof(float) : 0;
  }
  cfg.csum_off = round_up(head, 1024);
  cfg.land_off = cfg.csum_off + csum_bytes;
  if (cfg.land_off + cfg.stage_bytes > budget) return static_cast<int>(cudaErrorInvalidValue);
  const size_t st = (budget - cfg.land_off) / cfg.stage_bytes;
  cfg.stages = static_cast<int>(st < kMaxStages ? st : kMaxStages);
  const size_t smem = 1024 + cfg.land_off + cfg.stages * cfg.stage_bytes +
                      kMaxStages * sizeof(uint64_t);
  const dim3 grid(n_split * cfg.groups);
  cudaError_t err;
  if (x_bf16) {
    const auto kernel = cfg.xt_buffers == 1 ? stats_bf16<true> : stats_bf16<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kConsumersB, smem, s>>>(static_cast<const __nv_bfloat16*>(x), R, C, cfg,
                                           static_cast<float*>(work));
  } else {
    err = cudaFuncSetAttribute(stats_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    stats_f32<<<grid, kConsumersF, smem, s>>>(static_cast<const float*>(x), R, C, cfg,
                                           pow2_align(static_cast<size_t>(C) * 4),
                                           static_cast<float*>(work));
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(C) * C + C;
  stats_reduce<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(work), n_split, C, static_cast<float*>(colsum),
      static_cast<float*>(gram));
  return static_cast<int>(cudaGetLastError());
}
