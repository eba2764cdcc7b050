// H-dfwd: the forward of a fused POP decoder stage, for Hopper (sm_90a),
// with a plain C interface (loaded through ctypes by
// gaussianavatar_torch/ops/decoder_stage.py `stage_fwd`).
//
// z = act(x Wp + bp) for x (R, C), the BatchNorm-folded weights Wp (C, H)
// and bias bp (H,), any C >= 1 and H >= 1: the product accumulates in
// float32, and the bias and the activation (softplus or relu) run in the
// product's epilogue, so the pre-activation is never written. It has no
// Pallas counterpart: the JAX package's ShapeDecoderFused
// (gaussianavatar_tpu/models/decoder.py:220, `actv(inp.astype(cdt) @ Wp +
// bp)`) leaves the fusion to XLA.
//
// Rounding, as the JAX stage on the CPU and the plain version
// (`stage_fwd_plain`): bfloat16 mode rounds the float32 sum to bfloat16,
// adds the bias in bfloat16, and rounds after every operation of the
// activation (softplus: exp, log1p and the final sum); float32 mode adds
// the bias to the float32 sum and applies the activation in float32. Only
// the product's summation order differs from the plain version's cuBLAS,
// and in float32 mode each term's dropped lo lo (about 2^-22 of it, below).
//
// What bounds it on the H100: the bytes, reading x and writing z once (a
// 128-wide bfloat16 stage at R = 445,568: 114 + 114 MB, 0.068 ms at 3.35
// TB/s); the product's 2 R C H operations (0.015 ms on the bfloat16 tensor
// cores there) sit under that, and the epilogue's instructions come close.
// In float32 mode the bytes double (0.136 ms at 128 -> 128) and the product
// is three TF32 products, 3 x 2 R C H operations at 495 TFLOP/s (0.088 ms
// there): bytes still bound it up to about C = H = 200; the 322 -> 256 skip
// stage of --hsize 256 is bound by its operations (0.45 ms).
//
// The design (decoder_common.cuh): persistent blocks of 4 warpgroups and no
// producer warp, so a thread gets 128 registers. A block loads its slice of
// Wp and bp into shared memory once, then its warpgroups take the 64-row
// tiles of x in turn (tile = blockIdx.x + j gridDim.x, warpgroup j % 4). A
// warpgroup owns 1 or 2 stages of the ring: one of its threads lands each
// tile with one cp.async.bulk, and reissues the stage for its next tile as
// soon as the warpgroup has read it, so the copy overlaps the epilogue.
//  - bfloat16 mode: wgmma m64n64k16 with A in registers (each lane loads its
//    rows' values from the landed tile, casting float32 input to bfloat16)
//    and Wp^T from shared memory (K-major, 128-byte swizzle, written once),
//    two 32-wide K blocks in flight. K is permuted inside each 32-wide block
//    so that a lane's A values for two K steps are 8 consecutive values of
//    its row (one 16-byte load where the rows allow it); Wp^T's rows take
//    the same permutation. The epilogue runs from the accumulator registers
//    in bfloat16x2 arithmetic (the bias add, max(u, 0) and softplus's
//    log1p(exp(-|u|)) term from a 2,048-entry table of the same bits,
//    below), then stores whole 8-column groups, 16 bytes a lane, after a
//    4 x 4 transpose across each quad of lanes (a warp writes 64 contiguous
//    bytes of 8 rows); 2-byte stores where H is not a multiple of 8.
//  - float32 mode (--bf16_decoder 0): 3xTF32 (decoder_common.cuh) on wgmma
//    m64nNBk8, NB = 64 or 32. Single-pass TF32 keeps 11 bits of each
//    operand and would miss the float32 contract (the plain version and the
//    JAX stage are true float32) by two orders; the three products keep it.
//    Each lane loads 4 consecutive values of each of its two rows a 16-wide
//    K block (K permuted as above, Wp^T's rows alike) and splits them into
//    tf32 hi and lo in registers; Wp^T is written once as hi and lo, K-major
//    and swizzled. Per K step lo hi and hi lo accumulate into one set of
//    registers and hi hi into another, so the chain of large partial sums
//    takes one tensor-core rounding a step, not three; the epilogue adds the
//    two sets, the bias and the float32 activation (softplus as
//    jax.nn.softplus) and stores column pairs.
// Any width: K is padded with zeros to the K blocks (Wp^T's panels: 64
// bfloat16 or 32 tf32 values), loads past C are masked, columns past H are
// not stored, and the vector width of the loads follows the rows'
// alignment. The output columns are cut into groups of NB columns (bfloat16:
// 64 NCH, NCH 1 or 2; float32: 64 or 32), one group per blockIdx.y; a wider
// H takes more groups, each reading x again (from L2 while the groups run
// side by side). Shared memory per block: Wp's slice (NB x roundup(C, 64)
// bfloat16, or hi and lo of NB x roundup(C, 32) tf32), NB bias values, the 4
// KB table (bfloat16), and the ring (consumers x 1 or 2 stages of 64 C esize
// bytes). The launcher takes the widest group that leaves room for 2 stages
// in 227 KB, then the most consuming warpgroups (4, 2, 1) and stages each
// (2, 1) that fit. At H = 256 the skip stage (C = 322) takes NCH 2 (96 KB of
// Wp^T) and 2 warpgroups of 1 stage (40 KB each), in two column groups; its
// float32 form takes NB = 32 (90 KB of hi and lo) and one warpgroup of one
// stage (81 KB), in eight: there the tile's loads overlap only the epilogue.

#include "decoder_common.cuh"

namespace {

using namespace ga_dec;

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// softplus as jax.nn.softplus computes it, max(u, 0) + log1p(exp(-|u|)),
// with the hardware's exp and log (ex2.approx, lg2.approx: about 2^-22 of
// their results, so within 5e-7 of the exact term, in far fewer
// instructions than the accurate libm's log1pf and expf)
__device__ __forceinline__ float softplus_f32(float u) {
  return fmaxf(u, 0.f) + __logf(1.f + __expf(-fabsf(u)));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 8 values x[row][c0 .. c0 + 7] of a landed row, as 4 packed bfloat16
// pairs; zero past C. `vec` is the rows' alignment in bytes.
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int c0, int C, int vec,
                                      uint32_t (&w)[4]) {
  if (c0 + 8 <= C) {
    if (vec == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + c0);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      return;
    }
    if (vec >= 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const uint32_t*>(row + c0 + 2 * i);
      return;
    }
  }
  const uint16_t* r = reinterpret_cast<const uint16_t*>(row);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = c0 + 2 * i < C ? r[c0 + 2 * i] : 0u;
    const uint32_t hi = c0 + 2 * i + 1 < C ? r[c0 + 2 * i + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
}

__device__ __forceinline__ void load8(const float* row, int c0, int C, int vec,
                                      uint32_t (&w)[4]) {
  if (c0 + 8 <= C) {
    if (vec == 16) {
      const float4 a = *reinterpret_cast<const float4*>(row + c0);
      const float4 b = *reinterpret_cast<const float4*>(row + c0 + 4);
      w[0] = pack_bf16(a.x, a.y); w[1] = pack_bf16(a.z, a.w);
      w[2] = pack_bf16(b.x, b.y); w[3] = pack_bf16(b.z, b.w);
      return;
    }
    if (vec == 8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = *reinterpret_cast<const float2*>(row + c0 + 2 * i);
        w[i] = pack_bf16(v.x, v.y);
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = c0 + 2 * i < C ? row[c0 + 2 * i] : 0.f;
    const float hi = c0 + 2 * i + 1 < C ? row[c0 + 2 * i + 1] : 0.f;
    w[i] = pack_bf16(lo, hi);
  }
}

// the actual column of operand K index k (the permutation inside each
// 32-wide block that lets a lane's A values be 8 consecutive columns):
// step t = k / 16, fragment position p = k % 16
__device__ __forceinline__ int actual_k(int k) {
  const int t = k >> 4, p = k & 15;
  return 32 * (t >> 1) + 8 * ((p & 7) >> 1) + 4 * (t & 1) + (p & 1) + 2 * (p >> 3);
}

struct Layout {
  int consumers;        // warpgroups that take tiles (a power of two): units of ksplit
  int per_wg;           // stages each of them owns (1 or 2)
  size_t stage_bytes;   // one ring stage
  size_t w_bytes;       // Wp's slice; the bias and the softplus table follow it
  size_t land_off;      // where the ring starts (1024-byte aligned)
  int ksplit;           // float32 mode: warpgroups that share a tile, each a share of K
  size_t xch_off;       // float32 mode, ksplit > 1: the shares' exchange of sums
};

// a block is 4 warpgroups (128 registers a thread)
constexpr int kWGs = 4, kThreads = 128 * kWGs;

// The bfloat16 softplus of a bfloat16 u, max(u, 0) + T(|u|), takes its
// second term from a table of T(|u|) = bf(log1p(bf(exp(-|u|)))) over the
// bfloat16 |u| in [2^-9, 2^7) (2,048 values, 4 KB of shared memory, each
// operation rounded as the plain version rounds it, so the bits are the
// same as computing it in place):
// below 2^-9 bf(exp(-|u|)) is 1 and T is T(2^-9); from 2^7 on exp(-|u|)
// is 0 in float32 and T is 0, which the last entry (127.5) holds already.
constexpr uint32_t kSpLo = 118u << 7;   // the bfloat16 bits of 2^-9
constexpr int kSpTable = 2048;

__device__ __forceinline__ uint16_t sp_entry(int i) {
  const float a = __uint_as_float((kSpLo + i) << 16);
  const __nv_bfloat16 t = __float2bfloat16_rn(log1pf(bf(expf(-a))));
  return *reinterpret_cast<const uint16_t*>(&t);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// T(|u|) of one bfloat16 u given as its 16 bits
__device__ __forceinline__ uint32_t sp_term(uint32_t ubits, const uint16_t* sp_tab) {
  const int i = min(max(static_cast<int>(ubits & 0x7FFFu) - static_cast<int>(kSpLo), 0),
                    kSpTable - 1);
  return sp_tab[i];
}

// z of two bfloat16 pre-activations, in bfloat16x2 arithmetic: each add
// rounds the exact sum of two bfloat16 values once, which is what rounding
// their float32 sum gives, so the bits are the plain version's; the max
// keeps a NaN (as torch.relu and softplus do)
template <bool RELU>
__device__ __forceinline__ uint32_t act_bf16x2(__nv_bfloat162 u, const uint16_t* sp_tab) {
  const __nv_bfloat162 m = __hmax2_nan(u, __float2bfloat162_rn(0.f));
  if (RELU) return bits(m);
  const uint32_t ub = bits(u);
  const uint32_t t = sp_term(ub & 0xFFFFu, sp_tab) | (sp_term(ub >> 16, sp_tab) << 16);
  return bits(__hadd2(m, bf2(t)));
}

// The 4 x 4 transpose of 32-bit words across the 4 lanes of a quad: lane q
// gives v[k] and ends with v[p] = lane p's v[q] (two butterfly stages).
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const bool hi = (q >> b) & 1;
#pragma unroll
    for (int k0 = 0; k0 < 4; ++k0) {
      if (k0 & (1 << b)) continue;
      const int k1 = k0 | (1 << b);
      const uint32_t send = hi ? v[k0] : v[k1];
      const uint32_t recv = __shfl_xor_sync(0xFFFFFFFFu, send, 1 << b);
      if (hi) v[k0] = recv; else v[k1] = recv;
    }
  }
}

// one 32-column block b of the tile's products: the A fragments of this
// lane's rows (ra, rb) for K steps 2b and 2b + 1
template <typename TX>
__device__ __forceinline__ void load_a(const TX* tl, int ra, int rb, int rows, int b, int q,
                                       int C, int vec, uint32_t (&a0)[4], uint32_t (&a1)[4]) {
  uint32_t wa[4] = {0u, 0u, 0u, 0u}, wb[4] = {0u, 0u, 0u, 0u};
  if (ra < rows) load8(tl + static_cast<size_t>(ra) * C, 32 * b + 8 * q, C, vec, wa);
  if (rb < rows) load8(tl + static_cast<size_t>(rb) * C, 32 * b + 8 * q, C, vec, wb);
  a0[0] = wa[0]; a0[1] = wb[0]; a0[2] = wa[1]; a0[3] = wb[1];
  a1[0] = wa[2]; a1[1] = wb[2]; a1[2] = wa[3]; a1[3] = wb[3];
}

template <int NCH>
__device__ __forceinline__ void mma_block(float (&acc)[NCH][32], const uint32_t (&a0)[4],
                                          const uint32_t (&a1)[4], const unsigned char* Bs,
                                          int b) {
  constexpr int NB = 64 * NCH;
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    // step 2b lies in panel b / 2 at 32 (2b % 4) bytes; step 2b + 1 32 bytes on
    const unsigned char* base = Bs + (b >> 1) * (NB * 128) + c * (64 * 128) + (b & 1) * 64;
    wgmma_rs_64x64(acc[c], a0, desc_b128(base), 1);
    wgmma_rs_64x64(acc[c], a1, desc_b128(base + 32), 1);
  }
  wgmma_commit();
}

// The tiles of warpgroup wg: local index i is tile blockIdx.x + (wg + i
// consumers) gridDim.x, landed in its stage wg per_wg + i % per_wg.
struct TileWalk {
  int wg, consumers, per_wg, n_tiles;
  __device__ int tile(int i) const {
    return static_cast<int>(blockIdx.x) + (wg + i * consumers) * static_cast<int>(gridDim.x);
  }
  __device__ int stage(int i) const { return wg * per_wg + i % per_wg; }
  __device__ uint32_t parity(int i) const { return (i / per_wg) & 1; }
};

// bfloat16 mode
template <typename TX, int NCH, bool RELU>
__global__ void __launch_bounds__(kThreads, 1)
stage_fwd_bf16(const TX* __restrict__ x, const __nv_bfloat16* __restrict__ Wp,
               const __nv_bfloat16* __restrict__ bp, int R, int C, int H, Layout L, int vec,
               __nv_bfloat16* __restrict__ z) {
  constexpr int NB = 64 * NCH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Bs = smem;                                   // Wp^T, K-major, swizzled
  __nv_bfloat162* bias_s = reinterpret_cast<__nv_bfloat162*>(smem + L.w_bytes);   // NB / 2 pairs
  uint16_t* sp_tab = reinterpret_cast<uint16_t*>(bias_s + NB / 2);
  unsigned char* land = smem + L.land_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(land + L.consumers * L.per_wg * L.stage_bytes);
  const size_t row_bytes = static_cast<size_t>(C) * sizeof(TX);
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);

  const int n0 = blockIdx.y * NB;
  const int Kp = (C + 63) / 64 * 64;
  const int wg = threadIdx.x / 128, lt = threadIdx.x % 128;   // warpgroup, its thread
  const TileWalk walk{wg, L.consumers, L.per_wg, (R + kTileRows - 1) / kTileRows};
  if (threadIdx.x == 0) {
    for (int s = 0; s < L.consumers * L.per_wg; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  // the first tiles start landing while Wp^T is staged
  if (lt == 0 && wg < L.consumers)
    for (int i = 0; i < L.per_wg && walk.tile(i) < walk.n_tiles; ++i)
      land_tile(xb, row_bytes, R, walk.tile(i), land + walk.stage(i) * L.stage_bytes,
                &full[walk.stage(i)]);
  // Wp^T: each task writes 8 operand K values (16 bytes) of one row n
  for (int e = threadIdx.x; e < NB * (Kp / 8); e += kThreads) {
    const int n = e % NB, k0 = (e / NB) * 8;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = actual_k(k0 + 2 * i + h);
        v[h] = (k < C && n0 + n < H) ? __bfloat162float(Wp[static_cast<size_t>(k) * H + n0 + n])
                                     : 0.f;
      }
      w[i] = pack_bf16(v[0], v[1]);
    }
    *reinterpret_cast<uint4*>(Bs + b128_offset(n, k0, NB)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (int n = threadIdx.x; n < NB / 2; n += kThreads)
    bias_s[n] = __halves2bfloat162(n0 + 2 * n < H ? bp[n0 + 2 * n] : __float2bfloat16_rn(0.f),
                                   n0 + 2 * n + 1 < H ? bp[n0 + 2 * n + 1]
                                                      : __float2bfloat16_rn(0.f));
  if (!RELU)
    for (int i = threadIdx.x; i < kSpTable; i += kThreads) sp_tab[i] = sp_entry(i);
  fence_proxy_async();
  __syncthreads();
  if (wg >= L.consumers) return;

  const int warp = lt / 32, lane = lt % 32;       // warp within the warpgroup
  const int g = lane / 4, q = lane % 4;
  const int n_kb = (C + 31) / 32;
  // 16-byte stores where every 8-column group lies wholly inside H or past it
  const bool wide = !(H & 7);
  for (int i = 0;; ++i) {
    const int tile = walk.tile(i);
    if (tile >= walk.n_tiles) break;
    const int st = walk.stage(i);
    mbar_wait(&full[st], walk.parity(i));
    const TX* tl = reinterpret_cast<const TX*>(land + st * L.stage_bytes);
    const int r0 = tile * kTileRows;
    const int rows = min(kTileRows, R - r0);
    const int ra = 16 * warp + g, rb = ra + 8;   // this lane's two rows

    float acc[NCH][32];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
    // two blocks in flight: block b's A registers are reloaded only after
    // the products of block b - 2 that read them are done (wgmma reads its A
    // registers asynchronously; fence_regs keeps them allocated till then)
    uint32_t a0[4] = {}, a1[4] = {}, b0[4] = {}, b1[4] = {};
    for (int b = 0; b < n_kb; b += 2) {
      if (b > 0) {
        wgmma_wait<1>();
        fence_regs(a0);
        fence_regs(a1);
      }
      load_a(tl, ra, rb, rows, b, q, C, vec, a0, a1);
      mma_block<NCH>(acc, a0, a1, Bs, b);
      if (b + 1 < n_kb) {
        if (b > 0) {
          wgmma_wait<1>();
          fence_regs(b0);
          fence_regs(b1);
        }
        load_a(tl, ra, rb, rows, b + 1, q, C, vec, b0, b1);
        mma_block<NCH>(acc, b0, b1, Bs, b + 1);
      }
    }
    // every lane's loads of the stage are done: land the warpgroup's tile
    // after next there while the products finish and the epilogue runs
    named_sync(1 + wg, 128);
    if (lt == 0 && walk.tile(i + L.per_wg) < walk.n_tiles)
      land_tile(xb, row_bytes, R, walk.tile(i + L.per_wg), land + st * L.stage_bytes, &full[st]);
    wgmma_wait<0>();
    fence_regs(a0);
    fence_regs(a1);
    fence_regs(b0);
    fence_regs(b1);
#pragma unroll
    for (int c = 0; c < NCH; ++c) fence_acc(acc[c]);

    // epilogue from the accumulators: rows r0 + ra and r0 + rb
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = h ? rb : ra;
        uint32_t w[8];   // columns 64 c + 8 jj + 2 q, + 1, as bfloat16 pairs
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const __nv_bfloat162 bias = bias_s[(64 * c + 8 * jj) / 2 + q];
          const __nv_bfloat162 u = __hadd2(
              __floats2bfloat162_rn(acc[c][4 * jj + 2 * h], acc[c][4 * jj + 2 * h + 1]), bias);
          w[jj] = act_bf16x2<RELU>(u, sp_tab);
        }
        __nv_bfloat16* out = z + static_cast<size_t>(r0 + row) * H + n0 + 64 * c;
        if (wide) {
          // lane q stores the 8 columns of group 4 blk + q: 64 bytes a row
#pragma unroll
          for (int blk = 0; blk < 2; ++blk) {
            uint32_t v[4] = {w[4 * blk], w[4 * blk + 1], w[4 * blk + 2], w[4 * blk + 3]};
            quad_transpose(v, q);
            const int col = 8 * (4 * blk + q);
            if (row < rows && n0 + 64 * c + col < H)
              *reinterpret_cast<uint4*>(out + col) = make_uint4(v[0], v[1], v[2], v[3]);
          }
        } else if (row < rows) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int col = 8 * jj + 2 * q;
            const __nv_bfloat162 pr = *reinterpret_cast<const __nv_bfloat162*>(&w[jj]);
            if (n0 + 64 * c + col < H) out[col] = pr.x;
            if (n0 + 64 * c + col + 1 < H) out[col + 1] = pr.y;
          }
        }
      }
    }
  }
}

// x[row][c0 .. c0 + 3] of a landed row, zero past C; `vec` the rows'
// alignment in bytes
__device__ __forceinline__ void load4(const float* row, int c0, int C, int vec, float (&a)[4]) {
  if (c0 + 4 <= C && vec >= 8) {
    if (vec == 16) {
      const float4 v = *reinterpret_cast<const float4*>(row + c0);
      a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
    } else {
      const float2 v0 = *reinterpret_cast<const float2*>(row + c0);
      const float2 v1 = *reinterpret_cast<const float2*>(row + c0 + 2);
      a[0] = v0.x; a[1] = v0.y; a[2] = v1.x; a[3] = v1.y;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = c0 + i < C ? row[c0 + i] : 0.f;
}

// float32 mode's operand K order: inside each 16-wide block, operand index
// k (step t = k / 8 % 2, fragment position p = k % 8) takes column
// 4 (p % 4) + 2 t + p / 4, so that lane q's A values of both steps are the
// 4 consecutive columns 4 q .. 4 q + 3 of its rows (one 16-byte load)
__device__ __forceinline__ int actual_k_tf32(int k) {
  const int p = k & 7;
  return (k & ~15) + 4 * (p & 3) + 2 * ((k >> 3) & 1) + (p >> 2);
}

// the A fragments of one 16-wide K block b, hi and lo, for both its steps
struct FragTF32 {
  uint32_t h[2][4], l[2][4];
};

__device__ __forceinline__ void fence_frag(FragTF32& f) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    fence_regs(f.h[t]);
    fence_regs(f.l[t]);
  }
}

__device__ __forceinline__ void load_a_tf32(const float* tl, int ra, int rb, int rows, int b,
                                            int q, int C, int vec, FragTF32& f) {
  float va[4] = {0.f, 0.f, 0.f, 0.f}, vb[4] = {0.f, 0.f, 0.f, 0.f};
  if (ra < rows) load4(tl + static_cast<size_t>(ra) * C, 16 * b + 4 * q, C, vec, va);
  if (rb < rows) load4(tl + static_cast<size_t>(rb) * C, 16 * b + 4 * q, C, vec, vb);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    tf32_split(va[2 * t], f.h[t][0], f.l[t][0]);
    tf32_split(vb[2 * t], f.h[t][1], f.l[t][1]);
    tf32_split(va[2 * t + 1], f.h[t][2], f.l[t][2]);
    tf32_split(vb[2 * t + 1], f.h[t][3], f.l[t][3]);
  }
}

// block b's 3xTF32 products: the two small ones into `small`, hi hi into
// `big`, so the long chain of large partial sums takes one rounding a step
// (first: the first block of the warpgroup's share of K, whose first
// products overwrite the accumulators)
template <int NB>
__device__ __forceinline__ void mma_block_tf32(float (&big)[NB / 2], float (&small)[NB / 2],
                                               const FragTF32& f, const unsigned char* Bh,
                                               const unsigned char* Bl, int b, bool first) {
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    // step 2b + t: panel b / 2, 64 (b % 2) + 32 t bytes into its rows
    const uint32_t off = (b >> 1) * (NB * 128) + (b & 1) * 64 + 32 * t;
    const int acc = (first && t == 0) ? 0 : 1;
    wgmma_rs_tf32<NB>(small, f.l[t], desc_b128(Bh + off), acc);
    wgmma_rs_tf32<NB>(small, f.h[t], desc_b128(Bl + off), 1);
    wgmma_rs_tf32<NB>(big, f.h[t], desc_b128(Bh + off), acc);
  }
  wgmma_commit();
}

// float32 mode: 3xTF32 on wgmma m64nNBk8, A (x, split in registers) from
// the landed tile, Wp^T hi and lo from shared memory. With ksplit 2 the
// two warpgroups of a unit share each tile and its stage, half of K each;
// they pass their sums through shared memory, and each adds both halves of
// its own half of the columns, in K order, and runs their epilogue.
template <int NB, bool RELU>
__global__ void __launch_bounds__(kThreads, 1)
stage_fwd_tf32(const float* __restrict__ x, const float* __restrict__ Wp,
               const float* __restrict__ bp, int R, int C, int H, Layout L, int vec,
               float* __restrict__ z) {
  constexpr int ND = NB / 2;       // accumulators a thread
  constexpr int NJ = NB / 8;       // 8-column groups
  constexpr int NS = NB == 32 ? 4 : 2;   // K blocks in flight (A register sets)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int Kp = (C + 31) / 32 * 32;   // 32 tf32 values (128 bytes) a panel
  unsigned char* Bh = smem;            // Wp^T hi, K-major, swizzled
  unsigned char* Bl = smem + static_cast<size_t>(NB) * Kp * 4;   // Wp^T lo
  float* bias_s = reinterpret_cast<float*>(smem + L.w_bytes);
  unsigned char* land = smem + L.land_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(land + L.consumers * L.per_wg * L.stage_bytes);
  const size_t row_bytes = static_cast<size_t>(C) * 4;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);

  const int n0 = blockIdx.y * NB;
  const int wg = threadIdx.x / 128, lt = threadIdx.x % 128;
  const int ks = L.ksplit, unit = wg / ks, half = wg % ks;
  const TileWalk walk{unit, L.consumers, L.per_wg, (R + kTileRows - 1) / kTileRows};
  if (threadIdx.x == 0) {
    for (int s = 0; s < L.consumers * L.per_wg; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  const bool lander = lt == 0 && half == 0;
  if (lander && unit < L.consumers)
    for (int i = 0; i < L.per_wg && walk.tile(i) < walk.n_tiles; ++i)
      land_tile(xb, row_bytes, R, walk.tile(i), land + walk.stage(i) * L.stage_bytes,
                &full[walk.stage(i)]);
  // Wp^T hi and lo: each task writes 4 operand K values (16 bytes) of row n
  for (int e = threadIdx.x; e < NB * (Kp / 4); e += kThreads) {
    const int n = e % NB, k0 = (e / NB) * 4;
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = actual_k_tf32(k0 + i);
      tf32_split((k < C && n0 + n < H) ? Wp[static_cast<size_t>(k) * H + n0 + n] : 0.f, h[i],
                 l[i]);
    }
    const uint32_t off = b128_at(n, 4 * k0, NB);
    *reinterpret_cast<uint4*>(Bh + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(Bl + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
  for (int n = threadIdx.x; n < NB; n += kThreads) bias_s[n] = n0 + n < H ? bp[n0 + n] : 0.f;
  fence_proxy_async();
  __syncthreads();
  if (unit >= L.consumers) return;

  const int warp = lt / 32, lane = lt % 32;
  const int g = lane / 4, q = lane % 4;
  const int n_kb = (C + 15) / 16;
  const int kb_share = (n_kb + ks - 1) / ks;
  const int kb0 = half * kb_share, kb1 = min(n_kb, kb0 + kb_share);
  // the 8-column groups whose epilogue this warpgroup runs
  const int j0 = half * (NJ / ks), j1 = j0 + NJ / ks;
  // exchange (ksplit 2): half h's sums, ND floats a thread
  float* xch = reinterpret_cast<float*>(smem + L.xch_off) +
               static_cast<size_t>(unit) * ks * 128 * ND;
  const bool pairs = !(H & 1);   // 8-byte stores of column pairs
  for (int i = 0;; ++i) {
    const int tile = walk.tile(i);
    if (tile >= walk.n_tiles) break;
    const int st = walk.stage(i);
    mbar_wait(&full[st], walk.parity(i));
    const float* tl = reinterpret_cast<const float*>(land + st * L.stage_bytes);
    const int r0 = tile * kTileRows;
    const int rows = min(kTileRows, R - r0);
    const int ra = 16 * warp + g, rb = ra + 8;

    float big[ND], small[ND];
#pragma unroll
    for (int e = 0; e < ND; ++e) big[e] = small[e] = 0.f;
    // NS blocks in flight: block b's A registers (set b % NS) are reloaded
    // only after the products of block b - NS that read them are done
    FragTF32 f[NS];
    for (int b = kb0; b < kb1; b += NS) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (b + s >= kb1) break;
        if (b > kb0) {
          wgmma_wait<NS - 1>();
          fence_frag(f[s]);
        }
        load_a_tf32(tl, ra, rb, rows, b + s, q, C, vec, f[s]);
        mma_block_tf32<NB>(big, small, f[s], Bh, Bl, b + s, b + s == kb0);
      }
    }
    named_sync(1 + unit, 128 * ks);
    if (lander && walk.tile(i + L.per_wg) < walk.n_tiles)
      land_tile(xb, row_bytes, R, walk.tile(i + L.per_wg), land + st * L.stage_bytes, &full[st]);
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < NS; ++s) fence_frag(f[s]);
    fence_acc(big);
    fence_acc(small);
#pragma unroll
    for (int e = 0; e < ND; ++e) big[e] += small[e];   // this half of K's sum
    if (ks > 1) {
      // this half of K's sums out; both halves of this warpgroup's columns
      // in, added in K order
      float4* mine = reinterpret_cast<float4*>(xch + (half * 128 + lt) * ND);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mine[j] = make_float4(big[4 * j], big[4 * j + 1], big[4 * j + 2], big[4 * j + 3]);
      named_sync(1 + unit, 128 * ks);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (j >= j0 && j < j1) {
          float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int h = 0; h < ks; ++h) {
            const float4 v = reinterpret_cast<const float4*>(xch + (h * 128 + lt) * ND)[j];
            u.x += v.x;
            u.y += v.y;
            u.z += v.z;
            u.w += v.w;
          }
          big[4 * j] = u.x;
          big[4 * j + 1] = u.y;
          big[4 * j + 2] = u.z;
          big[4 * j + 3] = u.w;
        }
    }

    // epilogue from the accumulators: rows r0 + ra and r0 + rb
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? rb : ra;
      if (row >= rows) continue;
      float* out = z + static_cast<size_t>(r0 + row) * H + n0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < j0 || j >= j1) continue;
        const int col = 8 * j + 2 * q;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float u = big[4 * j + 2 * h + e] + bias_s[col + e];
          v[e] = RELU ? fmaxf(u, 0.f) : softplus_f32(u);
        }
        if (pairs && n0 + col + 1 < H) {
          *reinterpret_cast<float2*>(out + col) = make_float2(v[0], v[1]);
        } else {
          if (n0 + col < H) out[col] = v[0];
          if (n0 + col + 1 < H) out[col + 1] = v[1];
        }
      }
    }
  }
}

// bfloat16 mode: the widest column group (NCH) whose Wp slice leaves room
// for 2 ring stages (NCH 1 takes what fits), then the most consuming
// warpgroups and stages each. consumers 0: nothing fits.
Layout pick(int C, int H, int x_esize, int* nch) {
  const size_t stage = round_up(static_cast<size_t>(kTileRows) * C * x_esize, 128);
  const size_t avail = kSmemLimit - 1024 - 2 * kMaxStages * sizeof(uint64_t);
  // NCH 2 at most: a thread's accumulators fit in 128 registers beside the
  // rest, and a wider H takes more column groups (x read again, from L2)
  const int want = H <= 64 ? 1 : 2;
  for (int n = want; n >= 1; n /= 2) {
    const size_t NB = 64 * n;
    const size_t w = NB * round_up(C, 64) * 2;
    const size_t fixed = round_up(w + NB * sizeof(float) + kSpTable * 2, 1024);
    const size_t fit = fixed < avail ? (avail - fixed) / stage : 0;
    for (int cons = kWGs; cons >= 1; cons /= 2)
      for (int per = 2; per >= 1; --per)
        if (static_cast<size_t>(cons * per) <= fit && (cons * per >= 2 || n == 1)) {
          *nch = n;
          return Layout{cons, per, stage, w, fixed};
        }
  }
  return Layout{0, 0, stage, 0, 0};
}

// float32 mode: column groups of NB = 64 (two accumulator sets of 32
// registers a thread) where Wp^T's hi and lo leave room for 2 ring stages,
// else NB = 32 with what fits; then warpgroups and stages as above. Where
// that leaves warpgroups idle (1 or 2 consuming), pairs of them share each
// tile (ksplit 2), if their exchange (256 NB bytes a warpgroup) fits.
Layout pick_tf32(int C, int H, int* nb) {
  const size_t stage = round_up(static_cast<size_t>(kTileRows) * C * 4, 128);
  const size_t avail = kSmemLimit - 1024 - 2 * kMaxStages * sizeof(uint64_t);
  for (int NB = H <= 32 ? 32 : 64; NB >= 32; NB /= 2) {
    const size_t w = 2 * static_cast<size_t>(NB) * round_up(C, 32) * 4;
    const size_t fixed = round_up(w + NB * sizeof(float), 1024);
    const size_t fit = fixed < avail ? (avail - fixed) / stage : 0;
    for (int cons = kWGs; cons >= 1; cons /= 2)
      for (int per = 2; per >= 1; --per)
        if (static_cast<size_t>(cons * per) <= fit && (cons * per >= 2 || NB == 32)) {
          *nb = NB;
          Layout L{cons, per, stage, w, fixed, 1, fixed};
          const size_t xch = static_cast<size_t>(cons) * 2 * 256 * NB;
          const size_t fixed2 = round_up(fixed + xch, 1024);
          if (2 * cons <= kWGs && fixed2 < avail &&
              (avail - fixed2) / stage >= static_cast<size_t>(cons * per)) {
            L.ksplit = 2;
            L.land_off = fixed2;
          }
          return L;
        }
  }
  return Layout{0, 0, stage, 0, 0, 1, 0};
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Layout& L, int R, int groups, cudaStream_t s, Args... args) {
  const size_t smem = 1024 + L.land_off + L.consumers * L.per_wg * L.stage_bytes +
                      2 * kMaxStages * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_tiles = (R + kTileRows - 1) / kTileRows;
  int gx = per_sm * sms / groups;
  gx = gx < 1 ? 1 : gx;
  gx = n_tiles < gx ? n_tiles : gx;
  if (gx > 0) kernel<<<dim3(gx, groups), kThreads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int NCH>
int launch_bf16(const void* x, int x_bf16, const void* Wp, const void* bp, int relu, int R,
                int C, int H, const Layout& L, int groups, void* z, cudaStream_t s) {
  const auto* w = static_cast<const __nv_bfloat16*>(Wp);
  const auto* b = static_cast<const __nv_bfloat16*>(bp);
  auto* out = static_cast<__nv_bfloat16*>(z);
  const int vec = pow2_align(static_cast<size_t>(C) * (x_bf16 ? 2 : 4));
  if (x_bf16) {
    const auto* xx = static_cast<const __nv_bfloat16*>(x);
    return relu ? launch(stage_fwd_bf16<__nv_bfloat16, NCH, true>, L, R, groups, s, xx, w,
                              b, R, C, H, L, vec, out)
                : launch(stage_fwd_bf16<__nv_bfloat16, NCH, false>, L, R, groups, s, xx, w,
                              b, R, C, H, L, vec, out);
  }
  const auto* xx = static_cast<const float*>(x);
  return relu ? launch(stage_fwd_bf16<float, NCH, true>, L, R, groups, s, xx, w, b, R, C, H,
                            L, vec, out)
              : launch(stage_fwd_bf16<float, NCH, false>, L, R, groups, s, xx, w, b, R, C,
                            H, L, vec, out);
}

template <int NB>
int launch_tf32(const void* x, const void* Wp, const void* bp, int relu, int R, int C, int H,
                const Layout& L, int groups, void* z, cudaStream_t s) {
  const auto* xx = static_cast<const float*>(x);
  const auto* w = static_cast<const float*>(Wp);
  const auto* b = static_cast<const float*>(bp);
  auto* out = static_cast<float*>(z);
  const int vec = pow2_align(static_cast<size_t>(C) * 4);
  return relu ? launch(stage_fwd_tf32<NB, true>, L, R, groups, s, xx, w, b, R, C, H, L, vec,
                       out)
              : launch(stage_fwd_tf32<NB, false>, L, R, groups, s, xx, w, b, R, C, H, L, vec,
                       out);
}

}  // namespace

// x (R, C) contiguous and 16-byte aligned, float32 (x_bf16 0) or bfloat16
// (1); Wp (C, H) and bp (H,) in the compute dtype (cdt_bf16: bfloat16, else
// float32, which needs float32 x); any C >= 1, H >= 1. Writes z (R, H) in
// the compute dtype.
extern "C" int ga_decoder_stage_fwd(const void* x, int x_bf16, const void* Wp, const void* bp,
                                    int cdt_bf16, int relu, int R, int C, int H, void* z,
                                    void* stream) {
  if (R < 0 || C <= 0 || H <= 0 || (!cdt_bf16 && x_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    int nch = 1;
    const Layout L = pick(C, H, x_bf16 ? 2 : 4, &nch);
    if (L.consumers < 1) return static_cast<int>(cudaErrorInvalidValue);   // C too wide to stage
    const int groups = (H + 64 * nch - 1) / (64 * nch);
    return nch == 2 ? launch_bf16<2>(x, x_bf16, Wp, bp, relu, R, C, H, L, groups, z, s)
                    : launch_bf16<1>(x, x_bf16, Wp, bp, relu, R, C, H, L, groups, z, s);
  }
  int nb = 64;
  const Layout L = pick_tf32(C, H, &nb);
  if (L.consumers < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (H + nb - 1) / nb;
  return nb == 64 ? launch_tf32<64>(x, Wp, bp, relu, R, C, H, L, groups, z, s)
                  : launch_tf32<32>(x, Wp, bp, relu, R, C, H, L, groups, z, s);
}
