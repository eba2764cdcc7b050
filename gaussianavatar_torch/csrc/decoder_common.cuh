// What the fused POP decoder's kernels (H-dstat, H-dfwd) share on Hopper
// (sm_90a): the ring of row tiles in shared memory, filled with bulk
// asynchronous copies (TMA's non-tensor form, cp.async.bulk) that complete
// on mbarriers, and the warpgroup matrix multiply (wgmma) with its
// shared-memory operand descriptors.
//
// The ring. A stage's input x (R, C) is row-major and contiguous, so a tile
// of consecutive rows is one contiguous span of bytes, whatever C and the
// element size: one cp.async.bulk lands it, and no tensor map (which needs
// a row stride that is a multiple of 16 bytes) is involved. A tile of 64
// rows spans 64 C esize bytes, a multiple of 16 for esize 2 and 4, so every
// tile starts 16-byte aligned; only the last, short tile can end off a
// multiple of 16, and the issuing thread copies that tail (< 16 bytes)
// itself before it arrives. Each stage has a barrier that completes on one
// arrival (the issuing thread's) and the copy's bytes; round k of a stage
// waits on phase parity k & 1. There is no producer warp: the threads that
// read a stage reissue it once they are all done with it (a named barrier),
// so a block is whole warpgroups and gets the registers of no idle warp.
//
// The operand layout (wgmma's K-major, 128-byte swizzle, as TMA's
// SWIZZLE_128B writes it): a panel holds 64 K values (128 bytes) of each of
// its rows; row n's 16-byte chunk c sits at n * 128 + ((c ^ (n % 8)) * 16);
// a panel starts 1024-byte aligned; 8 rows (1024 bytes) apart is the
// descriptor's stride offset, and a K step of 16 values moves its start by
// 32 bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ga_dec {

constexpr int kTileRows = 64;   // rows of a ring tile: one wgmma M
constexpr int kMaxStages = 4;
constexpr size_t kSmemLimit = 232448;   // a block's shared memory on the H100

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spins until the phase of parity `parity` has completed; a wait of more
// than about 10 s (a broken pipeline) traps, so the launch fails instead of
// holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  for (uint32_t n = 1;; ++n) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (!(n & 1023) && clock64() - start > 20000000000LL) __trap();
  }
}

// one bulk copy global -> shared, its bytes counted on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// makes this thread's shared-memory writes visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier among `count` threads (a multiple of 32) only
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Lands tile `tile` of x (rows [tile * n, min(R, tile * n + n)) for n =
// tile_rows, 64 by default) in
// `dst`, its bytes counted on `bar`; one thread calls it, after every
// thread that read `dst` before is done with it. The short tail of the last
// tile (< 16 bytes) is copied by the calling thread itself, before it
// arrives.
__device__ __forceinline__ void land_tile(const unsigned char* __restrict__ x, size_t row_bytes,
                                          int R, int tile, unsigned char* dst, uint64_t* bar,
                                          int tile_rows = kTileRows) {
  const int r0 = tile * tile_rows;
  const int rows = min(tile_rows, R - r0);
  const size_t bytes = static_cast<size_t>(rows) * row_bytes;
  const size_t bulk = bytes & ~static_cast<size_t>(15);
  const unsigned char* src = x + static_cast<size_t>(r0) * row_bytes;
  for (size_t b = bulk; b < bytes; ++b) dst[b] = src[b];
  mbar_arrive_expect_tx(bar, static_cast<uint32_t>(bulk));
  if (bulk) bulk_g2s(dst, src, static_cast<uint32_t>(bulk), bar);
}

// ---- wgmma -----------------------------------------------------------------

// the descriptor of a K-major operand in the 128-byte swizzle layout whose
// rows start at `p` (1024-byte aligned panel, plus 32 bytes per K step)
__device__ __forceinline__ uint64_t desc_b128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// byte offset of K-major byte kb of row n in a 128-byte-swizzle panel stack
// of `rows` rows (128 bytes of K a panel: 64 bfloat16 or 32 tf32 values)
__device__ __forceinline__ uint32_t b128_at(int n, int kb, int rows) {
  const int panel = kb >> 7, kk = kb & 127;
  return static_cast<uint32_t>(panel) * rows * 128 + n * 128 + (((kk >> 4) ^ (n & 7)) << 4) +
         (kk & 15);
}

// the same for bfloat16 element (row n, k)
__device__ __forceinline__ uint32_t b128_offset(int n, int k, int rows) {
  return b128_at(n, 2 * k, rows);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of wgmma are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for A fragments held in registers, which wgmma reads until its
// group completes
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define GA_WGMMA_D32                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

#define GA_WGMMA_REGS32                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// D (64 x 64, float32) (+)= A (64 x 16, bfloat16, in registers: a[0..3],
// the m16n8k16 A fragment of this warp's 16 rows) x B (16 x 64) read from
// shared memory through desc_b, K-major. accumulate 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_64x64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GA_WGMMA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : GA_WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64) (+)= A (64 x 16) x B (16 x 64), both read from shared memory,
// both K-major
__device__ __forceinline__ void wgmma_ss_64x64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GA_WGMMA_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : GA_WGMMA_D32
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// ---- 3xTF32 ------------------------------------------------------------------
//
// A float32 product at float32 accuracy on the tensor cores: each operand
// a = hi + lo with hi = tf32(a) and lo = tf32(a - hi) (rounded to nearest,
// ties away from zero, as cvt.rna.tf32.f32 rounds; a - hi is exact in
// float32), and a b = hi hi + hi lo + lo hi; the dropped lo lo is about
// 2^-22 of a b. TF32 products are exact and sum in float32. One TF32
// product alone keeps 11 bits of each operand (about 3 decimal digits),
// which the float32 contract refuses.

// the rounding on the bits: adding half a tf32 ulp to the magnitude and
// clearing the 13 low bits rounds it to nearest, ties away (a carry into
// the exponent is the next binade, or inf past the largest float); a NaN
// becomes the quiet NaN, whose tf32 bits stay a NaN
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x7FFFFFFFu) > 0x7F800000u ? 0x7FC00000u : (b + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo; where hi is not finite (inf or NaN, or a value that rounds
// past the largest float), lo is 0
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = (hi & 0x7F800000u) != 0x7F800000u
           ? (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u
           : 0u;
}

#define GA_D4 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define GA_D8 GA_D4, "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define GA_D16                                                                             \
  GA_D8, "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),       \
      "+f"(d[14]), "+f"(d[15])
#define GA_R4 "{%0, %1, %2, %3}"
#define GA_R8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define GA_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// D (64 x N, float32) (+)= A (64 x 8, tf32, both operands from shared
// memory, K-major) x B (8 x N); d holds N / 2 accumulators a thread (of 36)
template <int N>
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[36], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate);
template <>
__device__ __forceinline__ void wgmma_ss_tf32<72>(float (&d)[36], uint64_t desc_a,
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35}, %36, %37, p, 1, 1;\n}\n"
      : GA_WGMMA_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_ss_tf32<64>(float (&d)[36], uint64_t desc_a,
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " GA_WGMMA_REGS32
      ", %32, %33, p, 1, 1;\n}\n"
      : GA_WGMMA_D32
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_ss_tf32<32>(float (&d)[36], uint64_t desc_a,
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " GA_R16 ", %16, %17, p, 1, 1;\n}\n"
      : GA_D16
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_ss_tf32<16>(float (&d)[36], uint64_t desc_a,
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 " GA_R8 ", %8, %9, p, 1, 1;\n}\n"
      : GA_D8
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_ss_tf32<8>(float (&d)[36], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 " GA_R4 ", %4, %5, p, 1, 1;\n}\n"
      : GA_D4
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x N) (+)= A (64 x 8, tf32 in registers: a[0..3], this warp's 16 rows,
// a[0] = A[g][q], a[1] = A[g + 8][q], a[2] = A[g][q + 4], a[3] = A[g + 8][q +
// 4] for lane 4 g + q) x B (8 x N) from shared memory, K-major
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate);
template <>
__device__ __forceinline__ void wgmma_rs_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " GA_WGMMA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : GA_WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " GA_R16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : GA_D16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// The accumulator's layout (m64nNk16 and m64nNk8, float32): warp w of the warpgroup
// holds rows 16 w .. 16 w + 15; lane l holds, for each 8-column group j,
// d[4 j + 2 h + e] = D[16 w + l / 4 + 8 h][8 j + 2 (l % 4) + e].

// ---- launch helpers ------------------------------------------------------

// rounds a shared-memory base up to 1024 bytes (the swizzle's alignment)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

inline size_t round_up(size_t v, size_t m) { return (v + m - 1) / m * m; }

// the largest power of two up to 16 that divides n (the alignment, in
// bytes, of every row of a ring tile whose rows are n bytes)
inline int pow2_align(size_t n) {
  int a = 16;
  while (a > 1 && n % a) a >>= 1;
  return a;
}

}  // namespace ga_dec
