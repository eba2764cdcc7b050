// What H-fwd (blend_fwd.cu) and H-bwd (blend_bwd.cu) share: the packed row
// layout, the gating constants, 16-byte cp.async copies into shared memory,
// and the alpha pre-test.
#pragma once

#include <cuda_runtime.h>

namespace blend {

constexpr int kRowWords = 16;  // packed row: mx,my,ca,cb | cc,r,g,b | op,valid,pad,pad | pad
constexpr int kChunks = 3;     // the 16-byte chunks of a row the blend reads (words 0-11)
// the constants round from double exactly as PyTorch rounds a Python float
// against a float32 tensor
constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kAlphaMax = static_cast<float>(0.99);
constexpr float kTEps = static_cast<float>(1e-4);

// A staged row: c0 = (mx, my, ca, cb), c1 = (cc, r, g, b), c2 = (op, valid, ., .).
struct Row {
  float4 c[kChunks];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed groups are still in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Start copying chunk `chunk` of packed row `id` into `row`.
__device__ __forceinline__ void stage_chunk(Row* row, const float* packed, int id, int chunk) {
  cp_async16(&row->c[chunk], packed + static_cast<size_t>(id) * kRowWords + 4 * chunk);
}

// An invalid row has opacity 0: alpha 0 < 1/255 skips it.
__device__ __forceinline__ float row_opacity(const Row& r) {
  return r.c[2].y > 0.f ? r.c[2].x : 0.f;
}

// The alpha pre-test: a pixel whose power lies below this threshold is cut
// by the alpha floor, fminf(op * expf(power), 0.99) < 1/255, so its expf is
// never taken. Below log(1/255 / op) - 0.01, op * exp(power) is below
// 0.99 x 1/255, a margin far above the few-ulp errors of logf, expf and the
// product, so the pre-test cuts only what the exact test cuts: every
// decision, and so n_contrib, done and T, stays exactly that of the exact
// test. op = 0 gives +inf (every pixel cut, as alpha 0 is); a negative or
// NaN op gives NaN, and then the pre-test cuts nothing.
__device__ __forceinline__ float alpha_cut_power(float op) {
  return logf(kAlphaMin / op) - 0.01f;
}

// Whether row r can pass the alpha pre-test (threshold `cut`) at some pixel
// of the rectangle [x0, x1] x [y0, y1] (pixel coordinates); false only
// where a bound proves every pixel of it cut. The power is -q(d)/2 for the
// conic's quadratic form q and d the offset from the mean, so it is at most
// -lambda_min |d|^2 / 2, lambda_min the conic's smaller eigenvalue (taken in
// double, from det / lambda_max, with det lowered by 2^-40 of ca cc against
// cancellation) and |d| the distance from the mean to the rectangle. The
// per-pixel float power (about nine roundings of terms bounded by
// (|ca| + |cc| + |cb|) |d|^2, |d| up to the rectangle's far corner) lies
// within 2^-20 of that of the exact one. Where the bound plus that error is
// below `cut`, every pixel's float power is below it too and the pre-test
// cuts the row at every pixel, so skipping the row changes no decision. A
// non-finite row, a conic that is not positive definite or a threshold
// that is not finite always reaches.
__device__ __forceinline__ bool row_reaches(const Row& r, float cut, float x0, float x1,
                                            float y0, float y1) {
  const double mx = r.c[0].x, my = r.c[0].y;
  const double ca = r.c[0].z, cb = r.c[0].w, cc = r.c[1].x;
  if (!(isfinite(mx) && isfinite(my) && isfinite(ca) && isfinite(cb) && isfinite(cc) &&
        isfinite(cut) && ca > 0.0)) {
    return true;
  }
  const double det = ca * cc - cb * cb - 0x1p-40 * ca * cc;
  if (!(det > 0.0)) return true;
  const double lmin = det / (0.5 * (ca + cc) + sqrt(0.25 * (ca - cc) * (ca - cc) + cb * cb));
  const double nx = fmax(fmax(x0 - mx, mx - x1), 0.0);
  const double ny = fmax(fmax(y0 - my, my - y1), 0.0);
  const double fx = fmax(fabs(x0 - mx), fabs(x1 - mx));
  const double fy = fmax(fabs(y0 - my), fabs(y1 - my));
  const double err = 0x1p-20 * (ca + cc + fabs(cb)) * (fx * fx + fy * fy);
  return !(-0.5 * lmin * (nx * nx + ny * ny) + err < static_cast<double>(cut));
}

}  // namespace blend
