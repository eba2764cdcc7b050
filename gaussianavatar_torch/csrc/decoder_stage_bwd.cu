// H-dbwd: the activation's backward of a fused POP decoder stage, for
// Hopper (sm_90a), with a plain C interface (loaded through ctypes by
// gaussianavatar_torch/ops/decoder_stage.py `stage_bwd`).
//
// du = g * act'(u), rebuilt from the stage's output z alone (softplus:
// sigma(u) = 1 - exp(-z), in float32, rounded to g's dtype; relu: g where
// z > 0, else 0), and in the same pass the bias gradient sum_rows du in
// float32. The pre-activation u is never stored. It has no Pallas
// counterpart: the JAX package's `_softplus_sv_bwd` / `_relu_sv_bwd`
// (gaussianavatar_tpu/models/decoder.py:125-155) leave it to XLA. The
// products that follow (d x = du Wp^T, d Wp = x^T du) are torch.matmul.
//
// Deterministic: the rows are cut into n_split fixed ranges; a block adds
// its range's du per column in a fixed order (each thread a strided set of
// rows, then the threads of a column in lane order) and writes them to
// `work`; a second kernel adds the partials in split order.
//
// What bounds it on the H100: the bytes, reading g and z and writing du
// once (a 128-wide bfloat16 stage at R = 445,568: 342 MB, 0.102 ms at 3.35
// TB/s); 5 operations per element (23 M elements) sit far under that. The
// design: where C is even and at most 512, each thread owns two adjacent
// columns and walks rows (a warp reads and writes 128 contiguous bytes of a
// bfloat16 row per step), 256 / (C / 2) row lanes a block (the threads past
// them idle), about 8 blocks per SM; any other width (odd, or wider) takes
// the scalar form, a column a thread. Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 11, 445,568 rows, bfloat16): 0.152 ms against the 0.102 ms bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Bf16Pair {
  using Pair = __nv_bfloat162;
  static __device__ __forceinline__ float2 load(const void* p) {
    return __bfloat1622float2(*static_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ float2 store(void* p, float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    *static_cast<__nv_bfloat162*>(p) = v;
    return __bfloat1622float2(v);  // what was stored, as the sum must see it
  }
};

struct F32Pair {
  using Pair = float2;
  static __device__ __forceinline__ float2 load(const void* p) {
    return *static_cast<const float2*>(p);
  }
  static __device__ __forceinline__ float2 store(void* p, float a, float b) {
    *static_cast<float2*>(p) = make_float2(a, b);
    return make_float2(a, b);
  }
};

__device__ __forceinline__ float dact(float g, float z, bool relu) {
  return relu ? (z > 0.f ? g : 0.f) : g * (1.f - expf(-z));
}

template <typename P, bool RELU>
__global__ void __launch_bounds__(kThreads)
stage_bwd_partial(const typename P::Pair* __restrict__ g, const typename P::Pair* __restrict__ z,
                  int R, int C, int rows_per_split, typename P::Pair* __restrict__ du,
                  float* __restrict__ work) {
  __shared__ float red[2 * kThreads];
  const int pairs = C / 2;               // at most kThreads
  const int lanes = kThreads / pairs;
  const int cp = threadIdx.x % pairs, lane = threadIdx.x / pairs;
  const int r_begin = blockIdx.x * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  if (lane < lanes) {
    float s0 = 0.f, s1 = 0.f;
    for (int r = r_begin + lane; r < r_end; r += lanes) {
      const size_t i = static_cast<size_t>(r) * pairs + cp;
      const float2 gv = P::load(g + i), zv = P::load(z + i);
      const float2 d = P::store(du + i, dact(gv.x, zv.x, RELU), dact(gv.y, zv.y, RELU));
      s0 += d.x;
      s1 += d.y;
    }
    red[lane * C + 2 * cp] = s0;
    red[lane * C + 2 * cp + 1] = s1;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s += red[l * C + c];
    work[static_cast<size_t>(blockIdx.x) * C + c] = s;
  }
}

// Any width: thread t owns columns t, t + 256, ... and walks the split's
// rows for each (a warp reads 32 adjacent elements of a row).
template <typename T, bool RELU>
__global__ void __launch_bounds__(kThreads)
stage_bwd_scalar(const T* __restrict__ g, const T* __restrict__ z, int R, int C,
                 int rows_per_split, T* __restrict__ du, float* __restrict__ work) {
  const int r_begin = blockIdx.x * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float sum = 0.f;
    for (int r = r_begin; r < r_end; ++r) {
      const size_t i = static_cast<size_t>(r) * C + c;
      const T d = T(dact(float(g[i]), float(z[i]), RELU));
      du[i] = d;
      sum += float(d);   // what was stored, as the sum must see it
    }
    work[static_cast<size_t>(blockIdx.x) * C + c] = sum;
  }
}

__global__ void bwd_reduce(const float* __restrict__ work, int n_split, int C,
                           float* __restrict__ dbp) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
  for (int p = 0; p < n_split; ++p) s += work[static_cast<size_t>(p) * C + c];
  dbp[c] = s;
}

template <typename T>
int launch_scalar(const void* g, const void* z, int relu, int R, int C, int n_split,
                  int rows_per_split, void* work, void* du, cudaStream_t s) {
  const auto* gg = static_cast<const T*>(g);
  const auto* zz = static_cast<const T*>(z);
  auto* dd = static_cast<T*>(du);
  auto* ww = static_cast<float*>(work);
  if (relu) {
    stage_bwd_scalar<T, true><<<n_split, kThreads, 0, s>>>(gg, zz, R, C, rows_per_split, dd, ww);
  } else {
    stage_bwd_scalar<T, false><<<n_split, kThreads, 0, s>>>(gg, zz, R, C, rows_per_split, dd, ww);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int launch(const void* g, const void* z, int relu, int R, int C, int n_split,
           int rows_per_split, void* work, void* du, cudaStream_t s) {
  using T = typename P::Pair;
  const auto* gg = static_cast<const T*>(g);
  const auto* zz = static_cast<const T*>(z);
  auto* dd = static_cast<T*>(du);
  auto* ww = static_cast<float*>(work);
  if (relu) {
    stage_bwd_partial<P, true><<<n_split, kThreads, 0, s>>>(gg, zz, R, C, rows_per_split, dd, ww);
  } else {
    stage_bwd_partial<P, false><<<n_split, kThreads, 0, s>>>(gg, zz, R, C, rows_per_split, dd, ww);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g, z (R, C) contiguous, both float32 (bf16 0) or both bfloat16 (1), any
// C >= 1; rows cut into n_split ranges of rows_per_split; work holds
// n_split x C floats. Writes du (R, C) in g's dtype and dbp (C,) float32.
extern "C" int ga_decoder_stage_bwd(const void* g, const void* z, int bf16, int relu, int R,
                                    int C, int n_split, int rows_per_split, void* work,
                                    void* du, void* dbp, void* stream) {
  if (R < 0 || C < 1 || n_split <= 0 || rows_per_split <= 0 ||
      static_cast<long long>(n_split) * rows_per_split < R) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (C % 2 == 0 && C <= 2 * kThreads) {
    err = bf16 ? launch<Bf16Pair>(g, z, relu, R, C, n_split, rows_per_split, work, du, s)
               : launch<F32Pair>(g, z, relu, R, C, n_split, rows_per_split, work, du, s);
  } else {
    err = bf16 ? launch_scalar<__nv_bfloat16>(g, z, relu, R, C, n_split, rows_per_split, work,
                                              du, s)
               : launch_scalar<float>(g, z, relu, R, C, n_split, rows_per_split, work, du, s);
  }
  if (err != 0) return err;
  bwd_reduce<<<(C + 255) / 256, 256, 0, s>>>(static_cast<const float*>(work), n_split, C,
                                            static_cast<float*>(dbp));
  return static_cast<int>(cudaGetLastError());
}
