// RMSNorm over rows for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rmsnorm_rows`
// (src/repro/kernels/rmsnorm.py:26): y = x * rsqrt(mean(x^2) + eps) * scale
// per row, accumulated in f32 and written in x's dtype.
//
// Bound: bytes.  Each row is read once for the sum of squares and once more
// (from L1/L2) for the output, and written once; the arithmetic is a few
// operations per element.  On the serving path the shape is one row of
// 1024 bf16 values: 2 KB in, 4 KB of f32 scale, 2 KB out, about 2.4 ns at
// 3.35 TB/s, so the kernel's time there is the launch latency, not the
// memory.  Large row counts are what the design serves: one block per row,
// 16-byte vector loads and stores (8 bf16 or 4 f32 per thread), an f32 sum
// of squares reduced by warp shuffles and then across warps through shared
// memory, and x * rsqrt(ms + eps) then * scale in the reference's order.
//
// Contract (checked by the Python wrapper): x and y are contiguous (rows, d)
// of one dtype (f32 or bf16), scale is contiguous f32 (d,), d is a multiple
// of 8 up to 8192, every pointer is 16-byte aligned.

#include "common.cuh"

using namespace repro;

namespace {

template <typename T>
__global__ void rmsnorm_rows_kernel(const T* __restrict__ x,
                                    const float* __restrict__ scale,
                                    T* __restrict__ y, int d, float eps) {
  constexpr int V = Vec<T>::n;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* yr = y + static_cast<size_t>(blockIdx.x) * d;
  const int nvec = d / V;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[V];
    load_vec(xr + i * V, v);
#pragma unroll
    for (int j = 0; j < V; ++j) ss += v[j] * v[j];
  }

  __shared__ float part[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < static_cast<int>(blockDim.x >> 5) ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float inv = rsqrtf(part[0] / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[V], s[V];
    load_vec(xr + i * V, v);
#pragma unroll
    for (int j = 0; j < V; j += 4) load_vec(scale + i * V + j, s + j);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = (v[j] * inv) * s[j];
    store_vec(yr + i * V, v);
  }
}

template <typename T>
void launch(const void* x, const void* scale, void* y, int rows, int d,
            float eps, cudaStream_t stream) {
  const int nvec = d / Vec<T>::n;
  int threads = ((nvec + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  rmsnorm_rows_kernel<T><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(y), d, eps);
}

}  // namespace

extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             int rows, int d, float eps, int dtype,
                             void* stream) {
  if (rows <= 0 || d <= 0 || d % 8 != 0 || d > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    launch<__nv_bfloat16>(x, scale, y, rows, d, eps, s);
  } else if (dtype == kF32) {
    launch<float>(x, scale, y, rows, d, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
