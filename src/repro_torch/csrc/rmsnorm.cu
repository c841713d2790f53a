// RMSNorm over rows for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rmsnorm_rows`
// (src/repro/kernels/rmsnorm.py:26): y = x * rsqrt(mean(x^2) + eps) * scale
// per row, accumulated in f32 and written in x's dtype, x * rsqrt first and
// then * scale, in the reference's order.
//
// Bound: bytes.  Each row is read once and written once; the arithmetic is
// a few operations per element.  Two regimes meet on the model paths:
//
// - One row (a decode step: 1 x 1024 bf16, about 8 KB with the f32 scale,
//   2.4 ns at 3.35 TB/s).  The launch's own fixed cost and one round trip
//   to L2 are all there is, so the row takes one block of a warp or two,
//   every load of the row and of its scale in flight at once.
// - Thousands of rows (a prefill or a train step; deepseek-v2's kv_norm is
//   4,096 x 512 bf16, 8 MB, 2.5 us).  Here the card has to keep enough
//   bytes in flight.
//
// Design (the launch is kernels/rmsnorm.py's rmsnorm_plan):
//
// - A row is read once from device memory.  Its `lanes` lanes (one warp,
//   or a power of two of its lanes, for rows of up to 96 vectors; else
//   32 x W, W >= 2 warps, 4 vectors a lane where the block's 8 warps
//   allow) each load all of their `vecs` 16-byte vectors (8 bf16 or 4
//   f32; vector j of the row on lane j % lanes) into registers, with the
//   f32 scale of those vectors, before the sum of squares, and scale
//   those same registers: no second read, and every load of a lane in
//   flight at once.  The kernel is specialised at compile time on `vecs`
//   (1 to 8).  Two warps of 2 or 3 vectors a lane beat one of 4 or 6 at
//   1024 and 1536 bf16 (by 0.3-4%), and 4 a lane beat 5 or 6 at the wide
//   widths.
// - A block holds `rows_per_block` narrow rows (one warp or part of one
//   each, reduced by xor shuffles alone: a butterfly, whose every lane
//   ends with the same bits) or one wide row (its warps' sums added in
//   warp order through shared memory after one barrier).  No atomics: two
//   calls give the same bits.
// - The grid is one block per `rows_per_block` rows, and the hardware's
//   block scheduler hands them out.  Measured on the H100 against the one
//   block per row of PR 11 (tools/rmsnorm_turns.py and the probes PERF.md
//   names, PR 26), the designs that the first plan asked for lost: a
//   persistent grid of the blocks the SMs hold at once, walking the rows
//   with the next row's loads in flight and the scale read once a block
//   (into registers, into shared memory by a loop, or by cp.async), ran
//   6-13% slower at 32,768 rows, and the shared-memory staging added
//   1.4-3.7 us to every launch.  The f32 scale is L2-resident after the
//   first rows, so reading it a row costs no device-memory bytes; a
//   static share of rows a warp left a tail that the block scheduler does
//   not.  A ring fed by 1-D TMA (cp.async.bulk) would add a shared-memory
//   round trip to a row that fits in registers.
// - Occupancy: __launch_bounds__ gives a thread 85 registers up to 4
//   vectors a lane (3 blocks of 256 an SM; more blocks, at 64 registers,
//   spilled and ran no faster) and 128 beyond; the bf16 vectors are held
//   raw across the reduction (4 registers each) and widened where they
//   are used.
//
// Contract (checked by the Python wrapper, and again here where a wrong
// launch would read out of bounds): x and y are contiguous (rows, d) of one
// dtype (f32 or bf16), scale is contiguous f32 (d,), d is a multiple of 8
// up to 8192, every pointer is 16-byte aligned.

#include "common.cuh"

using namespace repro;

// What kernels/rmsnorm.py passes for a launch (its ctypes structure
// `_Launch`, field for field).  Outside the unnamed namespace: the entry
// point that takes it must keep external linkage.
struct RmsnormLaunch {
  int rows, d, dtype, lanes, vecs, rows_per_block, grid;
  float eps;
};

namespace {

constexpr int kMaxThreads = 256;   // rows_per_block x lanes at most
constexpr int kMaxVecs = 8;

// Blocks of kMaxThreads an SM holds at once for a lane of K vectors
// (__launch_bounds__'s minimum).
__host__ __device__ constexpr int min_blocks(int K) { return K <= 4 ? 3 : 2; }

// The floats of a 16-byte vector of T.
__device__ __forceinline__ void unpack(const uint4& v, float* out, float) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(const uint4& v, float* out, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads, min_blocks(K))
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ y,
                   int rows, int d, int lanes, float eps) {
  constexpr int V = Vec<T>::n, Q = V / 4;   // elements, and float4s of scale, a vector
  const int nv = d / V;
  const int g = threadIdx.x / lanes, li = threadIdx.x - g * lanes;
  const long long r = static_cast<long long>(blockIdx.x) * (blockDim.x / lanes) + g;
  const bool ok = r < rows;

  // Every load of this lane's vectors and of their scale, at once (zeros
  // past the row's end, or for a group past the last row).
  const uint4* xr = reinterpret_cast<const uint4*>(x) + (ok ? r : 0) * nv;
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  uint4 v[K];
  float4 sc[K][Q];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = li + k * lanes;
    const bool in = ok && j < nv;
    v[k] = in ? __ldg(xr + j) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int h = 0; h < Q; ++h)
      sc[k][h] = in ? __ldg(s4 + j * Q + h) : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float f[V];
    unpack(v[k], f, T());
#pragma unroll
    for (int e = 0; e < V; ++e) ss = fmaf(f[e], f[e], ss);
  }
  if (lanes <= 32) {
    for (int o = lanes >> 1; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  } else {
    __shared__ float part[kMaxThreads / 32];
    ss = warp_sum(ss);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < (lanes >> 5); ++w) ss += part[w];
  }
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  // Keep the raw vectors, not their widened floats, live across the
  // reduction: they are widened again below.
#pragma unroll
  for (int k = 0; k < K; ++k)
    asm volatile("" : "+r"(v[k].x), "+r"(v[k].y), "+r"(v[k].z), "+r"(v[k].w));
  if (!ok) return;
  T* yr = y + r * d;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = li + k * lanes;
    if (j < nv) {
      float f[V];
      unpack(v[k], f, T());
#pragma unroll
      for (int h = 0; h < Q; ++h) {
        f[4 * h] = (f[4 * h] * inv) * sc[k][h].x;
        f[4 * h + 1] = (f[4 * h + 1] * inv) * sc[k][h].y;
        f[4 * h + 2] = (f[4 * h + 2] * inv) * sc[k][h].z;
        f[4 * h + 3] = (f[4 * h + 3] * inv) * sc[k][h].w;
      }
      store_vec(yr + j * V, f);
    }
  }
}

template <typename T, int K>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&rmsnorm_kernel<T, K>);
}

// The kernel of `dtype` specialised on `vecs`, or null.
const void* kernel_for(int dtype, int vecs) {
#define REPRO_RMSNORM_CASE(k)                                                   \
  case k:                                                                       \
    return dtype == kBF16 ? kernel_of<__nv_bfloat16, k>() : kernel_of<float, k>();
  if (dtype != kBF16 && dtype != kF32) return nullptr;
  switch (vecs) {
    REPRO_RMSNORM_CASE(1)
    REPRO_RMSNORM_CASE(2)
    REPRO_RMSNORM_CASE(3)
    REPRO_RMSNORM_CASE(4)
    REPRO_RMSNORM_CASE(5)
    REPRO_RMSNORM_CASE(6)
    REPRO_RMSNORM_CASE(7)
    REPRO_RMSNORM_CASE(8)
    default:
      return nullptr;
  }
#undef REPRO_RMSNORM_CASE
}

bool valid(const RmsnormLaunch& L) {
  if (L.rows <= 0 || L.d <= 0 || L.d % 8 != 0 || L.d > 8192) return false;
  if (L.dtype != kBF16 && L.dtype != kF32) return false;
  const int nv = L.d / (L.dtype == kBF16 ? 8 : 4);
  const bool warp_part = L.lanes >= 1 && L.lanes <= 32 && (L.lanes & (L.lanes - 1)) == 0;
  const bool warps = L.lanes > 32 && L.lanes % 32 == 0 && L.lanes <= kMaxThreads;
  if (!(warp_part || warps)) return false;
  if (L.vecs < 1 || L.vecs > kMaxVecs || L.vecs * L.lanes < nv) return false;
  const int threads = L.rows_per_block * L.lanes;
  if (L.rows_per_block < 1 || threads > kMaxThreads || threads % 32 != 0) return false;
  if (warps && L.rows_per_block != 1) return false;
  const long long blocks = (static_cast<long long>(L.rows) + L.rows_per_block - 1) /
                           L.rows_per_block;
  return L.grid == blocks;
}

}  // namespace

extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             const RmsnormLaunch* launch, void* stream) {
  if (launch == nullptr || !valid(*launch) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(scale) |
       reinterpret_cast<uintptr_t>(y)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const RmsnormLaunch& L = *launch;
  const void* fn = kernel_for(L.dtype, L.vecs);
  int rows = L.rows, d = L.d, lanes = L.lanes;
  float eps = L.eps;
  void* args[] = {(void*)&x, (void*)&scale, &y, &rows, &d, &lanes, &eps};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(L.grid), dim3(L.rows_per_block * L.lanes),
                                           args, 0, static_cast<cudaStream_t>(stream)));
}

// Blocks of `rows_per_block` x `lanes` threads of the `vecs` kernel of
// `dtype` that one SM holds at once, or -(CUDA error) where the query
// fails.
extern "C" int repro_rmsnorm_blocks_per_sm(int dtype, int vecs, int lanes, int rows_per_block) {
  const void* fn = kernel_for(dtype, vecs);
  const int threads = lanes * rows_per_block;
  if (fn == nullptr || threads < 32 || threads > kMaxThreads)
    return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, 0);
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}
