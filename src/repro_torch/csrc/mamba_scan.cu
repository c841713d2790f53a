// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `mamba_scan_bd`
// (src/repro/kernels/mamba_scan.py:63) behind the reference's
// `ops.mamba_scan`: for every batch row b, channel c and state s, from
// h = 0 and walking t = 0 .. T-1,
//   h[c, s] = exp(dt[t, c] * A[c, s]) * h[c, s] + (dt[t, c] * x[t, c]) * B[t, s]
//   y[t, c] = sum_s h[c, s] * C[t, s] + D[c] * x[t, c]
// in f32 (inputs upcast), y written in x's dtype.
//
// Bound: operations, on the special-function units.  At jamba's shape
// (B 1, T 4096, Dc 8192, S 16, bf16) the kernel must read x and dt and
// write y, 201 MB, 0.060 ms at 3.35 TB/s; it does about 6 f32 operations
// per (t, c, s), 3.2e9, 0.048 ms at 67 TFLOP/s; and one exp per (t, c, s),
// 5.4e8, which the SFUs issue at 16 per SM per clock: 0.13 ms at 1.98 GHz.
// The recurrence is serial in T; the parallelism is B * Dc * S.  What the
// design does about it:
//  - lanes run over (channel, state): each thread carries one h value in a
//    register, so a step costs it one exp, the FMAs and its share of a
//    shuffle sum over the S lanes of its channel (S padded to SP = 8, 16 or
//    32 lanes; padded lanes hold zeros).  At jamba's shape that is 131,072
//    threads, ~31 warps on each SM, where one thread per channel with the
//    16 states in registers would leave 8,192 threads and most SMs idle;
//  - one block of 256 threads per (batch row, 256 / SP channels) walks T in
//    chunks of 64 steps.  A chunk's x and dt tile (64 x channels) and its B
//    and C rows (64 x S) are staged in shared memory from coalesced loads,
//    and the next chunk's loads are issued into registers before the
//    current chunk's steps run, so their latency hides behind the scan;
//  - y goes back through a shared tile, one coalesced store per chunk;
//  - only h's update depends on the previous step (one FMA), so the
//    unrolled step loop overlaps the exps and reductions of several steps.
// The exp is `expf` (full precision, as the plain version's `torch.exp`);
// tails in T and Dc are masked (zeros in, nothing stored), so any T and Dc
// are taken.
//
// Contract (checked by the Python wrapper): x, dt and y are contiguous
// (B, T, Dc) of one dtype (f32 or bf16); B and C are (B, T, S) of that
// dtype with a contiguous last axis and batch and time strides given in
// elements; A is contiguous f32 (Dc, S) and D contiguous f32 (Dc,);
// 1 <= S <= 32.

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;     // time steps staged per chunk

template <typename T, int SP>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const T* __restrict__ bm, const T* __restrict__ cm,
                  const float* __restrict__ a, const float* __restrict__ dskip,
                  T* __restrict__ y, int n_t, int Dc, int S, long long bsb,
                  long long bst, long long csb, long long cst) {
  constexpr int CH = kThreads / SP;             // channels per block
  constexpr int RX = kChunk * CH / kThreads;    // x, dt values per thread
  constexpr int RB = kChunk * SP / kThreads;    // B, C values per thread
  static_assert(RX * kThreads == kChunk * CH && RB * kThreads == kChunk * SP,
                "the staging map covers each tile exactly");
  __shared__ float sx[kChunk][CH], sdt[kChunk][CH], sy[kChunk][CH];
  __shared__ float sb[kChunk][SP], sc[kChunk][SP];

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * CH;
  // This thread's scan lane: channel c0 + cl, state s.
  const int cl = tid / SP, s = tid % SP;
  const int c = c0 + cl;
  const float av = (c < Dc && s < S) ? a[static_cast<size_t>(c) * S + s] : 0.f;
  const float dv = c < Dc ? dskip[c] : 0.f;

  // Staging map: x/dt/y value j of this thread sits at (row xr + j * SP,
  // column xc) of the tile, B/C value j at (row cl + j * CH, column s).
  const int xr = tid / CH, xc = tid % CH;
  const bool xc_ok = c0 + xc < Dc;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * n_t;
  const T* bb = bm + blockIdx.y * bsb;
  const T* cb = cm + blockIdx.y * csb;

  float rx[RX], rdt[RX], rb[RB], rc[RB];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int j = 0; j < RX; ++j) {
      const int t = t0 + xr + j * SP;
      const bool ok = t < n_t && xc_ok;
      const size_t off = (row0 + t) * Dc + c0 + xc;
      rx[j] = ok ? to_float(x[off]) : 0.f;
      rdt[j] = ok ? to_float(dt[off]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int t = t0 + cl + j * CH;
      const bool ok = t < n_t && s < S;
      rb[j] = ok ? to_float(bb[t * bst + s]) : 0.f;
      rc[j] = ok ? to_float(cb[t * cst + s]) : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < RX; ++j) {
      sx[xr + j * SP][xc] = rx[j];
      sdt[xr + j * SP][xc] = rdt[j];
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      sb[cl + j * CH][s] = rb[j];
      sc[cl + j * CH][s] = rc[j];
    }
  };

  fetch(0);
  stash();
  __syncthreads();
  float h = 0.f;
  for (int t0 = 0; t0 < n_t; t0 += kChunk) {
    const bool more = t0 + kChunk < n_t;
    if (more) fetch(t0 + kChunk);   // in flight while this chunk runs
    // Steps past n_t see dt = 0 and B = C = 0: h is left as it is.
#pragma unroll 8
    for (int i = 0; i < kChunk; ++i) {
      const float dti = sdt[i][cl], xi = sx[i][cl];
      const float dA = expf(dti * av);
      h = h * dA + (dti * xi) * sb[i][s];
      float p = h * sc[i][s];
#pragma unroll
      for (int o = SP / 2; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o);
      if (s == 0) sy[i][cl] = p + dv * xi;
    }
    __syncthreads();   // sy is whole; every read of this chunk's tiles done
#pragma unroll
    for (int j = 0; j < RX; ++j) {
      const int r = xr + j * SP, t = t0 + r;
      if (t < n_t && xc_ok)
        y[(row0 + t) * Dc + c0 + xc] = from_float<T>(sy[r][xc]);
    }
    if (more) stash();
    __syncthreads();
  }
}

template <typename T, int SP>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const void* a, const void* d, void* y, int B, int n_t, int Dc,
           int S, long long bsb, long long bst, long long csb, long long cst,
           cudaStream_t stream) {
  constexpr int CH = kThreads / SP;
  const dim3 grid((Dc + CH - 1) / CH, B);
  mamba_scan_kernel<T, SP><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(d),
      static_cast<T*>(y), n_t, Dc, S, bsb, bst, csb, cst);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_s(const void* x, const void* dt, const void* bm, const void* cm,
             const void* a, const void* d, void* y, int B, int n_t, int Dc,
             int S, long long bsb, long long bst, long long csb,
             long long cst, cudaStream_t stream) {
  if (S <= 8)
    return launch<T, 8>(x, dt, bm, cm, a, d, y, B, n_t, Dc, S, bsb, bst, csb,
                        cst, stream);
  if (S <= 16)
    return launch<T, 16>(x, dt, bm, cm, a, d, y, B, n_t, Dc, S, bsb, bst, csb,
                         cst, stream);
  return launch<T, 32>(x, dt, bm, cm, a, d, y, B, n_t, Dc, S, bsb, bst, csb,
                       cst, stream);
}

}  // namespace

extern "C" int repro_mamba_scan(const void* x, const void* dt, const void* bm,
                                const void* cm, const void* a, const void* d,
                                void* y, int B, int n_t, int Dc, int S,
                                long long bsb, long long bst, long long csb,
                                long long cst, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || n_t <= 0 || Dc <= 0 || S <= 0 || S > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_s<__nv_bfloat16>(x, dt, bm, cm, a, d, y, B, n_t, Dc, S, bsb,
                                   bst, csb, cst, st);
  if (dtype == kF32)
    return launch_s<float>(x, dt, bm, cm, a, d, y, B, n_t, Dc, S, bsb, bst, csb,
                           cst, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
