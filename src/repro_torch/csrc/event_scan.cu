// Event-model makespan of many launch orders (the event scan) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `event_times_pallas`
// (src/repro/kernels/event_scan.py:295, body `event_scan_core` at :107).
// Each of B order rows (indices into a kernel table of K entries) is
// dispatched on a device of U units in float32, as the float64 oracle
// `_FastEventSim` does it: the head kernel's blocks are admitted one at a
// time to the first unit, in round-robin order from the pointer, that has
// room (same-instant cohort merge), every unit runs its resident cohorts at
// its occupancy-adjusted roofline rate, time advances to the next cohort
// retirement, and a head that fits on no empty unit drains alone in
// ceil(blocks / U) solo passes.  One output time per row.
//
// Bound: operations, on the card's scalar float32 units.  A row's work is
// its admissions (one fit test per unit each) plus its completion events
// (one rate per unit and one division per occupied cohort slot each); the
// bytes are tiny (each row read once, the table once, one float written).
// The work is a sequential chain of data-dependent steps, so the design
// spends parallelism across rows, not inside one:
//
//   * one warp per order row; lane u owns execution unit u (u += 32 when
//     U > 32), so every fit test, rate and retirement of a step runs on
//     all units at once, and the round-robin first fit is a warp
//     min-reduction of each fitting unit's cyclic offset from the pointer;
//   * a unit's state lives in shared memory and only its own lane touches
//     it, so the warp needs no barrier; the chain's scalars (time, head,
//     blocks left, pointer) are warp-uniform registers;
//   * the kernel table is staged in shared memory once per block;
//   * cohort slots per unit are C = min(max_resident, n * max grid): no
//     unit holds more cohorts than resident blocks (C is set by the
//     wrapper);
//   * float32 arithmetic in the reference's order, with the products and
//     sums that decide admission and retirement written as `__f*_rn`
//     intrinsics, so the compiler does not fuse them into FMAs the
//     reference does not have.
//
// The loop has a budget: admissions, completions and solo drains of a row
// cannot exceed 2 * (sum of its kernels' blocks) + n.  A row that overruns
// it, fills its cohort slots or names a kernel outside the table sets a bit
// in `err` and writes NaN; the wrapper raises.  The kernel never spins.

#include "common.cuh"

#include <math.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;   // order rows per block

enum ErrBits : int { kErrBudget = 1, kErrSlots = 2, kErrIndex = 4 };

struct Scan {
  const int* rows;
  const int* nbk;
  const float* dem;
  const float* inst;
  const float* mem;
  const float* caps;
  float* out;
  int* err;
  int B, n, K, D, U, C, max_res, sat_idx;
  long long max_events;   // <= 0: the per-row budget above
  float crate, mbw, satc, satm, fit_rtol, retire_eps;
};

__device__ __forceinline__ float warp_min_f(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ long long warp_sum_ll(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__host__ __device__ inline size_t table_bytes(int K, int D) {
  // nbk, inst, mem (K each), dem (K * D), admission limits (D)
  return static_cast<size_t>(4) * (3 * K + K * D + D);
}

__host__ __device__ inline size_t warp_bytes(int U, int D, int C) {
  // used (U * D), nres, lam (U each), slot kernel / blocks / fraction /
  // admission instant (U * C each)
  return static_cast<size_t>(4) * (U * D + 2 * U + 4 * U * C);
}

// Occupancy efficiency, as `rates` / the oversized branch compute it.
__device__ __forceinline__ float eff(float occ, float sat) {
  return fmaxf(fminf(1.f, __fdiv_rn(occ, sat)), kEps);
}

__global__ void __launch_bounds__(32 * kWarps)
event_scan_kernel(const Scan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = p.K, D = p.D, U = p.U, C = p.C, n = p.n;
  int* s_nbk = reinterpret_cast<int*>(smem);
  float* s_inst = reinterpret_cast<float*>(s_nbk + K);
  float* s_mem = s_inst + K;
  float* s_dem = s_mem + K;
  float* s_lim = s_dem + K * D;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    s_nbk[i] = p.nbk[i];
    s_inst[i] = p.inst[i];
    s_mem[i] = p.mem[i];
  }
  for (int i = threadIdx.x; i < K * D; i += blockDim.x) s_dem[i] = p.dem[i];
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    // caps + (caps * F32_FIT_RTOL + eps), the reference's admission slack
    const float c = p.caps[d];
    s_lim[d] = __fadd_rn(c, __fadd_rn(__fmul_rn(c, p.fit_rtol), kEps));
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= p.B) return;

  unsigned char* wbase = smem + table_bytes(K, D) + warp * warp_bytes(U, D, C);
  float* used = reinterpret_cast<float*>(wbase);   // [U][D]
  int* nres = reinterpret_cast<int*>(used + U * D);  // [U]
  float* lam = reinterpret_cast<float*>(nres + U);   // [U]
  int* skid = reinterpret_cast<int*>(lam + U);       // [U][C]
  int* snb = skid + U * C;                           // [U][C]
  float* sfr = reinterpret_cast<float*>(snb + U * C);  // [U][C]
  float* sta = sfr + U * C;                          // [U][C]

  const int* row = p.rows + static_cast<size_t>(b) * n;
  int bad = 0;
  long long blocks = 0;
  for (int i = lane; i < n; i += 32) {
    const int k = row[i];
    if (k < 0 || k >= K) bad = 1;
    else blocks += s_nbk[k];
  }
  if (__any_sync(kFull, bad)) {
    if (lane == 0) {
      atomicOr(p.err, kErrIndex);
      p.out[b] = nanf("");
    }
    return;
  }
  const long long budget =
      p.max_events > 0 ? p.max_events : 2 * warp_sum_ll(blocks) + n;
  for (int u = lane; u < U; u += 32) {
    for (int d = 0; d < D; ++d) used[u * D + d] = 0.f;
    nres[u] = 0;
    lam[u] = 0.f;
    for (int c = 0; c < C; ++c) {
      skid[u * C + c] = -1;
      snb[u * C + c] = 0;
      sfr[u * C + c] = 0.f;
      sta[u * C + c] = -1.f;
    }
  }

  float t = 0.f;
  int head = 0, rr = 0;
  int bleft = n > 0 ? s_nbk[row[0]] : 0;
  long long events = 0;
  int fail = 0;
  while (!fail) {
    // -- admission: place the head's blocks one at a time while one fits
    while (head < n) {
      const int kid = row[head];
      const float* dk = s_dem + kid * D;
      int best = U;   // smallest cyclic offset from rr of a fitting unit
      for (int u = lane; u < U; u += 32) {
        bool fit = nres[u] + 1 <= p.max_res;
        for (int d = 0; d < D && fit; ++d)
          fit = __fadd_rn(used[u * D + d], dk[d]) <= s_lim[d];
        if (fit) {
          const int off = u >= rr ? u - rr : u - rr + U;
          best = min(best, off);
        }
      }
      best = __reduce_min_sync(kFull, best);
      if (best >= U) break;   // the head blocks the queue (strict FIFO)
      const int u = best + rr < U ? best + rr : best + rr - U;
      int full = 0;
      if ((u & 31) == lane) {
        for (int d = 0; d < D; ++d)
          used[u * D + d] = __fadd_rn(used[u * D + d], dk[d]);
        nres[u] += 1;
        // merge into the cohort of this kernel admitted at this instant,
        // else open the first free slot
        int slot = -1, free_slot = -1;
        for (int c = 0; c < C; ++c) {
          const int i = u * C + c;
          if (snb[i] > 0) {
            if (skid[i] == kid && sta[i] == t) {
              slot = i;
              break;
            }
          } else if (free_slot < 0) {
            free_slot = i;
          }
        }
        if (slot >= 0) {
          snb[slot] += 1;
        } else if (free_slot >= 0) {
          skid[free_slot] = kid;
          snb[free_slot] = 1;
          sfr[free_slot] = 1.f;
          sta[free_slot] = t;
        } else {
          full = 1;
        }
      }
      if (__any_sync(kFull, full)) {
        fail = kErrSlots;
        break;
      }
      rr = u + 1 < U ? u + 1 : 0;
      if (--bleft == 0) {
        ++head;
        if (head < n) bleft = s_nbk[row[head]];
      }
      if (++events > budget) {
        fail = kErrBudget;
        break;
      }
    }
    if (fail) break;

    int res = 0;
    for (int u = lane; u < U; u += 32) res += nres[u];
    res = __reduce_add_sync(kFull, res);
    if (res == 0) {
      if (head >= n) break;   // drained: done
      // -- the head fits on no empty unit: it drains alone, one block
      //    per unit per pass, at a single resident block's occupancy
      const int kid = row[head];
      float eff_c = 1.f, eff_m = 1.f;
      if (p.sat_idx >= 0) {
        const float occ = s_dem[kid * D + p.sat_idx];
        eff_c = eff(occ, p.satc);
        eff_m = eff(occ, p.satm);
      }
      const float t1 = fmaxf(__fdiv_rn(s_inst[kid], __fmul_rn(p.crate, eff_c)),
                             __fdiv_rn(s_mem[kid], __fmul_rn(p.mbw, eff_m)));
      const float passes =
          ceilf(__fdiv_rn(static_cast<float>(bleft), static_cast<float>(U)));
      t = __fadd_rn(t, __fmul_rn(passes, t1));
      ++head;
      if (head < n) bleft = s_nbk[row[head]];
      if (++events > budget) fail = kErrBudget;
      continue;
    }

    // -- completion: per-unit rates, advance to the next retirement
    float ttf = INFINITY;
    for (int u = lane; u < U; u += 32) {
      float sum_c = 0.f, sum_m = 0.f;
      bool occupied = false;
      for (int c = 0; c < C; ++c) {
        const int i = u * C + c;
        if (snb[i] > 0) {
          occupied = true;
          const float nb = static_cast<float>(snb[i]);
          sum_c = __fadd_rn(sum_c, __fmul_rn(s_inst[skid[i]], nb));
          sum_m = __fadd_rn(sum_m, __fmul_rn(s_mem[skid[i]], nb));
        }
      }
      float l = 0.f;
      if (occupied) {
        float eff_c = 1.f, eff_m = 1.f;
        if (p.sat_idx >= 0) {
          const float occ = used[u * D + p.sat_idx];
          eff_c = eff(occ, p.satc);
          eff_m = eff(occ, p.satm);
        }
        l = fminf(__fdiv_rn(__fmul_rn(p.crate, eff_c), fmaxf(sum_c, kEps)),
                  __fdiv_rn(__fmul_rn(p.mbw, eff_m), fmaxf(sum_m, kEps)));
        for (int c = 0; c < C; ++c) {
          const int i = u * C + c;
          if (snb[i] > 0) ttf = fminf(ttf, __fdiv_rn(sfr[i], l));
        }
      }
      lam[u] = l;
    }
    const float dt = warp_min_f(ttf);
    t = __fadd_rn(t, dt);
    for (int u = lane; u < U; u += 32) {
      if (nres[u] == 0) continue;
      const float l = lam[u];
      int freed = 0;
      for (int c = 0; c < C; ++c) {
        const int i = u * C + c;
        if (snb[i] > 0) {
          const float f = __fsub_rn(sfr[i], __fmul_rn(l, dt));
          sfr[i] = f;
          if (f <= p.retire_eps) {
            freed += snb[i];
            snb[i] = -snb[i];   // marked: retires below
          }
        }
      }
      if (freed == 0) continue;
      // give back the retiring cohorts' demands: their sum, then one
      // subtraction per dimension, as the reference does
      for (int d = 0; d < D; ++d) {
        float s = 0.f;
        for (int c = 0; c < C; ++c) {
          const int i = u * C + c;
          if (snb[i] < 0)
            s = __fadd_rn(s, __fmul_rn(s_dem[skid[i] * D + d],
                                       static_cast<float>(-snb[i])));
        }
        used[u * D + d] = __fsub_rn(used[u * D + d], s);
      }
      nres[u] -= freed;
      for (int c = 0; c < C; ++c)
        if (snb[u * C + c] < 0) snb[u * C + c] = 0;
    }
    if (++events > budget) fail = kErrBudget;
  }
  if (lane == 0) {
    if (fail) {
      atomicOr(p.err, fail);
      p.out[b] = nanf("");
    } else {
      p.out[b] = t;
    }
  }
}

}  // namespace

// Bytes of dynamic shared memory one block of the scan needs (table plus
// four rows' state), for the wrapper's check against the card's limit.
extern "C" long long repro_event_scan_smem(int K, int D, int U, int C) {
  return static_cast<long long>(table_bytes(K, D) + kWarps * warp_bytes(U, D, C));
}

extern "C" int repro_event_scan(
    const void* rows, const void* nbk, const void* dem, const void* inst,
    const void* mem, const void* caps, void* out, void* err, int B, int n,
    int K, int D, int U, int C, int max_res, int sat_idx, long long max_events,
    float crate, float mbw, float satc, float satm, float fit_rtol,
    float retire_eps, void* stream) {
  if (B <= 0 || n <= 0 || K <= 0 || D <= 0 || U <= 0 || C <= 0 ||
      sat_idx >= D)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = table_bytes(K, D) + kWarps * warp_bytes(U, D, C);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(event_scan_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  Scan p;
  p.rows = static_cast<const int*>(rows);
  p.nbk = static_cast<const int*>(nbk);
  p.dem = static_cast<const float*>(dem);
  p.inst = static_cast<const float*>(inst);
  p.mem = static_cast<const float*>(mem);
  p.caps = static_cast<const float*>(caps);
  p.out = static_cast<float*>(out);
  p.err = static_cast<int*>(err);
  p.B = B;
  p.n = n;
  p.K = K;
  p.D = D;
  p.U = U;
  p.C = C;
  p.max_res = max_res;
  p.sat_idx = sat_idx;
  p.max_events = max_events;
  p.crate = crate;
  p.mbw = mbw;
  p.satc = satc;
  p.satm = satm;
  p.fit_rtol = fit_rtol;
  p.retire_eps = retire_eps;
  const int grid = (B + kWarps - 1) / kWarps;
  event_scan_kernel<<<grid, 32 * kWarps, smem,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
