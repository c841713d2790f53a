// Event-model makespan of many launch orders (the event scan) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `event_times_pallas`
// (src/repro/kernels/event_scan.py:295, body `event_scan_core` at :107).
// Each of B order rows (indices into a kernel table of K entries) is
// dispatched on a device of U units in float32, as the float64 oracle
// `_FastEventSim` does it: the head kernel's blocks go one at a time to
// the first unit, in round-robin order from the pointer, that has room
// (same-instant cohort merge), every unit runs its resident cohorts at its
// occupancy-adjusted roofline rate, time advances to the next cohort
// retirement, and a head that fits on no empty unit drains alone in
// ceil(blocks / U) solo passes.  One output time per row.
//
// Bound: operations, on the card's scalar float32 units; the bytes are
// tiny (each row read once, the table once, one float written).  A row is
// a chain of data-dependent steps, so parallelism comes from rows, and
// what a row costs is the number of its serial steps and the instructions
// each issues.  The design cuts both:
//
//   * burst admission: between two events time stands still and a unit's
//     state only grows, so whether unit u takes one more block of the head
//     is monotone.  One step places the whole head (or all of it that
//     fits): each lane counts `cap`, the blocks its unit can still take,
//     by the float32 running sums the one-block loop would form; the
//     round-robin first fit from the pointer is then closed form: with P
//     the first pass whose sum of min(cap, P) covers the blocks left (a
//     binary search of warp sums), every unit takes min(cap, P - 1), and
//     the first r units with cap >= P in cyclic order from the pointer one
//     more (a ballot, its bits counted below each lane); the pointer ends
//     one past the last of them.  Each unit then adds its take in sequence
//     and merges into or opens one cohort slot, all units at once.  A row
//     of EpBsEsSw-8 takes ~10 such steps and ~3.5 events where the
//     one-block loop took ~272 admissions;
//   * full warps: a row takes W lanes, W = U rounded up to a power of two
//     (at most 32), so a warp carries 32 / W rows; every reduction of a
//     row runs under its own lane mask (`redux.sync`), and rows in one
//     warp that need different steps diverge only for that step;
//   * float32 arithmetic in the reference's order, with the products and
//     sums that decide admission and retirement written as `__f*_rn`
//     intrinsics, so the compiler does not fuse them into FMAs the
//     reference does not have; one division a unit for its next
//     retirement (its least fraction left over its rate, which is the
//     least of the cohorts' quotients, as rounding keeps the order).  The
//     times equal the one-block loop's bit for bit.
//
// Plans (`kernels.event_scan.event_plan` picks one; the entry point checks
// it):
//
//   private U <= 32, D <= 4, C <= 8 (every GTX580 table): lane u holds
//           its unit's used[D], resident count and C cohort slots in
//           arrays of its own (D padded to 4 with zero demands and no
//           limit, C to 8 with slots that never open) and a mask of the
//           slots that hold a cohort; the loops over slots walk the
//           mask's bits, lowest first, so an event costs the cohorts a
//           unit holds, not 8.  Indexed at run time, the arrays live in
//           local memory, which stays in L1 (152 bytes a lane);
//           `tools/event_turns.py`'s `registers` build keeps them in
//           registers (every index a constant, every slot visited) and
//           runs slower (PERF.md has the times);
//   shared  any other shape: the units' state lives in shared memory,
//           slot-major, one region per row; in a burst lane i takes the
//           units at cyclic offsets i, i + W, ... from the pointer (so
//           U > 32 works, a chunk of 32 offsets a ballot), in an event
//           units i, i + W, ...; a __syncwarp of the row's lanes closes
//           each phase.  U = 1 (the serving device, 4,096 resident blocks,
//           C 24) packs 32 rows a warp.
//
// The kernel table (grids, demands, work per block, the admission limits)
// is staged in shared memory once per block.  Cohort slots per unit are
// C = min(max_resident, n * max grid): no unit holds more cohorts than
// resident blocks (C is set by the wrapper).  Demands are non-negative
// (the wrapper checks), which the monotone count above needs.
//
// The loop has a budget: blocks admitted, completions and solo drains of a
// row cannot exceed 2 * (sum of its kernels' blocks) + n.  A row that
// overruns it, fills its cohort slots or names a kernel outside the table
// sets a bit in `err` and writes NaN; the wrapper raises.  The kernel
// never spins.

#include "common.cuh"

#include <math.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;   // warps a block
constexpr int kLaneD = 4;   // the private plan's dimensions ...
constexpr int kLaneC = 8;   // ... and cohort slots a unit

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
  int B, n, K, D, U, C, max_res, sat_idx, width;
  long long max_events;   // <= 0: the per-row budget above
  float crate, mbw, satc, satm, fit_rtol, retire_eps;
};

// The W lanes of one row, from lane `base`; every reduction runs under
// the row's own mask.
struct Row {
  unsigned mask;
  int li, base, width;
  __device__ int sum(int v) const { return __reduce_add_sync(mask, v); }
  __device__ int max(int v) const { return __reduce_max_sync(mask, v); }
  // the min of non-negative floats, whose bits order as unsigned ints
  __device__ float min_pos(float v) const {
    return __uint_as_float(__reduce_min_sync(mask, __float_as_uint(v)));
  }
  // bit i: the predicate of the row's lane i
  __device__ unsigned ballot(bool q) const {
    return (__ballot_sync(mask, q) & mask) >> base;
  }
  __device__ long long sum_ll(long long v) const {
    for (int o = 1; o < width; o <<= 1) v += __shfl_xor_sync(mask, v, o);
    return v;
  }
};

__device__ __forceinline__ unsigned low_bits(int k) {
  return k >= 32 ? kFull : (1u << k) - 1u;
}

__host__ __device__ inline size_t table_bytes(int K, int D) {
  // nbk, inst, mem (K each), dem (K * D), admission limits (D)
  return static_cast<size_t>(4) * (3 * K + K * D + D);
}

__host__ __device__ inline size_t row_bytes(int U, int D, int C) {
  // the shared plan's state of one row: used (D * U), nres, cap, lam (U
  // each), slot kernel / blocks / fraction / admission instant (C * U
  // each)
  return static_cast<size_t>(4) * (U * D + 3 * U + 4 * U * C);
}

// Occupancy efficiency, as `rates` / the oversized branch compute it.
__device__ __forceinline__ float eff(float occ, float sat) {
  return fmaxf(fminf(1.f, __fdiv_rn(occ, sat)), kEps);
}

// One unit's state in arrays of its lane (the private plan); bit c of
// `live` is set while slot c holds a cohort.
template <int DM, int CM> struct LaneUnit {
  float used[DM];
  int nres, kid[CM], nb[CM];
  float fr[CM], ta[CM];
  unsigned live;
  __device__ float& use(int d) { return used[d]; }
  __device__ int& res() { return nres; }
  __device__ int& k(int c) { return kid[c]; }
  __device__ int& b(int c) { return nb[c]; }
  __device__ float& f(int c) { return fr[c]; }
  __device__ float& a(int c) { return ta[c]; }
};

// One unit's state in shared memory (the shared plan), slot-major with
// stride U; a slot holds a cohort while its block count is positive.
struct SmemUnit {
  float* used;
  int *nres, *kid, *nb;
  float *fr, *ta;
  int stride;
  __device__ float& use(int d) { return used[d * stride]; }
  __device__ int& res() { return *nres; }
  __device__ int& k(int c) { return kid[c * stride]; }
  __device__ int& b(int c) { return nb[c * stride]; }
  __device__ float& f(int c) { return fr[c * stride]; }
  __device__ float& a(int c) { return ta[c * stride]; }
};

// f(c) for each slot c in `slots` (the private plan, CM > 0: a mask of
// slots, lowest first) or, in the shared plan, for each of the C slots
// whose block count passes `keep`; in slot order either way, so sums over
// the cohorts keep the one-block loop's order.
template <int CM, class Unit, class Keep, class F>
__device__ __forceinline__ void each_slot(Unit& s, unsigned slots, int C,
                                          Keep keep, F f) {
  if constexpr (CM > 0) {
    for (; slots; slots &= slots - 1) f(__ffs(slots) - 1);
  } else {
    for (int c = 0; c < C; ++c)
      if (keep(s.b(c))) f(c);
  }
}

template <int CM, class Unit>
__device__ __forceinline__ unsigned live_slots(Unit& s) {
  if constexpr (CM > 0) return s.live;
  else return 0;
}

// which slots of the shared plan each_slot walks: those holding a cohort,
// or those marked to retire (a negated block count)
struct Held {
  __device__ bool operator()(int nb) const { return nb > 0; }
};
struct Retiring {
  __device__ bool operator()(int nb) const { return nb < 0; }
};

// The blocks of demand dk a unit can still take, at most `limit`: per
// dimension the running float32 sum of the one-block loop's fit tests
// (used + dk, then + dk again, ...) against the limit; the sums only
// grow, so the blocks that fit are a prefix, and the unit's count is the
// least over the dimensions.  DM > 0: the private plan's dimensions,
// the padded ones with dk 0 and no limit; else D.
template <int DM, class Unit>
__device__ __forceinline__ int unit_cap(Unit& s, const float* dk,
                                        const float* lim, int D, int limit) {
  const int ND = DM ? DM : D;
  int m = limit;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const float k = dk[d], l = lim[d];
    float acc = s.use(d);
    int j = 0;
    if (k == 0.f) {
      j = acc <= l ? m : 0;
    } else {
      while (j < m) {
        acc = __fadd_rn(acc, k);
        if (!(acc <= l)) break;
        ++j;
      }
    }
    m = j;
  }
  return m;
}

// Place m blocks of kernel kid on the unit at instant t: m adds of dk per
// dimension, in sequence, then the cohort of this kernel admitted at this
// instant grows, else the first free slot of the first C opens.  False
// where no slot is free.  DM, CM > 0: the private plan's padded D and C.
template <int DM, int CM, class Unit>
__device__ __forceinline__ bool unit_commit(Unit& s, int m, int kid, float t,
                                            const float* dk, int D, int C) {
  const int ND = DM ? DM : D;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    float acc = s.use(d);
    for (int j = 0; j < m; ++j) acc = __fadd_rn(acc, dk[d]);
    s.use(d) = acc;
  }
  s.res() += m;
  int hit = -1, free_slot = -1;
  if constexpr (CM > 0) {
    each_slot<CM>(s, s.live, C, Held(), [&](int c) {
      if (hit < 0 && s.k(c) == kid && s.a(c) == t) hit = c;
    });
    free_slot = __ffs(~s.live & low_bits(C)) - 1;
  } else {
    for (int c = 0; c < C && hit < 0; ++c) {
      if (s.b(c) > 0) {
        if (s.k(c) == kid && s.a(c) == t) hit = c;
      } else if (free_slot < 0) {
        free_slot = c;
      }
    }
  }
  if (hit >= 0) {
    s.b(hit) += m;
    return true;
  }
  if (free_slot < 0) return false;
  s.k(free_slot) = kid;
  s.b(free_slot) = m;
  s.f(free_slot) = 1.f;
  s.a(free_slot) = t;
  if constexpr (CM > 0) s.live |= 1u << free_slot;
  return true;
}

// The unit's rate (0 where it holds nothing) and, into ttf, the least time
// to finish of its cohorts: the least fraction left over the rate (a
// correctly rounded division by a positive rate keeps the order, so this
// is the least of the cohorts' own quotients).
template <int CM, class Unit>
__device__ __forceinline__ float unit_rate(Unit& s, const Scan& p,
                                           const float* s_inst,
                                           const float* s_mem, float& ttf) {
  float sum_c = 0.f, sum_m = 0.f, least = INFINITY;
  bool occupied = false;
  each_slot<CM>(s, live_slots<CM>(s), p.C, Held(), [&](int c) {
    occupied = true;
    const float nb = static_cast<float>(s.b(c));
    sum_c = __fadd_rn(sum_c, __fmul_rn(s_inst[s.k(c)], nb));
    sum_m = __fadd_rn(sum_m, __fmul_rn(s_mem[s.k(c)], nb));
    least = fminf(least, s.f(c));
  });
  if (!occupied) return 0.f;
  float eff_c = 1.f, eff_m = 1.f;
  if (p.sat_idx >= 0) {
    const float occ = s.use(p.sat_idx);
    eff_c = eff(occ, p.satc);
    eff_m = eff(occ, p.satm);
  }
  const float l =
      fminf(__fdiv_rn(__fmul_rn(p.crate, eff_c), fmaxf(sum_c, kEps)),
            __fdiv_rn(__fmul_rn(p.mbw, eff_m), fmaxf(sum_m, kEps)));
  ttf = fminf(ttf, __fdiv_rn(least, l));
  return l;
}

// Advance the unit's cohorts by dt at rate l; retire those done and give
// back their demands: their sum, then one subtraction per dimension, as
// the reference does.
template <int DM, int CM, class Unit>
__device__ __forceinline__ void unit_advance(Unit& s, const Scan& p,
                                             const float* s_dem, float l,
                                             float dt) {
  const int ND = DM ? DM : p.D;
  if (s.res() == 0) return;
  int freed = 0;
  unsigned gone = 0;
  each_slot<CM>(s, live_slots<CM>(s), p.C, Held(), [&](int c) {
    const float f = __fsub_rn(s.f(c), __fmul_rn(l, dt));
    s.f(c) = f;
    if (f <= p.retire_eps) {
      freed += s.b(c);
      s.b(c) = -s.b(c);   // marked: retires below
      gone |= 1u << (c & 31);
    }
  });
  if (freed == 0) return;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    if (d >= p.D) continue;   // a padded dimension holds nothing
    float sum = 0.f;
    each_slot<CM>(s, gone, p.C, Retiring(), [&](int c) {
      sum = __fadd_rn(sum, __fmul_rn(s_dem[s.k(c) * p.D + d],
                                     static_cast<float>(-s.b(c))));
    });
    s.use(d) = __fsub_rn(s.use(d), sum);
  }
  s.res() -= freed;
  each_slot<CM>(s, gone, p.C, Retiring(), [&](int c) { s.b(c) = 0; });
  if constexpr (CM > 0) s.live &= ~gone;
}

// DM = CM = 0: the shared plan; else the private plan with D padded to
// DM and C to CM.
template <int DM, int CM>
__global__ void __launch_bounds__(32 * kWarps)
event_scan_kernel(const Scan p) {
  constexpr bool kLane = DM > 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = p.K, D = p.D, U = p.U, C = p.C, n = p.n, W = p.width;
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
  const int li = lane & (W - 1), base = lane - li;
  const Row row_{W == 32 ? kFull : low_bits(W) << base, li, base, W};
  const int rows_a_warp = 32 / W;
  const int local = warp * rows_a_warp + base / W;   // the row in the block
  const long long b = static_cast<long long>(blockIdx.x) * kWarps *
                          rows_a_warp + local;
  bool live = b < p.B;
  const int* row = p.rows + static_cast<size_t>(live ? b : 0) * n;

  // the private plan's unit (lane li < U), or the row's region of the
  // shared plan
  LaneUnit<kLane ? DM : 1, kLane ? CM : 1> ru;
  float lim[kLane ? DM : 1];
  unsigned char* rbase = smem + table_bytes(K, D) + local * row_bytes(U, D, C);
  float* sh_used = reinterpret_cast<float*>(rbase);     // [D][U]
  int* sh_nres = reinterpret_cast<int*>(sh_used + D * U);
  int* sh_cap = sh_nres + U;
  float* sh_lam = reinterpret_cast<float*>(sh_cap + U);
  int* sh_kid = reinterpret_cast<int*>(sh_lam + U);     // [C][U]
  int* sh_nb = sh_kid + C * U;
  float* sh_fr = reinterpret_cast<float*>(sh_nb + C * U);
  float* sh_ta = sh_fr + C * U;
  auto unit = [&](int u) {
    return SmemUnit{sh_used + u, sh_nres + u, sh_kid + u, sh_nb + u,
                    sh_fr + u, sh_ta + u, U};
  };
  if constexpr (kLane) {
#pragma unroll
    for (int d = 0; d < DM; ++d) {
      ru.used[d] = 0.f;
      lim[d] = d < D ? s_lim[d] : INFINITY;
    }
    ru.nres = 0;
    ru.live = 0;
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      ru.kid[c] = -1;
      ru.nb[c] = 0;
      ru.fr[c] = 0.f;
      ru.ta[c] = -1.f;
    }
  } else if (live) {
    for (int u = li; u < U; u += W) {
      for (int d = 0; d < D; ++d) sh_used[d * U + u] = 0.f;
      sh_nres[u] = 0;
      for (int c = 0; c < C; ++c) {
        sh_kid[c * U + u] = -1;
        sh_nb[c * U + u] = 0;
        sh_fr[c * U + u] = 0.f;
        sh_ta[c * U + u] = -1.f;
      }
    }
    __syncwarp(row_.mask);
  }

  int fail = 0;
  long long blocks = 0;
  if (live) {
    int bad = 0;
    for (int i = li; i < n; i += W) {
      const int k = row[i];
      if (k < 0 || k >= K) bad = 1;
      else blocks += s_nbk[k];
    }
    if (row_.ballot(bad)) fail = kErrIndex;
    blocks = row_.sum_ll(blocks);
  }
  const long long budget = p.max_events > 0 ? p.max_events : 2 * blocks + n;

  float t = 0.f;
  int head = 0, rr = 0;
  int bleft = live && !fail ? s_nbk[row[0]] : 0;
  long long events = 0;
  bool admit = true, done = false;
  while (__any_sync(kFull, live)) {
    // -- a burst: the head's blocks on every unit that takes them
    if (live && !fail && admit && head < n) {
      const int kid = row[head];
      int placed = 0;
      bool slots_ok = true;
      if constexpr (kLane) {
        float dk[DM];
#pragma unroll
        for (int d = 0; d < DM; ++d)
          dk[d] = d < D ? s_dem[kid * D + d] : 0.f;
        const int cap =
            li < U ? unit_cap<DM>(ru, dk, lim, D,
                                  max(min(p.max_res - ru.nres, bleft), 0))
                   : 0;
        const int tot = row_.sum(cap);
        if (tot > 0) {
          // the first pass P whose sum of min(cap, P) covers bleft, and r
          // blocks of pass P
          int P, r;
          if (tot <= bleft) {
            P = row_.max(cap);
            r = __popc(row_.ballot(cap >= P));
          } else {
            int lo = 1, hi = row_.max(cap);
            while (lo < hi) {
              const int mid = (lo + hi) >> 1;
              if (row_.sum(min(cap, mid)) >= bleft) hi = mid;
              else lo = mid + 1;
            }
            P = lo;
            r = bleft - row_.sum(min(cap, P - 1));
          }
          // units with cap >= P ahead of this one in cyclic order from rr
          const bool q = cap >= P;
          const unsigned bal = row_.ballot(q);
          const unsigned from_rr = bal & ~low_bits(rr);
          const int rank = __popc(li >= rr ? from_rr & low_bits(li)
                                           : from_rr | (bal & low_bits(li)));
          const int take = min(cap, P - 1) + (q && rank < r ? 1 : 0);
          rr = __ffs(row_.ballot(q && rank == r - 1));  // one past the last
          if (rr == U) rr = 0;
          if (take > 0)
            slots_ok = unit_commit<DM, CM>(ru, take, kid, t, dk, D, C);
          slots_ok = row_.ballot(!slots_ok) == 0;
          placed = min(tot, bleft);
        }
      } else {
        const float* dk = s_dem + kid * D;
        int tot = 0, most = 0;
        for (int o = li; o < U; o += W) {
          const int u = rr + o < U ? rr + o : rr + o - U;
          SmemUnit s = unit(u);
          const int c = unit_cap<0>(s, dk, s_lim, D,
                                    max(min(p.max_res - s.res(), bleft), 0));
          sh_cap[u] = c;   // read back below by this lane only
          tot += c;
          most = max(most, c);
        }
        tot = row_.sum(tot);
        if (tot > 0) {
          auto cap_at = [&](int o) {
            return o < U ? sh_cap[rr + o < U ? rr + o : rr + o - U] : 0;
          };
          int P, r;
          most = row_.max(most);
          if (tot <= bleft) {
            P = most;
            int cnt = 0;
            for (int o = li; o < U; o += W) cnt += cap_at(o) >= P;
            r = row_.sum(cnt);
          } else {
            int lo = 1, hi = most;
            while (lo < hi) {
              const int mid = (lo + hi) >> 1;
              int part = 0;
              for (int o = li; o < U; o += W) part += min(cap_at(o), mid);
              if (row_.sum(part) >= bleft) hi = mid;
              else lo = mid + 1;
            }
            P = lo;
            int part = 0;
            for (int o = li; o < U; o += W) part += min(cap_at(o), P - 1);
            r = bleft - row_.sum(part);
          }
          // W offsets a ballot, in cyclic order from rr
          int seen = 0, last = 0;
          bool ok = true;
          for (int o0 = 0; o0 < U; o0 += W) {
            const int o = o0 + li;
            const int c = cap_at(o);
            const bool q = c >= P;
            const unsigned bal = row_.ballot(q);
            const int rank = seen + __popc(bal & low_bits(li));
            const int take = min(c, P - 1) + (q && rank < r ? 1 : 0);
            if (take > 0) {
              SmemUnit s = unit(rr + o < U ? rr + o : rr + o - U);
              ok &= unit_commit<0, 0>(s, take, kid, t, dk, D, C);
            }
            const unsigned lb = row_.ballot(q && rank == r - 1);
            if (lb) last = o0 + __ffs(lb) - 1;
            seen += __popc(bal);
          }
          rr = rr + last + 1;
          while (rr >= U) rr -= U;
          slots_ok = row_.ballot(!ok) == 0;
          placed = min(tot, bleft);
        }
        __syncwarp(row_.mask);   // the event reads units other lanes wrote
      }
      events += placed;
      bleft -= placed;
      if (bleft == 0) {
        if (++head < n) bleft = s_nbk[row[head]];
      } else {
        admit = false;   // the head blocks the queue (strict FIFO)
      }
      if (!slots_ok) fail |= kErrSlots;
      if (events > budget) fail |= kErrBudget;
    }

    // -- an event: a completion, a solo drain, or the end of the row
    if (live && !fail && (!admit || head >= n)) {
      int res = 0;
      if constexpr (kLane) res = ru.nres;
      else
        for (int u = li; u < U; u += W) res += sh_nres[u];
      res = row_.sum(res);
      if (res == 0 && head >= n) {
        done = true;
      } else if (res == 0) {
        // the head fits on no empty unit: it drains alone, one block per
        // unit per pass, at a single resident block's occupancy
        const int kid = row[head];
        float eff_c = 1.f, eff_m = 1.f;
        if (p.sat_idx >= 0) {
          const float occ = s_dem[kid * D + p.sat_idx];
          eff_c = eff(occ, p.satc);
          eff_m = eff(occ, p.satm);
        }
        const float t1 =
            fmaxf(__fdiv_rn(s_inst[kid], __fmul_rn(p.crate, eff_c)),
                  __fdiv_rn(s_mem[kid], __fmul_rn(p.mbw, eff_m)));
        const float passes = ceilf(
            __fdiv_rn(static_cast<float>(bleft), static_cast<float>(U)));
        t = __fadd_rn(t, __fmul_rn(passes, t1));
        if (++head < n) bleft = s_nbk[row[head]];
        ++events;
      } else {
        // per-unit rates, advance to the next retirement
        float ttf = INFINITY;
        float l = 0.f;
        if constexpr (kLane) {
          l = unit_rate<CM>(ru, p, s_inst, s_mem, ttf);
        } else {
          for (int u = li; u < U; u += W) {
            SmemUnit s = unit(u);
            sh_lam[u] = unit_rate<0>(s, p, s_inst, s_mem, ttf);
          }
        }
        const float dt = row_.min_pos(ttf);
        t = __fadd_rn(t, dt);
        if constexpr (kLane) {
          unit_advance<DM, CM>(ru, p, s_dem, l, dt);
        } else {
          for (int u = li; u < U; u += W) {
            SmemUnit s = unit(u);
            unit_advance<0, 0>(s, p, s_dem, sh_lam[u], dt);
          }
          __syncwarp(row_.mask);   // the next burst reads these units
        }
        ++events;
      }
      admit = true;
      if (events > budget) fail |= kErrBudget;
    }

    if (live && (fail || done)) {
      if (li == 0) {
        if (fail) {
          atomicOr(p.err, fail);
          p.out[b] = nanf("");
        } else {
          p.out[b] = t;
        }
      }
      live = false;
    }
  }
}

size_t plan_smem(int lane, int width, int K, int D, int U, int C) {
  return table_bytes(K, D) +
         (lane ? 0 : static_cast<size_t>(kWarps) * (32 / width) *
                         row_bytes(U, D, C));
}

}  // namespace

// The plan (private or shared state, lanes a row, shared memory) comes
// from the Python wrapper's `event_plan`; the entry point refuses a plan
// the kernel cannot run: a width that is no power of two from U rounded
// up to 32, private state past U 32, D 4 or C 8, or another layout's
// bytes.
extern "C" int repro_event_scan(
    const void* rows, const void* nbk, const void* dem, const void* inst,
    const void* mem, const void* caps, void* out, void* err, int B, int n,
    int K, int D, int U, int C, int max_res, int sat_idx, long long max_events,
    float crate, float mbw, float satc, float satm, float fit_rtol,
    float retire_eps, int lane, int width, long long smem, void* stream) {
  if (B <= 0 || n <= 0 || K <= 0 || D <= 0 || U <= 0 || C <= 0 ||
      sat_idx >= D)
    return static_cast<int>(cudaErrorInvalidValue);
  int lanes = 1;
  while (lanes < U && lanes < 32) lanes <<= 1;
  if (width < lanes || width > 32 || (width & (width - 1)) ||
      (lane && (U > 32 || D > kLaneD || C > kLaneC)) ||
      smem != static_cast<long long>(plan_smem(lane, width, K, D, U, C)))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const Scan) = lane ? event_scan_kernel<kLaneD, kLaneC>
                                    : event_scan_kernel<0, 0>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  p.width = width;
  p.max_events = max_events;
  p.crate = crate;
  p.mbw = mbw;
  p.satc = satc;
  p.satm = satm;
  p.fit_rtol = fit_rtol;
  p.retire_eps = retire_eps;
  const long long per_block = static_cast<long long>(kWarps) * (32 / width);
  const long long grid = (B + per_block - 1) / per_block;
  kernel<<<static_cast<unsigned>(grid), 32 * kWarps, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
