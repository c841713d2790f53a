// Flash attention (forward, full sequence) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_bh`
// (src/repro/kernels/flash_attention.py:79) behind `ops.flash_attention`:
// for every (batch b, query position s, query head h)
//   out[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h / g] * scale, mask) @ v
// with g = H / Hkv, scale = 1 / sqrt(D) and mask = (t <= s if causal) and
// (t > s - window if a window is set).  The online softmax (m, l, acc) is
// kept in f32, the softmax weights stay f32 in the P.V product (to 2^-18,
// below), as in the TPU kernel, and the output is written in the inputs'
// dtype.
//
// Bound: operations.  The work is 4 * D operations (2 * D multiply-adds)
// per visible (query, key) pair and query head against 4 * S * H * D
// elements moved, so at S = 4096, D = 64 it is ~1000 operations per byte,
// far above the card's ~295 in bf16: 0.0347 ms at qwen's (1, 4096, 16, 64)
// causal, 989 TFLOP/s.
//
// bf16 (flash_attention_wgmma_kernel), the path every model takes:
//  - one block per (batch, KV head, group of G of that head's query heads,
//    query tile), tiles heaviest first along S.  A tile is 128 rows, each a
//    (query position, query head) pair, so the g query heads of one KV head
//    share every K/V tile the block loads.  G divides g (the wrapper's
//    `flash_plan`), so a group never reaches another KV head's rows;
//  - 384 threads: two consumer warpgroups of 64 rows each and a producer
//    warpgroup, one thread of which issues every load.  `setmaxnreg` hands
//    the producer's registers to the consumers at run time; ptxas still
//    compiles every thread against the launch budget, 168 registers;
//  - TMA loads: q through a 4-D map (D, H, S, B) with box (64, G, P, 1),
//    which lands the tile in shared memory already in (position, head) row
//    order; k and v through (D, Hkv, T, B) maps, box (64, 1, BN, 1).  Rows
//    are 128 bytes with the 128-byte swizzle; a head dim above 64 loads as
//    two 64-column boxes.  Out-of-bounds reads fill zeros, which covers the
//    S and T tails and every head dim short of 64, 80 or 128.  The maps
//    read q, k and v in place through their strides (views of one fused
//    qkv);
//  - K/V tiles of BN keys (96 at D <= 80, 64 at D 128) go through a ring of
//    three stages guarded by full and empty mbarriers; nothing in the KV
//    loop waits on __syncthreads;
//  - Q.K^T: wgmma m64nBNk16, both operands K-major in shared memory;
//  - the online softmax in registers and in base 2 (one FFMA and one
//    ex2.approx per score); each row lives on the four lanes of a quad of
//    the accumulator layout.  Only the tiles that cross the diagonal, the
//    window's edge or the end of T run the masked copy of it, and o is
//    rescaled only where a row of the warp has a new maximum;
//  - P.V: wgmma m64nDk16 with P from registers (the score accumulators of
//    a 16-key step are already the A fragment) and V from shared memory,
//    MN-major, transposed on read.  Each f32 weight goes in as two bf16
//    parts, hi = rn(p) and lo = rn(p - hi), whose sum is within 2^-18 p of
//    it: invisible in a bf16 output, and one product fewer than the
//    three-part split that would be exact;
//  - within a warpgroup, tile j's Q.K^T is issued together with tile
//    j - 1's P.V, and tile j's softmax statistics run while that P.V does;
//    across the two warpgroups, named barriers make them take turns to
//    issue (ping-pong), so one's softmax runs under the other's products.
//    Tile j's scores, tile j - 1's weights and o must fit the 168
//    registers at once, which sets BN: at 128 keys ptxas serialises the
//    wgmmas (C7512) or spills;
//  - the epilogue scales by 1 / l and stores bf16 directly, masked to the
//    positions below S.
// Left for a later PR: a TMA store, persistent blocks, and a cheaper
// second weight part or exp (tools/flash_turns.py measures what each
// costs).
//
// f32 (flash_attention_kernel), for the f32 parity checks (no model is
// served in f32): both products on the f32 FMA units, 256 threads each
// computing a 4 x 4 block of scores from 16-byte shared loads and a
// 4 x (4 per 64 columns) block of the output; the weights pass through
// shared memory; 64-row tiles of up to 16 heads, partial head groups
// masked.
//
// Both kernels bound the KV walk of a tile by its last row's diagonal
// (causal) and its first row's window, so a window costs O(S * window),
// and mask the tail tiles of S and T, so any S and T are taken (the TPU
// kernel asks S % 128 == 0).
//
// Contract (checked by the Python wrapper): q, k, v of one dtype (f32 or
// bf16) with a contiguous last axis, the other strides multiples of 8
// elements (16 bytes in bf16, as TMA asks) and 16-byte aligned pointers;
// D a multiple of 8 up to 128 (the wrapper pads other head dims);
// H % Hkv == 0; 1 <= S <= T; window >= 1 or 0 for none; out contiguous
// (B, S, H, D); for bf16, the wrapper's plan (G, P): G divides g, G <= 16
// and P * G <= 128.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the driver at run time
#include <math_constants.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16 owns rows ty + 16 i
constexpr int kBM = 64;        // rows (query position, query head) per block
constexpr int kBN = 64;        // key positions per tile
constexpr int kMaxG = 16;      // query heads of one KV head per block
constexpr int kLdP = kBN + 4;  // row stride of the weights tile (floats)
constexpr float kNegInf = -1e30f;

static_assert(kThreads == 256 && kBM == 64 && kBN == 64,
              "the thread map covers a 64 x 64 tile with 4 x 4 per thread");

__device__ __forceinline__ void fma4(float& acc, const float4& a, const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// ---------------------------------------------------------------------------
// f32: both products on the f32 FMA units
// ---------------------------------------------------------------------------

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int S,
                       int Tk, int H, int Hkv, int D, int G, int ngroups,
                       long long qsb, long long qss, long long qsh,
                       long long ksb, long long kst, long long ksh,
                       long long vsb, long long vst, long long vsh,
                       float scale, int causal, int window) {
  constexpr int V = 4;           // floats per 16-byte load
  constexpr int DJ = DMAX / 64;  // 64-column groups of the output per thread
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 4;  // padded rows: 16-byte reads across rows hit distinct banks
  float* qs = smem;                    // (kBM, ld) query rows, pre-scaled
  float* ks = qs + kBM * ld;           // (kBN, ld) key tile
  float* ps = ks;                      // (kBM, kLdP) weights, aliasing the keys
  float* vs = ks + max(kBN * ld, kBM * kLdP);  // (kBN, D) value tile

  const int g = H / Hkv;
  const int P = kBM / G;  // query positions per block
  const int hg = blockIdx.x % ngroups;
  const int bh = blockIdx.x / ngroups;
  const int b = bh / Hkv, kvh = bh % Hkv;
  const int j0 = hg * G;
  const int gcnt = min(G, g - j0);
  const int p0 = (gridDim.y - 1 - blockIdx.y) * P;  // heaviest tiles first
  const int p_last = min(S, p0 + P) - 1;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int cpr = D / V;  // 16-byte vectors per row

  // Query tile: row r is position p0 + r / G, head kvh * g + j0 + r % G.
  for (int c = tid; c < kBM * cpr; c += kThreads) {
    const int r = c / cpr, dc = (c - r * cpr) * V;
    const int pos = p0 + r / G, j = r % G;
    float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < P * G && j < gcnt && pos < S) {
      e = *reinterpret_cast<const float4*>(q + b * qsb + pos * qss +
                                           (kvh * g + j0 + j) * qsh + dc);
      e = make_float4(e.x * scale, e.y * scale, e.z * scale, e.w * scale);
    }
    *reinterpret_cast<float4*>(qs + r * ld + dc) = e;
  }

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = p0 + (ty + 16 * i) / G;

  int lo = 0, hi = Tk;
  if (causal) hi = min(Tk, p_last + 1);
  if (window > 0) lo = max(0, p0 - window + 1);

  float m[4], l[4], o[4][DJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
      for (int x = 0; x < 4; ++x) o[i][jj][x] = 0.f;
  }

  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;
  for (int t0 = (lo / kBN) * kBN; t0 < hi; t0 += kBN) {
    __syncthreads();  // the previous tile's readers are done; q is staged
    for (int c = tid; c < kBN * cpr; c += kThreads) {
      const int n = c / cpr, dc = (c - n * cpr) * V;
      const int t = t0 + n;
      float4 ek = make_float4(0.f, 0.f, 0.f, 0.f), ev = ek;
      if (t < Tk) {
        ek = *reinterpret_cast<const float4*>(kb + t * kst + dc);
        ev = *reinterpret_cast<const float4*>(vb + t * vst + dc);
      }
      *reinterpret_cast<float4*>(ks + n * ld + dc) = ek;
      *reinterpret_cast<float4*>(vs + n * D + dc) = ev;
    }
    __syncthreads();

    // Scores s[i][j] for row ty + 16 i and key tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) fma4(s[i][j], qv[i], kv[j]);
    }
    __syncthreads();  // every thread is done with the keys: ps aliases them

    // Online softmax per row; the 16 lanes of a half-warp share a row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + tx + 16 * j;
        ok[j] = t < Tk && (!causal || t <= qpos[i]) &&
                (window <= 0 || t > qpos[i] - window);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
        for (int x = 0; x < 4; ++x) o[i][jj][x] *= corr;
    }
    __syncthreads();

    // P.V: thread owns columns 64 jj + 4 tx .. + 3 of its four rows.
    const int nmax = min(kBN, Tk - t0);
    for (int n = 0; n < nmax; n += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kLdP + n);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          const int col = 64 * jj + 4 * tx;
          if (col < D) {
            const float4 vv = *reinterpret_cast<const float4*>(vs + (n + nn) * D + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = nn == 0 ? pv[i].x : nn == 1 ? pv[i].y : nn == 2 ? pv[i].z : pv[i].w;
              o[i][jj][0] = fmaf(p, vv.x, o[i][jj][0]);
              o[i][jj][1] = fmaf(p, vv.y, o[i][jj][1]);
              o[i][jj][2] = fmaf(p, vv.z, o[i][jj][2]);
              o[i][jj][3] = fmaf(p, vv.w, o[i][jj][3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, j = r % G;
    if (r >= P * G || j >= gcnt || qpos[i] >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = out + ((static_cast<size_t>(b) * S + qpos[i]) * H + kvh * g + j0 + j) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int col = 64 * jj + 4 * tx;
      if (col < D)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(o[i][jj][0] * inv, o[i][jj][1] * inv, o[i][jj][2] * inv,
                        o[i][jj][3] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA, a producer warpgroup and two consumer warpgroups on wgmma
// ---------------------------------------------------------------------------

// REPRO_FA_ABLATE, for measurement only (tools/flash_turns.py builds
// with it; the library never does): 1 issues P.V with the weights' high
// bf16 part alone and 2 skips the exp2, both changing the result; 3 splits
// each weight into three bf16 parts whose sum is exact.
#ifndef REPRO_FA_ABLATE
#define REPRO_FA_ABLATE 0
#endif

constexpr int kWgThreads = 128;              // a warpgroup
constexpr int kTmaThreads = 3 * kWgThreads;  // two consumer warpgroups, then the producer's
constexpr int kTileRows = 128;               // (position, head) rows per block, 64 per consumer
constexpr int kRowBytes = 128;               // one 64-column box row: one 128-byte swizzle row
constexpr int kStages = 3;                   // K/V ring depth
constexpr int kConsumerWarps = 8;            // arrivals that free a stage
constexpr int kProducerRegs = 40;            // setmaxnreg: the producer gives registers up,
constexpr int kConsumerRegs = 232;           // the consumers take them

// Shared memory, every tile 1024-byte aligned (the 128-byte swizzle's
// period): Q as NH halves of 128 rows x 64 columns, then kStages stages of
// K and V (NH halves of BN rows each), then the mbarriers.  DN is the head
// dim the products run at (64, 80 or 128; the boxes' zero fill pads D), BN
// the keys per K/V tile.
template <int DN, int BN>
struct TmaLayout {
  static constexpr int kHalves = (DN + 63) / 64;
  static constexpr int kQHalf = kTileRows * kRowBytes;
  static constexpr int kKVHalf = BN * kRowBytes;
  static constexpr int kQ = kHalves * kQHalf;
  static constexpr int kStage = 2 * kHalves * kKVHalf;
  static constexpr int kBar = kQ + kStages * kStage;
  static constexpr int kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

// wgmma shared-memory descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets.  K-major (Q, K): the stride offset is
// 1024 bytes between 8-row groups, the leading one unused; a 16-column step
// along K adds 32 bytes inside the swizzled row.  MN-major (V): the stride
// offset is 1024 bytes between 8-key groups and the leading one the bytes
// between 64-column halves; a 16-key step adds 2048 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from reading or reusing registers that an issued wgmma
// still writes or reads: call after the wait that retires it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// S (+)= A . B^T, m64n64k16: A (64 x 16) and B (64 x 16) K-major in shared
// memory (descriptors); ScaleD = 0 overwrites d.
template <int ScaleD>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, %34, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(ScaleD));
}

// S (+)= A . B^T, m64n96k16: A (64 x 16) and B (96 x 16) K-major in shared
// memory (descriptors); ScaleD = 0 overwrites d.
template <int ScaleD>
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, %50, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "n"(ScaleD));
}

// O += A . B, m64n64k16: A (64 x 16) from registers in the accumulator's
// fragment layout, B (16 x 64) MN-major in shared memory (transposed on read).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// O += A . B, m64n80k16: A (64 x 16) from registers in the accumulator's
// fragment layout, B (16 x 80) MN-major in shared memory (transposed on read).
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// O += A . B, m64n128k16: A (64 x 16) from registers in the accumulator's
// fragment layout, B (16 x 128) MN-major in shared memory (transposed on read).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int N, int ScaleD>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 64) wgmma_ss_n64<ScaleD>(d, da, db);
  else wgmma_ss_n96<ScaleD>(d, da, db);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 80) wgmma_rs_n80(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// 2^x on the SFU, denormal results flushed to zero (a weight below 2^-126
// of the row's largest adds nothing to a sum that is at least 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 weights as two bf16 pairs, hi = rn(p) and lo = rn(p - hi).
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
#if REPRO_FA_ABLATE == 1
  lo = 0u;
#endif
}

#if REPRO_FA_ABLATE == 3
// Two f32 weights as three bf16 pairs whose sum is exactly the f32 pair.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  split2(x, y, hi, mid);
  const float2 hf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  const float2 mf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&mid));
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x - mf.x, y - hf.y - mf.y);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
#endif

// Block map as in the source note.  Consumer warpgroup c owns rows
// 64 c .. 64 c + 63; in it, warp w's lane (gid = lane / 4, tig = lane % 4)
// holds rows 64 c + 16 w + gid and + 8 in the wgmma accumulator layout:
// element 4 i + e (e < 2) at column 8 i + 2 tig + e of the first row,
// 4 i + 2 + e of the second.
template <int DN, int BN>
__global__ void __launch_bounds__(kTmaThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             __nv_bfloat16* __restrict__ out, int S, int Tk, int H, int Hkv,
                             int D, int G, int P, int ngroups, float scale, int causal,
                             int window) {
  using L = TmaLayout<DN, BN>;
  constexpr int NH = L::kHalves;
  constexpr int NC = BN / 16;  // 16-key steps of P.V
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, kv_s = base + L::kQ;
  const uint32_t q_full = base + L::kBar;  // then full[kStages], empty[kStages]
  const auto full = [&](int s) { return q_full + 8 * (1 + s); };
  const auto empty = [&](int s) { return q_full + 8 * (1 + kStages + s); };

  const int g = H / Hkv;
  const int hg = blockIdx.x % ngroups;
  const int bh = blockIdx.x / ngroups;
  const int b = bh / Hkv, kvh = bh % Hkv;
  const int h0 = kvh * g + hg * G;                   // the group's first query head
  const int p0 = (gridDim.y - 1 - blockIdx.y) * P;  // heaviest tiles first
  const int p_last = min(S, p0 + P) - 1;
  int lo = 0, hi = Tk;
  if (causal) hi = min(Tk, p_last + 1);
  if (window > 0) lo = max(0, p0 - window + 1);
  const int t_begin = (lo / BN) * BN;
  const int n_kv = (hi - t_begin + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup's role, warp-uniform: 0 and 1 consume, 2 produces.
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);
  if (role == 2) {
    // Producer: one thread loads Q once, then keeps the K/V ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == 2 * kWgThreads) {
      mbar_expect_tx(q_full, NH * P * G * kRowBytes);
      for (int h = 0; h < NH; ++h) tma_load4(q_s + h * L::kQHalf, &qmap, q_full, 64 * h, h0, p0, b);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);  // round 0 passes at once
        const uint32_t ks = kv_s + s * L::kStage, vs = ks + NH * L::kKVHalf;
        const int t0 = t_begin + it * BN;
        mbar_expect_tx(full(s), L::kStage);
        for (int h = 0; h < NH; ++h) {
          tma_load4(ks + h * L::kKVHalf, &kmap, full(s), 64 * h, kvh, t0, b);
          tma_load4(vs + h * L::kKVHalf, &vmap, full(s), 64 * h, kvh, t0, b);
        }
      }
    }
    asm volatile("exit;\n" ::: "memory");  // the two roles' paths never rejoin
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int cw = role;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int gid = lane / 4, tig = lane % 4;
    const int r0 = cw * 64 + warp * 16 + gid, r1 = r0 + 8;
    const int qpos0 = p0 + r0 / G, qpos1 = p0 + r1 / G;
    const int pos_first = p0 + cw * 64 / G, pos_last = p0 + (cw * 64 + 63) / G;
    const float scale_log2 = scale * 1.4426950408889634f;
    const uint32_t q_wg = q_s + cw * 64 * kRowBytes;

    // Running statistics in base 2 of the scaled scores: m = max of
    // s * scale_log2, each weight exp2(s * scale_log2 - m), one FFMA; l is
    // kept per thread (its own columns) and summed over the quad at the end,
    // since the factor that rescales it is the same on the quad's lanes.
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    // Keys a row sees: key_lo < t <= key_hi (the causal diagonal, the end of
    // T, the window's edge).
    int key_hi[2], key_lo[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pos = r ? qpos1 : qpos0;
      key_hi[r] = causal ? min(Tk - 1, pos) : Tk - 1;
      key_lo[r] = window > 0 ? pos - window : -1;
    }
    float o[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) o[i] = 0.f;
#if REPRO_FA_ABLATE == 3
    uint32_t pm[NC][4];  // the middle weight parts
#endif

    // Q.K^T of tile it into sc, issued and committed, not waited for.
    const auto qk = [&](float (&sc)[BN / 2], int it) {
      const uint32_t ks = kv_s + (it % kStages) * L::kStage;
#pragma unroll
      for (int kc = 0; kc < DN / 16; ++kc) {
        const uint64_t da = sw128_desc(q_wg + (kc / 4) * L::kQHalf + (kc % 4) * 32, 16, 1024);
        const uint64_t db = sw128_desc(ks + (kc / 4) * L::kKVHalf + (kc % 4) * 32, 16, 1024);
        if (kc == 0) wgmma_ss<BN, 0>(sc, da, db);
        else wgmma_ss<BN, 1>(sc, da, db);
      }
      wgmma_commit();
    };
    // P.V of tile it, each weight as its two bf16 parts, issued and
    // committed, not waited for.
    const auto pv = [&](const uint32_t (&ph)[NC][4], const uint32_t (&pl)[NC][4], int it) {
      const uint32_t vs = kv_s + (it % kStages) * L::kStage + NH * L::kKVHalf;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint64_t dv = sw128_desc(vs + c * 16 * kRowBytes, L::kKVHalf, 1024);
        wgmma_rs<DN>(o, ph[c], dv);
#if REPRO_FA_ABLATE != 1
        wgmma_rs<DN>(o, pl[c], dv);
#endif
#if REPRO_FA_ABLATE == 3
        wgmma_rs<DN>(o, pm[c], dv);
#endif
      }
      wgmma_commit();
    };
    // Online softmax of tile it: updates m and l, turns sc into weights and
    // returns the factors that rescale o.  A masked score becomes -inf,
    // weight exp2(-inf) = 0; m starts at the finite kNegInf, so a row that
    // has seen only masked keys keeps m, l = 0 and o = 0, and its first
    // visible key rescales them by exp2(kNegInf - m) = 0 (the TPU kernel's
    // outcome).  Maxima and sums run as four chains per row.
    const auto softmax_tile = [&](float (&sc)[BN / 2], int t0, float (&corr)[2], auto masked) {
      float mx[2][4], sum[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mx[r][j] = -CUDART_INF_F;
          sum[r][j] = 0.f;
        }
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& x = sc[4 * i + 2 * r + e];
            if constexpr (decltype(masked)::value) {
              const int t = t0 + 8 * i + 2 * tig + e;
              x = (t <= key_hi[r] && t > key_lo[r]) ? x : -CUDART_INF_F;
            }
            mx[r][2 * (i & 1) + e] = fmaxf(mx[r][2 * (i & 1) + e], x);
          }
      float mn[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        mn[r] = fmaxf(m[r], v * scale_log2);
      }
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& x = sc[4 * i + 2 * r + e];
#if REPRO_FA_ABLATE == 2
            x = fmaf(x, scale_log2, -mn[r]);
#else
            x = ex2(fmaf(x, scale_log2, -mn[r]));
#endif
            sum[r][2 * (i & 1) + e] += x;
          }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        corr[r] = ex2(m[r] - mn[r]);
        l[r] = l[r] * corr[r] + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
        m[r] = mn[r];
      }
    };
    // Two copies behind a warp-uniform branch: only the tiles that cross the
    // diagonal, the window's edge or the end of T pay for the mask (one
    // copy with a predicated mask would run it on every tile).
    const auto softmax = [&](float (&sc)[BN / 2], int it, float (&corr)[2]) {
      const int t0 = t_begin + it * BN;
      if (t0 + BN > Tk || (causal && t0 + BN - 1 > pos_first) ||
          (window > 0 && t0 <= pos_last - window))
        softmax_tile(sc, t0, corr, std::true_type{});
      else
        softmax_tile(sc, t0, corr, std::false_type{});
    };
    // o *= corr (skipped where no row of the warp has a new maximum, as
    // most tiles after the first few), then the weights into P.V's A
    // fragments: the fragment of 16-key step c is the scores of column tiles
    // 2 c and 2 c + 1, register x holding elements 8 c + 2 x and + 1.
    const auto rescale_split = [&](const float (&sc)[BN / 2], const float (&corr)[2],
                                   uint32_t (&ph)[NC][4], uint32_t (&pl)[NC][4]) {
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < DN / 8; ++i) {
          o[4 * i] *= corr[0];
          o[4 * i + 1] *= corr[0];
          o[4 * i + 2] *= corr[1];
          o[4 * i + 3] *= corr[1];
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int x = 0; x < 4; ++x)
#if REPRO_FA_ABLATE == 3
          split3(sc[8 * c + 2 * x], sc[8 * c + 2 * x + 1], ph[c][x], pm[c][x], pl[c][x]);
#else
          split2(sc[8 * c + 2 * x], sc[8 * c + 2 * x + 1], ph[c][x], pl[c][x]);
#endif
    };
    const auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(it % kStages));  // this warp is done with the stage
    };
    // Ping-pong: the two warpgroups take turns to issue their products
    // (named barriers 1 and 2, 256 threads each), so the tensor cores run
    // one's products while the other computes its softmax.  Warpgroup 1
    // opens warpgroup 0's first turn and leaves its own last one unanswered.
    const auto my_turn = [&] {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + cw), "n"(2 * kWgThreads) : "memory");
    };
    const auto your_turn = [&](bool last) {
      if (!(last && cw == 1))
        asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - cw), "n"(2 * kWgThreads) : "memory");
    };

    // Tile it's Q.K^T is issued with tile it - 1's P.V, and tile it's
    // softmax statistics are computed while that P.V still runs.
    float sc[BN / 2];  // overwritten by each Q.K^T's first step
    uint32_t ph[NC][4], pl[NC][4];
    float corr[2];
    if (cw == 1) asm volatile("bar.arrive 1, %0;\n" ::"n"(2 * kWgThreads) : "memory");
    mbar_wait(q_full, 0);
    mbar_wait(full(0), 0);
    my_turn();
    wgmma_fence();
    qk(sc, 0);
    your_turn(false);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(sc, 0, corr);
    rescale_split(sc, corr, ph, pl);
    for (int it = 1; it < n_kv; ++it) {
      mbar_wait(full(it % kStages), (it / kStages) & 1);
      my_turn();
      wgmma_fence();
      qk(sc, it);
      pv(ph, pl, it - 1);
      your_turn(false);
      wgmma_wait<1>();  // Q.K^T done, P.V may still run
      fence_regs(sc);
      softmax(sc, it, corr);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
#if REPRO_FA_ABLATE == 3
      fence_regs(pm);
#endif
      release(it - 1);
      rescale_split(sc, corr, ph, pl);
    }
    my_turn();
    wgmma_fence();
    pv(ph, pl, n_kv - 1);
    your_turn(true);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
#if REPRO_FA_ABLATE == 3
    fence_regs(pm);
#endif
    release(n_kv - 1);

    const int rows[2] = {r0, r1};
    const int qp[2] = {qpos0, qpos1};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      if (rows[r] >= P * G || qp[r] >= S) continue;
      __nv_bfloat16* orow =
          out + ((static_cast<size_t>(b) * S + qp[r]) * H + h0 + rows[r] % G) * D;
#pragma unroll
      for (int i = 0; i < DN / 8; ++i) {
        const int col = 8 * i + 2 * tig;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
      }
    }
  }
}

// A bf16 map over (D, heads, positions, batch) with element strides sh, sp,
// sb, swizzled 128 bytes, box (64, box_heads, box_len, 1).
bool encode_map(CUtensorMap* map, const void* ptr, int D, int heads, int len, int B,
                long long sh, long long sp, long long sb, int box_heads, int box_len) {
  return encode_heads_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, D, heads, len, B, sh,
                          sp, sb, 64, box_heads, box_len, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int DN, int BN>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
                 int H, int Hkv, int D, int G, int P, long long qsb, long long qss,
                 long long qsh, long long ksb, long long kst, long long ksh, long long vsb,
                 long long vst, long long vsh, float scale, int causal, int window,
                 cudaStream_t stream) {
  const int g = H / Hkv;
  if (G < 1 || G > kMaxG || g % G != 0 || P < 1 || P * G > kTileRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ngroups = g / G;
  const int ntiles = (S + P - 1) / P;
  const long long nblocks_x = static_cast<long long>(B) * Hkv * ngroups;
  if (ntiles > 65535 || nblocks_x > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap qmap, kmap, vmap;
  if (!encode_map(&qmap, q, D, H, S, B, qsh, qss, qsb, G, P) ||
      !encode_map(&kmap, k, D, Hkv, Tk, B, ksh, kst, ksb, 1, BN) ||
      !encode_map(&vmap, v, D, Hkv, Tk, B, vsh, vst, vsb, 1, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = &flash_attention_wgmma_kernel<DN, BN>;
  constexpr int smem = TmaLayout<DN, BN>::kSmem;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(nblocks_x), ntiles);
  kern<<<grid, kTmaThreads, smem, stream>>>(qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out),
                                            S, Tk, H, Hkv, D, G, P, ngroups, scale, causal,
                                            window);
  return static_cast<int>(cudaGetLastError());
}

// f32: one block per (batch, KV head, head group of up to 16) and 64-row
// query tile.
template <typename T, typename Kernel>
int launch(Kernel kern, int threads, size_t smem, const void* q, const void* k,
           const void* v, void* out, int B, int S, int Tk, int H, int Hkv, int D,
           long long qsb, long long qss, long long qsh, long long ksb, long long kst,
           long long ksh, long long vsb, long long vst, long long vsh, float scale,
           int causal, int window, cudaStream_t stream) {
  const int g = H / Hkv;
  const int G = std::min(g, kMaxG);
  const int ngroups = (g + G - 1) / G;
  const int P = kBM / G;
  const int ntiles = (S + P - 1) / P;
  const long long nblocks_x = static_cast<long long>(B) * Hkv * ngroups;
  if (ntiles > 65535 || nblocks_x > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(nblocks_x), ntiles);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, Tk, H, Hkv, D, G, ngroups, qsb, qss, qsh, ksb, kst, ksh,
      vsb, vst, vsh, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int S, int T,
    int H, int Hkv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kst, long long ksh, long long vsb, long long vst,
    long long vsh, float scale, int causal, int window, int G, int P, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || T < S || Hkv <= 0 || H % Hkv != 0 || D <= 0 ||
      D % 8 != 0 || D > 128 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {  // (G, P): the wrapper's plan of 128-row tiles
    const auto run = D <= 64   ? &launch_wgmma<64, 96>
                     : D <= 80 ? &launch_wgmma<80, 96>
                               : &launch_wgmma<128, 64>;
    return run(q, k, v, out, B, S, T, H, Hkv, D, G, P, qsb, qss, qsh, ksb, kst, ksh, vsb, vst,
               vsh, scale, causal, window, s);
  }
  if (dtype == kF32) {
    const int ld = D + 4;
    const size_t smem =
        sizeof(float) * (kBM * ld + std::max(kBN * ld, kBM * kLdP) + kBN * D);
    return launch<float>(D <= 64 ? &flash_attention_kernel<64> : &flash_attention_kernel<128>,
                         kThreads, smem, q, k, v, out, B, S, T, H, Hkv, D, qsb, qss, qsh, ksb,
                         kst, ksh, vsb, vst, vsh, scale, causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
