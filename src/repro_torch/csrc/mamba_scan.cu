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
// The recurrence is serial in T; the parallelism is B * Dc * S.
//
// A step costs one exp per (c, s) on the SFUs; the loads and reductions
// that feed it cost instructions on the SM's shared-memory and shuffle
// pipe, and the staging of each chunk of steps costs the scan its time
// unless other warps do it.  What the design does:
//  - several states a thread: a thread carries K states of one channel in
//    registers, so a channel takes L = SP / K lanes (S padded to SP = K * L,
//    padded states hold zeros).  B[t, s0:s0+K] and C[t, s0:s0+K] come in
//    as one or two 16-byte shared loads each, and the sum over states is
//    K - 1 register adds before any shuffle;
//  - several steps per shuffle tree: each lane keeps its partial y of G
//    steps (8, or 2 L where L > 4) in registers, then a transpose-reduce
//    over the channel's L lanes halves the values it exchanges at every
//    level and leaves each lane the full y of G / L steps: (L - 1) G / L
//    shuffles for G steps, where a tree per step would take G log2(L).
//    The G steps' exps and loads are independent of each other, which is
//    the scan warps' latency hiding where few of them share an SM;
//  - x and dt are staged step-major per channel, so a thread reads four
//    steps of its channel in one 16-byte load; the tile's 16-byte units are
//    XOR-swizzled by channel so that both the staging stores (four steps of
//    one channel for 8 step groups) and the scan's loads (one unit of each
//    of 8 channels) fall on distinct banks;
//  - the exp is one `ex2.approx.ftz` of dt * (A * log2 e), A prescaled once:
//    one multiply and one MUFU.EX2 per (t, c, s);
//  - warp specialisation: a block is 8 scan warps and 4 staging warps over
//    two stages of f32 tiles, at most 85 registers a thread so that two
//    blocks share an SM.  A block serves CH = 256 / L channels of one
//    batch row and walks T in chunks of 16 L steps (CH * chunk = 4096).
//    The staging warps land chunk n + 1 in shared memory by 16-byte
//    cp.async copies, as the rows lie in global memory, while the scan
//    warps run chunk n; they convert it into the free stage's f32 tiles,
//    write out the y that stage held, and hand the stage over through
//    named barriers (one "full" and one "empty" barrier a stage).  The
//    scan warps wait only where the staging warps fall behind;
//  - y overwrites x in its own tile (the lanes that read x[c, t] are the
//    lanes of c's warp that write y[c, t], after a warp sync) and goes out
//    in 16-byte stores per row;
//  - only h's update depends on the previous step (one FMA), so the
//    unrolled steps of a group overlap their exps and loads.
// The D * x skip enters the partial sum of the channel's lane 0.  Every sum
// runs in a fixed order, so two calls give the same bits.  Tails in T and Dc
// are masked (zeros in, nothing stored), so any T and Dc are taken.  Where
// x, dt and y (or B and C) are not 16-byte aligned, as slices of a
// projection may be, the staging warps read them with scalar loads.
//
// The plan (K, L, chunk, grid, shared memory) comes from the Python
// wrapper's `scan_plan`; the entry point refuses a plan whose layout
// disagrees with its own.
//
// Contract (checked by the Python wrapper): x, dt and y are contiguous
// (B, T, Dc) of one dtype (f32 or bf16); B and C are (B, T, S) of that
// dtype with a contiguous last axis and batch and time strides given in
// elements; A is contiguous f32 (Dc, S) and D contiguous f32 (Dc,);
// 1 <= S <= K * L <= 32.

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kScan = 256;                // scan threads a block (8 warps)
constexpr int kStage = 128;               // staging threads a block (4 warps)
constexpr int kBlock = kScan + kStage;
constexpr int kTile = 4096;               // channels x steps of a block's x (and dt) tile
constexpr float kLog2e = 1.4426950408889634f;

// The layout of plan (K states, L lanes a channel) in dtype T.
template <typename T, int K, int L>
struct Plan {
  static constexpr int SP = K * L;                     // states, padded
  static constexpr int CH = kScan / L;                 // channels a block
  static constexpr int CHUNK = kTile / CH;             // steps a chunk: 16 L
  static constexpr int G = 2 * (L > 4 ? L : 4);        // steps a shuffle tree
  static constexpr int R = G / L;                      // y values a lane ends with
  static constexpr int SWZ = (CHUNK / 4 < 8 ? CHUNK / 4 : 8) - 1;
  static constexpr int ES = static_cast<int>(sizeof(T));
  static constexpr int LR = (SP * ES + 15) / 16 * 16 / ES;   // a landed B or C row
  // one stage: the f32 tiles of x (then y), dt, B and C
  static constexpr int STAGE = 2 * kTile + 2 * CHUNK * SP;
  // two stages, then the landing tiles in T
  static constexpr int SMEM = 4 * 2 * STAGE + ES * (2 * kTile + 2 * CHUNK * LR);
  static_assert(CH * CHUNK == kTile && CHUNK % G == 0 && G % 4 == 0 && R >= 1 && SP <= 32 &&
                    L <= 32,
                "a plan's tiles divide evenly");
};

// Host-side twin of Plan<T, K, L>::SMEM, for any (K, L) and element size.
int plan_smem(int K, int L, int esize) {
  const int sp = K * L, chunk = kTile * L / kScan;
  const int lr = (sp * esize + 15) / 16 * 16 / esize;
  return 4 * 2 * (2 * kTile + 2 * chunk * sp) + esize * (2 * kTile + 2 * chunk * lr);
}

// 16 bytes global -> shared, asynchronously; bytes past `src_bytes` (0 to
// 16) are zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Named barriers 1 + stage ("full") and 3 + stage ("empty") over the whole
// block: one side arrives, the other waits.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kBlock) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kBlock) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Element (channel ch, step t) of an x or dt tile: 16-byte units of four
// steps, swizzled by channel.
template <int CHUNK, int SWZ>
__device__ __forceinline__ int tile_at(int ch, int t) {
  return ch * CHUNK + ((((t >> 2) ^ (ch & SWZ))) << 2) + (t & 3);
}

// K consecutive floats of shared memory (K * 4-byte aligned).
template <int K>
__device__ __forceinline__ void load_k(const float* p, float* out) {
  if constexpr (K == 1) {
    out[0] = p[0];
  } else if constexpr (K == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      out[j] = v.x; out[j + 1] = v.y; out[j + 2] = v.z; out[j + 3] = v.w;
    }
  }
}

// Transpose-reduce of v[0..N) over L lanes (li = lane within the channel):
// at each level a lane keeps one half, adds its partner's copy of that half
// and hands over the other.  Afterwards v[j] holds the sum over the L lanes
// of entry li * (N / L) + j.
template <int N, int L>
__device__ __forceinline__ void transpose_sum(float* v, int li) {
  if constexpr (L > 1) {
    constexpr int H = N / 2, O = L / 2;
    const bool up = (li & O) != 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float give = up ? v[j] : v[j + H];
      const float keep = up ? v[j + H] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, give, O);
    }
    transpose_sum<H, O>(v, li);
  }
}

// 16 bytes of registers -> Vec<T>::n floats.
__device__ __forceinline__ void unpack(const uint4& r, float* out, float) {
  out[0] = __uint_as_float(r.x); out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z); out[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, float* out, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T, int K, int L>
__global__ void __launch_bounds__(kBlock, 2)
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const T* __restrict__ bm, const T* __restrict__ cm,
                  const float* __restrict__ a, const float* __restrict__ dskip,
                  T* __restrict__ y, int n_t, int Dc, int S, long long bsb,
                  long long bst, long long csb, long long cst, bool vec, bool bc_vec) {
  using P = Plan<T, K, L>;
  constexpr int CH = P::CH, CHUNK = P::CHUNK, SP = P::SP, G = P::G, SWZ = P::SWZ;
  constexpr int LR = P::LR;

  extern __shared__ float4 smem4[];
  // stage s: x (then y) and dt (CH, CHUNK), B and C (CHUNK, SP), all f32
  float* const stage0 = reinterpret_cast<float*>(smem4);
  auto sx = [&](int s) { return stage0 + s * P::STAGE; };
  auto sdt = [&](int s) { return sx(s) + kTile; };
  auto sb = [&](int s) { return sx(s) + 2 * kTile; };
  auto sc = [&](int s) { return sx(s) + 2 * kTile + CHUNK * SP; };

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * CH;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * n_t;
  const int n_chunks = (n_t + CHUNK - 1) / CHUNK;

  if (tid >= kScan) {
    // -- staging warps ------------------------------------------------------
    constexpr int VE = Vec<T>::n;        // channels a 16-byte vector
    constexpr int CV = CH / VE;          // vectors across the block's channels
    constexpr int LSW = (CV < 8 ? CV : 8) - 1;
    constexpr int RG = CHUNK / 4;        // groups of four steps in a chunk
    constexpr int NU = 2 * CV * RG;      // units: four steps of VE channels of x, then dt
    constexpr int NCR = LR / VE;         // 16-byte pieces of a landed B or C row
    constexpr int NBC = 2 * CHUNK * NCR; // B and C pieces a chunk
    constexpr int NBS = 2 * CHUNK * SP;  // B and C values a chunk
    static_assert(CH % VE == 0 && LR % VE == 0 && NU % (2 * kStage) == 0,
                  "whole vectors across the channels, whole units a staging thread");
    T* const lx = reinterpret_cast<T*>(stage0 + 2 * P::STAGE);
    T* const ldt = lx + kTile;           // landing: x, dt (CHUNK, CH) as in global memory
    T* const lb = ldt + kTile;           // B, C (CHUNK, LR)
    T* const lc = lb + CHUNK * LR;
    const int pid = tid - kScan;
    const T* bb = bm + blockIdx.y * bsb;
    const T* cb = cm + blockIdx.y * csb;
    // A unit's landed rows are swizzled by row group.
    auto land_at = [](int tl, int cv) { return tl * CH + ((cv ^ ((tl >> 2) & LSW)) * VE); };
    // Chunk t0 into the landing tiles: this thread's units and pieces.
    auto issue = [&](int t0) {
      if (vec) {
#pragma unroll
        for (int i = 0; i < NU / kStage; ++i) {
          const int u = pid + i * kStage;
          const int rg = u % RG, cv = (u / RG) % CV, c = c0 + cv * VE;
          const T* src = u < NU / 2 ? x : dt;
          T* dst = u < NU / 2 ? lx : ldt;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int t = t0 + 4 * rg + r;
            const bool ok = t < n_t && c < Dc;
            cp_async16(smem_u32(dst + land_at(4 * rg + r, cv)),
                       ok ? src + (row0 + t) * Dc + c : src, ok ? 16 : 0);
          }
        }
      }
      if (bc_vec) {
#pragma unroll
        for (int i = 0; i < (NBC + kStage - 1) / kStage; ++i) {
          const int e = pid + i * kStage;
          if (e >= NBC) continue;
          const int j = e % NCR, tl = (e / NCR) % CHUNK, t = t0 + tl;
          const bool is_c = e >= NBC / 2;
          const int bytes = t < n_t ? min(max(S * P::ES - 16 * j, 0), 16) : 0;
          const T* src = (is_c ? cb + t * cst : bb + t * bst) + j * VE;
          cp_async16(smem_u32((is_c ? lc : lb) + tl * LR + j * VE), bytes ? src : bb, bytes);
        }
      }
      cp_async_commit();
    };
    // The landed chunk t0 (or, where it could not land, global memory)
    // into stage s's f32 tiles.
    auto convert = [&](int t0, int s) {
      cp_async_wait_all();   // this thread's own pieces
#pragma unroll
      for (int i = 0; i < NU / kStage; ++i) {
        const int u = pid + i * kStage;
        const int rg = u % RG, cv = (u / RG) % CV, c = c0 + cv * VE;
        float f[4][VE];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = t0 + 4 * rg + r;
          if (vec) {
            const T* land = (u < NU / 2 ? lx : ldt) + land_at(4 * rg + r, cv);
            unpack(*reinterpret_cast<const uint4*>(land), f[r], T());
          } else {
            const T* p = (u < NU / 2 ? x : dt) + (row0 + t) * Dc + c;
#pragma unroll
            for (int j = 0; j < VE; ++j) f[r][j] = t < n_t && c + j < Dc ? to_float(p[j]) : 0.f;
          }
        }
        float* dst = u < NU / 2 ? sx(s) : sdt(s);
#pragma unroll
        for (int j = 0; j < VE; ++j)
          *reinterpret_cast<float4*>(dst + tile_at<CHUNK, SWZ>(cv * VE + j, 4 * rg)) =
              make_float4(f[0][j], f[1][j], f[2][j], f[3][j]);
      }
      if (bc_vec) {
#pragma unroll
        for (int i = 0; i < (NBC + kStage - 1) / kStage; ++i) {
          const int e = pid + i * kStage;
          if (e >= NBC) continue;
          const int j = e % NCR, tl = (e / NCR) % CHUNK;
          const bool is_c = e >= NBC / 2;
          const T* land = (is_c ? lc : lb) + tl * LR + j * VE;
          float* dst = (is_c ? sc(s) : sb(s)) + tl * SP + j * VE;
#pragma unroll
          for (int i = 0; i < VE; ++i)
            if (j * VE + i < SP) dst[i] = to_float(land[i]);   // zeros past S
        }
      } else {
#pragma unroll 4
        for (int e = pid; e < NBS; e += kStage) {
          const int st = e % SP, t = t0 + (e / SP) % CHUNK;
          const bool is_c = e >= NBS / 2;
          (is_c ? sc(s) - NBS / 2 : sb(s))[e] =
              t < n_t && st < S ? to_float(is_c ? cb[t * cst + st] : bb[t * bst + st]) : 0.f;
        }
      }
    };
    // Chunk t0's y, in stage s's x tile, out: the x units convert() filled.
    auto drain = [&](int t0, int s) {
#pragma unroll
      for (int i = 0; i < NU / 2 / kStage; ++i) {
        const int u = pid + i * kStage;
        const int rg = u % RG, cv = u / RG, c = c0 + cv * VE;
        float f[4][VE];
#pragma unroll
        for (int j = 0; j < VE; ++j) {
          const float4 v =
              *reinterpret_cast<const float4*>(sx(s) + tile_at<CHUNK, SWZ>(cv * VE + j, 4 * rg));
          f[0][j] = v.x; f[1][j] = v.y; f[2][j] = v.z; f[3][j] = v.w;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = t0 + 4 * rg + r;
          if (t >= n_t) continue;
          T* p = y + (row0 + t) * Dc + c;
          if (vec) {
            if (c < Dc) store_vec(p, f[r]);
          } else {
#pragma unroll
            for (int j = 0; j < VE; ++j)
              if (c + j < Dc) p[j] = from_float<T>(f[r][j]);
          }
        }
      }
    };

    issue(0);
    for (int n = 0; n < n_chunks + 2; ++n) {
      const int s = n & 1;
      if (n >= 2) {
        bar_sync(3 + s);   // the scan warps are done with chunk n - 2
        drain((n - 2) * CHUNK, s);
      }
      if (n < n_chunks) {
        convert(n * CHUNK, s);
        if (n + 1 < n_chunks) issue((n + 1) * CHUNK);   // lands while chunk n runs
        bar_arrive(1 + s);
      }
    }
    return;
  }

  // -- scan warps: channel q, states li * K + k ------------------------------
  const int q = tid / L, li = tid % L;
  const int c = c0 + q;
  float a2[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = li * K + k;
    a2[k] = (c < Dc && s < S) ? a[static_cast<size_t>(c) * S + s] * kLog2e : 0.f;
    h[k] = 0.f;
  }
  const float dsk = (li == 0 && c < Dc) ? dskip[c] : 0.f;

  for (int n = 0; n < n_chunks; ++n) {
    const int s = n & 1;
    float* const tx = sx(s);
    const float* const tdt = sdt(s);
    const float* const tb = sb(s);
    const float* const tc = sc(s);
    bar_sync(1 + s);   // stage s holds chunk n
    // Steps past n_t see dt = 0 and B = C = 0: h is left as it is.
#pragma unroll 1
    for (int tg = 0; tg < CHUNK; tg += G) {
      float xv[G], dv[G];
#pragma unroll
      for (int i = 0; i < G; i += 4) {
        const float4 vx = *reinterpret_cast<const float4*>(tx + tile_at<CHUNK, SWZ>(q, tg + i));
        const float4 vd = *reinterpret_cast<const float4*>(tdt + tile_at<CHUNK, SWZ>(q, tg + i));
        xv[i] = vx.x; xv[i + 1] = vx.y; xv[i + 2] = vx.z; xv[i + 3] = vx.w;
        dv[i] = vd.x; dv[i + 1] = vd.y; dv[i + 2] = vd.z; dv[i + 3] = vd.w;
      }
      float p[G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        float bk[K], ck[K];
        load_k<K>(tb + (tg + i) * SP + li * K, bk);
        load_k<K>(tc + (tg + i) * SP + li * K, ck);
        const float d = dv[i], bx = d * xv[i];
        float acc = dsk * xv[i];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          h[k] = fmaf(h[k], ex2(d * a2[k]), bx * bk[k]);
          acc = fmaf(h[k], ck[k], acc);
        }
        p[i] = acc;
      }
      transpose_sum<G, L>(p, li);
      __syncwarp();   // every lane of this channel has read its x
#pragma unroll
      for (int j = 0; j < P::R; ++j) tx[tile_at<CHUNK, SWZ>(q, tg + li * P::R + j)] = p[j];
    }
    bar_arrive(3 + s);   // stage s is free; its x tile holds chunk n's y
  }
}

using Launch = int (*)(const void*, const void*, const void*, const void*, const void*,
                       const void*, void*, int, int, int, int, long long, long long, long long,
                       long long, bool, bool, cudaStream_t);

template <typename T, int K, int L>
int launch(const void* x, const void* dt, const void* bm, const void* cm, const void* a,
           const void* d, void* y, int B, int n_t, int Dc, int S, long long bsb, long long bst,
           long long csb, long long cst, bool vec, bool bc_vec, cudaStream_t stream) {
  using P = Plan<T, K, L>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      mamba_scan_kernel<T, K, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Dc + P::CH - 1) / P::CH, B);
  mamba_scan_kernel<T, K, L><<<grid, kBlock, P::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(a), static_cast<const float*>(d),
      static_cast<T*>(y), n_t, Dc, S, bsb, bst, csb, cst, vec, bc_vec);
  return static_cast<int>(cudaGetLastError());
}

// The launcher of plan (K, L) in dtype T, or null where the library has no
// such plan.
template <typename T>
Launch pick(int K, int L) {
#define REPRO_SCAN_PLAN(k, l) \
  if (K == k && L == l) return &launch<T, k, l>;
  // scan_plan's: K = min(4, SP) states, or 8 where the grid is large
  REPRO_SCAN_PLAN(1, 1)
  REPRO_SCAN_PLAN(2, 1)
  REPRO_SCAN_PLAN(4, 1)
  REPRO_SCAN_PLAN(4, 2)
  REPRO_SCAN_PLAN(4, 4)
  REPRO_SCAN_PLAN(4, 8)
  REPRO_SCAN_PLAN(8, 1)
  REPRO_SCAN_PLAN(8, 2)
  REPRO_SCAN_PLAN(8, 4)
#undef REPRO_SCAN_PLAN
  return nullptr;
}

}  // namespace

extern "C" int repro_mamba_scan(const void* x, const void* dt, const void* bm, const void* cm,
                                const void* a, const void* d, void* y, int B, int n_t, int Dc,
                                int S, long long bsb, long long bst, long long csb,
                                long long cst, int dtype, int K, int L, int chunk, int grid,
                                int smem, void* stream) {
  if (B <= 0 || B > 65535 || n_t <= 0 || Dc <= 0 || S <= 0 || K <= 0 || L <= 0 ||
      S > K * L || K * L > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ch = kScan / L;
  const int esize = dtype == kBF16 ? 2 : 4;
  if (chunk != kTile / ch || grid != (Dc + ch - 1) / ch || smem != plan_smem(K, L, esize))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch fn = dtype == kBF16 ? pick<__nv_bfloat16>(K, L)
                    : dtype == kF32 ? pick<float>(K, L)
                                    : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  // 16-byte copies of x, dt and y rows, and of B and C rows
  const bool vec = (Dc * esize) % 16 == 0 && aligned(x) && aligned(dt) && aligned(y);
  const bool bc_vec = aligned(bm) && aligned(cm) && (bst * esize) % 16 == 0 &&
                      (cst * esize) % 16 == 0 &&
                      (B == 1 || ((bsb * esize) % 16 == 0 && (csb * esize) % 16 == 0));
  return fn(x, dt, bm, cm, a, d, y, B, n_t, Dc, S, bsb, bst, csb, cst, vec, bc_vec,
            static_cast<cudaStream_t>(stream));
}
