// Decode attention (flash-decode, one query token per head) for Hopper
// (sm_90a): split-KV over a thread-block cluster, one launch.
//
// Replaces the Pallas TPU kernel `decode_attention_bh`
// (src/repro/kernels/decode_attention.py:68) and, on the model path, the
// reference's XLA `decode_sdpa`: for every (batch b, query head i)
//   out[b, i] = softmax(q[b, i] . k[b, t, i / g] * scale, t < lengths[b]) @ v
// with g = H / Hkv, the online softmax (m, l, acc) kept in f32 and the
// output written in q's dtype.  Like the TPU kernel (and unlike
// `decode_sdpa`) the softmax weights stay f32 in the P.V product.
//
// Bound: bytes.  The work is 4 * H * L * D operations against
// 2 * L * Hkv * D cache elements read, about 1 operation per byte, far
// below the card's ~295 operations per byte.  At qwen's serving shape
// (B 1, Hkv = H = 16, D 64, bf16 cache) L valid positions read 4096 * L
// bytes: 0.16 us at L 128, 40 us at the full 32,768-position context.
// Reading those bytes at the card's rate needs every SM streaming, with
// ~20-30 KB in flight on each, whatever the batch.  The design:
//  - a cluster of S blocks (the wrapper's `decode_plan`, S = 8) serves one
//    (batch, KV head, group of up to 8 query heads): the grid is
//    B * Hkv * ceil(g / 8) clusters, 128 blocks at B 1 x Hkv 16.  Each
//    block reads lengths[b] and takes every S-th tile of the valid prefix
//    [0, len), tiles of `tile` positions dealt round robin from its rank;
//    a short len leaves some blocks with no tile.  The host plans from
//    shapes alone and never reads the lengths;
//  - each block (8 warps) streams its tiles through a ring of `stages` K/V
//    stages in shared memory (two of ~32 KB: 128 positions at D 64 bf16),
//    each filled by two TMA loads (K and V boxes (D, 1, tile, 1) of
//    (D, Hkv, T, B) maps read in place through the cache's strides; rows
//    past T fill zeros) completing on a `full` mbarrier; each warp arrives
//    on the stage's `empty` mbarrier when done and thread 0 refills it;
//  - every warp scores positions: a position's row is split over LP lanes
//    (LP = D / 8 rounded up to a power of two, eight channels a lane), so a
//    warp scores 32 / LP positions at once, PPS of them a lane (4 at G 1
//    and 4, 2 at G 2, 1 at G 8) for independent work, with the query rows
//    in registers.  Each group of LP lanes keeps its own online softmax
//    (m, l, acc) for the G query heads, in base 2 (the scale carries
//    log2 e), and rescales only when its running max moves.  The butterfly
//    sums over a group run level by level, all PPS x G of a level in
//    flight.  At the models' head dims (D >= 64) no step leaves a thread
//    idle at g = 1 (a small D gives a warp more positions a step than a
//    short tile holds).  The tensor cores are not used: at g <= 8 Q.K^T is
//    a matrix-vector product per KV head;
//  - where the shape came from (design probes on the card; the chosen
//    shape's times are tools/decode_turns.py's): with the math taken out,
//    the ring alone streamed a long cache near the card's rate, so the
//    math, latency-bound at four warps an SM, was what held it; eight
//    warps a block, more positions per lane group and level-by-level
//    butterflies took most of that back.  Clusters of 16 (non-portable)
//    were faster on long caches only and slower at the serving lengths, so
//    S stays 8;
//  - the partials merge in a fixed order: the lane groups of a warp by xor
//    shuffles, the warps of a block in warp order through shared memory
//    (into the ring, which is free by then), then the blocks of the cluster
//    through distributed shared memory: each block leaves (m, l, acc) in
//    its shared memory, the cluster barrier publishes it, and each block
//    reduces a 1/S slice of the (head, channel) outputs, reading every
//    peer's partial (mapa, ld.shared::cluster) in rank order 0..S-1.  A
//    second cluster barrier keeps every block resident until its peers
//    have read it.  An empty split carries m = -1e30, l = 0, acc = 0, so
//    its weight exp2(m - M) is exactly 0 or multiplies zeros; a row whose
//    splits are all empty (length 0) gets zeros.  Where the caller asks
//    for it (a non-null `lse`), block 0 of the cluster also writes each
//    row's log-sum-exp from that merge's (M, l): M ln 2 + ln l in natural
//    log (the scores carry log2 e), -inf for a row of length 0.  A cache
//    cut into slot blocks is then attended block by block and the
//    blocks' outputs merged by their lse; the null case does no more work
//    than before.
// Why a cluster and not a second pass or atomics: the decode step is
// host-bound, so one launch per call matters more than anything a second
// kernel could overlap; nothing is kept between calls (no workspace, no
// zeroed counters); and the sum runs in one order, so every call gives the
// same bits.
//
// Contract (checked by the Python wrapper): q and out are contiguous
// (B, H, D) of one dtype; k and v are (B, T, Hkv, D) of one dtype with a
// contiguous last axis and strides that are multiples of 8 elements;
// lengths is int32 (B,) on the device; D is a multiple of 8 up to 256;
// every pointer is 16-byte aligned; the plan is `decode_plan`'s; `lse`
// is null or f32 (B, H), contiguous.  A length
// is clamped to [0, T]; a row of length 0 gets zeros.

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 8;     // query heads per cluster
constexpr int kMaxD = 256;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kMaxSmem = 232448; // 227 KB, a block's most
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Byte offsets in dynamic shared memory past its first 128-byte boundary,
// as `decode_plan` computes them: the ring (stages x (K, V) tiles), which
// later holds the warps' partials; the block's partial (m[G], l[G],
// acc[G][D], f32), which its peers read; the full and empty mbarriers.
struct Layout {
  long long part, bars, total;
};

__host__ __device__ inline Layout layout(int tile, int stages, int G, int D, int esize) {
  const long long ring = static_cast<long long>(stages) * 2 * tile * D * esize;
  const long long warps = 4LL * kWarps * G * (D + 2);
  Layout L;
  L.part = ((ring > warps ? ring : warps) + 15) / 16 * 16;
  L.bars = (L.part + 4LL * G * (D + 2) + 7) / 8 * 8;
  L.total = L.bars + 16LL * stages + 128;  // + alignment slack
  return L;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster; what was written to shared
// memory before it is visible to the peers after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The f32 at shared address `addr` of the cluster's block `rank`.
__device__ __forceinline__ float ld_peer(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float x;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(x) : "r"(remote) : "memory");
  return x;
}

// A lane's eight channels of a row: VPL vectors of V elements, vector
// c + k * LP for k < VPL, so the lanes of a group read consecutive 16-byte
// vectors; channels past D read as zeros.
template <typename T>
__device__ __forceinline__ void load_lane(const T* row, int c, int LP, int nvec, float (&x)[8]) {
  constexpr int V = Vec<T>::n, VPL = 8 / V;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int vi = c + k * LP;
    if (vi < nvec) {
      load_vec(row + vi * V, x + k * V);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[k * V + e] = 0.f;
    }
  }
}

// The K and V boxes of `tile` positions from t0 of KV head h, batch b into
// one stage (K at dst, V after it), completing on the stage's barrier.
__device__ __forceinline__ void load_tile(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                          uint32_t dst, uint32_t bar, uint32_t kv_bytes, int h,
                                          int t0, int b) {
  mbar_expect_tx(bar, 2u * kv_bytes);
  tma_load4(dst, kmap, bar, 0, h, t0, b);
  tma_load4(dst + kv_bytes, vmap, bar, 0, h, t0, b);
}

template <typename TQ, typename TKV, int G>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const void* q_,
                        const int* __restrict__ lengths, void* out_, float* lse, int H,
                        int Hkv, int T, int D, int ngroups, int tile, int stages,
                        float qscale) {
  constexpr int V = Vec<TKV>::n, VPL = 8 / V;
  // positions per lane group per step: independent work for the lane,
  // within the registers of G heads' queries and accumulators
  constexpr int PPS = G == 8 ? 1 : G == 2 ? 2 : 4;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base_u32 = (raw_u32 + 127) & ~127u;
  unsigned char* base = smem_raw + (base_u32 - raw_u32);
  const Layout lay = layout(tile, stages, G, D, sizeof(TKV));
  const uint32_t bars = base_u32 + static_cast<uint32_t>(lay.bars);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };

  const int S = static_cast<int>(cluster_blocks());
  const int rank = static_cast<int>(cluster_rank());
  const int cl = blockIdx.x / S;
  const int grp = cl % ngroups, bh = cl / ngroups;
  const int b = bh / Hkv, h = bh % Hkv;
  const int g = H / Hkv;
  const int j0 = grp * G;
  const int gcnt = min(G, g - j0);
  const int len = min(max(lengths[b], 0), T);
  const int ntiles = (len + tile - 1) / tile;
  const int mine = ntiles > rank ? (ntiles - rank + S - 1) / S : 0;  // tiles rank, rank + S, ...

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int LP = 1;
  while (LP * 8 < D) LP <<= 1;
  const int nsub = 32 / LP;                  // lane groups (positions at once) per warp
  const int sub = lane / LP, c = lane & (LP - 1);
  const int nvec = D / V;
  const uint32_t kv_bytes = static_cast<uint32_t>(tile) * D * sizeof(TKV);

  auto issue = [&](int i) {  // tile i of this block's into stage i % stages
    const int s = i % stages;
    load_tile(&kmap, &vmap, base_u32 + 2u * kv_bytes * s, full(s), kv_bytes, h,
              (rank + i * S) * tile, b);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(stages, mine); ++i) issue(i);

  // This lane's channels of the group's query rows, pre-scaled by
  // scale * log2(e); heads past the group read as zeros.
  const size_t row0 = (static_cast<size_t>(b) * H + static_cast<size_t>(h) * g + j0) * D;
  const TQ* q = static_cast<const TQ*>(q_) + row0;
  float qr[G][8], acc[G][8], m[G], l[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int vi = c + k * LP;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        qr[j][k * V + e] = j < gcnt && vi < nvec ? to_float(q[j * D + vi * V + e]) * qscale : 0.f;
        acc[j][k * V + e] = 0.f;
      }
    }
  }

  for (int i = 0; i < mine; ++i) {
    const int s = i % stages;
    const int nvalid = min(tile, len - (rank + i * S) * tile);
    const TKV* ks = reinterpret_cast<const TKV*>(base + 2u * kv_bytes * s);
    const TKV* vs = ks + tile * D;
    mbar_wait(full(s), (i / stages) & 1);
    for (int p0 = warp * nsub * PPS; p0 < nvalid; p0 += kWarps * nsub * PPS) {
      float sc[PPS][G];
      bool ok[PPS];
#pragma unroll
      for (int u = 0; u < PPS; ++u) {
        const int t = p0 + u * nsub + sub;
        ok[u] = t < nvalid;
        float kr[8];
        load_lane(ks + (ok[u] ? t : 0) * D, c, LP, nvec, kr);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) a = fmaf(qr[j][e], kr[e], a);
          sc[u][j] = a;
        }
      }
      // The LP lanes of a group sum their channels, level by level with
      // the PPS x G sums of a level in flight together; every lane of the
      // group ends with the same bits (each butterfly step adds the same
      // pair).
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
        if (o < LP)
#pragma unroll
          for (int u = 0; u < PPS; ++u)
#pragma unroll
            for (int j = 0; j < G; ++j) sc[u][j] += __shfl_xor_sync(0xffffffffu, sc[u][j], o);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float mx = kNegInf;
#pragma unroll
        for (int u = 0; u < PPS; ++u)
          if (ok[u]) mx = fmaxf(mx, sc[u][j]);
        if (mx > m[j]) {  // a new running max: rescale what was summed
          const float corr = exp2f(m[j] - mx);
          m[j] = mx;
          l[j] *= corr;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[j][e] *= corr;
        }
      }
#pragma unroll
      for (int u = 0; u < PPS; ++u) {
        if (ok[u]) {
          float vr[8];
          load_lane(vs + (p0 + u * nsub + sub) * D, c, LP, nvec, vr);
#pragma unroll
          for (int j = 0; j < G; ++j) {
            const float p = exp2f(sc[u][j] - m[j]);
            l[j] += p;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[j][e] = fmaf(p, vr[e], acc[j][e]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    if (tid == 0 && i + stages < mine) {
      mbar_wait(empty(s), (i / stages) & 1);  // every warp is done with the stage
      issue(i + stages);
    }
    __syncwarp();
  }

  // The warp's lane groups, merged by xor shuffles over the groups (lanes
  // c, c + LP, ...); each lane then holds the warp's partial for its
  // channels.
#pragma unroll
  for (int j = 0; j < G; ++j) {
    float M = m[j];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
      if (o >= LP) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    const float w = exp2f(m[j] - M);
    l[j] *= w;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] *= w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
      if (o >= LP) {
        l[j] += __shfl_xor_sync(0xffffffffu, l[j], o);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], o);
      }
    m[j] = M;
  }
  __syncthreads();  // every warp is done with the ring: it takes the warps' partials

  float* wm = reinterpret_cast<float*>(base);  // [kWarps][G]
  float* wl = wm + kWarps * G;                 // [kWarps][G]
  float* wacc = wl + kWarps * G;               // [kWarps][G][D]
  if (sub == 0) {
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int vi = c + k * LP;
        if (vi < nvec)
#pragma unroll
          for (int e = 0; e < V; ++e) wacc[(warp * G + j) * D + vi * V + e] = acc[j][k * V + e];
      }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      wm[warp * G + j] = m[j];
      wl[warp * G + j] = l[j];
    }
  }
  __syncthreads();

  // The block's partial, the warps merged in warp order.
  float* pm = reinterpret_cast<float*>(base + lay.part);  // [G]
  float* pl = pm + G;                                      // [G]
  float* pacc = pl + G;                                    // [G][D]
  for (int e = tid; e < G * D; e += kThreads) {
    const int j = e / D;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * G + j]);
    float a = 0.f, ls = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float sw = exp2f(wm[w * G + j] - M);
      ls = fmaf(wl[w * G + j], sw, ls);
      a = fmaf(wacc[w * G * D + e], sw, a);
    }
    pacc[e] = a;
    if (e == j * D) {
      pm[j] = M;
      pl[j] = ls;
    }
  }
  cluster_sync();  // every block's partial is written and visible

  // This block's slice of the (head, channel) outputs, the cluster's
  // partials merged in rank order: each peer's (m, l) per head is read once
  // into the ring (free again), its weight exp2(m - M) computed once, then
  // each output reads the S partial accumulators, all loads in flight.
  const int E = gcnt * D;
  const int chunk = (E + S - 1) / S;
  const int e0 = rank * chunk, e1 = min(E, e0 + chunk);
  const uint32_t part = base_u32 + static_cast<uint32_t>(lay.part);
  float* pw = reinterpret_cast<float*>(base);  // [kMaxCluster][G] peer weights
  float* pinv = pw + kMaxCluster * G;          // [G] 1 / l, or 0 for an empty row
  if (tid < S * G) {
    const int r = tid / G, j = tid - r * G;
    pw[tid] = ld_peer(part + 4u * j, r);
    pw[kMaxCluster * G + G + tid] = ld_peer(part + 4u * (G + j), r);
  }
  __syncthreads();
  if (tid < G) {
    float M = kNegInf, ls = 0.f;
    for (int r = 0; r < S; ++r) M = fmaxf(M, pw[r * G + tid]);
    for (int r = 0; r < S; ++r) {
      const float w = exp2f(pw[r * G + tid] - M);
      ls = fmaf(pw[kMaxCluster * G + G + r * G + tid], w, ls);
      pw[r * G + tid] = w;
    }
    pinv[tid] = ls > 0.f ? 1.f / ls : 0.f;
    if (lse != nullptr && rank == 0 && tid < gcnt)
      lse[row0 / D + tid] =
          ls > 0.f ? fmaf(M, kLn2, logf(ls)) : -__int_as_float(0x7f800000);
  }
  __syncthreads();
  TQ* out = static_cast<TQ*>(out_) + row0;
  for (int e = e0 + tid; e < e1; e += kThreads) {
    const int j = e / D;
    float x[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < S) x[r] = ld_peer(part + 4u * (2 * G + e), r);
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < S) a = fmaf(x[r], pw[r * G + j], a);
    out[e] = from_float<TQ>(a * pinv[j]);
  }
  cluster_sync();  // no block leaves while a peer may still read it
}

using Kernel = void (*)(CUtensorMap, CUtensorMap, const void*, const int*, void*, float*, int,
                        int, int, int, int, int, int, float);

// The kernel for (TQ, TKV, G), allowed the most dynamic shared memory
// once; null if that fails.
template <typename TQ, typename TKV, int G>
Kernel ready() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<TQ, TKV, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return attr == cudaSuccess ? &decode_attention_kernel<TQ, TKV, G> : nullptr;
}

template <typename TQ, typename TKV>
Kernel pick_group(int G) {
  switch (G) {
    case 1: return ready<TQ, TKV, 1>();
    case 2: return ready<TQ, TKV, 2>();
    case 4: return ready<TQ, TKV, 4>();
    case 8: return ready<TQ, TKV, 8>();
  }
  return nullptr;
}

Kernel pick(int q_dtype, int kv_dtype, int G) {
  if (q_dtype == kBF16 && kv_dtype == kBF16) return pick_group<__nv_bfloat16, __nv_bfloat16>(G);
  if (q_dtype == kF32 && kv_dtype == kBF16) return pick_group<float, __nv_bfloat16>(G);
  if (q_dtype == kBF16 && kv_dtype == kF32) return pick_group<__nv_bfloat16, float>(G);
  if (q_dtype == kF32 && kv_dtype == kF32) return pick_group<float, float>(G);
  return nullptr;
}

// Query heads per cluster: g rounded up to a power of two, at most 8.
int group_of(int g) {
  int G = 1;
  while (G < g && G < kMaxGroup) G <<= 1;
  return G;
}

// The kernel for a plan, or null where the plan is not `decode_plan`'s
// layout for these shapes.
Kernel planned(int H, int Hkv, int D, int q_dtype, int kv_dtype, int tile, int stages,
               int cluster, int smem) {
  if (Hkv <= 0 || H % Hkv != 0 || D <= 0 || D % 8 != 0 || D > kMaxD || tile < 8 ||
      tile > 256 || (tile & (tile - 1)) != 0 || stages < 1 || stages > 8 || cluster < 1 ||
      cluster > kMaxCluster)
    return nullptr;
  const int G = group_of(H / Hkv);
  const int esize = kv_dtype == kF32 ? 4 : 2;
  if (layout(tile, stages, G, D, esize).total != smem || smem > kMaxSmem) return nullptr;
  return pick(q_dtype, kv_dtype, G);
}

cudaLaunchConfig_t config(int grid, int smem, int cluster, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Clusters of the plan that the card can hold at once (0: the cluster
// cannot be scheduled), or minus a CUDA error code.
extern "C" int repro_decode_attention_clusters(int H, int Hkv, int D, int q_dtype, int kv_dtype,
                                               int tile, int stages, int cluster, int smem) {
  const Kernel kern = planned(H, Hkv, D, q_dtype, kv_dtype, tile, stages, cluster, smem);
  if (kern == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(cluster, smem, cluster, nullptr, &attr);
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kern), &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths, void* out, void* lse, int B,
    int H,
    int Hkv, int T, int D, long long ksb, long long kst, long long ksh, long long vsb,
    long long vst, long long vsh, float scale, int q_dtype, int kv_dtype, int tile, int stages,
    int cluster, int grid, int smem, void* stream) {
  const Kernel kern = planned(H, Hkv, D, q_dtype, kv_dtype, tile, stages, cluster, smem);
  if (kern == nullptr || B <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int g = H / Hkv;
  const int G = group_of(g);
  const int ngroups = (g + G - 1) / G;
  if (static_cast<long long>(B) * Hkv * ngroups * cluster != grid)
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType type =
      kv_dtype == kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int esize = kv_dtype == kF32 ? 4 : 2;
  CUtensorMap kmap, vmap;
  if (!encode_heads_map(&kmap, type, esize, k, D, Hkv, T, B, ksh, kst, ksb, D, 1, tile,
                        CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_heads_map(&vmap, type, esize, v, D, Hkv, T, B, vsh, vst, vsb, D, 1, tile,
                        CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(grid, smem, cluster, static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, kmap, vmap, q,
                                           static_cast<const int*>(lengths), out,
                                           static_cast<float*>(lse), H, Hkv, T, D, ngroups, tile,
                                           stages, scale * kLog2e);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}
