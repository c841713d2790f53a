// Flash attention (forward, full sequence) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_bh`
// (src/repro/kernels/flash_attention.py:79) behind `ops.flash_attention`:
// for every (batch b, query position s, query head h)
//   out[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h / g] * scale, mask) @ v
// with g = H / Hkv, scale = 1 / sqrt(D) and mask = (t <= s if causal) and
// (t > s - window if a window is set).  The online softmax (m, l, acc) is
// kept in f32, the softmax weights stay f32 in the P.V product, as in the
// TPU kernel, and the output is written in the inputs' dtype.
//
// Bound: operations.  The work is 4 * S * T * D multiply-adds per query
// head (about half of that under a causal mask) against 4 * S * H * D
// elements moved, so at S = 4096, D = 64 it is ~1000 operations per byte,
// far above the card's ~295 in bf16.  What the design does about the work:
//  - one block per (batch, KV head, group of up to 16 of that head's query
//    heads, query tile); a tile is 64 rows, each row a (query position,
//    query head) pair, so the g query heads of one KV head share every K/V
//    tile the block loads, and nothing is repeated per head as the TPU
//    path does with `jnp.repeat`;
//  - q, k and v are read in place in their (B, S, H, D) / (B, T, Hkv, D)
//    layouts through their strides, 16 bytes per load, and K/V tiles of 64
//    positions are staged in shared memory;
//  - bf16 runs both products on the tensor cores (mma.sync m16n8k16, f32
//    accumulation; flash_attention_mma_kernel): each warp keeps its 16 rows'
//    scores, softmax statistics and output in registers, and the score
//    fragments of a 16-key step are reused in place as the A operand of
//    P.V.  To keep the weights f32 there, each weight is split into three
//    bf16 parts whose sum is exactly the f32 value, so P.V costs three
//    tensor-core products instead of one.  K/V tiles are double-buffered
//    with cp.async, and V is read row-major through ldmatrix.trans;
//  - f32 runs both products on the f32 FMA units (flash_attention_kernel):
//    256 threads each compute a 4 x 4 block of scores from 16-byte shared
//    loads and a 4 x (4 per 64 columns) block of the output; the weights
//    pass through shared memory;
//  - under a causal mask the KV walk of a tile stops at its last row's
//    diagonal, and under a sliding window it starts at the first tile that
//    its first row can see, so a window costs O(S * window); the bf16
//    kernel computes the mask only on the tiles that cross the diagonal,
//    the window's edge or the end of T, and its softmax in base 2;
//  - the tail tiles of S and T are masked, so any S and T are taken (the
//    TPU kernel asks S % 128 == 0); tiles are issued heaviest first along
//    the sequence so that the causal tail does not idle the card.
// Neither version uses TMA or wgmma yet.
//
// Contract (checked by the Python wrapper): q, k, v of one dtype (f32 or
// bf16) with a contiguous last axis, the other strides multiples of 8
// elements and 16-byte aligned pointers; D a multiple of 8 up to 128 (the
// wrapper pads other head dims; the bf16 kernel pads to 16 in shared
// memory); H % Hkv == 0; 1 <= S <= T; window >= 1 or 0 for none; out
// contiguous (B, S, H, D).

#include <algorithm>
#include <cstdint>

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
// bf16: both products on the tensor cores (mma.sync m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps, 16 rows each

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// B fragments of four 8 x 8 bf16 tiles, transposed on the way: lane l names
// row l % 8 of tile l / 8 (16 bytes in shared memory).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16-byte asynchronous copy to shared memory; zero-fills when !full.
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           bool full) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Split two f32 weights into three bf16 pairs whose sum is exactly the f32
// pair (8 + 8 + 8 significant bits; each residual is exact in f32), so the
// three bf16 products with the value tile give the f32-weight product.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat16 xh = __float2bfloat16_rn(x), yh = __float2bfloat16_rn(y);
  const float xr = x - __bfloat162float(xh), yr = y - __bfloat162float(yh);
  const __nv_bfloat16 xm = __float2bfloat16_rn(xr), ym = __float2bfloat16_rn(yr);
  hi = pack2(xh, yh);
  mid = pack2(xm, ym);
  lo = pack2(__float2bfloat16_rn(xr - __bfloat162float(xm)),
             __float2bfloat16_rn(yr - __bfloat162float(ym)));
}

// Same block map, masks and KV bounds as flash_attention_kernel.  Warp w owns
// rows 16 w .. 16 w + 15; lane (gid = lane / 4, tig = lane % 4) holds rows
// 16 w + gid and + 8 in the mma fragment layout.  The scores and weights
// never leave registers: the score accumulators of one 16-key step are the
// A fragment of the P.V product.  K/V tiles are double-buffered: the copy
// of the next tile (cp.async) runs while the block computes on this one.
template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out, int S, int Tk, int H,
                           int Hkv, int D, int G, int ngroups, long long qsb,
                           long long qss, long long qsh, long long ksb,
                           long long kst, long long ksh, long long vsb,
                           long long vst, long long vsh, float scale, int causal,
                           int window) {
  constexpr int NK = DMAX / 16;  // 16-wide steps over the head dim
  constexpr int NT = DMAX / 8;   // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DP = (D + 15) / 16 * 16;  // head dim padded with zeros to the mma depth
  const int ldk = DP + 8;             // padded rows: fragment loads hit distinct banks
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (kBM, ldk)
  __nv_bfloat16* kbuf = qs + kBM * ldk;                             // 2 x (kBN, ldk)
  __nv_bfloat16* vbuf = kbuf + 2 * kBN * ldk;                       // 2 x (kBN, ldk)
  const int nk = DP / 16, np = (D / 8 + 1) / 2;  // 16-column output pairs

  const int g = H / Hkv;
  const int P = kBM / G;
  const int hg = blockIdx.x % ngroups;
  const int bh = blockIdx.x / ngroups;
  const int b = bh / Hkv, kvh = bh % Hkv;
  const int j0 = hg * G;
  const int gcnt = min(G, g - j0);
  const int p0 = (gridDim.y - 1 - blockIdx.y) * P;
  const int p_last = min(S, p0 + P) - 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int cpr = DP / 8;  // 16-byte chunks per padded row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  int lo = 0, hi = Tk;
  if (causal) hi = min(Tk, p_last + 1);
  if (window > 0) lo = max(0, p0 - window + 1);
  const int t_begin = (lo / kBN) * kBN;
  const int n_kv = (hi - t_begin + kBN - 1) / kBN;
  const __nv_bfloat16* kb = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kvh * vsh;
  auto issue = [&](int it) {  // K/V tile it into buffer it % 2; zeros past D and T
    __nv_bfloat16* kd = kbuf + (it & 1) * kBN * ldk;
    __nv_bfloat16* vd = vbuf + (it & 1) * kBN * ldk;
    const int t0 = t_begin + it * kBN;
    for (int c = tid; c < kBN * cpr; c += kMmaThreads) {
      const int n = c / cpr, dc = (c - n * cpr) * 8, t = t0 + n;
      const bool full = dc < D && t < Tk;
      cp_async16(kd + n * ldk + dc, full ? kb + t * kst + dc : kb, full);
      cp_async16(vd + n * ldk + dc, full ? vb + t * vst + dc : vb, full);
    }
    cp_async_commit();
  };
  if (n_kv > 0) issue(0);

  // Query tile into shared memory, then into registers as A fragments.
  for (int c = tid; c < kBM * cpr; c += kMmaThreads) {
    const int r = c / cpr, dc = (c - r * cpr) * 8;
    const int pos = p0 + r / G, j = r % G;
    uint4 val = zero;
    if (dc < D && r < P * G && j < gcnt && pos < S)
      val = *reinterpret_cast<const uint4*>(q + b * qsb + pos * qss +
                                            (kvh * g + j0 + j) * qsh + dc);
    *reinterpret_cast<uint4*>(qs + r * ldk + dc) = val;
  }
  __syncthreads();
  const int r0 = warp * 16 + gid, r1 = r0 + 8;
  uint32_t qf[NK][4];
#pragma unroll
  for (int kc = 0; kc < NK; ++kc) {
    if (kc < nk) {
      const __nv_bfloat16* base = qs + kc * 16 + tig * 2;
      qf[kc][0] = ld32(base + r0 * ldk);
      qf[kc][1] = ld32(base + r1 * ldk);
      qf[kc][2] = ld32(base + r0 * ldk + 8);
      qf[kc][3] = ld32(base + r1 * ldk + 8);
    }
  }
  const int qpos0 = p0 + r0 / G, qpos1 = p0 + r1 / G;
  const float scale_log2 = scale * 1.4426950408889634f;

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[nt][x] = 0.f;

  for (int it = 0; it < n_kv; ++it) {
    const int t0 = t_begin + it * kBN;
    if (it + 1 < n_kv) {
      issue(it + 1);
      cp_async_wait<1>();  // this thread's copies of tile it have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // ... and every thread's
    const __nv_bfloat16* ks = kbuf + (it & 1) * kBN * ldk;
    const __nv_bfloat16* vs = vbuf + (it & 1) * kBN * ldk;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) s[j][x] = 0.f;
#pragma unroll
      for (int kc = 0; kc < NK; ++kc) {
        if (kc < nk) {
          const __nv_bfloat16* kr = ks + (j * 8 + gid) * ldk + kc * 16 + tig * 2;
          mma_bf16(s[j], qf[kc], ld32(kr), ld32(kr + 8));
        }
      }
    }

    // Online softmax in base 2 (scores pre-multiplied by log2(e)); the 4
    // lanes of a quad share a row.  Only the tiles that cross the diagonal,
    // the window's edge or the end of T are masked: a masked score becomes
    // kNegInf, whose weight is 0 once the row has seen a visible key, and
    // whose weight before that is cancelled by the factor exp2(kNegInf - m)
    // = 0 the row's first visible key applies (as in the TPU kernel).
    const bool edge = t0 + kBN > Tk || (causal && t0 + kBN - 1 > p0) ||
                      (window > 0 && t0 <= p_last - window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] *= scale_log2;
        s[j][2 + e] *= scale_log2;
        if (edge) {
          const int t = t0 + j * 8 + tig * 2 + e;
          if (!(t < Tk && (!causal || t <= qpos0) && (window <= 0 || t > qpos0 - window)))
            s[j][e] = kNegInf;
          if (!(t < Tk && (!causal || t <= qpos1) && (window <= 0 || t > qpos1 - window)))
            s[j][2 + e] = kNegInf;
        }
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2f(s[j][e] - mn0);
        s[j][2 + e] = exp2f(s[j][2 + e] - mn1);
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][0] *= corr0;
      o[nt][1] *= corr0;
      o[nt][2] *= corr1;
      o[nt][3] *= corr1;
    }

    // P.V over four 16-key steps, the weights in three bf16 parts.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t ah[4], am[4], al[4];
      split3(s[2 * kc][0], s[2 * kc][1], ah[0], am[0], al[0]);
      split3(s[2 * kc][2], s[2 * kc][3], ah[1], am[1], al[1]);
      split3(s[2 * kc + 1][0], s[2 * kc + 1][1], ah[2], am[2], al[2]);
      split3(s[2 * kc + 1][2], s[2 * kc + 1][3], ah[3], am[3], al[3]);
      // lane l names key kc*16 + 8*(tile & 1) + l % 8 of tile l / 8;
      // tiles 0/1 give b0/b1 of column tile 2 p, tiles 2/3 of 2 p + 1
      const __nv_bfloat16* vr =
          vs + (kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldk + (lane >> 4) * 8;
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        if (p < np) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vr + p * 16);
          mma_bf16(o[2 * p], ah, bv[0], bv[1]);
          mma_bf16(o[2 * p], am, bv[0], bv[1]);
          mma_bf16(o[2 * p], al, bv[0], bv[1]);
          mma_bf16(o[2 * p + 1], ah, bv[2], bv[3]);
          mma_bf16(o[2 * p + 1], am, bv[2], bv[3]);
          mma_bf16(o[2 * p + 1], al, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  const int rows[2] = {r0, r1};
  const int qp[2] = {qpos0, qpos1};
  const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rows[h], j = r % G;
    if (r >= P * G || j >= gcnt || qp[h] >= S) continue;
    __nv_bfloat16* orow =
        out + ((static_cast<size_t>(b) * S + qp[h]) * H + kvh * g + j0 + j) * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt < D / 8)
        *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + tig * 2) =
            __floats2bfloat162_rn(o[nt][2 * h] * inv[h], o[nt][2 * h + 1] * inv[h]);
    }
  }
}

// One block per (batch, KV head, head group) and query tile; the caller
// picks the kernel and sizes its threads and shared memory.
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
    long long vsh, float scale, int causal, int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || T < S || Hkv <= 0 || H % Hkv != 0 || D <= 0 ||
      D % 8 != 0 || D > 128 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FA_ARGS                                                               \
  q, k, v, out, B, S, T, H, Hkv, D, qsb, qss, qsh, ksb, kst, ksh, vsb, vst, vsh, scale, \
      causal, window, s
  if (dtype == kBF16) {
    const int DP = (D + 15) / 16 * 16;
    const size_t smem = sizeof(__nv_bfloat16) * (kBM + 4 * kBN) * (DP + 8);
    return launch<__nv_bfloat16>(D <= 64 ? &flash_attention_mma_kernel<64>
                                         : &flash_attention_mma_kernel<128>,
                                 kMmaThreads, smem, REPRO_FA_ARGS);
  }
  if (dtype == kF32) {
    const int ld = D + 4;
    const size_t smem =
        sizeof(float) * (kBM * ld + std::max(kBN * ld, kBM * kLdP) + kBN * D);
    return launch<float>(D <= 64 ? &flash_attention_kernel<64> : &flash_attention_kernel<128>,
                         kThreads, smem, REPRO_FA_ARGS);
  }
#undef REPRO_FA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
