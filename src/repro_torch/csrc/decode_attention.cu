// Decode attention (flash-decode, one query token per head) for Hopper
// (sm_90a).
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
// below the card's ~295 operations per byte.  On the serving path (B = 1,
// Hkv = H = 16, D = 64, bf16 cache) L valid positions read 4096 * L bytes:
// 0.5 MB at L = 128, about 0.16 us at 3.35 TB/s, so here too the launch
// latency dominates.  What the design does about the bytes:
//  - the cache is read in place in its (B, T, Hkv, D) layout through its
//    strides; nothing is repeated per query head or padded to 128 lanes:
//    one block loads a KV head once for the (up to 8) query heads of its
//    group that it serves;
//  - only the valid prefix [0, lengths[b]) is read, in tiles of 32
//    positions staged through shared memory with 16-byte vector loads;
//  - the scores, the online-softmax statistics and the accumulator never
//    leave the chip.
// One block per (b, kv head, group of 8 query heads) fills only B * Hkv of
// the 132 SMs at small batch (16 at the serving shape); splitting the KV
// walk across blocks with a combine pass is the next design step.
//
// Contract (checked by the Python wrapper): q and out are contiguous
// (B, H, D) of one dtype; k and v are (B, T, Hkv, D) of one dtype with a
// contiguous last axis and strides that are multiples of 8 elements;
// lengths is int32 (B,) on the device; D is a multiple of 8 up to 256;
// every pointer is 16-byte aligned.  A length is clamped to [0, T]; a row
// of length 0 gets zeros.

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kTile = 32;       // cache positions per tile (one per lane)
constexpr int kGroup = 8;       // query heads per block
constexpr int kMaxD = 256;
constexpr int kAcc = kGroup * kMaxD / kThreads;  // accumulators per thread
constexpr float kNegInf = -1e30f;

static_assert(kTile == 32, "the softmax statistics map one position per lane");

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const int* __restrict__ lengths, TQ* __restrict__ out,
                        int H, int Hkv, int T, int D, long long ksb,
                        long long kst, long long ksh, long long vsb,
                        long long vst, long long vsh, float scale) {
  extern __shared__ float smem[];
  constexpr int V = Vec<TKV>::n;
  const int g = H / Hkv;
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int j0 = blockIdx.y * kGroup;
  const int gcnt = min(kGroup, g - j0);
  const int ld = D + 1;  // padded rows: column reads across rows hit distinct banks
  float* qs = smem;                    // (kGroup, D), pre-scaled query rows
  float* ks = qs + kGroup * D;         // (kTile, D + 1)
  float* vs = ks + kTile * ld;         // (kTile, D + 1)
  float* ps = vs + kTile * ld;         // (kGroup, kTile) scores, then weights
  float* m_s = ps + kGroup * kTile;    // running max per query head
  float* l_s = m_s + kGroup;           // running denominator
  float* c_s = l_s + kGroup;           // this tile's rescale factor
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int len = min(max(lengths[b], 0), T);
  const size_t q_row = static_cast<size_t>(b) * H + static_cast<size_t>(h) * g + j0;
  const TQ* qb = q + q_row * D;
  for (int i = tid; i < gcnt * D; i += kThreads) qs[i] = to_float(qb[i]) * scale;
  if (tid < kGroup) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

  const TKV* kb = k + b * ksb + h * ksh;
  const TKV* vb = v + b * vsb + h * vsh;
  const int cpr = D / V;  // vectors per cache row

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int tn = min(kTile, len - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < tn * cpr; c += kThreads) {
      const int t = c / cpr, dc = (c - t * cpr) * V;
      float e[V];
      load_vec(kb + (t0 + t) * kst + dc, e);
#pragma unroll
      for (int j = 0; j < V; ++j) ks[t * ld + dc + j] = e[j];
      load_vec(vb + (t0 + t) * vst + dc, e);
#pragma unroll
      for (int j = 0; j < V; ++j) vs[t * ld + dc + j] = e[j];
    }
    __syncthreads();

    // Scores: one (query head, position) pair per thread.
    for (int i = tid; i < gcnt * kTile; i += kThreads) {
      const int j = i / kTile, t = i - j * kTile;
      float s = kNegInf;
      if (t < tn) {
        const float* qr = qs + j * D;
        const float* kr = ks + t * ld;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        s = a;
      }
      ps[j * kTile + t] = s;
    }
    __syncthreads();

    // Online softmax: one warp per query head, one position per lane.
    for (int j = warp; j < gcnt; j += kThreads / 32) {
      const float s = ps[j * kTile + lane];
      const float m_old = m_s[j];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = lane < tn ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      ps[j * kTile + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[j] = corr;
        l_s[j] = l_s[j] * corr + psum;
        m_s[j] = m_new;
      }
    }
    __syncthreads();

    // P.V: each thread owns fixed (query head, channel) accumulators.
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int idx = tid + a * kThreads;
      if (idx < gcnt * D) {
        const int j = idx / D, d = idx - j * D;
        const float* pr = ps + j * kTile;
        float sum = 0.f;
        for (int t = 0; t < tn; ++t) sum = fmaf(pr[t], vs[t * ld + d], sum);
        acc[a] = acc[a] * c_s[j] + sum;
      }
    }
  }
  __syncthreads();

  TQ* ob = out + q_row * D;
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int idx = tid + a * kThreads;
    if (idx < gcnt * D) {
      const int j = idx / D;
      ob[idx] = from_float<TQ>(acc[a] / fmaxf(l_s[j], 1e-30f));
    }
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int H, int Hkv, int T, int D, long long ksb,
           long long kst, long long ksh, long long vsb, long long vst,
           long long vsh, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kGroup * D + 2 * kTile * (D + 1) + kGroup * kTile + 3 * kGroup);
  auto kern = decode_attention_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int g = H / Hkv;
  const dim3 grid(B * Hkv, (g + kGroup - 1) / kGroup);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(lengths),
      static_cast<TQ*>(out), H, Hkv, T, D, ksb, kst, ksh, vsb, vst, vsh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths, void* out,
    int B, int H, int Hkv, int T, int D, long long ksb, long long kst,
    long long ksh, long long vsb, long long vst, long long vsh, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || D % 8 != 0 || D <= 0 ||
      D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DA_LAUNCH(TQ, TKV)                                                \
  return launch<TQ, TKV>(q, k, v, lengths, out, B, H, Hkv, T, D, ksb, kst, ksh, \
                         vsb, vst, vsh, scale, s)
  if (q_dtype == kBF16 && kv_dtype == kBF16) REPRO_DA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == kF32 && kv_dtype == kBF16) REPRO_DA_LAUNCH(float, __nv_bfloat16);
  if (q_dtype == kBF16 && kv_dtype == kF32) REPRO_DA_LAUNCH(__nv_bfloat16, float);
  if (q_dtype == kF32 && kv_dtype == kF32) REPRO_DA_LAUNCH(float, float);
#undef REPRO_DA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
