// The one-token attention shared by the contiguous and the paged decode
// kernels (decode_attention.cu, paged_decode_attention.cu). The two differ
// only in where key t of a row lives; each passes a functor that maps the
// logical position t to an element offset from the row's base pointer.
//
// Design: split-KV across CTAs, then a deterministic log-sum-exp merge.
// - The key axis is cut into splits of CHUNK = 64 logical keys. The CTA for
//   (split s, kv head hk, row tile rt, batch row b) sweeps keys
//   [s * CHUNK, min((s + 1) * CHUNK, len)) for up to ROWS = 16 query heads
//   of the group (G > 16 takes more row tiles) and writes its f32 partial
//   (m, l, acc[D]) per head to a scratch that the wrapper allocates. A CTA
//   whose split starts at or past `len` loads nothing and writes nothing.
// - bf16: each of the 4 warps takes 16 consecutive keys of the split. Its K
//   and V rows come by cp.async into padded shared rows (V still in flight
//   while the scores are made); the group's heads are the M rows of
//   mma.m16n8k16 (padded to 16), keys are N and D is K for S = Q K^T, and P,
//   rounded to bf16 as the Pallas kernel rounds it, is the A operand of
//   P V with V read by ldmatrix.trans. The 4 warp partials merge in warp
//   order in shared memory.
// - f32 (tests and checks only; no path decodes in f32): SIMT, one warp per
//   query head, the split's keys in order, an online softmax.
// - merge_kernel, launched right behind with programmatic stream
//   serialisation, combines the live splits of each (row, head) in split
//   order: M = max m_s, L = sum l_s 2^(m_s - M), A = sum acc_s 2^(m_s - M),
//   out = A / (L == 0 ? 1 : L). Scores are kept in log2 units (the scale
//   folded with log2(e)), so every exponential is a power of two.
// - Which CTA and warp take key t, and the order of every sum, depend on t
//   alone, never on its address or on the cache's capacity: the same logical
//   cache gives bit-identical results under any page layout and through the
//   contiguous kernel, and a rerun gives the same bits.
// - Positions >= len are never loaded (cp.async zero-fills them and their
//   p is 0), so NaN there cannot leak, and a row with len = 0 has no live
//   split and is exactly 0. G is a run-time argument: every Hq % Hkv == 0.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace decode {

constexpr int CHUNK = 64;                 // logical keys per split (one CTA)
constexpr int NW = 4;                     // warps per CTA
constexpr int THREADS = NW * 32;
constexpr int KT = CHUNK / NW;            // keys per warp (bf16): one k-step of P V
constexpr int ROWS = 16;                  // query heads per CTA: the mma's M
constexpr int MERGE_THREADS = 256;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ __forceinline__ int row_tiles(int G) { return (G + ROWS - 1) / ROWS; }

// splits of a cache of `cap` positions (at least one, so the grid is never empty)
__host__ __device__ __forceinline__ int n_splits(int cap) {
  return cap > CHUNK ? (cap + CHUNK - 1) / CHUNK : 1;
}

// One CTA's work and where its partial goes. Scratch layout: acc [B, Hkv,
// NS, G, D] f32, then (m, l) [B, Hkv, NS, G] as float2, m in log2 units.
struct Split {
  int b, hk, s, rt, len, Hkv, G, NS;
  float* acc;
  float2* ml;
  __device__ __forceinline__ size_t part(int g) const {
    return (static_cast<size_t>(b) * Hkv + hk) * NS * G + static_cast<size_t>(s) * G + g;
  }
  __device__ __forceinline__ size_t q_row(int g) const {      // row of q [B, Hq, D]
    return (static_cast<size_t>(b) * Hkv + hk) * G + g;
  }
};

// This CTA's split, its length clipped to [0, cap]; false if the split holds
// no live key (the CTA then loads and writes nothing).
__device__ __forceinline__ bool cta_split(const int* __restrict__ length, int cap, int B,
                                          int Hkv, int G, int NS, int D, float* scratch,
                                          Split& sp) {
  const int n_rt = row_tiles(G);
  sp.s = blockIdx.x;
  sp.hk = blockIdx.y / n_rt;
  sp.rt = blockIdx.y - sp.hk * n_rt;
  sp.b = blockIdx.z;
  const int len = length[sp.b];
  sp.len = len < 0 ? 0 : (len > cap ? cap : len);
  sp.Hkv = Hkv;
  sp.G = G;
  sp.NS = NS;
  sp.acc = scratch;
  sp.ml = reinterpret_cast<float2*>(scratch + static_cast<size_t>(B) * Hkv * NS * G * D);
  return sp.s * CHUNK < sp.len;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ------------------------------------------------------------ bf16: tensor cores

// kb, vb: the row's K and V base pointers (kv head applied); keys(t): element
// offset of key t from them.
template <int D, typename Keys>
__device__ __forceinline__ void partial(const __nv_bfloat16* __restrict__ q,
                                        const __nv_bfloat16* __restrict__ kb,
                                        const __nv_bfloat16* __restrict__ vb, const Keys& keys,
                                        const Split& sp) {
  static_assert(D % 32 == 0 && D <= 128, "unsupported head dim");
  constexpr int LD = D + 8;               // padded row: ldmatrix rows hit distinct banks
  constexpr int RS = D + 4;               // row stride of a warp's f32 partial
  constexpr int CPR = D / 8;              // 16-byte pieces per key row
  constexpr int PER = KT * CPR / 32;      // pieces per lane per tile
  // a warp's K and V tiles; once read they hold its f32 partial [16][RS] + m, l
  __shared__ __align__(16) __nv_bfloat16 kv[NW][2][KT][LD];
  static_assert((ROWS * RS + 2 * ROWS) * 4 <= 2 * KT * LD * 2, "partial overflows the tiles");

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;       // mma fragment row and column pair
  const int t0 = sp.s * CHUNK + warp * KT;
  const int nk = min(KT, sp.len - t0);           // live keys of this warp (may be <= 0)
  const float scale2 = kLog2e / sqrtf(static_cast<float>(D));
  auto& sk = kv[warp][0];
  auto& sv = kv[warp][1];

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows gq, gq + 8
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  if (nk > 0) {                                  // warp-uniform
    const long long mine = lane < nk ? static_cast<long long>(keys(t0 + lane)) : 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = i * 32 + lane, r = idx / CPR, c = idx % CPR;
      const long long off = __shfl_sync(0xffffffffu, mine, r);
      cp_async16(&sk[r][c * 8], kb + off + c * 8, r < nk);
    }
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = i * 32 + lane, r = idx / CPR, c = idx % CPR;
      const long long off = __shfl_sync(0xffffffffu, mine, r);
      cp_async16(&sv[r][c * 8], vb + off + c * 8, r < nk);
    }
    cp_async_commit();

    // the A fragments of the 16 query heads of this row tile (rows >= G are 0)
    const int r0 = sp.rt * ROWS + gq, r1 = r0 + 8;
    const __nv_bfloat16* q0 = q + sp.q_row(r0) * D + 2 * tq;
    const __nv_bfloat16* q1 = q0 + 8 * D;
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      qa[ks][0] = r0 < sp.G ? ld32(q0 + ks * 16) : 0u;
      qa[ks][1] = r1 < sp.G ? ld32(q1 + ks * 16) : 0u;
      qa[ks][2] = r0 < sp.G ? ld32(q0 + ks * 16 + 8) : 0u;
      qa[ks][3] = r1 < sp.G ? ld32(q1 + ks * 16 + 8) : 0u;
    }

    cp_async_wait_group<1>();                    // K has landed
    __syncwarp();
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t kf[4];
      ldsm_x4(kf, &sk[(lane & 7) + ((lane >> 4) << 3)][ks * 16 + ((lane >> 3) & 1) * 8]);
      mma_16816(sc[0], qa[ks], kf[0], kf[1]);
      mma_16816(sc[1], qa[ks], kf[2], kf[3]);
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = nb * 8 + 2 * tq + (e & 1) < nk;
        sc[nb][e] = live ? sc[nb][e] * scale2 : kNegInf;
        m[e >> 1] = fmaxf(m[e >> 1], sc[nb][e]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = nb * 8 + 2 * tq + (e & 1) < nk;
        sc[nb][e] = live ? ex2_ftz(sc[nb][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += sc[nb][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    // P [16 heads x 16 keys] in bf16 as the A fragment of P V
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};

    cp_async_wait_group<0>();                    // V has landed
    __syncwarp();
#pragma unroll
    for (int nb2 = 0; nb2 < D / 16; ++nb2) {
      uint32_t vf[4];
      ldsm_x4_trans(vf, &sv[(lane & 7) + ((lane >> 3) & 1) * 8][nb2 * 16 + (lane >> 4) * 8]);
      mma_16816(acc[2 * nb2], pa, vf[0], vf[1]);
      mma_16816(acc[2 * nb2 + 1], pa, vf[2], vf[3]);
    }
  }

  // the warp's partial over its own (now read) tiles
  __syncwarp();
  float* red = reinterpret_cast<float*>(&kv[warp][0][0][0]);
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    *reinterpret_cast<float2*>(&red[gq * RS + nb * 8 + 2 * tq]) =
        make_float2(acc[nb][0], acc[nb][1]);
    *reinterpret_cast<float2*>(&red[(gq + 8) * RS + nb * 8 + 2 * tq]) =
        make_float2(acc[nb][2], acc[nb][3]);
  }
  if (tq == 0) {
    red[ROWS * RS + gq] = m[0];
    red[ROWS * RS + gq + 8] = m[1];
    red[ROWS * RS + ROWS + gq] = l[0];
    red[ROWS * RS + ROWS + gq + 8] = l[1];
  }
  __syncthreads();

  // merge the warps in warp order; write the split's partial
  const int nrows = min(ROWS, sp.G - sp.rt * ROWS);
  for (int i = threadIdx.x; i < nrows * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      M = fmaxf(M, reinterpret_cast<const float*>(&kv[w][0][0][0])[ROWS * RS + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* rw = reinterpret_cast<const float*>(&kv[w][0][0][0]);
      const float e = ex2_ftz(rw[ROWS * RS + r] - M);
      L = fmaf(rw[ROWS * RS + ROWS + r], e, L);
      A = fmaf(rw[r * RS + d], e, A);
    }
    const size_t p = sp.part(sp.rt * ROWS + r);
    sp.acc[p * D + d] = A;
    if (d == 0) sp.ml[p] = make_float2(M, L);
  }
}

// ------------------------------------------------------------ f32: SIMT

template <int E>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[E]) {
  if constexpr (E == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (E == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
    out[0] = *p;
  }
}

template <int D, typename Keys>
__device__ __forceinline__ void partial(const float* __restrict__ q, const float* __restrict__ kb,
                                        const float* __restrict__ vb, const Keys& keys,
                                        const Split& sp) {
  constexpr int E = D / 32;                      // elements per lane
  static_assert(E >= 1 && E <= 4 && D % 32 == 0, "unsupported head dim");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = sp.s * CHUNK;
  const int nk = min(CHUNK, sp.len - t0);
  const int nrows = min(ROWS, sp.G - sp.rt * ROWS);
  const float scale2 = kLog2e / sqrtf(static_cast<float>(D));
  for (int r = warp; r < nrows; r += NW) {
    const int g = sp.rt * ROWS + r;
    float qv[E], acc[E];
    load_f32<E>(q + sp.q_row(g) * D + lane * E, qv);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    float m = kNegInf, l = 0.f;
    for (int j = 0; j < nk; ++j) {
      const size_t off = keys(t0 + j) + lane * E;
      float kr[E], vr[E];
      load_f32<E>(kb + off, kr);
      load_f32<E>(vb + off, vr);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) part = fmaf(qv[e], kr[e], part);
      const float sc = warp_sum(part) * scale2;  // the same bits in every lane
      const float m_new = fmaxf(m, sc);
      const float corr = exp2f(m - m_new), p = exp2f(sc - m_new);
      l = fmaf(l, corr, p);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vr[e], acc[e] * corr);
      m = m_new;
    }
    const size_t p = sp.part(g);
#pragma unroll
    for (int e = 0; e < E; ++e) sp.acc[p * D + lane * E + e] = acc[e];
    if (lane == 0) sp.ml[p] = make_float2(m, l);
  }
}

// ------------------------------------------------------------ the merge

// (internal linkage: each kernel source instantiates its own merge kernels)
namespace {

// One thread per output element of o [B, Hkv * G, D]: the live splits of its
// row in split order.
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const float* __restrict__ scratch, const int* __restrict__ length,
             T* __restrict__ o, int B, int Hkv, int G, int D, int NS, int cap) {
  const size_t total = static_cast<size_t>(B) * Hkv * G * D;
  const size_t i = static_cast<size_t>(blockIdx.x) * MERGE_THREADS + threadIdx.x;
  if (i >= total) return;
  const int d = static_cast<int>(i % D);
  const size_t row = i / D;                      // b * Hq + h
  const int Hq = Hkv * G;
  const int b = static_cast<int>(row / Hq), h = static_cast<int>(row % Hq);
  const int hk = h / G, g = h - hk * G;
  int len = length[b];                           // an input, not the split kernel's output
  pdl_wait();
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int n = (len + CHUNK - 1) / CHUNK;       // live splits
  const float2* ml = reinterpret_cast<const float2*>(scratch + total * NS);
  const size_t p0 = (static_cast<size_t>(b) * Hkv + hk) * NS * G + g;
  float M = kNegInf;
  for (int s = 0; s < n; ++s) M = fmaxf(M, ml[p0 + static_cast<size_t>(s) * G].x);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n; ++s) {
    const size_t p = p0 + static_cast<size_t>(s) * G;
    const float2 st = ml[p];
    const float e = exp2f(st.x - M);
    L = fmaf(st.y, e, L);
    A = fmaf(scratch[p * D + d], e, A);
  }
  store(o + i, A / (L == 0.f ? 1.f : L));
}

template <typename T>
cudaError_t launch_merge(const float* scratch, const int* length, void* o, int B, int Hkv,
                         int G, int D, int NS, int cap, cudaStream_t stream) {
  const size_t total = static_cast<size_t>(B) * Hkv * G * D;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((total + MERGE_THREADS - 1) / MERGE_THREADS));
  cfg.blockDim = dim3(MERGE_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, merge_kernel<T>, scratch, length, static_cast<T*>(o), B,
                            Hkv, G, D, NS, cap);
}

}  // namespace

// Instantiate `Launch<T, D>::run(args...)` for the built head dims; anything
// else is cudaErrorInvalidValue.
template <template <typename, int> class Launch, typename T, typename... Args>
cudaError_t dispatch_d(int D, Args... args) {
  switch (D) {
    case 32: return Launch<T, 32>::run(args...);
    case 64: return Launch<T, 64>::run(args...);
    case 128: return Launch<T, 128>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <template <typename, int> class Launch, typename... Args>
cudaError_t dispatch(int dtype, int D, Args... args) {
  if (dtype == kBFloat16) return dispatch_d<Launch, __nv_bfloat16>(D, args...);
  if (dtype == kFloat32) return dispatch_d<Launch, float>(D, args...);
  return cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace repro
