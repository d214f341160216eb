// The decode kernel's stats entry for Hopper (sm_90a): one query token per
// row against one rank's shard of a sequence-sharded KV cache, left as its
// online-softmax stats (m, l, acc) for distributed flash decoding's
// log-sum-exp merge across ranks (dist/flash_decode.py).
//
// Replaces the stats path of the TPU kernel
// src/repro/kernels/decode_attention.py::_dec_kernel (entry decode_attention,
// :35 and :82; the JAX package's shard body reads the same stats from
// kernels/ref.py::decode_attention(..., return_stats=True)). It computes what
// that reference computes: m in natural-log units, l, and acc unnormalised,
// all f32, with scale 1/sqrt(D); the row length clipped to S; positions >=
// length never loaded (cp.async zero-fills them and their p is 0), so NaN
// there cannot leak; P rounded to bf16 before P V, as the decode kernel
// rounds it; and a row with no live key exactly (kNegInf, 0, 0). Any
// Hq % Hkv == 0, head dims 32, 64 and 128.
//
// What bounds it on the H100: bytes. At phase 3m serve_seqkv's local shard
// (B=2, S=16,384, Hq=24, Hkv=8, D=128, bf16) one call reads 134 MB of K/V
// and does 0.4 GFLOP: 40.1 us at 3.35 TB/s, 0.4 us at the bf16 peak.
//
// Design. The decode sweep (decode_sweep.cuh) was built for 528-position
// caches: one CTA per 64 keys, one batch of loads per CTA and nothing to
// overlap it with, and a merge of one thread per output element walking
// every split twice. At 16,384 positions that is 4,096 CTAs in waves and
// 6.4 MB of partials. Here:
// - Fewer, longer splits. A split holds `span` keys, a multiple of TILE = 64.
//   The rule (the wrapper's, kernels/ref.py stats_split_span): span = 64 *
//   ceil(tiles / 16), tiles = ceil(S / 64), so a row has at most 16 splits
//   whatever its capacity (16 at S = 16,384: 2 x 8 x 16 = 256 CTAs, two per
//   SM resident, one wave). The span depends on the capacity S alone, never
//   on the length, the device or the grid: the same inputs give the same
//   bits on every call and every card.
// - A ring per warp. Each CTA's 4 warps take 16 keys of every 64-key tile;
//   a warp streams its K and V rows through STAGES = 3 slots of its own by
//   cp.async groups, so the loads of the next two tiles are in flight while
//   it computes one, and no CTA-wide barrier runs in the loop. A warp keeps
//   an online softmax across its tiles (m, l and the 16 x D accumulator in
//   registers, rescaled when m grows); the group's query heads are the M
//   rows of mma.m16n8k16 for S = Q K^T and P V, as in the decode sweep.
// - The 4 warp partials merge in warp order in shared memory; each split
//   writes (m, l, acc[D]) for its heads to a scratch 16x smaller than the
//   sweep's (0.4 MB at the shape above).
// - merge: one CTA per (row, kv head). It reads its live splits' (m, l) once
//   into shared memory; threads g < G take M and L in split order and leave
//   each split's weight 2^(m_s - M) there; then the CTA's threads take the
//   (head, d) elements, each summing its live splits' acc in split order. A
//   split at or past the row's length is never read. The merge is launched
//   with programmatic stream serialisation right behind the split kernel.
// - f32 (tests and checks only; no path decodes in f32): SIMT, one warp per
//   query head, the split's keys in order with an online softmax.
// Scores are kept in log2 units (the scale folded with log2(e)); m leaves in
// natural-log units (M ln 2).
// Measured at the shape above on an NVIDIA H100 80GB HBM3 at 700 W: the
// split kernel reads at 80-84% of 3.35 TB/s, the merge adds about 6 us
// behind it; the decode sweep's entry took 0.149 ms, 0.095 ms of it its
// merge.
#include "decode_sweep.cuh"

namespace repro {
namespace stats {

constexpr int TILE = 64;                  // keys per tile: 4 warps x 16
constexpr int NW = 4;
constexpr int THREADS = NW * 32;
constexpr int KT = TILE / NW;             // keys per warp per tile: one k-step of P V
constexpr int ROWS = 16;                  // query heads per CTA: the mma's M
constexpr int STAGES = 3;                 // slots of a warp's ring
constexpr int MERGE_THREADS = 128;
using decode::kLn2;
using decode::kLog2e;
using decode::row_tiles;

// Splits of `span` keys over a capacity of S positions (at least one).
__host__ __device__ __forceinline__ int splits_of(int S, int span) {
  return S > span ? (S + span - 1) / span : 1;
}

template <int D>
constexpr int ring_bytes() {               // one CTA's shared memory (bf16)
  return NW * STAGES * 2 * KT * (D + 8) * 2;
}

// Where a CTA's split lies and where its partial goes. Scratch layout: acc
// [B, Hkv, NS, G, D] f32, then (m, l) [B, Hkv, NS, G] as float2, m in log2
// units.
struct Part {
  int b, hk, rt, start, end, Hkv, G, NS;
  float* acc;
  float2* ml;
  __device__ __forceinline__ size_t part(int g) const {
    return (static_cast<size_t>(b) * Hkv + hk) * NS * G +
           static_cast<size_t>(blockIdx.x) * G + g;
  }
  __device__ __forceinline__ size_t q_row(int g) const {      // row of q [B, Hq, D]
    return (static_cast<size_t>(b) * Hkv + hk) * G + g;
  }
};

// This CTA's split clipped to the row's live keys; false if it holds none.
__device__ __forceinline__ bool cta_part(const int* __restrict__ length, int S, int B,
                                         int Hkv, int G, int NS, int D, int span,
                                         float* scratch, Part& pt) {
  const int n_rt = row_tiles(G);
  pt.hk = blockIdx.y / n_rt;
  pt.rt = blockIdx.y - pt.hk * n_rt;
  pt.b = blockIdx.z;
  int len = length[pt.b];
  len = len < 0 ? 0 : (len > S ? S : len);
  pt.start = blockIdx.x * span;
  pt.end = min(pt.start + span, len);
  pt.Hkv = Hkv;
  pt.G = G;
  pt.NS = NS;
  pt.acc = scratch;
  pt.ml = reinterpret_cast<float2*>(scratch + static_cast<size_t>(B) * Hkv * NS * G * D);
  return pt.start < len;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ------------------------------------------------------------ bf16: tensor cores

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
split_kernel_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
                  const __nv_bfloat16* __restrict__ vc, const int* __restrict__ length,
                  float* __restrict__ scratch, int B, int S, int Hkv, int G, int NS,
                  int span) {
  static_assert(D % 32 == 0 && D <= 128, "unsupported head dim");
  constexpr int LD = D + 8;               // padded row: ldmatrix rows hit distinct banks
  constexpr int RS = D + 4;               // row stride of a warp's f32 partial
  constexpr int CPR = D / 8;              // 16-byte pieces per key row
  constexpr int PER = KT * CPR / 32;      // pieces per lane per tile, for K and for V
  constexpr int SLOT = 2 * KT * LD;       // one slot: K rows, then V rows
  static_assert((ROWS * RS + 2 * ROWS) * 4 <= STAGES * SLOT * 2, "partial overflows the ring");
  extern __shared__ __align__(16) unsigned char smem[];

  pdl_launch_dependents();
  Part pt;
  if (!cta_part(length, S, B, Hkv, G, NS, D, span, scratch, pt)) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;       // mma fragment row and column pair
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem) + warp * STAGES * SLOT;
  const size_t stride = static_cast<size_t>(Hkv) * D;      // elements between positions
  const size_t base = (static_cast<size_t>(pt.b) * S * Hkv + pt.hk) * D;
  const __nv_bfloat16* kb = kc + base;
  const __nv_bfloat16* vb = vc + base;
  const int n_tiles = (pt.end - pt.start + TILE - 1) / TILE;   // CTA-uniform
  const float scale2 = kLog2e / sqrtf(static_cast<float>(D));

  // Tile i's 16 keys of this warp into slot i % STAGES; always one commit
  // group, empty past the split, so the group count stays uniform.
  auto issue = [&](int i) {
    const int t0 = pt.start + i * TILE + warp * KT;
    const int nk = i < n_tiles ? min(KT, pt.end - t0) : 0;
    if (nk > 0) {                                // warp-uniform
      __nv_bfloat16* sk = ring + (i % STAGES) * SLOT;
      __nv_bfloat16* sv = sk + KT * LD;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int idx = j * 32 + lane, r = idx / CPR, c = idx % CPR;
        const bool live = r < nk;
        const size_t off = static_cast<size_t>(live ? t0 + r : t0) * stride + c * 8;
        cp_async16(&sk[r * LD + c * 8], kb + off, live);
        cp_async16(&sv[r * LD + c * 8], vb + off, live);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  // the A fragments of the 16 query heads of this row tile (rows >= G are 0)
  const int r0 = pt.rt * ROWS + gq, r1 = r0 + 8;
  const __nv_bfloat16* q0 = q + pt.q_row(r0) * D + 2 * tq;
  const __nv_bfloat16* q1 = q0 + 8 * D;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    qa[ks][0] = r0 < G ? ld32(q0 + ks * 16) : 0u;
    qa[ks][1] = r1 < G ? ld32(q1 + ks * 16) : 0u;
    qa[ks][2] = r0 < G ? ld32(q0 + ks * 16 + 8) : 0u;
    qa[ks][3] = r1 < G ? ld32(q1 + ks * 16 + 8) : 0u;
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows gq, gq + 8
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    issue(i + STAGES - 1);
    cp_async_wait_group<STAGES - 1>();           // tile i has landed
    __syncwarp();
    const int nk = min(KT, pt.end - (pt.start + i * TILE + warp * KT));
    if (nk > 0) {                                // warp-uniform
      const __nv_bfloat16* sk = ring + (i % STAGES) * SLOT;
      const __nv_bfloat16* sv = sk + KT * LD;
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t kf[4];
        ldsm_x4(kf, &sk[((lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                        ((lane >> 3) & 1) * 8]);
        mma_16816(sc[0], qa[ks], kf[0], kf[1]);
        mma_16816(sc[1], qa[ks], kf[2], kf[3]);
      }
      float mt[2] = {m[0], m[1]};
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = nb * 8 + 2 * tq + (e & 1) < nk;
          sc[nb][e] = live ? sc[nb][e] * scale2 : kNegInf;
          mt[e >> 1] = fmaxf(mt[e >> 1], sc[nb][e]);
        }
      }
      float ls[2] = {0.f, 0.f}, corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
        corr[h] = ex2_ftz(m[h] - mt[h]);         // 0 while m is still kNegInf
        m[h] = mt[h];
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = nb * 8 + 2 * tq + (e & 1) < nk;
          sc[nb][e] = live ? ex2_ftz(sc[nb][e] - m[e >> 1]) : 0.f;
          ls[e >> 1] += sc[nb][e];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 1);
        ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 2);
        l[h] = fmaf(l[h], corr[h], ls[h]);
      }
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        acc[nb][0] *= corr[0];
        acc[nb][1] *= corr[0];
        acc[nb][2] *= corr[1];
        acc[nb][3] *= corr[1];
      }
      // P [16 heads x 16 keys] in bf16 as the A fragment of P V
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                              pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
      for (int nb2 = 0; nb2 < D / 16; ++nb2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, &sv[((lane & 7) + ((lane >> 3) & 1) * 8) * LD + nb2 * 16 +
                              (lane >> 4) * 8]);
        mma_16816(acc[2 * nb2], pa, vf[0], vf[1]);
        mma_16816(acc[2 * nb2 + 1], pa, vf[2], vf[3]);
      }
    }
    __syncwarp();                                // the slot is refilled next iteration
  }
  cp_async_wait_group<0>();                      // only empty groups can be pending

  // the warp's partial over its own ring
  __syncwarp();
  float* red = reinterpret_cast<float*>(ring);
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
  const int nrows = min(ROWS, G - pt.rt * ROWS);
  const __nv_bfloat16* all = reinterpret_cast<const __nv_bfloat16*>(smem);
  for (int i = threadIdx.x; i < nrows * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      M = fmaxf(M, reinterpret_cast<const float*>(all + w * STAGES * SLOT)[ROWS * RS + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* rw = reinterpret_cast<const float*>(all + w * STAGES * SLOT);
      const float e = ex2_ftz(rw[ROWS * RS + r] - M);
      L = fmaf(rw[ROWS * RS + ROWS + r], e, L);
      A = fmaf(rw[r * RS + d], e, A);
    }
    const size_t p = pt.part(pt.rt * ROWS + r);
    pt.acc[p * D + d] = A;
    if (d == 0) pt.ml[p] = make_float2(M, L);
  }
}

// ------------------------------------------------------------ f32: SIMT

template <int D>
__global__ void __launch_bounds__(THREADS)
split_kernel_f32(const float* __restrict__ q, const float* __restrict__ kc,
                 const float* __restrict__ vc, const int* __restrict__ length,
                 float* __restrict__ scratch, int B, int S, int Hkv, int G, int NS, int span) {
  constexpr int E = D / 32;                      // elements per lane
  static_assert(E >= 1 && E <= 4 && D % 32 == 0, "unsupported head dim");
  pdl_launch_dependents();
  Part pt;
  if (!cta_part(length, S, B, Hkv, G, NS, D, span, scratch, pt)) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t stride = static_cast<size_t>(Hkv) * D;
  const size_t base = (static_cast<size_t>(pt.b) * S * Hkv + pt.hk) * D + lane * E;
  const int nrows = min(ROWS, G - pt.rt * ROWS);
  const float scale2 = kLog2e / sqrtf(static_cast<float>(D));
  for (int r = warp; r < nrows; r += NW) {
    const int g = pt.rt * ROWS + r;
    float qv[E], acc[E];
    decode::load_f32<E>(q + pt.q_row(g) * D + lane * E, qv);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    float m = kNegInf, l = 0.f;
    for (int t = pt.start; t < pt.end; ++t) {
      float kr[E], vr[E];
      decode::load_f32<E>(kc + base + t * stride, kr);
      decode::load_f32<E>(vc + base + t * stride, vr);
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
    const size_t p = pt.part(g);
#pragma unroll
    for (int e = 0; e < E; ++e) pt.acc[p * D + lane * E + e] = acc[e];
    if (lane == 0) pt.ml[p] = make_float2(m, l);
  }
}

// ------------------------------------------------------------ the merge

// One CTA per (row, kv head): m, l [B, Hkv, G] with m in natural-log units,
// acc [B, Hkv, G, D], over the row's live splits in split order. A row with
// no live split writes (kNegInf, 0, 0).
__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const float* __restrict__ scratch, const int* __restrict__ length,
             float* __restrict__ m_out, float* __restrict__ l_out,
             float* __restrict__ acc_out, int B, int S, int Hkv, int G, int D, int NS,
             int span) {
  extern __shared__ __align__(16) float shared[];
  float2* ml_s = reinterpret_cast<float2*>(shared);   // [NS][G]: the splits' (m, l)
  float* weight = shared + 2 * NS * G;               // [NS][G]: 2^(m_s - M)
  const int hk = blockIdx.x, b = blockIdx.y;
  int len = length[b];                           // an input, not the split kernel's output
  pdl_wait();
  len = len < 0 ? 0 : (len > S ? S : len);
  const int n = (len + span - 1) / span;         // live splits
  const size_t row = static_cast<size_t>(b) * Hkv + hk;
  const size_t p0 = row * NS * G;                // (split 0, head 0) of this row
  const float2* ml = reinterpret_cast<const float2*>(scratch + static_cast<size_t>(B) * Hkv *
                                                     NS * G * D);
  for (int i = threadIdx.x; i < n * G; i += MERGE_THREADS) ml_s[i] = ml[p0 + i];
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += MERGE_THREADS) {
    float M = kNegInf;
    for (int s = 0; s < n; ++s) M = fmaxf(M, ml_s[s * G + g].x);
    float L = 0.f;
    for (int s = 0; s < n; ++s) {
      const float e = exp2f(ml_s[s * G + g].x - M);
      weight[s * G + g] = e;
      L = fmaf(ml_s[s * G + g].y, e, L);
    }
    m_out[row * G + g] = n > 0 ? M * kLn2 : kNegInf;
    l_out[row * G + g] = L;
  }
  __syncthreads();
  const float* acc = scratch + p0 * D;
  for (int i = threadIdx.x; i < G * D; i += MERGE_THREADS) {
    const int g = i / D;
    float A = 0.f;
#pragma unroll 8
    for (int s = 0; s < n; ++s)
      A = fmaf(acc[static_cast<size_t>(s) * G * D + i], weight[s * G + g], A);
    acc_out[row * G * D + i] = A;
  }
}

template <typename T, int D>
struct Launch {
  static cudaError_t run(const void* q, const void* k, const void* v, const int* length,
                         float* m, float* l, float* acc, float* scratch, int B, int S,
                         int Hkv, int G, int NS, int span, cudaStream_t stream) {
    const dim3 grid(NS, Hkv * row_tiles(G), B);
    if constexpr (sizeof(T) == 2) {
      constexpr int smem = ring_bytes<D>();
      static const cudaError_t smem_ok = cudaFuncSetAttribute(
          split_kernel_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (smem_ok != cudaSuccess) return smem_ok;
      split_kernel_bf16<D><<<grid, THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), length,
          scratch, B, S, Hkv, G, NS, span);
    } else {
      split_kernel_f32<D><<<grid, THREADS, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), length,
          scratch, B, S, Hkv, G, NS, span);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(Hkv, B);
    cfg.blockDim = dim3(MERGE_THREADS);
    cfg.dynamicSmemBytes = static_cast<size_t>(NS) * G * 3 * sizeof(float);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, merge_kernel, static_cast<const float*>(scratch), length,
                              m, l, acc, B, S, Hkv, G, D, NS, span);
  }
};

}  // namespace stats
}  // namespace repro

// q: [B,Hq,D]; k, v: [B,S,Hkv,D]; length: int32 [B] on the device; m, l: f32
// [B, Hkv, Hq / Hkv] (m in natural-log units, the reference's NEG_INF =
// -1e30 where a row has no key); acc: f32 [B, Hkv, Hq / Hkv, D],
// unnormalised; contiguous, q/k/v of one dtype (0 = f32, 1 = bf16), 16-byte
// aligned. span: keys per split, a positive multiple of 64; n_splits =
// max(1, ceil(S / span)) (the wrapper passes the split rule's pair). scratch:
// f32 [B * Hkv * n_splits * (Hq / Hkv) * (D + 2)].
// Launches the split kernel and the merge on `stream`, does not synchronise,
// returns the first CUDA error of the two launches.
extern "C" int repro_decode_attention_stats(const void* q, const void* k, const void* v,
                                            const void* length, void* m, void* l, void* acc,
                                            void* scratch, int dtype, int B, int S, int Hq,
                                            int Hkv, int D, int n_splits, int span,
                                            void* stream) {
  if (B <= 0 || S < 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || span <= 0 ||
      span % repro::stats::TILE != 0 || n_splits != repro::stats::splits_of(S, span) ||
      static_cast<size_t>(n_splits) * (Hq / Hkv) * 3 * sizeof(float) > 48 * 1024)
    return cudaErrorInvalidValue;
  return repro::decode::dispatch<repro::stats::Launch>(
      dtype, D, q, k, v, static_cast<const int*>(length), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(acc), static_cast<float*>(scratch), B, S,
      Hkv, Hq / Hkv, n_splits, span, static_cast<cudaStream_t>(stream));
}
