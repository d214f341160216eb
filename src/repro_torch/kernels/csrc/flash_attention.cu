// Prefill attention for Hopper (sm_90a): GQA softmax(Q K^T / sqrt(D)) V,
// causal or bidirectional, with the causal diagonal shifted by q_offset.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_fa_kernel
// (entry flash_attention, :33 and :151). It computes what that kernel
// computes: online softmax with f32 (m, l, acc), P rounded to bf16 for the
// P V product, a fully masked row gives 0, the output is cast to q's dtype.
// The TPU kernel runs one (query head, q block) per grid step and streams
// K/V blocks through VMEM along a sequential grid dimension.
//
// What bounds it on the H100. For one llama3.2-3b prefill layer (B=4,
// S=512, Hq=24, Hkv=8, D=128, bf16, causal) the call moves ~33.5 MB (q, k,
// v, o) and does ~6.4 GFLOP: ~10 us at 3.35 TB/s against ~6.5 us at the
// 989 TFLOP/s bf16 tensor-core rate, so the card could run it memory-bound.
// Only wgmma reaches that tensor rate. The first tensor-core version
// (mma.sync; K/V staged by the threads between two barriers; V transposed by
// hand; every element masked) ran at 3.6x the library call.
//
// Three kernels, one contract:
// - bf16, D = 64 and 128 (the serve paths): flash_fwd_wgmma_kernel.
//   * A producer warp issues TMA loads: Q once, then K and V tiles of 64
//     keys into a ring of 2 stages with a full and an empty mbarrier per
//     stage, so the next tile lands while this one is computed. The tensor
//     maps hold the tensors' addresses, so they are encoded on the host for
//     a call's pointers and shapes (chip_smoke.py logs what an encoding
//     costs), cached per host thread, and passed as __grid_constant__
//     parameters; 128-byte swizzle; the ragged tail of Skv and rows past Sq
//     come zero-filled from TMA's out-of-bounds fill.
//   * One consumer warpgroup owns the CTA's 64 query rows. S = Q K^T is one
//     wgmma m64n64k16 chain from shared memory; the online softmax runs on S
//     in registers in f32, on exp2 with the scale folded into log2(e); P is
//     rounded to bf16 in registers and is the register A operand of the
//     P V wgmma, which reads V row-major through the descriptor's transpose
//     bit (no hand transpose).
//   * Two CTAs share an SM (160 threads, <= 204 registers, ~41 KB or ~81 KB
//     of shared memory), so one CTA's softmax and prologue run while the
//     other's products or loads are in flight. Timed against it on the
//     H100, two consumer warpgroups of 64 rows in one CTA were slower, with
//     or without a software pipeline (the scores of tile t + 1 issued beside
//     P V of tile t) and ping-pong scheduling between the two.
//   * Only tiles that cross a row's limit (the causal diagonal, the ragged
//     end of Skv) are masked; the others skip the compare.
//   * Row blocks are issued in reverse: blockIdx.y = 0 is the last block of
//     query positions, which in a causal grid sees the most keys, so the
//     heaviest CTAs start first and the light ones fill the tail. A
//     persistent CTA per SM walking the same order was measured no faster.
//   * G = Hq / Hkv is at most 64 (a CTA holds whole positions).
// - bf16, D = 32: flash_fwd_mma_kernel, the first tensor-core version
//   (mma.sync m16n8k16 on 4 warps, K/V staged by the threads), kept for the
//   narrow head dim that no path of the port runs.
// - f32 (tests and edge shapes): flash_fwd_simt_kernel, the same loop on the
//   f32 SIMT pipes (67 TFLOP/s peak), exact to f32 rounding.
//
// Layout common to all three: one CTA per (batch, kv head, block of query
// rows), where a row is one (position, query head of the group) pair: the
// G = Hq/Hkv query heads of a group share every K/V tile the CTA stages,
// instead of the Pallas grid's one pass over K/V per query head. The CTA
// stops at the causal diagonal of its last row.
//
// SIMT kernel: tiles of 32 keys are widened to f32 in shared memory; lane j
// of a warp owns key j and computes its dot product with the warp's 8 rows;
// online softmax per row with a warp max; P goes through shared memory and
// lane d accumulates output dims d, d+32, ... of all 8 rows.
//
// mma.sync kernel: each warp owns 16 rows, whose Q fragments stay in
// registers; per tile of 64 keys it computes S (16x64) = Q K^T from K staged
// row-major in shared memory, masks and rescales in registers, re-packs S as
// the A fragment of P V, and accumulates O (16xD) from V staged transposed.
#include <cuda.h>
#include <math_constants.h>

#include <algorithm>
#include <chrono>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

constexpr int BK = 32;              // keys per tile: one per lane
constexpr int RW = 8;               // query rows per warp
constexpr int NWARPS = 4;
constexpr int ROWS = RW * NWARPS;   // query rows per CTA
constexpr int THREADS = NWARPS * 32;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (ROWS * D + BK * (D + 4) + BK * D + ROWS * BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int Sq, int Skv, int Hq, int Hkv, int causal, int q_offset) {
  constexpr int V = kVec<T>;
  constexpr int VPR = D / V;        // 16-byte vectors per head row
  constexpr int KS = D + 4;         // padded K row stride (floats)
  constexpr int DPL = D / 32;       // output dims per lane: d = lane + 32 * t
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [ROWS][D]
  float* Ks = Qs + ROWS * D;        // [BK][KS]
  float* Vs = Ks + BK * KS;         // [BK][D]
  float* Ps = Vs + BK * D;          // [ROWS][BK]

  const int G = Hq / Hkv;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;          // flattened row = position * G + g
  const int nrows = Sq * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  for (int i = tid; i < ROWS * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * V;
    const int fr = row0 + r;
    float tmp[V];
    if (fr < nrows) {
      const int pos = fr / G, g = fr - pos * G;
      load_vec(q + ((static_cast<size_t>(b) * Sq + pos) * Hq + hk * G + g) * D + c, tmp);
    } else {
#pragma unroll
      for (int t = 0; t < V; ++t) tmp[t] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < V; ++t) Qs[r * D + c + t] = tmp[t];
  }

  // last key index each of this warp's rows may see (-1: the row is past Sq)
  int qlim[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int fr = row0 + warp * RW + i;
    qlim[i] = fr >= nrows ? -1 : (causal ? q_offset + fr / G : Skv - 1);
  }
  const int last = min(row0 + ROWS, nrows) - 1;
  const int kv_end = causal ? min(Skv, q_offset + last / G + 1) : Skv;

  float m[RW], lsum[RW], acc[RW][DPL];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = kNegInf;
    lsum[i] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[i][t] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                  // Q staged / previous tile consumed
    for (int i = tid; i < BK * VPR; i += THREADS) {
      const int j = i / VPR, c = (i % VPR) * V;
      const int kp = k0 + j;
      float kt[V], vt[V];
      if (kp < Skv) {
        const size_t off = ((static_cast<size_t>(b) * Skv + kp) * Hkv + hk) * D + c;
        load_vec(k + off, kt);
        load_vec(v + off, vt);
      } else {                        // ragged tail: never read past Skv
#pragma unroll
        for (int t = 0; t < V; ++t) kt[t] = vt[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < V; ++t) {
        Ks[j * KS + c + t] = kt[t];
        Vs[j * D + c + t] = vt[t];
      }
    }
    __syncthreads();

    const int kp = k0 + lane;
    float s[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(&Ks[lane * KS + d]);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(&Qs[(warp * RW + i) * D + d]);
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const bool valid = kp < Skv && kp <= qlim[i];
      const float sc = valid ? s[i] * scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float p = valid ? expf(sc - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      lsum[i] = lsum[i] * corr + p;
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[i][t] *= corr;
      m[i] = m_new;
      Ps[(warp * RW + i) * BK + lane] = p;
    }
    __syncwarp();
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pj[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i)
        pj[i] = *reinterpret_cast<const float4*>(&Ps[(warp * RW + i) * BK + j]);
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int d = lane + 32 * t;
        const float v0 = Vs[(j + 0) * D + d], v1 = Vs[(j + 1) * D + d];
        const float v2 = Vs[(j + 2) * D + d], v3 = Vs[(j + 3) * D + d];
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          acc[i][t] = fmaf(pj[i].x, v0, acc[i][t]);
          acc[i][t] = fmaf(pj[i].y, v1, acc[i][t]);
          acc[i][t] = fmaf(pj[i].z, v2, acc[i][t]);
          acc[i][t] = fmaf(pj[i].w, v3, acc[i][t]);
        }
      }
    }
    __syncwarp();                     // Ps is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const float l = warp_sum(lsum[i]);
    const int fr = row0 + warp * RW + i;
    if (fr >= nrows) continue;
    const int pos = fr / G, g = fr - pos * G;
    T* dst = o + ((static_cast<size_t>(b) * Sq + pos) * Hq + hk * G + g) * D;
    const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int t = 0; t < DPL; ++t) store(dst + lane + 32 * t, acc[i][t] / l_safe);
  }
}

// ------------------------------------------------- tensor cores, mma.sync (D = 32)

constexpr int MMA_ROWS = 64;        // query rows per CTA: 16 per warp
constexpr int MMA_BK = 64;          // keys per tile

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = 32 only (the wgmma kernel takes D = 64 and 128): fragment layout of
// mma.m16n8k16 in hopper.cuh.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int Sq, int Skv, int Hq, int Hkv, int causal, int q_offset) {
  constexpr int KSTR = D + 8;       // Ks row stride (bf16): conflict-free b-fragment loads
  constexpr int VSTR = MMA_BK + 8;  // Vt row stride (bf16)
  constexpr int NT = MMA_BK / 8;    // n-tiles of S per warp
  constexpr int DK = D / 16;        // k-steps of Q K^T
  constexpr int DN = D / 8;         // n-tiles of O
  constexpr int VPR = D / 8;        // 16-byte vectors per head row
  __shared__ __align__(16) __nv_bfloat16 Ks[MMA_BK * KSTR];   // [key][d]
  __shared__ __align__(16) __nv_bfloat16 Vt[D * VSTR];        // [d][key]

  const int G = Hq / Hkv;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tg = lane & 3;
  const int row0 = blockIdx.x * MMA_ROWS;
  const int nrows = Sq * G;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  // this thread's two rows: g and g + 8 of the warp's 16
  int qlim[2];
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = row0 + warp * 16 + gq + 8 * h;
    if (fr < nrows) {
      const int pos = fr / G, g = fr - pos * G;
      qlim[h] = causal ? q_offset + pos : Skv - 1;
      qrow[h] = q + ((static_cast<size_t>(b) * Sq + pos) * Hq + hk * G + g) * D;
    } else {
      qlim[h] = -1;
      qrow[h] = nullptr;
    }
  }
  uint32_t qa[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    const int c = kk * 16 + 2 * tg;
    qa[kk][0] = qrow[0] ? ld32(qrow[0] + c) : 0u;
    qa[kk][1] = qrow[1] ? ld32(qrow[1] + c) : 0u;
    qa[kk][2] = qrow[0] ? ld32(qrow[0] + c + 8) : 0u;
    qa[kk][3] = qrow[1] ? ld32(qrow[1] + c + 8) : 0u;
  }

  const int last = min(row0 + MMA_ROWS, nrows) - 1;
  const int kv_end = causal ? min(Skv, q_offset + last / G + 1) : Skv;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += MMA_BK) {
    __syncthreads();                  // previous tile consumed
    for (int i = tid; i < MMA_BK * VPR; i += THREADS) {
      {                               // K: d fastest, row-major
        const int j = i / VPR, c = (i % VPR) * 8, kp = k0 + j;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (kp < Skv)
          raw = *reinterpret_cast<const uint4*>(
              k + ((static_cast<size_t>(b) * Skv + kp) * Hkv + hk) * D + c);
        *reinterpret_cast<uint4*>(&Ks[j * KSTR + c]) = raw;
      }
      {                               // V: key fastest, transposed
        const int j = i % MMA_BK, c = (i / MMA_BK) * 8, kp = k0 + j;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (kp < Skv)
          raw = *reinterpret_cast<const uint4*>(
              v + ((static_cast<size_t>(b) * Skv + kp) * Hkv + hk) * D + c);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int t = 0; t < 8; ++t) Vt[(c + t) * VSTR + j] = e[t];
      }
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        const __nv_bfloat16* kr = &Ks[(nt * 8 + gq) * KSTR + kk * 16 + 2 * tg];
        mma_16816(s[nt], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + nt * 8 + 2 * tg + e;
          const bool valid = kp < Skv && kp <= qlim[h];
          const float x = valid ? s[nt][2 * h + e] * scale : -CUDART_INF_F;
          s[nt][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);           // finite: m starts at kNegInf
      const float corr = expf(m[h] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[nt][2 * h + e] - m_new);   // masked: exp(-inf) = 0
          s[nt][2 * h + e] = p;
          rs += p;
        }
      }
      l[h] = l[h] * corr + rs;        // this thread's columns; the 4 of a row sum at the end
      m[h] = m_new;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        acc[dn][2 * h] *= corr;
        acc[dn][2 * h + 1] *= corr;
      }
    }

#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const __nv_bfloat16* vr = &Vt[(dn * 8 + gq) * VSTR + kk * 16 + 2 * tg];
        mma_16816(acc[dn], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float L = l[h];
    L += __shfl_xor_sync(0xffffffffu, L, 1);
    L += __shfl_xor_sync(0xffffffffu, L, 2);
    if (qrow[h] == nullptr) continue;
    const float l_safe = L == 0.f ? 1.f : L;
    __nv_bfloat16* dst = o + (qrow[h] - q) + 2 * tg;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(acc[dn][2 * h] / l_safe,
                                                         acc[dn][2 * h + 1] / l_safe);
      *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8) = pair;
    }
  }
}

template <int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                        int Skv, int Hq, int Hkv, int causal, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_simt_kernel<float, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  const dim3 grid((Sq * G + ROWS - 1) / ROWS, Hkv, B);
  flash_fwd_simt_kernel<float, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Skv, Hq, Hkv, causal, q_offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Skv, int Hq, int Hkv, int causal, int q_offset, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const dim3 grid((Sq * G + MMA_ROWS - 1) / MMA_ROWS, Hkv, B);
  flash_fwd_mma_kernel<D><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Skv, Hq, Hkv,
      causal, q_offset);
  return cudaGetLastError();
}

// ------------------------------------------- tensor cores, TMA + wgmma (D = 64, 128)

constexpr int WG_ROWS = 64;           // query rows per CTA: one consumer warpgroup
constexpr int WG_BK = 64;             // keys per ring stage
constexpr int WG_STAGES = 2;          // K/V ring depth
constexpr int WG_THREADS = 128 + 32;  // the consumer warpgroup + one producer warp
constexpr int WG_CTAS_PER_SM = 2;
constexpr int SUB_KV = WG_BK * 128;   // bytes of one [64 keys][64 dims] bf16 sub-tile
constexpr int SUB_Q = WG_ROWS * 128;  // bytes of one [64 rows][64 dims] sub-tile

// Dynamic shared memory, from a 1024-byte aligned base: Q (D/64 sub-tiles),
// the ring (per stage: D/64 K sub-tiles, then D/64 V sub-tiles), barriers.
template <int D>
struct WgLayout {
  static constexpr int NSUB = D / 64;
  static constexpr int RING = NSUB * SUB_Q;
  static constexpr int STAGE = 2 * NSUB * SUB_KV;
  static constexpr int BARS = RING + WG_STAGES * STAGE;
  static constexpr size_t BYTES = 1024 + BARS + 8 * (1 + 2 * WG_STAGES);
};

// Rows of a CTA: P = 64 / G whole positions of one (batch, kv head), row r
// = (position p0 + r / G, query head hk G + r % G); rows past P G or past Sq
// are computed on zeros or stale data and never stored. Row blocks run in
// reverse order (blockIdx.y = 0 is the last, most loaded block).
template <int D>
__global__ void __launch_bounds__(WG_THREADS, WG_CTAS_PER_SM)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                       int Sq, int Skv, int Hq, int Hkv, int causal, int q_offset, int P) {
  using L = WgLayout<D>;
  constexpr int NSUB = L::NSUB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + WG_STAGES;

  const int G = Hq / Hkv;
  const int hk = blockIdx.x % Hkv, b = blockIdx.x / Hkv;
  const int p0 = (gridDim.y - 1 - blockIdx.y) * P;
  const int p_last = min(p0 + P, Sq) - 1;
  const int kv_end = max(causal ? min(Skv, q_offset + p_last + 1) : Skv, 0);
  const int ntiles = (kv_end + WG_BK - 1) / WG_BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);      // every consumer thread releases the stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {                    // producer: one thread issues every load
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, NSUB * 128 * G * P);
      for (int j = 0; j < NSUB; ++j)
        tma_load_5d(smem + j * SUB_Q, &qmap, qbar, j * 64, 0, hk, p0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % WG_STAGES;
        if (t >= WG_STAGES) mbar_wait(&empty[s], (t / WG_STAGES - 1) & 1);
        mbar_arrive_expect_tx(&full[s], L::STAGE);
        uint8_t* st = smem + L::RING + s * L::STAGE;
        for (int j = 0; j < NSUB; ++j) {
          tma_load_4d(st + j * SUB_KV, &kmap, &full[s], j * 64, hk, t * WG_BK, b);
          tma_load_4d(st + (NSUB + j) * SUB_KV, &vmap, &full[s], j * 64, hk, t * WG_BK, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's rows are g and g + 8 of its warp's 16
  const int gq = lane >> 2, tq = lane & 3;
  const float sl2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));  // scale * log2(e)
  int qlim[2];
  __nv_bfloat16* orow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gq + 8 * h;
    const int pos = p0 + r / G, g = r % G;
    if (r < P * G && pos < Sq) {
      qlim[h] = causal ? min(q_offset + pos, Skv - 1) : Skv - 1;
      orow[h] = o + ((static_cast<size_t>(b) * Sq + pos) * Hq + hk * G + g) * D;
    } else {
      qlim[h] = -1;
      orow[h] = nullptr;
    }
  }
  // the last key every row of the CTA sees: tiles up to it need no mask
  const int open_end = min(causal ? q_offset + p0 : Skv - 1, Skv - 1);

  float sacc[32], oacc[NSUB][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sacc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NSUB; ++j) oacc[j][i] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % WG_STAGES;
    mbar_wait(&full[s], (t / WG_STAGES) & 1);
    const uint8_t* kt = smem + L::RING + s * L::STAGE;
    const uint8_t* vt = kt + NSUB * SUB_KV;

    // S = Q K^T: one wgmma chain, both operands K-major in shared memory
    reg_fence(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sacc, wgmma_desc(smem + (kk / 4) * SUB_Q + (kk % 4) * 32, 16),
               wgmma_desc(kt + (kk / 4) * SUB_KV + (kk % 4) * 32, 16), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sacc);

    // online softmax on the raw scores, m in the log2 domain (p =
    // 2^(s sl2 - m), one FFMA and one ex2); only tiles past open_end are masked
    const int k0 = t * WG_BK;
    const bool masked = k0 + WG_BK - 1 > open_end;
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sacc[4 * i + 2 * h + e];
          if (masked && k0 + 8 * i + 2 * tq + e > qlim[h]) x = -CUDART_INF_F;
          sacc[4 * i + 2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * sl2);  // finite: m starts at kNegInf
      corr[h] = ex2_ftz(m[h] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2_ftz(fmaf(sacc[4 * i + 2 * h + e], sl2, -m_new));  // masked: 0
          sacc[4 * i + 2 * h + e] = p;
          rs += p;
        }
      }
      l[h] = l[h] * corr[h] + rs;                // this thread's columns; the quad sums at the end
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NSUB; ++j) {
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[j][i] *= corr[(i >> 1) & 1];
    }

    // O += P V: P (rounded to bf16) as the register A operand, V read
    // row-major through the descriptor's transpose bit
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
    }
#pragma unroll
    for (int j = 0; j < NSUB; ++j) reg_fence(oacc[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < NSUB; ++j)
        wgmma_rs_tb(oacc[j], pa[kk], wgmma_desc(vt + j * SUB_KV + kk * 16 * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NSUB; ++j) reg_fence(oacc[j]);
    reg_fence(pa);                    // pa stays put until P V has read it
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float L_ = l[h];
    L_ += __shfl_xor_sync(0xffffffffu, L_, 1);
    L_ += __shfl_xor_sync(0xffffffffu, L_, 2);
    if (orow[h] == nullptr) continue;
    const float l_safe = L_ == 0.f ? 1.f : L_;
#pragma unroll
    for (int j = 0; j < NSUB; ++j) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(oacc[j][4 * i + 2 * h] / l_safe,
                                                           oacc[j][4 * i + 2 * h + 1] / l_safe);
        *reinterpret_cast<__nv_bfloat162*>(orow[h] + j * 64 + 8 * i + 2 * tq) = pair;
      }
    }
  }
}

// ------------------------------------------------------------------ host

// cuTensorMapEncodeTiled is a driver-API function; it is reached through the
// runtime's cudaGetDriverEntryPoint so that the library links no -lcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// a bf16 map with 128-byte swizzle; elements out of bounds read as zero
bool encode_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct FlashMaps {
  CUtensorMap q, k, v;
};

// q as [B][Sq][Hkv][G][D] with a box of 64 dims x G heads x P positions (the
// CTA's rows, in row order); k and v as [B][Skv][Hkv][D], boxes of 64 x 64
bool encode_flash_maps(FlashMaps& m, const void* q, const void* k, const void* v, int B,
                       int Sq, int Skv, int Hq, int Hkv, int D, int P) {
  const cuuint64_t G = Hq / Hkv, e = sizeof(__nv_bfloat16);
  const cuuint64_t qdims[5] = {cuuint64_t(D), G, cuuint64_t(Hkv), cuuint64_t(Sq), cuuint64_t(B)};
  const cuuint64_t qstrides[4] = {D * e, G * D * e, Hq * D * e, cuuint64_t(Sq) * Hq * D * e};
  const cuuint32_t qbox[5] = {64, cuuint32_t(G), 1, cuuint32_t(P), 1};
  const cuuint64_t kdims[4] = {cuuint64_t(D), cuuint64_t(Hkv), cuuint64_t(Skv), cuuint64_t(B)};
  const cuuint64_t kstrides[3] = {D * e, Hkv * D * e, cuuint64_t(Skv) * Hkv * D * e};
  const cuuint32_t kbox[4] = {64, 1, WG_BK, 1};
  return encode_map(&m.q, q, 5, qdims, qstrides, qbox) &&
         encode_map(&m.k, k, 4, kdims, kstrides, kbox) &&
         encode_map(&m.v, v, 4, kdims, kstrides, kbox);
}

// The maps of the last few calls of this host thread, by their inputs: a
// serve program calls the kernel with the same shapes, and the caching
// allocator often hands out the same addresses, so most calls skip the
// encoding (a few microseconds of host time, chip_smoke.py logs it).
const FlashMaps* cached_flash_maps(const void* q, const void* k, const void* v, int B, int Sq,
                                   int Skv, int Hq, int Hkv, int D, int P) {
  struct Entry {
    const void *q, *k, *v;
    int dims[6];
    FlashMaps maps;
  };
  constexpr int N = 8;
  thread_local Entry cache[N] = {};
  thread_local int next = 0;
  const int dims[6] = {B, Sq, Skv, Hq, Hkv, D};
  for (Entry& e : cache) {
    if (e.q == q && e.k == k && e.v == v && std::equal(dims, dims + 6, e.dims)) return &e.maps;
  }
  Entry& e = cache[next];
  if (!encode_flash_maps(e.maps, q, k, v, B, Sq, Skv, Hq, Hkv, D, P)) {
    e.q = nullptr;
    return nullptr;
  }
  e.q = q;
  e.k = k;
  e.v = v;
  std::copy(dims, dims + 6, e.dims);
  next = (next + 1) % N;
  return &e.maps;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                         int Skv, int Hq, int Hkv, int causal, int q_offset,
                         cudaStream_t stream) {
  using L = WgLayout<D>;
  const int G = Hq / Hkv;
  if (G > WG_ROWS) return cudaErrorInvalidValue;
  if (Skv == 0)                       // no keys: every row is fully masked
    return cudaMemsetAsync(o, 0, sizeof(__nv_bfloat16) * B * Sq * Hq * D, stream);
  const int P = WG_ROWS / G;
  const FlashMaps* maps = cached_flash_maps(q, k, v, B, Sq, Skv, Hq, Hkv, D, P);
  if (maps == nullptr) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::BYTES));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(Hkv * B, (Sq + P - 1) / P);
  flash_fwd_wgmma_kernel<D><<<grid, WG_THREADS, L::BYTES, stream>>>(
      maps->q, maps->k, maps->v, static_cast<__nv_bfloat16*>(o), Sq, Skv, Hq, Hkv, causal,
      q_offset, P);
  return cudaGetLastError();
}

cudaError_t dispatch(int dtype, int D, const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Skv, int Hq, int Hkv, int causal, int q_offset,
                     cudaStream_t s) {
  if (dtype == kBFloat16) {
    switch (D) {
      case 32: return launch_mma<32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
      case 64: return launch_wgmma<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
      case 128: return launch_wgmma<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == kFloat32) {
    switch (D) {
      case 32: return launch_simt<32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
      case 64: return launch_simt<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
      case 128: return launch_simt<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// q: [B,Sq,Hq,D]; k, v: [B,Skv,Hkv,D]; o: [B,Sq,Hq,D]; all contiguous, one dtype
// (0 = f32, 1 = bf16), 16-byte aligned. Launches on `stream`, does not
// synchronise, returns cudaGetLastError() of the launch.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int dtype, int B, int Sq, int Skv, int Hq, int Hkv,
                                     int D, int causal, int q_offset, void* stream) {
  return repro::dispatch(dtype, D, q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, q_offset,
                         static_cast<cudaStream_t>(stream));
}

// Host microseconds to encode the three tensor maps of one bf16 call (mean of
// `iters`; -1 if encoding fails): what building the descriptors per call costs.
extern "C" double repro_flash_tensor_map_us(const void* q, const void* k, const void* v, int B,
                                            int Sq, int Skv, int Hq, int Hkv, int D,
                                            int iters) {
  const int P = repro::WG_ROWS / (Hq / Hkv);
  repro::FlashMaps maps;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (!repro::encode_flash_maps(maps, q, k, v, B, Sq, Skv, Hq, Hkv, D, P)) return -1.0;
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / iters;
}
