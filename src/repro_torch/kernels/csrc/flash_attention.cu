// Prefill attention for Hopper (sm_90a): GQA softmax(Q K^T / sqrt(D)) V,
// causal or bidirectional, with the causal diagonal shifted by q_offset.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_fa_kernel
// (entry flash_attention, :33 and :151). It computes what that kernel
// computes: online softmax with f32 (m, l, acc), a fully masked row gives 0,
// the output is cast to q's dtype.
//
// What bounds it on the H100. For one llama3.2-3b prefill layer (B=4,
// S=512, Hq=24, Hkv=8, D=128, bf16, causal) the call moves ~33.5 MB (q, k,
// v, o) and does ~6.4 GFLOP: ~10 us at 3.35 TB/s against ~6.5 us at the
// 989 TFLOP/s bf16 tensor-core rate, so the card could run it memory-bound.
//
// Two kernels, one contract:
// - bf16 (the serve path): flash_fwd_mma_kernel, whose two products run on
//   the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). P is
//   rounded to bf16 for the PV product, as the JAX reference does. It is
//   bound by the shared-memory traffic that feeds mma.sync and by the
//   softmax between the products; wgmma, TMA staging and a pipelined K/V
//   ring are for the PR that makes it fast.
// - f32 (tests and edge shapes): flash_fwd_simt_kernel, the same loop on the
//   f32 SIMT pipes (67 TFLOP/s peak), exact to f32 rounding.
//
// Layout common to both:
// - One CTA per (batch, kv head, block of query rows), where a row is one
//   (position, query head of the group) pair: the G = Hq/Hkv query heads of
//   a group share every K/V tile the CTA stages, instead of the Pallas
//   grid's one pass over K/V per query head.
// - The CTA loops over K/V tiles and stops at the causal diagonal of its
//   last row; the ragged Skv tail is zero-filled and masked in the kernel
//   (no host-side padding copy).
//
// SIMT kernel: tiles of 32 keys are widened to f32 in shared memory; lane j
// of a warp owns key j and computes its dot product with the warp's 8 rows;
// online softmax per row with a warp max; P goes through shared memory and
// lane d accumulates output dims d, d+32, ... of all 8 rows.
//
// MMA kernel: each warp owns 16 rows, whose Q fragments stay in registers;
// per tile of 64 keys it computes S (16x64) = Q K^T from K staged row-major
// in shared memory, masks and rescales in registers, re-packs S as the A
// fragment of P V, and accumulates O (16xD) from V staged transposed (so
// both B fragments are single 32-bit shared loads; strides are padded so
// the loads are conflict-free).
#include <math_constants.h>

#include "common.cuh"

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

// ------------------------------------------------------------ tensor cores

constexpr int MMA_ROWS = 64;        // query rows per CTA: 16 per warp
constexpr int MMA_BK = 64;          // keys per tile

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layout of mma.m16n8k16 (PTX ISA), g = lane / 4, t = lane % 4:
// A (16x16): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..)
// B (16x8):  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
// C (16x8):  c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
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

cudaError_t dispatch(int dtype, int D, const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Skv, int Hq, int Hkv, int causal, int q_offset,
                     cudaStream_t s) {
  if (dtype == kBFloat16) {
    switch (D) {
      case 32: return launch_mma<32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
      case 64: return launch_mma<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
      case 128: return launch_mma<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
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
