// The one-token attention sweep shared by the contiguous and the paged decode
// kernels (decode_attention.cu, paged_decode_attention.cu). The two differ
// only in where key t of a row lives; each passes a functor that maps the
// logical position t to an element offset from the row's base pointer.
//
// Design (one CTA of 8 warps per (kv head, batch row)):
// - The G = Hq/Hkv query heads of the group ride in registers of every
//   thread, so each K/V row is loaded once for all G heads.
// - A key group of D/8 lanes (bf16; D/4 for f32) covers one key row with one
//   16-byte load per lane; each warp holds 32/(D/8) key groups, and every
//   key group sweeps its own stride of keys (4 keys in flight) up to `len`
//   as an independent online softmax (m, l, acc in f32).
// - At the end the key groups of a warp merge by shuffles and the warps
//   merge through shared memory with the log-sum-exp rescale.
// - Which key group takes key t, and every merge, depend on t alone, never
//   on its address: the same logical cache gives bit-identical results
//   under any page layout, and through the contiguous kernel.
// - Positions >= len are never loaded, so NaN there cannot leak, and a row
//   with len = 0 (l = 0) is exactly 0.
#pragma once

#include "common.cuh"

namespace repro {
namespace decode {

constexpr int NW = 8;                 // warps per CTA
constexpr int THREADS = NW * 32;

// kb, vb: the row's K and V base pointers (kv head `hk` applied, lane
// offset not); key_offset(t): element offset of key t from them.
template <typename T, int D, int G, typename KeyOffset>
__device__ __forceinline__ void sweep(const T* __restrict__ q, const T* __restrict__ kb,
                                      const T* __restrict__ vb, KeyOffset key_offset,
                                      int len, T* __restrict__ o, int b, int hk, int Hkv) {
  constexpr int V = kVec<T>;          // elements per 16-byte load
  constexpr int LPG = D / V;          // lanes per key group
  constexpr int GPW = 32 / LPG;       // key groups per warp
  constexpr int NG = NW * GPW;        // key groups per CTA
  constexpr int U = G >= 8 ? 2 : 4;   // keys in flight per key group
  static_assert(LPG >= 1 && LPG <= 32 && 32 % LPG == 0, "unsupported head dim");
  __shared__ float sm_m[NW][G], sm_l[NW][G];
  __shared__ __align__(16) float sm_acc[NW][G][D];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / LPG, lig = lane % LPG;
  const int gid = warp * GPW + grp;
  const int Hq = Hkv * G;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kb += lig * V;
  vb += lig * V;

  float qv[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g)
    load_vec(q + (static_cast<size_t>(b) * Hq + hk * G + g) * D + lig * V, qv[g]);

  float m[G], l[G], acc[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int t = 0; t < V; ++t) acc[g][t] = 0.f;
  }

  // the loop bound is warp-uniform so every lane reaches the shuffles
  for (int base = 0; base < len; base += NG * U) {
    float kr[U][V], vr[U][V];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * NG + gid;
      valid[u] = j < len;
      if (valid[u]) {
        const size_t off = key_offset(j);
        load_vec(kb + off, kr[u]);
        load_vec(vb + off, vr[u]);
      } else {
#pragma unroll
        for (int t = 0; t < V; ++t) kr[u][t] = vr[u][t] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int t = 0; t < V; ++t) part = fmaf(qv[g][t], kr[u][t], part);
#pragma unroll
        for (int off = LPG / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (valid[u]) {
          const float sc = part * scale;
          const float m_new = fmaxf(m[g], sc);
          const float corr = expf(m[g] - m_new);
          const float p = expf(sc - m_new);
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int t = 0; t < V; ++t) acc[g][t] = fmaf(p, vr[u][t], acc[g][t] * corr);
          m[g] = m_new;
        }
      }
    }
  }

  // merge the key groups of this warp (lanes with the same lig)
#pragma unroll
  for (int off = LPG; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn), c = expf(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][t], off);
        acc[g][t] = acc[g][t] * a + ao * c;
      }
      m[g] = mn;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lig == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int t = 0; t < V; ++t) sm_acc[warp][g][lig * V + t] = acc[g][t];
    }
  }
  __syncthreads();

  // merge the warps: out = sum_w acc_w e^(m_w - M) / sum_w l_w e^(m_w - M)
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, d = i - g * D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = expf(sm_m[w][g] - M);
      L = fmaf(sm_l[w][g], e, L);
      A = fmaf(sm_acc[w][g][d], e, A);
    }
    store(o + (static_cast<size_t>(b) * Hq + hk * G + g) * D + d, A / (L == 0.f ? 1.f : L));
  }
}

// Instantiate `Launch<T, D, G>::run(args...)` for the built head dims and
// group sizes; anything else is cudaErrorInvalidValue.
template <template <typename, int, int> class Launch, typename T, int D, typename... Args>
cudaError_t dispatch_g(int G, Args... args) {
  switch (G) {
    case 1: return Launch<T, D, 1>::run(args...);
    case 2: return Launch<T, D, 2>::run(args...);
    case 3: return Launch<T, D, 3>::run(args...);
    case 4: return Launch<T, D, 4>::run(args...);
    case 8: return Launch<T, D, 8>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <template <typename, int, int> class Launch, typename T, typename... Args>
cudaError_t dispatch_dg(int D, int G, Args... args) {
  switch (D) {
    case 32: return dispatch_g<Launch, T, 32>(G, args...);
    case 64: return dispatch_g<Launch, T, 64>(G, args...);
    case 128: return dispatch_g<Launch, T, 128>(G, args...);
    default: return cudaErrorInvalidValue;
  }
}

template <template <typename, int, int> class Launch, typename... Args>
cudaError_t dispatch(int dtype, int D, int G, Args... args) {
  if (dtype == kBFloat16) return dispatch_dg<Launch, __nv_bfloat16>(D, G, args...);
  if (dtype == kFloat32) return dispatch_dg<Launch, float>(D, G, args...);
  return cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace repro
