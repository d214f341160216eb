// Decode attention for Hopper (sm_90a): one query token per row against a
// contiguous KV cache, with a per-row length.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::_dec_kernel
// (entry decode_attention, :35 and :82). It computes what that kernel
// computes: the row length is clipped to S (:49), positions >= length are
// dead, V is never read under the mask, so NaN written past length cannot
// leak (:59), and a row with l = 0 (length 0) is exactly 0.
//
// What bounds it on the H100: bytes. At llama3.2-3b's decode shape (B=4,
// S=528, Hkv=8, D=128, bf16) one layer call reads ~8.7 MB of K/V at full
// length and does ~26 MFLOP, ~2.6 us at 3.35 TB/s. The design keeps every
// K/V byte read exactly once with 16-byte loads and several loads in flight
// per thread.
//
// Design:
// - One CTA of 8 warps per (kv head, batch row). The G = Hq/Hkv query heads
//   of the group ride in registers of every thread, so each K/V row is
//   loaded once for all G heads.
// - A key group of D/8 lanes (bf16; D/4 for f32) covers one key row with one
//   16-byte load per lane; each warp holds 32/(D/8) key groups, and every
//   key group sweeps its own stride of keys (4 keys in flight) up to
//   min(length, S) as an independent online softmax (m, l, acc in f32).
// - At the end the key groups of a warp merge by shuffles and the warps
//   merge through shared memory with the log-sum-exp rescale.
// - Known gap: B * Hkv CTAs (32 at B=4, Hkv=8) on 132 SMs. Splitting S
//   across CTAs with a second merge pass is the redesign's work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int NW = 8;                 // warps per CTA
constexpr int THREADS = NW * 32;

template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
              const int* __restrict__ length, T* __restrict__ o, int S, int Hkv) {
  constexpr int V = kVec<T>;          // elements per 16-byte load
  constexpr int LPG = D / V;          // lanes per key group
  constexpr int GPW = 32 / LPG;       // key groups per warp
  constexpr int NG = NW * GPW;        // key groups per CTA
  constexpr int U = G >= 8 ? 2 : 4;   // keys in flight per key group
  static_assert(LPG >= 1 && LPG <= 32 && 32 % LPG == 0, "unsupported head dim");
  __shared__ float sm_m[NW][G], sm_l[NW][G];
  __shared__ __align__(16) float sm_acc[NW][G][D];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / LPG, lig = lane % LPG;
  const int gid = warp * GPW + grp;
  const int Hq = Hkv * G;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  int len = length[b];
  len = len < 0 ? 0 : (len > S ? S : len);

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

  const size_t row = static_cast<size_t>(Hkv) * D;        // elements between positions
  const T* kb = kc + (static_cast<size_t>(b) * S * Hkv + hk) * D + lig * V;
  const T* vb = vc + (static_cast<size_t>(b) * S * Hkv + hk) * D + lig * V;

  // the loop bound is warp-uniform so every lane reaches the shuffles
  for (int base = 0; base < len; base += NG * U) {
    float kr[U][V], vr[U][V];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * NG + gid;
      valid[u] = j < len;
      if (valid[u]) {
        load_vec(kb + j * row, kr[u]);
        load_vec(vb + j * row, vr[u]);
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

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const int* length, void* o,
                   int B, int S, int Hkv, cudaStream_t stream) {
  decode_kernel<T, D, G><<<dim3(Hkv, B), THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), length,
      static_cast<T*>(o), S, Hkv);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v, const int* len,
                       void* o, int B, int S, int Hkv, cudaStream_t s) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, k, v, len, o, B, S, Hkv, s);
    case 2: return launch<T, D, 2>(q, k, v, len, o, B, S, Hkv, s);
    case 3: return launch<T, D, 3>(q, k, v, len, o, B, S, Hkv, s);
    case 4: return launch<T, D, 4>(q, k, v, len, o, B, S, Hkv, s);
    case 8: return launch<T, D, 8>(q, k, v, len, o, B, S, Hkv, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(int D, int G, const void* q, const void* k, const void* v,
                       const int* len, void* o, int B, int S, int Hkv, cudaStream_t s) {
  switch (D) {
    case 32: return dispatch_g<T, 32>(G, q, k, v, len, o, B, S, Hkv, s);
    case 64: return dispatch_g<T, 64>(G, q, k, v, len, o, B, S, Hkv, s);
    case 128: return dispatch_g<T, 128>(G, q, k, v, len, o, B, S, Hkv, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// q: [B,Hq,D]; k, v: [B,S,Hkv,D]; length: int32 [B] on the device; o: [B,Hq,D];
// contiguous, one dtype (0 = f32, 1 = bf16), 16-byte aligned. Launches on
// `stream`, does not synchronise, returns cudaGetLastError() of the launch.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* length, void* o, int dtype, int B, int S,
                                      int Hq, int Hkv, int D, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  if (dtype == repro::kBFloat16)
    return repro::dispatch_d<__nv_bfloat16>(D, G, q, k, v, len, o, B, S, Hkv, s);
  if (dtype == repro::kFloat32)
    return repro::dispatch_d<float>(D, G, q, k, v, len, o, B, S, Hkv, s);
  return cudaErrorInvalidValue;
}
