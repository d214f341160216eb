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
// Design: the sweep of decode_sweep.cuh (one CTA of 8 warps per (kv head,
// batch row), the group's query heads in registers, key groups of D/8 lanes
// with 16-byte loads, shuffle and shared-memory merges), with key t of row b
// at (b * S + t) * Hkv * D, up to min(length, S).
// - Known gap: B * Hkv CTAs (32 at B=4, Hkv=8) on 132 SMs. Splitting S
//   across CTAs with a second merge pass is the redesign's work.
#include "decode_sweep.cuh"

namespace repro {
namespace {

struct ContiguousKeys {
  size_t row;                         // elements between positions (Hkv * D)
  __device__ __forceinline__ size_t operator()(int t) const { return t * row; }
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(decode::THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
              const int* __restrict__ length, T* __restrict__ o, int S, int Hkv) {
  const int hk = blockIdx.x, b = blockIdx.y;
  int len = length[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const size_t base = (static_cast<size_t>(b) * S * Hkv + hk) * D;
  decode::sweep<T, D, G>(q, kc + base, vc + base,
                         ContiguousKeys{static_cast<size_t>(Hkv) * D}, len, o, b, hk, Hkv);
}

template <typename T, int D, int G>
struct Launch {
  static cudaError_t run(const void* q, const void* k, const void* v, const int* length,
                         void* o, int B, int S, int Hkv, cudaStream_t stream) {
    decode_kernel<T, D, G><<<dim3(Hkv, B), decode::THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), length,
        static_cast<T*>(o), S, Hkv);
    return cudaGetLastError();
  }
};

}  // namespace
}  // namespace repro

// q: [B,Hq,D]; k, v: [B,S,Hkv,D]; length: int32 [B] on the device; o: [B,Hq,D];
// contiguous, one dtype (0 = f32, 1 = bf16), 16-byte aligned. Launches on
// `stream`, does not synchronise, returns cudaGetLastError() of the launch.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* length, void* o, int dtype, int B, int S,
                                      int Hq, int Hkv, int D, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  return repro::decode::dispatch<repro::Launch>(
      dtype, D, Hq / Hkv, q, k, v, static_cast<const int*>(length), o, B, S, Hkv,
      static_cast<cudaStream_t>(stream));
}
