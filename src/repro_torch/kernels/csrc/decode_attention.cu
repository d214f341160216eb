// Decode attention for Hopper (sm_90a): one query token per row against a
// contiguous KV cache, with a per-row length.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::_dec_kernel
// (entry decode_attention, :35 and :82). It computes what that kernel
// computes: an online softmax in f32 with scale 1/sqrt(D), the row length
// clipped to S (:49), positions >= length dead and V never read under the
// mask, so NaN written past length cannot leak (:59), P rounded to the
// cache's dtype before P V (:70-72), and a row with l = 0 (length 0)
// exactly 0. Any Hq % Hkv == 0, head dims 32, 64 and 128.
//
// What bounds it on the H100: bytes. At llama3.2-3b's decode shape (B=4,
// S=528, Hq=24, Hkv=8, D=128, bf16) one layer call reads 8.65 MB of K/V at
// full length and does 26 MFLOP: 2.6 us at 3.35 TB/s, 0.03 us at the bf16
// tensor-core peak.
//
// Design: decode_sweep.cuh. The keys are split into chunks of 64 across CTAs
// (9 x 8 x 4 = 288 CTAs at that shape, where one CTA per (row, kv head)
// gave 32 on 132 SMs), so enough K/V bytes are in flight to near the byte
// bound; each warp loads its 16 key rows by cp.async and runs both products
// on the tensor cores with the group's query heads as the M rows, so the
// per-key work is a few mma instructions instead of a shuffle-reduced dot
// per (key, head); a second, small kernel merges the f32 partials in split
// order. Key t of row b is at (b * S + t) * Hkv * D, up to min(length, S).
#include "decode_sweep.cuh"

namespace repro {
namespace {

struct ContiguousKeys {
  size_t row;                         // elements between positions (Hkv * D)
  __device__ __forceinline__ size_t operator()(int t) const { return t * row; }
};

template <typename T, int D>
__global__ void __launch_bounds__(decode::THREADS)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const int* __restrict__ length,
                      float* __restrict__ scratch, int B, int S, int Hkv, int G, int NS) {
  pdl_launch_dependents();
  decode::Split sp;
  if (!decode::cta_split(length, S, B, Hkv, G, NS, D, scratch, sp)) return;
  const size_t base = (static_cast<size_t>(sp.b) * S * Hkv + sp.hk) * D;
  decode::partial<D>(q, kc + base, vc + base, ContiguousKeys{static_cast<size_t>(Hkv) * D},
                     sp);
}

template <typename T, int D>
struct Launch {
  static cudaError_t run(const void* q, const void* k, const void* v, const int* length,
                         void* o, float* scratch, int B, int S, int Hkv, int G, int NS,
                         cudaStream_t stream) {
    const dim3 grid(NS, Hkv * decode::row_tiles(G), B);
    decode_partial_kernel<T, D><<<grid, decode::THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), length,
        scratch, B, S, Hkv, G, NS);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return decode::launch_merge<T>(scratch, length, o, B, Hkv, G, D, NS, S, stream);
  }
};

}  // namespace
}  // namespace repro

// q: [B,Hq,D]; k, v: [B,S,Hkv,D]; length: int32 [B] on the device; o: [B,Hq,D];
// contiguous, one dtype (0 = f32, 1 = bf16), 16-byte aligned. scratch: f32
// [B * Hkv * n_splits * (Hq / Hkv) * (D + 2)], n_splits = max(1, ceil(S / 64)).
// Launches the split kernel and the merge on `stream`, does not synchronise,
// returns the first CUDA error of the two launches.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* length, void* o, void* scratch, int dtype,
                                      int B, int S, int Hq, int Hkv, int D, int n_splits,
                                      void* stream) {
  if (B <= 0 || S < 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      n_splits != repro::decode::n_splits(S))
    return cudaErrorInvalidValue;
  return repro::decode::dispatch<repro::Launch>(
      dtype, D, q, k, v, static_cast<const int*>(length), o, static_cast<float*>(scratch), B,
      S, Hkv, Hq / Hkv, n_splits, static_cast<cudaStream_t>(stream));
}
