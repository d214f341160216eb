// Paged decode attention for Hopper (sm_90a): one query token per row against
// a KV cache held in a shared pool of fixed-size pages, read through a page
// table.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attention.py::
// _paged_kernel (entry paged_decode_attention, :40 and :87). It computes what
// that kernel computes: an online softmax over one sequence's chain of pages,
// positions >= length masked, V never read under the mask (so NaN in the null
// page 0 or in unmapped pages cannot leak, :60-64), and a row with l = 0
// (length 0) exactly 0 (:82-84).
//
// What bounds it on the H100: bytes. At the decode tier's shape (B=8 slots,
// Hq=24, Hkv=8, D=128, page_size 16, 33 pages per row, bf16) one layer call
// at length 528 reads ~17.3 MB of live K/V and does ~52 MFLOP, ~5.2 us at
// 3.35 TB/s. A key row is still 256 contiguous bytes inside its page, so
// every load stays a 16-byte vector load.
//
// Design: the sweep of decode_sweep.cuh (one CTA of 8 warps per (kv head,
// row), shared with the contiguous kernel), with key t of row b at
//   table[b, t / page_size] * page_size * Hkv * D + (t % page_size) * Hkv * D.
// - The sweep stops at min(length, max_pages * page_size): pages past
//   ceil(length / page_size) are never loaded (the Pallas grid walks all
//   max_pages of every row, :104).
// - Which key group takes key t, and every merge, depend on t alone: a
//   shuffled page layout gives bit-identical output, and so does the
//   contiguous kernel on the same logical cache.
// - Page ids are clamped to [0, P) as JAX's gather clamps, so a bad table
//   cannot read outside the pool.
// - Known gap: B * Hkv CTAs (64 at B=8, Hkv=8) on 132 SMs. Splitting the
//   pages across CTAs with the log-sum-exp merge is the redesign's work.
#include "decode_sweep.cuh"

namespace repro {
namespace {

struct PagedKeys {
  const int* table;                   // this row's page ids [max_pages]
  int page_size;
  int n_pages;                        // P, pages in the pool
  size_t row;                         // elements between positions (Hkv * D)
  __device__ __forceinline__ size_t operator()(int t) const {
    int page = table[t / page_size];
    page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
    return (static_cast<size_t>(page) * page_size + t % page_size) * row;
  }
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(decode::THREADS)
paged_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
             const int* __restrict__ table, const int* __restrict__ length,
             T* __restrict__ o, int P, int page_size, int max_pages, int Hkv) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int cap = max_pages * page_size;
  int len = length[b];
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const size_t head = static_cast<size_t>(hk) * D;
  const PagedKeys keys{table + static_cast<size_t>(b) * max_pages, page_size, P,
                       static_cast<size_t>(Hkv) * D};
  decode::sweep<T, D, G>(q, kp + head, vp + head, keys, len, o, b, hk, Hkv);
}

template <typename T, int D, int G>
struct Launch {
  static cudaError_t run(const void* q, const void* k, const void* v, const int* table,
                         const int* length, void* o, int B, int P, int page_size,
                         int max_pages, int Hkv, cudaStream_t stream) {
    paged_kernel<T, D, G><<<dim3(Hkv, B), decode::THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), table,
        length, static_cast<T*>(o), P, page_size, max_pages, Hkv);
    return cudaGetLastError();
  }
};

}  // namespace
}  // namespace repro

// q: [B,Hq,D]; k_pages, v_pages: [P,page_size,Hkv,D]; table: int32
// [B,max_pages]; length: int32 [B]; o: [B,Hq,D]; all on the device,
// contiguous, q/k/v/o of one dtype (0 = f32, 1 = bf16), 16-byte aligned.
// Launches on `stream`, does not synchronise, returns cudaGetLastError() of
// the launch.
extern "C" int repro_paged_decode_attention(const void* q, const void* k_pages,
                                            const void* v_pages, const void* table,
                                            const void* length, void* o, int dtype, int B,
                                            int P, int page_size, int max_pages, int Hq,
                                            int Hkv, int D, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || P <= 0 || page_size <= 0 || max_pages <= 0)
    return cudaErrorInvalidValue;
  return repro::decode::dispatch<repro::Launch>(
      dtype, D, Hq / Hkv, q, k_pages, v_pages, static_cast<const int*>(table),
      static_cast<const int*>(length), o, B, P, page_size, max_pages, Hkv,
      static_cast<cudaStream_t>(stream));
}
