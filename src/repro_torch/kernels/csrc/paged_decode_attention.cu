// Paged decode attention for Hopper (sm_90a): one query token per row against
// a KV cache held in a shared pool of fixed-size pages, read through a page
// table.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attention.py::
// _paged_kernel (entry paged_decode_attention, :40 and :87). It computes what
// that kernel computes: an online softmax over one sequence's chain of pages,
// positions >= length masked, V never read under the mask (so NaN in the null
// page 0 or in unmapped pages cannot leak, :60-64), and a row with l = 0
// (length 0) exactly 0 (:82-84). Any Hq % Hkv == 0, head dims 32, 64, 128.
//
// What bounds it on the H100: bytes. At the decode tier's shape (B=8 slots,
// Hq=24, Hkv=8, D=128, page_size 16, 33 pages per row, bf16) one layer call
// at length 528 reads 17.3 MB of live K/V and does 52 MFLOP: 5.2 us at
// 3.35 TB/s. A key row is still 256 contiguous bytes inside its page, so
// every copy stays a 16-byte cp.async.
//
// Design: decode_sweep.cuh, shared with the contiguous kernel: the logical
// keys are split into chunks of 64 across CTAs (9 x 8 x 8 = 576 CTAs at that
// shape, where one CTA per (row, kv head) gave 64 on 132 SMs), the group's
// query heads are the M rows of the tensor-core products, and a small
// kernel merges the partials in split order. Key t of row b is at
//   table[b, t / page_size] * page_size * Hkv * D + (t % page_size) * Hkv * D.
// - The sweep stops at min(length, max_pages * page_size): pages past
//   ceil(length / page_size) are never loaded (the Pallas grid walks all
//   max_pages of every row, :104).
// - Which CTA and warp take key t, and every merge, depend on t alone: a
//   shuffled page layout gives bit-identical output, and so does the
//   contiguous kernel on the same logical cache.
// - Page ids are clamped to [0, P) as JAX's gather clamps, so a bad table
//   cannot read outside the pool.
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

template <typename T, int D>
__global__ void __launch_bounds__(decode::THREADS)
paged_partial_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ table,
                     const int* __restrict__ length, float* __restrict__ scratch, int B, int P,
                     int page_size, int max_pages, int Hkv, int G, int NS) {
  pdl_launch_dependents();
  decode::Split sp;
  if (!decode::cta_split(length, max_pages * page_size, B, Hkv, G, NS, D, scratch, sp)) return;
  const size_t head = static_cast<size_t>(sp.hk) * D;
  const PagedKeys keys{table + static_cast<size_t>(sp.b) * max_pages, page_size, P,
                       static_cast<size_t>(Hkv) * D};
  decode::partial<D>(q, kp + head, vp + head, keys, sp);
}

template <typename T, int D>
struct Launch {
  static cudaError_t run(const void* q, const void* k, const void* v, const int* table,
                         const int* length, void* o, float* scratch, int B, int P,
                         int page_size, int max_pages, int Hkv, int G, int NS,
                         cudaStream_t stream) {
    const dim3 grid(NS, Hkv * decode::row_tiles(G), B);
    paged_partial_kernel<T, D><<<grid, decode::THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), table,
        length, scratch, B, P, page_size, max_pages, Hkv, G, NS);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return decode::launch_merge<T>(scratch, length, o, B, Hkv, G, D, NS,
                                   max_pages * page_size, stream);
  }
};

}  // namespace
}  // namespace repro

// q: [B,Hq,D]; k_pages, v_pages: [P,page_size,Hkv,D]; table: int32
// [B,max_pages]; length: int32 [B]; o: [B,Hq,D]; all on the device,
// contiguous, q/k/v/o of one dtype (0 = f32, 1 = bf16), 16-byte aligned.
// scratch: f32 [B * Hkv * n_splits * (Hq / Hkv) * (D + 2)], n_splits =
// max(1, ceil(max_pages * page_size / 64)). Launches the split kernel and
// the merge on `stream`, does not synchronise, returns the first CUDA error
// of the two launches.
extern "C" int repro_paged_decode_attention(const void* q, const void* k_pages,
                                            const void* v_pages, const void* table,
                                            const void* length, void* o, void* scratch,
                                            int dtype, int B, int P, int page_size,
                                            int max_pages, int Hq, int Hkv, int D,
                                            int n_splits, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || P <= 0 || page_size <= 0 ||
      max_pages <= 0 || n_splits != repro::decode::n_splits(max_pages * page_size))
    return cudaErrorInvalidValue;
  return repro::decode::dispatch<repro::Launch>(
      dtype, D, q, k_pages, v_pages, static_cast<const int*>(table),
      static_cast<const int*>(length), o, static_cast<float*>(scratch), B, P, page_size,
      max_pages, Hkv, Hq / Hkv, n_splits, static_cast<cudaStream_t>(stream));
}
