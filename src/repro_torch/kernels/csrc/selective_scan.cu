// Mamba selective scan for Hopper (sm_90a):
//   h_t = exp(dt_t * A) h_{t-1} + (dt_t x_t) B_t,   y_t = <h_t, C_t> + D x_t,
//   A = -exp(a_log), h_0 = h0 or 0; returns y (x's dtype) and h_S (f32).
//
// Replaces the TPU kernel src/repro/kernels/selective_scan.py::_scan_kernel
// (entry selective_scan, :26 and :60; pallas_call :85). That kernel walks a
// grid of (B, Di / 512, S / 64) with the [512, Ds] state in VMEM and a
// fori_loop over the steps of each chunk; it asserts Di % 512 == 0 and pads S
// with dt = 0. Here the state lives in registers instead, and the ragged
// channel block and the tail of S are masked, with no padded copies.
//
// What bounds it on the H100. At jamba-1.5-large's prefill shape (B=4,
// S=512, Di=16384, Ds=16; x bf16, dt f32) a call moves ~274 MB (x, dt and y,
// h out, B, C and the per-channel parameters): ~0.082 ms at 3.35 TB/s. It
// also takes B*S*Di*Ds = 537 M exponentials; the special-function units
// give 16 a clock per SM, ~0.13 ms at 132 SMs and 1.98 GHz. So the
// exponentials, not the bytes, set the floor; the multiply-adds beside them
// (~6 flops per exponential) need ~0.05 ms of the f32 pipes.
//
// Design: one thread per (b, channel), its Ds state values in registers, A
// pre-scaled by log2(e) so each decay is one multiply and one ex2. A CTA
// holds 128 neighbouring channels of one sequence, so every load of x and dt
// (channel-contiguous, [B, S, Di]) is coalesced across the warp; the CTA
// stages each chunk of 64 steps of B_t and C_t ([S, Ds], shared by all
// channels) in shared memory, read as broadcasts. x and dt of 8 steps are
// loaded together ahead of their use. Known gap: 65,536 threads at the
// path's shape fill a quarter of the card's thread slots; splitting Ds over
// lanes or S over CTAs (a chunked scan with a second pass) is the redesign.
#include "common.cuh"

namespace repro {
namespace {

constexpr int THREADS = 128;        // channels per CTA
constexpr int CHUNK = 64;           // steps of B_t / C_t staged in shared memory
constexpr int UNROLL = 8;           // steps whose x / dt loads are issued together
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x, y: [B,S,Di]; dt: [B,S,Di] f32; a_log: [Di,DS]; bm, cm: [B,S,DS]; d_skip:
// [Di]; h0 (or null), hout: [B,Di,DS]; all f32 but x and y. grid (ceil(Di/128), B).
template <typename T, int DS>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ a_log, const float* __restrict__ bm,
            const float* __restrict__ cm, const float* __restrict__ d_skip,
            const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hout, int S,
            int Di) {
  __shared__ float sb[CHUNK * DS];
  __shared__ float sc[CHUNK * DS];
  const int b = blockIdx.y;
  const int ch = blockIdx.x * THREADS + threadIdx.x;
  const bool live = ch < Di;
  const int c = live ? ch : Di - 1;           // masked lanes load a real channel, store nothing
  const size_t hrow = (static_cast<size_t>(b) * Di + c) * DS;

  float a2[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a2[s] = -expf(a_log[static_cast<size_t>(c) * DS + s]) * kLog2e;
    h[s] = h0 != nullptr ? h0[hrow + s] : 0.f;
  }
  const float dsk = d_skip[c];
  const size_t row0 = static_cast<size_t>(b) * S;   // first step of this sequence

  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    const int n = min(CHUNK, S - t0);
    __syncthreads();                          // the previous chunk's readers are done
    for (int i = threadIdx.x; i < n * DS; i += THREADS) {
      sb[i] = bm[(row0 + t0) * DS + i];
      sc[i] = cm[(row0 + t0) * DS + i];
    }
    __syncthreads();
    for (int t = 0; t < n; t += UNROLL) {
      float xv[UNROLL], dv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        xv[u] = 0.f;
        dv[u] = 0.f;
        if (t + u < n) {
          const size_t off = (row0 + t0 + t + u) * Di + c;
          xv[u] = to_float(x[off]);
          dv[u] = dt[off];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (t + u >= n) break;                // uniform across the CTA
        const float* bt = sb + (t + u) * DS;
        const float* ct = sc + (t + u) * DS;
        const float dx = dv[u] * xv[u];
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < DS; ++s) {
          h[s] = exp2_approx(dv[u] * a2[s]) * h[s] + dx * bt[s];
          acc += h[s] * ct[s];
        }
        if (live) store(y + (row0 + t0 + t + u) * Di + c, acc + xv[u] * dsk);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < DS; ++s) hout[hrow + s] = h[s];
  }
}

template <typename T, int DS>
cudaError_t launch(const void* x, const void* dt, const void* a_log, const void* bm,
                   const void* cm, const void* d_skip, const void* h0, void* y, void* hout,
                   int B, int S, int Di, cudaStream_t stream) {
  const dim3 grid((Di + THREADS - 1) / THREADS, B);
  scan_kernel<T, DS><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(d_skip),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(hout), S, Di);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ds(const void* x, const void* dt, const void* a_log, const void* bm,
                      const void* cm, const void* d_skip, const void* h0, void* y, void* hout,
                      int B, int S, int Di, int Ds, cudaStream_t stream) {
  switch (Ds) {
    case 4: return launch<T, 4>(x, dt, a_log, bm, cm, d_skip, h0, y, hout, B, S, Di, stream);
    case 8: return launch<T, 8>(x, dt, a_log, bm, cm, d_skip, h0, y, hout, B, S, Di, stream);
    case 16: return launch<T, 16>(x, dt, a_log, bm, cm, d_skip, h0, y, hout, B, S, Di, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// x, y: [B,S,Di] in one dtype (0 = f32, 1 = bf16); dt: [B,S,Di] f32; a_log:
// [Di,Ds] f32; bm, cm: [B,S,Ds] f32; d_skip: [Di] f32; h0: [B,Di,Ds] f32 or
// null (a zero state); hout: [B,Di,Ds] f32. Contiguous. Ds in {4, 8, 16}.
// Launches on `stream`, does not synchronise, returns cudaGetLastError() of
// the launch.
extern "C" int repro_selective_scan(const void* x, const void* dt, const void* a_log,
                                    const void* bm, const void* cm, const void* d_skip,
                                    const void* h0, void* y, void* hout, int dtype, int B,
                                    int S, int Di, int Ds, void* stream) {
  if (B <= 0 || S <= 0 || Di <= 0 || B > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return repro::launch_ds<__nv_bfloat16>(x, dt, a_log, bm, cm, d_skip, h0, y, hout, B, S, Di,
                                           Ds, s);
  if (dtype == repro::kFloat32)
    return repro::launch_ds<float>(x, dt, a_log, bm, cm, d_skip, h0, y, hout, B, S, Di, Ds, s);
  return cudaErrorInvalidValue;
}
