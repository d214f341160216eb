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
// also takes B*S*Di*Ds = 537 M (step, state) elements, each one exponential
// and 5 issue slots of the function's own (dt·a, dx·B, the FMA into h, the
// FMA into y, the ex2's own issue). A sub-partition's special-function unit
// takes 8 clocks for a warp's ex2, so with every exponential there the floor
// is 0.128 ms (132 SMs x 4 sub-partitions at 1.98 GHz); the FP32 pipe could
// take a share of them as a polynomial (12 slots), which balances the two
// near 0.108 ms (chip_smoke.scan_bound). So the compute, not the bytes, sets
// the floor.
//
// What holds it (tools/scan_compare.py --parts; PERF.md, row 4): removing
// the exponentials, the x and dt loads, or most B and C reads moves it by
// 10% at most. At B=4 a sub-partition has 4 warps (the grid's 65,536
// threads), too few to cover their own dependent instructions; more warps
// mean more lanes a channel, whose per-step work (x, dt, the reduction and
// store of y) then costs more than they win. Moving a share of the decays to
// the FP32 pipe as a polynomial was measured slower at every share tried
// (1, 2 and 3 of 16), as the SFU is not the limit: every decay is an
// ex2.approx.ftz.f32.
//
// Design:
// - 1 lane a channel with all Ds states in registers where that gives 2
//   warps a sub-partition or more (B=4); else 2 lanes a channel with Ds / 2
//   states each, y summed over the pair with __shfl_xor_sync (B=1). A CTA is
//   4 warps; each warp owns 32 / L neighbouring channels of one sequence and
//   runs a pipeline of its own, so no CTA barrier couples warps.
// - Each warp streams its inputs through a ring of STAGES stages of STEPS
//   steps in shared memory: per stage the [STEPS x channels] tiles of x and
//   dt and the STEPS rows of B and C, by cp.async (16-byte chunks, each lane
//   the same chunks every stage; 4-byte ones, and plain loads for bf16 x,
//   where a row is not 16-byte aligned). The loads of stage i + STAGES - 1
//   are issued before stage i is computed, so no lane waits on a load issued
//   in the same iteration. Steps past S are zero-filled: dt = 0 gives a decay
//   of exactly 1 and no input, so the state is unchanged and the loop has no
//   tail.
// - y goes to a shared tile and leaves it as 16-byte stores, one stage at a
//   time.
#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

constexpr int WARPS = 4;            // warps a CTA, each its own pipeline
// from this many (row, channel) pairs a SM, one lane a channel gives 2 warps a
// sub-partition or more: take it; below, 2 lanes a channel
constexpr int kOneLaneFrom = 256;
constexpr float kLog2e = 1.4426950408889634f;

// a decay 2^x, x = dt·a·log2(e) <= 0, on the SFU (0 below -126)
__device__ __forceinline__ float decay(float x) { return ex2_ftz(x); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int N>
__device__ __forceinline__ void load_states(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z; v[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 q = reinterpret_cast<const float2*>(p)[i];
      v[2 * i] = q.x; v[2 * i + 1] = q.y;
    }
  }
}

// by lanes a channel: the steps a ring stage, the ring's stages, and the CTAs
// a SM the registers are held to
template <int L> struct Ring;
template <> struct Ring<1> { static constexpr int STEPS = 8, STAGES = 3, MIN_CTAS = 4; };
template <> struct Ring<2> { static constexpr int STEPS = 16, STAGES = 2, MIN_CTAS = 8; };

// one warp's shared memory: the dt, B, C and x rings, then the y tile
template <typename T, int DS, int L>
struct Layout {
  static constexpr int WC = 32 / L;                // channels a warp
  static constexpr int NS = DS / L;                // states a thread
  static constexpr int STEPS = Ring<L>::STEPS, STAGES = Ring<L>::STAGES;
  static constexpr int X = STEPS * WC;             // elements of a stage's x or dt tile
  static constexpr int BC = STEPS * DS;            // floats of a stage's B or C rows
  static constexpr int BYTES = STAGES * (X * 4 + 2 * BC * 4 + X * int(sizeof(T))) +
                               X * int(sizeof(T));
};

// y of one step into the warp's y tile. No memory clobber: no load of the
// stage reads the tile, so later steps' loads may still move ahead of it.
__device__ __forceinline__ void sts_y(uint32_t a, float v, float*) {
  asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(a), "f"(v));
}
__device__ __forceinline__ void sts_y(uint32_t a, float v, __nv_bfloat16*) {
  asm volatile("st.shared.b16 [%0], %1;\n"
               :: "r"(a), "h"(__bfloat16_as_ushort(__float2bfloat16(v))));
}

// x, y: [B,S,Di]; dt: [B,S,Di] f32; a_log: [Di,DS]; bm, cm: [B,S,DS]; d_skip:
// [Di]; h0 (or null), hout: [B,Di,DS]; all f32 but x and y. grid
// (ceil(Di / (WARPS * 32 / L)), B). vec: every row of x, dt, y, bm and cm is
// 16-byte aligned (Di % 8 == 0 and aligned bases).
template <typename T, int DS, int L>
__global__ void __launch_bounds__(WARPS * 32, Ring<L>::MIN_CTAS)
scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ a_log, const float* __restrict__ bm,
            const float* __restrict__ cm, const float* __restrict__ d_skip,
            const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hout, int S,
            int Di, bool vec) {
  using G = Layout<T, DS, L>;
  constexpr int WC = G::WC, NS = G::NS, STEPS = G::STEPS, STAGES = G::STAGES, X = G::X,
                BC = G::BC;
  constexpr int VX = kVec<T>;                      // elements of x or y in 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cw0 = (blockIdx.x * WARPS + warp) * WC;   // the warp's first channel
  if (cw0 >= Di) return;                           // warp-uniform; no CTA barrier follows
  float* sdt = reinterpret_cast<float*>(smem + warp * G::BYTES);
  float* sb = sdt + STAGES * X;
  float* sc = sb + STAGES * BC;
  T* sx = reinterpret_cast<T*>(sc + STAGES * BC);
  T* sy = sx + STAGES * X;
  const int cl = lane / L, q = lane % L, s0 = q * NS;   // channel in the warp, its state block
  const int c = cw0 + cl;
  const bool live = c < Di;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * S;   // first step of this sequence
  const size_t hrow = (static_cast<size_t>(blockIdx.y) * Di + (live ? c : 0)) * DS + s0;

  float a2[NS], h[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    a2[s] = live ? -expf(a_log[static_cast<size_t>(c) * DS + s0 + s]) * kLog2e : 0.f;
    h[s] = live && h0 != nullptr ? h0[hrow + s] : 0.f;
  }
  const float dsk = live ? d_skip[c] : 0.f;
  const int nst = (S + STEPS - 1) / STEPS;

  // Aligned rows: lane l copies chunks l, l + 32, ... of each array's stage
  // tile (16 bytes: 4 channels of dt, VX of x or y, 4 states of B or C), the
  // same places in every stage; its j-th chunk lies 32 j chunks, a whole
  // number of rows, below its first. Its sources advance a stage at a time.
  constexpr int NDT = X / 4, NX = X / VX, NBC = BC / 4;          // chunks a stage
  constexpr int RDT = 32 / (WC / 4), RX = 32 / (WC / VX), RBC = 128 / DS;   // rows a 32
  const int r_dt = lane / (WC / 4), k_dt = 4 * (lane % (WC / 4));
  const int r_x = lane / (WC / VX), k_x = VX * (lane % (WC / VX));
  const int r_bc = 4 * lane / DS;
  const bool dt_col = cw0 + k_dt < Di, x_col = cw0 + k_x < Di;
  const size_t stride = static_cast<size_t>(STEPS) * Di;   // elements of x or dt a stage
  const float* dt_src = dt + (row0 + r_dt) * Di + cw0 + k_dt;
  const T* x_src = x + (row0 + r_x) * Di + cw0 + k_x;
  T* y_dst = y + (row0 + r_x) * Di + cw0 + k_x;
  size_t bc_off = row0 * DS + 4 * lane;
  const uint32_t dt_to = smem_u32(sdt + r_dt * WC + k_dt), x_to = smem_u32(sx + r_x * WC + k_x);
  const uint32_t b_to = smem_u32(sb + 4 * lane), c_to = smem_u32(sc + 4 * lane);
  const uint32_t y_at = smem_u32(sy + cl);

  // the loads of stage `stage` into its ring slot, as one cp.async group
  auto issue = [&](int stage) {
    if (stage < nst) {
      const int slot = stage % STAGES, t0 = stage * STEPS;
      if (vec) {
#pragma unroll
        for (int j = 0; j * 32 < NDT; ++j) {
          if (lane + 32 * j < NDT) {
            const bool ok = dt_col && t0 + r_dt + j * RDT < S;
            cp_async16(dt_to + (slot * X + j * RDT * WC) * 4,
                       ok ? dt_src + j * RDT * Di : dt, ok);
          }
        }
#pragma unroll
        for (int j = 0; j * 32 < NX; ++j) {
          if (lane + 32 * j < NX) {
            const bool ok = x_col && t0 + r_x + j * RX < S;
            cp_async16(x_to + (slot * X + j * RX * WC) * int(sizeof(T)),
                 ok ? x_src + j * RX * Di : x, ok);
          }
        }
#pragma unroll
        for (int j = 0; j * 32 < NBC; ++j) {
          if (lane + 32 * j < NBC) {
            const bool ok = t0 + r_bc + j * RBC < S;
            const size_t off = bc_off + 128 * j;
            cp_async16(b_to + (slot * BC + 128 * j) * 4, ok ? bm + off : bm, ok);
            cp_async16(c_to + (slot * BC + 128 * j) * 4, ok ? cm + off : cm, ok);
          }
        }
        dt_src += stride;
        x_src += stride;
        bc_off += STEPS * DS;
      } else {
        float* dts = sdt + slot * X;
        T* xs = sx + slot * X;
        const size_t bc0 = (row0 + t0) * DS;
        for (int i = lane; i < X; i += 32) {
          const int r = i / WC, k = i % WC;
          const bool ok = t0 + r < S && cw0 + k < Di;
          const size_t off = ok ? (row0 + t0 + r) * Di + cw0 + k : 0;
          cp_async4(dts + i, dt + off, ok);
          if constexpr (sizeof(T) == 4) {
            cp_async4(xs + i, x + off, ok);
          } else {
            store(xs + i, ok ? to_float(x[off]) : 0.f);
          }
        }
        for (int i = lane; i < BC; i += 32) {
          const bool ok = t0 + i / DS < S;
          cp_async4(sb + slot * BC + i, bm + (ok ? bc0 + i : 0), ok);
          cp_async4(sc + slot * BC + i, cm + (ok ? bc0 + i : 0), ok);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  for (int i = 0; i < nst; ++i) {
    issue(i + STAGES - 1);                         // into the slot stage i - 1 left
    cp_async_wait_group<STAGES - 1>();             // this lane's copies of stage i landed
    __syncwarp();                                  // and every lane's; the y tile is free
    const int slot = i % STAGES, t0 = i * STEPS;
    const float* dts = sdt + slot * X;
    const T* xs = sx + slot * X;
    const float* bs = sb + slot * BC;
    const float* cs = sc + slot * BC;
#pragma unroll
    for (int r = 0; r < STEPS; ++r) {
      const float dtv = dts[r * WC + cl];
      const float xv = to_float(xs[r * WC + cl]);
      float bv[NS], cv[NS];
      load_states(bs + r * DS + s0, bv);
      load_states(cs + r * DS + s0, cv);
      const float dx = dtv * xv;
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        h[s] = fmaf(decay(dtv * a2[s]), h[s], dx * bv[s]);
        if (s & 1) acc1 = fmaf(h[s], cv[s], acc1);
        else acc0 = fmaf(h[s], cv[s], acc0);
      }
      float yv = acc0 + acc1;
#pragma unroll
      for (int o = 1; o < L; o <<= 1) yv += __shfl_xor_sync(0xffffffffu, yv, o);
      if (q == 0) sts_y(y_at + r * WC * int(sizeof(T)), fmaf(xv, dsk, yv), sy);
    }
    __syncwarp();                                  // the y tile is whole; the slot is free
    if (vec) {
#pragma unroll
      for (int j = 0; j * 32 < NX; ++j) {
        if (lane + 32 * j < NX && x_col && t0 + r_x + j * RX < S)
          *reinterpret_cast<uint4*>(y_dst + j * RX * Di) =
              *reinterpret_cast<const uint4*>(sy + (r_x + j * RX) * WC + k_x);
      }
      y_dst += stride;
    } else {
      for (int i = lane; i < X; i += 32) {
        const int r = i / WC, k = i % WC;
        if (t0 + r < S && cw0 + k < Di) y[(row0 + t0 + r) * Di + cw0 + k] = sy[i];
      }
    }
  }
  cp_async_wait_group<0>();                        // only empty groups can be pending
  if (live) {
#pragma unroll
    for (int s = 0; s < NS; ++s) hout[hrow + s] = h[s];
  }
}

template <typename T, int DS, int L>
cudaError_t launch(const void* x, const void* dt, const void* a_log, const void* bm,
                   const void* cm, const void* d_skip, const void* h0, void* y, void* hout,
                   int B, int S, int Di, bool vec, cudaStream_t stream) {
  using G = Layout<T, DS, L>;
  constexpr int per_cta = WARPS * G::WC;
  constexpr int smem = WARPS * G::BYTES;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_kernel<T, DS, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Di + per_cta - 1) / per_cta, B);
  scan_kernel<T, DS, L><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(d_skip),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(hout), S, Di,
      vec);
  return cudaGetLastError();
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch_ds(const void* x, const void* dt, const void* a_log, const void* bm,
                      const void* cm, const void* d_skip, const void* h0, void* y, void* hout,
                      int B, int S, int Di, int Ds, cudaStream_t stream) {
  const bool vec = Di % 8 == 0 && aligned16(x) && aligned16(dt) && aligned16(y) &&
                   aligned16(bm) && aligned16(cm);
  const bool one_lane = static_cast<long long>(B) * Di >=
                        static_cast<long long>(kOneLaneFrom) * sm_count();
  switch (Ds * 2 + one_lane) {
    case 4 * 2 + 1:
      return launch<T, 4, 1>(x, dt, a_log, bm, cm, d_skip, h0, y, hout, B, S, Di, vec, stream);
    case 4 * 2:
      return launch<T, 4, 2>(x, dt, a_log, bm, cm, d_skip, h0, y, hout, B, S, Di, vec, stream);
    case 8 * 2 + 1:
      return launch<T, 8, 1>(x, dt, a_log, bm, cm, d_skip, h0, y, hout, B, S, Di, vec, stream);
    case 8 * 2:
      return launch<T, 8, 2>(x, dt, a_log, bm, cm, d_skip, h0, y, hout, B, S, Di, vec, stream);
    case 16 * 2 + 1:
      return launch<T, 16, 1>(x, dt, a_log, bm, cm, d_skip, h0, y, hout, B, S, Di, vec, stream);
    case 16 * 2:
      return launch<T, 16, 2>(x, dt, a_log, bm, cm, d_skip, h0, y, hout, B, S, Di, vec, stream);
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
