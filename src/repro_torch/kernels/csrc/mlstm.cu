// Chunkwise mLSTM for Hopper (sm_90a): the stabilised parallel form of the
// xLSTM matrix-memory cell, carrying (C, n, m) across chunks of 64 steps.
//
// Replaces the TPU kernel src/repro/kernels/mlstm.py::_mlstm_kernel (entry
// mlstm, :31 and :98; pallas_call :125). Per chunk it computes what that
// kernel computes, in f32:
//   F = cumsum(logsigmoid f), m_i = F_i + max(m_prev, max_{j<=i}(logi_j - F_j));
//   inter = (q C) * exp(F_i + m_prev - m_i);
//   intra = (q k^T * D) v, D_ij = exp(F_i - F_j + logi_j - m_i) for j <= i;
//   h = (inter + intra) / max(|n_i . q_i|, exp(-m_i));
//   carry: C, n, m to the end of the chunk.
// n_i . q_i is taken as exp(F_i + m_prev - m_i) (n . q_i) + sum_j D_ij s_ij
// with s = q k^T, the same sum regrouped, so the [chunk, Dk] normaliser rows
// are never formed. Two differences from the Pallas entry: a call may start
// from a carried state (C, n, m) instead of (0, 0, -1e30), and the steps of
// the last chunk past S take the reference's padding values (i = -1e30,
// f = 60) inside the kernel, with no padded copies of the inputs.
//
// What bounds it on the H100. At xlstm-1.3b's prefill shape (B=4, S=512,
// H=4, Dk=512, Dv=1024, bf16) a call moves 84.0 MB (q, k, v and h, the
// gates, C and n out) and needs 19.3 GFLOP: 0.025 ms at 3.35 TB/s, 0.020 ms
// at the bf16 tensor-core peak, 0.29 ms at the f32 SIMT peak. This first
// version runs its products on the f32 SIMT pipes, so operations bound it.
//
// Design: the state does not fit one SM. A head's C is Dk x Dv f32, 2 MB at
// the path's shape; an SM has 227 KB of shared memory. So the grid is
// (Dv / 64, H, B): each CTA owns a [Dk, 64] column tile of C (128 KB at
// Dk = 512) in shared memory for the whole sequence, and streams q and k
// through shared memory in blocks of 32 key dims. What depends on Dk alone
// (the gates, m_i, the scores q k^T, n and q . n) is recomputed by each of
// the Dv/64 CTAs of a head (1/16 of the head's score work per CTA at the
// path's shape); only the CTA of columns 0..63 writes n and m out.
// - Per chunk and key block the CTA accumulates the scores and q C (the
//   chunk's incoming C) in registers, then carries its rows of C and n to
//   the end of the chunk; after the last block it forms D * s, the
//   normaliser and (D * s) v, and writes h.
// - 256 threads; each owns a 4 x 4 tile of every 64 x 64 product, its rows
//   strided by 16 and the q/k rows padded to 33 floats, so shared-memory
//   reads are conflict-free or broadcasts.
// - Known gap: f32 SIMT products and scalar global loads, with no overlap
//   of the next block's loads; tensor-core chunk products (mma.sync or
//   wgmma) with TMA-staged q/k are the redesign.
#include "common.cuh"

namespace repro {
namespace {

constexpr int CHUNK = 64;           // steps per chunk (the Pallas kernel's DEFAULT_CHUNK)
constexpr int TV = 64;              // columns of C (value dims) per CTA
constexpr int KB = 32;              // key dims per streamed q/k block
constexpr int THREADS = 256;
constexpr int LDQ = KB + 1;         // padded row stride of the q/k blocks
constexpr int LDS = CHUNK + 1;      // padded row stride of D * s
constexpr int MAX_DK = 512;
constexpr float kPadForget = 60.f;  // f on padded steps: logsigmoid(60) ~ 0 keeps the state

size_t smem_bytes(int Dk) {
  return sizeof(float) * (static_cast<size_t>(Dk) * TV + 2 * CHUNK * LDQ + CHUNK * TV +
                          CHUNK * LDS + Dk + 7 * CHUNK + 4);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// -softplus(-x), written as the stable min(x, 0) - log1p(exp(-|x|))
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// q, k: [B,S,H,Dk]; v, h: [B,S,H,Dv]; ig, fg: [B,S,H] f32; C0/Cout: [B,H,Dk,Dv],
// n0/nout: [B,H,Dk], m0/mout: [B,H] f32; C0, n0, m0 all null for a fresh state.
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ ig, const float* __restrict__ fg,
             const float* __restrict__ C0, const float* __restrict__ n0,
             const float* __restrict__ m0, T* __restrict__ h, float* __restrict__ Cout,
             float* __restrict__ nout, float* __restrict__ mout, int S, int H, int Dk,
             int Dv, float scale) {
  extern __shared__ float smem[];
  float* sC = smem;                       // [Dk][TV]      this CTA's columns of C
  float* sQ = sC + Dk * TV;               // [CHUNK][LDQ]  q block, scaled
  float* sK = sQ + CHUNK * LDQ;           // [CHUNK][LDQ]  k block
  float* sV = sK + CHUNK * LDQ;           // [CHUNK][TV]   v tile of the chunk
  float* sW = sV + CHUNK * TV;            // [CHUNK][LDS]  D * s
  float* sN = sW + CHUNK * LDS;           // [Dk]          n
  float* sLogi = sN + Dk;                 // [CHUNK]       log i
  float* sF = sLogi + CHUNK;              // [CHUNK]       log f, then F
  float* sMi = sF + CHUNK;                // [CHUNK]       m_i
  float* sWin = sMi + CHUNK;              // [CHUNK]       exp(F_i + m_prev - m_i)
  float* sWk = sWin + CHUNK;              // [CHUNK]       exp(F_c - F_j + logi_j - m_new)
  float* sQn = sWk + CHUNK;               // [CHUNK]       q_i . n (the chunk's incoming n)
  float* sDen = sQn + CHUNK;              // [CHUNK]       the normaliser
  float* sCarry = sDen + CHUNK;           // F_c, m_new, w_old

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int v0 = blockIdx.x * TV, hh = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + hh;
  const size_t step_k = static_cast<size_t>(H) * Dk;   // elements between steps
  const size_t step_v = static_cast<size_t>(H) * Dv;
  const size_t first = static_cast<size_t>(b) * S * H + hh;   // step 0 of (b, hh)
  const T* qb = q + first * Dk;
  const T* kb = k + first * Dk;
  const T* vb = v + first * Dv + v0;
  T* hb = h + first * Dv + v0;
  const float* igb = ig + first;
  const float* fgb = fg + first;

  for (int e = tid; e < Dk * TV; e += THREADS) {
    const int d = e / TV, j = e % TV;
    sC[e] = C0 ? C0[(bh * Dk + d) * Dv + v0 + j] : 0.f;
  }
  for (int d = tid; d < Dk; d += THREADS) sN[d] = n0 ? n0[bh * Dk + d] : 0.f;
  float m_prev = m0 ? m0[bh] : kNegInf;

  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    // the chunk's gates (padding values past S) and its v tile
    if (tid < CHUNK) {
      const int t = t0 + tid;
      sLogi[tid] = t < S ? igb[static_cast<size_t>(t) * H] : kNegInf;
      sF[tid] = log_sigmoid(t < S ? fgb[static_cast<size_t>(t) * H] : kPadForget);
      sQn[tid] = 0.f;
    }
    for (int e = tid; e < CHUNK * TV; e += THREADS) {
      const int t = e / TV, j = e % TV;
      sV[e] = t0 + t < S ? to_float(vb[static_cast<size_t>(t0 + t) * step_v + j]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {                       // inclusive prefix sum and running max
      float F = 0.f, gmax = kNegInf;
      for (int t = 0; t < CHUNK; ++t) {
        F += sF[t];
        sF[t] = F;
        gmax = fmaxf(gmax, sLogi[t] - F);
        sMi[t] = F + fmaxf(m_prev, gmax);
      }
      const float m_new = F + fmaxf(m_prev, gmax);
      sCarry[0] = F;
      sCarry[1] = m_new;
      sCarry[2] = expf(F + m_prev - m_new);
    }
    __syncthreads();
    if (tid < CHUNK) {
      sWin[tid] = expf(sF[tid] + m_prev - sMi[tid]);
      sWk[tid] = expf(sCarry[0] - sF[tid] + sLogi[tid] - sCarry[1]);
    }
    const float w_old = sCarry[2];

    float sacc[4][4] = {}, iacc[4][4] = {};
    for (int d0 = 0; d0 < Dk; d0 += KB) {
      __syncthreads();                    // the previous block's readers are done
      for (int e = tid; e < CHUNK * KB; e += THREADS) {
        const int t = e / KB, d = e % KB;
        const bool live = t0 + t < S;
        const size_t off = static_cast<size_t>(t0 + t) * step_k + d0 + d;
        sQ[t * LDQ + d] = live ? to_float(qb[off]) * scale : 0.f;
        sK[t * LDQ + d] = live ? to_float(kb[off]) : 0.f;
      }
      __syncthreads();
      // scores and q C with the chunk's incoming C; q . n with its incoming n
#pragma unroll 4
      for (int d = 0; d < KB; ++d) {
        float a[4], bk[4], bc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = sQ[(ty + 16 * r) * LDQ + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          bk[c] = sK[(tx + 16 * c) * LDQ + d];
          bc[c] = sC[(d0 + d) * TV + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            sacc[r][c] = fmaf(a[r], bk[c], sacc[r][c]);
            iacc[r][c] = fmaf(a[r], bc[c], iacc[r][c]);
          }
        }
      }
      if (tid < CHUNK) {
        float s = 0.f;
        for (int d = 0; d < KB; ++d) s = fmaf(sQ[tid * LDQ + d], sN[d0 + d], s);
        sQn[tid] += s;
      }
      __syncthreads();
      // carry rows d0 .. d0+KB of C and n to the end of the chunk
      float cacc[2][4] = {};
#pragma unroll 4
      for (int t = 0; t < CHUNK; ++t) {
        const float wk = sWk[t];
        float a[2], bv[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) a[r] = sK[t * LDQ + ty + 16 * r] * wk;
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sV[t * TV + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) cacc[r][c] = fmaf(a[r], bv[c], cacc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float& cr = sC[(d0 + ty + 16 * r) * TV + tx + 16 * c];
          cr = fmaf(cr, w_old, cacc[r][c]);
        }
      }
      if (tid < KB) {
        float s = 0.f;
        for (int t = 0; t < CHUNK; ++t) s = fmaf(sK[t * LDQ + tid], sWk[t], s);
        sN[d0 + tid] = fmaf(sN[d0 + tid], w_old, s);
      }
    }

    // D * s (causal), the normaliser, (D * s) v and h
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        sW[i * LDS + j] =
            j <= i ? sacc[r][c] * expf(sF[i] - sF[j] + sLogi[j] - sMi[i]) : 0.f;
      }
    }
    __syncthreads();
    if (tid < CHUNK) {
      float s = 0.f;
      for (int j = 0; j < CHUNK; ++j) s += sW[tid * LDS + j];
      sDen[tid] = fmaxf(fabsf(fmaf(sWin[tid], sQn[tid], s)), expf(-sMi[tid]));
    }
    __syncthreads();
    float oacc[4][4] = {};
#pragma unroll 4
    for (int t = 0; t < CHUNK; ++t) {
      float a[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sW[(ty + 16 * r) * LDS + t];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = sV[t * TV + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) oacc[r][c] = fmaf(a[r], bv[c], oacc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      if (t0 + i < S) {
        T* dst = hb + static_cast<size_t>(t0 + i) * step_v;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          store(dst + tx + 16 * c, (iacc[r][c] * sWin[i] + oacc[r][c]) / sDen[i]);
      }
    }
    m_prev = sCarry[1];
    __syncthreads();                      // the next chunk rewrites the gates, sV and sW
  }

  // the state after the last step
  for (int e = tid; e < Dk * TV; e += THREADS) {
    const int d = e / TV, j = e % TV;
    Cout[(bh * Dk + d) * Dv + v0 + j] = sC[e];
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < Dk; d += THREADS) nout[bh * Dk + d] = sN[d];
    if (tid == 0) mout[bh] = m_prev;
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ig,
                   const void* fg, const void* C0, const void* n0, const void* m0, void* h,
                   void* C, void* n, void* m, int B, int S, int H, int Dk, int Dv,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(Dk);
  cudaError_t err = cudaFuncSetAttribute(mlstm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(Dv / TV, H, B);
  mlstm_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(ig), static_cast<const float*>(fg),
      static_cast<const float*>(C0), static_cast<const float*>(n0),
      static_cast<const float*>(m0), static_cast<T*>(h), static_cast<float*>(C),
      static_cast<float*>(n), static_cast<float*>(m), S, H, Dk, Dv, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q, k: [B,S,H,Dk]; v, h: [B,S,H,Dv] in one dtype (0 = f32, 1 = bf16); ig, fg:
// [B,S,H] f32; C0, n0, m0: the state to start from ([B,H,Dk,Dv], [B,H,Dk],
// [B,H] f32), all three null for a fresh one; C, n, m: the final state, same
// shapes. Contiguous. Dk a multiple of 32 up to 512, Dv a multiple of 64.
// Launches on `stream`, does not synchronise, returns cudaGetLastError() of
// the launch.
extern "C" int repro_mlstm(const void* q, const void* k, const void* v, const void* ig,
                           const void* fg, const void* C0, const void* n0, const void* m0,
                           void* h, void* C, void* n, void* m, int dtype, int B, int S, int H,
                           int Dk, int Dv, float scale, void* stream) {
  using repro::KB;
  using repro::TV;
  if (B <= 0 || S <= 0 || H <= 0 || Dk <= 0 || Dk % KB || Dk > repro::MAX_DK || Dv <= 0 ||
      Dv % TV)
    return cudaErrorInvalidValue;
  if ((C0 == nullptr) != (n0 == nullptr) || (C0 == nullptr) != (m0 == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, k, v, ig, fg, C0, n0, m0, h, C, n, m, B, S, H, Dk,
                                        Dv, scale, s);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, k, v, ig, fg, C0, n0, m0, h, C, n, m, B, S, H, Dk, Dv,
                                scale, s);
  return cudaErrorInvalidValue;
}
