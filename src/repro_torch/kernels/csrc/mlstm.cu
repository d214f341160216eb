// Chunkwise mLSTM for Hopper (sm_90a): the stabilised parallel form of the
// xLSTM matrix-memory cell, carrying (C, n, m) across chunks of 64 steps.
//
// Replaces the TPU kernel src/repro/kernels/mlstm.py::_mlstm_kernel (entry
// mlstm, :31 and :98; pallas_call :125), which keeps the head's whole state
// in VMEM across a sequential grid of chunks. Per chunk it computes what that
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
// at the bf16 tensor-core peak, 0.29 ms at the f32 SIMT peak. So the chunk
// products belong on the tensor cores, and the f32 state is what makes that
// hard.
//
// Layout: the state does not fit one SM. A head's C is Dk x Dv f32, 2 MB at
// the path's shape; an SM has 227 KB of shared memory. So the grid is
// (Dv / 64, H, B): each CTA owns a [Dk, 64] column tile of C in shared
// memory for the whole sequence and streams q and k through shared memory in
// blocks of key dims. What depends on Dk alone (the gates, m_i, the scores
// q k^T, n and q . n) is recomputed by each of the Dv/64 CTAs of a head;
// only the CTA of columns 0..63 writes n and m out. Sharing the scores over
// a thread-block cluster is not done.
//
// Two kernels:
// - bf16 (the xlstm path): mlstm_tc_kernel, the chunk products on the tensor
//   cores (mma.sync m16n8k16 with ldmatrix, bf16 in, f32 accumulate).
//   * Precision. q, k and v are bf16 inputs, exact as operands; the 1/sqrt(Dk)
//     scale is applied in f32 after q k^T and q C. The f32 operands, C in
//     q C, k wk in the carry and D * s in the output product, are each split
//     into bf16 hi + lo (x - hi - lo = O(2^-18 x)) and go through two
//     products, f32 accumulate: one bf16 rounding of k wk misses the state's
//     1e-4 tolerance (tests/test_torch_mlstm.py shows both).
//   * Staging: q and k blocks of 64 key dims by cp.async, double-buffered, so
//     the next block loads under this block's products; v per chunk.
//   * The carry's A operand (k wk)^T is read from the k tile by
//     ldmatrix.trans and scaled and split in registers; in the chunk
//     products each warp owns 8 columns of all 64 rows, so every element of C
//     is split once per chunk. n, q . n and the cumulative sums (a warp scan)
//     run in f32 on all threads.
//   * Tiling: C's 64-column tile is 136 KB at Dk = 512 (rows padded to 68
//     floats for conflict-free fragment reads), ~205 KB in all, so one CTA
//     of 8 warps per SM; 256 CTAs at the path's shape are 1.94 waves on 132
//     SMs. A 32-column tile would fit two CTAs per SM but double the
//     recomputed scores, and 512 CTAs are again 1.94 waves.
// - f32 (tests and reduced shapes): mlstm_simt_kernel, the same chunk loop
//   with its products on the f32 SIMT pipes, each of 256 threads owning a
//   4 x 4 tile of every 64 x 64 product, q/k in blocks of 32 key dims.
#include "common.cuh"
#include "hopper.cuh"

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

// -softplus(-x), written as the stable min(x, 0) - log1p(exp(-|x|))
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// q, k: [B,S,H,Dk]; v, h: [B,S,H,Dv]; ig, fg: [B,S,H] f32; C0/Cout: [B,H,Dk,Dv],
// n0/nout: [B,H,Dk], m0/mout: [B,H] f32; C0, n0, m0 all null for a fresh state.
__global__ void __launch_bounds__(THREADS)
mlstm_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ ig, const float* __restrict__ fg,
                  const float* __restrict__ C0, const float* __restrict__ n0,
                  const float* __restrict__ m0, float* __restrict__ h,
                  float* __restrict__ Cout, float* __restrict__ nout,
                  float* __restrict__ mout, int S, int H, int Dk, int Dv, float scale) {
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
  const float* qb = q + first * Dk;
  const float* kb = k + first * Dk;
  const float* vb = v + first * Dv + v0;
  float* hb = h + first * Dv + v0;
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
      sV[e] = t0 + t < S ? vb[static_cast<size_t>(t0 + t) * step_v + j] : 0.f;
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
        sQ[t * LDQ + d] = live ? qb[off] * scale : 0.f;
        sK[t * LDQ + d] = live ? kb[off] : 0.f;
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
        float* dst = hb + static_cast<size_t>(t0 + i) * step_v;
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

// ------------------------------------------------ bf16: tensor-core chunk products

constexpr int TC_KB = 64;                // key dims per staged q/k block
constexpr int TC_LDB = TC_KB + 8;        // bf16 row stride of q, k and D*s (144 B)
constexpr int TC_LDV = TV + 8;           // bf16 row stride of the v tile
constexpr int TC_LDC = TV + 4;           // f32 row stride of C: conflict-free fragment reads
constexpr int TC_TILE = CHUNK * TC_LDB;  // bf16 elements of one staged 64 x 64 tile
constexpr int NWARPS = THREADS / 32;

// shared memory, in bytes from the base, for key dims padded to Dkp
struct TcLayout {
  size_t C, Q, K, V, Whi, Wlo, N, gates, bytes;
  explicit __host__ __device__ TcLayout(int Dkp) {
    C = 0;
    Q = C + sizeof(float) * static_cast<size_t>(Dkp) * TC_LDC;  // 2 buffers
    K = Q + 2 * sizeof(__nv_bfloat16) * TC_TILE;                // 2 buffers
    V = K + 2 * sizeof(__nv_bfloat16) * TC_TILE;
    Whi = V + sizeof(__nv_bfloat16) * CHUNK * TC_LDV;           // D*s, hi
    Wlo = Whi + sizeof(__nv_bfloat16) * TC_TILE;                // and lo parts
    N = Wlo + sizeof(__nv_bfloat16) * TC_TILE;
    gates = N + sizeof(float) * Dkp;
    bytes = gates + sizeof(float) * ((7 + NWARPS) * CHUNK + 4);
  }
};

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the bf16 pair x (low half first) times (w0, w1), split into hi and lo pairs
__device__ __forceinline__ void scale_split(uint32_t x, float w0, float w1, uint32_t& hi,
                                            uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  __nv_bfloat16 h0, l0, h1, l1;
  split_bf16(f.x * w0, h0, l0);
  split_bf16(f.y * w1, h1, l1);
  hi = as_u32(__halves2bfloat162(h0, h1));
  lo = as_u32(__halves2bfloat162(l0, l1));
}

// The bf16 kernel: the f32 kernel's chunk loop with its products on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate), 8 warps.
// - Scores q k^T, q C and (D*s) v: warp w owns all 64 rows and columns
//   8w .. 8w + 7, so each element of C is split into hi + lo once per chunk.
// - The carry (k wk)^T v: warp w owns key dims 16 (w % 4) .. of the block and
//   columns 32 (w / 4) ..; its A operand is read from the k tile by
//   ldmatrix.trans, scaled by wk and split in registers.
__global__ void __launch_bounds__(THREADS, 1)
mlstm_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const float* __restrict__ ig,
                const float* __restrict__ fg, const float* __restrict__ C0,
                const float* __restrict__ n0, const float* __restrict__ m0,
                __nv_bfloat16* __restrict__ h, float* __restrict__ Cout,
                float* __restrict__ nout, float* __restrict__ mout, int S, int H, int Dk,
                int Dv, float scale) {
  const int Dkp = (Dk + TC_KB - 1) / TC_KB * TC_KB;
  const TcLayout lay(Dkp);
  extern __shared__ __align__(16) uint8_t smem_tc[];
  float* sC = reinterpret_cast<float*>(smem_tc + lay.C);       // [Dkp][LDC]
  auto* sQ = reinterpret_cast<__nv_bfloat16*>(smem_tc + lay.Q);  // [2][CHUNK][LDB]
  auto* sK = reinterpret_cast<__nv_bfloat16*>(smem_tc + lay.K);  // [2][CHUNK][LDB]
  auto* sV = reinterpret_cast<__nv_bfloat16*>(smem_tc + lay.V);  // [CHUNK][LDV]
  auto* sWhi = reinterpret_cast<__nv_bfloat16*>(smem_tc + lay.Whi);
  auto* sWlo = reinterpret_cast<__nv_bfloat16*>(smem_tc + lay.Wlo);
  float* sN = reinterpret_cast<float*>(smem_tc + lay.N);       // [Dkp]
  float* sLogi = reinterpret_cast<float*>(smem_tc + lay.gates);  // [CHUNK] log i
  float* sF = sLogi + CHUNK;           // log f, then F
  float* sMi = sF + CHUNK;             // m_i
  float* sWin = sMi + CHUNK;           // exp(F_i + m_prev - m_i)
  float* sWk = sWin + CHUNK;           // exp(F_c - F_j + logi_j - m_new)
  float* sQn = sWk + CHUNK;            // q_i . n (unscaled)
  float* sDen = sQn + CHUNK;           // the normaliser
  float* sRow = sDen + CHUNK;          // [NWARPS][CHUNK] row sums of D*s
  float* sCarry = sRow + NWARPS * CHUNK;  // F_c, m_new, w_old

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n8 = warp * 8;                                 // chunk products: columns
  const int mi = (warp & 3) * 16, nb = (warp >> 2) * 32;   // carry: key dims, columns
  const int v0 = blockIdx.x * TV, hh = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + hh;
  const size_t step_k = static_cast<size_t>(H) * Dk;
  const size_t step_v = static_cast<size_t>(H) * Dv;
  const size_t first = static_cast<size_t>(b) * S * H + hh;
  const __nv_bfloat16* qb = q + first * Dk;
  const __nv_bfloat16* kb = k + first * Dk;
  const __nv_bfloat16* vb = v + first * Dv + v0;
  __nv_bfloat16* hb = h + first * Dv + v0;
  const float* igb = ig + first;
  const float* fgb = fg + first;
  const int nblk = Dkp / TC_KB;
  const int nchunks = (S + CHUNK - 1) / CHUNK;

  // cp.async of the q and k block (chunk c, key block blk) into buffer buf;
  // steps past S and dims past Dk read as zero
  auto issue_qk = [&](int c, int blk, int buf) {
    for (int e = tid; e < 2 * CHUNK * (TC_KB / 8); e += THREADS) {
      const int which = e / (CHUNK * (TC_KB / 8)), r = (e / (TC_KB / 8)) % CHUNK;
      const int c8 = e % (TC_KB / 8), t = c * CHUNK + r, d = blk * TC_KB + c8 * 8;
      const bool live = t < S && d < Dk;
      const __nv_bfloat16* src = (which ? kb : qb) + (live ? t * step_k + d : 0);
      cp_async16((which ? sK : sQ) + buf * TC_TILE + r * TC_LDB + c8 * 8, src, live);
    }
  };
  auto issue_v = [&](int c) {
    for (int e = tid; e < CHUNK * (TV / 8); e += THREADS) {
      const int r = e / (TV / 8), c8 = e % (TV / 8), t = c * CHUNK + r;
      const bool live = t < S;
      cp_async16(sV + r * TC_LDV + c8 * 8, vb + (live ? t * step_v + c8 * 8 : 0), live);
    }
  };

  issue_qk(0, 0, 0);
  issue_v(0);
  cp_async_commit();
  for (int e = tid; e < Dkp * TV; e += THREADS) {
    const int d = e / TV, j = e % TV;
    sC[d * TC_LDC + j] = C0 && d < Dk ? C0[(bh * Dk + d) * Dv + v0 + j] : 0.f;
  }
  for (int d = tid; d < Dkp; d += THREADS) sN[d] = n0 && d < Dk ? n0[bh * Dk + d] : 0.f;
  float m_prev = m0 ? m0[bh] : kNegInf;

  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * CHUNK;
    if (tid < CHUNK) {
      const int t = t0 + tid;
      sLogi[tid] = t < S ? igb[static_cast<size_t>(t) * H] : kNegInf;
      sF[tid] = log_sigmoid(t < S ? fgb[static_cast<size_t>(t) * H] : kPadForget);
      sQn[tid] = 0.f;
    }
    __syncthreads();
    if (warp == 0) {                      // F = cumsum(log f) and the running max, by warp scan
      const float2 lf = *reinterpret_cast<const float2*>(sF + 2 * lane);
      const float2 li = *reinterpret_cast<const float2*>(sLogi + 2 * lane);
      float F = lf.x + lf.y;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, F, off);
        if (lane >= off) F += up;
      }
      const float F1 = F, F0 = F - lf.y;
      float gmax = fmaxf(li.x - F0, li.y - F1);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, gmax, off);
        if (lane >= off) gmax = fmaxf(gmax, up);
      }
      const float g0 = __shfl_up_sync(0xffffffffu, gmax, 1);   // the max before step 2 lane
      const float gmax0 = fmaxf(lane ? g0 : kNegInf, li.x - F0);
      *reinterpret_cast<float2*>(sF + 2 * lane) = make_float2(F0, F1);
      *reinterpret_cast<float2*>(sMi + 2 * lane) =
          make_float2(F0 + fmaxf(m_prev, gmax0), F1 + fmaxf(m_prev, gmax));
      if (lane == 31) {
        const float m_new = F1 + fmaxf(m_prev, gmax);
        sCarry[0] = F1;
        sCarry[1] = m_new;
        sCarry[2] = expf(F1 + m_prev - m_new);
      }
    }
    __syncthreads();
    if (tid < CHUNK) {
      sWin[tid] = expf(sF[tid] + m_prev - sMi[tid]);
      sWk[tid] = expf(sCarry[0] - sF[tid] + sLogi[tid] - sCarry[1]);
    }
    const float w_old = sCarry[2];

    float sacc[4][4] = {}, iacc[4][4] = {};   // [m-tile][fragment], columns n8 ..
    for (int blk = 0; blk < nblk; ++blk) {
      const int gi = c * nblk + blk, buf = gi & 1, d0 = blk * TC_KB;
      cp_async_wait_all();
      __syncthreads();                    // this block landed; the last one's readers are done
      if (gi + 1 < nchunks * nblk) {      // the next block loads under this one's products
        issue_qk((gi + 1) / nblk, (gi + 1) % nblk, buf ^ 1);
        cp_async_commit();
      }
      const __nv_bfloat16* bQ = sQ + buf * TC_TILE;
      const __nv_bfloat16* bK = sK + buf * TC_TILE;

      // scores q k^T and q C with the chunk's incoming C (hi + lo)
#pragma unroll
      for (int kk2 = 0; kk2 < TC_KB / 32; ++kk2) {
        uint32_t bk[4];
        ldsm_x4(bk, bK + (n8 + (lane & 7)) * TC_LDB + kk2 * 32 + (lane >> 3) * 8);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int kk = 2 * kk2 + half;
          const float* cr = sC + (d0 + kk * 16 + 2 * t4) * TC_LDC + n8 + g;
          __nv_bfloat16 hi[4], lo[4];
          split_bf16(cr[0], hi[0], lo[0]);
          split_bf16(cr[TC_LDC], hi[1], lo[1]);
          split_bf16(cr[8 * TC_LDC], hi[2], lo[2]);
          split_bf16(cr[9 * TC_LDC], hi[3], lo[3]);
          const uint32_t bh0 = as_u32(__halves2bfloat162(hi[0], hi[1]));
          const uint32_t bh1 = as_u32(__halves2bfloat162(hi[2], hi[3]));
          const uint32_t bl0 = as_u32(__halves2bfloat162(lo[0], lo[1]));
          const uint32_t bl1 = as_u32(__halves2bfloat162(lo[2], lo[3]));
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            uint32_t a[4];
            ldsm_x4(a, bQ + (mt * 16 + (lane & 15)) * TC_LDB + kk * 16 + (lane >> 4) * 8);
            mma_16816(sacc[mt], a, bk[2 * half], bk[2 * half + 1]);
            mma_16816(iacc[mt], a, bh0, bh1);
            mma_16816(iacc[mt], a, bl0, bl1);
          }
        }
      }
      {                                   // q . n with the chunk's incoming n: 4 threads a step
        const int t = tid >> 2, part = tid & 3;
        const __nv_bfloat162* qr =
            reinterpret_cast<const __nv_bfloat162*>(bQ + t * TC_LDB + part * 16);
        const float* nr = sN + d0 + part * 16;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 qq = __bfloat1622float2(qr[i]);
          s = fmaf(qq.x, nr[2 * i], fmaf(qq.y, nr[2 * i + 1], s));
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (part == 0) sQn[t] += s;
      }
      __syncthreads();                    // C and n rows of this block are read
      // carry key dims d0 + mi .. of C: C = C w_old + (k wk)^T v, (k wk) hi + lo
      float cacc[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < CHUNK / 16; ++kk) {
        uint32_t kt[4], ah[4], al[4];
        ldsm_x4_trans(kt, bK + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * TC_LDB + mi +
                              ((lane >> 3) & 1) * 8);
        const float2 wa = *reinterpret_cast<const float2*>(sWk + kk * 16 + 2 * t4);
        const float2 wb = *reinterpret_cast<const float2*>(sWk + kk * 16 + 2 * t4 + 8);
        scale_split(kt[0], wa.x, wa.y, ah[0], al[0]);
        scale_split(kt[1], wa.x, wa.y, ah[1], al[1]);
        scale_split(kt[2], wb.x, wb.y, ah[2], al[2]);
        scale_split(kt[3], wb.x, wb.y, ah[3], al[3]);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, sV + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * TC_LDV +
                                nb + np * 16 + ((lane >> 4) << 3));
          mma_16816(cacc[2 * np], ah, bv[0], bv[1]);
          mma_16816(cacc[2 * np], al, bv[0], bv[1]);
          mma_16816(cacc[2 * np + 1], ah, bv[2], bv[3]);
          mma_16816(cacc[2 * np + 1], al, bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float2* cp = reinterpret_cast<float2*>(sC + (d0 + mi + g + 8 * hr) * TC_LDC + nb +
                                                 nt * 8 + 2 * t4);
          float2 cv = *cp;
          cv.x = fmaf(cv.x, w_old, cacc[nt][2 * hr]);
          cv.y = fmaf(cv.y, w_old, cacc[nt][2 * hr + 1]);
          *cp = cv;
        }
      }
      {                                   // and n, in f32: 4 threads a key dim
        const int d = tid >> 2, part = tid & 3;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < CHUNK / 4; ++i) {
          const int t = part * (CHUNK / 4) + i;
          s = fmaf(__bfloat162float(bK[t * TC_LDB + d]), sWk[t], s);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (part == 0) sN[d0 + d] = fmaf(sN[d0 + d], w_old, s);
      }
    }

    // D * s (causal, scaled after the product), its row sums, split hi + lo
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = mt * 16 + g + 8 * hr;
        __nv_bfloat16 hi[2], lo[2];
        float rs = 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = n8 + 2 * t4 + e;
          const float w = j <= i ? sacc[mt][2 * hr + e] * scale *
                                       expf(sF[i] - sF[j] + sLogi[j] - sMi[i])
                                 : 0.f;
          rs += w;
          split_bf16(w, hi[e], lo[e]);
        }
        *reinterpret_cast<__nv_bfloat162*>(sWhi + i * TC_LDB + n8 + 2 * t4) =
            __halves2bfloat162(hi[0], hi[1]);
        *reinterpret_cast<__nv_bfloat162*>(sWlo + i * TC_LDB + n8 + 2 * t4) =
            __halves2bfloat162(lo[0], lo[1]);
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        if (t4 == 0) sRow[warp * CHUNK + i] = rs;
      }
    }
    __syncthreads();
    if (tid < CHUNK) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) s += sRow[w * CHUNK + tid];
      sDen[tid] = fmaxf(fabsf(fmaf(sWin[tid], sQn[tid] * scale, s)), expf(-sMi[tid]));
    }
    __syncthreads();
    // (D * s) v, D * s hi + lo, columns n8 ..; h = (inter + intra) / den
    float oacc[4][4] = {};
#pragma unroll
    for (int kk2 = 0; kk2 < CHUNK / 32; ++kk2) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, sV + (kk2 * 32 + lane) * TC_LDV + n8);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kk = 2 * kk2 + half;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t ah[4], al[4];
          ldsm_x4(ah, sWhi + (mt * 16 + (lane & 15)) * TC_LDB + kk * 16 + (lane >> 4) * 8);
          ldsm_x4(al, sWlo + (mt * 16 + (lane & 15)) * TC_LDB + kk * 16 + (lane >> 4) * 8);
          mma_16816(oacc[mt], ah, bv[2 * half], bv[2 * half + 1]);
          mma_16816(oacc[mt], al, bv[2 * half], bv[2 * half + 1]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = mt * 16 + g + 8 * hr;
        if (t0 + i >= S) continue;
        const float win = sWin[i] * scale, den = sDen[i];
        *reinterpret_cast<__nv_bfloat162*>(hb + static_cast<size_t>(t0 + i) * step_v + n8 +
                                           2 * t4) =
            __floats2bfloat162_rn(fmaf(iacc[mt][2 * hr], win, oacc[mt][2 * hr]) / den,
                                  fmaf(iacc[mt][2 * hr + 1], win, oacc[mt][2 * hr + 1]) / den);
      }
    }
    m_prev = sCarry[1];
    __syncthreads();                      // the gates, v and D * s are free for the next chunk
    if (c + 1 < nchunks) {
      issue_v(c + 1);
      cp_async_commit();
    }
  }

  // the state after the last step
  for (int e = tid; e < Dk * TV; e += THREADS) {
    const int d = e / TV, j = e % TV;
    Cout[(bh * Dk + d) * Dv + v0 + j] = sC[d * TC_LDC + j];
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < Dk; d += THREADS) nout[bh * Dk + d] = sN[d];
    if (tid == 0) mout[bh] = m_prev;
  }
}

cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* ig,
                        const void* fg, const void* C0, const void* n0, const void* m0, void* h,
                        void* C, void* n, void* m, int B, int S, int H, int Dk, int Dv,
                        float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(Dk);
  cudaError_t err = cudaFuncSetAttribute(mlstm_simt_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(Dv / TV, H, B);
  mlstm_simt_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(ig), static_cast<const float*>(fg),
      static_cast<const float*>(C0), static_cast<const float*>(n0),
      static_cast<const float*>(m0), static_cast<float*>(h), static_cast<float*>(C),
      static_cast<float*>(n), static_cast<float*>(m), S, H, Dk, Dv, scale);
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* ig,
                      const void* fg, const void* C0, const void* n0, const void* m0, void* h,
                      void* C, void* n, void* m, int B, int S, int H, int Dk, int Dv,
                      float scale, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      mlstm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(TcLayout(MAX_DK).bytes));
  if (attr != cudaSuccess) return attr;
  const size_t smem = TcLayout((Dk + TC_KB - 1) / TC_KB * TC_KB).bytes;
  const dim3 grid(Dv / TV, H, B);
  mlstm_tc_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(ig),
      static_cast<const float*>(fg), static_cast<const float*>(C0),
      static_cast<const float*>(n0), static_cast<const float*>(m0),
      static_cast<__nv_bfloat16*>(h), static_cast<float*>(C), static_cast<float*>(n),
      static_cast<float*>(m), S, H, Dk, Dv, scale);
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
    return repro::launch_tc(q, k, v, ig, fg, C0, n0, m0, h, C, n, m, B, S, H, Dk, Dv, scale, s);
  if (dtype == repro::kFloat32)
    return repro::launch_simt(q, k, v, ig, fg, C0, n0, m0, h, C, n, m, B, S, H, Dk, Dv, scale,
                              s);
  return cudaErrorInvalidValue;
}
