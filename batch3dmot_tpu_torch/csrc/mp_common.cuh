// Building blocks shared by the fused message-passing kernels
// (fused_mp.cu: inference and the training forward; fused_mp_train.cu: the
// training backward): the weight-blob layout, the block-wide fp32 product
// (the classifiers and the backward's once-per-call products), the
// backward's node projection and the coalesced row store. The tensor-core
// products are in tc_gemm.cuh (the backward's) and tc_stream.cuh (the
// forward's); the design notes are in the two sources.

#pragma once

#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per block: 4 warps, one row group each
constexpr int KC = 16;   // weight rows staged per step (double-buffered)
constexpr int SW = 2 * KC * 256;  // floats of the two weight stages
constexpr int N_ARRAYS = 29;      // arrays of the weight blob

struct Params {
  int B, N, E, nd, ed, with_att, depth;
  int H1, H2, M1, M, C1, C2, L1, L2, L3;
  int PW, QW;  // node projection row width; x-dependent prefix of it
  // node projection column offsets
  int o_eui, o_euj, o_fut, o_past, o_fx0, o_px0;
  const float *Wea, *eb0, *W1, *b1, *W2, *b2;
  const float *Fue, *fb0, *F1, *fb1;
  const float *Pue, *pb0, *P1, *pb1;
  const float *C0, *cb0, *C1w, *cb1, *C2w, *cb2;
  const float *Wp;
  const float *L0, *lb0, *L1w, *lb1, *L2w, *lb2, *L3w, *lb3;
};

// dims: B, N, E, nd, ed, with_att, depth, logits, H1, H2, M1, M, C1, C2,
//       L1, L2, L3
// woff: float offsets into wblob of the 29 weight arrays, in the order of
//       Params (Wea ... lb3); see ops/fused_mp.py::pack_mp_weights.
// Returns false when a width is not a multiple of 4 (the block products
// read activations as float4 along K). Null woff: widths only.
inline bool fill_params(const int* dims, const long long* woff,
                        const float* wblob, Params& p) {
  p.B = dims[0]; p.N = dims[1]; p.E = dims[2]; p.nd = dims[3]; p.ed = dims[4];
  p.with_att = dims[5];
  p.depth = dims[6];
  p.H1 = dims[8]; p.H2 = dims[9]; p.M1 = dims[10]; p.M = dims[11];
  p.C1 = dims[12]; p.C2 = dims[13];
  p.L1 = dims[14]; p.L2 = dims[15]; p.L3 = dims[16];
  p.o_eui = 0;
  p.o_euj = p.H1;
  p.o_fut = 2 * p.H1;
  p.o_past = 2 * p.H1 + p.M1;
  p.o_fx0 = 2 * p.H1 + 2 * p.M1;
  p.o_px0 = 2 * p.H1 + 3 * p.M1;
  p.QW = 2 * p.H1 + 2 * p.M1;
  p.PW = 2 * p.H1 + 4 * p.M1;
  const int ks[] = {p.nd, p.ed, p.H1, p.H2, p.M1, p.M, p.C1, p.C2,
                    p.L1, p.L2, p.L3};
  for (int k : ks)
    if (k % 4) return false;
  if (!woff) return true;
  const float** w[N_ARRAYS] = {
      &p.Wea, &p.eb0, &p.W1, &p.b1, &p.W2, &p.b2,
      &p.Fue, &p.fb0, &p.F1, &p.fb1,
      &p.Pue, &p.pb0, &p.P1, &p.pb1,
      &p.C0, &p.cb0, &p.C1w, &p.cb1, &p.C2w, &p.cb2,
      &p.Wp,
      &p.L0, &p.lb0, &p.L1w, &p.lb1, &p.L2w, &p.lb2, &p.L3w, &p.lb3};
  for (int i = 0; i < N_ARRAYS; ++i) *w[i] = wblob + woff[i];
  return true;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Output columns of one pass held by a thread: TN <= 3 strides them by 32
// (lane + 32 j); TN = 4, 6, 8 gives each lane a quad 4l..4l+3 of the first
// 128 columns and, for 6 and 8, a pair 128 + 2l or a quad 128 + 4l of the
// rest, so every warp-wide weight load is contiguous.
template <int TN>
struct Cols {
  static constexpr int width = TN <= 3 ? 32 * TN : TN == 4 ? 128 : TN == 6 ? 192 : 256;
  __device__ __forceinline__ static int col(int lane, int j) {
    if (TN <= 3) return lane + 32 * j;
    if (j < 4) return 4 * lane + j;
    return TN == 8 ? 128 + 4 * lane + (j - 4) : 128 + 2 * lane + (j - 4);
  }
  __device__ __forceinline__ static void load(const float* row, int lane, float* w) {
    if (TN <= 3) {
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = row[lane + 32 * j];
      return;
    }
    const float4 q = *reinterpret_cast<const float4*>(row + 4 * lane);
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    if (TN == 8) {
      const float4 r = *reinterpret_cast<const float4*>(row + 128 + 4 * lane);
      w[4] = r.x; w[5] = r.y; w[6] = r.z; w[7] = r.w;
    } else if (TN == 6) {
      const float2 r = *reinterpret_cast<const float2*>(row + 128 + 2 * lane);
      w[4] = r.x; w[5] = r.y;
    }
  }
};

// Stage rows k0..k0+kc of W[:, c0:c0+nc] into sW [kc][width], zero past nc.
// 16-byte cp.async copies where the layout allows, plain loads otherwise;
// the caller commits and waits.
__device__ __forceinline__ void stage_w(float* sW, int width,
                                        const float* __restrict__ W, int ldw,
                                        int k0, int kc, int c0, int nc) {
  if ((ldw & 3) == 0 && (c0 & 3) == 0 && (nc & 3) == 0) {
    const int q = width >> 2;
    for (int t = threadIdx.x; t < kc * q; t += blockDim.x) {
      const int kk = t / q, c = 4 * (t - kk * q);
      float* dst = sW + kk * width + c;
      if (c < nc)
        __pipeline_memcpy_async(dst, W + (size_t)(k0 + kk) * ldw + c0 + c, 16);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int t = threadIdx.x; t < kc * width; t += blockDim.x) {
      const int kk = t / width, c = t - kk * width;
      sW[t] = c < nc ? W[(size_t)(k0 + kk) * ldw + c0 + c] : 0.f;
    }
  }
  __pipeline_commit();
}

// out[rows, c0:c0+nc] = sA[rows, :K] @ W[:K, c0:c0+nc], handed to
// epi(row, col, value). Warp w owns rows TM*w .. TM*w+TM-1 and its lanes
// the columns of Cols<TN>: per 4 K steps a thread reads TM float4s of
// activations (a warp-wide broadcast) and 4 weight vectors, then runs
// 4*TM*TN FMAs. The weight stages are double-buffered: the copy of step
// i+1 is in flight while step i is multiplied. K and lda must be
// multiples of 4 (checked on the host). Each output is one FMA chain over
// k = 0..K-1 in order, whatever TM and TN are.
template <int TM, int TN, class Epi>
__device__ __forceinline__ void gemm_pass(const float* sA, int lda, int K,
                                          const float* __restrict__ W, int ldw,
                                          int c0, int nc, float* sW, Epi& epi) {
  using C = Cols<TN>;
  constexpr int CW = C::width;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * TM;
  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;

  const int steps = (K + KC - 1) / KC;
  stage_w(sW, CW, W, ldw, 0, min(KC, K), c0, nc);
  for (int s = 0; s < steps; ++s) {
    const int k0 = s * KC, kc = min(KC, K - k0);
    float* cur = sW + (s & 1) * KC * 256;
    __pipeline_wait_prior(0);
    __syncthreads();
    if (s + 1 < steps)
      stage_w(sW + ((s + 1) & 1) * KC * 256, CW, W, ldw, k0 + KC,
              min(KC, K - k0 - KC), c0, nc);
    for (int kk = 0; kk < kc; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m)
        a[m] = *reinterpret_cast<const float4*>(sA + (r0 + m) * lda + k0 + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float w[TN];
        C::load(cur + (kk + u) * CW, lane, w);
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n)
            acc[m][n] = fmaf(comp(a[m], u), w[n], acc[m][n]);
      }
    }
  }
  __syncthreads();  // every read of the stages is done before they refill
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int c = C::col(lane, n);
      if (c < nc) epi(r0 + m, c0 + c, acc[m][n]);
    }
}

// Full-width product in passes of up to 256 columns; ends with a barrier so
// the epilogue's shared-memory writes are visible to the next product.
template <int TM, class Epi>
__device__ void block_gemm(const float* sA, int lda, int K,
                           const float* __restrict__ W, int ldw, int N,
                           float* sW, Epi epi) {
  for (int c0 = 0; c0 < N; c0 += 256) {
    const int nc = min(256, N - c0);
    if (nc <= 32) gemm_pass<TM, 1>(sA, lda, K, W, ldw, c0, nc, sW, epi);
    else if (nc <= 64) gemm_pass<TM, 2>(sA, lda, K, W, ldw, c0, nc, sW, epi);
    else if (nc <= 96) gemm_pass<TM, 3>(sA, lda, K, W, ldw, c0, nc, sW, epi);
    else if (nc <= 128) gemm_pass<TM, 4>(sA, lda, K, W, ldw, c0, nc, sW, epi);
    else if (nc <= 192) gemm_pass<TM, 6>(sA, lda, K, W, ldw, c0, nc, sW, epi);
    else gemm_pass<TM, 8>(sA, lda, K, W, ldw, c0, nc, sW, epi);
  }
  __syncthreads();
}

// Edge-side kernels take 32 rows per block (8 per warp), the node kernels
// 16 (4 per warp) so that a (256-node, 8-window) batch still fills the card.
constexpr int EDGE_TM = 8, NODE_TM = 4;
constexpr int EDGE_ROWS = EDGE_TM * NT / 32, NODE_ROWS = NODE_TM * NT / 32;

// Node projections (the training backward's): the first `ncols` columns of
// x @ Wp for every node (all PW columns: the x part of the first layers and
// the loop-invariant x0 part; QW columns: the x part only). Window b's rows
// start at x + b * x_win.
__global__ void __launch_bounds__(NT, 2)
proj_kernel(Params p, const float* __restrict__ x, long long x_win,
            float* __restrict__ npb, int ncols) {
  extern __shared__ float smem[];
  const int rows = EDGE_ROWS;
  float* sX = smem;
  float* sW = sX + rows * p.nd;
  const int b = blockIdx.y, n0 = blockIdx.x * rows;
  for (int t = threadIdx.x; t < rows * p.nd; t += blockDim.x) {
    const int r = t / p.nd, c = t - r * p.nd, n = n0 + r;
    sX[t] = n < p.N ? x[b * x_win + (size_t)n * p.nd + c] : 0.f;
  }
  __syncthreads();
  float* out = npb + (size_t)b * p.N * p.PW;
  block_gemm<EDGE_TM>(sX, p.nd, p.nd, p.Wp, p.PW, ncols, sW,
             [&](int r, int c, float v) {
               const int n = n0 + r;
               if (n < p.N) out[(size_t)n * p.PW + c] = v;
             });
}

// Rows [0, n) of the shared array s (row stride ls) to g (row stride W,
// a multiple of 4) in coalesced 16-byte pieces: the layer kernels write
// their rows this way, not element by element from the product epilogues
// (whose fragment layout scatters the stores).
__device__ __forceinline__ void store_rows(const float* s, int ls, float* g,
                                           int W, int n) {
  const int q = W >> 2;
  for (int i = threadIdx.x; i < n * q; i += blockDim.x) {
    const int r = i / q, c = 4 * (i - r * q);
    *reinterpret_cast<float4*>(g + (size_t)r * W + c) =
        *reinterpret_cast<const float4*>(s + r * ls + c);
  }
}

// Dynamic shared memory above 48 KB has to be allowed per kernel.
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
