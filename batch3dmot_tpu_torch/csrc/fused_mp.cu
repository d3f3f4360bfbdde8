// Fused causal message passing + edge classifier for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of batch3dmot_tpu/ops/pallas_mp.py,
// which compute one function, fused_mp_scores:
//   B1 _mp_kernel            (single-shot, E*N <= 128k)
//   B2 _mp_kernel_tiled      (edge tiles, E*N up to 2M / 4M)
//   B3 _mp_kernel_tiled_hbm  (edge state in HBM, up to (512, 8192))
// One kernel family here covers every bucket up to (1024, 32768).
//
// What it computes, per window b (masked edges carry index -1):
//   depth times:
//     ue   = MLP3([x_i, x_j, e, att?])            (edge update)
//     f    = MLP2([x_i, ue, x0_i])                (future message -> src)
//     p    = MLP2([x_j, ue, x0_j])                (past message   -> dst)
//     x    = MLP3([sum_{dst=n} p, sum_{src=n} f]) (combine)
//     e    = ue
//   logit = MLP4(e)[0]; sigmoid unless `logits`.
// Weights are f32 [in, out] (flax layout); a masked edge gathers zero rows
// and is left out of both sums.
//
// What bounds it: fp32 FMA work on the CUDA cores (this kernel keeps the
// arithmetic in fp32; tensor cores would change the numbers). Per edge and
// layer the edge-side MLPs are ~0.54 MFLOP; one padded (256, 4096) window
// at depth 6 is ~13.6 GFLOP against ~2 MiB of inputs and outputs, far above
// the card's operations-per-byte line. The design spends its effort on the
// arithmetic and keeps the bytes simple:
//   * The TPU kernels build one-hot gather/scatter matrices for the MXU; on
//     this card that is N times the work, so rows are gathered by index.
//   * The x-dependent parts of every first layer (x_i @ W, x_j @ W) and the
//     loop-invariant x0 parts are projected once per NODE (proj_kernel and
//     the tail of node_kernel) and gathered per edge, which takes ~45% of
//     the edge FLOPs away (a reassociation of the same sums).
//   * A window's state does not fit in a block's shared memory, so x, e,
//     the node projections and the messages stay in global memory (L2
//     resident at these sizes). A block stages 32 edge rows (16 node rows)
//     of activations in shared memory; each thread computes an 8-row x
//     up-to-8-column tile from float4 shared loads, and the weight K-chunks
//     stream through a double-buffered cp.async stage.
//   * Blocks run in no order, so nothing is carried between them: per
//     layer one launch updates the edges (edge_kernel) and a second one
//     sums messages per node over a CSR built by the caller (node_kernel).
//     The CSR lists a node's edges in edge order, so the sums are
//     deterministic and in the order of a serial index_add_.
// Launches per forward: 1 + 2 * depth + 1. The edge kernel is still far
// from the fp32 peak (its times are in PERF.md): 254 registers leave 8
// warps per SM to hide the shared-memory, barrier and gather latencies.

#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per block: 4 warps, one row group each
constexpr int KC = 16;   // weight rows staged per step (double-buffered)
constexpr int SW = 2 * KC * 256;  // floats of the two weight stages

struct Params {
  int B, N, E, nd, ed, with_att;
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
// activations (a warp-wide broadcast) and 4 weight vectors, then issues
// 4*TM*TN FMAs. The weight stages are double-buffered: the copy of step
// i+1 is in flight while step i is multiplied. K and lda must be
// multiples of 4 (checked on the host).
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

// Edge-side kernels take 32 rows per block (8 per warp), the node kernel 16
// (4 per warp) so that a (256-node, 8-window) batch still fills the card.
constexpr int EDGE_TM = 8, NODE_TM = 4;
constexpr int EDGE_ROWS = EDGE_TM * NT / 32, NODE_ROWS = NODE_TM * NT / 32;

// Node projections of x0 for every column of the projection (the x part of
// the first layers and the loop-invariant x0 part).
__global__ void __launch_bounds__(NT, 2)
proj_kernel(Params p, const float* __restrict__ x0, float* __restrict__ npb) {
  extern __shared__ float smem[];
  const int rows = EDGE_ROWS;
  float* sX = smem;
  float* sW = sX + rows * p.nd;
  const int b = blockIdx.y, n0 = blockIdx.x * rows;
  for (int t = threadIdx.x; t < rows * p.nd; t += blockDim.x) {
    const int r = t / p.nd, c = t - r * p.nd, n = n0 + r;
    sX[t] = n < p.N ? x0[((size_t)b * p.N + n) * p.nd + c] : 0.f;
  }
  __syncthreads();
  float* out = npb + (size_t)b * p.N * p.PW;
  block_gemm<EDGE_TM>(sX, p.nd, p.nd, p.Wp, p.PW, p.PW, sW,
             [&](int r, int c, float v) {
               const int n = n0 + r;
               if (n < p.N) out[(size_t)n * p.PW + c] = v;
             });
}

// One layer's edge side: edge update (written in place into e), future and
// past messages (written to fbuf / pbuf).
__global__ void __launch_bounds__(NT, 2)
edge_kernel(Params p, const float* __restrict__ npb_all, float* e_state,
            const float* __restrict__ att, const int* __restrict__ src,
            const int* __restrict__ dst, float* __restrict__ pbuf,
            float* __restrict__ fbuf) {
  extern __shared__ float smem[];
  const int rows = EDGE_ROWS;
  const int ea_w = p.ed * (p.with_att ? 2 : 1);
  const int hw = max(p.H1, p.M1);
  int* sSrc = reinterpret_cast<int*>(smem);
  int* sDst = sSrc + rows;
  float* sA = smem + 2 * rows;
  float* sH1 = sA + rows * ea_w;
  float* sH2 = sH1 + rows * hw;
  float* sUE = sH2 + rows * p.H2;
  float* sW = sUE + rows * p.ed;

  const int b = blockIdx.y, e0 = blockIdx.x * rows;
  const size_t row0 = (size_t)b * p.E + e0;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const bool ok = e0 + r < p.E;
    sSrc[r] = ok ? src[row0 + r] : -1;
    sDst[r] = ok ? dst[row0 + r] : -1;
  }
  // [e | att] rows; e is read here, before any write to it below
  for (int t = threadIdx.x; t < rows * ea_w; t += blockDim.x) {
    const int r = t / ea_w, c = t - r * ea_w;
    float v = 0.f;
    if (e0 + r < p.E)
      v = c < p.ed ? e_state[(row0 + r) * p.ed + c]
                   : att[(row0 + r) * p.ed + c - p.ed];
    sA[t] = v;
  }
  __syncthreads();

  const float* npb = npb_all + (size_t)b * p.N * p.PW;
  const int H1 = p.H1, H2 = p.H2, M1 = p.M1, M = p.M, ed = p.ed, PW = p.PW;

  // h1 = relu(x_i W0a + x_j W0b + [e|att] W0cd + b0)
  block_gemm<EDGE_TM>(sA, ea_w, ea_w, p.Wea, H1, H1, sW, [&](int r, int c, float v) {
    v += p.eb0[c];
    const int i = sDst[r], j = sSrc[r];
    if (i >= 0) v += npb[(size_t)i * PW + p.o_eui + c];
    if (j >= 0) v += npb[(size_t)j * PW + p.o_euj + c];
    sH1[r * H1 + c] = fmaxf(v, 0.f);
  });
  block_gemm<EDGE_TM>(sH1, H1, H1, p.W1, H2, H2, sW, [&](int r, int c, float v) {
    sH2[r * H2 + c] = fmaxf(v + p.b1[c], 0.f);
  });
  block_gemm<EDGE_TM>(sH2, H2, H2, p.W2, ed, ed, sW, [&](int r, int c, float v) {
    v += p.b2[c];
    sUE[r * ed + c] = v;
    if (e0 + r < p.E) e_state[(row0 + r) * ed + c] = v;
  });
  // future message: relu(x_i F0a + ue F0b + x0_i F0c + fb0) F1 + fb1
  block_gemm<EDGE_TM>(sUE, ed, ed, p.Fue, M1, M1, sW, [&](int r, int c, float v) {
    v += p.fb0[c];
    const int i = sDst[r];
    if (i >= 0) {
      const float* q = npb + (size_t)i * PW;
      v += q[p.o_fut + c] + q[p.o_fx0 + c];
    }
    sH1[r * M1 + c] = fmaxf(v, 0.f);
  });
  block_gemm<EDGE_TM>(sH1, M1, M1, p.F1, M, M, sW, [&](int r, int c, float v) {
    if (e0 + r < p.E) fbuf[(row0 + r) * M + c] = v + p.fb1[c];
  });
  // past message: relu(x_j P0a + ue P0b + x0_j P0c + pb0) P1 + pb1
  block_gemm<EDGE_TM>(sUE, ed, ed, p.Pue, M1, M1, sW, [&](int r, int c, float v) {
    v += p.pb0[c];
    const int j = sSrc[r];
    if (j >= 0) {
      const float* q = npb + (size_t)j * PW;
      v += q[p.o_past + c] + q[p.o_px0 + c];
    }
    sH1[r * M1 + c] = fmaxf(v, 0.f);
  });
  block_gemm<EDGE_TM>(sH1, M1, M1, p.P1, M, M, sW, [&](int r, int c, float v) {
    if (e0 + r < p.E) pbuf[(row0 + r) * M + c] = v + p.pb1[c];
  });
}

// One layer's node side: per-node sums over the CSR rows (past messages by
// destination, future messages by source), the combine MLP, then the node
// projections of the new x for the next layer (skipped after the last).
// Blocks of 16 nodes, so that a (256-node, 8-window) batch fills the card.
__global__ void __launch_bounds__(NT, 3)
node_kernel(Params p, const float* __restrict__ pbuf,
            const float* __restrict__ fbuf, const int* __restrict__ doff,
            const int* __restrict__ dperm, const int* __restrict__ soff,
            const int* __restrict__ sperm, float* __restrict__ npb_all,
            int write_proj) {
  extern __shared__ float smem[];
  const int rows = NODE_ROWS;
  const int M = p.M, M2 = 2 * p.M, C1 = p.C1, C2 = p.C2, nd = p.nd;
  float* sAgg = smem;
  float* sC1 = sAgg + rows * M2;
  float* sC2 = sC1 + rows * C1;
  float* sX = sC2 + rows * C2;
  float* sW = sX + rows * nd;
  const int b = blockIdx.y, n0 = blockIdx.x * rows;

  for (int t = threadIdx.x; t < rows * M2; t += blockDim.x) {
    const int r = t / M2, c = t - r * M2, n = n0 + r;
    float v = 0.f;
    if (n < p.N) {
      const int k = b * (p.N + 1) + n;
      if (c < M) {
        for (int q = doff[k]; q < doff[k + 1]; ++q)
          v += pbuf[(size_t)dperm[q] * M + c];
      } else {
        for (int q = soff[k]; q < soff[k + 1]; ++q)
          v += fbuf[(size_t)sperm[q] * M + c - M];
      }
    }
    sAgg[t] = v;
  }
  __syncthreads();

  block_gemm<NODE_TM>(sAgg, M2, M2, p.C0, C1, C1, sW, [&](int r, int c, float v) {
    sC1[r * C1 + c] = fmaxf(v + p.cb0[c], 0.f);
  });
  block_gemm<NODE_TM>(sC1, C1, C1, p.C1w, C2, C2, sW, [&](int r, int c, float v) {
    sC2[r * C2 + c] = fmaxf(v + p.cb1[c], 0.f);
  });
  block_gemm<NODE_TM>(sC2, C2, C2, p.C2w, nd, nd, sW, [&](int r, int c, float v) {
    sX[r * nd + c] = v + p.cb2[c];
  });
  if (!write_proj) return;
  float* out = npb_all + (size_t)b * p.N * p.PW;
  block_gemm<NODE_TM>(sX, nd, nd, p.Wp, p.PW, p.QW, sW, [&](int r, int c, float v) {
    const int n = n0 + r;
    if (n < p.N) out[(size_t)n * p.PW + c] = v;
  });
}

// Edge classifier MLP on the final edge state; row 0 of its output.
__global__ void __launch_bounds__(NT, 2)
classifier_kernel(Params p, const float* __restrict__ e_state,
                  float* __restrict__ out, int logits) {
  extern __shared__ float smem[];
  const int rows = EDGE_ROWS;
  const int w = max(max(p.ed, p.L1), max(p.L2, p.L3));
  float* sA = smem;
  float* sB = sA + rows * w;
  float* sW = sB + rows * w;
  const int b = blockIdx.y, e0 = blockIdx.x * rows;
  const size_t row0 = (size_t)b * p.E + e0;
  for (int t = threadIdx.x; t < rows * p.ed; t += blockDim.x) {
    const int r = t / p.ed, c = t - r * p.ed;
    sA[r * w + c] = e0 + r < p.E ? e_state[(row0 + r) * p.ed + c] : 0.f;
  }
  __syncthreads();
  block_gemm<EDGE_TM>(sA, w, p.ed, p.L0, p.L1, p.L1, sW, [&](int r, int c, float v) {
    sB[r * w + c] = fmaxf(v + p.lb0[c], 0.f);
  });
  block_gemm<EDGE_TM>(sB, w, p.L1, p.L1w, p.L2, p.L2, sW, [&](int r, int c, float v) {
    sA[r * w + c] = fmaxf(v + p.lb1[c], 0.f);
  });
  block_gemm<EDGE_TM>(sA, w, p.L2, p.L2w, p.L3, p.L3, sW, [&](int r, int c, float v) {
    sB[r * w + c] = fmaxf(v + p.lb2[c], 0.f);
  });
  block_gemm<EDGE_TM>(sB, w, p.L3, p.L3w, 1, 1, sW, [&](int r, int c, float v) {
    if (e0 + r < p.E) {
      v += p.lb3[0];
      out[row0 + r] = logits ? v : 1.f / (1.f + expf(-v));
    }
  });
}

// Dynamic shared memory above 48 KB has to be allowed per kernel.
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// dims: B, N, E, nd, ed, with_att, depth, logits, H1, H2, M1, M, C1, C2,
//       L1, L2, L3
// woff: float offsets into wblob of the 29 weight arrays, in the order of
//       Params (Wea ... lb3); see ops/fused_mp.py::pack_mp_weights.
// e_state holds e0 on entry and the final edge state on return.
// Returns the first CUDA error (0 on success); nothing is synchronised.
extern "C" int fused_mp_forward(const int* dims, const long long* woff,
                                const float* wblob, const float* x0,
                                float* e_state, const float* att,
                                const int* src, const int* dst,
                                const int* doff, const int* dperm,
                                const int* soff, const int* sperm,
                                float* npb, float* pbuf, float* fbuf,
                                float* out, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  Params p;
  p.B = dims[0]; p.N = dims[1]; p.E = dims[2]; p.nd = dims[3]; p.ed = dims[4];
  p.with_att = dims[5];
  const int depth = dims[6], logits = dims[7];
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
  // the block products read activations as float4 along K
  const int ks[] = {p.nd, p.ed, p.H1, p.H2, p.M1, p.M, p.C1, p.C2,
                    p.L1, p.L2, p.L3};
  for (int k : ks)
    if (k % 4) return cudaErrorInvalidValue;
  const float** w[] = {
      &p.Wea, &p.eb0, &p.W1, &p.b1, &p.W2, &p.b2,
      &p.Fue, &p.fb0, &p.F1, &p.fb1,
      &p.Pue, &p.pb0, &p.P1, &p.pb1,
      &p.C0, &p.cb0, &p.C1w, &p.cb1, &p.C2w, &p.cb2,
      &p.Wp,
      &p.L0, &p.lb0, &p.L1w, &p.lb1, &p.L2w, &p.lb2, &p.L3w, &p.lb3};
  for (int i = 0; i < 29; ++i) *w[i] = wblob + woff[i];

  const size_t f = sizeof(float);
  const size_t sw = (size_t)SW * f;
  const int er = EDGE_ROWS, nr = NODE_ROWS;
  const int ea_w = p.ed * (p.with_att ? 2 : 1);
  const size_t proj_smem = (size_t)er * p.nd * f + sw;
  const size_t edge_smem =
      2 * er * sizeof(int) +
      (size_t)er * (ea_w + (p.H1 > p.M1 ? p.H1 : p.M1) + p.H2 + p.ed) * f + sw;
  const size_t node_smem =
      (size_t)nr * (2 * p.M + p.C1 + p.C2 + p.nd) * f + sw;
  int cw = p.ed;
  if (p.L1 > cw) cw = p.L1;
  if (p.L2 > cw) cw = p.L2;
  if (p.L3 > cw) cw = p.L3;
  const size_t cls_smem = (size_t)2 * er * cw * f + sw;

  cudaError_t err;
  if ((err = allow_smem(proj_kernel, proj_smem))) return err;
  if ((err = allow_smem(edge_kernel, edge_smem))) return err;
  if ((err = allow_smem(node_kernel, node_smem))) return err;
  if ((err = allow_smem(classifier_kernel, cls_smem))) return err;

  const dim3 proj_grid((p.N + er - 1) / er, p.B);
  const dim3 node_grid((p.N + nr - 1) / nr, p.B);
  const dim3 edge_grid((p.E + er - 1) / er, p.B);
  proj_kernel<<<proj_grid, NT, proj_smem, stream>>>(p, x0, npb);
  if ((err = cudaGetLastError())) return err;
  for (int layer = 0; layer < depth; ++layer) {
    edge_kernel<<<edge_grid, NT, edge_smem, stream>>>(
        p, npb, e_state, att, src, dst, pbuf, fbuf);
    if ((err = cudaGetLastError())) return err;
    node_kernel<<<node_grid, NT, node_smem, stream>>>(
        p, pbuf, fbuf, doff, dperm, soff, sperm, npb, layer + 1 < depth);
    if ((err = cudaGetLastError())) return err;
  }
  classifier_kernel<<<edge_grid, NT, cls_smem, stream>>>(p, e_state, out,
                                                              logits);
  return cudaGetLastError();
}
