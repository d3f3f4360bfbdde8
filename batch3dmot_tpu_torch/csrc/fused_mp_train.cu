// Hand-written backward of the fused message passing + edge classifier for
// NVIDIA Hopper (sm_90a).
//
// Replaces the backward halves of the Pallas training kernel pairs of
// batch3dmot_tpu/ops/pallas_mp_train.py:
//   B5 _train_bwd_kernel        (:295, E*N <= 32k)
//   B7 _train_bwd_kernel_tiled  (:680, edge tiles, E*N up to 1M / 2M)
// for every bucket up to (1024, 32768). It reads the stashes of the
// training forward (fused_mp.cu::fused_mp_forward_stash: x_t, e_t, agg_t)
// and the cotangent ds of the scores, and writes dx0, de0, datt and the
// gradient of every array of the weight blob (the blob's own layout),
// summed over the windows.
//
// Per window batch (all windows at once, in launch order):
//   1. cls_bwd_kernel: recompute the classifier from e_depth; ds * s(1-s)
//      from the recomputed logit (sigmoid scores) or ds (logits); the
//      chain down to the cotangent of e_depth, the carried dUE.
//   2. for t = depth-1 .. 0:
//      a. proj_kernel: the x-dependent node projections of x_t (the x0
//         columns are projected once, before the loop);
//      b. node_bwd_kernel: recompute c1, c2 from agg_t, then the combine
//         backward per node: dX -> dc2 -> dc1 -> [dA | dB];
//      c. edge_bwd_kernel: recompute h1, h2, f1, p1 per edge (ue is e_{t+1}
//         from the stash), gather dp = dA[dst], df = dB[src] (zero rows for
//         masked edges), run the past, future and edge-update chains with
//         the carried dUE, and overwrite dUE with the cotangent of e_t; the
//         attention part of the first layer accumulates into datt;
//      d. node_scatter_kernel: per node, the sums over the forward's CSRs
//         S = [sum_dst dh1 | sum_src dh1 | sum_dst df1 | sum_src dp1], then
//         dX_t = S Wp[:, :QW]^T (the per-node projection of the forward,
//         transposed: the same sums, reassociated) and T += the x0 part;
//      e. the layer's weight gradients (below).
//   3. dx0_kernel: dx0 = dX_0 + T Wp[:, QW:]^T; the x0 weight gradients.
// A masked edge gathers zero rows and belongs to no node's CSR row, as in
// the Pallas kernels, but its own chain (edge update, classifier) runs like
// any other, so a cotangent on it reaches the weights as in plain autograd.
//
// Weight gradients: every dW is H_in^T D_out, a product over the edge rows
// (or the node rows, for the combine MLP and the node projections) of an
// activation and a cotangent held in the workspace; a bias gradient is a
// column sum. One wgrad_kernel launch per batch of products splits the rows
// into a fixed number of chunks (at most 64, >= 256 rows each) and writes
// one 64x64 output tile per (product, tile, chunk) block to a partial
// buffer; wgrad_reduce_kernel then sums the chunks in order and adds the
// result to the gradient blob. No float atomics: the same inputs give
// bit-identical gradients. The partials hold at most 64 x the weights of
// one batch (~82 MB at mm widths), never per-block copies of all weights.
//
// What bounds it: fp32 FMA work on the CUDA cores, like the forward. Per
// edge and layer at mm widths the backward recomputes 0.18 MFLOP, runs
// 0.29 MFLOP of cotangent chain and 0.29 MFLOP of weight products; a
// (256, 4096) x8 batch at depth 6 is ~150 GFLOP over its padded edges
// (91 GFLOP over the valid ones, chip_smoke.py train_work) against a few
// hundred MB of stash and scratch traffic, far above the card's
// operations-per-byte line. The design keeps every product a block-wide fp32 product from
// shared memory (the forward's block_gemm, with the transposed weights the
// wrapper packs) and keeps the sums deterministic; it does not yet use the
// tensor cores.
//
// Workspace at (1024, 32768) x1 and mm widths (fused_mp_train_workspace):
// the per-edge recompute and cotangents (h1, h2, f1, p1, dp, df, dp1, df1,
// due, dh2, dh1: 1856 floats per edge) 243 MB, the classifier's 15 MB,
// the node projections and node scratch 15 MB, and the partials 82 MB.

#include "mp_common.cuh"

namespace {

// Transposed weights ([out, in]) the backward multiplies by, packed by the
// wrapper in this order (ops/fused_mp_train.py::_TRANSPOSED).
struct TParams {
  const float *P1T, *F1T, *PueT, *FueT, *W2T, *W1T, *WeaT;
  const float *C2wT, *C1wT, *C0T, *WpT, *L2wT, *L1wT, *L0T;
};
constexpr int N_TARRAYS = 14;

// Workspace regions ([rows, width] row-major; edge rows b * E + e, node
// rows b * N + n).
struct Work {
  float *npb;
  float *h1, *h2, *f1, *p1, *dp, *df, *dp1, *df1, *due, *dh2, *dh1;
  float *a1, *a2, *a3, *dz, *da1, *da2, *da3;
  float *c1, *c2, *dc2, *dc1, *dab, *S, *T, *dxa, *dxb;
  float *partial;
  long long partial_cap;
};

// Largest sum of K * F over one batch of weight products.
long long max_batch_weights(const Params& p) {
  const long long ea_w = (long long)p.ed * (p.with_att ? 2 : 1);
  const long long layer =
      2LL * p.M1 * p.M + 2 * p.M + 2LL * p.ed * p.M1 + 2 * p.M1 +
      (long long)p.H2 * p.ed + p.ed + (long long)p.H1 * p.H2 + p.H2 +
      ea_w * p.H1 + p.H1 + (long long)p.C2 * p.nd + p.nd +
      (long long)p.C1 * p.C2 + p.C2 + 2LL * p.M * p.C1 + p.C1 +
      (long long)p.nd * p.QW;
  const long long cls = (long long)p.ed * p.L1 + p.L1 + p.L1 * p.L2 + p.L2 +
                        p.L2 * p.L3 + p.L3 + p.L3 + 1;
  const long long fin = 2LL * p.nd * p.M1;
  long long m = layer > cls ? layer : cls;
  return m > fin ? m : fin;
}

constexpr int WG_MAX_CHUNKS = 64;

// Carves the workspace from base (null: only sizes it). Returns floats.
long long carve(const Params& p, float* base, Work& w) {
  long long pos = 0;
  auto take = [&](float*& ptr, long long n) {
    ptr = base ? base + pos : nullptr;
    pos += (n + 3) / 4 * 4;  // keep every region 16-byte aligned
  };
  const long long er = (long long)p.B * p.E, nr = (long long)p.B * p.N;
  take(w.npb, nr * p.PW);
  take(w.h1, er * p.H1);
  take(w.h2, er * p.H2);
  take(w.f1, er * p.M1);
  take(w.p1, er * p.M1);
  take(w.dp, er * p.M);
  take(w.df, er * p.M);
  take(w.dp1, er * p.M1);
  take(w.df1, er * p.M1);
  take(w.due, er * p.ed);
  take(w.dh2, er * p.H2);
  take(w.dh1, er * p.H1);
  take(w.a1, er * p.L1);
  take(w.a2, er * p.L2);
  take(w.a3, er * p.L3);
  take(w.dz, er);
  take(w.da1, er * p.L1);
  take(w.da2, er * p.L2);
  take(w.da3, er * p.L3);
  take(w.c1, nr * p.C1);
  take(w.c2, nr * p.C2);
  take(w.dc2, nr * p.C2);
  take(w.dc1, nr * p.C1);
  take(w.dab, nr * 2 * p.M);
  take(w.S, nr * p.QW);
  take(w.T, nr * 2 * p.M1);
  take(w.dxa, nr * p.nd);
  take(w.dxb, nr * p.nd);
  w.partial_cap = WG_MAX_CHUNKS * max_batch_weights(p);
  take(w.partial, w.partial_cap);
  return pos;
}

// ---------------------------------------------------------------------------
// Classifier backward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT, 2)
cls_bwd_kernel(Params p, TParams q, const float* __restrict__ e_fin,
               long long e_win, const float* __restrict__ ds, int logits,
               Work w, float* __restrict__ dUE) {
  extern __shared__ float smem[];
  const int rows = EDGE_ROWS;
  const int ed = p.ed, L1 = p.L1, L2 = p.L2, L3 = p.L3;
  float* sE = smem;
  float* sA1 = sE + rows * ed;
  float* sA2 = sA1 + rows * L1;
  float* sA3 = sA2 + rows * L2;
  float* sDZ = sA3 + rows * L3;
  float* sD3 = sDZ + rows;
  float* sD2 = sD3 + rows * L3;
  float* sD1 = sD2 + rows * L2;
  float* sW = sD1 + rows * L1;
  const int b = blockIdx.y, e0 = blockIdx.x * rows;
  const size_t row0 = (size_t)b * p.E + e0;
  const float* ein = e_fin + b * e_win + (size_t)e0 * ed;
  for (int t = threadIdx.x; t < rows * ed; t += blockDim.x) {
    const int r = t / ed;
    sE[t] = e0 + r < p.E ? ein[t] : 0.f;
  }
  __syncthreads();
  auto ok = [&](int r) { return e0 + r < p.E; };
  block_gemm<EDGE_TM>(sE, ed, ed, p.L0, L1, L1, sW, [&](int r, int c, float v) {
    v = fmaxf(v + p.lb0[c], 0.f);
    sA1[r * L1 + c] = v;
    if (ok(r)) w.a1[(row0 + r) * L1 + c] = v;
  });
  block_gemm<EDGE_TM>(sA1, L1, L1, p.L1w, L2, L2, sW, [&](int r, int c, float v) {
    v = fmaxf(v + p.lb1[c], 0.f);
    sA2[r * L2 + c] = v;
    if (ok(r)) w.a2[(row0 + r) * L2 + c] = v;
  });
  block_gemm<EDGE_TM>(sA2, L2, L2, p.L2w, L3, L3, sW, [&](int r, int c, float v) {
    v = fmaxf(v + p.lb2[c], 0.f);
    sA3[r * L3 + c] = v;
    if (ok(r)) w.a3[(row0 + r) * L3 + c] = v;
  });
  // d(logit): ds, times s(1 - s) of the recomputed logit for scores
  block_gemm<EDGE_TM>(sA3, L3, L3, p.L3w, 1, 1, sW, [&](int r, int c, float v) {
    const float z = v + p.lb3[0];
    float g = ok(r) ? ds[row0 + r] : 0.f;
    if (!logits) {
      const float s = 1.f / (1.f + expf(-z));
      g *= s * (1.f - s);
    }
    sDZ[r] = g;
    if (ok(r)) w.dz[row0 + r] = g;
  });
  for (int t = threadIdx.x; t < rows * L3; t += blockDim.x) {
    const int r = t / L3, c = t - r * L3;
    const float v = sA3[t] > 0.f ? sDZ[r] * p.L3w[c] : 0.f;
    sD3[t] = v;
    if (ok(r)) w.da3[(row0 + r) * L3 + c] = v;
  }
  __syncthreads();
  block_gemm<EDGE_TM>(sD3, L3, L3, q.L2wT, L2, L2, sW, [&](int r, int c, float v) {
    v = sA2[r * L2 + c] > 0.f ? v : 0.f;
    sD2[r * L2 + c] = v;
    if (ok(r)) w.da2[(row0 + r) * L2 + c] = v;
  });
  block_gemm<EDGE_TM>(sD2, L2, L2, q.L1wT, L1, L1, sW, [&](int r, int c, float v) {
    v = sA1[r * L1 + c] > 0.f ? v : 0.f;
    sD1[r * L1 + c] = v;
    if (ok(r)) w.da1[(row0 + r) * L1 + c] = v;
  });
  block_gemm<EDGE_TM>(sD1, L1, L1, q.L0T, ed, ed, sW, [&](int r, int c, float v) {
    if (ok(r)) dUE[(row0 + r) * ed + c] = v;
  });
}

// ---------------------------------------------------------------------------
// One layer, in reverse
// ---------------------------------------------------------------------------

// Recompute c1, c2 from the stashed message sums, then the combine MLP's
// backward: dc2 = (dX C2^T) * [c2 > 0], dc1 = (dc2 C1^T) * [c1 > 0],
// [dA | dB] = dc1 C0^T. dX is the cotangent of x_{t+1}.
__global__ void __launch_bounds__(NT, 2)
node_bwd_kernel(Params p, TParams q, const float* __restrict__ agg,
                long long agg_win, const float* __restrict__ dX, Work w) {
  extern __shared__ float smem[];
  const int rows = NODE_ROWS;
  const int M2 = 2 * p.M, C1 = p.C1, C2 = p.C2, nd = p.nd;
  float* sAgg = smem;
  float* sC1 = sAgg + rows * M2;
  float* sC2 = sC1 + rows * C1;
  float* sDX = sC2 + rows * C2;
  float* sW = sDX + rows * nd;
  const int b = blockIdx.y, n0 = blockIdx.x * rows;
  const size_t row0 = (size_t)b * p.N + n0;
  auto ok = [&](int r) { return n0 + r < p.N; };
  for (int t = threadIdx.x; t < rows * M2; t += blockDim.x) {
    const int r = t / M2;
    sAgg[t] = ok(r) ? agg[b * agg_win + (size_t)n0 * M2 + t] : 0.f;
  }
  for (int t = threadIdx.x; t < rows * nd; t += blockDim.x) {
    const int r = t / nd;
    sDX[t] = ok(r) ? dX[row0 * nd + t] : 0.f;
  }
  __syncthreads();
  block_gemm<NODE_TM>(sAgg, M2, M2, p.C0, C1, C1, sW, [&](int r, int c, float v) {
    v = fmaxf(v + p.cb0[c], 0.f);
    sC1[r * C1 + c] = v;
    if (ok(r)) w.c1[(row0 + r) * C1 + c] = v;
  });
  block_gemm<NODE_TM>(sC1, C1, C1, p.C1w, C2, C2, sW, [&](int r, int c, float v) {
    v = fmaxf(v + p.cb1[c], 0.f);
    sC2[r * C2 + c] = v;
    if (ok(r)) w.c2[(row0 + r) * C2 + c] = v;
  });
  // the masks are read and overwritten element by element: sC2 becomes
  // dc2, sC1 becomes dc1
  block_gemm<NODE_TM>(sDX, nd, nd, q.C2wT, C2, C2, sW, [&](int r, int c, float v) {
    v = sC2[r * C2 + c] > 0.f ? v : 0.f;
    sC2[r * C2 + c] = v;
    if (ok(r)) w.dc2[(row0 + r) * C2 + c] = v;
  });
  block_gemm<NODE_TM>(sC2, C2, C2, q.C1wT, C1, C1, sW, [&](int r, int c, float v) {
    v = sC1[r * C1 + c] > 0.f ? v : 0.f;
    sC1[r * C1 + c] = v;
    if (ok(r)) w.dc1[(row0 + r) * C1 + c] = v;
  });
  block_gemm<NODE_TM>(sC1, C1, C1, q.C0T, M2, M2, sW, [&](int r, int c, float v) {
    if (ok(r)) w.dab[(row0 + r) * M2 + c] = v;
  });
}

// Recompute one layer's edge side and back-propagate through it. 16 edge
// rows per block keep the recomputed activations and the cotangents of a
// block (~70 KB) in shared memory with two blocks per SM. dUE holds the
// cotangent of e_{t+1} on entry and that of e_t on return (each block
// reads its rows before it overwrites them).
__global__ void __launch_bounds__(NT, 2)
edge_bwd_kernel(Params p, TParams q, const float* __restrict__ npb_all,
                const float* __restrict__ e_t, const float* __restrict__ e_next,
                long long e_win, const float* __restrict__ att,
                const int* __restrict__ src, const int* __restrict__ dst,
                float* dUE, float* __restrict__ datt, Work w) {
  extern __shared__ float smem[];
  const int rows = NODE_ROWS;
  const int ed = p.ed, ea_w = ed * (p.with_att ? 2 : 1);
  const int H1 = p.H1, H2 = p.H2, M1 = p.M1, M = p.M, PW = p.PW;
  int* sSrc = reinterpret_cast<int*>(smem);
  int* sDst = sSrc + rows;
  float* sA = smem + 2 * rows;
  float* sH1 = sA + rows * ea_w;
  float* sH2 = sH1 + rows * H1;
  float* sU = sH2 + rows * H2;
  float* sF1 = sU + rows * ed;
  float* sP1 = sF1 + rows * M1;
  float* sG = sP1 + rows * M1;
  float* sW = sG + rows * M;
  const int b = blockIdx.y, e0 = blockIdx.x * rows;
  const size_t row0 = (size_t)b * p.E + e0;
  auto ok = [&](int r) { return e0 + r < p.E; };
  const float* et = e_t + b * e_win + (size_t)e0 * ed;
  const float* en = e_next + b * e_win + (size_t)e0 * ed;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    sSrc[r] = ok(r) ? src[row0 + r] : -1;
    sDst[r] = ok(r) ? dst[row0 + r] : -1;
  }
  for (int t = threadIdx.x; t < rows * ea_w; t += blockDim.x) {
    const int r = t / ea_w, c = t - r * ea_w;
    float v = 0.f;
    if (ok(r))
      v = c < ed ? et[(size_t)r * ed + c] : att[(row0 + r) * ed + c - ed];
    sA[t] = v;
  }
  for (int t = threadIdx.x; t < rows * ed; t += blockDim.x) {
    const int r = t / ed;
    sU[t] = ok(r) ? en[t] : 0.f;
  }
  __syncthreads();
  const float* npb = npb_all + (size_t)b * p.N * PW;

  // ---- recompute (the forward's arithmetic, in the same order) ----
  block_gemm<NODE_TM>(sA, ea_w, ea_w, p.Wea, H1, H1, sW, [&](int r, int c, float v) {
    v += p.eb0[c];
    const int i = sDst[r], j = sSrc[r];
    if (i >= 0) v += npb[(size_t)i * PW + p.o_eui + c];
    if (j >= 0) v += npb[(size_t)j * PW + p.o_euj + c];
    v = fmaxf(v, 0.f);
    sH1[r * H1 + c] = v;
    if (ok(r)) w.h1[(row0 + r) * H1 + c] = v;
  });
  block_gemm<NODE_TM>(sH1, H1, H1, p.W1, H2, H2, sW, [&](int r, int c, float v) {
    v = fmaxf(v + p.b1[c], 0.f);
    sH2[r * H2 + c] = v;
    if (ok(r)) w.h2[(row0 + r) * H2 + c] = v;
  });
  block_gemm<NODE_TM>(sU, ed, ed, p.Fue, M1, M1, sW, [&](int r, int c, float v) {
    v += p.fb0[c];
    const int i = sDst[r];
    if (i >= 0) {
      const float* n = npb + (size_t)i * PW;
      v += n[p.o_fut + c] + n[p.o_fx0 + c];
    }
    v = fmaxf(v, 0.f);
    sF1[r * M1 + c] = v;
    if (ok(r)) w.f1[(row0 + r) * M1 + c] = v;
  });
  block_gemm<NODE_TM>(sU, ed, ed, p.Pue, M1, M1, sW, [&](int r, int c, float v) {
    v += p.pb0[c];
    const int j = sSrc[r];
    if (j >= 0) {
      const float* n = npb + (size_t)j * PW;
      v += n[p.o_past + c] + n[p.o_px0 + c];
    }
    v = fmaxf(v, 0.f);
    sP1[r * M1 + c] = v;
    if (ok(r)) w.p1[(row0 + r) * M1 + c] = v;
  });

  // ---- past message: dp = dA[dst], dp1 = (dp P1^T) * [p1 > 0] ----
  const float* dab = w.dab + (size_t)b * p.N * 2 * M;
  for (int t = threadIdx.x; t < rows * M; t += blockDim.x) {
    const int r = t / M, c = t - r * M, i = sDst[r];
    const float v = i >= 0 ? dab[(size_t)i * 2 * M + c] : 0.f;
    sG[t] = v;
    if (ok(r)) w.dp[(row0 + r) * M + c] = v;
  }
  block_gemm<NODE_TM>(sG, M, M, q.P1T, M1, M1, sW, [&](int r, int c, float v) {
    v = sP1[r * M1 + c] > 0.f ? v : 0.f;
    sP1[r * M1 + c] = v;
    if (ok(r)) w.dp1[(row0 + r) * M1 + c] = v;
  });
  // ---- future message: df = dB[src], df1 = (df F1^T) * [f1 > 0] ----
  for (int t = threadIdx.x; t < rows * M; t += blockDim.x) {
    const int r = t / M, c = t - r * M, j = sSrc[r];
    const float v = j >= 0 ? dab[(size_t)j * 2 * M + M + c] : 0.f;
    sG[t] = v;
    if (ok(r)) w.df[(row0 + r) * M + c] = v;
  }
  block_gemm<NODE_TM>(sG, M, M, q.F1T, M1, M1, sW, [&](int r, int c, float v) {
    v = sF1[r * M1 + c] > 0.f ? v : 0.f;
    sF1[r * M1 + c] = v;
    if (ok(r)) w.df1[(row0 + r) * M1 + c] = v;
  });
  // ---- edge update: due = dp1 Pue^T + df1 Fue^T + dUE ----
  block_gemm<NODE_TM>(sP1, M1, M1, q.PueT, ed, ed, sW, [&](int r, int c, float v) {
    sU[r * ed + c] = v + (ok(r) ? dUE[(row0 + r) * ed + c] : 0.f);
  });
  block_gemm<NODE_TM>(sF1, M1, M1, q.FueT, ed, ed, sW, [&](int r, int c, float v) {
    v += sU[r * ed + c];
    sU[r * ed + c] = v;
    if (ok(r)) w.due[(row0 + r) * ed + c] = v;
  });
  block_gemm<NODE_TM>(sU, ed, ed, q.W2T, H2, H2, sW, [&](int r, int c, float v) {
    v = sH2[r * H2 + c] > 0.f ? v : 0.f;
    sH2[r * H2 + c] = v;
    if (ok(r)) w.dh2[(row0 + r) * H2 + c] = v;
  });
  block_gemm<NODE_TM>(sH2, H2, H2, q.W1T, H1, H1, sW, [&](int r, int c, float v) {
    v = sH1[r * H1 + c] > 0.f ? v : 0.f;
    sH1[r * H1 + c] = v;
    if (ok(r)) w.dh1[(row0 + r) * H1 + c] = v;
  });
  // ---- [de | datt] = dh1 [We | Watt]^T ----
  block_gemm<NODE_TM>(sH1, H1, H1, q.WeaT, ea_w, ea_w, sW, [&](int r, int c, float v) {
    if (!ok(r)) return;
    if (c < ed) dUE[(row0 + r) * ed + c] = v;
    else datt[(row0 + r) * ed + c - ed] += v;
  });
}

// Per-node sums of the edge cotangents over the forward's CSRs (edge order:
// deterministic), dX_t = S Wp[:, :QW]^T, and T += the initial-x part.
__global__ void __launch_bounds__(NT, 2)
node_scatter_kernel(Params p, TParams q, const int* __restrict__ doff,
                    const int* __restrict__ dperm, const int* __restrict__ soff,
                    const int* __restrict__ sperm, Work w,
                    float* __restrict__ dX_out) {
  extern __shared__ float smem[];
  const int rows = NODE_ROWS;
  const int H1 = p.H1, M1 = p.M1, QW = p.QW, nd = p.nd;
  float* sS = smem;
  float* sW = sS + rows * QW;
  const int b = blockIdx.y, n0 = blockIdx.x * rows;
  const size_t row0 = (size_t)b * p.N + n0;
  for (int t = threadIdx.x; t < rows * QW; t += blockDim.x) {
    const int r = t / QW, c = t - r * QW, n = n0 + r;
    float v = 0.f;
    if (n < p.N) {
      const int k = b * (p.N + 1) + n;
      if (c < H1) v = csr_sum(w.dh1, H1, c, doff, dperm, k);
      else if (c < 2 * H1) v = csr_sum(w.dh1, H1, c - H1, soff, sperm, k);
      else if (c < 2 * H1 + M1) v = csr_sum(w.df1, M1, c - 2 * H1, doff, dperm, k);
      else v = csr_sum(w.dp1, M1, c - 2 * H1 - M1, soff, sperm, k);
      w.S[(row0 + r) * QW + c] = v;
      if (c >= 2 * H1) w.T[(row0 + r) * 2 * M1 + c - 2 * H1] += v;
    }
    sS[t] = v;
  }
  __syncthreads();
  block_gemm<NODE_TM>(sS, QW, QW, q.WpT, nd, nd, sW, [&](int r, int c, float v) {
    if (n0 + r < p.N) dX_out[(row0 + r) * nd + c] = v;
  });
}

// dx0 = dX_0 + T Wp[:, QW:]^T (the loop-invariant x0 gathers, summed over
// the layers and transposed once).
__global__ void __launch_bounds__(NT, 2)
dx0_kernel(Params p, TParams q, Work w, const float* __restrict__ dX0,
           float* __restrict__ dx0) {
  extern __shared__ float smem[];
  const int rows = NODE_ROWS;
  const int K = 2 * p.M1, nd = p.nd;
  float* sT = smem;
  float* sW = sT + rows * K;
  const int b = blockIdx.y, n0 = blockIdx.x * rows;
  const size_t row0 = (size_t)b * p.N + n0;
  for (int t = threadIdx.x; t < rows * K; t += blockDim.x) {
    const int r = t / K;
    sT[t] = n0 + r < p.N ? w.T[row0 * K + t] : 0.f;
  }
  __syncthreads();
  block_gemm<NODE_TM>(sT, K, K, q.WpT + (size_t)p.QW * nd, nd, nd, sW,
                      [&](int r, int c, float v) {
    if (n0 + r < p.N) dx0[(row0 + r) * nd + c] = v + dX0[(row0 + r) * nd + c];
  });
}

// ---------------------------------------------------------------------------
// Weight gradients
// ---------------------------------------------------------------------------

constexpr int WG_MAX = 24;  // products per batch
constexpr int WG_TILE = 64, WG_ROWS = 32, WG_NT = 256;

// out[k * ldo + f] += sum_r A[r, k] D[r, f] over R rows; row r is row
// r % per_win of window r / per_win, at base + window * win + row * ld.
// A null: a column of ones (a bias gradient, K = 1).
struct WGDesc {
  const float* A;
  const float* D;
  float* out;
  long long a_win, d_win, poff;
  int lda, ldd, ldo, K, F, per_win, R, chunks, tiles_f, block0, elem0;
};

struct WGBatch {
  WGDesc d[WG_MAX];
  int n, blocks, elems;
};

__global__ void __launch_bounds__(WG_NT)
wgrad_kernel(const __grid_constant__ WGBatch bt, float* __restrict__ partial) {
  __shared__ __align__(16) float sA[WG_ROWS][WG_TILE];
  __shared__ __align__(16) float sD[WG_ROWS][WG_TILE];
  const int bid = blockIdx.x;
  int i = 0;
  while (i + 1 < bt.n && bt.d[i + 1].block0 <= bid) ++i;
  const WGDesc& g = bt.d[i];
  const int local = bid - g.block0;
  const int chunk = local % g.chunks, tile = local / g.chunks;
  const int k0 = (tile / g.tiles_f) * WG_TILE, f0 = (tile % g.tiles_f) * WG_TILE;
  const int crow = (g.R + g.chunks - 1) / g.chunks;
  const int r_lo = chunk * crow, r_hi = min(g.R, r_lo + crow);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (int r0 = r_lo; r0 < r_hi; r0 += WG_ROWS) {
    for (int t = threadIdx.x; t < WG_ROWS * WG_TILE; t += WG_NT) {
      const int rr = t / WG_TILE, cc = t - rr * WG_TILE, r = r0 + rr;
      float a = 0.f, d = 0.f;
      if (r < r_hi) {
        const int win = r / g.per_win, ri = r - win * g.per_win;
        const int k = k0 + cc, f = f0 + cc;
        if (k < g.K)
          a = g.A ? g.A[win * g.a_win + (long long)ri * g.lda + k] : 1.f;
        if (f < g.F) d = g.D[win * g.d_win + (long long)ri * g.ldd + f];
      }
      sA[rr][cc] = a;
      sD[rr][cc] = d;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < WG_ROWS; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&sA[rr][ty * 4]);
      const float4 d = *reinterpret_cast<const float4*>(&sD[rr][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], dv[y], acc[x][y]);
    }
    __syncthreads();
  }
  float* out = partial + g.poff + (long long)chunk * g.K * g.F;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int k = k0 + ty * 4 + x;
    if (k >= g.K) continue;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int f = f0 + tx * 4 + y;
      if (f < g.F) out[(long long)k * g.F + f] = acc[x][y];
    }
  }
}

// Sums each output's chunks in chunk order and adds the sum to the
// gradient (which accumulates over the layers in launch order).
__global__ void __launch_bounds__(WG_NT)
wgrad_reduce_kernel(const __grid_constant__ WGBatch bt,
                    const float* __restrict__ partial) {
  const int gid = blockIdx.x * WG_NT + threadIdx.x;
  if (gid >= bt.elems) return;
  int i = 0;
  while (i + 1 < bt.n && bt.d[i + 1].elem0 <= gid) ++i;
  const WGDesc& g = bt.d[i];
  const int e = gid - g.elem0, k = e / g.F, f = e - k * g.F;
  const long long kf = (long long)g.K * g.F;
  const float* src = partial + g.poff + e;
  float s = 0.f;
  for (int c = 0; c < g.chunks; ++c) s += src[c * kf];
  g.out[(long long)k * g.ldo + f] += s;
}

struct WGPlan {
  WGBatch bt;
  long long pfloats = 0;
  bool overflow = false;
  WGPlan() { bt.n = bt.blocks = bt.elems = 0; }
  void add(const float* A, long long a_win, int lda, const float* D,
           long long d_win, int ldd, float* out, int ldo, int K, int F,
           int per_win, int windows) {
    if (bt.n == WG_MAX) { overflow = true; return; }
    WGDesc& g = bt.d[bt.n++];
    g.A = A; g.D = D; g.out = out;
    g.a_win = a_win; g.d_win = d_win;
    g.lda = lda; g.ldd = ldd; g.ldo = ldo; g.K = K; g.F = F;
    g.per_win = per_win;
    g.R = per_win * windows;
    int chunks = (g.R + 255) / 256;
    g.chunks = chunks < 1 ? 1 : chunks > WG_MAX_CHUNKS ? WG_MAX_CHUNKS : chunks;
    g.tiles_f = (F + WG_TILE - 1) / WG_TILE;
    const int tiles_k = (K + WG_TILE - 1) / WG_TILE;
    g.block0 = bt.blocks;
    bt.blocks += tiles_k * g.tiles_f * g.chunks;
    g.elem0 = bt.elems;
    bt.elems += K * F;
    g.poff = pfloats;
    pfloats += (long long)g.chunks * K * F;
  }
  // bias gradient: column sums of D
  void bias(const float* D, long long d_win, int ldd, float* out, int F,
            int per_win, int windows) {
    add(nullptr, 0, 0, D, d_win, ldd, out, F, 1, F, per_win, windows);
  }
  cudaError_t launch(const Work& w, cudaStream_t stream) {
    if (overflow || pfloats > w.partial_cap) return cudaErrorInvalidValue;
    if (bt.n == 0) return cudaSuccess;
    wgrad_kernel<<<bt.blocks, WG_NT, 0, stream>>>(bt, w.partial);
    cudaError_t err = cudaGetLastError();
    if (err) return err;
    wgrad_reduce_kernel<<<(bt.elems + WG_NT - 1) / WG_NT, WG_NT, 0, stream>>>(
        bt, w.partial);
    return cudaGetLastError();
  }
};

void fill_tparams(const long long* toff, const float* tblob, TParams& q) {
  const float** t[N_TARRAYS] = {
      &q.P1T, &q.F1T, &q.PueT, &q.FueT, &q.W2T, &q.W1T, &q.WeaT,
      &q.C2wT, &q.C1wT, &q.C0T, &q.WpT, &q.L2wT, &q.L1wT, &q.L0T};
  for (int i = 0; i < N_TARRAYS; ++i) *t[i] = tblob + toff[i];
}

}  // namespace

// Floats of workspace that fused_mp_backward needs for these dims.
extern "C" long long fused_mp_train_workspace(const int* dims) {
  Params p;
  if (!fill_params(dims, nullptr, nullptr, p)) return -1;
  Work w;
  return carve(p, nullptr, w);
}

// dims: see fill_params (dims[7] = logits). woff/wblob: the forward's
// weight blob; toff/tblob: the transposed weights (TParams order). ds [B, E]
// the cotangent of the scores; xs, es, agg the forward's stashes; att may be
// null (no attention input; datt is then null too). work: workspace of
// fused_mp_train_workspace(dims) floats. Outputs: dx0 [B, N, nd]; de0
// [B, E, ed] (also the carried cotangent of e_t); datt [B, E, ed] and dblob
// (the weight blob's layout) must be zero on entry and receive sums.
// Returns the first CUDA error (0 on success); nothing is synchronised.
extern "C" int fused_mp_backward(
    const int* dims, const long long* woff, const float* wblob,
    const long long* toff, const float* tblob, const float* ds,
    const float* xs, const float* es, const float* agg, const float* att,
    const int* src, const int* dst, const int* doff, const int* dperm,
    const int* soff, const int* sperm, float* work, float* dx0, float* de0,
    float* datt, float* dblob, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  Params p;
  if (!fill_params(dims, woff, wblob, p)) return cudaErrorInvalidValue;
  if (p.depth < 1) return cudaErrorInvalidValue;
  TParams q;
  fill_tparams(toff, tblob, q);
  Work w;
  carve(p, work, w);
  const int logits = dims[7];
  const int B = p.B, N = p.N, E = p.E, nd = p.nd, ed = p.ed, depth = p.depth;
  const int H1 = p.H1, H2 = p.H2, M1 = p.M1, M = p.M, C1 = p.C1, C2 = p.C2;
  const int L1 = p.L1, L2 = p.L2, L3 = p.L3, PW = p.PW, QW = p.QW;
  const long long e_slot = (long long)E * ed, e_win = (depth + 1) * e_slot;
  const long long x_slot = (long long)N * nd, x_win = depth * x_slot;
  const long long a_slot = (long long)N * 2 * M, a_win = depth * a_slot;
  const size_t f = sizeof(float), sw = (size_t)SW * f;
  const int er = EDGE_ROWS, nr = NODE_ROWS;
  const int ea_w = ed * (p.with_att ? 2 : 1);
  const size_t proj_smem = (size_t)er * nd * f + sw;
  const size_t cls_smem = (size_t)er * (ed + 2 * (L1 + L2 + L3) + 1) * f + sw;
  const size_t nbwd_smem = (size_t)nr * (2 * M + C1 + C2 + nd) * f + sw;
  const size_t ebwd_smem =
      2 * nr * sizeof(int) +
      (size_t)nr * (ea_w + H1 + H2 + ed + 2 * M1 + M) * f + sw;
  const size_t scat_smem = (size_t)nr * QW * f + sw;
  const size_t dx0_smem = (size_t)nr * 2 * M1 * f + sw;
  cudaError_t err;
  if ((err = allow_smem(proj_kernel, proj_smem))) return err;
  if ((err = allow_smem(cls_bwd_kernel, cls_smem))) return err;
  if ((err = allow_smem(node_bwd_kernel, nbwd_smem))) return err;
  if ((err = allow_smem(edge_bwd_kernel, ebwd_smem))) return err;
  if ((err = allow_smem(node_scatter_kernel, scat_smem))) return err;
  if ((err = allow_smem(dx0_kernel, dx0_smem))) return err;

  const dim3 proj_grid((N + er - 1) / er, B);
  const dim3 cls_grid((E + er - 1) / er, B);
  const dim3 node_grid((N + nr - 1) / nr, B);
  const dim3 edge_grid((E + nr - 1) / nr, B);
  const long long nrows = (long long)B * N;
  if ((err = cudaMemsetAsync(w.T, 0, nrows * 2 * M1 * f, stream))) return err;
  if ((err = cudaMemsetAsync(w.dxa, 0, nrows * nd * f, stream))) return err;
  auto g = [&](int i) { return dblob + woff[i]; };

  // x0 projections, every column (the x0 ones serve every layer)
  proj_kernel<<<proj_grid, NT, proj_smem, stream>>>(p, xs, x_win, w.npb, PW);
  if ((err = cudaGetLastError())) return err;

  // ---- classifier ----
  const float* e_fin = es + depth * e_slot;
  cls_bwd_kernel<<<cls_grid, NT, cls_smem, stream>>>(p, q, e_fin, e_win, ds,
                                                      logits, w, de0);
  if ((err = cudaGetLastError())) return err;
  {
    WGPlan wb;
    const long long el = E;
    wb.add(e_fin, e_win, ed, w.da1, el * L1, L1, g(21), L1, ed, L1, E, B);
    wb.bias(w.da1, el * L1, L1, g(22), L1, E, B);
    wb.add(w.a1, el * L1, L1, w.da2, el * L2, L2, g(23), L2, L1, L2, E, B);
    wb.bias(w.da2, el * L2, L2, g(24), L2, E, B);
    wb.add(w.a2, el * L2, L2, w.da3, el * L3, L3, g(25), L3, L2, L3, E, B);
    wb.bias(w.da3, el * L3, L3, g(26), L3, E, B);
    wb.add(w.a3, el * L3, L3, w.dz, el, 1, g(27), 1, L3, 1, E, B);
    wb.bias(w.dz, el, 1, g(28), 1, E, B);
    if ((err = wb.launch(w, stream))) return err;
  }

  // ---- layers, in reverse ----
  float* dX_in = w.dxa;   // cotangent of x_{t+1} (x_depth feeds nothing)
  float* dX_out = w.dxb;  // cotangent of x_t
  for (int t = depth - 1; t >= 0; --t) {
    const float* x_t = xs + t * x_slot;
    const float* e_t = es + t * e_slot;
    const float* e_n = es + (t + 1) * e_slot;
    const float* agg_t = agg + t * a_slot;
    proj_kernel<<<proj_grid, NT, proj_smem, stream>>>(p, x_t, x_win, w.npb, QW);
    if ((err = cudaGetLastError())) return err;
    node_bwd_kernel<<<node_grid, NT, nbwd_smem, stream>>>(p, q, agg_t, a_win,
                                                           dX_in, w);
    if ((err = cudaGetLastError())) return err;
    edge_bwd_kernel<<<edge_grid, NT, ebwd_smem, stream>>>(
        p, q, w.npb, e_t, e_n, e_win, att, src, dst, de0, datt, w);
    if ((err = cudaGetLastError())) return err;
    node_scatter_kernel<<<node_grid, NT, scat_smem, stream>>>(
        p, q, doff, dperm, soff, sperm, w, dX_out);
    if ((err = cudaGetLastError())) return err;

    WGPlan wb;
    const long long el = E, nl = N;
    // edge products (rows b * E + e)
    wb.add(w.f1, el * M1, M1, w.df, el * M, M, g(8), M, M1, M, E, B);
    wb.bias(w.df, el * M, M, g(9), M, E, B);
    wb.add(w.p1, el * M1, M1, w.dp, el * M, M, g(12), M, M1, M, E, B);
    wb.bias(w.dp, el * M, M, g(13), M, E, B);
    wb.add(e_n, e_win, ed, w.df1, el * M1, M1, g(6), M1, ed, M1, E, B);
    wb.bias(w.df1, el * M1, M1, g(7), M1, E, B);
    wb.add(e_n, e_win, ed, w.dp1, el * M1, M1, g(10), M1, ed, M1, E, B);
    wb.bias(w.dp1, el * M1, M1, g(11), M1, E, B);
    wb.add(w.h2, el * H2, H2, w.due, el * ed, ed, g(4), ed, H2, ed, E, B);
    wb.bias(w.due, el * ed, ed, g(5), ed, E, B);
    wb.add(w.h1, el * H1, H1, w.dh2, el * H2, H2, g(2), H2, H1, H2, E, B);
    wb.bias(w.dh2, el * H2, H2, g(3), H2, E, B);
    wb.add(e_t, e_win, ed, w.dh1, el * H1, H1, g(0), H1, ed, H1, E, B);
    if (att)
      wb.add(att, e_slot, ed, w.dh1, el * H1, H1, g(0) + (size_t)ed * H1, H1,
             ed, H1, E, B);
    wb.bias(w.dh1, el * H1, H1, g(1), H1, E, B);
    // node products (rows b * N + n)
    wb.add(w.c2, nl * C2, C2, dX_in, nl * nd, nd, g(18), nd, C2, nd, N, B);
    wb.bias(dX_in, nl * nd, nd, g(19), nd, N, B);
    wb.add(w.c1, nl * C1, C1, w.dc2, nl * C2, C2, g(16), C2, C1, C2, N, B);
    wb.bias(w.dc2, nl * C2, C2, g(17), C2, N, B);
    wb.add(agg_t, a_win, 2 * M, w.dc1, nl * C1, C1, g(14), C1, 2 * M, C1, N, B);
    wb.bias(w.dc1, nl * C1, C1, g(15), C1, N, B);
    wb.add(x_t, x_win, nd, w.S, nl * QW, QW, g(20), PW, nd, QW, N, B);
    if ((err = wb.launch(w, stream))) return err;
    float* tmp = dX_in;
    dX_in = dX_out;
    dX_out = tmp;
  }

  // ---- the initial-x gathers ----
  dx0_kernel<<<node_grid, NT, dx0_smem, stream>>>(p, q, w, dX_in, dx0);
  if ((err = cudaGetLastError())) return err;
  WGPlan wb;
  wb.add(xs, x_win, nd, w.T, (long long)N * 2 * M1, 2 * M1, g(20) + QW, PW,
         nd, 2 * M1, N, B);
  return wb.launch(w, stream);
}
