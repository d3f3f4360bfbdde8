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
// ReLU masks (a debug output, ops/fused_mp_train.py::fused_mp_train_masks):
// given a mask buffer, the kernels also write one byte per hidden unit, 1
// where the recomputed activation that the unit's `> 0.f` test reads is
// positive, from that same value: h1, h2, f1, p1 (edge_bwd_kernel) and c1,
// c2 (node_bwd_kernel) for every layer, and the classifier's three
// (cls_bwd_kernel), in the order and shapes of ops/fused_mp.py::
// relu_masks_from_stashes. The three kernels are templates on whether
// they write masks: the training path passes null and runs the kMasks =
// false instances, whose code has no mask store at all; the arithmetic is
// the same either way.
//
// Weight gradients: every dW is H_in^T D_out, a product over the edge rows
// (or the node rows, for the combine MLP and the node projections) of an
// activation and a cotangent held in the workspace; a bias gradient is a
// column sum. One wgrad_kernel launch per batch of products splits the rows
// into a fixed number of chunks (at most 64, >= 256 rows each) and writes
// one 128x64 output tile per (product, tile, chunk) block to a partial
// buffer; wgrad_reduce_kernel then sums the chunks in order and adds the
// result to the gradient blob. No float atomics: the same inputs give
// bit-identical gradients. The partials hold at most 64 x the weights of
// one batch (~82 MB at mm widths), never per-block copies of all weights.
//
// What bounds it: operations. Per edge and layer at mm widths the backward
// recomputes 0.18 MFLOP, runs 0.29 MFLOP of cotangent chain and 0.29 MFLOP
// of weight products; a (256, 4096) x8 batch at depth 6 is ~150 GFLOP over
// its padded edges (91 GFLOP over the valid ones, chip_smoke.py train_work)
// against a few hundred MB of stash and scratch traffic, far above the
// card's operations-per-byte line. So every product of the layer kernels
// (node_bwd, edge_bwd, node_scatter) and of wgrad_kernel runs on the tensor
// cores at float32 accuracy (3xTF32 mma.sync, tc_gemm.cuh: three TF32
// products per step, never a single one). What bounds the kernels now is
// issue and latency around the products, not the tensor cores themselves:
// each k-step of a warp loads and splits its fragments before its mma, and
// a product's weights arrive through two cp.async stages. So:
//   * edge_bwd_kernel takes 32 edge rows (two m16 tiles) and 16 warps per
//     block, as many warps as its registers allow (512 threads, at most 128
//     registers each); shared memory (~207 KB: the padded activations and
//     cotangents, two weight stages of 32 rows and the split A slices)
//     holds one block per SM. A weight fragment serves both row tiles.
//   * node_bwd_kernel and node_scatter_kernel take 16 node rows and 8 warps,
//     two blocks per SM; their products stage 16 weight rows at a time.
//   * Each A slice is split into its TF32 parts once per block, not once per
//     warp, and the workspace rows leave shared memory in coalesced 16-byte
//     pieces after each product, not from the epilogues.
//   * wgrad_kernel (8 warps, 128x64 tiles) is held to 80 registers, three
//     blocks per SM; it stages 32 rows of both operands per step in two
//     cp.async buffers and maps rows to windows once per stage.
// The classifier and the initial-x product (cls_bwd_kernel, dx0_kernel,
// small and once per call) stay on mp_common.cuh's fp32 block_gemm. The
// per-node sums (node_scatter_kernel) take a warp per (node, part) with
// float4 loads, in edge order.
//
// Workspace at (1024, 32768) x1 and mm widths (fused_mp_train_workspace):
// the per-edge recompute and cotangents (h1, h2, f1, p1, dp, df, dp1, df1,
// due, dh2, dh1: 1856 floats per edge) 243 MB, the classifier's 15 MB,
// the node projections and node scratch 15 MB, and the partials 82 MB.

#include <algorithm>

#include "mp_common.cuh"
#include "tc_gemm.cuh"

namespace {

// The edge side takes 32 edge rows (two m16 tiles) per block and 16 warps,
// with two weight stages of 32 rows; the node kernels 16 rows, NB_WARPS
// warps and two stages of 16 rows.
constexpr int EB_MT = 2, EB_WARPS = 16, EB_KC = 32, EB_STAGES = 2;
constexpr int EB_ROWS = 16 * EB_MT, EB_NT = 32 * EB_WARPS;
constexpr int EB_SW = tc_stage_floats<EB_KC, EB_STAGES>() + tc_split_floats<EB_MT, EB_KC>();
constexpr int NB_WARPS = 8, NB_NT = 32 * NB_WARPS;

constexpr int NB_KC = 16, NB_STAGES = 2;
constexpr int NB_SW = tc_stage_floats<NB_KC, NB_STAGES>() + tc_split_floats<1, NB_KC>();

template <class Epi>
__device__ __forceinline__ void edge_gemm(const float* sA, int lda, int K,
                                          const float* __restrict__ W, int N,
                                          float* sW, Epi epi) {
  tc_gemm<EB_MT, EB_WARPS, EB_KC, EB_STAGES>(
      sA, lda, K, W, N, N, sW, sW + tc_stage_floats<EB_KC, EB_STAGES>(), epi);
}

template <class Epi>
__device__ __forceinline__ void node_gemm(const float* sA, int lda, int K,
                                          const float* __restrict__ W, int N,
                                          float* sW, Epi epi) {
  tc_gemm<1, NB_WARPS, NB_KC, NB_STAGES>(
      sA, lda, K, W, N, N, sW, sW + tc_stage_floats<NB_KC, NB_STAGES>(), epi);
}

// Transposed weights ([out, in]) the backward multiplies by, packed by the
// wrapper in this order (ops/fused_mp_train.py::_TRANSPOSED).
struct TParams {
  const float *P1T, *F1T, *PueT, *FueT, *W2T, *W1T, *WeaT;
  const float *C2wT, *C1wT, *C0T, *WpT, *L2wT, *L1wT, *L0T;
};
constexpr int N_TARRAYS = 14;

// Where the recomputed ReLU masks go (one byte per unit, [rows, width]
// row-major like the workspace), or null: one layer's, and the classifier's.
struct LayerMasks {
  unsigned char *h1, *h2, *f1, *p1, *c1, *c2;
};
struct ClsMasks {
  unsigned char *a1, *a2, *a3;
};

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

template <bool kMasks>
__global__ void __launch_bounds__(NT, 2)
cls_bwd_kernel(Params p, TParams q, const float* __restrict__ e_fin,
               long long e_win, const float* __restrict__ ds, int logits,
               Work w, float* __restrict__ dUE, ClsMasks mk) {
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
    const bool on = sA3[t] > 0.f;
    const float v = on ? sDZ[r] * p.L3w[c] : 0.f;
    sD3[t] = v;
    if (ok(r)) w.da3[(row0 + r) * L3 + c] = v;
    if (kMasks && ok(r)) mk.a3[(row0 + r) * L3 + c] = on;
  }
  __syncthreads();
  block_gemm<EDGE_TM>(sD3, L3, L3, q.L2wT, L2, L2, sW, [&](int r, int c, float v) {
    const bool on = sA2[r * L2 + c] > 0.f;
    v = on ? v : 0.f;
    if (kMasks && ok(r)) mk.a2[(row0 + r) * L2 + c] = on;
    sD2[r * L2 + c] = v;
    if (ok(r)) w.da2[(row0 + r) * L2 + c] = v;
  });
  block_gemm<EDGE_TM>(sD2, L2, L2, q.L1wT, L1, L1, sW, [&](int r, int c, float v) {
    const bool on = sA1[r * L1 + c] > 0.f;
    v = on ? v : 0.f;
    if (kMasks && ok(r)) mk.a1[(row0 + r) * L1 + c] = on;
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
// [dA | dB] = dc1 C0^T. dX is the cotangent of x_{t+1}. Every product on
// the tensor cores (tc_gemm.cuh); activations padded by TC_PAD per row;
// the workspace rows leave shared memory in coalesced pieces.
template <bool kMasks>
__global__ void __launch_bounds__(NB_NT, 2)
node_bwd_kernel(Params p, TParams q, const float* __restrict__ agg,
                long long agg_win, const float* __restrict__ dX, Work w,
                LayerMasks mk) {
  extern __shared__ __align__(16) float smem[];
  const int rows = NODE_ROWS;
  const int M2 = 2 * p.M, C1 = p.C1, C2 = p.C2, nd = p.nd;
  const int lAgg = M2 + TC_PAD, lC1 = C1 + TC_PAD, lC2 = C2 + TC_PAD;
  const int lDX = nd + TC_PAD;
  float* sW = smem;
  float* sAgg = sW + NB_SW;  // the message sums, then [dA | dB]
  float* sC1 = sAgg + rows * lAgg;
  float* sC2 = sC1 + rows * lC1;
  float* sDX = sC2 + rows * lC2;
  const int b = blockIdx.y, n0 = blockIdx.x * rows;
  const size_t row0 = (size_t)b * p.N + n0;
  const int nv = min(rows, p.N - n0);
  for (int t = threadIdx.x; t < rows * M2; t += blockDim.x) {
    const int r = t / M2;
    sAgg[r * lAgg + t - r * M2] =
        r < nv ? agg[b * agg_win + (size_t)n0 * M2 + t] : 0.f;
  }
  for (int t = threadIdx.x; t < rows * nd; t += blockDim.x) {
    const int r = t / nd;
    sDX[r * lDX + t - r * nd] = r < nv ? dX[row0 * nd + t] : 0.f;
  }
  __syncthreads();
  node_gemm(sAgg, lAgg, M2, p.C0, C1, sW, [&](int r, int c, float v) {
    sC1[r * lC1 + c] = fmaxf(v + p.cb0[c], 0.f);
  });
  store_rows(sC1, lC1, w.c1 + row0 * C1, C1, nv);
  node_gemm(sC1, lC1, C1, p.C1w, C2, sW, [&](int r, int c, float v) {
    sC2[r * lC2 + c] = fmaxf(v + p.cb1[c], 0.f);
  });
  store_rows(sC2, lC2, w.c2 + row0 * C2, C2, nv);
  // the masks are read and overwritten element by element: sC2 becomes
  // dc2, sC1 becomes dc1
  node_gemm(sDX, lDX, nd, q.C2wT, C2, sW, [&](int r, int c, float v) {
    float& m = sC2[r * lC2 + c];
    const bool on = m > 0.f;
    if (kMasks && r < nv) mk.c2[(row0 + r) * C2 + c] = on;
    m = on ? v : 0.f;
  });
  store_rows(sC2, lC2, w.dc2 + row0 * C2, C2, nv);
  node_gemm(sC2, lC2, C2, q.C1wT, C1, sW, [&](int r, int c, float v) {
    float& m = sC1[r * lC1 + c];
    const bool on = m > 0.f;
    if (kMasks && r < nv) mk.c1[(row0 + r) * C1 + c] = on;
    m = on ? v : 0.f;
  });
  store_rows(sC1, lC1, w.dc1 + row0 * C1, C1, nv);
  node_gemm(sC1, lC1, C1, q.C0T, M2, sW, [&](int r, int c, float v) {
    sAgg[r * lAgg + c] = v;
  });
  store_rows(sAgg, lAgg, w.dab + row0 * M2, M2, nv);
}

// Recompute one layer's edge side and back-propagate through it, EB_ROWS
// edge rows per block. The recomputed activations and the cotangents of a
// block stay in shared memory (~126 KB at 32 rows and mm widths, with the
// padding; the input rows and the gathered dp/df share one array), beside
// the weight stages and the split A slices. Each product's epilogue writes shared memory only; the
// workspace rows that the weight products read go to device memory after
// it, in coalesced row pieces (store_rows). dUE holds the cotangent of
// e_{t+1} on entry and that of e_t on return (each block reads its rows
// before it overwrites them). Every product on the tensor cores.
template <bool kMasks>
__global__ void __launch_bounds__(EB_NT, 1)
edge_bwd_kernel(Params p, TParams q, const float* __restrict__ npb_all,
                const float* __restrict__ e_t, const float* __restrict__ e_next,
                long long e_win, const float* __restrict__ att,
                const int* __restrict__ src, const int* __restrict__ dst,
                float* dUE, float* __restrict__ datt, Work w, LayerMasks mk) {
  extern __shared__ __align__(16) float smem[];
  const int rows = EB_ROWS;
  const int ed = p.ed, ea_w = ed * (p.with_att ? 2 : 1);
  const int H1 = p.H1, H2 = p.H2, M1 = p.M1, M = p.M, PW = p.PW;
  const int lA = max(ea_w, M) + TC_PAD, lH1 = H1 + TC_PAD, lH2 = H2 + TC_PAD;
  const int lU = ed + TC_PAD, lM1 = M1 + TC_PAD;
  float* sW = smem;
  float* sA = sW + EB_SW;  // [e_t | att], then dp and df, then [de | datt]
  float* sH1 = sA + rows * lA;
  float* sH2 = sH1 + rows * lH1;
  float* sU = sH2 + rows * lH2;
  float* sF1 = sU + rows * lU;
  float* sP1 = sF1 + rows * lM1;
  int* sSrc = reinterpret_cast<int*>(sP1 + rows * lM1);
  int* sDst = sSrc + rows;
  const int b = blockIdx.y, e0 = blockIdx.x * rows;
  const size_t row0 = (size_t)b * p.E + e0;
  const int nv = min(rows, p.E - e0);  // rows of real edges
  auto ok = [&](int r) { return r < nv; };
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
    sA[r * lA + c] = v;
  }
  for (int t = threadIdx.x; t < rows * ed; t += blockDim.x) {
    const int r = t / ed;
    sU[r * lU + t - r * ed] = ok(r) ? en[t] : 0.f;
  }
  __syncthreads();
  const float* npb = npb_all + (size_t)b * p.N * PW;

  // ---- recompute the edge side of the forward ----
  edge_gemm(sA, lA, ea_w, p.Wea, H1, sW, [&](int r, int c, float v) {
    v += p.eb0[c];
    const int i = sDst[r], j = sSrc[r];
    if (i >= 0) v += npb[(size_t)i * PW + p.o_eui + c];
    if (j >= 0) v += npb[(size_t)j * PW + p.o_euj + c];
    sH1[r * lH1 + c] = fmaxf(v, 0.f);
  });
  store_rows(sH1, lH1, w.h1 + row0 * H1, H1, nv);
  edge_gemm(sH1, lH1, H1, p.W1, H2, sW, [&](int r, int c, float v) {
    sH2[r * lH2 + c] = fmaxf(v + p.b1[c], 0.f);
  });
  store_rows(sH2, lH2, w.h2 + row0 * H2, H2, nv);
  edge_gemm(sU, lU, ed, p.Fue, M1, sW, [&](int r, int c, float v) {
    v += p.fb0[c];
    const int i = sDst[r];
    if (i >= 0) {
      const float* n = npb + (size_t)i * PW;
      v += n[p.o_fut + c] + n[p.o_fx0 + c];
    }
    sF1[r * lM1 + c] = fmaxf(v, 0.f);
  });
  edge_gemm(sU, lU, ed, p.Pue, M1, sW, [&](int r, int c, float v) {
    v += p.pb0[c];
    const int j = sSrc[r];
    if (j >= 0) {
      const float* n = npb + (size_t)j * PW;
      v += n[p.o_past + c] + n[p.o_px0 + c];
    }
    sP1[r * lM1 + c] = fmaxf(v, 0.f);
  });
  store_rows(sF1, lM1, w.f1 + row0 * M1, M1, nv);
  store_rows(sP1, lM1, w.p1 + row0 * M1, M1, nv);

  // ---- past message: dp = dA[dst], dp1 = (dp P1^T) * [p1 > 0] ----
  const float* dab = w.dab + (size_t)b * p.N * 2 * M;
  for (int t = threadIdx.x; t < rows * M; t += blockDim.x) {
    const int r = t / M, c = t - r * M, i = sDst[r];
    const float v = i >= 0 ? dab[(size_t)i * 2 * M + c] : 0.f;
    sA[r * lA + c] = v;
    if (ok(r)) w.dp[(row0 + r) * M + c] = v;
  }
  __syncthreads();
  edge_gemm(sA, lA, M, q.P1T, M1, sW, [&](int r, int c, float v) {
    float& m = sP1[r * lM1 + c];
    const bool on = m > 0.f;
    if (kMasks && ok(r)) mk.p1[(row0 + r) * M1 + c] = on;
    m = on ? v : 0.f;
  });
  store_rows(sP1, lM1, w.dp1 + row0 * M1, M1, nv);
  // ---- future message: df = dB[src], df1 = (df F1^T) * [f1 > 0] ----
  for (int t = threadIdx.x; t < rows * M; t += blockDim.x) {
    const int r = t / M, c = t - r * M, j = sSrc[r];
    const float v = j >= 0 ? dab[(size_t)j * 2 * M + M + c] : 0.f;
    sA[r * lA + c] = v;
    if (ok(r)) w.df[(row0 + r) * M + c] = v;
  }
  __syncthreads();
  edge_gemm(sA, lA, M, q.F1T, M1, sW, [&](int r, int c, float v) {
    float& m = sF1[r * lM1 + c];
    const bool on = m > 0.f;
    if (kMasks && ok(r)) mk.f1[(row0 + r) * M1 + c] = on;
    m = on ? v : 0.f;
  });
  store_rows(sF1, lM1, w.df1 + row0 * M1, M1, nv);
  // ---- edge update: due = dp1 Pue^T + df1 Fue^T + dUE ----
  edge_gemm(sP1, lM1, M1, q.PueT, ed, sW, [&](int r, int c, float v) {
    sU[r * lU + c] = v + (ok(r) ? dUE[(row0 + r) * ed + c] : 0.f);
  });
  edge_gemm(sF1, lM1, M1, q.FueT, ed, sW, [&](int r, int c, float v) {
    sU[r * lU + c] += v;
  });
  store_rows(sU, lU, w.due + row0 * ed, ed, nv);
  edge_gemm(sU, lU, ed, q.W2T, H2, sW, [&](int r, int c, float v) {
    float& m = sH2[r * lH2 + c];
    const bool on = m > 0.f;
    if (kMasks && ok(r)) mk.h2[(row0 + r) * H2 + c] = on;
    m = on ? v : 0.f;
  });
  store_rows(sH2, lH2, w.dh2 + row0 * H2, H2, nv);
  edge_gemm(sH2, lH2, H2, q.W1T, H1, sW, [&](int r, int c, float v) {
    float& m = sH1[r * lH1 + c];
    const bool on = m > 0.f;
    if (kMasks && ok(r)) mk.h1[(row0 + r) * H1 + c] = on;
    m = on ? v : 0.f;
  });
  store_rows(sH1, lH1, w.dh1 + row0 * H1, H1, nv);
  // ---- [de | datt] = dh1 [We | Watt]^T ----
  edge_gemm(sH1, lH1, H1, q.WeaT, ea_w, sW, [&](int r, int c, float v) {
    sA[r * lA + c] = v;
  });
  store_rows(sA, lA, dUE + row0 * ed, ed, nv);
  if (datt) {
    for (int i = threadIdx.x; i < nv * ed; i += blockDim.x) {
      const int r = i / ed, c = i - r * ed;
      datt[(row0 + r) * ed + c] += sA[r * lA + ed + c];
    }
  }
}

// Per-node sums of the edge cotangents over the forward's CSRs, S = [sum
// by dst of dh1 | by src of dh1 | by dst of df1 | by src of dp1], then
// dX_t = S Wp[:, :QW]^T and T += the initial-x part. A warp takes one
// (node, part): it reads the CSR row's offsets once and walks its edges in
// order, lanes across 4-column groups (float4 loads, up to two groups a
// lane), so each sum starts at 0 and adds in edge order as before: the
// same S bit for bit. The product runs on the tensor cores.
__global__ void __launch_bounds__(NB_NT, 2)
node_scatter_kernel(Params p, TParams q, const int* __restrict__ doff,
                    const int* __restrict__ dperm, const int* __restrict__ soff,
                    const int* __restrict__ sperm, Work w,
                    float* __restrict__ dX_out) {
  extern __shared__ __align__(16) float smem[];
  const int rows = NODE_ROWS;
  const int H1 = p.H1, M1 = p.M1, QW = p.QW, nd = p.nd, lS = QW + TC_PAD;
  float* sW = smem;
  float* sS = sW + NB_SW;
  const int b = blockIdx.y, n0 = blockIdx.x * rows;
  const size_t row0 = (size_t)b * p.N + n0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int task = warp; task < rows * 4; task += NB_WARPS) {
    const int r = task >> 2, part = task & 3, n = n0 + r;
    const bool by_dst = part == 0 || part == 2;
    const float* v = part < 2 ? w.dh1 : part == 2 ? w.df1 : w.dp1;
    const int width = part < 2 ? H1 : M1;
    const int col0 = part == 0 ? 0 : part == 1 ? H1 : part == 2 ? 2 * H1 : 2 * H1 + M1;
    int q0 = 0, q1 = 0;
    if (n < p.N) {
      const int* off = by_dst ? doff : soff;
      const int k = b * (p.N + 1) + n;
      q0 = off[k];
      q1 = off[k + 1];
    }
    const int* perm = by_dst ? dperm : sperm;
    const int w4 = width >> 2;
    for (int g0 = 0; g0 < w4; g0 += 64) {
      const int ga = g0 + lane, gb = ga + 32;
      float4 sa = zero, sb = zero;
      for (int qq = q0; qq < q1; ++qq) {
        const float4* row = reinterpret_cast<const float4*>(v + (size_t)perm[qq] * width);
        if (ga < w4) {
          const float4 x = row[ga];
          sa.x += x.x; sa.y += x.y; sa.z += x.z; sa.w += x.w;
        }
        if (gb < w4) {
          const float4 x = row[gb];
          sb.x += x.x; sb.y += x.y; sb.z += x.z; sb.w += x.w;
        }
      }
      const int gs[2] = {ga, gb};
      const float4 ss[2] = {sa, sb};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (gs[h] >= w4) continue;
        const int c = col0 + 4 * gs[h];
        *reinterpret_cast<float4*>(sS + r * lS + c) = ss[h];
        if (n >= p.N) continue;
        *reinterpret_cast<float4*>(w.S + (row0 + r) * QW + c) = ss[h];
        if (c >= 2 * H1) {
          float4* t4 = reinterpret_cast<float4*>(w.T + (row0 + r) * 2 * M1 + c - 2 * H1);
          float4 t = *t4;
          t.x += ss[h].x; t.y += ss[h].y; t.z += ss[h].z; t.w += ss[h].w;
          *t4 = t;
        }
      }
    }
  }
  __syncthreads();
  node_gemm(sS, lS, QW, q.WpT, nd, sW, [&](int r, int c, float v) {
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
// Output tile of a block: 128 (k) x 64 (f), 8 warps of 32 x 32 (2 m16 x 4
// n8 tiles each); rows stream in stages of 32 through two cp.async buffers
// whose row strides (136, 72 floats) are 8 mod 32: the fragment reads are
// free of bank conflicts.
constexpr int WG_TK = 128, WG_TF = 64, WG_RS = 32, WG_NT = 256;
constexpr int WG_LA = WG_TK + 8, WG_LD = WG_TF + 8;
constexpr int WG_SMEM = 2 * WG_RS * (WG_LA + WG_LD) * (int)sizeof(float);

// out[k * ldo + f] += sum_r A[r, k] D[r, f] over R rows; row r is row
// r % per_win of window r / per_win, at base + window * win + row * ld.
// A null: a bias gradient (K = 1), the column sums of D. vec_a / vec_d:
// rows and row starts are 16-byte aligned and the widths multiples of 4, so
// a stage is copied in 16-byte pieces.
struct WGDesc {
  const float* A;
  const float* D;
  float* out;
  long long a_win, d_win, poff;
  int lda, ldd, ldo, K, F, per_win, R, chunks, tiles_f, block0, elem0;
  int vec_a, vec_d;
};

struct WGBatch {
  WGDesc d[WG_MAX];
  int n, blocks, elems;
};

// Window and row of descriptor row r.
struct RowPos {
  int win, ri;
  __device__ __forceinline__ void at(int r, int per_win) {
    win = r / per_win;
    ri = r - win * per_win;
  }
  __device__ __forceinline__ void advance(int by, int per_win) {
    ri += by;
    while (ri >= per_win) {
      ri -= per_win;
      ++win;
    }
  }
};

// Stage rows [r, r + WG_RS) of an operand (columns c0 .. c0 + width of a
// [rows, cols] matrix) into s [WG_RS][ld]; rows past r_hi and columns past
// cols are zero. pos[i] is the window position of row rr0 + i * step, the
// rows this thread copies (vector path); advanced by WG_RS afterwards.
template <int WIDTH, int LD, int NPOS>
__device__ __forceinline__ void wg_stage(float* s, const float* __restrict__ base,
                                         long long win_stride, int ld, int cols,
                                         int c0, int vec, int r, int r_hi,
                                         int per_win, RowPos (&pos)[NPOS]) {
  constexpr int Q = WIDTH / 4;              // float4 per row
  constexpr int STEP = WG_NT / Q;           // rows per pass
  const int rr0 = threadIdx.x / Q, c = 4 * (threadIdx.x % Q);
  if (vec) {
#pragma unroll
    for (int i = 0; i < NPOS; ++i) {
      const int rr = rr0 + i * STEP;
      float* dst = s + rr * LD + c;
      if (r + rr < r_hi && c0 + c < cols)
        __pipeline_memcpy_async(
            dst, base + pos[i].win * win_stride + (long long)pos[i].ri * ld + c0 + c, 16);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < WG_RS * WIDTH; i += WG_NT) {
      const int rr = i / WIDTH, cc = i - rr * WIDTH;
      float v = 0.f;
      if (r + rr < r_hi && c0 + cc < cols) {
        RowPos q;
        q.at(r + rr, per_win);
        v = base[q.win * win_stride + (long long)q.ri * ld + c0 + cc];
      }
      s[rr * LD + cc] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < NPOS; ++i) pos[i].advance(WG_RS, per_win);
}

// A bias gradient's chunk: the column sums of D over rows [r_lo, r_hi),
// 4 row groups of 64 columns, each summed in row order, then the groups in
// order.
__device__ void wg_bias(const WGDesc& g, int f0, int r_lo, int r_hi,
                        float* __restrict__ out, float* red) {
  const int c = threadIdx.x & 63, grp = threadIdx.x >> 6, f = f0 + c;
  float s = 0.f;
  if (f < g.F && r_lo + grp < r_hi) {
    RowPos pos;
    pos.at(r_lo + grp, g.per_win);
    for (int r = r_lo + grp; r < r_hi; r += 4) {
      s += g.D[pos.win * g.d_win + (long long)pos.ri * g.ldd + f];
      pos.advance(4, g.per_win);
    }
  }
  red[grp * 64 + c] = s;
  __syncthreads();
  if (grp == 0 && f < g.F) out[f] = ((red[c] + red[64 + c]) + red[128 + c]) + red[192 + c];
}

// One (product, 128 x 64 tile, row chunk) per block: the tile of A^T D over
// the chunk's rows at float32 accuracy on the tensor cores (3xTF32), or a
// bias gradient's column sums; written to the chunk's partial.
__global__ void __launch_bounds__(WG_NT, 3)
wgrad_kernel(const __grid_constant__ WGBatch bt, float* __restrict__ partial) {
  extern __shared__ __align__(16) float wsm[];
  const int bid = blockIdx.x;
  int i = 0;
  while (i + 1 < bt.n && bt.d[i + 1].block0 <= bid) ++i;
  const WGDesc& g = bt.d[i];
  const int local = bid - g.block0;
  const int chunk = local % g.chunks, tile = local / g.chunks;
  const int k0 = (tile / g.tiles_f) * WG_TK, f0 = (tile % g.tiles_f) * WG_TF;
  const int crow = (g.R + g.chunks - 1) / g.chunks;
  const int r_lo = chunk * crow, r_hi = min(g.R, r_lo + crow);
  float* out = partial + g.poff + (long long)chunk * g.K * g.F;
  if (!g.A) {
    wg_bias(g, f0, r_lo, r_hi, out, wsm);
    return;
  }
  float* sA = wsm;                      // [2][WG_RS][WG_LA]
  float* sD = wsm + 2 * WG_RS * WG_LA;  // [2][WG_RS][WG_LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int wk = (warp & 3) * 32, wf = (warp >> 2) * 32;
  constexpr int NPA = WG_RS * WG_TK / 4 / WG_NT, NPD = WG_RS * WG_TF / 4 / WG_NT;
  RowPos pa[NPA], pd[NPD];
#pragma unroll
  for (int j = 0; j < NPA; ++j)
    pa[j].at(r_lo + threadIdx.x / (WG_TK / 4) + j * (WG_NT / (WG_TK / 4)), g.per_win);
#pragma unroll
  for (int j = 0; j < NPD; ++j)
    pd[j].at(r_lo + threadIdx.x / (WG_TF / 4) + j * (WG_NT / (WG_TF / 4)), g.per_win);
  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[m][n][h] = 0.f;

  const int stages = (r_hi - r_lo + WG_RS - 1) / WG_RS;
  auto load = [&](int st) {
    const int buf = st & 1, r = r_lo + st * WG_RS;
    wg_stage<WG_TK, WG_LA>(sA + buf * WG_RS * WG_LA, g.A, g.a_win, g.lda, g.K, k0,
                           g.vec_a, r, r_hi, g.per_win, pa);
    wg_stage<WG_TF, WG_LD>(sD + buf * WG_RS * WG_LD, g.D, g.d_win, g.ldd, g.F, f0,
                           g.vec_d, r, r_hi, g.per_win, pd);
    __pipeline_commit();
  };
  if (stages > 0) load(0);
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      load(st + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const float* a = sA + (st & 1) * WG_RS * WG_LA;
    const float* d = sD + (st & 1) * WG_RS * WG_LD;
#pragma unroll
    for (int kk = 0; kk < WG_RS; kk += 8) {
      const float* a0 = a + (kk + t) * WG_LA + wk + gq;
      const float* a1 = a0 + 4 * WG_LA;
      FragA fa[2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        fa[m].set(a0[16 * m], a0[16 * m + 8], a1[16 * m], a1[16 * m + 8]);
      const float* d0 = d + (kk + t) * WG_LD + wf + gq;
      FragB fb[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) fb[n].set(d0[8 * n], d0[8 * n + 4 * WG_LD]);
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int m = 0; m < 2; ++m) mma_term(acc[m][n], fa[m], fb[n], term);
    }
    __syncthreads();  // the buffer is read before the next stage refills it
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int k = k0 + wk + 16 * m + gq + (h >= 2 ? 8 : 0);
        const int f = f0 + wf + 8 * n + 2 * t + (h & 1);
        if (k < g.K && f < g.F) out[(long long)k * g.F + f] = acc[m][n][h];
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
    g.tiles_f = (F + WG_TF - 1) / WG_TF;
    const int tiles_k = A ? (K + WG_TK - 1) / WG_TK : 1;
    auto aligned = [](const float* ptr) {
      return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
    };
    g.vec_a = A && lda % 4 == 0 && a_win % 4 == 0 && K % 4 == 0 && aligned(A);
    g.vec_d = ldd % 4 == 0 && d_win % 4 == 0 && F % 4 == 0 && aligned(D);
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
    wgrad_kernel<<<bt.blocks, WG_NT, WG_SMEM, stream>>>(bt, w.partial);
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

// Bytes of the ReLU masks fused_mp_backward writes for these dims: per
// layer t = 0 .. depth - 1 in turn h1 [B, E, H1], h2 [B, E, H2], f1 and p1
// [B, E, M1], c1 [B, N, C1], c2 [B, N, C2]; then the classifier's a1, a2,
// a3 [B, E, L1 | L2 | L3].
extern "C" long long fused_mp_train_mask_bytes(const int* dims) {
  Params p;
  if (!fill_params(dims, nullptr, nullptr, p)) return -1;
  const long long er = (long long)p.B * p.E, nr = (long long)p.B * p.N;
  const long long layer = er * (p.H1 + p.H2 + 2 * p.M1) + nr * (p.C1 + p.C2);
  return p.depth * layer + er * (p.L1 + p.L2 + p.L3);
}

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
// (the weight blob's layout) must be zero on entry and receive sums; masks
// null, or fused_mp_train_mask_bytes(dims) bytes that receive the ReLU
// masks. Returns the first CUDA error (0 on success); nothing is
// synchronised.
extern "C" int fused_mp_backward(
    const int* dims, const long long* woff, const float* wblob,
    const long long* toff, const float* tblob, const float* ds,
    const float* xs, const float* es, const float* agg, const float* att,
    const int* src, const int* dst, const int* doff, const int* dperm,
    const int* soff, const int* sperm, float* work, float* dx0, float* de0,
    float* datt, float* dblob, unsigned char* masks, void* stream_ptr) {
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
  const size_t nw = (size_t)NB_SW * f, ew = (size_t)EB_SW * f, pad = TC_PAD;
  const size_t nbwd_smem = (size_t)nr * (2 * M + C1 + C2 + nd + 4 * pad) * f + nw;
  const size_t ebwd_smem =
      2 * EB_ROWS * sizeof(int) +
      (size_t)EB_ROWS * (std::max(ea_w, M) + H1 + H2 + ed + 2 * M1 + 6 * pad) * f + ew;
  const size_t scat_smem = (size_t)nr * (QW + pad) * f + nw;
  const size_t dx0_smem = (size_t)nr * 2 * M1 * f + sw;
  cudaError_t err;
  if ((err = allow_smem(proj_kernel, proj_smem))) return err;
  if ((err = allow_smem(cls_bwd_kernel<false>, cls_smem))) return err;
  if ((err = allow_smem(cls_bwd_kernel<true>, cls_smem))) return err;
  if ((err = allow_smem(node_bwd_kernel<false>, nbwd_smem))) return err;
  if ((err = allow_smem(node_bwd_kernel<true>, nbwd_smem))) return err;
  if ((err = allow_smem(edge_bwd_kernel<false>, ebwd_smem))) return err;
  if ((err = allow_smem(edge_bwd_kernel<true>, ebwd_smem))) return err;
  if ((err = allow_smem(node_scatter_kernel, scat_smem))) return err;
  if ((err = allow_smem(dx0_kernel, dx0_smem))) return err;
  if ((err = allow_smem(wgrad_kernel, WG_SMEM))) return err;

  const dim3 proj_grid((N + er - 1) / er, B);
  const dim3 cls_grid((E + er - 1) / er, B);
  const dim3 node_grid((N + nr - 1) / nr, B);
  const dim3 edge_grid((E + EB_ROWS - 1) / EB_ROWS, B);
  const long long nrows = (long long)B * N;
  if ((err = cudaMemsetAsync(w.T, 0, nrows * 2 * M1 * f, stream))) return err;
  if ((err = cudaMemsetAsync(w.dxa, 0, nrows * nd * f, stream))) return err;
  auto g = [&](int i) { return dblob + woff[i]; };

  // x0 projections, every column (the x0 ones serve every layer)
  proj_kernel<<<proj_grid, NT, proj_smem, stream>>>(p, xs, x_win, w.npb, PW);
  if ((err = cudaGetLastError())) return err;

  // ---- classifier ----
  // the masks' regions (fused_mp_train_mask_bytes), null without a buffer
  const long long erows_m = (long long)B * E, nrows_m = (long long)B * N;
  const long long layer_bytes = erows_m * (H1 + H2 + 2 * M1) + nrows_m * (C1 + C2);
  auto layer_masks = [&](int t) {
    LayerMasks m{};
    if (masks) {
      unsigned char* base = masks + t * layer_bytes;
      m.h1 = base;
      m.h2 = m.h1 + erows_m * H1;
      m.f1 = m.h2 + erows_m * H2;
      m.p1 = m.f1 + erows_m * M1;
      m.c1 = m.p1 + erows_m * M1;
      m.c2 = m.c1 + nrows_m * C1;
    }
    return m;
  };
  ClsMasks cmk{};
  if (masks) {
    cmk.a1 = masks + depth * layer_bytes;
    cmk.a2 = cmk.a1 + erows_m * L1;
    cmk.a3 = cmk.a2 + erows_m * L2;
  }

  const float* e_fin = es + depth * e_slot;
  if (masks)
    cls_bwd_kernel<true><<<cls_grid, NT, cls_smem, stream>>>(p, q, e_fin, e_win, ds,
                                                            logits, w, de0, cmk);
  else
    cls_bwd_kernel<false><<<cls_grid, NT, cls_smem, stream>>>(p, q, e_fin, e_win, ds,
                                                             logits, w, de0, cmk);
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
    const LayerMasks mk = layer_masks(t);
    if (masks)
      node_bwd_kernel<true><<<node_grid, NB_NT, nbwd_smem, stream>>>(p, q, agg_t, a_win,
                                                                   dX_in, w, mk);
    else
      node_bwd_kernel<false><<<node_grid, NB_NT, nbwd_smem, stream>>>(p, q, agg_t, a_win,
                                                                    dX_in, w, mk);
    if ((err = cudaGetLastError())) return err;
    if (masks)
      edge_bwd_kernel<true><<<edge_grid, EB_NT, ebwd_smem, stream>>>(
          p, q, w.npb, e_t, e_n, e_win, att, src, dst, de0, datt, w, mk);
    else
      edge_bwd_kernel<false><<<edge_grid, EB_NT, ebwd_smem, stream>>>(
          p, q, w.npb, e_t, e_n, e_win, att, src, dst, de0, datt, w, mk);
    if ((err = cudaGetLastError())) return err;
    node_scatter_kernel<<<node_grid, NB_NT, scat_smem, stream>>>(
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
