// Fused causal message passing + edge classifier for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of batch3dmot_tpu/ops/pallas_mp.py,
// which compute one function, fused_mp_scores:
//   B1 _mp_kernel            (single-shot, E*N <= 128k)
//   B2 _mp_kernel_tiled      (edge tiles, E*N up to 2M / 4M)
//   B3 _mp_kernel_tiled_hbm  (edge state in HBM, up to (512, 8192))
// and, through the second entry fused_mp_forward_stash, the forward halves
// of the two training kernel pairs of batch3dmot_tpu/ops/pallas_mp_train.py:
//   B4 _train_fwd_kernel        (:265, E*N <= 32k)
//   B6 _train_fwd_kernel_tiled  (:523, edge tiles, E*N up to 1M / 2M)
// One kernel family here covers every bucket up to (1024, 32768). The
// building blocks live in mp_common.cuh; the training backward (B5, B7)
// is fused_mp_train.cu.
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
//
// The training forward (B4/B6) is the same launch sequence with three
// stash outputs for the backward: x_t [B, depth, N, nd] (t < depth),
// e_t [B, depth + 1, E, ed] (t <= depth; the edge kernel reads slot t and
// writes slot t + 1, so the stash is the edge state) and the per-node
// message sums agg_t [B, depth, N, 2M], so the backward recomputes the
// combine MLP without the message MLPs' second layers. Slot 0 of x_t and
// e_t holds x0 and e0 on entry. At (1024, 32768) x1 and mm widths the
// e_t stash is 7 * 32768 * 64 * 4 B = 59 MB. The stash writes are a few
// bytes per FLOP; the bound stays the arithmetic.

#include "mp_common.cuh"

namespace {

// One layer's edge side: edge update, future and past messages (written to
// fbuf / pbuf). The edge state of window b is read from e_in + b * e_win
// and the update written to e_out + b * e_win; inference passes one
// buffer for both (each block reads its rows before it writes them), the
// training forward passes consecutive slots of the e_t stash.
__global__ void __launch_bounds__(NT, 2)
edge_kernel(Params p, const float* __restrict__ npb_all, const float* e_in,
            float* e_out, long long e_win, const float* __restrict__ att,
            const int* __restrict__ src, const int* __restrict__ dst,
            float* __restrict__ pbuf, float* __restrict__ fbuf) {
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
  const float* ein = e_in + b * e_win + (size_t)e0 * p.ed;
  float* eout = e_out + b * e_win + (size_t)e0 * p.ed;
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
      v = c < p.ed ? ein[(size_t)r * p.ed + c]
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
    if (e0 + r < p.E) eout[(size_t)r * ed + c] = v;
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
// The training forward also stashes the sums (agg_out) and the new x
// (x_out); inference passes null for both.
// Blocks of 16 nodes, so that a (256-node, 8-window) batch fills the card.
__global__ void __launch_bounds__(NT, 3)
node_kernel(Params p, const float* __restrict__ pbuf,
            const float* __restrict__ fbuf, const int* __restrict__ doff,
            const int* __restrict__ dperm, const int* __restrict__ soff,
            const int* __restrict__ sperm, float* __restrict__ npb_all,
            int write_proj, float* __restrict__ agg_out, long long agg_win,
            float* __restrict__ x_out, long long x_win) {
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
      v = c < M ? csr_sum(pbuf, M, c, doff, dperm, k)
                : csr_sum(fbuf, M, c - M, soff, sperm, k);
      if (agg_out) agg_out[b * agg_win + (size_t)n * M2 + c] = v;
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
    v += p.cb2[c];
    sX[r * nd + c] = v;
    const int n = n0 + r;
    if (x_out && n < p.N) x_out[b * x_win + (size_t)n * nd + c] = v;
  });
  if (!write_proj) return;
  float* out = npb_all + (size_t)b * p.N * p.PW;
  block_gemm<NODE_TM>(sX, nd, nd, p.Wp, p.PW, p.QW, sW, [&](int r, int c, float v) {
    const int n = n0 + r;
    if (n < p.N) out[(size_t)n * p.PW + c] = v;
  });
}

// Edge classifier MLP on the final edge state (window b's rows at
// e_in + b * e_win); row 0 of its output.
__global__ void __launch_bounds__(NT, 2)
classifier_kernel(Params p, const float* __restrict__ e_in, long long e_win,
                  float* __restrict__ out, int logits) {
  extern __shared__ float smem[];
  const int rows = EDGE_ROWS;
  const int w = max(max(p.ed, p.L1), max(p.L2, p.L3));
  float* sA = smem;
  float* sB = sA + rows * w;
  float* sW = sB + rows * w;
  const int b = blockIdx.y, e0 = blockIdx.x * rows;
  const size_t row0 = (size_t)b * p.E + e0;
  const float* ein = e_in + b * e_win + (size_t)e0 * p.ed;
  for (int t = threadIdx.x; t < rows * p.ed; t += blockDim.x) {
    const int r = t / p.ed, c = t - r * p.ed;
    sA[r * w + c] = e0 + r < p.E ? ein[(size_t)r * p.ed + c] : 0.f;
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

// Shared-memory bytes of the forward kernels.
struct FwdSmem {
  size_t proj, edge, node, cls;
};

inline FwdSmem fwd_smem(const Params& p) {
  const size_t f = sizeof(float);
  const size_t sw = (size_t)SW * f;
  const int er = EDGE_ROWS, nr = NODE_ROWS;
  const int ea_w = p.ed * (p.with_att ? 2 : 1);
  FwdSmem s;
  s.proj = (size_t)er * p.nd * f + sw;
  s.edge = 2 * er * sizeof(int) +
           (size_t)er * (ea_w + (p.H1 > p.M1 ? p.H1 : p.M1) + p.H2 + p.ed) * f + sw;
  s.node = (size_t)nr * (2 * p.M + p.C1 + p.C2 + p.nd) * f + sw;
  int cw = p.ed;
  if (p.L1 > cw) cw = p.L1;
  if (p.L2 > cw) cw = p.L2;
  if (p.L3 > cw) cw = p.L3;
  s.cls = (size_t)2 * er * cw * f + sw;
  return s;
}


// The shared launch sequence. Inference: e_state is read and updated in
// place (e_win = E * ed) and the stash pointers are null. Training: the
// edge state lives in the e_t stash (e_win = (depth + 1) * E * ed).
int run_forward(const int* dims, const long long* woff, const float* wblob,
                const float* x0, long long x0_win, float* e_state,
                long long e_win,
                const float* att, const int* src, const int* dst,
                const int* doff, const int* dperm, const int* soff,
                const int* sperm, float* npb, float* pbuf, float* fbuf,
                float* xs, float* agg, float* out, cudaStream_t stream) {
  Params p;
  if (!fill_params(dims, woff, wblob, p)) return cudaErrorInvalidValue;
  const int depth = p.depth, logits = dims[7];
  const FwdSmem sm = fwd_smem(p);
  cudaError_t err;
  if ((err = allow_smem(proj_kernel, sm.proj))) return err;
  if ((err = allow_smem(edge_kernel, sm.edge))) return err;
  if ((err = allow_smem(node_kernel, sm.node))) return err;
  if ((err = allow_smem(classifier_kernel, sm.cls))) return err;

  const int er = EDGE_ROWS, nr = NODE_ROWS;
  const dim3 proj_grid((p.N + er - 1) / er, p.B);
  const dim3 node_grid((p.N + nr - 1) / nr, p.B);
  const dim3 edge_grid((p.E + er - 1) / er, p.B);
  const long long e_slot = (long long)p.E * p.ed;
  const long long x_win = (long long)depth * p.N * p.nd;
  const long long agg_win = (long long)depth * p.N * 2 * p.M;
  const bool stash = xs != nullptr;
  proj_kernel<<<proj_grid, NT, sm.proj, stream>>>(p, x0, x0_win, npb, p.PW);
  if ((err = cudaGetLastError())) return err;
  for (int layer = 0; layer < depth; ++layer) {
    const float* e_in = stash ? e_state + layer * e_slot : e_state;
    float* e_out = stash ? e_state + (layer + 1) * e_slot : e_state;
    edge_kernel<<<edge_grid, NT, sm.edge, stream>>>(
        p, npb, e_in, e_out, e_win, att, src, dst, pbuf, fbuf);
    if ((err = cudaGetLastError())) return err;
    float* x_next = stash && layer + 1 < depth
                        ? xs + (long long)(layer + 1) * p.N * p.nd : nullptr;
    float* agg_t = stash ? agg + (long long)layer * p.N * 2 * p.M : nullptr;
    node_kernel<<<node_grid, NT, sm.node, stream>>>(
        p, pbuf, fbuf, doff, dperm, soff, sperm, npb, layer + 1 < depth,
        agg_t, agg_win, x_next, x_win);
    if ((err = cudaGetLastError())) return err;
  }
  classifier_kernel<<<edge_grid, NT, sm.cls, stream>>>(
      p, stash ? e_state + depth * e_slot : e_state, e_win, out, logits);
  return cudaGetLastError();
}

}  // namespace

// Inference. dims, woff: see fill_params in mp_common.cuh. e_state holds
// e0 on entry and the final edge state on return. Returns the first CUDA
// error (0 on success); nothing is synchronised.
extern "C" int fused_mp_forward(const int* dims, const long long* woff,
                                const float* wblob, const float* x0,
                                float* e_state, const float* att,
                                const int* src, const int* dst,
                                const int* doff, const int* dperm,
                                const int* soff, const int* sperm,
                                float* npb, float* pbuf, float* fbuf,
                                float* out, void* stream_ptr) {
  return run_forward(dims, woff, wblob, x0, (long long)dims[1] * dims[3],
                     e_state, (long long)dims[2] * dims[4], att, src, dst, doff, dperm,
                     soff, sperm, npb, pbuf, fbuf, nullptr, nullptr, out,
                     reinterpret_cast<cudaStream_t>(stream_ptr));
}

// Training forward: the same scores, plus the stashes the backward reads.
// xs [B, depth, N, nd] holds x0 in slot 0 on entry, es [B, depth + 1, E,
// ed] holds e0 in slot 0; agg [B, depth, N, 2M] is written whole.
extern "C" int fused_mp_forward_stash(const int* dims, const long long* woff,
                                      const float* wblob, const float* att,
                                      const int* src, const int* dst,
                                      const int* doff, const int* dperm,
                                      const int* soff, const int* sperm,
                                      float* npb, float* pbuf, float* fbuf,
                                      float* xs, float* es, float* agg,
                                      float* out, void* stream_ptr) {
  const long long x_win = (long long)dims[6] * dims[1] * dims[3];
  const long long e_win = (long long)(dims[6] + 1) * dims[2] * dims[4];
  return run_forward(dims, woff, wblob, xs, x_win, es, e_win, att, src, dst, doff,
                     dperm, soff, sperm, npb, pbuf, fbuf, xs, agg, out,
                     reinterpret_cast<cudaStream_t>(stream_ptr));
}
