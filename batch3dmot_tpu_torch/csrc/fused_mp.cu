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
// One kernel family here covers every bucket up to (1024, 32768), and the
// inference entry windows up to (2560, 102400) (COVER_N, COVER_E: the device
// pipeline's dense window of 500 boxes a frame, L = 5, kNN 40). The
// tensor-core products live in tc_gemm.cuh, the weight-blob layout and the
// classifier's fp32 product in mp_common.cuh; the training backward (B5,
// B7) is fused_mp_train.cu.
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
// What bounds it on this card: operations. Per edge and layer the edge
// side is ~0.54 MFLOP at mm widths; one padded (256, 4096) window at depth
// 6 is ~13.6 GFLOP against ~2 MiB of inputs and outputs, far above the
// card's operations-per-byte line. So every product of the edge update,
// the two message MLPs, the combine MLP and the node projections runs on
// the tensor cores at float32 accuracy (3xTF32, each 8-deep step's sum
// rounded to nearest and added to a float32 register sum, tc_gemm.cuh:
// four TF32 products per step, never a single TF32 pass). The design:
//   * The weights are split into their TF32 big and small parts once per
//     call by the wrapper (ops/fused_mp.py::tc_weights and split_tf32, bit
//     for bit the device's split_tf32) and laid out as streams of K slices
//     in the order the blocks consume them (tc_stream.cuh): no block splits
//     a weight or computes a weight address. One thread per block copies
//     each slice with one bulk asynchronous copy (the TMA unit) into a ring
//     of shared-memory slots that completes on an mbarrier, slices ahead of
//     the products and across product boundaries.
//   * edge_kernel (the seven products of every layer's edge side, ~90% of
//     the FLOPs) runs them as wgmma.m64nNk8: 64 edge rows per block, two
//     warpgroups each taking half of a product's columns, the weights (B,
//     transposed to [out, in]: tf32 wgmma wants B K-major) from the ring,
//     the activations (A) read and split by each thread into registers, so
//     the split costs no shared-memory round trip. A layer's edge weights
//     (1.2 MB of big and small parts at mm widths with attention) stream
//     from L2 once per 64 rows, half the traffic of 32-row blocks. ~217 KB
//     of shared memory (three 32 KB ring slots, the padded activations with
//     h2 and the messages aliased onto the [e | att] rows, the biases)
//     holds one block per SM. fused_mp_plan in ops/fused_mp.py gives every
//     kernel's shared bytes and the node kernels' column shares, and
//     run_forward refuses a plan that differs from its own arithmetic.
//     What still bounds it is not the tensor cores (the forward runs at
//     about a tenth of its 3xTF32 bound, PERF.md) but what one block per SM
//     does between its products and cannot overlap with them: the
//     per-slice handshake (mbarrier wait, barrier, issue), the node-row
//     gathers, the edge-row loads and the epilogues.
//   * The TPU kernels build one-hot gather/scatter matrices for the MXU; on
//     this card that is N times the work, so rows are gathered by index.
//     The x-dependent parts of every first layer and the loop-invariant x0
//     parts are projected once per NODE (xproj_kernel, the tail of
//     node_kernel) and gathered per edge after the product, in coalesced
//     16-byte pieces through shared memory; ~45% of the edge FLOPs go (a
//     reassociation of the same sums).
//   * Blocks run in no order, so nothing is carried between them: per
//     layer one launch updates the edges (edge_kernel) and a second one
//     sums messages per node over a CSR built by the caller (node_kernel).
//     A warp sums one (node, CSR) in edge order, lanes across float4
//     columns (half-warps at M = 64), the CSR row's edge ids read 32 at a
//     time and shuffled, eight row loads in flight: the same sums bit for
//     bit as a serial index_add_. node_kernel then runs the combine MLP and
//     its share of the next layer's node projection with 3xTF32 mma.sync
//     (16 node rows, below wgmma's 64) from its own weight stream; the
//     projection's 256-column passes are shared out over blockIdx.z so
//     that a small batch ((256, 4096) x2: 32 node tiles) still fills the
//     card.
//   * Rows leave shared memory in coalesced 16-byte pieces (store_rows),
//     not from the fragment-layout epilogues.
// Launches per forward: 1 + 2 * depth + 1. The classifier (64 -> 32 -> 16
// -> 8 -> 1, once per forward, ~1% of the FLOPs) stays on mp_common.cuh's
// fp32 block_gemm: its widths are below a tensor-core tile's worth of work.
// Inference updates the edge state in place: each block reads its rows
// before it writes them.
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
#include "tc_gemm.cuh"
#include "tc_stream.cuh"

namespace {

// Forward tensor-core kernels: 8 warps (two warpgroups). The edge kernel
// takes 64 rows (wgmma's M) and tc_stream.cuh's EDGE_KC-deep weight slices,
// EDGE_STAGES in its ring; the node kernels take NODE_T rows and slices 16
// deep, three in the ring.
constexpr int FT_WARPS = 8, FT_NT = 32 * FT_WARPS;
constexpr int EDGE_R = 64;
constexpr int NODE_KC = 16, NODE_STAGES = 3;
constexpr int MAX_SLICES = 128;       // weight slices of a layer's edge products
constexpr int MAX_NODE_SLICES = 128;  // weight slices of a node block
constexpr int BAR_FLOATS = 16;        // room for a ring's mbarriers
using EdgeRing = SliceRing<EDGE_KC, EDGE_STAGES>;
using NodeRing = SliceRing<NODE_KC, NODE_STAGES>;
constexpr int NODE_T = 16;  // node rows per block (one m16 tile)
constexpr int SMEM_LIMIT = 232448;
// The cover (ops/fused_mp.py::COVER). Shared memory does not grow with N or
// E; every buffer sized from them is addressed in 64 bits; the int32 edge
// ids (b * E + e) and CSR offsets (b * (N + 1) + n) must hold B * E and
// B * (N + 1) + 1.
constexpr int COVER_N = 2560, COVER_E = 102400;

// The tensor-core products' weights, split into TF32 parts and laid out
// as streams of slices by the wrapper (ops/fused_mp.py::tc_weights;
// tc_stream.cuh): the edge kernel's seven products (Wea, W1, W2, Fue, F1,
// Pue, P1) and the node kernels' five (C0, C1w, C2w, then the node
// projection's x columns Wp[:, :QW] and x0 columns Wp[:, QW:]).
struct TcW {
  const float *edge, *node;
};

// The edge products' biases (eb0, b1, b2, fb0, fb1, pb0, pb1), staged in
// shared memory once per block.
__host__ __device__ inline int edge_bias_floats(const Params& p) {
  return p.H1 + p.H2 + p.ed + 2 * (p.M1 + p.M);
}

// Slices of the edge stream (and their table in out, when not null).
__host__ __device__ inline int edge_slices(const Params& p, int2* out) {
  const int ea_w = p.ed * (p.with_att ? 2 : 1);
  const int kn[7][2] = {{ea_w, p.H1}, {p.H1, p.H2}, {p.H2, p.ed}, {p.ed, p.M1},
                        {p.M1, p.M},  {p.ed, p.M1}, {p.M1, p.M}};
  int n = 0, pos = 0;
  for (int i = 0; i < 7; ++i) pos = product_slices<EDGE_KC>(kn[i][0], kn[i][1], pos, out, n);
  return n;
}

// Node stream offsets: the projection's x part and x0 part.
__host__ __device__ inline int node_wpx(const Params& p) {
  return product_floats<NODE_KC>(2 * p.M, p.C1) + product_floats<NODE_KC>(p.C1, p.C2) +
         product_floats<NODE_KC>(p.C2, p.nd);
}
__host__ __device__ inline int node_wp0(const Params& p) {
  return node_wpx(p) + product_floats<NODE_KC>(p.nd, p.QW);
}
__host__ __device__ inline int passes(int N) { return (N + 255) / 256; }

// Slices a node_kernel block consumes: the combine MLP's, then (proj) the
// passes z, z + S, ... of the projection's x part.
__host__ __device__ inline int node_slices(const Params& p, int z, int S, bool proj,
                                           int2* out) {
  int n = 0, pos = 0;
  pos = product_slices<NODE_KC>(2 * p.M, p.C1, pos, out, n);
  pos = product_slices<NODE_KC>(p.C1, p.C2, pos, out, n);
  pos = product_slices<NODE_KC>(p.C2, p.nd, pos, out, n);
  for (int q = z; proj && q < passes(p.QW); q += S)
    pass_slices<NODE_KC>(p.nd, min(256, p.QW - 256 * q),
                         pos + pass_offset<NODE_KC>(p.nd, 256 * q), out, n);
  return n;
}

// Pass q of the x0 projection (the x part's passes, then the x0 part's):
// its first column in npb, its width and its stream offset.
__host__ __device__ inline void xproj_pass(const Params& p, int q, int& c0, int& P, int& pos) {
  const int px = passes(p.QW);
  if (q < px) {
    c0 = 256 * q;
    P = min(256, p.QW - c0);
    pos = node_wpx(p) + pass_offset<NODE_KC>(p.nd, c0);
  } else {
    const int c = 256 * (q - px);
    c0 = p.QW + c;
    P = min(256, p.PW - c0);
    pos = node_wp0(p) + pass_offset<NODE_KC>(p.nd, c);
  }
}

// Slices an xproj_kernel block consumes: the passes z, z + S, ... of both
// projection parts.
__host__ __device__ inline int xproj_slices(const Params& p, int z, int S, int2* out) {
  int n = 0;
  for (int q = z; q < passes(p.QW) + passes(p.PW - p.QW); q += S) {
    int c0, P, pos;
    xproj_pass(p, q, c0, P, pos);
    pass_slices<NODE_KC>(p.nd, P, pos, out, n);
  }
  return n;
}

// Launch plan of the forward, chosen by ops/fused_mp.py::fused_mp_plan and
// passed in dims[17..23]; dims[24] is the float offset of the node stream
// in the tensor-core weights.
struct Plan {
  int edge_rows, node_split, proj_split;
  size_t edge, node, proj, cls;  // shared-memory bytes
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Shared-memory floats of each kernel (the layouts at the top of each).
inline size_t edge_floats(const Params& p) {
  const int ea_w = p.ed * (p.with_att ? 2 : 1);
  const int lA = imax(imax(ea_w, p.H2), p.M) + TC_PAD;
  const int lH = imax(p.H1, p.M1) + TC_PAD, lU = p.ed + TC_PAD;
  return (size_t)BAR_FLOATS + ring_floats<EDGE_KC, EDGE_STAGES>() +
         (size_t)EDGE_R * (lA + lH + lU) + 2 * EDGE_R + 2 * MAX_SLICES + edge_bias_floats(p);
}

// The node kernels' buffers before their rows: the mbarriers, the ring and
// the split slices; the slice table follows the rows.
constexpr int NODE_BUF = BAR_FLOATS + ring_floats<NODE_KC, NODE_STAGES>() +
                         split_floats<NODE_T, NODE_KC>();

inline size_t node_floats(const Params& p) {
  const int lAgg = imax(2 * p.M, p.C2) + TC_PAD, lC1 = imax(p.C1, p.nd) + TC_PAD;
  return (size_t)NODE_BUF + (size_t)NODE_T * (lAgg + lC1) + 2 * MAX_NODE_SLICES;
}

inline size_t proj_floats(const Params& p) {
  return (size_t)NODE_BUF + (size_t)NODE_T * (p.nd + TC_PAD) + 2 * MAX_NODE_SLICES;
}

inline size_t cls_floats(const Params& p) {
  const int cw = imax(imax(p.ed, p.L1), imax(p.L2, p.L3));
  return (size_t)2 * EDGE_ROWS * cw + SW;
}

// The wrapper's plan, checked against this file's own arithmetic: the
// host and the kernels never disagree on a tile or a buffer.
inline bool read_plan(const int* dims, const Params& p, Plan& pl) {
  pl.edge_rows = dims[17];
  pl.node_split = dims[18];
  pl.proj_split = dims[19];
  pl.edge = (size_t)dims[20];
  pl.node = (size_t)dims[21];
  pl.proj = (size_t)dims[22];
  pl.cls = (size_t)dims[23];
  const size_t f = sizeof(float);
  const int m4 = p.M / 4, lanes = m4 < 32 ? m4 : 32;
  const int px = passes(p.QW), pp = px + passes(p.PW - p.QW);
  const long long ids = (long long)p.B * p.E, offs = (long long)p.B * (p.N + 1) + 1;
  return p.B >= 1 && p.N >= 1 && p.N <= COVER_N && p.E >= 1 && p.E <= COVER_E &&
         ids <= 2147483647LL && offs <= 2147483647LL &&
         pl.edge_rows == EDGE_R && edge_slices(p, nullptr) <= MAX_SLICES &&
         pl.node_split >= 1 && pl.node_split <= px && pl.proj_split >= 1 &&
         pl.proj_split <= pp && node_slices(p, 0, pl.node_split, true, nullptr) <= MAX_NODE_SLICES &&
         xproj_slices(p, 0, pl.proj_split, nullptr) <= MAX_NODE_SLICES &&
         32 % lanes == 0 && m4 % lanes == 0 &&
         pl.edge == edge_floats(p) * f && pl.node == node_floats(p) * f &&
         pl.proj == proj_floats(p) * f && pl.cls == cls_floats(p) * f &&
         pl.edge <= SMEM_LIMIT && pl.node <= SMEM_LIMIT && pl.proj <= SMEM_LIMIT &&
         pl.cls <= SMEM_LIMIT;
}

__device__ __forceinline__ float4 ld4(const float* a) {
  return *reinterpret_cast<const float4*>(a);
}
__device__ __forceinline__ void st4(float* a, float4 v) {
  *reinterpret_cast<float4*>(a) = v;
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// An edge-side product on the tensor cores (wgmma, tc_stream.cuh):
// out[0:64, :N] = act(sA[0:64, :K] @ W[:K, :N] + bias), W's slices from
// the ring.
__device__ __forceinline__ void edge_gemm(const float* sA, int lda, int K, int N,
                                          EdgeRing& ring, float* out, int ldo,
                                          const float* bias, bool relu) {
  wg_gemm(sA, lda, K, N, ring, out, ldo, bias, relu);
}

// sH[r, :n] += the gathered node-projection columns of row r, then ReLU,
// in coalesced 16-byte pieces, eight pieces' loads in flight per thread.
// PAIR: one node ia[r] gives both parts, added as v + (a + b) (the message
// layers); otherwise v + a[ia[r]] + b[ib[r]] in that order (the edge
// update). A -1 index adds nothing.
template <bool PAIR>
__device__ __forceinline__ void add_gathered_relu(float* sH, int lh, int rows, int n,
                                                  const int* ia, const int* ib,
                                                  const float* __restrict__ npb, int PW,
                                                  int oa, int ob) {
  constexpr int U = 8;
  const int q = n >> 2, total = rows * q;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t0 = threadIdx.x; t0 < total; t0 += U * blockDim.x) {
    float4 a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * blockDim.x, r = t / q, c = 4 * (t - r * q);
      const int i = t < total ? ia[r] : -1, j = t < total && !PAIR ? ib[r] : -1;
      a[u] = i >= 0 ? ld4(npb + (size_t)i * PW + oa + c) : zero;
      b[u] = PAIR ? (i >= 0 ? ld4(npb + (size_t)i * PW + ob + c) : zero)
                  : (j >= 0 ? ld4(npb + (size_t)j * PW + ob + c) : zero);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * blockDim.x, r = t / q, c = 4 * (t - r * q);
      if (t >= total) continue;
      float4 v = ld4(sH + r * lh + c);
      const int i = ia[r];
      if (PAIR) {
        if (i >= 0) v = add4(v, add4(a[u], b[u]));
      } else {
        if (i >= 0) v = add4(v, a[u]);
        if (ib[r] >= 0) v = add4(v, b[u]);
      }
      st4(sH + r * lh + c,
          make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f)));
    }
  }
  __syncthreads();
}

// One layer's edge side, 64 edge rows per block: edge update, future and
// past messages (to fbuf / pbuf). The edge state of window b is read from
// e_in + b * e_win and the update written to e_out + b * e_win; inference
// passes one buffer for both (each block reads its rows before it writes
// them), the training forward consecutive slots of the e_t stash. p holds
// the f32 blob's arrays (biases), tw the split tensor-core weights.
__global__ void __launch_bounds__(FT_NT, 1)
edge_kernel(Params p, TcW tw, const float* __restrict__ npb_all,
            const float* e_in, float* e_out, long long e_win,
            const float* __restrict__ att, const int* __restrict__ src,
            const int* __restrict__ dst, float* __restrict__ pbuf,
            float* __restrict__ fbuf) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = EDGE_R;
  const int ed = p.ed, ea_w = ed * (p.with_att ? 2 : 1);
  const int H1 = p.H1, H2 = p.H2, M1 = p.M1, M = p.M, PW = p.PW;
  const int lA = imax(imax(ea_w, H2), M) + TC_PAD;  // [e | att], then h2, then f / p
  const int lH = imax(H1, M1) + TC_PAD;             // h1, then the messages' hidden
  const int lU = ed + TC_PAD;                       // ue
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* sRing = smem + BAR_FLOATS;
  float* sA = sRing + ring_floats<EDGE_KC, EDGE_STAGES>();
  float* sH = sA + R * lA;
  float* sU = sH + R * lH;
  int* sSrc = reinterpret_cast<int*>(sU + R * lU);
  int* sDst = sSrc + R;
  int2* sSlices = reinterpret_cast<int2*>(sDst + R);
  float* sB = reinterpret_cast<float*>(sSlices + MAX_SLICES);  // the biases
  EdgeRing ring{sRing, bars, sSlices, tw.edge, edge_slices(p, nullptr), 0};
  if (threadIdx.x == 0) {
    edge_slices(p, sSlices);
    ring.init();
  }

  const int b = blockIdx.y, e0 = blockIdx.x * R;
  const size_t row0 = (size_t)b * p.E + e0;
  const int nv = min(R, p.E - e0);  // rows of real edges
  const float* ein = e_in + b * e_win + (size_t)e0 * ed;
  float* eout = e_out + b * e_win + (size_t)e0 * ed;
  for (int r = threadIdx.x; r < R; r += FT_NT) {
    sSrc[r] = r < nv ? src[row0 + r] : -1;
    sDst[r] = r < nv ? dst[row0 + r] : -1;
  }
  __syncthreads();  // the mbarriers and the slice table are ready
  if (threadIdx.x == 0) ring.prime();
  // the biases and the [e | att] rows, copied asynchronously (all in
  // flight at once); e is read here, before any write to it below
  const float* biases[7] = {p.eb0, p.b1, p.b2, p.fb0, p.fb1, p.pb0, p.pb1};
  const int widths[7] = {H1, H2, ed, M1, M, M1, M};
  float* bias_at[7];
  for (int i = 0, o = 0; i < 7; o += widths[i++]) {
    bias_at[i] = sB + o;
    for (int c = 4 * threadIdx.x; c < widths[i]; c += 4 * FT_NT)
      __pipeline_memcpy_async(sB + o + c, biases[i] + c, 16);
  }
  const int qa = ea_w >> 2, qe = ed >> 2;
  for (int t = threadIdx.x; t < R * qa; t += FT_NT) {
    const int r = t / qa, c4 = t - r * qa;
    float* d = sA + r * lA + 4 * c4;
    if (r < nv)
      __pipeline_memcpy_async(d, c4 < qe ? ein + (size_t)r * ed + 4 * c4
                                         : att + (row0 + r) * ed + 4 * (c4 - qe), 16);
    else
      st4(d, make_float4(0.f, 0.f, 0.f, 0.f));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const float* npb = npb_all + (size_t)b * p.N * PW;

  // h1 = relu([e|att] W0cd + eb0 + x_i W0a + x_j W0b)
  edge_gemm(sA, lA, ea_w, H1, ring, sH, lH, bias_at[0], false);
  add_gathered_relu<false>(sH, lH, R, H1, sDst, sSrc, npb, PW, p.o_eui, p.o_euj);
  // h2 = relu(h1 W1 + b1), over the dead [e | att] rows
  edge_gemm(sH, lH, H1, H2, ring, sA, lA, bias_at[1], true);
  // ue = h2 W2 + b2, the new edge state
  edge_gemm(sA, lA, H2, ed, ring, sU, lU, bias_at[2], false);
  store_rows(sU, lU, eout, ed, nv);
  // future message: relu(ue F0b + fb0 + (x_i F0a + x0_i F0c)) F1 + fb1
  edge_gemm(sU, lU, ed, M1, ring, sH, lH, bias_at[3], false);
  add_gathered_relu<true>(sH, lH, R, M1, sDst, nullptr, npb, PW, p.o_fut, p.o_fx0);
  edge_gemm(sH, lH, M1, M, ring, sA, lA, bias_at[4], false);
  store_rows(sA, lA, fbuf + row0 * M, M, nv);
  // past message: relu(ue P0b + pb0 + (x_j P0a + x0_j P0c)) P1 + pb1
  edge_gemm(sU, lU, ed, M1, ring, sH, lH, bias_at[5], false);
  add_gathered_relu<true>(sH, lH, R, M1, sSrc, nullptr, npb, PW, p.o_past, p.o_px0);
  edge_gemm(sH, lH, M1, M, ring, sA, lA, bias_at[6], false);
  store_rows(sA, lA, pbuf + row0 * M, M, nv);
}

// Per-node message sums of NODE_T nodes into sAgg (row stride lAgg):
// columns [0, M) the past messages by destination, [M, 2M) the future
// ones by source; agg_out (null for none) receives the same rows. A warp
// (or a half-warp when M = 64) takes one (node, CSR) at a time, lanes
// across float4 columns: the CSR row's edge ids are read LT at a time by
// the lanes and shuffled, eight rows' loads are in flight at once, and
// each sum starts at 0 and adds in edge order.
__device__ __forceinline__ void node_sums(const Params& p, int b, int n0,
                                          const float* __restrict__ pbuf,
                                          const float* __restrict__ fbuf,
                                          const int* __restrict__ doff,
                                          const int* __restrict__ dperm,
                                          const int* __restrict__ soff,
                                          const int* __restrict__ sperm, float* sAgg,
                                          int lAgg, float* __restrict__ agg_out) {
  const int M = p.M, m4 = M >> 2;
  const int LT = m4 < 32 ? m4 : 32;  // lanes per task (the plan checks 32 % LT == 0)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int li = lane % LT, per_warp = 32 / LT;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t0 = warp * per_warp; t0 < 2 * NODE_T; t0 += FT_WARPS * per_warp) {
    const int task = t0 + lane / LT;
    const int r = task >> 1, part = task & 1, n = n0 + r;
    const int* off = part ? soff : doff;
    const int* perm = part ? sperm : dperm;
    const float* v = part ? fbuf : pbuf;
    int q0 = 0, cnt = 0;
    if (n < p.N) {
      const int k = b * (p.N + 1) + n;
      q0 = off[k];
      cnt = off[k + 1] - q0;
    }
    const int most = __reduce_max_sync(0xffffffffu, cnt);
    for (int g0 = 0; g0 < m4; g0 += LT) {
      const int c4 = g0 + li;
      float4 s = zero;
      for (int base = 0; base < most; base += LT) {
        const int id = base + li < cnt ? perm[q0 + base + li] : 0;
        const int jn = min(LT, most - base);
        for (int j = 0; j < jn; j += 8) {
          float4 x[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int e = __shfl_sync(0xffffffffu, id, (j + u) & (LT - 1), LT);
            x[u] = j + u < jn && base + j + u < cnt ? ld4(v + (size_t)e * M + 4 * c4) : zero;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (j + u < jn && base + j + u < cnt) s = add4(s, x[u]);
        }
      }
      const int c = part * M + 4 * c4;
      st4(sAgg + r * lAgg + c, s);
      if (agg_out && n < p.N) st4(agg_out + (size_t)r * 2 * M + c, s);
    }
  }
  __syncthreads();
}

// One layer's node side for NODE_T nodes: the per-node message sums, the
// combine MLP, then share blockIdx.z of the next layer's node projection
// (the 256-column passes z, z + S, ... of its x part, S = gridDim.z;
// skipped after the last layer, which launches one share). Every share
// recomputes the sums and the combine MLP; share 0 alone writes the
// training stashes agg_out (the sums) and x_out (the new x); inference
// passes null for both. Products: mma.sync on the node weight stream.
__global__ void __launch_bounds__(FT_NT, 2)
node_kernel(Params p, TcW tw, const float* __restrict__ pbuf,
            const float* __restrict__ fbuf, const int* __restrict__ doff,
            const int* __restrict__ dperm, const int* __restrict__ soff,
            const int* __restrict__ sperm, float* __restrict__ npb_all,
            int write_proj, float* __restrict__ agg_out, long long agg_win,
            float* __restrict__ x_out, long long x_win) {
  extern __shared__ __align__(16) float smem[];
  const int M2 = 2 * p.M, C1 = p.C1, C2 = p.C2, nd = p.nd;
  const int lAgg = imax(M2, C2) + TC_PAD;  // the sums, then c2
  const int lC1 = imax(C1, nd) + TC_PAD;   // c1, then the new x
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* sRing = smem + BAR_FLOATS;
  float* sSplit = sRing + ring_floats<NODE_KC, NODE_STAGES>();
  float* sAgg = smem + NODE_BUF;
  float* sC1 = sAgg + NODE_T * lAgg;
  int2* sSlices = reinterpret_cast<int2*>(sC1 + NODE_T * lC1);
  const int b = blockIdx.y, n0 = blockIdx.x * NODE_T, z = blockIdx.z, S = gridDim.z;
  const int nv = min(NODE_T, p.N - n0);
  if (write_proj && z >= passes(p.QW)) return;  // a spare share: the whole block leaves
  NodeRing ring{sRing, bars, sSlices, tw.node, node_slices(p, z, S, write_proj, nullptr), 0};
  if (threadIdx.x == 0) {
    node_slices(p, z, S, write_proj, sSlices);
    ring.init();
  }
  __syncthreads();  // the mbarriers and the slice table are ready
  if (threadIdx.x == 0) ring.prime();
  const bool stash = z == 0;
  node_sums(p, b, n0, pbuf, fbuf, doff, dperm, soff, sperm, sAgg, lAgg,
            stash && agg_out ? agg_out + b * agg_win + (size_t)n0 * M2 : nullptr);

  mma_gemm(sAgg, lAgg, M2, C1, ring, sSplit, sC1, lC1, p.cb0, true, NODE_T);
  mma_gemm(sC1, lC1, C1, C2, ring, sSplit, sAgg, lAgg, p.cb1, true, NODE_T);
  mma_gemm(sAgg, lAgg, C2, nd, ring, sSplit, sC1, lC1, p.cb2, false, NODE_T);
  if (stash && x_out) store_rows(sC1, lC1, x_out + b * x_win + (size_t)n0 * nd, nd, nv);
  if (!write_proj) return;
  float* out = npb_all + ((size_t)b * p.N + n0) * p.PW;
  for (int q = z; q < passes(p.QW); q += S)
    mma_pass(sC1, lC1, nd, 256 * q, min(256, p.QW - 256 * q), ring, sSplit, out, p.PW,
             nullptr, false, nv);
}

// Node projections of x0 (all PW columns: the x part of the first layers
// and the loop-invariant x0 part), NODE_T nodes and one share (the passes
// blockIdx.z, + gridDim.z, ... of both parts) per block. Window b's rows
// start at x + b * x_win.
__global__ void __launch_bounds__(FT_NT, 2)
xproj_kernel(Params p, TcW tw, const float* __restrict__ x, long long x_win,
             float* __restrict__ npb) {
  extern __shared__ __align__(16) float smem[];
  const int nd = p.nd, lx = nd + TC_PAD;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* sRing = smem + BAR_FLOATS;
  float* sSplit = sRing + ring_floats<NODE_KC, NODE_STAGES>();
  float* sX = smem + NODE_BUF;
  int2* sSlices = reinterpret_cast<int2*>(sX + NODE_T * lx);
  const int b = blockIdx.y, n0 = blockIdx.x * NODE_T, z = blockIdx.z, S = gridDim.z;
  const int nv = min(NODE_T, p.N - n0);
  NodeRing ring{sRing, bars, sSlices, tw.node, xproj_slices(p, z, S, nullptr), 0};
  if (ring.n == 0) return;  // a spare share
  if (threadIdx.x == 0) {
    xproj_slices(p, z, S, sSlices);
    ring.init();
  }
  const int q4 = nd >> 2;
  for (int t = threadIdx.x; t < NODE_T * q4; t += FT_NT) {
    const int r = t / q4, c = 4 * (t - r * q4);
    if (r < nv)
      __pipeline_memcpy_async(sX + r * lx + c, x + b * x_win + (size_t)(n0 + r) * nd + c, 16);
    else
      st4(sX + r * lx + c, make_float4(0.f, 0.f, 0.f, 0.f));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();  // x rows, the mbarriers and the slice table are ready
  if (threadIdx.x == 0) ring.prime();
  float* out = npb + ((size_t)b * p.N + n0) * p.PW;
  for (int q = z; q < passes(p.QW) + passes(p.PW - p.QW); q += S) {
    int c0, P, pos;
    xproj_pass(p, q, c0, P, pos);
    mma_pass(sX, lx, nd, c0, P, ring, sSplit, out, p.PW, nullptr, false, nv);
  }
}

// Edge classifier MLP on the final edge state (window b's rows at
// e_in + b * e_win); row 0 of its output. fp32 block_gemm (see the note).
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

// The shared launch sequence. Inference: e_state is read and updated in
// place (e_win = E * ed) and the stash pointers are null. Training: the
// edge state lives in the e_t stash (e_win = (depth + 1) * E * ed).
// tblob: the tensor-core weights' streams, the edge stream first, the node
// stream at float offset dims[24].
int run_forward(const int* dims, const long long* woff, const float* wblob,
                const float* tblob, const float* x0, long long x0_win,
                float* e_state, long long e_win, const float* att, const int* src,
                const int* dst, const int* doff, const int* dperm, const int* soff,
                const int* sperm, float* npb, float* pbuf, float* fbuf, float* xs,
                float* agg, float* out, cudaStream_t stream) {
  Params p;
  Plan pl;
  if (!fill_params(dims, woff, wblob, p) || !read_plan(dims, p, pl))
    return cudaErrorInvalidValue;
  const TcW tw{tblob, tblob + dims[24]};
  const int depth = p.depth, logits = dims[7];
  const int R = EDGE_R;
  cudaError_t err;
  if ((err = allow_smem(xproj_kernel, pl.proj))) return err;
  if ((err = allow_smem(edge_kernel, pl.edge))) return err;
  if ((err = allow_smem(node_kernel, pl.node))) return err;
  if ((err = allow_smem(classifier_kernel, pl.cls))) return err;

  const int node_tiles = (p.N + NODE_T - 1) / NODE_T;
  const dim3 edge_grid((p.E + R - 1) / R, p.B);
  const dim3 cls_grid((p.E + EDGE_ROWS - 1) / EDGE_ROWS, p.B);
  const long long e_slot = (long long)p.E * p.ed;
  const long long x_win = (long long)depth * p.N * p.nd;
  const long long agg_win = (long long)depth * p.N * 2 * p.M;
  const bool stash = xs != nullptr;
  xproj_kernel<<<dim3(node_tiles, p.B, pl.proj_split), FT_NT, pl.proj, stream>>>(
      p, tw, x0, x0_win, npb);
  if ((err = cudaGetLastError())) return err;
  for (int layer = 0; layer < depth; ++layer) {
    const float* e_in = stash ? e_state + layer * e_slot : e_state;
    float* e_out = stash ? e_state + (layer + 1) * e_slot : e_state;
    edge_kernel<<<edge_grid, FT_NT, pl.edge, stream>>>(
        p, tw, npb, e_in, e_out, e_win, att, src, dst, pbuf, fbuf);
    if ((err = cudaGetLastError())) return err;
    const bool last = layer + 1 == depth;
    float* x_next = stash && !last ? xs + (long long)(layer + 1) * p.N * p.nd : nullptr;
    float* agg_t = stash ? agg + (long long)layer * p.N * 2 * p.M : nullptr;
    node_kernel<<<dim3(node_tiles, p.B, last ? 1 : pl.node_split), FT_NT, pl.node,
                  stream>>>(p, tw, pbuf, fbuf, doff, dperm, soff, sperm, npb,
                            !last, agg_t, agg_win, x_next, x_win);
    if ((err = cudaGetLastError())) return err;
  }
  classifier_kernel<<<cls_grid, NT, pl.cls, stream>>>(
      p, stash ? e_state + depth * e_slot : e_state, e_win, out, logits);
  return cudaGetLastError();
}

}  // namespace

// Inference. dims, woff: see fill_params in mp_common.cuh (and Plan above
// for dims[17..24]); tblob: the tensor-core weights' streams. e_state
// holds e0 on entry and the final edge state on return. Returns the first
// CUDA error (0 on success); nothing is synchronised.
extern "C" int fused_mp_forward(const int* dims, const long long* woff,
                                const float* wblob, const float* tblob,
                                const float* x0, float* e_state, const float* att,
                                const int* src, const int* dst,
                                const int* doff, const int* dperm,
                                const int* soff, const int* sperm,
                                float* npb, float* pbuf, float* fbuf,
                                float* out, void* stream_ptr) {
  return run_forward(dims, woff, wblob, tblob, x0, (long long)dims[1] * dims[3],
                     e_state, (long long)dims[2] * dims[4], att, src, dst, doff, dperm,
                     soff, sperm, npb, pbuf, fbuf, nullptr, nullptr, out,
                     reinterpret_cast<cudaStream_t>(stream_ptr));
}

// Training forward: the same scores, plus the stashes the backward reads.
// xs [B, depth, N, nd] holds x0 in slot 0 on entry, es [B, depth + 1, E,
// ed] holds e0 in slot 0; agg [B, depth, N, 2M] is written whole.
extern "C" int fused_mp_forward_stash(const int* dims, const long long* woff,
                                      const float* wblob, const float* tblob,
                                      const float* att, const int* src,
                                      const int* dst, const int* doff,
                                      const int* dperm, const int* soff,
                                      const int* sperm, float* npb, float* pbuf,
                                      float* fbuf, float* xs, float* es, float* agg,
                                      float* out, void* stream_ptr) {
  const long long x_win = (long long)dims[6] * dims[1] * dims[3];
  const long long e_win = (long long)(dims[6] + 1) * dims[2] * dims[4];
  return run_forward(dims, woff, wblob, tblob, xs, x_win, es, e_win, att, src, dst,
                     doff, dperm, soff, sperm, npb, pbuf, fbuf, xs, agg, out,
                     reinterpret_cast<cudaStream_t>(stream_ptr));
}
