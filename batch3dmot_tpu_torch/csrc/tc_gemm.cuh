// Tensor-core products at float32 accuracy (3xTF32) with mma.sync for the
// training backward (fused_mp_train.cu), which splits its operands itself.
// The forward's products (fused_mp.cu) run on the tensor cores too, from
// weights split once per call: tc_stream.cuh (wgmma for the edge kernel,
// mma.sync for the node kernels), built on split_tf32 and the step
// helpers here. Only the classifiers and the backward's once-per-call
// products stay on mp_common.cuh's fp32 block_gemm.
//
// 3xTF32: each operand x is split into big = tf32(x) (round to nearest,
// ties away, as cvt.rna) and small = tf32(x - big); x = big + small to
// about 2^-22 relative. A product runs small_a*big_b, big_a*small_b and
// big_a*big_b as mma.sync.m16n8k8 (TF32 in, f32 accumulate); the dropped
// small_a*small_b term and the split's residue are about 2^-22 of each
// product, of either sign. A single TF32 product (the big terms alone)
// keeps about 3 digits and is never used here.
//
// How the sums are rounded. The tensor cores add C and a step's eight
// products in one group: each addend aligned to the largest exponent among
// them, 2 bits beyond float32's 24 kept and the rest cut toward zero, the
// aligned sum cut toward zero to float32 (mma.sync.m16n8k8 and
// wgmma.m64n16k8 on an NVIDIA H100 80GB HBM3: of 80 models of the adder,
// the one that gives all 2,048 crafted outputs of each,
// scripts/probe_tc_rounding.py). An accumulator that runs over all of K
// is cut toward zero of the running sum at every step, so its error has
// the sign of the result and grows with K, and sums of such results (a
// node's 40 messages) add it up: six layers of them ended 12-46x further
// from float64 than float32 is. So no accumulator runs over K. Each
// 8-deep step (mma_term) first runs its big*big products alone into a
// fresh accumulator (C = 0), whose sign and exponent are those of the
// step's sum; that accumulator becomes half a unit in the last place of
// it (half_ulp), and the three terms are added onto it, so that the final
// cut toward zero rounds the step's sum to nearest (ties away); the step's
// result is then added to a float32 register sum (FADD, to nearest).
// Every rounding is then one to nearest of a sum the size of the step's or
// the running sum's, as float32's own are. That is four TF32 products per
// step. tc_gemm runs each term over all of a warp's tiles in turn; the
// weight-gradient kernel (fused_mp_train.cu) one tile at a time, which
// saves registers. The order of every sum is fixed, so a second run gives
// bit-identical results.
//
// Fragments of mma.m16n8k8 (PTX ISA), lane = 4 * g + t:
//   A 16x8 (row):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B 8x8 (col):   b0 (t, g), b1 (t + 4, g)
//   C 16x8 (f32):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// Shared-memory operands are laid out so that those reads are free of
// bank conflicts: row-major tiles (rows g, columns t) whose row stride is
// 4 or 8 mod 32 floats: the split A slices (KC + 4), the weight stages
// (TC_WS) and the weight-gradient stages. A kernel's activation arrays,
// the A operands, are padded by TC_PAD per row, so that the epilogues'
// writes (rows g, columns 2t) spread over the banks.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC_PAD = 4;    // extra floats per row of an A operand
constexpr int TC_WS = 264;   // stage row stride: 256 columns + 8

// The training backward's edge products (fused_mp_train.cu::edge_gemm,
// and tc_probe.cu, which runs tc_gemm at them): 32 edge rows (two m16
// tiles) per block, 16 warps, two weight stages of 32 rows.
constexpr int EB_MT = 2, EB_WARPS = 16, EB_KC = 32, EB_STAGES = 2;

// Floats of a product's weight stages: STAGES buffers of KC rows.
template <int KC, int STAGES>
__host__ __device__ constexpr int tc_stage_floats() {
  return STAGES * KC * TC_WS;
}

// Floats of a product's split A slices: two buffers, each the big and the
// small parts of 16 MT rows x KC columns (row stride KC + 4).
template <int MT, int KC>
__host__ __device__ constexpr int tc_split_floats() {
  return 2 * 2 * 16 * MT * (KC + 4);
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  // round half away from zero to 10 mantissa bits in integer arithmetic:
  // cvt.rna.tf32.f32 for finite x, at a fraction of its cost
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float rest = x - __uint_as_float(big);  // exact
  small = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b into a fresh accumulator (C = 0).
__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// An A fragment split into its big and small parts.
struct FragA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, big[0], small[0]);
    split_tf32(a1, big[1], small[1]);
    split_tf32(a2, big[2], small[2]);
    split_tf32(a3, big[3], small[3]);
  }
};

// A B fragment split into its big and small parts.
struct FragB {
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, big[0], small[0]);
    split_tf32(b1, big[1], small[1]);
  }
};

// Plus or minus half a unit in the last place of v (v's sign and
// exponent, times 2^-24); 0 for 0.
__device__ __forceinline__ float half_ulp(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xff800000u) * 0x1p-24f;
}

// One 8-deep step of a 3xTF32 product, its sum rounded to nearest, in
// TC_TERMS parts into d (see the note at the top): term 0 runs the
// big_a big_b products alone into a fresh accumulator, whose sign and
// exponent are the step's; term 1 turns d into half a unit of it and adds
// small_a big_b, term 2 big_a small_b, term 3 big_a big_b. The caller
// then adds d to its float32 sum (add_step).
constexpr int TC_TERMS = 4;
__device__ __forceinline__ void mma_term(float (&d)[4], const FragA& a,
                                         const FragB& b, int term) {
  if (term == 0) {
    mma_tf32_fresh(d, a.big, b.big[0], b.big[1]);
  } else if (term == 1) {
#pragma unroll
    for (int h = 0; h < 4; ++h) d[h] = half_ulp(d[h]);
    mma_tf32(d, a.small, b.big[0], b.big[1]);
  } else if (term == 2) {
    mma_tf32(d, a.big, b.small[0], b.small[1]);
  } else {
    mma_tf32(d, a.big, b.big[0], b.big[1]);
  }
}

// sum += d, rounded to nearest (FADD).
__device__ __forceinline__ void add_step(float (&sum)[4], const float (&d)[4]) {
#pragma unroll
  for (int h = 0; h < 4; ++h) sum[h] += d[h];
}

// Stage rows k0..k0+kc of W[:, c0:c0+nc] into sW [KC][TC_WS]: 16-byte
// cp.async copies where the layout allows, plain loads otherwise; rows
// past kc and columns past nc (up to ncp, nc rounded up to 8) are zero.
// Commits one cp.async group (empty when kc <= 0); the caller waits.
template <int KC>
__device__ __forceinline__ void tc_stage(float* sW, const float* __restrict__ W,
                                         int ldw, int k0, int kc, int c0,
                                         int nc, int ncp) {
  if (kc > 0) {
    const bool vec = (ldw & 3) == 0 && (c0 & 3) == 0 && (nc & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(W) & 15) == 0;
    if (vec) {
      const int q = ncp >> 2;
      for (int i = threadIdx.x; i < KC * q; i += blockDim.x) {
        const int kk = i / q, c = 4 * (i - kk * q);
        float* dst = sW + kk * TC_WS + c;
        if (kk < kc && c < nc)
          __pipeline_memcpy_async(dst, W + (size_t)(k0 + kk) * ldw + c0 + c, 16);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int i = threadIdx.x; i < KC * ncp; i += blockDim.x) {
        const int kk = i / ncp, c = i - kk * ncp;
        sW[kk * TC_WS + c] =
            kk < kc && c < nc ? W[(size_t)(k0 + kk) * ldw + c0 + c] : 0.f;
      }
    }
  }
  __pipeline_commit();
}

// Splits columns k0 .. k0 + KC of the R rows of sA (zero past K) into
// the big and small parts of one split buffer (row stride KC + 4), once
// for all warps.
template <int R, int KC>
__device__ __forceinline__ void tc_split_slice(const float* sA, int lda, int K,
                                               int k0, float* buf) {
  constexpr int LS = KC + 4;
  for (int i = threadIdx.x; i < R * KC; i += blockDim.x) {
    const int r = i / KC, kk = i % KC, k = k0 + kk;
    uint32_t big, small;
    split_tf32(k < K ? sA[r * lda + k] : 0.f, big, small);
    buf[r * LS + kk] = __uint_as_float(big);
    buf[R * LS + r * LS + kk] = __uint_as_float(small);
  }
}

// out[0:16 MT, :N] = sA[0:16 MT, :K] @ W[:K, :N], handed to
// epi(row, col, value) once per element, by a block of WARPS warps. sA is
// row-major with stride lda; W row-major in device memory with stride ldw.
// The warps split each pass of up to 256 columns into 8-column tiles (tile
// w, w + WARPS, ...), each warp all MT row tiles of its columns, so a
// weight fragment serves MT row tiles. A weight element is read by one
// warp only: the stages exist to copy weights asynchronously, STAGES - 1
// of them ahead of the one in use, KC rows each. The A operand is shared
// by all warps, so each KC-column slice of it is split into big and small
// parts once, into sSplit (tc_split_floats), one slice ahead, and the warps
// read their fragments from there without bank conflicts. Each 8-deep
// step's terms (mma_term) go to a fresh accumulator per tile, which is
// then added to the tile's float32 sum (see the note at the top). Ends with a
// barrier, so that the epilogue's shared-memory writes are visible to the
// next product.
template <int MT, int WARPS, int KC, int STAGES, class Epi>
__device__ void tc_gemm(const float* sA, int lda, int K,
                        const float* __restrict__ W, int ldw, int N, float* sW,
                        float* sSplit, Epi epi) {
  constexpr int MAX_TILES = 32 / WARPS;  // per warp and pass of 256 columns
  constexpr int R = 16 * MT, LS = KC + 4;
  static_assert(KC % 8 == 0 && STAGES >= 2, "stages of whole k-steps");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int c0 = 0; c0 < N; c0 += 256) {
    const int nc = min(256, N - c0);
    const int ntiles = (nc + 7) >> 3, ncp = ntiles * 8;
    float acc[MT][MAX_TILES][4], d[MT][MAX_TILES][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < MAX_TILES; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[m][j][h] = 0.f;
    const int steps = (K + KC - 1) / KC;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s)
      tc_stage<KC>(sW + s * KC * TC_WS, W, ldw, s * KC, min(KC, K - s * KC), c0,
                   nc, ncp);
    tc_split_slice<R, KC>(sA, lda, K, 0, sSplit);
    for (int s = 0; s < steps; ++s) {
      const int k0 = s * KC;
      __pipeline_wait_prior(STAGES - 2);
      __syncthreads();
      const int ahead = s + STAGES - 1;
      tc_stage<KC>(sW + (ahead % STAGES) * KC * TC_WS, W, ldw, ahead * KC,
                   min(KC, K - ahead * KC), c0, nc, ncp);
      if (s + 1 < steps)
        tc_split_slice<R, KC>(sA, lda, K, k0 + KC, sSplit + ((s + 1) & 1) * 2 * R * LS);
      const float* cur = sW + (s % STAGES) * KC * TC_WS;
      const float* ab = sSplit + (s & 1) * 2 * R * LS;
      const float* as = ab + R * LS;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 8) {
        if (k0 + kk >= K) break;
        FragA a[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int o = (16 * m + g) * LS + kk + t;
          a[m].big[0] = __float_as_uint(ab[o]);
          a[m].big[1] = __float_as_uint(ab[o + 8 * LS]);
          a[m].big[2] = __float_as_uint(ab[o + 4]);
          a[m].big[3] = __float_as_uint(ab[o + 8 * LS + 4]);
          a[m].small[0] = __float_as_uint(as[o]);
          a[m].small[1] = __float_as_uint(as[o + 8 * LS]);
          a[m].small[2] = __float_as_uint(as[o + 4]);
          a[m].small[3] = __float_as_uint(as[o + 8 * LS + 4]);
        }
        const float* b = cur + (kk + t) * TC_WS + g;
        FragB fb[MAX_TILES];
#pragma unroll
        for (int j = 0; j < MAX_TILES; ++j)
          if (warp + j * WARPS < ntiles)
            fb[j].set(b[(warp + j * WARPS) * 8], b[(warp + j * WARPS) * 8 + 4 * TC_WS]);
        // the step's terms in turn over all tiles, so that products into
        // one accumulator are several issues apart; then the step's
        // products into the sums
#pragma unroll
        for (int term = 0; term < TC_TERMS; ++term)
#pragma unroll
          for (int j = 0; j < MAX_TILES; ++j)
            if (warp + j * WARPS < ntiles)
#pragma unroll
              for (int m = 0; m < MT; ++m) mma_term(d[m][j], a[m], fb[j], term);
#pragma unroll
        for (int j = 0; j < MAX_TILES; ++j)
          if (warp + j * WARPS < ntiles)
#pragma unroll
            for (int m = 0; m < MT; ++m) add_step(acc[m][j], d[m][j]);
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();  // every read of the stages is done before they refill
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < MAX_TILES; ++j) {
        const int nt = warp + j * WARPS;
        if (nt >= ntiles) continue;
        const int c = nt * 8 + 2 * t, r = 16 * m + g;
        if (c < nc) {
          epi(r, c0 + c, acc[m][j][0]);
          epi(r + 8, c0 + c, acc[m][j][2]);
        }
        if (c + 1 < nc) {
          epi(r, c0 + c + 1, acc[m][j][1]);
          epi(r + 8, c0 + c + 1, acc[m][j][3]);
        }
      }
  }
  __syncthreads();
}

}  // namespace
