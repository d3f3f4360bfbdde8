// Tensor-core products at float32 accuracy (3xTF32) over a stream of
// weight slices, for the forward kernels of fused_mp.cu: wgmma for the
// edge kernel's 64-row tiles, mma.sync for the node kernels' 16-row tiles.
//
// 3xTF32 and its sums as in tc_gemm.cuh: each operand is split into a TF32
// big and small part; each 8-deep step runs its big*big products alone
// into a fresh accumulator, turns it into half a unit of their sum and adds
// small_a*big_b, big_a*small_b and big_a*big_b onto it, so that the tensor
// cores' cut toward zero rounds the step's sum to nearest; the step is then
// added to a float32 register sum. wgmma.m64n16k8 rounds as mma.sync does
// (scripts/probe_tc_rounding.py on an H100: addends aligned to the largest
// with 2 extra bits, both cuts toward zero). No accumulator runs over K
// (one cut toward zero of the running sum per step put the kernels 12-46x
// further from float64 than float32). A single TF32 pass is never used. A block
// splits only its activations (as it reads its A fragments: wgmma takes A
// from registers; mma.sync from a split slice in shared memory); the
// weights arrive split.
//
// Core-matrix layout (both operands, in shared memory and in the stream):
// a slice of R rows x KC (K-direction) columns is stored as [R / 8][KC / 4]
// "core matrices" of 8 rows x 4 floats (128 contiguous bytes), row-group
// major. That is the no-swizzle K-major layout of a wgmma shared-memory
// operand (descriptor K-direction stride LBO = 128 bytes, row-group stride
// SBO = KC / 4 * 128 bytes; tf32 wgmma wants B K-major, so the weights are
// stored transposed, [out, in]); and an mma.sync warp reads its fragments
// from it with no bank conflict (lane 4 g + t reads float 4 g + t of a
// core matrix).
//
// The weight stream: the wrapper (ops/fused_mp.py::tc_weights) lays every
// product's weights out in device memory as the slices a block consumes:
// per product, per pass of up to 256 output columns (2 wg_cols(P) rows of
// W^T, zero past the matrix), per K slice, the big parts of the slice in
// the core-matrix layout, then its small parts. So a slice is one
// contiguous chunk, and one thread copies it into a ring of STAGES
// shared-memory slots with one bulk asynchronous copy (cp.async.bulk, the
// TMA unit) that completes on the slot's mbarrier: no thread computes a
// weight address. A block lists the slices it will consume (their offsets
// in the stream, in order) once, and the ring runs on across passes and
// products, STAGES - 1 slices ahead of the products.
//
// Per K slice: the threads wait on the slot's mbarrier; one barrier; the
// products of the slice run (wgmma: each thread reads and splits its A
// fragments, each warpgroup issues its half of the columns, two waits per
// 8-deep step (the big*big products alone, then the step's terms), thread
// 0 issuing the copy STAGES - 1 slices ahead, into the slot the previous
// slice used, after the first; mma.sync: each warp takes its 8-column
// tiles, then the copy is issued and the next activation slice split).
// The order of every sum is fixed: a second run is bit-identical.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_gemm.cuh"

namespace {

// The edge kernel's weight slices (fused_mp.cu, and tc_probe.cu, which runs
// wg_gemm at them): 16 deep, three in its ring (ops/fused_mp.py's _EDGE_KC
// and stages on the host).
constexpr int EDGE_KC = 16, EDGE_STAGES = 3;

// Shared-memory descriptor of a no-swizzle K-major operand at p.
__device__ __forceinline__ uint64_t wg_desc(const float* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator accesses across a wait.
template <int N>
__device__ __forceinline__ void wg_pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x NW] = A[64 x 8] B[8 x NW] + (scale_d ? d : 0): wgmma.m64nNWk8,
// tf32 in, f32 accumulate, A from registers, B from shared memory
// (descriptor db). Lane
// (g, t) of warp q of the warpgroup holds A's rows 16 q + g (a[0], a[2])
// and 16 q + g + 8 (a[1], a[3]) at columns t (a[0], a[1]) and t + 4, and
// D's rows 16 q + g (d[4 i], d[4 i + 1]) and 16 q + g + 8 (d[4 i + 2],
// d[4 i + 3]) of columns 8 i + 2 t, + 1.
template <int NW>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NW / 2], const uint32_t (&a)[4],
                                           uint64_t db, int scale_d);

// ---- mbarriers and bulk copies ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Waits until the phase of the given parity of bar has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// One thread: bytes from src (device memory) to dst (shared memory), both
// 16-byte aligned, a multiple of 16 bytes; completes bar's current phase
// (its one arrival is this thread's, with the bytes as the transaction).
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- the weight stream -------------------------------------------------

// Columns of a warpgroup for a pass of P output columns (P <= 256): half of
// P rounded up to a multiple of 16; a pass's slices hold 2 wg_cols(P) rows.
__host__ __device__ constexpr int wg_cols(int P) { return (P + 31) / 32 * 16; }

// Floats of one slice (big and small parts) of a pass of P columns.
template <int KC>
__host__ __device__ constexpr int slice_floats(int P) { return 2 * 2 * wg_cols(P) * KC; }

// Floats of a product's stream (K inputs, N outputs), and the offset in it
// of the pass at column c0 (every earlier pass is 256 columns wide).
template <int KC>
__host__ __device__ inline int product_floats(int K, int N) {
  int f = 0;
  for (int c0 = 0; c0 < N; c0 += 256)
    f += (K + KC - 1) / KC * slice_floats<KC>(N - c0 < 256 ? N - c0 : 256);
  return f;
}
template <int KC>
__host__ __device__ inline int pass_offset(int K, int c0) {
  return c0 / 256 * ((K + KC - 1) / KC) * slice_floats<KC>(256);
}

// Appends the (offset, floats) of the K slices of one pass of P columns,
// starting at stream offset base, to out (when not null); counts them in n.
template <int KC>
__host__ __device__ inline void pass_slices(int K, int P, int base, int2* out, int& n) {
  const int len = slice_floats<KC>(P);
  for (int k0 = 0; k0 < K; k0 += KC, base += len) {
    if (out) out[n] = make_int2(base, len);
    ++n;
  }
}

// Appends every pass of a product at stream offset pos; returns the offset
// after it.
template <int KC>
__host__ __device__ inline int product_slices(int K, int N, int pos, int2* out, int& n) {
  for (int c0 = 0; c0 < N; c0 += 256)
    pass_slices<KC>(K, N - c0 < 256 ? N - c0 : 256, pos + pass_offset<KC>(K, c0), out, n);
  return pos + product_floats<KC>(K, N);
}

// The ring of weight slices: STAGES slots of up to 2 x 256 x KC floats, an
// mbarrier each, and the slices the block consumes, in order. Slice c goes
// to slot c % STAGES and completes phase c / STAGES of its mbarrier.
template <int KC, int STAGES>
struct SliceRing {
  static constexpr int SLOT = 2 * 256 * KC;
  float* slots;
  uint64_t* bars;
  const int2* slices;
  const float* stream;
  int n;     // slices listed
  int next;  // the next slice the products consume

  // Thread 0, once the slice table is written and before any wait.
  __device__ __forceinline__ void init() const {
    for (int i = 0; i < STAGES; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
  }
  // Thread 0: copy slice c into its slot (nothing past the last slice).
  __device__ __forceinline__ void issue(int c) const {
    if (c < n)
      bulk_copy(slots + (c % STAGES) * SLOT, stream + slices[c].x, 4u * slices[c].y,
                bars + c % STAGES);
  }
  // Thread 0, after the barrier that follows init: the first STAGES - 1.
  __device__ __forceinline__ void prime() const {
    for (int c = 0; c < STAGES - 1; ++c) issue(c);
  }
  // Every thread: wait for the next slice; returns its index. The caller
  // then passes a barrier and thread 0 calls issue(c + STAGES - 1).
  __device__ __forceinline__ int wait_next() {
    const int c = next++;
    mbar_wait(bars + c % STAGES, (c / STAGES) & 1);
    return c;
  }
  __device__ __forceinline__ const float* slot(int c) const {
    return slots + (c % STAGES) * SLOT;
  }
};

template <int KC, int STAGES>
__host__ __device__ constexpr int ring_floats() {
  return STAGES * SliceRing<KC, STAGES>::SLOT;
}

// Activation slice s of rows [0, R) of sA (row stride lda): columns s KC ..
// s KC + KC (zero past K), split into big and small parts, to dst in the
// core-matrix layout (the small parts R KC floats after the big ones).
template <int R, int KC>
__device__ __forceinline__ void split_slice(const float* sA, int lda, int K, int s,
                                            float* dst) {
  constexpr int KG = KC / 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < R * KG; i += blockDim.x) {
    const int r = i / KG, kg = i - r * KG, k = s * KC + 4 * kg;
    const float4 v = k < K ? *reinterpret_cast<const float4*>(sA + r * lda + k) : zero;
    uint32_t b[4], sm[4];
    split_tf32(v.x, b[0], sm[0]);
    split_tf32(v.y, b[1], sm[1]);
    split_tf32(v.z, b[2], sm[2]);
    split_tf32(v.w, b[3], sm[3]);
    float* d = dst + ((r >> 3) * KG + kg) * 32 + (r & 7) * 4;
    *reinterpret_cast<uint4*>(d) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(d + R * KC) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
  }
}

// The epilogue of both: out[r, c] = act(v + bias[c]) for rows r < nrows
// (act: ReLU when relu; no bias when null), two adjacent columns at a time.
__device__ __forceinline__ void store_pair(float* out, int ldo, int r, int c, int nrows,
                                           const float* __restrict__ bias, bool relu,
                                           float v0, float v1) {
  if (r >= nrows) return;
  if (bias) {
    const float2 b = *reinterpret_cast<const float2*>(bias + c);
    v0 += b.x;
    v1 += b.y;
  }
  if (relu) {
    v0 = fmaxf(v0, 0.f);
    v1 = fmaxf(v1, 0.f);
  }
  *reinterpret_cast<float2*>(out + (size_t)r * ldo + c) = make_float2(v0, v1);
}

// Floats of the two split activation slices of R rows.
template <int R, int KC>
__host__ __device__ constexpr int split_floats() {
  return 2 * 2 * R * KC;
}

// ---- 64 rows: wgmma ------------------------------------------------------

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_tf32<48>(float (&d)[24], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_tf32<80>(float (&d)[40], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_tf32<96>(float (&d)[48], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_tf32<112>(float (&d)[56], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
}

// One pass of wg_gemm over the columns [c0, c0 + P) (P <= 256): warpgroup w
// takes columns c0 + w NW .. c0 + w NW + NW, NW = wg_cols(P). Each thread
// reads its A fragments of the slice from sA and splits them into
// registers (both warpgroups read all 64 rows), so only the weights are
// read from shared memory by the tensor cores.
template <int NW, int KC, int STAGES>
__device__ __forceinline__ void wg_pass(const float* sA, int lda, int K, int c0, int P,
                                        SliceRing<KC, STAGES>& ring, float* out, int ldo,
                                        const float* __restrict__ bias, bool relu) {
  constexpr int KG = KC / 4;
  constexpr int SH = 2 * NW * KC;  // floats of one part of a weight slice
  constexpr uint32_t LBO = 128, SBO = KG * 128;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + g;  // this thread's rows r, r + 8
  const float* a_row = sA + r * lda + t;
  float acc[NW / 2], d[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = d[i] = 0.f;
  const int steps = (K + KC - 1) / KC;
  for (int s = 0; s < steps; ++s) {
    const int c = ring.wait_next();
    __syncthreads();  // slice s is in place; every product of slice s - 1 is done
    const float* wb = ring.slot(c) + wg * (NW / 8) * KG * 32;
    uint32_t a_big[KC / 8][4], a_small[KC / 8][4];
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      const int k = s * KC + 8 * kk;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int kh = k + (h >> 1) * 4;  // a0, a1 at column t; a2, a3 at t + 4
        const float v = kh + t < K ? a_row[(h & 1) * 8 * lda + kh] : 0.f;
        split_tf32(v, a_big[kk][h], a_small[kk][h]);
      }
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      const uint64_t b_big = wg_desc(wb + 64 * kk, LBO, SBO);
      const uint64_t b_small = wg_desc(wb + SH + 64 * kk, LBO, SBO);
      // each 8-deep step as mma_term (tc_gemm.cuh) runs it: the big*big
      // products alone into a fresh accumulator (scale-d 0), d = half a
      // unit of their sum, the three terms onto d, d into the sums
      wgmma_tf32<NW>(d, a_big[kk], b_big, 0);
      wg_commit();
      if (kk == 0 && threadIdx.x == 0) ring.issue(c + STAGES - 1);  // into slice c - 1's slot
      wg_wait_all();
      wg_pin(d);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) d[i] = half_ulp(d[i]);
      wg_fence();
      wgmma_tf32<NW>(d, a_small[kk], b_big, 1);
      wgmma_tf32<NW>(d, a_big[kk], b_small, 1);
      wgmma_tf32<NW>(d, a_big[kk], b_big, 1);
      wg_commit();
      wg_wait_all();
      wg_pin(d);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] += d[i];
      if (kk + 1 < KC / 8) wg_fence();
    }
  }
  __syncthreads();  // the warpgroups leave the pass together (measured faster)
#pragma unroll
  for (int i = 0; i < NW / 8; ++i) {
    const int col = wg * NW + 8 * i + 2 * t;
    if (col >= P) continue;
    store_pair(out, ldo, r, c0 + col, 64, bias, relu, acc[4 * i], acc[4 * i + 1]);
    store_pair(out, ldo, r + 8, c0 + col, 64, bias, relu, acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// out[0:64, :N] = act(sA[0:64, :K] @ W[:K, :N] + bias) (act: ReLU when
// relu), by a block of two warpgroups (256 threads), with W's slices taken
// from the ring in stream order. sA and out are row-major in shared memory
// with strides lda and ldo (multiples of 4, 16-byte aligned rows); K and N
// are multiples of 4. Ends with a barrier, so that the epilogue's writes
// are visible to the next product.
template <int KC, int STAGES>
__device__ void wg_gemm(const float* sA, int lda, int K, int N, SliceRing<KC, STAGES>& ring,
                        float* out, int ldo, const float* __restrict__ bias, bool relu) {
  for (int c0 = 0; c0 < N; c0 += 256) {
    const int P = min(256, N - c0);
    switch (wg_cols(P)) {
      case 16: wg_pass<16, KC, STAGES>(sA, lda, K, c0, P, ring, out, ldo, bias, relu);
        break;
      case 32: wg_pass<32, KC, STAGES>(sA, lda, K, c0, P, ring, out, ldo, bias, relu);
        break;
      case 48: wg_pass<48, KC, STAGES>(sA, lda, K, c0, P, ring, out, ldo, bias, relu);
        break;
      case 64: wg_pass<64, KC, STAGES>(sA, lda, K, c0, P, ring, out, ldo, bias, relu);
        break;
      case 80: wg_pass<80, KC, STAGES>(sA, lda, K, c0, P, ring, out, ldo, bias, relu);
        break;
      case 96: wg_pass<96, KC, STAGES>(sA, lda, K, c0, P, ring, out, ldo, bias, relu);
        break;
      case 112: wg_pass<112, KC, STAGES>(sA, lda, K, c0, P, ring, out, ldo, bias, relu);
        break;
      default: wg_pass<128, KC, STAGES>(sA, lda, K, c0, P, ring, out, ldo, bias, relu);
        break;
    }
  }
  __syncthreads();
}

// ---- 16 rows: mma.sync ---------------------------------------------------

// One pass of P <= 256 columns of a 16-row product: out[0:16, c0:c0 + P] =
// act(sA[0:16, :K] @ W[:K, c0:c0 + P] + bias), rows past nrows not
// written. The block's 8 warps take the pass's 8-column tiles in turn
// (tile w, w + 8, ...); each warp reads its fragments from the ring slot
// and the split slice, runs each 8-deep step's terms (mma_term) into a
// fresh accumulator per tile and adds it to the tile's float32 sum. Ends
// with a barrier.
template <int KC, int STAGES>
__device__ void mma_pass(const float* sA, int lda, int K, int c0, int P,
                         SliceRing<KC, STAGES>& ring, float* sSplit, float* out, int ldo,
                         const float* __restrict__ bias, bool relu, int nrows) {
  constexpr int KG = KC / 4, AH = 16 * KC, PER = 4;  // up to 32 tiles over 8 warps
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tiles = 2 * wg_cols(P) / 8, SH = 2 * wg_cols(P) * KC;
  float acc[PER][4], d[PER][4];
#pragma unroll
  for (int j = 0; j < PER; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) acc[j][h] = 0.f;
  const int steps = (K + KC - 1) / KC;
  split_slice<16, KC>(sA, lda, K, 0, sSplit);
  for (int s = 0; s < steps; ++s) {
    const int c = ring.wait_next();
    __syncthreads();  // slice s is in place; every read of slice s - 1 is done
    const float* wb = ring.slot(c);
    const float* ab = sSplit + (s & 1) * 2 * AH;
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      const int o = 2 * kk * 32 + 4 * g + t;  // core (row group 0, k group 2 kk)
      FragA a;
      a.big[0] = __float_as_uint(ab[o]);
      a.big[1] = __float_as_uint(ab[o + KG * 32]);
      a.big[2] = __float_as_uint(ab[o + 32]);
      a.big[3] = __float_as_uint(ab[o + KG * 32 + 32]);
      a.small[0] = __float_as_uint(ab[AH + o]);
      a.small[1] = __float_as_uint(ab[AH + o + KG * 32]);
      a.small[2] = __float_as_uint(ab[AH + o + 32]);
      a.small[3] = __float_as_uint(ab[AH + o + KG * 32 + 32]);
      FragB fb[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int tile = warp + 8 * j;
        if (tile >= tiles) continue;
        const float* b = wb + tile * KG * 32 + o;
        fb[j].big[0] = __float_as_uint(b[0]);
        fb[j].big[1] = __float_as_uint(b[32]);
        fb[j].small[0] = __float_as_uint(b[SH]);
        fb[j].small[1] = __float_as_uint(b[SH + 32]);
      }
#pragma unroll
      for (int term = 0; term < TC_TERMS; ++term)
#pragma unroll
        for (int j = 0; j < PER; ++j)
          if (warp + 8 * j < tiles) mma_term(d[j], a, fb[j], term);
#pragma unroll
      for (int j = 0; j < PER; ++j)
        if (warp + 8 * j < tiles) add_step(acc[j], d[j]);
    }
    if (threadIdx.x == 0) ring.issue(c + STAGES - 1);  // into the slot of slice c - 1
    if (s + 1 < steps) split_slice<16, KC>(sA, lda, K, s + 1, sSplit + ((s + 1) & 1) * 2 * AH);
  }
  __syncthreads();  // every read of the slots and the split slices is done
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int col = (warp + 8 * j) * 8 + 2 * t;
    if (warp + 8 * j >= tiles || col >= P) continue;
    store_pair(out, ldo, g, c0 + col, nrows, bias, relu, acc[j][0], acc[j][1]);
    store_pair(out, ldo, g + 8, c0 + col, nrows, bias, relu, acc[j][2], acc[j][3]);
  }
  __syncthreads();
}

// A 16-row product over every pass of N columns (see mma_pass).
template <int KC, int STAGES>
__device__ void mma_gemm(const float* sA, int lda, int K, int N, SliceRing<KC, STAGES>& ring,
                         float* sSplit, float* out, int ldo, const float* __restrict__ bias,
                         bool relu, int nrows) {
  for (int c0 = 0; c0 < N; c0 += 256)
    mma_pass(sA, lda, K, c0, min(256, N - c0), ring, sSplit, out, ldo, bias, relu, nrows);
}

}  // namespace
