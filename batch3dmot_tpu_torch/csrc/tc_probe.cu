// Probes of the tensor cores' float32 arithmetic, for
// scripts/probe_tc_rounding.py (and chip_smoke.py, which runs it). Not a
// port of a TPU kernel and not on any path of the package: it reads how
// the card sums what the kernels' products hand it, and runs one product
// through each of the kernels' two product routines.
//   tc_probe_mma:   one mma.sync.m16n8k8 (tf32 in, f32 accumulate) per
//                   warp: D = A B + C on crafted A [16 x 8], B [8 x 8],
//                   C [16 x 8] (row-major);
//   tc_probe_wgmma: one wgmma.m64n16k8 (tf32 in, f32 accumulate, A from
//                   registers, B from shared memory) per warpgroup:
//                   D = A B + C on A [64 x 8], B [8 x 16], C [64 x 16];
//   tc_probe_gemm:  out [R, N] = A [R, K] W [K, N] through tc_gemm.cuh::
//                   tc_gemm at the training backward's edge configuration
//                   (32 rows and 16 warps a block), W as it is in memory;
//   tc_probe_wg:    the same through tc_stream.cuh::wg_gemm (the edge
//                   kernel's wgmma products, 64 rows a block), W as a
//                   weight stream of ops/fused_mp.py::stream_slices.
// Each entry returns the CUDA error of its launch.

#include "tc_gemm.cuh"
#include "tc_stream.cuh"

namespace {

__global__ void probe_mma_kernel(const float* __restrict__ A, const float* __restrict__ B,
                                 const float* __restrict__ C, float* __restrict__ D, int P) {
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= P) return;  // whole warps
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a = A + p * 128;
  const float* b = B + p * 64;
  const float* c = C + p * 128;
  const uint32_t af[4] = {__float_as_uint(a[g * 8 + t]), __float_as_uint(a[(g + 8) * 8 + t]),
                          __float_as_uint(a[g * 8 + t + 4]),
                          __float_as_uint(a[(g + 8) * 8 + t + 4])};
  float d[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1], c[(g + 8) * 8 + 2 * t],
                c[(g + 8) * 8 + 2 * t + 1]};
  mma_tf32(d, af, __float_as_uint(b[t * 8 + g]), __float_as_uint(b[(t + 4) * 8 + g]));
  float* o = D + p * 128;
  o[g * 8 + 2 * t] = d[0];
  o[g * 8 + 2 * t + 1] = d[1];
  o[(g + 8) * 8 + 2 * t] = d[2];
  o[(g + 8) * 8 + 2 * t + 1] = d[3];
}

__global__ void __launch_bounds__(128)
probe_wgmma_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ C, float* __restrict__ D) {
  __shared__ __align__(128) float sB[128];
  const int p = blockIdx.x;
  const float* a = A + p * 512;
  const float* b = B + p * 128;
  const float* c = C + p * 1024;
  {
    // B^T [16][8] in the no-swizzle K-major core-matrix layout
    const int n = threadIdx.x >> 3, k = threadIdx.x & 7;
    sB[((n >> 3) * 2 + (k >> 2)) * 32 + (n & 7) * 4 + (k & 3)] = b[k * 16 + n];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int q = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = 16 * q + g;
  const uint32_t af[4] = {__float_as_uint(a[r * 8 + t]), __float_as_uint(a[(r + 8) * 8 + t]),
                          __float_as_uint(a[r * 8 + t + 4]),
                          __float_as_uint(a[(r + 8) * 8 + t + 4])};
  float d[8];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    d[4 * i] = c[r * 16 + 8 * i + 2 * t];
    d[4 * i + 1] = c[r * 16 + 8 * i + 2 * t + 1];
    d[4 * i + 2] = c[(r + 8) * 16 + 8 * i + 2 * t];
    d[4 * i + 3] = c[(r + 8) * 16 + 8 * i + 2 * t + 1];
  }
  wg_fence();
  wgmma_tf32<16>(d, af, wg_desc(sB, 128, 256), 1);
  wg_commit();
  wg_wait_all();
  wg_pin(d);
  float* o = D + p * 1024;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    o[r * 16 + 8 * i + 2 * t] = d[4 * i];
    o[r * 16 + 8 * i + 2 * t + 1] = d[4 * i + 1];
    o[(r + 8) * 16 + 8 * i + 2 * t] = d[4 * i + 2];
    o[(r + 8) * 16 + 8 * i + 2 * t + 1] = d[4 * i + 3];
  }
}

// tc_gemm at the training backward's edge configuration (tc_gemm.cuh's EB_*)
constexpr int PG_ROWS = 16 * EB_MT;

__global__ void __launch_bounds__(32 * EB_WARPS)
probe_gemm_kernel(const float* __restrict__ A, const float* __restrict__ W,
                  float* __restrict__ out, int R, int K, int N) {
  extern __shared__ __align__(16) float smem[];
  const int lda = K + TC_PAD;
  float* sA = smem;
  float* sW = sA + PG_ROWS * lda;
  float* sSplit = sW + tc_stage_floats<EB_KC, EB_STAGES>();
  const int r0 = blockIdx.x * PG_ROWS;
  for (int i = threadIdx.x; i < PG_ROWS * K; i += blockDim.x) {
    const int r = i / K, k = i - r * K;
    sA[r * lda + k] = r0 + r < R ? A[(size_t)(r0 + r) * K + k] : 0.f;
  }
  __syncthreads();
  tc_gemm<EB_MT, EB_WARPS, EB_KC, EB_STAGES>(
      sA, lda, K, W, N, N, sW, sSplit, [&](int r, int c, float v) {
        if (r0 + r < R) out[(size_t)(r0 + r) * N + c] = v;
      });
}

// wg_gemm at the edge kernel's slices and ring (tc_stream.cuh's EDGE_*)
constexpr int PW_MAX_SLICES = 128;
using ProbeRing = SliceRing<EDGE_KC, EDGE_STAGES>;

__host__ __device__ inline int probe_wg_floats(int K, int N) {
  return 16 + ring_floats<EDGE_KC, EDGE_STAGES>() + 64 * (K + 4) + 64 * (N + 4) +
         2 * PW_MAX_SLICES;
}

__global__ void __launch_bounds__(256, 1)
probe_wg_kernel(const float* __restrict__ A, const float* __restrict__ stream,
                float* __restrict__ out, int R, int K, int N) {
  extern __shared__ __align__(16) float smem[];
  const int lda = K + 4, ldo = N + 4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* sRing = smem + 16;
  float* sA = sRing + ring_floats<EDGE_KC, EDGE_STAGES>();
  float* sOut = sA + 64 * lda;
  int2* sSlices = reinterpret_cast<int2*>(sOut + 64 * ldo);
  int n = 0;
  product_slices<EDGE_KC>(K, N, 0, nullptr, n);
  ProbeRing ring{sRing, bars, sSlices, stream, n, 0};
  if (threadIdx.x == 0) {
    int m = 0;
    product_slices<EDGE_KC>(K, N, 0, sSlices, m);
    ring.init();
  }
  const int r0 = blockIdx.x * 64;
  for (int i = threadIdx.x; i < 64 * K; i += blockDim.x) {
    const int r = i / K, k = i - r * K;
    sA[r * lda + k] = r0 + r < R ? A[(size_t)(r0 + r) * K + k] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) ring.prime();
  wg_gemm(sA, lda, K, N, ring, sOut, ldo, nullptr, false);
  for (int i = threadIdx.x; i < 64 * N; i += blockDim.x) {
    const int r = i / N, c = i - r * N;
    if (r0 + r < R) out[(size_t)(r0 + r) * N + c] = sOut[r * ldo + c];
  }
}

}  // namespace

// dims: {P}; A, B, C, D as above.
extern "C" int tc_probe_mma(const int* dims, const float* A, const float* B, const float* C,
                            float* D, void* stream) {
  const int P = dims[0];
  probe_mma_kernel<<<(P + 3) / 4, 128, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      A, B, C, D, P);
  return cudaGetLastError();
}

// dims: {P}.
extern "C" int tc_probe_wgmma(const int* dims, const float* A, const float* B,
                              const float* C, float* D, void* stream) {
  probe_wgmma_kernel<<<dims[0], 128, 0, reinterpret_cast<cudaStream_t>(stream)>>>(A, B, C,
                                                                                 D);
  return cudaGetLastError();
}

// dims: {R, K, N}: K a multiple of 4, N of 8.
extern "C" int tc_probe_gemm(const int* dims, const float* A, const float* W, float* out,
                             void* stream) {
  const int R = dims[0], K = dims[1], N = dims[2];
  const int bytes = 4 * (PG_ROWS * (K + TC_PAD) + tc_stage_floats<EB_KC, EB_STAGES>() +
                         tc_split_floats<EB_MT, EB_KC>());
  cudaError_t err = cudaFuncSetAttribute(
      probe_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  probe_gemm_kernel<<<(R + PG_ROWS - 1) / PG_ROWS, 32 * EB_WARPS, bytes,
                      reinterpret_cast<cudaStream_t>(stream)>>>(A, W, out, R, K, N);
  return cudaGetLastError();
}

// dims: {R, K, N}: K and N multiples of 4, N <= 256, at most
// PW_MAX_SLICES slices; stream: W's slices (big, then small parts).
extern "C" int tc_probe_wg(const int* dims, const float* A, const float* stream_w,
                           float* out, void* stream) {
  const int R = dims[0], K = dims[1], N = dims[2];
  int n = 0;
  product_slices<EDGE_KC>(K, N, 0, nullptr, n);
  if (N > 256 || K % 4 || N % 4 || n > PW_MAX_SLICES) return cudaErrorInvalidValue;
  const int bytes = 4 * probe_wg_floats(K, N);
  cudaError_t err = cudaFuncSetAttribute(
      probe_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  probe_wg_kernel<<<(R + 63) / 64, 256, bytes, reinterpret_cast<cudaStream_t>(stream)>>>(
      A, stream_w, out, R, K, N);
  return cudaGetLastError();
}
