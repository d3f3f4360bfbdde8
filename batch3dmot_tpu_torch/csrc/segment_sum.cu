// Masked segment sum for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B8 of batch3dmot_tpu/ops/pallas_segment.py,
// _make_kernel (reached through segment_sum_pallas), which computes
//   out[b, n, :] = sum of data[b, e, :] over the valid edges e of window b
//                  with ids[b, e] == n
// for data [B, E, D] f32, ids [B, E], mask [B, E] -> out [B, N, D] f32. A
// masked edge adds exactly zero whatever its id (the kNN graph's masked
// edges carry id 0), and an empty segment is 0.
//
// What bounds it: bytes. Each valid edge row is read once and added once
// (D FLOPs for 4 D bytes), far below the card's operations-per-byte line;
// the least time is ids + mask + the valid rows of data + out over the
// memory rate. The design:
//   * The TPU kernel multiplies one-hot [128, 512] tiles on the MXU, N
//     times the work of the sum; here there is no one-hot matrix. The
//     caller lists each window's valid edges per segment in edge order (a
//     CSR by stable sort of the ids: off [B * (N + 1) + 1] and perm, the
//     global edge ids b * E + e; masked edges sit in a sentinel row N of
//     each window that no output reads).
//   * One thread owns one (segment, 4-column group) of the output, or one
//     (segment, column) when D is not a multiple of 4, and adds its
//     segment's rows in CSR order. Neighbouring threads take neighbouring
//     column groups of one row, so at D = 128 a warp reads one 512-byte
//     row per edge; at D = 1 (a softmax denominator) a warp walks 32
//     segments.
//   * No float atomics and a fixed order: a second run gives bit-identical
//     output, and each sum is taken in the order of a serial index_add_.
//   * Every output element is written (empty segments get 0), so the
//     output needs no zero fill before the launch.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// One thread per output element: row = b * N + n, column c.
__global__ void __launch_bounds__(THREADS)
segment_sum_scalar(const float* __restrict__ data, const int* __restrict__ off,
                   const int* __restrict__ perm, float* __restrict__ out,
                   long long rows, int n, int d) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * d) return;
  const long long row = t / d;
  const int c = (int)(t - row * d);
  const long long k = row + row / n;  // CSR row b * (N + 1) + n
  float s = 0.f;
  const int q1 = off[k + 1];
#pragma unroll 4
  for (int q = off[k]; q < q1; ++q) s += data[(size_t)perm[q] * d + c];
  out[t] = s;
}

// One thread per 4-column group of an output row (D a multiple of 4).
__global__ void __launch_bounds__(THREADS)
segment_sum_vec4(const float4* __restrict__ data, const int* __restrict__ off,
                 const int* __restrict__ perm, float4* __restrict__ out,
                 long long rows, int n, int d4) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * d4) return;
  const long long row = t / d4;
  const int c = (int)(t - row * d4);
  const long long k = row + row / n;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  const int q1 = off[k + 1];
#pragma unroll 4
  for (int q = off[k]; q < q1; ++q) {
    const float4 v = data[(size_t)perm[q] * d4 + c];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  out[t] = s;
}

}  // namespace

// dims: [B, N, D, vec4]; data [B, E, D], off [B * (N + 1) + 1], perm [B * E]
// (the valid edges' global ids first, per CSR row), out [B, N, D]. vec4
// needs D % 4 == 0 and 16-byte aligned data and out. Returns the launch's
// CUDA error (0 on success); nothing is synchronised.
extern "C" int segment_sum_forward(const int* dims, const float* data,
                                   const int* off, const int* perm, float* out,
                                   void* stream_ptr) {
  const long long rows = (long long)dims[0] * dims[1];
  const int n = dims[1], d = dims[2], vec4 = dims[3];
  if (n <= 0 || d <= 0 || (vec4 && d % 4)) return cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const long long work = rows * (vec4 ? d / 4 : d);
  if (work == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((work + THREADS - 1) / THREADS);
  if (vec4)
    segment_sum_vec4<<<blocks, THREADS, 0, stream>>>(
        reinterpret_cast<const float4*>(data), off, perm,
        reinterpret_cast<float4*>(out), rows, n, d / 4);
  else
    segment_sum_scalar<<<blocks, THREADS, 0, stream>>>(data, off, perm, out,
                                                       rows, n, d);
  return cudaGetLastError();
}
