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
//     times the work of the sum; here there is no one-hot matrix and no
//     CSR in device memory: one launch per call, nothing sorted outside.
//   * A block owns a tile of T nodes of one window (grid: node tiles x
//     windows). It streams the window's ids and mask in chunks of CH edges
//     and, per chunk, lists its own edges per node in edge order in shared
//     memory: a stable counting sort. Each warp takes a contiguous slice of
//     the chunk in rounds of 32 edges; __match_any_sync groups the lanes of
//     a round by node, the lowest lane of a group adds the group's size to
//     the warp's count for that node, and a lane's rank in its group is the
//     popcount of the group's lower lanes. One warp scans the counts (nodes
//     in order, warps in order within a node), and a second walk places
//     each edge at its node's base + rank. The local node of each edge is
//     kept in shared memory between the walks, so ids and mask are read
//     from device memory once per block.
//   * Then one thread owns one (node, 4-column group) of the tile, or one
//     (node, column) when D is not a multiple of 4, and adds its node's
//     listed rows in order into an accumulator in shared memory that only
//     it touches, chunk after chunk. At D = 128 a warp reads one 512-byte
//     row per edge; at D = 1 (a softmax denominator) a warp walks 32 nodes.
//   * No float atomics and a fixed order: every sum starts at 0 and adds
//     its segment's rows in edge order, the order of a serial index_add_;
//     a second run gives bit-identical output. Every output element of
//     the tile is written (empty segments get 0), so the output needs no
//     zero fill. An id outside [0, N) on a valid edge reaches no segment.
//   * The host picks T (at most 32, so that one warp scans a tile's counts)
//     and CH (ops/segment_kernel.py::segment_plan): small tiles fill the
//     card at (256, 4096) x8; CH bounds shared memory whatever E is (a
//     block walks a longer window chunk by chunk), so nothing caps E:
//     the device pipeline's windows reach (2560, 102400).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Shared {
  float* acc;         // [T * D] accumulators (float4 [T * D / 4] when vec4)
  int* list;          // [CH] window edge ids, grouped by node, edge order
  int* cnt;           // [WARPS * T] per-warp counts, then per-warp bases
  int* start;         // [T + 1] first list slot of each node
  signed char* loc;   // [CH] local node of each chunk edge (-1: not ours)
};

__device__ __forceinline__ Shared carve(unsigned char* smem, int T, int D,
                                        int CH) {
  Shared s;
  s.acc = reinterpret_cast<float*>(smem);
  s.list = reinterpret_cast<int*>(s.acc + (size_t)T * D);
  s.cnt = s.list + CH;
  s.start = s.cnt + WARPS * T;
  s.loc = reinterpret_cast<signed char*>(s.start + T + 1);
  return s;
}

// Adds node r's listed rows of this chunk to the accumulator of column
// group c (float4 when V4), in list order.
template <bool V4>
__device__ __forceinline__ void add_rows(const float* __restrict__ data,
                                         const Shared& s, size_t row0, int G,
                                         int p, int r, int c) {
  const int q0 = s.start[r], q1 = s.start[r + 1];
  if (V4) {
    const float4* d4 = reinterpret_cast<const float4*>(data);
    float4 a = reinterpret_cast<float4*>(s.acc)[p];
#pragma unroll 4
    for (int q = q0; q < q1; ++q) {
      const float4 v = d4[(row0 + s.list[q]) * G + c];
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    reinterpret_cast<float4*>(s.acc)[p] = a;
  } else {
    float a = s.acc[p];
#pragma unroll 4
    for (int q = q0; q < q1; ++q) a += data[(row0 + s.list[q]) * G + c];
    s.acc[p] = a;
  }
}

template <bool V4>
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const float* __restrict__ data, const void* __restrict__ ids,
                   int ids64, const unsigned char* __restrict__ mask,
                   float* __restrict__ out, int N, int E, int D, int T,
                   int CH) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shared s = carve(smem, T, D, CH);
  const int G = V4 ? D / 4 : D;  // column groups per row
  const int b = blockIdx.y, n0 = blockIdx.x * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = (size_t)b * E;
  const int* id32 = static_cast<const int*>(ids) + row0;
  const long long* id64 = static_cast<const long long*>(ids) + row0;
  const unsigned char* m = mask ? mask + row0 : nullptr;
  const int pairs = T * G;
  for (int i = threadIdx.x; i < T * D; i += THREADS) s.acc[i] = 0.f;
  const int per_warp = CH / WARPS;  // a multiple of 32

  for (int c0 = 0; c0 < E; c0 += CH) {
    for (int i = threadIdx.x; i < WARPS * T; i += THREADS) s.cnt[i] = 0;
    __syncthreads();
    // walk 1: local node of each edge, per-warp counts per node
    const int lo = warp * per_warp;
    for (int j = 0; j < per_warp; j += 32) {
      const int k = lo + j + lane, e = c0 + k;
      int r = -1;
      if (e < E && (!m || m[e])) {
        const long long id = ids64 ? id64[e] : (long long)id32[e];
        if (id >= n0 && id < n0 + T && id < N) r = (int)(id - n0);
      }
      s.loc[k] = (signed char)r;
      const unsigned peers = __match_any_sync(FULL, r);
      if (r >= 0 && lane == __ffs(peers) - 1) s.cnt[warp * T + r] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // scan: node starts in node order, per-warp bases in warp order
    if (warp == 0) {
      int tot = 0;
      if (lane < T)
        for (int w = 0; w < WARPS; ++w) tot += s.cnt[w * T + lane];
      int incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane < T) {
        int run = incl - tot;
        s.start[lane] = run;
        for (int w = 0; w < WARPS; ++w) {
          const int c = s.cnt[w * T + lane];
          s.cnt[w * T + lane] = run;
          run += c;
        }
        if (lane == T - 1) s.start[T] = incl;
      }
    }
    __syncthreads();
    // walk 2: place each edge at its node's base + its rank in the round
    for (int j = 0; j < per_warp; j += 32) {
      const int k = lo + j + lane;
      const int r = s.loc[k];
      const unsigned peers = __match_any_sync(FULL, r);
      int base = 0;
      if (r >= 0) {
        base = s.cnt[warp * T + r];
        s.list[base + __popc(peers & ((1u << lane) - 1u))] = c0 + k;
      }
      __syncwarp();
      if (r >= 0 && lane == __ffs(peers) - 1) s.cnt[warp * T + r] = base + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // sums: each (node, column group) owned by one thread, in list order
    for (int p = threadIdx.x; p < pairs; p += THREADS) {
      const int r = p / G;
      add_rows<V4>(data, s, row0, G, p, r, p - r * G);
    }
    __syncthreads();
  }

  for (int p = threadIdx.x; p < pairs; p += THREADS) {
    const int r = p / G, n = n0 + r;
    if (n >= N) continue;
    const size_t o = ((size_t)b * N + n) * G + (p - r * G);
    if (V4)
      reinterpret_cast<float4*>(out)[o] = reinterpret_cast<const float4*>(s.acc)[p];
    else
      out[o] = s.acc[p];
  }
}

}  // namespace

// dims: [B, N, E, D, vec4, T, CH, smem_bytes, ids64] (the plan of
// ops/segment_kernel.py::segment_plan); data [B, E, D], ids [B, E] int32
// (int64 when ids64), mask [B, E] bool bytes or null, out [B, N, D]. vec4
// needs D % 4 == 0 and 16-byte aligned data and out; T <= 32 and CH a
// multiple of 256. Returns the launch's CUDA error (0 on success); nothing
// is synchronised.
extern "C" int segment_sum_forward(const int* dims, const float* data,
                                   const void* ids, const unsigned char* mask,
                                   float* out, void* stream_ptr) {
  const int B = dims[0], N = dims[1], E = dims[2], D = dims[3], vec4 = dims[4];
  const int T = dims[5], CH = dims[6], smem = dims[7], ids64 = dims[8];
  if (B <= 0 || N <= 0 || D <= 0 || E < 0 || (vec4 && D % 4) || T < 1 ||
      T > 32 || CH < THREADS || CH % THREADS)
    return cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((N + T - 1) / T, B);
  auto kernel = vec4 ? segment_sum_kernel<true> : segment_sum_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  kernel<<<grid, THREADS, smem, stream>>>(data, ids, ids64, mask, out, N, E, D,
                                          T, CH);
  return cudaGetLastError();
}
