// Batched searchsorted-left over sorted int32 key rows (kernel K1 of the port).
//
// Replaces the Pallas TPU kernel apr_tpu/ops/pallas/searchsorted.py::
// searchsorted_left (pallas_call at :116, body _kernel at :51-75).  It
// computes the same function: for support [B, S] (each row ascending, with
// INVALID_KEY = INT32_MAX padding at its tail) and queries [B, G, C], the
// left insertion point of every query in its cloud's support row.  Valid keys
// are < 2^30, so an INVALID query gets s_valid, the count of valid supports,
// with no special case: the same as searchsorted(support, INT32_MAX, 'left').
// The TPU kernel's 128-lane coarse table, slab windows and S <= 16384 /
// % 128 guards came from VMEM and lane limits and are not carried over: any
// B, S >= 0, G and C work here.
//
// Design (the simple, right first version): grid (ceil(G*C / 1024), B),
// 256 threads, 4 queries per thread.  A block stages its cloud's support row
// in dynamic shared memory when S * 4 bytes fits the 227 KB a block may
// opt into (S <= 58112), else it searches device memory (L2 keeps the hot
// upper levels of the search tree).  Each thread runs a branch-light
// lower_bound over [0, S).
//
// Bound on an H100: memory.  A launch must read each query and support key
// once and write each result once, (2 * G * C + S) * 4 * B bytes: 26.7 MB
// for the 5^3 conv1 map at B = 8 and S = C = 16384, about 8 us at
// 3.35 TB/s; the seven maps of one pyramid build move about 5.6 MB per
// cloud.  At the shapes of the main path the launch overhead and the
// shared-memory staging (every block re-reads its 64 KB support row) cost
// more than that bound.  Making it fast is later work: a merge-path split
// that exploits the per-row sortedness of the queries (each row is base
// keys + a constant), or one fused launch for the seven maps.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                      // queries per thread
constexpr long long kPerBlock = kThreads * kItems;
constexpr size_t kMaxDynamicSmem = 232448;     // 227 KB opt-in per block

__device__ __forceinline__ int lower_bound(const int* sup, int s, int q) {
  int lo = 0;
  int n = s;
  while (n > 0) {
    const int half = n >> 1;
    if (sup[lo + half] < q) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

template <bool kStage>
__global__ void __launch_bounds__(kThreads)
searchsorted_left_kernel(const int* __restrict__ support,
                         const int* __restrict__ queries,
                         int* __restrict__ out, int s, long long n) {
  extern __shared__ int staged[];
  const long long b = blockIdx.y;
  const int* sup = support + b * s;
  if (kStage) {
    for (int i = threadIdx.x; i < s; i += kThreads) staged[i] = sup[i];
    __syncthreads();
    sup = staged;
  }
  const int* q = queries + b * n;
  int* o = out + b * n;
  const long long base = blockIdx.x * kPerBlock + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + static_cast<long long>(k) * kThreads;
    if (i < n) o[i] = lower_bound(sup, s, q[i]);
  }
}

}  // namespace

// support [batch, s], queries and out [batch, n] (n = G * C), all int32 and
// contiguous on the current device; launches on ``stream`` and does not
// synchronise.  Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int apr_searchsorted_left(const void* support, const void* queries,
                                     void* out, int batch, int s, long long n,
                                     void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kPerBlock - 1) / kPerBlock),
                  static_cast<unsigned>(batch));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sup = static_cast<const int*>(support);
  const int* qry = static_cast<const int*>(queries);
  int* res = static_cast<int*>(out);
  const size_t smem = static_cast<size_t>(s) * sizeof(int);
  if (smem <= kMaxDynamicSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        searchsorted_left_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    searchsorted_left_kernel<true><<<grid, kThreads, smem, st>>>(
        sup, qry, res, s, n);
  } else {
    searchsorted_left_kernel<false><<<grid, kThreads, 0, st>>>(
        sup, qry, res, s, n);
  }
  return static_cast<int>(cudaGetLastError());
}
