// The k nearest supports of every query, within a radius or not, over 3-D
// point clouds (kernel K3 of the port).
//
// Replaces no TPU kernel: apr_tpu computes the same selection with XLA's
// top_k (apr_tpu/ops/neighbors.py: knn, radius_neighbors and the window body
// of windowed_radius_neighbors).  The port's plain version of it
// (apr_torch/ops/neighbors.py) builds an int64 key (d2 bits << 32 |
// position) for every (query, candidate) pair and radix-selects over it with
// torch.topk: each pair's distance, casts, key and radix digits go through
// device memory several times, and a KP pyramid build spent ~470 ms on it.
// This kernel keeps each query's running list of its k best candidates on
// chip and writes only the k results.
//
// Candidates.  Brute mode (tile == 0): every support of the query's cloud,
// those that s_mask leaves out skipped.  Windowed mode (tile > 0): the
// queries are cell-key-sorted and cut into tiles of ``tile``; the queries of
// tile t see the sorted-support positions [lo[t], lo[t] + window) below
// hi[t], the window body's truncation, so an overflowing slab gives the
// plain version's table.  Candidates are scanned in ascending position.
//
// Distance.  The squared distance with the bits of the plain version's
// ``sq_norm(d0, d1, d2)``: d0 * d0 in float32, then each later coordinate
// one float64 multiply-add of the float32 difference (the product of two
// float32 values is exact in float64) rounded once to float32.  The order
// of the coordinates is the call site's: (dx, dy, dz) for knn and
// radius_neighbors, (dy, dx, dz) for the window body (``yx``), the orders in
// which the reference's compiled programs contract their sums.  Every
// operation is an explicitly rounded intrinsic, so nvcc contracts nothing.
//
// Selection.  A candidate is kept only if its d2 < ``bound`` (+inf for knn,
// the next float32 above r2 for a radius search: d2 < bound is d2 <= r2).
// Each query holds its list of up to k (d2, position) pairs in shared
// memory, ascending, ties in insertion order; since positions arrive in
// ascending order, that is the order of the key (d2 bits << 32 | position)
// that torch.topk sorts, and a candidate whose d2 equals the k-th's loses.
// Filtering by the radius before the selection gives the same table as
// selecting k and filtering after.  Missing neighbours and masked queries
// get (Ns, +inf).
//
// Work.  128 threads a block, one query a thread; the block's candidates
// stream through shared memory in stages of 512 points (float4), the next
// stage's loads in registers while this one is scored, and one broadcast
// 16-byte shared load feeds a thread's pair.  A pair first costs a float32
// distance with every product and sum rounded on its own, compared with the
// current k-th distance widened by 2^-16 of itself (plus FLT_MIN): that
// value and the exact one both lie within a few ulps of the true sum of
// three non-negative squares, so no pair the exact distance keeps fails the
// test.  Only the pairs that pass pay for the float64 distance (six
// float32 <-> float64 conversions at a sixteenth of the float32 rate) and
// the compare with the k-th; only those that beat it touch the list.
//
// Bound on an H100: operations.  Every (query, candidate) pair costs 3
// subtractions, 3 multiplications and 2 additions that cannot fuse: 8
// float32 instructions at 3.35e13 a second.  The compare is a ninth.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStage = 512;                      // supports per stage
constexpr int kPerThread = kStage / kThreads;    // stage loads per thread
constexpr int kMaxK = 64;
constexpr float kSlack = 1.0000152587890625f;    // 1 + 2^-16
constexpr float kTiny = 1.17549435082e-38f;      // FLT_MIN
constexpr size_t kStageBytes = kStage * sizeof(float4);
constexpr size_t kMaxSmem = kStageBytes + size_t{kMaxK} * kThreads * 8;

struct Args {
  const float* queries;        // [B, nq, 3]
  const float* supports;       // [B, ns, 3]
  const unsigned char* q_mask; // [B, nq] or null
  const unsigned char* s_mask; // [B, ns] or null (brute mode)
  const int* lo;               // [B, n_tiles] (windowed mode)
  const int* hi;
  int* out_idx;                // [B, nq, k]
  float* out_d2;               // [B, nq, k] or null
  int nq, ns, k;
  float bound;
  int tile, window, n_tiles, per_tile;
};

// sq_norm(d0, d1, d2) of apr_torch/ops/neighbors.py, bit for bit
__device__ __forceinline__ float exact_sq(float d0, float d1, float d2) {
  const float acc = __fmul_rn(d0, d0);
  const float acc1 = __double2float_rn(
      __fma_rn(static_cast<double>(d1), static_cast<double>(d1),
               static_cast<double>(acc)));
  return __double2float_rn(__fma_rn(static_cast<double>(d2),
                                    static_cast<double>(d2),
                                    static_cast<double>(acc1)));
}

// the float32 pre-test's threshold for a k-th distance ``worst``
__device__ __forceinline__ float widened(float worst) {
  return __fadd_rn(__fmul_rn(worst, kSlack), kTiny);
}

template <bool kYX>
__global__ void __launch_bounds__(kThreads) radius_select_kernel(Args a) {
  extern __shared__ float4 smem[];
  float4* stage = smem;
  float* ld = reinterpret_cast<float*>(smem + kStage) + threadIdx.x;
  int* li = reinterpret_cast<int*>(reinterpret_cast<float*>(smem + kStage) +
                                   a.k * kThreads) + threadIdx.x;
  const int b = blockIdx.y;
  int i, c0, c1;
  bool in_range;
  if (a.tile > 0) {
    const int t = blockIdx.x / a.per_tile;
    const int r = (blockIdx.x % a.per_tile) * kThreads + threadIdx.x;
    i = t * a.tile + r;
    in_range = r < a.tile && i < a.nq;
    const long long at = static_cast<long long>(b) * a.n_tiles + t;
    c0 = max(__ldg(a.lo + at), 0);
    c1 = min(min(c0 + a.window, __ldg(a.hi + at)), a.ns);
  } else {
    i = blockIdx.x * kThreads + threadIdx.x;
    in_range = i < a.nq;
    c0 = 0;
    c1 = a.ns;
  }
  const long long row = static_cast<long long>(b) * a.nq + i;
  const bool valid = in_range && (a.q_mask == nullptr || a.q_mask[row]);
  // a query left out scores NaN against everything: nothing is kept
  float qx = CUDART_NAN_F, qy = CUDART_NAN_F, qz = CUDART_NAN_F;
  if (valid) {
    qx = __ldg(a.queries + 3 * row);
    qy = __ldg(a.queries + 3 * row + 1);
    qz = __ldg(a.queries + 3 * row + 2);
  }

  const float* sp = a.supports + static_cast<long long>(b) * a.ns * 3;
  const unsigned char* sm =
      a.s_mask ? a.s_mask + static_cast<long long>(b) * a.ns : nullptr;
  float px[kPerThread], py[kPerThread], pz[kPerThread];
  // stage c's points into registers; NaN past c1 and where s_mask is 0
  auto fetch = [&](int c) {
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int j = c + u * kThreads + threadIdx.x;
      const bool on = j < c1 && (sm == nullptr || sm[j]);
      px[u] = on ? __ldg(sp + 3 * j) : CUDART_NAN_F;
      py[u] = on ? __ldg(sp + 3 * j + 1) : CUDART_NAN_F;
      pz[u] = on ? __ldg(sp + 3 * j + 2) : CUDART_NAN_F;
    }
  };

  float worst = a.bound;
  float worst_hi = widened(worst);
  int n = 0;
  if (c0 < c1) fetch(c0);
  for (int c = c0; c < c1; c += kStage) {  // c0, c1: the block's own
    __syncthreads();                       // the last stage is consumed
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      stage[u * kThreads + threadIdx.x] =
          make_float4(px[u], py[u], pz[u], 0.f);
    }
    __syncthreads();
    if (c + kStage < c1) fetch(c + kStage);
#pragma unroll 4
    for (int j = 0; j < kStage; ++j) {
      const float4 p = stage[j];
      const float dx = __fsub_rn(qx, p.x);
      const float dy = __fsub_rn(qy, p.y);
      const float dz = __fsub_rn(qz, p.z);
      const float rough = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (rough <= worst_hi) {
        const float d2 = kYX ? exact_sq(dy, dx, dz) : exact_sq(dx, dy, dz);
        if (d2 < worst) {
          // insert after every entry <= d2; a full list drops its k-th
          int at = min(n, a.k - 1);
          for (; at > 0 && ld[(at - 1) * kThreads] > d2; --at) {
            ld[at * kThreads] = ld[(at - 1) * kThreads];
            li[at * kThreads] = li[(at - 1) * kThreads];
          }
          ld[at * kThreads] = d2;
          li[at * kThreads] = c + j;
          if (n < a.k) ++n;
          if (n == a.k) {
            worst = ld[(a.k - 1) * kThreads];
            worst_hi = widened(worst);
          }
        }
      }
    }
  }
  if (!in_range) return;
  int* oi = a.out_idx + row * a.k;
  float* od = a.out_d2 ? a.out_d2 + row * a.k : nullptr;
  for (int j = 0; j < a.k; ++j) {
    const bool got = j < n;
    oi[j] = got ? li[j * kThreads] : a.ns;
    if (od) od[j] = got ? ld[j * kThreads] : CUDART_INF_F;
  }
}

// Lets both instantiations take up to kMaxSmem of dynamic shared memory on
// the current device (once per device).
cudaError_t allow_smem() {
  static bool done[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(radius_select_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(radius_select_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
  }
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace

// queries [batch, nq, 3] and supports [batch, ns, 3] float32; q_mask
// [batch, nq] and s_mask [batch, ns] bool or null; brute mode with tile = 0
// (lo, hi null), windowed mode with tile > 0: lo and hi [batch,
// ceil(nq / tile)] int32, the sorted-support range of each query tile, and
// ``window`` its length cap (s_mask unused).  Writes out_idx [batch, nq, k]
// int32 (the support positions of each query's k nearest kept candidates,
// ascending by (d2, position), then ns) and, unless null, out_d2 [batch,
// nq, k] float32 (their d2, then +inf).  A candidate is kept only if d2 <
// bound.  ``yx``: the window body's contraction order (dy, dx, dz).  All
// contiguous on the current device; launches on ``stream`` and does not
// synchronise.  Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int apr_radius_select(const void* queries, const void* supports,
                                 const void* q_mask, const void* s_mask,
                                 const void* lo, const void* hi, void* out_idx,
                                 void* out_d2, int batch, int nq, int ns,
                                 int k, float bound, int yx, int tile,
                                 int window, void* stream) {
  if (batch <= 0 || nq <= 0) return 0;
  if (k < 1 || k > kMaxK || batch > 65535 || ns < 0 || tile < 0 ||
      (tile > 0 && (lo == nullptr || hi == nullptr || window < 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const float*>(queries),
         static_cast<const float*>(supports),
         static_cast<const unsigned char*>(q_mask),
         static_cast<const unsigned char*>(s_mask),
         static_cast<const int*>(lo), static_cast<const int*>(hi),
         static_cast<int*>(out_idx), static_cast<float*>(out_d2),
         nq, ns, k, bound, tile, window, 0, 0};
  long long blocks;
  if (tile > 0) {
    a.n_tiles = (nq + tile - 1) / tile;
    a.per_tile = (tile + kThreads - 1) / kThreads;
    blocks = static_cast<long long>(a.n_tiles) * a.per_tile;
  } else {
    blocks = (nq + kThreads - 1) / kThreads;
  }
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = kStageBytes + static_cast<size_t>(k) * kThreads * 8;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (yx) {
    radius_select_kernel<true><<<grid, kThreads, smem, s>>>(a);
  } else {
    radius_select_kernel<false><<<grid, kThreads, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
