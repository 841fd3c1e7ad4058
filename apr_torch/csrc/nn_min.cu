// Batched nearest-neighbour min over 3-D point clouds (kernel K2 of the port).
//
// Replaces the Pallas TPU kernel apr_tpu/ops/pallas/distance.py::nn_min_pallas
// (pallas_call at :86, body _nn_kernel at :31-60).  It computes the same
// function over compacted clouds: the wrapper (apr_torch/ops/distance.py)
// moves each cloud's valid supports, and its valid queries when it has a
// query mask, to the front in their original order and hands the kernel the
// per-cloud counts as device arrays.  For every valid query the kernel finds
// the squared distance to its nearest valid support of the same cloud and
// that support's compacted index; ties go to the lowest index.  The wrapper
// maps the index back through the partition, which keeps order, so the
// lowest compacted index is the lowest original one.
//
// Work.  The kernel evaluates only valid pairs: per cloud b, ceil(nq_b /
// 2048) query tiles times ceil(ns_b / 256) support stages are the work
// units, counted from the device-side counts.  A persistent grid (as many
// blocks as fit on the SMs) splits the list of units evenly: each block
// takes one contiguous range of about total / gridDim units, so no block
// idles while another has a whole query tile left.  A range may start or
// end inside a query tile's support sweep; the partial results meet in an
// atomicMin on (d2 bits << 32 | index), which orders by d2 first (d2 >= 0,
// so its bits order as the floats do) and by index second: exactly the
// strict-'<' ascending scan's result.
//
// Per block: 256 threads hold 8 queries each in registers; support stages
// of 256 points (float4 x, y, z, -) are double-buffered in shared memory by
// cp.async, so the next stage's copy overlaps this stage's arithmetic, and
// one broadcast 16-byte shared load feeds 8 queries.  The inner loop keeps
// only a running min (fminf).  After every 32 supports a thread notes, per
// query, whether that sub-tile lowered the min; once a query tile's sweep
// ends it rescans the last sub-tile that did, and takes the first index
// that attains the min.  The argmin thus stays off the per-pair path.
//
// Exactness: d2 = ((dx*dx) + (dy*dy)) + (dz*dz) with every product and sum
// rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn), the order and
// rounding of the plain version's torch ops (nvcc would otherwise contract
// a product and a sum into one FMA and change the last ulp), and the rescan
// repeats the same operations.  Exact per-coordinate differences, never
// |q|^2 - 2 q.s + |s|^2, which cancels at LiDAR coordinates of +-80 m.
//
// Bound on an H100: operations.  Every valid (query, support) pair costs 3
// subtractions, 3 multiplications and 2 additions that cannot fuse: at the
// train step's shapes 3.11e10 valid pairs, 7.4 ms at 3.35e13 float32
// instructions per second.  The kernel issues a ninth instruction per pair
// (the fminf), so it can reach at most 8/9 of that bound.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 8;                        // queries per thread
constexpr int kQueryTile = kThreads * kQ;    // queries per work unit
constexpr int kStage = kThreads;             // supports per unit (4 KB)
constexpr int kSub = 32;                     // argmin rescan granularity
constexpr int kMinBlocksPerSm = 2;

struct Unit {
  int b;       // cloud
  int tile;    // query tile of that cloud
  int stage;   // support stage of that cloud
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ long long units_of(int nq, int ns) {
  return static_cast<long long>(cdiv(nq, kQueryTile)) * cdiv(ns, kStage);
}

__device__ long long total_units(const int* nq_count, const int* ns_count,
                                 int batch) {
  long long total = 0;
  for (int b = 0; b < batch; ++b) {
    total += units_of(__ldg(nq_count + b), __ldg(ns_count + b));
  }
  return total;
}

__device__ Unit decode(long long u, const int* nq_count, const int* ns_count) {
  int b = 0;
  for (;; ++b) {
    const long long here =
        units_of(__ldg(nq_count + b), __ldg(ns_count + b));
    if (u < here) break;
    u -= here;
  }
  const int stages = cdiv(__ldg(ns_count + b), kStage);
  return Unit{b, static_cast<int>(u / stages), static_cast<int>(u % stages)};
}

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float4 p) {
  const float dx = __fsub_rn(qx, p.x);
  const float dy = __fsub_rn(qy, p.y);
  const float dz = __fsub_rn(qz, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Stage ``u``'s supports into ``dst``: one 16-byte cp.async a thread, and a
// point at +inf (distance +inf, never a minimum) past the cloud's count.
__device__ __forceinline__ void stage_load(float4* dst, const Unit& u,
                                           const float4* supports, int ns,
                                           int ns_b) {
  const int j = u.stage * kStage + threadIdx.x;
  if (j < ns_b) {
    const float4* src = supports + static_cast<long long>(u.b) * ns + j;
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + threadIdx.x));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else {
    dst[threadIdx.x] =
        make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.f);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// A query tile's results so far into ``out``: per query with a candidate,
// rescan the last sub-tile that lowered its min for the first index that
// attains it, and atomicMin (d2 bits << 32 | index).
__device__ __forceinline__ void flush(
    const float (&qx)[kQ], const float (&qy)[kQ], const float (&qz)[kQ],
    const float (&best)[kQ], const int (&sub)[kQ], int qb, int qt,
    const float4* supports, const int* nq_count, const int* ns_count,
    unsigned long long* out, int nq, int ns) {
  const float4* sp = supports + static_cast<long long>(qb) * ns;
  const int nq_b = __ldg(nq_count + qb);
  const int ns_b = __ldg(ns_count + qb);
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = qt * kQueryTile + k * kThreads + threadIdx.x;
    if (i >= nq_b || sub[k] < 0) continue;
    const int j0 = sub[k] * kSub;
    const int j1 = min(j0 + kSub, ns_b);
    int arg = j0;
    for (int j = j0; j < j1; ++j) {
      if (sq_dist(qx[k], qy[k], qz[k], __ldg(sp + j)) == best[k]) {
        arg = j;
        break;
      }
    }
    atomicMin(out + static_cast<long long>(qb) * nq + i,
              static_cast<unsigned long long>(__float_as_uint(best[k])) << 32 |
                  static_cast<unsigned>(arg));
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
nn_min_kernel(const float4* __restrict__ queries,
              const float4* __restrict__ supports,
              const int* __restrict__ nq_count,
              const int* __restrict__ ns_count,
              unsigned long long* __restrict__ out, int batch, int nq,
              int ns) {
  __shared__ float4 tile[2][kStage];
  const long long total = total_units(nq_count, ns_count, batch);
  const long long begin = total * blockIdx.x / gridDim.x;
  const long long end = total * (blockIdx.x + 1) / gridDim.x;
  if (begin >= end) return;

  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int sub[kQ];          // last sub-tile that lowered best, -1 if none
  int qb = -1, qt = -1;  // the query tile held in registers

  Unit cur = decode(begin, nq_count, ns_count);
  stage_load(tile[0], cur, supports, ns, __ldg(ns_count + cur.b));
  for (long long u = begin; u < end; ++u) {
    const int buf = static_cast<int>((u - begin) & 1);
    if (cur.b != qb || cur.tile != qt) {
      if (qb >= 0) flush(qx, qy, qz, best, sub, qb, qt, supports, nq_count,
                          ns_count, out, nq, ns);
      qb = cur.b;
      qt = cur.tile;
      const int nq_b = __ldg(nq_count + qb);
      const float4* qp = queries + static_cast<long long>(qb) * nq;
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        const int i = qt * kQueryTile + k * kThreads + threadIdx.x;
        const float4 v = i < nq_b ? __ldg(qp + i) : make_float4(0, 0, 0, 0);
        qx[k] = v.x;
        qy[k] = v.y;
        qz[k] = v.z;
        best[k] = CUDART_INF_F;
        sub[k] = -1;
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // tile[buf] has landed; tile[buf ^ 1] is free
    const int sub0 = cur.stage * (kStage / kSub);
    if (u + 1 < end) {
      cur = decode(u + 1, nq_count, ns_count);
      stage_load(tile[buf ^ 1], cur, supports, ns, __ldg(ns_count + cur.b));
    }
    const float4* t = tile[buf];
#pragma unroll 1
    for (int s = 0; s < kStage / kSub; ++s) {
      float prev[kQ];
#pragma unroll
      for (int k = 0; k < kQ; ++k) prev[k] = best[k];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float4 p = t[s * kSub + j];
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          best[k] = fminf(best[k], sq_dist(qx[k], qy[k], qz[k], p));
        }
      }
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        sub[k] = best[k] < prev[k] ? sub0 + s : sub[k];
      }
    }
  }
  flush(qx, qy, qz, best, sub, qb, qt, supports, nq_count, ns_count, out, nq,
        ns);
}

int grid_size() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn_min_kernel,
                                                    kThreads, 0) !=
          cudaSuccess) {
    return 0;
  }
  const int grid = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) cached[dev] = grid;
  return grid;
}

}  // namespace

// queries [batch, nq, 4] and supports [batch, ns, 4] float32 (x, y, z, -),
// each cloud's valid points first; nq_count and ns_count [batch] int32, the
// valid counts; out [batch, nq] 64-bit, filled by the caller with
// (inf bits << 32 | 0xffffffff).  For every valid query of every cloud, out
// becomes min over valid supports of (d2 bits << 32 | support index); the
// rest keep the fill.  All contiguous on the current device; launches on
// ``stream`` and does not synchronise.  Returns the CUDA error of the launch
// (0 = cudaSuccess).
extern "C" int apr_nn_min(const void* queries, const void* supports,
                          const void* nq_count, const void* ns_count,
                          void* out, int batch, int nq, int ns,
                          void* stream) {
  if (batch <= 0 || nq <= 0 || ns <= 0) return 0;
  const int grid = grid_size();
  if (grid <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  nn_min_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(queries),
      static_cast<const float4*>(supports),
      static_cast<const int*>(nq_count), static_cast<const int*>(ns_count),
      static_cast<unsigned long long*>(out), batch, nq, ns);
  return static_cast<int>(cudaGetLastError());
}
