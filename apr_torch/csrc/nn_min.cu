// Batched nearest-neighbour min over 3-D point clouds (kernel K2 of the port).
//
// Replaces the Pallas TPU kernel apr_tpu/ops/pallas/distance.py::nn_min_pallas
// (pallas_call at :86, body _nn_kernel at :31-60).  It computes the same
// function: for queries [B, Nq, 3], supports [B, Ns, 3] and a support mask
// [B, Ns], the squared distance from every query to its nearest masked-valid
// support of the same cloud and that support's index; ties go to the lowest
// index, and a query with no valid support gets (+inf, Ns).  The TPU kernel's
// transposed [3, N] lane layout, (TQ, TS) tiles and f32-coded index came from
// the 128-lane VPU and VMEM; here the index is int32 and any B, Nq, Ns work.
//
// Design (the simple, right first version): grid (ceil(Nq / 512), B), 256
// threads, 2 queries per thread held in registers with a running
// (min, argmin).  The block walks its cloud's supports in ascending order in
// tiles of 2048, staged in shared memory as float4 (x, y, z, -) so that one
// broadcast load feeds both queries; a masked support is staged as x = +inf,
// so its distance is +inf and never wins.  Updates take strict '<' only:
// ascending order then gives ties to the lowest index, as the plain version
// (apr_torch/ops/distance.py::nn_min_plain) does.
//
// Exactness: d2 = ((dx*dx) + (dy*dy)) + (dz*dz) with every product and sum
// rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn), the order and
// rounding of the plain version's torch ops.  nvcc would otherwise contract
// a product and a sum into one FMA and change the last ulp.  Exact
// per-coordinate differences, never |q|^2 - 2 q.s + |s|^2, which cancels at
// LiDAR coordinates of +-80 m.
//
// Bound on an H100: operations.  Every (query, support) pair costs 3
// subtractions, 3 multiplications and 2 additions that cannot fuse (plus a
// compare and two selects): at full width one train step evaluates 16
// directed 65536 x 65536 passes, 6.9e10 pairs, about 16 ms at 3.35e13 FP32
// instructions per second (half the 67 TFLOP/s FMA peak).  Padding rows are
// computed too; the bound in chip_smoke.py counts valid pairs only.
// Making it fast (more queries per thread, skipping all-masked tiles, a
// spatial sort so that blocks stop early) is later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 2;                        // queries per thread
constexpr int kPerBlock = kThreads * kQ;
constexpr int kTile = 2048;                  // supports per shared tile (32 KB)

__global__ void __launch_bounds__(kThreads)
nn_min_kernel(const float* __restrict__ queries,
              const float* __restrict__ supports,
              const unsigned char* __restrict__ s_mask,
              float* __restrict__ out_d2, int* __restrict__ out_idx,
              int nq, int ns) {
  __shared__ float4 tile[kTile];
  const long long b = blockIdx.y;
  const float* q = queries + b * nq * 3LL;
  const float* s = supports + b * ns * 3LL;
  const unsigned char* m = s_mask + b * ns;

  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int arg[kQ];
  const long long base = static_cast<long long>(blockIdx.x) * kPerBlock +
                         threadIdx.x;
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const long long i = base + static_cast<long long>(k) * kThreads;
    const bool in = i < nq;
    qx[k] = in ? q[3 * i] : 0.f;
    qy[k] = in ? q[3 * i + 1] : 0.f;
    qz[k] = in ? q[3 * i + 2] : 0.f;
    best[k] = CUDART_INF_F;
    arg[k] = ns;
  }

  for (int t0 = 0; t0 < ns; t0 += kTile) {
    const int n = min(kTile, ns - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const long long r = t0 + j;
      tile[j] = m[r] ? make_float4(s[3 * r], s[3 * r + 1], s[3 * r + 2], 0.f)
                     : make_float4(CUDART_INF_F, 0.f, 0.f, 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 p = tile[j];
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        const float dx = __fsub_rn(qx[k], p.x);
        const float dy = __fsub_rn(qy[k], p.y);
        const float dz = __fsub_rn(qz[k], p.z);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        if (d2 < best[k]) {
          best[k] = d2;
          arg[k] = t0 + j;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const long long i = base + static_cast<long long>(k) * kThreads;
    if (i < nq) {
      out_d2[b * nq + i] = best[k];
      out_idx[b * nq + i] = arg[k];
    }
  }
}

}  // namespace

// queries [batch, nq, 3] and supports [batch, ns, 3] float32, s_mask
// [batch, ns] bool (one byte each), d2 [batch, nq] float32 and idx
// [batch, nq] int32, all contiguous on the current device; launches on
// ``stream`` and does not synchronise.  Returns the CUDA error of the launch
// (0 = cudaSuccess).
extern "C" int apr_nn_min(const void* queries, const void* supports,
                          const void* s_mask, void* d2, void* idx, int batch,
                          int nq, int ns, void* stream) {
  if (batch <= 0 || nq <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((nq + kPerBlock - 1) / kPerBlock),
                  static_cast<unsigned>(batch));
  nn_min_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const float*>(supports),
      static_cast<const unsigned char*>(s_mask), static_cast<float*>(d2),
      static_cast<int*>(idx), nq, ns);
  return static_cast<int>(cudaGetLastError());
}
