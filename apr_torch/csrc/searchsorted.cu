// Batched searchsorted-left over sorted int32 key rows (kernel K1 of the port).
//
// Replaces the Pallas TPU kernel apr_tpu/ops/pallas/searchsorted.py::
// searchsorted_left (pallas_call at :116, body _kernel at :51-75).  It
// computes the same function: for support [B, S] (each row ascending, with
// INVALID_KEY = INT32_MAX padding at its tail) and queries [B, G, C], the
// left insertion point of every query in its cloud's support row.  Valid keys
// are < 2^30, so an INVALID query gets s_valid, the count of valid supports,
// with no special case: the same as searchsorted(support, INT32_MAX, 'left').
// Any B, S >= 0, G and C work.
//
// One launch serves up to kMaxSearches searches that share B (the seven
// kernel maps of one pyramid build): their descriptors ride in the kernel's
// parameter struct, blockIdx.x maps to (search, chunk of kPerBlock queries)
// and blockIdx.y to the cloud.
//
// Two-level search, no staging of the row.  A block builds a coarse table
// of its cloud's row in shared memory, coarse[j] = support[W * j] with
// W = 32 (one 128-byte line of keys; 2 KB of table at S = 16384), or the
// least power of two above that keeps the table within kMaxCoarse entries.
// A query takes j = #{coarse < q} from the table; then support[W(j-1)] < q
// <= support[Wj] bound its answer to (W(j-1), min(Wj, S)], and a lower_bound
// over the W - 1 keys of that window, read with __ldg from one line (for
// W = 32), finishes it.  Duplicate keys straddling a window edge are no
// hazard: j counts strictly smaller keys, so the window always holds the
// first key >= q.  Reads past S count as INT32_MAX (never < q), which covers
// S < W, S % W != 0 and S = 0.  Both searches run a fixed number of steps
// for every query of a block (the branchless form with a uniform length),
// so a thread interleaves its kItems searches.
//
// Bound on an H100: memory.  A search must read each query and support key
// once and write each result once, (2 * G * C + S) * 4 * B bytes: 26.7 MB
// for the 5^3 conv1 map at B = 8 and S = C = 16384, about 8 us at
// 3.35 TB/s.  At the main path's shapes the launch and the dependent
// search steps (about 10 shared and 5 L1 loads a query) cost more than that.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                      // queries per thread
constexpr long long kPerBlock = kThreads * kItems;
constexpr int kMaxSearches = 8;
constexpr int kLineShift = 5;                  // 32 keys: one 128-byte line
constexpr int kMaxCoarse = 8192;               // 32 KB of coarse table

struct Search {
  const int* support;     // [batch, s]
  const int* queries;     // [batch, n]
  int* out;               // [batch, n]
  long long n;            // queries per cloud (G * C)
  int s;                  // support keys per cloud
  int shift;              // log2 of the coarse stride W
  int coarse;             // coarse entries, ceil(s / W)
  unsigned first_block;   // first blockIdx.x of this search
};

struct Group {
  Search search[kMaxSearches];
  int count;
};

__global__ void __launch_bounds__(kThreads)
searchsorted_many_kernel(const Group g) {
  extern __shared__ int coarse[];
  // the search this block serves: the last one whose first block it has
  // reached (unrolled, so every field is a constant-bank read)
  Search d = g.search[0];
#pragma unroll
  for (int i = 1; i < kMaxSearches; ++i) {
    if (i < g.count && blockIdx.x >= g.search[i].first_block) d = g.search[i];
  }
  const long long b = blockIdx.y;
  const int* sup = d.support + b * d.s;
  for (int j = threadIdx.x; j < d.coarse; j += kThreads) {
    coarse[j] = __ldg(sup + (static_cast<long long>(j) << d.shift));
  }
  __syncthreads();

  const int* qry = d.queries + b * d.n;
  int* res = d.out + b * d.n;
  const long long base =
      static_cast<long long>(blockIdx.x - d.first_block) * kPerBlock +
      threadIdx.x;
  int q[kItems], at[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + static_cast<long long>(k) * kThreads;
    q[k] = i < d.n ? __ldg(qry + i) : INT_MAX;
    at[k] = 0;
  }

  // level 1: j = #{coarse < q}; at[k] walks down to the last candidate
  if (d.coarse > 0) {
    for (int len = d.coarse; len > 1;) {
      const int half = len >> 1;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        at[k] = coarse[at[k] + half] < q[k] ? at[k] + half : at[k];
      }
      len -= half;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) at[k] += coarse[at[k]] < q[k];
  }

  // level 2: the keys strictly inside the window (W(j-1), Wj), W - 1 of
  // them, from lo = W(j-1) + 1 (lo = 0 when j = 0: then support[0] >= q and
  // the count below stays 0)
  const int width = (1 << d.shift) - 1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    at[k] = at[k] > 0 ? ((at[k] - 1) << d.shift) + 1 : 0;
  }
  for (int len = width; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int p = at[k] + half;
      const int key = p < d.s ? __ldg(sup + p) : INT_MAX;
      at[k] = key < q[k] ? p : at[k];
    }
    len -= half;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int key = at[k] < d.s ? __ldg(sup + at[k]) : INT_MAX;
    at[k] += key < q[k];
    const long long i = base + static_cast<long long>(k) * kThreads;
    if (i < d.n) res[i] = at[k];
  }
}

}  // namespace

// ``count`` searches (1..8) over ``batch`` clouds: supports[i] [batch, s[i]],
// queries[i] and outs[i] [batch, n[i]] (n = G * C), all int32, contiguous,
// on the current device.  Launches once on ``stream`` and does not
// synchronise.  Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int apr_searchsorted_left_many(int count,
                                          const void* const* supports,
                                          const void* const* queries,
                                          void* const* outs, const int* s,
                                          const long long* n, int batch,
                                          void* stream) {
  if (count < 1 || count > kMaxSearches) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Group g{};
  g.count = count;
  long long blocks = 0;
  int max_coarse = 0;
  for (int i = 0; i < count; ++i) {
    Search& d = g.search[i];
    d.support = static_cast<const int*>(supports[i]);
    d.queries = static_cast<const int*>(queries[i]);
    d.out = static_cast<int*>(outs[i]);
    d.n = n[i];
    d.s = s[i];
    d.shift = kLineShift;
    while ((static_cast<long long>(s[i]) + (1LL << d.shift) - 1 >> d.shift) >
           kMaxCoarse) {
      ++d.shift;
    }
    d.coarse = static_cast<int>(
        (static_cast<long long>(s[i]) + (1LL << d.shift) - 1) >> d.shift);
    d.first_block = static_cast<unsigned>(blocks);
    blocks += (n[i] + kPerBlock - 1) / kPerBlock;
    if (d.coarse > max_coarse) max_coarse = d.coarse;
  }
  if (batch <= 0 || blocks == 0) return 0;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
  searchsorted_many_kernel<<<grid, kThreads, max_coarse * sizeof(int),
                             static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
