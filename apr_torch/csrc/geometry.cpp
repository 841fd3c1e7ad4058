// Host-side point-cloud geometry (C, loaded with ctypes by
// apr_torch/native.py): barycenter grid subsampling, first-point-per-voxel
// dedup and a capped, distance-sorted radius search.
//
// The port's own copy of the reference's host library (native/geometry.cpp):
// the same algorithms in the same order, so both libraries give the same
// bits.  The voxel map is a flat open-addressing hash table keyed by packed
// 21-bit/axis coordinates; the radius search bins the supports on a uniform
// grid of cell size == radius and probes the 27 cells around each query.
//
// Build (apr_torch/native.py does this at first use):
//   g++ -O3 -march=native -shared -fPIC -std=c++17 geometry.cpp -o libgeometry.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

struct Key3 {
    int64_t x, y, z;
};

static inline uint64_t pack_key(int64_t x, int64_t y, int64_t z) {
    // 21 bits per axis, offset to non-negative
    const int64_t OFF = 1 << 20;
    const uint64_t M = (1ull << 21) - 1;
    uint64_t ux = (uint64_t)(x + OFF) & M;
    uint64_t uy = (uint64_t)(y + OFF) & M;
    uint64_t uz = (uint64_t)(z + OFF) & M;
    return (ux << 42) | (uy << 21) | uz;
}

static inline uint64_t hash_u64(uint64_t k) {
    // splitmix64 finalizer
    k += 0x9e3779b97f4a7c15ull;
    k = (k ^ (k >> 30)) * 0xbf58476d1ce4e5b9ull;
    k = (k ^ (k >> 27)) * 0x94d049bb133111ebull;
    return k ^ (k >> 31);
}

// Open-addressing hash map from packed voxel key -> slot index.
class VoxelMap {
  public:
    explicit VoxelMap(size_t expected) {
        size_t cap = 16;
        while (cap < expected * 2) cap <<= 1;
        mask_ = cap - 1;
        keys_.assign(cap, EMPTY);
        vals_.assign(cap, -1);
    }

    // returns slot for key; inserts next_id if absent (then increments it)
    int32_t get_or_insert(uint64_t key, int32_t* next_id) {
        size_t i = hash_u64(key) & mask_;
        while (true) {
            if (keys_[i] == EMPTY) {
                keys_[i] = key;
                vals_[i] = (*next_id)++;
                return vals_[i];
            }
            if (keys_[i] == key) return vals_[i];
            i = (i + 1) & mask_;
        }
    }

    int32_t find(uint64_t key) const {
        size_t i = hash_u64(key) & mask_;
        while (true) {
            if (keys_[i] == EMPTY) return -1;
            if (keys_[i] == key) return vals_[i];
            i = (i + 1) & mask_;
        }
    }

  private:
    static constexpr uint64_t EMPTY = ~0ull;
    size_t mask_;
    std::vector<uint64_t> keys_;
    std::vector<int32_t> vals_;
};

}  // namespace

extern "C" {

// Barycenter grid subsampling (C++ grid_subsampling parity).
// points: [n, 3] row-major; out_points: [capacity, 3].
// Optional features: [n, fdim] averaged into out_features [capacity, fdim].
// Returns the number of voxels written (<= capacity; surplus voxels merge
// into earlier slots only by arrival order truncation — callers size
// capacity generously).
int32_t apr_grid_subsample(const float* points, int32_t n, float voxel,
                           const float* features, int32_t fdim,
                           float* out_points, float* out_features,
                           int32_t capacity) {
    if (n <= 0 || voxel <= 0) return 0;
    VoxelMap map(n);
    std::vector<double> acc(3 * (size_t)capacity, 0.0);
    std::vector<double> facc(features ? (size_t)capacity * fdim : 0, 0.0);
    std::vector<int32_t> cnt(capacity, 0);
    int32_t next_id = 0;
    const float inv = 1.0f / voxel;
    for (int32_t i = 0; i < n; i++) {
        int64_t cx = (int64_t)std::floor(points[3 * i + 0] * inv);
        int64_t cy = (int64_t)std::floor(points[3 * i + 1] * inv);
        int64_t cz = (int64_t)std::floor(points[3 * i + 2] * inv);
        int32_t id = map.get_or_insert(pack_key(cx, cy, cz), &next_id);
        if (id >= capacity) {  // over capacity: drop (mirror device semantics)
            next_id = capacity;
            continue;
        }
        acc[3 * id + 0] += points[3 * i + 0];
        acc[3 * id + 1] += points[3 * i + 1];
        acc[3 * id + 2] += points[3 * i + 2];
        if (features) {
            for (int32_t f = 0; f < fdim; f++)
                facc[(size_t)id * fdim + f] += features[(size_t)i * fdim + f];
        }
        cnt[id]++;
    }
    int32_t nv = std::min(next_id, capacity);
    for (int32_t v = 0; v < nv; v++) {
        double c = (double)std::max(cnt[v], 1);
        out_points[3 * v + 0] = (float)(acc[3 * v + 0] / c);
        out_points[3 * v + 1] = (float)(acc[3 * v + 1] / c);
        out_points[3 * v + 2] = (float)(acc[3 * v + 2] / c);
        if (features && out_features) {
            for (int32_t f = 0; f < fdim; f++)
                out_features[(size_t)v * fdim + f] =
                    (float)(facc[(size_t)v * fdim + f] / c);
        }
    }
    return nv;
}

// First-point-per-voxel dedup (ME.sparse_quantize 'sel' parity).
// out_sel: [capacity] indices of the kept points. Returns count.
int32_t apr_voxel_dedup(const float* points, int32_t n, float voxel,
                        int32_t* out_sel, int32_t capacity) {
    if (n <= 0 || voxel <= 0) return 0;
    VoxelMap map(n);
    int32_t next_id = 0;
    const float inv = 1.0f / voxel;
    for (int32_t i = 0; i < n; i++) {
        int64_t cx = (int64_t)std::floor(points[3 * i + 0] * inv);
        int64_t cy = (int64_t)std::floor(points[3 * i + 1] * inv);
        int64_t cz = (int64_t)std::floor(points[3 * i + 2] * inv);
        int32_t before = next_id;
        int32_t id = map.get_or_insert(pack_key(cx, cy, cz), &next_id);
        if (id >= capacity) {
            next_id = capacity;
            continue;
        }
        if (next_id > before) out_sel[id] = i;  // newly inserted voxel
    }
    return std::min(next_id, capacity);
}

// Fixed-radius neighbor search via uniform grid binning (cell = radius).
// Distance-sorted, truncated to cap, sentinel = ns (nanoflann sorted-search
// + cap-truncation parity, neighbors.cpp:211-332).
// out_idx: [nq, cap] row-major.
void apr_radius_neighbors(const float* queries, int32_t nq,
                          const float* supports, int32_t ns,
                          float radius, int32_t cap, int32_t* out_idx) {
    for (int64_t i = 0; i < (int64_t)nq * cap; i++) out_idx[i] = ns;
    if (nq <= 0 || ns <= 0 || radius <= 0 || cap <= 0) return;

    const float inv = 1.0f / radius;
    // bin supports
    VoxelMap map(ns);
    std::vector<int32_t> bin_of(ns);
    int32_t nbins = 0;
    for (int32_t j = 0; j < ns; j++) {
        int64_t cx = (int64_t)std::floor(supports[3 * j + 0] * inv);
        int64_t cy = (int64_t)std::floor(supports[3 * j + 1] * inv);
        int64_t cz = (int64_t)std::floor(supports[3 * j + 2] * inv);
        bin_of[j] = map.get_or_insert(pack_key(cx, cy, cz), &nbins);
    }
    // bucket by bin (counting sort)
    std::vector<int32_t> start(nbins + 1, 0);
    for (int32_t j = 0; j < ns; j++) start[bin_of[j] + 1]++;
    for (int32_t b = 0; b < nbins; b++) start[b + 1] += start[b];
    std::vector<int32_t> order(ns);
    {
        std::vector<int32_t> cursor(start.begin(), start.end() - 1);
        for (int32_t j = 0; j < ns; j++) order[cursor[bin_of[j]]++] = j;
    }

    const float r2 = radius * radius;
    std::vector<std::pair<float, int32_t>> found;
    for (int32_t q = 0; q < nq; q++) {
        found.clear();
        const float* Q = queries + 3 * q;
        int64_t cx = (int64_t)std::floor(Q[0] * inv);
        int64_t cy = (int64_t)std::floor(Q[1] * inv);
        int64_t cz = (int64_t)std::floor(Q[2] * inv);
        for (int64_t dx = -1; dx <= 1; dx++)
            for (int64_t dy = -1; dy <= 1; dy++)
                for (int64_t dz = -1; dz <= 1; dz++) {
                    int32_t b = map.find(pack_key(cx + dx, cy + dy, cz + dz));
                    if (b < 0) continue;
                    for (int32_t t = start[b]; t < start[b + 1]; t++) {
                        int32_t j = order[t];
                        float ddx = supports[3 * j] - Q[0];
                        float ddy = supports[3 * j + 1] - Q[1];
                        float ddz = supports[3 * j + 2] - Q[2];
                        float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
                        if (d2 <= r2) found.emplace_back(d2, j);
                    }
                }
        int32_t keep = std::min((int32_t)found.size(), cap);
        std::partial_sort(found.begin(), found.begin() + keep, found.end());
        for (int32_t t = 0; t < keep; t++)
            out_idx[(int64_t)q * cap + t] = found[t].second;
    }
}

}  // extern "C"
