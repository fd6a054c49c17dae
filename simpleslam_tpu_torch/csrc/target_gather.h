// Where a LOAM query's candidates sit in the dense map and in the sorted
// voxel table, in plain C++.
//
// The index math of ops/voxel.py gather_neighbors_corner (the corner-
// selected 2x2x2 block of a DenseVoxelMap) and of gather_neighbors(vm, q,
// mask, 1) + lookup_voxels (the 27-cell key search of a sorted VoxelMap,
// here nine searches through a sampled index of the keys), op for op in f32
// and int32. The CUDA kernel loam_gn_loop includes this
// file for its dense and table candidate sources (loam_kernels.cu);
// target_gather_host.cpp compiles the same file with g++ behind a C entry
// point, so a CPU test holds the kernel's index math against the torch and
// JAX gathers. TG_HD is "__host__ __device__" under nvcc and empty
// otherwise. Build both sides without multiply-add contraction.

#ifndef SIMPLESLAM_TARGET_GATHER_H_
#define SIMPLESLAM_TARGET_GATHER_H_

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define TG_HD __host__ __device__
#else
#define TG_HD
#endif
// a read-only load through the texture path on the device, plain on the host
#ifdef __CUDA_ARCH__
#define TG_LOAD(p) __ldg(p)
#else
#define TG_LOAD(p) (*(p))
#endif

namespace tg {

constexpr int kVoxelHalf = 512;       // voxel.py _HALF
constexpr int kVoxelRange = 1024;     // voxel.py _RANGE
constexpr int32_t kInvalidKey = 1 << 30;   // voxel.py INVALID_KEY
constexpr int kCornerCells = 8;       // the 2x2x2 block, x outermost
constexpr int kTableCells = 27;       // offsets -1..1 per axis, x outermost

// --- the dense map's corner gather ----------------------------------------

// Minimum corner of the 2x2x2 block around one coordinate:
// floor((q - corner) / grid - 0.5).
TG_HD inline int corner_base(float q, float corner, float grid) {
    return static_cast<int>(floorf((q - corner) / grid - 0.5f));
}

// Flat row of voxel (x, y, z) in a (gx, gy, gz) grid; the sentinel row
// gx * gy * gz for a masked-out query or a voxel outside the window
// (voxel.py _dense_flat).
TG_HD inline int64_t dense_flat(int x, int y, int z, int gx, int gy, int gz,
                                bool valid) {
    const bool in = valid && x >= 0 && x < gx && y >= 0 && y < gy && z >= 0
                    && z < gz;
    return in ? (static_cast<int64_t>(x) * gy + y) * gz + z
              : static_cast<int64_t>(gx) * gy * gz;
}

// Row of cell k (0..7) of the corner block at base (bx, by, bz).
TG_HD inline int64_t corner_cell_row(int bx, int by, int bz, int k, int gx,
                                     int gy, int gz, bool valid) {
    return dense_flat(bx + ((k >> 2) & 1), by + ((k >> 1) & 1), bz + (k & 1),
                      gx, gy, gz, valid);
}

// --- the sorted table's 27-cell key search --------------------------------

// Voxel coordinate offset to [0, 1024): floor((q - origin) / grid) + 512.
TG_HD inline int voxel_coord(float q, float origin, float grid) {
    return static_cast<int>(floorf((q - origin) / grid)) + kVoxelHalf;
}

// Packed key of (x, y, z), INVALID for a masked-out query or a coordinate
// out of range (voxel.py pack_coords).
TG_HD inline int32_t pack_key(int x, int y, int z, bool valid) {
    const bool in = x >= 0 && x < kVoxelRange && y >= 0 && y < kVoxelRange
                    && z >= 0 && z < kVoxelRange;
    return (valid && in) ? ((x << 20) | (y << 10) | z) : kInvalidKey;
}

// Key of cell k (0..26) around voxel (cx, cy, cz): offsets -1..1, x
// outermost (voxel.py _neighbor_offsets(1)).
TG_HD inline int32_t table_cell_key(int cx, int cy, int cz, int k,
                                    bool valid) {
    return pack_key(cx + k / 9 - 1, cy + (k / 3) % 3 - 1, cz + k % 3 - 1,
                    valid);
}

// --- the sampled key index ---------------------------------------------
//
// A lower bound over the whole key array reads about log2(n) keys one after
// another. The table's INVALID keys form its tail, and every other key lies
// below them, so a search for a valid key only needs a range keys[0..n)
// that holds the keys before the tail (n at least INVALID's own lower
// bound). The kernel keeps every s-th key of that range in shared memory
// (sample[i] = keys[i s]), so a search reads shared memory for all but its
// last log2(s) levels, which search the s - 1 keys between two samples.

constexpr int kIndexBudget = 4096;   // sampled keys: 16 KB of shared memory

// The sampling stride for n keys: the least power of two s with
// ceil(n / s) <= budget.
TG_HD inline int index_stride(int n, int budget) {
    int s = 1;
    while ((n + s - 1) / s > budget) s <<= 1;
    return s;
}

// Where the kernel's sampled range ends: `probes` threads each read one key,
// key (t + 1) step - 1 with step = ceil(n_keys / probes); with `below` of
// them under INVALID, the tail starts at or before the first probe that is
// not, so every valid key lies in keys[0..end).
TG_HD inline int probe_step(int n_keys, int probes) {
    return (n_keys + probes - 1) / probes;
}
TG_HD inline int valid_range_end(int below, int n_keys, int probes) {
    const int end = (below + 1) * probe_step(n_keys, probes) - 1;
    return end < n_keys ? end : n_keys;
}

// The table's keys (ascending), a range keys[0..n) that holds every key
// below INVALID, and the range's sampled index sample[0..n_s),
// sample[i] = keys[i s], n_s = ceil(n / s).
struct KeyIndex {
    const int32_t* keys;
    const int32_t* sample;
    int n, s, n_s;
};

// The lower bound of a valid `key` in the keys (torch.searchsorted): the
// samples below it, then the keys between the last of those and the next
// sample.
TG_HD inline int lower_bound_sampled(const KeyIndex& ix, int32_t key) {
    int lo = 0, hi = ix.n_s;
    while (lo < hi) {
        const int mid = lo + (hi - lo) / 2;
        if (ix.sample[mid] < key) lo = mid + 1;
        else hi = mid;
    }
    if (lo == 0) return 0;   // keys[0] >= key
    // keys[(lo - 1) s] < key <= keys[lo s] (or lo s >= n)
    int a = (lo - 1) * ix.s + 1;
    int b = lo * ix.s < ix.n ? lo * ix.s : ix.n;
    while (a < b) {
        const int mid = a + (b - a) / 2;
        if (TG_LOAD(ix.keys + mid) < key) a = mid + 1;
        else b = mid;
    }
    return a;
}

// Run r (0..8) of the 27 cells: cells 3 r .. 3 r + 2 of table_cell_key's
// order, (x, y) fixed and z = cz - 1 .. cz + 1, found with one search. The
// z of a run are consecutive keys (z packs lowest), so the lower bound of
// each valid cell after the first is the one before's, past the entries
// that equal the key before. An INVALID cell's bound is lb_invalid, the
// INVALID key's own lower bound. Writes each cell's row, the bound clamped
// to the last of the table's n_keys rows, and whether that row holds its
// key and the key is not INVALID: voxel.py lookup_voxels, exactly.
TG_HD inline void table_run_lookup(const KeyIndex& ix, int n_keys,
                                   int lb_invalid, int cx, int cy, int cz,
                                   int r, bool valid, int* idx, bool* found) {
    int lb = -1;
    int32_t prev = 0;
    for (int c = 0; c < 3; ++c) {
        const int32_t key = table_cell_key(cx, cy, cz, 3 * r + c, valid);
        int b = lb_invalid;
        if (key != kInvalidKey) {
            if (lb < 0) {
                b = lower_bound_sampled(ix, key);
            } else {
                b = lb;
                while (b < ix.n && TG_LOAD(ix.keys + b) <= prev) ++b;
            }
            lb = b;
            prev = key;
        }
        idx[c] = b < n_keys - 1 ? b : n_keys - 1;
        found[c] = key != kInvalidKey && TG_LOAD(ix.keys + idx[c]) == key;
    }
}

}  // namespace tg

#endif  // SIMPLESLAM_TARGET_GATHER_H_
