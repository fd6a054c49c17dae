// Where a LOAM query's candidates sit in the dense map and in the sorted
// voxel table, in plain C++.
//
// The index math of ops/voxel.py gather_neighbors_corner (the corner-
// selected 2x2x2 block of a DenseVoxelMap) and of gather_neighbors(vm, q,
// mask, 1) + lookup_voxels (the 27-cell key search of a sorted VoxelMap),
// op for op in f32 and int32. The CUDA kernel loam_gn_loop includes this
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

// Row of `key` in the ascending table keys[0..n): the lower bound
// (torch.searchsorted), clamped to the last row; *found when that row holds
// the key and the key is not INVALID (voxel.py lookup_voxels). n >= 1.
TG_HD inline int table_lookup(const int32_t* keys, int n, int32_t key,
                              bool* found) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = lo + (hi - lo) / 2;
        if (TG_LOAD(keys + mid) < key) lo = mid + 1;
        else hi = mid;
    }
    const int idx = lo < n - 1 ? lo : n - 1;
    *found = TG_LOAD(keys + idx) == key && key != kInvalidKey;
    return idx;
}

}  // namespace tg

#endif  // SIMPLESLAM_TARGET_GATHER_H_
