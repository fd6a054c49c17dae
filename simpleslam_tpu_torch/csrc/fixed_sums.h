// The layout and the fixed-order sums of the LOAM kernels K1, K2 and K3, in
// plain C++.
//
// Layout: a launch has G blocks (one per SM) of kBlockThreads threads.
// Block b owns the queries b, b + G, b + 2G, ... (its local queries j = 0,
// 1, ...; the scan's valid queries come first, so striding balances the
// blocks), and thread t takes its local queries t, t + T, ... . A thread
// adds its queries' point-to-plane rows (accumulate_row) to 28 float sums:
// the 21 unique entries of J^T J, J^T e and the count.
//
// The block's partial of sum k, in double: over its first n_thr threads
// (threads_used), lane l of a warp adds the threads l, l + 32, ... one
// after another (lane_sum), then the warp's fixed tree (offsets 16, 8, 4,
// 2, 1: lane 0's value, tree32). The grid's sum k: over the G blocks'
// partials the same way (lane l adds blocks l, l + 32, ..., then the tree),
// rounded to float once and expanded into J^T J, J^T e and n_valid
// (expand_sum). No float atomics: the result repeats bit for bit.
//
// The CUDA kernels (loam_kernels.cu) run the lane sums on the lanes and the
// tree with warp shuffles; fixed_sums_host.cpp runs K2's whole body, every
// block and lane emulated on one thread, so a CPU test holds the order
// against its plain version and a numpy mirror. FS_HD is
// "__host__ __device__" under nvcc and empty otherwise. Build both sides
// without multiply-add contraction.

#ifndef SIMPLESLAM_FIXED_SUMS_H_
#define SIMPLESLAM_FIXED_SUMS_H_

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define FS_HD __host__ __device__
#else
#define FS_HD
#endif

namespace fs {

constexpr int kNSums = 28;        // 21 unique J^T J, 6 J^T e, 1 count
constexpr int kBlockWarps = 16;   // warps of the one block per SM
constexpr int kBlockThreads = kBlockWarps * 32;
constexpr float kPointValid = 0.1f;

// Local queries per block, at most (every block's share of the layout).
FS_HD inline int n_local_max(int n_q, int grid) {
    return (n_q + grid - 1) / grid;
}

// Local queries of block b.
FS_HD inline int n_local(int n_q, int grid, int b) {
    return b < n_q ? (n_q - b + grid - 1) / grid : 0;
}

// The query of block b's local query j.
FS_HD inline int query(int b, int j, int grid) { return b + j * grid; }

// Threads of a block that hold a query in some block: the block partial
// adds their sums, the rest hold zeros.
FS_HD inline int threads_used(int n_q, int grid, int threads) {
    const int m = n_local_max(n_q, grid);
    return m < threads ? m : threads;
}

struct Plane {
    float cx, cy, cz, nx, ny, nz;
    bool ok;
};

// Point-to-plane row of one query against its plane: adds J J^T, J e and 1
// to acc when the row is valid (plane ok and s > POINT_VALID_THRESH).
FS_HD inline void accumulate_row(const Plane& pl, float px, float py,
                                 float pz, float sqrt_r, float* acc) {
    const float d = (px - pl.cx) * pl.nx + (py - pl.cy) * pl.ny
                  + (pz - pl.cz) * pl.nz;
    const float s = 1.0f - (0.9f * fabsf(d)) / sqrt_r;
    if (!(pl.ok && s > kPointValid)) return;
    float J[6];
    J[0] = s * pl.nx;
    J[1] = s * pl.ny;
    J[2] = s * pl.nz;
    J[3] = s * (py * pl.nz - pz * pl.ny);
    J[4] = s * (pz * pl.nx - px * pl.nz);
    J[5] = s * (px * pl.ny - py * pl.nx);
    const float e = s * d;
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j) acc[k++] += J[i] * J[j];
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[21 + i] += J[i] * e;
    acc[27] += 1.0f;
}

// Lane `lane`'s share of a sum of v[0 .. n): the terms lane, lane + 32, ...
// added one after another in double.
template <class T>
FS_HD inline double lane_sum(const T* v, int n, int lane) {
    double t = 0.0;
    for (int i = lane; i < n; i += 32) t += v[i];
    return t;
}

// Lane 0's value after the warp's tree over the 32 lanes' values v (which
// it overwrites): at offsets 16, 8, 4, 2, 1 lane l adds lane l + off.
FS_HD inline double tree32(double* v) {
    for (int off = 16; off > 0; off >>= 1)
        for (int l = 0; l < off; ++l) v[l] += v[l + off];
    return v[0];
}

// Sum t of the 28 expanded into the symmetric 6x6 J^T J (row-major), J^T e
// and the count.
FS_HD inline void expand_sum(int t, float s, float* jtj, float* jte,
                             int32_t* n_valid) {
    if (t < 21) {
        int i = 0, k = t;
        while (k >= 6 - i) { k -= 6 - i; ++i; }
        const int j = i + k;
        jtj[i * 6 + j] = s;
        jtj[j * 6 + i] = s;
    } else if (t < 27) {
        jte[t - 21] = s;
    } else {
        *n_valid = static_cast<int32_t>(s);
    }
}

}  // namespace fs

#endif  // SIMPLESLAM_FIXED_SUMS_H_
