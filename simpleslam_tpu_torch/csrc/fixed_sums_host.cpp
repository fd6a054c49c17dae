// C entry point over fixed_sums.h for the host: the body of the CUDA kernel
// K2 (plane_normal_equations_kernel in loam_kernels.cu) on G emulated
// blocks of kBlockThreads threads and their lanes, compiled with g++ so a
// CPU test can hold its layout and its fixed-order double sums against the
// plain version and a numpy mirror (native.k2_host). Build with
// -ffp-contract=off, as the kernels are built with -fmad=false.

#include <vector>

#include "fixed_sums.h"

extern "C" {

// Normal equations of n_q queries p (n_q, 3) f32 with sqrt(range) sqrt_r
// (n_q) against frozen planes centroid, normal (n_q, 3) f32 and ok (n_q)
// 0/1, on a grid of `grid` blocks: writes jtj (36), jte (6) and n_valid.
// Returns 0, or -1 for a grid below one block.
int fixed_k2_host(const float* centroid, const float* normal,
                  const uint8_t* ok, const float* p, const float* sqrt_r,
                  int n_q, int grid, float* jtj, float* jte,
                  int32_t* n_valid) {
    if (grid < 1) return -1;
    constexpr int T = fs::kBlockThreads;
    const int n_thr = fs::threads_used(n_q, grid, T);
    std::vector<double> part(static_cast<size_t>(fs::kNSums) * grid);
    std::vector<float> red(static_cast<size_t>(fs::kNSums) * n_thr);
    double lanes[32];
    for (int b = 0; b < grid; ++b) {
        const int n_local = fs::n_local(n_q, grid, b);
        // every thread's sums, staged as the kernel stages them
        for (int t = 0; t < n_thr; ++t) {
            float acc[fs::kNSums] = {0.0f};
            for (int j = t; j < n_local; j += T) {
                const int qi = fs::query(b, j, grid);
                const fs::Plane pl = {
                    centroid[3 * qi], centroid[3 * qi + 1],
                    centroid[3 * qi + 2], normal[3 * qi], normal[3 * qi + 1],
                    normal[3 * qi + 2], ok[qi] != 0};
                fs::accumulate_row(pl, p[3 * qi], p[3 * qi + 1],
                                   p[3 * qi + 2], sqrt_r[qi], acc);
            }
            for (int k = 0; k < fs::kNSums; ++k)
                red[static_cast<size_t>(k) * n_thr + t] = acc[k];
        }
        for (int k = 0; k < fs::kNSums; ++k) {
            for (int l = 0; l < 32; ++l)
                lanes[l] = fs::lane_sum(red.data() + static_cast<size_t>(k)
                                        * n_thr, n_thr, l);
            part[static_cast<size_t>(k) * grid + b] = fs::tree32(lanes);
        }
    }
    for (int k = 0; k < fs::kNSums; ++k) {
        for (int l = 0; l < 32; ++l)
            lanes[l] = fs::lane_sum(part.data() + static_cast<size_t>(k)
                                    * grid, grid, l);
        fs::expand_sum(k, static_cast<float>(fs::tree32(lanes)), jtj, jte,
                       n_valid);
    }
    return 0;
}

}  // extern "C"
