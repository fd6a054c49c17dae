// C entry points over target_gather.h for the host: the index math the CUDA
// kernel loam_gn_loop runs to find a query's candidates in a dense map or a
// sorted voxel table, compiled with g++ so a CPU test can hold it against
// the torch and JAX gathers (native.corner_rows / native.table_rows).
// Build with -ffp-contract=off, as the kernels are built with -fmad=false.

#include <algorithm>
#include <vector>

#include "target_gather.h"

namespace {
constexpr int kProbes = 512;   // the kernel's threads a block (kK3Threads)
}  // namespace

extern "C" {

// Rows of the 8 corner-block cells of each query (n_q x 8, x outermost):
// q (n_q, 3) f32, mask (n_q) 0/1, corner (3) f32.
void tg_corner_rows(const float* q, const uint8_t* mask, int n_q,
                    const float* corner, float grid, int gx, int gy, int gz,
                    int64_t* rows_out) {
    for (int i = 0; i < n_q; ++i) {
        const int bx = tg::corner_base(q[3 * i], corner[0], grid);
        const int by = tg::corner_base(q[3 * i + 1], corner[1], grid);
        const int bz = tg::corner_base(q[3 * i + 2], corner[2], grid);
        for (int k = 0; k < tg::kCornerCells; ++k)
            rows_out[i * tg::kCornerCells + k] = tg::corner_cell_row(
                bx, by, bz, k, gx, gy, gz, mask[i] != 0);
    }
}

// Table rows and found flags of the 27 cells of each query (n_q x 27), by
// nine run searches through the sampled index of the range the kernel's
// probes find before the INVALID tail, as the kernel runs them:
// q (n_q, 3) f32, mask (n_q) 0/1, origin (3) f32, keys (n_keys) ascending,
// n_keys >= 1; stride the sampling stride (0: the kernel's, from its
// budget), written back to stride_out.
void tg_table_rows(const float* q, const uint8_t* mask, int n_q,
                   const float* origin, float grid, const int32_t* keys,
                   int n_keys, int stride, int32_t* idx_out,
                   uint8_t* found_out, int32_t* stride_out) {
    // the range the kernel samples, from its block's probes, and the
    // INVALID key's exact bound (the kernel reads no INVALID cell's row)
    const int step = tg::probe_step(n_keys, kProbes);
    int below = 0;
    for (int t = 0; t < kProbes; ++t) {
        const int pos = (t + 1) * step - 1;
        below += pos < n_keys && keys[pos] < tg::kInvalidKey;
    }
    const int range = tg::valid_range_end(below, n_keys, kProbes);
    const int n_pre = static_cast<int>(
        std::lower_bound(keys, keys + n_keys, tg::kInvalidKey) - keys);
    const int s = stride > 0 ? stride
                             : tg::index_stride(range, tg::kIndexBudget);
    std::vector<int32_t> sample((range + s - 1) / s);
    for (size_t i = 0; i < sample.size(); ++i) sample[i] = keys[i * s];
    const tg::KeyIndex ix = {keys, sample.data(), range, s,
                             static_cast<int>(sample.size())};
    for (int i = 0; i < n_q; ++i) {
        const int cx = tg::voxel_coord(q[3 * i], origin[0], grid);
        const int cy = tg::voxel_coord(q[3 * i + 1], origin[1], grid);
        const int cz = tg::voxel_coord(q[3 * i + 2], origin[2], grid);
        for (int r = 0; r < tg::kTableCells / 3; ++r) {
            int idx[3];
            bool found[3];
            tg::table_run_lookup(ix, n_keys, n_pre, cx, cy, cz, r,
                                 mask[i] != 0, idx, found);
            for (int c = 0; c < 3; ++c) {
                idx_out[i * tg::kTableCells + 3 * r + c] = idx[c];
                found_out[i * tg::kTableCells + 3 * r + c] = found[c] ? 1 : 0;
            }
        }
    }
    *stride_out = s;
}

}  // extern "C"
