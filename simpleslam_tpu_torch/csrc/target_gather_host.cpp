// C entry points over target_gather.h for the host: the index math the CUDA
// kernel loam_gn_loop runs to find a query's candidates in a dense map or a
// sorted voxel table, compiled with g++ so a CPU test can hold it against
// the torch and JAX gathers (native.corner_rows / native.table_rows).
// Build with -ffp-contract=off, as the kernels are built with -fmad=false.

#include "target_gather.h"

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

// Table rows and found flags of the 27 cells of each query (n_q x 27):
// q (n_q, 3) f32, mask (n_q) 0/1, origin (3) f32, keys (n_keys) ascending.
void tg_table_rows(const float* q, const uint8_t* mask, int n_q,
                   const float* origin, float grid, const int32_t* keys,
                   int n_keys, int32_t* idx_out, uint8_t* found_out) {
    for (int i = 0; i < n_q; ++i) {
        const int cx = tg::voxel_coord(q[3 * i], origin[0], grid);
        const int cy = tg::voxel_coord(q[3 * i + 1], origin[1], grid);
        const int cz = tg::voxel_coord(q[3 * i + 2], origin[2], grid);
        for (int k = 0; k < tg::kTableCells; ++k) {
            bool found = false;
            idx_out[i * tg::kTableCells + k] = tg::table_lookup(
                keys, n_keys, tg::table_cell_key(cx, cy, cz, k, mask[i] != 0),
                &found);
            found_out[i * tg::kTableCells + k] = found ? 1 : 0;
        }
    }
}

}  // extern "C"
