// LOAM point-to-plane Gauss-Newton kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel simpleslam_tpu/ops/loam_pallas.py::_kernel
// (called through normal_equations_t): per query 5-NN by argmin rounds with
// a first-index tie-break, the 5th-NN gate, the centred 5-point scatter, the
// closed-form 3x3 eigensolve, the planar / thickness / plane-residual gates,
// the weight s = 1 - 0.9 |d| / sqrt(r) and the J row s [n, p x n], reduced
// to J^T J (6x6), J^T e (6) and the valid-row count. The TPU kernel carried
// the sums across a sequential grid; blocks here run in no order, so every
// reduction goes through per-block partial sums that are added in a fixed
// order. No float atomics anywhere: results repeat bit for bit run to run.
//
// K1 loam_fit_and_linearize_merged: the whole TPU kernel with the merged-row
//    gather folded in: each query's one int16 row of 8 voxels x M points x 3
//    (1,152 B at M = 24) is read straight from the merged voxel map and
//    dequantized on the way; the (Q, 8M, 3) candidate tensor never exists
//    in device memory. It also writes the plane set for K2. Bound: the
//    valid queries' scattered row reads (bytes). One launch on K3's layout,
//    with K3's code: a block of 16 warps per SM owns queries b, b + G, ...
//    and stages their map-frame points, sqrt(r) and validity in shared
//    memory; a K1 phase of K3 (k1_phase: each warp double-buffers its next
//    query's row with cp.async while it selects this one's five points into
//    the query's record); then one thread per query fits the plane (the
//    scalar tail), writes it out and adds the query's row (block_rows); the
//    block's partial in double in K3's fixed order, and the last block to
//    finish (an integer counter) adds all blocks' partials in K3's fixed
//    order and rounds each sum to float once (csrc/fixed_sums.h).
// K2 loam_plane_normal_equations: the TPU kernel's second half (its rows
//    after the plane fit) against a frozen plane set, one thread per query,
//    on the same layout with the same block partial and last-block finish:
//    one launch. Bound: a (Q, 10)-float stream (bytes), below the launch's
//    own floor.
// K3 loam_gn_loop: a scan's whole Gauss-Newton registration in one
//    cooperative launch, K1's and K2's work as its phases (the TPU package
//    runs the same loop as one lax.while_loop around the kernel), on any of
//    the three LOAM targets: the merged map (one int16 row per query), the
//    dense map (the corner-selected 2x2x2 block, 8 f32 rows of M points)
//    and the sorted voxel table (27 cells of M f32 points, found by key
//    search); the K1 phase is templated on that candidate source.
//    Bound: the candidate reads of its K1 phases (bytes), and the loop's
//    own floor of one grid barrier per iteration; what it removes is
//    everything between them: the launches, the 6x6 solve and pose update
//    as separate small kernels, and the host read that decided each
//    iteration. A warp's time is a chain of dependent instructions, not
//    bytes (tools/k3_breakdown.py), so the design keeps the chains short:
//    - one persistent block of 16 warps per SM; block b owns queries b,
//      b + G, ... (the scan's valid queries come first, so striding
//      balances the SMs) and keeps their source points, sqrt(r), validity,
//      fitted planes and selection records in shared memory over all
//      iterations, so a K2 phase reads nothing from device memory;
//    - a K1 phase on the table first finds the cells of all the block's
//      queries at once, one thread per z-run of three cells, through a
//      sampled index of the keys in shared memory (csrc/target_gather.h;
//      nine searches a query, most levels in shared memory), so no search
//      sits on a warp's chain;
//    - then each warp owns a valid query at a time and double-buffers its
//      candidates with cp.async: the next query's row (or 8 dense rows,
//      four lanes a row, or its found cells' set points, one lane a cell)
//      is in flight while this one's selection runs. The selection
//      (csrc/select5.h) sorts each lane's candidates once and takes five
//      rounds of two warp reductions over the lanes' heads; it leaves the
//      query's gate and its five points in the query's record, and no
//      more: the scalar tail is not repeated on 32 lanes;
//    - every iteration, thread t then takes the block's queries t, t + T,
//      ...: in a K1 phase it fits each record's plane (centroid, 3x3
//      eigensolve, gates: the scalar tail, one query a thread, once per
//      query), in a K2 phase it reads the kept plane, and adds the query's
//      row to its sums;
//    - the block's sums, in double: every thread's sums staged in shared
//      memory, warp w adds sums w and w + 16, lanes over the threads in
//      order, then the warp's fixed tree (csrc/fixed_sums.h); the partials
//      go to device memory;
//    - one grid barrier per iteration (an integer counter, a release add
//      and acquire loads); then every block adds all blocks' partials the
//      same way (warp per sum, lanes over the blocks in order, all loads
//      first, then the tree), rounds each sum to float once and takes the
//      small step (csrc/gn_step.h) on one thread. Every block computes
//      the same step from the same numbers, so all agree on every branch
//      around the barrier; partials alternate between two buffers so a
//      fast block cannot overwrite what a slow one still reads.
//    Numerics: the per-query arithmetic and the plane set are those of the
//    plain version, op for op; the rows' f32 products are summed in double
//    in a fixed order and rounded to float once, where the kernel before
//    this layout summed in float (a tree over each warp, then the warps,
//    then the blocks one after another), so K3's result rows part from
//    that kernel's at rounding size, and repeat bit for bit from launch to
//    launch.

// K4 loam_fit_and_linearize_candidates: the TPU kernel in its own form,
//    candidates in, normal equations out: (Q, C, 3) f32 candidates and
//    (Q, C) flags in device memory, C <= 256 (the sharded path's form, and
//    the gather + K4 of K3's plain version on a dense or table target).
//    Bound: the candidate stream (bytes): the C flags of every valid query
//    and 12 bytes of coordinates for every set flag. Design:
//    - a warp walks its queries (valid ones first, masked-out ones written
//      as the zero plane before any load), one query at a time, through a
//      three-stage cp.async pipeline in shared memory: the flags of the
//      query after next, the coordinates of the next query (only the
//      16-byte chunks that hold a set flag), and the selection of this
//      one, so two queries' loads are in flight behind every selection;
//    - the selection is the warp's sorted-lane rounds (csrc/select5.h), as
//      in K1 and K3; the five chosen points go to a per-warp record, and the
//      scalar tail
//      (centroid, eigensolve, gates, J row, accumulate) runs one lane per
//      query over up to 32 records at once;
//    - one launch: the last block to finish (an integer counter) adds all
//      block partials in block order and writes J^T J, J^T e and n_valid.

// Arithmetic follows the plain PyTorch versions in ops/loam_kernels.py and
// ops/loam.py op for op. The library is built with -fmad=false so no
// multiply-add is contracted behind the source's back; the one fused
// multiply-add that the plain version also performs (the int16
// dequantization, torch.addcmul) is an explicit fmaf.
//
// Plain C interface for ctypes; every entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <mutex>

#include "fixed_sums.h"
#include "gn_step.h"
#include "select5.h"
#include "target_gather.h"

namespace {

using fs::Plane;
using fs::accumulate_row;
using fs::expand_sum;

constexpr int kPlanePts = 5;
constexpr float kMaxSearchSq = 1.0f;
constexpr float kPlaneValid = 0.2f;
constexpr float kMinPlanarEv = 1e-2f;
constexpr float kMaxThicknessEv = 2e-2f;
constexpr int16_t kPadQ = 32767;
constexpr float kQOff = 16384.0f;
constexpr int kNSums = fs::kNSums;   // 21 unique J^T J, 6 J^T e, 1 count
constexpr int kMaxCand = 256;   // 8 candidates per lane
constexpr int kCandPerLane = kMaxCand / 32;
constexpr int kK3Warps = fs::kBlockWarps;   // warps of the one block per SM
constexpr int kK3Threads = fs::kBlockThreads;
constexpr int kRowBufElems = kMaxCand * 3;   // int16 per staged row
constexpr int kPartStride = 32;  // K3's block partial: 28 sums, r_max, pad
                                 // (doubles)
constexpr int kRecFloats = 15;   // K3 record: the five selected points
constexpr int kQueryFloats = 10 + kRecFloats;  // p_src, sqrt_r, plane, record
constexpr int kF32BufBytes = kMaxCand * 3 * 4;   // f32 candidates per buffer
constexpr int kCellMeta = 32;   // ints per staged table buffer: 27 counts
constexpr int kIndexBudgetInts = tg::kIndexBudget;   // K3's sampled keys
static_assert(kIndexBudgetInts % kK3Threads == 0, "whole sample loads");
constexpr float kPadHalf = 0.5f * 1.0e6f;   // 0.5 * pointcloud.PAD_COORD
constexpr int kK4Warps = 4;     // warps per K4 block
constexpr int kK4Threads = kK4Warps * 32;
// K4's grid: about this many queries per warp (the fastest of 1, 2, 4, 8,
// 16, 32 on the card; tools/k4_breakdown.py builds the others with
// -DLOAM_K4_QPW=n to time them)
#ifndef LOAM_K4_QPW
#define LOAM_K4_QPW 4
#endif
constexpr int kK4QueriesPerWarp = LOAM_K4_QPW;
constexpr int kK4FlagSlots = 3;
constexpr int kK4Rec = 21;      // tail record: x[5] y[5] z[5] p[3] sqrt_r q meta
// how K4 copies a query's flags and coordinates (bits of `copy`)
constexpr int kCopyFlags16 = 1;   // flags in 16-byte cp.async chunks
constexpr int kCopyFlags4 = 2;    // flags in 4-byte cp.async words
constexpr int kCopyCoords16 = 4;  // coordinates in 16-byte chunks, else 4

// The merged voxel map as the kernels read it.
struct MapGeom {
    const int16_t* rows;
    int n_cand;
    float scale, grid, cx0, cy0, cz0;
    int mx, my, mz;
};

__device__ __forceinline__ MapGeom load_geom(
        const int16_t* rows, int n_cand, const float* scale_p,
        const float* corner_p, const float* grid_p, int gx, int gy, int gz) {
    MapGeom g;
    g.rows = rows;
    g.n_cand = n_cand;
    g.scale = *scale_p;
    g.grid = *grid_p;
    g.cx0 = corner_p[0];
    g.cy0 = corner_p[1];
    g.cz0 = corner_p[2];
    g.mx = gx + 1;
    g.my = gy + 1;
    g.mz = gz + 1;
    return g;
}

// Eigenvalues of the symmetric scatter (ascending) and the unit eigenvector
// of the smallest: ops/linalg3.py symeig3x3_values + _eigvec_for.
__device__ void symeig3x3_smallest(float m00, float m01, float m02, float m11,
                                   float m12, float m22, float* lam,
                                   float* v) {
    const float p1 = m01 * m01 + m02 * m02 + m12 * m12;
    const float q = (m00 + m11 + m22) / 3.0f;
    const float d0 = m00 - q, d1 = m11 - q, d2 = m22 - q;
    const float p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0f * p1;
    const bool diag_case = p2 <= 1e-24f;
    const float p = sqrtf((diag_case ? 1.0f : p2) / 6.0f);
    const float b00 = (m00 - q) / p, b11 = (m11 - q) / p, b22 = (m22 - q) / p;
    const float b01 = m01 / p, b02 = m02 / p, b12 = m12 / p;
    const float det_b = b00 * (b11 * b22 - b12 * b12)
                      - b01 * (b01 * b22 - b12 * b02)
                      + b02 * (b01 * b12 - b11 * b02);
    const float r = fminf(fmaxf(det_b / 2.0f, -1.0f), 1.0f);
    const float phi = acosf(r) / 3.0f;
    const float e_hi = q + 2.0f * p * cosf(phi);
    const float e_lo = q + 2.0f * p * cosf(phi + 2.0943951023931953f);
    const float e_mid = 3.0f * q - e_hi - e_lo;
    lam[0] = diag_case ? q : e_lo;
    lam[1] = diag_case ? q : e_mid;
    lam[2] = diag_case ? q : e_hi;
    // columns of (M - lam1 I)(M - lam2 I); the longest (first on ties)
    // spans the eigenspace of lam0
    const float a00 = m00 - lam[1], a11 = m11 - lam[1], a22 = m22 - lam[1];
    const float c00 = m00 - lam[2], c11 = m11 - lam[2], c22 = m22 - lam[2];
    const float p00 = a00 * c00 + m01 * m01 + m02 * m02;
    const float p10 = m01 * c00 + a11 * m01 + m12 * m02;
    const float p20 = m02 * c00 + m12 * m01 + a22 * m02;
    const float p01 = a00 * m01 + m01 * c11 + m02 * m12;
    const float p11 = m01 * m01 + a11 * c11 + m12 * m12;
    const float p21 = m02 * m01 + m12 * c11 + a22 * m12;
    const float p02 = a00 * m02 + m01 * m12 + m02 * c22;
    const float p12 = m01 * m02 + a11 * m12 + m12 * c22;
    const float p22 = m02 * m02 + m12 * m12 + a22 * c22;
    const float n0 = sqrtf(p00 * p00 + p10 * p10 + p20 * p20);
    const float n1 = sqrtf(p01 * p01 + p11 * p11 + p21 * p21);
    const float n2 = sqrtf(p02 * p02 + p12 * p12 + p22 * p22);
    const bool best0 = (n0 >= n1) && (n0 >= n2);
    const bool best1 = !best0 && (n1 >= n2);
    const float vx = best0 ? p00 : (best1 ? p01 : p02);
    const float vy = best0 ? p10 : (best1 ? p11 : p12);
    const float vz = best0 ? p20 : (best1 ? p21 : p22);
    const float vn = fmaxf(sqrtf(vx * vx + vy * vy + vz * vz), 1e-20f);
    v[0] = vx / vn;
    v[1] = vy / vn;
    v[2] = vz / vn;
}

// Fixed-order tree sum over the warp; lane 0 holds the result.
__device__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        x += __shfl_down_sync(0xffffffffu, x, off);
    return x;
}

__device__ __forceinline__ float dequant(int16_t q, float scale, float corner) {
    return fmaf(static_cast<float>(q) + kQOff, scale, corner);
}

// The query's one merged row: the corner-selected 2x2x2 block at row base + 1
// (voxel.gather_neighbors_merged); the all-padding sentinel row for a query
// outside the window. A masked-out query reads no row.
__device__ __forceinline__ const int16_t* merged_row(
        const MapGeom& g, float px, float py, float pz) {
    const int bx = static_cast<int>(floorf((px - g.cx0) / g.grid - 0.5f)) + 1;
    const int by = static_cast<int>(floorf((py - g.cy0) / g.grid - 0.5f)) + 1;
    const int bz = static_cast<int>(floorf((pz - g.cz0) / g.grid - 0.5f)) + 1;
    const bool in = bx >= 0 && bx < g.mx && by >= 0 && by < g.my
                    && bz >= 0 && bz < g.mz;
    const int64_t flat = in
        ? (static_cast<int64_t>(bx) * g.my + by) * g.mz + bz
        : static_cast<int64_t>(g.mx) * g.my * g.mz;
    return g.rows + flat * static_cast<int64_t>(g.n_cand) * 3;
}

// Where a query's candidates come from: get(c, x, y, z) gives candidate c in
// f32 metres, or false where it is padding.
//
// A staged int16 merged row (shared memory), dequantized on the way.
struct QuantRow {
    const int16_t* srow;
    float scale, cx0, cy0, cz0;
    __device__ __forceinline__ bool get(int c, float& x, float& y,
                                        float& z) const {
        if (srow[3 * c] == kPadQ) return false;
        x = dequant(srow[3 * c], scale, cx0);
        y = dequant(srow[3 * c + 1], scale, cy0);
        z = dequant(srow[3 * c + 2], scale, cz0);
        return true;
    }
};

// K3's staged dense rows (shared memory): padding where x is PAD_COORD, as
// voxel._rows_to_points reads it.
struct StagedRows {
    const float* s;
    __device__ __forceinline__ bool get(int c, float& x, float& y,
                                        float& z) const {
        const float x0 = s[3 * c];
        if (!(x0 < kPadHalf)) return false;
        x = x0;
        y = s[3 * c + 1];
        z = s[3 * c + 2];
        return true;
    }
};

// K3's staged table cells (shared memory): cell c / m holds cnt[c / m] set
// points (0 where its key was not found), as voxel.gather_neighbors reads
// them; the rest of a cell was not copied. c / m is (c * m_recip) >> 16,
// m_recip = ceil(2^16 / m), exact for c < 256 and m <= 9.
struct StagedCells {
    const float* s;
    const int* cnt;
    int m, m_recip;
    __device__ __forceinline__ bool get(int c, float& x, float& y,
                                        float& z) const {
        const int cell = (c * m_recip) >> 16;
        if (c - cell * m >= cnt[cell]) return false;
        x = s[3 * c];
        y = s[3 * c + 1];
        z = s[3 * c + 2];
        return true;
    }
};

// K4's staged candidates (shared memory): the query's C flags, and the
// coordinates of the chunks that hold a set one.
struct StagedCand {
    const float* co;
    const uint8_t* fl;
    __device__ __forceinline__ bool get(int c, float& x, float& y,
                                        float& z) const {
        if (!fl[c]) return false;
        x = co[3 * c];
        y = co[3 * c + 1];
        z = co[3 * c + 2];
        return true;
    }
};

// The selection rounds of select5.h on one warp: this lane's sorted
// candidates, the rounds' two reductions by the hardware.
template <int S>
struct WarpRounds {
    s5::Lane<S> lane;
    S5_HD unsigned min_d2() const {
#ifdef __CUDA_ARCH__
        return __reduce_min_sync(0xffffffffu, lane.head_d2());
#else
        return 0u;
#endif
    }
    S5_HD unsigned min_index(unsigned m) const {
#ifdef __CUDA_ARCH__
        return __reduce_min_sync(
            0xffffffffu, lane.head_d2() == m ? lane.head_index() : s5::kNoIndex);
#else
        return m;
#endif
    }
    S5_HD void drop(unsigned c) { lane.drop_if(lane.head_index() == c); }
};

// The five nearest candidates of one query, by one warp (csrc/select5.h):
// sel[] in candidate-index order, -1 where fewer than five are set (the
// same on every lane); returns the 5-NN gate.
template <int kSlots, class Cand>
__device__ __forceinline__ bool select5(const Cand& cd, int n_cand,
                                        bool valid, float px, float py,
                                        float pz, int lane, int* sel) {
    // squared distances of this lane's candidates c = lane + 32 j
    float d2[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
        const int c = lane + 32 * j;
        d2[j] = CUDART_INF_F;
        float cx, cy, cz;
        if (c < n_cand && cd.get(c, cx, cy, cz))
            d2[j] = s5::dist2(cx, cy, cz, px, py, pz);
    }
    WarpRounds<kSlots> w;
    w.lane.init(d2, lane);
    return s5::rounds(w, valid, kMaxSearchSq, sel);
}

// Each lane owns candidates lane, lane + 32, ...: 6 of them at the usual 192
// candidates per query (8 voxels x 24), 7 at a table's 216 (27 cells x 8),
// 8 at the most (kMaxCand).
template <class Cand>
__device__ __forceinline__ bool select5_any(const Cand& cd, int n_cand,
                                            bool valid, float px, float py,
                                            float pz, int lane, int* sel) {
    if (n_cand <= 6 * 32)
        return select5<6>(cd, n_cand, valid, px, py, pz, lane, sel);
    if (n_cand <= 7 * 32)
        return select5<7>(cd, n_cand, valid, px, py, pz, lane, sel);
    return select5<kCandPerLane>(cd, n_cand, valid, px, py, pz, lane, sel);
}

// Plane fit and gates of the selected points (bit k of `present` set where
// point k exists; absent points are 0 and take no part), on one thread.
__device__ __forceinline__ Plane fit_plane5(const float* x, const float* y,
                                            const float* z, unsigned present,
                                            bool gate) {
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
#pragma unroll
    for (int k = 0; k < kPlanePts; ++k) {
        if ((present >> k) & 1u) { sx += x[k]; sy += y[k]; sz += z[k]; }
    }
    Plane pl;
    pl.cx = sx / 5.0f;
    pl.cy = sy / 5.0f;
    pl.cz = sz / 5.0f;
    float m00 = 0.f, m01 = 0.f, m02 = 0.f, m11 = 0.f, m12 = 0.f, m22 = 0.f;
#pragma unroll
    for (int k = 0; k < kPlanePts; ++k) {
        if (!((present >> k) & 1u)) continue;
        const float bx_ = x[k] - pl.cx, by_ = y[k] - pl.cy, bz_ = z[k] - pl.cz;
        m00 += bx_ * bx_; m01 += bx_ * by_; m02 += bx_ * bz_;
        m11 += by_ * by_; m12 += by_ * bz_; m22 += bz_ * bz_;
    }
    float lam[3], n[3];
    symeig3x3_smallest(m00, m01, m02, m11, m12, m22, lam, n);
    pl.nx = n[0]; pl.ny = n[1]; pl.nz = n[2];
    const bool fit_ok = lam[1] > kMinPlanarEv && lam[0] < kMaxThicknessEv;
    float rmax = 0.0f;
#pragma unroll
    for (int k = 0; k < kPlanePts; ++k) {
        if (!((present >> k) & 1u)) continue;
        const float r = (x[k] - pl.cx) * pl.nx + (y[k] - pl.cy) * pl.ny
                      + (z[k] - pl.cz) * pl.nz;
        rmax = fmaxf(rmax, fabsf(r));
    }
    pl.ok = gate && fit_ok && rmax <= kPlaneValid;
    return pl;
}

// The block's sums of every thread's acc[kNSums]: a fixed-order tree over
// each warp, then the warps in order. Thread t < kNSums returns sum t.
template <int kWarps>
__device__ float block_sums(const float* acc, float (*s_acc)[kNSums]) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < kNSums; ++k) {
        const float t = warp_sum(acc[k]);
        if (lane == 0) s_acc[warp][k] = t;
    }
    __syncthreads();
    float t = 0.0f;
    if (threadIdx.x < kNSums)
        for (int w = 0; w < kWarps; ++w) t += s_acc[w][threadIdx.x];
    return t;
}

// ---------------------------------------------------------------------------
// K3: the whole GN loop of one scan in one cooperative launch
// ---------------------------------------------------------------------------

// Where a K3 warp spends its time, for tools/k3_breakdown.py: built with
// -DLOAM_K3_CLOCKS, every warp adds SM clock cycles per segment and lane 0
// writes them into k3_clocks[warp of the grid][kK3ClockSlots] at the end,
// with the queries it selected, its SM and its start and end on the global
// timer; -DLOAM_K1_CLOCKS does the same for K1 into k1_clocks
// (tools/k1_breakdown.py: stage, wait, select, tail, block sums, and the
// last block's sums in the partials slot). The normal build has none of it.
constexpr int kK3ClockSlots = 18;
enum K3Clock {
    kClkPrologue, kClkWait, kClkSearch, kClkStage, kClkSelect, kClkTail,
    kClkRow, kClkK2, kClkBlockSums, kClkBarrier, kClkPartials, kClkStep,
    kClkEpilogue, kClkQueries, kClkSm, kClkT0, kClkT1, kClkIters
};
#ifdef LOAM_K3_CLOCKS
__device__ long long* k3_clocks;
#endif
#ifdef LOAM_K1_CLOCKS
__device__ long long* k1_clocks;
#endif
#if defined(LOAM_K3_CLOCKS) || defined(LOAM_K1_CLOCKS)
#define K3_CLOCK_START(seg) long long k3c_##seg = clock64()
#define K3_CLOCK_ADD(seg, slot) k3_acc[slot] += clock64() - k3c_##seg
#define K3_CLOCK_COUNT(slot) ++k3_acc[slot]
// a kernel's segments and its start; a device function that adds to its
// caller's segments takes them as k3_acc
#define K3_CLOCK_DECL                               \
    long long k3_acc[kK3ClockSlots] = {0};          \
    const unsigned long long k3_t0 = clock_t0()
#define K3_CLOCK_PARAM , long long* k3_acc
#define K3_CLOCK_ARG , k3_acc
#else
#define K3_CLOCK_START(seg)
#define K3_CLOCK_ADD(seg, slot)
#define K3_CLOCK_COUNT(slot)
#define K3_CLOCK_DECL
#define K3_CLOCK_PARAM
#define K3_CLOCK_ARG
#endif

// The warp's start on the global timer, and at the end its segments, SM,
// start and end into row `row` of `clocks` (lane 0), in a clock build.
#if defined(LOAM_K3_CLOCKS) || defined(LOAM_K1_CLOCKS)
__device__ __forceinline__ unsigned long long clock_t0() {
    unsigned long long t0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    return t0;
}

__device__ __forceinline__ void clock_write(long long* clocks, long long row,
                                            const long long* k3_acc,
                                            unsigned long long t0, int iters) {
    if ((threadIdx.x & 31) != 0) return;
    unsigned long long t1;
    unsigned smid;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    long long* o = clocks + row * kK3ClockSlots;
    for (int k = 0; k < kClkSm; ++k) o[k] = k3_acc[k];
    o[kClkSm] = static_cast<long long>(smid);
    o[kClkT0] = static_cast<long long>(t0);
    o[kClkT1] = static_cast<long long>(t1);
    o[kClkIters] = iters;
}
#endif

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src) : "memory");
}

// 4 bytes, for sources whose rows are not 16-byte aligned.
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src) {
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one of this thread's copy groups is still in flight.
__device__ __forceinline__ void cp_async_wait_but_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Wait until all of this thread's copy groups have landed.
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

// Grid-wide barrier on a counter that only grows during a launch: every
// block arrives once, then waits until `target` (blocks x barriers so far)
// arrivals are in. All blocks must be co-resident (cooperative launch).
// The block's writes before it are ordered by __syncthreads and thread 0's
// release add (cumulative); another block's acquire load and
// __syncthreads order its reads after: no full fence on either side.
__device__ __forceinline__ void grid_barrier(unsigned* counter,
                                             unsigned target) {
    __syncthreads();
    if (threadIdx.x == 0) {
        asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                     :: "l"(counter) : "memory");
        while (ld_acquire(counter) < target) {}
    }
    __syncthreads();
}

// The last block to leave zeroes both counters for the next launch on the
// stream. Every block has passed its last barrier wait by then.
__device__ __forceinline__ void grid_barrier_release(unsigned* counters) {
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned left = atomicAdd(&counters[1], 1u);
        if (left == gridDim.x - 1) {
            counters[0] = 0u;
            counters[1] = 0u;
            __threadfence();
        }
    }
}

__device__ __forceinline__ void transform_point(const float* pose, float x,
                                                float y, float z, float* p) {
    p[0] = pose[0] * x + pose[1] * y + pose[2] * z + pose[9];
    p[1] = pose[3] * x + pose[4] * y + pose[5] * z + pose[10];
    p[2] = pose[6] * x + pose[7] * y + pose[8] * z + pose[11];
}

// K3's candidate sources. Each is the launch's parameters (plain pointers
// and sizes, filled on the host) with load() reading the map's device
// scalars into the source a K1 phase uses. prepare() runs once per launch
// on every thread, locate() once per K1 phase on every thread (a table's
// key searches, for all the block's queries at once); stage() puts query
// j's candidates into a buffer of kBufBytes (and kMetaInts ints) of shared
// memory with cp.async, on one warp; cand() reads them for the selection.
//
// The merged map: one int16 row per query (K1's source).
struct MergedSrc {
    MapGeom g;
    int row_chunks;   // 16-byte chunks per row
    __device__ __forceinline__ int32_t first_probe() const { return 0; }
    __device__ __forceinline__ void prepare(int*, int32_t) const {}
    __device__ __forceinline__ void locate(const float*, const float*,
                                           const float*, const float*,
                                           const uint8_t*, int, int*,
                                           const int*) const {}
    __device__ __forceinline__ void stage(int, float px, float py, float pz,
                                          unsigned char* buf, int*,
                                          const int*, int lane) const {
        const int4* src = reinterpret_cast<const int4*>(
            merged_row(g, px, py, pz));
        int4* dst = reinterpret_cast<int4*>(buf);
        for (int k = lane; k < row_chunks; k += 32) cp_async16(dst + k, src + k);
    }
    __device__ __forceinline__ QuantRow cand(const unsigned char* buf,
                                             const int*) const {
        return {reinterpret_cast<const int16_t*>(buf), g.scale, g.cx0, g.cy0,
                g.cz0};
    }
    __device__ __forceinline__ int n_cand() const { return g.n_cand; }
};

struct MergedParams {
    static constexpr int kBufBytes = kRowBufElems * 2;
    static constexpr int kMetaInts = 0;
    static constexpr int kIndexInts = 0;
    static constexpr int kCellInts = 0;
    const int16_t* rows;
    int n_cand;
    const float* scale;
    const float* corner;
    const float* grid;
    int gx, gy, gz;
    __device__ __forceinline__ MergedSrc load() const {
        return {load_geom(rows, n_cand, scale, corner, grid, gx, gy, gz),
                n_cand * 3 * 2 / 16};
    }
};

// The dense map: the 8 rows of the corner-selected 2x2x2 block
// (voxel.gather_neighbors_corner), M f32 points each, padding PAD_COORD.
struct DenseSrc {
    const float* slab;
    int m, gx, gy, gz;
    float cx0, cy0, cz0, grid;
    bool vec16;   // rows 16-byte aligned: copy in 16-byte chunks
    __device__ __forceinline__ int32_t first_probe() const { return 0; }
    __device__ __forceinline__ void prepare(int*, int32_t) const {}
    __device__ __forceinline__ void locate(const float*, const float*,
                                           const float*, const float*,
                                           const uint8_t*, int, int*,
                                           const int*) const {}
    __device__ __forceinline__ void stage(int, float px, float py, float pz,
                                          unsigned char* buf, int*,
                                          const int*, int lane) const {
        const int bx = tg::corner_base(px, cx0, grid);
        const int by = tg::corner_base(py, cy0, grid);
        const int bz = tg::corner_base(pz, cz0, grid);
        // four lanes a row: each lane finds its row once and copies every
        // fourth unit of it
        constexpr int kLanesPerRow = 32 / tg::kCornerCells;
        const int k = lane / kLanesPerRow, sub = lane % kLanesPerRow;
        const int row_floats = 3 * m;
        const float* src = slab
            + tg::corner_cell_row(bx, by, bz, k, gx, gy, gz, true) * row_floats;
        float* dst = reinterpret_cast<float*>(buf) + k * row_floats;
        if (vec16) {
            for (int c = sub; 4 * c < row_floats; c += kLanesPerRow)
                cp_async16(dst + 4 * c, src + 4 * c);
        } else {
            for (int c = sub; c < row_floats; c += kLanesPerRow)
                cp_async4(dst + c, src + c);
        }
    }
    __device__ __forceinline__ StagedRows cand(const unsigned char* buf,
                                               const int*) const {
        return {reinterpret_cast<const float*>(buf)};
    }
    __device__ __forceinline__ int n_cand() const {
        return tg::kCornerCells * m;
    }
};

struct DenseParams {
    static constexpr int kBufBytes = kF32BufBytes;
    static constexpr int kMetaInts = 0;
    static constexpr int kIndexInts = 0;
    static constexpr int kCellInts = 0;
    const float* slab;
    int m;
    const float* corner;
    const float* grid;
    int gx, gy, gz, vec16;
    __device__ __forceinline__ DenseSrc load() const {
        return {slab, m, gx, gy, gz, corner[0], corner[1], corner[2], *grid,
                vec16 != 0};
    }
};

// The sorted voxel table: the 27 cells around the query's voxel, x
// outermost (voxel.gather_neighbors with radius 1). Once per launch the
// block bounds the keys below the INVALID tail (every thread probes one key,
// evenly spaced; the count below INVALID puts the tail's start within one
// spacing) and copies every s-th key of the range before that into shared
// memory (the sampled index of csrc/target_gather.h); once
// per K1 phase its threads find the cells of all its valid queries, one
// thread per z-run of three cells (nine searches a query, most levels in
// shared memory), and keep each cell's row and count (row * 16 + count, 0
// where not found). A warp's stage() then only copies, one lane per cell:
// a found cell's set points, and its count.
struct TableSrc {
    // after the sampled index in shared memory: the keys it covers, the
    // sampling stride and the samples
    static constexpr int kRange = kIndexBudgetInts, kStride = kRange + 1,
                         kSamples = kRange + 2;
    const int32_t* keys;
    const float* slab;
    const int32_t* counts;
    int n_keys, m;
    float ox, oy, oz, grid;
    bool vec16;
    // this thread's probe of the keys (tg::valid_range_end), loaded before
    // the prologue's other loads; INT32_MAX past the end
    __device__ __forceinline__ int32_t first_probe() const {
        const int pos = (threadIdx.x + 1) * tg::probe_step(n_keys, blockDim.x)
                        - 1;
        return pos < n_keys ? __ldg(keys + pos) : INT32_MAX;
    }
    __device__ __forceinline__ void prepare(int* s_index,
                                            int32_t probe) const {
        const int hi = tg::valid_range_end(
            __syncthreads_count(probe < tg::kInvalidKey), n_keys, blockDim.x);
        const int st = tg::index_stride(hi, tg::kIndexBudget);
        const int n_s = (hi + st - 1) / st;
        // all of a thread's loads first (kK3Threads * kSampleLoads >= the
        // budget), then the stores
        constexpr int kSampleLoads = kIndexBudgetInts / kK3Threads;
        int v[kSampleLoads];
#pragma unroll
        for (int u = 0; u < kSampleLoads; ++u) {
            const int i = threadIdx.x + u * kK3Threads;
            v[u] = i < n_s ? __ldg(keys + static_cast<int64_t>(i) * st) : 0;
        }
#pragma unroll
        for (int u = 0; u < kSampleLoads; ++u) {
            const int i = threadIdx.x + u * kK3Threads;
            if (i < n_s) s_index[i] = v[u];
        }
        if (threadIdx.x == 0) {
            s_index[kRange] = hi;
            s_index[kStride] = st;
            s_index[kSamples] = n_s;
        }
    }
    __device__ __forceinline__ void locate(const float* pose, const float* x,
                                           const float* y, const float* z,
                                           const uint8_t* valid, int n_local,
                                           int* cells,
                                           const int* s_index) const {
        const tg::KeyIndex ix = {keys, s_index, s_index[kRange],
                                 s_index[kStride], s_index[kSamples]};
        constexpr int kRuns = tg::kTableCells / 3;
        for (int i = threadIdx.x; i < n_local * kRuns; i += blockDim.x) {
            const int j = i / kRuns, r = i - j * kRuns;
            if (!valid[j]) continue;
            float p[3];
            transform_point(pose, x[j], y[j], z[j], p);
            int idx[3];
            bool found[3];
            // an INVALID cell is never found, and its row is never read:
            // the end of the sampled range stands in for its bound
            tg::table_run_lookup(ix, n_keys, ix.n,
                                 tg::voxel_coord(p[0], ox, grid),
                                 tg::voxel_coord(p[1], oy, grid),
                                 tg::voxel_coord(p[2], oz, grid), r, true,
                                 idx, found);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const int cnt = found[c] ? min(__ldg(counts + idx[c]), m) : 0;
                cells[j * tg::kTableCells + 3 * r + c] =
                    cnt > 0 ? idx[c] * 16 + cnt : 0;
            }
        }
    }
    __device__ __forceinline__ void stage(int j, float, float, float,
                                          unsigned char* buf, int* cnt_out,
                                          const int* cells, int lane) const {
        if (lane >= tg::kTableCells) return;
        const int v = cells[j * tg::kTableCells + lane];
        const int cnt = v & 15;
        cnt_out[lane] = cnt;
        const int row_floats = 3 * m;
        const float* src = slab + static_cast<int64_t>(v >> 4) * row_floats;
        float* dst = reinterpret_cast<float*>(buf) + lane * row_floats;
        if (vec16) {
            // the 16-byte chunks that hold the cell's cnt set points
            for (int c = 0; 4 * c < 3 * cnt; ++c)
                cp_async16(dst + 4 * c, src + 4 * c);
        } else {
            for (int w = 0; w < 3 * cnt; ++w) cp_async4(dst + w, src + w);
        }
    }
    __device__ __forceinline__ StagedCells cand(const unsigned char* buf,
                                                const int* cnt) const {
        return {reinterpret_cast<const float*>(buf), cnt, m,
                (65536 + m - 1) / m};
    }
    __device__ __forceinline__ int n_cand() const {
        return tg::kTableCells * m;
    }
};

struct TableParams {
    static constexpr int kBufBytes = kF32BufBytes;
    static constexpr int kMetaInts = kCellMeta;
    static constexpr int kIndexInts = TableSrc::kSamples + 1;
    static constexpr int kCellInts = tg::kTableCells;
    const int32_t* keys;
    int n_keys;
    const float* slab;
    const int32_t* counts;
    int m;
    const float* origin;
    const float* grid;
    int vec16;
    __device__ __forceinline__ TableSrc load() const {
        return {keys, slab, counts, n_keys, m, origin[0], origin[1],
                origin[2], *grid, vec16 != 0};
    }
};

// Dynamic shared memory of K3 (and K1, on the merged map's source): the
// warps' double candidate buffers (and their cell counts), the table's
// sampled index and the cells of the block's queries, the staged row sums
// of the block's threads, then the block's per-query state: source point,
// sqrt(r), plane (6 floats), the selected points' record (15 floats), ok
// and validity.
__host__ __device__ inline size_t gn_loop_smem_bytes(
        int n_q, int grid, int buf_bytes, int meta_ints, int index_ints,
        int cell_ints) {
    const size_t n_local = static_cast<size_t>(fs::n_local_max(n_q, grid));
    const size_t n_thr = fs::threads_used(n_q, grid, kK3Threads);
    return static_cast<size_t>(kK3Warps) * 2 * buf_bytes
         + sizeof(int) * (kK3Warps * 2 * meta_ints + index_ints
                          + cell_ints * n_local)
         + sizeof(float) * (kNSums * n_thr + kQueryFloats * n_local)
         + 2 * n_local;
}

// That memory cut into its parts, for n_local_max queries a block and n_thr
// threads with sums.
template <class Params>
struct BlockSmem {
    unsigned char* bufs;
    int *meta, *index, *cells;
    float *red, *x, *y, *z, *sqrt_r, *plane, *rec;
    uint8_t *ok, *valid;
    __device__ __forceinline__ BlockSmem(unsigned char* raw, int n_local_max,
                                         int n_thr) {
        bufs = raw;
        meta = reinterpret_cast<int*>(bufs + kK3Warps * 2 * Params::kBufBytes);
        index = meta + kK3Warps * 2 * Params::kMetaInts;
        cells = index + Params::kIndexInts;
        red = reinterpret_cast<float*>(cells + Params::kCellInts * n_local_max);
        x = red + kNSums * n_thr;
        y = x + n_local_max;
        z = y + n_local_max;
        sqrt_r = z + n_local_max;
        plane = sqrt_r + n_local_max;        // 6 floats per query
        rec = plane + 6 * n_local_max;       // kRecFloats per query
        ok = reinterpret_cast<uint8_t*>(rec + kRecFloats * n_local_max);
        valid = ok + n_local_max;
    }
};

// Fixed-order tree sum over the warp in double; lane 0 holds the result
// (fs::tree32 on the host).
__device__ __forceinline__ double warp_sum_d(double x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        x += __shfl_down_sync(0xffffffffu, x, off);
    return x;
}

// The block's 28 sums over its threads t < n_thr, in a fixed order and in
// double, and the block's partial written for the grid: thread t stores its
// acc[] in s_red[k][t]; warp w adds sums k = w, w + W, ...: lane l the
// threads l, l + 32, ... one after another, then the warp's fixed tree
// (csrc/fixed_sums.h). Slot kNSums of the partial is the block's largest
// valid range. Every thread calls it.
__device__ __forceinline__ void k3_block_partial(const float* acc,
                                                 float* s_red, int n_thr,
                                                 float block_rmax,
                                                 double* part) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (static_cast<int>(threadIdx.x) < n_thr) {
#pragma unroll
        for (int k = 0; k < kNSums; ++k) s_red[k * n_thr + threadIdx.x] = acc[k];
    }
    __syncthreads();
    const int nb = gridDim.x;
    for (int k = warp; k <= kNSums; k += kK3Warps) {
        double t = 0.0;
        if (k < kNSums) {
            t = warp_sum_d(fs::lane_sum(s_red + k * n_thr, n_thr, lane));
        } else {
            t = block_rmax;
        }
        if (lane == 0) part[k * nb + blockIdx.x] = t;
    }
}

// The grid's sums of all blocks' partials (sum k of block b at k * G + b),
// in a fixed order and in double, rounded to float once: warp w takes sums
// w and w + W (slot kNSums is the largest range): lane l the blocks l,
// l + 32, ... one after another (all loads of both sums first), then the
// warp's fixed tree. Lane 0 writes s_sum[k].
__device__ __forceinline__ void k3_grid_sums(const double* part,
                                             float* s_sum) {
    static_assert(2 * kK3Warps > kNSums, "two sums a warp");
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nb = gridDim.x;
    constexpr int kLoads = 5;   // 160 blocks a pass
    const int k1 = warp + kK3Warps;
    const bool two = k1 <= kNSums;
    double t0 = 0.0, t1 = 0.0;
    for (int b0 = lane; b0 < nb; b0 += 32 * kLoads) {
        double v0[kLoads], v1[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
            const int b = b0 + 32 * u;
            v0[u] = b < nb ? __ldcg(part + warp * nb + b) : 0.0;
            v1[u] = two && b < nb ? __ldcg(part + k1 * nb + b) : 0.0;
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
            if (b0 + 32 * u >= nb) break;
            t0 += v0[u];
            t1 = k1 < kNSums ? t1 + v1[u] : fmax(t1, v1[u]);
        }
    }
    t0 = warp_sum_d(t0);
    if (k1 < kNSums) {
        t1 = warp_sum_d(t1);
    } else {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            t1 = fmax(t1, __shfl_down_sync(0xffffffffu, t1, off));
    }
    if (lane == 0) {
        s_sum[warp] = static_cast<float>(t0);
        if (two) s_sum[k1] = static_cast<float>(t1);
    }
}

// K1's and K2's finish, after the block's partial (k3_block_partial): the
// last block to arrive (an integer counter) adds all blocks' partials in
// K3's fixed order (k3_grid_sums), rounds each sum to float once, writes
// J^T J, J^T e and n_valid, and leaves the counter at zero for the next
// launch. Every thread calls it. The ordering is the grid barrier's: the
// block's partial before __syncthreads and thread 0's add, which releases
// (cumulative) and acquires at once, so the last block's loads after it and
// __syncthreads see every block's partial; no full fence on any thread.
__device__ __forceinline__ void last_block_sums(const double* part,
                                                unsigned* counter, float* jtj,
                                                float* jte, int32_t* n_valid) {
    __shared__ float s_sum[kPartStride];
    __shared__ bool s_last;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned arrived;
        asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                     : "=r"(arrived) : "l"(counter) : "memory");
        s_last = arrived == gridDim.x - 1;
    }
    __syncthreads();
    if (!s_last) return;
    k3_grid_sums(part, s_sum);
    __syncthreads();
    if (threadIdx.x < kNSums)
        expand_sum(threadIdx.x, s_sum[threadIdx.x], jtj, jte, n_valid);
    if (threadIdx.x == 0) *counter = 0u;
}

// Where a K1 phase finds query j in the map frame: K3 moves the block's
// source points by the current pose ...
struct PosedQueries {
    const float* pose;
    const float *x, *y, *z;
    __device__ __forceinline__ void at(int j, float* p) const {
        transform_point(pose, x[j], y[j], z[j], p);
    }
};

// ... and K1 is given them in the map frame.
struct MapQueries {
    const float *x, *y, *z;
    __device__ __forceinline__ void at(int j, float* p) const {
        p[0] = x[j];
        p[1] = y[j];
        p[2] = z[j];
    }
};

// A K1 phase's selections on source `src` (after its locate()): warp
// `warp` takes the block's valid queries warp, warp + W, ...; the next
// one's candidates are on their way (cp.async) while this one's selection
// runs, which leaves the query's record: its points x, y, z at k, 5 + k,
// 10 + k of s_rec + kRecFloats j, and in s_ok[j]
// - (kFull false, K3) the gate, the points kept only where it passed: K3
//   fits no other plane;
// - (kFull true, K1) the gate at bit 5 and which points exist at bits 0-4:
//   K1 writes every query's plane, also where the gate fails.
template <class Params, bool kFull, class Src, class Where>
__device__ __forceinline__ void k1_phase(
        const Src& src, const Where& at, int n_local, const uint8_t* s_valid,
        unsigned char* s_bufs, int* s_meta, const int* s_cells, float* s_rec,
        uint8_t* s_ok, int warp, int lane K3_CLOCK_PARAM) {
    constexpr int kBufBytes = Params::kBufBytes;
    constexpr int kMetaInts = Params::kMetaInts;
    K3_CLOCK_START(stage0);
    unsigned char* bufs = s_bufs + warp * 2 * kBufBytes;
    int* metas = s_meta + warp * 2 * kMetaInts;
    int j = warp;
    while (j < n_local && !s_valid[j]) j += kK3Warps;
    int stage = 0;
    float p[3];
    if (j < n_local) {
        at.at(j, p);
        src.stage(j, p[0], p[1], p[2], bufs, metas, s_cells, lane);
    }
    cp_async_commit();
    K3_CLOCK_ADD(stage0, kClkStage);
    while (j < n_local) {
        K3_CLOCK_START(stage);
        int jn = j + kK3Warps;
        while (jn < n_local && !s_valid[jn]) jn += kK3Warps;
        if (jn < n_local) {
            float pn[3];
            at.at(jn, pn);
            src.stage(jn, pn[0], pn[1], pn[2],
                      bufs + (stage ^ 1) * kBufBytes,
                      metas + (stage ^ 1) * kMetaInts, s_cells, lane);
        }
        cp_async_commit();   // an empty group after the last query
        K3_CLOCK_ADD(stage, kClkStage);
        K3_CLOCK_START(wait);
        cp_async_wait_but_one();
        __syncwarp();
        K3_CLOCK_ADD(wait, kClkWait);
        K3_CLOCK_START(select);
        at.at(j, p);
        const auto cd = src.cand(bufs + stage * kBufBytes,
                                 metas + stage * kMetaInts);
        int sel[kPlanePts];
        const bool gate = select5_any(cd, src.n_cand(), true, p[0], p[1],
                                      p[2], lane, sel);
        // lane k keeps point k: x, y, z at k, 5 + k, 10 + k of the record
        if constexpr (kFull) {
            const int sk = lane == 0 ? sel[0] : lane == 1 ? sel[1]
                         : lane == 2 ? sel[2] : lane == 3 ? sel[3] : sel[4];
            float* r = s_rec + kRecFloats * j;
            if (lane < kPlanePts && sk >= 0)
                cd.get(sk, r[lane], r[kPlanePts + lane],
                       r[2 * kPlanePts + lane]);
            if (lane == 0) {
                unsigned meta = gate ? 32u : 0u;
#pragma unroll
                for (int k = 0; k < kPlanePts; ++k)
                    if (sel[k] >= 0) meta |= 1u << k;
                s_ok[j] = static_cast<uint8_t>(meta);
            }
        } else {
            if (gate && lane < kPlanePts) {
                // all five exist where the gate passed
                const int sk = lane == 0 ? sel[0] : lane == 1 ? sel[1]
                             : lane == 2 ? sel[2] : lane == 3 ? sel[3]
                             : sel[4];
                float* r = s_rec + kRecFloats * j;
                cd.get(sk, r[lane], r[kPlanePts + lane],
                       r[2 * kPlanePts + lane]);
            }
            if (lane == 0) s_ok[j] = gate ? 1 : 0;
        }
        __syncwarp();   // the buffer is free for the load after next
        K3_CLOCK_ADD(select, kClkSelect);
        K3_CLOCK_COUNT(kClkQueries);
        j = jn;
        stage ^= 1;
    }
}

// K3's planes, kept in shared memory between its K1 phases (only those of
// the queries whose gate passed) ...
struct KeptPlanes {
    float* s_plane;
    uint8_t* s_ok;
    __device__ __forceinline__ void put(int j, const Plane& pl) const {
        float* pl_j = s_plane + 6 * j;
        pl_j[0] = pl.cx; pl_j[1] = pl.cy; pl_j[2] = pl.cz;
        pl_j[3] = pl.nx; pl_j[4] = pl.ny; pl_j[5] = pl.nz;
        s_ok[j] = pl.ok ? 1 : 0;
    }
    __device__ __forceinline__ Plane get(int j) const {
        const float* pl_j = s_plane + 6 * j;
        Plane pl;
        pl.cx = pl_j[0]; pl.cy = pl_j[1]; pl.cz = pl_j[2];
        pl.nx = pl_j[3]; pl.ny = pl_j[4]; pl.nz = pl_j[5];
        pl.ok = true;
        return pl;
    }
};

// ... and K1's plane set in device memory, every query's (query j of block
// `first` at fs::query(first, j, grid)); K1 has no K2 phase to read it.
struct PlaneSet {
    float* centroid;
    float* normal;
    uint8_t* ok;
    int first, grid;
    __device__ __forceinline__ void put(int j, const Plane& pl) const {
        const int qi = fs::query(first, j, grid);
        centroid[3 * qi] = pl.cx; centroid[3 * qi + 1] = pl.cy;
        centroid[3 * qi + 2] = pl.cz;
        normal[3 * qi] = pl.nx; normal[3 * qi + 1] = pl.ny;
        normal[3 * qi + 2] = pl.nz;
        ok[qi] = pl.ok ? 1 : 0;
    }
};

// The rows of the block's queries: thread t takes j = t, t + T, ...; after
// a K1 phase (`refit`, always for kFull) it first fits the plane of each
// record (the scalar tail, one query a thread: centroid, 3x3 eigensolve,
// gates) and hands it to keep.put(j, plane), else it takes query j's kept
// plane (keep.get(j)); then it adds the query's row to acc. The records are
// k1_phase's of the same kFull.
template <bool kFull, class Where, class Keep>
__device__ __forceinline__ void block_rows(bool refit, const Where& at,
                                           int n_local, const float* s_rec,
                                           const uint8_t* s_ok,
                                           const float* s_sqrt_r,
                                           const Keep& keep, float* acc) {
    for (int j = threadIdx.x; j < n_local; j += kK3Threads) {
        unsigned present = 0x1fu;
        bool gate = true;
        if constexpr (kFull) {
            const unsigned meta = s_ok[j];
            present = meta & 31u;
            gate = ((meta >> 5) & 1u) != 0u;
        } else {
            if (!s_ok[j]) continue;
        }
        Plane pl;
        if (kFull || refit) {
            const float* r = s_rec + kRecFloats * j;
            pl = fit_plane5(r, r + kPlanePts, r + 2 * kPlanePts, present,
                            gate);
            keep.put(j, pl);
        } else if constexpr (!kFull) {
            pl = keep.get(j);
        }
        float p[3];
        at.at(j, p);
        accumulate_row(pl, p[0], p[1], p[2], s_sqrt_r[j], acc);
    }
}

template <class Params>
__global__ void __launch_bounds__(kK3Threads, 1)
gn_loop_kernel(
        const Params prm, const float* __restrict__ src_xyz,
        const uint8_t* __restrict__ mask, int n_q,
        const float* __restrict__ init_pose, int max_iters,
        float degen_per_row, float* partials, unsigned* counters,
        float* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ float s_sum[kPartStride];
    __shared__ float s_pose[12], s_anchor[12];
    __shared__ float s_wmax[kK3Warps];
    __shared__ float s_rmax;
    __shared__ int s_ctl[4];   // stop, refit, converged, n_valid

    const int n_blocks = gridDim.x;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    K3_CLOCK_DECL;
    K3_CLOCK_START(prologue);
    const int n_local_max = fs::n_local_max(n_q, n_blocks);
    const int n_thr = fs::threads_used(n_q, n_blocks, kK3Threads);
    const int first = blockIdx.x;   // queries first, first + G, ...
    const int n_local = fs::n_local(n_q, n_blocks, first);
    const BlockSmem<Params> sm(smem_raw, n_local_max, n_thr);

    const auto src = prm.load();
    const int32_t probe = src.first_probe();

    // prologue: the block's queries, sqrt(max(|p|, 1e-6)) and the block's
    // largest valid range; the start pose; the source's own set-up
    float my_rmax = 0.0f;
    for (int j = tid; j < n_local; j += kK3Threads) {
        const int qi = fs::query(first, j, n_blocks);
        const float x = src_xyz[3 * qi], y = src_xyz[3 * qi + 1],
                    z = src_xyz[3 * qi + 2];
        const bool valid = mask[qi] != 0;
        const float r = gn::norm3(x, y, z);
        sm.x[j] = x; sm.y[j] = y; sm.z[j] = z;
        sm.sqrt_r[j] = sqrtf(fmaxf(r, 1e-6f));
        sm.valid[j] = valid ? 1 : 0;
        sm.ok[j] = 0;
        if (valid) my_rmax = fmaxf(my_rmax, r);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        my_rmax = fmaxf(my_rmax, __shfl_xor_sync(0xffffffffu, my_rmax, off));
    if (lane == 0) s_wmax[warp] = my_rmax;
    if (tid < 12) {
        const int src_i = tid < 9 ? (tid / 3) * 4 + tid % 3 : (tid - 9) * 4 + 3;
        s_pose[tid] = init_pose[src_i];
        s_anchor[tid] = init_pose[src_i];
    }
    src.prepare(sm.index, probe);
    __syncthreads();
    float block_rmax = 0.0f;
    for (int w = 0; w < kK3Warps; ++w) block_rmax = fmaxf(block_rmax, s_wmax[w]);
    K3_CLOCK_ADD(prologue, kClkPrologue);

    int iters = 0, gathers = 0;
    bool refit = true;
    while (true) {
        float pose[12];
#pragma unroll
        for (int i = 0; i < 12; ++i) pose[i] = s_pose[i];
        const PosedQueries at = {pose, sm.x, sm.y, sm.z};

        if (refit) {
            // K1 phase: the table's searches for all the block's queries;
            // then the warps' selections
            ++gathers;
            K3_CLOCK_START(search);
            if constexpr (Params::kCellInts > 0) {
                src.locate(pose, sm.x, sm.y, sm.z, sm.valid, n_local,
                           sm.cells, sm.index);
                __syncthreads();
            }
            K3_CLOCK_ADD(search, kClkSearch);
            k1_phase<Params, false>(src, at, n_local, sm.valid, sm.bufs,
                                    sm.meta, sm.cells, sm.rec, sm.ok, warp,
                                    lane K3_CLOCK_ARG);
        }

        // the rows: in a K1 phase each record's plane is fitted first, in
        // a K2 phase the kept plane is read
        K3_CLOCK_START(rows);
        __syncthreads();
        float acc[kNSums];
#pragma unroll
        for (int k = 0; k < kNSums; ++k) acc[k] = 0.0f;
        block_rows<false>(refit, at, n_local, sm.rec, sm.ok, sm.sqrt_r,
                          KeptPlanes{sm.plane, sm.ok}, acc);
        if (refit) {
            K3_CLOCK_ADD(rows, kClkTail);
        } else {
            K3_CLOCK_ADD(rows, kClkK2);
        }

        // publish this block's partial sums, meet the other blocks, then
        // add all partials in a fixed order: every block gets the same sums
        K3_CLOCK_START(bsums);
        double* part = reinterpret_cast<double*>(partials)
            + static_cast<size_t>(iters & 1) * kPartStride * n_blocks;
        k3_block_partial(acc, sm.red, n_thr, block_rmax, part);
        K3_CLOCK_ADD(bsums, kClkBlockSums);
        K3_CLOCK_START(barrier);
        grid_barrier(&counters[0],
                     static_cast<unsigned>(n_blocks) * (iters + 1));
        K3_CLOCK_ADD(barrier, kClkBarrier);
        K3_CLOCK_START(gsums);
        k3_grid_sums(part, s_sum);
        __syncthreads();
        K3_CLOCK_ADD(gsums, kClkPartials);

        // the small step, taken by every block on the same numbers
        K3_CLOCK_START(step);
        if (tid == 0) {
            // constant indices throughout, so these arrays are registers
            float jtj[36], jte[6], dx[6], next[12];
            int k = 0;
#pragma unroll
            for (int i = 0; i < 6; ++i)
#pragma unroll
                for (int j = i; j < 6; ++j) {
                    jtj[i * 6 + j] = s_sum[k];
                    jtj[j * 6 + i] = s_sum[k];
                    ++k;
                }
#pragma unroll
            for (int i = 0; i < 6; ++i) jte[i] = s_sum[21 + i];
            const int n_valid = static_cast<int>(s_sum[27]);
            if (iters == 0) s_rmax = s_sum[kNSums];
#pragma unroll
            for (int i = 0; i < 12; ++i) next[i] = pose[i];
            const int flags = gn::gn_step(jtj, jte, n_valid, degen_per_row,
                                          next, dx);
            const bool enough = (flags & gn::kFlagEnough) != 0;
            const bool converged = enough && (flags & gn::kFlagConv) != 0;
            const float moved = gn::moved_since(next, s_anchor, s_rmax);
            const bool stop = converged || !enough || iters + 1 >= max_iters;
            const bool again = !stop && moved > gn::kRegatherDist;
#pragma unroll
            for (int i = 0; i < 12; ++i) {
                s_pose[i] = next[i];
                if (again) s_anchor[i] = next[i];
            }
            s_ctl[0] = stop; s_ctl[1] = again; s_ctl[2] = converged;
            s_ctl[3] = n_valid;
        }
        __syncthreads();
        K3_CLOCK_ADD(step, kClkStep);
        ++iters;
        refit = s_ctl[1] != 0;
        if (s_ctl[0]) break;
    }

    // epilogue: one result row [pose (4x4), converged, iters, gathers,
    // n_valid of the last linearization]
    K3_CLOCK_START(epilogue);
    if (blockIdx.x == 0 && tid == 0) {
        float Rn[9];
        gn::reorthonormalize(s_pose, Rn);
        for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j) out[i * 4 + j] = Rn[i * 3 + j];
            out[i * 4 + 3] = s_pose[9 + i];
            out[12 + i] = 0.0f;
        }
        out[15] = 1.0f;
        out[16] = s_ctl[2] ? 1.0f : 0.0f;
        out[17] = static_cast<float>(iters);
        out[18] = static_cast<float>(gathers);
        out[19] = static_cast<float>(s_ctl[3]);
    }
    grid_barrier_release(counters);
#ifdef LOAM_K3_CLOCKS
    K3_CLOCK_ADD(epilogue, kClkEpilogue);
    clock_write(k3_clocks, static_cast<long long>(blockIdx.x) * kK3Warps + warp,
                k3_acc, k3_t0, iters);
#endif
}

// K1: a K1 phase of K3 on the merged map at map-frame queries, then every
// query's plane written out and its row added, one thread per query; the
// block's partial, and the last block's sums of all partials. One launch on
// K3's grid (one block per SM) and shared-memory layout.
__global__ void __launch_bounds__(kK3Threads, 1)
fit_and_linearize_merged_kernel(
        const MergedParams prm, const float* __restrict__ p_map,
        const float* __restrict__ sqrt_r, const uint8_t* __restrict__ mask,
        int n_q, float* __restrict__ centroid, float* __restrict__ normal,
        uint8_t* __restrict__ ok_out, double* partials, unsigned* counter,
        float* __restrict__ jtj, float* __restrict__ jte,
        int32_t* __restrict__ n_valid) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int n_blocks = gridDim.x;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    K3_CLOCK_DECL;
    K3_CLOCK_START(prologue);
    const int n_local_max = fs::n_local_max(n_q, n_blocks);
    const int n_thr = fs::threads_used(n_q, n_blocks, kK3Threads);
    const int first = blockIdx.x;
    const int n_local = fs::n_local(n_q, n_blocks, first);
    const BlockSmem<MergedParams> sm(smem_raw, n_local_max, n_thr);
    const MergedSrc src = prm.load();
    // a masked-out query's record says no point and no gate: its plane is
    // the zero plane, as the plain version's
    for (int j = tid; j < n_local; j += kK3Threads) {
        const int qi = fs::query(first, j, n_blocks);
        sm.x[j] = p_map[3 * qi];
        sm.y[j] = p_map[3 * qi + 1];
        sm.z[j] = p_map[3 * qi + 2];
        sm.sqrt_r[j] = sqrt_r[qi];
        sm.valid[j] = mask[qi] != 0 ? 1 : 0;
        sm.ok[j] = 0;
    }
    __syncthreads();
    K3_CLOCK_ADD(prologue, kClkPrologue);
    const MapQueries at = {sm.x, sm.y, sm.z};
    k1_phase<MergedParams, true>(src, at, n_local, sm.valid, sm.bufs,
                                 sm.meta, sm.cells, sm.rec, sm.ok, warp,
                                 lane K3_CLOCK_ARG);
    K3_CLOCK_START(rows);
    __syncthreads();
    float acc[kNSums];
#pragma unroll
    for (int k = 0; k < kNSums; ++k) acc[k] = 0.0f;
    block_rows<true>(true, at, n_local, sm.rec, sm.ok, sm.sqrt_r,
                     PlaneSet{centroid, normal, ok_out, first, n_blocks}, acc);
    K3_CLOCK_ADD(rows, kClkTail);
    K3_CLOCK_START(bsums);
    k3_block_partial(acc, sm.red, n_thr, 0.0f, partials);
    K3_CLOCK_ADD(bsums, kClkBlockSums);
    K3_CLOCK_START(finish);
    last_block_sums(partials, counter, jtj, jte, n_valid);
#ifdef LOAM_K1_CLOCKS
    K3_CLOCK_ADD(finish, kClkPartials);
    clock_write(k1_clocks, static_cast<long long>(blockIdx.x) * kK3Warps + warp,
                k3_acc, k3_t0, 1);
#endif
}

// K2: one thread per query against the frozen plane set, on K1's layout
// with its block partial and last-block finish; one launch. Its dynamic
// shared memory is the staged row sums (kNSums x the threads used).
__global__ void __launch_bounds__(kK3Threads, 1)
plane_normal_equations_kernel(
        const float* __restrict__ centroid, const float* __restrict__ normal,
        const uint8_t* __restrict__ ok, const float* __restrict__ p_map,
        const float* __restrict__ sqrt_r, int n_q, double* partials,
        unsigned* counter, float* __restrict__ jtj, float* __restrict__ jte,
        int32_t* __restrict__ n_valid) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int n_blocks = gridDim.x, first = blockIdx.x;
    const int n_local = fs::n_local(n_q, n_blocks, first);
    float acc[kNSums];
#pragma unroll
    for (int k = 0; k < kNSums; ++k) acc[k] = 0.0f;
    for (int j = threadIdx.x; j < n_local; j += kK3Threads) {
        const int qi = fs::query(first, j, n_blocks);
        Plane pl;
        pl.cx = centroid[3 * qi]; pl.cy = centroid[3 * qi + 1];
        pl.cz = centroid[3 * qi + 2];
        pl.nx = normal[3 * qi]; pl.ny = normal[3 * qi + 1];
        pl.nz = normal[3 * qi + 2];
        pl.ok = ok[qi] != 0;
        accumulate_row(pl, p_map[3 * qi], p_map[3 * qi + 1],
                       p_map[3 * qi + 2], sqrt_r[qi], acc);
    }
    k3_block_partial(acc, reinterpret_cast<float*>(smem_raw),
                     fs::threads_used(n_q, n_blocks, kK3Threads), 0.0f,
                     partials);
    last_block_sums(partials, counter, jtj, jte, n_valid);
}

// `n` grid barriers and nothing else, on K3's grid: the barrier's cost.
__global__ void __launch_bounds__(kK3Threads, 1)
barrier_probe_kernel(unsigned* counters, int n) {
    for (int i = 0; i < n; ++i)
        grid_barrier(&counters[0], gridDim.x * static_cast<unsigned>(i + 1));
    grid_barrier_release(counters);
}

// ---------------------------------------------------------------------------
// K4: the TPU kernel's candidates-in form, one launch
// ---------------------------------------------------------------------------

// Copy query qi's C flags into shared memory (`copy` says how they are
// aligned); the 1-byte path stores them at once.
__device__ __forceinline__ void k4_stage_flags(const uint8_t* cand_ok, int qi,
                                               int n_cand, int copy,
                                               uint8_t* dst, int lane) {
    const uint8_t* src = cand_ok + static_cast<size_t>(qi) * n_cand;
    if (copy & kCopyFlags16) {
        for (int k = lane; k < n_cand / 16; k += 32)
            cp_async16(dst + 16 * k, src + 16 * k);
    } else if (copy & kCopyFlags4) {
        for (int k = lane; k < n_cand / 4; k += 32)
            cp_async4(dst + 4 * k, src + 4 * k);
    } else {
        for (int k = lane; k < n_cand; k += 32) dst[k] = __ldg(src + k);
    }
}

// Copy the coordinates of query qi's set candidates (flags `fl`, already in
// shared memory): the 16-byte chunks that hold one, else 4-byte words.
__device__ __forceinline__ void k4_stage_coords(const float* cand, int qi,
                                                int n_cand, int copy,
                                                const uint8_t* fl, float* dst,
                                                int lane) {
    const float* src = cand + static_cast<size_t>(qi) * n_cand * 3;
    if (copy & kCopyCoords16) {
        // candidates 4g .. 4g + 3 fill the 16-byte chunks 3g .. 3g + 2:
        // chunk 3g holds candidate 4g and the start of 4g + 1, 3g + 1 the
        // rest of 4g + 1 and the start of 4g + 2, 3g + 2 the rest of 4g + 2
        // and 4g + 3; one 4-byte read of the flags decides all three
        const unsigned* fw = reinterpret_cast<const unsigned*>(fl);
        for (int g = lane; g < n_cand / 4; g += 32) {
            const unsigned w = fw[g];
            const bool f0 = (w & 0xffu) != 0u, f1 = (w & 0xff00u) != 0u,
                       f2 = (w & 0xff0000u) != 0u, f3 = (w >> 24) != 0u;
            if (f0 || f1) cp_async16(dst + 12 * g, src + 12 * g);
            if (f1 || f2) cp_async16(dst + 12 * g + 4, src + 12 * g + 4);
            if (f2 || f3) cp_async16(dst + 12 * g + 8, src + 12 * g + 8);
        }
    } else {
        for (int c = lane; c < n_cand; c += 32) {
            if (!fl[c]) continue;
            cp_async4(dst + 3 * c, src + 3 * c);
            cp_async4(dst + 3 * c + 1, src + 3 * c + 1);
            cp_async4(dst + 3 * c + 2, src + 3 * c + 2);
        }
    }
}

// The scalar tail of one query from its record, on one lane: plane fit,
// gates, the plane set and the query's row added to acc.
__device__ __forceinline__ void k4_tail(const float* r, float* centroid,
                                        float* normal, uint8_t* ok_out,
                                        float* acc) {
    float x[kPlanePts], y[kPlanePts], z[kPlanePts];
#pragma unroll
    for (int k = 0; k < kPlanePts; ++k) {
        x[k] = r[k];
        y[k] = r[kPlanePts + k];
        z[k] = r[2 * kPlanePts + k];
    }
    const unsigned meta = __float_as_uint(r[20]);
    const Plane pl = fit_plane5(x, y, z, meta & 31u, (meta >> 5) & 1u);
    const int qi = __float_as_int(r[19]);
    centroid[3 * qi] = pl.cx; centroid[3 * qi + 1] = pl.cy;
    centroid[3 * qi + 2] = pl.cz;
    normal[3 * qi] = pl.nx; normal[3 * qi + 1] = pl.ny;
    normal[3 * qi + 2] = pl.nz;
    ok_out[qi] = pl.ok ? 1 : 0;
    accumulate_row(pl, r[15], r[16], r[17], r[18], acc);
}

// K4's one-launch reduction: the block's partial sums (sum k of block b at
// k * blocks + b); the last block to finish adds them all in a fixed order
// (warp w takes sums w, w + W, ...: lane l adds blocks l, l + 32, ... in
// turn, eight loads in flight at a time, then the warp's fixed tree) and
// leaves the counter at zero for the next launch. Every thread of the
// block calls it.
__device__ __forceinline__ void k4_finish(const float* acc,
                                          float (*s_acc)[kNSums],
                                          float* partials, unsigned* counter,
                                          float* jtj, float* jte,
                                          int32_t* n_valid) {
    __shared__ bool s_last;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nb = gridDim.x;
    const float bsum = block_sums<kK4Warps>(acc, s_acc);
    if (threadIdx.x < kNSums) partials[threadIdx.x * nb + blockIdx.x] = bsum;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int k = warp; k < kNSums; k += kK4Warps) {
        const float* row = partials + k * nb;
        float part = 0.0f;
        for (int b0 = lane; b0 < nb; b0 += 32 * 8) {
            float v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
                v[u] = b0 + 32 * u < nb ? __ldcg(row + b0 + 32 * u) : 0.0f;
#pragma unroll
            for (int u = 0; u < 8; ++u)
                if (b0 + 32 * u < nb) part += v[u];
        }
        const float total = warp_sum(part);
        if (lane == 0) expand_sum(k, total, jtj, jte, n_valid);
    }
    if (threadIdx.x == 0) *counter = 0u;
}

// Where a K4 warp spends its time, for tools/k4_breakdown.py: built with
// -DLOAM_K4_CLOCKS, lane 0 of every warp adds SM clock cycles per segment
// (the prologue, the waits at the top of each query, the copies issued, the
// selection, the record and tail, the block's finish) into
// k4_clocks[warp of the grid][kK4ClockSlots], with its SM and its start and
// end on the global timer. The normal build has none of it.
constexpr int kK4ClockSlots = 10;
#ifdef LOAM_K4_CLOCKS
__device__ long long* k4_clocks;
#define K4_CLOCK_START(seg) long long k4c_##seg = clock64()
#define K4_CLOCK_ADD(seg, slot) k4_acc[slot] += clock64() - k4c_##seg
#else
#define K4_CLOCK_START(seg)
#define K4_CLOCK_ADD(seg, slot)
#endif

// K4: warp w of the grid's W walks queries w, w + W, ...; see the design
// note at the top of this file.
__global__ void __launch_bounds__(kK4Threads)
fit_and_linearize_candidates_kernel(
        const float* __restrict__ cand, const uint8_t* __restrict__ cand_ok,
        int n_cand, int copy, const float* __restrict__ p_map,
        const float* __restrict__ sqrt_r, const uint8_t* __restrict__ mask,
        int n_q, float* __restrict__ centroid, float* __restrict__ normal,
        uint8_t* __restrict__ ok_out, float* partials, unsigned* counter,
        float* __restrict__ jtj, float* __restrict__ jte,
        int32_t* __restrict__ n_valid) {
    __shared__ __align__(16) float s_co[kK4Warps][2][kMaxCand * 3];
    __shared__ __align__(16) uint8_t s_fl[kK4Warps][kK4FlagSlots][kMaxCand];
    __shared__ float s_rec[kK4Warps][32 * kK4Rec];
    __shared__ float s_acc[kK4Warps][kNSums];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int stride = gridDim.x * kK4Warps;
    float* rec = s_rec[warp];
#ifdef LOAM_K4_CLOCKS
    long long k4_acc[kK4ClockSlots] = {0};
    unsigned long long k4_t0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(k4_t0));
#endif
    K4_CLOCK_START(prologue);

    float acc[kNSums];
#pragma unroll
    for (int k = 0; k < kNSums; ++k) acc[k] = 0.0f;

    // the warp's queries are gw + i stride, i = 0 .. n_mine - 1; their mask
    // bits come 32 at a time, one load per lane, and a masked-out one gets
    // the zero plane there (what the selection gives a query with no set
    // flag) and needs no other load
    const int gw = blockIdx.x * kK4Warps + warp;
    const int n_mine = gw < n_q ? (n_q - gw + stride - 1) / stride : 0;
    int chunk = -1;
    unsigned bits = 0u;
    // the next valid i from i0 on (n_mine when there is none); i0 only grows
    auto next_valid = [&](int i0) {
        while (i0 < n_mine) {
            const int c = i0 >> 5;
            if (c != chunk) {
                const int i = (c << 5) + lane;
                const int qi = gw + i * stride;
                bool v = false;
                if (i < n_mine) {
                    v = mask[qi] != 0;
                    if (!v) {
                        centroid[3 * qi] = centroid[3 * qi + 1]
                            = centroid[3 * qi + 2] = 0.0f;
                        normal[3 * qi] = normal[3 * qi + 1]
                            = normal[3 * qi + 2] = 0.0f;
                        ok_out[qi] = 0;
                    }
                }
                bits = __ballot_sync(0xffffffffu, v);
                chunk = c;
            }
            const unsigned rest = bits & (0xffffffffu << (i0 & 31));
            if (rest) return (c << 5) + __ffs(rest) - 1;
            i0 = (c + 1) << 5;
        }
        return n_mine;
    };
    auto query = [&](int i) { return gw + i * stride; };

    // prologue: flags of the first query, then its coordinates and the
    // second one's flags. The warp's first query is valid as a rule (valid
    // queries come first), so its flags are on their way while the mask
    // bits come; where it is not, they are fetched again
    if (gw < n_q) k4_stage_flags(cand_ok, gw, n_cand, copy, s_fl[warp][0], lane);
    cp_async_commit();
    int i_cur = next_valid(0);
    int i_next = next_valid(i_cur + 1);
    int j = i_cur < n_mine ? query(i_cur) : n_q;
    int jn = i_next < n_mine ? query(i_next) : n_q;
    cp_async_wait_all();
    __syncwarp();
    if (j < n_q && j != gw) {
        k4_stage_flags(cand_ok, j, n_cand, copy, s_fl[warp][0], lane);
        cp_async_commit();
        cp_async_wait_all();
        __syncwarp();
    }
    if (jn < n_q)
        k4_stage_flags(cand_ok, jn, n_cand, copy, s_fl[warp][1], lane);
    if (j < n_q)
        k4_stage_coords(cand, j, n_cand, copy, s_fl[warp][0], s_co[warp][0],
                        lane);
    cp_async_commit();
    // this query's and the next one's position and sqrt(r), loaded a query
    // ahead
    float qx = 0.f, qy = 0.f, qz = 0.f, qr = 0.f;
    float nqx = 0.f, nqy = 0.f, nqz = 0.f, nqr = 0.f;
    if (j < n_q) {
        qx = __ldg(p_map + 3 * j); qy = __ldg(p_map + 3 * j + 1);
        qz = __ldg(p_map + 3 * j + 2); qr = __ldg(sqrt_r + j);
    }
    if (jn < n_q) {
        nqx = __ldg(p_map + 3 * jn); nqy = __ldg(p_map + 3 * jn + 1);
        nqz = __ldg(p_map + 3 * jn + 2); nqr = __ldg(sqrt_r + jn);
    }

    int t = 0, n_rec = 0;
    K4_CLOCK_ADD(prologue, 0);
    while (j < n_q) {
        const int i_nn = i_next < n_mine ? next_valid(i_next + 1) : n_mine;
        const int jnn = i_nn < n_mine ? query(i_nn) : n_q;
        // this query's coordinates and the next one's flags have landed
        K4_CLOCK_START(wait);
        cp_async_wait_all();
        __syncwarp();
        K4_CLOCK_ADD(wait, 1);
        K4_CLOCK_START(stage);
        if (jnn < n_q)
            k4_stage_flags(cand_ok, jnn, n_cand, copy,
                           s_fl[warp][(t + 2) % kK4FlagSlots], lane);
        if (jn < n_q)
            k4_stage_coords(cand, jn, n_cand, copy,
                            s_fl[warp][(t + 1) % kK4FlagSlots],
                            s_co[warp][(t + 1) & 1], lane);
        cp_async_commit();
        K4_CLOCK_ADD(stage, 2);

        K4_CLOCK_START(select);
        const StagedCand cd = {s_co[warp][t & 1], s_fl[warp][t % kK4FlagSlots]};
        int sel[kPlanePts];
        const bool gate = select5_any(cd, n_cand, true, qx, qy, qz, lane, sel);
        K4_CLOCK_ADD(select, 3);
        K4_CLOCK_START(record);
        // the query's record for the tail: its selected points (0 where
        // absent), the query, sqrt(r), its index and which points exist
        float* r = rec + n_rec * kK4Rec;
        if (lane < 3 * kPlanePts) {
            const int k = lane % kPlanePts, axis = lane / kPlanePts;
            const int sk = k == 0 ? sel[0] : k == 1 ? sel[1] : k == 2 ? sel[2]
                         : k == 3 ? sel[3] : sel[4];
            r[lane] = sk >= 0 ? cd.co[3 * sk + axis] : 0.0f;
        } else if (lane == 15) {
            r[15] = qx;
        } else if (lane == 16) {
            r[16] = qy;
        } else if (lane == 17) {
            r[17] = qz;
        } else if (lane == 18) {
            r[18] = qr;
        } else if (lane == 19) {
            r[19] = __int_as_float(j);
        } else if (lane == 20) {
            unsigned meta = gate ? 32u : 0u;
#pragma unroll
            for (int k = 0; k < kPlanePts; ++k)
                if (sel[k] >= 0) meta |= 1u << k;
            r[20] = __uint_as_float(meta);
        }
        if (++n_rec == 32) {
            __syncwarp();
            k4_tail(rec + lane * kK4Rec, centroid, normal, ok_out, acc);
            n_rec = 0;
        }
        __syncwarp();   // the buffers of this query are free for the loads
        j = jn;
        jn = jnn;
        i_next = i_nn;
        qx = nqx; qy = nqy; qz = nqz; qr = nqr;
        if (jn < n_q) {
            nqx = __ldg(p_map + 3 * jn); nqy = __ldg(p_map + 3 * jn + 1);
            nqz = __ldg(p_map + 3 * jn + 2); nqr = __ldg(sqrt_r + jn);
        }
        ++t;
        K4_CLOCK_ADD(record, 4);
    }
    K4_CLOCK_START(tail);
    __syncwarp();
    if (lane < n_rec)
        k4_tail(rec + lane * kK4Rec, centroid, normal, ok_out, acc);
    __syncwarp();
    K4_CLOCK_ADD(tail, 5);
    K4_CLOCK_START(finish);

    k4_finish(acc, s_acc, partials, counter, jtj, jte, n_valid);
#ifdef LOAM_K4_CLOCKS
    K4_CLOCK_ADD(finish, 6);
    if (lane == 0) {
        unsigned long long t1;
        unsigned smid;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
        asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
        long long* out = k4_clocks
            + (static_cast<long long>(blockIdx.x) * kK4Warps + warp)
              * kK4ClockSlots;
        for (int k = 0; k < 7; ++k) out[k] = k4_acc[k];
        out[7] = static_cast<long long>(smid);
        out[8] = static_cast<long long>(k4_t0);
        out[9] = static_cast<long long>(t1);
    }
#endif
}

// Nothing at all, on one block of K4's size: the launch's floor, beside
// which K4's device time is read.
__global__ void __launch_bounds__(kK4Threads) empty_kernel() {}

// K3's grid on the current device: one block per SM (0 on an error).
int gn_loop_grid_cached() {
    static std::mutex mu;
    static int sms[64] = {0};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
    std::lock_guard<std::mutex> lock(mu);
    if (sms[dev] == 0) {
        int n = 0;
        if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
                != cudaSuccess)
            return 0;
        sms[dev] = n;
    }
    return sms[dev];
}

// Raise `kernel`'s dynamic shared memory limit where `smem` bytes are above
// the default 48 KB.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
}

}  // namespace

extern "C" {

int loam_max_candidates() { return kMaxCand; }

// K1 on the merged map: one launch on K3's grid (loam_gn_loop_grid()
// blocks) with K3's shared memory on the merged map (loam_gn_loop_smem(n_q,
// 0) bytes). Its workspace is K3's: partials of loam_gn_loop_grid() x
// loam_gn_loop_partial_stride() floats and one zeroed 32-bit counter, which
// the launch leaves at zero; the last block writes jtj, jte and n_valid.
int loam_fit_and_linearize_merged(
        const void* rows, int n_cand, const void* scale, const void* corner,
        const void* grid, int gx, int gy, int gz, const void* p_map,
        const void* sqrt_r, const void* mask, int n_q, void* centroid,
        void* normal, void* ok, void* partials, void* counter, void* jtj,
        void* jte, void* n_valid, void* stream) {
    const int n_blocks = gn_loop_grid_cached();
    if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidDevice);
    if (n_cand < 1 || n_cand > kMaxCand)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = gn_loop_smem_bytes(
        n_q, n_blocks, MergedParams::kBufBytes, MergedParams::kMetaInts,
        MergedParams::kIndexInts, MergedParams::kCellInts);
    cudaError_t err = allow_smem(fit_and_linearize_merged_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const MergedParams prm = {
        static_cast<const int16_t*>(rows), n_cand,
        static_cast<const float*>(scale), static_cast<const float*>(corner),
        static_cast<const float*>(grid), gx, gy, gz};
    fit_and_linearize_merged_kernel<<<n_blocks, kK3Threads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
        prm, static_cast<const float*>(p_map),
        static_cast<const float*>(sqrt_r), static_cast<const uint8_t*>(mask),
        n_q, static_cast<float*>(centroid), static_cast<float*>(normal),
        static_cast<uint8_t*>(ok), static_cast<double*>(partials),
        static_cast<unsigned*>(counter), static_cast<float*>(jtj),
        static_cast<float*>(jte), static_cast<int32_t*>(n_valid));
    return static_cast<int>(cudaGetLastError());
}

// Rows of K1's clock buffer (-DLOAM_K1_CLOCKS): one per warp of its grid.
int loam_k1_clock_rows(int) { return gn_loop_grid_cached() * kK3Warps; }

// K4's grid: blocks of kK4Warps warps, each warp walking about
// kK4QueriesPerWarp queries (at least one block).
int loam_k4_blocks(int n_q) {
    const int per_block = kK4Warps * kK4QueriesPerWarp;
    const int nb = (n_q + per_block - 1) / per_block;
    return nb > 0 ? nb : 1;
}

// K4: candidates (n_q, n_cand, 3) f32 and flags (n_q, n_cand) uint8, both
// contiguous; partials hold loam_k4_blocks(n_q) x 28
// floats and the counter one zeroed 32-bit word, which the launch leaves
// at zero. One launch; the last block writes jtj, jte and n_valid.
int loam_fit_and_linearize_candidates(
        const void* cand, const void* cand_ok, int n_cand, const void* p_map,
        const void* sqrt_r, const void* mask, int n_q, void* centroid,
        void* normal, void* ok, void* partials, void* counter, void* jtj,
        void* jte, void* n_valid, void* stream) {
    const int nb = loam_k4_blocks(n_q);
    if (n_cand < 1 || n_cand > kMaxCand)
        return static_cast<int>(cudaErrorInvalidValue);
    const uintptr_t cp = reinterpret_cast<uintptr_t>(cand);
    const uintptr_t fp = reinterpret_cast<uintptr_t>(cand_ok);
    int copy = 0;
    if (fp % 16 == 0 && n_cand % 16 == 0) copy |= kCopyFlags16;
    else if (fp % 4 == 0 && n_cand % 4 == 0) copy |= kCopyFlags4;
    if (cp % 16 == 0 && n_cand % 4 == 0) copy |= kCopyCoords16;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    fit_and_linearize_candidates_kernel<<<nb, kK4Threads, 0, st>>>(
        static_cast<const float*>(cand), static_cast<const uint8_t*>(cand_ok),
        n_cand, copy, static_cast<const float*>(p_map),
        static_cast<const float*>(sqrt_r), static_cast<const uint8_t*>(mask),
        n_q, static_cast<float*>(centroid), static_cast<float*>(normal),
        static_cast<uint8_t*>(ok), static_cast<float*>(partials),
        static_cast<unsigned*>(counter), static_cast<float*>(jtj),
        static_cast<float*>(jte), static_cast<int32_t*>(n_valid));
    return static_cast<int>(cudaGetLastError());
}

// K2: one launch on K1's grid, with K1's workspace.
int loam_plane_normal_equations(
        const void* centroid, const void* normal, const void* ok,
        const void* p_map, const void* sqrt_r, int n_q, void* partials,
        void* counter, void* jtj, void* jte, void* n_valid, void* stream) {
    const int n_blocks = gn_loop_grid_cached();
    if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidDevice);
    const size_t smem = sizeof(float) * kNSums
                      * fs::threads_used(n_q, n_blocks, kK3Threads);
    cudaError_t err = allow_smem(plane_normal_equations_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    plane_normal_equations_kernel<<<n_blocks, kK3Threads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(centroid), static_cast<const float*>(normal),
        static_cast<const uint8_t*>(ok), static_cast<const float*>(p_map),
        static_cast<const float*>(sqrt_r), n_q,
        static_cast<double*>(partials), static_cast<unsigned*>(counter),
        static_cast<float*>(jtj), static_cast<float*>(jte),
        static_cast<int32_t*>(n_valid));
    return static_cast<int>(cudaGetLastError());
}

// Blocks of K3's cooperative grid on the current device (0 on an error);
// its workspace is 2 x blocks x loam_gn_loop_partial_stride() floats of
// partials (kPartStride doubles a block) plus two zeroed 32-bit counters.
int loam_gn_loop_grid() { return gn_loop_grid_cached(); }

int loam_gn_loop_partial_stride() { return 2 * kPartStride; }

// Dynamic shared memory K3 needs for n_q queries on a target of `kind`
// (0 merged map, 1 dense map, 2 sorted table), in bytes.
long long loam_gn_loop_smem(int n_q, int kind) {
    const int grid = gn_loop_grid_cached();
    if (grid <= 0) return -1;
    size_t bytes = gn_loop_smem_bytes(
        n_q, grid, MergedParams::kBufBytes, MergedParams::kMetaInts,
        MergedParams::kIndexInts, MergedParams::kCellInts);
    if (kind == 1)
        bytes = gn_loop_smem_bytes(n_q, grid, DenseParams::kBufBytes,
                                   DenseParams::kMetaInts,
                                   DenseParams::kIndexInts,
                                   DenseParams::kCellInts);
    if (kind == 2)
        bytes = gn_loop_smem_bytes(n_q, grid, TableParams::kBufBytes,
                                   TableParams::kMetaInts,
                                   TableParams::kIndexInts,
                                   TableParams::kCellInts);
    return static_cast<long long>(bytes);
}

}  // extern "C"

namespace {

// One cooperative launch of K3 on the source `prm`.
template <class Params>
int launch_gn_loop(Params prm, const void* src_xyz, const void* mask,
                   int n_q, const void* init_pose, int max_iters,
                   float degen_per_row, void* partials, void* counters,
                   void* out, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int n_blocks = gn_loop_grid_cached();
    if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidDevice);
    size_t smem = gn_loop_smem_bytes(n_q, n_blocks, Params::kBufBytes,
                                     Params::kMetaInts, Params::kIndexInts,
                                     Params::kCellInts);
    cudaError_t err = allow_smem(gn_loop_kernel<Params>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const float* src_p = static_cast<const float*>(src_xyz);
    const uint8_t* mask_p = static_cast<const uint8_t*>(mask);
    const float* pose_p = static_cast<const float*>(init_pose);
    float* partials_p = static_cast<float*>(partials);
    unsigned* counters_p = static_cast<unsigned*>(counters);
    float* out_p = static_cast<float*>(out);
    void* args[] = {&prm, &src_p, &mask_p, &n_q, &pose_p, &max_iters,
                    &degen_per_row, &partials_p, &counters_p, &out_p};
    // a cooperative launch is refused, not queued, when its grid cannot be
    // co-resident: the error comes back from this call
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(gn_loop_kernel<Params>), dim3(n_blocks),
        dim3(kK3Threads), args, smem, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K3 on a merged map.
int loam_gn_loop(
        const void* rows, int n_cand, const void* scale, const void* corner,
        const void* grid_size, int gx, int gy, int gz, const void* src_xyz,
        const void* mask, int n_q, const void* init_pose, int max_iters,
        float degen_per_row, void* partials, void* counters, void* out,
        void* stream) {
    const MergedParams prm = {
        static_cast<const int16_t*>(rows), n_cand,
        static_cast<const float*>(scale), static_cast<const float*>(corner),
        static_cast<const float*>(grid_size), gx, gy, gz};
    return launch_gn_loop(prm, src_xyz, mask, n_q, init_pose, max_iters,
                          degen_per_row, partials, counters, out, stream);
}

// K3 on a dense map: slab (gx * gy * gz + 1, m * 3) f32, the last row the
// all-padding sentinel; 8 m <= 256.
int loam_gn_loop_dense(
        const void* slab, int m, const void* corner, const void* grid_size,
        int gx, int gy, int gz, const void* src_xyz, const void* mask,
        int n_q, const void* init_pose, int max_iters, float degen_per_row,
        void* partials, void* counters, void* out, void* stream) {
    if (m < 1 || tg::kCornerCells * m > kMaxCand)
        return static_cast<int>(cudaErrorInvalidValue);
    const int vec16 = reinterpret_cast<uintptr_t>(slab) % 16 == 0
                      && (12 * m) % 16 == 0;
    const DenseParams prm = {
        static_cast<const float*>(slab), m, static_cast<const float*>(corner),
        static_cast<const float*>(grid_size), gx, gy, gz, vec16};
    return launch_gn_loop(prm, src_xyz, mask, n_q, init_pose, max_iters,
                          degen_per_row, partials, counters, out, stream);
}

// K3 on a sorted voxel table: keys (n_keys,) int32 ascending, slab
// (n_keys, m, 3) f32, counts (n_keys,) int32; 1 <= n_keys < 2^27 (a cell
// keeps row * 16 + count), 27 m <= 256.
int loam_gn_loop_table(
        const void* keys, int n_keys, const void* slab, const void* counts,
        int m, const void* origin, const void* grid_size,
        const void* src_xyz, const void* mask, int n_q, const void* init_pose,
        int max_iters, float degen_per_row, void* partials, void* counters,
        void* out, void* stream) {
    if (n_keys < 1 || n_keys >= (1 << 27) || m < 1
            || tg::kTableCells * m > kMaxCand)
        return static_cast<int>(cudaErrorInvalidValue);
    const int vec16 = reinterpret_cast<uintptr_t>(slab) % 16 == 0
                      && (12 * m) % 16 == 0;
    const TableParams prm = {
        static_cast<const int32_t*>(keys), n_keys,
        static_cast<const float*>(slab), static_cast<const int32_t*>(counts),
        m, static_cast<const float*>(origin),
        static_cast<const float*>(grid_size), vec16};
    return launch_gn_loop(prm, src_xyz, mask, n_q, init_pose, max_iters,
                          degen_per_row, partials, counters, out, stream);
}

#ifdef LOAM_K3_CLOCKS
// Where K3's clock build writes: loam_gn_loop_grid() x kK3Warps x
// kK3ClockSlots int64 (see k3_clocks).
int loam_k3_set_clocks(void* buf) {
    long long* p = static_cast<long long*>(buf);
    return static_cast<int>(cudaMemcpyToSymbol(k3_clocks, &p, sizeof(p)));
}
#endif

#ifdef LOAM_K1_CLOCKS
// Where K1's clock build writes: loam_k1_clock_rows(n_q) x kK3ClockSlots
// int64 (see k1_clocks).
int loam_k1_set_clocks(void* buf) {
    long long* p = static_cast<long long*>(buf);
    return static_cast<int>(cudaMemcpyToSymbol(k1_clocks, &p, sizeof(p)));
}
#endif

#ifdef LOAM_K4_CLOCKS
// Where K4's clock build writes: k4_blocks x kK4Warps x kK4ClockSlots
// int64 (see k4_clocks).
int loam_k4_set_clocks(void* buf) {
    long long* p = static_cast<long long*>(buf);
    return static_cast<int>(cudaMemcpyToSymbol(k4_clocks, &p, sizeof(p)));
}
#endif

// One empty launch (a measurement aid: the device time of a launch that
// does nothing).
int loam_empty(void* stream) {
    empty_kernel<<<1, kK4Threads, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}

// `n` grid barriers on K3's grid (counters as for loam_gn_loop).
int loam_barrier_probe(void* counters, int n, void* stream) {
    int n_blocks = gn_loop_grid_cached();
    if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidDevice);
    unsigned* counters_p = static_cast<unsigned*>(counters);
    void* args[] = {&counters_p, &n};
    cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(barrier_probe_kernel), dim3(n_blocks),
        dim3(kK3Threads), args, 0, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
