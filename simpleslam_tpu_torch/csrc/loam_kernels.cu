// LOAM point-to-plane Gauss-Newton kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel simpleslam_tpu/ops/loam_pallas.py::_kernel
// (called through normal_equations_t): per query 5-NN by argmin rounds with
// a first-index tie-break, the 5th-NN gate, the centred 5-point scatter, the
// closed-form 3x3 eigensolve, the planar / thickness / plane-residual gates,
// the weight s = 1 - 0.9 |d| / sqrt(r) and the J row s [n, p x n], reduced
// to J^T J (6x6), J^T e (6) and the valid-row count. The TPU kernel carried
// the sums across a sequential grid; blocks here run in no order, so every
// reduction goes through per-block partial sums that are added in block
// order. No float atomics anywhere: results repeat bit for bit run to run.
//
// K1 loam_fit_and_linearize_merged: the whole TPU kernel with the merged-row
//    gather folded in. One warp per query reads the query's one int16 row of
//    8 voxels x M points x 3 (1,152 B at M = 24) straight from the merged
//    voxel map, dequantizes it in registers and runs selection, plane fit,
//    gates and the J row; the (Q, 8M, 3) candidate tensor never exists in
//    device memory. It also writes the plane set for K2. Bound: the valid
//    queries' scattered row reads (bytes).
// K2 loam_plane_normal_equations: the TPU kernel's second half (its rows
//    after the plane fit) against a frozen plane set, one thread per query.
//    Bound: launch overhead and a (Q, 10)-float stream (bytes).
// K3 loam_gn_loop: a scan's whole Gauss-Newton registration in one
//    cooperative launch, K1's and K2's bodies as its phases (the TPU package
//    runs the same loop as one lax.while_loop around the kernel). Bound: the
//    row reads of its K1 phases (bytes); what it removes is everything
//    between them: the launches, the 6x6 solve and pose update as separate
//    small kernels, and the host read that decided each iteration. Design:
//    - one persistent block per SM; block b owns queries b, b + G, ... (the
//      scan's valid queries come first, so striding balances the SMs);
//    - a block keeps its queries' source points, sqrt(r), validity and
//      fitted planes in shared memory over all iterations, so a K2 phase
//      reads nothing from device memory;
//    - in a K1 phase each warp owns a query at a time and double-buffers
//      its rows with cp.async: the next valid query's row is in flight
//      while the five selection rounds run on the current one; masked-out
//      queries are skipped before any load;
//    - one grid barrier per iteration (an integer counter, __threadfence):
//      blocks publish 28 partial sums, pass the barrier, then each block
//      adds all partials in block order and takes the small step
//      (csrc/gn_step.h) itself. Every block computes the same step from the
//      same numbers, so all agree on every branch around the barrier;
//      partials alternate between two buffers so a fast block cannot
//      overwrite what a slow one still reads.
//
// K4 loam_fit_and_linearize_candidates: the TPU kernel in its own form,
//    candidates in, normal equations out, for the targets whose gather stays
//    in torch (the dense map's corner gather, the sorted table's 27-cell key
//    search). One warp per query reads the query's (C, 3) f32 candidates and
//    (C,) validity flags straight from device memory, once, into registers
//    (C <= 256), and runs the same selection, plane fit, gates and J row as
//    K1 through the same device functions; it writes the plane set for K2.
//    Bound: the candidate stream (bytes): the C flags of every valid query,
//    one byte each, and 12 bytes of coordinates for every set flag; a
//    masked-out query's flags are all false and it needs no candidate.
//
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

#include "gn_step.h"

namespace {

constexpr int kPlanePts = 5;
constexpr float kMaxSearchSq = 1.0f;
constexpr float kPlaneValid = 0.2f;
constexpr float kPointValid = 0.1f;
constexpr float kMinPlanarEv = 1e-2f;
constexpr float kMaxThicknessEv = 2e-2f;
constexpr int16_t kPadQ = 32767;
constexpr float kQOff = 16384.0f;
constexpr int kNSums = 28;      // 21 unique J^T J, 6 J^T e, 1 count
constexpr int kMaxCand = 256;   // 8 candidates per lane
constexpr int kCandPerLane = kMaxCand / 32;
constexpr int kK1Warps = 8;     // warps per K1 block
constexpr int kK1QueriesPerWarp = 4;
constexpr int kK2Threads = 256;
constexpr int kK3Warps = 16;    // warps of the one K3 block per SM
constexpr int kK3Threads = kK3Warps * 32;
constexpr int kRowBufElems = kMaxCand * 3;   // int16 per staged row
constexpr int kPartStride = 32;  // floats per block partial: sums, r_max, pad
constexpr int kQueryFloats = 10;  // K3 per-query floats: p_src, sqrt_r, plane

struct Plane {
    float cx, cy, cz, nx, ny, nz;
    bool ok;
};

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

// Point-to-plane row of one query against its plane: adds J J^T, J e and 1
// to acc when the row is valid (plane ok and s > POINT_VALID_THRESH).
__device__ void accumulate_row(const Plane& pl, float px, float py, float pz,
                               float sqrt_r, float* acc) {
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
// that is masked out or outside the window.
__device__ __forceinline__ const int16_t* merged_row(
        const MapGeom& g, bool valid, float px, float py, float pz) {
    const int bx = static_cast<int>(floorf((px - g.cx0) / g.grid - 0.5f)) + 1;
    const int by = static_cast<int>(floorf((py - g.cy0) / g.grid - 0.5f)) + 1;
    const int bz = static_cast<int>(floorf((pz - g.cz0) / g.grid - 0.5f)) + 1;
    const bool in = valid && bx >= 0 && bx < g.mx && by >= 0 && by < g.my
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

// A query's gathered (C, 3) f32 candidates and (C,) 0/1 flags in device
// memory; neighbouring lanes read neighbouring candidates.
struct FloatCand {
    const float* cand;
    const uint8_t* ok;
    __device__ __forceinline__ bool get(int c, float& x, float& y,
                                        float& z) const {
        if (!__ldg(ok + c)) return false;
        x = __ldg(cand + 3 * c);
        y = __ldg(cand + 3 * c + 1);
        z = __ldg(cand + 3 * c + 2);
        return true;
    }
};

// 5-NN selection, plane fit and gates of one query against its n_cand
// candidates, by one warp; every lane returns the same plane.
template <int kSlots, class Cand>
__device__ Plane select_and_fit_n(const Cand& cd, int n_cand, bool valid,
                                  float px, float py, float pz, int lane) {
    // squared distances of this lane's candidates c = lane + 32 j
    float d2[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
        const int c = lane + 32 * j;
        d2[j] = CUDART_INF_F;
        float cx, cy, cz;
        if (c < n_cand && cd.get(c, cx, cy, cz)) {
            const float dx = cx - px, dy = cy - py, dz = cz - pz;
            d2[j] = dx * dx + dy * dy + dz * dz;
        }
    }
    // five argmin rounds; (d^2, index) compared lexicographically is the
    // reference's "min, then the first index among hits"
    int sel[kPlanePts];
    int n_sel = 0;
    float d_k = CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < kPlanePts; ++k) {
        float bd = CUDART_INF_F;
        int bc = 0x7fffffff;
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
            const int c = lane + 32 * j;
            if (d2[j] < bd || (d2[j] == bd && c < bc)) { bd = d2[j]; bc = c; }
        }
        {
            // the warp's minimum distance, then the first index among the
            // lanes that hold it: two hardware warp reductions (non-negative
            // floats order like their bit patterns)
            const unsigned mine = __float_as_uint(bd);
            const unsigned m = __reduce_min_sync(0xffffffffu, mine);
            bc = static_cast<int>(__reduce_min_sync(
                0xffffffffu, mine == m ? static_cast<unsigned>(bc)
                                       : 0x7fffffffu));
            bd = __uint_as_float(m);
        }
        d_k = bd;
        sel[k] = -1;
        if (bd < CUDART_INF_F) {
            sel[k] = bc;
            ++n_sel;
#pragma unroll
            for (int j = 0; j < kSlots; ++j)
                if (lane + 32 * j == bc) d2[j] = CUDART_INF_F;
        }
    }
    const bool gate = valid && d_k < kMaxSearchSq && n_sel >= kPlanePts;

    // selected points in candidate-index order (the order a masked sum
    // over the candidate axis visits them)
#pragma unroll
    for (int a = 1; a < kPlanePts; ++a)
#pragma unroll
        for (int b = a; b > 0; --b)
            if (static_cast<unsigned>(sel[b]) < static_cast<unsigned>(sel[b - 1])) {
                const int t = sel[b]; sel[b] = sel[b - 1]; sel[b - 1] = t;
            }
    float x[kPlanePts], y[kPlanePts], z[kPlanePts];
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
#pragma unroll
    for (int k = 0; k < kPlanePts; ++k) {
        x[k] = y[k] = z[k] = 0.0f;
        if (sel[k] >= 0) {
            cd.get(sel[k], x[k], y[k], z[k]);   // a selected one is no padding
            sx += x[k]; sy += y[k]; sz += z[k];
        }
    }
    Plane pl;
    pl.cx = sx / 5.0f;
    pl.cy = sy / 5.0f;
    pl.cz = sz / 5.0f;
    float m00 = 0.f, m01 = 0.f, m02 = 0.f, m11 = 0.f, m12 = 0.f, m22 = 0.f;
#pragma unroll
    for (int k = 0; k < kPlanePts; ++k) {
        if (sel[k] < 0) continue;
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
        if (sel[k] < 0) continue;
        const float r = (x[k] - pl.cx) * pl.nx + (y[k] - pl.cy) * pl.ny
                      + (z[k] - pl.cz) * pl.nz;
        rmax = fmaxf(rmax, fabsf(r));
    }
    pl.ok = gate && fit_ok && rmax <= kPlaneValid;
    return pl;
}

// Each lane owns candidates lane, lane + 32, ...: 6 of them at the usual 192
// candidates per query (8 voxels x 24), 8 at the most (kMaxCand).
template <class Cand>
__device__ __forceinline__ Plane select_and_fit_any(
        const Cand& cd, int n_cand, bool valid, float px, float py, float pz,
        int lane) {
    if (n_cand <= 6 * 32)
        return select_and_fit_n<6>(cd, n_cand, valid, px, py, pz, lane);
    return select_and_fit_n<kCandPerLane>(cd, n_cand, valid, px, py, pz,
                                          lane);
}

// The selection against a staged merged row.
__device__ __forceinline__ Plane select_and_fit(
        const int16_t* srow, const MapGeom& g, bool valid, float px, float py,
        float pz, int lane) {
    const QuantRow cd = {srow, g.scale, g.cx0, g.cy0, g.cz0};
    return select_and_fit_any(cd, g.n_cand, valid, px, py, pz, lane);
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

// K1: one warp per query, kK1QueriesPerWarp queries per warp in order, block
// partials summed over warps in order.
__global__ void __launch_bounds__(kK1Warps * 32)
fit_and_linearize_merged_kernel(
        const int16_t* __restrict__ rows, int n_cand, const float* scale_p,
        const float* corner_p, const float* grid_p, int gx, int gy, int gz,
        const float* __restrict__ p_map, const float* __restrict__ sqrt_r,
        const uint8_t* __restrict__ mask, int n_q,
        float* __restrict__ centroid, float* __restrict__ normal,
        uint8_t* __restrict__ ok_out, float* __restrict__ partials) {
    __shared__ __align__(16) int16_t s_row[kK1Warps][kRowBufElems];
    __shared__ float s_acc[kK1Warps][kNSums];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const MapGeom g = load_geom(rows, n_cand, scale_p, corner_p, grid_p, gx,
                                gy, gz);
    const int row_chunks = n_cand * 3 * 2 / 16;   // 16-byte chunks per row
    int16_t* srow = s_row[warp];

    float acc[kNSums];
#pragma unroll
    for (int k = 0; k < kNSums; ++k) acc[k] = 0.0f;

    for (int it = 0; it < kK1QueriesPerWarp; ++it) {
        const int qi = (blockIdx.x * kK1Warps + warp) * kK1QueriesPerWarp + it;
        if (qi >= n_q) break;
        const float px = p_map[3 * qi], py = p_map[3 * qi + 1],
                    pz = p_map[3 * qi + 2];
        const bool valid = mask[qi] != 0;
        const int4* src = reinterpret_cast<const int4*>(
            merged_row(g, valid, px, py, pz));
        int4* dst = reinterpret_cast<int4*>(srow);
        __syncwarp();
        for (int k = lane; k < row_chunks; k += 32) dst[k] = src[k];
        __syncwarp();
        const Plane pl = select_and_fit(srow, g, valid, px, py, pz, lane);
        if (lane == 0) {
            centroid[3 * qi] = pl.cx; centroid[3 * qi + 1] = pl.cy;
            centroid[3 * qi + 2] = pl.cz;
            normal[3 * qi] = pl.nx; normal[3 * qi + 1] = pl.ny;
            normal[3 * qi + 2] = pl.nz;
            ok_out[qi] = pl.ok ? 1 : 0;
            accumulate_row(pl, px, py, pz, sqrt_r[qi], acc);
        }
    }
    const float t = block_sums<kK1Warps>(acc, s_acc);
    if (threadIdx.x < kNSums) partials[blockIdx.x * kNSums + threadIdx.x] = t;
}

// K4: one warp per query on its gathered f32 candidates, laid out and
// reduced like K1 (kK1QueriesPerWarp queries per warp in order, block
// partials summed over warps in order).
__global__ void __launch_bounds__(kK1Warps * 32)
fit_and_linearize_candidates_kernel(
        const float* __restrict__ cand, const uint8_t* __restrict__ cand_ok,
        int n_cand, const float* __restrict__ p_map,
        const float* __restrict__ sqrt_r, const uint8_t* __restrict__ mask,
        int n_q, float* __restrict__ centroid, float* __restrict__ normal,
        uint8_t* __restrict__ ok_out, float* __restrict__ partials) {
    __shared__ float s_acc[kK1Warps][kNSums];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    float acc[kNSums];
#pragma unroll
    for (int k = 0; k < kNSums; ++k) acc[k] = 0.0f;

    for (int it = 0; it < kK1QueriesPerWarp; ++it) {
        const int qi = (blockIdx.x * kK1Warps + warp) * kK1QueriesPerWarp + it;
        if (qi >= n_q) break;
        const float px = p_map[3 * qi], py = p_map[3 * qi + 1],
                    pz = p_map[3 * qi + 2];
        const bool valid = mask[qi] != 0;
        const size_t first = static_cast<size_t>(qi) * n_cand;
        const FloatCand cd = {cand + 3 * first, cand_ok + first};
        const Plane pl = select_and_fit_any(cd, n_cand, valid, px, py, pz,
                                            lane);
        if (lane == 0) {
            centroid[3 * qi] = pl.cx; centroid[3 * qi + 1] = pl.cy;
            centroid[3 * qi + 2] = pl.cz;
            normal[3 * qi] = pl.nx; normal[3 * qi + 1] = pl.ny;
            normal[3 * qi + 2] = pl.nz;
            ok_out[qi] = pl.ok ? 1 : 0;
            accumulate_row(pl, px, py, pz, sqrt_r[qi], acc);
        }
    }
    const float t = block_sums<kK1Warps>(acc, s_acc);
    if (threadIdx.x < kNSums) partials[blockIdx.x * kNSums + threadIdx.x] = t;
}

// K2: one thread per query against the frozen plane set.
__global__ void __launch_bounds__(kK2Threads)
plane_normal_equations_kernel(
        const float* __restrict__ centroid, const float* __restrict__ normal,
        const uint8_t* __restrict__ ok, const float* __restrict__ p_map,
        const float* __restrict__ sqrt_r, int n_q,
        float* __restrict__ partials) {
    __shared__ float s_acc[kK2Threads / 32][kNSums];
    const int qi = blockIdx.x * kK2Threads + threadIdx.x;
    float acc[kNSums];
#pragma unroll
    for (int k = 0; k < kNSums; ++k) acc[k] = 0.0f;
    if (qi < n_q) {
        Plane pl;
        pl.cx = centroid[3 * qi]; pl.cy = centroid[3 * qi + 1];
        pl.cz = centroid[3 * qi + 2];
        pl.nx = normal[3 * qi]; pl.ny = normal[3 * qi + 1];
        pl.nz = normal[3 * qi + 2];
        pl.ok = ok[qi] != 0;
        accumulate_row(pl, p_map[3 * qi], p_map[3 * qi + 1], p_map[3 * qi + 2],
                       sqrt_r[qi], acc);
    }
    const float t = block_sums<kK2Threads / 32>(acc, s_acc);
    if (threadIdx.x < kNSums) partials[blockIdx.x * kNSums + threadIdx.x] = t;
}

// Sum t of the 28 expanded into the symmetric 6x6 J^T J (row-major), J^T e
// and the count.
__device__ __forceinline__ void expand_sum(int t, float s, float* jtj,
                                           float* jte, int32_t* n_valid) {
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

// Second pass shared by K1, K2 and K4: block partials summed in block order,
// then expanded to the symmetric 6x6 J^T J, J^T e and the int count.
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       int n_blocks, float* __restrict__ jtj,
                                       float* __restrict__ jte,
                                       int32_t* __restrict__ n_valid) {
    const int t = threadIdx.x;
    if (t >= kNSums) return;
    float s = 0.0f;
    for (int b = 0; b < n_blocks; ++b) s += partials[b * kNSums + t];
    expand_sum(t, s, jtj, jte, n_valid);
}

// ---------------------------------------------------------------------------
// K3: the whole GN loop of one scan in one cooperative launch
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one of this thread's copy groups is still in flight.
__device__ __forceinline__ void cp_async_wait_but_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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
__device__ __forceinline__ void grid_barrier(unsigned* counter,
                                             unsigned target) {
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(counter, 1u);
        while (ld_acquire(counter) < target) {}
        __threadfence();
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

// Dynamic shared memory of K3: the warps' double row buffers, the staged
// partials of all blocks, then the block's per-query state.
__host__ __device__ inline size_t gn_loop_smem_bytes(int n_q, int grid) {
    const size_t n_local = static_cast<size_t>((n_q + grid - 1) / grid);
    return sizeof(int16_t) * kK3Warps * 2 * kRowBufElems
         + sizeof(float) * grid * kPartStride
         + sizeof(float) * kQueryFloats * n_local + 2 * n_local;
}

__global__ void __launch_bounds__(kK3Threads, 1)
gn_loop_kernel(
        const int16_t* __restrict__ rows, int n_cand, const float* scale_p,
        const float* corner_p, const float* grid_p, int gx, int gy, int gz,
        const float* __restrict__ src_xyz, const uint8_t* __restrict__ mask,
        int n_q, const float* __restrict__ init_pose, int max_iters,
        float degen_per_row, float* partials, unsigned* counters,
        float* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ float s_acc[kK3Warps][kNSums];
    __shared__ float s_sum[kPartStride];
    __shared__ float s_pose[12], s_anchor[12];
    __shared__ float s_wmax[kK3Warps];
    __shared__ float s_rmax;
    __shared__ int s_ctl[4];   // stop, refit, converged, n_valid

    const int n_blocks = gridDim.x;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int n_local_max = (n_q + n_blocks - 1) / n_blocks;
    const int first = blockIdx.x;   // queries first, first + G, ...
    const int n_local = first < n_q
        ? (n_q - first + n_blocks - 1) / n_blocks : 0;

    int16_t* s_rows = reinterpret_cast<int16_t*>(smem_raw);
    float* s_all = reinterpret_cast<float*>(
        s_rows + kK3Warps * 2 * kRowBufElems);
    float* s_x = s_all + n_blocks * kPartStride;
    float* s_y = s_x + n_local_max;
    float* s_z = s_y + n_local_max;
    float* s_sqrt_r = s_z + n_local_max;
    float* s_plane = s_sqrt_r + n_local_max;     // 6 floats per query
    uint8_t* s_ok = reinterpret_cast<uint8_t*>(s_plane + 6 * n_local_max);
    uint8_t* s_valid = s_ok + n_local_max;

    const MapGeom g = load_geom(rows, n_cand, scale_p, corner_p, grid_p, gx,
                                gy, gz);
    const int row_chunks = n_cand * 3 * 2 / 16;

    // prologue: the block's queries, sqrt(max(|p|, 1e-6)) and the block's
    // largest valid range; the start pose
    float my_rmax = 0.0f;
    for (int j = tid; j < n_local; j += kK3Threads) {
        const int qi = first + j * n_blocks;
        const float x = src_xyz[3 * qi], y = src_xyz[3 * qi + 1],
                    z = src_xyz[3 * qi + 2];
        const bool valid = mask[qi] != 0;
        const float r = gn::norm3(x, y, z);
        s_x[j] = x; s_y[j] = y; s_z[j] = z;
        s_sqrt_r[j] = sqrtf(fmaxf(r, 1e-6f));
        s_valid[j] = valid ? 1 : 0;
        s_ok[j] = 0;
        if (valid) my_rmax = fmaxf(my_rmax, r);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        my_rmax = fmaxf(my_rmax, __shfl_xor_sync(0xffffffffu, my_rmax, off));
    if (lane == 0) s_wmax[warp] = my_rmax;
    if (tid < 12) {
        const int src = tid < 9 ? (tid / 3) * 4 + tid % 3 : (tid - 9) * 4 + 3;
        s_pose[tid] = init_pose[src];
        s_anchor[tid] = init_pose[src];
    }
    __syncthreads();
    float block_rmax = 0.0f;
    for (int w = 0; w < kK3Warps; ++w) block_rmax = fmaxf(block_rmax, s_wmax[w]);

    int iters = 0, gathers = 0;
    bool refit = true;
    while (true) {
        float pose[12];
#pragma unroll
        for (int i = 0; i < 12; ++i) pose[i] = s_pose[i];
        float acc[kNSums];
#pragma unroll
        for (int k = 0; k < kNSums; ++k) acc[k] = 0.0f;

        if (refit) {
            // K1 phase: warp `warp` takes the block's valid queries warp,
            // warp + W, ...; the next one's row is on its way (cp.async)
            // while this one's selection runs
            ++gathers;
            int16_t* bufs = s_rows + warp * 2 * kRowBufElems;
            int j = warp;
            while (j < n_local && !s_valid[j]) j += kK3Warps;
            int stage = 0;
            float p[3];
            if (j < n_local) {
                transform_point(pose, s_x[j], s_y[j], s_z[j], p);
                const int4* src = reinterpret_cast<const int4*>(
                    merged_row(g, true, p[0], p[1], p[2]));
                int4* dst = reinterpret_cast<int4*>(bufs);
                for (int k = lane; k < row_chunks; k += 32)
                    cp_async16(dst + k, src + k);
            }
            cp_async_commit();
            while (j < n_local) {
                int jn = j + kK3Warps;
                while (jn < n_local && !s_valid[jn]) jn += kK3Warps;
                if (jn < n_local) {
                    float pn[3];
                    transform_point(pose, s_x[jn], s_y[jn], s_z[jn], pn);
                    const int4* src = reinterpret_cast<const int4*>(
                        merged_row(g, true, pn[0], pn[1], pn[2]));
                    int4* dst = reinterpret_cast<int4*>(
                        bufs + (stage ^ 1) * kRowBufElems);
                    for (int k = lane; k < row_chunks; k += 32)
                        cp_async16(dst + k, src + k);
                }
                cp_async_commit();   // an empty group after the last query
                cp_async_wait_but_one();
                __syncwarp();
                transform_point(pose, s_x[j], s_y[j], s_z[j], p);
                const Plane pl = select_and_fit(bufs + stage * kRowBufElems, g,
                                                true, p[0], p[1], p[2], lane);
                if (lane == 0) {
                    float* dst = s_plane + 6 * j;
                    dst[0] = pl.cx; dst[1] = pl.cy; dst[2] = pl.cz;
                    dst[3] = pl.nx; dst[4] = pl.ny; dst[5] = pl.nz;
                    s_ok[j] = pl.ok ? 1 : 0;
                    accumulate_row(pl, p[0], p[1], p[2], s_sqrt_r[j], acc);
                }
                __syncwarp();   // the buffer is free for the load after next
                j = jn;
                stage ^= 1;
            }
        } else {
            // K2 phase: one thread per query against the kept planes
            for (int j = tid; j < n_local; j += kK3Threads) {
                if (!s_ok[j]) continue;
                const float* src = s_plane + 6 * j;
                Plane pl;
                pl.cx = src[0]; pl.cy = src[1]; pl.cz = src[2];
                pl.nx = src[3]; pl.ny = src[4]; pl.nz = src[5];
                pl.ok = true;
                float p[3];
                transform_point(pose, s_x[j], s_y[j], s_z[j], p);
                accumulate_row(pl, p[0], p[1], p[2], s_sqrt_r[j], acc);
            }
        }

        // publish this block's partial sums, meet the other blocks, then
        // add all partials in block order: every block gets the same sums
        float* mine = partials
            + (static_cast<size_t>(iters & 1) * n_blocks + blockIdx.x)
              * kPartStride;
        const float t = block_sums<kK3Warps>(acc, s_acc);
        if (tid < kNSums) mine[tid] = t;
        if (tid == kNSums) mine[kNSums] = block_rmax;
        grid_barrier(&counters[0],
                     static_cast<unsigned>(n_blocks) * (iters + 1));
        const float* all = partials
            + static_cast<size_t>(iters & 1) * n_blocks * kPartStride;
        for (int i = tid; i < n_blocks * kPartStride; i += kK3Threads)
            s_all[i] = __ldcg(all + i);
        __syncthreads();
        if (tid < kNSums) {
            float s = 0.0f;
            for (int b = 0; b < n_blocks; ++b) s += s_all[b * kPartStride + tid];
            s_sum[tid] = s;
        } else if (tid == kNSums) {
            float m = 0.0f;
            for (int b = 0; b < n_blocks; ++b)
                m = fmaxf(m, s_all[b * kPartStride + kNSums]);
            s_sum[kNSums] = m;
        }
        __syncthreads();

        // the small step, taken by every block on the same numbers
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
        ++iters;
        refit = s_ctl[1] != 0;
        if (s_ctl[0]) break;
    }

    // epilogue: one result row [pose (4x4), converged, iters, gathers,
    // n_valid of the last linearization]
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
}

// `n` grid barriers and nothing else, on K3's grid: the barrier's cost.
__global__ void __launch_bounds__(kK3Threads, 1)
barrier_probe_kernel(unsigned* counters, int n) {
    for (int i = 0; i < n; ++i)
        grid_barrier(&counters[0], gridDim.x * static_cast<unsigned>(i + 1));
    grid_barrier_release(counters);
}

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

}  // namespace

extern "C" {

int loam_k1_blocks(int n_q) {
    const int per_block = kK1Warps * kK1QueriesPerWarp;
    return (n_q + per_block - 1) / per_block;
}

int loam_k2_blocks(int n_q) { return (n_q + kK2Threads - 1) / kK2Threads; }

int loam_max_candidates() { return kMaxCand; }

int loam_fit_and_linearize_merged(
        const void* rows, int n_cand, const void* scale, const void* corner,
        const void* grid, int gx, int gy, int gz, const void* p_map,
        const void* sqrt_r, const void* mask, int n_q, void* centroid,
        void* normal, void* ok, void* partials, void* jtj, void* jte,
        void* n_valid, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nb = loam_k1_blocks(n_q);
    fit_and_linearize_merged_kernel<<<nb, kK1Warps * 32, 0, st>>>(
        static_cast<const int16_t*>(rows), n_cand,
        static_cast<const float*>(scale), static_cast<const float*>(corner),
        static_cast<const float*>(grid), gx, gy, gz,
        static_cast<const float*>(p_map), static_cast<const float*>(sqrt_r),
        static_cast<const uint8_t*>(mask), n_q, static_cast<float*>(centroid),
        static_cast<float*>(normal), static_cast<uint8_t*>(ok),
        static_cast<float*>(partials));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    reduce_partials_kernel<<<1, 32, 0, st>>>(
        static_cast<const float*>(partials), nb, static_cast<float*>(jtj),
        static_cast<float*>(jte), static_cast<int32_t*>(n_valid));
    return static_cast<int>(cudaGetLastError());
}

// K4: candidates (n_q, n_cand, 3) f32 and flags (n_q, n_cand) uint8, both
// contiguous; outputs and partials (loam_k1_blocks(n_q) x 28) as for K1.
int loam_fit_and_linearize_candidates(
        const void* cand, const void* cand_ok, int n_cand, const void* p_map,
        const void* sqrt_r, const void* mask, int n_q, void* centroid,
        void* normal, void* ok, void* partials, void* jtj, void* jte,
        void* n_valid, void* stream) {
    if (n_cand < 1 || n_cand > kMaxCand)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nb = loam_k1_blocks(n_q);
    fit_and_linearize_candidates_kernel<<<nb, kK1Warps * 32, 0, st>>>(
        static_cast<const float*>(cand), static_cast<const uint8_t*>(cand_ok),
        n_cand, static_cast<const float*>(p_map),
        static_cast<const float*>(sqrt_r), static_cast<const uint8_t*>(mask),
        n_q, static_cast<float*>(centroid), static_cast<float*>(normal),
        static_cast<uint8_t*>(ok), static_cast<float*>(partials));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    reduce_partials_kernel<<<1, 32, 0, st>>>(
        static_cast<const float*>(partials), nb, static_cast<float*>(jtj),
        static_cast<float*>(jte), static_cast<int32_t*>(n_valid));
    return static_cast<int>(cudaGetLastError());
}

int loam_plane_normal_equations(
        const void* centroid, const void* normal, const void* ok,
        const void* p_map, const void* sqrt_r, int n_q, void* partials,
        void* jtj, void* jte, void* n_valid, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nb = loam_k2_blocks(n_q);
    plane_normal_equations_kernel<<<nb, kK2Threads, 0, st>>>(
        static_cast<const float*>(centroid), static_cast<const float*>(normal),
        static_cast<const uint8_t*>(ok), static_cast<const float*>(p_map),
        static_cast<const float*>(sqrt_r), n_q, static_cast<float*>(partials));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    reduce_partials_kernel<<<1, 32, 0, st>>>(
        static_cast<const float*>(partials), nb, static_cast<float*>(jtj),
        static_cast<float*>(jte), static_cast<int32_t*>(n_valid));
    return static_cast<int>(cudaGetLastError());
}

// Blocks of K3's cooperative grid on the current device (0 on an error);
// its workspace is 2 x blocks x loam_gn_loop_partial_stride() floats of
// partials plus two zeroed 32-bit counters.
int loam_gn_loop_grid() { return gn_loop_grid_cached(); }

int loam_gn_loop_partial_stride() { return kPartStride; }

// Dynamic shared memory K3 needs for n_q queries, in bytes.
long long loam_gn_loop_smem(int n_q) {
    const int grid = gn_loop_grid_cached();
    if (grid <= 0) return -1;
    return static_cast<long long>(gn_loop_smem_bytes(n_q, grid));
}

int loam_gn_loop(
        const void* rows, int n_cand, const void* scale, const void* corner,
        const void* grid_size, int gx, int gy, int gz, const void* src_xyz,
        const void* mask, int n_q, const void* init_pose, int max_iters,
        float degen_per_row, void* partials, void* counters, void* out,
        void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int n_blocks = gn_loop_grid_cached();
    if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidDevice);
    size_t smem = gn_loop_smem_bytes(n_q, n_blocks);
    if (smem > 48 * 1024) {   // above the default limit only on request
        cudaError_t err = cudaFuncSetAttribute(
            gn_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int16_t* rows_p = static_cast<const int16_t*>(rows);
    const float* scale_p = static_cast<const float*>(scale);
    const float* corner_p = static_cast<const float*>(corner);
    const float* grid_p = static_cast<const float*>(grid_size);
    const float* src_p = static_cast<const float*>(src_xyz);
    const uint8_t* mask_p = static_cast<const uint8_t*>(mask);
    const float* pose_p = static_cast<const float*>(init_pose);
    float* partials_p = static_cast<float*>(partials);
    unsigned* counters_p = static_cast<unsigned*>(counters);
    float* out_p = static_cast<float*>(out);
    void* args[] = {&rows_p, &n_cand, &scale_p, &corner_p, &grid_p, &gx, &gy,
                    &gz, &src_p, &mask_p, &n_q, &pose_p, &max_iters,
                    &degen_per_row, &partials_p, &counters_p, &out_p};
    // a cooperative launch is refused, not queued, when its grid cannot be
    // co-resident: the error comes back from this call
    cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(gn_loop_kernel), dim3(n_blocks),
        dim3(kK3Threads), args, smem, st);
    if (err != cudaSuccess) return static_cast<int>(err);
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
