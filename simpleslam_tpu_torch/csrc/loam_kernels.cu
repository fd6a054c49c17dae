// LOAM point-to-plane linearization kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel simpleslam_tpu/ops/loam_pallas.py::_kernel
// (called through normal_equations_t): per query 5-NN by argmin rounds with
// a first-index tie-break, the 5th-NN gate, the centred 5-point scatter, the
// closed-form 3x3 eigensolve, the planar / thickness / plane-residual gates,
// the weight s = 1 - 0.9 |d| / sqrt(r) and the J row s [n, p x n], reduced
// to J^T J (6x6), J^T e (6) and the valid-row count. The TPU kernel carried
// the sums across a sequential grid; blocks here run in no order, so each
// block writes 28 partial sums and a second launch adds them in a fixed
// order. No float atomics anywhere: results repeat bit for bit run to run.
//
// K1 loam_fit_and_linearize_merged: the whole TPU kernel with the merged-row
//    gather folded in. One warp per query reads the query's one int16 row of
//    8 voxels x M points x 3 (1,152 B at M = 24) straight from the merged
//    voxel map, dequantizes it in registers and runs selection, plane fit,
//    gates and the J row; the (Q, 8M, 3) candidate tensor never exists in
//    device memory. It also writes the plane set for K2. Bound: Q scattered
//    row reads (about 9.4 MB per call at Q = 8192) plus the per-query
//    selection work. Design: the row is staged in shared memory with 16-byte
//    loads (coalesced within the row), each lane owns C/32 candidates, and
//    the five argmin rounds are warp shuffles on (d^2, index) pairs.
// K2 loam_plane_normal_equations: the TPU kernel's second half (its rows
//    after the plane fit) against a frozen plane set, one thread per query.
//    Bound: launch overhead and a (Q, 6)-sized stream of plane data.
//    Design: one pass, warp-shuffle tree sums in a fixed order.
//
// Arithmetic follows the plain PyTorch versions in ops/loam_kernels.py op for
// op. The library is built with -fmad=false so no multiply-add is contracted
// behind the source's back; the one fused multiply-add that the plain
// version also performs (the int16 dequantization, torch.addcmul) is an
// explicit fmaf.
//
// Plain C interface for ctypes; every entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

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

struct Plane {
    float cx, cy, cz, nx, ny, nz;
    bool ok;
};

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
    __shared__ __align__(16) int16_t s_row[kK1Warps][kMaxCand * 3];
    __shared__ float s_acc[kK1Warps][kNSums];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const float scale = *scale_p, grid = *grid_p;
    const float cx0 = corner_p[0], cy0 = corner_p[1], cz0 = corner_p[2];
    const int mx = gx + 1, my = gy + 1, mz = gz + 1;
    const int64_t sentinel = static_cast<int64_t>(mx) * my * mz;
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
        // corner-selected 2x2x2 block, row base + 1 (voxel.gather_neighbors_merged)
        const int bx = static_cast<int>(floorf((px - cx0) / grid - 0.5f)) + 1;
        const int by = static_cast<int>(floorf((py - cy0) / grid - 0.5f)) + 1;
        const int bz = static_cast<int>(floorf((pz - cz0) / grid - 0.5f)) + 1;
        const bool in = mask[qi] && bx >= 0 && bx < mx && by >= 0 && by < my
                        && bz >= 0 && bz < mz;
        const int64_t flat = in ? (static_cast<int64_t>(bx) * my + by) * mz + bz
                                : sentinel;
        const int4* src = reinterpret_cast<const int4*>(
            rows + flat * static_cast<int64_t>(n_cand) * 3);
        int4* dst = reinterpret_cast<int4*>(srow);
        __syncwarp();
        for (int k = lane; k < row_chunks; k += 32) dst[k] = src[k];
        __syncwarp();

        // squared distances of this lane's candidates c = lane + 32 j
        float d2[kCandPerLane];
#pragma unroll
        for (int j = 0; j < kCandPerLane; ++j) {
            const int c = lane + 32 * j;
            d2[j] = CUDART_INF_F;
            if (c < n_cand && srow[3 * c] != kPadQ) {
                const float dx = dequant(srow[3 * c], scale, cx0) - px;
                const float dy = dequant(srow[3 * c + 1], scale, cy0) - py;
                const float dz = dequant(srow[3 * c + 2], scale, cz0) - pz;
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
            for (int j = 0; j < kCandPerLane; ++j) {
                const int c = lane + 32 * j;
                if (d2[j] < bd || (d2[j] == bd && c < bc)) { bd = d2[j]; bc = c; }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                const float od = __shfl_xor_sync(0xffffffffu, bd, off);
                const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
                if (od < bd || (od == bd && oc < bc)) { bd = od; bc = oc; }
            }
            d_k = bd;
            sel[k] = -1;
            if (bd < CUDART_INF_F) {
                sel[k] = bc;
                ++n_sel;
#pragma unroll
                for (int j = 0; j < kCandPerLane; ++j)
                    if (lane + 32 * j == bc) d2[j] = CUDART_INF_F;
            }
        }
        const bool gate = mask[qi] && d_k < kMaxSearchSq && n_sel >= kPlanePts;

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
                const int c = sel[k];
                x[k] = dequant(srow[3 * c], scale, cx0);
                y[k] = dequant(srow[3 * c + 1], scale, cy0);
                z[k] = dequant(srow[3 * c + 2], scale, cz0);
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
        if (lane == 0) {
            centroid[3 * qi] = pl.cx; centroid[3 * qi + 1] = pl.cy;
            centroid[3 * qi + 2] = pl.cz;
            normal[3 * qi] = pl.nx; normal[3 * qi + 1] = pl.ny;
            normal[3 * qi + 2] = pl.nz;
            ok_out[qi] = pl.ok ? 1 : 0;
            accumulate_row(pl, px, py, pz, sqrt_r[qi], acc);
        }
    }
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kNSums; ++k) s_acc[warp][k] = acc[k];
    }
    __syncthreads();
    if (threadIdx.x < kNSums) {
        float t = 0.0f;
        for (int w = 0; w < kK1Warps; ++w) t += s_acc[w][threadIdx.x];
        partials[blockIdx.x * kNSums + threadIdx.x] = t;
    }
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
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < kNSums; ++k) {
        const float t = warp_sum(acc[k]);
        if (lane == 0) s_acc[warp][k] = t;
    }
    __syncthreads();
    if (threadIdx.x < kNSums) {
        float t = 0.0f;
        for (int w = 0; w < kK2Threads / 32; ++w) t += s_acc[w][threadIdx.x];
        partials[blockIdx.x * kNSums + threadIdx.x] = t;
    }
}

// Second pass shared by K1 and K2: block partials summed in block order,
// then expanded to the symmetric 6x6 J^T J, J^T e and the int count.
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       int n_blocks, float* __restrict__ jtj,
                                       float* __restrict__ jte,
                                       int32_t* __restrict__ n_valid) {
    const int t = threadIdx.x;
    if (t >= kNSums) return;
    float s = 0.0f;
    for (int b = 0; b < n_blocks; ++b) s += partials[b * kNSums + t];
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

}  // extern "C"
