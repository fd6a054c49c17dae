// The small step of the LOAM Gauss-Newton loop, in plain C++.
//
// Everything one GN iteration does after the normal equations are summed:
// the 6x6 solve (LU with partial pivoting, or the eigenbasis solve of the
// degeneracy guard by a cyclic Jacobi eigensolve), the convergence test,
// pose <- exp(dx) pose, the motion-since-the-plane-fit test, and the
// re-orthonormalization after the loop. The formulas follow
// ops/loam.py::_solve and ops/geometry.py (se3_exp, rot_to_quat,
// quat_to_rot) op for op, in f32.
//
// The CUDA kernel loam_gn_loop (loam_kernels.cu) includes this file and runs
// gn_step on the device; gn_step_host.cpp compiles the same file with g++
// behind a C entry point, so a CPU test holds the code the kernel runs
// against the torch formulas. No CUDA header is needed: GN_HD is
// "__host__ __device__" under nvcc and empty otherwise. Build both sides
// without multiply-add contraction (-fmad=false, -ffp-contract=off).

#ifndef SIMPLESLAM_GN_STEP_H_
#define SIMPLESLAM_GN_STEP_H_

#include <math.h>

#ifdef __CUDACC__
#define GN_HD __host__ __device__
// Every loop below has a constant trip count and is unrolled on the device,
// so each array index is a constant and the arrays live in registers: the
// step runs on one thread, and a dynamically indexed array would sit in
// local memory with a load's latency on every access of a serial chain.
#define GN_UNROLL _Pragma("unroll")
#else
#define GN_HD
#define GN_UNROLL
#endif

namespace gn {

constexpr float kPosConverge = 5e-3f;
constexpr float kRotConverge = 5e-3f;
constexpr int kMinValidRows = 6;
constexpr float kRegatherDist = 0.2f;
constexpr float kSmallAngleSq = 1e-12f;  // geometry._EPS squared

// Flags of one step (bit set).
constexpr int kFlagConv = 1;    // |dx_t|, |dx_r| under the thresholds
constexpr int kFlagEnough = 2;  // n_valid >= kMinValidRows

GN_HD inline float norm3(float x, float y, float z) {
    return sqrtf(x * x + y * y + z * z);
}

// Solve A x = b (6x6, row-major) by LU with partial pivoting, the first
// largest pivot on ties. A zero pivot divides by zero: the result is
// non-finite, never a trap.
GN_HD inline void lu_solve6(const float* A_in, const float* b_in, float* x) {
    float A[36], b[6];
    GN_UNROLL
    for (int i = 0; i < 36; ++i) A[i] = A_in[i];
    GN_UNROLL
    for (int i = 0; i < 6; ++i) b[i] = b_in[i];
    GN_UNROLL
    for (int k = 0; k < 6; ++k) {
        // bring the largest |A[i][k]|, i >= k, to row k by exchanges with
        // constant indices; a strict compare keeps the first of equals.
        // (The rows below k end up in another order than after one swap
        // with the argmax row; each row's arithmetic does not depend on
        // where it sits.)
        GN_UNROLL
        for (int i = k + 1; i < 6; ++i) {
            if (fabsf(A[i * 6 + k]) > fabsf(A[k * 6 + k])) {
                GN_UNROLL
                for (int j = k; j < 6; ++j) {
                    const float t = A[k * 6 + j];
                    A[k * 6 + j] = A[i * 6 + j];
                    A[i * 6 + j] = t;
                }
                const float t = b[k]; b[k] = b[i]; b[i] = t;
            }
        }
        const float piv = A[k * 6 + k];
        GN_UNROLL
        for (int i = k + 1; i < 6; ++i) {
            const float l = A[i * 6 + k] / piv;
            GN_UNROLL
            for (int j = k + 1; j < 6; ++j) A[i * 6 + j] -= l * A[k * 6 + j];
            b[i] -= l * b[k];
        }
    }
    GN_UNROLL
    for (int i = 5; i >= 0; --i) {
        float s = b[i];
        GN_UNROLL
        for (int j = i + 1; j < 6; ++j) s -= A[i * 6 + j] * x[j];
        x[i] = s / A[i * 6 + i];
    }
}

// Eigendecomposition of a symmetric 6x6 (row-major) by cyclic Jacobi
// rotations: A = V diag(w) V^T, eigenvalues in no particular order, V's
// columns the eigenvectors.
GN_HD inline void jacobi_eig6(const float* A_in, float* w, float* V) {
    float A[36];
    GN_UNROLL
    for (int i = 0; i < 36; ++i) {
        A[i] = A_in[i];
        V[i] = (i % 7 == 0) ? 1.0f : 0.0f;
    }
    for (int sweep = 0; sweep < 30; ++sweep) {
        float off = 0.0f;
        GN_UNROLL
        for (int p = 0; p < 5; ++p) {
            GN_UNROLL
            for (int q = p + 1; q < 6; ++q) off += fabsf(A[p * 6 + q]);
        }
        if (off == 0.0f) break;
        GN_UNROLL
        for (int p = 0; p < 5; ++p) {
            GN_UNROLL
            for (int q = p + 1; q < 6; ++q) {
                const float apq = A[p * 6 + q];
                if (apq == 0.0f) continue;
                const float app = A[p * 6 + p], aqq = A[q * 6 + q];
                const float g = 100.0f * fabsf(apq);
                if (sweep > 3 && fabsf(app) + g == fabsf(app)
                        && fabsf(aqq) + g == fabsf(aqq)) {
                    A[p * 6 + q] = 0.0f;   // negligible beside the diagonal
                    A[q * 6 + p] = 0.0f;
                    continue;
                }
                const float h = aqq - app;
                float t;
                if (fabsf(h) + g == fabsf(h)) {
                    t = apq / h;
                } else {
                    const float theta = 0.5f * h / apq;
                    t = 1.0f / (fabsf(theta) + sqrtf(theta * theta + 1.0f));
                    if (theta < 0.0f) t = -t;
                }
                const float c = 1.0f / sqrtf(t * t + 1.0f);
                const float s = t * c;
                GN_UNROLL
                for (int k = 0; k < 6; ++k) {   // A <- A J
                    const float akp = A[k * 6 + p], akq = A[k * 6 + q];
                    A[k * 6 + p] = c * akp - s * akq;
                    A[k * 6 + q] = s * akp + c * akq;
                }
                GN_UNROLL
                for (int k = 0; k < 6; ++k) {   // A <- J^T A
                    const float apk = A[p * 6 + k], aqk = A[q * 6 + k];
                    A[p * 6 + k] = c * apk - s * aqk;
                    A[q * 6 + k] = s * apk + c * aqk;
                }
                A[p * 6 + q] = 0.0f;
                A[q * 6 + p] = 0.0f;
                GN_UNROLL
                for (int k = 0; k < 6; ++k) {   // V <- V J
                    const float vkp = V[k * 6 + p], vkq = V[k * 6 + q];
                    V[k * 6 + p] = c * vkp - s * vkq;
                    V[k * 6 + q] = s * vkp + c * vkq;
                }
            }
        }
    }
    GN_UNROLL
    for (int i = 0; i < 6; ++i) w[i] = A[i * 6 + i];
}

// The GN step dx: ops/loam.py::_solve. The padding-only case (not enough
// rows) is damped by the identity; with degen_per_row > 0 the eigenbasis
// solve gives no update along directions weaker than the floor.
GN_HD inline void solve_step(const float* jtj, const float* jte, int n_valid,
                             float degen_per_row, float* dx) {
    const bool enough = n_valid >= kMinValidRows;
    float A[36], rhs[6];
    GN_UNROLL
    for (int i = 0; i < 36; ++i) A[i] = jtj[i];
    GN_UNROLL
    for (int i = 0; i < 6; ++i) {
        A[i * 6 + i] = jtj[i * 6 + i] + (enough ? 0.0f : 1.0f);
        rhs[i] = -jte[i];
    }
    if (degen_per_row > 0.0f) {
        float w[6], V[36];
        jacobi_eig6(A, w, V);
        const float floor_ = degen_per_row * static_cast<float>(n_valid)
                           * (enough ? 1.0f : 0.0f);
        float y[6];
        GN_UNROLL
        for (int k = 0; k < 6; ++k) {
            float s = 0.0f;
            GN_UNROLL
            for (int i = 0; i < 6; ++i) s += V[i * 6 + k] * rhs[i];
            y[k] = w[k] > floor_ ? s / fmaxf(w[k], 1e-12f) : 0.0f;
        }
        GN_UNROLL
        for (int i = 0; i < 6; ++i) {
            float s = 0.0f;
            GN_UNROLL
            for (int k = 0; k < 6; ++k) s += V[i * 6 + k] * y[k];
            dx[i] = s;
        }
        return;
    }
    lu_solve6(A, rhs, dx);
}

GN_HD inline void skew3(const float* w, float* W) {
    W[0] = 0.0f;  W[1] = -w[2]; W[2] = w[1];
    W[3] = w[2];  W[4] = 0.0f;  W[5] = -w[0];
    W[6] = -w[1]; W[7] = w[0];  W[8] = 0.0f;
}

GN_HD inline void matmul3(const float* A, const float* B, float* C) {
    GN_UNROLL
    for (int i = 0; i < 3; ++i)
        GN_UNROLL
        for (int j = 0; j < 3; ++j)
            C[i * 3 + j] = A[i * 3] * B[j] + A[i * 3 + 1] * B[3 + j]
                         + A[i * 3 + 2] * B[6 + j];
}

// SE(3) exp of the twist k = [rho, w]: R (3x3 row-major) and t, as
// geometry.se3_exp (so3_exp and the left Jacobian with their small-angle
// Taylor forms).
GN_HD inline void se3_exp(const float* k, float* R, float* t) {
    const float* w = k + 3;
    const float sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const bool small = sq < kSmallAngleSq;
    const float th_safe = sqrtf(small ? 1.0f : sq);
    const float th = small ? 0.0f : th_safe;
    const float a[3] = {w[0] / th_safe, w[1] / th_safe, w[2] / th_safe};
    float W[9], Vm[9];
    if (small) {
        float WW[9];
        skew3(w, W);
        matmul3(W, W, WW);
        GN_UNROLL
        for (int i = 0; i < 9; ++i) {
            const float eye = (i % 4 == 0) ? 1.0f : 0.0f;
            R[i] = eye + W[i] + 0.5f * WW[i];
            Vm[i] = eye + 0.5f * W[i] + WW[i] / 6.0f;
        }
    } else {
        const float ct = cosf(th), st = sinf(th);
        const float st_over_t = st / th_safe;
        const float one_m_ct_over_t = (1.0f - ct) / th_safe;
        skew3(a, W);
        GN_UNROLL
        for (int i = 0; i < 3; ++i)
            GN_UNROLL
            for (int j = 0; j < 3; ++j) {
                const float eye = (i == j) ? 1.0f : 0.0f;
                const float aa = a[i] * a[j];
                R[i * 3 + j] = ct * eye + (1.0f - ct) * aa + st * W[i * 3 + j];
                Vm[i * 3 + j] = st_over_t * eye + (1.0f - st_over_t) * aa
                              + one_m_ct_over_t * W[i * 3 + j];
            }
    }
    GN_UNROLL
    for (int i = 0; i < 3; ++i)
        t[i] = Vm[i * 3] * k[0] + Vm[i * 3 + 1] * k[1] + Vm[i * 3 + 2] * k[2];
}

// A pose is kept as 12 floats: R row-major (9) then t (3).
// out <- exp(dx) pose.
GN_HD inline void pose_update(const float* dx, const float* pose, float* out) {
    float Re[9], te[3];
    se3_exp(dx, Re, te);
    matmul3(Re, pose, out);
    GN_UNROLL
    for (int i = 0; i < 3; ++i)
        out[9 + i] = Re[i * 3] * pose[9] + Re[i * 3 + 1] * pose[10]
                   + Re[i * 3 + 2] * pose[11] + te[i];
}

// Per-point bound on the motion from the pose the planes were fit at:
// |dt| + r_max * angle(Ra^T R).
GN_HD inline float moved_since(const float* pose, const float* anchor,
                               float r_max) {
    const float dt = norm3(pose[9] - anchor[9], pose[10] - anchor[10],
                           pose[11] - anchor[11]);
    float tr = 0.0f;
    GN_UNROLL
    for (int i = 0; i < 3; ++i)
        tr += anchor[i] * pose[i] + anchor[3 + i] * pose[3 + i]
            + anchor[6 + i] * pose[6 + i];
    const float cos_a = fminf(fmaxf((tr - 1.0f) * 0.5f, -1.0f), 1.0f);
    return dt + r_max * acosf(cos_a);
}

// One GN step from the summed normal equations: dx, the flags, and, unless
// the loop stops here (converged or starved: the reference breaks before
// the update), pose <- exp(dx) pose in place. Returns the flags.
GN_HD inline int gn_step(const float* jtj, const float* jte, int n_valid,
                         float degen_per_row, float* pose, float* dx) {
    solve_step(jtj, jte, n_valid, degen_per_row, dx);
    int flags = 0;
    if (norm3(dx[0], dx[1], dx[2]) <= kPosConverge
            && norm3(dx[3], dx[4], dx[5]) <= kRotConverge)
        flags |= kFlagConv;
    if (n_valid >= kMinValidRows) flags |= kFlagEnough;
    if (!(flags & kFlagConv) && (flags & kFlagEnough)) {
        float next[12];
        pose_update(dx, pose, next);
        GN_UNROLL
        for (int i = 0; i < 12; ++i) pose[i] = next[i];
    }
    return flags;
}

// Snap R back onto SO(3) by a quaternion round trip (geometry.
// reorthonormalize: Shepperd's method with the branch-free case selection,
// then quat_to_rot).
GN_HD inline void reorthonormalize(const float* R, float* out) {
    const float m00 = R[0], m01 = R[1], m02 = R[2];
    const float m10 = R[3], m11 = R[4], m12 = R[5];
    const float m20 = R[6], m21 = R[7], m22 = R[8];
    const float tr = m00 + m11 + m22;
    int sel = 0;
    if (!(tr > 0.0f)) {   // argmax of [tr, m00, m11, m22], first on ties
        float best = tr;
        if (m00 > best) { best = m00; sel = 1; }
        if (m11 > best) { best = m11; sel = 2; }
        if (m22 > best) { best = m22; sel = 3; }
    }
    float q[4];
    if (sel == 0) {
        const float s = sqrtf(fmaxf(1.0f + tr, 1e-12f)) * 0.5f;
        q[0] = s; q[1] = (m21 - m12) / (4.0f * s);
        q[2] = (m02 - m20) / (4.0f * s); q[3] = (m10 - m01) / (4.0f * s);
    } else if (sel == 1) {
        const float s = sqrtf(fmaxf(1.0f + m00 - m11 - m22, 1e-12f)) * 0.5f;
        q[0] = (m21 - m12) / (4.0f * s); q[1] = s;
        q[2] = (m01 + m10) / (4.0f * s); q[3] = (m02 + m20) / (4.0f * s);
    } else if (sel == 2) {
        const float s = sqrtf(fmaxf(1.0f - m00 + m11 - m22, 1e-12f)) * 0.5f;
        q[0] = (m02 - m20) / (4.0f * s); q[1] = (m01 + m10) / (4.0f * s);
        q[2] = s; q[3] = (m12 + m21) / (4.0f * s);
    } else {
        const float s = sqrtf(fmaxf(1.0f - m00 - m11 + m22, 1e-12f)) * 0.5f;
        q[0] = (m10 - m01) / (4.0f * s); q[1] = (m02 + m20) / (4.0f * s);
        q[2] = (m12 + m21) / (4.0f * s); q[3] = s;
    }
    for (int pass = 0; pass < 2; ++pass) {   // rot_to_quat and quat_to_rot
        const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]
                              + q[3] * q[3]);
        GN_UNROLL
        for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
    }
    const float w = q[0], x = q[1], y = q[2], z = q[3];
    out[0] = 1.0f - 2.0f * (y * y + z * z);
    out[1] = 2.0f * (x * y - w * z);
    out[2] = 2.0f * (x * z + w * y);
    out[3] = 2.0f * (x * y + w * z);
    out[4] = 1.0f - 2.0f * (x * x + z * z);
    out[5] = 2.0f * (y * z - w * x);
    out[6] = 2.0f * (x * z - w * y);
    out[7] = 2.0f * (y * z + w * x);
    out[8] = 1.0f - 2.0f * (x * x + y * y);
}

}  // namespace gn

#endif  // SIMPLESLAM_GN_STEP_H_
