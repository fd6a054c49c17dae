// The streamed executor's per-scan pose chain, in plain C++.
//
// What pipeline/streamed.py::_batch_body does around each registration,
// for the two kernels of csrc/pose_chain.cu: the upload's dequantization
// (upload_cloud), the capped constant-velocity prediction or lio's
// odom2map composition (_predict), and the planar clamp
// (geometry.six_dof_to_mobile, with so3_log's near-zero and near-pi
// branches), the NaN and jump guards, lio's odom2map update, the packed
// 21-float row and the shift of the pose state (_chain).
//
// The formulas follow the torch chain op for op, in f32, and round as
// PyTorch's CPU kernels do: a 4x4 product adds its four terms in order by
// fused multiply-adds (torch.matmul), pose_inverse's R^T t adds three
// rounded products (torch.einsum), a contiguous 3-vector's norm adds its
// squares by fused multiply-adds and a strided one's without them
// (torch.linalg.norm), and a Python number over a tensor is the tensor's
// reciprocal times the number. Every fused multiply-add is an explicit
// fmaf, so the file rounds the same under nvcc's -fmad=false and g++'s
// -ffp-contract=off; clamp, argmax and the comparisons keep torch's
// handling of NaN, so a non-finite registration takes the same branch.
// acosf, sinf and cosf are the platform's: on the card the CUDA functions
// the torch chain calls there too; on the host libm's, which part from
// torch's CPU kernels (SLEEF) by an ulp now and then.
//
// pose_chain.cu includes this file; pose_chain_host.cpp compiles it with
// g++ behind the same C entry points, so a CPU test holds the code the
// kernels run against the torch chain. PC_HD is "__host__ __device__"
// under nvcc and empty otherwise.

#ifndef SIMPLESLAM_POSE_CHAIN_H_
#define SIMPLESLAM_POSE_CHAIN_H_

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define PC_HD __host__ __device__
#define PC_UNROLL _Pragma("unroll")
#else
#define PC_HD
#define PC_UNROLL
#endif

namespace pc {

// K3's result row (ops/loam_kernels.py GN_ROW): the pose (16), then these
constexpr int kRegConverged = 16, kRegIters = 17, kRegGathers = 18,
              kRegNValid = 19;
constexpr int kRegRow = 20;
constexpr int kPackedRow = 21;   // pose16, converged, fitness, iters,
                                 // gathers, n_valid
constexpr float kPi = 3.14159265358979f;   // (float) math.pi

// torch.clamp: a NaN passes through.
PC_HD inline float clampf(float x, float lo, float hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// The norm of a contiguous (3,) tensor: squares added by fused
// multiply-adds.
PC_HD inline float norm3_fma(float x, float y, float z) {
    return sqrtf(fmaf(z, z, fmaf(y, y, x * x)));
}

// The norm of a strided (3,) view: rounded squares added in order.
PC_HD inline float norm3_strided(float x, float y, float z) {
    return sqrtf((x * x + y * y) + z * z);
}

// C = A B on 4x4 row-major poses (C may alias A or B).
PC_HD inline void compose(const float* A, const float* B, float* C) {
    float out[16];
    PC_UNROLL
    for (int i = 0; i < 4; ++i)
        PC_UNROLL
        for (int j = 0; j < 4; ++j) {
            float acc = A[i * 4] * B[j];
            acc = fmaf(A[i * 4 + 1], B[4 + j], acc);
            acc = fmaf(A[i * 4 + 2], B[8 + j], acc);
            out[i * 4 + j] = fmaf(A[i * 4 + 3], B[12 + j], acc);
        }
    PC_UNROLL
    for (int i = 0; i < 16; ++i) C[i] = out[i];
}

// geometry.pose_inverse: [R^T, -R^T t; 0 0 0 1] (out must not alias T).
PC_HD inline void inverse(const float* T, float* out) {
    PC_UNROLL
    for (int i = 0; i < 3; ++i) {
        PC_UNROLL
        for (int j = 0; j < 3; ++j) out[i * 4 + j] = T[j * 4 + i];
        out[i * 4 + 3] =
            -((T[i] * T[3] + T[4 + i] * T[7]) + T[8 + i] * T[11]);
        out[12 + i] = 0.0f;
    }
    out[15] = 1.0f;
}

// geometry.so3_log of the rotation block of T.
PC_HD inline void so3_log(const float* T, float* w) {
    const float R00 = T[0], R01 = T[1], R02 = T[2];
    const float R10 = T[4], R11 = T[5], R12 = T[6];
    const float R20 = T[8], R21 = T[9], R22 = T[10];
    const float cos_t = clampf(((R00 + R11) + R22 - 1.0f) * 0.5f, -1.0f,
                               1.0f);
    const float t = acosf(cos_t);
    const float wh[3] = {R21 - R12, R02 - R20, R10 - R01};
    if (t < 1e-4f) {   // near zero
        PC_UNROLL
        for (int i = 0; i < 3; ++i) w[i] = wh[i] * 0.5f;
        return;
    }
    if (!(kPi - t < 1e-3f)) {   // generic
        const float sin_t = sinf(t);
        const float scale = t / (sin_t == 0.0f ? 1.0f : 2.0f * sin_t);
        PC_UNROLL
        for (int i = 0; i < 3; ++i) w[i] = wh[i] * scale;
        return;
    }
    // near pi: w = t * axis, the axis magnitudes from the symmetric part's
    // diagonal, the signs from the off-diagonal sums against the dominant
    // axis
    const float den = (1.0f - cos_t) + 1e-12f;
    const float diag[3] = {(R00 + R00) * 0.5f, (R11 + R11) * 0.5f,
                           (R22 + R22) * 0.5f};
    float ax[3];
    PC_UNROLL
    for (int i = 0; i < 3; ++i)
        ax[i] = sqrtf(clampf((diag[i] - cos_t) / den, 0.0f, 1.0f));
    int k = 0;   // torch.argmax: the first largest, a NaN above all
    PC_UNROLL
    for (int i = 1; i < 3; ++i)
        if (ax[i] > ax[k] || (ax[i] != ax[i] && ax[k] == ax[k])) k = i;
    const float s01 = R01 + R10, s02 = R02 + R20, s12 = R12 + R21;
    const float row[3][3] = {{ax[0], s01, s02}, {s01, ax[1], s12},
                             {s02, s12, ax[2]}};
    PC_UNROLL
    for (int i = 0; i < 3; ++i) {
        const float sign = (i == k || row[k][i] >= 0.0f) ? 1.0f : -1.0f;
        w[i] = sign * ax[i] * t;
    }
}

// geometry.six_dof_to_mobile: (x, y) kept, z zeroed, and the rotation a
// pure yaw of the same angle where its axis is near +-Z (|axis.z| > 0.95),
// else the identity (out may alias T).
PC_HD inline void six_dof_to_mobile(const float* T, float* out) {
    float w[3];
    so3_log(T, w);
    const float angle = norm3_fma(w[0], w[1], w[2]);
    const float axis_z = w[2] / (angle < 1e-6f ? 1.0f : angle);
    const float sign = axis_z > 0.0f ? 1.0f : (axis_z < 0.0f ? -1.0f : 0.0f);
    const float yaw = fabsf(axis_z) > 0.95f ? angle * sign : 0.0f;
    const float cz = cosf(yaw), sz = sinf(yaw);
    const float tx = T[3], ty = T[7];
    const float pose[16] = {cz, -sz, 0.0f, tx,  sz,   cz,   0.0f, ty,
                            0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    PC_UNROLL
    for (int i = 0; i < 16; ++i) out[i] = pose[i];
}

// The prediction of a scan's start (_predict): lio (local != nullptr)
// composes odom2map with the scan's local odometry; lo extrapolates the
// last step, its translation cut to step_cap.
PC_HD inline void predict(const float* prev, const float* prev2,
                          const float* o2m, const float* local,
                          float step_cap, float* init) {
    if (local != nullptr) {
        compose(o2m, local, init);
        return;
    }
    float inv[16], step[16];
    inverse(prev2, inv);
    compose(inv, prev, step);
    const float n = norm3_strided(step[3], step[7], step[11]);
    const float cut = (1.0f / (n < 1e-9f ? 1e-9f : n)) * step_cap;
    const float scale = cut > 1.0f ? 1.0f : cut;
    step[3] = step[3] * scale;
    step[7] = step[7] * scale;
    step[11] = step[11] * scale;
    step[12] = step[13] = step[14] = 0.0f;
    step[15] = 1.0f;
    compose(prev, step, init);
}

// Everything after one registration (_chain, then the next _predict).
// state holds prev, prev2 and odom2map (3 x 16): the scan's pose becomes
// prev and the old prev prev2, and lio updates odom2map. reg is a
// registration row in K3's layout; fit its fitness (nullptr: 0). The jump
// guard is on where jump_on is set: a move from init above cap_conv
// (converged) or cap_other (not) is rejected, as a non-finite pose is.
// Writes the packed row and, where init_next is not nullptr, the next
// scan's prediction from local_next (lio) or the new state.
PC_HD inline void step(const float* reg, const float* fit, const float* init,
                       float* state, const float* local,
                       const float* local_next, int clamp, int jump_on,
                       float cap_conv, float cap_other, float step_cap,
                       float* packed, float* init_next) {
    float pose[16];
    if (clamp) {
        six_dof_to_mobile(reg, pose);
    } else {
        PC_UNROLL
        for (int i = 0; i < 16; ++i) pose[i] = reg[i];
    }
    const bool conv = reg[kRegConverged] > 0.5f;
    bool ok = true;
    PC_UNROLL
    for (int i = 0; i < 16; ++i) ok = ok && isfinite(pose[i]);
    if (jump_on) {
        const float jump = norm3_fma(pose[3] - init[3], pose[7] - init[7],
                                     pose[11] - init[11]);
        ok = ok && jump <= (conv ? cap_conv : cap_other);
    }
    if (!ok) {
        PC_UNROLL
        for (int i = 0; i < 16; ++i) pose[i] = init[i];
    }
    float* prev = state;
    float* prev2 = state + 16;
    float* o2m = state + 32;
    if (local != nullptr) {
        float inv[16];
        inverse(local, inv);
        compose(pose, inv, o2m);
    }
    PC_UNROLL
    for (int i = 0; i < 16; ++i) {
        packed[i] = pose[i];
        prev2[i] = prev[i];
        prev[i] = pose[i];
    }
    // the counts go through int32 on the torch side (row.to(torch.int32))
    packed[16] = (ok && conv) ? 1.0f : 0.0f;
    packed[17] = fit != nullptr ? *fit : 0.0f;
    packed[18] = static_cast<float>(static_cast<int>(reg[kRegIters]));
    packed[19] = static_cast<float>(static_cast<int>(reg[kRegGathers]));
    packed[20] = static_cast<float>(static_cast<int>(reg[kRegNValid]));
    if (init_next != nullptr)
        predict(prev, prev2, o2m, local_next, step_cap, init_next);
}

// One uploaded int16 point back in metres (upload_cloud): PAD_COORD and
// invalid where its x holds the padding sentinel.
PC_HD inline void dequant(const int16_t* q, float scale, int16_t pad,
                          float pad_coord, float* xyz, uint8_t* mask) {
    const bool valid = q[0] != pad;
    PC_UNROLL
    for (int i = 0; i < 3; ++i)
        xyz[i] = valid ? static_cast<float>(q[i]) * scale : pad_coord;
    *mask = valid ? 1 : 0;
}

}  // namespace pc

#endif  // SIMPLESLAM_POSE_CHAIN_H_
