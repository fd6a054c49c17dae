// C entry points over gn_step.h for the host: the code the CUDA kernel
// loam_gn_loop runs for its small step, compiled with g++ so a CPU test can
// hold it against the torch formulas (native.gn_step / native.gn_finish).
// Build with -ffp-contract=off, as the kernels are built with -fmad=false.

#include "gn_step.h"

extern "C" {

// One GN step. pose16/anchor16 are row-major 4x4 poses; writes dx (6), the
// pose after the step (16), the motion since the anchor, and returns the
// flags (gn::kFlagConv | gn::kFlagEnough).
int gn_step_host(const float* jtj36, const float* jte6, int n_valid,
                 float degen_per_row, const float* pose16,
                 const float* anchor16, float r_max, float* dx6_out,
                 float* pose16_out, float* moved_out) {
    float pose[12], anchor[12];
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
            pose[i * 3 + j] = pose16[i * 4 + j];
            anchor[i * 3 + j] = anchor16[i * 4 + j];
        }
        pose[9 + i] = pose16[i * 4 + 3];
        anchor[9 + i] = anchor16[i * 4 + 3];
    }
    const int flags = gn::gn_step(jtj36, jte6, n_valid, degen_per_row, pose,
                                  dx6_out);
    *moved_out = gn::moved_since(pose, anchor, r_max);
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) pose16_out[i * 4 + j] = pose[i * 3 + j];
        pose16_out[i * 4 + 3] = pose[9 + i];
        pose16_out[12 + i] = 0.0f;
    }
    pose16_out[15] = 1.0f;
    return flags;
}

// The loop's epilogue: the rotation block of pose16 re-orthonormalized.
void gn_finish_host(const float* pose16, float* pose16_out) {
    float R[9], Rn[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) R[i * 3 + j] = pose16[i * 4 + j];
    gn::reorthonormalize(R, Rn);
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) pose16_out[i * 4 + j] = Rn[i * 3 + j];
        pose16_out[i * 4 + 3] = pose16[i * 4 + 3];
        pose16_out[12 + i] = 0.0f;
    }
    pose16_out[15] = 1.0f;
}

// Eigendecomposition used by the degeneracy guard (for its own test).
void gn_jacobi_eig6_host(const float* a36, float* w6, float* v36) {
    gn::jacobi_eig6(a36, w6, v36);
}

}  // extern "C"
