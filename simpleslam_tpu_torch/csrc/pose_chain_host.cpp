// The C entry points of pose_chain.cu over host memory: the code the
// kernels scan_dequant and pose_step run (pose_chain.h), compiled with g++
// so a CPU test can hold it against the torch chain of
// pipeline/streamed.py (native.pose_chain_dequant, native.pose_chain_step).
// Same names and arguments as the CUDA library's; the stream is not read.
// Build with -ffp-contract=off, as the kernels are built with -fmad=false.

#include "pose_chain.h"

extern "C" {

int pose_chain_dequant(const void* rows, int n_pts, float scale, int pad,
                       float pad_coord, void* xyz, void* mask,
                       const void* prev, const void* prev2, const void* o2m,
                       const void* local0, float step_cap, void* state,
                       void* init0, void* /*stream*/) {
    if (n_pts < 1) return 1;
    const int16_t* q = static_cast<const int16_t*>(rows);
    float* out = static_cast<float*>(xyz);
    uint8_t* ok = static_cast<uint8_t*>(mask);
    for (int i = 0; i < n_pts; ++i)
        pc::dequant(q + 3 * i, scale, static_cast<int16_t>(pad), pad_coord,
                    out + 3 * i, ok + i);
    float* st = static_cast<float*>(state);
    for (int j = 0; j < 16; ++j) {
        st[j] = static_cast<const float*>(prev)[j];
        st[16 + j] = static_cast<const float*>(prev2)[j];
        st[32 + j] = static_cast<const float*>(o2m)[j];
    }
    pc::predict(st, st + 16, st + 32, static_cast<const float*>(local0),
                step_cap, static_cast<float*>(init0));
    return 0;
}

int pose_chain_step(const void* reg, const void* fit, const void* init,
                    void* state, const void* local, const void* local_next,
                    int clamp, int jump_on, float cap_conv, float cap_other,
                    float step_cap, void* packed, void* init_next,
                    void* /*stream*/) {
    pc::step(static_cast<const float*>(reg), static_cast<const float*>(fit),
             static_cast<const float*>(init), static_cast<float*>(state),
             static_cast<const float*>(local),
             static_cast<const float*>(local_next), clamp, jump_on, cap_conv,
             cap_other, step_cap, static_cast<float*>(packed),
             static_cast<float*>(init_next));
    return 0;
}

}  // extern "C"
