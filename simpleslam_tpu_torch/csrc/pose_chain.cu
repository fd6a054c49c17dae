// The streamed executor's pose chain around K3 (pipeline/streamed.py
// _batch_body on CUDA tensors): two small kernels over csrc/pose_chain.h.
//
// Replaces no TPU kernel: the JAX package runs this chain as XLA ops inside
// its one-program lax.scan over the batch. In eager PyTorch it was about a
// hundred small launches a scan around the one K3 launch, each costing
// more host time to enqueue than device time to run, so the executor's
// host loop, not the device, set the pace. Bound on the card: the launch
// itself (a few hundred bytes a scan; the dequantization streams the
// batch's int16 rows, 6 bytes in and 13 out a point).
//
// scan_dequant, one launch per batch: every point of the (K, C, 3) int16
//    upload to f32 metres and a validity byte (the registrations' queries,
//    which K3 reads scan by scan), and, on thread 0, the batch's pose state
//    (prev, prev2, odom2map) copied into the batch's buffer and scan 0's
//    prediction.
// pose_step, one launch per scan after its registration, one thread: the
//    planar clamp, the guards, lio's odom2map update, the packed row in
//    place in the batch's (K, 21) rows, the state shift and scan k+1's
//    prediction, which scan k+1's K3 launch reads as its start.
//
// Built into the one library with -fmad=false, as the LOAM kernels:
// pose_chain.h spells out the fused multiply-adds the torch chain does.
// Plain C interface for ctypes; every entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "pose_chain.h"

namespace {

constexpr int kDequantThreads = 256;

__global__ void __launch_bounds__(kDequantThreads)
scan_dequant_kernel(const int16_t* __restrict__ rows, int n_pts, float scale,
                    int pad, float pad_coord, float* __restrict__ xyz,
                    uint8_t* __restrict__ mask, const float* prev,
                    const float* prev2, const float* o2m, const float* local0,
                    float step_cap, float* state, float* init0) {
    const int i = blockIdx.x * kDequantThreads + threadIdx.x;
    if (i < n_pts)
        pc::dequant(rows + 3 * i, scale, static_cast<int16_t>(pad), pad_coord,
                    xyz + 3 * i, mask + i);
    if (i == 0) {
        for (int j = 0; j < 16; ++j) {
            state[j] = prev[j];
            state[16 + j] = prev2[j];
            state[32 + j] = o2m[j];
        }
        pc::predict(state, state + 16, state + 32, local0, step_cap, init0);
    }
}

__global__ void __launch_bounds__(32)
pose_step_kernel(const float* reg, const float* fit, const float* init,
                 float* state, const float* local, const float* local_next,
                 int clamp, int jump_on, float cap_conv, float cap_other,
                 float step_cap, float* packed, float* init_next) {
    if (threadIdx.x == 0)
        pc::step(reg, fit, init, state, local, local_next, clamp, jump_on,
                 cap_conv, cap_other, step_cap, packed, init_next);
}

}  // namespace

extern "C" {

// The batch's n_pts int16 points (3 each) to xyz (n_pts x 3 f32) and mask
// (n_pts bytes); prev, prev2 and o2m (4x4 f32 each) into state (48 f32),
// scan 0's prediction into init0 (16 f32). local0: scan 0's local odometry
// (lio) or nullptr (lo).
int pose_chain_dequant(const void* rows, int n_pts, float scale, int pad,
                       float pad_coord, void* xyz, void* mask,
                       const void* prev, const void* prev2, const void* o2m,
                       const void* local0, float step_cap, void* state,
                       void* init0, void* stream) {
    if (n_pts < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (n_pts + kDequantThreads - 1) / kDequantThreads;
    scan_dequant_kernel<<<blocks, kDequantThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(rows), n_pts, scale, pad, pad_coord,
        static_cast<float*>(xyz), static_cast<uint8_t*>(mask),
        static_cast<const float*>(prev), static_cast<const float*>(prev2),
        static_cast<const float*>(o2m), static_cast<const float*>(local0),
        step_cap, static_cast<float*>(state), static_cast<float*>(init0));
    return static_cast<int>(cudaGetLastError());
}

// One scan's chain after its registration (pc::step): reg (20 f32, K3's
// row), fit (1 f32 or nullptr), init (16), state (48, updated), local and
// local_next (16 each, lio) or nullptr, packed (21) and init_next (16, or
// nullptr after the batch's last scan).
int pose_chain_step(const void* reg, const void* fit, const void* init,
                    void* state, const void* local, const void* local_next,
                    int clamp, int jump_on, float cap_conv, float cap_other,
                    float step_cap, void* packed, void* init_next,
                    void* stream) {
    pose_step_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(reg), static_cast<const float*>(fit),
        static_cast<const float*>(init), static_cast<float*>(state),
        static_cast<const float*>(local),
        static_cast<const float*>(local_next), clamp, jump_on, cap_conv,
        cap_other, step_cap, static_cast<float*>(packed),
        static_cast<float*>(init_next));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
