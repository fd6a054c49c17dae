// The five-nearest-neighbour selection of the LOAM kernels, in plain C++.
//
// One warp selects a query's five nearest candidates. Lane l holds
// candidates l, l + 32, ..., l + 32 (S - 1) and sorts them once by
// (d^2, index) with a fixed compare-exchange network in registers, keeping
// the five smallest. Each of the five rounds then takes the warp's
// least head by two reductions, the least d^2 and then the least index among
// the lanes whose head holds it, and the winning lane drops its head.
// (d^2, index) compared lexicographically is the reference's "min, then the
// first index among hits" (ops/loam.py fit_planes_at), so the winners are
// exactly those of its argmin rounds. The CUDA kernels (loam_kernels.cu) run
// the rounds with the warp's __reduce_min_sync; select5_host.cpp runs them
// over 32 emulated lanes, so a CPU test holds them against the argmin
// rounds. S5_HD is "__host__ __device__" under nvcc and empty otherwise.
// Build both sides without multiply-add contraction.

#ifndef SIMPLESLAM_SELECT5_H_
#define SIMPLESLAM_SELECT5_H_

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define S5_HD __host__ __device__
#else
#define S5_HD
#endif

namespace s5 {

constexpr int kPts = 5;
constexpr unsigned kInfBits = 0x7f800000u;    // +inf
constexpr unsigned kNoIndex = 0x7fffffffu;
constexpr uint64_t kDropped = ~0ull;          // a dropped slot: after +inf

S5_HD inline unsigned float_bits(float f) {
#ifdef __CUDA_ARCH__
    return __float_as_uint(f);
#else
    unsigned u;
    memcpy(&u, &f, sizeof(u));
    return u;
#endif
}

// Squared distance of candidate (cx, cy, cz) from query (px, py, pz), in the
// order of the reference's f32 ops.
S5_HD inline float dist2(float cx, float cy, float cz, float px, float py,
                         float pz) {
    const float dx = cx - px, dy = cy - py, dz = cz - pz;
    return dx * dx + dy * dy + dz * dz;
}

// Candidate c at squared distance d2 (non-negative or +inf): keys order like
// (d2, c), since non-negative floats order like their bit patterns.
S5_HD inline uint64_t make_key(float d2, int c) {
    return (static_cast<uint64_t>(float_bits(d2)) << 32)
           | static_cast<unsigned>(c);
}

S5_HD inline void compare_exchange(uint64_t& a, uint64_t& b) {
    const uint64_t lo = a < b ? a : b, hi = a < b ? b : a;
    a = lo;
    b = hi;
}

// Sort S keys ascending: the smallest known networks for 6, 7 and 8 keys
// (12, 16 and 19 compare-exchanges), odd-even transposition otherwise.
template <int S>
S5_HD inline void sort_keys(uint64_t* k) {
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
        for (int i = r & 1; i + 1 < S; i += 2) compare_exchange(k[i], k[i + 1]);
}
#define S5_CE(i, j) compare_exchange(k[i], k[j])
template <>
S5_HD inline void sort_keys<6>(uint64_t* k) {
    S5_CE(0, 5); S5_CE(1, 3); S5_CE(2, 4);
    S5_CE(1, 2); S5_CE(3, 4);
    S5_CE(0, 3); S5_CE(2, 5);
    S5_CE(0, 1); S5_CE(2, 3); S5_CE(4, 5);
    S5_CE(1, 2); S5_CE(3, 4);
}
template <>
S5_HD inline void sort_keys<7>(uint64_t* k) {
    S5_CE(0, 6); S5_CE(2, 3); S5_CE(4, 5);
    S5_CE(0, 2); S5_CE(1, 4); S5_CE(3, 6);
    S5_CE(0, 1); S5_CE(2, 5); S5_CE(3, 4);
    S5_CE(1, 2); S5_CE(4, 6);
    S5_CE(2, 3); S5_CE(4, 5);
    S5_CE(1, 2); S5_CE(3, 4); S5_CE(5, 6);
}
template <>
S5_HD inline void sort_keys<8>(uint64_t* k) {
    S5_CE(0, 2); S5_CE(1, 3); S5_CE(4, 6); S5_CE(5, 7);
    S5_CE(0, 4); S5_CE(1, 5); S5_CE(2, 6); S5_CE(3, 7);
    S5_CE(0, 1); S5_CE(2, 3); S5_CE(4, 5); S5_CE(6, 7);
    S5_CE(2, 4); S5_CE(3, 5);
    S5_CE(1, 4); S5_CE(3, 6);
    S5_CE(1, 2); S5_CE(3, 4); S5_CE(5, 6);
}
#undef S5_CE

// One lane's candidates, ascending by key. A lane wins at most five
// rounds, so it keeps its five smallest keys.
template <int S>
struct Lane {
    static constexpr int kKeep = S < kPts ? S : kPts;
    uint64_t key[kKeep];

    // d2[j] is the squared distance of candidate lane + 32 j (+inf where it
    // is padding or past the query's candidates).
    S5_HD void init(const float* d2, int lane) {
        uint64_t all[S];
#pragma unroll
        for (int j = 0; j < S; ++j) all[j] = make_key(d2[j], lane + 32 * j);
        sort_keys<S>(all);
#pragma unroll
        for (int j = 0; j < kKeep; ++j) key[j] = all[j];
    }
    S5_HD unsigned head_d2() const {
        return static_cast<unsigned>(key[0] >> 32);
    }
    S5_HD unsigned head_index() const {
        return static_cast<unsigned>(key[0]);
    }
    // Drop the head where `win`.
    S5_HD void drop_if(bool win) {
#pragma unroll
        for (int j = 0; j + 1 < kKeep; ++j) key[j] = win ? key[j + 1] : key[j];
        key[kKeep - 1] = win ? kDropped : key[kKeep - 1];
    }
};

// The five rounds over a warp `w`: w.min_d2() is the least head d^2 (as
// bits) over its lanes, w.min_index(m) the least head index over the lanes
// whose head d^2 is m, w.drop(c) drops head c from the lane that holds it.
// sel[] gets the winners in candidate-index order, -1 where fewer than five
// candidates are set (the same on every lane); returns the 5-NN gate: valid,
// five found and the fifth closer than max_sq.
template <class Warp>
S5_HD bool rounds(Warp& w, bool valid, float max_sq, int* sel) {
    unsigned d_k = kInfBits;
    int n_sel = 0;
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
        const unsigned m = w.min_d2();
        d_k = m;
        sel[k] = -1;
        if (m < kInfBits) {
            const unsigned c = w.min_index(m);
            sel[k] = static_cast<int>(c);
            ++n_sel;
            w.drop(c);
        }
    }
    // candidate-index order (the order a masked sum over the candidate axis
    // visits them); -1 sorts last as unsigned
#pragma unroll
    for (int a = 1; a < kPts; ++a)
#pragma unroll
        for (int b = a; b > 0; --b)
            if (static_cast<unsigned>(sel[b])
                    < static_cast<unsigned>(sel[b - 1])) {
                const int t = sel[b];
                sel[b] = sel[b - 1];
                sel[b - 1] = t;
            }
    return valid && n_sel >= kPts && d_k < float_bits(max_sq);
}

}  // namespace s5

#endif  // SIMPLESLAM_SELECT5_H_
