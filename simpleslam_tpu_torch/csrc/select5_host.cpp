// C entry point over select5.h for the host: the selection the CUDA kernels
// run on one warp, here over 32 emulated lanes and their two reductions per
// round, compiled with g++ so a CPU test can hold it against the plain
// argmin rounds (native.select5). Build with -ffp-contract=off, as the
// kernels are built with -fmad=false.

#include "select5.h"

namespace {

constexpr float kInf = __builtin_inff();

// One warp's 32 lanes, one thread.
template <int S>
struct HostWarp {
    s5::Lane<S> lane[32];
    unsigned min_d2() const {
        unsigned m = ~0u;
        for (const auto& l : lane) m = l.head_d2() < m ? l.head_d2() : m;
        return m;
    }
    unsigned min_index(unsigned m) const {
        unsigned c = s5::kNoIndex;
        for (const auto& l : lane)
            if (l.head_d2() == m && l.head_index() < c) c = l.head_index();
        return c;
    }
    void drop(unsigned c) {
        for (auto& l : lane) l.drop_if(l.head_index() == c);
    }
};

template <int S>
bool select_one(const float* cand, const uint8_t* ok, int n_cand,
                const float* p, bool valid, float max_sq, int* sel) {
    HostWarp<S> w;
    for (int l = 0; l < 32; ++l) {
        float d2[S];
        for (int j = 0; j < S; ++j) {
            const int c = l + 32 * j;
            d2[j] = kInf;
            if (c < n_cand && ok[c])
                d2[j] = s5::dist2(cand[3 * c], cand[3 * c + 1],
                                  cand[3 * c + 2], p[0], p[1], p[2]);
        }
        w.lane[l].init(d2, l);
    }
    return s5::rounds(w, valid, max_sq, sel);
}

}  // namespace

extern "C" {

// The five nearest candidates of each query: cand (n_q, n_cand, 3) f32,
// ok (n_q, n_cand) 0/1, p (n_q, 3) f32, valid (n_q) 0/1; writes sel
// (n_q, 5) in candidate-index order, -1 where absent, and the gate (n_q).
// Returns 0, or -1 for more candidates than a warp holds (256).
int select5_host(const float* cand, const uint8_t* ok, const float* p,
                 const uint8_t* valid, int n_q, int n_cand, float max_sq,
                 int32_t* sel_out, uint8_t* gate_out) {
    if (n_cand < 1 || n_cand > 256) return -1;
    for (int i = 0; i < n_q; ++i) {
        const float* ci = cand + static_cast<int64_t>(i) * n_cand * 3;
        const uint8_t* oi = ok + static_cast<int64_t>(i) * n_cand;
        int sel[s5::kPts];
        const bool v = valid[i] != 0;
        const float* pi = p + 3 * i;
        // the kernels' slots a lane (loam_kernels.cu select5_any)
        const bool gate =
            n_cand <= 6 * 32 ? select_one<6>(ci, oi, n_cand, pi, v, max_sq, sel)
            : n_cand <= 7 * 32 ? select_one<7>(ci, oi, n_cand, pi, v, max_sq, sel)
            : select_one<8>(ci, oi, n_cand, pi, v, max_sq, sel);
        for (int k = 0; k < s5::kPts; ++k) sel_out[5 * i + k] = sel[k];
        gate_out[i] = gate ? 1 : 0;
    }
    return 0;
}

}  // extern "C"
