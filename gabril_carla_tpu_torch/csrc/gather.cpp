// Native batch assembly for the BC data pipeline (the port's copy of
// gabril_carla_tpu/native/gather.cpp, with the same C ABI).
//
// The robomimic SequenceDataset the reference trains from does its window
// gather + front-pad clamping in Python per sample (robomimic
// utils/dataset.py:589-663, multiprocessed by torch DataLoader workers).
// Here the same gather runs as a multithreaded memcpy over the store's flat
// host buffers: one call assembles a whole [batch, stack, frame] uint8
// array, and two more the float sidecars.
//
// Build: gabril_carla_tpu_torch/native/__init__.py compiles it with g++ at
// first use and binds it with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

template <typename T>
void gather_impl(const T* base, const int64_t* demo_offsets, const int64_t* demo_lens,
                 int64_t row_elems, const int64_t* demo_idx, const int64_t* t_idx,
                 int64_t n_samples, int64_t stack, T* out, int n_threads) {
    auto work = [&](int64_t i0, int64_t i1) {
        for (int64_t i = i0; i < i1; ++i) {
            const int64_t d = demo_idx[i];
            const int64_t len = demo_lens[d];
            for (int64_t s = 0; s < stack; ++s) {
                const int64_t t = clamp64(t_idx[i] - (stack - 1 - s), 0, len - 1);
                std::memcpy(out + (i * stack + s) * row_elems,
                            base + (demo_offsets[d] + t) * row_elems,
                            sizeof(T) * static_cast<size_t>(row_elems));
            }
        }
    };
    n_threads = std::max(1, n_threads);
    if (n_threads == 1 || n_samples < 2 * n_threads) {
        work(0, n_samples);
        return;
    }
    std::vector<std::thread> pool;
    const int64_t chunk = (n_samples + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int64_t i0 = t * chunk;
        const int64_t i1 = std::min<int64_t>(i0 + chunk, n_samples);
        if (i0 >= i1) break;
        pool.emplace_back(work, i0, i1);
    }
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// images: uint8 frames, row_elems = H*W*C
void gather_windows_u8(const uint8_t* base, const int64_t* demo_offsets,
                       const int64_t* demo_lens, int64_t row_elems,
                       const int64_t* demo_idx, const int64_t* t_idx,
                       int64_t n_samples, int64_t stack, uint8_t* out, int n_threads) {
    gather_impl<uint8_t>(base, demo_offsets, demo_lens, row_elems, demo_idx, t_idx,
                         n_samples, stack, out, n_threads);
}

// float sidecars (gaze windows), row_elems = P*2
void gather_windows_f32(const float* base, const int64_t* demo_offsets,
                        const int64_t* demo_lens, int64_t row_elems,
                        const int64_t* demo_idx, const int64_t* t_idx,
                        int64_t n_samples, int64_t stack, float* out, int n_threads) {
    gather_impl<float>(base, demo_offsets, demo_lens, row_elems, demo_idx, t_idx,
                       n_samples, stack, out, n_threads);
}

// single-row gather (actions at the window center), stack == 1 semantics
void gather_rows_f32(const float* base, const int64_t* demo_offsets,
                     const int64_t* demo_lens, int64_t row_elems,
                     const int64_t* demo_idx, const int64_t* t_idx,
                     int64_t n_samples, float* out, int n_threads) {
    gather_impl<float>(base, demo_offsets, demo_lens, row_elems, demo_idx, t_idx,
                       n_samples, 1, out, n_threads);
}

}  // extern "C"
