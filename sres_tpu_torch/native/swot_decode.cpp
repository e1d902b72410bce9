// Native SWOT binary decoder — the host-side hot path of the data layer
// (a copy of sres_tpu/native/swot_decode.cpp, same C interface).
//
// The reference decodes each SWOT timestep in Python/numpy
// (np.fromfile('>f4') + boolean-mask scatter, reference:
// sres/base/source/swot/raw.py:133-140): for the full LLC4320 grid that is
// 243M points of single-threaded byteswap + fancy indexing per (variable,
// timestep). This translation unit fuses the whole decode into one
// OpenMP-parallel pass over a precomputed index map:
//
//   out[i] = map[i] >= 0 ? bswap_f32(values[map[i]]) : NaN
//
// Exposed via ctypes (sres_tpu_torch/native/__init__.py); no fallback: a
// build that fails raises. The numpy formulation is kept beside it as the
// plain twin that tests hold it to.
#include <cstdint>
#include <cstring>
#include <limits>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {
inline float bswap_f32(uint32_t v) {
    v = __builtin_bswap32(v);
    float f;
    std::memcpy(&f, &v, sizeof(f));
    return f;
}
}  // namespace

extern "C" {

// Build the scatter index map from the mask template: map[i] = running index
// of ocean point i, or -1 for land. Returns the number of ocean points.
int64_t swot_build_map(const uint8_t* mask, int64_t npoints, int64_t* map) {
    int64_t k = 0;
    for (int64_t i = 0; i < npoints; ++i) {
        map[i] = mask[i] ? k++ : -1;
    }
    return k;
}

// Decode one variable timestep: big-endian f32 ocean values -> full grid
// with NaN land, parallel over grid points.
void swot_decode(const uint32_t* be_values, const int64_t* map,
                 int64_t npoints, float* out) {
    const float nanv = std::numeric_limits<float>::quiet_NaN();
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < npoints; ++i) {
        const int64_t j = map[i];
        out[i] = (j >= 0) ? bswap_f32(be_values[j]) : nanv;
    }
}

// Parallel big-endian -> host-endian f32 conversion (generic helper).
void bswap_f32_array(const uint32_t* in, int64_t n, float* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        out[i] = bswap_f32(in[i]);
    }
}

}  // extern "C"
