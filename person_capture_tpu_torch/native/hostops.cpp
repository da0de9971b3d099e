// pc_hostops — native host-side byte work feeding the TPU pipeline.
//
// The reference's only native code is the Windows Vulkan HDR preview DLL;
// its CPU-side job (strided P010 plane repack, hdr_preview/pc_hdr_vulkan.cpp
// uploadP010ToBuffers) plus the curator's host hash math live here as a
// portable shared object. Compiled on demand by native/__init__.py with
// g++ -O3; every entry point has a numpy fallback.
//
// C ABI only — loaded via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// Repack strided P010 planes into contiguous arrays, shifting the 10-bit
// codes down from the high bits (>>6) in the same step.
// y_src: h rows of y_stride bytes; uv_src: h/2 rows of uv_stride bytes
// (interleaved CbCr, 2 bytes each). Outputs are tightly packed uint16.
void pc_p010_repack(const uint8_t* y_src, int64_t y_stride,
                    const uint8_t* uv_src, int64_t uv_stride,
                    int64_t w, int64_t h,
                    uint16_t* y_out, uint16_t* uv_out) {
    for (int64_t r = 0; r < h; ++r) {
        const uint16_t* src = reinterpret_cast<const uint16_t*>(y_src + r * y_stride);
        uint16_t* dst = y_out + r * w;
        for (int64_t c = 0; c < w; ++c) dst[c] = static_cast<uint16_t>(src[c] >> 6);
    }
    const int64_t uw = w / 2, uh = h / 2;
    for (int64_t r = 0; r < uh; ++r) {
        const uint16_t* src = reinterpret_cast<const uint16_t*>(uv_src + r * uv_stride);
        uint16_t* dst = uv_out + r * uw * 2;
        for (int64_t c = 0; c < uw * 2; ++c) dst[c] = static_cast<uint16_t>(src[c] >> 6);
    }
}

// Pairwise Hamming distances between two arrays of 64-bit hashes.
void pc_hamming_matrix(const uint64_t* a, int64_t na,
                       const uint64_t* b, int64_t nb,
                       uint8_t* out /* na*nb */) {
    for (int64_t i = 0; i < na; ++i) {
        const uint64_t ai = a[i];
        uint8_t* row = out + i * nb;
        for (int64_t j = 0; j < nb; ++j) {
            row[j] = static_cast<uint8_t>(__builtin_popcountll(ai ^ b[j]));
        }
    }
}

// 64-bit DCT pHash of pre-resized 32x32 float gray images (batch).
// dct_mat: 32x32 orthonormal DCT-II matrix (row-major float32).
// zero_dc != 0 zeroes the DC coefficient before the median (curator pHash).
void pc_phash_batch(const float* gray, int64_t n, const float* dct_mat,
                    int zero_dc, uint64_t* out) {
    for (int64_t img = 0; img < n; ++img) {
        const float* g = gray + img * 32 * 32;
        // tmp = D * G
        float tmp[32 * 32];
        for (int i = 0; i < 32; ++i) {
            for (int j = 0; j < 32; ++j) {
                float s = 0.f;
                for (int k = 0; k < 32; ++k) s += dct_mat[i * 32 + k] * g[k * 32 + j];
                tmp[i * 32 + j] = s;
            }
        }
        // block = (tmp * D^T)[0:8,0:8]
        float block[64];
        for (int i = 0; i < 8; ++i) {
            for (int j = 0; j < 8; ++j) {
                float s = 0.f;
                for (int k = 0; k < 32; ++k) s += tmp[i * 32 + k] * dct_mat[j * 32 + k];
                block[i * 8 + j] = s;
            }
        }
        if (zero_dc) block[0] = 0.f;
        // median of 64 values (copy + nth_element-style partial sort)
        float sorted[64];
        std::memcpy(sorted, block, sizeof(sorted));
        // insertion sort — 64 elements, negligible
        for (int i = 1; i < 64; ++i) {
            float v = sorted[i];
            int j = i - 1;
            while (j >= 0 && sorted[j] > v) { sorted[j + 1] = sorted[j]; --j; }
            sorted[j + 1] = v;
        }
        const float median = 0.5f * (sorted[31] + sorted[32]);
        uint64_t bits = 0;
        for (int i = 0; i < 64; ++i) {
            if (block[i] > median) bits |= (1ULL << i);
        }
        out[img] = bits;
    }
}

int pc_hostops_version() { return 1; }

}  // extern "C"
