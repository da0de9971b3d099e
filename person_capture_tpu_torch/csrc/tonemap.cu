// Plain-PQ HDR tone-map for Hopper (sm_90a): two entries over one per-pixel
// device chain.
//
// Replaces the TPU kernel tonemap_planes_pallas
// (person_capture_tpu/kernels/hdr.py, body _core_math) and, in the fused
// entry, the jnp glue that hdr_to_sdr_bgr wraps around it there.
//
//   hdr_to_sdr_bgr_launch  P010 Y int16 [H, W] + CbCr int16 [H/2, W/2, 2]
//                          -> uint8 BGR [H, W, 3], H and W even: 10-bit
//                          codes, range normalisation, 2x bilinear chroma
//                          (half-pixel centres, clamped edges), Y'CbCr ->
//                          R'G'B' clipped to [0, 1], the chain, x255 plus the
//                          4x4 Bayer offset when dithering, round half to
//                          even, clamp, store B, G, R.
//   tonemap_planes_launch  planar float32 R'G'B' [3, H, W] -> encoded planar
//                          RGB [3, H, W], the counterpart of the public
//                          tonemap_planes_pallas.
//
// The chain: PQ EOTF x 10000/sdr_nits -> max-channel tone curve (clip |
// reinhard | mobius | hable | bt.2390) with the desat blend -> BT.2020 ->
// BT.709 -> clip [0, 1] -> sRGB OETF.
//
// Bound. bt.2390 with desat takes 25 pow per pixel (PQ EOTF x3, the curve
// on the max channel and on each channel at 4 each, sRGB OETF x3), each a
// log2 and an exp2 on the special-function units (MUFU, 16 results per
// clock per SM): about 50 MUFU results per pixel, against 6 bytes of memory
// per pixel in the fused entry (2 Y, 1 chroma, 3 out). The MUFU side binds
// by far, so neither tensor cores nor TMA have work here. The design spends
// the MUFU issue slots on the chain alone:
//   * pow(x, y) = exp2(y * log2 x) with lg2.approx.ftz / ex2.approx.ftz
//     (inline PTX): two MUFU instructions, where accurate powf is a long
//     FP32 sequence around them. lg2.approx is good to about 2^-22; times
//     the largest exponent (m2 = 78.84) that is about 2e-5 relative, well
//     inside 1 LSB of the 8-bit output. Divisions by a pixel value are
//     __fdividef (one MUFU reciprocal).
//   * every constant of a launch (curve coefficients, the BT.2390 knee,
//     reciprocals, both matrices, the range normalisation) is computed once
//     by the wrapper on the host (kernels/hdr.py, curve_constants) and
//     passed by value; division by one of them is a multiply.
//   * the curve and desat > 0 are template parameters: no branch on the
//     curve per pixel, and only the chosen curve's code is in the kernel
//     (5 x 2 instantiations per entry, picked by the launch function).
//   * fused entry: a thread takes a run of 4 horizontally adjacent pixels
//     of one row. With W % 4 == 0 and aligned pointers it reads their Y in
//     one 8-byte load and writes their 12 bytes of BGR in three 32-bit
//     stores; otherwise it loads and stores per pixel and masks the tail.
//     Its chroma, 4 columns x 2 rows of CbCr that cover all 4 pixels, comes
//     through the read-only cache (neighbouring threads share 2 columns).
//     The 4 independent chains give the scheduler work around MUFU latency.
//     A warp covers 128 adjacent pixels: 256 B of Y and 384 B of BGR, both
//     contiguous.
//
// Plain C interface, loaded with ctypes: launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

// Filled by kernels/hdr.py (_KernelParams), field for field.
struct KernelParams {
    int32_t algo;            // 0 clip, 1 reinhard, 2 mobius, 3 hable, 4 bt.2390
    int32_t dither;          // fused entry: add the 4x4 Bayer offset
    float lin_scale;         // 10000 / sdr_nits
    float inv_lin_scale;     // sdr_nits / 10000
    float peak_c;            // max(peak, 1 + 1e-6)
    float reinhard_gain;
    float mob_j, mob_a, mob_b, mob_scale;
    float hable_inv_norm;    // 1 / max(hable(peak), 1e-6)
    float src_max_pq, inv_src_max_pq, max_lum, ks, inv_knee_span;
    float desat;
    float inv_peak_m1;       // 1 / max(peak - 1, 1e-6)
    float y_off, y_scale, c_off, c_scale;  // value = (code - off) * scale
    float gamut[9];          // BT.2020 -> BT.709, row major
    float ycc[9];            // Y'CbCr -> R'G'B' (inverse of YCbCr BT.2020)
};

}  // extern "C"

namespace {

constexpr double kM1 = 2610.0 / 16384.0;
constexpr double kM2 = 2523.0 / 4096.0 * 128.0;
constexpr float kC1 = (float)(3424.0 / 4096.0);
constexpr float kC2 = (float)(2413.0 / 4096.0 * 32.0);
constexpr float kC3 = (float)(2392.0 / 4096.0 * 32.0);
constexpr float kInvM1 = (float)(1.0 / kM1);
constexpr float kInvM2 = (float)(1.0 / kM2);

enum { kClip = 0, kReinhard = 1, kMobius = 2, kHable = 3, kBt2390 = 4 };

// 4x4 Bayer matrix as added before rounding: (m + 0.5) / 16 - 0.5
#define BAYER(m) ((m + 0.5f) / 16.0f - 0.5f)
__constant__ float kBayer[16] = {
    BAYER(0), BAYER(8), BAYER(2), BAYER(10),
    BAYER(12), BAYER(4), BAYER(14), BAYER(6),
    BAYER(3), BAYER(11), BAYER(1), BAYER(9),
    BAYER(15), BAYER(7), BAYER(13), BAYER(5)};
#undef BAYER

__device__ __forceinline__ float clamp01(float x) {
    return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float mufu_log2(float x) {
    float y;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float mufu_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// x^y for x >= 0 and y > 0 (0^y = exp2(-inf) = 0): two MUFU instructions
__device__ __forceinline__ float mufu_pow(float x, float y) {
    return mufu_exp2(y * mufu_log2(x));
}

__device__ __forceinline__ float pq_eotf(float e) {
    float p = mufu_pow(clamp01(e), kInvM2);
    float num = fmaxf(p - kC1, 0.0f);
    float den = fmaxf(kC2 - kC3 * p, 1e-10f);
    return mufu_pow(__fdividef(num, den), kInvM1);
}

__device__ __forceinline__ float pq_inv_eotf(float y) {
    float p = mufu_pow(clamp01(y), (float)kM1);
    return mufu_pow(__fdividef(kC1 + kC2 * p, 1.0f + kC3 * p), (float)kM2);
}

__device__ __forceinline__ float srgb_oetf(float x) {
    x = clamp01(x);
    float hi = 1.055f * mufu_pow(fmaxf(x, 1e-10f), (float)(1.0 / 2.4))
        - 0.055f;
    return x <= 0.0031308f ? 12.92f * x : hi;
}

__device__ __forceinline__ float hable_partial(float x) {
    constexpr float a = 0.15f, b = 0.50f;
    constexpr float cb = (float)(0.10 * 0.50), de = (float)(0.20 * 0.02),
                    df = (float)(0.20 * 0.30), ef = (float)(0.02 / 0.30);
    return __fdividef(x * (a * x + cb) + de, x * (a * x + b) + df) - ef;
}

template <int ALGO>
__device__ __forceinline__ float curve(const KernelParams& c, float x) {
    if constexpr (ALGO == kClip) {
        return clamp01(x);
    } else if constexpr (ALGO == kReinhard) {  // contrast 0.5: offset 1
        return clamp01(__fdividef(x * c.reinhard_gain, x + 1.0f));
    } else if constexpr (ALGO == kMobius) {
        float mapped = __fdividef(c.mob_scale * (x + c.mob_a), x + c.mob_b);
        return clamp01(x <= c.mob_j ? x : mapped);
    } else if constexpr (ALGO == kHable) {
        return clamp01(hable_partial(x) * c.hable_inv_norm);
    } else {  // bt.2390 and its aliases
        float xc = fminf(fmaxf(x, 0.0f), c.peak_c);
        float e1 = pq_inv_eotf(xc * c.inv_lin_scale) * c.inv_src_max_pq;
        float t = clamp01((e1 - c.ks) * c.inv_knee_span);
        float t2 = t * t, t3 = t2 * t;
        float p = (2.0f * t3 - 3.0f * t2 + 1.0f) * c.ks
            + (t3 - 2.0f * t2 + t) * (1.0f - c.ks)
            + (-2.0f * t3 + 3.0f * t2) * c.max_lum;
        float e2 = e1 < c.ks ? e1 : p;
        return clamp01(pq_eotf(e2 * c.src_max_pq) * c.lin_scale);
    }
}

// The chain on one pixel's R'G'B' -> encoded (sRGB) RGB in [0, 1].
template <int ALGO, bool DESAT>
__device__ __forceinline__ void tonemap_pixel(const KernelParams& c,
                                              float r, float g, float b,
                                              float out[3]) {
    float rgb[3] = {pq_eotf(r) * c.lin_scale, pq_eotf(g) * c.lin_scale,
                    pq_eotf(b) * c.lin_scale};
    float lum = fmaxf(fmaxf(fmaxf(rgb[0], rgb[1]), rgb[2]), 1e-6f);
    float ratio = __fdividef(curve<ALGO>(c, lum), lum);
    float mapped[3];
    #pragma unroll
    for (int k = 0; k < 3; ++k) mapped[k] = rgb[k] * ratio;
    if constexpr (DESAT) {
        float w = c.desat * clamp01((lum - 1.0f) * c.inv_peak_m1);
        #pragma unroll
        for (int k = 0; k < 3; ++k)
            mapped[k] = mapped[k] * (1.0f - w) + curve<ALGO>(c, rgb[k]) * w;
    }
    #pragma unroll
    for (int k = 0; k < 3; ++k) mapped[k] = clamp01(mapped[k]);
    #pragma unroll
    for (int k = 0; k < 3; ++k)
        out[k] = srgb_oetf(c.gamut[3 * k] * mapped[0]
                           + c.gamut[3 * k + 1] * mapped[1]
                           + c.gamut[3 * k + 2] * mapped[2]);
}

template <int ALGO, bool DESAT>
__global__ void __launch_bounds__(256)
tonemap_planes_kernel(const float* __restrict__ in, float* __restrict__ out,
                      int64_t plane, KernelParams c) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= plane) return;
    float enc[3];
    tonemap_pixel<ALGO, DESAT>(c, __ldg(in + i), __ldg(in + plane + i),
                               __ldg(in + 2 * plane + i), enc);
    out[i] = enc[0];
    out[plane + i] = enc[1];
    out[2 * plane + i] = enc[2];
}

__device__ __forceinline__ float code10(uint32_t bits) {
    return (float)((bits & 0xFFFFu) >> 6);
}

// encoded value in [0, 1] -> rounded (half to even, as torch.round) and
// clamped 8-bit code; the multiply and add round apart, as in the plain
// version
__device__ __forceinline__ uint32_t quantize(float v, float dither) {
    float x = rintf(__fadd_rn(__fmul_rn(v, 255.0f), dither));
    return (uint32_t)fminf(fmaxf(x, 0.0f), 255.0f);
}

constexpr int kRun = 4;                  // pixels per thread
constexpr int kBlockX = 64, kBlockY = 4;

template <int ALGO, bool DESAT>
__global__ void __launch_bounds__(kBlockX * kBlockY)
hdr_to_sdr_bgr_kernel(const uint16_t* __restrict__ yp,
                      const uint16_t* __restrict__ uvp,
                      uint8_t* __restrict__ out, int height, int width,
                      bool vec, KernelParams c) {
    const int qx = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    const int x0 = kRun * qx;
    if (y >= height || x0 >= width) return;
    const int cw = width >> 1, ch = height >> 1;
    const int64_t row = (int64_t)y * width;

    // Chroma rows with half-pixel centres: an even row 2r sits between
    // rows r-1 (0.25) and r (0.75), an odd row 2r+1 between r (0.75) and
    // r+1 (0.25); clamping at the edges gives the edge sample. Codes
    // interpolate exactly in float32 (quarters of integers below 2^10).
    const int r = y >> 1;
    const bool odd = y & 1;
    const int ra = odd ? r : max(r - 1, 0);
    const int rb = odd ? min(r + 1, ch - 1) : r;
    const float wa = odd ? 0.75f : 0.25f, wb = 1.0f - wa;
    float cb[kRun], cr[kRun];  // columns 2qx-1 .. 2qx+2, clamped
    #pragma unroll
    for (int j = 0; j < kRun; ++j) {
        const int cx = min(max(2 * qx - 1 + j, 0), cw - 1);
        const uint16_t* pa = uvp + 2 * ((int64_t)ra * cw + cx);
        const uint16_t* pb = uvp + 2 * ((int64_t)rb * cw + cx);
        cb[j] = wa * code10(__ldg(pa)) + wb * code10(__ldg(pb));
        cr[j] = wa * code10(__ldg(pa + 1)) + wb * code10(__ldg(pb + 1));
    }

    float yc[kRun];
    if (vec) {
        const uint2 w = __ldg(reinterpret_cast<const uint2*>(yp + row + x0));
        yc[0] = code10(w.x);
        yc[1] = code10(w.x >> 16);
        yc[2] = code10(w.y);
        yc[3] = code10(w.y >> 16);
    } else {
        #pragma unroll
        for (int i = 0; i < kRun; ++i)
            yc[i] = x0 + i < width ? code10(__ldg(yp + row + x0 + i)) : 0.0f;
    }

    uint32_t q[3 * kRun];  // B, G, R per pixel
    #pragma unroll
    for (int i = 0; i < kRun; ++i) {
        // pixel 2k sits between chroma columns k-1 (0.25) and k (0.75),
        // pixel 2k+1 between k (0.75) and k+1 (0.25)
        const int lo = (i + 1) >> 1;
        const float wl = (i & 1) ? 0.75f : 0.25f, wh = 1.0f - wl;
        const float yn = (yc[i] - c.y_off) * c.y_scale;
        const float cbn = (wl * cb[lo] + wh * cb[lo + 1] - c.c_off)
            * c.c_scale - 0.5f;
        const float crn = (wl * cr[lo] + wh * cr[lo + 1] - c.c_off)
            * c.c_scale - 0.5f;
        float rgb[3];
        #pragma unroll
        for (int k = 0; k < 3; ++k)
            rgb[k] = clamp01(c.ycc[3 * k] * yn + c.ycc[3 * k + 1] * cbn
                             + c.ycc[3 * k + 2] * crn);
        float enc[3];
        tonemap_pixel<ALGO, DESAT>(c, rgb[0], rgb[1], rgb[2], enc);
        // the Bayer tile starts at the crop's top-left; x0 % 4 == 0
        const float d = c.dither ? kBayer[(y & 3) * 4 + i] : 0.0f;
        q[3 * i] = quantize(enc[2], d);
        q[3 * i + 1] = quantize(enc[1], d);
        q[3 * i + 2] = quantize(enc[0], d);
    }

    uint8_t* o = out + 3 * (row + x0);
    if (vec) {
        uint32_t* o32 = reinterpret_cast<uint32_t*>(o);
        #pragma unroll
        for (int k = 0; k < 3; ++k)
            o32[k] = q[4 * k] | (q[4 * k + 1] << 8) | (q[4 * k + 2] << 16)
                | (q[4 * k + 3] << 24);
    } else {
        #pragma unroll
        for (int i = 0; i < kRun; ++i)
            if (x0 + i < width) {
                o[3 * i] = (uint8_t)q[3 * i];
                o[3 * i + 1] = (uint8_t)q[3 * i + 1];
                o[3 * i + 2] = (uint8_t)q[3 * i + 2];
            }
    }
}

template <int ALGO, bool DESAT>
cudaError_t launch_planes(const float* in, float* out, int64_t plane,
                          const KernelParams& p, cudaStream_t stream) {
    const int threads = 256;
    const int64_t blocks = (plane + threads - 1) / threads;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    tonemap_planes_kernel<ALGO, DESAT><<<(unsigned)blocks, threads, 0,
                                         stream>>>(in, out, plane, p);
    return cudaGetLastError();
}

template <int ALGO, bool DESAT>
cudaError_t launch_fused(const uint16_t* y, const uint16_t* uv, uint8_t* out,
                         int height, int width, bool vec,
                         const KernelParams& p, cudaStream_t stream) {
    const dim3 block(kBlockX, kBlockY);
    const int runs = (width + kRun - 1) / kRun;
    const dim3 grid((runs + kBlockX - 1) / kBlockX,
                    (height + kBlockY - 1) / kBlockY);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    hdr_to_sdr_bgr_kernel<ALGO, DESAT><<<grid, block, 0, stream>>>(
        y, uv, out, height, width, vec, p);
    return cudaGetLastError();
}

using PlanesLaunch = cudaError_t (*)(const float*, float*, int64_t,
                                     const KernelParams&, cudaStream_t);
using FusedLaunch = cudaError_t (*)(const uint16_t*, const uint16_t*,
                                    uint8_t*, int, int, bool,
                                    const KernelParams&, cudaStream_t);

const PlanesLaunch kPlanes[5][2] = {
    {launch_planes<kClip, false>, launch_planes<kClip, true>},
    {launch_planes<kReinhard, false>, launch_planes<kReinhard, true>},
    {launch_planes<kMobius, false>, launch_planes<kMobius, true>},
    {launch_planes<kHable, false>, launch_planes<kHable, true>},
    {launch_planes<kBt2390, false>, launch_planes<kBt2390, true>}};

const FusedLaunch kFused[5][2] = {
    {launch_fused<kClip, false>, launch_fused<kClip, true>},
    {launch_fused<kReinhard, false>, launch_fused<kReinhard, true>},
    {launch_fused<kMobius, false>, launch_fused<kMobius, true>},
    {launch_fused<kHable, false>, launch_fused<kHable, true>},
    {launch_fused<kBt2390, false>, launch_fused<kBt2390, true>}};

}  // namespace

extern "C" int tonemap_planes_launch(const float* in, float* out,
                                     int64_t height, int64_t width,
                                     const KernelParams* params,
                                     void* stream) {
    const int64_t plane = height * width;
    if (plane <= 0) return (int)cudaSuccess;
    if (params->algo < 0 || params->algo > 4)
        return (int)cudaErrorInvalidValue;
    return (int)kPlanes[params->algo][params->desat > 0.0f](
        in, out, plane, *params, (cudaStream_t)stream);
}

extern "C" int hdr_to_sdr_bgr_launch(const int16_t* y, const int16_t* uv,
                                     uint8_t* out, int64_t height,
                                     int64_t width,
                                     const KernelParams* params,
                                     void* stream) {
    if (height <= 0 || width <= 0) return (int)cudaSuccess;
    if ((height | width) & 1 || height > 0x7fffffff || width > 0x7fffffff
        || params->algo < 0 || params->algo > 4)
        return (int)cudaErrorInvalidValue;
    const bool vec = width % kRun == 0 && (uintptr_t)y % 8 == 0
        && (uintptr_t)out % 4 == 0;
    return (int)kFused[params->algo][params->desat > 0.0f](
        reinterpret_cast<const uint16_t*>(y),
        reinterpret_cast<const uint16_t*>(uv), out, (int)height, (int)width,
        vec, *params, (cudaStream_t)stream);
}
