// Native crop + resample core for the training input pipeline.
//
// Replicates PIL/Pillow's resize semantics BIT-EXACTLY so the packed
// dataset can swap it in for `Image.fromarray(crop).resize(size, BILINEAR/
// NEAREST)` (data/ntu.py load_raw) without changing a single pixel:
//   * separable two-pass (horizontal then vertical) resampling with the
//     antialias-scaled triangle (bilinear) filter, 8-bit fixed-point
//     coefficients (PRECISION_BITS = 32-8-2), uint8 intermediate rows —
//     the exact quantization chain Pillow's Resample uses for uint8 bands
//   * NEAREST for uint16 depth: src = floor((dst + 0.5) * in/out)
//   * the crop window is read straight out of the (possibly memory-mapped)
//     frame with zero padding outside bounds (transforms.crop_pad), so no
//     intermediate full-frame copy is made on the Python side.
//
// tests/test_torch_packed.py asserts byte equality against Pillow over
// random boxes (including out-of-bounds pads, up- and down-scales).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;

static inline uint8_t clip8(int in) {
    if (in >= (1 << (PRECISION_BITS + 8))) return 255;
    if (in <= 0) return 0;
    return (uint8_t)(in >> PRECISION_BITS);
}

static inline double bilinear_filter(double x) {
    if (x < 0.0) x = -x;
    if (x < 1.0) return 1.0 - x;
    return 0.0;
}

// Pillow precompute_coeffs: normalized double weights -> bounds + weights.
static int precompute_coeffs(long in_size, long out_size,
                             std::vector<int>& bounds,
                             std::vector<double>& kk) {
    double scale = (double)in_size / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = 1.0 * filterscale;  // bilinear support = 1.0
    int ksize = (int)ceil(support) * 2 + 1;

    bounds.resize(out_size * 2);
    kk.resize((size_t)out_size * ksize);
    for (long xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        long xmin = (long)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        long xmax = (long)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double* k = &kk[(size_t)xx * ksize];
        long x = 0;
        for (; x < xmax; x++) {
            double w = bilinear_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; x++) {
            if (ww != 0.0) k[x] /= ww;
        }
        for (; x < ksize; x++) k[x] = 0.0;
        bounds[xx * 2 + 0] = (int)xmin;
        bounds[xx * 2 + 1] = (int)xmax;
    }
    return ksize;
}

static void normalize_coeffs_8bpc(const std::vector<double>& kk,
                                  std::vector<int>& kk_int) {
    kk_int.resize(kk.size());
    for (size_t i = 0; i < kk.size(); i++) {
        double w = kk[i];
        kk_int[i] = w < 0 ? (int)(-0.5 + w * (1 << PRECISION_BITS))
                          : (int)(0.5 + w * (1 << PRECISION_BITS));
    }
}

}  // namespace

extern "C" {

// Crop (ci, cj, crop_h, crop_w) out of an (fh, fw, ch) uint8 frame with
// zero padding outside bounds, resample to (out_h, out_w) with Pillow
// BILINEAR semantics, optional horizontal flip. out: out_h*out_w*ch.
int resized_crop_u8(const uint8_t* frame, long fh, long fw, long ch,
                    long ci, long cj, long crop_h, long crop_w,
                    long out_h, long out_w, int flip, uint8_t* out) {
    if (ch < 1 || ch > 4 || crop_h < 1 || crop_w < 1 || out_h < 1 ||
        out_w < 1)
        return -1;

    // materialize the zero-padded crop window (rows memcpy'd from the
    // frame; for mmap frames the kernel pages in only these rows)
    std::vector<uint8_t> crop((size_t)crop_h * crop_w * ch, 0);
    long r0 = std::max(ci, 0L), r1 = std::min(ci + crop_h, fh);
    long c0 = std::max(cj, 0L), c1 = std::min(cj + crop_w, fw);
    if (r0 < r1 && c0 < c1) {
        long span = (c1 - c0) * ch;
        for (long r = r0; r < r1; r++) {
            std::memcpy(&crop[((size_t)(r - ci) * crop_w + (c0 - cj)) * ch],
                        &frame[((size_t)r * fw + c0) * ch], span);
        }
    }

    // horizontal pass: (crop_h, crop_w) -> (crop_h, out_w)
    std::vector<int> bounds;
    std::vector<double> kk;
    std::vector<int> kki;
    int ksize = precompute_coeffs(crop_w, out_w, bounds, kk);
    normalize_coeffs_8bpc(kk, kki);
    std::vector<uint8_t> horiz((size_t)crop_h * out_w * ch);
    for (long y = 0; y < crop_h; y++) {
        const uint8_t* row = &crop[(size_t)y * crop_w * ch];
        uint8_t* orow = &horiz[(size_t)y * out_w * ch];
        for (long xx = 0; xx < out_w; xx++) {
            int xmin = bounds[xx * 2], xmax = bounds[xx * 2 + 1];
            const int* k = &kki[(size_t)xx * ksize];
            for (long b = 0; b < ch; b++) {
                int ss = 1 << (PRECISION_BITS - 1);
                for (int x = 0; x < xmax; x++)
                    ss += row[(size_t)(xmin + x) * ch + b] * k[x];
                orow[(size_t)xx * ch + b] = clip8(ss);
            }
        }
    }

    // vertical pass: (crop_h, out_w) -> (out_h, out_w)
    ksize = precompute_coeffs(crop_h, out_h, bounds, kk);
    normalize_coeffs_8bpc(kk, kki);
    for (long yy = 0; yy < out_h; yy++) {
        int ymin = bounds[yy * 2], ymax = bounds[yy * 2 + 1];
        const int* k = &kki[(size_t)yy * ksize];
        uint8_t* orow = &out[(size_t)yy * out_w * ch];
        for (long xx = 0; xx < out_w; xx++) {
            for (long b = 0; b < ch; b++) {
                int ss = 1 << (PRECISION_BITS - 1);
                for (int y = 0; y < ymax; y++)
                    ss += horiz[((size_t)(ymin + y) * out_w + xx) * ch + b] *
                          k[y];
                orow[(size_t)xx * ch + b] = clip8(ss);
            }
        }
    }

    if (flip) {
        for (long yy = 0; yy < out_h; yy++) {
            uint8_t* row = &out[(size_t)yy * out_w * ch];
            for (long xx = 0; xx < out_w / 2; xx++)
                for (long b = 0; b < ch; b++)
                    std::swap(row[(size_t)xx * ch + b],
                              row[(size_t)(out_w - 1 - xx) * ch + b]);
        }
    }
    return 0;
}

// NEAREST crop-resample for uint16 depth (Pillow: src = floor((dst+0.5) *
// in/out)), zero-padded crop, optional horizontal flip.
int resized_crop_nearest_u16(const uint16_t* frame, long fh, long fw,
                             long ci, long cj, long crop_h, long crop_w,
                             long out_h, long out_w, int flip,
                             uint16_t* out) {
    if (crop_h < 1 || crop_w < 1 || out_h < 1 || out_w < 1) return -1;
    double ys = (double)crop_h / out_h, xs = (double)crop_w / out_w;
    std::vector<long> xsrc(out_w);
    for (long xx = 0; xx < out_w; xx++) {
        // flip mirrors the OUTPUT coordinate (PIL transposes after resize)
        long oxx = flip ? (out_w - 1 - xx) : xx;
        long sx = (long)((oxx + 0.5) * xs);
        if (sx >= crop_w) sx = crop_w - 1;
        xsrc[xx] = cj + sx;
    }
    for (long yy = 0; yy < out_h; yy++) {
        long sy = (long)((yy + 0.5) * ys);
        if (sy >= crop_h) sy = crop_h - 1;
        long fr = ci + sy;
        uint16_t* orow = &out[(size_t)yy * out_w];
        if (fr < 0 || fr >= fh) {
            std::memset(orow, 0, sizeof(uint16_t) * out_w);
            continue;
        }
        const uint16_t* row = &frame[(size_t)fr * fw];
        for (long xx = 0; xx < out_w; xx++) {
            long fc = xsrc[xx];
            orow[xx] = (fc < 0 || fc >= fw) ? 0 : row[fc];
        }
    }
    return 0;
}

}  // extern "C"
