// Native data loader: JPEG/PNG decode -> PIL-exact bicubic resize ->
// center crop -> normalize, multithreaded across a batch.
//
// The decode and resize of a batch run in a C++ thread pool inside the
// process, in place of a pool of forked loader processes, and fill the
// host buffers the batch is copied to the device from.
//
// Preprocessing parity is a real accuracy risk, so the resize replicates
// Pillow's 8-bit resampling pipeline EXACTLY (Resample.c):
// separable convolution, horizontal then vertical, with int32 fixed-point
// coefficients at PRECISION_BITS = 22 and per-pass rounding back to uint8.
// The bicubic kernel is Catmull-Rom-like with a = -0.5, support 2.0, and
// the filter is widened (not truncated) when downscaling. Golden tests
// assert bit-identical output vs PIL (tests/test_torch_data.py).
//
// Build: see p2vit_tpu_torch/native/__init__.py (g++ -O3 -shared, links the
// system libjpeg + libpng).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>
#include <atomic>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------------------
// Decoding
// ---------------------------------------------------------------------------

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(err->jump, 1);
}

// Decode a JPEG file to RGB8 (grayscale is expanded by libjpeg, matching
// PIL convert("RGB") channel replication). Returns empty on failure.
std::vector<uint8_t> decode_jpeg(FILE* f, int* w, int* h) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    std::vector<uint8_t> out;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return {};
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;          // CMYK/YCCK also land on RGB
    cinfo.dct_method = JDCT_ISLOW;            // Pillow's default IDCT
    jpeg_start_decompress(&cinfo);
    *w = cinfo.output_width;
    *h = cinfo.output_height;
    out.resize(size_t(*w) * *h * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out.data() + size_t(cinfo.output_scanline) * *w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return out;
}

// Decode a PNG file to RGB8 (palette expanded, 16-bit stripped, alpha
// dropped — PIL convert("RGB") discards alpha without blending).
std::vector<uint8_t> decode_png(FILE* f, int* w, int* h) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    if (!png) return {};
    png_infop info = png_create_info_struct(png);
    std::vector<uint8_t> out;
    if (!info || setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
        return {};
    }
    png_init_io(png, f);
    png_read_info(png, info);
    png_set_palette_to_rgb(png);
    png_set_expand_gray_1_2_4_to_8(png);
    png_set_gray_to_rgb(png);
    png_set_strip_16(png);
    png_set_strip_alpha(png);
    png_read_update_info(png, info);
    *w = png_get_image_width(png, info);
    *h = png_get_image_height(png, info);
    out.resize(size_t(*w) * *h * 3);
    std::vector<png_bytep> rows(*h);
    for (int y = 0; y < *h; y++) rows[y] = out.data() + size_t(y) * *w * 3;
    png_read_image(png, rows.data());
    png_read_end(png, nullptr);
    png_destroy_read_struct(&png, &info, nullptr);
    return out;
}

std::vector<uint8_t> decode_image(const char* path, int* w, int* h) {
    FILE* f = fopen(path, "rb");
    if (!f) return {};
    uint8_t magic[8] = {0};
    size_t got = fread(magic, 1, 8, f);
    rewind(f);
    std::vector<uint8_t> out;
    if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
        out = decode_jpeg(f, w, h);
    } else if (got >= 8 && !png_sig_cmp(magic, 0, 8)) {
        out = decode_png(f, w, h);
    }
    fclose(f);
    return out;
}

// ---------------------------------------------------------------------------
// PIL-exact 8-bit resampling (Pillow src/libImaging/Resample.c)
// ---------------------------------------------------------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;  // 22

inline double bicubic_filter(double x) {
    constexpr double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
    if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
    return 0.0;
}

inline uint8_t clip8(int64_t in) {
    if (in >= (int64_t(1) << kPrecisionBits << 8)) return 255;
    if (in <= 0) return 0;
    return uint8_t(in >> kPrecisionBits);
}

// Pillow precompute_coeffs + normalize_coeffs_8bpc.
int precompute_coeffs(int in_size, int out_size, std::vector<int>& bounds,
                      std::vector<int32_t>& kk) {
    constexpr double support_base = 2.0;  // bicubic
    double scale = double(in_size) / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = support_base * filterscale;
    int ksize = int(ceil(support)) * 2 + 1;
    bounds.resize(size_t(out_size) * 2);
    std::vector<double> prekk(size_t(out_size) * ksize);
    for (int xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = int(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = int(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double* k = &prekk[size_t(xx) * ksize];
        int x = 0;
        for (; x < xmax; x++) {
            double w = bicubic_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; x++)
            if (ww != 0.0) k[x] /= ww;
        for (; x < ksize; x++) k[x] = 0;
        bounds[size_t(xx) * 2 + 0] = xmin;
        bounds[size_t(xx) * 2 + 1] = xmax;
    }
    kk.resize(prekk.size());
    for (size_t i = 0; i < prekk.size(); i++) {
        kk[i] = prekk[i] < 0
                    ? int32_t(-0.5 + prekk[i] * (1 << kPrecisionBits))
                    : int32_t(0.5 + prekk[i] * (1 << kPrecisionBits));
    }
    return ksize;
}

// One separable pass along the row (horizontal) direction; RGB8.
std::vector<uint8_t> resample_horizontal(const std::vector<uint8_t>& im,
                                         int w, int h, int out_w) {
    std::vector<int> bounds;
    std::vector<int32_t> kk;
    int ksize = precompute_coeffs(w, out_w, bounds, kk);
    std::vector<uint8_t> out(size_t(out_w) * h * 3);
    for (int yy = 0; yy < h; yy++) {
        const uint8_t* line = im.data() + size_t(yy) * w * 3;
        uint8_t* oline = out.data() + size_t(yy) * out_w * 3;
        for (int xx = 0; xx < out_w; xx++) {
            int xmin = bounds[size_t(xx) * 2 + 0];
            int xmax = bounds[size_t(xx) * 2 + 1];
            const int32_t* k = &kk[size_t(xx) * ksize];
            int64_t ss0 = int64_t(1) << (kPrecisionBits - 1);
            int64_t ss1 = ss0, ss2 = ss0;
            for (int x = 0; x < xmax; x++) {
                const uint8_t* p = line + size_t(xmin + x) * 3;
                ss0 += int64_t(p[0]) * k[x];
                ss1 += int64_t(p[1]) * k[x];
                ss2 += int64_t(p[2]) * k[x];
            }
            oline[size_t(xx) * 3 + 0] = clip8(ss0);
            oline[size_t(xx) * 3 + 1] = clip8(ss1);
            oline[size_t(xx) * 3 + 2] = clip8(ss2);
        }
    }
    return out;
}

std::vector<uint8_t> resample_vertical(const std::vector<uint8_t>& im, int w,
                                       int h, int out_h) {
    std::vector<int> bounds;
    std::vector<int32_t> kk;
    int ksize = precompute_coeffs(h, out_h, bounds, kk);
    std::vector<uint8_t> out(size_t(w) * out_h * 3);
    for (int yy = 0; yy < out_h; yy++) {
        int ymin = bounds[size_t(yy) * 2 + 0];
        int ymax = bounds[size_t(yy) * 2 + 1];
        const int32_t* k = &kk[size_t(yy) * ksize];
        uint8_t* oline = out.data() + size_t(yy) * w * 3;
        for (int xx = 0; xx < w; xx++) {
            int64_t ss0 = int64_t(1) << (kPrecisionBits - 1);
            int64_t ss1 = ss0, ss2 = ss0;
            for (int y = 0; y < ymax; y++) {
                const uint8_t* p = im.data() + (size_t(ymin + y) * w + xx) * 3;
                ss0 += int64_t(p[0]) * k[y];
                ss1 += int64_t(p[1]) * k[y];
                ss2 += int64_t(p[2]) * k[y];
            }
            oline[size_t(xx) * 3 + 0] = clip8(ss0);
            oline[size_t(xx) * 3 + 1] = clip8(ss1);
            oline[size_t(xx) * 3 + 2] = clip8(ss2);
        }
    }
    return out;
}

// Pillow ImagingResample order: horizontal pass first, then vertical (each
// skipped when that dimension is unchanged).
std::vector<uint8_t> resize_bicubic(std::vector<uint8_t> im, int w, int h,
                                    int out_w, int out_h) {
    if (out_w != w) {
        im = resample_horizontal(im, w, h, out_w);
        w = out_w;
    }
    if (out_h != h) {
        im = resample_vertical(im, w, h, out_h);
        h = out_h;
    }
    return im;
}

// ---------------------------------------------------------------------------
// Per-image pipeline
// ---------------------------------------------------------------------------

// torchvision Resize(int) geometry: shorter side -> size (data.py:41-45).
void resize_dims(int w, int h, int size, int* nw, int* nh) {
    if (w < h) {
        *nw = size;
        int t = int(lround(double(size) * h / w));
        *nh = t < size ? size : t;
    } else {
        *nh = size;
        int t = int(lround(double(size) * w / h));
        *nw = t < size ? size : t;
    }
}

// decode -> resize -> center-crop -> normalize into out[3, img, img] (CHW).
int process_one(const char* path, int resize_size, int img_size,
                const float* mean, const float* std_, float* out) {
    int w = 0, h = 0;
    std::vector<uint8_t> rgb = decode_image(path, &w, &h);
    if (rgb.empty() || w <= 0 || h <= 0) return 1;
    int nw, nh;
    resize_dims(w, h, resize_size, &nw, &nh);
    rgb = resize_bicubic(std::move(rgb), w, h, nw, nh);
    int left = (nw - img_size) / 2;
    int top = (nh - img_size) / 2;
    if (left < 0 || top < 0) return 2;
    for (int y = 0; y < img_size; y++) {
        const uint8_t* line = rgb.data() + (size_t(top + y) * nw + left) * 3;
        for (int x = 0; x < img_size; x++) {
            for (int c = 0; c < 3; c++) {
                // keep the exact (p/255 - mean)/std association of the
                // Python transform (data.py:50-51); a fused multiply-add
                // form would reassociate and drift by 1 ulp
                float v = (float(line[size_t(x) * 3 + c]) / 255.0f - mean[c]) /
                          std_[c];
                out[(size_t(c) * img_size + y) * img_size + x] = v;
            }
        }
    }
    return 0;
}

// decode -> resize -> center-crop into out[3, img, img] (CHW uint8, no
// normalize): the raw-u8 ingestion entry — normalize+quantize replay on
// device (serving.attach_u8_ingest), so the host stops at pixel bytes.
int process_one_u8(const char* path, int resize_size, int img_size,
                   uint8_t* out) {
    int w = 0, h = 0;
    std::vector<uint8_t> rgb = decode_image(path, &w, &h);
    if (rgb.empty() || w <= 0 || h <= 0) return 1;
    int nw, nh;
    resize_dims(w, h, resize_size, &nw, &nh);
    rgb = resize_bicubic(std::move(rgb), w, h, nw, nh);
    int left = (nw - img_size) / 2;
    int top = (nh - img_size) / 2;
    if (left < 0 || top < 0) return 2;
    for (int y = 0; y < img_size; y++) {
        const uint8_t* line = rgb.data() + (size_t(top + y) * nw + left) * 3;
        for (int x = 0; x < img_size; x++) {
            for (int c = 0; c < 3; c++) {
                out[(size_t(c) * img_size + y) * img_size + x] =
                    line[size_t(x) * 3 + c];
            }
        }
    }
    return 0;
}

}  // namespace

extern "C" {

// Batch entry point: decode+preprocess n images into out[n, 3, img, img]
// with a thread pool. Returns the number of FAILED images; rc[i] holds the
// per-image status (0 ok).
int p2vit_load_batch(const char** paths, int n, int resize_size, int img_size,
                     const float* mean, const float* std_, float* out,
                     int* rc, int n_threads) {
    if (n_threads <= 0) {
        n_threads = int(std::thread::hardware_concurrency());
        if (n_threads <= 0) n_threads = 4;
    }
    if (n_threads > n) n_threads = n;
    std::atomic<int> next(0), failed(0);
    size_t stride = size_t(3) * img_size * img_size;
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n) return;
            int r = process_one(paths[i], resize_size, img_size, mean, std_,
                                out + stride * i);
            rc[i] = r;
            if (r) failed.fetch_add(1);
        }
    };
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
    return failed.load();
}

// Raw-u8 batch entry: decode+resize+crop n images into out[n, 3, img, img]
// CHW uint8 (no normalize — see process_one_u8). Same pool/rc contract as
// p2vit_load_batch.
int p2vit_load_batch_u8(const char** paths, int n, int resize_size,
                        int img_size, uint8_t* out, int* rc, int n_threads) {
    if (n_threads <= 0) {
        n_threads = int(std::thread::hardware_concurrency());
        if (n_threads <= 0) n_threads = 4;
    }
    if (n_threads > n) n_threads = n;
    std::atomic<int> next(0), failed(0);
    size_t stride = size_t(3) * img_size * img_size;
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n) return;
            int r = process_one_u8(paths[i], resize_size, img_size,
                                   out + stride * i);
            rc[i] = r;
            if (r) failed.fetch_add(1);
        }
    };
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
    return failed.load();
}

// Single-image decode+resize to RGB8 HWC (for the parity tests): returns 0
// on success and writes the resized RGB into out (must hold nw*nh*3).
int p2vit_decode_resize(const char* path, int nw, int nh, uint8_t* out) {
    int w = 0, h = 0;
    std::vector<uint8_t> rgb = decode_image(path, &w, &h);
    if (rgb.empty()) return 1;
    rgb = resize_bicubic(std::move(rgb), w, h, nw, nh);
    memcpy(out, rgb.data(), rgb.size());
    return 0;
}

}  // extern "C"
