/* Fused JPEG decode + bilinear resize (libjpeg) for the port's host data
 * pipeline, with a plain C interface bound through ctypes
 * (mtlx_torch/data/imgcodec.py). The port's copy of mtlx/data/_imgcodec.cc:
 * the same DCT-scaled decode and the same resize, so the pixels are
 * bit-equal; the CPython module around them is replaced by C functions
 * that write into buffers the caller owns, one of which decodes with
 * TensorFlow's decode_jpeg settings instead. ctypes releases the
 * interpreter lock for the call, and decode_batch runs a std::thread pool.
 * Built at first use by mtlx_torch/kernels/build.py with g++, against the
 * libjpeg-turbo headers in jpeg/ and the libjpeg-turbo of Pillow's wheel.
 */
#include <csetjmp>
#include <cstddef>
#include <cstdio>
#include <cstring>
#include <atomic>
#include <string>
#include <thread>
#include <vector>

extern "C" {
#include <jpeglib.h>
}

namespace {

struct ErrMgr {
    jpeg_error_mgr pub;
    jmp_buf jb;
    char msg[JMSG_LENGTH_MAX];
};

void err_exit(j_common_ptr cinfo) {
    ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
    (*cinfo->err->format_message)(cinfo, e->msg);
    longjmp(e->jb, 1);
}

// bilinear, RGB interleaved uint8. legacy=0: half-pixel centers (TF2 /
// jax convention); legacy=1: src = dst * scale (TF1 resize_images
// align_corners=False — the reference's in-graph resize).
void resize_bilinear(const unsigned char* src, int sh, int sw,
                     unsigned char* dst, int th, int tw, int legacy) {
    if (sh == th && sw == tw) {
        std::memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
        return;
    }
    const float sy = static_cast<float>(sh) / th;
    const float sx = static_cast<float>(sw) / tw;
    std::vector<int> x0s(tw), x1s(tw);
    std::vector<float> wxs(tw);
    for (int x = 0; x < tw; x++) {
        float fx = legacy ? x * sx : (x + 0.5f) * sx - 0.5f;
        if (fx < 0) fx = 0;
        if (fx > sw - 1) fx = static_cast<float>(sw - 1);
        int x0 = static_cast<int>(fx);
        x0s[x] = x0;
        x1s[x] = x0 + 1 < sw ? x0 + 1 : sw - 1;
        wxs[x] = fx - x0;
    }
    for (int y = 0; y < th; y++) {
        float fy = legacy ? y * sy : (y + 0.5f) * sy - 0.5f;
        if (fy < 0) fy = 0;
        if (fy > sh - 1) fy = static_cast<float>(sh - 1);
        int y0 = static_cast<int>(fy);
        int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
        float wy = fy - y0;
        const unsigned char* r0 = src + static_cast<size_t>(y0) * sw * 3;
        const unsigned char* r1 = src + static_cast<size_t>(y1) * sw * 3;
        unsigned char* out = dst + static_cast<size_t>(y) * tw * 3;
        for (int x = 0; x < tw; x++) {
            int x0 = x0s[x] * 3, x1 = x1s[x] * 3;
            float wx = wxs[x];
            for (int c = 0; c < 3; c++) {
                float top = r0[x0 + c] + (r0[x1 + c] - r0[x0 + c]) * wx;
                float bot = r1[x0 + c] + (r1[x1 + c] - r1[x0 + c]) * wx;
                float v = top + (bot - top) * wy;
                out[x * 3 + c] = static_cast<unsigned char>(v + 0.5f);
            }
        }
    }
}

// decode JPEG -> RGB into out[th * tw * 3]: when (th, tw) < source dims,
// decode at the smallest sufficient DCT scale, then bilinear to exactly
// (th, tw). Returns false with `err` set on corrupt input.
bool decode_impl(const unsigned char* data, size_t len, int th, int tw,
                 unsigned char* out, size_t out_cap, int* dims,
                 std::string& err, int legacy, bool ifast = false) {
    if (th < 1 || tw < 1 || static_cast<size_t>(th) * tw * 3 > out_cap) {
        err = "decode target " + std::to_string(th) + "x" + std::to_string(tw) +
              " does not fit the output buffer";
        return false;
    }
    jpeg_decompress_struct cinfo;
    ErrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = err_exit;
    std::vector<unsigned char> raw;
    if (setjmp(jerr.jb)) {
        err = jerr.msg;
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    const int src_h = static_cast<int>(cinfo.image_height);
    const int src_w = static_cast<int>(cinfo.image_width);
    cinfo.out_color_space = JCS_RGB;  // grayscale/YCbCr -> RGB in-decode
    if (ifast) cinfo.dct_method = JDCT_IFAST;
    // legacy (TF1-parity) mode decodes at full resolution: the reference
    // resized from the full image, so DCT-scaled decode would change the
    // input to the resize
    if (!legacy && th < src_h && tw < src_w) {
        double f = static_cast<double>(th) / src_h;
        double fx = static_cast<double>(tw) / src_w;
        if (fx > f) f = fx;
        int num = static_cast<int>(f * 8.0);
        if (num * 1.0 < f * 8.0) num += 1;  // ceil: never below target
        if (num < 1) num = 1;
        if (num > 8) num = 8;
        cinfo.scale_num = static_cast<unsigned>(num);
        cinfo.scale_denom = 8;
    }
    jpeg_start_decompress(&cinfo);
    const int dh = static_cast<int>(cinfo.output_height);
    const int dw = static_cast<int>(cinfo.output_width);
    raw.resize(static_cast<size_t>(dh) * dw * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        unsigned char* row =
            raw.data() + static_cast<size_t>(cinfo.output_scanline) * dw * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    resize_bilinear(raw.data(), dh, dw, out, th, tw, legacy);
    dims[0] = src_h;
    dims[1] = src_w;
    dims[2] = th;
    dims[3] = tw;
    return true;
}

void set_err(char* err, int errlen, const std::string& msg) {
    if (err && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// (height, width) from the JPEG header; 0 on success, 1 with err set
int mtlx_jpeg_dims(const unsigned char* data, size_t len, int* h, int* w,
                   char* err, int errlen) {
    jpeg_decompress_struct cinfo;
    ErrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = err_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        set_err(err, errlen, jerr.msg);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    *h = static_cast<int>(cinfo.image_height);
    *w = static_cast<int>(cinfo.image_width);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// decode one JPEG onto (th, tw) into out; dims <- (src_h, src_w, th, tw)
int mtlx_jpeg_decode(const unsigned char* data, size_t len, int th, int tw,
                     int legacy, unsigned char* out, size_t out_cap, int* dims,
                     char* err, int errlen) {
    std::string msg;
    if (!decode_impl(data, len, th, tw, out, out_cap, dims, msg, legacy)) {
        set_err(err, errlen, msg);
        return 1;
    }
    return 0;
}

// decode one JPEG at its own (h, w) = (th, tw) as TensorFlow's decode_jpeg
// does by default (the fast integer inverse DCT, fancy upsampling), into
// out; dims <- (h, w, h, w)
int mtlx_jpeg_decode_tf(const unsigned char* data, size_t len, int th, int tw,
                        unsigned char* out, size_t out_cap, int* dims,
                        char* err, int errlen) {
    std::string msg;
    if (!decode_impl(data, len, th, tw, out, out_cap, dims, msg, 1, true)) {
        set_err(err, errlen, msg);
        return 1;
    }
    if (dims[0] != th || dims[1] != tw) {
        set_err(err, errlen, "the JPEG is not " + std::to_string(th) + "x" + std::to_string(tw));
        return 1;
    }
    return 0;
}

// decode n JPEGs on a pool of `threads`; dims holds 4 ints per image.
// Returns 0, or 1 + the index of the first image that failed.
int mtlx_jpeg_decode_batch(int n, const unsigned char* const* datas,
                           const size_t* lens, const int* ths, const int* tws,
                           int legacy, unsigned char* const* outs,
                           const size_t* caps, int* dims, int threads,
                           char* err, int errlen) {
    std::vector<std::string> errs(static_cast<size_t>(n));
    std::vector<char> ok(static_cast<size_t>(n), 0);
    std::atomic<int> next(0);
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n) break;
            ok[i] = decode_impl(datas[i], lens[i], ths[i], tws[i], outs[i], caps[i],
                                dims + 4 * i, errs[i], legacy);
        }
    };
    if (threads > n) threads = n;
    if (threads <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; t++) pool.emplace_back(worker);
        for (auto& t : pool) t.join();
    }
    for (int i = 0; i < n; i++) {
        if (!ok[i]) {
            set_err(err, errlen, errs[i]);
            return 1 + i;
        }
    }
    return 0;
}

}  // extern "C"
