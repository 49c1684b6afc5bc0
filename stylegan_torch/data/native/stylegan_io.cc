// Native data-loader core: JPEG/PNG decode + flip + PIL-compatible bilinear
// (triangle-filter) resize + [-1,1] normalization, in one pass per image.
//
// The port's copy of stylegan_tpu/data/native/stylegan_io.cc (unchanged
// below this header).  Replaces the Python/PIL decode path of the reference
// pipeline (reference data/datasets.py:61-85 + transforms.py:11-33) for
// throughput: the loader's threads decode while the GPU computes, with no GIL
// contention (ctypes releases the GIL for the call's duration).
//
// Exposed C ABI (see ../native.py):
//   sgio_decode_resize(data, size, out_res, flip, out_f32_hwc) -> 0 on ok
//
// Built by ../native.py at first use (g++ -O3 -shared -fPIC stylegan_io.cc
// -ljpeg -lpng) into build/stylegan_torch/ at the repository root.

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode JPEG bytes to an RGB8 buffer. Returns true on success.
bool decode_jpeg(const unsigned char* data, size_t size,
                 std::vector<unsigned char>* rgb, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb->resize(static_cast<size_t>(*w) * *h * 3);
  const size_t stride = static_cast<size_t>(*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = rgb->data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Decode PNG bytes to RGB8 (alpha dropped — reference converts to RGB).
bool decode_png(const unsigned char* data, size_t size,
                std::vector<unsigned char>* rgb, int* w, int* h) {
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, data, size)) return false;
  image.format = PNG_FORMAT_RGB;
  *w = image.width;
  *h = image.height;
  rgb->resize(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, rgb->data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  return true;
}

// PIL-style separable triangle-filter resampling coefficients: for each
// output index, the contributing input range and normalized weights
// (Pillow's ImagingResampleHorizontal, BILINEAR filter, support=1).
struct ResampleCoeffs {
  std::vector<int> bounds_lo;     // first input index per output px
  std::vector<int> counts;        // number of taps per output px
  std::vector<double> weights;    // taps, row-major [out][k]
  int kmax;
};

ResampleCoeffs compute_coeffs(int in_size, int out_size) {
  ResampleCoeffs rc;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;  // bilinear support = 1
  rc.kmax = static_cast<int>(std::ceil(support)) * 2 + 1;
  rc.bounds_lo.resize(out_size);
  rc.counts.resize(out_size);
  rc.weights.assign(static_cast<size_t>(out_size) * rc.kmax, 0.0);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = static_cast<int>(center - support + 0.5);
    int hi = static_cast<int>(center + support + 0.5);
    lo = std::max(lo, 0);
    hi = std::min(hi, in_size);
    double total = 0.0;
    for (int j = lo; j < hi; ++j) {
      double x = std::abs((j - center + 0.5) / filterscale);
      double wgt = (x < 1.0) ? 1.0 - x : 0.0;  // triangle
      rc.weights[static_cast<size_t>(i) * rc.kmax + (j - lo)] = wgt;
      total += wgt;
    }
    if (total > 0) {
      for (int k = 0; k < hi - lo; ++k)
        rc.weights[static_cast<size_t>(i) * rc.kmax + k] /= total;
    }
    rc.bounds_lo[i] = lo;
    rc.counts[i] = hi - lo;
  }
  return rc;
}

}  // namespace

extern "C" {

// data/size: encoded image bytes (JPEG or PNG, sniffed by magic).
// out: float32 buffer of out_res*out_res*3, HWC, values in [-1, 1].
// flip: mirror horizontally before resize (RandomHorizontalFlip semantics).
// Returns 0 on success, nonzero error code otherwise.
int sgio_decode_resize(const unsigned char* data, long size, int out_res,
                       int flip, float* out) {
  if (size < 8) return 1;
  std::vector<unsigned char> rgb;
  int w = 0, h = 0;
  bool ok = false;
  if (data[0] == 0xFF && data[1] == 0xD8) {
    ok = decode_jpeg(data, static_cast<size_t>(size), &rgb, &w, &h);
  } else if (data[0] == 0x89 && data[1] == 0x50) {
    ok = decode_png(data, static_cast<size_t>(size), &rgb, &w, &h);
  } else {
    return 2;  // unsupported format
  }
  if (!ok || w <= 0 || h <= 0) return 3;

  if (flip) {
    const size_t stride = static_cast<size_t>(w) * 3;
    for (int y = 0; y < h; ++y) {
      unsigned char* row = rgb.data() + y * stride;
      for (int x = 0; x < w / 2; ++x) {
        for (int c = 0; c < 3; ++c)
          std::swap(row[x * 3 + c], row[(w - 1 - x) * 3 + c]);
      }
    }
  }

  // horizontal pass: (h, w, 3) u8 -> (h, out_res, 3) f32
  ResampleCoeffs rh = compute_coeffs(w, out_res);
  std::vector<float> tmp(static_cast<size_t>(h) * out_res * 3);
  for (int y = 0; y < h; ++y) {
    const unsigned char* row = rgb.data() + static_cast<size_t>(y) * w * 3;
    float* orow = tmp.data() + static_cast<size_t>(y) * out_res * 3;
    for (int x = 0; x < out_res; ++x) {
      const int lo = rh.bounds_lo[x];
      const int n = rh.counts[x];
      const double* wv = &rh.weights[static_cast<size_t>(x) * rh.kmax];
      double acc[3] = {0, 0, 0};
      for (int k = 0; k < n; ++k) {
        const unsigned char* px = row + static_cast<size_t>(lo + k) * 3;
        acc[0] += wv[k] * px[0];
        acc[1] += wv[k] * px[1];
        acc[2] += wv[k] * px[2];
      }
      for (int c = 0; c < 3; ++c)
        orow[x * 3 + c] = static_cast<float>(acc[c]);
    }
  }

  // vertical pass + normalization: (h, out_res, 3) -> (out_res, out_res, 3)
  ResampleCoeffs rv = compute_coeffs(h, out_res);
  for (int y = 0; y < out_res; ++y) {
    const int lo = rv.bounds_lo[y];
    const int n = rv.counts[y];
    const double* wv = &rv.weights[static_cast<size_t>(y) * rv.kmax];
    float* orow = out + static_cast<size_t>(y) * out_res * 3;
    for (int x = 0; x < out_res * 3; ++x) {
      double acc = 0;
      for (int k = 0; k < n; ++k)
        acc += wv[k] * tmp[static_cast<size_t>(lo + k) * out_res * 3 + x];
      // uint8 rounding like PIL (clip + round), then [-1, 1]
      double v = std::min(255.0, std::max(0.0, acc + 0.5));
      orow[x] = static_cast<float>(
          (static_cast<double>(static_cast<unsigned char>(v)) / 255.0 - 0.5)
          / 0.5);
    }
  }
  return 0;
}

}  // extern "C"
