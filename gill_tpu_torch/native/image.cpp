// Native image engine for the data pipeline: JPEG/PNG decode + PIL-matching
// bicubic resize (shortest side), center crop, and CLIP normalization in one
// pass, without the Python/PIL object churn that bottlenecks CC3M-scale
// loading on few-core hosts (reference loads via PIL in gill/data.py:108).
//
// Resize matches PIL.Image.resize(..., BICUBIC) semantics: Keys cubic
// (a = -0.5, support 2) with the kernel scaled by the downsampling factor
// (PIL antialiases by default), separable H-then-V passes in float32.
// PIL's uint8 path uses 8-bit fixed point, so outputs differ by O(1/255).
//
// C ABI (ctypes):
//   gill_image_decode_preprocess(data, len, out_size, mean3, std3, out)
//     -> 0 on success; out is float32[out_size * out_size * 3] HWC.
//   gill_image_probe(data, len, &w, &h) -> format code or -1.

#include <cstdio>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------------------
// decoding
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* rgb,
                 int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb->resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = reinterpret_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->len) {
    png_error(png, "eof");
    return;
  }
  memcpy(out, s->data + s->pos, n);
  s->pos += n;
}

bool decode_png(const uint8_t* data, size_t len, std::vector<uint8_t>* rgb,
                int* w, int* h) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState st{data, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);
  png_uint_32 pw, ph;
  int depth, color;
  png_get_IHDR(png, info, &pw, &ph, &depth, &color, nullptr, nullptr, nullptr);
  // normalize every variant to 8-bit RGB
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  *w = static_cast<int>(pw);
  *h = static_cast<int>(ph);
  rgb->resize(static_cast<size_t>(*w) * *h * 3);
  std::vector<png_bytep> rows(ph);
  for (png_uint_32 y = 0; y < ph; ++y)
    rows[y] = rgb->data() + static_cast<size_t>(y) * *w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ---------------------------------------------------------------------------
// PIL-matching bicubic resample (Keys a=-0.5, kernel scaled when minifying)
// ---------------------------------------------------------------------------

double cubic(double x) {
  const double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Precompute, per output pixel, the source window [xmin, xmin+n) and
// normalized weights — PIL ImagingPrecomputeCoeffs semantics.
void precompute(int in_size, int out_size, std::vector<int>* bounds,
                std::vector<double>* weights, int* ksize) {
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 2.0 * filterscale;
  *ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds->resize(2 * out_size);
  weights->assign(static_cast<size_t>(out_size) * *ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = weights->data() + static_cast<size_t>(xx) * *ksize;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      double wgt = cubic((x + xmin - center + 0.5) / filterscale);
      k[x] = wgt;
      ww += wgt;
    }
    if (ww != 0.0)
      for (int x = 0; x < xmax; ++x) k[x] /= ww;
    (*bounds)[2 * xx] = xmin;
    (*bounds)[2 * xx + 1] = xmax;
  }
}

// PIL's uint8 path rounds AND clips to uint8 between the horizontal and
// vertical passes (ImagingResampleHorizontal_8bpc) — replicate that
// intermediate quantization so outputs match PIL within its fixed-point
// rounding (~1/255 per pass).
inline uint8_t clip8(double v) {
  double r = std::floor(v + 0.5);
  if (r < 0.0) return 0;
  if (r > 255.0) return 255;
  return static_cast<uint8_t>(r);
}

// separable resize of HWC uint8 -> uint8 (PIL-matching)
void resize_bicubic(const uint8_t* in, int iw, int ih, uint8_t* out, int ow,
                    int oh) {
  std::vector<int> xb, yb;
  std::vector<double> xw, yw;
  int xk, yk;
  precompute(iw, ow, &xb, &xw, &xk);
  precompute(ih, oh, &yb, &yw, &yk);

  // horizontal pass: (ih, iw) -> (ih, ow), quantized like PIL
  std::vector<uint8_t> tmp(static_cast<size_t>(ih) * ow * 3);
  for (int y = 0; y < ih; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * iw * 3;
    uint8_t* trow = tmp.data() + static_cast<size_t>(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      int xmin = xb[2 * x], n = xb[2 * x + 1];
      const double* k = xw.data() + static_cast<size_t>(x) * xk;
      double acc[3] = {0, 0, 0};
      for (int i = 0; i < n; ++i) {
        const uint8_t* px = row + static_cast<size_t>(xmin + i) * 3;
        acc[0] += px[0] * k[i];
        acc[1] += px[1] * k[i];
        acc[2] += px[2] * k[i];
      }
      trow[x * 3 + 0] = clip8(acc[0]);
      trow[x * 3 + 1] = clip8(acc[1]);
      trow[x * 3 + 2] = clip8(acc[2]);
    }
  }
  // vertical pass: (ih, ow) -> (oh, ow)
  for (int y = 0; y < oh; ++y) {
    int ymin = yb[2 * y], n = yb[2 * y + 1];
    const double* k = yw.data() + static_cast<size_t>(y) * yk;
    uint8_t* orow = out + static_cast<size_t>(y) * ow * 3;
    for (int x = 0; x < ow * 3; ++x) {
      double acc = 0.0;
      for (int i = 0; i < n; ++i)
        acc += tmp[static_cast<size_t>(ymin + i) * ow * 3 + x] * k[i];
      orow[x] = clip8(acc);
    }
  }
}

}  // namespace

extern "C" {

// Probe: returns 1 (jpeg), 2 (png) and fills w/h without full decode; -1
// when unrecognized.
int gill_image_probe(const uint8_t* data, long len) {
  if (len >= 3 && data[0] == 0xFF && data[1] == 0xD8) return 1;
  if (len >= 8 && !png_sig_cmp(data, 0, 8)) return 2;
  return -1;
}

// Decode + shortest-side bicubic resize + center crop to (out_size,
// out_size) + (x/255 - mean)/std. Returns 0 on success.
int gill_image_decode_preprocess(const uint8_t* data, long len, int out_size,
                                 const float* mean, const float* stddev,
                                 float* out) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  bool ok = false;
  if (gill_image_probe(data, len) == 1)
    ok = decode_jpeg(data, static_cast<size_t>(len), &rgb, &w, &h);
  else if (gill_image_probe(data, len) == 2)
    ok = decode_png(data, static_cast<size_t>(len), &rgb, &w, &h);
  if (!ok || w <= 0 || h <= 0) return 1;

  // Python round() is round-half-to-even — match it exactly so the
  // resized dims (and therefore the crop window) equal the PIL path's.
  auto py_round = [](double v) -> int {
    double fl = std::floor(v);
    double diff = v - fl;
    if (diff > 0.5) return static_cast<int>(fl) + 1;
    if (diff < 0.5) return static_cast<int>(fl);
    long f = static_cast<long>(fl);
    return static_cast<int>((f % 2 == 0) ? f : f + 1);
  };
  int short_side = w < h ? w : h;
  int nw = py_round(static_cast<double>(w) * out_size / short_side);
  int nh = py_round(static_cast<double>(h) * out_size / short_side);
  std::vector<uint8_t> resized(static_cast<size_t>(nw) * nh * 3);
  resize_bicubic(rgb.data(), w, h, resized.data(), nw, nh);

  int left = (nw - out_size) / 2;
  int top = (nh - out_size) / 2;
  for (int y = 0; y < out_size; ++y) {
    const uint8_t* src = resized.data() +
        (static_cast<size_t>(y + top) * nw + left) * 3;
    float* dst = out + static_cast<size_t>(y) * out_size * 3;
    for (int x = 0; x < out_size; ++x) {
      for (int c = 0; c < 3; ++c) {
        float v = src[x * 3 + c] / 255.0f;
        dst[x * 3 + c] = (v - mean[c]) / stddev[c];
      }
    }
  }
  return 0;
}

}  // extern "C"
