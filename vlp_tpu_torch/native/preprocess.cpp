// Native host-side deterministic image preprocessing (the port's own copy
// of vlp_tpu/native/preprocess.cpp: the same code, so the two packages'
// libraries give the same bytes and their image caches are interchangeable).
//
// C++ implementation of the pipeline in vlp_tpu_torch/data/preprocess_host.py
// (itself matching the reference's MONAI chain, reference
// DownstreamDataModule.py:152-180):
//   grayscale(luma) -> histogram equalization (256 bins, cumulative
//   rescale, linear interp at bin centers) -> optional symmetric crop of
//   the larger dim (<= max_ratio, never past square, crop//2 per side) ->
//   edge-average pad to square -> area resize -> round to uint8.
//
// A self-contained library (no OpenCV dependency) with a std::thread pool
// for batch cache building, bound to Python via ctypes and built with g++
// at first use (vlp_tpu_torch/native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Luma grayscale (ITU-R 601, matching torchvision Grayscale).
void to_gray(const uint8_t* img, int h, int w, int c, float* out) {
  const int n = h * w;
  if (c == 1) {
    for (int i = 0; i < n; ++i) out[i] = static_cast<float>(img[i]);
    return;
  }
  for (int i = 0; i < n; ++i) {
    const uint8_t* p = img + i * c;  // RGB interleaved
    out[i] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
  }
}

// MONAI HistogramNormalized semantics (see preprocess_host.equalize_hist):
// histogram over [min,max] with 256 uniform bins, cumulative sum rescaled
// to [0,255], pixel values linearly interpolated against bin centers.
void equalize_hist(float* img, int n) {
  float lo = img[0], hi = img[0];
  for (int i = 1; i < n; ++i) {
    lo = std::min(lo, img[i]);
    hi = std::max(hi, img[i]);
  }
  constexpr int kBins = 256;
  if (hi <= lo) {  // constant image
    for (int i = 0; i < n; ++i) img[i] = 0.0f;
    return;
  }
  double counts[kBins] = {0};
  const double scale = kBins / (double(hi) - double(lo));
  for (int i = 0; i < n; ++i) {
    int b = static_cast<int>((double(img[i]) - lo) * scale);
    if (b >= kBins) b = kBins - 1;  // x == max goes to the last bin
    if (b < 0) b = 0;
    counts[b] += 1.0;
  }
  double centers[kBins], cum[kBins];
  const double width = (double(hi) - double(lo)) / kBins;
  double run = 0.0;
  for (int b = 0; b < kBins; ++b) {
    centers[b] = lo + width * (b + 0.5);
    run += counts[b];
    cum[b] = run;
  }
  const double cmin = cum[0], cmax = cum[kBins - 1];
  for (int b = 0; b < kBins; ++b) {
    cum[b] = (cmax > cmin) ? (cum[b] - cmin) / (cmax - cmin) * 255.0 : 0.0;
  }
  // np.interp against bin centers: clamp outside, linear inside.
  for (int i = 0; i < n; ++i) {
    const double x = img[i];
    if (x <= centers[0]) {
      img[i] = static_cast<float>(cum[0]);
    } else if (x >= centers[kBins - 1]) {
      img[i] = static_cast<float>(cum[kBins - 1]);
    } else {
      int b = static_cast<int>((x - centers[0]) / width);
      if (b >= kBins - 1) b = kBins - 2;
      // centers are uniform; adjust if rounding put us off by one
      while (centers[b + 1] < x) ++b;
      while (centers[b] > x) --b;
      const double t = (x - centers[b]) / (centers[b + 1] - centers[b]);
      img[i] = static_cast<float>(cum[b] + t * (cum[b + 1] - cum[b]));
    }
  }
}

// Symmetric crop of the larger dim (reference CropLargerDimension.py:40-53):
// crop = int(dim * ratio), clamped so the result never drops below the
// smaller dim; crop//2 removed from EACH side (odd crops keep a pixel).
void crop_larger(const float* in, int h, int w, float ratio, float* out,
                 int* oh, int* ow) {
  int top = 0, left = 0, nh = h, nw = w;
  if (h > w) {
    int crop = static_cast<int>(h * ratio);
    if (h - crop < w) crop = h - w;
    top = crop / 2;
    nh = h - 2 * (crop / 2);
  } else if (w > h) {
    int crop = static_cast<int>(w * ratio);
    if (w - crop < h) crop = w - h;
    left = crop / 2;
    nw = w - 2 * (crop / 2);
  }
  for (int y = 0; y < nh; ++y)
    std::memcpy(out + y * nw, in + (y + top) * w + left, nw * sizeof(float));
  *oh = nh;
  *ow = nw;
}

// Edge-average pad to square (reference PadToSquaredEdgeAverage.py:40-76):
// pad shorter dim; fill = mean of nearest edge row/col, distinct per side;
// diff//2 before, rest after.
void pad_square(const float* in, int h, int w, float* out, int* osz) {
  const int s = std::max(h, w);
  *osz = s;
  if (h == w) {
    std::memcpy(out, in, size_t(h) * w * sizeof(float));
    return;
  }
  if (h > w) {  // pad width
    const int left = (h - w) / 2;
    double lsum = 0, rsum = 0;
    for (int y = 0; y < h; ++y) {
      lsum += in[y * w];
      rsum += in[y * w + w - 1];
    }
    const float lval = static_cast<float>(lsum / h);
    const float rval = static_cast<float>(rsum / h);
    for (int y = 0; y < s; ++y) {
      float* row = out + y * s;
      for (int x = 0; x < left; ++x) row[x] = lval;
      std::memcpy(row + left, in + y * w, w * sizeof(float));
      for (int x = left + w; x < s; ++x) row[x] = rval;
    }
  } else {  // pad height
    const int top = (w - h) / 2;
    double tsum = 0, bsum = 0;
    for (int x = 0; x < w; ++x) {
      tsum += in[x];
      bsum += in[(h - 1) * w + x];
    }
    const float tval = static_cast<float>(tsum / w);
    const float bval = static_cast<float>(bsum / w);
    for (int y = 0; y < top; ++y)
      for (int x = 0; x < s; ++x) out[y * s + x] = tval;
    std::memcpy(out + size_t(top) * s, in, size_t(h) * w * sizeof(float));
    for (int y = top + h; y < s; ++y)
      for (int x = 0; x < s; ++x) out[y * s + x] = bval;
  }
}

// Pixel-area-relation resize (cv2 INTER_AREA semantics for true area
// averaging): each output pixel integrates the source rectangle it covers
// with fractional edge weights. Exact for both down- and up-scaling of the
// box filter; matches cv2 INTER_AREA on downscale within rounding.
void resize_area(const float* in, int ih, int iw, float* out, int oh, int ow) {
  if (ih == oh && iw == ow) {
    std::memcpy(out, in, size_t(ih) * iw * sizeof(float));
    return;
  }
  const double sy = double(ih) / oh, sx = double(iw) / ow;
  std::vector<double> rowacc(iw);
  for (int oy = 0; oy < oh; ++oy) {
    const double y0 = oy * sy, y1 = (oy + 1) * sy;
    const int iy0 = static_cast<int>(y0);
    const int iy1 = std::min(static_cast<int>(std::ceil(y1)), ih);
    std::fill(rowacc.begin(), rowacc.end(), 0.0);
    double ywsum = 0.0;
    for (int iy = iy0; iy < iy1; ++iy) {
      const double wy = std::min<double>(iy + 1, y1) - std::max<double>(iy, y0);
      ywsum += wy;
      const float* row = in + size_t(iy) * iw;
      for (int x = 0; x < iw; ++x) rowacc[x] += wy * row[x];
    }
    for (int ox = 0; ox < ow; ++ox) {
      const double x0 = ox * sx, x1 = (ox + 1) * sx;
      const int ix0 = static_cast<int>(x0);
      const int ix1 = std::min(static_cast<int>(std::ceil(x1)), iw);
      double acc = 0.0, xwsum = 0.0;
      for (int ix = ix0; ix < ix1; ++ix) {
        const double wx =
            std::min<double>(ix + 1, x1) - std::max<double>(ix, x0);
        acc += wx * rowacc[ix];
        xwsum += wx;
      }
      out[size_t(oy) * ow + ox] = static_cast<float>(acc / (xwsum * ywsum));
    }
  }
}

}  // namespace

extern "C" {

// Full pipeline for one image. img: HWC uint8 (c in {1,3}); out: SxS uint8.
// Scratch-free for callers; allocates internally.
void vlp_preprocess_image(const uint8_t* img, int h, int w, int c,
                          int out_size, int do_crop, float max_crop_ratio,
                          int do_equalize, uint8_t* out) {
  std::vector<float> gray(size_t(h) * w);
  to_gray(img, h, w, c, gray.data());
  if (do_equalize) equalize_hist(gray.data(), h * w);
  std::vector<float> cropped(size_t(h) * w);
  int ch = h, cw = w;
  const float* src = gray.data();
  if (do_crop) {
    crop_larger(gray.data(), h, w, max_crop_ratio, cropped.data(), &ch, &cw);
    src = cropped.data();
  }
  const int s = std::max(ch, cw);
  std::vector<float> squared(size_t(s) * s);
  int osz = s;
  pad_square(src, ch, cw, squared.data(), &osz);
  std::vector<float> resized(size_t(out_size) * out_size);
  resize_area(squared.data(), osz, osz, resized.data(), out_size, out_size);
  for (int i = 0; i < out_size * out_size; ++i) {
    float v = std::nearbyint(resized[i]);
    out[i] = static_cast<uint8_t>(std::min(255.0f, std::max(0.0f, v)));
  }
}

// Thread-pooled batch variant over images of uniform shape [n, h, w, c].
void vlp_preprocess_batch(const uint8_t* imgs, int n, int h, int w, int c,
                          int out_size, int do_crop, float max_crop_ratio,
                          int do_equalize, uint8_t* out, int num_threads) {
  if (num_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i)
      vlp_preprocess_image(imgs + size_t(i) * h * w * c, h, w, c, out_size,
                           do_crop, max_crop_ratio, do_equalize,
                           out + size_t(i) * out_size * out_size);
    return;
  }
  std::atomic<int> next(0);
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      vlp_preprocess_image(imgs + size_t(i) * h * w * c, h, w, c, out_size,
                           do_crop, max_crop_ratio, do_equalize,
                           out + size_t(i) * out_size * out_size);
    }
  };
  std::vector<std::thread> pool;
  const int t = std::min(num_threads, n);
  pool.reserve(t);
  for (int k = 0; k < t; ++k) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
