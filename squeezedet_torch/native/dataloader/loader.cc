// Native batch image loader of squeezedet_torch.
//
// The host-side pixel work of the f32 readers (data/imdb.py
// read_image_batch and read_batch_raw_targets): decode, float
// conversion, BGR mean subtraction, the drift crop and horizontal flip,
// and the bilinear resize, on a pool of threads that run without the
// GIL.  The augmentation decisions (dx, dy, flip) are drawn in Python,
// so the sampler's RNG sequence is the reference's; this library only
// moves pixels.
//
// The C ABI is the JAX package's (squeezedet_tpu/native/dataloader/
// loader.cc): sdl_load_image_batch and sdl_load_train_batch.  That
// library links OpenCV; this one needs only zlib, so it builds where
// OpenCV's C++ headers are absent:
//   * the PNG decoder transcribes data/png.py (non-interlaced 8-bit
//     gray, RGB and RGBA, the five row filters, CRC-checked chunks; gray
//     becomes three equal channels, alpha is dropped), which equals
//     cv2.imread bit for bit;
//   * the resize is the bilinear one that cv2.resize(INTER_LINEAR) gives
//     on float images through OpenCV's IPP path (positions in double,
//     border replicate).
// Any other image format fails with kNotPng.
//
// A failed image makes the call return its status and marks the image's
// scale row with -status, so the caller can name the file.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

enum Status { kOk = 0, kUnreadable = 1, kBadDrift = 2, kNotPng = 3 };

struct Job {
  const char* path;
  int dx = 0, dy = 0;  // drift (train only)
  bool flip = false;   // horizontal flip (train only)
};

// A float BGR image [rows][cols][3].
struct Image {
  int rows = 0, cols = 0;
  std::vector<float> px;
  float* at(int y, int x) { return px.data() + (size_t(y) * cols + x) * 3; }
};

bool ReadFile(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return false;
  uint8_t buf[1 << 16];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof(buf), f)) > 0) {
    out->insert(out->end(), buf, buf + n);
  }
  const bool ok = std::ferror(f) == 0;
  std::fclose(f);
  return ok;
}

uint32_t Be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// Undo the per-row filters of `raw` (height rows of 1 + stride bytes)
// into `out` [height][stride] (data/png.py _unfilter).
bool Unfilter(const uint8_t* raw, int height, size_t stride, int bpp,
              uint8_t* out) {
  std::vector<uint8_t> zeros(stride, 0);
  const uint8_t* prev = zeros.data();
  for (int y = 0; y < height; ++y) {
    const uint8_t* line = raw + size_t(y) * (stride + 1);
    const uint8_t kind = line[0];
    ++line;
    uint8_t* row = out + size_t(y) * stride;
    switch (kind) {
      case 0:
        std::memcpy(row, line, stride);
        break;
      case 1:  // Sub
        for (size_t i = 0; i < stride; ++i) {
          row[i] = uint8_t(line[i] + (i >= size_t(bpp) ? row[i - bpp] : 0));
        }
        break;
      case 2:  // Up
        for (size_t i = 0; i < stride; ++i) row[i] = uint8_t(line[i] + prev[i]);
        break;
      case 3:  // Avg
        for (size_t i = 0; i < stride; ++i) {
          const int left = i >= size_t(bpp) ? row[i - bpp] : 0;
          row[i] = uint8_t(line[i] + ((left + prev[i]) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < stride; ++i) {
          int a = 0, c = 0;
          if (i >= size_t(bpp)) {
            a = row[i - bpp];
            c = prev[i - bpp];
          }
          const int b = prev[i];
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          row[i] = uint8_t(line[i] + pred);
        }
        break;
      default:
        return false;
    }
    prev = row;
  }
  return true;
}

// Decode a PNG file's bytes into `im` as float BGR (data/png.py
// imread_png, then astype(float32)).
bool DecodePng(const std::vector<uint8_t>& data, Image* im) {
  static const uint8_t kSignature[8] = {0x89, 'P', 'N', 'G',
                                        '\r', '\n', 0x1a, '\n'};
  if (data.size() < 8 || std::memcmp(data.data(), kSignature, 8) != 0) {
    return false;
  }
  size_t pos = 8;
  bool header = false, iend = false;
  uint32_t width = 0, height = 0;
  int depth = 0, colour = 0, compression = 0, filter = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 12 <= data.size()) {
    const size_t length = Be32(&data[pos]);
    const uint8_t* kind = &data[pos + 4];
    const size_t end = pos + 8 + length;
    if (end + 4 > data.size()) return false;
    const uLong crc = crc32(0L, kind, uInt(4 + length));
    if (crc != Be32(&data[end])) return false;
    const uint8_t* payload = &data[pos + 8];
    if (std::memcmp(kind, "IHDR", 4) == 0) {
      if (length != 13) return false;
      width = Be32(payload);
      height = Be32(payload + 4);
      depth = payload[8];
      colour = payload[9];
      compression = payload[10];
      filter = payload[11];
      interlace = payload[12];
      header = true;
    } else if (std::memcmp(kind, "IDAT", 4) == 0) {
      idat.insert(idat.end(), payload, payload + length);
    } else if (std::memcmp(kind, "IEND", 4) == 0) {
      iend = true;
      break;
    }
    pos = end + 4;
  }
  if (!iend || !header || idat.empty()) return false;
  const int bpp = colour == 0 ? 1 : colour == 2 ? 3 : colour == 6 ? 4 : 0;
  if (depth != 8 || bpp == 0 || compression != 0 || filter != 0 ||
      interlace != 0 || width == 0 || height == 0 || width > (1u << 16) ||
      height > (1u << 16)) {
    return false;
  }
  const size_t stride = size_t(width) * bpp;
  const size_t expected = size_t(height) * (stride + 1);
  std::vector<uint8_t> raw(expected + 1);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = idat.data();
  zs.avail_in = uInt(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = uInt(raw.size());
  const int rc = inflate(&zs, Z_FINISH);
  const size_t produced = zs.total_out;
  inflateEnd(&zs);
  if (rc != Z_STREAM_END || produced != expected) return false;

  std::vector<uint8_t> samples(size_t(height) * stride);
  if (!Unfilter(raw.data(), int(height), stride, bpp, samples.data())) {
    return false;
  }
  im->rows = int(height);
  im->cols = int(width);
  im->px.resize(size_t(height) * width * 3);
  const size_t n = size_t(height) * width;
  for (size_t i = 0; i < n; ++i) {
    const uint8_t* s = &samples[i * bpp];
    float* d = &im->px[i * 3];
    if (bpp == 1) {
      d[0] = d[1] = d[2] = float(s[0]);
    } else {  // RGB(A) -> BGR
      d[0] = float(s[2]);
      d[1] = float(s[1]);
      d[2] = float(s[0]);
    }
  }
  return true;
}

// Per output position along one axis: the first of its two source
// samples and their weights.  Positions are (i + 0.5) * n_src / n_out
// - 0.5 in double, clamped to the source (border replicate).
void Taps(int n_out, int n_src, std::vector<int>* first,
          std::vector<float>* w0, std::vector<float>* w1) {
  first->resize(n_out);
  w0->resize(n_out);
  w1->resize(n_out);
  const double scale = double(n_src) / n_out;
  for (int i = 0; i < n_out; ++i) {
    const double pos =
        std::min(std::max((i + 0.5) * scale - 0.5, 0.0), double(n_src - 1));
    const int s = std::min(int(std::floor(pos)), std::max(n_src - 2, 0));
    const double f = n_src > 1 ? pos - s : 0.0;
    (*first)[i] = s;
    (*w0)[i] = float(1.0 - f);
    (*w1)[i] = float(f);
  }
}

// Bilinear resize of a 3-channel float image into `dst` [dh][dw][3], as
// cv2.resize(INTER_LINEAR) computes it on the hosts the port runs on
// (OpenCV's IPP path: exact positions, within ~3e-5 of a float64
// bilinear at KITTI's sizes): each source row horizontally, then rows.
void Resize(Image& src, int dw, int dh, float* dst) {
  const int sw = src.cols, sh = src.rows;
  std::vector<int> xs, ys;
  std::vector<float> ax0, ax1, ay0, ay1;
  Taps(dw, sw, &xs, &ax0, &ax1);
  Taps(dh, sh, &ys, &ay0, &ay1);
  const int next_x = sw > 1 ? 3 : 0;
  std::vector<float> hrows(size_t(sh) * dw * 3);
  std::vector<char> done(sh, 0);
  auto hrow = [&](int sy) -> const float* {
    float* out = &hrows[size_t(sy) * dw * 3];
    if (!done[sy]) {
      const float* row = src.at(sy, 0);
      for (int x = 0; x < dw; ++x) {
        const float* p = row + 3 * xs[x];
        for (int k = 0; k < 3; ++k) {
          out[3 * x + k] = p[k] * ax0[x] + p[k + next_x] * ax1[x];
        }
      }
      done[sy] = 1;
    }
    return out;
  };
  for (int y = 0; y < dh; ++y) {
    const float* s0 = hrow(ys[y]);
    const float* s1 = hrow(std::min(ys[y] + 1, sh - 1));
    float* d = dst + size_t(y) * dw * 3;
    for (int i = 0; i < dw * 3; ++i) d[i] = s0[i] * ay0[y] + s1[i] * ay1[y];
  }
}

// Decode and preprocess one image into `out` (out_h * out_w * 3 f32,
// BGR); scale_xy gets (x_scale, y_scale) relative to the post-drift
// size, as the Python reader computes them.
int ProcessOne(const Job& job, bool augment, int out_w, int out_h,
               const float* means, float* out, float* scale_xy) {
  std::vector<uint8_t> bytes;
  if (!ReadFile(job.path, &bytes)) return kUnreadable;
  Image im;
  if (!DecodePng(bytes, &im)) return kNotPng;
  for (size_t i = 0; i < im.px.size(); i += 3) {
    im.px[i] -= means[0];
    im.px[i + 1] -= means[1];
    im.px[i + 2] -= means[2];
  }
  if (augment && (job.dx != 0 || job.dy != 0)) {
    // the zero-padded drift crop (data/imdb.py _augment): the canvas is
    // (rows - dy, cols - dx); the source from (max(dy, 0), max(dx, 0))
    // lands at (max(-dy, 0), max(-dx, 0))
    const int new_h = im.rows - job.dy, new_w = im.cols - job.dx;
    if (new_h <= 0 || new_w <= 0) return kBadDrift;
    Image canvas;
    canvas.rows = new_h;
    canvas.cols = new_w;
    canvas.px.assign(size_t(new_h) * new_w * 3, 0.f);
    const int src_y = std::max(job.dy, 0), dst_y = std::max(-job.dy, 0);
    const int src_x = std::max(job.dx, 0), dst_x = std::max(-job.dx, 0);
    const int copy_h = std::min(im.rows - src_y, new_h - dst_y);
    const int copy_w = std::min(im.cols - src_x, new_w - dst_x);
    for (int y = 0; y < copy_h; ++y) {
      std::memcpy(canvas.at(dst_y + y, dst_x), im.at(src_y + y, src_x),
                  sizeof(float) * 3 * std::max(copy_w, 0));
    }
    im = std::move(canvas);
  }
  if (augment && job.flip) {
    for (int y = 0; y < im.rows; ++y) {
      for (int l = 0, r = im.cols - 1; l < r; ++l, --r) {
        std::swap_ranges(im.at(y, l), im.at(y, l) + 3, im.at(y, r));
      }
    }
  }
  scale_xy[0] = float(out_w) / im.cols;
  scale_xy[1] = float(out_h) / im.rows;
  Resize(im, out_w, out_h, out);
  return kOk;
}

int RunBatch(const std::vector<Job>& jobs, bool augment, int out_w,
             int out_h, const float* means, int num_threads,
             float* out_images, float* out_scales) {
  const int n = int(jobs.size());
  std::atomic<int> next(0);
  std::atomic<int> status(kOk);
  const size_t stride = size_t(out_w) * out_h * 3;
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      const int rc = ProcessOne(jobs[i], augment, out_w, out_h, means,
                                out_images + stride * i, out_scales + 2 * i);
      if (rc != kOk) {
        out_scales[2 * i] = out_scales[2 * i + 1] = -float(rc);
        status.store(rc);
      }
    }
  };
  const int t = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return status.load();
}

}  // namespace

extern "C" {

// Eval reader (Imdb.read_image_batch): decode, -means, resize.
int sdl_load_image_batch(const char** paths, int n, int out_w, int out_h,
                         const float* bgr_means, int num_threads,
                         float* out_images, float* out_scales) {
  std::vector<Job> jobs(n);
  for (int i = 0; i < n; ++i) jobs[i].path = paths[i];
  return RunBatch(jobs, false, out_w, out_h, bgr_means, num_threads,
                  out_images, out_scales);
}

// Train reader: the same plus each image's drift crop and flip, with the
// decisions (drift[2*i], drift[2*i+1], flip[i]) made by the caller.
int sdl_load_train_batch(const char** paths, int n, int out_w, int out_h,
                         const float* bgr_means, const float* drift,
                         const unsigned char* flip, int num_threads,
                         float* out_images, float* out_scales) {
  std::vector<Job> jobs(n);
  for (int i = 0; i < n; ++i) {
    jobs[i].path = paths[i];
    jobs[i].dx = int(drift[2 * i]);
    jobs[i].dy = int(drift[2 * i + 1]);
    jobs[i].flip = flip[i] != 0;
  }
  return RunBatch(jobs, true, out_w, out_h, bgr_means, num_threads,
                  out_images, out_scales);
}

}  // extern "C"
