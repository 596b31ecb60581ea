// frameio.cpp: the host library of the port's frame loader.
//
// PNG unfiltering and the loader's resizes in compiled code, behind a plain
// C interface that gradslam_torch/datasets/frameio.py binds with ctypes.
// The caller reads the file, checks the chunks and inflates IDAT (Python's
// zlib, which releases the interpreter lock); the library takes the
// inflated bytes, the IHDR fields and the PLTE entries, and
//
//   - unfilters every row (filter types 0-4, bpp = max(1, samples * depth /
//     8)), each Adam7 pass as an image of its own scattered into the grid;
//   - unpacks sub-byte samples most significant bits first, scales grey
//     below 8 bits by 255 / (2^d - 1), looks palette indices up in PLTE
//     (an index past it reads black), turns 16-bit samples from big-endian
//     to native order and strips the alpha channel;
//   - resizes colour bilinearly at cv2's sample positions and depth by the
//     nearest sample times 1 / depth_scale, with the operations of the JAX
//     package's native library (native/frameio/frameio.cpp:134-190) in the
//     same order.
//
// Every entry point is reentrant: the Python threads of FrameLoader call
// them at once. Built with -ffp-contract=off (and no -march or
// -ffast-math), so no multiply-add is fused and each float operation rounds
// as the numpy version of the same arithmetic does.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kBadFilter = -1;  // a row filter byte above 4 (info[0]: the pass's largest)
constexpr int kBadSize = -2;    // the inflated size does not match the header
constexpr int kBadFormat = -3;  // a colour type / bit depth pair PNG does not define
constexpr int kEmpty = -4;      // an image without pixels, which has nothing to resize

// Adam7 passes: x0, y0, dx, dy
constexpr int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                              {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

// Samples a pixel in the file, and channels kept after the alpha is stripped
// (palette indices become RGB).
int file_samples(int color) {
  switch (color) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

int kept_channels(int color) { return color == 2 || color == 3 || color == 6 ? 3 : 1; }

bool defined_format(int color, int depth) {
  switch (color) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

struct Header {
  int64_t width, height;
  int depth, color, interlace;
};

struct Pass {
  int x0, y0, dx, dy;
  int64_t w, h;
};

// The non-empty passes: the whole image, or Adam7's seven.
std::vector<Pass> passes_of(const Header& hd) {
  std::vector<Pass> out;
  const int n = hd.interlace == 1 ? 7 : 1;
  for (int p = 0; p < n; p++) {
    const int x0 = n == 1 ? 0 : kAdam7[p][0], y0 = n == 1 ? 0 : kAdam7[p][1];
    const int dx = n == 1 ? 1 : kAdam7[p][2], dy = n == 1 ? 1 : kAdam7[p][3];
    const int64_t w = hd.width > x0 ? (hd.width - x0 + dx - 1) / dx : 0;
    const int64_t h = hd.height > y0 ? (hd.height - y0 + dy - 1) / dy : 0;
    if (w > 0 && h > 0) out.push_back({x0, y0, dx, dy, w, h});
  }
  return out;
}

// Bytes of one unfiltered row (the filter-type byte not counted).
int64_t row_bytes(int64_t w, int depth, int samples) { return (w * samples * depth + 7) / 8; }

uint8_t paeth(int a, int b, int c) {
  const int pa = b > c ? b - c : c - b;
  const int pb = a > c ? a - c : c - a;
  const int s = a + b - 2 * c;
  const int pc = s < 0 ? -s : s;
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

// Unfilter one pass: `raw` holds h rows of 1 + stride bytes (the filter type
// first); `rows` receives h rows of stride bytes.
int unfilter(const uint8_t* raw, int64_t h, int64_t stride, int bpp, uint8_t* rows,
             int64_t* info) {
  int most = 0;
  for (int64_t y = 0; y < h; y++) {
    const int type = raw[y * (stride + 1)];
    most = type > most ? type : most;
  }
  if (most > 4) {
    info[0] = most;
    return kBadFilter;
  }
  const std::vector<uint8_t> zeros(stride, 0);
  for (int64_t y = 0; y < h; y++) {
    const uint8_t* f = raw + y * (stride + 1) + 1;
    const uint8_t* up = y > 0 ? rows + (y - 1) * stride : zeros.data();
    uint8_t* o = rows + y * stride;
    const int64_t lead = bpp < stride ? bpp : stride;
    switch (raw[y * (stride + 1)]) {
      case 0:
        std::memcpy(o, f, stride);
        break;
      case 1:
        for (int64_t i = 0; i < lead; i++) o[i] = f[i];
        for (int64_t i = bpp; i < stride; i++) o[i] = (uint8_t)(f[i] + o[i - bpp]);
        break;
      case 2:
        for (int64_t i = 0; i < stride; i++) o[i] = (uint8_t)(f[i] + up[i]);
        break;
      case 3:
        for (int64_t i = 0; i < lead; i++) o[i] = (uint8_t)(f[i] + (up[i] >> 1));
        for (int64_t i = bpp; i < stride; i++)
          o[i] = (uint8_t)(f[i] + ((o[i - bpp] + up[i]) >> 1));
        break;
      default:
        for (int64_t i = 0; i < lead; i++) o[i] = (uint8_t)(f[i] + paeth(0, up[i], 0));
        for (int64_t i = bpp; i < stride; i++)
          o[i] = (uint8_t)(f[i] + paeth(o[i - bpp], up[i], up[i - bpp]));
        break;
    }
  }
  return kOk;
}

// A decoded image as the JAX package's native library holds one: row-major
// samples, `channels` a pixel, 16-bit samples as two little-endian bytes.
struct Image {
  int64_t width = 0, height = 0;
  int channels = 0;
  bool is16 = false;
  std::vector<uint8_t> data;
};

int decode(const uint8_t* raw, int64_t raw_size, const Header& hd, const uint8_t* palette,
           int palette_entries, Image* img, int64_t* info) {
  if (!defined_format(hd.color, hd.depth) || hd.width < 0 || hd.height < 0 ||
      (hd.interlace != 0 && hd.interlace != 1))
    return kBadFormat;
  const int samples = file_samples(hd.color);
  const int kept = kept_channels(hd.color);
  const int depth = hd.depth;
  const std::vector<Pass> passes = passes_of(hd);
  int64_t want = 0;
  for (const Pass& p : passes) want += p.h * (row_bytes(p.w, depth, samples) + 1);
  if (raw_size != want) return kBadSize;

  img->width = hd.width;
  img->height = hd.height;
  img->channels = kept;
  img->is16 = depth == 16;
  const int sample_bytes = img->is16 ? 2 : 1;
  img->data.assign((size_t)(hd.width * hd.height * kept * sample_bytes), 0);
  uint8_t table[256][3] = {};
  const int entries = palette_entries < 256 ? palette_entries : 256;
  for (int i = 0; i < entries; i++)
    for (int k = 0; k < 3; k++) table[i][k] = palette[3 * i + k];
  const int mask = (1 << (depth < 8 ? depth : 8)) - 1;
  const int grey_scale = depth < 8 ? 255 / mask : 1;
  const int per_byte = depth < 8 ? 8 / depth : 1;

  const int bpp = samples * depth / 8 > 1 ? samples * depth / 8 : 1;
  std::vector<uint8_t> rows;
  const uint8_t* at = raw;
  for (const Pass& p : passes) {
    const int64_t stride = row_bytes(p.w, depth, samples);
    rows.resize((size_t)(p.h * stride));
    const int code = unfilter(at, p.h, stride, bpp, rows.data(), info);
    if (code != kOk) return code;
    at += p.h * (stride + 1);
    for (int64_t j = 0; j < p.h; j++) {
      const uint8_t* row = rows.data() + j * stride;
      const int64_t y = p.y0 + j * p.dy;
      for (int64_t i = 0; i < p.w; i++) {
        uint8_t* px = img->data.data() + ((y * hd.width + p.x0 + i * p.dx) * kept) * sample_bytes;
        if (depth == 16) {
          for (int s = 0; s < kept; s++) {  // big-endian in the file, little-endian here
            px[2 * s] = row[2 * (i * samples + s) + 1];
            px[2 * s + 1] = row[2 * (i * samples + s)];
          }
          continue;
        }
        int value;
        if (depth == 8) {
          value = row[i * samples];
        } else {
          const int64_t k = i * samples;  // grey or palette: one sample a pixel
          value = (row[k / per_byte] >> (8 - depth - depth * (int)(k % per_byte))) & mask;
        }
        if (hd.color == 3) {
          for (int c = 0; c < 3; c++) px[c] = table[value][c];
        } else if (depth < 8) {
          px[0] = (uint8_t)(value * grey_scale);
        } else {
          for (int s = 0; s < kept; s++) px[s] = row[i * samples + s];
        }
      }
    }
  }
  return kOk;
}

// native/frameio/frameio.cpp:134-166: bilinear at cv2's sample positions,
// the four-term sum in the library's order, left unrounded, times 1.0f / 255
// when normalizing. The library reads bytes: a 16-bit image's bytes are read
// at the sample stride, as it reads them.
void resize_color_bilinear(const uint8_t* data, int64_t h, int64_t w, int channels, int H,
                           int W, bool normalize, float* out) {
  const float sy = (float)h / H;
  const float sx = (float)w / W;
  const float scale = normalize ? (1.0f / 255.0f) : 1.0f;
  const int c = channels >= 3 ? 3 : 1;
  for (int y = 0; y < H; y++) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int64_t y0 = (int64_t)fy;
    if (fy < 0) y0 = 0, fy = 0;
    const int64_t y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    const float wy = fy - y0;
    for (int x = 0; x < W; x++) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int64_t x0 = (int64_t)fx;
      if (fx < 0) x0 = 0, fx = 0;
      const int64_t x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      const float wx = fx - x0;
      for (int k = 0; k < 3; k++) {
        const int kk = c == 1 ? 0 : k;
        const float v00 = data[(y0 * w + x0) * channels + kk];
        const float v01 = data[(y0 * w + x1) * channels + kk];
        const float v10 = data[(y1 * w + x0) * channels + kk];
        const float v11 = data[(y1 * w + x1) * channels + kk];
        const float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                        v10 * wy * (1 - wx) + v11 * wy * wx;
        out[((int64_t)y * W + x) * 3 + k] = v * scale;
      }
    }
  }
}

// native/frameio/frameio.cpp:168-190: the nearest sample at (int)(y * sy),
// clamped to the last row, read from the samples in order, times
// 1.0f / depth_scale.
void resize_depth_nearest(const uint8_t* data, bool is16, int64_t h, int64_t w, int H, int W,
                          float depth_scale, float* out) {
  const float sy = (float)h / H;
  const float sx = (float)w / W;
  const float inv = 1.0f / depth_scale;
  for (int y = 0; y < H; y++) {
    int64_t sy_i = (int64_t)(y * sy);
    if (sy_i >= h) sy_i = h - 1;
    for (int x = 0; x < W; x++) {
      int64_t sx_i = (int64_t)(x * sx);
      if (sx_i >= w) sx_i = w - 1;
      const int64_t k = sy_i * w + sx_i;
      const float v = is16 ? (float)(uint16_t)(data[2 * k] | (data[2 * k + 1] << 8))
                           : (float)data[k];
      out[(int64_t)y * W + x] = v * inv;
    }
  }
}

}  // namespace

extern "C" {

// Decode inflated PNG rows into `out`: (height, width[, 3]) samples, uint8,
// or native-order uint16 at 16 bits. Returns 0, or a negative code (info[0]
// holds the bad filter type for -1).
int gradslam_png_decode(const uint8_t* raw, int64_t raw_size, int64_t width, int64_t height,
                        int depth, int color, int interlace, const uint8_t* palette, int palette_entries,
                        void* out, int64_t* info) {
  Image img;
  const int code = decode(raw, raw_size, {width, height, depth, color, interlace}, palette,
                          palette_entries, &img, info);
  if (code != kOk) return code;
  if (!img.is16) {
    std::memcpy(out, img.data.data(), img.data.size());
    return kOk;
  }
  uint16_t* o = static_cast<uint16_t*>(out);
  for (size_t k = 0; k < img.data.size() / 2; k++)
    o[k] = (uint16_t)(img.data[2 * k] | (img.data[2 * k + 1] << 8));
  return kOk;
}

// Decode, then resize colour to (H, W, 3) float32.
int gradslam_png_color(const uint8_t* raw, int64_t raw_size, int64_t width, int64_t height,
                       int depth, int color, int interlace, const uint8_t* palette, int palette_entries,
                       int H, int W, int normalize, float* out, int64_t* info) {
  Image img;
  const int code = decode(raw, raw_size, {width, height, depth, color, interlace}, palette,
                          palette_entries, &img, info);
  if (code != kOk) return code;
  if (img.width == 0 || img.height == 0) return kEmpty;
  resize_color_bilinear(img.data.data(), img.height, img.width, img.channels, H, W,
                        normalize != 0, out);
  return kOk;
}

// Decode, then resize depth to (H, W) float32 metres.
int gradslam_png_depth(const uint8_t* raw, int64_t raw_size, int64_t width, int64_t height,
                       int depth, int color, int interlace, const uint8_t* palette, int palette_entries,
                       int H, int W, float depth_scale, float* out, int64_t* info) {
  Image img;
  const int code = decode(raw, raw_size, {width, height, depth, color, interlace}, palette,
                          palette_entries, &img, info);
  if (code != kOk) return code;
  if (img.width == 0 || img.height == 0) return kEmpty;
  resize_depth_nearest(img.data.data(), img.is16, img.height, img.width, H, W, depth_scale, out);
  return kOk;
}

// The resizes alone, on samples decoded elsewhere (JPEG through Pillow):
// `data` as the library holds an image (16-bit samples little-endian).
void gradslam_resize_color(const uint8_t* data, int64_t h, int64_t w, int channels, int H, int W,
                           int normalize, float* out) {
  resize_color_bilinear(data, h, w, channels, H, W, normalize != 0, out);
}

void gradslam_resize_depth(const uint8_t* data, int is16, int64_t h, int64_t w, int H, int W,
                           float depth_scale, float* out) {
  resize_depth_nearest(data, is16 != 0, h, w, H, W, depth_scale, out);
}

}  // extern "C"
