// Native data loader for the VO engine: grayscale PNG decode + prefetch pool
// (the port's own copy of native/loader.cpp; host code, built with the host
// C++ compiler and -lz by vo_tpu_torch/io/native_loader.py).
//
// Replaces the reference's imageDatastore/readimage feed (VO.m:16-17,71-72),
// which is MATLAB-native C++ under the hood (SURVEY §2.2). The host-side
// image feed must outpace the device's step, so decoding happens in a C++ thread
// pool that stays N frames ahead of the consumer; Python picks finished
// frames up via ctypes with zero copies beyond the decode buffer.
//
// Scope: non-interlaced 8/16-bit PNG, color types 0/2/4/6 (color reduced to
// BT.601 luma, alpha ignored) — covering KITTI odometry image_0/image_1
// (gray8) and the reference's published result figures (4500/*.png, RGB and
// RGBA). Inflate is delegated to zlib.
//
// C API (ctypes-friendly):
//   vo_png_info(path, &h, &w)                  -> 0 on success
//   vo_png_read(path, out, h*w)                -> 0 on success, out in [0,1]
//   vo_prefetch_start(paths, n, ahead, threads)-> handle
//   vo_prefetch_get(handle, idx, out, size)    -> blocks until frame idx ready
//   vo_prefetch_stop(handle)

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int h = 0, w = 0;
  std::vector<float> px;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Returns 0 on success. If out == nullptr, only fills h/w.
int decode_png(const char* path, Image* img, bool header_only) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::vector<uint8_t> data;
  {
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (sz <= 8) { std::fclose(f); return -2; }
    data.resize(size_t(sz));
    if (std::fread(data.data(), 1, size_t(sz), f) != size_t(sz)) {
      std::fclose(f);
      return -3;
    }
    std::fclose(f);
  }
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (std::memcmp(data.data(), sig, 8) != 0) return -4;

  size_t pos = 8;
  int w = 0, h = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= data.size()) {
    uint32_t len = be32(&data[pos]);
    if (pos + 12 + len > data.size()) return -5;
    const char* type = reinterpret_cast<const char*>(&data[pos + 4]);
    const uint8_t* body = &data[pos + 8];
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return -6;
      w = int(be32(body));
      h = int(be32(body + 4));
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
      if (header_only) {
        img->h = h;
        img->w = w;
        return 0;
      }
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (w <= 0 || h <= 0 || interlace != 0) return -7;
  // Gray (0), RGB (2), gray+alpha (4), RGBA (6); alpha is ignored for luma.
  int chans;
  switch (color_type) {
    case 0: chans = 1; break;
    case 2: chans = 3; break;
    case 4: chans = 2; break;
    case 6: chans = 4; break;
    default: return -8;  // palette not supported
  }
  if (bit_depth != 8 && bit_depth != 16) return -9;
  int bpp = chans * bit_depth / 8;           // bytes per pixel
  size_t stride = size_t(w) * size_t(bpp);   // bytes per scanline (no filter byte)

  // Inflate all IDAT into raw scanlines: h * (1 + stride).
  std::vector<uint8_t> raw(size_t(h) * (stride + 1));
  {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) return -10;
    zs.next_in = idat.data();
    zs.avail_in = uInt(idat.size());
    zs.next_out = raw.data();
    zs.avail_out = uInt(raw.size());
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (rc != Z_STREAM_END && rc != Z_OK) return -11;
    if (zs.total_out != raw.size()) return -12;
  }

  // Unfilter in place (PNG filter spec: None/Sub/Up/Average/Paeth).
  std::vector<uint8_t> prev(stride, 0);
  std::vector<uint8_t> line(stride);
  img->h = h;
  img->w = w;
  img->px.resize(size_t(h) * size_t(w));
  const float scale8 = 1.0f / 255.0f;
  const float scale16 = 1.0f / 65535.0f;
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = &raw[size_t(y) * (stride + 1)];
    uint8_t filter = src[0];
    const uint8_t* s = src + 1;
    for (size_t x = 0; x < stride; ++x) {
      int a = (x >= size_t(bpp)) ? line[x - bpp] : 0;  // left
      int b = prev[x];                                  // up
      int c = (x >= size_t(bpp)) ? prev[x - bpp] : 0;   // up-left
      int v = s[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return -13;
      }
      line[x] = uint8_t(v & 0xff);
    }
    float* dst = &img->px[size_t(y) * size_t(w)];
    bool rgb = chans >= 3;  // 2 and 4 carry a trailing alpha byte, ignored
    if (bit_depth == 8) {
      for (int x = 0; x < w; ++x) {
        const uint8_t* q = &line[size_t(x) * size_t(bpp)];
        if (rgb) {
          // ITU-R BT.601 luma, matching rgb2gray-style conversion.
          dst[x] = (0.299f * q[0] + 0.587f * q[1] + 0.114f * q[2]) * scale8;
        } else {
          dst[x] = float(q[0]) * scale8;
        }
      }
    } else {  // 16-bit big-endian
      for (int x = 0; x < w; ++x) {
        const uint8_t* q = &line[size_t(x) * size_t(bpp)];
        if (rgb) {
          uint32_t r = (uint32_t(q[0]) << 8) | q[1];
          uint32_t g = (uint32_t(q[2]) << 8) | q[3];
          uint32_t bl = (uint32_t(q[4]) << 8) | q[5];
          dst[x] = (0.299f * float(r) + 0.587f * float(g) + 0.114f * float(bl)) * scale16;
        } else {
          uint32_t v16 = (uint32_t(q[0]) << 8) | q[1];
          dst[x] = float(v16) * scale16;
        }
      }
    }
    std::swap(prev, line);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Prefetch pool: worker threads decode ahead of the consumer's cursor.
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  int ahead;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::map<int, Image> ready;        // decoded frames waiting for pickup
  std::atomic<int> next_to_decode{0};
  std::atomic<int> consumer_cursor{0};
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      int idx = -1;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] {
          if (stop.load()) return true;
          return next_to_decode.load() < int(paths.size()) &&
                 next_to_decode.load() < consumer_cursor.load() + ahead;
        });
        if (stop.load()) return;
        idx = next_to_decode.fetch_add(1);
        if (idx >= int(paths.size())) return;
      }
      Image img;
      int rc = decode_png(paths[size_t(idx)].c_str(), &img, false);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (rc != 0) img = Image{};  // empty marks failure
        ready.emplace(idx, std::move(img));
      }
      cv_done.notify_all();
    }
  }
};

}  // namespace

extern "C" {

int vo_png_info(const char* path, int* h, int* w) {
  Image img;
  int rc = decode_png(path, &img, true);
  if (rc == 0) {
    *h = img.h;
    *w = img.w;
  }
  return rc;
}

int vo_png_read(const char* path, float* out, long long out_size) {
  Image img;
  int rc = decode_png(path, &img, false);
  if (rc != 0) return rc;
  if (out_size < (long long)img.px.size()) return -20;
  std::memcpy(out, img.px.data(), img.px.size() * sizeof(float));
  return 0;
}

void* vo_prefetch_start(const char** paths, int n, int ahead, int threads) {
  auto* p = new Prefetcher();
  p->paths.assign(paths, paths + n);
  p->ahead = ahead > 0 ? ahead : 8;
  int nt = threads > 0 ? threads : 4;
  for (int i = 0; i < nt; ++i) p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Blocks until frame idx is decoded; copies into out ([0,1] floats, row-major).
// Returns 0 on success, <0 on decode failure or size mismatch.
int vo_prefetch_get(void* handle, int idx, float* out, long long out_size) {
  auto* p = static_cast<Prefetcher*>(handle);
  if (idx < 0 || idx >= int(p->paths.size())) return -30;
  // Advance the window so workers keep decoding past idx.
  int cur = p->consumer_cursor.load();
  while (cur < idx + 1 &&
         !p->consumer_cursor.compare_exchange_weak(cur, idx + 1)) {
  }
  p->cv_work.notify_all();
  Image img;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_done.wait(lk, [&] { return p->ready.count(idx) > 0 || p->stop.load(); });
    if (p->stop.load()) return -31;
    img = std::move(p->ready[idx]);
    p->ready.erase(idx);
  }
  if (img.px.empty()) return -32;
  if (out_size < (long long)img.px.size()) return -33;
  std::memcpy(out, img.px.data(), img.px.size() * sizeof(float));
  return 0;
}

void vo_prefetch_stop(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv_work.notify_all();
  p->cv_done.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
