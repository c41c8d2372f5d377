// Native COLMAP sparse-model reader (the port's copy of
// gsplat_tpu/csrc/colmap_native.cpp).
//
// One pass of pointer arithmetic over each binary model file (cameras.bin,
// images.bin, points3D.bin), behind a minimal C interface that
// datasets/colmap_native.py binds through ctypes; it is built with g++ at
// first use. Two calls per file: a *_count / *_sizes call so that the
// caller can allocate its numpy buffers, then a *_read call that fills
// them.
//
// Format: https://colmap.github.io/format.html (binary model files).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

bool read_all(const char *path, std::vector<unsigned char> &buf) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize(static_cast<size_t>(sz));
  size_t got = sz ? std::fread(buf.data(), 1, static_cast<size_t>(sz), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(sz);
}

struct Cursor {
  const unsigned char *p;
  const unsigned char *end;
  bool ok = true;

  template <typename T> T get() {
    if (p + sizeof(T) > end) {
      ok = false;
      return T{};
    }
    T v;
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }
  bool skip(size_t nbytes) {
    if (p + nbytes > end) {
      ok = false;
      return false;
    }
    p += nbytes;
    return true;
  }
};

// COLMAP camera model id -> parameter count (format.html)
int model_params(int model_id) {
  static const int np[] = {3, 4, 4, 5, 8, 8, 12, 5, 4, 5, 12};
  return (model_id >= 0 && model_id <= 10) ? np[model_id] : -1;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- points3D
int64_t cn_points3d_count(const char *path) {
  std::vector<unsigned char> buf;
  if (!read_all(path, buf)) return -1;
  Cursor c{buf.data(), buf.data() + buf.size()};
  int64_t n = static_cast<int64_t>(c.get<uint64_t>());
  return c.ok ? n : -1;
}

// ids [n] i64, xyz [n*3] f64, rgb [n*3] u8, err [n] f64
int cn_points3d_read(const char *path, int64_t n, int64_t *ids, double *xyz,
                     uint8_t *rgb, double *err) {
  std::vector<unsigned char> buf;
  if (!read_all(path, buf)) return 1;
  Cursor c{buf.data(), buf.data() + buf.size()};
  int64_t n_file = static_cast<int64_t>(c.get<uint64_t>());
  if (!c.ok || n_file != n) return 2;
  for (int64_t i = 0; i < n; ++i) {
    ids[i] = static_cast<int64_t>(c.get<uint64_t>());
    xyz[3 * i + 0] = c.get<double>();
    xyz[3 * i + 1] = c.get<double>();
    xyz[3 * i + 2] = c.get<double>();
    rgb[3 * i + 0] = c.get<uint8_t>();
    rgb[3 * i + 1] = c.get<uint8_t>();
    rgb[3 * i + 2] = c.get<uint8_t>();
    err[i] = c.get<double>();
    uint64_t track_len = c.get<uint64_t>();
    if (!c.skip(8 * track_len)) return 3;
  }
  return c.ok ? 0 : 3;
}

// ----------------------------------------------------------------- images
int cn_images_sizes(const char *path, int64_t *n_images, int64_t *total_p2d) {
  std::vector<unsigned char> buf;
  if (!read_all(path, buf)) return 1;
  Cursor c{buf.data(), buf.data() + buf.size()};
  int64_t n = static_cast<int64_t>(c.get<uint64_t>());
  int64_t tot = 0;
  for (int64_t i = 0; i < n && c.ok; ++i) {
    c.skip(4 + 8 * 7 + 4);  // id, qvec, tvec, camera_id
    while (c.ok) {          // null-terminated name
      if (c.p >= c.end) {
        c.ok = false;
        break;
      }
      if (*c.p++ == 0) break;
    }
    uint64_t n2d = c.get<uint64_t>();
    tot += static_cast<int64_t>(n2d);
    if (!c.skip(24 * n2d)) return 2;
  }
  if (!c.ok) return 2;
  *n_images = n;
  *total_p2d = tot;
  return 0;
}

// image_ids [n] i32, qvecs [n*4] f64, tvecs [n*3] f64, camera_ids [n] i32,
// names [n*name_stride] char (null-terminated, truncated),
// p2d_offsets [n+1] i64, p2d_xy [total*2] f64, p2d_ids [total] i64
int cn_images_read(const char *path, int64_t n, int64_t total,
                   int32_t *image_ids, double *qvecs, double *tvecs,
                   int32_t *camera_ids, char *names, int32_t name_stride,
                   int64_t *p2d_offsets, double *p2d_xy, int64_t *p2d_ids) {
  std::vector<unsigned char> buf;
  if (!read_all(path, buf)) return 1;
  Cursor c{buf.data(), buf.data() + buf.size()};
  int64_t n_file = static_cast<int64_t>(c.get<uint64_t>());
  if (!c.ok || n_file != n) return 2;
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    image_ids[i] = c.get<int32_t>();
    for (int k = 0; k < 4; ++k) qvecs[4 * i + k] = c.get<double>();
    for (int k = 0; k < 3; ++k) tvecs[3 * i + k] = c.get<double>();
    camera_ids[i] = c.get<int32_t>();
    char *dst = names + static_cast<int64_t>(i) * name_stride;
    int w = 0;
    while (c.ok) {
      if (c.p >= c.end) {
        c.ok = false;
        break;
      }
      unsigned char ch = *c.p++;
      if (w < name_stride - 1) dst[w++] = static_cast<char>(ch);
      if (ch == 0) break;
    }
    dst[w < name_stride ? w : name_stride - 1] = 0;
    uint64_t n2d = c.get<uint64_t>();
    p2d_offsets[i] = pos;
    if (pos + static_cast<int64_t>(n2d) > total) return 3;
    for (uint64_t k = 0; k < n2d; ++k) {
      p2d_xy[2 * pos + 0] = c.get<double>();
      p2d_xy[2 * pos + 1] = c.get<double>();
      p2d_ids[pos] = c.get<int64_t>();
      ++pos;
    }
    if (!c.ok) return 3;
  }
  p2d_offsets[n] = pos;
  return c.ok ? 0 : 3;
}

// ---------------------------------------------------------------- cameras
int64_t cn_cameras_count(const char *path) {
  std::vector<unsigned char> buf;
  if (!read_all(path, buf)) return -1;
  Cursor c{buf.data(), buf.data() + buf.size()};
  int64_t n = static_cast<int64_t>(c.get<uint64_t>());
  return c.ok ? n : -1;
}

// cam_ids [n] i32, model_ids [n] i32, wh [n*2] i64,
// params [n*max_params] f64, n_params [n] i32
int cn_cameras_read(const char *path, int64_t n, int32_t *cam_ids,
                    int32_t *model_ids, int64_t *wh, double *params,
                    int32_t max_params, int32_t *n_params) {
  std::vector<unsigned char> buf;
  if (!read_all(path, buf)) return 1;
  Cursor c{buf.data(), buf.data() + buf.size()};
  int64_t n_file = static_cast<int64_t>(c.get<uint64_t>());
  if (!c.ok || n_file != n) return 2;
  for (int64_t i = 0; i < n; ++i) {
    cam_ids[i] = c.get<int32_t>();
    int32_t model_id = c.get<int32_t>();
    model_ids[i] = model_id;
    wh[2 * i + 0] = static_cast<int64_t>(c.get<uint64_t>());
    wh[2 * i + 1] = static_cast<int64_t>(c.get<uint64_t>());
    int np = model_params(model_id);
    if (np < 0 || np > max_params) return 3;
    n_params[i] = np;
    for (int k = 0; k < np; ++k) params[i * max_params + k] = c.get<double>();
  }
  return c.ok ? 0 : 3;
}

}  // extern "C"
