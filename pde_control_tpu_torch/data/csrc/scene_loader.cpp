// Native scene/batch loader of pde_control_tpu_torch.
//
// Parses .npy (v1/v2) float32 or float64 frames and gathers whole batches
// of them into one float32 buffer with a pool of threads, outside Python's
// interpreter lock. Python binds it with ctypes (data/native_loader.py).
//
// API (C, exported):
//   npy_probe(path, shape_out[8], ndim_out)      -> 0 ok / negative code
//   npy_read_f32(path, out, out_elems)            -> 0 ok
//   gather_batch_f32(paths, n, out, frame_elems, n_threads) -> 0 ok
// Codes: -2 cannot open, -3 bad header or Fortran order, -4 element count
// differs, -5 short read, -6 unsupported dtype.
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 scene_loader.cpp
//        -o libsceneloader_<hash>.so   (done by data/native_loader.py)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>
#include <atomic>

namespace {

// Parse the .npy header. Returns data offset, fills dtype/shape; -1 on error.
long parse_npy_header(FILE* f, std::string* descr,
                      std::vector<long>* shape, bool* fortran) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return -1;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return -1;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return -1;
    header_len = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return -1;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
  }
  std::string hdr(header_len, '\0');
  if (fread(&hdr[0], 1, header_len, f) != header_len) return -1;

  auto find_val = [&](const char* key) -> std::string {
    size_t p = hdr.find(key);
    if (p == std::string::npos) return "";
    p = hdr.find(':', p);
    if (p == std::string::npos) return "";
    size_t e = hdr.find(',', p);
    size_t e2 = hdr.find('}', p);
    if (e == std::string::npos || (e2 != std::string::npos && e2 < e)) e = e2;
    return hdr.substr(p + 1, e - p - 1);
  };

  std::string d = find_val("'descr'");
  size_t q0 = d.find('\''), q1 = d.rfind('\'');
  *descr = (q0 != std::string::npos && q1 > q0)
               ? d.substr(q0 + 1, q1 - q0 - 1) : "";
  *fortran = find_val("'fortran_order'").find("True") != std::string::npos;

  size_t sp = hdr.find("'shape'");
  if (sp == std::string::npos) return -1;
  size_t l = hdr.find('(', sp), r = hdr.find(')', sp);
  if (l == std::string::npos || r == std::string::npos) return -1;
  std::string tup = hdr.substr(l + 1, r - l - 1);
  shape->clear();
  const char* s = tup.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') s++;
    if (!*s) break;
    shape->push_back(strtol(s, const_cast<char**>(&s), 10));
  }
  return ftell(f);
}

int read_one(const char* path, float* out, long out_elems) {
  FILE* f = fopen(path, "rb");
  if (!f) return -2;
  std::string descr;
  std::vector<long> shape;
  bool fortran = false;
  long off = parse_npy_header(f, &descr, &shape, &fortran);
  if (off < 0 || fortran) { fclose(f); return -3; }
  long elems = 1;
  for (long s : shape) elems *= s;
  if (elems != out_elems) { fclose(f); return -4; }
  int rc = 0;
  if (descr == "<f4" || descr == "|f4" || descr == "=f4" || descr == "f4") {
    if ((long)fread(out, sizeof(float), elems, f) != elems) rc = -5;
  } else if (descr == "<f8") {
    std::vector<double> tmp(elems);
    if ((long)fread(tmp.data(), sizeof(double), elems, f) != elems) rc = -5;
    else for (long i = 0; i < elems; i++) out[i] = (float)tmp[i];
  } else {
    rc = -6;  // unsupported dtype
  }
  fclose(f);
  return rc;
}

}  // namespace

extern "C" {

int npy_probe(const char* path, long* shape_out, int* ndim_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -2;
  std::string descr;
  std::vector<long> shape;
  bool fortran = false;
  long off = parse_npy_header(f, &descr, &shape, &fortran);
  fclose(f);
  if (off < 0) return -3;
  *ndim_out = (int)shape.size();
  for (size_t i = 0; i < shape.size() && i < 8; i++) shape_out[i] = shape[i];
  return 0;
}

int npy_read_f32(const char* path, float* out, long out_elems) {
  return read_one(path, out, out_elems);
}

// Gather n frames (each frame_elems floats) into a contiguous batch buffer
// using a small thread pool. Returns 0, or the first nonzero error code.
int gather_batch_f32(const char** paths, int n, float* out, long frame_elems,
                     int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = read_one(paths[i], out + (long)i * frame_elems, frame_elems);
      if (rc != 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, rc);
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return err.load();
}

}  // extern "C"
