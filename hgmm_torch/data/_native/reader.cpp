// Native point-cloud ingest: mmap'd KITTI velodyne .bin and binary PLY
// readers (SURVEY.md §2.1 items 2/12: the reference's C++ loader maps to a
// native fast path for 10M+-point scans; the Python loaders in
// hgmm_torch.data.ply / hgmm_torch.data.kitti are the portable fallback).
// A copy of hgmm/data/_native/reader.cpp, kept by the port.
//
// Exposed via ctypes (hgmm_torch/data/native.py) — no pybind11 dependency.
// Build: python -m hgmm_torch.data.native --build   (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <thread>
#include <vector>

namespace {

struct Mapped {
  const uint8_t* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  m.data = static_cast<const uint8_t*>(p);
  m.size = static_cast<size_t>(st.st_size);
  return m;
}

void unmap(Mapped& m) {
  if (m.data) munmap(const_cast<uint8_t*>(m.data), m.size);
  if (m.fd >= 0) close(m.fd);
  m.data = nullptr;
  m.fd = -1;
}

// Strided xyz copy, parallelized for big scans (memory-bound; threads help
// only past the point where pages stream from disk).
void strided_copy_xyz(const float* src, float* dst, int64_t n,
                      int64_t src_stride_floats) {
  const int64_t kParallelThreshold = 4'000'000;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const float* s = src + i * src_stride_floats;
      float* d = dst + i * 3;
      d[0] = s[0];
      d[1] = s[1];
      d[2] = s[2];
    }
  };
  if (n < kParallelThreshold) {
    work(0, n);
    return;
  }
  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = hw > 8 ? 8 : (hw ? hw : 1);
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk > n ? n : lo + chunk;
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// KITTI velodyne: flat LE float32 [N,4]. Returns point count, or -1 on
// error. Pass out=nullptr to query the count.
int64_t hgmm_read_kitti_bin(const char* path, float* out) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  if (m.size % 16 != 0) {
    unmap(m);
    return -1;
  }
  int64_t n = static_cast<int64_t>(m.size / 16);
  if (out != nullptr) {
    strided_copy_xyz(reinterpret_cast<const float*>(m.data), out, n, 4);
  }
  unmap(m);
  return n;
}

// Binary little-endian PLY with float x/y/z as the first three vertex
// properties (the Stanford-scan layout). Returns vertex count or -1 if the
// file needs the general-purpose Python parser (ascii, doubles, reordered
// properties, ...). Pass out=nullptr to query.
int64_t hgmm_read_ply_xyz(const char* path, float* out) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* p = reinterpret_cast<const char*>(m.data);
  const char* end = p + m.size;
  if (m.size < 16 || strncmp(p, "ply", 3) != 0) {
    unmap(m);
    return -1;
  }
  // Header scan.
  int64_t n_vertex = -1;
  int64_t vertex_stride = 0;  // bytes per vertex record
  int xyz_offset = -1;        // byte offset of x within the record
  int prop_index = 0;
  bool in_vertex = false;
  bool fmt_ok = false;
  const char* line = p;
  const char* header_end = nullptr;
  while (line < end) {
    const char* nl = static_cast<const char*>(memchr(line, '\n', end - line));
    if (!nl) break;
    size_t len = nl - line;
    auto starts = [&](const char* s) {
      size_t sl = strlen(s);
      return len >= sl && strncmp(line, s, sl) == 0;
    };
    if (starts("format binary_little_endian")) {
      fmt_ok = true;
    } else if (starts("element vertex ")) {
      n_vertex = strtoll(line + 15, nullptr, 10);
      in_vertex = true;
      vertex_stride = 0;
      prop_index = 0;
    } else if (starts("element ")) {
      in_vertex = false;
    } else if (in_vertex && starts("property ")) {
      int sz = 0;
      if (starts("property float ")) sz = 4;
      else if (starts("property double ")) { unmap(m); return -1; }
      else if (starts("property uchar ") || starts("property char ")) sz = 1;
      else if (starts("property short ") || starts("property ushort ")) sz = 2;
      else if (starts("property int ") || starts("property uint ")) sz = 4;
      else { unmap(m); return -1; }  // list property etc.
      if (len >= 2 && nl[-2] == ' ') {
        char prop = nl[-1];
        if (prop == 'x' && xyz_offset < 0) {
          if (sz != 4) { unmap(m); return -1; }
          xyz_offset = static_cast<int>(vertex_stride);
        } else if (prop == 'y' && xyz_offset >= 0 &&
                   vertex_stride != xyz_offset + 4) {
          unmap(m); return -1;  // y not contiguous after x
        } else if (prop == 'z' && xyz_offset >= 0 &&
                   vertex_stride != xyz_offset + 8) {
          unmap(m); return -1;  // z not contiguous after y
        }
      }
      vertex_stride += sz;
      ++prop_index;
    } else if (starts("end_header")) {
      header_end = nl + 1;
      break;
    }
    line = nl + 1;
  }
  if (!fmt_ok || !header_end || n_vertex < 0 || xyz_offset < 0 ||
      vertex_stride < 12) {
    unmap(m);
    return -1;
  }
  if (static_cast<size_t>(header_end - p) + n_vertex * vertex_stride > m.size) {
    unmap(m);
    return -1;
  }
  if (out != nullptr) {
    const uint8_t* base =
        reinterpret_cast<const uint8_t*>(header_end) + xyz_offset;
    if (vertex_stride % 4 == 0 && xyz_offset % 4 == 0) {
      strided_copy_xyz(reinterpret_cast<const float*>(base), out, n_vertex,
                       vertex_stride / 4);
    } else {
      for (int64_t i = 0; i < n_vertex; ++i) {
        memcpy(out + i * 3, base + i * vertex_stride, 12);
      }
    }
  }
  unmap(m);
  return n_vertex;
}

// Voxel-grid downsample: one centroid per occupied voxel. Semantics match
// hgmm_torch.data.kitti.voxel_downsample exactly (same f32 floor(p/voxel) keys,
// same 20-bit-per-axis int64 packing, same ascending-key output order, f64
// centroid accumulation), so the Python fallback and this fast path are
// interchangeable bit-for-bit up to f32 rounding of the final centroids.
// np.add.at runs at ~20M pts/s; this single-pass open-addressing table at
// ~150M+ — the difference between ~0.5 s and ~30 ms per 10M-point frame of
// host-side preprocessing in the config-5 ingest path (SURVEY.md §8).
//
// `pts` is [n,3] row-major f32; `out` must hold n*3 floats (output count is
// always <= n). Returns the number of output points, or -1 on bad args.
int64_t hgmm_voxel_downsample(const float* pts, int64_t n, float voxel,
                              float* out) {
  if (pts == nullptr || out == nullptr || n <= 0 || !(voxel > 0.0f)) return -1;
  uint64_t cap = 64;
  while (cap < static_cast<uint64_t>(2 * n)) cap <<= 1;
  const uint64_t mask = cap - 1;
  constexpr uint64_t kEmpty = ~0ull;  // packed keys are < 2^60
  std::vector<uint64_t> table_key(cap, kEmpty);
  std::vector<int64_t> table_slot(cap);
  struct Acc {
    uint64_t key;
    double x, y, z;
    int64_t c;
  };
  std::vector<Acc> accs;
  accs.reserve(static_cast<size_t>(n / 4 + 16));

  for (int64_t i = 0; i < n; ++i) {
    const float* p = pts + i * 3;
    // Two's-complement & matches numpy's int64 & 0xFFFFF on negatives.
    int64_t kx = static_cast<int64_t>(std::floor(p[0] / voxel));
    int64_t ky = static_cast<int64_t>(std::floor(p[1] / voxel));
    int64_t kz = static_cast<int64_t>(std::floor(p[2] / voxel));
    uint64_t key = (static_cast<uint64_t>(kx) & 0xFFFFF) |
                   ((static_cast<uint64_t>(ky) & 0xFFFFF) << 20) |
                   ((static_cast<uint64_t>(kz) & 0xFFFFF) << 40);
    uint64_t idx = (key * 0x9E3779B97F4A7C15ull) & mask;
    while (true) {
      if (table_key[idx] == kEmpty) {
        table_key[idx] = key;
        table_slot[idx] = static_cast<int64_t>(accs.size());
        accs.push_back({key, p[0], p[1], p[2], 1});
        break;
      }
      if (table_key[idx] == key) {
        Acc& a = accs[static_cast<size_t>(table_slot[idx])];
        a.x += p[0];
        a.y += p[1];
        a.z += p[2];
        a.c += 1;
        break;
      }
      idx = (idx + 1) & mask;
    }
  }
  std::sort(accs.begin(), accs.end(),
            [](const Acc& a, const Acc& b) { return a.key < b.key; });
  for (size_t i = 0; i < accs.size(); ++i) {
    const Acc& a = accs[i];
    out[i * 3 + 0] = static_cast<float>(a.x / a.c);
    out[i * 3 + 1] = static_cast<float>(a.y / a.c);
    out[i * 3 + 2] = static_cast<float>(a.z / a.c);
  }
  return static_cast<int64_t>(accs.size());
}

}  // extern "C"
