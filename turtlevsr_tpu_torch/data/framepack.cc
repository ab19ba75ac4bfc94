// framepack — memory-mapped packed-frame dataset reader (the port's own copy
// of the JAX package's native/framepack.cc; the file format is the same, so
// a pack written by either package reads in the other).
//
// The reference feeds training from frame folders (decode per __getitem__)
// or vestigial LMDB (basicsr/utils/lmdb_util.py). This reader serves
// pre-decoded clips by pure memcpy from an mmap'd pack file, so the input
// pipeline leaves the host's few cores to the launches:
//
//   header:  "TVSRPAK1" | uint64 n_frames
//   index:   n_frames x { uint64 offset, uint32 h, uint32 w, uint32 c }
//   data:    raw uint8 HWC frames
//
// Exposed as a plain C API for ctypes. The hot entry point gathers a whole
// training clip (T frames) with a joint crop in one call — one Python->C
// transition per clip instead of per frame, and multi-threaded copies for
// multi-clip batches. Built by g++ at first use
// (turtlevsr_tpu_torch/data/framepack.py).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <thread>
#include <vector>

namespace {

#pragma pack(push, 1)
struct IndexEntry {  // 20 bytes on disk — keep packed, no padding
  uint64_t offset;
  uint32_t h, w, c;
};
#pragma pack(pop)
static_assert(sizeof(IndexEntry) == 20, "index entry must be packed");

struct Pack {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  uint64_t n_frames = 0;
  const IndexEntry* index = nullptr;
};

constexpr char kMagic[8] = {'T', 'V', 'S', 'R', 'P', 'A', 'K', '1'};

}  // namespace

extern "C" {

void* framepack_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) { ::close(fd); return nullptr; }
  const uint8_t* base = static_cast<const uint8_t*>(mem);
  if (st.st_size < 16 || memcmp(base, kMagic, 8) != 0) {
    munmap(mem, st.st_size); ::close(fd); return nullptr;
  }
  Pack* p = new Pack;
  p->fd = fd;
  p->base = base;
  p->size = st.st_size;
  memcpy(&p->n_frames, base + 8, 8);
  p->index = reinterpret_cast<const IndexEntry*>(base + 16);
  return p;
}

void framepack_close(void* handle) {
  Pack* p = static_cast<Pack*>(handle);
  if (!p) return;
  munmap(const_cast<uint8_t*>(p->base), p->size);
  ::close(p->fd);
  delete p;
}

uint64_t framepack_count(void* handle) {
  return static_cast<Pack*>(handle)->n_frames;
}

int framepack_shape(void* handle, uint64_t idx, uint32_t* hwc) {
  Pack* p = static_cast<Pack*>(handle);
  if (idx >= p->n_frames) return -1;
  const IndexEntry& e = p->index[idx];
  hwc[0] = e.h; hwc[1] = e.w; hwc[2] = e.c;
  return 0;
}

// Copy frame `idx` cropped at (y, x) with size (ph, pw) into out
// (ph*pw*c uint8, HWC row-major).
int framepack_read_crop(void* handle, uint64_t idx, uint32_t y, uint32_t x,
                        uint32_t ph, uint32_t pw, uint8_t* out) {
  Pack* p = static_cast<Pack*>(handle);
  if (idx >= p->n_frames) return -1;
  const IndexEntry& e = p->index[idx];
  if (y + ph > e.h || x + pw > e.w) return -2;
  const uint8_t* src = p->base + e.offset;
  const size_t row_bytes = static_cast<size_t>(e.w) * e.c;
  const size_t crop_row = static_cast<size_t>(pw) * e.c;
  for (uint32_t r = 0; r < ph; ++r) {
    memcpy(out + r * crop_row,
           src + (static_cast<size_t>(y) + r) * row_bytes
               + static_cast<size_t>(x) * e.c,
           crop_row);
  }
  return 0;
}

// Gather a clip: frames [first, first+T) jointly cropped at (y, x),
// written contiguously (T, ph, pw, c).
int framepack_read_clip(void* handle, uint64_t first, uint32_t t,
                        uint32_t y, uint32_t x, uint32_t ph, uint32_t pw,
                        uint8_t* out) {
  Pack* p = static_cast<Pack*>(handle);
  if (first + t > p->n_frames) return -1;
  const size_t frame_bytes =
      static_cast<size_t>(ph) * pw * p->index[first].c;
  for (uint32_t j = 0; j < t; ++j) {
    int rc = framepack_read_crop(handle, first + j, y, x, ph, pw,
                                 out + j * frame_bytes);
    if (rc != 0) return rc;
  }
  return 0;
}

// Batched multi-clip gather with one thread per clip (the 1-python-call
// batch path). firsts/ys/xs are length-n arrays; out is (n, T, ph, pw, c).
int framepack_read_batch(void* handle, const uint64_t* firsts, uint32_t n,
                         uint32_t t, const uint32_t* ys, const uint32_t* xs,
                         uint32_t ph, uint32_t pw, uint8_t* out) {
  Pack* p = static_cast<Pack*>(handle);
  const size_t clip_bytes =
      static_cast<size_t>(t) * ph * pw * (n ? p->index[firsts[0]].c : 3);
  std::vector<std::thread> workers;
  std::vector<int> rcs(n, 0);
  unsigned hw = std::thread::hardware_concurrency();
  if (hw <= 1 || n <= 1) {
    for (uint32_t i = 0; i < n; ++i) {
      rcs[i] = framepack_read_clip(handle, firsts[i], t, ys[i], xs[i], ph,
                                   pw, out + i * clip_bytes);
    }
  } else {
    for (uint32_t i = 0; i < n; ++i) {
      workers.emplace_back([&, i]() {
        rcs[i] = framepack_read_clip(handle, firsts[i], t, ys[i], xs[i], ph,
                                     pw, out + i * clip_bytes);
      });
    }
    for (auto& th : workers) th.join();
  }
  for (int rc : rcs) if (rc != 0) return rc;
  return 0;
}

}  // extern "C"
