// Memory-mapped batch cache: the native data-loader runtime for pre-rendered
// prior batches.
//
// Role (parity): the reference streams pre-rendered stroke batches from
// torch.save files chosen at random (reference priors/stroke.py:81-84) and
// caches omniglot episodes in host RAM (datasets/omniglotNshot.py:172-246).
// Both are Python-side, copy-heavy paths. This component replaces them with
// one binary format + mmap: batches are written once (expensive priors render
// offline), then served at training speed with ZERO-COPY reads — the mmap
// page cache is the only buffer, and numpy arrays view it directly.
//
// File layout (little-endian):
//   magic    "PFNC"            4 bytes
//   version  u32               currently 1
//   nrec     u64               number of records (finalized on close)
//   recf     u64               floats per record
//   metalen  u64               bytes of metadata (JSON written by Python)
//   meta     metalen bytes
//   records  nrec * recf * f32
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[4] = {'P', 'F', 'N', 'C'};
constexpr uint32_t kVersion = 1;

struct Header {
  char magic[4];
  uint32_t version;
  uint64_t nrec;
  uint64_t recf;
  uint64_t metalen;
};

struct Reader {
  int fd = -1;
  uint8_t* map = nullptr;
  size_t map_size = 0;
  Header hdr{};
  std::string meta;
  const float* records = nullptr;
};

struct Writer {
  FILE* f = nullptr;
  uint64_t nrec = 0;
  uint64_t recf = 0;
};

}  // namespace

extern "C" {

void* bc_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < sizeof(Header)) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* r = new Reader();
  r->fd = fd;
  r->map = static_cast<uint8_t*>(map);
  r->map_size = st.st_size;
  std::memcpy(&r->hdr, r->map, sizeof(Header));
  if (std::memcmp(r->hdr.magic, kMagic, 4) != 0 || r->hdr.version != kVersion) {
    munmap(map, st.st_size);
    ::close(fd);
    delete r;
    return nullptr;
  }
  // Validate the header BEFORE dereferencing any length it declares, with
  // overflow-safe arithmetic: a corrupt metalen/nrec/recf must fail cleanly,
  // not read past the mapping or wrap the size check.
  bool bad = r->hdr.metalen > r->map_size - sizeof(Header);
  if (!bad) {
    size_t payload = r->map_size - sizeof(Header) - r->hdr.metalen;
    size_t max_floats = payload / sizeof(float);
    bad = r->hdr.recf == 0 ||
          r->hdr.nrec > max_floats / r->hdr.recf;  // division: no overflow
  }
  if (bad) {
    munmap(map, st.st_size);
    ::close(fd);
    delete r;
    return nullptr;
  }
  r->meta.assign(reinterpret_cast<const char*>(r->map + sizeof(Header)),
                 r->hdr.metalen);
  // Strip alignment padding NULs from the JSON payload.
  while (!r->meta.empty() && r->meta.back() == '\0') r->meta.pop_back();
  r->records = reinterpret_cast<const float*>(r->map + sizeof(Header) +
                                              r->hdr.metalen);
  // Sequential read-ahead hint for training-order scans.
  madvise(map, st.st_size, MADV_WILLNEED);
  return r;
}

int64_t bc_num_records(void* h) {
  return static_cast<Reader*>(h)->hdr.nrec;
}

int64_t bc_record_floats(void* h) {
  return static_cast<Reader*>(h)->hdr.recf;
}

const char* bc_meta(void* h) { return static_cast<Reader*>(h)->meta.c_str(); }

// Zero-copy: pointer into the mapping; valid until bc_close.
const float* bc_record_ptr(void* h, int64_t idx) {
  auto* r = static_cast<Reader*>(h);
  if (idx < 0 || static_cast<uint64_t>(idx) >= r->hdr.nrec) return nullptr;
  return r->records + static_cast<uint64_t>(idx) * r->hdr.recf;
}

// Copying read for callers that need an owned buffer.
int bc_read(void* h, int64_t idx, float* out) {
  const float* p = bc_record_ptr(h, idx);
  if (p == nullptr) return -1;
  std::memcpy(out, p,
              static_cast<Reader*>(h)->hdr.recf * sizeof(float));
  return 0;
}

void bc_close(void* h) {
  auto* r = static_cast<Reader*>(h);
  if (r->map) munmap(r->map, r->map_size);
  if (r->fd >= 0) ::close(r->fd);
  delete r;
}

void* bcw_create(const char* path, int64_t record_floats, const char* meta) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  w->recf = record_floats;
  Header hdr{};
  std::memcpy(hdr.magic, kMagic, 4);
  hdr.version = kVersion;
  hdr.nrec = 0;  // patched in bcw_finish
  hdr.recf = record_floats;
  // Pad metadata so the records start float-aligned (zero-copy numpy views
  // point straight into the mapping).
  uint64_t raw_len = std::strlen(meta);
  hdr.metalen = (raw_len + alignof(float) - 1) / alignof(float) * alignof(float);
  std::fwrite(&hdr, sizeof(Header), 1, f);
  std::fwrite(meta, 1, raw_len, f);
  for (uint64_t i = raw_len; i < hdr.metalen; ++i) std::fputc('\0', f);
  return w;
}

int bcw_append(void* handle, const float* data) {
  auto* w = static_cast<Writer*>(handle);
  size_t n = std::fwrite(data, sizeof(float), w->recf, w->f);
  if (n != w->recf) return -1;
  w->nrec += 1;
  return 0;
}

int64_t bcw_num_records(void* handle) {
  return static_cast<Writer*>(handle)->nrec;
}

void bcw_finish(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  // Patch nrec into the header.
  std::fseek(w->f, offsetof(Header, nrec), SEEK_SET);
  std::fwrite(&w->nrec, sizeof(uint64_t), 1, w->f);
  std::fclose(w->f);
  delete w;
}

}  // extern "C"
