// Native read-only LMDB environment (mmap + B-tree walk).
//
// The hot path of the input pipeline is LMDB key lookups from Python worker
// threads (image-%09d / label-%09d / mask-%09d). This module provides a
// zero-copy C implementation of the same on-disk format as
// ccd_tpu_torch/data/lmdb.py (standard LMDB 0.9, little-endian 64-bit), exposed
// through a minimal C ABI consumed via ctypes. Values are returned as
// pointers into the mmap — no allocation or copy on the C side.
//
// Built at first use by ccd_tpu_torch/native/__init__.py:
//   g++ -O2 -shared -fPIC -o _build/libccd_lmdb_<hash>.so lmdb_reader.cc

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xBEEFC0DE;
constexpr size_t kPageSize = 4096;
constexpr size_t kPageHdr = 16;
constexpr uint16_t kPBranch = 0x01;
constexpr uint16_t kPLeaf = 0x02;
constexpr uint16_t kFBigData = 0x01;
constexpr uint64_t kPInvalid = ~0ULL;

struct Env {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t size = 0;
  uint64_t root = kPInvalid;
  uint64_t entries = 0;
};

inline uint16_t rd16(const uint8_t* p) { uint16_t v; memcpy(&v, p, 2); return v; }
inline uint32_t rd32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
inline uint64_t rd64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }

struct Meta {
  uint64_t txnid;
  uint64_t root;
  uint64_t entries;
  bool ok;
};

Meta read_meta(const Env* env, int pageno) {
  const uint8_t* page = env->map + pageno * kPageSize;
  Meta m{0, kPInvalid, 0, false};
  if (rd32(page + kPageHdr) != kMagic) return m;
  const uint8_t* main_db = page + kPageHdr + 24 + 48;  // mm_dbs[1]
  m.entries = rd64(main_db + 32);
  m.root = rd64(main_db + 40);
  m.txnid = rd64(main_db + 48 + 8);
  m.ok = true;
  return m;
}

inline int numkeys(const uint8_t* page) {
  return (rd16(page + 12) - kPageHdr) >> 1;
}

inline const uint8_t* node(const uint8_t* page, int i) {
  return page + rd16(page + kPageHdr + 2 * i);
}

inline int keycmp(const uint8_t* a, size_t alen, const uint8_t* b, size_t blen) {
  int c = memcmp(a, b, alen < blen ? alen : blen);
  if (c != 0) return c;
  return alen < blen ? -1 : (alen > blen ? 1 : 0);
}

}  // namespace

extern "C" {

void* ccd_lmdb_open(const char* path) {
  std::string data_path(path);
  struct stat st;
  if (stat(path, &st) != 0) return nullptr;
  if (S_ISDIR(st.st_mode)) data_path += "/data.mdb";
  int fd = open(data_path.c_str(), O_RDONLY);
  if (fd < 0) return nullptr;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) { close(fd); return nullptr; }

  Env* env = new Env;
  env->fd = fd;
  env->map = static_cast<const uint8_t*>(map);
  env->size = st.st_size;
  Meta m0 = read_meta(env, 0);
  Meta m1 = read_meta(env, 1);
  if (!m0.ok && !m1.ok) {
    munmap(map, st.st_size);
    close(fd);
    delete env;
    return nullptr;
  }
  const Meta& m = (!m0.ok || (m1.ok && m1.txnid >= m0.txnid)) ? m1 : m0;
  env->root = m.root;
  env->entries = m.entries;
  return env;
}

uint64_t ccd_lmdb_entries(void* handle) {
  return static_cast<Env*>(handle)->entries;
}

// Returns 1 and sets (*val, *vlen) to a zero-copy view on hit, 0 on miss.
int ccd_lmdb_get(void* handle, const uint8_t* key, size_t klen,
                 const uint8_t** val, size_t* vlen) {
  const Env* env = static_cast<Env*>(handle);
  uint64_t pgno = env->root;
  if (pgno == kPInvalid) return 0;
  while (true) {
    const uint8_t* page = env->map + pgno * kPageSize;
    uint16_t flags = rd16(page + 10);
    int n = numkeys(page);
    if (flags & kPLeaf) {
      int lo = 0, hi = n - 1;
      while (lo <= hi) {
        int mid = (lo + hi) / 2;
        const uint8_t* nd = node(page, mid);
        uint16_t ksize = rd16(nd + 6);
        int c = keycmp(nd + 8, ksize, key, klen);
        if (c == 0) {
          uint64_t dsize = rd16(nd) | (uint32_t(rd16(nd + 2)) << 16);
          uint16_t nflags = rd16(nd + 4);
          if (nflags & kFBigData) {
            uint64_t ovf = rd64(nd + 8 + ksize);
            *val = env->map + ovf * kPageSize + kPageHdr;
          } else {
            *val = nd + 8 + ksize;
          }
          *vlen = dsize;
          return 1;
        }
        if (c < 0) lo = mid + 1; else hi = mid - 1;
      }
      return 0;
    }
    if (!(flags & kPBranch)) return 0;
    // rightmost child whose key <= target (node 0 = -inf)
    int lo = 1, hi = n - 1, ans = 0;
    while (lo <= hi) {
      int mid = (lo + hi) / 2;
      const uint8_t* nd = node(page, mid);
      uint16_t ksize = rd16(nd + 6);
      if (keycmp(nd + 8, ksize, key, klen) <= 0) { ans = mid; lo = mid + 1; }
      else hi = mid - 1;
    }
    const uint8_t* nd = node(page, ans);
    pgno = uint64_t(rd16(nd)) | (uint64_t(rd16(nd + 2)) << 16)
         | (uint64_t(rd16(nd + 4)) << 32);
  }
}

void ccd_lmdb_close(void* handle) {
  Env* env = static_cast<Env*>(handle);
  if (env->map) munmap(const_cast<uint8_t*>(env->map), env->size);
  if (env->fd >= 0) close(env->fd);
  delete env;
}

}  // extern "C"
