// PackFile: the memory-mapped reader of packed datasets (the port's own copy;
// the format is the JAX package's, so that a file written by either reads in
// the other).
//
// Fills the role of the reference's FileClient lmdb backend
// (basicsr/utils/file_client.py:5-131): random access to millions of small
// blobs (encoded images) without per-file filesystem overhead, for the
// training input pipeline.  Unlike the lmdb dependency, this is a single
// mmap'd flat file with a sorted key index; reads are zero-copy pointers
// into the page cache, safe to share across loader threads (read-only).
//
// Layout (little-endian):
//   [0..8)    magic "RSPACK01"
//   [8..16)   u64 n_entries
//   [16..24)  u64 index_offset
//   [24..)    blob data
//   index_offset:
//       n_entries x { u64 data_off, u64 data_len, u32 key_off, u32 key_len }
//       key bytes blob (keys sorted ascending; key_off relative to blob)
//
// C ABI (ctypes-friendly); see resshift_tpu_torch/data/packfile.py for the
// Python writer and bindings.

#include <cstdint>
#include <cstring>
#include <string>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[8] = {'R', 'S', 'P', 'A', 'C', 'K', '0', '1'};

#pragma pack(push, 1)
struct IndexEntry {
  uint64_t data_off;
  uint64_t data_len;
  uint32_t key_off;
  uint32_t key_len;
};
#pragma pack(pop)

struct Pack {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  uint64_t n = 0;
  const IndexEntry* index = nullptr;
  const char* keys = nullptr;
};

inline int key_cmp(const char* a, uint32_t alen, const char* b, uint32_t blen) {
  uint32_t m = alen < blen ? alen : blen;
  int c = memcmp(a, b, m);
  if (c) return c;
  return (alen > blen) - (alen < blen);
}

}  // namespace

extern "C" {

void* rspk_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 24) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const uint8_t* base = static_cast<const uint8_t*>(mem);
  if (memcmp(base, kMagic, 8) != 0) {
    munmap(mem, st.st_size);
    ::close(fd);
    return nullptr;
  }
  auto* p = new Pack();
  p->fd = fd;
  p->base = base;
  p->size = st.st_size;
  memcpy(&p->n, base + 8, 8);
  uint64_t index_off;
  memcpy(&index_off, base + 16, 8);
  if (index_off + p->n * sizeof(IndexEntry) > p->size) {
    munmap(mem, st.st_size);
    ::close(fd);
    delete p;
    return nullptr;
  }
  p->index = reinterpret_cast<const IndexEntry*>(base + index_off);
  p->keys = reinterpret_cast<const char*>(base + index_off +
                                          p->n * sizeof(IndexEntry));
  // advise the kernel about the access pattern: blobs random, index hot
  madvise(mem, st.st_size, MADV_RANDOM);
  return p;
}

int64_t rspk_count(void* h) {
  return h ? static_cast<int64_t>(static_cast<Pack*>(h)->n) : -1;
}

// binary search over the sorted key blob; returns entry index or -1
int64_t rspk_find(void* h, const char* key, uint32_t key_len) {
  if (!h) return -1;
  const Pack* p = static_cast<Pack*>(h);
  int64_t lo = 0, hi = static_cast<int64_t>(p->n) - 1;
  while (lo <= hi) {
    int64_t mid = lo + (hi - lo) / 2;
    const IndexEntry& e = p->index[mid];
    int c = key_cmp(p->keys + e.key_off, e.key_len, key, key_len);
    if (c == 0) return mid;
    if (c < 0)
      lo = mid + 1;
    else
      hi = mid - 1;
  }
  return -1;
}

// zero-copy blob pointer; returns 0 on success
int rspk_get(void* h, int64_t idx, const uint8_t** ptr, uint64_t* len) {
  if (!h) return -1;
  const Pack* p = static_cast<Pack*>(h);
  if (idx < 0 || static_cast<uint64_t>(idx) >= p->n) return -1;
  const IndexEntry& e = p->index[idx];
  if (e.data_off + e.data_len > p->size) return -2;
  *ptr = p->base + e.data_off;
  *len = e.data_len;
  return 0;
}

int rspk_key(void* h, int64_t idx, const char** ptr, uint32_t* len) {
  if (!h) return -1;
  const Pack* p = static_cast<Pack*>(h);
  if (idx < 0 || static_cast<uint64_t>(idx) >= p->n) return -1;
  const IndexEntry& e = p->index[idx];
  *ptr = p->keys + e.key_off;
  *len = e.key_len;
  return 0;
}

// prefetch a blob into the page cache (for loader lookahead threads)
int rspk_prefetch(void* h, int64_t idx) {
  if (!h) return -1;
  const Pack* p = static_cast<Pack*>(h);
  if (idx < 0 || static_cast<uint64_t>(idx) >= p->n) return -1;
  const IndexEntry& e = p->index[idx];
  if (e.data_off + e.data_len > p->size) return -2;
  long ps = sysconf(_SC_PAGESIZE);
  uintptr_t start = reinterpret_cast<uintptr_t>(p->base + e.data_off);
  uintptr_t aligned = start & ~static_cast<uintptr_t>(ps - 1);
  size_t span = (start - aligned) + e.data_len;
  return madvise(reinterpret_cast<void*>(aligned), span, MADV_WILLNEED);
}

void rspk_close(void* h) {
  if (!h) return;
  Pack* p = static_cast<Pack*>(h);
  if (p->base) munmap(const_cast<uint8_t*>(p->base), p->size);
  if (p->fd >= 0) ::close(p->fd);
  delete p;
}

}  // extern "C"
