// Shared-memory SPSC ring buffer for DataLoader worker->main batch transfer.
//
// Reference parity: `fluid/memory/allocation/mmap_allocator.{h,cc}` +
// `fluid/operators/reader/blocking_queue.h` — the reference moves worker
// batches through shared memory with a C++ blocking queue; this is the same
// design as one POSIX-shm ring per worker process.
//
// Layout: [Header | data bytes].  Single producer (worker), single consumer
// (main process).  Messages are framed [u64 len | payload], wrapping at the
// end of the data region.  Lock-free: head/tail are C++11 atomics in shared
// memory; blocking sides spin with exponential nanosleep backoff.
//
// C ABI (consumed via ctypes from paddle_tpu_torch/io/shm_ring.py; a copy
// of the JAX package's `paddle_tpu/io/csrc/shm_ring.cc`, byte layout unchanged,
// so either package's ring attaches to the other's).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <errno.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

namespace {

struct Header {
  std::atomic<uint64_t> head;   // consumer position (bytes consumed)
  std::atomic<uint64_t> tail;   // producer position (bytes produced)
  std::atomic<uint32_t> closed; // producer hung up
  uint32_t _pad;
  uint64_t capacity;            // data-region size in bytes
};

struct Ring {
  Header* hdr;
  uint8_t* data;
  uint64_t map_len;
  int owner;
  char name[256];
};

inline uint64_t now_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000u + ts.tv_nsec / 1000000u;
}

inline void backoff(unsigned& spins) {
  if (spins < 64) {
    ++spins;
    return;                      // busy spin first
  }
  struct timespec ts = {0, spins < 1024 ? 50000 : 500000};  // 50us -> 500us
  nanosleep(&ts, nullptr);
  if (spins < 1024) spins *= 2;
}

// copy len bytes into the ring at logical position pos (wrapping)
inline void put_bytes(Ring* r, uint64_t pos, const void* src, uint64_t len) {
  uint64_t cap = r->hdr->capacity;
  uint64_t off = pos % cap;
  uint64_t first = len < cap - off ? len : cap - off;
  memcpy(r->data + off, src, first);
  if (len > first) memcpy(r->data, (const uint8_t*)src + first, len - first);
}

inline void get_bytes(Ring* r, uint64_t pos, void* dst, uint64_t len) {
  uint64_t cap = r->hdr->capacity;
  uint64_t off = pos % cap;
  uint64_t first = len < cap - off ? len : cap - off;
  memcpy(dst, r->data + off, first);
  if (len > first) memcpy((uint8_t*)dst + first, r->data, len - first);
}

Ring* open_ring(const char* name, uint64_t capacity, int create) {
  uint64_t map_len = sizeof(Header) + capacity;
  int flags = create ? (O_RDWR | O_CREAT | O_EXCL) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return nullptr;
  if (create && ftruncate(fd, (off_t)map_len) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  if (!create) {
    struct stat st;
    if (fstat(fd, &st) != 0 || (uint64_t)st.st_size < sizeof(Header)) {
      close(fd);
      return nullptr;
    }
    map_len = (uint64_t)st.st_size;
  }
  void* mem = mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Ring* r = new Ring();
  r->hdr = (Header*)mem;
  r->data = (uint8_t*)mem + sizeof(Header);
  r->map_len = map_len;
  r->owner = create;
  snprintf(r->name, sizeof(r->name), "%s", name);
  if (create) {
    r->hdr->head.store(0);
    r->hdr->tail.store(0);
    r->hdr->closed.store(0);
    r->hdr->capacity = capacity;
  }
  return r;
}

}  // namespace

extern "C" {

void* ring_create(const char* name, uint64_t capacity) {
  shm_unlink(name);  // stale segment from a crashed run
  return open_ring(name, capacity, 1);
}

void* ring_attach(const char* name) { return open_ring(name, 0, 0); }

// 0 ok; -1 timeout; -2 message larger than capacity; -3 closed
int ring_push(void* rv, const void* buf, uint64_t len, int timeout_ms) {
  Ring* r = (Ring*)rv;
  uint64_t need = len + 8;
  uint64_t cap = r->hdr->capacity;
  if (need > cap) return -2;
  uint64_t start = now_ms();
  unsigned spins = 0;
  for (;;) {
    uint64_t head = r->hdr->head.load(std::memory_order_acquire);
    uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
    if (cap - (tail - head) >= need) {
      uint64_t le = len;
      put_bytes(r, tail, &le, 8);
      put_bytes(r, tail + 8, buf, len);
      r->hdr->tail.store(tail + need, std::memory_order_release);
      return 0;
    }
    if (r->hdr->closed.load(std::memory_order_relaxed)) return -3;
    if (timeout_ms >= 0 && now_ms() - start > (uint64_t)timeout_ms) return -1;
    backoff(spins);
  }
}

// >=0: message length copied; -1 timeout; -2 out buffer too small (length
// returned via *need_out, message left in place); -3 closed and drained
long ring_pop(void* rv, void* out, uint64_t out_cap, int timeout_ms,
              uint64_t* need_out) {
  Ring* r = (Ring*)rv;
  uint64_t start = now_ms();
  unsigned spins = 0;
  for (;;) {
    uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
    uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
    if (tail - head >= 8) {
      uint64_t len;
      get_bytes(r, head, &len, 8);
      if (len > out_cap) {
        if (need_out) *need_out = len;
        return -2;
      }
      get_bytes(r, head + 8, out, len);
      r->hdr->head.store(head + 8 + len, std::memory_order_release);
      return (long)len;
    }
    if (r->hdr->closed.load(std::memory_order_relaxed)) return -3;
    if (timeout_ms >= 0 && now_ms() - start > (uint64_t)timeout_ms) return -1;
    backoff(spins);
  }
}

// peek the next message length without consuming (-1 if empty)
long ring_next_len(void* rv) {
  Ring* r = (Ring*)rv;
  uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
  uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
  if (tail - head < 8) return -1;
  uint64_t len;
  get_bytes(r, head, &len, 8);
  return (long)len;
}

void ring_close_producer(void* rv) {
  ((Ring*)rv)->hdr->closed.store(1, std::memory_order_release);
}

uint64_t ring_size(void* rv) {
  Ring* r = (Ring*)rv;
  return r->hdr->tail.load() - r->hdr->head.load();
}

void ring_free(void* rv, int unlink) {
  Ring* r = (Ring*)rv;
  munmap((void*)r->hdr, r->map_len);
  if (unlink) shm_unlink(r->name);
  delete r;
}

}  // extern "C"
