// Shared-memory blocking byte queue — the native core of the multiprocess
// DataLoader path.
//
// Reference parity: the C++ side of paddle's DataLoader is
// paddle/fluid/operators/reader/lod_tensor_blocking_queue.h (a
// mutex+condvar bounded queue feeding the executor) plus shared-memory
// tensor transport for multiprocess workers
// (python/paddle/incubate/multiprocessing + core._array_to_share_memory_*).
// Here the two collapse into one primitive: a process-shared ring of bytes
// in POSIX shm, pthread mutex/condvars with PTHREAD_PROCESS_SHARED, with
// variable-length records. Workers (producers) serialize batches into it;
// the trainer process (consumer) pops them without a Python-level copy per
// worker hop.
//
// Exposed as a C ABI for ctypes. The same source as paddle_tpu/native/
// shm_queue.cpp, built by paddle_tpu_torch/native/build.py.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Header {
  uint64_t magic;
  uint64_t capacity;      // ring capacity in bytes
  uint64_t head;          // read offset  (consumer)
  uint64_t tail;          // write offset (producer)
  uint64_t used;          // bytes in ring
  uint64_t n_records;
  uint64_t user_seq;      // consumer progress marker (producer pacing)
  int32_t closed;
  int32_t poisoned;       // a peer died mid-commit; contents untrustworthy
  int32_t in_commit;      // set around header-field commits (crash fencing)
  pthread_mutex_t mu;
  pthread_cond_t not_empty;
  pthread_cond_t not_full;
  char data[];            // ring storage
};

constexpr uint64_t kMagic = 0x70647471756575ULL;  // "pdtqueu"

struct Handle {
  Header* h;
  uint64_t map_len;
  char name[256];
  bool owner;
};

void timespec_in(struct timespec* ts, long timeout_ms) {
  clock_gettime(CLOCK_MONOTONIC, ts);  // condvars use the monotonic clock
  ts->tv_sec += timeout_ms / 1000;
  ts->tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

// Offset-based ring copies that do NOT touch header bookkeeping: data is
// staged first, and head/tail/used/n_records are committed afterwards in
// one small fenced window (see in_commit). A producer killed mid-memcpy
// then leaves the header fully consistent — the staged bytes are simply
// unaccounted and get overwritten.
uint64_t ring_write_at(Header* h, uint64_t pos, const char* src,
                       uint64_t len) {
  uint64_t first = len < h->capacity - pos ? len : h->capacity - pos;
  memcpy(h->data + pos, src, first);
  if (len > first) memcpy(h->data, src + first, len - first);
  return (pos + len) % h->capacity;
}

uint64_t ring_read_at(const Header* h, uint64_t pos, char* dst,
                      uint64_t len) {
  uint64_t first = len < h->capacity - pos ? len : h->capacity - pos;
  memcpy(dst, h->data + pos, first);
  if (len > first) memcpy(dst + first, h->data, len - first);
  return (pos + len) % h->capacity;
}

}  // namespace

extern "C" {

// Create (owner=1) or open (owner=0) the queue. Returns NULL on failure.
void* sq_create(const char* name, uint64_t capacity, int owner) {
  uint64_t map_len = sizeof(Header) + capacity;
  int flags = owner ? (O_CREAT | O_RDWR | O_EXCL) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0 && owner && errno == EEXIST) {
    shm_unlink(name);
    fd = shm_open(name, flags, 0600);
  }
  if (fd < 0) return nullptr;
  if (owner && ftruncate(fd, (off_t)map_len) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  if (!owner) {
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
    map_len = (uint64_t)st.st_size;
  }
  void* mem = mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Header* h = (Header*)mem;
  if (owner) {
    memset(h, 0, sizeof(Header));
    h->capacity = capacity;
    pthread_mutexattr_t ma;
    pthread_mutexattr_init(&ma);
    pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&h->mu, &ma);
    pthread_condattr_t ca;
    pthread_condattr_init(&ca);
    pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
    pthread_condattr_setclock(&ca, CLOCK_MONOTONIC);
    pthread_cond_init(&h->not_empty, &ca);
    pthread_cond_init(&h->not_full, &ca);
    h->magic = kMagic;
  } else if (h->magic != kMagic) {
    munmap(mem, map_len);
    return nullptr;
  }
  Handle* hd = new Handle();
  hd->h = h;
  hd->map_len = map_len;
  hd->owner = owner != 0;
  strncpy(hd->name, name, sizeof(hd->name) - 1);
  return hd;
}

static int lock_robust(Header* h) {
  int rc = pthread_mutex_lock(&h->mu);
  if (rc == EOWNERDEAD) {  // a worker died holding the lock
    pthread_mutex_consistent(&h->mu);
    if (h->in_commit) {
      // Death landed inside a header commit: bookkeeping may be torn.
      // Poison rather than serve misaligned records.
      h->poisoned = 1;
      pthread_cond_broadcast(&h->not_empty);
      pthread_cond_broadcast(&h->not_full);
    }
    return 0;
  }
  return rc;
}

// cond_timedwait can also hand us the mutex of a dead owner (EOWNERDEAD);
// it must be marked consistent before any further wait/unlock, else the
// mutex becomes permanently ENOTRECOVERABLE. Returns 0 (keep waiting
// semantics of a spurious wake) or ETIMEDOUT.
static int timedwait_robust(pthread_cond_t* cv, Header* h,
                            const struct timespec* ts) {
  int rc = pthread_cond_timedwait(cv, &h->mu, ts);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&h->mu);
    if (h->in_commit) {
      h->poisoned = 1;
      pthread_cond_broadcast(&h->not_empty);
      pthread_cond_broadcast(&h->not_full);
    }
    return 0;
  }
  return rc;
}

// Push one record. Returns 0 ok, -1 timeout, -2 closed, -3 too large,
// -5 poisoned.
int sq_push(void* handle, const char* buf, uint64_t len, long timeout_ms) {
  Header* h = ((Handle*)handle)->h;
  uint64_t need = len + sizeof(uint64_t);
  if (need > h->capacity) return -3;
  struct timespec ts;
  timespec_in(&ts, timeout_ms);
  if (lock_robust(h) != 0) return -1;
  while (h->capacity - h->used < need && !h->closed && !h->poisoned) {
    if (timedwait_robust(&h->not_full, h, &ts) == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  if (h->poisoned || h->closed) {
    int out = h->poisoned ? -5 : -2;
    pthread_mutex_unlock(&h->mu);
    return out;
  }
  // Stage bytes first (crash here leaves the header consistent), then
  // commit the bookkeeping inside the in_commit fence.
  uint64_t pos = ring_write_at(h, h->tail, (const char*)&len,
                               sizeof(uint64_t));
  ring_write_at(h, pos, buf, len);
  h->in_commit = 1;
  h->tail = (h->tail + need) % h->capacity;
  h->used += need;
  h->n_records += 1;
  h->in_commit = 0;
  pthread_cond_signal(&h->not_empty);
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// Pop one record into buf (maxlen bytes). Returns record size, -1 timeout,
// -2 closed+empty, -4 buffer too small (record left in place), -5 poisoned.
int64_t sq_pop(void* handle, char* buf, uint64_t maxlen, long timeout_ms) {
  Header* h = ((Handle*)handle)->h;
  struct timespec ts;
  timespec_in(&ts, timeout_ms);
  if (lock_robust(h) != 0) return -1;
  while (h->n_records == 0 && !h->poisoned) {
    if (h->closed) {
      pthread_mutex_unlock(&h->mu);
      return -2;
    }
    if (timedwait_robust(&h->not_empty, h, &ts) == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  if (h->poisoned) {
    pthread_mutex_unlock(&h->mu);
    return -5;
  }
  uint64_t len;
  // Read without consuming (so -4 can retry with a bigger buf); the
  // header fields are only committed once the payload copy is done.
  uint64_t pos = ring_read_at(h, h->head, (char*)&len, sizeof(uint64_t));
  if (len > maxlen) {
    pthread_mutex_unlock(&h->mu);
    return -4;
  }
  ring_read_at(h, pos, buf, len);
  h->in_commit = 1;
  h->head = (h->head + len + sizeof(uint64_t)) % h->capacity;
  h->used -= len + sizeof(uint64_t);
  h->n_records -= 1;
  h->in_commit = 0;
  // Broadcast, not signal: with several producers and variable-length
  // records, a single wakeup can keep landing on one whose record still
  // doesn't fit, starving a producer whose smaller record would.
  pthread_cond_broadcast(&h->not_full);
  pthread_mutex_unlock(&h->mu);
  return (int64_t)len;
}

// --- consumer-progress marker (producer pacing) ---------------------------
// The trainer publishes how far it has consumed (e.g. next batch index);
// producers read it to bound how far ahead they run, which in turn bounds
// the consumer-side reorder buffer. Broadcast not_full doubles as the
// "progress advanced" wakeup for producers sleeping on it.

void sq_set_useq(void* handle, uint64_t v) {
  Header* h = ((Handle*)handle)->h;
  if (lock_robust(h) != 0) return;
  h->user_seq = v;
  pthread_cond_broadcast(&h->not_full);
  pthread_mutex_unlock(&h->mu);
}

uint64_t sq_get_useq(void* handle) {
  Header* h = ((Handle*)handle)->h;
  if (lock_robust(h) != 0) return 0;
  uint64_t v = h->user_seq;
  pthread_mutex_unlock(&h->mu);
  return v;
}

// Block until user_seq >= min_val (or closed / poisoned / timeout).
// Returns 0 ok, -1 timeout, -2 closed, -5 poisoned.
int sq_wait_useq(void* handle, uint64_t min_val, long timeout_ms) {
  Header* h = ((Handle*)handle)->h;
  struct timespec ts;
  timespec_in(&ts, timeout_ms);
  if (lock_robust(h) != 0) return -1;
  while (h->user_seq < min_val && !h->closed && !h->poisoned) {
    if (timedwait_robust(&h->not_full, h, &ts) == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  int out = h->poisoned ? -5 : (h->closed ? -2 : 0);
  pthread_mutex_unlock(&h->mu);
  return out;
}

// Size of the next record (for buffer allocation), -1 if empty.
int64_t sq_peek_size(void* handle) {
  Header* h = ((Handle*)handle)->h;
  if (lock_robust(h) != 0) return -1;
  int64_t out = -1;
  if (h->n_records > 0 && !h->poisoned) {
    uint64_t len;
    ring_read_at(h, h->head, (char*)&len, sizeof(uint64_t));
    out = (int64_t)len;
  }
  pthread_mutex_unlock(&h->mu);
  return out;
}

uint64_t sq_count(void* handle) {
  Header* h = ((Handle*)handle)->h;
  lock_robust(h);
  uint64_t n = h->n_records;
  pthread_mutex_unlock(&h->mu);
  return n;
}

void sq_shutdown(void* handle) {  // wake everyone; no more pushes
  Header* h = ((Handle*)handle)->h;
  lock_robust(h);
  h->closed = 1;
  pthread_cond_broadcast(&h->not_empty);
  pthread_cond_broadcast(&h->not_full);
  pthread_mutex_unlock(&h->mu);
}

void sq_close(void* handle) {
  Handle* hd = (Handle*)handle;
  bool owner = hd->owner;
  char name[256];
  strncpy(name, hd->name, sizeof(name));
  munmap(hd->h, hd->map_len);
  if (owner) shm_unlink(name);
  delete hd;
}

}  // extern "C"
