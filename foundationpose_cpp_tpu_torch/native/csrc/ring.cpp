// Single-producer single-consumer frame ring for the async tracking loop.
//
// The port's own copy of the ring of foundationpose_cpp_tpu's native
// runtime (the reference's async_pipeline / IPipelinePackage role): a camera
// thread deposits frames while the tracking thread consumes the newest,
// dropping stale ones. Plain C ABI, loaded through ctypes.

#include <atomic>
#include <cstdint>
#include <cstring>

extern "C" {

// Ownership: `head` is producer-owned, `tail` is consumer-owned -- neither
// side ever stores the other's index.  The producer never blocks: when the
// ring is full it simply overwrites the oldest slot (drop-oldest real-time
// policy).  Torn reads are prevented by a per-slot seqlock: the producer
// marks a slot odd while writing, and the consumer re-validates the
// sequence after its memcpy, retrying on a newer frame if the producer
// lapped it mid-copy.
struct FpRing {
  uint8_t* storage;
  std::atomic<uint64_t>* seq;  // per-slot seqlock; odd = write in progress
  int64_t frame_bytes;
  int64_t capacity;
  std::atomic<int64_t> head;  // next write index (producer-owned)
  std::atomic<int64_t> tail;  // next read index (consumer-owned)
  std::atomic<int64_t> dropped;
};

FpRing* fp_ring_create(int64_t frame_bytes, int64_t capacity) try {
  // capacity 0 would make every push/pop compute `x % 0` (SIGFPE); a
  // negative value corrupts the allocation size
  if (frame_bytes <= 0 || capacity <= 0) return nullptr;
  auto* r = new FpRing();
  r->storage = new uint8_t[frame_bytes * capacity];
  r->seq = new std::atomic<uint64_t>[capacity];
  for (int64_t i = 0; i < capacity; ++i) r->seq[i].store(0);
  r->frame_bytes = frame_bytes;
  r->capacity = capacity;
  r->head.store(0);
  r->tail.store(0);
  r->dropped.store(0);
  return r;
} catch (...) {
  return nullptr;  // bad_alloc must not cross into ctypes
}

void fp_ring_destroy(FpRing* r) {
  if (!r) return;
  delete[] r->storage;
  delete[] r->seq;
  delete r;
}

// producer: push a frame; overwrites the oldest when full (drop-oldest
// real-time policy, counted in `dropped`).  Never touches `tail`.
void fp_ring_push(FpRing* r, const uint8_t* frame) {
  int64_t h = r->head.load(std::memory_order_relaxed);
  int64_t t = r->tail.load(std::memory_order_acquire);
  if (h - t >= r->capacity)
    r->dropped.fetch_add(1, std::memory_order_relaxed);  // oldest overwritten
  int64_t slot = h % r->capacity;
  uint64_t s0 = r->seq[slot].load(std::memory_order_relaxed);
  r->seq[slot].store(s0 + 1, std::memory_order_relaxed);  // odd: writing
  std::atomic_thread_fence(std::memory_order_seq_cst);
  memcpy(r->storage + slot * r->frame_bytes, frame, (size_t)r->frame_bytes);
  std::atomic_thread_fence(std::memory_order_seq_cst);
  r->seq[slot].store(s0 + 2, std::memory_order_release);  // even: stable
  r->head.store(h + 1, std::memory_order_release);
}

// consumer: pop the NEWEST frame (skipping stale ones); returns number of
// frames skipped, or -1 if empty.  Seqlock-validated against mid-copy
// overwrite by a wrapping producer.
int64_t fp_ring_pop_latest(FpRing* r, uint8_t* out) {
  int64_t t = r->tail.load(std::memory_order_relaxed);
  for (int attempt = 0; attempt < 1024; ++attempt) {
    int64_t h = r->head.load(std::memory_order_acquire);
    if (t >= h) return -1;
    int64_t newest = h - 1;
    int64_t slot = newest % r->capacity;
    uint64_t s1 = r->seq[slot].load(std::memory_order_acquire);
    if (s1 & 1) continue;  // producer mid-write on this slot; re-read head
    memcpy(out, r->storage + slot * r->frame_bytes, (size_t)r->frame_bytes);
    std::atomic_thread_fence(std::memory_order_seq_cst);
    uint64_t s2 = r->seq[slot].load(std::memory_order_acquire);
    if (s1 == s2) {  // copy is coherent: slot untouched during memcpy
      r->tail.store(h, std::memory_order_release);
      return newest - t;  // frames skipped (incl. any overwritten)
    }
    // torn: producer lapped us mid-copy; retry against a fresher head
  }
  return -1;  // producer stalled mid-write; treat as empty
}

int64_t fp_ring_size(FpRing* r) {
  int64_t n = r->head.load(std::memory_order_acquire) -
              r->tail.load(std::memory_order_acquire);
  if (n < 0) n = 0;
  return n > r->capacity ? r->capacity : n;
}

int64_t fp_ring_dropped(FpRing* r) { return r->dropped.load(); }

}  // extern "C"
