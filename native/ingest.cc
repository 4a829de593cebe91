// Host-side ingest: SPSC ring buffer + u8->i8 conversion + fs/4 mixer.
//
// Native equivalent of the reference's USB-callback hot path state
// management (/root/reference/rtlsdr_ft8d.c:76-202 + the double buffer
// h:91-107) — but with an explicit lock-free single-producer single-
// consumer ring instead of the reference's timing-based buffer ownership
// (a data race by design, SURVEY.md §5). The producer is the SDR callback
// (or file/socket reader); the consumer drains full 15-s windows for the
// device decimator. The fs/4 mixer runs here on int8 exactly like the
// reference's XOR trick (c:116-140): multiply by {1,-j,-1,j} is sign flips
// and I/Q swaps, staying int8 end to end.

#include <atomic>
#include <cstdint>
#include <cstring>

namespace {

struct Ring {
  int8_t* i_buf;
  int8_t* q_buf;
  size_t capacity;                  // samples (power of two)
  std::atomic<uint64_t> head;       // written samples
  std::atomic<uint64_t> tail;       // consumed samples
  std::atomic<uint64_t> dropped;    // producer samples lost to a full ring
  uint64_t mixer_phase;             // absolute sample index mod 4
};

}  // namespace

extern "C" {

void* ingest_ring_create(size_t capacity_samples) {
  Ring* r = new Ring();
  size_t cap = 1;
  while (cap < capacity_samples) cap <<= 1;
  r->i_buf = new int8_t[cap];
  r->q_buf = new int8_t[cap];
  r->capacity = cap;
  r->head = 0;
  r->tail = 0;
  r->dropped = 0;
  r->mixer_phase = 0;
  return r;
}

void ingest_ring_destroy(void* ring) {
  Ring* r = static_cast<Ring*>(ring);
  delete[] r->i_buf;
  delete[] r->q_buf;
  delete r;
}

// Producer: push interleaved unsigned-8 IQ (RTL-SDR native format),
// converting to signed and applying the fs/4 down-shift:
//   out = in * e^{-j*pi/2*n} with pattern n%4: (i,q) -> (i,q), (q,-i),
//   (-i,-q), (-q,i).
// Returns samples accepted (may be < count if the ring is full).
size_t ingest_ring_push_u8(void* ring, const uint8_t* iq_interleaved,
                           size_t count_samples) {
  Ring* r = static_cast<Ring*>(ring);
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  size_t free_samples = r->capacity - static_cast<size_t>(head - tail);
  if (count_samples > free_samples) {
    // overrun: the consumer detects the advance of `dropped` and resyncs
    // to the next UTC boundary (samples lost = windows shifted)
    r->dropped.fetch_add(count_samples - free_samples,
                         std::memory_order_relaxed);
    count_samples = free_samples;
  }

  uint64_t phase = r->mixer_phase;
  const size_t mask = r->capacity - 1;
  // negate with saturation: -(-128) wraps back to -128 in int8, which
  // would flip the sign of every ADC-rail (clipped) sample
  auto neg = [](int8_t v) -> int8_t {
    return v == -128 ? 127 : static_cast<int8_t>(-v);
  };
  for (size_t k = 0; k < count_samples; ++k) {
    int8_t i = static_cast<int8_t>(iq_interleaved[2 * k] - 128);
    int8_t q = static_cast<int8_t>(iq_interleaved[2 * k + 1] - 128);
    int8_t oi, oq;
    switch (phase & 3) {
      case 0: oi = i;  oq = q;  break;
      case 1: oi = q;  oq = neg(i); break;
      case 2: oi = neg(i); oq = neg(q); break;
      default: oi = neg(q); oq = i;  break;
    }
    size_t pos = static_cast<size_t>(head + k) & mask;
    r->i_buf[pos] = oi;
    r->q_buf[pos] = oq;
    ++phase;
  }
  r->mixer_phase = phase;
  r->head.store(head + count_samples, std::memory_order_release);
  return count_samples;
}

// Consumer: pop up to count samples into separate i/q arrays.
// Returns samples copied.
size_t ingest_ring_pop(void* ring, int8_t* i_out, int8_t* q_out,
                       size_t count_samples) {
  Ring* r = static_cast<Ring*>(ring);
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  size_t avail = static_cast<size_t>(head - tail);
  if (count_samples > avail) count_samples = avail;
  const size_t mask = r->capacity - 1;
  for (size_t k = 0; k < count_samples; ++k) {
    size_t pos = static_cast<size_t>(tail + k) & mask;
    i_out[k] = r->i_buf[pos];
    q_out[k] = r->q_buf[pos];
  }
  r->tail.store(tail + count_samples, std::memory_order_release);
  return count_samples;
}

size_t ingest_ring_available(void* ring) {
  Ring* r = static_cast<Ring*>(ring);
  return static_cast<size_t>(
      r->head.load(std::memory_order_acquire) -
      r->tail.load(std::memory_order_acquire));
}

// Consumer: advance tail without copying (UTC-boundary flush — the
// analogue of the reference's iqIndex reset at rtlsdr_ft8d.c:1349-1352).
// Returns samples discarded.
size_t ingest_ring_discard(void* ring, size_t count_samples) {
  Ring* r = static_cast<Ring*>(ring);
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  size_t avail = static_cast<size_t>(head - tail);
  if (count_samples > avail) count_samples = avail;
  r->tail.store(tail + count_samples, std::memory_order_release);
  return count_samples;
}

// Cumulative count of producer samples dropped on ring-full.
uint64_t ingest_ring_dropped(void* ring) {
  return static_cast<Ring*>(ring)->dropped.load(std::memory_order_relaxed);
}

}  // extern "C"
