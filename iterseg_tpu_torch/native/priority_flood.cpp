// Native priority-flood watershed kernel.
//
// One kernel serves both flood variants the framework needs:
//  * affinity mode  — re-derivation of iterseg watershed.py:95-159
//    (raveled_affinity_watershed): pushed value = affinity of the crossed
//    edge, seeds pushed with value 0.
//  * image mode     — skimage.segmentation.watershed semantics
//    (connectivity 1, compactness 0): pushed value = image value at the
//    claimed voxel, seeds pushed with the image value at the seed.
//
// Exact heap-order semantics: elements pop in the order of (value, age,
// index) compared lexicographically; ages increase monotonically with
// pushes so insertion order breaks value ties, and index breaks the
// initial all-age-zero seed ties — identical to Python heapq over
// Element(value, age, index, source).
//
// Claim-at-push: when an element pops, every in-mask unlabelled neighbour
// immediately takes its label and is enqueued. This is the sequential hot
// loop of inference; it runs on host while the GPU computes the next
// frame's feature maps.
//
// Two implementations of that one order:
//  * the bucketed queue (``queue_flood``, the default): 16-byte elements
//    keyed by one uint64, ``order_bits(value) << 32 | age``, in buckets by
//    the key's high bits, each sorted once when it becomes the lowest
//    (``BucketQueue``); one int32 state array (-1 outside the mask, 0
//    unlabelled, else the label) in place of the mask and output reads; a
//    prefetch of the neighbourhood of the element that pops next. Seeds
//    take ages 0..S-1 in order of voxel index and pushes ages from S up, so
//    the key order is the (value, age, index) order wherever that
//    comparator is a strict weak order.
//  * the binary heap over (float value, int64 age, int64 index)
//    (``heap_flood``): the fallback, taken where that comparator is not a
//    strict weak order (a NaN value), where a label is at or below 0 (the
//    state array's codes), or where the voxel count or the ages do not fit
//    in 32 bits; and the oracle the queue is tested against.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Elem {
  float value;
  int64_t age;
  int64_t index;
};

inline bool greater_than(const Elem& a, const Elem& b) {
  if (a.value != b.value) return a.value > b.value;
  if (a.age != b.age) return a.age > b.age;
  return a.index > b.index;
}

// Hand-rolled binary min-heap over a preallocated vector: ~2x faster than
// std::priority_queue for this workload (no indirection, reserve once).
class MinHeap {
 public:
  explicit MinHeap(size_t reserve) { data_.reserve(reserve); }

  bool empty() const { return data_.empty(); }
  size_t size() const { return data_.size(); }

  void push(Elem e) {
    data_.push_back(e);
    size_t i = data_.size() - 1;
    while (i > 0) {
      size_t parent = (i - 1) >> 1;
      if (greater_than(data_[parent], data_[i])) {
        Elem tmp = data_[parent];
        data_[parent] = data_[i];
        data_[i] = tmp;
        i = parent;
      } else {
        break;
      }
    }
  }

  Elem pop() {
    Elem top = data_[0];
    data_[0] = data_.back();
    data_.pop_back();
    size_t n = data_.size();
    size_t i = 0;
    while (true) {
      size_t l = 2 * i + 1;
      size_t r = l + 1;
      size_t smallest = i;
      if (l < n && greater_than(data_[smallest], data_[l])) smallest = l;
      if (r < n && greater_than(data_[smallest], data_[r])) smallest = r;
      if (smallest == i) break;
      Elem tmp = data_[smallest];
      data_[smallest] = data_[i];
      data_[i] = tmp;
      i = smallest;
    }
    return top;
  }

 private:
  std::vector<Elem> data_;
};

// The heap flood over the caller's mask and pre-seeded output; returns the
// largest number of elements the heap held.
int64_t heap_flood(const float* values, const int64_t* offsets,
                   const int64_t* val_chan, const int64_t* val_off,
                   int32_t n_nbr, const int64_t* markers, int64_t n_markers,
                   const float* seed_values, const uint8_t* mask,
                   int32_t* output, int64_t n) {
  MinHeap heap(static_cast<size_t>(n_markers) + 1024);
  for (int64_t i = 0; i < n_markers; ++i) {
    heap.push(Elem{seed_values[i], 0, markers[i]});
  }
  size_t peak = heap.size();
  int64_t age = 0;
  while (!heap.empty()) {
    Elem e = heap.pop();
    int32_t lab = output[e.index];
    for (int32_t k = 0; k < n_nbr; ++k) {
      int64_t nbr = e.index + offsets[k];
      if (nbr < 0 || nbr >= n) continue;
      if (!mask[nbr]) continue;
      if (output[nbr]) continue;
      output[nbr] = lab;
      float v = values[val_chan[k] * n + e.index + val_off[k]];
      ++age;
      heap.push(Elem{v, age, nbr});
    }
    peak = std::max(peak, heap.size());
  }
  return static_cast<int64_t>(peak);
}

// A uint32 whose unsigned order is the float's order, with -0.0 taken as
// +0.0 (they compare equal): the sign bit set for non-negatives, every bit
// flipped for negatives.
inline uint32_t order_bits(float v) {
  uint32_t b;
  std::memcpy(&b, &v, sizeof b);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

struct QElem {
  uint64_t key;  // order_bits(value) << 32 | age
  uint32_t index;
};

// Min-queue of QElem in 2^16 buckets by the key's top 16 bits (sign,
// exponent and 7 mantissa bits: 128 buckets a binade). A bucket fills as a
// run in push order, which is age order. When it becomes the lowest
// non-empty bucket it is sorted once, by a stable radix sort on the 16
// order bits under the bucket's (ages keep their order), and consumed from
// the front; an element pushed into it after that goes to the bucket's
// heap, and pops take the lower of the run's front and the heap's top. A
// two-level bitmap of the non-empty buckets finds the next one; a push
// below the lowest moves ``cur_`` down.
class BucketQueue {
 public:
  static constexpr int kBits = 16;
  static constexpr uint32_t kBuckets = 1u << kBits;
  static constexpr size_t kRadixMin = 256;  // std::sort below this

  BucketQueue() : buckets_(kBuckets), words_(kBuckets / 64, 0), top_{} {}

  bool empty() const { return size_ == 0; }
  size_t size() const { return size_; }

  void push(QElem e) {
    const uint32_t b = static_cast<uint32_t>(e.key >> (64 - kBits));
    Bucket& bucket = buckets_[b];
    if (bucket.sorted) {
      heap_push(bucket.heap, e);
    } else {
      if (bucket.run.empty()) mark(b);
      bucket.run.push_back(e);
    }
    ++size_;
  }

  // The element that pops next (the queue must not be empty).
  const QElem& peek() {
    Bucket& bucket = lowest();
    return from_run(bucket) ? bucket.run[bucket.head] : bucket.heap[0];
  }

  QElem pop() {
    Bucket& bucket = lowest();
    const QElem top =
        from_run(bucket) ? bucket.run[bucket.head++] : heap_pop(bucket.heap);
    if (bucket.head == bucket.run.size() && bucket.heap.empty()) {
      bucket.run.clear();
      bucket.head = 0;
      bucket.sorted = false;
      const uint32_t b = cur_;
      words_[b >> 6] &= ~(1ull << (b & 63));
      if (words_[b >> 6] == 0) top_[b >> 12] &= ~(1ull << ((b >> 6) & 63));
      cur_ = next_bucket(b);
    }
    --size_;
    return top;
  }

 private:
  struct Bucket {
    std::vector<QElem> run;   // push order, or sorted from ``head`` on
    std::vector<QElem> heap;  // pushes after the run was sorted
    size_t head = 0;
    bool sorted = false;
  };

  void mark(uint32_t b) {
    words_[b >> 6] |= 1ull << (b & 63);
    top_[b >> 12] |= 1ull << ((b >> 6) & 63);
    if (b < cur_) cur_ = b;
  }

  Bucket& lowest() {
    Bucket& bucket = buckets_[cur_];
    if (!bucket.sorted) sort_run(bucket);
    return bucket;
  }

  static bool from_run(const Bucket& bucket) {
    return bucket.head < bucket.run.size() &&
           (bucket.heap.empty() ||
            bucket.run[bucket.head].key < bucket.heap[0].key);
  }

  void sort_run(Bucket& bucket) {
    std::vector<QElem>& run = bucket.run;
    const size_t m = run.size();
    if (m < kRadixMin) {
      std::sort(run.begin(), run.end(),
                [](const QElem& a, const QElem& b) { return a.key < b.key; });
    } else {
      tmp_.resize(m);
      for (int shift = 32; shift < 64 - kBits; shift += 8) {
        size_t count[257] = {};
        for (size_t i = 0; i < m; ++i) {
          ++count[((run[i].key >> shift) & 255) + 1];
        }
        for (int d = 0; d < 256; ++d) count[d + 1] += count[d];
        for (size_t i = 0; i < m; ++i)
          tmp_[count[(run[i].key >> shift) & 255]++] = run[i];
        run.swap(tmp_);
      }
    }
    bucket.sorted = true;
    bucket.head = 0;
  }

  static bool later(const QElem& a, const QElem& b) { return a.key > b.key; }

  static void heap_push(std::vector<QElem>& h, QElem e) {
    h.push_back(e);
    std::push_heap(h.begin(), h.end(), later);
  }

  static QElem heap_pop(std::vector<QElem>& h) {
    std::pop_heap(h.begin(), h.end(), later);
    const QElem top = h.back();
    h.pop_back();
    return top;
  }

  // The lowest non-empty bucket above ``b`` (kBuckets when none is).
  uint32_t next_bucket(uint32_t b) const {
    uint32_t w = b >> 6;
    const uint64_t bits = words_[w] & (~1ull << (b & 63));
    if (bits) return (w << 6) | __builtin_ctzll(bits);
    ++w;
    for (uint32_t t = w >> 6; t < kBuckets / 4096; ++t) {
      uint64_t words = top_[t];
      if (t == (w >> 6)) words &= ~0ull << (w & 63);
      if (words) {
        w = (t << 6) | __builtin_ctzll(words);
        return (w << 6) | __builtin_ctzll(words_[w]);
      }
    }
    return kBuckets;
  }

  std::vector<Bucket> buckets_;
  std::vector<uint64_t> words_;    // bit b: bucket b is not empty
  uint64_t top_[kBuckets / 4096];  // bit w: words_[w] is not zero
  std::vector<QElem> tmp_;         // the radix sort's other buffer
  uint32_t cur_ = kBuckets;
  size_t size_ = 0;
};

// The bucketed-queue flood; returns the largest number of elements the
// queue held, or -1 without a label written where the heap has to run.
int64_t queue_flood(const float* values, const int64_t* offsets,
                    const int64_t* val_chan, const int64_t* val_off,
                    int32_t n_nbr, const int64_t* markers, int64_t n_markers,
                    const float* seed_values, const uint8_t* mask,
                    int32_t* output, int64_t n) {
  if (n > (int64_t{1} << 32) - n_markers) return -1;
  for (int64_t i = 0; i < n_markers; ++i) {
    if (std::isnan(seed_values[i]) || output[markers[i]] <= 0) return -1;
  }
  // the state, in place: -1 outside the mask, 0 unlabelled, else the
  // label; the caller's labels are kept to restore its output. Blocks
  // without a label take the vectorised path.
  std::vector<std::pair<int64_t, int32_t>> seeded;
  seeded.reserve(static_cast<size_t>(n_markers));
  constexpr int64_t kBlock = 64;
  for (int64_t i0 = 0; i0 < n; i0 += kBlock) {
    const int64_t i1 = std::min(i0 + kBlock, n);
    int32_t any = 0;
    for (int64_t i = i0; i < i1; ++i) any |= output[i];
    if (any == 0) {
      for (int64_t i = i0; i < i1; ++i) output[i] = (mask[i] != 0) - 1;
      continue;
    }
    for (int64_t i = i0; i < i1; ++i) {
      const int32_t o = output[i];
      if (o > 0) {
        seeded.emplace_back(i, o);
      } else if (o == 0) {
        output[i] = (mask[i] != 0) - 1;
      } else {
        for (int64_t j = 0; j < i; ++j) output[j] = std::max(output[j], 0);
        return -1;
      }
    }
  }
  int32_t* state = output;

  std::vector<int64_t> off(static_cast<size_t>(n_nbr));
  std::vector<const float*> vbase(static_cast<size_t>(n_nbr));
  for (int32_t k = 0; k < n_nbr; ++k) {
    off[k] = offsets[k];
    vbase[k] = values + val_chan[k] * n + val_off[k];
  }

  BucketQueue queue;
  std::vector<int64_t> order(static_cast<size_t>(n_markers));
  std::iota(order.begin(), order.end(), int64_t{0});
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return markers[a] < markers[b];
  });
  uint32_t age = 0;
  for (const int64_t i : order) {
    queue.push(QElem{uint64_t{order_bits(seed_values[i])} << 32 | age++,
                     static_cast<uint32_t>(markers[i])});
  }
  size_t peak = queue.size();
  while (!queue.empty()) {
    const QElem e = queue.pop();
    const int64_t idx = e.index;
    if (!queue.empty()) {
      const int64_t next = queue.peek().index;
      for (int32_t k = 0; k < n_nbr; ++k) {
        __builtin_prefetch(state + next + off[k]);
        __builtin_prefetch(vbase[k] + next);
      }
    }
    const int32_t lab = state[idx];
    for (int32_t k = 0; k < n_nbr; ++k) {
      const int64_t nbr = idx + off[k];
      if (nbr < 0 || nbr >= n) continue;
      if (state[nbr]) continue;
      const float v = vbase[k][idx];
      if (std::isnan(v)) {  // restore the caller's output for the heap
        std::memset(output, 0, static_cast<size_t>(n) * sizeof(int32_t));
        for (const auto& s : seeded) output[s.first] = s.second;
        return -1;
      }
      state[nbr] = lab;
      queue.push(QElem{uint64_t{order_bits(v)} << 32 | age++,
                       static_cast<uint32_t>(nbr)});
    }
    peak = std::max(peak, queue.size());
  }
  for (int64_t i = 0; i < n; ++i) output[i] = std::max(output[i], 0);
  return static_cast<int64_t>(peak);
}

}  // namespace

extern "C" {

// values:     (n_chan, n) row-major raveled value channels
// offsets:    (n_nbr,) signed raveled neighbour offsets
// val_chan:   (n_nbr,) value channel per direction
// val_off:    (n_nbr,) value sample offset added to the POPPED index
// markers:    (n_markers,) raveled seed indices; output must be pre-seeded
// seed_values:(n_markers,) heap value for each seed push
// mask:       (n,) uint8; border ring must be 0 (callers pad)
// output:     (n,) int32 labels, pre-seeded at markers
//
// Runs the bucketed queue, or the heap where the queue cannot keep the
// order (a NaN value, a label at or below 0 at a marker or below 0
// anywhere, more than 2^32 voxels and seeds). Returns the largest number
// of elements the queue held, or -1 - the heap's largest where the heap
// ran.
int64_t priority_flood(const float* values, const int64_t* offsets,
                       const int64_t* val_chan, const int64_t* val_off,
                       int32_t n_nbr, const int64_t* markers,
                       int64_t n_markers, const float* seed_values,
                       const uint8_t* mask, int32_t* output, int64_t n) {
  const int64_t peak =
      queue_flood(values, offsets, val_chan, val_off, n_nbr, markers,
                  n_markers, seed_values, mask, output, n);
  if (peak >= 0) return peak;
  return -1 - heap_flood(values, offsets, val_chan, val_off, n_nbr, markers,
                         n_markers, seed_values, mask, output, n);
}

// The heap alone: the fallback's code, as the oracle of ``priority_flood``.
// Returns the largest number of elements the heap held.
int64_t priority_flood_heap(const float* values, const int64_t* offsets,
                            const int64_t* val_chan, const int64_t* val_off,
                            int32_t n_nbr, const int64_t* markers,
                            int64_t n_markers, const float* seed_values,
                            const uint8_t* mask, int32_t* output, int64_t n) {
  return heap_flood(values, offsets, val_chan, val_off, n_nbr, markers,
                    n_markers, seed_values, mask, output, n);
}

}  // extern "C"

extern "C" {

// 6-connectivity connected components over a raveled 3D mask, labels
// assigned in raster-scan order of first occurrence (scipy.ndimage.label
// numbering). BFS flood per component. Returns the number of labels.
int32_t label_cc6(const uint8_t* mask, int32_t* labels, int64_t nz,
                  int64_t ny, int64_t nx) {
  const int64_t n = nz * ny * nx;
  const int64_t sy = nx;
  const int64_t sz = ny * nx;
  std::vector<int64_t> queue;
  queue.reserve(4096);
  int32_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!mask[i] || labels[i]) continue;
    ++next;
    labels[i] = next;
    queue.clear();
    queue.push_back(i);
    while (!queue.empty()) {
      int64_t v = queue.back();
      queue.pop_back();
      int64_t z = v / sz;
      int64_t rem = v - z * sz;
      int64_t y = rem / nx;
      int64_t x = rem - y * nx;
      const int64_t nbrs[6] = {v - sz, v - sy, v - 1, v + 1, v + sy, v + sz};
      const bool ok[6] = {z > 0, y > 0, x > 0, x < nx - 1, y < ny - 1,
                          z < nz - 1};
      for (int k = 0; k < 6; ++k) {
        if (!ok[k]) continue;
        int64_t u = nbrs[k];
        if (mask[u] && !labels[u]) {
          labels[u] = next;
          queue.push_back(u);
        }
      }
    }
  }
  return next;
}

// Greedy Chebyshev minimum-spacing rejection over priority-ordered integer
// coordinates (skimage ensure_spacing semantics, p_norm=inf): accept a
// candidate iff no previously accepted candidate lies within `spacing`.
// Grid-hashed for O(n); writes keep flags.
void ensure_spacing_cheb(const int64_t* coords, int64_t n, int64_t ndim,
                         int64_t spacing, uint8_t* keep) {
  if (n == 0) return;
  const int64_t cell_size = spacing > 0 ? spacing : 1;
  // open-addressing hash of cell -> chain of accepted point indices
  struct Node {
    int64_t point;
    int64_t next;
  };
  std::vector<Node> nodes;
  nodes.reserve(static_cast<size_t>(n));
  size_t buckets = 1;
  while (buckets < static_cast<size_t>(2 * n + 16)) buckets <<= 1;
  std::vector<int64_t> head(buckets, -1);
  auto cell_hash = [&](const int64_t* c) -> size_t {
    size_t h = 1469598103934665603ull;
    for (int64_t d = 0; d < ndim; ++d) {
      int64_t q = c[d] >= 0 ? c[d] / cell_size : -((-c[d] - 1) / cell_size) - 1;
      h ^= static_cast<size_t>(q) + 0x9e3779b97f4a7c15ull + (h << 6) +
           (h >> 2);
    }
    return h & (buckets - 1);
  };
  std::vector<int64_t> cell(static_cast<size_t>(ndim));
  for (int64_t i = 0; i < n; ++i) {
    const int64_t* c = coords + i * ndim;
    bool conflict = false;
    // scan all neighbour cells (3^ndim)
    int64_t n_cells = 1;
    for (int64_t d = 0; d < ndim; ++d) n_cells *= 3;
    for (int64_t t = 0; t < n_cells && !conflict; ++t) {
      int64_t tt = t;
      for (int64_t d = 0; d < ndim; ++d) {
        int64_t off = (tt % 3) - 1;
        tt /= 3;
        int64_t q = c[d] >= 0 ? c[d] / cell_size
                              : -((-c[d] - 1) / cell_size) - 1;
        cell[static_cast<size_t>(d)] = (q + off) * cell_size;
      }
      size_t h = cell_hash(cell.data());
      for (int64_t node = head[h]; node != -1 && !conflict;
           node = nodes[static_cast<size_t>(node)].next) {
        const int64_t* p =
            coords + nodes[static_cast<size_t>(node)].point * ndim;
        int64_t dmax = 0;
        for (int64_t d = 0; d < ndim; ++d) {
          int64_t diff = p[d] > c[d] ? p[d] - c[d] : c[d] - p[d];
          if (diff > dmax) dmax = diff;
        }
        if (dmax <= spacing) conflict = true;
      }
    }
    if (conflict) {
      keep[i] = 0;
      continue;
    }
    keep[i] = 1;
    size_t h = cell_hash(c);
    nodes.push_back(Node{i, head[h]});
    head[h] = static_cast<int64_t>(nodes.size() - 1);
  }
}

}  // extern "C"

extern "C" {

// Fused size-band filter: 6-connectivity components of `mask`, then zero
// every voxel whose component size is outside [min_area, max_area).
// In-place on mask; scratch labels buffer provided by caller (int32, same
// size, zero-initialised). Single BFS pass + one linear rewrite.
void band_filter_cc6(uint8_t* mask, int32_t* labels, int64_t nz, int64_t ny,
                     int64_t nx, int64_t min_area, int64_t max_area) {
  const int64_t n = nz * ny * nx;
  const int64_t sy = nx;
  const int64_t sz = ny * nx;
  std::vector<int64_t> queue;
  queue.reserve(4096);
  std::vector<int64_t> sizes;
  sizes.push_back(0);  // background
  int32_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!mask[i] || labels[i]) continue;
    ++next;
    int64_t count = 0;
    labels[i] = next;
    queue.clear();
    queue.push_back(i);
    ++count;
    while (!queue.empty()) {
      int64_t v = queue.back();
      queue.pop_back();
      int64_t z = v / sz;
      int64_t rem = v - z * sz;
      int64_t y = rem / nx;
      int64_t x = rem - y * nx;
      const int64_t nbrs[6] = {v - sz, v - sy, v - 1, v + 1, v + sy, v + sz};
      const bool ok[6] = {z > 0, y > 0, x > 0, x < nx - 1, y < ny - 1,
                          z < nz - 1};
      for (int k = 0; k < 6; ++k) {
        if (!ok[k]) continue;
        int64_t u = nbrs[k];
        if (mask[u] && !labels[u]) {
          labels[u] = next;
          queue.push_back(u);
          ++count;
        }
      }
    }
    sizes.push_back(count);
  }
  for (int64_t i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    int64_t s = sizes[static_cast<size_t>(labels[i])];
    if (s < min_area || s >= max_area) mask[i] = 0;
  }
}

// Bucketed image-mode priority flood for DISCRETE priorities.
//
// The DoG/EDT watershed floods with priority -sqrt(d^2) where d^2 is an
// exact integer: the priority ORDER is exactly descending d^2. A bucket
// queue over d^2 reproduces the (value, age, index) min-heap order
// precisely — buckets processed from the largest key down (most negative
// -sqrt first), FIFO within a bucket (ages increase monotonically with
// pushes, and the all-age-zero seeds arrive pre-sorted by index), with
// the cursor jumping back up when a push lands above it (exactly when the
// heap would pop that element next). O(n + max_key) instead of
// O(n log n): ~10x the heap on dense EDT masks.
//
// keys:    (n,) int32 d^2 per voxel; only read at in-mask voxels
// offsets: (n_nbr,) signed raveled neighbour offsets
// markers: (n_markers,) raveled seed indices ASCENDING; output pre-seeded
// mask:    (n,) uint8; border ring must be 0
// output:  (n,) int32 labels, pre-seeded at markers
void bucket_flood_image(const int32_t* keys, const int64_t* offsets,
                        int32_t n_nbr, const int64_t* markers,
                        int64_t n_markers, const uint8_t* mask,
                        int32_t* output, int64_t n) {
  int32_t max_key = 0;
  for (int64_t i = 0; i < n_markers; ++i) {
    if (keys[markers[i]] > max_key) max_key = keys[markers[i]];
  }
  for (int64_t i = 0; i < n; ++i) {
    if (mask[i] && keys[i] > max_key) max_key = keys[i];
  }
  std::vector<std::vector<int64_t>> buckets(
      static_cast<size_t>(max_key) + 1);
  std::vector<size_t> heads(static_cast<size_t>(max_key) + 1, 0);
  for (int64_t i = 0; i < n_markers; ++i) {
    buckets[static_cast<size_t>(keys[markers[i]])].push_back(markers[i]);
  }
  int64_t cb = max_key;
  while (cb >= 0) {
    std::vector<int64_t>& bucket = buckets[static_cast<size_t>(cb)];
    size_t& head = heads[static_cast<size_t>(cb)];
    if (head >= bucket.size()) {
      bucket.clear();
      bucket.shrink_to_fit();
      head = 0;
      --cb;
      continue;
    }
    const int64_t idx = bucket[head++];
    const int32_t lab = output[idx];
    for (int32_t k = 0; k < n_nbr; ++k) {
      const int64_t nbr = idx + offsets[k];
      if (nbr < 0 || nbr >= n) continue;
      if (!mask[nbr]) continue;
      if (output[nbr]) continue;
      output[nbr] = lab;
      const int32_t key = keys[nbr];
      buckets[static_cast<size_t>(key)].push_back(nbr);
      if (key > cb) cb = key;  // heap would pop this next
    }
  }
}

}  // extern "C"

extern "C" {

namespace {

// Union-find over run ids (path halving + union by size).
struct RunDSU {
  std::vector<int32_t> parent;
  std::vector<int64_t> size;  // component voxel count

  int32_t make(int64_t len) {
    parent.push_back(static_cast<int32_t>(parent.size()));
    size.push_back(len);
    return parent.back();
  }

  int32_t find(int32_t i) {
    while (parent[i] != i) {
      parent[i] = parent[parent[i]];
      i = parent[i];
    }
    return i;
  }

  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (size[a] < size[b]) {
      int32_t t = a;
      a = b;
      b = t;
    }
    parent[b] = a;
    size[a] += size[b];
  }
};

struct Run {
  int64_t x0, x1;  // [x0, x1)
  int32_t id;
};

}  // namespace

// Run-based 6-connectivity size-band filter: decompose each x-row into
// runs of consecutive masked voxels, union runs that overlap in the
// previous y-row / previous z-slice, then zero every run whose component
// size is outside [min_area, max_area). Identical output to a per-voxel
// CC + size filter (tested against the BFS/scipy oracles) but visits each
// voxel O(1) times with contiguous memory access — ~5x faster than the
// per-voxel BFS on 256^3 masks.
void band_filter_runs(uint8_t* mask, int64_t nz, int64_t ny, int64_t nx,
                      int64_t min_area, int64_t max_area) {
  const int64_t sy = nx;
  const int64_t sz = ny * nx;
  RunDSU dsu;
  std::vector<Run> all_runs;  // every run, in scan order
  // row index (z * ny + y) -> [start, end) into all_runs
  std::vector<int64_t> row_begin(static_cast<size_t>(nz * ny + 1), 0);

  for (int64_t zi = 0; zi < nz; ++zi) {
    for (int64_t yi = 0; yi < ny; ++yi) {
      const uint8_t* row = mask + zi * sz + yi * sy;
      const int64_t row_idx = zi * ny + yi;
      row_begin[static_cast<size_t>(row_idx)] =
          static_cast<int64_t>(all_runs.size());
      int64_t x = 0;
      while (x < nx) {
        if (!row[x]) {
          ++x;
          continue;
        }
        int64_t x0 = x;
        while (x < nx && row[x]) ++x;
        int32_t id = dsu.make(x - x0);
        all_runs.push_back(Run{x0, x, id});
      }
    }
  }
  row_begin[static_cast<size_t>(nz * ny)] =
      static_cast<int64_t>(all_runs.size());

  // union overlapping runs with the previous y-row and previous z-slice
  auto merge_rows = [&](int64_t row_a, int64_t row_b) {
    int64_t ia = row_begin[static_cast<size_t>(row_a)];
    const int64_t ea = row_begin[static_cast<size_t>(row_a) + 1];
    int64_t ib = row_begin[static_cast<size_t>(row_b)];
    const int64_t eb = row_begin[static_cast<size_t>(row_b) + 1];
    while (ia < ea && ib < eb) {
      const Run& a = all_runs[static_cast<size_t>(ia)];
      const Run& b = all_runs[static_cast<size_t>(ib)];
      if (a.x0 < b.x1 && b.x0 < a.x1) dsu.unite(a.id, b.id);
      if (a.x1 < b.x1) {
        ++ia;
      } else {
        ++ib;
      }
    }
  };
  for (int64_t zi = 0; zi < nz; ++zi) {
    for (int64_t yi = 0; yi < ny; ++yi) {
      const int64_t row_idx = zi * ny + yi;
      if (yi > 0) merge_rows(row_idx, row_idx - 1);
      if (zi > 0) merge_rows(row_idx, row_idx - ny);
    }
  }

  // zero runs whose component size falls outside the band
  for (int64_t zi = 0; zi < nz; ++zi) {
    for (int64_t yi = 0; yi < ny; ++yi) {
      const int64_t row_idx = zi * ny + yi;
      uint8_t* row = mask + zi * sz + yi * sy;
      const int64_t e = row_begin[static_cast<size_t>(row_idx) + 1];
      for (int64_t i = row_begin[static_cast<size_t>(row_idx)]; i < e; ++i) {
        const Run& r = all_runs[static_cast<size_t>(i)];
        const int64_t s = dsu.size[static_cast<size_t>(dsu.find(r.id))];
        if (s < min_area || s >= max_area)
          std::memset(row + r.x0, 0, static_cast<size_t>(r.x1 - r.x0));
      }
    }
  }
}

}  // extern "C"

extern "C" {

namespace {
// Felzenszwalb & Huttenlocher 1D squared distance transform (exact).
void dt1d(double* f, double* d, int64_t* v, double* z, int64_t n) {
  int64_t k = 0;
  v[0] = 0;
  z[0] = -1e308;
  z[1] = 1e308;
  for (int64_t q = 1; q < n; ++q) {
    double s;
    while (true) {
      double vq = static_cast<double>(v[k]);
      s = ((f[q] + q * static_cast<double>(q)) - (f[v[k]] + vq * vq)) /
          (2.0 * q - 2.0 * vq);
      if (s > z[k]) break;
      --k;
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = 1e308;
  }
  k = 0;
  for (int64_t q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    double dq = static_cast<double>(q - v[k]);
    d[q] = dq * dq + f[v[k]];
  }
}
}  // namespace

// Exact Euclidean distance transform of a 3D mask: distance of nonzero
// voxels to the nearest zero voxel (scipy.ndimage.distance_transform_edt
// semantics; squared distances are exact integers, so the f64 sqrt is
// bit-identical to scipy's).
void edt3d(const uint8_t* mask, double* out, int64_t nz, int64_t ny,
           int64_t nx) {
  const int64_t n = nz * ny * nx;
  const int64_t sy = nx;
  const int64_t sz = ny * nx;
  for (int64_t i = 0; i < n; ++i) out[i] = mask[i] ? 1e308 : 0.0;
  int64_t maxdim = nx > ny ? (nx > nz ? nx : nz) : (ny > nz ? ny : nz);
  std::vector<double> f(static_cast<size_t>(maxdim));
  std::vector<double> d(static_cast<size_t>(maxdim));
  std::vector<int64_t> v(static_cast<size_t>(maxdim));
  std::vector<double> z(static_cast<size_t>(maxdim) + 1);
  // x lines (contiguous)
  for (int64_t zi = 0; zi < nz; ++zi)
    for (int64_t yi = 0; yi < ny; ++yi) {
      double* line = out + zi * sz + yi * sy;
      dt1d(line, d.data(), v.data(), z.data(), nx);
      for (int64_t x = 0; x < nx; ++x) line[x] = d[x];
    }
  // y lines
  for (int64_t zi = 0; zi < nz; ++zi)
    for (int64_t xi = 0; xi < nx; ++xi) {
      double* base = out + zi * sz + xi;
      for (int64_t y = 0; y < ny; ++y) f[static_cast<size_t>(y)] = base[y * sy];
      dt1d(f.data(), d.data(), v.data(), z.data(), ny);
      for (int64_t y = 0; y < ny; ++y) base[y * sy] = d[y];
    }
  // z lines
  for (int64_t yi = 0; yi < ny; ++yi)
    for (int64_t xi = 0; xi < nx; ++xi) {
      double* base = out + yi * sy + xi;
      for (int64_t zi = 0; zi < nz; ++zi)
        f[static_cast<size_t>(zi)] = base[zi * sz];
      dt1d(f.data(), d.data(), v.data(), z.data(), nz);
      for (int64_t zi = 0; zi < nz; ++zi) base[zi * sz] = d[zi];
    }
  for (int64_t i = 0; i < n; ++i) out[i] = std::sqrt(out[i]);
}

}  // extern "C"
