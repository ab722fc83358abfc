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
// Exact heap-order semantics: a binary min-heap over (value, age, index)
// compared lexicographically; ages increase monotonically with pushes so
// insertion order breaks value ties, and index breaks the initial
// all-age-zero seed ties — identical to Python heapq over
// Element(value, age, index, source).
//
// Claim-at-push: when an element pops, every in-mask unlabelled neighbour
// immediately takes its label and is enqueued. This is the sequential hot
// loop of inference; it runs on host while the GPU computes the next
// frame's feature maps.

#include <cmath>
#include <cstdint>
#include <cstring>
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
void priority_flood(const float* values, const int64_t* offsets,
                    const int64_t* val_chan, const int64_t* val_off,
                    int32_t n_nbr, const int64_t* markers, int64_t n_markers,
                    const float* seed_values, const uint8_t* mask,
                    int32_t* output, int64_t n) {
  MinHeap heap(static_cast<size_t>(n_markers) + 1024);
  for (int64_t i = 0; i < n_markers; ++i) {
    heap.push(Elem{seed_values[i], 0, markers[i]});
  }
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
  }
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
