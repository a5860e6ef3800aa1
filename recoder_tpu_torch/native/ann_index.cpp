// Random-projection-forest approximate-nearest-neighbor index
// (angular metric), the native backend of
// recoder_tpu.embedding.AnnEmbeddingsIndex.
//
// Same capability class as the annoy library the reference consumes
// (reference embedding.py:92-159): a forest of random-hyperplane
// trees over item embeddings, searched best-first with a shared
// priority queue, candidates re-ranked exactly by angular distance
// d = sqrt(2 - 2*cos). Built from scratch for this framework; exposed
// to Python through a C ABI + ctypes (no pybind11 dependency).
//
// Storage design (round 2): after Build the index is serialized into
// one flat, 8-byte-aligned buffer whose layout equals the on-disk
// format; Save writes that buffer verbatim, Load mmaps the file and
// points the search structures into the mapping. Loads are O(1) --
// pages fault in on demand and multiple processes share the page
// cache -- matching annoy's mmap-based load (its headline serving
// feature). Queries are thread-safe (read-only) and batched over a
// worker pool.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libann_index.so ann_index.cpp -pthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <queue>
#include <random>
#include <thread>
#include <tuple>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int32_t kMagicV2 = 0x414E4E32;  // "ANN2"

struct Node {
  // leaf: left == -1, items holds ids. internal: plane_off into planes,
  // children in left/right.
  int32_t left = -1;
  int32_t right = -1;
  int64_t plane_off = -1;
  std::vector<int32_t> items;
};

struct Tree {
  std::vector<Node> nodes;
  std::vector<float> planes;  // dim floats per internal node
  int32_t root = 0;
};

// read-only view of one tree inside the flat buffer
struct TreeView {
  int32_t root = 0;
  const int32_t* left = nullptr;
  const int32_t* right = nullptr;
  const int64_t* leaf_off = nullptr;  // into leaf_items (leaves only)
  const int64_t* leaf_len = nullptr;
  const int64_t* plane_off = nullptr;
  const float* planes = nullptr;
  const int32_t* leaf_items = nullptr;
};

size_t Pad8(size_t n) { return (n + 7) & ~size_t(7); }

class AnnIndex {
 public:
  explicit AnnIndex(int dim) : dim_(dim) {}

  ~AnnIndex() { UnmapIfMapped(); }

  void AddItems(const float* data, int n) {
    size_t old = build_items_.size();
    build_items_.resize(old + static_cast<size_t>(n) * dim_);
    std::memcpy(build_items_.data() + old, data, sizeof(float) * n * dim_);
    build_norms_.resize(old + static_cast<size_t>(n) * dim_);
    for (int i = 0; i < n; ++i) {
      const float* v = data + static_cast<size_t>(i) * dim_;
      float* o = build_norms_.data() + old + static_cast<size_t>(i) * dim_;
      double s = 0;
      for (int d = 0; d < dim_; ++d) s += double(v[d]) * v[d];
      float inv = s > 0 ? float(1.0 / std::sqrt(s)) : 0.f;
      for (int d = 0; d < dim_; ++d) o[d] = v[d] * inv;
    }
    n_items_ += n;
  }

  bool Build(int n_trees, uint32_t seed, int leaf_size) {
    // staged vectors are cleared by Serialize/Load: a second Build (or
    // a Build on a loaded index) would read them out of bounds
    if (n_items_ <= 0 ||
        build_norms_.size() != size_t(n_items_) * dim_) {
      return false;
    }
    std::vector<Tree> trees(n_trees);
    leaf_size_ = leaf_size > 0 ? leaf_size : std::max(8, dim_ / 4);
    unsigned hw = std::max(1u, std::thread::hardware_concurrency());
    unsigned workers = std::min<unsigned>(hw, std::max(n_trees, 1));
    std::vector<std::thread> pool;
    std::atomic<int> next{0};
    for (unsigned w = 0; w < workers; ++w) {
      pool.emplace_back([&] {
        for (;;) {
          int t = next.fetch_add(1);
          if (t >= n_trees) return;
          std::mt19937 rng(seed + 0x9e3779b9u * (t + 1));
          std::vector<int32_t> all(n_items_);
          for (int i = 0; i < n_items_; ++i) all[i] = i;
          BuildTree(trees[t], all, rng);
        }
      });
    }
    for (auto& th : pool) th.join();
    Serialize(trees);
    return true;
  }

  // best-first search across all trees with a shared priority queue
  int GetNnsByVector(const float* query, int n, int search_k,
                     int32_t* out_ids, float* out_dists) const {
    if (search_k <= 0) search_k = n * std::max<size_t>(views_.size(), 1);
    std::vector<float> q(dim_);
    double s = 0;
    for (int d = 0; d < dim_; ++d) s += double(query[d]) * query[d];
    float inv = s > 0 ? float(1.0 / std::sqrt(s)) : 0.f;
    for (int d = 0; d < dim_; ++d) q[d] = query[d] * inv;

    // (priority = min margin along path, tree, node)
    using Entry = std::tuple<float, int32_t, int32_t>;
    std::priority_queue<Entry> pq;
    for (size_t t = 0; t < views_.size(); ++t)
      pq.emplace(std::numeric_limits<float>::infinity(), int32_t(t),
                 views_[t].root);

    std::vector<int32_t> candidates;
    candidates.reserve(search_k * 2);
    int visited = 0;
    while (!pq.empty() && visited < search_k) {
      auto [prio, t, ni] = pq.top();
      pq.pop();
      const TreeView& tree = views_[t];
      if (tree.left[ni] < 0) {
        const int32_t* leaf = tree.leaf_items + tree.leaf_off[ni];
        int64_t len = tree.leaf_len[ni];
        candidates.insert(candidates.end(), leaf, leaf + len);
        visited += int(len);
      } else {
        const float* plane = tree.planes + tree.plane_off[ni];
        double dot = 0;
        for (int d = 0; d < dim_; ++d) dot += double(plane[d]) * q[d];
        float margin = float(dot);
        pq.emplace(std::min(prio, std::max(margin, 0.f)), t,
                   tree.right[ni]);
        pq.emplace(std::min(prio, std::max(-margin, 0.f)), t,
                   tree.left[ni]);
      }
    }

    std::sort(candidates.begin(), candidates.end());
    candidates.erase(std::unique(candidates.begin(), candidates.end()),
                     candidates.end());

    // exact re-rank by angular distance
    std::vector<std::pair<float, int32_t>> scored;
    scored.reserve(candidates.size());
    for (int32_t id : candidates) {
      const float* v = norms_p_ + size_t(id) * dim_;
      double dot = 0;
      for (int d = 0; d < dim_; ++d) dot += double(v[d]) * q[d];
      float dist = std::sqrt(std::max(0.0, 2.0 - 2.0 * dot));
      scored.emplace_back(dist, id);
    }
    int k = std::min<int>(n, int(scored.size()));
    std::partial_sort(scored.begin(), scored.begin() + k, scored.end());
    for (int i = 0; i < k; ++i) {
      out_ids[i] = scored[i].second;
      out_dists[i] = scored[i].first;
    }
    return k;
  }

  bool ValidItem(int i) const {
    return items_p_ != nullptr && i >= 0 && i < n_items_;
  }

  int GetNnsByItem(int item, int n, int search_k, int32_t* out_ids,
                   float* out_dists) const {
    if (!ValidItem(item)) return -1;  // out-of-range id, surfaced to
    // Python as an exception instead of an out-of-bounds read
    return GetNnsByVector(items_p_ + size_t(item) * dim_, n, search_k,
                          out_ids, out_dists);
  }

  float GetDistance(int i, int j) const {
    if (!ValidItem(i) || !ValidItem(j)) return -1.f;  // real angular
    // distances are >= 0, so -1 is an unambiguous error sentinel
    const float* a = norms_p_ + size_t(i) * dim_;
    const float* b = norms_p_ + size_t(j) * dim_;
    double dot = 0;
    for (int d = 0; d < dim_; ++d) dot += double(a[d]) * b[d];
    return std::sqrt(std::max(0.0, 2.0 - 2.0 * dot));
  }

  bool GetItem(int i, float* out) const {
    if (!ValidItem(i)) return false;
    std::memcpy(out, items_p_ + size_t(i) * dim_, sizeof(float) * dim_);
    return true;
  }

  int n_items() const { return n_items_; }
  int dim() const { return dim_; }

  bool Save(const char* path) const {
    const char* src = buffer_.empty()
        ? static_cast<const char*>(map_) : buffer_.data();
    size_t size = buffer_.empty() ? map_size_ : buffer_.size();
    if (!src || !size) return false;
    FILE* f = std::fopen(path, "wb");
    if (!f) return false;
    bool ok = std::fwrite(src, 1, size, f) == size;
    std::fclose(f);
    return ok;
  }

  bool Load(const char* path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < 16) {
      ::close(fd);
      return false;
    }
    void* m = mmap(nullptr, size_t(st.st_size), PROT_READ, MAP_SHARED,
                   fd, 0);
    ::close(fd);
    if (m == MAP_FAILED) return false;
    // parse the NEW mapping before touching existing state: a corrupt
    // file must leave a previously working index fully intact (the
    // old flow freed the live buffer first, leaving every view pointer
    // dangling on failure)
    Parsed ps;
    if (!ParseBuffer(static_cast<const char*>(m), size_t(st.st_size),
                     &ps)) {
      munmap(m, size_t(st.st_size));
      return false;
    }
    UnmapIfMapped();
    buffer_.clear();
    buffer_.shrink_to_fit();
    build_items_.clear();
    build_items_.shrink_to_fit();
    build_norms_.clear();
    build_norms_.shrink_to_fit();
    map_ = m;
    map_size_ = size_t(st.st_size);
    Commit(ps);
    return true;
  }

 private:
  void UnmapIfMapped() {
    if (map_) {
      munmap(map_, map_size_);
      map_ = nullptr;
      map_size_ = 0;
    }
  }

  // -- flat buffer layout (== on-disk format, all sections 8-aligned):
  //   i32 magic, i32 dim, i32 n_items, i32 n_trees
  //   f32 items[n_items*dim]  f32 norms[n_items*dim]
  //   per tree:
  //     i32 root, i32 pad, i64 n_nodes, i64 n_planes, i64 n_leaf_items
  //     i32 left[n], i32 right[n] (each padded to 8)
  //     i64 plane_off[n], i64 leaf_off[n], i64 leaf_len[n]
  //     f32 planes[n_planes] (padded), i32 leaf_items[m] (padded)

  void Serialize(const std::vector<Tree>& trees) {
    size_t items_bytes = sizeof(float) * build_items_.size();
    size_t total = 16 + 2 * Pad8(items_bytes);
    for (const Tree& t : trees) {
      size_t n = t.nodes.size();
      size_t leaf_items = 0;
      for (const Node& nd : t.nodes) leaf_items += nd.items.size();
      total += 8 + 24;                      // root/pad + counters
      total += 2 * Pad8(4 * n) + 3 * 8 * n; // left/right + 3 i64 arrays
      total += Pad8(sizeof(float) * t.planes.size());
      total += Pad8(4 * leaf_items);
    }

    buffer_.assign(total, 0);
    char* p = buffer_.data();
    auto put = [&](const void* src, size_t bytes, bool pad) {
      std::memcpy(p, src, bytes);
      p += pad ? Pad8(bytes) : bytes;
    };
    int32_t header[4] = {kMagicV2, dim_, n_items_, int32_t(trees.size())};
    put(header, 16, false);
    put(build_items_.data(), items_bytes, true);
    put(build_norms_.data(), items_bytes, true);

    for (const Tree& t : trees) {
      int64_t n = int64_t(t.nodes.size());
      int64_t n_planes = int64_t(t.planes.size());
      std::vector<int32_t> left(n), right(n), leaf_items;
      std::vector<int64_t> plane_off(n), leaf_off(n), leaf_len(n);
      for (int64_t i = 0; i < n; ++i) {
        const Node& nd = t.nodes[i];
        left[i] = nd.left;
        right[i] = nd.right;
        plane_off[i] = std::max<int64_t>(nd.plane_off, 0);
        leaf_off[i] = int64_t(leaf_items.size());
        leaf_len[i] = int64_t(nd.items.size());
        leaf_items.insert(leaf_items.end(), nd.items.begin(),
                          nd.items.end());
      }
      int64_t n_leaf = int64_t(leaf_items.size());
      int32_t head[2] = {t.root, 0};
      put(head, 8, false);
      int64_t counters[3] = {n, n_planes, n_leaf};
      put(counters, 24, false);
      put(left.data(), 4 * n, true);
      put(right.data(), 4 * n, true);
      put(plane_off.data(), 8 * n, false);
      put(leaf_off.data(), 8 * n, false);
      put(leaf_len.data(), 8 * n, false);
      put(t.planes.data(), sizeof(float) * n_planes, true);
      put(leaf_items.data(), 4 * n_leaf, true);
    }

    build_items_.clear();
    build_items_.shrink_to_fit();
    build_norms_.clear();
    build_norms_.shrink_to_fit();
    UnmapIfMapped();
    Parsed ps;
    bool ok = ParseBuffer(buffer_.data(), buffer_.size(), &ps);
    (void)ok;  // layout written by this function; always parses
    Commit(ps);
  }

  // parse result, committed to members only on success (see Load)
  struct Parsed {
    int n_items = 0;
    const float* items_p = nullptr;
    const float* norms_p = nullptr;
    std::vector<TreeView> views;
  };

  void Commit(Parsed& ps) {
    n_items_ = ps.n_items;
    items_p_ = ps.items_p;
    norms_p_ = ps.norms_p;
    views_ = std::move(ps.views);
  }

  bool ParseBuffer(const char* base, size_t size, Parsed* out) const {
    const char* p = base;
    const char* end = base + size;
    auto need = [&](size_t bytes) { return size_t(end - p) >= bytes; };
    // counters come from the file: every count is validated against
    // the bytes remaining BEFORE entering size arithmetic, so corrupt
    // (or hostile) values cannot overflow the accumulated `want`
    auto sane = [&](int64_t v) {
      return v >= 0 && size_t(v) <= size_t(end - p);
    };
    if (!need(16)) return false;
    int32_t header[4];
    std::memcpy(header, p, 16);
    p += 16;
    if (header[0] != kMagicV2 || header[1] != dim_) return false;
    if (header[2] < 0 || header[3] < 0) return false;
    out->n_items = header[2];
    int n_trees = header[3];
    if (size_t(out->n_items) > size / (sizeof(float) * size_t(dim_)))
      return false;
    if (size_t(n_trees) > size / 32)  // each tree needs >= 32 bytes
      return false;
    size_t items_bytes = sizeof(float) * size_t(out->n_items) * dim_;
    if (!need(2 * Pad8(items_bytes))) return false;
    out->items_p = reinterpret_cast<const float*>(p);
    p += Pad8(items_bytes);
    out->norms_p = reinterpret_cast<const float*>(p);
    p += Pad8(items_bytes);

    out->views.assign(n_trees, TreeView{});
    for (TreeView& v : out->views) {
      if (!need(32)) return false;
      std::memcpy(&v.root, p, 4);
      p += 8;
      int64_t counters[3];
      std::memcpy(counters, p, 24);
      p += 24;
      int64_t n = counters[0], n_planes = counters[1],
              n_leaf = counters[2];
      if (!sane(n) || !sane(n_planes) || !sane(n_leaf)) return false;
      size_t want = 2 * Pad8(4 * size_t(n)) + 3 * 8 * size_t(n)
          + Pad8(sizeof(float) * size_t(n_planes))
          + Pad8(4 * size_t(n_leaf));
      if (!need(want)) return false;
      v.left = reinterpret_cast<const int32_t*>(p);
      p += Pad8(4 * n);
      v.right = reinterpret_cast<const int32_t*>(p);
      p += Pad8(4 * n);
      v.plane_off = reinterpret_cast<const int64_t*>(p);
      p += 8 * n;
      v.leaf_off = reinterpret_cast<const int64_t*>(p);
      p += 8 * n;
      v.leaf_len = reinterpret_cast<const int64_t*>(p);
      p += 8 * n;
      v.planes = reinterpret_cast<const float*>(p);
      p += Pad8(sizeof(float) * n_planes);
      v.leaf_items = reinterpret_cast<const int32_t*>(p);
      p += Pad8(4 * n_leaf);
    }
    return true;
  }

  void BuildTree(Tree& tree, std::vector<int32_t>& ids, std::mt19937& rng) {
    tree.root = BuildNode(tree, ids, rng, 0);
  }

  int32_t BuildNode(Tree& tree, std::vector<int32_t>& ids, std::mt19937& rng,
                    int depth) {
    int32_t me = int32_t(tree.nodes.size());
    tree.nodes.emplace_back();
    if (int(ids.size()) <= leaf_size_ || depth > 50) {
      tree.nodes[me].items = ids;
      return me;
    }

    // split plane via two-means: seed two random centroids, refine on a
    // sample by assigning points to the closer centroid and averaging
    // (the split heuristic annoy's angular trees use), then take the
    // normalized centroid difference as the hyperplane
    std::uniform_int_distribution<size_t> pick(0, ids.size() - 1);
    std::vector<float> plane(dim_);
    bool ok = false;
    for (int attempt = 0; attempt < 5 && !ok; ++attempt) {
      const float* a0 = build_norms_.data() + size_t(ids[pick(rng)]) * dim_;
      const float* b0 = build_norms_.data() + size_t(ids[pick(rng)]) * dim_;
      std::vector<float> c0(a0, a0 + dim_);
      std::vector<float> c1(b0, b0 + dim_);

      const int kIters = 3;
      const size_t kSample = std::min<size_t>(ids.size(), 256);
      std::vector<float> n0(dim_), n1(dim_);
      for (int it = 0; it < kIters; ++it) {
        std::fill(n0.begin(), n0.end(), 0.f);
        std::fill(n1.begin(), n1.end(), 0.f);
        int cnt0 = 0, cnt1 = 0;
        for (size_t k = 0; k < kSample; ++k) {
          const float* v =
              build_norms_.data() + size_t(ids[pick(rng)]) * dim_;
          double d0 = 0, d1 = 0;
          for (int d = 0; d < dim_; ++d) {
            double e0 = v[d] - c0[d], e1 = v[d] - c1[d];
            d0 += e0 * e0;
            d1 += e1 * e1;
          }
          float* acc = d0 < d1 ? n0.data() : n1.data();
          (d0 < d1 ? cnt0 : cnt1)++;
          for (int d = 0; d < dim_; ++d) acc[d] += v[d];
        }
        if (cnt0 == 0 || cnt1 == 0) break;
        for (int d = 0; d < dim_; ++d) {
          c0[d] = n0[d] / cnt0;
          c1[d] = n1[d] / cnt1;
        }
      }

      double s = 0;
      for (int d = 0; d < dim_; ++d) {
        plane[d] = c0[d] - c1[d];
        s += double(plane[d]) * plane[d];
      }
      if (s > 1e-12) {
        float inv = float(1.0 / std::sqrt(s));
        for (int d = 0; d < dim_; ++d) plane[d] *= inv;
        ok = true;
      }
    }
    if (!ok) {  // all duplicates: random gaussian plane
      std::normal_distribution<float> g;
      double s = 0;
      for (int d = 0; d < dim_; ++d) {
        plane[d] = g(rng);
        s += double(plane[d]) * plane[d];
      }
      float inv = float(1.0 / std::sqrt(std::max(s, 1e-12)));
      for (int d = 0; d < dim_; ++d) plane[d] *= inv;
    }

    std::vector<int32_t> left, right;
    left.reserve(ids.size() / 2);
    right.reserve(ids.size() / 2);
    for (int32_t id : ids) {
      const float* v = build_norms_.data() + size_t(id) * dim_;
      double dot = 0;
      for (int d = 0; d < dim_; ++d) dot += double(plane[d]) * v[d];
      (dot > 0 ? right : left).push_back(id);
    }
    // degenerate split: randomize
    if (left.empty() || right.empty()) {
      left.clear();
      right.clear();
      std::bernoulli_distribution coin(0.5);
      for (int32_t id : ids) (coin(rng) ? right : left).push_back(id);
    }

    int64_t plane_off = int64_t(tree.planes.size());
    tree.planes.insert(tree.planes.end(), plane.begin(), plane.end());

    ids.clear();
    ids.shrink_to_fit();
    int32_t l = BuildNode(tree, left, rng, depth + 1);
    int32_t r = BuildNode(tree, right, rng, depth + 1);
    tree.nodes[me].left = l;
    tree.nodes[me].right = r;
    tree.nodes[me].plane_off = plane_off;
    return me;
  }

  int dim_;
  int n_items_ = 0;
  int leaf_size_ = 32;
  // pre-Build staging; cleared after Serialize moves them into buffer_
  std::vector<float> build_items_;
  std::vector<float> build_norms_;
  // flat storage: owned buffer (built) or mmap (loaded)
  std::vector<char> buffer_;
  void* map_ = nullptr;
  size_t map_size_ = 0;
  const float* items_p_ = nullptr;
  const float* norms_p_ = nullptr;
  std::vector<TreeView> views_;
};

}  // namespace

extern "C" {

void* ann_create(int dim) { return new AnnIndex(dim); }
void ann_free(void* p) { delete static_cast<AnnIndex*>(p); }

void ann_add_items(void* p, const float* data, int n) {
  static_cast<AnnIndex*>(p)->AddItems(data, n);
}

int ann_build(void* p, int n_trees, uint32_t seed, int leaf_size) {
  return static_cast<AnnIndex*>(p)->Build(n_trees, seed, leaf_size)
      ? 1 : 0;
}

int ann_save(void* p, const char* path) {
  return static_cast<AnnIndex*>(p)->Save(path) ? 1 : 0;
}

int ann_load(void* p, const char* path) {
  return static_cast<AnnIndex*>(p)->Load(path) ? 1 : 0;
}

int ann_n_items(void* p) { return static_cast<AnnIndex*>(p)->n_items(); }
int ann_dim(void* p) { return static_cast<AnnIndex*>(p)->dim(); }

int ann_get_item(void* p, int i, float* out) {
  return static_cast<AnnIndex*>(p)->GetItem(i, out) ? 1 : 0;
}

int ann_get_nns_by_item(void* p, int item, int n, int search_k,
                        int32_t* out_ids, float* out_dists) {
  return static_cast<AnnIndex*>(p)->GetNnsByItem(item, n, search_k,
                                                 out_ids, out_dists);
}

int ann_get_nns_by_vector(void* p, const float* vec, int n, int search_k,
                          int32_t* out_ids, float* out_dists) {
  return static_cast<AnnIndex*>(p)->GetNnsByVector(vec, n, search_k,
                                                   out_ids, out_dists);
}

float ann_get_distance(void* p, int i, int j) {
  return static_cast<AnnIndex*>(p)->GetDistance(i, j);
}

// Batched multi-query search over a worker pool. out_ids/out_dists are
// [m, n] row-major; out_counts[i] holds the number of valid entries in
// row i (trailing slots untouched). Search is read-only, so workers
// share the index without locks.
void ann_get_nns_batch(void* p, const int32_t* items, int m, int n,
                       int search_k, int n_threads, int32_t* out_ids,
                       float* out_dists, int32_t* out_counts) {
  AnnIndex* index = static_cast<AnnIndex*>(p);
  if (n_threads <= 0)
    n_threads = int(std::max(1u, std::thread::hardware_concurrency()));
  n_threads = std::max(1, std::min(n_threads, m));
  std::atomic<int> next{0};
  auto worker = [&] {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= m) return;
      out_counts[i] = index->GetNnsByItem(
          items[i], n, search_k, out_ids + size_t(i) * n,
          out_dists + size_t(i) * n);
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
}

// Bulk row fetch: out is [m, dim] row-major. Returns 1, or 0 when any
// id is out of range (out is left partially written).
int ann_get_items(void* p, const int32_t* ids, int m, float* out) {
  AnnIndex* index = static_cast<AnnIndex*>(p);
  int dim = index->dim();
  for (int i = 0; i < m; ++i)
    if (!index->GetItem(ids[i], out + size_t(i) * dim)) return 0;
  return 1;
}

}  // extern "C"
