// Host-side preprocessing kernels for gpvecchia_tpu (C API, loaded via ctypes).
//
// These replace the quasilinear-but-Python host loops with native code:
//   * maxmin_exact     — exact maximum-minimum-distance ordering
//                        (capability of /root/reference/src/MaxMin.cpp:661-738,
//                        fresh lazy-heap + kd-tree design)
//   * ordered_nn       — m nearest previously-ordered neighbors
//                        (GpGp::find_ordered_nn equivalent)
//   * sgv_select       — SGV latent/response conditioning choice
//                        (/root/reference/R/whichCondOnLatent.R:2-27)
//   * symbolic_chol    — row-pattern symbolic Cholesky (Liu's algorithm)
//                        feeding the device numeric factorization plans
//
// Built on first use by csrc/__init__.py:
//   g++ -O3 -march=native -shared -fPIC hostops.cpp -o libhostops-<hash>.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <queue>
#include <vector>

namespace {

// ---------------------------------------------------------------- kd-tree --
struct KDTree {
  // simple static kd-tree over a subset of points; 2-8 dims
  const double* pts;  // (n, d) row-major
  int d;
  std::vector<int> idx;      // point ids in tree order
  std::vector<int> left, right;
  std::vector<double> lo_, hi_;  // per-node bounding boxes (d each)

  int build(int begin, int end, int depth) {
    if (begin >= end) return -1;
    int mid = (begin + end) / 2;
    int axis = depth % d;
    std::nth_element(idx.begin() + begin, idx.begin() + mid, idx.begin() + end,
                     [&](int a, int b) { return pts[a * d + axis] < pts[b * d + axis]; });
    int node = mid;
    left[node] = build(begin, mid, depth + 1);
    right[node] = build(mid + 1, end, depth + 1);
    for (int k = 0; k < d; ++k) {
      double lo = pts[idx[node] * d + k], hi = lo;
      for (int c : {left[node], right[node]}) {
        if (c >= 0) {
          lo = std::min(lo, lo_[c * d + k]);
          hi = std::max(hi, hi_[c * d + k]);
        }
      }
      lo_[node * d + k] = lo;
      hi_[node * d + k] = hi;
    }
    return node;
  }

  int root = -1;
  void init(const double* p, int dd, const std::vector<int>& ids) {
    pts = p; d = dd; idx = ids;
    int n = (int)idx.size();
    left.assign(n, -1); right.assign(n, -1);
    lo_.assign((size_t)n * d, 0.0); hi_.assign((size_t)n * d, 0.0);
    root = build(0, n, 0);
  }

  double boxDist2(int node, const double* q) const {
    double s = 0;
    for (int k = 0; k < d; ++k) {
      double v = q[k];
      double lo = lo_[node * d + k], hi = hi_[node * d + k];
      double t = v < lo ? lo - v : (v > hi ? v - hi : 0.0);
      s += t * t;
    }
    return s;
  }

  double pdist2(int id, const double* q) const {
    double s = 0;
    for (int k = 0; k < d; ++k) {
      double t = pts[id * d + k] - q[k];
      s += t * t;
    }
    return s;
  }

  void nearest1(int node, const double* q, double& best) const {
    if (node < 0) return;
    if (boxDist2(node, q) >= best) return;
    best = std::min(best, pdist2(idx[node], q));
    int l = left[node], r = right[node];
    double dl = l >= 0 ? boxDist2(l, q) : 1e300;
    double dr = r >= 0 ? boxDist2(r, q) : 1e300;
    if (dl < dr) { nearest1(l, q, best); if (dr < best) nearest1(r, q, best); }
    else { nearest1(r, q, best); if (dl < best) nearest1(l, q, best); }
  }

  // k nearest: maintains a max-heap of (dist2, id)
  void knn(int node, const double* q, int k,
           std::priority_queue<std::pair<double, int>>& heap) const {
    if (node < 0) return;
    double worst = (int)heap.size() < k ? 1e300 : heap.top().first;
    if (boxDist2(node, q) >= worst) return;
    double dp = pdist2(idx[node], q);
    if ((int)heap.size() < k) heap.push({dp, idx[node]});
    else if (dp < heap.top().first) { heap.pop(); heap.push({dp, idx[node]}); }
    int l = left[node], r = right[node];
    double dl = l >= 0 ? boxDist2(l, q) : 1e300;
    double dr = r >= 0 ? boxDist2(r, q) : 1e300;
    if (dl < dr) { knn(l, q, k, heap); knn(r, q, k, heap); }
    else { knn(r, q, k, heap); knn(l, q, k, heap); }
  }
};

// Bentley-Saxe kd-forest: batched inserts with logarithmic merging, so the
// total (re)build cost is O(n log^2 n) instead of the O(n^2 / batch) of
// rebuilding one tree (which made maxmin/ordered_nn quadratic at n=1e6).
struct KDForest {
  const double* pts = nullptr;
  int d = 0;
  std::vector<KDTree> trees;
  std::vector<std::vector<int>> idsets;

  void reset(const double* p, int dd) {
    pts = p; d = dd; trees.clear(); idsets.clear();
  }
  void insert_batch(std::vector<int> cur) {
    while (!idsets.empty() && idsets.back().size() <= cur.size()) {
      cur.insert(cur.end(), idsets.back().begin(), idsets.back().end());
      idsets.pop_back();
      trees.pop_back();
    }
    idsets.push_back(std::move(cur));
    trees.emplace_back();
    trees.back().init(pts, d, idsets.back());
  }
  void nearest1(const double* q, double& best) const {
    for (const auto& t : trees) t.nearest1(t.root, q, best);
  }
  void knn(const double* q, int k,
           std::priority_queue<std::pair<double, int>>& heap) const {
    for (const auto& t : trees) t.knn(t.root, q, k, heap);
  }
};

}  // namespace

extern "C" {

// Exact maxmin ordering: order[0] = closest to centroid; each next point
// maximizes min distance to the selected set.  Lazy max-heap with periodic
// kd-tree rebuilds over the selected set (amortized quasilinear).
void maxmin_exact(const double* locs, int64_t n, int d, int64_t* order) {
  if (n == 0) return;
  std::vector<double> centroid(d, 0.0);
  for (int64_t i = 0; i < n; ++i)
    for (int k = 0; k < d; ++k) centroid[k] += locs[i * d + k];
  for (int k = 0; k < d; ++k) centroid[k] /= (double)n;
  int64_t first = 0;
  double bestd = 1e300;
  for (int64_t i = 0; i < n; ++i) {
    double s = 0;
    for (int k = 0; k < d; ++k) {
      double t = locs[i * d + k] - centroid[k];
      s += t * t;
    }
    if (s < bestd) { bestd = s; first = i; }
  }
  order[0] = first;
  std::vector<char> selected(n, 0);
  selected[first] = 1;

  std::priority_queue<std::pair<double, int64_t>> heap;
  for (int64_t i = 0; i < n; ++i) {
    if (i == first) continue;
    double s = 0;
    for (int k = 0; k < d; ++k) {
      double t = locs[i * d + k] - locs[first * d + k];
      s += t * t;
    }
    heap.push({s, i});
  }

  KDForest forest;
  forest.reset(locs, d);
  forest.insert_batch({(int)first});
  std::vector<int64_t> recent;

  for (int64_t pos = 1; pos < n; ++pos) {
    while (true) {
      auto [cached, i] = heap.top();
      heap.pop();
      if (selected[i]) continue;
      double true_d2 = cached;
      for (int64_t r : recent) {
        double s = 0;
        for (int k = 0; k < d; ++k) {
          double t = locs[i * d + k] - locs[r * d + k];
          s += t * t;
        }
        true_d2 = std::min(true_d2, s);
      }
      double tb = true_d2;
      forest.nearest1(locs + i * d, tb);
      true_d2 = std::min(true_d2, tb);
      double next_best = heap.empty() ? -1e300 : heap.top().first;
      if (true_d2 >= next_best) {
        order[pos] = i;
        selected[i] = 1;
        recent.push_back(i);
        break;
      }
      heap.push({true_d2, i});
    }
    if (recent.size() >= 256) {
      forest.insert_batch(std::vector<int>(recent.begin(), recent.end()));
      recent.clear();
    }
  }
}

// m nearest previously-ordered neighbors.  NN is (n, m+1) int64, self first,
// -1 padded.  Doubling chunks: a kd-tree over [0, a) is rebuilt only at
// geometric checkpoints (O(n log^2 n) total build); within the chunk a local
// tree is queried with successive k-doubling until >= m previously-ordered
// points are found (the reference's msearch-doubling idea,
// R/NN_kdtree.R:36-68), with a brute-force path for short prefixes.
void ordered_nn(const double* locs, int64_t n, int d, int m, int64_t* NN) {
  for (int64_t i = 0; i < n; ++i) {
    NN[i * (m + 1)] = i;
    for (int j = 1; j <= m; ++j) NN[i * (m + 1) + j] = -1;
  }
  KDForest forest;
  forest.reset(locs, d);
  std::vector<int64_t> buf;  // previously-ordered points not yet in the forest
  std::vector<std::pair<double, int64_t>> cand;
  for (int64_t i = 0; i < n; ++i) {
    int64_t want = std::min<int64_t>(m, i);
    if (want > 0) {
      cand.clear();
      std::priority_queue<std::pair<double, int>> heap;
      forest.knn(locs + i * d, (int)want, heap);
      while (!heap.empty()) {
        cand.push_back({heap.top().first, heap.top().second});
        heap.pop();
      }
      for (int64_t j : buf) {
        double s = 0;
        for (int k = 0; k < d; ++k) {
          double t = locs[i * d + k] - locs[j * d + k];
          s += t * t;
        }
        cand.push_back({s, j});
      }
      int64_t lim = std::min<int64_t>(want, (int64_t)cand.size());
      std::partial_sort(cand.begin(), cand.begin() + lim, cand.end());
      for (int64_t j = 0; j < lim; ++j)
        NN[i * (m + 1) + 1 + j] = cand[j].second;
    }
    buf.push_back(i);
    if ((int64_t)buf.size() >= 256) {
      forest.insert_batch(std::vector<int>(buf.begin(), buf.end()));
      buf.clear();
    }
  }
}

// SGV conditioning selection.  NN: (n, mp1) int64 (-1 pad, self first);
// cond: (n, mp1) uint8 output.
void sgv_select(const int64_t* NN, int64_t n, int mp1, int64_t first_pred,
                uint8_t* cond) {
  std::memset(cond, 0, (size_t)n * mp1);
  if (n == 0) return;
  cond[0] = 1;
  std::vector<int64_t> latset;
  // stamp[q] == k  iff  q is in row k's conditioning set (O(n m^2) total
  // instead of the O(n m^3) of per-candidate linear membership scans)
  std::vector<int64_t> stamp(n, -1);
  for (int64_t k = 1; k < n; ++k) {
    const int64_t* row = NN + k * mp1;
    for (int j = 0; j < mp1; ++j)
      if (row[j] >= 0) stamp[row[j]] = k;
    int best_score = 0;
    int64_t best_l = -1;
    for (int j = 1; j < mp1; ++j) {
      int64_t l = row[j];
      if (l < 0 || l >= first_pred) continue;
      // score = overlap of row with l's latent-conditioned set
      int score = 0;
      const int64_t* lrow = NN + l * mp1;
      const uint8_t* lcond = cond + l * mp1;
      for (int t = 0; t < mp1; ++t)
        if (lcond[t] && lrow[t] >= 0 && stamp[lrow[t]] == k) ++score;
      if (score > best_score) { best_score = score; best_l = l; }
    }
    uint8_t* crow = cond + k * mp1;
    if (best_l >= 0) {
      const int64_t* lrow = NN + best_l * mp1;
      const uint8_t* lcond = cond + best_l * mp1;
      latset.clear();
      for (int t = 0; t < mp1; ++t)
        if (lcond[t] && lrow[t] >= 0) latset.push_back(lrow[t]);
      for (int j = 0; j < mp1; ++j) {
        int64_t q = row[j];
        if (q < 0) continue;
        bool in = std::find(latset.begin(), latset.end(), q) != latset.end();
        crow[j] = in ? 1 : 0;
      }
    }
    for (int j = 0; j < mp1; ++j) {
      int64_t q = row[j];
      if (q >= first_pred) crow[j] = 1;
      if (q < 0) crow[j] = 0;
    }
    crow[0] = 1;
  }
}

// MRA knot tree (native twin of geometry/mra.py build_mra_nnarray; the
// reference's is src/fastTree.cpp:272-297).  BFS over regions: at levels
// < M the first r[level] region points (ascending ordering position)
// become knots prepended to the inherited ancestor chain, the rest is
// median-split into J[level] balanced clusters; at level M every point is
// a knot.  Outputs the per-point conditioning CHAIN (next knot + length)
// -- the caller expands rows vectorizedly -- plus the effective stats.
//
// eff_out layout: [eff_M, finest_count, finest_total, r_eff_or_-1 x (M+1)]
// (the -1 marks levels whose regions disagreed on r_eff, replicating the
// Python conflict tracking ORDER-SENSITIVELY, hence BFS here too).
void mra_tree(const double* locs, int64_t n, int d, const int64_t* J,
              const int64_t* r, int64_t M, int64_t* chain_next,
              int64_t* chain_len, int64_t* eff_out) {
  struct Region {
    int64_t level;
    int64_t head;  // last knot of the inherited chain (-1 = none)
    std::vector<int64_t> pts;
  };
  std::vector<int64_t> eff_r(M + 1, 0);
  std::vector<char> conflict(M + 1, 0);
  int64_t eff_M = 0, finest_count = 0, finest_total = 0;
  for (int64_t i = 0; i < n; ++i) { chain_next[i] = -1; chain_len[i] = 0; }

  std::deque<Region> queue;
  {
    Region root{0, -1, {}};
    root.pts.resize(n);
    for (int64_t i = 0; i < n; ++i) root.pts[i] = i;
    queue.push_back(std::move(root));
  }
  std::vector<double> vals;
  while (!queue.empty()) {
    Region reg = std::move(queue.front());
    queue.pop_front();
    int64_t level = reg.level;
    if (level > eff_M) eff_M = level;
    int64_t head = reg.head;
    int64_t head_len = head >= 0 ? chain_len[head] : 0;
    if (level < M) {
      int64_t r_eff = std::min<int64_t>(r[level], (int64_t)reg.pts.size());
      if (eff_r[level] == 0 && !conflict[level]) eff_r[level] = r_eff;
      else if (eff_r[level] != r_eff) conflict[level] = 1;
      for (int64_t j = 0; j < r_eff; ++j) {
        int64_t k = reg.pts[j];
        chain_next[k] = head;
        chain_len[k] = head_len + 1;
        head = k;
        head_len = chain_len[k];
      }
      int64_t rest = (int64_t)reg.pts.size() - r_eff;
      if (rest == 0) continue;
      int64_t Jl = J[level];
      if (Jl > rest) {
        // singletons in region order, then empties
        for (int64_t j = 0; j < Jl; ++j) {
          Region child{level + 1, head, {}};
          if (j < rest) child.pts.push_back(reg.pts[r_eff + j]);
          queue.push_back(std::move(child));
        }
      } else {
        // cluster_equal: log2(K) rounds of median splits on alternating
        // dims starting at (level % 2 + 1); border points (== median)
        // balance the halves; children emerge ascending-sorted
        int64_t K = 1;
        int64_t lg = 0;
        while (K < Jl) { K <<= 1; ++lg; }
        int64_t dim_start = level % 2 + 1;
        std::vector<std::vector<int64_t>> regions;
        regions.emplace_back(reg.pts.begin() + r_eff, reg.pts.end());
        for (int64_t power = 0; power < lg; ++power) {
          int axis = (int)((dim_start + power) % d);
          std::vector<std::vector<int64_t>> next_regions;
          for (auto& cur : regions) {
            int64_t cn = (int64_t)cur.size();
            if (cn == 0) {
              next_regions.emplace_back();
              next_regions.emplace_back();
              continue;
            }
            vals.resize(cn);
            for (int64_t i = 0; i < cn; ++i)
              vals[i] = locs[cur[i] * d + axis];
            std::vector<double> sv(vals);
            std::nth_element(sv.begin(), sv.begin() + cn / 2, sv.end());
            double cutoff;
            if (cn % 2 == 1) {
              cutoff = sv[cn / 2];
            } else {
              double hi = sv[cn / 2];
              double lo = *std::max_element(sv.begin(), sv.begin() + cn / 2);
              cutoff = (lo + hi) / 2.0;
            }
            std::vector<int64_t> r1, r2, border;
            for (int64_t i = 0; i < cn; ++i) {
              if (vals[i] > cutoff) r1.push_back(cur[i]);
              else if (vals[i] < cutoff) r2.push_back(cur[i]);
              else border.push_back(cur[i]);
            }
            if (!border.empty()) {
              int64_t diff = std::llabs((int64_t)r1.size() - (int64_t)r2.size());
              int64_t take = std::min<int64_t>(diff, (int64_t)border.size());
              auto& small = r1.size() > r2.size() ? r2 : r1;
              small.insert(small.end(), border.begin(), border.begin() + take);
              int64_t restb = (int64_t)border.size() - take;
              int64_t half = restb / 2;
              r1.insert(r1.end(), border.begin() + take,
                        border.begin() + take + half);
              r2.insert(r2.end(), border.begin() + take + half, border.end());
            }
            next_regions.push_back(std::move(r1));
            next_regions.push_back(std::move(r2));
          }
          regions = std::move(next_regions);
        }
        // only the FINAL clusters are sorted (the Python twin keeps
        // intermediate split order, which feeds the border distribution)
        for (auto& child_pts : regions) std::sort(child_pts.begin(),
                                                  child_pts.end());
        for (auto& child_pts : regions) {
          Region child{level + 1, head, std::move(child_pts)};
          queue.push_back(std::move(child));
        }
      }
    } else {
      for (int64_t k : reg.pts) {
        chain_next[k] = head;
        chain_len[k] = head_len + 1;
        head = k;
        head_len = chain_len[k];
      }
      finest_count += 1;
      finest_total += (int64_t)reg.pts.size();
    }
  }
  eff_out[0] = eff_M;
  eff_out[1] = finest_count;
  eff_out[2] = finest_total;
  for (int64_t l = 0; l <= M; ++l)
    eff_out[3 + l] = conflict[l] ? -1 : eff_r[l];
}

// Symbolic Cholesky (Liu row-pattern algorithm) of a symmetric matrix given
// by its lower CSR pattern.  Outputs: per-column row patterns (CSC of L).
// Two-pass: first count, then fill.  Returns nnz(L); caller allocates.
int64_t symbolic_chol_count(const int64_t* indptr, const int64_t* indices,
                            int64_t n, int64_t* parent_out,
                            int64_t* colcount_out) {
  std::vector<int64_t> parent(n, -1), flag(n, -1);
  for (int64_t j = 0; j < n; ++j) colcount_out[j] = 1;  // diag
  int64_t nnz = n;
  for (int64_t i = 0; i < n; ++i) {
    flag[i] = i;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t j = indices[p];
      if (j == i) continue;
      while (flag[j] != i) {
        flag[j] = i;
        ++colcount_out[j];
        ++nnz;
        if (parent[j] == -1) parent[j] = i;
        j = parent[j];
      }
    }
  }
  std::memcpy(parent_out, parent.data(), n * sizeof(int64_t));
  return nnz;
}

// Fill pass: writes column patterns into (colptr, rows) CSC arrays; colptr
// must be precomputed from colcount.  Also writes forward row levels.
void symbolic_chol_fill(const int64_t* indptr, const int64_t* indices,
                        int64_t n, const int64_t* colptr, int64_t* rows,
                        int64_t* row_level) {
  std::vector<int64_t> parent(n, -1), flag(n, -1), next(n);
  for (int64_t j = 0; j < n; ++j) {
    next[j] = colptr[j];
    rows[next[j]++] = j;  // diag first
    row_level[j] = 0;
  }
  for (int64_t i = 0; i < n; ++i) {
    flag[i] = i;
    int64_t lev = 0;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t j = indices[p];
      if (j == i) continue;
      while (flag[j] != i) {
        flag[j] = i;
        rows[next[j]++] = i;
        if (row_level[j] + 1 > lev) lev = row_level[j] + 1;
        if (parent[j] == -1) parent[j] = i;
        j = parent[j];
      }
    }
    row_level[i] = lev;
  }
}

// Forward-solve dependency levels over a lower-triangular CSC factor
// (colptr, rows; diag first, rows ascending): level[j] = 1 + max level of
// the columns k < j appearing in row j.  Single ascending pass: column j's
// finished level pushes level[j]+1 onto every below-diagonal row.  O(nnz).
void solve_levels_fwd(const int64_t* colptr, const int64_t* rows, int64_t n,
                      int64_t* level) {
  for (int64_t j = 0; j < n; ++j) level[j] = 1;
  for (int64_t j = 0; j < n; ++j) {
    int64_t lj = level[j] + 1;
    for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p) {
      int64_t i = rows[p];
      if (i != j && level[i] < lj) level[i] = lj;
    }
  }
}

// Backward-solve dependency levels: level[j] = 1 + max level of rows below
// the diagonal in column j.  Single descending pass, O(nnz).
void solve_levels_bwd(const int64_t* colptr, const int64_t* rows, int64_t n,
                      int64_t* level) {
  for (int64_t j = n - 1; j >= 0; --j) {
    int64_t lv = 1;
    for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p) {
      int64_t i = rows[p];
      if (i != j && level[i] + 1 > lv) lv = level[i] + 1;
    }
    level[j] = lv;
  }
}

}  // extern "C"
