// Greedy cover decimation of a point set (host-side, setup-time): the
// support points of decim support (DiffPSR.set_support_scheme("decim")).
//
// The reference's greedy decimation (reference diffICP/tools/point_sets.py
// :102-133): repeatedly keep the point covering the most not-yet-covered
// neighbours within radius r (the lowest index among equals), until every
// point is covered.  The points are bucketed into grid cells of side r, so a
// point's neighbours are found in its 3^d adjacent cells; the uncovered
// degrees are kept up to date as points are covered.  The plain version
// (difficp_torch/utils/point_sets.py decimate_reference) is O(N^2) per pick.
//
// The same algorithm, arithmetic and tie rule as the JAX package's
// native/decimate.cpp, so both give the same kept indices.  Built with g++
// by difficp_torch/ops/_build.py host_library() and loaded with ctypes by
// difficp_torch/utils/point_sets.py.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct CellKey {
  int64_t v;
  bool operator==(const CellKey &o) const { return v == o.v; }
};
struct CellHash {
  size_t operator()(const CellKey &k) const {
    return std::hash<int64_t>()(k.v * 0x9E3779B97F4A7C15ull);
  }
};

// pack up to 3 21-bit signed cell coords into one int64
inline int64_t pack(int cx, int cy, int cz) {
  auto enc = [](int c) -> int64_t { return (int64_t)(c + (1 << 20)) & 0x1FFFFF; };
  return enc(cx) | (enc(cy) << 21) | (enc(cz) << 42);
}

}  // namespace

extern "C" {

// points: n x d row-major float32 (d <= 3); r: coverage radius.
// out_kept: caller-allocated int32 buffer of size n; returns #kept.
int difficp_decimate(const float *points, int n, int d, float r,
                     int32_t *out_kept) {
  if (n <= 0) return 0;
  const float r2 = r * r;
  const float cell = r > 0 ? r : 1e-9f;

  // bucket points into grid cells of side r
  std::unordered_map<CellKey, std::vector<int>, CellHash> grid;
  auto cell_of = [&](int i, int dim) -> int {
    return (int)std::floor(points[(size_t)i * d + dim] / cell);
  };
  auto key_of = [&](int i) -> CellKey {
    int cx = cell_of(i, 0);
    int cy = d > 1 ? cell_of(i, 1) : 0;
    int cz = d > 2 ? cell_of(i, 2) : 0;
    return CellKey{pack(cx, cy, cz)};
  };
  grid.reserve((size_t)n * 2);
  for (int i = 0; i < n; ++i) grid[key_of(i)].push_back(i);

  auto sqdist = [&](int i, int j) -> float {
    float s = 0;
    for (int k = 0; k < d; ++k) {
      float diff = points[(size_t)i * d + k] - points[(size_t)j * d + k];
      s += diff * diff;
    }
    return s;
  };

  // neighbour list within r for a point (scan 3^d adjacent cells)
  std::vector<int> tmp;
  auto neighbours = [&](int i, std::vector<int> &out) {
    out.clear();
    int cx = cell_of(i, 0);
    int cy = d > 1 ? cell_of(i, 1) : 0;
    int cz = d > 2 ? cell_of(i, 2) : 0;
    int zlo = d > 2 ? -1 : 0, zhi = d > 2 ? 1 : 0;
    int ylo = d > 1 ? -1 : 0, yhi = d > 1 ? 1 : 0;
    for (int dz = zlo; dz <= zhi; ++dz)
      for (int dy = ylo; dy <= yhi; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
          auto it = grid.find(CellKey{pack(cx + dx, cy + dy, cz + dz)});
          if (it == grid.end()) continue;
          for (int j : it->second)
            if (sqdist(i, j) <= r2) out.push_back(j);
        }
  };

  // uncovered-degree of every point; greedy max pick with lazy updates
  std::vector<uint8_t> covered(n, 0);
  std::vector<int> degree(n, 0);
  for (int i = 0; i < n; ++i) {
    neighbours(i, tmp);
    degree[i] = (int)tmp.size();
  }

  int n_kept = 0;
  int n_covered = 0;
  while (n_covered < n) {
    // argmax of uncovered-neighbour count among still-uncovered candidates
    // (matches the reference's restriction to `notcovered`,
    // point_sets.py:123-126)
    int best = -1, best_deg = -1;
    for (int i = 0; i < n; ++i) {
      if (covered[i]) continue;
      if (degree[i] > best_deg) {
        best_deg = degree[i];
        best = i;
      }
    }
    if (best < 0) break;  // should not happen
    out_kept[n_kept++] = best;
    neighbours(best, tmp);
    for (int j : tmp) {
      if (!covered[j]) {
        covered[j] = 1;
        ++n_covered;
        // decrement degree of j's neighbours (they cover one fewer new pt)
        std::vector<int> nb2;
        neighbours(j, nb2);
        for (int l : nb2) --degree[l];
      }
    }
  }
  return n_kept;
}

}  // extern "C"
