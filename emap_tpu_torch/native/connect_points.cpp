// Greedy bidirectional polyline growth over oriented edge points.
//
// Native implementation of the extraction stage's sequential hot spot
// (emap_tpu_torch/extract/fitting.py::connect_points; reference algorithm at
// src/edge_extraction/edge_fitting/main.py:93-228). The port's own copy of
// emap_tpu/native/connect_points.cpp, the same code, so both packages grow
// the same polylines from the same points and seed. The numpy version scans
// all unvisited points per attachment step (O(N) per step, O(N^2) total) --
// minutes at the 256^3 DTU/Replica extraction sizes. Here a uniform spatial
// hash grid answers the radius queries, making growth O(N * k).
//
// Exposed via a C ABI for ctypes (no pybind11 in this image):
//   emap_connect_points(points6[N*6], n, dist_thresh, angle_thresh,
//                       nms_factor, keep_short, seed,
//                       out_indices[N], out_offsets[N+1], &n_polylines)
// out_indices holds polyline point indices back to back; out_offsets[i..i+1)
// delimits polyline i. Returns 0 on success.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <random>
#include <unordered_map>
#include <vector>

namespace {

struct Grid {
  double cell;
  double mn[3];
  std::unordered_map<int64_t, std::vector<int32_t>> cells;

  static int64_t key(int64_t ix, int64_t iy, int64_t iz) {
    return (ix * 73856093LL) ^ (iy * 19349663LL) ^ (iz * 83492791LL);
  }

  void build(const double* pts, int64_t n, double cell_size) {
    cell = cell_size;
    mn[0] = mn[1] = mn[2] = 1e30;
    for (int64_t i = 0; i < n; ++i) {
      for (int d = 0; d < 3; ++d) {
        double v = pts[i * 6 + d];
        if (v < mn[d]) mn[d] = v;
      }
    }
    cells.reserve(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
      int64_t ix = static_cast<int64_t>((pts[i * 6 + 0] - mn[0]) / cell);
      int64_t iy = static_cast<int64_t>((pts[i * 6 + 1] - mn[1]) / cell);
      int64_t iz = static_cast<int64_t>((pts[i * 6 + 2] - mn[2]) / cell);
      cells[key(ix, iy, iz)].push_back(static_cast<int32_t>(i));
    }
  }

  template <typename F>
  void for_neighbors(const double* pts, const double* p, F&& f) const {
    int64_t ix = static_cast<int64_t>((p[0] - mn[0]) / cell);
    int64_t iy = static_cast<int64_t>((p[1] - mn[1]) / cell);
    int64_t iz = static_cast<int64_t>((p[2] - mn[2]) / cell);
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy)
        for (int64_t dz = -1; dz <= 1; ++dz) {
          auto it = cells.find(key(ix + dx, iy + dy, iz + dz));
          if (it == cells.end()) continue;
          for (int32_t j : it->second) f(j);
        }
  }
};

struct Candidate {
  int32_t idx;
  double dist;
  double dot;   // direction(anchor->cand) . line_dir(anchor)
  double ox, oy, oz;  // unit offset
};

}  // namespace

extern "C" int emap_connect_points(
    const double* pts,       // (n, 6): xyz + unit line direction
    int64_t n,
    double distance_threshold,
    double angle_threshold,
    double nms_factor,
    int keep_short_lines,
    uint64_t seed,
    int32_t* out_indices,    // capacity n
    int64_t* out_offsets,    // capacity n + 1
    int64_t* n_polylines) {
  if (n <= 0) {
    *n_polylines = 0;
    out_offsets[0] = 0;
    return 0;
  }

  Grid grid;
  grid.build(pts, n, distance_threshold);

  std::vector<uint8_t> unvisited(static_cast<size_t>(n), 1);
  std::vector<int32_t> order(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) order[i] = static_cast<int32_t>(i);
  std::mt19937_64 rng(seed);
  // random seed-point order (matches the python version's random seeding of
  // growth starts; sequences differ, statistics match)
  for (int64_t i = n - 1; i > 0; --i) {
    std::uniform_int_distribution<int64_t> d(0, i);
    std::swap(order[i], order[d(rng)]);
  }

  std::vector<Candidate> cands;
  cands.reserve(256);
  std::vector<int32_t> line;
  line.reserve(1024);

  int64_t out_pos = 0;
  int64_t n_lines = 0;
  out_offsets[0] = 0;

  auto gather = [&](int32_t anchor) {
    cands.clear();
    const double* pa = pts + static_cast<int64_t>(anchor) * 6;
    grid.for_neighbors(pts, pa, [&](int32_t j) {
      if (!unvisited[j]) return;
      const double* pj = pts + static_cast<int64_t>(j) * 6;
      double ox = pj[0] - pa[0], oy = pj[1] - pa[1], oz = pj[2] - pa[2];
      double dist = std::sqrt(ox * ox + oy * oy + oz * oz);
      if (dist >= distance_threshold) return;
      double inv = 1.0 / (dist + 1e-6);
      ox *= inv; oy *= inv; oz *= inv;
      double dot = ox * pa[3] + oy * pa[4] + oz * pa[5];
      cands.push_back({j, dist, dot, ox, oy, oz});
    });
  };

  auto grow = [&](int32_t start, bool forward) {
    int32_t anchor = start;
    while (true) {
      gather(anchor);
      if (cands.empty()) return;
      int best = -1;
      for (size_t c = 0; c < cands.size(); ++c) {
        if (best < 0 ||
            (forward ? cands[c].dot > cands[best].dot
                     : cands[c].dot < cands[best].dot))
          best = static_cast<int>(c);
      }
      const Candidate& bc = cands[best];
      if (forward) {
        if (bc.dot <= 1.0 - angle_threshold) return;
      } else {
        if (std::fabs(bc.dot) <= 1.0 - angle_threshold || bc.dot >= 0.0)
          return;
      }
      if (forward)
        line.push_back(bc.idx);
      else
        line.insert(line.begin(), bc.idx);

      // NMS: suppress closer near-collinear competitors
      for (const Candidate& c : cands) {
        bool kill = forward
            ? (c.dist <= bc.dist && c.dot < bc.dot &&
               c.dot >= nms_factor * bc.dot)
            : (c.dist <= bc.dist && c.dot > bc.dot &&
               c.dot <= nms_factor * bc.dot);
        if (kill) unvisited[c.idx] = 0;
      }

      const double* pb = pts + static_cast<int64_t>(bc.idx) * 6;
      double sign = forward ? 1.0 : -1.0;
      double agree =
          sign * (pb[3] * bc.ox + pb[4] * bc.oy + pb[5] * bc.oz);
      if (agree <= 0.5) return;

      unvisited[bc.idx] = 0;
      anchor = bc.idx;
    }
  };

  for (int64_t oi = 0; oi < n; ++oi) {
    int32_t seed_pt = order[oi];
    if (!unvisited[seed_pt]) continue;
    unvisited[seed_pt] = 0;
    line.clear();
    line.push_back(seed_pt);
    grow(seed_pt, /*forward=*/true);
    grow(seed_pt, /*forward=*/false);

    size_t min_len = keep_short_lines ? 1 : 3;
    if (line.size() > min_len) {
      std::memcpy(out_indices + out_pos, line.data(),
                  line.size() * sizeof(int32_t));
      out_pos += static_cast<int64_t>(line.size());
      ++n_lines;
      out_offsets[n_lines] = out_pos;
    }
  }
  *n_polylines = n_lines;
  return 0;
}
