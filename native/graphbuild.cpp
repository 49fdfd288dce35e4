// Native dataset-builder kernels for diffusion_model.
//
// The reference reaches native code for neighbour analysis only through
// pymatgen/PyG internals (SURVEY.md §2.7); here the host-side hot path of
// dataset construction — 3x3x3 supercell expansion and bonded-shell BFS over
// the O((27N)^2) distance structure (ref make_dataset.py:79-107) — is a
// small C++ library bound via ctypes (see data/native.py), with the numpy
// implementation in data/shells.py as the behavioural oracle.
//
// Build: g++ -O3 -march=native -shared -fPIC graphbuild.cpp -o libgraphbuild.so

#include <cmath>
#include <cstdint>
#include <vector>
#include <algorithm>
#include <set>

namespace {

struct Vec3 {
  double x, y, z;
};

inline Vec3 cart(const double* lat, double fa, double fb, double fc) {
  // row-vector lattice: cart = frac @ lattice
  return Vec3{
      fa * lat[0] + fb * lat[3] + fc * lat[6],
      fa * lat[1] + fb * lat[4] + fc * lat[7],
      fa * lat[2] + fb * lat[5] + fc * lat[8],
  };
}

inline double dist2(const Vec3& a, const Vec3& b) {
  const double dx = a.x - b.x, dy = a.y - b.y, dz = a.z - b.z;
  return dx * dx + dy * dy + dz * dz;
}

}  // namespace

extern "C" {

// Bonded-shell BFS around the excited atom in a 3x3x3 supercell.
//
//   lattice   : 3x3 row-major row-vector lattice matrix
//   frac      : n x 3 fractional coordinates of the unit cell
//   n         : number of unit-cell sites
//   exo_index : excited-atom site index in the unit cell
//   n_shells  : BFS depth (1 = exO's bonded neighbours, 2 = 2NN, ...)
//   cutoff    : bond cutoff in Angstrom (< cutoff, > 0)
//   out_pos   : [max_out * 3] cartesian coords relative to exO (exO first)
//   out_src   : [max_out] original unit-cell site index of each atom
//   max_out   : capacity of the output buffers
//
// Returns the number of atoms written (exO included), or -1 on overflow.
// Selection and ordering match data/shells.py exactly: exO first, then the
// remaining supercell indices ascending.
int build_shells(const double* lattice, const double* frac, int n,
                 int exo_index, int n_shells, double cutoff,
                 double* out_pos, int32_t* out_src, int max_out) {
  const int total = 27 * n;
  std::vector<Vec3> pos(total);
  std::vector<int32_t> src(total);
  int exo_super = -1;
  int idx = 0;
  for (int i = -1; i <= 1; ++i) {
    for (int j = -1; j <= 1; ++j) {
      for (int k = -1; k <= 1; ++k) {
        const bool central = (i == 0 && j == 0 && k == 0);
        for (int s = 0; s < n; ++s, ++idx) {
          pos[idx] = cart(lattice, frac[3 * s] + i, frac[3 * s + 1] + j,
                          frac[3 * s + 2] + k);
          src[idx] = static_cast<int32_t>(s);
          if (central && s == exo_index) exo_super = idx;
        }
      }
    }
  }
  if (exo_super < 0) return -1;

  const double cut2 = cutoff * cutoff;
  std::set<int> collected;
  std::vector<int> frontier{exo_super};
  for (int shell = 0; shell < n_shells; ++shell) {
    std::set<int> next;
    for (int c : frontier) {
      const Vec3& pc = pos[c];
      for (int t = 0; t < total; ++t) {
        if (t == c) continue;
        const double d2 = dist2(pc, pos[t]);
        if (d2 < cut2 && d2 > 0.0) next.insert(t);
      }
    }
    frontier.clear();
    for (int t : next) {
      if (t != exo_super && !collected.count(t)) {
        collected.insert(t);
        frontier.push_back(t);
      }
    }
  }

  const int count = 1 + static_cast<int>(collected.size());
  if (count > max_out) return -1;

  const Vec3 origin = pos[exo_super];
  out_pos[0] = 0.0;
  out_pos[1] = 0.0;
  out_pos[2] = 0.0;
  out_src[0] = src[exo_super];
  int w = 1;
  for (int t : collected) {  // std::set iterates ascending
    out_pos[3 * w] = pos[t].x - origin.x;
    out_pos[3 * w + 1] = pos[t].y - origin.y;
    out_pos[3 * w + 2] = pos[t].z - origin.z;
    out_src[w] = src[t];
    ++w;
  }
  return count;
}

// Dense pairwise distance matrix (row-major n x n) — the generic native
// analogue of pymatgen's Structure.distance_matrix for non-periodic use.
void distance_matrix(const double* pos, int n, double* out) {
  for (int i = 0; i < n; ++i) {
    out[i * n + i] = 0.0;
    for (int j = i + 1; j < n; ++j) {
      const double dx = pos[3 * i] - pos[3 * j];
      const double dy = pos[3 * i + 1] - pos[3 * j + 1];
      const double dz = pos[3 * i + 2] - pos[3 * j + 2];
      const double d = std::sqrt(dx * dx + dy * dy + dz * dz);
      out[i * n + j] = d;
      out[j * n + i] = d;
    }
  }
}

// Fixed-degree k-nearest-neighbour lists for large cells (host-side
// preprocessing twin of ops/edges.knn_edges).
void knn_indices(const double* pos, int n, int k, int32_t* out_idx) {
  std::vector<std::pair<double, int>> cand(n - 1);
  for (int i = 0; i < n; ++i) {
    int c = 0;
    for (int j = 0; j < n; ++j) {
      if (j == i) continue;
      const double dx = pos[3 * i] - pos[3 * j];
      const double dy = pos[3 * i + 1] - pos[3 * j + 1];
      const double dz = pos[3 * i + 2] - pos[3 * j + 2];
      cand[c++] = {dx * dx + dy * dy + dz * dz, j};
    }
    const int kk = std::min(k, n - 1);
    std::partial_sort(cand.begin(), cand.begin() + kk, cand.end());
    for (int q = 0; q < k; ++q) {
      out_idx[i * k + q] = q < kk ? cand[q].second : -1;
    }
  }
}

}  // extern "C"
