// Host library of optimalcontrolmps_torch: the combinatorial host work
// that feeds the card (the port's own copy of the JAX package's native
// library, the same C ABI and the same arithmetic):
//
//   * fixed-particle-number sector enumeration (the Hilbert-space "data
//     loader" behind InitializeState / BH_sites.h's QN bookkeeping),
//   * sparse (COO) assembly of the sector-restricted Bose-Hubbard
//     Hamiltonian  H = -J sum_i (a_i adag_{i+1} + adag_i a_{i+1})
//                      + U/2 sum_i n_i(n_i-1)
//     (InitializeState.hpp:42-50), used by exact ground-state preparation,
//   * linsigmoid seed-ramp batch generation (SeedGenerator.hpp:66-95) for
//     host-side multistart seeding at fleet scale.
//
// A plain C ABI for ctypes (optimalcontrolmps_torch/native.py). Built with
// g++ -O3 -march=native -shared -fPIC at first use by ops/_build.py.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <random>

namespace {

// Enumerate occupation vectors (n_0..n_{L-1}), 0 <= n_i <= d,
// sum = npart, in lexicographic order (site 0 most significant).
void enumerate_rec(int L, int d, int remaining, int site,
                   std::vector<uint8_t>& cur,
                   std::vector<uint8_t>& out) {
  if (site == L) {
    if (remaining == 0)
      out.insert(out.end(), cur.begin(), cur.end());
    return;
  }
  int sites_left = L - site - 1;
  int lo = std::max(0, remaining - d * sites_left);
  int hi = std::min(d, remaining);
  for (int n = lo; n <= hi; ++n) {
    cur[site] = static_cast<uint8_t>(n);
    enumerate_rec(L, d, remaining - n, site + 1, cur, out);
  }
}

// Binary search for a state in the lexicographically sorted table.
int64_t find_state(const uint8_t* states, int64_t n_states, int L,
                   const uint8_t* key) {
  int64_t lo = 0, hi = n_states - 1;
  while (lo <= hi) {
    int64_t mid = (lo + hi) / 2;
    int c = std::memcmp(states + mid * L, key, L);
    if (c == 0) return mid;
    if (c < 0) lo = mid + 1; else hi = mid - 1;
  }
  return -1;
}

}  // namespace

extern "C" {

// Count sector states (call first to size buffers).
int64_t ocmps_sector_count(int L, int d, int npart) {
  // DP count
  std::vector<int64_t> counts(npart + 1, 0);
  counts[0] = 1;
  for (int s = 0; s < L; ++s) {
    std::vector<int64_t> next(npart + 1, 0);
    for (int n = 0; n <= npart; ++n) {
      for (int k = std::max(0, n - d); k <= n; ++k) next[n] += counts[k];
    }
    counts.swap(next);
  }
  return counts[npart];
}

// Fill `states` (n_states x L uint8, row-major, lexicographic order).
// Returns the number written.
int64_t ocmps_sector_enumerate(int L, int d, int npart, uint8_t* states,
                               int64_t capacity) {
  std::vector<uint8_t> cur(L), out;
  out.reserve(static_cast<size_t>(capacity) * L);
  enumerate_rec(L, d, npart, 0, cur, out);
  int64_t n = static_cast<int64_t>(out.size()) / L;
  if (n > capacity) return -1;
  std::memcpy(states, out.data(), out.size());
  return n;
}

// Assemble the sector Hamiltonian in COO format.
// states: (n_states x L) from ocmps_sector_enumerate (sorted).
// rows/cols/vals: caller buffers of size >= n_states * (1 + 2*(L-1)).
// Returns the number of nonzeros written (duplicate (r,c) entries may
// appear; the caller sums duplicates, standard COO semantics).
int64_t ocmps_sector_hamiltonian(int L, int d, int npart,
                                 const uint8_t* states, int64_t n_states,
                                 double J, double U,
                                 int64_t* rows, int64_t* cols,
                                 double* vals) {
  int64_t nnz = 0;
  std::vector<uint8_t> tmp(L);
  for (int64_t k = 0; k < n_states; ++k) {
    const uint8_t* s = states + k * L;
    // interaction (diagonal)
    double diag = 0.0;
    for (int i = 0; i < L; ++i) {
      double n = s[i];
      diag += 0.5 * U * n * (n - 1.0);
    }
    rows[nnz] = k; cols[nnz] = k; vals[nnz] = diag; ++nnz;
    // hopping
    for (int i = 0; i + 1 < L; ++i) {
      int ni = s[i], nj = s[i + 1];
      if (ni >= 1 && nj + 1 <= d) {          // a_i adag_{i+1}
        std::memcpy(tmp.data(), s, L);
        tmp[i] = static_cast<uint8_t>(ni - 1);
        tmp[i + 1] = static_cast<uint8_t>(nj + 1);
        int64_t kk = find_state(states, n_states, L, tmp.data());
        rows[nnz] = kk; cols[nnz] = k;
        vals[nnz] = -J * std::sqrt(double(ni)) * std::sqrt(double(nj + 1));
        ++nnz;
      }
      if (nj >= 1 && ni + 1 <= d) {          // adag_i a_{i+1}
        std::memcpy(tmp.data(), s, L);
        tmp[i] = static_cast<uint8_t>(ni + 1);
        tmp[i + 1] = static_cast<uint8_t>(nj - 1);
        int64_t kk = find_state(states, n_states, L, tmp.data());
        rows[nnz] = kk; cols[nnz] = k;
        vals[nnz] = -J * std::sqrt(double(nj)) * std::sqrt(double(ni + 1));
        ++nnz;
      }
    }
  }
  return nnz;
}

// Batched linsigmoid seed generation (SeedGenerator.hpp:66-95):
// out is (batch x length) doubles; seed drives a counter-based mt19937
// stream per ramp (reproducible fleet seeding).
void ocmps_linsigmoid_batch(double u_start, double u_end, int length,
                            int batch, uint64_t seed, double* out) {
  for (int b = 0; b < batch; ++b) {
    std::mt19937_64 rng(seed + 0x9E3779B97F4A7C15ULL * (b + 1));
    std::uniform_real_distribution<double> ua(0.01, 0.15), uc(0.06, 0.18),
        ud(60.0, 80.0);
    double a = ua(rng), c = uc(rng), dd = ud(rng);
    double xmax = 100.0;
    double bcoef = u_end - u_start - a * xmax;
    for (int i = 0; i < length; ++i) {
      double x = 100.0 * i / (length - 1);
      double s1 = 1.0 / (1.0 + std::exp(-0.7 * (x - 5.0)));
      double s2 = 1.0 / (1.0 + std::exp(0.9 * (x - 93.0)));
      double S = (i >= length / 2) ? s2 : s1;
      if (i == 0 || i == length - 1) S = 0.0;
      double ramp = a * x + bcoef / (1.0 + std::exp(-c * (x - dd)))
                    + u_start;
      double base = (u_end - u_start) / (1.0 + std::exp(-0.2 * (x - 40.0)))
                    + u_start;
      out[static_cast<int64_t>(b) * length + i] = S * ramp + (1.0 - S) * base;
    }
  }
}

}  // extern "C"
