// Native host-side runtime: binning capacity planner and CPU binning oracle.
//
// The CUDA reference's host layer sizes its scratch buffers dynamically from
// device-side counts (resize_functional + cudaMemcpy sync, sample_points.cu:
// 29-35, sampler_impl.cu:256-257).  The JAX engine needs *static* capacities
// before tracing (entry capacity, per-axis duplicate cap R, sweep work-block
// caps, neighbor capacity).  This module computes them on the host in one
// O(P + N + T) pass over the raw arrays - a counting-sort binning identical
// in semantics to binning/grid.py - so the facade and training scripts can
// pick tight capacities without device round-trips or recompiles-by-trial.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline double radius_from_cov(const float* cov, int D, double radius_sigma,
                              double eig_floor) {
  // Mirrors oracle/dense.py radii() (and forward.cu:52-61).
  if (D == 1) {
    return radius_sigma * std::sqrt(std::max(0.0, (double)cov[0]));
  }
  if (D == 2) {
    double det = (double)cov[0] * cov[2] - (double)cov[1] * cov[1];
    double scale = std::abs((double)cov[0] * cov[2]) + (double)cov[1] * cov[1];
    if (std::abs(det) <= 1e-6 * scale + 1e-30) return 0.0;
    double mid = 0.5 * ((double)cov[0] + cov[2]);
    double lam = mid + std::sqrt(std::max(eig_floor, mid * mid - det));
    return radius_sigma * std::sqrt(std::max(0.0, lam));
  }
  // D == 3: trigonometric closed form for lambda_max of symmetric 3x3.
  double a00 = cov[0], a01 = cov[1], a02 = cov[2];
  double a11 = cov[3], a12 = cov[4], a22 = cov[5];
  double q = (a00 + a11 + a22) / 3.0;
  double b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
  double p2 = (b00 * b00 + b11 * b11 + b22 * b22 +
               2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0;
  double p = std::sqrt(std::max(p2, 1e-30));
  double detB = b00 * (b11 * a22 - q * b11 - a12 * a12) -
                a01 * (a01 * (a22 - q) - a12 * a02) +
                a02 * (a01 * a12 - (a11 - q) * a02);
  double r = detB / (2.0 * p * p * p);
  r = std::min(1.0, std::max(-1.0, r));
  double phi = std::acos(r) / 3.0;
  double lam = q + 2.0 * p * std::cos(phi);
  return radius_sigma * std::sqrt(std::max(0.0, lam));
}

// Per-axis AABB radii (oracle/dense.py radii_axis): tight bounding box of
// the same sigma ellipsoid; culling (det == 0 -> all axes 0) follows the
// scalar radius.  Writes D values into out; returns the scalar radius.
inline double radius_axes(const float* cov, int D, double radius_sigma,
                          double eig_floor, double* out) {
  double r = radius_from_cov(cov, D, radius_sigma, eig_floor);
  static const int diag1[1] = {0};
  static const int diag2[2] = {0, 2};
  static const int diag3[3] = {0, 3, 5};
  const int* diag = D == 1 ? diag1 : (D == 2 ? diag2 : diag3);
  for (int d = 0; d < D; ++d) {
    out[d] = r <= 0.0
                 ? 0.0
                 : radius_sigma *
                       std::sqrt(std::max(0.0, (double)cov[diag[d]]));
  }
  return r;
}

// Packed-tri inverse of a packed-tri covariance (binning/grid.py
// conics_from_cov).  Returns false when det <= 0 (no conic: keep all
// tiles; such rows are det-culled by the radius anyway).
inline bool conic_from_cov(const float* cov, int D, double* Q) {
  if (D == 2) {
    double det = (double)cov[0] * cov[2] - (double)cov[1] * cov[1];
    if (det <= 0.0) return false;
    Q[0] = cov[2] / det;
    Q[1] = -cov[1] / det;
    Q[2] = cov[0] / det;
    return true;
  }
  double a00 = cov[0], a01 = cov[1], a02 = cov[2];
  double a11 = cov[3], a12 = cov[4], a22 = cov[5];
  double q00 = a11 * a22 - a12 * a12;
  double q01 = a02 * a12 - a01 * a22;
  double q02 = a01 * a12 - a02 * a11;
  double q11 = a00 * a22 - a02 * a02;
  double q12 = a01 * a02 - a00 * a12;
  double q22 = a00 * a11 - a01 * a01;
  double det = a00 * q00 + a01 * q01 + a02 * q02;
  if (det <= 0.0) return false;
  Q[0] = q00 / det;
  Q[1] = q01 / det;
  Q[2] = q02 / det;
  Q[3] = q11 / det;
  Q[4] = q12 / det;
  Q[5] = q22 / det;
  return true;
}

// Exact ellipsoid-vs-tile test (binning/grid.py ellip_keep): clamped cyclic
// coordinate descent on min_{y in box} y^T Q y, 4 sweeps from the Euclidean
// projection of the mean; keep iff the found minimum is within (1 + 1e-3)
// of radius_sigma^2.  Q is packed-tri; blo/bhi are the tile box centered on
// the mean.
inline bool ellip_keep_tile(const double* Q, int D, const double* blo,
                            const double* bhi, double sigma2) {
  static const int tri2[2][2] = {{0, 1}, {1, 2}};
  static const int tri3[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
  double y[3];
  for (int d = 0; d < D; ++d)
    y[d] = std::min(std::max(0.0, blo[d]), bhi[d]);
  for (int it = 0; it < 4; ++it) {  // = grid.ELLIP_CULL_SWEEPS
    for (int d = 0; d < D; ++d) {
      double num = 0.0, qdd = 0.0;
      for (int e = 0; e < D; ++e) {
        double q = D == 2 ? Q[tri2[d][e]] : Q[tri3[d][e]];
        if (e == d)
          qdd = q;
        else
          num += q * y[e];
      }
      y[d] = std::min(std::max(-num / std::max(qdd, 1e-30), blo[d]), bhi[d]);
    }
  }
  double f = 0.0;
  for (int d = 0; d < D; ++d)
    for (int e = 0; e < D; ++e)
      f += (D == 2 ? Q[tri2[d][e]] : Q[tri3[d][e]]) * y[d] * y[e];
  return f <= sigma2 * (1.0 + 1e-3);
}

}  // namespace

extern "C" {

// Plan capacities for the tiled pipeline.
//
// Inputs: means (P*D), covariances (P*tri), samples (N*D), config scalars.
// Outputs (out, int64[8]):
//   [0] total valid (gaussian, tile) entries      -> entry capacity
//   [1] max per-axis rect extent                  -> max_tiles_per_gaussian R
//   [2] max entries in any single tile
//   [3] max samples in any single tile
//   [4] forward work blocks needed (given block_n, block_e)
//   [5] backward work blocks needed (given block_e_b, block_n_b)
//   [6] number of culled (zero-radius) gaussians
//   [7] number of occupied tiles
// Returns 0 on success, nonzero on bad arguments.
int dgs_plan_capacities(
    const float* means, const float* covariances, const float* samples,
    int64_t P, int64_t N, int32_t D,
    double lower0, double lower1, double lower2,
    double extent0, double extent1, double extent2,
    double tile_size, int32_t periodic,
    double radius_sigma, double eig_floor,
    int32_t block_n, int32_t block_e, int32_t block_e_b, int32_t block_n_b,
    int32_t axis_radii, int32_t ellip_cull,
    int64_t* out) {
  if (D < 1 || D > 3 || P < 0 || N < 0) return 1;
  const double lower[3] = {lower0, lower1, lower2};
  // Per-axis world extents (anisotropic open boxes are first-class; the
  // periodic torus passes the period on every axis) - mirrors
  // SamplerConfig.grid_shape.
  const double extent[3] = {extent0, extent1, extent2};
  int64_t grid[3] = {1, 1, 1};
  int64_t T = 1;
  for (int d = 0; d < D; ++d) {
    // Periodic: SamplerConfig snaps tile_size to period/grid
    // (config.py __post_init__), so the division is integral up to float
    // rounding - round, don't ceil (mirrors grid_shape()).
    grid[d] = periodic
                  ? std::max((int64_t)1, (int64_t)std::llround(
                                             extent[d] / tile_size))
                  : (int64_t)std::ceil((extent[d] + 1e-6) / tile_size);
    T *= grid[d];
  }
  const int tri = D * (D + 1) / 2;

  std::vector<int64_t> tile_entries((size_t)T, 0);
  std::vector<int64_t> tile_samples((size_t)T, 0);

  int64_t total_entries = 0, max_extent = 0, culled = 0;
  for (int64_t p = 0; p < P; ++p) {
    double rax[3];
    double rad = axis_radii
                     ? radius_axes(covariances + p * tri, D, radius_sigma,
                                   eig_floor, rax)
                     : radius_from_cov(covariances + p * tri, D,
                                       radius_sigma, eig_floor);
    if (rad <= 0.0) {
      ++culled;
      continue;
    }
    int64_t lo[3], hi[3];
    bool full_cover = false;
    for (int d = 0; d < D; ++d) {
      double m = means[p * D + d];
      double rd = axis_radii ? rax[d] : rad;
      lo[d] = (int64_t)std::floor((m - lower[d] - rd) / tile_size);
      hi[d] = (int64_t)std::ceil((m - lower[d] + rd) / tile_size);
      if (!periodic) {
        lo[d] = std::min(std::max(lo[d], (int64_t)0), grid[d]);
        hi[d] = std::min(std::max(hi[d], (int64_t)0), grid[d]);
      }
      if (hi[d] - lo[d] >= grid[d]) {
        lo[d] = 0;
        hi[d] = grid[d];
        full_cover = true;
      }
      max_extent = std::max(max_extent, hi[d] - lo[d]);
    }
    // Ellipsoid-vs-tile cull (cfg.ellip_cull; mirrors binning/grid.py
    // ellip_keep): full covers and conic-less rows keep every tile.
    double Q[6];
    bool do_cull = ellip_cull && D >= 2 && !full_cover &&
                   conic_from_cov(covariances + p * tri, D, Q);
    double sigma2 = radius_sigma * radius_sigma;
    auto keep = [&](const int64_t* idx) {
      if (!do_cull) return true;
      double blo[3], bhi[3];
      for (int d = 0; d < D; ++d) {
        blo[d] = lower[d] + (double)idx[d] * tile_size - means[p * D + d];
        bhi[d] = blo[d] + tile_size;
      }
      return ellip_keep_tile(Q, D, blo, bhi, sigma2);
    };
    // Tally per-tile entry counts (wrapped).
    int64_t idx[3];
    for (idx[0] = lo[0]; idx[0] < (D > 0 ? hi[0] : lo[0] + 1); ++idx[0]) {
      int64_t t0 = periodic ? ((idx[0] % grid[0]) + grid[0]) % grid[0] : idx[0];
      if (D == 1) {
        ++tile_entries[(size_t)t0];
        ++total_entries;
        continue;
      }
      for (idx[1] = lo[1]; idx[1] < hi[1]; ++idx[1]) {
        int64_t t1 = periodic ? ((idx[1] % grid[1]) + grid[1]) % grid[1]
                              : idx[1];
        if (D == 2) {
          if (!keep(idx)) continue;
          ++tile_entries[(size_t)(t0 * grid[1] + t1)];
          ++total_entries;
          continue;
        }
        for (idx[2] = lo[2]; idx[2] < hi[2]; ++idx[2]) {
          int64_t t2 = periodic ? ((idx[2] % grid[2]) + grid[2]) % grid[2]
                                : idx[2];
          if (!keep(idx)) continue;
          ++tile_entries[(size_t)((t0 * grid[1] + t1) * grid[2] + t2)];
          ++total_entries;
        }
      }
    }
  }

  for (int64_t n = 0; n < N; ++n) {
    int64_t t = 0;
    for (int d = 0; d < D; ++d) {
      int64_t td = (int64_t)std::floor((samples[n * D + d] - lower[d]) /
                                       tile_size);
      td = std::min(std::max(td, (int64_t)0), grid[d] - 1);
      t = t * grid[d] + td;
    }
    ++tile_samples[(size_t)t];
  }

  int64_t max_te = 0, max_ts = 0, occupied = 0;
  std::vector<int64_t> ent_cum((size_t)T + 1, 0), smp_cum((size_t)T + 1, 0);
  for (int64_t t = 0; t < T; ++t) {
    max_te = std::max(max_te, tile_entries[(size_t)t]);
    max_ts = std::max(max_ts, tile_samples[(size_t)t]);
    if (tile_entries[(size_t)t] || tile_samples[(size_t)t]) ++occupied;
    ent_cum[(size_t)t + 1] = ent_cum[(size_t)t] + tile_entries[(size_t)t];
    smp_cum[(size_t)t + 1] = smp_cum[(size_t)t] + tile_samples[(size_t)t];
  }

  // Exact sweep lengths (the host mirror of binning/grid.py
  // _range_geometry): sorted row block [r0, r1] spans tiles
  // [tile_of(r0), tile_of(r1)]; its column sweep covers
  // [col_cum[t_lo], col_cum[t_hi + 1]) in col_block granules.
  auto tile_of = [T](const std::vector<int64_t>& cum, int64_t row) {
    auto it = std::upper_bound(cum.begin(), cum.end(), row);
    return std::min<int64_t>(T - 1, (it - cum.begin()) - 1);
  };
  // Per-row-block sweep lengths; both the per-block max (rectangular cap)
  // and the total (flattened work-list capacity; every row block counts at
  // least one item, mirroring kernels/tiled.py work_list).
  auto sweep_stats = [&](const std::vector<int64_t>& row_cum, int64_t n_rows,
                         int32_t row_block, const std::vector<int64_t>& col_cum,
                         int32_t col_block, int64_t* worst, int64_t* total) {
    *worst = 0;
    *total = 0;
    for (int64_t r0 = 0; r0 < n_rows; r0 += row_block) {
      int64_t r1 = std::min(r0 + row_block, n_rows) - 1;
      int64_t lo = col_cum[(size_t)tile_of(row_cum, r0)];
      int64_t hi = col_cum[(size_t)tile_of(row_cum, r1) + 1];
      int64_t nblk = 0;
      if (hi > lo) {
        int64_t base = lo / col_block;
        nblk = (hi - base * col_block + col_block - 1) / col_block;
      }
      *worst = std::max(*worst, nblk);
      *total += std::max<int64_t>(nblk, 1);
    }
  };

  int64_t fwd_worst, fwd_total, bwd_worst, bwd_total;
  sweep_stats(smp_cum, N, block_n, ent_cum, block_e, &fwd_worst, &fwd_total);
  sweep_stats(ent_cum, total_entries, block_e_b, smp_cum, block_n_b,
              &bwd_worst, &bwd_total);

  out[0] = total_entries;
  out[1] = max_extent;
  out[2] = max_te;
  out[3] = max_ts;
  out[4] = fwd_worst;
  out[5] = bwd_worst;
  out[6] = culled;
  out[7] = occupied;
  out[8] = fwd_total;
  out[9] = bwd_total;
  return 0;
}

// Max neighbor-candidate count for the aggregation subsystem: for each
// gaussian, how many others' shrunk bounding circles overlap its own
// (findCollisions semantics, aggregate_neighbors.cu:18-55, with true
// min-image distance).  O(P^2) reference implementation on the host, meant
// for capacity planning at moderate P.
int64_t dgs_max_collisions(const float* means, const float* radii, int64_t P,
                           int32_t D, double period, int32_t periodic) {
  int64_t worst = 0;
  for (int64_t i = 0; i < P; ++i) {
    double ri = radii[i] * 0.2;
    if (ri < 1e-6) continue;
    int64_t cnt = 0;
    for (int64_t j = 0; j < P; ++j) {
      double rj = radii[j] * 0.2;
      if (rj < 1e-6) continue;
      double d2 = 0.0;
      for (int d = 0; d < D; ++d) {
        double dx = (double)means[j * D + d] - means[i * D + d];
        if (periodic) dx -= period * std::nearbyint(dx / period);
        d2 += dx * dx;
      }
      double rr = ri + rj;
      if (d2 <= rr * rr) ++cnt;
    }
    worst = std::max(worst, cnt);
  }
  return worst;
}

}  // extern "C"
