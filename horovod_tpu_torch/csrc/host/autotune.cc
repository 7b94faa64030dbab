// Autotuner: Gaussian-process regression + expected-improvement acquisition
// over (fusion_threshold, cycle_time), maximizing a bytes/us throughput
// score. Re-designs the reference's ParameterManager/BayesianOptimization/
// GaussianProcessRegressor (horovod/common/parameter_manager.{h,cc},
// horovod/common/optim/{bayesian_optimization,gaussian_process}.{h,cc})
// without Eigen/LBFGS: the 2-D search space is small, so a fixed
// squared-exponential kernel + Cholesky solve + random-candidate EI
// maximization gives the same behavior in ~200 self-contained lines.

#include "hvd_core.h"

#include <algorithm>
#include <cmath>
#include <cstring>
#include <mutex>
#include <random>
#include <vector>

namespace {

constexpr double kLengthScale = 0.25;   // in normalized [0,1]^2 coords
constexpr double kNoise = 1e-6;
constexpr double kXi = 0.01;            // EI exploration bonus
constexpr int kWarmupSamples = 4;       // random probes before GP kicks in
constexpr int kCandidates = 512;

double Kernel(const double* a, const double* b) {
  double d0 = a[0] - b[0], d1 = a[1] - b[1];
  return std::exp(-(d0 * d0 + d1 * d1) / (2.0 * kLengthScale * kLengthScale));
}

// Cholesky factorization of a symmetric positive-definite matrix (in place,
// lower triangle). Returns false if not SPD.
bool Cholesky(std::vector<double>& m, int n) {
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double sum = m[i * n + j];
      for (int k = 0; k < j; ++k) sum -= m[i * n + k] * m[j * n + k];
      if (i == j) {
        if (sum <= 0.0) return false;
        m[i * n + i] = std::sqrt(sum);
      } else {
        m[i * n + j] = sum / m[j * n + j];
      }
    }
  }
  return true;
}

// Solve L L^T x = b given the Cholesky factor L (lower).
void CholeskySolve(const std::vector<double>& L, int n,
                   const std::vector<double>& b, std::vector<double>& x) {
  std::vector<double> y(n);
  for (int i = 0; i < n; ++i) {
    double sum = b[i];
    for (int k = 0; k < i; ++k) sum -= L[i * n + k] * y[k];
    y[i] = sum / L[i * n + i];
  }
  x.assign(n, 0.0);
  for (int i = n - 1; i >= 0; --i) {
    double sum = y[i];
    for (int k = i + 1; k < n; ++k) sum -= L[k * n + i] * x[k];
    x[i] = sum / L[i * n + i];
  }
}

double NormCdf(double z) { return 0.5 * std::erfc(-z / std::sqrt(2.0)); }
double NormPdf(double z) {
  return std::exp(-0.5 * z * z) / std::sqrt(2.0 * M_PI);
}

struct Tuner {
  Tuner(double thr_lo, double thr_hi, double ct_lo, double ct_hi,
        uint64_t seed)
      : thr_lo(thr_lo), thr_hi(thr_hi), ct_lo(ct_lo), ct_hi(ct_hi),
        rng(seed) {}

  double thr_lo, thr_hi, ct_lo, ct_hi;
  std::mutex mutex;
  std::mt19937_64 rng;
  std::vector<double> xs;  // normalized, 2 per sample
  std::vector<double> ys;  // scores

  void Normalize(double thr, double ct, double* out) const {
    out[0] = (thr - thr_lo) / std::max(1e-12, thr_hi - thr_lo);
    out[1] = (ct - ct_lo) / std::max(1e-12, ct_hi - ct_lo);
  }

  void Denormalize(const double* in, double* thr, double* ct) const {
    *thr = thr_lo + in[0] * (thr_hi - thr_lo);
    *ct = ct_lo + in[1] * (ct_hi - ct_lo);
  }

  void Record(double thr, double ct, double score) {
    std::lock_guard<std::mutex> lock(mutex);
    double x[2];
    Normalize(thr, ct, x);
    xs.push_back(x[0]);
    xs.push_back(x[1]);
    ys.push_back(score);
  }

  void Suggest(double* thr, double* ct) {
    std::lock_guard<std::mutex> lock(mutex);
    int n = static_cast<int>(ys.size());
    std::uniform_real_distribution<double> unit(0.0, 1.0);
    if (n < kWarmupSamples) {
      double x[2] = {unit(rng), unit(rng)};
      Denormalize(x, thr, ct);
      return;
    }
    // normalize scores for GP conditioning
    double mean = 0.0, var = 0.0;
    for (double y : ys) mean += y;
    mean /= n;
    for (double y : ys) var += (y - mean) * (y - mean);
    double stdv = std::sqrt(var / std::max(1, n - 1)) + 1e-12;
    std::vector<double> y(n);
    double best = -1e300;
    for (int i = 0; i < n; ++i) {
      y[i] = (ys[i] - mean) / stdv;
      best = std::max(best, y[i]);
    }
    // K + noise I
    std::vector<double> K(static_cast<size_t>(n) * n);
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j)
        K[i * n + j] = Kernel(&xs[2 * i], &xs[2 * j]) + (i == j ? kNoise : 0);
    if (!Cholesky(K, n)) {  // degenerate: fall back to random
      double x[2] = {unit(rng), unit(rng)};
      Denormalize(x, thr, ct);
      return;
    }
    std::vector<double> alpha;
    CholeskySolve(K, n, y, alpha);

    double best_ei = -1.0;
    double best_x[2] = {unit(rng), unit(rng)};
    std::vector<double> kstar(n), v;
    for (int c = 0; c < kCandidates; ++c) {
      double x[2] = {unit(rng), unit(rng)};
      for (int i = 0; i < n; ++i) kstar[i] = Kernel(x, &xs[2 * i]);
      double mu = 0.0;
      for (int i = 0; i < n; ++i) mu += kstar[i] * alpha[i];
      CholeskySolve(K, n, kstar, v);
      double kxx = 1.0 + kNoise;
      double var_c = kxx;
      for (int i = 0; i < n; ++i) var_c -= kstar[i] * v[i];
      double sigma = std::sqrt(std::max(1e-12, var_c));
      double z = (mu - best - kXi) / sigma;
      double ei = (mu - best - kXi) * NormCdf(z) + sigma * NormPdf(z);
      if (ei > best_ei) {
        best_ei = ei;
        best_x[0] = x[0];
        best_x[1] = x[1];
      }
    }
    Denormalize(best_x, thr, ct);
  }

  int Best(double* thr, double* ct, double* score) {
    std::lock_guard<std::mutex> lock(mutex);
    if (ys.empty()) return 0;
    size_t bi = 0;
    for (size_t i = 1; i < ys.size(); ++i)
      if (ys[i] > ys[bi]) bi = i;
    Denormalize(&xs[2 * bi], thr, ct);
    *score = ys[bi];
    return 1;
  }
};

}  // namespace

void* hvd_autotune_create(double thr_lo, double thr_hi, double ct_lo,
                          double ct_hi, uint64_t seed) {
  return new Tuner(thr_lo, thr_hi, ct_lo, ct_hi, seed);
}

void hvd_autotune_destroy(void* tuner) { delete static_cast<Tuner*>(tuner); }

void hvd_autotune_record(void* tuner, double threshold, double cycle_ms,
                         double score) {
  static_cast<Tuner*>(tuner)->Record(threshold, cycle_ms, score);
}

void hvd_autotune_suggest(void* tuner, double* threshold_out,
                          double* cycle_ms_out) {
  static_cast<Tuner*>(tuner)->Suggest(threshold_out, cycle_ms_out);
}

int64_t hvd_autotune_num_samples(void* tuner) {
  auto* t = static_cast<Tuner*>(tuner);
  std::lock_guard<std::mutex> lock(t->mutex);
  return static_cast<int64_t>(t->ys.size());
}

int hvd_autotune_best(void* tuner, double* threshold_out, double* cycle_ms_out,
                      double* score_out) {
  return static_cast<Tuner*>(tuner)->Best(threshold_out, cycle_ms_out,
                                          score_out);
}
