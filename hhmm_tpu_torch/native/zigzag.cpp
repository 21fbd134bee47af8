// Native zig-zag feature extraction — the host-side hot path of the
// Tayal (2009) pipeline (`tayal2009/R/feature-extraction.R:8-133`; the
// reference flags its per-leg `find_leg` linear scan at `:112` as the
// bottleneck). The TPU framework keeps feature extraction on host by
// design (data-dependent compression, variable output length —
// SURVEY.md §7.3); this library makes that host stage native: one
// sequential pass per series, and a std::thread pool over batches for
// the walk-forward workloads (`tayal2009/R/wf-trade.R` runs ~204
// feature extractions per backtest).
//
// Semantics mirror apps/tayal/features.py's NumPy engine exactly; the
// Python wrapper (native/zigzag.py) is held against it in tests.
//
// C ABI: all functions return n_legs >= 0 on success or a negative
// error code (ZZ_ERR_*). Caller allocates outputs with capacity T.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

enum {
  ZZ_ERR_TOO_FEW_TICKS = -1,    // T < 3
  ZZ_ERR_TOO_FEW_CHANGES = -2,  // fewer than 6 direction changes
  ZZ_ERR_BAD_TRIPLE = -3,       // (f0,f1,f2) not in the 18-symbol table
};

// (f0, f1, f2) in {-1,0,1}^3 -> 1..18 symbol (feature-extraction.R:92-110);
// 0 = invalid triple. Index = (f0+1)*9 + (f1+1)*3 + (f2+1).
static const int32_t LEG_CUBE[27] = {
    // f0 = -1 (minima -> down legs D1..D9, coded 10..18)
    11, 16, 18,  // f1=-1: f2=-1,0,1
    13, 14, 15,  // f1= 0
    10, 12, 17,  // f1=+1
    // f0 = 0 (never produced)
    0, 0, 0, 0, 0, 0, 0, 0, 0,
    // f0 = +1 (maxima -> up legs U1..U9, coded 1..9)
    9, 7, 2,    // f1=-1
    6, 5, 4,    // f1= 0
    8, 3, 1,    // f1=+1
};

static inline int discretize(double ratio, double alpha) {
  // NaN/inf ratios (zero-volume legs) compare false on both sides -> 0,
  // matching numpy's errstate-suppressed where() chain
  if (ratio - 1.0 > alpha) return 1;
  if (1.0 - ratio > alpha) return -1;
  return 0;
}

// Single-series extraction. price/size/tsec: [T]. Outputs (capacity T):
// leg_price, start, end, size_av, f0, f1, f2, feature, trend.
int64_t zz_extract(const double* price, const double* size,
                   const double* tsec, int64_t T, double alpha,
                   double* leg_price, int64_t* start, int64_t* end,
                   double* size_av, int64_t* f0, int64_t* f1, int64_t* f2,
                   int64_t* feature, int64_t* trend) {
  if (T < 3) return ZZ_ERR_TOO_FEW_TICKS;

  // --- zig-zag change points (feature-extraction.R:19-36) ---
  // direction[t] = sign(price[t] - price[t-1]); a change tick is one
  // whose nonzero direction differs from the previous tick's direction.
  // NOTE: matches the numpy reference, where prev_dir is the previous
  // tick's direction *including zeros* (a flat tick resets nothing —
  // direction[t-1] is compared, zero or not).
  std::vector<int64_t> cp;
  cp.reserve((size_t)T / 2 + 1);
  {
    int prev = 0;
    for (int64_t t = 1; t < T; ++t) {
      double d = price[t] - price[t - 1];
      int dir = (d > 0.0) - (d < 0.0);
      if (dir != 0 && dir != prev) cp.push_back(t);
      prev = dir;
    }
  }
  const int64_t n = (int64_t)cp.size();
  if (n < 6) return ZZ_ERR_TOO_FEW_CHANGES;

  // leg i: price = ending extremum (tick before its change point);
  // start[0] = 0, start[i] = cp[i-1]; end[i] = cp[i] - 1, last = T-1.
  for (int64_t i = 0; i < n; ++i) {
    leg_price[i] = price[cp[i] - 1];
    start[i] = (i == 0) ? 0 : cp[i - 1];
    end[i] = (i == n - 1) ? T - 1 : cp[i] - 1;
  }

  // --- per-leg volume per second (feature-extraction.R:38-47) ---
  // computed as a cumulative-sum difference (not a per-leg re-sum) so
  // the float rounding matches the NumPy oracle bit-for-bit — a size_av
  // ratio landing within an ulp of alpha must discretize identically
  {
    std::vector<double> csize((size_t)T + 1);
    csize[0] = 0.0;
    for (int64_t t = 0; t < T; ++t) csize[t + 1] = csize[t] + size[t];
    for (int64_t i = 0; i < n; ++i) {
      double vol = csize[end[i] + 1] - csize[start[i]];
      double secs = tsec[end[i]] - tsec[start[i]] + 1.0;
      size_av[i] = vol / secs;
    }
  }

  // --- f0: extremum type (feature-extraction.R:49-51) ---
  for (int64_t i = 1; i < n; ++i)
    f0[i] = (leg_price[i - 1] < leg_price[i]) ? 1 : -1;
  f0[0] = (f0[1] == 1) ? -1 : 1;

  // --- f1: 5-extrema trend pattern (feature-extraction.R:53-70) ---
  for (int64_t i = 0; i < n; ++i) f1[i] = 0;
  for (int64_t i = 4; i < n; ++i) {
    const double e1 = leg_price[i - 4], e2 = leg_price[i - 3],
                 e3 = leg_price[i - 2], e4 = leg_price[i - 1],
                 e5 = leg_price[i];
    if (e1 < e3 && e3 < e5 && e2 < e4)
      f1[i] = 1;
    else if (e1 > e3 && e3 > e5 && e2 > e4)
      f1[i] = -1;
  }

  // --- f2: volume strength (feature-extraction.R:72-89) ---
  for (int64_t i = 0; i < n; ++i) f2[i] = 0;
  for (int64_t i = 2; i < n; ++i) {
    int s1 = discretize(size_av[i] / size_av[i - 1], alpha);
    int s2 = discretize(size_av[i] / size_av[i - 2], alpha);
    int s3 = discretize(size_av[i - 1] / size_av[i - 2], alpha);
    if (s1 == 1 && s2 > -1 && s3 < 1)
      f2[i] = 1;
    else if (s1 == -1 && s2 < 1 && s3 > -1)
      f2[i] = -1;
  }

  // --- symbol + coarse trend (feature-extraction.R:91-131) ---
  for (int64_t i = 0; i < n; ++i) {
    int32_t sym = LEG_CUBE[(f0[i] + 1) * 9 + (f1[i] + 1) * 3 + (f2[i] + 1)];
    if (sym == 0) return ZZ_ERR_BAD_TRIPLE;
    feature[i] = sym;
    // down legs {6,7,8,9,15,16,17,18}; local {5,14}; rest up
    if (sym == 5 || sym == 14)
      trend[i] = 0;
    else if ((sym >= 6 && sym <= 9) || sym >= 15)
      trend[i] = -1;
    else
      trend[i] = 1;
  }
  return n;
}

// Batched extraction over concatenated ragged series. offsets: [B+1]
// tick offsets into the concatenated inputs; outputs are written at the
// same offsets (capacity per series = its tick count); n_legs: [B]
// result per series (negative = that series' error code). n_threads <= 0
// uses hardware_concurrency. Returns 0.
int64_t zz_extract_batch(const double* price, const double* size,
                         const double* tsec, const int64_t* offsets,
                         int64_t B, double alpha, double* leg_price,
                         int64_t* start, int64_t* end, double* size_av,
                         int64_t* f0, int64_t* f1, int64_t* f2,
                         int64_t* feature, int64_t* trend, int64_t* n_legs,
                         int64_t n_threads) {
  int64_t nt = n_threads > 0
                   ? n_threads
                   : (int64_t)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > B) nt = B;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t b = next.fetch_add(1);
      if (b >= B) break;
      int64_t off = offsets[b];
      int64_t T = offsets[b + 1] - off;
      n_legs[b] = zz_extract(price + off, size + off, tsec + off, T, alpha,
                             leg_price + off, start + off, end + off,
                             size_av + off, f0 + off, f1 + off, f2 + off,
                             feature + off, trend + off);
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int64_t i = 0; i < nt; ++i) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return 0;
}

}  // extern "C"
