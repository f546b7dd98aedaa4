// cdehost: native host-side preprocessing kernels for torchcde_tpu_torch.
//
// The port's own copy of torchcde_tpu/native/src/cdehost.cpp: the code below
// this header is that file's, line for line (two comments cite the
// reference's files by name alone), and both libraries are built with the
// same flags, so the two give the same bits on the same inputs.
// The kernels run in the input pipeline (torchcde_tpu_torch.data's loader
// threads) on the host CPU, so coefficient preprocessing overlaps the
// card's compute; ctypes releases the interpreter lock around each call:
//
//   * thomas_solve_batch   — batched tridiagonal (Thomas) solve
//   * forward_fill         — NaN fill-down along the length axis
//   * linear_infill        — full linear NaN interpolation (endpoint
//                            imputation + interior lerp), matching
//                            interpolation_linear semantics
//   * natural_cubic_dense  — natural cubic spline coefficients (a, b, 2c, 3d)
//                            for fully-observed data
//   * natural_cubic_masked — the same for NaN-masked data
//   * hermite_coeffs       — Hermite-with-backward-differences coefficients
//   * lyndon_words         — Duval enumeration of the logsignature basis
//   * logsig_windows       — per-window logsignatures of a linear path
//
// All kernels are multithreaded over the batch dimension with std::thread.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename F>
void parallel_for(int64_t n, int n_threads, F&& fn) {
  if (n_threads <= 1 || n < 2) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([lo, hi, &fn] {
      for (int64_t i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

template <typename T>
void thomas_one(const T* b, const T* u, const T* d, const T* l, T* x, T* nd,
                T* nb, int64_t k) {
  nd[0] = d[0];
  nb[0] = b[0];
  for (int64_t i = 1; i < k; ++i) {
    T w = l[i - 1] / nd[i - 1];
    nd[i] = d[i] - w * u[i - 1];
    nb[i] = b[i] - w * nb[i - 1];
  }
  x[k - 1] = nb[k - 1] / nd[k - 1];
  for (int64_t i = k - 2; i >= 0; --i) {
    x[i] = (nb[i] - u[i] * x[i + 1]) / nd[i];
  }
}

template <typename T>
void thomas_batch(const T* b, const T* u, const T* d, const T* l, T* x,
                  int64_t n_batch, int64_t k, int n_threads) {
  parallel_for(n_batch, n_threads, [=](int64_t i) {
    std::vector<T> nd(k), nb(k);
    thomas_one(b + i * k, u + i * (k - 1), d + i * k, l + i * (k - 1),
               x + i * k, nd.data(), nb.data(), k);
  });
}

template <typename T>
void forward_fill_impl(const T* x, T* out, int64_t n, int64_t length,
                       int64_t channels, int n_threads) {
  parallel_for(n, n_threads, [=](int64_t i) {
    const T* xi = x + i * length * channels;
    T* oi = out + i * length * channels;
    for (int64_t c = 0; c < channels; ++c) {
      T last = xi[c];
      for (int64_t t = 0; t < length; ++t) {
        T v = xi[t * channels + c];
        if (!std::isnan(v)) last = v;
        oi[t * channels + c] = last;
      }
    }
  });
}

template <typename T>
void linear_infill_impl(const T* t, const T* x, T* out, int64_t n,
                        int64_t length, int64_t channels, int n_threads) {
  parallel_for(n * channels, n_threads, [=](int64_t bc) {
    int64_t i = bc / channels;
    int64_t c = bc % channels;
    const T* xi = x + i * length * channels;
    T* oi = out + i * length * channels;
    // first / last observed
    int64_t first = -1, last = -1;
    for (int64_t s = 0; s < length; ++s) {
      if (!std::isnan(xi[s * channels + c])) {
        if (first < 0) first = s;
        last = s;
      }
    }
    if (first < 0) {  // all-NaN channel -> zeros
      for (int64_t s = 0; s < length; ++s) oi[s * channels + c] = T(0);
      return;
    }
    T vf = xi[first * channels + c];
    T vl = xi[last * channels + c];
    int64_t prev = -1;
    for (int64_t s = 0; s < length; ++s) {
      T v = xi[s * channels + c];
      if (s == 0 && std::isnan(v)) v = vf;
      if (s == length - 1 && std::isnan(v)) v = vl;
      if (!std::isnan(v)) {
        // back-fill the gap (prev, s) linearly in t
        if (prev >= 0 && s > prev + 1) {
          T tp = t[prev], tn = t[s];
          T vp = oi[prev * channels + c];
          for (int64_t m = prev + 1; m < s; ++m) {
            T ratio = (t[m] - tp) / (tn - tp);
            oi[m * channels + c] = vp + ratio * (v - vp);
          }
        }
        oi[s * channels + c] = v;
        prev = s;
      }
    }
  });
}

// Natural cubic spline (fully observed), matching the masked JAX kernel and
// the mathematics of the reference (interpolation_cubic.py:7-53).  Writes
// (a, b, two_c, three_d) packed channel-major in groups of `channels`.
template <typename T>
void natural_cubic_dense_impl(const T* t, const T* x, T* coeffs, int64_t n,
                              int64_t length, int64_t channels,
                              int n_threads) {
  parallel_for(n * channels, n_threads, [=](int64_t bc) {
    int64_t i = bc / channels;
    int64_t c = bc % channels;
    const T* xi = x + i * length * channels;
    T* co = coeffs + i * (length - 1) * 4 * channels;
    int64_t k = length;
    std::vector<T> hr(k - 1), pds(k - 1), diag(k), rhs(k), nd(k), nb(k), kd(k);
    for (int64_t s = 0; s + 1 < k; ++s) {
      T h = t[s + 1] - t[s];
      hr[s] = T(1) / h;
      T dx = xi[(s + 1) * channels + c] - xi[s * channels + c];
      pds[s] = T(3) * dx * hr[s] * hr[s];
    }
    for (int64_t s = 0; s < k; ++s) {
      T left = (s > 0) ? hr[s - 1] : T(0);
      T right = (s + 1 < k) ? hr[s] : T(0);
      diag[s] = T(2) * (left + right);
      rhs[s] = ((s > 0) ? pds[s - 1] : T(0)) + ((s + 1 < k) ? pds[s] : T(0));
    }
    thomas_one(rhs.data(), hr.data(), diag.data(), hr.data(), kd.data(),
               nd.data(), nb.data(), k);
    for (int64_t s = 0; s + 1 < k; ++s) {
      T dx = xi[(s + 1) * channels + c] - xi[s * channels + c];
      T six_pd_hr = T(6) * dx * hr[s];
      T a = xi[s * channels + c];
      T b = kd[s];
      T two_c = (six_pd_hr - T(4) * kd[s] - T(2) * kd[s + 1]) * hr[s];
      T three_d =
          (-six_pd_hr + T(3) * (kd[s] + kd[s + 1])) * hr[s] * hr[s];
      T* row = co + s * 4 * channels;
      row[c] = a;
      row[channels + c] = b;
      row[2 * channels + c] = two_c;
      row[3 * channels + c] = three_d;
    }
  });
}

// NaN-masked natural cubic spline, matching the JAX masked pipeline
// (interpolation/cubic.py:_natural_cubic_coeffs_masked, _version=1) and the
// reference's per-scalar recursion it replaces
// (torchcde interpolation_cubic.py:78-167): fill
// forward/backward from the first/last observation, fit the natural spline
// on the observed knots only, then re-base each observed-knot polynomial
// onto every full-grid interval.
template <typename T>
void natural_cubic_masked_impl(const T* t, const T* x, T* coeffs, int64_t n,
                               int64_t length, int64_t channels,
                               int n_threads) {
  parallel_for(n * channels, n_threads, [=](int64_t bc) {
    int64_t i = bc / channels;
    int64_t c = bc % channels;
    const T* xi = x + i * length * channels;
    T* co = coeffs + i * (length - 1) * 4 * channels;

    // First/last observed position; all-NaN channels produce zero rows
    // (reference interpolation_cubic.py:85-92).
    int64_t first = -1, last = -1;
    for (int64_t s = 0; s < length; ++s) {
      if (!std::isnan(xi[s * channels + c])) {
        if (first < 0) first = s;
        last = s;
      }
    }
    if (first < 0) {
      for (int64_t s = 0; s + 1 < length; ++s) {
        T* row = co + s * 4 * channels;
        row[c] = row[channels + c] = row[2 * channels + c] =
            row[3 * channels + c] = T(0);
      }
      return;
    }

    // Observed knots after _version=1 endpoint imputation: every position
    // before `first` (value x[first]) and after `last` (value x[last]) is
    // observed; interior NaNs stay missing.
    std::vector<int64_t> obs;
    std::vector<T> v;
    obs.reserve(length);
    v.reserve(length);
    T vf = xi[first * channels + c];
    T vl = xi[last * channels + c];
    for (int64_t s = 0; s < length; ++s) {
      T val = xi[s * channels + c];
      if (s < first) val = vf;
      else if (s > last) val = vl;
      if (!std::isnan(val)) {
        obs.push_back(s);
        v.push_back(val);
      }
    }
    int64_t m = (int64_t)obs.size();

    // Natural spline on the observed knots (same construction as the dense
    // kernel above, just on the compacted grid).
    std::vector<T> a(std::max<int64_t>(m, 1)), b(std::max<int64_t>(m, 1)),
        two_c(std::max<int64_t>(m, 1)), three_d(std::max<int64_t>(m, 1));
    if (m == 1) {
      a[0] = v[0];
      b[0] = two_c[0] = three_d[0] = T(0);
    } else {
      std::vector<T> hr(m - 1), pds(m - 1), diag(m), rhs(m), nd(m), nb(m),
          kd(m);
      for (int64_t j = 0; j + 1 < m; ++j) {
        T h = t[obs[j + 1]] - t[obs[j]];
        hr[j] = T(1) / h;
        pds[j] = T(3) * (v[j + 1] - v[j]) * hr[j] * hr[j];
      }
      for (int64_t j = 0; j < m; ++j) {
        T left = (j > 0) ? hr[j - 1] : T(0);
        T right = (j + 1 < m) ? hr[j] : T(0);
        diag[j] = T(2) * (left + right);
        rhs[j] = ((j > 0) ? pds[j - 1] : T(0)) + ((j + 1 < m) ? pds[j] : T(0));
      }
      thomas_one(rhs.data(), hr.data(), diag.data(), hr.data(), kd.data(),
                 nd.data(), nb.data(), m);
      for (int64_t j = 0; j + 1 < m; ++j) {
        T six_pd_hr = T(6) * (v[j + 1] - v[j]) * hr[j];
        a[j] = v[j];
        b[j] = kd[j];
        two_c[j] = (six_pd_hr - T(4) * kd[j] - T(2) * kd[j + 1]) * hr[j];
        three_d[j] = (-six_pd_hr + T(3) * (kd[j] + kd[j + 1])) * hr[j] * hr[j];
      }
      // Past the final knot the polynomial continues from the last interval's
      // knot; the masked JAX path fills the same way (never reached when the
      // imputation makes position length-1 observed).
      a[m - 1] = v[m - 1];
      b[m - 1] = (m >= 2) ? b[m - 2] : T(0);
      two_c[m - 1] = (m >= 2) ? two_c[m - 2] : T(0);
      three_d[m - 1] = (m >= 2) ? three_d[m - 2] : T(0);
    }

    // Re-base the last observed knot's polynomial onto each grid interval:
    // with o = t_obs - t_grid, p(tau + (t_grid - t_obs)) expands to the
    // shifted coefficients below (interpolation/cubic.py re-base algebra).
    int64_t j = 0;
    for (int64_t s = 0; s + 1 < length; ++s) {
      while (j + 1 < m && obs[j + 1] <= s) ++j;
      int64_t jj = std::min<int64_t>(j, std::max<int64_t>(m - 2, 0));
      T o = t[obs[jj]] - t[s];
      T ak = a[jj], bk = b[jj], ck = two_c[jj], dk = three_d[jj];
      T* row = co + s * 4 * channels;
      row[c] = ak + ((T(0.5) * ck - dk * o / T(3)) * o - bk) * o;
      row[channels + c] = bk + (dk * o - ck) * o;
      row[2 * channels + c] = ck - T(2) * dk * o;
      row[3 * channels + c] = dk;
    }
  });
}

// Hermite cubic with backward differences on fully-observed data
// (reference interpolation_hermite_cubic_bdiff.py:5-20).
template <typename T>
void hermite_coeffs_impl(const T* t, const T* x, T* coeffs, int64_t n,
                         int64_t length, int64_t channels, int n_threads) {
  parallel_for(n, n_threads, [=](int64_t i) {
    const T* xi = x + i * length * channels;
    T* co = coeffs + i * (length - 1) * 4 * channels;
    for (int64_t c = 0; c < channels; ++c) {
      for (int64_t s = 0; s + 1 < length; ++s) {
        T td = t[s + 1] - t[s];
        T d_next = (xi[(s + 1) * channels + c] - xi[s * channels + c]) / td;
        T d_prev;
        if (s == 0) {
          d_prev = d_next;
        } else {
          T td0 = t[s] - t[s - 1];
          d_prev = (xi[s * channels + c] - xi[(s - 1) * channels + c]) / td0;
        }
        T x_prev = xi[s * channels + c];
        T x_next = xi[(s + 1) * channels + c];
        T a = x_prev;
        T b = d_prev;
        T two_c = T(2) * (T(3) * ((x_next - x_prev) / td - b) - d_next + d_prev) / td;
        T three_d = (d_next - b) / (td * td) - two_c / td;
        T* row = co + s * 4 * channels;
        row[c] = a;
        row[channels + c] = b;
        row[2 * channels + c] = two_c;
        row[3 * channels + c] = three_d;
      }
    }
  });
}

}  // namespace

extern "C" {

void thomas_solve_batch_f32(const float* b, const float* u, const float* d,
                            const float* l, float* x, int64_t n_batch,
                            int64_t k, int n_threads) {
  thomas_batch(b, u, d, l, x, n_batch, k, n_threads);
}

void thomas_solve_batch_f64(const double* b, const double* u, const double* d,
                            const double* l, double* x, int64_t n_batch,
                            int64_t k, int n_threads) {
  thomas_batch(b, u, d, l, x, n_batch, k, n_threads);
}

void forward_fill_f32(const float* x, float* out, int64_t n, int64_t length,
                      int64_t channels, int n_threads) {
  forward_fill_impl(x, out, n, length, channels, n_threads);
}

void forward_fill_f64(const double* x, double* out, int64_t n, int64_t length,
                      int64_t channels, int n_threads) {
  forward_fill_impl(x, out, n, length, channels, n_threads);
}

void linear_infill_f32(const float* t, const float* x, float* out, int64_t n,
                       int64_t length, int64_t channels, int n_threads) {
  linear_infill_impl(t, x, out, n, length, channels, n_threads);
}

void linear_infill_f64(const double* t, const double* x, double* out,
                       int64_t n, int64_t length, int64_t channels,
                       int n_threads) {
  linear_infill_impl(t, x, out, n, length, channels, n_threads);
}

void natural_cubic_dense_f32(const float* t, const float* x, float* coeffs,
                             int64_t n, int64_t length, int64_t channels,
                             int n_threads) {
  natural_cubic_dense_impl(t, x, coeffs, n, length, channels, n_threads);
}

void natural_cubic_dense_f64(const double* t, const double* x, double* coeffs,
                             int64_t n, int64_t length, int64_t channels,
                             int n_threads) {
  natural_cubic_dense_impl(t, x, coeffs, n, length, channels, n_threads);
}

void natural_cubic_masked_f32(const float* t, const float* x, float* coeffs,
                              int64_t n, int64_t length, int64_t channels,
                              int n_threads) {
  natural_cubic_masked_impl(t, x, coeffs, n, length, channels, n_threads);
}

void natural_cubic_masked_f64(const double* t, const double* x,
                              double* coeffs, int64_t n, int64_t length,
                              int64_t channels, int n_threads) {
  natural_cubic_masked_impl(t, x, coeffs, n, length, channels, n_threads);
}

void hermite_coeffs_f32(const float* t, const float* x, float* coeffs,
                        int64_t n, int64_t length, int64_t channels,
                        int n_threads) {
  hermite_coeffs_impl(t, x, coeffs, n, length, channels, n_threads);
}

void hermite_coeffs_f64(const double* t, const double* x, double* coeffs,
                        int64_t n, int64_t length, int64_t channels,
                        int n_threads) {
  hermite_coeffs_impl(t, x, coeffs, n, length, channels, n_threads);
}

// Duval's algorithm.  out_letters: flat buffer receiving each word's letters
// back to back; out_lengths: one length per word.  Returns the word count.
// Call with out_letters == nullptr to query sizes (returns count; writes
// total letter count into *total_letters if non-null).
int64_t lyndon_words_c(int32_t channels, int32_t depth, int32_t* out_letters,
                       int32_t* out_lengths, int64_t* total_letters) {
  std::vector<std::vector<int32_t>> words;
  std::vector<int32_t> w = {-1};
  while (!w.empty()) {
    w.back() += 1;
    int64_t m = (int64_t)w.size();
    if (w.back() < channels) {
      words.emplace_back(w);
      while ((int32_t)w.size() < depth) w.push_back(w[w.size() - m]);
    } else {
      w.pop_back();
      continue;
    }
    while (!w.empty() && w.back() == channels - 1) w.pop_back();
  }
  std::stable_sort(words.begin(), words.end(),
                   [](const std::vector<int32_t>& a,
                      const std::vector<int32_t>& b) {
                     if (a.size() != b.size()) return a.size() < b.size();
                     return a < b;
                   });
  int64_t letters = 0;
  for (auto& word : words) letters += (int64_t)word.size();
  if (total_letters) *total_letters = letters;
  if (out_letters && out_lengths) {
    int64_t pos = 0;
    for (size_t i = 0; i < words.size(); ++i) {
      out_lengths[i] = (int32_t)words[i].size();
      for (int32_t letter : words[i]) out_letters[pos++] = letter;
    }
  }
  return (int64_t)words.size();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Windowed logsignatures (host twin of ops/logsignature.py windowed path):
// per window, the ordered Chen product of segment exponentials in the
// truncated tensor algebra T^{<=depth}(R^c), tensor log, gathered at
// Lyndon-word indices.  Replaces the per-window signatory C++/CUDA calls the
// reference makes (torchcde log_ode.py:57-67) with a
// loader-thread kernel, so log-ODE preprocessing overlaps TPU compute.
// ---------------------------------------------------------------------------

namespace {

template <typename T>
struct TensorLevels {
  // levels[k-1] holds the c^k coefficients of level k (non-unit part).
  std::vector<std::vector<T>> levels;
  TensorLevels(int64_t c, int32_t depth) {
    int64_t size = 1;
    for (int32_t k = 1; k <= depth; ++k) {
      size *= c;
      levels.emplace_back((size_t)size, T(0));
    }
  }
  void zero() {
    for (auto& l : levels) std::fill(l.begin(), l.end(), T(0));
  }
};

// acc_k += a_i (x) b_j summed over i + j = k (i, j >= 1) — the non-unital
// part of a product, written into out (out must not alias a or b).
template <typename T>
void mul_no_unit(const TensorLevels<T>& a, const TensorLevels<T>& b,
                 TensorLevels<T>& out) {
  int32_t depth = (int32_t)out.levels.size();
  for (int32_t k = depth; k >= 1; --k) {
    auto& dst = out.levels[k - 1];
    std::fill(dst.begin(), dst.end(), T(0));
    for (int32_t i = 1; i < k; ++i) {
      const auto& ai = a.levels[i - 1];
      const auto& bj = b.levels[k - i - 1];
      int64_t nb = (int64_t)bj.size();
      for (int64_t p = 0; p < (int64_t)ai.size(); ++p) {
        T av = ai[p];
        if (av == T(0)) continue;
        T* d = dst.data() + p * nb;
        const T* bp = bj.data();
        for (int64_t q = 0; q < nb; ++q) d[q] += av * bp[q];
      }
    }
  }
}

// S <- S * exp(v) by Chen's identity, computed level-by-level descending so
// lower levels of S are still the old values when used.
template <typename T>
void chen_mul_exp(TensorLevels<T>& S, const TensorLevels<T>& E,
                  int64_t /*c*/) {
  int32_t depth = (int32_t)S.levels.size();
  for (int32_t k = depth; k >= 1; --k) {
    auto& sk = S.levels[k - 1];
    const auto& ek = E.levels[k - 1];
    for (size_t p = 0; p < sk.size(); ++p) sk[p] += ek[p];
    for (int32_t i = 1; i < k; ++i) {
      const auto& si = S.levels[i - 1];
      const auto& ej = E.levels[k - i - 1];
      int64_t nb = (int64_t)ej.size();
      for (int64_t p = 0; p < (int64_t)si.size(); ++p) {
        T sv = si[p];
        if (sv == T(0)) continue;
        T* d = sk.data() + p * nb;
        const T* ep = ej.data();
        for (int64_t q = 0; q < nb; ++q) d[q] += sv * ep[q];
      }
    }
  }
}

template <typename T>
void segment_exp(const T* v, int64_t c, TensorLevels<T>& E) {
  std::copy(v, v + c, E.levels[0].begin());
  T fact = T(1);
  for (size_t k = 2; k <= E.levels.size(); ++k) {
    const auto& prev = E.levels[k - 2];
    auto& cur = E.levels[k - 1];
    fact *= (T)k;
    // v^(k)/k! = (v^(k-1)/(k-1)!) (x) v / k
    for (int64_t p = 0; p < (int64_t)prev.size(); ++p) {
      T* d = cur.data() + p * c;
      T pv = prev[p] / (T)k;
      for (int64_t q = 0; q < c; ++q) d[q] = pv * v[q];
    }
  }
}

// L = log(1 + S) = S - S^2/2 + S^3/3 - ... truncated at depth.
template <typename T>
void tensor_log_impl(const TensorLevels<T>& S, TensorLevels<T>& L,
                     TensorLevels<T>& power, TensorLevels<T>& tmp) {
  int32_t depth = (int32_t)S.levels.size();
  for (int32_t k = 1; k <= depth; ++k) L.levels[k - 1] = S.levels[k - 1];
  power = S;
  for (int32_t m = 2; m <= depth; ++m) {
    mul_no_unit(power, S, tmp);
    std::swap(power.levels, tmp.levels);
    T coef = (T)(((m + 1) % 2 == 0) ? 1.0 : -1.0) / (T)m;
    for (int32_t k = 1; k <= depth; ++k) {
      auto& lk = L.levels[k - 1];
      const auto& pk = power.levels[k - 1];
      for (size_t p = 0; p < lk.size(); ++p) lk[p] += coef * pk[p];
    }
  }
}

template <typename T>
void logsig_windows_impl(const T* x, T* out, const int64_t* boundaries,
                         int64_t n, int64_t length, int64_t c, int32_t depth,
                         int64_t n_windows, const int32_t* word_level,
                         const int32_t* word_flat, int64_t n_logsig,
                         int n_threads) {
  parallel_for(n, n_threads, [&](int64_t row) {
    TensorLevels<T> S(c, depth), E(c, depth), L(c, depth), P(c, depth),
        tmp(c, depth);
    std::vector<T> v((size_t)c);
    const T* xr = x + row * length * c;
    T* outr = out + row * n_windows * n_logsig;
    for (int64_t w = 0; w < n_windows; ++w) {
      S.zero();
      for (int64_t j = boundaries[w]; j < boundaries[w + 1]; ++j) {
        for (int64_t q = 0; q < c; ++q)
          v[(size_t)q] = xr[(j + 1) * c + q] - xr[j * c + q];
        segment_exp(v.data(), c, E);
        chen_mul_exp(S, E, c);
      }
      tensor_log_impl(S, L, P, tmp);
      for (int64_t widx = 0; widx < n_logsig; ++widx) {
        outr[w * n_logsig + widx] =
            L.levels[word_level[widx] - 1][(size_t)word_flat[widx]];
      }
    }
  });
}

}  // namespace

extern "C" {

void logsig_windows_f32(const float* x, float* out, const int64_t* boundaries,
                        int64_t n, int64_t length, int64_t c, int32_t depth,
                        int64_t n_windows, const int32_t* word_level,
                        const int32_t* word_flat, int64_t n_logsig,
                        int n_threads) {
  logsig_windows_impl(x, out, boundaries, n, length, c, depth, n_windows,
                      word_level, word_flat, n_logsig, n_threads);
}

void logsig_windows_f64(const double* x, double* out,
                        const int64_t* boundaries, int64_t n, int64_t length,
                        int64_t c, int32_t depth, int64_t n_windows,
                        const int32_t* word_level, const int32_t* word_flat,
                        int64_t n_logsig, int n_threads) {
  logsig_windows_impl(x, out, boundaries, n, length, c, depth, n_windows,
                      word_level, word_flat, n_logsig, n_threads);
}

}  // extern "C"
