// Native CPU engine for RNS polynomial arithmetic — the C++ counterpart of
// the device kernels, filling the role Microsoft SEAL plays in the reference
// (the reference links SEAL as its only native crypto engine,
// CMakeLists.txt:211-217). Used by the Python stack (via ctypes) for
// host-side keygen/encrypt/decrypt work at large n, and as a third
// independent implementation for bit-exactness cross-checks
// (np64 / jx32 / cpp64 must all agree).
//
// Layout contract (matches abc_tpu.crypto.ntt.NttContext):
//   polynomials: uint32_t[L][n] row-major, one row per RNS limb
//   twiddles:    psi^bitrev(k) per limb, Shoup companions floor(w·2^32/q)
//   forward:     Cooley-Tukey, natural → bit-reversed order
//   inverse:     Gentleman-Sande (exact stage inverse), folds n^{-1}
//
// Build: cc -O3 -march=native -shared -fPIC modpoly.cpp -o libmodpoly.so

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Shoup multiply: a·w mod q, w_shoup = floor(w·2^32 / q); result < q.
static inline uint32_t mul_shoup(uint32_t a, uint32_t w, uint32_t wsh,
                                 uint32_t q) {
  uint32_t hi = (uint32_t)(((uint64_t)a * wsh) >> 32);
  uint32_t r = a * w - hi * q;  // mod 2^32; true value in [0, 2q)
  return r >= q ? r - q : r;
}

static inline uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  uint32_t r = a + b;
  return r >= q ? r - q : r;
}

static inline uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

// Forward negacyclic NTT over L limbs, in place.
// data: [L][n]; tw/twsh: [L][n]; q: [L]
void ntt_forward(uint32_t* data, const uint32_t* tw, const uint32_t* twsh,
                 const uint32_t* q, int64_t L, int64_t n) {
  for (int64_t l = 0; l < L; ++l) {
    uint32_t* x = data + l * n;
    const uint32_t* w = tw + l * n;
    const uint32_t* wsh = twsh + l * n;
    const uint32_t ql = q[l];
    for (int64_t m = 1; m < n; m <<= 1) {
      int64_t t = n / (2 * m);
      for (int64_t i = 0; i < m; ++i) {
        const uint32_t s = w[m + i];
        const uint32_t ssh = wsh[m + i];
        uint32_t* u = x + 2 * i * t;
        uint32_t* v = u + t;
        for (int64_t j = 0; j < t; ++j) {
          uint32_t vv = mul_shoup(v[j], s, ssh, ql);
          uint32_t uu = u[j];
          u[j] = add_mod(uu, vv, ql);
          v[j] = sub_mod(uu, vv, ql);
        }
      }
    }
  }
}

// Inverse negacyclic NTT over L limbs, in place (includes n^{-1} scaling).
// itw/itwsh: inverse twiddles; ninv/ninvsh: n^{-1} per limb.
void ntt_inverse(uint32_t* data, const uint32_t* itw, const uint32_t* itwsh,
                 const uint32_t* ninv, const uint32_t* ninvsh,
                 const uint32_t* q, int64_t L, int64_t n) {
  for (int64_t l = 0; l < L; ++l) {
    uint32_t* x = data + l * n;
    const uint32_t* w = itw + l * n;
    const uint32_t* wsh = itwsh + l * n;
    const uint32_t ql = q[l];
    for (int64_t m = n >> 1; m >= 1; m >>= 1) {
      int64_t t = n / (2 * m);
      for (int64_t i = 0; i < m; ++i) {
        const uint32_t s = w[m + i];
        const uint32_t ssh = wsh[m + i];
        uint32_t* u = x + 2 * i * t;
        uint32_t* v = u + t;
        for (int64_t j = 0; j < t; ++j) {
          uint32_t uu = u[j];
          uint32_t vv = v[j];
          u[j] = add_mod(uu, vv, ql);
          v[j] = mul_shoup(sub_mod(uu, vv, ql), s, ssh, ql);
        }
      }
    }
    for (int64_t j = 0; j < n; ++j)
      x[j] = mul_shoup(x[j], ninv[l], ninvsh[l], ql);
  }
}

// Pointwise modular product: out = a·b mod q over [L][n].
void pointwise_mul_mod(const uint32_t* a, const uint32_t* b, uint32_t* out,
                       const uint32_t* q, int64_t L, int64_t n) {
  for (int64_t l = 0; l < L; ++l) {
    const uint32_t ql = q[l];
    const uint32_t* ar = a + l * n;
    const uint32_t* br = b + l * n;
    uint32_t* orow = out + l * n;
    for (int64_t j = 0; j < n; ++j)
      orow[j] = (uint32_t)(((uint64_t)ar[j] * br[j]) % ql);
  }
}

void add_mod_poly(const uint32_t* a, const uint32_t* b, uint32_t* out,
                  const uint32_t* q, int64_t L, int64_t n) {
  for (int64_t l = 0; l < L; ++l)
    for (int64_t j = 0; j < n; ++j)
      out[l * n + j] = add_mod(a[l * n + j], b[l * n + j], q[l]);
}

void sub_mod_poly(const uint32_t* a, const uint32_t* b, uint32_t* out,
                  const uint32_t* q, int64_t L, int64_t n) {
  for (int64_t l = 0; l < L; ++l)
    for (int64_t j = 0; j < n; ++j)
      out[l * n + j] = sub_mod(a[l * n + j], b[l * n + j], q[l]);
}

// ---------------------------------------------------------------------------
// v2: batched, thread-parallel entry points (OpenMP when built with
// -fopenmp; serial otherwise). These carry the np64 host engine's hot loops:
// the BEHZ base-conversion contractions and batched transforms.
// ---------------------------------------------------------------------------

// General modular product over R independent rows of length n with per-row
// modulus: out[r][j] = a[r][j]·b[r][j] mod q[r]. Barrett with
// mu[r] = floor(2^60/q[r]) when nonzero (30-bit primes), hardware modulo
// otherwise (small plain moduli).
void mul_mod_rows(const uint32_t* a, const uint32_t* b, uint32_t* out,
                  const uint32_t* q, const uint32_t* mu,
                  int64_t R, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < R; ++r) {
    const uint32_t ql = q[r];
    const uint64_t mul_ = mu[r];
    const uint32_t* ar = a + r * n;
    const uint32_t* br = b + r * n;
    uint32_t* orow = out + r * n;
    if (mul_ != 0) {
      for (int64_t j = 0; j < n; ++j) {
        uint64_t v = (uint64_t)ar[j] * br[j];        // < 2^60
        uint64_t t = v >> 30;                        // < 2^30
        uint64_t z = (t * mul_) >> 30;               // ≤ floor(v/q), −3
        uint64_t rr = v - z * ql;                    // < 4q
        while (rr >= ql) rr -= ql;
        orow[j] = (uint32_t)rr;
      }
    } else {
      for (int64_t j = 0; j < n; ++j)
        orow[j] = (uint32_t)(((uint64_t)ar[j] * br[j]) % ql);
    }
  }
}

// Batched forward/inverse NTT: data [R][L][n], tables per limb row.
// Parallel over the R·L independent limb transforms.
void ntt_forward_batch(uint32_t* data, const uint32_t* tw,
                       const uint32_t* twsh, const uint32_t* q,
                       int64_t R, int64_t L, int64_t n) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t r = 0; r < R; ++r) {
    for (int64_t l = 0; l < L; ++l) {
      uint32_t* x = data + (r * L + l) * n;
      const uint32_t* w = tw + l * n;
      const uint32_t* wsh = twsh + l * n;
      const uint32_t ql = q[l];
      for (int64_t m = 1; m < n; m <<= 1) {
        int64_t t = n / (2 * m);
        for (int64_t i = 0; i < m; ++i) {
          const uint32_t s = w[m + i];
          const uint32_t ssh = wsh[m + i];
          uint32_t* u = x + 2 * i * t;
          uint32_t* v = u + t;
          for (int64_t j = 0; j < t; ++j) {
            uint32_t vv = mul_shoup(v[j], s, ssh, ql);
            uint32_t uu = u[j];
            u[j] = add_mod(uu, vv, ql);
            v[j] = sub_mod(uu, vv, ql);
          }
        }
      }
    }
  }
}

void ntt_inverse_batch(uint32_t* data, const uint32_t* itw,
                       const uint32_t* itwsh, const uint32_t* ninv,
                       const uint32_t* ninvsh, const uint32_t* q,
                       int64_t R, int64_t L, int64_t n) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t r = 0; r < R; ++r) {
    for (int64_t l = 0; l < L; ++l) {
      uint32_t* x = data + (r * L + l) * n;
      const uint32_t* w = itw + l * n;
      const uint32_t* wsh = itwsh + l * n;
      const uint32_t ql = q[l];
      for (int64_t m = n >> 1; m >= 1; m >>= 1) {
        int64_t t = n / (2 * m);
        for (int64_t i = 0; i < m; ++i) {
          const uint32_t s = w[m + i];
          const uint32_t ssh = wsh[m + i];
          uint32_t* u = x + 2 * i * t;
          uint32_t* v = u + t;
          for (int64_t j = 0; j < t; ++j) {
            uint32_t uu = u[j];
            uint32_t vv = v[j];
            u[j] = add_mod(uu, vv, ql);
            v[j] = mul_shoup(sub_mod(uu, vv, ql), s, ssh, ql);
          }
        }
      }
      for (int64_t j = 0; j < n; ++j)
        x[j] = mul_shoup(x[j], ninv[l], ninvsh[l], ql);
    }
  }
}

}  // extern "C"
