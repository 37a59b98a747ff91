// Host library of edipack_tpu_torch (a copy of edipack_tpu's
// native/edipack_native.cpp, less its unused ELL packer).
//
// The reference's "native tier" is Fortran (sector maps ED_SECTOR.f90,
// bit codec ED_AUX_FUNX.f90:334-480). This library covers host-side work
// that feeds the device: combinadic sector-basis enumeration, vectorized
// fermionic operator application over whole state arrays, binary search
// in a sorted basis and the hopping elements of one c+_i c_j. Plain C ABI,
// bound with ctypes by edipack_tpu_torch/native/__init__.py, which builds
// it with g++ -O3 -shared -fPIC at first use.

#include <algorithm>
#include <cstdint>

extern "C" {

// C(n,k) without overflow for the sizes we use (n <= 64)
static int64_t binom_i(int n, int k) {
  if (k < 0 || k > n) return 0;
  if (k > n - k) k = n - k;
  int64_t out = 1;
  for (int i = 0; i < k; ++i) out = out * (n - i) / (i + 1);
  return out;
}

int64_t edn_binom(int n, int k) { return binom_i(n, k); }

// All ns-bit states with popcount n, ascending. out must hold C(ns,n).
void edn_enum_states(int ns, int n, int64_t* out) {
  if (n < 0 || n > ns) return;
  if (n == 0) {
    out[0] = 0;
    return;
  }
  // first combination: lowest n bits set
  uint64_t v = (n >= 64) ? ~0ull : ((1ull << n) - 1ull);
  const uint64_t limit = (ns >= 64) ? ~0ull : (1ull << ns);
  int64_t idx = 0;
  while (v < limit) {
    out[idx++] = (int64_t)v;
    // Gosper's hack: next integer with same popcount
    uint64_t t = v | (v - 1);
    v = (t + 1) | (((~t & (t + 1)) - 1) >> (__builtin_ctzll(v) + 1));
    if (v == 0) break;
  }
}

// Jordan-Wigner sign of level `pos` on state m: (-1)^{popcount below pos}
static inline double jw_sign(int64_t m, int pos) {
  uint64_t mask = (pos >= 64) ? ~0ull : ((1ull << pos) - 1ull);
  return (__builtin_popcountll((uint64_t)m & mask) & 1) ? -1.0 : 1.0;
}

// Apply a c/cdg string (kinds[i]: 0=c, 1=cdg at levels[i], applied in order)
// to every state; returns new states, accumulated signs, validity.
void edn_apply_opstring(const int64_t* states, int64_t len, const int* kinds,
                        const int* levels, int nops, int64_t* out_states,
                        double* out_signs, uint8_t* out_valid) {
  for (int64_t s = 0; s < len; ++s) {
    int64_t m = states[s];
    double sign = 1.0;
    uint8_t ok = 1;
    for (int o = 0; o < nops && ok; ++o) {
      const int pos = levels[o];
      const int64_t bit = (int64_t)1 << pos;
      const bool occupied = (m & bit) != 0;
      if (kinds[o] == 0) {   // c
        if (!occupied) { ok = 0; break; }
        sign *= jw_sign(m, pos);
        m ^= bit;
      } else {               // cdg
        if (occupied) { ok = 0; break; }
        sign *= jw_sign(m, pos);
        m |= bit;
      }
    }
    out_states[s] = ok ? m : states[s];
    out_signs[s] = ok ? sign : 0.0;
    out_valid[s] = ok;
  }
}

// Binary search of values in a sorted basis; -1 when absent.
void edn_state_index(const int64_t* basis, int64_t blen, const int64_t* vals,
                     int64_t vlen, int64_t* out) {
  for (int64_t i = 0; i < vlen; ++i) {
    const int64_t* lo = std::lower_bound(basis, basis + blen, vals[i]);
    out[i] = (lo != basis + blen && *lo == vals[i]) ? (lo - basis) : -1;
  }
}

// Matrix elements of c^+_i c_j on a fixed-N basis: fills rows/cols/signs,
// returns the count. Buffers must hold blen entries.
int64_t edn_hop_elements(const int64_t* basis, int64_t blen, int i, int j,
                         int64_t* rows, int64_t* cols, double* signs) {
  int64_t cnt = 0;
  if (i == j) {
    const int64_t bit = (int64_t)1 << i;
    for (int64_t s = 0; s < blen; ++s)
      if (basis[s] & bit) {
        rows[cnt] = s;
        cols[cnt] = s;
        signs[cnt++] = 1.0;
      }
    return cnt;
  }
  const int64_t bi = (int64_t)1 << i, bj = (int64_t)1 << j;
  for (int64_t s = 0; s < blen; ++s) {
    const int64_t m = basis[s];
    if (!(m & bj) || (m & bi)) continue;
    double sg = jw_sign(m, j);
    const int64_t m1 = m ^ bj;
    sg *= jw_sign(m1, i);
    const int64_t m2 = m1 | bi;
    const int64_t* lo = std::lower_bound(basis, basis + blen, m2);
    if (lo != basis + blen && *lo == m2) {
      rows[cnt] = lo - basis;
      cols[cnt] = s;
      signs[cnt++] = sg;
    }
  }
  return cnt;
}

}  // extern "C"
