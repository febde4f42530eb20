// Native F_p row reduction — the hot kernel of the exact rounding path.
//
// Role parity: the reference reaches FLINT's nmod_mat rref through Nemo for
// pivot detection and Dixon-lifting setup (ClusteredLowRankSolver.jl/
// src/rounding.jl:288-333, :274,351,360). This is the equivalent native
// kernel for the Python framework: full reduced row echelon form of an
// m x n matrix over F_p, in place, p < 2^62 (products go through unsigned
// __int128). Exposed through a plain C ABI and loaded with ctypes.
//
// Build: g++ -O3 -shared -fPIC rref_modp.cpp -o librref_modp.so
#include <cstdint>

typedef unsigned __int128 u128;

static inline uint64_t mulmod(uint64_t a, uint64_t b, uint64_t p) {
    return (uint64_t)(((u128)a * b) % p);
}

// modular inverse via extended euclid (p prime, a != 0 mod p)
static uint64_t invmod(uint64_t a, uint64_t p) {
    int64_t t = 0, newt = 1;
    int64_t r = (int64_t)p, newr = (int64_t)(a % p);
    while (newr != 0) {
        int64_t q = r / newr;
        int64_t tmp = t - q * newt; t = newt; newt = tmp;
        tmp = r - q * newr; r = newr; newr = tmp;
    }
    if (t < 0) t += (int64_t)p;
    return (uint64_t)t;
}

extern "C" {

// In-place RREF of a (m x n, row-major, entries already reduced mod p).
// Writes pivot column indices into `pivots` (caller allocates >= min(m,n))
// and returns the rank.
int64_t rref_mod_p_u64(uint64_t* a, int64_t m, int64_t n, uint64_t p,
                       int64_t* pivots) {
    int64_t r = 0;
    for (int64_t col = 0; col < n && r < m; ++col) {
        // find pivot row
        int64_t piv = -1;
        for (int64_t i = r; i < m; ++i) {
            if (a[i * n + col] % p != 0) { piv = i; break; }
        }
        if (piv < 0) continue;
        if (piv != r) {
            for (int64_t j = col; j < n; ++j) {
                uint64_t t = a[r * n + j];
                a[r * n + j] = a[piv * n + j];
                a[piv * n + j] = t;
            }
        }
        uint64_t inv = invmod(a[r * n + col] % p, p);
        for (int64_t j = col; j < n; ++j)
            a[r * n + j] = mulmod(a[r * n + j] % p, inv, p);
        for (int64_t i = 0; i < m; ++i) {
            if (i == r) continue;
            uint64_t f = a[i * n + col] % p;
            if (f == 0) continue;
            uint64_t negf = p - f;
            for (int64_t j = col; j < n; ++j) {
                uint64_t add = mulmod(a[r * n + j], negf, p);
                uint64_t v = a[i * n + j] + add;  // both < p < 2^62: no overflow
                a[i * n + j] = v >= p ? v - p : v;
            }
        }
        pivots[r] = col;
        ++r;
    }
    return r;
}

// Matrix-vector product y = A x mod p (used by Dixon lifting iterations).
void matvec_mod_p_u64(const uint64_t* a, int64_t m, int64_t n,
                      const uint64_t* x, uint64_t p, uint64_t* y) {
    for (int64_t i = 0; i < m; ++i) {
        u128 acc = 0;
        const uint64_t* row = a + i * n;
        for (int64_t j = 0; j < n; ++j) {
            acc += (u128)row[j] * x[j];
            if ((j & 7) == 7) acc %= p;  // 8 * p^2 < 2^127: no overflow for p < 2^62
        }
        y[i] = (uint64_t)(acc % p);
    }
}

}  // extern "C"
