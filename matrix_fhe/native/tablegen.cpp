// Native table generator for matrix_fhe.
//
// The reference builds its W-CRT tables host-side in CUDA-C++
// (init_wntt_tables, HE.cu:237-273: Vandermonde build + O(phi^3)
// Gauss-Jordan inverse per limb).  This module is the framework's native
// equivalent: exact __int128 modular arithmetic, but with the O(phi^2)
// Lagrange-basis inversion (the evaluation points are all primitive p-th
// roots, so the master polynomial is the cyclotomic Phi_p and the modular
// inverse is unique — bit-identical to Gauss-Jordan's result).
//
// Exposed via a C ABI for ctypes (no pybind11 dependency).
//
// Build: g++ -O3 -shared -fPIC -o libtablegen.so tablegen.cpp

#include <cstdint>
#include <vector>

typedef unsigned __int128 u128;

static inline uint64_t mulmod(uint64_t a, uint64_t b, uint64_t q) {
    return (uint64_t)((u128)a * b % q);
}

static uint64_t powmod(uint64_t base, uint64_t exp, uint64_t q) {
    uint64_t r = 1;
    base %= q;
    while (exp) {
        if (exp & 1) r = mulmod(r, base, q);
        base = mulmod(base, base, q);
        exp >>= 1;
    }
    return r;
}

static inline uint64_t invmod(uint64_t x, uint64_t q) {  // q prime
    return powmod(x, q - 2, q);
}

extern "C" {

// out_v[w*phi + r] = roots[w]^r mod q   (init_wntt_tables V build)
void mf_vandermonde(uint64_t q, const uint64_t* roots, int64_t phi,
                    uint64_t* out_v) {
    for (int64_t w = 0; w < phi; ++w) {
        uint64_t cur = 1;
        const uint64_t x = roots[w];
        for (int64_t r = 0; r < phi; ++r) {
            out_v[w * phi + r] = cur;
            cur = mulmod(cur, x, q);
        }
    }
}

// out_vinv[r*phi + w] = coeff_r(master/(X - roots[w])) / master'(roots[w])
// master: phi+1 little-endian signed coefficients of the monic cyclotomic.
void mf_lagrange_inverse(uint64_t q, const uint64_t* roots, int64_t phi,
                         const int64_t* master, uint64_t* out_vinv) {
    std::vector<uint64_t> m(phi + 1), dm(phi);
    for (int64_t k = 0; k <= phi; ++k) {
        int64_t c = master[k] % (int64_t)q;
        if (c < 0) c += (int64_t)q;
        m[k] = (uint64_t)c;
    }
    for (int64_t k = 1; k <= phi; ++k) {
        dm[k - 1] = mulmod((uint64_t)(k % (int64_t)q), m[k], q);
    }
    std::vector<uint64_t> qc(phi);
    for (int64_t w = 0; w < phi; ++w) {
        const uint64_t x = roots[w];
        // synthetic division master / (X - x)
        qc[phi - 1] = m[phi];  // == 1 (monic)
        for (int64_t k = phi - 1; k > 0; --k) {
            qc[k - 1] = (m[k] + (u128)x * qc[k]) % q;
        }
        // master'(x) by Horner
        uint64_t acc = 0;
        for (int64_t k = phi - 1; k >= 0; --k) {
            acc = (uint64_t)(((u128)acc * x + dm[k]) % q);
        }
        const uint64_t s = invmod(acc, q);
        for (int64_t r = 0; r < phi; ++r) {
            out_vinv[r * phi + w] = mulmod(qc[r], s, q);
        }
    }
}

// Order-p root search mirroring h_find_eta (HE.cu:119-133).
uint64_t mf_find_eta(uint64_t q, uint64_t p, uint64_t f1, uint64_t f2) {
    const uint64_t exp = (q - 1) / p;
    for (uint64_t g = 2; g < q; ++g) {
        uint64_t eta = powmod(g, exp, q);
        if (eta == 1) continue;
        if (powmod(eta, p, q) != 1) continue;
        if (powmod(eta, p / f1, q) == 1) continue;
        if (powmod(eta, p / f2, q) == 1) continue;
        return eta;
    }
    return 0;
}

// Order-4n root search mirroring get_psi (ntt_core.cu:49-70).
uint64_t mf_find_psi4n(uint64_t q, uint64_t n) {
    const uint64_t order = 4 * n;
    if ((q - 1) % order != 0) return 0;
    for (uint64_t root = 2; root <= 100000; ++root) {
        uint64_t g = powmod(root, (q - 1) / order, q);
        if (powmod(g, 2 * n, q) == q - 1) return g;
    }
    return 0;
}

}  // extern "C"
