// The exp AIRs' oracle: each instance's expected output in exact BN254
// arithmetic, for the check that ends tracegen (upstream g1/exp.rs:279-285
// and its G2 and Fq12 equivalents).
//
// Host C++ (g++, no CUDA, no torch), built and loaded by native.py. It is
// written apart from native/witness.cpp, whose chain outputs it checks, and
// shares nothing with it: its own 4 x 64-bit Montgomery arithmetic mod p,
// Fq2 = Fq[u]/(u^2 + 1), Fq12 = Fq2[w]/(w^6 - (9 + u)). A fault in the
// chain's 16-bit limb arithmetic cannot repeat here.
//
// Each entry follows bn254.py step by step, its degenerate cases included:
//   g1: g1_add(g1_mul(x, e), offset)   (Jacobian double-and-add from the low
//   g2: g2_add(g2_mul(x, e), offset)    bit, one final inversion, then the
//                                       affine addition of the offset)
//   fq12: offset * x^e
// An inverse is a^(p-2), so the inverse of 0 is 0, as bn254.fq_inv gives.
// Where bn254.py returns the offset unchanged (x * e is the point at
// infinity) the output is the offset's own words, and its x == offset.x test
// compares words, as Python compares ints. A result at infinity sets the
// instance's `inf` flag and writes zero words.
//
// Values cross the interface as 4 little-endian 64-bit words per Fq element
// (any value below 2^256; reduced mod p on the way in), outputs reduced
// below p but for that copied offset. Instances are split over
// min(n, hardware threads) threads, capped by STARKY_NATIVE_THREADS.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

typedef unsigned __int128 u128;

struct Fq {
    uint64_t w[4];
};

constexpr uint64_t P[4] = {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                           0xb85045b68181585dULL, 0x30644e72e131a029ULL};
constexpr uint64_t P_MINUS_2[4] = {0x3c208c16d87cfd45ULL, 0x97816a916871ca8dULL,
                                   0xb85045b68181585dULL, 0x30644e72e131a029ULL};
constexpr uint64_t NEG_P_INV = 0x87d20782e4866389ULL;  // -p^-1 mod 2^64
constexpr Fq R_MOD_P = {{0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL,
                         0x666ea36f7879462cULL, 0x0e0a77c19a07df2fULL}};  // 1
constexpr Fq R2_MOD_P = {{0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL,
                          0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL}};
constexpr Fq ZERO = {{0, 0, 0, 0}};

inline bool geq_p(const uint64_t* a) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] != P[i]) return a[i] > P[i];
    }
    return true;
}

inline void sub_p(uint64_t* a) {
    uint64_t borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - P[i] - borrow;
        a[i] = (uint64_t)d;
        borrow = (uint64_t)(d >> 64) & 1;
    }
}

inline bool is_zero(const Fq& a) { return (a.w[0] | a.w[1] | a.w[2] | a.w[3]) == 0; }

// a + b; operands below p < 2^254, so the sum fits in 256 bits
inline Fq add(const Fq& a, const Fq& b) {
    Fq r;
    uint64_t carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a.w[i] + b.w[i] + carry;
        r.w[i] = (uint64_t)s;
        carry = (uint64_t)(s >> 64);
    }
    if (geq_p(r.w)) sub_p(r.w);
    return r;
}

inline Fq sub(const Fq& a, const Fq& b) {
    Fq r;
    uint64_t borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a.w[i] - b.w[i] - borrow;
        r.w[i] = (uint64_t)d;
        borrow = (uint64_t)(d >> 64) & 1;
    }
    if (borrow) {
        uint64_t carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 s = (u128)r.w[i] + P[i] + carry;
            r.w[i] = (uint64_t)s;
            carry = (uint64_t)(s >> 64);
        }
    }
    return r;
}

inline Fq dbl(const Fq& a) { return add(a, a); }

// Montgomery product a * b / 2^256 mod p (CIOS). Holds for any a < 2^256
// with b < p: the result before the last subtraction is below 2p. The
// products below are kept out of line: inlined, they made the build take
// six times as long and the oracle no faster.
__attribute__((noinline)) Fq mul(const Fq& a, const Fq& b) {
    uint64_t t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 c = 0;
        for (int j = 0; j < 4; j++) {
            c += (u128)a.w[j] * b.w[i] + t[j];
            t[j] = (uint64_t)c;
            c >>= 64;
        }
        c += t[4];
        t[4] = (uint64_t)c;
        t[5] = (uint64_t)(c >> 64);
        uint64_t m = t[0] * NEG_P_INV;
        c = ((u128)m * P[0] + t[0]) >> 64;
        for (int j = 1; j < 4; j++) {
            c += (u128)m * P[j] + t[j];
            t[j - 1] = (uint64_t)c;
            c >>= 64;
        }
        c += t[4];
        t[3] = (uint64_t)c;
        t[4] = t[5] + (uint64_t)(c >> 64);
    }
    Fq r = {{t[0], t[1], t[2], t[3]}};
    if (t[4] != 0 || geq_p(r.w)) sub_p(r.w);
    return r;
}

inline Fq sqr(const Fq& a) { return mul(a, a); }

// a^(p-2): the inverse of a nonzero a, and 0 for 0 (bn254.fq_inv)
__attribute__((noinline)) Fq inv(const Fq& a) {
    Fq r = R_MOD_P;
    for (int i = 3; i >= 0; i--) {
        for (int b = 63; b >= 0; b--) {
            r = sqr(r);
            if ((P_MINUS_2[i] >> b) & 1) r = mul(r, a);
        }
    }
    return r;
}

// words (any value < 2^256) -> Montgomery form; and back, reduced below p
inline Fq to_mont(const uint64_t* words) {
    Fq a = {{words[0], words[1], words[2], words[3]}};
    return mul(a, R2_MOD_P);
}

inline void from_mont(const Fq& a, uint64_t* words) {
    const Fq one = {{1, 0, 0, 0}};
    Fq r = mul(a, one);
    for (int i = 0; i < 4; i++) words[i] = r.w[i];
}

// the value of `a` equals the words `raw` as integers (a's canonical value)
inline bool equals_words(const Fq& a, const uint64_t* raw) {
    uint64_t w[4];
    from_mont(a, w);
    return w[0] == raw[0] && w[1] == raw[1] && w[2] == raw[2] && w[3] == raw[3];
}

// ------------------------------------------------------------------ Fq2
struct Fq2 {
    Fq c0, c1;  // c0 + c1 u, u^2 = -1
};

inline Fq2 add(const Fq2& a, const Fq2& b) { return {add(a.c0, b.c0), add(a.c1, b.c1)}; }
inline Fq2 sub(const Fq2& a, const Fq2& b) { return {sub(a.c0, b.c0), sub(a.c1, b.c1)}; }
inline Fq2 dbl(const Fq2& a) { return {dbl(a.c0), dbl(a.c1)}; }
inline bool is_zero(const Fq2& a) { return is_zero(a.c0) && is_zero(a.c1); }

__attribute__((noinline)) Fq2 mul(const Fq2& a, const Fq2& b) {
    Fq v0 = mul(a.c0, b.c0), v1 = mul(a.c1, b.c1);
    Fq s = mul(add(a.c0, a.c1), add(b.c0, b.c1));
    return {sub(v0, v1), sub(sub(s, v0), v1)};
}

__attribute__((noinline)) Fq2 sqr(const Fq2& a) {
    Fq t = mul(a.c0, a.c1);
    return {mul(add(a.c0, a.c1), sub(a.c0, a.c1)), dbl(t)};
}

// (a0 - a1 u) / (a0^2 + a1^2); 0 for 0 (bn254.fq2_inv)
Fq2 inv(const Fq2& a) {
    Fq ninv = inv(add(sqr(a.c0), sqr(a.c1)));
    return {mul(a.c0, ninv), sub(ZERO, mul(a.c1, ninv))};
}

// a * (9 + u) = (9 a0 - a1) + (a0 + 9 a1) u
inline Fq nine(const Fq& a) {
    Fq a8 = dbl(dbl(dbl(a)));
    return add(a8, a);
}

inline Fq2 mul_by_xi(const Fq2& a) { return {sub(nine(a.c0), a.c1), add(a.c0, nine(a.c1))}; }

// ------------------------------------------------- G1 and G2 (templated)
// Jacobian points with bn254.py's None as `none`
template <class F>
struct Jac {
    F x, y, z;
    bool none;
};

template <class F>
Jac<F> jdouble(const Jac<F>& p) {  // bn254._jdouble / _g2_jdouble
    if (p.none) return p;
    F a = sqr(p.x), b = sqr(p.y);
    F c = sqr(b);
    F t = add(p.x, b);
    F d = dbl(sub(sub(sqr(t), a), c));
    F e = add(dbl(a), a);
    F f = sqr(e);
    F x3 = sub(f, dbl(d));
    F c8 = dbl(dbl(dbl(c)));
    F y3 = sub(mul(e, sub(d, x3)), c8);
    F z3 = dbl(mul(p.y, p.z));
    return {x3, y3, z3, false};
}

template <class F>
Jac<F> jadd(const Jac<F>& p, const Jac<F>& q) {  // bn254._jadd / _g2_jadd
    if (p.none) return q;
    if (q.none) return p;
    F z1z1 = sqr(p.z), z2z2 = sqr(q.z);
    F u1 = mul(p.x, z2z2), u2 = mul(q.x, z1z1);
    F s1 = mul(mul(p.y, q.z), z2z2), s2 = mul(mul(q.y, p.z), z1z1);
    F h = sub(u2, u1), r = sub(s2, s1);
    if (is_zero(h)) {
        if (is_zero(r)) return jdouble(p);
        return {p.x, p.y, p.z, true};
    }
    F hh = sqr(h);
    F hhh = mul(h, hh);
    F v = mul(u1, hh);
    F x3 = sub(sub(sqr(r), hhh), dbl(v));
    F y3 = sub(mul(r, sub(v, x3)), mul(s1, hhh));
    F z3 = mul(mul(p.z, q.z), h);
    return {x3, y3, z3, false};
}

template <class F>
struct Affine {
    F x, y;
    bool none;
};

// bn254.g1_mul / g2_mul: low bit first, one inversion at the end
template <class F>
Affine<F> scalar_mul(const F& x, const F& y, const F& one, const uint64_t* e) {
    Affine<F> out{x, y, true};
    int top = -1;
    for (int b = 255; b >= 0; b--) {
        if ((e[b >> 6] >> (b & 63)) & 1) {
            top = b;
            break;
        }
    }
    if (top < 0) return out;  // k == 0
    Jac<F> acc{x, y, one, true};
    Jac<F> base{x, y, one, false};
    for (int b = 0; b <= top; b++) {
        if ((e[b >> 6] >> (b & 63)) & 1) acc = jadd(acc, base);
        if (b < top) base = jdouble(base);
    }
    if (acc.none || is_zero(acc.z)) return out;
    F zinv = inv(acc.z);
    F z2 = sqr(zinv);
    out.x = mul(acc.x, z2);
    out.y = mul(mul(acc.y, z2), zinv);
    out.none = false;
    return out;
}

// bn254.g1_double / g2_double (p is not None)
template <class F>
Affine<F> affine_double(const Affine<F>& p) {
    F x2 = sqr(p.x);
    F lam = mul(add(dbl(x2), x2), inv(dbl(p.y)));
    F x3 = sub(sqr(lam), dbl(p.x));
    F y3 = sub(mul(lam, sub(p.x, x3)), p.y);
    return {x3, y3, false};
}

// ------------------------------------------------------ word conversions
inline void load(const uint64_t* w, Fq& a) { a = to_mont(w); }
inline void load(const uint64_t* w, Fq2& a) {
    a.c0 = to_mont(w);
    a.c1 = to_mont(w + 4);
}
inline void store(const Fq& a, uint64_t* w) { from_mont(a, w); }
inline void store(const Fq2& a, uint64_t* w) {
    from_mont(a.c0, w);
    from_mont(a.c1, w + 4);
}
inline bool equals_words(const Fq2& a, const uint64_t* raw) {
    return equals_words(a.c0, raw) && equals_words(a.c1, raw + 4);
}
inline Fq one_of(const Fq*) { return R_MOD_P; }
inline Fq2 one_of(const Fq2*) { return {R_MOD_P, ZERO}; }

// One instance of g_add(g_mul(x, e), offset). x, off: [x | y] words, W
// words a coordinate; out likewise; returns whether the result is None.
template <class F, int W>
bool point_exp(const uint64_t* xw, const uint64_t* offw, const uint64_t* e, uint64_t* out) {
    F x, y, ox, oy;
    load(xw, x);
    load(xw + W, y);
    load(offw, ox);
    load(offw + W, oy);
    Affine<F> p = scalar_mul(x, y, one_of((F*)nullptr), e);
    if (p.none) {  // g_add(None, q) is q itself, as given
        std::copy(offw, offw + 2 * W, out);
        return false;
    }
    Affine<F> r;
    if (equals_words(p.x, offw)) {  // x1 == x2 on the ints
        if (is_zero(add(p.y, oy))) {
            std::fill(out, out + 2 * W, 0);
            return true;
        }
        r = affine_double(p);
    } else {
        F lam = mul(sub(oy, p.y), inv(sub(ox, p.x)));
        r.x = sub(sub(sqr(lam), p.x), ox);
        r.y = sub(mul(lam, sub(p.x, r.x)), p.y);
    }
    store(r.x, out);
    store(r.y, out + W);
    return false;
}

// ------------------------------------------------------------------ Fq12
struct Fq12 {
    Fq2 c[6];  // sum c[k] w^k, w^6 = 9 + u
};

__attribute__((noinline)) Fq12 mul(const Fq12& a, const Fq12& b) {  // bn254.Fq12.__mul__
    Fq2 wide[11];
    for (auto& v : wide) v = {ZERO, ZERO};
    for (int i = 0; i < 6; i++)
        for (int j = 0; j < 6; j++) wide[i + j] = add(wide[i + j], mul(a.c[i], b.c[j]));
    Fq12 r;
    for (int k = 0; k < 6; k++) r.c[k] = wide[k];
    for (int k = 6; k < 11; k++) r.c[k - 6] = add(r.c[k - 6], mul_by_xi(wide[k]));
    return r;
}

__attribute__((noinline)) Fq12 sqr(const Fq12& a) {  // mul(a, a) with each cross product once, doubled
    Fq2 wide[11];
    for (auto& v : wide) v = {ZERO, ZERO};
    for (int i = 0; i < 6; i++)
        for (int j = i + 1; j < 6; j++) wide[i + j] = add(wide[i + j], mul(a.c[i], a.c[j]));
    for (auto& v : wide) v = dbl(v);
    for (int i = 0; i < 6; i++) wide[2 * i] = add(wide[2 * i], sqr(a.c[i]));
    Fq12 r;
    for (int k = 0; k < 6; k++) r.c[k] = wide[k];
    for (int k = 6; k < 11; k++) r.c[k - 6] = add(r.c[k - 6], mul_by_xi(wide[k]));
    return r;
}

// 12 values in bn254.Fq12.to_fq_list order: real parts c0..c5, then the
// imaginary parts
void load(const uint64_t* w, Fq12& a) {
    for (int k = 0; k < 6; k++) {
        a.c[k].c0 = to_mont(w + 4 * k);
        a.c[k].c1 = to_mont(w + 4 * (k + 6));
    }
}

void store(const Fq12& a, uint64_t* w) {
    for (int k = 0; k < 6; k++) {
        from_mont(a.c[k].c0, w + 4 * k);
        from_mont(a.c[k].c1, w + 4 * (k + 6));
    }
}

// offset * x^e (square and multiply from the top bit: the same power as
// bn254.Fq12.pow's low-bit-first loop, the ring being commutative)
void fq12_exp(const uint64_t* xw, const uint64_t* offw, const uint64_t* e, uint64_t* out) {
    Fq12 x, off, acc;
    load(xw, x);
    load(offw, off);
    for (auto& v : acc.c) v = {ZERO, ZERO};
    acc.c[0].c0 = R_MOD_P;
    bool started = false;
    for (int b = 255; b >= 0; b--) {
        if (started) acc = sqr(acc);
        if ((e[b >> 6] >> (b & 63)) & 1) {
            acc = started ? mul(acc, x) : x;
            started = true;
        }
    }
    store(mul(off, acc), out);
}

// --------------------------------------------------------------- threads
unsigned oracle_threads(int64_t n) {
    unsigned hw = std::max(1u, std::thread::hardware_concurrency());
    const char* cap = std::getenv("STARKY_NATIVE_THREADS");
    if (cap != nullptr) {
        long v = std::atol(cap);
        if (v >= 1 && (unsigned)v < hw) hw = (unsigned)v;
    }
    return (unsigned)std::min<int64_t>(hw, std::max<int64_t>(n, 1));
}

// body(i) for every instance i < n; threads take the next instance in turn
template <class Body>
void for_instances(int64_t n, Body body) {
    unsigned nt = oracle_threads(n);
    std::atomic<int64_t> next{0};
    auto run = [&]() {
        for (int64_t i = next.fetch_add(1); i < n; i = next.fetch_add(1)) body(i);
    };
    if (nt <= 1) {
        run();
        return;
    }
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < nt; t++) ts.emplace_back(run);
    for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// x, off, out: [n][2][4] words (x then y); e: [n][4]; inf: [n]
void oracle_g1_exp(int64_t n, const uint64_t* x, const uint64_t* off, const uint64_t* e,
                   uint64_t* out, uint8_t* inf) {
    for_instances(n, [&](int64_t i) {
        inf[i] = point_exp<Fq, 4>(x + 8 * i, off + 8 * i, e + 4 * i, out + 8 * i);
    });
}

// x, off, out: [n][2][2][4] words (x.c0 x.c1 y.c0 y.c1); e: [n][4]; inf: [n]
void oracle_g2_exp(int64_t n, const uint64_t* x, const uint64_t* off, const uint64_t* e,
                   uint64_t* out, uint8_t* inf) {
    for_instances(n, [&](int64_t i) {
        inf[i] = point_exp<Fq2, 8>(x + 16 * i, off + 16 * i, e + 4 * i, out + 16 * i);
    });
}

// x, off, out: [n][12][4] words (to_fq_list order); e: [n][4]
void oracle_fq12_exp(int64_t n, const uint64_t* x, const uint64_t* off, const uint64_t* e,
                     uint64_t* out) {
    for_instances(n, [&](int64_t i) {
        fq12_exp(x + 48 * i, off + 48 * i, e + 4 * i, out + 48 * i);
    });
}

}  // extern "C"
