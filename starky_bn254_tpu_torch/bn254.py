"""Host-side BN254 arithmetic oracle (pure Python ints).

A host copy of the JAX package's bn254.py: the two moduli and the G2
cofactor, G1 (y^2 = x^3 + 3 over Fq), Fq2 = Fq[u]/(u^2 + 1), Fq12 =
Fq2[w]/(w^6 - XI) with XI = 9 + u, G2 (y^2 = x^3 + 3/XI over Fq2), the Fq
and Fq2 square roots and the SVDW map to the G2 twist (hash-to-G2); points
are affine, None is the point at infinity. Exact integer arithmetic, used
only on the host to build witnesses and check outputs, never on the device
compute path.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

# BN254 base field modulus
P_BN = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# BN254 scalar field (group order of G1/G2)
R_BN = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# G2 cofactor (reference hardcodes it at src/curves/g2/circuit.rs:346-349)
G2_COFACTOR = (
    21888242871839275222246405745257275088844257914179612981679871602714643921549
)


def fq_inv(a: int) -> int:
    return pow(a % P_BN, P_BN - 2, P_BN)


# ----------------------------------------------------------------------------
# Fq2 = Fq[u]/(u^2+1): represented as (c0, c1) = c0 + c1*u
# ----------------------------------------------------------------------------


def fq2_add(a, b):
    return ((a[0] + b[0]) % P_BN, (a[1] + b[1]) % P_BN)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P_BN, (a[1] - b[1]) % P_BN)


def fq2_neg(a):
    return ((-a[0]) % P_BN, (-a[1]) % P_BN)


def fq2_mul(a, b):
    return (
        (a[0] * b[0] - a[1] * b[1]) % P_BN,
        (a[0] * b[1] + a[1] * b[0]) % P_BN,
    )


def fq2_scalar(a, s: int):
    return (a[0] * s % P_BN, a[1] * s % P_BN)


def fq2_inv(a):
    ninv = fq_inv(a[0] * a[0] + a[1] * a[1])
    return (a[0] * ninv % P_BN, (-a[1]) * ninv % P_BN)


XI = (9, 1)  # 9 + u, the sextic non-residue


# ----------------------------------------------------------------------------
# Fq12 = Fq2[w]/(w^6 - XI): 6 Fq2 coefficients
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class Fq12:
    coeffs: tuple  # tuple of 6 Fq2 pairs

    @staticmethod
    def one() -> "Fq12":
        return Fq12(((1, 0),) + ((0, 0),) * 5)

    @staticmethod
    def zero() -> "Fq12":
        return Fq12(((0, 0),) * 6)

    def __mul__(self, other: "Fq12") -> "Fq12":
        a, b = self.coeffs, other.coeffs
        wide = [(0, 0)] * 11
        for i in range(6):
            for j in range(6):
                wide[i + j] = fq2_add(wide[i + j], fq2_mul(a[i], b[j]))
        out = list(wide[:6])
        for k in range(6, 11):
            out[k - 6] = fq2_add(out[k - 6], fq2_mul(wide[k], XI))
        return Fq12(tuple(out))

    def inv(self) -> "Fq12":
        """Extended Euclid over Fq2[w] modulo w^6 - XI."""
        return _fq12_inv(self)

    def pow(self, e: int) -> "Fq12":
        result = Fq12.one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def to_fq_list(self) -> list[int]:
        """Flatten to 12 Fq values: [c0.re..c5.re, c0.im..c5.im], the
        column order of the Fq12 gadgets (12 blocks of N_LIMBS, real parts
        first)."""
        return [c[0] for c in self.coeffs] + [c[1] for c in self.coeffs]

    @staticmethod
    def from_fq_list(vals) -> "Fq12":
        vals = [int(v) % P_BN for v in vals]
        return Fq12(tuple((vals[k], vals[k + 6]) for k in range(6)))


def _poly_divmod(a: list, b: list):
    """Polynomial division over Fq2; a, b: lists of Fq2 coeffs (low->high)."""
    a = list(a)
    while a and a[-1] == (0, 0):
        a.pop()
    bl = list(b)
    while bl and bl[-1] == (0, 0):
        bl.pop()
    q = [(0, 0)] * max(len(a) - len(bl) + 1, 0)
    inv_lead = fq2_inv(bl[-1])
    while len(a) >= len(bl) and a:
        f = fq2_mul(a[-1], inv_lead)
        pos = len(a) - len(bl)
        q[pos] = f
        for i, c in enumerate(bl):
            a[pos + i] = fq2_sub(a[pos + i], fq2_mul(f, c))
        while a and a[-1] == (0, 0):
            a.pop()
    return q, a


def _fq12_inv(x: Fq12) -> Fq12:
    # extended Euclid in Fq2[w] modulo m(w) = w^6 - XI
    m = [fq2_neg(XI), (0, 0), (0, 0), (0, 0), (0, 0), (0, 0), (1, 0)]
    r0, r1 = m, list(x.coeffs)
    while r1 and r1[-1] == (0, 0):
        r1.pop()
    s0, s1 = [], [(1, 0)]
    while True:
        if len(r1) == 1:
            inv_c = fq2_inv(r1[0])
            out = [fq2_mul(c, inv_c) for c in s1]
            out += [(0, 0)] * (6 - len(out))
            return Fq12(tuple(out[:6]))
        q, r = _poly_divmod(r0, r1)
        # s_new = s0 - q*s1
        prod = [(0, 0)] * (len(q) + len(s1) - 1 if s1 else 0)
        for i, qc in enumerate(q):
            for j, sc in enumerate(s1):
                prod[i + j] = fq2_add(prod[i + j], fq2_mul(qc, sc))
        ln = max(len(s0), len(prod))
        s_new = [
            fq2_sub(s0[i] if i < len(s0) else (0, 0), prod[i] if i < len(prod) else (0, 0))
            for i in range(ln)
        ]
        r0, r1 = r1, r
        s0, s1 = s1, s_new
        while r1 and r1[-1] == (0, 0):
            r1.pop()
        if not r1:
            raise ZeroDivisionError("Fq12 element not invertible")


# ----------------------------------------------------------------------------
# G1: y^2 = x^3 + 3 over Fq (affine; None = point at infinity)
# ----------------------------------------------------------------------------

G1_GEN = (1, 2)


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - 3) % P_BN == 0


def g1_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % P_BN == 0:
            return None
        return g1_double(p)
    lam = (y2 - y1) * fq_inv(x2 - x1) % P_BN
    x3 = (lam * lam - x1 - x2) % P_BN
    y3 = (lam * (x1 - x3) - y1) % P_BN
    return (x3, y3)


def g1_double(p):
    if p is None:
        return None
    x, y = p
    lam = 3 * x * x * fq_inv(2 * y) % P_BN
    x3 = (lam * lam - 2 * x) % P_BN
    y3 = (lam * (x - x3) - y) % P_BN
    return (x3, y3)


def g1_neg(p):
    if p is None:
        return None
    return (p[0], (-p[1]) % P_BN)


def _jdouble(pt):
    if pt is None:
        return None
    x, y, z = pt
    a = x * x % P_BN
    b = y * y % P_BN
    c = b * b % P_BN
    d = 2 * ((x + b) * (x + b) - a - c) % P_BN
    e = 3 * a % P_BN
    f = e * e % P_BN
    x3 = (f - 2 * d) % P_BN
    y3 = (e * (d - x3) - 8 * c) % P_BN
    z3 = 2 * y * z % P_BN
    return (x3, y3, z3)


def _jadd(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % P_BN
    z2z2 = z2 * z2 % P_BN
    u1 = x1 * z2z2 % P_BN
    u2 = x2 * z1z1 % P_BN
    s1 = y1 * z2 * z2z2 % P_BN
    s2 = y2 * z1 * z1z1 % P_BN
    h = (u2 - u1) % P_BN
    r = (s2 - s1) % P_BN
    if h == 0:
        if r == 0:
            return _jdouble(p)
        return None
    hh = h * h % P_BN
    hhh = h * hh % P_BN
    v = u1 * hh % P_BN
    x3 = (r * r - hhh - 2 * v) % P_BN
    y3 = (r * (v - x3) - s1 * hhh) % P_BN
    z3 = z1 * z2 * h % P_BN
    return (x3, y3, z3)


def g1_mul(p, k: int):
    """Scalar multiplication via Jacobian coordinates (one final inversion)."""
    if p is None or k == 0:
        return None
    acc = None
    base = (p[0], p[1], 1)
    while k > 0:
        if k & 1:
            acc = _jadd(acc, base)
        base = _jdouble(base)
        k >>= 1
    if acc is None:
        return None
    x, y, z = acc
    if z == 0:
        return None
    zinv = fq_inv(z)
    zinv2 = zinv * zinv % P_BN
    return (x * zinv2 % P_BN, y * zinv2 * zinv % P_BN)


# ----------------------------------------------------------------------------
# G2: y^2 = x^3 + 3/XI over Fq2 (affine; None = point at infinity)
# ----------------------------------------------------------------------------

G2_B = fq2_mul((3, 0), fq2_inv(XI))

G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return fq2_mul(y, y) == fq2_add(fq2_mul(fq2_mul(x, x), x), G2_B)


def g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if fq2_add(y1, y2) == (0, 0):
            return None
        return g2_double(p)
    lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_mul(lam, lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_double(p):
    if p is None:
        return None
    x, y = p
    lam = fq2_mul(fq2_scalar(fq2_mul(x, x), 3), fq2_inv(fq2_scalar(y, 2)))
    x3 = fq2_sub(fq2_mul(lam, lam), fq2_scalar(x, 2))
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x, x3)), y)
    return (x3, y3)


def g2_neg(p):
    if p is None:
        return None
    return (p[0], fq2_neg(p[1]))


def _g2_jdouble(pt):
    if pt is None:
        return None
    x, y, z = pt
    a = fq2_mul(x, x)
    b = fq2_mul(y, y)
    c = fq2_mul(b, b)
    t = fq2_add(x, b)
    d = fq2_scalar(fq2_sub(fq2_sub(fq2_mul(t, t), a), c), 2)
    e = fq2_scalar(a, 3)
    f = fq2_mul(e, e)
    x3 = fq2_sub(f, fq2_scalar(d, 2))
    y3 = fq2_sub(fq2_mul(e, fq2_sub(d, x3)), fq2_scalar(c, 8))
    z3 = fq2_scalar(fq2_mul(y, z), 2)
    return (x3, y3, z3)


def _g2_jadd(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = fq2_mul(z1, z1)
    z2z2 = fq2_mul(z2, z2)
    u1 = fq2_mul(x1, z2z2)
    u2 = fq2_mul(x2, z1z1)
    s1 = fq2_mul(fq2_mul(y1, z2), z2z2)
    s2 = fq2_mul(fq2_mul(y2, z1), z1z1)
    h = fq2_sub(u2, u1)
    r = fq2_sub(s2, s1)
    if h == (0, 0):
        if r == (0, 0):
            return _g2_jdouble(p)
        return None
    hh = fq2_mul(h, h)
    hhh = fq2_mul(h, hh)
    v = fq2_mul(u1, hh)
    x3 = fq2_sub(fq2_sub(fq2_mul(r, r), hhh), fq2_scalar(v, 2))
    y3 = fq2_sub(fq2_mul(r, fq2_sub(v, x3)), fq2_mul(s1, hhh))
    z3 = fq2_mul(fq2_mul(z1, z2), h)
    return (x3, y3, z3)


def g2_mul(p, k: int):
    """Scalar multiplication via Jacobian coordinates over Fq2 (one final
    inversion)."""
    if p is None or k == 0:
        return None
    acc = None
    base = (p[0], p[1], (1, 0))
    while k > 0:
        if k & 1:
            acc = _g2_jadd(acc, base)
        base = _g2_jdouble(base)
        k >>= 1
    if acc is None:
        return None
    x, y, z = acc
    if z == (0, 0):
        return None
    zinv = fq2_inv(z)
    z2 = fq2_mul(zinv, zinv)
    return (fq2_mul(x, z2), fq2_mul(fq2_mul(y, z2), zinv))


# ----------------------------------------------------------------------------
# Square roots in Fq / Fq2 and the SVDW map to the G2 twist (hash-to-G2)
# ----------------------------------------------------------------------------
# The reference composes plonky2-bn254's `map_to_g2_without_cofactor_mul`
# with its cofactor-mul circuit for hash-to-G2 (reference
# src/curves/g2/circuit.rs:388-390,445-474). Here the map itself is the
# standard Shallue-van de Woestijne encoding (RFC 9380 §6.6.1) specialized
# to E': y^2 = x^3 + 3/(9+u) over Fq2 (A = 0); the cofactor multiplication
# is the proven part (compose.msm.g2_mul_by_cofactor_input).

_HALF_BN = (P_BN + 1) // 2  # 1/2 mod p


def fq_is_square(a: int) -> bool:
    a %= P_BN
    return a == 0 or pow(a, (P_BN - 1) // 2, P_BN) == 1


def fq_sqrt(a: int):
    """sqrt mod p (p === 3 mod 4), or None if a is not a square."""
    a %= P_BN
    r = pow(a, (P_BN + 1) // 4, P_BN)
    return r if r * r % P_BN == a else None


def fq2_is_square(a) -> bool:
    """a is a square in Fq2 iff its norm a0^2 + a1^2 is a square in Fq
    (a^((p^2-1)/2) = norm(a)^((p-1)/2) since a^(p+1) = norm(a))."""
    a0, a1 = a
    return fq_is_square((a0 * a0 + a1 * a1) % P_BN)


def fq2_sqrt(a):
    """Square root in Fq2 = Fq[u]/(u^2+1) by the complex method; None if a
    is a non-residue. (x0 + x1 u)^2 = (x0^2 - x1^2) + 2 x0 x1 u."""
    a0, a1 = a[0] % P_BN, a[1] % P_BN
    if a1 == 0:
        r = fq_sqrt(a0)
        if r is not None:
            return (r, 0)
        r = fq_sqrt(P_BN - a0)  # (x u)^2 = -x^2 = a0
        return None if r is None else (0, r)
    alpha = fq_sqrt((a0 * a0 + a1 * a1) % P_BN)  # norm
    if alpha is None:
        return None
    delta = (a0 + alpha) * _HALF_BN % P_BN
    if not fq_is_square(delta):
        delta = (a0 - alpha) * _HALF_BN % P_BN
    x0 = fq_sqrt(delta)
    if x0 is None:
        return None
    x1 = a1 * _HALF_BN % P_BN * fq_inv(x0) % P_BN
    return (x0, x1)


def _fq2_sgn0(a) -> int:
    """RFC 9380 sgn0 for m=2: parity of a0, or of a1 when a0 == 0."""
    a0, a1 = a[0] % P_BN, a[1] % P_BN
    return (a0 & 1) if a0 != 0 else (a1 & 1)


def _g2_g(x):
    """g(x) = x^3 + B' on the twist."""
    return fq2_add(fq2_mul(fq2_mul(x, x), x), G2_B)


def _svdw_constants():
    """Find Z per RFC 9380 §6.6.1 criteria and derive c1..c4 (cached)."""
    candidates = []
    for k in range(1, 9):
        candidates += [(k, 0), (P_BN - k, 0), (0, k), (0, P_BN - k), (k, k)]
    for Z in candidates:
        gz = _g2_g(Z)
        if gz == (0, 0):
            continue
        three_z2 = fq2_scalar(fq2_mul(Z, Z), 3)  # 3Z^2 + 4A, A = 0
        if three_z2 == (0, 0):
            continue
        ratio = fq2_mul(fq2_neg(three_z2), fq2_inv(fq2_scalar(gz, 4)))
        if not fq2_is_square(ratio):
            continue
        neg_half_z = fq2_scalar(fq2_neg(Z), _HALF_BN)
        if not (fq2_is_square(gz) or fq2_is_square(_g2_g(neg_half_z))):
            continue
        c1 = gz
        c2 = neg_half_z
        c3 = fq2_sqrt(fq2_mul(fq2_neg(gz), three_z2))
        if c3 is None:
            continue
        if _fq2_sgn0(c3) == 1:
            c3 = fq2_neg(c3)
        c4 = fq2_mul(fq2_scalar(fq2_neg(gz), 4), fq2_inv(three_z2))
        return Z, c1, c2, c3, c4
    raise AssertionError("no SVDW Z found")  # pragma: no cover


_SVDW = None


def map_to_g2_svdw(u) -> tuple:
    """SVDW map Fq2 -> E'(Fq2) (twist point, NOT in the r-torsion subgroup;
    multiply by G2_COFACTOR — the proven step — to land in G2)."""
    global _SVDW
    if _SVDW is None:
        _SVDW = _svdw_constants()
    Z, c1, c2, c3, c4 = _SVDW
    one = (1, 0)
    tv1 = fq2_mul(fq2_mul(u, u), c1)
    tv2 = fq2_add(one, tv1)
    tv1 = fq2_sub(one, tv1)
    tv3 = fq2_mul(tv1, tv2)
    if tv3 == (0, 0):  # exceptional case: inv0 semantics
        tv3 = (0, 0)
    else:
        tv3 = fq2_inv(tv3)
    tv4 = fq2_mul(fq2_mul(fq2_mul(u, tv1), tv3), c3)
    x1 = fq2_sub(c2, tv4)
    gx1 = _g2_g(x1)
    e1 = fq2_is_square(gx1)
    x2 = fq2_add(c2, tv4)
    gx2 = _g2_g(x2)
    e2 = fq2_is_square(gx2) and not e1
    x3 = fq2_add(fq2_mul(fq2_mul(fq2_mul(fq2_mul(tv2, tv2), tv3),
                                 fq2_mul(fq2_mul(tv2, tv2), tv3)), c4), Z)
    x = x1 if e1 else (x2 if e2 else x3)
    gx = _g2_g(x)
    y = fq2_sqrt(gx)
    assert y is not None, "SVDW output must be on the curve"
    if _fq2_sgn0(u) != _fq2_sgn0(y):
        y = fq2_neg(y)
    return (x, y)


def hash_to_g2_field(msg: bytes) -> tuple:
    """Deterministic Fq2 element from a message (SHA-256 counter expansion;
    a fixed, documented scheme — not the full RFC 9380 expand_message)."""

    def fe(tag: bytes) -> int:
        h = b"".join(
            hashlib.sha256(b"starky-bn254-tpu-h2g2" + tag + msg + bytes([i])).digest()
            for i in range(2)
        )
        return int.from_bytes(h, "big") % P_BN

    return (fe(b"c0"), fe(b"c1"))
