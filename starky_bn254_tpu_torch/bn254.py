"""Host-side BN254 arithmetic oracle (pure Python ints).

A host copy of the JAX package's bn254.py, the parts the ported statements
need: the two moduli and G1 (y^2 = x^3 + 3 over Fq, affine, None = the
point at infinity). Exact integer arithmetic, used only on the host to
build witnesses and check outputs, never on the device compute path. Fq2,
Fq12, G2 and the SVDW map are not ported yet.
"""

from __future__ import annotations

# BN254 base field modulus
P_BN = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# BN254 scalar field (group order of G1/G2)
R_BN = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def fq_inv(a: int) -> int:
    return pow(a % P_BN, P_BN - 2, P_BN)


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
