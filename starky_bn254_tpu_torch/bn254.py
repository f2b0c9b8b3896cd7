"""Host-side BN254 arithmetic oracle (pure Python ints).

A host copy of the JAX package's bn254.py, the parts the ported statements
need: the two moduli, G1 (y^2 = x^3 + 3 over Fq), Fq2 = Fq[u]/(u^2 + 1)
and G2 (y^2 = x^3 + 3/XI over Fq2, XI = 9 + u); points are affine, None is
the point at infinity. Exact integer arithmetic, used only on the host to
build witnesses and check outputs, never on the device compute path. Fq12
and the SVDW map are not ported yet.
"""

from __future__ import annotations

# BN254 base field modulus
P_BN = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# BN254 scalar field (group order of G1/G2)
R_BN = 21888242871839275222246405745257275088548364400416034343698204186575808495617


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
