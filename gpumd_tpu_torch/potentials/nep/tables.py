"""NEP angular-descriptor constant tables, derived from first principles.

The NEP angular descriptor (Fan et al., J. Chem. Phys. 157, 114801 (2022))
uses real solid harmonics assembled from associated-Legendre polynomial
parts and powers of (x + iy).  For each degree L and order m the pair
contribution is

    s_{L,m}  +=  g_n(r) * Q_{L,m}(z) * Re/Im[(x + iy)^m]

with (x, y, z) the unit bond vector, and the rotation invariant is

    q_{nL} = C_{L,0} s_{L,0}^2 + 2 * sum_{m>0} C_{L,m} (s_re^2 + s_im^2).

Q_{L,m} is the m-th derivative of the Legendre polynomial P_L, rescaled to
the smallest integer-coefficient polynomial; the normalization constants
then follow from |Y_{Lm}|^2 algebra:

    C_{L,m} = (2L+1)/(4 pi) * (L-m)!/(L+m)! * (g_{L,m} / kappa_L)^2

where kappa_L clears the denominators of P_L and g_{L,m} is the gcd pulled
out of the m-th derivative.  This file computes all tables exactly with
Fraction arithmetic (the reference hard-codes the equivalent float tables
in src/utilities/nep_utilities.cuh:19-160; a unit test checks we reproduce
them).

The 4-/5-body invariant coefficients (C4B, C5B, ...) are the published
contraction constants from the NEP3/NEP4 papers (Fan 2022 JCP; Song et al.
2024) — physics data, listed verbatim with citations.
"""

from __future__ import annotations

import math
from fractions import Fraction
from functools import reduce

import numpy as np

L_MAX_SUPPORTED = 8
# Total s components for L = 1..8: sum (2L+1) = 80  (NUM_OF_ABC).
NUM_ABC = sum(2 * L + 1 for L in range(1, L_MAX_SUPPORTED + 1))


def _legendre_coeffs(l: int) -> list:
    """Coefficients [c0, c1, ...] of P_l(z) as Fractions (ascending powers)."""
    p0 = [Fraction(1)]
    if l == 0:
        return p0
    p1 = [Fraction(0), Fraction(1)]
    if l == 1:
        return p1
    for n in range(2, l + 1):
        # n P_n = (2n-1) z P_{n-1} - (n-1) P_{n-2}
        zp = [Fraction(0)] + p1
        new = [Fraction(0)] * (n + 1)
        for k, c in enumerate(zp):
            new[k] += Fraction(2 * n - 1, n) * c
        for k, c in enumerate(p0):
            new[k] -= Fraction(n - 1, n) * c
        p0, p1 = p1, new
    return p1


def _derivative(coeffs: list) -> list:
    return [coeffs[k] * k for k in range(1, len(coeffs))] or [Fraction(0)]


def _build_tables():
    """Returns (z_poly, c3b) where
    z_poly[L][m] = integer-coefficient polynomial in z (ascending, len L+1)
    c3b[L][m]    = normalization constant (float)
    for L in 1..8, m in 0..L.
    """
    z_poly = {}
    c3b = {}
    for L in range(1, L_MAX_SUPPORTED + 1):
        pl = _legendre_coeffs(L)
        kappa = reduce(lambda a, b: a * b // math.gcd(a, b),
                       [c.denominator for c in pl], 1)  # lcm of denominators
        z_poly[L] = {}
        c3b[L] = {}
        d = [c * kappa for c in pl]  # P_hat = kappa * P_L, integer coeffs
        for m in range(0, L + 1):
            if m > 0:
                d = _derivative(d)
            ints = [int(c) for c in d]
            g = reduce(math.gcd, [abs(c) for c in ints if c != 0], 0) or 1
            poly = [c // g for c in ints]
            poly += [0] * (L + 1 - len(poly))
            z_poly[L][m] = poly
            norm = (
                (2 * L + 1)
                / (4 * math.pi)
                * math.factorial(L - m)
                / math.factorial(L + m)
                * (g / kappa) ** 2
            )
            c3b[L][m] = norm
    return z_poly, c3b


_Z_POLY, _C3B_LM = _build_tables()


def z_coefficient_table(L: int) -> np.ndarray:
    """(L+1, L+1) float array: row m = ascending z-coefficients of Q_{L,m}.
    Reproduces the reference's Z_COEFFICIENT_<L> tables."""
    return np.array([_Z_POLY[L][m] for m in range(L + 1)], dtype=np.float64)


def c3b_flat(l_max: int = L_MAX_SUPPORTED) -> np.ndarray:
    """Flat (sum 2L+1,) array of per-component constants in the reference's
    s-component order: for each L, [m=0, m=1 re, m=1 im, m=2 re, ...].
    Matches nep_utilities.cuh C3B for l_max = 8."""
    out = []
    for L in range(1, l_max + 1):
        out.append(_C3B_LM[L][0])
        for m in range(1, L + 1):
            out += [_C3B_LM[L][m]] * 2
    return np.array(out, dtype=np.float64)


def component_index(L: int) -> int:
    """Start index of degree L's components in the flat s array (L*L - 1)."""
    return L * L - 1


# ---------------------------------------------------------------------------
# 4-/5-body invariant contraction coefficients.
# Published constants from the NEP papers (Fan et al., JCP 157, 114801
# (2022), Eq. for q^{(4)} / q^{(5)}; extended invariants from GPUMD 4.0,
# Xu et al. 2025).  Reference: src/utilities/nep_utilities.cuh:51-97.
# ---------------------------------------------------------------------------

# q_222: cubic invariant of the L=2 components s[3..7].
C4B = np.array(
    [
        -0.007499480826664,
        -0.134990654879954,
        0.067495327439977,
        0.404971964639861,
        -0.809943929279723,
    ]
)

# q_1111: quartic invariant of the L=1 components s[0..2].
C5B = np.array([0.026596810706114, 0.053193621412227, 0.026596810706114])

# Extended 4-body invariants (GPUMD adds q_112, q_123, q_233, q_134).
C4B2 = np.array(
    [
        0.027493550848847,
        0.164961305093080,
        -0.013746775424423,
        0.041240326273270,
        0.082480652546540,
    ]
)

C4B_123 = np.array(
    [
        -0.008418146349617,
        -0.016836292699234,
        -0.033672585398469,
        -0.042090731748086,
        -0.067345170796937,
        -0.084181463496172,
        -0.168362926992344,
    ]
)

C4B_233 = np.array(
    [
        0.008572620635186,
        0.009644198214584,
        0.019288396429168,
        0.025717861905558,
        0.026789439484956,
        0.032147327381947,
        0.038576792858337,
        0.128589309527790,
        0.192883964291685,
        0.321473273819474,
    ]
)

C4B_134 = np.array(
    [
        0.003645164295772,
        0.004860219061029,
        0.006075273826286,
        0.018225821478859,
        0.024301095305146,
        0.036451642957719,
        0.042526916784005,
        0.072903285915437,
        0.085053833568010,
        0.255161500704030,
    ]
)
