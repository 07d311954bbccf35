"""Parameter files of the classical potentials, as text, for the tests and
chip_smoke.py.

Published sets: Tersoff-1989 Si and SiC (Phys. Rev. B 39, 5566 (1989),
Table I; chi 0.9776 for Si-C; potentials/tersoff.py's SI_TERSOFF is the
Si file) and Stillinger-Weber Si (Phys. Rev. B 31, 5262 (1985), as
examples/02_silicon_thermal/make_model.py writes it).  The other formats
take synthetic sets, bound in the diamond or fcc lattice the tests and
chip_smoke.py build: a two-type Tersoff-1988 table mixed from the Si and
C rows, a Si/C mini-Tersoff set, a Si/Ge-like two-type SW, Cu/Ag-like
rows in the Zhou 2004 form, eam/alloy and ADP setfl tables tabulated from
those rows' functions, and a Dai 2006 set.  None of the synthetic sets
models a real material.
"""

from __future__ import annotations

import numpy as np
import torch

SI_ROW = ("1830.8 471.18 2.4799 1.7322 1.1e-6 0.78734 1.0039e5 16.217 "
          "-0.59825 2.7 3.0")
C_ROW = ("1393.6 346.74 3.4879 2.2119 1.5724e-7 0.72751 38049 4.3484 "
         "-0.57058 1.8 2.1")
TERSOFF_SIC = f"tersoff_1989 2 Si C\n{SI_ROW}\n{C_ROW}\n0.9776\n"
SW_SI = ("sw_1985 1 Si\n2.1683 21.0 7.049556277 0.6022245584 "
         "1.80 1.20 2.0951 -0.333333333333\n")

# mini-Tersoff pair classes (t1 + t2 = 0, 1, 2): D0 alpha r0 S beta n h r1 r2
TERSOFF_MINI = ("tersoff_mini 2 Si C\n"
                "2.66 1.4 2.35 1.6 0.33 0.91 -0.42 2.7 3.0\n"
                "4.2 1.6 1.9 1.5 0.5 0.85 -0.5 2.3 2.6\n"
                "6.0 1.9 1.54 1.4 0.7 0.8 -0.55 1.8 2.1\n")

# two-type SW: rows [eps A, B, a, sigma, gamma] of n1 + n2 = 0, 1, 2, then
# [eps lambda, cos0] of the 8 triples
SW_TWO = "sw_1985 2 Si Ge\n" + "\n".join(
    ["15.2855 0.6022245584 1.8 2.0951 1.2",
     "14.5 0.6022245584 1.8 2.135 1.2",
     "13.6 0.6022245584 1.8 2.181 1.2"]
    + [f"{45.5343 - 1.5 * e} -0.333333333333" for e in range(8)]) + "\n"

# Cu/Ag-like rows in the Zhou 2004 form (21 values a type, rc 6 A)
ZHOU_ROWS = (
    "2.556162 1.554485 21.175871 21.175395 8.127620 4.334731 0.396620 "
    "0.548085 0.308782 0.756515 -2.170269 -0.263788 1.088878 -0.817603 "
    "-2.19 0.0 0.561830 -2.100595 0.310490 -2.186568 6.0",
    "2.891814 1.106232 14.604100 14.604144 9.132010 4.870405 0.277758 "
    "0.419611 0.339710 0.750758 -1.729364 -0.255882 0.912050 -0.561432 "
    "-1.75 0.0 0.744561 -1.150650 0.783924 -1.748423 6.0")
EAM_ZHOU = "eam_zhou_2004 2 Cu Ag\n" + "\n".join(ZHOU_ROWS) + "\n"
# A d c c0 c1 c2 c3 c4 B: fcc bound at a0 3.8 A (-5.04 eV/atom)
EAM_DAI = "eam_dai_2006 1 Fe\n1.0 3.6 3.4 12.0 -6.0 0.5 0.0 0.0 0.5\n"

# the setfl tables' grid
NRHO, DRHO, NR, DR, RC_TAB = 600, 0.1, 600, 0.01, 5.99


def tersoff_1988_sic() -> str:
    """A two-type Tersoff-1988 table (T^3 = 8 entries of 14 values): the
    Si/C pair terms mixed as Tersoff-1989 mixes them, the centre's
    angular terms, r1/r2 of the (i, k) pair, and every form of the
    e-factor: alpha 0 (e = 1), m = 1 and m = 3."""
    rows = [[float(x) for x in r.split()] for r in (SI_ROW, C_ROW)]
    lines = ["tersoff_1988 2 Si C"]
    for i in range(2):
        for j in range(2):
            for k in range(2):
                ri, rj, rk = rows[i], rows[j], rows[k]
                e = 4 * i + 2 * j + k
                m, alpha = ((3.0, 0.0), (1.0, 0.7), (3.0, 1.3))[e % 3]
                vals = [np.sqrt(ri[0] * rj[0]),
                        np.sqrt(ri[1] * rj[1]) * (0.9776 if i != j else 1.0),
                        0.5 * (ri[2] + rj[2]), 0.5 * (ri[3] + rj[3]),
                        *ri[4:9], np.sqrt(ri[9] * rk[9]),
                        np.sqrt(ri[10] * rk[10]), m, alpha, 1.0 + 0.05 * k]
                lines.append(" ".join(repr(float(v)) for v in vals))
    return "\n".join(lines) + "\n"


def _row(values) -> str:
    return " ".join(repr(float(x)) for x in values)


def setfl(adp: bool = False) -> str:
    """A two-element (Cu, Ag) setfl file tabulated from the Zhou rows'
    own functions: F(rho), rho(r) = f(r) and r*phi(r) (the cross pair the
    mean of the two), tapered to zero over the last 1 A before RC_TAB;
    with `adp` also small smooth u and w pair tables, and the `adp`
    header with a `comment 2` block; else eam/alloy's three comment
    lines."""
    from gpumd_tpu_torch.potentials.eam import EAMZhou2004

    vals = np.array([[float(x) for x in r.split()] for r in ZHOU_ROWS])

    def ten(x):
        return torch.as_tensor(x, dtype=torch.float64)

    cols = ("re", "fe", "rho_e", "rho_s", "alpha", "beta", "a", "b",
            "kappa", "lam")
    zhou = EAMZhou2004(**{k: ten(vals[:, i]) for i, k in enumerate(cols)},
                       fn=ten(vals[:, 10:14]), f03=ten(vals[:, 14:18]),
                       eta=ten(vals[:, 18]), fe_emb=ten(vals[:, 19]),
                       rc_t=ten(vals[:, 20]), rc=6.0)
    dt = torch.float64
    r = np.arange(NR) * DR
    rr = ten(np.maximum(r, 0.5))
    taper = np.clip(RC_TAB - r, 0.0, 1.0) ** 3
    lines = (["adp 2 Cu Ag", "comment 2", "synthetic ADP tables"] if adp
             else ["eam/alloy synthetic Cu Ag tables", "comment 2",
                   "comment 3"])
    lines += ["2 Cu Ag", f"{NRHO} {DRHO} {NR} {DR} {RC_TAB}"]
    for e, (z, m) in enumerate(((29, 63.546), (47, 107.8682))):
        lines.append(f"{z} {m} 3.615 fcc")
        t = torch.full((NRHO,), e, dtype=torch.long)
        lines.append(_row(zhou._embed(t, ten(np.arange(NRHO) * DRHO), dt)))
        t = torch.full((NR,), e, dtype=torch.long)
        lines.append(_row(zhou._f_single(t, rr, dt).numpy() * taper))
    phi = [zhou._phi_single(torch.full((NR,), e, dtype=torch.long), rr,
                            dt).numpy() for e in range(2)]
    for a in range(2):
        for b in range(a + 1):
            lines.append(_row(r * 0.5 * (phi[a] + phi[b]) * taper))
    if adp:
        for scale in (0.02, -0.01):  # u, then w
            for a in range(2):
                for b in range(a + 1):
                    lines.append(_row(scale * (1 + 0.3 * (a + b))
                                      * np.exp(-r) * taper))
    return "\n".join(lines) + "\n"


def files() -> dict:
    """{header: (file name, text)} of one file a format (two types where
    the format has them; sw_1985 the published Si)."""
    from gpumd_tpu_torch.potentials.tersoff import SI_TERSOFF

    return {"tersoff_1989": ("si_tersoff.txt", SI_TERSOFF),
            "tersoff_1988": ("sic_1988.txt", tersoff_1988_sic()),
            "tersoff_mini": ("sic_mini.txt", TERSOFF_MINI),
            "sw_1985": ("si_sw.txt", SW_SI),
            "eam_zhou_2004": ("cuag_zhou.txt", EAM_ZHOU),
            "eam/alloy": ("cuag_alloy.txt", setfl()),
            "adp": ("cuag_adp.txt", setfl(adp=True)),
            "eam_dai_2006": ("fe_dai.txt", EAM_DAI)}
