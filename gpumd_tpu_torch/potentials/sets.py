"""Parameter files and decks of the classical potentials, the ILP hybrids,
FCP and qNEP, as text, for the tests and chip_smoke.py.

Published sets: Tersoff-1989 Si and SiC (Phys. Rev. B 39, 5566 (1989),
Table I; chi 0.9776 for Si-C; potentials/tersoff.py's SI_TERSOFF is the
Si file) and Stillinger-Weber Si (Phys. Rev. B 31, 5262 (1985), as
examples/02_silicon_thermal/make_model.py writes it).  The other formats
take synthetic sets, bound in the diamond or fcc lattice the tests and
chip_smoke.py build: a two-type Tersoff-1988 table mixed from the Si and
C rows, a Si/C mini-Tersoff set, a Si/Ge-like two-type SW, Cu/Ag-like
rows in the Zhou 2004 form, eam/alloy and ADP setfl tables tabulated from
those rows' functions, and a Dai 2006 set.  The ILP hybrids, FCP and
qNEP take synthetic sets too (below): ILP rows of the published form,
a Tersoff-1988 C/B/N block, an SW Mo/S block, simple-cubic force
constants of orders 2-4, seeded random NEP and qNEP models.  None of the
synthetic sets models a real material.
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


# ---- the ILP hybrids, FCP and qNEP (synthetic sets) --------------------

# ILP rows of the published form (beta alpha delta epsilon C d sR reff C6
# S rcut_ilp rcut_global; epsilon, C and C6 in meV with S = 1), synthetic
# values of the size of the published graphene/hBN and TMD sets: C/B/N
# for a graphene or hBN bilayer, Mo/S for a MoS2 bilayer, Te/Pb for the
# PbTe slabs the nep_ilp decks stack
ILP_CC = (3.205843, 7.511126, 1.235334, 1.528e-2, 37.530428, 15.499947,
          0.7954443, 3.681440, 25714.535, 1.0, 2.0, 16.0)


def _ilp_rows(base, t: int, scale=0.02) -> list:
    """T^2 rows from one row: beta, alpha and C6 moved by a few percent a
    type pair (symmetric in the pair)."""
    rows = []
    for a in range(t):
        for b in range(t):
            f = 1.0 + scale * (a + b)
            r = list(base)
            r[0] *= f
            r[1] *= 1.0 + 0.5 * scale * (a + b)
            r[8] *= f
            rows.append(r)
    return rows


def ilp_text(header: str, symbols, group_methods, rows) -> str:
    """An ILP file: header, T symbols, the group method(s), T^2 rows."""
    lines = [f"{header} {len(symbols)} " + " ".join(symbols),
             " ".join(str(g) for g in group_methods)]
    lines += [" ".join(repr(float(x)) for x in r) for r in rows]
    return "\n".join(lines) + "\n"


ILP_CBN_ROWS = _ilp_rows(ILP_CC, 3)
# rcut_ilp (the normals' neighbours) is chosen so that no atom has more
# than three same-layer neighbours inside it: the normal takes the first
# three in list order (ROADMAP queue 3, item 23), so with more it jumps
# when a rebuild reorders them.  Graphene: the three bonds; MoS2: an S
# atom's three Mo (Mo centres none: normal z); the PbTe slabs none.
ILP_MOS_ROWS = [
    # Mo-Mo, Mo-S, S-Mo, S-S
    (5.579, 9.0, 2.0, 1.0, 0.3, 9.7, 0.4, 4.2, 40000.0, 1.0, 0.0, 16.0),
    (3.6, 8.5, 1.8, 2.0, 15.0, 20.0, 0.45, 3.6, 50000.0, 1.0, 0.0, 16.0),
    (3.6, 8.5, 1.8, 2.0, 15.0, 20.0, 0.45, 3.6, 50000.0, 1.0, 2.8, 16.0),
    (3.16, 8.09, 1.95, 4.6, 118.9, 58.5, 0.48, 3.1, 70000.0, 1.0, 0.0, 16.0),
]
ILP_PBTE_ROWS = _ilp_rows((3.6, 8.0, 1.9, 3.0, 20.0, 20.0, 0.5, 3.8,
                           60000.0, 1.0, 0.0, 12.0), 2)

# Tersoff-1988 C/B/N (T^3 = 27 entries of A B lambda mu beta n c d h r1 r2
# m alpha gamma): the C entry of the Lindsay-Broido form, the B and N
# entries moved by a few percent (synthetic)
_T88_C = (1393.6, 430.0, 3.4879, 2.2119, 1.5724e-7, 0.72751, 38049.0,
          4.3484, -0.930, 1.8, 2.1, 3.0, 0.0, 1.0)


def tersoff_1988_cbn() -> str:
    """The headerless 27 x 14 block of a tersoff_ilp C/B/N hybrid."""
    lines = []
    for i in range(3):
        for j in range(3):
            for k in range(3):
                v = list(_T88_C)
                f = 1.0 - 0.01 * (i + j)
                v[0] *= f
                v[1] *= f
                v[8] += 0.01 * k
                lines.append(" ".join(repr(float(x)) for x in v))
    return "\n".join(lines) + "\n"


# Stillinger-Weber Mo/S (the sw_ilp intralayer block, two types): rows
# [eps A, B, a, sigma, gamma] of Mo-Mo, Mo-S, S-S (n1 + n2), then
# [eps lambda, cos0] of the 8 triples (t1 t2 t3).  Only Mo-S bonds
# (minimum near 2.41 A) and the S-Mo-S and Mo-S-Mo angles of the 2H layer
# (cos0 0.1426, 81.8 degrees) carry weight; the others are short-ranged
# (synthetic)
SW_MOS = "\n".join(
    ["0.5 0.6 1.8 1.6 1.2",
     "6.0 0.6022245584 1.8 2.148 1.2",
     "0.5 0.6 1.8 1.6 1.2"]
    + [f"{15.0 if e in (3, 4) else 0.0} 0.1426" for e in range(8)]) + "\n"


def fcp_files(n_cells: int, a0: float = 3.0, k2: float = 1.0,
              k3: float = 0.2, k4: float = 0.5, order: int = 4,
              offset: float = 0.0) -> dict:
    """FCP input files of a simple cubic lattice of n_cells^3 atoms, {name:
    text} (r0.in, fcs_orderK.in and clusters_orderK.in, K = 2..order):
    order 2 the nearest-neighbour springs of tests/test_fcp.py (phi(i,i)
    = 6 k2 I, phi(i,j) = -k2 I for each ordered bond), order 3 a bond term
    phi_abc = k3 [a = b = c] on the clusters (i, j, j), order 4 an on-site
    quartic phi_abcd = k4 [a = b = c = d] on (i, i, i, i) (synthetic).
    The lattice sites sit at a0 (i, j, k) + offset."""
    nc = n_cells
    grid = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    n = len(grid)

    def idx(c):
        c = np.mod(c, nc)
        return (c[..., 0] * nc + c[..., 1]) * nc + c[..., 2]

    bonds = []
    for d in range(3):
        for s in (-1, 1):
            step = np.zeros(3, int)
            step[d] = s
            bonds.append(np.stack([np.arange(n), idx(grid + step)], -1))
    bonds = np.concatenate(bonds)

    def fcs(phis, k):
        lines = [str(len(phis))]
        for phi in phis:
            for ix in np.ndindex(*(3,) * k):
                lines.append(" ".join(map(str, ix)) + f" {float(phi[ix])!r}")
        return "\n".join(lines) + "\n"

    def clusters(rows):
        return "\n".join([str(len(rows))] + [" ".join(map(str, r))
                                             for r in rows]) + "\n"

    def diag(k, v):
        phi = np.zeros((3,) * k)
        for a in range(3):
            phi[(a,) * k] = v
        return phi

    out = {"r0.in": "\n".join(" ".join(repr(float(x)) for x in p)
                              for p in grid * a0 + offset) + "\n"}
    out["fcs_order2.in"] = fcs([diag(2, 6 * k2), diag(2, -k2)], 2)
    out["clusters_order2.in"] = clusters(
        [(i, i, 0) for i in range(n)] + [(i, j, 1) for i, j in bonds])
    if order >= 3:
        out["fcs_order3.in"] = fcs([diag(3, k3)], 3)
        out["clusters_order3.in"] = clusters([(i, j, j, 0)
                                              for i, j in bonds])
    if order >= 4:
        out["fcs_order4.in"] = fcs([diag(4, k4)], 4)
        out["clusters_order4.in"] = clusters([(i,) * 4 + (0,)
                                              for i in range(n)])
    return out


def random_nep(charge_mode: int, symbols=("Na", "Cl"), seed: int = 0,
               rc=(8.0, 4.0), widths=(6, 6, 6, 6, 4, 30),
               head_scale=(0.1, 0.3), zbl: bool = True):
    """(NepModel, flat parameters, q_scaler) of a nep4[_zbl][_chargeM]
    model (charge_mode 0: a plain NEP4), seeded random parameters at
    `widths` (n_max_r, n_max_a, basis_r, basis_a, l_max, neurons:
    artifacts/trainer_parity_r5_nep.txt's by default, its l_max 4 with
    q1111), the heads' weights scaled by `head_scale` (energy, charge);
    universal ZBL 1-2 A (synthetic)."""
    from gpumd_tpu_torch.elements import atomic_number
    from gpumd_tpu_torch.potentials.nep.params import NepModel, num_trainable

    nr, na, br, ba, lmax, neu = widths
    t = len(symbols)
    model = NepModel(
        version=4, model_type=0, num_types=t, symbols=tuple(symbols),
        atomic_numbers=tuple(atomic_number(s) for s in symbols),
        rc_radial=(rc[0],) * t, rc_angular=(rc[1],) * t, mn_radial=100,
        mn_angular=100, n_max_radial=nr, n_max_angular=na,
        basis_size_radial=br, basis_size_angular=ba, l_max=lmax,
        has_q=(1, 0, 0, 0, 0, 0), neurons=neu, zbl=zbl, zbl_rc_inner=1.0,
        zbl_rc_outer=2.0, charge_mode=charge_mode)
    rng = np.random.default_rng(seed)
    theta = rng.normal(0.0, 0.3, num_trainable(model))
    dim = model.dim
    per_type = (dim + (3 if charge_mode else 2)) * neu
    for ty in range(t):
        p = ty * per_type + neu * dim + neu
        theta[p:p + neu] *= head_scale[0]  # the energy head
        if charge_mode:
            theta[p + neu:p + 2 * neu] *= head_scale[1]  # the charge head
    if charge_mode:
        theta[t * per_type] = 1.2  # sqrt(epsilon_inf)
    return model, theta, rng.uniform(0.5, 2.0, dim)


def bilayer(kind: str, nx: int, ny: int, vacuum: float = 20.0,
            seed: int = 0, jitter: float = 0.0):
    """(positions, lattice (3x3, columns), symbols, layer labels) of a
    bilayer on an orthorhombic nx x ny cell grid, layers in xy and a
    vacuum gap along z (pbc z off by the caller):
      "graphene": AB bilayer graphene, a_cc 1.44 A (the Tersoff-1988
      C entry's bond), 3.35 A apart;
      "hbn_graphene": hBN (B/N) below graphene, 3.33 A apart;
      "mos2": AA' 2H-MoS2 bilayer, a 3.16 A, Mo planes 6.15 A apart;
      "pbte": two rocksalt PbTe (001) slabs two planes thick, a0 6.57 A
      (the trained model's), 3.6 A between them."""
    rng = np.random.default_rng(seed)
    if kind in ("graphene", "hbn_graphene"):
        a = 1.44 if kind == "graphene" else 1.42
        cell = np.array([[0, 0, 0], [a, 0, 0],
                         [1.5 * a, np.sqrt(3) / 2 * a, 0],
                         [2.5 * a, np.sqrt(3) / 2 * a, 0]])
        lx, ly, gap = 3 * a, np.sqrt(3) * a, 3.35
        species = [["C"] * 4, ["C"] * 4]
        if kind == "hbn_graphene":
            species[0], gap = ["B", "N", "B", "N"], 3.33
        shift = np.array([a, 0.0, gap])
        layers = [cell, cell + shift]
    elif kind == "mos2":
        a, h = 3.16, 1.585
        lx, ly, gap = a, np.sqrt(3) * a, 6.15
        mo = np.array([[0, 0, 0], [a / 2, ly / 2, 0]])
        s_xy = np.array([[a / 2, ly / 6, 0], [0, 2 * ly / 3, 0]])
        s = np.concatenate([s_xy + [0, 0, h], s_xy - [0, 0, h]])
        bottom = np.concatenate([mo, s])
        # AA': Mo above S and S above Mo
        top = np.concatenate([s_xy + [0, 0, gap],
                              mo + [0, 0, gap + h], mo + [0, 0, gap - h]])
        layers = [bottom, top]
        species = [["Mo"] * 2 + ["S"] * 4, ["Mo"] * 2 + ["S"] * 4]
    elif kind == "pbte":
        a0 = 6.57
        lx = ly = a0 / np.sqrt(2)  # the (001) surface cell of rocksalt
        half = a0 / 2
        sheet = np.array([[0, 0, 0], [lx / 2, ly / 2, 0]])
        slab = np.concatenate([sheet, sheet + [0, 0, half]])
        sp = ["Pb", "Te", "Te", "Pb"]
        gap = half + 3.6
        layers = [slab, slab + [0, 0, gap]]
        species = [sp, sp]
    else:
        raise ValueError(f"unknown bilayer {kind!r}")
    pos, sym, lab = [], [], []
    for layer, (xyz, names) in enumerate(zip(layers, species)):
        for i in range(nx):
            for j in range(ny):
                pos.append(xyz + np.array([i * lx, j * ly, 0.0]))
                sym += names
                lab += [layer] * len(names)
    pos = np.concatenate(pos)
    pos[:, 2] += vacuum / 2 - pos[:, 2].min()
    pos = pos + rng.normal(0.0, jitter, pos.shape)
    height = float(np.ptp(pos[:, 2])) + vacuum
    return pos, np.diag([nx * lx, ny * ly, height]), sym, np.asarray(lab)


# ---- the decks of the ILP hybrids, FCP, D3 and qNEP ---------------------

# {deck: (small size, big size)}: bilayer cell counts (nx, ny), cubic
# cells a side; small decks 216-392 atoms, big ones 4,032-4,608
OTHER_DECKS = {
    "tersoff_ilp": ((8, 5), (30, 18)),  # 320 / 4,320 C
    "sw_ilp": ((6, 4), (24, 14)),  # 288 / 4,032 MoS2
    "nep_ilp": ((7, 7), (24, 24)),  # 392 / 4,608 PbTe
    "nep_ilp_two": ((7, 7), (24, 24)),
    "fcp": (6, 16),  # 216 / 4,096, order 4
    "dftd3": (3, 8),  # 216 / 4,096 PbTe, pbe 12 6
    "qnep_ewald": (3, 8),  # 216 / 4,096 NaCl, charge_mode 1
    "qnep_pppm": (3, 8),
    "qnep2": (3, 8),  # charge_mode 2 (PPPM)
}


def model_xyz(d, symbols, pos, lattice, temperature, seed, pbc,
              groups=None):
    """model.xyz with Maxwell velocities at `temperature` (no net
    momentum) and the layers as grouping method 0."""
    from gpumd_tpu_torch.elements import mass_of
    from gpumd_tpu_torch.io.xyz import XYZFrame, write_xyz
    from gpumd_tpu_torch.units import K_B, TIME_UNIT_CONVERSION

    mass = np.array([mass_of(s) for s in symbols])
    rng = np.random.default_rng(seed)
    v = rng.normal(size=pos.shape) * np.sqrt(K_B * temperature
                                             / mass)[:, None]
    v -= (mass[:, None] * v).sum(0) / mass.sum()
    write_xyz(str(d / "model.xyz"), XYZFrame(
        symbols=list(symbols), positions=pos, lattice=np.asarray(lattice),
        pbc=pbc, velocities=v / TIME_UNIT_CONVERSION,
        groups=None if groups is None else np.asarray(groups)[:, None]),
        with_velocities=True, with_groups=groups is not None)


def rocksalt(nc: int, a0: float, species=("Pb", "Te")):
    """(positions, symbols, box lengths) of nc^3 rocksalt cells."""
    fcc = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    basis = np.concatenate([fcc, fcc + [.5, 0, 0]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    pos = ((cells[:, None] + basis[None]) * a0).reshape(-1, 3)
    sym = [species[0]] * 4 + [species[1]] * 4
    return pos, sym * len(cells), np.full(3, nc * a0)


def other_deck(d, name: str, big: bool = False, nep_path: str = "",
               temperature: float = 300.0, seed: int = 7,
               jitter: float = 0.01) -> str:
    """Write deck `name` of OTHER_DECKS into the directory d (model.xyz
    with velocities at `temperature`, the potential files) and return its
    run.in head: the `potential` line (and `dftd3` / `kspace`).
    `nep_path`: the trained PbTe NEP (nep_ilp, dftd3)."""
    import pathlib
    import shutil

    d = pathlib.Path(d)
    d.mkdir(parents=True, exist_ok=True)
    size = OTHER_DECKS[name][1 if big else 0]
    rng = np.random.default_rng(seed)
    if name in ("tersoff_ilp", "sw_ilp", "nep_ilp", "nep_ilp_two"):
        kind = {"tersoff_ilp": "graphene", "sw_ilp": "mos2"}.get(name,
                                                                  "pbte")
        pos, lat, sym, lab = bilayer(kind, *size, seed=seed, jitter=jitter)
        model_xyz(d, sym, pos, lat.T, temperature, seed,
                  (True, True, False), groups=lab)
        if name == "tersoff_ilp":
            (d / "ilp.txt").write_text(ilp_text(
                "tersoff_ilp", ["C", "B", "N"], [0], ILP_CBN_ROWS))
            (d / "intra.txt").write_text(tersoff_1988_cbn())
        elif name == "sw_ilp":
            (d / "ilp.txt").write_text(ilp_text(
                "sw_ilp", ["Mo", "S"], [0], ILP_MOS_ROWS))
            (d / "intra.txt").write_text(SW_MOS)
        else:
            (d / "ilp.txt").write_text(ilp_text(
                "nep_ilp", ["Pb", "Te"], [0, 0], ILP_PBTE_ROWS))
            shutil.copy(nep_path, d / "nep_a.txt")
            if name == "nep_ilp":
                (d / "intra.txt").write_text("0 1 nep_a.txt\n")
            else:  # a NEP a layer: group 0 the first, group 1 the second
                shutil.copy(nep_path, d / "nep_b.txt")
                (d / "intra.txt").write_text(
                    "0 2 nep_a.txt nep_b.txt 2 0 1\n")
        return "potential ilp.txt intra.txt\n"
    if name == "fcp":
        files = fcp_files(size)
        (d / "fcs").mkdir(exist_ok=True)
        for fname, text in files.items():
            (d / "fcs" / fname).write_text(text)
        r0 = np.loadtxt(d / "fcs" / "r0.in")
        pos = r0 + rng.normal(0.0, jitter, r0.shape)
        model_xyz(d, ["Ar"] * len(pos), pos, np.eye(3) * size * 3.0,
                  temperature, seed, (True, True, True))
        (d / "fcp.txt").write_text("fcp 1 Ar\n4 2 fcs\n")
        return "potential fcp.txt\n"
    if name == "dftd3":
        pos, sym, lengths = rocksalt(size, 6.57)
        pos = pos + rng.normal(0.0, jitter, pos.shape)
        model_xyz(d, sym, pos, np.diag(lengths), temperature, seed,
                  (True, True, True))
        shutil.copy(nep_path, d / "nep.txt")
        return "potential nep.txt\ndftd3 pbe 12 6\n"
    mode = 2 if name == "qnep2" else 1
    pos, sym, lengths = rocksalt(size, 5.64, ("Na", "Cl"))
    pos = pos + rng.normal(0.0, jitter, pos.shape)
    # one group of every atom (add_efield's)
    model_xyz(d, sym, pos, np.diag(lengths), temperature, seed,
              (True, True, True), groups=np.zeros(len(pos), int))
    from gpumd_tpu_torch.potentials.nep.params import write_nep_txt

    model, theta, q_scaler = random_nep(mode)
    write_nep_txt(str(d / "qnep.txt"), model, theta, q_scaler)
    method = "ewald" if name == "qnep_ewald" else "pppm"
    return f"potential qnep.txt\nkspace {method}\n"
