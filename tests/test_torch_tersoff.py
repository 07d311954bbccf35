"""The port's Tersoff slice vs the JAX package, f64 on the CPU.

Both packages read the Si and SiC Tersoff-1989 parameters (Phys. Rev. B
39, 5566 (1989), Table I; chi = 0.9776 for Si-C) from the same text.  The
hand-derived two-pass gradient of the port's plain kernel is held against
jax.value_and_grad of the TPU kernel's own tile energy
(`_tersoff_energy_tiles`, pure jnp) and against torch.autograd; the force
pass and short MD runs under NVE, NVT-Berendsen and NVT-NHC are held
against the JAX list path (`ForceField`, `md_run`), which the JAX package
golden-tests.  The fused kernel's plain version (the tersoff kernel's plain
version, then the scatter's) is held against the Pallas tersoff kernel and
scatter in interpret mode on a plan cut to mn 8 (~5 s a call; at the
engine's mn 32 a call takes ~30 s), under a pinned JAX state (x64 on,
matmul precision "highest", restored on exit).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.engine import grid as JG
from gpumd_tpu.engine import nep_compact as JC
from gpumd_tpu.engine import tersoff_compact as JT
from gpumd_tpu.engine.grid import plan_grid as jplan_grid
from gpumd_tpu.engine.nep_compact import make_compact_plan as jmake_plan
from gpumd_tpu.forcefield import ForceField
from gpumd_tpu.integrate.ensembles.nve import NVE as JNVE
from gpumd_tpu.integrate.ensembles.nvt import NVTBerendsen as JBer
from gpumd_tpu.integrate.ensembles.nvt import NVTNoseHooverChain as JNHC
from gpumd_tpu.integrate.run import md_run
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.potentials.tersoff import Tersoff1989 as JTersoff
from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.engine import grid as TG
from gpumd_tpu_torch.engine import nep_compact as TC
from gpumd_tpu_torch.engine import tersoff_compact as TT
from gpumd_tpu_torch.integrate.ensembles.nve import NVE
from gpumd_tpu_torch.integrate.ensembles.nvt import (
    NVTBerendsen,
    NVTNoseHooverChain,
)
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.potentials.tersoff import Tersoff1989
from gpumd_tpu_torch.units import K_B, TIME_UNIT_CONVERSION
from torch_first_trig import warm_torch_transcendentals  # noqa: F401


SI = """tersoff_1989 1 Si
1830.8 471.18 2.4799 1.7322 1.1e-6 0.78734 1.0039e5 16.217 -0.59825 2.7 3.0
"""
SIC = """tersoff_1989 2 Si C
1830.8 471.18 2.4799 1.7322 1.1e-6 0.78734 1.0039e5 16.217 -0.59825 2.7 3.0
1393.6 346.74 3.4879 2.2119 1.5724e-7 0.72751 38049 4.3484 -0.57058 1.8 2.1
0.9776
"""
MASS = (28.085, 12.011)
FIELDS = ("a", "b", "lam", "mu", "r1", "r2", "beta", "n", "c2", "d2", "h")


@pytest.fixture(scope="module")
def pots(tmp_path_factory):
    """name -> (port potential, JAX potential), read from the same file."""
    d = tmp_path_factory.mktemp("tersoff")
    out = {}
    for name, text in (("Si", SI), ("SiC", SIC)):
        path = d / f"{name}.txt"
        path.write_text(text)
        out[name] = (Tersoff1989.from_file(str(path), device="cpu"),
                     JTersoff.from_file(str(path)))
    return out


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _diamond(nc, a0=5.431, jitter=0.1, seed=0, c_frac=0.0):
    """Diamond lattice of nc^3 cubic cells, jittered; c_frac of the sites
    become type 1 (C)."""
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5],
                     [.25, .25, .25], [.75, .75, .25], [.75, .25, .75],
                     [.25, .75, .75]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    pos = ((cells[:, None, :] + base[None]) * a0).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    pos = pos + rng.uniform(-jitter, jitter, pos.shape)
    types = (rng.uniform(size=len(pos)) < c_frac).astype(int)
    return pos, types, np.full(3, nc * a0)


@pytest.mark.parametrize("name", ["Si", "SiC"])
def test_params_match_jax(pots, name):
    mine, ref = pots[name]
    assert mine.num_types == ref.num_types
    assert mine.rc == ref.rc
    for k in FIELDS:
        np.testing.assert_array_equal(_np(getattr(mine, k)),
                                      np.asarray(getattr(ref, k)))
    assert TT.TersoffSpec.from_potential(mine)._asdict() == \
        JT.TersoffSpec.from_potential(ref)._asdict()


@pytest.mark.parametrize("name", ["Si", "SiC"])
def test_kernel_consts_are_built_once_a_spec(pots, name):
    spec = TT.TersoffSpec.from_potential(pots[name][0])
    consts = TT.kernel_consts(spec)
    again = TT.kernel_consts(TT.TersoffSpec.from_potential(pots[name][0]))
    assert again is consts and len(consts) == 34
    assert list(consts) == list(spec.kernel_consts())


def _tiles(num_types, mn=16, lanes=48, seed=7):
    """Random (mn, A) bond tiles: distances across R1..R2 of every type
    pair and beyond, empty slots (far, type -1), the centre's own slot, a
    parked centre lane (type -1), a centre with one live neighbour (zeta =
    0) and one with none."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(3, mn, lanes))
    v /= np.linalg.norm(v, axis=0)
    r = v * rng.uniform(1.5, 3.3, size=(mn, lanes))
    tj = rng.integers(0, num_types, size=(mn, lanes)).astype(float)
    empty = rng.uniform(size=(mn, lanes)) < 0.3
    r[:, empty] = 1.0e5
    tj[empty] = -1.0
    ct = rng.integers(0, num_types, size=(1, lanes)).astype(float)
    ct[0, 0] = -1.0  # parked centre lane
    r[:, 1, 1:], tj[1:, 1] = 1.0e5, -1.0  # lane 1: one neighbour
    r[:, 0, 1] = [2.4, 0.0, 0.0]
    tj[0, 1] = ct[0, 1]
    r[:, :, 2], tj[:, 2] = 1.0e5, -1.0  # lane 2: no neighbour
    r[:, 3, 3], tj[3, 3] = 0.0, ct[0, 3]  # lane 3: its own slot
    return r, tj, ct


@pytest.mark.parametrize("name", ["Si", "SiC"])
def test_tile_gradient_matches_value_and_grad(pots, name):
    """The plain kernel's hand-derived p_ij against jax.value_and_grad of
    the TPU kernel's tile energy, and against torch.autograd of the port's
    tile energy, at 1e-10."""
    mine, ref = pots[name]
    r, tj, ct = _tiles(mine.num_types)
    jspec = JT.TersoffSpec.from_potential(ref)
    mn = r.shape[1]

    def loss(dx, dy, dz):
        e = JT._tersoff_energy_tiles(dx, dy, dz, jnp.asarray(tj),
                                     jnp.asarray(ct), jspec, mn)
        return jnp.sum(e), e

    (_, e_ref), p_ref = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(*map(jnp.asarray, r))
    spec = TT.TersoffSpec.from_potential(mine)
    rt = [torch.tensor(x, requires_grad=True) for x in r]
    tjt, ctt = torch.tensor(tj), torch.tensor(ct)
    e, p = TT.tersoff_tiles_plain(*[x.detach() for x in rt], tjt, ctt, spec)
    e_auto = TT.tersoff_energy_tiles(*rt, tjt, ctt, spec)
    p_auto = torch.autograd.grad(e_auto.sum(), rt)
    assert np.isfinite(np.asarray(e_ref)).all()
    # the special lanes: parked and empty centres have E = 0, p = 0; the
    # single-neighbour centre has zeta = 0, b = 1
    assert float(e[0, 0]) == 0.0 and float(e[0, 2]) == 0.0
    assert float(e[0, 1]) != 0.0
    for got in (e, e_auto):
        np.testing.assert_allclose(_np(got), np.asarray(e_ref), rtol=1e-10,
                                   atol=1e-12)
    for q in range(3):
        assert float(p[q][:, 0].abs().max()) == 0.0
        for got in (p[q], p_auto[q]):
            np.testing.assert_allclose(_np(got), np.asarray(p_ref[q]),
                                       rtol=1e-10, atol=1e-12)


def _cplan_pair(mine, ref, pos, box, jbox, n, skin=0.5):
    """The engine's plan in both packages: plan_grid, make_compact_plan
    with CompactTersoffMD's margins and full windows, mn_a = mn_r."""
    kw = dict(rc_angular=mine.rc, slack_mul=1.2, slack_add=4, rnd=8)
    plan = TG.plan_grid(box, mine.rc, skin, n, position=pos)
    cp = TC.make_compact_plan(plan, position=pos, box=box,
                              compact_lists=False, **kw)
    jplan = jplan_grid(jbox, ref.rc, skin, n, position=pos)
    jcp = jmake_plan(jplan, position=pos, box=jbox, **kw)
    return cp._replace(mn_a=cp.mn_r), jcp._replace(mn_a=jcp.mn_r)


def _plan_key(cp):
    return (cp.base.grid, cp.base.cap, cp.bx, cp.mn_r, cp.mn_a, cp.wl, cp.cl)


@pytest.fixture(scope="module", params=["Si", "SiC"])
def force_pass(request, pots):
    """Both virial modes of compact_tersoff_compute against the list path,
    on 216 jittered Si atoms, or the same lattice with 30% of its sites C,
    on the engine's plan and on the same grid at cap 128 (one cell a block,
    wl 3,456), where the fused kernel's accumulator fits in shared memory
    at pch 4 but not at pch 12; with the wrappers each pass called."""
    name = request.param
    mine, ref = pots[name]
    pos, types, lengths = _diamond(3, c_frac=0.3 if name == "SiC" else 0.0,
                                   seed=2)
    n = len(pos)
    jbox = JBox.orthogonal(lengths)
    mass = np.asarray(MASS)[types]
    ff = ForceField.create([ref], jbox, n, mn=64)
    st = ff.compute(jmake_state(pos, mass, types, jbox))

    box = Box.orthogonal(lengths, device="cpu")
    pos_w = box.wrap(torch.as_tensor(pos))
    cp, jcp = _cplan_pair(mine, ref, _np(pos_w), box, jbox, n)
    assert _plan_key(cp) == _plan_key(jcp)
    wide = cp._replace(base=dataclasses.replace(cp.base, cap=128), bx=1)
    assert wide.wl == 3456
    spec = TT.TersoffSpec.from_potential(mine)
    calls = []
    outs, routes = {}, {}
    before = dict(cuda_build.launches)
    with pytest.MonkeyPatch.context() as mp:
        for fn in ("tersoff_scatter_call", "tersoff_kernel_call"):
            mp.setattr(TT, fn, lambda *a, _f=getattr(TT, fn), _n=fn:
                       calls.append(_n) or _f(*a))
        for plan, c in (("engine", cp), ("cap128", wide)):
            perm, smask, ov = TG.bin_dense(
                pos_w, box, torch.ones(n, dtype=torch.float64), c.base)
            assert not bool(ov)
            pos_s = TG.apply_perm(pos_w, perm, fill=1e5)
            typ_s = TG.apply_perm(torch.as_tensor(types, dtype=torch.int32),
                                  perm, 0)
            garr = TG.pack_ghost(pos_s, typ_s, smask, box, c.base)
            idx, ok = TC.build_indices(
                TC.block_centers(garr, c),
                TG.pack_block_windows(garr, c.base, c.bx, c.wl), c, mine.rc)
            assert bool(ok)
            inv = np.full(n, -1)
            pa = _np(perm)
            inv[pa[pa < n]] = np.nonzero(pa < n)[0]
            for pav in (False, True):
                calls.clear()
                out = TT.compact_tersoff_compute(
                    pos_s, typ_s, smask, box, c, idx, spec,
                    per_atom_virial=pav)
                outs[pav, plan] = (out, inv)
                routes[pav, plan] = (tuple(calls), TT.fused_fits(c, pav))
    assert cuda_build.launches == before  # no kernel launched on the CPU
    return st, outs, routes


@contextlib.contextmanager
def jax_oracle_state():
    """x64 on and full-precision matmuls for the JAX reference, whatever
    the process-wide settings (gpumd_tpu/app/nep.py sets "high" for the
    whole process); both restored on exit."""
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module", params=["Si", "SiC"])
def pallas_pair(request, pots):
    """The Pallas tersoff kernel (interpret mode) and the Pallas scatter on
    its pvals, both virial modes, on the force_pass system with the plan cut
    to mn 8 (~4 bonds a centre: every slot past them is empty), with the
    port's inputs made from the same numpy arrays."""
    name = request.param
    mine, ref = pots[name]
    pos, types, lengths = _diamond(3, c_frac=0.3 if name == "SiC" else 0.0,
                                   seed=2)
    n = len(pos)
    jbox = JBox.orthogonal(lengths)
    box = Box.orthogonal(lengths, device="cpu")
    pos = _np(box.wrap(torch.as_tensor(pos)))
    cp, jcp = _cplan_pair(mine, ref, pos, box, jbox, n)
    cp, jcp = cp._replace(mn_r=8, mn_a=8), jcp._replace(mn_r=8, mn_a=8)
    jspec = JT.TersoffSpec.from_potential(ref)
    with jax_oracle_state():
        @jax.jit
        def setup(p, t):
            perm, smask, _ = JG.bin_dense(p, jbox, jnp.ones(n), jcp.base)
            garr = JG.pack_ghost(JG.apply_perm(p, perm, fill=1e5),
                                 JG.apply_perm(t, perm, fill=0), smask, jbox,
                                 jcp.base)
            centers = JC.block_centers(garr, jcp)
            cand = JG.pack_block_windows(garr, jcp.base, jcp.bx, jcp.wl)
            idx, ok = JC.build_indices(centers, cand, jcp, ref.rc)
            return centers, cand, idx, ok

        centers, cand, idx, ok = setup(jnp.asarray(pos),
                                       jnp.asarray(types, jnp.int32))
        assert bool(ok)
        out = {}
        for pav in (False, True):
            outf, pvals = JT.tersoff_kernel_call(centers, cand, idx, jcp,
                                                 jspec, pav, True)
            dcand = JC.scatter_call(pvals, idx, jcp, True)
            out[pav] = tuple(np.asarray(v) for v in (outf, dcand))
    for v in (centers, cand) + sum(out.values(), ()):
        assert v.dtype == np.float64
    args = (torch.as_tensor(np.array(centers)),
            torch.as_tensor(np.array(cand)),
            torch.as_tensor(np.array(idx), dtype=torch.int32), cp,
            TT.TersoffSpec.from_potential(mine))
    return args, out


@pytest.mark.parametrize("pav", [False, True], ids=["pch4", "pch12"])
def test_fused_plain_matches_pallas(pallas_pair, pav):
    """tersoff_scatter_plain against the Pallas tersoff kernel and scatter:
    outf and the window cotangents, at the scatter parity tolerance of
    tests/test_torch_nep_kernels.py (rtol 1e-9, atol 1e-12)."""
    args, out = pallas_pair
    outf, dcand = TT.tersoff_scatter_plain(*args, pav)
    assert dcand.shape[2] == (12 if pav else 4)
    assert float(dcand[:, :, :3].abs().max()) > 0.1  # live bonds in reach
    for got, ref in zip((outf, dcand), out[pav]):
        np.testing.assert_allclose(_np(got), ref, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("pav", [False, True], ids=["pch4", "pch12"])
def test_fused_call_takes_plain_version_on_cpu(pallas_pair, pav):
    """On CPU tensors tersoff_scatter_call launches nothing and returns
    the composition of the two plain versions, bit for bit."""
    args, _ = pallas_pair
    before = dict(cuda_build.launches)
    got = TT.tersoff_scatter_call(*args, pav)
    assert cuda_build.launches == before
    outf, pvals = TT.tersoff_kernel_plain(*args, pav)
    ref = (outf, TC.scatter_plain(pvals, args[2], args[3]))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _matches_list_path(ref, out, inv, pav):
    np.testing.assert_allclose(_np(out.energy)[inv],
                               np.asarray(ref.potential_energy),
                               rtol=1e-10, atol=1e-11)
    np.testing.assert_allclose(_np(out.force)[inv], np.asarray(ref.force),
                               rtol=1e-8, atol=1e-9)
    w_ref = np.asarray(ref.virial)
    np.testing.assert_allclose(_np(out.virial_total), w_ref.sum(axis=0),
                               rtol=1e-8, atol=1e-8)
    if pav:
        np.testing.assert_allclose(_np(out.virial_atom)[inv], w_ref,
                                   rtol=1e-8, atol=1e-9)
    else:
        assert out.virial_atom is None


@pytest.mark.parametrize("pav", [False, True], ids=["total", "per_atom"])
def test_force_pass_matches_list_path(force_pass, pav):
    ref, outs, _ = force_pass
    _matches_list_path(ref, *outs[pav, "engine"], pav)


@pytest.mark.parametrize("pav", [False, True], ids=["total", "per_atom"])
def test_force_pass_matches_list_path_at_cap128(force_pass, pav):
    """The same at cap 128: the fused kernel's plain version at pch 4, the
    tersoff kernel's and the scatter's at pch 12."""
    ref, outs, _ = force_pass
    _matches_list_path(ref, *outs[pav, "cap128"], pav)


def test_force_pass_takes_fused_kernel_where_it_fits(force_pass):
    """The fused kernel wherever its accumulator fits in shared memory:
    on the engine's plan in both virial modes and at cap 128 with pch 4;
    the tersoff kernel, then the scatter, at cap 128 with pch 12."""
    _, _, routes = force_pass
    fused, contract = ("tersoff_scatter_call",), ("tersoff_kernel_call",)
    assert routes == {(False, "engine"): (fused, True),
                      (True, "engine"): (fused, True),
                      (False, "cap128"): (fused, True),
                      (True, "cap128"): (contract, False)}


@pytest.mark.parametrize("name,a0,nc,e_coh", [("Si", 5.432, 2, -4.62960),
                                               ("SiC", 4.32, 3, -6.16466)])
def test_lattice_cohesive_energy(pots, name, a0, nc, e_coh):
    """Perfect diamond Si at a0 = 5.432 A (-4.62960 eV/atom, the published
    parameters' known cohesive energy) and zincblende SiC at 4.32 A
    (-6.16466 eV/atom, the JAX list path's value): zero forces."""
    mine, _ = pots[name]
    pos, _, lengths = _diamond(nc, a0=a0, jitter=0.0)
    n = len(pos)
    types = np.tile([0, 0, 0, 0, 1, 1, 1, 1], n // 8) if name == "SiC" \
        else np.zeros(n, int)
    box = Box.orthogonal(lengths, device="cpu")
    md = TT.CompactTersoffMD(mine, box, n, position=pos, skin=0.2)
    carry = md.init_carry(make_state(pos, np.asarray(MASS)[types], types,
                                     box))
    s = md.compute(carry.state, carry.idx)
    assert float(torch.sum(s.potential_energy)) / n == pytest.approx(
        e_coh, abs=5e-6)
    assert float(s.force.abs().max()) < 1e-10


def test_g_keeps_f32_precision(pots):
    """Si's c^2/d^2 is 3.8e7: the TPU kernel's g = 1 + c^2/d^2 - c^2/(d^2 +
    (cos - h)^2) cancels two such terms, so in f32 it loses all of g near
    cos = h; the port's 1 + c^2 (cos - h)^2 / (d^2 (d^2 + (cos - h)^2))
    keeps f32 precision, and the f32 lattice energy agrees with f64."""
    mine, _ = pots["Si"]
    spec = TT.TersoffSpec.from_potential(mine)
    c2, d2, h = spec.c2[0], spec.d2[0], spec.h[0]
    cos = np.linspace(-1.0, 1.0, 201)
    exact = 1.0 + c2 * (cos - h) ** 2 / (d2 * (d2 + (cos - h) ** 2))
    f = np.float32
    c32 = cos.astype(f)
    tpu = (f(1) + f(c2) / f(d2)) - f(c2) / (f(d2) + (c32 - f(h)) ** 2)
    assert np.abs(tpu / exact - 1.0).max() > 0.5
    # bonds (cos, sin, 0) against (1, 0, 0): cos_jk is c32 exactly
    ux = torch.tensor(np.append(c32, f(1)))[:, None]
    uy = torch.tensor(np.append(np.sqrt(1 - c32 ** 2), f(0)))[:, None]
    tm = {"u": (ux, uy, torch.zeros_like(ux))}
    tm.update({k: torch.full((1, 1), v) for k, v in
               (("c2", c2), ("d2c", d2), ("h", h))})
    _, g, _ = TT._angle_tiles(tm)
    assert g.dtype == torch.float32
    assert np.abs(g[:201, 201, 0].double().numpy() / exact - 1.0).max() \
        < 1e-4
    pos, types, lengths = _diamond(2, a0=5.432, jitter=0.05)
    n = len(pos)
    e = []
    for dt in (torch.float32, torch.float64):
        box = Box.orthogonal(lengths, dtype=dt, device="cpu")
        md = TT.CompactTersoffMD(mine, box, n, position=pos, skin=0.2)
        carry = md.init_carry(make_state(pos, np.full(n, MASS[0]), types,
                                         box))
        s = md.compute(carry.state, carry.idx)
        e.append(float(torch.sum(s.potential_energy.double())) / n)
    assert abs(e[0] - e[1]) < 1e-5


@pytest.mark.parametrize("nc,plan", [
    (3, ((4, 4, 4), 8, 4, 32, 32, 512, 0)),
    (4, ((5, 6, 6), 8, 5, 32, 32, 512, 0))])
def test_md_plan_matches_jax(pots, nc, plan):
    """CompactTersoffMD plans as the JAX package does (216 and 512 atoms
    jittered by 0.1 A, skin 0.5): full windows (cl 0), mn 32."""
    mine, ref = pots["Si"]
    pos, _, lengths = _diamond(nc)
    n = len(pos)
    md = TT.CompactTersoffMD(mine, Box.orthogonal(lengths, device="cpu"), n,
                             position=pos, skin=0.5)
    jmd = JT.CompactTersoffMD(ref, JBox.orthogonal(lengths), n,
                              position=pos, skin=0.5)
    assert _plan_key(md.cplan) == _plan_key(jmd.cplan) == plan


ENSEMBLES = {
    "nve": (lambda: NVE(), lambda: JNVE()),
    "nvt_ber": (lambda: NVTBerendsen(t0=300.0, t1=400.0, coupling=5.0,
                                     n_steps=10),
                lambda: JBer(t0=300.0, t1=400.0, coupling=5.0, n_steps=10)),
    "nvt_nhc": (lambda: NVTNoseHooverChain(t0=300.0, t1=300.0,
                                           coupling=20.0),
                lambda: JNHC(t0=300.0, t1=300.0, coupling=20.0)),
}


@pytest.mark.parametrize("ens", list(ENSEMBLES))
def test_md_matches_md_run(pots, ens):
    """10 steps at 1 fs from the same 600 K velocities through
    CompactTersoffMD and JAX md_run on the list path with the JAX
    ensemble: positions to 1e-8 A, potential energy to 1e-8 eV,
    velocities to 1e-9.  Short couplings (tau = 5 fs, 20 fs for the chain,
    whose unit start velocities a shorter tau turns violent) make the
    thermostats move the 600 K start within the 10 steps; skin 0.1 makes
    the rebuild (rebin and new lists) fire within them."""
    mine, ref = pots["Si"]
    pos, types, lengths = _diamond(3, seed=4)
    n = len(pos)
    mass = np.full(n, MASS[0])
    rng = np.random.default_rng(5)
    vel = rng.normal(size=(n, 3)) * np.sqrt(K_B * 600.0 / mass)[:, None]
    vel -= vel.mean(axis=0)
    dt, steps = 1.0 / TIME_UNIT_CONVERSION, 10
    make, jmake = ENSEMBLES[ens]

    jbox = JBox.orthogonal(lengths)
    ff = ForceField.create([ref], jbox, n, mn=64)
    jfinal, _, _ = md_run(ff.compute(jmake_state(pos, mass, types, jbox,
                                                 velocity=vel)),
                          ff, jmake(), dt, steps)

    box = Box.orthogonal(lengths, device="cpu")
    md = TT.CompactTersoffMD(mine, box, n, position=pos, skin=0.1)
    ensemble = make()
    carry = md.init_carry(make_state(pos, mass, types, box, velocity=vel))
    carry = carry._replace(state=md.compute(carry.state, carry.idx))
    aux = ensemble.init(carry.state)
    step = md.make_step(ensemble, dt)
    rebuilds = 0
    for _ in range(steps):
        ref_frac = carry.ref_frac
        carry, aux = step(carry, aux)
        rebuilds += carry.ref_frac is not ref_frac
    assert rebuilds >= 1 and not bool(carry.overflow)
    if ens != "nve":
        assert aux["i"] == steps
    final = md.to_input_order(carry, n)
    dpos = box.minimum_image(final.position
                             - torch.as_tensor(np.array(jfinal.position)))
    assert float(dpos.abs().max()) < 1e-8
    e_ref = float(jnp.sum(jfinal.potential_energy * jfinal.mask))
    assert abs(float(torch.sum(final.potential_energy)) - e_ref) < 1e-8
    np.testing.assert_allclose(_np(final.velocity),
                               np.asarray(jfinal.velocity), rtol=0,
                               atol=1e-9)


def test_hnemd_not_ported(pots):
    """The HNEMD driving force on CompactTersoffMD: off by default, a
    ValueError without per-atom virials, accepted with them (the name is
    the one the test had while the driving force raised here);
    tests/test_torch_hnemd.py holds the driven force pass against the JAX
    package."""
    mine, _ = pots["Si"]
    pos, _, lengths = _diamond(3)
    box = Box.orthogonal(lengths, device="cpu")
    md = TT.CompactTersoffMD(mine, box, len(pos), position=pos, skin=0.5)
    assert md.hnemd_fe is None
    with pytest.raises(ValueError, match="per_atom_virial=True"):
        md.hnemd_fe = (0.0, 0.0, 1e-5)
    md = TT.CompactTersoffMD(mine, box, len(pos), position=pos, skin=0.5,
                             per_atom_virial=True)
    md.hnemd_fe = (0.0, 0.0, 1e-5)
    assert md.hnemd_fe == (0.0, 0.0, 1e-5)


def test_entry_points_default_to_the_card(tmp_path):
    """Without device=, Tersoff1989.from_file puts its tables on the card;
    on a machine without one it raises instead of falling back."""
    path = tmp_path / "Si.txt"
    path.write_text(SI)
    if torch.cuda.is_available():
        assert Tersoff1989.from_file(str(path)).a.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            Tersoff1989.from_file(str(path))
