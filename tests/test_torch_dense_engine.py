"""The port's dense-window NEP engines vs the JAX package, f64 on the CPU.

Round 2 (`dense_nep_compute_v2`, DenseNEPMD(engine="v2"), kernels K1b and
K2b) and round 1 (`dense_nep_compute`, kernels K1 and K2).  The systems
are 160 atoms of a jittered two-species solid on a 3^3 grid (cap 16),
with the small model of tests/test_torch_nep_kernels.py (n_max 2, basis
2, l_max 2, universal ZBL with rc 1/2; a few atoms moved within 2 A of a
neighbour so the switch is exercised) or the trained NEP4 Te/Pb model of
artifacts/trainer_parity_r5_nep.txt at full width, in periodic boxes and
one box with an open z.  The JAX Pallas kernels run in interpret mode.

Each plain kernel gets the JAX kernel's own numpy inputs (random
cotangents for the backward ones).  Sums are taken in another order, so
outputs agree to f64 rounding: rtol 1e-9 with an absolute floor of 1e-12.
The engines' energies, forces and virials are held to JAX at 1e-9 and to
the port's own compact engine at the tolerances of
tests/test_torch_nep_slice.py.  The round-1 oracle is JAX
`dense_nep_compute` once, with the small model (its interpret-mode
kernels take ~30 s here); its kernels' inputs and outputs are recorded
during that run.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.engine import grid as JG
from gpumd_tpu.engine import nep_dense as JD
from gpumd_tpu.engine.dense_md import DenseNEPMD as JDenseNEPMD
from gpumd_tpu.integrate.ensembles import NVE as JNVE
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.potentials.nep.model import NEP as JNEP
from gpumd_tpu.potentials.nep.params import NepModel as JModel
from gpumd_tpu.potentials.nep.params import load_nep_txt as jload
from gpumd_tpu.potentials.nep.params import random_params as jrandom_params
from gpumd_tpu_torch.engine import dense_md as TM
from gpumd_tpu_torch.engine import grid as TG
from gpumd_tpu_torch.engine import nep_dense as TD
from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
from gpumd_tpu_torch.integrate.ensembles.nve import NVE
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.potentials.nep.model import NEP
from gpumd_tpu_torch.potentials.nep.params import (
    NepModel,
    load_nep_txt,
    params_from_numpy,
)
from gpumd_tpu_torch.units import K_B, TIME_UNIT_CONVERSION
from torch_first_trig import warm_torch_transcendentals  # noqa: F401


RTOL, ATOL = 1e-9, 1e-12
MODEL = str(Path(__file__).resolve().parent.parent / "artifacts"
            / "trainer_parity_r5_nep.txt")
SMALL_KW = dict(
    version=4, model_type=0, num_types=2, symbols=("Te", "Pb"),
    atomic_numbers=(52, 82), rc_radial=(8.0, 8.0), rc_angular=(4.0, 4.0),
    mn_radial=96, mn_angular=24, n_max_radial=2, n_max_angular=2,
    basis_size_radial=2, basis_size_angular=2, l_max=2, neurons=30,
    zbl=True, zbl_rc_inner=1.0, zbl_rc_outer=2.0)
LENGTHS = [27.5, 28.5, 30.0]


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _models(which):
    """(JAX model, JAX params, port model, port params) in f64."""
    if which == "small":
        jm = JModel(**SMALL_KW)
        jp = jrandom_params(jm, seed=7, dtype=jnp.float64)
        leaves = {k: None if v is None else np.asarray(v)
                  for k, v in jp._asdict().items()}
        return jm, jp, NepModel(**SMALL_KW), params_from_numpy(
            leaves, dtype=torch.float64, device="cpu")
    jm, jp = jload(MODEL, dtype=jnp.float64)
    tm, tp = load_nep_txt(MODEL, dtype=torch.float64, device="cpu")
    return jm, jp, tm, tp


def _system(seed, n=160, close=0, open_z=False):
    """Jittered cubic lattice scaled to LENGTHS; `close` atoms moved within
    ~1-1.9 A of another atom (pairs inside the ZBL switch)."""
    rng = np.random.default_rng(seed)
    nx = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(nx)] * 3, indexing="ij"), -1)
    pos = grid.reshape(-1, 3)[:n] * 3.3 + rng.uniform(-0.35, 0.35, (n, 3))
    pos = pos * (np.asarray(LENGTHS) / (nx * 3.3))
    for k in range(close):
        v = rng.normal(size=3)
        pos[k] = pos[n - 1 - k] + v / np.linalg.norm(v) * rng.uniform(1.0,
                                                                      1.9)
    if open_z:
        pos[:, 2] = pos[:, 2] * 0.9 + 1.0  # away from the open faces
    return pos, rng.integers(0, 2, n)


def _slots(pos, types, open_z):
    """JAX binning on the v2 engine's plan: slot arrays, box, plan."""
    n = len(pos)
    box = JBox.orthogonal(LENGTHS, pbc=(True, True, not open_z))
    pos = np.array(box.wrap(jnp.asarray(pos)))
    plan = JG.plan_grid(box, 8.0, 0.5, n, position=pos)
    perm, smask, ov = JG.bin_dense(jnp.asarray(pos), box, jnp.ones(n), plan)
    assert not bool(ov)
    ps = JG.apply_perm(jnp.asarray(pos), perm, fill=1e5)
    ts = JG.apply_perm(jnp.asarray(types, jnp.int32), perm, fill=0)
    return ps, ts, smask, box, plan


def _tplan(plan):
    return TG.DenseGridPlan(grid=plan.grid, cap=plan.cap, rc=plan.rc,
                            skin=plan.skin, pbc=plan.pbc)


CASES = {"small-zbl": ("small", 3, False), "full": ("full", 0, False),
         "full-open-z": ("full", 0, True)}
# the kernels' oracle runs on the periodic cases (the open box reaches the
# kernels through the engine tests)
KERNEL_CASES = ["small-zbl", "full"]


@functools.lru_cache(maxsize=None)
def _v2(name):
    """One system: JAX slot arrays and engine output, the packed inputs."""
    which, close, open_z = CASES[name]
    jm, jp, tm, tp = _models(which)
    pos, types = _system(13, close=close, open_z=open_z)
    ps, ts, smask, box, plan = _slots(pos, types, open_z)
    garr = JG.pack_ghost(ps, ts, smask, box, plan)
    c, w = JG.pack_candidates(garr, plan,
                              lane_align=JD._chunk_lanes(plan.cap))
    return {"name": name, "jm": jm, "jp": jp, "tm": tm, "tp": tp, "ps": ps,
            "ts": ts, "smask": smask, "box": box, "plan": plan,
            "tplan": _tplan(plan), "garr": garr, "c": c, "w": w,
            "tbox": Box.orthogonal(LENGTHS, pbc=(True, True, not open_z),
                                   device="cpu"),
            "jout": JD.dense_nep_compute_v2(ps, ts, smask, box, plan, jm, jp,
                                            interpret=True)}


@functools.lru_cache(maxsize=None)
def _v2_kernels(name):
    """The JAX kernels on the case's packed inputs (random cotangents)."""
    case = dict(_v2(name))
    spec = JD.DenseNepSpec.from_model(case["jm"])
    c, w, plan = case["c"], case["w"], case["plan"]
    s, a = JD.k1b_call(c, w, plan, spec, True)
    rng = np.random.default_rng(5)
    cs = rng.normal(size=s.shape)
    ca = rng.normal(size=a.shape)
    dc, dw = JD.k2b_call(c, w, jnp.asarray(cs), jnp.asarray(ca), plan, spec,
                         True)
    case.update(s=s, a=a, cs=cs, ca=ca, dc=dc, dw=dw,
                spec=TD.DenseNepSpec.from_model(case["tm"]))
    return case


@pytest.mark.parametrize("name", list(CASES))
def test_pack_candidates_matches_jax(name):
    case = _v2(name)
    c, w = TG.pack_candidates(_t(case["garr"]), case["tplan"],
                              lane_align=TD._chunk_lanes(case["plan"].cap))
    assert torch.equal(c, _t(case["c"]))
    assert torch.equal(w, _t(case["w"]))


@pytest.mark.parametrize("name", list(CASES))
def test_fold_candidate_grad_matches_jax(name):
    """Equal to JAX's fold, and the adjoint of pack_candidates on the
    position channels: <pack(g), dc> = <g, fold(dc)>."""
    case = _v2(name)
    plan, tplan = case["plan"], case["tplan"]
    cap = plan.cap
    w = case["w"]
    dcand = np.random.default_rng(1).normal(
        size=w.shape[:3] + (3, w.shape[-1]))
    dcand[..., 27 * cap:] = 0.0  # pad lanes are dropped
    got = TG.fold_candidate_grad(_t(dcand), tplan)
    ref = JG.fold_candidate_grad(jnp.asarray(dcand[..., :27 * cap]), plan)
    assert torch.equal(got, _t(ref))
    garr = _t(case["garr"])[:, :, :3]
    lhs = torch.sum(_t(w)[..., :3, :27 * cap] * _t(dcand)[..., :27 * cap])
    assert float(lhs) == pytest.approx(float(torch.sum(garr * got)),
                                       rel=1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_fold_ghost_grad_matches_jax(name):
    """Equal to JAX's fold, and the adjoint of pack_ghost: autograd of
    <pack_ghost(p), dg> with respect to the occupied slots' positions."""
    case = _v2(name)
    plan, tplan = case["plan"], case["tplan"]
    dg = np.random.default_rng(2).normal(size=case["garr"][:, :, :3].shape)
    got = TG.fold_ghost_grad(_t(dg), tplan)
    assert torch.equal(got, _t(JG.fold_ghost_grad(jnp.asarray(dg), plan)))
    p = _t(case["ps"]).requires_grad_(True)
    g = TG.pack_ghost(p, _t(case["ts"]), _t(case["smask"]), case["tbox"],
                      tplan)
    (auto,) = torch.autograd.grad(torch.sum(g[:, :, :3] * _t(dg)), p)
    m = _t(case["smask"])[:, None]
    _close(got * m, _np(auto * m), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_k1b_plain_matches_jax(name):
    case = _v2_kernels(name)
    s, a = TD.k1b_plain(_t(case["c"]), _t(case["w"]), case["tplan"],
                        case["spec"])
    _close(s, case["s"])
    _close(a, case["a"])
    if name == "small-zbl":  # the switch region is populated
        assert float(torch.max(torch.abs(s[..., -1]))) > 1.0


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_k2b_plain_matches_jax(name):
    case = _v2_kernels(name)
    dc, dw = TD.k2b_plain(_t(case["c"]), _t(case["w"]), _t(case["cs"]),
                          _t(case["ca"]), case["tplan"], case["spec"])
    _close(dc, case["dc"])
    _close(dw, case["dw"])
    cap = case["plan"].cap
    assert float(torch.max(torch.abs(dw[..., 27 * cap:]))) == 0.0


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_middle_energy_and_vjp_match_jax(name):
    case = _v2_kernels(name)
    spec = case["spec"]
    ns = case["plan"].n_slots
    s = np.asarray(case["s"]).reshape(ns, spec.s_width)
    a = np.moveaxis(np.asarray(case["a"]), 3, 4).reshape(ns, spec.a_width)
    ts, sm = case["ts"], case["smask"]

    @jax.jit
    def mid_vjp(s_, a_):
        def mid(s2, a2):
            return JD.middle_energy(s2, a2, ts, case["jm"], case["jp"]) * sm

        e, vjp = jax.vjp(mid, s_, a_)
        return (e,) + vjp(jnp.ones_like(e))

    e, cot_s, cot_a = mid_vjp(jnp.asarray(s), jnp.asarray(a))
    te, tcs, tca = TD._middle_vjp(_t(s), _t(a), _t(ts), _t(sm), case["tm"],
                                  case["tp"])
    _close(te, e)
    _close(tcs, cot_s)
    _close(tca, cot_a)
    _close(TD.middle_energy(_t(s), _t(a), _t(ts), case["tm"], case["tp"])
           * _t(sm), e)


@pytest.mark.parametrize("name", list(CASES))
def test_dense_v2_matches_jax(name):
    c = _v2(name)
    out = TD.dense_nep_compute_v2(_t(c["ps"]), _t(c["ts"]), _t(c["smask"]),
                                  c["tbox"], c["tplan"], c["tm"], c["tp"])
    j = c["jout"]
    _close(out.energy, j.energy)
    _close(out.force, j.force, atol=1e-10)
    _close(out.virial_total, j.virial_total, atol=1e-10)


def _md_state(md, pos, types, box):
    mass = np.where(types == 1, 207.2, 127.6)
    carry = md.init_carry(make_state(pos, mass, types, box))
    assert not bool(carry.overflow)
    st = md.compute(carry.state, carry.idx)
    return md.to_input_order(carry._replace(state=st), len(pos))


@pytest.mark.parametrize("name", list(CASES))
def test_dense_v2_matches_compact(name):
    """DenseNEPMD(engine="v2").compute against the port's compact engine
    (full-window rung) on the same atoms, in input order."""
    c = _v2(name)
    which, close, open_z = CASES[name]
    pos, types = _system(13, close=close, open_z=open_z)
    nep = NEP(model=c["tm"], params=c["tp"])
    n = len(pos)
    got = {eng: _md_state(DenseNEPMD(nep, c["tbox"], n, position=pos,
                                     skin=0.5, engine=eng,
                                     compact_lists=False),
                          pos, types, c["tbox"])
           for eng in ("v2", "compact")}
    v2, cp = got["v2"], got["compact"]
    _close(v2.potential_energy, _np(cp.potential_energy), rtol=1e-9,
           atol=1e-10)
    _close(v2.force, _np(cp.force), rtol=1e-8, atol=1e-9)
    _close(v2.virial.sum(0), _np(cp.virial.sum(0)), rtol=1e-8, atol=1e-8)


# --------------------------------------------------------------------------
# round 1
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def v1_case():
    jm, jp, tm, tp = _models("small")
    pos, types = _system(17, close=3)
    ps, ts, smask, box, plan = _slots(pos, types, False)
    rec = {}
    k1_orig, k2_orig = JD.k1_call, JD.k2_call

    def k1_rec(garr, plan_, spec, interpret):
        rec["k1_in"] = garr
        rec["k1_out"] = k1_orig(garr, plan_, spec, interpret)
        return rec["k1_out"]

    def k2_rec(garr, cot_s, cot_a, plan_, spec, interpret):
        rec["k2_in"] = (garr, cot_s, cot_a)
        rec["k2_out"] = k2_orig(garr, cot_s, cot_a, plan_, spec, interpret)
        return rec["k2_out"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JD, "k1_call", k1_rec)
        mp.setattr(JD, "k2_call", k2_rec)
        rec["jout"] = JD.dense_nep_compute(ps, ts, smask, box, plan, jm, jp,
                                           interpret=True)
    rec.update(tm=tm, tp=tp, ps=ps, ts=ts, smask=smask, tplan=_tplan(plan),
               tbox=Box.orthogonal(LENGTHS, device="cpu"),
               spec=TD.DenseNepSpec.from_model(tm))
    return rec


def test_k1_plain_matches_jax(v1_case):
    s, a = TD.k1_plain(_t(v1_case["k1_in"]), v1_case["tplan"],
                       v1_case["spec"])
    _close(s, v1_case["k1_out"][0])
    _close(a, v1_case["k1_out"][1])


def test_k2_plain_matches_jax(v1_case):
    g = TD.k2_plain(*[_t(x) for x in v1_case["k2_in"]], v1_case["tplan"],
                    v1_case["spec"])
    _close(g, v1_case["k2_out"])


def test_dense_v1_matches_jax(v1_case):
    c = v1_case
    out = TD.dense_nep_compute(_t(c["ps"]), _t(c["ts"]), _t(c["smask"]),
                               c["tbox"], c["tplan"], c["tm"], c["tp"])
    j = c["jout"]
    _close(out.energy, j.energy)
    _close(out.force, j.force, atol=1e-10)
    _close(out.virial_total, j.virial_total, atol=1e-10)


# --------------------------------------------------------------------------
# the MD loop (DenseNEPMD)
# --------------------------------------------------------------------------


def _thermal(seed, temp):
    pos, types = _system(seed)
    mass = np.where(types == 1, 207.2, 127.6)
    vel = np.random.default_rng(seed + 1).normal(size=pos.shape)
    vel *= np.sqrt(K_B * temp / mass)[:, None]
    vel -= (mass[:, None] * vel).sum(0) / mass.sum()
    return pos, types, mass, vel


def test_dense_md_v2_tracks_compact_and_jax():
    """10 NVE steps at 2 fs from 3000 K velocities with skin 0.1 (rebins
    mid-run) on engine="v2", against the compact rung and JAX
    DenseNEPMD(engine="v2"): f64 force differences of ~1e-13 keep the
    trajectories within 1e-8 A."""
    jm, jp, tm, tp = _models("small")
    pos, types, mass, vel = _thermal(21, 3000.0)
    n, dt, steps = len(pos), 2.0 / TIME_UNIT_CONVERSION, 10
    box = Box.orthogonal(LENGTHS, device="cpu")
    nep = NEP(model=tm, params=tp)
    finals = {}
    for eng in ("v2", "compact"):
        md = DenseNEPMD(nep, box, n, position=pos, skin=0.1, engine=eng,
                        compact_lists=False)
        ens = NVE()
        with torch.no_grad():
            carry = md.init_carry(make_state(pos, mass, types, box,
                                             velocity=vel))
            carry = carry._replace(state=md.compute(carry.state, carry.idx))
            aux = ens.init(carry.state)
            step = md.make_step(ens, dt)
            rebins = 0
            for _ in range(steps):
                ref = carry.ref_frac
                carry, aux = step(carry, aux)
                rebins += carry.ref_frac is not ref
        assert rebins >= 1 and not bool(carry.overflow)
        finals[eng] = md.to_input_order(carry, n)
        if eng == "v2":
            assert carry.idx is None
            assert md.cplan is None
    d = box.minimum_image(finals["v2"].position - finals["compact"].position)
    assert float(d.abs().max()) < 1e-8

    jbox = JBox.orthogonal(LENGTHS)
    jmd = JDenseNEPMD(JNEP(model=jm, params=jp), jbox, n, position=pos,
                      skin=0.1, engine="v2", interpret=True)
    jc, _ = jax.jit(lambda s: jmd.run(s, JNVE(), dt, steps))(
        jmake_state(pos, mass, types, jbox, velocity=vel))
    jf = jmd.to_input_order(jc, n)
    d = box.minimum_image(finals["v2"].position - _t(jf.position))
    assert float(d.abs().max()) < 1e-8
    _close(finals["v2"].velocity, jf.velocity, rtol=0, atol=1e-9)
    _close(finals["v2"].potential_energy, jf.potential_energy, rtol=1e-8,
           atol=1e-9)


@pytest.mark.parametrize("route", ["compact", "v2-fallback"])
def test_engine_auto_routing(route, monkeypatch):
    """engine="auto" takes the compact engine when CompactSpec accepts the
    model, else v2; either way the plan comes from plan_grid_compact
    (cap None), as in the JAX package."""
    pos, types = _system(3)
    _, _, tm, tp = _models("small")
    box = Box.orthogonal(LENGTHS, device="cpu")
    if route == "v2-fallback":
        def reject(model, params):
            raise NotImplementedError("compact engine: rejected")

        monkeypatch.setattr(TM.CompactSpec, "from_model",
                            staticmethod(reject))
    md = DenseNEPMD(NEP(model=tm, params=tp), box, len(pos), position=pos,
                    skin=0.5, per_atom_virial=True)
    expect = "compact" if route == "compact" else "v2"
    assert md.engine == expect
    assert md.per_atom_virial == (expect == "compact")
    assert (md.cplan is None) == (expect == "v2")
    assert md.plan == TM.plan_grid_compact(box, 8.0, 0.5, len(pos),
                                           position=pos)


@pytest.mark.parametrize("bad", ["dipole", "five-types", "typewise-zbl"])
def test_dense_spec_rejections(bad):
    kw = dict(SMALL_KW)
    if bad == "dipole":
        kw["model_type"] = 1
    elif bad == "five-types":
        kw.update(num_types=5, symbols=("Te", "Pb", "Ge", "Sn", "Se"),
                  atomic_numbers=(52, 82, 32, 50, 34), rc_radial=(8.0,) * 5,
                  rc_angular=(4.0,) * 5)
    else:
        kw["zbl_typewise_factor"] = 0.65
    with pytest.raises(NotImplementedError, match="dense engine"):
        TD.DenseNepSpec.from_model(NepModel(**kw))


# --------------------------------------------------------------------------
# the kernels' cut of a cell (dense_tiling) against the shared-memory
# limits of the kernels without live-pair queues
# --------------------------------------------------------------------------


def _spec(t, kr1, ka1, l_max):
    return TD.DenseNepSpec(
        num_types=t, kr1=kr1, ka1=ka1, l_max=l_max, rc_radial=(8.0,) * t,
        rc_angular=(4.0,) * t, zbl=True, zbl_rc_inner=1.0, zbl_rc_outer=2.0,
        atomic_numbers=(52, 82, 32, 50)[:t])


@pytest.mark.parametrize("t,kr1,ka1,l_max", [
    (1, 2, 2, 1), (2, 7, 7, 4), (4, 20, 20, 1), (2, 7, 20, 6), (3, 12, 9, 8),
    (4, 9, 2, 3), (1, 20, 1, 2), (4, 20, 20, 8)])
def test_dense_tiling_accepts_every_queueless_plan(t, kr1, ka1, l_max):
    """Every (spec, cap) the queueless kernels' size checks let through
    (round 2 at pack_candidates' lanes, round 1 at 27 cap) gets a cut that
    fits in shared memory: one window and one group where that fits, else
    smaller pieces, groups and windows, never a refusal."""
    from test_torch_cuda_kernels import _queueless_smem_bytes

    spec = _spec(t, kr1, ka1, l_max)
    accepted = 0
    for cap in range(8, 2208, 8):
        v2 = TG.round_up(27 * cap, TD._chunk_lanes(cap))
        for lanes in (v2, 27 * cap):
            for backward in (False, True):
                if _queueless_smem_bytes(spec, cap, lanes, backward) > \
                        TD._SMEM_LIMIT:
                    continue
                accepted += 1
                tile = TD.dense_tiling(spec, cap, lanes, backward)
                assert tile.smem <= TD._SMEM_LIMIT
                assert tile.smem == 4 * TD._dense_smem_words(
                    spec, cap, tile.cw, tile.gc, tile.qr, tile.qa, backward)
                assert tile.cw % 32 == 0 and 32 <= tile.cw <= lanes + 31
                assert 1 <= tile.gc <= cap and min(tile.qr, tile.qa) >= 32
    assert accepted > 0


@pytest.mark.parametrize("lanes", [1152, 1080])
def test_dense_tiling_pbte_is_one_tile(lanes):
    """The trained model on the PbTe 262k v2 plan (cap 40; 1,152 lanes, or
    round 1's 27 cap): the whole cell in one window and one group, three
    blocks an SM by shared memory (228 KB an SM, 1 KB of it reserved a
    block), pieces of at least half a pair a thread."""
    _, _, tm, _ = _models("full")
    spec = TD.DenseNepSpec.from_model(tm)
    for backward in (False, True):
        tile = TD.dense_tiling(spec, 40, lanes, backward)
        assert tile.cw >= lanes and tile.gc == 40
        assert 3 * (tile.smem + 1024) <= 228 * 1024
        assert tile.qa >= TD._THREADS // 2 and tile.qr >= tile.qa


def test_dense_tiling_refuses_what_no_cut_fits():
    with pytest.raises(ValueError, match="shared memory"):
        TD.dense_tiling(_spec(4, 20, 20, 8), 40000, 27 * 40000, True)
