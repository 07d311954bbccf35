"""The port's general path (NEP list path, ForceField, md_run) vs the JAX
package, f64 on the CPU.

The same numpy positions, weights and neighbour lists go through both
packages' NEP list path (`per_atom_energy`, `raw_descriptors`, `compute`,
`b_projection`, `dipole`, `polarizability`, `restrict` with
`remap_types`) for the trained NEP4 Te/Pb model of
artifacts/trainer_parity_r5_nep.txt and `random_params` models of its
architecture that cover NEP3 and NEP5, the three ZBL kinds, every
invariant flag and the temperature model; a system of more than one
4,096-atom block; the parameter vector (`params_from_vector`,
`global_bias_index`, `write_nep_txt` both ways); `ForceField.compute` and
`compute_cached` across a rebuild, with HNEMD, both HNEMDEC modes and
`average`; `md_run` trajectories; and the list path against the port's own
compact engine.  Energies rtol 1e-9 / atol 1e-10, forces and virials rtol
1e-8 / atol 1e-9 (tests/test_torch_nep_slice.py's); trajectories atol
1e-9.  The JAX functions run with x64 on and matmul precision "highest".
"""

import contextlib
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.elements import MASS_TABLE as JMASS
from gpumd_tpu.forcefield import ForceField as JFF
from gpumd_tpu.forcefield import hnemdec_coefficients as jhnemdec
from gpumd_tpu.integrate.ensembles.nve import NVE as JNVE
from gpumd_tpu.integrate.ensembles.nvt import NVTBerendsen as JBer
from gpumd_tpu.integrate.run import md_run as jmd_run
from gpumd_tpu.integrate.velocity import correct_velocity as jcorrect
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.groups import Groups as JGroups
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.neighbor import neighbor as JN
from gpumd_tpu.potentials.lj import LJ as JLJ
from gpumd_tpu.potentials.nep import params as JP
from gpumd_tpu.potentials.nep.model import NEP as JNEP
from gpumd_tpu_torch.elements import MASS_TABLE, mass_of
from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
from gpumd_tpu_torch.forcefield import ForceField, hnemdec_coefficients
from gpumd_tpu_torch.integrate.ensembles.nve import NVE
from gpumd_tpu_torch.integrate.ensembles.nvt import NVTBerendsen
from gpumd_tpu_torch.integrate.run import md_run
from gpumd_tpu_torch.integrate.velocity import correct_velocity
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.groups import Groups
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.neighbor.neighbor import NeighborList
from gpumd_tpu_torch.potentials.lj import LJ
from gpumd_tpu_torch.potentials.nep import params as TP
from gpumd_tpu_torch.potentials.nep.model import NEP
from gpumd_tpu_torch.units import K_B, TIME_UNIT_CONVERSION
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
MODEL = str(ROOT / "artifacts" / "trainer_parity_r5_nep.txt")
E_TOL = dict(rtol=1e-9, atol=1e-10)
F_TOL = dict(rtol=1e-8, atol=1e-9)


@contextlib.contextmanager
def jax_oracle_state():
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        yield


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _jit(fn, *args):
    """fn(*args) through jax.jit: the oracle compiled whole (~2 s on this
    CPU) instead of op by op (~12 s for a new model's first pass)."""
    return jax.jit(fn)(*args)


def _pbte(nc, jitter, seed, a0=6.57):
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5],
                     [.5, 0, 0], [0, .5, 0], [0, 0, .5], [.5, .5, .5]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    pos = pos + np.random.default_rng(seed).normal(0, jitter, pos.shape)
    return pos, np.tile([1, 1, 1, 1, 0, 0, 0, 0], len(cells)), np.full(
        3, nc * a0)


def _base_model():
    """The artifacts model's architecture: the random models share its
    array shapes, so the JAX oracle compiles its ops once for all."""
    return JP.load_nep_txt(MODEL)[0]


# random models that, with the artifacts model (NEP4, q222), cover NEP3
# and NEP5, the three ZBL kinds, every invariant flag and the temperature
# model
MODELS = {
    "nep3_q1111_zbl_universal": dict(version=3, has_q=(1, 1, 0, 0, 0, 0),
                                     zbl=True, zbl_rc_inner=1.0,
                                     zbl_rc_outer=2.5),
    "nep5_temperature_zbl_typewise": dict(version=5, model_type=3, zbl=True,
                                          zbl_rc_outer=2.5,
                                          zbl_typewise_factor=0.7),
    "extended_zbl_flexible": dict(has_q=(0, 0, 1, 1, 1, 1), zbl=True,
                                  zbl_flexible=True),
}


def _pair_of(jm, jp, temperature=None):
    """The same model and weights in both packages."""
    tm = TP.NepModel(**dataclasses.asdict(jm))
    leaves = {k: None if v is None else np.asarray(v)
              for k, v in jp._asdict().items()}
    tp = TP.params_from_numpy(leaves, device="cpu")
    jnep = JNEP(model=jm, params=jp, temperature=None if temperature is None
                else jnp.asarray(temperature, jnp.float64))
    return jnep, NEP(model=tm, params=tp, temperature=temperature)


def _nep_pair(name):
    with jax_oracle_state():
        if name == "artifacts":
            return _pair_of(*JP.load_nep_txt(MODEL, dtype=jnp.float64))
        jm = dataclasses.replace(_base_model(), **MODELS[name])
        jp = JP.random_params(jm, seed=2, dtype=jnp.float64)
        if jm.zbl_flexible:
            # outer cutoffs past the closest pairs (2.0-2.4 A) and one slow
            # decay, so that the term reaches them
            jp = jp._replace(zbl_flex=jp.zbl_flex.at[:, 1].set(3.2)
                             .at[:, 3].set(0.35))
        return _pair_of(jm, jp, 300.0 if jm.model_type == 3 else None)


def _lists(pos, lengths, rc, mn):
    """A JAX brute-force list with its reverse map, and the same arrays
    as the port's NeighborList."""
    with jax_oracle_state():
        jbox = JBox.orthogonal(lengths)
        n = len(pos)
        jl = JN.neighbor_brute(jnp.asarray(pos), jbox, jnp.ones(n), rc=rc,
                               mn=mn)
        idx, r12, mask = (np.asarray(x) for x in (jl.idx, jl.r12, jl.mask))
        s = np.rint((r12 - (pos[idx] - pos[:, None, :])) / lengths)
        s = np.where(mask[..., None] > 0, s, 0).astype(np.int8)
        jl = jl._replace(rev=JN.build_reverse_map(jl, jnp.asarray(s)))
    tl = NeighborList(*(torch.as_tensor(np.array(x)) for x in jl))
    return jl, tl


@pytest.fixture(scope="module")
def dense_pbte():
    """216 PbTe atoms jittered by 0.35 A: pairs inside every ZBL cutoff."""
    pos, types, lengths = _pbte(3, 0.35, 1)
    jl, tl = _lists(pos, lengths, 8.0, 112)
    return pos, types, jl, tl


@pytest.fixture(scope="module")
def artifacts_oracle(dense_pbte):
    """The artifacts model's JAX results on dense_pbte, compiled once for
    the tests that read them: raw descriptors, compute with the reverse
    map and with the scatter (total virial), and b_projection."""
    pos, types, jl, _ = dense_pbte
    jnep, _ = _nep_pair("artifacts")
    jt = jnp.asarray(types, jnp.int32)
    jmask = jnp.ones(len(pos))
    with jax_oracle_state():
        return _jit(lambda: (
            *jnep.raw_descriptors(jl.r12, jt, jt[jl.idx]),
            jnep.compute(jt, jl, jmask),
            jnep.compute(jt, jl._replace(rev=None), jmask,
                         per_atom_virial=False),
            jnep.b_projection(jl.r12, jt, jt[jl.idx])))


@pytest.mark.parametrize("name", list(MODELS) + ["artifacts"])
def test_nep_list_path_matches(dense_pbte, artifacts_oracle, name):
    pos, types, jl, tl = dense_pbte
    jnep, nep = _nep_pair(name)
    n = len(pos)
    jt, tt = jnp.asarray(types, jnp.int32), torch.as_tensor(types)
    jmask, tmask = jnp.ones(n), torch.ones(n, dtype=torch.float64)
    if name == "artifacts":
        jq, jd, jout, jtot, _ = artifacts_oracle
    else:
        with jax_oracle_state():
            jq, jd, jout, jtot = _jit(lambda: (
                *jnep.raw_descriptors(jl.r12, jt, jt[jl.idx]),
                jnep.compute(jt, jl, jmask),
                # the scatter reduction, total virial
                jnep.compute(jt, jl._replace(rev=None), jmask,
                             per_atom_virial=False)))
    tt2 = tt[tl.idx.long()]
    q, d = nep.raw_descriptors(tl.r12, tt, tt2)
    assert q.shape == (n, nep.model.dim - (nep.model.model_type == 3))
    np.testing.assert_allclose(_np(q), np.asarray(jq), **E_TOL)
    np.testing.assert_allclose(_np(d), np.asarray(jd), rtol=0, atol=1e-12)
    out = nep.compute(tt, tl, tmask)
    np.testing.assert_allclose(_np(nep.per_atom_energy(tl.r12, tt, tt2)),
                               np.asarray(jout.energy), **E_TOL)
    for got, want in ((out, jout),
                      (nep.compute(tt, NeighborList(*tl[:4]), tmask,
                                   per_atom_virial=False), jtot)):
        np.testing.assert_allclose(_np(got.energy), np.asarray(want.energy),
                                   **E_TOL)
        np.testing.assert_allclose(_np(got.force), np.asarray(want.force),
                                   **F_TOL)
        np.testing.assert_allclose(_np(got.virial), np.asarray(want.virial),
                                   **F_TOL)
    if "zbl" in name:
        # the ZBL term is on: the same list without it gives other forces
        bare = nep._replace(model=dataclasses.replace(nep.model, zbl=False))
        assert float((bare.compute(tt, tl, tmask).force
                      - out.force).abs().max()) > 1e-3


def test_b_projection_matches(dense_pbte, artifacts_oracle):
    pos, types, jl, tl = dense_pbte
    _, nep = _nep_pair("artifacts")
    tt = torch.as_tensor(types)
    want = artifacts_oracle[-1]
    got = nep.b_projection(tl.r12, tt, tt[tl.idx.long()])
    assert got.shape == (len(pos), nep.model.neurons * (nep.model.dim + 2))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F_TOL)


def test_more_than_one_block():
    """5,832 atoms (two blocks of 4,096 and a short one) with a small
    model, through ForceField (the dense cell list)."""
    pos, types, lengths = _pbte(9, 0.1, 2)
    n = len(pos)
    with jax_oracle_state():
        jm = dataclasses.replace(_base_model(), rc_radial=(3.7, 3.7),
                                 rc_angular=(3.5, 3.5), n_max_radial=2,
                                 n_max_angular=2, l_max=2, neurons=4,
                                 has_q=(0,) * 6)
        jnep, nep = _pair_of(jm, JP.random_params(jm, seed=3,
                                                  dtype=jnp.float64))
        jbox = JBox.orthogonal(lengths)
        jff = JFF.create([jnep], jbox, n, mn=16)
        js = _jit(jff.compute, jmake_state(pos, np.ones(n), types, jbox))
    box = Box.orthogonal(lengths, device="cpu")
    ff = ForceField.create([nep], box, n, mn=16)
    assert ff.neighbor.method == jff.neighbor.method == "cell"
    ts = ff.compute(make_state(pos, np.ones(n), types, box))
    np.testing.assert_allclose(_np(ts.potential_energy),
                               np.asarray(js.potential_energy), **E_TOL)
    np.testing.assert_allclose(_np(ts.force), np.asarray(js.force), **F_TOL)
    np.testing.assert_allclose(_np(ts.virial), np.asarray(js.virial), **F_TOL)


def test_blocks_do_not_change_the_result(dense_pbte):
    """An atom's energy depends on its own rows only: blocks of 50 atoms
    (as on the CPU's 4,096 or the card's 32,768) give the same energies
    and partial forces as one block."""
    from gpumd_tpu_torch.potentials.base import energy_and_partials

    pos, types, _, tl = dense_pbte
    _, nep = _nep_pair("artifacts")
    tt = torch.as_tensor(types)
    fn = nep._energy_fn(tt, tt[tl.idx.long()])
    ones = torch.ones(len(pos), dtype=torch.float64)
    e1, p1 = energy_and_partials(fn, tl.r12, ones)
    e50, p50 = energy_and_partials(fn, tl.r12, ones, block=50)
    np.testing.assert_allclose(_np(e50), _np(e1), rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(_np(p50), _np(p1), rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(_np(nep.per_atom_energy(
        tl.r12, tt, tt[tl.idx.long()], block=50)), _np(e1), rtol=1e-13,
        atol=1e-14)


def _tensor_model(model_type, seed):
    """A NEP model with random weights from a random parameter vector, in
    both packages (params_from_vector)."""
    jm = dataclasses.replace(_base_model(), model_type=model_type)
    rng = np.random.default_rng(seed)
    theta = rng.normal(0, 0.3, JP.num_trainable(jm))
    qs = rng.uniform(0.5, 1.5, jm.dim)
    with jax_oracle_state():
        jp = JP.params_from_vector(jm, jnp.asarray(theta), jnp.asarray(qs))
    tp = TP.params_from_vector(TP.NepModel(**dataclasses.asdict(jm)),
                               torch.as_tensor(theta), torch.as_tensor(qs))
    return (JNEP(model=jm, params=jp),
            NEP(model=TP.NepModel(**dataclasses.asdict(jm)), params=tp))


def test_dipole_matches(dense_pbte):
    pos, types, jl, tl = dense_pbte
    jnep, nep = _tensor_model(1, 4)
    jt, tt = jnp.asarray(types, jnp.int32), torch.as_tensor(types)
    n = len(pos)
    with jax_oracle_state():
        want = _jit(lambda: jnep.dipole(jt, jl, jnp.ones(n)))
    # without the reverse map the same sum by pair-mirror symmetry
    for nbr in (tl, NeighborList(*tl[:4])):
        got = nep.dipole(tt, nbr, torch.ones(n, dtype=torch.float64))
        np.testing.assert_allclose(_np(got), np.asarray(want), **F_TOL)
    with pytest.raises(ValueError):
        _nep_pair("artifacts")[1].dipole(tt, tl, torch.ones(n))


def test_polarizability_matches(dense_pbte):
    pos, types, jl, tl = dense_pbte
    jnep, nep = _tensor_model(2, 5)
    assert nep.params.w0_pol.shape == nep.params.w0.shape
    jt, tt = jnp.asarray(types, jnp.int32), torch.as_tensor(types)
    n = len(pos)
    with jax_oracle_state():
        want = _jit(lambda: jnep.polarizability(jt, jl, jnp.ones(n)))
    got = nep.polarizability(tt, tl, torch.ones(n, dtype=torch.float64))
    assert got.shape == (3, 3)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F_TOL)


def test_restrict_and_remap_types(dense_pbte):
    """A three-species model restricted to the two present: the same
    numbers as the JAX package's restriction and as the full model."""
    pos, types, jl, tl = dense_pbte
    with jax_oracle_state():
        jm = dataclasses.replace(
            _base_model(), num_types=3, symbols=("Se", "Te", "Pb"),
            atomic_numbers=(34, 52, 82), rc_radial=(7.0, 8.0, 8.0),
            rc_angular=(4.0, 4.0, 3.5), zbl=True, zbl_flexible=True)
        jfull, full = _pair_of(jm, JP.random_params(jm, seed=6,
                                                    dtype=jnp.float64))
        jr = jfull.restrict(["Pb", "Te"])
    r = full.restrict(["Pb", "Te"])
    assert r.model.symbols == jr.model.symbols == ("Te", "Pb")
    assert dataclasses.asdict(r.model) == dataclasses.asdict(jr.model)
    for k in TP.NepParams._fields:
        a, b = getattr(r.params, k), getattr(jr.params, k, None)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=k)
    orig = types + 1  # codes of the full model: Te 1, Pb 2
    codes = r.remap_types(orig, full.model.symbols)
    np.testing.assert_array_equal(codes, jr.remap_types(orig,
                                                        jfull.model.symbols))
    np.testing.assert_array_equal(codes, types)
    n = len(pos)
    ones = torch.ones(n, dtype=torch.float64)
    got = r.compute(torch.as_tensor(codes), tl, ones)
    ref = full.compute(torch.as_tensor(orig), tl, ones)
    np.testing.assert_allclose(_np(got.force), _np(ref.force), **F_TOL)
    with pytest.raises(ValueError):
        full.restrict(["Pb", "Xe"])
    with pytest.raises(ValueError):
        r.remap_types([0, 1], full.model.symbols)


VECTOR_MODELS = {"nep4": {}, "nep5": dict(version=5),
                 "polarizability": dict(model_type=2),
                 "nep5_polarizability": dict(version=5, model_type=2)}


@pytest.mark.parametrize("name", list(VECTOR_MODELS))
def test_params_from_vector_matches(name):
    jm = dataclasses.replace(_base_model(), **VECTOR_MODELS[name])
    tm = TP.NepModel(**dataclasses.asdict(jm))
    assert TP.num_trainable(tm) == JP.num_trainable(jm)
    assert TP.global_bias_index(tm) == JP.global_bias_index(jm)
    np.testing.assert_array_equal(TP.variable_types(tm),
                                  JP.variable_types(jm))
    theta = np.random.default_rng(7).normal(size=JP.num_trainable(jm))
    with jax_oracle_state():
        jp = JP.params_from_vector(jm, jnp.asarray(theta))
    t = torch.as_tensor(theta).requires_grad_(True)
    tp = TP.params_from_vector(tm, t)
    for k in TP.NepParams._fields:
        a, b = getattr(tp, k), getattr(jp, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=k)
    # differentiable in theta: the global bias slot moves b1 only
    (g,) = torch.autograd.grad(tp.b1, t)
    assert int(torch.nonzero(g).reshape(-1)) == TP.global_bias_index(tm)


def test_global_bias_index_charge_models():
    """The charge layout's bias slot and size, and (NEP4) its
    params_from_vector (the charge head after each type's energy head,
    sqrt(epsilon_inf) before the bias) against the JAX package's on the
    same vector.  A NEP5 charge model's vector has no per-type bias slots
    (num_trainable) while both packages' bias index and params_from_vector
    count them: the port keeps the JAX numbers."""
    for kw in (dict(charge_mode=1), dict(charge_mode=2, version=5)):
        jm = dataclasses.replace(_base_model(), **kw)
        tm = TP.NepModel(**dataclasses.asdict(jm))
        assert TP.global_bias_index(tm) == JP.global_bias_index(jm)
        assert TP.num_trainable(tm) == JP.num_trainable(jm)
        if tm.version == 5:
            continue
        theta = np.random.default_rng(4).normal(size=TP.num_trainable(tm))
        got = TP.params_from_vector(tm, torch.as_tensor(theta))
        want = JP.params_from_vector(jm, jnp.asarray(theta))
        for field in ("w0", "b0", "w1", "b1", "b1_type", "w1_charge",
                      "sqrt_epsilon_inf", "c_radial", "c_angular"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)))
        assert float(got.b1) == theta[TP.global_bias_index(tm)]


@pytest.mark.parametrize("name", ["nep4_zbl", "nep5_polarizability",
                                  "nep3_dipole"])
def test_write_nep_txt_both_ways(tmp_path, name):
    """Each package writes the same bytes, and each reads the other's
    file to the same parameters (the polarizability head included)."""
    kw = {"nep4_zbl": dict(zbl=True, zbl_rc_inner=1.0, zbl_rc_outer=2.0,
                           zbl_typewise_factor=0.6),
          "nep5_polarizability": dict(version=5, model_type=2),
          "nep3_dipole": dict(version=3, model_type=1)}[name]
    jm = dataclasses.replace(_base_model(), **kw)
    tm = TP.NepModel(**dataclasses.asdict(jm))
    rng = np.random.default_rng(8)
    theta = rng.normal(size=JP.num_trainable(jm))
    qs = rng.uniform(0.5, 2.0, jm.dim)
    jpath, tpath = tmp_path / "jax.txt", tmp_path / "torch.txt"
    JP.write_nep_txt(str(jpath), jm, jnp.asarray(theta), jnp.asarray(qs))
    TP.write_nep_txt(str(tpath), tm, torch.as_tensor(theta),
                     torch.as_tensor(qs))
    assert tpath.read_bytes() == jpath.read_bytes()
    tm2, tp2 = TP.load_nep_txt(str(jpath), device="cpu")
    with jax_oracle_state():
        jm2, jp2 = JP.load_nep_txt(str(tpath), dtype=jnp.float64)
    assert dataclasses.asdict(tm2) == dataclasses.asdict(jm2)
    assert (tp2.w0_pol is not None) == (jm.model_type == 2)
    for k in TP.NepParams._fields:
        a, b = getattr(tp2, k), getattr(jp2, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=k)


# ---- ForceField and md_run ------------------------------------------------

@pytest.fixture(scope="module")
def ff_pair():
    """Artifacts model on 216 PbTe jittered by 0.15 A, skin 1.0, MN 112."""
    pos, types, lengths = _pbte(3, 0.15, 0)
    n = len(pos)
    mass = np.where(types == 1, 207.2, 127.6)
    vel = np.random.default_rng(9).normal(0, 1, (n, 3)) * np.sqrt(
        K_B * 300.0 / mass)[:, None]
    jnep, nep = _nep_pair("artifacts")
    with jax_oracle_state():
        jbox = JBox.orthogonal(lengths)
        jff = JFF.create([jnep], jbox, n, mn=112, skin=1.0)
        js = jmake_state(pos, mass, types, jbox, velocity=vel)
    box = Box.orthogonal(lengths, device="cpu")
    ff = ForceField.create([nep], box, n, mn=112, skin=1.0)
    ts = make_state(pos, mass, types, box, velocity=vel)
    return jff, js, ff, ts


@pytest.fixture(scope="module")
def j_first_pass(ff_pair):
    """The JAX force field's first pass on ff_pair's state, compiled once
    for the tests that start from it."""
    jff, js, _, _ = ff_pair
    with jax_oracle_state():
        return _jit(jff.compute, js)


def _same_state(ts, js, traj=False):
    np.testing.assert_allclose(_np(ts.potential_energy),
                               np.asarray(js.potential_energy), **E_TOL)
    np.testing.assert_allclose(_np(ts.force), np.asarray(js.force), **F_TOL)
    np.testing.assert_allclose(_np(ts.virial), np.asarray(js.virial), **F_TOL)
    np.testing.assert_allclose(_np(ts.heat_current),
                               np.asarray(js.heat_current), **F_TOL)
    if traj:
        np.testing.assert_allclose(_np(ts.position), np.asarray(js.position),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(_np(ts.velocity), np.asarray(js.velocity),
                                   rtol=0, atol=1e-9)


def test_compute_cached_across_rebuild(ff_pair, j_first_pass):
    """A small move keeps the cache, a move past skin/2 rebuilds it: the
    states and the caches (shifts, reverse map) as the JAX package's."""
    jff, js, ff, ts = ff_pair
    j0 = j_first_pass
    with jax_oracle_state():
        jc = _jit(jff.refresh_cache, j0)
        cached = jax.jit(jff.compute_cached)
    t0 = ff.compute(ts)
    tc = ff.refresh_cache(t0)
    _same_state(t0, j0)
    rng = np.random.default_rng(10)
    small = rng.normal(0, 0.05, tuple(ts.position.shape))
    big = small.copy()
    big[17] += [0.4, -0.3, 0.2]  # 0.54 A > skin/2
    for move, rebuilt in ((small, False), (big, True)):
        with jax_oracle_state():
            js1, jc1 = cached(j0._replace(position=j0.position + move), jc)
        ts1, tc1 = ff.compute_cached(
            t0._replace(position=t0.position + torch.as_tensor(move)), tc)
        assert (tc1 is not tc) == rebuilt
        _same_state(ts1, js1)
        for k in ("idx", "shift_frac", "mask", "count", "rev"):
            np.testing.assert_array_equal(_np(getattr(tc1, k)),
                                          np.asarray(getattr(jc1, k)),
                                          err_msg=k)
        np.testing.assert_array_equal(_np(tc1.ref_position),
                                      np.asarray(jc1.ref_position))


@pytest.mark.parametrize("drive", ["hnemd", "hnemdec0", "hnemdec1",
                                   "average"])
def test_forcefield_drives_match(ff_pair, drive):
    jff, js, ff, ts = ff_pair
    types = _np(ts.type)
    mass = _np(ts.mass)
    if drive == "hnemd":
        kw = dict(hnemd_fe=(2e-4, -1e-4, 5e-5))
    elif drive == "average":
        kw = dict(average=True)
    else:
        mode = int(drive[-1])
        coef, _, _ = jhnemdec(mode, mass, types, 2)
        kw = dict(hnemdec_mode=mode, hnemdec_fe=(1e-4, 2e-4, -1e-4),
                  hnemdec_coef=coef)
    jf, tf = dataclasses.replace(jff, **kw), dataclasses.replace(ff, **kw)
    if drive == "average":  # NEP and a two-type LJ, their mean
        lj = (np.array([[8e-3, 1e-2], [1e-2, 1.2e-2]]),
              np.array([[3.6, 3.8], [3.8, 4.0]]), np.full((2, 2), 8.0))
        with jax_oracle_state():
            jf = dataclasses.replace(jf, potentials=jf.potentials + (
                JLJ.from_params(*lj),))
        tf = dataclasses.replace(tf, potentials=tf.potentials + (
            LJ.from_params(*lj, device="cpu"),))
    with jax_oracle_state():
        jout = _jit(jf.compute, js)
    _same_state(tf.compute(ts), jout)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_hnemdec_coefficients(mode):
    rng = np.random.default_rng(11)
    types = rng.integers(0, 3, 50)
    masses = np.array([10.0, 20.0, 30.0])[types]
    got = hnemdec_coefficients(mode, masses, types, 3)
    want = jhnemdec(mode, masses, types, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("ens", ["nve", "nvt_ber"])
def test_nep_md_run_matches(ff_pair, j_first_pass, ens):
    """20 steps of 1 fs from the same state, velocities and thermo."""
    jff, js, ff, ts = ff_pair
    dt = 1.0 / TIME_UNIT_CONVERSION
    jens, tens = ((JNVE(), NVE()) if ens == "nve" else
                  (JBer(t0=250.0, coupling=10.0),
                   NVTBerendsen(t0=250.0, coupling=10.0)))
    with jax_oracle_state():
        jf, _, jth = jmd_run(j_first_pass, jff, jens, dt, 20)
    tf, _, th = md_run(ff.compute(ts), ff, tens, dt, 20)
    _same_state(tf, jf, traj=True)
    np.testing.assert_allclose(_np(th.temperature),
                               np.asarray(jth.temperature), **E_TOL)


def test_list_path_matches_compact_engine():
    """The port's list path and its compact engine (plain versions of the
    kernels) on 1,000 PbTe atoms, with a model that has every invariant:
    the compact middle shares `_angular_q`."""
    pos, types, lengths = _pbte(5, 0.15, 12)
    n = len(pos)
    jm = dataclasses.replace(_base_model(), has_q=(1, 1, 1, 1, 1, 1))
    with jax_oracle_state():
        _, nep = _pair_of(jm, JP.random_params(jm, seed=13,
                                               dtype=jnp.float64))
    box = Box.orthogonal(lengths, device="cpu")
    state = make_state(pos, np.ones(n), types, box)
    ref = ForceField.create([nep], box, n, mn=112).compute(state)
    md = DenseNEPMD(nep, box, n, position=pos, skin=1.0, engine="compact",
                    per_atom_virial=True, zero_net_force=False)
    carry = md.init_carry(state)
    out = md.to_input_order(carry._replace(
        state=md.compute(carry.state, carry.idx)), n)
    np.testing.assert_allclose(_np(out.potential_energy),
                               _np(ref.potential_energy), **E_TOL)
    np.testing.assert_allclose(_np(out.force), _np(ref.force), **F_TOL)
    np.testing.assert_allclose(_np(out.virial), _np(ref.virial), **F_TOL)


# ---- small host-side pieces ------------------------------------------------

def test_mass_of_and_table():
    assert MASS_TABLE == JMASS
    assert mass_of("Pb") == 207.2 and mass_of("Ar") == 39.948
    with pytest.raises(KeyError):
        mass_of("Xx")


def test_correct_velocity():
    pos, types, lengths = _pbte(2, 0.1, 14)
    n = len(pos)
    rng = np.random.default_rng(15)
    vel = rng.normal(0, 0.01, (n, 3)) + 0.003
    mass = np.where(types == 1, 207.2, 127.6)
    with jax_oracle_state():
        want = jcorrect(jmake_state(pos, mass, types,
                                    JBox.orthogonal(lengths), velocity=vel,
                                    n_pad=n + 3))
    got = correct_velocity(make_state(pos, mass, types,
                                      Box.orthogonal(lengths, device="cpu"),
                                      velocity=vel, n_pad=n + 3))
    np.testing.assert_allclose(_np(got.velocity), np.asarray(want.velocity),
                               rtol=0, atol=1e-15)
    p = torch.sum(got.velocity * got.mass[:, None] * got.mask[:, None], 0)
    assert float(p.abs().max()) < 1e-12


def test_groups():
    labels = np.array([[0, 1], [1, 1], [2, 0], [1, 0], [0, 2]])
    g, jg = Groups(labels, 7), JGroups(labels, 7)
    assert g.n_methods == jg.n_methods == 2
    for m in range(2):
        assert g.num_groups(m) == jg.num_groups(m)
        np.testing.assert_array_equal(g.sizes(m), jg.sizes(m))
        np.testing.assert_array_equal(_np(g.onehot(m, device="cpu")),
                                      np.asarray(jg.onehot(m)))
        for k in range(g.num_groups(m)):
            np.testing.assert_array_equal(_np(g.mask(m, k, device="cpu")),
                                          np.asarray(jg.mask(m, k)))
    empty = Groups(None, 4)
    assert empty.n_methods == 0 and empty.num_groups(0) == 0
