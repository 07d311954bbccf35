"""The port's HNEMD path and heat-transport measurements vs the JAX
package, f64 on the CPU.

`compute` with the driving force `hnemd_fe` on the default NEP rung (512
PbTe atoms, the trained NEP4 Te/Pb model in
artifacts/trainer_parity_r5_nep.txt) and on the Tersoff engine (216 Si,
Tersoff-1989) is held against the JAX list path (`ForceField` with
`hnemd_fe`, the same F_i += W_i^T Fe and net-force removal); a few driven
NVE steps' heat current J = sum_i W_i v_i, from `make_step`'s observer,
against JAX `md_run`'s observer.  `heat_current_5`, `HAC`, `HNEMDKappa`
and `SHC`'s host path write the same files as the JAX package's from the
same rows (the same session namespace serves both packages); SHC's
accumulation on the device matches its host path (as
tests/test_shc_device.py holds the JAX package's), also fed by
`DenseNEPMD.run`'s measure hook.
"""

import dataclasses
import os
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.forcefield import ForceField
from gpumd_tpu.integrate.ensembles.nve import NVE as JNVE
from gpumd_tpu.integrate.run import md_run
from gpumd_tpu.measure import properties as JP
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.potentials.nep.model import NEP as JNEP
from gpumd_tpu.potentials.tersoff import Tersoff1989 as JTersoff
from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
from gpumd_tpu_torch.engine.tersoff_compact import CompactTersoffMD
from gpumd_tpu_torch.integrate.ensembles.nve import NVE
from gpumd_tpu_torch.measure import properties as TP
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.potentials.nep.model import NEP
from gpumd_tpu_torch.potentials.tersoff import SI_TERSOFF, Tersoff1989
from gpumd_tpu_torch.units import K_B, TIME_UNIT_CONVERSION
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

MODEL = str(Path(__file__).resolve().parent.parent / "artifacts"
            / "trainer_parity_r5_nep.txt")
DT = 1.0 / TIME_UNIT_CONVERSION
# larger than a production Fe (1e-4 1/A), so that the driving term stands
# well above the tolerance
FE = (2.0e-2, -1.0e-2, 5.0e-3)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _lattice(kind):
    """(positions, types, masses, velocities, box lengths): 512 PbTe or
    216 diamond Si, jittered, 300 K velocities without net momentum."""
    if kind == "nep":
        nc, a0 = 4, 6.57
        base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5],
                         [.5, 0, 0], [0, .5, 0], [0, 0, .5], [.5, .5, .5]])
        tcell = [1, 1, 1, 1, 0, 0, 0, 0]
    else:
        nc, a0 = 3, 5.431
        base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5],
                         [.25, .25, .25], [.75, .75, .25], [.75, .25, .75],
                         [.25, .75, .75]])
        tcell = [0] * 8
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    pos = pos + np.random.default_rng(1).normal(0, 0.1, pos.shape)
    typ = np.tile(tcell, len(cells))
    mass = (np.where(typ == 1, 207.2, 127.6) if kind == "nep"
            else np.full(len(pos), 28.085))
    vel = np.random.default_rng(5).normal(size=pos.shape) * np.sqrt(
        K_B * 300.0 / mass)[:, None]
    vel -= (mass[:, None] * vel).sum(0) / mass.sum()
    return pos, typ, mass, vel, np.full(3, nc * a0)


@pytest.fixture(scope="module", params=["nep", "tersoff"])
def driven(request, tmp_path_factory):
    """Both packages' engines on one system, hnemd_fe set."""
    kind = request.param
    pos, typ, mass, vel, lengths = _lattice(kind)
    n = len(pos)
    box = Box.orthogonal(lengths, device="cpu")
    jbox = JBox.orthogonal(lengths)
    if kind == "nep":
        jpot = JNEP.from_file(MODEL, dtype=jnp.float64)
        nep = NEP.from_file(MODEL, dtype=torch.float64, device="cpu")
        md = DenseNEPMD(nep, box, n, position=pos, skin=0.5,
                        per_atom_virial=True)
        assert md.cplan.cl > 0
        mn = 128
    else:
        path = tmp_path_factory.mktemp("si") / "Si.txt"
        path.write_text(SI_TERSOFF)
        jpot = JTersoff.from_file(str(path))
        md = CompactTersoffMD(Tersoff1989.from_file(str(path), device="cpu"),
                              box, n, position=pos, skin=0.5,
                              per_atom_virial=True)
        mn = 64
    md.hnemd_fe = FE
    ff = ForceField.create([jpot], jbox, n, mn=mn)
    ff_fe = dataclasses.replace(ff, hnemd_fe=FE)
    jstate = jmake_state(pos, mass, typ, jbox, velocity=vel)
    state = make_state(pos, mass, typ, box, velocity=vel)
    return dict(kind=kind, n=n, md=md, ff=ff, ff_fe=ff_fe, jstate=jstate,
                state=state)


def test_compute_with_hnemd_fe_matches_jax(driven):
    """The driven force pass: forces (and the driving term itself, against
    the undriven pass) to 1e-8 relative, per-atom virials and energies to
    1e-8, J_i = W_i v_i from the JAX virials to 1e-8."""
    md, n = driven["md"], driven["n"]
    carry = md.init_carry(driven["state"])
    out = md.to_input_order(carry._replace(
        state=md.compute(carry.state, carry.idx)), n)
    ref = driven["ff_fe"].compute(driven["jstate"])
    plain = driven["ff"].compute(driven["jstate"])
    f_ref = np.asarray(ref.force)
    drive = f_ref - np.asarray(plain.force)
    assert np.abs(drive).max() > 1e-4  # the driving term is there
    np.testing.assert_allclose(_np(out.force), f_ref, rtol=1e-8, atol=1e-9)
    assert np.abs(_np(out.force).sum(0)).max() < 1e-10
    np.testing.assert_allclose(_np(out.virial), np.asarray(ref.virial),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(_np(out.potential_energy),
                               np.asarray(ref.potential_energy), rtol=1e-8,
                               atol=1e-9)
    j_ref = np.einsum("nab,nb->na", np.asarray(ref.virial),
                      np.asarray(ref.velocity))
    np.testing.assert_allclose(_np(out.heat_current), j_ref, rtol=1e-8,
                               atol=1e-10)


def test_observer_heat_current_matches_jax(driven):
    """Six driven NVE steps: the observer's J = sum_i W_i v_i of the state
    after each step, stacked by `run`, against md_run's observer, to 1e-7
    relative of max |J|.  (`heat_current`, which the benchmark's observer
    sums, holds W_i v_i at the force pass's half-kicked velocities in
    both packages' engines; the list path keeps none.)"""
    md, steps = driven["md"], 6

    def obs(s):
        j = torch.sum(s.virial * s.velocity[:, None, :], dim=2)
        return torch.sum(j * s.mask[:, None], dim=0)

    def jobs(s):
        j = jnp.sum(s.virial * s.velocity[:, None, :], axis=2)
        return jnp.sum(j * s.mask[:, None], axis=0)

    carry, _, maccs, ys = md.run(driven["state"], NVE(), DT, steps,
                                 observer=obs)
    assert maccs is None and ys.shape == (steps, 3)
    assert not bool(carry.overflow)
    ff = driven["ff_fe"]
    _, _, jys = md_run(ff.compute(driven["jstate"]), ff, JNVE(), DT, steps,
                       observer=jobs)
    jys = np.asarray(jys)
    np.testing.assert_allclose(_np(ys), jys, rtol=0,
                               atol=1e-7 * np.abs(jys).max())


def test_heat_current_5_matches_jax():
    rng = np.random.default_rng(2)
    n = 33
    w, v = rng.normal(size=(n, 3, 3)), rng.normal(size=(n, 3))
    state = make_state(np.zeros((n, 3)), np.ones(n), np.zeros(n, int),
                       Box.orthogonal([9.0] * 3, device="cpu"), velocity=v,
                       n_pad=n + 3)
    state = state._replace(virial=torch.as_tensor(
        np.concatenate([w, rng.normal(size=(3, 3, 3))])))
    jstate = jmake_state(np.zeros((n, 3)), np.ones(n), np.zeros(n, int),
                         JBox.orthogonal([9.0] * 3), velocity=v)
    jstate = jstate._replace(virial=jnp.asarray(w))
    np.testing.assert_allclose(_np(TP.heat_current_5(state)),
                               np.asarray(JP.heat_current_5(jstate)),
                               rtol=1e-13, atol=1e-13)


def _session(tmp_path, n=17):
    """One namespace for both packages: a JAX state's box, a workdir."""
    jstate = jmake_state(np.zeros((n, 3)), np.ones(n), np.zeros(n, int),
                         JBox.orthogonal([11.0, 12.0, 13.0]))
    return types.SimpleNamespace(workdir=str(tmp_path), _n=n, state=jstate)


def _in(sess, sub):
    sess.workdir = os.path.join(os.path.dirname(sess.workdir), sub)
    os.makedirs(sess.workdir, exist_ok=True)
    return sess.workdir


def _read(d, name):
    with open(os.path.join(d, name)) as f:
        return f.read()


def test_hac_and_kappa_files_match_jax(tmp_path):
    """The same J rows, in chunks, give hac.out and kappa.out equal byte
    for byte."""
    rows = np.random.default_rng(4).normal(size=(120, 5))
    sess = _session(tmp_path / "x")
    outs = []
    for props, sub in ((TP, "port"), (JP, "jax")):
        d = _in(sess, sub)
        hac = props.HAC(sample_interval=2, nc=12, output_interval=3,
                        dt=0.1, temperature=300.0)
        kap = props.HNEMDKappa(output_interval=25, fe=(1e-4, 0.0, 0.0),
                               dt=0.1, temperature=300.0)
        for k in range(0, len(rows), 30):
            chunk = rows[k:k + 30]
            hac.consume_heat(torch.as_tensor(chunk) if props is TP else chunk,
                             k)
            kap.consume_heat(chunk, k)
            kap.maybe_output(sess)
        hac.postprocess(sess)
        outs.append((_read(d, "hac.out"), _read(d, "kappa.out")))
    assert outs[0] == outs[1]
    assert outs[0][0].count("\n") == 4 and outs[0][1].count("\n") == 4


def _traj(n, n_frames, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_frames, n, 3, 3)),
            rng.normal(size=(n_frames, n, 3)))


def _shc(props, **kw):
    args = dict(sample_interval=1, nc=6, direction=0, num_omega=10,
                max_omega=30.0, dt=0.1)
    args.update(kw)
    return props.SHC(**args)


def _port_state(n):
    return make_state(np.zeros((n, 3)), np.ones(n), np.zeros(n, int),
                      Box.orthogonal([10.0] * 3, device="cpu"))


def test_shc_host_files_match_jax(tmp_path):
    n, frames = 17, 15
    ws, vs = _traj(n, frames)
    sess = _session(tmp_path / "x", n)
    outs = []
    for props, sub in ((TP, "port"), (JP, "jax")):
        d = _in(sess, sub)
        shc = _shc(props)
        for w, v in zip(ws, vs):
            if props is TP:
                st = _port_state(n)._replace(virial=torch.as_tensor(w),
                                             velocity=torch.as_tensor(v))
            else:
                st = sess.state._replace(virial=jnp.asarray(w),
                                         velocity=jnp.asarray(v))
            shc.sample_state(sess, st, 0)
        shc.postprocess(sess)
        outs.append(_read(d, "shc.out"))
    assert outs[0] == outs[1]


def _device_run(sess, props, ws, vs, perms=None, **kw):
    """SHC's device path over frames given in input order, handed over in
    slot order `perms[i]` (slot s holds input atom perms[i][s])."""
    n = ws.shape[1]
    shc = _shc(props, **kw)
    if props is TP:
        macc = shc.device_init(sess, n, device="cpu")
        base, conv = _port_state(n), torch.as_tensor
    else:
        macc = shc.device_init(sess, n)
        base, conv = sess.state, jnp.asarray
    for i, (w, v) in enumerate(zip(ws, vs)):
        perm = np.arange(n) if perms is None else perms[i]
        st = base._replace(virial=conv(w[perm]), velocity=conv(v[perm]))
        macc = shc.device_update(macc, st, conv(perm.astype(np.int32)))
    shc.device_postprocess(sess, macc)
    return np.loadtxt(os.path.join(sess.workdir, "shc.out"), comments="#")


def _host_run(sess, ws, vs, every=1, **kw):
    n = ws.shape[1]
    shc = _shc(TP, **kw)
    for i, (w, v) in enumerate(zip(ws, vs)):
        if (i + 1) % every == 0:
            shc.sample_state(sess, _port_state(n)._replace(
                virial=torch.as_tensor(w), velocity=torch.as_tensor(v)), i)
    shc.postprocess(sess)
    return np.loadtxt(os.path.join(sess.workdir, "shc.out"), comments="#")


@pytest.mark.parametrize("case", ["plain", "permuted", "group_interval"])
def test_shc_device_matches_host(tmp_path, case):
    """The on-device accumulation (f32 rings) against the host path, and
    against the JAX package's device path, to 1e-5 relative (as
    tests/test_shc_device.py): plain frames; slot-permuted frames (the
    engine's rebins); a group mask and sample_interval 2."""
    n, frames = (17, 15) if case == "plain" else (13, 12) if \
        case == "permuted" else (11, 24)
    ws, vs = _traj(n, frames, seed={"plain": 0, "permuted": 1,
                                    "group_interval": 2}[case])
    kw, every, perms = {}, 1, None
    if case == "permuted":
        rng = np.random.default_rng(3)
        perms = [rng.permutation(n) for _ in range(frames)]
    if case == "group_interval":
        kw = dict(sample_interval=2, nc=4, direction=1, num_omega=5,
                  max_omega=20.0, dt=0.5,
                  group_mask=(np.arange(n) % 3 == 0).astype(np.int32))
        every = 2
    sess = _session(tmp_path / "x", n)
    _in(sess, "host")
    host = _host_run(sess, ws, vs, every, **kw)
    _in(sess, "dev")
    dev = _device_run(sess, TP, ws, vs, perms, **kw)
    _in(sess, "jax")
    jdev = _device_run(sess, JP, ws, vs, perms, **kw)
    assert host.shape == dev.shape
    np.testing.assert_allclose(dev, host, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(dev, jdev, rtol=1e-5, atol=1e-7)


def test_run_measure_hook_feeds_shc(tmp_path):
    """DenseNEPMD.run with the observer and SHC's device_update as its
    measure hook, over 8 driven PbTe steps: the same shc.out (to 1e-5) as
    the host path sampling each step's input-order state, and the same
    observer rows as a step loop."""
    pos, typ, mass, vel, lengths = _lattice("nep")
    n = len(pos)
    box = Box.orthogonal(lengths, device="cpu")
    nep = NEP.from_file(MODEL, dtype=torch.float64, device="cpu")
    md = DenseNEPMD(nep, box, n, position=pos, skin=0.5,
                    per_atom_virial=True)
    md.hnemd_fe = (1e-4, 0.0, 0.0)
    state = make_state(pos, mass, typ, box, velocity=vel)
    sess = types.SimpleNamespace(workdir=str(tmp_path), _n=n, state=state)

    def obs(s):
        return TP.heat_current_5(s)

    shc = TP.SHC(sample_interval=1, nc=4, direction=0, num_omega=6,
                 max_omega=20.0, dt=DT)
    maccs = shc.device_init(sess, n)
    _, _, maccs, ys = md.run(state, NVE(), DT, 8, observer=obs,
                             measure=shc.device_update, maccs=maccs)
    assert maccs["step"] == 8 and maccs["count"] == 8
    shc.device_postprocess(sess, maccs)
    dev = np.loadtxt(tmp_path / "shc.out", comments="#")

    host = TP.SHC(sample_interval=1, nc=4, direction=0, num_omega=6,
                  max_omega=20.0, dt=DT)
    carry = md.init_carry(state)
    carry = carry._replace(state=md.compute(carry.state, carry.idx))
    step, aux, rows = md.make_step(NVE(), DT), (), []
    for i in range(8):
        carry, aux = step(carry, aux)
        rows.append(TP.heat_current_5(carry.state))
        host.sample_state(sess, md.to_input_order(carry, n), i)
    sess.workdir = str(tmp_path / "host")
    os.makedirs(sess.workdir)
    host.postprocess(sess)
    np.testing.assert_allclose(
        dev, np.loadtxt(tmp_path / "host" / "shc.out", comments="#"),
        rtol=1e-5, atol=1e-9)
    np.testing.assert_array_equal(_np(ys), _np(torch.stack(rows)))


def test_hnemd_needs_per_atom_virials():
    """v2 computes no per-atom virials (the JAX v2 compute has no driving
    term): setting hnemd_fe there raises, as on the compact engine without
    per_atom_virial."""
    pos, typ, _, _, lengths = _lattice("nep")
    box = Box.orthogonal(lengths, device="cpu")
    nep = NEP.from_file(MODEL, dtype=torch.float64, device="cpu")
    v2 = DenseNEPMD(nep, box, len(pos), position=pos, skin=0.5, engine="v2",
                    per_atom_virial=True)
    with pytest.raises(ValueError, match="engine=\"compact\""):
        v2.hnemd_fe = FE
    compact = DenseNEPMD(nep, box, len(pos), position=pos, skin=0.5)
    with pytest.raises(ValueError, match="per_atom_virial=True"):
        compact.hnemd_fe = FE
    v2.hnemd_fe = None  # switching it off is always allowed
    assert v2.hnemd_fe is None and compact.hnemd_fe is None
