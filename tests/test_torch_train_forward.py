"""The port's NEP trainers vs the JAX package, float64 on the CPU.

The same numpy-made frames (three PbTe frames of 8 and 16 atoms with
random labels, one with a stress), parameter vectors and injected SNES
draws go through both packages: `batched_forward` for a NEP4 model with
ZBL, a dipole and a polarizability model (with the per-atom observable);
`loss_terms`; `per_type_rmses` with and without the energy shift, with
type_weight, force_delta and lambda_shear; `compute_q_scaler`;
`fine_tune_init` and `read_q_scaler_from_nep_txt`; the SNES `evaluate`
and `update` on the same z and thetas, and the port's chunked evaluate
against a loop over single individuals; three `make_gnep_step` steps
through the clipping branch; `make_train_step` with torch.optim.Adam
against optax.adam; `gnep_lr` and `cosine_lr` over a table of steps; and
the texts of loss.out rows, nep.restart, nep.txt and gnep.restart.
Tolerance: 1e-9 relative (atol 1e-12) for every number; the chunked
evaluate against the loop 1e-12; texts byte for byte.  The JAX functions
run jitted with x64 on and matmul precision "highest".
"""

import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gpumd_tpu.app import gnep as JG
from gpumd_tpu.io import nep_input as JI
from gpumd_tpu.potentials.nep import params as JP
from gpumd_tpu.train import dataset as JD
from gpumd_tpu.train import nep_train as JT
from gpumd_tpu.train import snes as JS
from gpumd_tpu_torch.app import gnep as TG
from gpumd_tpu_torch.io import nep_input as TI
from gpumd_tpu_torch.io.xyz import XYZFrame
from gpumd_tpu_torch.potentials.nep import params as TP
from gpumd_tpu_torch.scripts.pbte_train_set import pbte_frames
from gpumd_tpu_torch.train import dataset as TD
from gpumd_tpu_torch.train import nep_train as TT
from gpumd_tpu_torch.train import snes as TS
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-12)
CFG = dict(num_types=2, symbols=("Te", "Pb"), rc_radial=5.0,
           rc_angular=4.0, n_max_radial=3, n_max_angular=3,
           basis_size_radial=3, basis_size_angular=3, l_max=4,
           l_max_4body=2, neurons=8, population_size=4,
           type_weight=(1.0, 2.0), force_delta=0.5, lambda_shear=0.7)
# l_max 2 (the oracle compiles faster); the tensorial models without the
# 4-body invariant: their
# heads, not the invariants, are what they add (the oracle compiles
# faster); "small" serves the optax step
KINDS = {"nep4_zbl": dict(zbl=3.5, l_max=2),
         "dipole": dict(model_type=1, atomic_v=1, l_max=2, l_max_4body=0),
         "polarizability": dict(model_type=2, atomic_v=1, l_max=2,
                                l_max_4body=0),
         "small": dict(l_max=2, l_max_4body=0, n_max_radial=2,
                       n_max_angular=2, neurons=6)}


@contextlib.contextmanager
def oracle():
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        yield


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _cfgs(kind):
    kw = {**CFG, **KINDS[kind]}
    return TI.NepTrainConfig(**kw), JI.NepTrainConfig(**kw)


def _frames(label_scale=1.0):
    """Two 8-atom and one 16-atom PbTe frame, random labels (forces
    scaled by label_scale); the last has a stress and a weight."""
    rng = np.random.default_rng(11)
    out = []
    for k, (pos, types_, edge) in enumerate(pbte_frames(3, 1, seed=12)):
        lat = np.diag([edge] * 3)
        if k == 1:
            pos = np.concatenate([pos, pos + [0, 0, edge]])
            types_ = np.concatenate([types_, types_])
            lat = np.diag([edge, edge, 2 * edge])
        n = len(pos)
        info = {"energy": f"{rng.normal(-3.0 * n, 1.0):.8f}",
                "dipole": "0.3 -0.2 0.1", "pol": "3 1 0 1 2 0.5 0 0.5 4"}
        if k == 2:
            info["stress"] = " ".join(f"{x:.6f}" for x in rng.normal(
                0, 0.01, 6))
            info["weight"] = "1.5"
        else:
            info["virial"] = " ".join(f"{x:.6f}" for x in rng.normal(
                0, 2.0, 9))
        arrays = {"adipole": rng.normal(0, 0.1, (n, 3)),
                  "apol": rng.normal(0, 0.3, (n, 9))}
        out.append(XYZFrame(
            symbols=["Pb" if t else "Te" for t in types_], positions=pos,
            lattice=lat, forces=label_scale * rng.normal(0, 0.5, (n, 3)),
            info=info, arrays=arrays))
    return out


def _batches(frames, model_type):
    jb = JD.batch_structures(frames, ("Te", "Pb"), rc=5.0, mn=40,
                             dtype=np.float64, model_type=model_type)
    tb = TD.batch_structures(frames, ("Te", "Pb"), rc=5.0, mn=40,
                             dtype=torch.float64, model_type=model_type,
                             device="cpu")
    return jb, tb


def _theta(model, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.3, TP.num_trainable(model)),
            rng.uniform(0.5, 1.5, model.dim))


@pytest.fixture(scope="module")
def case():
    """Per kind: (cfgs, models, batches, theta, q_scaler)."""
    out = {}
    frames = _frames()
    for i, kind in enumerate(KINDS):
        tc, jc = _cfgs(kind)
        tm, jm = TI.model_from_config(tc), JI.model_from_config(jc)
        jb, tb = _batches(frames, tc.model_type)
        theta, qs = _theta(tm, i)
        out[kind] = types.SimpleNamespace(tc=tc, jc=jc, tm=tm, jm=jm, jb=jb,
                                          tb=tb, theta=theta, qs=qs)
    return out


def _params(c, theta=None):
    theta = c.theta if theta is None else theta
    with oracle():
        jp = JP.params_from_vector(c.jm, jnp.asarray(theta),
                                   jnp.asarray(c.qs))
    tp = TP.params_from_vector(c.tm, torch.as_tensor(theta),
                               torch.as_tensor(c.qs))
    return jp, tp


@pytest.mark.parametrize("kind", ["nep4_zbl", "dipole", "polarizability"])
def test_forward_loss_and_rmses_match(case, kind):
    c = case[kind]
    jp, tp = _params(c)

    def jax_all(p, b):
        out = JT.batched_forward(c.jm, p, b)
        return (out, JT.loss_terms(c.jm, p, b),
                JS.per_type_rmses(c.jm, c.jc, out, b),
                JS.per_type_rmses(c.jm, c.jc, out, b, use_weight=False,
                                  do_shift=True, return_shift=True))

    with oracle():
        jout, jloss, jr, jrs = jax.jit(jax_all)(jp, c.jb)
    tout = TT.batched_forward(c.tm, tp, c.tb)
    for k in ("energy", "force", "virial", "avirial"):
        a, b = getattr(tout, k), getattr(jout, k)
        assert (a is None) == (b is None), k
        if a is not None:
            _close(a, b, msg=k)
    if kind == "nep4_zbl":
        # the ZBL term is on: without it the forces differ
        bare = dataclasses.replace(c.tm, zbl=False)
        assert float((TT.batched_forward(bare, tp, c.tb).force
                      - tout.force).abs().max()) > 1e-3
    else:
        assert float(tout.virial.abs().max()) > 1e-3
    for got, want in zip(TT.loss_terms(c.tm, tp, c.tb), jloss):
        _close(got, want, msg="loss_terms")
    for got, want in zip(TS.per_type_rmses(c.tm, c.tc, tout, c.tb), jr):
        _close(got, want, msg="rmses")
    got = TS.per_type_rmses(c.tm, c.tc, tout, c.tb, use_weight=False,
                            do_shift=True, return_shift=True)
    for g, w in zip(got, jrs):
        _close(g, w, msg="rmses with the shift")


def test_compute_q_scaler_matches(case):
    c = case["nep4_zbl"]
    theta = np.full(TP.num_trainable(c.tm), 0.7)
    with oracle():
        want = JS.compute_q_scaler(c.jm, theta, [c.jb])
    got = TS.compute_q_scaler(c.tm, theta, [c.tb])
    assert got.dtype == torch.float64
    _close(got, want)


def test_fine_tune_init_matches(tmp_path):
    kw = dict(num_types=2, symbols=("Si", "Ge"), n_max_radial=1,
              n_max_angular=1, basis_size_radial=1, basis_size_angular=1,
              l_max=4, l_max_4body=0, neurons=2,
              fine_tune_nep_txt=str(tmp_path / "nep89.txt"),
              fine_tune_nep_restart=str(tmp_path / "nep89.restart"))
    for desc in (False, True):
        tc = TI.NepTrainConfig(fine_tune_descriptor=desc, **kw)
        jc = JI.NepTrainConfig(fine_tune_descriptor=desc, **kw)
        tm, jm = TI.model_from_config(tc), JI.model_from_config(jc)
        per_ann = (tm.dim + 2) * tm.neurons
        num_tot = 89 * per_ann + 1 + 89 * 89 * 8
        rng = np.random.default_rng(3)
        np.savetxt(tmp_path / "nep89.restart",
                   np.stack([rng.normal(size=num_tot),
                             rng.uniform(size=num_tot)], 1))
        with open(tmp_path / "nep89.txt", "w") as f:
            f.write("".join(f"header{i} x\n" for i in range(7)))
            f.write("0.0\n" * num_tot)
            f.write("".join(f"{v}\n" for v in rng.uniform(size=tm.dim)))
        got, want = TS.fine_tune_init(tm, tc), JS.fine_tune_init(jm, jc)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            TS.read_q_scaler_from_nep_txt(kw["fine_tune_nep_txt"], tm.dim,
                                          num_tot), got[2])
    assert [TS._element_index_89(z) for z in range(-1, 97)] == [
        JS._element_index_89(z) for z in range(-1, 97)]
    np.testing.assert_array_equal(TS.type_of_variable_vector(tm),
                                  JS.type_of_variable_vector(jm))
    np.testing.assert_array_equal(TS._utilities(7), JS._utilities(7))


def _snes_draws(model, seed):
    d = TP.num_trainable(model)
    rng = np.random.default_rng(seed)
    mu = rng.normal(0, 0.3, d)
    sigma = rng.uniform(0.05, 0.2, d)
    z = rng.normal(size=(4, d))
    return mu, sigma, z, mu + sigma * z


def _updates_match(c, mu, sigma, z, thetas, trmses, jrmses, l1, l2):
    """Both packages' update on the same state, z, thetas and RMSEs."""
    with oracle():
        _, _, jupdate = JS.make_population_pieces(c.jm, c.jc, c.qs, l1, l2)
        jstate = JS.SNESState(mu=jnp.asarray(mu), sigma=jnp.asarray(sigma),
                              key=jax.random.PRNGKey(0),
                              generation=jnp.asarray(0, jnp.int32))
        jnew, jmet = jax.jit(jupdate)(jstate, jstate.key, jnp.asarray(z),
                                      jnp.asarray(thetas), *jrmses)
    _, _, tupd = TS.make_population_pieces(c.tm, c.tc, torch.as_tensor(c.qs),
                                           l1, l2)
    state = TS.SNESState(mu=torch.as_tensor(mu),
                         sigma=torch.as_tensor(sigma),
                         generator=torch.Generator(), generation=0)
    new, met = tupd(state, torch.as_tensor(z), torch.as_tensor(thetas),
                    *trmses)
    _close(new.mu, jnew.mu, msg="mu")
    _close(new.sigma, jnew.sigma, msg="sigma")
    assert new.generation == 1 and float(new.sigma.max()) <= 1.0
    for k in jmet:
        _close(met[k], jmet[k], msg=k)


def test_snes_evaluate_and_update_match(case):
    """The same injected z and thetas through both packages' evaluate and
    update; the port's evaluate in chunks of 3 and of the whole population
    equal to a loop over single individuals."""
    c = case["nep4_zbl"]
    mu, sigma, z, thetas = _snes_draws(c.tm, 20)
    with oracle():
        _, jeval, _ = JS.make_population_pieces(c.jm, c.jc, c.qs, 1e-3, 2e-3)
        jr = jax.jit(jeval)(jnp.asarray(thetas), c.jb)
    tth = torch.as_tensor(thetas)
    outs = {}
    for chunk in (None, 3):
        _, tev, _ = TS.make_population_pieces(c.tm, c.tc,
                                              torch.as_tensor(c.qs), 1e-3,
                                              2e-3, chunk=chunk)
        outs[chunk] = tev(tth, c.tb)
    loop = [TS.per_type_rmses(c.tm, c.tc, TT.batched_forward(
        c.tm, TP.params_from_vector(c.tm, th, torch.as_tensor(c.qs)),
        c.tb), c.tb, do_shift=True) for th in tth]
    for i, col in enumerate(zip(*loop)):
        for chunk in (None, 3):
            _close(outs[chunk][i], torch.stack(col),
                   dict(rtol=1e-12, atol=1e-14), f"chunk {chunk}")
        _close(outs[None][i], jr[i], msg="evaluate")
    _updates_match(c, mu, sigma, z, thetas, outs[None], jr, 1e-3, 2e-3)


def test_snes_update_two_heads_matches(case):
    """A polarizability model's vector holds two ANN heads: the update's
    per-class ranking on injected RMSEs."""
    c = case["polarizability"]
    mu, sigma, z, thetas = _snes_draws(c.tm, 21)
    rng = np.random.default_rng(22)
    r = [rng.uniform(0.1, 1.0, (4, 3)) for _ in range(3)] + [
        np.zeros((4, 3))] * 2
    _updates_match(c, mu, sigma, z, thetas, [torch.as_tensor(x) for x in r],
                   [jnp.asarray(x) for x in r], 0.0, 5e-3)


def _gnep_pair(c, label_scale):
    frames = _frames(label_scale)
    jb, tb = _batches(frames, 0)
    jp, _ = _params(c)
    tp = TP.params_from_numpy(
        {k: None if v is None else np.array(v)
         for k, v in jp._asdict().items()}, device="cpu")
    return jb, tb, jp, tp


def test_gnep_steps_match(case):
    """Three steps from the same parameters with forces 30x the usual
    labels: the gradient norm passes 10 and the clipping branch runs."""
    c = case["nep4_zbl"]
    jb, tb, jp, tp = _gnep_pair(c, 30.0)
    w = TT.LossWeights(energy=1.0, force=1.0, virial=0.1)
    with oracle():
        jstep = jax.jit(JT.make_gnep_step(c.jm, JT.LossWeights(*w), 1e-3))
        zeros = jax.tree.map(jnp.zeros_like, jp)
        js = JT.GnepState(params=jp, m=zeros, v=zeros,
                          step=jnp.zeros((), jnp.int32),
                          avg_norm=jnp.asarray(-1.0, jnp.float32))
    tstep = TT.make_gnep_step(c.tm, w, 1e-3)
    zt = TT.with_leaves(tp, [torch.zeros_like(x)
                             for x in TT.param_leaves(tp)])
    ts = TT.GnepState(params=tp, m=zt, v=zt,
                      step=torch.zeros((), dtype=torch.int32),
                      avg_norm=torch.tensor(-1.0))
    for k, lr in enumerate((1e-3, 2e-3, 5e-4)):
        lr32 = float(np.float32(lr))
        with oracle():
            js, jm = jstep(js, jb, jnp.asarray(lr32, jnp.float32))
        ts, tm = tstep(ts, tb, lr32)
        if k == 0:
            assert float(ts.avg_norm) > 10.0  # clipped
        for a, b in zip(TT.param_leaves(ts.params),
                        jax.tree.leaves(js.params)):
            _close(a, b, msg=f"params, step {k + 1}")
        for a, b in zip(TT.param_leaves(ts.m), jax.tree.leaves(js.m)):
            _close(a, b, msg="m")
        for a, b in zip(TT.param_leaves(ts.v), jax.tree.leaves(js.v)):
            _close(a, b, msg="v")
        _close(ts.avg_norm, js.avg_norm, msg="avg_norm")
        assert int(ts.step) == int(js.step) == k + 1
        for key in jm:
            _close(tm[key], jm[key], msg=key)


def test_train_step_adam_matches_optax(case):
    c = case["small"]
    jb, tb, jp, tp = _gnep_pair(c, 1.0)
    w = TT.LossWeights(energy=1.0, force=2.0, virial=0.3)
    with oracle():
        opt = optax.adam(3e-3, b1=0.9, b2=0.999, eps=1e-8)
        jstep = jax.jit(JT.make_train_step(c.jm, JT.LossWeights(*w), opt))
        js = JT.TrainState(params=jp, opt_state=opt.init(jp),
                           step=jnp.zeros((), jnp.int32))
    leaves = [x.clone().requires_grad_(True) for x in TT.param_leaves(tp)]
    topt = torch.optim.Adam(leaves, lr=3e-3, betas=(0.9, 0.999), eps=1e-8)
    tstep = TT.make_train_step(c.tm, w, topt)
    ts = TT.TrainState(params=TT.with_leaves(tp, leaves), opt_state={},
                       step=0)
    for _ in range(2):
        with oracle():
            js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        for a, b in zip(TT.param_leaves(ts.params),
                        jax.tree.leaves(js.params)):
            _close(a, b, msg="params")
        for key in jm:
            _close(tm[key], jm[key], msg=key)
    assert ts.step == 2 and len(ts.opt_state) == len(leaves)


def test_lr_schedules_match():
    base = dict(num_types=1, symbols=("Si",), start_lr=2e-3, stop_lr=1e-6)
    for extra in (dict(), dict(lr_restart_enable=True),
                  dict(lr_restart_enable=True, lr_warmup_epochs=2,
                       lr_restart_initial_period_epochs=3,
                       lr_restart_period_factor=1.5,
                       lr_restart_decay_factor=0.6)):
        tc = TI.NepTrainConfig(**base, **extra)
        jc = JI.NepTrainConfig(**base, **extra)
        for nb, total in ((1, 30), (3, 90), (4, 7)):
            for step in range(total + 2):
                assert TT.gnep_lr(step, nb, total, tc) == JT.gnep_lr(
                    step, nb, total, jc), (extra, nb, step)
    with oracle():
        for warmup in (0, 5):
            for step in (0, 1, 3, 5, 17, 40, 41, 60):
                want = float(JT.cosine_lr(step, 40, 2e-3, 1e-5, warmup))
                assert TT.cosine_lr(step, 40, 2e-3, 1e-5, warmup) == \
                    pytest.approx(want, rel=1e-15)


def test_written_texts_match(case, tmp_path):
    """loss.out rows (NEP with and without test columns, tensorial),
    nep.restart, nep.txt, gnep.restart and params_to_vector: byte for
    byte."""
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    rng = np.random.default_rng(30)
    for kind, rows in (("nep4_zbl", ([10] + list(rng.uniform(0, 2, 6)),
                                     [20] + list(rng.uniform(0, 2, 9)))),
                       ("dipole", ([30] + list(rng.uniform(0, 2, 6)),
                                   [40] + list(rng.uniform(0, 2, 9))))):
        c = case[kind]
        for model, cls, sub in ((c.tm, TS.SNESTrainer, "t"),
                                (c.jm, JS.SNESTrainer, "j")):
            fake = types.SimpleNamespace(model=model,
                                         workdir=str(tmp_path / sub))
            for row in rows:
                cls._write_loss_row(fake, row)
    t, j = tmp_path / "t", tmp_path / "j"
    assert (t / "loss.out").read_bytes() == (j / "loss.out").read_bytes()
    assert len((t / "loss.out").read_text().splitlines()[0].split()) == 10

    c = case["nep4_zbl"]
    d = TP.num_trainable(c.tm)
    mu, sigma = rng.normal(size=d), rng.uniform(size=d)
    for cls, sub, conv in ((TS.SNESTrainer, "t", torch.as_tensor),
                           (JS.SNESTrainer, "j", jnp.asarray)):
        fake = types.SimpleNamespace(
            model=c.tm if sub == "t" else c.jm, workdir=str(tmp_path / sub),
            state=types.SimpleNamespace(mu=conv(mu), sigma=conv(sigma)),
            best_theta=mu, q_scaler=conv(c.qs))
        cls.save_restart(fake)
        cls.save_potential(fake)
    for name in ("nep.restart", "nep.txt"):
        assert (t / name).read_bytes() == (j / name).read_bytes(), name
    jp, tp = _params(c)
    np.testing.assert_array_equal(TG.params_to_vector(c.tm, tp),
                                  JG.params_to_vector(c.jm, jp))
    np.testing.assert_allclose(TG.params_to_vector(c.tm, tp), c.theta,
                               rtol=0, atol=0)
    zt = TT.with_leaves(tp, [torch.ones_like(x) for x in
                             TT.param_leaves(tp)])
    TG._checkpoint(str(t), c.tm, TT.GnepState(
        params=tp, m=zt, v=zt, step=torch.tensor(3, dtype=torch.int32),
        avg_norm=torch.tensor(2.5)), torch.as_tensor(c.qs), 4,
        str(t / "gnep.restart"), str(t / "gnep_adam.npz"))
    with oracle():
        zj = jax.tree.map(jnp.ones_like, jp)
        JG._checkpoint(str(j), c.jm, JT.GnepState(
            params=jp, m=zj, v=zj, step=jnp.asarray(3, jnp.int32),
            avg_norm=jnp.asarray(2.5, jnp.float32)), np.asarray(c.qs), 4,
            str(j / "gnep.restart"), str(j / "gnep_adam.npz"))
    for name in ("nep.txt", "gnep.restart"):
        assert (t / name).read_bytes() == (j / name).read_bytes(), name
    zt_, zj_ = np.load(t / "gnep_adam.npz"), np.load(j / "gnep_adam.npz")
    assert set(zt_.files) == set(zj_.files)
    for k in zj_.files:
        np.testing.assert_array_equal(zt_[k], zj_[k], err_msg=k)
