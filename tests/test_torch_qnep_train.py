"""The port's qNEP trainers (charge_mode 1 and 2) against the JAX package,
float64 on the CPU.

Three rattled NaCl frames (8 atoms in a cubic cell, 16 in a sheared one,
8 with a total charge of 1) with random energies, forces and Born charges
on two of them go through both packages: the batches' k-vectors, G(k),
charge and BEC labels; `batched_forward` (energy, force, virial, the raw
charge sum and the Born charges); `per_type_rmses` with its charge and
BEC RMSEs; the SNES `evaluate` and `update` on injected z and thetas (the
fitness with its lambda_q and lambda_z terms); and SNESTrainer.train()'s
loss.out rows with JAX's draws injected.  The port's train_fused writes
train()'s 14 columns; the JAX package's fused loop writes 12 on a
one-batch set (pinned).  Tolerance: 1e-9 relative (atol 1e-12) for every
number; loss.out rows at its 5 printed decimals.  The JAX functions run
jitted with x64 on and matmul precision "highest".
"""

import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.io import nep_input as JI
from gpumd_tpu.io.xyz import XYZFrame as JFrame
from gpumd_tpu.potentials.nep import params as JP
from gpumd_tpu.train import dataset as JD
from gpumd_tpu.train import nep_train as JT
from gpumd_tpu.train import snes as JS
from gpumd_tpu_torch.app import gnep as TG
from gpumd_tpu_torch.io import nep_input as TI
from gpumd_tpu_torch.io.xyz import XYZFrame
from gpumd_tpu_torch.potentials.nep import params as TP
from gpumd_tpu_torch.train import dataset as TD
from gpumd_tpu_torch.train import nep_train as TT
from gpumd_tpu_torch.train import snes as TS
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-12)
SYMBOLS = ("Na", "Cl")
CFG = dict(num_types=2, symbols=SYMBOLS, rc_radial=5.0, rc_angular=4.0,
           n_max_radial=2, n_max_angular=2, basis_size_radial=2,
           basis_size_angular=2, l_max=2, l_max_4body=0, neurons=4,
           population_size=8, maximum_generation=4, output_interval=2,
           batch_size=10, lambda_q=0.7, lambda_z=0.9)
MN = 60


@contextlib.contextmanager
def oracle():
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        yield


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _frames():
    """Two rocksalt cells of 8 atoms (one with total charge 1) and one of
    16 in a sheared cell; BEC labels on the first and the third."""
    rng = np.random.default_rng(5)
    a0 = 5.64
    fcc = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    out = []
    for k in range(3):
        frac = np.concatenate([fcc, fcc + [.5, 0, 0]])
        sym = ["Na"] * 4 + ["Cl"] * 4
        lat = np.eye(3) * a0
        if k == 2:
            frac = np.concatenate([frac * [0.5, 1, 1],
                                   frac * [0.5, 1, 1] + [.5, 0, 0]])
            sym = sym * 2
            lat = np.array([[2 * a0, 0, 0], [0.6, a0, 0], [0, 0.4, a0]])
        pos = frac @ lat + rng.normal(0, 0.08, (len(sym), 3))
        n = len(sym)
        info = {"energy": f"{rng.normal(-3.0 * n, 1.0):.8f}",
                "charge": "1" if k == 1 else "0",
                "virial": " ".join(f"{x:.6f}" for x in rng.normal(0, 2, 9))}
        arrays = {}
        if k != 1:
            sign = np.where(np.array(sym) == "Na", 1.0, -1.0)
            arrays["bec"] = (np.eye(3).ravel()[None] * sign[:, None]
                             + rng.normal(0, 0.1, (n, 9)))
        out.append(dict(symbols=sym, positions=pos, lattice=lat,
                        forces=rng.normal(0, 0.5, (n, 3)), info=info,
                        arrays=arrays))
    return out


def _frame_objs(raw, cls):
    return [cls(symbols=f["symbols"], positions=f["positions"],
                lattice=f["lattice"], pbc=(True, True, True),
                forces=f["forces"], info=dict(f["info"]),
                arrays=dict(f["arrays"])) for f in raw]


@pytest.fixture(scope="module", params=[1, 2], ids=["mode1", "mode2"])
def case(request):
    mode = request.param
    kw = dict(CFG, charge_mode=mode)
    tc, jc = TI.NepTrainConfig(**kw), JI.NepTrainConfig(**kw)
    tm, jm = TI.model_from_config(tc), JI.model_from_config(jc)
    raw = _frames()
    jb = JD.batch_structures(_frame_objs(raw, JFrame), SYMBOLS, rc=5.0,
                             mn=MN, dtype=np.float64, charge_mode=mode)
    tb = TD.batch_structures(_frame_objs(raw, XYZFrame), SYMBOLS, rc=5.0,
                             mn=MN, dtype=torch.float64, charge_mode=mode,
                             device="cpu")
    rng = np.random.default_rng(10 + mode)
    d = TP.num_trainable(tm)
    theta = rng.normal(0, 0.3, d)
    qs = rng.uniform(0.5, 1.5, tm.dim)
    return types.SimpleNamespace(mode=mode, tc=tc, jc=jc, tm=tm, jm=jm,
                                 jb=jb, tb=tb, theta=theta, qs=qs, d=d)


def _params(c, theta):
    with oracle():
        jp = JP.params_from_vector(c.jm, jnp.asarray(theta),
                                   jnp.asarray(c.qs))
    return jp, TP.params_from_vector(c.tm, torch.as_tensor(theta),
                                     torch.as_tensor(c.qs))


def test_charge_batches_match(case):
    c = case
    for k in ("kvec", "gk", "position", "charge_ref", "bec_ref", "has_bec",
              "r12", "nbr_mask", "energy_ref", "force_ref"):
        got, want = getattr(c.tb, k), getattr(c.jb, k)
        if k in ("r12", "nbr_mask"):  # the port trims all-padding columns
            want = np.asarray(want)[:, :, :got.shape[2]]
        _close(got, want, msg=k)
    assert c.tb.kvec.shape[1] > 20 and float(c.tb.gk.max()) > 0.0
    # the sheared cell enumerates its own k-vectors; the others pad
    assert float(c.tb.gk[0].count_nonzero()) < c.tb.kvec.shape[1]


def test_charge_forward_and_rmses_match(case):
    c = case
    jp, tp = _params(c, c.theta)

    def jax_all(p, b):
        out = JT.batched_forward(c.jm, p, b)
        return (out, JS.per_type_rmses(c.jm, c.jc, out, b),
                JS.per_type_rmses(c.jm, c.jc, out, b, use_weight=False,
                                  do_shift=True, return_shift=True))

    with oracle():
        jout, jr, jrs = jax.jit(jax_all)(jp, c.jb)
    tout = TT.batched_forward(c.tm, tp, c.tb)
    for k in ("energy", "force", "virial", "qsum", "bec"):
        _close(getattr(tout, k), getattr(jout, k), msg=k)
    assert float(tout.bec.abs().max()) > 1e-2
    assert float(tout.qsum.abs().max()) > 1e-3
    for got, want in zip(TS.per_type_rmses(c.tm, c.tc, tout, c.tb), jr):
        _close(got, want, msg="rmses")
    got = TS.per_type_rmses(c.tm, c.tc, tout, c.tb, use_weight=False,
                            do_shift=True, return_shift=True)
    for g, w in zip(got, jrs):
        _close(g, w, msg="rmses with the shift")
    assert float(got[3][-1]) > 0 and float(got[4][-1]) > 0


def test_charge_fitness_matches(case):
    """A population of thetas: evaluate (the charge and BEC RMSEs among
    them) and the update's fitness with lambda_q and lambda_z."""
    c = case
    rng = np.random.default_rng(20 + c.mode)
    mu = rng.normal(0, 0.3, c.d)
    sigma = rng.uniform(0.05, 0.2, c.d)
    z = rng.normal(size=(8, c.d))
    thetas = mu + sigma * z
    with oracle():
        _, jeval, jupdate = JS.make_population_pieces(c.jm, c.jc, c.qs,
                                                      1e-3, 2e-3)
        jr = jax.jit(jeval)(jnp.asarray(thetas), c.jb)
        jstate = JS.SNESState(mu=jnp.asarray(mu), sigma=jnp.asarray(sigma),
                              key=jax.random.PRNGKey(0),
                              generation=jnp.asarray(0, jnp.int32))
        jnew, jmet = jax.jit(jupdate)(jstate, jstate.key, jnp.asarray(z),
                                      jnp.asarray(thetas), *jr)
    _, tev, tupd = TS.make_population_pieces(
        c.tm, c.tc, torch.as_tensor(c.qs), 1e-3, 2e-3, chunk=3)
    tr = tev(torch.as_tensor(thetas), c.tb)
    for i, (g, w) in enumerate(zip(tr, jr)):
        _close(g, w, msg=f"evaluate {i}")
    state = TS.SNESState(mu=torch.as_tensor(mu), sigma=torch.as_tensor(sigma),
                         generator=torch.Generator(), generation=0)
    new, met = tupd(state, torch.as_tensor(z), torch.as_tensor(thetas), *tr)
    _close(new.mu, jnew.mu, msg="mu")
    _close(new.sigma, jnew.sigma, msg="sigma")
    for k in jmet:
        _close(met[k], jmet[k], msg=k)
    assert float(met["rmse_q"]) > 0 and float(met["rmse_b"]) > 0


def _jax_zs(c, n_gen):
    key, zs = jax.random.PRNGKey(c.tc.seed), []
    for _ in range(n_gen):
        key, sub = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(sub, (8, c.d), jnp.float64)))
    return zs


def _inject(monkeypatch, zs):
    orig = TS.make_population_pieces

    def injected(*args, **kw):
        _, evaluate, update = orig(*args, **kw)

        def sample(state):
            z = torch.as_tensor(np.array(zs.pop(0)), dtype=state.mu.dtype)
            return z, state.mu[None, :] + state.sigma[None, :] * z
        return sample, evaluate, update

    monkeypatch.setattr(TS, "make_population_pieces", injected)


def _rows(path):
    return np.atleast_2d(np.loadtxt(path))


def test_train_rows_match_jax(case, tmp_path, monkeypatch):
    """train() for 4 generations, JAX's draws injected: loss.out rows 2 and
    4 of 14 columns equal the JAX trainer's; then the port's train_fused
    on the same draws writes the same 14-column rows, while the JAX
    package's fused loop writes 12 (its charge and BEC columns missing)."""
    c = case
    for sub in "jtf":
        (tmp_path / sub).mkdir()
    with oracle():
        jt = JS.SNESTrainer(c.jm, c.jc, [c.jb], workdir=str(tmp_path / "j"),
                            dtype=jnp.float64)
        jt.train(log=lambda *a, **k: None)
    _inject(monkeypatch, _jax_zs(c, 4))
    tt = TS.SNESTrainer(c.tm, c.tc, [c.tb], workdir=str(tmp_path / "t"),
                        dtype=torch.float64)
    tt.train(log=lambda *a, **k: None)
    _inject(monkeypatch, _jax_zs(c, 4))
    tf = TS.SNESTrainer(c.tm, c.tc, [c.tb], workdir=str(tmp_path / "f"),
                        dtype=torch.float64)
    tf.train_fused(log=lambda *a, **k: None)
    got, want = _rows(tmp_path / "t" / "loss.out"), _rows(
        tmp_path / "j" / "loss.out")
    assert got.shape == want.shape == (2, 14)
    np.testing.assert_allclose(got, want, rtol=0, atol=1.5e-5)
    assert np.all(got[:, 7:9] > 0)  # the charge and BEC RMSEs
    fused = _rows(tmp_path / "f" / "loss.out")
    np.testing.assert_array_equal(fused, got)
    # the JAX package's fused loop on a one-batch charge set: 12 columns
    # (ROADMAP queue 3; the port writes train()'s row)
    if c.mode == 1:
        with oracle():
            (tmp_path / "jf").mkdir()
            jf = JS.SNESTrainer(c.jm, c.jc, [c.jb],
                                workdir=str(tmp_path / "jf"),
                                dtype=jnp.float64)
            jf.train_fused(log=lambda *a, **k: None)
        assert _rows(tmp_path / "jf" / "loss.out").shape[1] == 12


def test_population_chunk_counts_the_ewald_terms(case):
    """A qNEP batch's (atom, k) terms add to an individual's bytes, which
    size the population chunk on the card: the same batch without its
    k-vectors holds more individuals, a wider k set fewer."""
    c = case
    with_k = TS.individual_bytes(c.tb)
    without = TS.individual_bytes(c.tb._replace(kvec=None))
    per_k = TS.BYTES_PER_KTERM * c.tb.mask.numel() * c.tb.kvec.shape[1]
    assert without == TS.BYTES_PER_SLOT * c.tb.idx.numel()
    assert with_k == without + per_k > without
    wide = c.tb._replace(kvec=torch.zeros(3, 4 * c.tb.kvec.shape[1], 3))
    assert TS.individual_bytes(wide) == without + 4 * per_k
    # off the card: the whole population
    assert TS.population_chunk(17, c.tb) == 17


def test_gnep_refuses_charge_mode(tmp_path):
    (tmp_path / "nep.in").write_text("type 2 Na Cl\ncharge_mode 1\n")
    with pytest.raises(ValueError, match="charge_mode 1"):
        TG.main([str(tmp_path)], device="cpu")


def _write_train_xyz(path):
    """_frames() as a train.xyz (energy, virial, charge, forces, bec)."""
    lines = []
    for f in _frames():
        n = len(f["symbols"])
        lat = " ".join(f"{x:.10f}" for x in np.asarray(f["lattice"]).ravel())
        props = "species:S:1:pos:R:3:force:R:3"
        bec = f["arrays"].get("bec")
        if bec is not None:
            props += ":bec:R:9"
        info = " ".join(f'{k}="{v}"' for k, v in f["info"].items())
        lines += [str(n), f'Lattice="{lat}" Properties={props} pbc="T T T" '
                  + info]
        for i in range(n):
            row = [f["symbols"][i], *f["positions"][i], *f["forces"][i]]
            if bec is not None:
                row += list(bec[i])
            lines.append(" ".join(str(x) if isinstance(x, str)
                                  else f"{x:.10f}" for x in row))
    path.write_text("\n".join(lines) + "\n")


NEP_IN = ("type 2 Na Cl\ncutoff 5 4\nn_max 2 2\nbasis_size 2 2\n"
          "l_max 2 0 0\nneuron 4\ncharge_mode 1\n")


def test_nep_app_trains_and_predicts_a_charge_model(tmp_path):
    """app.nep trains a charge_mode 1 model (loss.out rows of 14 columns,
    charge and BEC RMSEs above zero); prediction on its nep.txt writes
    energy/force/virial_train.out equal to the JAX package's qNEP forward
    on the same file (its NEPCharge loader) in float32, to 1e-6 relative
    plus 2e-6 of the file's largest value (1e-5 for the forces and
    virials, whose reciprocal sums cancel).  The JAX app's prediction mode
    reads nep.txt with the plain loader, which refuses a charge model
    (pinned)."""
    from gpumd_tpu.app import nep as jnep
    from gpumd_tpu.potentials.nep.charge import NEPCharge as JCharge
    from gpumd_tpu_torch.app import nep as tnep

    d = tmp_path / "src"
    d.mkdir()
    _write_train_xyz(d / "train.xyz")
    (d / "nep.in").write_text(
        NEP_IN + "population 4\ngeneration 2\noutput_interval 2\n")
    tnep.main([str(d)], device="cpu")
    rows = _rows(d / "loss.out")
    assert rows.shape == (1, 14) and np.isfinite(rows).all()
    assert np.all(rows[0, 7:9] > 0)
    (d / "nep.in").write_text(NEP_IN + "prediction 1\n")
    assert tnep.main([str(d)], device="cpu") is None
    old = jax.config.jax_default_matmul_precision
    try:
        with pytest.raises(NotImplementedError, match="qNEP"):
            jnep.main([str(d)])
    finally:
        jax.config.update("jax_default_matmul_precision", old)
    pot = JCharge.from_file(str(d / "nep.txt"), dtype=jnp.float32)
    params = pot.params._replace(w1_charge=pot.w1_charge,
                                 sqrt_epsilon_inf=pot.sqrt_epsilon_inf)
    jb = JD.batch_structures(_frame_objs(_frames(), JFrame), SYMBOLS,
                             rc=5.0, mn=200, dtype=np.float32, charge_mode=1)
    # the loader's model does not carry charge_mode: the forward's does
    model = dataclasses.replace(pot.model, charge_mode=1)
    out = jax.jit(JT.batched_forward, static_argnums=0)(model, params, jb)
    na = np.asarray(jb.n_atoms, np.float64)
    want = {"energy_train.out": np.stack(
                [np.asarray(out.energy) / na,
                 np.asarray(jb.energy_ref) / na], 1),
            "virial_train.out": np.concatenate(
                [np.asarray(out.virial) / na[:, None],
                 np.asarray(jb.virial_ref) / na[:, None]], 1),
            "force_train.out": np.concatenate(
                [np.concatenate([np.asarray(out.force)[c, :int(na[c])]
                                 for c in range(3)]),
                 np.concatenate([np.asarray(jb.force_ref)[c, :int(na[c])]
                                 for c in range(3)])], 1)}
    for name, w in want.items():
        got = np.loadtxt(d / name)
        assert got.shape == w.shape, name
        # the forces' and virials' Ewald sums cancel to ~1/10 of their
        # terms: 1e-5
        share = 2e-6 if name.startswith("energy") else 1e-5
        bound = 1e-6 * np.abs(w) + share * np.abs(w).max()
        assert np.max(np.abs(got - w) / bound) <= 1.0, name
