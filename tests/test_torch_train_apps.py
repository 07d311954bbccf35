"""The port's trainer entry points on the CPU, at a tiny size.

`app.nep.main` trains SNES on three 8-atom PbTe frames labelled by a
random NEP through the port's list path: loss.out has 10-column rows at
the output_interval boundaries, nep.txt and nep.restart are written, and
a rerun with a larger `generation` resumes the numbering (row 6 after
rows 2 and 4) without replaying generation 0's draws.  Prediction mode
writes energy/force/virial_train.out equal to the JAX app's files on the
same nep.txt and train.xyz to 1e-6 relative plus 2e-6 of the file's
largest value (both in float32).  `app.gnep.main` writes loss.out
(epochs, 10), and a run stopped after epoch 2 and resumed writes the same
rows (up to the wall-time column), nep.txt and gnep.restart byte for byte
as a straight run.  Without device="cpu" the apps refuse to run on a
machine with no card.
"""

import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gpumd_tpu_torch.app import gnep as tgnep
from gpumd_tpu_torch.app import nep as tnep
from gpumd_tpu_torch.io.nep_input import NepTrainConfig, model_from_config
from gpumd_tpu_torch.potentials.nep.model import NEP
from gpumd_tpu_torch.potentials.nep.params import random_params
from gpumd_tpu_torch.scripts.pbte_train_set import write_train_set
from gpumd_tpu_torch.train.snes import _generator
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

ARCH = ("type 2 Te Pb\ncutoff 5 4\nn_max 3 3\nbasis_size 3 3\n"
        "l_max 4 2 0\nneuron 8\n")


@pytest.fixture(scope="module")
def train_xyz(tmp_path_factory):
    """Three 8-atom PbTe frames labelled by a random NEP of ARCH."""
    d = tmp_path_factory.mktemp("set")
    cfg = NepTrainConfig(num_types=2, symbols=("Te", "Pb"), rc_radial=5.0,
                         rc_angular=4.0, n_max_radial=3, n_max_angular=3,
                         basis_size_radial=3, basis_size_angular=3,
                         neurons=8)
    model = model_from_config(cfg)
    nep = NEP(model, random_params(model, seed=4, dtype=torch.float64,
                                   device="cpu"))
    write_train_set(d / "train.xyz", nep, n_frames=3, cells=1, seed=5,
                    device="cpu")
    return d / "train.xyz"


def _workdir(path, train_xyz, nep_in):
    path.mkdir()
    shutil.copy(train_xyz, path / "train.xyz")
    (path / "nep.in").write_text(ARCH + nep_in)
    return path


def _rows(path):
    return np.atleast_2d(np.loadtxt(path / "loss.out"))


def test_nep_app_trains_and_resumes(tmp_path, train_xyz):
    d = _workdir(tmp_path / "run", train_xyz,
                 "population 4\ngeneration 4\noutput_interval 2\n")
    trainer = tnep.main([str(d)], device="cpu")
    rows = _rows(d)
    assert rows.shape == (2, 10) and list(rows[:, 0]) == [2, 4]
    assert np.isfinite(rows).all() and (rows[:, 7:] == 0).all()
    assert trainer.state.generation == 4
    for name in ("nep.txt", "nep.restart"):
        assert (d / name).exists()
    restart = np.loadtxt(d / "nep.restart")
    assert restart.shape == (trainer.d, 2)
    nep = NEP.from_file(str(d / "nep.txt"), device="cpu")
    assert nep.model.symbols == ("Te", "Pb") and nep.model.neurons == 8
    (d / "nep.in").write_text(ARCH + "population 4\ngeneration 6\n"
                              "output_interval 2\n")
    resumed = tnep.main([str(d)], device="cpu")
    rows = _rows(d)
    assert list(rows[:, 0]) == [2, 4, 6] and rows.shape[1] == 10
    assert resumed.gen_offset == 4 and resumed.state.generation == 6
    # the resumed run's first draws are not generation 0's
    assert not torch.equal(
        torch.randn(8, generator=_generator(12345678, 0, "cpu")),
        torch.randn(8, generator=_generator(12345678, 4, "cpu")))


@pytest.fixture
def restore_matmul_precision():
    """The JAX app sets the default matmul precision for the process;
    put it back for the tests after this one."""
    old = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", old)


def test_nep_prediction_matches_jax_app(tmp_path, train_xyz, monkeypatch,
                                        restore_matmul_precision):
    from gpumd_tpu.app import nep as jnep

    # the JAX app's forward jitted (op by op it takes ~15 s here)
    monkeypatch.setattr(jnep, "batched_forward",
                        jax.jit(jnep.batched_forward, static_argnums=0))

    src = _workdir(tmp_path / "src", train_xyz,
                   "population 4\ngeneration 2\noutput_interval 2\n")
    tnep.main([str(src)], device="cpu")
    dirs = {}
    for name in ("t", "j"):
        d = _workdir(tmp_path / name, train_xyz, "prediction 1\n")
        shutil.copy(src / "nep.txt", d / "nep.txt")
        dirs[name] = d
    assert tnep.main([str(dirs["t"])], device="cpu") is None
    jnep.main([str(dirs["j"])])
    for out in ("energy_train.out", "force_train.out", "virial_train.out"):
        got = np.loadtxt(dirs["t"] / out)
        want = np.loadtxt(dirs["j"] / out)
        assert got.shape == want.shape and got.size, out
        # both in float32, whose sums with cancellation round to ~1e-6 of
        # the quantity's largest value (a virial's shear to its diagonal's)
        bound = 1e-6 * np.abs(want) + 2e-6 * np.abs(want).max()
        worst = np.max(np.abs(got - want) / bound)
        assert worst <= 1.0, (out, worst)


def test_gnep_app_resume_equals_straight_run(tmp_path, train_xyz):
    nep_in = "batch 2\nepoch 3\nstart_lr 5e-3\nstop_lr 1e-4\n"
    a = _workdir(tmp_path / "a", train_xyz, nep_in)
    b = _workdir(tmp_path / "b", train_xyz, nep_in)
    tgnep.main([str(a)], device="cpu")
    tgnep.main([str(b)], stop_after=2, device="cpu")
    assert _rows(b).shape == (2, 10)
    tgnep.main([str(b)], device="cpu")
    rows = _rows(a)
    assert rows.shape == (3, 10) and list(rows[:, 0]) == [1, 2, 3]
    assert np.isfinite(rows).all() and (rows[:, 5:8] == 0).all()
    # equal text up to the last column, the epoch's wall time
    cut = 8 + 7 * 13 + 15
    la = [ln[:cut] for ln in (a / "loss.out").read_text().splitlines()]
    lb = [ln[:cut] for ln in (b / "loss.out").read_text().splitlines()]
    assert la == lb
    for name in ("nep.txt", "gnep.restart"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    NEP.from_file(str(a / "nep.txt"), device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("app", [tnep, tgnep])
def test_apps_refuse_without_a_card(tmp_path, train_xyz, app):
    d = _workdir(tmp_path / "d", train_xyz, "generation 1\nepoch 1\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main([str(d)])
    assert not Path(d / "loss.out").exists()


def test_train_fused_runs_whole_intervals_as_jax(tmp_path, train_xyz,
                                                 monkeypatch,
                                                 restore_matmul_precision):
    """generation 25 at output_interval 10: both packages' apps train 30
    generations and write loss.out rows 10, 20 and 30; with JAX's z draws
    injected into the port, the final nep.restart (mu, sigma) agrees to
    the prediction test's bound."""
    import jax.numpy as jnp

    from gpumd_tpu.app import nep as jnep
    from gpumd_tpu_torch.io.nep_input import parse_nep_in
    from gpumd_tpu_torch.potentials.nep.params import num_trainable
    from gpumd_tpu_torch.train import snes as tsnes

    # population 8: the JAX trainer rounds it up to a multiple of the
    # suite's 8 virtual devices
    nep_in = "population 8\ngeneration 25\noutput_interval 10\n"
    dirs = {k: _workdir(tmp_path / k, train_xyz, nep_in) for k in "tj"}
    jnep.main([str(dirs["j"])])
    model = model_from_config(parse_nep_in(str(dirs["t"] / "nep.in")))
    key, zs = jax.random.PRNGKey(12345678), []  # nep.in's default seed
    for _ in range(30):
        key, sub = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(
            sub, (8, num_trainable(model)), jnp.float32)))
    orig = tsnes.make_population_pieces

    def injected(*args, **kw):
        _, evaluate, update = orig(*args, **kw)

        def sample(state):
            z = torch.as_tensor(np.array(zs.pop(0)), dtype=state.mu.dtype)
            return z, state.mu[None, :] + state.sigma[None, :] * z
        return sample, evaluate, update

    monkeypatch.setattr(tsnes, "make_population_pieces", injected)
    trainer = tnep.main([str(dirs["t"])], device="cpu")
    assert not zs and trainer.state.generation == 30
    for k in "tj":
        rows = _rows(dirs[k])
        assert list(rows[:, 0]) == [10, 20, 30] and rows.shape[1] == 10, k
    got, want = (np.loadtxt(dirs[k] / "nep.restart") for k in "tj")
    bound = 1e-6 * np.abs(want) + 2e-6 * np.abs(want).max()
    assert np.max(np.abs(got - want) / bound) <= 1.0
