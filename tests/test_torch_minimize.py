"""The port's minimizers (gpumd_tpu_torch/minimize/minimizers.py) against
the JAX package's on the CPU in float64: steepest descent, FIRE and FIRE
with the box (anisotropic and hydrostatic) on rattled LJ argon.  Each
stops at JAX's step, with positions within 1e-8 A (minimum image) and the
energy within 1e-9 eV of JAX's; the `minimize` keyword logs the same step
count and energy through both apps."""

import re

import jax
import numpy as np
import pytest
import torch

from gpumd_tpu.forcefield import ForceField as JFF
from gpumd_tpu.io.xyz import XYZFrame, write_xyz
from gpumd_tpu.minimize import minimizers as jmin
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.potentials.lj import LJ as JLJ
from gpumd_tpu_torch.forcefield import ForceField
from gpumd_tpu_torch.minimize import minimizers as tmin
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.potentials.lj import LJ
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

LJ_PARAMS = (1.032e-2, 3.405, 9.0)  # the repo's lj.txt
MASS = 39.948
POS_TOL = 1e-8  # A
E_TOL = 1e-9  # eV


def rattled_argon(a0=5.26, nc=2, rattle=0.1, seed=3):
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    cells = np.array([[i, j, k] for i in range(nc) for j in range(nc)
                      for k in range(nc)])
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    pos = pos + np.random.default_rng(seed).normal(0, rattle, pos.shape)
    return pos, np.full(3, nc * a0)


def both(a0=5.26):
    """(JAX state, JAX force field, port state, port force field) of the
    same rattled argon."""
    pos, lengths = rattled_argon(a0)
    n = len(pos)
    jbox = JBox.orthogonal(lengths)
    jst = jmake_state(pos, np.full(n, MASS), np.zeros(n, int), jbox)
    jff = JFF.create([JLJ.from_params(*LJ_PARAMS)], jbox, n, mn=128)
    box = Box.orthogonal(lengths, device="cpu")
    st = make_state(pos, np.full(n, MASS), np.zeros(n, int), box)
    ff = ForceField.create([LJ.from_params(*LJ_PARAMS, device="cpu")], box,
                           n, mn=128)
    return jst, jff, st, ff


def assert_same(st, jst, steps, jsteps):
    assert steps == int(jsteps)
    dx = st.box.minimum_image(st.position - torch.as_tensor(
        np.array(jst.position), dtype=torch.float64))
    assert float(dx.abs().max()) <= POS_TOL
    e = float(torch.sum(st.potential_energy * st.mask))
    je = float(np.sum(np.asarray(jst.potential_energy)
                      * np.asarray(jst.mask)))
    assert abs(e - je) <= E_TOL, (e, je)
    np.testing.assert_allclose(st.box.h.numpy(), np.asarray(jst.box.h),
                               rtol=0, atol=POS_TOL)


@pytest.mark.parametrize("name, tol, max_steps, a0, kw", [
    ("sd", 1e-4, 400, 5.26, {}),
    ("fire", 1e-5, 400, 5.26, {}),
    ("fire_box", 1e-4, 400, 5.1, {}),
    ("fire_box", 1e-4, 400, 5.1, {"hydrostatic": True}),
], ids=["sd", "fire", "fire_box", "fire_box_hydrostatic"])
def test_minimizer_stops_where_jax_stops(name, tol, max_steps, a0, kw):
    jst, jff, st, ff = both(a0)
    jfn = getattr(jmin, f"minimize_{name}")
    jout, jsteps = jax.jit(lambda s: jfn(jff, s, tol, max_steps, **kw))(jst)
    out, steps = getattr(tmin, f"minimize_{name}")(ff, st, tol, max_steps,
                                                   **kw)
    # converged short of the step cap: the stop test decided
    assert 0 < steps < max_steps
    assert_same(out, jout, steps, jsteps)


def _argon_deck(d, deck):
    d.mkdir()
    pos, lengths = rattled_argon(nc=2, seed=1)
    write_xyz(str(d / "model.xyz"), XYZFrame(
        symbols=["Ar"] * len(pos), positions=pos, lattice=np.diag(lengths),
        pbc=(True, True, True)))
    (d / "lj.txt").write_text("lj 1 Ar\n{} {} {}\n".format(*LJ_PARAMS))
    (d / "run.in").write_text(deck)


@pytest.mark.parametrize("line", ["fire 1.0e-4 1000", "fire 1.0e-4 300 1 1"],
                         ids=["fire", "fire_box_hydrostatic"])
def test_minimize_keyword_logs_jax_steps_and_energy(tmp_path, capsys, line):
    import gpumd_tpu_torch.app.gpumd as tapp
    from gpumd_tpu.app import gpumd as japp

    deck = f"potential lj.txt\nminimize {line}\n"
    for pkg in ("jax", "torch"):
        _argon_deck(tmp_path / pkg, deck)
    japp.Session(str(tmp_path / "jax")).execute()
    jline = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("minimize")]
    tapp.Session(str(tmp_path / "torch"), device="cpu",
                 dtype=torch.float64).execute()
    tline = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("minimize")]
    pat = r"minimize fire: (\d+) steps, U = (\S+) eV"
    (jn, je), (tn, te) = (re.fullmatch(pat, x[0]).groups()
                          for x in (jline, tline))
    assert tn == jn and abs(float(te) - float(je)) <= E_TOL
