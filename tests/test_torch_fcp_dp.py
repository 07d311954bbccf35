"""The port's force-constant potential (gpumd_tpu_torch/potentials/fcp.py)
and DeePMD bridge (potentials/dp.py) against the JAX package's, float64
on the CPU.

FCP: potentials/sets.py's simple-cubic files (nearest-neighbour springs,
a bond cubic term, an on-site quartic).  Away from a box face the order-2
potential equals the JAX package's (energies, zero-summed forces, the
heat-current virial, 1e-10); orders 4-6 give the JAX package's per-cluster
energies; order 3, where the JAX einsum raises, gives an explicit sum;
the forces are the energy's gradient; across a face the port keeps the
analytic E = 3 k d^2, f = -6 k d for either sign of d (the JAX package
gives other numbers for d < 0: ROADMAP queue 3, item 21); and `potential
fcp.txt` through both apps.

DP: a stub `deepmd.infer` module put into sys.modules (deepmd-kit is on
neither machine), as tests/test_dp_bridge.py does: the type-map
reordering, mask compaction and scatter back, the missing-package error,
and `potential dp.txt` with `dftd3` on top through both apps (the D3
keyword's app deck)."""

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.potentials import dp as jdp
from gpumd_tpu.potentials import fcp as jfcp
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.potentials import dp as tdp
from gpumd_tpu_torch.potentials import fcp as tfcp
from gpumd_tpu_torch.potentials import sets
from torch_potential_decks import StubDeepPot, app_outputs_close, app_pair
from torch_potential_decks import close, outputs_close
from torch_potential_decks import stub_deepmd  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

A0, NC = 3.0, 3


def write_fcp(d, order, heat_order=2, offset=0.0):
    (d / "fcs").mkdir(parents=True, exist_ok=True)
    for name, text in sets.fcp_files(NC, a0=A0, order=order,
                                     offset=offset).items():
        (d / "fcs" / name).write_text(text)
    (d / "fcp.txt").write_text(f"fcp 1 Ar\n{order} {heat_order} fcs\n")
    return str(d / "fcp.txt")


def fcp_states(pos):
    n = len(pos)
    lengths = np.full(3, NC * A0)
    return (jmake_state(pos, np.ones(n), np.zeros(n, int),
                        JBox.orthogonal(lengths)),
            make_state(pos, np.ones(n), np.zeros(n, int),
                       Box.orthogonal(lengths, device="cpu")))


def r0(offset=0.0):
    g = np.stack(np.meshgrid(*[np.arange(NC)] * 3, indexing="ij"), -1)
    return g.reshape(-1, 3) * A0 + offset


def test_fcp_order2_matches_jax(tmp_path):
    """Rattled sites 0.5 A inside the box (no face crossed): both
    packages' output."""
    path = write_fcp(tmp_path, 2, offset=0.5)
    pos = r0(0.5) + np.random.default_rng(0).normal(0.0, 0.1, (NC ** 3, 3))
    js, ts = fcp_states(pos)
    jpot = jfcp.FCP.from_file(path, workdir=str(tmp_path)).attach_box(js.box)
    tpot = tfcp.FCP.from_file(path, workdir=str(tmp_path),
                              device="cpu").attach_box(ts.box)
    want = jax.jit(lambda st: jpot.compute_with_state(st, None))(js)
    outputs_close(tpot.compute_with_state(ts), want, "fcp2")


def _orders(k, c=12, seed=1):
    """Random clusters of order k (runs of equal atoms included) and
    force constants, as the JAX FCPOrder and the port's."""
    rng = np.random.default_rng(seed + k)
    atoms = np.sort(rng.integers(0, 6, (c, k)), axis=1)
    atoms[0] = 2  # one cluster of one atom repeated
    index = rng.integers(0, 3, c)
    phi = rng.normal(size=(3,) + (3,) * k).astype(np.float32)
    w = tfcp._weights(atoms).astype(np.float32)
    jod = jfcp.FCPOrder(atoms=jnp.asarray(atoms, jnp.int32),
                        index=jnp.asarray(index, jnp.int32),
                        phi=jnp.asarray(phi), weight=jnp.asarray(w))
    tod = tfcp.FCPOrder(atoms=torch.as_tensor(atoms),
                        index=torch.as_tensor(index),
                        phi=torch.as_tensor(phi, dtype=torch.float64),
                        weight=torch.as_tensor(w, dtype=torch.float64))
    return atoms, index, phi, jod, tod


@pytest.mark.parametrize("k", [4, 5, 6])
def test_fcp_high_orders_match_jax_cluster_energies(k):
    atoms, _, _, jod, tod = _orders(k)
    assert tfcp._weights(atoms)[0] == 1.0 / math.factorial(k)
    u = np.random.default_rng(k).normal(size=(6, 3))
    want, _ = jfcp.FCP._cluster_energies(None, jnp.asarray(u), jod, k)
    got, _ = tfcp.FCP._cluster_energies(None, torch.as_tensor(u), tod, k)
    close(got, want, k)


def test_fcp_order3_is_the_explicit_sum():
    """sum_abc phi_abc u_i^a u_j^b u_k^c / 6 a cluster, and dE/du_i / 2 for
    the virial, against numpy; the JAX einsum names two axes alike and
    raises unless there are exactly three clusters (queue 3, item 22)."""
    atoms, index, phi, jod, tod = _orders(3)
    u = np.random.default_rng(3).normal(size=(6, 3))
    e, de = tfcp.FCP._cluster_energies(None, torch.as_tensor(u), tod, 3)
    p = phi.astype(np.float64)[index]
    g = np.einsum("cabd,cb,cd->ca", p, u[atoms[:, 1]], u[atoms[:, 2]])
    np.testing.assert_allclose(e.numpy(), (u[atoms[:, 0]] * g).sum(1) / 6,
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(de.numpy(), 0.5 * g, rtol=1e-13, atol=1e-13)
    with pytest.raises(ValueError):
        jfcp.FCP._cluster_energies(None, jnp.asarray(u), jod, 3)


def test_fcp_forces_are_the_gradient(tmp_path):
    """Order 4: F_i = -dE/dx_i + mean_j dE/dx_j (the zero-summed net
    force), by central differences of the total energy."""
    path = write_fcp(tmp_path, 4)
    pos = r0() + np.random.default_rng(1).normal(0.0, 0.1, (NC ** 3, 3))
    _, ts = fcp_states(pos)
    pot = tfcp.FCP.from_file(path, workdir=str(tmp_path),
                             device="cpu").attach_box(ts.box)
    out = pot.compute_with_state(ts)
    h = 1e-5
    grad = np.zeros_like(pos)
    for i in range(len(pos)):
        for a in range(3):
            e = []
            for s in (h, -h):
                p = pos.copy()
                p[i, a] += s
                e.append(float(pot.compute_with_state(ts._replace(
                    position=torch.as_tensor(p))).energy.sum()))
            grad[i, a] = (e[0] - e[1]) / (2 * h)
    np.testing.assert_allclose(out.force.numpy(), -grad + grad.mean(0),
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("d", [0.1, -0.1])
def test_fcp_across_a_face_is_analytic(tmp_path, d):
    """Atom 0 sits on the x = 0 face; moved by d in x (the state wraps it):
    E = 3 k d^2 and f_x = -6 k d in the port for either sign.  The JAX
    package takes u = x - r0 of the wrapped position: for d = -0.1 it
    gives E = 237.6 and f_x = -53.4 (queue 3, item 21)."""
    path = write_fcp(tmp_path, 2)
    pos = r0().astype(float)
    pos[0, 0] += d
    pos = np.mod(pos, NC * A0)
    js, ts = fcp_states(pos)
    tpot = tfcp.FCP.from_file(path, workdir=str(tmp_path),
                              device="cpu").attach_box(ts.box)
    out = tpot.compute_with_state(ts)
    assert float(out.energy.sum()) == pytest.approx(3 * d * d, abs=1e-12)
    # the zero-sum leaves atom 0's force as is (the raw forces sum to 0)
    assert float(out.force[0, 0]) == pytest.approx(-6 * d, abs=1e-12)
    assert float(out.force.sum(0).abs().max()) < 1e-12
    jpot = jfcp.FCP.from_file(path, workdir=str(tmp_path)).attach_box(js.box)
    jout = jpot.compute_with_state(js, None)
    want = (3 * d * d, -6 * d) if d > 0 else (237.6, -53.4)
    assert float(jnp.sum(jout.energy)) == pytest.approx(want[0], abs=0.05)
    assert float(jout.force[0, 0]) == pytest.approx(want[1], abs=0.05)


def test_app_fcp_matches_jax(tmp_path, monkeypatch):
    """`potential fcp.txt` (order 2, heat order 2) through both apps, 10
    NVE steps from the lattice at 300 K (no atom crosses a face)."""
    src = tmp_path / "src"
    write_fcp(src, 2, offset=0.5)
    sets.model_xyz(src, ["Ar"] * NC ** 3, r0(0.5), np.eye(3) * NC * A0,
                   300.0, 4, (True, True, True))
    (src / "run.in").write_text("potential fcp.txt\ntime_step 1\n"
                                "ensemble nve\ndump_thermo 5\nrun 10\n")
    dirs, js, ts = app_pair(tmp_path, src, monkeypatch)
    assert isinstance(ts.potentials[0], tfcp.FCP)
    app_outputs_close(dirs, js, ts, ["thermo.out"])


# ---- DP ---------------------------------------------------------------


def test_dp_round_trip(tmp_path, stub_deepmd):
    """Types reordered by the graph's map, padding rows compacted out and
    zero on the way back; the JAX bridge's numbers on the same state."""
    (tmp_path / "graph.pb").write_text("stub")
    (tmp_path / "dp.txt").write_text("dp 2 Ar Xe\ngraph.pb\n")
    pot = tdp.DP.from_file(str(tmp_path / "dp.txt"))
    assert pot.rc == 6.0 and pot.order == (1, 0)
    n, n_pad = 20, 24
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 14.0, (n, 3))
    typ = rng.integers(0, 2, n)
    box = Box.orthogonal([14.0] * 3, device="cpu")
    st = make_state(pos, np.ones(n), typ, box, n_pad=n_pad)
    got = pot.compute_with_state(st)
    jpot = jdp.DP.from_file(str(tmp_path / "dp.txt"))
    js = jmake_state(pos, np.ones(n), typ, JBox.orthogonal([14.0] * 3),
                     n_pad=n_pad)
    outputs_close(got, jpot.compute_with_state(js, None), "dp")
    assert float(got.force[n:].abs().max()) == 0.0
    want = StubDeepPot("").eval(pos.reshape(1, -1),
                                 np.eye(3).reshape(1, 9) * 14.0,
                                 np.asarray(pot.order)[typ], atomic=True)
    np.testing.assert_allclose(got.force[:n].numpy(), want[1].reshape(n, 3),
                               rtol=0, atol=1e-12)


def test_dp_without_deepmd_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "deepmd", None)
    monkeypatch.setitem(sys.modules, "deepmd.infer", None)
    (tmp_path / "dp.txt").write_text("dp 1 Ar\ngraph.pb\n")
    with pytest.raises(RuntimeError, match="requires the deepmd-kit"):
        tdp.DP.from_file(str(tmp_path / "dp.txt"))


def test_app_dp_and_dftd3_match_jax(tmp_path, monkeypatch, stub_deepmd):
    """`potential dp.txt` (the stub's LJ argon, 108 atoms) and `dftd3 pbe
    8 5` on top of it through both apps, 10 NVE steps: positions, the last
    per-atom outputs and thermo.out within 1e-9."""
    src = tmp_path / "src"
    src.mkdir()
    pos, _, lengths = sets.rocksalt(3, 5.26, ("Ar", "Ar"))
    pos = pos[::2] + np.random.default_rng(2).normal(0, 0.05, (108, 3))
    sets.model_xyz(src, ["Ar"] * 108, pos, np.diag(lengths), 40.0, 3,
                   (True, True, True))
    (src / "graph.pb").write_text("stub")
    (src / "dp.txt").write_text("dp 1 Ar\ngraph.pb\n")
    (src / "run.in").write_text("potential dp.txt\ndftd3 pbe 8 5\n"
                                "time_step 2\nensemble nve\n"
                                "dump_thermo 5\nrun 10\n")
    dirs, js, ts = app_pair(tmp_path, src, monkeypatch)
    assert [type(p).__name__ for p in ts.potentials] == ["DP", "DFTD3"]
    assert ts.route_reason.startswith("CPU device")
    app_outputs_close(dirs, js, ts, ["thermo.out"])
