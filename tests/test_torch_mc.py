"""The port's hybrid MCMD (gpumd_tpu_torch/mc/mcmd.py) against the JAX
package's on the CPU in float64, with JAX's draws recomputed from its key
sequence and injected (tests/torch_jax_draws.py): a block's types equal,
masses and velocities within 1e-12 and the accepted count equal to JAX's
run_trials, for canonical, SGC and VC-SGC on the local path (a narrow
random NEP4 of Te Pb on jittered PbTe 64) and on the global path (binary
LJ).  The local dE equals the global dE within 1e-9 eV.  A lone SW
potential runs the global path, where the JAX module's local path raises
(ROADMAP queue 3).  Through both apps, an `mc sgc` deck writes the same
mcmd.out and the `mc` keyword keeps the run on the list path."""

import numpy as np
import pytest
import torch

import jax
from gpumd_tpu.forcefield import ForceField as JFF
from gpumd_tpu.io.xyz import XYZFrame, write_xyz
from gpumd_tpu.mc.mcmd import MCMD as JMCMD
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.potentials.lj import LJ as JLJ
from gpumd_tpu.potentials.nep import NEP as JNEP
from gpumd_tpu.potentials.sw import SW as JSW
from gpumd_tpu_torch.forcefield import ForceField
from gpumd_tpu_torch.io.nep_input import NepTrainConfig, model_from_config
from gpumd_tpu_torch.mc.mcmd import MCMD, ClusterDelta, GlobalDelta, MCDraws
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.potentials.lj import LJ
from gpumd_tpu_torch.potentials.nep.model import NEP
from gpumd_tpu_torch.potentials.nep.params import num_trainable, write_nep_txt
from gpumd_tpu_torch.potentials.sets import SW_TWO
from gpumd_tpu_torch.potentials.sw import SW
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_jax_draws import jax_mc_draws
from torch_one_thread import one_torch_thread  # noqa: F401

NMC = 12
LJ_BINARY = ("lj 2 Ar Kr\n1.032e-2 3.405 8.0\n1.2e-2 3.5 8.0\n"
             "1.2e-2 3.5 8.0\n1.4e-2 3.65 8.0\n")
MASSES = {"Te": 127.6, "Pb": 207.2, "Ar": 39.948, "Kr": 83.798,
          "Si": 28.0855, "Ge": 72.63}
# kind, (T, sgc mu or phi, kappa) a path
KINDS = {"canonical": ((), 0.0), "sgc": ((0.0, -0.05), 0.0),
         "vcsgc": ((0.0, 0.02), 5.0)}


def lattice(kind, nc, a0, seed):
    """(positions jittered 0.05 A, lengths, type a site) of rocksalt (two
    fcc sublattices), fcc or diamond, types half and half at random."""
    fcc = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    base = {"rocksalt": np.concatenate([fcc, fcc + [.5, 0, 0]]),
            "fcc": fcc, "diamond": np.concatenate([fcc, fcc + .25])}[kind]
    cells = np.array([[i, j, k] for i in range(nc) for j in range(nc)
                      for k in range(nc)])
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    rng = np.random.default_rng(seed)
    pos = pos + rng.normal(0, 0.05, pos.shape)
    types = rng.permutation(np.arange(len(pos)) % 2)
    return pos, np.full(3, nc * a0), types


def nep_file(path, seed=7):
    cfg = NepTrainConfig(num_types=2, symbols=("Te", "Pb"), rc_radial=5.0,
                         rc_angular=4.0, n_max_radial=3, n_max_angular=3,
                         basis_size_radial=3, basis_size_angular=3,
                         neurons=8)
    model = model_from_config(cfg)
    rng = np.random.default_rng(seed)
    write_nep_txt(str(path), model, rng.normal(0, 0.3, num_trainable(model)),
                  rng.uniform(0.5, 2.0, model.dim))
    return str(path)


def system(tmp_path, pot):
    """(JAX state, JAX force field, port state, port force field, the
    type names) of one potential's system (64 atoms, LJ 32), velocities
    drawn."""
    if pot == "nep":
        path = nep_file(tmp_path / "nep.txt")
        jpots, tpots = [JNEP.from_file(path)], [
            NEP.from_file(path, dtype=torch.float64, device="cpu")]
        pos, lengths, types = lattice("rocksalt", 2, 6.46, 1)
        names, mn = ("Te", "Pb"), 100
    elif pot == "lj":
        (tmp_path / "lj.txt").write_text(LJ_BINARY)
        jpots = [JLJ.from_file(str(tmp_path / "lj.txt"))]
        tpots = [LJ.from_file(str(tmp_path / "lj.txt"), device="cpu")]
        pos, lengths, types = lattice("fcc", 2, 5.0, 2)
        names, mn = ("Ar", "Kr"), 160
    else:
        (tmp_path / "sw.txt").write_text(SW_TWO)
        jpots = [JSW.from_file(str(tmp_path / "sw.txt"))]
        tpots = [SW.from_file(str(tmp_path / "sw.txt"), device="cpu")]
        pos, lengths, types = lattice("diamond", 2, 5.5, 3)
        names, mn = ("Si", "Ge"), 64
    n = len(pos)
    mass = np.array([MASSES[names[t]] for t in types])
    vel = np.random.default_rng(4).normal(0, 0.01, (n, 3))
    jbox, box = JBox.orthogonal(lengths), Box.orthogonal(lengths,
                                                         device="cpu")
    jst = jmake_state(pos, mass, types, jbox, velocity=vel)
    st = make_state(pos, mass, types, box, velocity=vel)
    return (jst, JFF.create(jpots, jbox, n, mn=mn),
            st, ForceField.create(tpots, box, n, mn=mn), names)


def mcmd(cls, kind, names):
    mu, kappa = KINDS[kind]
    sgc = kind != "canonical"
    return cls(kind=kind, num_steps_md=1, num_steps_mc=NMC, t_initial=900.0,
               t_final=900.0, sgc_types=(0, 1) if sgc else (),
               sgc_mu=mu, sgc_masses=tuple(MASSES[s] for s in names)
               if sgc else (), kappa=kappa)


def injected(kind, key, n):
    (atom, other, uniform), _ = jax_mc_draws(kind, key, NMC, n, 2)
    return MCDraws(*(torch.as_tensor(a) for a in (atom, other, uniform)))


def assert_block(st, na, jst, jna):
    assert na == int(jna)
    np.testing.assert_array_equal(st.type.numpy(), np.asarray(jst.type))
    for f in ("mass", "velocity"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(jst, f)), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("pot", ["nep", "lj"])
@pytest.mark.parametrize("kind", ["canonical", "sgc", "vcsgc"])
def test_block_matches_jax_with_its_draws(tmp_path, kind, pot):
    jst, jff, st, ff, names = system(tmp_path, pot)
    jmc, tmc = mcmd(JMCMD, kind, names), mcmd(MCMD, kind, names)
    key = jax.random.PRNGKey(11)
    if pot == "nep":
        jrun = jmc._make_local_trials(jff, jff.potentials[0])
        assert isinstance(tmc.delta_of(ff, st), ClusterDelta)
    else:
        jrun = jmc._make_global_trials(jff)
        assert isinstance(tmc.delta_of(ff, st), GlobalDelta)
    jout, _, jna = jrun(jst, key, 900.0)
    out, na = tmc.make_trials(ff)(st, 900.0, injected(kind, key, len(
        st.mask)))
    assert 0 < na < NMC  # some trials taken, some refused
    assert_block(out, na, jout, jna)


def test_local_delta_equals_global_delta(tmp_path):
    _, _, st, ff, _ = system(tmp_path, "nep")
    local, glob = ClusterDelta(ff, ff.potentials[0], st), GlobalDelta(ff, st)
    rng = np.random.default_rng(9)
    types = st.type
    with torch.no_grad():
        for _ in range(10):
            i, j = rng.choice(len(types), 2, replace=False)
            sites = torch.as_tensor([i, j])
            new = types.clone()
            new[i], new[j] = types[j], 1 - types[i]  # a swap or a flip
            dl, dg = (float(d(types, new, sites)) for d in (local, glob))
            assert abs(dl - dg) <= 1e-9, (dl, dg)


def test_lone_sw_runs_the_global_path(tmp_path):
    """The JAX module takes its local path for SW and the call raises
    (SW.per_atom_energy takes a neighbour mask, not a block); the port
    runs the global path, equal to JAX's global run_trials."""
    jst, jff, st, ff, names = system(tmp_path, "sw")
    jmc, tmc = (mcmd(c, "canonical", names) for c in (JMCMD, MCMD))
    key = jax.random.PRNGKey(3)
    with pytest.raises(TypeError):
        jmc.make_trials(jff)(jst, key, 900.0)
    assert isinstance(tmc.delta_of(ff, st), GlobalDelta)
    jout, _, jna = jmc._make_global_trials(jff)(jst, key, 900.0)
    out, na = tmc.make_trials(ff)(st, 900.0,
                                  injected("canonical", key, len(st.mask)))
    assert_block(out, na, jout, jna)


def test_default_draws_keep_the_block_on_the_device(tmp_path):
    """Without injected draws the seeded generator decides: two runs from
    one seed agree, canonical keeps the composition and SGC moves it the
    way mu says."""
    _, _, st, ff, names = system(tmp_path, "lj")
    runs = [mcmd(MCMD, "canonical", names).make_trials(ff)(st, 900.0)
            for _ in range(2)]
    assert runs[0][1] == runs[1][1]
    assert torch.equal(runs[0][0].type, runs[1][0].type)
    assert int((runs[0][0].type == 1).sum()) == int((st.type == 1).sum())
    mc = MCMD(kind="sgc", num_steps_md=1, num_steps_mc=40, t_initial=300.0,
              t_final=300.0, sgc_types=(0, 1), sgc_mu=(0.0, -2.0),
              sgc_masses=(MASSES["Ar"], MASSES["Kr"]))
    out, na = mc.make_trials(ff)(st, 300.0)
    assert int((out.type == 1).sum()) > int((st.type == 1).sum()) and na > 0


def _binary_deck(d, deck):
    d.mkdir()
    pos = lattice("fcc", 2, 5.0, 2)[0]
    n = len(pos)
    write_xyz(str(d / "model.xyz"), XYZFrame(
        symbols=["Ar" if i < n // 2 else "Kr" for i in range(n)],
        positions=pos, lattice=np.diag([10.0] * 3), pbc=(True,) * 3,
        velocities=np.random.default_rng(6).normal(0, 1e-3, (n, 3))),
        with_velocities=True)
    (d / "lj.txt").write_text(LJ_BINARY)
    (d / "run.in").write_text(deck)


def test_mc_deck_writes_jax_rows(tmp_path, monkeypatch):
    """An `mc sgc` deck through both apps, the port given JAX's draws of
    each block (its key from PRNGKey(seed), carried across blocks): the
    same mcmd.out rows and final types; the run takes the list path with
    the reason logged."""
    import gpumd_tpu_torch.app.gpumd as tapp
    import gpumd_tpu_torch.mc.mcmd as tmcmd
    from gpumd_tpu.app import gpumd as japp

    deck = ("potential lj.txt\ntime_step 2\nensemble nve\n"
            "mc sgc 5 8 300 200 2 Ar 0.0 Kr -0.3\nrun 20\n")
    for pkg in ("jax", "torch"):
        _binary_deck(tmp_path / pkg, deck)
    js = japp.Session(str(tmp_path / "jax"), quiet=True)
    js.execute()

    class JaxKeys:
        def __init__(self, seed, device):
            self.key = jax.random.PRNGKey(seed)

        def block(self, kind, nmc, n_real, ns, dtype):
            arrays, self.key = jax_mc_draws(kind, self.key, nmc,
                                            int(n_real), ns)
            return MCDraws(*(torch.as_tensor(a) for a in arrays))

    monkeypatch.setattr(tmcmd, "TorchDraws", JaxKeys)
    ts = tapp.Session(str(tmp_path / "torch"), quiet=True, device="cpu",
                      dtype=torch.float64)
    ts.execute()
    assert ts.route_reason == "CPU device (the kernels' plain versions run " \
        "slower than the list path there)"
    assert tapp._dense_blocker(ts, ts.ensemble) == "MCMD run"
    want = np.loadtxt(tmp_path / "jax" / "mcmd.out")
    got = np.loadtxt(tmp_path / "torch" / "mcmd.out")
    assert got.shape == want.shape == (4, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ts.state.type.numpy(),
                                  np.asarray(js.state.type))
