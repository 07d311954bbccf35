"""The port's ILP hybrids (gpumd_tpu_torch/potentials/ilp.py) against the
JAX package's, float64 on the CPU.

The files come from potentials/sets.py (synthetic ILP rows of the
published form, a Tersoff-1988 C/B/N block, an SW Mo/S block; nep_ilp's
NEPs seeded random models at small widths), with rcut_global cut to 8 A
to keep the JAX package's (N, MN, MN) intralayer tensors small.  Both
packages get the same neighbour rows (the JAX builder's): the normals
take the first three same-layer neighbours in list order.  Energies,
forces and per-atom virials within 1e-10 of each quantity's largest
magnitude, with the port's narrow intralayer list; the narrow list holds
the JAX package's masked long list's pairs in its order; the list order
moves the energy; the app's capacity holds a bilayer in a vacuum box;
and each header through both apps."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.potentials import ilp as jilp
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.potentials import ilp as tilp
from gpumd_tpu_torch.potentials import sets
from gpumd_tpu_torch.potentials.nep.params import write_nep_txt
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_potential_decks import app_outputs_close, app_pair, lists
from torch_potential_decks import outputs_close
from torch_one_thread import one_torch_thread  # noqa: F401

RC_GLOBAL = 8.0
NEP_WIDTHS = (3, 2, 4, 3, 2, 8)


def _rows(rows):
    return [tuple(r[:11]) + (RC_GLOBAL,) for r in rows]


def write_files(d: Path, name: str) -> tuple:
    """(ILP file, second file, symbols, bilayer kind) of case `name`."""
    d.mkdir(parents=True, exist_ok=True)
    if name == "tersoff_ilp":
        (d / "ilp.txt").write_text(sets.ilp_text(
            "tersoff_ilp", ["C", "B", "N"], [0], _rows(sets.ILP_CBN_ROWS)))
        (d / "intra.txt").write_text(sets.tersoff_1988_cbn())
        return ("C", "B", "N"), "hbn_graphene"
    if name == "sw_ilp":
        (d / "ilp.txt").write_text(sets.ilp_text(
            "sw_ilp", ["Mo", "S"], [0], _rows(sets.ILP_MOS_ROWS)))
        (d / "intra.txt").write_text(sets.SW_MOS)
        return ("Mo", "S"), "mos2"
    rows = _rows(sets.ILP_PBTE_ROWS)
    rows = [r[:10] + (3.5,) + r[11:] for r in rows]  # normals from the slab
    (d / "ilp.txt").write_text(sets.ilp_text("nep_ilp", ["Pb", "Te"],
                                             [0, 0], rows))
    for k in (0, 1):
        model, theta, qs = sets.random_nep(
            0, ("Te", "Pb"), seed=k, rc=(5.0, 4.0), widths=NEP_WIDTHS,
            head_scale=(1.0, 1.0), zbl=False)
        write_nep_txt(str(d / f"nep{k}.txt"), model, theta, qs)
    (d / "intra.txt").write_text("0 1 nep0.txt\n" if name == "nep_ilp"
                                 else "0 2 nep0.txt nep1.txt 2 1 0\n")
    return ("Pb", "Te"), "pbte"


CASES = {"tersoff_ilp": (3, 2), "sw_ilp": (3, 2), "nep_ilp": (3, 3),
         "nep_ilp_two": (3, 3)}
LOADERS = {"tersoff_ilp": "load_tersoff_ilp", "sw_ilp": "load_sw_ilp",
           "nep_ilp": "load_nep_ilp", "nep_ilp_two": "load_nep_ilp"}


def build(d, name, jitter=0.05):
    """(JAX hybrid, port hybrid, positions, lengths, types, labels)."""
    symbols, kind = write_files(d, name)
    pos, lat, sym, lab = sets.bilayer(kind, *CASES[name], jitter=jitter)
    types = np.array([symbols.index(s) for s in sym])
    args = (str(d / "ilp.txt"), str(d / "intra.txt"), lab)
    jpot = getattr(jilp, LOADERS[name])(*args)
    tpot = getattr(tilp, LOADERS[name])(*args, device="cpu", intra_mn=24)
    jpot, tpot = jpot[0], tpot[0]
    if name == "nep_ilp_two":  # layer k -> NEP map[k] (the map: 1, 0)
        nl = np.asarray([1, 0])[lab]
        jpot = jpot._replace(nep_labels=jnp.asarray(nl, jnp.int32))
        tpot = tpot._replace(nep_labels=torch.as_tensor(nl))
    return jpot, tpot, pos, np.diag(lat), types, lab


def states(pos, lengths, types):
    n = len(pos)
    pbc = (True, True, False)
    return (jmake_state(pos, np.ones(n), types,
                        JBox.orthogonal(lengths, pbc=pbc)),
            make_state(pos, np.ones(n), types,
                       Box.orthogonal(lengths, pbc=pbc, device="cpu")))


@pytest.mark.parametrize("name", ["nep_ilp_two"])
def test_matches_jax(tmp_path, name):
    """The hybrid on the same rows in both packages: nep_ilp with a NEP a
    layer (tersoff_ilp, sw_ilp and nep_ilp with one NEP run through both
    apps below, per-atom outputs included)."""
    jpot, tpot, pos, lengths, types, _ = build(tmp_path, name)
    jn, tn = lists(pos, lengths, jpot.rc, 320, pbc=(True, True, False))
    js, ts = states(pos, lengths, types)
    want = jax.jit(jpot.compute_with_state)(js, jn)
    got = tpot.compute_with_state(ts, tn)
    outputs_close(got, want, name)


def test_narrow_list_is_the_masked_long_list(tmp_path):
    """The intralayer list holds, row by row and in order, the pairs of
    the JAX package's masked long list that lie within the intralayer
    cutoff, and the intralayer potential gives the same numbers on it as
    on that masked list (padded slots at _FAR add exactly 0)."""
    _, tpot, pos, lengths, types, lab = build(tmp_path, "tersoff_ilp")
    _, tn = lists(pos, lengths, tpot.rc, 320, pbc=(True, True, False))
    labels = torch.as_tensor(lab)
    same = (labels[:, None] == labels[tn.idx.long()]) & (tn.mask > 0)
    masked = tn._replace(r12=torch.where(same[..., None], tn.r12,
                                         torch.full_like(tn.r12, 1e5)),
                         mask=torch.where(same, tn.mask,
                                          torch.zeros_like(tn.mask)))
    keep = same & (torch.sum(tn.r12 ** 2, -1) < tpot.intra_rc ** 2)
    narrow = tilp.narrow_list(tn, keep, 24)
    assert narrow.idx.shape == (len(pos), 24)
    for i in range(len(pos)):
        cols = torch.nonzero(keep[i]).reshape(-1)
        c = int(narrow.count[i])
        assert c == len(cols) and c > 0
        assert torch.equal(narrow.idx[i, :c].long(), tn.idx[i, cols].long())
        assert torch.equal(narrow.r12[i, :c], tn.r12[i, cols])
        assert bool((narrow.r12[i, c:] == 1e5).all())
    t = torch.as_tensor(types)
    m = torch.ones(len(pos), dtype=torch.float64)
    for a, b in zip(tpot.intra.compute(t, narrow, m),
                    tpot.intra.compute(t, masked, m)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    with pytest.raises(RuntimeError, match="overflow"):
        tilp.narrow_list(tn, keep, 2)


def test_normals_follow_the_list_order(tmp_path):
    """An atom with more than three same-layer neighbours inside rcut_ilp
    takes the first three in slot order, in both packages: the same rows
    in another order give another normal and another energy (ROADMAP
    queue 3, item 23), the same in both packages."""
    jpot, tpot, pos, lengths, types, _ = build(tmp_path, "sw_ilp")
    big = tpot.ilp._replace(rcutsq_ilp=torch.full_like(
        tpot.ilp.rcutsq_ilp, 16.0))  # 4 A: an S atom has ten neighbours
    jbig = jpot.ilp._replace(rcutsq_ilp=jnp.full_like(jpot.ilp.rcutsq_ilp,
                                                      16.0))
    jn, tn = lists(pos, lengths, tpot.rc, 320, pbc=(True, True, False))
    js, ts = states(pos, lengths, types)
    flip = torch.arange(tn.idx.shape[1] - 1, -1, -1)
    tr = tn._replace(idx=tn.idx[:, flip], r12=tn.r12[:, flip],
                     mask=tn.mask[:, flip])
    jr = jn._replace(idx=jn.idx[:, ::-1], r12=jn.r12[:, ::-1],
                     mask=jn.mask[:, ::-1])
    e0 = float(big.compute(ts.type, tn, ts.mask).energy.sum())
    e1 = float(big.compute(ts.type, tr, ts.mask).energy.sum())
    j1 = float(jnp.sum(jax.jit(jbig.compute)(js.type, jr, js.mask).energy))
    assert abs(e1 - e0) > 1e-6 * abs(e0)
    assert abs(e1 - j1) <= 1e-10 * abs(j1)
    # the sets' own rows give an S atom its three Mo only: order-free
    f0 = float(tpot.ilp.compute(ts.type, tn, ts.mask).energy.sum())
    f1 = float(tpot.ilp.compute(ts.type, tr, ts.mask).energy.sum())
    assert abs(f1 - f0) <= 1e-12 * abs(f0)


def test_app_capacity_holds_a_bilayer_in_vacuum(tmp_path):
    """The app's MN for bilayer graphene in a box with 60 A of vacuum is
    above its fullest row at rc + skin, where the 3-D density bound alone
    is below it; the intralayer capacity is above the fullest intralayer
    row."""
    import gpumd_tpu_torch.app.gpumd as tapp

    d = tmp_path / "deck"
    sets.other_deck(d, "tersoff_ilp")
    pos, lat, sym, lab = sets.bilayer("graphene", 8, 5, vacuum=60.0,
                                      jitter=0.01)
    sets.model_xyz(d, sym, pos, lat.T, 300.0, 5, (True, True, False),
                   groups=lab)
    (d / "run.in").write_text("potential ilp.txt intra.txt\n")
    s = tapp.Session(str(d), quiet=True, device="cpu")
    s.execute()
    pot = s.potentials[0]
    st = s.state
    nbr = s.ff.neighbor.build(st.box.wrap(st.position), st.box, st.mask)
    rows = int(nbr.count.max())
    assert rows <= s.ff.neighbor.mn
    dens = s._n / float(st.box.volume)
    bound = int(dens * 4.0 / 3.0 * np.pi * (pot.rc + 1.5) ** 3 * 1.5) + 8
    assert bound < rows
    labels = pot.ilp.labels
    d2 = torch.sum(nbr.r12 ** 2, -1)
    same = ((labels[:, None] == labels[nbr.idx.long()]) & (nbr.mask > 0)
            & (d2 < pot.intra_rc ** 2))
    assert 0 < int(same.sum(1).max()) <= pot.intra_mn < 40


@pytest.mark.parametrize("name", ["tersoff_ilp", "sw_ilp", "nep_ilp"])
def test_app_header_matches_jax(tmp_path, monkeypatch, name):
    """`potential ilp.txt intra.txt` (the layers grouping method 0; a
    vacuum along z) through both apps, 6 NVE steps: positions, the last
    per-atom energies, forces and virials, and thermo.out within 1e-9."""
    src = tmp_path / "src"
    symbols, kind = write_files(src, name)
    pos, lat, sym, lab = sets.bilayer(kind, *CASES[name], jitter=0.02)
    sets.model_xyz(src, sym, pos, lat.T, 300.0, 5, (True, True, False),
                   groups=lab)
    (src / "run.in").write_text("potential ilp.txt intra.txt\n"
                                "time_step 1\nensemble nve\n"
                                "dump_thermo 3\nrun 6\n")
    dirs, js, ts = app_pair(tmp_path, src, monkeypatch)
    assert isinstance(ts.potentials[0], tilp.ILPHybrid)
    app_outputs_close(dirs, js, ts, ["thermo.out"])
