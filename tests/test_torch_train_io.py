"""The port's trainer inputs vs the JAX package: extended XYZ, nep.in and
batched structures, on texts and frames the tests write.

`read_xyz_frames` / `read_xyz` / `write_xyz` field by field (properties,
quoted values, pbc, groups, an integer column, stress and virial),
`parse_nep_in` on every keyword the JAX parser takes (lr_cos_restart in
both forms, fine_tune, type_weight, the errors), `model_from_config`, and
`batch_structures` (idx, r12, masks and references equal in float64 and
float32 for the potential, dipole and polarizability layouts; the reverse
map pairs every slot with its mirror; the padding cut leaves idx, r12 and
rev's pairs as they were and the forward unchanged to 1e-12).  Exact
equality unless stated.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpumd_tpu.io import nep_input as JI
from gpumd_tpu.io import xyz as JX
from gpumd_tpu.train import dataset as JD
from gpumd_tpu_torch.io import nep_input as TI
from gpumd_tpu_torch.io import xyz as TX
from gpumd_tpu_torch.potentials.nep.params import random_params
from gpumd_tpu_torch.train import dataset as TD
from gpumd_tpu_torch.train.nep_train import batched_forward
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

XYZ_TEXT = """3
Lattice="5.0 0.1 0 0 6.0 0 0.2 0 7.0" Properties=species:S:1:pos:R:3:mass:R:1:vel:R:3:group:I:2:force:R:3:charge:R:1 pbc="T F T" Energy=-3.25 virial="1 2 3 4 5 6 7 8 9" config_type="bulk phase" weight=0.5
Te 0.1 0.2 0.3 127.6 0.01 0.02 0.03 0 1 -0.1 0.2 0.3 0.5
Pb 1.1 1.2 1.3 207.2 -0.01 0.0 0.05 1 1 0.4 -0.5 0.6 -0.5
Te 2.1 2.2 2.3 127.6 0.0 0.0 0.0 1 0 0.7 0.8 -0.9 0.0
2
Lattice="4 0 0 0 4 0 0 0 4" Properties=species:S:1:pos:R:3:forces:R:3:adipole:R:3 stress="0.1 0.2 0.3 0.4 0.5 0.6" energy=1.5
Pb 0 0 0 1 2 3 0.1 0.2 0.3
Te 2 2 2 -1 -2 -3 0.4 0.5 0.6
"""

NEP_IN = """# every keyword the JAX parser takes
type 3 Te Pb Se   # trailing comment
version 5
model_type 0
cutoff 6.5 4.5
n_max 5 3
basis_size 7 5
l_max 4 2 1
neuron 12
zbl 2.2
use_typewise_cutoff_zbl 0.7
atomic_v 1
output_descriptor 2
charge_mode 0
lambda_1 0.05
lambda_2 0.06
lambda_e 2.0
lambda_f 3.0
lambda_v 0.5
lambda_shear 0.3
lambda_q 0.2
lambda_z 0.4
force_delta 0.25
batch 7 1
population 40
generation 1234
initial_para 0.8
sigma0 0.05
prediction 1
save_potential 50
output_interval 25
type_weight 1.0 2.0 0.5
seed 42
fine_tune nep89.txt nep89.restart 1
import_q_scaler
epoch 12
start_lr 2e-3
stop_lr 3e-6
weight_decay 1e-4
lr_cos_restart 1 2 5 1.5 0.7
"""


def _same_fields(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def _same_frame(t, j):
    assert t.symbols == j.symbols and t.pbc == j.pbc and t.info == j.info
    for k in ("positions", "lattice", "masses", "charges", "velocities",
              "forces", "groups"):
        a, b = getattr(t, k), getattr(j, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=k)
            assert a.dtype == b.dtype, k
    assert set(t.arrays) == set(j.arrays)
    for k in t.arrays:
        np.testing.assert_array_equal(t.arrays[k], j.arrays[k], err_msg=k)
    np.testing.assert_array_equal(t.default_masses(), j.default_masses())


def test_xyz_frames_match(tmp_path):
    path = tmp_path / "in.xyz"
    path.write_text(XYZ_TEXT)
    tf = TX.read_xyz_frames(str(path))
    jf = JX.read_xyz_frames(str(path))
    assert len(tf) == len(jf) == 2
    for t, j in zip(tf, jf):
        _same_frame(t, j)
    assert tf[0].info["config_type"] == "bulk phase"
    assert tf[0].info["energy"] == "-3.25"  # keys lower-cased
    assert tf[0].pbc == (True, False, True)
    assert tf[0].groups.shape == (3, 2) and tf[0].groups.dtype == np.int64
    assert tf[1].forces is not None and tf[1].arrays["adipole"].shape == (2, 3)
    _same_frame(TX.read_xyz(str(path)), JX.read_xyz(str(path)))
    assert len(TX.read_xyz_frames(str(path), max_frames=1)) == 1
    bad = tmp_path / "bad.xyz"
    for text in ("3\nProperties=species:S:1:pos:R:3\nTe 0 0 0\n",
                 "1\nProperties=species:S:1:pos:R\nTe 0 0 0\n",
                 "1\nProperties=species:S:1\nTe\n",
                 '1\nLattice="1 2 3"\nTe 0 0 0\n', "\n\n"):
        bad.write_text(text)
        with pytest.raises(ValueError):
            TX.read_xyz_frames(str(bad))
        with pytest.raises(ValueError):
            JX.read_xyz_frames(str(bad))


@pytest.mark.parametrize("flags", [dict(), dict(with_velocities=True,
                                                with_forces=True,
                                                with_masses=True,
                                                with_groups=True)])
def test_write_xyz_matches(tmp_path, flags):
    src = tmp_path / "in.xyz"
    src.write_text(XYZ_TEXT)
    frame = TX.read_xyz(str(src))
    extra = {"energy": "1.25", "virial": '"1 0 0 0 1 0 0 0 1"'}
    tp, jp = tmp_path / "t.xyz", tmp_path / "j.xyz"
    for append in (False, True):
        TX.write_xyz(str(tp), frame, append=append, extra_info=extra,
                     **flags)
        JX.write_xyz(str(jp), frame, append=append, extra_info=extra,
                     **flags)
    assert tp.read_bytes() == jp.read_bytes()
    back = TX.read_xyz_frames(str(tp))
    assert len(back) == 2
    np.testing.assert_array_equal(back[1].positions, frame.positions)


def test_parse_nep_in_every_keyword(tmp_path):
    path = tmp_path / "nep.in"
    path.write_text(NEP_IN)
    t, j = TI.parse_nep_in(str(path)), JI.parse_nep_in(str(path))
    _same_fields(t, j)
    assert t.fine_tune and t.fine_tune_descriptor and t.import_q_scaler
    assert t.type_weight == (1.0, 2.0, 0.5) and t.use_full_batch
    assert (t.lr_restart_enable, t.lr_warmup_epochs,
            t.lr_restart_initial_period_epochs, t.lr_restart_period_factor,
            t.lr_restart_decay_factor) == (True, 2, 5, 1.5, 0.7)
    assert t.zbl == 2.2 and t.typewise_cutoff_zbl_factor == 0.7
    # the short lr_cos_restart form, a bare use_typewise_cutoff_zbl and
    # defaults everywhere else
    path.write_text("type 2 Te Pb\nlr_cos_restart 1\nuse_typewise_cutoff_zbl"
                    "\nmode 1\nl_max 4\n")
    t, j = TI.parse_nep_in(str(path)), JI.parse_nep_in(str(path))
    _same_fields(t, j)
    assert t.lr_restart_enable and t.lr_warmup_epochs == 1
    assert t.typewise_cutoff_zbl_factor == 0.65 and t.model_type == 1
    _same_fields(TI.NepTrainConfig(), JI.NepTrainConfig())
    for text in ("type 2 Te Pb\nversion 3\n", "type 2 Te\n",
                 "cutoff 6 4\n", "type 1 Te\nbogus 1\n",
                 "type 1 Te\nlr_cos_restart 1 2\n"):
        path.write_text(text)
        with pytest.raises(ValueError):
            TI.parse_nep_in(str(path))
        with pytest.raises(ValueError):
            JI.parse_nep_in(str(path))


@pytest.mark.parametrize("text", [
    "type 2 Te Pb\n",
    "type 3 Te Pb Se\nversion 5\nl_max 4 2 1\nzbl 2.0\n"
    "use_typewise_cutoff_zbl 0.6\nmode 2\n",
    "type 1 Si\nl_max 4 0 0\nmodel_type 1\ncharge_mode 1\n"])
def test_model_from_config_matches(tmp_path, text):
    path = tmp_path / "nep.in"
    path.write_text(text)
    t = TI.model_from_config(TI.parse_nep_in(str(path)))
    j = JI.model_from_config(JI.parse_nep_in(str(path)))
    _same_fields(t, j)


def _frames(tmp_path):
    """Three PbTe frames (8, 16 and 8 atoms) with every label kind, and
    TNEP-labelled twins, written and read back by the port."""
    from gpumd_tpu_torch.scripts.pbte_train_set import pbte_frames

    rng = np.random.default_rng(5)
    frames = []
    for k, (pos, types, edge) in enumerate(pbte_frames(2, 1, seed=3)):
        frames.append((pos, types, np.diag([edge] * 3)))
    pos, types, _ = pbte_frames(1, 1, seed=4)[0]
    lat = np.array([[6.5, 0, 0], [0.3, 6.4, 0], [0, 0, 13.0]])
    pos2 = np.concatenate([pos, pos + [0, 0, 6.5]])
    frames.insert(1, (pos2, np.concatenate([types, types]), lat))
    text = []
    for k, (pos, types, lat) in enumerate(frames):
        n = len(pos)
        info = [f'Lattice="{" ".join(f"{x:.10f}" for x in lat.ravel())}"',
                "Properties=species:S:1:pos:R:3:force:R:3:adipole:R:3"
                ":apol:R:9", f"energy={rng.normal():.8f}"]
        info.append({0: 'virial="' + " ".join(
            f"{x:.6f}" for x in rng.normal(size=9)) + '"',
            1: 'stress="' + " ".join(f"{x:.6f}" for x in rng.normal(
                size=6)) + '" weight=2.5 energy_weight=0.5',
            2: ""}[k])
        info.append('dipole="0.1 -0.2 0.3" pol="1 2 3 2 4 5 3 5 6"')
        rows = [f"{'Pb' if t else 'Te'} " + " ".join(
            f"{x:.10f}" for x in np.concatenate(
                [p, rng.normal(size=3), rng.normal(size=3),
                 rng.normal(size=9)])) for p, t in zip(pos, types)]
        text += [str(n), " ".join(info)] + rows
    path = tmp_path / "train.xyz"
    path.write_text("\n".join(text) + "\n")
    return TX.read_xyz_frames(str(path)), JX.read_xyz_frames(str(path))


@pytest.mark.parametrize("model_type", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_batch_structures_matches(tmp_path, model_type, dtype):
    tf, jf = _frames(tmp_path)
    for t, j in zip(tf, jf):
        _same_frame(t, j)
    npdt, tdt = ((np.float64, torch.float64) if dtype == "f64"
                 else (np.float32, torch.float32))
    jb = JD.batch_structures(jf, ("Te", "Pb"), rc=5.0, mn=40, dtype=npdt,
                             model_type=model_type)
    tb = TD.batch_structures(tf, ("Te", "Pb"), rc=5.0, mn=40, dtype=tdt,
                             model_type=model_type, trim=False,
                             device="cpu")
    assert tb.num_configs == 3 and tb.max_atoms == 16
    for k in JD.StructureBatch._fields:
        # the JAX batch's qNEP fields are None here, and the port has none
        a, b = getattr(tb, k, None), getattr(jb, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == (tdt if b.dtype in (np.float32, np.float64)
                               else a.dtype), k
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=k)
    # the reverse map: every valid slot's mirror points back with -r12
    c, a, mn = tb.idx.shape
    valid = tb.nbr_mask > 0
    rv = tb.rev.reshape(c, a * mn)
    back = torch.gather(rv, 1, rv).reshape(c, a, mn)
    flat = torch.arange(a * mn).reshape(a, mn).expand(c, -1, -1)
    assert torch.equal(back[valid], flat[valid])
    rows = torch.arange(a)[None, :, None].expand(c, a, mn)
    assert torch.equal(torch.gather(tb.idx.reshape(c, -1).long(), 1, rv)
                       .reshape(c, a, mn)[valid], rows[valid])
    r_m = torch.gather(tb.r12.reshape(c, a * mn, 3), 1,
                       rv[..., None].expand(-1, -1, 3)).reshape(c, a, mn, 3)
    np.testing.assert_allclose(r_m[valid].numpy(), -tb.r12[valid].numpy(),
                               rtol=0, atol=1e-12 if dtype == "f64" else 1e-5)


def test_batch_structures_refuses():
    frames = [TX.XYZFrame(symbols=["Te"] * 2, positions=np.eye(3)[:2] * 2.5,
                          lattice=np.eye(3) * 5.0)]
    with pytest.raises(ValueError):
        TD.batch_structures(frames, ("Te",), rc=6.0, mn=4, device="cpu")
    with pytest.raises(ValueError):
        TD.batch_structures(frames, ("Te",), rc=3.0, mn=8, max_atoms=1,
                            device="cpu")
    # a qNEP batch (ported with the charge path) carries its k-vectors;
    # a plain one none
    qb = TD.batch_structures(frames, ("Te",), rc=3.0, mn=8, charge_mode=1,
                             device="cpu")
    assert qb.kvec.shape[0] == 1 and float(qb.gk.max()) > 0.0
    plain = TD.batch_structures(frames, ("Te",), rc=3.0, mn=8, device="cpu")
    assert plain.kvec is None and plain.position is None


def test_padding_cut_leaves_the_forward(tmp_path):
    """trim cuts the columns that are padding in every row: the kept
    columns as they were, rev's pairs the same, and the forward of a
    random model the same to 1e-12."""
    tf, _ = _frames(tmp_path)
    full = TD.batch_structures(tf, ("Te", "Pb"), rc=5.0, mn=40,
                               dtype=torch.float64, trim=False, device="cpu")
    cut = TD.batch_structures(tf, ("Te", "Pb"), rc=5.0, mn=40,
                              dtype=torch.float64, device="cpu")
    w = cut.idx.shape[2]
    most = int(full.nbr_mask.sum(-1).max())
    assert w == most + most % 2 and w < 40
    assert not bool(full.nbr_mask[..., w:].any())
    for k in ("r12", "idx", "nbr_mask"):
        assert torch.equal(getattr(cut, k), getattr(full, k)[:, :, :w]), k
    valid = cut.nbr_mask > 0
    assert torch.equal((cut.rev // w)[valid], (full.rev[..., :w] // 40)[valid])
    assert torch.equal((cut.rev % w)[valid], (full.rev[..., :w] % 40)[valid])
    cfg = TI.NepTrainConfig(num_types=2, symbols=("Te", "Pb"),
                            rc_radial=5.0, rc_angular=4.0, n_max_radial=3,
                            n_max_angular=3, basis_size_radial=3,
                            basis_size_angular=3, neurons=8)
    model = TI.model_from_config(cfg)
    params = random_params(model, seed=1, dtype=torch.float64, device="cpu")
    a = batched_forward(model, params, full)
    b = batched_forward(model, params, cut)
    for k in ("energy", "force", "virial"):
        np.testing.assert_allclose(getattr(b, k).numpy(),
                                   getattr(a, k).numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=k)
