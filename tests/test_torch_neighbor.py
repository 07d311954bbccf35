"""The port's neighbour lists vs the JAX package's, f64 on the CPU.

The same numpy positions go through `neighbor_brute`, `neighbor_cell_list`,
`neighbor_cell_dense` and `build_neighbor_list` of both packages, on
orthogonal and triclinic boxes, a box thinner than 2 rc (periodic
images), a box with a non-periodic axis, padding atoms, and cell lists
whose cells overflow their capacity.  The slot layout is part of the
contract: `idx`, `mask`, `count` and the reverse-pair map `rev` must be
equal, `r12` within 1e-12 A.  The JAX functions run with x64 on and matmul
precision "highest" (`jax_oracle_state`).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.box import num_replicas_for_cutoff as jreps
from gpumd_tpu.neighbor import neighbor as JN
from gpumd_tpu_torch.model.box import Box, num_replicas_for_cutoff
from gpumd_tpu_torch.neighbor import neighbor as TN
from torch_one_thread import one_torch_thread  # noqa: F401

R12_ATOL = 1e-12
# the JAX reverse map compiled once a shape for the module (op by op it
# dispatches a few hundred small programs a call)
J_REVERSE_MAP = jax.jit(JN.build_reverse_map)


@contextlib.contextmanager
def jax_oracle_state():
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        yield


def _fcc(nc, a0, jitter, seed):
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    cells = np.stack(np.meshgrid(*[np.arange(n) for n in nc], indexing="ij"),
                     axis=-1).reshape(-1, 3)
    frac = (cells[:, None, :] + base[None]).reshape(-1, 3) / np.asarray(nc)
    rng = np.random.default_rng(seed)
    return frac, rng.normal(0.0, jitter, frac.shape)


def _system(name):
    """(lattice rows, pbc, positions, mask, rc, mn) of a named case."""
    if name == "orthogonal":
        frac, d = _fcc((4, 4, 4), 4.0, 0.15, 0)
        lat = np.diag([16.0, 16.0, 16.0])
        mask = np.ones(len(frac))
        return lat, (1, 1, 1), frac @ lat + d, mask, 4.5, 32
    if name == "triclinic":
        frac, d = _fcc((4, 4, 4), 4.0, 0.1, 1)
        lat = np.array([[16.0, 0.0, 0.0], [3.0, 15.5, 0.0], [-2.0, 1.5, 15.0]])
        return lat, (1, 1, 1), frac @ lat + d, np.ones(len(frac)), 4.3, 40
    if name == "thin_images":
        # a slab 5.6 A thick along x and y: brute force with images
        frac, d = _fcc((2, 2, 6), 2.8, 0.05, 2)
        lat = np.diag([5.6, 5.6, 16.8])
        return lat, (1, 1, 1), frac @ lat + d, np.ones(len(frac)), 4.0, 96
    if name == "nonperiodic_z":
        frac, d = _fcc((4, 4, 4), 4.0, 0.1, 3)
        lat = np.diag([16.0, 16.0, 20.0])
        pos = frac @ np.diag([16.0, 16.0, 16.0]) + d + [0, 0, 2.0]
        return lat, (1, 1, 0), pos, np.ones(len(frac)), 4.5, 32
    if name == "padding":
        frac, d = _fcc((4, 4, 4), 4.0, 0.15, 4)
        lat = np.diag([16.0, 16.0, 16.0])
        pos = np.concatenate([frac @ lat + d, np.zeros((9, 3))])
        mask = np.concatenate([np.ones(len(frac)), np.zeros(9)])
        return lat, (1, 1, 1), pos, mask, 4.5, 32
    raise KeyError(name)


CASES = ("orthogonal", "triclinic", "thin_images", "nonperiodic_z",
         "padding")


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _shift_frac(nbr, pos, h_inv):
    """Integer image shift of each slot (ForceField.refresh_cache's)."""
    idx, r12, mask = _np(nbr.idx), _np(nbr.r12), _np(nbr.mask)
    sc = r12 - (pos[idx] - pos[:, None, :])
    s = np.rint(sc @ np.asarray(h_inv).T)
    return np.where(mask[..., None] > 0, s, 0.0).astype(np.int8)


def _builds(name):
    """Both packages' lists of every builder that takes the case."""
    lat, pbc, pos, mask, rc, mn = _system(name)
    jbox = JBox.from_lattice(lat, pbc=pbc)
    box = Box.from_lattice(lat, pbc=pbc, device="cpu")
    reps = jreps(jbox, rc)
    assert num_replicas_for_cutoff(box, rc) == reps
    grid = JN.choose_grid(jbox, rc)
    assert TN.choose_grid(box, rc) == grid
    jp, jm = jnp.asarray(pos), jnp.asarray(mask)
    tp, tm = torch.as_tensor(pos), torch.as_tensor(mask)
    out = {"brute": (
        JN.neighbor_brute(jp, jbox, jm, rc=rc, mn=mn, reps=reps),
        TN.neighbor_brute(tp, box, tm, rc=rc, mn=mn, reps=reps))}
    if grid is not None:
        kw = dict(rc=rc, mn=mn, grid=grid, cell_cap=16)
        out["cell_list"] = (JN.neighbor_cell_list(jp, jbox, jm, **kw),
                            TN.neighbor_cell_list(tp, box, tm, **kw))
        out["cell_dense"] = (JN.neighbor_cell_dense(jp, jbox, jm, **kw),
                             TN.neighbor_cell_dense(tp, box, tm, **kw))
    if name == "orthogonal":
        # cells of capacity 2: the cell list drops atoms, the dense one
        # flags the overflow
        kw = dict(rc=rc, mn=mn, grid=grid, cell_cap=2)
        out["cell_list_overflow"] = (
            JN.neighbor_cell_list(jp, jbox, jm, **kw),
            TN.neighbor_cell_list(tp, box, tm, **kw))
        out["cell_dense_overflow"] = (
            JN.neighbor_cell_dense(jp, jbox, jm, **kw),
            TN.neighbor_cell_dense(tp, box, tm, **kw))
    return out, pos, np.asarray(jbox.h_inv)


@pytest.fixture(scope="module", params=CASES)
def built(request):
    with jax_oracle_state():
        out, pos, h_inv = _builds(request.param)
        outs = {k: (jax.tree_util.tree_map(np.asarray, j), t)
                for k, (j, t) in out.items()}
    return request.param, outs, pos, h_inv


def test_builders_match(built):
    name, outs, _, _ = built
    assert "brute" in outs
    if name != "thin_images":
        assert "cell_dense" in outs and "cell_list" in outs
    if name == "orthogonal":
        assert "cell_dense_overflow" in outs
    for key, (j, t) in outs.items():
        for f in ("idx", "mask", "count"):
            np.testing.assert_array_equal(_np(getattr(t, f)),
                                          np.asarray(getattr(j, f)),
                                          err_msg=f"{name}/{key}/{f}")
        np.testing.assert_allclose(_np(t.r12), np.asarray(j.r12), rtol=0,
                                   atol=R12_ATOL, err_msg=f"{name}/{key}")
        assert t.idx.dtype == torch.int32 and t.count.dtype == torch.int32
        over = key.endswith("_overflow")
        if over and key.startswith("cell_dense"):
            assert bool(t.overflowed())  # cell overflow shows as MN overflow
        elif not over:
            assert not bool(t.overflowed())


def test_builders_find_every_pair(built):
    """The lists hold exactly the pairs within rc (brute force over all
    image shifts in numpy), padding atoms none."""
    name, outs, pos, h_inv = built
    lat, pbc, _, mask, rc, mn = _system(name)
    h = lat.T
    t = outs["brute"][1]
    n = len(pos)
    for i in range(0, n, 7):
        want = set()
        if mask[i] > 0:
            r = max(1, int(np.ceil(rc / 4.0)) + 1)
            rngs = [range(-r, r + 1) if p else range(1) for p in pbc]
            for sx in rngs[0]:
                for sy in rngs[1]:
                    for sz in rngs[2]:
                        shift = h @ np.array([sx, sy, sz], float)
                        d = pos + shift - pos[i]
                        ok = (np.sum(d * d, -1) < rc * rc) & (mask > 0)
                        if (sx, sy, sz) == (0, 0, 0):
                            ok[i] = False
                        want |= {(int(j), sx, sy, sz)
                                 for j in np.nonzero(ok)[0]}
        m = _np(t.mask[i]) > 0
        idx = _np(t.idx[i])[m]
        r12 = _np(t.r12[i])[m]
        s = np.rint((r12 - (pos[idx] - pos[i])) @ h_inv.T).astype(int)
        got = {(int(j),) + tuple(int(v) for v in sv) for j, sv in zip(idx, s)}
        assert got == want, (name, i)


def test_reverse_map_matches(built):
    """build_reverse_map on the same list and shifts: the same map, and it
    pairs every valid slot with its mirror."""
    name, outs, pos, h_inv = built
    for key in ("brute", "cell_dense"):
        if key not in outs:
            continue
        j, t = outs[key]
        shift = _shift_frac(j, pos, h_inv)
        with jax_oracle_state():
            jnbr = JN.NeighborList(*(jnp.asarray(getattr(j, f)) for f in
                                     ("idx", "r12", "mask", "count")))
            jrev = np.asarray(J_REVERSE_MAP(jnbr, jnp.asarray(shift)))
        trev = TN.build_reverse_map(t, torch.as_tensor(shift))
        assert trev.dtype == torch.int32
        np.testing.assert_array_equal(_np(trev), jrev, err_msg=name)
        valid = _np(t.mask) > 0
        rows = np.broadcast_to(np.arange(len(pos))[:, None], valid.shape)
        rv = _np(trev).reshape(-1)
        flat_idx = _np(t.idx).reshape(-1)
        flat_shift = shift.reshape(-1, 3)
        assert (flat_idx[rv].reshape(valid.shape)[valid] == rows[valid]).all()
        assert (flat_shift[rv].reshape(shift.shape)[valid]
                == -shift[valid]).all()


def test_reverse_map_refuses_odd_slots():
    nbr = TN.NeighborList(idx=torch.zeros((3, 3), dtype=torch.int32),
                          r12=torch.zeros((3, 3, 3)), mask=torch.zeros(3, 3),
                          count=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        TN.build_reverse_map(nbr, torch.zeros((3, 3, 3), dtype=torch.int8))


def test_build_neighbor_list_dispatch():
    """Above 2,048 atoms with a box of >= 3 cells the dispatch takes the
    sort-based cell list (its cell_cap from the density): the same lists
    as the JAX dispatch; force_brute gives brute force's list."""
    frac, d = _fcc((9, 9, 9), 4.0, 0.1, 5)
    lat = np.diag([36.0, 36.0, 36.0])
    pos = frac @ lat + d
    mask = np.ones(len(pos))
    kw = dict(rc=4.5, mn=32)
    with jax_oracle_state():
        j = JN.build_neighbor_list(jnp.asarray(pos), JBox.from_lattice(lat),
                                   jnp.asarray(mask), **kw)
        j = jax.tree_util.tree_map(np.asarray, j)
    t = TN.build_neighbor_list(torch.as_tensor(pos),
                               Box.from_lattice(lat, device="cpu"),
                               torch.as_tensor(mask), **kw)
    for f in ("idx", "mask", "count"):
        np.testing.assert_array_equal(_np(getattr(t, f)), getattr(j, f))
    np.testing.assert_allclose(_np(t.r12), j.r12, rtol=0, atol=R12_ATOL)
    box = Box.from_lattice(lat, device="cpu")
    b = TN.build_neighbor_list(torch.as_tensor(pos), box,
                               torch.as_tensor(mask), force_brute=True, **kw)
    want = TN.neighbor_brute(torch.as_tensor(pos), box,
                             torch.as_tensor(mask), rc=4.5, mn=32)
    for f in ("idx", "mask", "count", "r12"):
        assert torch.equal(getattr(b, f), getattr(want, f))
    # the brute-force slot order differs from the cell list's
    assert not torch.equal(b.idx, t.idx)


def test_compact_rows_keeps_column_order():
    """The first MN valid candidates a row in column order, the count of
    all of them, and rows with fewer candidates than slots."""
    rng = np.random.default_rng(6)
    valid = rng.random((40, 23)) < 0.3
    src, sv = TN._compact_rows(torch.as_tensor(valid), 5)
    for r in range(40):
        cols = np.nonzero(valid[r])[0][:5]
        assert _np(sv[r]).sum() == len(cols)
        np.testing.assert_array_equal(_np(src[r])[:len(cols)], cols)
    src, sv = TN._compact_rows(torch.as_tensor(valid), 30)
    assert src.shape == (40, 30) and int(sv.sum()) == int(valid.sum())


@pytest.mark.parametrize("lat,pbc,rc", [
    (np.diag([5.0, 7.0, 30.0]), (1, 1, 1), 9.0),
    (np.array([[6.0, 0, 0], [3.0, 5.5, 0], [0, 0, 4.0]]), (1, 1, 0), 7.5),
    (np.diag([20.0, 20.0, 20.0]), (1, 1, 1), 9.0)])
def test_num_replicas_for_cutoff(lat, pbc, rc):
    with jax_oracle_state():
        want = jreps(JBox.from_lattice(lat, pbc=pbc), rc)
    assert num_replicas_for_cutoff(
        Box.from_lattice(lat, pbc=pbc, device="cpu"), rc) == want


def _pairs(nbr):
    idx, m = nbr.idx, np.asarray(nbr.mask) > 0
    rows = np.repeat(np.arange(idx.shape[0])[:, None], idx.shape[1], 1)
    return set(zip(rows[m].tolist(), np.asarray(idx)[m].tolist()))


def test_cell_dense_on_a_sheared_lattice():
    """An unjittered fcc lattice in a sheared cell (x' = x + 0.01 y, y' = y
    + 0.01 x): rounding puts atoms of the x = 0 face at s = -1e-18, whose
    wrap is 1.0 and whose cell is the last one.  The port's dense cell list
    moves such an atom with its cell and finds every pair brute force
    finds, with the same displacements; the JAX package's misses pairs
    (ROADMAP queue 3)."""
    frac, _ = _fcc((6, 6, 6), 4.0, 0.0, 0)
    shear = np.eye(3)
    shear[0, 1] = shear[1, 0] = 0.01
    lat = (shear @ np.diag([24.0] * 3)).T  # rows a, b, c
    pos = frac @ lat
    n, rc, mn = len(pos), 4.5, 80
    box = Box.from_lattice(lat, dtype=torch.float64, device="cpu")
    tpos = torch.as_tensor(pos)
    mask = torch.ones(n, dtype=torch.float64)
    assert float(box.fractional(tpos).min()) < 0.0  # the face's rounding
    grid = TN.choose_grid(box, rc)
    cell = TN.neighbor_cell_dense(tpos, box, mask, rc=rc, mn=mn, grid=grid,
                                  cell_cap=16)
    brute = TN.neighbor_brute(tpos, box, mask, rc=rc, mn=mn,
                              reps=num_replicas_for_cutoff(box, rc))
    assert _pairs(cell) == _pairs(brute) and int(cell.count.sum()) == n * 18
    d = {(i, j): tuple(np.round(cell.r12[i, k].numpy(), 9))
         for i in range(n) for k, j in enumerate(cell.idx[i].tolist())
         if cell.mask[i, k] > 0}
    for i in range(n):
        for k, j in enumerate(brute.idx[i].tolist()):
            if brute.mask[i, k] > 0:
                np.testing.assert_allclose(d[i, j], brute.r12[i, k].numpy(),
                                           atol=1e-9)
    with jax_oracle_state():
        jbox = JBox.from_lattice(lat)
        jcell = JN.neighbor_cell_dense(jnp.asarray(pos), jbox,
                                       jnp.ones(n), rc=rc, mn=mn, grid=grid,
                                       cell_cap=16)
    assert int(np.asarray(jcell.count).sum()) < n * 18
