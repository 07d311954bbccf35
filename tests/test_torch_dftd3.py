"""The port's DFT-D3(BJ) term (gpumd_tpu_torch/potentials/dftd3.py)
against the JAX package's, float64 on the CPU.

The same rattled lattices and the same neighbour rows (the JAX builder's)
in both packages: per-atom energies, forces and per-atom virials within
1e-10 of each quantity's largest magnitude; the tables of the port's own
assets/dftd3para.npz equal to those the JAX package builds; the blocks of
rows leave every number as it is.  `dftd3` after `potential` runs through
both apps in tests/test_torch_fcp_dp.py (over the DP bridge's deck)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.potentials import dftd3 as jd3
from gpumd_tpu_torch.potentials import dftd3 as td3
from gpumd_tpu_torch.potentials import sets
from torch_potential_decks import lists, outputs_close
from torch_one_thread import one_torch_thread  # noqa: F401

# (functional, symbols, lattice a0, species of the two rocksalt sites,
# cells, rc, rc_cn, mn)
CASES = {
    "pbe_pbte": ("pbe", ("Pb", "Te"), 6.57, ("Pb", "Te"), 2, 8.0, 5.0, 160),
    "b3lyp_nacl": ("b3lyp", ("Na", "Cl"), 5.64, ("Na", "Cl"), 2, 7.0, 4.0,
                   160),
}


def setup(name, jitter=0.15):
    fn, symbols, a0, species, nc, rc, rc_cn, mn = CASES[name]
    pos, sym, lengths = sets.rocksalt(nc, a0, species)
    pos = pos + np.random.default_rng(4).normal(0.0, jitter, pos.shape)
    types = np.array([symbols.index(s) for s in sym])
    return fn, symbols, pos, lengths, types, rc, rc_cn, mn


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(name):
    fn, symbols, pos, lengths, types, rc, rc_cn, mn = setup(name)
    jn, tn = lists(pos, lengths, rc, mn)
    jpot = jd3.DFTD3.create(fn, rc, rc_cn, symbols)
    tpot = td3.DFTD3.create(fn, rc, rc_cn, symbols, device="cpu")
    n = len(pos)
    want = jax.jit(lambda t, nb, m: jpot.compute(t, nb, m))(
        jnp.asarray(types), jn, jnp.ones(n))
    got = tpot.compute(torch.as_tensor(types), tn,
                       torch.ones(n, dtype=torch.float64))
    outputs_close(got, want, name)
    # dispersion binds: negative energy, forces on
    assert float(got.energy.sum()) < 0.0
    assert float(got.force.abs().max()) > 1e-4


def test_tables_equal_the_jax_packages():
    """The per-type tables (the port's own npz) against the JAX package's
    94-element ones gathered at the types."""
    symbols = ("C", "Pb", "Te")
    j = jd3.DFTD3.create("pbe", 10.0, 5.0, symbols)
    t = td3.DFTD3.create("pbe", 10.0, 5.0, symbols, device="cpu")
    z = np.asarray(j.z_of_type)
    assert t.z_of_type == tuple(z)
    np.testing.assert_array_equal(
        t.c6.numpy(), np.asarray(j.c6_pair)[z[:, None], z[None]])
    np.testing.assert_array_equal(t.cn_ref.numpy(), np.asarray(j.cn_ref)[z])
    assert (t.s6, t.a1, t.s8, t.a2) == jd3.FUNCTIONALS["pbe"]


def test_blocks_leave_the_result(monkeypatch):
    """Five rows a block (the byte bound cut down) against one block: the
    CN chain taken through every block's share of dE/dCN."""
    fn, symbols, pos, lengths, types, rc, rc_cn, mn = setup("pbe_pbte")
    _, tn = lists(pos, lengths, rc, mn)
    pot = td3.DFTD3.create(fn, rc, rc_cn, symbols, device="cpu")
    args = (torch.as_tensor(types), tn,
            torch.ones(len(pos), dtype=torch.float64))
    whole = pot.compute(*args)
    width = tn.idx.shape[1]
    monkeypatch.setattr(td3, "D3_BLOCK_BYTES", 5 * width * 25 * 8)
    assert pot.block_rows(width, torch.float64) == 5
    for a, b in zip(whole, pot.compute(*args)):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)


def test_unknown_functional_raises():
    with pytest.raises(ValueError, match="not supported"):
        td3.DFTD3.create("nope", 10.0, 5.0, ("C",), device="cpu")
