"""Hybrid MCMD: Monte Carlo type moves interleaved with MD.

Counterpart of gpumd_tpu/mc/mcmd.py.  run.in:
        `mc canonical num_steps_md num_steps_mc T_initial T_final`
        `mc sgc   ... num_types (sym mu)...`
        `mc vcsgc ... num_types (sym phi)... kappa`
(ref: src/mc/mc.cu:206-330, mc_ensemble_canonical.cu, mc_ensemble_sgc.cu)

Canonical: pick two atoms of different types and propose an identity swap
(type + mass + velocity, ref: exchange kernel mc_ensemble_canonical.cu:177).
SGC: pick one atom and propose a species flip with chemical-potential bias
dE += mu_new - mu_old; VC-SGC adds the variance constraint
kappa kB T / N (N (phi_new - phi_old) + 2 (N_new - N_old) + 1)
(ref: mc_ensemble_sgc.cu:465-471); the flipped atom's velocity is scaled by
m_old/m_new for momentum conservation (gpu_flip).

With one NEP potential the energy difference is LOCAL: only atoms within
the cutoff of the touched sites change energy, so a trial evaluates
`NEP.per_atom_energy` on the cluster {i, j} + their neighbour rows, over
one list built a block (positions are frozen during a block; ref:
nep_energy.cu:483-530).  Any other force field takes the exact global
difference, two full passes a trial.  The JAX module takes the local path
for any single potential with a `per_atom_energy`, whose call then raises
for SW (a different signature); here only NEP does.

A block of trials runs on the state's device with no host read inside it,
as JAX's `lax.scan` does: accepting or not selects with torch.where, and
the block's end reads the accepted count (with the list's deepest row on
the local path) once.  Its random numbers come from a draw source
(`TorchDraws`, a seeded torch.Generator on the device, by default; tests
inject JAX's) as one `MCDraws` a block: the atom picks and the candidates
of the bounded redraws, `_MAX_REDRAW` + 1 a trial, and the uniforms.  A
redraw loop becomes the first valid candidate of those drawn (the last
one where none is), the index JAX's loop stops at.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from gpumd_tpu_torch.forcefield import ForceField
from gpumd_tpu_torch.potentials.nep.model import NEP
from gpumd_tpu_torch.units import K_B

_MAX_REDRAW = 64  # bounded redraw of invalid picks
_CANDIDATES = _MAX_REDRAW + 1


class MCDraws(NamedTuple):
    """One block's random numbers, on the state's device.

    atom: (nmc, 65) int64 atom picks: canonical's i in column 0; SGC's i
        and its redraw candidates.
    other: (nmc, 65) int64: canonical's j and its redraw candidates; SGC's
        species candidates (indices into the species list).
    uniform: (nmc,) the acceptance draws, in the state's dtype."""

    atom: torch.Tensor
    other: torch.Tensor
    uniform: torch.Tensor


class TorchDraws:
    """The default draw source: a torch.Generator seeded with `seed` on the
    device, drawing each block's picks, candidates and uniforms as
    separate draws (no stream is reused)."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)

    def block(self, kind: str, nmc: int, n_real: torch.Tensor, ns: int,
              dtype: torch.dtype) -> MCDraws:
        dev = n_real.device

        def indices(bound):
            """Uniform integers in [0, bound), bound on the device."""
            u = torch.rand((nmc, _CANDIDATES), generator=self.gen,
                           dtype=torch.float64, device=dev)
            return torch.minimum(torch.floor(u * bound), bound - 1).long()

        n_f = n_real.to(torch.float64)
        other = indices(n_f if kind == "canonical"
                        else torch.full_like(n_f, ns))
        return MCDraws(atom=indices(n_f), other=other,
                       uniform=torch.rand(nmc, generator=self.gen,
                                          dtype=dtype, device=dev))


def _first_valid(cand: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(1,) the first candidate where `valid` holds, else the last: the
    index a bounded redraw loop stops at."""
    k = torch.argmax(valid.to(torch.int32))
    k = torch.where(valid.any(), k, torch.full_like(k, cand.shape[0] - 1))
    return cand[k[None]]


def _swap(a: torch.Tensor, i: torch.Tensor, j: torch.Tensor):
    out = a.clone()
    out[i] = a[j]
    out[j] = a[i]
    return out


def _with(a: torch.Tensor, i: torch.Tensor, v: torch.Tensor):
    out = a.clone()
    out[i] = v
    return out


class ClusterDelta:
    """The local energy difference of one NEP potential: the per-atom
    energies of the touched sites and their neighbour rows, on one list of
    the state's positions (a block's).  `delta(types, new_types, sites)`
    -> 0-d dE, no host read."""

    def __init__(self, ff: ForceField, pot, state):
        pos = state.box.wrap(state.position)
        self.nbr = ff.neighbor.build(pos, state.box, state.mask)
        self.nidx = self.nbr.idx.long()
        self.pot = pot
        self.n = state.type.shape[0]
        self.dtype = pos.dtype

    def _cluster(self, sites):
        """Sorted-unique affected set: the sites and their neighbour
        rows; returns (cl, clmask)."""
        n = self.n
        cand = torch.cat([sites, self.nidx[sites].reshape(-1)])
        ok = torch.cat([torch.ones_like(sites, dtype=torch.bool),
                        (self.nbr.mask[sites] > 0).reshape(-1)])
        cand = torch.sort(torch.where(ok, cand, torch.full_like(cand, n)))[0]
        uniq = torch.cat([torch.ones(1, dtype=torch.bool,
                                     device=cand.device),
                          cand[1:] != cand[:-1]]) & (cand < n)
        return torch.clamp(cand, max=n - 1), uniq.to(self.dtype)

    def __call__(self, types, new_types, sites):
        """The cluster's energy under both type vectors, in one pass of
        its rows twice over."""
        cl, clmask = self._cluster(sites)
        k = cl.shape[0]
        r12 = self.nbr.r12[cl]
        idxc = self.nidx[cl]
        e = self.pot.per_atom_energy(
            torch.cat([r12, r12]), torch.cat([types[cl], new_types[cl]]),
            torch.cat([types[idxc], new_types[idxc]]), block=2 * k)
        return torch.sum((e[k:] - e[:k]) * clmask)

    def deepest(self):
        """() the deepest row of the list, against its capacity."""
        return self.nbr.count.max()


class GlobalDelta:
    """The exact energy difference of any force field: two full passes
    of the state with each type vector."""

    def __init__(self, ff: ForceField, state):
        self.ff = ff
        self.state = state

    def _total(self, types):
        out = self.ff.compute(self.state._replace(type=types))
        return torch.sum(out.potential_energy * out.mask)

    def __call__(self, types, new_types, sites):
        return self._total(new_types) - self._total(types)

    def deepest(self):
        return None


@dataclass(frozen=True)
class MCMD:
    kind: str  # canonical | sgc | vcsgc
    num_steps_md: int
    num_steps_mc: int
    t_initial: float
    t_final: float
    # sgc/vcsgc: species type indices, chemical potentials (phi), masses
    sgc_types: Tuple[int, ...] = ()
    sgc_mu: Tuple[float, ...] = ()
    sgc_masses: Tuple[float, ...] = ()
    kappa: float = 0.0
    seed: int = 2024

    @staticmethod
    def delta_of(ff: ForceField, state):
        """The energy difference a block uses: ClusterDelta for one NEP
        potential, else GlobalDelta."""
        pots = ff.potentials
        if len(pots) == 1 and isinstance(pots[0], NEP):
            return ClusterDelta(ff, pots[0], state)
        return GlobalDelta(ff, state)

    def make_trials(self, ff: ForceField):
        """Returns run_trials(state, temperature, draws=None) -> (state,
        accepted count); `draws` (an MCDraws) replaces the block's own,
        which come from TorchDraws(seed) on the first state's device."""
        source = None

        def run_trials(state, t, draws: Optional[MCDraws] = None):
            nonlocal source
            with torch.no_grad():
                if draws is None:
                    if source is None:
                        source = TorchDraws(self.seed, state.position.device)
                    draws = source.block(
                        self.kind, self.num_steps_mc,
                        torch.sum(state.mask).to(torch.int64),
                        len(self.sgc_types), state.position.dtype)
                return self._block(self.delta_of(ff, state), state,
                                   float(t), draws)

        return run_trials

    def _block(self, delta, state, t, draws):
        """num_steps_mc trials on the device; the accepted count (and the
        list's deepest row) read once at the end."""
        dev, dtype = state.position.device, state.position.dtype
        n_real = torch.sum(state.mask).to(torch.int64)
        kt = K_B * t
        types, mass, vel = state.type, state.mass, state.velocity
        na = torch.zeros((), dtype=torch.int64, device=dev)
        if self.kind == "canonical":
            for s in range(self.num_steps_mc):
                # i, then j redrawn while of i's type
                i = draws.atom[s, :1]
                ti = types[i]
                j = _first_valid(draws.other[s], types[draws.other[s]] != ti)
                tj = types[j]
                new_types = _with(_with(types, i, tj), j, ti)
                de = delta(types, new_types, torch.cat([i, j]))
                accept = (ti != tj) & (draws.uniform[s:s + 1]
                                       < torch.exp(-de / kt))
                # identity swap: type + mass + velocity ride together
                types = torch.where(accept, new_types, types)
                mass = torch.where(accept, _swap(mass, i, j), mass)
                vel = torch.where(accept, _swap(vel, i, j), vel)
                na = na + accept.to(torch.int64).sum()
        else:
            types_arr = torch.as_tensor(self.sgc_types, dtype=torch.int32,
                                        device=dev)
            mu_arr = torch.as_tensor(self.sgc_mu, dtype=dtype, device=dev)
            mass_arr = torch.as_tensor(self.sgc_masses, dtype=dtype,
                                       device=dev)
            nsp = torch.sum((types[None, :] == types_arr[:, None])
                            & (state.mask[None, :] > 0), dim=1)
            for s in range(self.num_steps_mc):
                # i redrawn while not of a listed species, then the new
                # species redrawn while equal to i's
                cand = draws.atom[s]
                i = _first_valid(cand, torch.any(
                    types[cand][:, None] == types_arr[None, :], dim=1))
                ti = types[i]
                old = torch.argmax((types_arr == ti).to(torch.int32))[None]
                new = _first_valid(draws.other[s],
                                   types_arr[draws.other[s]] != ti)
                tnew = types_arr[new]
                new_types = _with(types, i, tnew)
                de = delta(types, new_types, i)
                if self.kind == "vcsgc":
                    nr = n_real.to(dtype)
                    de = de + self.kappa * kt / nr * (
                        nr * (mu_arr[new] - mu_arr[old])
                        + 2.0 * (nsp[new] - nsp[old]).to(dtype) + 1.0)
                else:
                    de = de + mu_arr[new] - mu_arr[old]
                accept = (tnew != ti) & (draws.uniform[s:s + 1]
                                         < torch.exp(-de / kt))
                m_old, m_new = mass[i], mass_arr[new]
                types = torch.where(accept, new_types, types)
                mass = torch.where(accept, _with(mass, i, m_new), mass)
                # v *= m_old/m_new: momentum conservation (gpu_flip)
                vel = torch.where(accept, _with(
                    vel, i, vel[i] * (m_old / m_new)[:, None]), vel)
                dn = torch.zeros_like(nsp)
                dn.index_add_(0, new, torch.ones_like(new))
                dn.index_add_(0, old, -torch.ones_like(old))
                nsp = torch.where(accept, nsp + dn, nsp)
                na = na + accept.to(torch.int64).sum()
        deepest = delta.deepest()
        if deepest is None:
            na_h = int(na)
        else:  # the block's one read: the accepted count and the deepest row
            na_h, deep = torch.stack([na, deepest.to(torch.int64)]).tolist()
            cap = delta.nbr.idx.shape[1]
            if deep > cap:
                raise RuntimeError(f"mc: an atom has {deep} neighbors but "
                                   f"the list capacity is {cap}; increase mn")
        return state._replace(type=types, mass=mass, velocity=vel), na_h
