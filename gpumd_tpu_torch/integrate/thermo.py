"""System thermodynamic observables (ref: src/integrate/ensemble.cu:434-674).

Counterpart of gpumd_tpu/integrate/thermo.py: temperature (K), kinetic and
potential energy (eV), and the pressure tensor
P = (sum_i m_i v_i (x) v_i + sum_i W_i) / V in eV/A^3.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.units import K_B


class Thermo(NamedTuple):
    temperature: torch.Tensor
    kinetic_energy: torch.Tensor
    potential_energy: torch.Tensor
    pressure: torch.Tensor  # (3, 3)


def compute_thermo(state: MDState, ndof=None) -> Thermo:
    m = state.mask
    ke = 0.5 * torch.sum(state.mass * torch.sum(state.velocity ** 2, -1) * m)
    pe = torch.sum(state.potential_energy * m)
    dof = 3.0 * torch.sum(m) if ndof is None else ndof
    kin = torch.einsum("n,na,nb->ab", state.mass * m, state.velocity,
                       state.velocity)
    w = torch.einsum("nab,n->ab", state.virial, m)
    return Thermo(temperature=2.0 * ke / (dof * K_B), kinetic_energy=ke,
                  potential_energy=pe,
                  pressure=(kin + w) / state.box.volume)
