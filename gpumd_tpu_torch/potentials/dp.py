"""DP (DeePMD-kit) bridge potential.

Counterpart of gpumd_tpu/potentials/dp.py (ref: src/force/dp.cu:20-40,
374-520): the model is evaluated on the host through deepmd-kit's Python
API (`deepmd.infer.DeepPot`, which brings its own neighbour machinery).
A force pass copies positions, types, mask and cell to the host, calls
`DeepPot.eval(..., atomic=True)`, and brings the per-atom energies,
forces and virials back to the state's device.  No kernel of the port
runs on this path.

Without deepmd-kit installed, loading raises the JAX package's
RuntimeError; nothing stands in for the model.

run.in: potential <dp_setting_file>, the file holding `dp <num_types>
<symbols...>` and the graph path (ref: dp.cu parse).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from gpumd_tpu_torch.potentials.base import PotentialOutput


def _load_deep_pot(graph_path: str):
    try:
        from deepmd.infer import DeepPot  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "DP potential requires the deepmd-kit python package "
            "(pip install deepmd-kit); it is not installed") from e
    return DeepPot(graph_path)


class DP(NamedTuple):
    graph_path: str
    symbols: tuple
    rc: float
    handle: object  # the host DeepPot
    order: tuple  # this file's type index -> the graph's type index

    @staticmethod
    def from_file(path: str) -> "DP":
        with open(path) as f:
            toks = f.read().split()
        if toks[0] != "dp":
            raise ValueError(f"{path}: not a dp file")
        t = int(toks[1])
        symbols = tuple(toks[2:2 + t])
        graph = toks[2 + t]
        if not os.path.isabs(graph):
            graph = os.path.join(os.path.dirname(os.path.abspath(path)),
                                 graph)
        handle = _load_deep_pot(graph)
        dp_map = list(handle.get_type_map())
        return DP(graph_path=graph, symbols=symbols,
                  rc=float(handle.get_rcut()), handle=handle,
                  order=tuple(dp_map.index(s) for s in symbols))

    def compute_with_state(self, state, nbr=None) -> PotentialOutput:
        """The real atoms (mask > 0) through DeepPot.eval in float64 on
        the host; padding rows get zeros."""
        pos = state.position
        real = (state.mask > 0).cpu().numpy()
        n = int(real.sum())
        coords = pos.detach().cpu().numpy().astype(np.float64)[real]
        atype = np.asarray(self.order, np.int64)[
            state.type.cpu().numpy()[real]]
        cell = state.box.h.detach().cpu().numpy().astype(np.float64).T
        _, f, _, ae, av = self.handle.eval(coords.reshape(1, -1),
                                           cell.reshape(1, 9), atype,
                                           atomic=True)
        n_pad = pos.shape[0]
        energy = np.zeros(n_pad)
        force = np.zeros((n_pad, 3))
        virial = np.zeros((n_pad, 3, 3))
        energy[real] = np.asarray(ae).reshape(-1)[:n]
        force[real] = np.asarray(f).reshape(-1, 3)[:n]
        virial[real] = np.asarray(av).reshape(-1, 9)[:n].reshape(n, 3, 3)

        def dev(x):
            return torch.as_tensor(x, dtype=pos.dtype, device=pos.device)

        return PotentialOutput(energy=dev(energy), force=dev(force),
                               virial=dev(virial))
