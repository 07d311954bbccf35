"""Tersoff-1989 parameters (ref: src/force/tersoff1989.cu:30-120).

Counterpart of gpumd_tpu/potentials/tersoff.py::Tersoff1989: the file
parser with its mixing rules for one or two types (geometric A, B * chi,
r1, r2; arithmetic lambda, mu).  The compact engine
(engine/tersoff_compact.py) evaluates the potential; the list-path
`compute`, Tersoff1988 and TersoffMini are not ported yet (ROADMAP queue 1,
item 9).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# The published Tersoff-1989 Si set (Phys. Rev. B 39, 5566 (1989), Table
# I), in the format Tersoff1989.from_file reads
SI_TERSOFF = """tersoff_1989 1 Si
1830.8 471.18 2.4799 1.7322 1.1e-6 0.78734 1.0039e5 16.217 -0.59825 2.7 3.0
"""


class Tersoff1989(NamedTuple):
    # pair-indexed (T, T)
    a: torch.Tensor
    b: torch.Tensor
    lam: torch.Tensor
    mu: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor
    # centre-type-indexed (T,)
    beta: torch.Tensor
    n: torch.Tensor
    c2: torch.Tensor
    d2: torch.Tensor
    h: torch.Tensor
    rc: float

    @staticmethod
    def from_file(path: str, dtype=torch.float64,
                  device=torch.device("cuda")) -> "Tersoff1989":
        """Read a `tersoff_1989` file; the tables go on the card unless
        `device` says otherwise."""
        with open(path) as f:
            return Tersoff1989.from_text(f.read(), dtype, device, name=path)

    @staticmethod
    def from_text(text: str, dtype=torch.float64,
                  device=torch.device("cuda"),
                  name: str = "text") -> "Tersoff1989":
        """Parse the text of a `tersoff_1989` file (e.g. SI_TERSOFF)."""
        tokens = text.split()
        if tokens[0] != "tersoff_1989":
            raise ValueError(f"{name}: not a tersoff_1989 file")
        t = int(tokens[1])
        if t not in (1, 2):
            raise ValueError("tersoff_1989 supports 1 or 2 types")
        vals = [float(x) for x in tokens[2 + t:]]
        rows = [vals[11 * i:11 * (i + 1)] for i in range(t)]
        chi = vals[11 * t] if t == 2 else 1.0

        pair = {k: np.zeros((t, t)) for k in ("a", "b", "lam", "mu", "r1",
                                               "r2")}
        for i in range(t):
            for k, col in (("a", 0), ("b", 1), ("lam", 2), ("mu", 3),
                           ("r1", 9), ("r2", 10)):
                pair[k][i, i] = rows[i][col]
        if t == 2:
            for k in ("a", "r1", "r2"):
                pair[k][0, 1] = pair[k][1, 0] = np.sqrt(pair[k][0, 0]
                                                        * pair[k][1, 1])
            pair["b"][0, 1] = pair["b"][1, 0] = np.sqrt(
                pair["b"][0, 0] * pair["b"][1, 1]) * chi
            for k in ("lam", "mu"):
                pair[k][0, 1] = pair[k][1, 0] = 0.5 * (pair[k][0, 0]
                                                       + pair[k][1, 1])

        def col(c):
            return np.array([rows[i][c] for i in range(t)])

        def ten(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return Tersoff1989(
            **{k: ten(v) for k, v in pair.items()},
            beta=ten(col(4)), n=ten(col(5)), c2=ten(col(6) ** 2),
            d2=ten(col(7) ** 2), h=ten(col(8)),
            rc=float(pair["r2"].max()))

    @property
    def num_types(self) -> int:
        return self.beta.shape[0]
