"""Grouping methods (ref: src/model/group.cuh:20-37).

Counterpart of gpumd_tpu/model/groups.py.  A grouping method gives every
atom a group label (model.xyz `group:I:k` columns); groups drive fixed and
moving atoms, local thermostats and group-resolved observables.  Labels
stay on the host; the masks are built on demand on the device asked for.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class Groups:
    """Host-side group bookkeeping."""

    def __init__(self, labels: Optional[np.ndarray], n_pad: int):
        """labels: (N, n_methods) int array or None; padding rows get -1."""
        if labels is None:
            self.labels = np.zeros((n_pad, 0), dtype=np.int32)
        else:
            lab = np.asarray(labels, dtype=np.int32)
            pad = n_pad - lab.shape[0]
            if pad:
                lab = np.pad(lab, ((0, pad), (0, 0)), constant_values=-1)
            self.labels = lab
        self.n_methods = self.labels.shape[1]

    def num_groups(self, method: int) -> int:
        if self.labels.shape[0] == 0 or self.n_methods == 0:
            return 0
        return int(self.labels[:, method].max()) + 1

    def sizes(self, method: int) -> np.ndarray:
        return np.array([(self.labels[:, method] == g).sum()
                         for g in range(self.num_groups(method))])

    def mask(self, method: int, group_id: int, dtype=torch.float64,
             device=torch.device("cuda")) -> torch.Tensor:
        """(N,) membership mask."""
        return torch.as_tensor(self.labels[:, method] == group_id,
                               dtype=dtype, device=device)

    def onehot(self, method: int, dtype=torch.float64,
               device=torch.device("cuda")) -> torch.Tensor:
        """(N, n_groups) membership matrix for group reductions."""
        lab = self.labels[:, method]
        oh = np.zeros((len(lab), self.num_groups(method)))
        valid = lab >= 0
        oh[np.arange(len(lab))[valid], lab[valid]] = 1.0
        return torch.as_tensor(oh, dtype=dtype, device=device)
