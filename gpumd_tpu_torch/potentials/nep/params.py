"""nep.txt parser -> static model config + parameter tensors.

Counterpart of gpumd_tpu/potentials/nep/params.py (file format:
ref src/force/nep.cu:100-395).  `NepModel` is the same hashable
architecture record; `NepParams` holds torch tensors with the JAX
package's shapes, so `params_from_numpy` can carry a JAX model's weights
over leaf by leaf.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gpumd_tpu_torch.elements import atomic_number


class NepParams(NamedTuple):
    w0: torch.Tensor  # (T, neurons, dim)
    b0: torch.Tensor  # (T, neurons)
    w1: torch.Tensor  # (T, neurons)
    b1: torch.Tensor  # () global output bias
    b1_type: torch.Tensor  # (T,) per-type bias (NEP5; zeros for NEP4)
    c_radial: torch.Tensor  # (T, T, n_max_r+1, basis_r+1)
    c_angular: torch.Tensor  # (T, T, n_max_a+1, basis_a+1)
    q_scaler: torch.Tensor  # (dim,)
    zbl_flex: Optional[torch.Tensor] = None  # (T*(T+1)/2, 10)


@dataclass(frozen=True)
class NepModel:
    """Static NEP architecture descriptor (hashable)."""

    version: int  # 3 | 4 | 5
    model_type: int  # 0 potential, 1 dipole, 2 polarizability, 3 temperature
    num_types: int
    symbols: tuple
    atomic_numbers: tuple
    rc_radial: tuple
    rc_angular: tuple
    mn_radial: int
    mn_angular: int
    n_max_radial: int
    n_max_angular: int
    basis_size_radial: int
    basis_size_angular: int
    l_max: int
    has_q: tuple = (0, 0, 0, 0, 0, 0)  # q222, q1111, q112, q123, q233, q134
    neurons: int = 30
    zbl: bool = False
    zbl_rc_inner: float = 0.0
    zbl_rc_outer: float = 0.0
    zbl_flexible: bool = False
    zbl_typewise_factor: float = 0.0
    charge_mode: int = 0

    @property
    def num_l(self) -> int:
        return self.l_max + sum(self.has_q)

    @property
    def dim_angular(self) -> int:
        return (self.n_max_angular + 1) * self.num_l

    @property
    def dim(self) -> int:
        d = (self.n_max_radial + 1) + self.dim_angular
        return d + 1 if self.model_type == 3 else d

    @property
    def rc_radial_max(self) -> float:
        return max(self.rc_radial)

    @property
    def rc_angular_max(self) -> float:
        return max(self.rc_angular)

    def num_ann_params(self) -> int:
        if self.version == 5:
            n = ((self.dim + 2) * self.neurons + 1) * self.num_types + 1
        elif self.version == 3:
            n = (self.dim + 2) * self.neurons + 1
        else:
            n = (self.dim + 2) * self.neurons * self.num_types + 1
        return 2 * n if self.model_type == 2 else n

    def num_descriptor_params(self) -> int:
        return self.num_types ** 2 * (
            (self.n_max_radial + 1) * (self.basis_size_radial + 1)
            + (self.n_max_angular + 1) * (self.basis_size_angular + 1))


def _parse_header_name(name: str):
    parts = name.split("_")
    if parts[0] not in ("nep3", "nep4", "nep5"):
        raise ValueError(f"unsupported NEP model name {name!r}")
    model_type, charge_mode = 0, 0
    for p in parts[1:]:
        if p == "dipole":
            model_type = 1
        elif p == "polarizability":
            model_type = 2
        elif p == "temperature":
            model_type = 3
        elif p.startswith("charge"):
            charge_mode = int(p[6:]) if len(p) > 6 else 1
    return int(parts[0][3]), model_type, "zbl" in parts[1:], charge_mode


def params_from_numpy(np_params, device=None,
                      dtype: torch.dtype = torch.float64) -> NepParams:
    """NepParams from numpy leaves: any object with the JAX NepParams field
    names (e.g. `jax NepParams` mapped through np.asarray) or a dict."""
    get = (np_params.get if isinstance(np_params, dict)
           else lambda k: getattr(np_params, k, None))
    vals = {}
    for k in NepParams._fields:
        v = get(k)
        vals[k] = None if v is None else torch.as_tensor(
            np.asarray(v, np.float64), dtype=dtype, device=device)
    return NepParams(**vals)


def unflatten_params(model: NepModel, flat: np.ndarray, q_scaler: np.ndarray,
                     dtype=torch.float64, device=None) -> NepParams:
    """Split the flat parameter vector as the reference's update_potential
    (ref: nep.cu:227-283) and c-refactor (ref: nep.cu:75-98) do."""
    if model.model_type == 2:
        raise NotImplementedError("polarizability models: not ported yet")
    t, neu, dim = model.num_types, model.neurons, model.dim
    w0 = np.empty((t, neu, dim))
    b0 = np.empty((t, neu))
    w1 = np.empty((t, neu))
    b1_type = np.zeros((t,))
    p = 0
    for ty in range(1 if model.version == 3 else t):
        w0[ty] = flat[p:p + neu * dim].reshape(neu, dim)
        p += neu * dim
        b0[ty] = flat[p:p + neu]
        p += neu
        w1[ty] = flat[p:p + neu]
        p += neu
        if model.version == 5:
            b1_type[ty] = flat[p]
            p += 1
    if model.version == 3:  # one shared ANN, broadcast to every type
        w0[1:], b0[1:], w1[1:] = w0[0], b0[0], w1[0]
    b1 = flat[p]
    p += 1
    t2 = t * t
    nr = (model.n_max_radial + 1) * (model.basis_size_radial + 1)
    na = (model.n_max_angular + 1) * (model.basis_size_angular + 1)
    c = flat[p:p + t2 * (nr + na)]
    # file order: basis-major, type-pair minor
    c_rad = c[:t2 * nr].reshape(nr, t2).T.reshape(
        t, t, model.n_max_radial + 1, model.basis_size_radial + 1)
    c_ang = c[t2 * nr:].reshape(na, t2).T.reshape(
        t, t, model.n_max_angular + 1, model.basis_size_angular + 1)
    return params_from_numpy(dict(
        w0=w0, b0=b0, w1=w1, b1=np.asarray(b1), b1_type=b1_type,
        c_radial=c_rad, c_angular=c_ang, q_scaler=q_scaler),
        device=device, dtype=dtype)


def load_nep_txt(path: str, dtype=torch.float64,
                 device=None) -> Tuple[NepModel, NepParams]:
    with open(path) as f:
        tokens = f.read().split()
    pos = 0

    def take(k):
        nonlocal pos
        out = tokens[pos:pos + k]
        pos += k
        return out

    version, model_type, zbl, charge_mode = _parse_header_name(take(1)[0])
    if charge_mode:
        raise NotImplementedError("qNEP (charge) models: separate loader")
    num_types = int(take(1)[0])
    symbols = tuple(take(num_types))

    zbl_inner = zbl_outer = zbl_factor = 0.0
    zbl_flexible = False
    if zbl:
        tok = take(1)[0]
        if tok != "zbl":
            raise ValueError(f"{path}: expected 'zbl' line, got {tok!r}")
        zbl_inner, zbl_outer = float(take(1)[0]), float(take(1)[0])
        zbl_flexible = zbl_inner == 0.0 and zbl_outer == 0.0
        if tokens[pos] != "cutoff":  # optional typewise factor
            zbl_factor = float(take(1)[0])

    tok = take(1)[0]
    if tok != "cutoff":
        raise ValueError(f"{path}: expected 'cutoff', got {tok!r}")
    rest = []
    while tokens[pos] != "n_max":
        rest.append(take(1)[0])
    if len(rest) == 4:
        rc_r = (float(rest[0]),) * num_types
        rc_a = (float(rest[1]),) * num_types
    elif len(rest) == 2 * num_types + 2:
        rc_r = tuple(float(rest[2 * i]) for i in range(num_types))
        rc_a = tuple(float(rest[2 * i + 1]) for i in range(num_types))
    else:
        raise ValueError(f"{path}: bad cutoff line ({len(rest)} values)")
    if int(rest[-2]) > 819:
        raise ValueError("MN_radial exceeds 819")
    # enlarged caps (ref: nep.cu:226-237)
    mn_radial = int(np.ceil(int(rest[-2]) * 1.25))
    mn_angular = int(np.ceil(int(rest[-1]) * 1.25))

    assert take(1)[0] == "n_max"
    n_max_r, n_max_a = int(take(1)[0]), int(take(1)[0])
    assert take(1)[0] == "basis_size"
    basis_r, basis_a = int(take(1)[0]), int(take(1)[0])
    assert take(1)[0] == "l_max"
    l_vals = []
    while tokens[pos].lower() != "ann":
        l_vals.append(int(take(1)[0]))
    has_q = tuple(1 if v else 0 for v in (l_vals[1:] + [0] * 6)[:6])
    assert take(1)[0].lower() == "ann"
    neurons = int(take(1)[0])
    take(1)  # trailing 0

    model = NepModel(
        version=version, model_type=model_type, num_types=num_types,
        symbols=symbols,
        atomic_numbers=tuple(atomic_number(s) for s in symbols),
        rc_radial=rc_r, rc_angular=rc_a, mn_radial=mn_radial,
        mn_angular=mn_angular, n_max_radial=n_max_r, n_max_angular=n_max_a,
        basis_size_radial=basis_r, basis_size_angular=basis_a,
        l_max=l_vals[0], has_q=has_q, neurons=neurons, zbl=zbl,
        zbl_rc_inner=zbl_inner, zbl_rc_outer=zbl_outer,
        zbl_flexible=zbl_flexible, zbl_typewise_factor=zbl_factor,
    )
    n_para = model.num_ann_params() + model.num_descriptor_params()
    values = np.array([float(v) for v in take(n_para + model.dim)])
    params = unflatten_params(model, values[:n_para], values[n_para:],
                              dtype=dtype, device=device)
    if zbl_flexible:
        n_pair = num_types * (num_types + 1) // 2
        flex = np.array([float(v) for v in take(10 * n_pair)])
        params = params._replace(zbl_flex=torch.as_tensor(
            flex.reshape(n_pair, 10), dtype=dtype, device=device))
    return model, params


def random_params(model: NepModel, seed: int = 0, dtype=torch.float32,
                  device=None) -> NepParams:
    """Random parameters from the same numpy stream as the JAX package's
    random_params, so equal seeds give equal weights."""
    rng = np.random.default_rng(seed)
    t, neu, dim = model.num_types, model.neurons, model.dim

    def g(*shape):
        return rng.normal(0, 0.3, shape)

    zbl_flex = None
    if model.zbl and model.zbl_flexible:
        npair = t * (t + 1) // 2
        rows = np.empty((npair, 10))
        rows[:, 0] = rng.uniform(0.5, 1.0, npair)
        rows[:, 1] = rng.uniform(1.5, 2.5, npair)
        rows[:, 2::2] = rng.uniform(0.05, 0.5, (npair, 4))
        rows[:, 3::2] = rng.uniform(0.3, 3.5, (npair, 4))
        zbl_flex = rows
    leaves = dict(w0=g(t, neu, dim), b0=g(t, neu), w1=g(t, neu))
    leaves["b1"] = np.asarray(rng.normal())
    leaves["b1_type"] = np.zeros((t,)) if model.version != 5 else g(t)
    leaves["c_radial"] = g(t, t, model.n_max_radial + 1,
                           model.basis_size_radial + 1)
    leaves["c_angular"] = g(t, t, model.n_max_angular + 1,
                            model.basis_size_angular + 1)
    leaves["q_scaler"] = np.ones((dim,))
    leaves["zbl_flex"] = zbl_flex
    return params_from_numpy(leaves, device=device, dtype=dtype)
