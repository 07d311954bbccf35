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
    # the second ANN head of a polarizability model (model_type 2)
    w0_pol: Optional[torch.Tensor] = None  # (T, neurons, dim)
    b0_pol: Optional[torch.Tensor] = None  # (T, neurons)
    w1_pol: Optional[torch.Tensor] = None  # (T, neurons)
    b1_pol: Optional[torch.Tensor] = None  # ()
    # the charge head of a qNEP model (charge_mode > 0; ref: main_nep/
    # nep_charge.cu:236-253)
    w1_charge: Optional[torch.Tensor] = None  # (T, neurons)
    sqrt_epsilon_inf: Optional[torch.Tensor] = None  # ()


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
        if self.charge_mode:
            # per type w0, b0, w1 and the charge head's w1; sqrt_eps_inf
            # and b1 (ref: main_nep/nep_charge.cu:309)
            return (self.dim + 3) * self.neurons * self.num_types + 2
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


def params_from_numpy(np_params, device=torch.device("cuda"),
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
                     dtype=torch.float64,
                     device=torch.device("cuda")) -> NepParams:
    """Split the flat parameter vector as the reference's update_potential
    (ref: nep.cu:227-283) and c-refactor (ref: nep.cu:75-98) do; a
    polarizability model carries a second ANN block after the first, a
    charge model a charge head after each type's energy head and
    sqrt(epsilon_inf) before the bias (ref: nep_charge.cu:236-253)."""
    t, neu, dim = model.num_types, model.neurons, model.dim
    p = 0
    charge = {}
    if model.charge_mode:
        w0, b0 = np.empty((t, neu, dim)), np.empty((t, neu))
        w1, w1q = np.empty((t, neu)), np.empty((t, neu))
        for ty in range(t):
            for arr, size in ((w0, neu * dim), (b0, neu), (w1, neu),
                              (w1q, neu)):
                arr[ty] = flat[p:p + size].reshape(arr.shape[1:])
                p += size
        charge = dict(w1_charge=w1q, sqrt_epsilon_inf=np.asarray(flat[p]))
        b1 = np.asarray(flat[p + 1])
        p += 2

    def ann_block():
        nonlocal p
        w0 = np.empty((t, neu, dim))
        b0 = np.empty((t, neu))
        w1 = np.empty((t, neu))
        b1_type = np.zeros((t,))
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
        return w0, b0, w1, np.asarray(b1), b1_type

    if model.charge_mode:
        b1_type = np.zeros((t,))
    else:
        w0, b0, w1, b1, b1_type = ann_block()
    pol = {}
    if model.model_type == 2:
        pw0, pb0, pw1, pb1, _ = ann_block()
        pol = dict(w0_pol=pw0, b0_pol=pb0, w1_pol=pw1, b1_pol=pb1)
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
        w0=w0, b0=b0, w1=w1, b1=b1, b1_type=b1_type,
        c_radial=c_rad, c_angular=c_ang, q_scaler=q_scaler, **pol,
        **charge), device=device, dtype=dtype)


def load_nep_txt(path: str, dtype=torch.float64,
                 device=torch.device("cuda")) -> Tuple[NepModel, NepParams]:
    with open(path) as f:
        tokens = f.read().split()
    pos = 0

    def take(k):
        nonlocal pos
        out = tokens[pos:pos + k]
        pos += k
        return out

    version, model_type, zbl, charge_mode = _parse_header_name(take(1)[0])
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
        charge_mode=charge_mode,
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


def num_trainable(model: NepModel) -> int:
    """Trainable parameter count (ANN + descriptor c; not q_scaler)."""
    return model.num_ann_params() + model.num_descriptor_params()


def global_bias_index(model: NepModel) -> int:
    """Flat-vector slot of the global output bias b1, the slot the trainer
    shifts to absorb the mean energy error (ref: fitness.cu:457)."""
    t, neu, dim = model.num_types, model.neurons, model.dim
    per_type = (dim + 2) * neu
    if model.charge_mode:
        per_type += neu
    if model.version == 5:
        per_type += 1
    p = t * per_type
    if model.charge_mode:
        p += 1  # sqrt_eps_inf sits before b1
    return p


def params_from_vector(model: NepModel, theta: torch.Tensor,
                       q_scaler: Optional[torch.Tensor] = None) -> NepParams:
    """Flat vector -> NepParams on theta's device, in the reference's file
    order: per-type ANN blocks, the global bias, a polarizability model's
    second head, then c basis-major and type-pair-minor; a charge model
    has a charge head after each type's energy head and sqrt(epsilon_inf)
    before the bias (ref: nep_charge.cu:246-251).  Differentiable in
    theta.  As in the JAX package, a NEP3 vector is read as one ANN block
    per type (the trainer's layout), not the file's shared block."""
    t, neu, dim = model.num_types, model.neurons, model.dim
    p = 0
    charge = {}

    def heads(keep_type_bias):
        nonlocal p
        w0, b0, w1, bt, w1q = [], [], [], [], []
        for _ in range(t):
            w0.append(theta[p:p + neu * dim].reshape(neu, dim))
            p += neu * dim
            b0.append(theta[p:p + neu])
            p += neu
            w1.append(theta[p:p + neu])
            p += neu
            if model.charge_mode:
                w1q.append(theta[p:p + neu])
                p += neu
            if model.version == 5:
                if keep_type_bias:
                    bt.append(theta[p])
                p += 1  # the pol head's per-type bias slot is unused
        if model.charge_mode:
            charge.update(w1_charge=torch.stack(w1q),
                          sqrt_epsilon_inf=theta[p])
            p += 1
        b1 = theta[p]
        p += 1
        return torch.stack(w0), torch.stack(b0), torch.stack(w1), bt, b1

    w0, b0, w1, b1_type, b1 = heads(True)
    pol = {}
    if model.model_type == 2:  # ref: snes.cu:256-266 (two ANNs)
        pw0, pb0, pw1, _, pb1 = heads(False)
        pol = dict(w0_pol=pw0, b0_pol=pb0, w1_pol=pw1, b1_pol=pb1)
    t2 = t * t
    nr = (model.n_max_radial + 1) * (model.basis_size_radial + 1)
    na = (model.n_max_angular + 1) * (model.basis_size_angular + 1)
    c = theta[p:p + t2 * (nr + na)]
    c_rad = c[:t2 * nr].reshape(nr, t2).T.reshape(
        t, t, model.n_max_radial + 1, model.basis_size_radial + 1)
    c_ang = c[t2 * nr:].reshape(na, t2).T.reshape(
        t, t, model.n_max_angular + 1, model.basis_size_angular + 1)
    if q_scaler is None:
        q_scaler = torch.ones(dim, dtype=theta.dtype, device=theta.device)
    return NepParams(
        w0=w0, b0=b0, w1=w1, b1=b1,
        b1_type=(torch.stack(b1_type) if b1_type else
                 torch.zeros(t, dtype=theta.dtype, device=theta.device)),
        c_radial=c_rad, c_angular=c_ang, q_scaler=q_scaler, **pol, **charge)


def variable_types(model: NepModel) -> np.ndarray:
    """Element class of each trainable variable (ref: snes.cu
    find_type_of_variable): an ANN block of type t -> t; the global bias
    -> num_types; a c parameter -> its t1."""
    t, neu, dim = model.num_types, model.neurons, model.dim
    per_type = (dim + 2) * neu + (1 if model.version == 5 else 0)
    out = []
    for ty in range(t):
        out += [ty] * per_type
    out += [t]  # global bias
    nr = (model.n_max_radial + 1) * (model.basis_size_radial + 1)
    na = (model.n_max_angular + 1) * (model.basis_size_angular + 1)
    for _ in range(nr + na):
        for t1 in range(t):
            out += [t1] * t
    return np.asarray(out, dtype=np.int32)


def write_nep_txt(path: str, model: NepModel, theta, q_scaler):
    """Write a nep.txt the reference MD engine reads (ref: the format of
    nep.cu:100-395): the same bytes as the JAX package's writer."""
    name = f"nep{model.version}"
    if model.zbl:
        name += "_zbl"
    name += {1: "_dipole", 2: "_polarizability",
             3: "_temperature"}.get(model.model_type, "")
    if model.charge_mode:
        name += f"_charge{model.charge_mode}"
    lines = [f"{name} {model.num_types} " + " ".join(model.symbols)]
    if model.zbl:
        zline = f"zbl {model.zbl_rc_inner} {model.zbl_rc_outer}"
        if model.zbl_typewise_factor > 0.0:
            zline += f" {model.zbl_typewise_factor}"
        lines.append(zline)
    # global cutoffs and the raw (un-enlarged) MN
    mn_r = int(np.ceil(model.mn_radial / 1.25))
    mn_a = int(np.ceil(model.mn_angular / 1.25))
    lines.append(f"cutoff {model.rc_radial[0]} {model.rc_angular[0]} "
                 f"{mn_r} {mn_a}")
    lines.append(f"n_max {model.n_max_radial} {model.n_max_angular}")
    lines.append(f"basis_size {model.basis_size_radial} "
                 f"{model.basis_size_angular}")
    lines.append(f"l_max {model.l_max} "
                 + " ".join(str(v) for v in model.has_q[:2]))
    lines.append(f"ANN {model.neurons} 0")

    def host(x):
        if torch.is_tensor(x):
            x = x.detach().cpu()
        return np.asarray(x, dtype=np.float64)

    lines += [f"{v:15.7e}" for v in host(theta)]
    lines += [f"{v:15.7e}" for v in host(q_scaler)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def random_params(model: NepModel, seed: int = 0, dtype=torch.float32,
                  device=torch.device("cuda")) -> NepParams:
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
