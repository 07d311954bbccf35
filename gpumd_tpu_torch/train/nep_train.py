"""Differentiable NEP training: batched forward, loss, Adam steps.

Counterpart of gpumd_tpu/train/nep_train.py, the analog of the
reference's gradient trainer `gnep` (ref: src/main_gnep/: analytic
dE/dtheta + dF/dtheta kernels, Adam with decoupled weight decay
adam.cuh:25-58, cosine LR fitness.cu:317-328).

Where the reference hand-writes ~3.5k lines of parameter-gradient kernels
(gradients.cuh), force errors are differentiated here straight through the
r12 -> energy vjp (torch.func.vjp, whose result plain autograd
differentiates again).  The same batched forward serves SNES fitness
evaluation (train/snes.py), which maps it over the population axis with
torch.func.vmap.  All of it is plain torch: the JAX trainers reach no
Pallas kernel, and these launch no hand-written one.

Forces are reduced by a gather through the batch's reverse map
(`StructureBatch.rev`) where the JAX package uses segment_sum: the order
of its sums is fixed, on the card too.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from gpumd_tpu_torch.potentials.nep.charge import two_head_energy_charge
from gpumd_tpu_torch.potentials.nep.model import NEP
from gpumd_tpu_torch.potentials.nep.params import NepModel, NepParams
from gpumd_tpu_torch.train.dataset import StructureBatch
from gpumd_tpu_torch.units import K_C, PI


class ConfigOutput(NamedTuple):
    energy: torch.Tensor  # (C,) total energy
    force: torch.Tensor  # (C, A, 3)
    virial: torch.Tensor  # (C, 6) Voigt xx yy zz xy yz zx
    # qNEP extras (None for plain models)
    qsum: Optional[torch.Tensor] = None  # (C,) raw total predicted charge
    bec: Optional[torch.Tensor] = None  # (C, A, 9) Born effective charges
    # per-atom tensorial observable for atomic_v TNEP training (C, A, 6)
    avirial: Optional[torch.Tensor] = None


def _pair_types(batch: StructureBatch) -> torch.Tensor:
    """Neighbour types t2 (C, A, MN): each config's types at idx."""
    c, a, mn = batch.idx.shape
    return torch.gather(batch.type.long(), 1,
                        batch.idx.reshape(c, a * mn).long()).reshape(c, a, mn)


def _energies_and_partials(nep: NEP, batch: StructureBatch):
    """Per-atom energies e (C, A) and p = d sum(e * mask) / d r12 (C, A,
    MN, 3).  An atom's energy depends on its own rows only, so the configs
    run as one flat set of atoms."""
    c, a, mn, _ = batch.r12.shape
    t1 = batch.type.reshape(c * a)
    t2 = _pair_types(batch).reshape(c * a, mn)

    def e_fn(r12):
        return nep.per_atom_energy(r12.reshape(c * a, mn, 3), t1,
                                   t2).reshape(c, a)

    e_atom, vjp = torch.func.vjp(e_fn, batch.r12)
    (p,) = vjp(batch.mask.to(e_atom.dtype))
    return e_atom, p


def _mirror(p, batch: StructureBatch):
    """p at each slot's mirror pair (C, A, MN, 3), zero on padded slots."""
    c, a, mn, _ = p.shape
    rows = batch.rev.reshape(c, a * mn, 1).expand(-1, -1, 3)
    p_rev = torch.gather(p.reshape(c, a * mn, 3), 1, rows)
    return p_rev.reshape(c, a, mn, 3) * batch.nbr_mask[..., None]


def _voigt(w):
    """(..., 3, 3) -> (..., 6) xx yy zz xy yz zx."""
    return torch.stack([w[..., 0, 0], w[..., 1, 1], w[..., 2, 2],
                        w[..., 0, 1], w[..., 1, 2], w[..., 2, 0]], dim=-1)


def batched_forward(model: NepModel, params: NepParams,
                    batch: StructureBatch) -> ConfigOutput:
    """Energy/forces/virial for every config in the batch.

    For TNEP models the tensorial observable rides the virial slots like
    the reference (dipole -> first 3 Voigt components, polarizability ->
    all 6; ref: tnep.cu, structure.cu:351-404)."""
    if model.model_type in (1, 2):
        return _batched_forward_tnep(model, params, batch)
    if model.charge_mode:
        return _batched_forward_charge(model, params, batch)
    e_atom, p = _energies_and_partials(NEP(model, params), batch)
    mask = batch.mask.to(e_atom.dtype)
    e_total = torch.sum(e_atom * mask, dim=1)
    force = (torch.sum(p, dim=2)
             - torch.sum(_mirror(p, batch), dim=2)) * mask[..., None]
    # total virial: W = sum_pairs -r12 (x) p
    rm = batch.r12 * batch.nbr_mask[..., None]
    w = -torch.einsum("camx,camy->cxy", rm, p)
    return ConfigOutput(energy=e_total, force=force, virial=_voigt(w))


def _batched_forward_tnep(model: NepModel, params: NepParams,
                          batch: StructureBatch) -> ConfigOutput:
    """TNEP dipole/polarizability forward: the observable lands in the
    virial slots (dipole -> 0:3; polarizability -> Voigt 6 incl. the
    second-head diagonal; ref: tnep.cu find_descriptors/apply_ann).

    The per-atom `avirial` output (atomic_v training, ref:
    dataset.cu:766-830 get_rmse_avirial) attributes each bond term to the
    atom whose neighbour row produced it: the decomposition sums exactly
    to the global observable."""
    nep = NEP(model, params)
    _, p = _energies_and_partials(nep, batch)
    r12 = batch.r12
    mask = batch.mask.to(r12.dtype)
    if model.model_type == 1:
        # mu_a = - sum_pairs |r12|^2 p_a (both pair directions listed)
        r2 = torch.sum(r12 * r12, dim=-1) * batch.nbr_mask
        mu = -torch.einsum("cnm,cnma->ca", r2, p)
        voigt = torch.cat([mu, torch.zeros_like(mu)], dim=-1)
        # per-atom attribution (own neighbour row; sums to the total)
        mu_atom = -torch.einsum("cnm,cnma->cna", r2, p)
        av = torch.cat([mu_atom, torch.zeros_like(mu_atom)], dim=-1)
    else:
        c, a, mn, _ = r12.shape
        rm = r12 * batch.nbr_mask[..., None]
        w = -torch.einsum("camx,camy->cxy", rm, p)
        w = 0.5 * (w + w.transpose(1, 2))
        dtype = r12.dtype
        t1 = batch.type.reshape(c * a)
        q, _ = nep.raw_descriptors(r12.reshape(c * a, mn, 3), t1,
                                   _pair_types(batch).reshape(c * a, mn))
        q = q * params.q_scaler.to(dtype)
        x1 = torch.tanh(torch.einsum("pd,tud->ptu", q,
                                     params.w0_pol.to(dtype))
                        - params.b0_pol.to(dtype)[None])
        f_t = torch.einsum("ptu,tu->pt", x1, params.w1_pol.to(dtype))
        f_pol = torch.gather(f_t, 1, t1.long()[:, None])[:, 0]
        f_pol = (f_pol - params.b1_pol.to(dtype)).reshape(c, a) * mask
        diag = torch.sum(f_pol, dim=1)
        eye = torch.eye(3, dtype=dtype, device=r12.device)
        voigt = _voigt(w + diag[:, None, None] * eye)
        # per-atom attribution: own bond row + own diagonal head
        wa = -torch.einsum("camx,camy->caxy", rm, p)
        wa = 0.5 * (wa + wa.transpose(2, 3))
        av = _voigt(wa + f_pol[..., None, None] * eye)
    c = r12.shape[0]
    return ConfigOutput(
        energy=torch.zeros(c, dtype=r12.dtype, device=r12.device),
        force=torch.zeros_like(r12[:, :, 0, :]), virial=voigt,
        avirial=av * mask[..., None])


def _batched_forward_charge(model: NepModel, params: NepParams,
                            batch: StructureBatch) -> ConfigOutput:
    """qNEP training forward: the two-head ANN, the charges shifted to each
    config's total, the erfc real-space pairs (charge_mode 1) and the
    reciprocal Ewald sum; forces from one vjp over r12 and the positions
    as separate leaves, the analytic reciprocal virial, the raw charge
    sums and the Born effective charges in the bond-centred gauge times
    sqrt(eps_inf) for the lambda_q / lambda_z losses (ref: main_nep/
    nep_charge.cu find_force_charge_real_space:930-1005,
    find_k_and_G:1020-1086, zero_total_charge:1088-1123,
    find_bec_*:356-630).  torch.func throughout, so SNES maps it over the
    population as it maps the plain forward."""
    alpha = PI / model.rc_radial_max
    rc = model.rc_radial_max
    c, a, mn, _ = batch.r12.shape
    dtype = batch.r12.dtype
    mask = batch.mask.to(dtype)
    nbr_mask = batch.nbr_mask.to(dtype)
    t1 = batch.type.reshape(c * a)
    t2 = _pair_types(batch).reshape(c * a, mn)
    na = torch.clamp(torch.sum(mask, dim=1), min=1.0)  # (C,)
    flat_idx = batch.idx.reshape(c, a * mn).long()
    kvec, gk = batch.kvec.to(dtype), batch.gk.to(dtype)

    def heads(r12):
        e, q = two_head_energy_charge(model, params,
                                      r12.reshape(c * a, mn, 3), t1, t2)
        return e.reshape(c, a), q.reshape(c, a) * mask

    def total_energy(r12, pos):
        e_nep, q_raw = heads(r12)
        # shift so the config total matches the reference total charge
        q = (q_raw + ((batch.charge_ref - torch.sum(q_raw, dim=1))
                      / na)[:, None]) * mask
        if model.charge_mode == 1:
            d = torch.sqrt(torch.clamp(torch.sum(r12 * r12, dim=-1),
                                       min=1e-12))
            q_j = torch.gather(q, 1, flat_idx).reshape(c, a, mn)
            pair = torch.where((d < rc) & (nbr_mask > 0),
                               q[..., None] * q_j
                               * torch.special.erfc(alpha * d) / d,
                               torch.zeros_like(d))
            e_real = K_C * (0.5 * torch.sum(pair, dim=-1)
                            - (alpha / math.sqrt(PI)) * q * q)
        else:
            e_real = torch.zeros_like(q)
        kr = torch.einsum("cax,ckx->cak", pos, kvec)
        s_re = torch.sum(q[..., None] * torch.cos(kr), dim=1)
        s_im = -torch.sum(q[..., None] * torch.sin(kr), dim=1)
        e_rec = K_C * torch.sum(gk * (s_re ** 2 + s_im ** 2), dim=1)
        e_tot = torch.sum((e_nep + e_real) * mask, dim=1) + e_rec
        return e_tot, (torch.sum(q_raw, dim=1), q, s_re, s_im)

    e_tot, vjp, (qsum, q, s_re, s_im) = torch.func.vjp(
        total_energy, batch.r12, batch.position, has_aux=True)
    p, dpos = vjp(torch.ones_like(e_tot))
    force = (torch.sum(p, dim=2) - torch.sum(_mirror(p, batch), dim=2)
             - dpos) * mask[..., None]
    rm = batch.r12 * nbr_mask[..., None]
    w = -torch.einsum("camx,camy->cxy", rm, p)
    # analytic reciprocal virial (ref: ewald.cu find_virial_reciprocal;
    # the expression of NEPCharge.compute_with_state)
    ksq = torch.clamp(torch.sum(kvec * kvec, dim=-1), min=1e-12)
    pref = K_C * gk * (s_re ** 2 + s_im ** 2)  # (C, K)
    eye = torch.eye(3, dtype=dtype, device=p.device)
    w_rec = (torch.sum(pref, dim=1)[:, None, None] * eye
             - torch.einsum("ck,cka,ckb->cab", pref * 2.0 * (
                 1.0 / ksq + 1.0 / (4.0 * alpha ** 2)), kvec, kvec))
    w = w + w_rec

    # Born effective charges, bond-centred gauge (ref: find_bec_*)
    _, qvjp = torch.func.vjp(lambda r: heads(r)[1], batch.r12)
    (y,) = qvjp(torch.ones_like(mask))
    b = (0.5 * batch.r12[..., :, None] * y[..., None, :]
         * nbr_mask[..., None, None]).reshape(c, a, mn, 9)
    rows = batch.rev.reshape(c, a * mn, 1).expand(-1, -1, 9)
    b_rev = torch.gather(b.reshape(c, a * mn, 9), 1, rows).reshape(
        c, a, mn, 9) * nbr_mask[..., None]
    bec = (torch.sum(b, dim=2) - torch.sum(b_rev, dim=2)
           + q[..., None] * eye.reshape(9)) * params.sqrt_epsilon_inf.to(
               dtype)
    return ConfigOutput(energy=e_tot, force=force, virial=_voigt(w),
                        qsum=qsum, bec=bec)


class LossWeights(NamedTuple):
    energy: float = 1.0  # lambda_e (nep.in defaults, parameters.cu)
    force: float = 1.0  # lambda_f
    virial: float = 0.1  # lambda_v


def loss_terms(model: NepModel, params: NepParams, batch: StructureBatch
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-term MSEs (energy per atom, force components, virial per atom),
    weighted by per-config weight tags (ref: dataset.cu get_rmse_*)."""
    out = batched_forward(model, params, batch)
    na = torch.clamp(batch.n_atoms.to(out.energy.dtype), min=1.0)
    cw = batch.weight

    de = (out.energy - batch.energy_ref) / na
    mse_e = torch.sum(cw * batch.energy_weight * de * de) / torch.sum(cw)

    df = (out.force - batch.force_ref) * batch.mask[..., None]
    per_cfg_f = torch.sum(df * df, dim=(1, 2)) / (3.0 * na)
    mse_f = torch.sum(cw * per_cfg_f) / torch.sum(cw)

    dv = (out.virial - batch.virial_ref) / na[:, None]
    per_cfg_v = torch.mean(dv * dv, dim=1) * batch.has_virial
    denom = torch.clamp(torch.sum(cw * batch.has_virial), min=1e-12)
    mse_v = torch.sum(cw * per_cfg_v) / denom
    return mse_e, mse_f, mse_v


def loss_fn(model, params, batch, weights: LossWeights):
    mse_e, mse_f, mse_v = loss_terms(model, params, batch)
    total = (weights.energy * mse_e + weights.force * mse_f
             + weights.virial * mse_v)
    return total, (torch.sqrt(mse_e), torch.sqrt(mse_f), torch.sqrt(mse_v))


def param_leaves(params: NepParams):
    """The tensors of a NepParams in field order, None skipped (the JAX
    package's tree leaves)."""
    return [x for x in params if x is not None]


def with_leaves(params: NepParams, leaves) -> NepParams:
    """NepParams with its non-None fields replaced, in field order."""
    it = iter(leaves)
    return NepParams(*(None if x is None else next(it) for x in params))


class TrainState(NamedTuple):
    params: NepParams  # leaves are the optimizer's parameters
    opt_state: dict  # the optimizer's per-parameter state
    step: int


def make_train_step(model: NepModel, weights: LossWeights,
                    optimizer: torch.optim.Optimizer):
    """(state, batch) -> (state, metrics): one step of any torch optimizer
    with gradients through energies AND forces (second-order autograd).
    The optimizer must hold the leaves of state.params, which the step
    updates in place."""

    def train_step(state: TrainState, batch: StructureBatch):
        optimizer.zero_grad()
        total, rmses = loss_fn(model, state.params, batch, weights)
        total.backward()
        optimizer.step()
        return (TrainState(params=state.params, opt_state=optimizer.state,
                           step=state.step + 1),
                {"loss": total.detach(), "rmse_e": rmses[0].detach(),
                 "rmse_f": rmses[1].detach(), "rmse_v": rmses[2].detach()})

    return train_step


def cosine_lr(step, total_steps, lr_max=1e-3, lr_min=1e-5, warmup=0):
    """Cosine schedule with optional warmup (ref: gnep fitness.cu:317-328)."""
    warm = min(step / max(warmup, 1), 1.0) if warmup else 1.0
    t = min(max(step / total_steps, 0.0), 1.0)
    return warm * (lr_min + 0.5 * (lr_max - lr_min)
                   * (1 + math.cos(math.pi * t)))


class GnepState(NamedTuple):
    """gnep optimizer state: Adam moments + the gradient-norm EMA used by
    the reference's adaptive clipping (ref: main_gnep/adam.cu:132-161).
    Checkpointable: gnep.restart carries params (reference format) and a
    sidecar npz carries (m, v, step, avg_norm) so a resumed run continues
    bit-identically, stronger than the reference, whose gnep.restart
    stores parameters only (adam.cu:225-245)."""

    params: NepParams
    m: NepParams
    v: NepParams
    step: torch.Tensor  # () int32 Adam bias-correction counter
    avg_norm: torch.Tensor  # () gradient-norm EMA (-1 = unset)


def make_gnep_step(model: NepModel, weights: LossWeights,
                   weight_decay: float):
    """(state, batch, lr) -> (state, metrics): the reference gnep update:
    global-norm gradient clipping to min(EMA, 10) (adam.cu:132-161), Adam
    moments (adam.cu:37-52), bias-corrected decoupled-weight-decay step
    (adam.cu:53-72).  lr arrives per call (host-computed warmup/cosine
    schedule, fitness.cu:317-371).  As in the JAX package every leaf of
    the parameters is a variable, q_scaler and NEP4's zero b1_type
    included.  The step reads nothing back to the host."""
    beta1, beta2, eps = 0.9, 0.999, 1e-8

    def gnep_step(state: GnepState, batch: StructureBatch, lr):
        leaves = [x.detach().requires_grad_(True)
                  for x in param_leaves(state.params)]
        total, rmses = loss_fn(model, with_leaves(state.params, leaves),
                               batch, weights)
        grads = torch.autograd.grad(total, leaves)
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        avg = torch.where(state.avg_norm < 0, norm,
                          0.9 * state.avg_norm + 0.1 * norm)
        max_norm = torch.clamp(avg, max=10.0)
        scale = torch.where(norm > max_norm, max_norm / (norm + 1e-12),
                            torch.ones_like(norm))
        grads = [g * scale for g in grads]
        m = [beta1 * mm + (1 - beta1) * g
             for mm, g in zip(param_leaves(state.m), grads)]
        v = [beta2 * vv + (1 - beta2) * g * g
             for vv, g in zip(param_leaves(state.v), grads)]
        # bias corrections in float32, as the JAX package computes them
        t = (state.step + 1).to(torch.float32)
        bc1 = 1.0 - beta1 ** t
        bc2 = 1.0 - beta2 ** t
        new = [p.detach() - lr * ((mm / bc1) / (torch.sqrt(vv / bc2) + eps)
                                  + weight_decay * p.detach())
               for p, mm, vv in zip(leaves, m, v)]
        new_state = GnepState(params=with_leaves(state.params, new),
                              m=with_leaves(state.m, m),
                              v=with_leaves(state.v, v),
                              step=state.step + 1, avg_norm=avg.detach())
        rmses = [r.detach() for r in rmses]
        return new_state, {
            "loss": total.detach(), "rmse_e": rmses[0], "rmse_f": rmses[1],
            "rmse_v": rmses[2], "mse_e": rmses[0] ** 2,
            "mse_f": rmses[1] ** 2, "mse_v": rmses[2] ** 2}

    return gnep_step


def gnep_lr(step: int, num_batches: int, maximum_steps: int, cfg):
    """Host-side LR schedule, the reference's update_learning_rate_cos /
    _cos_restart verbatim (fitness.cu:317-371)."""
    start_lr, stop_lr = cfg.start_lr, cfg.stop_lr
    if not cfg.lr_restart_enable:
        warmup_steps = 1 * num_batches
        if step < warmup_steps:
            return stop_lr + (step / warmup_steps) * (start_lr - stop_lr)
        progress = (step - warmup_steps) / max(
            maximum_steps - warmup_steps, 1)
        smooth = 0.5 * (1.0 + math.cos(math.pi * progress))
        return stop_lr + (start_lr - stop_lr) * smooth
    warmup_steps = cfg.lr_warmup_epochs * num_batches
    if step < warmup_steps:
        return stop_lr + (step / warmup_steps) * (start_lr - stop_lr)
    initial_period = cfg.lr_restart_initial_period_epochs * num_batches
    pf = cfg.lr_restart_period_factor
    df = cfg.lr_restart_decay_factor
    steps_since = step - warmup_steps
    total = maximum_steps - warmup_steps
    cycle = 0
    cycle_start = 0
    cycle_len = initial_period
    cum = 0
    while cum + cycle_len <= steps_since:
        cum += cycle_len
        cycle_start = cum
        cycle += 1
        cycle_len = int(initial_period * pf ** cycle)
    if cum + cycle_len > total:
        cycle_len = max(total - cum, 1)
    progress = (steps_since - cycle_start) / cycle_len
    cycle_max = max(start_lr * df ** cycle, stop_lr)
    smooth = 0.5 * (1.0 + math.cos(math.pi * progress))
    return stop_lr + (cycle_max - stop_lr) * smooth
