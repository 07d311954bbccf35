"""SNES (separable natural evolution strategy) NEP trainer.

Counterpart of gpumd_tpu/train/snes.py (ref: src/main_nep/snes.cu).  As
in the JAX package:
  * the population is evaluated by one map over the batched forward
    (torch.func.vmap over theta, in chunks sized to the device's memory;
    the reference round-robins individuals over GPUs, fitness.cu:158-199);
  * the per-element ranked update (snes.cu:252-293, 564-592) is fully
    vectorized: each variable class (per-type ANN block / c rows / global
    bias) is updated with the population ordering of ITS OWN type-resolved
    fitness, all types at once;
  * a generation stays on the device: the host reads values only for a
    loss.out row.

Matching reference conventions:
  utilities  u_k = max(0, ln(P/2+1) - ln(k+1)), normalized, minus 1/P
  eta_sigma  = (3 + ln(D/T)) / (5 sqrt(D/T)) / 2
  update     mu += sigma * sum_k u_k z_(k);  sigma *= exp(eta * sum u (z^2-1))
             (sigma capped at 1.0), rankings per variable type
  lambda auto: sqrt(D * 1e-6 / T)
  fitness[t] = L1[t] + L2[t] + lambda_e RMSE_e[t] + lambda_f RMSE_f[t]
               + lambda_v RMSE_v[t]   for t = 0..T-1 and t = T (global),
    where RMSE_*[t] pools configs containing element t
    (ref: dataset.cu get_rmse_energy/force/virial per-type arrays)
  q_scaler   = 1 / (max q - min q) over the training set

The normal draws z come from a torch.Generator on the device, seeded from
cfg.seed (a resumed run from (seed, generation)); the JAX package draws
them with jax.random, a different stream.  The numpy draws (mu at the
start) are the same in both packages.

The population may be cut over a `devices` list (SNESTrainer(devices=...);
by default every visible card when there are several, as the JAX package
shards the population over its mesh): the population is rounded up to a
multiple of their number (ref: parameters.cu:132-140), each device
evaluates its share on its own copy of the batches (the reference's
round-robin of individuals over GPUs, fitness.cu:158-199), and the
fitness is gathered on the first device, which ranks and updates.  One
process drives every device; a devices list may repeat an entry.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from gpumd_tpu_torch.io.nep_input import NepTrainConfig
from gpumd_tpu_torch.potentials.nep.model import NEP
from gpumd_tpu_torch.potentials.nep.params import (
    NepModel,
    global_bias_index,
    num_trainable,
    params_from_vector,
    write_nep_txt,
)
from gpumd_tpu_torch.train.dataset import StructureBatch
from gpumd_tpu_torch.train.nep_train import _pair_types, batched_forward

# Bytes of device memory an individual's evaluation may hold a pair slot
# (forward and vjp of the NEP4 energy): ~330 measured for config 5 on an
# H100 (chip_smoke's train phase), 3x that here.  The population runs in
# chunks that keep chunk * slots * this under half the free memory.
BYTES_PER_SLOT = 1024
# The same for an (atom, k-vector) term of a qNEP batch's Ewald sums:
# k.r, its cos and sin, their products with q, and the saved tensors of
# the two vjps (the forces and the Born charges), ~16 float32 (A, K)
# tensors an individual.
BYTES_PER_KTERM = 64


class SNESState(NamedTuple):
    mu: torch.Tensor  # (D,)
    sigma: torch.Tensor  # (D,)
    generator: torch.Generator  # the normal draws, on mu's device
    generation: int


def _utilities(population_size: int) -> np.ndarray:
    k = np.arange(population_size)
    u = np.maximum(0.0, np.log(population_size * 0.5 + 1.0) - np.log(k + 1.0))
    return (u / u.sum() - 1.0 / population_size).astype(np.float32)


def type_of_variable_vector(model: NepModel) -> np.ndarray:
    """(D,) int: owning element of each trainable variable, T = shared/global
    (ref: snes.cu:252-293 find_type_of_variable).  Layout must mirror
    params_from_vector: per-type ANN blocks, global bias, then the c array
    basis-major with type-pair (t1*T+t2) minor; c rows belong to t1."""
    t = model.num_types
    neu, dim = model.neurons, model.dim
    if model.charge_mode:
        # per type w0/b0/w1e/w1q; then sqrt_eps_inf + b1 global
        per_type = (dim + 3) * neu
        tov = []
        for ty in range(t):
            tov.extend([ty] * per_type)
        tov.extend([t, t])
    else:
        per_type = (dim + 2) * neu + (1 if model.version == 5 else 0)
        tov = []
        num_ann = 2 if model.model_type == 2 else 1  # pol: second head
        for _ in range(num_ann):
            for ty in range(t):
                tov.extend([ty] * per_type)
            tov.append(t)  # global output bias
    nr = (model.n_max_radial + 1) * (model.basis_size_radial + 1)
    na = (model.n_max_angular + 1) * (model.basis_size_angular + 1)
    for _ in range(nr + na):
        for t1 in range(t):
            tov.extend([t1] * t)
    out = np.asarray(tov, np.int32)
    if out.shape[0] != num_trainable(model):
        raise ValueError("variable classes do not cover the vector")
    return out


_FOUNDATION_TYPES = 89  # nep89 foundation model element count


def _element_index_89(z: int) -> int:
    """Foundation-model slot of atomic number z (ref: snes.cu:148-155:
    Po/At/Rn/Fr/Ra are absent from the 89-element foundation model)."""
    missing = (84, 85, 86, 87, 88)
    if z in missing or z < 1 or z > 94:
        return 0
    return z - 1 - sum(1 for m in missing if m < z)


def fine_tune_init(model: NepModel, cfg: NepTrainConfig):
    """(mu, sigma, q_scaler) bootstrapped from an 89-element foundation model
    (ref: snes.cu:144-238 for mu/sigma, parameters.cu:263-281 for q_scaler).

    Slices the user's elements' ANN blocks and (t1, t2) c rows out of the
    foundation nep.restart; descriptor sigmas are zeroed (frozen) unless
    fine_tune_descriptor.  The global-bias slot starts at (0, 0) as in the
    reference (its vectors are zero-initialized and the slot is skipped)."""
    nf = _FOUNDATION_TYPES
    per_ann = ((model.dim + 2) * model.neurons
               + (1 if model.version == 5 else 0))
    num_ann = nf * per_ann + 1
    nr = (model.n_max_radial + 1) * (model.basis_size_radial + 1)
    na = (model.n_max_angular + 1) * (model.basis_size_angular + 1)
    num_tot = num_ann + nf * nf * (nr + na)
    arr = np.loadtxt(cfg.fine_tune_nep_restart)
    if arr.shape != (num_tot, 2):
        raise ValueError(
            f"foundation restart {cfg.fine_tune_nep_restart}: expected "
            f"{num_tot} rows x 2 cols for this architecture, got {arr.shape}")
    rmu, rsig = arr[:, 0], arr[:, 1]
    d = num_trainable(model)
    t = model.num_types
    mu = np.zeros(d)
    sigma = np.zeros(d)
    cnt = 0
    for ty in range(t):
        ei = _element_index_89(model.atomic_numbers[ty])
        mu[cnt:cnt + per_ann] = rmu[ei * per_ann:(ei + 1) * per_ann]
        sigma[cnt:cnt + per_ann] = rsig[ei * per_ann:(ei + 1) * per_ann]
        cnt += per_ann
    cnt += 1  # global bias stays (0, 0)
    eidx = [_element_index_89(z) for z in model.atomic_numbers]
    for nk in range(nr + na):
        base = num_ann + nk * nf * nf
        for t1 in range(t):
            for t2 in range(t):
                src = base + eidx[t1] * nf + eidx[t2]
                mu[cnt] = rmu[src]
                sigma[cnt] = rsig[src] if cfg.fine_tune_descriptor else 0.0
                cnt += 1
    q_scaler = read_q_scaler_from_nep_txt(cfg.fine_tune_nep_txt, model.dim,
                                          num_tot)
    return mu, sigma, q_scaler


def read_q_scaler_from_nep_txt(path: str, dim: int, num_params: int):
    """q_scaler block of a nep.txt: skip 7 header + num_params parameter
    lines, read dim scaler lines (ref: parameters.cu:274-281, 292-301)."""
    with open(path) as f:
        rows = [ln.split() for ln in f if ln.split()]
    vals = [float(row[0]) for row in rows[7 + num_params:7 + num_params + dim]]
    if len(vals) != dim:
        raise ValueError(f"{path}: expected {dim} q_scaler lines")
    return np.asarray(vals)


def per_type_rmses(model: NepModel, cfg: NepTrainConfig, out, batch,
                   use_weight: bool = True, do_shift: bool = False,
                   return_shift: bool = False):
    """Type-resolved (T+1,) RMSE arrays, reference pooling conventions
    (ref: dataset.cu:630-678 force, 892-951 energy, 998-1041 virial).

    t < T pools configs CONTAINING element t; t = T pools all.  Training
    weights (config weight^2, per-element type_weight, force_delta
    demotion, lambda_shear on shear virials) apply when use_weight.

    `do_shift` subtracts the energy_weight-weighted mean per-structure
    energy error before the energy RMSE (ref: dataset.cu:823-922
    gpu_get_energy_shift + do_shift in get_rmse_energy): the reference's
    energy fitness is SHIFT-INVARIANT, so SNES never has to evolve the
    constant offset (it is absorbed into the elite's output bias at save
    time, fitness.cu:457)."""
    t = model.num_types
    dtype = out.energy.dtype
    dev = out.energy.device
    na = torch.clamp(batch.n_atoms.to(dtype), min=1.0)
    cw2 = batch.weight ** 2 if use_weight else torch.ones_like(batch.weight)
    # has_type: (C, T+1) config-contains-element indicator
    onehot = (torch.nn.functional.one_hot(batch.type.long(), t).to(dtype)
              * batch.mask[..., None])
    has_type = torch.cat(
        [(torch.sum(onehot, dim=1) > 0).to(dtype),
         torch.ones((batch.num_configs, 1), dtype=dtype, device=dev)], dim=1)

    def pool(err, count):
        return torch.einsum("c,ct->t", err, has_type), torch.einsum(
            "c,ct->t", count, has_type)

    # energy: per-config ((E-Eref)/Na - shift)^2 * energy_weight
    de = (out.energy - batch.energy_ref) / na
    ew = batch.energy_weight
    shift = torch.zeros((), dtype=dtype, device=dev)
    if do_shift:
        shift = torch.sum(de * ew) / torch.clamp(torch.sum(ew), min=1e-12)
        de = de - shift
    err_e = ew * de * de
    num_e, cnt_e = pool(cw2 * err_e, torch.ones_like(err_e))
    rmse_e = torch.sqrt(num_e / torch.clamp(cnt_e, min=1.0))

    # force: pooled atoms; type_weight^2 and force_delta demotion per atom
    df2 = torch.sum((out.force - batch.force_ref) ** 2, dim=-1)  # (C, A)
    if use_weight:
        if cfg.type_weight and any(w != 1.0 for w in cfg.type_weight):
            tw = torch.as_tensor(cfg.type_weight[:t], dtype=dtype,
                                 device=dev)[batch.type.long()]
            df2 = df2 * tw * tw
        if cfg.force_delta > 0.0:
            fmag = torch.sqrt(torch.sum(batch.force_ref ** 2, dim=-1))
            df2 = df2 * (cfg.force_delta / (cfg.force_delta + fmag))
    err_f = torch.sum(df2 * batch.mask, dim=1)  # (C,)
    num_f, cnt_f = pool(cw2 * err_f, na)
    rmse_f = torch.sqrt(num_f / torch.clamp(cnt_f * 3.0, min=1.0))

    # virial: 6 Voigt components per config, shear (d>=3) scaled
    if (cfg.atomic_v and getattr(out, "avirial", None) is not None
            and batch.has_avirial is not None):
        # per-ATOM tensorial comparison (ref: dataset.cu:766-830)
        nd = 3.0 if cfg.model_type == 1 else 6.0
        d_av = out.avirial - batch.avirial_ref
        if cfg.model_type == 1:
            d_av = d_av[..., :3]
        err_v = torch.sum(d_av ** 2 * batch.mask[..., None],
                          dim=(1, 2)) * batch.has_avirial
        hv = has_type * batch.has_avirial[:, None]
        num_v = torch.einsum("c,ct->t", cw2 * err_v, hv)
        cnt_v = torch.clamp(torch.einsum("c,ct->t", na, hv) * nd, min=1e-12)
    else:
        dv = (out.virial - batch.virial_ref) / na[:, None]
        sw = cfg.lambda_shear ** 2 if use_weight else 1.0
        err_v = (torch.sum(dv[:, :3] ** 2, dim=1)
                 + sw * torch.sum(dv[:, 3:] ** 2, dim=1)) * batch.has_virial
        hv = has_type * batch.has_virial[:, None]
        num_v = torch.einsum("c,ct->t", cw2 * err_v, hv)
        cnt_v = torch.clamp(torch.einsum("c,ct->t", torch.ones_like(err_v),
                                         hv) * 6.0, min=1e-12)
    rmse_v = torch.sqrt(num_v / cnt_v)

    # qNEP: total-charge + Born-effective-charge RMSEs, reference pooling
    # (ref: dataset.cu:1112-1191: unweighted; charge counts 1 per config,
    # bec counts 9 per config with the error pre-divided by Na)
    if getattr(out, "qsum", None) is not None:
        dq = (out.qsum - batch.charge_ref) / na
        num_q, cnt_q = pool(dq * dq, torch.ones_like(dq))
        rmse_q = torch.sqrt(num_q / torch.clamp(cnt_q, min=1.0))
        db2 = torch.sum((out.bec - batch.bec_ref) ** 2
                        * batch.mask[..., None], dim=(1, 2)) / na
        hb = has_type * batch.has_bec[:, None]
        num_b = torch.einsum("c,ct->t", db2, hb)
        cnt_b = torch.einsum("c,ct->t", torch.ones_like(db2), hb) * 9.0
        rmse_b = torch.sqrt(num_b / torch.clamp(cnt_b, min=1e-12))
    else:
        rmse_q = torch.zeros((t + 1,), dtype=dtype, device=dev)
        rmse_b = torch.zeros((t + 1,), dtype=dtype, device=dev)
    if return_shift:
        return rmse_e, rmse_f, rmse_v, rmse_q, rmse_b, shift
    return rmse_e, rmse_f, rmse_v, rmse_q, rmse_b


@torch.no_grad()
def compute_q_scaler(model: NepModel, theta, batches: List[StructureBatch]):
    """1/(max-min) per descriptor dim over the whole training set, at the
    parameter vector theta, on the batches' device."""
    dev = batches[0].r12.device
    theta = torch.as_tensor(np.asarray(theta), device=dev)
    nep = NEP(model, params_from_vector(model, theta))
    qmax = torch.full((model.dim,), -1e6, dtype=theta.dtype, device=dev)
    qmin = torch.full((model.dim,), 1e6, dtype=theta.dtype, device=dev)
    for b in batches:
        c, a, mn, _ = b.r12.shape
        q, _ = nep.raw_descriptors(b.r12.reshape(c * a, mn, 3),
                                   b.type.reshape(c * a),
                                   _pair_types(b).reshape(c * a, mn))
        real = b.mask.reshape(c * a, 1) > 0
        qmax = torch.maximum(qmax, torch.where(real, q, -1e6).amax(0))
        qmin = torch.minimum(qmin, torch.where(real, q, 1e6).amin(0))
    return 1.0 / torch.clamp(qmax - qmin, min=1e-6)


def individual_bytes(batch: StructureBatch) -> int:
    """Device bytes one individual of a vmapped evaluation of `batch`
    takes: BYTES_PER_SLOT a pair slot and, on a qNEP batch,
    BYTES_PER_KTERM an (atom, k-vector) term of the Ewald sums."""
    per = BYTES_PER_SLOT * batch.idx.numel()
    if batch.kvec is not None:
        per += BYTES_PER_KTERM * batch.mask.numel() * batch.kvec.shape[1]
    return per


def population_chunk(pop: int, batch: StructureBatch) -> int:
    """Individuals a vmapped evaluation holds at once: all of them off the
    card; on it as many as half the free device memory takes at
    individual_bytes each."""
    if batch.r12.device.type != "cuda":
        return pop
    free, _ = torch.cuda.mem_get_info(batch.r12.device)
    return int(max(1, min(pop, (free // 2) // individual_bytes(batch))))


def make_population_pieces(model: NepModel, cfg: NepTrainConfig, q_scaler,
                           lambda_1: float, lambda_2: float,
                           chunk: Optional[int] = None):
    """Three pieces of one SNES generation: sample / evaluate / update.

    Split so the trainer can evaluate the SAME population over several
    batches (use_full_batch combines per-batch RMSEs as a quadratic mean,
    ref: fitness.cu:202-256) before the ranked update.  `evaluate` maps
    the forward over `chunk` individuals at a time (default
    population_chunk)."""
    d = num_trainable(model)
    pop = cfg.population_size
    t = model.num_types
    per_class = d / t
    eta_sigma = float((3.0 + np.log(per_class))
                      / (5.0 * np.sqrt(per_class)) / 2.0)
    utility = _utilities(pop)
    tov = type_of_variable_vector(model)  # (D,) in 0..T
    # variable-class masks: rows 0..T-1 per-element, row T = everything
    vmask = np.concatenate(
        [np.eye(t + 1, dtype=np.float32)[tov][:, :t].T,
         np.ones((1, d), np.float32)], axis=0)  # (T+1, D)
    nv_class = np.concatenate(
        [np.full((t,), d / t, np.float32), np.asarray([float(d)])]
    ).astype(np.float32)
    consts = {}

    def const(name, like):
        key = (name, like.dtype, like.device)
        if key not in consts:
            src = {"utility": utility, "vmask": vmask, "nv_class": nv_class,
                   "tov": tov}[name]
            consts[key] = torch.as_tensor(
                src, device=like.device,
                dtype=torch.int64 if name == "tov" else like.dtype)
        return consts[key]

    def sample(state: SNESState):
        z = torch.randn((pop, d), generator=state.generator,
                        dtype=state.mu.dtype, device=state.mu.device)
        thetas = state.mu[None, :] + state.sigma[None, :] * z
        return z, thetas

    def one(theta, batch):
        qs = torch.as_tensor(q_scaler, dtype=theta.dtype, device=theta.device)
        out = batched_forward(model, params_from_vector(model, theta, qs),
                              batch)
        # shift-invariant energy fitness (ref: fitness.cu:178-180 passes
        # do_shift=true for every population evaluation)
        return per_type_rmses(model, cfg, out, batch, do_shift=True)

    def evaluate(thetas, batch: StructureBatch):
        size = chunk or population_chunk(thetas.shape[0], batch)
        fn = torch.func.vmap(lambda th: one(th, batch))
        with torch.no_grad():
            parts = [fn(thetas[s:s + size])
                     for s in range(0, thetas.shape[0], size)]
        return tuple(torch.cat(cols) for cols in zip(*parts))

    def update(state: SNESState, z, thetas, rmse_e, rmse_f, rmse_v, rmse_q,
               rmse_b):
        vm, nv = const("vmask", thetas), const("nv_class", thetas)
        # per-class L1/L2 regularization (ref: snes.cu:462-533)
        cost_l1 = lambda_1 * (torch.abs(thetas) @ vm.T) / nv
        cost_l2 = lambda_2 * torch.sqrt((thetas ** 2 @ vm.T) / nv)
        fitness = (cost_l1 + cost_l2 + cfg.lambda_e * rmse_e
                   + cfg.lambda_f * rmse_f + cfg.lambda_v * rmse_v
                   + cfg.lambda_q * rmse_q + cfg.lambda_z * rmse_b)
        # (pop, T+1) per-class ranking
        order = torch.argsort(fitness, dim=0, stable=True)
        # ranked natural gradients per class, then per-variable selection
        z_by_class = z[order.T]  # (T+1, pop, D)
        u = const("utility", z)
        g_mu = torch.einsum("p,tpd->td", u, z_by_class)
        g_sig = torch.einsum("p,tpd->td", u, z_by_class ** 2 - 1.0)
        tv = const("tov", z)[None, :]
        grad_mu = torch.gather(g_mu, 0, tv)[0]
        grad_sigma = torch.gather(g_sig, 0, tv)[0]
        mu = state.mu + state.sigma * grad_mu
        sigma = torch.clamp(state.sigma * torch.exp(eta_sigma * grad_sigma),
                            max=1.0)
        best = order[0, t]  # global-fitness best (ref: snes.cu:370)
        metrics = {
            "fitness": fitness[best, t], "l1": cost_l1[best, t],
            "l2": cost_l2[best, t], "rmse_e": rmse_e[best, t],
            "rmse_f": rmse_f[best, t], "rmse_v": rmse_v[best, t],
            "rmse_q": rmse_q[best, t], "rmse_b": rmse_b[best, t],
            "best_theta": thetas[best]}
        return (state._replace(mu=mu, sigma=sigma,
                               generation=state.generation + 1), metrics)

    return sample, evaluate, update


def make_generation_step(model: NepModel, cfg: NepTrainConfig, q_scaler,
                         lambda_1: float, lambda_2: float,
                         chunk: Optional[int] = None):
    """(state, batch) -> (state, metrics) for one SNES generation
    (single-batch convenience wrapper around make_population_pieces)."""
    sample, evaluate, update = make_population_pieces(
        model, cfg, q_scaler, lambda_1, lambda_2, chunk)

    def step(state: SNESState, batch: StructureBatch):
        z, thetas = sample(state)
        return update(state, z, thetas, *evaluate(thetas, batch))

    return step


def batch_on(batch: StructureBatch, device) -> StructureBatch:
    """The batch with its tensors on `device`."""
    return batch._replace(**{k: v.to(device)
                             for k, v in batch._asdict().items()
                             if isinstance(v, torch.Tensor)})


def sharded_evaluate(evaluate, devices: Sequence[torch.device]):
    """`evaluate(thetas, batch)` with the population cut into one equal
    share a device: each share runs on its device against that device's
    copy of the batch (made once a batch), and the RMSEs come back to the
    first device in population order."""
    devices = [torch.device(d) for d in devices]
    copies = {}

    def ctx(dev):
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def run(thetas, batch: StructureBatch):
        key = id(batch)
        if key not in copies:
            copies[key] = (batch, [batch if batch.r12.device == d
                                   else batch_on(batch, d)
                                   for d in devices])
        share = thetas.shape[0] // len(devices)
        outs = []
        for j, (dev, b) in enumerate(zip(devices, copies[key][1])):
            with ctx(dev):
                outs.append(evaluate(
                    thetas[j * share:(j + 1) * share].to(dev), b))
        dev0 = thetas.device
        return tuple(torch.cat([o[k].to(dev0) for o in outs])
                     for k in range(len(outs[0])))

    return run


def _generator(seed: int, gen_offset: int, device) -> torch.Generator:
    """The draws' generator: seeded from cfg.seed, and from (seed,
    generation) on a resumed run, which branches the stream instead of
    replaying generation 0's draws."""
    g = torch.Generator(device=device)
    if gen_offset:
        seed = int(np.random.SeedSequence([seed, gen_offset])
                   .generate_state(1, np.uint64)[0] >> np.uint64(1))
    g.manual_seed(seed)
    return g


class SNESTrainer:
    """The training loop: batches round-robin per generation, loss.out,
    nep.txt / nep.restart checkpoints (ref: snes.cu:295-422)."""

    def __init__(self, model: NepModel, cfg: NepTrainConfig,
                 batches: List[StructureBatch], workdir: str = ".",
                 dtype=torch.float32,
                 test_batches: List[StructureBatch] = (),
                 devices: Optional[Sequence] = None):
        device = batches[0].r12.device
        # the population over several devices: every visible card when
        # there are several (the JAX package's default mesh), else an
        # explicit list; rounded up to a multiple of their number
        if devices is None:
            count = (torch.cuda.device_count() if device.type == "cuda"
                     else 0)
            devices = ([torch.device("cuda", i) for i in range(count)]
                       if count > 1 else [device])
        self.devices = [torch.device(d) for d in devices]
        nd = len(self.devices)
        if cfg.population_size % nd:
            cfg = dataclasses.replace(
                cfg, population_size=cfg.population_size + nd
                - cfg.population_size % nd)
        self.model = model
        self.cfg = cfg
        self.batches = batches
        self.test_batches = list(test_batches)
        self.workdir = workdir
        d = num_trainable(model)
        self.d = d
        lam_auto = float(np.sqrt(d * 1.0e-6 / model.num_types))
        self.lambda_1 = cfg.lambda_1 if cfg.lambda_1 >= 0 else lam_auto
        self.lambda_2 = cfg.lambda_2 if cfg.lambda_2 >= 0 else lam_auto

        rng = np.random.default_rng(cfg.seed)
        restart = os.path.join(workdir, "nep.restart")
        q_scaler = None
        # generation numbering continues across restarts: a resumed run
        # appends to loss.out from where the checkpointed run stopped (the
        # reference reloads nep.restart the same way, snes.cu:106-137; its
        # loss.out also just keeps appending)
        self.gen_offset = 0
        loss_path = os.path.join(workdir, "loss.out")
        if os.path.exists(restart) and os.path.exists(loss_path):
            try:
                rows = np.atleast_2d(np.loadtxt(loss_path))
            except ValueError:  # an unreadable loss.out: number from 0
                rows = np.zeros((0, 0))
            if rows.size:
                self.gen_offset = int(rows[-1][0])
        if os.path.exists(restart):
            arr = np.loadtxt(restart)
            mu, sigma = arr[:, 0], arr[:, 1]
        elif cfg.fine_tune:
            mu, sigma, q_scaler = fine_tune_init(model, cfg)
        else:
            mu = (rng.random(d) - 0.5) * 2.0 * cfg.initial_para
            sigma = np.full(d, cfg.sigma0)
        if q_scaler is None and cfg.import_q_scaler:
            q_scaler = read_q_scaler_from_nep_txt(
                os.path.join(workdir, "nep.txt"), model.dim, d)
        self.state = SNESState(
            mu=torch.as_tensor(mu, dtype=dtype, device=device),
            sigma=torch.as_tensor(sigma, dtype=dtype, device=device),
            generator=_generator(cfg.seed, self.gen_offset, device),
            generation=self.gen_offset)
        # q_scaler from a CONSTANT initial_para parameter vector over the
        # full training set (ref: fitness.cu:162-171 evaluates a
        # dummy_solution filled with para.initial_para at generation 0 with
        # calculate_q_scaler=true), NOT from the random mu, whose c-value
        # cancellations give a different descriptor range and mis-condition
        # the ANN inputs.
        self.q_scaler = (
            torch.as_tensor(np.asarray(q_scaler), dtype=dtype, device=device)
            if q_scaler is not None else compute_q_scaler(
                model, np.full((d,), cfg.initial_para,
                               np.float64 if dtype == torch.float64
                               else np.float32), batches))
        self._sample, self._eval, self._update = make_population_pieces(
            model, cfg, self.q_scaler, self.lambda_1, self.lambda_2)
        if nd > 1:
            self._eval = sharded_evaluate(self._eval, self.devices)
        self.best_theta = self.state.mu.detach().cpu().numpy()
        self._b1_idx = global_bias_index(model)
        # wall seconds and generations of the train() loops run so far
        self.train_seconds = 0.0
        self.generations_run = 0

    @torch.no_grad()
    def _theta_rmses(self, theta, batch, do_shift):
        """Unweighted global RMSEs of one parameter vector, with the shift
        (reporting, ref: fitness.cu:443-470: the train row is
        shift-corrected, the test row evaluates the bias-corrected elite
        with no further shift)."""
        params = params_from_vector(self.model, theta, self.q_scaler)
        out = batched_forward(self.model, params, batch)
        e, f, v, _, _, shift = per_type_rmses(
            self.model, self.cfg, out, batch, use_weight=False,
            do_shift=do_shift, return_shift=True)
        return e[-1], f[-1], v[-1], shift

    def _write_loss_row(self, row):
        """Append one loss.out row in the reference's exact column layout
        (fitness.cu:497-578): NEP models print 10 columns
        %-8d %-11.5f x3 %-13.5f x6 with test columns always present (zeros
        when no test set); qNEP prints 14 columns at %-9.5f; tensorial
        (dipole/polarizability) prints gen, total, L1, L2, v_train, v_test."""
        gen = int(row[0])
        vals = [float(x) for x in row[1:]]
        if self.model.charge_mode:
            # row: total,l1,l2,e,f,v,q,b [,te,tf,tv]; test q/b not evaluated
            # without a test set -> zeros like the reference
            test = vals[8:11] + [0.0] * (3 - len(vals[8:11]))
            cols = vals[:8] + test + [0.0, 0.0]
            line = f"{gen:<8d}" + "".join(f"{v:<9.5f}" for v in cols)
        elif self.model.model_type in (1, 2):
            # tensorial: the dipole/polarizability RMSE rides the v slot
            v_tr = vals[5]
            v_te = vals[8] if len(vals) > 8 else 0.0
            line = (f"{gen:<8d}" + "".join(f"{v:<11.5f}" for v in vals[:3])
                    + f"{v_tr:<13.5f}{v_te:<13.5f}")
        else:
            train3 = vals[3:6]
            test3 = vals[6:9] + [0.0] * (3 - len(vals[6:9]))
            line = (f"{gen:<8d}" + "".join(f"{v:<11.5f}" for v in vals[:3])
                    + "".join(f"{v:<13.5f}" for v in train3 + test3))
        with open(os.path.join(self.workdir, "loss.out"), "a") as f:
            f.write(line + "\n")

    def _report_elite(self, best_theta, batch):
        """Reference report_error semantics (fitness.cu:430-470): re-evaluate
        the elite unweighted + shift-corrected on the train batch, absorb
        the shift into the global output bias (so written nep.txt predicts
        unbiased energies), then test RMSEs with the corrected elite."""
        theta = torch.as_tensor(best_theta, device=self.state.mu.device)
        e, f, v, shift = self._theta_rmses(theta, batch, True)
        if self.model.model_type in (0, 3):
            theta = theta.clone()
            theta[self._b1_idx] += shift
        self.best_theta = theta.cpu().numpy()
        row = [float(e), float(f), float(v)]
        if self.test_batches:
            te, tf_, tv, _ = self._theta_rmses(theta, self.test_batches[0],
                                               False)
            row += [float(te), float(tf_), float(tv)]
        return row

    def train_fused(self, generations: Optional[int] = None, log=print):
        """Single-batch training in whole report intervals, as the JAX
        package's fused loop runs them (one lax.scan of `output_interval`
        generations a dispatch): each interval ends in a loss.out row, so
        a `generation` that is not a multiple of the interval trains past
        it to the next multiple (25 at interval 10: rows 10, 20 and 30).
        Several batches or use_full_batch take `train`.  A charge model's
        rows are train()'s 14 columns with the elite as it is (the JAX
        package's fused loop writes the plain model's row there, without
        the charge and BEC columns, and moves the charge model's bias)."""
        gens = (generations or self.cfg.maximum_generation) - self.gen_offset
        if len(self.batches) == 1 and not self.cfg.use_full_batch and gens > 0:
            report = max(1, min(self.cfg.output_interval, gens))
            generations = self.gen_offset + -(-gens // report) * report
        return self.train(generations, log=log)

    def save_restart(self):
        arr = np.stack([self.state.mu.cpu().numpy(),
                        self.state.sigma.cpu().numpy()], axis=1)
        np.savetxt(os.path.join(self.workdir, "nep.restart"), arr,
                   fmt="%15.7e")

    def save_potential(self, filename="nep.txt"):
        write_nep_txt(os.path.join(self.workdir, filename), self.model,
                      self.best_theta, self.q_scaler)

    def train(self, generations: Optional[int] = None, log=print):
        gens = (generations or self.cfg.maximum_generation) - self.gen_offset
        if gens <= 0:
            log(f"nothing to do: loss.out already at generation "
                f"{self.gen_offset}")
            return self.state
        t0 = time.time()
        for g in range(gens):
            gi = g % len(self.batches)
            z, thetas = self._sample(self.state)
            rmses = self._eval(thetas, self.batches[gi])
            if self.cfg.use_full_batch and len(self.batches) > 1:
                # quadratic mean of per-batch RMSEs (ref: fitness.cu:202-256)
                sums = [r ** 2 for r in rmses]
                for j, b in enumerate(self.batches):
                    if j == gi:
                        continue
                    extra = self._eval(thetas, b)
                    sums = [s + r ** 2 for s, r in zip(sums, extra)]
                nb = len(self.batches)
                rmses = tuple(torch.sqrt(s / nb) for s in sums)
            self.state, metrics = self._update(self.state, z, thetas, *rmses)
            if (g + 1) % self.cfg.output_interval == 0 or g == gens - 1:
                row = [self.gen_offset + g + 1, float(metrics["fitness"]),
                       float(metrics["l1"]), float(metrics["l2"])]
                if self.model.charge_mode:
                    # charge mode keeps the population metrics + charge/BEC
                    # columns (ref: fitness.cu:530-536); no bias absorption
                    self.best_theta = metrics["best_theta"].cpu().numpy()
                    row += [float(metrics[k]) for k in (
                        "rmse_e", "rmse_f", "rmse_v", "rmse_q", "rmse_b")]
                    if self.test_batches:
                        te, tf_, tv, _ = self._theta_rmses(
                            metrics["best_theta"], self.test_batches[0],
                            False)
                        row += [float(te), float(tf_), float(tv)]
                else:
                    row += self._report_elite(metrics["best_theta"],
                                              self.batches[gi])
                self._write_loss_row(row)
                log(f"gen {g + 1}: fitness {row[1]:.5f} rmse_e {row[4]:.5f} "
                    f"rmse_f {row[5]:.5f} rmse_v {row[6]:.5f} "
                    f"({time.time() - t0:.0f}s)")
            if (g + 1) % 100 == 0:
                self.save_restart()
            if (g + 1) % self.cfg.save_potential == 0:
                self.save_potential()
        self.save_restart()
        self.save_potential()
        self.train_seconds += time.time() - t0
        self.generations_run += gens
        return self.state
