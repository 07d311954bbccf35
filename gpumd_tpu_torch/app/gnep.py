"""The `gnep` application: gradient-descent NEP training.

    python -m gpumd_tpu_torch.app.gnep [workdir] [--device cpu]

Counterpart of gpumd_tpu/app/gnep.py, the analog of the reference gnep
trainer (ref: src/main_gnep/): Adam with decoupled weight decay and
adaptive global-norm gradient clipping (adam.cu:132-161, 236-285), a
warmup + cosine LR schedule with an optional cosine-restart variant
(fitness.cu:317-371, keyword lr_cos_restart), an epoch x shuffled-batch
loop with Nc-weighted epoch-mean RMSEs (fitness.cu:212-280), the
reference's 10-column loss.out rows (fitness.cu:502-527), per-epoch
nep.txt + gnep.restart checkpoints, and test-set evaluation when test.xyz
is present (report_error, fitness.cu:461-540).  The loss is
differentiated straight through the batched forward (second-order
autograd for force errors).

Resume: gnep.restart carries the parameter vector in the reference's
format; a sidecar gnep_adam.npz (the JAX package's layout) carries the
Adam moments, step counter, gradient-norm EMA, exact parameters and
epoch, so a resumed run continues bit-identically (the reference
restores parameters only, adam.cu:225-245).  It runs on the card unless
the caller asks for the CPU, and stops when it finds no card.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from gpumd_tpu_torch.app.nep import build_batches, parse_args
from gpumd_tpu_torch.bench import prepare_device
from gpumd_tpu_torch.io.nep_input import model_from_config, parse_nep_in
from gpumd_tpu_torch.io.xyz import read_xyz_frames
from gpumd_tpu_torch.potentials.nep.params import (
    num_trainable,
    params_from_vector,
    write_nep_txt,
)
from gpumd_tpu_torch.train.nep_train import (
    GnepState,
    LossWeights,
    gnep_lr,
    loss_terms,
    make_gnep_step,
    param_leaves,
    with_leaves,
)
from gpumd_tpu_torch.train.snes import compute_q_scaler


def main(argv=None, stop_after=None, device="cuda"):
    """stop_after: optional epoch count to stop at (testing hook for the
    resume path; a killed run resumes the same way).  The command line's
    --device overrides `device`."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    device = torch.device(args.device or device)
    prepare_device(device)
    workdir = args.workdir
    cfg = parse_nep_in(os.path.join(workdir, "nep.in"))
    if cfg.charge_mode:
        # the JAX package's gnep builds its batches without the charge
        # labels and fails in its first epoch; the port adds no trainer
        # the JAX package lacks
        raise ValueError(f"gnep does not train qNEP models (charge_mode "
                         f"{cfg.charge_mode}): train them with nep")
    model = model_from_config(cfg)

    def batches_of(name):
        return build_batches(
            read_xyz_frames(os.path.join(workdir, name)), cfg.symbols,
            rc=model.rc_radial_max, batch_size=cfg.batch_size,
            model_type=cfg.model_type, device=device)

    batches = batches_of("train.xyz")
    test_batches = []
    if os.path.exists(os.path.join(workdir, "test.xyz")):
        test_batches = batches_of("test.xyz")

    d = num_trainable(model)
    rng = np.random.default_rng(cfg.seed)
    theta0 = (rng.random(d) - 0.5) * 0.2
    q_scaler = compute_q_scaler(model, theta0.astype(np.float32), batches)

    restart_path = os.path.join(workdir, "gnep.restart")
    adam_path = os.path.join(workdir, "gnep_adam.npz")
    epoch0 = 0
    if os.path.exists(restart_path):
        theta0 = np.loadtxt(restart_path).reshape(-1)
        if theta0.shape[0] != d:
            raise ValueError(
                f"gnep.restart has {theta0.shape[0]} parameters, "
                f"model needs {d}")
        print(f"resuming parameters from {restart_path}")
    params = params_from_vector(
        model, torch.as_tensor(theta0, dtype=torch.float32, device=device),
        q_scaler)
    zeros = with_leaves(params, [torch.zeros_like(x)
                                 for x in param_leaves(params)])
    state = GnepState(
        params=params, m=zeros, v=zeros,
        step=torch.zeros((), dtype=torch.int32, device=device),
        avg_norm=torch.tensor(-1.0, dtype=torch.float32, device=device))
    if os.path.exists(adam_path):
        z = np.load(adam_path)
        n = len(param_leaves(params))

        def load(prefix):
            return with_leaves(params, [torch.as_tensor(
                z[f"{prefix}{i}"], device=device) for i in range(n)])

        # exact f32 params from the sidecar (gnep.restart's %15.7e text is
        # the reference artifact but loses the last mantissa bit)
        state = GnepState(
            params=load("p") if "p0" in z else params, m=load("m"),
            v=load("v"),
            step=torch.tensor(int(z["step"]), dtype=torch.int32,
                              device=device),
            avg_norm=torch.tensor(float(z["avg_norm"]), dtype=torch.float32,
                                  device=device))
        epoch0 = int(z["epoch"])
        print(f"resuming Adam moments from {adam_path} (epoch {epoch0})")

    num_batches = len(batches)
    maximum_steps = cfg.epoch * num_batches
    weights = LossWeights(energy=cfg.lambda_e, force=cfg.lambda_f,
                          virial=cfg.lambda_v)
    step_fn = make_gnep_step(model, weights, cfg.weight_decay)
    # per-batch config / virial-config counts for Nc-weighted epoch means
    # (ref: fitness.cu:244-256)
    nc = [int((b.weight > 0).sum()) for b in batches]
    nc_v = [int((b.has_virial > 0).sum()) for b in batches]

    loss_path = os.path.join(workdir, "loss.out")
    # all epoch permutations drawn up front so a resumed run replays the
    # same batch order for the remaining epochs
    order_rng = np.random.default_rng(cfg.seed + 1)
    orders = [order_rng.permutation(num_batches) for _ in range(cfg.epoch)]
    t0 = time.time()
    for epoch in range(epoch0, cfg.epoch):
        # the reference shuffles batch order each epoch
        # (fitness.cu:217-220, random_device there; seeded here so resumed
        # runs are reproducible)
        sums = []
        for k, bi in enumerate(orders[epoch]):
            step = epoch * num_batches + k
            lr = float(np.float32(gnep_lr(step, num_batches, maximum_steps,
                                          cfg)))
            state, metrics = step_fn(state, batches[bi], lr)
            sums.append((bi, metrics["mse_e"], metrics["mse_f"],
                         metrics["mse_v"]))
        # the epoch's values read back once
        mse_e = mse_f = mse_v = 0.0
        for bi, me, mf, mv in sums:
            mse_e += float(me) * nc[bi]
            mse_f += float(mf) * nc[bi]
            mse_v += float(mv) * nc_v[bi]
        count = sum(nc[bi] for bi, *_ in sums)
        count_v = sum(nc_v[bi] for bi, *_ in sums)
        rmse_e = float(np.sqrt(mse_e / max(count, 1)))
        rmse_f = float(np.sqrt(mse_f / max(count, 1)))
        rmse_v = float(np.sqrt(mse_v / count_v)) if count_v else 0.0
        total = (cfg.lambda_e * rmse_e + cfg.lambda_f * rmse_f
                 + cfg.lambda_v * rmse_v)
        te = tf = tv = 0.0
        if test_batches:
            acc = np.zeros(3)
            w = np.zeros(3)
            for b in test_batches:
                with torch.no_grad():
                    me, mf, mv = (float(x) for x in
                                  loss_terms(model, state.params, b))
                ncb = int((b.weight > 0).sum())
                ncv = int((b.has_virial > 0).sum())
                acc += [me * ncb, mf * ncb, mv * ncv]
                w += [ncb, ncb, max(ncv, 0)]
            te = float(np.sqrt(acc[0] / max(w[0], 1)))
            tf = float(np.sqrt(acc[1] / max(w[1], 1)))
            tv = float(np.sqrt(acc[2] / w[2])) if w[2] else 0.0
        elapsed = time.time() - t0
        lr_now = gnep_lr(min((epoch + 1) * num_batches, maximum_steps - 1),
                         num_batches, maximum_steps, cfg)
        # the reference's exact 10-column row (fitness.cu:513-527)
        with open(loss_path, "a") as f:
            f.write(f"{epoch + 1:<8d}"
                    + "".join(f"{x:<13.5f}" for x in
                              (total, rmse_e, rmse_f, rmse_v, te, tf, tv))
                    + f"{lr_now:<15.7f}{elapsed:<13.5f}\n")
        print(f"epoch {epoch + 1}/{cfg.epoch} loss {total:.5f} "
              f"rmse_e {rmse_e:.5f} rmse_f {rmse_f:.5f} "
              f"rmse_v {rmse_v:.5f} lr {lr_now:.2e}")
        _checkpoint(workdir, model, state, q_scaler, epoch + 1,
                    restart_path, adam_path)
        t0 = time.time()
        if stop_after is not None and epoch + 1 >= stop_after:
            print(f"stopping after epoch {epoch + 1} (resume with the "
                  f"same command)")
            return state
    print("wrote nep.txt")
    return state


def _host(x):
    return x.detach().cpu().numpy()


def _checkpoint(workdir, model, state: GnepState, q_scaler, epoch,
                restart_path, adam_path):
    """Per-epoch outputs like the reference report_error: nep.txt +
    gnep.restart (parameters, %15.7e one per line, adam.cu:290-296) +
    the Adam-moment sidecar for exact resume."""
    theta = params_to_vector(model, state.params)
    write_nep_txt(os.path.join(workdir, "nep.txt"), model, theta, q_scaler)
    with open(restart_path, "w") as f:
        for x in theta:
            f.write(f"{x:15.7e}\n")
    np.savez(
        adam_path, step=int(state.step), avg_norm=float(state.avg_norm),
        epoch=epoch,
        **{f"m{i}": _host(x) for i, x in enumerate(param_leaves(state.m))},
        **{f"v{i}": _host(x) for i, x in enumerate(param_leaves(state.v))},
        **{f"p{i}": _host(x)
           for i, x in enumerate(param_leaves(state.params))})


def params_to_vector(model, params) -> np.ndarray:
    """Inverse of params_from_vector (reference flat layout)."""
    t = model.num_types
    chunks = []
    for ty in range(t):
        chunks.append(_host(params.w0[ty]).reshape(-1))
        chunks.append(_host(params.b0[ty]).reshape(-1))
        chunks.append(_host(params.w1[ty]).reshape(-1))
        if model.version == 5:
            chunks.append(_host(params.b1_type[ty]).reshape(1))
    chunks.append(_host(params.b1).reshape(1))
    nr = (model.n_max_radial + 1) * (model.basis_size_radial + 1)
    na = (model.n_max_angular + 1) * (model.basis_size_angular + 1)
    c_rad = _host(params.c_radial).reshape(t, t, nr).transpose(2, 0, 1)
    c_ang = _host(params.c_angular).reshape(t, t, na).transpose(2, 0, 1)
    chunks.append(c_rad.reshape(-1))
    chunks.append(c_ang.reshape(-1))
    return np.concatenate(chunks)


if __name__ == "__main__":
    main()
