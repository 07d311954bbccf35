"""The `nep` application: NEP training/prediction from nep.in + train.xyz.

    python -m gpumd_tpu_torch.app.nep [workdir] [--device cpu]

Counterpart of gpumd_tpu/app/nep.py.  Reads nep.in (architecture +
hyperparameters), train.xyz (+ optional test.xyz), batches structures with
static neighbour tensors, runs the SNES trainer (the whole population
mapped over the card in chunks), and writes loss.out, nep.txt and
nep.restart, reference-compatible (ref: src/main_nep/main.cu).
Prediction mode (`prediction 1`) evaluates an existing nep.txt over the
training set and writes energy_train.out / force_train.out /
virial_train.out scatter files.  It runs on the card unless the caller
asks for the CPU, and stops when it finds no card.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

import torch

from gpumd_tpu_torch.bench import prepare_device
from gpumd_tpu_torch.io.nep_input import model_from_config, parse_nep_in
from gpumd_tpu_torch.io.xyz import read_xyz_frames
from gpumd_tpu_torch.potentials.nep.model import NEP
from gpumd_tpu_torch.train.dataset import StructureBatch, batch_structures
from gpumd_tpu_torch.train.nep_train import _pair_types, batched_forward
from gpumd_tpu_torch.train.snes import SNESTrainer


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default=".")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def build_batches(frames, symbols, rc, batch_size, mn=200, log=print,
                  model_type=0, charge_mode=0,
                  device=torch.device("cuda")) -> List[StructureBatch]:
    """Split frames into batches of <= batch_size configs (ref: fitness.cu
    45-84: consecutive split), padding each batch to its own max_atoms."""
    batches = [batch_structures(frames[i:i + batch_size], symbols, rc=rc,
                                mn=mn, model_type=model_type,
                                charge_mode=charge_mode, device=device)
               for i in range(0, len(frames), batch_size)]
    log(f"{len(frames)} configurations -> {len(batches)} batch(es)")
    return batches


@torch.no_grad()
def _write_descriptors(cfg, nep, batches, workdir):
    """descriptor.out in prediction mode: output_descriptor 1 writes the
    per-structure mean scaled descriptor, 2 the per-atom rows
    (ref: main_nep/nep.cu:711-740)."""
    path = os.path.join(workdir, "descriptor.out")
    with open(path, "a") as f:
        for batch in batches:
            c, a, mn, _ = batch.r12.shape
            q, _ = nep.raw_descriptors(batch.r12.reshape(c * a, mn, 3),
                                       batch.type.reshape(c * a),
                                       _pair_types(batch).reshape(c * a, mn))
            qs = (q * nep.params.q_scaler.to(q.dtype)).reshape(c, a, -1)
            qs = qs.cpu().numpy()
            mask = batch.mask.cpu().numpy() > 0
            for ci in range(batch.num_configs):
                qc = qs[ci][mask[ci]]
                if cfg.output_descriptor == 2:
                    for row in qc:
                        f.write(" ".join(f"{x:g}" for x in row) + "\n")
                else:
                    f.write(" ".join(f"{x:g}" for x in qc.mean(axis=0))
                            + "\n")


def run_prediction(cfg, model, batches, workdir, log=print, tag="train"):
    device = batches[0].r12.device
    nep = NEP.from_file(os.path.join(workdir, "nep.txt"),
                        dtype=batches[0].r12.dtype, device=device)
    model = nep.model
    if cfg.output_descriptor and tag == "train":
        _write_descriptors(cfg, nep, batches, workdir)
        log("descriptor.out written")
    e_path = os.path.join(workdir, f"energy_{tag}.out")
    f_path = os.path.join(workdir, f"force_{tag}.out")
    v_path = os.path.join(workdir, f"virial_{tag}.out")
    with open(e_path, "w") as fe, open(f_path, "w") as ff, \
            open(v_path, "w") as fv:
        for batch in batches:
            with torch.no_grad():
                out = batched_forward(model, nep.params, batch)
            host = {k: getattr(out, k).cpu().numpy()
                    for k in ("energy", "force", "virial")}
            na = batch.n_atoms.cpu().numpy()
            e_pred = host["energy"] / na
            e_ref = batch.energy_ref.cpu().numpy() / na
            for p, r in zip(e_pred, e_ref):
                fe.write(f"{p:15.7e}{r:15.7e}\n")
            fref = batch.force_ref.cpu().numpy()
            for c in range(len(na)):
                for a in range(int(na[c])):
                    row = list(host["force"][c, a]) + list(fref[c, a])
                    ff.write("".join(f"{x:15.7e}" for x in row) + "\n")
            vpred = host["virial"] / na[:, None]
            vref = batch.virial_ref.cpu().numpy() / na[:, None]
            hv = batch.has_virial.cpu().numpy() > 0
            for c in range(len(na)):
                if hv[c]:
                    row = list(vpred[c]) + list(vref[c])
                    fv.write("".join(f"{x:15.7e}" for x in row) + "\n")
    log(f"prediction written: energy/force/virial_{tag}.out")


def main(argv=None, device="cuda"):
    """Train (or predict) in argv's work directory on `device`; the
    command line's --device overrides it."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    device = torch.device(args.device or device)
    # the card unless the CPU was asked for; full-f32 matmuls there, as
    # the reference trains in f32
    prepare_device(device)
    workdir = args.workdir
    cfg = parse_nep_in(os.path.join(workdir, "nep.in"))
    model = model_from_config(cfg)

    def batches_of(name):
        return build_batches(
            read_xyz_frames(os.path.join(workdir, name)), cfg.symbols,
            rc=model.rc_radial_max, batch_size=cfg.batch_size,
            model_type=cfg.model_type, charge_mode=cfg.charge_mode,
            device=device)

    batches = batches_of("train.xyz")
    has_test = os.path.exists(os.path.join(workdir, "test.xyz"))
    if cfg.prediction:
        run_prediction(cfg, model, batches, workdir)
        if has_test:
            run_prediction(cfg, model, batches_of("test.xyz"), workdir,
                           tag="test")
        return None
    trainer = SNESTrainer(model, cfg, batches, workdir=workdir,
                          test_batches=batches_of("test.xyz") if has_test
                          else [])
    trainer.train_fused()
    return trainer


if __name__ == "__main__":
    main()
