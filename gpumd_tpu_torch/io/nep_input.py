"""nep.in parser (ref: src/main_nep/parameters.cu:60-141, 654-718;
keyword catalog in SURVEY.md A.2).

Counterpart of gpumd_tpu/io/nep_input.py: the same fields, defaults and
keywords; `model_from_config` returns the port's NepModel."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from gpumd_tpu_torch.elements import atomic_number
from gpumd_tpu_torch.potentials.nep.params import NepModel


@dataclass
class NepTrainConfig:
    # model
    model_type: int = 0  # 0 potential, 1 dipole, 2 polarizability, 3 temp
    version: int = 4
    num_types: int = 0
    symbols: Tuple[str, ...] = ()
    rc_radial: float = 8.0
    rc_angular: float = 4.0
    n_max_radial: int = 6
    n_max_angular: int = 6
    basis_size_radial: int = 6
    basis_size_angular: int = 6
    l_max: int = 4
    l_max_4body: int = 2
    l_max_5body: int = 0
    neurons: int = 30
    zbl: Optional[float] = None  # outer cutoff; inner = outer/2
    # per-pair ZBL outer cutoff factor (ref: parameters.cu
    # parse_use_typewise_cutoff_zbl; default factor 0.65 when enabled)
    typewise_cutoff_zbl_factor: float = 0.0
    charge_mode: int = 0
    atomic_v: int = 0  # fit per-atom dipole/polarizability
    output_descriptor: int = 0  # 1 per-structure, 2 per-atom (prediction)
    # loss
    lambda_1: float = -1.0  # auto
    lambda_2: float = -1.0  # auto
    lambda_e: float = 1.0
    lambda_f: float = 1.0
    lambda_v: float = 0.1
    lambda_shear: float = 1.0
    lambda_q: float = 0.1  # total-charge loss (ref: parameters.cu:100)
    lambda_z: float = 0.5  # BEC loss (ref: parameters.cu:101)
    force_delta: float = 0.0
    # training
    batch_size: int = 1000
    use_full_batch: bool = False
    population_size: int = 50
    maximum_generation: int = 100000
    initial_para: float = 1.0
    sigma0: float = 0.1
    prediction: bool = False
    save_potential: int = 100000
    output_interval: int = 100
    type_weight: Tuple[float, ...] = ()
    seed: int = 12345678
    # foundation-model fine-tuning (ref: parameters.cu:1424-1444)
    fine_tune_nep_txt: str = ""
    fine_tune_nep_restart: str = ""
    fine_tune_descriptor: bool = False
    import_q_scaler: bool = False
    # gnep (gradient trainer) keywords (ref: main_gnep/parameters.cu)
    epoch: int = 100
    start_lr: float = 1e-3
    stop_lr: float = 1e-7
    weight_decay: float = 0.0
    # cosine-restart LR schedule (ref: parameters.cu:913-940, keyword
    # `lr_cos_restart enable [warmup_epochs initial_period_epochs
    # period_factor decay_factor]`)
    lr_restart_enable: bool = False
    lr_warmup_epochs: int = 1
    lr_restart_initial_period_epochs: int = 10
    lr_restart_period_factor: float = 2.0
    lr_restart_decay_factor: float = 0.8

    @property
    def fine_tune(self) -> bool:
        return bool(self.fine_tune_nep_restart)


def parse_nep_in(path: str) -> NepTrainConfig:
    cfg = NepTrainConfig()
    with open(path) as f:
        for raw in f:
            body = raw.split("#", 1)[0].strip()
            if not body:
                continue
            toks = body.split()
            kw, args = toks[0], toks[1:]
            if kw in ("mode", "model_type"):
                cfg.model_type = int(args[0])
            elif kw == "version":
                cfg.version = int(args[0])
                if cfg.version not in (4, 5):
                    raise ValueError("version must be 4 or 5")
            elif kw == "type":
                cfg.num_types = int(args[0])
                cfg.symbols = tuple(args[1 : 1 + cfg.num_types])
                if len(cfg.symbols) != cfg.num_types:
                    raise ValueError("type: wrong number of symbols")
            elif kw == "cutoff":
                cfg.rc_radial = float(args[0])
                cfg.rc_angular = float(args[1])
            elif kw == "n_max":
                cfg.n_max_radial, cfg.n_max_angular = int(args[0]), int(args[1])
            elif kw == "basis_size":
                cfg.basis_size_radial = int(args[0])
                cfg.basis_size_angular = int(args[1])
            elif kw == "l_max":
                cfg.l_max = int(args[0])
                if len(args) > 1:
                    cfg.l_max_4body = int(args[1])
                if len(args) > 2:
                    cfg.l_max_5body = int(args[2])
            elif kw == "neuron":
                cfg.neurons = int(args[0])
            elif kw == "zbl":
                cfg.zbl = float(args[0])
            elif kw == "use_typewise_cutoff_zbl":
                cfg.typewise_cutoff_zbl_factor = (
                    float(args[0]) if args else 0.65
                )
            elif kw == "atomic_v":
                cfg.atomic_v = int(args[0])
            elif kw == "output_descriptor":
                cfg.output_descriptor = int(args[0])
            elif kw == "charge_mode":
                cfg.charge_mode = int(args[0])
            elif kw == "lambda_1":
                cfg.lambda_1 = float(args[0])
            elif kw == "lambda_2":
                cfg.lambda_2 = float(args[0])
            elif kw == "lambda_e":
                cfg.lambda_e = float(args[0])
            elif kw == "lambda_f":
                cfg.lambda_f = float(args[0])
            elif kw == "lambda_v":
                cfg.lambda_v = float(args[0])
            elif kw == "lambda_shear":
                cfg.lambda_shear = float(args[0])
            elif kw == "lambda_q":
                cfg.lambda_q = float(args[0])
            elif kw == "lambda_z":
                cfg.lambda_z = float(args[0])
            elif kw == "force_delta":
                cfg.force_delta = float(args[0])
            elif kw == "batch":
                cfg.batch_size = int(args[0])
                if len(args) > 1 and args[1] == "1":
                    cfg.use_full_batch = True
            elif kw == "population":
                cfg.population_size = int(args[0])
            elif kw == "generation":
                cfg.maximum_generation = int(args[0])
            elif kw == "initial_para":
                cfg.initial_para = float(args[0])
            elif kw == "sigma0":
                cfg.sigma0 = float(args[0])
            elif kw == "prediction":
                cfg.prediction = bool(int(args[0]))
            elif kw == "save_potential":
                cfg.save_potential = int(args[0])
            elif kw == "output_interval":
                cfg.output_interval = int(args[0])
            elif kw == "type_weight":
                cfg.type_weight = tuple(float(x) for x in args)
            elif kw == "seed":
                cfg.seed = int(args[0])
            elif kw == "fine_tune":
                cfg.fine_tune_nep_txt = args[0]
                cfg.fine_tune_nep_restart = args[1]
                if len(args) > 2:
                    cfg.fine_tune_descriptor = bool(int(args[2]))
            elif kw == "import_q_scaler":
                cfg.import_q_scaler = True
            elif kw == "epoch":
                cfg.epoch = int(args[0])
            elif kw == "start_lr":
                cfg.start_lr = float(args[0])
            elif kw == "stop_lr":
                cfg.stop_lr = float(args[0])
            elif kw == "weight_decay":
                cfg.weight_decay = float(args[0])
            elif kw == "lr_cos_restart":
                if len(args) not in (1, 5):
                    raise ValueError(
                        "lr_cos_restart takes 1 or 5 parameters")
                cfg.lr_restart_enable = bool(int(args[0]))
                if len(args) == 5:
                    cfg.lr_warmup_epochs = int(args[1])
                    cfg.lr_restart_initial_period_epochs = int(args[2])
                    cfg.lr_restart_period_factor = float(args[3])
                    cfg.lr_restart_decay_factor = float(args[4])
            else:
                raise ValueError(f"unknown nep.in keyword {kw!r}")
    if cfg.num_types == 0:
        raise ValueError("nep.in must contain a `type` line")
    return cfg


def model_from_config(cfg: NepTrainConfig):
    """NepTrainConfig -> static NepModel (trainer-side architecture)."""
    has_q = (1 if cfg.l_max_4body else 0, 1 if cfg.l_max_5body else 0,
             0, 0, 0, 0)
    return NepModel(
        version=cfg.version,
        model_type=cfg.model_type,
        num_types=cfg.num_types,
        symbols=cfg.symbols,
        atomic_numbers=tuple(atomic_number(s) for s in cfg.symbols),
        rc_radial=(cfg.rc_radial,) * cfg.num_types,
        rc_angular=(cfg.rc_angular,) * cfg.num_types,
        mn_radial=100,
        mn_angular=100,
        n_max_radial=cfg.n_max_radial,
        n_max_angular=cfg.n_max_angular,
        basis_size_radial=cfg.basis_size_radial,
        basis_size_angular=cfg.basis_size_angular,
        l_max=cfg.l_max,
        has_q=has_q,
        neurons=cfg.neurons,
        zbl=cfg.zbl is not None,
        zbl_rc_inner=(cfg.zbl / 2 if cfg.zbl else 0.0),
        zbl_rc_outer=(cfg.zbl or 0.0),
        zbl_typewise_factor=cfg.typewise_cutoff_zbl_factor,
        charge_mode=cfg.charge_mode,
    )
