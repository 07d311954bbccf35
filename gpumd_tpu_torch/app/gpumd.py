"""The `gpumd` application: execute run.in against model.xyz.

    python -m gpumd_tpu_torch.app.gpumd [workdir] [--device cpu]

Counterpart of gpumd_tpu/app/gpumd.py.  Keyword-stream execution as in the
reference (ref: src/main_gpumd/run.cu:343-575): state keywords apply at
once, property keywords register observers, `run N` performs a run block.
The handlers keep the JAX module's names (`kw_<keyword>`).

`engine auto` (the default) sends a run that the compact engine takes
(one driving NEP or Tersoff-1989 potential, where several `potential`
lines in dump_observer's observe mode drive with the first, an ensemble
of DENSE_ENSEMBLES, no fix/move group, no deform, no add_force-type
term, no HNEMDEC, no per-step stress or Onsager observer, no deposition
and no plumed, a box of >= 3 cells of rc + skin an axis) to
DenseNEPMD or CompactTersoffMD, whose steps launch the hand-written CUDA
kernels on the card; anything else runs the general (list) path,
ForceField + integrate/run.py, and the log says why
(`dense_route_reason`).  On the CPU `engine auto` always takes the list
path; `engine dense` forces the compact engine (its kernels' plain
versions on the CPU) and refuses what it cannot carry, an ensemble
outside DENSE_ENSEMBLES included (their group masks are in input order,
which the engine's slot order would apply to the wrong atoms); `engine
list` takes the list path.  The list path's ensembles (heat baths,
MTTK, QTB, MSST, walls, TTM, TI) write their own outputs at chunk ends
(the TI .csv rows) and at a run's end (the TI .yaml summary,
ttm_electron_temperature.out); `compute` reads the heat baths' energies
from the ensemble's aux.  `ensemble pimd|rpmd|trpmd` runs
integrate/pimd.py's runner whatever the engine (the beads a leading
axis, each bead's force pass on the list path), with `dump_beads`.

The run loop goes in chunks whose length is the gcd of the observers'
intervals, at most MAX_CHUNK steps: the host reads the state (overflow,
a finite-energy check, the input-order snapshot) and writes the .out
files once a chunk, never once a step; on the list path that read also
holds the deepest neighbour row of every list the chunk built against
the capacity, and a row past it raises.  The measure keywords sample that
snapshot (measure/properties.py); the list path's per-step observer adds
the heat current, stress_6 and the Onsager fluxes its measures consume.

Every keyword of the JAX app runs; `minimize` (minimize/minimizers.py),
`compute_phonon` (phonon/hessian.py), `compute_lsqt` (measure/lsqt.py)
and `mc` (mc/mcmd.py: a block of trials at every num_steps_md steps'
chunk end, on the list path) run on the session's device through
ForceField, and `python -m gpumd_tpu_torch.app.mdi` serves a deck to an
external driver.  `engine dense N [axis]` with N > 1 runs a NEP deck on
the z-slab sharded engine (engine/sharded.py): N slabs round-robin over
the visible cards (all on the CPU in a CPU session), the placement
logged.  An unknown keyword raises ValueError.
The session runs on the card unless the caller asks for the CPU
(`device="cpu"`), and raises without a card.  Randomness comes from
torch generators seeded from the keyword's seed; the stochastic ensembles
and drivers take an injected `draw` for tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gpumd_tpu_torch.bench import prepare_device
from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
from gpumd_tpu_torch.elements import MASS_TABLE, mass_of
from gpumd_tpu_torch.engine.nep_compact import (
    CompactSpec,
    compact_nep_compute,
    plan_grid_compact,
)
from gpumd_tpu_torch.engine.sharded import (
    ShardedDenseMD,
    round_robin_devices,
)
from gpumd_tpu_torch.engine.tersoff_compact import CompactTersoffMD
from gpumd_tpu_torch.forcefield import ForceField, hnemdec_coefficients
from gpumd_tpu_torch.integrate.drivers import (
    AddEfield,
    AddForce,
    AddRandomForce,
    AddSpring,
    ElectronStop,
    parse_table_or_values,
)
from gpumd_tpu_torch.integrate.ensembles.deform import DeformWrapper
from gpumd_tpu_torch.integrate.ensembles.heat import (
    HeatBDP,
    HeatHybrid,
    HeatLangevin,
    HeatNHC,
)
from gpumd_tpu_torch.integrate.ensembles.msst import MSST
from gpumd_tpu_torch.integrate.ensembles.mttk import MTTK, NPHug
from gpumd_tpu_torch.integrate.ensembles.npt import NPTSCR, NPTBerendsen
from gpumd_tpu_torch.integrate.ensembles.nve import NVE
from gpumd_tpu_torch.integrate.ensembles.nvt import (
    NVTBAOAB,
    NVTBDP,
    NVTBerendsen,
    NVTLangevin,
    NVTNoseHooverChain,
)
from gpumd_tpu_torch.integrate.ensembles.qtb import NPTQTB, NVTQTB
from gpumd_tpu_torch.integrate.ensembles.ti import (
    TI,
    TIAS,
    TIRS,
    TILiquid,
    TISpring,
)
from gpumd_tpu_torch.integrate.ensembles.ttm import TTM
from gpumd_tpu_torch.integrate.ensembles.walls import (
    WallHarmonic,
    WallMirror,
    WallPiston,
)
from gpumd_tpu_torch.integrate.pimd import PIMDRunner
from gpumd_tpu_torch.integrate.run import MDRunner
from gpumd_tpu_torch.integrate.thermo import compute_thermo
from gpumd_tpu_torch.integrate.velocity import (
    correct_velocity,
    initialize_velocity,
)
from gpumd_tpu_torch.io.xyz import XYZFrame, read_xyz, write_xyz
from gpumd_tpu_torch.mc.mcmd import MCMD
from gpumd_tpu_torch.measure.lsqt import LSQT
from gpumd_tpu_torch.measure.netcdf_dump import DumpNetCDF
from gpumd_tpu_torch.measure.plumed_bridge import PlumedBridge
from gpumd_tpu_torch.measure.properties import (
    ADF,
    DOS,
    HAC,
    MSD,
    RDF,
    SDC,
    SHC,
    AngularRDF,
    HNEMDECOnsager,
    HNEMDKappa,
    IonicConductivity,
    ModalAnalysis,
    OrientOrder,
    Viscosity,
    heat_current_5,
    onsager_flux,
    stress_6,
)
from gpumd_tpu_torch.minimize.minimizers import (
    minimize_fire,
    minimize_fire_box,
    minimize_sd,
)
from gpumd_tpu_torch.model.box import Box, inv3
from gpumd_tpu_torch.model.groups import Groups
from gpumd_tpu_torch.model.state import MDState, make_state
from gpumd_tpu_torch.phonon.hessian import compute_phonon_dispersion
from gpumd_tpu_torch.potentials.base import _scatter_rows
from gpumd_tpu_torch.potentials.dftd3 import DFTD3
from gpumd_tpu_torch.potentials.dp import DP
from gpumd_tpu_torch.potentials.eam import (
    ADP,
    EAMAlloy,
    EAMDai2006,
    EAMZhou2004,
)
from gpumd_tpu_torch.potentials.fcp import FCP
from gpumd_tpu_torch.potentials.ilp import (
    ILPHybrid,
    layer_bound,
    load_nep_ilp,
    load_sw_ilp,
    load_tersoff_ilp,
)
from gpumd_tpu_torch.potentials.lj import LJ
from gpumd_tpu_torch.potentials.nep.charge import NEPCharge
from gpumd_tpu_torch.potentials.nep.model import NEP
from gpumd_tpu_torch.potentials.nep.pppm import best_mesh
from gpumd_tpu_torch.potentials.sw import SW
from gpumd_tpu_torch.potentials.tersoff import (
    Tersoff1988,
    Tersoff1989,
    TersoffMini,
)
from gpumd_tpu_torch.units import (
    K_B,
    PRESSURE_UNIT_CONVERSION,
    TIME_UNIT_CONVERSION,
)

# the session's floating-point type: the kernels take float32, and the JAX
# package runs float32 on the TPU
DTYPE = torch.float32

# At most this many steps between two host reads of the state.
MAX_CHUNK = 1000

# ensembles the compact engine integrates: constant-box thermostats and the
# Berendsen/SCR barostats (the rebuild criterion is barostat-safe)
DENSE_ENSEMBLES = (
    "NVE", "NVTBerendsen", "NVTLangevin", "NVTBDP", "NVTBAOAB",
    "NVTNoseHooverChain", "NPTBerendsen", "NPTSCR",
)

# run.in keywords of the JAX app whose modules are not ported yet, and the
# ROADMAP queue 1 item that ports each: none since every keyword runs
UNPORTED: Dict[str, int] = {}

# potential file headers read by a class's from_file(path, dtype, device)
# whose type names are the header's symbols, `potential <T> <syms>`
_HEADER_POTENTIALS = {
    "lj": LJ, "tersoff_1989": Tersoff1989, "tersoff_1988": Tersoff1988,
    "tersoff_mini": TersoffMini, "sw_1985": SW,
    "eam_zhou_2004": EAMZhou2004, "eam_dai_2006": EAMDai2006,
}

# setfl potentials: their type names are the file's symbols
_SETFL_POTENTIALS = {"adp": ADP, "eam/alloy": EAMAlloy}

# many-body potentials without a neighbour-count hint: the list capacity
# is their density bound alone (a (B, MN, MN) angle tensor a block grows
# with MN^2); the ILP hybrids' layers add their own bound (_auto_mn), and
# FCP reads no list
_MANY_BODY = (Tersoff1989, Tersoff1988, TersoffMini, SW, EAMZhou2004,
              EAMAlloy, ADP, EAMDai2006, ILPHybrid, FCP)

# the ILP hybrids' potential headers and their loaders
_ILP_LOADERS = {"tersoff_ilp": load_tersoff_ilp, "sw_ilp": load_sw_ilp,
                "nep_ilp": load_nep_ilp}


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to gpumd_tpu_torch yet (ROADMAP queue 1, "
        f"item {item})")


def _pairs(toks, what: str):
    """(keyword, value) pairs of a `key value ...` token stream."""
    if len(toks) % 2:
        raise ValueError(f"{what}: {toks[-1]!r} has no value")
    return zip(toks[0::2], toks[1::2])


def _np(t) -> np.ndarray:
    """A tensor (on any device) as a float64 numpy array."""
    return t.detach().cpu().numpy().astype(np.float64)


def _baro_tokens(name, toks, extra, axes=("x", "y", "z"), n_press=2):
    """The MTTK family's keyword stream: `iso|aniso|tri` with `n_press`
    pressures, an axis of `axes` with two, `tperiod`/`pperiod` with one,
    and each keyword of `extra` with the number of values it maps to.
    Returns (mode, {axis: (ps, pe)} in the order last given, the last
    (ps, pe) given by a mode or an axis, {"tperiod"/"pperiod": value},
    {keyword of extra: its value tokens})."""
    mode, comps, press, periods, other = None, {}, (0.0, 0.0), {}, {}
    i = 0
    while i < len(toks):
        t = toks[i]
        if t in ("iso", "aniso", "tri"):
            vals = [float(x) for x in toks[i + 1:i + 1 + n_press]]
            mode, press = t, (vals[0], vals[-1])
            i += 1 + n_press
        elif t in axes:
            comps.pop(t, None)
            press = comps[t] = (float(toks[i + 1]), float(toks[i + 2]))
            i += 3
        elif t in ("tperiod", "pperiod"):
            periods[t] = float(toks[i + 1])
            i += 2
        elif t in extra:
            other[t] = toks[i + 1:i + 1 + extra[t]]
            i += 1 + extra[t]
        else:
            raise ValueError(f"unknown {name} token {t!r}")
    return mode, comps, press, periods, other


def _one_axis_config(cls, mode, comps, ps, pe):
    """`cls._baro_config` of a one-axis barostat (npt_qtb, nphug): the
    axis given last at the last pressures given, else `mode`."""
    if comps:
        axis = {next(reversed(comps)): (ps, pe)}
        return cls._baro_config(axis, axis, None)
    return cls._baro_config(ps, pe, mode)


def parse_run_in(path: str) -> List[List[str]]:
    """Tokenize run.in: whitespace tokens, '#' comments (ref: read_file.cu).
    Returns a list of keyword lines."""
    lines = []
    with open(path) as f:
        for raw in f:
            body = raw.split("#", 1)[0].strip()
            if not body:
                continue
            toks = body.split()
            if len(toks) > 32:
                raise ValueError(f"run.in line has > 32 tokens: {body!r}")
            lines.append(toks)
    return lines


@dataclass
class PropertyRequest:
    interval: int
    process: Callable  # (session, state, global_step) -> None
    finalize: Optional[Callable] = None
    # samples per-atom virials (the compact engine must not spread the
    # total over the atoms)
    needs_atom_virial: bool = False
    # replaces session.state (plumed's bias, deposit's new atoms): the list
    # path hands the next chunk that state and rebuilds its lists; the
    # compact engine does not take it
    mutates_state: bool = False


def _bounded_chunk(interval_gcd: int, n_steps: int) -> int:
    """Chunk length: the observer-interval gcd, bounded by MAX_CHUNK.  When
    the gcd exceeds the cap, its largest divisor under the cap, so chunk
    boundaries still land exactly on every observer interval."""
    chunk = max(1, min(interval_gcd, n_steps))
    if chunk <= MAX_CHUNK:
        return chunk
    best = 1
    for d in range(1, int(math.isqrt(chunk)) + 1):
        if chunk % d == 0:
            if d <= MAX_CHUNK:
                best = max(best, d)
            q = chunk // d
            if q <= MAX_CHUNK:
                best = max(best, q)
    return best


def thermo_row(state: MDState) -> List[float]:
    """A thermo.out row: T KE PE, the stress sxx syy szz syz sxz sxy (GPa)
    and the lattice vectors a, b, c (columns of h); one read from the
    device."""
    th = compute_thermo(state)
    vals = torch.cat([torch.stack([th.temperature, th.kinetic_energy,
                                   th.potential_energy]),
                      th.pressure.reshape(-1), state.box.h.reshape(-1)])
    v = vals.to(torch.float64).cpu().numpy()
    p = v[3:12].reshape(3, 3) * PRESSURE_UNIT_CONVERSION
    h = v[12:21].reshape(3, 3)
    return [v[0], v[1], v[2],
            p[0, 0], p[1, 1], p[2, 2], p[1, 2], p[0, 2], p[0, 1],
            h[0, 0], h[1, 0], h[2, 0], h[0, 1], h[1, 1], h[2, 1],
            h[0, 2], h[1, 2], h[2, 2]]


def _dense_blocker(session, ens) -> Optional[str]:
    """What keeps a run off the compact engine whatever the device: it
    integrates only DENSE_ENSEMBLES (the others hold group masks in input
    order, which its slot order would apply to the wrong atoms, or move
    the cell as its plan does not follow), and it does not carry the
    groups, drivers or deformation below into its slot order, nor apply
    the HNEMDEC driving force, nor observe a step's stress or Onsager
    fluxes."""
    if type(ens).__name__ not in DENSE_ENSEMBLES:
        return f"ensemble {type(ens).__name__}"
    if getattr(session, "deform", None) is not None:
        return "deform run"
    if getattr(session, "move_pin", None) is not None:
        return "move groups"
    if session.mobile_mask is not None:
        # the engine's state is permuted into padded slots and nothing
        # permutes `mobile` with it (ROADMAP queue 3, item 10)
        return "fix groups"
    if session.drivers:
        return "add_force/add_efield/add_random_force/electron_stop/" \
               "add_spring drivers"
    if session.ff is not None and session.ff.hnemdec_mode is not None:
        return "compute_hnemdec"
    if getattr(session, "_deposit", None) is not None:
        return "deposition source"
    if getattr(session, "mc", None) is not None:
        return "MCMD run"
    if any(p.mutates_state for p in session.properties):
        return "state-mutating property (plumed)"
    if any(getattr(m, "needs_stress", False) for m in session.measure_props):
        return "per-step stress observer"
    if any(getattr(m, "needs_onsager", False)
           for m in session.measure_props):
        return "onsager flux observer"
    return None


def dense_route_reason(session, ens, device) -> Optional[str]:
    """None when `engine auto` on `device` runs this block on the compact
    engine, else why it takes the list path.  Asks nothing of the card: a
    test on the CPU can ask what the card would do.

    The reference has one hot path, every deck on the production kernels
    (ref: src/force/force.cu:514-565); on the card `engine auto` does the
    same.  On the CPU the kernels' plain versions run slower than the list
    path, so auto takes the list path there."""
    if torch.device(device).type != "cuda":
        return ("CPU device (the kernels' plain versions run slower than "
                "the list path there)")
    driving = session.driving_potentials()
    if len(driving) != 1:
        averaged = (" averaged" if getattr(session.ff, "average", False)
                    else "")
        return (f"{len(driving)} potentials{averaged} (the compact engine "
                f"drives one)")
    pot = driving[0]
    if isinstance(pot, NEP):
        try:
            CompactSpec.from_model(pot.model, pot.params)
        except NotImplementedError as e:
            return f"model not compact-eligible ({e})"
    elif not isinstance(pot, Tersoff1989):
        return f"potential {type(pot).__name__} has no compact engine"
    blocker = _dense_blocker(session, ens)
    if blocker is not None:
        return blocker
    rc = pot.model.rc_radial_max if isinstance(pot, NEP) else pot.rc
    n = session._n
    plan = plan_grid_compact(session.state.box, rc, 1.0, n,
                             position=_np(session.state.position)[:n])
    if plan is None:
        return "box too thin for the cell grid (< 3 cells per axis)"
    return None


class Session:
    """One gpumd run: model.xyz + run.in in a working directory, on
    `device` (the card unless the CPU is asked for), in `dtype` (DTYPE,
    float32, unless asked otherwise: float64 for a CPU reference)."""

    def __init__(self, workdir: str = ".", quiet: bool = False,
                 device="cuda", dtype: Optional[torch.dtype] = None):
        self.device = torch.device(device)
        self.dtype = dtype or DTYPE
        prepare_device(self.device)
        self.workdir = workdir
        self.quiet = quiet
        if self.device.type == "cuda":
            # device banner (ref: the reference's GPU-info print at startup)
            self.log(f"gpumd_tpu_torch on cuda: "
                     f"{torch.cuda.device_count()} device(s) "
                     f"[{torch.cuda.get_device_name()}]")
        else:
            self.log("gpumd_tpu_torch on cpu")
        frame = read_xyz(os.path.join(workdir, "model.xyz"))
        self.frame = frame
        self.box = self._box(frame)
        self.symbols: List[str] = frame.symbols
        self.type_names: List[str] = []
        self.potentials: list = []
        self.ff: Optional[ForceField] = None
        self.state: Optional[MDState] = None
        self.dt = 1.0 / TIME_UNIT_CONVERSION  # natural units (default 1 fs)
        self.ensemble = None
        self.drivers = []
        self.groups = Groups(frame.groups, frame.n_atoms)
        self.mobile_mask = None  # set by `fix`
        self.move_pin = None  # set by `move`
        self.deform = None  # set by `deform`: A a step a direction
        self._dump_beads = None  # (interval, velocities, forces)
        self._last_velocity_t = 300.0  # rpmd/trpmd's temperature
        self._ens_aux = None  # the list path's ensemble aux, a chunk's end
        self.properties: List[PropertyRequest] = []
        self.measure_props: list = []
        self.global_step = 0
        self.engine_mode = "auto"
        self.engine_devices = 1  # slabs of `engine dense N`
        self.engine_axis = "z"
        self.route_reason: Optional[str] = None  # the last run's, or None
        self.md = None  # the last compact run's engine (None: list path)
        self.run_seconds: List[float] = []  # each run block's wall time
        self._n = frame.n_atoms
        self._files: Dict[str, object] = {}
        self._kspace_method = "pppm"  # qNEP's k-space (the `kspace` keyword)
        # several `potential` lines: potential 0 drives and the others are
        # observed ("observe"), or the forces are averaged ("average"), as
        # dump_observer sets it (ref: force.cu:211-217)
        self.observer_mode = "observe"
        self._deposit = None  # the `deposit` keyword's request
        self.mc = None  # the `mc` keyword's MCMD (kept across runs)
        self.replicate_cxyz = (1, 1, 1)  # `replicate`'s, for compute_phonon
        # (engine, carry) of the compact run at a chunk's end, for the
        # observers that evaluate on its plan and lists
        self._dense_eval_ctx = None
        self.observer_compact_evals = 0  # observer passes on the kernels
        self._observer_specs: Dict[int, Optional[CompactSpec]] = {}

    # ------------------------------------------------------------------ utils

    def log(self, *msg):
        if not self.quiet:
            print(*msg)

    def _box(self, frame) -> Box:
        return Box.from_lattice(frame.lattice, pbc=frame.pbc, dtype=self.dtype,
                                device=self.device)

    def _gmask(self, method: int, gid: int) -> torch.Tensor:
        """(N,) group membership on the session's device."""
        return self.groups.mask(method, gid, dtype=self.dtype,
                                device=self.device)

    def _file(self, name: str, header: Optional[str] = None):
        if name not in self._files:
            f = open(os.path.join(self.workdir, name), "w")
            if header:
                f.write(header)
            self._files[name] = f
        return self._files[name]

    def _require_state(self):
        if self.state is None:
            raise ValueError("no potential defined yet (potential keyword)")

    def _types_from_symbols(self) -> np.ndarray:
        if not self.type_names:
            raise ValueError("potential must be declared before this keyword")
        index = {s: i for i, s in enumerate(self.type_names)}
        try:
            return np.array([index[s] for s in self.symbols])
        except KeyError as e:
            raise ValueError(f"element {e} not covered by the potential")

    def _make_state(self, velocity=None) -> MDState:
        """State from the current frame, unwrapped positions tracked."""
        state = make_state(self.frame.positions, self.frame.default_masses(),
                           self._types_from_symbols(), self.box,
                           velocity=velocity, n_pad=self._n)
        return state._replace(unwrapped_position=state.position.clone())

    # -------------------------------------------------------------- keywords

    def kw_potential(self, args):
        path = os.path.join(self.workdir, args[0])
        with open(path) as f:
            head = f.readline().split()
        name = head[0]
        dev = dict(dtype=self.dtype, device=self.device)
        if name in _HEADER_POTENTIALS:
            pot = _HEADER_POTENTIALS[name].from_file(path, **dev)
            self.type_names = head[2:2 + int(head[1])]
        elif name in _SETFL_POTENTIALS:
            pot = _SETFL_POTENTIALS[name].from_file(path, **dev)
            self.type_names = list(pot.symbols)
        elif name == "nnap":
            raise RuntimeError(
                "nnap requires the external Java NNAP runtime (the "
                "reference gates it behind USE_NNAP + a JVM, nnap.cu:21); "
                "it is not bridged in this build")
        elif name in _ILP_LOADERS:
            if len(args) < 2:
                raise ValueError(f"{name} needs two potential files")
            pot = self._load_ilp(name, path,
                                 os.path.join(self.workdir, args[1]))
            self.type_names = head[2:2 + int(head[1])]
        elif name == "fcp":
            pot = FCP.from_file(path, workdir=self.workdir, **dev)
            pot = pot.attach_box(self.box)
            self.type_names = head[2:2 + int(head[1])]
        elif name == "dp":
            pot = DP.from_file(path)
            self.type_names = head[2:2 + int(head[1])]
        elif name.startswith("nep") and "charge" in name:
            pot = NEPCharge.from_file(path, **dev)._replace(
                kspace_method=self._kspace_method,
                pppm_mesh=best_mesh(self.box))
            self.type_names = list(pot.model.symbols)
        elif name.startswith("nep"):
            pot = NEP.from_file(path, **dev)
            # foundation models: slice the type tables down to the species
            # present in model.xyz (the same numbers; the compact engine
            # stays open)
            present = set(self.symbols)
            syms = list(pot.model.symbols)
            if 0 < len(present & set(syms)) < pot.model.num_types \
                    and present <= set(syms):
                pot = pot.restrict(sorted(present, key=syms.index))
            self.type_names = list(pot.model.symbols)
        else:
            raise ValueError(f"unsupported potential type {name!r}")
        self.potentials.append(pot)
        vel = (self.frame.velocities * TIME_UNIT_CONVERSION
               if self.frame.velocities is not None else None)
        state = self._make_state(velocity=vel)
        if self.state is not None:  # a later potential keeps the velocities
            state = state._replace(velocity=self.state.velocity)
        self.state = state
        self._rebuild_ff()
        self.log(f"potential: {name} ({path})")

    def _load_ilp(self, name, path, path2) -> ILPHybrid:
        """An ILP hybrid with the layer labels of its file's group method,
        nep_ilp's per-group NEP indices, and the intralayer list's
        capacity from the layers' bound at the intralayer cutoff."""
        dev = dict(dtype=self.dtype, device=self.device)
        labels = np.zeros(self._n, np.int32)
        if name == "nep_ilp":
            pot, gm, gm_nep, nep_map = load_nep_ilp(path, path2, labels,
                                                    **dev)
            if nep_map is not None:
                gids = self.groups.labels[:, gm_nep]
                pot = pot._replace(nep_labels=torch.as_tensor(
                    nep_map[gids], dtype=torch.int64, device=self.device))
        else:
            pot, gm = _ILP_LOADERS[name](path, path2, labels, **dev)
        labels = self.groups.labels[:, gm]
        pot = pot._replace(ilp=pot.ilp._replace(labels=torch.as_tensor(
            labels, dtype=torch.int64, device=self.device)))
        n = self._n
        return pot._replace(intra_mn=layer_bound(
            self.frame.positions[:n], labels[:n], _np(self.box.h),
            self.frame.pbc, pot.intra_rc))

    def observer_models(self) -> list:
        """The potentials of the `potential` lines (dftd3's term, which
        adds to the driving model, left out)."""
        return [p for p in self.potentials if not isinstance(p, DFTD3)]

    def driving_potentials(self) -> list:
        """What the force pass sums: with several `potential` lines in
        observe mode (the default) potential 0 and any dftd3 term, else
        every potential (averaged in average mode)."""
        models = self.observer_models()
        if len(models) > 1 and self.observer_mode == "observe":
            return models[:1] + [p for p in self.potentials
                                 if isinstance(p, DFTD3)]
        return list(self.potentials)

    def _force_field(self, box: Box, skin: float = 1.0) -> ForceField:
        """The force field of the driving potentials on `box` (ref:
        force.cu:211-217), its list sized for every potential loaded."""
        ff = ForceField.create(
            self.driving_potentials(), box, self._n,
            mn=_auto_mn(self.potentials, self._n, box,
                        self.frame.positions, self.frame.pbc), skin=skin)
        if len(self.observer_models()) > 1 and \
                self.observer_mode == "average":
            ff = dataclasses.replace(ff, average=True)
        return ff

    def _rebuild_ff(self):
        self.ff = self._force_field(self.box)

    def kw_velocity(self, args):
        self._require_state()
        t = float(args[0])
        seed = 12345
        if len(args) >= 3 and args[1] == "seed":
            seed = int(args[2])
        self.state = initialize_velocity(self.state, t, seed=seed)
        # rpmd/trpmd take their temperature from the last velocity keyword
        # (ref: run.cu sets it from the integrate parsing)
        self._last_velocity_t = t
        self.log(f"velocity: {t} K (seed {seed})")

    def kw_time_step(self, args):
        self.dt = float(args[0]) / TIME_UNIT_CONVERSION
        self.log(f"time_step: {args[0]} fs")

    def kw_ensemble(self, args):
        name = args[0]
        if name == "nve":
            self.ensemble = NVE()
        elif name in ("nvt_ber", "nvt_lan", "nvt_bdp", "nvt_nhc", "nvt_bao"):
            cls = {"nvt_ber": NVTBerendsen, "nvt_lan": NVTLangevin,
                   "nvt_bdp": NVTBDP, "nvt_nhc": NVTNoseHooverChain,
                   "nvt_bao": NVTBAOAB}[name]
            p = [float(x) for x in args[1:]]
            self.ensemble = cls(t0=p[0], t1=p[1], coupling=p[2])
        elif name == "nvt_qtb":
            self.ensemble = self._parse_nvt_qtb(args)
        elif name == "npt_qtb":
            self.ensemble = self._parse_npt_qtb(args[1:])
        elif name in ("heat_lan", "heat_nhc", "heat_bdp"):
            cls = {"heat_lan": HeatLangevin, "heat_nhc": HeatNHC,
                   "heat_bdp": HeatBDP}[name]
            p = [float(x) for x in args[1:]]
            self.ensemble = cls(
                temperature=p[0], coupling=p[1], delta_t=p[2],
                source_mask=self._gmask(0, int(p[3])),
                sink_mask=self._gmask(0, int(p[4])))
        elif name == "heat_hybrid":
            self.ensemble = self._parse_heat_hybrid(args[1:])
        elif name in ("npt_ber", "npt_scr"):
            cls = NPTBerendsen if name == "npt_ber" else NPTSCR
            p = [float(x) for x in args[1:]]
            t1, t2, tc = p[0], p[1], p[2]
            rest = p[3:]
            if len(rest) == 3:  # isotropic: p C tau_p
                ens = cls(t0=t1, t1=t2, coupling=tc,
                          target_pressure=(rest[0],) * 3,
                          elastic_modulus=(rest[1],) * 3, tau_p=rest[2],
                          isotropic=True)
            elif len(rest) == 7:  # px py pz Cx Cy Cz tau_p
                ens = cls(t0=t1, t1=t2, coupling=tc,
                          target_pressure=tuple(rest[0:3]),
                          elastic_modulus=tuple(rest[3:6]), tau_p=rest[6])
            else:
                raise ValueError(f"{name} needs 6 or 10 parameters")
            self.ensemble = ens
        elif name in ("nvt_mttk", "npt_mttk", "nph_mttk"):
            self.ensemble = self._parse_mttk(name, args[1:])
        elif name == "ti_spring":
            self.ensemble = self._parse_ti_spring(args[1:])
        elif name == "ti":
            self.ensemble = self._parse_ti(args[1:])
        elif name == "ti_liquid":
            self.ensemble = self._parse_ti_liquid(args[1:])
        elif name in ("ti_rs", "ti_as"):
            self.ensemble = self._parse_ti_npt(name, args[1:])
        elif name == "nphug":
            self.ensemble = self._parse_nphug(args[1:])
        elif name in ("ttm", "heat_ttm"):
            self.ensemble = self._parse_ttm(args[1:])
        elif name in ("wall_piston", "wall_mirror", "wall_harmonic"):
            self.ensemble = self._parse_wall(name, args[1:])
        elif name == "msst":
            self.ensemble = self._parse_msst(args[1:])
        elif name in ("pimd", "rpmd", "trpmd"):
            self.ensemble = self._parse_path_integral(name, args[1:])
        else:
            raise ValueError(f"unsupported ensemble {name!r}")
        self.log(f"ensemble: {name} {args[1:]}")

    def _parse_path_integral(self, name, toks):
        """ensemble pimd <nbeads> T1 [T2] Tc (a T1 -> T2 linear ramp, ref:
        run.cu's temperature interpolation) | rpmd|trpmd <nbeads> (the
        last `velocity` keyword's temperature, default 300 K): the tuple
        (mode, nbeads, T1, Tc, T2) that `run` hands to _run_pimd."""
        p = [float(x) for x in toks]
        nbeads = int(p[0])
        if name == "pimd":
            t1 = p[1]
            t2 = p[2] if len(p) > 3 else t1
            tc = p[3] if len(p) > 3 else (p[2] if len(p) > 2 else 100.0)
            return ("pimd", nbeads, t1, tc, t2)
        t = self._last_velocity_t
        return (name, nbeads, t, 100.0, t)

    def _parse_nvt_qtb(self, args):
        """ensemble nvt_qtb T1 T2 Tc [f_max v] [N_f n]."""
        kw = dict(temperature=float(args[1]), coupling=float(args[3]),
                  dt=self.dt)
        for key, val in _pairs(args[4:], "nvt_qtb"):
            if key == "f_max":
                kw["f_max"] = float(val)
            elif key == "N_f":
                kw["n_f"] = int(val)
            else:
                raise ValueError(f"unknown nvt_qtb keyword {key!r}")
        return NVTQTB(**kw)

    def _parse_npt_qtb(self, toks):
        """ensemble npt_qtb temp T1 T2 [tperiod x] [f_max v] [N_f n]
        iso|aniso|tri ps pe | x|y|z ps pe [pperiod x]
        (ref: ensemble_npt_qtb.cu:115-200)."""
        mode, comps, (ps, pe), per, other = _baro_tokens(
            "npt_qtb", toks, {"temp": 2, "f_max": 1, "N_f": 1})
        if mode is None and not comps:
            raise ValueError("npt_qtb requires pressure specification")
        kwq = dict(dt=self.dt)
        for key, field in (("temp", "temperature"), ("f_max", "f_max")):
            if key in other:
                kwq[field] = float(other[key][0])
        if "N_f" in other:
            kwq["n_f"] = int(other["N_f"][0])
        if "tperiod" in per:
            kwq["coupling"] = per["tperiod"]
        baro = MTTK(use_thermostat=False, use_barostat=True,
                    p_period=per.get("pperiod", 1000.0),
                    **_one_axis_config(MTTK, mode, comps, ps, pe))
        return NPTQTB(qtb=NVTQTB(**kwq), baro=baro)

    def _parse_heat_hybrid(self, toks):
        """ensemble heat_hybrid <kind>... T <coupling>... dT <label>...;
        kind nhc or lan, bath 0 the source (ref: heat_hybrid header)."""
        toks = list(toks)
        kinds = []
        while toks and toks[0] in ("nhc", "lan"):
            kinds.append(toks.pop(0))
        nt = len(kinds)
        if nt < 2:
            raise ValueError("heat_hybrid needs >= 2 thermostats")
        t = float(toks.pop(0))
        coup = tuple(float(toks.pop(0)) for _ in range(nt))
        dt_ = float(toks.pop(0))
        masks = tuple(self._gmask(0, int(toks.pop(0))) for _ in range(nt))
        return HeatHybrid(kinds=tuple(kinds), temperature=t, couplings=coup,
                          delta_t=dt_, masks=masks)

    def _parse_msst(self, toks):
        """ensemble msst x|y|z vs [qmass q] [mu m] [tscale f] [p0 P]
        [v0 V] [e0 E]."""
        kw = dict(shock_direction={"x": 0, "y": 1, "z": 2}[toks[0]],
                  vs=float(toks[1]))
        for key, val in _pairs(toks[2:], "msst"):
            if key not in ("qmass", "mu", "tscale", "p0", "v0", "e0"):
                raise ValueError(f"unknown msst token {key!r}")
            kw[key] = float(val)
        return MSST(**kw)

    def _parse_wall(self, name, toks):
        """ensemble wall_piston vp v thickness d | wall_mirror vp v
        [thickness d] | wall_harmonic vp v k kk [thickness d]; vp in km/s
        -> natural units (/100 x TIME_UNIT_CONVERSION,
        ensemble_wall_piston.cu:109)."""
        kw = {}
        for t, val in _pairs(toks, name):
            if t == "vp":
                kw["vp"] = float(val) / 100.0 * TIME_UNIT_CONVERSION
            elif t == "thickness":
                kw["thickness"] = float(val)
            elif t == "k" and name == "wall_harmonic":
                kw["k"] = float(val)
            else:
                raise ValueError(f"unknown {name} token {t!r}")
        return {"wall_piston": WallPiston, "wall_mirror": WallMirror,
                "wall_harmonic": WallHarmonic}[name](**kw)

    def _parse_ttm(self, toks):
        """ensemble ttm gm gid Ce rho_e kappa_e gamma_p gamma_s v_0
        nx ny nz T_e_init [ttm_out_interval n] [ttm_source s]
        (ref: ensemble_ttm.cu:84-300, unit conversions 742-790)."""
        gm, gid = int(toks[0]), int(toks[1])
        ce, rho_e, kappa_e = (float(toks[i]) for i in (2, 3, 4))
        gamma_p, gamma_s, v0 = (float(toks[i]) for i in (5, 6, 7))
        nx, ny, nz = (int(toks[i]) for i in (8, 9, 10))
        kw = {}
        for key, val in _pairs(toks[12:], "ttm"):
            if key == "ttm_out_interval":
                kw["out_interval"] = int(val)
            elif key == "ttm_source":
                kw["source"] = float(val) / 1000.0
            else:
                raise ValueError(f"unknown ttm keyword {key!r}")
        h = _np(self.box.h)
        v0_nat = v0 * TIME_UNIT_CONVERSION / 1000.0
        return TTM(gmask=self._gmask(gm, gid), c_vol=ce * rho_e,
                   kappa_e=kappa_e / 1000.0,
                   gamma_p=gamma_p * TIME_UNIT_CONVERSION / 1000.0,
                   gamma_s=gamma_s * TIME_UNIT_CONVERSION / 1000.0,
                   v0_sq=v0_nat * v0_nat, grid=(nx, ny, nz),
                   t_e_init=float(toks[11]),
                   dcell_static=(h[0, 0] / nx, h[1, 1] / ny, h[2, 2] / nz),
                   **kw)

    def _parse_nphug(self, toks):
        """ensemble nphug [tperiod x] [pperiod x]
        iso|aniso|tri ps pe | x|y|z ps pe [p0 v] [v0 v] [e0 v]
        (ref: ensemble_nphug.cu:27-160)."""
        mode, comps, (ps, pe), per, other = _baro_tokens(
            "nphug", toks, {"p0": 1, "v0": 1, "e0": 1})
        if mode is None and not comps:
            raise ValueError("nphug: must specify barostat parameters")
        kw = {key[0] + "_period": val for key, val in per.items()}
        kw.update((key, float(val[0])) for key, val in other.items())
        if "p0" in kw:
            kw["p0"] /= PRESSURE_UNIT_CONVERSION
        uni = "xyz".index(next(reversed(comps))) if comps else -1
        return NPHug(use_thermostat=True, use_barostat=True, uniaxial=uni,
                     **_one_axis_config(NPHug, mode, comps, ps, pe), **kw)

    def _springs(self, toks, i, spring):
        """`spring El k ...` from toks[i] on into `spring`; returns the
        index after it."""
        while i + 1 < len(toks):
            spring[toks[i]] = float(toks[i + 1])
            i += 2
        return i

    def _ti_tokens(self, name, toks, known):
        """The TI family's tokens, each of `known`: (kwargs, spring
        constants, the tokens with no field of their own)."""
        kw = dict(num_types=max(1, len(self.type_names)))
        spring, rest = {}, {}
        fields = {"temp": "temperature", "tperiod": "coupling",
                  "tswitch": "t_switch", "tequil": "t_equil"}
        i = 0
        while i < len(toks):
            t = toks[i]
            if t not in known:
                raise ValueError(f"unknown {name} token {t!r}")
            if t == "spring":
                i = self._springs(toks, i + 1, spring)
                continue
            val = toks[i + 1]
            if t in ("tswitch", "tequil"):
                kw[fields[t]] = int(val)
            elif t in fields:
                kw[fields[t]] = float(val)
            elif t == "press":
                kw["target_pressure"] = float(val) / PRESSURE_UNIT_CONVERSION
            else:
                rest[t] = float(val)
            i += 2
        return kw, spring, rest

    def _spring_table(self, name, spring):
        missing = [s for s in self.type_names if s not in spring]
        if missing:
            raise ValueError(f"{name}: spring constants missing for "
                             f"{missing}")
        return tuple(spring[s] for s in self.type_names)

    def _parse_ti(self, toks):
        """ensemble ti lambda x temp T [tperiod tau] spring El k ...
        (ref: ensemble_ti.cu:77-113)."""
        kw, spring, rest = self._ti_tokens(
            "ti", toks, ("lambda", "temp", "tperiod", "spring"))
        if "lambda" in rest:
            kw["lam"] = rest["lambda"]
        kw["spring_k"] = self._spring_table("ti", spring)
        return TI(**kw)

    def _parse_ti_spring(self, toks):
        """ensemble ti_spring temp T [tperiod tau] [tswitch n tequil n]
        [press P] [spring El k ...] (ref: ensemble_ti_spring.cu:100-150)."""
        kw, spring, _ = self._ti_tokens(
            "ti_spring", toks,
            ("temp", "tperiod", "tswitch", "tequil", "press", "spring"))
        if spring:
            kw["spring_k"] = self._spring_table("ti_spring", spring)
        return TISpring(**kw)

    def _parse_ti_liquid(self, toks):
        """ensemble ti_liquid temp T [press P] [tperiod tau] [tswitch n]
        [tequil n] [sigmasqrd s2] [p P_UF]
        (ref: ensemble_ti_liquid.cu:151-203)."""
        kw, _, rest = self._ti_tokens(
            "ti_liquid", toks, ("temp", "press", "tperiod", "tswitch",
                                "tequil", "sigmasqrd", "p"))
        if "sigmasqrd" in rest:
            kw["sigma_sqrd"] = rest["sigmasqrd"]
        if "p" in rest:
            if int(round(rest["p"])) not in (1, 25, 50, 75, 100):
                raise ValueError("ti_liquid: p must be 1, 25, 50, 75 or 100")
            kw["p_uf"] = rest["p"]
        return TILiquid(**kw)

    def _parse_ti_npt(self, name, toks):
        """ensemble ti_rs temp T Tmax iso|aniso|tri P [tperiod x]
        [pperiod x] [tswitch n] [tequil n]   (ref: ensemble_ti_rs.cu:52-105)
        ensemble ti_as temp T press pmin pmax iso P ...
        (ref: ensemble_ti_as.cu:24-135)."""
        mode, _, (press, _), per, other = _baro_tokens(
            name, toks, {"temp": 2 if name == "ti_rs" else 1, "press": 2,
                         "tswitch": 1, "tequil": 1}, axes=(), n_press=1)
        kw = {key[0] + "_period": val for key, val in per.items()}
        if "temp" in other:
            kw["t_start"] = kw["t_stop"] = float(other["temp"][0])
            if name == "ti_rs":
                kw["t_max"] = float(other["temp"][1])
        if "press" in other:
            kw["p_min"], kw["p_max"] = (float(x) for x in other["press"])
        for key in ("tswitch", "tequil"):
            if key in other:
                kw["t_" + key[1:]] = int(other[key][0])
        cls = TIRS if name == "ti_rs" else TIAS
        if name == "ti_as" and "p_min" not in kw:
            kw["p_min"] = kw["p_max"] = press
        return cls(use_thermostat=True, use_barostat=True,
                   **cls._baro_config(press, press, mode or "iso"), **kw)

    def _parse_mttk(self, name, toks):
        """The MTTK keyword stream (ref: ensemble_mttk.cu:81-238):
        temp T1 T2 | tperiod t | pperiod p | iso/aniso/tri P1 P2 |
        x/y/z/xy/xz/yz P1 P2."""
        mode, comps, (p1, p2), per, other = _baro_tokens(
            name, toks, {"temp": 2}, axes=("x", "y", "z", "xy", "xz", "yz"))
        t1, t2 = ((float(x) for x in other["temp"]) if "temp" in other
                  else (None, None))
        tper, pper = per.get("tperiod", 100.0), per.get("pperiod", 1000.0)
        if comps:
            baro = (comps, comps)
        elif mode is not None:
            baro = (p1, p2)
        else:
            baro = None
        if name == "nvt_mttk":
            if t1 is None:
                raise ValueError("nvt_mttk needs temp T1 T2")
            return MTTK.nvt(t1, t2, t_period=tper)
        if name == "nph_mttk":
            if baro is None:
                raise ValueError("nph_mttk needs a barostat spec")
            return MTTK.nph(baro[0], baro[1], mode=mode or "aniso",
                            p_period=pper)
        if t1 is None or baro is None:
            raise ValueError("npt_mttk needs temp and a barostat spec")
        return MTTK.npt(t1, t2, baro[0], baro[1], mode=mode or "aniso",
                        t_period=tper, p_period=pper)

    def kw_dump_thermo(self, args):
        interval = int(args[0])
        f = self._file(
            "thermo.out",
            f"# dump_thermo {interval}\n# format_version 1\n"
            f"# num_atoms {self._n}\n"
            f"# dt_output {self.dt * interval * TIME_UNIT_CONVERSION:.10e} fs\n"
            "# columns T KE PE sxx syy szz syz sxz sxy "
            "ax ay az bx by bz cx cy cz\n",
        )

        def process(session, state, step):
            f.write("".join(f"{x:20.10e}" for x in thermo_row(state)) + "\n")
            f.flush()

        self.properties.append(PropertyRequest(interval, process))
        self.log(f"dump_thermo every {interval}")

    def _dump_frame(self, state: MDState, filename, with_vel, with_forces):
        n = self._n
        frame = XYZFrame(
            symbols=self.symbols,
            positions=_np(state.box.wrap(state.position))[:n],
            lattice=_np(state.box.h).T,
            pbc=self.frame.pbc,
            velocities=(_np(state.velocity)[:n] / TIME_UNIT_CONVERSION
                        if with_vel else None),
            forces=_np(state.force)[:n] if with_forces else None,
            masses=_np(state.mass)[:n],
        )
        write_xyz(os.path.join(self.workdir, filename), frame, append=True,
                  with_velocities=with_vel, with_forces=with_forces)

    def kw_dump_exyz(self, args):
        interval = int(args[0])
        with_vel = len(args) > 1 and args[1] == "1"
        with_f = len(args) > 2 and args[2] == "1"

        def process(session, state, step):
            self._dump_frame(state, "dump.xyz", with_vel, with_f)

        self.properties.append(PropertyRequest(interval, process))
        self.log(f"dump_exyz every {interval}")

    def kw_dump_xyz(self, args):
        """dump_xyz grouping_method group_id interval filename [quantities]

        Group-selective extended-XYZ dump (ref: dump_xyz.cu:73-160).
        grouping_method < 0 dumps the whole system; a trailing '*' on the
        filename writes one file per frame.  Quantities: velocity, force,
        mass, potential, unwrapped_position."""
        if len(args) < 4:
            raise ValueError("dump_xyz needs at least 4 parameters")
        gm, gid, interval = int(args[0]), int(args[1]), int(args[2])
        filename = args[3]
        if interval <= 0:
            raise ValueError("dump interval should be > 0")
        if gm >= 0:
            if gm >= self.groups.n_methods:
                raise ValueError("grouping method exceeds the bound")
            if not 0 <= gid < self.groups.num_groups(gm):
                raise ValueError("group id exceeds the bound")
        quantities = set(args[4:])
        known = {"velocity", "force", "mass", "potential",
                 "unwrapped_position", "charge", "bec", "group", "virial"}
        unknown = quantities - known
        if unknown:
            raise ValueError(f"unknown dump_xyz quantities {sorted(unknown)}")
        separated = filename.endswith("*")
        base = filename[:-1] if separated else filename
        first = [True]

        def process(session, state, step):
            n = session._n
            if gm >= 0:
                sel = np.where(session.groups.labels[:n, gm] == gid)[0]
            else:
                sel = np.arange(n)
            prop = "species:S:1:pos:R:3"
            cols = [_np(state.box.wrap(state.position))[:n][sel]]
            if "mass" in quantities:
                prop += ":mass:R:1"
                cols.append(_np(state.mass)[:n][sel, None])
            if "velocity" in quantities:
                prop += ":vel:R:3"
                cols.append(_np(state.velocity)[:n][sel]
                            / TIME_UNIT_CONVERSION)
            if "force" in quantities:
                prop += ":forces:R:3"
                cols.append(_np(state.force)[:n][sel])
            if "potential" in quantities:
                prop += ":energy_atom:R:1"
                cols.append(_np(state.potential_energy)[:n][sel, None])
            if "unwrapped_position" in quantities:
                prop += ":unwrapped_position:R:3"
                up = (state.unwrapped_position
                      if state.unwrapped_position is not None
                      else state.position)
                cols.append(_np(up)[:n][sel])
            h = _np(state.box.h)
            lat = " ".join(f"{x:.15g}" for x in h.T.ravel())
            pb = " ".join("T" if p else "F" for p in session.frame.pbc)
            path = os.path.join(session.workdir,
                                f"{base}{step}" if separated else base)
            mode = "w" if separated or first[0] else "a"
            first[0] = False
            with open(path, mode) as f:
                f.write(f"{len(sel)}\n")
                f.write(f'Lattice="{lat}" Properties={prop} pbc="{pb}"\n')
                data = np.concatenate(cols, axis=1)
                for k, i in enumerate(sel):
                    f.write(f"{session.symbols[i]:<2s} "
                            + " ".join(f"{x:.15g}" for x in data[k]) + "\n")

        self.properties.append(PropertyRequest(interval, process))
        self.log(f"dump_xyz group {gm}/{gid} every {interval} into {filename}")

    def kw_dump_position(self, args):
        interval = int(args[0])

        def process(session, state, step):
            self._dump_frame(state, "movie.xyz", False, False)

        self.properties.append(PropertyRequest(interval, process))

    def kw_dump_velocity(self, args):
        """velocity.out: one row per atom per frame, A/fs."""
        interval = int(args[0])
        f = self._file("velocity.out")

        def process(session, state, step):
            v = _np(state.velocity)[:session._n] / TIME_UNIT_CONVERSION
            for row in v:
                f.write(" ".join(f"{x:g}" for x in row) + "\n")
            f.flush()

        self.properties.append(PropertyRequest(interval, process))

    def kw_dump_force(self, args):
        interval = int(args[0])
        f = self._file("force.out")

        def process(session, state, step):
            for row in _np(state.force)[:session._n]:
                f.write(" ".join(f"{x:g}" for x in row) + "\n")
            f.flush()

        self.properties.append(PropertyRequest(interval, process))

    def kw_dump_restart(self, args):
        interval = int(args[0])

        def process(session, state, step):
            n = self._n
            frame = XYZFrame(
                symbols=self.symbols,
                positions=_np(state.box.wrap(state.position))[:n],
                lattice=_np(state.box.h).T,
                pbc=self.frame.pbc,
                velocities=_np(state.velocity)[:n] / TIME_UNIT_CONVERSION,
                masses=_np(state.mass)[:n],
            )
            write_xyz(os.path.join(self.workdir, "restart.xyz"), frame,
                      append=False, with_velocities=True, with_masses=True)

        self.properties.append(PropertyRequest(interval, process))

    def kw_correct_velocity(self, args):
        interval = int(args[0])

        def process(session, state, step):
            session.state = correct_velocity(state)

        self.properties.append(PropertyRequest(interval, process))

    def kw_engine(self, args):
        """engine dense|list|auto [n_devices] [axis]: route `run` through
        the compact engine (engine/dense_md.py, the kernels' path), the
        list path, or let `dense_route_reason` choose (the default).  With
        n_devices > 1 a compact-engine run takes the slab-sharded engine
        (engine/sharded.py), its slabs cut along `axis` (x, y or z; the
        reference's user-selectable partition, nep_multigpu.cu:1429-1455)
        and put round-robin over the visible cards.  The JAX app raises
        when fewer devices than slabs are visible; here slabs share a card
        (logged), so a one-card machine runs any N."""
        mode = args[0]
        ndev = int(args[1]) if len(args) > 1 else 1
        axis = args[2] if len(args) > 2 else "z"
        if mode not in ("dense", "list", "auto"):
            raise ValueError("engine must be 'dense', 'list' or 'auto'")
        if ndev < 1:
            raise ValueError("engine: the device count must be >= 1")
        if axis not in ("x", "y", "z"):
            raise ValueError("engine partition axis must be x, y or z")
        self.engine_mode = mode
        self.engine_devices = ndev
        self.engine_axis = axis
        self.log(f"engine: {mode}")

    def kw_replicate(self, args):
        """replicate cx cy cz: build a supercell (basis-inner atom order;
        ref: src/main_gpumd/replicate.cu)."""
        cx, cy, cz = int(args[0]), int(args[1]), int(args[2])
        f = self.frame
        lat = np.asarray(f.lattice)
        cells = np.array([[i, j, k] for i in range(cx) for j in range(cy)
                          for k in range(cz)])
        shifts = cells @ lat  # (C, 3)
        pos = (shifts[:, None, :] + f.positions[None, :, :]).reshape(-1, 3)
        symbols = [s for _ in range(len(cells)) for s in f.symbols]
        self.frame = dataclasses.replace(
            f, positions=pos, symbols=symbols,
            lattice=lat * np.array([cx, cy, cz])[:, None],
            velocities=(np.tile(f.velocities, (len(cells), 1))
                        if f.velocities is not None else None),
            groups=(np.tile(f.groups, (len(cells), 1))
                    if f.groups is not None else None),
            masses=(np.tile(f.masses, len(cells))
                    if f.masses is not None else None))
        self.symbols = symbols
        self._n = len(pos)
        self.box = self._box(self.frame)
        self.replicate_cxyz = (cx, cy, cz)
        self.groups = Groups(self.frame.groups, self._n)
        if self.potentials:  # rebuild the state with the new geometry
            self.state = self._make_state()
            self._rebuild_ff()
        self.log(f"replicate: {cx} x {cy} x {cz} -> {self._n} atoms")

    def kw_fix(self, args):
        """fix [grouping_method] group_id: freeze a group
        (ref: integrate.cu:1272-1300)."""
        if self.groups.n_methods == 0:
            raise ValueError("cannot use 'fix' without grouping methods")
        if len(args) == 2:
            method, gid = int(args[0]), int(args[1])
        else:
            method, gid = 0, int(args[0])
        self.mobile_mask = 1.0 - self._gmask(method, gid)
        self.log(f"fix: group {gid} (method {method}) frozen")

    def kw_move(self, args):
        """move [method] group vx vy vz (A/fs): constant-velocity group
        (ref: integrate.cu:1315-1378)."""
        if len(args) == 5:
            method, gid = int(args[0]), int(args[1])
            v = [float(x) for x in args[2:5]]
        else:
            method, gid = 0, int(args[0])
            v = [float(x) for x in args[1:4]]
        vel = np.asarray(v) * TIME_UNIT_CONVERSION  # A/fs -> natural
        self.move_pin = (self._gmask(method, gid), vel)
        self.log(f"move: group {gid} at {v} A/fs")

    def kw_deform(self, args):
        """deform rate [rx ry rz] dx dy dz: the box's strain rate in A a
        step on the flagged directions (ref: integrate.cu:1381-1420); the
        list path wraps the ensemble in DeformWrapper."""
        if len(args) == 4:
            rates = [float(args[0])] * 3
            flags = [int(x) for x in args[1:4]]
        else:
            rates = [float(x) for x in args[0:3]]
            flags = [int(x) for x in args[3:6]]
        self.deform = tuple(r if f else 0.0 for r, f in zip(rates, flags))
        self.log(f"deform: {self.deform} A/step")

    def kw_dump_shock_nemd(self, args):
        """dump_shock_nemd interval n bin_size d -> temperature, pxx, pyy,
        pzz, density and vp _hist.txt, one row a dump (ref:
        dump_shock_nemd.cu): a bin along x's COM-relative temperature,
        stress (virial + convective) in GPa, density in g/cm3 and COM vx
        in km/s, from the state read at the dump, in float64 on the
        host."""
        interval = bin_size = None
        for key, val in _pairs(args, "dump_shock_nemd"):
            if key == "interval":
                interval = int(val)
            elif key == "bin_size":
                bin_size = float(val)
            else:
                raise ValueError(f"dump_shock_nemd: unknown {key!r}")
        if interval is None or bin_size is None:
            raise ValueError("dump_shock_nemd needs interval and bin_size")
        h = _np(self.box.h)
        bins = int(h[0, 0] / bin_size) + 1
        slice_vol = h[1, 1] * h[2, 2] * bin_size
        files = {name: self._file(f"{name}_hist.txt")
                 for name in ("temperature", "pxx", "pyy", "pzz", "density",
                              "vp")}

        def process(session, state, step):
            mask = _np(state.mask) > 0
            x = _np(state.position)[:, 0]
            b = np.clip((x / bin_size).astype(np.int64), 0, bins - 1)
            b = np.where(mask, b, bins)
            v, w = _np(state.velocity), _np(state.virial)
            mw = _np(state.mass) * mask

            def per_bin(weights):
                return np.bincount(b, weights=weights,
                                   minlength=bins + 1)[:bins]

            dens = per_bin(mw)
            com = np.stack([per_bin(mw * v[:, k]) for k in range(3)], axis=1)
            com = np.where(dens[:, None] > 1e-5,
                           com / np.maximum(dens, 1e-30)[:, None], 0.0)
            vrel = v - com[np.minimum(b, bins - 1)]
            temp = per_bin(mw * (vrel ** 2).sum(axis=1))
            num = per_bin(mask.astype(float))
            temp = np.where(num >= 20,
                            temp / np.maximum(3 * num * K_B, 1e-30), temp)
            rows = {}
            for j, name in enumerate(("pxx", "pyy", "pzz")):
                pk = w[:, j, j] + mw * vrel[:, j] ** 2
                rows[name] = (per_bin(pk * mask) / slice_vol
                              * PRESSURE_UNIT_CONVERSION)
            rows["temperature"] = temp
            rows["density"] = dens / slice_vol * 1.660538921  # g/cm3
            rows["vp"] = com[:, 0] / (0.01 * TIME_UNIT_CONVERSION)  # km/s
            for name, arr in rows.items():
                files[name].write(" ".join(f"{v2:f}" for v2 in arr) + "\n")
                files[name].flush()

        self.properties.append(
            PropertyRequest(interval, process, needs_atom_virial=True))
        self.log(f"dump_shock_nemd {args}")

    # ----------------------------------------------------------- the route

    def _run_dense(self, n_steps, ens):
        """MD block on the compact engine (one driving NEP or Tersoff-1989
        potential); properties observe input-order snapshots at chunk
        boundaries, SHC accumulates on the card inside the chunk, and
        dump_observer's models evaluate on the chunk end's plan and
        lists (`_dense_eval_ctx`)."""
        driving = self.driving_potentials()
        if len(driving) != 1 or not isinstance(driving[0],
                                               (NEP, Tersoff1989)):
            raise ValueError("engine dense: exactly one driving NEP or "
                             "Tersoff1989 potential")
        pot = driving[0]
        needs_heat = any(getattr(m, "needs_heat", False)
                         for m in self.measure_props)
        needs_av = any(getattr(m, "needs_atom_virial", False)
                       for m in self.measure_props) or any(
            p.needs_atom_virial for p in self.properties)
        hnemd_fe = self.ff.hnemd_fe
        pav = needs_heat or needs_av or hnemd_fe is not None
        n = self._n
        state = self.state
        ndev = self.engine_devices
        # measures with a device_init accumulate on the card inside the
        # chunk (one device only); the others sample at chunk boundaries
        dev_props = [m for m in self.measure_props
                     if hasattr(m, "device_init") and ndev == 1]
        host_props = [m for m in self.measure_props if m not in dev_props]
        intervals = [p.interval for p in self.properties] + [
            m.interval for m in host_props]
        chunk = _bounded_chunk(
            math.gcd(*intervals) if intervals else n_steps, n_steps)
        if ndev > 1:
            if not isinstance(pot, NEP):
                raise ValueError("engine dense multi-device: NEP only")
            return self._run_dense_sharded(n_steps, ens, pot, chunk, pav)
        position = _np(state.position)[:n]
        if isinstance(pot, Tersoff1989):
            md = CompactTersoffMD(pot, state.box, n, position=position,
                                  per_atom_virial=pav)
        else:
            md = DenseNEPMD(pot, state.box, n, position=position,
                            per_atom_virial=pav)
            if pav and md.engine != "compact":
                raise ValueError(
                    "engine dense: per-atom heat-current observables need "
                    "the compact engine (this model fell back to the window "
                    "engine); use `engine list`")
        md.hnemd_fe = hnemd_fe
        self.md = md
        heat_props = [m for m in self.measure_props
                      if hasattr(m, "consume_heat")]
        observer = heat_current_5 if heat_props else None
        if dev_props:
            def measure(maccs, st, orig_id):
                return tuple(m.device_update(a, st, orig_id)
                             for m, a in zip(dev_props, maccs))
            maccs = tuple(m.device_init(self, n) for m in dev_props)
        else:
            measure, maccs = None, ()
        hooked = observer is not None or measure is not None
        t0 = time.time()
        with torch.no_grad():
            carry = md.init_carry(state)
            carry = carry._replace(state=md.compute(carry.state, carry.idx))
            aux = ens.init(carry.state)
            step = md.make_step(ens, self.dt, observer=observer,
                                measure=measure)
            done = 0
            while done < n_steps:
                ys = []
                for _ in range(chunk):
                    if hooked:
                        carry, aux, maccs, y = step(carry, aux, maccs)
                        ys.append(y)
                    else:
                        carry, aux = step(carry, aux)
                if heat_props:
                    rows = torch.stack(ys)  # (chunk, 5), read once
                    for m in heat_props:
                        m.consume_heat(rows, self.global_step)
                        if hasattr(m, "maybe_output"):
                            m.maybe_output(self)
                done += chunk
                self.global_step += chunk
                if bool(carry.overflow):
                    raise RuntimeError(
                        "dense engine: cell capacity overflow; rerun with "
                        "engine list or a larger skin")
                self._dense_eval_ctx = (md, carry)
                self._chunk_end(md.to_input_order(carry, n), done,
                                host_props)
        self._dense_eval_ctx = None
        wall = time.time() - t0
        self.run_seconds.append(wall)
        self.log(f"Speed of this run = {n * n_steps / max(wall, 1e-9):.5g} "
                 f"atom*step/second (dense)")
        for m, a in zip(dev_props, maccs):
            m.device_postprocess(self, a)
        self._finish_run()

    def _chunk_end(self, snap, done, measures):
        """A dense run's chunk end, on its input-order snapshot: the
        finite-energy check, then the snapshot to the session, the
        properties and the measures that sample chunk ends."""
        pe = float(torch.sum(snap.potential_energy * snap.mask))
        if not np.isfinite(pe):
            raise RuntimeError(f"non-finite potential energy at step "
                               f"{self.global_step}")
        self.state = snap
        for prop in self.properties:
            if done % prop.interval == 0:
                prop.process(self, snap, self.global_step)
        for m in measures:
            if done % m.interval == 0 and hasattr(m, "sample_state"):
                m.sample_state(self, snap, self.global_step)

    def _run_dense_sharded(self, n_steps, ens, nep, chunk, pav):
        """A NEP run on the z-slab sharded engine (engine/sharded.py):
        blocks of `chunk` steps, a global rebin between them, and a block
        whose atoms outran the skin rerun from its start in one-step
        blocks with a global rebin after each, so every step starts from
        fresh slab bins and tiles (the JAX app keeps the chunk's bins,
        ROADMAP queue 3)."""
        ndev = self.engine_devices
        devices = round_robin_devices(ndev, self.device)
        n = self._n
        state = self.state
        hnemd_fe = self.ff.hnemd_fe
        smd = ShardedDenseMD(nep, state.box, n, devices,
                             position=_np(state.position)[:n],
                             axis=self.engine_axis,
                             per_atom_virial=pav)
        self.log(f"engine dense {ndev}: {smd.placement}")
        if pav and smd.engine != "compact":
            raise ValueError(
                "engine dense sharded: heat observables need the compact "
                "engine; use `engine list`")
        smd.hnemd_fe = hnemd_fe
        self.md = smd
        heat_props = [m for m in self.measure_props
                      if hasattr(m, "consume_heat")]
        observer = heat_current_5 if heat_props else None
        block, _ = smd.make_block(ens, self.dt, chunk, observer=observer)
        block1 = None  # one-step blocks, for a block the drift invalidated
        sstate, oid, overflow = smd.bin_state(state, with_id=True)
        if bool(overflow):
            raise RuntimeError("dense engine: cell capacity overflow")
        aux = None
        t0 = time.time()
        done = 0
        while done < n_steps:
            pre_state, pre_aux, pre_oid = sstate, aux, oid
            sstate, aux, ok, ys = block(sstate, aux)
            if not bool(ok):  # the block's one read
                self.log("sharded block invalidated by drift; retrying "
                         "with per-step index rebuilds")
                if block1 is None:
                    block1 = smd.make_block(ens, self.dt, 1,
                                            observer=observer)[0]
                sstate, aux, oid = pre_state, pre_aux, pre_oid
                rows = []
                for i in range(chunk):
                    if i:
                        sstate, oid, overflow = smd.bin_state(
                            smd.gather_input_order(sstate, oid, n),
                            with_id=True)
                        if bool(overflow):
                            raise RuntimeError("dense engine: cell "
                                               "capacity overflow")
                    sstate, aux, ok, y1 = block1(sstate, aux)
                    if not bool(ok):
                        raise RuntimeError(
                            "dense engine: neighbor cap overflow or an "
                            "atom moved past skin/2 in one step")
                    if observer is not None:
                        rows.append(y1[0])
                ys = torch.stack(rows) if rows else ys
            if heat_props:
                for m in heat_props:
                    m.consume_heat(ys, self.global_step)
                    if hasattr(m, "maybe_output"):
                        m.maybe_output(self)
            done += chunk
            self.global_step += chunk
            snap = smd.gather_input_order(sstate, oid, n)
            self._chunk_end(snap, done, self.measure_props)
            if done < n_steps:
                sstate, oid, overflow = smd.bin_state(snap, with_id=True)
                if bool(overflow):
                    raise RuntimeError("dense engine: cell capacity "
                                       "overflow")
        wall = time.time() - t0
        self.run_seconds.append(wall)
        self.log(f"Speed of this run = {n * n_steps / max(wall, 1e-9):.5g} "
                 f"atom*step/second (dense, {ndev} slabs)")
        self._finish_run()

    def _finish_run(self):
        """Reset the per-run observers and drivers (ref: run.cu:329-340
        finalize()); the HNEMD and HNEMDEC driving forces are per run
        too."""
        for m in self.measure_props:
            m.postprocess(self)
        self.measure_props = []
        for prop in self.properties:
            if prop.finalize:
                prop.finalize(self)
        self.properties = []
        self.drivers = []
        if self.ff is not None and (self.ff.hnemd_fe is not None
                                    or self.ff.hnemdec_mode is not None):
            self.ff = dataclasses.replace(
                self.ff, hnemd_fe=None, hnemdec_mode=None, hnemdec_fe=None,
                hnemdec_coef=None)

    def _wire_nep_temperature(self, ens):
        """Temperature-dependent NEP (model_type 3): feed the ensemble's
        target temperature (ref: run.cu:679-681 sets force.temperature =
        temperature1), on both routes."""
        if not any(isinstance(p, NEP) and p.model.model_type == 3
                   for p in self.potentials):
            return
        t_tgt = getattr(ens, "t0", None) or getattr(ens, "t1", None)
        if t_tgt is None:
            raise ValueError(
                "temperature-mode NEP needs a thermostatted ensemble")
        self.potentials = [
            p._replace(temperature=float(t_tgt))
            if isinstance(p, NEP) and p.model.model_type == 3 else p
            for p in self.potentials]
        self.ff = dataclasses.replace(
            self.ff, potentials=tuple(self.driving_potentials()))

    def kw_run(self, args):
        self._require_state()
        n_steps = int(args[0])
        if self._deposit is not None:
            self._prepare_deposit(n_steps)
        if self.ensemble is None:
            self.ensemble = NVE()
        self._ens_aux = None
        ens = self.ensemble
        if isinstance(ens, tuple):
            # the path integrals run their own runner whatever the engine
            # (the JAX app's kw_run does the same)
            self.route_reason = "path integrals"
            self.log(f"engine {self.engine_mode}: list path (path "
                     f"integrals)")
            self.md = None
            return self._run_pimd(n_steps)
        # temperature ramp length = this run's steps
        if hasattr(ens, "n_steps"):
            ens = dataclasses.replace(ens, n_steps=n_steps)
        mode = self.engine_mode
        if mode == "dense":
            blocker = _dense_blocker(self, ens)
            if blocker is not None:
                raise ValueError(f"engine dense: the compact engine does "
                                 f"not take {blocker}; use `engine list` "
                                 f"or `engine auto`")
            self.route_reason = None
            self._wire_nep_temperature(ens)
            return self._run_dense(n_steps, ens)
        if mode == "auto":
            self.route_reason = dense_route_reason(self, ens, self.device)
            if self.route_reason is None:
                self.log("engine auto: compact engine")
                self._wire_nep_temperature(ens)
                return self._run_dense(n_steps, ens)
            self.log(f"engine auto: list path ({self.route_reason})")
        else:
            self.route_reason = "engine list"
        self.md = None
        self._run_list(n_steps, ens)

    def _mc_block(self, mc, trials, state, done, n_steps):
        """One MC block at a chunk end, at the temperature ramped over the
        run, and its mcmd.out row: the acceptance and, for SGC and
        VC-SGC, each listed species' concentration (ref:
        mc_ensemble_sgc.cu mc_output tail)."""
        t_now = mc.t_initial + (mc.t_final - mc.t_initial) * (
            done / max(n_steps, 1))
        state, na = trials(state, t_now)
        self.state = state
        row = f"{self.global_step}  {na / mc.num_steps_mc:.6f}"
        if mc.sgc_types:
            real = state.mask > 0
            *counts, nr = torch.stack(
                [torch.sum((state.type == tt) & real)
                 for tt in mc.sgc_types] + [torch.sum(real)]).tolist()
            row += "".join(f" {c / max(nr, 1):.6f}" for c in counts)
        fmc = self._file("mcmd.out")
        fmc.write(row + "\n")
        fmc.flush()
        return state

    def _check_capacity(self, peak: int, cap: int, where: str):
        """The list path's loud neighbour-capacity check: the reference
        aborts on overflow; a silently truncated row corrupts forces."""
        if peak > cap:
            raise RuntimeError(
                f"neighbor overflow {where}: an atom has {peak} neighbors "
                f"but the list capacity is {cap}; increase mn")

    def _run_list(self, n_steps, ens):
        """MD block on the general path: ForceField + integrate/run.py,
        chunk by chunk."""
        if self.mobile_mask is not None and hasattr(ens, "mobile"):
            ens = dataclasses.replace(ens, mobile=self.mobile_mask)
        if self.move_pin is not None and hasattr(ens, "pinned"):
            ens = dataclasses.replace(ens, pinned=self.move_pin)
        if self.deform is not None:
            ens = DeformWrapper(inner=ens, rate=self.deform)
        self._wire_nep_temperature(ens)
        intervals = [p.interval for p in self.properties] + [
            m.interval for m in self.measure_props]
        mc = self.mc
        if mc is not None:
            intervals.append(mc.num_steps_md)
            mc_trials = mc.make_trials(self.ff)
        chunk = _bounded_chunk(
            math.gcd(*intervals) if intervals else n_steps, n_steps)
        needs_heat = any(getattr(m, "needs_heat", False)
                         for m in self.measure_props)
        needs_stress = any(getattr(m, "needs_stress", False)
                           for m in self.measure_props)
        ons = next((m for m in self.measure_props
                    if getattr(m, "needs_onsager", False)), None)
        observed = needs_heat or needs_stress or ons is not None
        is_ti = hasattr(ens, "csv_name")
        if is_ti and (needs_heat or needs_stress):
            raise ValueError("TI runs do not support heat/stress observers")

        def observer(s, a):
            """A TI step's observation; else a step's heat current, stress
            and Onsager fluxes (each None unless a measure consumes
            it)."""
            if is_ti:
                return ens.observe(s, a)
            if not observed:
                return None
            return (heat_current_5(s) if needs_heat else None,
                    stress_6(s) if needs_stress else None,
                    onsager_flux(s, ons.mass_type, ons.num_types)
                    if ons is not None else None)
        st = self.state
        with torch.no_grad():
            # loud neighbour-capacity check: the reference aborts on
            # overflow; a silently truncated list corrupts forces
            nbr0 = self.ff.neighbor.build(st.box.wrap(st.position), st.box,
                                          st.mask)
            counts = nbr0.count[st.mask > 0]
            cmin, cmax, cmean = torch.stack(
                [counts.min().double(), counts.max().double(),
                 counts.double().mean()]).tolist()
            cap = nbr0.idx.shape[1]
            self._check_capacity(int(cmax), cap,
                                 f"at step {self.global_step}")
            # neighbor.out: one occupancy row per `run` (ref: nep.cu:
            # 1014-1034 logs every 1000 calls)
            fnb = self._file("neighbor.out")
            fnb.write(f"step {self.global_step}: min {int(cmin)} "
                      f"mean {cmean:.1f} max {int(cmax)} capacity {cap}\n")
            fnb.flush()
            del nbr0
            state = self.ff.compute(self.state)
            cache = (self.ff.refresh_cache(state) if self.ff.skin > 0
                     else None)
        runner = MDRunner(self.ff, ens, self.dt, chunk, observer=observer,
                          drivers=tuple(self.drivers))
        aux = None
        t0 = time.time()
        done = 0
        while done < n_steps:
            step0 = self.global_step
            state, (aux, cache), obs = runner(state, aux=aux, cache=cache)
            self._ens_aux = aux  # processors read e.g. the baths' energies
            if is_ti:
                fcsv = self._file(ens.csv_name, ens.csv_header)
                for row in ens.csv_rows(obs, self._n):
                    fcsv.write(row)
                fcsv.flush()
            done += chunk
            self.global_step += chunk
            self.state = state
            # the chunk end's one read: the energy and the deepest row of
            # every list the chunk built
            pe_t = torch.sum(state.potential_energy * state.mask)
            if cache is not None:
                pe, peak = torch.stack([pe_t.double(),
                                        cache.peak.double()]).tolist()
                self._check_capacity(int(peak), cap,
                                     f"by step {self.global_step}")
            else:
                pe = float(pe_t)
            if not np.isfinite(pe):
                raise RuntimeError(
                    f"non-finite potential energy at step "
                    f"{self.global_step}: the system blew up (check "
                    f"time_step, initial overlaps, or neighbor capacity)")
            # 10%-progress prints (ref: run.cu:313-317)
            decile = max(n_steps // 10, 1)
            if done % decile < chunk and n_steps >= 10:
                self.log(f"    {int(100 * done / n_steps)}% of the run "
                         f"completed ({done}/{n_steps} steps)")
            if observed and not is_ti:
                j5, s6, fluxes = obs
                for m in self.measure_props:
                    if getattr(m, "needs_heat", False):
                        m.consume_heat(j5, step0)
                        if hasattr(m, "maybe_output"):
                            m.maybe_output(self)
                    if getattr(m, "needs_stress", False):
                        m.consume_stress(s6, step0)
                    if getattr(m, "needs_onsager", False):
                        m.consume_onsager(fluxes, step0)
                        m.maybe_output(self)
            for m in self.measure_props:
                if hasattr(m, "sample_state") and done % m.interval == 0:
                    m.sample_state(self, state, self.global_step)
            if mc is not None and done % mc.num_steps_md == 0:
                # the types move, the geometry not: the cache stays valid
                state = self._mc_block(mc, mc_trials, state, done, n_steps)
            for prop in self.properties:
                if done % prop.interval == 0:
                    prop.process(self, state, self.global_step)
                    state = self.state  # processors may replace it
                    if prop.mutates_state and cache is not None:
                        # atoms switched on or moved: fresh lists for the
                        # next force pass
                        fresh = self.ff.refresh_cache(state)
                        cache = fresh._replace(
                            peak=torch.maximum(cache.peak, fresh.peak))
        if state.position.is_cuda:
            torch.cuda.synchronize()
        wall = time.time() - t0
        self.run_seconds.append(wall)
        self.log(f"Speed of this run = "
                 f"{self._n * n_steps / max(wall, 1e-9):.5g} atom*step/second")
        if isinstance(aux, dict) and "t_e" in aux:  # a TTM run
            self._write_ttm(getattr(ens, "inner", ens), aux)
        if is_ti and ens.yaml_name:
            summary = ens.free_energy(state, aux)
            fy = self._file(ens.yaml_name)
            for key, val in summary.items():
                fy.write(f"{key}: {val:f}\n")
            fy.flush()
            self.log(f"{type(ens).__name__}: F = {summary['F']:.6f} eV/atom "
                     f"(G {summary['G']:.6f})")
        self._finish_run()

    def _run_pimd(self, n_steps):
        """A PIMD/RPMD/TRPMD block (ref: run.cu:222-246 bead loop), the
        beads a leading tensor axis (integrate/pimd.py), in chunks of the
        dump_beads interval (else of at most MAX_CHUNK steps); a chunk's
        end reads the bead temperatures, energies and the deepest
        neighbour row of every bead's lists at once.  The T1 -> T2 ramp
        runs across the whole block, chunks and all.  The centroid is
        folded back into the classical state."""
        mode, nbeads, t, tc, t_end = self.ensemble
        beads_cfg = self._dump_beads
        if beads_cfg is not None:
            chunk = beads_cfg[0]
            if n_steps % chunk:
                raise ValueError(f"dump_beads: the interval {chunk} does not "
                                 f"divide the run's {n_steps} steps")
        else:
            chunk = _bounded_chunk(n_steps, n_steps)
        runner = PIMDRunner(ff=self.ff, base=self.state, n_beads=nbeads,
                            temperature=t, coupling=tc, mode=mode)
        cap = self.ff.neighbor.mn
        st = runner.init(seed=7)
        t0 = time.time()
        obs = {"t_beads": [], "pe": []}
        done = 0
        while done < n_steps:
            st, o = runner.run(st, self.dt, chunk, t_end=t_end, first=done,
                               total=n_steps)
            done += chunk
            row = torch.cat([o["t_beads"], o["pe"],
                             st.max_count[None].to(o["pe"].dtype)]
                            ).to(torch.float64).cpu().numpy()
            self._check_capacity(int(row[-1]), cap,
                                 f"by step {self.global_step + done}")
            if not np.all(np.isfinite(row)):
                raise RuntimeError(f"non-finite bead observables at step "
                                   f"{self.global_step + done}")
            obs["t_beads"].append(row[:chunk])
            obs["pe"].append(row[chunk:2 * chunk])
            if beads_cfg is not None:
                self._write_beads(st, nbeads, beads_cfg[1], beads_cfg[2],
                                  (self.global_step + done) * self.dt)
        if st.position.is_cuda:
            torch.cuda.synchronize()
        wall = time.time() - t0
        self.run_seconds.append(wall)
        self.global_step += n_steps
        self.state = runner.centroid(st)
        self._pimd_obs = {k: np.concatenate(v) for k, v in obs.items()}
        rate = self._n * n_steps * nbeads / max(wall, 1e-9)
        self.log(f"PIMD({mode}, {nbeads} beads): bead-T "
                 f"{float(self._pimd_obs['t_beads'][-1]):.1f} K; "
                 f"Speed of this run = {rate:.5g} atom*step/second")

    def kw_dump_beads(self, args):
        """dump_beads interval has_velocity has_force -> beads_dump_<k>.xyz
        a bead (ref: dump_beads.cu:36-90)."""
        self._dump_beads = (int(args[0]), bool(int(args[1])),
                            bool(int(args[2])))
        self.log(f"dump_beads {args}")

    def _write_beads(self, st, nbeads, has_vel, has_force, time_nat):
        """One frame a bead file: positions as integrated (unwrapped),
        velocities in natural units, the JAX app's header and digits."""
        mask = _np(self.state.mask) > 0
        h = _np(self.box.h)
        pbc = " ".join("T" if p else "F" for p in _np(self.box.pbc) > 0)
        lat = " ".join(f"{h[i, j]:.8f}" for j in range(3) for i in range(3))
        props = "species:S:1:pos:R:3"
        if has_vel:
            props += ":vel:R:3"
        if has_force:
            props += ":forces:R:3"
        pos_all = _np(st.position)
        vel_all = _np(st.velocity) if has_vel else None
        frc_all = _np(st.force) if has_force else None
        symbols = np.asarray(self.symbols)[mask]
        for k in range(nbeads):
            f = self._file(f"beads_dump_{k}.xyz")
            cols = [pos_all[k][mask]]
            if has_vel:
                cols.append(vel_all[k][mask])
            if has_force:
                cols.append(frc_all[k][mask])
            vals = np.concatenate(cols, axis=1)
            f.write(f"{int(mask.sum())}\n")
            f.write(f"Time={time_nat * TIME_UNIT_CONVERSION:.8f} "
                    f'pbc="{pbc}" Lattice="{lat}" Properties={props}\n')
            for sym, v in zip(symbols, vals):
                f.write(sym + "".join(f" {x:.8f}" for x in v) + "\n")
            f.flush()

    def _write_ttm(self, ens, aux):
        """ttm_electron_temperature.out, overwritten at a run's end
        (ref: ttm_electron_temperature_out.rst, ensemble_ttm.cu)."""
        nx, ny, nz = ens.grid
        te = _np(aux["t_e"]).reshape(nz, ny, nx)
        with open(os.path.join(self.workdir,
                               "ttm_electron_temperature.out"), "w") as f:
            f.write("# electron temperature snapshots for TTM\n")
            f.write(f"# nx {nx} ny {ny} nz {nz}\n")
            f.write(f"# output_interval {ens.out_interval} step(s)\n")
            f.write("# columns: ix iy iz T_e[K]\n")
            f.write(f"# step {self.global_step}\n")
            for iz in range(nz):
                for iy in range(ny):
                    for ix in range(nx):
                        f.write(f"{ix} {iy} {iz} {te[iz, iy, ix]:.6f}\n")

    # ------------------------------------------------------- measure keywords

    def _ensemble_temperature(self) -> float:
        ens = self.ensemble
        if ens is not None and hasattr(ens, "t1"):
            return float(ens.t1)
        return 300.0

    def kw_compute_hac(self, args):
        self.measure_props.append(
            HAC(int(args[0]), int(args[1]), int(args[2]), self.dt,
                self._ensemble_temperature()))
        self.log(f"compute_hac {args}")

    def kw_compute_hnemd(self, args):
        self._require_state()
        fe = (float(args[1]), float(args[2]), float(args[3]))
        self.ff = dataclasses.replace(self.ff, hnemd_fe=fe)
        self.measure_props.append(
            HNEMDKappa(int(args[0]), fe, self.dt,
                       self._ensemble_temperature()))
        self.log(f"compute_hnemd {args}")

    def kw_compute_shc(self, args):
        group_mask = None
        if len(args) >= 8 and args[5] == "group":
            method, gid = int(args[6]), int(args[7])
            group_mask = self.groups.labels[:, method] == gid
        self.measure_props.append(
            SHC(int(args[0]), int(args[1]), int(args[2]), int(args[3]),
                float(args[4]), self.dt, group_mask=group_mask))
        self.log(f"compute_shc {args}")

    def kw_compute_msd(self, args):
        self.measure_props.append(MSD(int(args[0]), int(args[1]), self.dt))
        self.log(f"compute_msd {args}")

    def kw_compute_sdc(self, args):
        self.measure_props.append(SDC(int(args[0]), int(args[1]), self.dt))
        self.log(f"compute_sdc {args}")

    def kw_compute_dos(self, args):
        num_points = None
        if "num_dos_points" in args:
            num_points = int(args[args.index("num_dos_points") + 1])
        self.measure_props.append(
            DOS(int(args[0]), int(args[1]), float(args[2]), self.dt,
                num_points=num_points))
        self.log(f"compute_dos {args}")

    def kw_compute_ic(self, args):
        """compute_ic sample_int Nc type charge -> ic.out
        (ref: iron_conductivity.cu)."""
        self.measure_props.append(
            IonicConductivity(int(args[0]), int(args[1]), int(args[2]),
                              float(args[3]), self.dt,
                              self._ensemble_temperature()))
        self.log(f"compute_ic {args}")

    def kw_compute_viscosity(self, args):
        self.measure_props.append(
            Viscosity(int(args[0]), int(args[1]), self.dt,
                      self._ensemble_temperature()))
        self.log(f"compute_viscosity {args}")

    def kw_compute_hnemdec(self, args):
        """compute_hnemdec <mode> <output_interval> fe_x fe_y fe_z ->
        onsager.out (ref: hnemdec_kappa.cu:252-280, force.cu:355-422).
        mode 0 = heat flow; mode k in [1, num_types] = color flow of
        species k-1."""
        self._require_state()
        mode = int(args[0])
        interval = int(args[1])
        fe = (float(args[2]), float(args[3]), float(args[4]))
        num_types = max(1, len(self.type_names))
        if not 0 <= mode <= num_types:
            raise ValueError(f"compute_hnemdec: mode {mode} out of range")
        t = self._ensemble_temperature()
        coef, mass_type, factor = hnemdec_coefficients(
            mode, _np(self.state.mass), _np(self.state.type), num_types)
        if mode == 0:
            coef = tuple(c * (K_B * t) if i % 2 == 1 else c
                         for i, c in enumerate(coef))
        self.ff = dataclasses.replace(self.ff, hnemdec_mode=mode,
                                      hnemdec_fe=fe, hnemdec_coef=coef)
        prop = HNEMDECOnsager(mode, interval, fe, t, num_types, factor)
        prop.mass_type = mass_type
        self.measure_props.append(prop)
        self.log(f"compute_hnemdec {args}")

    def _modal_binning(self, args, what):
        if args[0] == "bin_size":
            return {"bin_size": int(args[1])}
        if args[0] == "f_bin_size":
            return {"f_bin_size": float(args[1])}
        raise ValueError(f"{what}: invalid binning keyword")

    def kw_compute_gkma(self, args):
        """compute_gkma sample_int first_mode last_mode bin_size|f_bin_size x
        -> heatmode.out (ref: modal_analysis.cu:650-748)."""
        self.measure_props.append(ModalAnalysis(
            "gkma", int(args[0]), int(args[1]), int(args[2]),
            eig_path=os.path.join(self.workdir, "eigenvector.in"),
            **self._modal_binning(args[3:5], "compute_gkma")))
        self.log(f"compute_gkma {args}")

    def kw_compute_hnema(self, args):
        """compute_hnema sample_int output_int fe_x fe_y fe_z first last
        bin_size|f_bin_size x -> kappamode.out; also applies the HNEMD
        driving force (ref: modal_analysis.cu:751-830)."""
        self._require_state()
        fe_vec = (float(args[2]), float(args[3]), float(args[4]))
        self.ff = dataclasses.replace(self.ff, hnemd_fe=fe_vec)
        self.measure_props.append(ModalAnalysis(
            "hnema", int(args[0]), int(args[5]), int(args[6]),
            output_interval=int(args[1]),
            fe=math.sqrt(sum(x * x for x in fe_vec)),
            temperature=self._ensemble_temperature(),
            eig_path=os.path.join(self.workdir, "eigenvector.in"),
            **self._modal_binning(args[7:9], "compute_hnema")))
        self.log(f"compute_hnema {args}")

    def kw_compute_rdf(self, args):
        self.measure_props.append(RDF(
            float(args[0]), int(args[1]), int(args[2]),
            num_types=max(1, len(self.type_names)),
            type_names=self.type_names))
        self.log(f"compute_rdf {args}")

    def kw_compute_angular_rdf(self, args):
        """compute_angular_rdf r_cut r_bins theta_bins interval
        [atom_a atom_b]... -> angular_rdf.out
        (ref: angular_rdf.cu:440-520 parse)."""
        pairs = [(int(args[i]), int(args[i + 1]))
                 for i in range(4, len(args), 2)]
        self.measure_props.append(AngularRDF(
            float(args[0]), int(args[1]), int(args[2]), int(args[3]), pairs))
        self.log(f"compute_angular_rdf {args}")

    def kw_compute_adf(self, args):
        """compute_adf interval bins rc_min rc_max (global) or
        compute_adf interval bins (i j k rcminj rcmaxj rcmink rcmaxk)xM
        (ref: adf.cu:371-460)."""
        if len(args) == 4:
            prop = ADF(int(args[0]), int(args[1]), rc_min=float(args[2]),
                       rc_max=float(args[3]))
        elif len(args) > 4 and (len(args) - 2) % 7 == 0:
            rest = args[2:]
            triples = [
                (int(t[0]), int(t[1]), int(t[2]), float(t[3]), float(t[4]),
                 float(t[5]), float(t[6]))
                for t in (rest[7 * m:7 * m + 7]
                          for m in range(len(rest) // 7))]
            prop = ADF(int(args[0]), int(args[1]), triples=triples)
        else:
            raise ValueError(
                "compute_adf needs 4 parameters or 2 + 7*Ntriples")
        self.measure_props.append(prop)
        self.log(f"compute_adf {args}")

    def kw_compute_orientorder(self, args):
        """compute_orientorder <interval> cutoff rc|nnn n <ndeg> l...
        [average] [wl] [wlhat] (ref: orientorder.cu:795-860)."""
        interval = int(args[0])
        mode = args[1]
        if mode not in ("cutoff", "nnn"):
            raise ValueError("compute_orientorder mode must be cutoff or nnn")
        mode_param = float(args[2]) if mode == "cutoff" else int(args[2])
        ndeg = int(args[3])
        degrees = [int(x) for x in args[4:4 + ndeg]]
        flags = [bool(int(x)) for x in args[4 + ndeg:]] + [False] * 3
        self.measure_props.append(OrientOrder(
            interval, mode, mode_param, degrees, average=flags[0],
            wl=flags[1], wlhat=flags[2]))
        self.log(f"compute_orientorder {args}")

    def kw_compute(self, args):
        """compute <method> <sample_int> <output_int> temperature|potential|
        force|virial|jp|jk|momentum ... -> compute.out.

        Column layout as the reference (ref: compute.cu:369-560): the
        quantity order is fixed (T, U, F, W, jp, jk, p) whatever the
        keyword order; per quantity one column a group.  All columns are
        group sums time-averaged over the output window, except temperature,
        a per-atom average; with temperature the two cumulative bath
        energies (source, sink) follow, the NEMD heat-flux measurement:
        the ensemble's aux["e_transfer"] (the heat_* ensembles; zero under
        the others).  A sample's sums run in float64 on the state's device;
        the rows reach the host at output."""
        method = int(args[0])
        sample_interval = int(args[1])
        output_interval = int(args[2])
        quantities = set(args[3:])
        known = {"temperature", "potential", "force", "virial", "jp", "jk",
                 "momentum"}
        bad = quantities - known
        if bad:
            raise ValueError(f"compute: unknown quantities {sorted(bad)}")
        f64 = torch.float64
        onehot = self.groups.onehot(method, dtype=f64, device=self.device)
        kt_denom = torch.as_tensor(
            3.0 * np.maximum(self.groups.sizes(method), 1) * K_B, dtype=f64,
            device=self.device)
        rows = []
        f = self._file("compute.out")

        def process(session, state, step):
            v, mass = state.velocity.to(f64), state.mass.to(f64)
            ek2 = mass * torch.sum(v ** 2, dim=-1)
            cols = []
            if "temperature" in quantities:
                cols.append((ek2 @ onehot) / kt_denom)
            if "potential" in quantities:
                cols.append(state.potential_energy.to(f64) @ onehot)
            if "force" in quantities:
                cols.append(state.force.to(f64).T @ onehot)
            w = state.virial.to(f64)
            if "virial" in quantities:  # (N, 3, 3) row-major
                cols.append(w.reshape(-1, 9).T @ onehot)
            if "jp" in quantities:
                cols.append(torch.einsum("nab,nb->na", w, v).T @ onehot)
            if "jk" in quantities:
                e = 0.5 * ek2 + state.potential_energy.to(f64)
                cols.append((v * e[:, None]).T @ onehot)
            if "momentum" in quantities:
                cols.append((mass[:, None] * v).T @ onehot)
            rows.append(torch.cat([c.reshape(-1) for c in cols]))
            if len(rows) % max(output_interval // sample_interval, 1) == 0:
                out = list(_np(torch.stack(rows).mean(dim=0)))
                if "temperature" in quantities:
                    # the heat baths' cumulative energies (source, sink)
                    aux = session._ens_aux
                    et = (_np(aux["e_transfer"]) if isinstance(aux, dict)
                          and "e_transfer" in aux else np.zeros(2))
                    out += [float(et[0]), float(et[1])]
                f.write("".join(f"{x:15.6e}" for x in out) + "\n")
                f.flush()
                rows.clear()

        self.properties.append(PropertyRequest(
            sample_interval, process,
            needs_atom_virial=bool({"virial", "jp"} & quantities)))
        self.log(f"compute: method {method} {sorted(quantities)}")

    def kw_compute_chunk(self, args):
        """compute_chunk sample_int output_int bin/1d|2d|3d (axis lower
        delta)... props... -> compute_chunk.out
        (ref: compute_chunk.cu:147-350).

        Row format per chunk per output: chunk_id coord(s) count props...
        Temperature from per-chunk kinetic energy; density/number uses the
        chunk volume; velocities/forces are per-atom chunk averages.  The
        bins and their float64 sums stay on the state's device until an
        output."""
        sample_interval = int(args[0])
        output_interval = int(args[1])
        ndim = {"bin/1d": 1, "bin/2d": 2, "bin/3d": 3}[args[2]]
        vol = float(self.box.volume)
        thick = self.box.thickness().tolist()
        axes, deltas, nlayers, box_len = [], [], [], []
        i = 3
        for _ in range(ndim):
            ax = {"x": 0, "y": 1, "z": 2}[args[i]]
            if args[i + 1] != "lower":
                raise ValueError("compute_chunk: origin must be lower")
            delta = float(args[i + 2])
            axes.append(ax)
            deltas.append(delta)
            box_len.append(thick[ax])
            nlayers.append(max(int(np.ceil(thick[ax] / delta)), 1))
            i += 3
        props = list(args[i:])
        known = ("temperature", "density/number", "density/mass",
                 "vx", "vy", "vz", "fx", "fy", "fz")
        for p in props:
            if p not in known:
                raise ValueError(f"compute_chunk: invalid property {p!r}")
        nchunk = int(np.prod(nlayers))

        def bin_width(d, k):
            rem = box_len[d] - (nlayers[d] - 1) * deltas[d]
            return deltas[d] if k < nlayers[d] - 1 else rem

        def bin_center(d, k):
            if k < nlayers[d] - 1:
                return (k + 0.5) * deltas[d]
            rem = box_len[d] - (nlayers[d] - 1) * deltas[d]
            return (nlayers[d] - 1) * deltas[d] + rem * 0.5

        # chunk volumes + centers, reference ordering (fastest axis first)
        volumes = np.zeros(nchunk)
        coords = np.zeros((nchunk, ndim))
        for c, combo in enumerate(itertools.product(
                *reversed([range(nl) for nl in nlayers]))):
            combo = tuple(reversed(combo))  # (i0, i1, i2) fastest first
            if ndim == 1:
                w = (vol / box_len[0]) * bin_width(0, combo[0])
            elif ndim == 2:
                third = 3 - axes[0] - axes[1]
                w = (bin_width(0, combo[0]) * bin_width(1, combo[1])
                     * thick[third])
            else:
                w = np.prod([bin_width(d, combo[d]) for d in range(3)])
            volumes[c] = w
            coords[c] = [bin_center(d, combo[d]) for d in range(ndim)]

        f64 = torch.float64
        count = torch.zeros(nchunk + 1, dtype=f64, device=self.device)
        sums = torch.zeros((len(props), nchunk + 1), dtype=f64,
                           device=self.device)
        samples = [0]
        fout = self._file("compute_chunk.out")

        def process(session, state, step):
            # bins from float64 positions and box, as the reference bins
            # its doubles: a float32 run's quotient within rounding of a
            # bin edge would round across it
            h = state.box.h.to(f64)
            box = Box(h=h, h_inv=inv3(h), pbc=state.box.pbc.to(f64))
            pos = box.wrap(state.position.to(f64))
            mask = state.mask > 0
            bins = torch.zeros(pos.shape[0], dtype=torch.int64,
                               device=pos.device)
            mult = 1
            for d in range(ndim):
                b = (pos[:, axes[d]] / deltas[d]).to(torch.int64)
                bins += torch.clamp(b, 0, nlayers[d] - 1) * mult
                mult *= nlayers[d]
            bins = torch.where(mask, bins, nchunk)  # padding: overflow bin
            count.add_(torch.bincount(bins, minlength=nchunk + 1))
            v, m = state.velocity.to(f64), state.mass.to(f64)
            for j, p in enumerate(props):
                if p == "temperature":
                    val = 0.5 * m * torch.sum(v ** 2, dim=-1)
                elif p == "density/number":
                    val = torch.ones_like(m)
                elif p == "density/mass":
                    val = m
                elif p[0] == "v":
                    val = v[:, "xyz".index(p[1])]
                else:
                    val = state.force[:, "xyz".index(p[1])].to(f64)
                sums[j].add_(torch.bincount(bins, weights=val * mask,
                                            minlength=nchunk + 1))
            samples[0] += 1
            if samples[0] % output_interval:
                return
            ns = samples[0]
            cnts = _np(count)[:nchunk] / ns
            vals = _np(sums)[:, :nchunk] / ns
            for c in range(nchunk):
                cnt = cnts[c]
                row = [f"{c} "] + [f"{coords[c][d]:.6f} "
                                   for d in range(ndim)]
                row.append(f"{cnt:.1f} ")
                for j, p in enumerate(props):
                    s = vals[j, c]
                    if p == "temperature":
                        t = (2.0 * s / (K_B * 3.0 * cnt)) if cnt > 0 else 0.0
                        row.append(f"{t:.10e} ")
                    elif p == "density/number":
                        row.append(f"{cnt / volumes[c]:.10e} ")
                    elif p == "density/mass":
                        row.append(f"{s / volumes[c]:.10e} ")
                    else:
                        row.append(f"{s / cnt if cnt > 0 else 0.0:.10e} ")
                fout.write("".join(row) + "\n")
            fout.flush()
            count.zero_()
            sums.zero_()
            samples[0] = 0

        self.properties.append(PropertyRequest(sample_interval, process))
        self.log(f"compute_chunk {args}")

    # ------------------------------------------------ D3, k-space, qNEP

    def kw_dftd3(self, args):
        """dftd3 <functional> rc_potential rc_cn: the D3(BJ) dispersion
        term added to the loaded potential (ref: nep.cu:45-73 scans run.in
        for it; here a keyword of its own, as in the JAX app)."""
        if self.ff is None:
            raise ValueError("dftd3 must come after the potential keyword")
        self.potentials.append(DFTD3.create(
            args[0], float(args[1]), float(args[2]), self.type_names,
            dtype=self.dtype, device=self.device))
        self._rebuild_ff()
        self.log(f"dftd3 {args}")

    def kw_kspace(self, args):
        """kspace ewald|pppm: qNEP's k-space method, for a charge model
        loaded before or after (ref: nep_charge.cu:46-75)."""
        method = args[0]
        if method not in ("ewald", "pppm"):
            raise ValueError("kspace method can only be ewald or pppm")
        self._kspace_method = method
        self.potentials = [p._replace(kspace_method=method)
                           if isinstance(p, NEPCharge) else p
                           for p in self.potentials]
        if self.ff is not None:
            self.ff = dataclasses.replace(
                self.ff, potentials=tuple(self.driving_potentials()))
        self.log(f"kspace {method}")

    def _charge_model(self, what: str) -> NEPCharge:
        pot = next((p for p in self.potentials if isinstance(p, NEPCharge)),
                   None)
        if pot is None:
            raise ValueError(f"{what} needs a NEP-Charge model")
        return pot

    def _fresh_list(self, state):
        """(state with wrapped positions, a fresh neighbour list)."""
        pos = state.box.wrap(state.position)
        return (state._replace(position=pos),
                self.ff.neighbor.build(pos, state.box, state.mask))

    def kw_compute_dpdt(self, args):
        """compute_dpdt sample_interval -> dpdt.out: dP/dt = sum_i Z*_i v_i
        and its running integral, the polarization (ref: compute_dpdt.cu;
        the Born charges of the qNEP model)."""
        interval = int(args[0])
        pot = self._charge_model("compute_dpdt")
        f = self._file("dpdt.out")
        f.write(f"# compute_dpdt {interval}\n# format_version 1\n")
        f.write(f"# num_atoms {self._n}\n")
        f.write(f"# dt_output "
                f"{self.dt * interval * TIME_UNIT_CONVERSION:.10e} fs\n")
        f.write("# columns time_fs dpdt_x dpdt_y dpdt_z P_x P_y P_z\n")
        acc = {"P": np.zeros(3)}

        def process(session, state, step):
            with torch.no_grad():
                bec = pot.born_effective_charges(state,
                                                 self._fresh_list(state)[1])
                dp = _np(torch.einsum("nab,nb->a", bec, state.velocity
                                      * state.mask[:, None]))
            acc["P"] += dp * self.dt * interval
            row = [step * self.dt * TIME_UNIT_CONVERSION, *dp, *acc["P"]]
            f.write(" ".join(f"{x:.10e}" for x in row) + "\n")
            f.flush()

        self.properties.append(PropertyRequest(interval, process))
        self.log(f"compute_dpdt {args}")

    def kw_compute_es(self, args):
        """compute_es sample_interval -> elactrostatic_force.out and
        elactrostatic_energy.out (the reference's file names, typo and
        all; ref: compute_es.cu): the full qNEP output minus its
        short-range NEP + ZBL part, so the charge chain is included."""
        interval = int(args[0])
        pot = self._charge_model("compute_es")
        ff_out = self._file("elactrostatic_force.out")
        fe_out = self._file("elactrostatic_energy.out")

        def process(session, state, step):
            st, nbr = self._fresh_list(state)
            m = st.mask
            full = pot.compute_with_state(st, nbr)
            t2 = st.type[nbr.idx.long()]
            with torch.enable_grad():
                r12 = nbr.r12.detach().requires_grad_(True)
                e_s, _ = pot.energy_and_charge(r12, st.type, t2)
                (p,) = torch.autograd.grad(torch.sum(e_s * m), r12)
            recv = _scatter_rows(p.reshape(-1, 3), nbr.idx, p.shape[0])
            f_es = full.force - (torch.sum(p, dim=1) - recv) * m[:, None]
            e_es = torch.sum((full.energy - e_s.detach()) * m)
            f_np = _np(f_es)[_np(m) > 0]
            for r in f_np:
                ff_out.write(f"{r[0]:16.8e}{r[1]:16.8e}{r[2]:16.8e}\n")
            fe_out.write(f"{float(e_es):16.8e}\n")
            ff_out.flush()
            fe_out.flush()

        self.properties.append(PropertyRequest(interval, process))
        self.log(f"compute_es {args}")

    # ------------------------------------------- observers and TNEP outputs

    def kw_dump_observer(self, args):
        """dump_observer observe|average thermo_int exyz_int has_vel
        has_force (ref: dump_observer.cu:81-130): every model of the
        `potential` lines evaluated on the trajectory, observer<k>.out
        thermo rows and observer<k>.xyz frames (a committee's disagreement
        for active learning); average mode drives with the models' mean
        and writes nothing of its own.  After a compact-engine chunk each
        model that `_observer_spec` takes runs on the kernels with the
        driving model's plan and lists; the others on the list path."""
        mode = args[0]
        if mode not in ("observe", "average"):
            raise ValueError("observer mode should be 'observe' or 'average'")
        self.observer_mode = mode
        self._rebuild_ff()
        int_thermo, int_exyz = int(args[1]), int(args[2])
        with_vel, with_force = args[3] == "1", args[4] == "1"
        if mode == "average":
            self.log("dump_observer: average mode (forces averaged)")
            return
        files = {}

        def process(session, state, step):
            for k, pot in enumerate(session.observer_models()):
                out = session._observe(k, pot, state)
                name = f"observer{k}.out"
                if name not in files:
                    files[name] = session._file(name)
                files[name].write("".join(f"{x:20.10e}"
                                          for x in thermo_row(out)) + "\n")
                files[name].flush()

        def process_exyz(session, state, step):
            n = session._n
            for k, pot in enumerate(session.observer_models()):
                out = session._observe(k, pot, state)
                write_xyz(
                    os.path.join(session.workdir, f"observer{k}.xyz"),
                    XYZFrame(symbols=session.symbols,
                             positions=_np(state.box.wrap(state.position))[:n],
                             lattice=_np(state.box.h).T, pbc=session.frame.pbc,
                             velocities=(_np(state.velocity)[:n]
                                         / TIME_UNIT_CONVERSION
                                         if with_vel else None),
                             forces=(_np(out.force)[:n] if with_force
                                     else None)),
                    append=True, with_velocities=with_vel,
                    with_forces=with_force)

        self.properties.append(PropertyRequest(int_thermo, process))
        self.properties.append(PropertyRequest(int_exyz, process_exyz))
        self.log(f"dump_observer {args}")

    def _observer_spec(self, k: int, pot) -> Optional[CompactSpec]:
        """The compact spec on which observer model k rides the driving
        model's plan and lists, or None; decided once a model.  It rides
        them when it is a NEP the compact engine takes, of the driving
        model's species, with cutoffs no larger than its: its cutoff
        functions zero what lies beyond its own cutoffs, and the driving
        model's rc + skin lists hold every pair it can see (ref:
        dump_observer.cu:29-80, one neighbour pass for every model).  A
        committee (one architecture, other weights) always qualifies."""
        if k not in self._observer_specs:
            self._observer_specs[k] = self._compact_spec(pot)
        return self._observer_specs[k]

    def _compact_spec(self, pot) -> Optional[CompactSpec]:
        drv = self.driving_potentials()[0]
        if not (isinstance(pot, NEP) and isinstance(drv, NEP)):
            return None
        if pot.model.model_type == 3 and pot.temperature is None:
            return None
        if not (tuple(pot.model.symbols) == tuple(drv.model.symbols)
                and pot.model.rc_radial_max
                <= drv.model.rc_radial_max + 1e-9
                and pot.model.rc_angular_max
                <= drv.model.rc_angular_max + 1e-9):
            return None
        try:
            return CompactSpec.from_model(pot.model, pot.params)
        except NotImplementedError:
            return None

    def _observe(self, k: int, pot, state: MDState) -> MDState:
        """`state` with the forces, energies and virials of observer model
        k: on the kernels through the last compact chunk's plan and lists
        where _observer_spec takes the model (the total virial on atom 0,
        what the thermo row reads), else on a fresh list (at the model's
        own cutoff where it lies past the plan's)."""
        ctx = self._dense_eval_ctx
        spec = None if ctx is None else self._observer_spec(k, pot)
        if spec is None:
            with torch.no_grad():
                return self.ff._evaluate_with(state, pot)
        md, carry = ctx
        c = carry.state
        with torch.no_grad():
            out = compact_nep_compute(
                c.position, c.type, c.mask, c.box, md.cplan, carry.idx,
                pot.model, pot.params, per_atom_virial=False,
                temperature=pot.temperature, spec=spec,
                plain=md.plain)
        self.observer_compact_evals += 1
        n = self._n
        oid = carry.orig_id
        valid = oid < n
        inv = torch.zeros(n, dtype=torch.int64, device=oid.device)
        inv[oid[valid]] = torch.nonzero(valid)[:, 0]
        w = torch.zeros_like(state.virial)
        w[0] = out.virial_total
        return state._replace(force=out.force[inv],
                              potential_energy=out.energy[inv] * state.mask,
                              virial=w,
                              heat_current=torch.zeros_like(state.force))

    def kw_active(self, args):
        """active check_interval has_velocity has_force has_uncertainty
        threshold (ref: active.cu:118-170): the force uncertainty of the
        loaded committee, sqrt of the per-atom population variance summed
        over x, y, z; its largest value into active.out every check, and
        the frame into active.xyz above the threshold.  has_uncertainty is
        read and not used, as in the JAX app."""
        interval = int(args[0])
        with_vel, with_force = args[1] == "1", args[2] == "1"
        threshold = float(args[4])
        if len(self.observer_models()) < 2:
            raise ValueError("active learning needs >= 2 potentials")
        f = self._file("active.out")

        def process(session, state, step):
            n = session._n
            with torch.no_grad():
                forces = torch.stack([
                    session.ff._evaluate_with(state, pot).force[:n]
                    for pot in session.observer_models()]).to(torch.float64)
            unc = torch.sqrt(torch.sum(torch.var(forces, dim=0,
                                                 unbiased=False), dim=-1))
            max_unc = float(torch.max(unc))
            if max_unc > threshold:
                write_xyz(
                    os.path.join(session.workdir, "active.xyz"),
                    XYZFrame(symbols=session.symbols,
                             positions=_np(state.box.wrap(state.position))[:n],
                             lattice=_np(state.box.h).T, pbc=session.frame.pbc,
                             velocities=(_np(state.velocity)[:n]
                                         / TIME_UNIT_CONVERSION
                                         if with_vel else None),
                             forces=_np(forces[0]) if with_force else None),
                    append=True, with_velocities=with_vel,
                    with_forces=with_force,
                    extra_info={"uncertainty": f"{max_unc:.6f}"})
            f.write(f"{step} {max_unc:g}\n")
            f.flush()

        self.properties.append(PropertyRequest(interval, process))
        self.log(f"active {args}")

    def kw_compute_extrapolation(self, args):
        """compute_extrapolation asi_file <f> gamma_low x gamma_high x
        [check_interval n] [dump_interval n] -> extrapolation_dump.xyz
        (ref: extrapolation.cu:44-240): gamma_i = max |ASI[type_i] B_i|,
        B_i atom i's gradient of its energy by its element's ANN
        parameters (NEP.b_projection); a structure with max gamma at or
        above gamma_low is dumped (at most once a dump_interval), one
        above gamma_high is dumped and ends the run."""
        kw = {"check_interval": 1, "dump_interval": 1, "gamma_low": 0.0,
              "gamma_high": 1e100}
        asi_file = None
        for key, val in _pairs(args, "compute_extrapolation"):
            if key == "asi_file":
                asi_file = val
            elif key in ("gamma_low", "gamma_high"):
                kw[key] = float(val)
            elif key in ("check_interval", "dump_interval"):
                kw[key] = int(val)
            else:
                raise ValueError(f"compute_extrapolation: bad token {key!r}")
        if asi_file is None:
            raise ValueError("compute_extrapolation needs asi_file")
        nep = self.ff.potentials[0]
        if not hasattr(nep, "b_projection"):
            raise ValueError("compute_extrapolation requires a NEP potential")
        bsize = nep.model.neurons * (nep.model.dim + 2)
        # blocks "Element shape1 shape2 <shape1 * shape2 numbers>"
        with open(os.path.join(self.workdir, asi_file)) as fa:
            toks = fa.read().split()
        asi = np.zeros((len(self.type_names), bsize, bsize))
        p = 0
        while p < len(toks):
            s1, s2 = int(toks[p + 1]), int(toks[p + 2])
            if (s1, s2) != (bsize, bsize):
                raise ValueError(f"ASI for {toks[p]}: shape {(s1, s2)} != "
                                 f"({bsize},{bsize})")
            asi[self.type_names.index(toks[p])] = np.asarray(
                toks[p + 3:p + 3 + s1 * s2], np.float64).reshape(s1, s2)
            p += 3 + s1 * s2
        # the matrices in float32, as the JAX app holds them
        asi_t = torch.as_tensor(asi.astype(np.float32), dtype=self.dtype,
                                device=self.device)
        last = {"dump": -(10 ** 9)}
        fdump = self._file("extrapolation_dump.xyz")

        def gamma_of(session, state):
            st, nbr = session._fresh_list(state)
            typ = st.type.long()
            b = nep.b_projection(nbr.r12, st.type, st.type[nbr.idx.long()])
            g = torch.zeros_like(b)
            for t in range(asi_t.shape[0]):
                g = g + (b @ asi_t[t].T) * (typ == t)[:, None]
            return torch.amax(torch.abs(g), dim=-1) * st.mask

        def process(session, state, step):
            with torch.no_grad():
                gamma = _np(gamma_of(session, state))
            mg = float(gamma.max())
            if mg >= kw["gamma_low"] and (
                    step == 0 or step - last["dump"] >= kw["dump_interval"]):
                last["dump"] = step
                session._dump_gamma(fdump, state, gamma, mg)
            if mg > kw["gamma_high"]:
                session._dump_gamma(fdump, state, gamma, mg)
                raise RuntimeError(
                    f"extrapolation grade {mg:.4f} exceeds gamma_high at "
                    f"step {step}; terminating (ref: extrapolation.cu:207)")

        self.properties.append(PropertyRequest(kw["check_interval"], process))
        self.log(f"compute_extrapolation {args}")

    def _dump_gamma(self, f, state, gamma, max_gamma):
        mask = _np(state.mask) > 0
        pos = _np(state.position)[mask]
        types = _np(state.type).astype(np.int64)[mask]
        h = _np(state.box.h)
        pbc = " ".join("T" if p else "F" for p in _np(state.box.pbc) > 0)
        lat = " ".join(f"{h[i, j]:.8f}" for j in range(3) for i in range(3))
        f.write(f"{int(mask.sum())}\n")
        f.write(f'max_gamma={max_gamma:.8f} pbc="{pbc}" Lattice="{lat}" '
                "Properties=species:S:1:pos:R:3:gamma:R:1\n")
        for t, r, g in zip(types, pos, gamma[mask]):
            f.write(f"{self.type_names[t]} {r[0]:.8f} {r[1]:.8f} "
                    f"{r[2]:.8f} {g:8f}\n")
        f.flush()

    def _tnep(self, model_type: int, what: str):
        pot = next((p for p in self.potentials
                    if getattr(getattr(p, "model", None), "model_type", 0)
                    == model_type), None)
        if pot is None:
            raise ValueError(what)
        return pot

    def kw_dump_dipole(self, args):
        """dump_dipole interval -> dipole.out: the loaded *_dipole model's
        global dipole on the trajectory (ref: dump_dipole.cu)."""
        interval = int(args[0])
        tnep = self._tnep(1, "dump_dipole needs a loaded *_dipole potential")
        f = self._file("dipole.out")

        def process(session, state, step):
            st, nbr = session._fresh_list(state)
            mu = _np(tnep.dipole(st.type, nbr, st.mask))
            f.write(f"{step}" + "".join(f"{x:20.10e}" for x in mu) + "\n")
            f.flush()

        self.properties.append(PropertyRequest(interval, process))
        self.log(f"dump_dipole every {interval}")

    def kw_dump_polarizability(self, args):
        """dump_polarizability interval -> polarizability.out: the loaded
        *_polarizability model's tensor, xx yy zz xy yz xz
        (ref: dump_polarizability.cu)."""
        interval = int(args[0])
        tnep = self._tnep(
            2, "dump_polarizability needs a *_polarizability potential")
        f = self._file("polarizability.out")

        def process(session, state, step):
            st, nbr = session._fresh_list(state)
            p = _np(tnep.polarizability(st.type, nbr, st.mask))
            row = [p[0, 0], p[1, 1], p[2, 2], p[0, 1], p[1, 2], p[0, 2]]
            f.write(f"{step}" + "".join(f"{x:20.10e}" for x in row) + "\n")
            f.flush()

        self.properties.append(PropertyRequest(interval, process))
        self.log(f"dump_polarizability every {interval}")

    # ------------------------------------------------------ the box tools

    def _box_energies(self, ff, boxes_positions):
        """Each (box, positions)'s total potential energy, summed in
        float64 on the state's device and read once."""
        out = []
        with torch.no_grad():
            for box, pos in boxes_positions:
                st = ff.compute(self.state._replace(position=pos, box=box))
                out.append(torch.sum(st.potential_energy.to(torch.float64)
                                     * st.mask))
        return _np(torch.stack(out))

    def kw_compute_cohesive(self, args):
        """compute_cohesive start end d -> cohesive.out: the energy at
        scale factors from start to end, 1000 points a unit factor
        (ref: cohesive.cu:110-240); d 0 scales every axis, d 1-3 the x, y
        or z component.  The cell is scaled as the positions are,
        diag(s) h, so the atoms stay an affine image of the cell on a
        triclinic one (the JAX app scales its lattice vectors there)."""
        self._require_state()
        start, end, d = float(args[0]), float(args[1]), int(args[2])
        num_points = round((end - start) * 1000) + 1
        factors = np.linspace(start, end, num_points)
        st = self.state
        base_h, base_pos = st.box.h, st.position
        # one neighbour plan, sized for the most compressed cell
        ff = self._force_field(st.box.with_h(base_h * min(start, end)),
                               skin=0.0)

        def geometry(fac):
            scale = torch.ones(3, dtype=base_h.dtype, device=base_h.device)
            if d == 0:
                scale.fill_(fac)
            else:
                scale[(d - 1) % 3] = fac
            return (st.box.with_h(scale[:, None] * base_h),
                    base_pos * scale[None, :])

        energies = self._box_energies(ff, [geometry(x) for x in factors])
        f = self._file("cohesive.out")
        for fac, e in zip(factors, energies):
            f.write(f"{fac:15.7e}{e:15.7e}\n")
        f.flush()
        self.log(f"compute_cohesive: {num_points} points written")

    def kw_compute_elastic(self, args):
        """compute_elastic strain cubic -> elastic.out: C11, C12 and C44
        from the energy's curvature under uniaxial, biaxial and shear
        strains (ref: cohesive.cu:151-340), energies in float64."""
        self._require_state()
        strain = float(args[0])
        st = self.state
        v0 = float(st.box.volume)

        def energy(defm):
            dm = torch.as_tensor(defm, dtype=st.box.h.dtype,
                                 device=st.box.h.device)
            box = st.box.with_h(dm @ st.box.h)
            return float(self._box_energies(self._force_field(box, 0.0), [
                (box, st.position @ dm.T)])[0])

        e0 = energy(np.eye(3))

        def curvature(pairs):
            dp, dm = np.eye(3), np.eye(3)
            for i, j in pairs:
                dp[i, j] += strain
                dm[i, j] -= strain
            return (energy(dp) + energy(dm) - 2 * e0) / strain ** 2 / v0 \
                * PRESSURE_UNIT_CONVERSION

        c11 = curvature([(0, 0)])  # d2E/de_xx^2 = C11 V
        c12 = (curvature([(0, 0), (1, 1)]) - 2 * c11) / 2.0  # 2 C11 + 2 C12
        c44 = curvature([(0, 1), (1, 0)]) / 4.0  # 4 C44 (gamma = 2 e_xy)
        f = self._file("elastic.out")
        f.write("# Elastic Constants (GPa): C11 C12 C44\n")
        f.write(f"{c11:10.3f} {c12:10.3f} {c44:10.3f}\n")
        f.flush()
        self.log(f"compute_elastic: C11={c11:.1f} C12={c12:.1f} "
                 f"C44={c44:.1f} GPa")

    def kw_change_box(self, args):
        """change_box dxx | dxx dyy dzz | dxx dyy dzz eyz exz exy
        (ref: run.cu:712-810): diagonal entries are length changes in A,
        off-diagonals strains; the positions deform affinely with the cell,
        and the force field is planned anew for the new cell (the JAX app
        keeps the old cell grid, whose cells a large compression narrows
        below rc + skin)."""
        self._require_state()
        d = np.zeros((3, 3))
        d[0, 0] = float(args[0])
        if len(args) >= 3:
            d[1, 1], d[2, 2] = float(args[1]), float(args[2])
        else:
            d[1, 1] = d[2, 2] = d[0, 0]
        if len(args) == 6:
            d[1, 2] = d[2, 1] = float(args[3])
            d[0, 2] = d[2, 0] = float(args[4])
            d[0, 1] = d[1, 0] = float(args[5])
        h = _np(self.state.box.h)
        for k in range(3):
            d[k, k] = (h[k, k] + d[k, k]) / h[k, k]
        self.box = Box.from_lattice((d @ h).T, pbc=self.frame.pbc,
                                    dtype=self.dtype, device=self.device)
        dm = torch.as_tensor(d, dtype=self.dtype, device=self.device)
        st = self.state
        self.state = st._replace(
            position=st.position @ dm.T, box=self.box,
            unwrapped_position=(st.unwrapped_position @ dm.T
                                if st.unwrapped_position is not None
                                else None))
        self._rebuild_ff()
        self.log(f"change_box {args}")

    # ------------------------------------ minimize, phonons, LSQT, MC

    def kw_minimize(self, args):
        """minimize sd|fire tol max_steps [box_change [hydrostatic]]
        (ref: minimize.cu:80-116): the minimizer on the session's device
        (minimize/minimizers.py), after the list's capacity is checked
        on the start."""
        self._require_state()
        method, tol, max_steps = args[0], float(args[1]), int(args[2])
        box_change = len(args) > 3 and int(args[3]) == 1
        if box_change:
            if method != "fire":
                raise ValueError("box relaxation requires the fire minimizer")
            fn = functools.partial(
                minimize_fire_box,
                hydrostatic=len(args) > 4 and int(args[4]) == 1)
        else:
            fn = {"sd": minimize_sd, "fire": minimize_fire}.get(method)
            if fn is None:
                raise ValueError(f"unsupported minimizer {method!r}")
        st = self.state
        with torch.no_grad():
            nbr = self.ff.neighbor.build(st.box.wrap(st.position), st.box,
                                         st.mask)
            self._check_capacity(int(nbr.count.max()), nbr.idx.shape[1],
                                 "at the minimizer's start")
        self.state, steps = fn(self.ff, st, tol, max_steps)
        e = float(torch.sum(self.state.potential_energy * self.state.mask))
        self.log(f"minimize {method}: {int(steps)} steps, U = {e:.10f} eV")

    def kw_compute_phonon(self, args):
        """compute_phonon <displacement>: dispersion along kpoints.in ->
        omega2.out and D.out (ref: hessian.cu:494-507), on the cell of the
        last `replicate` (1 1 1 without one: a primitive-cell model)."""
        self._require_state()
        compute_phonon_dispersion(self.ff, self.state, self.replicate_cxyz,
                                  float(args[0]), workdir=self.workdir)
        self.log("compute_phonon: omega2.out written")

    def kw_compute_lsqt(self, args):
        """compute_lsqt x|y|z Nm Ne E_start E_end E_max [sp3] ->
        lsqt_dos.out / lsqt_velocity.out / lsqt_sigma.out
        (ref: lsqt.cu:962-1035; `sp3` selects the 4-orbital carbon model,
        the reference's non-USE_GRAPHENE_TB build, lsqt.cu:554-643)."""
        model = "sp3" if (len(args) > 6 and args[6] == "sp3") else "graphene"
        rc = 2.6 if model == "sp3" else 2.1
        self.measure_props.append(
            LSQT(args[0], int(args[1]), int(args[2]), float(args[3]),
                 float(args[4]), float(args[5]), dt=self.dt, rc=rc,
                 model=model))
        self.log(f"compute_lsqt {args}")

    def kw_mc(self, args):
        """mc canonical|sgc|vcsgc n_md n_mc T1 T2
        [num_types (sym mu_or_phi)... [kappa]] (ref: mc.cu:206-330): a
        block of n_mc trials every n_md steps of the list path's runs."""
        kind = args[0]
        if kind not in ("canonical", "sgc", "vcsgc"):
            raise ValueError(f"invalid MC ensemble {kind!r}")
        sgc_types, sgc_mu, sgc_masses, kappa = (), (), (), 0.0
        if kind in ("sgc", "vcsgc"):
            ntypes = int(args[5])
            syms = args[6:6 + 2 * ntypes:2]
            sgc_types = tuple(self.type_names.index(x) for x in syms)
            sgc_mu = tuple(float(m) for m in args[7:7 + 2 * ntypes:2])
            sgc_masses = tuple(mass_of(x) for x in syms)
            if kind == "vcsgc":
                kappa = float(args[6 + 2 * ntypes])
        self.mc = MCMD(kind=kind, num_steps_md=int(args[1]),
                       num_steps_mc=int(args[2]), t_initial=float(args[3]),
                       t_final=float(args[4]), sgc_types=sgc_types,
                       sgc_mu=sgc_mu, sgc_masses=sgc_masses, kappa=kappa)
        self.log(f"mc {args}")

    # ------------------------------------------- deposition, CG, NetCDF

    def kw_deposit(self, args):
        """deposit interval direction hmin hmax atom type number velocity
        (ref: deposition.cu:48-170, 440-470): every `interval` steps
        `number` atoms of `type` appear at random lateral positions, the
        deposition axis coordinate in [hmin, hmax], moving at `velocity`
        (natural units) along it.  The state is padded with masked atoms
        at a run's start and a deposition switches them on; the positions
        come from numpy's default_rng(777), as in the JAX app."""
        if args[4] != "atom":
            raise ValueError("deposit: only 'atom' mode supported")
        self._deposit = dict(
            interval=int(args[0]), direction=int(args[1]),
            hmin=float(args[2]), hmax=float(args[3]), type=int(args[5]),
            number=int(args[6]), velocity=float(args[7]), next_slot=None,
            rng=np.random.default_rng(777))
        self.log(f"deposit {args}")

    def _prepare_deposit(self, n_steps):
        """Pad the state with this run's deposited atoms (masked), the
        group labels with -1, and register the activation."""
        dep = self._deposit
        need = (n_steps // dep["interval"]) * dep["number"]
        if need <= 0:
            return
        st = self.state
        mass_new = MASS_TABLE.get(self.type_names[dep["type"]], 1.0)

        def pad(a, fill=0.0):
            if a is None:
                return None
            return torch.cat([a, torch.full((need,) + tuple(a.shape[1:]),
                                            fill, dtype=a.dtype,
                                            device=a.device)])

        self.state = st._replace(
            position=pad(st.position), velocity=pad(st.velocity),
            force=pad(st.force), mass=pad(st.mass, mass_new),
            type=pad(st.type, dep["type"]),
            potential_energy=pad(st.potential_energy),
            virial=pad(st.virial), heat_current=pad(st.heat_current),
            mask=pad(st.mask), charge=pad(st.charge),
            unwrapped_position=pad(st.unwrapped_position),
            position_c=pad(st.position_c), velocity_c=pad(st.velocity_c))
        self.symbols = list(self.symbols) + [self.type_names[dep["type"]]
                                             ] * need
        if self.groups.n_methods:
            self.groups.labels = np.pad(self.groups.labels,
                                        ((0, need), (0, 0)),
                                        constant_values=-1)
        dep["next_slot"] = self._n
        self._n += need
        self._rebuild_ff()

        def process(session, state, step):
            s0, k = dep["next_slot"], dep["number"]
            if s0 + k > session._n:
                return
            rng = dep["rng"]
            h = _np(state.box.h)
            axis = dep["direction"]
            new = np.zeros((k, 3))
            for m in range(k):
                new[m] = [rng.random() * h[0, 0], rng.random() * h[1, 1],
                          rng.random() * h[2, 2]]
                new[m, axis] = (dep["hmin"]
                                + rng.random() * (dep["hmax"] - dep["hmin"]))
            vel = np.zeros((k, 3))
            vel[:, axis] = dep["velocity"]
            pos, v, mask = (state.position.clone(), state.velocity.clone(),
                            state.mask.clone())
            pos[s0:s0 + k] = torch.as_tensor(new, dtype=pos.dtype)
            v[s0:s0 + k] = torch.as_tensor(vel, dtype=v.dtype)
            mask[s0:s0 + k] = 1.0
            dep["next_slot"] = s0 + k
            session.state = state._replace(position=pos, velocity=v,
                                           mask=mask)

        self.properties.append(PropertyRequest(dep["interval"], process,
                                               mutates_state=True))

    def kw_dump_cg(self, args):
        """dump_cg interval grouping_method -> train.xyz frames of
        coarse-grained beads, a group a bead (ref: dump_cg.cu): the beads'
        centres of mass, their forces, the energy and the virial averaged
        over the window, the virial plus the missing degrees of freedom's
        ideal-gas term (N - beads) k_B T.  The sums run every step in
        float64 on the state's device and come back once a window."""
        interval, gm = int(args[0]), int(args[1])
        f64 = torch.float64
        onehot = self.groups.onehot(gm, dtype=f64, device=self.device)
        nbeads = onehot.shape[1]
        labels = self.groups.labels[:, gm]
        # a bead's species: its first member's (ref: dump_cg.cu:352)
        first_sym = [self.symbols[int(np.nonzero(labels == b)[0][0])]
                     for b in range(nbeads)]
        acc = {"n": 0}
        fout = self._file("train.xyz")

        def process(session, state, step):
            n = onehot.shape[0]
            m = state.mask[:n].to(f64)
            sums = torch.cat([
                (onehot.T @ state.force[:n].to(f64)).reshape(-1),
                torch.sum(state.potential_energy[:n].to(f64) * m)[None],
                torch.sum(state.virial[:n].to(f64) * m[:, None, None],
                          dim=0).reshape(-1)])
            acc["sum"] = sums if acc["n"] == 0 else acc["sum"] + sums
            acc["n"] += 1
            if acc["n"] % interval:
                return
            inv = 1.0 / acc["n"]
            mass = state.mass[:n].to(f64)
            pos = (state.unwrapped_position
                   if state.unwrapped_position is not None
                   else state.position)[:n].to(f64)
            com = (onehot.T @ (mass[:, None] * pos)) / (onehot.T @ mass
                                                         )[:, None]
            vals = _np(torch.cat([acc["sum"], com.reshape(-1),
                                  torch.sum(m)[None], state.box.h.reshape(
                                      -1).to(f64)]))
            nf = 3 * nbeads
            fb = vals[:nf].reshape(nbeads, 3) * inv
            e = vals[nf] * inv
            w = vals[nf + 1:nf + 10].reshape(3, 3) * inv
            com = vals[nf + 10:nf + 10 + nf].reshape(nbeads, 3)
            n_real = int(round(vals[2 * nf + 10]))
            h = vals[2 * nf + 11:].reshape(3, 3)
            extra = (n_real - nbeads) * K_B * session._ensemble_temperature()
            w = w + extra * np.eye(3)
            pbc = " ".join("T" if p else "F" for p in _np(state.box.pbc) > 0)
            lat = " ".join(f"{h[i, j]:.8f}" for j in range(3)
                           for i in range(3))
            fout.write(f"{nbeads}\n")
            fout.write(f'pbc="{pbc}" Lattice="{lat}" energy={e:.8f} '
                       f'virial="{" ".join(f"{x:.8f}" for x in w.ravel())}" '
                       "Properties=species:S:1:pos:R:3:forces:R:3\n")
            for b in range(nbeads):
                fout.write(f"{first_sym[b]} {com[b, 0]:.8f} "
                           f"{com[b, 1]:.8f} {com[b, 2]:.8f} "
                           f"{fb[b, 0]:.8f} {fb[b, 1]:.8f} "
                           f"{fb[b, 2]:.8f}\n")
            fout.flush()
            acc["n"] = 0

        self.properties.append(PropertyRequest(1, process))
        self.log(f"dump_cg {args}")

    def kw_dump_netcdf(self, args):
        """dump_netcdf grouping_method group_id interval has_velocity file
        [precision single|double] [compression N] -> an AMBER NetCDF
        trajectory (ref: dump_netcdf.cu:86-200), written at a run's end
        through scipy's NetCDF-3 writer (compression, a NetCDF-4 feature,
        is ignored)."""
        method, gid, interval = int(args[0]), int(args[1]), int(args[2])
        has_vel = int(args[3]) == 1
        precision = "double"
        for key, val in _pairs(args[5:], "dump_netcdf"):
            if key == "precision":
                precision = val
            elif key == "compression":
                self.log("dump_netcdf: compression ignored (NetCDF-3)")
            else:
                raise ValueError(f"unknown dump_netcdf token {key!r}")
        dumper = DumpNetCDF(os.path.join(self.workdir, args[4]), has_vel,
                            precision, grouping_method=method, group_id=gid)

        def process(session, state, step):
            n = session._n
            pick = (session.groups.labels[:n, method] == gid if method >= 0
                    else np.ones(n, bool))
            pos = _np(state.position)[:n][pick]
            types = _np(state.type).astype(np.int64)[:n][pick]
            vel = _np(state.velocity)[:n][pick] if has_vel else None
            t_ps = step * session.dt / 1000.0 * TIME_UNIT_CONVERSION
            dumper.add_frame(t_ps, pos, types, _np(state.box.h), vel)

        def finalize(session):
            dumper.write()
            session.log(f"dump_netcdf: {len(dumper.frames)} frames -> "
                        f"{dumper.path}")

        self.properties.append(PropertyRequest(interval, process, finalize))

    def kw_plumed(self, args):
        """plumed <dat_file> <interval> <restart>: an enhanced-sampling bias
        from libplumed, loaded at run time (ref: plumed.cu:108-131); the
        bias forces replace the state's and the per-atom virials are
        rescaled at every call, as the reference does.  Without libplumed
        it raises the reference's "PLUMED not installed!"."""
        self._require_state()
        dat, interval, restart = args[0], int(args[1]), int(args[2]) == 1
        n = self._n
        bridge = PlumedBridge(
            os.path.join(self.workdir, dat), interval, restart, n,
            _np(self.state.mass)[:n], self.dt,
            getattr(self.ensemble, "temperature", 300.0))

        def process(session, state, step):
            f_new, v_new, _ = bridge.compute(
                _np(state.position)[:n], _np(state.force)[:n],
                _np(state.box.h), _np(state.virial)[:n])
            force, virial = state.force.clone(), state.virial.clone()
            force[:n] = torch.as_tensor(f_new, dtype=force.dtype)
            virial[:n] = torch.as_tensor(v_new, dtype=virial.dtype)
            session.state = state._replace(force=force, virial=virial)

        def finalize(session):
            bridge.finalize()

        self.properties.append(PropertyRequest(
            interval, process, finalize, needs_atom_virial=True,
            mutates_state=True))
        self.log(f"plumed {args}")

    # --------------------------------------------------------------- drivers

    def kw_add_force(self, args):
        """add_force <gm> <gid> (fx fy fz | file) (ref: add_force.cu)."""
        gm, gid = int(args[0]), int(args[1])
        table = parse_table_or_values(args[2:], self.workdir)
        self.drivers.append(AddForce(gmask=self._gmask(gm, gid), table=table))
        self.log(f"add_force {args}")

    def kw_add_efield(self, args):
        """add_efield <gm> <gid> (Ex Ey Ez | file) [charge|bec]
        (ref: add_efield.cu)."""
        gm, gid = int(args[0]), int(args[1])
        rest = list(args[2:])
        mode = "charge"
        if rest and rest[-1] in ("charge", "bec"):
            mode = rest.pop()
        table = parse_table_or_values(rest, self.workdir)
        bec_fn = None
        if mode == "bec":
            # the Born charges on a fresh list each step (the JAX app's
            # bec_fn, ref: add_efield.cu's BEC branch)
            pot = self._charge_model("add_efield bec mode")

            def bec_fn(state):
                return pot.born_effective_charges(
                    state, self._fresh_list(state)[1])

        self.drivers.append(AddEfield(gmask=self._gmask(gm, gid), table=table,
                                      use_bec=(mode == "bec"),
                                      bec_fn=bec_fn))
        self.log(f"add_efield {args}")

    def kw_add_spring(self, args):
        """add_spring ghost_com <gm> <gid> vx vy vz couple k R0 x0 y0 z0 |
        add_spring ghost_com <gm> <gid> vx vy vz decouple kx ky kz x0 y0 z0
        (ref: add_spring.cu)."""
        self._require_state()
        if args[0] != "ghost_com":
            raise ValueError(
                f"add_spring mode {args[0]!r} not supported (ghost_com only)")
        gm, gid = int(args[1]), int(args[2])
        vel = tuple(float(x) for x in args[3:6])
        stiff = args[6]
        gmask = self._gmask(gm, gid)
        pos = _np(self.state.position)
        m = _np(self.state.mass) * _np(gmask)
        com0 = (m[:, None] * pos).sum(0) / max(m.sum(), 1e-30)
        if stiff == "couple":
            k, r0 = float(args[7]), float(args[8])
            off = tuple(float(x) for x in args[9:12])
            drv = AddSpring(gmask=gmask, com0=tuple(com0), velocity=vel,
                            offset=off, couple=True, k=k, r0=r0)
        elif stiff == "decouple":
            k3 = tuple(float(x) for x in args[7:10])
            off = tuple(float(x) for x in args[10:13])
            drv = AddSpring(gmask=gmask, com0=tuple(com0), velocity=vel,
                            offset=off, couple=False, k3=k3)
        else:
            raise ValueError("add_spring: expected couple|decouple")
        self.drivers.append(drv)
        self.log(f"add_spring {args}")

    def kw_add_random_force(self, args):
        self.drivers.append(AddRandomForce(variance=float(args[0])))
        self.log(f"add_random_force {args}")

    def kw_electron_stop(self, args):
        path = args[0]
        if not os.path.isabs(path):
            path = os.path.join(self.workdir, path)
        self.drivers.append(
            ElectronStop.from_file(path, max(1, len(self.type_names))))
        self.log(f"electron_stop {args}")

    # ----------------------------------------------------------------- driver

    KEYWORDS = {
        "potential": kw_potential,
        "velocity": kw_velocity,
        "time_step": kw_time_step,
        "ensemble": kw_ensemble,
        "dump_thermo": kw_dump_thermo,
        "dump_exyz": kw_dump_exyz,
        "dump_position": kw_dump_position,
        "dump_xyz": kw_dump_xyz,
        "dump_restart": kw_dump_restart,
        "dump_velocity": kw_dump_velocity,
        "engine": kw_engine,
        "dump_force": kw_dump_force,
        "correct_velocity": kw_correct_velocity,
        "fix": kw_fix,
        "replicate": kw_replicate,
        "compute_hac": kw_compute_hac,
        "compute_hnemd": kw_compute_hnemd,
        "add_force": kw_add_force,
        "add_spring": kw_add_spring,
        "add_efield": kw_add_efield,
        "add_random_force": kw_add_random_force,
        "electron_stop": kw_electron_stop,
        "compute_shc": kw_compute_shc,
        "compute_msd": kw_compute_msd,
        "compute_sdc": kw_compute_sdc,
        "compute_dos": kw_compute_dos,
        "compute_ic": kw_compute_ic,
        "compute_viscosity": kw_compute_viscosity,
        "compute_hnemdec": kw_compute_hnemdec,
        "compute_gkma": kw_compute_gkma,
        "compute_hnema": kw_compute_hnema,
        "compute_rdf": kw_compute_rdf,
        "compute_angular_rdf": kw_compute_angular_rdf,
        "compute_adf": kw_compute_adf,
        "compute_orientorder": kw_compute_orientorder,
        "compute": kw_compute,
        "compute_chunk": kw_compute_chunk,
        "move": kw_move,
        "deform": kw_deform,
        "dump_shock_nemd": kw_dump_shock_nemd,
        "dump_beads": kw_dump_beads,
        "dftd3": kw_dftd3,
        "kspace": kw_kspace,
        "compute_dpdt": kw_compute_dpdt,
        "compute_es": kw_compute_es,
        "dump_observer": kw_dump_observer,
        "active": kw_active,
        "compute_extrapolation": kw_compute_extrapolation,
        "dump_dipole": kw_dump_dipole,
        "dump_polarizability": kw_dump_polarizability,
        "compute_cohesive": kw_compute_cohesive,
        "compute_elastic": kw_compute_elastic,
        "change_box": kw_change_box,
        "deposit": kw_deposit,
        "dump_cg": kw_dump_cg,
        "dump_netcdf": kw_dump_netcdf,
        "plumed": kw_plumed,
        "minimize": kw_minimize,
        "compute_phonon": kw_compute_phonon,
        "compute_lsqt": kw_compute_lsqt,
        "mc": kw_mc,
        "run": kw_run,
    }

    def execute(self, runfile: str = "run.in"):
        try:
            for toks in parse_run_in(os.path.join(self.workdir, runfile)):
                kw, args = toks[0], toks[1:]
                if kw in UNPORTED:
                    raise _not_ported(f"run.in keyword {kw!r}", UNPORTED[kw])
                handler = self.KEYWORDS.get(kw)
                if handler is None:
                    raise ValueError(
                        f"unknown or unsupported run.in keyword {kw!r}")
                handler(self, args)
        finally:
            for f in self._files.values():
                f.close()
            self._files.clear()


def _auto_mn(potentials, n_atoms=None, box=None, position=None,
             pbc=(True, True, True)) -> int:
    """Neighbour capacity: NEP files carry MN hints, otherwise 256; and at
    least a density bound, so the list cannot silently truncate.  The
    many-body potentials without a hint (_MANY_BODY) take the density
    bound alone, at least 32: their angle tensors grow with MN^2, and the
    list path raises at a chunk's end if a row outgrows it.  An ILP
    hybrid's rows also get the layers' bound (potentials/ilp.py's
    layer_bound, from `position`): the density of a bilayer in a vacuum
    box counts the vacuum."""
    mn = 0
    rc_max = max((getattr(p, "rc", 0.0) for p in potentials), default=0.0)
    rc_base = 0.0
    for p in potentials:
        if hasattr(p, "model"):
            mn = max(mn, p.model.mn_radial)
            rc_base = max(rc_base, p.rc)
    if mn and rc_base and rc_max > rc_base:
        mn = int(mn * (rc_max / rc_base) ** 3)
    many_body = bool(potentials) and all(isinstance(p, _MANY_BODY)
                                         for p in potentials)
    out = int(mn * 1.3) if mn else (32 if many_body else 256)
    if n_atoms and box is not None and rc_max > 0.0:
        dens = n_atoms / float(box.volume)
        bound = dens * 4.0 / 3.0 * math.pi * (rc_max + 1.5) ** 3
        # images of a small periodic cell can exceed n_atoms, so no clamp
        # by atom count here
        out = max(out, int(bound * 1.5) + 8)
        if position is not None and any(isinstance(p, ILPHybrid)
                                        for p in potentials):
            out = max(out, layer_bound(position[:n_atoms], None,
                                       _np(box.h), pbc, rc_max + 1.5))
    return out


def main(argv=None):
    """Execute argv's work directory's run.in on the card, or on the CPU
    with --device cpu.  Returns the session."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default=".")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    session = Session(args.workdir, device=args.device or "cuda")
    session.execute()
    return session


if __name__ == "__main__":
    main()
