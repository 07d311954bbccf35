"""The `gpumd` application: execute run.in against model.xyz.

    python -m gpumd_tpu_torch.app.gpumd [workdir] [--device cpu]

Counterpart of gpumd_tpu/app/gpumd.py.  Keyword-stream execution as in the
reference (ref: src/main_gpumd/run.cu:343-575): state keywords apply at
once, property keywords register observers, `run N` performs a run block.
The handlers keep the JAX module's names (`kw_<keyword>`).

`engine auto` (the default) sends a run that the compact engine takes
(one NEP or Tersoff-1989 potential, an ensemble of DENSE_ENSEMBLES, no
fix/move group, no deform, no driver, no HNEMDEC and no per-step stress
or Onsager observer, a box of >= 3 cells of rc + skin an axis) to
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

Keywords whose modules are not ported raise NotImplementedError naming
the ROADMAP item that ports them; an unknown keyword raises ValueError.
The session runs on the card unless the caller asks for the CPU
(`device="cpu"`), and raises without a card.  Randomness comes from
torch generators seeded from the keyword's seed; the stochastic ensembles
and drivers take an injected `draw` for tests.
"""

from __future__ import annotations

import argparse
import dataclasses
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
from gpumd_tpu_torch.engine.nep_compact import CompactSpec, plan_grid_compact
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
from gpumd_tpu_torch.model.box import Box, inv3
from gpumd_tpu_torch.model.groups import Groups
from gpumd_tpu_torch.model.state import MDState, make_state
from gpumd_tpu_torch.potentials.eam import (
    ADP,
    EAMAlloy,
    EAMDai2006,
    EAMZhou2004,
)
from gpumd_tpu_torch.potentials.lj import LJ
from gpumd_tpu_torch.potentials.nep.model import NEP
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
# ROADMAP queue 1 item that ports each
UNPORTED = {
    # item 6: the rest of the app surface
    **{kw: 6 for kw in (
        "compute_cohesive", "compute_elastic", "change_box", "deposit",
        "dump_observer", "active", "compute_extrapolation",
        "compute_dpdt", "compute_es", "dump_cg",
        "dump_dipole", "dump_polarizability", "kspace",
        "plumed", "dump_netcdf")},
    # item 8: measure (the tight-binding transport solver)
    "compute_lsqt": 8,
    # item 9: potentials
    "dftd3": 9,
    # item 10: MC, minimize, phonon
    **{kw: 10 for kw in ("minimize", "mc", "compute_phonon")},
}

# potential file headers not ported yet: all ROADMAP queue 1, item 9
_UNPORTED_POTENTIALS = ("dp", "tersoff_ilp", "nep_ilp", "sw_ilp", "fcp")

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
# with MN^2)
_MANY_BODY = (Tersoff1989, Tersoff1988, TersoffMini, SW, EAMZhou2004,
              EAMAlloy, ADP, EAMDai2006)


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
    pot = session.potentials[0]
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
        self.route_reason: Optional[str] = None  # the last run's, or None
        self.md = None  # the last compact run's engine (None: list path)
        self.run_seconds: List[float] = []  # each run block's wall time
        self._n = frame.n_atoms
        self._files: Dict[str, object] = {}

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
        if self.potentials:
            # several potentials drive in the reference's observe/average
            # modes, which need dump_observer
            raise _not_ported("a second potential (dump_observer's "
                              "observe/average modes)", 6)
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
        elif name in _UNPORTED_POTENTIALS or (
                name.startswith("nep") and "charge" in name):
            raise _not_ported(f"potential {name!r}", 9)
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
        self.state = self._make_state(velocity=vel)
        self._rebuild_ff()
        self.log(f"potential: {name} ({path})")

    def _rebuild_ff(self):
        self.ff = ForceField.create(
            self.potentials, self.box, self._n,
            mn=_auto_mn(self.potentials, self._n, self.box), skin=1.0)

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
        """engine dense|list|auto [n_devices]: route `run` through the
        compact engine (engine/dense_md.py, the kernels' path), the list
        path, or let `dense_route_reason` choose (the default)."""
        mode = args[0]
        ndev = int(args[1]) if len(args) > 1 else 1
        if mode not in ("dense", "list", "auto"):
            raise ValueError("engine must be 'dense', 'list' or 'auto'")
        if ndev > 1:
            raise _not_ported("engine on several devices (the slab-sharded "
                              "compact engine)", 11)
        self.engine_mode = mode
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
        """MD block on the compact engine (one NEP or Tersoff-1989
        potential); properties observe input-order snapshots at chunk
        boundaries, SHC accumulates on the card inside the chunk."""
        if len(self.potentials) != 1 or not isinstance(
                self.potentials[0], (NEP, Tersoff1989)):
            raise ValueError("engine dense: exactly one driving NEP or "
                             "Tersoff1989 potential")
        pot = self.potentials[0]
        needs_heat = any(getattr(m, "needs_heat", False)
                         for m in self.measure_props)
        needs_av = any(getattr(m, "needs_atom_virial", False)
                       for m in self.measure_props) or any(
            p.needs_atom_virial for p in self.properties)
        hnemd_fe = self.ff.hnemd_fe
        pav = needs_heat or needs_av or hnemd_fe is not None
        n = self._n
        state = self.state
        # measures with a device_init accumulate on the card inside the
        # chunk; the others sample at chunk boundaries
        dev_props = [m for m in self.measure_props
                     if hasattr(m, "device_init")]
        host_props = [m for m in self.measure_props if m not in dev_props]
        intervals = [p.interval for p in self.properties] + [
            m.interval for m in host_props]
        chunk = _bounded_chunk(
            math.gcd(*intervals) if intervals else n_steps, n_steps)
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
                snap = md.to_input_order(carry, n)
                pe = float(torch.sum(snap.potential_energy * snap.mask))
                if not np.isfinite(pe):
                    raise RuntimeError(f"non-finite potential energy at "
                                       f"step {self.global_step}")
                self.state = snap
                for prop in self.properties:
                    if done % prop.interval == 0:
                        prop.process(self, snap, self.global_step)
                for m in host_props:
                    if done % m.interval == 0 and hasattr(m, "sample_state"):
                        m.sample_state(self, snap, self.global_step)
        wall = time.time() - t0
        self.run_seconds.append(wall)
        self.log(f"Speed of this run = {n * n_steps / max(wall, 1e-9):.5g} "
                 f"atom*step/second (dense)")
        for m, a in zip(dev_props, maccs):
            m.device_postprocess(self, a)
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
        self.ff = dataclasses.replace(self.ff,
                                      potentials=tuple(self.potentials))

    def kw_run(self, args):
        self._require_state()
        n_steps = int(args[0])
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
            for prop in self.properties:
                if done % prop.interval == 0:
                    prop.process(self, state, self.global_step)
                    state = self.state  # processors may replace it
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
        self.drivers.append(AddEfield(gmask=self._gmask(gm, gid), table=table,
                                      use_bec=(mode == "bec")))
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


def _auto_mn(potentials, n_atoms=None, box=None) -> int:
    """Neighbour capacity: NEP files carry MN hints, otherwise 256; and at
    least a density bound, so the list cannot silently truncate.  The
    many-body potentials without a hint (_MANY_BODY) take the density
    bound alone, at least 32: their angle tensors grow with MN^2, and the
    list path raises at a chunk's end if a row outgrows it."""
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
