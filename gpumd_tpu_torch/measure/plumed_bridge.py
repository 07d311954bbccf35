"""PLUMED interface: metadynamics / enhanced-sampling bias via libplumed.

Counterpart of gpumd_tpu/measure/plumed_bridge.py, the rebuild of the
reference's PLUMED plugin wrapper (ref: src/measure/plumed.cu:106-262).  The reference links libplumed at
build time behind a USE_PLUMED flag; here the kernel library is loaded at
RUNTIME with ctypes (the same C API: plumed_create / plumed_cmd /
plumed_finalize), so no build-time dependency exists.  If no libplumed is
found the keyword raises the reference's "PLUMED not installed!" error.

Unit setup mirrors plumed.cu:139-158: PLUMED is told the MD units
(time ps, mass amu, energy kJ/mol per eV, length nm per 0.1 A) and does
every conversion internally — positions/forces cross the boundary raw.

Flow per invocation (ref: :166-256): pass step/masses/box/positions/
forces, performCalc; PLUMED adds bias forces IN PLACE and returns the
bias virial; per-atom virials are rescaled by (W - dW)/W per component.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from gpumd_tpu_torch.units import K_B, TIME_UNIT_CONVERSION

# eV -> kJ/mol (ref: plumed.cu:30-33)
_ENERGY_UNIT = 6.0221367e23 * 1.602176634e-19 / 1000.0


class _PlumedHandle(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p)]


def _load_library():
    names = ("libplumed.so", "libplumedKernel.so", "libplumed.dylib")
    env = os.environ.get("PLUMED_KERNEL")
    candidates = ([env] if env else []) + list(names)
    for name in candidates:
        try:
            lib = ctypes.CDLL(name, mode=ctypes.RTLD_GLOBAL)
            lib.plumed_create.restype = _PlumedHandle
            lib.plumed_cmd.argtypes = [
                _PlumedHandle, ctypes.c_char_p, ctypes.c_void_p
            ]
            lib.plumed_finalize.argtypes = [_PlumedHandle]
            return lib
        except OSError:
            continue
    return None


def plumed_installed() -> bool:
    return _load_library() is not None


class PlumedBridge:
    """One `plumed <file> <interval> <restart>` request."""

    def __init__(self, input_file: str, interval: int, restart: bool,
                 n_atoms: int, masses, time_step: float, temperature: float):
        self._lib = _load_library()
        if self._lib is None:
            raise RuntimeError("PLUMED not installed!")
        self.interval = interval
        self.n = n_atoms
        self.step = 0
        self.masses = np.ascontiguousarray(masses, np.float64)
        self.bias = ctypes.c_double(0.0)
        self._h = self._lib.plumed_create()

        def cmd(key, val=None):
            self._lib.plumed_cmd(self._h, key.encode(), val)

        self._cmd = cmd
        api = ctypes.c_int(0)
        cmd("getApiVersion", ctypes.byref(api))
        kbt = ctypes.c_double(K_B * temperature)
        tu = ctypes.c_double(TIME_UNIT_CONVERSION / 1000.0)
        mu = ctypes.c_double(1.0)
        eu = ctypes.c_double(_ENERGY_UNIT)
        lu = ctypes.c_double(0.1)
        qu = ctypes.c_double(1.0)
        ts = ctypes.c_double(time_step)
        rs = ctypes.c_int(1 if restart else 0)
        na = ctypes.c_int(n_atoms)
        cmd("setKbT", ctypes.byref(kbt))
        cmd("setMDEngine", b"GPUMD")
        cmd("setMDTimeUnits", ctypes.byref(tu))
        cmd("setMDMassUnits", ctypes.byref(mu))
        cmd("setMDEnergyUnits", ctypes.byref(eu))
        cmd("setMDLengthUnits", ctypes.byref(lu))
        cmd("setMDChargeUnits", ctypes.byref(qu))
        cmd("setPlumedDat", input_file.encode())
        cmd("setLogFile", (input_file + ".out").encode())
        cmd("setTimestep", ctypes.byref(ts))
        cmd("setRestart", ctypes.byref(rs))
        cmd("setNatoms", ctypes.byref(na))
        cmd("init")

    def compute(self, positions, forces, h, virial_per_atom):
        """Run PLUMED at this step.  Returns (new_forces, new_virial,
        bias_energy); arrays are numpy, shapes (N, 3) / (N, 3, 3)."""
        n = self.n
        self.step += self.interval
        # column-major xyz blocks like the reference SoA layout
        q = np.ascontiguousarray(positions.T.reshape(3, n), np.float64)
        f = np.ascontiguousarray(forces.T.reshape(3, n), np.float64)
        # PLUMED box rows = lattice vectors (ref: :186-195 transposes h)
        b = np.ascontiguousarray(np.asarray(h, np.float64).T)
        v = np.zeros((3, 3), np.float64)
        step = ctypes.c_long(self.step)
        stop = ctypes.c_int(0)

        def ptr(a):
            return a.ctypes.data_as(ctypes.c_void_p)

        self._cmd("setStep", ctypes.byref(step))
        self._cmd("setMasses", ptr(self.masses))
        self._cmd("setBox", ptr(b))
        self._cmd("setVirial", ptr(v))
        self._cmd("setForcesX", ptr(f[0]))
        self._cmd("setForcesY", ptr(f[1]))
        self._cmd("setForcesZ", ptr(f[2]))
        self._cmd("setPositionsX", ptr(q[0]))
        self._cmd("setPositionsY", ptr(q[1]))
        self._cmd("setPositionsZ", ptr(q[2]))
        self._cmd("prepareCalc")
        self._cmd("performCalc")
        self._cmd("getBias", ctypes.byref(self.bias))
        self._cmd("setStopFlag", ctypes.byref(stop))

        new_forces = f.reshape(3, n).T.copy()
        # rescale per-atom virials by (W - dW)/W per component
        # (ref: gpu_scale_virial + factor table :245-256)
        w = np.sum(virial_per_atom, axis=0)  # (3, 3) total
        with np.errstate(divide="ignore", invalid="ignore"):
            factor = np.where(np.abs(w) > 0, (w - v) / w, 1.0)
        new_virial = virial_per_atom * factor[None]
        return new_forces, new_virial, float(self.bias.value)

    def finalize(self):
        if self._h.p:
            self._lib.plumed_finalize(self._h)
            self._h = _PlumedHandle()
