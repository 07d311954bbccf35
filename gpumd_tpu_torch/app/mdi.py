"""MDI engine mode: drive the MD engine from an external program.

    python -m gpumd_tpu_torch.app.mdi [workdir] [--device cpu] [--port P]
    python -m gpumd_tpu_torch.app.mdi [workdir] --libmdi [MDI options]

Counterpart of gpumd_tpu/app/mdi.py (ref: src/main_mdi/run.cu:355-480,
main.cu:42-51): an external driver (e.g. an ab-initio loop) sets
positions/cell and reads forces/energy/stress, optionally stepping the
dynamics one step at a time.  The reference links libmdi; here the same
engine surface is exposed three ways:

  * `MDIEngine`: an in-process object with the MDI command set as methods
    (set_coords / set_cell / get_forces / get_energy / get_stress /
    init_md / step / step_with_forces), on a Session prepared from
    model.xyz + run.in (potential and ensemble, no `run` needed);
  * `serve()`: a newline/JSON TCP server speaking the same commands for
    out-of-process drivers ("<FORCES", ">COORDS", ...);
  * `serve_libmdi()`: the reference's MDI engine loop over the MolSSI MDI
    library through ctypes.

Units follow MDI conventions at the wire (atomic units: Bohr, Hartree),
converted at the boundary like the reference does.  The engine runs on the
card unless it is given device="cpu".  A `>CELL` plans the force field
anew for the new cell (its neighbour images or cell grid and the list's
capacity), as `change_box` does: the JAX engine keeps the plan of the
first cell.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
from typing import Callable, Optional

import numpy as np
import torch

from gpumd_tpu_torch.app.gpumd import Session, _np
from gpumd_tpu_torch.integrate.ensembles.nve import NVE
from gpumd_tpu_torch.integrate.run import make_md_step
from gpumd_tpu_torch.model.box import Box

BOHR = 0.529177210903  # A
HARTREE = 27.211386245988  # eV


class MDIEngine:
    """In-process engine: wraps a Session prepared from model.xyz + run.in
    (the run.in should configure potential/ensemble but needs no `run`)."""

    def __init__(self, workdir: str = ".", device="cuda",
                 dtype: Optional[torch.dtype] = None):
        self.session = Session(workdir, quiet=True, device=device,
                               dtype=dtype)
        self.session.execute()  # executes setup keywords (no run needed)
        self._fresh = True
        self._state_out = None
        self.external_energy = None
        self.external_stress = None

    def _compute(self, state):
        with torch.no_grad():
            return self.session.ff.compute(state)

    # ---- MDI command surface (ref: run.cu:355-480) -----------------------

    def get_natoms(self) -> int:
        return int(self.session.state.mask.sum())

    def set_coords(self, coords_bohr):
        """>COORDS: (N, 3) in Bohr."""
        st = self.session.state
        pos = torch.as_tensor(np.asarray(coords_bohr, np.float64) * BOHR,
                              dtype=st.position.dtype,
                              device=st.position.device)
        position = st.position.clone()
        position[:pos.shape[0]] = pos
        self.session.state = st._replace(position=position)
        self._state_out = None

    def set_cell(self, cell_bohr):
        """>CELL: 3x3 in Bohr (column vectors a, b, c); the force field is
        planned anew for the new cell."""
        s = self.session
        h = np.asarray(cell_bohr, np.float64) * BOHR
        box = Box.from_lattice(h.T, pbc=_np(s.box.pbc) > 0, dtype=s.dtype,
                               device=s.device)
        s.box = box
        s.state = s.state._replace(box=box)
        s._rebuild_ff()
        self._state_out = None
        self._fresh = True  # an integrator's cache holds the old plan

    def _ensure(self):
        if self._state_out is None:
            self._state_out = self._compute(self.session.state)
        return self._state_out

    def get_energy(self) -> float:
        """<ENERGY in Hartree."""
        out = self._ensure()
        return float(torch.sum(out.potential_energy * out.mask)) / HARTREE

    def get_forces(self) -> np.ndarray:
        """<FORCES in Hartree/Bohr, (N, 3)."""
        out = self._ensure()
        return _np(out.force)[:self.get_natoms()] * (BOHR / HARTREE)

    def get_stress(self) -> np.ndarray:
        """<STRESS: virial/volume in Hartree/Bohr^3, (3, 3)."""
        out = self._ensure()
        w = _np(torch.sum(out.virial * out.mask[:, None, None], dim=0))
        vol = float(self.session.state.box.volume)
        return w / vol * (BOHR ** 3 / HARTREE)

    def get_coords(self) -> np.ndarray:
        """<COORDS in Bohr."""
        return _np(self.session.state.position)[:self.get_natoms()] / BOHR

    def init_md(self):
        """@INIT_MD: build the integrator for step-one control."""
        s = self.session
        ens = s.ensemble or NVE()
        self._step = make_md_step(s.ff, ens, s.dt, observer=lambda st: 0)
        with torch.no_grad():
            st = self._compute(s.state)
            self._aux = ens.init(st)
            self._cache = s.ff.refresh_cache(st) if s.ff.skin > 0 else None
        s.state = st
        self._fresh = False

    def step(self, n: int = 1):
        """@COORDS advance: n MD steps."""
        if self._fresh:
            self.init_md()
        carry = (self.session.state, self._aux, self._cache)
        with torch.no_grad():
            for _ in range(n):
                carry, _ = self._step(carry)
        self.session.state, self._aux, self._cache = carry
        self._state_out = None

    def step_with_forces(self, forces_ev_a):
        """>FORCES path: integrate ONE velocity-Verlet step using
        externally supplied forces (QM/MM hybrid loops; ref: run.cu
        mdi_set_forces + mdi_step_one)."""
        if self._fresh:
            self.init_md()
        st = self.session.state
        ext = torch.as_tensor(np.asarray(forces_ev_a, np.float64),
                              dtype=st.force.dtype, device=st.force.device)
        force = st.force.clone()
        force[:ext.shape[0]] = ext
        dt = self.session.dt
        inv_m = (st.mask / st.mass)[:, None]
        v_half = st.velocity + 0.5 * dt * force * inv_m
        x_new = st.position + dt * v_half * st.mask[:, None]
        # the second half-kick reuses the external forces (the next >FORCES
        # call supplies updated ones, as in the reference's hybrid loop)
        v_new = v_half + 0.5 * dt * force * inv_m
        self.session.state = st._replace(position=x_new, velocity=v_new,
                                         force=force)
        self._state_out = None


def _reply(eng: MDIEngine, msg: dict) -> Optional[dict]:
    """One JSON command's answer; None for EXIT."""
    cmd = msg.get("cmd", "")
    if cmd == "<NATOMS":
        return {"value": eng.get_natoms()}
    if cmd == "<ENERGY":
        return {"value": eng.get_energy()}
    if cmd == "<FORCES":
        return {"value": eng.get_forces().tolist()}
    if cmd == "<STRESS":
        return {"value": eng.get_stress().tolist()}
    if cmd == "<COORDS":
        return {"value": eng.get_coords().tolist()}
    if cmd == ">COORDS":
        eng.set_coords(np.asarray(msg["value"]))
    elif cmd == ">CELL":
        eng.set_cell(np.asarray(msg["value"]))
    elif cmd == "@INIT_MD":
        eng.init_md()
    elif cmd == "@COORDS":
        eng.step(int(msg.get("n", 1)))
    elif cmd == "EXIT":
        return None
    else:
        return {"error": f"unknown command {cmd!r}"}
    return {"ok": True}


def serve(workdir: str = ".", host: str = "127.0.0.1", port: int = 8021,
          device="cuda", dtype: Optional[torch.dtype] = None,
          on_listen: Optional[Callable[[int], None]] = None):
    """Line-protocol TCP server: one JSON object per line, {"cmd":
    "<FORCES"} etc.; arrays as nested lists.  Serves one driver until it
    sends EXIT or closes; `on_listen(port)` is called once the socket
    listens (port 0 picks a free one)."""
    eng = MDIEngine(workdir, device=device, dtype=dtype)
    with socket.create_server((host, port)) as srv:
        bound = srv.getsockname()[1]
        print(f"MDI engine listening on {host}:{bound}")
        if on_listen is not None:
            on_listen(bound)
        conn, _ = srv.accept()
        with conn, conn.makefile("rw") as f:
            for line in f:
                try:
                    out = _reply(eng, json.loads(line))
                except Exception as e:  # the loop outlives a bad command
                    out = {"error": str(e)}
                f.write(json.dumps({"ok": True} if out is None else out)
                        + "\n")
                f.flush()
                if out is None:
                    break


def serve_libmdi(workdir: str = ".", mdi_options: str = "",
                 lib_path: Optional[str] = None, max_commands: int = 0,
                 device="cuda", dtype: Optional[torch.dtype] = None):
    """The reference's MDI engine loop over the MolSSI MDI library via
    ctypes (ref: src/main_mdi/mdi_stub.cu:49-246): <NATOMS, >COORDS,
    <COORDS, >FORCES (integrates one step with external forces), <FORCES,
    <ENERGY, >ENERGY, >STRESS, EXIT.  The datatype codes and
    MDI_COMMAND_LENGTH are read from the loaded library, so any libmdi ABI
    works.  Library discovery: `lib_path`, then $MDI_LIBRARY, then
    ctypes.util.find_library("mdi"); without one this raises (`serve()` is
    the dependency-free alternative).  Returns the commands served."""
    import ctypes
    import ctypes.util

    path = (lib_path or os.environ.get("MDI_LIBRARY")
            or ctypes.util.find_library("mdi"))
    if not path:
        raise RuntimeError(
            "serve_libmdi: no MDI library found (set MDI_LIBRARY); "
            "use gpumd_tpu_torch.app.mdi.serve() for the JSON protocol")
    lib = ctypes.CDLL(path)

    def const(name, default):
        try:
            return int(ctypes.c_int.in_dll(lib, name).value)
        except ValueError:
            return default

    cmd_len = const("MDI_COMMAND_LENGTH_", const("MDI_COMMAND_LENGTH", 12))
    mdi_int = const("MDI_INT_", const("MDI_INT", 0))
    mdi_double = const("MDI_DOUBLE_", const("MDI_DOUBLE", 1))

    # MDI_Init: modern builds take an options string; older take argc/argv
    opts = f"-role ENGINE -name gpumd_tpu_torch {mdi_options}".strip().encode()
    try:
        lib.MDI_Init.argtypes = [ctypes.c_char_p]
        ret = lib.MDI_Init(opts)
    except (ctypes.ArgumentError, OSError):
        ret = 1
    if ret != 0:
        argv_strings = [b"gpumd_tpu_torch"] + opts.split()
        argc = ctypes.c_int(len(argv_strings))
        argv_arr = (ctypes.c_char_p * len(argv_strings))(*argv_strings)
        argv_p = ctypes.cast(ctypes.pointer(argv_arr), ctypes.POINTER(
            ctypes.POINTER(ctypes.c_char_p)))
        lib.MDI_Init.argtypes = []
        ret = lib.MDI_Init(ctypes.byref(argc), argv_p)
        if ret != 0:
            raise RuntimeError(f"MDI_Init failed ({ret})")

    for cmd in (b"<NATOMS", b">COORDS", b"<COORDS", b">FORCES", b"<FORCES",
                b"<ENERGY", b">ENERGY", b">STRESS", b"EXIT"):
        try:
            lib.MDI_Register_node(b"@DEFAULT")
            lib.MDI_Register_command(b"@DEFAULT", cmd)
        except AttributeError:
            break

    eng = MDIEngine(workdir, device=device, dtype=dtype)
    comm = ctypes.c_int(0)
    if lib.MDI_Accept_communicator(ctypes.byref(comm)) != 0:
        raise RuntimeError("MDI_Accept_communicator failed")

    n = eng.get_natoms()
    buf = ctypes.create_string_buffer(cmd_len + 1)

    def send(arr):
        a = np.ascontiguousarray(arr, np.float64)
        lib.MDI_Send(a.ctypes.data_as(ctypes.c_void_p), a.size, mdi_double,
                     comm)

    def recv(count):
        arr = (ctypes.c_double * count)()
        lib.MDI_Recv(arr, count, mdi_double, comm)
        return np.frombuffer(arr, np.float64).copy()

    served = 0
    while True:
        if lib.MDI_Recv_command(buf, comm) != 0:
            break
        cmd = buf.value.decode(errors="replace")
        served += 1
        if cmd == "<NATOMS":
            v = ctypes.c_int(n)
            lib.MDI_Send(ctypes.byref(v), 1, mdi_int, comm)
        elif cmd == ">COORDS":
            eng.set_coords(recv(3 * n).reshape(n, 3))
        elif cmd == "<COORDS":
            send(eng.get_coords())
        elif cmd == "<FORCES":
            send(eng.get_forces())
        elif cmd == ">FORCES":
            eng.step_with_forces(recv(3 * n).reshape(n, 3)
                                 * (HARTREE / BOHR))
        elif cmd == "<ENERGY":
            send(np.array([eng.get_energy()]))
        elif cmd == ">ENERGY":
            eng.external_energy = float(recv(1)[0]) * HARTREE
        elif cmd == ">STRESS":
            eng.external_stress = recv(9).reshape(3, 3)
        elif cmd == "EXIT":
            break
        if max_commands and served >= max_commands:
            break
    return served


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default=".")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8021)
    ap.add_argument("--libmdi", nargs=argparse.REMAINDER, default=None,
                    help="serve through libmdi; the rest are MDI options")
    args = ap.parse_args(argv)
    if args.libmdi is not None:
        serve_libmdi(args.workdir, mdi_options=" ".join(args.libmdi),
                     device=args.device)
    else:
        serve(args.workdir, host=args.host, port=args.port,
              device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
