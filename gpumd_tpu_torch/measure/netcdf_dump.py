"""AMBER-convention NetCDF trajectory writer (dump_netcdf).

Counterpart of gpumd_tpu/measure/netcdf_dump.py, the rebuild of the
reference's NetCDF dump (ref: src/measure/dump_netcdf.cu:86-520): AMBER 1.0 trajectory layout —
unlimited `frame` dimension, `coordinates` (frame, atom, spatial),
`cell_lengths`/`cell_angles`, `time` in picoseconds — plus the GPUMD
extensions (`type` per frame, group metadata as global attributes,
selectable float/double precision).  Instead of linking libnetcdf, frames
are buffered and written with scipy's pure-python NetCDF-3 writer
(functionally equivalent for the classic AMBER format; compression is a
NetCDF-4 feature and is ignored with a note).

Positions/velocities are rotated into the restricted AMBER cell frame
(a along +x, b in xy; ref: :440-520) so readers reconstruct the correct
triclinic geometry.
"""

from __future__ import annotations

import numpy as np

from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION


def cell_to_restricted(h: np.ndarray):
    """(lengths, angles_deg, transform) of the AMBER restricted cell.
    `h` columns are the lattice vectors; transform rows are the restricted
    axes in original Cartesian coordinates (ref: dump_netcdf.cu:440-520)."""
    a, b, c = h[:, 0], h[:, 1], h[:, 2]
    la, lb, lc = np.linalg.norm(a), np.linalg.norm(b), np.linalg.norm(c)
    clamp = lambda x: np.clip(x, -1.0, 1.0)
    alpha = np.degrees(np.arccos(clamp(np.dot(b, c) / (lb * lc))))
    beta = np.degrees(np.arccos(clamp(np.dot(a, c) / (la * lc))))
    gamma = np.degrees(np.arccos(clamp(np.dot(a, b) / (la * lb))))
    t = np.zeros((3, 3))
    t[0] = a / la
    bperp = b - np.dot(b, t[0]) * t[0]
    t[1] = bperp / np.linalg.norm(bperp)
    t[2] = np.cross(t[0], t[1])
    return (
        np.array([la, lb, lc]),
        np.array([alpha, beta, gamma]),
        t,
    )


class DumpNetCDF:
    """Frame buffer + writer for one `dump_netcdf` request."""

    def __init__(self, path: str, has_velocity: bool, precision: str = "double",
                 grouping_method: int = -1, group_id: int = -1):
        self.path = path
        self.has_velocity = has_velocity
        self.dtype = np.float32 if precision == "single" else np.float64
        self.grouping_method = grouping_method
        self.group_id = group_id
        self.frames = []

    def add_frame(self, time_ps, positions, types, h, velocities=None):
        lengths, angles, t = cell_to_restricted(np.asarray(h, np.float64))
        pos = np.asarray(positions, np.float64) @ t.T
        vel = None
        if self.has_velocity and velocities is not None:
            # natural -> A/ps (AMBER convention)
            vel = (
                np.asarray(velocities, np.float64)
                / TIME_UNIT_CONVERSION * 1000.0
            ) @ t.T
        self.frames.append(
            (float(time_ps), pos.astype(self.dtype), np.asarray(types),
             lengths, angles, vel)
        )

    def write(self):
        from scipy.io import netcdf_file

        if not self.frames:
            return
        n = self.frames[0][1].shape[0]
        f = netcdf_file(self.path, "w", version=2)
        f.program = "GPUMD"
        f.programVersion = "gpumd_tpu_torch"
        f.Conventions = "AMBER"
        f.ConventionVersion = "1.0"
        f.gpumd_grouping_method = np.int32(self.grouping_method)
        f.gpumd_group_id = np.int32(self.group_id)
        f.createDimension("frame", None)
        f.createDimension("spatial", 3)
        f.createDimension("atom", n)
        f.createDimension("cell_spatial", 3)
        f.createDimension("cell_angular", 3)
        f.createDimension("label", 10)

        v = f.createVariable("spatial", "c", ("spatial",))
        v[:] = list("xyz")
        v = f.createVariable("cell_spatial", "c", ("cell_spatial",))
        v[:] = list("abc")
        v = f.createVariable("cell_angular", "c", ("cell_angular", "label"))
        for i, s in enumerate(("alpha", "beta", "gamma")):
            v[i, : len(s)] = list(s)

        nf = len(self.frames)
        tv = f.createVariable("time", "d", ("frame",))
        tv.units = "picosecond"
        cl = f.createVariable("cell_lengths", "d", ("frame", "cell_spatial"))
        cl.units = "angstrom"
        ca = f.createVariable("cell_angles", "d", ("frame", "cell_angular"))
        ca.units = "degree"
        code = "f" if self.dtype == np.float32 else "d"
        cv = f.createVariable("coordinates", code, ("frame", "atom", "spatial"))
        cv.units = "angstrom"
        ty = f.createVariable("type", "i", ("frame", "atom"))
        vv = None
        if self.has_velocity:
            vv = f.createVariable(
                "velocities", code, ("frame", "atom", "spatial")
            )
            vv.units = "angstrom/picosecond"
        for i, (tt, pos, types, lengths, angles, vel) in enumerate(self.frames):
            tv[i] = tt
            cl[i] = lengths
            ca[i] = angles
            cv[i] = pos
            ty[i] = types
            if vv is not None and vel is not None:
                vv[i] = vel.astype(self.dtype)
        f.close()
