"""Extended-XYZ reader/writer (model.xyz / train.xyz / dump files).

Counterpart of gpumd_tpu/io/xyz.py.  Format per the reference (ref:
src/model/read_xyz.cu:163-330 and src/main_nep/structure.cu):

  line 1: N
  line 2: key=value attributes; quoted values may contain spaces.
          Lattice="ax ay az bx by bz cx cy cz" (rows = lattice vectors)
          Properties=species:S:1:pos:R:3[:mass:R:1][:charge:R:1]
                      [:vel:R:3][:group:I:k][:force(s):R:3]
          pbc="T T F"   energy=...  virial="9 floats"  stress="..."
          weight=... energy_weight=... temperature=... config_type=...
  lines 3..N+2: whitespace-separated columns per Properties.

A numpy host module.  Frames of NATIVE_MIN_ROWS atoms or more are parsed
by the C++ row parser (gpumd_tpu_torch/native/xyz_native.cpp, built with
g++ at first use), as the JAX package parses them; a frame it cannot
parse (a token that is not a number, a short row) falls through to the
Python rows, which report the fault.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from gpumd_tpu_torch.elements import MASS_TABLE


@dataclass
class XYZFrame:
    """One extended-XYZ frame (host-side numpy)."""

    symbols: List[str]
    positions: np.ndarray  # (N, 3)
    lattice: Optional[np.ndarray] = None  # (3, 3) rows = a, b, c
    pbc: tuple = (True, True, True)
    masses: Optional[np.ndarray] = None
    charges: Optional[np.ndarray] = None
    velocities: Optional[np.ndarray] = None
    forces: Optional[np.ndarray] = None
    groups: Optional[np.ndarray] = None  # (N, num_group_methods) int
    info: Dict[str, str] = field(default_factory=dict)
    # every parsed per-atom column (e.g. bec:R:9 for qNEP training)
    arrays: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def n_atoms(self) -> int:
        return len(self.symbols)

    def default_masses(self) -> np.ndarray:
        if self.masses is not None:
            return self.masses
        return np.array([MASS_TABLE[s] for s in self.symbols])


_TOKEN_RE = re.compile(r'(\S+)="([^"]*)"|(\S+)=(\S+)|(\S+)')


def _parse_comment(line: str) -> Dict[str, str]:
    """Parse key=value pairs; quoted values keep spaces. Case-insensitive keys
    (the reference lowercases keys before matching)."""
    out: Dict[str, str] = {}
    for m in _TOKEN_RE.finditer(line.strip()):
        if m.group(1) is not None:
            out[m.group(1).lower()] = m.group(2)
        elif m.group(3) is not None:
            out[m.group(3).lower()] = m.group(4)
        else:
            out[m.group(5).lower()] = ""
    return out


def _parse_properties(spec: str):
    """Split Properties=name:type:count triplets into (name, type, count)."""
    parts = spec.split(":")
    if len(parts) % 3 != 0:
        raise ValueError(f"Malformed Properties spec: {spec!r}")
    return [(parts[i].lower(), parts[i + 1].upper(), int(parts[i + 2]))
            for i in range(0, len(parts), 3)]


def read_xyz_frames(path: str, max_frames: Optional[int] = None
                    ) -> List[XYZFrame]:
    """Read one or more extended-XYZ frames from a file."""
    frames: List[XYZFrame] = []
    with open(path) as f:
        lines = f.readlines()
    i = 0
    n_lines = len(lines)
    while i < n_lines:
        line = lines[i].strip()
        if not line:
            i += 1
            continue
        n = int(line.split()[0])
        info = _parse_comment(lines[i + 1])
        body = lines[i + 2:i + 2 + n]
        if len(body) < n:
            raise ValueError(f"{path}: truncated frame at line {i + 1}")
        frames.append(_build_frame(n, info, body, path))
        i += 2 + n
        if max_frames is not None and len(frames) >= max_frames:
            break
    if not frames:
        raise ValueError(f"{path}: no frames found")
    return frames


def read_xyz(path: str) -> XYZFrame:
    """Read the first frame (model.xyz semantics)."""
    return read_xyz_frames(path, max_frames=1)[0]


# the native row parser takes frames of at least this many atoms (the
# Python loop costs ~5 us a token, the C strtod loop ~20 ns)
NATIVE_MIN_ROWS = 4096


def _parse_native(n: int, props, body: List[str]):
    """(symbols, arrays) from the C++ row parser, or None when a row does
    not parse."""
    import ctypes

    from gpumd_tpu_torch.native import xyz_native

    n_cols = sum(count for _, _, count in props)
    species_col, col = -1, 0
    for name, _, count in props:
        if name == "species":
            species_col = col
        col += count
    buf = "".join(body).encode()
    species = ctypes.create_string_buffer(max(n * 16, 16))
    numeric = np.empty((n, n_cols - (species_col >= 0)), np.float64)
    got = xyz_native().xyz_parse_mem(
        buf, len(buf), n, n_cols, species_col, species,
        numeric.ctypes.data_as(ctypes.c_void_p))
    if got != n:
        return None
    symbols: List[str] = []
    if species_col >= 0:
        symbols = np.frombuffer(species.raw[:n * 16], dtype="S16").astype(
            "U15").tolist()
    arrays: Dict[str, np.ndarray] = {}
    col = 0
    for name, typ, count in props:
        if name == "species":
            continue
        arr = numeric[:, col:col + count]
        col += count
        if typ == "I":
            arr = arr.astype(np.int64)
        arrays[name] = arr if count > 1 or name == "group" else arr[:, 0]
    return symbols, arrays


def _parse_body(props, body: List[str]):
    """Atom-line columns -> (symbols, arrays)."""
    if len(body) >= NATIVE_MIN_ROWS:
        parsed = _parse_native(len(body), props, body)
        if parsed is not None:
            return parsed
    symbols: List[str] = []
    arrays: Dict[str, np.ndarray] = {}
    cols = [ln.split() for ln in body]
    col = 0
    for name, typ, count in props:
        if name == "species":
            symbols = [c[col] for c in cols]
        else:
            if typ == "I":
                arr = np.array(
                    [[int(c[col + k]) for k in range(count)] for c in cols],
                    dtype=np.int64)
            else:
                arr = np.array(
                    [[float(c[col + k]) for k in range(count)] for c in cols])
            arrays[name] = (arr if count > 1 or name == "group"
                            else arr[:, 0])
        col += count
    return symbols, arrays


def _build_frame(n: int, info: Dict[str, str], body: List[str],
                 path: str) -> XYZFrame:
    props = _parse_properties(info.get("properties", "species:S:1:pos:R:3"))

    lattice = None
    if "lattice" in info:
        vals = [float(x) for x in info["lattice"].split()]
        if len(vals) != 9:
            raise ValueError(f"{path}: Lattice must have 9 numbers")
        lattice = np.array(vals).reshape(3, 3)

    pbc = (True, True, True)
    if "pbc" in info:
        pbc = tuple(t.upper() in ("T", "TRUE", "1")
                    for t in info["pbc"].split())

    symbols, arrays = _parse_body(props, body)
    positions = arrays.get("pos")
    if positions is None:
        raise ValueError(f"{path}: Properties must include pos:R:3")
    return XYZFrame(
        symbols=symbols, positions=positions, lattice=lattice, pbc=pbc,
        masses=arrays.get("mass"), charges=arrays.get("charge"),
        velocities=arrays.get("vel"),
        forces=arrays.get("force", arrays.get("forces")),
        groups=arrays.get("group"), info=info, arrays=arrays)


def write_xyz(path: str, frame: XYZFrame, append: bool = False,
              with_velocities: bool = False, with_forces: bool = False,
              with_masses: bool = False, with_groups: bool = False,
              extra_info: Optional[Dict[str, str]] = None):
    """Write one extended-XYZ frame (dump_exyz / dump_restart semantics)."""
    prop = "species:S:1:pos:R:3"
    if with_masses and frame.masses is not None:
        prop += ":mass:R:1"
    if with_velocities and frame.velocities is not None:
        prop += ":vel:R:3"
    if with_forces and frame.forces is not None:
        prop += ":forces:R:3"
    if with_groups and frame.groups is not None:
        prop += f":group:I:{frame.groups.shape[1]}"

    parts = []
    if frame.lattice is not None:
        lat = " ".join(f"{x:.15g}" for x in np.asarray(frame.lattice).ravel())
        parts.append(f'Lattice="{lat}"')
    parts.append(f"Properties={prop}")
    pb = " ".join("T" if p else "F" for p in frame.pbc)
    parts.append(f'pbc="{pb}"')
    for k, v in (extra_info or {}).items():
        parts.append(f"{k}={v}")

    with open(path, "a" if append else "w") as f:
        f.write(f"{frame.n_atoms}\n")
        f.write(" ".join(parts) + "\n")
        for i in range(frame.n_atoms):
            row = [f"{frame.symbols[i]:<2s}"]
            row += [f"{x:.15g}" for x in frame.positions[i]]
            if with_masses and frame.masses is not None:
                row.append(f"{frame.masses[i]:.15g}")
            if with_velocities and frame.velocities is not None:
                row += [f"{x:.15g}" for x in frame.velocities[i]]
            if with_forces and frame.forces is not None:
                row += [f"{x:.15g}" for x in frame.forces[i]]
            if with_groups and frame.groups is not None:
                row += [str(int(g)) for g in frame.groups[i]]
            f.write(" ".join(row) + "\n")
