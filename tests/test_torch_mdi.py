"""The port's MDI engine (gpumd_tpu_torch/app/mdi.py) against the JAX
package's on the CPU in float64, on rattled LJ argon 32: energy, forces,
stress and coords within 1e-10 (atomic units) of JAX's engine, after a
`>COORDS` too; five MD steps and a step on external forces alike.  After a
`>CELL` the port plans its force field anew and equals an engine started
on that cell, where JAX's keeps the first cell's plan and loses pairs
(ROADMAP queue 3).  `serve()` answers the JSON protocol over a loopback
socket, and `serve_libmdi` runs the reference's command loop through a
scripted MDI library (tests/mdi_stub.c, built with cc), recording what
the JAX engine records."""

import json
import queue
import socket
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from gpumd_tpu.app import mdi as jmdi
from gpumd_tpu.io.xyz import XYZFrame, write_xyz
from gpumd_tpu_torch.app import mdi as tmdi
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

A0 = 5.26
TOL = 1e-10
STUB = Path(__file__).with_name("mdi_stub.c")


def deck(d, scale=1.0):
    """Rattled fcc argon 32 (2^3 cells), the repo's LJ line, an NVE deck
    of 5 fs steps: its positions."""
    d.mkdir()
    a0 = A0 * scale
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    cells = np.array([[i, j, k] for i in range(2) for j in range(2)
                      for k in range(2)])
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    pos = pos + np.random.default_rng(1).normal(0, 0.05 * scale, pos.shape)
    write_xyz(str(d / "model.xyz"), XYZFrame(
        symbols=["Ar"] * len(pos), positions=pos,
        lattice=np.diag([2 * a0] * 3), pbc=(True,) * 3))
    (d / "lj.txt").write_text("lj 1 Ar\n1.032e-2 3.405 9.0\n")
    (d / "run.in").write_text("potential lj.txt\ntime_step 5\n"
                              "ensemble nve\n")
    return pos


def engine(d):
    return tmdi.MDIEngine(str(d), device="cpu", dtype=torch.float64)


def readings(eng):
    return {"energy": np.array([eng.get_energy()]),
            "forces": eng.get_forces(), "stress": eng.get_stress(),
            "coords": eng.get_coords()}


def assert_readings(got, want, tol=TOL):
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.abs(got[k] - want[k]).max() <= tol, k


def test_engine_matches_jax(tmp_path):
    pos = deck(tmp_path / "jax")
    deck(tmp_path / "torch")
    je, te = jmdi.MDIEngine(str(tmp_path / "jax")), engine(tmp_path / "torch")
    assert te.get_natoms() == je.get_natoms() == 32
    assert_readings(readings(te), readings(je))
    moved = pos.copy()
    moved[0, 0] += 0.4
    for e in (je, te):
        e.set_coords(moved / jmdi.BOHR)
    assert_readings(readings(te), readings(je))
    for e in (je, te):
        e.step(5)
    assert_readings(readings(te), readings(je))
    ext = np.random.default_rng(2).normal(0, 0.05, (32, 3))
    for e in (je, te):
        e.step_with_forces(ext)
    np.testing.assert_allclose(te.get_coords(), je.get_coords(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(te.session.state.velocity.numpy(),
                               np.asarray(je.session.state.velocity),
                               rtol=0, atol=TOL)


def test_cell_change_plans_the_lists_anew(tmp_path):
    """A `>CELL` to 0.7 of the cell (with the coordinates scaled): the
    port equals an engine started there; the JAX engine keeps MN 256 of
    the first cell, truncates rows and departs from its own fresh
    engine's forces by most of their size."""
    pos = deck(tmp_path / "jax")
    deck(tmp_path / "torch")
    deck(tmp_path / "jax_fresh", 0.7)
    deck(tmp_path / "torch_fresh", 0.7)
    cell = np.diag([2 * A0 * 0.7] * 3) / jmdi.BOHR
    je, te = jmdi.MDIEngine(str(tmp_path / "jax")), engine(tmp_path / "torch")
    for e in (je, te):
        e.set_cell(cell)
        e.set_coords(pos * 0.7 / jmdi.BOHR)
    fresh = readings(engine(tmp_path / "torch_fresh"))
    assert_readings(readings(te), fresh, tol=1e-12)
    jf = jmdi.MDIEngine(str(tmp_path / "jax_fresh")).get_forces()
    assert np.abs(je.get_forces() - jf).max() > 0.5 * np.abs(jf).max()
    assert te.session.ff.neighbor.mn > je.session.ff.neighbor.mn == 256


def test_serve_over_loopback(tmp_path):
    d = tmp_path / "serve"
    pos = deck(d)
    deck(tmp_path / "direct")
    ports = queue.Queue()
    server = threading.Thread(target=tmdi.serve, kwargs=dict(
        workdir=str(d), port=0, device="cpu", dtype=torch.float64,
        on_listen=ports.put), daemon=True)
    server.start()
    moved = (pos + 0.1) / jmdi.BOHR
    with socket.create_connection(("127.0.0.1", ports.get(timeout=60))) \
            as conn, conn.makefile("rw") as f:
        def ask(**msg):
            f.write(json.dumps(msg) + "\n")
            f.flush()
            return json.loads(f.readline())

        assert ask(cmd="<NATOMS") == {"value": 32}
        assert ask(cmd=">COORDS", value=moved.tolist()) == {"ok": True}
        forces = np.asarray(ask(cmd="<FORCES")["value"])
        assert ask(cmd="@COORDS", n=5) == {"ok": True}
        coords = np.asarray(ask(cmd="<COORDS")["value"])
        assert "error" in ask(cmd="<NOPE")
        assert ask(cmd="EXIT") == {"ok": True}
    server.join(timeout=60)
    assert not server.is_alive()
    eng = engine(tmp_path / "direct")
    eng.set_coords(moved)
    np.testing.assert_allclose(forces, eng.get_forces(), rtol=0, atol=1e-15)
    eng.step(5)
    np.testing.assert_allclose(coords, eng.get_coords(), rtol=0, atol=1e-12)


def records(path):
    """The stub's record: each MDI_Send's values."""
    data, off, out = path.read_bytes(), 0, []
    while off < len(data):
        count, dtype = struct.unpack_from("<ii", data, off)
        off += 8
        size = count * (8 if dtype == 1 else 4)
        out.append(np.frombuffer(data[off:off + size],
                                 np.float64 if dtype == 1 else np.int32))
        off += size
    return out


def test_serve_libmdi_records_what_jax_records(tmp_path, monkeypatch):
    so = tmp_path / "libfake_mdi.so"
    subprocess.run(["cc", "-shared", "-fPIC", "-o", str(so), str(STUB)],
                   check=True)
    seq = "<NATOMS,<COORDS,<FORCES,<ENERGY,>FORCES,<COORDS,>STRESS,EXIT"
    monkeypatch.setenv("FAKE_MDI_SEQ", seq)
    got = {}
    for pkg, serve in (("jax", jmdi.serve_libmdi),
                       ("torch", tmdi.serve_libmdi)):
        deck(tmp_path / pkg)
        monkeypatch.setenv("FAKE_MDI_OUT", str(tmp_path / f"{pkg}.bin"))
        kw = {} if pkg == "jax" else {"device": "cpu",
                                      "dtype": torch.float64}
        assert serve(str(tmp_path / pkg), lib_path=str(so), **kw) == 8
        got[pkg] = records(tmp_path / f"{pkg}.bin")
    assert len(got["torch"]) == len(got["jax"]) == 5
    assert got["torch"][0][0] == 32
    for a, b in zip(got["torch"][1:], got["jax"][1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    # the >FORCES step moved the atoms
    assert np.abs(got["torch"][4] - got["torch"][1]).max() > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_engine_defaults_to_the_card(tmp_path):
    deck(tmp_path / "d")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmdi.MDIEngine(str(tmp_path / "d"))


def test_module_entry_runs_the_libmdi_loop(tmp_path, monkeypatch):
    """`python -m gpumd_tpu_torch.app.mdi DIR --device cpu --libmdi OPTS`:
    the library from $MDI_LIBRARY, the default command script served."""
    so = tmp_path / "libfake_mdi.so"
    subprocess.run(["cc", "-shared", "-fPIC", "-o", str(so), str(STUB)],
                   check=True)
    deck(tmp_path / "d")
    monkeypatch.setenv("MDI_LIBRARY", str(so))
    monkeypatch.setenv("FAKE_MDI_OUT", str(tmp_path / "rec.bin"))
    monkeypatch.delenv("FAKE_MDI_SEQ", raising=False)
    tmdi.main([str(tmp_path / "d"), "--device", "cpu", "--libmdi",
               "-method", "TEST"])
    natoms, forces, energy = records(tmp_path / "rec.bin")
    assert natoms[0] == 32 and forces.shape == (96,)
    assert np.isfinite(forces).all() and energy[0] < 0.0
