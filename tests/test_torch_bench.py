"""The port's twins of bench.py, scripts/drift_gate.py and
scripts/hnemd_kappa_sanity.py, on the CPU at a tiny size.

Each mode of `gpumd_tpu_torch.bench` (nep, npt, hnemd, tersoff; the nep
mode also on the full-window and list rungs) runs 2 timed steps with device="cpu"
and prints one well-formed JSON line with bench.py's metric name, and
each engine picks its rung; the drift and kappa twins run a few steps in
blocks of 1-2 and print their scripts' JSON lines.  The numbers are CPU timings of the plain
versions and mean nothing; on the card the same entry points run the
kernels.
"""

import json

import pytest

from gpumd_tpu_torch import bench
from gpumd_tpu_torch.scripts import drift_gate, hnemd_kappa_sanity
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("mode,engine,n", [
    ("nep", "compact", 1000), ("nep", "windows", 1000),
    ("nep", "list", 1000),
    ("npt", "compact", 1000), ("hnemd", "compact", 1000),
    ("tersoff", "compact", 216)])
def test_bench_modes_print_their_json_line(monkeypatch, capsys, mode,
                                           engine, n):
    monkeypatch.setenv("GPUMD_BENCH_N", str(n))
    monkeypatch.setenv("GPUMD_BENCH_STEPS", "2")
    monkeypatch.setenv("GPUMD_BENCH_MODE", mode)
    monkeypatch.setenv("GPUMD_BENCH_ENGINE", engine)
    r = bench.main(device="cpu")
    out = capsys.readouterr()
    line = _last_json(out.out)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == bench.METRICS[mode]
    assert line["unit"] == "atom_step_per_s_per_chip"
    assert line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 1e8)
    assert r["n"] == n and r["steps"] == 2 and r["peak_gib"] is None
    assert f"# N={n} steps=2" in out.err


@pytest.mark.parametrize("engine,cl,name", [("compact", True, "compact"),
                                            ("windows", False, "compact"),
                                            ("v2", None, "v2")])
def test_bench_engines_pick_their_rung(engine, cl, name):
    """GPUMD_BENCH_ENGINE picks the rung: compact candidate lists, full
    windows or the round-2 dense engine (which `run` drives as it drives
    the others)."""
    md, _, state, observer = bench.setup("nep", 1000, engine, device="cpu")
    assert md.engine == name and observer is None
    assert state.position.shape == (1000, 3)
    if cl is None:
        assert md.cplan is None
    else:
        assert (md.cplan.cl > 0) == cl


@pytest.mark.parametrize("mode,engine", [("nep", "dense"),
                                         ("hnemd", "v2"),
                                         ("tersoff", "windows"),
                                         ("list", "compact"),
                                         ("npt", "list"),
                                         ("hnemd", "list"),
                                         ("tersoff", "list")])
def test_bench_refuses_what_it_does_not_run(monkeypatch, mode, engine):
    """No fallback: an unknown engine or mode, HNEMD on v2, Tersoff on
    another rung and the list rung outside the nep mode raise."""
    with pytest.raises(ValueError):
        bench.setup(mode, 1000, engine, device="cpu")


def test_bench_list_rung_is_bench_py_s():
    """GPUMD_BENCH_ENGINE=list: bench.py's list rung, a ForceField with MN
    112, skin 1.0 and total virials, under NVE."""
    from gpumd_tpu_torch.forcefield import ForceField
    from gpumd_tpu_torch.integrate.ensembles.nve import NVE

    ff, ens, state, observer = bench.setup("nep", 1000, "list", device="cpu")
    assert isinstance(ff, ForceField) and isinstance(ens, NVE)
    assert observer is None and state.position.shape == (1000, 3)
    assert ff.neighbor.mn == 112 and ff.skin == 1.0
    assert ff.neighbor.rc == 9.0 and not ff.per_atom_virial


@pytest.mark.parametrize("over_at", [6, None])
def test_bench_list_rung_refuses_an_overflow_at_a_middle_rebuild(
        monkeypatch, over_at):
    """At skin 1e-4 A every step rebuilds: the warm state's cache is the
    1st, the warm-up block's 3 steps make the 2nd-4th and the timed
    block's the 5th-7th.  An over-full row in the 6th cache, which the
    7th (final) one replaces, refuses the run; without it the run
    passes."""
    from gpumd_tpu_torch.forcefield import ForceField

    real = ForceField.refresh_cache
    made = []

    def refresh_cache(self, state):
        cache = real(self, state)
        made.append(cache)
        if len(made) == over_at:
            cache = cache._replace(count=cache.count + self.neighbor.mn)
        return cache

    monkeypatch.setattr(ForceField, "refresh_cache", refresh_cache)
    if over_at is None:
        assert bench.run("nep", 1000, 3, "list", skin=1e-4,
                         device="cpu")["steps"] == 3
    else:
        with pytest.raises(RuntimeError, match="overflow"):
            bench.run("nep", 1000, 3, "list", skin=1e-4, device="cpu")
    assert len(made) == 7
    assert not bool((made[-1].count > 112).any())


def test_drift_twin_prints_its_json_line(monkeypatch, capsys):
    monkeypatch.setenv("GPUMD_DRIFT_N", "1000")
    monkeypatch.setenv("GPUMD_DRIFT_PS", "0.003")
    r = drift_gate.main(device="cpu", block=1)
    line = _last_json(capsys.readouterr().out)
    assert line == r
    assert line["metric"] == "nve_drift" and line["n_atoms"] == 1000
    assert line["sim_ps"] == pytest.approx(0.003)
    assert line["gate"] == 1e-5 and isinstance(line["pass"], bool)
    assert line["unit"] == "eV_per_atom_per_ns" and line["value"] >= 0


def test_kappa_twin_prints_its_json_line(monkeypatch, capsys):
    monkeypatch.setenv("GPUMD_KAPPA_N", "1000")
    monkeypatch.setenv("GPUMD_KAPPA_EQ", "2")
    monkeypatch.setenv("GPUMD_KAPPA_STEPS", "4")
    r = hnemd_kappa_sanity.main(device="cpu", block=2)
    line = _last_json(capsys.readouterr().out)
    assert line == r
    assert line["metric"] == "hnemd_kappa_pbte_300K"
    assert line["steps"] == 4 and line["fe_per_A"] == 1e-4
    assert set(line) == {"metric", "kappa_x_W_per_mK", "kappa_x_half_window",
                         "n_atoms", "steps", "fe_per_A",
                         "throughput_atom_step_per_s"}
