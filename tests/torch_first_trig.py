"""The first f64 cos and sin of a process in torch's CPU build.

In torch 2.13's CPU build the first f64 torch.cos over more elements than
one thread's grain in a fresh process now and then returns, in the part a
worker thread computes, values ~1e-8 off those the same call returns when
made again.  The port's CPU tests hold f64 plain versions that use cos and
sin against the JAX package at rtol 1e-9 and tighter, so each test module
that does so imports `warm_torch_transcendentals`: an autouse fixture that
makes one such call of each before any comparison.  It makes them in f32
too: in one run of the whole suite under pytest-xdist, the f32 torch.cos
of test_torch_probes.py's transcendental check read up to 1.5e-4 off (in
every row but the first, as a worker thread's part) and failed its 1e-6
gate; 480 fresh f32 processes, loaded or not, did not repeat it.

Run as a script, this module reproduces the fault with torch alone: it
starts fresh processes that each compute torch.cos over 36,864 random f64
elements twice, cold or after the fixture's warm-up, and counts the
processes whose two results differ:

    python tests/torch_first_trig.py --procs 200 --workers 4
"""

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

N_ELEMENTS = 9 * 32 * 128

_CHILD = f"""
import sys
import torch
if sys.argv[1] == "warm":
    x = torch.zeros(1 << 17, dtype=torch.float64)
    torch.cos(x)
    torch.sin(x)
g = torch.Generator().manual_seed(int(sys.argv[2]))
x = torch.rand({N_ELEMENTS}, dtype=torch.float64, generator=g) * 3.0
d = (torch.cos(x) - torch.cos(x)).abs()
print(int((d > 0).sum()), float(d.max()))
"""


@pytest.fixture(scope="module", autouse=True)
def warm_torch_transcendentals():
    """One torch.cos and torch.sin over more elements than a thread's
    grain, in f64 and in f32, before the module's first comparison."""
    for dtype in (torch.float64, torch.float32):
        x = torch.zeros(1 << 17, dtype=dtype)
        torch.cos(x)
        torch.sin(x)


def _child(mode: str, seed: int):
    out = subprocess.run([sys.executable, "-c", _CHILD, mode, str(seed)],
                         capture_output=True, text=True, check=True)
    n_diff, dmax = out.stdout.split()
    return int(n_diff), float(dmax)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=200,
                    help="fresh processes for each mode")
    ap.add_argument("--workers", type=int, default=4,
                    help="processes run at once")
    args = ap.parse_args(argv)
    report = {"torch": torch.__version__, "elements": N_ELEMENTS,
              "threads": torch.get_num_threads()}
    with ThreadPoolExecutor(args.workers) as pool:
        for mode in ("cold", "warm"):
            res = list(pool.map(lambda s, m=mode: _child(m, s),
                                range(args.procs)))
            bad = [r for r in res if r[0]]
            report[mode] = {
                "procs": args.procs, "procs_differing": len(bad),
                "elements_differing_max": max((r[0] for r in bad), default=0),
                "max_abs_diff": max((r[1] for r in res), default=0.0)}
            print(f"[first_trig] {mode}: {len(bad)} of {args.procs} fresh "
                  f"processes gave two different cos results; "
                  f"{report[mode]}")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
