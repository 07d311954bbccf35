#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (gpumd_tpu_torch) on one NVIDIA GPU.

Drives the port's main path, NEP molecular dynamics of rocksalt PbTe under
NVE on the compact engine (DenseNEPMD), with the trained NEP4 Te/Pb model
in artifacts/trainer_parity_r5_nep.txt at its full width, in float32, on
both of its rungs: compact candidate lists (the default; the kept window
lanes are gathered by compact_rows from the ghost rows, or by
compact_windows from packed windows on plans that rows_compact_eligible
rejects) and full windows (compact_lists=False), and then the same path
under NPT, under HNEMD and over a 10 ps drift run (phases 3a-3c).
Phases:

  1. build   compile the CUDA kernels from gpumd_tpu_torch/csrc with nvcc
             (one process per source, all at once); print the build time
             and the card's name and power limit
  2. kernels at 32,768 atoms jittered by 0.1 A, three pipeline passes
             (first, what the K1/K2 design acts on: ptxas's registers,
             stack frame and spills of the model's template instances,
             their shared memory and resident blocks an SM):
             the default plan (cap 56, compact_windows), the same state on
             a plan made from the unjittered lattice (cap 64,
             compact_rows) and the full-window rung; each kernel against
             its plain torch version on the tensors of its pass (K2, the
             scatter and the fold with per-atom virials off and on, 4 and
             12 channels, as the HNEMD path gives them); the compactions
             bit for bit, and compact_rows == compact_windows of the
             packed window on the rows pass; after each pass at 4 and at
             12 channels a [design] line for the scatter (ptxas, shared
             memory a CTA, CTAs an SM by the occupancy query, channels a
             CTA, grid, ms, TB/s, share of its byte bound)
  3. md      32,768 atoms, 300 K, dt 1 fs: 200 NVE steps on the default
             rung from the lattice (compact_rows), 50 from the jittered
             state (compact_windows) and 50 on the full-window rung: finite,
             no overflow, energy conserved, every kernel of each path
             launched on every step; after 20 steps the default rung
             tracks its all-plain run and the full-window rung
 3a. npt-md  32,768 atoms on the default rung (BASELINE config 3 as
             written): 200 steps under NPTBerendsen with bench.py's
             coupling (40 GPa, tau_p 1000) and 200 under NPTSCR (BDP noise
             from a seeded generator): finite, no overflow, the box
             rescaled (its change printed), K1/K2/scatter/fold and
             compact_rows launched on every step; after 20 steps each
             tracks its all-plain run (same seed, same noise)
 3b. hnemd-md  HNEMD (BASELINE config 4's path: per-atom virials, the
             driving force (1e-4, 0, 0) 1/A, NVE), 100 steps with the
             heat-current observer and an SHC measure on the card, on
             PbTe 32,768 (default rung; K2, scatter and fold at 12
             channels) and on Si 32,768 Tersoff (its route, fused or not,
             and shared memory printed): finite, the SHC file well formed;
             after 20 steps positions and the observer's J track the
             all-plain run
 3c. drift   the NVE drift gate: 10 ps (10 blocks of 1000 steps) of
             PbTe 32,768 with compensated positions and velocities
             (scripts/drift_gate.py's twin): drift in eV/atom/ns, failing
             above 1e-5, on overflow or a non-finite energy
 3d. list-md the general path (ForceField + integrate/run.py, plain
             torch, none of the hand-written kernels: the phase fails if
             one launches): LJ argon 4,000 (BASELINE config 1, the repo's
             lj.txt, MN 160, skin 1.0, 80 K, 2 fs), its neighbour plan
             printed, 200 NVE steps (finite, no overflow, |dE| within
             2e-3 eV/(fs^2 atom) dt^2 N) and after 20 steps within 1e-3 A
             of the same run on the CPU in f64; NEP PbTe 32,768 jittered
             by 0.1 A on the list path (MN 112, skin 1.0, per-atom
             virials): its first force pass against the compact rung's
             (forces within 1e-3 of max |F|, per-atom energies and the
             total virial within 1e-4), 200 NVE steps conserving energy,
             and after 20 steps within 1e-3 A of the compact rung; the
             three neighbour builders and the reverse map on a jittered
             4,096-atom box in f64, the card's lists against the CPU's
 3e. train   BASELINE config 5, the NEP trainers through their entry
             points at config 5's width (nep.in "type 2 Te Pb", every
             other keyword at its default: D 3,033, population 50), plain
             torch (the phase fails if a hand-written kernel launches
             outside its MD run): a synthetic PbTe set (25 rocksalt
             frames of 216 atoms, a0 6.46 A x U(0.97, 1.03), jittered
             0.1 A) labelled by the trained model through the list path
             in f64; batched_forward in f32 at the model's weights
             against the labels (RMSE of E, F, V within their bounds) and
             the chunked population evaluate against single evaluations;
             app.nep.main for 20 SNES generations (loss.out rows 10 and
             20 of 10 columns; s/generation, the population chunk, peak
             memory), the written nep.txt in DenseNEPMD for 20 NVE steps
             of 4,096 PbTe (finite, energy gate, K1/K2/scatter/fold every
             step), a resume to generation 30 (the third row numbered
             30); app.gnep.main for 3 epochs (s/epoch, peak memory), and
             a run stopped after 2 and resumed against it
  4. time    262,144 atoms, 50 steps of each rung after warm-up
             (atom-step/s, the cost of the per-step host sync, a device
             profile of 5 steps): the default rung from the lattice
             (compact_rows; also its live centre lanes and live pair slots
             against those inside the cutoffs) and from the jittered state
             (compact_windows),
             and the full-window rung; every kernel at those shapes against
             its plain version and, where one PyTorch call computes the
             same function, that call (CUDA events), and for the fold a
             [design] line (ptxas, unit width, threads, rows, resident
             blocks an SM against the plan, TB/s), for the scatter one
             as in `kernels` (also at 12 channels on the HNEMD rung and,
             in `tersoff-time`, on the contract pvals); the wall time of one
             rebuild on each, and 500 more steps of the lattice-start runs
             with their rebuilds counted and included; the default rung
             under NPTBerendsen (a device profile; then NVE and NPT in
             turns in one process, blocks of 20 steps with their ms/step
             and rebuilds, and the host time of a step of each by
             operator, torch.profiler's CPU side) and under HNEMD with its
             observer (a device profile, peak memory, and K2, the scatter
             and the fold at 12 channels beside their plain versions,
             bounds and library calls); then 1,000,000 atoms on the
             default rung, 20 steps (atom-step/s, peak memory), and the
             bytes of K2's pvals, the scatter's dcand and the fold's drows
             with per-atom virials off and on; last the list rung (the
             general path, bench.py's: MN 112, skin 1.0, total virials) at
             262,144 atoms, 50 NVE steps after warm-up (atom-step/s, the
             rebuilds, one rebuild's time, the per-step sync, peak memory,
             a device profile of 5 steps) and LJ argon 4,000 (atom-step/s)

It then drives the dense-window engines on the same PbTe model: the
round-2 engine of DenseNEPMD(engine="v2") (kernels K1b and K2b, the path
engine="auto" takes for models the compact engine rejects) and the
round-1 force pass dense_nep_compute (the round-1 K1 and K2, here
dense_k1 and dense_k2):

  5. dense-kernels  32,768 atoms jittered by 0.1 A on the v2 plan (grid
             11^3, cap 40), then compressed to a0 5.6 A (each cell's
             live-pair queues take several pieces of the kernels'
             buffers): K1b and K2b on the tensors of one
             dense_nep_compute_v2 pass, dense_k1 and dense_k2 on those of
             one dense_nep_compute pass, each against its plain version
  6. dense-md       32,768 atoms, 300 K, dt 1 fs: 200 NVE steps on
             engine="v2" (finite, no overflow, energy conserved, K1b and
             K2b launched on every step); after 20 steps it tracks its
             all-plain run and the compact default rung; then the round-1
             pass, its counts from 0, on the state after 20 steps against
             dense_nep_compute_v2
  7. dense-time     262,144 atoms on v2: 50 steps after warm-up
             (atom-step/s, the host-sync cost, a device profile of 5
             steps), the four kernels at that shape beside their plain
             versions and bounds (the round-1 ones on a dense_nep_compute
             pass), a [design] line for each (ptxas, the block's cut and
             shared memory, blocks an SM, live pairs a centre, queue
             pieces a cell, TB/s), one rebuild; then 1,000,000 atoms, 20
             steps (atom-step/s, peak memory)

It then drives the third path, Tersoff-1989 MD of diamond Si on the
compact engine (CompactTersoffMD, full windows, BASELINE config 2), with the
published Si parameters (Phys. Rev. B 39, 5566 (1989)) written to a
temporary file and read by Tersoff1989.from_file, in float32:

  8. tersoff-kernels  32,768 Si jittered by 0.1 A: both modes of the
             tersoff kernel (contract: pvals; fused: the scatter inside)
             against their plain versions with per-atom virials off and
             on, the scatter at pch 4 and 12 on the contract mode's pvals
             and the fold on the cotangents; then both modes on 4,096 Si
             compressed to a0 4.1 A, where every centre has 16 live bonds
             and takes the kernel's general path (past the live cap)
  9. tersoff-md       32,768 Si, 300 K, dt 1 fs: 200 NVE steps (energy
             conserved, tersoff_scatter and fold launched every step,
             tersoff and scatter never), 100 NVT-NHC and 50 NVT-Berendsen
             steps (300 K, coupling 100); after 20 steps each run tracks
             its all-plain run; then 20 NVE steps of 4,096 Si on the
             default plan and at cap 320, a window (wl 8,704) too wide for
             the fused kernel's accumulator, whose steps take the contract
             kernel and the scatter (tersoff, scatter, fold every step)
             and track the default plan's
 10. tersoff-time     1,000,000 Si (bench.py's run_tersoff system, skin
             1.0): 50 steps after warm-up under NVE and under NVT-NHC
             (atom-step/s, the host-sync cost of each), a device profile
             of 5 NVE steps, the fused and contract tersoff kernels, the
             scatter on the contract mode's pvals and the fold at that
             shape beside their plain versions, bounds (from the shapes)
             and library calls; [design] lines for both tersoff modes
             (ptxas, shared memory, blocks an SM, live bonds a centre,
             centres past the live cap, TB/s) and the fold; one rebuild,
             peak memory

Last, the probes' path: the port's counterparts of the three probe scripts
(gpumd_tpu_torch/probes, kernels in csrc/probes.cu):

 11. probes   each probe kernel against its plain version on random inputs
             at the shapes the probes' path gives it (the gather at G 256,
             bit for bit; bench_mxu_probes at 1,734 blocks: every one-hot
             case, ksplit 1 and 4, TF32 and f32, and the f32 path's
             error against f64 at most twice f32 torch.matmul's; the
             feature matmul at ch 24 and 168; both pair-reduce orders,
             and the two equal bit for bit, also at 1024 and 300 lanes
             (the spill order in tiles of 256); the blocked gather at
             nblk 18 and 11 with indices out of range, at nblk 18 with the
             script's zero indices, at nblk 27 (past what one block's
             shared memory held when the whole window was staged) and
             nblk 1); then, counts from 0, the three entry points'
             main() at the scripts' geometry (the probes' path, which
             prints the scripts' keys); the transcendental gate (every
             kernel op within 1e-6 of f64); every probe timed beside its
             plain version, library call and bound (the one-hot dot's f32
             path also beside torch.matmul in full f32 and its own bound,
             three TF32 passes, beside the f32 FFMA formulation's); for
             the three wgmma kernels (the two TF32 products and the f32
             path, fed by a ring of asynchronous copies) a
             [design] line: ptxas's registers, stack and spill, shared
             memory, blocks an SM, the ring and its bytes in flight, TB/s;
             for the pair reduce's tiled order (a shared-memory slab a
             lane tile) one too: ptxas, shared memory, blocks an SM, lane
             tile, slab row stride, TB/s; the blocked gather at the
             script's zero indices and at uniform random ones, each
             beside its bound (the 32-byte sectors of src the indices
             touch), and a [design] line (ptxas, channels a block, lanes
             a thread, threads, shared memory, blocks an SM, TB/s); last
             the [host] block (probes/host_cost.py in its own process):
             the host microseconds of a wrapper call, part by part
             (require, allocation, pointers, stream, the ctypes call,
             check, the rest), for row 13's wrapper and those the NEP and
             Tersoff steps launch, each wrapper with the launch helpers as
             they were and as they are (in turns in one process), and
             row 13's launch floor from a CUDA graph.  With --parent DIR (a checkout of the parent commit)
             the phase also times DIR's blocked gather in turns with this
             tree's (probes/ab_bgather.py) and runs the [host] block for
             DIR's package, on this tree's kernels

Last, the app: run.in + model.xyz decks through the port's `gpumd`
application (gpumd_tpu_torch/app/gpumd.py, Session(dir, device="cuda"),
`engine auto`), each in a temporary work directory, its model.xyz
written with velocities drawn by numpy:

 12. app      (a) BASELINE config 3 as a deck: PbTe 32,768 from the
             lattice with the trained model, `ensemble npt_ber 300 300 100
             0 40 1000`, dump_thermo 20, dump_restart 200, run 200: the
             route is the compact engine, compact_rows/K1/K2/scatter/fold
             launch every step, thermo.out has 10 finite rows of 18 and
             the box changed; the same start driven directly (DenseNEPMD +
             NPTBerendsen, chunks of 20) gives the same rows (1e-6) and
             restart positions (4 float32 ulps of the box edge); (b)
             config 4's path as a deck:
             NVE, compute_hnemd 10 (1e-4, 0, 0), compute_shc with phase
             3b's parameters, 100 steps: K2/scatter/fold at 12 channels
             every step, kappa.out and shc.out well formed, J (kappa.out's
             10-step sums) within 1e-3 of the direct run's; (c) nvt_lan
             and nvt_bao at 300 K, coupling 100: a 20-step run with
             dump_restart from the lattice (compact_rows), then 980 steps
             from where it ended (a windows plan: compact_windows): the
             kernels every step, the
             mean T of the last 500 steps within 5% of 300 K, the 20-step
             positions within 1e-3 A of the all-plain run with the same
             generator seed; (d) Tersoff Si 32,768 under nvt_nhc, 200
             steps: tersoff_scatter and the fold every step, the rows
             against the direct CompactTersoffMD run (5e-6); (e) LJ argon
             4,000 (config 1, MN from _auto_mn), NVE with add_force on the
             half x < L/2: the route reason is the list path's, no
             hand-written kernel launches, the total energy less the
             force's work within list-md's gate, the total momentum equal
             to the group's impulse (1e-3); (f) PbTe 262,144 NVE,
             dump_thermo 100, run 500, in turns with the same run driven
             directly (direct, app, direct): atom-step/s of each and the
             app loop's overhead
 13. measure  the measure keywords as decks through Session, engine auto,
             a recorder property copying to the host every snapshot the
             measures see; the outputs recomputed on the CPU in float64
             from the recorded snapshots by fresh instances of the same
             classes (the keywords of the deck on a CPU session): (a)
             PbTe 32,768 (16^3 cells, a0 6.57 A, groups: the two halves
             along x), nvt_ber 300 K, 1,000 steps in chunks of 5, with
             compute_msd, _sdc, _dos, _ic, _rdf, _adf, _angular_rdf,
             _orientorder, compute and compute_chunk: the compact route,
             K1/K2/scatter/fold every step and compact_rows twice;
             msd/sdc/dos/mvac/ic/compute/compute_chunk.out against the
             CPU's files; the neighbour measures' last sample (histogram
             counts, per-atom q_l) against the CPU's; the physics (the
             Pb-Te peak of g(r) at a0/2, the ADF's maxima near 90 and
             180 degrees, q4 and q6 within 15% of simple cubic, mvac's
             first row summing to 3, compute_chunk's counts to 32,768,
             the momentum to ~0); beside it, first, the same deck with
             only dump_thermo 100 (both decks' atom-step/s); (b) PbTe
             1,728 (6^3 cells) NVE, 200 steps, compute_gkma over 5,184
             identity modes and compute virial jp: the kernels at 12
             channels every step, the modes' sum against
             heat_current_5 of every recorded snapshot, heatmode.out
             and compute.out against the CPU's; then 100 steps of
             compute_hnema on the same modes (kappamode.out finite, 5
             outputs); (c) PbTe 32,768 NVE on the list path, 100 steps
             each of compute_viscosity 1 50 and compute_hnemdec 1 20
             (1e-4, 0, 0): the route reasons, no hand-written kernel
             launched, stress_6 / onsager_flux of every recorded
             snapshot on the card against the CPU's, viscosity.out and
             onsager.out against the CPU's
 14. ensembles  the list path's ensembles through Session (engine auto;
             none launches a hand-written kernel: each deck fails on a
             launch): (a) a deck for every keyword of the slice (heat_lan,
             heat_nhc, heat_bdp, heat_hybrid, nvt_mttk, npt_mttk iso, tri
             and per axis, nph_mttk, nphug, nvt_qtb, npt_qtb, msst,
             wall_piston with dump_shock_nemd, wall_mirror, wall_harmonic,
             ttm, heat_ttm, ti_spring, ti, ti_rs, ti_as, ti_liquid, deform)
             on LJ argon 4,000 (config 1's geometry, four slabs along x as
             groups), 20 steps on the card against the same deck on the
             CPU in float64 (in four worker processes while the card
             runs (a) and (b)), the Langevin-type noise from one numpy
             seed in both:
             positions within 1e-3 A, compute.out (with its bath columns),
             the TI .csv files, the _hist.txt files and
             ttm_electron_temperature.out within 1e-3 of a column's
             largest magnitude, the .yaml entries within 1e-4 eV/atom;
             (b) the physics on the card: the four heat baths (400 steps
             of 5 fs at 30 +- 15 K) put the source slab 5 K above the sink
             with e_src < 0 < e_snk; nvt_mttk (driven directly, 1,000
             steps) keeps its conserved quantity within 1e-3 eV/atom
             while KE + U alone moves by more than twice that; npt_mttk
             iso halves its distance to 0.3 GPa in 1,000 steps; msst (3
             km/s) on tests/test_msst.py's box (108 atoms, 40 K)
             compresses x by more than that test's 0.5% in 800 steps with
             y untouched; the wall piston (2 km/s) moves 4 A in 100 steps
             within 0.01 A with the far wall still and the run finite; (c) NEP PbTe 32,768 (the trained model,
             four slabs along x, from 600 K) on the list path: NVE (engine
             list), heat_lan 300 +- 60 K and npt_mttk iso, 100 steps of
             warm-up then 100 timed (the port's own noise generators):
             ms/step against NVE, the route
             reasons, a gradient in compute.out (source > the two middle
             slabs > sink, the source injecting); then TILiquid's UF pair
             sum at LJ 4,000 and TTM's diffusion substeps and ms a step
 15. pimd-potentials  the path integrals and the classical potentials
             through Session on the list path (plain torch; the phase
             fails on any launch of a hand-written kernel): (a) each of
             tersoff_1989 (engine list), tersoff_1988, tersoff_mini,
             sw_1985, eam_zhou_2004, eam/alloy, adp and eam_dai_2006
             (potentials/sets.py's files: published Si for tersoff_1989
             and sw_1985, synthetic sets otherwise) on a 216-512-atom
             lattice at 300 K, 20 NVE steps on the card (float32)
             against the CPU's float64 run (four worker processes while
             the card works): positions within 1e-3 A, the last potential
             energy within 1e-4 eV/atom; then a 4,096-atom Si or
             4,000-atom fcc deck of each for 200 NVE steps: KE + U within
             5e-4 eV/atom of step 10's; (b) Tersoff-1989 Si 4,096 under
             heat_lan (engine auto: the list path for its ensemble) for
             200 steps, the source bath injecting more than the sink and
             its slab hotter; (c) pimd, 8 beads, LJ argon 4,000 at 40 K,
             60 steps with dump_beads every 30: the bead temperature of
             the last 50 steps within [0.6, 1.5] x 8 x 40 K, eight
             beads_dump_<k>.xyz of two frames; (d) no hand-written kernel
             launched; (e) ms/step and the peak device memory of every
             4,000-atom deck and of (c)

Not among the default phases (ask for it with --phases):

 ensembles-time  each deck of `ensembles` (a) and NVE (engine list), 20
             steps then 100 timed, on LJ argon 4,000 and on NEP PbTe
             32,768 (300 K; the TI springs a species), each drawing its
             noise from the port's own generator on the card: ms/step
             and its difference from NVE's

 app-spread  (a)'s config 3 deck and (d)'s Tersoff deck, each run three
             times through Session and three times driven directly (a new
             engine each time), in turns: the largest thermo-row and
             position differences between two app runs, two direct runs
             and an app run and a direct run, at step 20 and step 200;
             and one force pass repeated on one state, which shows what
             varies from run to run (the bounds of (a) and (d) rest on
             these readings)

Usage: python3 chip_smoke.py [--phases build,kernels,md,npt-md,
       hnemd-md,drift,list-md,train,time,dense-kernels,dense-md,dense-time,
       tersoff-kernels,tersoff-md,tersoff-time,probes,app,measure,
       ensembles,pimd-potentials,app-spread,ensembles-time]
       [--parent DIR]
Prints the kernels' JSON line, then, last, {"ok": true, "device": {...}}.
A kernel's "launches" are those of the 200-step NVE run of its path;
"launches_npt", "launches_hnemd" (PbTe), "launches_hnemd_tersoff" and
"launches_drift" those of the new phases' runs, where the kernel is on
them; "launches_app" those of the app phase's config-3 deck (compact
rows, K1, K2, scatter, fold; compact_windows: the Langevin deck),
"launches_app_hnemd" of its HNEMD deck and "launches_app_tersoff" of its
Tersoff deck; "launches_measure" those of the measure phase's deck (a)
and "launches_measure_modal" of its deck (b), at 12 channels.  "max_abs_err_pav" is the largest error of a kernel's instances at
12 channels (per-atom virials: K2, scatter, fold, the tersoff modes), and
K2's, the scatter's and the fold's "ms_pav", "plain_ms_pav",
"library_ms_pav", "bound_ms_pav" and "bound_by_pav" their step at 12
channels on the HNEMD path at 262,144 atoms.
A NEP kernel's "ms", "plain_ms", "library_ms" and "bound_ms" are per MD
step at 262,144 atoms on the default rung: the compactions launch twice a
step (positions and cotangent rows) and count both; compact_windows is
timed on the packed windows of that plan.  The dense kernels' are per
force pass at 262,144 atoms on the v2 plan, their launches those of the
200-step v2 run (dense_k1 and dense_k2: of the round-1 pass).  The two
tersoff kernels' are per MD step at 1,000,000 Si; the fused kernel's
launches are those of the 200-step NVE run, the contract kernel's those of
the 20-step run of 4,096 Si at cap 320.  A probe's are per call at its
script's geometry (bench_mxu_probes at 1,734 blocks, its scale 8), its
launches those of the probes' path.
Exits non-zero, printing no result, without a CUDA device or on any
failed check.
"""

import argparse
import dataclasses
import json
import re
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MODEL = ROOT / "artifacts" / "trainer_parity_r5_nep.txt"

PROBES = ("probe_gather", "probe_transcendentals", "probe_onehot_dot",
          "probe_feature_matmul", "probe_pair_reduce", "probe_bgather")
KERNELS = ("k1", "k2", "scatter", "fold", "compact_rows", "compact_windows",
           "tersoff", "tersoff_scatter", "k1b", "k2b", "dense_k1",
           "dense_k2") + PROBES
# Tolerances, relative to max|plain|.  K1 and the fold add the same terms
# in another order in f32 (descriptor sums of ~100 pairs): 1e-5.  K2 also
# differs by hand-derived vs autograd-free op order, the scatter by
# shared-memory atomics whose order changes from run to run: 1e-4.  The
# compactions copy: bit for bit.  The tersoff kernel sums the bond-order
# terms in another order and with CUDA's own powf/expf/sincospif: 1e-4;
# its fused mode also adds by shared-memory atomics, as the scatter: 1e-4.
# The dense K1s sum in another order (1e-5); the dense K2s derive by hand
# what the plain versions take from autograd (1e-4).
# The probes: the gather copies (bit for bit); rsqrtf/cosf/sinf against
# torch's ops, both within 2 ulp (1e-6); the TF32 products round their
# inputs to 10 mantissa bits (2e-3; 1e-5 for the f32 FFMA path, which is
# checked under its own tag); the pair reduce and the blocked gather add
# the same f32 terms in another order (1e-5).
TOL = {"k1": 1e-5, "fold": 1e-5, "k2": 1e-4, "scatter": 1e-4,
       "compact_rows": 0.0, "compact_windows": 0.0, "tersoff": 1e-4,
       "tersoff_scatter": 1e-4,
       "k1b": 1e-5, "k2b": 1e-4, "dense_k1": 1e-5, "dense_k2": 1e-4,
       "probe_gather": 0.0, "probe_transcendentals": 1e-6,
       "probe_onehot_dot": 2e-3, "probe_feature_matmul": 2e-3,
       "probe_pair_reduce": 1e-5, "probe_bgather": 1e-5}
TOL_F32_PRODUCT = 1e-5
# The f32 path's products are exact (three TF32 terms against a 0/1 R) and
# only its sums round, so its error against f64 stays near f32
# torch.matmul's (TF32 off) on random normal inputs: at most twice it.
F32_ERROR_RATIO = 2.0
# The transcendental gate: the kernels' max relative error against f64 on
# the probe's ranges (rsqrtf, cosf, sinf are within 2 ulp, ~2.4e-7;
# __cosf-class fast math reads ~4e-4 there).
TRANS_GATE = 1e-6
# Positions after 20 NVE steps, kernels vs plain versions (or one rung vs
# the other) on the card: the runs differ only by f32 summation order
# (~1e-7 relative in forces), which 20 fs of chaotic dynamics amplifies far
# less than 1e-3 A.
POS_TOL = 1e-3
# Total-energy change over a run, per atom: f32 velocity Verlet at dt 1 fs
# conserves it to ~1e-5 eV/atom; broken forces do not.
DRIFT_TOL = 5e-4
# The HNEMD heat current after 20 steps, kernels vs plain versions, over
# max |J|: positions agree to ~1e-5 A there, so J to ~1e-5; a broken
# per-atom virial moves it by its whole size.
J_TOL = 1e-3

REPLACES = {
    "k1": "gpumd_tpu/engine/nep_compact.py:1099",
    "k2": "gpumd_tpu/engine/nep_compact.py:1223",
    "scatter": "gpumd_tpu/engine/nep_compact.py:1425",
    "fold": "gpumd_tpu/engine/fold_kernel.py:55",
    "compact_rows": "gpumd_tpu/engine/nep_compact.py:541",
    "compact_windows": "gpumd_tpu/engine/nep_compact.py:478",
    "tersoff": "gpumd_tpu/engine/tersoff_compact.py:162",
    "tersoff_scatter": "gpumd_tpu/engine/tersoff_compact.py:162",
    "k1b": "gpumd_tpu/engine/nep_dense.py:555",
    "k2b": "gpumd_tpu/engine/nep_dense.py:588",
    "dense_k1": "gpumd_tpu/engine/nep_dense.py:303",
    "dense_k2": "gpumd_tpu/engine/nep_dense.py:331",
    "probe_gather": "scripts/bench_gather.py:28",
    "probe_transcendentals": "scripts/probe_transcendentals.py:21",
    "probe_onehot_dot": "scripts/bench_mxu_probes.py:75",
    "probe_feature_matmul": "scripts/bench_mxu_probes.py:113",
    "probe_pair_reduce": "scripts/bench_mxu_probes.py:150",
    "probe_bgather": "scripts/bench_mxu_probes.py:207",
}
SOURCES = {
    "k1": "gpumd_tpu_torch/csrc/nep_k1.cu",
    "k2": "gpumd_tpu_torch/csrc/nep_k2.cu",
    "scatter": "gpumd_tpu_torch/csrc/scatter.cu",
    "fold": "gpumd_tpu_torch/csrc/fold.cu",
    "compact_rows": "gpumd_tpu_torch/csrc/compact.cu",
    "compact_windows": "gpumd_tpu_torch/csrc/compact.cu",
    "tersoff": "gpumd_tpu_torch/csrc/tersoff.cu",
    "tersoff_scatter": "gpumd_tpu_torch/csrc/tersoff.cu",
    **{k: "gpumd_tpu_torch/csrc/nep_dense.cu"
       for k in ("k1b", "k2b", "dense_k1", "dense_k2")},
    **{k: "gpumd_tpu_torch/csrc/probes.cu" for k in PROBES},
}
# Peaks of one H100 SXM (NVIDIA's data sheet): HBM3
# bytes/s, float32 FLOP/s outside the tensor cores, dense TF32 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12


class System:
    """PbTe at nc^3 cells with the trained model, on the card in f32.

    `jitter` displaces the atoms (a perfect lattice's pair cotangents cancel
    to rounding noise, which no check can resolve); `plan_on_lattice`
    plans the engine on the undisplaced lattice, as a run that starts from
    it would."""

    def __init__(self, nc, plain=False, seed=3, jitter=0.0,
                 plan_on_lattice=False, compact_lists=True, engine="auto",
                 a0=6.57, per_atom_virial=False, compensated=False):
        from gpumd_tpu_torch.bench import build_pbte
        from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
        from gpumd_tpu_torch.integrate.velocity import initialize_velocity
        from gpumd_tpu_torch.model.box import Box
        from gpumd_tpu_torch.model.state import make_state
        from gpumd_tpu_torch.potentials.nep.model import NEP

        lattice, types, lengths = build_pbte(nc, nc, nc, a0)
        pos = lattice
        if jitter:
            pos = lattice + np.random.default_rng(seed).normal(
                0, jitter, lattice.shape)
        self.n = len(pos)
        self.nep = NEP.from_file(str(MODEL), dtype=torch.float32)
        self.box = Box.orthogonal(lengths, dtype=torch.float32)
        state = make_state(pos, np.where(types == 1, 207.2, 127.6), types,
                           self.box, compensated=compensated)
        self.state = initialize_velocity(state, 300.0, seed=seed)
        self.md = DenseNEPMD(self.nep, self.box, self.n,
                             position=lattice if plan_on_lattice else pos,
                             skin=1.5, plain=plain,
                             compact_lists=compact_lists, engine=engine,
                             per_atom_virial=per_atom_virial)

    def describe(self):
        from gpumd_tpu_torch.engine.grid import round_up
        from gpumd_tpu_torch.engine.nep_compact import rows_compact_eligible
        from gpumd_tpu_torch.engine.nep_dense import _chunk_lanes

        if self.md.engine == "v2":
            p = self.md.plan
            return (f"PbTe n={self.n} grid={p.grid} cap={p.cap} "
                    f"C={round_up(27 * p.cap, _chunk_lanes(p.cap))} "
                    f"(v2 dense windows)")
        cp = self.md.cplan
        path = ("full windows" if not cp.cl else "compact_rows"
                if rows_compact_eligible(cp) else "compact_windows")
        return (f"PbTe n={self.n} grid={cp.base.grid} cap={cp.base.cap} "
                f"bx={cp.bx} mn_r={cp.mn_r} mn_a={cp.mn_a} "
                f"a_pad={cp.a_pad} wl={cp.wl} cl={cp.cl} nb={cp.nb} "
                f"({path})")

    def pipeline(self, carry, per_atom_virial):
        from gpumd_tpu_torch.engine.grid import pack_ghost
        from gpumd_tpu_torch.engine.nep_compact import compact_pipeline

        s = carry.state
        garr = pack_ghost(s.position, s.type, s.mask, s.box, self.md.plan)
        keep = {}
        compact_pipeline(garr, s.type, s.mask, self.md.cplan, carry.idx,
                         self.nep.model, self.nep.params, per_atom_virial,
                         spec=self.md.spec, keep=keep)
        return keep


class TersoffSystem:
    """Diamond Si at nc^3 cells with Tersoff-1989 (the file `pot_path`), on
    the card in f32, skin 1.0 as bench.py's run_tersoff."""

    def __init__(self, nc, pot_path, plain=False, seed=3, jitter=0.0,
                 a0=5.431, cap=None, per_atom_virial=False):
        from gpumd_tpu_torch.bench import build_diamond
        from gpumd_tpu_torch.engine.tersoff_compact import CompactTersoffMD
        from gpumd_tpu_torch.integrate.velocity import initialize_velocity
        from gpumd_tpu_torch.model.box import Box
        from gpumd_tpu_torch.model.state import make_state
        from gpumd_tpu_torch.potentials.tersoff import Tersoff1989

        pos, lengths = build_diamond(nc, a0)
        if jitter:
            pos = pos + np.random.default_rng(seed).normal(0, jitter,
                                                           pos.shape)
        self.n = len(pos)
        pot = Tersoff1989.from_file(pot_path)
        self.box = Box.orthogonal(lengths, dtype=torch.float32)
        state = make_state(pos, np.full(self.n, 28.085),
                           np.zeros(self.n, int), self.box)
        self.state = initialize_velocity(state, 300.0, seed=seed)
        self.md = CompactTersoffMD(pot, self.box, self.n, position=pos,
                                   skin=1.0, plain=plain, cap=cap,
                                   per_atom_virial=per_atom_virial)

    def describe(self):
        cp = self.md.cplan
        return (f"Si n={self.n} grid={cp.base.grid} cap={cp.base.cap} "
                f"bx={cp.bx} mn={cp.mn_r} a_pad={cp.a_pad} wl={cp.wl} "
                f"cl={cp.cl} nb={cp.nb} (full windows)")

    def pipeline(self, carry, per_atom_virial):
        from gpumd_tpu_torch.engine.tersoff_compact import (
            compact_tersoff_compute,
        )

        s = carry.state
        keep = {}
        compact_tersoff_compute(s.position, s.type, s.mask, s.box,
                                self.md.cplan, carry.idx, self.md.spec,
                                per_atom_virial=per_atom_virial, keep=keep)
        keep["idx_a"] = keep["idx"]
        return keep


def tersoff_pairs(md, keep):
    """(name, kernel fn, plain fn) on one Tersoff pass's tensors: both
    modes of the tersoff kernel, the scatter on the contract mode's pvals
    (made here, once: the pass keeps none) and the fold."""
    from gpumd_tpu_torch.engine import fold_kernel as fk
    from gpumd_tpu_torch.engine import nep_compact as nc
    from gpumd_tpu_torch.engine import tersoff_compact as tc

    cp, spec = md.cplan, md.spec
    pav = keep["dcand"].shape[2] == 12
    args = (keep["centers"], keep["cand"], keep["idx"], cp, spec, pav)
    keep["pvals"] = tc.tersoff_kernel_plain(*args)[1]
    return [
        ("tersoff", lambda: tc.tersoff_kernel_call(*args),
         lambda: tc.tersoff_kernel_plain(*args)),
        ("tersoff_scatter", lambda: tc.tersoff_scatter_call(*args),
         lambda: tc.tersoff_scatter_plain(*args)),
        ("scatter", lambda: nc.scatter_call(keep["pvals"], keep["idx"], cp),
         lambda: nc.scatter_plain(keep["pvals"], keep["idx"], cp)),
        ("fold", lambda: fk.fold_windows_to_rows(keep["dcand"], cp.base,
                                                 cp.bx),
         lambda: fk.fold_windows_to_rows_plain(keep["dcand"], cp.base,
                                               cp.bx)),
    ]


def kernel_pairs(md, keep):
    """(name, kernel fn, plain fn) on one pipeline pass's tensors: every
    kernel that pass ran, one entry per launch of a step."""
    from gpumd_tpu_torch.engine import fold_kernel as fk
    from gpumd_tpu_torch.engine import nep_compact as nc

    cp, spec = md.cplan, md.spec
    pav = keep["pvals"].shape[3] == 12
    cidx = keep.get("cidx")
    pairs = [
        ("k1", lambda: nc.k1_call(keep["centers"], keep["cand"], keep["idx"],
                                  cp, spec),
         lambda: nc.k1_plain(keep["centers"], keep["cand"], keep["idx"], cp,
                             spec)),
        ("k2", lambda: nc.k2_call(keep["centers"], keep["tiles"], keep["idx"],
                                  keep["cotc"], keep["cotw"], cp, spec, pav),
         lambda: nc.k2_plain(keep["centers"], keep["tiles"], keep["idx"],
                             keep["cotc"], keep["cotw"], cp, spec, pav)),
        ("scatter",
         lambda: nc.scatter_call(keep["pvals"], keep["idx_a"], cp, cidx),
         lambda: nc.scatter_plain(keep["pvals"], keep["idx_a"], cp, cidx)),
        ("fold", lambda: fk.fold_windows_to_rows(keep["dcand"], cp.base,
                                                 cp.bx),
         lambda: fk.fold_windows_to_rows_plain(keep["dcand"], cp.base,
                                               cp.bx)),
    ]
    if cidx is None:
        return pairs
    if nc.rows_compact_eligible(cp):
        srcs, name = (keep["garr"], keep["rows_p"]), "compact_rows"
        kern, plain = nc.compact_rows_call, nc.compact_rows_plain
    else:
        srcs, name = (keep["cand_win"], keep["cotw_win"]), "compact_windows"
        kern, plain = nc.compact_windows_call, nc.compact_windows_plain
    for src in srcs:
        pairs.append((name, lambda s=src: kern(s, cidx, cp),
                      lambda s=src: plain(s, cidx, cp)))
    return pairs


def _outputs(x):
    return [t for t in (x if isinstance(x, tuple) else (x,)) if t is not None]


def phase_build():
    from gpumd_tpu_torch.engine import cuda_build

    t0 = time.time()
    cuda_build.library()
    print(f"[build] kernels built and loaded in {time.time() - t0:.1f} s "
          f"(nvcc {cuda_build.build_info.get('seconds', 0.0):.1f} s)")
    report = _ptxas_report()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", report)]
    print(f"[build] ptxas: {len(regs)} kernels, max {max(regs, default=0)} "
          f"registers/thread, {sum(spills)} bytes of spill stores")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(card)  # the card's name and power limit, as nvidia-smi gives them


def _compare(tag, name, got, ref, results, failures, tol=None, pav=False):
    got, ref = _outputs(got), _outputs(ref)
    torch.cuda.synchronize()
    tol = TOL[name] if tol is None else tol
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    rel = max(float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
              for g, r in zip(got, ref))
    fin = all(bool(torch.isfinite(g).all()) for g in got)
    ok = fin and rel <= tol
    print(f"[kernels] {tag}: max_abs_err={err:.3e} rel={rel:.3e} "
          f"tol={tol:.0e} {'ok' if ok else 'FAIL'}")
    r = results.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
    if pav:  # the 12-channel instances of K2, the scatter and the fold
        r["max_abs_err_pav"] = max(r.get("max_abs_err_pav", 0.0), err)
    if not ok:
        failures.append(tag)


def phase_kernels(results):
    from gpumd_tpu_torch.engine import nep_compact as nc
    from gpumd_tpu_torch.engine.grid import pack_block_windows

    passes = [
        ("lists", dict(jitter=0.1)),
        ("lists-rows", dict(jitter=0.1, plan_on_lattice=True)),
        ("windows", dict(jitter=0.1, compact_lists=False)),
    ]
    failures = []
    with torch.no_grad():
        for label, kw in passes:
            sysm = System(16, **kw)
            print(f"[kernels] pass {label}: {sysm.describe()}")
            if label == "lists":
                _k_design(sysm.md)
            carry = sysm.md.init_carry(sysm.state)
            if bool(carry.overflow):
                raise RuntimeError(f"overflow at init ({label})")
            if sysm.md.cplan.cl:
                print(f"[kernels] pass {label}: max live compact lanes "
                      f"{int(carry.idx.cnt.max())} of cl {sysm.md.cplan.cl}")
            for pav in (False, True):
                keep = sysm.pipeline(carry, pav)
                for name, kern, plain in kernel_pairs(sysm.md, keep):
                    if pav and name not in ("k2", "scatter", "fold"):
                        continue  # K1 and the compactions: no channels
                    tag = f"{name}[{label}{',pav' if pav else ''}]"
                    _compare(tag, name, kern(), plain(), results, failures,
                             pav=pav)
                _scatter_design(f"{label}{', 12 channels' if pav else ''}",
                                keep, sysm.md.cplan)
                if label == "lists-rows" and not pav:
                    cp, cidx = sysm.md.cplan, keep["cidx"]
                    for src in (keep["garr"], keep["rows_p"]):
                        win = pack_block_windows(src, cp.base, cp.bx, cp.wl,
                                                 far_channels=0)
                        _compare("compact_windows(pack)==compact_rows",
                                 "compact_windows",
                                 nc.compact_windows_call(win, cidx, cp),
                                 nc.compact_rows_call(src, cidx, cp),
                                 results, failures)
            del sysm, carry, keep
    if failures:
        raise RuntimeError(f"kernels disagree with plain versions: {failures}")


def _run_steps(sysm, n_steps, snap_at=None, ens=None, observer=None,
               measure=None, maccs=None):
    """n_steps from sysm's state: the final carry, the starting total
    energy per atom and the input-order positions after `snap_at` steps.
    With make_step's hooks, also the observer's tensors stacked (kept on
    the card; None without an observer) and the measure's accumulators."""
    from gpumd_tpu_torch.integrate.ensembles.nve import NVE
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    md, ens = sysm.md, ens or NVE()
    hooked = observer is not None or measure is not None
    carry = md.init_carry(sysm.state)
    carry = carry._replace(state=md.compute(carry.state, carry.idx))
    aux = ens.init(carry.state)
    step = md.make_step(ens, 1.0 / TIME_UNIT_CONVERSION, observer, measure)
    snap, ys = None, []
    e0 = total_energy(carry.state)
    for s in range(n_steps):
        if hooked:
            carry, aux, maccs, y = step(carry, aux, maccs)
            ys.append(y)
        else:
            carry, aux = step(carry, aux)
        if snap_at is not None and s + 1 == snap_at:
            snap = md.to_input_order(carry, sysm.n).position.clone()
    if not hooked:
        return carry, e0, snap
    return (carry, e0, snap,
            torch.stack(ys) if observer is not None else None, maccs)


def total_energy(state):
    pe = torch.sum(state.potential_energy * state.mask)
    return float(state.kinetic_energy() + pe) / float(state.mask.sum())


def _md_path(label, sysm, n_steps, need, ens=None, never=(), hooks=None,
             out=None):
    """Drive one path from counts of 0, read them just after, gate it
    (energy conservation under NVE only: `ens` None; the kernels `never`
    not launched).  Returns the 20-step positions and the counts; with
    `hooks` (observer, measure, maccs) it runs through make_step's hooks
    and puts the observer's rows and the accumulators in `out`, which
    also receives the final carry."""
    from gpumd_tpu_torch.engine import cuda_build

    cuda_build.reset_launches()
    carry, e0, snap, *ys_maccs = _run_steps(sysm, n_steps, snap_at=20,
                                            ens=ens, **(hooks or {}))
    if hooks is not None:
        out.update(ys=ys_maccs[0], maccs=ys_maccs[1])
    if out is not None:
        out["carry"] = carry
    torch.cuda.synchronize()
    counts = dict(cuda_build.launches)
    e1 = total_energy(carry.state)
    s = carry.state
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (s.position, s.velocity, s.force, s.potential_energy))
    overflow = bool(carry.overflow)
    print(f"[md] {label}: {sysm.describe()}")
    print(f"[md] {label}: steps={n_steps} launches={counts} "
          f"finite={finite} overflow={overflow}")
    print(f"[md] {label}: total energy per atom: start {e0:.8f} eV, end "
          f"{e1:.8f} eV, change {e1 - e0:+.3e} eV"
          + (f" (bound {DRIFT_TOL})" if ens is None else
             f"; temperature {float(s.temperature()):.2f} K"))
    if not finite or overflow:
        raise RuntimeError(f"{label}: non-finite values or overflow")
    low = [k for k, c in need.items() if counts[k] < c]
    if low:
        raise RuntimeError(f"{label}: kernels launched fewer times than "
                           f"{need}: {low}")
    off = [k for k in never if counts[k]]
    if off:
        raise RuntimeError(f"{label}: kernels off this path launched: {off}")
    if ens is None and abs(e1 - e0) > DRIFT_TOL:
        raise RuntimeError(f"{label}: total energy not conserved")
    return snap, counts


def _pos_check(what, box, a, b):
    dmax = float(box.minimum_image(a - b).abs().max())
    print(f"[md] 20-step positions, {what}: max |dx| = {dmax:.3e} A "
          f"(bound {POS_TOL})")
    if not dmax <= POS_TOL:
        raise RuntimeError(f"trajectories depart: {what}")


def phase_md(results):
    from gpumd_tpu_torch.engine import cuda_build

    base = ("k1", "k2", "scatter", "fold")
    with torch.no_grad():
        # the main path: default rung from the lattice (compact_rows)
        sysm = System(16)
        n = 200
        snap, counts = _md_path("default rung (lattice start)", sysm, n,
                                {**{k: n for k in base},
                                 "compact_rows": 2 * n})
        for k in base + ("compact_rows",):
            results.setdefault(k, {})["launches"] = counts[k]
        # the default rung on a plan rows_compact_eligible rejects
        jit = System(16, jitter=0.1)
        _, counts = _md_path("default rung (jittered start)", jit, 50,
                             {**{k: 50 for k in base},
                              "compact_windows": 100})
        results.setdefault("compact_windows", {})["launches"] = \
            counts["compact_windows"]
        del jit
        full = System(16, compact_lists=False)
        snap_w, _ = _md_path("full-window rung", full, 50,
                             {k: 50 for k in base})
        _pos_check("default vs full-window rung", sysm.box, snap, snap_w)
        ref = System(16, plain=True)
        cuda_build.reset_launches()
        _, _, snap_p = _run_steps(ref, 20, snap_at=20)
        if any(cuda_build.launches.values()):
            raise RuntimeError("the plain reference run launched kernels")
        _pos_check("default rung, kernels vs plain", sysm.box, snap, snap_p)


def _box_change(carry, box0):
    """Largest relative change of a lattice vector component since box0."""
    h, h0 = carry.state.box.h, box0.h
    return float(((h - h0).abs() / h0.abs().max()).max())


def phase_npt_md(results):
    """NPT on the default rung (BASELINE config 3 as written): 200 steps
    under NPTBerendsen with bench.py's coupling and 200 under NPTSCR, the
    box rescaled every step; 20 steps of each against the all-plain run
    with the same noise."""
    from gpumd_tpu_torch.bench import NPT_BARO
    from gpumd_tpu_torch.engine import cuda_build
    from gpumd_tpu_torch.integrate.ensembles.npt import NPTSCR, NPTBerendsen

    runs = (("NPT-Berendsen", lambda: NPTBerendsen(**NPT_BARO)),
            ("NPT-SCR", lambda: NPTSCR(coupling=100.0, seed=5, **NPT_BARO)))
    base = ("k1", "k2", "scatter", "fold")
    n = 200
    with torch.no_grad():
        sysm = System(16)
        ref = System(16, plain=True)
        for label, make in runs:
            out = {}
            snap, counts = _md_path(
                f"{label} default rung", sysm, n,
                {**{k: n for k in base}, "compact_rows": 2 * n}, ens=make(),
                out=out)
            change = _box_change(out["carry"], sysm.box)
            print(f"[npt-md] {label}: box {sysm.box.h.diagonal().tolist()}"
                  f" -> {out['carry'].state.box.h.diagonal().tolist()} A, "
                  f"largest relative change {change:.3e}")
            if not change > 1e-6:
                raise RuntimeError(f"{label}: the box did not change")
            if label == "NPT-Berendsen":
                for k in base + ("compact_rows",):
                    results.setdefault(k, {})["launches_npt"] = counts[k]
            cuda_build.reset_launches()
            _, _, snap_p = _run_steps(ref, 20, snap_at=20, ens=make())
            if any(cuda_build.launches.values()):
                raise RuntimeError("the plain reference run launched kernels")
            _pos_check(f"{label}, kernels vs plain", sysm.box, snap, snap_p)


def _rows_check(what, ys, ys_p):
    """The observer's rows of two runs: max difference over max |row|."""
    rel = float((ys - ys_p).abs().max()) / max(float(ys_p.abs().max()),
                                               1e-30)
    print(f"[hnemd-md] 20-step heat current, {what}: max |dJ| / max |J| "
          f"= {rel:.3e} (bound {J_TOL})")
    if not rel <= J_TOL:
        raise RuntimeError(f"heat currents depart: {what}")


def phase_hnemd_md(results, pot_path):
    """HNEMD (BASELINE config 4's path): per-atom virials, the driving
    force, the heat-current observer and an SHC measure, on PbTe (default
    rung) and on Si Tersoff (the fused route with 12 channels)."""
    import types as pytypes

    from gpumd_tpu_torch.bench import HNEMD_FE
    from gpumd_tpu_torch.engine import cuda_build
    from gpumd_tpu_torch.engine import tersoff_compact as tc
    from gpumd_tpu_torch.integrate.ensembles.nve import NVE
    from gpumd_tpu_torch.measure.properties import SHC, heat_current_total
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    fe, n = HNEMD_FE, 100
    dt = 1.0 / TIME_UNIT_CONVERSION
    paths = (("PbTe", lambda plain: System(16, plain=plain,
                                           per_atom_virial=True),
              {"k1": n, "k2": n, "scatter": n, "fold": n,
               "compact_rows": 2 * n}, ()),
             ("Si Tersoff", lambda plain: TersoffSystem(
                 16, pot_path, plain=plain, per_atom_virial=True),
              {"tersoff_scatter": n, "fold": n}, ("tersoff", "scatter")))
    with torch.no_grad(), tempfile.TemporaryDirectory() as tmp:
        for label, make, need, never in paths:
            sysm = make(False)
            sysm.md.hnemd_fe = fe
            if label == "Si Tersoff":
                cp = sysm.md.cplan
                fused = tc.fused_fits(cp, True)
                print(f"[hnemd-md] Si Tersoff, per-atom virials: route "
                      f"{tc.tersoff_entry(fused, cp, True)} "
                      f"({'fused' if fused else 'contract + scatter'}), "
                      f"{tc.tersoff_smem(fused, cp.wl, cp.mn_r, True):,} B "
                      f"of shared memory a block (3 channels: "
                      f"{tc.tersoff_smem(fused, cp.wl, cp.mn_r, False):,} B)"
                      f", {tc.tersoff_occupancy(fused, cp, True)[0]} blocks"
                      f" an SM")
            sess = pytypes.SimpleNamespace(workdir=tmp, _n=sysm.n,
                                           state=sysm.state)
            shc = SHC(sample_interval=2, nc=10, direction=0, num_omega=20,
                      max_omega=40.0, dt=dt)
            out = {}
            snap, counts = _md_path(
                f"HNEMD {label}", sysm, n, need, ens=NVE(), never=never,
                hooks=dict(observer=heat_current_total,
                           measure=shc.device_update,
                           maccs=shc.device_init(sess, sysm.n)), out=out)
            key = "launches_hnemd" + ("" if label == "PbTe" else "_tersoff")
            for k in need:
                results.setdefault(k, {})[key] = counts[k]
            shc.device_postprocess(sess, out["maccs"])
            rows = np.loadtxt(Path(tmp) / "shc.out", comments="#")
            (Path(tmp) / "shc.out").unlink()
            print(f"[hnemd-md] {label}: SHC {rows.shape[0]} rows, finite "
                  f"{bool(np.isfinite(rows).all())}; J of {len(out['ys'])} "
                  f"steps, the last {out['ys'][-1].tolist()}")
            if rows.shape != (2 * 10 - 1 + 20, 3) or not np.isfinite(
                    rows).all() or not bool(torch.isfinite(out["ys"]).all()):
                raise RuntimeError(f"HNEMD {label}: SHC or J not finite or "
                                   f"misshapen")
            ref = make(True)
            ref.md.hnemd_fe = fe
            cuda_build.reset_launches()
            _, _, snap_p, ys_p, _ = _run_steps(
                ref, 20, snap_at=20, ens=NVE(), observer=heat_current_total)
            if any(cuda_build.launches.values()):
                raise RuntimeError("the plain reference run launched kernels")
            _pos_check(f"HNEMD {label}, kernels vs plain", sysm.box, snap,
                       snap_p)
            _rows_check(f"{label}, kernels vs plain", out["ys"][:20], ys_p)
            del sysm, ref, out


def phase_drift(results):
    """The NVE drift gate, 10 ps of PbTe 32,768 on the default rung with
    compensated positions and velocities (scripts/drift_gate.py's twin at
    a fifth of its length)."""
    from gpumd_tpu_torch.engine import cuda_build
    from gpumd_tpu_torch.scripts.drift_gate import run_drift

    samples = []
    cuda_build.reset_launches()
    out = run_drift(32768, 10.0, samples=samples)
    torch.cuda.synchronize()
    counts = dict(cuda_build.launches)
    for k in ("k1", "k2", "scatter", "fold", "compact_rows"):
        results.setdefault(k, {})["launches_drift"] = counts[k]
    n = out["n_atoms"]
    print("[drift] total energy per atom a ps: " + ", ".join(
        f"{e / n:.8f}" for _, e in samples) + " eV")
    print(f"[drift] PbTe {n}, {out['sim_ps']:.1f} ps: drift "
          f"{out['value']:.3e} eV/atom/ns (gate {out['gate']:.0e}) "
          f"{'pass' if out['pass'] else 'FAIL'}; launches "
          f"{ {k: counts[k] for k in ('k1', 'k2', 'compact_rows')} }")
    if not out["pass"]:
        raise RuntimeError("NVE drift above the gate")


# ---- the general (list) path: ForceField + md_run ------------------------

LJ_FILE = ROOT / "lj.txt"
# BASELINE config 1's gate on the total-energy change of an NVE run:
# 2e-3 eV/(fs^2 atom) x dt^2 x N (BASELINE.md; the unshifted LJ cutoff
# leaks energy as pairs cross it)
LJ_GATE = 2e-3
# The list path's first force pass against the compact rung's on the same
# f32 state: forces within 1e-3 of max |F|; per-atom energies and the
# total virial within 1e-4 of their largest magnitude (the two paths sum
# the same f32 terms in another order: ~1e-6 relative)
LIST_F_TOL = 1e-3
LIST_EW_TOL = 1e-4


class LJArgon:
    """BASELINE config 1: fcc argon at 10^3 cells (a0 5.26 A), the repo's
    lj.txt, ForceField.create(mn=160, skin=1.0), 80 K; the velocities drawn
    with numpy, so the card and the CPU start from the same state.  MN 128
    would overflow: rc + skin = 10 A takes in the first seven fcc shells,
    134 neighbours (the seventh at 9.84 A)."""

    def __init__(self, dtype=torch.float32, device="cuda"):
        from gpumd_tpu_torch.forcefield import ForceField
        from gpumd_tpu_torch.integrate.velocity import initialize_velocity
        from gpumd_tpu_torch.model.box import Box
        from gpumd_tpu_torch.model.state import make_state
        from gpumd_tpu_torch.potentials.lj import LJ
        from gpumd_tpu_torch.units import K_B

        nc, a0, mass = 10, 5.26, 39.948
        base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
        cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                         axis=-1).reshape(-1, 3)
        pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
        self.n = n = len(pos)
        v = np.random.default_rng(42).normal(0.0, np.sqrt(K_B * 80.0 / mass),
                                             (n, 3))
        self.box = Box.orthogonal([nc * a0] * 3, dtype=dtype, device=device)
        lj = LJ.from_file(str(LJ_FILE), dtype=dtype, device=device)
        self.ff = ForceField.create([lj], self.box, n, mn=160, skin=1.0)
        state = make_state(pos, np.full(n, mass), np.zeros(n, int), self.box)
        self.state = initialize_velocity(state, 80.0, velocity=v)


def _list_run(ff, state, dt, n_steps, snap_at=None):
    """n_steps of NVE through integrate/run.py's step from state (its
    first force pass included): the final carry (state, aux, cache), the
    starting total energy per atom, the positions after `snap_at` steps,
    the rebuilds and whether any neighbour list overflowed MN."""
    from gpumd_tpu_torch.integrate.ensembles.nve import NVE
    from gpumd_tpu_torch.integrate.run import make_md_step

    ens = NVE()
    state = ff.compute(state)
    cache = ff.refresh_cache(state)
    carry = (state, ens.init(state), cache)
    step = make_md_step(ff, ens, dt, observer=lambda s: None)
    e0 = total_energy(state)
    over = cache.count.max() > ff.neighbor.mn
    snap, rebuilds = None, 0
    for s in range(n_steps):
        prev = carry[2]
        carry, _ = step(carry)
        if carry[2] is not prev:
            rebuilds += 1
            over = over | (carry[2].count.max() > ff.neighbor.mn)
        if snap_at is not None and s + 1 == snap_at:
            snap = carry[0].position.clone()
    return carry, e0, snap, rebuilds, bool(over)


def _list_gate(label, carry, e0, n_steps, rebuilds, over, bound):
    """Finite, no overflow, |total energy change| per atom within bound."""
    s = carry[0]
    e1 = total_energy(s)
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (s.position, s.velocity, s.force, s.potential_energy))
    print(f"[list-md] {label}: {n_steps} steps, {rebuilds} rebuilds, "
          f"finite={finite} overflow={over}; total energy per atom start "
          f"{e0:.8f} eV, end {e1:.8f} eV, change {e1 - e0:+.3e} eV (bound "
          f"{bound:.3e}); temperature {float(s.temperature()):.2f} K")
    if not finite or over:
        raise RuntimeError(f"{label}: non-finite values or overflow")
    if not abs(e1 - e0) <= bound:
        raise RuntimeError(f"{label}: total energy not conserved")


def _rel_check(what, got, ref, tol):
    rel = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
    print(f"[list-md] {what}: max diff / max |ref| = {rel:.3e} (bound "
          f"{tol:.0e})")
    if not rel <= tol:
        raise RuntimeError(f"{what}: departs")


def _pair_keys(nbr, position, box):
    """Per row the sorted keys j * 35937 + enc(shift) of the valid slots
    (invalid slots last), the integer image shifts and the count."""
    from gpumd_tpu_torch.neighbor.neighbor import _enc

    jdx = nbr.idx.long()
    d = nbr.r12 - (position[jdx] - position[:, None, :])
    shift = torch.round(box.fractional(d)).long()
    shift = torch.where(nbr.mask[..., None] > 0, shift,
                        torch.zeros_like(shift))
    key = torch.where(nbr.mask > 0, jdx * 35937 + _enc(shift),
                      torch.full_like(jdx, 2 ** 62))
    return torch.sort(key, dim=1).values, shift


def _builders_check():
    """The three builders and the reverse map on a jittered 4,096-atom
    PbTe box (rc 9 A, MN 112), in f64 on the card and on the CPU: the same
    (idx, shift) set a row and count, and a valid reverse map on the card,
    equal to the CPU's where the slot layouts are equal."""
    from gpumd_tpu_torch.bench import build_pbte
    from gpumd_tpu_torch.model.box import Box
    from gpumd_tpu_torch.neighbor import neighbor as nb

    lattice, _, lengths = build_pbte(8, 8, 8)
    pos = lattice + np.random.default_rng(7).normal(0, 0.1, lattice.shape)
    rc, mn = 9.0, 112
    out = {}
    for dev in ("cuda", "cpu"):
        box = Box.orthogonal(lengths, device=dev)
        p = torch.as_tensor(pos, device=dev)
        m = torch.ones(len(pos), dtype=torch.float64, device=dev)
        grid = nb.choose_grid(box, rc)
        cap = nb.default_cell_cap(box, grid, len(pos))
        builders = {
            "neighbor_brute": lambda: nb.neighbor_brute(p, box, m, rc=rc,
                                                        mn=mn),
            "neighbor_cell_list": lambda: nb.neighbor_cell_list(
                p, box, m, rc=rc, mn=mn, grid=grid, cell_cap=cap),
            "neighbor_cell_dense": lambda: nb.neighbor_cell_dense(
                p, box, m, rc=rc, mn=mn, grid=grid, cell_cap=cap)}
        for name, fn in builders.items():
            nbr = fn()
            keys, shift = _pair_keys(nbr, p, box)
            if dev == "cuda":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                t0 = time.perf_counter()
                rev = nb.build_reverse_map(nbr, shift)
                torch.cuda.synchronize()
                ms_rev = 1e3 * (time.perf_counter() - t0)
            else:
                rev = nb.build_reverse_map(nbr, shift)
                ms = ms_rev = None
            out.setdefault(name, {})[dev] = dict(
                nbr=nbr, keys=keys, shift=shift, rev=rev, ms=ms,
                ms_rev=ms_rev)
    for name, r in out.items():
        g, c = r["cuda"], r["cpu"]
        n_rows, width = g["nbr"].idx.shape
        same_keys = torch.equal(g["keys"].cpu(), c["keys"])
        same_count = torch.equal(g["nbr"].count.cpu(), c["nbr"].count)
        valid = g["nbr"].mask > 0
        rows = torch.arange(n_rows, device=valid.device)[:, None].expand(
            -1, width)
        rv = g["rev"].long()
        mirror_ok = bool(((g["nbr"].idx.reshape(-1)[rv] == rows)
                          & (g["shift"].reshape(-1, 3)[rv]
                             == -g["shift"]).all(-1))[valid].all())
        layout = (torch.equal(g["nbr"].idx.cpu(), c["nbr"].idx)
                  and torch.equal(g["nbr"].mask.cpu(), c["nbr"].mask))
        same_rev = (torch.equal(g["rev"].cpu(), c["rev"]) if layout
                    else None)
        over = int((g["nbr"].count > width).sum())
        print(f"[list-md] {name} on PbTe {len(pos)} jittered (f64, rc {rc}, "
              f"MN {mn}): card {g['ms']:.2f} ms, reverse map "
              f"{g['ms_rev']:.2f} ms; same (idx, shift) sets {same_keys}, "
              f"same counts {same_count} (max {int(g['nbr'].count.max())}, "
              f"{over} over MN), card rev valid {mirror_ok}, same layout "
              f"{layout}, same rev {same_rev}")
        if not (same_keys and same_count and mirror_ok and over == 0
                and same_rev is not False):
            raise RuntimeError(f"{name}: the card's list differs from the "
                               f"CPU's")


def phase_list_md(results):
    """The general path (ForceField + integrate/run.py): BASELINE config
    1 (LJ argon 4,000, NVE) against the same run on the CPU in f64, NEP
    PbTe 32,768 on the list path against the compact rung, and the
    neighbour builders on the card against the CPU.  It launches none of
    the hand-written kernels."""
    from gpumd_tpu_torch.engine import cuda_build
    from gpumd_tpu_torch.forcefield import ForceField
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    with torch.no_grad():
        cuda_build.reset_launches()
        # LJ argon, BASELINE config 1
        dt_fs = 2.0
        dt = dt_fs / TIME_UNIT_CONVERSION
        lj = LJArgon()
        method = {"cell": "cell list", "brute": "brute force"}[
            lj.ff.neighbor.method]
        print(f"[list-md] LJ argon n={lj.n}: neighbour plan "
              f"{lj.ff.neighbor} ({method})")
        carry, e0, snap, rb, over = _list_run(lj.ff, lj.state, dt, 200,
                                              snap_at=20)
        bound = LJ_GATE * dt_fs ** 2 * lj.n
        _list_gate("LJ argon NVE, 2 fs", carry, e0, 200, rb, over,
                   bound / lj.n)
        ref = LJArgon(dtype=torch.float64, device="cpu")
        _, _, snap_c, _, over_c = _list_run(ref.ff, ref.state, dt, 20,
                                            snap_at=20)
        if over_c:
            raise RuntimeError("LJ argon on the CPU: overflow")
        _pos_check("LJ argon list path, card f32 vs CPU f64", lj.box,
                   snap, snap_c.to(device=snap.device, dtype=snap.dtype))
        del lj, ref, carry
        # NEP PbTe on the list path, against the compact default rung (from
        # a jittered lattice: a perfect one's forces are rounding noise)
        sysm = System(16, jitter=0.1)
        ff = ForceField.create([sysm.nep], sysm.box, sysm.n, mn=112,
                               skin=1.0, per_atom_virial=True)
        print(f"[list-md] NEP PbTe n={sysm.n}: neighbour plan {ff.neighbor}")
        st = ff.compute(sysm.state)
        counts = dict(cuda_build.launches)
        md = sysm.md
        c = md.init_carry(sysm.state)
        c = c._replace(state=md.compute(c.state, c.idx))
        ref = md.to_input_order(c, sysm.n)
        _rel_check("NEP first force pass, list vs compact rung: forces",
                   st.force, ref.force, LIST_F_TOL)
        _rel_check("NEP first force pass, list vs compact rung: per-atom "
                   "energies", st.potential_energy, ref.potential_energy,
                   LIST_EW_TOL)
        _rel_check("NEP first force pass, list vs compact rung: total "
                   "virial", torch.sum(st.virial, 0), torch.sum(ref.virial, 0),
                   LIST_EW_TOL)
        cuda_build.reset_launches()
        dt = 1.0 / TIME_UNIT_CONVERSION
        carry, e0, snap, rb, over = _list_run(ff, sysm.state, dt, 200,
                                              snap_at=20)
        counts = {k: counts[k] + v for k, v in cuda_build.launches.items()}
        _list_gate("NEP PbTe NVE, 1 fs, per-atom virials", carry, e0, 200,
                   rb, over, DRIFT_TOL)
        _, _, snap_r = _run_steps(sysm, 20, snap_at=20)
        _pos_check("NEP PbTe, list path vs compact rung", sysm.box, snap,
                   snap_r)
        launched = {k: v for k, v in counts.items() if v}
        print(f"[list-md] hand-written kernels launched by the list path "
              f"(LJ and NEP runs): {launched or 'none'}")
        if launched:
            raise RuntimeError("the list path launched hand-written kernels")
        del sysm, ff, carry, st, ref, c
        _builders_check()


# The trainer's f32 forward against labels from the same model through the
# list path in f64: f32 rounding of energies of ~-3 eV/atom (~4e-7),
# forces and virials of the same model (~1e-5); the bounds leave 20-50x.
TRAIN_E_TOL = 2e-5  # eV/atom
TRAIN_F_TOL = 2e-4  # eV/A
TRAIN_V_TOL = 2e-4  # eV/atom
# The chunked population evaluate against single evaluations in f32: the
# same sums batched over individuals (bmm against mm), relative.
TRAIN_CHUNK_TOL = 1e-4
# Config 5: nep.in "type 2 Te Pb" with every other keyword at its default
# (NEP4, cutoffs 8/4 A, n_max 6/6, basis 6/6, l_max 4 2 0, 30 neurons,
# population 50, batch 1000), generation cut to what a smoke run affords.
TRAIN_NEP_IN = "type 2 Te Pb\n"


def _card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"


def _trained_md(path, n_steps=20):
    """20 NVE steps of 4,096 PbTe (300 K, 1 fs) on the compact engine with
    the nep.txt at `path`, counts from 0: (counts, energy change per
    atom, finite)."""
    from gpumd_tpu_torch.bench import build_pbte, pbte_mass
    from gpumd_tpu_torch.engine import cuda_build
    from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
    from gpumd_tpu_torch.integrate.ensembles.nve import NVE
    from gpumd_tpu_torch.integrate.velocity import initialize_velocity
    from gpumd_tpu_torch.model.box import Box
    from gpumd_tpu_torch.model.state import make_state
    from gpumd_tpu_torch.potentials.nep.model import NEP
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    pos, types, lengths = build_pbte(8, 8, 8, 6.46)
    n = len(pos)
    nep = NEP.from_file(path, dtype=torch.float32)
    box = Box.orthogonal(lengths, dtype=torch.float32)
    state = initialize_velocity(make_state(pos, pbte_mass(types), types,
                                           box), 300.0, seed=3)
    md = DenseNEPMD(nep, box, n, position=pos, skin=1.5)
    ens = NVE()
    cuda_build.reset_launches()
    carry = md.init_carry(state)
    carry = carry._replace(state=md.compute(carry.state, carry.idx))
    aux = ens.init(carry.state)
    step = md.make_step(ens, 1.0 / TIME_UNIT_CONVERSION)
    e0 = total_energy(carry.state)
    for _ in range(n_steps):
        carry, aux = step(carry, aux)
    torch.cuda.synchronize()
    counts = dict(cuda_build.launches)
    s = carry.state
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (s.position, s.velocity, s.force, s.potential_energy))
    return counts, total_energy(s) - e0, finite and not bool(carry.overflow)


def _loss_rows(path):
    return [ln for ln in Path(path).read_text().splitlines() if ln.strip()]


def phase_train(results):
    """BASELINE config 5, the NEP trainers, through their entry points on
    the card at config 5's width (plain torch: no hand-written kernel runs
    on the trainer path, and the phase fails if one launches).  A
    synthetic PbTe set (25 rocksalt frames of 216 atoms, a0 6.46 A scaled
    by U(0.97, 1.03), jittered 0.1 A) labelled by the artifacts model
    through the list path in f64; batched_forward at that model's weights
    reproduces the labels, and the chunked population evaluate equals
    single evaluations; app.nep.main trains 20 SNES generations (rows 10
    and 20, the nep.txt it writes runs 20 NVE steps of 4,096 PbTe on the
    compact engine) and resumes to 30; app.gnep.main runs 3 epochs, and a
    run stopped after 2 and resumed writes the same rows, nep.txt and
    gnep.restart."""
    from gpumd_tpu_torch.app import gnep as app_gnep
    from gpumd_tpu_torch.app import nep as app_nep
    from gpumd_tpu_torch.engine import cuda_build
    from gpumd_tpu_torch.io.nep_input import parse_nep_in
    from gpumd_tpu_torch.io.xyz import read_xyz_frames
    from gpumd_tpu_torch.potentials.nep.model import NEP
    from gpumd_tpu_torch.potentials.nep.params import (
        num_trainable, params_from_vector,
    )
    from gpumd_tpu_torch.scripts.pbte_train_set import write_train_set
    from gpumd_tpu_torch.train import snes
    from gpumd_tpu_torch.train.nep_train import batched_forward

    card = _card()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        snes_dir, ga, gb = tmp / "nep", tmp / "gnep_a", tmp / "gnep_b"
        for d in (snes_dir, ga, gb):
            d.mkdir()
        cuda_build.reset_launches()
        # 1. the data, labelled on the card in f64
        t0 = time.perf_counter()
        nep64 = NEP.from_file(str(MODEL), dtype=torch.float64)
        write_train_set(snes_dir / "train.xyz", nep64, n_frames=25, cells=3)
        frames = read_xyz_frames(str(snes_dir / "train.xyz"))
        print(f"[train] data: {len(frames)} PbTe frames of "
              f"{frames[0].n_atoms} atoms labelled by {MODEL.name} through "
              f"the list path in f64 in {time.perf_counter() - t0:.1f} s")
        # 2. the trainer's forward in f32 at the model's weights
        nep32 = NEP.from_file(str(MODEL), dtype=torch.float32)
        (snes_dir / "nep.in").write_text(TRAIN_NEP_IN)
        cfg = parse_nep_in(str(snes_dir / "nep.in"))
        batch, = app_nep.build_batches(frames, cfg.symbols, rc=8.0,
                                       batch_size=cfg.batch_size,
                                       device="cuda")
        with torch.no_grad():
            out = batched_forward(nep32.model, nep32.params, batch)
        na = batch.n_atoms.float()
        rmse_e = float(torch.sqrt(torch.mean(
            ((out.energy - batch.energy_ref) / na) ** 2)))
        rmse_f = float(torch.sqrt(torch.mean(
            (out.force - batch.force_ref) ** 2)))
        rmse_v = float(torch.sqrt(torch.mean(
            ((out.virial - batch.virial_ref) / na[:, None]) ** 2)))
        print(f"[train] batched_forward (f32, MN cut to "
              f"{batch.idx.shape[2]}) vs the labels: RMSE E "
              f"{rmse_e:.3e} eV/atom (bound {TRAIN_E_TOL:.0e}), F "
              f"{rmse_f:.3e} eV/A (bound {TRAIN_F_TOL:.0e}), V "
              f"{rmse_v:.3e} eV/atom (bound {TRAIN_V_TOL:.0e})")
        if not (rmse_e <= TRAIN_E_TOL and rmse_f <= TRAIN_F_TOL
                and rmse_v <= TRAIN_V_TOL):
            raise RuntimeError("the trainer's forward departs from the "
                               "list path's labels")
        model = nep32.model
        d = num_trainable(model)
        rng = np.random.default_rng(9)
        thetas = torch.as_tensor(rng.normal(0, 0.3, (4, d)),
                                 dtype=torch.float32, device="cuda")
        qs = torch.ones(model.dim, device="cuda")
        cfg4 = dataclasses.replace(cfg, population_size=4)
        _, evaluate, _ = snes.make_population_pieces(model, cfg4, qs, 0.0,
                                                     0.0, chunk=2)
        got = evaluate(thetas, batch)
        worst = 0.0
        with torch.no_grad():
            for i in range(4):
                ref = snes.per_type_rmses(model, cfg4, batched_forward(
                    model, params_from_vector(model, thetas[i], qs),
                    batch), batch, do_shift=True)
                for g, r in zip(got, ref):
                    worst = max(worst, float((g[i] - r).abs().max()
                                             / r.abs().max().clamp(
                                                 min=1e-30)))
        print(f"[train] chunked population evaluate (4 individuals, "
              f"chunks of 2) vs single evaluations: max relative "
              f"difference {worst:.3e} (bound {TRAIN_CHUNK_TOL:.0e})")
        if not worst <= TRAIN_CHUNK_TOL:
            raise RuntimeError("the chunked evaluate departs")
        del out, got
        # 3. SNES through app.nep.main: 20 generations, then resume to 30
        (snes_dir / "nep.in").write_text(
            TRAIN_NEP_IN + "generation 20\noutput_interval 10\n")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = app_nep.main([str(snes_dir)])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rows = _loss_rows(snes_dir / "loss.out")
        gens = [int(r.split()[0]) for r in rows]
        ncols = {len(r.split()) for r in rows}
        chunk = snes.population_chunk(cfg.population_size, trainer.batches[0])
        slots = trainer.batches[0].idx.numel()
        per_gen = trainer.train_seconds / trainer.generations_run
        per_slot = peak * 2 ** 30 / (chunk * slots)
        print(f"[train] SNES config 5: D={trainer.d}, population "
              f"{cfg.population_size} in chunks of {chunk}, 1 batch of "
              f"{trainer.batches[0].num_configs} configs, MN "
              f"{trainer.batches[0].idx.shape[2]} ({slots} pair slots); 20 "
              f"generations: {per_gen:.4f} s/generation "
              f"({trainer.train_seconds:.2f} s for the loop, {wall:.2f} s "
              f"for app.nep.main), peak {peak:.3f} GiB ({per_slot:.0f} B "
              f"a slot of a chunk's individual; BYTES_PER_SLOT "
              f"{snes.BYTES_PER_SLOT}); loss.out rows {gens}, columns "
              f"{ncols}; {card}")
        print("[train] loss.out:\n" + "\n".join(rows))
        if gens != [10, 20] or ncols != {10}:
            raise RuntimeError("loss.out rows are not at 10 and 20 with 10 "
                               "columns")
        counts = dict(cuda_build.launches)
        md_counts, de, ok = _trained_md(str(snes_dir / "nep.txt"))
        print(f"[train] the trained nep.txt in DenseNEPMD, 4,096 PbTe, 20 "
              f"NVE steps: finite and no overflow {ok}, total energy "
              f"change {de:+.3e} eV/atom (bound {DRIFT_TOL}), launches "
              f"{ {k: v for k, v in md_counts.items() if v} }")
        if not ok or not abs(de) <= DRIFT_TOL:
            raise RuntimeError("the trained model's MD run failed its gate")
        if min(md_counts[k] for k in ("k1", "k2", "scatter", "fold")) < 20:
            raise RuntimeError("the MD run did not launch its kernels")
        cuda_build.reset_launches()
        (snes_dir / "nep.in").write_text(
            TRAIN_NEP_IN + "generation 30\noutput_interval 10\n")
        app_nep.main([str(snes_dir)])
        gens = [int(r.split()[0]) for r in _loss_rows(snes_dir / "loss.out")]
        print(f"[train] resumed to generation 30: loss.out rows {gens}")
        if gens != [10, 20, 30]:
            raise RuntimeError("the resumed run's row is not numbered 30")
        # 4. gnep: 3 epochs straight; stopped after 2 and resumed
        for g in (ga, gb):
            (g / "train.xyz").symlink_to(snes_dir / "train.xyz")
            (g / "nep.in").write_text(TRAIN_NEP_IN + "epoch 3\n")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        app_gnep.main([str(ga)])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        app_gnep.main([str(gb)], stop_after=2)
        app_gnep.main([str(gb)])
        ra, rb = _loss_rows(ga / "loss.out"), _loss_rows(gb / "loss.out")
        epoch_s = [float(r.split()[-1]) for r in ra]
        cut = 8 + 7 * 13 + 15  # the row's text before the wall time
        same = ([r[:cut] for r in ra] == [r[:cut] for r in rb]
                and all((ga / f).read_bytes() == (gb / f).read_bytes()
                        for f in ("nep.txt", "gnep.restart")))
        print(f"[train] gnep config 5: 3 epochs of 1 batch, s/epoch "
              f"{epoch_s} ({wall:.1f} s for app.gnep.main), peak "
              f"{peak:.2f} GiB; stopped after 2 and resumed equals the "
              f"straight run (rows before the time column, nep.txt, "
              f"gnep.restart): {same}; {card}")
        print("[train] gnep loss.out:\n" + "\n".join(ra))
        if len(ra) != 3 or {len(r.split()) for r in ra} != {10} or not same:
            raise RuntimeError("gnep: rows or the resumed run differ")
        counts = {k: counts[k] + v for k, v in cuda_build.launches.items()}
        launched = {k: v for k, v in counts.items() if v}
        print(f"[train] hand-written kernels launched on the trainer path "
              f"(data, forward, SNES, gnep): {launched or 'none'}")
        if launched:
            raise RuntimeError("the trainer path launched hand-written "
                               "kernels")


def pbte_list_state(nc):
    """PbTe at nc^3 cells with the trained model, f32 on the card, 300 K
    (System's state, without the compact engine's plan): (nep, box,
    state)."""
    from gpumd_tpu_torch.bench import build_pbte, pbte_mass
    from gpumd_tpu_torch.integrate.velocity import initialize_velocity
    from gpumd_tpu_torch.model.box import Box
    from gpumd_tpu_torch.model.state import make_state
    from gpumd_tpu_torch.potentials.nep.model import NEP

    pos, types, lengths = build_pbte(nc, nc, nc)
    nep = NEP.from_file(str(MODEL), dtype=torch.float32)
    box = Box.orthogonal(lengths, dtype=torch.float32)
    state = make_state(pos, pbte_mass(types), types, box)
    return nep, box, initialize_velocity(state, 300.0, seed=3)


def _time_list(results):
    """The list rung at PbTe 262,144 (NVE, ForceField mn 112, skin 1.0,
    total virials, as bench.py's): atom-step/s over 50 steps after
    warm-up with the rebuilds counted, one rebuild, the per-step sync (10
    steps without it), peak memory and a device profile of 5 steps; then
    LJ argon 4,000."""
    from gpumd_tpu_torch.forcefield import ForceField
    from gpumd_tpu_torch.integrate.ensembles.nve import NVE
    from gpumd_tpu_torch.integrate.run import make_md_step
    from gpumd_tpu_torch.potentials.nep.model import CARD_BLOCK
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    def timed(label, ff, state, dt, n, n_steps):
        ens = NVE()
        step = make_md_step(ff, ens, dt, observer=lambda s: None)
        state = ff.compute(state)
        carry = (state, ens.init(state), ff.refresh_cache(state))
        for _ in range(5):  # warm-up
            carry, _ = step(carry)
        rebuilds = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            prev = carry[2]
            carry, _ = step(carry)
            rebuilds += carry[2] is not prev
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = carry[0]
        if (bool(carry[2].count.max() > ff.neighbor.mn)
                or not bool(torch.isfinite(s.position).all())):
            raise RuntimeError(f"{label}: timed block invalid")
        print(f"[time] {label}: {n_steps} steps in {wall:.4f} s, {rebuilds} "
              f"rebuilds: {n * n_steps / wall:.6e} atom-step/s "
              f"({1e3 * wall / n_steps:.3f} ms/step)")
        return step, carry, ens, wall

    with torch.no_grad():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        nep, box, state = pbte_list_state(32)
        n = state.position.shape[0]
        ff = ForceField.create([nep], box, n, mn=112, skin=1.0,
                               per_atom_virial=False)
        label = "262k list rung"
        print(f"[time] {label}: PbTe n={n}, neighbour plan {ff.neighbor}, "
              f"{CARD_BLOCK} atoms a block")
        dt = 1.0 / TIME_UNIT_CONVERSION
        step, carry, ens, wall = timed(label, ff, state, dt, n, 50)
        print(f"[time] {label}: peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache = ff.refresh_cache(carry[0])
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        print(f"[time] {label}: one rebuild (cell list, shifts, reverse "
              f"map) {1e3 * best:.3f} ms")
        # 10 steps without compute_cached's rebuild test and its sync
        state, aux = carry[0], carry[1]
        cache = carry[2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            state, aux = ens.step1(state, aux, dt)
            state = ff._evaluate(state, ff.cache_r12(state, cache))
            state, aux = ens.step2(state, aux, dt)
        torch.cuda.synchronize()
        ms_ns = 1e3 * (time.perf_counter() - t0) / 10
        print(f"[time] {label}: without the per-step rebuild test and its "
              f"host sync: {ms_ns:.3f} ms/step; sync cost "
              f"{1e3 * wall / 50 - ms_ns:.3f} ms/step")

        def adapter(c, a):
            return step(c)[0], a

        t0 = time.perf_counter()
        _profile(adapter, carry, None)
        print(f"[time] {label}: the profile took "
              f"{time.perf_counter() - t0:.1f} s")
        del nep, ff, carry, cache, state
        torch.cuda.empty_cache()
        lj = LJArgon()
        timed("LJ argon 4,000 (list path, 2 fs)", lj.ff, lj.state,
              2.0 / TIME_UNIT_CONVERSION, lj.n, 200)


def _time_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _in_turns(a, b, reps_a, reps_b):
    """Best of two rounds, in turns a, b, b, a."""
    ta, tb = [_time_ms(a, reps_a)], []
    tb += [_time_ms(b, reps_b), _time_ms(b, reps_b)]
    ta.append(_time_ms(a, reps_a))
    return min(ta), min(tb)


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _live_pairs(keep, cp, spec=None):
    """Live (radial, angular) pair slots of this pass: the kernels skip
    dead slots (self, empty, FAR, parked).  Given `spec`, also the live
    slots inside the cutoffs, the only ones that add non-zero terms
    (radial: 0.5 (rc_r[ti] + rc_r[tj]) or the ZBL outer cutoff; angular:
    both types valid and 0.5 (rc_a[ti] + rc_a[tj])), and the live centre
    lanes (not an empty slot or lane padding at FAR with type -1)."""
    from gpumd_tpu_torch.engine.nep_compact import _by_type

    t = keep["tiles"]
    d2 = t[..., 0, :, :] ** 2 + t[..., 1, :, :] ** 2 + t[..., 2, :, :] ** 2
    live = (d2 > 1e-6) & (t[..., 3, :, :] > -0.5)
    counts = (int(live.sum()), int(live[..., :cp.mn_a, :].sum()))
    if spec is None:
        return counts
    nb, mn_r, a_pad = cp.nb, cp.mn_r, cp.a_pad
    c = keep["centers"].reshape(nb, 4, 1, a_pad)
    ct, tj = c[:, 3], t.reshape(nb, 4, mn_r, a_pad)[:, 3]
    d = torch.sqrt(d2.reshape(nb, mn_r, a_pad))
    live = live.reshape(nb, mn_r, a_pad)

    def valid(x):
        return ((torch.abs(x - torch.round(x)) < 0.5) & (x > -0.5)
                & (x < spec.num_types - 0.5))

    in_r = d < 0.5 * (_by_type(ct, spec.rc_radial)
                      + _by_type(tj, spec.rc_radial))
    if spec.zbl_mode:
        in_r = in_r | (d < (spec.zbl_rc_outer if spec.zbl_mode < 3
                            else float("inf")))
    in_a = valid(ct) & valid(tj) & (d < 0.5 * (
        _by_type(ct, spec.rc_angular) + _by_type(tj, spec.rc_angular)))
    lanes = ~((ct <= -0.5) & (c[:, 0] >= 5e4))
    return counts + (int((live & in_r).sum()),
                     int((live & in_a)[:, :cp.mn_a].sum()),
                     int(lanes.sum()))


def _distinct_sources(keep, cp):
    """Distinct source words of one channel that a compaction of this pass
    reads: on the rows path the blocks' windows overlap in the ghost
    rows, so a slot that several blocks keep is counted once."""
    from gpumd_tpu_torch.engine import nep_compact as nc

    cidx = keep["cidx"]
    if nc.rows_compact_eligible(cp):
        g = keep["garr"]
        ids = torch.arange(g[:, :, :1].numel(), dtype=torch.float64,
                           device=g.device).reshape(g[:, :, :1].shape)
        got = nc.compact_rows_plain(ids, cidx, cp)
    else:
        w = keep["cand_win"]
        ids = torch.arange(w[..., :1, :].numel(), dtype=torch.float64,
                           device=w.device).reshape(w[..., :1, :].shape)
        got = nc.compact_windows_plain(ids, cidx, cp)
    return int(torch.unique(got).numel())


def work(name, keep, cp, spec):
    """(bytes, operations) one step's launches of `name` need at this
    pass's shapes: each input read once, each output written once; float
    operations per live pair estimated from the kernel source (an FMA is
    2, a transcendental 1).  `spec` is read by K1 and K2 only."""
    if name in ("k1", "k2"):
        kr1, ka1, na1, nlm = spec.kr1, spec.ka1, spec.na1, spec.nlm
        zbl = 40 if spec.zbl_mode else 0
        rad, ang = _live_pairs(keep, cp)
        if name == "k1":
            ops = (rad * (10 + 6 + 5 * kr1 + zbl)
                   + ang * (6 + 4 * ka1 + 2 * na1 * ka1 + 3 * nlm
                            + 2 * na1 * nlm))
            nb = _nbytes(keep["centers"], keep["cand"], keep["idx"],
                         keep["k1"], keep["tiles"])
        else:
            ops = (rad * (10 + 10 + 12 * kr1 + 2 * zbl + 24)
                   + ang * (10 + 8 * ka1 + 4 * na1 * ka1 + 4 * na1 * nlm
                            + 20 * nlm + 40))
            nb = _nbytes(keep["centers"], keep["tiles"], keep["idx"],
                         keep["cotc"], keep["cotw"], keep["outf"],
                         keep["pvals"])
        return nb, ops
    if name == "scatter":
        idx_a = keep["idx_a"]
        nb = (_nbytes(keep["pvals"], keep.get("cidx"), keep["dcand"])
              + idx_a.numel() * idx_a.element_size())
        return nb, int((keep["pvals"] != 0).sum())
    if name == "fold":
        return _nbytes(keep["dcand"], keep["drows"]), keep["dcand"].numel()
    # compactions: cidx once per launch, the source words the kept lanes
    # index (positions and cot rows), the output
    cidx = keep["cidx"]
    words = 4 * (4 + spec.wch)
    if name == "compact_windows":  # each block reads cl lanes of its own
        src = cidx.numel() * words
    else:
        src = _distinct_sources(keep, cp) * words
    return 2 * _nbytes(cidx) + src + cidx.numel() * words, 0


def bound(nbytes, nops, peak=F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_calls(name, keep, cp):
    """One PyTorch call computing the same function on the same inputs
    (timed only, as a yardstick), or None; inputs are prepared here."""
    from gpumd_tpu_torch.engine.grid import (
        pack_block_windows,
        pack_ghost_rows,
    )

    if name == "scatter":
        nb, pch = cp.nb, keep["pvals"].shape[3]
        vals = keep["pvals"].reshape(nb, pch, -1)
        lanes = keep["idx_a"].reshape(nb, -1).long()
        if keep.get("cidx") is not None:
            lanes = torch.gather(keep["cidx"].reshape(nb, -1).long(), 1,
                                 lanes)
        lanes = lanes[:, None, :].expand(vals.shape).contiguous()
        return [lambda: vals.new_zeros((nb, pch, cp.wl)).scatter_add_(
            2, lanes, vals)]
    if name == "fold":
        plan = cp.base
        nx, ny, nz = plan.grid
        n_slots = nz * ny * nx * plan.cap
        dev = keep["dcand"].device
        ids = torch.arange(n_slots, dtype=torch.float64, device=dev)
        ghost = pack_ghost_rows(ids.reshape(nz, ny, 1, nx * plan.cap), plan,
                                fill=-1.0)
        win = pack_block_windows(ghost, plan, cp.bx, cp.wl, far_channels=0)
        win[..., 9 * (cp.bx + 2) * plan.cap:] = -1.0  # pad lanes: dropped
        dest = win.reshape(-1)
        dest = torch.where((dest >= 0) & (dest < n_slots), dest,
                           torch.full_like(dest, n_slots)).long()
        c = keep["dcand"].shape[2]
        src = keep["dcand"].movedim(2, 0).reshape(c, -1).contiguous()
        return [lambda: src.new_zeros((c, n_slots + 1)).index_add_(
            1, dest, src)]
    if name in ("compact_rows", "compact_windows"):
        cidx = keep["cidx"]
        calls = []
        for key in ("cand_win", "cotw_win"):
            win = keep[key]
            lanes = cidx.long()[:, :, :, None, :].expand(
                tuple(win.shape[:4]) + (cp.cl,)).contiguous()
            calls.append(lambda w=win, i=lanes: torch.gather(w, 4, i))
        return calls
    return None


def _with_windows(keep, cp):
    """Add the packed windows of a rows-path pass (to time compact_windows
    and the library gather on them)."""
    from gpumd_tpu_torch.engine.grid import pack_block_windows

    if "cand_win" not in keep:
        keep["cand_win"] = pack_block_windows(keep["garr"], cp.base, cp.bx,
                                              cp.wl)
        keep["cotw_win"] = pack_block_windows(keep["rows_p"], cp.base, cp.bx,
                                              cp.wl, far_channels=0)
    return keep


def _collect(hooked):
    """A step with an observer as step(carry, aux) -> (carry, aux); the
    observer's rows stay on the card, in step.rows."""
    rows = []

    def step(c, a):
        c, a, _, y = hooked(c, a)
        rows.append(y)
        return c, a

    step.rows = rows
    return step


def _time_rung(sysm, label, n_steps=50, ens=None, observer=None):
    from gpumd_tpu_torch.integrate.ensembles.nve import NVE
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    md, ens = sysm.md, ens or NVE()
    dt = 1.0 / TIME_UNIT_CONVERSION
    print(f"[time] {label}: {sysm.describe()}")
    carry = md.init_carry(sysm.state)
    carry = carry._replace(state=md.compute(carry.state, carry.idx))
    aux = ens.init(carry.state)
    step = md.make_step(ens, dt)
    if observer is not None:
        step = _collect(md.make_step(ens, dt, observer))
    for _ in range(5):  # warm-up
        carry, aux = step(carry, aux)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        carry, aux = step(carry, aux)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if bool(carry.overflow) or not bool(
            torch.isfinite(carry.state.position).all()):
        raise RuntimeError(f"{label}: timed block invalid")
    print(f"[time] {label}: {n_steps} steps in {wall:.4f} s: "
          f"{sysm.n * n_steps / wall:.6e} atom-step/s "
          f"({1e3 * wall / n_steps:.3f} ms/step)")
    # the same steps without the rebuild check's host sync
    state = carry.state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, aux = ens.step1(state, aux, dt)
        state = md.compute(state, carry.idx)
        state, aux = ens.step2(state, aux, dt)
        if observer is not None:
            observer(state)
    torch.cuda.synchronize()
    wall_ns = time.perf_counter() - t0
    print(f"[time] {label}: without the per-step rebuild check and its "
          f"host sync: {1e3 * wall_ns / n_steps:.3f} ms/step; sync cost "
          f"{1e3 * (wall - wall_ns) / n_steps:.3f} ms/step")
    return carry, aux, step, 1e3 * wall / n_steps


def _time_rebuild(sysm, label, reps=3):
    """Wall time of one rebuild (rebin, ghost packing, neighbour lists),
    the work a step whose Verlet check trips adds; best of `reps`."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry = sysm.md.init_carry(sysm.state)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    if bool(carry.overflow):
        raise RuntimeError(f"{label}: rebuild overflowed")
    print(f"[time] {label}: one rebuild {1e3 * best:.3f} ms")
    return 1e3 * best


def _block(step, carry, aux, n_steps):
    """n_steps steps ending in a synchronize: the carry, aux, ms/step and
    the rebuilds, counted by the carry's reference positions, which only a
    rebuild replaces."""
    rebuilds = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        ref = carry.ref_frac
        carry, aux = step(carry, aux)
        rebuilds += carry.ref_frac is not ref
    torch.cuda.synchronize()
    return carry, aux, 1e3 * (time.perf_counter() - t0) / n_steps, rebuilds


def _long_run(sysm, carry, aux, step, rebuild_ms, label, n_steps=500):
    """n_steps more steps with their rebuilds."""
    md = sysm.md
    carry, aux, ms, rebuilds = _block(step, carry, aux, n_steps)
    s = carry.state
    if bool(carry.overflow) or not bool(torch.isfinite(s.position).all()):
        raise RuntimeError(f"{label}: long run invalid")
    d = s.box.minimum_image(s.position - s.box.cartesian(carry.ref_frac))
    umax = float(torch.sqrt(torch.max(torch.sum(d * d, dim=-1) * s.mask)))
    print(f"[time] {label}: {n_steps} more steps, rebuilds included: "
          f"{rebuilds} rebuilds, {sysm.n / ms * 1e3:.6e} atom-step/s "
          f"({ms:.3f} ms/step); rebuild cost over these "
          f"steps {rebuild_ms * rebuilds / n_steps:.3f} ms/step; largest "
          f"displacement since the last rebuild {umax:.4f} A (a rebuild "
          f"at {md.skin / 2:.4f} A)")
    return carry, aux


def _host_ops(step, carry, aux, n=5):
    """Host time of n steps by operator (torch.profiler, CPU side only):
    {op: (calls a step, self CPU ms a step)}, and the carry and aux.  A
    sync's wait for the card shows as its op's self time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            carry, aux = step(carry, aux)
        torch.cuda.synchronize()
    ops = {e.key: (e.count / n, e.self_cpu_time_total / 1e3 / n)
           for e in prof.key_averages()}
    return ops, carry, aux


def _steps_in_turns(runs, n_steps=20, rounds=4):
    """Runs [(label, step, carry, aux)] from their own warmed carries, in
    turns in one process (forward, then backward, `rounds` times): each
    block's ms/step and rebuilds, each run's median; then the host time
    of a step by operator, and the operators where the runs differ most
    against the first run."""
    runs = [list(r) for r in runs]
    ms = {r[0]: [] for r in runs}
    for k in range(rounds):
        for r in (runs if k % 2 == 0 else runs[::-1]):
            r[2], r[3], t, rb = _block(r[1], r[2], r[3], n_steps)
            ms[r[0]].append(t)
            print(f"[time] in turns, round {k}: {r[0]}: {t:.3f} ms/step, "
                  f"{rb} rebuilds in {n_steps} steps")
    for label, ts in ms.items():
        print(f"[time] in turns: {label}: median {np.median(ts):.3f} "
              f"ms/step over {len(ts)} blocks of {n_steps}")
    host = []
    for r in runs:
        ops, r[2], r[3] = _host_ops(r[1], r[2], r[3])
        host.append(ops)
        print(f"[time] host, {r[0]}: {sum(c for c, _ in ops.values()):.0f} "
              f"ops a step, self CPU {sum(t for _, t in ops.values()):.3f} "
              f"ms a step (profiled)")
    for r, ops in zip(runs[1:], host[1:]):
        base = host[0]
        keys = sorted(set(ops) | set(base), key=lambda k: -abs(
            ops.get(k, (0, 0))[1] - base.get(k, (0, 0))[1]))
        for key in keys[:10]:
            (c1, t1), (c0, t0) = ops.get(key, (0, 0)), base.get(key, (0, 0))
            print(f"[time]   {r[0]} - {runs[0][0]}: {t1 - t0:+8.3f} ms, "
                  f"{c1 - c0:+6.1f} calls a step  {key[:60]}")


def _profile(step, carry, aux, n=5):
    """Device time over n steps (torch.profiler): busy and idle share, the
    kernels by name, and the operators that launched them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            carry, aux = step(carry, aux)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type != DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    print(f"[time] profile, {n} steps: wall {wall:.3f} ms/step, device "
          f"busy {busy:.3f} ms/step, idle share {1 - busy / wall:.3f}")
    for what, rows in (("kernel", kernels), ("op", ops)):
        rows.sort(key=lambda e: -e.self_device_time_total)
        for e in rows[:10]:
            ms = e.self_device_time_total / 1e3 / n
            print(f"[time]   {what} {ms:8.3f} ms/step "
                  f"{100 * ms / busy:5.1f}%  {e.key[:64]}")


def _time_kernels(sysm, carry, results=None, pav=False):
    """Every kernel of one rung against its plain version and library call,
    per step; also its bound.  results=None prints without recording; with
    `pav` only K2, the scatter and the fold, at 12 channels, recorded under
    keys ending in _pav."""
    md = sysm.md
    keep = sysm.pipeline(carry, pav)
    pairs = kernel_pairs(md, keep)
    if pav:
        pairs = [p for p in pairs if p[0] in ("k2", "scatter", "fold")]
    names = list(dict.fromkeys(name for name, _, _ in pairs))
    if md.cplan.cl and not pav:
        from gpumd_tpu_torch.engine import nep_compact as nc

        _with_windows(keep, md.cplan)
        if "compact_windows" not in names:
            names.append("compact_windows")
            cidx = keep["cidx"]
            for key in ("cand_win", "cotw_win"):
                pairs.append(("compact_windows",
                              lambda s=keep[key]: nc.compact_windows_call(
                                  s, cidx, md.cplan),
                              lambda s=keep[key]: nc.compact_windows_plain(
                                  s, cidx, md.cplan)))
    sfx = "_pav" if pav else ""
    for name in names:
        mine = [(k, p) for n, k, p in pairs if n == name]
        fast = name not in ("k1", "k2")
        k_ms = p_ms = 0.0
        for kern, plain in mine:
            p, k = _in_turns(plain, kern, 3, 20 if fast else 10)
            k_ms, p_ms = k_ms + k, p_ms + p
        lib = library_calls(name, keep, md.cplan)
        lib_ms = (None if lib is None
                  else sum(_time_ms(f, 20) for f in lib))
        nbytes, nops = work(name, keep, md.cplan, md.spec)
        b_ms, b_by = bound(nbytes, nops)
        lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"[time] {name}{' at 12 channels' if pav else ''}: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"({p_ms / k_ms:.2f}x), library {lib_txt}, bound "
              f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, "
              f"{nops / 1e9:.3f} GFLOP; {100 * b_ms / k_ms:.1f}% of bound)")
        if results is not None:
            results.setdefault(name, {}).update({
                f"ms{sfx}": k_ms, f"plain_ms{sfx}": p_ms,
                f"library_ms{sfx}": lib_ms, f"bound_ms{sfx}": b_ms,
                f"bound_by{sfx}": b_by})
        if name == "fold":
            _fold_design(sysm.describe() + (", 12 channels" if pav else ""),
                         keep, md.cplan, nbytes, k_ms)
        if name == "scatter":
            _scatter_design(sysm.describe() + (", 12 channels" if pav
                                               else ""),
                            keep, md.cplan, k_ms)
    return keep


def _pav_bytes(sysm, carry, label):
    """The per-pair and per-window tensors of one force pass with per-atom
    virials off and on (K2's pvals, the scatter's dcand, the fold's
    drows), and the growth of device memory over the pass (every
    intermediate kept, so above a step's)."""
    sizes = {}
    for pav in (False, True):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        keep = sysm.pipeline(carry, pav)
        torch.cuda.synchronize()
        grow = torch.cuda.max_memory_allocated() - base
        sizes[pav] = {k: _nbytes(keep[k]) for k in ("pvals", "dcand",
                                                     "drows")}
        print(f"[time] {label}, per-atom virials {'on' if pav else 'off'}: "
              + ", ".join(f"{k} {tuple(keep[k].shape)} {v / 2 ** 30:.3f} GiB"
                          for k, v in sizes[pav].items())
              + f"; the pass's peak over its start {grow / 2 ** 30:.3f} GiB")
        del keep
    extra = sum(sizes[True].values()) - sum(sizes[False].values())
    print(f"[time] {label}: 12 channels instead of 4 add {extra / 2 ** 30:.3f}"
          f" GiB in pvals + dcand + drows")


def phase_time(results):
    from gpumd_tpu_torch.bench import HNEMD_FE, NPT_BARO
    from gpumd_tpu_torch.integrate.ensembles.npt import NPTBerendsen
    from gpumd_tpu_torch.measure.properties import heat_current_total

    with torch.no_grad():
        sysm = System(32)
        label = "262k default rung"
        carry, aux, step, _ = _time_rung(sysm, label)
        _profile(step, carry, aux)
        keep = _time_kernels(sysm, carry, results)
        _k_design(sysm.md)
        _live_lines(label, keep, sysm.md.cplan, sysm.md.spec)
        del keep
        carry, aux = _long_run(sysm, carry, aux, step,
                               _time_rebuild(sysm, label), label)
        nve = ("NVE", step, carry, aux)  # in turns with NPT below
        del sysm, carry, aux, step
        jit = System(32, jitter=0.1)
        label = "262k default rung, jittered start"
        carry, aux, step, _ = _time_rung(jit, label)
        _time_kernels(jit, carry)
        _time_rebuild(jit, label)
        del jit, carry, aux, step
        full = System(32, compact_lists=False)
        label = "262k full-window rung"
        carry, aux, step, _ = _time_rung(full, label)
        _profile(step, carry, aux)
        _time_kernels(full, carry)
        _long_run(full, carry, aux, step, _time_rebuild(full, label), label)
        del full, carry, aux, step
        npt = System(32)
        label = "262k default rung, NPT-Berendsen"
        carry, aux, step, _ = _time_rung(npt, label,
                                         ens=NPTBerendsen(**NPT_BARO))
        _profile(step, carry, aux)
        print(f"[time] {label}: box {npt.box.h.diagonal().tolist()} -> "
              f"{carry.state.box.h.diagonal().tolist()} A")
        _steps_in_turns([nve, ("NPT-Berendsen", step, carry, aux)])
        del npt, carry, aux, step, nve
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        hn = System(32, per_atom_virial=True)
        hn.md.hnemd_fe = HNEMD_FE
        label = "262k default rung, HNEMD"
        carry, aux, step, _ = _time_rung(hn, label,
                                         observer=heat_current_total)
        _profile(step, carry, aux)
        print(f"[time] {label}: peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; "
              f"J of the last step {step.rows[-1].tolist()}")
        _time_kernels(hn, carry, results, pav=True)
        del hn, carry, aux, step
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        big = System(50)
        carry = _time_rung(big, "1M default rung", n_steps=20)[0]
        print(f"[time] 1M default rung: peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        _pav_bytes(big, carry, "1M default rung")
        del big, carry
        _time_list(results)


def dense_passes(sysm, carry):
    """One dense_nep_compute_v2 and one dense_nep_compute pass on the
    carry's slot state, keeping each kernel's inputs."""
    from gpumd_tpu_torch.engine import nep_dense as nd

    s, nep = carry.state, sysm.nep
    k2, k1 = {}, {}
    nd.dense_nep_compute_v2(s.position, s.type, s.mask, s.box, sysm.md.plan,
                            nep.model, nep.params, keep=k2)
    nd.dense_nep_compute(s.position, s.type, s.mask, s.box, sysm.md.plan,
                         nep.model, nep.params, keep=k1)
    return k2, k1


def dense_pairs(plan, spec, k2, k1):
    """(name, kernel fn, plain fn) for the four dense kernels."""
    from gpumd_tpu_torch.engine import nep_dense as nd

    c, w, cs, ca = k2["centers"], k2["cand"], k2["cot_s"], k2["cot_a"]
    g, cs1, ca1 = k1["garr"], k1["cot_s"], k1["cot_a"]
    return [
        ("k1b", lambda: nd.k1b_call(c, w, plan, spec),
         lambda: nd.k1b_plain(c, w, plan, spec)),
        ("k2b", lambda: nd.k2b_call(c, w, cs, ca, plan, spec),
         lambda: nd.k2b_plain(c, w, cs, ca, plan, spec)),
        ("dense_k1", lambda: nd.k1_call(g, plan, spec),
         lambda: nd.k1_plain(g, plan, spec)),
        ("dense_k2", lambda: nd.k2_call(g, cs1, ca1, plan, spec),
         lambda: nd.k2_plain(g, cs1, ca1, plan, spec)),
    ]


def phase_dense_kernels(results):
    from gpumd_tpu_torch.engine import nep_dense as nd

    failures = []
    with torch.no_grad():
        # the v2 plan of the MD runs, and PbTe compressed to a0 5.6 A,
        # whose cells' radial and angular queues each take several pieces
        # of the kernels' shared-memory buffers
        for tag, a0 in (("v2 plan", 6.57), ("compressed", 5.6)):
            sysm = System(16, jitter=0.1, engine="v2", a0=a0)
            plan, spec = sysm.md.plan, sysm.md.spec
            print(f"[dense-kernels] {tag}: {sysm.describe()}")
            carry = sysm.md.init_carry(sysm.state)
            if bool(carry.overflow):
                raise RuntimeError(f"v2 {tag}: overflow at init")
            k2, k1 = dense_passes(sysm, carry)
            live = _dense_live(k2, plan, spec)
            lanes = k2["cand"].shape[-1]
            tiles = [nd.dense_tiling(spec, plan.cap, lanes, bwd)
                     for bwd in (False, True)]
            pieces = [_dense_pieces(live, t, lanes, bwd)
                      for t, bwd in zip(tiles, (False, True))]
            most_r, most_a = (int(np.clip(x, 0, None).sum(1).max())
                              for x in live[3:])
            print(f"[dense-kernels] {tag}: per centre {live[0] / sysm.n:.1f} "
                  f"candidate slots, {live[1] / sysm.n:.2f} inside the "
                  f"radial cutoff, {live[2] / sysm.n:.2f} inside the angular "
                  f"one; a cell's queues at most {most_r} radial, "
                  f"{most_a} angular pairs; queue "
                  f"pieces a cell (mean, max): forward {pieces[0][0]:.2f}, "
                  f"{pieces[0][1]}, backward {pieces[1][0]:.2f}, "
                  f"{pieces[1][1]}")
            if tag == "compressed" and not (
                    most_r > tiles[1].qr
                    and most_a > max(t.qa for t in tiles)):
                raise RuntimeError("compressed cell: its queues fit in one "
                                   "piece, so it checks no more than the "
                                   "v2 plan")
            for name, kern, plain in dense_pairs(plan, spec, k2, k1):
                _compare(f"{name}[{tag}]", name, kern(), plain(), results,
                         failures)
            del sysm, carry, k2, k1
    if failures:
        raise RuntimeError(f"kernels disagree with plain versions: {failures}")


def phase_dense_md(results):
    from gpumd_tpu_torch.engine import cuda_build
    from gpumd_tpu_torch.engine import nep_dense as nd

    with torch.no_grad():
        sysm = System(16, engine="v2")
        n = 200
        snap, counts = _md_path("v2 engine", sysm, n, {"k1b": n, "k2b": n})
        for k in ("k1b", "k2b"):
            results.setdefault(k, {})["launches"] = counts[k]
        ref = System(16, engine="v2", plain=True)
        cuda_build.reset_launches()
        _, _, snap_p = _run_steps(ref, 20, snap_at=20)
        if any(cuda_build.launches.values()):
            raise RuntimeError("the plain reference run launched kernels")
        _pos_check("v2 engine, kernels vs plain", sysm.box, snap, snap_p)
        del ref
        _, _, snap_c = _run_steps(System(16), 20, snap_at=20)
        _pos_check("v2 engine vs compact default rung", sysm.box, snap,
                   snap_c)
        # the round-1 path, its counts from 0: dense_nep_compute on a
        # thermal state (20 steps from the lattice) against v2
        carry, _, _ = _run_steps(sysm, 20)
        s, nep = carry.state, sysm.nep
        cuda_build.reset_launches()
        out1 = nd.dense_nep_compute(s.position, s.type, s.mask, s.box,
                                    sysm.md.plan, nep.model, nep.params)
        torch.cuda.synchronize()
        counts = dict(cuda_build.launches)
        out2 = nd.dense_nep_compute_v2(s.position, s.type, s.mask, s.box,
                                       sysm.md.plan, nep.model, nep.params)
        de = float((out1.energy - out2.energy).abs().max())
        df = float((out1.force - out2.force).abs().max())
        fmax = float(out2.force.abs().max())
        print(f"[md] round-1 pass: launches {counts}; vs v2: max |dE| "
              f"{de:.3e} eV, max |dF| {df:.3e} of {fmax:.3e} eV/A")
        if counts["dense_k1"] < 1 or counts["dense_k2"] < 1:
            raise RuntimeError("round-1 pass: kernels not launched")
        if not (torch.isfinite(out1.force).all() and de <= 1e-4
                and df <= 1e-4 * fmax):
            raise RuntimeError("round-1 pass disagrees with v2")
        for k in ("dense_k1", "dense_k2"):
            results.setdefault(k, {})["launches"] = counts[k]


def _dense_live(k2, plan, spec):
    """(candidate slots, pairs inside the radial or ZBL cutoff, pairs
    inside the angular cutoff, and those two a (cell, live centre), in
    slot order, as numpy arrays with -1 past a cell's live centres) of one
    v2 pass: the kernels test every slot and evaluate the live pairs only,
    an empty slot (at FAR, type -1) being no live centre."""
    from gpumd_tpu_torch.engine.nep_dense import _by_type, _cell_chunks

    cap = plan.cap
    c = k2["centers"].reshape(-1, 4, cap)
    w = k2["cand"].reshape(c.shape[0], 4, -1)
    rc, ac = [], []
    for sl in _cell_chunks(c.shape[0], cap, w.shape[2]):
        ci, wj = c[sl, :, :, None], w[sl, :, None, :]
        d2 = sum((wj[:, q] - ci[:, q]) ** 2 for q in range(3))
        tj = wj[:, 3]
        ok = (d2 > 1e-6) & (torch.abs(tj - torch.round(tj)) < 0.5) & (
            tj > -0.5) & (tj < spec.num_types - 0.5)
        d = torch.sqrt(d2)
        rcp_r = 0.5 * (_by_type(ci[:, 3], spec.rc_radial)
                       + _by_type(tj, spec.rc_radial))
        rcp_a = 0.5 * (_by_type(ci[:, 3], spec.rc_angular)
                       + _by_type(tj, spec.rc_angular))
        lr = d < rcp_r
        if spec.zbl:
            lr = lr | (d < spec.zbl_rc_outer)
        rc.append((ok & lr).sum(dim=2))
        ac.append((ok & (d < rcp_a)).sum(dim=2))
    dead = (c[:, 3] <= -0.5) & (c[:, 0] >= 5.0e4)
    rc, ac = torch.cat(rc), torch.cat(ac)
    # live centres first, in slot order (a stable sort on deadness)
    order = torch.sort(dead.to(torch.int8), dim=1, stable=True).indices
    rc = torch.where(dead, -1, rc).gather(1, order).cpu().numpy()
    ac = torch.where(dead, -1, ac).gather(1, order).cpu().numpy()
    return (c.shape[0] * cap * w.shape[2], int(rc[rc > 0].sum()),
            int(ac[ac > 0].sum()), rc, ac)


def _dense_pieces(live, tile, lanes, backward):
    """Queue pieces a cell of a kernel at its cut (mean, max): each group
    of tile.gc live centres has its own queues; the forward runs a group's
    radial queue in pieces of tile.qr pairs, then its angular one in pieces
    of tile.qa; the backward runs the k-th of each together.  The live
    counts are over all of a cell's lanes, so a cut into windows is
    refused."""
    if tile.cw < lanes:
        raise ValueError(f"a window of {tile.cw} of {lanes} lanes: the "
                         f"piece count holds for one window only")
    n = []
    for rc, ac in zip(live[3], live[4]):
        rc, ac = rc[rc >= 0], ac[ac >= 0]
        k = 0
        for c0 in range(0, len(rc), tile.gc):
            pr = -(-int(rc[c0:c0 + tile.gc].sum()) // tile.qr)
            pa = -(-int(ac[c0:c0 + tile.gc].sum()) // tile.qa)
            k += max(pr, pa) if backward else pr + pa
        n.append(k)
    return float(np.mean(n)), int(np.max(n))


def dense_work(name, k2, k1, live, spec):
    """(bytes, operations) of one launch: each input read once, each output
    written once; float operations from the kernel source (an FMA 2, a
    transcendental 1): ~10 per candidate slot tested, and per live pair
    the Chebyshev basis, ZBL, Y_lm or their derivatives and the sums."""
    slots, rad, ang = live[:3]
    kr1, ka1, nlm, sw = spec.kr1, spec.ka1, spec.nlm, spec.s_width
    zt = sum((L + 1) ** 2 for L in range(1, spec.l_max + 1))
    zbl = 40 if spec.zbl else 0
    if name in ("dense_k1", "dense_k2"):  # 27 cap candidates, no pad lanes
        slots = slots * 27 * k2["centers"].shape[-1] // k2["cand"].shape[-1]
    if name in ("k1b", "dense_k1"):
        ops = (10 * slots + rad * (15 + 6 * kr1 + sw + zbl)
               + ang * (16 + 6 * ka1 + 2 * zt + 2 * nlm + 2 * ka1 * nlm))
    else:
        ops = (10 * slots + rad * (20 + 14 * kr1 + 2 * zbl)
               + ang * (30 + 12 * ka1 + 4 * ka1 * nlm + 4 * zt + 10 * nlm))
    nb = {"k1b": (k2["centers"], k2["cand"], k2["s"], k2["a"]),
          "k2b": (k2["centers"], k2["cand"], k2["cot_s"], k2["cot_a"],
                  k2["dcenter"], k2["dcand"]),
          "dense_k1": (k1["garr"], k1["s"], k1["a"]),
          "dense_k2": (k1["garr"], k1["cot_s"], k1["cot_a"], k1["g"])}[name]
    return _nbytes(*nb), ops


def phase_dense_time(results):
    with torch.no_grad():
        sysm = System(32, engine="v2")
        label = "262k v2 engine"
        carry, aux, step, _ = _time_rung(sysm, label)
        _profile(step, carry, aux)
        k2, k1 = dense_passes(sysm, carry)
        spec = sysm.md.spec
        live = _dense_live(k2, sysm.md.plan, spec)
        print(f"[time] {label}: per centre {live[0] / sysm.n:.1f} candidate "
              f"slots, {live[1] / sysm.n:.2f} radial and "
              f"{live[2] / sysm.n:.2f} angular live pairs")
        for name, kern, plain in dense_pairs(sysm.md.plan, spec, k2, k1):
            p_ms, k_ms = _in_turns(plain, kern, 1, 10)
            nbytes, nops = dense_work(name, k2, k1, live, spec)
            b_ms, b_by = bound(nbytes, nops)
            print(f"[time] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
                  f"({p_ms / k_ms:.2f}x), library n/a, bound {b_ms:.4f} ms "
                  f"by {b_by} ({nbytes / 1e6:.1f} MB, {nops / 1e9:.3f} "
                  f"GFLOP; {100 * b_ms / k_ms:.1f}% of bound)")
            _dense_design(name, sysm, k2, live, nbytes, k_ms)
            results.setdefault(name, {}).update(
                ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by)
        del k2, k1
        _time_rebuild(sysm, label)
        del sysm, carry, aux, step
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        big = System(50, engine="v2")
        _time_rung(big, "1M v2 engine", n_steps=20)
        print(f"[time] 1M v2 engine: peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")


def _dense_design(name, sysm, k2, live, nbytes, ms):
    """What the dense kernels' design acts on at this plan: ptxas's
    registers, stack and spill of the model's instance, the block's cut
    and shared memory, resident blocks an SM by the occupancy query, the
    live pairs a centre, queue pieces a cell, and the rate reached."""
    from gpumd_tpu_torch.engine import nep_dense as nd

    plan, spec = sysm.md.plan, sysm.md.spec
    backward = name in ("k2b", "dense_k2")
    lanes = k2["cand"].shape[-1] if name in ("k1b", "k2b") else 27 * plan.cap
    tile = nd.dense_tiling(spec, plan.cap, lanes, backward)
    entry = nd.dense_entry(spec, backward)
    px = _ptxas_entry(entry)
    occ = nd.dense_occupancy(spec, tile, plan.cap, backward)
    mean, most = _dense_pieces(live, tile, lanes, backward)
    print(f"[design] {name} instance {entry}: {px['regs']} registers, "
          f"{px['stack']} B stack frame, {px['spill_stores']} B spill "
          f"stores, {px['spill_loads']} B spill loads; {tile.smem} B shared "
          f"memory a block (a window of {tile.cw} lanes, a group of "
          f"{tile.gc} centres, pieces of {tile.qr} radial / {tile.qa} "
          f"angular pairs), {occ} blocks = {8 * occ} warps resident an "
          f"SM; "
          f"per centre {live[1] / sysm.n:.2f} radial and "
          f"{live[2] / sysm.n:.2f} angular live pairs; {mean:.2f} queue "
          f"pieces a cell (at most {most}); "
          f"{nbytes / ms / 1e9:.3f} TB/s reached")
    if occ < 1:
        raise RuntimeError(f"{entry}: no resident block")


def _tersoff_live(keep, cp, spec):
    """Live bonds (fc > 0 candidates: d < R2, real centre and neighbour),
    ordered live bond pairs (j != k), live centres and the centres past the
    kernel's live cap (its general path) of this pass: the kernel's work."""
    from gpumd_tpu_torch.engine.nep_compact import _gather_lanes
    from gpumd_tpu_torch.engine.tersoff_compact import tersoff_live_cap

    nb, mn, a_pad = cp.nb, cp.mn_r, cp.a_pad
    c = keep["centers"].reshape(nb, 4, 1, a_pad)
    g = _gather_lanes(keep["cand"].reshape(nb, 4, -1),
                      keep["idx"].reshape(nb, mn, a_pad))
    d2 = sum((g[:, q] - c[:, q]) ** 2 for q in range(3))
    t = spec.num_types
    ti = torch.clamp(torch.round(c[:, 3]), 0, t - 1).long()
    tj = torch.clamp(torch.round(g[:, 3]), 0, t - 1).long()
    r2 = torch.as_tensor(spec.r2, device=d2.device)[ti * t + tj]
    live = ((d2 > 1e-6) & (g[:, 3] > -0.5) & (c[:, 3] > -0.5)
            & (d2 < r2 * r2))
    nl = live.sum(dim=1).double()
    past = int((nl > tersoff_live_cap()).sum())
    return (int(nl.sum()), int((nl * (nl - 1)).sum()),
            int((c[:, 3, 0] > -0.5).sum()), past)


def tersoff_work(keep, cp, spec, fused):
    """(bytes, operations) of one launch of a tersoff mode, from the
    shapes: each input read once (centres, window, lanes), each output
    written once (outf; pvals (pch, mn, a_pad) a block, or the window
    cotangents (pch, wl) a block); float operations from the kernel source
    (an FMA 2, a transcendental 1): ~10 per slot (gather, distance), ~80 per
    live bond (cutoff, exponentials, bond order, p_j, virial), ~47 per
    ordered live bond pair (12 in pass 1, 35 in pass 2) and, fused, one
    shared-memory add per channel of each live bond."""
    bonds, pairs, _, _ = _tersoff_live(keep, cp, spec)
    pch = keep["dcand"].shape[2]
    out = cp.wl if fused else cp.mn_r * cp.a_pad
    nb = (_nbytes(keep["centers"], keep["cand"], keep["idx"], keep["outf"])
          + 4 * cp.nb * pch * out)
    ops = 10 * keep["idx"].numel() + 80 * bonds + 47 * pairs
    if fused:
        ops += (12 if pch == 12 else 3) * bonds
    return nb, ops


def _tersoff_design(label, keep, cp, spec, pav, nbytes, ms, fused):
    """What the tersoff kernel's design acts on at this plan: ptxas's
    registers, stack and spill of the instance, its shared memory and the
    resident blocks an SM (occupancy query), the live bonds a live centre
    and the centres past the live cap (the general path), the rate."""
    from gpumd_tpu_torch.engine import tersoff_compact as tc

    entry = tc.tersoff_entry(fused, cp, pav)
    px = _ptxas_entry(entry)
    blocks, smem = tc.tersoff_occupancy(fused, cp, pav)
    if smem != tc.tersoff_smem(fused, cp.wl, cp.mn_r, pav):
        raise RuntimeError(f"{entry}: launcher's shared memory {smem} B is "
                           "not the wrapper's")
    bonds, _, centres, past = _tersoff_live(keep, cp, spec)
    print(f"[design] {'tersoff_scatter' if fused else 'tersoff'} {label}: "
          f"instance {entry}: {px['regs']} registers, {px['stack']} B stack "
          f"frame (the general path's bonds), {px['spill_stores']} B spill "
          f"stores, {px['spill_loads']} B spill loads; {smem} B shared "
          f"memory a block, {blocks} blocks an SM by the occupancy query; "
          f"{bonds / max(centres, 1):.3f} live bonds a live centre, {past} "
          f"of {centres} centres past the live cap of "
          f"{tc.tersoff_live_cap()}; "
          f"{nbytes / ms / 1e9:.3f} TB/s reached")
    return {"regs": px["regs"], "stack": px["stack"],
            "spill_stores": px["spill_stores"], "smem": smem,
            "blocks_per_sm": blocks, "past_cap": past}


def phase_tersoff_kernels(results, pot_path):
    failures = []
    with torch.no_grad():
        sysm = TersoffSystem(16, pot_path, jitter=0.1)
        print(f"[tersoff-kernels] {sysm.describe()}")
        carry = sysm.md.init_carry(sysm.state)
        if bool(carry.overflow):
            raise RuntimeError("tersoff: overflow at init")
        for pav in (False, True):
            keep = sysm.pipeline(carry, pav)
            if not pav:
                bonds, pairs, _, past = _tersoff_live(keep, sysm.md.cplan,
                                                      sysm.md.spec)
                print(f"[tersoff-kernels] live bonds per atom "
                      f"{bonds / sysm.n:.3f}, ordered bond pairs per atom "
                      f"{pairs / sysm.n:.3f}, centres past the live cap "
                      f"{past}")
            for name, kern, plain in tersoff_pairs(sysm.md, keep):
                tag = f"{name}[tersoff{',pav' if pav else ''}]"
                _compare(tag, name, kern(), plain(), results, failures,
                         pav=pav)
        del sysm, carry, keep
        # compressed: 16 live bonds a centre, every one on the general path
        dense = TersoffSystem(8, pot_path, jitter=0.05, a0=4.1)
        print(f"[tersoff-kernels] {dense.describe()}")
        carry = dense.md.init_carry(dense.state)
        if bool(carry.overflow):
            raise RuntimeError("tersoff: overflow at init (a0 4.1)")
        for pav in (False, True):
            keep = dense.pipeline(carry, pav)
            _, _, centres, past = _tersoff_live(keep, dense.md.cplan,
                                                dense.md.spec)
            if past != centres:
                raise RuntimeError(f"a0 4.1: {past} of {centres} centres "
                                   "past the live cap, expected all")
            for name, kern, plain in tersoff_pairs(dense.md, keep)[:2]:
                tag = f"{name}[tersoff a0 4.1{',pav' if pav else ''}]"
                _compare(tag, name, kern(), plain(), results, failures,
                         pav=pav)
    if failures:
        raise RuntimeError(f"kernels disagree with plain versions: {failures}")


def phase_tersoff_md(results, pot_path):
    from gpumd_tpu_torch.engine import cuda_build
    from gpumd_tpu_torch.engine import tersoff_compact as tc
    from gpumd_tpu_torch.integrate.ensembles.nvt import (
        NVTBerendsen,
        NVTNoseHooverChain,
    )

    runs = [("NVE", None, 200),
            ("NVT-NHC", lambda: NVTNoseHooverChain(t0=300.0, t1=300.0,
                                                    coupling=100.0), 100),
            ("NVT-Berendsen", lambda: NVTBerendsen(t0=300.0, t1=300.0,
                                                   coupling=100.0), 50)]
    kernels = ("tersoff_scatter", "fold")
    with torch.no_grad():
        sysm = TersoffSystem(16, pot_path)
        ref = TersoffSystem(16, pot_path, plain=True)
        for label, make, n in runs:
            snap, counts = _md_path(f"tersoff {label}", sysm, n,
                                    {k: n + 1 for k in kernels},
                                    ens=make and make(),
                                    never=("tersoff", "scatter"))
            if label == "NVE":
                results.setdefault("tersoff_scatter", {})["launches"] = \
                    counts["tersoff_scatter"]
            cuda_build.reset_launches()
            _, _, snap_p = _run_steps(ref, 20, snap_at=20,
                                      ens=make and make())
            if any(cuda_build.launches.values()):
                raise RuntimeError("the plain reference run launched kernels")
            _pos_check(f"tersoff {label}, kernels vs plain", sysm.box, snap,
                       snap_p)
        del ref, sysm
        torch.cuda.empty_cache()
        # a window too wide for the fused kernel's accumulator (cap 320, wl
        # 8,704): the contract kernel and the scatter in its place, against
        # the default plan's run of the same atoms.  4,096 atoms: the
        # rebuild holds a z slab's (a_pad, wl) distances, 1.3 GB a tensor
        # here, 5.9 GB at 32,768
        small = TersoffSystem(8, pot_path)
        wide = TersoffSystem(8, pot_path, cap=320)
        if tc.fused_fits(wide.md.cplan, False) \
                or not tc.fused_fits(small.md.cplan, False):
            raise RuntimeError("4,096 Si: routes not as planned")
        snap_s, _ = _md_path("tersoff NVE, 4,096 Si", small, 20,
                             {k: 21 for k in kernels},
                             never=("tersoff", "scatter"))
        snap_w, counts = _md_path("tersoff NVE, 4,096 Si at cap 320", wide,
                                  20, {k: 21 for k in ("tersoff", "scatter",
                                                       "fold")},
                                  never=("tersoff_scatter",))
        results.setdefault("tersoff", {})["launches"] = counts["tersoff"]
        _pos_check("tersoff NVE, cap 320 vs the default plan", small.box,
                   snap_w, snap_s)


def phase_tersoff_time(results, pot_path):
    from gpumd_tpu_torch.integrate.ensembles.nvt import NVTNoseHooverChain

    with torch.no_grad():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        big = TersoffSystem(50, pot_path)
        label = "1M Si NVE"
        carry, aux, step, ms_nve = _time_rung(big, label)
        _profile(step, carry, aux)
        print(f"[time] 1M Si: peak memory of the step "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        md = big.md
        keep = big.pipeline(carry, False)
        for name, kern, plain in tersoff_pairs(md, keep):
            p_ms, k_ms = _in_turns(plain, kern, 2, 10)
            fused = name == "tersoff_scatter"
            lib_ms = None  # no single PyTorch call computes a tersoff mode
            if name in ("tersoff", "tersoff_scatter"):
                nbytes, nops = tersoff_work(keep, md.cplan, md.spec, fused)
            else:
                nbytes, nops = work(name, keep, md.cplan, None)
                lib = library_calls(name, keep, md.cplan)
                lib_ms = sum(_time_ms(f, 20) for f in lib)
            b_ms, b_by = bound(nbytes, nops)
            lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
            print(f"[time] 1M Si {name}: kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms ({p_ms / k_ms:.2f}x), library {lib_txt}, "
                  f"bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, "
                  f"{nops / 1e9:.3f} GFLOP; {100 * b_ms / k_ms:.1f}% of "
                  f"bound)")
            row = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
            if name in ("tersoff", "tersoff_scatter"):
                row.update(_tersoff_design(label, keep, md.cplan, md.spec,
                                           False, nbytes, k_ms, fused))
                results.setdefault(name, {}).update(row)
            else:  # the scatter and fold rows are PbTe's; Si 1M beside
                results.setdefault(name, {}).update(
                    {f"{k}_si1m": v for k, v in row.items()
                     if k != "bound_by"})
            if name == "fold":
                _fold_design(label, keep, md.cplan, nbytes, k_ms)
            if name == "scatter":
                _scatter_design(f"{label}, contract pvals", keep, md.cplan,
                                k_ms)
        del keep
        _time_rebuild(big, label)
        del carry, aux, step
        _, _, _, ms_nhc = _time_rung(big, "1M Si NVT-NHC",
                                     ens=NVTNoseHooverChain(
                                         t0=300.0, t1=300.0, coupling=100.0))
        print(f"[time] 1M Si: NVT-NHC costs {ms_nhc - ms_nve:.3f} ms/step "
              f"more than NVE (the chain's two host syncs and scalar "
              f"integration a step)")
        print(f"[time] 1M Si: peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")


def _ptxas_report():
    """The build's nvcc/ptxas report, saved beside the library (also when
    the library came from the cache)."""
    from gpumd_tpu_torch.engine import cuda_build

    return (Path(cuda_build.build_info["path"]).parent
            / "ptxas.txt").read_text()


def _ptxas_entry(name):
    """What ptxas reported for the first kernel entry whose (mangled) name
    contains `name`, in the build's report: registers, stack frame, spill
    stores and spill loads, static shared memory (bytes)."""
    report = _ptxas_report()
    hit = re.search(rf"Compiling entry function '[^']*{re.escape(name)}",
                    report)
    rest = report[hit.start():] if hit else ""
    # the entry's own lines: up to the next entry (a kernel without
    # shared memory prints no smem line of its own)
    nxt = rest.find("Compiling entry function", 1)
    rest = rest if nxt < 0 else rest[:nxt]
    keys = {"regs": r"Used (\d+) registers",
            "stack": r"(\d+) bytes stack frame",
            "spill_stores": r"(\d+) bytes spill stores",
            "spill_loads": r"(\d+) bytes spill loads",
            "smem": r"(\d+) bytes smem"}
    out = {}
    for key, pat in keys.items():
        m = re.search(pat, rest)
        out[key] = int(m.group(1)) if m else None
    return out


def _fold_design(label, keep, cp, nbytes, ms):
    """What the fold's design acts on at this plan: ptxas's registers,
    stack and spill of the plan's instance, its shared memory (none), the
    plan (unit width, threads, rows), the resident blocks an SM by the
    occupancy query, and the rate reached.  Fails on local memory or no
    resident block."""
    from gpumd_tpu_torch.engine import fold_kernel as fk

    dcand = keep["dcand"]
    fp = fk.fold_plan(cp.base, cp.bx, dcand.shape[2], dcand.shape[4])
    px = _ptxas_entry(fp.entry)
    occ = fk.fold_occupancy(fp)
    waves = fp.blocks / (_sms() * max(occ, 1))
    print(f"[design] fold {label}: instance {fp.entry}: {px['regs']} "
          f"registers, {px['stack']} B stack frame, {px['spill_stores']} B "
          f"spill stores, {px['smem'] or 0} B shared memory; units of "
          f"{fp.vec} floats, {fp.units} a row, {fp.threads} threads a block, "
          f"{fp.blocks} blocks (rows), {occ} blocks an SM by the occupancy "
          f"query, {waves:.2f} waves; "
          f"{nbytes / ms / 1e9:.3f} TB/s reached")
    if px["stack"] or px["spill_stores"] or occ < 1:
        raise RuntimeError(f"{fp.entry}: local memory or no resident block")


def _scatter_design(label, keep, cp, ms=None):
    """What the scatter's design acts on at this plan: ptxas's registers,
    stack and spill of the plan's instance, shared memory a CTA, resident
    CTAs an SM (occupancy query), channels a CTA, the grid, and the rate
    reached beside the byte bound (`ms` the kernel's time, else timed here
    over 20 launches).  Fails on local memory or no resident CTA."""
    from gpumd_tpu_torch.engine import nep_compact as nc

    pvals, idx_a, cidx = keep["pvals"], keep["idx_a"], keep.get("cidx")
    sp = nc.scatter_plan(cp.nb, pvals.shape[3], cp.wl, pvals.shape[5])
    px = _ptxas_entry(sp.entry)
    occ = nc.scatter_occupancy(sp)
    if ms is None:
        ms = _time_ms(lambda: nc.scatter_call(pvals, idx_a, cp, cidx), 20)
    nbytes, _ = work("scatter", keep, cp, None)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[design] scatter {label}: instance {sp.entry}: {px['regs']} "
          f"registers, {px['stack']} B stack frame, {px['spill_stores']} B "
          f"spill stores; {sp.smem} B shared memory a CTA, {occ} CTAs an SM "
          f"by the occupancy query, {sp.group} channels a CTA "
          f"({sp.groups} CTAs a block), grid {sp.ctas} CTAs of 256 threads; "
          f"{ms:.4f} ms, {nbytes / ms / 1e9:.3f} TB/s, "
          f"{100 * b_ms / ms:.1f}% of the byte bound {b_ms:.4f} ms")
    if px["stack"] or px["spill_stores"] or occ < 1:
        raise RuntimeError(f"{sp.entry}: local memory or no resident CTA")


def _k_design(md):
    """What the K1/K2 design acts on, for the instances the model uses:
    ptxas's registers, stack frame and spills, the shared memory of a
    block at this plan and the resident blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    from gpumd_tpu_torch.engine import nep_compact as nc

    for name in ("k1", "k2"):
        entry = nc.kernel_entry(name, md.spec)
        px = _ptxas_entry(entry)
        lay = nc.kernel_layout(name, md.spec, md.cplan)
        occ = nc.kernel_occupancy(name, md.spec, md.cplan)
        clean = px["stack"] == 0 and px["spill_stores"] == 0
        print(f"[design] {name} instance {entry}: {px['regs']} registers, "
              f"{px['stack']} B stack frame, {px['spill_stores']} B spill "
              f"stores, {px['spill_loads']} B spill loads "
              f"({'no local memory' if clean else 'LOCAL MEMORY'}); "
              f"{lay.smem} B shared memory a block (queue chunks of "
              f"< {lay.qcap + md.cplan.mn_a} pairs, <= {lay.ccap} centres), "
              f"{occ} blocks = {8 * occ} warps resident an SM")


def _live_lines(label, keep, cp, spec):
    """Live centre lanes against a_pad, and live pair slots against the
    slots inside the cutoffs (the pairs the kernels evaluate)."""
    rad, ang, rad_in, ang_in, lanes = _live_pairs(keep, cp, spec)
    n = cp.nb * cp.a_pad
    print(f"[design] {label}: live centre lanes {lanes} of {n} "
          f"({100 * lanes / n:.1f}%); per live centre {rad / lanes:.2f} "
          f"live radial slots, {rad_in / lanes:.2f} inside the radial or "
          f"ZBL cutoff; {ang / lanes:.2f} live angular slots, "
          f"{ang_in / lanes:.2f} inside the angular cutoff")


def _probe_checks(results, failures):
    """Every probe kernel against its plain version on random inputs at the
    shapes the probes' path gives it (the gather at G 256, bench_mxu_probes
    at 1,734 blocks), the blocked gather with indices out of range."""
    from gpumd_tpu_torch.probes import bench_gather as BG
    from gpumd_tpu_torch.probes import bench_mxu_probes as MX
    from gpumd_tpu_torch.probes import probe_transcendentals as PT

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    table, idx = BG.make_inputs(device=dev, seed=5)
    g, w, s = table.shape[0], table.shape[1], idx.shape[1]
    _compare(f"probe_gather[W {w}, S {s}, G {g}]", "probe_gather",
             BG.gather_call(table, idx), BG.gather_plain(table, idx),
             results, failures)
    del table, idx
    x = torch.cat([torch.linspace(1e-3, 3.2, 4096),
                   torch.linspace(1.0, 120.0, 4096)]).reshape(8, 1024).to(dev)
    _compare("probe_transcendentals[(8, 1024)]", "probe_transcendentals",
             PT.run(x), PT.run_plain(x), results, failures)
    nb = MX.NB_FULL // 8
    for m, k in ((144, 4096), (72, 4096), (144, 3072), (88, 3072),
                 (108, 4096), (96, 3072)):
        vals = randn(nb, m, k)
        for ksplit in ((1, 4) if (m, k) == (144, 4096) else (1,)):
            ref = MX.onehot_dot_plain(vals, 128, ksplit)
            for prec in MX.PRECISIONS:
                got = MX.onehot_dot(vals, 128, ksplit, prec)
                label = (f"probe_onehot_dot[nb {nb}, {m}x{k}x128, ksplit "
                         f"{ksplit}, {prec}]")
                _compare(label, "probe_onehot_dot", got, ref, results,
                         failures,
                         tol=None if prec == "default" else TOL_F32_PRODUCT)
                if prec == "highest" and (m, k) == (144, 4096):
                    _f32_error(label, vals, ksplit, got, ref, results,
                               failures, f"ksplit{ksplit}")
                del got
            del ref
        del vals
    # the FFMA kernel, the f32 path's launch for what the ring cannot
    # take: here the timed shape on a base 4 bytes past 16-byte alignment
    m, k = 144, 4096
    vals = randn(nb * m * k + 1)[1:].view(nb, m, k)
    label = (f"probe_onehot_dot[nb {nb}, {m}x{k}x128, ksplit 1, highest, "
             f"base + 4 B: FFMA kernel]")
    if MX.onehot_f32_on_ring(k, vals.data_ptr()):
        failures.append(f"{label}: the shape chose the ring")
    ref = MX.onehot_dot_plain(vals, 128)
    got = MX.onehot_dot(vals, 128, 1, "highest")
    _compare(label, "probe_onehot_dot", got, ref, results, failures,
             tol=TOL_F32_PRODUCT)
    _f32_error(label, vals, 1, got, ref, results, failures, "ffma")
    del vals, ref, got
    _f32_exact_rows(nb, gen, results, failures)
    vals = randn(nb, 32 * 8, 128)
    for ch in (24, 168):
        _compare(f"probe_feature_matmul[nb {nb}, mn 32, k 8, ch {ch}]",
                 "probe_feature_matmul", MX.feature_matmul(vals, ch),
                 MX.feature_matmul_plain(vals, ch), results, failures)
    del vals
    g, y = randn(nb, 4 * 8 * 7, 128), randn(nb, 4 * 8 * 24, 128)
    ref = MX.pair_reduce_plain(g, y)
    got = {}
    for order in MX.ORDERS:
        got[order] = MX.pair_reduce(g, y, order=order)
        _compare(f"probe_pair_reduce[nb {nb}, {order}]", "probe_pair_reduce",
                 got[order], ref, results, failures)
    # both orders sum a channel in chunk, then row order with fmaf
    same = torch.equal(got["tiled"], got["spill"])
    print(f"[check] probe_pair_reduce[nb {nb}]: tiled "
          f"{'equals' if same else 'DIFFERS FROM'} spill bit for bit")
    if not same:
        failures.append("probe_pair_reduce tiled != spill")
    del g, y, ref, got
    # the spill order past 256 lanes: several lane tiles a b
    for lanes in (1024, 300):
        g, y = randn(9, 4 * 8 * 7, lanes), randn(9, 4 * 8 * 24, lanes)
        spill = MX.pair_reduce(g, y, order="spill")
        _compare(f"probe_pair_reduce[nb 9, {lanes} lanes, spill]",
                 "probe_pair_reduce", spill, MX.pair_reduce_plain(g, y),
                 results, failures)
        same = torch.equal(spill, MX.pair_reduce(g, y, order="tiled"))
        print(f"[check] probe_pair_reduce[nb 9, {lanes} lanes]: spill "
              f"{'equals' if same else 'DIFFERS FROM'} tiled bit for bit")
        if not same:
            failures.append(f"probe_pair_reduce spill != tiled at {lanes}")
        del g, y, spill
    # the script's shapes with indices out of range, its zero indices, a
    # window past what one block's shared memory held before (nblk 27) and
    # one block of 128 columns
    for nblk, chunks, zeros in ((18, 14, False), (11, 14, False),
                                (11, 12, False), (18, 14, True),
                                (27, 14, False), (1, 14, False)):
        width = 128 * nblk
        src = randn(nb, 17, width)
        shape = (nb, 8 * chunks, 128)
        idx = (torch.zeros(shape, device=dev, dtype=torch.int32) if zeros
               else torch.randint(-64, width + 64, shape, generator=gen,
                                  device=dev, dtype=torch.int32))
        what = "zero indices" if zeros else "indices out of range"
        _compare(f"probe_bgather[nb {nb}, nblk {nblk}, chunks {chunks}, "
                 f"{what}]", "probe_bgather", MX.bgather(src, idx),
                 MX.bgather_plain(src, idx), results, failures)
        del src, idx


def _f32_error(label, vals, ksplit, got, ref, results, failures, key):
    """The f32 path's error against the product in f64, beside that of f32
    torch.matmul (TF32 off) on the same random inputs; the kernel's must be
    at most F32_ERROR_RATIO times the library's."""
    from gpumd_tpu_torch.probes import bench_mxu_probes as MX

    exact = MX.onehot_dot_plain(vals.double(), 128, ksplit)
    err = float((got.double() - exact).abs().max())
    err_lib = float((ref.double() - exact).abs().max())
    del exact
    ok = err <= F32_ERROR_RATIO * err_lib
    print(f"[check] {label} against f64: kernel max abs error {err:.3e}, "
          f"f32 torch.matmul {err_lib:.3e} ({err / err_lib:.2f}x; limit "
          f"{F32_ERROR_RATIO:.0f}x): {'ok' if ok else 'FAILED'}")
    results.setdefault("probe_onehot_dot", {})[
        f"f64_error_ratio_highest_{key}"] = err / err_lib
    if not ok:
        failures.append(f"{label}: error against f64 {err:.3e} above "
                        f"{F32_ERROR_RATIO} x torch.matmul's {err_lib:.3e}")


def _f32_exact_rows(nb, gen, results, failures):
    """The f32 path on rows of one random normal value each, at a random
    column: every row sum is exact in f32, so the kernel must give the f64
    product bit for bit.  A kernel that dropped the mid or lo term of the
    split (lo is non-zero in about half such values) would not; this is
    what the f64 error check cannot see, since a lo term is below 2^-21 of
    its value.  The ring at ksplit 1 and 4, and the FFMA kernel on a base
    4 bytes past 16-byte alignment."""
    from gpumd_tpu_torch.probes import bench_mxu_probes as MX

    m, k = 144, 4096
    dev = torch.device("cuda")
    for ksplit, offset in ((1, 0), (4, 0), (1, 1)):
        vals = torch.zeros(nb * m * k + offset, device=dev)[offset:]
        vals = vals.view(nb, m, k)
        col = torch.randint(0, k, (nb, m, 1), generator=gen, device=dev)
        one = torch.randn((nb, m, 1), generator=gen, device=dev)
        vals.scatter_(2, col, one)
        lo_terms = int((MX.tf32_split(one)[2] != 0).sum())
        route = ("ring" if MX.onehot_f32_on_ring(k, vals.data_ptr())
                 else "ffma")
        got = MX.onehot_dot(vals, 128, ksplit, "highest")
        exact = MX.onehot_dot_plain(vals.double(), 128, ksplit).float()
        bad = int((got != exact).sum())
        ok = bad == 0 and route == ("ring" if offset == 0 else "ffma")
        print(f"[check] probe_onehot_dot[nb {nb}, {m}x{k}x128, ksplit "
              f"{ksplit}, highest, one value a row, {route}]: {bad} of "
              f"{got.numel()} outputs differ from the f64 product "
              f"({lo_terms} of {one.numel()} values have a lo term): "
              f"{'ok' if ok else 'FAILED'}")
        results.setdefault("probe_onehot_dot", {})[
            f"exact_rows_differ_{route}_ksplit{ksplit}"] = bad
        if not ok:
            failures.append(f"probe_onehot_dot one value a row ({route}, "
                            f"ksplit {ksplit}): {bad} outputs differ")
        del vals, col, one, got, exact


def _probe_row(results, name, label, k_ms, p_ms, lib_ms, nbytes, nops,
               peak=F32_FLOP_PER_S, **extra):
    b_ms, b_by = bound(nbytes, nops, peak)
    lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
    print(f"[time] {label}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
          f"({p_ms / k_ms:.2f}x), library {lib_txt}, bound {b_ms:.4f} ms "
          f"by {b_by} ({nbytes / 1e6:.1f} MB, {nops / 1e9:.3f} GFLOP; "
          f"{100 * b_ms / k_ms:.1f}% of bound)"
          + "".join(f", {k} {v:.4f}" if isinstance(v, float) else
                    f", {k} {v}" for k, v in extra.items()))
    results.setdefault(name, {}).update(
        ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
        bound_by=b_by, **extra)


def _sectors(keys):
    """Distinct 32-byte sectors (8 f32 words) that flat element offsets
    fall in."""
    return int(torch.unique(keys.reshape(-1) // 8).numel())


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def _wgmma_design(results, name, plan, nbytes, ms, key="tb_per_s"):
    """What the TF32 probe kernels' design acts on: ptxas's registers,
    stack and spill of the plan's instance (and whether ptxas serialised its
    wgmmas, warning C7520), shared memory, resident blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the ring, the bytes in
    flight an SM and the rate reached.  Only the rate goes into the
    results: the rest is the plan's or the compiler's, not measured."""
    from gpumd_tpu_torch.probes import bench_mxu_probes as MX

    px = _ptxas_entry(plan.entry)
    smem, occ = MX.wgmma_occupancy(plan)
    serial = any("C7520" in line and plan.entry in line
                 for line in _ptxas_report().splitlines())
    flight = plan.stages * plan.stage_bytes
    rate = nbytes / ms / 1e9
    passes = (" (three passes: hi, mid, lo)"
              if plan.kernel == "onehot_f32" else "")
    print(f"[design] {name} instance {plan.entry}: {px['regs']} registers, "
          f"{px['stack']} B stack frame, {px['spill_stores']} B spill "
          f"stores, {px['spill_loads']} B spill loads; wgmma "
          f"m{plan.mma[0]}n{plan.mma[1]}k{plan.mma[2]} TF32{passes} "
          f"{'SERIALISED by ptxas' if serial else 'not serialised'}; "
          f"{smem} B shared memory a block, {occ} block(s) an SM "
          f"({plan.warps * occ} warps); ring of {plan.stages} stages x "
          f"{plan.stage_bytes} B = {flight} B in flight an SM at most; "
          f"{plan.units} units over {plan.blocks} persistent blocks; "
          f"{rate:.3f} TB/s reached")
    if (serial or px["stack"] or px["spill_stores"] or occ < 1
            or smem != plan.smem):
        raise RuntimeError(f"{plan.entry}: serialised wgmma, local memory, "
                           f"no resident block or shared memory {smem} B "
                           f"against the plan's {plan.smem} B")
    results.setdefault(name, {})[key] = rate


def _reduce_design(nb, chunks, lanes, rate):
    """What the pair reduce's design acts on: ptxas's registers, stack and
    spill of both orders' kernels; for the tiled order its shared memory a
    block, resident blocks an SM (the occupancy query), lane tile, slab
    row stride and the rate reached.  Fails on local memory in the tiled
    kernel or a launch other than the plan's."""
    from gpumd_tpu_torch.probes import bench_mxu_probes as MX

    px_s = _ptxas_entry("probe_reduce_spill_kernel")
    print(f"[design] probe_pair_reduce spill order "
          f"probe_reduce_spill_kernel: {px_s['regs']} registers, "
          f"{px_s['stack']} B stack frame, {px_s['spill_stores']} B spill "
          f"stores (ptxas)")
    px = _ptxas_entry("probe_reduce_tiled_kernel")
    plan = MX.reduce_plan(nb, chunks, lanes, _sms())
    occ = MX.reduce_occupancy(nb, chunks, lanes)
    print(f"[design] probe_pair_reduce tiled order "
          f"probe_reduce_tiled_kernel: {px['regs']} registers, "
          f"{px['stack']} B stack frame, {px['spill_stores']} B spill "
          f"stores, {px['spill_loads']} B spill loads; lane tile "
          f"{occ['tile']}, {occ['threads']} threads (m, lane); slab "
          f"{occ['smem']} B shared memory a block, 8-row groups "
          f"{plan.group} floats apart (16 floats of padding a group); "
          f"{occ['blocks_per_sm']} blocks an SM; {occ['units']} blocks, "
          f"{plan.waves:.1f} waves; {rate:.3f} TB/s reached")
    want = dict(smem=plan.smem, threads=plan.threads, tile=plan.tile,
                units=plan.units, blocks_per_sm=plan.blocks_per_sm)
    if px["stack"] or px["spill_stores"] or occ != want:
        raise RuntimeError(f"probe_reduce_tiled_kernel: local memory, or "
                           f"launch {occ} against the plan's {want}")


def _probe_time(results, parent=None):
    """Every probe at its script's geometry (bench_mxu_probes at scale 8:
    1,734 blocks): kernel, plain version and library call with CUDA
    events, and the bound.  Bytes count each input once and each output
    once; a gather's table counts the 32-byte sectors its indices touch."""
    from gpumd_tpu_torch.probes import ab_bgather as AB
    from gpumd_tpu_torch.probes import bench_gather as BG
    from gpumd_tpu_torch.probes import bench_mxu_probes as MX
    from gpumd_tpu_torch.probes import probe_transcendentals as PT

    dev = torch.device("cuda")
    table, idx = BG.make_inputs(device=dev)
    g, w, lanes = table.shape
    idx_l = idx.long()
    p, k = _in_turns(lambda: BG.gather_plain(table, idx),
                     lambda: BG.gather_call(table, idx), 5, 5)
    lib = _time_ms(lambda: torch.take_along_dim(table, idx_l, dim=1), 5)
    keys = ((torch.arange(g, device=dev).view(g, 1, 1) * w + idx_l) * lanes
            + torch.arange(lanes, device=dev))
    _probe_row(results, "probe_gather", f"probe_gather (G {g}, W {w}, S "
               f"{idx.shape[1]})", k, p, lib,
               2 * _nbytes(idx) + 32 * _sectors(keys), 0)
    del table, idx, idx_l, keys

    x = torch.linspace(1.0, 120.0, 8192, device=dev).reshape(8, 1024)
    p, k = _in_turns(lambda: PT.run_plain(x), lambda: PT.run(x), 200, 200)
    _probe_row(results, "probe_transcendentals",
               "probe_transcendentals (8, 1024)", k, p, None,
               4 * _nbytes(x), 3 * x.numel())

    nb = MX.NB_FULL // 8
    (vals,) = MX.case_inputs("onehot_current_144x4096x128", nb, dev)
    _, m, kk = vals.shape
    r = MX.onehot_mask(kk, 128, device=dev)
    p, k = _in_turns(lambda: MX.onehot_dot_plain(vals, 128),
                     lambda: MX.onehot_dot(vals, 128), 3, 10)
    k_hi = _time_ms(lambda: MX.onehot_dot(vals, 128, prec="highest"), 5)
    k4 = _time_ms(lambda: MX.onehot_dot(vals, 128, 4), 10)
    lib_hi = _time_ms(lambda: torch.matmul(vals, r), 5)  # full f32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lib = _time_ms(lambda: torch.matmul(vals, r), 10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    nbytes = _nbytes(vals) + 4 * nb * m * 128
    # the f32 path's bound: the same bytes, and its operations as it does
    # them, three TF32 products (hi, mid, lo) at the TF32 peak; beside it
    # the bound of the same product in f32 FFMA, by the f32 peak
    flop = 2 * nb * m * kk * 128
    b_hi, by_hi = bound(nbytes, 3 * flop, TF32_FLOP_PER_S)
    b_ffma, _ = bound(nbytes, flop)
    _probe_row(results, "probe_onehot_dot",
               f"probe_onehot_dot (nb {nb}, {m}x{kk}x128, TF32)", k, p, lib,
               nbytes, flop, TF32_FLOP_PER_S,
               ms_ksplit4=k4, ms_highest=k_hi, library_ms_highest=lib_hi,
               bound_ms_highest=b_hi, bound_by_highest=by_hi,
               bound_ms_highest_ffma=b_ffma)
    print(f"[time] probe_onehot_dot f32 path: {k_hi:.4f} ms, f32 "
          f"torch.matmul {lib_hi:.4f} ms ({lib_hi / k_hi:.2f}x), bound "
          f"{b_hi:.4f} ms by {by_hi} in three TF32 passes "
          f"({100 * b_hi / k_hi:.1f}% of bound; the f32 FFMA formulation's "
          f"bound {b_ffma:.4f} ms)")
    _wgmma_design(results, "probe_onehot_dot",
                  MX.onehot_plan(nb, m, kk, 128, sms=_sms()), nbytes, k)
    _wgmma_design(results, "probe_onehot_dot",
                  MX.onehot_f32_plan(nb, m, kk, 128, sms=_sms()), nbytes,
                  k_hi, key="tb_per_s_highest")
    px = _ptxas_entry("probe_onehot_ffma_kernel")
    print(f"[design] probe_onehot_dot f32 path, k not a multiple of 4 or an "
          f"unaligned base: probe_onehot_ffma_kernel: {px['regs']} "
          f"registers, {px['stack']} B stack frame, {px['spill_stores']} B "
          f"spill stores, {px['smem']} B static shared memory (ptxas)")
    del vals

    (vals,) = MX.case_inputs("feature_matmul_mn32_k8_ch168", nb, dev)
    full = MX.feature_table(168, 8, device=dev).repeat(1, 32 // 8)
    p, k = _in_turns(lambda: MX.feature_matmul_plain(vals, 168),
                     lambda: MX.feature_matmul(vals, 168), 5, 20)
    k24 = _time_ms(lambda: MX.feature_matmul(vals, 24), 20)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lib = _time_ms(lambda: torch.matmul(full, vals), 20)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    nbytes = _nbytes(vals) + 4 * nb * 168 * 128
    _probe_row(results, "probe_feature_matmul",
               f"probe_feature_matmul (nb {nb}, mn 32, k 8, ch 168, TF32)",
               k, p, lib, nbytes, 2 * nb * 168 * vals.shape[1] * 128,
               TF32_FLOP_PER_S, ms_ch24=k24)
    _wgmma_design(results, "probe_feature_matmul",
                  MX.feature_plan(nb, 32, 8, 168, sms=_sms()), nbytes, k)
    del vals

    gv, yv = MX.case_inputs("pair_reduce_spill", nb, dev)
    p, k = _in_turns(lambda: MX.pair_reduce_plain(gv, yv),
                     lambda: MX.pair_reduce(gv, yv, order="spill"), 3, 10)
    k_tiled = _time_ms(lambda: MX.pair_reduce(gv, yv, order="tiled"), 10)
    g5 = gv.view(nb, 4, 7, 8, 128)
    y5 = yv.view(nb, 4, 24, 8, 128)
    lib = _time_ms(lambda: torch.einsum("bcnra,bcmra->bnma", g5, y5), 10)
    nbytes = _nbytes(gv, yv) + 4 * nb * 168 * 128
    rate = nbytes / k_tiled / 1e9
    _probe_row(results, "probe_pair_reduce",
               f"probe_pair_reduce (nb {nb}, 7x24 channels, 4 chunks; ms is "
               f"the spill order)", k, p, lib, nbytes,
               2 * nb * 168 * 4 * 8 * 128, ms_tiled=k_tiled,
               tb_per_s_tiled=rate)
    b_ms = results["probe_pair_reduce"]["bound_ms"]
    print(f"[time] probe_pair_reduce tiled order: {k_tiled:.4f} ms, "
          f"{100 * b_ms / k_tiled:.1f}% of bound, einsum {lib:.4f} ms "
          f"({lib / k_tiled:.2f}x)")
    _reduce_design(nb, 4, 128, rate)
    del gv, yv

    src, bidx = MX.case_inputs("bgather_17ch_nblk18", nb, dev)
    p, k = _in_turns(lambda: MX.bgather_plain(src, bidx),
                     lambda: MX.bgather(src, bidx), 3, 10)
    s11, i11 = MX.case_inputs("bgather_17ch_nblk11", nb, dev)
    k11 = _time_ms(lambda: MX.bgather(s11, i11), 10)
    del s11, i11
    nch, width = src.shape[1:]
    j = bidx.long().reshape(nb, 1, -1)
    gsum_ms = _time_ms(lambda: torch.gather(
        src, 2, j.expand(nb, nch, j.shape[2])).view(nb, nch, -1, 128).sum(2),
        10)
    del j
    # bytes: the indices, the output and, of src, nch x the (b, column)
    # sectors the valid indices touch
    nbytes = AB.sector_bytes(src, bidx)
    terms = nch * int(((bidx >= 0) & (bidx < width)).sum())
    _probe_row(results, "probe_bgather",
               f"probe_bgather (nb {nb}, 17 channels, nblk 18, 14 chunks, "
               f"the script's zero indices)", k, p, None, nbytes, terms,
               ms_nblk11=k11, gather_sum_ms=gsum_ms)
    del src, bidx
    # uniform random indices in [-64, width + 64): nearly every sector
    rsrc, ridx = AB.inputs("random", dev)
    p_r, k_r = _in_turns(lambda: MX.bgather_plain(rsrc, ridx),
                         lambda: MX.bgather(rsrc, ridx), 3, 10)
    nbytes_r = AB.sector_bytes(rsrc, ridx)
    b_r, by_r = bound(nbytes_r,
                      nch * int(((ridx >= 0) & (ridx < width)).sum()))
    print(f"[time] probe_bgather (the same shape, uniform random indices "
          f"in [-64, width + 64)): kernel {k_r:.4f} ms, plain {p_r:.4f} ms "
          f"({p_r / k_r:.2f}x), bound {b_r:.4f} ms by {by_r} "
          f"({nbytes_r / 1e6:.1f} MB; {100 * b_r / k_r:.1f}% of bound)")
    results["probe_bgather"].update(ms_random=k_r, plain_ms_random=p_r,
                                    bound_ms_random=b_r)
    _bgather_design(results, rsrc, ridx, nbytes, k, nbytes_r, k_r)
    del rsrc, ridx
    if parent is not None:
        _bgather_parent(results, parent)


def _bgather_design(results, src, idx, nbytes, ms, nbytes_r, ms_r):
    """What the blocked gather's design acts on: ptxas's registers, stack
    and spill of the plan's instance, lanes a thread, threads, the window's
    chunks, shared memory a block, resident blocks an SM (the occupancy
    query beside the plan's), waves, and the rate at both index patterns.
    Fails on local memory, no staging or no resident block."""
    from gpumd_tpu_torch.probes import bench_mxu_probes as MX

    nb, nch, width = src.shape
    nq, lanes = idx.shape[1:]
    plan = MX.bgather_plan(nb, nch, nq, width, lanes, sms=_sms())
    occ = MX.bgather_occupancy(plan)
    px = _ptxas_entry(f"probe_bgather_kernelILi{plan.lv}ELb"
                      f"{int(plan.stage)}E")
    rate, rate_r = nbytes / ms / 1e9, nbytes_r / ms_r / 1e9
    print(f"[design] probe_bgather probe_bgather_kernel<{plan.lv}, "
          f"{str(plan.stage).lower()}>: {px['regs']} registers, "
          f"{px['stack']} B stack frame, {px['spill_stores']} B spill "
          f"stores, {px['spill_loads']} B spill loads; a block a b, "
          f"{plan.lv} lanes of a channel quad a thread, "
          f"{plan.threads} threads; the indices "
          f"and {plan.chunks} chunks of {plan.chunk} columns (touched "
          f"sectors only) in {plan.smem} B shared memory a block; {occ} "
          f"blocks an SM (plan {plan.blocks_per_sm}); {plan.units} blocks, "
          f"{plan.waves:.1f} waves; {rate:.3f} TB/s at zero indices, "
          f"{rate_r:.3f} at random")
    results["probe_bgather"].update(tb_per_s=rate, tb_per_s_random=rate_r)
    if px["stack"] or px["spill_stores"] or occ < 1 or not plan.stage:
        raise RuntimeError("probe_bgather_kernel: local memory, no staging "
                           "or no resident block")


def _bgather_parent(results, parent):
    """The parent checkout's blocked gather (its csrc/probes.cu, built on
    its own) and this tree's, in turns on the same inputs at both index
    patterns (probes/ab_bgather.py)."""
    from gpumd_tpu_torch.engine import cuda_build
    from gpumd_tpu_torch.probes import ab_bgather as AB

    src = Path(parent) / "gpumd_tpu_torch" / "csrc" / "probes.cu"
    lib, _ = AB.build({"parent": src})["parent"]
    res = AB.compare({"parent": lib, "tree": cuda_build.library()},
                     torch.device("cuda"))
    for pattern, rows in res.items():
        b_ms, pa, tr = rows["bound_ms"], rows["parent"], rows["tree"]
        print(f"[time] probe_bgather {pattern} indices, in turns "
              f"(ab_bgather): parent {pa['ms']:.4f} ms "
              f"({100 * b_ms / pa['ms']:.1f}% of bound), this tree "
              f"{tr['ms']:.4f} ms "
              f"({100 * b_ms / tr['ms']:.1f}%; {pa['ms'] / tr['ms']:.2f}x); "
              f"max |error| {pa['max_abs_err']:.2e} / "
              f"{tr['max_abs_err']:.2e}")
        key = "" if pattern == "zeros" else "_random"
        results["probe_bgather"][f"parent_ms{key}"] = pa["ms"]


def _host_block(results, parent):
    """The [host] block: the host time of a wrapper call, part by part
    (probes/host_cost.py, a process of its own each), for the parent
    checkout's package and this one's on this tree's kernels, in turns
    (parent, tree, tree, parent); this tree's wrappers with the launch
    helpers as they were and as they are, in turns in one process; and
    the launch floor of row 13 from a CUDA graph.  The results keep each
    checkout's smaller reading."""
    import sys

    if parent is None:
        turns = [("tree", str(ROOT))]
    else:
        turns = [("parent", parent), ("tree", str(ROOT))]
        turns += turns[::-1]
    script = ROOT / "gpumd_tpu_torch" / "probes" / "host_cost.py"
    best = {}
    for label, root in turns:
        out = subprocess.run([sys.executable, str(script), "--root", root],
                             capture_output=True, text=True)
        lines = out.stdout.strip().splitlines()
        if out.returncode:
            raise RuntimeError(f"host_cost ({label}) failed:\n"
                               + out.stderr[-4000:])
        for line in lines[:-1]:
            print(line.replace(f"[host] {Path(root).resolve()}",
                               f"[host] {label}"))
        res = json.loads(lines[-1])
        for name, r in res["wrappers"].items():
            key = (label, name)
            if key not in best or r["whole"] < best[key]:
                best[key] = r["whole"]
        r13 = results.setdefault("probe_transcendentals", {})
        suffix = "" if label == "tree" else "_parent"
        r13[f"back_to_back_ms{suffix}"] = min(
            res["row13_ms"], r13.get(f"back_to_back_ms{suffix}", 1e9))
        if label == "tree":
            r13["launch_floor_ms"] = res["launch_floor_ms"]
            ab = res["ab"]["probe/transcendentals"]
            r13["host_us_helpers_before"] = ab["before"]
            r13["host_us_helpers_now"] = ab["now"]
    for (label, name), us in best.items():
        if label == "tree" and ("parent", name) in best:
            print(f"[host] {name}: {us:.2f} us a call (parent "
                  f"{best[('parent', name)]:.2f}), the smaller reading of "
                  f"each checkout")
    r13 = results["probe_transcendentals"]
    r13["host_us"] = best[("tree", "probe/transcendentals")]
    if parent is not None:
        r13["host_us_parent"] = best[("parent", "probe/transcendentals")]


def phase_probes(results, parent=None):
    """Phase 11: the probe kernels against their plain versions, the
    probes' own path (the three entry points at the scripts' geometry,
    counts from 0), the transcendental gate, the timings (with a parent
    checkout, its blocked gather in turns with this one's) and the [host]
    block."""
    from gpumd_tpu_torch.engine import cuda_build
    from gpumd_tpu_torch.probes import bench_gather as BG
    from gpumd_tpu_torch.probes import bench_mxu_probes as MX
    from gpumd_tpu_torch.probes import probe_transcendentals as PT

    failures = []
    with torch.no_grad():
        _probe_checks(results, failures)
        if failures:
            raise RuntimeError(f"probe kernels disagree with plain versions: "
                               f"{failures}")
        cuda_build.reset_launches()
        acc = PT.main([])
        BG.main([])
        MX.main([])
        torch.cuda.synchronize()
        counts = dict(cuda_build.launches)
        print(f"[probes] launches on the probes' path: "
              f"{ {k: counts[k] for k in PROBES} }")
        low = [k for k in PROBES if counts[k] < 1]
        if low:
            raise RuntimeError(f"probe kernels not launched: {low}")
        for k in PROBES:
            results.setdefault(k, {})["launches"] = counts[k]
        worst = max(v["kernel_max_rel"] for v in acc.values())
        print(f"[probes] transcendentals: worst kernel max relative error "
              f"{worst:.3e} (gate {TRANS_GATE:.0e})")
        if not worst <= TRANS_GATE:
            raise RuntimeError("in-kernel transcendentals above the gate")
        _probe_time(results, parent)
    _host_block(results, parent)


# ---- the gpumd app: run.in + model.xyz through app/gpumd.py's Session -----

# A deck's thermo rows against the same start driven directly.  Both build
# the same start and run the same step: at step 20 they agree to
# thermo.out's printed digits; then the order of the shared-memory float
# atomics (scatter.cu, tersoff.cu's fused mode), which varies from run to
# run, parts them, and two app runs or two direct runs part as far
# (app-spread).  T, KE, PE and the box within the bound of their column's
# largest magnitude, the stress within the bound of the largest stress
# component.  NEP: 1e-6, ~10x the largest reading (1.05e-7, stress);
# Tersoff under NHC: 5e-6, ~4x the largest (1.29e-6, stress; the chain
# feeds the kinetic energy back every half step).
APP_ROW_TOL = 1e-6
APP_ROW_TOL_TERSOFF = 5e-6
# The restart's positions against the direct run's after 200 steps: the
# same run-to-run parting, in float32 ulps of the box edge (7.6e-6 A at
# 105.6 A).  NEP pairs (app-app, direct-direct, app-direct) part by 1-2
# ulps, Tersoff pairs by 1-4 (app-spread), so 4 ulps, 3.1e-5 A at PbTe
# 32,768: 1e-5 A would sit between 1 and 2 ulps.
APP_POS_ULPS = 4
# Langevin and BAOAB hold 300 K: the mean T of the last 500 steps within
# 5% (32,768 atoms fluctuate by ~0.5%).
APP_T_TOL = 0.05
# LJ with a constant force on a group: the total momentum equals the
# impulse n_g f (t - dt/2) (internal forces cancel; the first half kick
# has no driver force) to 1e-3 of it.
APP_P_TOL = 1e-3
NEP_BASE = ("k1", "k2", "scatter", "fold")


def _write_model(d, symbols, pos, mass, lengths, temperature, seed,
                 groups=None):
    """model.xyz with velocities at `temperature` (numpy, no net
    momentum), through the port's extended-XYZ writer."""
    from gpumd_tpu_torch.io.xyz import XYZFrame, write_xyz
    from gpumd_tpu_torch.units import K_B, TIME_UNIT_CONVERSION

    rng = np.random.default_rng(seed)
    v = rng.normal(size=pos.shape) * np.sqrt(K_B * temperature / mass)[:, None]
    v -= (mass[:, None] * v).sum(0) / mass.sum()
    d.mkdir(parents=True, exist_ok=True)
    write_xyz(str(d / "model.xyz"), XYZFrame(
        symbols=list(symbols), positions=pos, lattice=np.diag(lengths),
        pbc=(True, True, True), velocities=v / TIME_UNIT_CONVERSION,
        groups=groups), with_velocities=True, with_groups=groups is not None)


def _pbte_deck(d, nc, deck, jitter=0.0, seed=3, halves=False):
    """PbTe nc^3 cells (a0 6.57 A) at 300 K with the trained model;
    `halves`: a grouping method, group 1 the atoms with x < L/2."""
    import shutil

    from gpumd_tpu_torch.bench import build_pbte

    pos, types, lengths = build_pbte(nc, nc, nc)
    if jitter:
        pos = pos + np.random.default_rng(seed).normal(0, jitter, pos.shape)
    symbols = np.where(types == 1, "Pb", "Te")
    groups = ((pos[:, :1] < lengths[0] / 2).astype(int) if halves
              else None)
    _write_model(d, symbols, pos, np.where(types == 1, 207.2, 127.6),
                 lengths, 300.0, seed, groups=groups)
    shutil.copy(MODEL, d / "nep.txt")
    (d / "run.in").write_text(deck)


def _session(d, count=True):
    """Session(d, device="cuda").execute() from launch counts of 0: the
    session and the counts read just after."""
    from gpumd_tpu_torch.app.gpumd import Session
    from gpumd_tpu_torch.engine import cuda_build

    s = Session(str(d), quiet=True, device="cuda")
    if count:
        cuda_build.reset_launches()
    s.execute()
    torch.cuda.synchronize()
    return s, dict(cuda_build.launches)


def _direct_start(d, names):
    """The deck's start built directly: model.xyz, the box and the state
    (types by the potential's species `names`) as a user of the library
    would, f32 on the card."""
    from gpumd_tpu_torch.io.xyz import read_xyz
    from gpumd_tpu_torch.model.box import Box
    from gpumd_tpu_torch.model.state import make_state
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    fr = read_xyz(str(d / "model.xyz"))
    box = Box.from_lattice(fr.lattice, dtype=torch.float32)
    types = np.array([names.index(s) for s in fr.symbols])
    state = make_state(fr.positions, fr.default_masses(), types, box,
                       velocity=fr.velocities * TIME_UNIT_CONVERSION)
    return state._replace(unwrapped_position=state.position.clone()), fr


def _pos64(state):
    """The positions as the app hands them to an engine's planner: a
    float64 numpy array (a float32 one can bin a boundary atom into
    another cell and give another plan)."""
    return state.position.cpu().numpy().astype(np.float64)


def _plan(md):
    cp = md.cplan
    return (f"grid {cp.base.grid} cap {cp.base.cap} bx {cp.bx} mn_r "
            f"{cp.mn_r} cl {cp.cl}")


def _direct_rows(md, state, ens, n_steps, chunk, observer=None):
    """n_steps driven directly on md from state, chunk by chunk: thermo
    rows at each chunk's end (app.gpumd.thermo_row), the final
    input-order state and the observer's rows."""
    from gpumd_tpu_torch.app.gpumd import thermo_row
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    n = state.position.shape[0]
    dt = 1.0 / TIME_UNIT_CONVERSION
    rows, ys = [], []
    with torch.no_grad():
        carry = md.init_carry(state)
        carry = carry._replace(state=md.compute(carry.state, carry.idx))
        aux = ens.init(carry.state)
        step = md.make_step(ens, dt, observer=observer)
        for _ in range(n_steps // chunk):
            for _ in range(chunk):
                if observer is not None:
                    carry, aux, _, y = step(carry, aux)
                    ys.append(y)
                else:
                    carry, aux = step(carry, aux)
            snap = md.to_input_order(carry, n)
            rows.append(thermo_row(snap))
    return (np.array(rows), snap,
            torch.stack(ys).cpu().numpy() if ys else None)


def _row_diff(got, want):
    """Largest row difference over its scale, for T/KE/PE, the stress and
    the box (see APP_ROW_TOL)."""
    scale = np.maximum(np.abs(want).max(0), 1e-30)
    scale[3:9] = np.abs(want[:, 3:9]).max()
    rel = np.abs(got - want).max(0) / scale
    return rel[:3].max(), rel[3:9].max(), rel[9:].max()


def _rows_match(what, got, want, tol):
    """thermo.out rows against the direct run's."""
    if got.shape != want.shape:
        raise RuntimeError(f"{what}: rows {got.shape} vs {want.shape}")
    rel = _row_diff(got, want)
    print(f"[app] {what}: thermo rows vs the direct run, max diff / scale "
          f"(T KE PE, stress, box): {rel[0]:.3e}, {rel[1]:.3e}, "
          f"{rel[2]:.3e} (bound {tol})")
    if not max(rel) <= tol:
        raise RuntimeError(f"{what}: the deck departs from the direct run")


def _launch_check(what, counts, need, never=()):
    low = {k: counts[k] for k, c in need.items() if counts[k] < c}
    off = {k: counts[k] for k in never if counts[k]}
    print(f"[app] {what}: launches "
          f"{ {k: v for k, v in counts.items() if v} or 'none'}")
    if low or off:
        raise RuntimeError(f"{what}: launches below {need}: {low}; "
                           f"off the path: {off}")


def _thermo(d, n_rows):
    rows = np.atleast_2d(np.loadtxt(d / "thermo.out", comments="#"))
    if rows.shape != (n_rows, 18) or not np.isfinite(rows).all():
        raise RuntimeError(f"{d.name}: thermo.out {rows.shape}, expected "
                           f"{n_rows} finite rows of 18")
    return rows


def _restart_check(what, d, snap):
    """restart.xyz against the direct run's final positions."""
    from gpumd_tpu_torch.io.xyz import read_xyz

    box = snap.box
    pos = torch.as_tensor(read_xyz(str(d / "restart.xyz")).positions,
                          dtype=torch.float32, device="cuda")
    # restart.xyz holds wrapped positions: wrap the direct run's the same
    # way (the f32 wrap alone moves a coordinate by an ulp)
    dx = float(box.minimum_image(pos - box.wrap(snap.position)).abs().max())
    edge = float(box.h.abs().max())
    bound = APP_POS_ULPS * float(np.spacing(np.float32(edge)))
    print(f"[app] {what}: restart.xyz vs the direct run: max |dx| = "
          f"{dx:.3e} A (bound {bound:.3e} A, {APP_POS_ULPS} float32 ulps "
          f"at {edge:.3f} A)")
    if not dx <= bound:
        raise RuntimeError(f"{what}: restart positions depart")


CONFIG3_DECK = ("potential nep.txt\ntime_step 1\n"
                "ensemble npt_ber 300 300 100 0 40 1000\ndump_thermo 20\n"
                "dump_restart 200\nrun 200\n")


def _config3_direct(d, n):
    """(a)'s start driven directly, DenseNEPMD + NPTBerendsen in chunks of
    20: the rows, the final input-order state and the engine."""
    from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
    from gpumd_tpu_torch.integrate.ensembles.npt import NPTBerendsen
    from gpumd_tpu_torch.potentials.nep.model import NEP

    nep = NEP.from_file(str(d / "nep.txt"), dtype=torch.float32)
    state, _ = _direct_start(d, nep.model.symbols)
    md = DenseNEPMD(nep, state.box, n, position=_pos64(state))
    ens = NPTBerendsen(t0=300.0, t1=300.0, coupling=100.0, n_steps=200,
                       target_pressure=(0.0,) * 3,
                       elastic_modulus=(40.0,) * 3, tau_p=1000.0,
                       isotropic=True)
    rows, snap, _ = _direct_rows(md, state, ens, 200, 20)
    return rows, snap, md


def _tersoff_deck(d, pot_path):
    """(d)'s deck: Si 32,768 (diamond, 16^3 cells) at 300 K, nvt_nhc."""
    import shutil

    from gpumd_tpu_torch.bench import build_diamond

    pos, lengths = build_diamond(16)
    _write_model(d, ["Si"] * len(pos), pos, np.full(len(pos), 28.085),
                 lengths, 300.0, 3)
    shutil.copy(pot_path, d / "si.txt")
    (d / "run.in").write_text("potential si.txt\ntime_step 1\n"
                              "ensemble nvt_nhc 300 300 100\n"
                              "dump_thermo 20\nrun 200\n")


def _tersoff_direct(d, n):
    """(d)'s start driven directly, CompactTersoffMD + NVTNoseHooverChain
    in chunks of 20: as _config3_direct."""
    from gpumd_tpu_torch.engine.tersoff_compact import CompactTersoffMD
    from gpumd_tpu_torch.integrate.ensembles.nvt import NVTNoseHooverChain
    from gpumd_tpu_torch.potentials.tersoff import Tersoff1989

    pot = Tersoff1989.from_file(str(d / "si.txt"), dtype=torch.float32)
    state, _ = _direct_start(d, ["Si"])
    md = CompactTersoffMD(pot, state.box, n, position=_pos64(state))
    ens = NVTNoseHooverChain(t0=300.0, t1=300.0, coupling=100.0,
                             n_steps=200)
    rows, snap, _ = _direct_rows(md, state, ens, 200, 20)
    return rows, snap, md


def _app_config3(tmp, results):
    """(a) BASELINE config 3 as a deck: PbTe 32,768, npt_ber, 200 steps."""
    d = tmp / "config3"
    _pbte_deck(d, 16, CONFIG3_DECK)
    t0 = time.time()
    s, counts = _session(d)
    n = s._n
    print(f"[app] (a) config 3 deck: PbTe {n}, npt_ber, 200 steps in "
          f"{time.time() - t0:.1f} s (run {s.run_seconds[0]:.2f} s); "
          f"route: {s.route_reason or 'compact engine'}; "
          f"{type(s.md).__name__} per_atom_virial={s.md.per_atom_virial}")
    if s.route_reason is not None:
        raise RuntimeError("config 3 deck: not on the compact engine")
    _launch_check("(a) config 3 deck", counts,
                  {**{k: 200 for k in NEP_BASE}, "compact_rows": 400})
    for k in NEP_BASE + ("compact_rows",):
        results.setdefault(k, {})["launches_app"] = counts[k]
    rows = _thermo(d, 10)
    change = abs(rows[-1, 9] - rows[0, 9]) / rows[0, 9]
    print(f"[app] (a) box a_x {rows[0, 9]:.6f} -> {rows[-1, 9]:.6f} A "
          f"(relative {change:.3e}); T at the last row "
          f"{rows[-1, 0]:.2f} K")
    if not change > 1e-6:
        raise RuntimeError("config 3 deck: the box did not change")
    want, snap, _ = _config3_direct(d, n)
    _rows_match("(a) config 3 deck", rows, want, APP_ROW_TOL)
    _restart_check("(a) config 3 deck", d, snap)


def _app_hnemd(tmp, results):
    """(b) config 4's path as a deck: NVE, compute_hnemd, compute_shc."""
    import types as pytypes

    from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
    from gpumd_tpu_torch.integrate.ensembles.nve import NVE
    from gpumd_tpu_torch.measure.properties import HNEMDKappa, heat_current_5
    from gpumd_tpu_torch.potentials.nep.model import NEP
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    d = tmp / "hnemd"
    _pbte_deck(d, 16, "potential nep.txt\ntime_step 1\nensemble nve\n"
               "compute_hnemd 10 1e-4 0 0\ncompute_shc 2 10 0 20 40\n"
               "run 100\n")
    s, counts = _session(d)
    n = s._n
    print(f"[app] (b) HNEMD deck: route {s.route_reason or 'compact engine'}"
          f"; per_atom_virial={s.md.per_atom_virial} (12 channels)")
    if s.route_reason is not None or not s.md.per_atom_virial:
        raise RuntimeError("HNEMD deck: not on the compact engine at 12 "
                           "channels")
    _launch_check("(b) HNEMD deck", counts,
                  {**{k: 100 for k in NEP_BASE}, "compact_rows": 200})
    for k in NEP_BASE + ("compact_rows",):
        results.setdefault(k, {})["launches_app_hnemd"] = counts[k]
    kappa = np.atleast_2d(np.loadtxt(d / "kappa.out"))
    shc = np.loadtxt(d / "shc.out", comments="#")
    print(f"[app] (b) kappa.out {kappa.shape}, shc.out {shc.shape}; the last "
          f"kappa row {kappa[-1].tolist()}")
    if kappa.shape != (10, 5) or shc.shape != (2 * 10 - 1 + 20, 3) or not (
            np.isfinite(kappa).all() and np.isfinite(shc).all()):
        raise RuntimeError("HNEMD deck: kappa.out or shc.out malformed")
    nep = NEP.from_file(str(d / "nep.txt"), dtype=torch.float32)
    state, _ = _direct_start(d, nep.model.symbols)
    md = DenseNEPMD(nep, state.box, n, position=_pos64(state),
                    per_atom_virial=True)
    md.hnemd_fe = (1e-4, 0.0, 0.0)
    _, snap, ys = _direct_rows(md, state, NVE(), 100, 100,
                               observer=heat_current_5)
    ref = HNEMDKappa(10, (1e-4, 0.0, 0.0), 1.0 / TIME_UNIT_CONVERSION, 300.0)
    (d / "direct").mkdir()
    sess = pytypes.SimpleNamespace(workdir=str(d / "direct"), state=snap)
    for k in range(0, 100, 10):  # the app's chunks of 10 steps
        ref.consume_heat(ys[k:k + 10], k)
        ref.maybe_output(sess)
    want = np.loadtxt(d / "direct" / "kappa.out")
    rel = float(np.abs(kappa - want).max() / np.abs(want).max())
    print(f"[app] (b) kappa.out (J summed over 10 steps) vs the direct run: "
          f"max diff / max = {rel:.3e} (bound {J_TOL})")
    if not rel <= J_TOL:
        raise RuntimeError("HNEMD deck: J departs from the direct run")


def _app_langevin(tmp, results):
    """(c) nvt_lan and nvt_bao on PbTe 32,768, 1,000 steps at 300 K."""
    from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
    from gpumd_tpu_torch.integrate.ensembles.nvt import NVTBAOAB, NVTLangevin
    from gpumd_tpu_torch.potentials.nep.model import NEP
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    dt = 1.0 / TIME_UNIT_CONVERSION
    # each run block plans its engine on the positions it starts from: the
    # lattice (compact_rows) for the first, thermalized positions (a
    # windows plan, compact_windows) for the second
    for name, cls in (("nvt_lan", NVTLangevin), ("nvt_bao", NVTBAOAB)):
        d = tmp / name
        _pbte_deck(d, 16, f"potential nep.txt\ntime_step 1\n"
                   f"ensemble {name} 300 300 100\ndump_restart 20\n"
                   f"run 20\ndump_thermo 10\nrun 980\n")
        t0 = time.time()
        s, counts = _session(d)
        n = s._n
        rows = _thermo(d, 98)
        t_mean = float(rows[-50:, 0].mean())
        print(f"[app] (c) {name}: PbTe {n}, 1,000 steps in "
              f"{time.time() - t0:.1f} s; route "
              f"{s.route_reason or 'compact engine'}; mean T of the last "
              f"500 steps {t_mean:.2f} K (bound 300 +- {APP_T_TOL:.0%})")
        if s.route_reason is not None:
            raise RuntimeError(f"{name} deck: not on the compact engine")
        _launch_check(f"(c) {name}", counts,
                      {**{k: 1000 for k in NEP_BASE}, "compact_rows": 40,
                       "compact_windows": 1960})
        results.setdefault("compact_windows", {}).setdefault(
            "launches_app", counts["compact_windows"])
        if not abs(t_mean - 300.0) <= APP_T_TOL * 300.0:
            raise RuntimeError(f"{name}: the thermostat misses 300 K")
        # 20 steps of the all-plain run with the same generator seed
        nep = NEP.from_file(str(d / "nep.txt"), dtype=torch.float32)
        state, _ = _direct_start(d, nep.model.symbols)
        md = DenseNEPMD(nep, state.box, n,
                        position=_pos64(state), plain=True)
        from gpumd_tpu_torch.engine import cuda_build

        cuda_build.reset_launches()
        with torch.no_grad():
            carry, _ = md.run(state, cls(t0=300.0, t1=300.0, coupling=100.0,
                                         n_steps=20), dt, 20)
        if any(cuda_build.launches.values()):
            raise RuntimeError("the plain reference run launched kernels")
        from gpumd_tpu_torch.io.xyz import read_xyz

        pos = torch.as_tensor(read_xyz(str(d / "restart.xyz")).positions,
                              dtype=torch.float32, device="cuda")
        _pos_check(f"(c) {name} deck vs the all-plain run (seed 12345)",
                   state.box, pos, md.to_input_order(carry, n).position)


def _app_tersoff(tmp, results, pot_path):
    """(d) Tersoff Si 32,768 under nvt_nhc, 200 steps."""
    d = tmp / "tersoff"
    _tersoff_deck(d, pot_path)
    s, counts = _session(d)
    n = s._n
    print(f"[app] (d) Tersoff deck: Si {n}, nvt_nhc, route "
          f"{s.route_reason or 'compact engine'} "
          f"({type(s.md).__name__})")
    if s.route_reason is not None:
        raise RuntimeError("Tersoff deck: not on the compact engine")
    _launch_check("(d) Tersoff deck", counts,
                  {"tersoff_scatter": 200, "fold": 200},
                  never=("tersoff", "scatter", "k1", "k2"))
    for k in ("tersoff_scatter", "fold"):
        results.setdefault(k, {})["launches_app_tersoff"] = counts[k]
    rows = _thermo(d, 10)
    want, _, _ = _tersoff_direct(d, n)
    _rows_match("(d) Tersoff deck", rows, want, APP_ROW_TOL_TERSOFF)


def _app_lj(tmp):
    """(e) LJ argon 4,000 (config 1) under NVE with add_force on a group."""
    import shutil

    from gpumd_tpu_torch.app.gpumd import _auto_mn
    from gpumd_tpu_torch.forcefield import ForceField
    from gpumd_tpu_torch.potentials.lj import LJ
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    nc, a0, mass = 10, 5.26, 39.948
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    n, f, steps, dt_fs = len(pos), 1e-3, 200, 2.0
    grp = (pos[:, :1] < nc * a0 / 2).astype(int)  # group 1: x < L/2
    d = tmp / "lj"
    _write_model(d, ["Ar"] * n, pos, np.full(n, mass), [nc * a0] * 3, 80.0,
                 42, groups=grp)
    shutil.copy(LJ_FILE, d / "lj.txt")
    (d / "run.in").write_text(f"potential lj.txt\ntime_step {dt_fs}\n"
                              f"ensemble nve\nadd_force 0 1 {f} 0 0\n"
                              f"dump_thermo 20\nrun {steps}\n")
    s, counts = _session(d)
    print(f"[app] (e) LJ argon {n}: MN {s.ff.neighbor.mn} (_auto_mn "
          f"{_auto_mn(s.potentials, n, s.box)}), {s.ff.neighbor.method}; "
          f"engine auto: list path ({s.route_reason})")
    if s.route_reason is None or s.md is not None:
        raise RuntimeError("LJ deck: not on the list path")
    _launch_check("(e) LJ deck", counts, {}, never=tuple(counts))
    _thermo(d, steps // 20)
    lj = LJ.from_file(str(d / "lj.txt"), dtype=torch.float32)
    state0, _ = _direct_start(d, ["Ar"])
    ff = ForceField.create([lj], state0.box, n, mn=s.ff.neighbor.mn,
                           skin=1.0)
    with torch.no_grad():
        e0 = total_energy(ff.compute(state0))
    st = s.state
    sel = torch.as_tensor(grp[:, 0] == 1, device="cuda")
    work = f * float((st.unwrapped_position[:n, 0]
                      - state0.position[:, 0])[sel].sum()) / n
    e1 = total_energy(st)
    bound = LJ_GATE * dt_fs ** 2
    print(f"[app] (e) total energy per atom {e0:.8f} -> {e1:.8f} eV, work "
          f"of add_force {work:.8f} eV/atom; change less work "
          f"{e1 - e0 - work:+.3e} (bound {bound:.3e})")
    if not abs(e1 - e0 - work) <= bound:
        raise RuntimeError("LJ deck: energy less work not conserved")
    p = torch.sum(st.mass[:n, None] * st.velocity[:n], dim=0).tolist()
    # the run's first half kick uses the force of the start, which has no
    # driver in it (the drivers act after each step's force pass)
    impulse = (int(grp.sum()) * f * (steps - 0.5) * dt_fs
               / TIME_UNIT_CONVERSION)
    rel = max(abs(p[0] - impulse), abs(p[1]), abs(p[2])) / impulse
    print(f"[app] (e) total momentum {p} against the group's impulse "
          f"({impulse:.6f}, 0, 0): max diff / impulse {rel:.3e} (bound "
          f"{APP_P_TOL})")
    if not rel <= APP_P_TOL:
        raise RuntimeError("LJ deck: momentum does not grow as F t")


def _app_time(tmp):
    """(f) PbTe 262,144 NVE, dump_thermo 100, run 500: the app's run block
    and the same run driven directly, in turns (direct, app, direct)."""
    from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
    from gpumd_tpu_torch.integrate.ensembles.nve import NVE
    from gpumd_tpu_torch.potentials.nep.model import NEP
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    d = tmp / "time"
    steps = 500
    _pbte_deck(d, 32, "potential nep.txt\ntime_step 1\nensemble nve\n"
               f"dump_thermo 100\nrun {steps}\n")
    nep = NEP.from_file(str(d / "nep.txt"), dtype=torch.float32)
    state, _ = _direct_start(d, nep.model.symbols)
    n = state.position.shape[0]
    # timed as the app times a run block: from the first rebin (the engine
    # built before the clock starts) to the run's last read
    md = DenseNEPMD(nep, state.box, n, position=_pos64(state))

    def direct():
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.no_grad():
            carry, _ = md.run(state, NVE(), 1.0 / TIME_UNIT_CONVERSION,
                              steps)
        bool(carry.overflow)
        torch.cuda.synchronize()
        return time.time() - t0

    first = direct()
    s, _ = _session(d, count=False)
    walls = {"direct": [first, direct()], "app": s.run_seconds}
    a, b = min(walls["app"]), min(walls["direct"])
    print(f"[app] (f) plans: app {_plan(s.md)}; direct {_plan(md)}")
    print(f"[app] (f) PbTe {n} NVE, {steps} steps a block, dump_thermo 100, "
          f"in turns (direct, app, direct): app "
          f"{[f'{w:.4f}' for w in walls['app']]} s, direct "
          f"{[f'{w:.4f}' for w in walls['direct']]} s; best "
          f"{n * steps / a:.6e} vs {n * steps / b:.6e} atom-step/s; the app "
          f"loop's overhead {100.0 * (a - b) / b:+.2f}% "
          f"({1e3 * (a - b) / (steps // 100):+.2f} ms a chunk of 100 steps)")


def phase_app(results, pot_path):
    """The gpumd app: run.in + model.xyz decks through Session on the card,
    engine auto (phases (a)-(f) of the module docstring)."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for label, fn in (("a", lambda: _app_config3(tmp, results)),
                          ("b", lambda: _app_hnemd(tmp, results)),
                          ("c", lambda: _app_langevin(tmp, results)),
                          ("d", lambda: _app_tersoff(tmp, results, pot_path)),
                          ("e", lambda: _app_lj(tmp)),
                          ("f", lambda: _app_time(tmp))):
            t1 = time.time()
            fn()
            print(f"[app] ({label}) done in {time.time() - t1:.1f} s")
    print(f"[app] phase done in {time.time() - t0:.1f} s")


# ---- the measure keywords: decks whose measures sample the app's snapshots --

# Card against the CPU's float64 recomputation from the same recorded
# snapshots.  Files whose per-sample work is float64 on both sides (msd,
# sdc, dos, mvac, ic, compute: the frames are the card's float32 values,
# correlated in float64; compute's sums run in float64 on the card) within
# 1e-6 of each column's largest magnitude: the printed digits.  Files
# whose per-sample work is float32 on the card: compute_chunk 1e-4 (an atom
# within float32 rounding of a bin edge may bin apart: one atom of ~2,048
# for one of 100 samples, 5e-6), heatmode 1e-5 (one float32 product a mode
# and value), viscosity.out and onsager.out 1e-3 (sums over 32,768 atoms
# cancelling to ~1% of their terms, then to fluctuations: 1e-6 of the
# terms becomes ~1e-4 of the result).
MEASURE_FILE_TOL = {"msd.out": 1e-6, "sdc.out": 1e-6, "dos.out": 1e-6,
                    "mvac.out": 1e-6, "ic.out": 1e-6, "compute.out": 1e-6,
                    "compute_chunk.out": 1e-4, "heatmode.out": 1e-5,
                    "viscosity.out": 1e-3, "onsager.out": 1e-3}
# The neighbour measures' last sample, card against the CPU: histogram
# counts differ only by pairs within float32 rounding of a bin edge (a
# boundary-crossing displacement carries one ulp of the box edge, 7.6e-6 A
# at 105 A, against bins of 0.05 A and 2 degrees): the summed |difference|
# within 1e-3 of the counts; q_l within 1e-4 (the bond directions to
# float32, no neighbour within rounding of rc = 4.0 A in PbTe).
MEASURE_HIST_TOL = 1e-3
MEASURE_Q_TOL = 1e-4
# stress_6 and onsager_flux of a recorded snapshot, card against CPU f64,
# against the sum of the magnitudes of their terms (what float32 rounds)
MEASURE_FLUX_TOL = 1e-5
# the completeness of the identity modes: sum over modes of heatmode.out
# against heat_current_5, over the largest |component| of the sample's J
MODAL_SUM_TOL = 1e-4
MEASURE_A = (
    "potential nep.txt\ntime_step 1\nensemble nvt_ber 300 300 100\n"
    "compute_msd 10 50\ncompute_sdc 5 100\ncompute_dos 5 100 40\n"
    "compute_ic 10 50 1 2.0\ncompute_rdf 8.0 160 100\n"
    "compute_adf 100 90 2.5 4.0\ncompute_angular_rdf 6.0 60 36 100\n"
    "compute_orientorder 100 cutoff 4.0 2 4 6\n"
    "compute 0 10 100 temperature potential force jk momentum\n"
    "compute_chunk 10 100 bin/1d x lower 6.57 temperature density/number "
    "vx\nrun {steps}\n")
# the decks' sizes: (a) PbTe 16^3 cells, 1,000 steps; (b) 6^3 cells, 200
# steps, its hnema deck 100; (c) 16^3 cells, 100 steps each
MEASURE_CELLS, MEASURE_STEPS = 16, 1000
MODAL_CELLS, MODAL_STEPS, HNEMA_STEPS = 6, 200, 100
LIST_STEPS = 100
NEIGHBOR_KEYWORDS = ("compute_rdf", "compute_adf", "compute_angular_rdf",
                     "compute_orientorder")
SNAP_FIELDS = ("position", "velocity", "force", "mass", "type",
               "potential_energy", "virial", "mask", "unwrapped_position")


class _Recorder:
    """A PropertyRequest's process that copies every snapshot the
    measures see to the host, with the neighbour measures' histograms as
    they stood before the step's sample, and times itself."""

    def __init__(self):
        self.snaps, self.hists, self.seconds = [], {}, 0.0
        self.measures = []

    def __call__(self, session, state, step):
        t0 = time.time()
        self.snaps.append((step, {f: getattr(state, f).cpu()
                                  for f in SNAP_FIELDS
                                  if getattr(state, f) is not None},
                           state.box.h.cpu()))
        self.measures = session.measure_props  # the run's instances
        self.hists[step] = [_counts(m) for m in self.measures
                            if hasattr(m, "hist")]
        self.seconds += time.time() - t0


def _recorded_session(d, interval):
    """Session(d, device="cuda") with a recorder of every `interval`-th
    snapshot, from launch counts of 0: the session, the counts, the
    recorder."""
    from gpumd_tpu_torch.app.gpumd import PropertyRequest, Session
    from gpumd_tpu_torch.engine import cuda_build

    rec = _Recorder()
    s = Session(str(d), quiet=True, device="cuda")
    s.properties.append(PropertyRequest(interval, rec))
    cuda_build.reset_launches()
    s.execute()
    torch.cuda.synchronize()
    return s, dict(cuda_build.launches), rec


def _state64(snap, h, dtype=torch.float64, device="cpu"):
    """A recorded snapshot as an MDState, float64 on the CPU unless asked
    otherwise."""
    from gpumd_tpu_torch.model.box import Box
    from gpumd_tpu_torch.model.state import MDState

    f = {k: (v.to(dtype) if v.is_floating_point() else v).to(device)
         for k, v in snap.items()}
    return MDState(box=Box.from_lattice(h.double().T.numpy(), dtype=dtype,
                                        device=device),
                   heat_current=torch.zeros_like(f["velocity"]), **f)


def _cpu_session(d):
    """A CPU session in d/cpu on d's model.xyz, nep.txt (and
    eigenvector.in), with every keyword of d's run.in but `run`."""
    import os

    from gpumd_tpu_torch.app.gpumd import Session, parse_run_in

    c = d / "cpu"
    c.mkdir()
    for name in ("model.xyz", "nep.txt", "eigenvector.in"):
        if (d / name).exists():
            os.symlink(d / name, c / name)
    s = Session(str(c), quiet=True, device="cpu")
    for toks in parse_run_in(str(d / "run.in")):
        if toks[0] != "run":
            s.KEYWORDS[toks[0]](s, toks[1:])
    return s


def _replay(d, rec, last_only=()):
    """The deck's measures and properties, fresh on a CPU session, fed the
    recorded snapshots in float64 as the app feeds them (a list deck's
    per-step observers from snapshots recorded every step); measures of
    the classes `last_only` take only their last sample.  Writes d/cpu's
    files; returns the session."""
    from gpumd_tpu_torch.measure.properties import onsager_flux, stress_6

    s = _cpu_session(d)
    measures = list(s.measure_props)
    last = {id(m): max(step for step, _, _ in rec.snaps
                       if step % m.interval == 0)
            for m in measures if isinstance(m, last_only)}
    with torch.no_grad():
        for step, snap, h in rec.snaps:
            st = _state64(snap, h)
            s.state = st
            for p in s.properties:
                if step % p.interval == 0:
                    p.process(s, st, step)
            for m in measures:
                if getattr(m, "needs_stress", False):
                    m.consume_stress(stress_6(st)[None], step - 1)
                if getattr(m, "needs_onsager", False):
                    m.consume_onsager(onsager_flux(
                        st, m.mass_type, m.num_types)[None], step - 1)
                    m.maybe_output(s)
                if not hasattr(m, "sample_state") or step % m.interval:
                    continue
                if id(m) not in last or last[id(m)] == step:
                    m.sample_state(s, st, step)
    s._finish_run()
    for f in s._files.values():
        f.close()
    s.measure_props = measures
    return s


def _split_rows(path):
    """(header lines, numeric rows) of an output file."""
    heads, rows = [], []
    for line in Path(path).read_text().splitlines():
        try:
            rows.append([float(x) for x in line.split()])
        except ValueError:
            heads.append(line)
    return heads, np.array(rows)


def _files_match(what, d, names):
    """d's files against d/cpu's: the same headers and shapes, every
    column within its MEASURE_FILE_TOL of its largest magnitude."""
    for name in names:
        (ha, a), (hb, b) = _split_rows(d / name), _split_rows(d / "cpu" / name)
        if ha != hb or a.shape != b.shape or not a.size:
            raise RuntimeError(f"{what}: {name} {a.shape} vs the CPU's "
                               f"{b.shape}, or its header differs")
        scale = np.maximum(np.abs(b).max(axis=0), 1e-300)
        rel = float((np.abs(a - b).max(axis=0) / scale).max())
        tol = MEASURE_FILE_TOL[name]
        print(f"[measure] {what}: {name} {a.shape} against the CPU in f64: "
              f"max diff / column max {rel:.3e} (bound {tol:.0e})")
        if not (rel <= tol and np.isfinite(a).all()):
            raise RuntimeError(f"{what}: {name} departs from the CPU's")


def _counts(m):
    """A histogram measure's counts, its pair histograms too, as one flat
    vector."""
    return np.concatenate([m.hist.ravel(),
                           getattr(m, "hist_pair", np.zeros(0)).ravel()])


def _neighbor_match(what, rec, cpu):
    """The neighbour measures' last sample on the card (the increment of
    its histograms; OrientOrder's last block) against fresh CPU f64
    instances fed the same snapshot."""
    from gpumd_tpu_torch.measure.properties import OrientOrder

    card = [m for m in rec.measures if hasattr(m, "hist")]
    host = [m for m in cpu.measure_props if hasattr(m, "hist")]
    for k, (mc, mh) in enumerate(zip(card, host)):
        step = max(st for st in rec.hists if st % mc.interval == 0)
        got = _counts(mc) - rec.hists[step][k]
        want = _counts(mh)
        rel = float(np.abs(got - want).sum() / max(want.sum(), 1.0))
        print(f"[measure] {what}: {type(mc).__name__} at step {step}: "
              f"{int(want.sum())} counts, summed |card - CPU| / counts "
              f"{rel:.3e} (bound {MEASURE_HIST_TOL:.0e})")
        if not rel <= MEASURE_HIST_TOL:
            raise RuntimeError(f"{what}: {type(mc).__name__} departs")
    for mc, mh in zip(
            [m for m in rec.measures if isinstance(m, OrientOrder)],
            [m for m in cpu.measure_props if isinstance(m, OrientOrder)]):
        (step, got), (step_c, want) = mc.blocks[-1], mh.blocks[-1]
        diff = float(np.abs(got - want).max())
        print(f"[measure] {what}: OrientOrder at step {step}: max |q_l "
              f"card - CPU| {diff:.3e} over {got.shape} (bound "
              f"{MEASURE_Q_TOL:.0e})")
        if step != step_c or not diff <= MEASURE_Q_TOL:
            raise RuntimeError(f"{what}: OrientOrder departs")


def _abs_state(st):
    """The state with |v|, |W| and |U|: an observer of it sums the
    magnitudes of the observer's terms (the scale float32 rounds)."""
    return st._replace(velocity=st.velocity.abs(), virial=st.virial.abs(),
                       potential_energy=st.potential_energy.abs())


def _rdf_peak(d, pair):
    """The radius of g(r)'s largest value in rdf.out's `pair` column."""
    heads, rows = _split_rows(d / "rdf.out")
    names = heads[0].split()
    col = names.index(pair) if pair in names else names.index(
        "-".join(reversed(pair.split("-"))))
    return float(rows[np.argmax(rows[:, col]), 0])


def _measure_physics(d, n):
    """(a)'s outputs against what rocksalt PbTe at 300 K must give."""
    a0 = 6.57
    checks = []
    peak = _rdf_peak(d, "Te-Pb")
    checks.append((f"first Pb-Te peak of g(r) at {peak:.3f} A (a0/2 = "
                   f"{a0 / 2:.3f} +- 0.1)", abs(peak - a0 / 2) <= 0.1))
    _, adf = _split_rows(d / "adf.out")
    low = adf[adf[:, 0] < 135.0]
    high = adf[adf[:, 0] >= 135.0]
    a_low = float(low[np.argmax(low[:, 1]), 0])
    a_high = float(high[np.argmax(high[:, 1]), 0])
    checks.append((f"ADF maxima in the bins from {a_low:g} and {a_high:g} "
                   f"degrees (90 +- 4; above 170)",
                   abs(a_low + 1.0 - 90.0) <= 4.0 and a_high >= 170.0))
    _, q = _split_rows(d / "orientorder.out")
    q4, q6 = (float(x) for x in q.mean(axis=0))
    checks.append((f"mean q4 {q4:.4f}, q6 {q6:.4f} (simple cubic 0.764, "
                   f"0.354, +- 15%)",
                   abs(q4 / 0.764 - 1) <= 0.15 and abs(q6 / 0.354 - 1)
                   <= 0.15))
    _, mvac = _split_rows(d / "mvac.out")
    checks.append((f"mvac.out's first row sums to {mvac[0, 1:].sum():.6f} "
                   f"(3)", abs(mvac[0, 1:].sum() - 3.0) <= 1e-5))
    _, chunk = _split_rows(d / "compute_chunk.out")
    # an output's rows are the chunks 0, 1, ...; the box edge in float32
    # (16 x 6.57 + 3e-6 A) leaves a 17th, sliver bin, as in the JAX app
    out = np.cumsum(chunk[:, 0] == 0)
    sums = np.array([chunk[out == k, 2].sum() for k in range(1, out[-1] + 1)])
    bound = 0.05 * (len(chunk) // len(sums))
    checks.append((f"compute_chunk counts of {len(chunk) // len(sums)} bins "
                   f"sum to {sums.tolist()} ({n} +- {bound:g}, the printed "
                   f".1f)", bool(np.all(np.abs(sums - n) <= bound))))
    _, comp = _split_rows(d / "compute.out")
    p = comp[:, 16:22].reshape(len(comp), 3, 2)  # momentum: (row, k, group)
    ratio = float((np.abs(p.sum(axis=2)) / np.abs(p).sum(axis=2)).max())
    checks.append((f"compute.out's momentum over both groups / the groups' "
                   f"|momentum| at most {ratio:.3e} (1e-2)", ratio <= 1e-2))
    for text, ok in checks:
        print(f"[measure] (a) physics: {text}: {'ok' if ok else 'FAILED'}")
    if not all(ok for _, ok in checks):
        raise RuntimeError("measure deck (a): a physics check failed")


def _measure_a(tmp, results):
    """(a) PbTe 32,768 under nvt_ber with every snapshot measure, compute
    and compute_chunk; in turns with the same deck with only dump_thermo
    100."""
    from gpumd_tpu_torch.measure.properties import (
        ADF,
        RDF,
        AngularRDF,
        OrientOrder,
    )

    steps = MEASURE_STEPS
    d0 = tmp / "thermo"
    _pbte_deck(d0, MEASURE_CELLS, "potential nep.txt\ntime_step 1\n"
               "ensemble nvt_ber 300 300 100\ndump_thermo 100\n"
               f"run {steps}\n", halves=True)
    s0, _ = _session(d0, count=False)
    d = tmp / "measures"
    _pbte_deck(d, MEASURE_CELLS, MEASURE_A.format(steps=steps), halves=True)
    s, counts, rec = _recorded_session(d, 5)
    n = s._n
    print(f"[measure] (a) PbTe {n}, nvt_ber, {steps} steps, chunks of 5: "
          f"route {s.route_reason or 'compact engine'}; "
          f"per_atom_virial={s.md.per_atom_virial}")
    if s.route_reason is not None:
        raise RuntimeError("measure deck (a): not on the compact engine")
    _launch_check("(a) measure deck", counts,
                  {**{k: steps for k in NEP_BASE}, "compact_rows": 2 * steps})
    for k in NEP_BASE + ("compact_rows",):
        results.setdefault(k, {})["launches_measure"] = counts[k]
    w0, w1 = s0.run_seconds[0], s.run_seconds[0]
    print(f"[measure] (a) in turns: dump_thermo 100 alone {w0:.3f} s "
          f"({n * steps / w0:.6e} atom-step/s); the measure deck {w1:.3f} s "
          f"({n * steps / w1:.6e} atom-step/s), of which the recorder "
          f"{rec.seconds:.3f} s ({n * steps / (w1 - rec.seconds):.6e} "
          f"atom-step/s without it): the measures "
          f"{1e3 * (w1 - rec.seconds - w0) / steps:+.3f} ms a step")
    _measure_physics(d, n)
    t0 = time.time()
    cpu = _replay(d, rec, last_only=(RDF, AngularRDF, ADF, OrientOrder))
    print(f"[measure] (a) the CPU's float64 recomputation of "
          f"{len(rec.snaps)} snapshots: {time.time() - t0:.1f} s")
    _files_match("(a)", d, ("msd.out", "sdc.out", "dos.out", "mvac.out",
                            "ic.out", "compute.out", "compute_chunk.out"))
    _neighbor_match("(a)", rec, cpu)
    _measure_costs(d, rec, steps, w1 - rec.seconds - w0)


def _measure_costs(d, rec, steps, extra):
    """What a sample of each of (a)'s measures costs on the card: fresh
    instances from the deck's keywords on a card session, each sampling
    the last recorded snapshot three times (host clock, synchronised);
    the sum over the run's samples beside the measure deck's extra
    seconds over the thermo deck."""
    from gpumd_tpu_torch.app.gpumd import Session, parse_run_in

    c = d / "cost"
    c.mkdir()
    for name in ("model.xyz", "nep.txt"):
        (c / name).symlink_to(d / name)
    s = Session(str(c), quiet=True, device="cuda")
    for toks in parse_run_in(str(d / "run.in")):
        if toks[0] != "run":
            s.KEYWORDS[toks[0]](s, toks[1:])
    step, snap, h = rec.snaps[-1]
    st = _state64(snap, h, torch.float32, "cuda")
    total, parts = 0.0, []
    with torch.no_grad():
        for m in list(s.measure_props) + list(s.properties):
            fn = (m.process if hasattr(m, "process")
                  else lambda sess, x, k, m=m: m.sample_state(sess, x, k))
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.time()
                fn(s, st, step)
                torch.cuda.synchronize()
                walls.append(time.time() - t0)
            ms = 1e3 * min(walls[1:])
            n_samples = steps // m.interval
            total += ms * n_samples / 1e3
            name = (m.process.__qualname__.split(".")[1]
                    if hasattr(m, "process") else type(m).__name__)
            parts.append(f"{name} {ms:.2f} ms x {n_samples}")
    for f in s._files.values():
        f.close()
    print(f"[measure] (a) a sample on the card (best of the 2nd and 3rd "
          f"of 3): {'; '.join(parts)}: {total:.3f} s of the run's "
          f"{extra:.3f} s over the thermo deck (the rest: the chunks of 5 "
          f"steps' reads and `to_input_order`)")


def _identity_modes(path, n):
    """eigenvector.in of the identity basis for n atoms: 3n ascending
    omega^2, then mode m = (atom m // 3, direction m % 3), float32."""
    nm = 3 * n
    buf = np.zeros(nm + nm * nm, np.float32)
    buf[:nm] = np.arange(1, nm + 1)
    m = np.arange(nm)
    buf[nm + m * nm + (m % 3) * n + m // 3] = 1.0
    buf.tofile(path)
    return nm


def _measure_modal(tmp, results):
    """(b) PbTe 1,728 (6^3 cells) NVE with compute_gkma over the identity
    modes and compute virial jp, 200 steps; then 100 steps of
    compute_hnema on the same modes."""
    import os

    from gpumd_tpu_torch.measure.properties import heat_current_5

    nc, steps = MODAL_CELLS, MODAL_STEPS
    d = tmp / "modal"
    _pbte_deck(d, nc, "potential nep.txt\ntime_step 1\nensemble nve\n"
               f"compute_gkma 10 1 {3 * 8 * nc ** 3} bin_size 1\n"
               f"compute 0 10 10 virial jp\nrun {steps}\n", halves=True)
    nm = _identity_modes(d / "eigenvector.in", 8 * nc ** 3)
    s, counts, rec = _recorded_session(d, 10)
    print(f"[measure] (b) PbTe {s._n}, {nm} identity modes, NVE, {steps} "
          f"steps: route {s.route_reason or 'compact engine'}; "
          f"per_atom_virial={getattr(s.md, 'per_atom_virial', None)} (12 "
          f"channels); plan {_plan(s.md) if s.md is not None else None}")
    if s.route_reason is not None or not s.md.per_atom_virial:
        raise RuntimeError("measure deck (b): not on the compact engine at "
                           "12 channels")
    _launch_check("(b) modal deck", counts, {k: steps for k in NEP_BASE})
    for k in NEP_BASE + ("compact_rows", "compact_windows"):
        if counts[k]:
            results.setdefault(k, {})["launches_measure_modal"] = counts[k]
    _, jm = _split_rows(d / "heatmode.out")
    jm = jm.reshape(-1, nm, 5)
    worst = 0.0
    for (step, snap, h), rows in zip(rec.snaps, jm):
        j5 = heat_current_5(_state64(snap, h)).numpy()
        worst = max(worst, float(np.abs(rows.sum(axis=0) - j5).max()
                                 / np.abs(j5).max()))
    print(f"[measure] (b) heatmode.out {jm.shape}: the modes' sum against "
          f"heat_current_5 of each of {len(rec.snaps)} recorded snapshots "
          f"(f64): max diff / max |J| {worst:.3e} (bound {MODAL_SUM_TOL})")
    if len(jm) != steps // 10 or not worst <= MODAL_SUM_TOL:
        raise RuntimeError("measure deck (b): the modal sum departs")
    _replay(d, rec)
    _files_match("(b)", d, ("heatmode.out", "compute.out"))
    d2 = tmp / "hnema"
    _pbte_deck(d2, nc, "potential nep.txt\ntime_step 1\nensemble nve\n"
               f"compute_hnema 10 20 1e-4 0 0 1 {nm} bin_size 1\n"
               f"run {HNEMA_STEPS}\n")
    os.symlink(d / "eigenvector.in", d2 / "eigenvector.in")
    s2, counts2 = _session(d2)
    _launch_check("(b) hnema deck", counts2,
                  {k: HNEMA_STEPS for k in NEP_BASE})
    km = np.atleast_2d(np.loadtxt(d2 / "kappamode.out"))
    print(f"[measure] (b) hnema: route {s2.route_reason or 'compact engine'}"
          f", per_atom_virial={s2.md.per_atom_virial}; kappamode.out "
          f"{km.shape}, finite {bool(np.isfinite(km).all())}, summed over "
          f"modes (last output) {km[-nm:].sum(axis=0).tolist()}")
    if (s2.route_reason is not None
            or km.shape != (HNEMA_STEPS // 20 * nm, 5)
            or not np.isfinite(km).all()):
        raise RuntimeError("hnema deck: kappamode.out malformed")


def _measure_list(tmp):
    """(c) PbTe 32,768 on the list path, 100 steps: (c1) viscosity,
    (c2) HNEMDEC colour flow."""
    from gpumd_tpu_torch.measure.properties import onsager_flux, stress_6

    steps = LIST_STEPS
    for label, line, reason, out, shape in (
            ("c1", "compute_viscosity 1 50", "per-step stress observer",
             "viscosity.out", (min(50, steps), 13)),
            ("c2", "compute_hnemdec 1 20 1e-4 0 0", "compute_hnemdec",
             "onsager.out", (steps // 20, 9))):
        d = tmp / label
        _pbte_deck(d, MEASURE_CELLS, "potential nep.txt\ntime_step 1\n"
                   f"ensemble nve\n{line}\nrun {steps}\n")
        s, counts, rec = _recorded_session(d, 1)
        print(f"[measure] ({label}) PbTe {s._n}, `{line}`, {steps} steps in "
              f"{s.run_seconds[0]:.2f} s: engine auto: list path "
              f"({s.route_reason})")
        if s.route_reason != reason or s.md is not None:
            raise RuntimeError(f"({label}): not on the list path for "
                               f"{reason!r}")
        _launch_check(f"({label})", counts, {}, never=tuple(counts))
        rows = np.atleast_2d(np.loadtxt(d / out))
        if rows.shape != shape or not np.isfinite(rows).all():
            raise RuntimeError(f"({label}): {out} {rows.shape}, expected "
                               f"{shape} finite")
        ons = [m for m in rec.measures if hasattr(m, "mass_type")]
        worst = 0.0
        with torch.no_grad():
            for step, snap, h in rec.snaps:
                st = _state64(snap, h)
                card = _state64(snap, h, torch.float32, "cuda")
                if ons:
                    m = ons[0]
                    fn = lambda x: onsager_flux(x, m.mass_type,  # noqa
                                                m.num_types)
                else:
                    fn = stress_6
                got = fn(card).double().cpu()
                want, scale = fn(st), fn(_abs_state(st))
                worst = max(worst, float(((got - want).abs() / scale).max()))
        print(f"[measure] ({label}) {'onsager_flux' if ons else 'stress_6'} "
              f"of {len(rec.snaps)} recorded snapshots, card against CPU "
              f"f64: max diff / the terms' magnitude {worst:.3e} (bound "
              f"{MEASURE_FLUX_TOL:.0e}); {out} {rows.shape}")
        # the driving force ends with the run
        if not worst <= MEASURE_FLUX_TOL or s.ff.hnemdec_mode is not None:
            raise RuntimeError(f"({label}): the observer departs")
        _replay(d, rec)
        _files_match(f"({label})", d, (out,))


def phase_measure(results):
    """The measure keywords through Session on the card (phase 13 of the
    module docstring)."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for label, fn in (("a", lambda: _measure_a(tmp, results)),
                          ("b", lambda: _measure_modal(tmp, results)),
                          ("c", lambda: _measure_list(tmp))):
            t1 = time.time()
            fn()
            print(f"[measure] ({label}) done in {time.time() - t1:.1f} s")
    print(f"[measure] phase done in {time.time() - t0:.1f} s")


def _force_repeats(md, state, k=5):
    """One force pass on one state repeated k times: the largest
    difference of the forces, per-atom energies and virials from the
    first pass's, over each one's largest magnitude (0: bit for bit).  A
    lattice start has net forces near 0 against pair terms of eV/A, so
    the state is a run's last, thermalized."""
    with torch.no_grad():
        carry = md.init_carry(state)
        outs = [md.compute(carry.state, carry.idx) for _ in range(k)]
    diff = {}
    for f in ("force", "potential_energy", "virial"):
        a = [getattr(o, f) for o in outs]
        scale = float(a[0].abs().max())
        diff[f] = max(float((b - a[0]).abs().max()) for b in a[1:]) / scale
    return diff


def _spread_pairs(runs, i, j):
    """Rows and final positions of run i against run j: the max diff /
    scale (T KE PE, stress, box) at step 20 and over all rows, and the
    largest |dx| at the end."""
    (ra, sa), (rb, sb) = runs[i], runs[j]
    dx = float(sa.box.minimum_image(sa.position - sb.position).abs().max())
    return _row_diff(ra[:1], rb[:1]), _row_diff(ra, rb), dx


def phase_app_spread(results, pot_path, repeats=3):
    """The app against the direct run, each repeated (app-spread in the
    module docstring): what separates the app's rows and positions from
    the direct run's, beside what separates two app runs and two direct
    runs."""
    import itertools

    from gpumd_tpu_torch.engine import cuda_build

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, make, direct in (
                ("config 3 deck", lambda d: _pbte_deck(d, 16, CONFIG3_DECK),
                 _config3_direct),
                ("Tersoff deck", lambda d: _tersoff_deck(d, pot_path),
                 _tersoff_direct)):
            app, drv = [], []
            for r in range(repeats):  # in turns: app, direct, app, ...
                d = tmp / f"{name.split()[0]}{r}"
                make(d)
                s, _ = _session(d, count=False)
                app.append((_thermo(d, 10), s.state))
                rows, snap, md = direct(d, s._n)
                drv.append((rows, snap))
            # the force pass on the last direct run's final state
            cuda_build.reset_launches()
            rep = _force_repeats(md, snap)
            launched = {k: v for k, v in cuda_build.launches.items() if v}
            print(f"[spread] {name}: one force pass repeated 5 times on the "
                  f"state of step 200 (launches {launched}): max diff "
                  f"/ max |value| from the first pass: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in rep.items()))
            both = app + drv
            k = len(app)
            for kind, pairs in (
                    ("app-app", itertools.combinations(range(k), 2)),
                    ("direct-direct",
                     itertools.combinations(range(k, 2 * k), 2)),
                    ("app-direct",
                     itertools.product(range(k), range(k, 2 * k)))):
                got = [_spread_pairs(both, i, j) for i, j in pairs]
                first = np.max([g[0] for g in got], axis=0)
                last = np.max([g[1] for g in got], axis=0)
                dxs = [g[2] for g in got]
                same = sum(1 for g in got
                           if not (max(g[1]) or g[2]))
                print(f"[spread] {name}, {kind} ({len(got)} pairs, "
                      f"{same} the same to the bit): max diff / scale (T KE "
                      f"PE, stress, box) at step 20 {first[0]:.3e}, "
                      f"{first[1]:.3e}, {first[2]:.3e}; over 200 steps "
                      f"{last[0]:.3e}, {last[1]:.3e}, {last[2]:.3e}; max "
                      f"|dx| at step 200 "
                      f"{[float(f'{x:.3e}') for x in dxs]} A")
    print(f"[app-spread] phase done in {time.time() - t0:.1f} s")



# ---- phase 14: the ensembles (the list path's NEMD, MTTK, shock, QTB,
# TTM and TI ensembles and deform, through the app) ----------------------

# LJ argon 4,000 (config 1's geometry), four slabs along x as grouping
# method 0: slab 0 the heat source, slab 2 the sink.
ENS_CELLS, ENS_STEPS, ENS_T = 10, 20, 60.0
# (a)'s CPU references: ENS_WORKERS worker processes of two torch threads
# each
ENS_WORKERS = 4
# (a) the decks: a keyword's ensemble line, and what else the deck holds.
ENS_DECKS = {
    "heat_lan": "ensemble heat_lan 60 20 15 0 2\ncompute 0 5 10 temperature",
    "heat_nhc": "ensemble heat_nhc 60 20 15 0 2\ncompute 0 5 10 temperature",
    "heat_bdp": "ensemble heat_bdp 60 20 15 0 2\ncompute 0 5 10 temperature",
    "heat_hybrid": "ensemble heat_hybrid nhc lan 60 20 20 15 0 2\n"
                   "compute 0 5 10 temperature",
    "nvt_mttk": "ensemble nvt_mttk temp 60 60 tperiod 50",
    "npt_mttk": "ensemble npt_mttk temp 60 60 iso 0.2 0.2 pperiod 100",
    "npt_mttk tri": "ensemble npt_mttk temp 60 60 tri 0.2 0.2 pperiod 100",
    "npt_mttk axes": "ensemble npt_mttk temp 60 60 x 0.1 0.1 y 0.2 0.2 "
                     "z 0 0 xy 0.05 0.05 pperiod 100",
    "nph_mttk": "ensemble nph_mttk aniso 0.2 0.2 pperiod 100",
    "nphug": "ensemble nphug tperiod 100 pperiod 100 x 0.5 0.5",
    "nvt_qtb": "ensemble nvt_qtb 60 60 20 f_max 100 N_f 8",
    "npt_qtb": "ensemble npt_qtb temp 60 60 tperiod 20 f_max 100 N_f 8 "
               "iso 0.2 0.2 pperiod 100",
    "msst": "ensemble msst x 3 qmass 200 mu 5 tscale 0.05",
    "wall_piston": "ensemble wall_piston vp 10 thickness 6\n"
                   "dump_shock_nemd interval 5 bin_size 5.0",
    "wall_mirror": "ensemble wall_mirror vp 10 thickness 6",
    "wall_harmonic": "ensemble wall_harmonic vp 5 k 2.0 thickness 6",
    "ttm": "ensemble ttm 0 1 1.0e-5 1.0 1.0 5.0 1.0 0.5 2 2 1 600 "
           "ttm_out_interval 10",
    "heat_ttm": "ensemble heat_ttm 0 1 1.0e-5 1.0 1.0 5.0 0 100 4 1 1 600 "
                "ttm_source 0.001",
    "ti_spring": "ensemble ti_spring temp 60 tperiod 30 tswitch 8 tequil 2 "
                 "spring Ar 0.5",
    "ti": "ensemble ti lambda 0.4 temp 60 tperiod 30 spring Ar 0.5",
    "ti_rs": "ensemble ti_rs temp 60 90 iso 0 tperiod 30 pperiod 100 "
             "tswitch 8 tequil 2",
    "ti_as": "ensemble ti_as temp 60 press 0 0.2 tperiod 30 pperiod 100 "
             "tswitch 8 tequil 2",
    "ti_liquid": "ensemble ti_liquid temp 60 tperiod 30 tswitch 8 tequil 2 "
                 "sigmasqrd 2.0 p 25",
    "deform": "deform 0.005 1 0 1\nensemble nvt_ber 60 60 100",
}
# The noise a keyword's class draws through its `draw` hook: the card's
# and the CPU's run get the same numbers from one numpy seed (HeatBDP
# draws its own from numpy.random.default_rng(12345) in both).
ENS_NOISE = {"HeatLangevin": "normal", "HeatHybrid": "normal",
             "NVTQTB": "normal", "TTM": "uniform", "TISpring": "normal",
             "TI": "normal", "TILiquid": "normal"}
# (a)'s gates, card (float32) against the CPU (float64) after 20 steps:
# positions within list-md's 1e-3 A; compute.out, the .csv and _hist.txt
# files and ttm_electron_temperature.out within ENS_OUT_TOL of a column's
# largest magnitude (float32 velocities and sums: ~1e-6 relative a sample,
# the trajectories apart by ~1e-6 A); a .yaml entry within ENS_YAML_TOL
# eV/atom (F and G are sums of terms of ~0.1 eV/atom).
ENS_OUT_TOL = 1e-3
ENS_YAML_TOL = 1e-4
# (b): the heat baths' source slab above the sink by ENS_DT_MARGIN K after
# 400 steps of 5 fs at 30 +- 15 K (tests/test_nemd.py's deck and margin;
# the lattice starts at 60 K, which equipartition halves; on the H100 1,000
# steps gave 15.5-27.1 K and 600 steps 13.1-26.8 K);
# nvt_mttk (LJArgon, 80 K, to 60 K) over 1,000 steps of 2 fs: its
# conserved quantity within ENS_MTTK_CONS_TOL eV/atom (the H100 read 1.915
# eV in 1,000 steps and 1.927 eV in 500, 4.8e-4 eV/atom: the unshifted LJ
# cutoff's crossings), while KE + U alone, which leaves out the chain's
# reservoir, must move by more than twice that bound (the chain reheats
# the lattice from ~40 K: ~3 N kB 20 K = 21 eV), so that a conserved
# quantity without the chain's terms would fail the gate;
# npt_mttk iso halves its distance to the target pressure in 1,000 steps;
# msst on tests/test_msst.py's box (fcc argon 3^3 cells, 108 atoms, 40 K,
# 800 steps of 2 fs) compresses x past that test's ENS_MSST_SHRINK (the
# port matches JAX's run there within 1e-9 on the CPU,
# tests/test_torch_shock.py).
ENS_DT_MARGIN = 5.0
ENS_MTTK_CONS_TOL = 1e-3
ENS_HEAT_STEPS, ENS_MTTK_CONS_STEPS, ENS_NPT_STEPS = 400, 1000, 1000
ENS_MSST_CELLS, ENS_MSST_T, ENS_MSST_STEPS = 3, 40.0, 800
ENS_MSST_SHRINK = 0.005
# the wall piston at ENS_PISTON_VP km/s for 100 steps of 2 fs: its atoms
# within ENS_PISTON_TOL A of vp t, the far wall still, the run finite.  At
# 10 km/s (tests/test_msst.py's deck, 0.2 A a step into the lattice) the
# run blows up within 100 steps (its velocities go non-finite) and its
# rows outgrow MN 256 (the list path's capacity check stops it); at 2 km/s
# the shock heats the lattice and the run stays finite
ENS_PISTON_VP, ENS_PISTON_TOL = 2.0, 0.01
# (c): NEP PbTe 32,768 on the list path, heat_lan on four slabs along x.
ENS_PBTE_CELLS, ENS_PBTE_STEPS, ENS_PBTE_WARM = 16, 100, 100


def _ens_slabs(pos, length, k=4):
    return np.minimum((pos[:, :1] / (length / k)).astype(int), k - 1)


def _ens_argon(d, line, steps=ENS_STEPS, dt_fs=2.0, temperature=ENS_T,
               extra="", nc=ENS_CELLS):
    """LJ argon 4,000 (nc^3 fcc cells) with four slabs along x, and its
    deck."""
    import shutil

    a0 = 5.26
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    n = len(pos)
    _write_model(d, ["Ar"] * n, pos, np.full(n, 39.948), [nc * a0] * 3,
                 temperature, 7, groups=_ens_slabs(pos, nc * a0))
    shutil.copy(LJ_FILE, d / "lj.txt")
    (d / "run.in").write_text(f"potential lj.txt\ntime_step {dt_fs}\n{line}\n"
                              f"{extra}run {steps}\n")
    return n


def _ens_patches(seed=11):
    """The `draw` hooks of ENS_NOISE's classes from one numpy generator
    each: (attribute, class given draw) pairs for app.gpumd."""
    import functools

    import gpumd_tpu_torch.app.gpumd as tapp

    out = []
    for k, (cls, kind) in enumerate(sorted(ENS_NOISE.items())):
        rng = np.random.default_rng(seed + k)

        def draw(shape, dtype, device, rng=rng, kind=kind):
            x = (rng.standard_normal(shape) if kind == "normal"
                 else rng.random(shape))
            return torch.as_tensor(x, dtype=dtype, device=device)

        out.append((cls, functools.partial(getattr(tapp, cls), draw=draw)))
    return out


def _ens_session(d, device, dtype=None, noise=True):
    """Session(d) on `device`, with ENS_NOISE's draw hooks patched in
    unless `noise` is false (the timed decks draw from the port's own
    generators on the card)."""
    import gpumd_tpu_torch.app.gpumd as tapp

    saved = {cls: getattr(tapp, cls) for cls in ENS_NOISE}
    try:
        for cls, fn in (_ens_patches() if noise else ()):
            setattr(tapp, cls, fn)
        s = tapp.Session(str(d), quiet=True, device=device, dtype=dtype)
        s.execute()
    finally:
        for cls, fn in saved.items():
            setattr(tapp, cls, fn)
    return s


def _ens_cpu(d):
    """(a)'s CPU reference in a worker process: d's deck in float64 on the
    CPU, in d/cpu; returns the final positions and the box."""
    import shutil

    torch.set_num_threads(2)
    c = Path(d) / "cpu"
    c.mkdir()
    for name in ("model.xyz", "lj.txt", "run.in"):
        shutil.copy(Path(d) / name, c / name)
    s = _ens_session(c, "cpu", torch.float64)
    return (s.state.position.numpy(), s.state.box.h.numpy(),
            s.route_reason)


def _ens_files_close(what, d, names):
    """Each output file of d against d/cpu's: ENS_OUT_TOL of a column's
    largest magnitude (.yaml: ENS_YAML_TOL eV/atom); the worst of each."""
    worst = {}
    for name in names:
        got, want = d / name, d / "cpu" / name
        if name.endswith(".yaml"):
            a, b = ([float(x.split(":")[1]) for x in p.read_text().split(
                "\n") if x] for p in (got, want))
            worst[name] = float(np.abs(np.subtract(a, b)).max())
            bound = ENS_YAML_TOL
        else:
            csv = name.endswith(".csv")
            a, b = (np.atleast_2d(np.loadtxt(p, comments="#",
                                             delimiter="," if csv else None,
                                             skiprows=int(csv)))
                    for p in (got, want))
            if a.shape != b.shape:
                raise RuntimeError(f"(a) {what}: {name} {a.shape} against "
                                   f"the CPU's {b.shape}")
            scale = np.maximum(np.abs(b).max(axis=0), 1e-12)
            worst[name] = float((np.abs(a - b).max(axis=0) / scale).max())
            bound = ENS_OUT_TOL
        if not np.isfinite(a).all() or not worst[name] <= bound:
            raise RuntimeError(f"(a) {what}: {name} departs from the CPU's "
                               f"({worst[name]:.3e}, bound {bound})")
    return worst


def _ens_card_runs(tmp, pool):
    """(a) every keyword's deck, 20 steps on the card (float32); the same
    deck on the CPU in float64 submitted to `pool`'s worker processes
    first.  Returns {keyword: (directory, the CPU's future)} and the card
    sessions."""
    from gpumd_tpu_torch.engine import cuda_build

    futures = {}
    # ti_liquid first: its all-pairs UF sum is the CPU's longest deck
    for key in sorted(ENS_DECKS, key=lambda k: k != "ti_liquid"):
        d = tmp / "a" / key.replace(" ", "_")
        _ens_argon(d, ENS_DECKS[key])
        futures[key] = (d, pool.submit(_ens_cpu, str(d)))
    cards = {}
    for key, (d, _) in futures.items():
        cuda_build.reset_launches()
        t0 = time.time()
        s = _ens_session(d, "cuda")
        torch.cuda.synchronize()
        counts = dict(cuda_build.launches)
        _launch_check(f"(a) {key}", counts, {}, never=tuple(counts))
        # LJ has no compact engine: the list path for that reason first
        if s.route_reason is None or s.md is not None:
            raise RuntimeError(f"(a) {key}: not on the list path")
        cards[key] = (s, time.time() - t0)
    return futures, cards


def _ens_card_vs_cpu(futures, cards):
    """(a)'s gates: each card run against the CPU's float64 run."""
    from gpumd_tpu_torch.model.box import Box

    for key, (d, fut) in futures.items():
        s, wall = cards[key]
        pos, h, route = fut.result()
        n = s._n
        box = Box.from_lattice(h.T, dtype=torch.float64, device="cpu")
        dx = float(box.minimum_image(
            s.state.position[:n].double().cpu() - torch.as_tensor(pos)[:n]
        ).abs().max())
        names = sorted(p.name for p in d.iterdir()
                       if p.suffix in (".csv", ".yaml")
                       or p.name.endswith("_hist.txt")
                       or p.name in ("compute.out",
                                     "ttm_electron_temperature.out"))
        worst = _ens_files_close(key, d, names)
        print(f"[ensembles] (a) {key}: card {wall:.2f} s (run "
              f"{s.run_seconds[0]:.3f} s), route: {s.route_reason}; max "
              f"|dx| against the CPU's float64 run {dx:.3e} A (bound "
              f"{POS_TOL}); "
              + (", ".join(f"{k} {v:.2e}" for k, v in worst.items())
                 or "no output file"))
        if not dx <= POS_TOL:
            raise RuntimeError(f"(a) {key}: positions depart from the CPU's")


def _ens_rows(path, skip=0):
    return np.atleast_2d(np.loadtxt(path, comments="#"))[skip:]


def _ens_heat(tmp):
    """(b) the four heat baths: a gradient and the baths' signs."""
    for name, line in (("heat_lan", "heat_lan 30 50 15 0 2"),
                       ("heat_nhc", "heat_nhc 30 50 15 0 2"),
                       ("heat_bdp", "heat_bdp 30 50 15 0 2"),
                       ("heat_hybrid", "heat_hybrid nhc lan 30 100 100 15 "
                                       "0 2")):
        d = tmp / "b" / name
        steps = ENS_HEAT_STEPS
        _ens_argon(d, f"ensemble {line}\ncompute 0 10 {steps} temperature",
                   steps=steps, dt_fs=5.0, temperature=60.0)
        s = _ens_session(d, "cuda")
        row = _ens_rows(d / "compute.out")[-1]
        t, e_src, e_snk = row[:4], row[4], row[5]
        print(f"[ensembles] (b) {name}: {steps} steps of 5 fs in "
              f"{s.run_seconds[0]:.2f} s; slab T {np.round(t, 2).tolist()} "
              f"K (source - sink {t[0] - t[2]:.2f}, bound > "
              f"{ENS_DT_MARGIN}); baths {e_src:.4e} / {e_snk:.4e} eV")
        if not (t[0] > t[2] + ENS_DT_MARGIN and e_src < 0.0 < e_snk
                and np.isfinite(row).all()):
            raise RuntimeError(f"(b) {name}: no gradient or wrong signs")


def _ens_mttk_conserved():
    """(b) nvt_mttk driven directly: its conserved quantity over 1,000
    steps of 2 fs, and KE + U alone beside it."""
    from gpumd_tpu_torch.integrate.ensembles.mttk import MTTK
    from gpumd_tpu_torch.integrate.run import MDRunner
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    lj = LJArgon()
    ff = lj.ff
    dt = 2.0 / TIME_UNIT_CONVERSION
    ens = MTTK.nvt(60.0, 60.0, t_period=50.0)
    def ke_u(s):
        return (0.5 * float(torch.sum(s.mass * torch.sum(
            s.velocity.double() ** 2, dim=-1) * s.mask))
            + float(torch.sum(s.potential_energy.double() * s.mask)))

    steps = ENS_MTTK_CONS_STEPS
    with torch.no_grad():
        state = ff.compute(lj.state)
        aux = ens.init(state)
        h0, e0 = ens.conserved(state, aux, dt), ke_u(state)
        t0 = time.time()
        state, (aux, _), _ = MDRunner(ff, ens, dt, steps)(state, aux=aux)
        torch.cuda.synchronize()
        wall = time.time() - t0
        h1, e1 = ens.conserved(state, aux, dt), ke_u(state)
    bound = ENS_MTTK_CONS_TOL * lj.n
    print(f"[ensembles] (b) nvt_mttk LJ {lj.n}, {steps} steps of 2 fs in "
          f"{wall:.2f} s ({1e3 * wall / steps:.3f} ms/step): conserved "
          f"quantity {h0:.6f} -> {h1:.6f} eV (change {h1 - h0:+.3e}, bound "
          f"{bound:.3e}); KE + U alone {e0:.6f} -> {e1:.6f} eV (change "
          f"{e1 - e0:+.3e}, must exceed {2 * bound:.3e})")
    if not abs(h1 - h0) <= bound:
        raise RuntimeError("(b) nvt_mttk: the conserved quantity drifts")
    if not abs(e1 - e0) > 2 * bound:
        raise RuntimeError("(b) nvt_mttk: the chain moved too little energy "
                           "for the gate to tell its terms")


def _ens_barostats(tmp):
    """(b) npt_mttk iso toward its pressure; msst and wall_piston
    compress along x."""
    d = tmp / "b" / "npt"
    _ens_argon(d, "ensemble npt_mttk temp 60 60 iso 0.3 0.3 pperiod 200\n"
               "dump_thermo 10", steps=ENS_NPT_STEPS)
    _ens_session(d, "cuda")
    p = _ens_rows(d / "thermo.out")[:, 3:6].mean(axis=1)
    gap0, gap1 = abs(p[0] - 0.3), abs(p[-20:].mean() - 0.3)
    print(f"[ensembles] (b) npt_mttk iso 0.3 GPa, {ENS_NPT_STEPS} steps: "
          f"pressure {p[0]:.4f} GPa at step 10, {p[-20:].mean():.4f} over "
          f"the last 200 steps (distance to the target {gap0:.4f} -> "
          f"{gap1:.4f})")
    if not gap1 < 0.5 * gap0:
        raise RuntimeError("(b) npt_mttk: the pressure does not relax")
    d = tmp / "b" / "msst"
    n = _ens_argon(d, "ensemble msst x 3 qmass 200 mu 5 tscale 0.05",
                   steps=ENS_MSST_STEPS, temperature=ENS_MSST_T,
                   nc=ENS_MSST_CELLS)
    s = _ens_session(d, "cuda")
    h0 = s.box.h.double().cpu()
    h1 = s.state.box.h.double().cpu()
    shrink = 1.0 - float(h1[0, 0] / h0[0, 0])
    print(f"[ensembles] (b) msst x 3 km/s, argon {n} at {ENS_MSST_T:g} K, "
          f"{ENS_MSST_STEPS} steps: Lx {float(h0[0, 0]):.4f} -> "
          f"{float(h1[0, 0]):.4f} A ({shrink:.3%}, bound > "
          f"{ENS_MSST_SHRINK:.1%}), Ly {float(h0[1, 1]):.6f} -> "
          f"{float(h1[1, 1]):.6f} A")
    if not (shrink > ENS_MSST_SHRINK
            and abs(float(h1[1, 1] - h0[1, 1])) < 1e-4):
        raise RuntimeError("(b) msst: no compression along x")
    d = tmp / "b" / "piston"
    n = _ens_argon(d, f"ensemble wall_piston vp {ENS_PISTON_VP:g} "
                   "thickness 6\ndump_thermo 10", steps=100)
    s = _ens_session(d, "cuda")
    x0 = torch.as_tensor(s.frame.positions[:, 0])
    x1 = s.state.position[:n, 0].double().cpu()
    piston, frozen = x0 < 6.0, x0 > float(s.box.h[0, 0]) - 6.0
    move = (x1 - x0)[piston]
    still = float((x1 - x0)[frozen].abs().max())
    want = ENS_PISTON_VP / 100.0 * 200.0  # km/s -> A/fs, 100 steps of 2 fs
    t = _ens_rows(d / "thermo.out")[:, 0]
    finite = bool(torch.isfinite(s.state.velocity).all()) and bool(
        np.isfinite(t).all())
    print(f"[ensembles] (b) wall_piston {ENS_PISTON_VP:g} km/s, 100 steps "
          f"of 2 fs: the piston moved {float(move.min()):.4f}-"
          f"{float(move.max()):.4f} A ({want:g} expected), the far wall "
          f"{still:.2e} A; T {t[0]:.1f} -> {t[-1]:.1f} K, finite {finite}")
    if not (float((move - want).abs().max()) < ENS_PISTON_TOL
            and still < 1e-3 and finite):
        raise RuntimeError("(b) wall_piston: the piston does not compress, "
                           "or the run is not finite")


def _ens_pbte(tmp):
    """(c) NEMD at full width: NEP PbTe 32,768 on the list path, heat_lan
    on four slabs along x against NVE of the same deck; npt_mttk iso.  The
    lattice starts at 600 K, which equipartition halves to the baths'
    mean."""
    import shutil

    from gpumd_tpu_torch.bench import build_pbte
    from gpumd_tpu_torch.engine import cuda_build

    steps = ENS_PBTE_STEPS
    pos, types, lengths = build_pbte(*[ENS_PBTE_CELLS] * 3)
    out = {}
    for name, line, extra in (
            ("nve", "engine list\nensemble nve", ""),
            ("heat_lan", "ensemble heat_lan 300 20 60 0 2",
             f"compute 0 10 {steps} temperature\n"),
            ("npt_mttk", "ensemble npt_mttk temp 300 300 iso 0 0 "
                         "pperiod 200", f"dump_thermo {ENS_PBTE_WARM}\n")):
        d = tmp / "c" / name
        _write_model(d, np.where(types == 1, "Pb", "Te"), pos,
                     np.where(types == 1, 207.2, 127.6), lengths, 600.0, 5,
                     groups=_ens_slabs(pos, lengths[0]))
        shutil.copy(MODEL, d / "nep.txt")
        (d / "run.in").write_text(f"potential nep.txt\ntime_step 1\n"
                                  f"{line}\n{extra}run {ENS_PBTE_WARM}\n"
                                  f"{extra}run {steps}\n")
        cuda_build.reset_launches()
        s = _ens_session(d, "cuda", noise=False)
        counts = dict(cuda_build.launches)
        _launch_check(f"(c) {name}", counts, {}, never=tuple(counts))
        want = ("engine list" if name == "nve"
                else f"ensemble {type(s.ensemble).__name__}")
        if s.route_reason != want:
            raise RuntimeError(f"(c) {name}: route {s.route_reason!r}")
        ms = 1e3 * s.run_seconds[1] / steps
        out[name] = ms
        print(f"[ensembles] (c) PbTe {s._n} {name} on the list path: "
              f"{ms:.3f} ms/step over {steps} steps (after {ENS_PBTE_WARM} "
              f"of warm-up)"
              + (f", {ms - out['nve']:+.3f} against NVE" if "nve" in out
                 and name != "nve" else ""))
        if name == "heat_lan":
            row = _ens_rows(d / "compute.out")[-1]
            t = row[:4]
            print(f"[ensembles] (c) heat_lan slab T {np.round(t, 2).tolist()}"
                  f" K, baths {row[4]:.4e} / {row[5]:.4e} eV")
            # the source injects energy from the start; the sink takes it
            # out once the slabs between have warmed past its target
            if not (t[0] > t[1] > t[2] and t[0] > t[3] > t[2]
                    and row[4] < 0.0):
                raise RuntimeError("(c) heat_lan: no gradient")
        if name == "npt_mttk":
            rows = _ens_rows(d / "thermo.out")
            if not np.isfinite(rows).all():
                raise RuntimeError("(c) npt_mttk: non-finite thermo")
            # rows at the warm-up's end and every 100 steps of the timed
            # run: the cell moves under the barostat
            change = abs(rows[-1, 9] / rows[0, 9] - 1.0)
            print(f"[ensembles] (c) npt_mttk box a_x {rows[0, 9]:.5f} -> "
                  f"{rows[-1, 9]:.5f} A over the timed run (relative "
                  f"{change:.3e}), pressure {rows[0, 3:6].mean():.4f} -> "
                  f"{rows[-1, 3:6].mean():.4f} GPa")
            if not (rows.shape[0] == 1 + steps // ENS_PBTE_WARM
                    and change > 0.0):
                raise RuntimeError("(c) npt_mttk: the cell did not move")
    return out


def _ens_costs():
    """Host reads and costs the ensembles add, measured: TTM's substeps a
    step and ms a step on LJ 4,000; TILiquid's UF pair sum at 4,000."""
    from gpumd_tpu_torch.integrate.ensembles.ti import uf_pair
    from gpumd_tpu_torch.integrate.ensembles.ttm import TTM
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    lj = LJArgon()
    with torch.no_grad():
        state = lj.state
        uf_pair(state, 60.0, 2.0, 25.0)
        ms = _time_ms(lambda: uf_pair(state, 60.0, 2.0, 25.0), 5)
        a0 = 5.26 * ENS_CELLS
        ttm = TTM(gmask=state.mask, c_vol=1.0e-5, kappa_e=1.0e-3,
                  gamma_p=5.0 * TIME_UNIT_CONVERSION / 1000.0, grid=(2, 2, 1),
                  t_e_init=600.0, dcell_static=(a0 / 2, a0 / 2, a0))
        dt = 2.0 / TIME_UNIT_CONVERSION
        aux = ttm.init(state)
        diffuse = _time_ms(lambda: ttm._diffuse(state, aux, dt), 10)
    n_sub = ttm.substeps(2.0)
    print(f"[ensembles] costs at LJ {lj.n}: TILiquid's UF pair sum "
          f"{ms:.3f} ms (all pairs, blocks of 512); TTM's diffusion "
          f"{n_sub} substeps a step on a 2 x 2 x 1 grid, {diffuse:.3f} ms "
          f"a step")


def phase_ensembles(results):
    """The ensembles (phase 14 of the module docstring): (a) card against
    CPU, (b) physics on the card, (c) NEMD at full width.  The CPU's
    float64 references of (a) run in ENS_WORKERS worker processes while
    the card runs (a) and (b); (c) and the costs run after them, on a
    quiet host."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp, ProcessPoolExecutor(
            ENS_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        tmp = Path(tmp)
        futures, cards = _ens_card_runs(tmp, pool)
        t1 = time.time()
        print(f"[ensembles] (a) the card's decks done in {t1 - t0:.1f} s; "
              f"their run blocks "
              f"{sum(s.run_seconds[0] for s, _ in cards.values()):.2f} s of "
              f"20 steps x {len(cards)} decks")
        _ens_heat(tmp)
        _ens_mttk_conserved()
        _ens_barostats(tmp)
        t2 = time.time()
        print(f"[ensembles] (b) done in {t2 - t1:.1f} s")
        _ens_card_vs_cpu(futures, cards)
        t3 = time.time()
        print(f"[ensembles] (a) the CPU's references compared "
              f"{t3 - t2:.1f} s after (b)")
        _ens_pbte(tmp)
        _ens_costs()
        print(f"[ensembles] (c) and the costs done in {time.time() - t3:.1f}"
              " s")
    print(f"[ensembles] phase done in {time.time() - t0:.1f} s")



def _ens_time_deck(d, line, steps, system):
    """A timing deck: LJ argon 4,000 at 60 K or NEP PbTe 32,768 at 300 K
    (a spring a species for the TI decks), `run 20` then `run steps`."""
    import shutil

    from gpumd_tpu_torch.bench import build_pbte

    if system == "lj":
        _ens_argon(d, line, steps=20, extra="")
    else:
        pos, types, lengths = build_pbte(*[ENS_PBTE_CELLS] * 3)
        _write_model(d, np.where(types == 1, "Pb", "Te"), pos,
                     np.where(types == 1, 207.2, 127.6), lengths, 600.0, 5,
                     groups=_ens_slabs(pos, lengths[0]))
        shutil.copy(MODEL, d / "nep.txt")
        line = (line.replace("temp 60 90", "temp 300 450")
                .replace("60 60", "300 300").replace("temp 60", "temp 300")
                .replace(" 60 20 15 ", " 300 20 30 ")
                .replace("spring Ar 0.5", "spring Te 0.5 Pb 0.5"))
        (d / "run.in").write_text(f"potential nep.txt\ntime_step 1\n{line}\n"
                                  "run 20\n")
    with open(d / "run.in", "a") as f:
        f.write(f"run {steps}\n")


def phase_ensembles_time(results, steps=100):
    """ms/step of each keyword's deck of `ensembles` (a) beside NVE's, on
    the list path, for LJ argon 4,000 and NEP PbTe 32,768 (not a default
    phase: the ensembles' costs that PERF.md records)."""
    t0 = time.time()
    decks = {"nve": "engine list\nensemble nve", **ENS_DECKS}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for system in ("lj", "pbte"):
            base = None
            for key, line in decks.items():
                d = tmp / system / key.replace(" ", "_")
                _ens_time_deck(d, line, steps, system)
                s = _ens_session(d, "cuda", noise=False)
                ms = 1e3 * s.run_seconds[1] / steps
                base = ms if base is None else base
                print(f"[ensembles-time] {system} {s._n} {key}: {ms:.3f} "
                      f"ms/step over {steps} steps, {ms - base:+.3f} against "
                      f"NVE; route: {s.route_reason}")
    print(f"[ensembles-time] phase done in {time.time() - t0:.1f} s")



# ---- phase 15: the path integrals and the classical potentials (the list
# path through the app, plain torch: no hand-written kernel launches) ------

# (a) each potential of the slice with its format's file from
# potentials/sets.py (the published Si sets for tersoff_1989 and sw_1985,
# synthetic sets otherwise): a small deck, PP_STEPS of NVE on the card
# (float32) against the same deck on the CPU (float64, in worker processes
# while the card works), and a 4,096-atom Si or 4,000-atom fcc deck on the
# card for PP_BIG_STEPS of NVE.  The lattices: (kind, a0 A, cells, types)
# of the small deck, (kind, a0 A, cells) of the big one (one type).
PP_DECKS = {
    "tersoff_1989": (("diamond", 5.431, 3, "one"), ("diamond", 5.431, 8)),
    "tersoff_1988": (("zincblende", 4.36, 3, "zb"), ("diamond", 5.431, 8)),
    "tersoff_mini": (("zincblende", 4.36, 3, "zb"), ("diamond", 5.431, 8)),
    "sw_1985": (("diamond", 5.431, 4, "one"), ("diamond", 5.431, 8)),
    "eam_zhou_2004": (("fcc", 3.7, 5, "random"), ("fcc", 3.615, 10)),
    "eam/alloy": (("fcc", 3.7, 5, "random"), ("fcc", 3.615, 10)),
    "adp": (("fcc", 3.7, 5, "random"), ("fcc", 3.615, 10)),
    "eam_dai_2006": (("fcc", 3.8, 5, "one"), ("fcc", 3.8, 10)),
}
PP_STEPS, PP_BIG_STEPS, PP_T = 20, 200, 300.0
# (a)'s gates: positions within POS_TOL (list-md's 1e-3 A) of the CPU's
# float64 run after PP_STEPS; its last thermo row's potential energy within
# PP_PE_TOL eV/atom (float32 sums of ~4 eV terms: ~1e-6 eV/atom); the big
# deck's KE + U within PP_DRIFT_TOL eV/atom of its first thermo row over
# PP_BIG_STEPS steps of 1 fs at 300 K (velocity Verlet's fluctuation there
# is ~1e-5 eV/atom; a force that is not the energy's gradient moves it by
# far more)
PP_PE_TOL = 1e-4
PP_DRIFT_TOL = 5e-4
# (b) Tersoff-1989 Si 4,096 under heat_lan (300 +- 50 K, four slabs along
# x: slab 0 the source, slab 2 the sink; from 600 K on the lattice, which
# equipartition halves) on the list path, PP_BIG_STEPS: the source bath
# injects more than the sink (e_src < e_snk; the sign convention of
# `ensembles` (b)) and its slab ends hotter.
# (c) pimd, PP_BEADS beads, LJ argon 4,000 at PP_PIMD_T K for
# PP_PIMD_STEPS of 2 fs, dump_beads every PP_PIMD_DUMP steps: the bead
# temperature over the last 50 steps within [0.6, 1.5] P T
# (tests/test_pimd.py's band; the beads start at P T, and 100 steps read
# 305.1 K over their last 50 on the H100).  A step re-lists every bead,
# ~0.3 s at 4,000 atoms and 8 beads: 60 steps keep the phase under 90 s.
PP_BEADS, PP_PIMD_T, PP_PIMD_STEPS, PP_PIMD_DUMP = 8, 40.0, 60, 30


def _pp_lattice(kind, a0, nc, types="one", seed=5):
    """(positions, lengths, type indices) of nc^3 cells: fcc, diamond, or
    zincblende (the +1/4 sites type 1); `types` "random" draws 0/1."""
    fcc = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    basis = fcc if kind == "fcc" else np.concatenate([fcc, fcc + 0.25])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    pos = (cells[:, None, :] + basis[None]).reshape(-1, 3) * a0
    n = len(pos)
    if types == "zb":
        t = np.tile(np.repeat([0, 1], 4), n // 8)
    elif types == "random":
        t = np.random.default_rng(seed).integers(0, 2, n)
    else:
        t = np.zeros(n, int)
    return pos, np.full(3, nc * a0), t


def _pp_deck(d, name, lattice, deck, groups=False, temperature=PP_T):
    """name's potential file as pot.txt, the lattice at `temperature` as
    model.xyz (the file's type names as symbols; with `groups` four slabs
    along x as grouping method 0), and `deck` after `potential`."""
    from gpumd_tpu_torch.elements import mass_of
    from gpumd_tpu_torch.potentials import sets

    _, text = sets.files()[name]
    head = text.split("\n", 1)[0].split()
    symbols = (head[2:2 + int(head[1])] if name not in ("adp", "eam/alloy")
               else ["Cu", "Ag"])
    pos, lengths, t = _pp_lattice(*lattice)
    sym = np.asarray(symbols)[t]
    _write_model(d, sym, pos, np.array([mass_of(x) for x in sym]), lengths,
                 temperature, 9, groups=_ens_slabs(pos, lengths[0]) if groups
                 else None)
    (d / "pot.txt").write_text(text)
    (d / "run.in").write_text(f"potential pot.txt\ntime_step 1\n{deck}")
    return len(pos)


def _pp_cpu(d):
    """(a)'s CPU reference in a worker process: d's deck in float64 on the
    CPU, in d/cpu; returns the final positions, the box and the last
    thermo row."""
    import shutil

    from gpumd_tpu_torch.app.gpumd import Session

    torch.set_num_threads(2)
    c = Path(d) / "cpu"
    c.mkdir()
    for name in ("model.xyz", "pot.txt", "run.in"):
        shutil.copy(Path(d) / name, c / name)
    s = Session(str(c), quiet=True, device="cpu", dtype=torch.float64)
    s.execute()
    return (s.state.position.numpy(), s.state.box.h.numpy(),
            np.atleast_2d(np.loadtxt(c / "thermo.out"))[-1])


def _pp_card(d, steps):
    """d's deck on the card from a reset peak: (session, ms/step of the
    run block, peak MiB)."""
    from gpumd_tpu_torch.app.gpumd import Session

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s = Session(str(d), quiet=True, device="cuda")
    s.execute()
    torch.cuda.synchronize()
    return (s, 1e3 * s.run_seconds[-1] / steps,
            torch.cuda.max_memory_allocated() / 2 ** 20)


def _pp_small(tmp, pool):
    """(a) the small decks: the CPU's references submitted first, then
    each on the card and compared."""
    from gpumd_tpu_torch.model.box import Box

    # engine list: tersoff_1989 under NVE would take the compact kernels
    deck = f"engine list\nensemble nve\ndump_thermo 10\nrun {PP_STEPS}\n"
    futures = {}
    for name, (small, _) in PP_DECKS.items():
        d = tmp / "a" / name.replace("/", "_")
        n = _pp_deck(d, name, small, deck)
        futures[name] = (d, n, pool.submit(_pp_cpu, str(d)))
    for name, (d, n, fut) in futures.items():
        s, ms, _ = _pp_card(d, PP_STEPS)
        pos, h, row = fut.result()
        box = Box.from_lattice(h.T, dtype=torch.float64, device="cpu")
        dx = float(box.minimum_image(
            s.state.position.double().cpu() - torch.as_tensor(pos)
        ).abs().max())
        got = np.atleast_2d(np.loadtxt(d / "thermo.out"))[-1]
        de = abs(got[2] - row[2]) / n
        print(f"[pimd-potentials] (a) {name} {n} atoms, MN "
              f"{s.ff.neighbor.mn}: {PP_STEPS} steps {ms:.3f} ms/step; "
              f"route: {s.route_reason}; max |dx| against the CPU's "
              f"float64 run {dx:.3e} A (bound {POS_TOL}), |dPE| "
              f"{de:.3e} eV/atom (bound {PP_PE_TOL})")
        if not (dx <= POS_TOL and de <= PP_PE_TOL and s.md is None):
            raise RuntimeError(f"(a) {name}: departs from the CPU's run")


def _pp_big(tmp):
    """(a) the big decks on the card: KE + U over PP_BIG_STEPS, ms/step
    and the peak."""
    deck = (f"engine list\nensemble nve\ndump_thermo 10\n"
            f"run {PP_BIG_STEPS}\n")
    for name, (_, big) in PP_DECKS.items():
        d = tmp / "big" / name.replace("/", "_")
        n = _pp_deck(d, name, (*big, "one"), deck)
        s, ms, peak = _pp_card(d, PP_BIG_STEPS)
        rows = np.atleast_2d(np.loadtxt(d / "thermo.out"))
        e = rows[:, 1] + rows[:, 2]
        drift = float(np.abs(e - e[0]).max()) / n
        print(f"[pimd-potentials] (e) {name} {n} atoms, MN "
              f"{s.ff.neighbor.mn}: {ms:.3f} ms/step over {PP_BIG_STEPS} "
              f"NVE steps, peak {peak:.0f} MiB; (a) KE + U within "
              f"{drift:.3e} eV/atom of step 10's (bound {PP_DRIFT_TOL}), "
              f"T {rows[-1, 0]:.1f} K")
        if not (rows.shape == (PP_BIG_STEPS // 10, 18)
                and np.isfinite(rows).all() and drift <= PP_DRIFT_TOL):
            raise RuntimeError(f"(a) {name}: KE + U moved or went "
                               f"non-finite")


def _pp_heat(tmp):
    """(b) Tersoff-1989 under heat_lan on the list path."""
    d = tmp / "b"
    n = _pp_deck(d, "tersoff_1989", ("diamond", 5.431, 8),
                 f"ensemble heat_lan 300 100 50 0 2\ncompute 0 10 "
                 f"{PP_BIG_STEPS // 2} temperature\nrun {PP_BIG_STEPS}\n",
                 groups=True, temperature=2 * PP_T)
    s, ms, peak = _pp_card(d, PP_BIG_STEPS)
    row = np.atleast_2d(np.loadtxt(d / "compute.out"))[-1]
    t, e_src, e_snk = row[:4], row[4], row[5]
    print(f"[pimd-potentials] (b) tersoff_1989 {n} heat_lan: {ms:.3f} "
          f"ms/step, peak {peak:.0f} MiB; route: {s.route_reason}; slab T "
          f"{np.round(t, 1).tolist()} K; baths {e_src:.4e} / {e_snk:.4e} eV")
    if not (s.route_reason == "ensemble HeatLangevin" and s.md is None
            and np.isfinite(row).all() and e_src < e_snk and t[0] > t[2]):
        raise RuntimeError("(b) heat_lan on Tersoff: not on the list path, "
                           "or the source does not heat more than the sink")


def _pp_pimd(tmp):
    """(c) pimd on LJ argon 4,000 with dump_beads."""
    d = tmp / "c"
    n = _ens_argon(d, f"ensemble pimd {PP_BEADS} {PP_PIMD_T} {PP_PIMD_T} "
                   f"100\ndump_beads {PP_PIMD_DUMP} 0 0",
                   steps=PP_PIMD_STEPS, temperature=PP_PIMD_T)
    s, ms, peak = _pp_card(d, PP_PIMD_STEPS)
    tb = s._pimd_obs["t_beads"]
    mean = float(tb[-50:].mean())
    lo, hi = 0.6 * PP_BEADS * PP_PIMD_T, 1.5 * PP_BEADS * PP_PIMD_T
    frames = PP_PIMD_STEPS // PP_PIMD_DUMP
    lines = [len((d / f"beads_dump_{k}.xyz").read_text().splitlines())
             for k in range(PP_BEADS)]
    print(f"[pimd-potentials] (c) pimd {PP_BEADS} beads, LJ {n}: {ms:.3f} "
          f"ms/step over {PP_PIMD_STEPS} steps, peak {peak:.0f} MiB; route: "
          f"{s.route_reason}; bead T over the last 50 steps {mean:.1f} K "
          f"(band [{lo:.0f}, {hi:.0f}]); beads_dump lines {set(lines)}")
    if not (lo <= mean <= hi and np.isfinite(tb).all()
            and lines == [frames * (n + 2)] * PP_BEADS
            and s.route_reason == "path integrals"):
        raise RuntimeError("(c) pimd: bead temperature out of its band or "
                           "beads_dump_<k>.xyz malformed")


def phase_pimd_potentials(results):
    """The path integrals and the classical potentials (phase 15 of the
    module docstring): (a) each potential card against CPU and its big
    deck's KE + U, (b) Tersoff under heat_lan, (c) pimd, (d) no launch of
    a hand-written kernel anywhere in the phase, (e) ms/step and peaks."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from gpumd_tpu_torch.engine import cuda_build

    t0 = time.time()
    cuda_build.reset_launches()
    with tempfile.TemporaryDirectory() as tmp, ProcessPoolExecutor(
            ENS_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        tmp = Path(tmp)
        _pp_small(tmp, pool)
        t1 = time.time()
        print(f"[pimd-potentials] (a) small decks done in {t1 - t0:.1f} s")
        _pp_big(tmp)
        _pp_heat(tmp)
        _pp_pimd(tmp)
    torch.cuda.synchronize()
    counts = dict(cuda_build.launches)
    _launch_check("pimd-potentials (d)", counts, {}, never=tuple(counts))
    print(f"[pimd-potentials] phase done in {time.time() - t0:.1f} s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,md,npt-md,hnemd-md,"
                    "drift,list-md,train,time,dense-kernels,dense-md,"
                    "dense-time,"
                    "tersoff-kernels,tersoff-md,tersoff-time,probes,app,"
                    "measure,ensembles,pimd-potentials")
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit: the probes "
                    "phase then times its blocked gather and its wrappers' "
                    "host time beside this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's smoke test needs one")
    from gpumd_tpu_torch.engine.nep_compact import pin_fp32_matmul
    from gpumd_tpu_torch.potentials.tersoff import SI_TERSOFF

    pin_fp32_matmul()
    phases = args.phases.split(",")
    results = {}
    t0 = time.time()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        pot_path = str(Path(tmp) / "Si_Tersoff_1989.txt")
        Path(pot_path).write_text(SI_TERSOFF)
        for name, fn in (
                ("kernels", phase_kernels), ("md", phase_md),
                ("npt-md", phase_npt_md),
                ("hnemd-md", lambda r: phase_hnemd_md(r, pot_path)),
                ("drift", phase_drift), ("list-md", phase_list_md),
                ("train", phase_train),
                ("time", phase_time),
                ("dense-kernels", phase_dense_kernels),
                ("dense-md", phase_dense_md),
                ("dense-time", phase_dense_time),
                ("tersoff-kernels",
                 lambda r: phase_tersoff_kernels(r, pot_path)),
                ("tersoff-md", lambda r: phase_tersoff_md(r, pot_path)),
                ("tersoff-time", lambda r: phase_tersoff_time(r, pot_path)),
                ("probes", lambda r: phase_probes(r, args.parent)),
                ("app", lambda r: phase_app(r, pot_path)),
                ("measure", phase_measure),
                ("ensembles", phase_ensembles),
                ("pimd-potentials", phase_pimd_potentials),
                ("ensembles-time", phase_ensembles_time),
                ("app-spread", lambda r: phase_app_spread(r, pot_path))):
            if name in phases:
                fn(results)
                print(f"[{name}] done at {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k], **results.get(k, {})}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
