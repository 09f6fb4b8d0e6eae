#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:  python3 chip_smoke.py

Phases, one line or more each; any failure raises and exits non-zero:
  1. build   compile every CUDA source under src/repro_torch/kernels/csrc
             (five, one nvcc per source, all at once) into build/;
  2. kernels each kernel against its plain PyTorch version on the card, at
             the main path's shapes: color_step in f32 and f64 with a dead
             row and dropped messages, and at D = 40 (lanes beyond a warp)
             in f64 and in f32 against an f64 witness, one color at a time;
             then whole 30-sweep color_sweep calls (one launch each, a
             (30, R, D) delivery mask with 30% drops and a dead row) in f64,
             in f32 (both with at least 2 CTAs per field's cluster) and in
             f64 at D = 40, against the plain per-color loop; knn_fuse in f32,
             f64 and with bf16 anchors (identical selected sets), also on a
             tie-heavy lattice (queries at lattice points and cell
             midpoints, k = 3 and 5); kernel_matvec on the conn route's
             inputs, with every anchor's coefficient non-zero and one field
             all zero (output exactly 0), at a ragged Q, at d = 1 and d = 8,
             for one field with shared anchors, and twice (bitwise equal);
             ssd_intra at the mamba2-370m prefill's shape (B=4, S=512,
             H=32, P=64, N=128, chunk 256), through the chunked scan at
             S=300 (padded to a chunk multiple), and at a ragged shape (P,
             N and chunk off the tensor-core tiles), rbf_gram of the conn query line against the
             main path's 8400-anchor table; then each kernel's time, its
             plain version's time, one PyTorch library call's time where
             there is one, and the least time the card could take
             (``bound_ms``, the largest of the bytes, the operations and the
             exps on the special-function units): color_step per 30-sweep
             call (its one launch) and per color step, ssd_intra against the
             tensor cores' TF32 rate with the float32-FMA bound beside it,
             kernel_matvec also at B = 1 and with every anchor non-zero;
  2b. audit  ``repro_torch.analysis`` on the card: the launch ledger held
             to this script's LEDGER_UNITS; a control (knn_fuse without a
             plan: exactly one host-sync finding, in make_serving_plan);
             then every function of the sync-free registry under
             torch.cuda.set_sync_debug_mode("error") (host-sync), the
             liveness rules through the cuda engines (alive-dead,
             alive-scatter) and the launch ledger's self-check with its grid
             check (a fault-rate, tau and beta grid: each call the ledger's
             launches, no library build); one "audit:" line per auditor, and
             no new finding nor stale baseline entry among what ran;
  3. main    the port's launcher at the benched geometry (n=1000 sensors in
             d=2, radius 0.3*sqrt(100/n), rbf gamma=1, lambda=0.1, B=16
             fields, 30 colored sweeps with the CUDA color step, kNN k=3 and
             conn serving of Q=4096 queries), with every launch counter set
             to 0 before and read after: exactly one launch per call, so
             color_step 2 (colored_sweep's warm-up and timed call), knn_fuse
             2 and kernel_matvec 2 (each request's); then the same pipeline
             through the plain engines on the card, compared end to end;
  3b. main-stream the port's launcher with --stream 2048 --on_full evict
             --refresh_sweeps 5 at the same geometry (D = max degree + 7),
             launch counters set to 0 before and read after: color_step =
             the train calls + 1 refresh, knn_fuse 2, kernel_matvec 2; its
             factors against rebuild_chol (1e-4), then the same pipeline on
             the plain engines (identical receipts and streamed tables, z
             2e-4, coef 2e-2, kNN 2e-4) and its conn inputs through
             kernel_matvec against the plain version or a float64 witness;
             then dense arrival waves on the same geometry with beta 1.0 /
             0.9 alternating over the fields: one partial wave under drop,
             10 under evict (16,000 arrivals each, so the windows wrap),
             two of them held row by row to sequential absorbs (bitwise,
             the factors 1e-5), the factors to rebuild_chol (5e-5), and
             color_sweep (5 sweeps), knn_fuse and kernel_matvec to their
             plain versions on the streamed state; with the times of
             absorb_many, absorb_wave, rebuild_chol, the refresh, the
             requests and kernel_matvec on the streamed anchors;
  3c. main-churn the port's launcher with --stream 2048 --on_full evict
             --churn 16 --spares 8 (D = max degree + 9, 40 color classes),
             launch counters set to 0 before and read after: color_step =
             the train calls + the stream refresh + the churn refreshes (one
             per round, two when a sensor leaves), knn_fuse = one per round +
             2, kernel_matvec 2; its counts against the reference's
             (REFERENCE_CHURN), then the same trace on the plain engines
             (integer tables and counts equal, z 2e-4, coef 2e-2, kNN 2e-4)
             and knn_fuse and kernel_matvec on the churned plan and state;
             then, on the geometry's arrival-free problem, a join -> leave
             round trip (every table and the state restored bitwise), the
             events' times and kernel counts, and robust_sweep: all alive
             against colored_sweep, and a 5-sweep transient death trace (5
             color_sweep launches, dead rows untouched, z 2e-4 and coef 2e-2
             from the plan engine) with its refactor and launch times;
  3d. main-faults the port's launcher with --refresh_sweeps 5 and --faults,
             once with bursty links (drop=0.1,burst=0.05:0.4:0.5) and once
             with crashes (drop=0.1,crash=0.01:0.25), launch counters set to
             0 before and read after: color_step once per watchdog round
             (crash-free: one launch of 5 sweeps with a fresh 3-D delivery
             mask) or once per sweep (crashes, through robust_sweep),
             knn_fuse 2, kernel_matvec 2; the seeded rounds replayed
             bitwise, clear of the watchdog's divergence ratio; the same run
             on the plain engines with a generator of the same seed (receipt
             integers equal, z 2e-4, coef 2e-2, kNN 2e-4, conn 2e-5); then,
             on the launcher's trained problem: drop=0 bitwise colored_sweep,
             drop=1 z frozen bitwise, no library build and one launch per
             call over a rate grid; the sampler's statistics over (30, n+1,
             D) lanes; the NaN ladder rolled back bitwise in memory and on
             disk; save_train/restore_train bitwise with their times; the
             reference's acceptance (kNN-fused RMSE at 10% drops within 2x
             of fault-free); the single-field serial engines on field 0; and
             a round's time split;
  3e. main-daemon the serving daemon (``repro_torch.launch.daemon.Daemon``)
             at the churned geometry (n = 1000 + 8 spares, B = 16, D = 24,
             k = 3, the query plan of the churn launcher), trained 30 sweeps
             first, with energy_tau at the 0.1 quantile of the live energies,
             under the reference daemon bench's traffic: per tick 4 requests
             of 1-256 rows and 1-32 arrivals, a join or a leave every 4th
             tick, 16 clean ticks, 8 under 10% drops, 4 clean, a checkpoint
             every 4 ticks; launch counters set to 0 before the 28 ticks and
             read after: knn_fuse once per dispatch, color_step once per
             watchdog round, no library built; each published snapshot's
             sha256 unchanged through the next tick, also across a forced
             rollback (a NaN-poisoned working state); on the final snapshot
             knn_fuse against knn_fuse_ref and the plain engine (the same
             picks, 1e-5 or the f64 witness), the compacted plan (1e-6) and
             answer_bound on a 4096-point grid; the first 8 ticks, and the
             fault episode's first 4 from the measured daemon's working
             pair and fault generator, replayed with plan engines (receipt
             integers equal, answers 2e-4); a warm restart from the last
             checkpoint (digest and probe answers bitwise); the CLI killed
             with SIGKILL after two checkpoints and restarted with
             --verify-restart; then the launcher of phase 3 with
             --energy_tau (knn_fuse on the compacted plan, held to
             knn_fuse_ref on the request's inputs);
  3f. main-sharded the multi-device layer over an NCCL group of one (a
             FileStore in a temporary directory) at the benched geometry,
             launch counters set to 0 before and read after: field-sharded
             sharded_sweep with the cuda engine (one color_sweep launch per
             call, color_step 2), once without and once with a 10% drop mask,
             each bitwise colored_sweep(engine="cuda"); the sensor regime on
             field_view(prob, 0) against the plan engine (z 2e-4, coef 2e-2;
             f64 1e-10); the sharded call's ms beside colored_sweep's, in
             turns, and the all-gathers' ms; then allreduce_average,
             gossip_round and neighborhood_average on mamba2-370m's full-width
             parameters, each a bitwise identity at a world of one, with
             consensus_sq 0 and their ms;
  3g. main-train mamba2-370m at full width (48 layers, d_model 1024, bf16,
             random weights from seed 0) trained with the launcher's build
             (AdamW on its cosine schedule, lr 3e-4) at batch 8 x 128 in both
             dp_modes over the group of one: a warm-up step, then 20 timed
             steps, launch counters set to 0 before and read after (no kernel:
             ssd_fused stays off, as in the reference's launcher); s/step,
             tokens/s, the loss per step (finite, and the last below the
             first) and peak memory; after the first step five leaves' AdamW
             updates against a float64 recomputation of the reference's
             formula from the gradients the step used and the moments before
             it (moments 1e-5 relative, parameters one bf16 ulp plus 1e-6 of
             |p| + |u|, the float32 formula's rounding where p + u cancels); then
             ``python -m repro_torch.launch.train --arch mamba2-370m
             --variant full --steps 3`` in a subprocess, which must print
             ``done``;
  4. main-lm the port's launcher in LM mode: mamba2-370m at full width in
             its own bf16, random weights from seed 0, a 4 x 512 prompt
             and 32 greedy tokens, with every launch counter set to 0
             before and read after (ssd_intra must run once per layer per
             prefill); then the same prompt through the full-width model in
             float32 with the kernel and with the plain ssd_chunked, on the
             same weights, compared on the prefill's logits, every layer's
             final SSM state and 4 teacher-forced decode steps, with an
             f64 run of the plain route as the witness;
  5. report  the kernels JSON line (``launches``: the sum over the field,
             stream, churn, faults, daemon, prune, sharded, train and LM
             paths' runs, each
             path's count beside it), the card's name and power limit, and the final
             {"ok": true, ...} line.

Tolerances are the reference's own.  Per color step, on identical inputs:
color_step z 1e-5 and coef 1e-3 in f32 (tests/test_scatter_plan.py),
1e-10 in f64 (at D = 40 in f32, where the rounding of either version
exceeds 1e-5, both are held to an f64 evaluation of the same inputs and
the kernel's error may be at most WITNESS_FACTOR times the plain
version's).  Per 30-sweep color_sweep call: z 2e-4 and coef 2e-2 in f32
(the reference's bound for two reduction orders, tests/test_scatter_plan.py),
1e-10 in f64.  knn_fuse 1e-5 (tests/test_serving.py), 1e-10 in f64;
kernel_matvec and rbf_gram 2e-5 absolute and relative, ssd_intra 3e-4
(tests/test_kernels_pallas.py); where unit coefficients on thousands of
anchors make the float32 rounding of either summation order exceed 2e-5,
kernel_matvec is held to a float64 evaluation instead, its error at most
WITNESS_FACTOR times the plain version's.
End to end, after 30 sweeps in which kernel and plan engine sum in
different orders, the two realizations drift apart by f32 rounding (the
same 30 sweeps in f64 must agree within 1e-10, which shows the math is
the same); the f32 drift is bounded as the reference bounds its own two
realizations of one sweep with different reduction orders
(tests/test_scatter_plan.py, sharded transport: z 2e-4, coef 2e-2), kNN
answers at the z bound, conn answers at 2e-5.  The LM path's kernel and
plain routes are held to the reference's fused-on/off bound of 2e-3
absolute and relative (tests/test_kernels_pallas.py); should they differ by
more, each is held to the f64 witness and the kernel route's error may be
at most LM_WITNESS_FACTOR times the plain route's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM3 bytes/s,
# float32 and float64 FLOP/s outside the tensor cores, TF32 on them.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "tf32": 495e12}
# Exps per second on the special-function units: 16 results per SM per clock
# for exp2 at compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput table) x 132 SMs x the 1.98 GHz boost clock.
PEAK_EXPS = 16 * 132 * 1.98e9


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call of ``fn``, replayed from a CUDA graph.

    Capturing the launches removes the Python wrapper's host time, so this
    is the kernels' own time on the card (``cuda_ms`` of the wrapper call
    is reported beside it as ``call_ms``).
    """
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def bound(nbytes: float, flops: float, dtype: str, exps: float = 0.0) -> tuple[float, str]:
    """(ms, "bytes" | "operations" | "exp"): the largest of the floors set by
    the bytes, the operations and the exps on the special-function units."""
    floors = {"bytes": nbytes / PEAK_BYTES * 1e3, "operations": flops / PEAK_FLOPS[dtype] * 1e3,
              "exp": exps / PEAK_EXPS * 1e3}
    by = max(floors, key=floors.get)
    return floors[by], by


def main_args():
    from repro_torch.launch import serve

    n = 1000
    argv = ["--mode", "field", "--device", "cuda", "--fields", "16", "--sensors", str(n),
            "--dim", "2", "--radius", repr(0.3 * (100.0 / n) ** 0.5), "--gamma", "1.0",
            "--lam", "0.1", "--sweeps", "30", "--queries", "4096", "--fusion", "knn", "conn",
            "--k", "3", "--engine", "cuda", "--seed", "0"]
    return argv, serve.parser().parse_args(argv)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version, then timed.
# ---------------------------------------------------------------------------


def gated_inputs(torch, prob):
    """A trained state, a dead row and 30% of messages dropped."""
    from repro_torch.core import colored_sweep, init_state

    st = colored_sweep(prob, init_state(prob), n_sweeps=2, engine="plan")
    alive = prob.alive.clone()
    alive[7] = False  # a dead row
    rng = np.random.default_rng(1)
    deliv = torch.as_tensor(rng.uniform(size=tuple(prob.nbr_idx.shape)) >= 0.3,
                            device=prob.device)  # 30% of messages dropped
    return st.z.clone(), st.coef.clone(), alive, alive[prob.layout.slot_owner], deliv


def check_color_step(torch, prob, label: str):
    """Every color of one sweep, kernel vs plain on identical inputs."""
    from repro_torch.kernels import color_step as cs

    z, coef, alive, alive_z, deliv = gated_inputs(torch, prob)
    err_z = err_c = 0.0
    for c in range(prob.color_members.shape[0]):
        args = (prob.nbr_idx, prob.nbr_mask, prob.gram, prob.chol, prob.lam_pad, alive,
                alive_z, prob.color_members[c], prob.color_mask[c], deliv)
        zk, ck = z.clone(), coef.clone()
        cs.color_step(zk, ck, *args)
        cs.color_step_ref(z, coef, *args)
        torch.cuda.synchronize()
        err_z, err_c = max(err_z, max_err(zk, z)), max(err_c, max_err(ck, coef))
    tol_z, tol_c = (1e-5, 1e-3) if prob.gram.dtype == torch.float32 else (1e-10, 1e-10)
    check(err_z <= tol_z and err_c <= tol_c,
          f"color_step {label}: z err {err_z:.3g} (tol {tol_z}), coef err {err_c:.3g}")
    check(float(z[:, -1].abs().max()) == 0.0, "color_step wrote the sentinel slot")
    print(f"kernels: color_step {label} ok: B={prob.batch_size} D={prob.nbr_idx.shape[1]} "
          f"{prob.color_members.shape[0]} colors, dead row + 30% drops, "
          f"max |dz| {err_z:.3g}, max |dcoef| {err_c:.3g}")
    return err_z


# The f32 kernel's error against an f64 evaluation of the same inputs may be
# at most this multiple of the f32 plain version's own error against it.
WITNESS_FACTOR = 4.0


def check_color_step_witness(torch, prob, label: str) -> None:
    """f32 kernel and f32 plain version, both against an f64 witness.

    Where the local systems are dense and badly conditioned, the f32
    rounding of any realization exceeds the per-step 1e-5, so the two f32
    versions are not held to each other: each is held to the plain version
    evaluated in f64 on the same (f32) inputs, and the kernel's error may be
    at most WITNESS_FACTOR times the plain version's.
    """
    from repro_torch.kernels import color_step as cs

    z, coef, alive, alive_z, deliv = gated_inputs(torch, prob)
    gram64, chol64, lam64 = prob.gram.double(), prob.chol.double(), prob.lam_pad.double()
    ek = {"z": 0.0, "coef": 0.0}
    ep = {"z": 0.0, "coef": 0.0}
    for c in range(prob.color_members.shape[0]):
        gates = (alive, alive_z, prob.color_members[c], prob.color_mask[c], deliv)
        zk, ck = z.clone(), coef.clone()
        z64, coef64 = z.double(), coef.double()
        cs.color_step(zk, ck, prob.nbr_idx, prob.nbr_mask, prob.gram, prob.chol,
                      prob.lam_pad, *gates)
        cs.color_step_ref(z64, coef64, prob.nbr_idx, prob.nbr_mask, gram64, chol64, lam64,
                          *gates)
        cs.color_step_ref(z, coef, prob.nbr_idx, prob.nbr_mask, prob.gram, prob.chol,
                          prob.lam_pad, *gates)
        torch.cuda.synchronize()
        for key, kern, plain, wit in (("z", zk, z, z64), ("coef", ck, coef, coef64)):
            ek[key] = max(ek[key], max_err(kern, wit))
            ep[key] = max(ep[key], max_err(plain, wit))
    ratio = {key: ek[key] / ep[key] if ep[key] > 0 else float(ek[key] > 0) for key in ek}
    readings = ", ".join(f"{key}: kernel {ek[key]:.3g}, plain {ep[key]:.3g}, "
                         f"ratio {ratio[key]:.3g}" for key in ek)
    check(all(ek[key] <= WITNESS_FACTOR * ep[key] for key in ek),
          f"color_step {label}: error against the f64 witness beyond "
          f"{WITNESS_FACTOR} x the plain version's ({readings})")
    print(f"kernels: color_step {label} ok: D={prob.nbr_idx.shape[1]}, dead row + 30% drops, "
          f"max error against the f64 witness (tol {WITNESS_FACTOR} x plain) {readings}")


SWEEP_TOL = {"float32": (2e-4, 2e-2), "float64": (1e-10, 1e-10)}  # (z, coef)


def check_color_sweep(torch, prob, label: str, sweeps: int, min_cluster: int = 1) -> float:
    """A whole ``sweeps``-sweep color_sweep call (one launch) against the plain
    per-color loop on identical inputs, with a dead row and 30% of the
    messages dropped in every sweep; the same call on gram and factor
    tables that are misaligned views; and one color over 7 sweeps (each
    member's next item is itself).  f64 is held to 1e-10; f32 to the
    reference's bound for two reduction orders over many steps (z 2e-4,
    coef 2e-2, tests/test_scatter_plan.py)."""
    from repro_torch.kernels import color_step as cs

    z, coef, alive, alive_z, _ = gated_inputs(torch, prob)
    rng = np.random.default_rng(9)
    delivered = torch.as_tensor(
        rng.uniform(size=(sweeps,) + tuple(prob.nbr_idx.shape)) >= 0.3, device=prob.device)
    c, m = prob.color_members.shape
    d = prob.nbr_idx.shape[1]
    plan = cs.launch_plan(prob.gram.element_size(), d, m)
    args = (prob.nbr_idx, prob.nbr_mask, prob.gram, prob.chol, prob.lam_pad, alive, alive_z,
            prob.color_members, prob.color_mask, delivered, sweeps)
    tol_z, tol_c = SWEEP_TOL[str(prob.gram.dtype).split(".")[1]]
    # the tables as views that start one element into their storage: the
    # kernel stages each member's blocks by 16-byte-aligned spans
    gram_v = prob.gram.new_empty(prob.gram.numel() + 1)[1:].view_as(prob.gram)
    chol_v = prob.chol.new_empty(prob.chol.numel() + 3)[3:].view_as(prob.chol)
    gram_v.copy_(prob.gram)
    chol_v.copy_(prob.chol)
    # one color over several sweeps: each member follows itself
    n_one = min(7, sweeps)
    one = (prob.nbr_idx, prob.nbr_mask, prob.gram, prob.chol, prob.lam_pad, alive, alive_z,
           prob.color_members[:1], prob.color_mask[:1], delivered[:n_one], n_one)
    runs = {}
    for name, kernel_args, plain_args in (
            ("sweeps", args, args), ("views", args[:2] + (gram_v, chol_v) + args[4:], None),
            ("one color", one, one)):
        zk, ck = z.clone(), coef.clone()
        cs.color_sweep(zk, ck, *kernel_args)
        if plain_args is not None:
            zp, cp = z.clone(), coef.clone()
            cs.color_sweep_ref(zp, cp, *plain_args)
            runs[name + " plain"] = (zp, cp)
        runs[name] = (zk, ck)
    torch.cuda.synchronize()
    errs = {}
    for name, plain in (("sweeps", "sweeps plain"), ("views", "sweeps plain"),
                        ("one color", "one color plain")):
        errs[name] = (max_err(runs[name][0], runs[plain][0]),
                      max_err(runs[name][1], runs[plain][1]))
        check(errs[name][0] <= tol_z and errs[name][1] <= tol_c,
              f"color_sweep {label} ({name}): z err {errs[name][0]:.3g} (tol {tol_z}), "
              f"coef err {errs[name][1]:.3g} (tol {tol_c})")
        check(float(runs[name][0][:, -1].abs().max()) == 0.0,
              f"color_sweep {label} ({name}) wrote the sentinel slot")
    err_z, err_c = errs["sweeps"]
    check(plan.cluster >= min_cluster,
          f"color_sweep {label}: {plan.cluster} CTAs per field, expected >= {min_cluster}")
    print(f"kernels: color_sweep {label} ok: {sweeps} sweeps x {c} colors in one launch, "
          f"B={prob.batch_size} D={d} M={m}; plan: one cluster of {plan.cluster} CTAs per "
          f"field, {plan.warps} warps x {plan.per_warp} members each, {plan.smem_bytes} B "
          f"shared memory; dead row + 30% drops per sweep, max |dz| {err_z:.3g} (tol {tol_z}), "
          f"max |dcoef| {err_c:.3g} (tol {tol_c}), sentinel 0; misaligned table views max "
          f"|dz| {errs['views'][0]:.3g}; one color x {n_one} sweeps max |dz| "
          f"{errs['one color'][0]:.3g}")
    return err_z


def check_sweep_f64(torch, prob, sweeps: int) -> float:
    """The main path's whole training in f64, kernel engine vs plan engine.

    In f64 the two summation orders agree to ~1e-13, so the f32 drift the
    end-to-end check allows is rounding, not a difference in the math.
    """
    from repro_torch.core import colored_sweep, init_state

    st0 = init_state(prob)
    a = colored_sweep(prob, st0, n_sweeps=sweeps, engine="cuda")
    b = colored_sweep(prob, st0, n_sweeps=sweeps, engine="plan")
    err_z, err_c = max_err(a.z, b.z), max_err(a.coef, b.coef)
    check(err_z <= 1e-10 and err_c <= 1e-10,
          f"f64 sweep: kernel vs plan max |dz| {err_z:.3g}, |dcoef| {err_c:.3g} (tol 1e-10)")
    print(f"kernels: colored_sweep float64, {sweeps} sweeps, cuda vs plan engine ok: "
          f"max |dz| {err_z:.3g}, max |dcoef| {err_c:.3g}")
    return err_z


def wide_problem(torch, dtype):
    """Neighborhoods wider than a warp: up to 36 neighbors in D = 40 lanes."""
    from repro_torch.core import Kernel, build_topology, make_batch_problem, uniform_sensors

    pos = uniform_sensors(300, d=2, seed=5)
    topo = build_topology(pos, 0.33, d_max=40, device="cuda")
    ys = np.sin(np.pi * pos[None, :, 0]) + np.random.default_rng(6).normal(size=(2, 300))
    prob = make_batch_problem(topo, Kernel("rbf", gamma=1.0), ys, np.full(300, 0.1),
                              dtype=dtype, device="cuda")
    max_deg = int(prob.topology.degrees.max())
    check(prob.nbr_idx.shape[1] == 40 > max_deg > 32, f"wide problem: max degree {max_deg}")
    return prob


def color_step_work(torch, prob, alive, alive_z):
    """Per color, what one color step needs at the least, from each live
    (field, member)'s real lanes g (its nbr_mask) and the s of them that send
    (target slot alive): (constant bytes, z/coef bytes, operations).

    Constant bytes: the lower triangle of its factor restricted to those
    lanes, g(g+1)/2, and the gram rows of the sending lanes, s*g; per member
    its g slot ids and their liveness bytes, its id, two liveness bytes and
    lambda; the mask bytes of its g lanes.  z/coef bytes: z and coef read on
    the s lanes, coef written on g, z written on s.  Padded lanes are left
    out: their factor is the identity, their coefficient stays 0, and what
    they send is 0 into a slot that holds 0.  Operations per (field, member):
    two triangular solves 2 g^2, the rhs 2 s, the evaluation 2 s g.
    """
    e = prob.gram.element_size()
    live = prob.color_mask & alive[prob.color_members]  # (C, M)
    idx = prob.nbr_idx[prob.color_members]  # (C, M, D)
    real = prob.nbr_mask[:, prob.color_members] & live[None, :, :, None]  # (B, C, M, D)
    send = real & alive_z[idx][None]
    g = real.sum(-1).double()  # (B, C, M)
    s = send.sum(-1).double()
    g_member = real.any(0).sum(-1).double()  # (C, M) lanes of a member in any field
    const = (e * (g * (g + 1) / 2 + s * g) + g).sum(dim=(0, 2)) + (
        live.double() * (4 + 1 + 1 + e) + g_member * (4 + 1)).sum(-1)
    state = (e * (2 * s + g + s)).sum(dim=(0, 2))
    flops = (2 * g * g + 2 * s + 2 * s * g).sum(dim=(0, 2))
    return const, state, flops


def color_step_bound(torch, prob, alive, alive_z) -> tuple[float, str]:
    """Mean over the colors of one sweep of the least time one color step
    needs on its own (every byte of ``color_step_work`` read per step)."""
    const, state, flops = color_step_work(torch, prob, alive, alive_z)
    dt = str(prob.gram.dtype).split(".")[1]
    t_bytes, t_ops = (const + state) / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dt] * 1e3
    by = "bytes" if float(t_bytes.sum()) >= float(t_ops.sum()) else "operations"
    return float(torch.maximum(t_bytes, t_ops).mean()), by


def color_sweep_bound(torch, prob, alive, alive_z, sweeps: int) -> tuple[float, str]:
    """The least time one ``sweeps``-sweep call needs: the constant bytes
    (factors, grams, tables) once per call, z and coef read and written
    once on the lanes the members touch, and every step's operations."""
    const, state, flops = color_step_work(torch, prob, alive, alive_z)
    dt = str(prob.gram.dtype).split(".")[1]
    nbytes = float(const.sum() + state.sum())  # one sweep touches each lane once
    return bound(nbytes, sweeps * float(flops.sum()), dt)


def time_color_step(torch, prob, sweeps: int) -> dict:
    """One ``sweeps``-sweep call: device ms (graph replay of its one launch),
    call ms (CUDA events around the wrapper), the plain per-color loop, and
    the same per color step (``sweeps`` x n_colors dependent steps)."""
    from repro_torch.core import colored_sweep, init_state
    from repro_torch.kernels import color_step as cs

    st = colored_sweep(prob, init_state(prob), n_sweeps=2, engine="plan")
    alive, alive_z = prob.alive, prob.alive_z
    steps = sweeps * prob.color_members.shape[0]
    z, coef = st.z.clone(), st.coef.clone()

    def call(fn):
        return lambda: fn(z, coef, prob.nbr_idx, prob.nbr_mask, prob.gram, prob.chol,
                          prob.lam_pad, alive, alive_z, prob.color_members, prob.color_mask,
                          None, sweeps)

    ms = graph_ms(call(cs.color_sweep), reps=10)
    call_ms = cuda_ms(call(cs.color_sweep), reps=10)
    plain_ms = cuda_ms(call(cs.color_sweep_ref), reps=2, warmup=1)
    t_bound, by = color_sweep_bound(torch, prob, alive, alive_z, sweeps)
    step_bound, step_by = color_step_bound(torch, prob, alive, alive_z)
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                library_ms=None, sweeps=sweeps, dependent_steps=steps,
                per_step=dict(ms=ms / steps, call_ms=call_ms / steps, plain_ms=plain_ms / steps,
                              bound_ms=step_bound, bound_by=step_by))


def knn_inputs(torch, prob, state, q: int, seed: int, k: int = 3, xq=None, plan=None):
    """knn_fuse's inputs for ``q`` uniform queries over the base sensors' box
    (or the given ``xq``) on ``plan`` (default: one built now), with sensor 11
    dead; returns (inputs, alive, plan)."""
    from repro_torch.core import make_serving_plan, serving, effective_coef

    if plan is None:
        plan = make_serving_plan(prob, k=k)
    if xq is None:
        rng = np.random.default_rng(seed)
        pos = prob.topology.positions[: prob.n_base].cpu().numpy()
        xq = torch.as_tensor(rng.uniform(pos.min(0), pos.max(0), size=(q, pos.shape[1])),
                             dtype=prob.nbr_pos.dtype, device=prob.device)
    positions = prob.topology.positions.to(xq.dtype)
    spos = torch.cat([positions, positions.new_zeros((1, xq.shape[1]))])
    alive = prob.alive.clone()
    alive[11] = False  # a dead sensor drops out of selection
    return (xq, serving.query_cells(plan, xq), plan.cells, plan.cell_mask, spos,
            prob.nbr_pos, prob.nbr_mask, effective_coef(prob, state)), alive, plan


def knn_f64(torch, ins, sel, gamma: float):
    """knn_fuse's evaluation in float64 on the selections ``sel`` (Q, k)."""
    xq, _, _, _, _, nbr_pos, nbr_mask, coef = ins
    valid = sel >= 0
    s = torch.clamp(sel, min=0).long()
    d2 = ((xq.double()[None, :, None, None, :] - nbr_pos[:, s].double()) ** 2).sum(-1)
    f = (torch.exp(-gamma * d2) * torch.where(nbr_mask[:, s], coef[:, s].double(), 0.0)).sum(-1)
    return torch.where(valid[None], f, 0.0).sum(-1) / valid.sum(-1).clamp(min=1)


def knn_agree(torch, out, ref, ins, sel, gamma: float, label: str,
              witness: bool = False) -> float:
    """``out`` (the kernel's) against ``ref`` (a plain version's) on the same
    picks ``sel``: within 1e-5 (f32) or 1e-10 (f64); returns max |err|.
    With ``witness``, where the two f32 summation orders differ by more, the
    kernel's error against a float64 evaluation of the picks may be at most
    WITNESS_FACTOR times the plain version's."""
    err = max_err(out, ref)
    tol = 1e-5 if out.dtype == torch.float32 else 1e-10
    ok = err <= tol
    if not ok and witness:
        wit = knn_f64(torch, ins, sel, gamma)
        e_k, e_p = max_err(out, wit), max_err(ref, wit)
        ok = e_k <= WITNESS_FACTOR * e_p
        print(f"kernels: knn_fuse {label}: max |err| {err:.3g} over {tol}; against float64 "
              f"on the same picks: kernel {e_k:.3g}, plain {e_p:.3g} (ratio at most "
              f"{WITNESS_FACTOR})")
    check(bool(torch.isfinite(out).all()) and ok,
          f"knn_fuse {label}: max err {err:.3g} (tol {tol})")
    return err


def compare_knn(torch, ins, alive, gamma: float, k: int, label: str,
                witness: bool = False, served=None) -> tuple:
    """knn_fuse against knn_fuse_ref: identical selections, outputs within
    ``knn_agree``'s bound; returns (max |err|, the (Q, k) picks).
    ``served``: answers a path served on these inputs, which must be the
    kernel's bitwise."""
    from repro_torch.kernels import knn_fuse as kf

    out, sel = kf.knn_fuse_fused(*ins, alive=alive, gamma=gamma, k=k, with_selection=True)
    ref, ref_sel = kf.knn_fuse_ref(*ins[:4], alive, *ins[4:], gamma=gamma, k=k)
    torch.cuda.synchronize()
    q, b = ins[0].shape[0], ins[-1].shape[0]
    check(torch.equal(sel, ref_sel), f"knn_fuse {label}: selected sets differ")
    check(out.dtype == ins[-1].dtype and out.shape == (b, q),
          f"knn_fuse {label}: output {out.dtype} {tuple(out.shape)}")
    check(served is None or torch.equal(served, out),
          f"knn_fuse {label}: the served answers are not the kernel's on these inputs")
    return knn_agree(torch, out, ref, ins, sel, gamma, label, witness), sel


def check_knn(torch, prob, state, anchor_dtype, label: str) -> float:
    ins, alive, _ = knn_inputs(torch, prob, state, 4096, seed=2)
    if anchor_dtype is not None:
        ins = ins[:5] + (ins[5].to(anchor_dtype),) + ins[6:]
    err, sel = compare_knn(torch, ins, alive, prob.kernel.gamma, 3, label)
    picks = int((sel >= 0).sum())
    print(f"kernels: knn_fuse {label} ok: Q={ins[0].shape[0]} k=3, identical selections "
          f"({picks} picks), max |err| {err:.3g}")
    return err


LATTICE_H = 1.0 / 16  # lattice spacing: coordinates and squared distances exact in f32


def lattice_problem(torch, dtype):
    """Sensors on the 33 x 33 lattice of spacing 1/16 over [-1, 1]^2 (4 fields)."""
    from repro_torch.core import Kernel, build_topology, make_batch_problem

    g = np.arange(-16, 17) * LATTICE_H
    pos = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    topo = build_topology(pos, 1.5 * LATTICE_H, device="cuda")
    ys = np.sin(np.pi * pos[None, :, 0]) + np.random.default_rng(12).normal(size=(4, len(pos)))
    return make_batch_problem(topo, Kernel("rbf", gamma=1.0), ys, np.full(len(pos), 0.1),
                              dtype=dtype, device="cuda")


def check_knn_ties(torch, dtype, anchor_dtype, label: str) -> None:
    """knn_fuse on a tie-heavy input: queries at every lattice point (its 4
    nearest neighbours tie at distance h) and every cell midpoint (4 corners
    tie), k = 3 and 5; the selections must equal the plain version's, whose
    argmin takes the lowest column among exact ties."""
    from repro_torch.core import colored_sweep, init_state

    prob = lattice_problem(torch, dtype)
    state = colored_sweep(prob, init_state(prob), n_sweeps=3, engine="plan")
    g = np.arange(-16, 17) * LATTICE_H
    mid = g[:-1] + LATTICE_H / 2
    pts = [np.stack(np.meshgrid(a, a, indexing="ij"), -1).reshape(-1, 2) for a in (g, mid)]
    xq = torch.as_tensor(np.concatenate(pts), dtype=dtype, device="cuda")
    readings = []
    for k in (3, 5):
        ins, alive, _ = knn_inputs(torch, prob, state, 0, seed=0, k=k, xq=xq)
        if anchor_dtype is not None:
            ins = ins[:5] + (ins[5].to(anchor_dtype),) + ins[6:]
        err, sel = compare_knn(torch, ins, alive, prob.kernel.gamma, k, f"{label} ties k={k}")
        picks = int((sel >= 0).sum())
        readings.append(f"k={k}: {picks} picks, max |err| {err:.3g}")
    print(f"kernels: knn_fuse {label} ties ok: {xq.shape[0]} queries at lattice points and "
          f"cell midpoints, identical selections; " + "; ".join(readings))


def time_knn(torch, prob, state, plan=None) -> dict:
    from repro_torch.kernels import knn_fuse as kf

    ins, alive, plan = knn_inputs(torch, prob, state, 4096, seed=3, plan=plan)
    g = prob.kernel.gamma
    ms = graph_ms(lambda: kf.knn_fuse_fused(*ins, alive=alive, gamma=g, k=3))
    call_ms = cuda_ms(lambda: kf.knn_fuse_fused(*ins, alive=alive, gamma=g, k=3))
    plain_ms = cuda_ms(lambda: kf.knn_fuse_ref(*ins[:4], alive, *ins[4:], gamma=g, k=3),
                       reps=5)
    # the selection alone: the same call with no fields to evaluate
    no_fields = ins[:5] + tuple(t[:0].contiguous() for t in ins[5:])
    selection_ms = graph_ms(lambda: kf.knn_fuse_fused(*no_fields, alive=alive, gamma=g, k=3))
    _, sel = kf.knn_fuse_fused(*ins, alive=alive, gamma=g, k=3, with_selection=True)
    xq, _, cells, cmask, spos, nbr_pos, nbr_mask, coef = ins
    q, d = xq.shape
    b, r, dm, _ = nbr_pos.shape
    s = coef.element_size()
    picked = int(torch.unique(sel[sel >= 0]).numel())  # rows this run's queries need
    nbytes = (q * (d * s + 4) + cells.numel() * 5 + r * (1 + d * s)
              + b * picked * dm * (d * nbr_pos.element_size() + 1 + s) + b * q * s)
    flops = q * cells.shape[1] * 3 * d + b * int((sel >= 0).sum()) * dm * (3 * d + 4)
    exps = int(nbr_mask[:, sel[sel >= 0].long()].sum())  # the masked-in terms of the picks
    t, by = bound(nbytes, flops, str(coef.dtype).split(".")[1], exps)
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=t, bound_by=by,
                library_ms=None, exps=exps, selection_ms=selection_ms)


def conn_inputs(torch, prob, state, xq):
    from repro_torch.core import fusion

    anchors, coefs = fusion.global_coefficients(prob, state, rule="conn")
    return xq.to(torch.float32).contiguous(), anchors.contiguous(), coefs.contiguous()


MATVEC_TOL = 2e-5


def matvec_f64(torch, xq, anchors, coef, gamma: float):
    """kernel_matvec's function evaluated in float64, one field at a time."""
    x, a, c = xq.double(), anchors.double(), coef.double()
    rows = []
    for i in range(c.shape[0]):
        ai = a if a.ndim == 2 else a[i]
        d2 = (x * x).sum(-1)[:, None] + (ai * ai).sum(-1)[None, :] - 2.0 * x @ ai.T
        rows.append(torch.exp(-gamma * torch.clamp(d2, min=0.0)) @ c[i])
    return torch.stack(rows)


def matvec_case(torch, xq, anchors, coef, gamma: float, label: str,
                held: bool | None = True):
    """kernel_matvec against its plain version and both against float64.

    ``held``: the kernel must be within MATVEC_TOL absolute and relative of
    the plain version.  False (unit coefficients on thousands of anchors,
    where the float32 rounding of either summation order exceeds that): its
    error against float64 may be at most WITNESS_FACTOR times the plain
    version's.  None (a streamed state, every anchor non-zero): either of
    the two.  Returns (kernel output, reading)."""
    from repro_torch.kernels import kernel_matvec as km

    got = km.kernel_matvec_batched(xq, anchors, coef, gamma=gamma)
    ref = km.kernel_matvec_ref(xq, anchors, coef, gamma)
    wit = matvec_f64(torch, xq, anchors, coef, gamma)
    torch.cuda.synchronize()
    r = dict(err=max_err(got, ref), kernel_f64=max_err(got, wit), plain_f64=max_err(ref, wit),
             max_abs=float(wit.abs().max()))
    direct = excess(got, ref, MATVEC_TOL) <= MATVEC_TOL
    witness = r["kernel_f64"] <= WITNESS_FACTOR * r["plain_f64"]
    within = f"within {MATVEC_TOL} + {MATVEC_TOL} |ref|"
    f64 = f"f64 error <= {WITNESS_FACTOR} x plain's"
    if held or (held is None and direct):
        ok, how = direct, within
    else:
        ok, how = witness, f64
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()) and ok,
          f"kernel_matvec {label}: not {how}: {json.dumps(r)}")
    return got, (f"{label} ({how}): max |err| {r['err']:.3g}, vs f64 kernel "
                 f"{r['kernel_f64']:.3g} plain {r['plain_f64']:.3g} (|f64| up to "
                 f"{r['max_abs']:.3g})")


def streaming_coefs(torch, coefs, seed: int, scale: float | None = None):
    """Random non-zero coefficients on every anchor (the state once stream
    slots hold arrivals), at the live coefficients' RMS unless ``scale``."""
    if scale is None:
        live = coefs[coefs != 0]
        scale = float(live.square().mean().sqrt())
    rng = np.random.default_rng(seed)
    return torch.as_tensor(scale * rng.normal(size=tuple(coefs.shape)), dtype=torch.float32,
                           device=coefs.device)


def check_matvec(torch, prob, state, xq) -> float:
    """The conn route's inputs, then the kernel's edges: every anchor
    non-zero, one all-zero field, a ragged Q, d = 1 and d = MAX_DIM, one
    field with shared anchors (through ``ops.kernel_matvec``), and two calls
    that must give the same bits."""
    from repro_torch.kernels import kernel_matvec as km
    from repro_torch.kernels.ops import kernel_matvec

    g = prob.kernel.gamma
    xq32, anchors, coefs = conn_inputs(torch, prob, state, xq)
    lines = []
    multi, line = matvec_case(torch, xq32, anchors, coefs, g, "conn route")
    err_m = max_err(multi, km.kernel_matvec_ref(xq32, anchors, coefs, g))
    lines.append(line)
    full = streaming_coefs(torch, coefs, seed=5)
    full[5] = 0.0  # one field whose coefficients are all zero
    out_full, line = matvec_case(torch, xq32, anchors, full, g, "all anchors non-zero")
    lines.append(line)
    check(bool((out_full[5] == 0).all()), "kernel_matvec: an all-zero field gave non-zero output")
    _, line = matvec_case(torch, xq32, anchors, streaming_coefs(torch, coefs, 6, scale=1.0), g,
                          "all anchors, unit coefficients", held=False)
    lines.append(line)
    _, line = matvec_case(torch, xq32[:4001].contiguous(), anchors, full, g, "ragged Q=4001")
    lines.append(line)
    rng = np.random.default_rng(7)
    for d in (1, km.MAX_DIM):
        n = 3000  # coefficients N(0, 1/n): outputs of order 1, as the fields' are
        xd = torch.as_tensor(rng.normal(size=(4096, d)), dtype=torch.float32, device="cuda")
        ad = torch.as_tensor(rng.normal(size=(3, n, d)), dtype=torch.float32, device="cuda")
        cd = torch.as_tensor(rng.normal(size=(3, n)) / n ** 0.5, dtype=torch.float32,
                             device="cuda")
        for g_d in (0.5, -0.05) if d == 1 else (0.5,):  # gamma < 0 clamps the other way
            _, line = matvec_case(torch, xd, ad, cd, g_d, f"d={d}, B=3 x {n} anchors, "
                                  f"gamma {g_d}")
            lines.append(line)
    # one field (B = 1, the centralized-predict body): shared sensor anchors
    pos = prob.topology.positions
    c1 = torch.as_tensor(np.random.default_rng(4).normal(size=pos.shape[0]),
                         dtype=torch.float32, device=pos.device)
    single = kernel_matvec(xq32, pos, c1, gamma=g)
    ref1 = km.kernel_matvec_ref(xq32, pos, c1[None], g)[0]
    torch.cuda.synchronize()
    check(single.shape == (xq.shape[0],) and excess(single, ref1, MATVEC_TOL) <= MATVEC_TOL,
          f"kernel_matvec B=1: max |err| {max_err(single, ref1):.3g}")
    lines.append(f"B=1 x {pos.shape[0]} shared anchors: max |err| {max_err(single, ref1):.3g}")
    again = (km.kernel_matvec_batched(xq32, anchors, coefs, gamma=g),
             km.kernel_matvec_batched(xq32, anchors, full, gamma=g))
    torch.cuda.synchronize()
    check(torch.equal(again[0], multi) and torch.equal(again[1], out_full),
          "kernel_matvec: two calls on the same inputs differ")
    print(f"kernels: kernel_matvec ok: B={prob.batch_size} fields x {anchors.shape[1]} anchors; "
          + "; ".join(lines) + "; two calls bitwise equal")
    return err_m


def matvec_floor(xq, anchors, coef) -> tuple[float, str, int]:
    """kernel_matvec's least time on these inputs: the non-zero terms this data
    needs (exp-bound at the field shapes); returns (ms, by, non-zero anchors)."""
    q, d = xq.shape
    nonzero = int((coef != 0).sum())
    nbytes = 4 * (q * d + anchors.numel() + coef.numel() + coef.shape[0] * q)
    t, by = bound(nbytes, q * nonzero * (2 * d + 8), "float32", q * nonzero)
    return t, by, nonzero


def time_matvec(torch, prob, state, xq) -> dict:
    from repro_torch.kernels import kernel_matvec as km

    g = prob.kernel.gamma
    xq32, anchors, coefs = conn_inputs(torch, prob, state, xq)
    ms = graph_ms(lambda: km.kernel_matvec_batched(xq32, anchors, coefs, gamma=g))
    call_ms = cuda_ms(lambda: km.kernel_matvec_batched(xq32, anchors, coefs, gamma=g))
    plain_ms = cuda_ms(lambda: km.kernel_matvec_ref(xq32, anchors, coefs, g), reps=5)
    xb = xq32[None].expand(anchors.shape[0], -1, -1)
    library_ms = cuda_ms(
        lambda: torch.exp(-g * torch.cdist(xb, anchors) ** 2) @ coefs[..., None], reps=5)
    t, by, nonzero = matvec_floor(xq32, anchors, coefs)
    # every anchor non-zero: the state once stream slots hold arrivals
    full = streaming_coefs(torch, coefs, seed=5)
    t_full, by_full, _ = matvec_floor(xq32, anchors, full)
    all_nonzero = dict(ms=graph_ms(lambda: km.kernel_matvec_batched(xq32, anchors, full, gamma=g)),
                       bound_ms=t_full, bound_by=by_full, nonzero_anchors=int(full.numel()))
    # one field (B = 1, the TPU's single-field kernel): the sensor anchors
    pos = prob.topology.positions.contiguous()
    c1 = torch.as_tensor(np.random.default_rng(4).normal(size=(1, pos.shape[0])),
                         dtype=torch.float32, device=pos.device)
    t1, by1, _ = matvec_floor(xq32, pos, c1)
    single = dict(
        ms=graph_ms(lambda: km.kernel_matvec_batched(xq32, pos, c1, gamma=g)),
        plain_ms=cuda_ms(lambda: km.kernel_matvec_ref(xq32, pos, c1, g)),
        library_ms=cuda_ms(lambda: torch.exp(-g * torch.cdist(xq32, pos) ** 2) @ c1[0]),
        bound_ms=t1, bound_by=by1, anchors=pos.shape[0],
    )
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=t, bound_by=by,
                library_ms=library_ms, nonzero_anchors=nonzero, single_field=single,
                all_nonzero=all_nonzero)


# ssd_intra and rbf_gram: the second slice's kernels.
# ---------------------------------------------------------------------------

SSD_FULL = (4, 512, 32, 64, 128, 256)  # b, s, H, P, N, chunk of the mamba2-370m prefill
SSD_PADDED_S = 300  # not a chunk multiple: the scan pads it to 512
SSD_RAGGED = (2, 96, 5, 20, 24, 48)  # P, N and chunk off the MMA tiles, H odd
SSD_TOL = 3e-4
GRAM_TOL = 2e-5


def excess(got, ref, tol: float) -> float:
    """max(|got - ref| - tol |ref|): within tol absolute and relative iff <= tol."""
    return float(((got.double() - ref.double()).abs() - tol * ref.double().abs()).max())


def ssd_inputs(torch, b, s, h, p, n, seed: int):
    """Random SSD inputs at a model's shapes, with the model's A in [-16, -1]."""
    rng = np.random.default_rng(seed)
    cuda = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    x = cuda(rng.normal(size=(b, s, h, p)))
    dt = torch.nn.functional.softplus(cuda(rng.normal(size=(b, s, h))))
    a = -cuda(np.linspace(1.0, 16.0, h))
    return x, dt, a, cuda(rng.normal(size=(b, s, n))), cuda(rng.normal(size=(b, s, n)))


def check_ssd_intra(torch):
    """The kernel at the prefill's shape, then the chunked scan around it at a
    padded length; returns (max |err|, the full-shape kernel inputs)."""
    from repro_torch.kernels import ops, ssd_intra as si
    from repro_torch.models import ssm

    b, s, h, p, n, cs = SSD_FULL
    x, dt, a, bm, cm = ssd_inputs(torch, b, s, h, p, n, seed=7)
    da_cum = torch.cumsum((dt * a).reshape(b, s // cs, cs, h), dim=2).reshape(b, s, h)
    ins = (x, dt, da_cum.contiguous(), bm, cm)
    got = si.ssd_intra(*ins, chunk=cs)
    ref = si.ssd_intra_ref(*ins, cs)
    torch.cuda.synchronize()
    err, over = max_err(got, ref), excess(got, ref, SSD_TOL)
    check(got.shape == (b, s, h, p) and bool(torch.isfinite(got).all()) and over <= SSD_TOL,
          f"ssd_intra: max |err| {err:.3g} (tol {SSD_TOL} + {SSD_TOL} |ref|)")
    xs, dts, _, bms, cms = ssd_inputs(torch, 2, SSD_PADDED_S, h, p, n, seed=8)
    y_k, st_k = ops.ssd_chunked_fused(xs, dts, a, bms, cms, cs)
    y_p, st_p = ssm.ssd_chunked(xs, dts, a, bms, cms, cs)
    torch.cuda.synchronize()
    err_y, err_st = max_err(y_k, y_p), max_err(st_k, st_p)
    check(excess(y_k, y_p, SSD_TOL) <= SSD_TOL and excess(st_k, st_p, SSD_TOL) <= SSD_TOL,
          f"ssd_chunked_fused at S={SSD_PADDED_S}: |dy| {err_y:.3g}, |dstate| {err_st:.3g}")
    rb, rs, rh, rp, rn, rc = SSD_RAGGED
    xr, dtr, ar, bmr, cmr = ssd_inputs(torch, rb, rs, rh, rp, rn, seed=9)
    dar = torch.cumsum((dtr * ar).reshape(rb, rs // rc, rc, rh), dim=2).reshape(rb, rs, rh)
    ins_r = (xr, dtr, dar.contiguous(), bmr, cmr)
    got_r, ref_r = si.ssd_intra(*ins_r, chunk=rc), si.ssd_intra_ref(*ins_r, rc)
    torch.cuda.synchronize()
    err_r = max_err(got_r, ref_r)
    check(bool(torch.isfinite(got_r).all()) and excess(got_r, ref_r, SSD_TOL) <= SSD_TOL,
          f"ssd_intra at B={rb} S={rs} H={rh} P={rp} N={rn} chunk={rc}: max |err| {err_r:.3g}")
    print(f"kernels: ssd_intra ok: B={b} S={s} H={h} P={p} N={n} chunk={cs}, max |err| "
          f"{err:.3g} (|ref| up to {float(ref.abs().max()):.3g}); chunked scan at "
          f"S={SSD_PADDED_S} (padded to {-(-SSD_PADDED_S // cs) * cs}) vs plain: "
          f"max |dy| {err_y:.3g}, max |dstate| {err_st:.3g}; ragged B={rb} S={rs} H={rh} "
          f"P={rp} N={rn} chunk={rc}: max |err| {err_r:.3g} (tol {SSD_TOL} + {SSD_TOL} |ref|)")
    return err, (ins, cs)


def time_ssd_intra(torch, ins, cs: int) -> dict:
    from repro_torch.kernels import ssd_intra as si

    x, dt, da_cum, bm, cm = ins
    b, s, h, p = x.shape
    n = bm.shape[-1]
    ms = graph_ms(lambda: si.ssd_intra(*ins, chunk=cs))
    call_ms = cuda_ms(lambda: si.ssd_intra(*ins, chunk=cs))
    plain_ms = cuda_ms(lambda: si.ssd_intra_ref(*ins, cs), reps=5)
    # inputs read once, the output written once; per (batch, chunk) the
    # causal pairs l >= m: CB over N, and per head the masked decay (a
    # subtraction, an exp, a product) and M (dt x) over P; dt x once
    # The kernel runs both products on the tensor cores in 3xTF32, so its
    # least time is the larger of the bytes and three TF32 passes of the
    # causal operations; the float32-FMA bound is printed beside it.
    pairs = b * (s // cs) * cs * (cs + 1) // 2
    nbytes = 4 * (2 * x.numel() + 2 * dt.numel() + 2 * bm.numel())
    flops = pairs * (2 * n + h * (2 * p + 3)) + x.numel()
    t, by = bound(nbytes, 3 * flops, "tf32")
    t_fma, by_fma = bound(nbytes, flops, "float32")
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=t, bound_by=by,
                library_ms=None, bound_f32_fma_ms=t_fma, bound_f32_fma_by=by_fma)


def check_gram(torch, x1, x2, gamma: float) -> float:
    from repro_torch.kernels import gram
    from repro_torch.kernels.ops import rbf_gram

    got = rbf_gram(x1, x2, gamma=gamma)
    ref = gram.rbf_gram_ref(x1, x2, gamma)
    torch.cuda.synchronize()
    err, over = max_err(got, ref), excess(got, ref, GRAM_TOL)
    check(got.shape == (x1.shape[0], x2.shape[0]) and over <= GRAM_TOL,
          f"rbf_gram: max |err| {err:.3g} (tol {GRAM_TOL} + {GRAM_TOL} |ref|)")
    print(f"kernels: rbf_gram ok: {x1.shape[0]} queries x {x2.shape[0]} anchors, d="
          f"{x1.shape[1]}, {got.numel() * 4 / 1e6:.1f} MB out, max |err| {err:.3g}")
    return err


def time_gram(torch, x1, x2, gamma: float) -> dict:
    from repro_torch.kernels import gram

    ms = graph_ms(lambda: gram.rbf_gram(x1, x2, gamma=gamma))
    call_ms = cuda_ms(lambda: gram.rbf_gram(x1, x2, gamma=gamma))
    plain_ms = cuda_ms(lambda: gram.rbf_gram_ref(x1, x2, gamma), reps=5)
    library_ms = cuda_ms(lambda: torch.exp(-gamma * torch.cdist(x1, x2).square()), reps=5)
    (m, d), n = x1.shape, x2.shape[0]
    # per element: the cross term, the expanded square, clamp, scale and exp
    t, by = bound(4 * (m * n + (m + n) * d), m * n * (2 * d + 6), "float32", m * n)
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=t, bound_by=by,
                library_ms=library_ms)


# ---------------------------------------------------------------------------
# Phase 3b: the streaming path.
# ---------------------------------------------------------------------------

STREAM_FLAGS = ["--stream", "2048", "--on_full", "evict", "--refresh_sweeps", "5"]
WAVE_ROUNDS = 10  # dense evicting waves after the partial one: the windows wrap
WAVE_BETAS = (1.0, 0.9)  # alternating over the fields
WAVE_PAIRS = 16  # (field, sensor) pairs held against sequential absorbs per checked wave
STREAM_Z_TOL, STREAM_COEF_TOL = 2e-4, 2e-2  # the long-chain sweep bound
STREAM_KNN_TOL = 2e-4


# One unit of each registry entry whose launches the phases below count, as
# this script holds them.  The phases read their expected counts from the
# launch ledger; the audit phase first holds the ledger to this table, so a
# change to the ledger's counts fails the run instead of moving the yardstick.
LEDGER_UNITS = {
    "sweep.colored.cuda": {"color_step": 1},
    "serving.knn.cuda": {"knn_fuse": 1},
    "kernels.matvec": {"kernel_matvec": 1},
    "faults.cuda": {"color_step": 1},  # per call (a round)
    "faults.crash.cuda": {"color_step": 1},  # per sweep
    "sweep.sharded.fields.cuda": {"color_step": 1},
    "sweep.sharded.sensors": {},
    "lm.prefill.ssd": {"ssd_intra": 1},  # per SSM layer of a prefill
}
# the host-sync control: knn_fuse without a plan builds one on the host, so
# the auditor must report exactly this key
SYNC_CONTROL = "host-sync:control.knn_fuse.plan_none:core.serving:make_serving_plan"


def run_audit(torch) -> dict:
    """The card's auditors of ``repro_torch.analysis``: host-sync over the
    sync-free registry, the liveness rules through the cuda engines, and the
    launch ledger with its fault-rate / tau / beta grid check.  First the
    ledger is held to ``LEDGER_UNITS`` and the host-sync auditor to a
    control with one known sync (outside the baseline comparison).  One
    ``audit:`` line per auditor; any new finding, or a stale baseline entry
    among what ran, fails the run.  Returns the seconds and keys."""
    from repro_torch import analysis
    from repro_torch.analysis import entries, launch_ledger, sync_audit
    from repro_torch.core import serving

    t0 = time.perf_counter()
    for name, want in LEDGER_UNITS.items():
        got = {k: v for k, v in launch_ledger.expected({name: 1}).items() if v}
        check(got == want, f"audit: the ledger says {name} launches {got}, this script {want}")
    c = entries.card_inputs(sync_audit.canonical_card())
    control = sync_audit.audit_entry(
        "control.knn_fuse.plan_none", "core.serving:knn_fuse",
        lambda: serving.knn_fuse(c.p, c.st, c.xq, 2, plan=None, engine="cuda"))
    keys = [f.key for f in control]
    print(f"audit: control: knn_fuse without a plan: {keys}")
    check(keys == [SYNC_CONTROL], f"audit: the host-sync control found {keys}, "
          f"expected [{SYNC_CONTROL}]")
    results = analysis.run(("sync", "alive", "ledger"), "cuda")
    readings = {"control": keys}
    for r in results:
        print(analysis.summary_line(r))
        for f in r["findings"]:
            print(f"audit: {r['auditor']}: {'NEW' if f in r['new'] else 'baselined'} "
                  f"{f.key}: {f.detail}")
        for key in r["stale"]:
            print(f"audit: {r['auditor']}: STALE {key} (no longer fires; delete it)")
        readings[r["auditor"]] = {"s": r["seconds"], "findings": [f.key for f in r["findings"]]}
    bad = [f.key for r in results for f in r["new"]] + [k for r in results for k in r["stale"]]
    check(not bad, f"audit: new or stale findings {bad}")
    readings["phase_s"] = time.perf_counter() - t0
    return readings


def stream_args():
    from repro_torch.launch import serve

    argv = main_args()[0] + STREAM_FLAGS
    return argv, serve.parser().parse_args(argv)


def run_stream_launcher(torch, mods) -> tuple[dict, dict]:
    """The launcher with --stream at the field path's geometry, launches counted;
    then its streamed state held to the same pipeline on the plain engines.
    Returns (launches, readings)."""
    from repro_torch.analysis import launch_ledger
    from repro_torch.core import colored_sweep, streaming
    from repro_torch.kernels import kernel_matvec as km
    from repro_torch.launch import serve

    argv, args = stream_args()
    print("main-stream: python -m repro_torch.launch.serve " + " ".join(argv))
    for mod in mods.values():
        mod.launches = 0
    res = serve.main(argv)
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in mods.items()}
    print("main-stream: kernel launches " + json.dumps(launches)
          + f" ({res['train_calls']} train calls + 1 refresh)")
    expected = launch_ledger.expected({"sweep.colored.cuda": res["train_calls"] + 1,
                                       "serving.knn.cuda": serve.TIMED_CALLS,
                                       "kernels.matvec": serve.TIMED_CALLS})
    check(launches == expected, f"main-stream: kernel launches {launches}, expected {expected}")
    info, prob, state, xq = res["stream"], res["problem"], res["state"], res["xq"]
    b, q = args.fields, args.queries
    check(info["absorbed"] > 0 and info["absorbed"] + info["dropped"] == args.stream,
          f"main-stream: receipts {info['absorbed']} absorbed + {info['dropped']} dropped "
          f"!= {args.stream}")
    occupied = int((prob.nbr_mask & (prob.nbr_idx >= prob.n)).sum())
    print(f"main-stream: receipts: {info['absorbed']} absorbed, {info['evicted']} evicted, "
          f"{info['dropped']} dropped of {args.stream}; D={prob.topology.d_max}, "
          f"{prob.n_stream} stream slots per field, {occupied} occupied over {b} fields")
    for key in ("knn", "conn"):
        check(res[key].shape == (b, q) and bool(torch.isfinite(res[key]).all()),
              f"main-stream {key}: shape {tuple(res[key].shape)} or non-finite values")
    err_chol = max_err(streaming.rebuild_chol(prob), prob.chol)
    check(prob.chol.is_contiguous() and err_chol <= 1e-4,
          f"main-stream: chol vs rebuild_chol {err_chol:.3g} (tol 1e-4)")

    # the same pipeline on the plain engines (train, refresh and kNN)
    plain = serve.main(argv + ["--engine", "plan"])
    torch.cuda.synchronize()
    pp, ps = plain["problem"], plain["state"]
    for key in ("absorbed", "evicted"):
        check(torch.equal(getattr(plain["stream"]["receipt"], key), getattr(info["receipt"], key)),
              f"main-stream: {key} flags differ between the engines' runs")
    for name in ("nbr_pos", "nbr_mask", "stream_pos", "gram", "anchor_w"):
        check(torch.equal(getattr(pp, name), getattr(prob, name)),
              f"main-stream: streamed {name} differs between the engines' runs")
    err_z, err_c = max_err(state.z[:, :-1], ps.z[:, :-1]), max_err(state.coef, ps.coef)
    err_knn = max_err(res["knn"], plain["knn"])
    err_conn_e2e = max_err(res["conn"], plain["conn"])
    print(f"main-stream: vs plain engines on the card: max |dz| {err_z:.3g}, |dcoef| "
          f"{err_c:.3g}, knn {err_knn:.3g}, conn {err_conn_e2e:.3g}; chol vs rebuild_chol "
          f"{err_chol:.3g}")
    check(err_z <= STREAM_Z_TOL and err_c <= STREAM_COEF_TOL,
          "main-stream: streamed state differs from the plan engine's")
    check(err_knn <= STREAM_KNN_TOL, "main-stream: kNN answers differ from the plain engines'")
    xq32, anchors, coefs = conn_inputs(torch, prob, state, xq)
    _, line = matvec_case(torch, xq32, anchors, coefs, args.gamma, "streamed conn route",
                          held=None)
    print(f"main-stream: kernel_matvec {line}")

    # times on the card
    g = args.gamma
    t_mv, by_mv, nonzero = matvec_floor(xq32, anchors, coefs)
    readings = dict(
        absorb_many_ms_per_arrival=info["window_s"] / info["window"] * 1e3,
        absorb_window=info["window"],
        refresh_s=info["refresh_s"],
        refresh_ms=cuda_ms(lambda: colored_sweep(prob, state, n_sweeps=args.refresh_sweeps,
                                                 engine="cuda"), reps=5, warmup=1),
        knn_request_ms=res["knn_s"] * 1e3,
        conn_request_ms=res["conn_s"] * 1e3,
        rebuild_chol_ms=cuda_ms(lambda: streaming.rebuild_chol(prob), reps=5, warmup=1),
        kernel_matvec_ms=graph_ms(lambda: km.kernel_matvec_batched(xq32, anchors, coefs,
                                                                   gamma=g)),
        kernel_matvec_nonzero_anchors=nonzero,
        kernel_matvec_anchors=int(coefs.numel()),
        kernel_matvec_bound_ms=t_mv, kernel_matvec_bound_by=by_mv,
        kernel_matvec_plain_ms=cuda_ms(lambda: km.kernel_matvec_ref(xq32, anchors, coefs, g),
                                       reps=5),
        err_z=err_z, err_coef=err_c, err_knn=err_knn, err_conn_e2e=err_conn_e2e,
        err_chol_rebuild=err_chol,
        # the two lane-bound kernels at the streamed geometry's wider D
        color_step=time_color_step(torch, prob, args.sweeps),
        knn_fuse=time_knn(torch, prob, state),
    )
    return launches, readings


def wave_pairs(torch, prob, mask, fields: int):
    """WAVE_PAIRS (field, sensor) pairs over every field (both betas): the
    highest-degree sensors (the first to wrap their windows), each with an
    arrival under ``mask``."""
    order = torch.argsort(prob.topology.degrees, descending=True, stable=True).cpu().numpy()
    fs, ss = [], []
    for i in range(WAVE_PAIRS):
        f = i % fields
        s = next(int(s) for s in order if mask[f, s] and int(s) not in ss)
        fs.append(f)
        ss.append(s)
    dev = prob.device
    return torch.as_tensor(fs, device=dev), torch.as_tensor(ss, device=dev)


def compare_wave_rows(torch, pw, sw, pq, sq, f, s, label: str) -> float:
    """The wave's rows (f, s) against sequential absorbs': every table bitwise,
    the factors within 1e-5; returns the factors' max |err|."""
    ids = pw.nbr_idx[s].long()  # (P, D)
    live = ids != pw.sentinel
    slot = torch.clamp(ids - pw.n, 0, pw.n_stream - 1)
    stream = live & (ids >= pw.n)
    for name in ("nbr_pos", "nbr_mask", "gram", "anchor_w"):
        check(torch.equal(getattr(pw, name)[f, s], getattr(pq, name)[f, s]),
              f"main-stream wave {label}: {name} differs from sequential absorbs")
    check(torch.equal(pw.stream_pos[f[:, None], slot][stream],
                      pq.stream_pos[f[:, None], slot][stream]),
          f"main-stream wave {label}: stream_pos differs from sequential absorbs")
    check(torch.equal(sw.z[f[:, None], ids][live], sq.z[f[:, None], ids][live]),
          f"main-stream wave {label}: z differs from sequential absorbs")
    check(torch.equal(sw.coef[f, s], sq.coef[f, s]),
          f"main-stream wave {label}: coef differs from sequential absorbs")
    err = max_err(pw.chol[f, s], pq.chol[f, s])
    check(err <= 1e-5, f"main-stream wave {label}: chol {err:.3g} from sequential (tol 1e-5)")
    return err


def run_waves(torch) -> dict:
    """Dense arrival waves at the streamed geometry with the beta mix: one
    partial wave under drop, then WAVE_ROUNDS under evict; two of them held
    to sequential absorbs, the factors to rebuild_chol, and the kernels to
    their plain versions on the final state.  Returns the readings."""
    from repro_torch.core import colored_sweep, init_state, streaming
    from repro_torch.kernels import kernel_matvec as km
    from repro_torch.launch import serve

    _, args = stream_args()
    prob = serve.build_problem(args)
    b, n = args.fields, args.sensors
    beta = torch.as_tensor([WAVE_BETAS[i % 2] for i in range(b)], dtype=prob.beta.dtype,
                           device=prob.device)
    prob = dataclasses.replace(prob, beta=beta)
    state = colored_sweep(prob, init_state(prob), n_sweeps=args.sweeps, engine="cuda")
    rng = np.random.default_rng(21)
    pos = prob.topology.positions[:n].cpu().numpy()
    partial = (np.add.outer(np.arange(b), np.arange(n)) % 3) != 0
    rounds = [("drop", partial)] + [("evict", np.ones((b, n), bool))] * WAVE_ROUNDS
    times = {"drop": [], "evict": []}
    checked, evicted, chol_errs = 0, 0, []
    for r, (policy, mask) in enumerate(rounds):
        xs = torch.as_tensor(pos[None] + 0.05 * rng.normal(size=(b, n, pos.shape[1])),
                             dtype=torch.float32, device=prob.device)
        ys = torch.as_tensor(rng.normal(size=(b, n)), dtype=torch.float32, device=prob.device)
        mask_t = torch.as_tensor(mask, device=prob.device)
        pairs = None
        if r in (0, len(rounds) - 1):  # the partial drop wave and the last evicting one
            f, s = pairs = wave_pairs(torch, prob, mask, b)
            pq, sq = prob, state
            for i in range(WAVE_PAIRS):
                pq, sq, _ = streaming.absorb(pq, sq, f[i], s[i], xs[f[i], s[i]], ys[f[i], s[i]],
                                             donate=i > 0, on_full=policy)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        prob, state, rec = streaming.absorb_wave(prob, state, xs, ys, mask=mask_t, donate=True,
                                                 on_full=policy)
        end.record()
        torch.cuda.synchronize()
        times[policy].append(start.elapsed_time(end))
        check(torch.equal(rec.absorbed, mask_t) or policy == "drop",
              f"main-stream wave {r}: an evicting wave dropped an arrival")
        evicted += int(rec.evicted.sum())
        if pairs is not None:
            label = f"{r} ({policy})"
            chol_errs.append(compare_wave_rows(torch, prob, state, pq, sq, *pairs, label))
            checked += WAVE_PAIRS
            del pq, sq
    check(evicted > 0, "main-stream waves: no eviction, the windows never wrapped")
    err_rebuild = max_err(streaming.rebuild_chol(prob), prob.chol)
    check(err_rebuild <= 5e-5, f"main-stream waves: chol vs rebuild_chol {err_rebuild:.3g} "
          f"(tol 5e-5)")
    print(f"main-stream waves: 1 partial wave under drop + {WAVE_ROUNDS} dense waves under "
          f"evict ({b * n} arrivals each), beta {WAVE_BETAS[0]}/{WAVE_BETAS[1]} alternating: "
          f"{evicted} evictions; {checked} (field, sensor) pairs bitwise equal to sequential "
          f"absorbs (chol max |err| {max(chol_errs):.3g}); chol vs rebuild_chol "
          f"{err_rebuild:.3g}; min anchor weight {float(prob.anchor_w.min()):.3g}")

    # the ported kernels on the streamed state against their plain versions
    st_c = colored_sweep(prob, state, n_sweeps=args.refresh_sweeps, engine="cuda")
    st_p = colored_sweep(prob, state, n_sweeps=args.refresh_sweeps, engine="plan")
    torch.cuda.synchronize()
    err_z, err_c = max_err(st_c.z, st_p.z), max_err(st_c.coef, st_p.coef)
    check(err_z <= STREAM_Z_TOL and err_c <= STREAM_COEF_TOL,
          f"main-stream waves: color_sweep vs plan: |dz| {err_z:.3g}, |dcoef| {err_c:.3g}")
    ins, alive, _ = knn_inputs(torch, prob, st_c, 4096, seed=13)
    err_knn, sel = compare_knn(torch, ins, alive, prob.kernel.gamma, 3, "streamed waves")
    picks = int((sel >= 0).sum())
    xq = torch.as_tensor(np.stack([np.linspace(-1, 1, 4096), np.zeros(4096)], 1),
                         dtype=torch.float32, device=prob.device)
    xq32, anchors, coefs = conn_inputs(torch, prob, st_c, xq)
    _, line = matvec_case(torch, xq32, anchors, coefs, prob.kernel.gamma,
                          "streamed waves, conn route", held=None)
    print(f"main-stream waves: {args.refresh_sweeps} color_sweep refresh sweeps vs plan: max "
          f"|dz| {err_z:.3g}, |dcoef| {err_c:.3g}; knn_fuse: identical selections "
          f"({picks} picks), max |err| {err_knn:.3g}; kernel_matvec {line}")
    t_mv, by_mv, nonzero = matvec_floor(xq32, anchors, coefs)
    g = prob.kernel.gamma
    return dict(
        wave_drop_ms=times["drop"], wave_evict_ms=times["evict"],
        wave_evict_median_ms=float(np.median(times["evict"])),
        wave_arrivals=b * n, evictions=evicted, pairs_checked=checked,
        err_chol_rebuild=err_rebuild, err_chol_sequential=max(chol_errs),
        rebuild_chol_ms=cuda_ms(lambda: streaming.rebuild_chol(prob), reps=5, warmup=1),
        refresh_err_z=err_z, refresh_err_coef=err_c, knn_err=err_knn,
        kernel_matvec_ms=graph_ms(lambda: km.kernel_matvec_batched(xq32, anchors, coefs,
                                                                   gamma=g)),
        kernel_matvec_nonzero_anchors=nonzero, kernel_matvec_bound_ms=t_mv,
        kernel_matvec_bound_by=by_mv,
    )


# ---------------------------------------------------------------------------
# Phase 3c: the join/leave lifecycle.
# ---------------------------------------------------------------------------

CHURN_FLAGS = ["--churn", "16", "--spares", "8"]
# The JAX package's counts on the same flags and seed (its pipeline in
# tests/test_torch_churn_launch.py, run there as a script on the CPU).
REFERENCE_CHURN = {"joins": 15, "leaves": 8, "join_drops": 1, "absorbed": 128, "dropped": 0,
                   "cell_overflows": 0, "skipped_couplings": 0, "dropped_newest": 0}
CHURN_TABLES = ("nbr_idx", "nbr_mask", "plan_z", "plan_coef", "color_members", "color_mask",
                "color_of", "member_pos", "alive")
# what a join -> leave round trip restores (the departed row keeps the
# newcomer's neighbor positions and lambda, which are restored elsewhere)
ROUND_TRIP_TABLES = CHURN_TABLES + ("gram", "stream_pos", "anchor_w")
ROBUST_SWEEPS = 5
EVENT_REPS = 10  # join + leave pairs timed


def churn_args():
    from repro_torch.launch import serve

    argv = stream_args()[0] + CHURN_FLAGS
    return argv, serve.parser().parse_args(argv)


def run_churn_launcher(torch, mods) -> tuple[dict, dict]:
    """The launcher with --stream and --churn, launches counted from 0; then
    the same trace replayed on the plain engines.  Returns (launches, readings)."""
    from repro_torch.analysis import launch_ledger
    from repro_torch.core import streaming
    from repro_torch.launch import serve

    argv, args = churn_args()
    print("main-churn: python -m repro_torch.launch.serve " + " ".join(argv))
    for mod in mods.values():
        mod.launches = 0
    res = serve.main(argv)
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in mods.items()}
    info, prob, state = res["churn"], res["problem"], res["state"]
    print("main-churn: kernel launches " + json.dumps(launches)
          + f" ({res['train_calls']} train calls + 1 stream refresh + {info['refresh_calls']} "
          f"churn refreshes; {info['knn_calls']} churn kNN requests + {serve.TIMED_CALLS})")
    expected = launch_ledger.expected({
        "sweep.colored.cuda": res["train_calls"] + 1 + info["refresh_calls"],
        "serving.knn.cuda": info["knn_calls"] + serve.TIMED_CALLS,
        "kernels.matvec": serve.TIMED_CALLS})
    check(launches == expected, f"main-churn: kernel launches {launches}, expected {expected}")
    check(info["refresh_calls"] == args.churn + args.churn // 2
          and info["knn_calls"] == args.churn, "main-churn: the launcher's round count")
    counts = {key: info[key] for key in REFERENCE_CHURN}
    print(f"main-churn: counts {json.dumps(counts)} (the reference's: "
          f"{json.dumps(REFERENCE_CHURN)}); CUDA library builds during the timed rounds "
          f"{info['builds']}; live degree headroom {json.dumps(info['headroom'])}")
    check(counts == REFERENCE_CHURN, "main-churn: counts differ from the reference's")
    check(info["builds"] == 0, "main-churn: a CUDA library was built during the timed rounds")
    plan = info["plan"]
    recolored = int((prob.color_of[: prob.n] >= prob.recolor_start).sum())
    print(f"main-churn: D={prob.topology.d_max}, {prob.topology.n_colors} colors "
          f"({prob.color_mask.any(1).sum().item()} non-empty, {recolored} rows in recolor "
          f"classes), M={prob.color_members.shape[1]}, query plan K_max={plan.k_max} with "
          f"{int((~plan.cell_mask).sum())} free columns")
    b, q = args.fields, args.queries
    for key in ("knn", "conn"):
        check(res[key].shape == (b, q) and bool(torch.isfinite(res[key]).all()),
              f"main-churn {key}: shape {tuple(res[key].shape)} or non-finite values")
    err_chol = max_err(streaming.rebuild_chol(prob), prob.chol)
    check(prob.chol.is_contiguous() and err_chol <= 1e-4,
          f"main-churn: chol vs rebuild_chol {err_chol:.3g} (tol 1e-4)")

    # the same trace on the plain engines: the tables do not depend on the state
    plain = serve.main(argv + ["--engine", "plan"])
    torch.cuda.synchronize()
    pp, ps = plain["problem"], plain["state"]
    for name in CHURN_TABLES:
        check(torch.equal(getattr(pp, name), getattr(prob, name)),
              f"main-churn: {name} differs from the plain engines' replay")
    check(torch.equal(pp.topology.degrees, prob.topology.degrees),
          "main-churn: degrees differ from the plain engines' replay")
    check({key: plain["churn"][key] for key in REFERENCE_CHURN} == counts,
          "main-churn: counts differ from the plain engines' replay")
    err_z, err_c = max_err(state.z[:, :-1], ps.z[:, :-1]), max_err(state.coef, ps.coef)
    err_knn = max_err(res["knn"], plain["knn"])
    err_conn_e2e = max_err(res["conn"], plain["conn"])
    print(f"main-churn: vs the plain engines' replay: tables equal; max |dz| {err_z:.3g}, "
          f"|dcoef| {err_c:.3g}, knn {err_knn:.3g}, conn {err_conn_e2e:.3g}; chol vs "
          f"rebuild_chol {err_chol:.3g}")
    check(err_z <= STREAM_Z_TOL and err_c <= STREAM_COEF_TOL,
          "main-churn: churned state differs from the plain engines'")
    check(err_knn <= STREAM_KNN_TOL, "main-churn: kNN answers differ from the plain engines'")
    xq32, anchors, coefs = conn_inputs(torch, prob, state, res["xq"])
    _, line = matvec_case(torch, xq32, anchors, coefs, args.gamma, "churned conn route",
                          held=None)
    ins, alive, _ = knn_inputs(torch, prob, state, 4096, seed=17, plan=plan)
    err_kf, sel = compare_knn(torch, ins, alive, prob.kernel.gamma, args.k, "churned plan",
                              witness=True)
    picks = int((sel >= 0).sum())
    print(f"main-churn: kernel_matvec {line}; knn_fuse on the repaired plan: identical "
          f"selections ({picks} picks), max |err| {err_kf:.3g}")
    readings = dict(
        counts=counts, round_ms=info["round_ms"], timed_rounds=info["timed_rounds"],
        recolored_rows=recolored,
        builds=info["builds"], d_max=prob.topology.d_max, n_colors=prob.topology.n_colors,
        k_max=plan.k_max, err_z=err_z, err_coef=err_c, err_knn=err_knn,
        err_conn_e2e=err_conn_e2e, err_chol_rebuild=err_chol, knn_fuse_err=err_kf,
        knn_request_ms=res["knn_s"] * 1e3, conn_request_ms=res["conn_s"] * 1e3,
        # the two lane-bound kernels at the churn geometry (D, spare and recolor classes)
        color_step=time_color_step(torch, prob, args.sweeps),
        color_classes=time_color_classes(torch, prob, state, args.sweeps),
        knn_fuse=time_knn(torch, prob, state, plan=plan),
    )
    return launches, readings


def time_color_classes(torch, prob, state, sweeps: int) -> dict:
    """color_sweep (device ms, graph replay) on the churned problem with every
    class, and with the base classes only: what the spare singletons and the
    recolor classes (empty, or one moved row) cost per step."""
    from repro_torch.kernels import color_step as cs

    n_colors = prob.color_members.shape[0]
    base = n_colors - prob.topology.n_spare - prob.topology.n_recolor
    z, coef = state.z.clone(), state.coef.clone()

    def call(members, mask):
        return lambda: cs.color_sweep(z, coef, prob.nbr_idx, prob.nbr_mask, prob.gram,
                                      prob.chol, prob.lam_pad, prob.alive, prob.alive_z,
                                      members, mask, None, sweeps)

    all_ms = graph_ms(call(prob.color_members, prob.color_mask), reps=10)
    base_ms = graph_ms(call(prob.color_members[:base].contiguous(),
                            prob.color_mask[:base].contiguous()), reps=10)
    extra = sweeps * (n_colors - base)
    return dict(all_ms=all_ms, base_ms=base_ms, classes=n_colors, base_classes=base,
                base_step_us=base_ms / (sweeps * base) * 1e3,
                extra_step_us=(all_ms - base_ms) / extra * 1e3 if extra else None)


def kernel_count(torch, fn) -> int | None:
    """CUDA kernels ``fn`` launches, by torch.profiler (None: nothing traced)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def run_lifecycle(torch, mods) -> dict:
    """On the churn geometry's arrival-free trained problem: a join -> leave
    round trip (restored bitwise), the events' times, and robust_sweep (all
    alive against colored_sweep; a transient death trace: one color_sweep
    launch per sweep, dead rows untouched, against the plan engine)."""
    from repro_torch.core import colored_sweep, init_state, plans, robust_sweep, sn_train
    from repro_torch.core import streaming
    from repro_torch.launch import serve

    _, args = churn_args()
    prob = serve.build_problem(args)
    state = colored_sweep(prob, init_state(prob), n_sweeps=args.sweeps, engine="cuda")
    dev = prob.device
    ys = torch.zeros(args.fields, device=dev)

    # a join that recolors adopters (the first on a grid of positions): the
    # repaired scatter plans equal the host builder's on the new tables,
    # before and after the newcomer leaves again (the moved rows stay moved)
    for x in torch.cartesian_prod(*[torch.linspace(-0.8, 0.8, 5, device=dev)] * 2):
        p2, s2, rec = streaming.add_sensor(prob, state, x, ys, lam=args.lam)
        moved = int((p2.color_of[: prob.n] != prob.color_of[: prob.n]).sum())
        if moved:
            break
    check(moved > 0, "main-churn recolor: no join on the grid recolored an adopter")
    p3, _, _ = streaming.remove_sensor(p2, s2, rec.slot)
    for label, p in (("join", p2), ("leave", p3)):
        host = lambda t: t.cpu().numpy()  # noqa: E731
        pz, pc = plans.build_color_plans(host(p.color_members), host(p.color_mask),
                                         host(p.nbr_idx), p.n_stream, host(p.alive))
        check(np.array_equal(pz, host(p.plan_z)) and np.array_equal(pc, host(p.plan_coef)),
              f"main-churn recolor: the {label}'s plans differ from the host builder's")
    print(f"main-churn recolor: join at ({float(x[0]):.1f}, {float(x[1]):.1f}) moved {moved} "
          f"adopters into recolor classes; plans equal the host builder's after the join "
          f"and after the leave")

    # join -> leave without recoloring: every table and the state come back
    x = torch.tensor([0.1, 0.2], device=dev)
    p2, s2, rec = streaming.add_sensor(prob, state, x, ys, lam=args.lam)
    p3, s3, ok = streaming.remove_sensor(p2, s2, rec.slot)
    torch.cuda.synchronize()
    check(bool(rec.joined) and bool(ok), "main-churn round trip: the join or the leave failed")
    check(torch.equal(p2.color_of, prob.color_of), "main-churn round trip: the join recolored")
    adopted = int(rec.adopted_mask.sum())
    for name in ROUND_TRIP_TABLES:
        check(torch.equal(getattr(p3, name), getattr(prob, name)),
              f"main-churn round trip: {name} not restored")
    rest = torch.arange(prob.n + 1, device=dev) != rec.slot
    check(torch.equal(p3.nbr_pos[:, rest], prob.nbr_pos[:, rest])
          and torch.equal(p3.lam_pad[rest], prob.lam_pad[rest]),
          "main-churn round trip: nbr_pos or lam_pad not restored")
    check(torch.equal(p3.topology.degrees, prob.topology.degrees)
          and torch.equal(s3.z[:, :-1], state.z[:, :-1]) and torch.equal(s3.coef, state.coef),
          "main-churn round trip: degrees or state not restored")
    chol_err = max_err(p3.chol, prob.chol)
    chol_bitwise = torch.equal(p3.chol, prob.chol)
    check(chol_err <= 1e-6, f"main-churn round trip: chol {chol_err:.3g} from the build's")
    print(f"main-churn round trip: join at (0.1, 0.2) adopted {adopted} rows; the leave "
          f"restored every table and the state bitwise; chol "
          f"{'bitwise' if chol_bitwise else f'max |err| {chol_err:.3g}'}")

    # the events' times (donated, as the launcher runs them), join + leave pairs
    pt, st = p3, s3
    ev = {"add_sensor": [], "remove_sensor": []}
    host = {"add_sensor": [], "remove_sensor": []}
    for _ in range(EVENT_REPS + 1):
        for name in ("add_sensor", "remove_sensor"):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            if name == "add_sensor":
                pt, st, rec = streaming.add_sensor(pt, st, x, ys, lam=args.lam, donate=True)
            else:
                pt, st, _ = streaming.remove_sensor(pt, st, rec.slot, donate=True)
            end.record()
            torch.cuda.synchronize()
            host[name].append((time.perf_counter() - t0) * 1e3)
            ev[name].append(start.elapsed_time(end))
    held = {}

    def join():
        held["out"] = streaming.add_sensor(pt, st, x, ys, lam=args.lam, donate=True)

    launches_add = kernel_count(torch, join)
    pt, st, rec = held["out"]

    def leave():
        held["out"] = streaming.remove_sensor(pt, st, rec.slot, donate=True)

    launches_remove = kernel_count(torch, leave)
    events = {name: dict(events_ms=float(np.median(ev[name][1:])),
                         host_ms=float(np.median(host[name][1:])),
                         events_ms_range=[min(ev[name][1:]), max(ev[name][1:])])
              for name in ev}
    events["add_sensor"]["kernels"] = launches_add
    events["remove_sensor"]["kernels"] = launches_remove
    print("main-churn events: " + json.dumps(events))

    # robust_sweep: all alive on the arrival-free problem equals colored_sweep
    ones = torch.ones(prob.n, dtype=torch.bool, device=dev)
    r = robust_sweep(prob, state, ones, n_sweeps=ROBUST_SWEEPS, engine="cuda")
    c = colored_sweep(prob, state, n_sweeps=ROBUST_SWEEPS, engine="cuda")
    _, chol_all = sn_train._masked_factors(prob, prob.nbr_mask, prob.gram, prob.alive)
    torch.cuda.synchronize()
    same = torch.equal(r.z, c.z) and torch.equal(r.coef, c.coef)
    gap = (max_err(r.z, c.z), max_err(r.coef, c.coef))
    factors_same = torch.equal(chol_all, prob.chol)
    print(f"main-churn robust: all alive vs colored_sweep ({ROBUST_SWEEPS} sweeps, cuda): "
          f"{'bitwise' if same else f'max |dz| {gap[0]:.3g}, |dcoef| {gap[1]:.3g}'}; refactored "
          f"factors {'bitwise the cached ones' if factors_same else 'differ from the cached'}")
    check(same or (gap[0] <= STREAM_Z_TOL and gap[1] <= STREAM_COEF_TOL),
          "main-churn robust: all-alive sweep differs from colored_sweep")

    # a transient death trace: 20% of the base rows down per sweep, 10 of them
    # down throughout
    rng = np.random.default_rng(23)
    alive_np = rng.random((ROBUST_SWEEPS, prob.n)) > 0.2
    alive_np[:, rng.choice(prob.n_base, 10, replace=False)] = False
    alive_np[:, prob.n_base:] = False
    alive_t = torch.as_tensor(alive_np, device=dev)
    mods["color_step"].launches = 0
    rc = robust_sweep(prob, state, alive_t, n_sweeps=ROBUST_SWEEPS, engine="cuda")
    torch.cuda.synchronize()
    n_launch = mods["color_step"].launches
    check(n_launch == ROBUST_SWEEPS,
          f"main-churn robust: {n_launch} color_sweep launches for {ROBUST_SWEEPS} sweeps")
    rp = robust_sweep(prob, state, alive_t, n_sweeps=ROBUST_SWEEPS, engine="plan")
    dead = torch.as_tensor(~alive_np.any(axis=0), device=dev)
    dead_rows = torch.nonzero(dead[: prob.n_base])[:, 0]
    check(torch.equal(rc.coef[:, dead_rows], state.coef[:, dead_rows])
          and torch.equal(rc.z[:, dead_rows], state.z[:, dead_rows]),
          "main-churn robust: a dead row's coefficients or message changed")
    err_rz, err_rc = max_err(rc.z[:, :-1], rp.z[:, :-1]), max_err(rc.coef, rp.coef)
    check(err_rz <= STREAM_Z_TOL and err_rc <= STREAM_COEF_TOL,
          f"main-churn robust: cuda vs plan |dz| {err_rz:.3g}, |dcoef| {err_rc:.3g}")
    alive_row = prob.alive & torch.cat([alive_t[0], torch.ones(1, dtype=torch.bool, device=dev)])
    gram_eff, chol_eff = sn_train._masked_factors(prob, prob.nbr_mask, prob.gram, alive_row)
    timing = dict(
        per_sweep_ms=cuda_ms(lambda: robust_sweep(prob, state, alive_t, n_sweeps=ROBUST_SWEEPS,
                                                  engine="cuda"), reps=5, warmup=1)
        / ROBUST_SWEEPS,
        refactor_ms=cuda_ms(lambda: sn_train._masked_factors(prob, prob.nbr_mask, prob.gram,
                                                             alive_row), reps=10),
        launch_ms=cuda_ms(lambda: sn_train._colored_core(
            prob, prob.nbr_mask, gram_eff, chol_eff, state.z, state.coef, 1, "cuda",
            alive=alive_row), reps=10),
    )
    print(f"main-churn robust: {ROBUST_SWEEPS}-sweep transient death trace "
          f"({len(dead_rows)} rows down throughout): {n_launch} color_sweep launches, dead rows "
          f"untouched, vs plan |dz| {err_rz:.3g}, |dcoef| {err_rc:.3g}; " + json.dumps(timing))
    return dict(adopted=adopted, recolored=moved, round_trip_chol_bitwise=chol_bitwise,
                round_trip_chol_err=chol_err, events=events, robust_all_alive_bitwise=same,
                robust_all_alive_gap=gap, robust_factors_bitwise=factors_same,
                robust_launches=n_launch, robust_err_z=err_rz, robust_err_coef=err_rc,
                robust=timing)


# ---------------------------------------------------------------------------
# Phase 3d: training under unreliable links.
# ---------------------------------------------------------------------------

FAULT_SPECS = {
    "bursty": "drop=0.1,burst=0.05:0.4:0.5",  # the reference README's example
    "crash": "drop=0.1,crash=0.01:0.25",  # the reference parse_fault_spec's example
}
FAULT_ROUND = 5  # --refresh_sweeps: sweeps per watchdog round
FAULT_RATES = (0.0, 0.05, 0.1, 0.3, 0.6, 0.9)  # the identities' rate grid
SAMPLER_SWEEPS = 30  # the sampler's statistics over (30, n+1, D) lanes
# the reference's acceptance: watch to tol 1e-3 in up to 40 rounds of 5
# sweeps, and the kNN-fused (k = 3) RMSE at 10% drops within 2x of
# fault-free (benchmarks/fault_bench.py:20-21, 153-154)
ACCEPT_TOL, ACCEPT_ROUNDS, ACCEPT_DROP, ACCEPT_RATIO = 1e-3, 40, 0.1, 2.0
SERIAL_SWEEPS = 2
RECEIPT_INTS = ("rounds", "sweeps", "retries", "refactorized", "rolled_back")


def faults_args(spec: str):
    from repro_torch.launch import serve

    argv = main_args()[0] + ["--refresh_sweeps", str(FAULT_ROUND), "--faults", spec]
    return argv, serve.parser().parse_args(argv)


def replay_rounds(torch, prob, spec: str, seed: int, rounds: int):
    """The launcher's supervised rounds replayed with a generator of the
    same seed (for a run with no retry, refactorization or rollback):
    (the smallest distance of a round's per-field norm growth from the
    watchdog's divergence ratio, the largest growth, the final state)."""
    from repro_torch.core import faults, init_state, monitor, weighted_norm_sq

    dev = prob.device
    model = faults.parse_fault_spec(spec, device=dev)
    g = _gen(torch, dev, seed)
    ratio = monitor.WatchdogConfig().divergence_ratio
    state = init_state(prob)
    norm = weighted_norm_sq(prob, state)
    margin, growth = float("inf"), 0.0
    for _ in range(rounds):
        state = faults.faulty_sweep(prob, state, model, g, FAULT_ROUND, engine="cuda")
        new = weighted_norm_sq(prob, state)
        margin = min(margin, float((new / norm - ratio).abs().min()))
        growth = max(growth, float((new / norm).max()))
        norm = new
    return margin, growth, state


def run_faults_launcher(torch, mods, name: str) -> tuple[dict, dict]:
    """The launcher under --faults, launches counted from 0: color_step once
    per round (crash-free) or once per sweep (crash model), the requests'
    kernels TIMED_CALLS each; then the same run on the plain engines with a
    generator of the same seed (the same masks): receipt integers equal,
    states at the long-chain bound, answers as the main phase holds them.
    Returns (launches, readings)."""
    from repro_torch.analysis import launch_ledger
    from repro_torch.launch import serve

    argv, args = faults_args(FAULT_SPECS[name])
    print("main-faults: python -m repro_torch.launch.serve " + " ".join(argv))
    for mod in mods.values():
        mod.launches = 0
    res = serve.main(argv)
    torch.cuda.synchronize()
    launches = {key: mod.launches for key, mod in mods.items()}
    rec = res["watchdog"]
    crash = name == "crash"
    per = rec.sweeps if crash else rec.rounds
    print(f"main-faults {name}: kernel launches " + json.dumps(launches)
          + f" ({rec.rounds} rounds, {rec.sweeps} sweeps: one color_sweep launch per "
          + ("sweep)" if crash else "round)"))
    # faulty_sweep launches once per call (a round) crash-free, once per
    # sweep with a crash model
    expected = launch_ledger.expected({("faults.crash.cuda" if crash else "faults.cuda"): per,
                                       "serving.knn.cuda": serve.TIMED_CALLS,
                                       "kernels.matvec": serve.TIMED_CALLS})
    check(launches == expected,
          f"main-faults {name}: kernel launches {launches}, expected {expected}")
    check(rec.sweeps == rec.rounds * FAULT_ROUND and res["train_calls"] == rec.rounds,
          f"main-faults {name}: receipt {rec.to_json()} against {res['train_calls']} calls")
    b, q = args.fields, args.queries
    for key in ("knn", "conn"):
        check(res[key].shape == (b, q) and bool(torch.isfinite(res[key]).all()),
              f"main-faults {name} {key}: shape {tuple(res[key].shape)} or non-finite values")
    # the watchdog's decisions are thresholds: the run must keep clear of them
    check(rec.retries == 0 and rec.refactorized == 0 and not rec.rolled_back,
          f"main-faults {name}: the watchdog acted: {rec.to_json()}")
    margin, growth, replayed = replay_rounds(torch, res["problem"], FAULT_SPECS[name],
                                             args.seed + 1, rec.rounds)
    check(torch.equal(replayed.z, res["state"].z) and torch.equal(replayed.coef,
                                                                  res["state"].coef),
          f"main-faults {name}: a replay with the same seed differs from the launcher's run")
    check(margin > 1e-3, f"main-faults {name}: a round's norm growth is {margin:.3g} from "
          f"the divergence ratio")
    print(f"main-faults {name}: the seeded rounds replay bitwise; largest per-round norm "
          f"growth {growth:.6g}, nearest the divergence ratio by {margin:.3g}")

    plain = serve.main(argv + ["--engine", "plan"])
    torch.cuda.synchronize()
    pr = plain["watchdog"]
    for key in RECEIPT_INTS:
        check(getattr(pr, key) == getattr(rec, key),
              f"main-faults {name}: receipt {key} {getattr(rec, key)} != the plain "
              f"replay's {getattr(pr, key)}")
    check(np.array_equal(pr.converged, rec.converged)
          and np.array_equal(pr.diverged, rec.diverged),
          f"main-faults {name}: per-field flags differ from the plain replay")
    state, ps = res["state"], plain["state"]
    err_z, err_c = max_err(state.z[:, :-1], ps.z[:, :-1]), max_err(state.coef, ps.coef)
    err_knn, err_conn = max_err(res["knn"], plain["knn"]), max_err(res["conn"], plain["conn"])
    print(f"main-faults {name}: vs the plain engines' replay: receipt integers equal; max "
          f"|dz| {err_z:.3g}, |dcoef| {err_c:.3g}, knn {err_knn:.3g}, conn {err_conn:.3g}; "
          f"max residual / tol {float(np.max(rec.residual)) / args.watch_tol:.3g}")
    check(err_z <= STREAM_Z_TOL and err_c <= STREAM_COEF_TOL,
          f"main-faults {name}: supervised state differs from the plain engines'")
    check(err_knn <= 2e-4, f"main-faults {name}: kNN answers differ from the plain engines'")
    check(err_conn <= 2e-5, f"main-faults {name}: conn answers differ from the plain engines'")
    readings = dict(receipt=rec.to_json(), growth_max=growth, threshold_margin=margin,
                    train_s=res["train_s"],
                    round_ms=res["train_s"] / rec.rounds * 1e3,
                    plain_train_s=plain["train_s"], err_z=err_z, err_coef=err_c,
                    err_knn=err_knn, err_conn=err_conn, knn_request_ms=res["knn_s"] * 1e3,
                    conn_request_ms=res["conn_s"] * 1e3)
    return launches, readings


def _gen(torch, dev, seed: int):
    return torch.Generator(device=dev).manual_seed(seed)


def check_fault_identities(torch, mods, prob, state) -> dict:
    """drop=0 is colored_sweep bitwise, drop=1 freezes z bitwise while coef
    moves, and the rate grid builds nothing and launches once per call."""
    from repro_torch.core import colored_sweep, faults
    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    dev = prob.device
    model = lambda p: faults.make_fault_model(p, device=dev)  # noqa: E731
    a = faults.faulty_sweep(prob, state, model(0.0), _gen(torch, dev, 7), FAULT_ROUND,
                            engine="cuda")
    c = colored_sweep(prob, state, FAULT_ROUND, engine="cuda")
    check(torch.equal(a.z, c.z) and torch.equal(a.coef, c.coef),
          "main-faults identities: drop=0 differs from colored_sweep")
    o = faults.faulty_sweep(prob, state, model(1.0), _gen(torch, dev, 7), FAULT_ROUND,
                            engine="cuda")
    check(torch.equal(o.z, state.z) and not torch.equal(o.coef, state.coef),
          "main-faults identities: drop=1 moved z or froze coef")
    builds0 = _build.builds
    per_call = []
    for p in FAULT_RATES:
        mods["color_step"].launches = 0
        faults.faulty_sweep(prob, state, model(p), _gen(torch, dev, 7), FAULT_ROUND,
                            engine="cuda")
        serve._sync(dev)
        per_call.append(mods["color_step"].launches)
    built = _build.builds - builds0
    check(built == 0 and per_call == [1] * len(FAULT_RATES),
          f"main-faults identities: {built} library builds, launches per call {per_call}")
    print(f"main-faults identities (cuda engine, {FAULT_ROUND} sweeps): drop=0 == "
          f"colored_sweep bitwise; drop=1 leaves z bitwise and moves coef; rates "
          f"{list(FAULT_RATES)}: {built} CUDA library builds, launches per call {per_call}")
    return dict(grid_builds=built, grid_launches=per_call)


def check_sampler(torch, prob) -> dict:
    """The fault process's statistics over (SAMPLER_SWEEPS, n+1, D) lanes, to
    the reference's thresholds (tests/test_faults.py:140-203) and the closed
    forms: i.i.d. and stationary delivered fractions within 0.01, bursts
    (P(drop | dropped last sweep) > 1.5 x the marginal), monotone coupling
    under one seed, the crash chain's up share after burn-in within 0.02 of
    restart / (crash + restart)."""
    from repro_torch.core import faults

    dev = prob.device
    lanes, t = tuple(prob.nbr_idx.shape), SAMPLER_SWEEPS
    mk = lambda *a, **k: faults.make_fault_model(*a, device=dev, **k)  # noqa: E731
    masks = lambda m, seed: faults.link_masks(m, _gen(torch, dev, seed), t, lanes)  # noqa: E731
    out = {}
    low, high = masks(mk(0.1), 11), masks(mk(0.4), 11)
    for p, m in ((0.1, low), (0.4, high)):
        out[f"iid_{p}"] = got = float(m.double().mean())
        check(abs(got - (1 - p)) <= 0.01, f"main-faults sampler: i.i.d. p={p} delivered {got}")
    out["coupling_violations"] = bad = int((high & ~low).sum())
    check(bad == 0, f"main-faults sampler: {bad} lanes delivered at p=0.4 but not at 0.1")
    for label, drop, burst in (("readme", 0.1, (0.05, 0.4, 0.5)),
                               ("reference_test", 0.02, (0.05, 0.3, 0.7))):
        m = masks(mk(drop, burst=burst), 12)
        pi_bad = burst[0] / (burst[0] + burst[1])
        want = (1 - drop) * (1 - pi_bad * burst[2])
        got = float(m.double().mean())
        dropped = ~m
        marginal = float(dropped.double().mean())
        cond = float(dropped[1:][dropped[:-1]].double().mean())
        out[f"bursty_{label}"] = dict(delivered=got, closed_form=want, marginal_drop=marginal,
                                      drop_after_drop=cond)
        check(abs(got - want) <= 0.01,
              f"main-faults sampler: {label} stationary delivered {got}, closed form {want}")
        if label == "reference_test":
            check(cond > 1.5 * marginal, f"main-faults sampler: bursts {cond} vs {marginal}")
    trace = faults.crash_schedule(mk(0.0, crash=(0.3, 0.5)), _gen(torch, dev, 17), t, prob.n)
    up = float(trace[10:].double().mean())
    came_back = bool((~trace[:-1] & trace[1:]).any())
    out["crash_up_share"] = up
    check(abs(up - 0.5 / 0.8) <= 0.02 and came_back,
          f"main-faults sampler: crash chain up share {up} (want {0.5 / 0.8}), "
          f"restarts {came_back}")
    print("main-faults sampler (" + " x ".join(map(str, (t,) + lanes)) + " lanes): "
          + json.dumps(out))
    return out


def _bits(torch, t):
    """The tensor's bytes as integers: a bitwise comparison NaN cannot defeat."""
    return t.contiguous().view({4: torch.int32, 8: torch.int64}[t.element_size()])


def run_ladder(torch, prob, state) -> dict:
    """From a NaN-poisoned state the watchdog retries 3 times, refactorizes
    once and rolls back: the entry state and factors come back bitwise, once
    from the in-memory snapshot and once through a checkpoint directory."""
    from repro_torch.core import SNTrainState, faults, monitor
    from repro_torch.launch import serve

    dev = prob.device
    z = state.z.clone()
    z[0, 0] = float("nan")
    bad = SNTrainState(z=z, coef=state.coef.clone())
    cfg = monitor.WatchdogConfig(max_rounds=14)
    model = faults.make_fault_model(0.05, device=dev)
    out = {}
    for where in ("memory", "disk"):
        with tempfile.TemporaryDirectory() as d:
            serve._sync(dev)
            t0 = time.perf_counter()
            p2, s2, rec = monitor.watch_sweeps(
                prob, bad, model=model, generator=_gen(torch, dev, 3), engine="cuda",
                config=cfg, snapshot_dir=None if where == "memory" else os.path.join(d, "wd"))
            serve._sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
        check(rec.retries == cfg.max_retries and rec.refactorized == 1 and rec.rolled_back,
              f"main-faults ladder ({where}): receipt {rec.to_json()}")
        check(torch.equal(_bits(torch, s2.z), _bits(torch, bad.z))
              and torch.equal(_bits(torch, s2.coef), _bits(torch, bad.coef))
              and torch.equal(p2.chol, prob.chol),
              f"main-faults ladder ({where}): the entry state or factors not restored bitwise")
        out[where] = dict(ms=ms, rounds=rec.rounds, sweeps=rec.sweeps)
        print(f"main-faults ladder ({where}): {monitor.format_receipt(rec)}; entry state "
              f"and factors restored bitwise (NaN included) in {ms:.1f} ms")
    return out


def run_checkpoint(torch, prob, state) -> dict:
    """save_train / restore_train of the full problem and state: every leaf
    back bitwise, on its device in its dtype; save and restore times."""
    from repro_torch import checkpoint
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import serve

    dev = prob.device
    save_ms, restore_ms = [], []
    with tempfile.TemporaryDirectory() as d:
        for step in range(3):
            serve._sync(dev)
            t0 = time.perf_counter()
            checkpoint.save_train(d, step, prob, state)
            save_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            p2, s2 = checkpoint.restore_train(d, step, prob, state)
            serve._sync(dev)
            restore_ms.append((time.perf_counter() - t0) * 1e3)
        nbytes = os.path.getsize(os.path.join(d, "step_00000000", "arrays.npz"))
        check(checkpoint.latest_step(d) == 2, "main-faults checkpoint: latest_step")
    want = list(ckpt._items({"problem": prob, "state": state}))
    got = list(ckpt._items({"problem": p2, "state": s2}))
    check(len(want) == len(got), "main-faults checkpoint: leaf count")
    for (path, a), (_, b) in zip(want, got):
        check(a.device == b.device and a.dtype == b.dtype and a.shape == b.shape
              and torch.equal(a, b), f"main-faults checkpoint: {path[:-1]} not restored bitwise")
    out = dict(bytes=nbytes, leaves=len(want), save_ms=save_ms, restore_ms=restore_ms)
    print(f"main-faults checkpoint: {len(want)} leaves, {nbytes} bytes of npz, bitwise round "
          f"trip on {dev}; save_train {np.median(save_ms):.1f} ms, restore_train "
          f"{np.median(restore_ms):.1f} ms (median of 3)")
    return out


def launcher_truth(torch, args, dev):
    """The launcher's noiseless fields at the sensor sites: its seeded
    freq/phase draws (serve.build_problem) without the noise."""
    from repro_torch.core import uniform_sensors

    rng = np.random.default_rng(args.seed)
    pos = uniform_sensors(args.sensors, d=args.dim, seed=args.seed)
    freq = rng.uniform(0.5, 2.0, size=(args.fields, 1))
    phase = rng.uniform(0, 2 * np.pi, size=(args.fields, 1))
    return torch.as_tensor(np.sin(np.pi * freq * pos[None, :, 0] + phase), device=dev)


def run_acceptance(torch, prob, args) -> dict:
    """The reference's acceptance on the launcher's problem: watched to tol
    1e-3 in up to 40 rounds of 5 sweeps, fault-free and at 10% drops, the
    kNN-fused (k = 3) RMSE at the sensor sites against the noiseless
    fields within 2x of fault-free."""
    from repro_torch.core import faults, fusion, init_state, make_serving_plan, monitor
    from repro_torch.launch import serve

    dev = prob.device
    truth = launcher_truth(torch, args, dev)
    sites = prob.topology.positions[: args.sensors]
    plan = make_serving_plan(prob, k=3)
    cfg = monitor.WatchdogConfig(sweeps_per_round=FAULT_ROUND, tol=ACCEPT_TOL,
                                 max_rounds=ACCEPT_ROUNDS)
    out = {}
    for drop in (0.0, ACCEPT_DROP):
        serve._sync(dev)
        t0 = time.perf_counter()
        p2, s2, rec = monitor.watch_sweeps(
            prob, init_state(prob), model=faults.make_fault_model(drop, device=dev),
            generator=_gen(torch, dev, 1), engine="cuda", config=cfg)
        serve._sync(dev)
        dt = time.perf_counter() - t0
        fused = fusion.fuse(p2, s2, sites, "knn", k=3, engine="cuda", plan=plan)
        rmse = torch.sqrt(torch.mean((fused.double() - truth) ** 2, dim=-1)).cpu().numpy()
        check(bool(np.isfinite(rmse).all()) and not rec.rolled_back,
              f"main-faults acceptance drop={drop}: {rec.to_json()}")
        out[str(drop)] = dict(rmse_mean=float(rmse.mean()), rmse_max=float(rmse.max()),
                              sweeps=rec.sweeps, rounds=rec.rounds,
                              converged=int(rec.converged.sum()), retries=rec.retries,
                              seconds=dt, ms_per_sweep=dt / rec.sweeps * 1e3)
    ratio = out[str(ACCEPT_DROP)]["rmse_mean"] / out["0.0"]["rmse_mean"]
    out["ratio"] = ratio
    print(f"main-faults acceptance: kNN-fused RMSE at the sensor sites, fault-free "
          f"{out['0.0']['rmse_mean']:.5g} in {out['0.0']['sweeps']} sweeps "
          f"({out['0.0']['converged']}/{args.fields} converged), drop={ACCEPT_DROP} "
          f"{out[str(ACCEPT_DROP)]['rmse_mean']:.5g} in {out[str(ACCEPT_DROP)]['sweeps']} "
          f"sweeps ({out[str(ACCEPT_DROP)]['converged']}/{args.fields}); ratio {ratio:.4g} "
          f"(acceptance <= {ACCEPT_RATIO})")
    check(ratio <= ACCEPT_RATIO, f"main-faults acceptance: RMSE ratio {ratio}")
    return out


def run_serial_engines(torch, prob, state) -> dict:
    """The single-field serial engines on field 0, SERIAL_SWEEPS sweeps each:
    all-alive links and unit weights equal serial_sweep (z 1e-5, coef 1e-3),
    random orderings and weighted sweeps Fejer monotone to the reference's
    slack (tests/test_sn_train.py), and ms per sweep."""
    from repro_torch.core import (field_view, random_sweep, robust_sweep_links, serial_sweep,
                                  weighted_norm_sq, weighted_norm_sq_hetero, weighted_sweep)
    from repro_torch.launch import serve

    dev = prob.device
    pv, sv = field_view(prob, state, 0)
    n, d = pv.n, pv.nbr_idx.shape[1]
    ms = {}

    def timed(name, fn):
        serve._sync(dev)
        t0 = time.perf_counter()
        out = fn()
        serve._sync(dev)
        ms[name] = (time.perf_counter() - t0) / SERIAL_SWEEPS * 1e3
        return out

    t = SERIAL_SWEEPS
    ser = timed("serial_sweep", lambda: serial_sweep(pv, sv, t))
    rnd = timed("random_sweep", lambda: random_sweep(pv, sv, _gen(torch, dev, 5), t))
    ones = torch.ones((t, n, d), dtype=torch.bool, device=dev)
    links = timed("robust_sweep_links", lambda: robust_sweep_links(pv, sv, ones, t))
    trace = torch.as_tensor(np.random.default_rng(19).random((t, n, d)) > 0.2, device=dev)
    lossy = timed("robust_sweep_links_20pct", lambda: robust_sweep_links(pv, sv, trace, t))
    unit = timed("weighted_sweep", lambda: weighted_sweep(pv, sv, torch.ones(n, device=dev), t))
    errs = {}
    for name, got in (("links", links), ("weights", unit)):
        errs[name] = (max_err(got.z, ser.z), max_err(got.coef, ser.coef))
        check(errs[name][0] <= 1e-5 and errs[name][1] <= 1e-3,
              f"main-faults serial: {name} vs serial_sweep |dz| {errs[name][0]:.3g}, "
              f"|dcoef| {errs[name][1]:.3g}")
    check(all(bool(torch.isfinite(s.z).all()) for s in (rnd, lossy)),
          "main-faults serial: non-finite random or lossy-link sweep")
    fejer = lambda cur, prev: cur <= prev * 1.03 + 1e-5  # noqa: E731
    norms = [float(weighted_norm_sq(pv, sv)), float(weighted_norm_sq(pv, rnd))]
    check(fejer(norms[1], norms[0]), f"main-faults serial: random_sweep norm {norms}")
    w = torch.as_tensor(np.random.default_rng(0).uniform(0.2, 5.0, n), dtype=sv.z.dtype,
                        device=dev)
    st, hetero = sv, [float(weighted_norm_sq_hetero(pv, sv, w))]
    for _ in range(t):
        st = weighted_sweep(pv, st, w, 1)
        hetero.append(float(weighted_norm_sq_hetero(pv, st, w)))
    check(all(fejer(c, p) for p, c in zip(hetero, hetero[1:])),
          f"main-faults serial: reweighted norm grew {hetero}")
    print(f"main-faults serial engines (field 0, n={n}, D={d}, {t} sweeps): all-alive "
          f"links vs serial |dz| {errs['links'][0]:.3g}, unit weights |dz| "
          f"{errs['weights'][0]:.3g}; random_sweep norm {norms[0]:.6g} -> {norms[1]:.6g}; "
          f"reweighted norm {[round(v, 6) for v in hetero]}; ms per sweep " + json.dumps(ms))
    return dict(ms_per_sweep=ms, err_links=errs["links"], err_weights=errs["weights"],
                random_norms=norms, hetero_norms=hetero)


def time_fault_round(torch, prob, state) -> dict:
    """One crash-free round's parts (sampling, one 5-sweep color_sweep launch
    with the masks, the metrics and their one host read) and one crash round
    (its 5 refactors and 5 launches), by CUDA events."""
    from repro_torch.core import colored_sweep, faults, monitor, sn_train

    dev = prob.device
    free = faults.parse_fault_spec(FAULT_SPECS["bursty"], device=dev)
    crash = faults.parse_fault_spec(FAULT_SPECS["crash"], device=dev)
    g = _gen(torch, dev, 29)
    deliv, _ = faults.sample_faults(free, g, FAULT_ROUND, prob)
    cand = colored_sweep(prob, state, FAULT_ROUND, engine="cuda", delivered=deliv)
    deliv_c, alive_tn = faults.sample_faults(crash, g, FAULT_ROUND, prob)
    alive_row = prob.alive & torch.cat([alive_tn[0], torch.ones(1, dtype=torch.bool,
                                                                device=dev)])
    gram_eff, chol_eff = sn_train._masked_factors(prob, prob.nbr_mask, prob.gram, alive_row)
    return dict(
        round_ms=cuda_ms(lambda: faults.faulty_sweep(prob, state, free, g, FAULT_ROUND,
                                                     engine="cuda"), reps=10),
        sample_ms=cuda_ms(lambda: faults.sample_faults(free, g, FAULT_ROUND, prob), reps=10),
        sweep_launch_ms=cuda_ms(lambda: colored_sweep(prob, state, FAULT_ROUND, engine="cuda",
                                                      delivered=deliv), reps=10),
        metrics_read_ms=cuda_ms(lambda: monitor._host(monitor._round_metrics(prob, state,
                                                                             cand)), reps=10),
        crash_round_ms=cuda_ms(lambda: faults._faulty(prob, state, crash, deliv_c, alive_tn,
                                                      FAULT_ROUND, "cuda"), reps=5, warmup=1),
        crash_sample_ms=cuda_ms(lambda: faults.sample_faults(crash, g, FAULT_ROUND, prob),
                                reps=10),
        refactor_ms=cuda_ms(lambda: sn_train._masked_factors(prob, prob.nbr_mask, prob.gram,
                                                             alive_row), reps=10),
        one_sweep_launch_ms=cuda_ms(lambda: sn_train._colored_core(
            prob, prob.nbr_mask, gram_eff, chol_eff, state.z, state.coef, 1, "cuda",
            alive=alive_row, delivered=deliv_c[:1]), reps=10),
    )


def run_faults_checks(torch, mods) -> dict:
    """Phase 3d after the launcher runs, on the launcher's problem and its
    30-sweep trained state."""
    from repro_torch.core import colored_sweep, init_state
    from repro_torch.launch import serve

    _, args = faults_args(FAULT_SPECS["bursty"])
    prob = serve.build_problem(args)
    state = colored_sweep(prob, init_state(prob), n_sweeps=args.sweeps, engine="cuda")
    out = dict(identities=check_fault_identities(torch, mods, prob, state),
               sampler=check_sampler(torch, prob),
               ladder=run_ladder(torch, prob, state),
               checkpoint=run_checkpoint(torch, prob, state),
               acceptance=run_acceptance(torch, prob, args),
               serial=run_serial_engines(torch, prob, state),
               round=time_fault_round(torch, prob, state))
    print("main-faults round split: " + json.dumps(out["round"]))
    return out


# ---------------------------------------------------------------------------
# Phase 3e: the serving daemon, with representer pruning.
# ---------------------------------------------------------------------------

# The reference daemon bench's traffic (benchmarks/daemon_bench.py:96-138),
# scaled to the churned field geometry: per tick 4 requests of 1-256 rows
# uniform in [-1, 1]^2 and 1-32 arrivals, a join or a leave every 4th tick
# (alternating), 16 clean ticks, 8 under 10% link drops (its EPISODE_DROP)
# and 4 clean; a checkpoint every 4 ticks.
DAEMON_PHASES = ((16, 0.0), (8, 0.1), (4, 0.0))  # (ticks, drop rate)
DAEMON_REQUESTS, DAEMON_MAX_ROWS, DAEMON_ARRIVALS = 4, 256, 32
DAEMON_CHURN_EVERY, DAEMON_CKPT_EVERY = 4, 4
DAEMON_REPLAY_TICKS = 8  # replayed through a daemon with plan engines
DAEMON_EPISODE_REPLAY = 4  # the fault episode's first ticks, replayed likewise
DAEMON_PRUNE_Q = 0.1  # energy_tau: this quantile of the live energies at the first publish
DAEMON_SLO = 3.0  # the reference's fault-episode p99 budget (printed, not gated)
DAEMON_GRID = 64  # 64 x 64 = 4096 queries held to answer_bound
DAEMON_CLI = ["--device", "cuda", "--sensors", "16", "--fields", "2", "--ckpt-every", "1",
              "--queries-per-tick", "1", "--arrivals-per-tick", "4"]
TICK_INTS = ("tick", "published", "degraded", "version", "absorbed", "arrival_drops",
             "arrivals_rolled_back", "joins", "leaves", "ckpt_step")
# the receipt integers that do not count ticks, versions or checkpoints: a
# replay started mid-run compares these
TICK_WORK_INTS = ("published", "degraded", "absorbed", "arrival_drops", "arrivals_rolled_back",
                  "joins", "leaves")
WATCHDOG_INTS = ("converged", "rounds", "sweeps", "retries", "refactorized", "rolled_back",
                 "diverged")


def snapshot_digest(snap) -> str:
    """sha256 of everything a published snapshot serves from: the state
    digest (problem and state), the plan's tables, ``ecoef`` and the prune
    mask."""
    import hashlib

    from repro_torch.launch import daemon

    h = hashlib.sha256(daemon._state_digest(snap.problem, snap.state).encode())
    for t in (snap.plan.cells, snap.plan.cell_mask, snap.ecoef, snap.keep):
        if t is not None:
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def daemon_traffic(args, prob, seed: int = 0) -> list:
    """Per tick: (requests, arrivals, event, drop rate), drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    b, n, d = args.fields, prob.n_base, args.dim
    pos = prob.topology.positions[:n].cpu().numpy()
    out, t = [], 0
    for ticks, drop in DAEMON_PHASES:
        for _ in range(ticks):
            reqs = [rng.uniform(-1, 1, size=(int(rng.integers(1, DAEMON_MAX_ROWS + 1)), d))
                    .astype(np.float32) for _ in range(DAEMON_REQUESTS)]
            a = int(rng.integers(1, DAEMON_ARRIVALS + 1))
            ss = rng.integers(0, n, size=a)
            arrivals = (rng.integers(0, b, size=a), ss,
                        (pos[ss] + 0.05 * rng.normal(size=(a, d))).astype(np.float32),
                        rng.normal(size=a).astype(np.float32))
            event = None
            if t % DAEMON_CHURN_EVERY == 0:
                if (t // DAEMON_CHURN_EVERY) % 2 == 0:
                    event = ("join", rng.uniform(-0.9, 0.9, size=d).astype(np.float32),
                             rng.normal(size=b).astype(np.float32))
                else:  # a random slot: a dead one is a counted no-op, as in the bench
                    event = ("leave", int(rng.integers(0, n)))
            out.append((reqs, arrivals, event, drop))
            t += 1
    return out


def drive_daemon(torch, d, traffic, lam: float, hold=None) -> list:
    """Run ``traffic`` through ``d`` as the bench does (submit, offer, tick,
    pump).  ``hold(t, snap)`` is called before each tick with the published
    snapshot and returns a callback run after the tick.  Returns per tick
    (receipt, answers by ticket order, latencies, split)."""
    from repro_torch.core import make_fault_model

    rows = []
    drop_now = None
    for t, (reqs, arrivals, event, drop) in enumerate(traffic):
        if drop != drop_now:
            d.set_fault_model(make_fault_model(drop, dtype=d._work[1].z.dtype, device=d.device))
            drop_now = drop
        after = hold(t, d.snapshot) if hold is not None else None
        tickets = [d.submit(x) for x in reqs]
        d.offer_arrivals(*arrivals)
        if event is not None and event[0] == "join":
            d.offer_join(event[1], event[2], lam=lam)
        elif event is not None:
            d.offer_leave(event[1])
        rcpt = d.tick()
        answers = {a.id: a for a in d.pump()}
        if after is not None:
            after()
        check(all(tk.admitted and tk.id in answers for tk in tickets),
              f"main-daemon tick {t}: a request was shed or not answered")
        vals = [answers[tk.id].values for tk in tickets]
        check(all(np.isfinite(v).all() and v.shape == (d.snapshot.ecoef.shape[0], x.shape[0])
                  for v, x in zip(vals, reqs)), f"main-daemon tick {t}: bad answers")
        rows.append((rcpt, vals, [answers[tk.id].latency_s * 1e3 for tk in tickets],
                     dict(d.last_split, pruned=d.snapshot.pruned)))
    return rows


def warm_up_daemon(torch, d, traffic, lam: float) -> None:
    """Touch every path the measured run takes once, on a throwaway daemon
    over the same problem (which it never writes): each dispatch bucket, a
    full and a padded arrival window, a join, a leave, a drill and a
    checkpoint, as the reference bench warms up."""
    from repro_torch.core import make_fault_model
    from repro_torch.checkpoint import save_train

    rng = np.random.default_rng(1)
    dim = d.snapshot.problem.topology.positions.shape[1]
    q = 8
    while q <= DAEMON_MAX_ROWS:
        d.submit(rng.uniform(-1, 1, size=(q, dim)).astype(np.float32))
        d.pump()
        q *= 2
    # 49 arrivals: a full window of 32 and one padded from 17 to 32
    arrivals = [np.concatenate(a)[:49] for a in zip(*(t[1] for t in traffic[:8]))]
    d.offer_arrivals(*arrivals)
    d.offer_join(np.zeros(dim, np.float32), np.zeros(d.snapshot.ecoef.shape[0], np.float32),
                 lam=lam)
    d.tick()
    d.offer_arrivals(*arrivals)
    d.offer_leave(3)
    d.tick()
    d.set_fault_model(make_fault_model(0.1, dtype=d._work[1].z.dtype, device=d.device))
    d.tick()
    with tempfile.TemporaryDirectory() as tmp:
        save_train(tmp, 0, d.snapshot.problem, d.snapshot.state)
    torch.cuda.synchronize()


def replay_err(rows, rrows, ints, label: str, offset: int = 0) -> float:
    """Checks that each replayed tick's receipt has the measured one's
    ``ints`` and watchdog integers; returns the answers' max |err|."""
    err = 0.0
    for t, (a, b) in enumerate(zip(rows, rrows), start=offset):
        ja, jb = a[0].to_json(), b[0].to_json()
        same = all(ja[k] == jb[k] for k in ints) and all(
            ja["watchdog"][k] == jb["watchdog"][k] for k in WATCHDOG_INTS)
        check(same, f"main-daemon {label} tick {t}: receipts differ: {ja} vs {jb}")
        err = max([err] + [float(np.abs(x - y).max()) for x, y in zip(a[1], b[1])])
    return err


def pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q)) if len(xs) else float("nan")


def run_daemon(torch, mods) -> tuple[dict, dict, float]:
    """The Daemon at the churned field geometry under the bench's traffic,
    launches counted from 0 around the 28 ticks; then the isolation,
    plain-engine, replay and warm-restart checks.  Returns (launches,
    readings, energy_tau)."""
    import dataclasses

    from repro_torch.analysis import launch_ledger
    from repro_torch.core import colored_sweep, fusion, init_state, make_serving_plan, pruning
    from repro_torch.core import serving
    from repro_torch.kernels import _build
    from repro_torch.launch import daemon, serve

    _, args = churn_args()
    prob = serve.build_problem(args)
    dev = prob.device
    state0 = colored_sweep(prob, init_state(prob), n_sweeps=args.sweeps, engine="cuda")
    plan0 = make_serving_plan(prob, k=args.k, spare=args.spares + 4, slack=16)
    energy = pruning.representer_energy(prob, state0)[: prob.n]
    tau = float(torch.quantile(energy[prob.alive[: prob.n]], DAEMON_PRUNE_Q))
    traffic = daemon_traffic(args, prob)
    ckdir = tempfile.mkdtemp(prefix="daemon_ckpt_")
    cfg = daemon.DaemonConfig(k=args.k, max_batch_rows=DAEMON_MAX_ROWS,
                              arrival_rows=DAEMON_ARRIVALS, ckpt_every=DAEMON_CKPT_EVERY,
                              snapshot_dir=ckdir, energy_tau=tau)
    print(f"main-daemon: n={args.sensors} (+{args.spares} spares) B={args.fields} "
          f"D={prob.topology.d_max} k={args.k}, plan K_max={plan0.k_max} "
          f"({plan0.n_cells} cells), energy_tau={tau!r} (the {DAEMON_PRUNE_Q} quantile of "
          f"the live energies), {len(traffic)} ticks")
    try:
        warm_up_daemon(torch, daemon.Daemon(prob, state0, plan=plan0, config=dataclasses.replace(
            cfg, ckpt_every=0, snapshot_dir=None)), traffic, args.lam)
        d = daemon.Daemon(prob, state0, config=cfg, plan=plan0)
        pruned0 = d.snapshot.pruned
        print(f"main-daemon: first publish prunes {pruned0} of "
              f"{int(prob.alive[: prob.n].sum())} live sensors")
        check(pruned0 > 0, "main-daemon: the first publish pruned nothing")
        dispatches = []  # (rows, ms)
        serve_plain = d.dispatch

        def timed_dispatch(snap, xq):
            t0 = time.perf_counter()
            out = serve_plain(snap, xq)
            torch.cuda.synchronize()
            dispatches.append((xq.shape[0], (time.perf_counter() - t0) * 1e3))
            return out

        d.dispatch = timed_dispatch
        isolation = []
        e0 = DAEMON_PHASES[0][0]  # the fault episode's first tick
        episode = {}

        def hold(t, snap):
            if t == e0:  # what the episode's replay starts from
                episode.update(work=d._work, plan=d._plan, gen=d._gen.get_state())
            before = snapshot_digest(snap)
            return lambda: isolation.append(snapshot_digest(snap) == before)

        builds0 = _build.builds
        for mod in mods.values():
            mod.launches = 0
        t0 = time.perf_counter()
        rows = drive_daemon(torch, d, traffic, args.lam, hold)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {name: mod.launches for name, mod in mods.items()}
        builds = _build.builds - builds0
        rounds = sum(r[0].watchdog.rounds for r in rows)
        print("main-daemon: kernel launches " + json.dumps(launches)
              + f" ({len(dispatches)} dispatches, {rounds} watchdog rounds); CUDA library "
              f"builds during the run {builds}")
        expected = launch_ledger.expected({"sweep.colored.cuda": rounds,
                                           "serving.knn.cuda": len(dispatches)})
        check(launches == expected, f"main-daemon: launches {launches}, expected {expected}")
        check(builds == 0, "main-daemon: a CUDA library was built during the run")
        check(len(isolation) == len(rows) and all(isolation),
              f"main-daemon: a published snapshot changed under a later tick: {isolation}")

        # a forced rollback, on a daemon over the final snapshot with room
        # for the whole ladder (rounds_per_tick 14, as tests/test_daemon.py)
        snap = d.snapshot
        rb = daemon.Daemon(snap.problem, snap.state, plan=snap.plan, config=dataclasses.replace(
            cfg, rounds_per_tick=14, ckpt_every=0, snapshot_dir=None))
        held = rb.snapshot
        before = snapshot_digest(held)
        wp, ws = rb._work
        z = ws.z.clone()
        z[0, 0] = float("nan")  # a poisoned copy of the working state
        rb._work = (wp, type(ws)(z=z, coef=ws.coef))
        bad = rb.tick()
        aliased = rb._work[0] is held.problem and rb._work[1] is held.state
        good = rb.tick()  # from the restored working pair, which aliases the snapshot
        intact = snapshot_digest(held) == before
        print(f"main-daemon rollback: rolled_back={bad.watchdog.rolled_back} "
              f"published={bad.published} degraded={bad.degraded}; working pair aliased the "
              f"snapshot {aliased}; next tick published={good.published}; held snapshot "
              f"digest unchanged {intact}")
        check(bad.watchdog.rolled_back and not bad.published and aliased and good.published
              and intact, "main-daemon: the forced rollback")

        # the final snapshot: its answers on the plain engine; then, pruned
        # at the 0.1 quantile of its own energies (training grows them past
        # the first publish's threshold), the compacted plan against the
        # prune mask and every query of a grid within answer_bound
        snap = d.snapshot
        h = np.linspace(-0.95, 0.95, DAEMON_GRID)
        grid = np.stack(np.meshgrid(h, h, indexing="ij"), -1).reshape(-1, 2).astype(np.float32)
        xq = torch.as_tensor(grid, device=dev)
        kern = serve_plain(snap, xq)
        # the kernel against its plain version on the snapshot's inputs, as
        # main-churn holds the churned plan (1e-5, else the float64 witness);
        # the served answers are the kernel's on these inputs
        ins = knn_inputs(torch, snap.problem, snap.state, 0, seed=0, xq=xq, plan=snap.plan)[0]
        check(torch.equal(ins[-1], snap.ecoef), "main-daemon: the snapshot's ecoef")
        alive = snap.problem.alive & snap.keep
        gamma = snap.problem.kernel.gamma
        err_kf, sel = compare_knn(torch, ins, alive, gamma, args.k, "daemon snapshot",
                                  witness=True, served=kern)
        # the plain engine on the same snapshot: the same picks, answers in
        # the same bound
        plain = fusion.fuse(snap.problem, snap.state, xq, "knn", k=args.k, engine="plan",
                            plan=snap.plan, ecoef=snap.ecoef, prune=snap.keep)
        sel_pl, ok_pl = serving.knn_select_valid(snap.plan, snap.problem.topology.positions, xq,
                                                 args.k, alive)
        check(torch.equal(torch.where(ok_pl, sel_pl, -1).to(sel.dtype), sel),
              "main-daemon: the plain engine picked other neighbours")
        err_plain = knn_agree(torch, kern, plain, ins, sel, gamma,
                              "daemon served vs the plain engine", witness=True)
        e = pruning.representer_energy(snap.problem, ecoef=snap.ecoef)
        n = snap.problem.n
        tau_final = float(torch.quantile(e[:n][snap.problem.alive[:n]], DAEMON_PRUNE_Q))
        keep = pruning.prune_mask(snap.problem, ecoef=snap.ecoef, energy_tau=tau_final)
        knn = lambda plan, prune: fusion.fuse(  # noqa: E731
            snap.problem, snap.state, xq, "knn", k=args.k, engine="cuda", plan=plan,
            ecoef=snap.ecoef, prune=prune)
        masked = knn(snap.plan, keep)
        compact, rep = pruning.prune_plan(snap.problem, None, snap.plan, energy_tau=tau_final,
                                          ecoef=snap.ecoef)
        err_comp = max_err(masked, knn(compact, None))
        positions = snap.problem.topology.positions
        sel_u = serving.knn_select_valid(snap.plan, positions, xq, args.k, snap.problem.alive)
        sel_p = serving.knn_select_valid(snap.plan, positions, xq, args.k,
                                         snap.problem.alive & keep)
        bnd = pruning.answer_bound(e, *sel_u, *sel_p)
        gap = (knn(snap.plan, None) - masked).abs().amax(0).cpu().numpy()
        over = float((gap - bnd).max())
        print(f"main-daemon final snapshot (version {snap.version}, {snap.pruned} pruned at "
              f"the first publish's tau, |answer| <= {float(kern.abs().max()):.3g}): served vs "
              f"the plain engine max |err| {err_plain:.3g}, knn_fuse vs knn_fuse_ref "
              f"{err_kf:.3g} (identical selections); at tau {tau_final!r} ({rep.n_pruned} of {rep.n_live} pruned) the "
              f"compacted plan (K_max {rep.k_max_before} -> {rep.k_max_after}) vs the prune "
              f"mask {err_comp:.3g} (tol 1e-6); {grid.shape[0]} queries within answer_bound "
              f"(max gap - bound {over:.3g}, {int((bnd > 0).sum())} with a non-zero bound)")
        check(err_comp <= 1e-6 and rep.n_pruned > 0,
              "main-daemon: compacted plan vs the prune mask")
        check(bool((gap <= bnd + 1e-5).all()), "main-daemon: a query outside answer_bound")

        # warm restart from the last checkpoint, into a fresh daemon
        last = rows[-1][0]
        check(last.ckpt_step == len(rows), "main-daemon: the last tick did not checkpoint")
        probe = torch.as_tensor(grid[:: DAEMON_GRID + 1], device=dev)
        want = serve_plain(snap, probe).cpu().numpy()
        fresh = daemon.Daemon(serve.build_problem(args), init_state(prob), plan=snap.plan,
                              config=dataclasses.replace(cfg, ckpt_every=0))
        got = fresh.dispatch(fresh.snapshot, probe).cpu().numpy()
        restart_ok = (fresh.restored_step == last.ckpt_step
                      and fresh.state_digest() == d.state_digest()
                      and np.array_equal(got, want))
        print(f"main-daemon warm restart: step {fresh.restored_step}, digest equal "
              f"{fresh.state_digest() == d.state_digest()}, {probe.shape[0]} probe answers "
              f"bitwise {np.array_equal(got, want)}")
        check(restart_ok, "main-daemon: warm restart")

        # the first ticks replayed through a daemon with plan engines
        rp_dir = tempfile.mkdtemp(prefix="daemon_replay_")
        try:
            replay = daemon.Daemon(prob, state0, plan=plan0, config=dataclasses.replace(
                cfg, engine="plan", train_engine="plan", snapshot_dir=rp_dir))
            t0 = time.perf_counter()
            rrows = drive_daemon(torch, replay, traffic[:DAEMON_REPLAY_TICKS], args.lam)
            replay_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(rp_dir, ignore_errors=True)
        err_ans = replay_err(rows, rrows, TICK_INTS, "replay")
        print(f"main-daemon replay on the plain engines ({DAEMON_REPLAY_TICKS} ticks, "
              f"{replay_s:.2f}s): receipt integers equal, answers max |err| {err_ans:.3g} "
              f"(tol {STREAM_Z_TOL})")
        check(err_ans <= STREAM_Z_TOL, "main-daemon: replay answers differ")

        # the fault episode's first ticks (a join among them) replayed the
        # same way, from the working pair, plan and fault generator the
        # measured daemon held before its first faulty tick: color_sweep
        # under drop masks at this D against the plain engine
        gen = torch.Generator(device=dev)
        gen.set_state(episode["gen"])
        ep = daemon.Daemon(*episode["work"], plan=episode["plan"], generator=gen,
                           config=dataclasses.replace(cfg, engine="plan", train_engine="plan",
                                                      ckpt_every=0, snapshot_dir=None))
        t0 = time.perf_counter()
        erows = drive_daemon(torch, ep, traffic[e0:e0 + DAEMON_EPISODE_REPLAY], args.lam)
        episode_s = time.perf_counter() - t0
        err_ep = replay_err(rows[e0:], erows, TICK_WORK_INTS, "episode replay", offset=e0)
        print(f"main-daemon episode replay on the plain engines (ticks {e0}-"
              f"{e0 + DAEMON_EPISODE_REPLAY - 1}, drop {traffic[e0][3]}, {episode_s:.2f}s): "
              f"receipt integers equal, answers max |err| {err_ep:.3g} (tol {STREAM_Z_TOL})")
        check(err_ep <= STREAM_Z_TOL, "main-daemon: episode replay answers differ")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    # readings
    ticks = [r[0] for r in rows]
    fault = [i for i, (_, _, _, drop) in enumerate(traffic) if drop > 0]
    lat_clean = [x for i, r in enumerate(rows) if i not in fault for x in r[2]]
    lat_fault = [x for i in fault for x in rows[i][2]]
    p99_clean, p99_fault = pct(lat_clean, 99), pct(lat_fault, 99)
    pruned = [r[3].pop("pruned") for r in rows]
    split = {k: dict(mean=float(np.mean([r[3][k] for r in rows])),
                     p50=pct([r[3][k] for r in rows], 50), max=max(r[3][k] for r in rows))
             for k in rows[0][3]}
    tick_ms = [sum(r[3].values()) for r in rows]
    by_bucket = {}
    for q, ms in dispatches:
        by_bucket.setdefault(q, []).append(ms)
    buckets = {str(q): dict(n=len(v), p50=pct(v, 50), p99=pct(v, 99))
               for q, v in sorted(by_bucket.items())}
    readings = dict(
        ticks=len(rows), run_s=run_s, energy_tau=tau, d_max=prob.topology.d_max,
        k_max=plan0.k_max,
        tick_ms=dict(mean=float(np.mean(tick_ms)), p50=pct(tick_ms, 50), max=max(tick_ms)),
        split_ms=split, dispatch_ms_by_bucket=buckets,
        served=d.served, shed=d.shed, dispatches=len(dispatches),
        degraded_ticks=sum(r.degraded for r in ticks),
        rollbacks=sum(r.watchdog.rolled_back for r in ticks),
        retries=sum(r.watchdog.retries for r in ticks), watchdog_rounds=rounds,
        absorbed=sum(r.absorbed for r in ticks), arrival_drops=sum(r.arrival_drops for r in ticks),
        joins=sum(r.joins for r in ticks), leaves=sum(r.leaves for r in ticks),
        pruned_first=pruned0, pruned_by_tick=pruned, tau_final=tau_final,
        pruned_final=rep.n_pruned,
        latency_ms=dict(clean_p50=pct(lat_clean, 50), clean_p99=p99_clean,
                        fault_p50=pct(lat_fault, 50), fault_p99=p99_fault,
                        ratio=p99_fault / p99_clean, budget=DAEMON_SLO),
        err_plain=err_plain, err_knn_fuse=err_kf, err_compact=err_comp, bound_over=over,
        bound_nonzero=int((bnd > 0).sum()), err_replay=err_ans, err_episode_replay=err_ep,
        k_max_compact=rep.k_max_after, replay_s=replay_s, episode_replay_s=episode_s,
    )
    print(f"main-daemon: {len(rows)} ticks in {run_s:.2f}s; ms per tick p50 "
          f"{readings['tick_ms']['p50']:.2f}; split p50 " + json.dumps(
              {k: round(v["p50"], 3) for k, v in split.items()}))
    print(f"main-daemon: served {d.served}, shed {d.shed}; degraded ticks "
          f"{readings['degraded_ticks']}, rollbacks {readings['rollbacks']}; fault-episode "
          f"p99 {p99_fault:.2f} ms vs clean p99 {p99_clean:.2f} ms: ratio "
          f"{p99_fault / p99_clean:.3f} (the reference's budget {DAEMON_SLO}, not gated)")
    print("main-daemon: dispatch ms by bucket " + json.dumps(
        {q: [round(v["p50"], 3), round(v["p99"], 3)] for q, v in buckets.items()}))
    return launches, readings, tau


def run_daemon_cli(torch) -> dict:
    """The reference CI's kill-and-warm-restart step on the card: the daemon's
    CLI checkpointing every tick, SIGKILLed after two checkpoints, then
    ``--verify-restart``."""
    import signal

    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    snap = tempfile.mkdtemp(prefix="daemon_cli_")
    base = [sys.executable, "-m", "repro_torch.launch.daemon"] + DAEMON_CLI
    t0 = time.perf_counter()
    proc = subprocess.Popen(base + ["--ticks", "200", "--tick-sleep", "0.2",
                                    "--snapshot-dir", snap],
                            env=env, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while time.time() < deadline and proc.poll() is None:
            if sum(f.startswith("probe_") for f in os.listdir(snap)) >= 2:
                break
            time.sleep(0.01)
        early = proc.poll()
        time.sleep(0.05)  # inside the tick's sleep, after its probe file
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.kill()
        _, err = proc.communicate()
    check(early is None, f"main-daemon CLI exited early: {err[-2000:]!r}")
    steps = sorted(f for f in os.listdir(snap) if f.startswith("step_"))
    out = subprocess.run(base + ["--ticks", "0", "--snapshot-dir", snap, "--verify-restart"],
                         env=env, cwd=HERE, capture_output=True, text=True, timeout=180)
    shutil.rmtree(snap, ignore_errors=True)
    verified = [ln for ln in out.stdout.splitlines() if "warm restart verified" in ln]
    print(f"main-daemon CLI: SIGKILL after {len(steps)} checkpoints; " + (
        verified[0] if verified else f"restart failed: {out.stderr[-2000:]}"))
    check(out.returncode == 0 and verified and len(steps) >= 2, "main-daemon: CLI warm restart")
    return dict(checkpoints=len(steps), cli_s=time.perf_counter() - t0)


def run_prune_launcher(torch, mods, tau: float) -> tuple[dict, dict]:
    """The field launcher at the benched geometry with --energy_tau, launches
    counted from 0: knn_fuse serves the compacted plan."""
    from repro_torch.analysis import launch_ledger
    from repro_torch.launch import serve

    argv = main_args()[0] + ["--energy_tau", repr(tau)]
    args = serve.parser().parse_args(argv)
    print("main-prune: python -m repro_torch.launch.serve " + " ".join(argv))
    for mod in mods.values():
        mod.launches = 0
    res = serve.main(argv)
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in mods.items()}
    rep, plan = res["prune"], res["pruned_plan"]
    print("main-prune: kernel launches " + json.dumps(launches)
          + f"; K_max {rep.k_max_before} -> {rep.k_max_after}, pruned {rep.n_pruned} of "
          f"{rep.n_live} live sensors at tau {tau!r}")
    expected = launch_ledger.expected({"sweep.colored.cuda": res["train_calls"],
                                       "serving.knn.cuda": serve.TIMED_CALLS,
                                       "kernels.matvec": serve.TIMED_CALLS})
    check(launches == expected, f"main-prune: launches {launches}, expected {expected}")
    check(plan.k_max == rep.k_max_after < rep.k_max_before and 0 < rep.n_pruned < rep.n_live,
          "main-prune: the plan was not compacted")
    # the kernel on the compacted plan against its plain version, on the
    # inputs of the launcher's request; the served answers are the kernel's
    prob, state = res["problem"], res["state"]
    ins = knn_inputs(torch, prob, state, 0, seed=0, xq=res["xq"], plan=plan)[0]
    err, sel = compare_knn(torch, ins, prob.alive, prob.kernel.gamma, args.k, "compacted plan",
                           witness=True, served=res["knn"])
    print(f"main-prune: knn_fuse on the compacted plan (Q={ins[0].shape[0]}, K_max "
          f"{plan.k_max}): identical selections ({int((sel >= 0).sum())} picks), served answers "
          f"the kernel's, max |err| vs knn_fuse_ref {err:.3g}")
    return launches, dict(k_max_before=rep.k_max_before, k_max_after=rep.k_max_after,
                          pruned=rep.n_pruned, live=rep.n_live, tau=tau,
                          knn_request_ms=res["knn_s"] * 1e3, knn_fuse_err=err)


# ---------------------------------------------------------------------------
# Phase 3f: the multi-device layer at a world of one on NCCL.
# ---------------------------------------------------------------------------

SHARDED_DROP = 0.1  # the delivery mask's drop rate


def _clones(xs) -> list:
    return [x.detach().clone() for x in xs]


def run_sharded(torch, mods, ctx) -> tuple[dict, dict]:
    """sharded_sweep over the NCCL group of one at the benched geometry, launch
    counters set to 0 before and read after: field-sharded with the cuda
    engine (one color_sweep launch per call, bitwise colored_sweep), without
    and with a 10% drop mask; the sensor regime on field 0 against the plan
    engine (f32 2e-4 / 2e-2, f64 1e-10); then its costs."""
    from repro_torch.analysis import launch_ledger
    from repro_torch.core import colored_sweep, field_view, init_state, sharded_sweep
    from repro_torch.distributed import all_gather_into
    from repro_torch.launch import serve

    _, args = main_args()
    prob = serve.build_problem(args, torch.float32)
    st0 = init_state(prob)
    sweeps, g = args.sweeps, ctx.group
    rng = np.random.default_rng(5)
    deliv = torch.as_tensor(rng.uniform(size=(sweeps,) + tuple(prob.nbr_idx.shape))
                            >= SHARDED_DROP, device=prob.device)
    fv, fs0 = field_view(prob, st0, 0)
    for mod in mods.values():
        mod.launches = 0
    sh = sharded_sweep(prob, st0, g, n_sweeps=sweeps, engine="cuda")
    sh_d = sharded_sweep(prob, st0, g, n_sweeps=sweeps, engine="cuda", delivered=deliv)
    sh_s = sharded_sweep(fv, fs0, g, n_sweeps=sweeps)
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in mods.items()}
    print("main-sharded: kernel launches " + json.dumps(launches)
          + f" (2 field-sharded calls of {sweeps} sweeps, 1 sensor-regime call)")
    expected = launch_ledger.expected({"sweep.sharded.fields.cuda": 2,
                                       "sweep.sharded.sensors": 1})
    check(launches == expected, f"main-sharded: launches {launches}, expected {expected}")
    out = {}
    for tag, got, mask in (("field", sh, None), ("field+drops", sh_d, deliv)):
        want = colored_sweep(prob, st0, n_sweeps=sweeps, engine="cuda", delivered=mask)
        same = torch.equal(got.z, want.z) and torch.equal(got.coef, want.coef)
        print(f"main-sharded: {tag} (B={prob.batch_size}, n={prob.n}, "
              f"D={prob.nbr_idx.shape[1]}) engine=cuda bitwise colored_sweep: {same}")
        check(same, f"main-sharded: {tag} sharded_sweep differs from colored_sweep")
    check(not torch.equal(sh.z, sh_d.z), "main-sharded: the drop mask changed nothing")
    plain = colored_sweep(fv, fs0, n_sweeps=sweeps, engine="plan")
    out["sensor_err_z"], out["sensor_err_coef"] = max_err(sh_s.z, plain.z), max_err(
        sh_s.coef, plain.coef)
    prob64 = serve.build_problem(args, torch.float64)
    fv64, fs64 = field_view(prob64, init_state(prob64), 0)
    sh64 = sharded_sweep(fv64, fs64, g, n_sweeps=sweeps)
    plain64 = colored_sweep(fv64, fs64, n_sweeps=sweeps, engine="plan")
    out["sensor64_err"] = max(max_err(sh64.z, plain64.z), max_err(sh64.coef, plain64.coef))
    print(f"main-sharded: sensor regime on field 0 vs the plan engine: f32 |dz| "
          f"{out['sensor_err_z']:.3g}, |dcoef| {out['sensor_err_coef']:.3g}; f64 "
          f"{out['sensor64_err']:.3g}")
    check(out["sensor_err_z"] <= 2e-4 and out["sensor_err_coef"] <= 2e-2,
          "main-sharded: sensor regime differs from the plan engine (f32)")
    check(out["sensor64_err"] <= 1e-10, "main-sharded: sensor regime differs (f64)")
    # costs: the sharded call beside colored_sweep, in turns; the all-gathers
    sharded = lambda: sharded_sweep(prob, st0, g, n_sweeps=sweeps, engine="cuda")  # noqa: E731
    colored = lambda: colored_sweep(prob, st0, n_sweeps=sweeps, engine="cuda")  # noqa: E731
    ms = {"colored": [], "sharded": []}
    for name in ("colored", "sharded", "sharded", "colored"):
        ms[name].append(cuda_ms(sharded if name == "sharded" else colored, reps=10))
    zbuf, cbuf = torch.empty_like(st0.z), torch.empty_like(st0.coef)
    out["gather_ms"] = cuda_ms(lambda: (all_gather_into(zbuf, sh.z, g),
                                        all_gather_into(cbuf, sh.coef, g)), reps=20)
    t0 = time.perf_counter()
    sharded_sweep(fv, fs0, g, n_sweeps=sweeps)
    torch.cuda.synchronize()
    out["sensor_call_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    colored_sweep(fv, fs0, n_sweeps=sweeps, engine="plan")
    torch.cuda.synchronize()
    out["sensor_plan_s"] = time.perf_counter() - t0
    out.update(sharded_ms=ms["sharded"], colored_ms=ms["colored"],
               gather_bytes=(st0.z.numel() + st0.coef.numel()) * 4)
    print(f"main-sharded: ms per call, field-sharded {ms['sharded']} vs colored_sweep "
          f"{ms['colored']} (engine cuda, in turns); the two all-gathers "
          f"({out['gather_bytes']} bytes) {out['gather_ms']:.4f} ms; sensor regime "
          f"{out['sensor_call_s']:.3f} s per call vs the plan engine {out['sensor_plan_s']:.3f} s")
    return launches, out


def run_consensus_lm(torch, ctx) -> dict:
    """The gossip collectives on mamba2-370m's full-width parameters at a world
    of one: bitwise identities, consensus_sq 0, and their times."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import consensus
    from repro_torch.models import init_params

    cfg = get_config("mamba2-370m")
    params = init_params(cfg, LM_SEED, device=ctx.device)
    before = _clones(tree.leaves(params))
    g, out = ctx.group, {}
    for name, fn in (("allreduce_average", lambda: consensus.allreduce_average(params, g)),
                     ("gossip_round", lambda: consensus.gossip_round(params, g, [[0]], 3)),
                     ("neighborhood_average",
                      lambda: consensus.neighborhood_average(params, g, 1))):
        check(fn() is params, f"main-sharded: {name} returned another module")
        same = all(torch.equal(a, b) for a, b in zip(tree.leaves(params), before))
        check(same, f"main-sharded: {name} is not a bitwise identity at a world of one")
        out[name + "_ms"] = cuda_ms(fn, reps=5, warmup=1)
    sq = float(consensus.consensus_sq_distance(params, g))
    check(sq == 0.0, f"main-sharded: consensus_sq {sq} at a world of one")
    nbytes = sum(x.numel() * x.element_size() for x in before)
    print(f"main-sharded: {cfg.name} parameters ({len(before)} leaves, {nbytes} bytes, "
          f"{cfg.dtype}): allreduce_average, gossip_round, neighborhood_average bitwise "
          f"identities, consensus_sq 0.0; ms " + json.dumps(
              {k: round(v, 4) for k, v in out.items()}))
    return dict(out, bytes=nbytes)


# ---------------------------------------------------------------------------
# Phase 3g: the data-parallel train step at full width.
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR, TRAIN_STEPS = 8, 128, 3e-4, 20  # the launcher's defaults
ADAMW_CHECK_LEAVES = ("embed", "layers.0.ssm.in_proj", "layers.47.ssm.out_proj",
                      "layers.23.ssm.A_log", "final_norm.scale")


def check_adamw(torch, names, p0, grads, state0, state1, p1, lr: float) -> dict:
    """The step's AdamW update recomputed in float64 from the gradients it
    was given and the moments before it: moments to 1e-5 relative, the new
    bf16 parameters to one bf16 ulp (plus 1e-6 of |p| + |u|)."""
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, 0.1  # repro.optim.adamw's defaults
    g64 = [g.double() for g in grads]
    norm = sum(float((g * g).sum()) for g in g64) ** 0.5
    scale = min(1.0, 1.0 / (norm + 1e-9))
    step = int(state1["step"])
    out = {}
    for name in ADAMW_CHECK_LEAVES:
        i = names.index(name)
        g = g64[i] * scale
        mu = b1 * state0["mu"][i].double() + (1 - b1) * g
        nu = b2 * state0["nu"][i].double() + (1 - b2) * g * g
        u = -lr * ((mu / (1 - b1 ** step)) / ((nu / (1 - b2 ** step)).sqrt() + eps)
                   + wd * p0[i].double())
        want = p0[i].double() + u
        # one bf16 ulp of the result, and the float32 formula's own rounding
        # (its bias corrections are float32, ~2.4e-7 relative), which shows
        # where p + u cancels
        ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want.float()).exponent - 8)
        allowed = ulp + 1e-6 * (p0[i].double().abs() + u.abs())
        err_p = float(((p1[i].double() - want).abs() / allowed).max())
        err_m = max(max_err(state1["mu"][i], mu) / max(float(mu.abs().max()), 1e-30),
                    max_err(state1["nu"][i], nu) / max(float(nu.abs().max()), 1e-30))
        out[name] = dict(param_over_bound=err_p, moments_rel=err_m)
        check(err_p <= 1.0 and err_m <= 1e-5,
              f"main-train: AdamW update of {name} differs from the float64 formula: "
              f"{err_p} of its bound, moments {err_m}")
    return out


def run_train(torch, mods, ctx) -> tuple[dict, dict]:
    """mamba2-370m at full width (bf16, random weights from seed 0) trained
    with the launcher's build (AdamW on its cosine schedule) at batch 8 x 128,
    in both dp_modes over the NCCL group of one: a warm-up step, then 20
    timed steps; launch counters set to 0 before and read after (no kernel
    of the port is on this path: ssd_fused stays off, as in the reference's
    launcher); then the launcher itself in a subprocess."""
    from repro_torch import optim, tree
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_stream
    from repro_torch.launch import train
    from repro_torch.models import init_params, make_train_step
    from repro_torch.optim import cosine_warmup

    cfg = get_config("mamba2-370m")
    check(not cfg.ssd_fused and cfg.dtype == "bfloat16" and cfg.n_layers == 48,
          "main-train: not the full-width mamba2-370m")
    steps = TRAIN_STEPS + 1
    stream = synthetic_lm_stream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [{k: torch.as_tensor(v, device=ctx.device) for k, v in stream.batch_at(i).items()}
               for i in range(steps)]
    # the launcher's schedule (train.build) at the first step
    lr_1 = float(cosine_warmup(TRAIN_LR, min(100, steps // 10 + 1), steps)(1))
    for mod in mods.values():
        mod.launches = 0
    readings = {}
    for dp_mode in ("allreduce", "sop_gossip"):
        opt, _ = train.build(cfg, dp_mode=dp_mode, lr=TRAIN_LR, steps=steps, group=ctx.group,
                             world=ctx.world)
        seen = {}

        def update(grads, state, params, opt=opt, seen=seen):
            seen["grads"] = [gr.detach().clone() for gr in grads]
            return opt.update(grads, state, params)

        rec = optim.Optimizer(init=opt.init, update=update)
        sched = [[0]] if dp_mode == "sop_gossip" else None  # train.build's, at a world of one
        step = make_train_step(cfg, rec, group=ctx.group, dp_mode=dp_mode,
                               gossip_schedule=sched)
        params = init_params(cfg, LM_SEED, device=ctx.device)
        names = [n for n, _ in params.named_parameters()]
        state = opt.init(params)
        p0 = _clones(tree.leaves(params))
        s0 = {"mu": _clones(state["mu"]), "nu": _clones(state["nu"])}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[0], 0)  # the warm-up step
        losses = [float(m["loss"])]
        warm_s = time.perf_counter() - t0
        adamw = check_adamw(torch, names, p0, seen["grads"], s0, state,
                            tree.leaves(params), lr_1)
        del p0, s0
        times = []
        for i in range(1, steps):
            t0 = time.perf_counter()
            params, state, m = step(params, state, batches[i], i)
            losses.append(float(m["loss"]))  # one host read per step, as the launcher logs
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)), f"main-train {dp_mode}: non-finite loss {losses}")
        check(losses[-1] < losses[0], f"main-train {dp_mode}: the loss did not fall: {losses}")
        if dp_mode == "sop_gossip":
            check(float(m["consensus_sq"]) == 0.0, "main-train: consensus_sq at a world of one")
        s_step = float(np.mean(times))
        readings[dp_mode] = dict(
            s_per_step=s_step, s_per_step_p50=float(np.median(times)), warmup_s=warm_s,
            tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / s_step, peak_bytes=peak, losses=losses,
            adamw=adamw)
        print(f"main-train: {cfg.name} dp={dp_mode} world={ctx.world} batch {TRAIN_BATCH} x "
              f"{TRAIN_SEQ}: {s_step:.4f} s/step ({TRAIN_BATCH * TRAIN_SEQ / s_step:.0f} "
              f"tokens/s) over {TRAIN_STEPS} steps after a {warm_s:.2f} s warm-up step; peak "
              f"memory {peak / 2**30:.2f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        print(f"main-train: dp={dp_mode} loss per step " + json.dumps(
            [round(x, 4) for x in losses]))
        print(f"main-train: dp={dp_mode} AdamW after one step vs the float64 formula "
              "(the new parameter's error over one bf16 ulp + 1e-6 (|p| + |u|), the "
              "moments' relative error): "
              + json.dumps(adamw))
        del params, state, m, seen
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in mods.items()}
    print("main-train: kernel launches " + json.dumps(launches))
    check(all(v == 0 for v in launches.values()),
          f"main-train: a kernel without a backward was launched: {launches}")
    readings["launcher"] = run_train_launcher(torch)
    return launches, readings


TRAIN_ARGV = ["--arch", "mamba2-370m", "--variant", "full", "--steps", "3", "--batch", "8",
              "--seq", "128", "--dp_mode", "sop_gossip", "--log_every", "1"]


def run_train_launcher(torch) -> dict:
    """``python -m repro_torch.launch.train`` in a subprocess (one rank per
    card, NCCL): it must print ``done``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    print("main-train: python -m repro_torch.launch.train " + " ".join(TRAIN_ARGV))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"] + TRAIN_ARGV,
                         env=env, cwd=HERE, capture_output=True, text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    for line in lines:
        print("main-train launcher: " + line)
    check(out.returncode == 0 and lines and lines[-1] == "done",
          f"main-train: the launcher failed: {out.stderr[-2000:]}")
    return dict(launcher_s=time.perf_counter() - t0, lines=len(lines))


# ---------------------------------------------------------------------------
# Phase 4: the LM path.
# ---------------------------------------------------------------------------

LM_ARGV = ["--mode", "lm", "--arch", "mamba2-370m", "--variant", "full", "--batch", "4",
           "--prompt_len", "512", "--gen", "32"]
LM_SEED = 0  # the launcher's default --seed
LM_TOL = 2e-3
LM_DECODE_STEPS = 4
# Where the kernel and plain routes differ by more than LM_TOL, the kernel
# route's error against the f64 witness may be at most this multiple of the
# plain route's.
LM_WITNESS_FACTOR = 4.0


def lm_route(torch, cfg, params, prompt, tokens):
    """Prefill ``prompt``, then decode ``tokens`` teacher-forced; returns
    {"logits", "states", "decode"}."""
    from repro_torch.models import decode_step, init_cache, prefill

    b, s0 = prompt.shape
    cache = init_cache(cfg, b, s0 + tokens.shape[1] + 1, device=prompt.device)
    logits, cache = prefill(cfg, params, {"tokens": prompt}, cache)
    out = {"logits": logits, "states": torch.stack([c["state"] for c in cache])}
    steps = []
    for t in range(tokens.shape[1]):
        step, cache = decode_step(cfg, params, tokens[:, t:t + 1], cache, s0 + t)
        steps.append(step)
    out["decode"] = torch.cat(steps, dim=1)
    return out


def compare_lm(torch, res) -> dict:
    """Kernel route against plain route at full width in float32 (same weights,
    same prompt), both also against the plain route in float64."""
    from repro_torch.models import init_params

    cfg = res["cfg"]
    prompt, tokens = res["prompt"], res["tokens"][:, :LM_DECODE_STEPS]
    runs = {}
    with torch.inference_mode():
        for name, dtype, fused in (("cuda", "float32", True), ("plan", "float32", False),
                                   ("f64", "float64", False)):
            c = dataclasses.replace(cfg, dtype=dtype, ssd_fused=fused)
            if name != "plan":  # the f32 routes share one set of weights
                params = init_params(c, LM_SEED, device="cuda")
            runs[name] = lm_route(torch, c, params, prompt, tokens)
            torch.cuda.synchronize()
    readings, ok_direct, ok_witness = {}, True, True
    for key in ("logits", "states", "decode"):
        k, p, w = runs["cuda"][key], runs["plan"][key], runs["f64"][key]
        check(bool(torch.isfinite(k).all()) and bool(torch.isfinite(p).all()),
              f"main-lm f32 {key}: non-finite values")
        r = dict(kernel_vs_plain=max_err(k, p), kernel_vs_f64=max_err(k, w),
                 plain_vs_f64=max_err(p, w), max_abs=float(w.abs().max()))
        ok_direct &= excess(k, p, LM_TOL) <= LM_TOL
        ok_witness &= r["kernel_vs_f64"] <= LM_WITNESS_FACTOR * r["plain_vs_f64"]
        readings[key] = r
        print(f"main-lm: float32 {key}: kernel vs plain max |d| "
              f"{r['kernel_vs_plain']:.3g}; against the f64 witness kernel "
              f"{r['kernel_vs_f64']:.3g}, plain {r['plain_vs_f64']:.3g} "
              f"(|f64| up to {r['max_abs']:.3g})")
    check(ok_direct or ok_witness,
          f"main-lm: kernel and plain routes differ beyond {LM_TOL} and the kernel's "
          f"error against the f64 witness exceeds {LM_WITNESS_FACTOR} x the plain "
          f"route's: {json.dumps(readings)}")
    how = (f"within {LM_TOL} abs + rel" if ok_direct else
           f"beyond {LM_TOL}, within {LM_WITNESS_FACTOR} x the plain route's f64 error")
    print(f"main-lm: float32 kernel vs plain route ok ({how}): prefill logits, "
          f"{cfg.n_layers} final SSM states, {LM_DECODE_STEPS} teacher-forced decode steps")
    return readings


# ---------------------------------------------------------------------------


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch.distributed as dist

    from repro_torch.analysis import launch_ledger
    from repro_torch.core import (colored_sweep, fusion, init_state, make_serving_plan,
                                  representer_energy)
    from repro_torch.kernels import _build, color_step, gram, kernel_matvec, knn_fuse, ssd_intra
    from repro_torch.distributed import init_group
    from repro_torch.launch import serve

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}); {smi}")

    # 1. build ---------------------------------------------------------------
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)  # build from this checkout
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {len(reports)} CUDA sources in {time.perf_counter() - t0:.1f}s "
          f"-> {_build.BUILD_DIR}")
    check(sorted(reports) == sorted(_build.SOURCES), "not every source was built")
    for name, rep in sorted(reports.items()):
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")

    # 2. kernels against their plain versions, at the main path's shapes -----
    _, args = main_args()
    prob32 = serve.build_problem(args, torch.float32)
    prob64 = serve.build_problem(args, torch.float64)
    err_cs = check_color_step(torch, prob32, "float32")
    check_color_step(torch, prob64, "float64")
    check_color_step(torch, wide_problem(torch, torch.float64), "float64, D > 32")
    check_color_step_witness(torch, wide_problem(torch, torch.float32), "float32, D > 32")
    check_color_sweep(torch, prob64, "float64", args.sweeps, min_cluster=2)
    check_color_sweep(torch, prob32, "float32", args.sweeps, min_cluster=2)
    check_color_sweep(torch, wide_problem(torch, torch.float64), "float64, D = 40", args.sweeps)
    check_sweep_f64(torch, prob64, args.sweeps)
    st32 = colored_sweep(prob32, init_state(prob32), n_sweeps=5, engine="plan")
    st64 = colored_sweep(prob64, init_state(prob64), n_sweeps=5, engine="plan")
    err_knn = check_knn(torch, prob32, st32, None, "float32")
    check_knn(torch, prob64, st64, None, "float64")
    check_knn(torch, prob32, st32, torch.bfloat16, "float32 + bf16 anchors")
    check_knn(torch, prob64, st64, torch.bfloat16, "float64 + bf16 anchors")
    check_knn_ties(torch, torch.float32, None, "float32")
    check_knn_ties(torch, torch.float64, None, "float64")
    check_knn_ties(torch, torch.float32, torch.bfloat16, "float32 + bf16 anchors")
    xq_line = torch.as_tensor(np.stack([np.linspace(-1, 1, 4096), np.zeros(4096)], 1),
                              dtype=torch.float32, device="cuda")
    err_mv = check_matvec(torch, prob32, st32, xq_line)
    err_ssd, (ssd_ins, ssd_cs) = check_ssd_intra(torch)
    anchor_table = conn_inputs(torch, prob32, st32, xq_line)[1][0].contiguous()  # (8400, 2)
    err_gram = check_gram(torch, xq_line, anchor_table, prob32.kernel.gamma)
    timing = {
        "color_step": time_color_step(torch, prob32, args.sweeps),
        "knn_fuse": time_knn(torch, prob32, st32),
        "kernel_matvec": time_matvec(torch, prob32, st32, xq_line),
        "ssd_intra": time_ssd_intra(torch, ssd_ins, ssd_cs),
        "rbf_gram": time_gram(torch, xq_line, anchor_table, prob32.kernel.gamma),
    }
    for name, t in timing.items():
        print(f"kernels: {name} timing: " + json.dumps(t))

    # 2b. the invariant audit on the card -----------------------------------
    audit_readings = run_audit(torch)
    print("audit: " + json.dumps(audit_readings))

    # 3. the main path through the port's launcher ---------------------------
    mods = {"color_step": color_step, "knn_fuse": knn_fuse, "kernel_matvec": kernel_matvec,
            "ssd_intra": ssd_intra, "rbf_gram": gram}
    field = ("color_step", "knn_fuse", "kernel_matvec")
    argv, _ = main_args()
    print("main: python -m repro_torch.launch.serve " + " ".join(argv))
    for mod in mods.values():
        mod.launches = 0
    res = serve.main(argv)
    torch.cuda.synchronize()
    launches = {name: mods[name].launches for name in field}
    print("main: kernel launches " + json.dumps(launches))
    # one launch per call: colored_sweep and each serving request run twice
    # (the launcher's warm-up and its timed call)
    want = launch_ledger.expected({"sweep.colored.cuda": res["train_calls"],
                                   "serving.knn.cuda": serve.TIMED_CALLS,
                                   "kernels.matvec": serve.TIMED_CALLS})
    expected = {name: want[name] for name in field}
    check(launches == expected,
          f"main: kernel launches {launches}, expected one per call: {expected}")
    prob, state, xq = res["problem"], res["state"], res["xq"]
    b, q = args.fields, args.queries
    for key in ("knn", "conn"):
        check(res[key].shape == (b, q) and bool(torch.isfinite(res[key]).all()),
              f"main {key}: shape {tuple(res[key].shape)} or non-finite values")
    # the same pipeline through the plain engines, on the card
    plain = colored_sweep(prob, init_state(prob), n_sweeps=args.sweeps, engine="plan")
    err_z = max_err(state.z, plain.z)
    err_c = max_err(state.coef, plain.coef)
    knn_plain = fusion.fuse(prob, plain, xq, "knn", k=args.k, engine="plan",
                            plan=make_serving_plan(prob, k=args.k))
    anchors, coefs = fusion.global_coefficients(prob, plain, rule="conn")
    conn_plain = kernel_matvec.kernel_matvec_ref(xq, anchors, coefs, args.gamma)
    err_knn_e2e = max_err(res["knn"], knn_plain)
    err_conn_e2e = max_err(res["conn"], conn_plain)
    print(f"main: vs plain engines on the card: max |dz| {err_z:.3g}, |dcoef| {err_c:.3g}, "
          f"knn {err_knn_e2e:.3g}, conn {err_conn_e2e:.3g}")
    check(err_z <= 2e-4 and err_c <= 2e-2, "main: trained state differs from the plan engine")
    check(err_knn_e2e <= 2e-4, "main: kNN answers differ from the plain engines")
    check(err_conn_e2e <= 2e-5, "main: conn answers differ from the plain engines")

    # 3b. the streaming path through the port's launcher, then dense waves ----
    stream_launches, stream_readings = run_stream_launcher(torch, mods)
    stream_readings["waves"] = run_waves(torch)
    print("main-stream: " + json.dumps(stream_readings))

    # 3c. the join/leave lifecycle through the port's launcher ----------------
    churn_launches, churn_readings = run_churn_launcher(torch, mods)
    churn_readings["lifecycle"] = run_lifecycle(torch, mods)
    print("main-churn: " + json.dumps(churn_readings))

    # 3d. training under unreliable links through the port's launcher -------
    t0 = time.perf_counter()
    fault_launches, fault_readings = {}, {}
    for name in FAULT_SPECS:
        got, fault_readings[name] = run_faults_launcher(torch, mods, name)
        fault_launches = {key: fault_launches.get(key, 0) + v for key, v in got.items()}
    fault_readings.update(run_faults_checks(torch, mods))
    fault_readings["phase_s"] = time.perf_counter() - t0
    print("main-faults: " + json.dumps(fault_readings))

    # 3e. the serving daemon, then the launcher's --energy_tau ---------------
    t0 = time.perf_counter()
    daemon_launches, daemon_readings, _ = run_daemon(torch, mods)
    daemon_readings["cli"] = run_daemon_cli(torch)
    live = representer_energy(prob, state)[: prob.n][prob.alive[: prob.n]]
    prune_launches, daemon_readings["prune"] = run_prune_launcher(
        torch, mods, float(torch.quantile(live, DAEMON_PRUNE_Q)))
    daemon_readings["phase_s"] = time.perf_counter() - t0
    print("main-daemon: " + json.dumps(daemon_readings))

    # 3f. the multi-device layer over an NCCL group of one -------------------
    ctx = init_group(0, 1, device="cuda")
    t0 = time.perf_counter()
    sharded_launches, sharded_readings = run_sharded(torch, mods, ctx)
    sharded_readings["lm_collectives"] = run_consensus_lm(torch, ctx)
    sharded_readings["phase_s"] = time.perf_counter() - t0
    print("main-sharded: " + json.dumps(sharded_readings))

    # 3g. the data-parallel train step, then the training launcher ------------
    t0 = time.perf_counter()
    train_launches, train_readings = run_train(torch, mods, ctx)
    train_readings["phase_s"] = time.perf_counter() - t0
    print("main-train: " + json.dumps(train_readings))
    dist.destroy_process_group()

    # 4. the LM path through the port's launcher -----------------------------
    print("main-lm: python -m repro_torch.launch.serve " + " ".join(LM_ARGV))
    for mod in mods.values():
        mod.launches = 0
    t0 = time.perf_counter()
    lm = serve.main(LM_ARGV)
    torch.cuda.synchronize()
    lm_launches = {name: mod.launches for name, mod in mods.items()}
    print("main-lm: kernel launches " + json.dumps(lm_launches)
          + f" ({lm['prefill_calls']} prefill calls, the warm-up included)")
    cfg = lm["cfg"]
    want = launch_ledger.expected({"lm.prefill.ssd": cfg.n_layers * lm["prefill_calls"]})
    check(lm_launches["ssd_intra"] == want["ssd_intra"],
          f"main-lm: ssd_intra launched {lm_launches['ssd_intra']} times, expected "
          f"{cfg.n_layers} per prefill x {lm['prefill_calls']}")
    check(lm_launches == want, f"main-lm: a kernel off the LM path was launched: {lm_launches}")
    b_lm, gen = (int(LM_ARGV[LM_ARGV.index(flag) + 1]) for flag in ("--batch", "--gen"))
    check(lm["logits"].shape == (b_lm, 1, cfg.vocab_size)
          and bool(torch.isfinite(lm["logits"]).all()), "main-lm: prefill logits")
    check(lm["tokens"].shape == (b_lm, gen) and int(lm["tokens"].min()) >= 0
          and int(lm["tokens"].max()) < cfg.vocab_size, "main-lm: generated tokens")
    print(f"main-lm: {cfg.name} ({cfg.n_params() / 1e6:.1f}M params, {cfg.dtype}) "
          f"prefill {lm['prefill_s']:.4f}s, decode {lm['tok_s']:.1f} tok/s, "
          f"launcher {time.perf_counter() - t0:.1f}s")
    lm_readings = compare_lm(torch, lm)
    # each path's launches, counted from 0 around its run (rbf_gram: on none)
    by_path = {"field": launches, "stream": stream_launches, "churn": churn_launches,
               "faults": fault_launches, "daemon": daemon_launches, "prune": prune_launches,
               "sharded": sharded_launches, "train": train_launches, "lm": lm_launches}

    # 5. report --------------------------------------------------------------
    meta = {
        "color_step": ("src/repro_torch/kernels/csrc/color_step.cu",
                       "src/repro/kernels/color_step.py:38", err_cs),
        "knn_fuse": ("src/repro_torch/kernels/csrc/knn_fuse.cu",
                     "src/repro/kernels/knn_fuse.py:73", err_knn),
        "kernel_matvec": ("src/repro_torch/kernels/csrc/kernel_matvec.cu",
                          "src/repro/kernels/kernel_matvec.py:52", err_mv),
        "ssd_intra": ("src/repro_torch/kernels/csrc/ssd_intra.cu",
                      "src/repro/kernels/ssd_intra.py:30", err_ssd),
        "rbf_gram": ("src/repro_torch/kernels/csrc/gram.cu",
                     "src/repro/kernels/gram.py:19", err_gram),
    }
    rows = []
    for name, (source, replaces, err) in meta.items():
        t = timing[name]
        counts = {path: got.get(name, 0) for path, got in by_path.items()}
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": sum(counts.values()), "launches_by_path": counts,
                     "max_abs_err": err, "ms": t["ms"],
                     "call_ms": t["call_ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print("main-lm: " + json.dumps({"f32_vs_plain_and_f64": lm_readings}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
