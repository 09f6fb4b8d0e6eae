"""The multi-device layer on W local cards, one rank per card (NCCL), or on
W gloo ranks on the CPU:

    python -m repro_torch.launch.multi_gpu --world 4

Every rank checks, and rank 0 prints, at chip_smoke's geometries:
  1. the field-sharded ``sharded_sweep`` (n = 1000, B = 16, 30 sweeps,
     engine cuda; without and with a 10% drop mask) against
     ``colored_sweep`` of the whole batch on the rank's own device: 1e-5
     (the kernel runs one thread-block cluster per field, so the fields are
     expected bitwise; the line says whether they are);
  2. the sensor regime on field 0 (plan transport, members split over the
     ranks) against ``colored_sweep(engine="plan")``: z 2e-4, coef 2e-2;
  3. the gossip on float32 replicas drawn per rank: a hypercube sweep
     equals ``allreduce_average`` (1e-5), ``neighborhood_average`` the
     (x_{r-1} + x_r + x_{r+1}) / 3 stencil of an all-gather (1e-6), ring
     gossip rounds never raise ``consensus_sq`` (Lemma 2.1);
  4. the data-parallel train step of ``mamba2-370m`` (the launcher's build:
     AdamW on its cosine schedule; global batch 8 x 128 split over the
     ranks), ``--steps`` steps per dp_mode: the loss falls, all-reduce
     replicas stay bitwise equal (``consensus_sq`` exactly 0), gossip
     reports its disagreement;
and times the sharded call beside ``colored_sweep`` (in turns), the
all-gathers, the gossip collectives over the model's parameters and the
train step.  One JSON line closes; any failed check raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import distributed, tree
from ..configs import get_config
from ..core import (colored_sweep, consensus, field_view, init_state, sharded_sweep)
from ..data import synthetic_lm_stream
from ..kernels import _build
from ..models import init_params
from . import serve
from .train import build


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"multi_gpu check failed: {what}")


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def _ms(fn, dev: torch.device, reps: int = 10) -> float:
    """Mean ms per call of ``fn`` after one warm-up call, ending in a sync."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _field_checks(ctx, args) -> dict:
    argv = ["--device", str(ctx.device), "--fields", str(args.fields), "--sensors",
            str(args.sensors), "--dim", "2", "--radius", repr(0.3 * (100.0 / args.sensors) ** 0.5),
            "--lam", "0.1", "--seed", "0"]
    prob = serve.build_problem(serve.parser().parse_args(argv))
    st0 = init_state(prob)
    g, sweeps, out = ctx.group, args.sweeps, {}
    rng = np.random.default_rng(5)
    deliv = torch.as_tensor(rng.uniform(size=(sweeps,) + tuple(prob.nbr_idx.shape)) >= 0.1,
                            device=prob.device)
    for tag, mask in (("field", None), ("field+drops", deliv)):
        got = sharded_sweep(prob, st0, g, n_sweeps=sweeps, engine="cuda", delivered=mask)
        want = colored_sweep(prob, st0, n_sweeps=sweeps, engine="cuda", delivered=mask)
        err = max(_err(got.z, want.z), _err(got.coef, want.coef))
        out[tag] = dict(err=err, bitwise=bool(torch.equal(got.z, want.z)
                                              and torch.equal(got.coef, want.coef)))
        _check(err <= 1e-5, f"{tag}: sharded vs colored {err}")
    fv, fs = field_view(prob, st0, 0)
    got = sharded_sweep(fv, fs, g, n_sweeps=sweeps)
    want = colored_sweep(fv, fs, n_sweeps=sweeps, engine="plan")
    out["sensor"] = dict(err_z=_err(got.z, want.z), err_coef=_err(got.coef, want.coef))
    _check(out["sensor"]["err_z"] <= 2e-4 and out["sensor"]["err_coef"] <= 2e-2,
           f"sensor regime vs colored: {out['sensor']}")
    ms = {"sharded": [], "colored": []}
    for name in ("colored", "sharded", "sharded", "colored"):
        fn = (lambda: sharded_sweep(prob, st0, g, n_sweeps=sweeps, engine="cuda")) \
            if name == "sharded" else (lambda: colored_sweep(prob, st0, n_sweeps=sweeps,
                                                             engine="cuda"))
        ms[name].append(_ms(fn, ctx.device))
    zb = st0.z.new_empty(st0.z.shape)
    cb = st0.coef.new_empty(st0.coef.shape)
    b_local = prob.batch_size // ctx.world
    out["ms"] = ms
    out["gather_ms"] = _ms(lambda: (distributed.all_gather_into(zb, st0.z[:b_local], g),
                                    distributed.all_gather_into(cb, st0.coef[:b_local], g)),
                           ctx.device, reps=20)
    t0 = time.perf_counter()
    sharded_sweep(fv, fs, g, n_sweeps=sweeps)
    _sync(ctx.device)
    out["sensor_call_s"] = time.perf_counter() - t0
    return out


def _gossip_checks(ctx) -> dict:
    w, g = ctx.world, ctx.group
    rng = np.random.default_rng(100 + ctx.rank)
    mine = {k: torch.as_tensor(rng.normal(size=s).astype(np.float32), device=ctx.device)
            for k, s in (("a", (64, 33)), ("b", (1000,)))}
    full = {k: distributed.all_gather_into(v.new_empty((w,) + tuple(v.shape)), v[None], g)
            for k, v in mine.items()}
    mean = consensus.allreduce_average(mine, g)
    out = {}
    if w & (w - 1) == 0:
        swept = mine
        for partners in consensus.hypercube_schedule(w):
            swept = consensus.pairwise_project(swept, g, partners)
        out["hypercube_vs_mean"] = max(_err(swept[k], mean[k]) for k in mine)
        _check(out["hypercube_vs_mean"] <= 1e-5, "hypercube sweep vs the mean")
    nb = consensus.neighborhood_average(mine, g, w)
    r = ctx.rank
    out["neighborhood_vs_stencil"] = max(
        _err(nb[k], (full[k][(r - 1) % w] + full[k][r] + full[k][(r + 1) % w]) / 3.0)
        for k in mine)
    _check(out["neighborhood_vs_stencil"] <= 1e-6, "neighborhood average vs the stencil")
    if w % 2 == 0:
        ring, t = consensus.ring_schedule(w), mine
        sq = [float(consensus.consensus_sq_distance(t, g))]
        for i in range(6):
            t = consensus.gossip_round(t, g, ring, i)
            sq.append(float(consensus.consensus_sq_distance(t, g)))
        out["ring_consensus_sq"] = sq
        _check(all(b <= a * (1 + 1e-5) + 1e-7 for a, b in zip(sq, sq[1:])),
               f"ring gossip raised the disagreement: {sq}")
    return out


def _train_checks(ctx, args) -> dict:
    cfg = get_config("mamba2-370m", variant=None if args.variant == "full" else "smoke")
    stream = synthetic_lm_stream(cfg.vocab_size, args.seq, args.batch, seed=0)
    rows = args.batch // ctx.world
    lo = ctx.rank * rows
    batches = [{k: torch.as_tensor(v[lo:lo + rows], device=ctx.device)
                for k, v in stream.batch_at(i).items()} for i in range(args.steps)]
    out = {}
    for dp_mode in ("allreduce", "sop_gossip"):
        opt, step = build(cfg, dp_mode=dp_mode, lr=3e-4, steps=args.steps, group=ctx.group,
                          world=ctx.world)
        params = init_params(cfg, 0, device=ctx.device)
        state = opt.init(params)
        losses, times = [], []
        for i in range(args.steps):
            t0 = time.perf_counter()
            params, state, m = step(params, state, batches[i], i)
            m = consensus.allreduce_average(m, ctx.group)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
        sq = float(consensus.consensus_sq_distance(params, ctx.group))
        _check(all(np.isfinite(losses)) and losses[-1] < losses[0],
               f"{dp_mode}: the loss did not fall: {losses}")
        if dp_mode == "allreduce":
            _check(sq == 0.0, f"allreduce replicas differ: consensus_sq {sq}")
        out[dp_mode] = dict(losses=losses, consensus_sq=sq,
                            s_per_step=float(np.mean(times[1:])),
                            tokens_per_s=args.batch * args.seq / float(np.mean(times[1:])))
        if dp_mode == "sop_gossip":
            leaves = tree.leaves(params)
            out["lm_ms"] = {
                "allreduce_average": _ms(lambda: consensus.allreduce_average(leaves, ctx.group),
                                         ctx.device, reps=5),
                "gossip_round": _ms(lambda: consensus.gossip_round(
                    leaves, ctx.group, consensus.ring_schedule(ctx.world)
                    if ctx.world % 2 == 0 else [list(range(ctx.world))], 0), ctx.device, reps=5),
                "bytes": sum(x.numel() * x.element_size() for x in leaves)}
        del params, state
    return out


def run(ctx: distributed.RankContext, args: argparse.Namespace) -> dict:
    out = {"world": ctx.world, "device": str(ctx.device)}
    if ctx.device.type == "cuda":
        out["kind"] = torch.cuda.get_device_name(ctx.device)
    for name, fn in (("fields", lambda: _field_checks(ctx, args)),
                     ("gossip", lambda: _gossip_checks(ctx)),
                     ("train", lambda: _train_checks(ctx, args))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name]["phase_s"] = time.perf_counter() - t0
        if ctx.rank == 0:
            print(f"{name}: " + json.dumps(out[name]), flush=True)
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.multi_gpu")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: the number of cards; on the CPU it must be given)")
    ap.add_argument("--sensors", type=int, default=1000)
    ap.add_argument("--fields", type=int, default=16)
    ap.add_argument("--sweeps", type=int, default=30)
    ap.add_argument("--variant", default="full", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=6)
    return ap


def main(argv: list[str] | None = None) -> list:
    args = parser().parse_args(argv)
    world = args.world
    if world is None:
        if distributed.rank_device(0, args.device).type != "cuda":
            raise ValueError("--world must be given on the CPU")
        world = torch.cuda.device_count()
    if distributed.rank_device(0, args.device).type == "cuda":
        _build.build_all()  # once, before the ranks start
    results = distributed.spawn(run, world, args, device=args.device)
    print(json.dumps({"multi_gpu": results[0]}))
    return results


if __name__ == "__main__":
    main()
