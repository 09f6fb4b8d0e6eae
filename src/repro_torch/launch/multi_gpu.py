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
  5. the spec-placed FSDP/TP step (``sharding.steps``) on a data x model
     grid (2 x 2 on four ranks; ``fsdp_grid``): nemotron-4-15b's smoke
     variant in float32, two AdamW steps against the unsharded
     ``make_train_step`` on the whole batch 8 x 128 on every rank (loss,
     this rank's slices of the parameters and moments: 2e-5 absolute + 2e-5
     relative; whether they are bitwise equal), then nemotron-4-15b at
     full width with its depth cut to what fits the card (``fsdp_depth``;
     ``--variant full``), two timed steps, its first loss against
     ``loss_fn`` on the unsharded model;
  6. sharded prefill and decode (``sharding.serve``) on the grids 1 x W and,
     for an even W > 2, 2 x W/2 (``serve_grids``): smollm-135m (3 kv heads:
     the cache length is split) and qwen1.5-32b (40 kv heads: the heads
     are split) at full width, depth cut so that the unsharded float32
     model fills at most ``SERVE_SHARE`` of the card (``serve_depth``), in
     float32: a --batch x --seq prompt and 4 teacher-forced decode steps
     against the unsharded ``prefill`` / ``decode_step`` on the rank's own
     card (the logits of its rows, 2e-5 absolute + 2e-5 relative, or, past
     that bound, the float64 witness rule: against a float64 run of the same
     weights the sharded error at most ``SERVE_WITNESS_FACTOR`` times the
     unsharded float32 run's); then in
     bf16, 4 x 512 prompts and 32 greedy tokens (the smoke variant: 4 x
     --seq and 4) timed on each grid beside the unsharded path
     (``serve_times``), with the peak memory per card against
     ``serve.reckon``;
and times the sharded call beside ``colored_sweep`` (in turns), the
all-gathers, the gossip collectives over the model's parameters and the
train step.  One JSON line closes; any failed check raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from .. import distributed, tree
from ..configs import get_config
from ..core import (colored_sweep, consensus, field_view, init_state, sharded_sweep)
from ..data import synthetic_lm_stream
from ..kernels import _build
from ..models import init_params, loss_fn, make_train_step
from ..optim import adamw, cosine_warmup
from ..models import decode_step, init_cache, prefill
from ..sharding import batch_pspecs, param_pspecs, param_shapes
from ..sharding import serve as sharded_serve
from ..sharding import steps as sharded
from . import serve
from .train import build

FSDP_ARCH = "nemotron-4-15b"
FSDP_SHARE = 0.9  # of the card's memory that the reckoned cut may fill
FSDP_STEPS = 2
FSDP_TOL = (2e-5, 2e-5)  # absolute, relative
SERVE_ARCHS = ("smollm-135m", "qwen1.5-32b")
SERVE_SHARE = 0.3  # of the card that the unsharded float32 model may fill
SERVE_STEPS = 4  # teacher-forced decode steps of the float32 check
# Past the float32 bound, the sharded run's error against a float64 run of
# the same weights may be at most this multiple of the unsharded run's (the
# rule of chip_smoke's LM_WITNESS_FACTOR).  The split reorders float32 sums
# only, so the two errors are of one size: qwen1.5-32b's came 1.02 apart on
# four H100s (PERF.md), so 2 leaves room above that.
SERVE_WITNESS_FACTOR = 2.0
SERVE_B, SERVE_PROMPT, SERVE_GEN = 4, 512, 32  # bf16 timings at full width


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


def fsdp_grid(world: int) -> tuple[int, int]:
    """(data, model) of the FSDP phase's grid: 2 x 2 on four ranks, 1 x 1 on one."""
    model = 2 if world % 2 == 0 else 1
    return world // model, model


def fsdp_config(variant: str, depth: int = 2):
    """nemotron-4-15b: its smoke variant, or full width cut to ``depth`` layers."""
    if variant == "full":
        return dataclasses.replace(get_config(FSDP_ARCH), n_layers=depth)
    return get_config(FSDP_ARCH, variant="smoke")


def fsdp_bytes(cfg, grid: sharded.Grid) -> dict:
    """This rank's bytes in the sharded step, counted from the shapes: its
    shards (the model's dtype), the AdamW moments of its shards (float32),
    the gathered full copy and its full gradients (the model's dtype; the
    MoE router float32 is counted at the model's dtype)."""
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    shapes = param_shapes(cfg)
    specs = param_pspecs(cfg, shapes, grid)
    full = sum(int(np.prod(s)) for s in shapes.values())
    local = 0
    for name, shape in shapes.items():
        parts = int(np.prod([grid.shape[a] for _, a in sharded.split_dims(specs[name], grid)]))
        local += int(np.prod(shape)) // parts
    return {"params": full, "local_params": local, "shards": local * item,
            "moments": local * 8, "gathered": full * item, "grads": full * item,
            "total": local * (item + 8) + 2 * full * item}


def fsdp_norm_bytes(cfg) -> int:
    """The float32 copy and square of the largest gradient, for its norm."""
    return 8 * max(int(np.prod(s)) for s in param_shapes(cfg).values())


def fsdp_depth(grid: sharded.Grid, card_bytes: int) -> int:
    """The deepest full-width cut of nemotron-4-15b whose reckoned bytes on
    this rank (``fsdp_bytes`` and ``fsdp_norm_bytes``) fill at most
    ``FSDP_SHARE`` of ``card_bytes``; 0 where not even one layer fits."""
    full = get_config(FSDP_ARCH)
    depth = 0
    while depth < full.n_layers:
        cfg = fsdp_config("full", depth + 1)
        if fsdp_bytes(cfg, grid)["total"] + fsdp_norm_bytes(cfg) > FSDP_SHARE * card_bytes:
            break
        depth += 1
    return depth


def _fsdp_batches(cfg, batch: int, seq: int, n: int, dev) -> list[dict]:
    stream = synthetic_lm_stream(cfg.vocab_size, seq, batch, seed=0)
    return [{k: torch.as_tensor(v, device=dev) for k, v in stream.batch_at(i).items()}
            for i in range(n)]


def _fsdp_optimizer():
    return adamw(cosine_warmup(3e-4, 1, 10))


def fsdp_vs_unsharded(ctx, grid: sharded.Grid, cfg, batch: int = 8, seq: int = 128) -> dict:
    """``FSDP_STEPS`` sharded steps against the unsharded ``make_train_step``
    on the whole batch (both from ``init_params(cfg, 0)``): the losses, and
    this rank's slices of the parameters and moments, within ``FSDP_TOL``."""
    batches = _fsdp_batches(cfg, batch, seq, FSDP_STEPS, ctx.device)
    opt = _fsdp_optimizer()
    ref = init_params(cfg, 0, device=ctx.device)
    ref_state = opt.init(ref)
    ref_step = make_train_step(cfg, opt, dp_mode="none")
    want = []
    for b in batches:
        ref, ref_state, m = ref_step(ref, ref_state, b)
        want.append(float(m["loss"]))
    params = init_params(cfg, 0, device=ctx.device)
    specs = param_pspecs(cfg, params, grid)
    shards, state = sharded.place(params, opt.init(params), specs, grid)
    step = sharded.build_train(cfg, grid, opt)
    got = []
    for b in batches:
        shards, state, m = step(shards, state, b)
        got.append(float(m["loss"]))
    leaves = dict(ref.named_parameters())
    err, excess, bitwise = 0.0, -1.0, got == want
    for i, (name, x) in enumerate(shards.items()):
        for have, full in ((x, leaves[name]), (state["mu"][i], ref_state["mu"][i]),
                           (state["nu"][i], ref_state["nu"][i])):
            part = sharded.local_slice(full, specs[name], grid)
            d = (have.double() - part.double()).abs()
            err = max(err, float(d.max()))
            excess = max(excess, float((d - FSDP_TOL[0] - FSDP_TOL[1] * part.double().abs()).max()))
            bitwise = bitwise and bool(torch.equal(have, part))
    loss_err = max(abs(a - b) for a, b in zip(got, want))
    _check(all(abs(a - b) <= FSDP_TOL[0] + FSDP_TOL[1] * abs(b) for a, b in zip(got, want)),
           f"fsdp: sharded losses {got} vs unsharded {want}")
    _check(excess <= 0.0, f"fsdp: a slice differs from the unsharded step by {err}")
    return dict(arch=cfg.name, dtype=cfg.dtype, grid=[grid.shape["data"], grid.shape["model"]],
                losses=got, unsharded_losses=want, loss_err=loss_err, max_abs_err=err,
                bitwise=bitwise)


def fsdp_train(ctx, grid: sharded.Grid, cfg, batch: int = 8, seq: int = 128,
               steps: int = FSDP_STEPS) -> dict:
    """``steps`` timed sharded steps of ``cfg`` (random weights from seed 0):
    s/step, the peak memory, the losses (finite), the first against
    ``loss_fn`` of the unsharded model on the whole batch (2e-5)."""
    batches = _fsdp_batches(cfg, batch, seq, steps, ctx.device)
    opt = _fsdp_optimizer()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    params = init_params(cfg, 0, device=ctx.device)
    with torch.no_grad():
        first = float(loss_fn(cfg, params, batches[0])[0])
    specs = param_pspecs(cfg, params, grid)
    shards, _ = sharded.place(params, {}, specs, grid)
    del params
    # AdamW's state starts at zero: made for the shards, the full moments
    # (8 bytes per parameter) never exist on a rank
    state = opt.init(list(shards.values()))
    step = sharded.build_train(cfg, grid, opt)
    losses, times = [], []
    for b in batches:
        t0 = time.perf_counter()
        shards, state, m = step(shards, state, b)
        losses.append(float(m["loss"]))  # one host read per step
        times.append(time.perf_counter() - t0)
    _check(all(np.isfinite(losses)), f"fsdp: non-finite loss {losses}")
    _check(abs(losses[0] - first) <= FSDP_TOL[0] + FSDP_TOL[1] * abs(first),
           f"fsdp: the first step's loss {losses[0]} vs loss_fn {first}")
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype,
               grid=[grid.shape["data"], grid.shape["model"]], losses=losses,
               loss_fn_first=first, first_bitwise=losses[0] == first, s_per_step=times,
               reckoned=fsdp_bytes(cfg, grid))
    if ctx.device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device)
    del shards, state, step
    return out


def _fsdp_checks(ctx, args) -> dict:
    grid = sharded.make_grid(ctx, *fsdp_grid(ctx.world))
    out = {"vs_unsharded": fsdp_vs_unsharded(ctx, grid, get_config(FSDP_ARCH, variant="smoke"),
                                             args.batch, args.seq)}
    depth = 2
    if ctx.device.type == "cuda":
        depth = fsdp_depth(grid, torch.cuda.get_device_properties(ctx.device).total_memory)
        _check(depth >= 1, "fsdp: no layer of the full-width model fits the card")
    out["train"] = fsdp_train(ctx, grid, fsdp_config(args.variant, depth), args.batch, args.seq)
    return out


def serve_grids(world: int) -> list[tuple[int, int]]:
    """(data, model) of the serving check's grids: 1 x W, and 2 x W/2 for an
    even W > 2."""
    return [(1, world)] + ([(2, world // 2)] if world > 2 and world % 2 == 0 else [])


def serve_depth(cfg, card_bytes: int) -> int:
    """The deepest cut of ``cfg`` whose float32 parameters fill at most
    ``SERVE_SHARE`` of ``card_bytes`` (every layer alike)."""
    shapes = param_shapes(dataclasses.replace(cfg, n_layers=1))
    layer = sum(4 * int(np.prod(s)) for n, s in shapes.items() if n.startswith("layers."))
    root = sum(4 * int(np.prod(s)) for n, s in shapes.items() if not n.startswith("layers."))
    return max(0, min(cfg.n_layers, int((SERVE_SHARE * card_bytes - root) // layer)))


def serve_times(prefill, decode, prompt: torch.Tensor, gen: int, dev: torch.device) -> dict:
    """``prefill(prompt) -> (logits, cache)`` on a fresh cache and
    ``decode(token, cache, position) -> (logits, cache)``: a warm-up prefill
    and step, then the timed prefill and ``gen`` greedy steps (host clock,
    each ending in a sync); their logits and the tokens."""
    b, s0 = prompt.shape
    logits, cache = prefill(prompt)
    decode(torch.argmax(logits[:, -1:], dim=-1), cache, s0)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(prompt)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out, toks = [logits], []
    t0 = time.perf_counter()
    for i in range(gen):
        logits, cache = decode(tok, cache, s0 + i)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(logits)
        toks.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return dict(prefill_s=prefill_s, decode_s=decode_s, tok_s=b * gen / decode_s, logits=out,
                tokens=torch.cat(toks, dim=1))


def _unsharded_logits(cfg, toks, prompt: int, max_seq: int, dev) -> list:
    """``_teacher_forced`` of the unsharded model of ``cfg`` (weights from
    seed 0), which is freed before it returns."""
    params = init_params(cfg, 0, device=dev)
    out = _teacher_forced(
        cfg, lambda b: prefill(cfg, params, b, init_cache(cfg, toks.shape[0], max_seq,
                                                          device=dev)),
        lambda t, c, i: decode_step(cfg, params, t, c, i), toks, prompt)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _teacher_forced(cfg, prefill_fn, decode_fn, toks, prompt: int) -> list:
    logits, cache = prefill_fn({"tokens": toks[:, :prompt]})
    out = [logits]
    for t in range(SERVE_STEPS):
        logits, cache = decode_fn(toks[:, prompt + t:prompt + t + 1], cache, prompt + t)
        out.append(logits)
    return out


def _serve_checks(ctx, args) -> dict:
    dev = ctx.device
    grids = {g: sharded.make_grid(ctx, *g) for g in serve_grids(ctx.world)}
    card = torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda" else None
    out = {}
    for arch in SERVE_ARCHS:
        base = get_config(arch, variant="smoke" if args.variant == "smoke" else None)
        depth = serve_depth(base, card) if card else base.n_layers
        _check(depth >= 1, f"serve: no layer of {arch} fits the card")
        cfg = dataclasses.replace(base, n_layers=depth, dtype="float32")
        rng = np.random.default_rng(3)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (args.batch, args.seq + SERVE_STEPS)), device=dev)
        max_seq = args.seq + SERVE_STEPS + 4
        # the same weights in float64 (init_params draws in float32, then casts)
        witness = _unsharded_logits(dataclasses.replace(cfg, dtype="float64"), toks, args.seq,
                                    max_seq, dev)
        params = init_params(cfg, 0, device=dev)
        want = _teacher_forced(
            cfg, lambda b: prefill(cfg, params, b, init_cache(cfg, args.batch, max_seq,
                                                              device=dev)),
            lambda t, c, i: decode_step(cfg, params, t, c, i), toks, args.seq)
        plain_vs_f64 = max(_err(w, f) for w, f in zip(want, witness))
        res = {"n_layers": depth, "float32": {}, "bf16": {},
               "unsharded_vs_float64": plain_vs_f64}
        for shape, grid in grids.items():
            shards, _ = sharded.place(params, {}, param_pspecs(cfg, params, grid), grid)
            pre = sharded_serve.build_prefill(cfg, grid, args.batch, max_seq)
            dec = sharded_serve.build_decode(cfg, grid, args.batch, max_seq, prefill=pre)
            got = _teacher_forced(
                cfg, lambda b: pre(shards, b, sharded_serve.init_cache(cfg, grid, args.batch,
                                                                       max_seq)),
                lambda t, c, i: dec(shards, t, c, i), toks, args.seq)
            rows = sharded.local_slice(torch.arange(args.batch, device=dev),
                                       batch_pspecs(cfg, {"t": (args.batch,)}, grid)["t"], grid)
            err, excess = 0.0, -1.0
            for g, w in zip(got, want):
                d = (g.double() - w[rows].double()).abs()
                err = max(err, float(d.max()))
                excess = max(excess, float((d - FSDP_TOL[0]
                                            - FSDP_TOL[1] * w[rows].double().abs()).max()))
            vs_f64 = max(_err(g, f[rows]) for g, f in zip(got, witness))
            res["float32"][f"{shape[0]}x{shape[1]}"] = dict(
                max_abs_err=err, within_bound=excess <= 0.0, vs_float64=vs_f64)
            # past the bound, both float32 runs are held to the float64 one
            _check(excess <= 0.0 or vs_f64 <= SERVE_WITNESS_FACTOR * plain_vs_f64,
                   f"serve: {arch} on {shape} differs from unsharded by {err}, from float64 "
                   f"by {vs_f64} (the unsharded float32 run: {plain_vs_f64})")
            del shards, pre, dec
        del params
        # the LM launcher's geometry on the card; the smoke variant at --seq
        full = args.variant == "full"
        res["bf16"] = _serve_bf16(ctx, grids, dataclasses.replace(cfg, dtype="bfloat16"),
                                  SERVE_PROMPT if full else args.seq,
                                  SERVE_GEN if full else SERVE_STEPS)
        out[arch] = res
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _serve_bf16(ctx, grids: dict, cfg, s0: int, gen: int) -> dict:
    """``serve_times`` of the sharded path on each grid, then the unsharded
    path, in bf16 at SERVE_B x ``s0`` and ``gen`` tokens; the peak memory of
    each (the sharded run holds only the shards)."""
    dev = ctx.device
    b = SERVE_B
    max_seq = s0 + gen + 1
    prompt = torch.as_tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (b, s0)),
                             device=dev)
    out = {}
    for shape, grid in grids.items():
        params = init_params(cfg, 0, device=dev)
        shards, _ = sharded.place(params, {}, param_pspecs(cfg, params, grid), grid)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        pre = sharded_serve.build_prefill(cfg, grid, b, max_seq)
        dec = sharded_serve.build_decode(cfg, grid, b, max_seq, prefill=pre)
        r = serve_times(lambda p: pre(shards, {"tokens": p},
                                      sharded_serve.init_cache(cfg, grid, b, max_seq)),
                        lambda t, c, i: dec(shards, t, c, i), prompt, gen, dev)
        out[f"{shape[0]}x{shape[1]}"] = dict(
            prefill_s=r["prefill_s"], tok_s=r["tok_s"],
            peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
            reckoned=sharded_serve.reckon(cfg, grid, b, max_seq))
        del shards, pre, dec, r
    params = init_params(cfg, 0, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    r = serve_times(lambda p: prefill(cfg, params, {"tokens": p},
                                      init_cache(cfg, b, max_seq, device=dev)),
                    lambda t, c, i: decode_step(cfg, params, t, c, i), prompt, gen, dev)
    out["unsharded"] = dict(
        prefill_s=r["prefill_s"], tok_s=r["tok_s"],
        peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None)
    del params, r
    return out


def run(ctx: distributed.RankContext, args: argparse.Namespace) -> dict:
    out = {"world": ctx.world, "device": str(ctx.device)}
    if ctx.device.type == "cuda":
        out["kind"] = torch.cuda.get_device_name(ctx.device)
    for name, fn in (("fields", lambda: _field_checks(ctx, args)),
                     ("gossip", lambda: _gossip_checks(ctx)),
                     ("train", lambda: _train_checks(ctx, args)),
                     ("fsdp", lambda: _fsdp_checks(ctx, args)),
                     ("serve", lambda: _serve_checks(ctx, args))):
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
