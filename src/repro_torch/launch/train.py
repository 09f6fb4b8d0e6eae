"""Training launcher of the port (the reference's ``repro.launch.train``).

One process per rank in a ``torch.distributed`` group (NCCL on the card,
gloo on the CPU).  ``--world W`` ranks are spawned on this host (default:
the number of cards; on the CPU it must be given); under torchrun the
process is the rank torchrun's ``RANK`` / ``WORLD_SIZE`` name.  Every rank
builds the same parameters from ``--seed`` and takes rows [r B/W, (r+1) B/W)
of global batch i (``stream.batch_at(i)``), as the reference's ``P("data")``
splits it.  Data parallelism, with the paper's technique as the transport:

  --dp_mode allreduce   gradients averaged every step: the centralized
                        special case (complete graph; paper Lemma 3.1)
  --dp_mode sop_gossip  local steps + one SOP pairwise-projection round per
                        step on a hypercube (power-of-two W) or ring
                        pairing schedule: SN-Train's relaxed neighbor
                        coupling in parameter space

Metrics are averaged over the group.  ``--ckpt_dir`` saves every
``--ckpt_every`` steps from rank 0, in the reference's layout: the
parameters' and optimizer state's leaves stacked on a leading replica axis;
a restart restores each rank's replica and resumes at the saved step.
``--arch`` defaults to ``smollm-135m``, as in the reference.  Every
decoder trains on tokens only, as the reference's launcher feeds them (the
VLM without its patch prefix).  The launcher has no frames to feed, so it
refuses an encoder-decoder (``whisper-tiny``) with a ``ValueError``; that
trains through ``models.make_train_step`` with a batch that holds
``frames``.  An MoE model's loss holds the router terms
(``models.loss_fn``), after attention or a Mamba2 mixer alike; the
returned metrics carry ``aux_loss`` and ``z_loss``.

Example (CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
    --variant smoke --steps 3 --batch 4 --seq 32 --dp_mode sop_gossip \\
    --log_every 1 --device cpu --world 2
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from .. import device as _device
from .. import distributed, tree
from ..checkpoint import latest_step, restore, save
from ..configs import ARCH_NAMES, get_config
from ..core import consensus
from ..data import synthetic_lm_stream
from ..models import init_params, make_train_step
from ..optim import adamw, cosine_warmup


def build(cfg, *, dp_mode: str, lr: float, steps: int, group, world: int):
    """(optimizer, train step): the reference's AdamW on a cosine schedule,
    and the gossip schedule for ``world`` replicas."""
    opt = adamw(cosine_warmup(lr, min(100, steps // 10 + 1), steps))
    sched = None
    if dp_mode == "sop_gossip":
        name = "hypercube" if (world & (world - 1)) == 0 and world > 1 else "ring"
        sched = consensus.schedule(name, world) if world > 1 else [[0]]
    step = make_train_step(cfg, opt, group=group, dp_mode=dp_mode, gossip_schedule=sched)
    return opt, step


def _stacked(xs: list[torch.Tensor], ctx) -> list[torch.Tensor]:
    """Every rank's ``xs``, stacked on a leading replica axis (rank order)."""
    out = []
    for x in xs:
        y = x.to(ctx.device)
        full = y.new_empty((ctx.world,) + tuple(y.shape))
        out.append(distributed.all_gather_into(full, y[None], ctx.group).to(x.device))
    return out


def _save(directory: str, step: int, params, opt_state: dict, ctx) -> None:
    p = _stacked(tree.leaves(params), ctx)
    o = tree.rebuild(opt_state, _stacked(tree.leaves(opt_state), ctx))
    if ctx.rank == 0:
        save(directory, step, (p, o))
    dist.barrier(ctx.group)


def _restore(directory: str, step: int, params, opt_state: dict, ctx):
    def like(x):
        return x[None].expand((ctx.world,) + tuple(x.shape))

    p, o = restore(directory, step, ([like(x) for x in tree.leaves(params)],
                                     tree.tree_map(like, opt_state)))
    params = tree.rebuild(params, [x[ctx.rank] for x in p])
    return params, tree.tree_map(lambda x: x[ctx.rank].clone(), o)


def run(ctx: distributed.RankContext, args: argparse.Namespace) -> dict:
    """One rank's training loop; returns the last logged (group-mean) metrics."""
    cfg = _config(args)
    lead = ctx.rank == 0
    opt, step = build(cfg, dp_mode=args.dp_mode, lr=args.lr, steps=args.steps,
                      group=ctx.group, world=ctx.world)
    if lead:
        print(f"arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M devices={ctx.world} "
              f"dp={args.dp_mode}", flush=True)
    params = init_params(cfg, args.seed, device=ctx.device)
    opt_state = opt.init(params)
    start = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            params, opt_state = _restore(args.ckpt_dir, last, params, opt_state, ctx)
            start = last
            if lead:
                print(f"restored step {last}", flush=True)
    stream = synthetic_lm_stream(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    if lead:
        print(f"achievable CE floor (bigram entropy): {stream.bigram_entropy():.3f} nats",
              flush=True)
    rows = args.batch // ctx.world
    lo = ctx.rank * rows
    logged: dict = {}
    t0 = time.time()
    for i in range(start, args.steps):
        b = stream.batch_at(i)
        batch = {k: torch.as_tensor(v[lo:lo + rows], device=ctx.device) for k, v in b.items()}
        params, opt_state, metrics = step(params, opt_state, batch, i)
        metrics = consensus.allreduce_average(metrics, ctx.group)
        if (i + 1) % args.log_every == 0 or i == start:
            logged = {k: float(v) for k, v in metrics.items()}
            extra = (f" consensus_sq={logged['consensus_sq']:.3e}"
                     if "consensus_sq" in logged else "")
            if lead:
                print(f"step {i + 1:5d}  loss={logged['loss']:.4f} ce={logged['ce']:.4f}"
                      f"{extra}  ({(time.time() - t0) / (i - start + 1):.2f}s/step)", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            _save(args.ckpt_dir, i + 1, params, opt_state, ctx)
    if lead:
        print("done", flush=True)
    return logged


def tokens_only(cfg):
    """``cfg``, or a ValueError for an encoder-decoder: the launcher feeds
    tokens only, as the reference's does, and has no frames to feed."""
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is an encoder-decoder: the launcher feeds tokens only "
                         "and has no frames for its encoder, as the reference's has none; "
                         "train it through models.make_train_step with batch['frames']")
    return cfg


def _config(args: argparse.Namespace):
    return tokens_only(get_config(args.arch, variant=None if args.variant == "full" else "smoke"))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_NAMES)
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--dp_mode", default="allreduce", choices=["allreduce", "sop_gossip"])
    ap.add_argument("--ckpt_dir", default="")
    ap.add_argument("--ckpt_every", type=int, default=50)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks to spawn on this host (default: the number of cards)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = parser().parse_args(argv)
    _config(args)  # an arch the launcher cannot feed raises before any process starts
    dev = _device.resolve(args.device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # started by torchrun
        ctx = distributed.init_group(device=args.device)
        world = ctx.world
    else:
        ctx = None
        world = args.world
        if world is None:
            if dev.type != "cuda":
                raise ValueError("--world must be given on the CPU")
            world = torch.cuda.device_count()
    if world < 1 or args.batch % world:
        raise ValueError(f"global batch {args.batch} must divide over {world} ranks")
    if ctx is None and world > 1:
        return distributed.spawn(run, world, args, device=args.device)[0]
    if ctx is None:
        ctx = distributed.init_group(0, 1, device=args.device)
    out = run(ctx, args)
    dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
