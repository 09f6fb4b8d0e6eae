"""Where the train step's time goes on the card: ``--arch`` (default
``mamba2-370m``) at full width (chip_smoke's main-train and main-dense
geometry: batch 8 x 128, AdamW on the launcher's cosine schedule, seed 0)
over an NCCL group of one, under ``torch.profiler``.  After two warm-up
steps, one step is profiled in its three parts: the forward and backward
(``loss_fn`` + ``autograd.grad``), the optimizer (``update`` +
``apply_updates``), and the gossip (``gossip_round`` +
``consensus_sq_distance``).  For each window it prints
the wall time, the device time summed over every kernel, the idle share
and the kernels that took the most device time (``profile_lm._window``),
then one JSON line with the same numbers.
  python -m repro_torch.launch.profile_train [--arch smollm-135m]
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from .. import distributed, tree
from ..configs import ARCH_NAMES, get_config
from ..core import consensus
from ..data import synthetic_lm_stream
from ..models import init_params, loss_fn
from ..optim import apply_updates
from .profile_lm import _window
from .train import build, tokens_only

BATCH, SEQ, LR, STEPS, SEED = 8, 128, 3e-4, 21, 0


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-370m", choices=ARCH_NAMES)
    args = ap.parse_args(argv)
    cfg = tokens_only(get_config(args.arch))  # the launcher's batches: no frames
    ctx = distributed.init_group(0, 1, device="cuda")
    opt, step = build(cfg, dp_mode="sop_gossip", lr=LR, steps=STEPS, group=ctx.group,
                      world=1)
    params = init_params(cfg, SEED, device=ctx.device)
    state = opt.init(params)
    stream = synthetic_lm_stream(cfg.vocab_size, SEQ, BATCH, seed=SEED)
    batch = {k: torch.as_tensor(v, device=ctx.device) for k, v in stream.batch_at(0).items()}
    for i in range(2):  # warm-up
        params, state, _ = step(params, state, batch, i)
    leaves = tree.leaves(params)
    held = {}

    def forward_backward():
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss, _ = loss_fn(cfg, params, batch)
            held["grads"] = list(torch.autograd.grad(loss, leaves))
            for p in leaves:
                p.requires_grad_(False)

    def optimizer():
        with torch.no_grad():
            updates, held["state"] = opt.update(held["grads"], state, params)
            apply_updates(params, updates)

    def gossip():
        consensus.gossip_round(params, ctx.group, [[0]], 2)
        consensus.consensus_sq_distance(params, ctx.group)

    out = {"device": torch.cuda.get_device_name(ctx.device), "arch": cfg.name,
           "dtype": cfg.dtype, "batch": BATCH, "seq": SEQ, "world": ctx.world}
    for key, fn in (("forward_backward", forward_backward), ("optimizer", optimizer),
                    ("gossip", gossip)):
        out[key] = _window(fn, ctx.device)
        w = out[key]
        idle = "not measured" if w["idle_share"] is None else f"{w['idle_share']:.3f}"
        print(f"{key}: wall {w['wall_ms']:.3f} ms, device {w['device_ms']:.3f} ms in "
              f"{w['launches']} kernels, idle share {idle}")
        for k in w["top"]:
            print(f"  {k['ms']:9.3f} ms  {k['calls']:5d}x  {k['name']}")
    dist.destroy_process_group()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
