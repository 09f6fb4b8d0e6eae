"""Where the train step's time goes on the card: ``--arch`` (default
``mamba2-370m``) at full width (chip_smoke's main-train and main-dense
geometry by default: batch 8 x 128, AdamW on the launcher's cosine
schedule, seed 0) over an NCCL group of one, under ``torch.profiler``.
After two warm-up steps, one step is profiled in its three parts: the
forward and backward (``loss_fn`` + ``autograd.grad``), the optimizer
(``update`` + ``apply_updates``), and the gossip (``gossip_round`` +
``consensus_sq_distance``).  Where the config sets ``remat``, the forward
and backward is profiled a second time without it, and the recompute's
share of the rematerialised window's device time is printed (1 - without
/ with).  For each window it prints the wall time, the device time summed
over every kernel, the idle share and the kernels that took the most
device time (``profile_lm._window``), then one JSON line with the same
numbers.

  python -m repro_torch.launch.profile_train [--arch smollm-135m]
  python -m repro_torch.launch.profile_train --arch qwen1.5-32b --layers 1 \
      --batch 2 --seq 2048

``--layers N`` cuts the depth to N layers (full width), for a config whose
full depth does not fit the card; ``--batch``/``--seq`` set the batch.
``--device cpu --variant smoke`` rehearses the windows on the CPU (gloo; no
device time).
"""

from __future__ import annotations

import argparse
import dataclasses
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
    ap.add_argument("--variant", default="full", choices=["full", "smoke"])
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the config's)")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    cfg = tokens_only(get_config(args.arch, variant=None if args.variant == "full"
                                 else "smoke"))  # the launcher's batches: no frames
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    ctx = distributed.init_group(0, 1, device=args.device)
    opt, step = build(cfg, dp_mode="sop_gossip", lr=LR, steps=STEPS, group=ctx.group,
                      world=1)
    params = init_params(cfg, SEED, device=ctx.device)
    state = opt.init(params)
    stream = synthetic_lm_stream(cfg.vocab_size, args.seq, args.batch, seed=SEED)
    batch = {k: torch.as_tensor(v, device=ctx.device) for k, v in stream.batch_at(0).items()}
    for i in range(2):  # warm-up
        params, state, _ = step(params, state, batch, i)
    leaves = tree.leaves(params)
    held = {}

    def forward_backward(run_cfg):
        held.pop("grads", None)  # the last window's, freed before this one's backward
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss, _ = loss_fn(run_cfg, params, batch)
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

    out = {"device": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                      else str(ctx.device)),
           "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype, "batch": args.batch,
           "seq": args.seq, "world": ctx.world,
           "remat": cfg.remat_policy if cfg.remat else None}
    windows = [("forward_backward", lambda: forward_backward(cfg))]
    if cfg.remat:
        plain = dataclasses.replace(cfg, remat=False)
        windows.append(("forward_backward_no_remat", lambda: forward_backward(plain)))
    windows += [("optimizer", optimizer), ("gossip", gossip)]
    for key, fn in windows:
        out[key] = _window(fn, ctx.device)
        w = out[key]
        idle = "not measured" if w["idle_share"] is None else f"{w['idle_share']:.3f}"
        dev_ms = "not measured" if w["device_ms"] is None else f"{w['device_ms']:.3f} ms"
        print(f"{key}: wall {w['wall_ms']:.3f} ms, device {dev_ms} in "
              f"{w['launches']} kernels, idle share {idle}")
        for k in w["top"]:
            print(f"  {k['ms']:9.3f} ms  {k['calls']:5d}x  {k['name']}")
    if cfg.remat:
        with_ms = out["forward_backward"]["device_ms"]
        without_ms = out["forward_backward_no_remat"]["device_ms"]
        out["recompute_share"] = None if not with_ms else 1.0 - without_ms / with_ms
        share = ("not measured" if out["recompute_share"] is None
                 else f"{out['recompute_share']:.4f}")
        print(f"remat {cfg.remat_policy}: the recompute's share of the forward and "
              f"backward's device time {share}")
    dist.destroy_process_group()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
