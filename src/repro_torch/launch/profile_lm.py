"""Where the LM serving path's time goes on the card: one prefill and 8
decode steps of ``--arch`` (default ``mamba2-370m``) at full width
(chip_smoke's main-lm and main-dense geometry: B=4, a 512-token prompt,
seed 0) under ``torch.profiler``.

The family's stub inputs are fed as the launcher feeds them
(``serve.lm_extras``: a VLM's patch prefix, an encoder-decoder's frames,
decoding from BOS at position 0).  For each window it prints the wall
time, the device time summed over every kernel, the device's idle share
(1 - device / wall; the profiler's own host cost inflates it) and the
kernels that took the most device time, then one JSON line with the same
numbers.

  PYTHONPATH=src python -m repro_torch.launch.profile_lm --engine cuda
  PYTHONPATH=src python -m repro_torch.launch.profile_lm --arch smollm-135m
  PYTHONPATH=src python -m repro_torch.launch.profile_lm \
      --arch jamba-1.5-large-398b --layers 4

``--layers N`` cuts the depth to N layers (full width), for a config
whose full depth does not fit the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .. import device as _device
from ..configs import ARCH_NAMES, get_config
from ..models import decode_start, decode_step, init_cache, init_params, prefill
from .serve import lm_cache_len, lm_extras

BATCH, PROMPT_LEN, DECODE_STEPS, SEED, TOP = 4, 512, 8, 0, 8


def _window(fn, dev: torch.device) -> dict:
    """Profile one call of ``fn``: wall ms, device ms, idle share, top kernels.
    On the CPU (a rehearsal) there is no device: device ms and the idle
    share are None and no kernel is listed."""
    cuda = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(dev)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in kernels:
        slot = by_name.setdefault(e.name, [0.0, 0])
        slot[0] += e.device_time_total / 1e3  # us -> ms
        slot[1] += 1
    device_ms = sum(v[0] for v in by_name.values()) if cuda else None
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return dict(
        wall_ms=wall_ms, device_ms=device_ms, launches=len(kernels),
        idle_share=1.0 - device_ms / wall_ms if device_ms else None,
        top=[dict(name=name[:80], ms=ms, calls=n) for name, (ms, n) in ranked],
    )


@torch.inference_mode()
def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-370m", choices=ARCH_NAMES)
    ap.add_argument("--engine", default="cuda", choices=["cuda", "plan"],
                    help="cuda: the ssd_intra kernel; plan: the plain ssd_chunked "
                         "(the same code for a dense decoder)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the config's)")
    args = ap.parse_args(argv)
    dev = _device.resolve("cuda")
    cfg = dataclasses.replace(get_config(args.arch), ssd_fused=args.engine == "cuda")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = init_params(cfg, SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), generator=gen, device=dev)
    extras = lm_extras(cfg, BATCH, gen, dev)
    start = decode_start(cfg, PROMPT_LEN, extras)

    def run_prefill():
        cache = init_cache(cfg, BATCH, lm_cache_len(cfg, PROMPT_LEN, DECODE_STEPS), device=dev)
        return prefill(cfg, params, {"tokens": prompt, **extras}, cache)

    def run_decode(logits, cache):
        tok = (torch.zeros((BATCH, 1), dtype=torch.long, device=dev) if logits is None
               else torch.argmax(logits[:, -1:], dim=-1))
        for i in range(DECODE_STEPS):
            logits, cache = decode_step(cfg, params, tok, cache, start + i)
            tok = torch.argmax(logits[:, -1:], dim=-1)

    logits, cache = run_prefill()  # warm-up
    run_decode(logits, cache)
    out = {"device": torch.cuda.get_device_name(dev), "arch": cfg.name, "layers": cfg.n_layers,
           "dtype": cfg.dtype,
           "engine": args.engine, "batch": BATCH, "prompt_len": PROMPT_LEN,
           "decode_steps": DECODE_STEPS}
    out["prefill"] = _window(run_prefill, dev)
    out["decode"] = _window(lambda: run_decode(logits, cache), dev)
    for key in ("prefill", "decode"):
        w = out[key]
        idle = "not measured" if w["idle_share"] is None else f"{w['idle_share']:.3f}"
        print(f"{key}: wall {w['wall_ms']:.3f} ms, device {w['device_ms']:.3f} ms in "
              f"{w['launches']} kernels, idle share {idle}")
        for k in w["top"]:
            print(f"  {k['ms']:9.3f} ms  {k['calls']:5d}x  {k['name']}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
