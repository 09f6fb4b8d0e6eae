"""``cfg.remat`` under the spec-placed train step (``sharding.steps.build_train``)
on 2 gloo ranks, a 2 x 1 grid (the batch split over ``data``), against the
same step without remat.

With the batch split, ``moe_apply(reduce=)`` all-reduces the router metrics
inside the forward (``steps._mean_over``), so a rematerialised block runs
that collective again in the backward; every rank recomputes its blocks in
the same order, so they pair up.  One ``distributed.spawn`` of 2 ranks,
bounded by ``SPAWN_TIMEOUT_S`` (a hang fails the fixture instead of
stalling the suite), runs the jamba-1.5-large-398b smoke variant (Mamba2,
attention and MoE layers; dispatch groups of 64 tokens, as in
test_torch_sharding_step.py) for two AdamW steps with remat off, "full"
and "dots": the losses, every shard and both moments are bitwise the
step's without remat.  Then ``spawn``'s time limit itself: ranks that never
finish are killed and ``TimeoutError`` raised.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import distributed
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.sharding import param_pspecs, steps

torch.set_num_threads(1)

W = 2
ARCH = "jamba-1.5-large-398b"
POLICIES = ["full", "dots"]
STEPS = 2
BATCH, SEQ = 4, 32
MOE_GROUP = 64  # 64 tokens per data rank: no dispatch group straddles two ranks
SPAWN_TIMEOUT_S = 300


def _cfg(remat: bool, policy: str = "full"):
    return dataclasses.replace(get_config(ARCH, variant="smoke"), moe_group_size=MOE_GROUP,
                               remat=remat, remat_policy=policy)


def _batch(cfg, i):
    rng = np.random.default_rng(200 + i)
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, SEQ))),
            "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, SEQ))),
            "mask": torch.as_tensor((rng.uniform(size=(BATCH, SEQ)) > 0.2).astype(np.float32))}


def _ranks(ctx):
    torch.set_num_threads(1)  # the CPU's multithreaded embedding backward is not deterministic
    grid = steps.make_grid(ctx, W, 1)
    out = {}
    for name, cfg in (("off", _cfg(False)), *((p, _cfg(True, p)) for p in POLICIES)):
        opt = adamw(cosine_warmup(3e-4, 1, 10))
        params = init_params(cfg, 0, device="cpu")
        shards, state = steps.place(params, opt.init(params), param_pspecs(cfg, params, grid),
                                    grid)
        step = steps.build_train(cfg, grid, opt)
        losses = []
        for i in range(STEPS):
            shards, state, m = step(shards, state, _batch(cfg, i))
            losses.append(m["loss"])
        out[name] = {"losses": losses, "aux_loss": m["aux_loss"], "shards": shards,
                     "mu": state["mu"], "nu": state["nu"]}
    return out


@pytest.fixture(scope="module")
def ranks():
    return distributed.spawn(_ranks, W, device="cpu", timeout=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("policy", POLICIES)
def test_loss_is_bitwise_the_step_without_remat(ranks, policy):
    for r in ranks:
        got, want = r[policy], r["off"]
        assert len(got["losses"]) == STEPS
        for a, b in zip(got["losses"], want["losses"]):
            assert torch.equal(a, b)
        assert torch.equal(got["aux_loss"], want["aux_loss"])
    # the metrics are the global batch's: the same on both ranks
    assert all(torch.equal(a, b) for a, b in zip(ranks[0][policy]["losses"],
                                                 ranks[1][policy]["losses"]))


@pytest.mark.parametrize("policy", POLICIES)
def test_shards_and_moments_are_bitwise_the_step_without_remat(ranks, policy):
    for r in ranks:
        got, want = r[policy], r["off"]
        assert list(got["shards"]) == list(want["shards"])
        for i, name in enumerate(want["shards"]):
            assert torch.equal(got["shards"][name], want["shards"][name]), name
            assert torch.equal(got["mu"][i], want["mu"][i]), name
            assert torch.equal(got["nu"][i], want["nu"][i]), name
        # the step moved the parameters
        assert any(float(m.abs().max()) > 0 for m in got["mu"])


def _hang(ctx):
    if ctx.rank == 0:
        time.sleep(600)
    return ctx.rank


def test_spawn_time_limit_kills_ranks_that_never_finish():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="killed"):
        distributed.spawn(_hang, W, device="cpu", timeout=5)
    assert time.monotonic() - t0 < 60
