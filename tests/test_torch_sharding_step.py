"""The spec-placed FSDP/TP train step (``repro_torch.sharding.steps``) on 4
gloo ranks against the port's unsharded ``make_train_step(dp_mode="none")``
on the whole batch.

One ``distributed.spawn`` of 4 ranks for the file; inside it the grids
2 x 2, 1 x 4 and 4 x 1 take two AdamW steps (the reference's defaults:
clipping to a global norm of 1, weight decay 0.1) of the smoke variants of
nemotron-4-15b (dense, fsdp), qwen3-moe-30b-a3b (experts over ``model``,
fsdp), jamba-1.5-large-398b (SSM and MoE, fsdp) and whisper-tiny (the
encoder-decoder roots and ``dec_pos``), from the same parameters and on the
same global batches (a random mask with holes, so the ranks' counts
differ), in float32 and float64 (jamba in float32 only).  The unsharded step's parity with the
reference's own step is held by test_torch_dense_train.py,
test_torch_moe_train.py, test_torch_hybrid_train.py and
test_torch_encdec.py, so this file runs no JAX.

The MoE configs' dispatch groups are cut from 512 to 64 tokens, so that the
8 x 32 batch forms whole groups on every data rank (512-token groups need
2048 tokens, on which jamba's 16 smoke layers take a minute); the refusal
of groups that straddle two ranks runs at the smoke variant's 512.

Bounds: on the 1 x 4 grid (tensor parallelism alone) every rank holds the
whole batch and every whole gradient, and the loss, every parameter and
both moments are the unsharded step's, bitwise.  Where the batch is split
(2 x 2, 4 x 1), the loss, every parameter and both moments within 2e-5
absolute + 2e-5 relative, in float64 models too: ``cross_entropy`` sums in
float32 (as the reference's does), the AdamW moments are float32 (the
optimizer's contract), and Adam's update of a gradient near its eps of
1e-8 magnifies their rounding, so the ranks' partial sums keep float32's
differences in a float64 model.  Every shard and moment holds exactly its
slice: local numel = full numel / the size of the axes that split it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import distributed
from repro_torch.configs import get_config
from repro_torch.models import init_params, make_train_step
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.sharding import param_pspecs, steps

torch.set_num_threads(1)

W = 4
GRIDS = [(2, 2), (1, 4), (4, 1)]
ARCHS = ["nemotron-4-15b", "qwen3-moe-30b-a3b", "jamba-1.5-large-398b", "whisper-tiny"]
DTYPES = ["float32", "float64"]
# jamba's 16 smoke layers run in float32 only: in float64 they would double
# the file's time
RUNS = [(a, d) for a in ARCHS for d in DTYPES if (a, d) != ("jamba-1.5-large-398b", "float64")]
STEPS = 2
BATCH, SEQ = 8, 32
# MoE dispatch groups of 64 tokens: 64 per data rank at D = 4, so no group
# straddles two ranks (the smoke variants' 512 would need 2048 tokens)
MOE_GROUP = 64
TOL32 = (2e-5, 2e-5)  # absolute, relative


def _cfg(arch, dtype, group=MOE_GROUP):
    cfg = get_config(arch, variant="smoke")
    return dataclasses.replace(cfg, dtype=dtype,
                               moe_group_size=group if cfg.n_experts else cfg.moe_group_size)


def _batch(cfg, i):
    rng = np.random.default_rng(100 + i)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, SEQ))),
           "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, SEQ))),
           "mask": torch.as_tensor((rng.uniform(size=(BATCH, SEQ)) > 0.2).astype(np.float32))}
    if cfg.is_encoder_decoder:
        frames = rng.normal(size=(BATCH, cfg.encoder_seq, cfg.d_model))
        out["frames"] = torch.as_tensor(frames, dtype=getattr(torch, cfg.dtype))
    return out


def _optimizer():
    return adamw(cosine_warmup(3e-4, 1, 10))


def _unsharded(cfg, batches):
    opt = _optimizer()
    params = init_params(cfg, 0, device="cpu")
    state = opt.init(params)
    step = make_train_step(cfg, opt, dp_mode="none")
    losses = []
    for b in batches:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    return losses, dict(params.named_parameters()), state


def _ranks(ctx):
    torch.set_num_threads(1)  # the CPU's multithreaded embedding backward is not deterministic
    grids = {g: steps.make_grid(ctx, *g) for g in GRIDS}
    out = {}
    for arch, dtype in RUNS:
        cfg = _cfg(arch, dtype)
        batches = [_batch(cfg, i) for i in range(STEPS)]
        losses, ref, ref_state = _unsharded(cfg, batches)
        for shape, grid in grids.items():
            opt = _optimizer()
            params = init_params(cfg, 0, device="cpu")
            specs = param_pspecs(cfg, params, grid)
            shards, state = steps.place(params, opt.init(params), specs, grid)
            step = steps.build_train(cfg, grid, opt)
            got = []
            for b in batches:
                shards, state, m = step(shards, state, b)
                got.append(float(m["loss"]))
            rows = {}
            for i, (name, x) in enumerate(shards.items()):
                split = steps.split_dims(specs[name], grid)
                parts = int(np.prod([grid.shape[a] for _, a in split]))
                want = {"param": steps.local_slice(ref[name], specs[name], grid),
                        "mu": steps.local_slice(ref_state["mu"][i], specs[name], grid),
                        "nu": steps.local_slice(ref_state["nu"][i], specs[name], grid)}
                have = {"param": x, "mu": state["mu"][i], "nu": state["nu"][i]}
                diff = {k: (t.double() - want[k].double()).abs() for k, t in have.items()}
                rows[name] = {
                    "numel": [t.numel() * parts == ref[name].numel() for t in have.values()],
                    "shape": [tuple(t.shape) == tuple(want[k].shape) for k, t in have.items()],
                    "abs": {k: float(d.max()) for k, d in diff.items()},
                    "excess32": {k: float((d - TOL32[0] - TOL32[1] * want[k].double().abs())
                                          .max()) for k, d in diff.items()},
                }
            out[(arch, dtype, shape)] = {"losses": (got, losses), "leaves": rows,
                                         "step": int(state["step"])}
    grid = grids[(4, 1)]
    arch = "qwen3-moe-30b-a3b"
    cfg = _cfg(arch, "float32", group=get_config(arch, variant="smoke").moe_group_size)
    params = init_params(cfg, 0, device="cpu")
    opt = _optimizer()
    shards, state = steps.place(params, opt.init(params), param_pspecs(cfg, params, grid), grid)
    with pytest.raises(ValueError) as err:
        steps.build_train(cfg, grid, opt)(shards, state, _batch(cfg, 0))
    return {"runs": out, "refusal": str(err.value)}


@pytest.fixture(scope="module")
def ranks():
    return distributed.spawn(_ranks, W, device="cpu")


CASES = [(a, d, g) for a, d in RUNS for g in GRIDS]


@pytest.mark.parametrize("arch,dtype,shape", CASES,
                         ids=[f"{a}-{d}-{g[0]}x{g[1]}" for a, d, g in CASES])
def test_sharded_step_equals_unsharded(ranks, arch, dtype, shape):
    for rank, res in enumerate(ranks):
        run = res["runs"][(arch, dtype, shape)]
        got, want = run["losses"]
        assert run["step"] == STEPS
        if shape[0] == 1:  # tensor parallel alone: the unsharded step, bitwise
            assert got == want, (rank, got, want)
        for g, w in zip(got, want):
            assert abs(g - w) <= TOL32[0] + TOL32[1] * abs(w), (rank, got, want)
        for name, row in run["leaves"].items():
            assert all(row["numel"]) and all(row["shape"]), (rank, name)
            for k, excess in row["excess32"].items():
                assert excess <= 0.0, (rank, name, k, row["abs"][k])
                if shape[0] == 1:
                    assert row["abs"][k] == 0.0, (rank, name, k, row["abs"][k])


def test_every_rank_reports_the_same_global_loss(ranks):
    for key in ranks[0]["runs"]:
        losses = [res["runs"][key]["losses"][0] for res in ranks]
        assert all(x == losses[0] for x in losses), key


def test_moe_groups_straddling_ranks_are_refused(ranks):
    for res in ranks:
        msg = res["refusal"]
        assert "64 tokens" in msg and "groups of 256" in msg and "straddle" in msg, msg
