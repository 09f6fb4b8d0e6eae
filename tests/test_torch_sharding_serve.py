"""Sharded prefill and decode (``repro_torch.sharding.serve``) on 4 gloo ranks
against the port's unsharded ``models.prefill`` / ``decode_step`` on the
whole batch, and the split math against the unsplit functions in one
process.

One ``distributed.spawn`` of 4 ranks for the file.  Inside it the grids 2 x
2 (kv heads over ``model``), 1 x 4 (the cache length over ``model``: the
smoke variants' 2 kv heads do not divide 4) and 4 x 1 (rows only) prefill a
B = 8 x 16 prompt and take 4 teacher-forced decode steps of:
  * nemotron-4-15b (dense, fsdp) in float32 and float64;
  * qwen3-moe-30b-a3b (its 512-token dispatch groups straddle the data
    ranks in prefill and decode);
  * jamba-1.5-large-398b (SSM state and conv, attention, MoE; groups of 16
    tokens, so the prefill's align with the data ranks and the decode's do
    not), in float32 only and cut to one period of its pattern (8 layers:
    m+MLP, m+MoE and a+MoE, every kind of its 16-layer smoke variant), for
    time, as test_torch_sharding_step.py runs it in float32 only;
  * whisper-tiny (self rings, and cross K/V of its 32 frames split by
    length on 1 x 4);
  * qwen2-vl-2b (the patch prefix and M-RoPE);
  * smollm-135m with ``sliding_window=16`` (what ``reduced()`` gives the
    ``long`` variant), a 30-token prompt past the window and decode steps
    at positions 30-33, slots 14, 15, 0, 1: the owner of the written slot
    wraps from the last model rank to the first;
and two edge cases: nemotron with a cache of 22 slots (4 divides neither
the length nor the 2 kv heads, so every model rank holds the whole leaf on
1 x 4) and with B = 2 (on 4 x 1 the rows stay whole).

Bounds: the logits of the rank's rows, and every cache part against its
slice of the unsharded cache after the prefill and after the last step,
within 2e-5 absolute + 2e-5 relative in float32 and 1e-10 in float64
(``pos`` exactly).  Every part has exactly its slice's numel: the whole
leaf's over the sizes of the axes that split it.  The ranks of a model
group return the same logits, bitwise.  During the decode steps every
tensor handed to a collective is recorded: none has the shape of a k, v,
state, conv or cross K/V part, and every int32 one is a ``pos`` part (the
one leaf gathered whole).  The unsharded path's parity with the reference
is held by test_torch_dense_lm.py, test_torch_moe_lm.py,
test_torch_hybrid_lm.py, test_torch_vlm.py and test_torch_encdec.py; the
sharded path's directly by test_torch_sharding_serve_ref.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import distributed, models
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.sharding import batch_pspecs, cache_pspecs, param_pspecs, serve, steps

torch.set_num_threads(1)

W = 4
GRIDS = [(2, 2), (1, 4), (4, 1)]
STEPS = 4
TOL = {"float32": (2e-5, 2e-5), "float64": (1e-10, 1e-10)}  # absolute, relative


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    dtype: str = "float32"
    batch: int = 8
    prompt: int = 16
    max_seq: int = 24  # divisible by 4: the 1 x 4 grid splits the length
    over: tuple = ()  # config overrides


CASES = {
    "nemotron-f32": Case("nemotron-4-15b"),
    "nemotron-f64": Case("nemotron-4-15b", "float64"),
    "qwen3-moe": Case("qwen3-moe-30b-a3b"),
    "jamba": Case("jamba-1.5-large-398b", over=(("moe_group_size", 16), ("n_layers", 8))),
    "whisper": Case("whisper-tiny"),
    "qwen2-vl": Case("qwen2-vl-2b", max_seq=40),  # 16 patches + 16 tokens + 4, and spare
    "smollm-window": Case("smollm-135m", prompt=30, max_seq=40,
                          over=(("sliding_window", 16),)),
    "indivisible-length": Case("nemotron-4-15b", max_seq=22),
    "two-rows": Case("nemotron-4-15b", batch=2),
}


def _cfg(case: Case):
    return dataclasses.replace(get_config(case.arch, variant="smoke"), dtype=case.dtype,
                               **dict(case.over))


def _inputs(cfg, case: Case):
    rng = np.random.default_rng(7)
    dt = getattr(torch, cfg.dtype)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (case.batch, case.prompt + STEPS)))
    extra = {}
    if cfg.is_encoder_decoder:
        extra["frames"] = torch.as_tensor(
            rng.normal(size=(case.batch, cfg.encoder_seq, cfg.d_model)), dtype=dt)
    if cfg.n_patches:
        extra["patch_embeds"] = torch.as_tensor(
            rng.normal(size=(case.batch, cfg.n_patches, cfg.d_model)), dtype=dt)
    return toks, extra


def _clone(cache):
    if isinstance(cache, dict):
        return {k: _clone(v) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_clone(v) for v in cache]
    return cache.clone()


def _leaves(cache, spec, path=""):
    """(path, leaf, spec) over a cache structure."""
    if isinstance(cache, dict):
        for k, v in cache.items():
            yield from _leaves(v, spec[k], path + k)
    elif isinstance(cache, list):
        for i, (v, s) in enumerate(zip(cache, spec)):
            yield from _leaves(v, s, f"{path}{i}.")
    else:
        yield path, cache, spec


def _teacher_forced(cfg, case, toks, extra, prefill, decode, cache):
    """The prefill's logits and each decode step's, with the cache after the
    prefill (a copy) and after the last step."""
    logits, cache = prefill({"tokens": toks[:, :case.prompt], **extra}, cache)
    out, caches = [logits], [_clone(cache)]
    start = models.decode_start(cfg, case.prompt, extra)
    for t in range(STEPS):
        logits, cache = decode(toks[:, case.prompt + t:case.prompt + t + 1], cache, start + t)
        out.append(logits)
    return out, caches + [cache]


def _excess(got, want, dtype):
    """(max |got - want|, its largest excess over the dtype's bound)."""
    atol, rtol = TOL[dtype]
    d = (got.double() - want.double()).abs()
    return float(d.max()), float((d - atol - rtol * want.double().abs()).max())


class _Recorder:
    """Wraps the serving module's collectives; while ``on``, records the
    shape and dtype of every tensor handed to one."""

    def __init__(self):
        self.on, self.seen = False, []
        self.saved = serve._gather, serve.group_comm
        serve._gather, serve.group_comm = self.gather, self.comm

    def close(self):
        serve._gather, serve.group_comm = self.saved

    def record(self, kind, t):
        if self.on:
            self.seen.append((kind, tuple(t.shape), str(t.dtype)))

    def gather(self, t, dim, axis, grid):
        self.record("gather " + axis, t)
        return self.saved[0](t, dim, axis, grid)

    def comm(self, grid):
        c = self.saved[1](grid)

        def reduce(t, op):
            self.record("reduce " + op, t)
            return c.reduce(t, op)

        return serve.Comm(reduce, c.gather)


def _rows(cfg, grid, batch: int) -> torch.Tensor:
    """The global indices of the rank's rows."""
    return steps.local_slice(torch.arange(batch), batch_pspecs(cfg, {"t": (batch,)}, grid)["t"],
                             grid)


def _sharded(cfg, grid, case, params, toks, extra, rec=None):
    """``_teacher_forced`` through the serving module on ``grid``, from the
    full ``params`` (a module or ``{name: tensor}``); ``rec`` records the
    decode steps' collectives."""
    shards, _ = steps.place(params, {}, param_pspecs(cfg, params, grid), grid)
    pre = serve.build_prefill(cfg, grid, case.batch, case.max_seq)
    dec = serve.build_decode(cfg, grid, case.batch, case.max_seq, prefill=pre)

    def decode(tok, cache, position):
        if rec is not None:
            rec.on = True
        out = dec(shards, tok, cache, position)
        if rec is not None:
            rec.on = False
        return out

    return _teacher_forced(cfg, case, toks, extra, lambda b, c: pre(shards, b, c), decode,
                           serve.init_cache(cfg, grid, case.batch, case.max_seq))


def sharded_logits(ctx, cfg, state: dict, toks, prompt: int, max_seq: int, grids) -> dict:
    """``{grid shape: (the rank's rows, the logits of the prefill and of each
    teacher-forced decode step)}`` of the model whose parameters are
    ``state`` (``{name: tensor}``) on each grid.  A rank function whose
    module imports no JAX, for test_torch_sharding_serve_ref.py."""
    torch.set_num_threads(1)
    case = Case(cfg.name, batch=toks.shape[0], prompt=prompt, max_seq=max_seq)
    out = {}
    for shape in grids:
        grid = steps.make_grid(ctx, *shape)
        got, _ = _sharded(cfg, grid, case, state, toks, {})
        out[shape] = (_rows(cfg, grid, case.batch), got)
    return out


def _run(grid, cfg, case, params, want, want_caches):
    toks, extra = _inputs(cfg, case)
    rec = _Recorder()
    got, caches = _sharded(cfg, grid, case, params, toks, extra, rec)
    rec.close()
    rows = _rows(cfg, grid, case.batch)
    out = {"logits": [], "cache": [], "got": got, "seen": rec.seen, "parts": {},
           "pos0": caches[-1][0].get("pos") if isinstance(caches[-1], list) else None}
    for g, w in zip(got, want):
        if w is None:
            out["logits"].append(None if g is None else "logits where None was due")
        else:
            out["logits"].append({"shape": tuple(g.shape) == (len(rows),) + tuple(w.shape[1:]),
                                  "err": _excess(g, w[rows], cfg.dtype)})
    whole = models.init_cache(cfg, case.batch, case.max_seq, device="meta")
    specs = cache_pspecs(cfg, whole, grid)
    for phase, (mine, full) in enumerate(zip(caches, want_caches)):
        for (path, part, spec), (_, leaf, _) in zip(_leaves(mine, specs),
                                                    _leaves(full, specs)):
            n = int(np.prod([grid.shape[a] for _, a in steps.split_dims(spec, grid)]))
            want_part = steps.local_slice(leaf, spec, grid)
            row = {"numel": part.numel() * n == leaf.numel(),
                   "shape": tuple(part.shape) == tuple(want_part.shape),
                   "whole": tuple(part.shape) == tuple(leaf.shape)}
            if row["shape"] and part.dtype == torch.int32:
                row["err"] = (0.0, -1.0) if torch.equal(part, want_part) else (1.0, 1.0)
            elif row["shape"]:
                row["err"] = _excess(part, want_part, cfg.dtype)
            out["cache"].append((phase, path, row))
            out["parts"][path] = (tuple(part.shape), str(part.dtype))
    return out


def _refusals(grid):
    """The step's errors for a shard and a cache part of the wrong shape."""
    cfg = _cfg(CASES["nemotron-f32"])
    params = models.init_params(cfg, 0, device="cpu")
    shards, _ = steps.place(params, {}, param_pspecs(cfg, params, grid), grid)
    cache = serve.init_cache(cfg, grid, 8, 24)
    pre = serve.build_prefill(cfg, grid, 8, 24)
    batch = {"tokens": torch.zeros((8, 4), dtype=torch.long)}
    out = {}
    bad = dict(shards)
    bad["layers.0.attn.wq.w"] = bad["layers.0.attn.wq.w"][:, :-1]
    with pytest.raises(ValueError) as err:
        pre(bad, batch, cache)
    out["shard"] = str(err.value)
    cache[1]["k"] = cache[1]["k"][:, :-1]
    with pytest.raises(ValueError) as err:
        pre(shards, batch, cache)
    out["cache"] = str(err.value)
    with pytest.raises(ValueError) as err:
        serve.build_decode(cfg, grid, 8, 32, prefill=pre)
    out["prefill"] = str(err.value)
    return out


def _ranks(ctx):
    torch.set_num_threads(1)
    grids = {g: steps.make_grid(ctx, *g) for g in GRIDS}
    runs = {}
    for name, case in CASES.items():
        cfg = _cfg(case)
        toks, extra = _inputs(cfg, case)
        params = models.init_params(cfg, 0, device="cpu")
        want, want_caches = _teacher_forced(
            cfg, case, toks, extra, lambda b, c: models.prefill(cfg, params, b, c),
            lambda t, c, p: models.decode_step(cfg, params, t, c, p),
            models.init_cache(cfg, case.batch, case.max_seq, device="cpu"))
        greedy = None
        if name in GREEDY:
            greedy, _ = models.greedy_decode(cfg, params, toks[:, :case.prompt], STEPS,
                                             case.max_seq, batch_extra=extra)
        for shape, grid in grids.items():
            runs[(name, shape)] = _run(grid, cfg, case, params, want, want_caches)
            if greedy is not None:
                shards, _ = steps.place(params, {}, param_pspecs(cfg, params, grid), grid)
                got, _ = serve.greedy_decode(cfg, grid, shards, toks[:, :case.prompt], STEPS,
                                             case.max_seq, batch_extra=extra)
                runs[(name, shape)]["greedy"] = (got, greedy)
    return {"runs": runs, "refusals": _refusals(grids[(2, 2)])}


@pytest.fixture(scope="module")
def ranks():
    return distributed.spawn(_ranks, W, device="cpu")


RUNS = [(c, g) for c in CASES for g in GRIDS]
IDS = [f"{c}-{g[0]}x{g[1]}" for c, g in RUNS]


@pytest.mark.parametrize("case,shape", RUNS, ids=IDS)
def test_logits_of_the_ranks_rows_equal_unsharded(ranks, case, shape):
    for rank, res in enumerate(ranks):
        for step, row in enumerate(res["runs"][(case, shape)]["logits"]):
            if CASES[case].arch == "whisper-tiny" and step == 0:
                assert row is None, (rank, row)  # the encoder-decoder's prefill
                continue
            assert row["shape"], (rank, step)
            assert row["err"][1] <= 0.0, (rank, step, row["err"])


@pytest.mark.parametrize("case,shape", RUNS, ids=IDS)
def test_cache_parts_are_the_unsharded_cache_sliced(ranks, case, shape):
    """Each part has its slice's numel and values, after the prefill and
    after the last step; over the ranks the parts cover the whole cache."""
    for rank, res in enumerate(ranks):
        rows = res["runs"][(case, shape)]["cache"]
        assert rows
        for phase, path, row in rows:
            assert row["numel"] and row["shape"], (rank, phase, path, row)
            assert row["err"][1] <= 0.0, (rank, phase, path, row["err"])


@pytest.mark.parametrize("case,shape", RUNS, ids=IDS)
def test_decode_gathers_no_cache_leaf_but_pos(ranks, case, shape):
    for rank, res in enumerate(ranks):
        run = res["runs"][(case, shape)]
        parts = run["parts"]
        big = {v for p, v in parts.items() if not p.endswith("pos")}
        pos = {v for p, v in parts.items() if p.endswith("pos")}
        for kind, shp, dtype in run["seen"]:
            assert (shp, dtype) not in big, (rank, kind, shp, dtype)
            if dtype == "torch.int32":
                assert (shp, dtype) in pos, (rank, kind, shp)
        kinds = {k for k, _, _ in run["seen"]}
        if shape == (1, 4) and CASES[case].max_seq % 4 == 0:
            assert {"reduce max", "reduce sum"} <= kinds, kinds  # the length split
        if shape[1] == 1:
            assert not any(k.startswith("reduce") for k in kinds), kinds


@pytest.mark.parametrize("case,shape", RUNS, ids=IDS)
def test_model_group_ranks_agree_bitwise(ranks, case, shape):
    model = shape[1]
    for rank, res in enumerate(ranks):
        first = ranks[rank - rank % model]["runs"][(case, shape)]["got"]
        for a, b in zip(res["runs"][(case, shape)]["got"], first):
            assert (a is None and b is None) or torch.equal(a, b), (rank, case, shape)


GREEDY = ["nemotron-f32", "whisper", "qwen2-vl"]
GREEDY_RUNS = [(c, g) for c in GREEDY for g in GRIDS]


@pytest.mark.parametrize("case,shape", GREEDY_RUNS,
                         ids=[f"{c}-{g[0]}x{g[1]}" for c, g in GREEDY_RUNS])
def test_greedy_decode_gives_the_unsharded_tokens(ranks, case, shape):
    """Every rank returns the whole batch's tokens, those of
    ``models.greedy_decode`` (whisper from BOS, the VLM behind its patch
    prefix)."""
    for rank, res in enumerate(ranks):
        got, want = res["runs"][(case, shape)]["greedy"]
        assert got.shape == want.shape and torch.equal(got, want), (rank, got, want)


def test_indivisible_length_stays_whole_on_every_model_rank(ranks):
    for res in ranks:
        run = res["runs"][("indivisible-length", (1, 4))]
        for phase, path, row in run["cache"]:
            assert row["whole"], (phase, path)
        assert not any(k.startswith("reduce") or d == "torch.int32" for k, _, d in run["seen"])


def test_two_rows_stay_whole_on_4x1(ranks):
    for res in ranks:
        run = res["runs"][("two-rows", (4, 1))]
        assert all(row["shape"] for row in run["logits"])
        assert all(row["whole"] for _, _, row in run["cache"])
        assert run["got"][0].shape[0] == 2


def test_window_decode_wraps_the_slot_owner(ranks):
    """Decode positions 30-33 in a ring of 16 slots, 4 per rank on 1 x 4:
    slots 14, 15 on rank 3, then 0, 1 on rank 0; the other ranks' parts
    keep the prefill's slots."""
    want = {0: [32, 33, 18, 19], 3: [28, 29, 30, 31]}
    for rank, res in enumerate(ranks):
        run = res["runs"][("smollm-window", (1, 4))]
        assert run["parts"]["0.k"][0] == (8, 4, 2, 32)
        if rank in want:
            assert run["pos0"].tolist() == [want[rank]] * 8, (rank, run["pos0"])


def test_wrong_shapes_are_refused_naming_the_leaf(ranks):
    for res in ranks:
        assert "layers.0.attn.wq.w" in res["refusals"]["shard"]
        assert "cache 1.k" in res["refusals"]["cache"]
        assert "not a step of build_prefill" in res["refusals"]["prefill"]


# ---------------------------------------------------------------------------
# The split math in one process
# ---------------------------------------------------------------------------


def _attn_inputs(dtype, b=3, sq=1, h=4, kheads=2, hd=8, length=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, sq, h, hd), generator=g, dtype=torch.float64).to(dtype)
    k = torch.randn((b, length, kheads, hd), generator=g, dtype=torch.float64).to(dtype)
    v = torch.randn((b, length, kheads, hd), generator=g, dtype=torch.float64).to(dtype)
    valid = torch.rand((b, sq, length), generator=g) > 0.3
    valid[:, :, length // 2:length // 2 + length // 4] = False  # a masked quarter: part 2 of 4
    valid[1] = False  # a row masked everywhere
    return q, k, v, valid


CFG = get_config("nemotron-4-15b", variant="smoke")


def _length_split(q, k, v, valid, n, fault=False):
    ks, vs, ms = k.chunk(n, dim=1), v.chunk(n, dim=1), valid.chunk(n, dim=2)

    def fn(comm, kp, vp, mp):
        if fault:  # the combine without the rescale to the common max
            right = comm
            comm = serve.Comm(lambda t, op: t if op == "max" else right.reduce(t, op),
                              right.gather)
        return serve.length_split_sdpa(q, kp, vp, mp, CFG, comm)

    return serve.in_process(fn, list(zip(ks, vs, ms)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_length_split_sdpa_equals_sdpa(n, dtype):
    q, k, v, valid = _attn_inputs(getattr(torch, dtype))
    want = L._sdpa(q, k, v, valid, CFG)
    outs = _length_split(q, k, v, valid, n)
    for out in outs:
        assert out.shape == want.shape and out.dtype == want.dtype
        assert _excess(out, want, dtype)[1] <= 0.0, _excess(out, want, dtype)
        assert torch.equal(out, outs[0])
    # the row masked on every rank averages v over all the slots
    avg = v[1].mean(dim=0).repeat_interleave(2, dim=0).reshape(-1)
    assert _excess(outs[0][1, 0], avg, dtype)[1] <= 0.0


def test_a_combine_without_the_rescale_is_refused():
    q, k, v, valid = _attn_inputs(torch.float32, seed=3)
    want = L._sdpa(q, k, v, valid, CFG)
    good = _length_split(q, k, v, valid, 4)[0]
    bad = _length_split(q, k, v, valid, 4, fault=True)[0]
    assert _excess(good, want, "float32")[1] <= 0.0
    assert _excess(bad, want, "float32")[1] > 1e-3


@pytest.mark.parametrize("n", [1, 2])
def test_heads_split_sdpa_equals_sdpa(n):
    q, k, v, valid = _attn_inputs(torch.float32, h=8, kheads=4, seed=1)
    want = L._sdpa(q, k, v, valid, CFG)
    parts = list(zip(q.chunk(n, dim=2), k.chunk(n, dim=2), v.chunk(n, dim=2)))
    outs = serve.in_process(
        lambda comm, qp, kp, vp: serve.heads_split_sdpa(qp, kp, vp, valid, CFG, comm), parts)
    for out in outs:
        assert _excess(out, want, "float32")[1] <= 0.0


@pytest.mark.parametrize("split", ["heads", "channels", "both"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ssm_decode_on_a_split_cache_equals_ssm_decode(split, dtype):
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b", variant="smoke"), dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    p = S.ssm_init(gen, cfg)
    dt = getattr(torch, dtype)
    u = torch.randn((3, 1, cfg.d_model), generator=gen, dtype=torch.float64).to(dt)
    cache = S.init_ssm_cache(cfg, 3, dt, "cpu")
    cache["state"].normal_(generator=gen)
    cache["conv"].normal_(generator=gen)
    want_y, want = S.ssm_decode(p, cfg, u, {k: v.clone() for k, v in cache.items()})
    n, h, c = 4, cfg.ssm_heads, cache["conv"].shape[2]
    heads = [slice(r * h // n, (r + 1) * h // n) for r in range(n)] \
        if split != "channels" else [None] * n
    chans = [slice(r * c // n, (r + 1) * c // n) for r in range(n)] \
        if split != "heads" else [None] * n
    parts = [({"state": cache["state"][:, hs or slice(None)],
               "conv": cache["conv"][..., cs or slice(None)]}, hs, cs)
             for hs, cs in zip(heads, chans)]
    outs = serve.in_process(
        lambda comm, part, hs, cs: S.ssm_decode(p, cfg, u, part, comm=comm, heads=hs,
                                                channels=cs), parts)
    for y, _ in outs:
        assert _excess(y, want_y, dtype)[1] <= 0.0
    state = torch.cat([o["state"] for _, o in outs], 1) if split != "channels" \
        else outs[0][1]["state"]
    conv = torch.cat([o["conv"] for _, o in outs], 2) if split != "heads" \
        else outs[0][1]["conv"]
    assert _excess(state, want["state"], dtype)[1] <= 0.0
    assert _excess(conv, want["conv"], dtype)[1] <= 0.0
