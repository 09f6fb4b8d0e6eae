"""Sharded prefill and decode over a ``data`` x ``model`` grid of ranks: the
consumer of ``rules.cache_pspecs`` and the executed counterpart of the
reference's ``launch/dryrun.build_prefill`` / ``build_decode``, beside
``steps.build_train``.

    grid = steps.make_grid(ctx, data=D, model=M)
    shards, _ = steps.place(params, {}, rules.param_pspecs(cfg, params, grid), grid)
    cache = init_cache(cfg, grid, B, max_seq)          # this rank's part
    pre = build_prefill(cfg, grid, B, max_seq)
    dec = build_decode(cfg, grid, B, max_seq, prefill=pre)   # one set of scratch layers
    logits, cache = pre(shards, batch, cache)
    logits, cache = dec(shards, token, cache, position)
    tokens, cache = greedy_decode(cfg, grid, shards, prompt, n_steps, max_seq)

Every rank passes the same global batch and gets the logits of its ``data``
rows (``rules.batch_pspecs``): (B / D, 1, V), or None for the
encoder-decoder's prefill, as ``models.prefill`` gives; a decode step takes
the global token (B, 1) or the rank's rows of it.  The
builders take the global batch size and ``max_seq`` as the reference's take
its shape: what a cache part belongs to cannot be read off the part (a part
of 5 slots is a whole ring of 5 or a quarter of 20).

Parameters are gathered on use, a layer at a time: just before a layer
runs, each of its leaves is all-gathered over the axes its spec splits and
bound to a scratch layer of its kind (one ``AttnLayer`` or ``MixerLayer``
per distinct set of leaves, whisper's ``EncLayer`` and ``DecLayer``), which
the next layer of that kind takes over; the embedding, head and final norms
are gathered where they are used.  A rank so holds its shards, one gathered
layer per kind, its part of the cache and the activations (``reckon``).
The model's own stack functions (``transformer.decoder_prefill`` and
``decoder_decode_step``, ``encdec.encdec_prefill`` and
``encdec_decode_step``) run on a view of the shards that gathers each
module where it is read, with the split attention, SSM, cross K/V and MoE
parts passed in.

The cache lies where ``cache_pspecs`` puts it: rows over ``data``; a kv
cache's heads over ``model`` where they divide it, else its length, and
``pos`` always by length; the SSM state by heads and the conv tail by
channels; whisper's stacked cross K/V like a kv cache.  Prefill runs each
whole layer on the rank's rows and keeps the rank's part of what it writes
(the layer's whole K/V exist only while it runs).  Decode reads every cache
leaf where it lies; only ``pos`` (B x L int32) is gathered whole:

  * heads split: the rank writes its kv heads' new key and value, attends
    with the query heads that read them and gathers the heads' outputs over
    ``model`` before ``wo`` (``heads_split_sdpa``);
  * length split: the rank that owns slot ``position % L`` writes it, every
    rank forms its slots' logits as ``_sdpa`` does, and the softmax is
    completed over ``model`` (``length_split_sdpa``);
  * neither (``model`` = 1, or heads and length both indivisible): the rank
    holds the whole leaf and ``layers.attn_decode`` runs unchanged;
  * SSM: the rank convolves its conv channels and updates its state heads,
    gathering the conv outputs and the heads' y (``ssm.ssm_decode`` with
    the rank's ``heads`` and ``channels``).

The split math takes a ``Comm`` (``reduce(t, op)``, ``gather(t, dim)``):
``group_comm`` gives the collectives over the model group, ``in_process``
runs one function per part on threads whose ``Comm`` combines the parts in
rank order, so the math can be held to the unsplit functions in one process.

An MoE layer's dispatch groups are the global batch's only where no group
straddles two data ranks (the reckoning of ``steps._check_moe_groups``);
where one would, the layer's input is all-gathered over ``data``, the layer
runs on the global rows and the rank keeps its own.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import threading
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import models
from ..models import encdec as ED
from ..models import layers as L
from ..models import ssm as S
from ..models import transformer as T
from ..models.config import ModelConfig
from .rules import P, batch_pspecs, cache_pspecs, param_pspecs, param_shapes
from .steps import Grid, _gather, local_slice, split_dims


@dataclasses.dataclass(frozen=True)
class Comm:
    """Collectives over the model group: ``reduce(t, op)`` is the elementwise
    max (op "max") or sum ("sum") of every rank's ``t``, ``gather(t, dim)``
    the ranks' ``t`` concatenated along ``dim`` in rank order."""

    reduce: Callable[[torch.Tensor, str], torch.Tensor]
    gather: Callable[[torch.Tensor, int], torch.Tensor]


def group_comm(grid: Grid) -> Comm:
    """``Comm`` over ``grid``'s model group."""
    ops = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}

    def reduce(t, op):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=ops[op], group=grid.groups["model"])
        return out

    return Comm(reduce, lambda t, dim: _gather(t, dim, "model", grid))


_COMBINE = {"max": lambda ts: torch.stack(ts).amax(dim=0),
            "sum": lambda ts: functools.reduce(torch.add, ts)}


def in_process(fn, parts: list[tuple]) -> list:
    """``[fn(comm_r, *parts[r]) for each r]``, each call on its own thread,
    where ``comm_r`` combines what the threads hand it in rank order: a
    model group of ``len(parts)`` ranks in one process.  A thread that
    raises breaks the others' wait, and its error is raised."""
    n = len(parts)
    slots: list = [None] * n
    barrier = threading.Barrier(n)

    def comm(r):
        def combine(t, how):
            slots[r] = t
            barrier.wait()
            out = how(list(slots))
            barrier.wait()  # no thread writes its next value before all have read
            return out

        return Comm(lambda t, op: combine(t, _COMBINE[op]),
                    lambda t, dim: combine(t, lambda ts: torch.cat(ts, dim)))

    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        futures = [pool.submit(fn, comm(r), *parts[r]) for r in range(n)]
        for f in futures:
            f.add_done_callback(lambda f: f.exception() is not None and barrier.abort())
    errors = [f.exception() for f in futures]
    for e in errors:
        if e is not None and not isinstance(e, threading.BrokenBarrierError):
            raise e
    return [f.result() for f in futures]


# ---------------------------------------------------------------------------
# The split math
# ---------------------------------------------------------------------------


def length_split_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                      cfg: ModelConfig, comm: Comm) -> torch.Tensor:
    """``layers._sdpa`` over a cache whose slots are split over the model
    group: q (B, Sq, H, hd) every query head; k, v (B, L_r, K, hd) and
    ``valid`` (B, Sq, L_r) bool the rank's slots -> (B, Sq, H hd), the same
    on every rank.

    The rank's logits are ``_sdpa``'s (the activation-dtype q k^T widened,
    scaled by hd^-1/2, -1e30 where masked).  With m the all-reduced MAX of
    the row maxima and s the all-reduced SUM of exp(l - m), the rank's
    probabilities exp(l - m) / s are cast to v's dtype as ``_sdpa`` casts
    them, their partial P V is formed in the wide dtype, and the partials'
    SUM is cast to v's dtype.  A rank whose slots are all masked adds
    exp(-1e30 - m) = 0; a row masked on every rank averages v over all the
    slots, as ``_sdpa`` does."""
    b, sq, h, hd = q.shape
    kheads = k.shape[2]
    q = q.reshape(b, sq, kheads, h // kheads, hd)
    logits = torch.einsum("bqkrh,bskh->bkrqs", q, k).to(L.wide(q.dtype))
    logits = logits * (hd**-0.5)
    logits = torch.where(valid[:, None, None, :, :], logits, -1e30)
    m = comm.reduce(torch.amax(logits, dim=-1, keepdim=True), "max")
    e = torch.exp(logits - m)
    s = comm.reduce(torch.sum(e, dim=-1, keepdim=True), "sum")
    probs = (e / s).to(v.dtype).to(logits.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", probs, v.to(logits.dtype))
    return comm.reduce(out, "sum").to(v.dtype).reshape(b, sq, h * hd)


def heads_split_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                     cfg: ModelConfig, comm: Comm) -> torch.Tensor:
    """``layers._sdpa`` over a cache whose kv heads are split over the model
    group: q (B, Sq, H_r, hd) the query heads that read the rank's kv heads
    (query head h reads kv head h // (H / K)), k, v (B, L, K_r, hd), valid
    (B, Sq, L) -> (B, Sq, H hd), the heads' outputs gathered in head order."""
    return comm.gather(L._sdpa(q, k, v, valid, cfg), 2)


# ---------------------------------------------------------------------------
# The cache's parts
# ---------------------------------------------------------------------------


def _map(fn, node, spec, path: str = ""):
    """``fn(path, leaf, spec)`` over a cache structure and its specs."""
    if isinstance(node, dict):
        return {k: _map(fn, v, spec[k], f"{path}{k}") for k, v in node.items()}
    if isinstance(node, list):
        return [_map(fn, v, s, f"{path}{i}.")
                for i, (v, s) in enumerate(zip(node, spec, strict=True))]
    return fn(path, node, spec)


def _local_shape(shape, spec: P, grid: Grid) -> tuple[int, ...]:
    out = list(shape)
    for dim, axis in split_dims(spec, grid):
        out[dim] //= grid.shape[axis]
    return tuple(out)


def _split(spec: P, dim: int, grid: Grid) -> bool:
    """Whether ``spec`` splits ``dim`` over more than one model rank."""
    return (dim, "model") in split_dims(spec, grid)


def _kv_split(spec: P, grid: Grid) -> str | None:
    """How a per-layer (B, L, K, hd) kv leaf lies over ``model``."""
    if _split(spec, 2, grid):
        return "heads"
    return "length" if _split(spec, 1, grid) else None


def _whole_specs(cfg: ModelConfig, grid: Grid, batch_size: int, max_seq: int, dtype=None):
    whole = models.init_cache(cfg, batch_size, max_seq, dtype, device="meta")
    return whole, cache_pspecs(cfg, whole, grid)


def init_cache(cfg: ModelConfig, grid: Grid, batch_size: int, max_seq: int, dtype=None):
    """This rank's part of ``models.init_cache(cfg, batch_size, max_seq,
    dtype)`` under ``rules.cache_pspecs``, on the grid's device: each leaf
    allocated at its slice's size (no whole cache is made), zero, and -1 in
    the empty ``pos`` slots."""
    whole, specs = _whole_specs(cfg, grid, batch_size, max_seq, dtype)

    def part(path, x, spec):
        shape = _local_shape(x.shape, spec, grid)
        if path.endswith("pos"):
            return torch.full(shape, -1, dtype=x.dtype, device=grid.device)
        return torch.zeros(shape, dtype=x.dtype, device=grid.device)

    return _map(part, whole, specs)


# ---------------------------------------------------------------------------
# Parameters gathered on use
# ---------------------------------------------------------------------------


_STACKS = ("layers", "enc_layers", "dec_layers")


def _owner(name: str) -> str:
    """The module a leaf is gathered with: ``layers.3``, or a root name."""
    head, _, rest = name.partition(".")
    return f"{head}.{rest.split('.')[0]}" if head in _STACKS else head


class _Layers:
    """The rank's parameters gathered a module at a time: each of a layer's
    leaves all-gathered over the axes its spec splits and bound (``.data``)
    to the scratch module of the layer's kind (its stack and its leaves'
    names and shapes), replacing what the previous layer of that kind
    bound."""

    def __init__(self, cfg: ModelConfig, grid: Grid):
        self.grid = grid
        self.shapes = param_shapes(cfg)
        self.specs = param_pspecs(cfg, self.shapes, grid)
        self.split = {n: split_dims(s, grid) for n, s in self.specs.items()}
        self.local = {n: _local_shape(self.shapes[n], s, grid) for n, s in self.specs.items()}
        self.members: dict[str, list[str]] = {}
        for name in self.shapes:
            self.members.setdefault(_owner(name), []).append(name)
        self.kinds = {owner: (owner.split(".")[0],)
                      + tuple((n[len(owner) + 1:], self.shapes[n]) for n in names)
                      for owner, names in self.members.items()}
        self.scratch: dict[tuple, tuple] = {}  # kind -> (module, its leaves in member order)
        self.gen = torch.Generator(device=grid.device).manual_seed(0)

    def check(self, shards: dict) -> None:
        if list(shards) != list(self.shapes):
            raise ValueError("the shards are not the model's leaves")
        for name, x in shards.items():
            if tuple(x.shape) != self.local[name]:
                raise ValueError(f"{name}: a shard of {tuple(x.shape)} is not this rank's slice "
                                 f"{self.local[name]} of {self.shapes[name]} under "
                                 f"{self.specs[name]}")

    def leaf(self, shards: dict, name: str) -> torch.Tensor:
        x = shards[name]
        for dim, axis in self.split[name]:
            x = _gather(x, dim, axis, self.grid)
        return x

    def module(self, shards: dict, owner: str, init):
        """The scratch module of ``owner``'s kind (made by ``init(generator)``
        the first time) with ``owner``'s leaves bound to it."""
        kind = self.kinds[owner]
        if kind not in self.scratch:
            mod = init(self.gen)
            cut = len(owner) + 1
            self.scratch[kind] = mod, [mod.get_parameter(n[cut:]) for n in self.members[owner]]
        mod, leaves = self.scratch[kind]
        for p, name in zip(leaves, self.members[owner]):
            p.data = self.leaf(shards, name)
        return mod


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------


class _View:
    """The model's parameters as its stack functions read them
    (``transformer.decoder_prefill``, ``encdec.encode``, ...), each gathered
    where it is read: ``layers`` (whisper's ``enc_layers``, ``dec_layers``)
    yields its layers in order, each bound to the scratch module of its
    kind; a norm is bound to its scratch module; a leaf is gathered at each
    read, but the tied embedding, which the head reads again, once."""

    _INIT = {"layers": lambda gen, cfg, i: T._layer_init(gen, cfg, i),
             "enc_layers": lambda gen, cfg, i: ED.enc_layer_init(gen, cfg),
             "dec_layers": lambda gen, cfg, i: ED.dec_layer_init(gen, cfg)}

    def __init__(self, layers: _Layers, shards: dict, cfg: ModelConfig):
        self._layers, self._shards, self._cfg = layers, shards, cfg

    def __getattr__(self, name: str):
        lay, shards, cfg = self._layers, self._shards, self._cfg
        if name in self._INIT:
            n = cfg.n_encoder_layers if name == "enc_layers" else cfg.n_layers
            init = self._INIT[name]
            return (lay.module(shards, f"{name}.{i}", lambda gen, i=i: init(gen, cfg, i))
                    for i in range(n))
        if name not in lay.members:
            if name == "lm_head":
                return None  # the tied head reads the embedding
            raise AttributeError(name)
        if lay.members[name] != [name]:
            return lay.module(shards, name, lambda gen: L.norm_init(cfg, gen.device))
        x = lay.leaf(shards, name)
        if name == "embed" and cfg.tie_embeddings:
            self.embed = x
        return x


class _Server:
    """Prefill and decode of ``cfg`` on ``grid`` for caches of
    ``init_cache(cfg, grid, batch_size, max_seq)``: the model's own stack
    functions on a ``_View`` of the shards, with the attention, SSM, cross
    K/V and MoE parts that the split cache needs."""

    def __init__(self, cfg: ModelConfig, grid: Grid, batch_size: int, max_seq: int):
        self.cfg, self.grid, self.batch_size, self.max_seq = cfg, grid, batch_size, max_seq
        self.layers = _Layers(cfg, grid)
        whole, self.specs = _whole_specs(cfg, grid, batch_size, max_seq)
        self.parts = _map(lambda _, x, s: _local_shape(x.shape, s, grid), whole, self.specs)
        self.row_spec = batch_pspecs(cfg, {"t": (batch_size, 1)}, grid)["t"]
        self.rows_split = bool(split_dims(self.row_spec, grid))
        self.length = T.attn_cache_len(cfg, max_seq) if not cfg.is_encoder_decoder else max_seq
        self.comm = group_comm(grid)
        # a leaf's spec depends on its name and shape only: one for every
        # layer of a kind
        per_layer = self.specs["self"] if cfg.is_encoder_decoder else self.specs
        self.kv_spec = next((s for s in per_layer if "k" in s), None)
        self.cross_spec = P(*self.specs["cross_k"][1:]) if cfg.is_encoder_decoder else None
        cuts = {}
        ssm = next((i for i, spec in enumerate(per_layer) if "state" in spec), None)
        for name, key, dim in (("heads", "state", 1), ("channels", "conv", 2)):
            if ssm is not None and _split(self.specs[ssm][key], dim, grid):
                n, r = self.parts[ssm][key][dim], grid.coord["model"]
                cuts[name] = slice(r * n, (r + 1) * n)
        self.ssm_decode = functools.partial(S.ssm_decode, comm=self.comm, **cuts)

    # -- checks and parts --------------------------------------------------

    def check_cache(self, cache) -> None:
        def one(path, x, want):
            if not isinstance(x, torch.Tensor) or tuple(x.shape) != want:
                got = tuple(x.shape) if isinstance(x, torch.Tensor) else type(x).__name__
                raise ValueError(f"cache {path}: {got} is not this rank's part {want}")

        _map(one, cache, self.parts)

    def part(self, x: torch.Tensor, spec: P) -> torch.Tensor:
        """The rank's part of ``x``, which holds the rank's rows whole."""
        return local_slice(x, P(*(a if a == "model" else None for a in spec)), self.grid)

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """The data group's rows of ``t``, gathered in rank order."""
        return _gather(t, 0, "data", self.grid) if self.rows_split else t

    # -- the layers' parts -------------------------------------------------

    def ffn(self, layer, cfg: ModelConfig, i: int, x: torch.Tensor):
        """``transformer._ffn`` on the rank's rows; an MoE layer whose
        dispatch groups would straddle data ranks runs on the gathered rows."""
        if self.rows_split and cfg.has_ffn and cfg.layer_is_moe(i):
            local = x.shape[0] * x.shape[1]
            if local % min(cfg.moe_group_size, local * self.grid.shape["data"]):
                rows = x.shape[0]
                y, _ = T._ffn(layer, cfg, i, self.rows(x))
                return y.narrow(0, self.grid.coord["data"] * rows, rows), None
        return T._ffn(layer, cfg, i, x)

    def prefill_mixer(self, layer, cfg: ModelConfig, i: int, h: torch.Tensor, angles, c: dict):
        """``transformer.prefill_mixer`` keeping the rank's part ``c`` of what
        it writes: the layer's whole ring exists while it runs."""
        whole = c
        if cfg.layer_kind(i) == "a":
            whole = L.init_kv_cache(cfg, h.shape[0], self.length, c["k"].dtype, h.device)
        h, whole = T.prefill_mixer(layer, cfg, i, h, angles, whole)
        for key, t in whole.items():
            c[key].copy_(self.part(t, self.specs[i][key]))
        return h, c

    def cross_kv(self, p, cfg: ModelConfig, enc: torch.Tensor):
        """``encdec._kv`` cut to the rank's part of the cross K/V."""
        return tuple(self.part(t, self.cross_spec).contiguous() for t in ED._kv(p, cfg, enc))

    def attn_decode(self, p, cfg: ModelConfig, x, c: dict, position: int, *, window: int = 0,
                    rope: bool = True, rope_position: int | None = None):
        """``layers.attn_decode`` on the rank's part ``c`` of a kv cache."""
        grid, spec = self.grid, self.kv_spec
        kv = _kv_split(spec["k"], grid)
        if kv is None:  # the rank holds the whole leaf
            return L.attn_decode(p, cfg, x, c, position, window=window, rope=rope,
                                 rope_position=rope_position)
        angles = L.decode_angles(cfg, x.shape[0], position, rope_position,
                                 x.device) if rope else None
        q, k, v = L._qkv(p, cfg, x, angles, rope=rope)
        r = grid.coord["model"]
        pos_split = _split(spec["pos"], 1, grid)
        n_pos = c["pos"].shape[1]
        slot = position % (n_pos * grid.shape["model"] if pos_split else n_pos)
        owner, local = divmod(slot, n_pos)  # a host int: no sync
        if owner == r or not pos_split:
            c["pos"][:, local] = position
        if kv == "heads":
            kh = c["k"].shape[2]
            rep = cfg.n_heads // cfg.n_kv_heads
            q = q[:, :, r * kh * rep:(r + 1) * kh * rep]
            c["k"][:, slot] = k[:, 0, r * kh:(r + 1) * kh].to(c["k"].dtype)
            c["v"][:, slot] = v[:, 0, r * kh:(r + 1) * kh].to(c["v"].dtype)
            kpos = self.comm.gather(c["pos"], 1) if pos_split else c["pos"]
            attend = heads_split_sdpa
        else:
            if owner == r:
                c["k"][:, local] = k[:, 0].to(c["k"].dtype)
                c["v"][:, local] = v[:, 0].to(c["v"].dtype)
            kpos, attend = c["pos"], length_split_sdpa
        valid = L.decode_mask(kpos, position, window)
        return L.dense(p.wo, attend(q, c["k"], c["v"], valid[:, None, :], cfg, self.comm)), c

    def cross_decode(self, p, cfg: ModelConfig, x, ck, cv) -> torch.Tensor:
        """``encdec._cross_attend`` on the rank's part of one layer's cross
        K/V."""
        grid = self.grid
        kv = _kv_split(self.cross_spec, grid)
        if kv is None:
            return ED._cross_attend(p, cfg, x, ck, cv)
        b, s, _ = x.shape
        q = L.dense(p.wq, x).reshape(b, s, cfg.n_heads, cfg.hd)
        valid = torch.ones((b, s, ck.shape[1]), dtype=torch.bool, device=x.device)
        if kv == "heads":
            n = cfg.n_heads // grid.shape["model"]
            r = grid.coord["model"]
            return L.dense(p.wo, heads_split_sdpa(q[:, :, r * n:(r + 1) * n], ck, cv, valid,
                                                  cfg, self.comm))
        return L.dense(p.wo, length_split_sdpa(q, ck, cv, valid, cfg, self.comm))

    # -- the steps ---------------------------------------------------------

    @torch.no_grad()
    def prefill(self, shards: dict, batch: dict, cache):
        cfg, grid = self.cfg, self.grid
        self.layers.check(shards)
        self.check_cache(cache)
        bspecs = batch_pspecs(cfg, batch, grid)
        local = {k: local_slice(v, bspecs[k], grid) for k, v in batch.items()}
        view = _View(self.layers, shards, cfg)
        if cfg.is_encoder_decoder:
            return None, ED.encdec_prefill(view, cfg, local["frames"], cache, kv=self.cross_kv)
        return T.decoder_prefill(view, cfg, local["tokens"], cache,
                                 patch_embeds=local.get("patch_embeds"),
                                 mixer=self.prefill_mixer, ffn=self.ffn)

    @torch.no_grad()
    def decode(self, shards: dict, token: torch.Tensor, cache, position: int):
        cfg = self.cfg
        self.layers.check(shards)
        self.check_cache(cache)
        if token.shape[0] == self.batch_size:  # the global token: the rank's rows of it
            token = local_slice(token, self.row_spec, self.grid)
        elif token.shape[0] != self.batch_size // self.grid.shape["data"] or not self.rows_split:
            raise ValueError(f"a token of {tuple(token.shape)} rows is neither the batch of "
                             f"{self.batch_size} nor this rank's rows of it")
        view = _View(self.layers, shards, cfg)
        if cfg.is_encoder_decoder:
            return ED.encdec_decode_step(view, cfg, token, cache, position,
                                         attn=self.attn_decode, cross=self.cross_decode)
        return T.decoder_decode_step(view, cfg, token, cache, position, attn=self.attn_decode,
                                     ssm=self.ssm_decode, ffn=self.ffn)


def build_prefill(cfg: ModelConfig, grid: Grid, batch_size: int, max_seq: int):
    """``step(shards, batch, cache) -> (logits of the rank's rows, cache)``:
    ``models.prefill`` of the global ``batch`` (``batch_size`` rows) on
    ``grid``.  ``shards`` come from ``steps.place`` with
    ``rules.param_pspecs``' specs, ``cache`` from ``init_cache(cfg, grid,
    batch_size, max_seq)``; the rank's part is filled as ``models.prefill``
    fills a cache (attention rings and SSM parts IN PLACE, whisper's cross
    K/V new) and returned.  A shard or cache part of the wrong shape
    raises, naming the leaf."""
    return _Server(cfg, grid, batch_size, max_seq).prefill


def build_decode(cfg: ModelConfig, grid: Grid, batch_size: int, max_seq: int, *,
                 prefill=None):
    """``step(shards, token, cache, position) -> (logits of the rank's rows,
    cache)``: ``models.decode_step`` at ``position`` (a host int) on
    ``grid``.  ``token`` is the global one (``batch_size`` x 1) or the
    rank's rows of it, such as the argmax of the previous step's logits
    (where the rows are split the two differ in size).  Attention parts
    are written IN PLACE, SSM parts come back new, as ``decode_step``
    does.  Given the ``prefill`` step of ``build_prefill`` with the same
    arguments, the decode step shares its scratch layers."""
    if prefill is None:
        return _Server(cfg, grid, batch_size, max_seq).decode
    server = getattr(prefill, "__self__", None)
    if not isinstance(server, _Server) or server.grid is not grid or (
            server.cfg, server.batch_size, server.max_seq) != (cfg, batch_size, max_seq):
        raise ValueError("prefill is not a step of build_prefill with these arguments")
    return server.decode


def greedy_decode(cfg: ModelConfig, grid: Grid, shards: dict, prompt: torch.Tensor,
                  n_steps: int, max_seq: int, *, batch_extra: dict | None = None):
    """``models.greedy_decode`` on ``grid``: prefill the global ``prompt``
    (B, S0) (with ``batch_extra``'s ``patch_embeds`` or ``frames``), then
    ``n_steps`` greedy tokens from ``models.decode_start``; every rank
    returns the global tokens (B, n_steps) and its cache part."""
    b, s0 = prompt.shape
    server = _Server(cfg, grid, b, max_seq)
    cache = init_cache(cfg, grid, b, max_seq)
    logits, cache = server.prefill(shards, {"tokens": prompt, **(batch_extra or {})}, cache)
    if logits is None:  # an encoder-decoder: BOS
        tok = torch.zeros((b, 1), dtype=torch.long, device=prompt.device)
    else:
        tok = torch.argmax(logits[:, -1:], dim=-1)
    start = models.decode_start(cfg, s0, batch_extra)
    out = []
    for i in range(n_steps):
        logits, cache = server.decode(shards, tok, cache, start + i)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    return server.rows(torch.cat(out, dim=1)), cache


def reckon(cfg: ModelConfig, grid: Grid, batch_size: int, max_seq: int) -> dict:
    """This rank's bytes in serving, counted from the shapes (every leaf at
    the model's dtype): its ``shards``; ``gathered``, per kind of layer (and
    for the embedding, head and norms) the whole size of the leaves the grid
    splits (a leaf held whole is bound as it is); ``scratch``, the largest
    kind's layer, made once and dropped leaf by leaf as the first layer of
    its kind binds; the ``cache`` part.  Activations are not counted.
    ``gathered_per_step``: what one prefill or decode step all-gathers into
    whole leaves."""
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    lay = _Layers(cfg, grid)

    def numel(names, local=False):
        return sum(int(np.prod(lay.local[n] if local else lay.shapes[n])) for n in names)

    kinds: dict[tuple, tuple[int, int]] = {}
    for owner, names in lay.members.items():
        kinds[lay.kinds[owner]] = (numel(names), numel([n for n in names if lay.split[n]]))
    split = [n for n in lay.shapes if lay.split[n]]
    whole, specs = _whole_specs(cfg, grid, batch_size, max_seq)
    cache = []
    _map(lambda _, x, s: cache.append(int(np.prod(_local_shape(x.shape, s, grid)))
                                      * x.element_size()), whole, specs)
    out = {"shards": numel(lay.shapes, local=True) * item,
           "gathered": sum(s for _, s in kinds.values()) * item,
           "scratch": max(w for w, _ in kinds.values()) * item, "cache": sum(cache),
           "gathered_per_step": numel(split) * item}
    out["total"] = out["shards"] + out["gathered"] + out["scratch"] + out["cache"]
    return out
