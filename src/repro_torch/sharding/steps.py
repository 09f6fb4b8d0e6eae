"""A spec-placed FSDP / tensor-parallel train step over a ``data`` x
``model`` grid of ranks: the consumer of ``sharding.rules``, the counterpart
of the reference's ``launch/dryrun.build_train``, executed.

    grid = make_grid(ctx, data=D, model=M)
    specs = rules.param_pspecs(cfg, params, grid)
    shards, opt_state = place(params, optimizer.init(params), specs, grid)
    step = build_train(cfg, grid, optimizer)
    shards, opt_state, metrics = step(shards, opt_state, batch)

Rank r sits at (r // M, r % M).  Each rank holds only its slice of every
leaf: a dim under ``"data"`` is split by its data coordinate, one under
``"model"`` by its model coordinate, a ``None`` dim is kept whole; the
optimizer's moments are placed the same way.  Every rank passes the same
global batch.  One step:

  1. gathers each leaf over the axes its spec names into a full-parameter
     ``Decoder`` / ``EncDec`` (gather on use);
  2. runs ``models.loss_fn`` on the rank's rows of the batch (split over
     ``"data"`` by ``rules.batch_pspecs``, the same rows on every rank of a
     model group) and differentiates it;
  3. brings each gradient back to its leaf's spec: a reduce-scatter over
     the data group along a dim under ``"data"`` (the reference's sharding
     constraint under ``cfg.fsdp``), else an all-reduce over it; then the
     rank's ``"model"`` slice;
  4. clips to the global norm and applies the optimizer's update to the
     shards and moments IN PLACE, a block of rows at a time (an update is
     elementwise, so the blocks' results are the whole leaf's; the moments
     never exist twice).

The reference under ``jit`` computes the global batch's loss.  Where a
data-split step would silently compute something else, it is made global:

  * the cross-entropy is a masked mean: the rank's mean is weighted by its
    share of the global mask count, and the weighted means are summed over
    the data group;
  * the MoE aux loss is a product of two token means, and the z loss a
    mean: ``moe_apply`` reduces each mean over the data group
    (``_mean_over``) before the product;
  * MoE dispatch groups of ``moe_group_size`` tokens form the global
    batch's groups only if no group straddles two ranks: the step raises a
    ``ValueError`` otherwise;
  * clipping sums each leaf's squares once: the whole gradient's where
    the rank holds it, else its slice's summed over the axes that split it.

On a 1 x M grid (tensor parallelism alone) every rank holds every whole
gradient, and the step is the unsharded ``make_train_step``'s, bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from .. import distributed
from ..models import init_params, loss_fn
from ..models.config import ModelConfig
from ..optim import Optimizer, apply_updates
from .rules import P, batch_pspecs, param_pspecs

# elements per block of the in-place optimizer update
UPDATE_BLOCK = 1 << 26


@dataclasses.dataclass(frozen=True)
class Grid:
    """A ``data`` x ``model`` grid of ranks; ``shape`` is what the rules read."""

    shape: dict[str, int]
    coord: dict[str, int]  # this rank's coordinate on each axis
    groups: dict[str, Any]  # axis -> the process group of this rank's line along it
    world: Any  # every rank of the grid
    device: torch.device


def make_grid(ctx: distributed.RankContext, data: int, model: int) -> Grid:
    """The ``data`` x ``model`` grid of ``ctx``'s world.  Every rank creates
    every line's group, in the same order (gloo and NCCL hang on a rank
    that skips one)."""
    if data * model != ctx.world:
        raise ValueError(f"a {data} x {model} grid needs {data * model} ranks, "
                         f"the world has {ctx.world}")
    dc, mc = divmod(ctx.rank, model)
    groups = {}
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if d == dc:
            groups["model"] = g
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if m == mc:
            groups["data"] = g
    return Grid({"data": data, "model": model}, {"data": dc, "model": mc}, groups, ctx.group,
                ctx.device)


def split_dims(spec: P, grid: Grid) -> list[tuple[int, str]]:
    """(dim, axis) of each dim that ``spec`` splits over more than one rank."""
    out = []
    for dim, axis in enumerate(spec):
        if isinstance(axis, tuple):
            raise ValueError(f"spec {spec}: a dim over several grid axes is not placed")
        if axis is not None and grid.shape[axis] > 1:
            out.append((dim, axis))
    return out


def local_slice(x: torch.Tensor, spec: P, grid: Grid) -> torch.Tensor:
    """This rank's slice of the full ``x`` (a view)."""
    for dim, axis in split_dims(spec, grid):
        n = x.shape[dim] // grid.shape[axis]
        x = x.narrow(dim, grid.coord[axis] * n, n)
    return x


def place(params, opt_state: dict, specs: dict[str, P], grid: Grid) -> tuple[dict, dict]:
    """(``{name: this rank's slice}``, the optimizer state with every moment
    list sliced likewise) from the full ``params`` (a module or ``{name:
    tensor}``) and ``optimizer.init(params)``.  A split leaf's slice is a
    copy of its own; a leaf this rank holds whole is the given tensor, which
    the step then updates in place."""
    if not isinstance(params, dict):
        params = dict(params.named_parameters())
    spec_list = list(specs.values())

    def own(x, spec):
        if not split_dims(spec, grid):
            return x.detach()
        return local_slice(x.detach(), spec, grid).clone(memory_format=torch.contiguous_format)

    shards = {name: own(params[name], spec) for name, spec in specs.items()}
    state = {k: [own(x, s) for x, s in zip(v, spec_list)] if isinstance(v, list) else v
             for k, v in opt_state.items()}
    return shards, state


def _gather(x: torch.Tensor, dim: int, axis: str, grid: Grid) -> torch.Tensor:
    n = grid.shape[axis]
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((n * moved.shape[0],) + tuple(moved.shape[1:]))
    distributed.all_gather_into(out, moved, grid.groups[axis])
    return out.movedim(0, dim)


def _reduce_to_spec(g: torch.Tensor, spec: P, grid: Grid
                    ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(this rank's part under ``spec`` of the data group's sum of the full
    gradients ``g``, that sum's float32 sum of squares where the rank holds
    all of it, else None)."""
    split = split_dims(spec, grid)
    data_dims = [dim for dim, axis in split if axis == "data"]
    sq = None
    if data_dims:
        n = grid.shape["data"]
        moved = g.movedim(data_dims[0], 0).contiguous()
        out = moved.new_empty((moved.shape[0] // n,) + tuple(moved.shape[1:]))
        g = distributed.reduce_scatter_into(out, moved, grid.groups["data"])
        g = g.movedim(0, data_dims[0])
    else:
        if grid.shape["data"] > 1:
            dist.all_reduce(g, group=grid.groups["data"])
        sq = torch.sum(torch.square(g.to(torch.float32)))
    for dim, axis in split:
        if axis == "model":  # a copy of its own: the full gradient is dropped
            n = g.shape[dim] // grid.shape["model"]
            g = g.narrow(dim, grid.coord["model"] * n, n).clone(
                memory_format=torch.contiguous_format)
    return g, sq


def _global_norm(grads: list[torch.Tensor], sqs: list, specs: list[P], grid: Grid
                 ) -> torch.Tensor:
    """``optim.global_norm`` of the full float32 gradients: each leaf's sum
    of squares is the whole gradient's where the rank held it (``sqs``),
    else its slice's summed over the axes that split it (a kept-whole dim
    is not counted D or M times); then the leaves in order, as
    ``global_norm`` adds them."""
    sq = torch.stack([torch.sum(torch.square(g.to(torch.float32))) if s is None else s
                      for g, s in zip(grads, sqs)])
    split = [frozenset(axis for _, axis in split_dims(spec, grid)) if s is None
             else frozenset() for spec, s in zip(specs, sqs)]
    for axes, group in ((frozenset({"data"}), grid.groups["data"]),
                        (frozenset({"data", "model"}), grid.world)):
        if axes in split:
            mask = torch.tensor([s == axes for s in split], device=sq.device)
            part = torch.where(mask, sq, 0.0)
            dist.all_reduce(part, group=group)
            sq = torch.where(mask, part, sq)
    total = 0.0
    for s in sq.unbind():
        total = total + s
    return torch.sqrt(torch.as_tensor(total))


def _mean_over(group, n: int):
    """``moe_apply``'s ``reduce`` over ``n`` data ranks: the value is the
    mean over the group, the gradient 1 / n of the rank's own term, so the
    data group's sum of the ranks' gradients is the mean's."""

    def reduce(t: torch.Tensor) -> torch.Tensor:
        total = t.detach().clone()
        dist.all_reduce(total, group=group)
        return total / n + (t - t.detach()) / n

    return reduce


def _check_moe_groups(cfg: ModelConfig, batch: dict, n_data: int) -> None:
    """Raise where the rank's tokens would not form the global batch's MoE
    dispatch groups (``moe_apply``: groups of ``min(moe_group_size, tokens)``
    with a padded tail)."""
    b, s = batch["tokens"].shape
    if cfg.n_patches and "patch_embeds" in batch:
        s += batch["patch_embeds"].shape[1]
    local, total = b * s, b * s * n_data
    g = min(cfg.moe_group_size, total)
    if local % g:
        raise ValueError(
            f"{cfg.name}: each of {n_data} data ranks holds {local} tokens, but the global "
            f"batch of {total} tokens forms MoE groups of {g} (moe_group_size "
            f"{cfg.moe_group_size}): a group would straddle two ranks")


def _blocks(x: torch.Tensor):
    """Row ranges of ``x`` of at most ~``UPDATE_BLOCK`` elements."""
    rows = max(1, UPDATE_BLOCK // max(1, x[:1].numel()))
    for lo in range(0, x.shape[0], rows):
        yield lo, min(lo + rows, x.shape[0])


def _update(optimizer: Optimizer, shards: list, grads: list, opt_state: dict,
            norm: torch.Tensor) -> None:
    """The optimizer's update of every shard and moment, in place, a block of
    rows at a time; each gradient is dropped once used."""
    moments = [k for k, v in opt_state.items() if isinstance(v, list)]
    step = None
    for i, p in enumerate(shards):
        g = grads[i]
        for lo, hi in _blocks(p):
            part = {k: [v[i][lo:hi]] if k in moments else v for k, v in opt_state.items()}
            updates, new = optimizer.update([g[lo:hi]], part, [p[lo:hi]], norm=norm)
            p[lo:hi] = apply_updates([p[lo:hi]], updates)[0]
            for k in moments:
                opt_state[k][i][lo:hi] = new[k][0]
            step = new["step"]
        grads[i] = None
    opt_state["step"] = step


def build_train(cfg: ModelConfig, grid: Grid, optimizer: Optimizer):
    """``step(shards, opt_state, batch) -> (shards, opt_state, metrics)`` of
    ``cfg`` on ``grid`` (see the module docstring).  ``shards`` and
    ``opt_state`` come from ``place`` with ``rules.param_pspecs``' specs and
    are updated in place; ``metrics`` are the global batch's ``loss`` and
    ``ce`` (and ``aux_loss``, ``z_loss``), the same on every rank.  The step
    keeps one full-parameter model of ``cfg`` on the grid's device to
    gather into."""
    model = init_params(cfg, 0, device=grid.device)  # its values: the shards, gathered
    leaves = dict(model.named_parameters())
    specs = param_pspecs(cfg, model, grid)
    n_data = grid.shape["data"]
    reduce = _mean_over(grid.groups["data"], n_data) if n_data > 1 else None

    def step(shards: dict, opt_state: dict, batch: dict):
        if list(shards) != list(leaves):
            raise ValueError(f"the shards are not the leaves of {cfg.name}")
        for name, x in shards.items():
            if tuple(x.shape) != tuple(local_slice(leaves[name], specs[name], grid).shape):
                raise ValueError(f"{name}: a shard of {tuple(x.shape)} is not this rank's "
                                 f"slice of {tuple(leaves[name].shape)} under {specs[name]}")
        with torch.no_grad():
            for name, x in shards.items():
                for dim, axis in split_dims(specs[name], grid):
                    x = _gather(x, dim, axis, grid)
                leaves[name].copy_(x)
        bspecs = batch_pspecs(cfg, batch, grid)
        local = {k: local_slice(v, bspecs[k], grid) for k, v in batch.items()}
        if cfg.n_experts and any(split_dims(s, grid) for s in bspecs.values()):
            _check_moe_groups(cfg, local, n_data)
        count = torch.sum(local["mask"])
        total = count.clone()
        if n_data > 1:
            dist.all_reduce(total, group=grid.groups["data"])
        weight = count / torch.clamp(total, min=1.0)
        params = list(leaves.values())
        with torch.enable_grad():
            for p in params:
                p.requires_grad_(True)
            _, m = loss_fn(cfg, model, local, moe_reduce=reduce)
            part = m["ce"] * weight
            ce = part.detach().clone()
            if n_data > 1:
                dist.all_reduce(ce, group=grid.groups["data"])
            loss = ce + (part - part.detach())  # the global value, this rank's gradient
            metrics = {"loss": loss, "ce": ce}
            if cfg.n_experts:  # loss_fn's sum, over the global cross-entropy
                loss = (loss + cfg.router_aux_weight * m["aux_loss"]
                        + cfg.router_z_weight * m["z_loss"])
                metrics.update(loss=loss, aux_loss=m["aux_loss"], z_loss=m["z_loss"])
            grads = list(torch.autograd.grad(loss, params))
            for p in params:
                p.requires_grad_(False)
        metrics = {k: v.detach() for k, v in metrics.items()}
        with torch.no_grad():
            spec_list, sqs = list(specs.values()), []
            for i, spec in enumerate(spec_list):
                grads[i], sq = _reduce_to_spec(grads[i], spec, grid)
                sqs.append(sq)
            norm = _global_norm(grads, sqs, spec_list, grid)
            _update(optimizer, list(shards.values()), grads, opt_state, norm)
        return shards, opt_state, metrics

    return step
