"""SN-Train: distributed kernel regression by alternating projections.

Port of ``repro.core.sn_train`` (the build, the serial and colored
engines, the sensor-level robust engine ``robust_sweep``, ``field_view``,
the single-field serial engines ``random_sweep``,
``robust_sweep_links`` and ``weighted_sweep``, and ``sharded_sweep`` over a
``torch.distributed`` group).
Each sensor ``s`` keeps a local function
``f_s = sum_{j in N_s} c_{s,j} K(., x_j)`` and the network shares a message
vector ``z``.  One projection at s
(paper Table 1 / Eq. 18):

    c_{s,t} = (K_s + lambda_s I)^{-1} (z_{N_s, t-1} + lambda_s c_{s,t-1})
    z_j <- f_{s,t}(x_j)   for j in N_s

The colored sweep updates all sensors of one distance-2 color class at once
(paper Sec. 3.3) and runs the classes in order.  Layouts are the
reference's: ``z (B, n + n_stream + 1)`` with the write sentinel last,
``coef (B, n+1, D)`` with the sentinel row last, per-field ``gram``/``chol``
``(B, n+1, D, D)``; single-field problems drop the leading ``B``.

Engines of ``colored_sweep``:

  ``"plan"``    (default) the static scatter plans: one gather per color;
  ``"onehot"``  the dense one-hot GEMM realization, the simple oracle the
                plans are tested against (plan == onehot bit for bit);
  ``"cuda"``    the hand-written color-step kernel
                (``repro_torch.kernels.color_step.color_sweep``, one launch
                per call), the counterpart of the reference's
                ``"pallas"``.  On CPU tensors it runs the kernel's plain
                PyTorch version.

``serial_sweep`` is the paper's Table-1 ordering, one sensor at a time
(plain PyTorch, every field of a batch at once).

The colored engine's local solves are forward and back substitution over the cached
Cholesky factors, vectorized over all B*M lanes, and not LAPACK's
``cholesky_solve``: the reference measured the substitution as more
accurate in f32 at the paper's ill-conditioned lambdas.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .. import device as _device
from ..distributed import all_gather_into
from . import plans
from .kernels_math import Kernel
from .plans import LifecycleLayout
from .topology import SensorTopology, pad_topology


@dataclasses.dataclass(frozen=True)
class SNTrainProblem:
    """Static per-network precomputation for SN-Train (fixed, padded shapes).

    ``n`` is the sensor count, ``D`` the padded neighborhood size, ``S`` the
    reserved streaming capacity (``n_stream``).  Batched problems prepend a
    field axis ``B`` to ``y``, ``nbr_pos``, ``nbr_mask``, ``gram``,
    ``chol``, ``stream_pos`` and ``anchor_w``.
    """

    topology: SensorTopology
    kernel: Kernel
    y: torch.Tensor  # (n,) measurements
    lambdas: torch.Tensor  # (n,) per-sensor regularizers
    nbr_pos: torch.Tensor  # (n+1, D, d) neighbor positions (padded row n)
    nbr_idx: torch.Tensor  # (n+1, D) int32 message-slot ids
    nbr_mask: torch.Tensor  # (n+1, D) bool
    gram: torch.Tensor  # (n+1, D, D) masked local Gram K_s
    chol: torch.Tensor  # (n+1, D, D) lower Cholesky of K_s + lambda_s I
    lam_pad: torch.Tensor  # (n+1,)
    stream_pos: torch.Tensor  # (S, d) arrival positions (zeros until absorbed)
    plan_z: torch.Tensor  # (n_colors, n_z) int32 color-step gather plan for z
    plan_coef: torch.Tensor  # (n_colors, n+1) int32 gather plan for coef
    color_members: torch.Tensor  # (n_colors, M) int32 member rows per class
    color_mask: torch.Tensor  # (n_colors, M) bool validity of color_members
    color_of: torch.Tensor  # (n+1,) int32 color per row (sentinel: n_colors)
    member_pos: torch.Tensor  # (n+1,) int32 position of each row in its color
    alive: torch.Tensor  # (n+1,) bool row liveness; the sentinel row is dead
    beta: torch.Tensor  # () / (B,) forgetting factor in (0, 1]
    anchor_w: torch.Tensor  # (n+1, D) / (B, n+1, D) per-lane anchor weights
    layout: LifecycleLayout
    n_stream: int = 0

    @property
    def n(self) -> int:
        return self.topology.n

    @property
    def batched(self) -> bool:
        return self.y.ndim == 2

    @property
    def batch_size(self) -> int | None:
        return int(self.y.shape[0]) if self.batched else None

    @property
    def sentinel(self) -> int:
        """Index of the write-sentinel slot of z (== n + n_stream)."""
        return self.n + self.n_stream

    @property
    def n_z(self) -> int:
        return self.n + self.n_stream + 1

    @property
    def n_base(self) -> int:
        """Build-time sensor count; rows [n_base, n) are join capacity."""
        return self.layout.n_base

    @property
    def alive_z(self) -> torch.Tensor:
        """(n_z,) message-slot liveness (a slot lives with its owning row)."""
        return plans.alive_slots(self.alive, self.layout.slot_owner)

    @property
    def recolor_start(self) -> int:
        """First reserved recolor class (the pool symmetric joins use)."""
        return int(self.color_members.shape[0]) - self.topology.n_recolor

    @property
    def device(self) -> torch.device:
        return self.y.device


@dataclasses.dataclass(frozen=True)
class SNTrainState:
    z: torch.Tensor  # (n+S+1,) messages; the last slot is a write sentinel
    coef: torch.Tensor  # (n+1, D) per-sensor representer coefficients


def factor(a: torch.Tensor, check: bool = False) -> torch.Tensor:
    """Row-major lower Cholesky factors of a batch of SPD matrices.

    Every factor of a local system goes through here: the build, streaming,
    the lifecycle repairs and ``robust_sweep``'s per-sweep refactorization,
    so a system factored again on the same batch shape gets the same bits.
    ``check=False`` never syncs (a failure returns non-finite factors, as
    the reference does); ``check=True`` raises on one (build time).  CUDA's
    factors come back column-major, so they are made contiguous.
    """
    return torch.linalg.cholesky_ex(a, check_errors=check).L.contiguous()


def _local_systems(gram: torch.Tensor, mask: torch.Tensor, lam_pad: torch.Tensor):
    """``K_s + lambda_s I`` over the lanes of ``mask`` (..., R, D); the other
    lanes get a unit diagonal, so their coefficients stay exactly 0."""
    diag = torch.where(mask, lam_pad[:, None], torch.ones((), dtype=gram.dtype,
                                                           device=gram.device))
    return gram + torch.diag_embed(diag)


def default_lambdas(topology: SensorTopology, kappa: float = 0.01) -> torch.Tensor:
    """Paper Sec. 4.1: lambda_i = kappa / |N_i|^2 (spare rows: 1.0)."""
    deg = topology.degrees.to(torch.float32)
    return torch.where(deg > 0, kappa / torch.clamp(deg, min=1) ** 2, 1.0)


def _pad_per_sensor(arr: torch.Tensor, n: int, fill) -> torch.Tensor:
    short = n - arr.shape[-1]
    if short == 0:
        return arr
    if short < 0:
        raise ValueError(f"per-sensor array longer ({arr.shape[-1]}) than n={n}")
    pad = torch.full(arr.shape[:-1] + (short,), fill, dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad], dim=-1)


def make_problem(
    topology: SensorTopology,
    kernel: Kernel,
    y,
    lambdas=None,
    *,
    dtype: torch.dtype = torch.float32,
    n_max: int | None = None,
    beta: float = 1.0,
    device: str | torch.device = "cuda",
) -> SNTrainProblem:
    """Precompute the padded SN-Train problem on ``device``.

    The topology must already live there.  float64 reproduces the paper's
    numerics at its own lambdas; float32 needs larger lambdas (the same
    caveat as the reference).  ``n_max`` pads the topology with spare rows.
    """
    dev = _device.resolve(device)
    if topology.device != dev:
        raise ValueError(f"topology lives on {topology.device}, not {dev}")
    if not 0.0 < float(beta) <= 1.0:
        raise ValueError(f"beta must be in (0, 1], got {beta}")
    if n_max is not None:
        topology = pad_topology(topology, n_max)
    n, d_max = topology.nbr_idx.shape
    d = topology.positions.shape[1]
    n_base = topology.n_base if topology.n_base >= 0 else n
    if lambdas is None:
        lambdas = default_lambdas(topology)
    # copies: the problem never aliases the caller's arrays
    lambdas = torch.as_tensor(lambdas, dtype=dtype, device=dev).clone()
    lambdas = _pad_per_sensor(lambdas, n, 1.0)
    y = _pad_per_sensor(torch.as_tensor(y, dtype=dtype, device=dev).clone(), n, 0.0)

    idx_full, n_stream = plans.assign_stream_slots(
        topology.nbr_idx.cpu().numpy(), topology.degrees.cpu().numpy()
    )
    # Base rows alive, spare rows and the sentinel row n dead.
    alive0 = np.arange(n + 1) < n_base
    color_members = topology.color_members.cpu().numpy()
    color_mask = topology.color_mask.cpu().numpy()
    plan_z, plan_coef = plans.build_color_plans(
        color_members, color_mask, idx_full, n_stream, alive0
    )
    layout = plans.build_layout(idx_full, n_stream, n_base, device=dev)
    color_of, member_pos = plans.color_assignments(
        topology.colors.cpu().numpy(), color_members, color_mask
    )
    nbr_mask = torch.cat(
        [topology.nbr_mask, torch.zeros((1, d_max), dtype=torch.bool, device=dev)]
    )
    pos_pad = torch.cat(
        [topology.positions.to(dtype), torch.zeros((1, d), dtype=dtype, device=dev)]
    )
    sentinel_row = torch.full((1, d_max), n, dtype=topology.nbr_idx.dtype, device=dev)
    nbr_pos = pos_pad[torch.cat([topology.nbr_idx, sentinel_row])]  # (n+1, D, d)
    lam_pad = torch.cat([lambdas, torch.ones((1,), dtype=dtype, device=dev)])

    # Local systems: masked Gram K_s, and the factor of K_s + lambda_s I with
    # padded diagonal entries set to 1 (padded coefficients stay exactly 0).
    gram = kernel(nbr_pos, nbr_pos)  # (n+1, D, D)
    outer = nbr_mask[:, :, None] & nbr_mask[:, None, :]
    gram = torch.where(outer, gram, torch.zeros((), dtype=dtype, device=dev))
    chol = factor(_local_systems(gram, nbr_mask, lam_pad), check=True)

    # copies: on the CPU ``as_tensor`` would share the numpy buffers, and the
    # lifecycle events write these tables in place
    t = lambda a, dt=None: torch.tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    return SNTrainProblem(
        topology=topology,
        kernel=kernel,
        y=y,
        lambdas=lambdas,
        nbr_pos=nbr_pos,
        nbr_idx=t(idx_full, torch.int32),
        nbr_mask=nbr_mask,
        gram=gram,
        chol=chol,
        lam_pad=lam_pad,
        stream_pos=torch.zeros((n_stream, d), dtype=dtype, device=dev),
        plan_z=t(plan_z),
        plan_coef=t(plan_coef),
        color_members=t(color_members, torch.int32),
        color_mask=t(color_mask, torch.bool),
        color_of=t(color_of),
        member_pos=t(member_pos),
        alive=t(alive0),
        beta=torch.tensor(beta, dtype=dtype, device=dev),
        anchor_w=torch.ones((n + 1, d_max), dtype=dtype, device=dev),
        layout=layout,
        n_stream=n_stream,
    )


def make_batch_problem(
    topology: SensorTopology,
    kernel: Kernel,
    ys,
    lambdas=None,
    *,
    dtype: torch.dtype = torch.float32,
    n_max: int | None = None,
    beta=1.0,
    device: str | torch.device = "cuda",
) -> SNTrainProblem:
    """B independent fields over one network: ``ys`` is (B, n).

    Geometry is shared; the per-field tables start as B identical copies
    (materialized, so every field's rows are contiguous for the kernels).
    ``beta`` is a scalar or a (B,) vector of forgetting factors.
    """
    dev = _device.resolve(device)
    ys = torch.as_tensor(ys, dtype=dtype, device=dev).clone()
    if ys.ndim != 2:
        raise ValueError(f"ys must be (B, n), got shape {tuple(ys.shape)}")
    base = make_problem(
        topology, kernel, ys[0], lambdas, dtype=dtype, n_max=n_max, device=dev
    )
    ys = _pad_per_sensor(ys, base.n, 0.0)
    b = ys.shape[0]
    beta = torch.broadcast_to(torch.as_tensor(beta, dtype=dtype, device=dev), (b,))
    if not bool(torch.all((beta > 0.0) & (beta <= 1.0))):
        raise ValueError(f"beta must be in (0, 1] per field, got {beta}")

    def tile(a):
        return a[None].expand((b,) + tuple(a.shape)).contiguous()

    nbr_mask, gram = tile(base.nbr_mask), tile(base.gram)
    return dataclasses.replace(
        base,
        y=ys,
        nbr_pos=tile(base.nbr_pos),
        nbr_mask=nbr_mask,
        gram=gram,
        # factored again at the (B, n+1) shape robust_sweep refactors, so
        # its all-alive factors are these bits on any device
        chol=factor(_local_systems(gram, nbr_mask, base.lam_pad), check=True),
        stream_pos=tile(base.stream_pos),
        beta=beta.clone(),
        anchor_w=tile(base.anchor_w),
    )


def field_view(
    problem: SNTrainProblem, state: SNTrainState, b: int
) -> tuple[SNTrainProblem, SNTrainState]:
    """Single-field view of field ``b`` of a batched problem/state."""
    if not problem.batched:
        raise ValueError("field_view expects a batched problem")
    prob = dataclasses.replace(
        problem,
        y=problem.y[b],
        nbr_pos=problem.nbr_pos[b],
        nbr_mask=problem.nbr_mask[b],
        gram=problem.gram[b],
        chol=problem.chol[b],
        stream_pos=problem.stream_pos[b],
        beta=problem.beta[b],
        anchor_w=problem.anchor_w[b],
    )
    return prob, SNTrainState(z=state.z[b], coef=state.coef[b])


def weighted_norm_sq(problem: SNTrainProblem, state: SNTrainState) -> torch.Tensor:
    """The SOP product-space norm ||z||^2 + sum_i lambda_i c_i^T K_i c_i.

    Non-increasing along any admissible SOP ordering (Lemma 2.1); batched
    inputs return one norm per field.
    """
    z_part = torch.sum(state.z[..., :-1] ** 2, dim=-1)  # excludes the sentinel
    quad = torch.einsum("...sd,...sde,...se->...s", state.coef, problem.gram, state.coef)
    return z_part + torch.sum(problem.lam_pad * quad, dim=-1)


def init_state(problem: SNTrainProblem) -> SNTrainState:
    """Paper Table 1 initialization: z_{s,0} = y_s, f_{s,0} = 0."""
    n, d_max = problem.n, problem.nbr_idx.shape[-1]
    dt, dev = problem.y.dtype, problem.y.device
    lead = problem.y.shape[:-1]
    z = torch.cat(
        [problem.y, torch.zeros(lead + (problem.n_stream + 1,), dtype=dt, device=dev)],
        dim=-1,
    )
    coef = torch.zeros(lead + (n + 1, d_max), dtype=dt, device=dev)
    return SNTrainState(z=z, coef=coef)


def effective_coef(problem: SNTrainProblem, state: SNTrainState) -> torch.Tensor:
    """TRUE representer coefficients a = anchor_w * coef (identity at beta=1)."""
    return state.coef * problem.anchor_w.to(state.coef.dtype)


# ---------------------------------------------------------------------------
# Serial engine: the paper's Table-1 ordering, one sensor at a time, every
# field of a batch at once.
# ---------------------------------------------------------------------------


def _sensor_update(z, coef_s, nbr_idx_s, nbr_mask_s, gram_s, chol_s, lam_s):
    """One P_{C_s} projection (Eq. 18) for B fields: z (B, n_z), coef_s (B, D),
    nbr_mask_s (B, D), gram_s/chol_s (B, D, D).  Returns (coef_s', z at N_s)."""
    z_nbr = z[:, nbr_idx_s]  # (B, D)
    rhs = torch.where(nbr_mask_s, z_nbr + lam_s * coef_s, 0.0)
    coef_new = torch.cholesky_solve(rhs[..., None], chol_s, upper=False)[..., 0]
    z_new = (gram_s @ coef_new[..., None])[..., 0]  # f_s(x_j) for j in N_s
    return coef_new, z_new


def _serial_core(
    nbr_idx, nbr_mask, gram, chol, lam_pad, sentinel, z, coef, n_sweeps,
    alive_row, alive_slot, delivered=None, orders=None,
):
    """Sweeps over explicit leading field axes, sensors 0..n-1 in order
    (``orders``: one host sequence of sensor ids per sweep instead).

    A dead sensor neither updates nor is heard from; an undelivered lane's
    message write never lands (its slot keeps its last value), while the
    local coefficient update still runs.
    """
    z, coef = z.clone(), coef.clone()
    n = nbr_idx.shape[0] - 1
    for t in range(n_sweeps):
        for s in range(n) if orders is None else orders[t]:
            idx = nbr_idx[s].long()
            mask_s = nbr_mask[:, s] & alive_slot[idx] & alive_row[s]  # (B, D)
            coef_new, z_new = _sensor_update(
                z, coef[:, s], idx, mask_s, gram[:, s], chol[:, s], lam_pad[s]
            )
            coef[:, s] = torch.where(alive_row[s], coef_new, coef[:, s])
            send = mask_s if delivered is None else mask_s & delivered[t, s]
            # unsent lanes write the sentinel's own value back to it
            target = torch.where(send, idx, sentinel)
            value = torch.where(send, z_new, z[:, sentinel : sentinel + 1])
            z.scatter_(1, target, value)
    return z, coef


def serial_sweep(
    problem: SNTrainProblem,
    state: SNTrainState,
    n_sweeps: int = 1,
    *,
    delivered: torch.Tensor | None = None,
) -> SNTrainState:
    """The paper's Table-1 serial ordering: for t: for s: project.

    Batched problems run every field's serial sweep at once.  delivered:
    optional (n_sweeps, n+1, D) bool per-sweep link-delivery mask shared
    across fields; a dropped lane's message write never lands.  All-True is
    bitwise the fault-free sweep.  Plain PyTorch: n_sweeps x n dependent
    steps, the reference ordering the other engines are checked against.
    """
    if delivered is not None and delivered.shape[0] != n_sweeps:
        raise ValueError(
            f"delivered has {delivered.shape[0]} sweeps, expected {n_sweeps}"
        )
    args = (problem.nbr_mask, problem.gram, problem.chol, state.z, state.coef)
    if not problem.batched:
        args = tuple(a[None] for a in args)
    nbr_mask, gram, chol, z, coef = args
    z, coef = _serial_core(
        problem.nbr_idx, nbr_mask, gram, chol, problem.lam_pad, problem.sentinel,
        z, coef, n_sweeps, problem.alive, problem.alive_z, delivered,
    )
    if not problem.batched:
        z, coef = z[0], coef[0]
    return SNTrainState(z=z, coef=coef)


# ---------------------------------------------------------------------------
# Colored engine.  The field axis is explicit (B = 1 for single-field
# problems).  Within one color every touched message slot has a unique
# owner (distance-2 coloring), so the scatter back is an exact write.
# ---------------------------------------------------------------------------


def _tri_solve_spd(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(L L^T)^{-1} rhs by forward then back substitution over the last axis.

    chol: (..., D, D) lower factors (padded rows identity), rhs: (..., D).
    Each of the 2D steps is one batched row operation over every lane.
    """
    d = chol.shape[-1]
    y = torch.zeros_like(rhs)
    for i in range(d):
        li = chol[..., i, :]
        y[..., i] = (rhs[..., i] - torch.sum(li * y, dim=-1)) / chol[..., i, i]
    x = torch.zeros_like(rhs)
    for i in range(d - 1, -1, -1):
        ui = chol[..., :, i]
        x[..., i] = (y[..., i] - torch.sum(ui * x, dim=-1)) / chol[..., i, i]
    return x


def _color_solve(
    nbr_idx, lam_pad, alive_row, alive_slot, nbr_mask, gram, chol, z, coef,
    members, member_mask,
):
    """Simultaneous local solves of one color for all B fields.

    Dead members solve to exact zeros and dead neighbors/slots drop out of
    every rhs.  Returns (idx_m (M, D), coef_new (B, M, D), z_new (B, M, D)).
    """
    idx_m = nbr_idx[members]  # (M, D) shared across fields
    live_m = member_mask & alive_row[members]
    mask_m = nbr_mask[:, members] & live_m[None, :, None] & alive_slot[idx_m][None]
    gram_m = gram[:, members]
    chol_m = chol[:, members]
    lam_m = lam_pad[members]
    coef_m = coef[:, members]
    b = z.shape[0]
    z_nbr = z[:, idx_m.reshape(-1)].reshape((b,) + tuple(idx_m.shape))
    rhs = torch.where(mask_m, z_nbr + lam_m[None, :, None] * coef_m, 0.0)
    coef_new = _tri_solve_spd(chol_m, rhs)
    z_new = torch.einsum("bmij,bmj->bmi", gram_m, coef_new)  # f_s at N_s
    return idx_m, coef_new, z_new


def _apply_plan(
    z, coef, z_new, coef_new, plan_z_c, plan_coef_c, live_m, alive_slot,
    deliv_flat=None,
):
    """Static-gather realization of the color-step scatter: O(n_z + n*D).

    Codes whose source member or target slot is dead, and (``deliv_flat``,
    (M*D,)) undelivered lanes, degrade to "keep"; the coefficient scatter
    needs only the source gate.
    """
    b, n_z = z.shape
    d = z_new.shape[-1]
    m = live_m.shape[0]
    zc = torch.cat([z, z_new.reshape(b, -1)], dim=-1)[:, plan_z_c]
    src_m = torch.clamp(torch.div(plan_z_c - n_z, d, rounding_mode="floor"), 0, m - 1)
    fresh_ok = live_m[src_m] & alive_slot
    if deliv_flat is not None:
        lane = torch.clamp(plan_z_c - n_z, 0, deliv_flat.shape[0] - 1)
        fresh_ok = fresh_ok & deliv_flat[lane]
    use = (plan_z_c < n_z) | fresh_ok
    z = torch.where(use[None, :], zc, z)
    n_rows = coef.shape[1]
    cc = torch.cat([coef, coef_new], dim=1)[:, plan_coef_c]
    srcc = torch.clamp(plan_coef_c - n_rows, 0, m - 1)
    usec = (plan_coef_c < n_rows) | live_m[srcc]
    coef = torch.where(usec[None, :, None], cc, coef)
    return z, coef


def _apply_onehot(
    z, coef, z_new, coef_new, idx_m, members, n_z, n_rows, live_m, alive_slot,
    deliv_flat=None,
):
    """Dense one-hot reference realization: O(M*D*n_z) GEMMs per color.

    Dead members' one-hot rows, dead slots' columns and undelivered lanes'
    rows are zeroed, the same gates as the plan gather.
    """
    b = z.shape[0]
    d = idx_m.shape[-1]
    dt, dev = z.dtype, z.device
    flat_idx = idx_m.reshape(-1).long()
    live_f = torch.repeat_interleave(live_m, d).to(dt)
    if deliv_flat is not None:
        live_f = live_f * deliv_flat.to(dt)
    oh = (flat_idx[:, None] == torch.arange(n_z, device=dev)[None, :]).to(dt)
    oh = oh * live_f[:, None] * alive_slot.to(dt)[None, :]
    hit = oh.sum(dim=0)
    z = z * (1.0 - hit)[None, :] + torch.einsum("kz,bk->bz", oh, z_new.reshape(b, -1))
    ohm = (members.long()[:, None] == torch.arange(n_rows, device=dev)[None, :]).to(dt)
    ohm = ohm * live_m.to(dt)[:, None]
    hitm = ohm.sum(dim=0)
    coef = coef * (1.0 - hitm)[None, :, None] + torch.einsum("mn,bmd->bnd", ohm, coef_new)
    return z, coef


ENGINES = ("plan", "onehot", "cuda")


def _colored_core(
    problem: SNTrainProblem, nbr_mask, gram, chol, z, coef, n_sweeps,
    engine: str = "plan",
    alive=None,
    delivered=None,
):
    """Batched colored sweep over explicit leading field axes.

    ``alive`` overrides the problem's row liveness; ``delivered`` is the
    optional (n_sweeps, n+1, D) per-sweep link-delivery mask shared across
    fields (an undelivered lane's message write never lands).
    """
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if delivered is not None and delivered.shape[0] != n_sweeps:
        raise ValueError(
            f"delivered has {delivered.shape[0]} sweeps, expected {n_sweeps}"
        )
    alive_row = problem.alive if alive is None else alive
    alive_slot = plans.alive_slots(alive_row, problem.layout.slot_owner)
    n_colors = problem.color_members.shape[0]

    if engine == "cuda":
        from ..kernels.color_step import color_sweep

        # The kernel writes z and coef in place (the reference returns new
        # buffers); the caller's state is copied once per call instead.  All
        # n_sweeps x n_colors color steps are one launch.
        z, coef = z.clone(), coef.clone()
        color_sweep(
            z, coef, problem.nbr_idx, nbr_mask, gram, chol, problem.lam_pad,
            alive_row, alive_slot, problem.color_members, problem.color_mask,
            delivered, n_sweeps,
        )
        return z, coef

    for t in range(n_sweeps):
        deliv_t = None if delivered is None else delivered[t]
        for c in range(n_colors):
            members = problem.color_members[c]
            member_mask = problem.color_mask[c]
            live_m = member_mask & alive_row[members]
            deliv_flat = None if deliv_t is None else deliv_t[members].reshape(-1)
            idx_m, coef_new, z_new = _color_solve(
                problem.nbr_idx, problem.lam_pad, alive_row, alive_slot,
                nbr_mask, gram, chol, z, coef, members, member_mask,
            )
            if engine == "plan":
                z, coef = _apply_plan(
                    z, coef, z_new, coef_new, problem.plan_z[c],
                    problem.plan_coef[c], live_m, alive_slot, deliv_flat,
                )
            else:
                z, coef = _apply_onehot(
                    z, coef, z_new, coef_new, idx_m, members, problem.n_z,
                    problem.n + 1, live_m, alive_slot, deliv_flat,
                )
    return z, coef


def colored_sweep(
    problem: SNTrainProblem,
    state: SNTrainState,
    n_sweeps: int = 1,
    *,
    engine: str = "plan",
    alive: torch.Tensor | None = None,
    delivered: torch.Tensor | None = None,
) -> SNTrainState:
    """Distance-2-colored parallel SOP (paper Sec. 3.3 'Parallelism').

    engine: "plan", "onehot" or "cuda" (see the module docstring).
    alive: optional (n+1,) row-liveness override (dead sensors neither
    update nor are heard from).  delivered: optional (n_sweeps, n+1, D) bool
    link-delivery mask; dropped messages hold their last value.  All-True
    masks are bitwise identities, engine by engine.
    """
    if problem.batched:
        z, coef = _colored_core(
            problem, problem.nbr_mask, problem.gram, problem.chol,
            state.z, state.coef, n_sweeps, engine, alive, delivered,
        )
        return SNTrainState(z=z, coef=coef)
    z, coef = _colored_core(
        problem, problem.nbr_mask[None], problem.gram[None], problem.chol[None],
        state.z[None], state.coef[None], n_sweeps, engine, alive, delivered,
    )
    return SNTrainState(z=z[0], coef=coef[0])


# ---------------------------------------------------------------------------
# Sharded engine: sensors (single-field) or fields (batched) distributed over
# the ranks of a torch.distributed group, one process per rank.
# ---------------------------------------------------------------------------


def sharded_sweep(
    problem: SNTrainProblem,
    state: SNTrainState,
    group=None,
    *,
    n_sweeps: int,
    engine: str = "plan",
    delivered: torch.Tensor | None = None,
) -> SNTrainState:
    """``colored_sweep`` distributed over the ranks of ``group`` (default: the
    default group).  Every rank passes the same replicated problem and state
    and gets back the whole replicated state.

    Single-field: each color's members are split over the ranks.  A rank
    solves its contiguous shard; because a color's neighborhoods are
    disjoint, the shards touch disjoint slots, so two rank-ordered
    all-gathers assemble the color's touched values, (M*D,) fresh messages
    and (M, D) fresh coefficients, and every rank applies the color's static
    scatter plan itself.  Members are padded to a multiple of the world size
    by appending, so a member's flat position ``m*D + k`` stays the plans'
    coordinate.  Only the plan transport exists here.

    Batched: the field axis is split instead; each rank runs the colored
    engine (any of ``ENGINES``; with ``"cuda"`` one ``color_sweep`` launch)
    on its B/W fields, and one all-gather returns them.

    delivered: optional (n_sweeps, n+1, D) bool link-delivery mask,
    replicated in both regimes (delivery is a property of the physical
    lane); dropped messages hold their last value, all-True is bitwise
    fault-free.  A world of one is ``colored_sweep`` bitwise.
    """
    if problem.batched:
        return _sharded_sweep_fields(problem, state, group, n_sweeps=n_sweeps,
                                     engine=engine, delivered=delivered)
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if engine != "plan":
        raise NotImplementedError(
            "single-field sharded_sweep implements the plan transport only "
            "(the psum payload IS the plan's touched-slot buffer); engine "
            "selection applies to batched, field-sharded problems"
        )
    if delivered is not None and delivered.shape[0] != n_sweeps:
        raise ValueError(
            f"delivered has {delivered.shape[0]} sweeps, expected {n_sweeps}"
        )
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n_colors, m_max = problem.color_members.shape
    m_local = -(-m_max // world)
    pad = m_local * world - m_max
    members = torch.cat([problem.color_members, torch.full(
        (n_colors, pad), problem.n, dtype=problem.color_members.dtype,
        device=problem.device)], dim=1)  # (n_colors, m_pad)
    mask = torch.cat([problem.color_mask, torch.zeros(
        (n_colors, pad), dtype=torch.bool, device=problem.device)], dim=1)
    live_full = mask & problem.alive[members]
    lo, hi = rank * m_local, (rank + 1) * m_local
    alive_z = problem.alive_z
    d = problem.nbr_idx.shape[1]
    z, coef = state.z[None], state.coef[None]
    for t in range(n_sweeps):
        for c in range(n_colors):
            _, coef_new, z_new = _color_solve(
                problem.nbr_idx, problem.lam_pad, problem.alive, alive_z,
                problem.nbr_mask[None], problem.gram[None], problem.chol[None],
                z, coef, members[c, lo:hi], mask[c, lo:hi],
            )
            z_full = all_gather_into(
                z.new_empty((world * m_local * d,)), z_new[0].reshape(-1), group)
            c_full = all_gather_into(coef.new_empty((world * m_local, d)), coef_new[0], group)
            deliv_flat = None if delivered is None else delivered[t][members[c]].reshape(-1)
            z, coef = _apply_plan(
                z, coef, z_full[None], c_full[None], problem.plan_z[c],
                problem.plan_coef[c], live_full[c], alive_z, deliv_flat,
            )
    return SNTrainState(z=z[0], coef=coef[0])


def _sharded_sweep_fields(problem, state, group, *, n_sweeps, engine="plan", delivered=None):
    """Field-data-parallel split of the batched colored engine; the
    replicated ``delivered`` is shared by every rank's fields."""
    b = problem.batch_size
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if b % world != 0:
        raise ValueError(f"batch size {b} must divide over {world} devices")
    lo, hi = rank * (b // world), (rank + 1) * (b // world)
    z, coef = _colored_core(
        problem, problem.nbr_mask[lo:hi], problem.gram[lo:hi], problem.chol[lo:hi],
        state.z[lo:hi], state.coef[lo:hi], n_sweeps, engine, delivered=delivered,
    )
    return SNTrainState(z=all_gather_into(torch.empty_like(state.z), z, group),
                        coef=all_gather_into(torch.empty_like(state.coef), coef, group))


# ---------------------------------------------------------------------------
# Robust engine: transient sensor liveness (paper Sec. 3.3 'Robustness').
# ---------------------------------------------------------------------------


def _masked_factors(problem: SNTrainProblem, nbr_mask, gram, alive_row):
    """Every local system refactored under the liveness ``alive_row`` (n+1,).

    The build's recipe over the effective lanes (occupied, and the slot's
    owner and the row alive): the Gram masked to them, lambda on their
    diagonal and 1 elsewhere, one batched ``factor`` call.  At all-True
    liveness on an arrival-free batched problem this is the build's own
    matrix at the build's (B, n+1) shape, so the factors are the cached
    ones bit for bit; rows that absorbed arrivals carry grow-one factors,
    which a fresh factorization matches to rounding.  nbr_mask/gram carry
    an explicit leading field axis.  Returns (gram_eff, chol_eff).
    """
    alive_slot = plans.alive_slots(alive_row, problem.layout.slot_owner)
    lane_alive = alive_slot[problem.nbr_idx.long()] & alive_row[:, None]  # (n+1, D)
    mask_eff = nbr_mask & lane_alive[None]
    outer = mask_eff[..., :, None] & mask_eff[..., None, :]
    gram_eff = torch.where(outer, gram, 0.0)
    return gram_eff, factor(_local_systems(gram_eff, mask_eff, problem.lam_pad))


def _robust_colored(problem, state, alive_tn, n_sweeps, engine, delivered=None):
    """Per sweep t: refactor under ``alive_tn[t]`` (one batched factor call),
    then one colored sweep with those factors (one ``color_sweep`` launch
    with the cuda engine)."""
    batched = problem.batched
    nbr_mask = problem.nbr_mask if batched else problem.nbr_mask[None]
    gram = problem.gram if batched else problem.gram[None]
    z = state.z if batched else state.z[None]
    coef = state.coef if batched else state.coef[None]
    tail = torch.ones((1,), dtype=torch.bool, device=problem.device)
    for t in range(n_sweeps):
        alive_row = problem.alive & torch.cat([alive_tn[t], tail])
        gram_eff, chol_eff = _masked_factors(problem, nbr_mask, gram, alive_row)
        z, coef = _colored_core(
            problem, nbr_mask, gram_eff, chol_eff, z, coef, 1, engine,
            alive=alive_row, delivered=None if delivered is None else delivered[t : t + 1],
        )
    if batched:
        return SNTrainState(z=z, coef=coef)
    return SNTrainState(z=z[0], coef=coef[0])


def robust_sweep(
    problem: SNTrainProblem,
    state: SNTrainState,
    alive,
    n_sweeps: int = 1,
    *,
    engine: str = "plan",
    delivered: torch.Tensor | None = None,
) -> SNTrainState:
    """SN-Train under a changing sensor liveness (paper Sec. 3.3 'Robustness').

    ``alive`` is (n,) or (n_sweeps, n) bool; sweep t runs the colored engine
    under ``alive[t] & problem.alive``: dead sensors neither update nor are
    heard from, so a down mote's messages and coefficients persist and a
    healed one resumes from its last state.  The liveness is transient (no
    event patches the cached factors), so each sweep refactors every masked
    local system in one batched call, then runs one colored sweep with
    ``engine`` ("plan", "onehot" or "cuda": one ``color_sweep`` launch per
    sweep).  Batched and single-field problems both work.  "plan" ==
    "onehot" bitwise at any liveness; at all-True liveness on an
    arrival-free problem ``robust_sweep == colored_sweep`` bitwise, engine
    by engine (the factors are the cached ones, see ``_masked_factors``).
    ``delivered``: optional (n_sweeps, n+1, D) link-delivery mask composed
    on top (all-True is the plain robust sweep bitwise); ``faults.faulty_sweep``
    runs this path when its model crashes sensors.

    PERSISTENT membership changes belong to ``streaming.add_sensor`` /
    ``remove_sensor``, which patch the factors once per event.  Link-level
    (n_sweeps, n, D) traces route to ``robust_sweep_links`` (single field,
    serial, without ``delivered``: such a trace already encodes per-lane
    loss).
    """
    alive = torch.as_tensor(alive, device=problem.device)
    if alive.ndim == 3:
        if delivered is not None:
            raise NotImplementedError(
                "delivered masks compose with SENSOR-level alive traces; "
                "legacy link-level traces already encode per-lane loss"
            )
        return robust_sweep_links(problem, state, alive, n_sweeps)
    alive = alive.to(torch.bool)
    if alive.ndim == 1:
        alive = alive[None].expand((n_sweeps,) + tuple(alive.shape))
    if tuple(alive.shape) != (n_sweeps, problem.n):
        raise ValueError(
            f"alive must be (n,), (n_sweeps={n_sweeps}, n={problem.n}) or "
            f"link-level (n_sweeps, n, D); got {tuple(alive.shape)}"
        )
    if delivered is not None and delivered.shape[0] != n_sweeps:
        raise ValueError(
            f"delivered has {delivered.shape[0]} sweeps, expected {n_sweeps}"
        )
    return _robust_colored(problem, state, alive, n_sweeps, engine, delivered)


# ---------------------------------------------------------------------------
# Single-field serial engines (paper Sec. 3.3 random orderings and link-level
# robustness, Sec. 5.2 weighted losses): plain PyTorch, one sensor at a
# time, with the serial engine's liveness and write conventions.
# ---------------------------------------------------------------------------


def _require_single_field(problem: SNTrainProblem, fn_name: str) -> None:
    if problem.batched:
        raise NotImplementedError(
            f"{fn_name} supports single-field problems only; "
            "use serial_sweep/colored_sweep for batches"
        )


def _random_core(problem: SNTrainProblem, state: SNTrainState, orders) -> SNTrainState:
    """``random_sweep`` over given visiting orders, one (n,) array or tensor
    per sweep (read on the host, one sync per sweep)."""
    orders = [o.tolist() for o in orders]
    z, coef = _serial_core(
        problem.nbr_idx, problem.nbr_mask[None], problem.gram[None], problem.chol[None],
        problem.lam_pad, problem.sentinel, state.z[None], state.coef[None], len(orders),
        problem.alive, problem.alive_z, orders=orders,
    )
    return SNTrainState(z=z[0], coef=coef[0])


def random_sweep(
    problem: SNTrainProblem,
    state: SNTrainState,
    generator: torch.Generator,
    n_sweeps: int = 1,
) -> SNTrainState:
    """ALOHA-style randomized control ordering (paper Sec. 3.3 'Parallelism').

    Each sweep visits the sensors in a fresh uniformly random permutation
    (``torch.randperm`` from ``generator``, on the problem's device).  Every
    sensor appears once per sweep, so the serial ordering's fixed point
    carries over (Lemma 3.2).  Single-field problems only.
    """
    _require_single_field(problem, "random_sweep")
    orders = [torch.randperm(problem.n, generator=generator, device=problem.device)
              for _ in range(n_sweeps)]
    return _random_core(problem, state, orders)


def _dense_serial(problem: SNTrainProblem, state: SNTrainState, n_sweeps: int, update):
    """Single-field Table-1 sweeps with a directly solved sensor step.

    ``update(z, coef_s, s, t)`` returns (coef_new, z_new, mask): the row's
    coefficients take coef_new where the row is alive, and the mask's lanes
    take z_new; the other lanes write the sentinel's own value back to it
    (read before the write).
    """
    z, coef = state.z.clone(), state.coef.clone()
    sentinel = problem.sentinel
    for t in range(n_sweeps):
        for s in range(problem.n):
            coef_new, z_new, mask = update(z, coef[s], s, t)
            coef[s] = torch.where(problem.alive[s], coef_new, coef[s])
            target = torch.where(mask, problem.nbr_idx[s].long(), sentinel)
            z.scatter_(0, target, torch.where(mask, z_new, z[sentinel]))
    return SNTrainState(z=z, coef=coef)


def _solve(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """a^{-1} rhs by LU, without the error check's host sync."""
    return torch.linalg.solve_ex(a, rhs[:, None])[0][:, 0]


def _dynamic_sensor_update(problem, z, coef_s, s, alive_s, alive_row, alive_slot):
    """P_{C_s} with the current neighborhood N_{s,t} = N_s & alive_s.

    Solves the masked system directly (no cached factor: the active set
    changes per step).  The problem's persistent liveness intersects the
    link mask, so dead sensors neither update nor are read here either.
    """
    idx = problem.nbr_idx[s].long()
    mask = problem.nbr_mask[s] & alive_s & alive_slot[idx] & alive_row[s]
    gram = torch.where(mask[:, None] & mask[None, :], problem.gram[s], 0.0)
    lam = problem.lam_pad[s]
    a = gram + torch.diag(torch.where(mask, lam, 1.0))
    coef_prev = torch.where(mask, coef_s, 0.0)
    rhs = torch.where(mask, z[idx] + lam * coef_prev, 0.0)
    coef_new = _solve(a, rhs)
    return coef_new, gram @ coef_new, mask


def robust_sweep_links(
    problem: SNTrainProblem,
    state: SNTrainState,
    link_alive,
    n_sweeps: int = 1,
) -> SNTrainState:
    """Link-level robustness: the paper's Sec. 3.3 model verbatim.

    ``link_alive`` (n_sweeps, n, D) bool: sweep t uses the neighborhoods
    N_{s,t} = N_s & link_alive[t, s] & the problem's persistent row/slot
    liveness, solved densely per sensor in the serial Table-1 ordering.
    Single-field problems only; sensor-level liveness (the common case)
    goes through ``robust_sweep``'s batched colored path.
    """
    _require_single_field(problem, "robust_sweep_links")
    link_alive = torch.as_tensor(link_alive, device=problem.device).to(torch.bool)
    if link_alive.shape[0] != n_sweeps:
        raise ValueError(f"link_alive has {link_alive.shape[0]} sweeps, expected {n_sweeps}")
    alive_row, alive_slot = problem.alive, problem.alive_z

    def update(z, coef_s, s, t):
        return _dynamic_sensor_update(
            problem, z, coef_s, s, link_alive[t, s], alive_row, alive_slot
        )

    return _dense_serial(problem, state, n_sweeps, update)


def _weighted_sensor_update(problem, z, coef_s, s, w_pad, alive_row, alive_slot):
    """The reweighted projection: (W_s K_s + lambda_s I) c = W_s z + lambda_s c_prev."""
    idx = problem.nbr_idx[s].long()
    mask = problem.nbr_mask[s] & alive_slot[idx] & alive_row[s]
    gram = torch.where(mask[:, None] & mask[None, :], problem.gram[s], 0.0)
    lam = problem.lam_pad[s]
    w_nbr = torch.where(mask, w_pad[idx], 0.0)
    a = w_nbr[:, None] * gram + torch.diag(torch.where(mask, lam, 1.0))
    rhs = torch.where(mask, w_nbr * z[idx] + lam * coef_s, 0.0)
    coef_new = _solve(a, rhs)
    return coef_new, gram @ coef_new, mask


def weighted_sweep(
    problem: SNTrainProblem,
    state: SNTrainState,
    weights,
    n_sweeps: int = 1,
) -> SNTrainState:
    """SN-Train under the reweighted norm (paper Sec. 5.2, heteroscedastic
    measurements): ``weights`` (n,) are per-sensor confidences w_j > 0.

    Unit weights reduce to ``serial_sweep``; the iterates are Fejer
    monotone in ``weighted_norm_sq_hetero``.  Liveness is threaded as in the
    serial engine.  Single-field problems only.
    """
    _require_single_field(problem, "weighted_sweep")
    dt, dev = state.z.dtype, state.z.device
    w_pad = torch.cat([torch.as_tensor(weights, dtype=dt, device=dev),
                       torch.zeros((problem.n_stream + 1,), dtype=dt, device=dev)])
    alive_row, alive_slot = problem.alive, problem.alive_z

    def update(z, coef_s, s, t):
        return _weighted_sensor_update(problem, z, coef_s, s, w_pad, alive_row, alive_slot)

    return _dense_serial(problem, state, n_sweeps, update)


def weighted_norm_sq_hetero(
    problem: SNTrainProblem, state: SNTrainState, weights
) -> torch.Tensor:
    """sum_j w_j z_j^2 + sum_i lambda_i ||f_i||^2, the Fejer invariant of
    ``weighted_sweep``."""
    w = torch.as_tensor(weights, dtype=state.z.dtype, device=state.z.device)
    z_part = torch.sum(w * state.z[..., : problem.n] ** 2, dim=-1)
    quad = torch.einsum("...sd,...sde,...se->...s", state.coef, problem.gram, state.coef)
    return z_part + torch.sum(problem.lam_pad * quad, dim=-1)


def local_only(problem: SNTrainProblem) -> SNTrainState:
    """The paper's Sec-4.3 ablation: one local fit, no Update messages.

    Refuses problems whose stream slots are occupied (their values are not
    part of ``problem.y``).
    """
    stream_used = problem.nbr_mask & (problem.nbr_idx >= problem.n)
    if bool(stream_used.any()):
        raise NotImplementedError(
            "local_only is the pre-streaming ablation; absorbed arrivals "
            "are not part of problem.y — run it before streaming.absorb"
        )
    lead = problem.y.shape[:-1]
    y_pad = torch.cat(
        [problem.y, torch.zeros(lead + (problem.n_stream + 1,),
                                dtype=problem.y.dtype, device=problem.device)],
        dim=-1,
    )
    alive_slot = problem.alive_z
    mask = (
        problem.nbr_mask
        & alive_slot[problem.nbr_idx]
        & problem.alive[:, None]
    )
    rhs = torch.where(mask, y_pad[..., problem.nbr_idx], 0.0)
    coef = torch.cholesky_solve(rhs[..., None], problem.chol, upper=False)[..., 0]
    return SNTrainState(z=y_pad, coef=coef)
