"""The colored SN-Train sweep's color steps (kernel: ``csrc/color_step.cu``).

Replaces the TPU kernel ``src/repro/kernels/color_step.py``
(``_color_step_kernel``).  What one color step computes, for every field b
and member m of one color: gather z at the member's D slots and its previous
coefficient row, form ``rhs = mask * (z_nbr + lambda * coef)``, solve
``(L L^T) coef' = rhs`` on the cached Cholesky factor, evaluate
``z' = K_s coef'``, and write both back.  Dead members do not write; lanes
whose target slot is dead or whose message was not delivered do not write
their message.  The update is IN PLACE on ``z`` and ``coef``.

``color_sweep`` runs ``n_sweeps`` x ``n_colors`` color steps in ONE launch
(one thread-block cluster per field, a cluster barrier between steps);
``color_step`` is the same kernel run for one color and one sweep.  The
launch plan (warps per CTA, CTAs per cluster, shared memory) is
``launch_plan``.  Bound on the H100: the chain of dependent color steps
(latency); see the kernel source.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import spans
from . import _build

launches = 0

_SIG = {
    "color_sweep_launch": [ctypes.c_int] + [ctypes.c_void_p] * 12
    + [ctypes.c_int] * 9 + [ctypes.c_longlong, ctypes.c_void_p],
}
_DTYPES = {torch.float32: 0, torch.float64: 1}

SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on the H100
MAX_WARPS = 16  # warps per CTA
MAX_CLUSTER = 8  # CTAs per cluster without the non-portable opt-in
MAX_D = 128  # four rows per lane


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How ``color_sweep`` lays one field's members over one cluster.

    A warp solves ``per_warp`` members side by side (two half-warps when
    D <= 16, else one); member slot p = (CTA * warps + warp) * per_warp +
    half owns members ``p + k * warps * cluster * per_warp``.  Each slot
    keeps two buffers of a member's factor and gram at row stride
    ``row_stride`` (odd, so column walks meet no bank conflict), each padded
    by 16 bytes for the kernel's aligned copies.
    """

    warps: int
    cluster: int
    per_warp: int
    row_stride: int
    smem_bytes: int


def launch_plan(itemsize: int, d: int, m: int) -> LaunchPlan:
    """The plan for members of D lanes of ``itemsize``-byte floats, M per color.

    The members spread over as many SMs as a cluster may span: warps per CTA
    ceil(M / (per_warp * MAX_CLUSTER)), at most MAX_WARPS and at most what
    fits in SMEM_LIMIT (double-buffered factor and gram per member slot);
    CTAs per cluster ceil(M / (warps * per_warp)), at most MAX_CLUSTER
    (slots then own several members).  Raises ValueError when not even one
    warp's buffers fit.
    """
    ld = d | 1
    per = 2 if d <= 16 else 1
    # two buffers of factor + gram, each D rows at stride ld with 16 bytes of
    # slack for the kernel's aligned copies, rounded to 16 bytes
    per_slot = 4 * ((d * ld * itemsize + 31) // 16 * 16)
    fit = SMEM_LIMIT // (per * per_slot)
    if not 1 <= d <= MAX_D or fit < 1:
        raise ValueError(
            f"color_sweep has no launch plan for D={d} ({itemsize}-byte floats): one "
            f"warp needs {per * per_slot} bytes of shared memory, a block has "
            f"{SMEM_LIMIT}, and D may be at most {MAX_D}"
        )
    warps = min(MAX_WARPS, fit, max(1, -(-m // (per * MAX_CLUSTER))))
    cluster = min(MAX_CLUSTER, max(1, -(-m // (per * warps))))
    return LaunchPlan(warps=warps, cluster=cluster, per_warp=per, row_stride=ld,
                      smem_bytes=warps * per * per_slot)


def color_step_ref(
    z, coef, nbr_idx, nbr_mask, gram, chol, lam_pad, alive_row, alive_z,
    members, member_mask, deliv=None,
) -> None:
    """Plain PyTorch version of the kernel (same arguments, same in-place writes)."""
    from ..core.sn_train import _color_solve

    idx_m, coef_new, z_new = _color_solve(
        nbr_idx, lam_pad, alive_row, alive_z, nbr_mask, gram, chol, z, coef,
        members, member_mask,
    )
    live = member_mask & alive_row[members]
    send = live[:, None] & alive_z[idx_m]
    if deliv is not None:
        send = send & deliv[members]
    coef[:, members[live].long()] = coef_new[:, live]
    z[:, idx_m[send].long()] = z_new[:, send]


def color_sweep_ref(
    z, coef, nbr_idx, nbr_mask, gram, chol, lam_pad, alive_row, alive_z,
    color_members, color_mask, delivered=None, n_sweeps: int = 1,
) -> None:
    """Plain PyTorch version of ``color_sweep``: ``color_step_ref`` over the
    sweeps, and within each sweep over the colors in order."""
    for t in range(n_sweeps):
        deliv = None if delivered is None else delivered[t]
        for c in range(color_members.shape[0]):
            color_step_ref(
                z, coef, nbr_idx, nbr_mask, gram, chol, lam_pad, alive_row, alive_z,
                color_members[c], color_mask[c], deliv,
            )


def color_sweep(
    z: torch.Tensor,
    coef: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_mask: torch.Tensor,
    gram: torch.Tensor,
    chol: torch.Tensor,
    lam_pad: torch.Tensor,
    alive_row: torch.Tensor,
    alive_z: torch.Tensor,
    color_members: torch.Tensor,
    color_mask: torch.Tensor,
    delivered: torch.Tensor | None = None,
    n_sweeps: int = 1,
) -> None:
    """``n_sweeps`` colored sweeps for all B fields, in place on ``z`` and ``coef``.

    z (B, NZ); coef (B, R, D); nbr_idx (R, D) int32; nbr_mask (B, R, D)
    bool; gram/chol (B, R, D, D); lam_pad (R,); alive_row (R,) bool;
    alive_z (NZ,) bool; color_members (C, M) int32 rows of each color;
    color_mask (C, M) bool; delivered (n_sweeps, R, D) bool or None (all
    delivered).  Float tensors are all float32 or all float64.  The kernel
    treats an out-of-range row or slot id as masked (it never reads or
    writes out of bounds); the plain version raises on one.
    """
    global launches
    with spans.span("kernel.color_sweep") as s:
        if z.device.type == "cpu":
            color_sweep_ref(
                z, coef, nbr_idx, nbr_mask, gram, chol, lam_pad, alive_row, alive_z,
                color_members, color_mask, delivered, n_sweeps,
            )
            s.count(steps=n_sweeps * color_members.shape[0])
            return
        req = _build.require
        req(z.device.type == "cuda", f"color_step runs on cpu or cuda, got {z.device}")
        req(z.ndim == 2 and coef.ndim == 3, "z must be (B, NZ) and coef (B, R, D)")
        b, n_z = z.shape
        _, r, d = coef.shape
        req(color_members.ndim == 2, "color_members must be (C, M)")
        n_colors, m = color_members.shape
        req(coef.shape[0] == b, "coef and z disagree on B")
        req(1 <= b <= 65535, f"color_sweep takes 1 <= B <= 65535 fields, got {b}")
        req(tuple(nbr_idx.shape) == (r, d), "nbr_idx must be (R, D)")
        req(tuple(nbr_mask.shape) == (b, r, d), "nbr_mask must be (B, R, D)")
        req(tuple(gram.shape) == (b, r, d, d), "gram must be (B, R, D, D)")
        req(tuple(chol.shape) == (b, r, d, d), "chol must be (B, R, D, D)")
        req(tuple(lam_pad.shape) == (r,) and tuple(alive_row.shape) == (r,),
            "lam_pad and alive_row must be (R,)")
        req(tuple(alive_z.shape) == (n_z,), "alive_z must be (NZ,)")
        req(tuple(color_mask.shape) == (n_colors, m), "color_mask must be (C, M)")
        req(n_sweeps >= 0, f"n_sweeps must be >= 0, got {n_sweeps}")
        req(delivered is None or tuple(delivered.shape) == (n_sweeps, r, d),
            "delivered must be (n_sweeps, R, D)")
        req(z.dtype in _DTYPES, f"color_step takes float32 or float64, got {z.dtype}")
        for key, t in dict(coef=coef, gram=gram, chol=chol, lam_pad=lam_pad).items():
            req(t.dtype == z.dtype, f"{key} is {t.dtype}, expected {z.dtype}")
        req(nbr_idx.dtype == torch.int32 and color_members.dtype == torch.int32,
            "nbr_idx and color_members must be int32")
        for key, t in dict(nbr_mask=nbr_mask, alive_row=alive_row, alive_z=alive_z,
                           color_mask=color_mask, delivered=delivered).items():
            req(t is None or t.dtype == torch.bool, f"{key} must be bool")
        _build.require_cuda_inputs(z.device, dict(
            z=z, coef=coef, nbr_idx=nbr_idx, nbr_mask=nbr_mask, gram=gram, chol=chol,
            lam_pad=lam_pad, alive_row=alive_row, alive_z=alive_z, color_members=color_members,
            color_mask=color_mask, delivered=delivered,
        ))
        if n_sweeps == 0 or n_colors == 0 or m == 0 or d == 0:
            s.count(steps=0)
            return  # no color step has work to do
        plan = launch_plan(z.element_size(), d, m)
        lib = _build.library("color_step", _SIG)
        p = _build.ptr
        err = lib.color_sweep_launch(
            _DTYPES[z.dtype], p(z), p(coef), p(nbr_idx), p(nbr_mask), p(gram),
            p(chol), p(lam_pad), p(alive_row), p(alive_z), p(color_members),
            p(color_mask), p(delivered), b, n_z, r, d, m, n_colors, n_sweeps,
            plan.warps, plan.cluster, plan.smem_bytes, _build.stream(z.device),
        )
        _build.check(err, lib, "color_step")
        launches += 1
        s.count(steps=n_sweeps * n_colors)


def color_step(
    z: torch.Tensor,
    coef: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_mask: torch.Tensor,
    gram: torch.Tensor,
    chol: torch.Tensor,
    lam_pad: torch.Tensor,
    alive_row: torch.Tensor,
    alive_z: torch.Tensor,
    members: torch.Tensor,
    member_mask: torch.Tensor,
    deliv: torch.Tensor | None = None,
) -> None:
    """One color step for all B fields, in place on ``z`` and ``coef``.

    members (M,) int32 rows of this color; member_mask (M,) bool; deliv
    (R, D) bool or None (all delivered); the rest as in ``color_sweep``,
    whose kernel runs it as one color of one sweep.
    """
    if z.device.type == "cpu":
        color_step_ref(
            z, coef, nbr_idx, nbr_mask, gram, chol, lam_pad, alive_row,
            alive_z, members, member_mask, deliv,
        )
        return
    _build.require(members.ndim == 1 and member_mask.ndim == 1,
                   "members and member_mask must be (M,)")
    color_sweep(
        z, coef, nbr_idx, nbr_mask, gram, chol, lam_pad, alive_row, alive_z,
        members[None], member_mask[None], None if deliv is None else deliv[None],
    )
