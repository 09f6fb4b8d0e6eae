"""One color step of the colored SN-Train sweep (kernel: ``csrc/color_step.cu``).

Replaces the TPU kernel ``src/repro/kernels/color_step.py``
(``_color_step_kernel``).  What it computes, for every field b and member m
of one color: gather z at the member's D slots and its previous
coefficient row, form ``rhs = mask * (z_nbr + lambda * coef)``, solve
``(L L^T) coef' = rhs`` on the cached Cholesky factor, evaluate
``z' = K_s coef'``, and write both back.  Dead members do not write; lanes
whose target slot is dead or whose message was not delivered do not write
their message.  The update is IN PLACE on ``z`` and ``coef``.

Bound on the H100: bytes (each lane reads two D x D factors for ~4 D^2
flops) and, at the benched sizes, launch latency; see the kernel source.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

_SIG = {
    "color_step_launch": [ctypes.c_int] + [ctypes.c_void_p] * 12
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}
_DTYPES = {torch.float32: 0, torch.float64: 1}


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

    z (B, NZ); coef (B, R, D); nbr_idx (R, D) int32; nbr_mask (B, R, D)
    bool; gram/chol (B, R, D, D); lam_pad (R,); alive_row (R,) bool;
    alive_z (NZ,) bool; members (M,) int32 rows of this color;
    member_mask (M,) bool; deliv (R, D) bool or None (all delivered).
    Float tensors are all float32 or all float64.  The kernel treats an
    out-of-range row or slot id as masked (it never reads or writes out of
    bounds); the plain version raises on one.
    """
    global launches
    if z.device.type == "cpu":
        color_step_ref(
            z, coef, nbr_idx, nbr_mask, gram, chol, lam_pad, alive_row,
            alive_z, members, member_mask, deliv,
        )
        return
    req = _build.require
    req(z.device.type == "cuda", f"color_step runs on cpu or cuda, got {z.device}")
    req(z.ndim == 2 and coef.ndim == 3, "z must be (B, NZ) and coef (B, R, D)")
    b, n_z = z.shape
    _, r, d = coef.shape
    m = members.shape[0]
    req(coef.shape[0] == b, "coef and z disagree on B")
    req(tuple(nbr_idx.shape) == (r, d), "nbr_idx must be (R, D)")
    req(tuple(nbr_mask.shape) == (b, r, d), "nbr_mask must be (B, R, D)")
    req(tuple(gram.shape) == (b, r, d, d), "gram must be (B, R, D, D)")
    req(tuple(chol.shape) == (b, r, d, d), "chol must be (B, R, D, D)")
    req(tuple(lam_pad.shape) == (r,) and tuple(alive_row.shape) == (r,),
        "lam_pad and alive_row must be (R,)")
    req(tuple(alive_z.shape) == (n_z,), "alive_z must be (NZ,)")
    req(members.ndim == 1 and tuple(member_mask.shape) == (m,),
        "members and member_mask must be (M,)")
    req(deliv is None or tuple(deliv.shape) == (r, d), "deliv must be (R, D)")
    req(z.dtype in _DTYPES, f"color_step takes float32 or float64, got {z.dtype}")
    for key, t in dict(coef=coef, gram=gram, chol=chol, lam_pad=lam_pad).items():
        req(t.dtype == z.dtype, f"{key} is {t.dtype}, expected {z.dtype}")
    req(nbr_idx.dtype == torch.int32 and members.dtype == torch.int32,
        "nbr_idx and members must be int32")
    for key, t in dict(nbr_mask=nbr_mask, alive_row=alive_row, alive_z=alive_z,
                       member_mask=member_mask, deliv=deliv).items():
        req(t is None or t.dtype == torch.bool, f"{key} must be bool")
    _build.require_cuda_inputs(z.device, dict(
        z=z, coef=coef, nbr_idx=nbr_idx, nbr_mask=nbr_mask, gram=gram, chol=chol,
        lam_pad=lam_pad, alive_row=alive_row, alive_z=alive_z, members=members,
        member_mask=member_mask, deliv=deliv,
    ))
    lib = _build.library("color_step", _SIG)
    p = _build.ptr
    err = lib.color_step_launch(
        _DTYPES[z.dtype], p(z), p(coef), p(nbr_idx), p(nbr_mask), p(gram),
        p(chol), p(lam_pad), p(alive_row), p(alive_z), p(members),
        p(member_mask), p(deliv), b, n_z, r, d, m, _build.stream(z.device),
    )
    _build.check(err, lib, "color_step")
    launches += 1
