"""Streaming measurement absorption for batched SN-Train problems.

Port of ``repro.core.streaming``, part 1: ``absorb``, ``absorb_many``,
``absorb_wave``, ``evict_oldest``, exponential forgetting (``beta < 1``),
``pad_arrivals``, ``capacity_left`` and ``rebuild_chol``.  The network
lifecycle (sensor join/leave) is not ported yet.

An arrival ``(field b, sensor s, location x, value y)`` becomes one more
data point owned by sensor s: it occupies the next free padded lane ``k``
of N_s (build the topology with ``d_max`` headroom for capacity), whose
FIXED reserved message slot ``nbr_idx[s, k]`` was assigned at problem
build.  The local system of s grows by one row/column, and its Cholesky
factor by one row (the rank-1 "grow" update):

    w = L_s^{-1} a,    d = sqrt(K(x,x) + lambda_s - w^T w)

Because the padded lanes of ``chol`` are identity rows and arrivals fill
lanes left to right, the full-shape masked triangular solve IS the textbook
update; after any number of absorptions ``problem.chol`` equals
``rebuild_chol(problem)`` to float precision.

Over capacity, an arrival at a FULL sensor is dropped (``on_full="drop"``)
or the sensor's oldest arrival is evicted first (``"evict"``): the later
arrivals shift down one lane, keeping left-to-right == chronological, and
the sensor's factor is rebuilt from its (D, D) Gram.

Forgetting (EW-RLS): each absorb at (field, sensor) multiplies the
sensor's occupied stream lanes' anchor weights by sqrt(beta), rescales the
Gram rows/columns and message slots to match, and patches the factor by
scale-then-update (a sqrt(beta) row scale, then one rank-1 update per
ticked lane restoring the undecayed lambda, ``_chol_diag_update``).  With
``beta = 1`` every tick multiplies by exactly 1.0 and the restore is not
applied, so the static path is bitwise the same as no forgetting.

How the port computes it:

- Every operation works on L (field, sensor) ROWS at once, through the
  same two row functions: ``_evict_rows`` and ``_absorb_rows``.  ``absorb``
  and ``evict_oldest`` pass one row, ``absorb_wave`` every (field, row)
  pair, ``absorb_many`` one row per arrival in order.  Kernel values come
  from ``Kernel.pairs`` (elementwise), so a wave writes the same Gram bits
  as the absorbs it equals; only the factors (batched triangular solves and
  Cholesky) may differ by rounding.
- ``donate=True`` updates the given problem's and state's tensors in
  place and returns objects holding the same tensors (the caller rebinds);
  ``donate=False`` copies the touched tensors first and leaves the inputs
  bitwise untouched.
- No host sync per arrival: every write is gated with ``torch.where`` on
  the row's ``ok`` flag and the flags come back as tensors.  The one host
  read is per call: whether any field has ``beta < 1``.  If none has, the
  D x D steps of the lambda restore are skipped (the reference computes and
  discards them then, so the result is bitwise the same).
- Writes with repeated indices: every gather precedes the writes, and a
  repeated target only ever receives its current value (structural lanes
  shared between rows, the z sentinel), so no write order can change a
  result.  Rows that must not write send their lanes to z's sentinel or to
  a scratch row past ``stream_pos``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .sn_train import SNTrainProblem, SNTrainState

_TABLES = ("nbr_pos", "nbr_mask", "gram", "chol", "stream_pos", "anchor_w")


class AbsorbReceipt(NamedTuple):
    """Per-arrival outcome flags (bool tensors of one shape).

    ``absorbed``: the arrival was written (possibly after an eviction);
    ``evicted``: the ``on_full="evict"`` policy freed the sensor's oldest
    arrival first.  ``~absorbed`` arrivals were dropped (sensor full under
    the drop policy, zero-capacity window sensor, or dead sensor).
    """

    absorbed: torch.Tensor
    evicted: torch.Tensor

    def to_json(self) -> dict:
        """Plain-JSON receipt (schema-tagged; syncs at the call site)."""
        return {
            "schema": "absorb_receipt/1",
            "absorbed": self.absorbed.cpu().numpy().astype(bool).tolist(),
            "evicted": self.evicted.cpu().numpy().astype(bool).tolist(),
        }


def _check(problem: SNTrainProblem, on_full: str = "drop") -> None:
    if not problem.batched:
        raise ValueError("streaming requires a batched problem (use B = 1)")
    if problem.n_stream == 0:
        raise ValueError(
            "problem has no streaming capacity — build the topology with "
            "d_max headroom (build_topology(pos, r, d_max=max_degree + k))"
        )
    if on_full not in ("drop", "evict"):
        raise ValueError(f"on_full must be 'drop' or 'evict', got {on_full!r}")


def _writable(problem, state, donate: bool):
    """The problem and state the row functions may write in place."""
    if donate:
        return problem, state
    problem = dataclasses.replace(
        problem, **{name: getattr(problem, name).clone() for name in _TABLES}
    )
    return problem, SNTrainState(z=state.z.clone(), coef=state.coef.clone())


def _forgets(problem: SNTrainProblem) -> bool:
    """Whether any field decays (the call's one host read)."""
    return bool((problem.beta < 1.0).any())


def _rows(t: torch.Tensor, problem: SNTrainProblem) -> torch.Tensor:
    """A per-sensor (n, ...) topology table padded with zeros to the n + 1 rows."""
    pad = t.new_zeros((problem.n + 1 - t.shape[0],) + tuple(t.shape[1:]))
    return torch.cat([t, pad])


def _with_scratch_row(stream_pos: torch.Tensor) -> torch.Tensor:
    """A (B, S + 1, d) copy of ``stream_pos`` whose last row takes the writes
    of lanes that must not land; copy ``[:, :S]`` back afterwards."""
    b, _, d = stream_pos.shape
    return torch.cat([stream_pos, stream_pos.new_zeros((b, 1, d))], dim=1)


def _ints(a, problem: SNTrainProblem) -> torch.Tensor:
    return torch.as_tensor(a, device=problem.device).long().reshape(-1)


def capacity_left(problem: SNTrainProblem) -> torch.Tensor:
    """(B, n) free ABSORBABLE neighborhood lanes per (field, sensor).

    Free lanes retired to the sentinel id back no message slot and do not
    count.
    """
    if not problem.batched:
        raise ValueError("streaming requires a batched problem (use B = 1)")
    absorbable = problem.nbr_idx[:-1] != problem.sentinel  # (n, D)
    return torch.sum(~problem.nbr_mask[:, :-1, :] & absorbable[None], dim=-1)


def _chol_diag_update(chol: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """chol(L L^T + diag(alpha^2)) by one classic rank-1 update per lane.

    ``chol`` (..., D, D), ``alpha`` (..., D) with zeros on untouched lanes.
    The "update" half of the forgetting tick's scale-then-update: it
    restores the undecayed regularizer on the ticked lanes.  A zero entry is
    neutral only in exact arithmetic (sqrt(l*l) costs an ulp), so callers
    apply it only to fields with beta < 1.  D lanes x D rows of batched
    steps over every leading dim.
    """
    d = chol.shape[-1]
    ar = torch.arange(d, device=chol.device)
    L = chol.clone()
    for j in range(d):
        x = torch.where(ar == j, alpha[..., j : j + 1], 0.0)
        for i in range(d):
            lii = L[..., i, i]
            xi = x[..., i]
            r = torch.sqrt(lii * lii + xi * xi)
            c = (r / lii)[..., None]
            s = (xi / lii)[..., None]
            below = ar > i
            col = L[..., :, i]
            new_col = torch.where(below, (col + s * x) / c, col)
            new_col[..., i] = r
            x = torch.where(below, c * x - s * new_col, x)
            L[..., :, i] = new_col
    return L


def _chol(a: torch.Tensor) -> torch.Tensor:
    """Row-major lower Cholesky factors, with no sync on failure (the
    reference returns NaN there; CUDA's factors come back column-major)."""
    return torch.linalg.cholesky_ex(a, check_errors=False).L.contiguous()


def _evict_rows(problem, state, f, s, gate) -> torch.Tensor:
    """Free the OLDEST arrival of each row (f[i], s[i]) where ``gate``, in place.

    The later arrivals shift down one lane (left-to-right fill survives),
    the Gram is permuted with them and the freed lane zeroed, anchor
    weights ride along (the freed lane resets to 1), and the factor is
    rebuilt from the row's Gram over the effective lanes.  Messages,
    coefficients and stream positions ride their slots.  Returns (L,) bool.
    """
    n, s_cap = problem.n, problem.n_stream
    ar = torch.arange(problem.nbr_idx.shape[-1], device=problem.device)
    ids = problem.nbr_idx[s].long()  # (L, D)
    deg = _rows(problem.topology.degrees, problem)[s].long()  # structural |N_s|
    above = ar >= deg[:, None]  # lanes past the structure
    mask = problem.nbr_mask[f, s]
    occ = mask & above  # occupied stream lanes (contiguous from deg)
    ok = occ.any(-1) & gate & problem.alive[s]
    last = deg + occ.sum(-1) - 1  # last occupied stream lane (when ok)
    perm = torch.where(above & (ar < last[:, None]), ar + 1, ar)
    freed = ar == last[:, None]
    keep = ~freed
    shift = ok[:, None] & above & (ids != problem.sentinel)

    def permuted(t):  # t (L, D, ...) with lanes reordered by perm
        p = perm.reshape(perm.shape + (1,) * (t.ndim - 2)).expand_as(t)
        return torch.gather(t, 1, p)

    # every gather first, then the writes
    pos = problem.nbr_pos[f, s]  # (L, D, d)
    gram = problem.gram[f, s]
    chol = problem.chol[f, s]
    aw = problem.anchor_w[f, s]
    z_rows = state.z[f[:, None], ids]  # (L, D)
    coef = state.coef[f, s]
    spv = _with_scratch_row(problem.stream_pos)
    slot = torch.clamp(ids - n, 0, s_cap)  # stream slot of a lane above deg
    cur_sp = spv[f[:, None], torch.where(above, slot, s_cap)]  # (L, D, d)

    own = _rows(problem.topology.positions, problem)[s].to(pos.dtype)  # (L, d)
    new_pos = torch.where(freed[..., None], own[:, None, :], permuted(pos))
    new_mask = keep & permuted(mask)
    g2 = torch.gather(permuted(gram), 2, perm[:, None, :].expand_as(gram))
    g2 = torch.where(keep[:, :, None] & keep[:, None, :], g2, 0.0)
    aw2 = torch.where(freed, 1.0, permuted(aw))
    lane_alive = problem.alive_z[ids]
    diag = torch.where(new_mask & lane_alive, problem.lam_pad[s][:, None], 1.0)
    new_chol = _chol(g2 + torch.diag_embed(diag))

    okd = ok[:, None]
    problem.nbr_pos[f, s] = torch.where(okd[..., None], new_pos, pos)
    problem.nbr_mask[f, s] = torch.where(okd, new_mask, mask)
    problem.gram[f, s] = torch.where(okd[..., None], g2, gram)
    problem.chol[f, s] = torch.where(okd[..., None], new_chol, chol)
    problem.anchor_w[f, s] = torch.where(okd, aw2, aw)
    z_new = torch.where(freed, 0.0, permuted(z_rows))
    state.z[f[:, None].expand_as(ids), ids] = torch.where(shift, z_new, z_rows)
    coef_new = torch.where(freed, 0.0, permuted(coef))
    state.coef[f, s] = torch.where(ok[:, None] & above, coef_new, coef)
    sp_new = torch.where(freed[..., None], 0.0, permuted(cur_sp))
    spv[f[:, None].expand_as(ids), torch.where(shift, slot, s_cap)] = sp_new
    problem.stream_pos.copy_(spv[:, :s_cap])
    return ok


def _absorb_rows(problem, state, f, s, x, y, amask, forget: bool) -> torch.Tensor:
    """Absorb arrival (x[i], y[i]) at row (f[i], s[i]) where ``amask``, in place.

    The forgetting tick of the row's occupied stream lanes, then the
    weighted grow-one update into its first free lane.  A row with no free
    absorbable lane, or a dead sensor, is left untouched (the arrival is
    dropped).  The rows must be distinct.  Returns (L,) bool ``absorbed``.
    """
    n = problem.n
    ar = torch.arange(problem.nbr_idx.shape[-1], device=problem.device)
    ids = problem.nbr_idx[s].long()  # (L, D)
    absorbable = ids != problem.sentinel
    mask = problem.nbr_mask[f, s]
    free = ~mask & absorbable
    ok = free.any(-1) & problem.alive[s] & amask
    k = torch.argmax(free.to(torch.uint8), dim=-1)  # first free lane
    zid = torch.gather(ids, 1, k[:, None])[:, 0]  # its reserved message slot
    at_k = ar == k[:, None]
    pos = problem.nbr_pos[f, s]  # (L, D, d)
    gram = problem.gram[f, s]
    chol = problem.chol[f, s]
    aw = problem.anchor_w[f, s]
    z_rows = state.z[f[:, None], ids]  # (L, D)
    lam = problem.lam_pad[s]

    # forgetting tick: the occupied stream lanes age one sqrt(beta) step
    gdt = gram.dtype
    beta = problem.beta[f].to(gdt)
    is_stream = mask & (ids >= n) & absorbable
    root = torch.sqrt(beta)[:, None]
    s_vec = torch.where(is_stream, root, 1.0)  # (L, D)
    aw_s = aw * s_vec.to(aw.dtype)
    gram_s = gram * (s_vec[:, :, None] * s_vec[:, None, :])
    chol_s = chol * s_vec[:, :, None].to(chol.dtype)
    if forget:
        alpha = torch.where(is_stream, torch.sqrt((1.0 - beta) * lam.to(gdt))[:, None], 0.0)
        chol_s = torch.where((beta < 1.0)[:, None, None], _chol_diag_update(chol_s, alpha),
                             chol_s)

    # the weighted kernel row over the effective (occupied & alive) lanes;
    # the fresh arrival enters at weight 1
    mask_eff = mask & problem.alive_z[ids]
    kv = problem.kernel.pairs(x[:, None, :], pos)  # (L, D)
    kvec = torch.where(mask_eff, kv * aw_s.to(kv.dtype), 0.0)
    kself = problem.kernel.pairs(x, x)  # (L,)
    new_row = torch.where(at_k, kself[:, None], kvec)
    gram_s = torch.where(at_k[:, :, None], new_row[:, None, :], gram_s)
    gram_s = torch.where(at_k[:, None, :], new_row[:, :, None], gram_s)

    # grow-one Cholesky: lanes >= k are identity rows, so the full-shape
    # solve returns w on the valid prefix; only row k of the factor changes
    w = torch.linalg.solve_triangular(chol_s, kvec[..., None], upper=False)[..., 0]
    d_new = torch.sqrt(torch.clamp(kself + lam - torch.sum(w * w, dim=-1), min=1e-12))
    chol_row = torch.where(at_k, d_new[:, None], w)
    chol_s = torch.where(at_k[:, :, None], chol_row[:, None, :], chol_s)

    okd = ok[:, None]
    put = okd & at_k
    problem.nbr_pos[f, s] = torch.where(put[..., None], x[:, None, :], pos)
    problem.nbr_mask[f, s] = mask | put
    problem.gram[f, s] = torch.where(okd[..., None], gram_s, gram)
    problem.chol[f, s] = torch.where(okd[..., None], chol_s, chol)
    problem.anchor_w[f, s] = torch.where(okd, torch.where(at_k, 1.0, aw_s), aw)
    s_cap = problem.n_stream
    spv = _with_scratch_row(problem.stream_pos)
    spv[f, torch.where(ok, zid - n, s_cap)] = x.to(spv.dtype)  # not-ok rows: scratch row
    problem.stream_pos.copy_(spv[:, :s_cap])

    # the ticked lanes' message slots decay with their anchors, then the
    # arrival seeds its own slot (Table-1 init z_0 = y); its coefficient
    # starts at 0
    z_scale = torch.where(is_stream & okd, root, 1.0).to(z_rows.dtype)
    state.z[f[:, None].expand_as(ids), ids] = z_rows * z_scale
    z_idx = torch.where(ok, zid, problem.sentinel)  # not-ok rows hit the sentinel
    state.z[f, z_idx] = torch.where(ok, y, state.z[f, z_idx])
    return ok


def _full(problem, f, s) -> torch.Tensor:
    """(L,) whether each row has no free absorbable lane."""
    return torch.all(problem.nbr_mask[f, s] | (problem.nbr_idx[s] == problem.sentinel), dim=-1)


def _absorb_one(problem, state, f, s, x, y, evict: bool, forget: bool):
    """One arrival at row (f, s) (each (1,)), in place; returns (absorbed, evicted)."""
    yes = torch.ones((1,), dtype=torch.bool, device=problem.device)
    if evict:
        ev = _evict_rows(problem, state, f, s, _full(problem, f, s))
    else:
        ev = ~yes
    ok = _absorb_rows(problem, state, f, s, x, y, yes, forget)
    return ok, ev


def absorb(
    problem: SNTrainProblem,
    state: SNTrainState,
    field,
    sensor,
    x,
    y,
    *,
    donate: bool = False,
    on_full: str = "drop",
) -> tuple[SNTrainProblem, SNTrainState, torch.Tensor]:
    """Absorb one measurement (x, y) arriving at ``sensor`` of ``field``.

    Returns ``(problem, state, absorbed)``; ``absorbed`` is a 0-d bool
    tensor (read it when the caller wants to sync).  An arrival at a sensor
    with no free lane is DROPPED without touching anything; callers that
    must not lose data check ``capacity_left`` first.  ``field`` and
    ``sensor`` may be ints or tensors on the problem's device.

    on_full="evict" frees the sensor's OLDEST arrival first whenever the
    sensor is full, so its stream lanes act as a sliding window over the
    most recent measurements (a sensor built with zero headroom still drops).

    donate=True updates the problem's and state's tensors in place; the
    caller must rebind and not use the old objects' values afterwards.
    """
    _check(problem, on_full)
    problem, state = _writable(problem, state, donate)
    f, s = _ints(field, problem), _ints(sensor, problem)
    x = torch.as_tensor(x, dtype=problem.nbr_pos.dtype, device=problem.device).reshape(1, -1)
    y = torch.as_tensor(y, dtype=state.z.dtype, device=problem.device).reshape(1)
    ok, _ = _absorb_one(problem, state, f, s, x, y, on_full == "evict", _forgets(problem))
    return problem, state, ok[0]


def absorb_many(
    problem: SNTrainProblem,
    state: SNTrainState,
    fields,
    sensors,
    xs,
    ys,
    *,
    donate: bool = False,
    on_full: str = "drop",
) -> tuple[SNTrainProblem, SNTrainState, AbsorbReceipt]:
    """Absorb a window of A arrivals in order (the reference's ``lax.scan``).

    ``fields``/``sensors`` are (A,) ints, ``xs`` (A, d), ``ys`` (A,).  Each
    arrival runs exactly ``absorb``'s update under the same ``on_full``
    policy, so the result equals A sequential ``absorb`` calls bitwise, with
    one host read for the whole window instead of one per arrival.  Returns
    an ``AbsorbReceipt`` of (A,) ``absorbed``/``evicted`` flags.  ``donate``
    has ``absorb``'s contract.
    """
    _check(problem, on_full)
    fields, sensors = _ints(fields, problem), _ints(sensors, problem)
    xs = torch.as_tensor(xs, dtype=problem.nbr_pos.dtype, device=problem.device)
    ys = torch.as_tensor(ys, dtype=state.z.dtype, device=problem.device)
    a = fields.shape[0]
    if xs.ndim != 2 or xs.shape[0] != a:
        raise ValueError(f"xs must be (A={a}, d), got {tuple(xs.shape)}")
    if sensors.shape != (a,) or ys.shape != (a,):
        raise ValueError(
            f"fields/sensors/ys must share length A={a}, got "
            f"{tuple(sensors.shape)} / {tuple(ys.shape)}"
        )
    problem, state = _writable(problem, state, donate)
    forget, evict = _forgets(problem), on_full == "evict"
    oks, evs = [], []
    for i in range(a):
        ok, ev = _absorb_one(problem, state, fields[i : i + 1], sensors[i : i + 1],
                             xs[i : i + 1], ys[i : i + 1], evict, forget)
        oks.append(ok)
        evs.append(ev)
    none = torch.zeros((0,), dtype=torch.bool, device=problem.device)
    receipt = AbsorbReceipt(absorbed=torch.cat(oks) if oks else none,
                            evicted=torch.cat(evs) if evs else none)
    return problem, state, receipt


def pad_arrivals(problem: SNTrainProblem, fields, sensors, xs, ys, a_pad: int):
    """Pad an arrival window to ``a_pad`` rows with guaranteed no-ops.

    A serving process can pad each window to its power-of-two bucket
    (``kernels.ops.bucket_rows``) so that window shapes take O(log A)
    values.  The padding arrivals target the SENTINEL row (``sensor ==
    problem.n``), which is permanently dead, so they are bitwise no-ops
    under both ``on_full`` policies and come back ``absorbed=False``.
    Returns ``(fields, sensors, xs, ys, real)`` as tensors on the problem's
    device; ``real`` is the (a_pad,) bool mask of genuine arrivals.
    """
    dev = problem.device
    fields = torch.as_tensor(fields, device=dev).to(torch.int32).reshape(-1)
    sensors = torch.as_tensor(sensors, device=dev).to(torch.int32).reshape(-1)
    xs = torch.as_tensor(xs, dtype=problem.nbr_pos.dtype, device=dev)
    xs = xs if xs.ndim >= 2 else xs.reshape(1, -1)
    ys = torch.as_tensor(ys, device=dev)
    a = int(fields.shape[0])
    if a > a_pad:
        raise ValueError(f"window of {a} arrivals exceeds a_pad={a_pad}")
    pad = a_pad - a
    real = torch.arange(a_pad, device=dev) < a
    if pad == 0:
        return fields, sensors, xs, ys, real
    return (
        torch.cat([fields, fields.new_zeros((pad,))]),
        torch.cat([sensors, sensors.new_full((pad,), problem.n)]),
        torch.cat([xs, xs.new_zeros((pad, xs.shape[1]))]),
        torch.cat([ys, ys.new_zeros((pad,))]),
        real,
    )


def absorb_wave(
    problem: SNTrainProblem,
    state: SNTrainState,
    xs,
    ys,
    *,
    mask=None,
    donate: bool = False,
    on_full: str = "drop",
) -> tuple[SNTrainProblem, SNTrainState, AbsorbReceipt]:
    """Absorb up to ONE arrival per (field, sensor) as one batched update.

    ``xs`` is (B, n, d), ``ys`` (B, n), ``mask`` an optional (B, n) bool
    selecting the pairs that have an arrival (default: all).  Each pair's
    update touches only its own row and its own reserved slots, so the wave
    equals absorbing the masked arrivals one ``absorb(..., on_full=...)`` at
    a time in any order: bitwise, except the factors, where the batched
    solves may differ by rounding.  Returns an ``AbsorbReceipt`` of (B, n)
    flags.  Every (field, row) pair is updated at once, so the cost is a few
    hundred batched steps, not B * n sequential arrivals.
    """
    _check(problem, on_full)
    n, b = problem.n, problem.batch_size
    r = n + 1
    dev = problem.device
    xs = torch.as_tensor(xs, dtype=problem.nbr_pos.dtype, device=dev)
    ys = torch.as_tensor(ys, dtype=state.z.dtype, device=dev)
    if tuple(xs.shape[:2]) != (b, n) or tuple(ys.shape) != (b, n):
        raise ValueError(
            f"xs must be (B={b}, n={n}, d) and ys (B, n), got "
            f"{tuple(xs.shape)} / {tuple(ys.shape)}"
        )
    amask = (torch.ones((b, n), dtype=torch.bool, device=dev) if mask is None
             else torch.as_tensor(mask, device=dev).to(torch.bool))
    problem, state = _writable(problem, state, donate)
    # the arrival operands extended to the n + 1 rows (sentinel row inert)
    x = torch.cat([xs, xs.new_zeros((b, 1, xs.shape[-1]))], dim=1).reshape(b * r, -1)
    y = torch.cat([ys, ys.new_zeros((b, 1))], dim=1).reshape(-1)
    am = torch.cat([amask, amask.new_zeros((b, 1))], dim=1).reshape(-1)
    f = torch.arange(b, device=dev).repeat_interleave(r)
    s = torch.arange(r, device=dev).repeat(b)
    if on_full == "evict":
        ev = _evict_rows(problem, state, f, s, _full(problem, f, s) & am)
    else:
        ev = torch.zeros_like(am)
    ok = _absorb_rows(problem, state, f, s, x, y, am, _forgets(problem))
    receipt = AbsorbReceipt(absorbed=ok.reshape(b, r)[:, :n], evicted=ev.reshape(b, r)[:, :n])
    return problem, state, receipt


def evict_oldest(
    problem: SNTrainProblem,
    state: SNTrainState,
    field,
    sensor,
    *,
    donate: bool = False,
) -> tuple[SNTrainProblem, SNTrainState, torch.Tensor]:
    """Free the OLDEST occupied reserved lane of ``sensor`` in ``field``.

    Returns ``(problem, state, evicted)``; ``evicted`` (0-d bool) is False
    and the call a no-op when the sensor holds no absorbed arrival.  The
    remaining arrivals shift down one lane, the sensor's Gram is permuted
    accordingly and its factor rebuilt (O(D^3) for the one sensor).  An
    ``absorb`` at the same sensor then reuses the freed lane: the round
    trip equals building the window's problem from scratch.  ``donate`` has
    ``absorb``'s contract.
    """
    _check(problem)
    problem, state = _writable(problem, state, donate)
    f, s = _ints(field, problem), _ints(sensor, problem)
    gate = torch.ones((1,), dtype=torch.bool, device=problem.device)
    ok = _evict_rows(problem, state, f, s, gate)
    return problem, state, ok[0]


def rebuild_chol(problem: SNTrainProblem) -> torch.Tensor:
    """From-scratch Cholesky of every local system, the O(D^3) reference the
    streaming updates are held to.  Factors over the effective lanes
    (occupied & alive); padded and dead lanes get a unit diagonal."""
    live = problem.alive_z[problem.nbr_idx.long()] & problem.alive[:, None]
    diag = torch.where(problem.nbr_mask & live, problem.lam_pad[:, None], 1.0)
    return _chol(problem.gram + torch.diag_embed(diag))
