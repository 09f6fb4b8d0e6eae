"""Streaming measurement absorption for batched SN-Train problems.

Port of ``repro.core.streaming``: ``absorb``, ``absorb_many``,
``absorb_wave``, ``evict_oldest``, exponential forgetting (``beta < 1``),
``pad_arrivals``, ``capacity_left``, ``rebuild_chol``, and the network
lifecycle: ``add_sensor`` (a symmetric join) and ``remove_sensor`` (a
leave), with their ``JoinReceipt``.

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
- The lifecycle events work the same way on the O(degree) rows they
  affect (the adopters of a join, the neighbors of a leave; padded with
  the sentinel row n): ``_insert_rows`` grows each adopter's reciprocal
  anchor lane at its stream boundary, ``_delete_rows`` deletes each
  neighbor's lane for the victim and restores a reserved id, and both
  refactor only those rows (``_refactor_rows``).  Indices the reference
  lets JAX clamp or drop (the sentinel row past ``topology.degrees``, the
  sentinel's out-of-range color) are clamped here, with a gated no-op
  write, so no table depends on an out-of-range index.  A dropped join
  (no free spare, or the recolor pool exhausted) writes only values it
  read: a bitwise no-op.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import plans
from .sn_train import SNTrainProblem, SNTrainState, factor

_TABLES = ("nbr_pos", "nbr_mask", "gram", "chol", "stream_pos", "anchor_w")
# what a join or a leave writes, beyond _TABLES
_EVENT_TABLES = ("y", "nbr_idx", "lam_pad", "plan_z", "plan_coef", "color_members",
                 "color_mask", "color_of", "member_pos", "alive")


class JoinReceipt(NamedTuple):
    """Outcome of one symmetric join (``add_sensor``), all tensors.

    ``joined``: () bool; False means the join was a bitwise no-op (no
    spare row, or the recolor pool was exhausted).  ``slot``: () int64, the
    claimed row (meaningful when ``joined``).  ``adopted``/``adopted_mask``:
    (A,) the neighbor rows that adopted a reciprocal anchor lane (padded
    with ``n``).  ``skipped``/``skipped_mask``: (A,) live in-radius
    neighbors NOT adopted because their rows had no free lane (each a
    coupling lost against a from-scratch build; see
    ``plans.degree_headroom``).  ``dropped_newest``: (B, A) bool, the
    (field, adopter) pairs whose row was full, so the anchor lane displaced
    the newest absorbed arrival.
    """

    joined: torch.Tensor
    slot: torch.Tensor
    adopted: torch.Tensor
    adopted_mask: torch.Tensor
    skipped: torch.Tensor
    skipped_mask: torch.Tensor
    dropped_newest: torch.Tensor

    def to_json(self) -> dict:
        """Plain-JSON receipt (schema-tagged; syncs at the call site)."""
        host = lambda t: t.cpu().numpy()  # noqa: E731
        return {
            "schema": "join_receipt/1",
            "joined": bool(self.joined),
            "slot": int(self.slot),
            "adopted": host(self.adopted).tolist(),
            "adopted_mask": host(self.adopted_mask).astype(bool).tolist(),
            "skipped": host(self.skipped).tolist(),
            "skipped_mask": host(self.skipped_mask).astype(bool).tolist(),
            "dropped_newest": host(self.dropped_newest).astype(bool).tolist(),
        }


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


def _writable(problem, state, donate: bool, tables=_TABLES):
    """The problem and state the row functions may write in place.

    A lifecycle event also writes ``_EVENT_TABLES`` and the topology's
    positions and degrees (``tables=None``)."""
    if donate:
        return problem, state
    if tables is None:
        tables = _TABLES + _EVENT_TABLES
        topo = problem.topology
        problem = dataclasses.replace(problem, topology=dataclasses.replace(
            topo, positions=topo.positions.clone(), degrees=topo.degrees.clone()))
    problem = dataclasses.replace(
        problem, **{name: getattr(problem, name).clone() for name in tables}
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
    new_chol = factor(g2 + torch.diag_embed(diag))

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
    return factor(problem.gram + torch.diag_embed(diag))


# ---------------------------------------------------------------------------
# Network lifecycle: a sensor joins (add_sensor) or leaves (remove_sensor).
#
# Joins are SYMMETRIC: the newcomer adopts its neighbors AND each adopter
# grows a reciprocal anchor lane at the newcomer's position (with on-device
# recoloring when two same-color adopters would now share the newcomer's
# slot), so the post-join problem is the one a fresh build on the post-join
# topology gives.  A leave is the exact inverse.  Both gather, repair and
# refactor only the O(degree) affected rows.
# ---------------------------------------------------------------------------


def _refactor_rows(problem, alive_new, rows, idx_rows, mask_rows, gram_rows, lam_rows):
    """Masked Cholesky factors of O(degree) gathered rows, (B, R, D, D).

    The effective-lane convention of ``rebuild_chol``: a lane counts iff it
    is occupied and its slot's owner and its row are alive; the others get a
    unit diagonal.  ``rows`` (R,) (sentinel-padded), ``idx_rows`` (R, D) the
    post-event slot tables, ``mask_rows`` (B, R, D), ``gram_rows``
    (B, R, D, D), ``lam_rows`` (R,) the rows' post-event regularizers.
    """
    owner = problem.layout.slot_owner[idx_rows.long()]
    lane_alive = alive_new[owner] & alive_new[rows][:, None]  # (R, D)
    mask_eff = mask_rows & lane_alive[None]
    diag = torch.where(mask_eff, lam_rows[None, :, None], 1.0)
    outer = mask_eff[..., :, None] & mask_eff[..., None, :]
    return factor(torch.where(outer, gram_rows, 0.0) + torch.diag_embed(diag))


def _lane_gather(t: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """t (B, R, D, ...) with lanes reordered by ``src`` (R, D)."""
    p = src[None].reshape(src[None].shape + (1,) * (t.ndim - 3)).expand_as(t)
    return torch.gather(t, 2, p)


def _gram_gather(g: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """g (B, R, D, D) with rows and columns reordered by ``src`` (R, D)."""
    g = _lane_gather(g, src)
    return torch.gather(g, 3, src[None, :, None, :].expand_as(g))


def _insert_rows(problem, state, rows, valid, slot, x, alive_new, repair, kappa):
    """Each adopter row ``rows[i]`` (where ``valid``) grows an anchor lane for
    the newcomer ``slot`` at ``x``, in place.

    The lane is inserted at the row's stream boundary (its pre-join degree),
    so the structural lanes stay a prefix and absorb's left-to-right fill
    survives; absorbed arrivals shift up one lane, the last lane's reserved
    id falls out of the table (its message and stream position reset), and a
    field whose row was full loses its newest arrival.  The row's regularizer
    follows its new degree when ``repair``; its factor is refactored.
    Returns the (B, A) ``dropped_newest`` flags.
    """
    n, s_cap = problem.n, problem.n_stream
    d_max = problem.nbr_idx.shape[1]
    topo = problem.topology
    ar = torch.arange(d_max, device=rows.device)
    deg = topo.degrees[torch.clamp(rows, max=n - 1)].long()  # pre-join degrees
    at_new = ar[None, :] == deg[:, None]  # (A, D) the inserted lane
    src = torch.where(ar[None, :] > deg[:, None], ar[None, :] - 1, ar[None, :])

    # every gather first
    old_idx = problem.nbr_idx[rows]  # (A, D)
    orphan = old_idx[:, d_max - 1].long()  # reserved ids falling out
    pos = problem.nbr_pos[:, rows]  # (B, A, D, d)
    mask = problem.nbr_mask[:, rows]
    gram = problem.gram[:, rows]
    chol = problem.chol[:, rows]
    aw = problem.anchor_w[:, rows]
    coef = state.coef[:, rows]
    lam = problem.lam_pad[rows]
    z_orphan = state.z[:, orphan]
    spv = _with_scratch_row(problem.stream_pos)
    sp_idx = torch.where(valid, torch.clamp(orphan - n, 0, s_cap), s_cap)

    new_idx = torch.where(at_new, slot.to(old_idx.dtype), torch.gather(old_idx, 1, src))
    dropped = mask[:, :, d_max - 1] & valid[None, :]
    new_pos = torch.where(at_new[None, :, :, None], x.to(pos.dtype), _lane_gather(pos, src))
    new_mask = at_new[None] | _lane_gather(mask, src)
    new_coef = torch.where(at_new[None], 0.0, _lane_gather(coef, src))
    new_aw = torch.where(at_new[None], 1.0, _lane_gather(aw, src))
    # the anchor's kernel row against the row's occupied lanes (K(x, x) at
    # the new lane); decayed stream lanes carry their anchor weights
    kv = problem.kernel.pairs(x.to(pos.dtype), new_pos)  # (B, A, D)
    krow = torch.where(new_mask, kv * new_aw.to(kv.dtype), 0.0).to(gram.dtype)
    g = _gram_gather(gram, src)
    g = torch.where(at_new[None, :, None, :], krow[..., None], g)
    g = torch.where(at_new[None, :, :, None], krow[..., None, :], g)
    deg_new = (deg + 1).to(lam.dtype)
    new_lam = torch.where(repair & valid, kappa / (deg_new * deg_new), lam)
    new_chol = _refactor_rows(problem, alive_new, rows, new_idx, new_mask, g, new_lam)

    v, vb = valid[:, None], valid[None, :, None]
    problem.nbr_idx[rows] = torch.where(v, new_idx, old_idx)
    problem.nbr_pos[:, rows] = torch.where(vb[..., None], new_pos, pos)
    problem.nbr_mask[:, rows] = torch.where(vb, new_mask, mask)
    problem.gram[:, rows] = torch.where(vb[..., None], g, gram)
    problem.chol[:, rows] = torch.where(vb[..., None], new_chol, chol)
    problem.anchor_w[:, rows] = torch.where(vb, new_aw, aw)
    problem.lam_pad[rows] = new_lam
    state.coef[:, rows] = torch.where(vb, new_coef, coef)
    topo.degrees.index_add_(0, torch.clamp(rows, max=n - 1), valid.to(topo.degrees.dtype))
    # the orphaned slots' messages and arrival positions reset (lanes that
    # must not write go to the sentinel's own value and the scratch row)
    state.z[:, orphan] = torch.where(valid[None], 0.0, z_orphan)
    spv[:, sp_idx] = torch.where(valid[None, :, None], 0.0, spv[:, sp_idx])
    problem.stream_pos.copy_(spv[:, :s_cap])
    return dropped


def _delete_rows(problem, state, rows, valid, victim, alive_new, repair, kappa):
    """Each row ``rows[i]`` (where ``valid``) deletes its lane for ``victim``, in place.

    The lanes above it shift down one (keeping [structure | arrivals | free]
    and absorb's fill), and the freed last lane restores the row's first
    orphaned reserved id (none left: the inert sentinel id, which backs no
    message slot).  The row's regularizer follows its new degree when
    ``repair``; its factor is refactored.
    """
    n = problem.n
    d_max = problem.nbr_idx.shape[1]
    topo = problem.topology
    ar = torch.arange(d_max, device=rows.device)
    old_idx = problem.nbr_idx[rows]  # (R, D)
    lane = torch.argmax((old_idx == victim.to(old_idx.dtype)).to(torch.uint8), dim=1)
    src = torch.where(ar[None, :] >= lane[:, None],
                      torch.clamp(ar[None, :] + 1, max=d_max - 1), ar[None, :])
    shifted = torch.gather(old_idx, 1, src)
    ids0 = problem.layout.nbr_idx0[rows]  # the pristine table: the reserved pool
    present = (ids0[:, :, None] == shifted[:, None, : d_max - 1]).any(-1)
    cand = (ids0 >= n) & ~present
    pick = torch.argmax(cand.to(torch.uint8), dim=1)
    restored = torch.gather(ids0, 1, pick[:, None])[:, 0]
    restored = torch.where(cand.any(dim=1), restored, problem.sentinel)
    freed = ar == d_max - 1
    new_idx = torch.where(freed[None, :], restored[:, None].to(shifted.dtype), shifted)

    # every gather first
    pos = problem.nbr_pos[:, rows]  # (B, R, D, d)
    mask = problem.nbr_mask[:, rows]
    gram = problem.gram[:, rows]
    chol = problem.chol[:, rows]
    aw = problem.anchor_w[:, rows]
    coef = state.coef[:, rows]
    lam = problem.lam_pad[rows]
    r_in = torch.clamp(rows, max=n - 1)
    own = topo.positions[r_in].to(pos.dtype)  # (R, d)
    deg = topo.degrees[r_in]

    new_pos = torch.where(freed[None, None, :, None], own[None, :, None, :],
                          _lane_gather(pos, src))
    new_mask = ~freed[None, None, :] & _lane_gather(mask, src)
    new_coef = torch.where(freed[None, None, :], 0.0, _lane_gather(coef, src))
    new_aw = torch.where(freed[None, None, :], 1.0, _lane_gather(aw, src))
    g = _gram_gather(gram, src)
    g = torch.where(freed[None, None, :, None] | freed[None, None, None, :], 0.0, g)
    deg_post = torch.clamp(deg - 1, min=1).to(lam.dtype)
    new_lam = torch.where(repair & valid, kappa / (deg_post * deg_post), lam)
    new_chol = _refactor_rows(problem, alive_new, rows, new_idx, new_mask, g, new_lam)

    v, vb = valid[:, None], valid[None, :, None]
    problem.nbr_idx[rows] = torch.where(v, new_idx, old_idx)
    problem.nbr_pos[:, rows] = torch.where(vb[..., None], new_pos, pos)
    problem.nbr_mask[:, rows] = torch.where(vb, new_mask, mask)
    problem.gram[:, rows] = torch.where(vb[..., None], g, gram)
    problem.chol[:, rows] = torch.where(vb[..., None], new_chol, chol)
    problem.anchor_w[:, rows] = torch.where(vb, new_aw, aw)
    problem.lam_pad[rows] = new_lam
    state.coef[:, rows] = torch.where(vb, new_coef, coef)
    topo.degrees.index_add_(0, r_in, -valid.to(topo.degrees.dtype))


def _owned_slots(problem, row: torch.Tensor) -> torch.Tensor:
    """(D+1,) the message slots row ``row`` (1,) owns: its own and the
    reserved ids of its pristine table (``row`` again where a lane is
    structural) — the slots ``layout.slot_owner`` maps to it."""
    ids0 = problem.layout.nbr_idx0[row][0].long()
    return torch.cat([row, torch.where(ids0 >= problem.n, ids0, row)])


def _clear_owned(problem, state, row, gate, stream_pos: bool) -> None:
    """Reset the messages (and with ``stream_pos`` the arrival positions) of
    the slots ``row`` owns, in place."""
    n, s_cap = problem.n, problem.n_stream
    owned = _owned_slots(problem, row)
    state.z[:, owned] = torch.where(gate, 0.0, state.z[:, owned])
    if not stream_pos:
        return
    spv = _with_scratch_row(problem.stream_pos)
    sp = torch.where(gate & (owned >= n), owned - n, s_cap)
    spv[:, sp] = torch.where(gate, 0.0, spv[:, sp])
    problem.stream_pos.copy_(spv[:, :s_cap])


def _nearest(d2: torch.Tensor, gate: torch.Tensor, k: int):
    """The k gated entries of least ``d2``, nearest first, ties to the lower
    id (the reference's ``top_k`` over ``-d2``); returns (ids (k,), valid (k,))."""
    neg = torch.where(gate, -d2, float("-inf"))
    vals, ids = torch.sort(neg, descending=True, stable=True)
    return ids[:k], torch.isfinite(vals[:k])


def _scalar(v, dtype, dev) -> torch.Tensor:
    """A 0-d tensor on ``dev`` (a Python number is filled there, not copied)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=dtype).reshape(())
    return torch.full((), v, dtype=dtype, device=dev)


def _check_lifecycle(problem: SNTrainProblem) -> None:
    if not problem.batched:
        raise ValueError("lifecycle ops require a batched problem (use B = 1)")


def add_sensor(
    problem: SNTrainProblem,
    state: SNTrainState,
    x,
    ys,
    *,
    lam=-1.0,
    repair_lambda=False,
    kappa=0.01,
    donate: bool = False,
) -> tuple[SNTrainProblem, SNTrainState, JoinReceipt]:
    """A sensor JOINS the network at position ``x`` with measurements ``ys`` (B,).

    It claims the first dead spare row (``make_problem(..., n_max=...)``
    reserves them; spares carry reserved singleton colors) and, on the
    device at fixed shapes:

      * adopts the nearest live in-radius sensors whose rows have a lane to
        spare (up to D - 1 of them, after itself);
      * every adopter grows a reciprocal anchor lane at ``x``
        (``_insert_rows``), so the coupling is symmetric;
      * same-color adopters, which now share the newcomer's slot, are
        separated by moving all but the first of each color into reserved
        empty recolor classes (``plans.resolve_join_conflicts``); an
        exhausted pool DROPS the join;
      * builds the newcomer's masked Gram and factor (one D x D system shared
        by the fields) and refactors the adopter rows only;
      * rewrites the scatter plans of the adopters and the newcomer, seeds
        its message slot with ``ys`` (Table-1 init) and marks it alive.

    ``lam``: the newcomer's regularizer; negative applies ``kappa``/|N|^2 to
    its adopted degree.  ``repair_lambda`` re-derives each adopter's
    regularizer from its new degree (kappa / |N_i|^2) inside the
    refactorization; ``repair_lambda`` and ``kappa`` may be tensors.

    Returns ``(problem, state, receipt)``; ``receipt.joined`` is False (a
    bitwise no-op) when no spare row is free or the recolor pool is
    exhausted.  Nothing syncs with the host.  A serving process also
    patches its query plan: ``serving.plan_add_sensor(plan, x,
    receipt.slot)``.  ``donate`` has ``absorb``'s contract.
    """
    _check_lifecycle(problem)
    topo = problem.topology
    if topo.n_spare == 0:
        raise ValueError(
            "problem has no spare rows — build with make_problem(..., n_max=n + spares) "
            "(or build_topology n_max=)"
        )
    if float(topo.radius) <= 0.0:
        raise ValueError(
            "add_sensor needs a geometric topology (radius > 0) to find the joining "
            "sensor's neighborhood"
        )
    dev, dt = problem.device, problem.nbr_pos.dtype
    ldt = problem.lam_pad.dtype
    x = torch.as_tensor(x, dtype=dt, device=dev).reshape(-1)
    ys = torch.as_tensor(ys, dtype=state.z.dtype, device=dev).reshape(-1)
    lam = _scalar(lam, ldt, dev)
    repair = _scalar(repair_lambda, torch.bool, dev)
    kappa = _scalar(kappa, ldt, dev)
    problem, state = _writable(problem, state, donate, tables=None)
    topo = problem.topology
    n, n_base = problem.n, problem.n_base
    d_max = problem.nbr_idx.shape[1]
    lay = problem.layout

    # 1. the first dead spare row; none free => DROP
    spare_alive = problem.alive[n_base:n]
    have_spare = (~spare_alive).any()
    slot = n_base + torch.argmin(spare_alive.to(torch.uint8)).reshape(1)  # (1,)

    # 2. adopt the nearest live in-radius rows with a lane to spare
    pos = topo.positions.to(dt)  # (n, d)
    d2 = torch.sum((pos - x[None, :]) ** 2, dim=-1)
    radius = torch.full((), topo.radius, dtype=dt, device=dev)
    in_radius = problem.alive[:n] & (d2 < radius * radius)
    k_n = min(d_max - 1, n)
    ids, valid0 = _nearest(d2, in_radius & (topo.degrees < d_max), k_n)
    c = 1 + valid0.sum()  # the newcomer's degree
    lam = torch.where(lam >= 0, lam, kappa / c.to(ldt) ** 2)
    # in-radius rows without a free lane: couplings lost, reported
    sk_ids, sk_valid = _nearest(d2, in_radius & (topo.degrees >= d_max), k_n)

    # 3. recolor same-color adopters; an exhausted pool => DROP
    new_colors, moved, feasible = plans.resolve_join_conflicts(
        problem.color_of, problem.color_mask, ids, valid0, problem.recolor_start
    )
    ok = have_spare & feasible
    valid = valid0 & ok
    mv = moved & valid
    rows = torch.where(valid, ids, n)  # (A,) padded with the sentinel row

    # 4. the newcomer's slot table [self, adopted slots...], its free lanes
    # back on the pristine reserved ids (a recycled row starts clean)
    pad_k = d_max - 1 - k_n
    sel_ids = torch.cat([slot, ids, ids.new_zeros((pad_k,))])
    sel_valid = torch.cat([valid0.new_ones((1,)), valid0, valid0.new_zeros((pad_k,))])
    new_idx = torch.where(sel_valid, sel_ids, lay.nbr_idx0[slot][0].long())
    new_pos = torch.where(sel_valid[:, None], pos[torch.clamp(sel_ids, max=n - 1)], x[None, :])
    new_pos[0] = x  # lane 0 is the newcomer itself

    # 5. its local system and factor (one, shared by every field)
    gdt = problem.gram.dtype
    outer = sel_valid[:, None] & sel_valid[None, :]
    gram_row = torch.where(outer, problem.kernel(new_pos, new_pos), 0.0).to(gdt)
    chol_row = factor(gram_row + torch.diag_embed(torch.where(sel_valid, lam, 1.0).to(gdt)))

    # everything read from the slot's row and the color tables before writing
    old_c, old_m = problem.color_of[rows], problem.member_pos[rows]
    old_idx_r = problem.nbr_idx[rows]
    slot_color = problem.color_of[slot]
    b = problem.batch_size
    okb = ok.reshape(1, 1)

    # 6. the adopters' reciprocal anchor lanes (reads the post-join liveness)
    problem.alive[slot] = ok | problem.alive[slot]
    dropped = _insert_rows(problem, state, rows, valid, slot, x, problem.alive, repair, kappa)

    # the newcomer's row
    topo.positions[slot] = torch.where(ok, x.to(topo.positions.dtype), topo.positions[slot])
    topo.degrees[slot] = torch.where(ok, c.to(topo.degrees.dtype), topo.degrees[slot])
    problem.y[:, slot] = torch.where(ok, ys[:, None], problem.y[:, slot])
    problem.lam_pad[slot] = torch.where(ok, lam, problem.lam_pad[slot])
    problem.nbr_idx[slot] = torch.where(ok, new_idx.to(problem.nbr_idx.dtype),
                                        problem.nbr_idx[slot])
    problem.nbr_mask[:, slot] = torch.where(okb, sel_valid, problem.nbr_mask[:, slot])
    problem.nbr_pos[:, slot] = torch.where(okb[..., None, None], new_pos,
                                           problem.nbr_pos[:, slot])
    problem.gram[:, slot] = torch.where(okb[..., None, None], gram_row, problem.gram[:, slot])
    problem.chol[:, slot] = torch.where(okb[..., None, None], chol_row, problem.chol[:, slot])
    problem.anchor_w[:, slot] = torch.where(okb, 1.0, problem.anchor_w[:, slot])

    # 7. colors: recolored adopters change classes, the newcomer enters its
    # singleton class, and the repaired rows' scatter codes are rewritten
    cm, cmk = problem.color_members, problem.color_mask
    plans.members_clear(cm, cmk, old_c, old_m, mv, n)
    plans.members_set(cm, cmk, new_colors, torch.zeros_like(new_colors), rows, mv)
    plans.members_set(cm, cmk, slot_color, torch.zeros_like(slot_color), slot, ok.reshape(1))
    new_c = torch.where(mv, new_colors, old_c)
    new_m = torch.where(mv, 0, old_m)
    problem.color_of[rows] = new_c
    problem.member_pos[rows] = new_m
    plans.plan_rows_remove(problem.plan_z, problem.plan_coef, old_c, rows, old_idx_r, valid)
    plans.plan_rows_add(problem.plan_z, problem.plan_coef, new_c, new_m, rows,
                        problem.nbr_idx[rows], valid)
    plans.color_plans_add(problem.plan_z, problem.plan_coef, problem.color_of,
                          problem.member_pos, slot, problem.nbr_idx[slot][0], ok.reshape(1))

    # 8. the state: the recycled row's owned slots reset, then its message
    # slot takes the measurements; its coefficients start at 0
    _clear_owned(problem, state, slot, ok, stream_pos=False)
    state.z[:, slot] = torch.where(ok, ys[:, None], state.z[:, slot])
    state.coef[:, slot] = torch.where(okb[..., None], 0.0, state.coef[:, slot])
    receipt = JoinReceipt(
        joined=ok,
        slot=slot[0],
        adopted=rows,
        adopted_mask=valid,
        skipped=torch.where(sk_valid & ok, sk_ids, n),
        skipped_mask=sk_valid & ok,
        dropped_newest=dropped,
    )
    return problem, state, receipt


def remove_sensor(
    problem: SNTrainProblem,
    state: SNTrainState,
    slot,
    *,
    repair_lambda=False,
    kappa=0.01,
    donate: bool = False,
) -> tuple[SNTrainProblem, SNTrainState, torch.Tensor]:
    """A sensor LEAVES the network: the exact inverse of the symmetric join.

    Marks the row dead (its reserved slots die with it through the slot
    owner map); every live row its own slot table lists (symmetry makes
    that the complete set of rows referencing it) deletes its lane for the
    victim (``_delete_rows``) and is refactored, O(degree) rows, never all
    n.  Their scatter codes are rewritten, the victim's revert to "keep",
    its class membership clears (freeing a recolor class), its row returns
    to the pristine slot table with no occupied lane, and its messages and
    stream positions reset.  Removed spare rows are recycled by the next
    ``add_sensor``.

    Returns ``(problem, state, removed)`` with ``removed`` a 0-d bool
    tensor; removing a dead or out-of-range row is a bitwise no-op.
    ``repair_lambda`` re-derives the affected rows' regularizers from their
    new degrees.  A serving process also patches its query plan:
    ``serving.plan_remove_sensor(plan, slot)``.  ``donate`` has
    ``absorb``'s contract.
    """
    _check_lifecycle(problem)
    dev = problem.device
    ldt = problem.lam_pad.dtype
    slot = _ints(slot, problem)  # (1,)
    repair = _scalar(repair_lambda, torch.bool, dev)
    kappa = _scalar(kappa, ldt, dev)
    problem, state = _writable(problem, state, donate, tables=None)
    n = problem.n
    d_max = problem.nbr_idx.shape[1]
    topo, lay = problem.topology, problem.layout
    ok = ((slot >= 0) & (slot < n) & problem.alive[torch.clamp(slot, 0, n)])[0]
    sl = torch.clamp(slot, 0, n - 1)  # a safe index; the writes are gated on ok
    okb = ok.reshape(1, 1)

    # the affected rows: the live rows the victim's own table lists
    victim_idx = problem.nbr_idx[sl][0].long()  # (D,)
    nb = ((victim_idx < n) & (victim_idx != sl) & problem.alive[torch.clamp(victim_idx, max=n)]
          & ok)
    rows = torch.where(nb, victim_idx, n)
    c_r, m_r = problem.color_of[rows], problem.member_pos[rows]
    old_idx_r = problem.nbr_idx[rows]
    sl_color, sl_pos = problem.color_of[sl], problem.member_pos[sl]

    problem.alive[sl] = ~ok & problem.alive[sl]
    _delete_rows(problem, state, rows, nb, sl, problem.alive, repair, kappa)

    # the victim's own row returns to its build state with nothing occupied
    problem.nbr_idx[sl] = torch.where(ok, lay.nbr_idx0[sl], problem.nbr_idx[sl])
    problem.nbr_mask[:, sl] = ~okb & problem.nbr_mask[:, sl]
    problem.gram[:, sl] = torch.where(okb[..., None, None], 0.0, problem.gram[:, sl])
    eye = torch.eye(d_max, dtype=problem.chol.dtype, device=dev)
    problem.chol[:, sl] = torch.where(okb[..., None, None], eye, problem.chol[:, sl])
    problem.anchor_w[:, sl] = torch.where(okb, 1.0, problem.anchor_w[:, sl])
    state.coef[:, sl] = torch.where(okb[..., None], 0.0, state.coef[:, sl])
    topo.degrees[sl] = torch.where(ok, 0, topo.degrees[sl]).to(topo.degrees.dtype)
    _clear_owned(problem, state, sl, ok, stream_pos=True)

    # scatter codes and colors
    plans.plan_rows_remove(problem.plan_z, problem.plan_coef, c_r, rows, old_idx_r, nb)
    plans.plan_rows_add(problem.plan_z, problem.plan_coef, c_r, m_r, rows,
                        problem.nbr_idx[rows], nb)
    plans.color_plans_remove(problem.plan_z, problem.plan_coef, problem.color_of, sl,
                             victim_idx, ok.reshape(1))
    plans.members_clear(problem.color_members, problem.color_mask, sl_color, sl_pos,
                        ok.reshape(1), n)
    return problem, state, ok
