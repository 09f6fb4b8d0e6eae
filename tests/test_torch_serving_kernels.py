"""The serving kernels' designs, held on the CPU where neither kernel runs.

``knn_fuse`` selects each query's k picks as k warp-wide arg-mins over
(distance, column) pairs; a numpy emulation of that reduction (lane l owns
columns l, l + 32, ...; a 5-step xor butterfly compares lexicographically)
must give exactly ``knn_fuse_ref``'s selections on a lattice, where exact
distance ties are everywhere.

``kernel_matvec`` splits each field's non-zero anchors over the CTAs of a
cluster (``launch_plan``): its plans fill the H100 at B = 1 and B = 16, and
a numpy model of the kernel's window / compaction / balanced split assigns
every non-zero anchor to exactly one CTA, evenly, and none to an all-zero
field; the model's float32 sum, in the kernel's order with the exp of the
pre-scaled argument, is within the 2e-5 bound of the plain version.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as tr
from repro_torch.kernels import kernel_matvec as km
from repro_torch.kernels import knn_fuse as kf

torch.set_num_threads(1)

LANES = 32
H = 0.25  # lattice spacing: every coordinate and squared distance is exact in f32


def _lattice(dtype):
    g = np.arange(-4, 5) * H
    pos = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    topo = tr.build_topology(pos, 1.5 * H, device="cpu")
    ys = np.sin(np.pi * pos[None, :, 0]) + np.random.default_rng(0).normal(size=(2, len(pos)))
    prob = tr.make_batch_problem(topo, tr.Kernel("rbf", gamma=1.0), ys,
                                 np.full(len(pos), 0.1), dtype=dtype, device="cpu")
    mid = g[:-1] + H / 2
    xq = np.concatenate([np.stack(np.meshgrid(a, a, indexing="ij"), -1).reshape(-1, 2)
                         for a in (g, mid)])  # lattice points and cell midpoints
    return prob, torch.as_tensor(xq, dtype=dtype)


def _warp_select(xq, qcell, cells, cell_mask, alive, spos, k):
    """numpy model of the kernel's selection: (Q, k) picks, -1 past the valid."""
    dt = xq.dtype
    picks = np.full((xq.shape[0], k), -1, np.int32)
    for q in range(xq.shape[0]):
        cand, cm = cells[qcell[q]], cell_mask[qcell[q]]
        dist = np.full(cand.shape[0], np.inf, dt)
        for col, s in enumerate(cand):
            if cm[col] and 0 <= s < spos.shape[0] and alive[s]:
                diff = xq[q] - spos[s]  # unfused: each product and sum rounded
                acc = diff[0] * diff[0]
                for c in range(1, xq.shape[1]):
                    acc = dt.type(acc + diff[c] * diff[c])
                dist[col] = acc
        for j in range(k):
            best = np.full(LANES, np.inf, dt)
            best_col = np.full(LANES, np.iinfo(np.int32).max, np.int64)
            for lane in range(LANES):  # each lane scans its own columns in order
                for col in range(lane, cand.shape[0], LANES):
                    if dist[col] < best[lane]:
                        best[lane], best_col[lane] = dist[col], col
            for off in (16, 8, 4, 2, 1):  # xor butterfly, all lanes at once
                ov, oc = best[np.arange(LANES) ^ off], best_col[np.arange(LANES) ^ off]
                take = (ov < best) | ((ov == best) & (oc < best_col))
                best, best_col = np.where(take, ov, best), np.where(take, oc, best_col)
            assert (best == best[0]).all() and (best_col == best_col[0]).all()
            if not np.isfinite(best[0]):
                break
            picks[q, j] = cand[best_col[0]]
            dist[best_col[0]] = np.inf
    return picks


@pytest.mark.parametrize("cells_per_dim", [None, 2])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_warp_argmin_selection_equals_the_plain_version_under_ties(dtype, k, cells_per_dim):
    prob, xq = _lattice(dtype)
    plan = tr.make_serving_plan(prob, k=5, cells_per_dim=cells_per_dim)
    assert plan.k_max > LANES  # lanes own more than one column
    qcell = tr.serving.query_cells(plan, xq)
    positions = prob.topology.positions.to(dtype)
    spos = torch.cat([positions, positions.new_zeros((1, 2))])
    alive = prob.alive.clone()
    alive[[10, 40]] = False
    ecoef = tr.effective_coef(prob, tr.init_state(prob))
    _, ref = kf.knn_fuse_ref(xq, qcell, plan.cells, plan.cell_mask, alive, spos, prob.nbr_pos,
                             prob.nbr_mask, ecoef, gamma=1.0, k=k)
    got = _warp_select(xq.numpy(), qcell.numpy(), plan.cells.numpy(),
                       plan.cell_mask.numpy(), alive.numpy(), spos.numpy(), k)
    np.testing.assert_array_equal(got, ref.numpy())
    # tie-heavy: for many queries the k-th nearest live sensor ties with the
    # next one, so the tie rule decides the selected set
    d2 = ((xq[:, None, :] - positions[None]) ** 2).sum(-1).numpy()
    d2[:, ~alive[:-1].numpy()] = np.inf
    srt = np.sort(d2, axis=1)
    assert (srt[:, k - 1] == srt[:, k]).mean() > 1 / 3


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_warp_argmin_ties_within_one_lane(k):
    """Four sensors tie nearest at columns 3, 35, 67 (one lane's) and 20: the
    picks follow the column order, as torch.argmin's first minimum does."""
    r, kmax = 40, 70
    ang = np.arange(r) * 2 * np.pi / r
    spos = np.concatenate([np.stack([np.cos(ang), np.sin(ang)], 1) * 2.0,
                           [[0.25, 0.0], [0.0, 0.25], [-0.25, 0.0], [0.0, -0.25]]])
    cells = np.arange(kmax, dtype=np.int32)[None] % r
    cells[0, [3, 35, 67, 20]] = [r, r + 1, r + 2, r + 3]  # exact ties at distance 1/4
    spos = torch.as_tensor(np.concatenate([spos, [[0.0, 0.0]]]), dtype=torch.float32)
    n = spos.shape[0]
    xq = torch.zeros((1, 2))
    qcell = torch.zeros(1, dtype=torch.int32)
    cell_mask, alive = torch.ones((1, kmax), dtype=torch.bool), torch.ones(n, dtype=torch.bool)
    nbr = (torch.zeros((1, n, 3, 2)), torch.ones((1, n, 3), dtype=torch.bool),
           torch.ones((1, n, 3)))
    _, ref = kf.knn_fuse_ref(xq, qcell, torch.as_tensor(cells), cell_mask, alive, spos, *nbr,
                             gamma=1.0, k=k)
    got = _warp_select(xq.numpy(), qcell.numpy(), cells, cell_mask.numpy(), alive.numpy(),
                       spos.numpy(), k)
    np.testing.assert_array_equal(got, ref.numpy())
    assert ref[0, :4].tolist()[:k] == [r, r + 3, r + 1, r + 2][:k]  # columns 3, 20, 35, 67


# ---------------------------------------------------------------------------
# kernel_matvec: launch plan and the non-zero split.
# ---------------------------------------------------------------------------

SMS = 132
SMEM_LIMIT = 232_448


@pytest.mark.parametrize("q,b,n,d", [(4096, 16, 8400, 2), (4096, 1, 1000, 2),
                                     (4096, 16, 8400, 8), (4001, 3, 20000, 1), (1, 1, 1, 1)])
def test_launch_plan_limits(q, b, n, d):
    p = km.launch_plan(q, b, n, d)
    assert 1 <= p.cluster <= km.MAX_CLUSTER and p.per_thread in (1, 2, 4)
    assert p.span % km.THREADS == 0 and km.THREADS <= p.span <= km.MAX_SPAN
    assert p.tiles * p.per_thread * km.THREADS >= q > (p.tiles - 1) * p.per_thread * km.THREADS
    assert p.padded_dim >= d and p.padded_dim in (2, 4, 8)
    row = -(-(p.padded_dim + 2) // 4) * 4
    assert p.smem_bytes == 4 * (p.span * (row + 1) + p.per_thread * km.THREADS)
    assert p.smem_bytes <= SMEM_LIMIT


def test_launch_plan_fills_the_card_at_both_serving_shapes():
    field = km.launch_plan(4096, 16, 8400, 2)  # the conn route: B = 16, 8400 anchors
    assert (field.cluster, field.per_thread) == (8, 4)
    assert field.tiles * field.cluster * 16 >= km.TARGET_CTAS  # several CTAs per SM
    assert field.cluster * field.span >= 8400  # one window
    one = km.launch_plan(4096, 1, 1000, 2)  # centralized predict: B = 1, 1000 anchors
    assert one.cluster == 8 and one.per_thread == 1
    assert one.tiles * one.cluster >= SMS  # every SM has work (the old grid had 32 CTAs)


def _split(coef_row, plan):
    """numpy model of the kernel: per window, each rank compacts the non-zero
    indices of its span in order; rank r takes ranks [r tot / C, (r+1) tot / C)
    of the window's list.  Returns per rank the list of its indices, in order."""
    c, span, n = plan.cluster, plan.span, coef_row.shape[0]
    shares = [[] for _ in range(c)]
    for w0 in range(0, n, c * span):
        lists = [[j for j in range(w0 + r * span, min(w0 + (r + 1) * span, n))
                  if coef_row[j] != 0] for r in range(c)]
        window = [j for lst in lists for j in lst]
        tot = len(window)
        for r in range(c):
            part = window[r * tot // c:(r + 1) * tot // c]
            assert len(part) in (tot // c, -(-tot // c))  # balanced within one
            shares[r].append(part)
    return shares


@pytest.mark.parametrize("case", ["conn", "all nonzero", "all zero", "B=1"])
def test_nonzero_split_is_exact_and_balanced(case):
    rng = np.random.default_rng(3)
    n = 1000 if case == "B=1" else 8400
    coef = rng.normal(size=n).astype(np.float32)
    if case == "conn":
        coef[1000:] = 0.0  # 1000 sensors, then 7400 empty stream slots
        coef[rng.choice(1000, 30, replace=False)] = 0.0  # dead sensors
    if case == "all zero":
        coef[:] = 0.0
    plan = km.launch_plan(4096, 1 if case == "B=1" else 16, n, 2)
    shares = _split(coef, plan)
    got = sorted(j for rank in shares for part in rank for j in part)
    assert got == np.flatnonzero(coef).tolist()  # every non-zero once, no zero
    sizes = [sum(len(p) for p in rank) for rank in shares]
    assert max(sizes) - min(sizes) <= len(shares[0])  # within one per window
    if case == "conn":  # 970 live anchors: ~121 per CTA, where an index split gives 970, 0, ...
        assert plan.cluster == 8 and max(sizes) - min(sizes) <= 1 and sum(sizes) == 970
    if case == "all zero":
        assert sizes == [0] * plan.cluster


FOLD = 64  # the kernel's kFold


def _model_sum(xq, anchors, coef, gamma, plan):
    """The kernel's arithmetic in float32: exp2 of the pre-scaled, clamped
    argument, two accumulators per query over blocks of FOLD rows of each
    rank's share, the ranks' partial sums added in order."""
    f = np.float32
    k = f(gamma * np.log2(np.e))
    xs, nx = f(2) * k * xq, -k * (xq * xq).sum(1, dtype=f)  # (Q, d), (Q,)
    out = np.zeros((coef.shape[0], xq.shape[0]), f)
    for b in range(coef.shape[0]):
        a = anchors if anchors.ndim == 2 else anchors[b]
        partials = []
        for rank in _split(coef[b], plan):
            acc = np.zeros((2, xq.shape[0]), f)
            for part in rank:  # one window's share, in blocks of FOLD rows
                for t0 in range(0, len(part), FOLD):
                    blk = np.zeros((2, xq.shape[0]), f)
                    for t, j in enumerate(part[t0:t0 + FOLD]):
                        u = nx + (-k * (a[j] * a[j]).sum(dtype=f)) + (xs * a[j]).sum(1, dtype=f)
                        blk[t % 2] += np.exp2(np.minimum(u, f(0))) * coef[b, j]
                    acc += blk
            partials.append(acc[0] + acc[1])
        total = np.zeros(xq.shape[0], f)
        for p in partials:
            total += p
        out[b] = total
    return out


@pytest.mark.parametrize("n,b,shared", [(700, 2, False), (1000, 1, True)])
def test_model_of_the_kernels_sum_holds_the_bound(n, b, shared):
    rng = np.random.default_rng(n + b)
    xq = rng.uniform(-1, 1, size=(64, 2)).astype(np.float32)
    anchors = rng.uniform(-1, 1, size=((n, 2) if shared else (b, n, 2))).astype(np.float32)
    coef = (rng.normal(size=(b, n)) / np.sqrt(n)).astype(np.float32)
    coef[:, n // 3:n // 2] = 0.0
    plan = km.launch_plan(xq.shape[0], b, n, 2)
    assert plan.cluster > 1
    got = _model_sum(xq, anchors, coef, 1.3, plan)
    ref = km.kernel_matvec_ref(torch.as_tensor(xq), torch.as_tensor(anchors),
                               torch.as_tensor(coef), 1.3).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
