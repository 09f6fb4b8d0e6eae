"""The one-launch colored sweep: its plain version and its launch plan.

``color_sweep`` runs n_sweeps x n_colors color steps in one launch on the
card; on CPU tensors it runs its plain version, which must equal the loop of
single color steps (``color_step``) over the sweeps and colors, bit for bit.
The launch plan is plain Python, so its limits are checked here: shared
memory within the H100's 232,448 bytes per block, at most 8 CTAs per
cluster, and every member of a color owned by exactly one warp.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as tr
from repro_torch.kernels import color_step as cs

torch.set_num_threads(1)

SWEEPS = 4


def _problem(b, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, size=(40, 2)).astype(np.float32)
    ys = np.sin(np.pi * pos[None, :, 0]) + 0.3 * rng.normal(size=(b, 40))
    topo = tr.build_topology(pos, 0.5, device="cpu")
    return tr.make_batch_problem(topo, tr.Kernel("rbf", gamma=1.0), ys, np.full(40, 0.1),
                                 device="cpu")


@pytest.mark.parametrize("b", [1, 3])
def test_color_sweep_equals_the_color_step_loop_bitwise(b):
    prob = _problem(b, seed=b)
    st = tr.colored_sweep(prob, tr.init_state(prob), n_sweeps=1)  # non-trivial z
    rng = np.random.default_rng(7)
    delivered = torch.as_tensor(rng.uniform(size=(SWEEPS,) + tuple(prob.nbr_idx.shape)) >= 0.3)
    alive = prob.alive.clone()
    alive[[3, 11]] = False  # the alive override: two dead rows
    alive_z = alive[prob.layout.slot_owner]
    tables = (prob.nbr_idx, prob.nbr_mask, prob.gram, prob.chol, prob.lam_pad, alive, alive_z)
    z_s, c_s = st.z.clone(), st.coef.clone()
    cs.color_sweep(z_s, c_s, *tables, prob.color_members, prob.color_mask, delivered, SWEEPS)
    z_l, c_l = st.z.clone(), st.coef.clone()
    for t in range(SWEEPS):
        for c in range(prob.color_members.shape[0]):
            cs.color_step(z_l, c_l, *tables, prob.color_members[c], prob.color_mask[c],
                          delivered[t])
    assert torch.equal(z_s, z_l) and torch.equal(c_s, c_l)
    assert not torch.equal(z_s, st.z)  # the sweeps did move the state
    assert float(z_s[:, -1].abs().max()) == 0.0  # the sentinel is never written
    # the engine runs the same plain version through colored_sweep
    via = tr.colored_sweep(prob, st, n_sweeps=SWEEPS, engine="cuda", alive=alive,
                           delivered=delivered)
    assert torch.equal(via.z, z_s) and torch.equal(via.coef, c_s)
    assert cs.launches == 0  # CPU tensors never count a launch


def _owners(plan, m):
    """member -> (CTA, warp, half) under the kernel's layout."""
    owned = {}
    stride = plan.warps * plan.cluster * plan.per_warp
    for rank in range(plan.cluster):
        for warp in range(plan.warps):
            for half in range(plan.per_warp):
                slot = (rank * plan.warps + warp) * plan.per_warp + half
                for member in range(slot, m, stride):
                    assert member not in owned, member
                    owned[member] = (rank, warp, half)
    return owned


@pytest.mark.parametrize("itemsize,d,m,warps,cluster,per", [
    (4, 15, 63, 4, 8, 2),     # f32 at the main geometry's D with 63 members
    (4, 15, 105, 7, 8, 2),    # f32, the benched problem's widest color
    (8, 15, 105, 7, 8, 2),    # f64 of the same
    (4, 17, 105, 14, 8, 1),   # past 16 lanes: one member per warp
    (8, 40, 40, 4, 8, 1),     # f64 at D = 40: 52,544 bytes per warp, 4 fit
    (4, 40, 40, 5, 8, 1),     # f32 at D = 40
    (4, 15, 1, 1, 1, 2),      # one member
    (4, 15, 1000, 16, 8, 2),  # more members than slots: slots stride
])
def test_launch_plan_fits_and_covers_every_member(itemsize, d, m, warps, cluster, per):
    plan = cs.launch_plan(itemsize, d, m)
    assert (plan.warps, plan.cluster, plan.per_warp) == (warps, cluster, per)
    assert plan.row_stride % 2 == 1 and plan.row_stride >= d
    per_matrix = -(-(d * plan.row_stride * itemsize + 16) // 16) * 16  # 16 B slack, aligned
    assert plan.smem_bytes == plan.warps * per * 4 * per_matrix
    assert plan.smem_bytes <= cs.SMEM_LIMIT == 232_448
    assert 1 <= plan.cluster <= 8 and 1 <= plan.warps <= 16
    assert sorted(_owners(plan, m)) == list(range(m))


def test_launch_plan_at_d40_f64_uses_four_warps():
    plan = cs.launch_plan(8, 40, 63)
    assert plan.warps == 4 and plan.smem_bytes == 210_176


@pytest.mark.parametrize("itemsize,d", [(8, 90), (4, 129)])
def test_launch_plan_raises_when_nothing_fits(itemsize, d):
    with pytest.raises(ValueError, match="no launch plan"):
        cs.launch_plan(itemsize, d, 10)
