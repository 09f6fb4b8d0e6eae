"""The plain reference agrees with the port's CPU path at a tiny size, in
float64: the build, the colored sweep, kNN and conn serving; and the
controls' TF32 rounding."""

import numpy as np
import pytest
import torch

from portbench import gen
from portbench.reference import build as rbuild
from portbench.reference import fusion as rfusion
from portbench.reference.precision import REFERENCE, Precision, control, tf32_round
from portbench.reference.sop import Sweeper

CFG = {"domain": [-1.0, 1.0], "placement_seed": 3, "n_sensors": 40, "dim": 2}
RADIUS, GAMMA, SWEEPS, FIELDS = 0.5, 1.0, 4, 3


@pytest.fixture(scope="module")
def both():
    from repro_torch.core import (Kernel, build_topology, colored_sweep, init_state,
                                  make_batch_problem)

    pos = gen.placement(CFG)
    b = rbuild.build(pos, RADIUS, {"rule": "kappa_over_deg2", "kappa": 0.5})
    ys = np.random.default_rng(0).normal(size=(FIELDS, b.n))
    topo = build_topology(pos, RADIUS, device="cpu")
    prob = make_batch_problem(topo, Kernel("rbf", gamma=GAMMA), ys, b.lambdas,
                              dtype=torch.float64, device="cpu")
    st = colored_sweep(prob, init_state(prob), SWEEPS, engine="plan")
    return b, prob, st, torch.as_tensor(ys)


def test_build_matches_the_ports(both):
    b, prob, _, _ = both
    n = b.n
    assert np.array_equal(prob.topology.colors.numpy(), b.colors)
    assert np.array_equal(prob.nbr_mask[0, :n].numpy(), b.nbr_mask)
    assert np.array_equal(np.where(b.nbr_mask, prob.nbr_idx[:n].numpy(), 0),
                          np.where(b.nbr_mask, b.nbr_idx, 0))
    gram = rbuild.gram_blocks(b, GAMMA, REFERENCE, "cpu")
    assert torch.allclose(prob.gram[0, :n], gram, rtol=0, atol=1e-14)
    chol = torch.linalg.cholesky(rbuild.systems(b, gram))
    assert torch.allclose(prob.chol[0, :n], chol, rtol=0, atol=1e-12)


def test_sweep_matches_the_ports(both):
    b, prob, st, ys = both
    z, coef = Sweeper(b, GAMMA, REFERENCE, "cpu").sweep(ys, SWEEPS)
    assert torch.allclose(st.z[:, : b.n], z, rtol=0, atol=1e-11)
    assert torch.allclose(st.coef[:, : b.n], coef, rtol=0, atol=1e-10)


def test_knn_matches_the_ports(both):
    from repro_torch.core import fusion

    b, prob, st, _ = both
    xq = gen.points([-1.0, 1.0], 50, 2, 11, 0, torch.Generator(), torch.float64)
    want = fusion.fuse(prob, st, xq, "knn", k=3, engine="dense")
    got, alt, tie = rfusion.knn_answers(b, st.coef[:, : b.n], xq, 3, GAMMA, REFERENCE, 1e-7)
    assert not bool(tie.any())
    assert torch.allclose(got, want, rtol=0, atol=1e-10)


def test_conn_matches_the_ports(both):
    from repro_torch.core import fusion
    from repro_torch.kernels.kernel_matvec import kernel_matvec_ref

    b, prob, st, _ = both
    anchors, cglob = fusion.global_coefficients(prob, st, rule="conn")
    mine = rfusion.conn_coefficients(b, st.coef[:, : b.n], REFERENCE)
    assert torch.allclose(cglob[:, : b.n], mine, rtol=0, atol=1e-12)
    assert not bool(cglob[:, b.n:].any())
    xq = gen.points([-1.0, 1.0], 30, 2, 12, 0, torch.Generator(), torch.float64)
    want = fusion.fuse(prob, st, xq, "conn", engine="dense")
    got = rfusion.conn_answers(b, mine, xq, GAMMA, REFERENCE)
    assert torch.allclose(got, want, rtol=0, atol=1e-10)
    f32 = kernel_matvec_ref(xq.float(), anchors[0].float(), cglob.float(), GAMMA)
    assert torch.allclose(f32.double(), got, rtol=0, atol=1e-5)


def test_ties_offer_both_answers():
    pos = np.array([[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [0.0, 3.0]], np.float32)
    b = rbuild.build(pos, 1.5, {"rule": "const", "value": 0.1})
    coef = torch.arange(b.n * b.nbr_idx.shape[1], dtype=torch.float64).reshape(1, b.n, -1)
    xq = torch.tensor([[0.0, 0.0]], dtype=torch.float64)  # sensors 1 and 2 at equal distance
    got, alt, tie = rfusion.knn_answers(b, coef, xq, 2, GAMMA, REFERENCE, 1e-7)
    assert bool(tie[0]) and not torch.equal(got, alt)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12, -3.0])
    assert tf32_round(x).tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-9, 1.0, -3.0]
    assert control("float32") == Precision("tf32") and control("float64") == Precision("float32")
