"""The work the rooflines and MFUs divide by, against hand counts at tiny
shapes, and the readers on a made-up trace."""

import types

import numpy as np
import pytest
import torch

from portbench import counts, harness, peaks, trace
from portbench.reference import build as rbuild

# three sensors on a line: 0-1 and 1-2 neighbours, 0 and 2 not
POS = np.array([[0.0], [0.3], [0.6]], np.float32)
B = rbuild.build(POS, 0.4, {"rule": "const", "value": 0.1})


def test_tiny_build():
    assert B.degrees.tolist() == [2, 3, 2] and B.nbr_idx.shape == (3, 3)
    assert len(B.members) == 3  # every pair shares sensor 1


def test_sweep_work_by_hand():
    # per (field, sensor): e (g(g+1)/2 + g^2) + g + 4 e g; per sensor 4+1+1+e + 5g
    e, fields, sweeps = 4, 2, 5
    per_field = sum(e * (g * (g + 1) / 2 + g * g) + g + 4 * e * g for g in (2, 3, 2))
    per_sensor = sum(6 + e + 5 * g for g in (2, 3, 2))
    flops = sum(4 * g * g + 2 * g for g in (2, 3, 2))
    assert counts.sweep_work(B, fields, sweeps, e) == (fields * per_field + per_sensor,
                                                       fields * sweeps * flops)


def test_rbf_term_and_requests_by_hand():
    assert counts.rbf_term_flops(2) == 9
    nb, fl, ex = counts.conn_request(10, 2, torch.tensor([3, 0]))
    assert (nb, fl, ex) == (4.0 * (20 + 20 + 9), 30 * 9, 30)
    xq = torch.tensor([[0.0], [0.59]])
    # k = 1: query 0 picks sensor 0 (2 lanes), query 1 picks sensor 2 (2 lanes)
    assert counts.knn_picks(B, xq, 1) == (4, 4)
    nb, fl, ex = counts.knn_request(B, xq, 1, 3, 4)
    assert ex == 3 * 4 and fl == ex * counts.rbf_term_flops(1)
    assert nb == 2 * 4 + 3 * 2 * 4 + 3 * 4 + 3 * 4 * (4 + 4 + 1)


def test_least_seconds_takes_the_largest_floor():
    assert peaks.least_seconds(3.35e12, 0, "float32") == (1.0, "bytes")
    assert peaks.least_seconds(0, 67e12, "float64") == (1.0, "operations")
    t, by = peaks.least_seconds(0, 0, "float32", 2 * peaks.EXPS_PER_S)
    assert by == "exp" and t == pytest.approx(2.0)


def test_trace_union_and_gaps():
    busy, gaps = trace._union([(0, 2), (1, 3), (5, 6)])
    assert busy == 4 and gaps == [(3, 5)]


def _ctx(kind, **work):
    tr = dict(window_s=1.0, busy_s=0.25,
              kernels={"void color_sweep_kernel<float>(...)": (0.002, 2), "Memcpy HtoD": (0.1, 3)})
    items = [(0, 0.0, 0.5, 3), (1, 0.5, 1.0, 3)]
    return types.SimpleNamespace(trace=tr, window=dict(items=items, traced=items, seconds=1.0,
                                                       setup_s=4.0),
                                 work=dict(kind=kind, build=B, fields=3, sweeps=5,
                                           dtype="float32", **work))


def test_readers_on_a_made_up_trace():
    cell = harness.Cell.find("n1000-train")
    ctx = _ctx("train")
    nbytes, flops = counts.sweep_work(B, 3, 5, 4)
    least = peaks.least_seconds(nbytes, flops, "float32")[0]
    assert cell.reader("color_step_roofline").read(ctx) == pytest.approx(100 * least * 2 / 0.002)
    assert cell.reader("train_mfu").read(ctx) == pytest.approx(100 * flops * 2 / (1.0 * 67e12))
    assert cell.reader("device_idle.train").read(ctx) == pytest.approx(75.0)
    assert cell.reader("device_idle.query").read(ctx) is None
    assert cell.reader("train_fields_per_s").read(ctx) == 6.0
    assert cell.reader("setup_s").read(ctx) == 4.0


def test_knn_launch_count_leaves_out_copies():
    cell = harness.Cell.find("n1000-knn")
    ctx = _ctx("query", rule="knn")
    assert cell.reader("launches_per_request.knn").read(ctx) == 1.0
    ctx.trace = None
    assert cell.reader("knn_fuse_roofline").read(ctx) is None
