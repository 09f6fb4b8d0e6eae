"""The port's span recorder (``repro_torch.spans``) on the CPU.

Off (no profiler session): every span is the one shared no-op and nothing
is recorded.  On (``torch.profiler`` with CPU activity): spans nest, carry
their parent's and their outermost span's index and their counts, give
self time as duration less their children, and appear in the profiler's
events as function-scope host events, never as user annotations (which
the profiler would also put on the device's timeline).  The serving
wrappers count the rows they pad to their power-of-two bucket.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as tr
from repro_torch import spans
from repro_torch.core import fusion
from repro_torch.kernels import knn_fuse as kf
from repro_torch.kernels import ops

torch.set_num_threads(1)

PORT_NAMES = {"serve.knn", "serve.knn.prep", "serve.knn.cells", "kernel.knn_fuse",
               "serve.conn", "kernel.kernel_matvec", "train.sweep", "kernel.color_sweep"}


def _problem(n=40, fields=2, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, size=(n, 2))
    topo = tr.build_topology(pos, 0.5, device="cpu")
    ys = np.sin(np.pi * pos[None, :, 0]) + rng.normal(size=(fields, n))
    prob = tr.make_batch_problem(topo, tr.Kernel("rbf", gamma=1.0), ys, np.full(n, 0.1),
                                 dtype=torch.float32, device="cpu")
    return prob, tr.init_state(prob)


def _profiled(fn):
    """Runs ``fn`` under a CPU profiler session on an empty ring; returns
    (the profiler, the ring's records)."""
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    recs = spans.records()
    spans.reset()
    return prof, recs


def test_off_span_is_the_shared_noop_and_records_nothing():
    assert not torch.autograd._profiler_enabled()
    spans.reset()
    s = spans.span("serve.knn")
    assert s is spans.OFF and spans.span("other") is spans.OFF
    with s as inner:
        inner.count(rows=3)
        assert inner is spans.OFF
    prob, st = _problem()
    st = tr.colored_sweep(prob, st, 2, engine="cuda")
    fusion.fuse(prob, st, torch.zeros((5, 2)), "knn", k=2, engine="cuda")
    assert spans.records() == []


def test_nested_spans_carry_parent_request_counts_and_self_time():
    def nest():
        with spans.span("outer") as a:
            a.count(rows=7)
            with spans.span("mid"):
                with spans.span("leaf") as c:
                    c.count(steps=2, padded=1)
            with spans.span("mid"):
                pass
        with spans.span("second"):
            pass

    _, recs = _profiled(nest)
    assert [r.name for r in recs] == ["outer", "mid", "leaf", "mid", "second"]
    outer, mid1, leaf, mid2, second = recs
    assert outer.parent is None and second.parent is None
    assert mid1.parent == mid2.parent == outer.index and leaf.parent == mid1.index
    assert {r.request for r in recs[:4]} == {outer.index} and second.request == second.index
    assert outer.counts == {"rows": 7} and leaf.counts == {"steps": 2, "padded": 1}
    assert all(r.start <= r.end for r in recs)
    assert outer.start <= mid1.start <= leaf.start <= leaf.end <= mid1.end <= mid2.start
    assert mid2.end <= outer.end <= second.start
    own = spans.self_ns(recs)
    dur = {r.index: r.end - r.start for r in recs}
    assert own[outer.index] == dur[outer.index] - dur[mid1.index] - dur[mid2.index]
    assert own[mid1.index] == dur[mid1.index] - dur[leaf.index]
    assert own[leaf.index] == dur[leaf.index] and own[second.index] == dur[second.index]
    table = spans.table(recs)
    assert table["mid"]["calls"] == 2 and table["leaf"]["steps"] == 2
    assert table["outer"]["self_ms"] == pytest.approx(own[outer.index] * 1e-6)


def test_port_spans_are_function_events_not_user_annotations():
    """The profiler shows each span under its prefixed name, as a host event
    that is not a user annotation; its aten ops nest under it."""
    prob, st = _problem()
    xq = torch.rand((37, 2)) * 2 - 1
    anchors, cglob = None, None

    def calls():
        nonlocal anchors, cglob
        s = tr.colored_sweep(prob, st, 2, engine="cuda")
        fusion.fuse(prob, s, xq, "knn", k=2, engine="cuda")
        anchors, cglob = fusion.global_coefficients(prob, s, rule="conn")
        ops.kernel_matvec(xq, anchors, cglob, gamma=1.0)

    prof, recs = _profiled(calls)
    assert {r.name for r in recs} == PORT_NAMES
    events = [e for e in prof.events() if e.name.startswith(spans.PREFIX)]
    assert {e.name[len(spans.PREFIX):] for e in events} == PORT_NAMES
    assert not any(e.is_user_annotation for e in events)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in events)
    knn = [e for e in events if e.name == spans.PREFIX + "serve.knn"]
    children = {c.name for c in knn[0].cpu_children}
    assert {spans.PREFIX + "serve.knn.prep", spans.PREFIX + "serve.knn.cells",
            spans.PREFIX + "kernel.knn_fuse"} <= children
    by_name = {r.name: r for r in recs}
    assert by_name["kernel.knn_fuse"].counts == {"rows": 37, "padded": 64 - 37}
    assert by_name["serve.conn"].counts == {"rows": 37, "padded": 64 - 37}
    assert by_name["kernel.knn_fuse"].request == by_name["serve.knn"].index
    assert by_name["kernel.kernel_matvec"].parent == by_name["serve.conn"].index


def test_colour_steps_are_counted():
    prob, st = _problem()
    n_colors = int(prob.topology.colors.max()) + 1
    _, recs = _profiled(lambda: tr.colored_sweep(prob, st, 3, engine="cuda"))
    sweep = [r for r in recs if r.name == "kernel.color_sweep"]
    assert len(sweep) == 1 and sweep[0].counts == {"steps": 3 * n_colors}
    assert sweep[0].parent == recs[0].index and recs[0].name == "train.sweep"


@pytest.mark.parametrize("route", ["knn_fuse_fused", "kernel_matvec"])
def test_padding_counted_at_q_5000(route):
    """Q = 5,000 rows pad to the 8,192-row bucket: 3,192 rows of padding."""
    prob, st = _problem()
    xq = torch.rand((5000, 2)) * 2 - 1
    if route == "knn_fuse_fused":
        from repro_torch.core import make_serving_plan
        from repro_torch.core.serving import query_cells

        plan = make_serving_plan(prob, k=2)
        pos = prob.topology.positions.to(torch.float32)
        spos = torch.cat([pos, pos.new_zeros((1, 2))])
        coef = tr.effective_coef(prob, st)

        def call():
            kf.knn_fuse_fused(xq, query_cells(plan, xq), plan.cells, plan.cell_mask, spos,
                              prob.nbr_pos, prob.nbr_mask, coef, alive=prob.alive, k=2)
        name = "kernel.knn_fuse"
    else:
        anchors, cglob = fusion.global_coefficients(prob, st, rule="conn")

        def call():
            ops.kernel_matvec(xq, anchors, cglob, gamma=1.0)
        name = "serve.conn"
    _, recs = _profiled(call)
    hit = [r for r in recs if r.name == name]
    assert len(hit) == 1 and hit[0].counts == {"rows": 5000, "padded": 3192}


def test_ring_keeps_its_newest_records():
    extra = 10

    def many():
        for i in range(spans.RING + extra):
            with spans.span("x") as s:
                s.count(i=i)

    _, recs = _profiled(many)
    assert len(recs) == spans.RING == 65536
    assert [r.counts["i"] for r in recs[:3]] == [extra, extra + 1, extra + 2]
    assert recs[-1].counts["i"] == spans.RING + extra - 1
    assert [r.index for r in recs[:3]] == [0, 1, 2] and recs[-1].index == spans.RING - 1
    assert all(r.parent is None and r.request == r.index for r in recs)


def test_profile_field_prints_the_span_table(capsys):
    """The operator's profile of the field requests (rehearsed on the CPU)
    reads the same spans as the benchmark, per request."""
    from repro_torch.launch import profile_field

    out = profile_field.main(["--device", "cpu", "--fields", "2", "--sensors", "60",
                              "--radius", "0.5", "--sweeps", "2", "--queries", "50"])
    knn, conn = out["knn"]["spans"], out["conn"]["spans"]
    assert list(knn) == ["serve.knn", "serve.knn.prep", "serve.knn.cells", "kernel.knn_fuse"]
    assert knn["kernel.knn_fuse"]["rows"] == 50 and knn["kernel.knn_fuse"]["padded"] == 14
    assert list(conn) == ["serve.conn", "kernel.kernel_matvec"]
    assert conn["serve.conn"]["rows"] == 50 and conn["serve.conn"]["padded"] == 14
    assert all(row["calls"] == 1 and 0 <= row["self_ms"] <= row["ms"]
               for row in (*knn.values(), *conn.values()))
    text = capsys.readouterr().out
    assert "repro_torch.kernel.knn_fuse  rows 50  padded 14" in text
    assert "repro_torch.serve.conn  rows 50  padded 14" in text
