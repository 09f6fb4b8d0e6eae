"""The readers of the port's own spans (``metrics/_spans.py``):
``serve_host_ms``, ``serve_padded_rows`` and ``color_step_us``.

On hand-built records each reads its value, and None where the port
recorded no span, where a traced item lacks its span, or where the program
has no recorder.  Whole ``--trace 1`` runs of the query cells at a small
size on the CPU read both serve metrics, the padded share exactly as the
request sizes give it.  On the card a traced kNN stretch shows the port's
spans as host events only: none among the device's kernels.
"""

import sys
import types

import pytest
import torch

from portbench import gen, harness, trace
from portbench._small import small_cell
from portbench.metrics._spans import traced_requests

CPU = torch.device("cpu")
SEED = 2**31 + 23


def reader(name):
    return harness.Cell.find("n1000-knn").reader(name)


def rec(index, name, start_ms, end_ms, parent=None, request=None, **counts):
    return types.SimpleNamespace(
        index=index, name=name, parent=parent, request=index if request is None else request,
        start=int(start_ms * 1e6), end=int(end_ms * 1e6), counts=counts)


def ctx(kind, items, rule=None, tr=None):
    """A run's context as the readers see it: traced items (i, a, z, units)
    on the perf_counter clock in seconds."""
    return types.SimpleNamespace(
        work=dict(kind=kind, rule=rule), trace=tr,
        window=dict(traced=[(i, a * 1e-3, z * 1e-3, 1) for i, (a, z) in enumerate(items)]))


ITEMS = [(0.0, 10.0), (10.0, 20.0)]  # two traced items, in ms


def knn_records():
    return [rec(0, "serve.knn", 1.0, 2.0), rec(1, "serve.knn.prep", 1.1, 1.3, 0, 0),
            rec(2, "kernel.knn_fuse", 1.5, 1.9, 0, 0, rows=5000, padded=3192),
            rec(3, "serve.knn", 11.0, 14.0), rec(4, "kernel.knn_fuse", 12.0, 13.0, 3, 3,
                                                 rows=8192, padded=0)]


@pytest.fixture
def ring(monkeypatch):
    """Hands the readers the records this test puts in the list."""
    from repro_torch import spans

    held = []
    monkeypatch.setattr(spans, "records", lambda: list(held))
    return held


def test_serve_readers_on_hand_built_records(ring):
    ring.extend(knn_records())
    c = ctx("query", ITEMS, rule="knn")
    assert reader("serve_host_ms").read(c) == pytest.approx(2.0)
    assert reader("serve_padded_rows").read(c) == pytest.approx(100.0 * 3192 / (8192 + 8192))


def test_conn_reads_its_own_span(ring):
    ring.extend([rec(0, "serve.conn", 1.0, 1.5, rows=4096, padded=0),
                 rec(1, "kernel.kernel_matvec", 1.1, 1.4, 0, 0),
                 rec(2, "serve.conn", 11.0, 11.5, rows=5000, padded=3192)])
    c = ctx("query", ITEMS, rule="conn")
    assert reader("serve_host_ms").read(c) == pytest.approx(0.5)
    assert reader("serve_padded_rows").read(c) == pytest.approx(100.0 * 3192 / (4096 + 8192))
    assert reader("serve_host_ms").read(ctx("query", ITEMS, rule="knn")) is None


def test_color_step_us_on_hand_built_records(ring):
    ring.extend([rec(0, "train.sweep", 1.0, 5.0), rec(1, "kernel.color_sweep", 1.0, 1.2, 0, 0,
                                                     steps=480),
                 rec(2, "train.sweep", 11.0, 15.0), rec(3, "kernel.color_sweep", 11, 11.2, 2, 2,
                                                       steps=480)])
    tr = dict(kernels={"void color_sweep_kernel<float, 16, 1>(...)": (0.0384, 2),
                       "Memcpy DtoD (Device -> Device)": (0.001, 2)})
    assert reader("color_step_us").read(ctx("train", ITEMS, tr=tr)) == pytest.approx(40.0)
    assert reader("color_step_us").read(ctx("train", ITEMS, tr=None)) is None
    assert reader("color_step_us").read(ctx("query", ITEMS, rule="knn", tr=tr)) is None


@pytest.mark.parametrize("case", ["a launch outside the spans", "a span without its launch",
                                  "an early return counted as a launch"])
def test_color_step_us_needs_one_launch_per_launching_span(ring, case):
    """The profiled launches must be the traced calls' launching spans, one
    for one; a span with ``steps`` 0 (the early return) launched nothing."""
    recs = [rec(0, "train.sweep", 1.0, 5.0),
            rec(1, "kernel.color_sweep", 1.0, 1.2, 0, 0, steps=480),
            rec(2, "train.sweep", 11.0, 15.0),
            rec(3, "kernel.color_sweep", 11, 11.2, 2, 2, steps=480),
            rec(4, "kernel.color_sweep", 12, 12.1, 2, 2, steps=0)]
    launches = 2
    if case == "a launch outside the spans":
        launches = 3
    elif case == "a span without its launch":
        launches = 1
    else:
        recs[4].counts["steps"] = 480
    ring.extend(recs)
    tr = dict(kernels={"void color_sweep_kernel<float, 16, 1>(...)": (0.0384, launches)})
    assert reader("color_step_us").read(ctx("train", ITEMS, tr=tr)) is None


@pytest.mark.parametrize("name", ["serve_host_ms", "serve_padded_rows"])
@pytest.mark.parametrize("case", ["no spans", "item without its span", "two spans in an item",
                                  "a span of another name", "no traced items"])
def test_serve_readers_find_nothing(ring, name, case):
    recs = knn_records()
    items = ITEMS
    if case == "item without its span":
        recs = recs[:3]
    elif case == "two spans in an item":
        recs.append(rec(5, "serve.knn", 15.0, 16.0))
    elif case == "a span of another name":
        recs[3].name = "serve.conn"
    elif case == "no traced items":
        items = []
    if case != "no spans":
        ring.extend(recs)
    assert reader(name).read(ctx("query", items, rule="knn")) is None


@pytest.mark.parametrize("name", ["serve_host_ms", "serve_padded_rows", "color_step_us"])
def test_readers_without_the_recorder_find_nothing(monkeypatch, name):
    """A program without ``repro_torch.spans`` (the benchmark's readers run
    on the parent's program too) reads None and raises nothing."""
    import repro_torch

    monkeypatch.delattr(repro_torch, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    tr = dict(kernels={"color_sweep_kernel": (1.0, 1)})
    for kind, rule in (("query", "knn"), ("train", None)):
        assert reader(name).read(ctx(kind, ITEMS, rule=rule, tr=tr)) is None


def test_traced_requests_keeps_each_items_records(ring):
    ring.extend(knn_records())
    got = traced_requests(ctx("query", ITEMS, rule="knn"), "serve.knn")
    assert [root.index for root, _ in got] == [0, 3]
    assert [[r.index for r in recs] for _, recs in got] == [[0, 1, 2], [3, 4]]


def test_full_mix_pads_27_06_percent():
    """The kNN and conn mixes' 64 sizes, each once in any 64 consecutive
    requests: 1,431,109 rows become 1,961,984 kernel rows."""
    from repro_torch.kernels.ops import bucket_rows

    for mix in ("knn-q4k-64k", "conn-q4k-64k"):
        spec = harness.load_json(harness.ROOT / "traffic" / f"{mix}.json")
        qs = gen.sizes(spec["sizes"], SEED)
        assert len(qs) == spec["trace_items"] == 64
        assert sum(qs) == 1_431_109 and sum(bucket_rows(q) for q in qs) == 1_961_984
        assert round(100.0 * (1_961_984 - 1_431_109) / 1_961_984, 2) == 27.06


@pytest.mark.parametrize("name", ["n1000-knn", "n1000-conn"])
def test_traced_small_run_reads_the_serve_spans(name):
    """A ``--trace 1`` run at a small size on the CPU, with sizes that pad:
    both serve metrics read, the padded share exactly the sizes'."""
    from repro_torch.kernels.ops import bucket_rows

    cell = small_cell(name)
    cell.traffic["sizes"] = dict(q_min=9, q_max=40, count=3)
    qs = gen.sizes(cell.traffic["sizes"], SEED)
    assert cell.traffic["trace_items"] == len(qs)  # each size once in the traced stretch
    res = harness.run_cell(cell, SEED, 0.2, True, CPU)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    pad = sum(bucket_rows(q) - q for q in qs)
    assert m["serve_padded_rows"]["value"] == pytest.approx(
        100.0 * pad / sum(bucket_rows(q) for q in qs))
    assert m["serve_padded_rows"]["unit"] == "%" and pad > 0
    assert m["serve_host_ms"]["value"] > 0 and m["serve_host_ms"]["unit"] == "ms"
    assert "color_step_us" not in m


def test_traced_small_train_run_counts_colour_steps(monkeypatch):
    """On the CPU no kernel is profiled, so ``color_step_us`` reads None;
    given a kernel time, it divides it by the colour steps the traced calls
    counted (the plain version runs them here)."""
    cell = small_cell("n1000-train")
    res = harness.run_cell(cell, SEED, 0.2, True, CPU)
    assert res["correct"] and "color_step_us" not in res["metrics"]
    monkeypatch.setattr(trace, "kernel_seconds", lambda tr, fragment: (1e-3, 2))
    res = harness.run_cell(cell, SEED, 0.2, True, CPU)
    steps = 1e-3 * 1e6 / res["metrics"]["color_step_us"]["value"]
    sweeps = cell.traffic["trace_items"] * cell.config["n_sweeps"]
    assert steps == pytest.approx(round(steps)) and round(steps) % sweeps == 0 and steps > 0


@pytest.mark.chip
def test_port_spans_are_not_device_activity_on_the_card(cuda_device, monkeypatch):
    """A traced kNN stretch at the cell's own size: the port's spans were
    recorded (the serve metrics read), and none of its names is among the
    device's kernels or device ops."""
    seen = []
    real = trace.summarise

    def keep(prof):
        seen.append(real(prof))
        return seen[-1]

    monkeypatch.setattr(trace, "summarise", keep)
    res = harness.run_cell(harness.Cell.find("n1000-knn"), 2**31 + 107, 2.0, True, cuda_device)
    assert res["correct"], res["checks"]
    assert seen and seen[0]["kernels"]
    assert not [k for k in seen[0]["kernels"] if k.startswith("repro_torch.")]
    assert not [k for k, _ in res["breakdown"]["device_ops"] if k.startswith("repro_torch")]
    assert res["metrics"]["serve_padded_rows"]["value"] == pytest.approx(27.06, abs=0.005)
    assert res["metrics"]["serve_host_ms"]["value"] > 0
