"""The port's invariant auditors (``repro_torch.analysis``) on the CPU.

The load-bearing pins:

  * ``python -m repro_torch.analysis --device cpu --skip sync`` on the tree
    exits 0: no new and no stale finding among the rules run;
  * one planted violation of each rule is found with its exact key, and the
    CLI exits 1 naming every key;
  * the port's dtype findings are the reference's baselined dtype findings
    (``tools/audit_baseline.json``, read as JSON);
  * on the reference's parsed-only fixtures the port's ``ast-alive-thread``
    and ``ast-receipt-json`` findings are the ones ``tests/test_audit.py``
    asserts;
  * ``launch_ledger.snapshot`` / ``assert_within`` enforce a launch budget
    (a stand-in counter: CPU tensors launch nothing).
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import pytest
import torch

from repro_torch import analysis
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import (alive_audit, ast_lint, dtype_audit, entries, launch_ledger,
                                  sync_audit)
from repro_torch.analysis.report import Finding, compare_with_baseline, load_baseline
from repro_torch.core import colored_sweep
from repro_torch.core.sn_train import SNTrainState
from repro_torch.kernels import _build, color_step, knn_fuse

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_ROOT = os.path.join(ROOT, "tests", "fixtures")
REFERENCE_BASELINE = os.path.join(ROOT, "tools", "audit_baseline.json")


@pytest.fixture(scope="module")
def fx32():
    return entries.canonical(torch.float32, "cpu")


@pytest.fixture(scope="module")
def fx64():
    return entries.canonical(torch.float64, "cpu")


def test_cli_on_the_tree_exits_clean():
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu", "--skip", "sync", "-v"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("audit: ")]
    assert [ln.split(":")[1].strip() for ln in lines[:-1]] == ["ast", "ledger", "dtype", "alive"]
    assert all(" 0 new, 0 stale" in ln for ln in lines[:-1]) and lines[-1] == "audit: clean"


def test_sync_needs_the_card():
    """``sync`` never falls back: on the CPU it raises (exit 2 from the CLI)."""
    with pytest.raises(ValueError, match="CUDA device"):
        sync_audit.run("cpu")


def test_sync_free_registry_is_the_card_entries():
    """``SYNC_FREE`` is derived from the registry's card calls: the functions
    that claim no host sync, each run by the card's host-sync audit."""
    assert ast_lint.SYNC_FREE == {
        "core/sn_train.py": ("colored_sweep", "robust_sweep"),
        "core/faults.py": ("faulty_sweep", "sample_faults"),
        "core/streaming.py": ("absorb", "absorb_many", "absorb_wave", "add_sensor",
                              "remove_sensor", "evict_oldest"),
        "core/serving.py": ("knn_fuse", "knn_select_valid", "_eval_selected",
                            "plan_add_sensor", "plan_remove_sensor"),
        "core/pruning.py": ("prune_mask",),
        "kernels/color_step.py": ("color_sweep", "color_step"),
        "kernels/knn_fuse.py": ("knn_fuse_fused",),
        "kernels/kernel_matvec.py": ("kernel_matvec_batched",),
        "kernels/ssd_intra.py": ("ssd_intra",),
        "kernels/gram.py": ("rbf_gram",),
    }


def test_frame_tag_names_the_innermost_port_frame():
    """A host-sync finding's tag is the innermost frame in ``repro_torch``
    outside the auditor: here ``make_serving_plan`` below ``knn_fuse``."""
    from repro_torch.core import serving

    with pytest.raises(AttributeError, match="alive") as info:  # a problem without tables
        serving.knn_fuse(types.SimpleNamespace(n=5), None, torch.zeros((1, 1)), 2, plan=None)
    assert sync_audit._frame_tag(info.value.__traceback__) == "core.serving:make_serving_plan"


# --- planted violations ----------------------------------------------------

_PLANTED_AST = {
    "host_sync": ("""
        def hot(x):
            return float(x) + x.item()
        """, ("hot",), {"ast-host-sync:core/planted.py:hot:float",
                        "ast-host-sync:core/planted.py:hot:item"}),
    "host_sync_transitive": ("""
        def hot(x, k: int):
            return _helper(x) + int(k) + int(x.shape[0])

        def _helper(x):
            return _deeper(x)

        def _deeper(x):
            return x.tolist()
        """, ("hot",), {"ast-host-sync:core/planted.py:hot:tolist"}),
    "alive_thread": ("""
        def dropped(z, alive=None):
            if alive is None:
                pass
            return z
        """, (), {"ast-alive-thread:core/planted.py:dropped"}),
    "receipt_json": ("""
        class LostReceipt:
            pass
        """, (), {"ast-receipt-json:core/planted.py:LostReceipt"}),
}


def _plant(tmp_path, source):
    d = tmp_path / "core"
    d.mkdir(exist_ok=True)
    path = d / "planted.py"
    path.write_text(textwrap.dedent(source))
    return str(path)


@pytest.mark.parametrize("case", sorted(_PLANTED_AST))
def test_planted_ast_violation_found(case, tmp_path):
    source, sync_free, want = _PLANTED_AST[case]
    path = _plant(tmp_path, source)
    keys = {f.key for f in ast_lint.lint_file(path, str(tmp_path), sync_free=sync_free)}
    assert keys == want


def _narrow(fx, alive):
    return fx.state.z.to(torch.float32)


def _promo(fx, alive):
    return fx.state.z * torch.ones((), dtype=torch.float64).expand(1)


def _dropped_gate(fx, alive):
    return colored_sweep(fx.prob, fx.state, 1)


def _writes_dead_row(fx, alive):
    out = colored_sweep(entries.with_alive(fx.prob, alive), fx.state, 1)
    return SNTrainState(z=out.z, coef=out.coef + 1.0)


_SWEEP = "core.sn_train:colored_sweep"
_PLANTED_RUNTIME = {
    "dtype-narrow": (entries.Entry("planted.narrow", _SWEEP, _narrow), torch.float64,
                     "dtype-narrow:planted.narrow:float64->float32"),
    "weak-promo": (entries.Entry("planted.promo", _SWEEP, _promo), torch.float32,
                   "weak-promo:planted.promo:float32->float64"),
    "alive-dead": (entries.Entry("planted.dropped", _SWEEP, _dropped_gate, ("alive",)),
                   torch.float32, "alive-dead:planted.dropped"),
    "alive-scatter": (entries.Entry("planted.scatter", _SWEEP, _writes_dead_row, entries.SWEEP),
                      torch.float32, "alive-scatter:planted.scatter"),
}
_PLANTED_LEDGER = entries.Entry("planted.missing", "core.sn_train:no_such_sweep",
                                launches=(("color_step", 1),))


@pytest.mark.parametrize("rule", sorted(_PLANTED_RUNTIME))
def test_planted_runtime_violation_found(rule, fx32, fx64):
    entry, dtype, key = _PLANTED_RUNTIME[rule]
    fx = fx64 if dtype == torch.float64 else fx32
    audit = dtype_audit if rule in ("dtype-narrow", "weak-promo") else alive_audit
    assert {f.key for f in audit.audit_entry(entry, fx)} == {key}


def test_planted_ledger_entry_with_unknown_target_found():
    keys = {f.key for f in launch_ledger.audit(registry=(_PLANTED_LEDGER,))}
    assert keys == {"ledger:planted.missing:resolve"}


def test_cli_names_every_planted_key(tmp_path, monkeypatch, capsys):
    """One planted violation per rule: the CLI exits 1 and prints each key."""
    paths = []
    for case, (source, sync_free, _) in sorted(_PLANTED_AST.items()):
        d = tmp_path / case / "core"
        d.mkdir(parents=True)
        (d / "planted.py").write_text(textwrap.dedent(source))
        paths.append((str(d / "planted.py"), sync_free))
    real_lint = ast_lint.lint_paths
    monkeypatch.setattr(ast_lint, "lint_paths", lambda: real_lint() + [
        f for p, sf in paths for f in ast_lint.lint_file(p, str(tmp_path), sync_free=sf)])
    planted = tuple(e for e, _, _ in _PLANTED_RUNTIME.values()) + (_PLANTED_LEDGER,)
    real = entries.registry()
    monkeypatch.setattr(entries, "registry", lambda: real + planted)
    assert cli.main(["--device", "cpu", "--skip", "sync"]) == 1
    out = capsys.readouterr().out
    want = {k.replace("core/planted.py", f"{case}/core/planted.py")
            for case, (_, _, keys) in _PLANTED_AST.items() for k in keys}
    want |= {key for _, _, key in _PLANTED_RUNTIME.values()}
    want.add("ledger:planted.missing:resolve")
    assert {ln.split()[1] for ln in out.splitlines() if ln.startswith("  NEW ")} == want
    assert "STALE" not in out


def test_write_baseline_keeps_the_rules_not_run(tmp_path, capsys):
    """The CPU ledger run is its self-check only: a baselined ``grid-launch``
    entry (the card's grid check) is neither stale nor deleted, nor is a
    ``host-sync`` entry of the skipped sync auditor."""
    path = str(tmp_path / "baseline.json")
    kept = {"host-sync:entry:core.x:f": "kept: sync did not run",
            "grid-launch:faults.cuda:0.1": "kept: the grid check runs on the card only"}
    with open(path, "w") as fh:
        json.dump({"baselined": kept}, fh)
    argv = ["--device", "cpu", "--skip", "sync,dtype,alive", "--baseline", path]
    assert cli.main(argv) == 1  # the tree's three ast findings are not in this file
    assert "STALE" not in capsys.readouterr().out
    assert cli.main(argv + ["--write-baseline"]) == 0
    written = load_baseline(path)
    assert {k: written[k] for k in kept} == kept
    assert {k for k in written if k.startswith("ast-")} == {f.key for f in ast_lint.lint_paths()}
    assert cli.main(argv) == 0


# --- the reference's records -----------------------------------------------


def test_dtype_findings_equal_the_references_baselined_ones():
    with open(REFERENCE_BASELINE) as fh:
        ref = json.load(fh)["baselined"]
    ref_dtype = {k for k in ref if k.split(":")[0] in ("dtype-narrow", "weak-promo")}
    assert {f.key for f in dtype_audit.run("cpu")} == ref_dtype
    assert ref_dtype == {"dtype-narrow:stream.add_sensor:float64->float32"}


@pytest.mark.parametrize("name,want", [
    ("bad_ast.py", {"ast-alive-thread:core/bad_ast.py:dropped_gate",
                    "ast-receipt-json:core/bad_ast.py:LostReceipt"}),
    ("clean_ast.py", set()),
])
def test_reference_fixtures_alive_and_receipt_rules(name, want):
    path = os.path.join(FIXTURE_ROOT, "core", name)
    keys = {f.key for f in ast_lint.lint_file(path, FIXTURE_ROOT)
            if f.rule in ("ast-alive-thread", "ast-receipt-json")}
    assert keys == want


def test_every_sync_free_function_exists_and_the_baseline_is_justified():
    """Every sync-free target is a function defined in the file the AST rule
    reads, so none goes unread."""
    for rel, names in ast_lint.SYNC_FREE.items():
        with open(os.path.join(ROOT, "src", "repro_torch", rel)) as fh:
            tree = ast.parse(fh.read())
        defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
        assert set(names) <= defined, rel
    findings = ast_lint.lint_paths()
    baseline = load_baseline(os.path.join(ROOT, "src", "repro_torch", "analysis",
                                          "audit_baseline.json"))
    assert all(len(why) > 40 for why in baseline.values())
    new, stale = compare_with_baseline(findings, {k: v for k, v in baseline.items()
                                                  if k.startswith("ast-")})
    assert new == [] and stale == []


def test_baseline_stale_only_among_rules_run():
    f1, f2 = Finding("rule-a", "spot", "t"), Finding("rule-b", "other")
    baseline = {f1.key: "justified", "host-sync:entry:core.x:f": "justified"}
    new, stale = compare_with_baseline([f1, f2], baseline, scope=("rule-a", "rule-b"))
    assert [f.key for f in new] == [f2.key] and stale == []
    new, stale = compare_with_baseline([], baseline, scope=("rule-a",))
    assert new == [] and stale == [f1.key]
    assert compare_with_baseline([], baseline, scope=("rule-a:spot",))[1] == [f1.key]
    assert compare_with_baseline([], baseline, scope=("rule-a:spo", "rule"))[1] == []
    assert compare_with_baseline([], baseline)[1] == sorted(baseline)


@pytest.mark.parametrize("auditor,device,key,stale", [
    ("ledger", "cpu", "grid-launch:faults.cuda:0.1", False),
    ("ledger", "cuda", "grid-launch:faults.cuda:0.1", True),
    ("ledger", "cpu", "ledger:sweep.serial:resolve", True),
    ("alive", "cuda", "alive-dead:sweep.serial", False),
    ("alive", "cuda", "alive-scatter:faults.crash", False),
    ("alive", "cuda", "alive-dead:faults.cuda", True),
    ("alive", "cpu", "alive-dead:sweep.serial", True),
    ("sync", "cuda", "host-sync:stream.absorb:core.streaming:absorb", True),
])
def test_scope_narrows_staleness_to_what_runs(auditor, device, key, stale):
    """A baselined key that does not fire is stale only where its auditor
    ran it: the grid check and the sync audit on the card only, the
    liveness rules there only for the cuda entries."""
    got = compare_with_baseline([], {key: "justified"}, analysis.scope(auditor, device))[1]
    assert got == ([key] if stale else [])


# --- the launch ledger -------------------------------------------------------


def test_ledger_audits_clean_and_groups_resolve():
    """The registry's self-check is clean, and the entries whose launches
    ``chip_smoke.py``'s phases count resolve to kernels."""
    assert launch_ledger.audit() == []
    ledger = entries.by_name()
    for name in ("sweep.colored.cuda", "serving.knn.cuda", "kernels.matvec", "faults.cuda",
                 "faults.crash.cuda", "sweep.sharded.fields.cuda", "lm.prefill.ssd"):
        assert ledger[name].launches and ledger[name].resolve(), name
    assert ledger["sweep.sharded.sensors"].launches == ()


def test_ledger_expected_counts():
    want = launch_ledger.expected({"sweep.colored.cuda": 3, "serving.knn.cuda": 2,
                                   "kernels.matvec": 2, "faults.crash.cuda": 5,
                                   "lm.prefill.ssd": 96, "stream.absorb": 7})
    assert want == {"color_step": 8, "knn_fuse": 2, "kernel_matvec": 2, "ssd_intra": 96,
                    "rbf_gram": 0}
    with pytest.raises(KeyError, match="not in the launch ledger"):
        launch_ledger.snapshot(("no.such.entry",))


def test_snapshot_enforces_the_launch_budget(monkeypatch):
    """A stand-in counter: the test bumps the counters a launch would."""
    monkeypatch.setattr(color_step, "launches", 0)
    monkeypatch.setattr(knn_fuse, "launches", 0)
    monkeypatch.setattr(_build, "builds", 0)
    snap = launch_ledger.snapshot(("sweep.colored.cuda", "serving.knn.cuda"))
    assert snap.kernels == ["color_step", "knn_fuse"]
    color_step.launches += 3
    knn_fuse.launches += 1
    growth = snap.assert_within({"sweep.colored.cuda": 3, "serving.knn.cuda": 1}, "three ticks")
    assert growth == {"color_step": 3, "knn_fuse": 1, "builds": 0}
    with pytest.raises(AssertionError, match="color_step launched 3"):
        snap.assert_within({"sweep.colored.cuda": 2, "serving.knn.cuda": 1})
    with pytest.raises(KeyError, match="outside the snapshot"):
        snap.assert_within({"faults.cuda": 1})
    _build.builds += 1
    with pytest.raises(AssertionError, match="library build"):
        snap.assert_within({"sweep.colored.cuda": 3, "serving.knn.cuda": 1})
    snap = launch_ledger.snapshot(("pruning.keep",))  # plain PyTorch: no kernel counted
    assert snap.assert_within({"pruning.keep": 4}) == {"builds": 0}


def test_registry_names_follow_the_reference():
    """The runtime registry keeps the reference's entry names (``cuda`` for
    ``pallas``), every SWEEP entry is a sweep, and every liveness row is live."""
    names = [e.name for e in entries.registry()]
    assert len(names) == len(set(names))
    assert {"sweep.serial", "sweep.colored.plan", "sweep.colored.cuda", "stream.add_sensor",
            "serving.knn.quant", "pruning.keep", "faults.crash",
            "monitor.watchdog_step"} <= set(names)
    fx = entries.canonical(torch.float32, "cpu")
    for e in (e for e in entries.registry() if e.call is not None):
        row = entries.row_of(e, fx)
        prob = fx.sprob if e.single else fx.prob
        assert bool(prob.alive[row]), e.name
        if "alive-scatter" in e.checks:
            assert isinstance(e.call(fx, None), SNTrainState), e.name


def test_canonical_problem_reaches_the_stream_lanes():
    fx = entries.canonical(torch.float32, "cpu")
    occupied = fx.prob.nbr_mask & (fx.prob.nbr_idx >= fx.prob.n)[None]
    assert int(occupied.sum()) > 0 and float(fx.prob.beta.min()) < 1.0
    assert fx.prob.n_stream > 0 and fx.prob.topology.n_spare > 0


def test_sensor_field_config_equals_the_reference():
    """``configs.sensor_field`` (the paper's workload) is the reference's,
    field for field."""
    from repro.configs import sensor_field_config as ref_config
    from repro_torch.configs import sensor_field, sensor_field_config

    port = sensor_field_config()
    assert isinstance(port, sensor_field.SensorFieldConfig)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref_config())
    assert [f.name for f in dataclasses.fields(port)] == list(dataclasses.asdict(ref_config()))
