"""The port's daemon and pruning entry points, run as a user runs them.

  * ``python -m repro_torch.launch.daemon --device cpu`` with a checkpoint
    every tick is SIGKILLed after two checkpoints; a restart over the same
    directory with ``--verify-restart`` reproduces the last checkpoint's
    state digest and probe answers bitwise (the reference's CI step,
    .github/workflows/ci.yml, at its geometry);
  * ``serve --mode daemon`` hands every other flag to the daemon's CLI;
  * ``serve --energy_tau`` prints the same ``pruned n/m`` and ``K_max`` as
    the JAX package's launcher on the same seed and flags, and under
    ``--churn`` compacts the churn trace's repaired plan;
  * ``--hardened-env`` re-execs the launcher once (the guard variable stops
    the loop) and notes an absent tcmalloc instead of failing.
"""

import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

import repro_torch.core as tr
from repro_torch.launch import daemon as td
from repro_torch.launch import serve

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
DAEMON = [sys.executable, "-m", "repro_torch.launch.daemon", "--device", "cpu",
          "--sensors", "16", "--fields", "2"]


def _probes(snap):
    return sorted(f for f in os.listdir(snap) if f.startswith("probe_"))


def test_cli_sigkill_then_warm_restart_bitwise():
    with tempfile.TemporaryDirectory() as snap:
        argv = DAEMON + ["--ticks", "200", "--ckpt-every", "1", "--snapshot-dir", snap,
                         "--queries-per-tick", "1", "--arrivals-per-tick", "4",
                         "--tick-sleep", "0.2"]
        proc = subprocess.Popen(argv, env=ENV, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        try:
            deadline = time.time() + 120
            while time.time() < deadline:
                if len(_probes(snap)) >= 2:
                    break
                if proc.poll() is not None:
                    _, err = proc.communicate()
                    pytest.fail(f"daemon exited early: {err[-2000:]}")
                time.sleep(0.01)
            else:
                pytest.fail("no checkpoints appeared before the deadline")
            time.sleep(0.05)  # inside the tick's sleep, after its probe file
            proc.send_signal(signal.SIGKILL)  # a crash, not a clean exit
        finally:
            proc.kill()
            proc.wait()
        assert proc.returncode == -signal.SIGKILL
        steps = sorted(f for f in os.listdir(snap) if f.startswith("step_"))
        assert len(steps) >= 2
        out = subprocess.run(DAEMON + ["--ticks", "0", "--snapshot-dir", snap,
                                       "--verify-restart"],
                             env=ENV, cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        last = int(steps[-1].split("_")[1])
        assert f"warm restart: restored step {last}" in out.stdout
        assert f"warm restart verified: step {last} bitwise" in out.stdout


def test_serve_mode_daemon_delegates(capsys):
    d = serve.main(["--mode", "daemon", "--device", "cpu", "--sensors", "16", "--fields", "2",
                    "--ticks", "2", "--queries-per-tick", "2", "--query-rows", "5",
                    "--energy-tau", "0.01"])
    assert isinstance(d, td.Daemon) and d.tick_count == 2 and d.served == 4
    assert d.config.engine == "cuda" and d.config.energy_tau == 0.01
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "daemon_health/1" in ln]
    assert len(lines) == 2


def _serve_argv(extra):
    return ["--mode", "field", "--fields", "3", "--sensors", "60", "--radius", "0.5",
            "--sweeps", "10", "--queries", "64", "--fusion", "knn", "--k", "3",
            "--engine", "plan", "--seed", "1"] + extra


def _tau(res):
    """A threshold near the 30th percentile of the live energies, at least
    1e-3 relative away from each of them."""
    e = tr.representer_energy(res["problem"], res["state"])[: res["problem"].n].numpy()
    s = np.sort(e)
    for i in range(int(0.3 * len(s)), len(s) - 1):
        tau = 0.5 * (s[i] + s[i + 1])
        if np.abs(e - tau).min() >= 1e-3 * tau:
            return float(tau)
    raise AssertionError("no gap between the energies")


def _query_note(out):
    m = re.search(r"query\[knn k=3 engine=plan tau=(\S+) pruned (\d+)/(\d+) "
                  r"\(plan: (\d+) cells, K_max=(\d+)\)\]", out)
    assert m, out
    return m.groups()


def test_energy_tau_matches_the_reference_launcher(capsys, monkeypatch):
    res = serve.main(_serve_argv(["--device", "cpu"]))
    capsys.readouterr()
    tau = _tau(res)
    res = serve.main(_serve_argv(["--device", "cpu", "--energy_tau", repr(tau)]))
    port = _query_note(capsys.readouterr().out)
    rep = res["prune"]
    assert 0 < rep.n_pruned < rep.n_live and rep.k_max_after < rep.k_max_before
    assert res["pruned_plan"].k_max == rep.k_max_after
    assert port[1:3] == (str(rep.n_pruned), str(rep.n_live))

    from repro.launch import serve as jserve

    monkeypatch.setattr(sys, "argv", ["serve"] + _serve_argv(["--energy_tau", repr(tau)]))
    jserve.main()
    ref = _query_note(capsys.readouterr().out)
    assert port == ref, (port, ref)


def test_energy_tau_under_churn_compacts_the_repaired_plan(capsys):
    argv = _serve_argv(["--device", "cpu", "--dim", "2", "--stream", "9", "--churn", "4",
                        "--spares", "2"])
    res = serve.main(argv + ["--energy_tau", "0.5"])
    repaired, compact, rep = res["churn"]["plan"], res["pruned_plan"], res["prune"]
    assert rep.k_max_before == repaired.k_max and compact.k_max == rep.k_max_after
    assert compact.n_cells == repaired.n_cells
    keep = torch.as_tensor(rep.keep)
    for c in range(repaired.n_cells):
        want = repaired.cells[c][repaired.cell_mask[c] & keep[repaired.cells[c].long()]]
        got = compact.cells[c][compact.cell_mask[c]]
        assert torch.equal(got, want), c
    out = capsys.readouterr().out
    assert f"pruned {rep.n_pruned}/{rep.n_live}" in out and f"K_max={compact.k_max}" in out


def test_hardened_env_builds_the_preload(monkeypatch, tmp_path):
    lib = tmp_path / "libtcmalloc.so.4"
    lib.write_bytes(b"")
    monkeypatch.setattr(serve, "_TCMALLOC_PATHS", ("/nonexistent/libtcmalloc.so.4", str(lib)))
    env, notes = serve.hardened_env({"LD_PRELOAD": "/x.so"})
    assert env["LD_PRELOAD"] == f"{lib}:/x.so" and notes == [f"tcmalloc={lib}"]
    assert env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == "60000000000"
    assert "XLA_FLAGS" not in env and "TF_CPP_MIN_LOG_LEVEL" not in env
    env, _ = serve.hardened_env({"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "7"})
    assert env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == "7"  # never overrides
    monkeypatch.setattr(serve, "_TCMALLOC_PATHS", ("/nonexistent/libtcmalloc.so.4",))
    env, notes = serve.hardened_env({})
    assert "LD_PRELOAD" not in env and notes == ["tcmalloc absent (preload skipped)"]


def test_hardened_env_reexecs_once():
    env = {k: v for k, v in ENV.items() if k != "_REPRO_HARDENED_ENV"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--hardened-env", "--mode", "daemon",
         "--device", "cpu", "--sensors", "16", "--fields", "2", "--ticks", "1"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    notes = [ln for ln in out.stdout.splitlines() if ln.startswith("hardened-env: ")]
    assert len(notes) == 1, out.stdout  # the re-exec'd process does not re-exec
    have = next((p for p in serve._TCMALLOC_PATHS if os.path.exists(p)), None)
    want = f"tcmalloc={have}" if have else "tcmalloc absent (preload skipped)"
    assert notes[0] == "hardened-env: " + want
    assert sum("daemon_health/1" in ln for ln in out.stdout.splitlines()) == 1


def test_guard_set_means_no_reexec(monkeypatch):
    def no_exec(*a):
        raise AssertionError("re-exec'd with the guard set")

    monkeypatch.setattr(serve.os, "execve", no_exec)
    monkeypatch.setenv("_REPRO_HARDENED_ENV", "1")
    d = serve.main(["--hardened-env", "--mode", "daemon", "--device", "cpu", "--sensors", "16",
                    "--fields", "2", "--ticks", "1"])
    assert d.tick_count == 1
