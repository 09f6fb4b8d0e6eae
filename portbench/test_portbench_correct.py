"""The check that decides ``correct``, driven through whole runs at a small
size on the CPU: sound runs of the program pass; the control (the
reference in the program's place, one precision down) and each fault the
cells can have, planted under the timed path, fail."""

import pytest
import torch

from portbench import harness
from portbench._small import small_cell
from portbench.reference.precision import control

CPU = torch.device("cpu")
SEED = 2**31 + 17  # larger than 32 signed bits hold
CELLS = ["n1000-train", "paper-case2-train", "n1000-knn", "n1000-conn"]


def run(name, ctl=None):
    cell = small_cell(name)
    return harness.run_cell(cell, SEED, 0.2, False, CPU, control=ctl)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == set(res["readings"])
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small_cell(name)
    res = harness.run_cell(cell, SEED, 0.2, False, CPU, control=control(cell.config["dtype"]))
    assert not res["correct"], res["checks"]


def _state_unchanged(real):
    return lambda problem, state, n_sweeps=1, **kw: state


def _half_batch(real):
    def sweep(problem, state, n_sweeps=1, **kw):
        out = real(problem, state, n_sweeps, **kw)
        h = state.z.shape[0] // 2 or 1
        return type(out)(z=torch.cat([out.z[:h], state.z[h:]]),
                         coef=torch.cat([out.coef[:h], state.coef[h:]]))
    return sweep


@pytest.mark.parametrize("name", ["n1000-train", "paper-case2-train"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_train_fault_is_not_correct(monkeypatch, name, fault):
    from repro_torch.core import sn_train

    monkeypatch.setattr(sn_train, "colored_sweep", fault(sn_train.colored_sweep))
    assert not run(name)["correct"]


def _answer_altered(out):
    out = out.clone()
    out[0, -1] += 1e-2  # one answer of one field, where it is produced
    return out


def _half_fields(out):
    out = out.clone()
    out[out.shape[0] // 2:] = 0.0  # half of the batch left out
    return out


@pytest.mark.parametrize("fault", [_answer_altered, _half_fields])
def test_knn_fault_is_not_correct(monkeypatch, fault):
    from repro_torch.core import fusion

    real = fusion.fuse
    monkeypatch.setattr(fusion, "fuse", lambda *a, **kw: fault(real(*a, **kw)))
    assert not run("n1000-knn")["correct"]


@pytest.mark.parametrize("fault", [_answer_altered, _half_fields])
def test_conn_fault_is_not_correct(monkeypatch, fault):
    from repro_torch.kernels import ops

    real = ops.kernel_matvec
    monkeypatch.setattr(ops, "kernel_matvec", lambda *a, **kw: fault(real(*a, **kw)))
    assert not run("n1000-conn")["correct"]


def test_stale_answers_are_not_correct(monkeypatch):
    """A request that returns the same answers whatever it is asked."""
    from repro_torch.core import fusion

    real, first = fusion.fuse, {}

    def stale(problem, state, xq, *a, **kw):
        out = real(problem, state, xq, *a, **kw)
        first.setdefault("out", out.clone())
        q = min(out.shape[1], first["out"].shape[1])
        out[:, :q] = first["out"][:, :q]
        return out

    monkeypatch.setattr(fusion, "fuse", stale)
    assert not run("n1000-knn")["correct"]
