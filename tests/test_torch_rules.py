"""The port's rules: no JAX, an explicit device, no fallback from a kernel."""

import ast
import inspect
import os

import numpy as np
import pytest
import torch

import repro_torch.core as tr
from repro_torch import checkpoint, convert, data, distributed, models, optim, tree
from repro_torch.configs import (get_config, jamba_1_5_large_398b, qwen2_vl_2b,
                                  whisper_tiny)
from repro_torch.kernels import _build, color_step, gram, kernel_matvec, knn_fuse, ssd_intra
from repro_torch.core import consensus, pruning, sop
from repro_torch.data import lm
from repro_torch.launch import (daemon, multi_gpu, profile_field, profile_lm, profile_train,
                                serve, train)
from repro_torch.optim import optimizers, schedules
from repro_torch import analysis, sharding
from repro_torch.sharding import rules as sharding_rules
from repro_torch.sharding import serve as sharding_serve
from repro_torch.sharding import steps as sharding_steps
from repro_torch.analysis import (alive_audit, ast_lint, dtype_audit, entries, launch_ledger,
                                  report, sync_audit)

# the modules of the multi-device and training slice, and of the sharding slices
TRAIN_SLICE = (sop, consensus, distributed, tree, optim, optimizers, schedules, data, lm,
               train, profile_train, multi_gpu, models.model, sharding, sharding_rules,
               sharding_steps, sharding_serve)

# the modules of the hybrid, VLM and encoder-decoder slice
MODEL_SLICE = (models.encdec, models.transformer, models.layers, convert, jamba_1_5_large_398b,
               qwen2_vl_2b, whisper_tiny)

# the modules of the audit slice
ANALYSIS = (analysis, report, ast_lint, launch_ledger, dtype_audit, alive_audit, sync_audit,
            entries)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_never_imports_jax_or_the_reference():
    files = _port_files()
    assert len(files) > 10
    for mod in (pruning, daemon) + TRAIN_SLICE + ANALYSIS + MODEL_SLICE:  # later slices' too
        assert os.path.abspath(mod.__file__) in files
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


_POS = np.random.default_rng(0).uniform(-1, 1, size=(8, 2)).astype(np.float32)
ENTRY_POINTS = {
    "build_topology": lambda: tr.build_topology(_POS, 0.8),
    "ring_topology": lambda: tr.ring_topology(6),
    "make_problem": lambda: tr.make_problem(
        tr.build_topology(_POS, 0.8, device="cpu"), tr.Kernel(), np.zeros(8)),
    "make_batch_problem": lambda: tr.make_batch_problem(
        tr.build_topology(_POS, 0.8, device="cpu"), tr.Kernel(), np.zeros((2, 8))),
    "fit_krr": lambda: tr.fit_krr(_POS, np.zeros(8), tr.Kernel(), 0.1),
    "state_from_numpy": lambda: convert.state_from_numpy(
        {"z": np.zeros(3), "coef": np.zeros((2, 2))}),
    "serve.main": lambda: serve.main(["--fields", "2", "--sensors", "8"]),
    "serve.main stream": lambda: serve.main(["--fields", "2", "--sensors", "8", "--stream", "4"]),
    "serve.main churn": lambda: serve.main(["--fields", "2", "--sensors", "8", "--churn", "2"]),
    "serve.main faults": lambda: serve.main(["--fields", "2", "--sensors", "8",
                                             "--faults", "drop=0.1"]),
    "serve.main daemon": lambda: serve.main(["--mode", "daemon", "--fields", "2",
                                             "--sensors", "8", "--ticks", "1"]),
    "serve.main energy_tau": lambda: serve.main(["--fields", "2", "--sensors", "8", "--fusion",
                                                 "knn", "--energy_tau", "0.1"]),
    "daemon.main": lambda: daemon.main(["--fields", "2", "--sensors", "8", "--ticks", "1"]),
    "make_fault_model": lambda: tr.make_fault_model(0.1),
    "parse_fault_spec": lambda: tr.faults.parse_fault_spec("drop=0.1"),
    "models.init_params": lambda: models.init_params(get_config("mamba2-370m", variant="smoke")),
    "models.init_params dense": lambda: models.init_params(
        get_config("smollm-135m", variant="smoke")),
    "models.init_params moe": lambda: models.init_params(
        get_config("qwen3-moe-30b-a3b", variant="smoke")),
    "models.init_params hybrid": lambda: models.init_params(
        get_config("jamba-1.5-large-398b", variant="smoke")),
    "models.init_params vlm": lambda: models.init_params(
        get_config("qwen2-vl-2b", variant="smoke")),
    "models.init_params encdec": lambda: models.init_params(
        get_config("whisper-tiny", variant="smoke")),
    "models.init_cache encdec": lambda: models.init_cache(
        get_config("whisper-tiny", variant="smoke"), 1, 4),
    "serve.main lm vlm": lambda: serve.main(["--mode", "lm", "--arch", "qwen2-vl-2b",
                                             "--batch", "1", "--prompt_len", "4", "--gen", "1"]),
    "serve.main lm": lambda: serve.main(["--mode", "lm", "--variant", "smoke", "--batch", "1",
                                         "--prompt_len", "4", "--gen", "1"]),
    "profile_lm.main": lambda: profile_lm.main([]),
    "profile_field.main": lambda: profile_field.main([]),
    "train.main": lambda: train.main(["--variant", "smoke", "--steps", "1"]),
    "profile_train.main": lambda: profile_train.main([]),
    "multi_gpu.main": lambda: multi_gpu.main([]),
    "distributed.init_group": lambda: distributed.init_group(0, 1),
    "distributed.rank_device": lambda: distributed.rank_device(0),
    "distributed.spawn": lambda: distributed.spawn(print, 2),
    "analysis.canonical": lambda: entries.canonical(),
    "analysis.dtype_audit": lambda: dtype_audit.run(),
    "analysis.alive_audit": lambda: alive_audit.run(),
    "analysis.sync_audit": lambda: sync_audit.run(),
    "analysis.run_auditor": lambda: analysis.run_auditor("alive"),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available, so the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name]()


def _fail(*a, **k):
    raise AssertionError("a non-CPU tensor reached the plain version")


def test_non_cpu_tensors_never_reach_the_plain_versions(monkeypatch):
    """A tensor that is not on the CPU launches the kernel or raises."""
    monkeypatch.setattr(color_step, "color_step_ref", _fail)
    monkeypatch.setattr(color_step, "color_sweep_ref", _fail)
    monkeypatch.setattr(knn_fuse, "knn_fuse_ref", _fail)
    monkeypatch.setattr(kernel_matvec, "kernel_matvec_ref", _fail)
    monkeypatch.setattr(ssd_intra, "ssd_intra_ref", _fail)
    monkeypatch.setattr(gram, "rbf_gram_ref", _fail)
    meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device="meta")  # noqa
    b, r, d, nz, m = 2, 5, 3, 9, 2
    with pytest.raises(ValueError, match="cpu or cuda"):
        color_step.color_step(
            meta(b, nz), meta(b, r, d), meta(r, d, dt=torch.int32),
            meta(b, r, d, dt=torch.bool), meta(b, r, d, d), meta(b, r, d, d), meta(r),
            meta(r, dt=torch.bool), meta(nz, dt=torch.bool), meta(m, dt=torch.int32),
            meta(m, dt=torch.bool),
        )
    with pytest.raises(ValueError, match="cpu or cuda"):
        color_step.color_sweep(
            meta(b, nz), meta(b, r, d), meta(r, d, dt=torch.int32),
            meta(b, r, d, dt=torch.bool), meta(b, r, d, d), meta(b, r, d, d), meta(r),
            meta(r, dt=torch.bool), meta(nz, dt=torch.bool), meta(3, m, dt=torch.int32),
            meta(3, m, dt=torch.bool), meta(4, r, d, dt=torch.bool), 4,
        )
    with pytest.raises(ValueError, match="cpu or cuda"):
        knn_fuse.knn_fuse_fused(
            meta(4, 2), meta(4, dt=torch.int32), meta(3, 5, dt=torch.int32),
            meta(3, 5, dt=torch.bool), meta(r, 2), meta(b, r, d, 2),
            meta(b, r, d, dt=torch.bool), meta(b, r, d), k=2,
        )
    with pytest.raises(ValueError, match="cpu or cuda"):
        kernel_matvec.kernel_matvec_batched(meta(4, 2), meta(7, 2), meta(b, 7), gamma=1.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ssd_intra.ssd_intra(meta(1, 8, 2, 4), meta(1, 8, 2), meta(1, 8, 2), meta(1, 8, 3),
                            meta(1, 8, 3), chunk=4)
    with pytest.raises(ValueError, match="cpu or cuda"):
        gram.rbf_gram(meta(4, 2), meta(7, 2), gamma=1.0)
    assert color_step.launches == knn_fuse.launches == kernel_matvec.launches == 0
    assert ssd_intra.launches == gram.launches == 0


def test_missing_nvcc_raises_and_names_it(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


@pytest.mark.parametrize("flag", [["--churn", "2", "--energy_tau", "0.1"],
                                  ["--faults", "drop=0.1", "--energy_tau", "0.1"],
                                  ["--energy_tau", "0.1"], ["--mode", "daemon"]])
def test_unported_launcher_features_refuse(flag):
    """Named when the port refused these launcher features.  Now that
    ``--energy_tau`` and ``--mode daemon`` are ported, they run on the CPU
    when asked for, and refuse only the default device on a machine
    without CUDA."""
    argv = ["--fields", "2", "--sensors", "8"] + flag
    if flag[0] != "--mode":
        argv += ["--fusion", "knn", "conn"]
    out = serve.main(["--device", "cpu"] + argv)
    if flag[0] == "--mode":
        assert isinstance(out, daemon.Daemon) and out.tick_count == 10
    else:
        assert out["prune"].energy_tau == 0.1 and out["knn"].shape == out["conn"].shape
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(argv)


def test_daemon_entry_points_default_to_the_card():
    assert daemon.DaemonConfig().engine == daemon.DaemonConfig().train_engine == "cuda"
    args = daemon.parser().parse_args([])
    assert args.device == "cuda" and args.engine == "cuda"
    assert serve.parser().parse_args([]).device == "cuda"


def test_lifecycle_entry_points_stay_on_the_problems_device():
    """add_sensor, remove_sensor and robust_sweep take their device from the
    problem: every tensor they return lies where the problem lies."""
    pos = np.random.default_rng(0).uniform(-1, 1, size=(10, 1)).astype(np.float32)
    topo = tr.build_topology(pos, 0.8, d_max=9, n_max=12, device="cpu")
    prob = tr.make_batch_problem(topo, tr.Kernel(), np.zeros((2, 10)),
                                 np.full((10,), 0.1, np.float32), device="cpu")
    state = tr.init_state(prob)
    prob, state, rec = tr.add_sensor(prob, state, np.zeros(1), np.ones(2))
    prob, state, ok = tr.remove_sensor(prob, state, 3)
    out = tr.robust_sweep(prob, state, np.ones(prob.n, bool), n_sweeps=1, engine="cuda")
    tensors = [v for v in rec] + [ok, out.z, out.coef, state.z, state.coef]
    tensors += [v for v in vars(prob).values() if isinstance(v, torch.Tensor)]
    assert bool(rec.joined) and bool(ok)
    assert all(t.device.type == "cpu" for t in tensors)


def test_fault_entry_points_stay_on_the_problems_device(tmp_path):
    """faulty_sweep, watch_sweeps and restore_train take their device from
    the problem (the template): every tensor they return lies there."""
    pos = np.random.default_rng(0).uniform(-1, 1, size=(10, 1)).astype(np.float32)
    prob = tr.make_batch_problem(tr.build_topology(pos, 0.8, device="cpu"), tr.Kernel(),
                                 np.zeros((2, 10)), np.full((10,), 0.1, np.float32),
                                 device="cpu")
    state = tr.init_state(prob)
    model = tr.faults.parse_fault_spec("drop=0.1,crash=0.1:0.5", device="cpu")
    out = tr.faulty_sweep(prob, state, model, torch.Generator(), 2, engine="cuda")
    prob2, state2, _ = tr.watch_sweeps(prob, state, model=model, generator=torch.Generator(),
                                       engine="cuda", snapshot_dir=str(tmp_path))
    p3, s3 = checkpoint.restore_train(str(tmp_path), 0, prob2, state2)
    tensors = [out.z, out.coef, state2.z, state2.coef, s3.z, s3.coef]
    tensors += [v for p in (prob2, p3) for v in vars(p).values() if isinstance(v, torch.Tensor)]
    assert all(t.device.type == "cpu" for t in tensors)


def test_new_entry_points_default_to_the_card():
    """Every function of the training slice that takes ``device=`` defaults
    to "cuda"; the launcher's flag too."""
    seen = []
    for mod in TRAIN_SLICE + ANALYSIS:
        for name, fn in vars(mod).items():
            public = inspect.isfunction(fn) and not name.startswith("_")
            if public and fn.__module__ == mod.__name__:
                param = inspect.signature(fn).parameters.get("device")
                if param is not None:
                    assert param.default == "cuda", f"{mod.__name__}.{name}"
                    seen.append(name)
    assert {"init_group", "rank_device", "spawn", "canonical", "run"} <= set(seen)
    for launcher in (train, multi_gpu):
        assert launcher.parser().parse_args([]).device == "cuda"
        assert launcher.parser().parse_args([]).world is None


_GUARDED = {"all_to_all_single", "all_reduce", "all_gather_into", "all_gather_into_tensor",
            "all_gather_single", "barrier", "init_process_group", "color_sweep",
            "color_step", "knn_fuse_fused", "kernel_matvec_batched", "ssd_intra", "rbf_gram",
            "sharded_sweep", "pairwise_project", "gossip_round", "allreduce_average",
            "neighborhood_average", "consensus_sq_distance"}


def test_no_try_around_a_collective_or_a_kernel_call():
    """The training slice's modules hold no ``try`` at all; in the whole port
    no ``try`` body calls a collective or a kernel wrapper."""
    slice_files = {os.path.abspath(mod.__file__) for mod in TRAIN_SLICE}
    for path in _port_files():
        with open(path) as fh:
            tree_ = ast.parse(fh.read(), path)
        for node in ast.walk(tree_):
            if not isinstance(node, ast.Try):
                continue
            assert path not in slice_files, f"{path}:{node.lineno}: a try in the slice"
            for sub in (n for stmt in node.body for n in ast.walk(stmt)):
                if isinstance(sub, ast.Call):
                    f = sub.func
                    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
                    assert name not in _GUARDED, f"{path}:{sub.lineno}: try around {name}"
