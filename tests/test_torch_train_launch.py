"""The port's training launcher (``python -m repro_torch.launch.train``) on
the CPU with 2 gloo ranks, beside the reference's launcher on 2 forced host
devices (``tests/test_system.py:114``'s run, on ``mamba2-370m``): the same
line shapes, then ``done``; a ``--ckpt_dir`` restart resumes at its saved
step with the replicas' parameters and optimizer state bitwise those of
the uninterrupted run; each decoder config trains through the launcher at
its smoke variant (tokens only, as the reference's launcher feeds them);
the encoder-decoder, which the launcher has no frames for, is refused
before any process starts."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.configs import ARCH_NAMES
from repro_torch.launch import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--arch", "mamba2-370m", "--variant", "smoke", "--batch", "4", "--seq", "32",
         "--log_every", "1"]


def _shape(line: str) -> str:
    """A printed line with its numbers and the arch's name blanked."""
    return re.sub(r"-?\d+(\.\d+)?(e[-+]\d+)?", "#", line.replace("mamba2-370m-smoke", "ARCH"))


def test_launcher_prints_the_reference_lines_and_done():
    env = dict(os.environ, PYTHONPATH="src")
    ref = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", *FLAGS, "--steps", "3",
         "--dp_mode", "sop_gossip"],
        cwd=ROOT, env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *FLAGS, "--steps", "3",
         "--dp_mode", "sop_gossip", "--device", "cpu", "--world", "2"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    ref_out, ref_err = ref.communicate(timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert ref.returncode == 0, ref_err[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "arch=mamba2-370m-smoke params=0.3M devices=2 dp=sop_gossip"
    assert lines[-1] == "done"
    steps = [ln for ln in lines if ln.startswith("step")]
    assert len(steps) == 3 and all("consensus_sq=" in ln and "s/step)" in ln for ln in steps)
    assert [_shape(ln) for ln in lines] == [_shape(ln) for ln in ref_out.strip().splitlines()]
    losses = [float(re.search(r"loss=(\S+)", ln).group(1)) for ln in steps]
    assert all(np.isfinite(losses))


def _run(capfd, ckpt_dir: str, *extra: str) -> str:
    capfd.readouterr()
    train.main([*FLAGS, "--steps", "4", "--dp_mode", "allreduce", "--device", "cpu",
                "--world", "2", "--ckpt_every", "2", "--ckpt_dir", ckpt_dir, *extra])
    return capfd.readouterr().out


def test_ckpt_restart_resumes_bitwise(tmp_path, capfd):
    full, resumed = str(tmp_path / "full"), str(tmp_path / "resumed")
    printed = _run(capfd, full)
    assert "restored" not in printed and printed.strip().endswith("done")
    os.makedirs(resumed)
    shutil.copytree(os.path.join(full, "step_00000002"), os.path.join(resumed, "step_00000002"))
    printed = _run(capfd, resumed)
    assert "restored step 2" in printed
    assert [ln.split()[1] for ln in printed.splitlines() if ln.startswith("step")] == ["3", "4"]
    with np.load(os.path.join(full, "step_00000004", "arrays.npz")) as a, \
            np.load(os.path.join(resumed, "step_00000004", "arrays.npz")) as b:
        assert a.files == b.files and len(a.files) == 3 * 20 + 1
        for key in a.files:
            assert np.array_equal(a[key], b[key]), key
        assert a["leaf_00000"].shape[0] == 2  # one replica per rank
        assert np.array_equal(a["leaf_00000"][0], a["leaf_00000"][1])  # allreduce


DENSE = ["smollm-135m", "internlm2-1.8b", "nemotron-4-15b", "qwen1.5-32b"]
MOE = ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"]
HYBRID = ["jamba-1.5-large-398b"]  # Mamba2 and attention layers, MoE after both
VLM = ["qwen2-vl-2b"]  # fed tokens only: no patch prefix


def test_encoder_decoder_is_refused_before_any_process_starts(monkeypatch):
    """The reference's launcher feeds tokens only, so it cannot train
    whisper-tiny; the port's says so with a ValueError and spawns nothing."""
    monkeypatch.setattr(train.distributed, "spawn", _no_spawn)
    monkeypatch.setattr(train.distributed, "init_group", _no_spawn)
    assert "whisper-tiny" in ARCH_NAMES
    with pytest.raises(ValueError, match="encoder-decoder.*frames"):
        train.main(["--arch", "whisper-tiny", "--device", "cpu", "--world", "2"])


def _no_spawn(*a, **k):
    raise AssertionError("a process group was started")


@pytest.mark.parametrize("arch", DENSE + MOE + HYBRID + VLM)
def test_dense_archs_train_through_the_launcher(arch, capfd):
    capfd.readouterr()
    out = train.main(["--arch", arch, "--variant", "smoke", "--steps", "2", "--batch", "4",
                      "--seq", "16", "--log_every", "1", "--device", "cpu", "--world", "1"])
    lines = capfd.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"arch={arch}-smoke params=") and lines[-1] == "done"
    assert len([ln for ln in lines if ln.startswith("step")]) == 2
    assert np.isfinite(out["loss"]) and np.isfinite(out["ce"])
    if arch in MOE + HYBRID:  # the router terms are in the loss
        assert np.isfinite(out["aux_loss"]) and np.isfinite(out["z_loss"])
        assert out["loss"] > out["ce"]


def test_world_and_batch_are_checked():
    with pytest.raises(ValueError, match="--world must be given on the CPU"):
        train.main(["--device", "cpu"])
    with pytest.raises(ValueError, match="must divide over 3 ranks"):
        train.main(["--device", "cpu", "--world", "3", "--batch", "8"])



@pytest.mark.parametrize("arch", ["qwen1.5-32b", "mamba2-370m"])
def test_profile_train_rehearses_its_windows_on_the_cpu(arch, capfd):
    """``profile_train`` at the smoke variant on the CPU, depth cut to one
    block: qwen1.5-32b sets ``remat``, so its forward and backward is
    profiled with and without it; mamba2-370m does not.  No device time on
    the CPU: "not measured", and no recompute share."""
    from repro_torch.configs import get_config
    from repro_torch.launch import profile_train

    block = get_config(arch, variant="smoke").block_len
    capfd.readouterr()
    out = profile_train.main(["--arch", arch, "--variant", "smoke", "--layers", str(block),
                              "--batch", "2", "--seq", "32", "--device", "cpu"])
    lines = capfd.readouterr().out.strip().splitlines()
    remat = arch == "qwen1.5-32b"
    windows = ["forward_backward", "optimizer", "gossip"]
    if remat:
        windows.insert(1, "forward_backward_no_remat")
    assert [ln.split(":")[0] for ln in lines if ln.split(":")[0] in out] == windows
    assert (out["arch"], out["layers"], out["batch"], out["seq"]) == (
        f"{arch}-smoke", block, 2, 32)
    assert out["remat"] == ("full" if remat else None)
    for key in windows:
        assert out[key]["device_ms"] is None and out[key]["wall_ms"] > 0
        assert "device not measured" in next(ln for ln in lines if ln.startswith(key + ":"))
    assert ("recompute_share" in out) == remat and out.get("recompute_share") is None
    assert lines[-1].startswith("{")
