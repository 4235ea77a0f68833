"""The port's trainer launcher (``repro_torch.launch.train``) on the CPU at
``qwen2-0.5b`` smoke width: the loss falls, a run with an injected
failure ends on a clean run's state bit for bit, and what it cannot run
raises."""

import pytest
import torch

from repro_torch.launch import train

SMALL = ["--device", "cpu", "--seq-len", "32", "--global-batch", "4"]


def test_loss_falls_on_the_cpu_smoke_run(capsys):
    losses = train.main(SMALL + ["--steps", "12"])
    assert len(losses) == 12
    assert losses[-1] < 0.8 * losses[0]
    out = capsys.readouterr().out
    assert "qwen2-0.5b-smoke, cpu, backend torch" in out


def test_failure_recovery_matches_a_clean_run(tmp_path):
    clean = train.main(SMALL + ["--steps", "8", "--ckpt-dir",
                                str(tmp_path / "clean")])
    failed = train.main(SMALL + ["--steps", "8", "--ckpt-every", "4",
                                 "--inject-failure-at", "5", "--ckpt-dir",
                                 str(tmp_path / "failed")])
    # steps 0-4, the failure at 5, the restore of step 4, steps 4-7 again
    assert len(failed) == 9
    assert failed[:5] == clean[:5] and failed[5:] == clean[4:]
    assert sorted(p.name for p in (tmp_path / "failed").glob("step_*")) == \
        ["step_00000004", "step_00000008"]
    assert not list((tmp_path / "clean").glob("step_*"))


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train.main(["--steps", "1"])


def test_what_the_port_cannot_train_raises():
    with pytest.raises(KeyError, match="not ported yet"):
        train.main(SMALL + ["--arch", "qwen2-moe-a2.7b", "--steps", "1"])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        train.main(SMALL + ["--backend", "cuda", "--steps", "1"])
    with pytest.raises(SystemExit):
        train.main(SMALL + ["--multi-pod"])
