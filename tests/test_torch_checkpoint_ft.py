"""The port's checkpoint manager and fault-tolerance supervisor: every case
of ``tests/test_checkpoint_ft.py`` on the port, plus checkpoints of nested
dicts of arrays (bf16 included) written by one package and restored by
the other, both ways, bit for bit."""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.ft import FaultInjector, Preemption, Supervisor, WorkerFailure


def _state(x=0.0):
    return {"w": torch.full((4, 4), x), "step": torch.tensor(x)}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    st = _state(3.5)
    mgr.save(7, st, extra={"note": "hi"}, blocking=True)
    assert mgr.available() == [7]
    restored, extra = mgr.restore(st)
    assert torch.equal(restored["w"], st["w"])
    assert extra["note"] == "hi"


def test_atomic_commit_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (10, 20, 30, 40):
        mgr.save(s, _state(float(s)), blocking=True)
    assert mgr.available() == [30, 40]         # keep=2
    # partial directory without COMMITTED must be invisible
    (tmp_path / "step_00000050").mkdir()
    assert mgr.latest_step() == 40
    assert not list(tmp_path.glob(".tmp_*"))


def test_elastic_restore_dtype(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.ones(8)}, blocking=True)
    restored, _ = mgr.restore({"w": torch.zeros(8, dtype=torch.bfloat16)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].float(), torch.ones(8))


def test_save_copies_before_an_in_place_update(tmp_path):
    """The trainer's optimizer updates its tensors in place right after a
    save returns: the write must hold the values at the save."""
    mgr = CheckpointManager(tmp_path)
    st = _state(1.0)
    mgr.save(1, st)
    st["w"].add_(5.0)
    mgr.wait()
    restored, _ = mgr.restore(_state(0.0))
    assert torch.equal(restored["w"], torch.full((4, 4), 1.0))


def test_restore_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path).restore(_state())


def _run(tmp_path, injector=None, steps=20, every=5):
    mgr = CheckpointManager(tmp_path, keep=10)
    sup = Supervisor(mgr, checkpoint_every=every)
    trace = []

    def step_fn(state, step):
        new = {"w": state["w"] + 1.0, "step": state["step"] + 1.0}
        trace.append(float(new["w"].ravel()[0]))
        return new

    final = sup.run(state=_state(0.0), step_fn=step_fn, num_steps=steps,
                    injector=injector)
    return final, trace, sup


def test_supervisor_failure_recovery(tmp_path):
    inj = FaultInjector({12: "fail"})
    final, trace, sup = _run(tmp_path / "a", inj)
    # failure at 12 → restore from checkpoint 10 → final state identical to
    # an uninterrupted run
    clean, _, _ = _run(tmp_path / "b")
    assert torch.equal(final["w"], clean["w"])
    assert any(e.startswith("failure@12") for e in sup.events)
    assert "restore@10" in sup.events


def test_supervisor_gives_up_after_retries(tmp_path):
    sup = Supervisor(CheckpointManager(tmp_path), checkpoint_every=100,
                     max_retries_per_step=2)

    def step_fn(state, step):
        if step == 3:
            raise WorkerFailure("always")
        return state

    with pytest.raises(WorkerFailure):
        sup.run(state=_state(), step_fn=step_fn, num_steps=5)
    assert sum(e.startswith("failure@3") for e in sup.events) == 3


def test_supervisor_straggler_redispatch(tmp_path):
    inj = FaultInjector({15: "slow"}, slow_s=0.2)
    sup = Supervisor(CheckpointManager(tmp_path), checkpoint_every=100,
                     straggler_factor=3.0)

    def step_fn(state, step):
        inj.check(step)
        return {"w": state["w"] + 1.0, "step": state["step"] + 1.0}

    final = sup.run(state=_state(0.0), step_fn=step_fn, num_steps=20)
    # straggler step re-dispatched; state still exact
    assert float(final["w"].ravel()[0]) == 20.0
    assert any(e.startswith("straggler@") for e in sup.events)


class FakeClock:
    """Every ``clock()`` call advances a fixed tick, ``sleep(s)`` by s."""

    def __init__(self, tick=0.01):
        self.now = 0.0
        self.tick = tick

    def __call__(self):
        self.now += self.tick
        return self.now

    def sleep(self, s):
        self.now += s


def _run_clocked(tmp_path, plan, *, reexecute=True, steps=20,
                 factor=3.0, slow_s=1.0):
    clk = FakeClock()
    inj = FaultInjector(plan, slow_s=slow_s, sleep=clk.sleep)
    sup = Supervisor(CheckpointManager(tmp_path), checkpoint_every=100,
                     straggler_factor=factor,
                     reexecute_stragglers=reexecute, clock=clk)

    def step_fn(state, step):
        inj.check(step)
        return {"w": state["w"] + 1.0, "step": state["step"] + 1.0}

    final = sup.run(state=_state(0.0), step_fn=step_fn, num_steps=steps)
    return final, sup


def test_straggler_detection_is_deterministic(tmp_path):
    final, sup = _run_clocked(tmp_path, {15: "slow"})
    assert float(final["w"].ravel()[0]) == 20.0
    assert sup.stragglers and sup.stragglers[0][0] == 15
    step, dt, dt2 = sup.stragglers[0]
    assert dt > dt2
    assert dt == pytest.approx(1.0 + 0.01)
    ev = next(e for e in sup.events if e.startswith("straggler@15"))
    assert "->" in ev and f"{dt:.3f}s" in ev and f"{dt2:.3f}s" in ev


def test_straggler_samples_excluded_from_p50_window(tmp_path):
    burst = {s: "slow" for s in range(10, 16)}
    final, sup = _run_clocked(tmp_path, burst, reexecute=False)
    assert float(final["w"].ravel()[0]) == 20.0
    assert [s for s, _, _ in sup.stragglers] == list(range(10, 16))
    assert all(dt2 is None for _, _, dt2 in sup.stragglers)
    assert all("->" not in e for e in sup.events
               if e.startswith("straggler@"))


def test_straggler_reexecution_feeds_clean_sample(tmp_path):
    _, sup = _run_clocked(tmp_path, {8: "slow", 14: "slow"})
    assert [s for s, _, _ in sup.stragglers] == [8, 14]
    assert all(dt2 is not None and dt2 < dt
               for _, dt, dt2 in sup.stragglers)


def test_supervisor_wallclock_defaults():
    assert Supervisor.__dataclass_fields__["clock"].default \
        is time.perf_counter
    assert FaultInjector.__dataclass_fields__["sleep"].default \
        is time.sleep


def test_supervisor_preemption_checkpoints(tmp_path):
    inj = FaultInjector({8: "preempt"})
    mgr = CheckpointManager(tmp_path)
    sup = Supervisor(mgr, checkpoint_every=100)
    with pytest.raises(Preemption):
        sup.run(state=_state(0.0),
                step_fn=lambda s, i: {"w": s["w"] + 1, "step": s["step"] + 1},
                num_steps=20, injector=inj)
    assert mgr.latest_step() == 8
    restored, _ = mgr.restore(_state(0.0))
    assert float(restored["w"].ravel()[0]) == 8.0


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _arrays(seed):
    """Nested dicts (and a list) of numpy arrays: f32, int32, a scalar and
    bf16 values given as float32."""
    rng = np.random.default_rng(seed)
    return {"b": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                  "emb": rng.standard_normal((5, 2)).astype(np.float32)},
            "a": [rng.integers(-9, 9, 6).astype(np.int32),
                  np.float32(rng.standard_normal())],
            "step": np.int32(seed)}


def _jax_tree(a):
    t = jax.tree.map(jnp.asarray, a)
    t["b"]["emb"] = t["b"]["emb"].astype(jnp.bfloat16)
    return t


def _torch_tree(a):
    t = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), a)
    t["b"]["emb"] = t["b"]["emb"].to(torch.bfloat16)
    return t


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _torch_tree(_arrays(1))
    CheckpointManager(tmp_path).save(3, tree, extra={"data_step": 3},
                                     blocking=True)
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json")
                          .read_text())
    assert [m["dtype"] for m in manifest["leaves"]] == [
        "int32", "float32", "bfloat16", "float32", "int32"]
    restored, extra = RefManager(tmp_path).restore(_jax_tree(_arrays(0)))
    assert extra == {"data_step": 3}
    assert jax.tree.structure(restored) == jax.tree.structure(
        _jax_tree(_arrays(0)))
    assert restored["b"]["emb"].dtype == jnp.bfloat16
    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(
            {"a": tree["a"], "b": tree["b"], "step": tree["step"]})):
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _jax_tree(_arrays(2))
    RefManager(tmp_path).save(9, tree, blocking=True)
    target = _torch_tree(_arrays(0))
    restored, _ = CheckpointManager(tmp_path).restore(target)
    assert restored["b"]["emb"].dtype == torch.bfloat16
    assert restored["step"].dtype == torch.int32
    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(_bits(got), _bits(want))
