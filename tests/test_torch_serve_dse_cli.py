"""The port's DSE-service launcher (``repro_torch.launch.serve_dse``) on the
CPU, against the JAX package's (``repro.launch.serve_dse``, on its numpy
engine): the same seeded mix gives the same answers and the same health
counters; it prints ``drained=True`` under ``--chaos``, ``--fault-event``
and a ``--state-dir`` replay; ``--scrub`` audits the store;
``install_graceful`` drains and exits 0; and without ``--device cpu`` it
needs a card.  A small injected grid and a fake clock keep it fast."""

import json

import pytest
import torch

from repro.launch import serve_dse as ref_launch
from repro_torch.launch import serve_dse
from repro_torch.serving.dse_service import DSEService

from torch_service_pairs import (FakeClock, close, paired_networks,
                                 reference_on_numpy, small_grids)

NETS = ["--networks", "AlexNet", "MobileNet", "--chunk-size", "5"]


@pytest.fixture(scope="module")
def grids():
    return small_grids()


def _health(out: str) -> dict:
    """The launcher prints its lines, then one indented JSON object."""
    return json.loads(out[out.index("\n{") + 1:])


def _port(grids, args, capsys):
    clk = FakeClock()
    responses = serve_dse.main(["--device", "cpu"] + NETS + args,
                               clock=clk, sleep=clk.sleep, grid=grids[1])
    out = capsys.readouterr().out
    return responses, out, _health(out)


@pytest.mark.parametrize("args", [
    ["--requests", "6"],
    ["--requests", "5", "--seed", "3", "--fault-event"],
    ["--requests", "4", "--seed", "1", "--chaos", "0", "--fault-event"],
])
def test_same_answers_and_counters_as_reference(grids, capsys, args):
    responses, out, h = _port(grids, args, capsys)
    clk = FakeClock()
    with reference_on_numpy():
        ref = ref_launch.main(NETS + args + ["--backend", "numpy"],
                              clock=clk, sleep=clk.sleep, grid=grids[0])
    ref_out = capsys.readouterr().out
    ref_h = _health(ref_out)
    assert len(responses) == len(ref)
    for p, r in zip(responses, ref):
        assert (p.rid, p.kind, p.ok, p.degraded) == \
            (r.rid, r.kind, r.ok, r.degraded)
        close(p.answer, r.answer)
    assert h.keys() == ref_h.keys() - {"jit"}
    for k in h:
        if k not in ("uptime_s", "last_backend", "p50_s", "p99_s"):
            assert h[k] == ref_h[k], k
    first = [ln for ln in out.splitlines() if ln.startswith("served")]
    assert len(first) == 1 and first[0].endswith("drained=True")
    assert h["errors"] == 0 and h["backend_fallbacks"] == 0
    assert h["last_backend"] == "torch"
    if "--fault-event" in args:
        assert h["fault_events"] == 1 and h["reschedules"] == 1
        line = [ln for ln in out.splitlines()
                if ln.startswith("fault-event")]
        ref_line = [ln for ln in ref_out.splitlines()
                    if ln.startswith("fault-event")]
        assert line == ref_line and "ok=True" in line[0]


def test_state_dir_replays_then_scrubs(grids, tmp_path, capsys):
    """A killed earlier launch left an accepted request in the journal;
    the next launch replays it first, and ``--scrub`` audits the store."""
    _, pnets = paired_networks()
    dead = DSEService(grids[1], pnets, device="cpu", chunk_size=5,
                      state_dir=tmp_path)
    dead.submit("pareto", network="AlexNet", deadline=2.0)
    responses, out, h = _port(
        grids, ["--requests", "2", "--state-dir", str(tmp_path),
                "--scrub"], capsys)
    assert "replayed 1 unanswered requests" in out
    assert len(responses) == 3 and responses[0].kind == "pareto"
    assert all(r.ok for r in responses) and "drained=True" in out
    assert h["replayed"] == 1 and h["errors"] == 0
    scrub = [ln for ln in out.splitlines() if ln.startswith("scrub:")]
    assert len(scrub) == 1 and "0 quarantined" in scrub[0]
    assert h["scrub_entries"] >= 2 and h["store"]["n_entries"] >= 2


def test_install_graceful_drains_and_exits_zero(grids, tmp_path):
    _, pnets = paired_networks()
    svc = DSEService(grids[1], pnets, device="cpu", chunk_size=5,
                     state_dir=tmp_path)
    svc.submit("best_config")
    svc.submit("best_chip", deadline=2.0)
    handler = serve_dse.install_graceful(svc, signals=())
    with pytest.raises(SystemExit) as info:
        handler(None, None)
    assert info.value.code == 0
    assert svc.health()["queue_depth"] == 0 and len(svc.responses) == 2
    assert all(r.ok for r in svc.responses) and svc._journal is None
    assert not svc.submit("best_config").accepted
    again = DSEService(grids[1], pnets, device="cpu", chunk_size=5,
                       state_dir=tmp_path)
    assert again.stats["replayed"] == 0
    again.close()


def test_needs_a_card_unless_told_cpu(grids, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve_dse.main(NETS + ["--requests", "1"], grid=grids[1])
    with pytest.raises(SystemExit):
        serve_dse.main(["--device", "cpu", "--backend", "numpy"] + NETS,
                       grid=grids[1])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        serve_dse.main(["--device", "cpu", "--backend", "cuda"] + NETS,
                       grid=grids[1])
    with pytest.raises(KeyError):
        serve_dse.main(["--device", "cpu", "--networks", "NoSuchNet"],
                       grid=grids[1])
