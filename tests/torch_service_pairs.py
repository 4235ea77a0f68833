"""Shared inputs and comparators of the port's fault-layer and service
tests (``tests/test_torch_{faults,verify,store,dse_service,
serve_dse_cli}.py``): the reference tests' 18-point grid and two networks
built in both packages, a fake clock, the switch that keeps the JAX
package on its numpy paths, and answer comparators (ints exact, floats
within a relative tolerance, tuples equal to lists)."""

import contextlib
import dataclasses

import pytest

from repro.core import accelerator as ref_acc
from repro.core import topology as ref_topo
from repro_torch.core import convert
from repro_torch.serving.dse_service import answer_diffs

NETS = ("AlexNet", "MobileNet")
#: Ints exact, floats within this relative tolerance (atol 0).
RTOL = 1e-12


def small_grids():
    """(reference grid, port grid): the reference tests' 18 points."""
    g = ref_acc.ConfigGrid.product(arrays=((16, 16), (32, 32), (64, 64)),
                                   gb_psum_kb=(13, 54, 216),
                                   gb_ifmap_kb=(27, 108))
    return g, convert.grid_from_fields(g.fields)


def paired_networks(names=NETS):
    """(reference networks, port networks) over the same layers."""
    ref = {n: ref_topo.get_network(n) for n in names}
    port = convert.networks_from_dicts(
        {n: [dataclasses.asdict(l) for l in v] for n, v in ref.items()})
    return ref, port


@contextlib.contextmanager
def reference_on_numpy():
    """The JAX package's service, co-design and slack solves pick their
    backend by ``jax_available()``, and its jax paths fail on this host's
    jax (``enable_x64``): switch the probes off for the block."""
    from repro.core import energymodel, partition
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(partition, "jax_available", lambda: False)
        mp.setattr(energymodel, "jax_available", lambda: False)
        yield


class FakeClock:
    """Deterministic service time: advances only when told to."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt

    def per_chunk_hook(self, seconds):
        def hook(ci, e, t):
            self.t += seconds
            return e, t
        return hook


def close(a, b, rtol=RTOL, path="answer"):
    """Assert ``a`` and ``b`` agree as
    :func:`repro_torch.serving.dse_service.answer_diffs` compares them:
    ints exact, floats within ``rtol``, a tuple equal to a list."""
    diffs = answer_diffs(a, b, rtol, path)
    assert not diffs, diffs[:5]


def same(a, b, path="answer"):
    """Bit-identical structure (tuple == list, NaN == NaN)."""
    close(a, b, 0.0, path)
