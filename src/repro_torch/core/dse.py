"""Design-space exploration (§III–§IV): sweeps, and the statistics of
Tables 1–4 (equations (2)–(5)).

The PyTorch port of ``repro.core.dse``.  The sweeps evaluate every
network against the whole grid in one call to
:func:`repro_torch.core.energymodel.evaluate_networks` on ``device`` (the
card by default), the streaming wrappers through its streamed reductions;
the statistics are numpy on the host, as in the reference, over the
arrays the engine returns.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from .accelerator import (ARRAY_SIZES, GB_SIZES_KB, AcceleratorConfig,
                          ConfigGrid)
from . import energymodel
from .topology import Layer


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Energy / latency over the full (array × psum × ifmap) grid."""

    network: str
    arrays: Tuple[Tuple[int, int], ...]
    psum_kb: Tuple[int, ...]
    ifmap_kb: Tuple[int, ...]
    energy: np.ndarray      # [n_array, n_psum, n_ifmap]
    latency: np.ndarray     # [n_array, n_psum, n_ifmap]

    @property
    def edp(self) -> np.ndarray:
        return self.energy * self.latency

    def metric(self, name: str = "edp") -> np.ndarray:
        return self.edp if name == "edp" else getattr(self, name)

    def argmin_cell(self, metric: str = "edp") -> Tuple[int, int, int]:
        arr = self.metric(metric)
        return tuple(np.unravel_index(int(np.argmin(arr)), arr.shape))

    def cell_label(self, cell: Tuple[int, int, int]) -> str:
        a, p, i = cell
        return (f"({self.psum_kb[p]}/{self.ifmap_kb[i]}, "
                f"[{self.arrays[a][0]},{self.arrays[a][1]}])")


def _paper_grid(arrays, psum_kb, ifmap_kb,
                base: AcceleratorConfig | None) -> ConfigGrid:
    return ConfigGrid.product(arrays=arrays, gb_psum_kb=psum_kb,
                              gb_ifmap_kb=ifmap_kb, base=base)


def sweep_networks(networks: Mapping[str, Sequence[Layer]],
                   arrays: Sequence[Tuple[int, int]] = ARRAY_SIZES,
                   psum_kb: Sequence[int] = GB_SIZES_KB,
                   ifmap_kb: Sequence[int] = GB_SIZES_KB,
                   base: AcceleratorConfig | None = None,
                   *,
                   device=None,
                   backend: str | None = None,
                   chunk_size: int | None = None) -> Dict[str, SweepResult]:
    """Sweep every network over the whole grid in one engine call.

    ``device``, ``backend`` and ``chunk_size`` forward to
    :func:`repro_torch.core.energymodel.evaluate_networks`."""
    grid = _paper_grid(arrays, psum_kb, ifmap_kb, base)
    e, t = energymodel.evaluate_networks(grid, networks, device=device,
                                         backend=backend,
                                         chunk_size=chunk_size)
    shape = (len(arrays), len(psum_kb), len(ifmap_kb))
    out = {}
    for j, name in enumerate(networks):
        out[name] = SweepResult(
            network=name, arrays=tuple(arrays), psum_kb=tuple(psum_kb),
            ifmap_kb=tuple(ifmap_kb), energy=e[:, j].reshape(shape),
            latency=t[:, j].reshape(shape))
    return out


def layer_metrics(networks: Mapping[str, Sequence[Layer]],
                  grid: ConfigGrid | None = None,
                  **kwargs) -> Tuple[np.ndarray, np.ndarray]:
    """Per-layer energy/latency tensors over a grid (default: the paper's
    150-point space): ``evaluate_networks(..., per_layer=True)`` →
    ``[n_cfg, n_net, n_layer]`` pairs, zero-padded past each network's
    length (:func:`energymodel.network_layer_counts`).  Keyword arguments
    forward to :func:`energymodel.evaluate_networks` (``device``,
    ``backend``, ``chunk_size``)."""
    if grid is None:
        grid = _paper_grid(ARRAY_SIZES, GB_SIZES_KB, GB_SIZES_KB, None)
    return energymodel.evaluate_networks(grid, networks, per_layer=True,
                                         **kwargs)


def stream_layer_grid(networks: Mapping[str, Sequence[Layer]],
                      grid: ConfigGrid,
                      **kwargs) -> "energymodel.LayerTopK":
    """Streaming PER-LAYER sweep of an arbitrary ConfigGrid: one chunked
    pass folds every chunk into running reductions on the device —
    per-network top-k configs with their ``[n_layer]`` energy/latency
    rows, aggregate and per-(network, layer) minima, and (with ``bound=``)
    the ≤bound boundary candidate sets — without materialising the
    ``[n_cfg, n_net, n_layer]`` tensors.  Keyword arguments forward to
    :func:`energymodel.stream_layer_topk` (``device``, ``backend``,
    ``topk``, ``bound``, ``chunk_size``, ``metric``, ...)."""
    return energymodel.stream_layer_topk(grid, networks, **kwargs)


def stream_grid(networks: Mapping[str, Sequence[Layer]],
                grid: ConfigGrid,
                **kwargs) -> "energymodel.StreamResult":
    """Streaming sweep of an arbitrary ConfigGrid: chunked evaluation with
    running reductions on the device (per-network minima, top-k cells, and
    the ≤bound boundary sets that
    :func:`repro_torch.core.hetero.design_chip_streaming` consumes) — the
    full [n_cfg, n_net] matrices are never materialised.  Keyword
    arguments forward to :func:`energymodel.stream_networks` (``device``,
    ``backend``, ``chunk_size``, ``bound``, ``metric``, ``topk``, ...)."""
    return energymodel.stream_networks(grid, networks, **kwargs)


def sweep_network(layers: Sequence[Layer], network: str = "net",
                  arrays: Sequence[Tuple[int, int]] = ARRAY_SIZES,
                  psum_kb: Sequence[int] = GB_SIZES_KB,
                  ifmap_kb: Sequence[int] = GB_SIZES_KB,
                  base: AcceleratorConfig | None = None,
                  *,
                  device=None,
                  backend: str | None = None) -> SweepResult:
    """Single-network sweep (thin wrapper over :func:`sweep_networks`)."""
    return sweep_networks({network: layers}, arrays=arrays, psum_kb=psum_kb,
                          ifmap_kb=ifmap_kb, base=base, device=device,
                          backend=backend)[network]


# ---------------------------------------------------------------------------
# Tables 1–2: sweep one GB partition with the other held at the 25-point
# minimum's value (equations (2) and (3)), vectorised over the array axis.
# ---------------------------------------------------------------------------

def mu_delta(sweep: SweepResult, swept: str = "ifmap"
             ) -> Dict[Tuple[int, int], Tuple[float, float]]:
    """μ^p_min and δ^max_min per array size, for the swept partition.

    ``swept='ifmap'`` reproduces Table 1 (GB_psum held at the value of the
    per-array minimum); ``swept='psum'`` reproduces Table 2.
    """
    e = sweep.energy                              # [nA, nP, nI]
    n_a, n_p, n_i = e.shape
    flat = e.reshape(n_a, -1)
    p_min, i_min = np.unravel_index(np.argmin(flat, axis=1), (n_p, n_i))
    ar = np.arange(n_a)
    if swept == "ifmap":
        lines = e[ar, p_min, :]                   # [nA, nI]
    else:
        lines = e[ar, :, i_min]                   # [nA, nP]
    e_min = lines.min(axis=1, keepdims=True)
    n = lines.shape[1]
    mu = ((lines - e_min) / e_min * 100.0).sum(axis=1) / (n - 1)
    delta = ((lines.max(axis=1, keepdims=True) - e_min)
             / e_min * 100.0)[:, 0]
    return {arr: (float(mu[a]), float(delta[a]))
            for a, arr in enumerate(sweep.arrays)}


def delta_whole_space(sweep: SweepResult) -> Dict[Tuple[int, int], float]:
    """Table 3: Δ^max_min over the (psum × ifmap) points per array."""
    flat = sweep.energy.reshape(len(sweep.arrays), -1)
    mn, mx = flat.min(axis=1), flat.max(axis=1)
    d = (mx - mn) / mn * 100.0
    return {arr: float(d[a]) for a, arr in enumerate(sweep.arrays)}


def edp_spread(sweep: SweepResult) -> Tuple[float, float]:
    """Table 4: mean and max of (EDP_i − EDP_min)/EDP_min over all points."""
    edp = sweep.edp.ravel()
    edp_min = float(edp.min())
    rel = (edp - edp_min) / edp_min * 100.0
    return float(rel.mean()), float(rel.max())


def boundary_configs(sweep: SweepResult, bound: float = 0.05,
                     metric: str = "edp") -> List[Tuple[int, int, int]]:
    """Table 5: all cells within ``bound`` of the minimum (min cell first)."""
    arr = sweep.metric(metric)
    mn = float(arr.min())
    cells = np.argwhere(arr <= mn * (1.0 + bound))
    vals = arr[tuple(cells.T)]
    order = np.argsort(vals, kind="stable")
    return [tuple(int(x) for x in cells[k]) for k in order]
