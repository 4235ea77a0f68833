"""The Tool (§II) and its batched design-space engine, on PyTorch.

The PyTorch port of ``repro.core.energymodel`` (the Tool and
``evaluate_networks``); that module's docstring describes the energy and
latency model.  Shapes and names follow the reference:

* a "config" is a dict of equal-length float64 columns
  (:class:`repro_torch.core.accelerator.ConfigGrid.fields`), a "layer
  struct" a dict of per-layer columns (``rs_mapping.layer_struct``);
* the heavy stage broadcasts ``[n_u, 1]`` config columns against
  ``[1, L]`` layer columns, where ``n_u`` is the two-level dedup of the
  grid: the RS mapping runs on the mapping-unique rows
  (``_MAPPING_COLUMNS``), the access counts on the count-unique rows
  (``_COUNT_COLUMNS``), and ``inv`` / ``inv_m`` gather back out;
* all networks share one concatenated layer axis padded to a multiple of
  256; ``segments`` holds each network's (start, stop) on it, and the 14
  count terms are summed per segment before the per-config coefficients
  are applied (``per_layer=True`` keeps the layer axis instead).

Where the work runs.  Building the config columns, the ``np.unique``
dedup and stacking the networks stay numpy on the host, as in the
reference.  Everything from the heavy stage on runs in torch on
``device``: float64 tensors throughout, because access counts exceed
float32's exact-integer range.  Two heavy-stage backends:

* ``"cuda"``: the hand-written kernels of ``src/repro_torch/csrc``
  (through :mod:`repro_torch.kernels.count_terms`): the aggregate kernel
  takes the same two-level operands, evaluates the mapping once per
  mapping-unique row and fuses the segment sum; the per-layer kernel
  evaluates it per count-unique row;
* ``"torch"``: the same arithmetic as plain torch operations.

With ``device=None`` the engine runs on ``"cuda"`` and raises when no card
is present; it never moves to the CPU on its own.  ``backend=None`` means
``"cuda"`` on a CUDA device and ``"torch"`` on the CPU; ``"cuda"`` with CPU
tensors raises.  Unlike the reference, there is no fallback chain: a
kernel that fails to build or launch raises, and :func:`last_backend`
reports what ran.

The reference pads the unique axes and every chunk to bucket multiples so
that jitted shapes repeat; eager torch and the CUDA kernels take any
shape, so the port does not.

Streaming (``stream_networks``, ``stream_layer_topk``): the grid in
chunks through the same heavy stage, each chunk folded into running
reductions on ``device`` (minima, top-k, boundary masks) in torch for both
backends, with the reference's resumable fold state, seams and
(value, flat index) tie-break, so results, hashes and exported states
agree with the reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..device import BACKENDS, resolve_backend, resolve_device  # noqa: F401
from .accelerator import AcceleratorConfig, ConfigGrid
from . import rs_mapping
from .topology import Layer

_POOL_OP_ENERGY = 0.2      # a pooling compare/add relative to a MAC

_F64 = torch.float64


def _mapping(cfg: Dict[str, Any], lay: Dict[str, Any]) -> Dict[str, Any]:
    """RS mapping over (configs × layers) from struct-of-arrays inputs."""
    return rs_mapping.mapping(
        rows=cfg["rows"], cols=cfg["cols"],
        c_ch=lay["c_ch"], m=lay["m"], ky=lay["ky"], kx=lay["kx"],
        stride=lay["stride"], ix=lay["ix"], iy=lay["iy"],
        oy=lay["oy"], ox=lay["ox"],
        is_acc=lay["is_acc"], is_dw=lay["is_dw"], is_pool=lay["is_pool"],
        gb_ifmap_words=cfg["gb_ifmap_words"],
        rf_ifmap_words=cfg["rf_ifmap_words"],
        rf_weight_words=cfg["rf_weight_words"],
        rf_psum_words=cfg["rf_psum_words"])


@dataclasses.dataclass(frozen=True)
class LayerReport:
    """Per-layer outputs of the Tool (§II.B.2)."""

    name: str
    energy: float            # pJ
    latency: float           # ns
    macs: float
    dram_reads: float
    dram_writes: float
    gb_reads: float
    gb_writes: float
    rf_accesses: float
    utilization: float       # active PEs / total PEs (compute-time weighted)
    mem_time: float          # ns spent on the memory hierarchy
    array_time: float        # ns spent computing in the array
    psum_spilled: float      # words of psum traffic that went to DRAM
    ifmap_refetched: float   # extra ifmap words re-read from DRAM


@dataclasses.dataclass(frozen=True)
class NetworkReport:
    name: str
    energy: float
    latency: float
    layers: List[LayerReport]

    @property
    def edp(self) -> float:
        return self.energy * self.latency

    @property
    def layer_latencies(self) -> np.ndarray:
        return np.array([l.latency for l in self.layers])

    @property
    def layer_energies(self) -> np.ndarray:
        return np.array([l.energy for l in self.layers])


def _counts(cfg: Dict[str, Any], lay: Dict[str, Any],
            mp: Dict[str, Any] | None = None) -> Dict[str, Any]:
    """Access counts + time terms; broadcast over (configs × layers).

    ``mp`` lets callers pass a precomputed RS mapping (the batched engine
    evaluates it on the smaller mapping-unique config set and gathers)."""
    if mp is None:
        mp = _mapping(cfg, lay)

    n_c, n_m = mp["n_c"], mp["n_m"]
    w_psum = mp["w_psum"]
    ky_serial = mp["ky_serial"]

    ifmap_vol = lay["ifmap_words"]
    ofmap = lay["ofmap_words"]
    weights = lay["weight_words"]
    macs = lay["macs"]
    pool = lay["is_pool"] != 0
    pool_ops = lay["c_ch"] * lay["ox"] * lay["oy"] * lay["kx"] * lay["ky"]

    # ifmap: every word streams DRAM→GB once; resident planes are
    # re-delivered GB→array for each of the n_m filter blocks.
    ifmap_dram_reads = ifmap_vol * torch.ones_like(n_m)
    ifmap_refetched = ifmap_vol * 0.0
    gb_ifmap_writes = ifmap_dram_reads                 # DRAM → GB
    gb_ifmap_reads = ifmap_vol * torch.where(lay["is_acc"] != 0, n_m, 1.0)

    # weights stream from DRAM once and land in the PE RFs once per phase.
    wt_dram_reads = weights
    gb_wt_writes = weights
    gb_wt_reads = weights * ky_serial

    # psums of the in-flight filter block are read-modify-written on every
    # accumulation round after the first; the slice exceeding GB_psum makes
    # the round trip to DRAM (Observation 1).
    inter_rounds = torch.clamp(n_c * ky_serial - 1, min=0.0)
    overflow = torch.clamp(w_psum - cfg["gb_psum_words"], min=0.0)
    held = torch.minimum(w_psum,
                         cfg["gb_psum_words"] * torch.ones_like(w_psum))
    psum_dram_writes = inter_rounds * overflow
    psum_dram_reads = psum_dram_writes
    psum_gb_inter = inter_rounds * held
    gb_psum_writes = psum_gb_inter + ofmap             # + final results
    gb_psum_reads = psum_gb_inter + ofmap              # reload + writeback
    ofmap_dram_writes = ofmap

    dram_reads = ifmap_dram_reads + wt_dram_reads + psum_dram_reads
    dram_writes = ofmap_dram_writes + psum_dram_writes
    gb_reads = gb_ifmap_reads + gb_wt_reads + gb_psum_reads
    gb_writes = gb_ifmap_writes + gb_wt_writes + gb_psum_writes

    words_into_array = gb_ifmap_reads + gb_wt_reads + psum_gb_inter + psum_dram_reads
    words_out_of_array = gb_psum_writes + psum_dram_writes

    ops = torch.where(pool, pool_ops, macs)
    rf_accesses = (4.0 * ops) + words_into_array + words_out_of_array

    return dict(
        mp=mp, ops=ops, macs=macs, pool_ops=pool_ops,
        dram_reads=dram_reads, dram_writes=dram_writes,
        gb_ifmap_reads=gb_ifmap_reads, gb_ifmap_writes=gb_ifmap_writes,
        gb_wt_reads=gb_wt_reads, gb_wt_writes=gb_wt_writes,
        gb_psum_reads=gb_psum_reads, gb_psum_writes=gb_psum_writes,
        gb_reads=gb_reads, gb_writes=gb_writes,
        rf_accesses=rf_accesses,
        words_into_array=words_into_array,
        words_out_of_array=words_out_of_array,
        psum_spilled=psum_dram_writes + psum_dram_reads,
        ifmap_refetched=ifmap_refetched,
    )


def _energy_latency(cfg: Dict[str, Any], lay: Dict[str, Any],
                    ct: Dict[str, Any]) -> Dict[str, Any]:
    e = cfg  # per-access constants pre-flattened into the cfg dict
    mp = ct["mp"]

    gb_e_if, gb_e_ps, gb_e_wt = e["gb_e_ifmap"], e["gb_e_psum"], e["gb_e_wt"]
    mac_e = torch.where(lay["is_pool"] != 0, e["e_mac"] * _POOL_OP_ENERGY,
                        e["e_mac"])

    noc_hops = (cfg["rows"] + cfg["cols"]) / 2.0
    # idle PEs still burn clock/leakage power for the whole layer occupancy
    idle_cycles = (cfg["rows"] * cfg["cols"] - mp["active_pes"]) \
        * ct["ops"] / mp["active_pes"]
    energy = (
        ct["dram_reads"] * e["e_dram_r"] + ct["dram_writes"] * e["e_dram_w"]
        + (ct["gb_ifmap_reads"] + ct["gb_ifmap_writes"]) * gb_e_if
        + (ct["gb_psum_reads"] + ct["gb_psum_writes"]) * gb_e_ps
        + (ct["gb_wt_reads"] + ct["gb_wt_writes"]) * gb_e_wt
        + ct["rf_accesses"] * e["e_rf"]
        + ct["ops"] * mac_e
        + idle_cycles * e["e_pe_idle"]
        + (ct["words_into_array"] + ct["words_out_of_array"])
        * e["e_noc_hop"] * noc_hops
    )

    # GB→array delivery is paced by the NoC and by the access time of the
    # partition it drains (bigger buffer ⇒ slower access, Fig. 9).
    lat_if = e["gb_t_ifmap"] / e["gb_t_base"]
    lat_ps = e["gb_t_psum"] / e["gb_t_base"]
    delivery_cy = (
        (ct["gb_ifmap_reads"] + ct["gb_wt_reads"]) * lat_if
        + (ct["gb_psum_reads"]) * lat_ps
    ) / e["noc_wpc"]
    writeback_cy = ct["words_out_of_array"] * lat_ps / e["noc_wpc"]
    compute_cy = ct["ops"] / mp["active_pes"] * e["mac_t_cy"]
    array_cy = delivery_cy + compute_cy + writeback_cy

    dram_words = ct["dram_reads"] + ct["dram_writes"]
    dram_cy = dram_words / e["dram_wpc"]

    array_time = array_cy * e["cycle_ns"]
    mem_time = dram_cy * e["cycle_ns"] + (delivery_cy + writeback_cy) * e["cycle_ns"]
    latency = (array_cy + dram_cy) * e["cycle_ns"]

    total_pes = cfg["rows"] * cfg["cols"]
    utilization = torch.where(
        array_cy > 0, (compute_cy / torch.clamp(array_cy, min=1e-30))
        * mp["active_pes"] / total_pes, 0.0)

    return dict(energy=energy, latency=latency, array_time=array_time,
                mem_time=mem_time, utilization=utilization)


def _cfg_struct(cfg: AcceleratorConfig, device) -> Dict[str, torch.Tensor]:
    """One config as 0-d float64 tensors on ``device``."""
    et = cfg.energy
    vals = dict(
        rows=cfg.array_rows, cols=cfg.array_cols,
        gb_ifmap_words=cfg.gb_ifmap_words(),
        gb_psum_words=cfg.gb_psum_words(),
        rf_ifmap_words=cfg.rf_ifmap_words,
        rf_weight_words=cfg.rf_weight_words,
        rf_psum_words=cfg.rf_psum_words,
        e_rf=et.rf_read,
        e_dram_r=et.dram_read, e_dram_w=et.dram_write,
        e_mac=et.mac, e_noc_hop=et.noc_hop,
        e_pe_idle=et.pe_idle,
        gb_e_ifmap=et.gb_energy(cfg.gb_ifmap_kb),
        gb_e_psum=et.gb_energy(cfg.gb_psum_kb),
        gb_e_wt=et.gb_energy(cfg.gb_weight_kb),
        gb_t_ifmap=et.gb_latency(cfg.gb_ifmap_kb),
        gb_t_psum=et.gb_latency(cfg.gb_psum_kb),
        gb_t_base=et.gb_t,
        noc_wpc=cfg.noc_words_per_cycle,
        dram_wpc=cfg.dram_words_per_cycle,
        mac_t_cy=et.mac_t / cfg.cycle_ns,
        cycle_ns=cfg.cycle_ns,
    )
    return {k: torch.tensor(float(v), dtype=_F64, device=device)
            for k, v in vals.items()}


# ---------------------------------------------------------------------------
# Backends (``resolve_device`` / ``resolve_backend`` live in
# :mod:`repro_torch.device` and are re-exported here).
# ---------------------------------------------------------------------------

_LAST_BACKEND: str | None = None


def last_backend() -> str | None:
    """Backend the most recent engine call ran its heavy stage on
    (``"cuda" | "torch"``) — ``None`` before the first call."""
    return _LAST_BACKEND


def simulate_network(cfg: AcceleratorConfig, layers: Sequence[Layer],
                     name: str = "net", *, device=None) -> NetworkReport:
    """Scalar (per-network, per-config) entry point → full layer reports.

    The per-layer model runs in torch on ``device``; the report totals are
    summed on the host in numpy's order, as the reference sums them."""
    dev = resolve_device(device)
    compute = [l for l in layers if l.kind != "input"]
    lay = rs_mapping.layer_struct(compute, device=dev)
    cfgs = _cfg_struct(cfg, dev)

    ct = _counts(cfgs, lay)
    el = _energy_latency(cfgs, lay, ct)
    h = {k: v.cpu().numpy() for k, v in (
        ("energy", el["energy"]), ("latency", el["latency"]),
        ("macs", lay["macs"]), ("dram_reads", ct["dram_reads"]),
        ("dram_writes", ct["dram_writes"]), ("gb_reads", ct["gb_reads"]),
        ("gb_writes", ct["gb_writes"]), ("rf_accesses", ct["rf_accesses"]),
        ("utilization", el["utilization"]), ("mem_time", el["mem_time"]),
        ("array_time", el["array_time"]),
        ("psum_spilled", ct["psum_spilled"]),
        ("ifmap_refetched", ct["ifmap_refetched"]))}

    reports = [LayerReport(name=l.name, **{k: float(v[i])
                                           for k, v in h.items()})
               for i, l in enumerate(compute)]
    return NetworkReport(
        name=name,
        energy=float(h["energy"].sum()),
        latency=float(h["latency"].sum()),
        layers=reports)


# ---------------------------------------------------------------------------
# Batched design-space engine.
#
# * Count dedup — the RS mapping and access counts depend on a config only
#   through (array, GB words, RF words), so the grid is deduplicated on
#   those columns (5,400 extended-space points → 1,800 count-unique rows)
#   and the heavy (unique × layers) stage runs once per unique row.
# * Early layer reduction — energy and latency are linear in the 14
#   per-layer count terms with config-only coefficients, so the layer axis
#   is summed per network before the coefficients are applied.
# ---------------------------------------------------------------------------

_LAYER_BUCKET = 256


def _cfg_struct_from_grid(grid) -> Dict[str, np.ndarray]:
    """Vectorised twin of :func:`_cfg_struct` on the host: the per-access
    model columns for every grid point (numpy float64, shape [n]).  Accepts
    a ConfigGrid or a bare column dict (the chunked path slices columns)."""
    fields = grid.fields if isinstance(grid, ConfigGrid) else grid
    f = {k: np.asarray(v, dtype=np.float64) for k, v in fields.items()}
    bpw = f["bitwidth"] / 8.0
    ref = f["gb_ref_kb"]

    def gb_e(kb):
        return f["gb_e_ref"] * np.sqrt(np.maximum(kb, 1.0) / ref)

    def gb_t(kb):
        return f["gb_t_ref"] * np.sqrt(np.sqrt(np.maximum(kb, 1.0) / ref))

    return dict(
        rows=f["rows"], cols=f["cols"],
        gb_ifmap_words=np.floor(f["gb_ifmap_kb"] * 1024 / bpw),
        gb_psum_words=np.floor(f["gb_psum_kb"] * 1024 / bpw),
        rf_ifmap_words=f["rf_ifmap_words"],
        rf_weight_words=f["rf_weight_words"],
        rf_psum_words=f["rf_psum_words"],
        e_rf=f["e_rf"], e_dram_r=f["e_dram_r"], e_dram_w=f["e_dram_w"],
        e_mac=f["e_mac"], e_noc_hop=f["e_noc_hop"], e_pe_idle=f["e_pe_idle"],
        gb_e_ifmap=gb_e(f["gb_ifmap_kb"]),
        gb_e_psum=gb_e(f["gb_psum_kb"]),
        gb_e_wt=gb_e(f["gb_weight_kb"]),
        gb_t_ifmap=gb_t(f["gb_ifmap_kb"]),
        gb_t_psum=gb_t(f["gb_psum_kb"]),
        gb_t_base=f["gb_t_ref"],
        noc_wpc=f["noc_wpc"], dram_wpc=f["dram_wpc"],
        mac_t_cy=f["mac_t"] / f["cycle_ns"], cycle_ns=f["cycle_ns"],
    )


# A benign do-nothing layer: unit shapes keep every mapping quantity ≥ 1
# (no division hazards) while zero macs/words make all 14 count terms, and
# so its energy and latency, exactly 0.0.
_PAD_LAYER_ROW = dict(
    c_ch=1.0, m=1.0, ky=1.0, kx=1.0, stride=1.0, ix=1.0, iy=1.0,
    oy=1.0, ox=1.0, macs=0.0, weight_words=0.0, ifmap_words=0.0,
    ofmap_words=0.0, is_acc=1.0, is_dw=0.0, is_pool=0.0)


def _bucketed(n: int, bucket: int) -> int:
    return max(bucket, -(-n // bucket) * bucket)


#: Layer-struct columns that must be ≥ 1 — shapes/strides act as tile
#: divisors in the RS mapping — vs. counts that only need to be ≥ 0.
_LAYER_DIM_COLUMNS = ("c_ch", "m", "ky", "kx", "stride", "ix", "iy",
                      "oy", "ox")


def _validate_layer_struct(name: str, struct: Dict[str, np.ndarray]):
    """Reject NaN/inf/non-positive layer parameters at the engine boundary,
    naming the network, layer index and field."""
    for k, v in struct.items():
        bad = ~np.isfinite(v)
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(
                f"network {name!r}: layer {i} field {k!r} is non-finite "
                f"({v[i]!r})")
        floor = 1 if k in _LAYER_DIM_COLUMNS else 0
        bad = v < floor
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(
                f"network {name!r}: layer {i} field {k!r} must be >= "
                f"{floor}, got {v[i]!r}")


def _stack_networks(networks: Mapping[str, Sequence[Layer]],
                    bucket: int = _LAYER_BUCKET,
                    absorb_pad: bool = True):
    """Concatenate all networks' compute layers along one padded axis.

    Returns ``(lay, segments)``: ``lay`` values are numpy float64 [L_pad]
    and ``segments`` a tuple of per-network (start, stop) on that axis.
    With ``absorb_pad`` the LAST segment extends to L_pad — pad layers
    contribute exactly zero (see ``_PAD_LAYER_ROW``), so the aggregate
    kernel may sum them into the last network.  The per-layer path passes
    ``absorb_pad=False``: it needs the true per-network lengths to size the
    padded ``n_layer`` output axis.
    """
    if not networks:
        raise ValueError("evaluate_networks needs at least one network")
    structs = []
    seg_lens = []
    for name, layers in networks.items():
        compute = [l for l in layers if l.kind != "input"]
        s = {k: v.numpy() for k, v in
             rs_mapping.layer_struct(compute, device="cpu").items()}
        _validate_layer_struct(name, s)
        structs.append(s)
        seg_lens.append(len(compute))
    total = int(np.sum(seg_lens))
    l_pad = _bucketed(total, bucket)

    lay = {}
    for k in structs[0]:
        col = np.full(l_pad, _PAD_LAYER_ROW[k], dtype=np.float64)
        col[:total] = np.concatenate([s[k] for s in structs])
        lay[k] = col
    offs = np.concatenate([[0], np.cumsum(seg_lens)]).astype(int)
    if absorb_pad:
        offs[-1] = l_pad                    # zero-energy pad → last segment
    segments = tuple((int(a), int(b)) for a, b in zip(offs[:-1], offs[1:]))
    return lay, segments


def network_layer_counts(networks: Mapping[str, Sequence[Layer]]
                         ) -> np.ndarray:
    """Per-network compute-layer counts, ordered like ``networks`` — the
    valid lengths of the per-layer path's padded ``n_layer`` axis."""
    return np.array([sum(1 for l in layers if l.kind != "input")
                     for layers in networks.values()], dtype=np.int64)


#: Config columns the RS mapping / access counts depend on, in the row
#: order of the CUDA kernels' config operand.  Everything else only scales
#: the counts linearly and is applied after the layer reduction.
_COUNT_COLUMNS = ("rows", "cols", "gb_ifmap_words", "gb_psum_words",
                  "rf_ifmap_words", "rf_weight_words", "rf_psum_words")

#: Subset of _COUNT_COLUMNS the RS mapping itself depends on — GB_psum only
#: enters the spill accounting in `_counts`, never the mapping.
_MAPPING_COLUMNS = ("rows", "cols", "gb_ifmap_words",
                    "rf_ifmap_words", "rf_weight_words", "rf_psum_words")

#: Mapping outputs `_counts` / `_count_terms` consume (gathered back to the
#: count-unique axis after the mapping-unique evaluation).
_MAPPING_KEYS = ("n_c", "n_m", "n_oy", "w_psum", "ky_serial", "active_pes")


def _dedup_rows(cfgs: Dict[str, np.ndarray], columns):
    """→ (unique column dict [n_u], inverse index [n]) over ``columns``:
    ``np.unique(key, axis=0, return_inverse=True)``'s rows in its
    lexicographic order, found with one ``np.lexsort`` (a tenth of
    ``np.unique``'s host time on these grids)."""
    key = np.stack([cfgs[k] for k in columns], axis=1)
    order = np.lexsort(key.T[::-1])
    ranked = key[order]
    new = np.ones(len(ranked), dtype=bool)
    new[1:] = (ranked[1:] != ranked[:-1]).any(axis=1)
    inv = np.empty(len(ranked), dtype=np.int64)
    inv[order] = np.cumsum(new) - 1
    return dict(zip(columns, ranked[new].T.copy())), inv


def _dedup_count_rows(cfgs: Dict[str, np.ndarray]):
    """→ (count-unique column dict [n_u], inverse index [n]), the rows
    grouped by mapping row: sorted on ``_MAPPING_COLUMNS``, then GB_psum,
    so the rows that share a mapping are neighbours and the mapping dedup's
    inverse never decreases (``count_terms_kernel`` finds each mapping
    row's count rows by a search of it)."""
    uniq, inv = _dedup_rows(cfgs, _MAPPING_COLUMNS + ("gb_psum_words",))
    return {k: uniq[k] for k in _COUNT_COLUMNS}, inv


def _count_terms(cfg_u: Dict[str, Any], lay: Dict[str, Any],
                 mp: Dict[str, Any] | None = None):
    """The 14 per-layer count terms that energy/latency are linear in.

    ``cfg_u`` holds the [n_u, 1] unique count columns; returns a tuple of
    [n_u, L] (or [1, L] for the two config-independent terms) tensors.
    """
    ct = _counts(cfg_u, lay, mp)
    active = ct["mp"]["active_pes"]
    ops = ct["ops"]
    pool = lay["is_pool"] != 0
    return (
        ct["dram_reads"],                                   # 0 e_dram_r
        ct["dram_writes"],                                  # 1 e_dram_w
        ct["gb_ifmap_reads"] + ct["gb_ifmap_writes"],       # 2 gb_e_ifmap
        ct["gb_psum_reads"] + ct["gb_psum_writes"],         # 3 gb_e_psum
        ct["gb_wt_reads"] + ct["gb_wt_writes"],             # 4 gb_e_wt
        ct["rf_accesses"],                                  # 5 e_rf
        torch.where(pool, 0.0, ct["macs"]),                 # 6 e_mac
        torch.where(pool, ct["pool_ops"], 0.0),             # 7 e_mac·pool
        (cfg_u["rows"] * cfg_u["cols"] - active) * ops / active,  # 8 idle
        ct["words_into_array"] + ct["words_out_of_array"],  # 9 noc energy
        ct["gb_ifmap_reads"] + ct["gb_wt_reads"],           # 10 delivery@if
        ct["gb_psum_reads"],                                # 11 delivery@ps
        ct["words_out_of_array"],                           # 12 writeback
        ops / active,                                       # 13 compute cy
    )


def _combine_reduced(S, coefs: Dict[str, Any]):
    """14 × [n_cfg, n_net] reduced sums × per-config coefficients →
    (energy, latency), both [n_cfg, n_net].  Mirrors `_energy_latency`."""
    C = {k: v[:, None] for k, v in coefs.items()}
    (d_r, d_w, gb_if, gb_ps, gb_wt, rf, ops_mac, ops_pool, idle,
     words_noc, dlv_if, dlv_ps, wout, ops_pe) = S
    energy = (
        d_r * C["e_dram_r"] + d_w * C["e_dram_w"]
        + gb_if * C["gb_e_ifmap"] + gb_ps * C["gb_e_psum"]
        + gb_wt * C["gb_e_wt"] + rf * C["e_rf"]
        + ops_mac * C["e_mac"] + ops_pool * (C["e_mac"] * _POOL_OP_ENERGY)
        + idle * C["e_pe_idle"]
        + words_noc * C["e_noc_hop"] * C["noc_hops"])
    lat_if = C["gb_t_ifmap"] / C["gb_t_base"]
    lat_ps = C["gb_t_psum"] / C["gb_t_base"]
    array_cy = ((dlv_if * lat_if + dlv_ps * lat_ps + wout * lat_ps)
                / C["noc_wpc"] + ops_pe * C["mac_t_cy"])
    dram_cy = (d_r + d_w) / C["dram_wpc"]
    latency = (array_cy + dram_cy) * C["cycle_ns"]
    return energy, latency


def _coef_struct(cfgs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    keys = ("e_dram_r", "e_dram_w", "gb_e_ifmap", "gb_e_psum", "gb_e_wt",
            "e_rf", "e_mac", "e_pe_idle", "e_noc_hop", "gb_t_ifmap",
            "gb_t_psum", "gb_t_base", "noc_wpc", "mac_t_cy", "dram_wpc",
            "cycle_ns")
    out = {k: cfgs[k] for k in keys}
    out["noc_hops"] = (cfgs["rows"] + cfgs["cols"]) / 2.0
    return out


def _term_sums_body(segments, cfg_m, cfg_u, lay, inv_m):
    """Mapping on the mapping-unique rows, counts on the count-unique rows,
    per-network segment sums: tuple of [n_u, n_net] (or [1, n_net] for the
    two config-independent terms).  The plain torch heavy stage."""
    mp_m = _mapping(cfg_m, lay)
    mp = {k: mp_m[k][inv_m] for k in _MAPPING_KEYS}
    terms = _count_terms(cfg_u, lay, mp)
    return tuple(
        torch.stack([t[..., a:b].sum(-1) for a, b in segments], dim=-1)
        for t in terms)


def _gather_combine_body(S, inv, coefs):
    """Gather the reduced sums back to the full config axis and apply the
    per-config coefficients — the cheap [n_cfg, n_net] stage."""
    gathered = []
    for s in S:
        if s.shape[0] == 1:                  # config-independent term
            g = s.expand(inv.shape[0], s.shape[1])
        else:
            g = s[inv]
        gathered.append(g)
    return _combine_reduced(tuple(gathered), coefs)


def _cuda_term_sums(segments, cfg_m, cfg_u, lay, inv_m):
    """The CUDA count-terms kernel on :func:`_term_sums_body`'s operands:
    the mapping once per mapping-unique row, the 14 terms per count-unique
    row and the segment sums in one launch."""
    from ..kernels.count_terms import ops
    return ops.count_term_sums(segments, cfg_m, cfg_u, lay, inv_m)


# ---------------------------------------------------------------------------
# Per-layer path: the same heavy stage without the early segment reduction.
# ---------------------------------------------------------------------------


def _term_layers_body(cfg_m, cfg_u, lay, inv_m):
    """Per-layer twin of :func:`_term_sums_body`: the raw 14 count terms,
    each [n_u, L] ([1, L] for the config-independent two)."""
    mp_m = _mapping(cfg_m, lay)
    mp = {k: mp_m[k][inv_m] for k in _MAPPING_KEYS}
    return _count_terms(cfg_u, lay, mp)


def _cuda_term_layers(cfg_u, lay):
    """The CUDA per-layer kernel: the [14, n_u, L] terms in one launch."""
    from ..kernels.count_terms import ops
    return ops.count_term_layers(cfg_u, lay)


def _layer_axis_len(segments) -> int:
    """Padded n_layer of the per-layer output: the longest segment."""
    return max(b - a for a, b in segments)


def _split_layers(arr, segments):
    """[n, L_concat] → [n, n_net, n_layer]: slice each network's segment
    off the concatenated axis and zero-pad to the longest one."""
    n_layer = _layer_axis_len(segments)
    outs = []
    for a, b in segments:
        seg = arr[:, a:b]
        if b - a < n_layer:
            seg = torch.nn.functional.pad(seg, (0, n_layer - (b - a)))
        outs.append(seg)
    return torch.stack(outs, dim=1)


#: Where set, called with each stage's name as the stage ends (the host
#: split of ``chip_smoke.py`` times the stages of a call); ``None``
#: otherwise.
_stage_hook = None


def _stage(name: str) -> None:
    if _stage_hook is not None:
        _stage_hook(name)


def _grid_kernel_body(segments, cfg_m, cfg_u, lay, inv_m, inv, coefs,
                      backend: str, per_layer: bool = False):
    """Heavy stage on ``backend``, then the coefficient combine.
    ``per_layer=True`` skips the segment reduction: the combine runs on
    the [*, L] terms and the outputs are re-split to [n, n_net, n_layer]."""
    if per_layer and backend == "cuda":
        S = _cuda_term_layers(cfg_u, lay)
    elif per_layer:
        S = _term_layers_body(cfg_m, cfg_u, lay, inv_m)
    elif backend == "cuda":
        S = _cuda_term_sums(segments, cfg_m, cfg_u, lay, inv_m)
    else:
        S = _term_sums_body(segments, cfg_m, cfg_u, lay, inv_m)
    _stage("heavy stage")
    e, t = _gather_combine_body(S, inv, coefs)
    _stage("gather-combine")
    if per_layer:
        e, t = _split_layers(e, segments), _split_layers(t, segments)
        _stage("layer split")
    return e, t


def _prepare_fields(fields: Dict[str, np.ndarray], device: torch.device):
    """Grid columns → two-level-deduped heavy-stage operands on ``device``,
    the same for both backends, the count rows grouped by mapping row
    (``inv_m`` non-decreasing).  The dedup runs on the host in numpy, as in
    the reference."""
    cfgs = _cfg_struct_from_grid(fields)
    coefs = _coef_struct(cfgs)
    _stage("config columns")
    cfg_u, inv = _dedup_count_rows(cfgs)                  # counts level
    _stage("count dedup")
    cfg_m, inv_m = _dedup_rows(cfg_u, _MAPPING_COLUMNS)   # mapping level
    _stage("mapping dedup")

    def put(a):
        return torch.as_tensor(a, dtype=_F64).to(device)

    def put_idx(a):
        return torch.as_tensor(a, dtype=torch.int64).to(device)

    cfg_m = {k: put(v)[:, None] for k, v in cfg_m.items()}
    cfg_u = {k: put(v)[:, None] for k, v in cfg_u.items()}
    coefs = {k: put(v) for k, v in coefs.items()}
    inv_m, inv = put_idx(inv_m), put_idx(inv)
    _stage("config host-to-device")
    return cfg_m, cfg_u, inv_m, inv, coefs


def _device_layers(networks, device: torch.device, absorb_pad: bool):
    """:func:`_stack_networks` with the layer columns moved to ``device``
    as ``[1, L]`` float64 tensors → ``(lay, segments)``."""
    lay_np, segments = _stack_networks(networks, absorb_pad=absorb_pad)
    _stage("layer stacking")
    lay = {k: torch.as_tensor(v, dtype=_F64).to(device)[None, :]
           for k, v in lay_np.items()}
    _stage("layer host-to-device")
    return lay, segments


def _eval_fields(fields, lay, segments, backend: str, device: torch.device,
                 per_layer: bool = False):
    """Evaluate one batch of grid columns → (energy, latency) tensors on
    ``device``: [n, n_net], or [n, n_net, n_layer] in per-layer mode."""
    cfg_m, cfg_u, inv_m, inv, coefs = _prepare_fields(fields, device)
    return _grid_kernel_body(segments, cfg_m, cfg_u, lay, inv_m, inv, coefs,
                             backend, per_layer)


def _eval_chunked(fields, lay, segments, backend: str, device: torch.device,
                  chunk_size: int, n: int, n_net: int,
                  per_layer: bool = False):
    """Chunked evaluation of the full grid → dense host outputs, so the
    (unique-rows × layers) intermediates on the device stay bounded by the
    chunk."""
    shape = ((n, n_net, _layer_axis_len(segments)) if per_layer
             else (n, n_net))
    e = np.empty(shape)
    t = np.empty(shape)
    for start in range(0, n, chunk_size):
        stop = min(start + chunk_size, n)
        fc = {k: v[start:stop] for k, v in fields.items()}
        ec, tc = _eval_fields(fc, lay, segments, backend, device, per_layer)
        e[start:stop] = ec.cpu().numpy()
        t[start:stop] = tc.cpu().numpy()
        _stage("device-to-host")
    return e, t


def visible_devices(dev: torch.device) -> int:
    """How many devices of ``dev``'s kind a sharded evaluation would
    split over: the visible cards for a CUDA device, one for the CPU."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def check_shard(shard: bool, dev: torch.device) -> None:
    """``shard=True`` asks for the deduped config axis to be split over
    the visible devices, as the reference splits it over its host
    devices.  With one device that split is the unsharded evaluation,
    bit for bit, and that is what runs.  A split over several cards is
    not written yet, so with more than one visible ``shard=True`` raises
    rather than run on one card."""
    if shard and visible_devices(dev) > 1:
        raise NotImplementedError(
            f"shard=True over {visible_devices(dev)} {dev.type} devices: "
            f"the port evaluates on one card; pass shard=False, or hide "
            f"the other cards with CUDA_VISIBLE_DEVICES")


def evaluate_networks(grid: ConfigGrid,
                      networks: Mapping[str, Sequence[Layer]],
                      *,
                      device=None,
                      backend: str | None = None,
                      chunk_size: int | None = None,
                      per_layer: bool = False,
                      shard: bool = False,
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Evaluate every network against every grid point.

    Returns ``(energy, latency)`` float64 numpy arrays of shape
    ``[grid.n, len(networks)]``, columns ordered like ``networks``.
    ``device`` is where the heavy stage runs (default: the card; raises
    without one).  ``backend`` selects the heavy stage: ``"cuda"`` (the
    hand-written kernels) or ``"torch"`` (plain torch operations); the
    default is ``"cuda"`` on a CUDA device and ``"torch"`` on the CPU.
    ``chunk_size`` evaluates the grid in chunks of that many points so the
    device intermediates stay bounded.

    ``per_layer=True`` keeps the layer axis: the outputs become
    ``[grid.n, len(networks), n_layer]`` where ``n_layer`` is the longest
    network's compute-layer count (shorter networks zero-padded — see
    :func:`network_layer_counts` for the valid lengths).

    ``shard=True`` asks for the deduped config axis to be split over the
    visible devices (see :func:`check_shard`): with one device it
    evaluates exactly as ``shard=False``, and with several it raises.
    """
    global _LAST_BACKEND
    dev = resolve_device(device)
    check_shard(shard, dev)
    backend = resolve_backend(backend, dev)
    lay, segments = _device_layers(networks, dev, absorb_pad=not per_layer)
    fields = grid.fields if isinstance(grid, ConfigGrid) else dict(grid)
    n = int(next(iter(fields.values())).shape[0])

    if chunk_size is not None and n > chunk_size:
        out = _eval_chunked(fields, lay, segments, backend, dev,
                            chunk_size, n, len(networks),
                            per_layer=per_layer)
    else:
        e, t = _eval_fields(fields, lay, segments, backend, dev,
                            per_layer=per_layer)
        out = e.cpu().numpy(), t.cpu().numpy()
        _stage("device-to-host")
    _LAST_BACKEND = backend
    return out


def simulate_grid(configs: Sequence[AcceleratorConfig] | ConfigGrid,
                  layers: Sequence[Layer], *, device=None,
                  backend: str | None = None):
    """Vectorised sweep of one network: (energy, latency) arrays [n_cfg]."""
    grid = (configs if isinstance(configs, ConfigGrid)
            else ConfigGrid.from_configs(configs))
    e, t = evaluate_networks(grid, {"net": layers}, device=device,
                             backend=backend)
    return e[:, 0], t[:, 0]


# ---------------------------------------------------------------------------
# Streaming evaluation: the grid in chunks, each folded into running
# reductions on the device.
#
# The paper's §III/§IV consumers want per-network minima, the ≤bound
# boundary sets and a few near-optimal cells, not the [n_cfg, n_net]
# matrices.  Both streams evaluate one chunk at a time through
# :func:`_eval_fields` and fold it, as torch operations, where the heavy
# stage ran; only the boundary mask's hits, their energy and latency, and
# the finished state cross to the host.  Every reduction ranks by (value,
# flat grid index), so the fold depends neither on the chunk size nor on
# where a run was cut and resumed.  Unlike the reference, the last chunk
# is not padded: its padded rows only ever entered the fold as +inf
# behind the -1 sentinels, so leaving them out changes no result.
#
# Crash safety.  Everything the fold carries (the state tuple and the
# boundary candidates) is exported after every chunk; a content hash over
# (grid columns, layer structs, metric, bound, topk, chunk schedule) is
# stamped into it, and resuming against other inputs is refused.  Both
# the hash and the export are the reference's, so a state crosses between
# the packages.
# ---------------------------------------------------------------------------


def _metric_of(metric: str, e, t):
    if metric == "edp":
        return e * t
    return e if metric == "energy" else t


@dataclasses.dataclass(frozen=True)
class StreamResult:
    """Running reductions of a streamed sweep (flat grid indices), as
    numpy arrays; ``device`` and ``backend`` say where the heavy stage and
    the fold ran."""

    networks: Tuple[str, ...]
    n_cfg: int
    metric: str
    bound: float
    min_energy: np.ndarray          # [n_net]
    min_latency: np.ndarray         # [n_net]
    min_metric: np.ndarray          # [n_net]
    argmin: np.ndarray              # [n_net] flat grid index of metric min
    topk_idx: np.ndarray            # [k, n_net] flat indices, best first
    topk_metric: np.ndarray         # [k, n_net]
    boundary_idx: Dict[str, np.ndarray]      # per net, sorted by metric
    boundary_energy: Dict[str, np.ndarray]
    boundary_latency: Dict[str, np.ndarray]
    device: str
    backend: str

    def boundary_metric(self, name: str) -> np.ndarray:
        return _metric_of(self.metric, self.boundary_energy[name],
                          self.boundary_latency[name])


class StreamStateError(ValueError):
    """Resume state incompatible with the requested stream: wrong stream
    kind, inputs changed since the state was exported, or a truncated /
    corrupt payload."""


class ChunkCorruption(RuntimeError):
    """Non-finite energy/latency detected in a streamed chunk.

    Raised by the per-chunk NaN/inf guard BEFORE the chunk is folded, so
    the running state is never poisoned; carries chunk provenance
    (``chunk``, grid row range ``start:stop``, affected ``networks``)."""

    def __init__(self, msg: str, *, chunk: int, start: int, stop: int,
                 networks: Sequence[str] = ()):
        super().__init__(msg)
        self.chunk = int(chunk)
        self.start = int(start)
        self.stop = int(stop)
        self.networks = tuple(networks)


#: Fault-injection seam: when set, called as ``hook(chunk_index, e, t)`` on
#: every chunk's raw evaluation (device tensors) right before it is folded
#: (both streams) and must return the possibly-modified ``(e, t)``; ``None``
#: otherwise.
_CHUNK_HOOK = None


def _apply_chunk_hook(ci, e, t):
    if _CHUNK_HOOK is None:
        return e, t
    return _CHUNK_HOOK(ci, e, t)


def _guard_chunk(ci, start, stop, es, ts, names):
    """NaN/inf guard with chunk provenance over the chunk's [rows, n_net]
    aggregates: checked on their device, copied to the host only to name
    the networks of a failure."""
    bad = ~(torch.isfinite(es) & torch.isfinite(ts))
    if not bool(bad.any()):
        return
    nets = [names[j] for j in torch.nonzero(bad.any(dim=0)).flatten().tolist()]
    raise ChunkCorruption(
        f"non-finite energy/latency in streamed chunk {ci} (grid rows "
        f"{start}:{stop}, networks {nets}); the fold state was NOT "
        f"updated with this chunk — retry the chunk or resume from the "
        f"last exported state", chunk=ci, start=start, stop=stop,
        networks=nets)


def stream_input_hash(grid: ConfigGrid | Mapping[str, Any],
                      networks: Mapping[str, Sequence[Layer]],
                      *, kind: str, metric: str, bound: float | None,
                      topk: int, chunk: int) -> str:
    """Content hash of everything that determines a streamed fold: the
    grid columns and each network's layer struct as float64 bytes, and the
    reduction parameters with the effective chunk — the reference's
    digest for the same inputs.  Equal hashes fold identical chunk
    sequences, the precondition for a bit-exact resume."""
    h = hashlib.sha256()
    h.update(repr((kind, metric,
                   None if bound is None else float(bound),
                   int(topk), int(chunk))).encode())
    fields = grid.fields if isinstance(grid, ConfigGrid) else dict(grid)
    for k in sorted(fields):
        h.update(k.encode())
        h.update(np.ascontiguousarray(
            np.asarray(fields[k], dtype=np.float64)).tobytes())
    for nm in networks:
        h.update(nm.encode())
        struct = rs_mapping.layer_struct(
            [l for l in networks[nm] if l.kind != "input"], device="cpu")
        for sk in sorted(struct):
            h.update(sk.encode())
            h.update(struct[sk].numpy().tobytes())      # float64
    return h.hexdigest()


def _to_host(a) -> np.ndarray:
    """A fold-state array as a numpy copy (device tensors copied over)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().copy()
    return np.array(np.asarray(a), copy=True)


@dataclasses.dataclass
class StreamFoldState:
    """Serializable fold state of a streamed sweep after ``next_chunk``
    chunks.

    Emitted through the ``on_chunk=`` callback of :func:`stream_networks`
    / :func:`stream_layer_topk` after every folded chunk and accepted back
    through ``resume_from=``; ``state`` may hold device tensors.
    :meth:`export_state` flattens it to the reference's numpy payload
    (device tensors copied to the host) and :meth:`save` / :meth:`load`
    persist that export crash-safely (a temp file, then an atomic
    rename)."""

    kind: str                       # "networks" | "layer_topk"
    input_hash: str
    next_chunk: int                 # chunks [0, next_chunk) are folded
    n_chunks: int
    chunk_size: int                 # effective chunk row count
    n_cfg: int
    networks: Tuple[str, ...]
    metric: str
    bound: float | None
    topk: int
    state: tuple                    # reduction state (tensors or arrays)
    cand: Dict[str, list]           # boundary triples (idx, e, t) per net

    @property
    def complete(self) -> bool:
        return self.next_chunk >= self.n_chunks

    def export_state(self) -> Dict[str, Any]:
        """Flatten to a ``{name: np.ndarray}`` dict (+ a ``meta`` JSON
        string) — npz-serializable, no pickling."""
        out: Dict[str, Any] = {}
        for i, s in enumerate(self.state):
            out[f"state_{i}"] = _to_host(s)
        for j, nm in enumerate(self.networks):
            entries = self.cand.get(nm, [])
            if entries:
                out[f"cand{j}_idx"] = np.concatenate(
                    [np.asarray(c[0], np.int64) for c in entries])
                out[f"cand{j}_e"] = np.concatenate(
                    [np.asarray(c[1], np.float64) for c in entries])
                out[f"cand{j}_t"] = np.concatenate(
                    [np.asarray(c[2], np.float64) for c in entries])
            else:
                out[f"cand{j}_idx"] = np.zeros(0, np.int64)
                out[f"cand{j}_e"] = np.zeros(0)
                out[f"cand{j}_t"] = np.zeros(0)
        out["meta"] = json.dumps(dict(
            kind=self.kind, input_hash=self.input_hash,
            next_chunk=int(self.next_chunk), n_chunks=int(self.n_chunks),
            chunk_size=int(self.chunk_size), n_cfg=int(self.n_cfg),
            networks=list(self.networks), metric=self.metric,
            bound=self.bound, topk=int(self.topk),
            n_state=len(self.state)))
        return out

    @classmethod
    def from_export(cls, d: Mapping[str, Any]) -> "StreamFoldState":
        try:
            meta_raw = d["meta"]
            if not isinstance(meta_raw, str):
                meta_raw = str(np.asarray(meta_raw)[()])
            meta = json.loads(meta_raw)
            state = tuple(np.asarray(d[f"state_{i}"])
                          for i in range(int(meta["n_state"])))
            cand: Dict[str, list] = {}
            for j, nm in enumerate(meta["networks"]):
                idx = np.asarray(d[f"cand{j}_idx"], np.int64)
                cand[nm] = ([(idx, np.asarray(d[f"cand{j}_e"]),
                              np.asarray(d[f"cand{j}_t"]))]
                            if idx.size else [])
        except (KeyError, ValueError, TypeError) as e:
            raise StreamStateError(
                f"truncated or corrupt stream fold-state payload: {e}")
        return cls(kind=meta["kind"], input_hash=meta["input_hash"],
                   next_chunk=int(meta["next_chunk"]),
                   n_chunks=int(meta["n_chunks"]),
                   chunk_size=int(meta["chunk_size"]),
                   n_cfg=int(meta["n_cfg"]),
                   networks=tuple(meta["networks"]), metric=meta["metric"],
                   bound=meta["bound"], topk=int(meta["topk"]),
                   state=state, cand=cand)

    def save(self, path) -> None:
        """Crash-safe persist: write the npz to ``path + '.tmp'``, fsync,
        then atomically rename over ``path``."""
        d = self.export_state()
        tmp = str(path) + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **d)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, str(path))

    @classmethod
    def load(cls, path) -> "StreamFoldState":
        with np.load(str(path), allow_pickle=False) as z:
            d = {k: z[k] for k in z.files}
        return cls.from_export(d)


def _resume_fold(resume_from, *, kind, ihash, names, device):
    """Validate a resume payload against the live call → (state on
    ``device``, boundary candidates, first chunk to fold)."""
    fs = (resume_from if isinstance(resume_from, StreamFoldState)
          else StreamFoldState.from_export(resume_from))
    if fs.kind != kind:
        raise StreamStateError(
            f"resume_from carries a {fs.kind!r} fold state but this is a "
            f"{kind!r} stream")
    if fs.input_hash != ihash:
        raise StreamStateError(
            "resume_from was exported from different inputs — the (grid, "
            "networks, metric, bound, topk, chunk schedule) content hash "
            "does not match; refusing to resume because the folded result "
            "would not be bit-identical")
    state = tuple(s.to(device) if isinstance(s, torch.Tensor)
                  else torch.as_tensor(np.asarray(s)).to(device)
                  for s in fs.state)
    cand = {nm: list(fs.cand.get(nm, [])) for nm in names}
    return state, cand, int(fs.next_chunk)


def _lex_order(all_v, all_i, k: int):
    """The first ``k`` positions along dim 0 in (value, index) order —
    numpy's ``lexsort((all_i, all_v), axis=0)[:k]``, which torch lacks: a
    stable sort on the index, then a stable sort on the value.  The +inf
    sentinel rows carry index -1, so they sort ahead of any real +inf."""
    by_i = torch.sort(all_i, dim=0, stable=True).indices
    by_v = torch.sort(torch.gather(all_v, 0, by_i), dim=0,
                      stable=True).indices
    return torch.gather(by_i, 0, by_v)[:k]


def _chunk_index(e, base: int):
    """Flat grid indices of a chunk's rows, broadcast to [rows, n_net]."""
    rows = torch.arange(base, base + e.shape[0], device=e.device)
    return rows[:, None].expand(e.shape[0], e.shape[1])


def _stream_reduce_body(metric, topk, e, t, base, bound, state):
    """Fold one [rows, n_net] chunk (grid rows ``base`` on) into the
    running state → ``(state, mask)``.  Ties go to the lower flat index
    (``argmin`` returns the first minimum, the top-k ranks by (value,
    index)); the boundary mask compares against the *updated* running
    minimum, a superset of the final boundary set."""
    min_e, min_t, min_m, argm, top_v, top_i = state
    v = _metric_of(metric, e, t)
    min_e = torch.minimum(min_e, e.amin(dim=0))
    min_t = torch.minimum(min_t, t.amin(dim=0))
    cmin = v.amin(dim=0)
    better = cmin < min_m
    min_m = torch.where(better, cmin, min_m)
    argm = torch.where(better, base + v.argmin(dim=0), argm)
    all_v = torch.cat([top_v, v])
    all_i = torch.cat([top_i, _chunk_index(v, base)])
    order = _lex_order(all_v, all_i, topk)
    top_v = torch.gather(all_v, 0, order)
    top_i = torch.gather(all_i, 0, order)
    mask = v <= min_m[None, :] * (1.0 + bound)
    return (min_e, min_t, min_m, argm, top_v, top_i), mask


def _collect_hits(cand, names, mask, es, ts, start: int) -> None:
    """Append each network's boundary hits of a chunk — (flat indices,
    energies, latencies) — to ``cand``; only the hits cross to the host."""
    r, c = torch.nonzero(mask, as_tuple=True)
    if r.numel() == 0:
        return
    e_h, t_h = es[r, c].cpu().numpy(), ts[r, c].cpu().numpy()
    r, c = r.cpu().numpy(), c.cpu().numpy()
    for j, nm in enumerate(names):
        sel = c == j
        if sel.any():
            cand[nm].append((start + r[sel], e_h[sel], t_h[sel]))


def _pruned_candidates(entries, metric, min_m: float, bound: float):
    """One network's boundary candidates pruned to the final minimum →
    (indices, energies, latencies, metric values), in fold order."""
    if entries:
        idx = np.concatenate([c[0] for c in entries])
        ee = np.concatenate([c[1] for c in entries])
        tt = np.concatenate([c[2] for c in entries])
    else:
        idx, ee, tt = (np.zeros(0, np.int64),) + (np.zeros(0),) * 2
    v = _metric_of(metric, ee, tt)
    keep = v <= min_m * (1.0 + bound)
    return idx[keep], ee[keep], tt[keep], v[keep]


def _plain_ref_eval(lay, segments, per_layer: bool):
    """A verifier's shadow evaluator: the plain torch path on the CPU in
    float64, a chunk's columns → numpy (energy, latency)."""
    cpu = torch.device("cpu")
    lay_cpu = {k: v.to(cpu) for k, v in lay.items()}

    def ref_eval(fc):
        e, t = _eval_fields(fc, lay_cpu, segments, "torch", cpu, per_layer)
        return e.numpy(), t.numpy()
    return ref_eval


def _full(shape, value, device, dtype=_F64):
    return torch.full(shape, value, dtype=dtype, device=device)


def _chunk_rows(fields, n: int, chunk: int, done: int):
    """(chunk index, start, stop, the chunk's columns) from chunk
    ``done`` on, unpadded."""
    for ci in range(done, -(-n // chunk)):
        start = ci * chunk
        stop = min(start + chunk, n)
        yield ci, start, stop, {k: v[start:stop] for k, v in fields.items()}


def stream_networks(grid: ConfigGrid,
                    networks: Mapping[str, Sequence[Layer]],
                    *,
                    device=None,
                    backend: str | None = None,
                    chunk_size: int = 4096,
                    bound: float = 0.05,
                    metric: str = "edp",
                    topk: int = 16,
                    resume_from: "StreamFoldState | Mapping | None" = None,
                    on_chunk=None,
                    nan_guard: bool = True,
                    verify=None,
                    shard: bool = False) -> StreamResult:
    """Chunked streaming sweep with running reductions on the device.

    Never materialises the full ``[n_cfg, n_net]`` matrices: each chunk
    of ``chunk_size`` grid rows is evaluated like :func:`evaluate_networks`
    (``device``, ``backend``: the same defaults) and folded, on ``device``,
    into per-network running minima, top-``topk`` cells and ≤``bound``
    boundary candidate sets of ``metric`` (``"edp" | "energy" |
    "latency"``).  Equivalent to reducing :func:`evaluate_networks`'s
    output, at bounded memory.

    Crash safety: ``on_chunk`` receives a :class:`StreamFoldState` after
    every folded chunk; pass one back (or its export, the reference's
    too) as ``resume_from=`` to restart from the first unfolded chunk —
    the result is bit-identical to an uninterrupted run, and a state
    exported from other inputs raises :class:`StreamStateError`.
    ``nan_guard`` checks every chunk for NaN/inf before the fold commits
    (:class:`ChunkCorruption`).  ``verify=`` takes a verifier duck-typed
    like the reference's ``StreamVerifier`` (``bind`` / ``check_resume``
    / ``check_chunk`` / ``check_fold``), each called before the fold
    commits; its ``ref_eval`` is the plain torch path on the CPU.
    ``shard`` acts as in :func:`evaluate_networks`.
    """
    global _LAST_BACKEND
    dev = resolve_device(device)
    check_shard(shard, dev)
    backend = resolve_backend(backend, dev)
    names = tuple(networks)
    n_net = len(names)
    lay, segments = _device_layers(networks, dev, absorb_pad=True)
    fields = grid.fields if isinstance(grid, ConfigGrid) else dict(grid)
    n = int(next(iter(fields.values())).shape[0])
    chunk = max(1, min(chunk_size, n))
    n_chunks = -(-n // chunk)
    ihash = stream_input_hash(fields, networks, kind="networks",
                              metric=metric, bound=bound, topk=topk,
                              chunk=chunk)

    inf, i64 = float("inf"), torch.int64
    state = (_full((n_net,), inf, dev),                 # min_energy
             _full((n_net,), inf, dev),                 # min_latency
             _full((n_net,), inf, dev),                 # min_metric
             _full((n_net,), -1, dev, i64),             # argmin
             _full((topk, n_net), inf, dev),            # top_v
             _full((topk, n_net), -1, dev, i64))        # top_i
    cand: Dict[str, list] = {nm: [] for nm in names}
    done = 0
    if resume_from is not None:
        state, cand, done = _resume_fold(resume_from, kind="networks",
                                         ihash=ihash, names=names,
                                         device=dev)
    if verify is not None:
        verify.bind(kind="networks", names=names, metric=metric,
                    topk=topk, bound=bound, backend=backend,
                    ref_eval=_plain_ref_eval(lay, segments, False))
        if resume_from is not None:
            verify.check_resume(state, cand)
    _stage("stream setup")

    for ci, start, stop, fc in _chunk_rows(fields, n, chunk, done):
        e, t = _eval_fields(fc, lay, segments, backend, dev)
        e, t = _apply_chunk_hook(ci, e, t)
        if nan_guard:
            _guard_chunk(ci, start, stop, e, t, names)
        if verify is not None:          # raises BEFORE the fold commits
            verify.check_chunk(ci, start, stop, fc, e, t)
        new_state, mask = _stream_reduce_body(metric, topk, e, t, start,
                                              bound, state)
        if verify is not None:
            verify.check_fold(ci, start, stop, state, new_state,
                              es=e, ts=t, mask=mask)
        state = new_state
        _collect_hits(cand, names, mask, e, t, start)
        _stage("chunk fold")
        if on_chunk is not None:
            on_chunk(StreamFoldState(
                kind="networks", input_hash=ihash, next_chunk=ci + 1,
                n_chunks=n_chunks, chunk_size=chunk, n_cfg=n,
                networks=names, metric=metric, bound=bound, topk=topk,
                state=state, cand={nm: list(v) for nm, v in cand.items()}))

    min_e, min_t, min_m, argm, top_v, top_i = (_to_host(s) for s in state)
    b_idx, b_e, b_t = {}, {}, {}
    for j, nm in enumerate(names):
        idx, ee, tt, v = _pruned_candidates(cand[nm], metric, min_m[j],
                                            bound)
        order = np.argsort(v, kind="stable")
        b_idx[nm], b_e[nm], b_t[nm] = idx[order], ee[order], tt[order]
    _stage("stream finish")
    _LAST_BACKEND = backend
    return StreamResult(
        networks=names, n_cfg=n, metric=metric, bound=bound,
        min_energy=min_e, min_latency=min_t, min_metric=min_m,
        argmin=argm, topk_idx=top_i, topk_metric=top_v,
        boundary_idx=b_idx, boundary_energy=b_e, boundary_latency=b_t,
        device=str(dev), backend=backend)


# ---------------------------------------------------------------------------
# Streaming per-layer reduction.  The per-layer tensors of a mega sweep are
# far too large to keep ([n_cfg, n_net, n_layer]), but the co-design needs
# only the per-layer rows of the few near-optimal configs of each network
# and the ≤bound boundary sets.  Each chunk is evaluated in per-layer mode
# and folded on the device into (a) a running per-network top-k that keeps
# the [n_layer] energy/latency rows of its configs, (b) running minima of
# energy, latency, EDP and the metric, (c) per-(network, layer) metric
# minima, and (d) with ``bound=`` the ≤bound mask whose hits become the
# boundary sets.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerTopK:
    """Running reductions of a streamed per-layer sweep, as numpy arrays.

    The boundary-set fields are ``None`` unless the sweep ran with a
    ``bound=``.  ``topk_idx`` ranks by (metric, flat index): ties go to
    the LOWER grid index, so the result does not depend on the chunk
    size."""

    networks: Tuple[str, ...]
    n_cfg: int
    metric: str
    layer_counts: np.ndarray        # [n_net] valid lengths of the layer axis
    topk_idx: np.ndarray            # [k, n_net] flat grid indices, best first
    topk_metric: np.ndarray         # [k, n_net]
    layer_energy: np.ndarray        # [k, n_net, n_layer]
    layer_latency: np.ndarray       # [k, n_net, n_layer]
    min_energy: np.ndarray | None = None      # [n_net]
    min_latency: np.ndarray | None = None     # [n_net]
    min_edp: np.ndarray | None = None         # [n_net]
    min_metric: np.ndarray | None = None      # [n_net]
    argmin: np.ndarray | None = None          # [n_net] flat index of min
    layer_min_metric: np.ndarray | None = None   # [n_net, n_layer]
    layer_argmin: np.ndarray | None = None       # [n_net, n_layer]
    bound: float | None = None
    boundary_idx: Dict[str, np.ndarray] | None = None   # sorted by metric
    boundary_energy: Dict[str, np.ndarray] | None = None
    boundary_latency: Dict[str, np.ndarray] | None = None

    def boundary_metric(self, name: str) -> np.ndarray:
        if self.boundary_energy is None:
            raise ValueError("this stream carries no boundary sets — "
                             "run stream_layer_topk with bound=")
        return _metric_of(self.metric, self.boundary_energy[name],
                          self.boundary_latency[name])


def _take_rows(prev, new, order):
    """Rows ``order`` [k, n_net] of ``cat([prev, new])`` along dim 0 for
    [·, n_net, n_layer] operands, without building the concatenation (the
    chunk's per-layer tensor is the large one)."""
    k = prev.shape[0]
    ix = order[:, :, None].expand(-1, -1, prev.shape[2])
    from_prev = torch.gather(prev, 0, ix.clamp(max=k - 1))
    from_new = torch.gather(new, 0, (ix - k).clamp(min=0))
    return torch.where(ix < k, from_prev, from_new)


def _layer_reduce_body(metric, topk, e, t, es, ts, base, bound, lay_valid,
                       state):
    """Fold one [rows, n_net, n_layer] per-layer chunk, with its
    layer-summed [rows, n_net] aggregates ``es`` / ``ts``, into the
    running state → ``(state, mask)``; ``mask`` is the ≤bound mask
    against the *updated* running minimum.  ``lay_valid`` [n_net, n_layer]
    masks each network's zero-padded layer tail out of the per-layer
    minima.  Ties go to the lower flat index everywhere."""
    (top_v, top_i, top_e, top_t, min_e, min_t, min_edp, min_m, argm,
     lmin, larg) = state
    v = _metric_of(metric, es, ts)
    min_e = torch.minimum(min_e, es.amin(dim=0))
    min_t = torch.minimum(min_t, ts.amin(dim=0))
    min_edp = torch.minimum(min_edp, (es * ts).amin(dim=0))
    cmin = v.amin(dim=0)
    better = cmin < min_m
    min_m = torch.where(better, cmin, min_m)
    argm = torch.where(better, base + v.argmin(dim=0), argm)

    # per-(network, layer) metric minima; strict < keeps the earlier
    # (lower-index) config on ties
    vl = torch.where(lay_valid, _metric_of(metric, e, t), float("inf"))
    clmin = vl.amin(dim=0)
    lbetter = clmin < lmin
    lmin = torch.where(lbetter, clmin, lmin)
    larg = torch.where(lbetter, base + vl.argmin(dim=0), larg)

    all_v = torch.cat([top_v, v])
    all_i = torch.cat([top_i, _chunk_index(v, base)])
    order = _lex_order(all_v, all_i, topk)
    top_e = _take_rows(top_e, e, order)
    top_t = _take_rows(top_t, t, order)
    top_v = torch.gather(all_v, 0, order)
    top_i = torch.gather(all_i, 0, order)

    mask = v <= min_m[None, :] * (1.0 + bound)
    return (top_v, top_i, top_e, top_t, min_e, min_t, min_edp, min_m,
            argm, lmin, larg), mask


def stream_layer_topk(grid: ConfigGrid,
                      networks: Mapping[str, Sequence[Layer]],
                      *,
                      device=None,
                      backend: str | None = None,
                      topk: int = 8,
                      chunk_size: int = 4096,
                      metric: str = "edp",
                      bound: float | None = None,
                      resume_from: "StreamFoldState | Mapping | None" = None,
                      on_chunk=None,
                      nan_guard: bool = True,
                      verify=None,
                      shard: bool = False) -> LayerTopK:
    """Streamed per-layer sweep: one pass, every co-design reduction.

    Equivalent to ``evaluate_networks(..., per_layer=True)`` followed by
    per-network reductions on the layer-summed metric, at bounded memory:
    only one chunk's ``[chunk, n_net, n_layer]`` tensors are ever alive
    on ``device``, and the state carries ``topk`` per-layer rows per
    network plus the running aggregate and per-(network, layer) minima.
    With ``bound=`` the result also carries the per-network boundary
    candidate sets (flat indices + aggregate energy/latency, sorted by
    (metric, index)).  ``device``, ``backend``, ``resume_from``,
    ``on_chunk``, ``nan_guard`` (on the layer sums), ``verify`` and
    ``shard`` act as in :func:`stream_networks`."""
    global _LAST_BACKEND
    dev = resolve_device(device)
    check_shard(shard, dev)
    backend = resolve_backend(backend, dev)
    names = tuple(networks)
    n_net = len(names)
    lay, segments = _device_layers(networks, dev, absorb_pad=False)
    n_layer = _layer_axis_len(segments)
    fields = grid.fields if isinstance(grid, ConfigGrid) else dict(grid)
    n = int(next(iter(fields.values())).shape[0])
    chunk = max(1, min(chunk_size, n))
    n_chunks = -(-n // chunk)
    lay_counts = network_layer_counts(networks)
    lay_valid = torch.as_tensor(
        np.arange(n_layer)[None, :] < lay_counts[:, None], device=dev)

    k = int(topk)
    inf, i64 = float("inf"), torch.int64
    state = (_full((k, n_net), inf, dev),               # top_v
             _full((k, n_net), -1, dev, i64),           # top_i
             _full((k, n_net, n_layer), 0.0, dev),      # top_e
             _full((k, n_net, n_layer), 0.0, dev),      # top_t
             _full((n_net,), inf, dev),                 # min_energy
             _full((n_net,), inf, dev),                 # min_latency
             _full((n_net,), inf, dev),                 # min_edp
             _full((n_net,), inf, dev),                 # min_metric
             _full((n_net,), -1, dev, i64),             # argmin
             _full((n_net, n_layer), inf, dev),         # layer_min_metric
             _full((n_net, n_layer), -1, dev, i64))     # layer_argmin
    b = 0.0 if bound is None else float(bound)
    cand: Dict[str, list] = {nm: [] for nm in names}
    ihash = stream_input_hash(fields, networks, kind="layer_topk",
                              metric=metric, bound=bound, topk=k,
                              chunk=chunk)
    done = 0
    if resume_from is not None:
        state, cand, done = _resume_fold(resume_from, kind="layer_topk",
                                         ihash=ihash, names=names,
                                         device=dev)
    if verify is not None:
        verify.bind(kind="layer_topk", names=names, metric=metric,
                    topk=k, bound=bound, backend=backend,
                    ref_eval=_plain_ref_eval(lay, segments, True))
        if resume_from is not None:
            verify.check_resume(state, cand)
    _stage("stream setup")

    for ci, start, stop, fc in _chunk_rows(fields, n, chunk, done):
        e, t = _eval_fields(fc, lay, segments, backend, dev, per_layer=True)
        e, t = _apply_chunk_hook(ci, e, t)
        es, ts = e.sum(dim=-1), t.sum(dim=-1)
        if nan_guard:                   # raises BEFORE the fold commits
            _guard_chunk(ci, start, stop, es, ts, names)
        if verify is not None:
            verify.check_chunk(ci, start, stop, fc, e, t)
        new_state, mask = _layer_reduce_body(metric, k, e, t, es, ts, start,
                                             b, lay_valid, state)
        if verify is not None:
            verify.check_fold(ci, start, stop, state, new_state,
                              es=es, ts=ts, mask=mask)
        state = new_state
        if bound is not None:
            _collect_hits(cand, names, mask, es, ts, start)
        _stage("chunk fold")
        if on_chunk is not None:
            on_chunk(StreamFoldState(
                kind="layer_topk", input_hash=ihash, next_chunk=ci + 1,
                n_chunks=n_chunks, chunk_size=chunk, n_cfg=n,
                networks=names, metric=metric, bound=bound, topk=k,
                state=state, cand={nm: list(v) for nm, v in cand.items()}))

    (top_v, top_i, top_e, top_t, min_e, min_t, min_edp, min_m, argm,
     lmin, larg) = (_to_host(s) for s in state)
    b_idx = b_e = b_t = None
    if bound is not None:
        b_idx, b_e, b_t = {}, {}, {}
        for j, nm in enumerate(names):
            idx, ee, tt, v = _pruned_candidates(cand[nm], metric, min_m[j],
                                                b)
            order = np.lexsort((idx, v))       # metric, then lower index
            b_idx[nm], b_e[nm], b_t[nm] = idx[order], ee[order], tt[order]
    _stage("stream finish")
    _LAST_BACKEND = backend
    return LayerTopK(
        networks=names, n_cfg=n, metric=metric,
        layer_counts=lay_counts,
        topk_idx=top_i, topk_metric=top_v,
        layer_energy=top_e, layer_latency=top_t,
        min_energy=min_e, min_latency=min_t, min_edp=min_edp,
        min_metric=min_m, argmin=argm,
        layer_min_metric=lmin, layer_argmin=larg,
        bound=bound, boundary_idx=b_idx,
        boundary_energy=b_e, boundary_latency=b_t)


def _shift_idx(idx: np.ndarray, offset: int) -> np.ndarray:
    """Shift flat grid indices by ``offset``, preserving -1 sentinels."""
    idx = np.asarray(idx)
    return np.where(idx >= 0, idx + offset, idx)


def merge_layer_topk(a: LayerTopK, b: LayerTopK) -> LayerTopK:
    """Fold two completed streamed sweeps over consecutive grid-row ranges,
    on the host in numpy.

    ``a`` covers rows ``[0, a.n_cfg)`` of some grid and ``b`` the APPENDED
    rows ``[a.n_cfg, a.n_cfg + b.n_cfg)`` streamed as a grid of their own
    (its flat indices are local, so they are shifted by ``a.n_cfg`` here).
    Every streamed reduction ties by (value, flat index), so the merge is
    BIT-identical to streaming the concatenated grid from scratch.  Each
    part's boundary set was pruned against its own minimum; the merged
    threshold ``min(a_min, b_min)·(1+bound)`` is no looser than either, so
    nothing pruned early is ever needed.
    """
    if a.networks != b.networks:
        raise ValueError(
            f"cannot merge streams over different network sets "
            f"{a.networks} vs {b.networks}")
    if a.metric != b.metric or a.bound != b.bound:
        raise ValueError(
            f"cannot merge streams with different reduction parameters: "
            f"(metric, bound) = ({a.metric!r}, {a.bound}) vs "
            f"({b.metric!r}, {b.bound})")
    if a.topk_idx.shape != b.topk_idx.shape:
        raise ValueError(
            f"cannot merge streams with different top-k sizes "
            f"{a.topk_idx.shape[0]} vs {b.topk_idx.shape[0]}")
    off = int(a.n_cfg)
    k = a.topk_idx.shape[0]

    all_v = np.concatenate([a.topk_metric, b.topk_metric], axis=0)
    all_i = np.concatenate([a.topk_idx, _shift_idx(b.topk_idx, off)],
                           axis=0)
    order = np.lexsort((all_i, all_v), axis=0)[:k]
    top_v = np.take_along_axis(all_v, order, axis=0)
    top_i = np.take_along_axis(all_i, order, axis=0)
    all_e = np.concatenate([a.layer_energy, b.layer_energy], axis=0)
    all_t = np.concatenate([a.layer_latency, b.layer_latency], axis=0)
    top_e = np.take_along_axis(all_e, order[:, :, None], axis=0)
    top_t = np.take_along_axis(all_t, order[:, :, None], axis=0)

    # aggregate minima: strict < keeps the LOWER-index (a) side on ties
    better = b.min_metric < a.min_metric
    min_m = np.where(better, b.min_metric, a.min_metric)
    argm = np.where(better, _shift_idx(b.argmin, off), a.argmin)
    lbetter = b.layer_min_metric < a.layer_min_metric
    lmin = np.where(lbetter, b.layer_min_metric, a.layer_min_metric)
    larg = np.where(lbetter, _shift_idx(b.layer_argmin, off),
                    a.layer_argmin)

    b_idx = b_e = b_t = None
    if a.bound is not None:
        b_idx, b_e, b_t = {}, {}, {}
        for j, nm in enumerate(a.networks):
            entries = [(a.boundary_idx[nm], a.boundary_energy[nm],
                        a.boundary_latency[nm]),
                       (b.boundary_idx[nm] + off, b.boundary_energy[nm],
                        b.boundary_latency[nm])]
            idx, ee, tt, v = _pruned_candidates(entries, a.metric, min_m[j],
                                                float(a.bound))
            order = np.lexsort((idx, v))        # metric, then lower index
            b_idx[nm], b_e[nm], b_t[nm] = idx[order], ee[order], tt[order]

    return LayerTopK(
        networks=a.networks, n_cfg=off + int(b.n_cfg), metric=a.metric,
        layer_counts=a.layer_counts,
        topk_idx=top_i, topk_metric=top_v,
        layer_energy=top_e, layer_latency=top_t,
        min_energy=np.minimum(a.min_energy, b.min_energy),
        min_latency=np.minimum(a.min_latency, b.min_latency),
        min_edp=np.minimum(a.min_edp, b.min_edp),
        min_metric=min_m, argmin=argm,
        layer_min_metric=lmin, layer_argmin=larg,
        bound=a.bound, boundary_idx=b_idx,
        boundary_energy=b_e, boundary_latency=b_t)
