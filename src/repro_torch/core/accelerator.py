"""Accelerator configuration for the array-based DNN accelerator simulator.

This mirrors §II.B.1 of the paper ("Tool's inputs"): PE-array geometry, the
global-buffer partition (GB_ifmap / GB_psum / GB_weight), register-file sizes,
per-access energy & latency for every memory level, MAC energy/latency, NoC
delivery bandwidth, and the storage/compute bit width.

The paper calibrates per-access numbers with CACTI and a synthesized MAC; the
absolute values are therefore foundry/library-specific.  What the paper *does*
pin down (§II, "the energy cost of the memory hierarchy from register files to
DRAM is incremental ... DRAM ≈ several tens of RF, GB ≈ 5–10× RF") is the
*ratio structure*, which is what all of its observations and tables depend on.
``EnergyTable.cacti_like`` reproduces that structure with a capacity-dependent
global-buffer model (energy/latency grow ~sqrt(capacity), the usual SRAM
scaling CACTI reports to first order).

The PyTorch port keeps this module as its own copy of ``repro.core.accelerator`` (it
imports nothing from the JAX package); ``tests/test_torch_engine.py`` holds
the two copies equal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import numpy as np

# The exact sweep values used throughout §III / §IV of the paper.
GB_SIZES_KB: Tuple[int, ...] = (13, 27, 54, 108, 216)
ARRAY_SIZES: Tuple[Tuple[int, int], ...] = (
    (12, 14), (16, 16), (32, 32), (64, 64), (128, 128), (256, 256))

# Finer GB grid for the extended (≥5,000-point) design space: the paper's
# five sizes plus geometric midpoints, so the engine can resolve the
# Observation-1/2 breakpoints between the paper's coarse steps.
EXTENDED_GB_SIZES_KB: Tuple[int, ...] = (
    9, 13, 20, 27, 40, 54, 80, 108, 160, 216)
# Extended per-PE psum scratch-pad sizes (Eyeriss uses 24) and NoC delivery
# widths — the two non-GB knobs §II.B.1 lists as Tool inputs.
RF_PSUM_SIZES: Tuple[int, ...] = (16, 24, 32)
NOC_WIDTHS: Tuple[float, ...] = (2.0, 4.0, 8.0)

# The mega space (~49k points) for the sharded/chunked streaming engine:
# the full EXTENDED_GB_SIZES_KB cross continued past 216KB (the Fig. 5/6
# right-hand tails), intermediate/larger arrays, and wider RF/NoC ranges.
MEGA_GB_SIZES_KB: Tuple[int, ...] = EXTENDED_GB_SIZES_KB + (320, 432, 648, 864)
MEGA_ARRAY_SIZES: Tuple[Tuple[int, int], ...] = ARRAY_SIZES + (
    (24, 24), (48, 48), (96, 96), (192, 192))
MEGA_RF_PSUM_SIZES: Tuple[int, ...] = (8, 16, 24, 32, 48)
MEGA_NOC_WIDTHS: Tuple[float, ...] = (1.0, 2.0, 4.0, 8.0, 16.0)


@dataclasses.dataclass(frozen=True)
class EnergyTable:
    """Per-access energy (pJ) and latency (ns) for each memory level.

    All values are *per word* of the configured bit width (the tool counts
    word-granularity accesses; wider interfaces are modelled by the
    ``words_per_cycle`` fields on :class:`AcceleratorConfig`).
    """

    rf_read: float = 1.0           # register file (scratch pad) read
    rf_write: float = 1.0
    gb_read: float = 6.0           # global buffer @ reference capacity
    gb_write: float = 6.0
    dram_read: float = 200.0       # off-chip DRAM (Eyeriss-published ratio;
    dram_write: float = 200.0      # the paper says "several tens of" RF)
    mac: float = 1.0               # one multiply-accumulate
    pe_idle: float = 0.02          # per-PE per-cycle clock/leakage energy
    noc_hop: float = 0.05          # per-word-per-hop transfer energy

    rf_t: float = 1.0              # ns per access
    gb_t: float = 2.0
    dram_t: float = 20.0
    mac_t: float = 1.0             # ns per MAC (pipelined PEs: 1/cycle)

    gb_ref_kb: float = 54.0        # capacity at which gb_read/gb_write hold

    def gb_energy(self, size_kb: float) -> float:
        """Capacity-scaled GB access energy (CACTI first-order ~sqrt(cap))."""
        return self.gb_read * math.sqrt(max(size_kb, 1.0) / self.gb_ref_kb)

    def gb_latency(self, size_kb: float) -> float:
        return self.gb_t * math.sqrt(math.sqrt(max(size_kb, 1.0) / self.gb_ref_kb))


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """One processing core (Fig. 2): PE array + RF / GB / DRAM hierarchy."""

    array_rows: int = 16
    array_cols: int = 16
    gb_ifmap_kb: float = 54.0      # GB partition for input feature maps
    gb_psum_kb: float = 54.0       # GB partition for partial sums
    gb_weight_kb: float = 108.0    # assumed "large enough" (§III) — held fixed
    rf_ifmap_words: int = 12       # per-PE scratch pad shares (Eyeriss-like)
    rf_weight_words: int = 224
    rf_psum_words: int = 24
    bitwidth: int = 16             # storage & compute bit width
    noc_words_per_cycle: float = 4.0   # GB->array delivery bandwidth (words/cy)
    dram_words_per_cycle: float = 1.0  # DRAM<->GB interface bandwidth
    cycle_ns: float = 1.0
    energy: EnergyTable = dataclasses.field(default_factory=EnergyTable)

    @property
    def num_pes(self) -> int:
        return self.array_rows * self.array_cols

    @property
    def bytes_per_word(self) -> float:
        return self.bitwidth / 8.0

    def gb_ifmap_words(self) -> int:
        return int(self.gb_ifmap_kb * 1024 / self.bytes_per_word)

    def gb_psum_words(self) -> int:
        return int(self.gb_psum_kb * 1024 / self.bytes_per_word)

    def replace(self, **kw) -> "AcceleratorConfig":
        return dataclasses.replace(self, **kw)

    def label(self) -> str:
        return (f"[{self.array_rows},{self.array_cols}]"
                f" psum={self.gb_psum_kb:g}KB ifmap={self.gb_ifmap_kb:g}KB")


# ---------------------------------------------------------------------------
# Vectorised design spaces: the batched DSE engine consumes a struct-of-arrays
# ConfigGrid, never per-point AcceleratorConfig objects.
# ---------------------------------------------------------------------------

#: Primitive per-config columns of a ConfigGrid, in canonical order.  Derived
#: quantities (GB words, capacity-scaled GB energy/latency) are computed by
#: the energy model from these.
GRID_COLUMNS: Tuple[str, ...] = (
    "rows", "cols", "gb_ifmap_kb", "gb_psum_kb", "gb_weight_kb",
    "rf_ifmap_words", "rf_weight_words", "rf_psum_words", "bitwidth",
    "noc_wpc", "dram_wpc", "cycle_ns",
    "e_rf", "e_dram_r", "e_dram_w", "e_mac", "e_pe_idle", "e_noc_hop",
    "gb_e_ref", "gb_t_ref", "gb_ref_kb", "mac_t")


#: Columns that must be strictly positive: geometry, capacities, bandwidths
#: and reference latencies act as divisors or multiplicative scales in the
#: energy model — zero or negative values silently produce garbage (or
#: divide-by-zero) energies instead of an error.
_POSITIVE_COLUMNS: Tuple[str, ...] = (
    "rows", "cols", "gb_ifmap_kb", "gb_psum_kb", "gb_weight_kb",
    "rf_ifmap_words", "rf_weight_words", "rf_psum_words", "bitwidth",
    "noc_wpc", "dram_wpc", "cycle_ns", "gb_t_ref", "gb_ref_kb", "mac_t")
#: Per-access energy coefficients: zero is a legitimate ablation, negative
#: energy is not.
_NONNEGATIVE_COLUMNS: Tuple[str, ...] = (
    "e_rf", "e_dram_r", "e_dram_w", "e_mac", "e_pe_idle", "e_noc_hop",
    "gb_e_ref")


def validate_fields(fields: Dict[str, np.ndarray], *,
                    context: str = "ConfigGrid") -> None:
    """Reject NaN/inf/non-positive config parameters at the engine boundary.

    Raises ``ValueError`` naming the offending column and row index — the
    alternative is a silent garbage energy surfacing many layers later in
    a reduction or a Pareto frontier."""
    for k in GRID_COLUMNS:
        v = np.asarray(fields[k])
        bad = ~np.isfinite(v)
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(
                f"{context}: column {k!r} row {i} is non-finite "
                f"({v.reshape(-1)[i]!r}); the energy model would silently "
                f"propagate it into every reduction")
        if k in _POSITIVE_COLUMNS:
            bad = v <= 0
            if bad.any():
                i = int(np.argmax(bad))
                raise ValueError(
                    f"{context}: column {k!r} row {i} must be > 0, got "
                    f"{v.reshape(-1)[i]!r}")
        elif k in _NONNEGATIVE_COLUMNS:
            bad = v < 0
            if bad.any():
                i = int(np.argmax(bad))
                raise ValueError(
                    f"{context}: column {k!r} row {i} must be >= 0, got "
                    f"{v.reshape(-1)[i]!r}")


def _config_row(cfg: AcceleratorConfig) -> Tuple[float, ...]:
    et = cfg.energy
    return (cfg.array_rows, cfg.array_cols, cfg.gb_ifmap_kb, cfg.gb_psum_kb,
            cfg.gb_weight_kb, cfg.rf_ifmap_words, cfg.rf_weight_words,
            cfg.rf_psum_words, cfg.bitwidth, cfg.noc_words_per_cycle,
            cfg.dram_words_per_cycle, cfg.cycle_ns,
            et.rf_read, et.dram_read, et.dram_write, et.mac, et.pe_idle,
            et.noc_hop, et.gb_read, et.gb_t, et.gb_ref_kb, et.mac_t)


@dataclasses.dataclass(frozen=True)
class ConfigGrid:
    """A design space as parallel float64 columns of length ``n``.

    This is the input format of the batched DSE engine
    (:func:`repro_torch.core.energymodel.evaluate_networks`): the cross product is
    built directly as arrays, so a 5,000+-point space costs a handful of
    numpy ops instead of 5,000 dataclass constructions.
    """

    fields: Dict[str, np.ndarray]        # column name -> float64 [n]

    def __post_init__(self):
        n = {v.shape for v in self.fields.values()}
        if len(n) != 1:
            raise ValueError(f"ragged ConfigGrid columns: {n}")
        missing = set(GRID_COLUMNS) - set(self.fields)
        if missing:
            raise ValueError(f"ConfigGrid missing columns: {sorted(missing)}")
        validate_fields(self.fields)

    @property
    def n(self) -> int:
        return int(next(iter(self.fields.values())).shape[0])

    def __len__(self) -> int:
        return self.n

    def config_at(self, i: int, base: AcceleratorConfig | None = None
                  ) -> AcceleratorConfig:
        """Materialise one grid point as a config object (reports/labels).

        All model-relevant energy-table columns round-trip too, so
        ``simulate_network(grid.config_at(i))`` agrees with the batched
        engine even for non-default energy tables."""
        base = base or AcceleratorConfig()
        f = self.fields
        et = dataclasses.replace(
            base.energy,
            rf_read=float(f["e_rf"][i]),
            dram_read=float(f["e_dram_r"][i]),
            dram_write=float(f["e_dram_w"][i]),
            mac=float(f["e_mac"][i]), pe_idle=float(f["e_pe_idle"][i]),
            noc_hop=float(f["e_noc_hop"][i]),
            gb_read=float(f["gb_e_ref"][i]), gb_t=float(f["gb_t_ref"][i]),
            gb_ref_kb=float(f["gb_ref_kb"][i]), mac_t=float(f["mac_t"][i]))
        return base.replace(
            energy=et,
            array_rows=int(f["rows"][i]), array_cols=int(f["cols"][i]),
            gb_ifmap_kb=float(f["gb_ifmap_kb"][i]),
            gb_psum_kb=float(f["gb_psum_kb"][i]),
            gb_weight_kb=float(f["gb_weight_kb"][i]),
            rf_ifmap_words=int(f["rf_ifmap_words"][i]),
            rf_weight_words=int(f["rf_weight_words"][i]),
            rf_psum_words=int(f["rf_psum_words"][i]),
            bitwidth=int(f["bitwidth"][i]),
            noc_words_per_cycle=float(f["noc_wpc"][i]),
            dram_words_per_cycle=float(f["dram_wpc"][i]),
            cycle_ns=float(f["cycle_ns"][i]))

    def take(self, idx) -> "ConfigGrid":
        """Subset grid at the given flat indices (order preserved) — the
        streaming engine's chunking and the boundary-set consumers pull
        slices of a design space through this."""
        idx = np.asarray(idx)
        return ConfigGrid({k: v[idx] for k, v in self.fields.items()})

    def slice_rows(self, start: int, stop: int) -> "ConfigGrid":
        """Contiguous [start:stop) slice (no copy of untouched columns)."""
        return ConfigGrid({k: v[start:stop] for k, v in self.fields.items()})

    def with_columns(self, **cols) -> "ConfigGrid":
        """Copy of the grid with the named columns replaced (scalar or
        full-length array values).  The fault-scenario layer builds
        degraded core types through this — e.g. a PE array with disabled
        rows is the same config row with a shrunk ``rows`` column — and
        the constructor re-validates, so a transform can never smuggle a
        zero/NaN geometry past the engine boundary."""
        unknown = set(cols) - set(GRID_COLUMNS)
        if unknown:
            raise ValueError(f"unknown ConfigGrid columns: {sorted(unknown)}")
        fields = dict(self.fields)
        for k, v in cols.items():
            fields[k] = np.broadcast_to(
                np.asarray(v, dtype=np.float64), (self.n,)).copy()
        return ConfigGrid(fields)

    @staticmethod
    def concat(grids: Sequence["ConfigGrid"]) -> "ConfigGrid":
        """Row-wise concatenation (column order preserved) — the scenario
        expansion glues nominal chip rows and their degraded variants into
        one union grid so a single engine call evaluates them all."""
        grids = list(grids)
        if not grids:
            raise ValueError("ConfigGrid.concat needs >= 1 grid")
        return ConfigGrid({k: np.concatenate(
            [g.fields[k] for g in grids]) for k in GRID_COLUMNS})

    @classmethod
    def from_configs(cls, configs: Sequence[AcceleratorConfig]
                     ) -> "ConfigGrid":
        rows = np.asarray([_config_row(c) for c in configs], dtype=np.float64)
        return cls(dict(zip(GRID_COLUMNS, rows.T.copy())))

    @classmethod
    def product(cls,
                arrays: Sequence[Tuple[int, int]] = ARRAY_SIZES,
                gb_psum_kb: Sequence[float] = GB_SIZES_KB,
                gb_ifmap_kb: Sequence[float] = GB_SIZES_KB,
                rf_psum_words: Sequence[int] | None = None,
                noc_words_per_cycle: Sequence[float] | None = None,
                base: AcceleratorConfig | None = None) -> "ConfigGrid":
        """Cross product over (array × psum × ifmap [× rf_psum × noc]).

        Axis order (outer→inner) matches the classic ``sweep_network`` loop
        so results reshape onto the paper's [array, psum, ifmap] cube.  With
        the defaults this is the 150-point space of §IV; passing
        ``EXTENDED_GB_SIZES_KB`` / ``RF_PSUM_SIZES`` / ``NOC_WIDTHS`` grows
        it to 5,400 points.
        """
        base = base or AcceleratorConfig()
        rf_psum = ((base.rf_psum_words,) if rf_psum_words is None
                   else tuple(rf_psum_words))
        noc = ((base.noc_words_per_cycle,) if noc_words_per_cycle is None
               else tuple(noc_words_per_cycle))
        arr = np.asarray(arrays, dtype=np.float64)          # [nA, 2]
        axes = (np.arange(len(arr)), np.asarray(gb_psum_kb, np.float64),
                np.asarray(gb_ifmap_kb, np.float64),
                np.asarray(rf_psum, np.float64), np.asarray(noc, np.float64))
        ai, ps, ifm, rf, nw = [g.ravel() for g in
                               np.meshgrid(*axes, indexing="ij")]
        n = ai.size
        fields = dict(zip(GRID_COLUMNS,
                          np.tile(np.asarray(_config_row(base),
                                             np.float64)[:, None], (1, n))))
        fields["rows"] = arr[ai.astype(np.intp), 0]
        fields["cols"] = arr[ai.astype(np.intp), 1]
        fields["gb_psum_kb"] = ps
        fields["gb_ifmap_kb"] = ifm
        fields["rf_psum_words"] = rf
        fields["noc_wpc"] = nw
        return cls(fields)


def extended_grid(base: AcceleratorConfig | None = None) -> ConfigGrid:
    """The 5,400-point extended space: 6 arrays × 10² GB sizes × 3 RF_psum
    × 3 NoC widths (§II.B.1's knobs beyond the paper's 150 points)."""
    return ConfigGrid.product(
        arrays=ARRAY_SIZES, gb_psum_kb=EXTENDED_GB_SIZES_KB,
        gb_ifmap_kb=EXTENDED_GB_SIZES_KB, rf_psum_words=RF_PSUM_SIZES,
        noc_words_per_cycle=NOC_WIDTHS, base=base)


def mega_grid(base: AcceleratorConfig | None = None) -> ConfigGrid:
    """The 49,000-point mega space: 10 arrays × 14² GB sizes × 5 RF_psum
    × 5 NoC widths.  Built for the chunked/sharded streaming engine —
    evaluating it in one unchunked call would materialise multi-GB
    (unique-row × layer) intermediates."""
    return ConfigGrid.product(
        arrays=MEGA_ARRAY_SIZES, gb_psum_kb=MEGA_GB_SIZES_KB,
        gb_ifmap_kb=MEGA_GB_SIZES_KB, rf_psum_words=MEGA_RF_PSUM_SIZES,
        noc_words_per_cycle=MEGA_NOC_WIDTHS, base=base)


def config_grid(
    gb_psum_kb=GB_SIZES_KB,
    gb_ifmap_kb=GB_SIZES_KB,
    arrays=ARRAY_SIZES,
    base: AcceleratorConfig | None = None,
) -> Dict[Tuple[float, float, Tuple[int, int]], AcceleratorConfig]:
    """The paper's search space: |psum| × |ifmap| × |array| configs.

    With the default arguments this is the 5 × 5 × 6 = 150-point space of §IV.
    """
    base = base or AcceleratorConfig()
    grid = {}
    for p in gb_psum_kb:
        for i in gb_ifmap_kb:
            for (r, c) in arrays:
                grid[(p, i, (r, c))] = base.replace(
                    gb_psum_kb=float(p), gb_ifmap_kb=float(i),
                    array_rows=r, array_cols=c)
    return grid
