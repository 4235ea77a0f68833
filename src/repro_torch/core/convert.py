"""Carry a grid and networks across from another package as plain data.

The port keeps its own copies of ``accelerator`` and ``topology``.  These
two functions rebuild the port's objects from plain numpy columns and
dicts — ``ConfigGrid.fields`` and ``dataclasses.asdict(layer)`` of the JAX
package's objects, say — so both packages evaluate the same grid and the
same layers.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np

from .accelerator import GRID_COLUMNS, ConfigGrid
from .topology import Layer


def grid_from_fields(fields: Mapping[str, np.ndarray]) -> ConfigGrid:
    """A port ConfigGrid from ``{column: float64 [n]}`` (every column of
    ``GRID_COLUMNS``; validated like any grid)."""
    return ConfigGrid({k: np.array(fields[k], dtype=np.float64)
                       for k in GRID_COLUMNS})


def networks_from_dicts(nets: Mapping[str, Sequence[Mapping[str, Any]]]
                        ) -> Dict[str, List[Layer]]:
    """Port networks from ``{name: [layer as a field dict, ...]}``."""
    return {name: [Layer(**dict(d)) for d in layers]
            for name, layers in nets.items()}
