"""Hardware-fault scenarios of the port (:mod:`.hw_faults`)."""

from .hw_faults import (CoreFailure, DegradedArray,  # noqa: F401
                        FaultScenario, ScenarioBatch,
                        all_single_core_failures, apply_counts,
                        degrade_rows, expand_scenarios,
                        random_degradations, scenario_problems,
                        scenario_from_json, scenario_to_json)
