"""Fault tolerance of the port: the trainer's checkpoint-and-restart
supervisor (:mod:`.supervisor`), chunk-level fault injection
(:mod:`.faults`), the silent-corruption defense (:mod:`.verify`) and
hardware-fault scenarios (:mod:`.hw_faults`)."""

from .supervisor import (FaultInjector, Preemption,  # noqa: F401
                         Supervisor, WorkerFailure)
from .faults import (BackendFault, FaultPlan, ProcessKill,  # noqa: F401
                     StreamKill, inject_chunk_faults)
from .verify import (FoldInvariantError, ShadowMismatchError,  # noqa: F401
                     StreamVerifier, VerifyConfig,
                     check_layer_topk_result, scrub_layer_topk)
from .hw_faults import (CoreFailure, DegradedArray,  # noqa: F401
                        FaultScenario, ScenarioBatch,
                        all_single_core_failures, apply_counts,
                        degrade_rows, expand_scenarios,
                        random_degradations, scenario_problems,
                        scenario_from_json, scenario_to_json)
