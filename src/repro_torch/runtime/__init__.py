from repro_torch.runtime.elastic import MeshPlan, degrade_sequence, plan_remesh
from repro_torch.runtime.faults import (DEFAULT_FREEZE_READS, FAULT_KINDS,
                                        FaultEvent, FaultInjected, FaultPlan)
from repro_torch.runtime.heartbeat import FailureDetector, Heartbeat
from repro_torch.runtime.preemption import Preempted, PreemptionHandler
from repro_torch.runtime.straggler import StragglerDetector
from repro_torch.runtime.supervisor import (DegradeToOneshot, ServeSupervisor,
                                            drain_with_oneshot, run_supervised)

__all__ = ["MeshPlan", "degrade_sequence", "plan_remesh",
           "FailureDetector", "Heartbeat", "StragglerDetector",
           "DEFAULT_FREEZE_READS", "FAULT_KINDS", "FaultEvent",
           "FaultInjected", "FaultPlan",
           "Preempted", "PreemptionHandler",
           "DegradeToOneshot", "ServeSupervisor", "drain_with_oneshot",
           "run_supervised"]
