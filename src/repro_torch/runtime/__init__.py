from repro_torch.runtime.faults import (DEFAULT_FREEZE_READS, FAULT_KINDS,
                                        FaultEvent, FaultInjected, FaultPlan)
from repro_torch.runtime.preemption import Preempted, PreemptionHandler

__all__ = ["DEFAULT_FREEZE_READS", "FAULT_KINDS", "FaultEvent",
           "FaultInjected", "FaultPlan", "Preempted", "PreemptionHandler"]
