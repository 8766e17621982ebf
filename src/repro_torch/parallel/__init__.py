from repro_torch.parallel.partitioner import (
    DEFAULT_RULES, Spec, assign_spec, local_slice, merge_rules)
from repro_torch.parallel.collectives import compressed_psum_pods

__all__ = ["DEFAULT_RULES", "Spec", "assign_spec", "local_slice",
           "merge_rules", "compressed_psum_pods"]
