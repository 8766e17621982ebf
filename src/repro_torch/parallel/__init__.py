from repro_torch.parallel.partitioner import (
    DEFAULT_RULES, Spec, assign_spec, local_slice, merge_rules, param_spec,
    shard_tree, tree_specs, unshard_tree)
from repro_torch.parallel.collectives import compressed_psum_pods

__all__ = ["DEFAULT_RULES", "Spec", "assign_spec", "local_slice",
           "merge_rules", "param_spec", "shard_tree", "tree_specs",
           "unshard_tree", "compressed_psum_pods"]
