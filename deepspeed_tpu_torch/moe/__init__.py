from deepspeed_tpu_torch.moe.sharded_moe import (MoE, StackedExperts,
                                                 expert_parallel,
                                                 moe_capacity, moe_leaf_spec,
                                                 sum_moe_losses,
                                                 top_k_gating)

__all__ = ["MoE", "StackedExperts", "expert_parallel", "moe_capacity",
           "moe_leaf_spec", "sum_moe_losses", "top_k_gating"]
