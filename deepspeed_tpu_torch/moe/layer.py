"""DeepSpeed-style MoE entry point.

Port of deepspeed_tpu/moe/layer.py. Later DeepSpeed exposes
``deepspeed.moe.layer.MoE(hidden_size, expert, num_experts, k,
capacity_factor, ...)``; users coming from there find the equivalent
here. The experts are stacked weight tensors, not wrapped submodules, so
``hidden_size`` and ``expert_intermediate_size`` map onto the layer's
sizes instead of wrapping a module.
"""
import torch

from deepspeed_tpu_torch.moe.sharded_moe import MoE as _MoE


def MoE(hidden_size: int, num_experts: int = 1, k: int = 1,
        capacity_factor: float = 1.0, eval_capacity_factor: float = 0.0,
        min_capacity: int = 4, expert_intermediate_size: int = 0,
        aux_loss_coef: float = 0.01, noisy_gate_policy: str = None,
        generator=None, **kw):
    """Build the MoE layer with DeepSpeed-MoE argument names, its weights
    drawn from ``generator`` (seed 0 if None).

    noisy_gate_policy: None or 'Jitter' (maps to router_jitter=0.01;
    DeepSpeed's 'RSample' has no equivalent here).
    """
    if noisy_gate_policy not in (None, "Jitter"):
        # a ported DeepSpeed config expecting RSample noise must not get
        # silently-different gating
        raise ValueError(
            f"noisy_gate_policy={noisy_gate_policy!r} is not supported; "
            "use None or 'Jitter' (DeepSpeed's 'RSample' has no equivalent "
            "in this build)")
    jitter = 0.01 if noisy_gate_policy == "Jitter" else 0.0
    return _MoE(hidden_size, num_experts=num_experts,
                d_ff=expert_intermediate_size or 4 * hidden_size,
                k=k, capacity_factor=capacity_factor,
                eval_capacity_factor=eval_capacity_factor,
                min_capacity=min_capacity, aux_loss_coef=aux_loss_coef,
                router_jitter=jitter,
                generator=generator if generator is not None
                else torch.Generator().manual_seed(0), **kw)
