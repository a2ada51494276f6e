"""ZeRO compatibility checks.

Port of deepspeed_tpu/runtime/zero/utils.py (reference:
deepspeed/runtime/zero/utils.py:36-58 whitelists the optimizers whose state
ZeRO knows how to partition, and the engine refuses other client
optimizers unless ``zero_allow_untested_optimizer``, engine.py:681-700).
Here ZeRO partitions each parameter-shaped state list leaf by leaf, so an
optimizer qualifies when it is one of the port's FusedAdam, FusedLamb and
SGD: element-wise updates over the shards, and LAMB's per-tensor norms
reduced over the data-parallel group.
"""
from deepspeed_tpu_torch.utils.logging import logger


class ZeRORuntimeException(Exception):
    pass


def _supported_classes():
    from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
    from deepspeed_tpu_torch.ops.adam.sgd import SGD
    from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb

    return (FusedAdam, FusedLamb, SGD)


def is_zero_supported_optimizer(optimizer) -> bool:
    return isinstance(optimizer, _supported_classes())


def assert_zero_supported_optimizer(optimizer, allow_untested: bool):
    """Engine-side gate (reference engine.py:694-700): raise for other
    client optimizers unless zero_allow_untested_optimizer is set."""
    if is_zero_supported_optimizer(optimizer):
        return
    name = type(optimizer).__name__
    if allow_untested:
        logger.warning(f"**** You are using ZeRO with an untested optimizer "
                       f"{name!r} ****")
        return
    raise ZeRORuntimeException(
        f"You are using ZeRO with an optimizer ({name!r}) that is not "
        f"ZeRO-supported: the port partitions FusedAdam, FusedLamb and SGD. "
        f"Set 'zero_allow_untested_optimizer': true in the config to "
        f"proceed anyway")
