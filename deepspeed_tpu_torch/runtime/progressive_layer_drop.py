"""Progressive Layer Drop (reference:
deepspeed/runtime/progressive_layer_drop.py:5-33).

Port of deepspeed_tpu/runtime/progressive_layer_drop.py:
theta(t) = (1 - theta_0) * exp(-gamma * t) + theta_0, the per-layer keep
probability schedule. The engine advances it at every global step and hands
the current theta to the model in the batch (``pld_theta``), as the JAX
engine does.
"""
import math


class ProgressiveLayerDrop:
    def __init__(self, theta=0.5, gamma=0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self):
        return self.current_theta

    def update_state(self, global_step):
        def _prob(x, gamma, p):
            return (1.0 - p) * math.exp(-gamma * x) + p

        self.current_theta = _prob(global_step, self.gamma, self.theta)
