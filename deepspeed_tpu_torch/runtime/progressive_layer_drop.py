"""Progressive Layer Drop (port of
``deepspeed_tpu/runtime/progressive_layer_drop.py``): the keep-parameter
schedule ``theta(t) = (1 - theta_bar) exp(-gamma t) + theta_bar``. The
engine evaluates the same schedule in fp32 at its step counter and
passes it to the model's forward (``engine._pld_theta``); this object
keeps the reference's host-side API."""

import numpy as np

from deepspeed_tpu_torch.utils.logging import log_dist


class ProgressiveLayerDrop:
    def __init__(self, theta=0.5, gamma=0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0
        log_dist("Enabled progressive layer dropping (theta = {})".format(
            self.theta), ranks=[0])

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self):
        return self.current_theta

    def update_state(self, global_step):
        def _prob(x, gamma, p):
            return (1.0 - p) * np.exp(-gamma * x) + p

        self.current_theta = _prob(global_step, self.gamma, self.theta)
