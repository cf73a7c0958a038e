"""Profiling hooks: a torch.profiler trace over a window of training steps.

The port of the JAX package's ``utils/profiling.py``: ``train(profile_dir=)``
traces steps ``[start, start + 10)`` (the loop passes its first iteration
plus 20) into ``profile_dir`` as a TensorBoard-readable trace
(``torch.profiler.tensorboard_trace_handler``: one ``*.pt.trace.json`` file,
the host's calls and, on the card, its kernels).
"""

import logging
from typing import Optional

import torch

logger = logging.getLogger(__name__)


class StepProfiler:
    """Starts a trace at ``start_step`` and stops it at ``stop_step``."""

    def __init__(self, profile_dir: Optional[str], start_step: int = 10,
                 num_steps: int = 10):
        self.profile_dir = profile_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._profile = None

    def maybe_start(self, step: int):
        if self.profile_dir and self._profile is None \
                and step == self.start_step:
            logger.info("Starting torch.profiler trace at step %d -> %s",
                        step, self.profile_dir)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profile = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    self.profile_dir))
            self._profile.start()

    def maybe_stop(self, step: int):
        if self._profile is not None and step >= self.stop_step:
            self.close()
            logger.info("Stopped torch.profiler trace at step %d", step)

    def close(self):
        if self._profile is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._profile.stop()
            self._profile = None
