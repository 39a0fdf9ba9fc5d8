"""Opt-in training-step profiling (port of
myrtle_vision_tpu/utils/profiling.py on ``torch.profiler``).

Setting ``MVT_PROFILE_DIR=/path`` makes every train CLI trace a few warm
steps: host activity, and the card's kernels when CUDA is available,
written as a Chrome trace (viewable in Perfetto or chrome://tracing) to
``<dir>/trace_steps_<first>_<last>.json``.  Without the variable the
profiler does nothing.
"""
from __future__ import annotations

import os

import torch


class StepProfiler:
    """Traces steps [start, start + num_steps) when MVT_PROFILE_DIR is
    set; otherwise a no-op.  ``step(iteration)`` is called after each
    optimizer step with the iteration count it reached."""

    def __init__(self, start: int = 3, num_steps: int = 3):
        self.trace_dir = os.environ.get("MVT_PROFILE_DIR")
        self.start = start
        self.stop = start + num_steps
        self._prof = None

    def _trace_path(self) -> str:
        return os.path.join(
            self.trace_dir,
            f"trace_steps_{self.start}_{self.stop - 1}.json")

    def step(self, iteration: int) -> None:
        if self.trace_dir is None:
            return
        if self._prof is None and iteration == self.start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            print(f"[profiler] tracing steps {self.start}..{self.stop - 1} "
                  f"-> {self.trace_dir}")
        elif self._prof is not None and iteration >= self.stop:
            self._finish()
            print(f"[profiler] trace written to {self._trace_path()}")

    def _finish(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        self._prof.export_chrome_trace(self._trace_path())
        self._prof = None

    def close(self) -> None:
        if self._prof is not None:
            self._finish()
