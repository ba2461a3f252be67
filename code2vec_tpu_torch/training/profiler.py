"""`--profile` support: trace a window of training steps with
`torch.profiler`.

The counterpart of training/profiler.py of the JAX package, whose window
is `jax.profiler.start_trace` / `stop_trace`: `--profile <dir>` wraps
steps [PROFILE_START_STEP, PROFILE_START_STEP + PROFILE_STEPS) of this
process's run in a `torch.profiler.profile` of the CPU and, where CUDA
is available, the CUDA activities, and writes its Chrome trace
(`chrome://tracing`, Perfetto) to `<dir>/trace_<pid>.json`.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch

from code2vec_tpu_torch.obs.telemetry import device_sync


class StepProfiler:
    """Drives one bounded `torch.profiler` window over a train loop.

    Call `tick(step, sync_tree)` once per step BEFORE launching the
    step's device work, with `step` counted from the start of this
    process (so resumed runs still profile), and `finish(sync_tree)`
    after the loop, which closes a window still open. `sync_tree` holds
    a tensor whose device work is waited for before the window closes,
    so the trace holds the window's whole device timeline.
    """

    def __init__(self, profile_dir: Optional[str], start_step: int,
                 num_steps: int,
                 log: Optional[Callable[[str], None]] = None):
        self.profile_dir = profile_dir
        self.start_step = start_step
        self.num_steps = num_steps
        self.log = log or (lambda _msg: None)
        self.trace_path: Optional[str] = None
        self._prof: Optional[torch.profiler.profile] = None
        self._done = profile_dir is None
        self._stop_at = start_step + num_steps

    def tick(self, step: int, sync_tree) -> None:
        if self._done:
            return
        if self._prof is None and step >= self.start_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            self.log(f"profiler: tracing {self.num_steps} steps "
                     f"-> {self.profile_dir}")
        elif self._prof is not None and step >= self._stop_at:
            self._stop(sync_tree)

    def finish(self, sync_tree) -> None:
        """Close the window if the run ended inside it."""
        if self._prof is not None:
            self._stop(sync_tree)
        elif not self._done:
            # --profile was requested but the run ended before
            # start_step: say so instead of leaving an empty directory
            self.log(f"profiler: run ended before step {self.start_step};"
                     f" no trace written (train longer)")
            self._done = True

    def _stop(self, sync_tree) -> None:
        device_sync(sync_tree)  # the window's kernels have finished
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        self.trace_path = os.path.join(self.profile_dir,
                                       f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(self.trace_path)
        self._done = True
        self.log(f"profiler: trace written to {self.trace_path}")
