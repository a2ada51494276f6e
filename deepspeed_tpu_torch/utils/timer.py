"""Wall-clock and throughput timers.

Port of deepspeed_tpu/utils/timer.py (reference: deepspeed/utils/
timer.py:19-170). Like the reference, a timer synchronizes the device
before it reads the clock — ``torch.cuda.synchronize`` on a CUDA
device, nothing on the CPU — so its numbers are device time, and each
start or stop costs one host sync.  The training engine uses them only
under ``wall_clock_breakdown``, as the reference does.
"""
import time

import torch

from deepspeed_tpu_torch.utils.logging import log_dist


def _device_sync(device=None):
    """Wait for the device's queued work (a no-op off CUDA)."""
    if device is not None and torch.device(device).type != "cuda":
        return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize(device)


class SynchronizedWallClockTimer:
    """Named timers that synchronize the device before reading the
    clock. ``device``: the device to wait for (None: the current CUDA
    device, when CUDA is up)."""

    class Timer:
        def __init__(self, name: str, device=None):
            self.name_ = name
            self.device = device
            self.elapsed_ = 0.0
            self.started_ = False
            self.start_time = 0.0

        def start(self):
            assert not self.started_, f"timer {self.name_} already started"
            _device_sync(self.device)
            self.start_time = time.time()
            self.started_ = True

        def stop(self, reset=False):
            assert self.started_, f"timer {self.name_} not started"
            _device_sync(self.device)
            if reset:
                self.elapsed_ = time.time() - self.start_time
            else:
                self.elapsed_ += time.time() - self.start_time
            self.started_ = False

        def reset(self):
            self.elapsed_ = 0.0
            self.started_ = False

        def elapsed(self, reset=True):
            started = self.started_
            if started:
                self.stop()
            elapsed_ = self.elapsed_
            if reset:
                self.reset()
            if started:
                self.start()
            return elapsed_

    def __init__(self, device=None):
        self.device = device
        self.timers = {}

    def __call__(self, name: str) -> "SynchronizedWallClockTimer.Timer":
        if name not in self.timers:
            self.timers[name] = self.Timer(name, self.device)
        return self.timers[name]

    def memory_usage(self) -> str:
        """The allocator's in-use and peak bytes of the device (the
        runtime/memory_accounting.py reader); empty off CUDA."""
        from deepspeed_tpu_torch.runtime.memory_accounting import \
            device_memory_report

        lines = []
        for entry in device_memory_report(self.device):
            if entry["bytes_in_use"] is None:
                continue
            used = entry["bytes_in_use"] / (1024**3)
            peak = (entry["peak_bytes_in_use"] or 0) / (1024**3)
            lines.append(f"{entry['kind']}:{entry['id']}: "
                         f"in_use {used:.2f} GB | peak {peak:.2f} GB")
        return " | ".join(lines)

    def log(self, names, normalizer=1.0, reset=True, ranks=None,
            memory_breakdown=False):
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].elapsed(reset=reset) \
                    * 1000.0 / normalizer
                string += f" | {name}: {elapsed_time:.2f}"
        if memory_breakdown:
            string += " | " + self.memory_usage()
        log_dist(string, ranks=ranks or [0])


class ThroughputTimer:
    """Samples/sec tracking with warm-up steps skipped (reference:
    utils/timer.py:97-170)."""

    def __init__(self, batch_size, num_workers=1, start_step=2,
                 steps_per_output=50, monitor_memory=False, logging_fn=None,
                 device=None):
        self.start_time = 0.0
        self.end_time = 0.0
        self.started = False
        self.batch_size = max(1, batch_size)
        self.num_workers = num_workers
        self.start_step = start_step
        self.epoch_count = 0
        self.local_step_count = 0
        self.total_step_count = 0
        self.total_elapsed_time = 0.0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.device = device
        self.logging = logging_fn or (lambda msg: log_dist(msg, ranks=[0]))
        self.initialized = False

    def update_epoch_count(self):
        self.epoch_count += 1
        self.local_step_count = 0

    def _init_timer(self):
        self.initialized = True

    def start(self):
        self._init_timer()
        self.started = True
        if self.total_step_count >= self.start_step:
            _device_sync(self.device)
            self.start_time = time.time()

    def stop(self, report_speed=True):
        if not self.started:
            return
        self.started = False
        self.total_step_count += 1
        self.local_step_count += 1
        if self.total_step_count > self.start_step:
            _device_sync(self.device)
            self.end_time = time.time()
            duration = self.end_time - self.start_time
            self.total_elapsed_time += duration
            if report_speed \
                    and self.local_step_count % self.steps_per_output == 0:
                self.logging(
                    f"epoch={self.epoch_count}/micro_step="
                    f"{self.local_step_count}/global_step="
                    f"{self.total_step_count}, RunningAvgSamplesPerSec="
                    f"{self.avg_samples_per_sec():.6f}, CurrSamplesPerSec="
                    f"{self.batch_size * self.num_workers / duration:.6f}")

    def avg_samples_per_sec(self):
        if self.total_elapsed_time > 0 \
                and self.total_step_count > self.start_step:
            samples = self.batch_size * self.num_workers \
                * (self.total_step_count - self.start_step)
            return samples / self.total_elapsed_time
        return float("-1")
