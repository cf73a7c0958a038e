"""The decode's check sample and the harness's own launches: the sample
of batches is uniform over the window's batches at a fixed size, and the
launch count leaves out the kernels launched in the ``checksum`` span."""

from types import SimpleNamespace

import numpy as np

from benchmark.drivers.greedy_decode import Session
from benchmark.harness import trace


def sampled(seed: int, batches: int, checked: int):
    """The batch indices that the reservoir holds after ``batches``."""
    holder = SimpleNamespace(seen=0, checked=checked, kept=[],
                             sample_rng=np.random.default_rng([seed, 2]))
    for i in range(batches):
        slot = Session._slot(holder)
        if slot is not None:
            holder.kept[slot] = i
    return holder.kept


def test_the_sample_is_fixed_in_size_and_uniform_over_the_batches():
    assert sampled(2**31 + 1, 5, 16) == [0, 1, 2, 3, 4]
    picks = [sampled(seed, 500, 16) for seed in range(200)]
    assert all(len(p) == 16 and len(set(p)) == 16 for p in picks)
    counts = np.bincount(np.concatenate(picks), minlength=500)
    # 3,200 picks over 500 batches: each tenth of the window gets ~320.
    tenths = counts.reshape(10, 50).sum(axis=1)
    assert tenths.min() > 260 and tenths.max() < 380


class Event:
    def __init__(self, name, start, duration, cuda=False):
        self._name, self._start, self._duration = name, start, duration
        self._cuda = cuda

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._duration

    def device_type(self):
        import torch
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)


def test_launches_in_the_checksum_span_are_the_harness_own():
    events = [
        Event("window", 0, 1000),
        Event("decode_batch", 10, 500),
        Event("cudaLaunchKernel", 20, 1),       # the program's
        Event("cuLaunchKernelEx", 30, 1),       # the program's
        Event("checksum", 400, 100),
        Event("cudaLaunchKernel", 410, 1),      # the harness's
        Event("cudaLaunchKernelExC", 420, 1),   # the harness's
        Event("cudaMemcpyAsync", 430, 1),       # a copy, no kernel
        Event("cudaGraphLaunch", 440, 1),       # no kernel of its own
        Event("cudaLaunchKernel", 1500, 1),     # after the window
        Event("gemm", 100, 50, cuda=True),
        Event("reduce", 450, 20, cuda=True),
    ]
    reduced = trace.reduce(events)
    assert reduced.harness_launches == 2
    assert len(reduced.kernels()) == 2
    assert reduced.busy_s == 70 / 1e9
