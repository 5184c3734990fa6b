"""The port's ``utils`` and ``config`` on the card (``chip_smoke.py`` phase
63's checks): the stall watchdog, ``StepTimer`` around the Macenko kernel
K1, a ``torch.profiler`` trace of K1 with an ``annotate`` region, and
``Config()``.

Needs a CUDA device (marker ``cuda``; every test skips without one). The
card has no jax, so this file imports only torch, numpy and the port. On
the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_utils_cuda.py

Tolerances: each ``StepTimer`` step (host clock, a synchronize before the
clock stops) lasts at least its own CUDA-event time; the watchdog
fires once within a 0.3 s timeout and never while beaten every 30 ms.
"""

import dataclasses
import glob
import time

import numpy as np
import pytest
import torch

from stainlib_tpu_torch import config
from stainlib_tpu_torch.kernels import macenko_fused as mf
from stainlib_tpu_torch.normalization import extractive
from stainlib_tpu_torch.utils import profiling
from stainlib_tpu_torch.utils.watchdog import StallWatchdog
from synth import he_batch, he_patch


@pytest.fixture
def k1():
    """A K1 call on 64 tiles of 256^2 on the card (the API's fs=2 knobs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    batch = torch.from_numpy(he_batch(64, 256, 256, seed=63)).to(dev)
    p = extractive.fit(torch.from_numpy(he_patch(256, 256, seed=64)).to(dev))

    def call():
        return mf.macenko_normalize(batch, p.stain_matrix_target,
                                    p.max_c_target, fit_stride=2, n_bisect=10)
    call()
    torch.cuda.synchronize()
    return call


@pytest.mark.cuda
def test_step_timer_covers_the_kernel(k1):
    """Each step's host-clock time covers its CUDA-event time: the clock
    starts before the start event and stops after the synchronize the
    timer makes for the result's device, which follows the end event."""
    timer, events = profiling.StepTimer(), []
    launches = mf.launches
    for _ in range(10):
        with timer.measure() as out:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out["result"] = {"tiles": k1(), "host": [np.zeros(1), None]}
            end.record()
        assert end.query()  # the timer waited for the card
        events.append(start.elapsed_time(end))
    assert mf.launches == launches + 10
    assert len(timer.times) == 10
    assert all(t * 1e3 >= e for t, e in zip(timer.times, events))
    assert timer.p50() * 1e3 >= float(np.median(events))


@pytest.mark.cuda
def test_trace_holds_annotation_and_k1(k1, tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("stain_k1_region"):
            for _ in range(3):  # a short trace can lose its first launch
                k1()
            torch.cuda.synchronize()
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    text = open(files[0]).read()
    assert "stain_k1_region" in text
    assert "macenko_apply_kernel" in text


@pytest.mark.cuda
def test_watchdog_and_config_on_the_card_host(k1):
    events = []
    with StallWatchdog(timeout_s=0.3, poll_s=0.02,
                       on_stall=events.append) as wd:
        for _ in range(10):  # beaten every 30 ms around K1: quiet
            k1()
            torch.cuda.synchronize()
            wd.beat()
            time.sleep(0.03)
        assert wd.stall_count == 0
        time.sleep(0.6)  # a stall: one firing
    assert wd.stall_count == 1 and len(events) == 1 and events[0] >= 0.3
    cfg = config.Config()
    assert dataclasses.asdict(cfg)["flow"]["image_size"] == 32
    assert cfg.sampler.tile == 256 and cfg.mesh.tiles == 1
