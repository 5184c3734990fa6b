"""The port's ``config.py`` and the last of ``utils/`` (``watchdog``,
``profiling``, ``plot``) against the JAX package's, on the CPU.

* ``Config()``: every field, nested ones included, equal to JAX's
  (``dataclasses.asdict``), with the same field names and types per class.
* ``StallWatchdog``: the cases of ``tests/test_manifests_watchdog.py``
  on the port's copy.
* ``StepTimer``: CPU tensors and pytree results; ``p50`` equal to JAX's on
  the same recorded times.
* ``trace`` + ``annotate``: a Chrome trace file that holds the region;
  the count of kernel launches without a device kernel, on which ``trace``
  raises on a card.
* ``plot_image_grid``: the PNG bytes equal JAX's on the same numpy images,
  and equal again when the images come as torch tensors.
"""

import dataclasses
import glob
import inspect
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("matplotlib")

from stainlib_tpu import config as jax_config  # noqa: E402
from stainlib_tpu.utils import plot as jax_plot  # noqa: E402
from stainlib_tpu.utils import profiling as jax_profiling  # noqa: E402
from stainlib_tpu.utils import watchdog as jax_watchdog  # noqa: E402
from stainlib_tpu_torch import config  # noqa: E402
from stainlib_tpu_torch.utils import plot, profiling  # noqa: E402
from stainlib_tpu_torch.utils.watchdog import StallWatchdog  # noqa: E402


def _classes(cfg):
    """{class name: dataclass fields} of ``cfg`` and its nested configs."""
    out = {type(cfg).__name__: [(f.name, str(f.type), f.default)
                                for f in dataclasses.fields(cfg)]}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_classes(v))
    return out


def test_config_equals_jax_field_by_field():
    got, want = config.Config(), jax_config.Config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert _classes(got) == _classes(want)
    assert len(_classes(got)) == 7  # Config and its six sub-configs
    for name in ("StainConfig", "AugmentConfig", "MeshConfig"):
        assert (dataclasses.asdict(getattr(config, name)())
                == dataclasses.asdict(getattr(jax_config, name)()))
    # The sub-configs are the port's own trainer and sampler classes.
    assert type(got.flow).__module__ == "stainlib_tpu_torch.models.train_flow"
    assert type(got.dann).__module__ == "stainlib_tpu_torch.models.train_dann"
    assert type(got.sampler).__module__ == "stainlib_tpu_torch.data.wsi"


def test_watchdog_is_the_jax_class():
    for name in ("__init__", "beat", "start", "stop"):
        assert (inspect.signature(getattr(StallWatchdog, name))
                == inspect.signature(getattr(jax_watchdog.StallWatchdog,
                                             name)))


def test_watchdog_fires_and_resets():
    events = []
    wd = StallWatchdog(timeout_s=0.15, poll_s=0.02,
                       on_stall=lambda gap: events.append(gap))
    with wd:
        wd.beat()
        time.sleep(0.35)  # stall -> one firing
        assert wd.stall_count == 1
        wd.beat()  # recovery re-arms
        time.sleep(0.35)
    assert wd.stall_count == 2
    assert len(events) == 2 and all(g >= 0.15 for g in events)


def test_watchdog_quiet_when_beating():
    wd = StallWatchdog(timeout_s=0.3, poll_s=0.02)
    with wd:
        for _ in range(10):
            wd.beat()
            time.sleep(0.03)
    assert wd.stall_count == 0


@pytest.mark.parametrize("result", [
    torch.ones(4),
    {"a": torch.zeros(2, 3), "b": [torch.ones(1), 3, None]},
    (np.ones(2), "no tensor"),
])
def test_step_timer_on_cpu_results(result):
    timer = profiling.StepTimer()
    assert timer.p50() is None
    for _ in range(3):
        with timer.measure() as out:
            time.sleep(0.002)
            out["result"] = result
    with timer.measure():  # no result: nothing to wait for
        pass
    assert len(timer.times) == 4 and all(t >= 0 for t in timer.times)
    assert min(timer.times[:3]) >= 0.002


def test_step_timer_p50_equals_jax():
    times = [0.3, 0.1, 0.4, 0.2, 0.5, 0.25]
    for n in range(1, len(times) + 1):
        got, want = profiling.StepTimer(), jax_profiling.StepTimer()
        got.times, want.times = list(times[:n]), list(times[:n])
        assert got.p50() == want.p50()


def test_trace_writes_the_annotation(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("stain_probe_region"):
            x = torch.arange(64.0).reshape(8, 8)
            (x @ x).sum()
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    text = open(files[0]).read()
    assert "stain_probe_region" in text and "traceEvents" in text
    with profiling.trace(str(tmp_path)):  # a second trace, a second file
        torch.ones(2).sum()
    assert len(glob.glob(str(tmp_path / "trace_*.json"))) == 2


def _launch(corr, name="cudaLaunchKernel"):
    return {"cat": "cuda_runtime", "name": name, "args": {"correlation": corr}}


def _kernel(corr):
    return {"cat": "kernel", "name": "k", "args": {"correlation": corr}}


@pytest.mark.parametrize("events,lost", [
    ([_launch(1), _kernel(1), _launch(2, "cudaLaunchKernelExC"), _kernel(2)],
     0),
    ([_launch(1), _launch(2, "cudaLaunchKernelExC"), _kernel(2)], 1),
    ([_launch(3), _launch(4)], 2),
    ([_launch(5, "cudaMemcpyAsync"), {"cat": "cpu_op", "name": "aten::add"},
      _kernel(6)], 0),
])
def test_trace_counts_launches_without_kernels(events, lost):
    """``trace`` raises on a Chrome trace where a kernel launch (a CUDA
    runtime launch event) has no device kernel of its correlation id."""
    assert profiling.lost_device_records(events) == lost


def test_plot_image_grid_png_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (24, 32, 3), np.uint8) for _ in range(5)]
    titles = [f"panel {i}" for i in range(5)]
    a, b, c = (str(tmp_path / f"{n}.png") for n in ("jax", "np", "torch"))
    assert jax_plot.plot_image_grid(images, titles, cols=3, save_path=a) == a
    assert plot.plot_image_grid(images, titles, cols=3, save_path=b) == b
    plot.plot_image_grid([torch.from_numpy(i) for i in images], titles,
                         cols=3, save_path=c)
    png = open(a, "rb").read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert open(b, "rb").read() == png
    assert open(c, "rb").read() == png
