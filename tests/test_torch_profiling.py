"""The port's profiling aux (``uasr_torch.profiling``) and TensorBoard
export (``train.tensorboard``), as tests/test_aux.py holds the JAX
package's: StepTimer's stats, a torch.profiler trace written, ``checked``
raising on the first NaN an op produces (naming the op) and passing
finite work through, and MetricWriter's event file under ``<dir>/tb``
beside metrics.jsonl."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from uasr_torch.metrics import MetricWriter
from uasr_torch.profiling import NonFiniteError, StepTimer, checked, trace


def test_step_timer_and_checked():
    timer = StepTimer()
    x = torch.ones(32, 32)
    for _ in range(3):
        timer.start()
        y = x @ x
        timer.stop(y)
    s = timer.stats(payload_per_step=1.0)
    assert s["steps"] == 3 and s["median_s"] > 0
    assert set(s) == {"steps", "median_s", "p10_s", "p90_s", "throughput"}
    with timer.step() as fence:
        fence["y"] = x @ x
    assert timer.stats()["steps"] == 4 and StepTimer().stats() == {}
    # the rate is all payload over all time, not payload over the median step
    uneven = StepTimer()
    uneven.times = [1.0, 1.0, 4.0]
    assert uneven.stats(payload_per_step=2.0)["throughput"] == pytest.approx(1.0)

    ok = checked(lambda a: torch.log(a))
    assert np.isfinite(float(ok(torch.tensor(2.0))))
    with pytest.raises(NonFiniteError, match="log"):
        ok(torch.tensor(-1.0))  # NaN from the log of a negative
    with pytest.raises(NonFiniteError, match="div"):
        checked(lambda a: (a * 2) / torch.zeros(()))(torch.ones(3))  # inf from a division
    assert float(torch.log(torch.tensor(-1.0)).isnan())  # nothing installed outside


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert prof.key_averages()


def test_metric_writer_tensorboard_event_file(tmp_path):
    w = MetricWriter(str(tmp_path), also_tensorboard=True)
    w.write(1, "train", loss=2.5, grad_norm=1.0, note="text")
    w.write(2, "dev", per=0.5)
    w.close()
    recs = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    assert [r["tag"] for r in recs] == ["train", "dev"] and recs[0]["note"] == "text"
    events = glob.glob(os.path.join(tmp_path, "tb", "events.out.tfevents.*"))
    assert events and os.path.getsize(events[0]) > 0
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert {"train/loss", "train/grad_norm", "dev/per"} <= set(acc.Tags()["scalars"])
    assert acc.Scalars("train/loss")[0].value == 2.5 and acc.Scalars("dev/per")[0].step == 2
