"""The torch port's profiling tools against the JAX package's, on the CPU:
``pairwise_interactions`` and ``StepReport`` equal, ``StepTimer``'s
accumulation and rates, ``sync`` on a tree of CPU tensors (it returns at
once), ``benchmark_fn``'s median of the calls, and ``trace`` writing a
Chrome trace of the CPU ops.  tests/test_torch_cuda.py holds
``benchmark_fn`` and ``trace`` on a CUDA tensor."""

import json
import time

import pytest
import torch

from nbody.diagnostics import profiling as jprof
from nbody_torch import diagnostics as tdiag
from nbody_torch.core.types import ParticleState
from nbody_torch.diagnostics import profiling as tprof


@pytest.mark.parametrize("n,steps,kicks", [(1, 1, 2), (4096, 10, 2),
                                           (262144, 250, 2), (100, 7, 3)])
def test_pairwise_interactions_match_jax(n, steps, kicks):
    assert tprof.pairwise_interactions(n, steps, kicks) == \
        jprof.pairwise_interactions(n, steps, kicks)


@pytest.mark.parametrize("ips", [None, 1.97e12])
def test_step_report_matches_jax(ips):
    t = tprof.StepReport(steps=250, wall_s=8.78, steps_per_s=28.47,
                         interactions_per_s=ips)
    j = jprof.StepReport(steps=250, wall_s=8.78, steps_per_s=28.47,
                         interactions_per_s=ips)
    assert str(t) == str(j)


def test_step_timer_accumulates():
    timer = tprof.StepTimer(n_particles=1000)
    for steps in (3, 5):
        with timer.measure(steps=steps, device="cpu"):
            time.sleep(0.01)
    rep = timer.report()
    assert rep.steps == 8 and rep.wall_s >= 0.02
    assert rep.steps_per_s == pytest.approx(8 / rep.wall_s)
    assert rep.interactions_per_s == pytest.approx(
        tprof.pairwise_interactions(1000, 8) / rep.wall_s)
    assert tprof.StepTimer().report().interactions_per_s is None
    assert tdiag.StepTimer is tprof.StepTimer


def test_sync_returns_its_tree():
    st = ParticleState.create(torch.zeros(4, 3), torch.ones(4, 3), 1.0)
    tree = {"a": [st, (torch.ones(2), 3)], "b": None}
    assert tprof.sync(tree) is tree
    assert tprof._devices(tree) == set()


def test_benchmark_fn_median():
    calls = []

    def fn(x, dt):
        calls.append(dt)
        time.sleep(dt)
        return x * 2

    t = tprof.benchmark_fn(fn, torch.ones(3), 0.02, reps=3)
    assert len(calls) == 4  # the warm-up and three timed calls
    assert 0.015 <= t < 1.0
    tprof.benchmark_fn(fn, torch.ones(3), 0.0, reps=2, warmup=False)
    assert len(calls) == 6


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.rand(64, 64)
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.mm(a, a)
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
