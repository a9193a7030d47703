"""A run whose timed path is broken underneath comes out not correct, once
for each fault the cell can have (a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced; no cell spans chips, so no exchange can be left out); the
control, the reference one precision down in the program's place, fails
the check at a size a test run holds, and on the card at the cells' own
sizes."""

import json
import os

import pytest
import torch

import harness
from conftest import ROOT


def _cell(tiny, name):
    return harness.Cell(harness.load_json(os.path.join(tiny, "BENCHMARK.json")), name, root=tiny)


def _run(tiny, name):
    return harness.run_cell(_cell(tiny, name), 2**31 + 21, 0.4, False, torch.device("cpu"),
                            log=lambda m: None)


def _apply_faults():
    from grav1synth_tpu_torch.ops import grain

    real = grain.apply_grain

    def unchanged(y, cb, cr, *a, **k):
        return y, cb, cr

    def half(y, cb, cr, p, *a, **k):
        b = y.shape[0] // 2
        out = real(y[:b], cb[:b], cr[:b], grain.GrainParamsBatch(p.buffer[:b]), *a, **k)
        return tuple(torch.cat([o, src[b:].to(o.dtype)]) for o, src in zip(out, (y, cb, cr)))

    def altered(*a, **k):
        out = real(*a, **k)
        out[0][:, 0, 0] += 1
        return out

    return grain, "apply_grain", {"unchanged": unchanged, "half": half, "altered": altered}


def _diff_faults():
    from grav1synth_tpu_torch.ops import diff_estimate as de

    real_batch, real_shards = de.DiffEstimator.diff_batch, de._shard_stats

    def altered(*a, **k):
        outs = real_shards(*a, **k)
        outs[0][0]["ata"][:, 0, 0] += 1
        return outs

    return {
        "unchanged": (de.DiffEstimator, "diff_batch", lambda self, s, d, mesh=None: None),
        "half": (de.DiffEstimator, "diff_batch",
                 lambda self, s, d, mesh=None: real_batch(self, s[: len(s) // 2], d[: len(d) // 2])),
        "altered": (de, "_shard_stats", altered),
    }


def _estimate_faults():
    from grav1synth_tpu_torch.ops import estimate as es

    real_push, real_stats = es.NoiseEstimator.push_batch, es._plane_stats

    def altered(*a, **k):
        out = real_stats(*a, **k)
        out["bin_sum"][:, 10] += 1
        return out

    return {
        "unchanged": (es.NoiseEstimator, "push_batch", lambda self, frames: None),
        "half": (es.NoiseEstimator, "push_batch",
                 lambda self, frames: real_push(self, frames[: len(frames) // 2])),
        "altered": (es, "_plane_stats", altered),
    }


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", ["uhd10_420.render_film_b16", "uhd10_420.resident_film_b112"])
def test_apply_faults_fail(tiny, monkeypatch, workload, fault):
    module, name, faults = _apply_faults()
    monkeypatch.setattr(module, name, faults[fault])
    result = _run(tiny, workload)
    assert result["correct"] is False
    assert result["checks"]["wrong_samples"]["value"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload,faults", [("fhd8_420.diff_b32", _diff_faults),
                                             ("uhd10_420.estimate_b16", _estimate_faults)])
def test_statistics_faults_fail(tiny, monkeypatch, workload, faults, fault):
    owner, name, fn = faults()[fault]
    monkeypatch.setattr(owner, name, fn)
    result = _run(tiny, workload)
    assert result["correct"] is False
    failing = [k for k, c in result["checks"].items() if c["value"] > c["limit"]]
    assert failing, result["checks"]


def _control(cell, seed, device, seconds):
    driver = cell.driver(seed, device)
    driver.setup()
    harness.run_window(driver, seconds, False)
    checks = driver.check()
    return checks, driver.control()


def test_control_fails_at_a_test_size(tiny):
    """At 1920x1080 (where the statistics' float32 sums pass 2^24 and
    round), the control reads above each cell's limit where the program
    reads within it."""
    for name in os.listdir(os.path.join(tiny, "benchmark", "configs")):
        path = os.path.join(tiny, "benchmark", "configs", name)
        with open(path) as fh:
            cfg = json.load(fh)
        cfg.update(width=1920, height=1080)
        with open(path, "w") as fh:
            json.dump(cfg, fh)
    for workload in ("uhd10_420.render_film_b16", "fhd8_420.diff_b32", "uhd10_420.estimate_b16"):
        checks, control = _control(_cell(tiny, workload), 13, torch.device("cpu"), 0.3)
        assert all(v <= lim for v, lim in checks.values()), (workload, checks)
        assert any(control[k] > checks[k][1] for k in control), (workload, control)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in harness.load_json(
    os.path.join(ROOT, "BENCHMARK.json"))["workloads"]])
def test_control_fails_on_the_card(cuda, workload):
    """The control at the cell's own size on the card, three seeds."""
    cell = harness.Cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), workload)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        checks, control = _control(cell, seed, cuda, 2.0)
        assert all(v <= lim for v, lim in checks.values()), (workload, seed, checks)
        assert any(control[k] > checks[k][1] for k in control), (workload, seed, control)
