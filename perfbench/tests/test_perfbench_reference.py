"""The port against the plain reference at a tiny size on the CPU, through
the harness's whole run (the card's look skipped), and the control and the
faults that the comparison has to fail."""

import time

import pytest
import torch

from perfbench.core import compare, process, registry, train_cell
from perfbench.reference import models as ref
from perfbench.tests import tiny

CELLS = ["deepfm_criteo.train.uniform"]


def _run(workload, seed, trace=0, **kw):
    cell = tiny.shrink(registry.Registry().cell(workload), **kw)
    return process.run_process(cell, seed=seed, seconds=0.5, trace=trace,
                               device="cpu", t0=time.time())


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(workload, trace):
    result, lines = _run(workload, 2**31 + 17, trace)
    assert result["correct"], lines
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(tiny.LIMITS)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["count"] == 1
    # On the CPU the trace holds no device kernels: of the per-layer
    # metrics only the whole step's share reads.
    want = ({"train_examples_per_s", "peak_device_mem_gib", "setup_s"}
            if not trace else {"train_mfu_pct"})
    assert want <= set(result["metrics"])
    assert lines[-3:] == compare.check_lines(
        {k: v["value"] for k, v in result["checks"].items()},
        {k: v["limit"] for k, v in result["checks"].items()})


def _readings(workload, seed, **kw):
    cell = tiny.shrink(registry.Registry().cell(workload), bf16=True)
    run = train_cell.Run(cell, seed=seed, device="cpu", t0=time.time())
    run.setup()
    run.free_program()
    return run, run.reference()


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_far_above_the_program(workload):
    """The reference in float8 in the program's place reads above what the
    bfloat16 program reads, on the number the cells' limits hold."""
    run, readings = _readings(workload, 11)
    program = compare.gaps(run.checked, readings)
    control = compare.gaps(run.reference(quant=True), readings)
    assert control["grad_gap"] > 3 * program["grad_gap"]
    assert control["grad_gap_geomean"] > 3 * program["grad_gap_geomean"]


def test_reference_matches_plain_autograd_adam():
    """One reference step against torch.optim.Adam on the same loss."""
    torch.manual_seed(0)
    params = {"fm_b": torch.zeros(1), "fm_w": torch.randn(50) * 0.1,
              "fm_v": torch.randn(50, 4) * 0.1,
              "tower.layers.0.w": torch.randn(12, 5) * 0.3,
              "tower.layers.0.b": torch.zeros(5),
              "tower.out.w": torch.randn(5, 1) * 0.3,
              "tower.out.b": torch.zeros(1)}
    batch = {"ids": torch.randint(0, 50, (64, 3)),
             "vals": torch.randn(64, 3),
             "label": (torch.rand(64) < 0.5).float()}
    out = ref.train_steps(params, [batch], lr=1e-2, l2=1e-4)
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    opt = torch.optim.Adam(list(p.values()), lr=1e-2, eps=1e-8)
    loss = ref.loss(p, batch, 1e-4)
    loss.backward()
    opt.step()
    assert abs(out["losses"][0] - float(loss.detach())) < 1e-6
    for k in p:
        torch.testing.assert_close(out["change"][k],
                                   p[k].detach() - params[k],
                                   rtol=1e-4, atol=1e-7)


def test_judge():
    assert compare.judge({"a": 1.0}, {"a": 1.0})
    assert not compare.judge({"a": 1.1}, {"a": 1.0})
    assert not compare.judge({"a": float("nan")}, {"a": 1.0})
    assert not compare.judge({"a": 0.0}, {})
