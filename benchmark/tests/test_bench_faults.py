"""A run's `correct`: the harness's whole run on the CPU at a small size
(the look for a card skipped), with the timed path sound, broken
underneath, and the control (the reference in int8) in its place, each
judged under the limit names of the cell's committed limits file."""

import json

import pytest
import torch

from benchmark.harness import control
from benchmark.tests._tiny import BENCH, run, tiny


# the limits at this size, for the program with its decoder in float32
# (which follows the reference to rounding), under the names the cell's
# committed limits file holds: a planted fault reads far over them
TINY = {"loss1_gap": 1e-3, "loss_gap": 1e-3, "grad_gap": 1e-3, "grad_med_gap": 1e-3,
        "change_gap": 2e-2, "change_med_gap": 2e-2, "frame_rel": 0.5}


def _limits(cell):
    with open(f"{BENCH}/limits/{cell}.json") as f:
        names = json.load(f)
    return {k: TINY[k] for k in names}


@pytest.fixture(scope="module")
def limits():
    return {c: _limits(c) for c in ("s1-train", "s2-train", "s2-render")}


def test_sound_runs_pass(limits):
    for cell in limits:
        res, _ = run(cell, limits[cell], seed=4242, bf16=False)
        assert res["correct"], res["check"]
        assert list(res)[-1] == "check"


def test_a_step_that_leaves_the_state_unchanged_fails(limits, monkeypatch):
    from gaussianavatar_torch.engine import optim

    monkeypatch.setattr(optim.Adam, "step", lambda self: None)
    monkeypatch.setattr(optim.SparseAdam, "step", lambda self: None)
    for cell in ("s1-train", "s2-train"):
        res, r = run(cell, limits[cell], bf16=False)
        assert not res["correct"] and "change_gap" in res["check"], res["check"]
        assert r.numbers["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("fault", ["write_lost", "rate_doubled"])
def test_a_lost_parameter_write_or_a_wrong_rate_fails(limits, monkeypatch, fault):
    """Adam's moments move but its parameter write is lost, or its rate is
    twice the configuration's: the change after the compared steps reads
    far off the reference's."""
    from gaussianavatar_torch.engine import optim

    if fault == "write_lost":
        step = optim.Adam.step

        def lost(self):
            keep = [p.detach().clone() for p in self.params]
            step(self)
            with torch.no_grad():
                for p, k in zip(self.params, keep):
                    p.copy_(k)

        monkeypatch.setattr(optim.Adam, "step", lost)
    else:
        sched = optim.multistep_schedule
        monkeypatch.setattr(optim, "multistep_schedule",
                            lambda lr, ms, gamma=0.1: sched(2 * lr, ms, gamma))
    res, r = run("s1-train", limits["s1-train"], bf16=False)
    assert not res["correct"] and r.numbers["change_gap"] > 0.5, res["check"]


def test_half_the_batch_left_out_fails(limits, monkeypatch):
    from gaussianavatar_torch.engine import train_step

    l1, ssim = train_step.l1_loss, train_step.ssim
    half = lambda f: (lambda a, b: f(a[: a.shape[0] // 2], b[: b.shape[0] // 2]))
    monkeypatch.setattr(train_step, "l1_loss", half(l1))
    monkeypatch.setattr(train_step, "ssim", half(ssim))
    for cell in ("s1-train", "s2-train"):
        res, _ = run(cell, limits[cell], bf16=False)
        assert not res["correct"], res["check"]


def test_an_altered_frame_fails(limits, monkeypatch):
    from gaussianavatar_torch.engine import inference

    make = inference.make_renderer

    def altered(*a, **k):
        render = make(*a, **k)

        def wrong(batch, iteration=10 ** 6):
            out = render(batch, iteration).clone()
            out[0] = (out[0] + 0.05).clamp(0, 1)
            return out

        return wrong

    monkeypatch.setattr(inference, "make_renderer", altered)
    res, _ = run("s2-render", limits["s2-render"], bf16=False)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("cell", ["s1-train", "s2-train", "s2-render"])
def test_the_control_fails(limits, cell):
    """The control (the reference with its decoder in int8, or for the
    render float8, both ways), on the batches or calls the run compared,
    comes out not correct by check.verdict under the cell's limit names,
    where the sound run came out correct."""
    res, r = run(cell, limits[cell], bf16=False)
    assert res["correct"], res["check"]
    _, mix = tiny(cell)
    fn, low = ((control.train_readings, "int8") if "train" in cell
               else (control.render_readings, "fp8"))
    got = fn(r, mix, limits[cell], "cpu", (low,))[low]
    assert not got["correct"] and set(got["check"]) == set(limits[cell]), got


def test_the_readings_hold_the_fault_and_the_look():
    """The training readings: the half-batch fault comes out not correct;
    the float32 program against the reference stepped under the program's
    own caps follows it to rounding, as against the reference's own."""
    lim = {"grad_gap": 1e-3, "change_gap": 2e-2}
    res, r = run("s1-train", lim, bf16=False)
    _, mix = tiny("s1-train")
    got = control.train_readings(r, mix, lim, "cpu", ("half_batch", "program_caps"))
    assert not got["half_batch"]["correct"], got["half_batch"]
    assert got["program_caps"]["correct"] and got["program_caps"]["numbers"]["grad_gap"] < 1e-4


def test_no_card_no_result(monkeypatch, capsys):
    from benchmark import run as bench_run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", "s1-train", "--seed", "3", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_every_cell_names_its_files():
    from benchmark.run import ROOT, cell_spec

    with open(f"{ROOT}/BENCHMARK.json") as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        _, _, cfg, mix, limits = cell_spec(w["name"])
        assert mix["kind"] in ("train", "render") and limits
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert __import__("os").path.exists(f"{ROOT}/benchmark/metrics/{m['name']}.py")
