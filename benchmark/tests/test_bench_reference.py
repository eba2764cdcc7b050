"""The plain reference against the program at a small size on the CPU,
and what the reference may import."""

import subprocess
import sys

import pytest

from benchmark.tests._tiny import run

LOOSE = {"loss_gap": 1.0, "grad_gap": 10.0, "change_gap": 10.0}


@pytest.mark.parametrize("cell", ["s1-train", "s2-train"])
def test_train_reference_matches_the_float32_program(cell):
    """With the program's decoder in float32 the reference follows its first
    three steps to rounding: the reference's semantics are the program's."""
    res, r = run(cell, LOOSE, bf16=False)
    n = r.numbers
    assert n["loss_gap"] < 1e-4 and n["grad_gap"] < 1e-4 and n["change_gap"] < 5e-3, n
    # the biases BatchNorm cancels are the leaves the rule leaves out
    assert n["_left_out"] and all(k.startswith("pop.decoder.dense.") and k.endswith(".bias")
                                  for k in n["_left_out"])


@pytest.mark.parametrize("cell", ["s1-render", "s2-render"])
def test_render_reference_matches_the_float32_program(cell):
    res, r = run(cell, {"frame_rel": 1.0}, bf16=False)
    assert r.numbers["frame_mae"] < 1e-6 and r.numbers["frame_rel"] < 0.05


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         capture_output=True, text=True, timeout=300, check=True)
    return eval(out.stdout.strip().splitlines()[-1])


def test_reference_imports_nothing_of_the_program():
    mods = _loaded("import benchmark.reference.train, benchmark.reference.raster, "
                   "benchmark.reference.body, benchmark.reference.net")
    assert "gaussianavatar_torch" not in mods
    assert not {"jax", "jaxlib", "flax", "gaussianavatar_tpu"} & set(mods)


def test_a_cells_run_loads_no_jax():
    mods = _loaded("import benchmark.run, benchmark.harness.cells, benchmark.harness.control\n"
                   "from benchmark.tests._tiny import run\n"
                   "run('s1-train', {'loss_gap': 1, 'grad_gap': 9, 'change_gap': 9})")
    assert "gaussianavatar_torch" in mods
    assert not {"jax", "jaxlib", "flax", "gaussianavatar_tpu"} & set(mods)


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from benchmark import run as bench_run

    assert bench_run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.setitem(sys.modules, "gaussianavatar_tpux", object())
    assert bench_run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "gaussianavatar_tpu.ops", object())
    assert bench_run.forbidden_loaded() == ["gaussianavatar_tpu"]
