"""The program's spans read from hand-built device traces
(harness/spans.py), and the per-layer metrics that read them."""

from types import SimpleNamespace

import pytest

from benchmark.harness import spans
from benchmark.run import read_metric

TRAIN = ("decode_ms.train", "raster_ms.train", "optimizer_ms.train", "step_other_ms.train")
RENDER = ("decode_ms.render", "raster_ms.render", "call_gap_ms.render")


class Ops:
    """A device stream written in order: markers take 1 us, kernels their
    duration, and the clock can jump (an idle gap)."""

    def __init__(self, t=0.0):
        self.t, self.ops = t, []

    def k(self, d, name="void at::native::elementwise_kernel<128, 2>()"):
        self.ops.append((name, self.t, float(d)))
        self.t += d
        return self

    def b(self, span):
        return self.k(1.0, f"ga_span__{span}__b")

    def e(self, span):
        return self.k(1.0, f"ga_span__{span}__e")

    def idle(self, d):
        self.t += d
        return self


def _step(s: Ops):
    """One training step: decode 10 + 20 backward, raster 1+2+3+4 forward and
    5+6 backward, optimizer 7, posing 8, loss 9 and the rest of the backward
    11, with a 100 us idle gap inside the loss."""
    s.b("train_step").b("train_decode").k(10).e("train_decode").b("render_pose_gaussians").k(8)
    s.e("render_pose_gaussians")
    for span, d in (("projection", 1), ("binning", 2), ("blend", 3), ("untile", 4)):
        s.b(f"render_{span}").k(d).e(f"render_{span}")
    s.b("train_loss").k(4).idle(100).k(5).e("train_loss")
    s.b("train_backward").k(11).b("render_blend_bwd").k(5).e("render_blend_bwd")
    s.b("render_scatter_bwd").k(6).e("render_scatter_bwd")
    s.b("train_decode_bwd").k(20).e("train_decode_bwd").e("train_backward")
    s.b("train_optimizer").k(7).e("train_optimizer").e("train_step")


def _train_run(n_steps=8, markers=True):
    s = Ops().k(50, "Memcpy HtoD (Pageable -> Device)")
    for _ in range(n_steps):
        _step(s)
    s.k(3, "Memcpy DtoD (Device -> Device)")
    ops = s.ops if markers else [o for o in s.ops if not o[0].startswith("ga_span__")]
    return SimpleNamespace(kind="train", trace=SimpleNamespace(ops=ops, steps=n_steps))


def test_nested_and_replayed_spans_pair():
    run = _train_run()
    got = spans.pair(run.trace.ops)
    assert len(got["train_step"]) == 8 and len(got["train_decode_bwd"]) == 8
    for (a, b), (c, d) in zip(got["train_step"], got["train_backward"]):
        assert a < c < d < b
    # a span nested in itself pairs innermost first
    s = Ops().b("render_call").b("render_call").k(2).e("render_call").k(3).e("render_call")
    assert spans.pair(s.ops)["render_call"] == [(0.0, 9.0), (1.0, 5.0)]


def test_a_lost_first_begin_opens_at_the_first_operation():
    """The profiler can drop the first operation of its trace: here the
    first call's begin marker."""
    s = Ops()
    for _ in range(2):
        s.b("render_call").k(3, "Memcpy HtoD (Pageable -> Device)").idle(4).k(5).e("render_call")
        s.idle(10)
    got = spans.pair(s.ops[1:])
    assert got["render_call"] == [(1.0, 14.0), (24.0, 38.0)]
    run = SimpleNamespace(kind="render", trace=SimpleNamespace(ops=s.ops[1:], calls=2))
    assert read_metric("call_gap_ms.render", run) == pytest.approx(4e-3)
    # an end with no begin anywhere else is a fault
    assert spans.pair(s.ops[:-1] + s.ops[-1:] * 2) is None


def test_busy_excludes_markers_and_idle_gaps():
    run = _train_run(1)
    # the loss: 4 + 5 us of kernels, 100 us idle, 2 markers
    assert spans.busy_ms(run.trace, ["train::loss"]) == pytest.approx(9e-3)
    assert spans.idle_ms(run.trace, "train::loss") == pytest.approx(100e-3)
    step = 10 + 8 + 1 + 2 + 3 + 4 + 9 + 11 + 5 + 6 + 20 + 7
    assert spans.busy_ms(run.trace, ["train::step"]) == pytest.approx(step * 1e-3)
    assert spans.idle_ms(run.trace, "train::step") == pytest.approx(100e-3)


def test_unmatched_or_missing_markers_read_none():
    run = _train_run(2)
    run.trace.ops = [o for o in run.trace.ops if o[0] != "ga_span__train_optimizer__e"]
    assert spans.pair(run.trace.ops) is None
    assert all(read_metric(m, run) is None for m in TRAIN)
    ends_first = Ops().e("train_step").b("train_step")
    assert spans.pair(ends_first.ops) is None
    plain = _train_run(2, markers=False)   # a program without markers
    assert all(read_metric(m, plain) is None for m in TRAIN)


def test_training_metrics_by_hand():
    run = _train_run(8)
    got = {m: read_metric(m, run) for m in TRAIN}
    assert got == pytest.approx({"decode_ms.train": 30e-3, "raster_ms.train": 21e-3,
                                 "optimizer_ms.train": 7e-3,
                                 "step_other_ms.train": (8 + 9 + 11) * 1e-3})
    # what the four cover is the steps' busy time: the feeds and the copy
    # outside train::step are left out
    assert sum(got.values()) * 8 == pytest.approx(spans.busy_ms(run.trace, ["train::step"]))
    assert all(read_metric(m, SimpleNamespace(kind="render", trace=run.trace)) is None
               for m in TRAIN)


def test_render_metrics_by_hand():
    s = Ops()
    for _ in range(4):
        s.b("render_call").k(2).idle(30).b("render_decode").k(40).e("render_decode").idle(5)
        for span, d in (("projection", 1), ("binning", 2), ("blend", 3), ("untile", 4)):
            s.b(f"render_{span}").k(d).e(f"render_{span}").idle(1)
        s.e("render_call").k(60, "Memcpy DtoH (Device -> Pageable)").idle(20)
    run = SimpleNamespace(kind="render", trace=SimpleNamespace(ops=s.ops, calls=4))
    got = {m: read_metric(m, run) for m in RENDER}
    # per call: 30 + 5 + 4 x 1 us idle inside render::call; the copy after it
    assert got == pytest.approx({"decode_ms.render": 40e-3, "raster_ms.render": 10e-3,
                                 "call_gap_ms.render": 39e-3})
    assert all(read_metric(m, SimpleNamespace(kind="render", trace=None)) is None
               for m in RENDER)
