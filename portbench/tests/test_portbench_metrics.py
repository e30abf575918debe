"""The metric arithmetic on fixed numbers: the readers, the static band's
bound, and the trace's reduction."""

import pytest

from portbench import harness, roofline, tracing


def ctx(**over):
    c = {"units": 4000, "window_s": 20.0, "setup_s": 31.5, "devices": 1,
         "counters": {"banded_align.launches": 200, "seed_block.launches":
                      80, "dp_cells": 10 ** 10},
         "traffic": {"aligner": {"band_width": 256}},
         "trace": {"spans_s": {"align.seed": 2.0, "align.finish": 6.0},
                   "ops_s": {"void dp_static_kernel<256>(x)": 30.0,
                             "dp_adaptive_kernel<256, true>": 0.9,
                             "seed_block_kernel<false>": 0.05,
                             "select_candidates_kernel": 0.03},
                   "busy_s": {0: 5.0}, "window_s": 20.0}}
    c.update(over)
    return c


@pytest.mark.parametrize("name, want", [
    ("reads_per_s", 200.0),
    ("setup_s", 31.5),
    ("seed_ms_per_kread", 500.0),
    ("emit_ms_per_kread", 1500.0),
    ("extender_calls_per_kread", 50.0),
    ("adaptive_dp_ms_per_launch", 4.5),
    ("seeder_kernels_ms_per_call", 1.0),
    ("device_idle_pct", 75.0),
])
def test_reader(name, want):
    assert harness.reader(name)(ctx()) == pytest.approx(want)


def test_static_roofline():
    # 1e10 cells x 20 ops over the int32 rate (bytes are below it), over
    # 30 s of dp_static_kernel
    want = 100 * 1e10 * 20 / (132 * 64 * 1.98e9) / 30.0
    assert harness.reader("static_dp_roofline")(ctx()) == pytest.approx(want)
    assert roofline.dp_bound_s(10 ** 10, 256) == pytest.approx(
        2e11 / 16.72704e12)


def test_card_balance():
    c = ctx(devices=4)
    c["trace"]["busy_s"] = {0: 4.0, 1: 2.0, 2: 3.0, 3: 1.0}
    assert harness.reader("card_busy_min_max_pct")(c) == pytest.approx(25.0)
    assert harness.reader("device_idle_pct")(c) == pytest.approx(87.5)


@pytest.mark.parametrize("name", [
    "seed_ms_per_kread", "emit_ms_per_kread", "static_dp_roofline",
    "adaptive_dp_ms_per_launch", "seeder_kernels_ms_per_call",
    "device_idle_pct", "card_busy_min_max_pct", "extender_calls_per_kread"])
def test_nothing_to_read_gives_nothing(name):
    c = ctx(trace={"spans_s": {}, "ops_s": {}, "busy_s": {},
                   "window_s": 20.0}, counters={})
    assert harness.reader(name)(c) is None


class Ev:
    """A profiler event with the fields the reduction reads."""

    def __init__(self, dev, name, start, dur, ann=False, index=0):
        self.d, self.n, self.s, self.du = dev, name, start, dur
        self.u, self.i = ann, index

    def device_type(self):
        return "DeviceType." + self.d

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.du

    def is_user_annotation(self):
        return self.u

    def device_index(self):
        return self.i


def test_summarize_unions_and_gaps():
    ms = 1_000_000
    events = [
        Ev("CPU", "align.seed", 0, 40 * ms, True),
        Ev("CPU", "align.finish", 50 * ms, 50 * ms, True),
        Ev("CPU", "aten::copy_", 0, 100 * ms),
        # card 0: two overlapping kernels and a copy: busy 10 + 5 ms
        Ev("CUDA", "k1", 40 * ms, 8 * ms), Ev("CUDA", "k2", 44 * ms, 6 * ms),
        Ev("CUDA", "Memcpy HtoD", 90 * ms, 5 * ms),
        # the span's mirror on the card: no work there
        Ev("CUDA", "align.finish", 50 * ms, 50 * ms),
        Ev("CUDA", "k1", 0, 30 * ms, index=1),
    ]
    s = tracing.summarize(events, 0.1)
    assert s["busy_s"] == {0: pytest.approx(0.015), 1: pytest.approx(0.03)}
    assert s["ops_s"]["k1"] == pytest.approx(0.038)
    assert "align.finish" not in s["ops_s"]
    assert s["spans_s"] == {"align.seed": pytest.approx(0.04),
                            "align.finish": pytest.approx(0.05)}
    gaps = dict(s["idle_gaps"])
    # card 0 idle: 0-40 ms in align.seed, 50-90 in align.finish, 95-100
    assert gaps["align.seed"] == pytest.approx(0.04)
    assert gaps["align.finish"] == pytest.approx(0.045)
    b = tracing.breakdown(s)
    assert b["device_ops"][0][0] == "k1"
