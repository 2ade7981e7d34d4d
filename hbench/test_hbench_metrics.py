"""The metrics' arithmetic on recorded numbers: the per-layer readers, the
profiler trace reading, and the frozen roofline counts."""
import math

import pytest

from hbench import context, peaks, spec, trace

SHAPE = {"slots": 32, "rows": 8388608, "n": 256, "scan_block": 4096,
         "sax_words": 8388608, "sax_segments": 16}
PATHS = ("scan_eapca", "scan_sax", "pruned", "forced_scan", "unknown")


def _snap(served=0, waves=0, calls=0, wave_calls=0, total=0.0, paths=(0, 0, 0, 0, 0),
          sax_sum=0.0, launches=None):
    """A snapshot as ``run.snapshot`` takes it (the fields the readers use)."""
    known = sum(paths[:4])
    return {"calls": calls, "wave_calls": wave_calls, "latency": {"total": total},
            "paths": dict(zip(PATHS, paths)),
            "pruning": {"sax_mean": sax_sum / max(known, 1)},
            "serving": {"served": served, "waves": waves, "batch_slots": 32},
            "launches": launches or {}, "launches_by": {}}


# the window: 300 served in 10 waves of 32 slots, 10 calls of 2.5 s in all,
# 300 known paths (20 + 40 scans) with summed sax_pr 180, after the warm-up's
# 64 (sax_pr summed 32)
BEFORE = _snap(64, 2, 2, 2, 0.5, (0, 0, 64, 0, 0), 32.0)
AFTER = _snap(364, 12, 12, 12, 3.0, (20, 40, 304, 0, 0), 212.0)
WINDOW = (BEFORE, AFTER)
NO_TRACE = {"window": WINDOW}


def _read(name, ctx):
    return spec.metric_reader(name).read(ctx)


def _summary(by_name, busy_s=1.0, window_s=4.0):
    return {"busy_s": busy_s, "window_s": window_s, "by_name": by_name,
            "device_ops": [], "idle_gaps": []}


def _stretch(calls, wave_calls, launches):
    """A traced stretch after the window: its counters grow by these."""
    after = dict(AFTER, calls=AFTER["calls"] + calls,
                 wave_calls=AFTER["wave_calls"] + wave_calls,
                 launches={k: AFTER["launches"].get(k, 0) + v for k, v in launches.items()})
    return {"window": WINDOW, "stretch": (AFTER, after)}


def test_window_readers():
    ctx = context.Context({}, NO_TRACE, None, SHAPE)
    assert _read("serve.wave_fill", ctx) == pytest.approx(100 * 300 / 320)
    assert _read("engine.call_ms", ctx) == pytest.approx(250.0)
    assert _read("engine.call_ms.qps", ctx) == pytest.approx(250.0)
    assert _read("search.sax_pruned", ctx) == pytest.approx(60.0)
    assert _read("search.scan_path", ctx) == pytest.approx(20.0)
    # an untraced run reads nothing from the device
    for name in ("device.idle", "lb_sax_matrix_roofline", "ed_min_roofline",
                 "ed_matrix_roofline"):
        assert _read(name, ctx) is None


def test_end_to_end_readers():
    run = {"answered": 500, "window_s": 50.0, "latencies": [0.1 * i for i in range(1, 21)],
           "build_s": 7.5, "peak_bytes": 3 * 2**30, "setup_s": 18.0}
    ctx = context.Context(run, NO_TRACE, None, SHAPE)
    assert _read("qps", ctx) == pytest.approx(10.0)
    assert _read("latency_p95_ms", ctx) == pytest.approx(1905.0)   # linear: 1.9 + 0.05 x 0.1
    assert _read("serve.latency_p95_ms", ctx) == pytest.approx(1905.0)
    assert _read("build_s", ctx) == 7.5 and _read("setup_s", ctx) == 18.0
    assert _read("peak_mem_gib", ctx) == pytest.approx(3.0)
    ctx = context.Context(dict(run, latencies=[], peak_bytes=None), NO_TRACE, None, SHAPE)
    assert _read("latency_p95_ms", ctx) is None and _read("peak_mem_gib", ctx) is None
    assert _read("serve.latency_p95_ms", ctx) is None


def test_a_forced_scan_prunes_nothing_to_read():
    forced = (BEFORE, _snap(364, 12, 12, 12, 3.0, (0, 0, 64, 300, 0), 32.0))
    ctx = context.Context({}, {"window": forced}, None, SHAPE)
    assert _read("search.sax_pruned", ctx) is None
    assert _read("search.scan_path", ctx) is None
    ctx = context.Context({}, {"window": (BEFORE, BEFORE)}, None, SHAPE)
    assert _read("serve.wave_fill", ctx) is None and _read("engine.call_ms", ctx) is None
    assert _read("engine.call_ms.qps", ctx) is None


def test_lb_sax_roofline_and_idle():
    one = peaks.bound_seconds(*spec.roofline("lb_sax_matrix").cost(q=32, n_words=8388608, m=16))
    tr = _summary({"void lb_sax_v2<16, false>(float const*)": [5 * one * 2, 5],
                   "ed_min_resident": [9.0, 1]})
    ctx = context.Context({}, _stretch(5, 5, {"lb_sax_matrix": 5}), tr, SHAPE)
    assert _read("lb_sax_matrix_roofline", ctx) == pytest.approx(50.0)
    assert _read("device.idle", ctx) == pytest.approx(75.0)
    # a launch of another shape (calls and launches disagree): nothing read
    ctx = context.Context({}, _stretch(6, 6, {"lb_sax_matrix": 5}), tr, SHAPE)
    assert _read("lb_sax_matrix_roofline", ctx) is None
    # launches but no device time under the kernel's names: nothing read, never 0
    ctx = context.Context({}, _stretch(5, 5, {"lb_sax_matrix": 5}), _summary({}), SHAPE)
    assert _read("lb_sax_matrix_roofline", ctx) is None


def test_scan_rooflines():
    blocks = 8388608 // 4096
    ed_min = spec.roofline("ed_min")
    ed_matrix = spec.roofline("ed_matrix")
    t_min = peaks.bound_seconds(*ed_min.cost(q=32, rows=8388608, n=256))
    t_mat = peaks.bound_seconds(*ed_matrix.cost(q=32, rows=4096, n=256))
    tr = _summary({"ed_min_init": [0.0, 3], "void ed_min_resident<float>()": [3 * t_min * 4, 3],
                   "ed_min_finish": [0.0, 3],
                   "void ed_tiles<C, float, 4, 4, StoreDists>()": [2 * blocks * t_mat * 5,
                                                                    2 * blocks]})
    launches = {"ed_min": 3, "ed_matrix": 2 * blocks}
    ctx = context.Context({}, _stretch(5, 5, launches), tr, SHAPE)
    assert ctx.scan_calls() == (3, 2)
    assert _read("ed_min_roofline", ctx) == pytest.approx(25.0)
    assert _read("ed_matrix_roofline", ctx) == pytest.approx(20.0)
    # a call without a launch: the counts disagree
    ctx = context.Context({}, _stretch(6, 6, launches), tr, SHAPE)
    assert ctx.scan_calls() is None and _read("ed_min_roofline", ctx) is None


def test_ragged_scan_block_bounds_the_tail():
    ed_matrix = spec.roofline("ed_matrix")
    shape = dict(SHAPE, rows=10000, scan_block=4096)
    full = peaks.bound_seconds(*ed_matrix.cost(q=32, rows=4096, n=256))
    tail = peaks.bound_seconds(*ed_matrix.cost(q=32, rows=10000 - 8192, n=256))
    tr = _summary({"StoreDists": [2 * full + tail, 3]})
    ctx = context.Context({}, _stretch(1, 1, {"ed_matrix": 3}), tr, shape)
    assert _read("ed_matrix_roofline", ctx) == pytest.approx(100.0)


@pytest.mark.parametrize("kernel,shape,nbytes,ops", [
    # PERF.md section 6's rows at one query row (the tables counted there)
    ("lb_sax_matrix", dict(q=1, n_words=4198400, m=16), 83970112, 407244800),
    ("lb_sax_matrix", dict(q=1, n_words=1052672, m=16), 21055552, 102109184),
    # its wave rows left the two 1 KiB bound tables out: + 2,048 B here
    ("lb_sax_matrix", dict(q=128, n_words=4198400, m=16), 2216763392 + 2048, 52127334400),
    ("lb_sax_matrix", dict(q=32, n_words=4198400, m=16), 604571648 + 2048, 13031833600),
    ("ed_min", dict(q=128, rows=4194304, n=256), 4295099392, 274877906944),
    ("ed_min", dict(q=128, rows=131072, n=256), 134349824, 8589934592),
    ("ed_matrix", dict(q=128, rows=4096, n=256), 6422528, 268435456),
    ("ed_matrix", dict(q=128, rows=131072, n=256), 201457664, 8589934592),
])
def test_roofline_counts_reproduce_the_kernel_table(kernel, shape, nbytes, ops):
    assert spec.roofline(kernel).cost(**shape) == (nbytes, ops)


def test_kernel_table_bounds():
    # PERF.md section 6: lb_sax Q=1 0.0251 ms (bytes), ed_min 4.1027 ms (operations)
    assert 1e3 * peaks.bound_seconds(83970112, 407244800) == pytest.approx(0.0251, abs=5e-5)
    assert 1e3 * peaks.bound_seconds(4295099392, 274877906944) == pytest.approx(4.1027, abs=5e-5)


def test_trace_summary_unions_overlaps_and_names_gaps():
    device = [(0.0, 100.0, "k1"), (50.0, 150.0, "memcpy"), (400.0, 500.0, "k1"),
              (900.0, 1000.0, "k2")]
    host = [(0.0, 1000.0, "step"), (160.0, 390.0, "aten::sort"),
            (600.0, 880.0, "aten::item"), (700.0, 710.0, "cudaStreamSynchronize")]
    s = trace.summarize(device, host, wall_s=1e-3)
    assert s["busy_s"] == pytest.approx(350e-6)          # 0..150, 400..500, 900..1000
    assert s["by_name"]["k1"] == [pytest.approx(200e-6), 2]
    assert s["device_ops"][0] == ["k1", pytest.approx(200e-6)]
    # gaps 150..400 (middle 275: in aten::sort) and 500..900 (middle 700:
    # in the synchronize nested in aten::item)
    assert dict((n, v) for n, v in s["idle_gaps"]) == {
        "aten::sort": pytest.approx(250e-6), "cudaStreamSynchronize": pytest.approx(400e-6)}
    assert trace.kernel_seconds(s, ("k",)) == pytest.approx(300e-6)


def test_trace_summary_lists_at_most_ten():
    device = [(10.0 * i, 10.0 * i + 1, f"op{i}") for i in range(30)]
    s = trace.summarize(device, [], wall_s=1.0)
    assert len(s["device_ops"]) == 10 and s["idle_gaps"] == [["host idle",
                                                               pytest.approx(29 * 9e-6)]]
    assert math.isclose(s["busy_s"], 30e-6)
