"""The split of the window's device idle time among the program's span
layers (`portbench.spans`) and its readers, on traces built by hand."""
import pytest

from portbench import harness, spans
from portbench.tracefile import CALL_SPAN, FIELD_SPAN, Trace


def X(cat, name, ts, end, corr=None, tid=1, pid=100):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
         "pid": pid, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def U(name, ts, end):
    return X("user_annotation", name, ts, end)


def K(ts, end, corr):
    return X("kernel", "k", ts, end, corr, tid=7, pid=0)


# one field, microseconds; device busy [12, 20), [40, 50), [95, 98)
EVENTS = [
    U("codec.encode", -30, -10),                      # the untimed call
    U("stage.predict", -25, -15),
    U(FIELD_SPAN, 0, 100),
    U(CALL_SPAN, 0, 90),
    U("codec.encode", 2, 88),
    U("stage.resolve_eb", 4, 30),
    U("dispatch.histogram", 10, 25),
    K(12, 20, 1),
    U("stage.predict", 30, 60),
    U("dispatch.lorenzo.dualquant", 35, 45),
    K(40, 50, 2),
    U("portbench.other", 65, 70),                     # not the program's
    X("cpu_op", "aten::nonzero", 70, 80),
    K(95, 98, 3),
]
# idle: [0, 12), [20, 40), [50, 95), [98, 100); 79 us in all
WANT = {
    "codec": 2 + 28,           # [2, 4), [60, 88)
    "stage": 6 + 5 + 5 + 10,   # [4, 10), [25, 30), [30, 35), [50, 60)
    "dispatch": 2 + 5 + 5,     # [10, 12), [20, 25), [35, 40)
    "outside": 2 + 7 + 2,      # [0, 2), [88, 95), [98, 100)
}


def record(events):
    return harness.Record(
        setup_s=1.0, window_s=1e-4, latencies_s=[1e-4], field_bytes=[4000],
        stored_bytes=[1000], snapshot_raw=[4000], snapshot_stored=[1000],
        trace=Trace(events))


def test_nested_spans_idle_goes_to_the_innermost():
    split = spans.idle_split(Trace(EVENTS))
    assert split == pytest.approx(WANT)


def test_a_gap_across_a_span_boundary_is_cut_there():
    # one gap [0, 100) with no device work but a kernel at the window's
    # end; the stage span [20, 60) inside the codec span [10, 80)
    events = [U(FIELD_SPAN, 0, 110), U("codec.decode", 10, 80),
              U("stage.decode", 20, 60), K(100, 110, 1)]
    assert spans.idle_split(Trace(events)) == pytest.approx(
        {"codec": 30.0, "stage": 40.0, "dispatch": 0.0, "outside": 30.0})


def test_the_layers_add_up_to_the_idle_time():
    t = Trace(EVENTS)
    idle = t.window_us() - t.busy_us()
    assert idle == 79.0
    assert abs(sum(spans.idle_split(t).values()) - idle) <= 1e-9
    assert sum(b - a for a, b in spans.idle_intervals(t)) == idle


def test_spans_before_the_window_are_ignored():
    names = [e.name for e in spans.program_spans(Trace(EVENTS))]
    assert names == ["codec.encode", "stage.resolve_eb",
                     "dispatch.histogram", "stage.predict",
                     "dispatch.lorenzo.dualquant"]
    # a span of the untimed call that overlapped the window would still
    # be left out: it starts before the window
    events = [U("stage.encode", -5, 8)] + EVENTS
    assert spans.idle_split(Trace(events)) == pytest.approx(WANT)


@pytest.mark.parametrize("direction", ["compress", "decompress"])
def test_readers(direction):
    rec = record(EVENTS)
    for layer in spans.LAYERS:
        got = harness.reader(f"{layer}_idle_ms.{direction}").read(rec)
        assert got == pytest.approx(WANT[layer] / 1e3)


def test_readers_return_none_without_program_spans():
    def program(e):
        return e["name"].startswith(spans.PREFIXES)

    no_spans = [e for e in EVENTS if not program(e)]
    # only the untimed call's spans, before the window
    before_only = [e for e in EVENTS if not program(e) or e["ts"] < 0]
    no_device = [e for e in EVENTS if e["pid"] != 0]
    for events in (no_spans, before_only, no_device, []):
        rec = record(events)
        for layer in spans.LAYERS:
            assert harness.reader(f"{layer}_idle_ms").read(rec) is None
    rec = record(EVENTS)
    rec.trace = None
    assert harness.reader("stage_idle_ms").read(rec) is None
