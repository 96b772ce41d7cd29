"""The metric readers on a small recorded profiler event list and a
record whose values are worked out by hand."""
import pytest

from portbench import harness, peaks
from portbench.tracefile import CALL_SPAN, FIELD_SPAN, Trace


def X(cat, name, ts, end, corr=None, tid=1, pid=100):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
         "pid": pid, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def D(cat, name, ts, end, corr):
    return X(cat, name, ts, end, corr, tid=7, pid=0)


# two fields, microseconds; the comments give what each event stands for
EVENTS = [
    {"ph": "M", "name": "process_name", "pid": 0, "args": {}},
    D("kernel", "warm_kernel", -50, -40, 9),          # before the window
    X("cuda_runtime", "cudaLaunchKernel", -60, -59, 9),
    X("user_annotation", FIELD_SPAN, 0, 100),
    X("user_annotation", CALL_SPAN, 0, 80),
    X("cpu_op", "aten::aminmax", 5, 15),              # a torch kernel
    X("cuda_runtime", "cudaLaunchKernel", 8, 10, 1),
    D("kernel", "reduce_kernel", 12, 20, 1),
    X("cuda_runtime", "cudaLaunchKernel", 20, 22, 2),  # the port's own
    D("kernel", "deflate_kernel", 25, 45, 2),
    X("cpu_op", "aten::_local_scalar_dense", 50, 70),  # a read
    X("cuda_runtime", "cudaMemcpyAsync", 52, 54, 3),
    D("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 55, 56, 3),
    X("cuda_runtime", "cudaStreamSynchronize", 54, 68),
    X("cuda_runtime", "cudaDeviceSynchronize", 82, 95),  # the harness's
    X("user_annotation", FIELD_SPAN, 110, 200),
    X("user_annotation", CALL_SPAN, 110, 180),
    X("cuda_runtime", "cudaLaunchKernel", 112, 114, 4),
    D("kernel", "deflate_kernel", 115, 165, 4),
    X("cpu_op", "aten::nonzero", 166, 178),
    X("cuda_runtime", "cudaMemsetAsync", 167, 168, 5),
    D("gpu_memset", "Memset (Device)", 169, 170, 5),
    X("cuda_runtime", "cudaStreamSynchronize", 170, 177),
    X("cuda_runtime", "cudaDeviceSynchronize", 181, 190),
    X("cpu_op", "aten::empty", 60, 61, tid=2),         # another thread
]


def record(trace=None, stored=(1000, 1000)):
    return harness.Record(
        setup_s=12.5, window_s=0.5,
        latencies_s=[i * 1e-3 for i in range(1, 101)],
        field_bytes=[4000] * 100 if trace is None else [4000, 4000],
        stored_bytes=list(stored) if trace is not None else [1000] * 100,
        snapshot_raw=[4000, 4000], snapshot_stored=[400, 600], trace=trace)


def read(name, rec):
    return harness.reader(name).read(rec)


def test_trace_reading():
    t = Trace(EVENTS)
    assert t.n_fields == 2 and t.window == (0.0, 200.0)
    assert len(t.device) == 5                       # the warm kernel is out
    assert t.busy_us() == pytest.approx(80.0)
    assert t.device_us(own=True) == pytest.approx(70.0)
    assert t.device_us(own=False) == pytest.approx(10.0)
    assert t.host_syncs() == 2
    assert t.top_device_ops()[0] == ["deflate_kernel", pytest.approx(7e-5)]
    gaps = dict((k, v) for k, v in t.idle_gaps())
    assert gaps == pytest.approx({
        "cudaDeviceSynchronize": 89e-6, "aten::aminmax": 12e-6,
        "aten::_local_scalar_dense": 10e-6, "portbench.call": 5e-6,
        "aten::nonzero/cudaMemsetAsync": 4e-6})


def test_per_layer_readers():
    rec = record(Trace(EVENTS))
    for direction in ("compress", "decompress"):
        assert read(f"torch_ops_ms.{direction}", rec) == pytest.approx(0.005)
        assert read(f"host_syncs_per_field.{direction}", rec) == 1.0
        assert read(f"device_ops_per_field.{direction}", rec) == 2.5
        assert read(f"device_idle_pct.{direction}", rec) == pytest.approx(
            60.0)
        assert read(f"kernel_roofline_pct.{direction}", rec) == \
            pytest.approx(100 * 10000 / peaks.HBM_BYTES_PER_S / 80e-6)


def test_end_to_end_readers():
    rec = record()
    assert read("compress_GBps", rec) == pytest.approx(400000 / 0.5 / 1e9)
    assert read("decompress_GBps", rec) == pytest.approx(400000 / 0.5 / 1e9)
    assert read("compress_ms_p95", rec) == pytest.approx(95.95)
    assert read("ratio", rec) == pytest.approx(8.0)
    assert read("setup_s", rec) == 12.5


def test_readers_find_nothing_without_a_trace_or_a_device():
    for rec in (record(), record(Trace([])),
                record(Trace([e for e in EVENTS
                              if e.get("pid") != 0]))):
        for name in ("torch_ops_ms", "host_syncs_per_field",
                     "device_ops_per_field", "kernel_roofline_pct",
                     "device_idle_pct"):
            assert read(name, rec) is None
    missing = record()
    missing.snapshot_stored = [400, None]
    assert read("ratio", missing) is None
