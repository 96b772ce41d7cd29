"""The port's spans (`repro_torch.perf.trace`) on the CPU.

Without a profiler a span is one shared no-op and nothing is recorded.
Under `torch.profiler` a staged codec's encode and the registry's decode
each export one `codec.*` span, the compressor's `stage.*` spans nest
inside them, and a `dispatch.<kernel>` span nests inside a stage for every
kernel the codec's stages resolve.  Containers and reconstructions are
the same, bit for bit, with the profiler on and off.
"""
from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import codecs
from repro_torch.core import interp, stages
from repro_torch.kernels import dispatch
from repro_torch.perf import trace

CODECS = ("cusz", "cusz-i", "fz")
COMPRESS_STAGES = ("stage.resolve_eb", "stage.predict", "stage.encode")
DECOMPRESS_STAGES = ("stage.decode_meta", "stage.decode",
                     "stage.reconstruct")
# rounding of the exported microseconds
EPS = 1e-3


def field(seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(16, 24, 20, generator=g).cumsum(0)


def roundtrip(name: str, x: torch.Tensor):
    c = codecs.get(name).encode(x)
    return c, codecs.decode(c)


def profiled(fn, tmp_path):
    """(fn's result, the user_annotation events of its exported trace)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]


def inside(child, parent) -> bool:
    return (child["ts"] >= parent["ts"] - EPS
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"]
            + EPS)


def named(events, prefix):
    return [e for e in events if e["name"].startswith(prefix)]


def test_the_profiler_flag_the_spans_read():
    """`span` reads this private flag of torch's; a torch that renames it
    would drop every span without notice."""
    from torch.autograd import profiler

    assert profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiler._is_profiler_enabled is True
        assert trace.span("x") is not trace.span("y")
    assert profiler._is_profiler_enabled is False


def test_a_span_without_a_profiler_is_the_shared_no_op():
    assert trace.span("codec.encode") is trace.span("stage.decode")
    with trace.span("stage.encode") as entered:
        assert entered is None


@pytest.mark.parametrize("name", CODECS)
def test_no_profiler_records_nothing(name, monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda span_name: made.append(span_name))
    roundtrip(name, field())
    assert made == []


@pytest.mark.parametrize("name", CODECS)
def test_spans_nest_codec_stage_dispatch(name, tmp_path):
    (c, _), events = profiled(lambda: roundtrip(name, field()), tmp_path)
    enc, dec = named(events, "codec.encode"), named(events, "codec.decode")
    assert len(enc) == 1 and len(dec) == 1
    got_stages = [e for e in named(events, "stage.")
                  if e["name"] != interp.LEVELS_SPAN]
    assert sorted(e["name"] for e in got_stages) == sorted(
        COMPRESS_STAGES + DECOMPRESS_STAGES)
    for e in got_stages:
        outer = enc[0] if e["name"] in COMPRESS_STAGES else dec[0]
        assert inside(e, outer), e["name"]
    codec = codecs.get(name)
    want = set(stages.get_predictor(codec.cfg.predictor).kernels
               + stages.get_encoder(codec.cfg.encoder).kernels)
    got = named(events, "dispatch.")
    assert {e["name"] for e in got} == {f"dispatch.{k}" for k in want}
    for e in got:
        assert any(inside(e, s) for s in got_stages), e["name"]


@pytest.mark.parametrize("name", CODECS)
def test_interp_level_loop_span_per_field(name, tmp_path):
    """One `stage.interp.levels` span in each encode and each decode of
    an interpolation-predicted field, inside `stage.predict` and
    `stage.reconstruct`; none for the Lorenzo codecs."""
    _, events = profiled(lambda: roundtrip(name, field()), tmp_path)
    levels = sorted(named(events, interp.LEVELS_SPAN),
                    key=lambda e: e["ts"])
    if codecs.get(name).cfg.predictor != "interp":
        assert levels == []
        return
    assert len(levels) == 2
    (predict,), (reconstruct,) = (named(events, "stage.predict"),
                                  named(events, "stage.reconstruct"))
    assert inside(levels[0], predict) and inside(levels[1], reconstruct)
    for e in named(events, "dispatch.interp."):
        assert any(inside(e, lv) for lv in levels), e["name"]


def test_decode_table_spans_count_the_builds(tmp_path):
    """The decode table is cached by the stored lengths tensor: a second
    decode of one container builds none, a fresh copy of its lengths (as
    a read from storage gives) builds one again."""
    c = codecs.get("cusz").encode(field(1))

    def decodes():
        codecs.decode(c)
        codecs.decode(c)
        fresh = c.replace(payload={**c.payload,
                                   "lengths": c.payload["lengths"].clone()})
        codecs.decode(fresh)

    _, events = profiled(decodes, tmp_path)
    assert len(named(events, "codec.decode")) == 3
    assert len(named(events, "dispatch.huffman.decode_table")) == 2


@pytest.mark.parametrize("name", CODECS)
def test_the_profiler_changes_no_output(name, tmp_path):
    x = field(2)
    c_off, y_off = roundtrip(name, x)
    (c_on, y_on), _ = profiled(lambda: roundtrip(name, x), tmp_path)
    assert c_on.header == c_off.header
    assert c_on.payload.keys() == c_off.payload.keys()
    for k, v in c_off.payload.items():
        assert c_on.payload[k].dtype == v.dtype, k
        assert torch.equal(c_on.payload[k], v), k
    assert torch.equal(y_on.view(torch.int32), y_off.view(torch.int32))


def test_spanned_keeps_the_function_and_closes_on_error(tmp_path):
    @trace.spanned("stage.probe")
    def probe(v):
        """probe's doc"""
        if v < 0:
            raise ValueError("negative")
        return v + 1

    assert probe.__name__ == "probe" and probe.__doc__ == "probe's doc"
    assert probe(1) == 2

    def calls():
        with pytest.raises(ValueError):
            probe(-1)
        return probe(2)

    out, events = profiled(calls, tmp_path)
    assert out == 3
    assert [e["name"] for e in events] == ["stage.probe", "stage.probe"]
    assert events[0]["ts"] + events[0]["dur"] <= events[1]["ts"] + EPS


def test_every_kernel_span_is_named_by_its_registration():
    kernels = dispatch.registered()
    assert set(dispatch.PIPELINE_STAGES) <= set(kernels)
    for name in dispatch.PIPELINE_STAGES:
        assert kernels[name].span == f"dispatch.{name}"
