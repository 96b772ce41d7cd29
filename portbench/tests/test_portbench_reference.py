"""The frozen reference gives the port's containers byte for byte, its
stored bytes and its reconstructions, on small fields on the CPU (where
the port runs its plain path)."""
import numpy as np
import pytest
import torch

from portbench import harness
from repro_torch import codecs
from repro_torch.data import scidata

R = harness.load_module("reference", "cusz")
PARAMS = harness.load_json("configs", "cusz-nyx")["codec_params"]


def fields():
    yield "nyx", scidata.nyx_like((24, 40, 48), seed=3, device="cpu")
    yield "nyx-ragged", scidata.nyx_like((21, 33, 47), seed=5, device="cpu")
    yield "hacc", torch.from_numpy(scidata.hacc_like(n=300001, seed=1))
    yield "hacc-tight", torch.from_numpy(scidata.hacc_like(n=70001, seed=2))


CASES = [(name, x, eb) for name, x in fields() for eb in (1e-4, 1e-5)]


@pytest.mark.parametrize("name,x,eb", CASES,
                         ids=[f"{n}-{eb:g}" for n, _, eb in CASES])
def test_reference_matches_the_port(name, x, eb):
    params = {**PARAMS, "eb": eb}
    port = harness.Port(harness.Cell("t", {"codec": "cusz",
                                           "codec_params": params},
                                     {}, None, R))
    c = port.encode(x)
    h_got, p_got = port.container(c)
    h_want, p_want = R.compress(x, params)
    assert harness.header_mismatch(h_got, h_want) == 0
    assert harness.payload_mismatch(p_got, p_want) == 0
    assert R.stored_nbytes(p_want) == codecs.get("cusz").pack(c).nbytes
    y = port.decode(c)
    want = R.reconstruct(x, params)
    assert torch.equal(y.view(torch.int32), want.view(torch.int32))
    tol = R.tolerance(x, R.resolve_eb(x, params))
    assert float((y - x).abs().max()) <= tol


def test_the_bfloat16_control_differs():
    x = scidata.nyx_like((24, 40, 48), seed=3, device="cpu")
    _, p32 = R.compress(x, PARAMS)
    _, p16 = R.compress(x, PARAMS, torch.bfloat16)
    assert harness.payload_mismatch(p16, p32) > 0
    assert R.stored_nbytes(p16) != R.stored_nbytes(p32)
    y16 = R.reconstruct(x, PARAMS, torch.bfloat16)
    tol = R.tolerance(x, R.resolve_eb(x, PARAMS))
    assert float((y16 - x).abs().max()) > tol


def test_two_queue_tree_is_huffman():
    """Bitlengths of the reference's tree give the optimal code length
    (a heap-built Huffman code's), with ties and one symbol."""
    import heapq

    rng = np.random.default_rng(0)
    for freq in (rng.integers(0, 50, 300), np.array([0, 7, 0]),
                 np.array([1, 1, 1, 1, 2, 2, 4])):
        got = R.codeword_lengths(torch.from_numpy(freq).to(torch.int32))
        active = [int(f) for f in freq if f > 0]
        heap = list(active)
        heapq.heapify(heap)
        cost = 0
        while len(heap) > 1:
            a, b = heapq.heappop(heap), heapq.heappop(heap)
            cost += a + b
            heapq.heappush(heap, a + b)
        if len(active) == 1:
            cost = active[0]
        assert int((got.long() * torch.from_numpy(freq)).sum()) == cost
