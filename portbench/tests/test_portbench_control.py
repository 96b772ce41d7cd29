"""The check decides `correct`: sound runs pass it, and the control (the
reference one precision lower in the program's place) and a broken
program fail it.  On the CPU the port runs its plain path; the `cuda`
cases run the same at small sizes on the card."""
import pytest
import torch

from conftest import CELLS, DEVICES, SMALL
from portbench import harness
from portbench.control import Control


def run(cell, device, program=harness.Port, seed=2 ** 31 + 11):
    return harness.run(cell, seed, 0.3, False, device=device,
                       program=program, config=SMALL[cell.split(".")[0]],
                       emit=lambda d: None)


class Altered(harness.Port):
    """One answer altered where it is produced: a bit of the first
    stream word, or one reconstructed value moved by one ulp."""

    def encode(self, x):
        c = super().encode(x)
        c.payload["words"].view(torch.int32).reshape(-1)[0] ^= 1
        return c

    def decode(self, c):
        y = super().decode(c)
        flat = y.reshape(-1)
        flat[0] = torch.nextafter(flat[0], flat.new_tensor(float("inf")))
        return y


class Half(harness.Port):
    """Half of the field left out: only the first half is compressed, or
    reconstructed (the rest left 0)."""

    def encode(self, x):
        flat = x.reshape(-1).clone()
        flat[flat.numel() // 2:] = 0
        return super().encode(flat.reshape(x.shape))

    def decode(self, c):
        y = super().decode(c).clone()
        y.reshape(-1)[y.numel() // 2:] = 0
        return y


@pytest.mark.parametrize("device", DEVICES, indirect=True)
@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(cell, device):
    r = run(cell, device)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("device", DEVICES, indirect=True)
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, device):
    r = run(cell, device, Control)
    assert r["correct"] is False
    # the control fails every number this direction compares
    for c in r["checks"].values():
        assert c["value"] is None or c["value"] > c["limit"]


@pytest.mark.parametrize("device", DEVICES, indirect=True)
@pytest.mark.parametrize("fault", [Altered, Half])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_is_not_correct(cell, fault, device):
    assert run(cell, device, fault)["correct"] is False


def test_every_decode_is_a_fresh_read(monkeypatch):
    """Each decode gets its container as a read from storage hands it
    over, so the port builds the decode tables on every call and takes
    none from its cache."""
    from repro_torch.core import huffman

    built = []
    build = huffman.build_decode_table
    monkeypatch.setattr(huffman, "build_decode_table",
                        lambda *a, **k: built.append(1) or build(*a, **k))
    r = run("cusz-nyx.decompress", "cpu")
    assert r["correct"] is True
    assert len(built) == r["attempted"] + 4 * harness.WARMUP_ROUNDS
