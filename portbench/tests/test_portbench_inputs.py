"""The device-form generators against `repro_torch.data.scidata`'s
construction at small sizes."""
import numpy as np
import torch

from portbench import harness
from repro_torch.data import scidata

NYX = harness.load_module("inputs", "nyx_like")
HACC = harness.load_module("inputs", "hacc_like")
BIG_SEED = 2 ** 31 + 977


def test_nyx_field_is_scidatas():
    for seed in (0, 3):
        want = scidata.nyx_like((12, 20, 24), seed=seed, device="cpu")
        g = NYX.log_field((12, 20, 24), np.random.default_rng(seed), "cpu")
        assert torch.equal(torch.exp(2.5 * g), want)


def test_nyx_snapshots_follow_the_seed():
    cfg = {"shape": [16, 24, 32],
           "generator_params": {"snapshots": 3, "g_std": 2.0}}
    a = NYX.snapshots(cfg, BIG_SEED, "cpu")
    b = NYX.snapshots(cfg, BIG_SEED, "cpu")
    c = NYX.snapshots(cfg, BIG_SEED + 1, "cpu")
    assert len(a) == 3 and all(x.shape == (16, 24, 32) for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    for i, x in enumerate(a):
        g = NYX.log_field(cfg["shape"], np.random.default_rng([BIG_SEED, i]),
                          "cpu")
        assert torch.equal(x, torch.exp(2.5 * (g * (2.0 / float(g.std())))))
        assert abs(float(torch.log(x).std()) - 2.5 * 2.0) < 1e-3


def test_hacc_construction_is_scidatas():
    """Fed numpy's own draws, the construction gives scidata's field."""
    n = 40001
    for seed in (0, 7):
        rng = np.random.default_rng(seed)
        u = torch.from_numpy(rng.random(max(1, n // 256)))
        z = torch.from_numpy(rng.standard_normal(n))
        assert torch.equal(HACC.construct(u, z, n),
                           torch.from_numpy(scidata.hacc_like(n, seed)))


def test_hacc_snapshots_follow_the_seed():
    cfg = {"shape": [20001], "generator_params": {"snapshots": 3}}
    a = HACC.snapshots(cfg, BIG_SEED, "cpu")
    b = HACC.snapshots(cfg, BIG_SEED, "cpu")
    c = HACC.snapshots(cfg, BIG_SEED + 1, "cpu")
    assert len(a) == 3 and all(x.shape == (20001,) for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    assert a[0].dtype == torch.float32
