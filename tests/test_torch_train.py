"""Port parity for the train step's parts (`repro_torch.data.pipeline`,
`repro_torch.train.train_step`, `repro_torch.optim.adamw`,
`repro_torch.core.{gradient,weights}`) against the reference's, on the
CPU, with the reference's weights carried over by `params_from_numpy`.

Tolerances, each restated where it is used:
  * `host_batch`: bit-identical.
  * `loss_fn` and its grads with the forward patched to f32 on both sides
    (qwen3-4b, qwen2.5-3b, deepseek-v2-236b, mamba2-1.3b,
    jamba-1.5-large-398b; phi-3-vision with patch embeddings): the loss
    within 1e-5 relative, every grad leaf within 1e-4 of the reference
    leaf's max |g| (the two packages' matmuls sum in other orders; the
    gaps at these sizes are 2e-7 and 1e-6 to 7e-6).  At the default bf16
    compute, for the dense archs: the loss within 1e-2 relative and every
    grad leaf's cosine with the reference's at least 0.99 (the packages
    round bf16 intermediates at different points).  MoE routing is
    discontinuous, so the MoE archs are compared in f32 only.
  * `adamw.update` on identical inputs against `jax.jit(adamw.update)`:
    params and f32 moments within rtol 1e-6, and 1e-6 of the leaf's max
    |value| near zero (XLA on the CPU contracts
    ``b1·m + (1-b1)·g`` into one fused multiply-add, the port rounds the
    product first: an ulp apart).  `_quantize` against
    `jax.jit(_quantize)`: int8 codes and scales bit-identical (the scale
    is ``max * f32(1/127)``, XLA's form of the divide by the constant).
  * `compressed_psum_mean` (int8 and int16, 2 and 4 pods),
    `compress_for_gather` and `_qdq` against `jax.jit` of the reference:
    bit-identical.  The pod mean is within amax/(qmax//npods)/2 of the
    plain mean and cannot overflow the narrow sum.
  * `make_train_step` against the reference's jitted step, per
    `TrainConfig` branch, in f32: the loss within 1e-5 relative and the
    first moment after one step (= (1-b1)·grad, which holds the grads)
    within 1e-4 of its max, plus one quantization step where the grads
    pass a quantizer (int8 grad compress, int8 moments).  Parameters
    after a step are not compared: Adam's first step is ~lr·sign(g), so
    a grad that is ~0 moves a parameter by ±lr on either side.  The
    same check holds the card's step (the `cuda` tests) to the reference.
  * `train:compress`'s configuration over 3 steps against the
    reference's jitted run, f32: each loss within 1e-5 relative, and
    both runs blow up at the third step.

The reference imports `repro.dist`, whose package init imports a `chaos`
module that the checkout lacks: the `ref` fixture puts an unarmed
stand-in into `sys.modules` for this module's duration and removes every
`repro*` module it caused to be imported at teardown.  The `cuda` tests
hold the card to the reference (run on the CPU) on the same inputs, and
`compress_for_gather` on the card to the CPU's bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import os
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import gradient as TG
from repro_torch.core import weights as TW
from repro_torch.data import pipeline as TP
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA
from repro_torch.train import train_step as TT
from repro_torch.tree import leaves, leaves_up_to

F32_ARCHS = ("qwen3-4b", "qwen2.5-3b", "deepseek-v2-236b", "mamba2-1.3b",
             "jamba-1.5-large-398b", "phi-3-vision-4.2b")
DENSE = ("qwen3-4b", "qwen2.5-3b")


@pytest.fixture(scope="module")
def ref():
    """The reference modules, imported with an unarmed `repro.dist.chaos`
    stand-in; every `repro*` module this import added leaves
    `sys.modules` again at teardown."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    before = set(sys.modules)
    stub = types.ModuleType("repro.dist.chaos")
    stub.current = lambda: None
    sys.modules["repro.dist.chaos"] = stub
    names = {"jax": "jax", "jnp": "jax.numpy", "configs": "repro.configs",
             "M": "repro.models.model", "T": "repro.train.train_step",
             "A": "repro.optim.adamw", "G": "repro.core.gradient",
             "W": "repro.core.weights", "P": "repro.data.pipeline"}
    try:
        yield types.SimpleNamespace(**{k: importlib.import_module(v)
                                       for k, v in names.items()})
    finally:
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name == "repro" or name.startswith("repro."):
                del sys.modules[name]
                parent, _, child = name.rpartition(".")
                if parent in sys.modules:
                    sys.modules[parent].__dict__.pop(child, None)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    return torch.device("cuda")


@contextlib.contextmanager
def f32_forward(ref):
    """Both packages' `loss_fn` forward in f32 (restored on exit)."""
    r, t = ref.T.M.forward, TM.forward
    ref.T.M.forward = functools.partial(r, compute_dtype=ref.jnp.float32)
    TM.forward = functools.partial(t, compute_dtype=torch.float32)
    try:
        yield
    finally:
        ref.T.M.forward, TM.forward = r, t


def _np(tree, ref):
    return ref.jax.tree.map(np.asarray, tree)


def _setup(ref, arch, batch=2, seq=32, seed=0):
    """(reference cfg, port cfg, reference params, port params, int32
    tokens, reference extra, port extra)."""
    rcfg = ref.configs.reduced(arch, n_periods=1)
    tcfg = tconfigs.reduced(arch, n_periods=1)
    rp = ref.M.init_params(ref.jax.random.PRNGKey(seed), rcfg)
    tp = TM.params_from_numpy(_np(rp, ref), device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, rcfg.vocab, (batch, seq)).astype(np.int32)
    rx = tx = None
    if rcfg.n_prepend_embeds:
        pe = (rng.standard_normal((batch, rcfg.n_prepend_embeds,
                                   rcfg.d_model)) * 0.1).astype(np.float32)
        rx = {"patch_embeds": ref.jnp.asarray(pe)}
        tx = {"patch_embeds": torch.from_numpy(pe)}
    return rcfg, tcfg, rp, tp, toks, rx, tx


def _assert_grads_close(got_tree, want_tree, ref, rel=1e-4):
    got = [g.detach().float().numpy() for g in leaves(got_tree)]
    want = [np.asarray(w, np.float32)
            for w in ref.jax.tree.leaves(want_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        tol = rel * float(np.abs(w).max()) + 1e-12
        assert float(np.abs(g - w).max()) <= tol


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seed,step", [(256, 0, 0), (256, 3, 7),
                                             (151936, 0, 5),
                                             (50280, 11, 123)])
def test_host_batch_bit_identical(ref, vocab, seed, step):
    """Bit-identical to the reference's `host_batch`."""
    got = TP.host_batch(vocab, 4, 48, step, seed)
    want = ref.P.host_batch(vocab, 4, 48, step, seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# loss and grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", F32_ARCHS)
def test_loss_and_grads_f32(ref, arch):
    """f32 forward on both sides: the loss within 1e-5 relative, each
    grad leaf within 1e-4 of the reference leaf's max |g| (phi-3-vision
    with patch embeddings: its loss drops the patch positions)."""
    rcfg, tcfg, rp, tp, toks, rx, tx = _setup(ref, arch)
    with f32_forward(ref):
        lr, gr = ref.jax.value_and_grad(ref.T.loss_fn)(
            rp, rcfg, ref.jnp.asarray(toks), rx)
        lt, gt = TT._value_and_grad(tp, tcfg, torch.from_numpy(toks), tx)
    assert abs(float(lt) - float(lr)) <= 1e-5 * abs(float(lr))
    _assert_grads_close(gt, gr, ref)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_bf16(ref, arch):
    """Default bf16 compute: the loss within 1e-2 relative, every grad
    leaf's cosine with the reference's at least 0.99."""
    rcfg, tcfg, rp, tp, toks, rx, tx = _setup(ref, arch)
    lr, gr = ref.jax.value_and_grad(ref.T.loss_fn)(
        rp, rcfg, ref.jnp.asarray(toks), rx)
    lt, gt = TT._value_and_grad(tp, tcfg, torch.from_numpy(toks), tx)
    assert abs(float(lt) - float(lr)) <= 1e-2 * abs(float(lr))
    for g, w in zip(leaves(gt), ref.jax.tree.leaves(gr)):
        g = g.float().numpy().ravel().astype(np.float64)
        w = np.asarray(w, np.float64).ravel()
        cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w) + 1e-30)
        assert cos >= 0.99


def test_loss_chunks_pad_and_sum_in_order(ref):
    """A sequence longer than one CE chunk (1,030 positions: two chunks,
    the second padded) gives the reference's loss within 1e-5 relative in
    f32, and `loss_fn` equals the mean CE of the full logits."""
    rcfg, tcfg, rp, tp, toks, rx, tx = _setup(ref, "qwen3-4b", batch=1,
                                              seq=TT.CE_CHUNK + 7)
    with f32_forward(ref):
        lr = ref.T.loss_fn(rp, rcfg, ref.jnp.asarray(toks))
        with torch.no_grad():
            lt = TT.loss_fn(tp, tcfg, torch.from_numpy(toks))
            logits, _ = TM.forward(tp, tcfg, torch.from_numpy(toks))
    full = torch.nn.functional.cross_entropy(
        logits[0, :-1], torch.from_numpy(toks[0, 1:]).long())
    assert abs(float(lt) - float(lr)) <= 1e-5 * abs(float(lr))
    assert abs(float(lt) - float(full)) <= 1e-5 * abs(float(full))


def test_microbatched_grads_match_full():
    """The port's own property, as the reference's test states it: 4
    microbatches give the full batch's mean loss (within 1e-4) and grads
    (rtol 2e-2, atol 2e-4)."""
    cfg = tconfigs.reduced("qwen2.5-3b", n_periods=1)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, 32)).astype(np.int32))
    l1, g1 = TT._microbatched_grads(params, cfg, TT.TrainConfig(), toks,
                                    None)
    l4, g4 = TT._microbatched_grads(params, cfg,
                                    TT.TrainConfig(microbatches=4), toks,
                                    None)
    assert abs(float(l1) - float(l4)) < 1e-4
    for a, b in zip(leaves(g1), leaves(g4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2,
                                   atol=2e-4)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

SHAPES = {"emb": (64, 256), "stack": (2, 128, 128), "norm": (7,),
          "odd": (40, 100)}


def _draw(rng, scale):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _assert_ulp_close(got, want):
    """rtol 1e-6, and within 1e-6 of the leaf's max |value| where a value
    is near zero (one ulp of a cancelled sum is large relative to it)."""
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("quantized", (False, True))
def test_adamw_update_matches_jitted_reference(ref, quantized):
    """On identical inputs (the reference's state after two steps, carried
    over by `opt_state_from_numpy`), one update against
    `jax.jit(adamw.update)`: params and f32 moments within rtol 1e-6
    (atol 1e-6 of the leaf's max near zero); int8 moments' codes within one level and scales within rtol 1e-6
    (the f32 moment before the requantize is an ulp apart)."""
    rng = np.random.default_rng(0)
    rcfg = ref.A.AdamWConfig(quantized_moments=quantized)
    tcfg = TA.AdamWConfig(quantized_moments=quantized)
    upd = ref.jax.jit(lambda g, s, p: ref.A.update(g, s, p, rcfg))
    rp = {k: ref.jnp.asarray(v) for k, v in _draw(rng, 0.02).items()}
    rs = ref.A.init(rp, rcfg)
    for _ in range(2):
        rp, rs = upd({k: ref.jnp.asarray(v)
                      for k, v in _draw(rng, 1e-3).items()}, rs, rp)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    ts = TA.opt_state_from_numpy(_np(rs, ref), device="cpu")
    assert int(ts.count) == 2
    g = _draw(rng, 1e-3)
    rp, rs = upd({k: ref.jnp.asarray(v) for k, v in g.items()}, rs, rp)
    tp, ts = TA.update({k: torch.from_numpy(v) for k, v in g.items()}, ts,
                       tp, tcfg)
    assert int(ts.count) == int(rs.count) == 3
    for k in SHAPES:
        _assert_ulp_close(tp[k].numpy(), np.asarray(rp[k]))
    for got, want in ((ts.m, rs.m), (ts.v, rs.v)):
        for k in SHAPES:
            a, b = got[k], want[k]
            if isinstance(a, TA.QTensor):
                assert isinstance(b, ref.A.QTensor)
                dq = np.abs(a.q.numpy().astype(int)
                            - np.asarray(b.q).astype(int))
                assert dq.max() <= 1
                np.testing.assert_allclose(a.scale.numpy(),
                                           np.asarray(b.scale), rtol=1e-6)
            else:
                _assert_ulp_close(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("key", ("emb", "stack"))
def test_adamw_quantize_is_the_jitted_form(ref, key):
    """`_quantize` against `jax.jit(_quantize)`: codes and scales
    bit-identical (scale = max|block| * f32(1/127))."""
    x = _draw(np.random.default_rng(1), 1e-3)[key]
    want = ref.jax.jit(ref.A._quantize)(ref.jnp.asarray(x))
    got = TA._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    assert got.scale.numpy().tobytes() == np.asarray(want.scale).tobytes()


def test_adamw_init_structure_and_in_place_update():
    """Quantized moments where the leaf is quantizable (last dim a
    multiple of 128, at least 4096 values), f32 elsewhere; `update`
    writes the given tensors and drops each consumed grad leaf."""
    rng = np.random.default_rng(2)
    p = {k: torch.from_numpy(v) for k, v in _draw(rng, 0.02).items()}
    s = TA.init(p, TA.AdamWConfig(quantized_moments=True))
    assert isinstance(s.m["emb"], TA.QTensor)
    assert s.m["emb"].q.dtype == torch.int8
    assert s.m["emb"].scale.shape == (64, 2)
    assert s.m["norm"].dtype == torch.float32
    assert isinstance(s.m["odd"], torch.Tensor)
    ptr = {k: v.data_ptr() for k, v in p.items()}
    g = {k: torch.from_numpy(v) for k, v in _draw(rng, 1e-3).items()}
    p2, s2 = TA.update(g, s, p, TA.AdamWConfig(quantized_moments=True))
    assert p2 is p and all(p[k].data_ptr() == ptr[k] for k in p)
    assert all(v is None for v in g.values())
    assert s2.m is s.m and int(s2.count) == 1


# ---------------------------------------------------------------------------
# gradient and weight compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("npods", (2, 4))
@pytest.mark.parametrize("mode", ("int8", "int16"))
def test_compressed_psum_mean_bit_identical(ref, mode, npods):
    """Against `jax.jit(compressed_psum_mean)`: bit-identical (the shared
    scale is amax * f32(1/qeff), the jitted form)."""
    rng = np.random.default_rng(npods)
    g = {k: (rng.standard_normal((npods,) + s) * 1e-2).astype(np.float32)
         for k, s in SHAPES.items()}
    want = ref.jax.jit(lambda t: ref.G.compressed_psum_mean(t, mode, npods))(
        {k: ref.jnp.asarray(v) for k, v in g.items()})
    got = TG.compressed_psum_mean({k: torch.from_numpy(v)
                                   for k, v in g.items()}, mode, npods)
    for k in SHAPES:
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), k


@pytest.mark.parametrize("mode,bits", [("int16", 16), ("int8", 8)])
def test_psum_mean_error_bounded(mode, bits):
    """Within amax/(qmax//npods)/2 of the plain pod mean."""
    g = (np.random.default_rng(0).standard_normal((2, 64, 32))
         * 0.01).astype(np.float32)
    out = TG.compressed_psum_mean({"w": torch.from_numpy(g)}, mode, 2)["w"]
    scale = np.abs(g).max() / ((2 ** (bits - 1) - 1) // 2)
    assert np.abs(out.numpy() - g.mean(0)).max() <= scale / 2 + 1e-12


def test_psum_mean_none_exact_and_no_overflow():
    """'none' is the plain mean; all pods at +amax do not overflow the
    narrow int8 sum (rtol 0.05, as the reference's test states it)."""
    g = np.random.default_rng(1).standard_normal((2, 16)).astype(np.float32)
    out = TG.compressed_psum_mean(torch.from_numpy(g), "none", 2)
    np.testing.assert_allclose(out.numpy(), g.mean(0), rtol=1e-6)
    out = TG.compressed_psum_mean(torch.full((4, 128), 3.0), "int8", 4)
    np.testing.assert_allclose(out.numpy(), 3.0, rtol=0.05)


def test_quantize_tensor_helpers(ref):
    """`quantize_tensor`, `dequantize_tensor` and `error_bound_of` equal
    the reference's eager functions bit for bit."""
    g = (np.random.default_rng(3).standard_normal((32, 64)) * 0.1
         ).astype(np.float32)
    q, s = TG.quantize_tensor(torch.from_numpy(g), "int8")
    rq, rs = ref.G.quantize_tensor(ref.jnp.asarray(g), "int8")
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    assert TG.dequantize_tensor(q, s).numpy().tobytes() == \
        np.asarray(ref.G.dequantize_tensor(rq, rs)).tobytes()
    assert float(TG.error_bound_of(torch.from_numpy(g), "int16")) == \
        float(ref.G.error_bound_of(ref.jnp.asarray(g), "int16"))


def test_compress_for_gather_bit_identical(ref):
    """Against `jax.jit(compress_for_gather)` and `jax.jit(_qdq)`:
    bit-identical, norms and unaligned leaves passed through."""
    p = _draw(np.random.default_rng(4), 0.02)
    p["mlp_norm"] = np.ones((256,), np.float32) * 1.5
    want = ref.jax.jit(ref.W.compress_for_gather)(
        {k: ref.jnp.asarray(v) for k, v in p.items()})
    got = TW.compress_for_gather({k: torch.from_numpy(v)
                                  for k, v in p.items()})
    for k in p:
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), k
    assert torch.equal(got["mlp_norm"], torch.from_numpy(p["mlp_norm"]))
    assert torch.equal(got["odd"], torch.from_numpy(p["odd"]))
    x = p["emb"]
    assert TW._qdq(torch.from_numpy(x)).numpy().tobytes() == \
        np.asarray(ref.jax.jit(ref.W._qdq)(ref.jnp.asarray(x))).tobytes()


def test_qdq_error_bound_and_max_weight_error():
    """|x - qdq(x)| <= blockmax/127/2 per block (1.01 slack, as the
    reference's test); `max_weight_error` <= 1/254 plus one f32 ulp."""
    x = np.random.default_rng(0).standard_normal((16, 256)).astype(
        np.float32)
    y = TW._qdq(torch.from_numpy(x)).numpy()
    xb = x.reshape(16, 2, 128)
    bound = np.abs(xb).max(-1, keepdims=True) / 127.0 / 2 * 1.01 + 1e-12
    assert (np.abs(y.reshape(16, 2, 128) - xb) <= bound).all()
    worst = TW.max_weight_error({"w": torch.from_numpy(x),
                                 "pre_norm": torch.ones(128)})
    assert 0 < worst <= 1 / 254 + 2.0 ** -23


def test_ste_gradient_identity():
    """d loss / d master through `compress_for_gather` is the analytic
    grad at qdq(w) (rtol 1e-6): the identity through the quantizer."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((128, 128)).astype(
        np.float32)).requires_grad_()
    v = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    loss = torch.tanh(TW.compress_for_gather({"w_up": w})["w_up"] @ v).sum()
    (g,) = torch.autograd.grad(loss, [w])
    wq = TW._qdq(w.detach()).requires_grad_()
    (want,) = torch.autograd.grad(torch.tanh(wq @ v).sum(), [wq])
    np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# the train step, per TrainConfig branch
# ---------------------------------------------------------------------------

BRANCHES = {
    "none": dict(),
    "podded-none": dict(npods=2, podded=True),
    "int8-grad": dict(grad_compress="int8", npods=2, podded=True),
    "int8-weight": dict(weight_compress="int8"),
    "quantized-moments": dict(quantized_moments=True),
    "microbatches": dict(microbatches=2),
}


def _check_step_against_reference(ref, branch, device):
    """One step of `make_train_step` on `device` against the reference's
    jitted step on the same numpy inputs, f32 forward: the loss within
    1e-5 relative; the first moment after the step, (1-b1)·grad, within
    1e-4 of its max, plus one quantization step where a quantizer sits on
    the grads' path."""
    kw = dict(BRANCHES[branch])
    podded = kw.pop("podded", False)
    qm = kw.pop("quantized_moments", False)
    rcfg, tcfg, rp, _, toks, _, _ = _setup(ref, "qwen3-4b", batch=4,
                                           seq=16)
    tp = TM.params_from_numpy(_np(rp, ref), device=device)
    if podded:
        toks = toks.reshape(2, 2, 16)
    rt = ref.T.TrainConfig(adamw=ref.A.AdamWConfig(quantized_moments=qm),
                           **kw)
    tt = TT.TrainConfig(adamw=TA.AdamWConfig(quantized_moments=qm), **kw)
    with f32_forward(ref):
        rloss, _, ropt = ref.jax.jit(ref.T.make_train_step(rcfg, rt))(
            rp, ref.A.init(rp, rt.adamw), ref.jnp.asarray(toks))
        tloss, tp2, topt = TT.make_train_step(tcfg, tt)(
            tp, TA.init(tp, tt.adamw), torch.from_numpy(toks).to(device))
    assert tp2 is tp and int(topt.count) == 1
    assert all(t.device.type == torch.device(device).type
               for t in leaves((tp2, topt)))
    assert abs(float(tloss) - float(rloss)) <= 1e-5 * abs(float(rloss))
    grads_quantized = kw.get("grad_compress", "none") != "none" or qm
    got_m, want_m = leaves_up_to(tp, topt.m), leaves_up_to(tp, ropt.m)
    assert len(got_m) == len(want_m) == len(leaves(tp))
    for got, want in zip(got_m, want_m):
        a, b = _first_moment(got), _first_moment(want)
        tol = 1e-4 * float(np.abs(b).max()) + 1e-12
        if grads_quantized:
            # one quantization step of the grad (pod-mean scale) or of
            # the int8 moment (block scale)
            tol += float(np.abs(b).max()) / 63.0
        assert float(np.abs(a - b).max()) <= tol


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_train_step_matches_jitted_reference(ref, branch):
    """One step per `TrainConfig` branch on the CPU against the
    reference's jitted step: the loss within 1e-5 relative, the first
    moment (1-b1)·grad within 1e-4 of its max (plus one quantization step
    behind a quantizer)."""
    _check_step_against_reference(ref, branch, "cpu")


def test_int8_grads_with_int8_moments_diverge_as_the_reference(ref):
    """`train:compress`'s configuration (int8 pod-compressed grads over 2
    pods, int8 weight STE, 2 microbatches, int8 moments), 3 steps from
    the reference's initial state in both packages at d_model 128 (so the
    embedding's moments are quantized, as at full width), f32 forward:
    each step's loss within 1e-5 relative of the reference's jitted run,
    and both blow up at the third step (loss > 10x the second).  The
    mechanism: a grad that the pod-mean quantizer rounds to 0 leaves
    v = b2·v, and v's block quantizer had already rounded v to 0 where m
    kept a code, so the update is m / eps."""
    kw = dict(grad_compress="int8", npods=2, weight_compress="int8",
              microbatches=2)
    rcfg = dataclasses.replace(ref.configs.reduced("qwen3-4b", n_periods=1),
                               d_model=128, d_ff=256)
    tcfg = dataclasses.replace(tconfigs.reduced("qwen3-4b", n_periods=1),
                               d_model=128, d_ff=256)
    rt = ref.T.TrainConfig(adamw=ref.A.AdamWConfig(quantized_moments=True),
                           **kw)
    tt = TT.TrainConfig(adamw=TA.AdamWConfig(quantized_moments=True), **kw)
    rp = ref.M.init_params(ref.jax.random.PRNGKey(0), rcfg)
    ro = ref.A.init(rp, rt.adamw)
    tp = TM.params_from_numpy(_np(rp, ref), device="cpu")
    to = TA.opt_state_from_numpy(_np(ro, ref), device="cpu")
    assert isinstance(to.m["embed"], TA.QTensor)
    rstep = ref.jax.jit(ref.T.make_train_step(rcfg, rt))
    tstep = TT.make_train_step(tcfg, tt)
    got, want = [], []
    with f32_forward(ref):
        for s in range(3):
            toks = TP.host_batch(rcfg.vocab, 4, 64, s, 0).reshape(2, 2, 64)
            rl, rp, ro = rstep(rp, ro, ref.jnp.asarray(toks))
            tl, tp, to = tstep(tp, to, torch.from_numpy(toks))
            want.append(float(rl))
            got.append(float(tl))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for losses in (got, want):
        assert all(np.isfinite(losses)) and losses[2] > 10 * losses[1]


def _first_moment(m):
    if isinstance(m, TA.QTensor):
        return TA._dequantize(m, m.q.shape).cpu().numpy()
    if hasattr(m, "_fields"):                   # the reference's QTensor
        nb = m.q.shape[-1] // 128
        q = np.asarray(m.q, np.float32).reshape(m.q.shape[:-1] + (nb, 128))
        return (q * np.asarray(m.scale)[..., None]).reshape(m.q.shape)
    return m.cpu().numpy() if isinstance(m, torch.Tensor) else np.asarray(m)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_train_step_on_card_matches_jitted_reference(ref, cuda_dev, branch):
    """One step per `TrainConfig` branch on the card against the
    reference's jitted step on the CPU, on the same numpy inputs: the loss
    within 1e-5 relative, the first moment (1-b1)·grad within 1e-4 of its
    max (plus one quantization step behind a quantizer).  This holds the
    card's backward (checkpointed periods, chunked CE, the per-period
    unbind) to the reference's grads."""
    _check_step_against_reference(ref, branch, cuda_dev)


@pytest.mark.cuda
def test_compress_for_gather_on_card_bit_identical(cuda_dev):
    """`compress_for_gather` and the pod mean on the card equal the CPU's
    bit for bit."""
    p = {k: torch.from_numpy(v) for k, v in
         _draw(np.random.default_rng(5), 0.02).items()}
    cpu = TW.compress_for_gather(p)
    card = TW.compress_for_gather({k: v.to(cuda_dev) for k, v in p.items()})
    for k in p:
        assert torch.equal(card[k].cpu(), cpu[k]), k
    g = torch.from_numpy((np.random.default_rng(6).standard_normal(
        (2, 64, 256)) * 1e-2).astype(np.float32))
    assert torch.equal(TG.compressed_psum_mean(g.to(cuda_dev), "int8",
                                               2).cpu(),
                       TG.compressed_psum_mean(g, "int8", 2))
