"""The port's mesh rules against the reference's, in one process.

`dist.sharding.param_specs` / `_leaf_spec` give the reference's specs for
every arch's parameters and AdamW state (f32 and int8 moments), with and
without FSDP, on several mesh shapes (the reference reads only
``dict(mesh.shape)``, so both get a stand-in).  `dist.context`'s spec
resolution and scoping follow ``tests/test_dist_context.py``'s contract;
placements, `weight_gather_info`, `batch_spec` and the kernel entry's
refusal of a DTensor run on a one-rank gloo mesh.
"""
import types

import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import configs as tconfigs
from repro_torch.dist import context as tctx
from repro_torch.dist import sharding as TSH
from repro_torch.kernels import dispatch
from repro_torch.launch import mesh as LM
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA
from repro_torch.tree import leaves
from torch_spmd import reference_modules

MESH_SHAPES = ({"data": 2, "model": 4}, {"pod": 2, "data": 2, "model": 2},
               {"data": 8, "model": 1}, {"data": 4, "model": 16})


@pytest.fixture(scope="module")
def ref():
    yield from reference_modules(
        jax=("jax"), configs="repro.configs", M="repro.models.model",
        A="repro.optim.adamw", SH="repro.dist.sharding",
        ctx="repro.dist.context")


def _stand_in(shape):
    return types.SimpleNamespace(shape=dict(shape))


def _port_state(arch, quantized):
    cfg = tconfigs.reduced(arch, n_periods=2)
    params = TM.init_params(None, cfg, device="meta")
    return params, TA.init(params, TA.AdamWConfig(
        quantized_moments=quantized))


def _ref_state(ref, arch, quantized):
    cfg = ref.configs.reduced(arch, n_periods=2)
    params = ref.jax.eval_shape(
        lambda: ref.M.init_params(ref.jax.random.PRNGKey(0), cfg))
    opt = ref.jax.eval_shape(lambda p: ref.A.init(p, ref.A.AdamWConfig(
        quantized_moments=quantized)), params)
    return params, opt


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_param_specs_match_reference(ref, arch):
    """The port's specs are the reference's, except for int8 moments,
    which sit at `quantized_moment_spec` of their parameter's spec (a
    deliberate difference: see `sharding.quantized_moment_spec`)."""
    from jax.sharding import PartitionSpec
    from repro_torch.tree import leaves_with_path
    for quantized in (False, True):
        tstate = _port_state(arch, quantized)
        rstate = _ref_state(ref, arch, quantized)
        paths = [p for p, _ in leaves_with_path(tstate)]
        shapes = [tuple(t.shape) for t in leaves(tstate)]
        for shape in MESH_SHAPES:
            for fsdp in (False, True):
                got = leaves(TSH.param_specs(tstate, _stand_in(shape),
                                             fsdp=fsdp))
                want = [tuple(w) for w in ref.jax.tree.leaves(
                    ref.SH.param_specs(rstate, _stand_in(shape), fsdp=fsdp),
                    is_leaf=lambda x: isinstance(x, PartitionSpec))]
                assert len(got) == len(want)
                moved = 0
                for i, path in enumerate(paths):
                    if str(path[-1]) == ".q":
                        q = tuple(TSH.quantized_moment_spec(
                            TSH.P(*want[i]), shapes[i], shape))
                        moved += q != want[i]
                        want[i] = want[i + 1] = q       # q, then scale
                assert [tuple(g) for g in got] == want, \
                    (arch, quantized, shape, fsdp)
                assert quantized or not moved


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=str)
def test_resolve_spec_matches_reference(ref, shape):
    cases = [(("dp", None), (8, 4)), (("dp", "model"), (8, 16)),
             (("dp", "model"), (3, 5)), (("dp", None, "model"), (4,)),
             (("pod", ("pod", "data")), (4, 4)), ((("data", "model"),), (64,)),
             ((None, "model", None, "data"), (2, 8, 3, 8)), ((), (2, 2))]
    m = _stand_in(shape)
    for override in (None, ("data",)):
        for elems, shp in cases:
            def run(c):
                if override is None:
                    return tuple(c._resolve_spec(elems, shp, m))
                with c.dp_axes_override(override):
                    return tuple(c._resolve_spec(elems, shp, m))
            with ref.ctx.use_mesh(m), tctx.use_mesh(m):
                assert run(tctx) == run(ref.ctx), (elems, shp, override)


def test_leaf_spec_names_follow_reference(ref):
    """`_leaf_spec` keys on the nearest recognized trailing name: a QTensor
    moment's ``q``/``scale`` inherit their weight's rule."""
    mesh = {"data": 2, "model": 4}
    q = torch.empty((2, 64, 4, 16), device="meta")
    s = torch.empty((2, 64, 4, 1), device="meta")
    for path, leaf in ((("m", "layers", 0, "attn", "wq", ".q"), q),
                       (("m", "layers", 0, "attn", "wq", ".scale"), s),
                       (("layers", 0, "moe", "w_up"),
                        torch.empty((2, 8, 64, 32), device="meta")),
                       (("layers", 0, "moe", "shared", "w_up"),
                        torch.empty((2, 64, 32), device="meta")),
                       (("layers", 0, "pre_norm"),
                        torch.empty((2, 64), device="meta"))):
        for fsdp in (False, True):
            got = TSH._leaf_spec(path, leaf, mesh, fsdp)
            rpath = [types.SimpleNamespace(key=str(k).lstrip("."))
                     for k in path]
            want = ref.SH._leaf_spec(rpath, types.SimpleNamespace(
                shape=tuple(leaf.shape), size=leaf.numel()), mesh, fsdp)
            assert tuple(got) == tuple(want), (path, fsdp)


def test_context_nesting_and_exception_restores():
    m1, m2 = _stand_in({"data": 1}), _stand_in({"data": 1})
    assert tctx.current_mesh() is None
    with tctx.use_mesh(m1):
        assert tctx.current_mesh() is m1
        with pytest.raises(RuntimeError):
            with tctx.use_mesh(m2), tctx.use_param_specs({"w": TSH.P()}), \
                    tctx.use_weight_compress(True), \
                    tctx.use_a2a_compress(True), \
                    tctx.use_restore_compress(True):
                assert tctx.current_mesh() is m2
                assert tctx.a2a_codec() == "int8-block"
                assert tctx.restore_codec() == "int8-block"
                raise RuntimeError("boom")
        assert tctx.current_mesh() is m1
        assert tctx.current_param_specs() is None
        assert tctx.weight_gather_info() is None
        assert tctx.restore_codec() is None
    assert tctx.current_mesh() is None and not tctx.a2a_compress_active()


def test_restore_codec_validated_when_armed():
    with pytest.raises(ValueError, match="unknown compression codec"):
        with tctx.use_restore_compress("no-such-codec"):
            pass
    with pytest.raises(ValueError, match="blockwise"):
        with tctx.use_restore_compress("cusz"):
            pass


def test_constrain_is_identity_off_mesh():
    x = torch.ones(4, 8)
    assert tctx.constrain(x, "dp", "model") is x
    tree = {"w": x}
    assert tctx.constrain_like_params(tree) is tree


def test_batch_spec_and_dp_axes(ref):
    for shape in MESH_SHAPES:
        m = _stand_in(shape)
        for podded in (False, True):
            if podded and "pod" not in shape:
                continue
            assert tuple(TSH.batch_spec(m, podded)) == tuple(
                ref.SH.batch_spec(m, podded))
        assert TSH.dp_axes(m) == ref.SH.dp_axes(m)


def test_spec_placements():
    m = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert TSH.placements(TSH.P(("pod", "data"), None, "model"), m) == [
        Shard(0), Shard(0), Shard(2)]
    assert TSH.placements(TSH.P(None, "data"), m) == [
        Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="lacks"):
        TSH.placements(TSH.P("expert"), m)
    with pytest.raises(ValueError, match="order"):
        TSH.placements(TSH.P(("data", "pod")), m)


@pytest.fixture
def one_rank():
    """A one-rank gloo group (in-process store) and its (1, 1) host mesh,
    destroyed on exit."""
    with LM.process_group("cpu"):
        yield LM.make_host_mesh("cpu")


def test_host_mesh_and_weight_gather_info(one_rank, ref):
    mesh = one_rank
    assert TSH.mesh_shape(mesh) == {"data": 1, "model": 1}
    assert tctx.current_dp_axes() is None
    cfg = tconfigs.reduced("qwen2.5-3b", n_periods=1)
    params = TM.init_params(None, cfg, device="meta")
    specs = TSH.param_specs(params, mesh, fsdp=True)
    with tctx.use_mesh(mesh), tctx.use_param_specs(specs):
        assert tctx.current_dp_axes() == ("data",)
        with tctx.dp_axes_override(("data", "model")):
            assert tctx.current_dp_axes() == ("data", "model")
        assert tctx.weight_gather_info() is None      # hook not armed
        with tctx.use_weight_compress(True):
            specs_tuple, m = tctx.weight_gather_info()
    assert m is mesh and len(specs_tuple) == len(params["layers"])
    for layer, lspecs in zip(params["layers"], specs_tuple):
        full = leaves(TSH.param_specs(layer, mesh, fsdp=True))
        for leaf, spec, whole in zip(leaves(layer), leaves(lspecs), full):
            assert tuple(spec) == tuple(whole)[1:]
            assert len(spec) <= leaf.dim() - 1


def test_constrain_on_host_mesh(one_rank):
    mesh = one_rank
    x = TSH.NamedSharding(mesh, TSH.P()).place(torch.arange(12.).reshape(3, 4))
    with tctx.use_mesh(mesh):
        y = tctx.constrain(x, "dp", "model")
        assert isinstance(y, DTensor)
        assert list(y.placements) == [Shard(0), Shard(1)]
        z = tctx.constrain(y, "dp", None, "model")    # over-rank: replicate
        assert list(z.placements) == [Shard(0), Replicate()]
        assert torch.equal(z.full_tensor(), x.full_tensor())
        with pytest.raises(TypeError, match="DTensor"):
            tctx.constrain(torch.ones(2), "dp")


def test_kernel_entry_refuses_a_dtensor(one_rank):
    mesh = one_rank
    codes = TSH.NamedSharding(mesh, TSH.P("data")).place(
        torch.zeros(256, dtype=torch.int32))
    with pytest.raises(TypeError, match="DTensor"):
        dispatch.resolve("histogram", codes)
    assert dispatch.resolve("histogram", codes.to_local()) == "torch"
    from repro_torch.kernels.histogram import ops as H
    with pytest.raises(TypeError, match="full_tensor"):
        H.histogram(codes, 16)


def test_nccl_without_a_card_raises():
    """Asking for the card's backend without a card raises; nothing
    falls back to gloo quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a card"):
        LM.init_process_group("cuda")
    with pytest.raises(RuntimeError, match="needs a card"):
        LM.make_host_mesh("cuda")
    import torch.distributed as dist
    assert not dist.is_initialized()


@pytest.mark.cuda
def test_one_rank_nccl_mesh_on_card():
    """A one-rank NCCL mesh on the card: the int8 weight gather equals
    the mesh-less quantize-dequantize, the int8 pod mean over a
    ("pod", "data", "model") mesh equals the mesh-less form, and the
    kernel entry refuses a card DTensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import torch.distributed as dist

    from repro_torch.core import gradient as G
    from repro_torch.core import weights as W
    with LM.process_group("cuda"):
        assert dist.get_backend() == "nccl"
        mesh = LM.make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
        gen = torch.Generator("cuda").manual_seed(0)
        x = torch.randn(256, 512, device="cuda", generator=gen)
        sub = mesh["data", "model"]
        spec = TSH.P("data", "model")
        placed = TSH.NamedSharding(sub, spec).place(x)
        got = W.gather_dequant_tree({"w": placed}, {"w": spec}, sub)["w"]
        assert torch.equal(got.full_tensor(), W._qdq(x))
        with tctx.use_mesh(mesh):
            mean = G.pod_mean({"w": placed}, "int8", mesh)["w"]
        want = G.compressed_psum_mean({"w": x[None]}, "int8", 1)["w"]
        assert torch.equal(mean.full_tensor(), want)
        with pytest.raises(TypeError, match="DTensor"):
            dispatch.resolve("histogram", placed)


@pytest.mark.parametrize("quantized", (False, True))
def test_adamw_updates_placed_leaves_in_place(one_rank, quantized):
    """AdamW on DTensor params, grads and moments (f32 or int8 blocks)
    updates each rank's shard in place, bit for bit the mesh-less update;
    a restored (placed) step count is taken as its value."""
    mesh = one_rank
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(32, 256, generator=gen),
              "b": torch.randn(256, generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in
             params.items()}
    cfg = TA.AdamWConfig(lr=1e-2, quantized_moments=quantized)
    plain = {k: v.clone() for k, v in params.items()}
    popt = TA.init(plain, cfg)
    _, popt = TA.update({k: v.clone() for k, v in grads.items()}, popt,
                        plain, cfg)

    specs = {"w": TSH.P("data", "model"), "b": TSH.P()}
    shard = {k: TSH.NamedSharding(mesh, s) for k, s in specs.items()}
    placed = {k: shard[k].place(v.clone()) for k, v in params.items()}
    opt = TA.init(placed, cfg)
    opt = opt._replace(count=TSH.NamedSharding(mesh, TSH.P()).place(
        opt.count))
    local_w = placed["w"].to_local()
    _, opt = TA.update({k: shard[k].place(v.clone())
                        for k, v in grads.items()}, opt, placed, cfg)
    assert placed["w"].to_local().data_ptr() == local_w.data_ptr()
    for k in params:
        assert torch.equal(placed[k].full_tensor(), plain[k])
    got, want = leaves((opt.m, opt.v)), leaves((popt.m, popt.v))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, DTensor) and torch.equal(g.full_tensor(), w)
    assert int(opt.count) == int(popt.count) == 1
