"""The port's tensor-parallel rules (``runtime/sharding.py``) against the
JAX package's ``param_specs`` / ``_fit_spec`` / ``cache_specs_tree`` on
meshes without devices (``abstract_mesh``): the same split dim for every
leaf of a toy tree and of the smoke Qwen2 tree, at model sizes 1, 2 and
4, replicate-when-not-divisible and the cache rule's relocation
included; the rank slices ``shard_tree`` takes; the mesh helpers. Pure:
no process group, no kernel.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.policy import ElasticSpec as JaxSpec  # noqa: E402
from repro.models import cache_init as jax_cache_init  # noqa: E402
from repro.models import model_init as jax_model_init  # noqa: E402
from repro.runtime import elastic as jax_elastic  # noqa: E402
from repro.runtime import sharding as JS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import ElasticSpec  # noqa: E402
from repro_torch.interop import layered_tree  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.models import cache_init, model_init  # noqa: E402
from repro_torch.runtime import elastic as T_elastic  # noqa: E402
from repro_torch.runtime import mesh as M  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402

MODEL_SIZES = (1, 2, 4)
ARCHS = ("toy-lm", "qwen2-7b")


def _norm(entry):
    """A spec entry in PartitionSpec's normal form."""
    if isinstance(entry, tuple):
        return entry[0] if len(entry) == 1 else (entry or None)
    return entry


def _flat_jax(specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {jax.tree_util.keystr(p): tuple(_norm(e) for e in s)
            for p, s in flat}


def _flat_port(tree, specs, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, specs[k], f"{prefix}['{k}']"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_port(v, specs[i], f"{prefix}[{i}]"))
        return out
    return {prefix: tuple(_norm(e) for e in specs)}


def _pair(arch):
    """The arch's smoke config in both packages (f32), the JAX params'
    shapes and the port's params in the JAX layout."""
    jcfg = dataclasses.replace(jax_get_config(arch, "smoke"),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config(arch, "smoke"), dtype="float32")
    jshapes = jax.eval_shape(
        lambda: jax_model_init(jax.random.PRNGKey(0), jcfg, JaxSpec()))
    tparams = model_init(torch.Generator().manual_seed(0), tcfg, None,
                         device="cpu")
    tlayered = layered_tree(tcfg, ElasticSpec(), {"p": tparams})["p"]
    return jcfg, tcfg, jshapes, tparams, tlayered


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


@pytest.mark.parametrize("m", MODEL_SIZES)
def test_param_specs_match_jax(pair, m):
    _, _, jshapes, _, tlayered = pair
    jmesh = JS.abstract_mesh((1, m), ("data", "model"))
    tmesh = M.abstract_mesh((1, m), ("data", "model"))
    want = _flat_jax(JS.param_specs(jshapes, jmesh))
    got = _flat_port(tlayered, SH.param_specs(tlayered, tmesh))
    assert got == want
    # without a mesh: the raw rule, unfitted
    assert _flat_port(tlayered, SH.param_specs(tlayered)) == \
        _flat_jax(JS.param_specs(jshapes))


@pytest.mark.parametrize("shape,spec,relocate", [
    ((28, 3584), ("model", None), False),
    ((4, 3584, 128), (None, "model", None), False),      # 4 kv-heads
    ((3, 64, 16), (None, "model", None), False),         # 3: replicated
    ((2, 1024, 3, 128), ("data", None, "model", None), True),   # relocated
    ((2, 1024, 3, 127), ("data", None, "model", None), True),
    ((6, 10), (("data", "model"), None), False),
])
@pytest.mark.parametrize("m", MODEL_SIZES)
def test_fit_spec_matches_jax(shape, spec, relocate, m):
    for d in (1, 2):
        jmesh = JS.abstract_mesh((d, m), ("data", "model"))
        tmesh = M.abstract_mesh((d, m), ("data", "model"))
        want = JS._fit_spec(P(*spec), shape, jmesh, relocate=relocate)
        got = SH._fit_spec(spec, shape, tmesh, relocate=relocate)
        assert tuple(_norm(e) for e in got) == tuple(_norm(e) for e in want)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("m", MODEL_SIZES)
def test_cache_specs_match_jax(kv_dtype, m):
    """The ring cache rule: kv-heads over ``model`` when they divide it
    (qwen2 smoke: 2 kv-heads), else head_dim; the scales' K axis."""
    jcfg = dataclasses.replace(jax_get_config("qwen2-7b", "smoke"),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("qwen2-7b", "smoke"),
                               dtype="float32")
    jmesh = JS.abstract_mesh((1, m), ("data", "model"))
    tmesh = M.abstract_mesh((1, m), ("data", "model"))
    jc = jax.eval_shape(lambda: jax_cache_init(jcfg, 2, 32,
                                               kv_dtype=kv_dtype))
    want = _flat_jax(JS.cache_specs_tree(jc, jcfg, jmesh))
    tc = cache_init(tcfg, 2, 32, device="cpu", kv_dtype=kv_dtype)
    tl = layered_tree(tcfg, None, {"c": tc})["c"]
    got = _flat_port(tl, SH.cache_specs_tree(tl, tcfg, tmesh))
    assert got == want
    assert tuple(SH.attn_kv_spec(tcfg, tmesh)) == tuple(
        _norm(e) for e in JS.attn_kv_spec(jcfg, jmesh))


@pytest.mark.parametrize("m", (2, 4))
def test_shard_tree_takes_each_ranks_slice(m):
    """Rank r's leaf is the r-th of m equal pieces along its split dim,
    and the pieces of all ranks rebuild the whole leaf; replicated leaves
    come back as they are."""
    _, tcfg, _, tparams, _ = _pair("qwen2-7b")
    specs = SH.param_specs(tparams, M.abstract_mesh((1, m),
                                                    ("data", "model")))
    shards = [SH.shard_params(tparams, M.Mesh({"data": 1, "model": m},
                                              rank=r))
              for r in range(m)]
    wq = tparams["layers"][0]["attn"]["wq"]
    assert shards[1]["layers"][0]["attn"]["wq"].shape == (
        tcfg.d_model, tcfg.n_heads // m, tcfg.d_head)
    for path in (("embed",), ("lm_head",), ("layers", 1, "mlp", "wo"),
                 ("layers", 0, "attn", "bq"), ("layers", 0, "norm1",
                                               "scale")):
        def get(t):
            for k in path:
                t = t[k]
            return t
        d = SH.split_dim(get(specs))
        parts = [get(s) for s in shards]
        whole = get(tparams)
        if d is None:
            assert all(p is whole for p in parts)
        else:
            assert torch.equal(torch.cat(parts, dim=d), whole)
    np.testing.assert_array_equal(
        shards[m - 1]["layers"][0]["attn"]["wq"].numpy(),
        wq[:, -tcfg.n_heads // m:].numpy())


def test_mesh_helpers():
    """Row-major rank coordinates, the axis sizes the rules read, the
    production shape the port states for H100s (two nodes as data=2,
    model=8), a leaf sliced over the data and the model axis and made
    whole again, and ``valid_mesh_shapes`` as JAX's."""
    mesh = M.Mesh({"data": 2, "model": 4}, rank=6)
    assert (mesh.coord("data"), mesh.model_rank, mesh.size) == (1, 2, 8)
    assert (mesh.data_rank, mesh.data_size, mesh.member) == (1, 2, True)
    assert not M.Mesh({"data": 1, "model": 4}, rank=6).member
    assert (SH.data_axis_size(mesh), SH.model_axis_size(mesh)) == (2, 4)
    assert SH.model_axis_size(None) == SH.data_axis_size(None) == 1
    assert LM.make_production_mesh() == ((2, 8), ("data", "model"))
    with pytest.raises(ValueError, match="backend"):
        LM.make_mesh((2, 2), ("data", "model"), backend="mpi", rank=0)
    with pytest.raises(ValueError, match="model axis must be the last"):
        LM.make_mesh((2, 2), ("model", "data"), backend="gloo", rank=0)
    x = torch.arange(64.0).reshape(4, 16)
    assert torch.equal(SH.shard_leaf(x, ("data", "model"), mesh),
                       x[2:4, 8:12])
    assert SH.shard_leaf(x, (), mesh) is x
    parts = [SH.shard_leaf(x, ("data", "model"), M.Mesh(mesh.shape, rank=r))
             for r in range(mesh.size)]
    assert torch.equal(SH.unshard_leaf(parts, ("data", "model"), mesh), x)
    assert M.active_mesh() is None
    with mesh:
        assert M.active_mesh() is mesh
    assert M.active_mesh() is None
    for n, m in ((8, 2), (16, 4), (6, 4), (12, 3), (1, 1)):
        assert T_elastic.valid_mesh_shapes(n, m) == \
            jax_elastic.valid_mesh_shapes(n, m)
