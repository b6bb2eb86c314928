"""PyTorch port, the sharding rules (``models/sharding.py``) against the
reference's (``repro/models/sharding.py``): for every assigned arch, both
production meshes (16x16, 2x16x16) and both modes, every parameter's spec
equals the reference's ``param_pspecs`` spec leaf for leaf through
``models/convert.py``'s names (the reference's leading ``None`` per stacked
layer axis dropped), and every cache tensor's at decode_32k equals
``cache_pspecs``'; the reference's own sharding tests, ported; and the
specs as DTensor placements.

The reference keeps three cache subtrees whose leaves carry a leading layer
axis out of its list of stacks (an encdec model's ``self`` and ``cross``,
a hybrid's ``shared_attn``), so its rules read that layer axis as the
batch; the port applies them past the layer axis.  There the port is held
to the reference's rules on the subtree filed under a stack name, and the
reference's own reading is checked to differ (ROADMAP Queue 3)."""
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType
from jax.sharding import PartitionSpec as P

from repro.configs.base import SHAPES
from repro.configs.registry import ASSIGNED
from repro.configs.registry import get_config as jax_config
from repro.models import sharding as JSH
from repro.models.registry import build_model as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.models import sharding as SH
from repro_torch.models.convert import STACKED
from repro_torch.models.registry import build_model

torch.set_num_threads(1)  # pytest -n: several processes share the cores

MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}
# reference cache subtrees stacked over layers under a name outside its
# stack list, and a stack name to file each under for its rules
UNLISTED = {"self": "layers", "cross": "dec", "shared_attn": "layers"}


def _jax_mesh(multi_pod):
    axes, shape = zip(*MESHES[multi_pod].items())
    return AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


@lru_cache(maxsize=None)
def _jax_params(arch):
    m = jax_build(jax_config(arch))
    return jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0)))


@lru_cache(maxsize=None)
def _meta_model(arch):
    return build_model(get_config(arch), device="meta")


def _params(arch):
    return dict(_meta_model(arch).named_parameters())


def _norm(spec, ndim):
    """A spec as one tuple of axis names per dim, padded to ndim."""
    out = [() if a is None else (a,) if isinstance(a, str) else tuple(a)
           for a in spec]
    return tuple(out + [()] * (ndim - len(out)))


def _axis_size(mesh, axes):
    return SH.mesh_axis_size(mesh, axes)


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("mode", ["train", "serve"])
def test_param_specs_equal_the_reference(arch, multi_pod, mode):
    shapes = _jax_params(arch)
    ref = JSH.param_pspecs(jax_config(arch), shapes, _jax_mesh(multi_pod),
                           mode=mode)
    params = _params(arch)
    port = SH.param_pspecs(get_config(arch), params, MESHES[multi_pod],
                           mode=mode)
    seen = set()
    flat = jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: isinstance(x, P))[0]
    leaves = {jax.tree_util.keystr(p): l for p, l in
              jax.tree_util.tree_flatten_with_path(shapes)[0]}
    for path, spec in flat:
        names = [k.key for k in path]
        leaf = leaves[jax.tree_util.keystr(path)]
        depth = STACKED.get(names[0], 0)
        want = _norm(spec, leaf.ndim)[depth:]
        rest = ".".join(names[1:])
        for idx in np.ndindex(*leaf.shape[:depth]):
            at = ".".join([names[0], *map(str, idx)]) if depth else names[0]
            name = f"{at}.{rest}" if rest else at
            assert _norm(port[name], params[name].dim()) == want, name
            seen.add(name)
    assert seen == set(port)


def _port_cache_specs(node, path=()):
    """(keys without list indices, spec) for every tensor of a port cache
    spec tree."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _port_cache_specs(v, path + (k,))
    elif isinstance(node, list):
        for v in node:
            yield from _port_cache_specs(v, path)
    elif isinstance(node, tuple):
        yield path, node


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
@pytest.mark.parametrize("multi_pod", [False, True])
def test_cache_specs_equal_the_reference(arch, multi_pod):
    shape = SHAPES["decode_32k"]
    B, S = shape.global_batch, shape.seq_len
    jm = jax_build(jax_config(arch))
    jcache = jax.eval_shape(lambda: jm.init_cache(B, S))
    mesh = _jax_mesh(multi_pod)
    filed = {UNLISTED.get(k, k): v for k, v in jcache.items()}
    ref = JSH.cache_pspecs(jax_config(arch), filed, mesh)
    cache = _meta_model(arch).init_cache(B, S)
    port = SH.cache_pspecs(get_config(arch), cache, MESHES[multi_pod])
    shapes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(filed)[0]:
        shapes[tuple(k.key for k in path)] = leaf
    refs = {tuple(k.key for k in p): s for p, s in
            jax.tree_util.tree_flatten_with_path(
                ref, is_leaf=lambda x: isinstance(x, P))[0]}
    n = 0
    for keys, spec in _port_cache_specs(port):
        rkeys = (UNLISTED.get(keys[0], keys[0]),) + keys[1:]
        leaf = shapes[rkeys]
        want = _norm(refs[rkeys], leaf.ndim)
        got = _norm(spec, len(spec))
        assert want[len(want) - len(got):] == got, (keys, spec, refs[rkeys])
        assert all(a == () for a in want[:len(want) - len(got)])
        n += 1
    assert n
    if set(jcache) & set(UNLISTED):
        # the reference's own reading of those subtrees differs
        own = JSH.cache_pspecs(jax_config(arch), jcache, mesh)
        key = next(k for k in jcache if k in UNLISTED)
        assert own[key]["k"] != ref[UNLISTED[key]]["k"]


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("mode", ["train", "serve"])
def test_param_specs_divisible(arch, multi_pod, mode):
    params = _params(arch)
    mesh = MESHES[multi_pod]
    specs = SH.param_pspecs(get_config(arch), params, mesh, mode=mode)
    assert set(specs) == set(params)
    for name, t in params.items():
        spec = specs[name]
        assert len(spec) == t.dim()
        for dim, axes in zip(t.shape, spec):
            assert dim % _axis_size(mesh, axes) == 0, (arch, name, spec)


@pytest.mark.parametrize("arch", ["nemotron-4-340b", "command-r-35b",
                                  "mixtral-8x7b", "deepseek-v2-lite-16b"])
def test_big_weights_are_sharded_in_train(arch):
    """No >1 GB parameter stays fully replicated under the train rules."""
    params = _params(arch)
    mesh = MESHES[False]
    specs = SH.param_pspecs(get_config(arch), params, mesh, mode="train")
    for name, t in params.items():
        if t.numel() * t.element_size() > 1e9:
            shards = int(np.prod([_axis_size(mesh, a) for a in specs[name]]))
            assert shards >= 16, (arch, name, specs[name])


def test_expert_parallel_when_divisible():
    """deepseek (E=64) shards experts over model; mixtral (E=8) falls back
    to tensor-parallel d_ff."""
    mesh = MESHES[False]
    ds = SH.param_pspecs(get_config("deepseek-v2-lite-16b"),
                         _params("deepseek-v2-lite-16b"), mesh)
    assert ds["layers.0.moe.wg"][0] == "model"          # [E, d, f] EP
    mx = SH.param_pspecs(get_config("mixtral-8x7b"), _params("mixtral-8x7b"),
                         mesh)
    assert mx["layers.0.moe.wg"][0] != "model"
    assert mx["layers.0.moe.wg"][2] == "model"          # TP over f


def test_mqa_kv_not_sharded_seq_cache_instead():
    """granite (kv=1): kv heads can't shard over model=16, so the cache
    rules shard the sequence dim instead (distributed flash-decode)."""
    cache = _meta_model("granite-20b").init_cache(128, 32768)
    specs = SH.cache_pspecs(get_config("granite-20b"), cache, MESHES[False])
    k_spec = specs["layers"][0]["k"]                     # [B, S, Hkv, hd]
    assert k_spec[1] == "model"                          # seq sharded
    assert k_spec[2] is None


def test_serve_mode_weight_gather_for_big_models():
    """340B can't replicate per data shard: the serve rules keep FSDP
    sharding; a 3B model stays replicated over data."""
    mesh = MESHES[False]
    specs = SH.param_pspecs(get_config("nemotron-4-340b"),
                            _params("nemotron-4-340b"), mesh, mode="serve")
    assert specs["layers.0.attn.wq"][0] is not None      # fsdp axis on
    small = SH.param_pspecs(get_config("llama3.2-3b"), _params("llama3.2-3b"),
                            mesh, mode="serve")
    assert small["layers.0.attn.wq"][0] is None          # replicated


def test_meta_build_costs_no_memory():
    """A full-size model and cache on the meta device hold no storage."""
    m = _meta_model("nemotron-4-340b")
    assert all(p.is_meta for p in m.parameters())
    assert sum(p.numel() for p in m.parameters()) > 3e11
    cache = m.init_cache(128, 32768)
    assert cache["layers"][0]["k"].is_meta


def test_placements_on_a_mesh():
    """Specs as DTensor placements: mesh dim i shards the tensor dim that
    names it; ("pod", "data") puts two mesh dims on one tensor dim, in mesh
    order; another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:                    # the two attributes placements reads
        mesh_dim_names = ("pod", "data", "model")
    mesh = Mesh()
    assert SH.placements((("pod", "data"), "model", None), mesh) == [
        Shard(0), Shard(0), Shard(1)]
    assert SH.placements((None, None), mesh) == [Replicate()] * 3
    assert SH.placements(("data", None), mesh) == [
        Replicate(), Shard(0), Replicate()]
    with pytest.raises(ValueError, match="mesh order"):
        SH.placements((("data", "pod"),), mesh)
    # the batch over (pod, data): the reference's batch_pspec
    assert SH.batch_pspec(MESHES[True]) == (("pod", "data"), None)
    assert SH.placements(SH.batch_pspec(MESHES[True]), mesh) == [
        Shard(0), Shard(0), Replicate()]


def test_mesh_size_must_match_the_world():
    """``launch/mesh.py``: the reference's shapes and axis names on the
    card by default; a mesh whose size is not the default group's world
    size raises, naming both (no process group is started here: the world
    is 1)."""
    import inspect

    import torch.distributed as dist

    from repro_torch.launch import mesh as LM
    for fn in (LM.make_production_mesh, LM.make_mesh_from_plan,
               LM.single_device_mesh):
        assert inspect.signature(fn).parameters[
            "device_type"].default == "cuda"
    with pytest.raises(ValueError, match=r"\(16, 16\) needs 256 .* has 1"):
        LM.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match=r"\(2, 16, 16\) needs 512"):
        LM.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(ValueError, match=r"\(2, 4\) needs 8"):
        LM.make_mesh_from_plan({"model": 4, "data": 2}, "cpu")
    assert not dist.is_initialized()
