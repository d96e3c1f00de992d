"""The port's sharding resolution against the JAX package's, with no
process group: ``to_pspec`` and ``make_rules`` on fake meshes, every leaf
the step builders place, and ``placements`` onto DTensor ``Shard`` /
``Replicate``.

Every param, train-state, batch and cache leaf of all ten arch IDs at
full size (on the meta device in the port, through ``jax.eval_shape`` in
JAX) must carry the same logical axes and shape in both packages and
resolve to the same PartitionSpec, entry by entry, under every strategy
of ``AXIS_RULES`` and both decode layouts, on 16x16, 2x16x16 and 2x2
fake meshes (``tests/test_sharding_spec.py``'s ``FakeMesh``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
from hypothesis import given, settings, strategies as st
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_arch_config as jax_arch_config
from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
from repro.core import split_parallel as JSP
from repro.launch import steps as JS
from repro.models.model import build_model as jax_build_model
from repro.optim import get_optimizer as jax_get_optimizer
from repro.sharding.rules import AXIS_RULES as JAX_AXIS_RULES
from repro.sharding.rules import rules_for_strategy as jax_rules_for
from repro.sharding.spec import Param as JaxParam
from repro.sharding.spec import to_pspec as jax_to_pspec
from repro_torch.configs import ARCH_IDS, RunConfig, get_arch_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.core.split_parallel import TrainState
from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.sharding import (AXIS_RULES, PartitionSpec, placements,
                                  rules_for_strategy, spec_tree, to_pspec)
from repro_torch.sharding.spec import map_axes
from repro_torch.tree import tree_leaves


class FakeMesh:
    def __init__(self, sizes):
        self.shape = sizes
        self.axis_names = tuple(sizes)


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
          "2x2": FakeMesh({"data": 2, "model": 2})}
LAYOUTS = ("batch_sharded", "replicated_batch")
CONCURRENT = ("split_concurrent", "split_server_sharded")
TRAIN, DECODE = "train_4k", "decode_32k"


def _entries(spec) -> tuple:
    """A PartitionSpec's entries, a one-name tuple read as the name (a
    spelling JAX keeps and the port may too)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in tuple(spec))


# --- the leaves of each package ---------------------------------------------


def _collect(axes, spec) -> list:
    """[(axes, shape)] of each tensor leaf of ``spec`` (tensors, or the
    port's ``(shape, dtype)`` batch entries) under its logical ``axes``."""
    out = []

    def one(ax, leaf):
        if hasattr(leaf, "shape") or (isinstance(leaf, tuple)
                                      and len(leaf) == 2):
            out.append((tuple(ax), PS._shape_of(leaf)))

    map_axes(one, axes, spec)
    return out


@functools.lru_cache(maxsize=None)
def _port_leaves(arch: str, strategy: str) -> dict:
    """{kind: [(axes, shape)]} of every leaf the port's builders place:
    params, train state (``strategy``), batch and decode cache."""
    cfg = get_arch_config(arch)
    api = build_model(cfg)
    out = {"params": [(p.axes, tuple(p.value.shape))
                      for p in tree_leaves(api.init(None))]}
    train = INPUT_SHAPES[TRAIN]
    bundle = PS.build_train_step(cfg, RunConfig(arch=arch,
                                                strategy=strategy),
                                 train, MESHES["2x2"])
    bspec = bundle.api.batch_spec(train)
    st_axes = PS.train_state_axes(bundle.api, "adagrad", strategy, bspec)
    out["state"] = [x for f in dataclasses.fields(TrainState) for x in
                    _collect(getattr(st_axes, f.name),
                             getattr(bundle.args_spec[0], f.name))]
    out["batch"] = _collect(PS.batch_axes(bspec), bspec)
    dec = INPUT_SHAPES[DECODE]
    cache = api.init_cache(dec.global_batch, dec.seq_len, device="meta")
    out["cache"] = _collect(PS.cache_axes(cache), cache)
    return out


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


@functools.lru_cache(maxsize=None)
def _jax_leaves(arch: str, strategy: str) -> dict:
    """The same leaves in the JAX package: ``jax.eval_shape`` of its init,
    of its train state as its ``build_train_step`` makes it, and of its
    decode cache."""
    api = jax_build_model(jax_arch_config(arch))
    ptree = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    out = {"params": [(p.axes, tuple(p.value.shape)) for p in
                      jax.tree_util.tree_leaves(
                          ptree, is_leaf=lambda x: isinstance(x, JaxParam))]}
    train = JAX_SHAPES[TRAIN]
    tapi = jax_build_model(JS.arch_for_run(jax_arch_config(arch), train,
                                           strategy))
    init_state, _ = JSP.make_train_step(
        tapi, jax_get_optimizer("adagrad", 1e-2), strategy=strategy)
    bspec = tapi.batch_spec(train)

    def init_all():
        state = init_state(jax.random.PRNGKey(0))
        if strategy in CONCURRENT:
            state = JSP.init_prev_features(state, tapi, bspec,
                                           dtype=jnp.bfloat16)
        return state

    sds = jax.eval_shape(init_all)
    st_axes = JS.train_state_axes(tapi, "adagrad", strategy, bspec)
    out["state"] = []
    for f in dataclasses.fields(TrainState):
        axes = jax.tree_util.tree_leaves(getattr(st_axes, f.name),
                                         is_leaf=_is_axes)
        leaves = jax.tree_util.tree_leaves(getattr(sds, f.name))
        out["state"].extend((tuple(a), tuple(s.shape))
                            for a, s in zip(axes, leaves))
    out["batch"] = [(ax, tuple(bspec[k].shape)) for k, ax in
                    sorted(JS.batch_axes(bspec).items())]
    dec = JAX_SHAPES[DECODE]
    cache = jax.eval_shape(lambda: api.init_cache(dec.global_batch,
                                                  dec.seq_len))
    out["cache"] = [(ax, tuple(cache[k].shape)) for k, ax in
                    sorted(JS.cache_axes(cache).items())]
    return out


def _shape_kinds():
    """(name, port shape, JAX shape, decode layout or None)."""
    yield "train", INPUT_SHAPES[TRAIN], JAX_SHAPES[TRAIN], None
    yield "prefill", INPUT_SHAPES["prefill_32k"], \
        JAX_SHAPES["prefill_32k"], None
    for layout in LAYOUTS:
        yield (f"decode/{layout}", INPUT_SHAPES[DECODE], JAX_SHAPES[DECODE],
               layout)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_leaf_resolves_as_in_jax(arch):
    """For each strategy, mesh and step kind: the rules ``make_rules``
    gives equal JAX's, and every leaf's axes, shape and PartitionSpec
    equal JAX's, entry by entry; ``placements`` puts each sharded entry on
    its mesh axes as ``Shard(dim)``, in mesh order, and ``Replicate``
    elsewhere."""
    cfg, jcfg = get_arch_config(arch), jax_arch_config(arch)
    n = 0
    for strategy in AXIS_RULES:
        mine, theirs = _port_leaves(arch, strategy), _jax_leaves(arch,
                                                                 strategy)
        for kind in mine:
            assert mine[kind] == [(tuple(a), s) for a, s in theirs[kind]], \
                (strategy, kind)
        for mesh_name, mesh in MESHES.items():
            for kind, shape, jshape, layout in _shape_kinds():
                rules = PS.make_rules(strategy, mesh, shape,
                                      decode_layout=layout or "auto",
                                      cfg=cfg)
                jrules = JS.make_rules(strategy, mesh, jshape,
                                       decode_layout=layout or "auto",
                                       cfg=jcfg)
                assert {k: _entries((v,))[0] for k, v in rules.items()} \
                    == {k: _entries((v,))[0] for k, v in jrules.items()}, \
                    (strategy, mesh_name, kind)
                for leaf_kind, leaves in mine.items():
                    for ax, shp in leaves:
                        got = to_pspec(ax, rules, mesh=mesh, shape=shp)
                        want = jax_to_pspec(ax, jrules, mesh=mesh,
                                            shape=shp)
                        assert _entries(got) == _entries(want), \
                            (strategy, mesh_name, kind, leaf_kind, ax, shp)
                        _assert_placements(got, mesh, len(shp))
                        n += 1
    assert n > 1000


def _assert_placements(spec, mesh, ndim: int) -> None:
    names = list(mesh.shape)
    pl = placements(spec, mesh)
    assert len(pl) == len(names)
    for j, name in enumerate(names):
        dims = [d for d, e in enumerate(spec)
                if name in (e if isinstance(e, tuple) else (e,))]
        assert pl[j] == (Shard(dims[0]) if dims else Replicate())
        assert not dims or dims[0] < ndim


def test_resolve_decode_layout_matches_jax():
    for arch in ARCH_IDS:
        for mesh in MESHES.values():
            for layout in ("auto",) + LAYOUTS:
                assert PS.resolve_decode_layout(
                    get_arch_config(arch), mesh, layout) == \
                    JS.resolve_decode_layout(jax_arch_config(arch), mesh,
                                             layout)


# --- the property of tests/test_sharding_spec.py:24-48 ----------------------

LOGICAL = [None, "batch", "embed", "mlp", "heads", "kv_heads", "vocab",
           "expert", "layers", "seq", "mamba", "rwkv_head"]


@settings(max_examples=200, deadline=None)
@given(st.lists(st.sampled_from(LOGICAL), min_size=1, max_size=5),
       st.sampled_from(list(AXIS_RULES)),
       st.lists(st.sampled_from([1, 2, 8, 16, 48, 64, 128, 256, 151936]),
                min_size=1, max_size=5))
def test_to_pspec_never_produces_invalid_sharding(axes, strategy, dims):
    """For any logical axes, rule table and shape, on 16x16 and 2x16x16:
    no mesh axis is used twice, every sharded dim is divisible by its
    mesh-axis product, and the spec is the JAX package's."""
    axes = tuple(axes)
    dims = tuple((dims * 5)[: len(axes)])
    for mesh in (MESHES["16x16"], MESHES["2x16x16"]):
        rules = rules_for_strategy(strategy, mesh.axis_names)
        spec = to_pspec(axes, rules, mesh=mesh, shape=dims)
        assert isinstance(spec, PartitionSpec)
        used = []
        for dim, entry in zip(dims, tuple(spec)):
            if entry is None:
                continue
            flat = entry if isinstance(entry, tuple) else (entry,)
            n = 1
            for a in flat:
                assert a not in used, (spec, axes)
                used.append(a)
                n *= mesh.shape[a]
            assert dim % n == 0, (spec, axes, dims)
        assert _entries(spec) == _entries(jax_to_pspec(
            axes, jax_rules_for(strategy, mesh.axis_names), mesh=mesh,
            shape=dims))


def test_rule_tables_are_the_jax_packages():
    assert AXIS_RULES == JAX_AXIS_RULES
    assert rules_for_strategy("fsdp_tp", ("data", "model"))["batch"] == "data"
    assert rules_for_strategy("fsdp_tp", ("pod", "data", "model"))[
        "batch"] == ("pod", "data")
    with pytest.raises(KeyError):
        rules_for_strategy("nope", ("data",))


def test_spec_tree_and_placements_data_major():
    """``spec_tree`` maps an axes tree (tuples are leaves) to specs, or to
    placements with a mesh; a dimension over ("data", "model") is
    ``Shard`` on both, data first; another order is refused."""
    rules = {"kv_seq": ("data", "model"), "batch": None, "embed": "data"}
    axes = {"k": ("layers", "batch", "kv_seq"), "w": [("embed", None)]}
    specs = spec_tree(axes, rules)
    assert specs == {"k": PartitionSpec(None, None, ("data", "model")),
                     "w": [PartitionSpec("data", None)]}
    mesh = MESHES["2x2"]
    assert spec_tree(axes, rules, mesh) == {
        "k": (Shard(2), Shard(2)), "w": [(Shard(0), Replicate())]}
    with pytest.raises(ValueError):
        placements(PartitionSpec(("model", "data")), mesh)


def test_production_mesh_and_cardless_local_mesh_raise(tmp_path):
    """The 256- and 512-rank production meshes are shape-only meshes over a
    fake process group, refused in a process that holds a real one (a
    one-rank gloo group here; ``tests/test_torch_dryrun.py`` builds them
    in a process of their own); a mesh on ``cuda`` without a card raises
    rather than fall back to the CPU."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        for multi_pod in (False, True):
            with pytest.raises(RuntimeError, match="real 'gloo' one"):
                make_production_mesh(multi_pod=multi_pod)
    finally:
        dist.destroy_process_group()
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_local_mesh(1, 1)
