"""Step builders (port of ``repro.launch.steps``): turn (arch config, run
config, mesh) into step functions whose every argument leaf is placed on
a torch ``DeviceMesh`` by its logical axes, for training, prefill and
decode.

The JAX package hands its builders' functions to ``jax.jit`` with
``in_shardings``; here a :class:`StepBundle` distributes each state,
batch, parameter and cache leaf as a DTensor with the placements its
logical axes resolve to under the run's rules (``make_rules``), then runs
the eager step on the DTensors under a :class:`ShardCtx`, where
``shard_act`` redistributes the activations.  Tensors the model makes
itself (positions, masks, zeros) count as replicated
(``implicit_replication``).  Sharding never changes what a step computes:
a sharded step gives its unsharded step's numbers, up to the order of
floating-point sums.

:meth:`StepBundle.lower` is the counterpart of the JAX bundles'
``.lower()`` (``jax.jit`` with the bundle's shardings, the state
donated): a runner that places its arguments outside the step and replays
the training or decode step on the mesh as one CUDA graph
(``launch.graphs.StepGraph``, ``launch.serve.DecodeGraph``), DTensor's
dispatch and the collectives captured with it.

:meth:`StepBundle.account` is the counterpart of ``.lower()``'s analyses
(XLA's cost and memory analyses): it runs the step once under
``launch.hlo_analysis.Accounting`` and returns one rank's FLOPs, bytes,
collectives, kernel launches and memory.  Given no arguments it runs on
the bundle's ``args_spec``, placed as DTensors of meta tensors (rank 0's
local shapes, nothing allocated), on any mesh, a shape-only one
(``launch.mesh.make_shape_mesh``) included; given real arguments it counts
a real step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig, InputShape, RunConfig
from repro_torch.core.split_parallel import (TrainState, init_prev_features,
                                             make_train_step, split_params)
from repro_torch.launch.graphs import StepGraph
from repro_torch.launch.serve import DecodeGraph
from repro_torch.models.model import build_model
from repro_torch.optim import get_optimizer
from repro_torch.sharding.rules import rules_for_strategy
from repro_torch.sharding.spec import (ShardCtx, axes_tree, axis_sizes,
                                       is_dtensor, map_axes, placements,
                                       to_pspec, use_shard_ctx, values_tree)
from repro_torch.tree import tree_map

LONG_CONTEXT_WINDOW = 8192  # sliding window used by full-attention archs
                            # for the long_500k shape

_SPLIT_CONCURRENT = ("split_concurrent", "split_server_sharded")


# ---------------------------------------------------------------------------
# Shape-aware rule adjustment
# ---------------------------------------------------------------------------


def resolve_decode_layout(cfg: ArchConfig, mesh, layout: str) -> str:
    """Resolve "auto" ONCE against the full-size config (reduced-depth
    runs must inherit the same concrete layout)."""
    if layout != "auto":
        return layout
    per_shard = cfg.param_count() * 2 / axis_sizes(mesh)["model"]
    return "replicated_batch" if per_shard > 2 * 2**30 else "batch_sharded"


def make_rules(strategy: str, mesh, shape: InputShape,
               global_batch: int | None = None,
               decode_layout: str = "batch_sharded",
               cfg: ArchConfig | None = None) -> dict:
    """Strategy rules specialised to the input shape, as the JAX
    package's ``make_rules``.

    * decode: query heads are replicated and the KV cache is sharded along
      its sequence dim over 'model' (plus 'data' too when the batch does
      not occupy the data axis) — the distributed flash-decode layout.
      ``decode_layout="replicated_batch"`` also replicates the batch over
      the data axes, so that weights sharded along their contraction dim
      (FSDP) stay resident; "auto" picks it when the bf16 weight bytes
      per model shard exceed 2 GiB.
    * any shape: drop 'batch' sharding when the global batch doesn't
      divide the data axes."""
    sizes = axis_sizes(mesh)
    names = tuple(sizes)
    rules = dict(rules_for_strategy(strategy, names))
    b = global_batch or shape.global_batch
    data_size = 1
    for a in ("pod", "data"):
        if a in sizes:
            data_size *= sizes[a]
    batch_shardable = b % data_size == 0
    if not batch_shardable:
        rules["batch"] = None
    if shape.kind == "decode":
        layout = decode_layout
        if layout == "auto":
            layout = "batch_sharded"
            if cfg is not None:
                per_shard = cfg.param_count() * 2 / sizes["model"]
                if per_shard > 2 * 2**30:
                    layout = "replicated_batch"
        rules["heads"] = None
        if layout == "replicated_batch":
            rules["batch"] = None
            batch_shardable = False
        kv = ("data", "model") if not batch_shardable else ("model",)
        kv = tuple(a for a in kv if a in names)
        rules["kv_seq"] = kv[0] if len(kv) == 1 else kv
    return rules


def arch_for_run(cfg: ArchConfig, shape: InputShape,
                 strategy: str) -> ArchConfig:
    """Apply run-level config surgery: untie heads for split strategies,
    sliding window for long-context decode on full-attention archs."""
    if strategy.startswith("split") and cfg.tie_embeddings:
        cfg = dataclasses.replace(cfg, tie_embeddings=False)
    if (shape.name == "long_500k" and not cfg.supports_long_context
            and not cfg.sliding_window):
        cfg = cfg.with_sliding_window(LONG_CONTEXT_WINDOW)
    return cfg


# ---------------------------------------------------------------------------
# Axes trees for states / batches / caches
# ---------------------------------------------------------------------------


def _shape_of(spec) -> tuple:
    """A leaf's shape: of a tensor, or of the port's ``(shape, dtype)``
    batch-spec entry."""
    shape = getattr(spec, "shape", None)
    return tuple(spec[0] if shape is None else shape)


def batch_axes(batch_spec: dict) -> dict:
    """Logical axes for a batch tree: leading dim "batch", rest unsharded."""
    return {k: ("batch",) + (None,) * (len(_shape_of(v)) - 1)
            for k, v in batch_spec.items()}


_CACHE_AXES_BY_KEY = {
    "k": ("layers", "batch", "kv_seq", "kv_heads", None),
    "v": ("layers", "batch", "kv_seq", "kv_heads", None),
    "pos": ("layers", "kv_seq"),
    "cross_k": ("layers", "batch", None, "kv_heads", None),
    "cross_v": ("layers", "batch", None, "kv_heads", None),
    "ssm": ("layers", None, "batch", "mamba", None),
    "conv": ("layers", None, "batch", None, "mamba"),
    "wkv": ("layers", "batch", "rwkv_head", None, None),
    "shift_tm": ("layers", "batch", None),
    "shift_cm": ("layers", "batch", None),
}


def cache_axes(cache_spec: dict) -> dict:
    """Logical axes for every decode-cache entry present in the tree."""
    return {k: _CACHE_AXES_BY_KEY[k] for k in cache_spec}


#: the cache a prefill makes, placed as the JAX prefill's compile places
#: it (its bundle gives no ``out_shardings``; XLA's propagation decides):
#: the batch over the batch axes and the rest replicated on the KV and
#: cross caches, so never their sequence over ``kv_seq``, not even where
#: the batch is replicated; the positions replicated; the Mamba states as
#: decode's, their inner dimension over ``mamba``.  The RWKV state is the
#: scan's own output and has no entry.
_PREFILL_CACHE_AXES_BY_KEY = {
    "k": ("layers", "batch", None, "kv_heads", None),
    "v": ("layers", "batch", None, "kv_heads", None),
    "pos": ("layers", None),
    "cross_k": ("layers", "batch", None, "kv_heads", None),
    "cross_v": ("layers", "batch", None, "kv_heads", None),
    "ssm": ("layers", None, "batch", "mamba", None),
    "conv": ("layers", None, "batch", None, "mamba"),
}


def prefill_cache_full(rules: dict, mesh) -> Callable:
    """The prefill's cache maker on ``mesh``, the ``full`` of the models'
    ``init_cache``: ``full(key, shape, fill, dtype, device)`` allocates
    this rank's shard alone of the leaf ``key``, filled with ``fill``, and
    returns it as a DTensor of the global ``shape`` placed by the leaf's
    prefill axes under ``rules``.  No rank makes the whole cache."""

    def full(key, shape, fill, dtype, device):
        pl = placements(to_pspec(_PREFILL_CACHE_AXES_BY_KEY[key], rules,
                                 mesh=mesh, shape=shape), mesh)
        return _from_shard(lambda local: torch.full(
            local, fill, dtype=dtype, device=device), shape, mesh, pl)

    return full


def opt_state_axes(opt_name: str, params_axes):
    """Optimizer-state axes tree mirroring the params' axes."""
    if opt_name == "adagrad":
        return {"acc": params_axes}
    if opt_name == "adamw":
        return {"m": params_axes, "v": params_axes, "t": ()}
    if opt_name == "sgd":
        return {}
    raise KeyError(opt_name)


def train_state_axes(api, opt_name: str, strategy: str,
                     batch_spec: dict) -> TrainState:
    """Logical-axes TrainState matching what ``init_state`` will build
    (the parameters' axes read from an init on the meta device)."""
    p_axes = axes_tree(api.init(None))
    if strategy in ("dp_full", "fsdp_tp"):
        return TrainState(
            params=p_axes, head={}, head_stale={},
            opt_state=opt_state_axes(opt_name, p_axes), head_opt_state={},
            prev_features=(), prev_labels=(), prev_mask=(), step=())
    backbone_axes, head_axes = split_params(p_axes)
    concurrent = strategy in _SPLIT_CONCURRENT
    feats = ("batch", None, None) if concurrent else ()
    lbl = ("batch", None) if concurrent else ()
    return TrainState(
        params=backbone_axes, head=head_axes, head_stale=head_axes,
        opt_state=opt_state_axes(opt_name, backbone_axes),
        head_opt_state=opt_state_axes(opt_name, head_axes),
        prev_features=feats, prev_labels=lbl, prev_mask=lbl, step=())


# ---------------------------------------------------------------------------
# Placing trees on the mesh
# ---------------------------------------------------------------------------


def _as_tree(x):
    """A TrainState as a dict of its fields (other trees as they are)."""
    return vars(x) if isinstance(x, TrainState) else x


def _from_tree(like, tree):
    return TrainState(**tree) if isinstance(like, TrainState) else tree


def placement_tree(axes, spec, rules: dict, mesh):
    """Placements for every leaf of ``spec`` (tensors, or ``(shape,
    dtype)`` batch-spec entries) from its logical ``axes`` under
    ``rules``; ``None`` for a 0-d leaf or an empty slot (left as given:
    the host step counter, adamw's count)."""

    def one(ax, leaf):
        if isinstance(leaf, torch.Tensor) or (
                isinstance(leaf, tuple) and len(leaf) == 2
                and isinstance(leaf[1], torch.dtype)):
            shape = _shape_of(leaf)
            if len(shape):
                return placements(to_pspec(ax, rules, mesh=mesh,
                                           shape=shape), mesh)
        return None

    return _from_tree(axes, map_axes(one, _as_tree(axes), _as_tree(spec)))


def _is_spec(x) -> bool:
    """A leaf that holds a shape and a dtype only: a ``(shape, dtype)``
    batch-spec entry or a meta tensor."""
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[1], torch.dtype)) or (
                isinstance(x, torch.Tensor) and x.is_meta
                and not is_dtensor(x))


def _from_shard(make, shape, mesh, pl):
    """A DTensor of the global ``shape`` with placements ``pl`` whose
    local shard is ``make(local_shape)``, at this rank's shape (an uneven
    split's included): nothing but the shard is allocated."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    stride, n = [], 1
    for size in reversed(shape):     # contiguous; a whole-shape tensor
                                     # made for its stride would count in
                                     # the dry-run's high-water mark
        stride.insert(0, n)
        n *= size
    return DTensor.from_local(make(local), mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _meta_leaf(x, mesh, pl):
    """A shape-only leaf as a meta tensor, or with placements ``pl`` a
    DTensor of meta tensors whose local shard has this rank's shape;
    nothing is allocated."""
    shape, dtype = ((tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
                    else (tuple(x[0]), x[1]))
    if pl is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    return _from_shard(lambda local: torch.empty(local, dtype=dtype,
                                                 device="meta"),
                       shape, mesh, pl)


def _place_leaf(x, mesh, pl):
    """One leaf on ``mesh`` with placements ``pl``: a plain tensor is
    distributed from this rank's copy (every rank holds the same whole
    tensor, made from the same seed), a DTensor redistributed when its
    placements differ, and a shape-only leaf (:func:`_is_spec`) made a
    meta DTensor (:func:`_meta_leaf`)."""
    if _is_spec(x):
        return _meta_leaf(x, mesh, pl)
    if pl is None:
        return x
    if is_dtensor(x):
        return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x.to(mesh.device_type), mesh, pl,
                             src_data_rank=None)


def place(tree, pls, mesh):
    """``tree`` with each tensor leaf placed by the matching entry of the
    placement tree ``pls`` (see :func:`placement_tree`)."""

    from torch.distributed.tensor import Placement

    def walk(x, pl):
        if isinstance(pl, dict):
            return {k: walk(x[k], pl[k]) for k in pl}
        if isinstance(pl, (list, tuple)) and not (
                pl and all(isinstance(q, Placement) for q in pl)):
            if not isinstance(x, (list, tuple)):
                return x                     # an empty slot's () or None
            return type(x)(walk(a, b) for a, b in zip(x, pl))
        return _place_leaf(x, mesh, pl)

    return _from_tree(tree, walk(_as_tree(tree), _as_tree(pls)))


# ---------------------------------------------------------------------------
# Bundles
# ---------------------------------------------------------------------------


@dataclass
class StepBundle:
    """Everything needed to run one step kind on a mesh.

    ``fn`` is the eager step on its arguments; ``args_spec`` holds
    example arguments (on the meta device: shapes and dtypes alone) and
    ``in_placements`` the placement tree of each.  Calling the bundle
    places its arguments (:meth:`place`) and runs ``fn`` eagerly under
    the run's :class:`ShardCtx` (:meth:`context`); :meth:`lower` makes
    its compiled runner; :meth:`account` runs it once under the
    accounting mode.  ``init`` (train) makes the initial state:
    ``init(generator=None, *, params=None, batch=None)``.  ``lowered``:
    the runner class :meth:`lower` makes (set by ``build_train_step``,
    ``build_prefill_step`` and ``build_decode_step``)."""

    fn: Callable
    args_spec: tuple
    in_placements: tuple
    rules: dict
    mesh: Any
    api: Any
    cfg: ArchConfig
    init: Optional[Callable] = None
    lowered: Optional[Callable] = None

    def place(self, *args) -> tuple:
        """Every tensor leaf of ``args`` as a DTensor placed by its spec."""
        return tuple(place(a, pl, self.mesh)
                     for a, pl in zip(args, self.in_placements))

    @contextlib.contextmanager
    def context(self):
        """The contexts the step runs under: the run's :class:`ShardCtx`,
        and ``implicit_replication`` (tensors the model makes itself count
        as replicated)."""
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with use_shard_ctx(ShardCtx(self.mesh, self.rules)), \
                implicit_replication():
            yield

    def _run(self, args, kw):
        with self.context():
            return self.fn(*args, **kw)

    def __call__(self, *args, **kw):
        return self._run(self.place(*args), kw)

    def lower(self):
        """The step compiled as the JAX bundles' ``.lower()`` compiles it
        (``jax.jit(fn, in_shardings=..., donate_argnums=(0,))`` under the
        bundle's mesh): a runner called as the bundle is, which places its
        arguments (:meth:`place`) outside the step and runs ``fn`` under
        :meth:`context`.

        * train: ``runner(state, batch) -> (state, metrics)`` through a
          ``launch.graphs.StepGraph`` of the placed state;
        * decode: ``runner(params, cache, token, index) -> (logits,
          cache)`` through a ``launch.serve.DecodeGraph``, the parameters
          and the cache placed once, the token and the index loaded at
          each call;
        * prefill: ``runner(params, batch, **kw)``, the parameters placed
          once and the step run eagerly (a one-shot prefill is not
          captured, as off the mesh).

        On ``cuda`` the first call of a train or decode runner runs the
        step eagerly on the capture stream; the step is captured as a
        CUDA graph (NCCL's collectives inside; ``thread_local`` capture
        errors, beside NCCL's watchdog thread) at the second call (train:
        the first call's new state becomes the buffers) or right after
        the first (decode, as ``DecodeGraph`` does off the mesh), and
        every later call is a replay; on the CPU every call runs eagerly
        on the same buffers.  A capture that fails raises: nothing falls
        back to the eager bundle call.  A call whose state (train) or
        parameters and cache (decode) are not the ones the runner handed
        back last starts a new graph from them.  The state (train) and the
        cache (decode) are donated, as JAX's ``donate_argnums=(0,)``
        donates the state: the runner's buffers are the placed arguments'
        own tensors (the caller's, where they came placed), which the
        steps then overwrite."""
        return self.lowered(self)

    def account(self, *args, **kw) -> dict:
        """Run the step once under ``launch.hlo_analysis.Accounting`` and
        return this rank's counts (``Accounting.counts``) with
        ``arg_bytes`` (the local shards of the placed arguments),
        ``out_bytes`` (the outputs' storage the step made), ``peak_bytes``
        (``arg_bytes`` plus the high-water mark of storage the step made)
        and ``launches`` ({kernel: launches, real or meta, in this run}).
        With no ``args`` the step runs on ``args_spec`` as meta DTensors,
        and nothing is computed or allocated.  The cyclic garbage
        collector is off during the step, so that what it frees does not
        depend on when it runs: storage that only a reference cycle holds
        counts as live to the end of the step."""
        from repro_torch.launch.hlo_analysis import Accounting
        placed = self.place(*(args or self.args_spec))
        acct = Accounting()
        arg_bytes = acct.pin(_locals(placed))
        before = kernel_launches()
        collecting = gc.isenabled()
        gc.disable()      # storage in a reference cycle lives to the end
        try:
            with acct:
                out = self._run(placed, kw)
        finally:
            if collecting:
                gc.enable()
        counts = acct.counts()
        after = kernel_launches()
        fresh = {}
        for t in _locals(out):
            key = t.untyped_storage()._cdata
            if key not in acct._pinned:
                fresh[key] = t.untyped_storage().nbytes()
        counts.update(arg_bytes=arg_bytes, out_bytes=sum(fresh.values()),
                      peak_bytes=arg_bytes + counts["temp_bytes"],
                      launches={k: after[k] - before[k] for k in after})
        return counts


class _LoweredTrain:
    """:meth:`StepBundle.lower` of a training bundle."""

    def __init__(self, bundle: StepBundle):
        self.bundle = bundle
        self.graph = None                # the StepGraph of the held state
        self._last = None                # the state it handed back last

    def __call__(self, state, batch):
        b = self.bundle
        if self.graph is None or state is not self._last:
            placed, = b.place(state)
            self.graph = StepGraph(lambda st, bt: b._run((st, bt), {}),
                                   placed)
        new, out = self.graph(place(batch, b.in_placements[1], b.mesh))
        self._last = new
        return new, out


class _LoweredDecode:
    """:meth:`StepBundle.lower` of a decode bundle."""

    def __init__(self, bundle: StepBundle):
        self.bundle = bundle
        self.graph = None                # the DecodeGraph of the held cache
        self._params = self._cache = None

    def __call__(self, params, cache, token, index):
        b = self.bundle
        if (self.graph is None or params is not self._params
                or cache is not self._cache):
            p, c, t = b.place(params, cache, token)
            self.graph = DecodeGraph(b.api, p, c, token.shape[0], token=t,
                                     context=b.context)
            self._params = params
        logits = self.graph.step(place(token, b.in_placements[2], b.mesh),
                                 index)
        self._cache = self.graph.new_cache()
        return logits, self._cache


class _LoweredPrefill:
    """:meth:`StepBundle.lower` of a prefill bundle: eager."""

    def __init__(self, bundle: StepBundle):
        self.bundle = bundle
        self._params = self._placed = None

    def __call__(self, params, batch, **kw):
        b = self.bundle
        if self._placed is None or params is not self._params:
            self._placed, = b.place(params)
            self._params = params
        return b._run((self._placed, place(batch, b.in_placements[1],
                                           b.mesh)), kw)


def _locals(x) -> list:
    """The tensors of a tree (dicts, lists, tuples, TrainStates), each
    DTensor as its local shard."""
    if isinstance(x, TrainState):
        x = vars(x)
    if isinstance(x, dict):
        return [t for v in x.values() for t in _locals(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _locals(v)]
    if isinstance(x, torch.Tensor):
        return [x.to_local() if is_dtensor(x) else x]
    return []


def kernel_launches() -> dict:
    """{kernel: launches on the card plus launches on the meta route} of
    every wrapper, summed over a kernel's wrappers."""
    from repro_torch.kernels.adagrad.ops import (adagrad_update,
                                                 adagrad_update_leaves)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.mamba.ops import mamba_scan
    from repro_torch.kernels.rwkv6.ops import wkv
    from repro_torch.kernels.server_step.ops import server_step_update
    wrappers = {"server_step": (server_step_update,),
                "adagrad": (adagrad_update, adagrad_update_leaves),
                "flash_attention": (flash_attention,), "rwkv6": (wkv,),
                "mamba": (mamba_scan,)}
    return {k: sum(w.launches + w.meta_launches for w in ws)
            for k, ws in wrappers.items()}


def _meta(shape_dtype) -> torch.Tensor:
    shape, dtype = shape_dtype
    return torch.zeros(shape, dtype=dtype, device="meta")


def _cast_float(tree, dtype):
    return tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                    and x.is_floating_point() else x, tree)


def _params_spec(api, dtype):
    return _cast_float(values_tree(api.init(None)), dtype)


def train_parts(cfg: ArchConfig, run: RunConfig, shape: InputShape, *,
                global_batch: int | None = None):
    """The model, state initialiser and step of a training run, on one
    device or (through :func:`build_train_step`) on a mesh: ``(api,
    init_all, step_fn)``.  ``init_all(generator=None, *, params=None,
    batch=None)`` makes the initial state, the feature buffers of a
    concurrent split strategy included (from ``batch``, or from
    ``shape``'s batch on the meta device).  The adagrad optimizer runs
    K2."""
    cfg = arch_for_run(cfg, shape, run.strategy)
    dtype = getattr(torch, run.compute_dtype)
    api = build_model(cfg, compute_dtype=dtype, remat=run.remat,
                      loss_chunks=run.loss_chunks)
    kw = {"use_kernel": True} if run.optimizer == "adagrad" else {}
    opt = get_optimizer(run.optimizer, run.learning_rate,
                        adagrad_beta=run.adagrad_beta,
                        weight_decay=run.weight_decay, **kw)
    init_state, step_fn = make_train_step(
        api, opt, strategy=run.strategy,
        head_sync_period=run.head_sync_period, grad_accum=run.grad_accum)

    def init_all(generator=None, *, params=None, batch=None):
        state = init_state(generator, params=params)
        if run.strategy in _SPLIT_CONCURRENT:
            if batch is None:
                batch = {k: _meta(v) for k, v in api.batch_spec(
                    shape, global_batch=global_batch).items()}
            state = init_prev_features(state, api, batch, dtype=dtype)
        return state

    return api, init_all, step_fn


def build_train_step(cfg: ArchConfig, run: RunConfig, shape: InputShape,
                     mesh, *, global_batch: int | None = None) -> StepBundle:
    """The training step on ``mesh``: ``bundle(state, batch) -> (state,
    metrics)``, :func:`train_parts`'s step with every state and batch leaf
    placed; K2 runs on each leaf's local shard."""
    api, init_all, step_fn = train_parts(cfg, run, shape,
                                         global_batch=global_batch)
    batch_spec = api.batch_spec(shape, global_batch=global_batch)
    rules = make_rules(run.strategy, mesh, shape, global_batch)
    state_spec = init_all()
    if run.param_dtype != "float32":
        state_spec = dataclasses.replace(state_spec, **{
            k: _cast_float(v, getattr(torch, run.param_dtype))
            for k, v in vars(state_spec).items()})
    st_axes = train_state_axes(api, run.optimizer, run.strategy, batch_spec)
    in_pl = (placement_tree(st_axes, state_spec, rules, mesh),
             placement_tree(batch_axes(batch_spec), batch_spec, rules, mesh))
    return StepBundle(step_fn, (state_spec, batch_spec), in_pl, rules, mesh,
                      api, api.cfg, init=init_all, lowered=_LoweredTrain)


def build_prefill_step(cfg: ArchConfig, run: RunConfig, shape: InputShape,
                       mesh, *, global_batch: int | None = None) -> StepBundle:
    """The prefill step on ``mesh``: ``bundle(params, batch, *,
    cache_len=None) -> (logits, cache)``; K3 runs on each rank's batch and
    head shard.  The cache comes back as the JAX prefill's compile places
    it (``_PREFILL_CACHE_AXES_BY_KEY``: the batch over ``data`` under
    ``fsdp_tp``), each rank having made and written its own shard alone
    (:func:`prefill_cache_full`); the decode step redistributes it once to
    its own layout (:meth:`StepBundle.place`)."""
    cfg = arch_for_run(cfg, shape, run.strategy)
    dtype = getattr(torch, run.compute_dtype)
    api = build_model(cfg, compute_dtype=dtype, remat=False)
    batch_spec = api.batch_spec(shape, global_batch=global_batch)
    rules = make_rules(run.strategy, mesh, shape, global_batch)
    params_spec = _params_spec(api, dtype)
    p_axes = axes_tree(api.init(None))
    in_pl = (placement_tree(p_axes, params_spec, rules, mesh),
             placement_tree(batch_axes(batch_spec), batch_spec, rules, mesh))

    full = prefill_cache_full(rules, mesh)

    def fn(params, batch, **kw):
        return api.prefill(params, batch, full=full, **kw)

    return StepBundle(fn, (params_spec, batch_spec), in_pl, rules, mesh,
                      api, cfg, lowered=_LoweredPrefill)


def build_decode_step(cfg: ArchConfig, run: RunConfig, shape: InputShape,
                      mesh, *, global_batch: int | None = None) -> StepBundle:
    """The one-token decode step on ``mesh``: ``bundle(params, cache,
    token, index) -> (logits, cache)``, the cache placed by the decode
    layout's rules (its sequence sharded over ``model``, or over
    ``("data", "model")`` with the batch replicated) and updated in place
    on each rank's shard."""
    cfg = arch_for_run(cfg, shape, run.strategy)
    dtype = getattr(torch, run.compute_dtype)
    api = build_model(cfg, compute_dtype=dtype, remat=False)
    b = global_batch or shape.global_batch
    rules = make_rules(run.strategy, mesh, shape, global_batch,
                       decode_layout=run.decode_layout, cfg=cfg)
    cache_spec = api.init_cache(b, shape.seq_len, device="meta")
    params_spec = _params_spec(api, dtype)
    p_axes = axes_tree(api.init(None))
    token_spec = ((b, 1), torch.int32)
    in_pl = (placement_tree(p_axes, params_spec, rules, mesh),
             placement_tree(cache_axes(cache_spec), cache_spec, rules, mesh),
             placement_tree(("batch", None), token_spec, rules, mesh),
             None)

    def fn(params, cache, token, index):
        return api.decode_step(params, cache, token, index)

    return StepBundle(fn, (params_spec, cache_spec, token_spec, 0), in_pl,
                      rules, mesh, api, cfg, lowered=_LoweredDecode)


def build_step(cfg: ArchConfig, run: RunConfig, shape: InputShape, mesh,
               **kw) -> StepBundle:
    """Dispatch to the train/prefill/decode builder by ``shape.kind``."""
    if shape.kind == "train":
        return build_train_step(cfg, run, shape, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, run, shape, mesh, **kw)
    if shape.kind == "decode":
        return build_decode_step(cfg, run, shape, mesh, **kw)
    raise ValueError(shape.kind)


__all__ = ["LONG_CONTEXT_WINDOW", "StepBundle", "arch_for_run", "batch_axes",
           "build_decode_step", "build_prefill_step", "build_step",
           "build_train_step", "cache_axes", "kernel_launches", "make_rules",
           "opt_state_axes", "place", "placement_tree", "prefill_cache_full",
           "resolve_decode_layout", "train_parts", "train_state_axes"]
