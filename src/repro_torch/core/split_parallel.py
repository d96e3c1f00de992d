"""The paper's distributed deep-learning algorithm (§4.1) as training
strategies, and the baselines it is compared against (port of
``repro.core.split_parallel``).

  * ``dp_full``          — MLitB (Meeds et al. 2014): synchronous data
                           parallelism; every parameter's gradient crosses
                           the data axis every step.
  * ``split_sequential`` — He et al. 2015: backbone data-parallel, head
                           ("FC") on the server, *synchronous*: head trains
                           on current features, backbone waits.
  * ``split_concurrent`` — the paper: backbone data-parallel on "clients",
                           head trained on the "server" **concurrently** —
                           the head updates from the *previous* step's
                           features while the backbone's backward pass uses
                           a *stale* head copy refreshed every K steps.
  * ``fsdp_tp``, ``split_server_sharded`` — the JAX package's sharded
                           mappings of ``dp_full`` and ``split_concurrent``:
                           only their sharding rules differ, so here they
                           take those steps (on a mesh, the step builders
                           of ``launch/steps.py`` place them by the
                           rules).

The JAX package runs a step under one ``jit``, where XLA may overlap the
server's head update with the clients' backward pass.  Here a step runs
on one stream: the clients' half, then the server's
(:func:`server_head_update`), in sequence; ``launch.graphs.StepGraph``
replays it as one CUDA graph on the card.

Gradients come from ``torch.autograd.grad`` over detached copies of the
leaves that require grad; every optimizer update runs under
``torch.no_grad()`` on detached tensors, so no step's graph outlives it.
``TrainState.step`` is a 0-d int32 tensor on the params' device, as the
JAX package keeps it, and the step reads it only through tensor ops: the
step-0 head rule and the stale-head refresh are ``torch.where`` selects,
as the JAX step's ``jnp.where``, so no value goes to the host and a
captured step is right at every step.

Also here: the round drivers' shared client-lifetime ownership,
throughput-proportional shard sizing, the work-weighted gradient mean and
the dispatcher that runs a step's backbone shards as tickets.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import torch

from repro_torch.models.model import ModelApi, lm_loss
from repro_torch.optim import Optimizer
from repro_torch.sharding.spec import values_tree
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

HEAD_KEYS = ("head",)  # server-owned subtree(s) of the param tree


def split_params(params: dict):
    """Partition a param tree into (backbone, head) by top-level key."""
    backbone = {k: v for k, v in params.items() if k not in HEAD_KEYS}
    head = {k: v for k, v in params.items() if k in HEAD_KEYS}
    return backbone, head


def merge_params(backbone: dict, head: dict) -> dict:
    """Inverse of :func:`split_params`."""
    return {**backbone, **head}


@dataclass
class TrainState:
    """Train state with the JAX package's field list
    (``core/split_parallel.py:54-66``), so round checkpoints move between
    the packages; split_concurrent uses the head/stale-head/prev-feature
    slots, the others leave them empty."""

    params: Any                 # backbone params (clients)
    head: Any                   # server head params
    head_stale: Any             # client-side stale head copy (split_concurrent)
    opt_state: Any              # backbone optimizer state
    head_opt_state: Any         # head optimizer state
    prev_features: Any          # features from step t-1 (split_concurrent)
    prev_labels: Any
    prev_mask: Any
    step: Any                   # scalar int32


def _text_logits(api: ModelApi, logits):
    if api.cfg.family == "vlm":
        return logits[:, api.cfg.num_patches:]
    return logits


def _head_loss(api: ModelApi, head_params, full_params_wo_head, feats,
               labels, mask):
    """Server-side loss: head logits from (detached) features."""
    params = merge_params(full_params_wo_head, head_params)
    logits = _text_logits(api, api.head_logits(params, feats))
    return lm_loss(logits, labels, mask)


def _value_and_grad(loss_fn, *trees):
    """``loss_fn(*trees) -> (loss, aux)``.  Returns ``(loss, aux, grads)``:
    loss and aux detached, and one gradient tree per tree, of a copy of
    each leaf that requires grad (zeros where the loss does not reach a
    leaf, as ``jax.grad`` gives)."""
    flat = [tree_flatten(t) for t in trees]
    leaves = [[x.detach().requires_grad_(True) for x in ls]
              for ls, _ in flat]
    every = [x for ls in leaves for x in ls]
    with torch.enable_grad():
        loss, aux = loss_fn(*(tdef.unflatten(ls)
                              for ls, (_, tdef) in zip(leaves, flat)))
        grads = (torch.autograd.grad(loss, every, allow_unused=True)
                 if every else ())
    grads = [torch.zeros_like(x) if g is None else g.contiguous()
             for x, g in zip(every, grads)]
    out = []
    for ls, (_, tdef) in zip(leaves, flat):
        out.append(tdef.unflatten(grads[:len(ls)]))
        grads = grads[len(ls):]
    return loss.detach(), tree_map(torch.Tensor.detach, aux), out


def _split_micro(batch, k: int) -> list:
    """A (B, ...) batch as k microbatches of B/k rows, in order."""
    rows = tree_leaves(batch)[0].shape[0]
    if rows % k:
        raise ValueError(f"batch of {rows} rows does not split into {k} "
                         f"microbatches")
    m = rows // k
    return [tree_map(lambda x, i=i: x[i * m:(i + 1) * m], batch)
            for i in range(k)]


def _accum(grad_fn, batch, k: int):
    """Gradient accumulation: ``grad_fn`` over k microbatches in order,
    the outputs summed and divided by k.  Peak activation memory drops
    ~k-fold (one microbatch's forward and backward is live at a time)."""
    tot = None
    for mb in _split_micro(batch, k):
        out = grad_fn(mb)
        tot = out if tot is None else tree_map(torch.add, tot, out)
    return tree_map(lambda x: x / k, tot)


def _device_of(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def _step_of(state) -> torch.Tensor:
    """``state.step`` as a 0-d int32 tensor on the params' device (a round
    checkpoint loads it as a host tensor; a step already there is
    returned as it is)."""
    return torch.as_tensor(state.step, dtype=torch.int32,
                           device=_device_of(state.params))


def _new_step(state):
    """``state.step + 1`` on the params' device (JAX ``:272``)."""
    return _step_of(state) + 1


def server_head_update(api: ModelApi, opt: Optimizer, state: TrainState):
    """The server's half of a ``split_concurrent`` step: the head's
    gradient from the PREVIOUS step's detached features, merged with the
    pre-update backbone (``state.params``), then the head's optimizer
    update.  Returns ``(head, head_opt_state)``.

    The gradient is computed every step and selected by ``state.step >
    0`` (JAX ``:247-260``): at step 0 there are no features yet
    (``init_prev_features``' zeros, mask 0) and the select gives zeros,
    whatever was computed; the update still runs, as in the JAX package
    (with weight decay > 0 the head moves)."""
    _, _, (g_head,) = _value_and_grad(
        lambda head: (_head_loss(api, head, state.params,
                                 state.prev_features, state.prev_labels,
                                 state.prev_mask), None), state.head)
    have_prev = _step_of(state) > 0
    g_head = tree_map(lambda g: torch.where(have_prev, g, torch.zeros_like(g)),
                      g_head)
    with torch.no_grad():
        return opt.update(g_head, state.head_opt_state, state.head)


def make_train_step(api: ModelApi, opt: Optimizer, *, strategy: str,
                    head_sync_period: int = 4,
                    grad_accum: int = 1) -> tuple[Callable, Callable]:
    """Returns (init_state, step_fn).

    ``init_state(generator=None, *, params=None)`` makes the state from
    ``api.init(generator)``, or from a values tree already made
    (``params``, e.g. ``params_from_numpy``'s), on that tree's device.
    ``step_fn(state, batch) -> (state, metrics)``; batch is
    {"tokens","labels","mask"} on the params' device.  ``grad_accum`` > 1
    splits the global batch into microbatches and accumulates gradients
    (the same math for mean losses; ~k-fold lower activation memory).

    ``state.step`` is a 0-d int32 tensor on the params' device.  Updates
    are functional: the optimizers return new tensors and nothing writes
    a state's tensor in place, so a step may read the pre-update backbone
    after its update ran.  A ``split_concurrent`` step hands back a
    ``head_stale`` of its own (``torch.where`` of the new head and the
    old stale copy: bitwise the new head after a refresh, the old copy
    otherwise); ``split_sequential`` hands back its new head as both
    ``head`` and ``head_stale``, and ``split_concurrent`` the batch's
    labels and mask as ``prev_labels``/``prev_mask``, so a caller that
    keeps a step's state in buffers of its own (``launch.graphs.
    StepGraph``) copies each leaf into its buffer."""
    cfg = api.cfg

    def params_of(generator, params):
        return params if params is not None else values_tree(
            api.init(generator))

    def zero_step(params):
        return torch.zeros((), dtype=torch.int32, device=_device_of(params))

    if strategy in ("dp_full", "fsdp_tp"):

        def init_state(generator=None, *, params=None):
            params = params_of(generator, params)
            return TrainState(params=params, head={}, head_stale={},
                              opt_state=opt.init(params), head_opt_state={},
                              prev_features=(), prev_labels=(),
                              prev_mask=(), step=zero_step(params))

        def step_fn(state: TrainState, batch):
            def grad_fn(mb):
                loss, metrics, (grads,) = _value_and_grad(
                    lambda params: api.train_loss(params, mb), state.params)
                return {"loss": loss, "metrics": metrics, "grads": grads}

            out = (_accum(grad_fn, batch, grad_accum) if grad_accum > 1
                   else grad_fn(batch))
            with torch.no_grad():
                new_params, new_opt = opt.update(out["grads"],
                                                 state.opt_state,
                                                 state.params)
            return TrainState(new_params, {}, {}, new_opt, {}, (), (), (),
                              _new_step(state)), \
                {**out["metrics"], "total": out["loss"]}

        return init_state, step_fn

    if strategy not in ("split_sequential", "split_concurrent",
                        "split_server_sharded"):
        raise KeyError(strategy)

    def init_state(generator=None, *, params=None):
        params = params_of(generator, params)
        backbone, head = split_params(params)
        if not tree_leaves(head):
            raise ValueError(
                f"{cfg.name}: split strategies need an untied head; "
                "build the model with tie_embeddings=False "
                "(configs are auto-untied by the launcher for split runs)")
        # head_stale starts as a buffer of its own, as the JAX package's
        stale = tree_map(torch.clone, head)
        return TrainState(
            params=backbone, head=head, head_stale=stale,
            opt_state=opt.init(backbone), head_opt_state=opt.init(head),
            prev_features=(), prev_labels=(), prev_mask=(),
            step=zero_step(params))

    if strategy == "split_sequential":
        # He et al.: exact gradients, hard dependency between server and
        # clients (head grads from *current* features; backbone backward
        # through the *current* head).
        def step_fn(state: TrainState, batch):
            loss, metrics, (g_backbone, g_head) = _value_and_grad(
                lambda backbone, head: api.train_loss(
                    merge_params(backbone, head), batch),
                state.params, state.head)
            with torch.no_grad():
                new_backbone, new_opt = opt.update(
                    g_backbone, state.opt_state, state.params)
                new_head, new_hopt = opt.update(g_head, state.head_opt_state,
                                                state.head)
            return TrainState(new_backbone, new_head, new_head, new_opt,
                              new_hopt, (), (), (), _new_step(state)), \
                {**metrics, "total": loss}

        return init_state, step_fn

    # --- split_concurrent: the paper's algorithm -----------------------------

    def step_fn(state: TrainState, batch):
        # ---- clients: backbone fwd/bwd through the STALE head ------------
        def grad_fn(mb):
            def client_loss(backbone):
                params = merge_params(backbone, state.head_stale)
                logits, aux, feats = api.forward_features(
                    params, mb, differentiable=True)
                loss = lm_loss(_text_logits(api, logits), mb["labels"],
                               mb["mask"])
                # features are what the server trains on NEXT step
                return loss + aux, ({"loss": loss, "aux": aux}, feats)

            loss, (metrics, feats), (g,) = _value_and_grad(client_loss,
                                                           state.params)
            return {"loss": loss, "metrics": metrics, "grads": g,
                    "feats": feats}

        if grad_accum > 1:
            # microbatched: mean grads; feature replay keeps the per-token
            # layout by re-assembling microbatch features along batch
            feats_parts = []

            def keep_feats(mb):
                out = grad_fn(mb)
                feats_parts.append(out.pop("feats"))
                return out

            out = _accum(keep_feats, batch, grad_accum)
            feats = torch.cat(feats_parts, dim=0)
        else:
            out = grad_fn(batch)
            feats = out["feats"]
        with torch.no_grad():
            new_backbone, new_opt = opt.update(out["grads"], state.opt_state,
                                               state.params)

        # ---- server: head trains on PREVIOUS step's features -------------
        new_head, new_hopt = server_head_update(api, opt, state)

        # ---- stale-head refresh every K steps (JAX :265-268) ---------------
        do_sync = (_step_of(state) + 1) % head_sync_period == 0
        new_stale = tree_map(
            lambda fresh, stale: torch.where(do_sync, fresh, stale),
            new_head, state.head_stale)

        return TrainState(
            new_backbone, new_head, new_stale, new_opt, new_hopt,
            feats, batch["labels"], batch["mask"], _new_step(state)), \
            {**out["metrics"], "total": out["loss"]}

    return init_state, step_fn


def adaptive_shard_sizes(rates: dict, global_batch: int, *,
                         min_shard: int = 1) -> dict:
    """Split ``global_batch`` rows across clients proportional to measured
    throughput (EWMA work-units/s from ``TicketQueue.stats``).

    Clients with ``None`` rate (never observed) share the mean of the known
    rates so newcomers aren't starved.  Integer apportionment uses the
    largest-remainder method; every client gets at least ``min_shard`` rows
    (dropping to 0 would stop us ever re-measuring a slow client).

    >>> adaptive_shard_sizes({"fast": 30.0, "slow": 10.0}, 8)
    {'fast': 6, 'slow': 2}
    """
    if not rates:
        return {}
    known = [r for r in rates.values() if r]
    fallback = (sum(known) / len(known)) if known else 1.0
    eff = {c: (r if r else fallback) for c, r in rates.items()}
    total = sum(eff.values())
    raw = {c: global_batch * r / total for c, r in eff.items()}
    # largest-remainder apportionment (sums to global_batch exactly)
    sizes = {c: int(raw[c]) for c in raw}
    by_remainder = sorted(raw, key=lambda c: raw[c] - int(raw[c]),
                          reverse=True)
    i = 0
    while sum(sizes.values()) < global_batch:
        sizes[by_remainder[i % len(by_remainder)]] += 1
        i += 1
    # enforce the floor only when it's satisfiable (global_batch may be
    # smaller than len(rates) * min_shard), stealing from the largest
    if min_shard * len(sizes) <= global_batch:
        for c in sizes:
            while sizes[c] < min_shard:
                donor = max(sizes, key=lambda d: (sizes[d], eff[d]))
                if sizes[donor] <= min_shard:
                    break
                sizes[donor] -= 1
                sizes[c] += 1
    return sizes


def weighted_grad_mean(shard_grads, shard_sizes) -> Any:
    """Work-weighted mean of per-shard gradient trees — the exact
    combination rule for unevenly sized data-parallel shards.  Each leaf
    is reduced in one pass over all the shards' trees."""
    total = float(sum(shard_sizes))
    weights = [w / total for w in shard_sizes]

    def fuse(*leaves):
        acc = leaves[0] * weights[0]
        for g, w in zip(leaves[1:], weights[1:]):
            acc = acc + g * w
        return acc

    return tree_map(fuse, *shard_grads)


class RoundDriverLifetime:
    """Explicit client-lifetime ownership shared by the round drivers.

    A round driver needs the distributor's clients to survive drained
    queues between rounds, so constructing one flips ``keep_alive`` on —
    but the caller's original mode must come back when the driver is
    done, or a discarded driver leaves the distributor permanently
    changed.  :meth:`aclose` (or the async context manager) restores it."""

    def _own_clients(self, distributor):
        self.dist = distributor
        self._prev_keep_alive = distributor.keep_alive
        distributor.keep_alive = True
        self._closed = False

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    def _notify(self):
        """Wake the whole fabric (federation) or this distributor's
        parked waiters."""
        notify = getattr(self.dist, "_notify_all", None)
        (notify or self.dist._notify_waiters)()

    async def aclose(self, *, shutdown: bool = False):
        """End this driver's ownership of the client lifetime: restore
        the distributor's original ``keep_alive`` (parked clients wake,
        re-check the now-restored terminal condition, and exit once the
        queue drains), optionally shutting the distributor down outright.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.dist.keep_alive = self._prev_keep_alive
        if shutdown:
            await self.dist.shutdown()
        else:
            self._notify()


class SplitConcurrentDispatcher(RoundDriverLifetime):
    """Bridge from §4.1 split training to the Distributor v2 scheduler.

    Each training step, the backbone's data-parallel shards become a batch
    of tickets on an :class:`repro_torch.core.distributor.AsyncDistributor`;
    the simulated browser clients lease them (adaptively sized batches),
    run the shard work function, and the dispatcher aggregates the results
    — a work-weighted mean, which is exactly the gradient combination rule
    for unevenly sized data-parallel shards.

    The server-side head update (:func:`server_head_update`, which never
    crosses the data axis) runs on the caller's thread, so the ticket
    round only covers backbone traffic.
    """

    def __init__(self, distributor, task_name: str = "backbone_shard"):
        self._own_clients(distributor)
        self.task_name = task_name
        self.rounds = 0

    async def run_round(self, shard_args, *, shard_work=None,
                        statics=None, timeout: float = 60.0) -> list:
        """Execute one step's shards through the scheduler.

        ``shard_args`` is a list of per-shard work-function arguments;
        ``shard_work[i]`` (default 1.0 each) meters each shard's size so
        the EWMA stays calibrated when shards are uneven.  Returns results
        ordered like ``shard_args``.

        ``statics`` ({key: value}, e.g. this step's stale-head weights) is
        re-registered on the origin registry BEFORE the round's tickets
        are enqueued.  Re-registering bumps each asset's version, the
        tickets pin the new coherence version, and every client
        revalidates before executing — so a client can never run round
        t's shard against round t-1's weights."""
        if statics:
            for key, value in statics.items():
                self.dist.add_static(key, value)
        if shard_work is None:
            shard_work = [1.0] * len(shard_args)
        tids = self.dist.add_work(self.task_name, shard_args,
                                  work=list(shard_work))
        deadline = self.dist.queue.clock() + timeout
        while True:
            # capture the wake epoch before checking: a submit can only
            # land at an await point, so this can't miss a notification
            wake = self.dist._wake_event()
            out = self.dist.queue.results_for(tids)
            if out is not None:
                break
            if self.dist.queue.clock() > deadline:
                raise TimeoutError(
                    f"split round unfinished: {self.dist.console()}")
            await self.dist._wait_on(wake, 0.05)
        # forget the finished round so queue scans/memory stay O(one round)
        # over a long training run, not O(all history)
        self.dist.queue.prune(tids)
        self.rounds += 1
        return out

    @staticmethod
    def aggregate(shard_grads, shard_sizes) -> Any:
        """Work-weighted mean of per-shard gradient trees (see
        :func:`weighted_grad_mean`)."""
        return weighted_grad_mean(shard_grads, shard_sizes)


def init_prev_features(state: TrainState, api: ModelApi, batch,
                       dtype=torch.bfloat16) -> TrainState:
    """Zero placeholders for the feature-replay slots, on the batch's
    device (their shapes depend on the batch)."""
    cfg = api.cfg
    tokens = batch["tokens"]
    b, s = tokens.shape
    if cfg.family == "vlm":
        s = s + cfg.num_patches
    feats = torch.zeros((b, s, cfg.d_model), dtype=dtype,
                        device=tokens.device)
    return replace(state, prev_features=feats,
                   prev_labels=torch.zeros_like(batch["labels"]),
                   prev_mask=torch.zeros_like(batch["mask"]))


__all__ = ["HEAD_KEYS", "RoundDriverLifetime", "SplitConcurrentDispatcher",
           "TrainState", "adaptive_shard_sizes", "init_prev_features",
           "make_train_step", "merge_params", "server_head_update",
           "split_params", "weighted_grad_mean"]
