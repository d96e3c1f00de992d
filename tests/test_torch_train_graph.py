"""The compiled training step of the port, on the CPU: the split
strategies read ``state.step`` through tensor ops alone (a 0-d int32
tensor on the params' device, as the JAX step computes under
``jax.jit``), and ``launch.graphs.StepGraph`` runs a step on static
buffers (a CUDA graph's replay on the card, the same step run eagerly
here).

What is held, on smoke configs at f32 with weights from a seed:

(a) 6 steps (step 0 and the K = 4 refresh among them) of each strategy
    at ``grad_accum`` 1 and 2 against the JAX package's
    ``jax.jit(step_fn)``, every loss and state leaf within the f32 model
    bar (atol 2e-4 / rtol 1e-3): qwen3-4b in all six, and
    ``split_concurrent`` at ``grad_accum`` 1 in qwen3-moe-30b-a3b,
    rwkv6-1.6b and Jamba (each case one JAX compile);
(b) the device-step form against the host-branch form it replaced (the
    parent's ``int(state.step)`` branches, kept below): every leaf bit
    for bit at every step, so step 0's zero head gradient and the
    refreshes are the same;
(c) one step traced once by ``make_fx`` (real mode: it records the ops
    eager runs, as a CUDA graph records the kernels of one run) at step 1
    and replayed at steps 2-5 with other batches equals the eager step
    bit for bit: no step value is baked in; the host-branch step, which
    reads ``int(state.step)``, cannot be traced;
(d) ``StepGraph`` equals a plain loop of ``step_fn`` bit for bit, and a
    runner that never refreshes its batch buffer, or one whose
    ``prev_labels`` alias the batch buffer, departs from it;
(e) a DTensor state is adopted (the training bundle's ``lower()``): each
    buffer placed as the bundle places it, with a local storage of its
    own, and the step equal to the bundle's eager call bit for bit;
(f) the CNN's ``loss_and_grads`` and the quickstart's step
    (``cnn.train_step``) through their runners equal their eager selves
    bit for bit and the JAX package's jitted counterparts within
    ``tests/test_kernels.py::_tol`` (f32);
and no family's training step draws from a random generator (so
``layers.checkpointed`` need not save the RNG state, which a capture
cannot read).
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
import types
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import paper_cnn as jcfgs
from repro.core import split_parallel as JS
from repro.launch.steps import arch_for_run as jax_arch_for_run
from repro.models import cnn as jcnn
from repro.models.model import build_model as jax_build_model
from repro.optim import adagrad as jax_adagrad
from repro.optim import get_optimizer as jax_get_optimizer
from repro.train_fabric import checkpointing as jax_ckpt
from repro_torch.configs import InputShape, get_smoke_config
from repro_torch.configs import paper_cnn as tcfgs
from repro_torch.core import split_parallel as S
from repro_torch.data import make_lm_batch
from repro_torch.launch.graphs import StepGraph
from repro_torch.launch.steps import arch_for_run
from repro_torch.models import cnn as tcnn
from repro_torch.models import layers, mamba, rwkv
from repro_torch.models.model import build_model, lm_loss
from repro_torch.optim import adagrad, get_optimizer
from repro_torch.train_fabric import checkpointing as port_ckpt
from repro_torch.tree import (tree_as_tensors, tree_flatten, tree_leaves,
                              tree_map, tree_to_numpy, to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-4, rtol=1e-3)
#: tests/test_kernels.py::_tol at f32
F32 = dict(atol=3e-5, rtol=1e-4)
B, SEQ, STEPS, K, LR = 4, 16, 6, 4, 0.05
_SHAPE = InputShape("custom", SEQ, B, "train")

#: name -> (arch, strategy, grad_accum)
CASES = {f"qwen3-4b/{s}/accum{a}": ("qwen3-4b", s, a)
         for s in ("dp_full", "split_sequential", "split_concurrent")
         for a in (1, 2)}
CASES.update({f"{arch}/split_concurrent/accum1": (arch, "split_concurrent", 1)
              for arch in ("qwen3-moe-30b-a3b", "rwkv6-1.6b",
                           "jamba-1.5-large-398b")})
#: one smoke config a family, for the no-random-draw check
FAMILIES = ("qwen3-4b", "qwen3-moe-30b-a3b", "internvl2-26b",
            "whisper-small", "rwkv6-1.6b", "jamba-1.5-large-398b")


def _configs(arch: str, strategy: str):
    jcfg, pcfg = jax_smoke_config(arch), get_smoke_config(arch)
    if arch == "qwen3-4b":
        jcfg = dataclasses.replace(jcfg, tie_embeddings=False)
        pcfg = dataclasses.replace(pcfg, tie_embeddings=False)
    return (jax_arch_for_run(jcfg, _SHAPE, strategy),
            arch_for_run(pcfg, _SHAPE, strategy))


def _batches(vocab: int, n: int = STEPS, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [make_lm_batch(rng, B, SEQ, vocab) for _ in range(n)]


def _port(arch: str, strategy: str, accum: int = 1):
    """The port's (api, opt, init, step_fn, batches, initial state) for a
    case, its weights from the seed."""
    _, cfg = _configs(arch, strategy)
    api = build_model(cfg, compute_dtype=torch.float32)
    opt = get_optimizer("adagrad", LR)
    init, step = S.make_train_step(api, opt, strategy=strategy,
                                   head_sync_period=K, grad_accum=accum)
    batches = [tree_as_tensors(b) for b in _batches(cfg.vocab_size)]
    state = init(torch.Generator().manual_seed(0))
    if strategy == "split_concurrent":
        state = S.init_prev_features(state, api, batches[0],
                                     dtype=torch.float32)
    return api, opt, init, step, batches, state


def _leaves(state) -> list:
    return [x for f in fields(S.TrainState)
            for x in tree_leaves(getattr(state, f.name))]


def _assert_same(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and torch.equal(a, b), f"{what}: leaf {i}"


def _loop(step, state, batches) -> tuple:
    """A plain loop of ``step``: (every state, every metrics dict)."""
    states, metrics = [state], []
    for b in batches:
        state, m = step(state, b)
        states.append(state)
        metrics.append(m)
    return states, metrics


# --- (a) the port's device-step form against the JAX jitted step -------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_step_matches_the_jax_jitted_step(case):
    arch, strategy, accum = CASES[case]
    jcfg, _ = _configs(arch, strategy)
    japi = jax_build_model(jcfg, compute_dtype=jnp.float32)
    _, jstep = JS.make_train_step(
        japi, jax_get_optimizer("adagrad", LR), strategy=strategy,
        head_sync_period=K, grad_accum=accum)
    _, _, _, step, batches, state = _port(arch, strategy, accum)
    # the port's initial state carried to JAX whole (the packages share
    # the round checkpoint's field layout), which spares a JAX init
    jstate = jax_ckpt.state_from_tree(jax.tree_util.tree_map(
        jnp.asarray, tree_to_numpy(port_ckpt.state_to_tree(state))))
    np_batches = _batches(jcfg.vocab_size)
    assert state.step.dtype == torch.int32 and state.step.shape == ()
    jit_step = jax.jit(jstep)
    for i, (jb, b) in enumerate(zip(np_batches, batches)):
        jstate, jm = jit_step(jstate, jb)
        state, m = step(state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **TOL, err_msg=f"{case} step {i}")
        assert int(state.step) == int(jstate.step) == i + 1
        for f in fields(S.TrainState):
            want = jax.tree_util.tree_leaves(getattr(jstate, f.name))
            got = tree_leaves(getattr(state, f.name))
            assert len(got) == len(want), (case, i, f.name)
            for a, g in zip(want, got):
                a, g = np.asarray(a), to_numpy(g)
                assert a.shape == g.shape and a.dtype == g.dtype, f.name
                np.testing.assert_allclose(
                    g, a, **TOL, err_msg=f"{case} step {i} {f.name}")


# --- (b) against the host-branch form it replaced ----------------------------


def _host_branch_step(api, opt, k: int):
    """The parent's ``split_concurrent`` step (``grad_accum`` 1): the head
    gradient computed only when ``int(state.step) > 0`` and zeros
    otherwise, ``head_stale`` rebound to the new head when ``(int(step) +
    1) % k == 0``, the step counter a host tensor."""

    def step_fn(state, batch):
        def client_loss(backbone):
            params = S.merge_params(backbone, state.head_stale)
            logits, aux, feats = api.forward_features(params, batch,
                                                      differentiable=True)
            loss = lm_loss(S._text_logits(api, logits), batch["labels"],
                           batch["mask"])
            return loss + aux, ({"loss": loss, "aux": aux}, feats)

        loss, (metrics, feats), (g,) = S._value_and_grad(client_loss,
                                                         state.params)
        with torch.no_grad():
            new_backbone, new_opt = opt.update(g, state.opt_state,
                                               state.params)
        if int(state.step) > 0:
            _, _, (g_head,) = S._value_and_grad(
                lambda head: (S._head_loss(
                    api, head, state.params, state.prev_features,
                    state.prev_labels, state.prev_mask), None), state.head)
        else:
            g_head = tree_map(torch.zeros_like, state.head)
        with torch.no_grad():
            new_head, new_hopt = opt.update(g_head, state.head_opt_state,
                                            state.head)
        do_sync = (int(state.step) + 1) % k == 0
        return S.TrainState(
            new_backbone, new_head,
            new_head if do_sync else state.head_stale, new_opt, new_hopt,
            feats, batch["labels"], batch["mask"],
            torch.as_tensor(state.step, dtype=torch.int32) + 1), \
            {**metrics, "total": loss}

    return step_fn


@pytest.mark.parametrize("arch", ["qwen3-4b"])
def test_device_step_equals_the_host_branch_form_bitwise(arch):
    api, opt, _, step, batches, state = _port(arch, "split_concurrent")
    got, got_m = _loop(step, state, batches)
    want, want_m = _loop(_host_branch_step(api, opt, K), state, batches)
    for i in range(1, STEPS + 1):
        _assert_same(got[i], want[i], f"{arch} after step {i - 1}")
        assert torch.equal(got_m[i - 1]["loss"], want_m[i - 1]["loss"])
    # the rules themselves: step 0 leaves the head (weight decay 0) as it
    # was; from step 1 on the stale copy is the head only after a refresh
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(got[1].head), tree_leaves(state.head)))
    for i in range(1, STEPS):
        synced = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(got[i + 1].head_stale), tree_leaves(got[i + 1].head)))
        assert synced == ((i + 1) % K == 0), i


# --- (c) one trace replayed at other steps -----------------------------------


def _flat(step_fn):
    """``step_fn`` over a flat list of the state's leaves (a trace takes
    and gives lists and dicts of tensors): (the step on leaves, a
    function rebuilding the state from them)."""
    names = [f.name for f in fields(S.TrainState)]

    def split(leaves, like):
        out, i = {}, 0
        for name in names:
            n, tdef = tree_flatten(getattr(like, name))
            out[name] = tdef.unflatten(leaves[i:i + len(n)])
            i += len(n)
        return S.TrainState(**out)

    def on_leaves(like):
        def run(leaves, batch):
            new, metrics = step_fn(split(list(leaves), like), batch)
            return _leaves(new), metrics
        return run

    return on_leaves, split


def _replays_like_eager(step_fn, state, batches):
    """Trace ``step_fn`` at step 1 (after one eager step), then replay the
    trace at steps 2-5 with their batches: each must equal the eager step
    there, bit for bit."""
    on_leaves, split = _flat(step_fn)
    state, _ = step_fn(state, batches[0])
    traced = make_fx(on_leaves(state))(_leaves(state), batches[1])
    for i in range(1, STEPS):
        want, want_m = step_fn(state, batches[i])
        leaves, got_m = traced(_leaves(state), batches[i])
        got = split(leaves, state)
        _assert_same(got, want, f"the trace replayed at step {i}")
        assert torch.equal(got_m["loss"], want_m["loss"]), i
        state = want
    assert int(state.step) == STEPS


@pytest.mark.parametrize("strategy", ["split_concurrent", "dp_full"])
def test_traced_step_replays_at_other_steps(strategy):
    _, _, _, step, batches, state = _port("qwen3-4b", strategy)
    _replays_like_eager(step, state, batches)


def test_a_step_that_reads_its_step_fails_the_replay_check():
    """A planted fault: the host-branch step reads ``int(state.step)``,
    which a trace, like a CUDA graph, cannot carry to another step."""
    api, opt, _, _, batches, state = _port("qwen3-4b", "split_concurrent")
    with pytest.raises(RuntimeError, match="value out of a tracing tensor"):
        _replays_like_eager(_host_branch_step(api, opt, K), state, batches)


# --- (d) the runner against a plain loop -------------------------------------


class _StaleBatch(StepGraph):
    """A planted fault: the runner loads its batch buffer once."""

    def _load(self, inputs):
        if self.inputs is None:
            super()._load(inputs)


class _AliasedState(StepGraph):
    """A planted fault: the runner takes the new state's tensors as its
    state instead of copying them, so ``prev_labels`` and ``prev_mask``
    are the batch buffer, which the next batch overwrites before the
    server's half reads them."""

    def _advance(self):
        if self.new is not None:
            self.state = self.new


class _ReplayedCapture:
    """A stand-in for ``graphs.Capture`` on the CPU that keeps what a CUDA
    graph keeps: the captured call's output tensors, which each replay
    rewrites by running the function again on the same buffers; so the
    graph route's bookkeeping (the first step's new state taken as the
    buffers, the capture at the second call, the copies before each
    replay) runs here."""

    def __init__(self, device):
        self.per_replay = {}

    def warm(self, body):
        return body()

    def record(self, body):
        self.body, self.outs = body, body()
        return self.outs

    def copies(self, pairs):
        return types.SimpleNamespace(
            replay=lambda: [dst.copy_(src) for dst, src in pairs])

    def replay(self):
        for out, new in zip(_leaves_of(self.outs), _leaves_of(self.body())):
            out.copy_(new)


def _leaves_of(pair) -> list:
    new, out = pair
    return _leaves(new) + tree_leaves(out)


def _run(runner_cls, step, state, batches, graphed=False) -> tuple:
    runner = runner_cls(step, tree_map(torch.clone, state)
                        if not isinstance(state, S.TrainState)
                        else dataclasses.replace(state, **{
                            f.name: tree_map(torch.clone,
                                             getattr(state, f.name))
                            for f in fields(S.TrainState)}))
    if graphed:
        runner.graphed, runner.capture_type = True, _ReplayedCapture
    states, losses = [], []
    for b in batches:
        new, m = runner(b)
        states.append(dataclasses.replace(new, **{
            f.name: tree_map(torch.clone, getattr(new, f.name))
            for f in fields(S.TrainState)}))
        losses.append(m["loss"].clone())
    return states, losses


@pytest.mark.parametrize("graphed", [False, True])
@pytest.mark.parametrize("strategy", ["split_concurrent", "split_sequential",
                                      "dp_full"])
def test_runner_on_the_cpu_equals_a_plain_loop(strategy, graphed):
    """The CPU route, and (``graphed``) the graph route's bookkeeping
    around a stand-in capture."""
    _, _, _, step, batches, state = _port("qwen3-4b", strategy)
    want, want_m = _loop(step, state, batches)
    got, got_losses = _run(StepGraph, step, state, batches, graphed)
    for i in range(STEPS):
        _assert_same(got[i], want[i + 1], f"{strategy} step {i}")
        assert torch.equal(got_losses[i], want_m[i]["loss"])


@pytest.mark.parametrize("runner,graphed", [(_StaleBatch, False),
                                            (_StaleBatch, True),
                                            (_AliasedState, False)])
def test_a_planted_runner_departs_from_the_plain_loop(runner, graphed):
    _, _, _, step, batches, state = _port("qwen3-4b", "split_concurrent")
    want, _ = _loop(step, state, batches)
    got, _ = _run(runner, step, state, batches, graphed)
    gaps = [max((a - b).abs().max().item() for a, b in zip(
        _leaves(got[i]), _leaves(want[i + 1])) if a.is_floating_point())
        for i in range(STEPS)]
    assert gaps[0] == 0.0 and max(gaps) > TOL["atol"], gaps


def test_runner_keeps_each_leaf_a_buffer_of_its_own():
    """``split_sequential`` hands back its new head as ``head`` and
    ``head_stale``: the runner's buffers stay apart, and a state whose
    leaves share storage is given a buffer a leaf."""
    _, _, _, step, batches, state = _port("qwen3-4b", "split_sequential")
    shared = dataclasses.replace(state, head_stale=state.head)
    runner = StepGraph(step, shared)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(
        tree_leaves(runner.state.head), tree_leaves(runner.state.head_stale)))
    for b in batches[:2]:
        runner(b)
    runner._advance()
    for a, b in zip(tree_leaves(runner.state.head),
                    tree_leaves(runner.state.head_stale)):
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)


# --- (e) a DTensor state -----------------------------------------------------


def test_a_dtensor_state_is_refused(tmp_path):
    """A DTensor state is no longer refused: the training bundle's
    ``lower()`` on a 1x1 gloo mesh (qwen3-4b's smoke config, fsdp_tp) adopts
    the placed state in a ``StepGraph``, each buffer a DTensor with the
    bundle's placements and a local storage of its own, and its step
    equals the bundle's eager call bit for bit."""
    script = textwrap.dedent(f"""
        import numpy as np, torch, torch.distributed as dist
        from repro_torch.configs import InputShape, RunConfig, get_smoke_config
        from repro_torch.data import make_lm_batch
        from repro_torch.launch.graphs import local
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.launch.steps import build_train_step
        from repro_torch.sharding.spec import is_dtensor
        from repro_torch.tree import tree_leaves
        dist.init_process_group("gloo", store=dist.FileStore(
            {str(tmp_path / "store")!r}, 1), rank=0, world_size=1)
        mesh = make_local_mesh(1, 1, device="cpu")
        cfg = get_smoke_config("qwen3-4b")
        bundle = build_train_step(
            cfg, RunConfig(arch="qwen3-4b", strategy="fsdp_tp",
                           learning_rate=0.05, compute_dtype="float32"),
            InputShape("c", 16, 2, "train"), mesh)
        batch = {{k: torch.from_numpy(v) for k, v in make_lm_batch(
            np.random.default_rng(0), 2, 16, cfg.vocab_size).items()}}
        init = lambda: bundle.init(torch.Generator().manual_seed(0))
        runner = bundle.lower()
        got, m_got = runner(init(), batch)
        want, m_want = bundle(init(), batch)
        bufs = [x for x in tree_leaves(vars(runner.graph.state))
                if isinstance(x, torch.Tensor)]
        placed, = bundle.place(bundle.args_spec[0])
        pls = [tuple(x.placements) if is_dtensor(x) else None
               for x in tree_leaves(vars(placed))
               if isinstance(x, torch.Tensor)]
        print("dtensors:", sum(map(is_dtensor, bufs)), len(bufs))
        print("placed_as:", [tuple(x.placements) if is_dtensor(x) else None
                             for x in bufs] == pls)
        ptrs = [local(x).untyped_storage().data_ptr() for x in bufs
                if x.numel()]
        print("own_storage:", len(set(ptrs)) == len(ptrs))
        whole = lambda x: x.full_tensor() if is_dtensor(x) else x
        print("equal:", torch.equal(whole(m_got["loss"]),
                                    whole(m_want["loss"])) and all(
            torch.equal(whole(a), whole(b)) for a, b in zip(
                tree_leaves(vars(got)), tree_leaves(vars(want)))))
        dist.destroy_process_group()
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(": ", 1) for line in out.stdout.splitlines()
                 if ": " in line)
    n_dt, n = map(int, lines["dtensors"].split())
    assert n_dt > 0 and n_dt == n - 1, out.stdout     # all but the step
    assert lines["placed_as"] == "True", out.stdout
    assert lines["own_storage"] == "True", out.stdout
    assert lines["equal"] == "True", out.stdout


# --- (f) the CNN's two jitted steps ------------------------------------------


@functools.lru_cache(maxsize=None)
def _cnn():
    """The smoke net (the quickstart's layer kinds at toy width), the
    port's init carried to JAX as numpy (no JAX init compile), and three
    batches of 8 rows."""
    jc, tc = jcfgs.smoke_config(), tcfgs.smoke_config()
    jp = tcnn.params_to_numpy(tcnn.init_cnn(torch.Generator().manual_seed(0),
                                            tc, "cpu"))
    rng = np.random.default_rng(0)
    data = [(rng.normal(size=(8, jc.image_size, jc.image_size,
                              jc.in_channels)).astype(np.float32),
             rng.integers(0, jc.num_classes, 8).astype(np.int32))
            for _ in range(3)]
    return jc, tc, jp, data


def test_cnn_loss_and_grads_through_its_runner():
    jc, tc, jp, data = _cnn()
    tp = tcnn.params_from_numpy(jp, "cpu")
    f, eager = tcnn.loss_and_grads(tc), tcnn.value_and_grad(tc)
    jf = jcnn.loss_and_grads(jc)
    for x, y in data:
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        loss, grads = f(tp, tx, ty)
        e_loss, e_grads = eager(tp, tx, ty)
        j_loss, j_grads = jf(jp, jnp.asarray(x), jnp.asarray(y))
        assert torch.equal(loss, e_loss)
        np.testing.assert_allclose(float(loss), float(j_loss), **F32)
        j_leaves = jax.tree_util.tree_leaves(jax.device_get(j_grads))
        for g, e, j in zip(tree_leaves(grads), tree_leaves(e_grads),
                           j_leaves):
            assert torch.equal(g, e)
            np.testing.assert_allclose(g.numpy(), np.asarray(j), **F32)
    # handed back apart from the runner's buffers: a later call leaves an
    # earlier call's gradients as they were
    first, _ = f(tp, *map(torch.from_numpy, data[0]))[1], None
    f(tp, *map(torch.from_numpy, data[1]))
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(first), tree_leaves(eager(
            tp, *map(torch.from_numpy, data[0]))[1])))


def test_quickstart_step_through_its_runner():
    jc, tc, jp, data = _cnn()
    tp = tcnn.params_from_numpy(jp, "cpu")
    opt = adagrad(0.02, beta=1.0, use_kernel=True)
    step = tcnn.train_step(tc, opt)
    runner = StepGraph(step, (tree_map(torch.clone, tp), opt.init(tp)))
    jopt = jax_adagrad(0.02, beta=1.0)

    @jax.jit
    def jstep(params, opt_state, x, y):
        def loss_fn(p):
            return jcnn.nll_loss(jcnn.forward(p, jc, x), y)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt_state = jopt.update(grads, opt_state, params)
        return params, opt_state, loss

    eager = (tp, opt.init(tp))
    jstate = (jp, jopt.init(jp))
    for x, y in data:
        batch = (torch.from_numpy(x), torch.from_numpy(y))
        (params, opt_state), loss = runner(batch)
        eager, e_loss = step(eager, batch)
        jparams, jopt_state, j_loss = jstep(*jstate, jnp.asarray(x),
                                            jnp.asarray(y))
        jstate = (jparams, jopt_state)
        assert torch.equal(loss, e_loss)
        np.testing.assert_allclose(float(loss), float(j_loss), **F32)
        for g, e, j in zip(tree_leaves((params, opt_state)),
                           tree_leaves(eager),
                           jax.tree_util.tree_leaves(jstate)):
            assert torch.equal(g, e)
            np.testing.assert_allclose(g.numpy(), np.asarray(j), **F32)


# --- no random draws in training ---------------------------------------------


_checkpointed = layers.checkpointed


class _NoRandom(TorchDispatchMode):
    """Refuses every op that draws from a random generator."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if torch.Tag.nondeterministic_seeded in func.tags:
            raise AssertionError(f"{func} draws from a generator")
        return func(*args, **(kwargs or {}))


def test_the_no_random_mode_refuses_a_draw():
    with pytest.raises(AssertionError, match="draws from a generator"):
        with _NoRandom():
            torch.rand(2)


@pytest.mark.parametrize("arch", FAMILIES)
def test_no_training_step_draws_from_a_generator(arch, monkeypatch):
    """One remat ``split_concurrent`` step of each family's smoke config
    under a mode that refuses random ops; the recurrent scans in chunks of
    8 steps, so their checkpointed chunks (``layers.chunked_scan``) run
    too."""
    monkeypatch.setattr(rwkv, "SCAN_CHUNK", SEQ // 2)
    monkeypatch.setattr(mamba, "SCAN_CHUNK", SEQ // 2)
    seq = SEQ
    cfg = arch_for_run(get_smoke_config(arch),
                       InputShape("custom", seq, 1, "train"),
                       "split_concurrent")
    api = build_model(cfg, compute_dtype=torch.float32, remat=True)
    init, step = S.make_train_step(api, get_optimizer("adagrad", LR),
                                   strategy="split_concurrent")
    rng = np.random.default_rng(0)
    batch = tree_as_tensors(make_lm_batch(rng, 1, seq, cfg.vocab_size))
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.normal(0, 0.02, (
            1, cfg.num_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(0, 0.02, (
            1, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
    state = S.init_prev_features(init(torch.Generator().manual_seed(0)),
                                 api, batch, dtype=torch.float32)
    chunks = []
    monkeypatch.setattr(layers, "checkpointed", lambda fn, *a, **k: (
        chunks.append(fn), _checkpointed(fn, *a, **k))[1])
    with _NoRandom():
        state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"])) and int(state.step) == 1
    if arch in ("rwkv6-1.6b", "jamba-1.5-large-398b"):
        assert any(fn in (rwkv._wkv_chunk, mamba._scan_chunk)
                   for fn in chunks), arch
