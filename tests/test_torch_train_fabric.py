"""The port's training fabric: the server steps (fused == tree bitwise inside
the port, and close to the JAX package's), and the slice as a whole — paper
CNN rounds through the port's fabric tracking the JAX package's in-process
trajectory on the same weights."""
import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jopt
import repro.train_fabric as jfab
from repro.models import cnn as jcnn
from repro_torch.configs.paper_cnn import FABRIC_CNN
from repro_torch.core.distributor import ClientProfile, FixedSizer, TaskDef
from repro_torch.core.federation import FederatedDistributor
from repro_torch.core.split_parallel import TrainState
from repro_torch.models import cnn
from repro_torch.optim import adagrad, sgd
from repro_torch.train_fabric import (FederatedTrainer,
                                      FederatedTrainingLoop, FusedServerStep,
                                      TreeServerStep, checkpoint_path,
                                      latest_checkpoint,
                                      load_round_checkpoint, member_coeffs,
                                      param_count)
from repro_torch.tree import as_tensor, to_numpy, tree_leaves, tree_map

F32 = dict(atol=3e-5, rtol=1e-4)


def _ragged(rng, dtype, scale=1.0):
    """2-d, 1-d, nested 3-d and 1- and 2-element leaves, as numpy in
    ``dtype`` (bf16 through ml_dtypes)."""
    mk = lambda *s: np.asarray(jnp.asarray(
        rng.normal(size=s).astype(np.float32) * scale, jnp.dtype(dtype)))
    return {"w": mk(33, 7), "b": mk(5),
            "deep": {"k": mk(3, 5, 7), "tiny": mk(1), "pair": mk(2)}}


def _round_inputs(dtype):
    rng = np.random.default_rng(5)
    params = _ragged(rng, dtype)
    grads = [_ragged(rng, dtype, scale=0.5) for _ in range(4)]
    return params, grads, [1.0, 2.0, 0.5, 1.5]


def _same_bits(a, b) -> bool:
    a, b = to_numpy(a), to_numpy(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("grads_as", ["numpy", "tensor"])
def test_fused_server_step_bit_equal_to_tree_step(dtype, clip, grads_as):
    """Inside the port the fused step is BIT-equal to the tree reference,
    params and accumulator, on ragged trees down to 1-element leaves
    (eager PyTorch has no scalarised-FMA caveat); gradients may arrive as
    numpy (from the wire) or as tensors."""
    params, grads, works = _round_inputs(dtype)
    params = tree_map(as_tensor, params)
    if grads_as == "tensor":
        grads = [tree_map(as_tensor, g) for g in grads]
    opt = adagrad(0.05, beta=1.5)
    state = opt.init(params)
    p1, s1 = TreeServerStep(opt, clip_norm=clip).step(grads, works, params,
                                                      state)
    p2, s2 = FusedServerStep(opt, lr=0.05, beta=1.5, clip_norm=clip).step(
        grads, works, params, state)
    for a, b in zip(tree_leaves((p1, s1["acc"])),
                    tree_leaves((p2, s2["acc"]))):
        assert _same_bits(a, b)
    assert all(str(a.dtype).endswith(dtype) for a in tree_leaves(p2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [None, 1.0])
def test_fused_server_step_matches_jax(dtype, clip):
    params, grads, works = _round_inputs(dtype)
    jopt_ = jopt.adagrad(0.05, beta=1.5)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want_p, want_s = jfab.FusedServerStep(
        jopt_, lr=0.05, beta=1.5, clip_norm=clip).step(
            grads, works, jp, jopt_.init(jp))
    topt = adagrad(0.05, beta=1.5)
    tp = tree_map(as_tensor, params)
    got_p, got_s = FusedServerStep(topt, lr=0.05, beta=1.5,
                                   clip_norm=clip).step(
        grads, works, tp, topt.init(tp))
    tol = F32 if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    for a, b in zip(jax.tree_util.tree_leaves((want_p, want_s["acc"])),
                    tree_leaves((got_p, got_s["acc"]))):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), **tol)


def _tail_inputs(tail, grads_as):
    """``_round_inputs`` with one more leaf of ``tail`` elements, so the
    flat buffer's n mod 4 is ``tail``; gradients as numpy or tensors."""
    params, grads, works = _round_inputs("float32")
    rng = np.random.default_rng(tail)
    params = dict(params, odd=rng.normal(size=tail).astype(np.float32))
    grads = [dict(g, odd=rng.normal(size=tail).astype(np.float32))
             for g in grads]
    if grads_as == "tensor":
        grads = [tree_map(as_tensor, g) for g in grads]
    return params, grads, works


@pytest.mark.parametrize("tail", [1, 2, 3])
@pytest.mark.parametrize("grads_as", ["numpy", "tensor"])
def test_fused_server_step_stacks_its_gradients_at_a_pitch_of_32(
        monkeypatch, tail, grads_as):
    """The (M, n) stack that reaches the kernel is a view of one buffer
    whose rows lie a multiple of 32 elements apart (n mod 4 = ``tail``, so
    a contiguous stack would put rows at odd offsets).  The step stays bit
    for bit the tree step's and within the f32 bar of the JAX package's
    FusedServerStep."""
    from repro_torch.train_fabric import server_step as port_step
    params, grads, works = _tail_inputs(tail, grads_as)
    stacks = []
    fused_update = port_step.server_step_update

    def spy(p, g_stack, *args, **kwargs):
        stacks.append(g_stack)
        return fused_update(p, g_stack, *args, **kwargs)

    monkeypatch.setattr(port_step, "server_step_update", spy)
    opt = adagrad(0.05, beta=1.5)
    tp = tree_map(as_tensor, params)
    got_p, got_s = FusedServerStep(opt, lr=0.05, beta=1.5).step(
        grads, works, tp, opt.init(tp))
    (g_stack,) = stacks
    n = param_count(params)
    assert n % 4 == tail and g_stack.shape == (len(grads), n)
    assert g_stack.stride(1) == 1 and g_stack.stride(0) % 32 == 0
    assert n <= g_stack.stride(0) < n + 32
    tree_p, tree_s = TreeServerStep(opt).step(grads, works, tp,
                                              opt.init(tp))
    for a, b in zip(tree_leaves((tree_p, tree_s["acc"])),
                    tree_leaves((got_p, got_s["acc"]))):
        assert _same_bits(a, b)
    jopt_ = jopt.adagrad(0.05, beta=1.5)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want_p, want_s = jfab.FusedServerStep(jopt_, lr=0.05, beta=1.5).step(
        [tree_map(to_numpy, g) for g in grads], works, jp, jopt_.init(jp))
    for a, b in zip(jax.tree_util.tree_leaves((want_p, want_s["acc"])),
                    tree_leaves((got_p, got_s["acc"]))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)


def test_fused_server_step_keeps_one_staging_buffer_across_rounds():
    """Rounds of 4, then 3, then 4 members reuse the host buffer the first
    round made, and each gives what a fresh FusedServerStep gives, bit for
    bit: nothing of an earlier round leaks into a later one."""
    params, grads, works = _tail_inputs(3, "numpy")
    opt = adagrad(0.05, beta=1.5)
    tp = tree_map(as_tensor, params)
    state = opt.init(tp)
    kept = FusedServerStep(opt, lr=0.05, beta=1.5)
    buffers = []
    for m in (4, 3, 4):
        got = kept.step(grads[:m], works[:m], tp, state)
        buffers.append(kept._staging.data_ptr())
        want = FusedServerStep(opt, lr=0.05, beta=1.5).step(
            grads[:m], works[:m], tp, state)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert _same_bits(a, b)
        grads = grads[1:] + grads[:1]           # other gradients each round
    assert buffers[0] == buffers[1] == buffers[2]


@pytest.mark.parametrize("clip", [None, 1.0, 0.01])
def test_member_coeffs_match_jax(clip):
    _, grads, works = _round_inputs("float32")
    got = member_coeffs(grads, works, clip)
    want = jfab.member_coeffs(grads, works, clip)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_fused_server_step_rejects_non_adagrad():
    with pytest.raises(ValueError, match="AdaGrad"):
        FusedServerStep(sgd(0.1), lr=0.1)


# --- the slice as a whole ------------------------------------------------------

ROWS, SHARDS, LR = 96, 4, 0.05
ARGS = [(lo, lo + ROWS // SHARDS) for lo in range(0, ROWS, ROWS // SHARDS)]
WORK = [float(ROWS // SHARDS)] * SHARDS


def _weights():
    return cnn.params_to_numpy(cnn.init_cnn(torch.Generator().manual_seed(0),
                                            FABRIC_CNN, "cpu"))


def _state(params, opt):
    return TrainState(params=params, head={}, head_stale={},
                      opt_state=opt.init(params), head_opt_state={},
                      prev_features=(), prev_labels=(), prev_mask=(),
                      step=np.zeros((), np.int32))


async def _port_rounds(rounds, *, remote=False, server_step="fused",
                       state=None, start=0, ckdir=None):
    """The port's CNN rounds through its fabric copy on the CPU: in-process
    clients, or remote v2-wire clients behind a TransportServer."""
    from repro_torch.core.transport import (TransportServer,
                                            spawn_remote_clients)
    fed = FederatedDistributor(2, n_shards=4, timeout=20.0,
                               redistribute_min=0.02, sizer=FixedSizer(1),
                               watchdog_interval=0.01, grace=2.0,
                               project_name="TorchFabric")
    fed.register_task(TaskDef(
        "cnn_grad_shard", cnn.CnnGradShard(FABRIC_CNN, n_rows=ROWS,
                                           device="cpu"),
        static_files=("weights",)))
    profiles = [ClientProfile(name=f"c{i}", speed=2000.0) for i in range(3)]
    server = tasks = None
    if remote:
        server = TransportServer(fed)
        host, port = await server.start()
        _, tasks = spawn_remote_clients((host, port), profiles,
                                        reconnect_delay=0.02)
    else:
        fed.spawn_clients(profiles)
    opt = adagrad(LR)
    step = (FusedServerStep(opt, lr=LR) if server_step == "fused"
            else TreeServerStep(opt))
    trainer = FederatedTrainer(fed, task_name="cnn_grad_shard",
                               barrier_k=0.75, straggler_policy="reticket",
                               timeout=30.0)
    loop = FederatedTrainingLoop(
        trainer, opt, state or _state(cnn.params_from_numpy(
            _weights(), "cpu"), opt),
        server_step=step, device="cpu", round_index=start,
        checkpoint_dir=ckdir)
    try:
        async with trainer:
            for _ in range(start, rounds):
                await loop.run_round(ARGS, WORK)
        if tasks:
            await asyncio.wait_for(asyncio.gather(*tasks), 30.0)
    finally:
        if server is not None:
            # bounded: TransportServer.stop() waits for open connections
            await asyncio.wait_for(server.stop(), 30.0)
        await fed.shutdown()
    return loop


def _jax_in_process(rounds):
    """The JAX package's in-process trajectory: its CnnGradShard over the
    same row shards, folded by its TreeServerStep, on the same weights."""
    from repro.configs.paper_cnn import FABRIC_CNN as JAX_FABRIC_CNN
    task = jcnn.CnnGradShard(JAX_FABRIC_CNN, n_rows=ROWS)
    opt = jopt.adagrad(LR)
    params = _weights()
    opt_state = opt.init(params)
    step = jfab.TreeServerStep(opt)
    losses = []
    for t in range(rounds):
        outs = [task(a, {"weights": {"round": t, "params": params}})
                for a in ARGS]
        params, opt_state = step.step([o["grad"] for o in outs], WORK,
                                      params, opt_state)
        losses.append(sum(o["loss"] * w for o, w in zip(outs, WORK))
                      / sum(WORK))
    return losses, jax.device_get(params)


def test_port_fabric_rounds_track_the_jax_in_process_trajectory():
    """Three FABRIC_CNN rounds through the port (in-process clients, K-of-N
    reticket barrier, fused server step) against the JAX package's
    in-process twin: losses within 1e-5, final weights within the f32
    tolerance (the two frameworks' convolutions round differently)."""
    loop = asyncio.run(_port_rounds(3))
    assert loop.stale_executions == 0 and loop.round_index == 3
    assert int(loop.state.step) == 3
    assert param_count(loop.state.params) == param_count(_weights())
    losses, params = _jax_in_process(3)
    np.testing.assert_allclose(loop.losses, losses, rtol=0, atol=1e-5)
    assert loop.losses[-1] < loop.losses[0]
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    tree_leaves(loop.state.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)


def test_remote_wire_rounds_equal_in_process_rounds():
    """The Fig. 3 path on the CPU: remote v2-wire clients give the
    trajectory of in-process clients, and the fused step that of the tree
    step, exactly."""
    remote = asyncio.run(_port_rounds(2, remote=True))
    local = asyncio.run(_port_rounds(2, server_step="tree"))
    assert remote.stale_executions == 0
    assert remote.losses == local.losses
    for a, b in zip(tree_leaves(remote.state.params),
                    tree_leaves(local.state.params)):
        assert _same_bits(a, b)


def test_kill_and_resume_at_a_round_boundary_reproduces_the_trajectory(
        tmp_path):
    full = asyncio.run(_port_rounds(3))
    asyncio.run(_port_rounds(1, ckdir=str(tmp_path)))
    ck = latest_checkpoint(str(tmp_path))
    assert ck == checkpoint_path(str(tmp_path), 1)
    state, start, extra = load_round_checkpoint(ck)
    assert start == 1 and extra["losses"] == full.losses[:1]
    resumed = asyncio.run(_port_rounds(3, state=state, start=start))
    assert resumed.losses == full.losses[1:]
