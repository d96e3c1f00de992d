"""The port's dry-run (``repro_torch.launch.dryrun``): steps run on the meta
device over a shape-only mesh, counted by ``launch.hlo_analysis``'s
accounting mode, on the CPU.

Every dry-run case runs in a subprocess of its own, with its own fake
process group and a hard timeout, as ``tests/test_dryrun_mini.py`` runs
the JAX dry-run (a process can hold one default group, and the JAX side
needs its device-count flag before jax starts).

What is held:

* the three combos of ``test_dryrun_mini.py`` at smoke size on a 2x4 shape
  mesh (S 256, B 8) run, with positive FLOPs and peak bytes, each kernel
  of the path launched on its meta route;
* their rank-0 argument bytes against the JAX bundles' per-device
  argument bytes (``NamedSharding.shard_shape`` of ``args_sds``, no
  compile): equal, but for the one leaf laid out otherwise, the decode
  step's index (a 0-d int32 array in JAX, a Python int in the port);
* a data- and model-sharded product made replicated counts collective
  bytes;
* the meta count of a step against a real CPU run of the same bundle on a
  1-rank gloo world: product FLOPs, kernel launches and the bytes of
  every op equal, the storage high-water mark within ``TEMP_TOL``;
* the two-depth extrapolation against a full-depth count: FLOPs,
  collectives and launches exact; bytes carry the L-squared term of the
  stacked layers' gradient fills, which three depths fit exactly;
* each kernel's meta route gives its CPU route's shapes and dtypes, and
  its ``work`` the numbers ``chip_smoke.py`` computed before it;
* the production meshes (256 and 512 ranks), and their refusal beside a
  real process group;
* the CLI writes a record with every key of the JAX record.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.kernels.adagrad.ops import adagrad_update_leaves
from repro_torch.kernels.adagrad.ops import work as k2_work
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ops import work as k3_work
from repro_torch.kernels.mamba.ops import mamba_scan
from repro_torch.kernels.mamba.ops import work as k4_work
from repro_torch.kernels.rwkv6.ops import wkv
from repro_torch.kernels.rwkv6.ops import work as k5_work
from repro_torch.kernels.server_step.ops import server_step_update
from repro_torch.kernels.server_step.ops import work as k1_work

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMBOS = [("qwen3-4b", "train_4k", "split_concurrent"),
          ("dbrx-132b", "decode_32k", "fsdp_tp"),
          ("rwkv6-1.6b", "long_500k", "fsdp_tp")]
#: the kernel each combo's path launches, and how often (K2 for the
#: backbone's and the head's trees; K5 once a layer of the smoke config)
COMBO_LAUNCHES = {"qwen3-4b": {"adagrad": 2}, "dbrx-132b": {},
                  "rwkv6-1.6b": {"rwkv6": 2}}
#: the decode step's index: a 0-d int32 array among the JAX bundle's
#: arguments, a Python int among the port's
DECODE_INDEX_BYTES = 4


def _run(code: str, timeout: float = 120) -> dict:
    """Run ``code`` in a fresh interpreter (``src`` on the path, no XLA
    device-count flag); return the JSON object it prints last."""
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=timeout)
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-3000:])
    return json.loads(r.stdout.strip().splitlines()[-1])


_MINI = """
    import dataclasses, json
    from repro_torch.configs import INPUT_SHAPES, RunConfig, get_smoke_config
    from repro_torch.launch.mesh import make_shape_mesh
    from repro_torch.launch.steps import build_step

    mesh = make_shape_mesh((2, 4), ("data", "model"))
    out = {}
    for arch, shape, strategy in COMBOS:
        shape = dataclasses.replace(INPUT_SHAPES[shape], seq_len=256,
                                    global_batch=8)
        bundle = build_step(get_smoke_config(arch),
                            RunConfig(strategy=strategy), shape, mesh)
        out[arch] = bundle.account()
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def mini():
    return _run(f"COMBOS = {COMBOS!r}\n" + textwrap.dedent(_MINI))


@pytest.fixture(scope="module")
def jax_arg_bytes():
    """Per-device argument bytes of the JAX bundles of ``COMBOS`` on an
    8-device 2x4 mesh, read from their shardings (nothing compiled)."""
    return _run(f"COMBOS = {COMBOS!r}\n" + textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import dataclasses, json, math
        import jax, numpy as np
        from repro.configs.base import INPUT_SHAPES, RunConfig, get_smoke_config
        from repro.launch.mesh import make_local_mesh
        from repro.launch.steps import build_step

        mesh = make_local_mesh(data=2, model=4)
        out = {}
        for arch, shape, strategy in COMBOS:
            shape = dataclasses.replace(INPUT_SHAPES[shape], seq_len=256,
                                        global_batch=8)
            b = build_step(get_smoke_config(arch), RunConfig(
                strategy=strategy), shape, mesh)
            sds = jax.tree_util.tree_leaves(b.args_sds)
            shs = jax.tree_util.tree_leaves(
                b.in_shardings, is_leaf=lambda x: hasattr(x, "shard_shape"))
            assert len(sds) == len(shs)
            out[arch] = sum(math.prod(sh.shard_shape(x.shape))
                            * np.dtype(x.dtype).itemsize
                            for x, sh in zip(sds, shs))
        print(json.dumps(out))
    """), timeout=240)


@pytest.mark.parametrize("arch,shape,strategy", COMBOS)
def test_mini_dry_run_on_a_2x4_shape_mesh(mini, arch, shape, strategy):
    c = mini[arch]
    assert c["flops"] > 0 and c["product_flops"] > 0
    assert c["peak_bytes"] > c["arg_bytes"] > 0
    assert c["bytes"] > 0
    # every rank holds a part of the step: it gathers FSDP weights
    assert c["collective_counts"].get("all-gather", 0) > 0
    assert {k: n for k, n in c["launches"].items() if n} \
        == COMBO_LAUNCHES[arch]
    for name, n in COMBO_LAUNCHES[arch].items():
        assert c["kernels"][name]["calls"] == n


@pytest.mark.parametrize("arch,shape,strategy", COMBOS)
def test_argument_bytes_match_the_jax_bundles(mini, jax_arg_bytes, arch,
                                              shape, strategy):
    """Rank 0's local shards of every argument against JAX's per-device
    shard shapes (both round an uneven shard up on rank 0)."""
    got, want = mini[arch]["arg_bytes"], jax_arg_bytes[arch]
    if shape.startswith(("decode", "long")):
        assert want - got == DECODE_INDEX_BYTES
    else:
        assert got == want


def test_collectives_of_a_sharded_product_made_replicated():
    """``test_collective_parse_on_real_hlo``'s product: x data-sharded and
    w model-sharded, summed to a replicated scalar, moves collective
    bytes."""
    out = _run("""
        import json, torch
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.launch.hlo_analysis import Accounting
        from repro_torch.launch.mesh import make_shape_mesh

        mesh = make_shape_mesh((2, 4), ("data", "model"))
        x = DTensor.from_local(torch.empty(4, 512, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(512, 128, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        with Accounting() as acct:
            y = (x @ w).sum().redistribute(mesh, [Replicate(), Replicate()])
        c = acct.counts()
        print(json.dumps({"c": c, "local": 2 * 4 * 512 * 128}))
    """)
    c = out["c"]
    assert sum(c["collectives"].values()) > 0
    assert c["collective_counts"]["all-reduce"] == 2   # one a mesh axis
    assert c["sequential_all_reduces"] == 1            # the second
    assert c["product_flops"] == out["local"]   # rank 0's product alone


_CASE = """
    import dataclasses, json, torch
    from repro_torch.configs import InputShape, RunConfig, get_smoke_config
    from repro_torch.launch.steps import build_step

    def bundle(mesh, arch, kind):
        shape = InputShape("s", 32, 4, kind)
        run = RunConfig(strategy="split_concurrent" if kind == "train"
                        else "fsdp_tp", compute_dtype="float32")
        return build_step(get_smoke_config(arch), run, shape, mesh), shape

    CASES = (("qwen3-4b", "prefill"), ("qwen3-4b", "train"),
             ("jamba-1.5-large-398b", "prefill"))
"""


#: the storage high-water mark of the meta run against the real CPU run's,
#: relative.  The same storages are made, but a real collective's buffers
#: are held by gloo's work objects until they complete, on gloo's threads,
#: so a real run's peak moves from run to run (by up to 640 KiB of 10.9
#: MB on Jamba's prefill, 2 MiB of 26 MB on qwen3-4b's train step)
TEMP_TOL = 0.1


def test_meta_count_equals_a_real_cpu_run_of_the_same_bundle(tmp_path):
    """The same bundles, once on the meta device over a 1x1 shape-only
    mesh and once for real on a 1-rank gloo world: product FLOPs, each
    kernel's calls (the meta route's launches) and the bytes of every op
    equal, and the storage high-water mark within ``TEMP_TOL``."""
    meta = _run(textwrap.dedent(_CASE) + textwrap.dedent("""
        from repro_torch.launch.mesh import make_shape_mesh
        mesh = make_shape_mesh((1, 1), ("data", "model"))
        print(json.dumps({f"{a}/{k}": bundle(mesh, a, k)[0].account()
                          for a, k in CASES}))
    """))
    real = _run(textwrap.dedent(_CASE) + textwrap.dedent(f"""
        import numpy as np, torch.distributed as dist
        from repro_torch.data import make_lm_batch
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.sharding.spec import values_tree
        from repro_torch.tree import tree_as_tensors
        dist.init_process_group("gloo", store=dist.FileStore(
            {str(tmp_path / "store")!r}, 1), rank=0, world_size=1)
        mesh = make_local_mesh(1, 1, device="cpu")
        out = {{}}
        for a, k in CASES:
            b, shape = bundle(mesh, a, k)
            gen = torch.Generator().manual_seed(0)
            rng = np.random.default_rng(0)
            if k == "train":
                data = tree_as_tensors(make_lm_batch(
                    rng, 4, 32, b.cfg.vocab_size))
                args = (b.init(gen, batch=data), data)
            else:
                args = (values_tree(b.api.init(gen)), {{"tokens":
                    torch.from_numpy(rng.integers(0, b.cfg.vocab_size,
                                                  (4, 32)).astype(np.int32))}})
            with torch.no_grad() if k != "train" else torch.enable_grad():
                out[f"{{a}}/{{k}}"] = b.account(*b.place(*args))
        dist.destroy_process_group()
        print(json.dumps(out))
    """))
    for case, m in meta.items():
        r = real[case]
        assert m["product_flops"] == r["product_flops"] > 0, case
        assert m["flops_by_op"] == r["flops_by_op"], case
        assert m["kernels"] == r["kernels"], case
        assert m["launches"] == {k: r["kernels"].get(k, {}).get("calls", 0)
                                 for k in m["launches"]}, case
        for key in ("bytes", "bytes_by_op", "arg_bytes", "out_bytes",
                    "collective_counts"):
            assert m[key] == r[key], (case, key)
        assert abs(m["temp_bytes"] - r["temp_bytes"]) \
            <= TEMP_TOL * r["temp_bytes"], case


def test_two_depth_extrapolation_against_the_full_depth_count():
    """qwen1.5-0.5b's smoke config on a 2x4 shape mesh, counted at depths
    2, 3, 4 and 6: the line through 2 and 4 gives depth 6's FLOPs,
    collectives and launches exactly; its bytes grow by a constant second
    difference (the zero-filled gradient of each stacked leaf, one a
    layer), so the parabola through 2, 3 and 4 gives them exactly."""
    out = _run("""
        import dataclasses, json
        from repro_torch.configs import INPUT_SHAPES, get_smoke_config
        from repro_torch.launch import dryrun as D
        from repro_torch.launch.mesh import make_shape_mesh
        from repro_torch.launch.steps import build_step

        mesh = make_shape_mesh((2, 4), ("data", "model"))
        cfg = get_smoke_config("qwen1.5-0.5b")
        shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=64,
                                    global_batch=8)
        run = D.make_run(cfg, shape, mesh)
        counts = {d: build_step(D._reduced_depth(cfg, d), run, shape,
                                mesh).account() for d in (2, 3, 4, 6)}
        ext = D.extrapolate([counts[2], counts[4]], (2, 4), 6)
        print(json.dumps({"counts": counts, "ext": ext}))
    """)
    c = {int(k): v for k, v in out["counts"].items()}
    ext = out["ext"]
    for key in ("flops", "product_flops", "collectives",
                "collective_counts", "launches", "arg_bytes", "out_bytes"):
        assert ext[key] == c[6][key], key
    b = [c[d]["bytes"] for d in (2, 3, 4)]
    second = b[2] - 2 * b[1] + b[0]
    assert second > 0
    # f(6) = f(2) + 4 (f(3) - f(2)) + 6 (second difference)
    assert c[6]["bytes"] == b[0] + 4 * (b[1] - b[0]) + 6 * second
    assert ext["bytes"] < c[6]["bytes"]


# --- each kernel's meta route and work ---------------------------------------


def _old_bound_terms():
    """``chip_smoke.py``'s formulas before the kernels' ``work``: (flops,
    bytes) of each kernel, by name, as functions of its inputs."""
    def k1(n, m):
        return (2 * m + 7) * n, (m + 4) * 4 * n + 4 * m

    def k2(ps, gs):
        return (7 * sum(p.numel() for p in ps),
                sum(p.numel() * (2 * p.element_size() + g.element_size() + 8)
                    for p, g in zip(ps, gs)))

    def k3(q, k, causal):
        b, sq, hq, hd = q.shape
        skv = k.shape[1]
        if causal:
            n = min(sq, skv)
            pairs = n * (n + 1) // 2 + (sq - n) * skv
        else:
            pairs = sq * skv
        return (4 * b * hq * hd * pairs,
                (2 * q.numel() + 2 * k.numel()) * q.element_size())

    def k4(ins):
        dt, _, b_t, _, _, h0 = ins
        b, t, di = dt.shape
        return (b * t * di * (6 * b_t.shape[2] + 1),
                sum(z.numel() * z.element_size() for z in ins)
                + 4 * dt.numel() + 4 * h0.numel())

    def k5(r, s0):
        b, t, h, hd = r.shape
        return (b * t * h * (5 * hd * hd + 5 * hd),
                4 * (5 * r.numel() + h * hd + 2 * s0.numel()))

    return k1, k2, k3, k4, k5


def _inputs(name, device, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)

    def r(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=g).to(dt).to(device)

    if name == "server_step":
        return (r(1000), r(4, 1000), r(1000).abs(), r(4).abs()), {"lr": 0.1}
    if name == "adagrad":
        return ([r(300, dt=dtype), r(7, dt=dtype)],
                [r(300), r(7)], [r(300).abs(), r(7).abs()]), {"lr": 0.1}
    if name == "flash_attention":
        return (r(2, 65, 4, 32, dt=dtype), r(2, 65, 2, 32, dt=dtype),
                r(2, 65, 2, 32, dt=dtype)), {"window": 16}
    if name == "mamba":
        return (r(2, 5, 64).abs(), r(2, 5, 64, dt=dtype),
                r(2, 5, 16, dt=dtype), r(2, 5, 16, dt=dtype),
                -r(64, 16).abs(), r(2, 64, 16)), {}
    return (r(2, 5, 2, 32, dt=dtype), r(2, 5, 2, 32, dt=dtype),
            r(2, 5, 2, 32, dt=dtype), torch.rand(2, 5, 2, 32, generator=g)
            .to(device), r(2, 32), r(2, 2, 32, 32)), {}


KERNEL_CALLS = {"server_step": (server_step_update, server_step_update),
                "adagrad": (adagrad_update_leaves, adagrad_update_leaves),
                "flash_attention": (flash_attention, flash_attention),
                "mamba": (mamba_scan, mamba_scan), "rwkv6": (wkv, wkv)}


@pytest.mark.parametrize("name,dtype", [
    (name, dtype) for name in sorted(KERNEL_CALLS)
    for dtype in ((torch.float32,) if name == "server_step"   # f32 only
                  else (torch.float32, torch.bfloat16))])
def test_kernel_meta_route_gives_the_cpu_route_shapes(name, dtype):
    """On meta tensors each wrapper returns what its CPU route returns in
    shape and dtype, counts one meta launch (never a launch) and runs
    nothing."""
    fn, counter = KERNEL_CALLS[name]
    args, kw = _inputs(name, "cpu", dtype)
    want = fn(*args, **kw)
    meta_args, _ = _inputs(name, "meta", dtype)
    before = (counter.launches, counter.meta_launches)
    got = fn(*meta_args, **kw)
    assert (counter.launches, counter.meta_launches) == (before[0],
                                                         before[1] + 1)
    flat = (lambda t: [x for y in t for x in (y if isinstance(y, list)
                                              else [y])])
    for g, w in zip(flat(got), flat(want)):
        assert g.is_meta and g.shape == w.shape and g.dtype == w.dtype


def test_kernel_work_gives_the_smoke_scripts_old_numbers():
    k1, k2, k3, k4, k5 = _old_bound_terms()
    p, gs = torch.empty(609_258, device="meta"), torch.empty(
        4, 609_258, device="meta")
    assert k1_work(p, gs, None, None) == k1(609_258, 4)
    ps = [torch.empty(n, dtype=dt, device="meta")
          for n, dt in ((300, torch.float32), (7, torch.bfloat16))]
    grads = [torch.empty(n, device="meta") for n in (300, 7)]
    assert k2_work(ps, grads) == k2(ps, grads)
    for dtype in (torch.float32, torch.bfloat16):
        for (b, sq, skv, hq, hkv, hd), causal in (
                ((4, 512, 512, 32, 8, 128), True),
                ((4, 64, 1500, 12, 12, 64), False),
                ((2, 100, 37, 8, 2, 128), True)):
            q = torch.empty(b, sq, hq, hd, dtype=dtype, device="meta")
            k = torch.empty(b, skv, hkv, hd, dtype=dtype, device="meta")
            assert k3_work(q, k, k, causal=causal) == k3(q, k, causal)
    ins = tuple(torch.empty(s, device="meta") for s in (
        (4, 512, 16384), (4, 512, 16384), (4, 512, 16), (4, 512, 16),
        (16384, 16), (4, 16384, 16)))
    assert k4_work(*ins) == k4(ins)
    r = torch.empty(4, 512, 32, 64, device="meta")
    s0 = torch.empty(4, 32, 64, 64, device="meta")
    assert k5_work(r, r, r, r, torch.empty(32, 64, device="meta"),
                   s0) == k5(r, s0)


def test_attention_work_counts_the_window():
    """The pairs a sliding window leaves, counted query by query."""
    q = torch.empty(1, 50, 2, 32, device="meta")
    for causal, window in ((True, 0), (True, 7), (False, 9)):
        want = sum(1 for i in range(50) for j in range(50)
                   if (j <= i or not causal) and (
                       window == 0 or j > i - window))
        assert k3_work(q, q, q, causal=causal, window=window)[0] \
            == 4 * 2 * 32 * want


# --- the production meshes and the CLI ----------------------------------------


def test_production_meshes_are_shape_only_and_refuse_a_real_group(
        tmp_path):
    out = _run("""
        import json
        from repro_torch.launch.mesh import make_production_mesh
        one = make_production_mesh()
        two = make_production_mesh(multi_pod=True)
        print(json.dumps({"one": [list(one.shape), one.mesh_dim_names],
                          "two": [list(two.shape), two.mesh_dim_names],
                          "sizes": [one.size(), two.size()]}))
    """)
    assert out["one"] == [[16, 16], ["data", "model"]]
    assert out["two"] == [[2, 16, 16], ["pod", "data", "model"]]
    assert out["sizes"] == [256, 512]
    refused = _run(f"""
        import json, torch.distributed as dist
        from repro_torch.launch.mesh import make_production_mesh
        dist.init_process_group("gloo", store=dist.FileStore(
            {str(tmp_path / "store")!r}, 1), rank=0, world_size=1)
        try:
            make_production_mesh()
            msg = None
        except RuntimeError as e:
            msg = str(e)
        dist.destroy_process_group()
        print(json.dumps({{"msg": msg}}))
    """)
    assert refused["msg"] and "real 'gloo'" in refused["msg"]


#: the keys of a JAX dry-run record (``src/repro/launch/dryrun.py``'s
#: ``run_one``), besides ``Roofline.as_dict``'s
JAX_RECORD_KEYS = {"arch", "shape", "strategy", "mesh", "chips", "compile_s",
                   "arg_bytes_per_device", "out_bytes_per_device",
                   "temp_bytes_per_device", "peak_bytes_per_device",
                   "collectives", "collective_counts"}


def test_cli_writes_a_record_with_every_key_of_the_jax_record(tmp_path):
    from repro.launch.hlo_analysis import Roofline as JaxRoofline
    path = tmp_path / "dry.jsonl"
    env = dict(os.environ, PYTHONPATH="src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-4b", "--shape", "train_4k", "--out", str(path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "1 OK, 0 failed" in r.stdout
    rec = json.loads(path.read_text().splitlines()[0])
    want = JAX_RECORD_KEYS | set(JaxRoofline(1.0, 1.0, 1.0, 1).as_dict())
    assert want <= set(rec)
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["peak_bytes_per_device"] > rec["arg_bytes_per_device"] > 0
    assert rec["launches"]["adagrad"] == 2
    assert np.isfinite(rec["t_compute_s"]) and rec["flops"] > 0


def test_cli_sweep_runs_each_combo_in_a_child_within_its_limit(tmp_path):
    """``--all`` over one arch's and one shape's combos, ``--limit``: each
    combo in a child process, its record written."""
    path = tmp_path / "sweep.jsonl"
    env = dict(os.environ, PYTHONPATH="src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--arch", "whisper-small", "--shape", "long_500k", "--full-depth",
         "--limit", "100", "--out", str(path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=150)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("whisper-small x long_500k") == 1
    assert "1 OK, 0 failed" in r.stdout
    (rec,) = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert (rec["arch"], rec["shape"], rec["chips"]) == (
        "whisper-small", "long_500k", 256)
    assert rec["accounting_depths"] is None        # counted at full depth
