"""The sharded prefill's cache, placed as the JAX prefill's compile places
it, on 2x4 and 4x2 meshes.

The JAX bundle gives its prefill no ``out_shardings``, so XLA's
propagation places the cache: compiled on 8 forced host devices, each
leaf's ``PartitionSpec`` and per-device shard shape are read from
``compiled.output_shardings`` (a subprocess: the device-count flag must be
set before jax starts, and ``tests/conftest.py`` imports jax into every
test process).  The port's bundles run once on the meta device over
shape-only meshes of the same shapes (a subprocess with its own fake
process group), under ``StepBundle.account``.

What is held, for six smoke configs at global batch 4 and S 64 (and
qwen3-4b at batch 1, which the data axis does not divide):

* every cache leaf's placements, as mesh axes a dimension, and rank 0's
  local shape equal the JAX compile's spec and shard shape;
* the port's ``out_bytes`` (its outputs' local storage) is at most the
  compiled ``output_size_in_bytes`` (logits included on both sides);
* no rank makes the whole cache: at a cache sized for a long generation
  (``LONG_CACHE`` rows), where the cache outweighs the rest of the step,
  the storage high-water mark stays under the whole cache's bytes;
* the cache writes (``layers.write_rows``) move no collective, and (on
  the 2x4 mesh) a write of a batch- and head-sharded source into a
  batch-sharded destination gathers over ``model`` alone: its all-gather
  yields the destination's local rows, not the whole batch.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (arch, global batch) at S 64 under ``fsdp_tp``, bf16 compute
CASES = [("qwen3-4b", 4), ("qwen3-moe-30b-a3b", 4), ("internvl2-26b", 4),
         ("jamba-1.5-large-398b", 4), ("whisper-small", 4),
         ("rwkv6-1.6b", 4), ("qwen3-4b", 1)]
#: (data, model) of each mesh
MESHES = [(2, 4), (4, 2)]
SEQ = 64
#: the cache rows of the run that checks no rank made the whole cache
LONG_CACHE = 4096
IDS = [f"{a}-b{b}-{d}x{m}" for d, m in MESHES for a, b in CASES]

_COMMON = """
    import dataclasses, json
    CASES = {cases!r}
    MESHES = {meshes!r}

    def shape_of(b):
        return dataclasses.replace(INPUT_SHAPES["prefill_32k"], seq_len={seq},
                                   global_batch=b)
"""

_JAX = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.configs.base import INPUT_SHAPES, RunConfig, get_smoke_config
    from repro.launch.mesh import make_local_mesh
    from repro.launch.steps import build_prefill_step
""" + _COMMON + """
    def axes(spec, ndim):
        out = [None if e is None else (e if isinstance(e, str) else list(e))
               for e in spec]
        return out + [None] * (ndim - len(out))

    res = {{}}
    for (d, m), (arch, b) in [(x, c) for x in MESHES for c in CASES]:
        mesh = make_local_mesh(data=d, model=m)
        bundle = build_prefill_step(get_smoke_config(arch), RunConfig(
            strategy="fsdp_tp", compute_dtype="bfloat16"), shape_of(b), mesh)
        compiled = bundle.lower().compile()
        _, cache_sh = compiled.output_shardings
        _, cache = jax.eval_shape(bundle.fn, *bundle.args_sds)
        res[f"{{arch}}-b{{b}}-{{d}}x{{m}}"] = {{
            "cache": {{k: [axes(cache_sh[k].spec, len(v.shape)),
                          list(cache_sh[k].shard_shape(v.shape))]
                      for k, v in cache.items()}},
            "out_bytes": compiled.memory_analysis().output_size_in_bytes}}
    print(json.dumps(res))
"""

_PORT = """
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import INPUT_SHAPES, RunConfig, get_smoke_config
    from repro_torch.kernels import build
    from repro_torch.launch.hlo_analysis import Accounting
    from repro_torch.launch.mesh import make_shape_mesh
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import layers as L
""" + _COMMON + """
    def axes(t):
        names = t.device_mesh.mesh_dim_names
        out = [[n for n, q in zip(names, t.placements) if q == Shard(d)]
               for d in range(t.ndim)]
        return [None if not a else (a[0] if len(a) == 1 else a) for a in out]

    writes, real = [], L.write_rows

    def recording(dst, dim, rows, src):
        moved = build.ACCOUNTS[-1].collectives.bytes_by_kind
        before = dict(moved)
        real(dst, dim, rows, src)
        writes.append({{k: n - before.get(k, 0) for k, n in moved.items()
                       if n != before.get(k, 0)}})

    L.write_rows = recording
    res = {{}}
    for (d, m), (arch, b) in [(x, c) for x in MESHES for c in CASES]:
        mesh = make_shape_mesh((d, m), ("data", "model"))
        bundle = build_prefill_step(get_smoke_config(arch), RunConfig(
            strategy="fsdp_tp", compute_dtype="bfloat16"), shape_of(b), mesh)
        made, fn = [], bundle.fn
        bundle.fn = lambda *a, **k: made.append(fn(*a, **k)) or made[-1]
        writes.clear()
        counts = bundle.account()
        cache = made[-1][1]
        long = bundle.account(cache_len={long})
        res[f"{{arch}}-b{{b}}-{{d}}x{{m}}"] = {{
            "cache": {{k: [axes(v), list(v.to_local().shape)]
                      for k, v in cache.items()}},
            "out_bytes": counts["out_bytes"], "writes": list(writes),
            "long_temp_bytes": long["temp_bytes"],
            "long_whole_cache_bytes": sum(
                v.numel() * v.element_size() for v in made[-1][1].values())}}

    # a batch- and head-sharded source into a batch-sharded destination
    mesh = make_shape_mesh((2, 4), ("data", "model"))

    def meta(shape, pl):
        return DTensor.from_local(
            torch.empty([n // (2 if pl[0] == Shard(d) else 1)
                         // (4 if pl[1] == Shard(d) else 1)
                         for d, n in enumerate(shape)], device="meta"),
            mesh, pl, run_check=False)

    kv = (4, {seq}, 4, 64)
    dst = meta(kv, (Shard(0), Replicate()))
    direct = {{}}
    for name, pl in (("heads_sharded", (Shard(0), Shard(2))),
                     ("placed_as_dst", (Shard(0), Replicate()))):
        with Accounting() as acct:
            real(dst, 1, range({seq}), meta(kv, pl))
        direct[name] = acct.counts()["collectives"]
    res["direct"] = {{"writes": direct, "dst_local_bytes":
                     dst.to_local().numel() * dst.element_size()}}
    print(json.dumps(res))
"""


def _start(code: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    body = textwrap.dedent(code).format(cases=CASES, meshes=MESHES,
                                        seq=SEQ, long=LONG_CACHE)
    return subprocess.Popen([sys.executable, "-c", body], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc: subprocess.Popen, timeout: float) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, (out[-1500:], err[-3000:])
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def both():
    """(JAX compile, port meta run) of every case, the two subprocesses
    run side by side."""
    jax_proc, port_proc = _start(_JAX), _start(_PORT)
    try:
        port = _result(port_proc, 120)
    finally:
        theirs = _result(jax_proc, 180)
    return theirs, port


@pytest.mark.parametrize("case", IDS)
def test_prefill_cache_placed_as_the_jax_compile_places_it(both, case):
    """Each leaf's mesh axes a dimension and rank 0's local shape equal
    the JAX compile's ``PartitionSpec`` and shard shape: the batch over
    ``data`` and replicated over ``model`` (replicated whole where the
    data axis does not divide it), the positions replicated, Jamba's
    states' inner dimension and rwkv's WKV heads over ``model``."""
    theirs, port = both
    assert port[case]["cache"] == theirs[case]["cache"]


@pytest.mark.parametrize("case", IDS)
def test_prefill_out_bytes_at_most_the_jax_compile(both, case):
    theirs, port = both
    assert 0 < port[case]["out_bytes"] <= theirs[case]["out_bytes"]


#: the cases whose cache a maker makes (rwkv's state is the scan's output)
#: and shards (the batch of 1 is replicated, whole on every rank)
SHARDED = [c for c in IDS if "rwkv" not in c and "-b1-" not in c]


@pytest.mark.parametrize("case", SHARDED)
def test_no_rank_makes_the_whole_cache(both, case):
    """At ``LONG_CACHE`` rows the whole cache outweighs the rest of the
    step, and the storage high-water mark stays under it: each rank made
    its own shard alone."""
    c = both[1][case]
    assert c["long_temp_bytes"] < c["long_whole_cache_bytes"]


@pytest.mark.parametrize("case", [c for c in IDS if "rwkv" not in c])
def test_cache_writes_move_no_collective(both, case):
    """The k/v (and cross, and Mamba state) sources arrive placed as the
    batch-sharded cache: each write is local."""
    writes = both[1][case]["writes"]
    assert writes and all(w == {} for w in writes), writes


def test_a_head_sharded_write_gathers_over_model_alone(both):
    direct = both[1]["direct"]
    assert direct["writes"]["placed_as_dst"] == {}
    assert direct["writes"]["heads_sharded"] == {
        "all-gather": direct["dst_local_bytes"]}
