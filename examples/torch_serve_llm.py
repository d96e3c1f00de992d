"""Batched serving demo on the PyTorch port (``repro_torch``; the JAX
package's twin is ``examples/serve_llm.py``): prefill a batch of prompts,
then greedy-decode with the KV-cache/state path, for any architecture
family (``--arch``) at its smoke size.

The default, rwkv6-1.6b, runs its WKV recurrence in the WKV-6 kernel (K5)
on the card, one launch a layer for the prefill and for each decode step;
the demo prints the launch counts of every kernel.  ``--device cpu`` runs
the kernels' plain versions.

  PYTHONPATH=src python examples/torch_serve_llm.py --arch rwkv6-1.6b --gen 32
  PYTHONPATH=src python examples/torch_serve_llm.py --device cpu
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.mamba.ops import mamba_scan  # noqa: E402
from repro_torch.kernels.rwkv6.ops import wkv  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding.spec import values_tree  # noqa: E402

#: the kernels a served model can launch, by name
KERNELS = {"flash_attention": flash_attention, "rwkv6": wkv,
           "mamba": mamba_scan}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b", choices=list(ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    api = build_model(cfg, compute_dtype=torch.float32, remat=False)
    params = values_tree(api.init(torch.Generator(device=dev)
                                  .manual_seed(0)))
    rng = np.random.default_rng(0)
    s_text = args.prompt_len - (cfg.num_patches if cfg.family == "vlm"
                                else 0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, s_text)).astype(np.int32)).to(dev)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = torch.from_numpy(rng.normal(
            0, 0.02, (args.batch, cfg.num_patches, cfg.d_model)).astype(
                np.float32)).to(dev)
    if cfg.family == "encdec":
        extra["frames"] = torch.from_numpy(rng.normal(
            0, 0.02, (args.batch, cfg.encoder_seq_len, cfg.d_model)).astype(
                np.float32)).to(dev)

    print(f"serving {cfg.name} ({cfg.family}): batch={args.batch} "
          f"prompt={s_text} gen={args.gen}")
    for wrapper in KERNELS.values():
        wrapper.launches = 0
    t0 = time.time()
    toks = generate(api, params, prompts, gen=args.gen, extra_inputs=extra)
    toks = toks.cpu()
    dt = time.time() - t0
    print(f"generated {toks.shape[0]}x{toks.shape[1]} tokens in {dt:.2f}s "
          f"({args.batch*args.gen/dt:.1f} tok/s, kernel builds included)")
    print("sample tokens:", toks[0][:12].numpy())
    print("kernel launches: " + " ".join(
        f"{name}={w.launches}" for name, w in KERNELS.items())
        + f" (on {dev.type})", flush=True)
    if dev.type == "cuda" and cfg.family == "ssm":
        assert wkv.launches == (1 + args.gen) * cfg.num_layers, wkv.launches


if __name__ == "__main__":
    main()
