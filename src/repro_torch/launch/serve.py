"""Serving driver: batched prefill + greedy decode with the KV-cache/state
path, the port of ``repro.launch.serve``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --batch 4 --prompt-len 64 --gen 32            # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --smoke --device cpu                         # anywhere
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.sharding.spec import values_tree


def generate(api, params, prompts, *, gen: int, extra_inputs=None):
    """Greedy decode ``gen`` tokens after one batched prefill.

    prompts: (B, S) int on the params' device.  Returns (B, gen) int32."""
    if extra_inputs:
        raise NotImplementedError(
            "extra inputs (vlm patches, encdec frames) come with later "
            "slices of the port (ROADMAP.md, Queue 1 item 6)")
    cfg = api.cfg
    s = prompts.shape[1]
    with torch.inference_mode():
        logits, cache = api.prefill(params, {"tokens": prompts},
                                    cache_len=s + gen)
        out = []
        tok = logits[:, :, :cfg.vocab_size].argmax(-1).to(torch.int32)
        for i in range(gen):
            out.append(tok[:, 0])
            logits, cache = api.decode_step(params, cache, tok, s + i)
            tok = logits[:, :, :cfg.vocab_size].argmax(-1).to(torch.int32)
        return torch.stack(out, dim=1)


def main(argv=None):
    """CLI entry: serve a model (prefill + decode loop) from a config id."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_arch_config(args.arch))
    api = build_model(cfg, compute_dtype=torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = values_tree(api.init(gen))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    ).to(device=dev, dtype=torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    toks = generate(api, params, prompts, gen=args.gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"generated {tuple(toks.shape)} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) on {where}")
    print("sample:", toks[0][:16].cpu().numpy())


if __name__ == "__main__":
    main()
