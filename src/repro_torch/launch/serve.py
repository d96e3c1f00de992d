"""Serving driver: batched prefill + greedy decode with the KV-cache/state
path, the port of ``repro.launch.serve``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --batch 4 --prompt-len 64 --gen 32            # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --smoke --device cpu                         # anywhere
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small
                                     # 1,500 encoder frames, on the card
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

    prompts: (B, S) int on the params' device; ``extra_inputs`` go into the
    prefill's batch (vlm ``patches`` (B, P, D), encdec ``frames``).
    Returns (B, gen) int32.

    A vlm sequence starts with its P patch positions, so its cache covers
    P + S + gen positions and step i decodes at P + S + i.  The JAX
    package's ``generate`` sizes the cache S + gen and decodes at S + i,
    which overwrites prompt slots and departs from the model's own
    forward (ROADMAP.md, Queue 3, notes on the reference)."""
    cfg = api.cfg
    s = prompts.shape[1]
    if cfg.family == "vlm":
        s += cfg.num_patches
    with torch.inference_mode():
        logits, cache = api.prefill(params,
                                    dict(extra_inputs or {}, tokens=prompts),
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
    s_text = args.prompt_len - (cfg.num_patches if cfg.family == "vlm"
                                else 0)
    if s_text < 1:
        ap.error(f"--prompt-len {args.prompt_len} leaves no text after "
                 f"{cfg.num_patches} patch positions")
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, s_text))
    ).to(device=dev, dtype=torch.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = rng.normal(
            0, 0.02, (args.batch, cfg.num_patches, cfg.d_model))
    if cfg.family == "encdec":
        extra["frames"] = rng.normal(
            0, 0.02, (args.batch, cfg.encoder_seq_len, cfg.d_model))
    extra = {k: torch.from_numpy(v).to(device=dev, dtype=torch.float32)
             for k, v in extra.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    toks = generate(api, params, prompts, gen=args.gen, extra_inputs=extra)
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
