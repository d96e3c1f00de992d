"""The training cells' loop: the program's training step, as
``launch.train.train_loop`` runs it (``launch.steps.train_parts``'s step
through ``launch.graphs.StepGraph``: the first step eager, the second
captured as one CUDA graph and replayed, every later one a replay), fed
one batch after another.

Set-up builds the one ``StepGraph`` from weights drawn from the seed,
and drives it through the first ``compare_steps`` steps (the eager step,
the capture, replays; past the stale head's first refresh where the mix
asks for it): the steps the check follows.  The window then runs whole
steps on the same object until its seconds have passed.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import statistics

import torch

from bench.core import traffic, weights
from bench.reference import common


def arch_config(config: dict):
    """The program's ``ArchConfig`` of a configuration file's ``arch``."""
    from repro_torch.configs.base import (ArchConfig, MambaConfig,
                                          MoEConfig, RWKVConfig)
    nested = {"moe": MoEConfig, "mamba": MambaConfig, "rwkv": RWKVConfig}
    arch = {k: nested[k](**v) if k in nested else v
            for k, v in config["arch"].items()}
    return ArchConfig(**arch)


def model_dims(config: dict) -> dict:
    """The sizes the reference and the work counts read: the ``arch``
    and the sizes the program fixes in code (``fixed``)."""
    return dict(config["arch"], **config.get("fixed", {}))


def _half_batch(batch):
    mask = batch["mask"].clone()
    mask[mask.shape[0] // 2:] = 0
    return dict(batch, mask=mask)


class TrainLoop:
    """``setup()``, ``step()`` (one whole step of the window, finished on
    the device), ``release()`` and ``numbers()`` (the check)."""

    def __init__(self, cell, seed: int, device, faults=()):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.mix, self.dims = cell.mix, model_dims(cell.config)
        self.layout = cell.reference.layout(self.dims)
        self.faults = set(faults)
        self.losses, self.window_losses = [], []
        self.i = 0

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.configs.base import InputShape, RunConfig
        from repro_torch.launch.graphs import StepGraph
        from repro_torch.launch.steps import train_parts

        mix = self.mix
        cfg = arch_config(self.cell.config)
        run = RunConfig(arch=cfg.name, strategy=mix["strategy"],
                        optimizer="adagrad", learning_rate=mix["lr"],
                        adagrad_beta=mix["adagrad_beta"],
                        compute_dtype=self.cell.config["dtype"],
                        head_sync_period=mix["head_sync_period"],
                        seed=self.seed)
        shape = InputShape("custom", mix["seq"], mix["batch"], "train")
        _, init_all, step_fn = train_parts(cfg, run, shape)
        step_fn = self._planted(step_fn)
        self.batches = traffic.train_batches(mix, cfg.vocab_size, self.seed,
                                             self.device)
        state = init_all(params=weights.make(self.layout, self.seed,
                                             self.device),
                         batch=self.batches[0])
        self.graph = StepGraph(step_fn, state)
        del state
        for i in range(mix["compare_steps"]):
            new, out = self.graph(self.batches[i])
            self.losses.append(float(out["loss"]))
            if i == 0:
                self.grads = {
                    common.name(p): float(a.sum().sqrt())
                    for p, a in common.flat(dict(new.opt_state["acc"],
                                                 **new.head_opt_state["acc"]))}
        self.i = mix["compare_steps"]
        new = self.graph.new
        self.change = self._change(dict(new.params, **new.head))
        self.stale = self._change(new.head_stale)

    def _change(self, tree) -> dict:
        """The norm of each leaf's change from the seed's weights."""
        out = {}
        for path, v in common.flat(tree):
            start = weights.leaf(self.layout, self.seed, path, self.device)
            out[common.name(path)] = float((v - start).norm())
            del start
        return out

    def _planted(self, step_fn):
        """The step with the faults a test plants in it."""
        if "frozen_refresh" in self.faults:
            fresh = step_fn

            def step_fn(state, batch):
                new, out = fresh(state, batch)
                return dataclasses.replace(
                    new, head_stale=state.head_stale), out
        if "state_unchanged" in self.faults:
            inner = step_fn

            def step_fn(state, batch):
                return state, inner(state, batch)[1]
        if "half_batch" in self.faults:
            whole = step_fn

            def step_fn(state, batch):
                return whole(state, _half_batch(batch))
        return step_fn

    # -- the window --------------------------------------------------------

    def step(self) -> None:
        b = self.batches[self.i % len(self.batches)]
        _, out = self.graph(b)
        self.window_losses.append(float(out["loss"]))   # waits for the step
        self.i += 1

    def work(self, steps: int) -> dict:
        tokens = steps * self.mix["batch"] * self.mix["seq"]
        return {"tokens": tokens, "attempted": steps,
                "failed": sum(not math.isfinite(x)
                              for x in self.window_losses)}

    def release(self) -> None:
        self.graph = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def numbers(self) -> dict:
        """The program's first steps against the reference's, on the same
        weights and batches: the worst relative gap of a step's loss, of a
        leaf's first gradient and of a leaf's change over the steps."""
        ref = reference_steps(self.cell, self.dims, self.layout, self.seed,
                              self.batches[:self.mix["compare_steps"]],
                              self.device, "f32")
        return gaps({"losses": self.losses, "grads": self.grads,
                     "change": self.change, "stale": self.stale}, ref)


def reference_steps(cell, dims, layout, seed, batches, device, prec: str,
                    **kw):
    """The reference's split_concurrent steps from the seed's weights, in
    precision ``prec``: ``common.split_concurrent``'s dict."""
    mix = cell.mix
    params = weights.make(layout, seed, device)
    with common.precision(prec, device):
        out = common.split_concurrent(
            cell.reference.Model(dims), params, batches, lr=mix["lr"],
            beta=mix["adagrad_beta"],
            head_sync_period=mix["head_sync_period"], **kw)
    del params
    gc.collect()
    return out


def _leaf_gaps(prog: dict, ref: dict, kept) -> list:
    """Each leaf's gap between the program's norm and the reference's,
    over the reference's norm or the median leaf's, whichever is larger,
    of the leaves ``kept``."""
    med = statistics.median(ref[k] for k in kept)
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in kept]


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers a training cell may compare (its limits file names
    those it does), of the program's steps (``prog``: ``losses``,
    ``grads``, ``change``, ``stale``) against the reference's: the worst
    step's relative loss gap and the first step's; the worst leaf's gap
    of the first gradient; the worst leaf's and the median leaf's gap of
    the change over the steps; and the worst gap of the stale head's
    change, over the reference's (0 where the steps hold no refresh; a
    refresh left out reads 1).  A leaf whose reference gradient is under
    a thousandth of the median leaf's is left out: of the first gradient
    by its first gradient (the server's head has none at step 0, by the
    split rule), of the change by all its gradients together."""
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                ref["losses"])]
    med_first = statistics.median(ref["grads"].values())
    med_every = statistics.median(ref["every"].values())
    first = [k for k, g in ref["grads"].items() if g >= 1e-3 * med_first]
    moved = [k for k, g in ref["every"].items()
             if g >= 1e-3 * med_every and k in ref["change"]]
    moves = _leaf_gaps(prog["change"], ref["change"], moved)
    stale = [abs(prog["stale"][k] - r) / r
             for k, r in ref["stale"].items() if r > 0]
    return {"loss_gap": max(loss), "first_loss_gap": loss[0],
            "grad_gap": max(_leaf_gaps(prog["grads"], ref["grads"], first)),
            "change_gap": max(moves),
            "median_change_gap": statistics.median(moves),
            "stale_head_gap": max(stale, default=0.0)}


__all__ = ["TrainLoop", "arch_config", "gaps", "model_dims",
           "reference_steps"]
