"""Model factory: one API over the architecture families the port runs.

The port of ``repro.models.model``.  ``build_model(cfg)`` returns a
``ModelApi`` with:

  init(generator)              -> Param tree on the generator's device
  train_loss(params, batch)    -> (loss, metrics)   [full values tree]
  forward_features(params, batch) -> (logits, aux, features)
  head_logits(params, features)   -> logits
  prefill(params, batch)       -> (logits, cache)
  decode_step(params, cache, token, index) -> (logits, cache)
                               [index: a host int or a 0-d int32 tensor]
  init_cache(batch, cache_len) -> cache tree
  batch_spec(shape)            -> {name: (shape, dtype)} of the inputs

Every LM family is ported, dispatched on ``cfg.family`` as the JAX
factory does: ``dense``, ``moe`` and ``vlm`` (``transformer``), ``ssm``
(``rwkv``), ``hybrid`` (``hybrid``: Mamba, attention and MoE) and
``encdec`` (``encdec``).  A ``vlm`` batch carries ``patches`` (B, P, D),
an ``encdec`` batch ``frames`` (B, T_enc, D).  Every family trains
(``train_loss``, and ``forward_features(differentiable=True)``): the
training forward runs attention, the WKV and the selective scan in torch
ops, as the JAX package's training paths run jnp ops, since the kernels
(K3-K5) have no backward.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import encdec, hybrid, rwkv, transformer
from repro_torch.sharding.collectives import (local_in, local_out, max_over,
                                              shard_offset, sharding_axes,
                                              sum_over)
from repro_torch.sharding.spec import is_dtensor, values_tree
from repro_torch.tree import as_tensor, tree_flatten

def lm_loss(logits, labels, mask):
    """Token-mean masked cross-entropy; labels: (B,S) int, mask (B,S).
    Logits on a mesh take :func:`_lm_loss_sharded`."""
    if is_dtensor(logits):
        return _lm_loss_sharded(logits, labels, mask)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1.0)


def _lm_loss_sharded(logits, labels, mask):
    """:func:`lm_loss` of DTensor logits, vocab-parallel, as GSPMD
    partitions the JAX package's (DTensor's ``gather`` along a sharded
    dimension leaves a masked partial that it then fails to reduce): each
    rank keeps its batch and vocab shard of the logits; the logsumexp
    takes its max and its sum of exps over the mesh axes that shard the
    vocab, and the label's logit comes from the shard that holds it."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = logits.device_mesh
    pl = tuple(q if q in (Shard(0), Shard(2)) else Replicate()
               for q in logits.placements)
    rows_pl = tuple(q if q == Shard(0) else Replicate() for q in pl)
    vocab = sharding_axes(pl, mesh, 2)
    lg = local_in(logits, mesh, pl).float()
    m = max_over(lg.amax(-1), mesh, vocab)
    lse = torch.log(sum_over(torch.exp(lg - m[..., None]).sum(-1), mesh,
                             vocab)) + m
    at = (local_in(labels, mesh, rows_pl).long()
          - shard_offset(logits, 2, pl))
    mine = (at >= 0) & (at < lg.shape[-1])
    picked = torch.gather(lg, -1, at.clamp(0, lg.shape[-1] - 1)[..., None])
    gold = sum_over(torch.where(mine, picked[..., 0], 0.0), mesh, vocab)
    return _token_mean(lse - gold, mask, mesh, rows_pl)


def _token_mean(nll, mask, mesh, rows_pl):
    """The masked token mean of each rank's ``nll`` (its batch shard under
    ``rows_pl``), its sums summed over the mesh axes that shard the
    batch: a scalar DTensor, replicated."""
    from torch.distributed.tensor import Replicate
    batch = sharding_axes(rows_pl, mesh, 0)
    msk = local_in(mask, mesh, rows_pl)
    loss = (sum_over((nll * msk).sum(), mesh, batch)
            / sum_over(msk.sum(), mesh, batch).clamp_min(1.0))
    return local_out(loss, mesh, (Replicate(),) * mesh.ndim)


def _chunk_logsumexp(m, ssum, gold, feats, w_c, labels, off: int):
    """One vocab chunk of :func:`lm_loss_chunked`: its logits folded into
    the running max ``m``, sum ``ssum`` and label logit ``gold``."""
    vc = w_c.shape[1]
    logits = (feats @ w_c.to(feats.dtype)).float()
    m_new = torch.maximum(m, logits.amax(-1))
    ssum = ssum * torch.exp(m - m_new) + torch.exp(
        logits - m_new[..., None]).sum(-1)
    local = labels.long() - off
    in_chunk = (local >= 0) & (local < vc)
    picked = torch.gather(logits, -1, local.clamp(0, vc - 1)[..., None])
    return m_new, ssum, torch.where(in_chunk, picked[..., 0], gold)


def lm_loss_chunked(feats, head_w, labels, mask, *, n_chunks: int = 8):
    """Cross-entropy without materialising the (B, S, V) logits tensor.

    Loops over vocab chunks of the head matmul with an online logsumexp
    (running max and sum) and picks the label logit from whichever chunk
    owns it; each chunk runs under ``torch.utils.checkpoint``, so the
    backward pass recomputes its logits and peak logits memory is
    V/n_chunks of :func:`lm_loss`'s.  feats: (B,S,D); head_w: (D,V).  A
    head on a mesh takes :func:`_lm_loss_chunked_sharded`."""
    if is_dtensor(head_w):
        return _lm_loss_chunked_sharded(feats, head_w, labels, mask,
                                        n_chunks)
    b, s, _ = feats.shape
    v = head_w.shape[1]
    if v % n_chunks:
        raise ValueError(f"vocab {v} is not a multiple of n_chunks "
                         f"{n_chunks}")
    vc = v // n_chunks
    dev = feats.device
    m = torch.full((b, s), -1e30, dtype=torch.float32, device=dev)
    ssum = torch.zeros((b, s), dtype=torch.float32, device=dev)
    gold = torch.zeros((b, s), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        m, ssum, gold = checkpoint(_chunk_logsumexp, m, ssum, gold, feats,
                                   head_w[:, c * vc:(c + 1) * vc], labels,
                                   c * vc, use_reentrant=False,
                                   preserve_rng_state=False)
    lse = torch.log(ssum.clamp_min(1e-30)) + m
    nll = (lse - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1.0)


def _lm_loss_chunked_sharded(feats, head_w, labels, mask, n_chunks: int):
    """:func:`lm_loss_chunked` with the head on a mesh, vocab-parallel:
    each rank runs the chunked online logsumexp over its own vocab shard
    of the head (gathered along ``head_embed`` alone) in chunks of
    V/``n_chunks`` columns, for its batch shard of ``feats``; the ranks'
    running maxima and sums are then combined over the mesh axes that
    shard the vocab, as :func:`_lm_loss_sharded` combines its shards."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = head_w.device_mesh
    rows_pl = tuple(Shard(0) if q == Shard(0) else Replicate()
                    for q in (feats.placements if is_dtensor(feats)
                              else (Replicate(),) * mesh.ndim))
    w_pl = tuple(Shard(1) if q == Shard(1) and r != Shard(0)
                 else Replicate() for q, r in zip(head_w.placements, rows_pl))
    vocab = sharding_axes(w_pl, mesh, 1)
    f, w = local_in(feats, mesh, rows_pl), local_in(head_w, mesh, w_pl)
    v = head_w.shape[1]
    if v % n_chunks:
        raise ValueError(f"vocab {v} is not a multiple of n_chunks "
                         f"{n_chunks}")
    vc = v // n_chunks
    if w.shape[1] % vc:
        raise ValueError(f"a vocab shard of {w.shape[1]} is not a multiple "
                         f"of the chunk {vc}")
    lo = shard_offset(head_w, 1, w_pl)
    lab = local_in(labels, mesh, rows_pl)
    b, s, _ = f.shape
    m = torch.full((b, s), -1e30, dtype=torch.float32, device=f.device)
    ssum = torch.zeros((b, s), dtype=torch.float32, device=f.device)
    gold = torch.zeros((b, s), dtype=torch.float32, device=f.device)
    for c0 in range(0, w.shape[1], vc):
        m, ssum, gold = checkpoint(_chunk_logsumexp, m, ssum, gold, f,
                                   w[:, c0:c0 + vc], lab, lo + c0,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    top = max_over(m, mesh, vocab)
    lse = torch.log(sum_over(ssum * torch.exp(m - top), mesh,
                             vocab).clamp_min(1e-30)) + top
    return _token_mean(lse - sum_over(gold, mesh, vocab), mask, mesh,
                       rows_pl)


@dataclass
class ModelApi:
    cfg: ArchConfig
    init: Callable[..., Any]
    train_loss: Callable[..., Any]
    forward_features: Callable[..., Any]   # pre-head hidden states
    head_logits: Callable[..., Any]        # features -> logits
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Any]
    batch_spec: Callable[..., Any]


_MODULES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "ssm": rwkv, "hybrid": hybrid, "encdec": encdec}


def _module(cfg: ArchConfig):
    if cfg.family not in _MODULES:
        raise ValueError(f"no LM assembly for family {cfg.family!r}")
    return _MODULES[cfg.family]


def _text_len(cfg: ArchConfig, seq_len: int) -> int:
    """The text tokens of a sequence of ``seq_len`` positions (a vlm
    sequence starts with its ``num_patches`` patch positions)."""
    return seq_len - cfg.num_patches if cfg.family == "vlm" else seq_len


def build_model(cfg: ArchConfig, *, compute_dtype=torch.bfloat16,
                remat: bool = True, loss_chunks: int = 0) -> ModelApi:
    """``remat``: the training forward recomputes each block in the
    backward pass.  ``loss_chunks`` > 1: ``train_loss`` takes
    :func:`lm_loss_chunked` over that many vocab chunks."""
    mod = _module(cfg)

    def init(generator):
        return mod.init_model(generator, cfg)

    def _fwd_kwargs(batch):
        if cfg.family == "vlm":
            return {"patches": batch["patches"]}
        if cfg.family == "encdec":
            return {"frames": batch["frames"]}
        return {}

    def forward_features(params, batch, *, window=None,
                         compute_logits=True, differentiable=False):
        """Backbone forward up to the pre-head hidden states;
        ``differentiable`` for a pass autograd can differentiate (torch
        ops where the kernels would run, each block recomputed in the
        backward pass under ``remat``)."""
        return mod.forward_train(params, cfg, batch["tokens"],
                                 dtype=compute_dtype, window=window,
                                 compute_logits=compute_logits,
                                 remat=remat, differentiable=differentiable,
                                 **_fwd_kwargs(batch))

    def head_logits(params, feats):
        return L.lm_logits(params["head"], params["embed"], cfg, feats)

    def train_loss(params, batch, *, window=None):
        if loss_chunks > 1:
            # fused vocab-chunked head and loss: full logits never made
            _, aux, feats = forward_features(params, batch, window=window,
                                             compute_logits=False,
                                             differentiable=True)
            if cfg.family == "vlm":      # loss on the text positions only
                feats = feats[:, cfg.num_patches:]
            head_w = (params["embed"]["table"].T if cfg.tie_embeddings
                      else params["head"]["w"])
            loss = lm_loss_chunked(feats, head_w, batch["labels"],
                                   batch["mask"], n_chunks=loss_chunks)
            return loss + aux, {"loss": loss, "aux": aux}
        logits, aux, _ = forward_features(params, batch, window=window,
                                          differentiable=True)
        if cfg.family == "vlm":          # loss on the text positions only
            logits = logits[:, cfg.num_patches:]
        loss = lm_loss(logits, batch["labels"], batch["mask"])
        return loss + aux, {"loss": loss, "aux": aux}

    def prefill(params, batch, *, window=None, cache_len=None,
                full=L.full_whole):
        return mod.prefill(params, cfg, batch["tokens"], dtype=compute_dtype,
                           window=window, cache_len=cache_len, full=full,
                           **_fwd_kwargs(batch))

    def decode_step(params, cache, token, index, *, window=None):
        return mod.decode_step(params, cfg, cache, token, index,
                               dtype=compute_dtype, window=window)

    def init_cache(batch, cache_len, *, window=None, device="cuda"):
        return mod.init_cache(cfg, batch, cache_len, window=window,
                              dtype=compute_dtype,
                              device=resolve_device(device))

    def batch_spec(shape: InputShape, *, global_batch=None):
        b = global_batch or shape.global_batch
        s_text = _text_len(cfg, shape.seq_len)
        spec = {"tokens": ((b, s_text), torch.int32)}
        if shape.kind == "train":
            spec["labels"] = ((b, s_text), torch.int32)
            spec["mask"] = ((b, s_text), torch.float32)
        if cfg.family == "vlm":
            spec["patches"] = ((b, cfg.num_patches, cfg.d_model),
                               torch.float32)
        if cfg.family == "encdec":
            spec["frames"] = ((b, cfg.encoder_seq_len, cfg.d_model),
                              torch.float32)
        return spec

    return ModelApi(cfg=cfg, init=init, train_loss=train_loss,
                    forward_features=forward_features,
                    head_logits=head_logits, prefill=prefill,
                    decode_step=decode_step, init_cache=init_cache,
                    batch_spec=batch_spec)


def _shapes(cfg: ArchConfig) -> dict:
    """{path: (shape, dtype)} of the model's values, made on the meta
    device (nothing allocated)."""
    leaves, tdef = tree_flatten(values_tree(_module(cfg).init_model(None,
                                                                    cfg)))
    return dict(zip(_paths(tdef), ((tuple(x.shape), x.dtype)
                                   for x in leaves)))


def _paths(tdef, prefix=""):
    if tdef.kind == "leaf":
        return [prefix]
    keys = tdef.keys if tdef.kind is dict else range(len(tdef.children))
    return [p for k, c in zip(keys, tdef.children)
            for p in _paths(c, f"{prefix}/{k}")]


def count_params_analytic(cfg: ArchConfig, active_only: bool = False) -> int:
    """The number of parameters of the real init, counted on the meta
    device.  ``active_only``: MoE expert weights (the ``w_*`` leaves under
    a ``moe`` key) counted at k/E of their size."""
    total = expert = 0
    for path, (shape, _) in _shapes(cfg).items():
        n = 1
        for dim in shape:
            n *= dim
        total += n
        keys = path.split("/")
        if "moe" in keys and any(k.startswith("w_") for k in keys):
            expert += n
    if active_only and cfg.is_moe and expert:
        frac = cfg.moe.num_experts_per_tok / cfg.moe.num_experts
        return int(total - expert * (1.0 - frac))
    return total


def params_from_numpy(cfg: ArchConfig, tree, device="cuda"):
    """A JAX values tree (``values_tree`` of the JAX package's init, as
    numpy; bf16 as numpy's bfloat16 or through the int16 view of
    ``repro_torch.tree``) as the port's tree of tensors on ``device``.
    Every key, shape and dtype is checked against the port's own init; a
    mismatch raises ``ValueError``."""
    dev = resolve_device(device)
    want = _shapes(cfg)
    leaves, tdef = tree_flatten(tree)
    got = dict(zip(_paths(tdef), leaves))
    if set(got) != set(want):
        raise ValueError(
            f"param keys differ from {cfg.name}'s: missing "
            f"{sorted(set(want) - set(got))}, unexpected "
            f"{sorted(set(got) - set(want))}")
    out = []
    for path, leaf in got.items():
        t = as_tensor(leaf)
        if (tuple(t.shape), t.dtype) != want[path]:
            raise ValueError(
                f"{path}: got {tuple(t.shape)} {t.dtype}, {cfg.name} has "
                f"{want[path][0]} {want[path][1]}")
        out.append(t.to(dev))
    return tdef.unflatten(out)


__all__ = ["ModelApi", "build_model", "count_params_analytic", "lm_loss",
           "lm_loss_chunked", "params_from_numpy"]
