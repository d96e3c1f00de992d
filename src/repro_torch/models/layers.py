"""Shared transformer building blocks: norms, RoPE, GQA attention, MLPs.

The port of ``repro.models.layers``, with the same functions and the same
parameter trees: every block is ``init_*(generator, cfg) -> Param tree``
plus an apply function taking the plain-value tree.  Layouts are the JAX
package's, so weights carried across compute the same layer.

Full-sequence attention runs the flash attention kernel (K3) on the
un-repeated k and v, where the JAX package runs its query-chunked jnp path
(the same function).  K3 has no backward, so training asks for
``differentiable=True``: the torch-op port of that jnp path
(``_chunked_attend``), which autograd differentiates.  Decode attention
keeps the JAX package's torch-op equivalent of ``_attend_grouped``.
Cross-attention (the encoder-decoder's) runs K3 too over the whole
decoder sequence, non-causal with Sq != Skv; its decode against the
cached encoder K/V runs torch ops, as the JAX package's ``_attend``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.sharding.collectives import (local_in, local_out,
                                              shard_offset, sharding_axes,
                                              sum_over)
from repro_torch.sharding.spec import (Param, init_device, is_dtensor,
                                       grad_as_placed, on_local_shards,
                                       param, shard_act, shard_heads)


def checkpointed(fn, *args, enabled: bool = True):
    """``fn(*args)``; when ``enabled`` and autograd records, under
    ``torch.utils.checkpoint`` (non-reentrant), so its activations are
    recomputed in the backward pass, as the JAX package's
    ``jax.checkpoint``.  The RNG state is not saved and restored around
    the recomputation (``preserve_rng_state=False``): no training forward
    draws from a generator, and a CUDA graph capture refuses to read a
    generator's state."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def chunked_scan(chunk_fn, param_, seqs, state, chunk: int):
    """A recurrence over axis 1 of ``seqs`` as the JAX package's training
    scans run it: ``chunk_fn(param_, *seqs, state) -> (y, state)`` over
    ``chunk``-step chunks when they divide the sequence (more than one),
    each checkpointed (:func:`checkpointed`) and the state carried from
    one to the next; else in one shot.  Returns (y, the final state)."""
    s = seqs[0].shape[1]
    chunk = min(chunk, s)
    if s % chunk or s == chunk:
        return chunk_fn(param_, *seqs, state)
    ys = []
    for c0 in range(0, s, chunk):
        y, state = checkpointed(chunk_fn, param_,
                                *(z[:, c0:c0 + chunk] for z in seqs), state)
        ys.append(y)
    return torch.cat(ys, dim=1), state

ATTN_QUERY_CHUNK = 1024  # max query block for chunked attention


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg, d: int | None = None, generator=None):
    """``generator`` only places the parameters (its device; ``None``:
    the meta device)."""
    d = d or cfg.d_model
    dev = init_device(generator)
    p = {"scale": Param(torch.ones(d, device=dev), (None,))}
    if cfg.norm != "rmsnorm":
        p["bias"] = Param(torch.zeros(d, device=dev), (None,))
    return p


def apply_norm(p, cfg, x, eps: float = 1e-5):
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (xf * p["scale"]).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * p["scale"] + p["bias"]).to(x.dtype)


def _rms_head(x, scale, eps: float = 1e-6):
    """Per-head RMS norm (qk_norm) over the trailing head_dim."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions: (S,) int -> cos, sin of shape (S, head_dim/2)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, N, hd); cos/sin: (S, hd/2)."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _sinusoids(positions, d_model: int):
    """Rows ``positions`` (an int tensor) of the sinusoidal table:
    ``sin(pos * freq) | cos(pos * freq)``, f32."""
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, device=positions.device)
                     / max(half - 1, 1))
    ang = positions.float()[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions(seq_len: int, d_model: int, device=None):
    """Whisper-style fixed sinusoidal position embedding (S, D), f32."""
    return _sinusoids(torch.arange(seq_len, device=device), d_model)


def sinusoidal_position(index, d_model: int, max_len: int, device=None):
    """Row ``min(index, max_len - 1)`` of ``sinusoidal_positions(max_len,
    d_model)`` as (1, D), computed alone with the table's products (the
    decode step's position, without the whole table).  ``index`` is a
    host int (the row is filled on ``device``) or a 0-d integer tensor,
    clamped on its own device with no read to the host (a decode step's
    index under a CUDA graph, :func:`decode_index`)."""
    if isinstance(index, torch.Tensor):
        return _sinusoids(index.clamp(max=max_len - 1).reshape(1), d_model)
    row = torch.full((1,), min(index, max_len - 1), device=device)
    return _sinusoids(row, d_model)


def decode_index(index, like):
    """A decode step's ``index`` as the attention and the sinusoids take
    it: a 0-d int32 tensor on ``like``'s device, as the JAX package's
    step takes a traced ``jnp.int32`` under ``jax.jit``.  A host int is
    filled into a new one (a fill, no upload); a tensor, which must be
    0-d and int32 on that device, is used as it is, so a CUDA graph that
    captured the step reads whatever its index buffer holds at each
    replay.  Beside a DTensor ``like`` (a cache on a mesh) it is a plain
    tensor too, the same on every rank: each rank writes its own shard of
    the cache at it with tensor ops (:func:`write_row`)."""
    if isinstance(index, torch.Tensor):
        if (index.dim() or index.dtype != torch.int32
                or index.device != like.device):
            raise ValueError(
                f"a decode index tensor must be 0-d int32 on {like.device}, "
                f"got {tuple(index.shape)} {index.dtype} on {index.device}")
        return index
    return torch.full((), index, dtype=torch.int32, device=like.device)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def init_attention(generator, cfg, *, cross: bool = False):
    """``cross``: a cross-attention block (no qk-norm)."""
    hd = cfg.resolved_head_dim
    dev = init_device(generator)
    p = {
        "wq": param(generator, (cfg.d_model, cfg.num_heads, hd),
                    ("embed", "heads", None)),
        "wk": param(generator, (cfg.d_model, cfg.num_kv_heads, hd),
                    ("embed", "kv_heads", None)),
        "wv": param(generator, (cfg.d_model, cfg.num_kv_heads, hd),
                    ("embed", "kv_heads", None)),
        "wo": param(generator, (cfg.num_heads, hd, cfg.d_model),
                    ("heads", None, "embed"),
                    scale=1.0 / math.sqrt(cfg.num_heads * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = Param(torch.zeros(cfg.num_heads, hd, device=dev),
                        ("heads", None))
        p["bk"] = Param(torch.zeros(cfg.num_kv_heads, hd, device=dev),
                        ("kv_heads", None))
        p["bv"] = Param(torch.zeros(cfg.num_kv_heads, hd, device=dev),
                        ("kv_heads", None))
    if cfg.qk_norm and not cross:
        p["q_norm"] = Param(torch.ones(hd, device=dev), (None,))
        p["k_norm"] = Param(torch.ones(hd, device=dev), (None,))
    return p


def _project_heads(x, w, axis: str):
    """x (B, S, D) through w (D, N, hd) -> (B, S, N, hd): one product over
    the flattened heads, placed by ``axis`` for N heads
    (``shard_heads``) before it is split into them, so that a head count
    the mesh axis does not divide (2 kv heads on a 4-wide model axis)
    stays whole; the flattened weight's gradient comes back in its own
    placements (``grad_as_placed``) for the same reason."""
    d, n, hd = w.shape
    wf = grad_as_placed(w.to(x.dtype).reshape(d, n * hd))
    y = shard_heads(x @ wf, axis, n)
    return y.unflatten(-1, (n, hd))


def _proj_q(p, x):
    q = _project_heads(x, p["wq"], "heads")
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
    if "q_norm" in p:
        q = _rms_head(q, p["q_norm"])
    return q


def _proj_qkv(p, cfg, x, kv_input):
    k = _project_heads(kv_input, p["wk"], "kv_heads")
    v = _project_heads(kv_input, p["wv"], "kv_heads")
    if "bk" in p:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    if "k_norm" in p:
        k = _rms_head(k, p["k_norm"])
    return _proj_q(p, x), k, v


def _out_proj(p, out, dtype):
    """(B, Q, H, hd) heads through ``wo`` (H, hd, D): the sum over (H, hd)
    as one product over the flattened heads (a DTensor sharded over the
    heads flattens them, head dim first, where an einsum may not)."""
    b, q, h, hd = out.shape
    return out.reshape(b, q, h * hd) @ p["wo"].to(dtype).reshape(h * hd, -1)


def _repeat_kv(k, num_heads: int):
    """(B, S, Kv, hd) -> (B, S, H, hd) by group broadcast (the
    differentiable full-sequence path; K3 reads the un-repeated k/v by
    head index)."""
    b, s, kv, hd = k.shape
    if kv == num_heads:
        return k
    g = num_heads // kv
    return k[:, :, :, None, :].expand(b, s, kv, g, hd).reshape(
        b, s, num_heads, hd)


def _attend(q, k, v, mask, scale: float):
    """q: (B,Q,H,hd), k/v: (B,S,H,hd), mask: (Q,S) | (B,Q,S) | None."""
    scores = torch.einsum("bqhe,bshe->bhqs", q, k).float() * scale
    if mask is not None:
        mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
        scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bshe->bqhe", w.to(v.dtype), v)


def _attend_grouped(q, k, v, mask, scale: float):
    """GQA attention without materialising the KV-head repeat — the decode
    path, where cache traffic dominates.  q: (B,Q,H,hd), k/v: (B,S,Kv,hd),
    mask: (Q,S) | None."""
    b, qlen, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, qlen, kv, h // kv, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * scale
    if mask is not None:
        scores = torch.where(mask[None, None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)
    return out.reshape(b, qlen, h, hd)


def _chunked_attend(q, k, v, scale, *, causal: bool, window: int):
    """Exact attention streamed over query chunks (bounded scores memory),
    the port of the JAX package's ``_chunked_attend`` for positions
    ``arange`` on each side (self-attention, or cross-attention's Sq
    queries against Skv keys).

    With a sliding window, each query chunk attends only to a sliced
    (window + chunk)-sized KV segment, so windowed cost is O(S·(W+C)),
    not O(S²).  q: (B,Q,H,hd), k/v: (B,S,H,hd) (already repeated)."""
    b, qlen, h, hd = q.shape
    s_kv = k.shape[1]
    pos = torch.arange(max(qlen, s_kv), dtype=torch.int32, device=q.device)

    def mask_for(q0: int, n: int, k0: int, m: int):
        """(n, m) mask of queries q0.. against keys k0.."""
        qpos, kpos = pos[q0:q0 + n, None], pos[None, k0:k0 + m]
        mask = torch.ones((n, m), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kpos <= qpos)
        if window:
            mask = mask & (kpos > qpos - window)
        return mask

    chunk = min(ATTN_QUERY_CHUNK, qlen)
    windowed = bool(window) and causal and s_kv > window + chunk
    if qlen % chunk != 0 or (qlen == chunk and not windowed):
        return _attend(q, k, v, mask_for(0, qlen, 0, s_kv), scale)
    outs = []
    for q0 in range(0, qlen, chunk):
        qi = q[:, q0:q0 + chunk]
        if windowed:
            seg = window + chunk          # the KV segment a chunk can see
            start = min(max(q0 - window, 0), s_kv - seg)
            outs.append(_attend(qi, k[:, start:start + seg],
                                v[:, start:start + seg],
                                mask_for(q0, chunk, start, seg), scale))
        else:
            outs.append(_attend(qi, k, v, mask_for(q0, chunk, 0, s_kv),
                                scale))
    return torch.cat(outs, dim=1)


def attention(p, cfg, x, *, positions, causal: bool = True, window: int = 0,
              encoder_out=None, cache=None, cache_index=None,
              use_rope: bool = True, differentiable: bool = False):
    """Multi-head GQA attention.

    Modes:
      * full-sequence (train / prefill / encoder): ``cache is None``;
        ``positions`` is ``arange(S)`` (the kernel counts query and key
        positions from 0).  Returns (out, (k, v)).  K3 computes it, unless
        ``differentiable`` asks for ``_chunked_attend``'s torch ops,
        which autograd differentiates (K3 refuses inputs that require
        grad, so a training caller that forgets to ask raises).  With
        ``encoder_out`` (B, T, D) it is cross-attention: k and v are
        projected from ``encoder_out``, non-causal, without RoPE, and the
        returned (k, v) are the cross K/V a decode step reads.
      * self-attention decode: ``cache = (k, v, kv_pos)`` with k/v
        (B, S_cache, Kv, hd) and kv_pos (S_cache,) absolute positions
        (-1 = empty slot); x is (B, 1, D) and ``cache_index`` the new
        token's absolute position, a 0-d int32 tensor on x's device
        (:func:`decode_index`; a host int is filled into one).  Every use
        of it is a tensor op, with nothing read back to the host: the
        RoPE angle, the cache slot (``remainder`` for a window, ``clamp``
        otherwise), the k, v and position writes (``index_copy_`` at the
        slot) and the visibility mask; so a CUDA graph of the step
        replays at any index.  RoPE is applied *before* caching so a ring
        buffer (sliding window) stays correct.  The new k, v and position
        are written into the cache tensors in place (the JAX package
        returns updated copies); the same tensors are returned.  A cache
        on a mesh (DTensor) takes the same tensor index: each rank writes
        its own shard of the sequence (:func:`write_row`), so a graph of
        the step on a mesh replays at any index too.
      * cross-attention decode: ``cache = (k, v)``, the encoder's K/V of
        the prefill, read and returned unchanged.
    """
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)

    if cache is not None and len(cache) == 2:
        # cross decode: only q is new (the JAX package also projects k and
        # v from x here, and drops them)
        ck, cv = cache
        out = _attend(_proj_q(p, x), _repeat_kv(ck, cfg.num_heads),
                      _repeat_kv(cv, cfg.num_heads), None, scale)
        y = _out_proj(p, out, x.dtype)
        return shard_act(y, "batch", "seq", None), cache

    is_cross = encoder_out is not None
    q, k, v = _proj_qkv(p, cfg, x, encoder_out if is_cross else x)

    if cache is not None:
        ck, cv, kv_pos = cache
        s_cache = ck.shape[1]
        i = decode_index(cache_index, ck)
        pos1 = i.reshape(1)
        slot = (torch.remainder(i, s_cache) if window
                else i.clamp(max=s_cache - 1)).reshape(1).long()
        if use_rope:
            cos, sin = rope_cos_sin(pos1, hd, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        write_row(ck, 1, slot, k)
        write_row(cv, 1, slot, v)
        write_row(kv_pos, 0, slot, pos1)
        m = (kv_pos >= 0) & (kv_pos <= i)
        if window:
            m = m & (kv_pos > i - window)
        out = _attend_grouped(q, ck.to(q.dtype), cv.to(q.dtype),
                              m[None, :].expand(q.shape[1], -1), scale)
        y = _out_proj(p, out, x.dtype)
        return shard_act(y, "batch", "seq", None), (ck, cv, kv_pos)

    if positions.shape != (x.shape[1],):
        raise ValueError(f"positions must be arange(S) of shape "
                         f"({x.shape[1]},), got {tuple(positions.shape)}")
    if use_rope and not is_cross:
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if is_cross:
        causal = False
    q = shard_act(q, "batch", "seq", "heads", None)
    k = shard_act(k, "batch", "seq", "kv_heads", None)
    v = shard_act(v, "batch", "seq", "kv_heads", None)
    if differentiable:
        # independent across batch and heads: under a mesh each rank
        # attends with its own shard of both (DTensor cannot flatten a
        # sharded head dim into the products' batch)
        bh = {"batch": 0, "head": 2}
        out, = on_local_shards(
            lambda q_, k_, v_: (_chunked_attend(q_, k_, v_, scale,
                                                causal=causal,
                                                window=window),),
            q, {0: "batch", 2: "head"},
            [(q, bh), (_repeat_kv(k, cfg.num_heads), bh),
             (_repeat_kv(v, cfg.num_heads), bh)], (bh,))
    else:
        out = flash_attention_sharded(q, k, v, causal=causal, window=window)
    out = shard_act(out, "batch", "seq", "heads", None)
    y = _out_proj(p, out, x.dtype)
    return shard_act(y, "batch", "seq", None), (k, v)


def flash_attention_sharded(q, k, v, *, causal: bool, window: int):
    """K3 (``flash_attention``) on plain tensors as they are, and on
    DTensors shard by shard: its work is independent across the batch and
    the query heads, so q keeps its sharding of dims 0 (batch) and 2
    (heads) and is replicated along the rest; k and v follow q's batch
    sharding and are replicated along heads, and each rank passes the kv
    heads its q-head block reads (head h reads kv head h // (Hq/Hkv)).
    The output is placed as q.  A block of q heads that straddles kv-head
    groups unevenly is not split: q's heads are gathered then."""
    if not is_dtensor(q):
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, window=window)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    hq, hkv = q.shape[2], k.shape[2]
    group = hq // hkv
    keep = (Shard(0), Shard(2))
    q_pl = tuple(p if p in keep else Replicate() for p in q.placements)
    n_head = 1
    for j, p in enumerate(q_pl):
        if p == Shard(2):
            n_head *= mesh.size(j)
    hl = hq // n_head
    if hl % group and group % hl:
        q_pl = tuple(Replicate() if p == Shard(2) else p for p in q_pl)
        hl = hq
    kv_pl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in q_pl)
    q = q.redistribute(mesh, q_pl)
    k, v = k.redistribute(mesh, kv_pl), v.redistribute(mesh, kv_pl)
    h0 = shard_offset(q, 2)
    lo, hi = h0 // group, (h0 + hl - 1) // group + 1
    out = flash_attention(q.to_local().contiguous(),
                          k.to_local()[:, :, lo:hi].contiguous(),
                          v.to_local()[:, :, lo:hi].contiguous(),
                          causal=causal, window=window)
    return DTensor.from_local(out, mesh, q_pl, run_check=False)


def full_whole(key, shape, fill, dtype, device):
    """A cache leaf made whole on ``device``: the ``full`` the models'
    ``init_cache`` takes by default.  ``key`` names the leaf, for a maker
    that places each leaf by its own axes
    (``launch.steps.prefill_cache_full``)."""
    return torch.full(shape, fill, dtype=dtype, device=device)


def prefill_slots(positions, size: int) -> tuple:
    """A prefill's cache writes: ``(keep, slots)``, the positions kept
    (all, or the trailing window of ``size`` when the prompt is longer)
    and the cache rows they go to, ring-ordered by position.  The rows
    are host values (a ``range``, or a list for the ring), as
    :func:`write_rows` takes them: they follow from the shapes alone."""
    s = positions.shape[0]
    if size < s:
        return positions[s - size:], [p % size for p in range(s - size, s)]
    return positions, range(s)


def _src_local(dst, dim: int, src):
    """``src``'s local shard placed as DTensor ``dst`` is, whole along
    ``dim`` (a plain ``src``, the same on every rank, is split locally)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = dst.device_mesh
    pl = tuple(Replicate() if q == Shard(dim) else q for q in dst.placements)
    if is_dtensor(src):
        return src.redistribute(mesh, pl).to_local()
    return distribute_tensor(src, mesh, pl, src_data_rank=None).to_local()


def write_rows(dst, dim: int, rows, src) -> None:
    """``dst`` along ``dim`` at the rows ``rows`` (an int, a ``range`` of
    step 1, or a sequence of ints: host values) takes ``src`` (``dst``'s
    shape with ``len(rows)`` along ``dim``), in place.  For a DTensor
    ``dst`` each rank writes the rows that fall in its own shard of
    ``dim`` into its local tensor (DTensor has no in-place rule for an
    indexed write into a sharded dimension); ``src`` is first placed as
    ``dst`` is, whole along ``dim``.  A plain ``dst`` takes a slice for an
    int or a range: no index tensor to upload.  The prefill's writes: a
    decode step's, at a device index, are :func:`write_row`'s."""
    if isinstance(rows, int):
        rows = range(rows, rows + 1)
    if not is_dtensor(dst):
        at = (slice(rows.start, rows.stop) if isinstance(rows, range)
              and rows.step == 1 else torch.tensor(list(rows),
                                                   device=dst.device))
        dst[(slice(None),) * dim + (at,)] = src.to(dst.dtype)
        return
    src = _src_local(dst, dim, src)
    local = dst.to_local()
    lo = shard_offset(dst, dim)
    hi = lo + local.shape[dim]
    sel = [i for i, r in enumerate(rows) if lo <= r < hi]
    if sel:
        index = torch.tensor(sel, device=local.device)
        local.index_copy_(dim, torch.tensor([rows[i] - lo for i in sel],
                                            device=local.device),
                          src.index_select(dim, index).to(local.dtype))


def write_row(dst, dim: int, slot, src) -> None:
    """``dst`` along ``dim`` at row ``slot`` (a 1-element int64 tensor on
    ``dst``'s device, never read on the host) takes ``src`` (``dst``'s
    shape with 1 along ``dim``), in place: a decode step's cache write.
    For a DTensor ``dst`` each rank writes its own shard, with ``src``
    placed as :func:`write_rows` places it: at ``slot - lo`` clamped into
    the shard (``lo``: where the shard starts, a shape), the new row where
    the slot falls in the shard and the row already there where it does
    not (a select of the same values), so every rank's write is the same
    ops whatever the slot, and a CUDA graph of the step replays at any."""
    if not is_dtensor(dst):
        dst.index_copy_(dim, slot, src.to(dst.dtype))
        return
    src = _src_local(dst, dim, src).to(dst.dtype)
    local = dst.to_local()
    n = local.shape[dim]
    at = slot - shard_offset(dst, dim)
    inside = ((at >= 0) & (at < n)).reshape(
        [-1 if d == dim else 1 for d in range(local.dim())])
    at = at.clamp(0, n - 1)
    local.index_copy_(dim, at, torch.where(inside, src,
                                           local.index_select(dim, at)))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(generator, cfg, d_ff: int | None = None):
    d_ff = d_ff or cfg.d_ff
    p = {
        "w_up": param(generator, (cfg.d_model, d_ff), ("embed", "mlp")),
        "w_down": param(generator, (d_ff, cfg.d_model), ("mlp", "embed"),
                        scale=1.0 / math.sqrt(d_ff)),
    }
    if cfg.act == "swiglu":
        p["w_gate"] = param(generator, (cfg.d_model, d_ff),
                            ("embed", "mlp"))
    return p


def mlp_act(cfg, up, gate=None):
    if cfg.act == "swiglu":
        return F.silu(gate) * up
    if cfg.act == "gelu":
        return F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    if cfg.act == "relu2":
        return F.relu(up).square()
    raise ValueError(cfg.act)


def apply_mlp(p, cfg, x):
    h = x @ p["w_up"].to(x.dtype)
    g = x @ p["w_gate"].to(x.dtype) if cfg.act == "swiglu" else None
    h = shard_act(mlp_act(cfg, h, g), "batch", "seq", "mlp")
    return shard_act(h @ p["w_down"].to(x.dtype), "batch", "seq", None)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def init_embedding(generator, cfg):
    return {
        "table": param(generator, (cfg.padded_vocab, cfg.d_model),
                       ("vocab", "embed"), scale=0.02),
    }


def embed_tokens(p, cfg, tokens, dtype):
    """The table's rows of ``tokens``.  A table on a mesh is looked up
    vocab-parallel, as GSPMD partitions the JAX package's gather (DTensor
    has no rule for the indexing's backward, an indexed put, with the
    table sharded): the table keeps its vocab shards and is gathered along
    ``embed`` alone, each rank looks up its batch shard's tokens that fall
    in its vocab shard (zero rows for the others), and the rows are summed
    over the mesh axes that shard the vocab."""
    table = p["table"]
    if not is_dtensor(table):
        return shard_act(table[tokens.long()].to(dtype), "batch", "seq",
                         None)
    from torch.distributed.tensor import Replicate, Shard
    mesh = table.device_mesh
    tok_pl = tuple(Shard(0) if q == Shard(0) else Replicate()
                   for q in (tokens.placements if is_dtensor(tokens)
                             else (Replicate(),) * mesh.ndim))
    tab_pl = tuple(Shard(0) if q == Shard(0) and t != Shard(0)
                   else Replicate() for q, t in zip(table.placements, tok_pl))
    rows = local_in(table, mesh, tab_pl)
    ids = local_in(tokens, mesh, tok_pl).long() - shard_offset(table, 0,
                                                               tab_pl)
    mine = (ids >= 0) & (ids < rows.shape[0])
    y = rows[ids.clamp(0, rows.shape[0] - 1)] * mine[..., None]
    y = sum_over(y, mesh, sharding_axes(tab_pl, mesh, 0))
    return shard_act(local_out(y, mesh, tok_pl).to(dtype), "batch", "seq",
                     None)


def init_lm_head(generator, cfg):
    if cfg.tie_embeddings:
        return {}
    return {
        "w": param(generator, (cfg.d_model, cfg.padded_vocab),
                   ("head_embed", "head_vocab"),
                   scale=1.0 / math.sqrt(cfg.d_model)),
    }


def lm_logits(head_p, embed_p, cfg, x):
    if cfg.tie_embeddings:
        logits = x @ embed_p["table"].to(x.dtype).T
    else:
        logits = x @ head_p["w"].to(x.dtype)
    return shard_act(logits, "batch", "seq", "head_vocab")
