"""Plain float32 PyTorch pieces that the references share: layer norm, the
masked cross-entropy, the paper's modified AdaGrad, the split_concurrent
training step, and the precision a reference computes its products in.

Nothing here imports the program under test: the references are written
from the published descriptions (and from the paper's §4.1 for the split
step), and are judged against the program only by the harness.
"""
from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import checkpoint


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """Layer norm over the last axis with a biased variance, in f32."""
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def lm_loss(logits, labels, mask):
    """Token-mean cross-entropy over the positions ``mask`` keeps."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return ((lse - gold) * mask).sum() / mask.sum().clamp_min(1.0)


def adagrad(p, g, acc, *, lr: float, beta: float):
    """The paper's modified AdaGrad (Sukiyaki §3.1): β inside the root.
    ``acc' = acc + g²``, ``p' = p - lr·g/sqrt(β + acc')``."""
    a = acc + g * g
    return p - lr * g * torch.rsqrt(beta + a), a


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass when
    autograd records (so a reference fits beside its parameters)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------

_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.mm, torch.bmm, torch.einsum,
             torch.nn.functional.linear}


def tf32_round(x):
    """``x`` (f32) rounded to TF32's 10 mantissa bits, to nearest, ties
    to even: what a TF32 product does to its inputs."""
    bits = x.contiguous().view(torch.int32)
    bits = bits + (0x0FFF + ((bits >> 13) & 1))
    return (bits & ~0x1FFF).view(torch.float32)


class _TF32Products(TorchFunctionMode):
    """Every matrix product of the forward pass with its f32 inputs
    rounded to TF32 (the CPU has no TF32 products; the backward pass's
    products stay f32)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            def rnd(a):
                if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
                    # rounded forward, the gradient passed straight through
                    return a + (tf32_round(a.detach()) - a.detach())
                if isinstance(a, (list, tuple)):
                    return type(a)(rnd(b) for b in a)
                return a
            args = tuple(rnd(a) for a in args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def precision(name: str, device):
    """Products in ``name``: ``"f32"`` (TF32 off in both of PyTorch's
    switches) or ``"tf32"`` (the control: on the card TF32 on in both
    switches; on the CPU each product's inputs rounded to TF32)."""
    if name not in ("f32", "tf32"):
        raise ValueError(f"no precision {name!r}")
    on = name == "tf32"
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    mode = (_TF32Products() if on and torch.device(device).type == "cpu"
            else contextlib.nullcontext())
    try:
        with mode:
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def flat(tree, prefix=()):
    """``[(path, tensor)]`` of a nested dict, in its key order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += flat(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def unflat(pairs) -> dict:
    tree: dict = {}
    for path, v in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def name(path) -> str:
    return ".".join(path)


# ---------------------------------------------------------------------------
# The split_concurrent step (the paper's §4.1)
# ---------------------------------------------------------------------------


def split_concurrent(model, params, batches, *, lr: float, beta: float,
                     head_sync_period: int, half_batch: bool = False):
    """Train ``params`` (``{"head": {"w"}}`` the server's, the rest the
    clients' backbone) for ``len(batches)`` steps of split_concurrent:

    - clients: the backbone's loss through the *stale* head, and its
      gradient, which updates the backbone;
    - server: the head's loss on the *previous* step's features (none at
      step 0: a zero gradient), which updates the head;
    - the stale head takes the new head every ``head_sync_period`` steps.

    ``model`` has ``features(backbone, tokens)`` (the pre-head hidden
    states) and ``logits(head, feats)``.  ``half_batch``: a planted fault,
    the second half of each batch's rows masked out.  Returns a dict:
    ``losses``, the client loss of each step; and by leaf name, ``grads``,
    the norm of the gradient the leaf got at step 0, ``change``, of its
    change over all the steps, ``every``, of all its gradients together
    (the root of its accumulator's sum), and ``stale``, of the stale
    head's change over all the steps (0 until its first refresh)."""
    backbone = {k: v for k, v in params.items() if k != "head"}
    head = {"head": params["head"]}
    stale = {"head": {k: v.clone() for k, v in params["head"].items()}}
    acc = {name(p): torch.zeros_like(v) for p, v in flat(params)}
    prev = None
    losses, first_grads = [], {}
    for t, batch in enumerate(batches):
        mask = batch["mask"]
        if half_batch:
            mask = mask.clone()
            mask[mask.shape[0] // 2:] = 0
        leaves = [(p, v.detach().requires_grad_(True))
                  for p, v in flat(backbone)]
        with torch.enable_grad():
            feats = model.features(unflat(leaves), batch["tokens"])
            loss = lm_loss(model.logits(stale["head"], feats),
                           batch["labels"], mask)
            grads = torch.autograd.grad(loss, [v for _, v in leaves])
        losses.append(float(loss.detach()))
        feats = feats.detach()
        new_backbone = []
        for (p, v), g in zip(leaves, grads):
            nv, acc[name(p)] = adagrad(v.detach(), g, acc[name(p)], lr=lr,
                                       beta=beta)
            new_backbone.append((p, nv))
            if t == 0:
                first_grads[name(p)] = float(g.norm())
        head_leaves = [(("head",) + p, v.detach().requires_grad_(True))
                       for p, v in flat(head["head"])]
        if prev is None:
            head_grads = [torch.zeros_like(v) for _, v in head_leaves]
        else:
            with torch.enable_grad():
                hl = lm_loss(model.logits(unflat(head_leaves)["head"],
                                          prev[0]), prev[1], prev[2])
                head_grads = torch.autograd.grad(
                    hl, [v for _, v in head_leaves])
        new_head = []
        for (p, v), g in zip(head_leaves, head_grads):
            nv, acc[name(p)] = adagrad(v.detach(), g, acc[name(p)], lr=lr,
                                       beta=beta)
            new_head.append((p, nv))
            if t == 0:
                first_grads[name(p)] = float(g.norm())
        backbone = unflat(new_backbone)
        head = unflat(new_head)
        if (t + 1) % head_sync_period == 0:
            stale = {"head": dict(head["head"])}
        prev = (feats, batch["labels"], mask)
        del feats, grads, leaves
    start = dict(flat(params))
    change = {name(p): float((v - start[p]).norm())
              for p, v in flat(dict(backbone, **head))}
    every = {k: float(a.sum().sqrt()) for k, a in acc.items()}
    stale_change = {name(p): float((v - start[p]).norm())
                    for p, v in flat(stale)}
    return {"losses": losses, "grads": first_grads, "change": change,
            "every": every, "stale": stale_change}
