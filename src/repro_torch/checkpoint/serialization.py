"""Checkpointing (port of ``repro.checkpoint.serialization``).

Two formats:
  * the paper's model-file format — JSON with **base64-encoded parameters**
    ("although the model file is a platform independent string format, it
    can be exchanged among machines without rounding errors") — bit-exact
    round-trip, in the JAX package's schema
    (``{"__tensor__", "dtype": <numpy dtype name>, "shape", "data"}``), so a
    file written by either package loads bit-exactly in the other;
  * a fast ``.npz`` path for large checkpoints (numpy has no bfloat16
    of its own, so a bf16 leaf is stored as its int16 bits under a key
    ending in ``::bfloat16``).

Leaves are written from tensors (any device) or numpy arrays and read back
as CPU tensors; bfloat16 is carried through an int16 view under the dtype
name ``"bfloat16"``.
"""
from __future__ import annotations

import base64
import json

import numpy as np
import torch

from repro_torch.tree import as_tensor, to_numpy


def _leaf_bits(x) -> tuple[str, np.ndarray]:
    """``(numpy dtype name, host array)`` of a leaf; a bf16 leaf (tensor,
    or numpy where ml_dtypes is loaded) comes as its int16 bits."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16", x.detach().to("cpu").contiguous() \
            .view(torch.int16).numpy()
    a = to_numpy(x)
    if a.dtype.name == "bfloat16":
        return "bfloat16", a.view(np.int16)
    return str(a.dtype), a


def _encode_leaf(x) -> dict:
    dtype, raw = _leaf_bits(x)
    return {
        "__tensor__": True,
        "dtype": dtype,
        "shape": list(raw.shape),
        "data": base64.b64encode(raw.tobytes()).decode("ascii"),
    }


def _decode_leaf(d: dict) -> torch.Tensor:
    raw = base64.b64decode(d["data"])
    if d["dtype"] == "bfloat16":
        a = np.frombuffer(raw, dtype=np.int16).reshape(d["shape"]).copy()
        return torch.from_numpy(a).view(torch.bfloat16)
    a = np.frombuffer(raw, dtype=np.dtype(d["dtype"]))
    return torch.from_numpy(a.reshape(d["shape"]).copy())


def tree_to_json(tree) -> str:
    """Serialise a tree of tensors/arrays to the paper's JSON+base64
    format."""

    def conv(x):
        if isinstance(x, dict):
            return {"__dict__": {k: conv(v) for k, v in x.items()}}
        if isinstance(x, (list, tuple)):
            tag = "__list__" if isinstance(x, list) else "__tuple__"
            return {tag: [conv(v) for v in x]}
        if isinstance(x, (int, float, str, bool)) or x is None:
            return {"__scalar__": x}
        return _encode_leaf(x)

    return json.dumps(conv(tree))


def tree_from_json(s: str):
    """Inverse of :func:`tree_to_json`; array leaves come back as CPU
    tensors."""

    def conv(d):
        if "__dict__" in d:
            return {k: conv(v) for k, v in d["__dict__"].items()}
        if "__list__" in d:
            return [conv(v) for v in d["__list__"]]
        if "__tuple__" in d:
            return tuple(conv(v) for v in d["__tuple__"])
        if "__scalar__" in d:
            return d["__scalar__"]
        return _decode_leaf(d)

    return conv(json.loads(s))


def save_json_model(path: str, tree) -> None:
    with open(path, "w") as f:
        f.write(tree_to_json(tree))


def load_json_model(path: str):
    with open(path) as f:
        return tree_from_json(f.read())


# --- npz fast path ---------------------------------------------------------

_BF16_KEY = "::bfloat16"


def _flatten_paths(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_paths(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        tag = "T" if isinstance(tree, tuple) else "L"
        for i, v in enumerate(tree):
            out.update(_flatten_paths(v, f"{prefix}__{tag}{i}/"))
    else:
        dtype, raw = _leaf_bits(tree)
        key = prefix.rstrip("/")
        out[key + _BF16_KEY if dtype == "bfloat16" else key] = raw
    return out


def save_npz(path: str, tree) -> None:
    np.savez(path, **_flatten_paths(tree))


def load_npz(path: str):
    flat = {}
    with np.load(path) as z:
        for k in z.files:
            if k.endswith(_BF16_KEY):
                flat[k[:-len(_BF16_KEY)]] = as_tensor(z[k]).view(
                    torch.bfloat16)
            else:
                flat[k] = as_tensor(z[k])

    def insert(root, keys, val):
        k = keys[0]
        if len(keys) == 1:
            root[k] = val
            return
        root = root.setdefault(k, {})
        insert(root, keys[1:], val)

    nested: dict = {}
    for k, v in flat.items():
        insert(nested, k.split("/"), v)

    def fix(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.startswith("__T") or k.startswith("__L")
                            for k in keys):
                seq = [fix(node[k]) for k in sorted(
                    keys, key=lambda s: int(s[3:]))]
                return tuple(seq) if keys[0].startswith("__T") else seq
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(nested)
