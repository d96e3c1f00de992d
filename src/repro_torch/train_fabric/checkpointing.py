"""Resumable training rounds: the full ``TrainState`` + trainer metadata in
the paper's JSON+base64 model-file format (port of
``repro.train_fabric.checkpointing``).

The envelope (``"sashimi-train-ckpt-v1"``) and the state's field list are
the JAX package's, and :mod:`repro_torch.checkpoint.serialization` writes
the JAX package's leaf schema, so a round checkpoint written by either
package resumes in the other bit-exactly (bf16 leaves and the 0-d int32
``step`` included).  Leaves load as CPU tensors.

Checkpoints are written **atomically** (temp file + ``os.replace``) at
round boundaries, so a kill mid-write can never leave a torn file.
"""
from __future__ import annotations

import os
from dataclasses import fields
from typing import Optional

from repro_torch.checkpoint.serialization import tree_from_json, tree_to_json
from repro_torch.core.split_parallel import TrainState

#: Envelope tag; bump on layout changes so a resume can fail loudly
#: instead of mis-reading an old file.
CHECKPOINT_FORMAT = "sashimi-train-ckpt-v1"


def state_to_tree(state: TrainState) -> dict:
    """The ``TrainState`` dataclass as a plain field-name → subtree dict."""
    return {f.name: getattr(state, f.name) for f in fields(TrainState)}


def state_from_tree(tree: dict) -> TrainState:
    """Inverse of :func:`state_to_tree`."""
    return TrainState(**{f.name: tree[f.name] for f in fields(TrainState)})


def save_round_checkpoint(path: str, state: TrainState, *,
                          round_index: int,
                          extra: Optional[dict] = None) -> str:
    """Write a round-boundary checkpoint atomically; returns ``path``.

    ``round_index`` is the number of rounds COMPLETED — a resume
    continues from round ``round_index`` (zero-based)."""
    doc = {"format": CHECKPOINT_FORMAT,
           "round": int(round_index),
           "extra": dict(extra or {}),
           "state": state_to_tree(state)}
    payload = tree_to_json(doc)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(payload)
    os.replace(tmp, path)
    return path


def load_round_checkpoint(path: str) -> tuple[TrainState, int, dict]:
    """Read a round checkpoint; returns ``(state, round_index, extra)``.
    Raises ``ValueError`` on an unknown envelope format."""
    with open(path) as f:
        doc = tree_from_json(f.read())
    if doc.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(
            f"not a {CHECKPOINT_FORMAT} checkpoint: {doc.get('format')!r}")
    return state_from_tree(doc["state"]), int(doc["round"]), doc["extra"]


def latest_checkpoint(directory: str,
                      prefix: str = "round") -> Optional[str]:
    """The highest-round ``<prefix>_<n>.json`` checkpoint in
    ``directory`` (None when there is none) — the resume entry point."""
    best: tuple[int, Optional[str]] = (-1, None)
    if not os.path.isdir(directory):
        return None
    for name in os.listdir(directory):
        if not (name.startswith(f"{prefix}_") and name.endswith(".json")):
            continue
        try:
            n = int(name[len(prefix) + 1:-len(".json")])
        except ValueError:
            continue
        if n > best[0]:
            best = (n, os.path.join(directory, name))
    return best[1]


def checkpoint_path(directory: str, round_index: int,
                    prefix: str = "round") -> str:
    """Canonical per-round checkpoint filename."""
    return os.path.join(directory, f"{prefix}_{round_index}.json")


__all__ = ["CHECKPOINT_FORMAT", "checkpoint_path", "latest_checkpoint",
           "load_round_checkpoint", "save_round_checkpoint",
           "state_from_tree", "state_to_tree"]
