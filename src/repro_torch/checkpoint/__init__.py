from repro_torch.checkpoint.serialization import (
    load_json_model,
    load_npz,
    save_json_model,
    save_npz,
    tree_from_json,
    tree_to_json,
)

__all__ = [
    "load_json_model",
    "load_npz",
    "save_json_model",
    "save_npz",
    "tree_from_json",
    "tree_to_json",
]
