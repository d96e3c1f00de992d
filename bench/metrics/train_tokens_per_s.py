"""train_tokens_per_s: the tokens of the window's whole training steps
over their own elapsed time (``bench/core/harness.py``)."""


def read(run):
    return run.window["tokens"] / run.window["seconds"]
