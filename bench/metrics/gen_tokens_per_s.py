"""gen_tokens_per_s: the generated tokens of the window's whole
``generate`` calls over their own elapsed time
(``bench/core/harness.py``)."""


def read(run):
    return run.window["tokens"] / run.window["seconds"]
