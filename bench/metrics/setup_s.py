"""setup_s: the seconds from the process's start to the window's: the
program's builds and loads, the weights from the seed, the warm steps or
call (``bench/core/harness.py``)."""


def read(run):
    return run.window["setup_s"]
