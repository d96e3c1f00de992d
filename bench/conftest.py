"""Pytest settings of the benchmark's own tests (``bench/tests``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device; decides inside the test "
        "whether one is there, and skips without it")
