"""PyTorch and CUDA port of the Sashimi/Sukiyaki reproduction.

The package sits beside the JAX package (``repro``) and mirrors its
subpackage paths.  It imports ``torch`` and ``numpy``, never ``jax`` and
nothing of ``repro``: the plain-Python modules it needs
(``core.{wire, tickets, distributor, shards, federation, transport}``,
``data.synthetic``, ``configs.paper_cnn``, ``configs.base`` and the ten
architecture configs) are byte copies whose only change is the import
prefix, held to their originals by ``tests/test_torch_guard.py``.

Device rule: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; asking for ``cuda`` on a host without CUDA raises
(:func:`repro_torch.device.resolve_device`).  The kernels' wrappers dispatch
by the device of the tensors they are given.
"""
