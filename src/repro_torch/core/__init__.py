"""Sashimi's distributed-calculation core, as the port carries it.

``tickets``, ``wire``, ``distributor``, ``shards``, ``federation``,
``transport``, ``profiles`` and ``project`` are byte copies of the JAX
package's modules (only the import prefix differs); ``split_parallel``
holds the framework-free pieces of the JAX module of that name that the
training fabric needs.
"""
