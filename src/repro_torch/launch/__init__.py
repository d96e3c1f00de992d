"""Command-line drivers of the port: ``serve`` (batched prefill and greedy
decode over the LM zoo)."""
