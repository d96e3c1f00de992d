"""Command-line drivers of the port: ``serve`` (batched prefill and greedy
decode over the LM zoo) and ``train`` (LM training with the paper's split
strategies)."""
