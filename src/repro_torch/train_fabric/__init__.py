"""Training fabric: federation-scale §4.1 training (port of
``repro.train_fabric``).

Joins the port's ML stack (``repro_torch.models`` / ``.optim`` /
``.checkpoint`` / ``.kernels``) to its copy of the Sashimi fabric
(``repro_torch.core``): the round engine with K-of-N straggler barriers
(:class:`FederatedTrainer`), the round loop (:class:`FederatedTrainingLoop`),
the server step (tree reference or the fused CUDA kernel) and resumable
round checkpoints in the paper's JSON+base64 model-file format, and the
shard rebalancer (:class:`Rebalancer`, a byte copy of the JAX package's)
that the trainer's ``rebalancer=`` hook calls at each round boundary.
"""
from repro_torch.train_fabric.checkpointing import (CHECKPOINT_FORMAT,
                                                    checkpoint_path,
                                                    latest_checkpoint,
                                                    load_round_checkpoint,
                                                    save_round_checkpoint,
                                                    state_from_tree,
                                                    state_to_tree)
from repro_torch.train_fabric.rebalancer import Migration, Rebalancer
from repro_torch.train_fabric.round_engine import (STRAGGLER_POLICIES,
                                                   EmptyRoundError,
                                                   FederatedTrainer,
                                                   FederatedTrainingLoop,
                                                   RoundResult,
                                                   affinity_placement,
                                                   resolve_barrier_k)
from repro_torch.train_fabric.server_step import (FusedServerStep,
                                                  ServerStep, TreeServerStep,
                                                  member_coeffs,
                                                  member_grad_norms,
                                                  param_count)

__all__ = [
    "CHECKPOINT_FORMAT", "EmptyRoundError", "FederatedTrainer",
    "FederatedTrainingLoop", "FusedServerStep", "Migration", "Rebalancer",
    "RoundResult",
    "STRAGGLER_POLICIES", "ServerStep", "TreeServerStep",
    "affinity_placement", "checkpoint_path", "latest_checkpoint",
    "load_round_checkpoint", "member_coeffs", "member_grad_norms",
    "param_count", "resolve_barrier_k", "save_round_checkpoint",
    "state_from_tree", "state_to_tree",
]
