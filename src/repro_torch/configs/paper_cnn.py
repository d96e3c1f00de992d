"""The paper's own deep CNNs (Sukiyaki benchmarks, Figures 2 and 4).

Figure-2 net (stand-alone benchmark, CIFAR-10): three 5x5 conv layers
(16/20/20 maps) each followed by activation + 2x2 max-pool, then a
fully-connected 320 -> 10 softmax layer.  Mini-batch 50.
"""
from dataclasses import dataclass, field
from typing import Sequence


@dataclass(frozen=True)
class ConvSpec:
    out_channels: int
    kernel: int = 5
    pool: int = 2          # max-pool window/stride after activation


@dataclass(frozen=True)
class CNNConfig:
    name: str = "paper-cnn-fig2"
    image_size: int = 32
    in_channels: int = 3
    num_classes: int = 10
    convs: Sequence[ConvSpec] = field(
        default_factory=lambda: (
            ConvSpec(16), ConvSpec(20), ConvSpec(20),
        )
    )
    fc_hidden: Sequence[int] = ()   # hidden widths of the FC classifier
    batch_size: int = 50   # paper: 50 images per mini-batch

    @property
    def feature_dim(self) -> int:
        size = self.image_size
        for c in self.convs:
            size //= c.pool
        return size * size * self.convs[-1].out_channels


FIG2_CNN = CNNConfig()

# Figure-4 net (distributed benchmark) — same family, slightly larger maps.
FIG4_CNN = CNNConfig(
    name="paper-cnn-fig4",
    convs=(ConvSpec(32), ConvSpec(32), ConvSpec(64)),
    fc_hidden=(512,),   # heavier server-side classifier (distributed bench)
)

# Fabric cell net (benchmarks/federated_training.py, tests): the Fig-2
# family scaled down so a real conv→pool→softmax gradient shard runs in
# a CI-sized federated round — still every layer kind of the paper net.
FABRIC_CNN = CNNConfig(
    name="paper-cnn-fabric", image_size=16,
    convs=(ConvSpec(8), ConvSpec(8)), batch_size=32,
)


def smoke_config() -> CNNConfig:
    return CNNConfig(name="paper-cnn-smoke", image_size=16,
                     convs=(ConvSpec(8), ConvSpec(8)), batch_size=4)
