"""The paper's own model: a small CNN for CIFAR-10 (Sec. V-A).

Conv2d(C,64) -> ReLU -> MaxPool -> Conv2d(64,128) -> ReLU -> MaxPool
-> FC(512*?,256) -> ReLU -> FC(256, num_labels)

Split after the first MaxPool2d (client-side = first conv block).
Head = the final FC(256, num_labels) — randomly initialized, frozen during
global training, fine-tuned per client afterwards.

A copy of ``repro.configs.phsfl_cnn`` (the port imports nothing of the
reference package).
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class CNNConfig:
    name: str = "phsfl-cnn"
    image_size: int = 32
    channels: int = 3
    conv1_filters: int = 64
    conv2_filters: int = 128
    fc_hidden: int = 256
    num_labels: int = 10
    # PHSFL split: client side = [conv1, pool1]; server body = [conv2, pool2,
    # fc1]; server head = fc2.
    source = "paper Sec. V-A"

    @property
    def flat_dim(self) -> int:
        # two stride-2 maxpools
        s = self.image_size // 4
        return s * s * self.conv2_filters


CONFIG = CNNConfig()
