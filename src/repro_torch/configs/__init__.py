from repro_torch.configs.base import HierarchyConfig, TrainConfig
from repro_torch.configs.phsfl_cnn import CNNConfig

__all__ = ["CNNConfig", "HierarchyConfig", "TrainConfig"]
