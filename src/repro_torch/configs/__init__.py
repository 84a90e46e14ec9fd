from repro_torch.configs.base import HierarchyConfig, ModelConfig, TrainConfig
from repro_torch.configs.phsfl_cnn import CNNConfig
from repro_torch.configs.registry import get_arch

__all__ = ["CNNConfig", "HierarchyConfig", "ModelConfig", "TrainConfig",
           "get_arch"]
