from repro_torch.configs.base import (FaultConfig, HierarchyConfig,
                                      ModelConfig, TrainConfig,
                                      WirelessConfig)
from repro_torch.configs.phsfl_cnn import CNNConfig
from repro_torch.configs.registry import get_arch
from repro_torch.configs.sweeps import (sweep_hierarchy, sweep_train,
                                        sweep_wireless)

__all__ = ["CNNConfig", "FaultConfig", "HierarchyConfig", "ModelConfig",
           "TrainConfig", "WirelessConfig", "get_arch", "sweep_hierarchy",
           "sweep_train", "sweep_wireless"]
