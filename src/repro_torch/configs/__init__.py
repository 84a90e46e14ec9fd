from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    MLAConfig,
    EncDecConfig,
    VLMConfig,
    XLSTMConfig,
    RGLRUConfig,
    HierarchyConfig,
    TrainConfig,
    ShapeConfig,
    MeshConfig,
    ATTN,
    LOCAL_ATTN,
    MLA_ATTN,
    RGLRU,
    SLSTM,
    MLSTM,
    RECURRENT_KINDS,
    FaultConfig,
    WirelessConfig,
)
from repro_torch.configs.phsfl_cnn import CNNConfig
from repro_torch.configs.registry import get_arch
from repro_torch.configs.sweeps import (sweep_hierarchy, sweep_train,
                                        sweep_wireless)

# the reference's names in its order, then the port's own
__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "EncDecConfig", "VLMConfig",
    "XLSTMConfig", "RGLRUConfig", "HierarchyConfig", "TrainConfig",
    "ShapeConfig", "MeshConfig",
    "ATTN", "LOCAL_ATTN", "MLA_ATTN", "RGLRU", "SLSTM", "MLSTM",
    "RECURRENT_KINDS",
    "CNNConfig", "FaultConfig", "WirelessConfig", "get_arch",
    "sweep_hierarchy", "sweep_train", "sweep_wireless",
]
