from repro_torch.sharding.rules import (
    LOGICAL_AXES,
    AbstractMesh,
    add_client_axis,
    as_abstract,
    data_axes,
    params_specs,
    spec_for,
)

__all__ = [
    "LOGICAL_AXES", "AbstractMesh", "add_client_axis", "as_abstract",
    "data_axes", "params_specs", "spec_for",
]
