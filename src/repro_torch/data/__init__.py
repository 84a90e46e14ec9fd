from repro_torch.data.dirichlet import dirichlet_partition
from repro_torch.data.loader import ClientLoader, batch_iterator
from repro_torch.data.synthetic import (
    FederatedImageData,
    SyntheticImageDataset,
    make_federated_image_data,
    make_image_dataset,
    synthetic_token_batch,
)

__all__ = [
    "ClientLoader",
    "batch_iterator",
    "dirichlet_partition",
    "FederatedImageData",
    "SyntheticImageDataset",
    "make_federated_image_data",
    "make_image_dataset",
    "synthetic_token_batch",
]
