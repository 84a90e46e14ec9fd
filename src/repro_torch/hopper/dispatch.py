"""Where a kernel wrapper sends its tensors, and the kernels' custom ops.

Each wrapper's forward goes through a ``torch.library.custom_op``
(``repro_torch::<kernel>``) when its tensor is on the card or is a fake
tensor (``FakeTensorMode``: shapes, dtypes and devices, no data, as the
dry run traces a step): on a real CUDA tensor the op launches the kernel
(or raises); on a fake one its ``register_fake`` gives the output's shape
and dtype and nothing is launched, and its ``register_flop_formula``
counts the operations the card does (the bounds of PERF.md §6), so
``FlopCounterMode`` counts the kernel as it runs.  A real CPU tensor
takes the plain version, a meta tensor the plain version's shapes.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (shapes, no data)."""
    return isinstance(t, FakeTensor)


def takes_kernel_op(t: torch.Tensor) -> bool:
    """Whether ``t`` goes through the kernel's custom op: a CUDA tensor,
    or a fake one on any device."""
    return isinstance(t, FakeTensor) or t.device.type == "cuda"


def kernel_op(name: str, schema: str, launch, fake, flops):
    """Register ``repro_torch::<name>`` with ``schema``: ``launch`` on
    CUDA tensors, ``fake`` for fake ones, ``flops`` (the arguments with
    tensors as their shapes -> operations) for ``FlopCounterMode``.
    Returns the op."""
    from torch.utils.flop_counter import register_flop_formula
    op = torch.library.custom_op(f"repro_torch::{name}", launch,
                                 mutates_args=(), device_types="cuda",
                                 schema=schema)
    op.register_fake(fake)
    packet = getattr(torch.ops.repro_torch, name)

    def formula(*args, out_shape=None, **kwargs):
        return int(flops(*args, **kwargs))

    register_flop_formula(packet)(formula)
    return packet.default
