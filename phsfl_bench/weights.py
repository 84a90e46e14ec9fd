"""Weights drawn from the run's seed on the device, in a few large calls.

A configuration's layout ({path: (shape, dtype, init)}, from its plain
reference) gives every leaf.  One standard-normal draw per dtype fills a
flat buffer on the device from a ``torch.Generator`` there; each leaf is
a view of it, clipped to 2 standard deviations and scaled in place, or
filled with ones or zeros.  The same seed on the same device gives the
same weights, so the reference draws them again after the window rather
than keep a copy beside the program.
"""

from __future__ import annotations

import math

import torch

from phsfl_bench.reference.common import nest


def draw(layout: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    by_dtype: dict = {}
    for path in sorted(layout):
        shape, dtype, _ = layout[path]
        by_dtype.setdefault(dtype, []).append((path, shape))
    flat = {}
    for dtype in sorted(by_dtype, key=str):
        items = by_dtype[dtype]
        total = sum(math.prod(s) for _, s in items)
        buf = torch.empty(total, dtype=dtype, device=device)
        buf.normal_(generator=gen)
        at = 0
        for path, shape in items:
            n = math.prod(shape)
            t = buf[at:at + n].view(shape)
            at += n
            init = layout[path][2]
            if init == "ones":
                t.fill_(1)
            elif init == "zeros":
                t.zero_()
            else:
                t.clamp_(-2, 2).mul_(init)
            flat[path] = t
    return nest(flat)
