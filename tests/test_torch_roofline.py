"""The port's roofline (``repro_torch.launch.roofline``): the collective
recorder on a fake process group, mirroring ``tests/test_roofline.py::
test_collective_parser``'s cases kind by kind (the bytes of each
collective's output), the terms under the H100 constants, the
reference's decode-is-memory-bound check, and that no constant of the
reference's TPU (``src/repro/launch/roofline.py:23-25``) survives in the
port.

The fake group (``torch.testing._internal.distributed.fake_pg``) is the
default group of this module only: a module fixture opens it and
destroys it.
"""

import inspect
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_arch
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import analytic, roofline
from repro_torch.launch.roofline import CollectiveRecorder, Roofline

ROOT = Path(__file__).resolve().parent.parent
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


@pytest.fixture(scope="module")
def mesh():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (4, 2),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_collective_recorder(mesh):
    model, data = mesh.get_group("model"), mesh.get_group("data")
    with CollectiveRecorder(mesh) as rec:
        dist.all_reduce(torch.zeros(8, 128, dtype=torch.bfloat16),
                        group=model)
        dist.all_gather_into_tensor(torch.zeros(16, 128),
                                    torch.zeros(4, 128), group=data)
        dist.reduce_scatter_tensor(torch.zeros(4, 128),
                                   torch.zeros(16, 128), group=data)
        dist.send(torch.zeros(8, 128, dtype=torch.bfloat16), dst=1)
    out = rec.record
    assert out["all-reduce"] == 8 * 128 * 2
    assert out["all-gather"] == 16 * 128 * 4
    assert out["reduce-scatter"] == 4 * 128 * 4
    assert out["collective-permute"] == 8 * 128 * 2
    assert out["all-to-all"] == 0
    assert out["total"] == sum(out[k] for k in KINDS)
    assert out["counts"] == {"all-reduce": 1, "all-gather": 1,
                             "reduce-scatter": 1, "all-to-all": 0,
                             "collective-permute": 1}
    assert out["by_dim"]["model"]["all-reduce"] == 2048
    assert out["by_dim"]["data"]["counts"]["all-gather"] == 1
    assert out["by_dim"]["other"]["collective-permute"] == 2048


def test_collective_recorder_under_fake_tensors(mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(), CollectiveRecorder(mesh) as rec:
        x = torch.empty(1024, 4096, dtype=torch.bfloat16)
        for _ in range(3):
            dist.all_reduce(x, group=mesh.get_group("model"))
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.get_group("data"))
        dist.all_to_all_single(torch.empty(8, 128), torch.empty(8, 128),
                               group=mesh.get_group("data"))
    out = rec.record
    assert out["by_dim"]["model"]["counts"]["all-reduce"] == 3
    assert out["by_dim"]["model"]["all-reduce"] == 3 * 1024 * 4096 * 2
    assert out["by_dim"]["data"]["all-reduce"] == 1024 * 4096 * 2
    assert out["all-to-all"] == 8 * 128 * 4
    assert out["total"] == sum(out[k] for k in KINDS)


def test_terms_use_the_h100_constants():
    r = Roofline(arch="x", shape="s", mesh="m", chips=4, flops=989e12,
                 hbm_bytes=2 * 3.35e12, coll_bytes=3 * 400e9 / 8,
                 traced_flops=0.5 * 989e12)
    assert r.compute_s == 1.0 and r.memory_s == 2.0
    assert r.collective_s == pytest.approx(3.0, rel=1e-15)
    assert r.dominant == "collective"
    assert r.traced_flops_ratio == 0.5
    # the "model" dim's bytes: NVLink inside a node, the node's 8 NICs
    # across two; the client dims' bytes at one NIC a GPU
    for model, bw in ((8, 450e9), (16, 8 * 400e9 / 8)):
        r = Roofline(arch="x", shape="s", mesh="m", chips=4, flops=0.0,
                     hbm_bytes=0.0, coll_bytes=bw + 400e9 / 8,
                     analytic_detail={"coll_tp": bw}, model_dim=model)
        assert r.collective_s == pytest.approx(2.0, rel=1e-15)
    d = r.to_dict()
    assert not any(k.startswith("hlo_") for k in d)
    for key in ("flops_per_chip", "hbm_bytes_per_chip",
                "collective_bytes_per_chip", "collective_detail",
                "analytic_detail", "compute_s", "memory_s", "collective_s",
                "dominant", "model_flops", "useful_flops_ratio",
                "peak_memory_bytes", "traced_flops_per_chip",
                "traced_collective_bytes_per_chip"):
        assert key in d


def test_decode_memory_bound():
    cfg = get_arch("command-r-plus-104b")
    c = analytic.decode_cost(cfg, SHAPES["decode_32k"],
                             {"data": 16, "model": 16})
    r = Roofline(arch="x", shape="decode_32k", mesh="single", chips=256,
                 flops=c.flops, hbm_bytes=c.hbm_bytes, coll_bytes=c.coll_bytes)
    assert r.memory_s > r.compute_s       # decode is memory/collective bound


def test_no_tpu_constant_in_the_port():
    from repro.launch import roofline as tpu
    # the H100 SXM5 data sheet's dense bf16 peak, HBM3 rate and NVLink 4
    # a direction; InfiniBand NDR's 400 Gb/s a port (DGX H100: one a GPU)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW,
            roofline.NIC_BW) == (989e12, 3.35e12, 450e9, 400e9 / 8)
    assert roofline.PEAK_FLOPS != tpu.PEAK_FLOPS
    assert roofline.HBM_BW != tpu.HBM_BW
    # NDR's 50 GB/s equals the TPU's ICI rate by value only: at the
    # production "model" dim of 16 the port's TP bytes go at 400 GB/s
    assert roofline.NIC_BW == tpu.ICI_BW
    assert roofline.model_link_bw(16) == 8 * roofline.NIC_BW != tpu.ICI_BW
    values = [v for m in (roofline, analytic) for v in vars(m).values()
              if isinstance(v, float)]
    assert tpu.PEAK_FLOPS not in values and tpu.HBM_BW not in values
    texts = [inspect.getsource(roofline), inspect.getsource(analytic)]
    texts += [p.read_text() for p in (ROOT / "src/repro_torch").rglob("*.py")]
    for text in texts:
        for name in ("ICI_BW", "v5e", "197 TF", "819 GB"):
            assert name not in text, name
