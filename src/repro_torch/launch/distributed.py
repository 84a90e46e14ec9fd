"""Process groups for the mesh rounds: the backend rule, a rank's device,
and a spawner of ranks on one host.

The backend rule: ``nccl`` when each rank has a card of its own; ``gloo``
when the ranks share a card (NCCL refuses two ranks on one device) or run
on the CPU.  Gloo's ``all_reduce`` takes CUDA tensors (it stages them
through the host), so the tensors stay on the card either way.  Nothing
falls back: a rank that asks for ``cuda`` and finds no card raises
(``device.resolve_device``).

The reference's mesh is one program over fake or real devices; here each
client rank is a process.  ``torchrun`` starts them for the launcher
(``launch/train.py``); :func:`spawn` starts them for the tests and the
chip checks, each with the group initialised at ``tcp://localhost``.
"""

from __future__ import annotations

import os
import queue
import socket
import traceback

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def backend_for(device_type: str, local_world_size: int) -> str:
    """``nccl`` if every local rank can have a card of its own, else
    ``gloo`` (ranks sharing a card, or the CPU)."""
    if device_type == "cuda" and torch.cuda.device_count() >= \
            local_world_size:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """This rank's device: the CPU, or card ``local_rank`` modulo the
    cards there are (every rank on card 0 of a one-card host).  Sets it as
    the current card, before any mesh or group touches CUDA."""
    dev = resolve_device(device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world_size, port, device_type, threads, args, out):
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(device_type, rank)
        backend = backend_for(device_type, world_size)
        dist.init_process_group(backend,
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world_size)
        try:
            res = fn(rank, world_size, dev, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except Exception:           # the rank's boundary: report to the parent
        out.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size: int, args=(), *, device: str = "cpu",
          threads: int | None = None, timeout: float = 900.0) -> list:
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size`` fresh
    processes joined in one process group (the backend rule above), and
    return each rank's (picklable) result, by rank.  ``fn`` must be
    importable by name.  ``threads`` caps each rank's intra-op threads.
    A rank that raises, or dies, raises here with its traceback; every
    process started is gone on return."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world_size, port,
                                              device, threads, args, out),
                         daemon=True) for r in range(world_size)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        waited = 0.0
        while len(results) + len(errors) < world_size:
            try:
                rank, ok, res = out.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError(f"a rank died (exit codes "
                                       f"{[p.exitcode for p in procs]})")
                if waited > timeout:
                    raise TimeoutError(f"ranks did not finish in {timeout} s")
                continue
            if ok:
                results[rank] = res
            else:
                errors.append(f"rank {rank}:\n{res}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return [results[r] for r in range(world_size)]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()


def init_from_env(device_type: str) -> tuple[torch.device, str]:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_*``):
    this rank's device and the backend by the rule above."""
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ["WORLD_SIZE"]))
    dev = rank_device(device_type, local_rank)
    backend = backend_for(dev.type, local_world)
    dist.init_process_group(backend)
    return dev, backend
