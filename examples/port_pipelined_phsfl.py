"""Pipelined split training: stream each minibatch's activations mid-compute.

    PYTHONPATH=src python examples/port_pipelined_phsfl.py \
        [--deadline 3.0]

(the PyTorch port's counterpart of ``examples/pipelined_phsfl.py``: the
scheduler's numpy oracle on the host, as there; no device)

What happens:
  1. builds the SAME wireless round twice — once with the serial Eq.-17
     timeline (compute everything, then transmit everything) and once with
     ``WirelessConfig.pipeline=True`` (each of the kappa0 x
     batches_per_epoch minibatch activation payloads transmits as soon as
     its minibatch's compute finishes and the radio is free) — and prints
     one client's explicit event timeline for both
     (``RoundTimeline.segments``): in the pipelined one the uplink
     segments interleave with the compute chunks instead of waiting for
     the last one;
  2. compares the per-client completion times: pipelining saves exactly
     ``(n-1) * min(c, u)`` (per-chunk compute c, per-payload airtime u) —
     never negative, and the round moves from ``compute + tx`` toward
     ``max(compute, tx)`` plus one fill bubble;
  3. applies a tight deadline: clients whose serial timeline overshoots it
     are straggler-dropped, while their pipelined timeline fits — the
     deadline gate, the energy charge, and the moved-bits ledger all read
     the overlapped schedule.

Async staleness banking (``staleness_lambda``) composes with this — see
benchmarks/pipeline_sweep.py for the four-cell comparison.
"""

import argparse

import numpy as np

from repro_torch.configs.base import WirelessConfig
from repro_torch.configs.phsfl_cnn import CONFIG as CNN_CFG
from repro_torch.core.comm import comm_for_cnn
from repro_torch.core.hierarchy import es_assignment
from repro_torch.wireless import client_round_bits, make_scheduler

KAPPA0 = 2
U = 8


def scenario(pipeline: bool, args) -> WirelessConfig:
    return WirelessConfig(model="static", mean_uplink_mbps=20.0,
                          mean_downlink_mbps=80.0, latency_s=0.02,
                          heterogeneity=0.5, deadline_s=args.deadline,
                          compute_gflops=args.compute_gflops,
                          compute_power_w=0.2, pipeline=pipeline,
                          seed=args.seed)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--deadline", type=float, default=3.0)
    ap.add_argument("--compute-gflops", type=float, default=0.5)
    ap.add_argument("--client", type=int, default=0,
                    help="whose timeline to print")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    comm = comm_for_cnn(CNN_CFG, dataset_size=400, batch_size=16,
                        batches_per_epoch=2)
    bits = client_round_bits(comm, KAPPA0)
    print(f"per round: {bits.chunks} minibatch payloads x "
          f"{bits.up_stream:,} bits + {bits.up_tail:,} offload bits up, "
          f"{np.asarray(bits.downlink):,} bits down\n")

    reps = {}
    for pipeline in (False, True):
        cfg = scenario(pipeline, args)
        sched = make_scheduler(cfg, U, comm, KAPPA0,
                               es_assign=es_assignment(U, U // 2))
        link = sched.channel.sample(0)
        tl = sched._timeline(link, bits, sched._compute_s(None))
        name = "pipelined" if pipeline else "serial"
        print(f"--- {name} timeline of client {args.client} "
              f"(activity clock, seconds) ---")
        for seg in tl.segments(args.client):
            span = f"[{seg['start']:7.3f}, {seg['end']:7.3f})"
            extra = f"  {seg['bits']:,.0f} bits" if "bits" in seg else ""
            print(f"  {seg['kind']:8s} {span}{extra}")
        reps[name] = sched.step(0)
        print(f"  -> completion {np.round(tl.times_s, 3)}\n")

    serial, piped = reps["serial"], reps["pipelined"]
    saved = serial.times_s - piped.times_s
    print(f"pipelining saves per client (s): {np.round(saved, 3)}")
    assert (saved >= -1e-9).all(), "pipelining must never be slower"
    print(f"deadline {args.deadline}s participation: "
          f"serial {serial.num_participants}/{U}, "
          f"pipelined {piped.num_participants}/{U}")


if __name__ == "__main__":
    main()
