"""Serve a reduced model with batched requests and per-request personalized
heads (the PHSFL head bank).

    PYTHONPATH=src python examples/port_serve_personalized.py \
        [--arch xlstm-350m] [--device cpu]

(the PyTorch port's counterpart of ``examples/serve_personalized.py``: the
same flags into ``repro_torch.launch.serve``, on the card unless
``--device cpu``; xlstm-350m's mLSTM layers run the chunkwise mLSTM
kernel there)
"""

import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = ["--device", args.device] if args.device else []
    return serve_main(["--arch", args.arch, "--batch", "4", "--steps", "12",
                       "--clients", "3"] + device)


if __name__ == "__main__":
    main()
