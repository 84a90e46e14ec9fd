"""Quickstart: train a reduced assigned architecture with PHSFL.

    PYTHONPATH=src python examples/port_quickstart.py [--arch gemma3-12b] \
        [--device cpu]

(the PyTorch port's counterpart of ``examples/quickstart.py``: the same
flags into ``repro_torch.launch.train``, on the card unless ``--device
cpu``; gemma3-12b's attention runs the flash-attention kernel there)

What happens:
  1. builds the architecture at a reduced (smoke) scale;
  2. runs R PHSFL rounds — per-client local SGD with the classifier FROZEN,
     then weighted hierarchical aggregation;
  3. fine-tunes a personalized head per client (Eq. 18) and prints the
     per-client personalization gain.
"""

import argparse

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = ["--device", args.device] if args.device else []
    return train_main(["--arch", args.arch, "--rounds", str(args.rounds),
                       "--clients", "4", "--seq", "128"] + device)


if __name__ == "__main__":
    main()
