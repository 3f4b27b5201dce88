"""CLI: sample the airframe population -> dynamics_parameters/{i}.json.

Counterpart of `raptor_tpu/apps/sample_dynamics.py`.

    python -m raptor_tpu_torch.apps.sample_dynamics --n 1000 --out dynamics_parameters
"""

from __future__ import annotations

import argparse
import os

import torch

from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.env.io import save_params_json
from raptor_tpu_torch.env.randomization import RandomizationConfig, sample_population
from raptor_tpu_torch.env.types import tree_map


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--out", default="dynamics_parameters")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    # sampled in one batch on the device, pulled to the host once
    frames = tree_map(lambda x: x.cpu(), sample_population(generator, args.n, RandomizationConfig()))
    for i in range(args.n):
        save_params_json(os.path.join(args.out, f"{i}.json"), tree_map(lambda x: x[i:i + 1], frames))
    print(f"wrote {args.n} airframes to {args.out}/")


if __name__ == "__main__":
    main()
