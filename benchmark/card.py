"""The card's name and power limit, as `nvidia-smi` reports them. A copy of
the port's reader (`raptor_tpu_torch/apps/roofline.py`,
`card_name_and_power_limit`)."""

from __future__ import annotations

import subprocess


def name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, first
    line; "nvidia-smi failed" where it cannot be read."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=False,
        )
    except OSError:
        return "nvidia-smi failed"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else "nvidia-smi failed"


def power_limit_watts(line: str):
    """The power limit in watts from `name_and_power_limit()`'s line, or None."""
    try:
        return float(line.rsplit(",", 1)[1].strip().split()[0])
    except (IndexError, ValueError):
        return None
