"""The card: its presence, name, memory rate and power limit."""

from __future__ import annotations

import shutil
import subprocess

import torch

# memory rate by card name, bytes/s (NVIDIA data sheets); the first
# name contained in the card's name wins
MEMORY_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
               ("H200", 4.8e12), ("H100", 3.35e12))


class NoCard(RuntimeError):
    """The run needs more CUDA cards than this machine shows."""


def require(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: torch.cuda.is_available() is false")
    n = torch.cuda.device_count()
    if n < chips:
        raise NoCard(f"the cell needs {chips} CUDA cards, {n} visible")


def memory_rate(name: str) -> float | None:
    for key, rate in MEMORY_RATE:
        if key in name:
            return rate
    return None


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it, or "unknown"."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "unknown"
    try:
        done = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    lines = done.stdout.strip().splitlines()
    return lines[0].strip() if done.returncode == 0 and lines else "unknown"
