"""The GPU a measurement ran on, as ``nvidia-smi`` names it."""

from __future__ import annotations

import subprocess


def card_lines() -> list[str]:
    """``name, power.limit`` of every card, one string each, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them.  A card may be capped below its maximum power and then
    runs slower under load, so every number is reported beside this."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]
