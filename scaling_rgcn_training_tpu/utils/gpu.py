"""The GPU a measurement ran on, as ``nvidia-smi`` names it.

Cards of one model are set to different power limits, and a card below
its maximum runs slower under load, so every recorded time carries this.
"""

from __future__ import annotations

import subprocess


def card_description() -> str:
    """``name, power.limit`` of every visible card, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
