"""Which device a measurement ran on.

``require_gpu`` stops a measurement path that finds no GPU (it never falls
back to the CPU).  ``gpu_label`` reads the cards' names and power limits
with ``nvidia-smi`` in a child process, which stays off JAX: a card below
its 700 W maximum runs slower under load, so every number printed on a
card carries this label.
"""

from __future__ import annotations

import subprocess
from typing import List, Tuple

NVIDIA_SMI_QUERY = (
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
)


def require_gpu():
    """The JAX devices, when the first of them is a GPU; else RuntimeError."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"needs a GPU; JAX found {len(devices)} "
            f"{devices[0].platform} device(s)"
        )
    return devices


def device_record() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def parse_nvidia_smi(text: str) -> List[Tuple[str, str]]:
    """``name, power.limit`` CSV lines -> [(name, power limit)], one per
    card, e.g. ``[("NVIDIA H100 80GB HBM3", "700.00 W")]``."""
    cards = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip() or not limit.strip():
            raise ValueError(f"unexpected nvidia-smi line {line!r}")
        cards.append((name.strip(), limit.strip()))
    if not cards:
        raise ValueError("nvidia-smi listed no GPU")
    return cards


def nvidia_smi() -> str:
    """nvidia-smi's ``name, power.limit`` lines, one per card."""
    return subprocess.run(
        NVIDIA_SMI_QUERY, capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout


def gpu_label() -> str:
    """``name, power limit`` of the cards, as nvidia-smi gives them; cards
    that agree are listed once (``4x NVIDIA H100 ..., 700.00 W``)."""
    return format_label(parse_nvidia_smi(nvidia_smi()))


def format_label(cards: List[Tuple[str, str]]) -> str:
    distinct = sorted(set(cards), key=cards.index)
    parts = []
    for card in distinct:
        n = cards.count(card)
        parts.append(("" if n == 1 else f"{n}x ") + f"{card[0]}, {card[1]}")
    return "; ".join(parts)
