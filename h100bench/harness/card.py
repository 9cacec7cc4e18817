"""The card a run measures, and the modules it may not load."""

from __future__ import annotations

import subprocess
import sys

# top-level module names that no run may hold: JAX and the JAX package,
# of which the port is a copy (compared whole: "orion_kmer_tpu_torch" is not
# "orion_kmer_tpu")
FORBIDDEN = ("jax", "jaxlib", "flax", "orion_kmer_tpu")


def forbidden_loaded(module_names) -> list[str]:
    """The module names whose top-level name is forbidden, sorted."""
    return sorted(m for m in module_names if m.split(".", 1)[0] in FORBIDDEN)


class NoCard(RuntimeError):
    pass


def require_cards(n: int) -> None:
    """Raise NoCard unless torch sees at least ``n`` CUDA cards."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise NoCard(f"{torch.cuda.device_count()} CUDA cards visible, the cell needs {n}")


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(out.stdout.strip().splitlines()) or f"nvidia-smi exit {out.returncode}"


def describe(n: int) -> dict:
    import torch

    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": n,
    }


def log(msg: str) -> None:
    print(msg, flush=True)


def err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
