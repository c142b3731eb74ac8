"""PyTorch/CUDA port of ``moeva2_ijcai22_replication_tpu``.

The package mirrors the JAX package's layout module for module. It imports
``torch`` and ``numpy`` only: nothing of JAX and nothing of the JAX package.
Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for and
    missing (there is no quiet CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU"
        )
    return dev
