"""Global configuration for the juliagrid_tpu_torch port.

Mirrors the reference's ``@config`` macro (internal.jl:299-312). The port
computes in float64 throughout: the H100 has native f64 in its CUDA cores,
tensor cores and cuSOLVER, so there is no reduced-precision factor type and
no refinement switch.

``device`` names where analyses place their tensors. It defaults to
``"cuda"``; a run on the CPU asks for ``"cpu"`` explicitly. Asking for
CUDA where none exists raises: nothing falls back to the CPU quietly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Config:
    """Live global configuration (the reference's ``template.config``)."""

    #: solver progress verbosity 0..3 (reference @config(verbose=...))
    verbose: int = 0
    #: default label key type for new elements: ``int`` or ``str``
    label_type: type = int
    #: torch device analyses place their tensors on
    device: str = "cuda"


config = Config()


def set_config(**kwargs) -> None:
    """Equivalent of the reference ``@config`` macro."""
    for k, v in kwargs.items():
        if not hasattr(config, k):
            raise KeyError(f"unknown config key: {k}")
        setattr(config, k, v)


def default_config() -> None:
    """Reset global config (part of the reference ``@default`` macro)."""
    config.verbose = 0
    config.label_type = int
    config.device = "cuda"


def resolve_device(device=None) -> torch.device:
    """The torch device for ``device`` (default ``config.device``).

    Raises when CUDA is asked for and ``torch.cuda.is_available()`` is
    false."""
    dev = torch.device(config.device if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available;"
            " pass device='cpu' to run on the CPU")
    return dev
