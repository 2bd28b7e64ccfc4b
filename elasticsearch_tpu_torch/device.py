"""Device placement for the port's entry points.

Every entry point (Node, Engine, pack_segment, RestServer) runs on the
card unless the caller asks for the CPU. Without a CUDA device the default
raises instead of quietly running the plain versions on the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "elasticsearch_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run the plain PyTorch "
            "versions of its kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device [{dev}]")
    return dev
