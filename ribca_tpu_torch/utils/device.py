"""Device and dtype policy of the port.

Entry points run on ``"cuda"`` unless the caller asks for ``"cpu"``; asking
for CUDA on a host without it raises instead of carrying on on the CPU.
On CUDA, f32 means f32: both TF32 switches are turned off, because cuDNN
would otherwise run the Gaussian, patch-embed and soft-mask convolutions
in TF32 (about three decimal digits).
"""

from __future__ import annotations

import torch

DTYPES = {
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float32": torch.float32,
    "f32": torch.float32,
}


def resolve_device(name: str | torch.device) -> torch.device:
    """torch.device for ``name`` ("cuda", "cuda:<i>" or "cpu")."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but CUDA is not available "
                "on this host; pass device='cpu' (CLI: --device cpu) to run "
                "on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(name)!r}: use cuda or cpu")
    return dev


def dtype_from_name(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {name!r}: {sorted(DTYPES)}")
    return DTYPES[name]
