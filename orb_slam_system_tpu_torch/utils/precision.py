"""Full-f32 matmul precision for the whole port.

TF32 keeps ~10 mantissa bits. In the pose solver's normal equations or any
geometric product it would bring back the reduced-precision solver
divergence the JAX package recorded on its accelerator (its
utils/precision.py). The policy is set by the FrameBuilder and TrackPrograms
constructors, never as an import side effect.
"""

from __future__ import annotations

import torch


def set_f32_policy() -> None:
    """Turn TF32 off for matmuls and cuDNN; float32 matmuls run in full
    precision ("highest")."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
