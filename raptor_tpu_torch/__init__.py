"""raptor_tpu_torch — the PyTorch / CUDA port of `raptor_tpu`, for NVIDIA
Hopper (H100).

The JAX package stays the reference; this package keeps its layout (`env/`,
`policy/`, `checkpoint/`, `ops/`, `rl/`, `apps/`) so each counterpart is easy
to find, imports neither JAX nor `raptor_tpu`, and runs its hot loops in
hand-written CUDA kernels (`csrc/`). Entry points run on the card unless the
caller passes `device="cpu"`, which takes the kernels' plain PyTorch versions.
"""

import torch

# The JAX reference runs matmuls in full f32; keep TF32 off on the card too.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from raptor_tpu_torch.policy.raptor import Raptor  # noqa: E402,F401
