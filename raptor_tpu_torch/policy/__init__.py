from raptor_tpu_torch.policy import network  # noqa: F401
from raptor_tpu_torch.policy.raptor import Raptor, shipped_checkpoint_path  # noqa: F401
