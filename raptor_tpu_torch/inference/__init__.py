"""Deployment: the multi-rate Python executor (`Executor`, on the card or the
CPU) and the native executor and firmware built from `native/` with g++ and
driven through ctypes on the host."""

from raptor_tpu_torch.inference.executor import Executor, ExecutorConfig  # noqa: F401
from raptor_tpu_torch.inference.native import (  # noqa: F401
    Firmware,
    NativeExecutor,
    PlatformFirmware,
    build_executor,
    build_firmware,
)
