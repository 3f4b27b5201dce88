"""Multi-device runs of the port: one process a device under
`torch.distributed` (`multihost`), and the layout of the training state over
those processes (`mesh`). Counterpart of `raptor_tpu/parallel/`."""

from raptor_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    distill_block,
    gather_distill_columns,
    local_block,
    make_mesh,
    mesh_shape,
    replicate_pytree,
    round_teacher_block,
    shard_buffer_pytree,
    shard_distill_config,
    shard_env_pytree,
    shard_runner_config,
    shard_trainer_state,
)
