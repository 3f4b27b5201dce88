from raptor_tpu_torch.env.types import (  # noqa: F401
    POLICY_OBS_DIM,
    DynamicsParams,
    EnvConfig,
    InitConfig,
    ObservationConfig,
    RewardConfig,
    State,
    TerminationConfig,
    eval_parity_init,
    observation_dim,
)
from raptor_tpu_torch.env.quad import EnvState, L2F  # noqa: F401
from raptor_tpu_torch.env.randomization import (  # noqa: F401
    RandomizationConfig,
    sample_dynamics_params,
    sample_population,
)
from raptor_tpu_torch.env import dynamics, maths, presets  # noqa: F401
