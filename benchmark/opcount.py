"""Operations of each measured step, counted from shapes. Frozen: the counts
say what the algorithm needs, whatever implements it, so a fused kernel or a
captured graph does not change them.

Each add, sub, mul, div, sqrt, compare and select is one operation; a fused
multiply-add is two. Special-function calls (exp, tanh, log, sin, cos, sqrt,
rsqrt) are not operations here.

The per-env-step counts of the quadrotor are a copy of the port's hand counts
(`raptor_tpu_torch/apps/roofline.py`, `flop_counts`), counted from its CUDA
sources and `env/quad.py`.
"""

from __future__ import annotations

# -- the quadrotor, per env-step ---------------------------------------------
# one derivative 210; RK4: 4 derivatives, 3 stage updates (34 + 68 + 68),
# combination 51, quaternion renormalization 13, rotor-speed clip 8
FLOPS_RK4_STEP = 4 * 210 + (34 + 68 + 68) + 51 + 13 + 8
FLOPS_TERMINATION = 20
FLOPS_ROLLOUT_STEP = FLOPS_RK4_STEP + FLOPS_TERMINATION
# closed-loop evaluation: observation 30, Dense 22->16 + ReLU 720, GRU matmuls
# 3,072, gates 240, Dense 16->4 + clip 136, setpoints 28, reward 42,
# accumulators 2
FLOPS_EVAL_STEP = FLOPS_ROLLOUT_STEP + 30 + 720 + 3_072 + 240 + 136 + 28 + 42 + 2
# per-step disturbance (six normals by Philox and Box-Muller, scaling, entry
# into the four derivatives)
FLOPS_DISTURBANCE = 198 + 6 + 4 * 12
# a full env step with auto-reset: keyed dynamics, reward and penalty 44,
# termination, step counter 4, the fresh state every env draws (477), the
# reset select 25, two observations with privileged tails (2 x 110)
FLOPS_ENV_STEP = (FLOPS_RK4_STEP + FLOPS_DISTURBANCE + 44 + FLOPS_TERMINATION + 4
                  + (116 + 142 + 204 + 15) + 25 + 2 * 110)

# -- bytes of one evaluation call ------------------------------------------
N_PARAM_ROWS, N_STATE_ROWS, N_STAT_ROWS = 42, 17, 3


def eval_kernel_flops(env_steps: float) -> float:
    """Operations of the evaluation kernel over the env-steps it ran."""
    return float(env_steps) * FLOPS_EVAL_STEP


def eval_kernel_bytes(n_envs: int, n_weights: int) -> float:
    """Each input read once (weights, airframe rows, initial state) and each
    output written once (final state, alive, length, return), float32."""
    return 4.0 * (n_weights + n_envs * (N_PARAM_ROWS + N_STATE_ROWS)
                  + n_envs * (N_STATE_ROWS + N_STAT_ROWS))


# -- dense layers and the GRU, per sample ----------------------------------
def dense_flops(n_in: int, n_out: int) -> int:
    """x @ W^T + b."""
    return 2 * n_in * n_out + n_out


def gru_step_flops(n_in: int, hidden: int) -> int:
    """Both gate matmuls with their biases, then per unit: r and z (add and
    logistic, 4 each), n (add, mul, tanh: 3), h = (1 - z) n + z h (4)."""
    return dense_flops(n_in, 3 * hidden) + dense_flops(hidden, 3 * hidden) + hidden * 15


def student_forward_flops(obs: int = 22, hidden: int = 16, actions: int = 4) -> int:
    """One sample-step of the student in BPTT: the reset select (hidden),
    Dense + ReLU, the GRU step, the head, and the squared error (3 an
    action)."""
    return (hidden + dense_flops(obs, hidden) + hidden + gru_step_flops(hidden, hidden)
            + dense_flops(hidden, actions) + 3 * actions)


def n_student_weights(obs: int = 22, hidden: int = 16, actions: int = 4) -> int:
    return 6 * hidden * hidden + (obs + 1 + 6 + 1 + actions) * hidden + actions


ADAM_FLOPS_PER_WEIGHT = 12  # two moments, two bias corrections, sqrt, eps, scale, update


def bptt_flops(batch: int, seq_len: int, obs: int = 22, hidden: int = 16,
               actions: int = 4) -> float:
    """The loss and its gradient over one minibatch: the forward over batch x
    seq_len sample-steps, and the backward counted as twice the forward."""
    return float(3 * batch * seq_len * student_forward_flops(obs, hidden, actions))


def bptt_bytes(batch: int, seq_len: int, obs: int = 22, hidden: int = 16,
               actions: int = 4) -> float:
    """The gathered minibatch (observations, teacher actions and reset flags,
    float32) and the weights read once; the gradient and the loss written
    once."""
    n_weights = n_student_weights(obs, hidden, actions)
    return 4.0 * (batch * seq_len * (obs + actions + 1) + 2 * n_weights + 1)


def distill_step_flops(batch: int, seq_len: int, obs: int = 22, hidden: int = 16,
                       actions: int = 4) -> float:
    """One gradient step: the loss and its gradient (`bptt_flops`), and Adam
    over the weights."""
    return (bptt_flops(batch, seq_len, obs, hidden, actions)
            + ADAM_FLOPS_PER_WEIGHT * n_student_weights(obs, hidden, actions))


# -- the SAC teacher farm ----------------------------------------------------
def mlp_flops(dims) -> int:
    """Dense layers with ReLU between them."""
    return sum(dense_flops(a, b) for a, b in zip(dims[:-1], dims[1:])) + sum(dims[1:-1])


def sac_update_flops(batch: int, obs: int, actions: int, hidden=(64, 64)) -> float:
    """One SAC update of one learner, forward and backward (2 x forward):
    the critic target (actor on next obs, two target critics), the twin
    critics and their loss (3 a sample a critic), the actor (actor, two
    critics on the fresh action, loss), the temperature loss, the squashed
    Gaussian (about 12 an action) and Polyak over the critics (3 a weight),
    and three Adams."""
    actor = mlp_flops([obs, *hidden, 2 * actions]) + 12 * actions
    critic = mlp_flops([obs + actions, *hidden, 1])
    target = actor + 2 * critic  # no gradient
    critic_train = 3 * (2 * critic + 2 * 3)
    actor_train = 3 * (actor + 2 * critic + 4)
    alpha_train = 3 * 3
    n_actor = sum(a * b + b for a, b in zip([obs, *hidden], [*hidden, 2 * actions]))
    n_critic = 2 * sum(a * b + b for a, b in zip([obs + actions, *hidden], [*hidden, 1]))
    per_sample = target + critic_train + actor_train + alpha_train
    return float(batch * per_sample
                 + ADAM_FLOPS_PER_WEIGHT * (n_actor + n_critic + 1) + 3 * n_critic)


def farm_super_step_flops(n_teachers: int, envs: int, rollout: int, grad_steps: int,
                          batch: int, obs: int, actions: int = 4, hidden=(64, 64)) -> float:
    """One super-step of the population: rollout x envs env steps with the
    actor's sampled action, then grad_steps SAC updates, for each teacher."""
    act = mlp_flops([obs, *hidden, 2 * actions]) + 12 * actions
    collect = rollout * envs * (FLOPS_ENV_STEP + act)
    train = grad_steps * sac_update_flops(batch, obs, actions, hidden)
    return float(n_teachers * (collect + train))
