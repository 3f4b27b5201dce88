"""L2F — the quadrotor environment, batched over N envs.

Counterpart of `raptor_tpu/env/quad.py`. Where the JAX environment is written
for one env and vmapped, every method here takes [N]-leading tensors, and an
explicit `torch.Generator` takes the place of the per-env keys:

    env = L2F(EnvConfig())
    params = randomization.sample_population(generator, n)
    es, obs = env.reset(params, generator)
    es, obs, reward, done, info = env.step(params, es, action, generator)

Observation layout (first 22 dims = the policy observation):
    [0:3] position  [3:12] rotation matrix, row-major  [12:15] linear velocity
    [15:18] angular velocity (body)  [18:22] previous action
    [22:] privileged tail (normalized dynamics params; critics only)

`sample_state` and `reset` make every draw first, in the order and shapes
`state_draws` gives, and then derive the states (and the histories and the
observation) from those draws and the airframes alone. The draws' order and
shapes are part of the API: the benchmark's reference draws them again from
the same seed, and the generator's state after a call is that of these
draws. On a card `reset`'s arithmetic runs as one CUDA graph replay
(`utils.graphs`); the auto-reset inside `step` stays eager.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from raptor_tpu_torch.env import dynamics, maths
from raptor_tpu_torch.env.types import (
    DynamicsParams,
    EnvConfig,
    State,
    observation_dim,
    where,
)
from raptor_tpu_torch.utils import graphs
from raptor_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class EnvState:
    """Per-env episode state carried between steps."""

    dynamics: State
    action_history: torch.Tensor  # [N, h, 4] oldest -> newest
    angvel_history: torch.Tensor  # [N, d+1, 3] oldest -> newest
    t: torch.Tensor  # [N] int32 steps since episode start


def terminated_by(
    state: State, pos_bound: float, linvel_bound: float, angvel_bound: float
) -> torch.Tensor:
    """[N] bool: position outside the box, speed or spin above its bound, or a
    non-finite position."""
    return (
        torch.any(torch.abs(state.position) > pos_bound, -1)
        | (torch.sum(state.linear_velocity**2, -1) > linvel_bound**2)
        | (torch.sum(state.angular_velocity**2, -1) > angvel_bound**2)
        | ~torch.all(torch.isfinite(state.position), -1)
    )


def state_draws(n: int):
    """The draws of `L2F.sample_state` and `L2F.reset` for n envs, in order:
    `(kind, shape)` each, as `graphs.draw` makes them. Their order and shapes
    are part of the API: the benchmark's reference (`benchmark/reference/
    quad.py` `sample_states`) draws them again from the same seed."""
    return (
        ("rand", (n, 3)),  # position in the box
        ("randn", (n, 3)),  # rotation axis (maths.random_quaternion)
        ("rand", (n,)),  # rotation angle
        ("randn", (n, 3)),  # linear velocity
        ("randn", (n, 3)),  # angular velocity
    )


# the airframes' leaves the arithmetic of a reset reads: its initial rotor
# speeds and the observation's privileged tail
RESET_READS = ("mass", "inertia_diag", "thrust_curve", "rpm_min", "rpm_max",
               "torque_constant", "motor_time_constant", "rotor_positions")

_GRAPHED = graphs.Graphed("reset")


def _as_reset(leaves) -> Tuple[EnvState, torch.Tensor]:
    """(env state, observation) from the leaves of `L2F._leaves_of_reset`;
    the step counter is made here, zero."""
    position, orientation, linvel, angvel, rpm, action_history, angvel_history, obs = leaves
    es = EnvState(
        dynamics=State(position, orientation, linvel, angvel, rpm),
        action_history=action_history,
        angvel_history=angvel_history,
        t=torch.zeros(position.shape[0], dtype=torch.int32, device=position.device),
    )
    return es, obs


class L2F:
    """The environment. The static config lives on the object; all dynamic
    data flows through the arguments."""

    def __init__(self, config: EnvConfig = EnvConfig()):
        self.config = config

    @property
    def OBSERVATION_DIM(self) -> int:  # noqa: N802  (l2f-compat naming)
        return observation_dim(self.config)

    @property
    def EPISODE_LENGTH(self) -> int:  # noqa: N802
        return self.config.episode_length

    # -- sampling --------------------------------------------------------
    def sample_state(self, params: DynamicsParams, generator: torch.Generator) -> State:
        """Randomized initial states, one per airframe in `params`: the draws
        of `state_draws`, then `_state_from_draws`."""
        n = params.mass.shape[0]
        return self._state_from_draws(params, graphs.draw(generator, state_draws(n)))

    def _state_from_draws(self, params: DynamicsParams, draws) -> State:
        """The arithmetic of `sample_state` on its draws; reads `mass` and
        `thrust_curve` (`rpm_min` where the rotors do not start at hover)."""
        c = self.config.init
        u_pos, axis, u_angle, linvel, angvel = draws
        n = u_pos.shape[0]
        position = -c.position_range + u_pos * (2.0 * c.position_range)
        orientation = maths.quaternion_from_draws(axis, u_angle, c.max_angle, c.angle_power)
        linear_velocity = linvel * c.linear_velocity_std
        angular_velocity = angvel * c.angular_velocity_std
        rpm = dynamics.hover_rpm(params) if c.rpm_at_hover else params.rpm_min
        return State(
            position=position,
            orientation=orientation,
            linear_velocity=linear_velocity,
            angular_velocity=angular_velocity,
            rpm=rpm[:, None].expand(n, 4).contiguous(),
        )

    # -- observation -----------------------------------------------------
    def privileged_tail(self, params: DynamicsParams) -> torch.Tensor:
        """Normalized dynamics parameters for critics, [N, 9]."""
        t2w = torch.sum(
            dynamics.rotor_thrusts(params, params.rpm_max[:, None].expand(-1, 4)), -1
        ) / (params.mass * 9.81)
        arm = torch.mean(torch.linalg.norm(params.rotor_positions, dim=-1), -1)
        return torch.stack(
            [
                torch.log(params.mass / 0.25),
                torch.log(params.inertia_diag[:, 0] / 1e-3),
                torch.log(params.inertia_diag[:, 2] / 1e-3),
                t2w / 4.0,
                params.torque_constant / 0.05,
                torch.log(params.motor_time_constant / 0.05),
                params.rpm_min,
                arm / 0.25,
                dynamics.hover_action(params),
            ],
            -1,
        )

    def observe(
        self,
        params: DynamicsParams,
        state: State,
        action_history: torch.Tensor,  # [N, 4] (h == 1 shorthand) or [N, h, 4]
        angvel_history: Optional[torch.Tensor] = None,  # [N, d+1, 3]
    ) -> torch.Tensor:
        """Observation [N, obs_dim]: policy observation + privileged tail."""
        n = state.position.shape[0]
        if action_history.dim() == 2:
            if self.config.observation.action_history_length != 1:
                raise ValueError("pass the full [N, h, 4] history when h > 1")
            action_history = action_history[:, None]
        angvel = state.angular_velocity if angvel_history is None else angvel_history[:, 0]
        parts = [
            state.position,
            maths.quat_to_rotm(state.orientation).reshape(n, 9),
            state.linear_velocity,
            angvel,
            action_history.reshape(n, -1),
        ]
        if self.config.observation.privileged:
            parts.append(self.privileged_tail(params))
        return torch.cat(parts, -1).float()

    # -- reward / termination -------------------------------------------
    def reward(
        self,
        params: DynamicsParams,
        state: State,
        action: torch.Tensor,
        next_state: State,
    ) -> torch.Tensor:
        """Weighted quadratic costs + survival constant, [N]."""
        c = self.config.reward
        pos_cost = torch.sum(next_state.position**2, -1)
        orient_cost = 2.0 * (1.0 - torch.abs(next_state.orientation[:, 0]))
        linvel_cost = torch.sum(next_state.linear_velocity**2, -1)
        angvel_cost = torch.sum(next_state.angular_velocity**2, -1)
        action_cost = torch.sum((action - dynamics.hover_action(params)[:, None]) ** 2, -1)
        return c.scale * (
            c.constant
            - c.position_weight * pos_cost
            - c.orientation_weight * orient_cost
            - c.linear_velocity_weight * linvel_cost
            - c.angular_velocity_weight * angvel_cost
            - c.action_weight * action_cost
        )

    def terminated(self, params: DynamicsParams, state: State) -> torch.Tensor:
        c = self.config.termination
        return terminated_by(
            state, c.position_bound, c.linear_velocity_bound, c.angular_velocity_bound
        )

    # -- episode API -----------------------------------------------------
    def reset(
        self, params: DynamicsParams, generator: torch.Generator
    ) -> Tuple[EnvState, torch.Tensor]:
        """Fresh episodes, one per airframe in `params`: (env state,
        observation).

        The draws come first (`state_draws`, on `generator`), then the
        arithmetic, which reads the airframes' `RESET_READS` alone. On a
        card that arithmetic is one CUDA graph replay from the third call
        with the same sizes, configs and device (`utils.graphs`), and the
        float leaves of the result are views of one buffer of the call's
        own. A subclass that draws its own initial states (`sample_state`
        overridden) cannot be keyed: it takes the eager `_reset`."""
        with span("env.reset"):
            if type(self).sample_state is not L2F.sample_state:
                return self._reset(params, generator)
            n = params.mass.shape[0]
            leaves = [getattr(params, k) for k in RESET_READS]
            key = (type(self), n, self.config.init, self.config.observation,
                   tuple(x.shape for x in leaves))
            return _as_reset(_GRAPHED(key, generator, state_draws(n), self._reset_from_draws,
                                      leaves))

    def _reset(
        self, params: DynamicsParams, generator: torch.Generator
    ) -> Tuple[EnvState, torch.Tensor]:
        """`reset`, eager and without its span: `step` draws the auto-reset
        states every time step."""
        return _as_reset(self._leaves_of_reset(params, self.sample_state(params, generator)))

    def _reset_from_draws(self, draws, leaves):
        """The arithmetic of `reset` on the draws of `state_draws` and the
        airframes' `RESET_READS` (the graph's body): every other leaf of the
        airframes is None here, so that reading one fails."""
        fields = {f.name: None for f in dataclasses.fields(DynamicsParams)}
        params = DynamicsParams(**{**fields, **dict(zip(RESET_READS, leaves))})
        return self._leaves_of_reset(params, self._state_from_draws(params, draws))

    def _leaves_of_reset(self, params: DynamicsParams, state: State):
        """The float leaves of a reset from its initial states: the state's
        five, the two histories and the observation."""
        n = state.position.shape[0]
        h = self.config.observation.action_history_length
        d = self.config.observation.angular_velocity_delay
        action_history = state.position.new_zeros((n, h, 4))
        angvel_history = state.angular_velocity[:, None].expand(n, d + 1, 3).contiguous()
        obs = self.observe(params, state, action_history, angvel_history)
        return [state.position, state.orientation, state.linear_velocity,
                state.angular_velocity, state.rpm, action_history, angvel_history, obs]

    def dynamics_step(
        self,
        params: DynamicsParams,
        state: State,
        action: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[State, float]:
        """Pure dynamics advance; disturbances drawn per control step when a
        generator is given."""
        if generator is None:
            ext_f = torch.zeros_like(state.position)
            ext_t = torch.zeros_like(state.position)
        else:
            shape, dev = state.position.shape, generator.device
            ext_f = torch.randn(shape, generator=generator, device=dev) * (
                params.disturbance_force_std[:, None]
            )
            ext_t = torch.randn(shape, generator=generator, device=dev) * (
                params.disturbance_torque_std[:, None]
            )
        return dynamics.sub_step(
            params, state, action, self.config.dt, ext_f, ext_t, self.config.integrator
        )

    def step(
        self,
        params: DynamicsParams,
        es: EnvState,
        action: torch.Tensor,
        generator: torch.Generator,
    ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor, dict]:
        """Full env step with auto-reset: (next_env_state, obs, reward, done,
        info). `done` is termination or truncation at the episode length."""
        action = torch.clamp(action, -1.0, 1.0)
        next_state, _ = self.dynamics_step(params, es.dynamics, action, generator)
        reward = self.reward(params, es.dynamics, action, next_state)
        terminated = self.terminated(params, next_state)
        reward = reward - self.config.reward.termination_penalty * terminated
        t_next = es.t + 1
        truncated = t_next >= self.config.episode_length
        done = terminated | truncated

        reset_es, _ = self._reset(params, generator)
        action_history = torch.cat([es.action_history[:, 1:], action[:, None]], 1)
        angvel_history = torch.cat(
            [es.angvel_history[:, 1:], next_state.angular_velocity[:, None]], 1
        )
        cont_es = EnvState(
            dynamics=next_state,
            action_history=action_history,
            angvel_history=angvel_history,
            t=t_next,
        )
        next_es = where(done, reset_es, cont_es)
        obs = self.observe(
            params, next_es.dynamics, next_es.action_history, next_es.angvel_history
        )
        info = {
            "terminated": terminated,
            "truncated": truncated,
            # observation of the true (pre-reset) next state
            "final_obs": self.observe(params, next_state, action_history, angvel_history),
        }
        return next_es, obs, reward, done, info

    def vector_ops(self):
        """(reset, step): already batched over the leading env axis."""
        return self.reset, self.step
