"""The distillation step's backpropagation through time: the student's
actions over [T, B] sequences with the reset-masked hidden carry, and their
gradient, as one forward and one backward CUDA kernel (`csrc/bptt.cu` over
`csrc/bptt_step.cuh`) in place of a Python loop of T `apply_step` calls under
autograd.

Counterpart of the JAX package's `lax.scan` under `jax.value_and_grad`
(`raptor_tpu/distill/post_training.py` `bptt_actions`); no Pallas kernel.

`bptt` is the wrapper: a CPU tensor takes `bptt_plain` (the eager loop); a
CUDA tensor launches the forward kernel, through the `torch.autograd.Function`
`_Bptt` where a leaf records gradients (its backward launches the backward
kernel and the sum of the sequences' gradient rows), or raises. Each launch
counts in `utils.profiling.launches`: 1 a forward, 2 a backward.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from raptor_tpu_torch.ops import build
from raptor_tpu_torch.ops.eval import layout, n_weights
from raptor_tpu_torch.ops.eval import require_built as eval_require_built
from raptor_tpu_torch.ops.rollout import check_tensor
from raptor_tpu_torch.policy import network
from raptor_tpu_torch.utils.profiling import launches

OBS, ACT = network.OBS_DIM, network.ACTION_DIM
SAVED_ROWS = 6  # saved a step and sequence: h entering, x, r, z, n, wh_n h + bh_n


def bptt_plain(student_params, obs, reset):
    """Student actions [T, B, 4] over obs [T, B, 22], in plain PyTorch: T
    `apply_step` calls, the hidden state entering step t the learned initial
    state where t == 0 or reset[t - 1] != 0."""
    b = obs.shape[1]
    h0 = network.initial_hidden(student_params, b)
    entering_reset = torch.cat([torch.ones_like(reset[:1]), reset[:-1]]) != 0
    h = h0
    actions = []
    for t in range(obs.shape[0]):
        h = torch.where(entering_reset[t][:, None], h0, h)
        h, action = network.apply_step(student_params, h, obs[t])
        actions.append(action)
    return torch.stack(actions)


def _pointers(leaves):
    return [t.data_ptr() for t in leaves]


def _forward(obs, reset, leaves, save: bool):
    """Launch the forward kernel: (actions [T, B, 4], saved [T, B, 6, H] or
    None)."""
    hidden, (t_len, b) = leaves[6].shape[-1], reset.shape
    actions = torch.empty((t_len, b, ACT), dtype=torch.float32, device=obs.device)
    saved = (torch.empty((t_len, b, SAVED_ROWS, hidden), dtype=torch.float32, device=obs.device)
             if save else None)
    lib = build.cuda_library()
    with torch.cuda.device(obs.device):
        rc = getattr(lib, f"raptor_bptt_forward_{hidden}")(
            *_pointers(leaves), obs.data_ptr(), reset.data_ptr(), actions.data_ptr(),
            None if saved is None else saved.data_ptr(), t_len, b,
            torch.cuda.current_stream(obs.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"raptor_bptt_forward launch failed: CUDA error {rc}")
    launches["bptt"] += 1
    return actions, saved


def _backward(obs, reset, saved, leaves, d_actions):
    """Launch the backward kernel and the sum of its per-sequence rows over
    the forward's `saved` activations and the upstream d_actions [T, B, 4]:
    the flat gradient [n_weights(H)] in the order of `leaves`."""
    hidden, (t_len, b) = leaves[6].shape[-1], reset.shape
    d_actions = d_actions.contiguous()
    partial = torch.empty((b, n_weights(hidden)), dtype=torch.float32, device=obs.device)
    grad = torch.empty(n_weights(hidden), dtype=torch.float32, device=obs.device)
    lib = build.cuda_library()
    with torch.cuda.device(obs.device):
        rc = getattr(lib, f"raptor_bptt_backward_{hidden}")(
            *_pointers(leaves), obs.data_ptr(), reset.data_ptr(), saved.data_ptr(),
            d_actions.data_ptr(), partial.data_ptr(), grad.data_ptr(), t_len, b,
            torch.cuda.current_stream(obs.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"raptor_bptt_backward launch failed: CUDA error {rc}")
    launches["bptt"] += 2
    return grad


class _Bptt(torch.autograd.Function):
    """actions = the student's forward over (obs, reset) from its nine leaves
    (in the flat policy layout's order); the gradient of each leaf comes from
    the backward kernel, none for obs and reset."""

    @staticmethod
    def forward(ctx, obs, reset, *leaves):
        actions, saved = _forward(obs, reset, leaves, save=True)
        ctx.save_for_backward(obs, reset, saved, *leaves)
        return actions

    @staticmethod
    @once_differentiable
    def backward(ctx, d_actions):
        obs, reset, saved, *leaves = ctx.saved_tensors
        grad, views, off = _backward(obs, reset, saved, leaves, d_actions), [], 0
        for _, _, shape in layout(leaves[6].shape[-1]):
            size = torch.Size(shape).numel()
            views.append(grad[off : off + size].view(shape))
            off += size
        return (None, None, *views)


def require_built(hidden: int, obs_dim: int = OBS) -> None:
    """Raise ValueError, naming the built widths, unless the BPTT kernels are
    built for this hidden width and observation width."""
    eval_require_built(hidden, obs_dim, kernels="BPTT",
                       instead="train other widths on the CPU (ops.bptt.bptt_plain)")


def bptt(student_params, obs, reset):
    """Student actions [T, B, 4] over obs [T, B, 22] f32 with reset [T, B]
    (the hidden state entering step t is the learned initial state where
    t == 0 or reset[t - 1] != 0), differentiable in the student's leaves.
    On the CPU `bptt_plain`; on a CUDA device the kernels, for a student of a
    width in build.HIDDEN_WIDTHS (else ValueError). Does not synchronize."""
    device = obs.device
    if device.type == "cpu":
        return bptt_plain(student_params, obs, reset)
    if device.type != "cuda":
        raise ValueError(f"no BPTT kernel for device {device}")
    hidden = student_params["gru_1"]["initial_hidden_state"].shape[-1]
    require_built(hidden, obs.shape[-1])
    obs, reset = obs.contiguous(), reset.to(torch.float32).contiguous()
    t_len, b = reset.shape
    check_tensor("obs", obs, (t_len, b, OBS), device)
    check_tensor("reset", reset, (t_len, b), device)
    leaves = []
    for layer, name, shape in layout(hidden):
        leaf = student_params[layer][name]
        check_tensor(f"{layer}/{name}", leaf, shape, device)
        leaves.append(leaf)
    if torch.is_grad_enabled() and any(leaf.requires_grad for leaf in leaves):
        return _Bptt.apply(obs, reset, *leaves)
    return _forward(obs, reset, leaves, save=False)[0]
