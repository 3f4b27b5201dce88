"""Faults planted in the program's timed path, to show that the check
catches them (`tests/test_bench_faults.py` at a small size on the CPU,
`control.py --fault` at the cell's own size on the card). Each is a context
manager that patches the port's module for its duration:

- `unchanged_state`: a step that returns its state unchanged;
- `half_batch`: half of the batch left out, the mean taken over the rest;
- `altered_output`: the output altered where it is produced.

A cell on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, make):
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


# -- distillation ---------------------------------------------------------
def _distill_unchanged_state():
    from raptor_tpu_torch.distill import post_training as pt

    def make(original):
        def grad_step(student, opt, *args, **kw):
            before = [t.detach().clone() for d in student.values() for t in d.values()]
            loss = original(student, opt, *args, **kw)
            with torch.no_grad():
                for t, b in zip((t for d in student.values() for t in d.values()), before):
                    t.copy_(b)
            return loss
        return grad_step

    return _patched(pt, "_grad_step", make)


def _distill_half_batch():
    from raptor_tpu_torch.distill import post_training as pt

    def make(original):
        def loss(student, obs, teacher_action, reset, *args, **kw):
            half = obs.shape[1] // 2
            return original(student, obs[:, :half], teacher_action[:, :half], reset[:, :half],
                            *args, **kw)
        return loss

    return _patched(pt, "bptt_loss", make)


def _distill_altered_output():
    from raptor_tpu_torch.distill import post_training as pt

    def make(original):
        def actions(*args, **kw):
            return original(*args, **kw) + 1e-3
        return actions

    return _patched(pt, "bptt_actions", make)


# -- closed-loop evaluation ----------------------------------------------------
def _eval_patch(change):
    from raptor_tpu_torch.ops import eval as ops_eval

    def make(original):
        def eval_soa(weights, params_soa, state_soa, *args, **kw):
            return change(original, weights, params_soa, state_soa, *args, **kw)
        return eval_soa

    return _patched(ops_eval, "eval_soa", make)


def _eval_unchanged_state():
    def change(original, weights, params, state, *args, **kw):
        _, stats = original(weights, params, state, *args, **kw)
        return state.clone(), stats

    return _eval_patch(change)


def _eval_half_batch():
    def change(original, weights, params, state, *args, **kw):
        half = state.shape[1] // 2
        out, stats = original(weights, params[:, :half].contiguous(),
                              state[:, :half].contiguous(), *args, **kw)
        full_out = state.clone()
        full_out[:, :half] = out
        full_stats = torch.zeros((3, state.shape[1]), device=state.device)
        full_stats[0] = 1.0
        full_stats[:, :half] = stats
        return full_out, full_stats

    return _eval_patch(change)


def _eval_altered_output():
    def change(original, *args, **kw):
        out, stats = original(*args, **kw)
        stats = stats.clone()
        stats[2] *= 1.0 + 1e-3
        return out, stats

    return _eval_patch(change)


# -- the teacher farm ---------------------------------------------------------
def _farm_unchanged_state():
    from raptor_tpu_torch.rl import networks, sac

    def make(original):
        def update(state, *args, **kw):
            learners = (state.actor, state.critic, state.target_critic)
            before = [t.detach().clone() for t in networks.tree_leaves(learners)]
            before.append(state.log_alpha.detach().clone())
            state, metrics = original(state, *args, **kw)
            with torch.no_grad():
                after = networks.tree_leaves(learners) + [state.log_alpha]
                for t, b in zip(after, before):
                    t.copy_(b)
            return state, metrics
        return update

    return _patched(sac, "sac_update", make)


def _farm_half_batch():
    from raptor_tpu_torch.rl import sac

    def make(original):
        def update(state, generator, batch, *args, **kw):
            half = batch[0].shape[-2] // 2
            return original(state, generator, tuple(x[..., :half, :] if x.dim() == 3 else
                                                    x[..., :half] for x in batch), *args, **kw)
        return update

    return _patched(sac, "sac_update", make)


def _farm_altered_output():
    from raptor_tpu_torch.rl import networks

    def make(original):
        def squash(*args, **kw):
            action, log_prob = original(*args, **kw)
            return action + 1e-3, log_prob
        return squash

    return _patched(networks, "sample_and_squash", make)


FAULTS = {
    "distill": {"unchanged_state": _distill_unchanged_state,
                "half_batch": _distill_half_batch,
                "altered_output": _distill_altered_output},
    "eval": {"unchanged_state": _eval_unchanged_state,
             "half_batch": _eval_half_batch,
             "altered_output": _eval_altered_output},
    "farm": {"unchanged_state": _farm_unchanged_state,
             "half_batch": _farm_half_batch,
             "altered_output": _farm_altered_output},
}


def planted(kind: str, name: str):
    """The context manager that plants fault `name` in a cell of `kind`."""
    return FAULTS[kind][name]()
