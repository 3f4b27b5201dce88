"""The BPTT kernels' code (`csrc/bptt_step.cuh`) held to the plain autograd
path on the CPU, and the dispatch around it (`ops/bptt.py`,
`distill.post_training.bptt_actions`).

- `raptor_bptt_host`, the header's forward, backward and gradient sum looped
  over a block's threads phase by phase and over the sequences, at every
  width in `HIDDEN_WIDTHS`, T = 37, B = 5: the actions, and the nine leaves'
  gradients for a random upstream dActions, against `ops.bptt.bptt_plain`
  under `torch.autograd`, within 1e-5 of the larger of the leaf's norm and
  the median leaf's (the sum runs in another order). Resets at the first
  step, at consecutive steps and at the last; none; at every step; and
  observations normalized by `fit_norm` through `bptt_actions`.
- The same at every width and case against the JAX package's `bptt_actions`
  and its `jax.vjp` with the same dActions, at the same tolerance.
- A CPU tensor takes the plain version and launches nothing. On a card, the
  distillation CLI refuses a width the kernels are not built for before it
  loads the teachers.
- Patching `post_training.bptt_actions`, as `benchmark/faults.py`'s
  `altered_output` does, still reaches `bptt_loss`.
"""

import shutil
import statistics

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raptor_tpu.distill import post_training as jpt
from raptor_tpu_torch.apps import post_training as post_training_cli
from raptor_tpu_torch.distill import post_training as pt
from raptor_tpu_torch.ops import bptt as ops_bptt
from raptor_tpu_torch.ops import build
from raptor_tpu_torch.ops.eval import layout, n_weights
from raptor_tpu_torch.policy import network
from raptor_tpu_torch.utils.profiling import launches

T, B = 37, 5
RTOL = 1e-5
CASES = ("resets", "none", "every", "normalized")


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the kernels' code needs it")
    return build.host_library()


def student(hidden, seed=0):
    """init_params of `hidden`, biases and h0 drawn from N(0, 0.1) too, every
    leaf recording gradients."""
    g = torch.Generator().manual_seed(seed)
    params = network.init_params(g, hidden_dim=hidden)
    for layer in params.values():
        for t in layer.values():
            t.add_(0.1 * torch.randn(t.shape, generator=g))
            t.requires_grad_(True)
    return params


def inputs(case, seed=1):
    g = torch.Generator().manual_seed(seed)
    obs = torch.randn((T, B, 22), generator=g) * torch.linspace(0.2, 1.0, 22)
    reset = torch.zeros((T, B))
    if case in ("resets", "normalized"):
        reset = (torch.rand((T, B), generator=g) < 0.1).float()
        reset[0, 0] = 1.0  # step 1 enters a reset
        reset[5:8, 1] = 1.0  # steps 6, 7 and 8 each enter one
        reset[-1] = 1.0  # after the last step: no step enters it
    elif case == "every":
        reset = torch.ones((T, B))
    if case == "normalized":
        obs = obs * 3.0 + 0.5
    return obs, reset, torch.randn((T, B, 4), generator=g)


def leaves_of(params, hidden):
    return [params[layer][name] for layer, name, _ in layout(hidden)]


def run_host(lib, params, obs, reset, d_actions, hidden):
    """(actions [T, B, 4], the nine leaves' gradients) from raptor_bptt_host."""
    leaves = [t.detach().contiguous() for t in leaves_of(params, hidden)]
    actions = torch.empty((T, B, 4))
    grad = torch.empty(n_weights(hidden))
    rc = lib.raptor_bptt_host(*[t.data_ptr() for t in leaves], obs.data_ptr(), reset.data_ptr(),
                              d_actions.data_ptr(), actions.data_ptr(), grad.data_ptr(), T, B,
                              hidden)
    assert rc == 0
    sizes = [t.numel() for t in leaves]
    return actions, [g.view(t.shape) for g, t in zip(torch.split(grad, sizes), leaves)]


def check_host(lib, params, obs, reset, d_actions, norm, hidden, case, want, want_grads):
    """raptor_bptt_host's actions and leaf gradients within RTOL of `want`
    and `want_grads` (torch tensors in the layout's order)."""
    got, got_grads = run_host(lib, params, pt._norm_obs(obs, norm).contiguous(), reset,
                              d_actions, hidden)
    assert float((got - want).abs().max()) <= RTOL * float(want.abs().max())
    median = statistics.median(float(g.norm()) for g in want_grads)
    for (layer, name, _), g, w in zip(layout(hidden), got_grads, want_grads):
        err = float((g - w).norm()) / max(float(w.norm()), median)
        assert err <= RTOL, f"{layer}/{name}: {err:.3e}"
    if case in ("resets", "every", "normalized"):  # h0 receives a gradient at every reset
        assert float(got_grads[6].norm()) > 0.0


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("hidden", build.HIDDEN_WIDTHS)
def test_host_forward_and_backward_match_autograd(host, hidden, case):
    params = student(hidden, seed=hidden)
    obs, reset, d_actions = inputs(case)
    norm = pt.fit_norm(obs) if case == "normalized" else None
    want = pt.bptt_actions(params, obs, reset, norm)  # the CPU path: bptt_plain
    want_grads = torch.autograd.grad(want, leaves_of(params, hidden), d_actions)
    check_host(host, params, obs, reset, d_actions, norm, hidden, case, want.detach(),
               want_grads)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("hidden", build.HIDDEN_WIDTHS)
def test_host_forward_and_backward_match_jax(host, hidden, case):
    params = student(hidden, seed=hidden)
    obs, reset, d_actions = inputs(case)
    norm = pt.fit_norm(obs) if case == "normalized" else None
    jparams = {layer: {name: jnp.asarray(t.detach().numpy()) for name, t in tensors.items()}
               for layer, tensors in params.items()}
    jnorm = None if norm is None else {k: jnp.asarray(v.numpy()) for k, v in norm.items()}
    want, vjp = jax.vjp(lambda p: jpt.bptt_actions(p, jnp.asarray(obs.numpy()),
                                                   jnp.asarray(reset.numpy()), jnorm), jparams)
    (want_grads,) = vjp(jnp.asarray(d_actions.numpy()))
    check_host(host, params, obs, reset, d_actions, norm, hidden, case,
               torch.from_numpy(np.array(want)),
               [torch.from_numpy(np.array(want_grads[layer][name]))
                for layer, name, _ in layout(hidden)])


def test_host_forward_alone_and_unbuilt_width(host):
    params = student(16)
    obs, reset, _ = inputs("resets")
    leaves = [t.detach() for t in leaves_of(params, 16)]
    actions = torch.empty((T, B, 4))
    grad = torch.full((n_weights(16),), 7.0)
    ptrs = [t.data_ptr() for t in leaves]
    assert host.raptor_bptt_host(*ptrs, obs.data_ptr(), reset.data_ptr(), None,
                                 actions.data_ptr(), grad.data_ptr(), T, B, 16) == 0
    with torch.no_grad():
        assert torch.allclose(actions, ops_bptt.bptt_plain(params, obs, reset), atol=1e-6)
    assert bool((grad == 7.0).all())  # no dActions: the forward alone
    assert host.raptor_bptt_host(*ptrs, obs.data_ptr(), reset.data_ptr(), None,
                                 actions.data_ptr(), grad.data_ptr(), T, B, 12) == -1
    with pytest.raises(ValueError, match="built for hidden widths"):
        ops_bptt.require_built(12)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    params = student(16)
    obs, reset, _ = inputs("resets")
    before = launches["bptt"]
    got = ops_bptt.bptt(params, obs, reset)
    assert launches["bptt"] == before == 0
    assert torch.equal(got, ops_bptt.bptt_plain(params, obs, reset))
    assert got.requires_grad


def test_patched_bptt_actions_still_reaches_bptt_loss(monkeypatch):
    params = student(16)
    obs, reset, _ = inputs("resets")
    labels = torch.zeros((T, B, 4))
    clean = float(pt.bptt_loss(params, obs, labels, reset).detach())
    original = pt.bptt_actions
    monkeypatch.setattr(pt, "bptt_actions", lambda *a, **k: original(*a, **k) + 1e-3)
    assert float(pt.bptt_loss(params, obs, labels, reset).detach()) != clean


def test_unbuilt_width_on_a_card_fails_before_the_teachers_load(monkeypatch):
    monkeypatch.setattr(post_training_cli, "resolve_device", lambda _: torch.device("cuda"))
    with pytest.raises(ValueError, match="BPTT kernels are built for hidden widths"):
        post_training_cli.main(["no_such_manifest.txt", "--student-hidden", "12"])
