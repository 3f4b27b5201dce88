"""Plain reference of one DAgger distillation step of the RAPTOR student:
the minibatch gather from the aggregate, full-sequence BPTT of the GRU policy
with the hidden state re-injected at its learned initial value where an
episode restarts, the MSE against the teacher labels, and Adam (eps outside
the square root) under the warm-up-cosine learning rate.

It imports nothing of the system under test, and computes in float32 with
TF32 off, or with `precision="tf32"` as the control.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from reference.tf32 import matmul

LAYOUT = (  # (name, shape at hidden width H, fan-in for the initial draw or None for zeros)
    ("dense_0/weights", lambda h: (h, 22), 22),
    ("dense_0/biases", lambda h: (h,), None),
    ("gru_1/weights_input", lambda h: (3 * h, h), "h"),
    ("gru_1/weights_hidden", lambda h: (3 * h, h), "h"),
    ("gru_1/biases_input", lambda h: (3 * h,), None),
    ("gru_1/biases_hidden", lambda h: (3 * h,), None),
    ("gru_1/initial_hidden_state", lambda h: (h,), None),
    ("dense_2/weights", lambda h: (4, h), "h"),
    ("dense_2/biases", lambda h: (4,), None),
)


def init_weights(g: torch.Generator, hidden: int) -> Dict[str, torch.Tensor]:
    """The student's initial weights: uniform +-1/sqrt(fan_in) matrices, zero
    biases and initial hidden state, drawn in layout order."""
    out = {}
    for name, shape, fan_in in LAYOUT:
        size = shape(hidden)
        if fan_in is None:
            out[name] = torch.zeros(size, device=g.device)
        else:
            bound = 1.0 / math.sqrt(hidden if fan_in == "h" else fan_in)
            out[name] = -bound + torch.rand(size, generator=g, device=g.device) * (2.0 * bound)
    return out


def lr_at(step: int, cfg: dict) -> float:
    """Learning rate of optimizer step `step` (0-based): 0.1 lr rising
    linearly to lr over the warm-up, then a cosine to lr * final_scale at
    total_grad_steps."""
    lr, total = cfg["learning_rate"], cfg["total_grad_steps"]
    warmup = max(1, int(total * cfg["lr_warmup_frac"]))
    if step < warmup:
        return (0.1 * lr - lr) * (1.0 - step / warmup) + lr
    c = min(step - warmup, total - warmup)
    cosine = 0.5 * (1.0 + math.cos(math.pi * c / (total - warmup)))
    return lr * ((1.0 - cfg["lr_final_scale"]) * cosine + cfg["lr_final_scale"])


def bptt_loss(w, obs, label, reset, precision: str = "float32") -> torch.Tensor:
    """MSE over [T, B, 4] of the student's actions against the labels;
    reset[t] = 1 restarts the hidden state after step t, and the first step
    starts from the initial state."""
    t_len, b = obs.shape[:2]
    h0 = w["gru_1/initial_hidden_state"].expand(b, -1)
    n_h = h0.shape[-1]
    h, sq = h0, 0.0
    for t in range(t_len):
        if t == 0:
            h = h0
        else:
            h = torch.where(reset[t - 1][:, None] != 0, h0, h)
        x = torch.relu(matmul(obs[t], w["dense_0/weights"].T, precision) + w["dense_0/biases"])
        gi = matmul(x, w["gru_1/weights_input"].T, precision) + w["gru_1/biases_input"]
        gh = matmul(h, w["gru_1/weights_hidden"].T, precision) + w["gru_1/biases_hidden"]
        r = torch.sigmoid(gi[:, :n_h] + gh[:, :n_h])
        z = torch.sigmoid(gi[:, n_h:2 * n_h] + gh[:, n_h:2 * n_h])
        cand = torch.tanh(gi[:, 2 * n_h:] + r * gh[:, 2 * n_h:])
        h = (1.0 - z) * cand + z * h
        action = matmul(h, w["dense_2/weights"].T, precision) + w["dense_2/biases"]
        sq = sq + torch.sum((action - label[t]) ** 2)
    return sq / (t_len * b * 4)


class Adam:
    """Adam with the bias corrections and eps = 1e-8 outside the square root."""

    def __init__(self, weights: Dict[str, torch.Tensor], b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps, self.count = b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in weights.items()}
        self.v = {k: torch.zeros_like(v) for k, v in weights.items()}

    def step(self, weights, grads, lr: float):
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for k in weights:
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * grads[k]
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * grads[k] ** 2
            denom = torch.sqrt(self.v[k]) / math.sqrt(c2) + self.eps
            weights[k] = weights[k] - (lr / c1) * self.m[k] / denom
        return weights


def train_steps(w0, batches: List[tuple], cfg: dict, precision: str = "float32",
                moment_after: int = 1):
    """Steps of BPTT + Adam from the weights `w0` over the given minibatches
    ((obs, label, reset) in float32, [T, B, ...]). Returns (losses, Adam's
    first moment after `moment_after` steps over (1 - beta1), by leaf: the
    first gradient where that is one step, the weights after the last
    step)."""
    w = {k: v.clone() for k, v in w0.items()}
    opt = Adam(w)
    losses, moment = [], None
    for i, (obs, label, reset) in enumerate(batches):
        leaves = {k: v.detach().requires_grad_(True) for k, v in w.items()}
        loss = bptt_loss(leaves, obs, label, reset, precision)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            w = opt.step({k: v.detach() for k, v in leaves.items()}, grads, lr_at(i, cfg))
        if i + 1 == moment_after:
            moment = {k: m / (1.0 - opt.b1) for k, m in opt.m.items()}
    return losses, moment, w
