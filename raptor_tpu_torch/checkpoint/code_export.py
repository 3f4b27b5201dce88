"""Code export: emit the policy as a standalone, dependency-free C++ header.

Copy of `raptor_tpu/checkpoint/code_export.py` (numpy only), so the port never
imports the JAX package. The header is a self-contained C++17 file with
constexpr weight arrays, a plain-C inference routine (dense -> GRU (r, z, n)
-> dense) and a self-test against the embedded golden I/O; it needs no
framework headers. For the same parameters and golden I/O its text equals the
JAX package's byte for byte, banner line included, so a header made by either
package builds the same `native/executor.cpp` and firmware.

`inference/native.py` compiles it with g++.
"""

from __future__ import annotations

import io
from typing import Any, Dict, Optional

import numpy as np


def _fmt_array(name: str, arr: np.ndarray, indent: str = "") -> str:
    flat = np.asarray(arr, np.float32).reshape(-1)
    dims = "".join(f"[{d}]" for d in arr.shape) if arr.ndim else "[1]"
    body = ", ".join(f"{v:.9e}f" for v in flat)
    return f"{indent}alignas(16) static const float {name}{dims} = {{{body}}};\n"


def export_header(
    params: Dict[str, Any],
    example_input: Optional[np.ndarray] = None,
    example_output: Optional[np.ndarray] = None,
    namespace: str = "raptor_checkpoint",
    checkpoint_name: str = "",
) -> str:
    """Render the C++ header as a string.

    params: the policy pytree (h5 schema shapes, SURVEY §A.1).
    example_*: golden I/O ([T, B, 22] / [T, B, 4]); embedded for the
    compiled-in self-test (reference README:136-137,155 semantics).
    """
    p = {k: {kk: np.asarray(vv, np.float32) for kk, vv in v.items()} for k, v in params.items()}
    d0w, d0b = p["dense_0"]["weights"], p["dense_0"]["biases"].reshape(-1)
    g = p["gru_1"]
    d2w, d2b = p["dense_2"]["weights"], p["dense_2"]["biases"].reshape(-1)
    hidden = d0w.shape[0]
    obs_dim = d0w.shape[1]
    act_dim = d2w.shape[0]

    out = io.StringIO()
    w = out.write
    w("// Auto-generated by raptor_tpu.checkpoint.code_export — standalone policy.\n")
    w("// Network: Dense(%d->%d, ReLU) -> GRU(%d, learned h0) -> Dense(%d->%d).\n"
      % (obs_dim, hidden, hidden, hidden, act_dim))
    w("// GRU gate order (r,z,n); reset gates hidden pre-activation post-bias.\n")
    if checkpoint_name:
        w(f"// checkpoint: {checkpoint_name}\n")
    w("#pragma once\n#include <cmath>\n#include <cstddef>\n\n")
    w(f"namespace {namespace} {{\n\n")
    w(f"constexpr std::size_t OBS_DIM = {obs_dim};\n")
    w(f"constexpr std::size_t HIDDEN_DIM = {hidden};\n")
    w(f"constexpr std::size_t ACTION_DIM = {act_dim};\n\n")
    w(_fmt_array("W0", d0w))
    w(_fmt_array("B0", d0b))
    w(_fmt_array("WI", g["weights_input"]))
    w(_fmt_array("WH", g["weights_hidden"]))
    w(_fmt_array("BI", g["biases_input"]))
    w(_fmt_array("BH", g["biases_hidden"]))
    w(_fmt_array("H0", g["initial_hidden_state"]))
    w(_fmt_array("W2", d2w))
    w(_fmt_array("B2", d2b))
    w(
        """
inline void reset(float* h) {
    for (std::size_t i = 0; i < HIDDEN_DIM; ++i) h[i] = H0[i];
}

// One policy step. obs[OBS_DIM], h[HIDDEN_DIM] (updated in place when
// commit, else left untouched), action[ACTION_DIM].
inline void evaluate_step(const float* obs, float* h, float* action,
                          bool commit = true) {
    float x[HIDDEN_DIM];
    for (std::size_t i = 0; i < HIDDEN_DIM; ++i) {
        float acc = B0[i];
        for (std::size_t j = 0; j < OBS_DIM; ++j) acc += W0[i][j] * obs[j];
        x[i] = acc > 0.0f ? acc : 0.0f;
    }
    float gi[3 * HIDDEN_DIM], gh[3 * HIDDEN_DIM];
    for (std::size_t i = 0; i < 3 * HIDDEN_DIM; ++i) {
        float ai = BI[i], ah = BH[i];
        for (std::size_t j = 0; j < HIDDEN_DIM; ++j) {
            ai += WI[i][j] * x[j];
            ah += WH[i][j] * h[j];
        }
        gi[i] = ai;
        gh[i] = ah;
    }
    float h_new[HIDDEN_DIM];
    for (std::size_t i = 0; i < HIDDEN_DIM; ++i) {
        const float r = 1.0f / (1.0f + std::exp(-(gi[i] + gh[i])));
        const float z = 1.0f / (1.0f + std::exp(-(gi[HIDDEN_DIM + i] + gh[HIDDEN_DIM + i])));
        const float n = std::tanh(gi[2 * HIDDEN_DIM + i] + r * gh[2 * HIDDEN_DIM + i]);
        h_new[i] = (1.0f - z) * n + z * h[i];
    }
    for (std::size_t i = 0; i < ACTION_DIM; ++i) {
        float acc = B2[i];
        for (std::size_t j = 0; j < HIDDEN_DIM; ++j) acc += W2[i][j] * h_new[j];
        action[i] = acc;
    }
    if (commit) {
        for (std::size_t i = 0; i < HIDDEN_DIM; ++i) h[i] = h_new[i];
    }
}
"""
    )
    if example_input is not None and example_output is not None:
        ei = np.asarray(example_input, np.float32)
        eo = np.asarray(example_output, np.float32)
        t, b = ei.shape[0], ei.shape[1]
        w(f"\nconstexpr std::size_t EXAMPLE_T = {t};\n")
        w(f"constexpr std::size_t EXAMPLE_B = {b};\n")
        w(_fmt_array("EXAMPLE_INPUT", ei))
        w(_fmt_array("EXAMPLE_OUTPUT", eo))
        w(
            """
// Replay the embedded golden I/O; returns max abs error (self-test,
// analogous to the reference's compiled-in startup test).
inline float self_test() {
    float h[EXAMPLE_B][HIDDEN_DIM];
    for (std::size_t bb = 0; bb < EXAMPLE_B; ++bb) reset(h[bb]);
    float max_err = 0.0f;
    float action[ACTION_DIM];
    for (std::size_t tt = 0; tt < EXAMPLE_T; ++tt) {
        for (std::size_t bb = 0; bb < EXAMPLE_B; ++bb) {
            evaluate_step(EXAMPLE_INPUT[tt][bb], h[bb], action);
            for (std::size_t a = 0; a < ACTION_DIM; ++a) {
                const float err = std::fabs(action[a] - EXAMPLE_OUTPUT[tt][bb][a]);
                if (err > max_err) max_err = err;
            }
        }
    }
    return max_err;
}
"""
        )
    w(f"\n}} // namespace {namespace}\n")
    return out.getvalue()


def export_header_file(
    path: str,
    params: Dict[str, Any],
    example_input: Optional[np.ndarray] = None,
    example_output: Optional[np.ndarray] = None,
    **kw,
) -> None:
    with open(path, "w") as f:
        f.write(export_header(params, example_input, example_output, **kw))
