"""rl-tools `checkpoint.h` interchange.

Copy of `raptor_tpu/checkpoint/rltools_export.py` (numpy only), so the port
never imports the JAX package. The reference ships policies as generated C++
headers in the `rl_tools::checkpoint` namespace, compiled directly into
upstream rl-tools firmware. `checkpoint/code_export.py` is a dependency-free
format of this repository; this module speaks the upstream one:

- `export_rltools_header` emits the format: per-layer namespaces holding
  little-endian float bytes in `unsigned char memory[]` arrays plus the
  rl_tools container/layer/template type aliases (dense 22->16 RELU, GRU 16,
  dense 16->4 IDENTITY, sequential chain), the `example::input/output`
  golden tensors, and the `meta` namespace.
- `import_rltools_header` parses any such header back into the parameter
  dict under the names `checkpoint.from_numpy` takes (`dense_0`, `gru_1`,
  `dense_2`) and the example I/O.

Byte layout: row-major float32, matching
`rl_tools::matrix::layouts::RowMajorAlignment<unsigned long, 1>` /
`tensor::RowMajorStride`. For the same inputs the text equals the JAX
package's byte for byte.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np

_NSW = "RL_TOOLS_NAMESPACE_WRAPPER ::rl_tools::"
_BANNER = (
    "// NOTE: This code export assumes that the endianness of the target "
    "platform is the same as the endianness of the source platform"
)


def _bytes_of(arr: np.ndarray) -> str:
    data = np.ascontiguousarray(arr, dtype="<f4").tobytes()
    return ", ".join(str(b) for b in data)


def _matrix_block(arr2d: np.ndarray, category: str) -> list:
    """A Plain-parameter matrix namespace body (weights or biases of a dense
    layer): memory bytes + Matrix container + parameter instance."""
    rows, cols = arr2d.shape
    return [
        "            namespace parameters_memory {",
        "                static_assert(sizeof(unsigned char) == 1);",
        "                alignas(float) const unsigned char memory[] = "
        f"{{{_bytes_of(arr2d)}}};",
        f"                using CONTAINER_SPEC = {_NSW}matrix::Specification"
        f"<float, unsigned long, {rows}, {cols}, true, "
        f"{_NSW}matrix::layouts::RowMajorAlignment<unsigned long, 1>>;",
        f"                using CONTAINER_TYPE = {_NSW}Matrix<CONTAINER_SPEC>;",
        "                const CONTAINER_TYPE container = {(float*)memory}; ",
        "            }",
        f"            using PARAMETER_SPEC = {_NSW}nn::parameters::Plain::spec"
        f"<parameters_memory::CONTAINER_TYPE, {_NSW}nn::parameters::groups::"
        f"Normal, {_NSW}nn::parameters::categories::{category}>;",
        f"            const {_NSW}nn::parameters::Plain::instance"
        "<PARAMETER_SPEC> parameters = {parameters_memory::container};",
    ]


def _tensor_block(arr: np.ndarray, category: str) -> list:
    """A Plain-parameter tensor namespace body (GRU weights/biases/h0)."""
    shape = ", ".join(str(d) for d in arr.shape)
    return [
        "            namespace parameters_memory {",
        "                static_assert(sizeof(unsigned char) == 1);",
        "                alignas(float) const unsigned char memory[] = "
        f"{{{_bytes_of(arr)}}};",
        f"                using SHAPE = {_NSW}tensor::Shape<unsigned long, "
        f"{shape}>;",
        f"                using SPEC = {_NSW}tensor::Specification<float, "
        f"unsigned long, SHAPE, true, {_NSW}tensor::RowMajorStride<SHAPE>, "
        "true>;",
        f"                using CONTAINER_TYPE = {_NSW}Tensor<SPEC>;",
        "                const CONTAINER_TYPE container = {(float*)memory}; ",
        "            }",
        f"            using PARAMETER_SPEC = {_NSW}nn::parameters::Plain::spec"
        f"<parameters_memory::CONTAINER_TYPE, {_NSW}nn::parameters::groups::"
        f"Normal, {_NSW}nn::parameters::categories::{category}>;",
        f"            const {_NSW}nn::parameters::Plain::instance"
        "<PARAMETER_SPEC> parameters = {parameters_memory::container};",
    ]


def _dense_layer_def(idx: int, out_dim: int, activation: str,
                     input_shape: Tuple[int, int, int]) -> list:
    shape = ", ".join(str(d) for d in input_shape)
    return [
        f"    namespace layer_{idx} {{",
        f"        using CONFIG = {_NSW}nn::layers::dense::Configuration"
        f"<float, unsigned long, {out_dim}, {_NSW}nn::activation_functions::"
        f"ActivationFunction::{activation}, {_NSW}nn::layers::dense::"
        f"DefaultInitializer<float, unsigned long>, {_NSW}nn::parameters::"
        "groups::Normal>; ",
        f"        using TEMPLATE = {_NSW}nn::layers::dense::BindConfiguration"
        "<CONFIG>;",
        f"        using INPUT_SHAPE = {_NSW}tensor::Shape<unsigned long, "
        f"{shape}>;",
        f"        using CAPABILITY = {_NSW}nn::capability::Forward<true>;",
        f"        using TYPE = {_NSW}nn::layers::dense::Layer<CONFIG, "
        "CAPABILITY, INPUT_SHAPE>;",
        "        const TYPE module = {weights::parameters, biases::parameters};",
        "        template <typename T_TYPE = TYPE>",
        "        const T_TYPE factory = {weights::parameters, "
        "biases::parameters};",
        "        template <typename T_TYPE = TYPE>",
        "        const T_TYPE factory_function(){return T_TYPE{"
        "weights::parameters, biases::parameters};}",
        "    }",
    ]


def _gru_layer_def(idx: int, hidden: int,
                   input_shape: Tuple[int, int, int]) -> list:
    shape = ", ".join(str(d) for d in input_shape)
    members = (
        "weights_input::parameters, biases_input::parameters, "
        "weights_hidden::parameters, biases_hidden::parameters, "
        "initial_hidden_state::parameters"
    )
    return [
        f"    namespace layer_{idx} {{",
        f"        using CONFIG = {_NSW}nn::layers::gru::Configuration<float, "
        f"unsigned long, {hidden}, {_NSW}nn::parameters::groups::Normal, "
        "false, true>; ",
        f"        using TEMPLATE = {_NSW}nn::layers::gru::BindConfiguration"
        "<CONFIG>;",
        f"        using INPUT_SHAPE = {_NSW}tensor::Shape<unsigned long, "
        f"{shape}>;",
        f"        using CAPABILITY = {_NSW}nn::capability::Forward<true>;",
        f"        using TYPE = {_NSW}nn::layers::gru::Layer<CONFIG, "
        "CAPABILITY, INPUT_SHAPE>;",
        f"        const TYPE module = {{{members}}};",
        "        template <typename T_TYPE = TYPE>",
        f"        const T_TYPE factory = {{{members}}};",
        "        template <typename T_TYPE = TYPE>",
        f"        const T_TYPE factory_function(){{return {{{members}}};}}",
        "    }",
    ]


def _example_block(ns: str, arr: np.ndarray) -> list:
    shape = ", ".join(str(d) for d in arr.shape)
    return [
        _BANNER,
        "#include <rl_tools/containers/tensor/tensor.h>",
        f"namespace rl_tools::checkpoint::example::{ns} {{",
        "    static_assert(sizeof(unsigned char) == 1);",
        "    alignas(float) const unsigned char memory[] = "
        f"{{{_bytes_of(arr)}}};",
        f"    using SHAPE = {_NSW}tensor::Shape<unsigned long, {shape}>;",
        f"    using SPEC = {_NSW}tensor::Specification<float, unsigned long, "
        f"SHAPE, true, {_NSW}tensor::RowMajorStride<SHAPE>, true>;",
        f"    using CONTAINER_TYPE = {_NSW}Tensor<SPEC>;",
        "    const CONTAINER_TYPE container = {(float*)memory}; ",
        "}",
        "",
    ]


def export_rltools_header(
    path: str,
    params: Dict[str, Any],
    example_input: np.ndarray,  # [T, B, obs]
    example_output: np.ndarray,  # [T, B, 4]
    name: str = "raptor-tpu",
    commit_hash: str = "",
) -> None:
    """Write `params` (dense/GRU/dense actor pytree) as an upstream
    rl-tools `checkpoint.h` (format of ckpt.h:34-220)."""
    p = {k: np.asarray(v, np.float32) for k, v in _flatten(params).items()}
    w0, b0 = p["dense_0/weights"], p["dense_0/biases"].reshape(1, -1)
    wi, wh = p["gru_1/weights_input"], p["gru_1/weights_hidden"]
    bi, bh = p["gru_1/biases_input"], p["gru_1/biases_hidden"]
    h0 = p["gru_1/initial_hidden_state"]
    w2, b2 = p["dense_2/weights"], p["dense_2/biases"].reshape(1, -1)
    hidden, obs_dim = w0.shape
    out_dim = w2.shape[0]
    ei = np.asarray(example_input, np.float32)
    eo = np.asarray(example_output, np.float32)
    T, B = ei.shape[0], ei.shape[1]

    lines = [
        _BANNER,
        "#include <rl_tools/containers/matrix/matrix.h>",
        "#include <rl_tools/containers/tensor/tensor.h>",
        "#include <rl_tools/nn/parameters/parameters.h>",
        "#include <rl_tools/nn/layers/dense/layer.h>",
        "#include <rl_tools/nn/layers/gru/layer.h>",
        "#include <rl_tools/nn_models/sequential/model.h>",
        "namespace rl_tools::checkpoint::actor {",
        "    namespace layer_0 {",
        "        namespace weights {",
        *_matrix_block(w0, "Weights"),
        "        }",
        "        namespace biases {",
        *_matrix_block(b0, "Biases"),
        "        }",
        "    }",
        *_dense_layer_def(0, hidden, "RELU", (T, B, obs_dim)),
        "    namespace layer_1 {",
        "        namespace weights_input {",
        *_tensor_block(wi, "Weights"),
        "        }",
        "        namespace weights_hidden {",
        *_tensor_block(wh, "Weights"),
        "        }",
        "        namespace biases_input {",
        *_tensor_block(bi, "Biases"),
        "        }",
        "        namespace biases_hidden {",
        *_tensor_block(bh, "Biases"),
        "        }",
        "        namespace initial_hidden_state {",
        *_tensor_block(h0, "Biases"),
        "        }",
        "    }",
        *_gru_layer_def(1, hidden, (T, B, hidden)),
        "    namespace layer_2 {",
        "        namespace weights {",
        *_matrix_block(w2, "Weights"),
        "        }",
        "        namespace biases {",
        *_matrix_block(b2, "Biases"),
        "        }",
        "    }",
        *_dense_layer_def(2, out_dim, "IDENTITY", (T, B, hidden)),
        "    namespace model_definition {",
        f"        using CAPABILITY = {_NSW}nn::capability::Forward<true>; ",
        "        template <typename T_CONTENT, typename T_NEXT_MODULE = "
        f"{_NSW}nn_models::sequential::OutputModule>",
        f"        using Module = typename {_NSW}nn_models::sequential::Module"
        "<T_CONTENT, T_NEXT_MODULE>;",
        "        using MODULE_CHAIN = Module<layer_0::TEMPLATE, "
        "Module<layer_1::TEMPLATE, Module<layer_2::TEMPLATE>>>;",
        f"        using MODEL = typename {_NSW}nn_models::sequential::Build"
        "<CAPABILITY, MODULE_CHAIN, layer_0::INPUT_SHAPE>;",
        "    }",
        "    using TYPE = model_definition::MODEL;",
        "    const TYPE module = {layer_0::factory<TYPE::CONTENT>, "
        "{layer_1::factory<TYPE::NEXT_MODULE::CONTENT>, "
        "{layer_2::factory<TYPE::NEXT_MODULE::NEXT_MODULE::CONTENT>, {}}}};",
        "    template <typename T_TYPE = TYPE>",
        "    const T_TYPE factory = {layer_0::factory<typename "
        "T_TYPE::CONTENT>, {layer_1::factory<typename "
        "T_TYPE::NEXT_MODULE::CONTENT>, {layer_2::factory<typename "
        "T_TYPE::NEXT_MODULE::NEXT_MODULE::CONTENT>, {}}}};",
        "    template <typename T_TYPE = TYPE>",
        "    const T_TYPE factory_function(){return T_TYPE{"
        "layer_0::factory_function<typename T_TYPE::CONTENT>(), "
        "{layer_1::factory_function<typename T_TYPE::NEXT_MODULE::CONTENT>(), "
        "{layer_2::factory_function<typename "
        "T_TYPE::NEXT_MODULE::NEXT_MODULE::CONTENT>(), {}}}};}",
        "}",
        "",
        *_example_block("input", ei),
        *_example_block("output", eo),
        "namespace rl_tools::checkpoint::meta{",
        f'   char name[] = "{name}";',
        f'   char commit_hash[] = "{commit_hash}";',
        "}",
        "",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def _flatten(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    for layer, sub in params.items():
        for k, v in sub.items():
            out[f"{layer}/{k}"] = v
    return out


# ---------------------------------------------------------------------------
# importer: parse any rl_tools::checkpoint header (incl. the shipped
# reference one) back into our pytree + example I/O
# ---------------------------------------------------------------------------

_MEM_RE = re.compile(
    r"namespace\s+(\w+)\s*\{[^{]*?namespace\s+parameters_memory\s*\{"
    r".*?memory\[\]\s*=\s*\{([^}]*)\}.*?"
    r"(?:Shape<unsigned long,\s*([\d,\s]+)>|Specification<float,\s*unsigned"
    r"\s*long,\s*(\d+),\s*(\d+))",
    re.S,
)


def _parse_arrays(text: str):
    """Yield (namespace_name, np.ndarray) for every parameters_memory block."""
    for m in _MEM_RE.finditer(text):
        name = m.group(1)
        data = np.frombuffer(
            bytes(int(b) for b in m.group(2).split(",")), dtype="<f4"
        )
        if m.group(3) is not None:
            shape = tuple(int(d) for d in m.group(3).split(","))
        else:
            shape = (int(m.group(4)), int(m.group(5)))
        yield name, data.reshape(shape)


_EXAMPLE_RE = re.compile(
    r"namespace\s+rl_tools::checkpoint::example::(\w+)\s*\{"
    r".*?memory\[\]\s*=\s*\{([^}]*)\}.*?Shape<unsigned long,\s*([\d,\s]+)>",
    re.S,
)


def import_rltools_header(path: str):
    """Parse a `rl_tools::checkpoint` header -> (params pytree,
    example_input, example_output).  Layer namespaces follow the generated
    layout: layer_0 dense (weights/biases), layer_1 GRU (weights_input,
    weights_hidden, biases_input, biases_hidden, initial_hidden_state),
    layer_2 dense."""
    with open(path) as f:
        text = f.read()
    actor_txt = text[text.index("rl_tools::checkpoint::actor"):]
    arrays = []
    # namespaces appear in declaration order; the regex keys them by the
    # enclosing parameter namespace name
    for name, arr in _parse_arrays(actor_txt):
        arrays.append((name, arr))
    by_order: Dict[str, list] = {}
    for name, arr in arrays:
        by_order.setdefault(name, []).append(arr)
    params = {
        "dense_0": {
            "weights": by_order["weights"][0],
            "biases": by_order["biases"][0].reshape(-1),
        },
        "gru_1": {
            "weights_input": by_order["weights_input"][0],
            "weights_hidden": by_order["weights_hidden"][0],
            "biases_input": by_order["biases_input"][0].reshape(-1),
            "biases_hidden": by_order["biases_hidden"][0].reshape(-1),
            "initial_hidden_state": by_order["initial_hidden_state"][0]
            .reshape(-1),
        },
        "dense_2": {
            "weights": by_order["weights"][1],
            "biases": by_order["biases"][1].reshape(-1),
        },
    }
    examples = {}
    for m in _EXAMPLE_RE.finditer(text):
        shape = tuple(int(d) for d in m.group(3).split(","))
        examples[m.group(1)] = np.frombuffer(
            bytes(int(b) for b in m.group(2).split(",")), dtype="<f4"
        ).reshape(shape)
    return params, examples.get("input"), examples.get("output")
