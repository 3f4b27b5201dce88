"""A function of the port as one CUDA graph replay: the one mechanism that
captures and replays graphs in the port.

A function that goes through it makes all of its `torch.Generator` draws
first and then computes its outputs from those draws by a `body` of tensor
arithmetic. On a card that body costs many small launches, each made by the
host in turn; a `Graphed` runs it as one CUDA graph instead. Its users: a
fresh population's sampler (`env/randomization.py`), `L2F.reset`
(`env/quad.py`) and the distillation step (`distill/post_training.py`).

The contract of a call with a key:

- its draws, the `specs`, are made eagerly on the caller's generator, in
  order, into the graph's static buffers: `("rand" | "randn", shape)`
  float32, or `("randint", shape, high)` int64 in [0, high), whose `high` is
  the call's own and not part of the key; the generator's state after a call
  is the eager path's;
- its float32 `inputs` are copied into one static buffer, since every call
  brings new tensors;
- its body may read, in place, tensors that the key names by identity
  (`Identity`); these must change between calls only in place. A cached key
  holds them, so it keeps them alive;
- it returns the body's float32 outputs as views of one clone of the arena
  the graph writes them into, which each replay overwrites: no caller sees a
  later call overwrite its tensors.

The first call with a key runs eagerly, the second captures and replays,
later calls replay, so a one-off call never pays for a capture; a function
keeps its graphs of at most `ENTRIES` keys (the oldest goes first). The
eager path is `body(draw(generator, specs), inputs)`: the CPU, and a call made
while a stream is being captured (into a caller's own graph), take it. The
replay runs the eager path's aten kernels, in the same order, on the same
draws.

A capture launches nothing: what the body's kernel wrappers added to
`profiling.launches` while it was captured is taken back, and added again at
each replay. `calls` tallies the eager calls, captures and replays of each
function; `replay_share` reads it.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Sequence

import torch

from raptor_tpu_torch.utils import profiling

calls: Dict[str, Dict[str, int]] = {}  # function -> {"eager", "capture", "replay": count}
ENTRIES = 4  # keys a function keeps, captured or seen once

_DRAWS = {"rand": torch.rand, "randn": torch.randn, "randint": torch.randint}


def replay_share(name: str = None) -> float:
    """Replays over all calls counted in `calls`, of one function or of all;
    0.0 before any call."""
    rows = [calls[name]] if name is not None else list(calls.values())
    total = sum(sum(r.values()) for r in rows)
    return sum(r["replay"] for r in rows) / total if total else 0.0


def draw(generator: torch.Generator, specs: Sequence[tuple],
         out: Sequence[torch.Tensor] = None) -> List[torch.Tensor]:
    """The draws `specs` names (see the module's contract), in order on
    `generator`: fresh tensors on its device, or written into `out`."""
    drawn = []
    for i, (kind, shape, *high) in enumerate(specs):
        args = (0, *high, shape) if kind == "randint" else (shape,)
        if out is None:
            drawn.append(_DRAWS[kind](*args, generator=generator, device=generator.device))
        else:
            drawn.append(_DRAWS[kind](*args, generator=generator, out=out[i]))
    return drawn


class Identity:
    """Tensors in a key, equal to another `Identity` only where it holds the
    same objects, in order. A key that holds it keeps them alive."""

    __slots__ = ("tensors",)

    def __init__(self, *tensors: torch.Tensor):
        self.tensors = tensors

    def __hash__(self):
        return hash(tuple(map(id, self.tensors)))

    def __eq__(self, other):
        return (isinstance(other, Identity) and len(other.tensors) == len(self.tensors)
                and all(a is b for a, b in zip(self.tensors, other.tensors)))


def _split(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    """Contiguous views of `flat`, one a shape, in order."""
    if not shapes:
        return []
    parts = flat.split([s.numel() for s in shapes])
    return [part.view(s) for part, s in zip(parts, shapes)]


class _Graph:
    """One capture of `body` over static draw and input buffers. Built by the
    second call with its key, whose draws and inputs it takes."""

    def __init__(self, device, generator, specs, body, inputs):
        self.draws = [torch.empty(shape, device=device,
                                  dtype=torch.int64 if kind == "randint" else torch.float32)
                      for kind, shape, *_ in specs]
        self.shapes = [x.shape for x in inputs]
        self.inputs = torch.empty(sum(s.numel() for s in self.shapes), device=device)
        self.load(generator, specs, inputs)
        self.graph = torch.cuda.CUDAGraph()
        before = profiling.launches.copy()
        with torch.cuda.device(device), torch.cuda.graph(self.graph):
            outs = body(self.draws, _split(self.inputs, self.shapes))
            self.arena = torch.cat([o.reshape(-1) for o in outs])
        self.launches = profiling.launches - before
        profiling.launches.subtract(self.launches)
        self.out_shapes = [o.shape for o in outs]

    def load(self, generator, specs, inputs):
        """This call's draws and inputs into the static buffers."""
        draw(generator, specs, self.draws)
        if inputs:
            torch.cat([x.reshape(-1) for x in inputs], out=self.inputs)

    def replay(self) -> List[torch.Tensor]:
        self.graph.replay()
        profiling.launches.update(self.launches)
        return _split(self.arena.clone(), self.out_shapes)


class Graphed:
    """The graph path of one function, with its own cache of graphs; its
    calls count in the row of `calls` of its name."""

    def __init__(self, name: str):
        self.name = name
        self._graphs: "collections.OrderedDict[tuple, _Graph]" = collections.OrderedDict()
        calls.setdefault(name, {"eager": 0, "capture": 0, "replay": 0})

    def __call__(self, key, generator: torch.Generator, specs: Sequence[tuple],
                 body: Callable, inputs=()) -> List[torch.Tensor]:
        """The outputs of one call, as a list of float32 tensors:
        `body(draws, inputs)` over the draws `specs` names and copies of
        `inputs`. `key` holds everything else `body` bakes in: the sizes and
        configs by value, the tensors it reads by `Identity`."""
        device = generator.device
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if (device.type != "cuda" or torch.cuda.is_current_stream_capturing()
                or any(x.dtype != torch.float32 or x.device != device for x in inputs)):
            return self._eager(generator, specs, body, inputs)
        key = (device, key)
        if key not in self._graphs:  # first call: seen, not captured
            self._see(key)
            return self._eager(generator, specs, body, inputs)
        graph = self._graphs[key]
        self._graphs.move_to_end(key)
        if graph is None:
            graph = _Graph(device, generator, specs, body, list(inputs))
            self._graphs[key] = graph
            self._count("capture")
        else:
            graph.load(generator, specs, inputs)
            self._count("replay")
        return graph.replay()

    def _eager(self, generator, specs, body, inputs):
        self._count("eager")
        return body(draw(generator, specs), list(inputs))

    def _see(self, key):
        self._graphs[key] = None
        while len(self._graphs) > ENTRIES:
            self._graphs.popitem(last=False)

    def _count(self, kind: str):
        calls[self.name][kind] += 1

    def clear(self):
        """Forget every key and free every graph."""
        self._graphs.clear()
