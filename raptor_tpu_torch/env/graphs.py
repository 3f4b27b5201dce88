"""The arithmetic after a function's random draws as one CUDA graph replay.

`randomization.sample_population` and `L2F.reset`, the two functions that
draw a fresh population and its initial states, each make all of their
`torch.Generator` draws first (the `(kind, shape)` specs of
`randomization.population_draws` and `quad.state_draws`) and then derive
every output from those draws, and from a few leaves of the airframes, by a
pure function of tensors. On a card that pure function costs about a
hundred small launches, each made by the host in turn, for well under a
millisecond of card work. A `Graphed` runs it as one CUDA graph instead:

- it keeps a few captured graphs, keyed by what the arithmetic bakes in (the
  sizes, the frozen configs, the device);
- the first call with a key runs eagerly, the second captures and replays,
  later calls replay, so a one-off call never pays for a capture;
- the draws stay eager, on the caller's generator, in their order and
  shapes, written straight into the graph's static buffers
  (`torch.rand(shape, generator=g, out=buffer)`), so that the generator's
  state after a call is the eager path's; the input leaves are copied into
  one static buffer, since every call brings new tensors;
- the graph writes every output into one flat arena, which each replay
  overwrites; a call returns views of one clone of it, so that no caller
  sees a later call overwrite its tensors.

The replay runs the eager path's aten kernels, in the same order, on the
same draws: its outputs equal the eager path's bit for bit. The CPU, and a
call made while a stream is being captured (into a caller's own graph), stay
eager. `calls` tallies the eager calls, captures and replays of each
function, in the manner of `ops.bptt.launches`; `replay_share` reads it.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Sequence, Tuple

import torch

calls: Dict[str, Dict[str, int]] = {}  # function -> {"eager", "capture", "replay": count}
ENTRIES = 4  # keys a function keeps, captured or seen once

_DRAWS = {"rand": torch.rand, "randn": torch.randn}


def replay_share(name: str = None) -> float:
    """Replays over all calls counted in `calls`, of one function or of all;
    0.0 before any call."""
    rows = [calls[name]] if name is not None else list(calls.values())
    total = sum(sum(r.values()) for r in rows)
    return sum(r["replay"] for r in rows) / total if total else 0.0


def draw(generator: torch.Generator, specs: Sequence[Tuple[str, tuple]],
         out: Sequence[torch.Tensor] = None) -> List[torch.Tensor]:
    """The draws `specs` names, `("rand" | "randn", shape)` each, in order on
    `generator`: fresh float32 tensors on its device, or written into `out`."""
    if out is None:
        return [_DRAWS[kind](shape, generator=generator, device=generator.device)
                for kind, shape in specs]
    for (kind, shape), buf in zip(specs, out):
        _DRAWS[kind](shape, generator=generator, out=buf)
    return list(out)


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
        self.draws = [torch.empty(shape, device=device) for _, shape in specs]
        self.shapes = [x.shape for x in inputs]
        self.inputs = torch.empty(sum(s.numel() for s in self.shapes), device=device)
        self.load(generator, specs, inputs)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(self.graph):
            outs = body(self.draws, _split(self.inputs, self.shapes))
            self.arena = torch.cat([o.reshape(-1) for o in outs])
        self.out_shapes = [o.shape for o in outs]

    def load(self, generator, specs, inputs):
        """This call's draws and inputs into the static buffers."""
        draw(generator, specs, self.draws)
        if inputs:
            torch.cat([x.reshape(-1) for x in inputs], out=self.inputs)

    def replay(self) -> List[torch.Tensor]:
        self.graph.replay()
        return _split(self.arena.clone(), self.out_shapes)


class Graphed:
    """The graph path of one function, with its own cache of graphs (at most
    `ENTRIES` keys; the oldest goes first) and its own row of `calls`."""

    def __init__(self, name: str):
        self.name = name
        self._graphs: "collections.OrderedDict[tuple, _Graph]" = collections.OrderedDict()
        calls[name] = {"eager": 0, "capture": 0, "replay": 0}

    def __call__(self, key, generator: torch.Generator,
                 eager: Callable[[], List[torch.Tensor]], specs: Sequence[Tuple[str, tuple]],
                 body: Callable, inputs=()) -> List[torch.Tensor]:
        """The outputs of one call, as a list of float32 tensors.

        `eager()` computes them with every draw on `generator`; `body(draws,
        inputs)` computes them from the draws `specs` names and from
        `inputs`, copies of which it receives, and reads no other tensor
        that changes between calls; the two run the same arithmetic. `key`
        holds everything else `body` bakes in (None: always eager)."""
        device = generator.device
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if (key is None or device.type != "cuda" or torch.cuda.is_current_stream_capturing()
                or any(x.dtype != torch.float32 or x.device != device for x in inputs)):
            self._count("eager")
            return eager()
        key = (device, key)
        if key not in self._graphs:  # first call: seen, not captured
            self._see(key)
            self._count("eager")
            return eager()
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

    def _see(self, key):
        self._graphs[key] = None
        while len(self._graphs) > ENTRIES:
            self._graphs.popitem(last=False)

    def _count(self, kind: str):
        calls[self.name][kind] += 1

    def clear(self):
        """Forget every key and free every graph."""
        self._graphs.clear()
