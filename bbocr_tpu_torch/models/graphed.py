"""The decode loop that the port's generating models share: one cached step
a token over static buffers, replayed as a CUDA graph on a card.

A model's step state subclasses ``StepState``: it owns static buffers for
one shape (batch, cache slots, type, device), and its ``step`` reads and
writes only them, with no host sync, so that one ``capture`` records a
step and each ``graph.replay()`` is the next one. ``state_for`` keeps one
state a shape for each model, weakly by model, and ``run_steps`` runs a
call's steps under the state's lock, capturing at the first call.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, Optional

import torch

from bbocr_tpu_torch.utils.profiling import span

_LOCK = threading.Lock()


class StepState:
    """Static buffers of one shape, a ``step`` over them and its graph;
    ``lock`` guards the buffers through a call."""

    graph: Optional[torch.cuda.CUDAGraph]

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = None
        self.lock = threading.Lock()

    def step(self) -> None:
        raise NotImplementedError

    def capture(self) -> None:
        """Record one ``step`` as a CUDA graph, after one eager step on a
        side stream (the lazy set-up of cuBLAS, of the kernels' libraries
        and of constants stays out of the capture). The capture runs on that
        stream, which lies on the buffers' device whatever device is
        current: ``torch.cuda.graph``'s own stream lies on the device current
        at its first use, and a step launched on another device's stream
        would leave the graph empty. The buffers then hold that step: load
        them again before replaying. Errors are raised only by this thread's
        calls (``thread_local``): other threads may launch work while it
        captures, though PyTorch refuses them a draw from the card's random
        generator meanwhile."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            self.step()
        self.graph = graph


def state_for(states: "weakref.WeakKeyDictionary", model, key: tuple, make: Callable[[], StepState]) -> StepState:
    """The state of ``model`` for ``key`` in ``states`` (model -> {key:
    state}), made by ``make`` at its first use. Weak by model, so a dropped
    model frees its buffers and graphs, and no graph rides along when a
    model is copied or pickled."""
    with _LOCK:
        own: Dict[tuple, StepState] = states.setdefault(model, {})
        if key not in own:
            own[key] = make()
        return own[key]


def run_steps(state: StepState, steps: int, load: Callable[[], None], graphed: bool, name: str) -> None:
    """Under ``state.lock``: ``load()`` the call's inputs, capture the step
    at the first graphed call (and load again, as the capture ran a step),
    then ``steps`` steps, each one replay of the graph where there is one,
    else one eager ``step``; each in a span ``name`` with ``step`` and
    ``graph`` (the step replayed a graph). The caller reads the buffers
    before it releases ``state.lock``, so it holds the lock around this."""
    load()
    if graphed and state.graph is None:
        state.capture()
        load()
    replay = state.graph is not None
    for t in range(steps):
        with span(name, step=t, graph=replay):
            if replay:
                state.graph.replay()
            else:
                state.step()
