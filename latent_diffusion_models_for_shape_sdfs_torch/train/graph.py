"""One training or optimisation step captured as a CUDA graph.

The reference runs its loops (stage-2 training, encoder training, latent
optimisation) as compiled `lax.scan`s that never return to the host. The
port's counterpart is a step that reads its inputs from static buffers at
a device-side counter, captured once and replayed: `capture_step` warms
the step up on a side stream (so backward has allocated its gradients and
an optimizer its state), puts back every tensor the warm-up changed, and
captures one call. The eager step is the graph's plain version, and a
failed capture raises: nothing falls back to the eager loop on a card.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Sequence

import torch

from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling

# warm-up calls before the capture: the first creates the gradients and
# the optimizers' state, the second runs with them in place, as replays do
_WARMUP = 2
# the warm-up stream of each device, shared by every capture: cuBLAS keeps
# a workspace for each stream it has run on, so a new stream per capture
# would hold one more workspace each time
_SIDE: dict = {}


@contextlib.contextmanager
def deterministic_cudnn() -> Iterator[None]:
    """cuDNN restricted to deterministic algorithms (the conv backward may
    otherwise accumulate with atomics), so that a replayed graph, the eager
    step and a resumed run give the same bits. Restores the flag."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def capture_step(step: Callable[[], None], tensors: Sequence[torch.Tensor],
                 optimizers: Sequence[torch.optim.Optimizer] = ()
                 ) -> torch.cuda.CUDAGraph:
    """Capture one call of `step` as a CUDA graph.

    `tensors`: every tensor the step changes in place (parameters, EMA,
    counters, sums, moments), all on one CUDA device; each is put back to
    its value before the warm-up. The `optimizers`' state is put back too;
    state that the warm-up created is zeroed, which is a fresh state
    (torch's Adam starts its moments and count at zero). Raises if the
    tensors are not on a CUDA device or the capture fails, and under
    `utils.profiling.debug_nans`, whose op-by-op checks a replay would
    skip (nothing falls back to the eager step)."""
    if profiling.nans_checked():
        raise RuntimeError("capture_step under debug_nans: a CUDA graph "
                           "replays its kernels without the NaN checks; "
                           "run the eager step to check it op by op")
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError("a CUDA graph needs a CUDA device")
    saved = [t.detach().clone() for t in tensors]
    opt_saved = [{id(v): v.clone() for s in opt.state.values()
                  for v in s.values() if torch.is_tensor(v)}
                 for opt in optimizers]
    if dev not in _SIDE:
        _SIDE[dev] = torch.cuda.Stream(dev)
    side = _SIDE[dev]
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(_WARMUP):
            step()
    torch.cuda.current_stream(dev).wait_stream(side)
    with torch.no_grad():
        for t, v in zip(tensors, saved):
            t.copy_(v)
        for opt, before in zip(optimizers, opt_saved):
            for s in opt.state.values():
                for v in s.values():
                    if not torch.is_tensor(v):
                        continue
                    if id(v) in before:
                        v.copy_(before[id(v)])
                    else:
                        v.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return graph
