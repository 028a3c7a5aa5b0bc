"""Dygraph data parallelism (the port's counterpart of
``paddle_tpu.dygraph.parallel``).

Reference analog: ``python/paddle/fluid/dygraph/parallel.py`` DataParallel:84
(scale_loss :150 + apply_collective_grads — a coalesced NCCL all-reduce via
imperative/nccl_context.cc).

One process a device, as the reference runs it: ``nranks`` and
``local_rank`` are the initialised ``torch.distributed`` group's
(``parallel/env.py``; ``init_parallel_env`` starts it from the PADDLE_*
variables ``distributed.launch`` sets: NCCL with one rank a card, gloo on
the CPU). ``apply_collective_grads`` sums the gradients over the group with
one all-reduce a dtype over a flat buffer (``collective.summed_coalesced``);
``scale_loss`` has already divided the loss by ``nranks``, so the update is
the global mean, the reference's recipe.
"""
from __future__ import annotations

from typing import Optional

from ..parallel import env as penv
from ..parallel.collective import summed_coalesced
from .layers import Layer
from .varbase import VarBase


class ParallelStrategy:
    def __init__(self):
        self.nranks = 1
        self.local_rank = 0
        self.trainer_endpoints = []
        self.current_endpoint = ""


def prepare_context(strategy: Optional[ParallelStrategy] = None
                    ) -> ParallelStrategy:
    """Reference dygraph/parallel.py prepare_context: the group's size and
    this process's rank (the group is started by
    ``parallel.env.init_parallel_env``)."""
    s = strategy or ParallelStrategy()
    s.nranks = penv.get_world_size()
    s.local_rank = penv.get_rank()
    return s


class Env:
    @property
    def nranks(self):
        return penv.get_world_size()

    @property
    def local_rank(self):
        return penv.get_rank()


class DataParallel(Layer):
    """Wraps a Layer; scale_loss + apply_collective_grads parity."""

    def __init__(self, layers: Layer,
                 strategy: Optional[ParallelStrategy] = None):
        super().__init__()
        self._layers = layers
        self._strategy = strategy or prepare_context()
        self.last_allreduce_bytes = 0

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def scale_loss(self, loss: VarBase) -> VarBase:
        n = self._strategy.nranks
        if n <= 1:
            return loss
        return loss * (1.0 / n)

    def apply_collective_grads(self):
        """The gradients summed over the group: one all-reduce SUM a dtype
        over a flat buffer (`last_allreduce_bytes` is its size)."""
        if self._strategy.nranks <= 1:
            return
        grads = [p for p in self._layers.parameters()
                 if p.grad_value is not None]
        if not grads:
            return
        summed = summed_coalesced([p.grad_value for p in grads])
        self.last_allreduce_bytes = sum(
            g.numel() * g.element_size() for g in summed)
        for p, g in zip(grads, summed):
            p.grad_value = g

    def parameters(self, include_sublayers: bool = True):
        return self._layers.parameters(include_sublayers)

    def state_dict(self):
        return self._layers.state_dict()

    def set_dict(self, d):
        self._layers.set_dict(d)

    load_dict = set_dict
