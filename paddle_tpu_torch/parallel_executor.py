"""fluid.parallel_executor (the port's counterpart of
``paddle_tpu.parallel_executor``; reference parallel_executor.py
ParallelExecutor).

Compat wrapper: the C++ ParallelExecutor's role (clone the graph a device,
all-reduce the gradients, parallel_executor.cc:356) is played by
``CompiledProgram.with_data_parallel``, which in the port lays a dp mesh
over the ``torch.distributed`` group (one process a GPU). This class keeps
the constructor/run surface for scripts that used ParallelExecutor.
"""
from __future__ import annotations

from .core.compiler import (BuildStrategy, CompiledProgram,
                            ExecutionStrategy, ShardingStrategy)
from .core.executor import CPUPlace, CUDAPlace, Executor
from .core.program import default_main_program
from .observability.registry import get_registry
from .observability.tracer import trace_span

__all__ = ["ParallelExecutor", "BuildStrategy", "ExecutionStrategy",
           "ShardingStrategy"]


class ParallelExecutor:
    """``use_cuda`` picks the rank's card (``torch.cuda.current_device()``,
    set by ``init_parallel_env``) or the CPU; ``device_count`` is the
    world size."""

    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None, build_strategy=None,
                 num_trainers=1, trainer_id=0, scope=None):
        import torch

        self._program = main_program or default_main_program()
        build_strategy = build_strategy or BuildStrategy()
        self._compiled = CompiledProgram(self._program).with_data_parallel(
            loss_name=loss_name, build_strategy=build_strategy,
            exec_strategy=exec_strategy,
            share_vars_from=getattr(share_vars_from, "_compiled", None))
        place = (CUDAPlace(torch.cuda.current_device()) if use_cuda
                 else CPUPlace())
        self._exe = Executor(place)
        self._scope = scope
        # build_strategy.sharding_strategy (the ZeRO stage) is honoured by
        # the compiled program; surfaced here for introspection
        self.sharding_strategy = getattr(
            build_strategy, "sharding_strategy", ShardingStrategy.off)
        # set on EVERY construction, so a later ParallelExecutor over
        # another world does not leave the first one's count exported
        get_registry().gauge("executor/device_count").set(self.device_count)

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        with trace_span("parallel_executor/run"):
            return self._exe.run(self._compiled, feed=feed,
                                 fetch_list=list(fetch_list),
                                 scope=self._scope, return_numpy=return_numpy)

    @property
    def device_count(self):
        from .parallel.env import get_world_size

        return get_world_size()
