"""Fleet — the high-level distributed-training API (the port's counterpart
of ``paddle_tpu.parallel.fleet``).

Reference analog: ``python/paddle/fluid/incubate/fleet/base/fleet_base.py:37``
(Fleet abstract: init/is_worker/run_server/…), role_maker.py:30 (RoleMakerBase,
PaddleCloudRoleMaker env-based, UserDefinedRoleMaker), and the collective
implementation (incubate/fleet/collective/__init__.py:41 CollectiveOptimizer).

Collective mode: workers are the ranks of a ``torch.distributed`` group
(one process a GPU, started by ``distributed.launch``); the optimizer
wraps the program in a ``CompiledProgram`` over the strategy's mesh, so
``Executor.run(fleet.main_program, ...)`` runs each rank's step on its own
rows. Role makers can also produce SERVER roles — ``TRAINING_ROLE=PSERVER``
+ ``PADDLE_PSERVER_ENDPOINTS`` turn a process into an embedding shard
server (``fleet.init_server()`` / ``run_server()`` over
``ps.transport.ShardServer``). A server returns before any process group
or CUDA context exists: it must not take a card.
"""
from __future__ import annotations

import os
from typing import List, Optional

from ..core.compiler import CompiledProgram
from .mesh import DistributedStrategy

__all__ = ["Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "Fleet", "DistributedOptimizer", "fleet"]


class Role:
    WORKER = 1
    SERVER = 2


def _pserver_endpoints_env() -> List[str]:
    """The pserver endpoint list from either env spelling the reference
    launchers used (fleet launch_ps: PADDLE_PSERVERS_IP_PORT_LIST;
    transpiler docs: PADDLE_PSERVER_ENDPOINTS)."""
    raw = (os.environ.get("PADDLE_PSERVER_ENDPOINTS")
           or os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST") or "")
    return [e.strip() for e in raw.split(",") if e.strip()]


def _group_running() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


class RoleMakerBase:
    def __init__(self):
        self._role = Role.WORKER

    def generate_role(self):
        pass

    def is_worker(self) -> bool:
        return self._role == Role.WORKER

    def is_server(self) -> bool:
        return self._role == Role.SERVER

    def is_first_worker(self) -> bool:
        return self.is_worker() and self.worker_index() == 0

    def worker_num(self) -> int:
        return 1

    def worker_index(self) -> int:
        return 0

    def server_num(self) -> int:
        return len(self.server_endpoints())

    def server_index(self) -> int:
        return 0

    def server_endpoints(self) -> List[str]:
        return []


class PaddleCloudRoleMaker(RoleMakerBase):
    """Env-var role maker (role_maker.py PaddleCloudRoleMaker parity):
    TRAINING_ROLE selects TRAINER vs PSERVER; trainers read
    PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ENDPOINTS
    (``parallel.init_parallel_env`` starts the group from them), servers
    read PADDLE_PSERVER_ENDPOINTS (or the launcher's
    PADDLE_PSERVERS_IP_PORT_LIST) with the current server resolved from
    PADDLE_PSERVER_ID, or POD_IP:PADDLE_PORT matched against the list.

    `device` ("cuda" or "cpu") is passed to ``init_parallel_env``: an NCCL
    group on the card unless the caller asks for a gloo group on the
    CPU."""

    def __init__(self, is_collective: bool = True,
                 device: Optional[str] = None):
        super().__init__()
        self._is_collective = is_collective
        self._device = device
        self._server_eps: List[str] = []
        self._server_idx = 0

    def generate_role(self):
        role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        self._server_eps = _pserver_endpoints_env()
        if role == "PSERVER":
            self._role = Role.SERVER
            if not self._server_eps:
                raise ValueError(
                    "TRAINING_ROLE=PSERVER but no PADDLE_PSERVER_ENDPOINTS/"
                    "PADDLE_PSERVERS_IP_PORT_LIST in the environment")
            sid = os.environ.get("PADDLE_PSERVER_ID")
            if sid is not None:
                self._server_idx = int(sid)
            else:
                cur = (f"{os.environ.get('POD_IP', '127.0.0.1')}:"
                       f"{os.environ.get('PADDLE_PORT', '')}")
                if cur not in self._server_eps:
                    raise ValueError(
                        f"cannot locate this pserver: {cur!r} is not in "
                        f"the endpoint list {self._server_eps} (set "
                        f"PADDLE_PSERVER_ID, or POD_IP + PADDLE_PORT)")
                self._server_idx = self._server_eps.index(cur)
            if not (0 <= self._server_idx < len(self._server_eps)):
                raise ValueError(
                    f"PADDLE_PSERVER_ID={self._server_idx} out of range "
                    f"for {len(self._server_eps)} endpoints")
            return  # a server must not start a group or take a card
        self._role = Role.WORKER
        from .env import init_parallel_env

        init_parallel_env(device=self._device)

    def worker_num(self) -> int:
        if _group_running():
            import torch.distributed as dist

            return dist.get_world_size()
        return int(os.environ.get("PADDLE_TRAINERS_NUM", 1))

    def worker_index(self) -> int:
        if _group_running():
            import torch.distributed as dist

            return dist.get_rank()
        return int(os.environ.get("PADDLE_TRAINER_ID", 0))

    def server_index(self) -> int:
        return self._server_idx

    def server_endpoints(self) -> List[str]:
        return list(self._server_eps)


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id: int = 0, role=Role.WORKER,
                 worker_num: int = 1, server_endpoints=None):
        super().__init__()
        self._cur = current_id
        self._num = worker_num
        self._role = role
        self._server_eps = list(server_endpoints or [])

    def worker_num(self) -> int:
        return self._num

    def worker_index(self) -> int:
        return self._cur if self._role == Role.WORKER else 0

    def server_index(self) -> int:
        return self._cur if self._role == Role.SERVER else 0

    def server_endpoints(self) -> List[str]:
        return list(self._server_eps)


class Fleet:
    """fleet_base.py:37 surface, collective mode plus the PS servers."""

    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._strategy: Optional[DistributedStrategy] = None
        self.main_program = None
        self._ps_server = None
        self._barrier_mesh = None

    def init(self, role_maker: Optional[RoleMakerBase] = None,
             is_collective: bool = True):
        self._role_maker = role_maker or PaddleCloudRoleMaker()
        self._role_maker.generate_role()
        self._barrier_mesh = None  # of this init's group
        return self

    def is_worker(self) -> bool:
        return self._role_maker is None or self._role_maker.is_worker()

    def is_server(self) -> bool:
        return self._role_maker is not None and self._role_maker.is_server()

    def is_first_worker(self) -> bool:
        return self._role_maker is None or self._role_maker.is_first_worker()

    def worker_num(self) -> int:
        return self._role_maker.worker_num() if self._role_maker else 1

    def worker_index(self) -> int:
        return self._role_maker.worker_index() if self._role_maker else 0

    def worker_endpoints(self) -> List[str]:
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")

    def server_num(self) -> int:
        return self._role_maker.server_num() if self._role_maker else 0

    def server_index(self) -> int:
        return self._role_maker.server_index() if self._role_maker else 0

    def server_endpoints(self) -> List[str]:
        return (self._role_maker.server_endpoints() if self._role_maker
                else [])

    def init_worker(self):
        pass

    def init_server(self, shards=None, endpoint: Optional[str] = None):
        """Stand up this process's embedding shard server (reference
        ``fleet.init_server()``; ``run_server()`` then blocks serving).

        shards: the ``ps.EmbeddingShard`` slices this server hosts — e.g.
        ``ps.make_shards(...)[fleet.server_index()]`` per table. Without
        shards this stays the collective-mode no-op.
        endpoint: bind address; defaults to this server's entry in the
        role maker's endpoint list.
        """
        if shards is None:
            return None
        from ..ps.transport import ShardServer
        if endpoint is None:
            eps = self.server_endpoints()
            if not eps:
                raise RuntimeError(
                    "fleet.init_server: no endpoint given and the role "
                    "maker has no server endpoints (set "
                    "PADDLE_PSERVER_ENDPOINTS / TRAINING_ROLE=PSERVER)")
            endpoint = eps[self.server_index()]
        host, port = endpoint.rsplit(":", 1)
        self._ps_server = ShardServer(shards, host=host, port=int(port))
        return self._ps_server

    def run_server(self):
        """Serve embedding shards until shutdown (blocks)."""
        if self._ps_server is None:
            raise RuntimeError(
                "fleet.run_server: call init_server(shards=...) first "
                "(dense pserver mode is not provided; only the "
                "paddle_tpu_torch.ps embedding tier has servers)")
        self._ps_server.serve_forever()

    def stop_server(self):
        if self._ps_server is not None:
            self._ps_server.stop()
            self._ps_server = None

    def stop_worker(self):
        pass

    def barrier_worker(self):
        """A sync point of every worker (a one-element all-reduce over the
        group); a no-op for one worker. A failing collective raises."""
        if _group_running():
            import torch.distributed as dist

            if dist.get_world_size() > 1:
                from .collective import barrier
                from .mesh import make_mesh

                if self._barrier_mesh is None:  # one mesh (one group)
                    self._barrier_mesh = make_mesh(
                        {"dp": dist.get_world_size()})
                barrier(self._barrier_mesh)

    def distributed_optimizer(self, optimizer,
                              strategy: Optional[DistributedStrategy] = None):
        self._strategy = strategy or DistributedStrategy()
        return DistributedOptimizer(self, optimizer, self._strategy)

    def save_persistables(self, executor, dirname, main_program=None):
        from .. import io
        if self.is_first_worker():
            io.save_persistables(executor, dirname, main_program)

    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None):
        from .. import io
        if self.is_first_worker():
            io.save_inference_model(dirname, feeded_var_names, target_vars,
                                    executor, main_program)


class DistributedOptimizer:
    """CollectiveOptimizer parity (fleet/collective/__init__.py:139): wraps a
    regular optimizer; minimize() additionally builds the CompiledProgram
    over the strategy's mesh (``with_mesh(..., data_axis="dp")``, with the
    Megatron rules applied when ``tensor_parallel_degree > 1``). With no
    process group the program runs on the executor's one device, with
    the strategy's remat knobs."""

    def __init__(self, fleet: Fleet, optimizer, strategy: DistributedStrategy):
        self._fleet = fleet
        self._inner = optimizer
        self._strategy = strategy

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        ops, pg = self._inner.minimize(loss, startup_program, parameter_list,
                                       no_grad_set)
        program = loss.block.program
        if self._strategy.tensor_parallel_degree > 1:
            from .tensor_parallel import annotate_tp
            annotate_tp(program)
        cp = CompiledProgram(program)
        if _group_running():
            cp.with_mesh(self._strategy.build_mesh(), data_axis="dp",
                         strategy=self._strategy)
        else:
            cp._strategy_remat = bool(self._strategy.recompute)
            cp._strategy_remat_policy = self._strategy.remat_policy
        self._fleet.main_program = cp
        return ops, pg

    def __getattr__(self, name):
        return getattr(self._inner, name)


fleet = Fleet()
