"""incubate/fleet/base/role_maker.py parity (role_maker.py:30).

Role makers resolve WORKER vs SERVER: ``TRAINING_ROLE=PSERVER`` plus
``PADDLE_PSERVER_ENDPOINTS`` (or ``PADDLE_PSERVERS_IP_PORT_LIST``) makes
``fleet.is_server()`` true and ``server_num()``/``server_index()`` real —
the PS embedding tier (paddle_tpu_torch.ps) keys off them.
"""
from ....parallel.fleet import (  # noqa: F401
    PaddleCloudRoleMaker, Role, RoleMakerBase, UserDefinedRoleMaker,
    _pserver_endpoints_env)
