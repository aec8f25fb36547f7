"""Role makers (the JAX package's `fleet/role_maker.py`, the port's own
copy).

Reference parity: fluid/incubate/fleet/base/role_maker.py (:190 MPI legacy,
:1132 UserDefinedRoleMaker) + fleet/base/role_maker.py PaddleCloudRoleMaker
(env-driven TRAINING_ROLE / PADDLE_* variables).
"""
from __future__ import annotations

import os


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class RoleMakerBase:
    def _is_worker(self):
        raise NotImplementedError

    def _is_server(self):
        raise NotImplementedError

    def _worker_num(self):
        raise NotImplementedError

    def _server_num(self):
        raise NotImplementedError

    def _worker_index(self):
        raise NotImplementedError


class PaddleCloudRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=False, **kwargs):
        self._is_collective = is_collective
        self._role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        self._trainer_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._trainers_num = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self._server_eps = [e for e in os.environ.get(
            "PADDLE_PSERVER_ENDPOINTS", "").split(",") if e]
        self._worker_eps = [e for e in os.environ.get(
            "PADDLE_TRAINER_ENDPOINTS", "").split(",") if e]
        self._current_ep = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    def _is_worker(self):
        return self._role in ("TRAINER", "WORKER")

    def _is_server(self):
        return self._role == "PSERVER"

    def _is_first_worker(self):
        return self._is_worker() and self._trainer_id == 0

    def _worker_num(self):
        return self._trainers_num

    def _server_num(self):
        return len(self._server_eps)

    def _worker_index(self):
        return self._trainer_id

    def _server_index(self):
        if self._current_ep in self._server_eps:
            return self._server_eps.index(self._current_ep)
        return 0

    def _get_pserver_endpoints(self):
        return self._server_eps

    def _get_trainer_endpoints(self):
        return self._worker_eps


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None, **kwargs):
        self._cur_id = current_id
        self._role = role
        self._worker_num_ = worker_num
        self._server_eps = server_endpoints or []

    def _is_worker(self):
        return self._role == Role.WORKER

    def _is_server(self):
        return self._role == Role.SERVER

    def _worker_num(self):
        return self._worker_num_

    def _server_num(self):
        return len(self._server_eps)

    def _worker_index(self):
        return self._cur_id

    def _server_index(self):
        return self._cur_id

    def _get_pserver_endpoints(self):
        return self._server_eps
