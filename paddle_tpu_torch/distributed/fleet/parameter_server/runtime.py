"""Parameter-server runtime glue (the JAX package's
`fleet/parameter_server/runtime.py`).

Reference parity: fleet/runtime/parameter_server_runtime.py: wires
fleet.init_server / run_server / init_worker / stop_worker onto the
port's parameter server (`distributed.ps`: the native TCP RPC server and
the Communicator).
Role/endpoints come from the same env contract the reference uses
(PADDLE_PSERVER_ENDPOINTS, PADDLE_PORT, PADDLE_TRAINERS_NUM,
TRAINING_ROLE, PADDLE_TRAINER_ID).
"""
from __future__ import annotations

import os
import time

_server = None
_communicator = None


def _env(name, default=""):
    return os.environ.get(name, default)


def init_server(fleet_obj, *args):
    global _server
    from ...ps import PsServer

    port = int(_env("PADDLE_PORT", "0") or 0)
    trainers = int(_env("PADDLE_TRAINERS_NUM", "1") or 1)
    strategy = getattr(fleet_obj, "_strategy", None)
    lr = 0.01
    opt = "sgd"
    if strategy is not None:
        cfg = getattr(strategy, "a_sync_configs", {}) or {}
        opt = cfg.get("server_optimizer", opt)
        lr = float(cfg.get("server_lr", lr))
    _server = PsServer(port=port, trainers=trainers, optimizer=opt, lr=lr)
    return _server


def run_server(fleet_obj):
    """The listen_and_serv loop: serve until a trainer sends the shutdown
    RPC (`PsClient.shutdown_server`), then stop the server."""
    if _server is None:
        init_server(fleet_obj)
    try:
        while not _server.shutdown_requested():
            time.sleep(0.2)
    finally:
        _server.stop()


def get_server():
    return _server


def init_worker(fleet_obj):
    global _communicator
    from ...ps import Communicator

    endpoints = [e for e in _env("PADDLE_PSERVER_ENDPOINTS").split(",")
                 if e]
    if not endpoints:
        return None
    trainer_id = int(_env("PADDLE_TRAINER_ID", "0") or 0)
    strategy = getattr(fleet_obj, "_strategy", None)
    mode = "sync"
    geo_k = 4
    # async-SGD staleness knobs (DistributedStrategy.a_sync_configs):
    # bounded send queue + a short recv interval keep lr*(1+tau)*L < 2
    # on a contended host (the 8/50ms defaults diverged at lr=0.1)
    send_queue_size = 2
    recv_interval = 0.005
    if strategy is not None and getattr(strategy, "a_sync", False):
        cfg = getattr(strategy, "a_sync_configs", {}) or {}
        k_steps = int(cfg.get("k_steps", 0) or 0)
        mode = "geo" if k_steps > 0 else "async"
        geo_k = k_steps or geo_k
        send_queue_size = int(cfg.get("send_queue_size",
                                      send_queue_size) or send_queue_size)
        recv_interval = float(cfg.get("recv_interval", recv_interval)
                              or recv_interval)
    _communicator = Communicator(endpoints, mode=mode,
                                 trainer_id=trainer_id, geo_k=geo_k,
                                 send_queue_size=send_queue_size,
                                 recv_interval=recv_interval)
    _communicator.start()
    return _communicator


def get_communicator():
    return _communicator


def stop_worker(fleet_obj):
    global _communicator
    if _communicator is not None:
        _communicator.close()
        _communicator = None
