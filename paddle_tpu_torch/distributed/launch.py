"""Multi-process launcher (the JAX package's `distributed/launch.py`;
reference: python/paddle/distributed/launch.py and fleet/launch.py with
the watchdog of distributed/utils.py: if any local process dies, the
rest are killed and the launcher exits with its code).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \
        train.py [args]

Collective mode gives each rank the reference's environment
(PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS,
PADDLE_CURRENT_ENDPOINT, TRAINING_ROLE) plus what `init_parallel_env`
and torch.distributed read: PADDLE_MASTER, MASTER_ADDR / MASTER_PORT,
RANK, WORLD_SIZE, LOCAL_RANK and PADDLE_LOCAL_RANK. The parameter-server
mode (`launch_ps`, `--server_num N --worker_num M`) starts N pservers of
the port's parameter server (`distributed/ps`) and M trainers:

    python -m paddle_tpu_torch.distributed.launch --server_num 1 \
        --worker_num 2 train_ps.py [args]
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

__all__ = ["launch_collective", "launch_ps", "main"]

#: seconds a pserver may take to listen before launch_ps gives up
_SERVER_START_S = 120.0


def _free_ports(n, host="127.0.0.1"):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind((host, 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def terminate_procs(procs):
    """terminate_local_procs (distributed/utils.py:252) parity."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + 5
    for p in procs:
        while p.poll() is None and time.time() < deadline:
            time.sleep(0.05)
        if p.poll() is None:
            p.kill()


def watch_procs(procs, tags):
    """watch_local_trainers parity: block until all exit; if any dies
    nonzero, kill the rest and return its code."""
    try:
        while True:
            alive = False
            for p, tag in zip(procs, tags):
                rc = p.poll()
                if rc is None:
                    alive = True
                elif rc != 0:
                    sys.stderr.write(
                        f"[launch] {tag} exited with code {rc}; "
                        "terminating remaining processes\n")
                    terminate_procs(procs)
                    return rc
            if not alive:
                return 0
            time.sleep(0.2)
    except KeyboardInterrupt:
        terminate_procs(procs)
        return 1


def launch_collective(script_args, nproc=2, host="127.0.0.1",
                      started_port=None, log_dir=None, extra_env=None):
    """Spawn nproc ranks of `python script args...` with the collective
    env contract. Returns the watchdog's exit code."""
    ports = _free_ports(nproc) if started_port is None else \
        list(range(started_port, started_port + nproc))
    endpoints = ",".join(f"{host}:{p}" for p in ports)
    procs, tags = [], []
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    for rank in range(nproc):
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nproc),
            "PADDLE_TRAINER_ENDPOINTS": endpoints,
            "PADDLE_CURRENT_ENDPOINT": f"{host}:{ports[rank]}",
            "TRAINING_ROLE": "TRAINER",
            # torch.distributed's rendezvous (init_parallel_env reads it)
            "PADDLE_MASTER": f"{host}:{ports[0]}",
            "MASTER_ADDR": host,
            "MASTER_PORT": str(ports[0]),
            "RANK": str(rank),
            "WORLD_SIZE": str(nproc),
            "LOCAL_RANK": str(rank),
            "PADDLE_LOCAL_RANK": str(rank),
        })
        env.update(extra_env or {})
        out = None
        if log_dir:
            out = open(os.path.join(log_dir, f"workerlog.{rank}"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, *script_args], env=env, stdout=out,
            stderr=subprocess.STDOUT if out else None))
        tags.append(f"trainer {rank}")
    return watch_procs(procs, tags)


def launch_ps(script_args, num_servers=1, num_trainers=1,
              host="127.0.0.1", server_optimizer="sgd", server_lr=0.01,
              log_dir=None, extra_env=None):
    """Spawn pserver processes (`python -m paddle_tpu_torch.distributed.ps`,
    the native PS server) and trainer processes (fleet/launch.py:227
    launch_ps parity). Each pserver gets TRAINING_ROLE=PSERVER,
    PADDLE_PORT, PADDLE_TRAINERS_NUM and POD_IP; each trainer
    TRAINING_ROLE=TRAINER, PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM and
    PADDLE_PSERVER_ENDPOINTS (what `fleet.init_worker` reads). The
    trainers start once every pserver listens (its ready file, within
    `_SERVER_START_S` seconds). The job ends when every trainer has
    exited (the pservers are then stopped); a trainer that fails, or a
    pserver that fails before the trainers are done, ends it with its
    code (a pserver a trainer shut down exits 0 and ends nothing)."""
    import tempfile

    ports = _free_ports(num_servers)
    endpoints = ",".join(f"{host}:{p}" for p in ports)
    procs, tags = [], []
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    ready_dir = tempfile.mkdtemp(prefix="launch_ps_")
    ready = [os.path.join(ready_dir, f"pserver{sid}") for sid in
             range(num_servers)]
    for sid, port in enumerate(ports):
        env = dict(os.environ)
        env.update({
            "TRAINING_ROLE": "PSERVER",
            "PADDLE_PORT": str(port),
            "PADDLE_TRAINERS_NUM": str(num_trainers),
            "POD_IP": host,
        })
        env.update(extra_env or {})
        out = None
        if log_dir:
            out = open(os.path.join(log_dir, f"serverlog.{sid}"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.ps",
             "--port", str(port), "--trainers", str(num_trainers),
             "--optimizer", server_optimizer, "--lr", str(server_lr),
             "--ready-file", ready[sid]],
            env=env, stdout=out,
            stderr=subprocess.STDOUT if out else None))
        tags.append(f"pserver {sid}")
    # the trainers connect at once: start them once every pserver listens
    # (a pserver writes its ready file after binding its port)
    deadline = time.time() + _SERVER_START_S
    while not all(os.path.exists(f) for f in ready):
        dead = [(i, p.poll()) for i, p in enumerate(procs)
                if p.poll() is not None]
        if dead or time.time() > deadline:
            sys.stderr.write(
                f"[launch] pserver {dead[0][0] if dead else '?'} "
                f"{'exited ' + str(dead[0][1]) if dead else 'did not listen'}"
                f" before the trainers started; terminating job\n")
            terminate_procs(procs)
            return (dead[0][1] or 1) if dead else 1
        time.sleep(0.05)
    import shutil

    shutil.rmtree(ready_dir, ignore_errors=True)
    trainer_procs = []
    for rank in range(num_trainers):
        env = dict(os.environ)
        env.update({
            "TRAINING_ROLE": "TRAINER",
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(num_trainers),
            "PADDLE_PSERVER_ENDPOINTS": endpoints,
        })
        env.update(extra_env or {})
        out = None
        if log_dir:
            out = open(os.path.join(log_dir, f"workerlog.{rank}"), "w")
        trainer_procs.append(subprocess.Popen(
            [sys.executable, *script_args], env=env, stdout=out,
            stderr=subprocess.STDOUT if out else None))
        tags.append(f"trainer {rank}")
    all_procs = procs + trainer_procs
    # trainers finishing cleanly ends the job; then stop servers
    rc = 0
    try:
        while True:
            t_alive = False
            for i, p in enumerate(trainer_procs):
                prc = p.poll()
                if prc is None:
                    t_alive = True
                elif prc != 0:
                    sys.stderr.write(
                        f"[launch] trainer {i} exited {prc}; "
                        "terminating job\n")
                    terminate_procs(all_procs)
                    return prc
            for i, p in enumerate(procs):
                prc = p.poll()
                # a pserver that exits 0 was shut down by a trainer's
                # request (`shutdown_server`): the trainers may still be
                # finishing, so only a failing pserver ends the job
                if prc not in (None, 0) and t_alive:
                    sys.stderr.write(
                        f"[launch] pserver {i} died ({prc}); "
                        "terminating job\n")
                    terminate_procs(all_procs)
                    return prc
            if not t_alive:
                break
            time.sleep(0.2)
    except KeyboardInterrupt:
        rc = 1
    terminate_procs(procs)
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="paddle_tpu multi-process launcher (fleetrun parity)")
    ap.add_argument("--nproc_per_node", type=int, default=None)
    ap.add_argument("--server_num", type=int, default=0)
    ap.add_argument("--worker_num", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--started_port", type=int, default=None)
    ap.add_argument("--log_dir", default=None)
    ap.add_argument("--server_optimizer", default="sgd")
    ap.add_argument("--server_lr", type=float, default=0.01)
    ap.add_argument("script", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    script = [a for a in args.script if a != "--"]
    if not script:
        ap.error("no training script given")
    if args.server_num > 0:
        return launch_ps(script, num_servers=args.server_num,
                         num_trainers=args.worker_num or 1,
                         host=args.host, log_dir=args.log_dir,
                         server_optimizer=args.server_optimizer,
                         server_lr=args.server_lr)
    nproc = args.nproc_per_node or 1
    return launch_collective(script, nproc=nproc, host=args.host,
                             started_port=args.started_port,
                             log_dir=args.log_dir)


if __name__ == "__main__":
    sys.exit(main())
