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
mode (`launch_ps`, `--server_num`) comes with the port's parameter
server and raises until then.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

__all__ = ["launch_collective", "launch_ps", "main"]


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
    """The parameter-server mode: not ported yet."""
    raise NotImplementedError(
        "launch_ps: the parameter server (distributed/ps) is not ported "
        "yet; it comes with the second multi-GPU slice (ROADMAP.md item "
        "5b)")


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
