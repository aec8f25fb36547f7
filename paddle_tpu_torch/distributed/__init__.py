"""paddle.distributed on torch.distributed: the eager collectives, the
process bootstrap, `spawn`, `DataParallel`, the launcher and the stores
(the JAX package's `distributed/`).

The process model is multi-controller, one process a rank and one device
a rank: `cuda:{local rank}` on a card, the CPU only when the caller asks
for it (`init_parallel_env(device="cpu")`, as the tests do). The world
is one `torch.distributed` process group, NCCL for a CUDA device and
gloo for the CPU; `init_parallel_env` adopts a group the caller already
made (any backend), so ranks that share one card can run over gloo.
There is no fallback: a CUDA device whose NCCL group cannot come up
raises.

Gloo lacks some collectives on CUDA tensors. Under a gloo group those
(everything but all-reduce and broadcast) stage their CUDA tensors
through host memory, never under NCCL; `STAGED_CALLS` counts each staged
call by collective.

A one-process world (no group, or a group of one) makes every
collective the identity, as in the JAX package.
"""
from __future__ import annotations

import atexit
import collections
import os
import socket

import torch
import torch.distributed as dist

__all__ = ["ReduceOp", "init_parallel_env", "get_rank", "get_world_size",
           "all_reduce", "broadcast", "all_gather", "scatter", "reduce",
           "barrier", "wait", "spawn", "all_reduce_mean_tree", "device",
           "send_recv",
           "DataParallel", "collective", "launch", "rendezvous", "fleet",
           "ps", "STAGED_CALLS"]

#: host-staged collective calls under gloo, by collective
STAGED_CALLS = collections.Counter()
#: the collectives gloo runs on CUDA tensors itself
_GLOO_ON_CUDA = ("all_reduce", "broadcast")
_ENV = {"device": None}


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT}


def _free_port(host="127.0.0.1"):
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _local_rank(rank):
    for key in ("PADDLE_LOCAL_RANK", "LOCAL_RANK"):
        if key in os.environ:
            return int(os.environ[key])
    n = torch.cuda.device_count()
    return rank % n if n else 0


def init_parallel_env(device=None, init_method=None, timeout=None):
    """Bring up (or adopt) the world's process group and bind this rank's
    device; returns that device. The world comes from
    PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ID and the rendezvous address
    from `init_method` (any torch.distributed URL: `tcp://host:port`,
    `file:///path`), else PADDLE_MASTER, else MASTER_ADDR:MASTER_PORT; a
    world of one with none of them takes a free local port. device None:
    `cuda:{local rank}` (PADDLE_LOCAL_RANK / LOCAL_RANK, else the rank
    modulo the cards), and a box with no card raises. The backend is
    NCCL for a CUDA device and gloo for the CPU; an already initialised
    group is adopted as it is."""
    from ..core.device import resolve_device

    if dist.is_initialized():
        rank = dist.get_rank()
    else:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if device is None:
        if not torch.cuda.is_available():
            resolve_device(None)          # raises the entry points' error
        device = torch.device("cuda", _local_rank(rank))
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _ENV["device"] = device
    if dist.is_initialized():
        return device
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if init_method is None:
        master = os.environ.get("PADDLE_MASTER")
        if master is None and "MASTER_ADDR" in os.environ:
            master = (os.environ["MASTER_ADDR"] + ":"
                      + os.environ.get("MASTER_PORT", "8701"))
        if master is None:
            if world > 1:
                raise RuntimeError(
                    "init_parallel_env: a world of more than one rank needs "
                    "init_method, PADDLE_MASTER or MASTER_ADDR/MASTER_PORT")
            master = f"127.0.0.1:{_free_port()}"
        init_method = f"tcp://{master}"
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {} if timeout is None else {"timeout": timeout}
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kw)
    # the group this call made is torn down before the interpreter's own
    # teardown: a backend thread still running at exit can abort the
    # process after its work is done
    atexit.register(_destroy_at_exit)
    return device


def _destroy_at_exit():
    if dist.is_initialized():
        dist.destroy_process_group()


def device():
    """The device `init_parallel_env` bound (None before it ran)."""
    return _ENV["device"]


def get_rank(group=None):
    if not dist.is_initialized():
        return int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    return dist.get_rank(group)


def get_world_size(group=None):
    if not dist.is_initialized():
        return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    return dist.get_world_size(group)


def _alone(group):
    return not dist.is_initialized() or dist.get_world_size(group) == 1


def _staged(name, group, tensors):
    """True when `name` must stage these tensors through host memory: a
    gloo group, a CUDA tensor, and a collective gloo does not run on
    CUDA tensors. Counts the call."""
    if dist.get_backend(group) != "gloo" or name in _GLOO_ON_CUDA:
        return False
    if not any(t.is_cuda for t in tensors):
        return False
    STAGED_CALLS[name] += 1
    return True


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In place over `group` (None: the world); returns the tensor."""
    if _alone(group):
        return tensor
    dist.all_reduce(tensor, _TORCH_OP[op], group=group)
    return tensor


def broadcast(tensor, src, group=None, sync_op=True):
    """`src`'s tensor on every rank of `group`, in place (src is a global
    rank)."""
    if _alone(group):
        return tensor
    dist.broadcast(tensor, src, group=group)
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Appends every rank's tensor to `tensor_list`, in rank order."""
    if _alone(group):
        tensor_list.append(tensor.clone())
        return tensor_list
    n = dist.get_world_size(group)
    if _staged("all_gather", group, [tensor]):
        host = tensor.cpu()
        outs = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(outs, host, group=group)
        outs = [o.to(tensor.device) for o in outs]
    else:
        outs = [torch.empty_like(tensor) for _ in range(n)]
        dist.all_gather(outs, tensor.contiguous(), group=group)
    tensor_list.extend(outs)
    return tensor_list


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """`src`'s tensor_list[rank] lands in each rank's `tensor`."""
    if _alone(group):
        if tensor_list:
            tensor.copy_(tensor_list[get_rank(group)])
        return tensor
    me = dist.get_rank() == src
    if _staged("scatter", group, [tensor]):
        host = torch.empty_like(tensor, device="cpu")
        dist.scatter(host, [t.cpu() for t in tensor_list] if me else None,
                     src=src, group=group)
        tensor.copy_(host)
    else:
        dist.scatter(tensor, list(tensor_list) if me else None, src=src,
                     group=group)
    return tensor


def reduce(tensor, dst, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction lands in `dst`'s tensor (the JAX package reduces on
    every rank; so does the port, which makes every rank's tensor the
    result: the reference's dst tensor, and a copy elsewhere)."""
    return all_reduce(tensor, op, group, sync_op)


def barrier(group=None):
    if not _alone(group):
        dist.barrier(group=group)


def wait(tensor, group=None, use_calc_stream=True):
    """Block until the tensor's pending work is done."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


def all_to_all_single(output, tensor, group=None):
    """`tensor`'s equal chunks along dim 0 go to the group's ranks in
    order; `output` receives theirs (staged through host under gloo)."""
    if _alone(group):
        output.copy_(tensor)
        return output
    if _staged("all_to_all", group, [tensor]):
        host = torch.empty_like(tensor, device="cpu")
        dist.all_to_all_single(host, tensor.cpu().contiguous(), group=group)
        output.copy_(host)
    else:
        dist.all_to_all_single(output, tensor.contiguous(), group=group)
    return output


def reduce_scatter(output, tensor, group=None):
    """The sum over the group of `tensor`, whose equal chunks along dim 0
    land on the group's ranks in order."""
    if _alone(group):
        output.copy_(tensor)
        return output
    if dist.get_backend(group) == "gloo":
        # gloo has no reduce-scatter: an all-reduce, then this rank's chunk
        total = tensor.contiguous().clone()
        dist.all_reduce(total, group=group)
        n, r = dist.get_world_size(group), dist.get_rank(group)
        output.copy_(total.chunk(n)[r])
    else:
        dist.reduce_scatter_tensor(output, tensor.contiguous(), group=group)
    return output


def shift(tensor, group, offset=1):
    """Ring shift over `group`: each rank sends `tensor` to the rank
    `offset` places on (in group order) and returns what the rank
    `offset` places back sent (a new tensor). The JAX `ppermute` with
    perm j -> j + offset."""
    n = 1 if _alone(group) else dist.get_world_size(group)
    if n == 1 or offset % n == 0:
        return tensor.clone()
    r = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(
        dist.group.WORLD if group is None else group)
    out = torch.empty_like(tensor)
    send_recv([(tensor, ranks[(r + offset) % n])],
              [(out, ranks[(r - offset) % n])], group)
    return out


def send_recv(sends=(), recvs=(), group=None):
    """Point to point in one batch: every (tensor, dst) of `sends` goes to
    global rank dst and every (tensor, src) of `recvs` is filled in place
    from global rank src (both sides post their messages to each other in
    the same order). Under a gloo group CUDA tensors go through host
    memory (`STAGED_CALLS["send_recv"]`); NCCL sends them as they are."""
    tensors = [t for t, _ in sends] + [t for t, _ in recvs]
    if not tensors:
        return
    staged = _staged("send_recv", group, tensors)
    ops, back = [], []
    for t, dst in sends:
        t = t.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if staged else t, dst,
                              group))
    for t, src in recvs:
        buf = torch.empty_like(t, device="cpu") if staged else t
        ops.append(dist.P2POp(dist.irecv, buf, src, group))
        back.append((t, buf))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if staged:
        for t, buf in back:
            t.copy_(buf)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Start `nprocs` processes (spawn start method), each running
    `func(*args)` with PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM set and a
    shared PADDLE_MASTER (a free local port unless the environment has
    one), so that `init_parallel_env()` in `func` joins them. Returns the
    processes (joined when `join`)."""
    import multiprocessing as mp

    if nprocs == -1:
        nprocs = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    master = os.environ.get("PADDLE_MASTER", f"127.0.0.1:{_free_port()}")
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = {"PADDLE_TRAINER_ID": str(rank),
               "PADDLE_TRAINERS_NUM": str(nprocs),
               "PADDLE_MASTER": master}
        p = ctx.Process(target=_spawn_entry, args=(func, args, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
    return procs


def _spawn_entry(func, args, env):
    os.environ.update(env)
    func(*args)


def all_reduce_mean_tree(named_arrays, group=None):
    """{name: tensor} averaged over the data-parallel replicas (LocalSGD's
    periodic sync); a one-process world returns the input."""
    world = get_world_size(group)
    if _alone(group):
        return named_arrays
    out = {}
    for n, v in named_arrays.items():
        t = v.clone()
        dist.all_reduce(t, group=group)
        out[n] = t / world
    return out


from . import collective, launch, rendezvous  # noqa: E402,F401
from . import fleet, ps  # noqa: E402,F401
from .parallel import DataParallel  # noqa: E402,F401
