"""Gloo ranks on the CPU for the port's multi-GPU tests
(`test_torch_mesh.py`, `test_torch_distributed.py`,
`test_torch_ring_pipeline.py`).

This module imports numpy, torch and the port only: the ranks start from
a forkserver (which preloads this module and the port, never JAX) and
import the module of the function they run, and the test modules import
JAX. A test file starts one `RankPool` (its processes
live for the module) and hands it tasks: `pool.run(world, "fn", *args)`
runs `fn(rank, world, *args)` on ranks 0 .. world - 1, each in a fresh
gloo world of that size that rendezvouses through a `file://` store in
the pool's temporary directory (no port, so parallel test workers never
collide), and returns the ranks' results. Every rank runs on one intra-op
thread, on the CPU.
"""
import os
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

#: seconds a task may take before the pool gives up on it
TASK_SECONDS = 120
#: the limit of float32 runs that reduce in another order (dp and tp
#: sums) against one device: relative L2 (the test modules' docstrings)
REL = 1e-5


class RankPool:
    def __init__(self, n):
        import multiprocessing as mp

        self.n = n
        self.dir = tempfile.mkdtemp(prefix="torch_ranks_")
        # a forkserver that has imported torch and the port once forks the
        # ranks (a spawned rank imports them itself, ~2-5 s each); fork it
        # never: the test process holds JAX's threads
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(["_torch_dist_ranks",
                                    "paddle_tpu_torch.parallel",
                                    "paddle_tpu_torch.distributed"])
        self.conns, self.procs = [], []
        for r in range(n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_serve, args=(r, child), daemon=True)
            p.start()
            child.close()
            self.conns.append(parent)
            self.procs.append(p)
        self.tasks = 0

    def run(self, world, fn, *args):
        if world > self.n:
            raise ValueError(f"a world of {world} in a pool of {self.n}")
        self.tasks += 1
        store = os.path.join(self.dir, f"store_{self.tasks}")
        for r in range(world):
            self.conns[r].send((fn, world, store, args))
        out, errs = [], []
        for r in range(world):
            if not self.conns[r].poll(TASK_SECONDS):
                self.close()
                raise TimeoutError(f"rank {r} of {fn} did not answer")
            kind, val = self.conns[r].recv()
            (errs if kind == "err" else out).append(val)
        if errs:
            raise RuntimeError(f"{fn} failed:\n" + "\n".join(errs))
        return out

    def close(self):
        for c in self.conns:
            try:
                c.send(None)
            except Exception:
                pass
        for p in self.procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
        self.procs = []


def _serve(rank, conn):
    import datetime

    torch.set_num_threads(1)
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.parallel import mesh as M

    while True:
        msg = conn.recv()
        if msg is None:
            return
        fn, world, store, args = msg
        try:
            dist.init_process_group(
                "gloo", init_method=f"file://{store}", world_size=world,
                rank=rank, timeout=datetime.timedelta(seconds=60))
            D.init_parallel_env(device="cpu")
            conn.send(("ok", globals()[fn](rank, world, *args)))
        except BaseException:
            conn.send(("err", f"rank {rank}: {traceback.format_exc()}"))
        finally:
            M._reset()
            if dist.is_initialized():
                dist.destroy_process_group()


# ------------------------------------------------------------ helpers
def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_np(v) for v in x)
    return x


def mlp():
    from paddle_tpu_torch import nn

    return torch.nn.Sequential(nn.Linear(8, 32, device="cpu"), nn.ReLU(),
                               nn.Linear(32, 4, device="cpu"))


def ernie(cfg):
    from paddle_tpu_torch.text import (ErnieConfig,
                                       ErnieForSequenceClassification)

    return ErnieForSequenceClassification(ErnieConfig.tiny(**cfg),
                                          device="cpu")


def ce(logits, labels):
    return torch.nn.functional.cross_entropy(logits.float(), labels)


def build(spec):
    from paddle_tpu_torch import convert

    net = mlp() if spec["model"] == "mlp" else ernie(spec["cfg"])
    net.load_state_dict(convert.from_jax_state(spec["state"]))
    return net


def optimizer(spec):
    from paddle_tpu_torch.optimizer import functional as fopt

    name, kw = spec.get("opt", ("sgd", {"learning_rate": 0.1}))
    tx = getattr(fopt, name)(**kw)
    if spec.get("clip"):
        tx = fopt.clip_by_global_norm(tx, spec["clip"])
    return tx


def trainer(spec, mesh):
    from paddle_tpu_torch.parallel import COMMON_TP_RULES, SpmdTrainer

    return SpmdTrainer(
        build(spec), ce, optimizer(spec), device="cpu", mesh=mesh,
        rules=COMMON_TP_RULES if spec.get("rules") else None,
        batch_axes=tuple(spec.get("batch_axes", ("dp",))),
        remat=spec.get("remat", False),
        grad_accum=spec.get("grad_accum", 1),
        generator=torch.Generator().manual_seed(0))


# ------------------------------------------------------------ rank tasks
def train(rank, world, spec):
    """`spec["steps"]` steps of the spec's model on `spec["mesh"]` over
    one global batch; rank 0 returns the losses, the full parameters
    after the steps (gathered from the blocks, and as `sync_to_layer`
    wrote them into the layer) and the local shapes of the split ones."""
    from paddle_tpu_torch.parallel import init_mesh

    mesh = init_mesh(**spec["mesh"]) if spec["mesh"] is not None else None
    tr = trainer(spec, mesh)
    convert_ok = None
    lean = spec.get("lean", False)        # losses and parameters only
    if spec.get("rules") and not lean:
        # the JAX state and slots cut into this rank's blocks
        from paddle_tpu_torch import convert
        from paddle_tpu_torch.parallel import COMMON_TP_RULES

        blocks = convert.from_jax_state(spec["state"], COMMON_TP_RULES, mesh)
        slots = convert.from_jax_optimizer_state(
            {f"{n}__moment1": v for n, v in spec["state"].items()}, None,
            COMMON_TP_RULES, mesh)
        convert_ok = all(torch.equal(blocks[n], p.detach()) and torch.equal(
            slots[f"{n}__moment1"], p.detach())
            for n, p in tr.params.items())
    inputs, labels = spec["batch"]
    losses = []
    if spec.get("epoch"):
        losses.append(float(tr.run_epoch(
            [(inputs, labels)] * spec["steps"])))
    else:
        for _ in range(spec["steps"]):
            losses.append(float(tr.step(inputs, labels)))
    evals = to_np(tr.eval_step(inputs)) if spec.get("eval") else None
    full = to_np(tr.full_params())
    synced = None
    if not lean:
        tr.sync_to_layer()
        synced = to_np(dict(tr._user_layer.named_parameters()))
    local = {n: tuple(p.shape) for n, p in tr.params.items()}
    slots = None
    if hasattr(tr.opt_state, "m"):
        slots = {n: tuple(v.shape) for n, v in tr.opt_state.m.items()}
    if rank:
        return None
    return {"losses": losses, "params": full, "synced": synced,
            "local": local, "slots": slots, "convert_ok": convert_ok,
            "eval": evals}


def many(rank, world, calls):
    """Several tasks in one world: [(name, args), ...] -> their results
    (one rendezvous for all of them)."""
    return [globals()[fn](rank, world, *args) for fn, args in calls]


def sync_bn(rank, world, x, w, b):
    """SyncBatchNorm over the ranks' rows of x: rank 0 returns the output
    and x's gradient (all rows), the running stats, and w's and b's
    gradients of the whole batch, against a seeded cotangent."""
    from paddle_tpu_torch import nn

    bn = nn.SyncBatchNorm(x.shape[1], device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    n = x.shape[0] // world
    xs = torch.from_numpy(x[rank * n:(rank + 1) * n]).requires_grad_(True)
    y = bn(xs)
    cot = torch.from_numpy(np.random.RandomState(1).randn(*x.shape)
                           .astype(np.float32))[rank * n:(rank + 1) * n]
    (y * cot).sum().backward()
    from paddle_tpu_torch.parallel.collectives import all_gather_cat

    g = dist.group.WORLD
    ranks = list(range(world))
    # the gradients of w and b of the whole batch: the ranks' summed
    dw, db = bn.weight.grad.clone(), bn.bias.grad.clone()
    dist.all_reduce(dw)
    dist.all_reduce(db)
    out = to_np({"y": all_gather_cat(y.detach(), g, 0, ranks),
                 "dx": all_gather_cat(xs.grad, g, 0, ranks),
                 "dw": dw, "db": db, "mean": bn._mean,
                 "var": bn._variance})
    return out if rank == 0 else None


def mesh_facts(rank, world):
    """init_mesh(dp=2, tp=2, pp=2)'s shape and this rank's dp and tp
    peers, auto_mesh(world)'s shape, and init_mesh(dp=3, tp=5)'s error."""
    from paddle_tpu_torch.parallel import auto_mesh, init_mesh

    m = init_mesh(dp=2, tp=2, pp=2)
    out = {"shape": m.shape, "tp_ranks": m.ranks_of("tp"),
           "dp_ranks": m.ranks_of("dp")}
    out["auto"] = auto_mesh(world, want_tp=True).shape
    try:
        init_mesh(dp=3, tp=5)
        out["bad"] = "no error"
    except ValueError as e:
        out["bad"] = f"ValueError: {e}"
    return out


def gather_seq(x, group, ranks):
    from paddle_tpu_torch.parallel.collectives import all_gather_cat

    return all_gather_cat(x.detach(), group, 2, ranks)


def ring_case(rank, world, q, k, v, causal, layout, pre_striped=False,
              axis="sp", mesh=None):
    """ring_attention over `axis` on this rank's shard of the global q, k,
    v (contiguous, or the zigzag stripe when pre_striped); rank 0 returns
    the global output and the gradients of sum(out) (natural order)."""
    from paddle_tpu_torch.parallel import init_mesh, ring_attention
    from paddle_tpu_torch.parallel.ring import zigzag_permutation

    m = init_mesh(**(mesh or {axis: world}))
    n, i = m.axis_size(axis), m.coord(axis)
    S = q.shape[2]
    s = S // n
    order = np.arange(S)
    if pre_striped:
        order = zigzag_permutation(S, n)[0]
    rows = order[i * s:(i + 1) * s]
    ts = [torch.from_numpy(a[:, :, rows]).requires_grad_(True)
          for a in (q, k, v)]
    out = ring_attention(*ts, axis_name=axis, is_causal=causal,
                         layout=layout, pre_striped=pre_striped)
    out.float().sum().backward()
    g, ranks = m.group_of(axis), m.ranks_of(axis)
    full = [gather_seq(t, g, ranks) for t in
            (out, ts[0].grad, ts[1].grad, ts[2].grad)]
    inv = np.argsort(order)
    full = [to_np(t)[:, :, inv] for t in full]
    return full if rank == 0 else None


def pipeline_ernie(rank, world, spec):
    """A 2-stage GPipe ERNIE (stage 0: embeddings + encoder layer 0;
    stage 1: layer 1 + pooler + classifier) over pp with the other ranks
    on dp: the per-microbatch losses, and each gradient's relative L2
    against the serial model's gradients of the same mean loss."""
    from torch.func import functional_call

    from paddle_tpu_torch.parallel import init_mesh, pipeline_spmd_fn

    m = init_mesh(**spec["mesh"])
    net = build(spec)
    net.eval()
    ids, lbl = (torch.from_numpy(a) for a in spec["micro"])
    emb, layers = net.ernie.embeddings, net.ernie.encoder.layers
    pooler, cls = net.ernie.pooler, net.classifier

    def first_fn(fp, mb):
        return functional_call(emb, fp, (mb[0],))

    def stage_apply(sp, x):
        return functional_call(layers[0], sp, (x,))

    def last_fn(lp, y, mb):
        pooled = torch.tanh(functional_call(pooler, lp[0], (y[:, 0],)))
        return ce(functional_call(cls, lp[1], (pooled,)), mb[1])

    s = m.coord("pp")
    stage = dict(layers[s].named_parameters())
    first = dict(emb.named_parameters())
    last = (dict(pooler.named_parameters()), dict(cls.named_parameters()))
    fn = pipeline_spmd_fn(stage_apply, mesh=m, first_fn=first_fn,
                          last_fn=last_fn)
    losses = fn((stage, first, last), (ids, lbl))
    losses.mean().backward()
    got = {n: p.grad.clone() for n, p in net.named_parameters()
           if p.grad is not None}
    net.zero_grad()
    serial = torch.stack([ce(net(ids[j]), lbl[j])
                          for j in range(ids.shape[0])])
    serial.mean().backward()
    errs = {}
    for n, p in net.named_parameters():
        if n in got:
            errs[n] = float((got[n] - p.grad).norm()
                            / p.grad.norm().clamp_min(1e-30))
    # stage s holds its layer's gradients; the ends are whole everywhere
    want = {f"ernie.encoder.layers.{s}."} | {"ernie.embeddings.",
                                              "ernie.pooler.", "classifier."}
    covered = all(any(n.startswith(w) for w in want) for n in got)
    return {"losses": to_np(losses), "serial": to_np(serial), "errs": errs,
            "covered": covered, "stage": s, "n_grads": len(got)}


def gpipe_case(rank, world, stages, mb):
    """A GPipe of `world` tanh(x @ w) stages over pp: rank 0 returns the
    outputs and the gradient of sum(out ** 2) for every stage's w."""
    from paddle_tpu_torch.parallel import (init_mesh, pipeline_spmd_fn,
                                           stack_stage_params)

    m = init_mesh(pp=world)
    stacked = stack_stage_params([{"w": torch.from_numpy(s["w"])}
                                  for s in stages])
    stacked["w"].requires_grad_(True)
    fn = pipeline_spmd_fn(lambda p, x: torch.tanh(x @ p["w"]), mesh=m)
    out = fn(stacked, torch.from_numpy(mb))
    (out ** 2).sum().backward()
    grad = stacked["w"].grad.clone()      # this stage's row only
    dist.all_reduce(grad)
    return to_np({"out": out, "grad": grad}) if rank == 0 else None


def eager_collectives(rank, world):
    """Every eager collective on rank-dependent tensors; rank 0 returns
    each one's result, the others theirs (gathered by the pool)."""
    from paddle_tpu_torch import distributed as D

    base = torch.arange(6, dtype=torch.float32).reshape(2, 3) + rank + 1
    out = {"rank": D.get_rank(), "world": D.get_world_size()}
    for name, op in (("sum", D.ReduceOp.SUM), ("max", D.ReduceOp.MAX),
                     ("min", D.ReduceOp.MIN), ("prod", D.ReduceOp.PROD)):
        out[name] = to_np(D.all_reduce(base.clone(), op))
    out["broadcast"] = to_np(D.broadcast(base.clone(), 1))
    out["all_gather"] = to_np(D.all_gather([], base))
    parts = [torch.full((3,), 10.0 * r) for r in range(world)]
    out["scatter"] = to_np(D.scatter(torch.zeros(3), parts if rank == 2
                                     else None, src=2))
    out["reduce"] = to_np(D.reduce(base.clone(), 0))
    D.barrier()
    D.wait(base)
    out["mean_tree"] = to_np(D.all_reduce_mean_tree({"a": base})["a"])
    out["shift"] = to_np(D.shift(base, None, 1))
    a2a = torch.arange(world * 2, dtype=torch.float32) + 100 * rank
    out["all_to_all"] = to_np(D.all_to_all_single(torch.empty_like(a2a),
                                                  a2a))
    out["reduce_scatter"] = to_np(D.reduce_scatter(
        torch.empty(2), torch.arange(world * 2, dtype=torch.float32)
        + rank))
    return out


def c_collectives(rank, world):
    """The c_* ops over the tp and dp axes of a dp=2 x tp=2 mesh, with the
    gradients of the differentiable ones."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.parallel import init_mesh

    init_mesh(dp=2, tp=2)
    x = (torch.arange(4, dtype=torch.float32) + 1 + rank).requires_grad_(
        True)
    out = {}
    for axis in ("tp", "dp"):
        s = C.c_allreduce_sum(x, axis)
        g = C.c_allgather(x, axis)
        (s.sum() + (g * torch.arange(g.numel())).sum()).backward()
        out[axis] = to_np({
            "sum": s, "max": C.c_allreduce_max(x, axis),
            "min": C.c_allreduce_min(x, axis),
            "prod": C.c_allreduce_prod(x, axis), "gather": g,
            "gather_stacked": C.c_allgather(x, axis, tiled=False),
            "scatter": C.c_reducescatter(x, axis),
            "bcast": C.c_broadcast(x, 1, axis),
            "perm": C.c_ppermute(x, [(0, 1), (1, 0)], axis),
            "grad": x.grad.clone()})
        x.grad = None
        C.barrier_op(axis)
    assert C.c_sync_calc_stream(x) is x and C.c_sync_comm_stream(x) is x
    return out


def data_parallel(rank, world, state, x, y):
    """A DataParallel step on this rank's half of the batch, with buckets
    small enough to need several; returns the gradients."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import DataParallel

    net = mlp()
    net.load_state_dict(convert.from_jax_state(state))
    dp = DataParallel(net, comm_buffer_size_mb=0.0005)
    n = x.shape[0] // world
    sl = slice(rank * n, (rank + 1) * n)
    loss = dp.scale_loss(ce(dp(torch.from_numpy(x[sl])),
                            torch.from_numpy(y[sl])))
    loss.backward()
    n_buckets = len(dp.buckets())
    dp.apply_collective_grads()
    return {"grads": {k: to_np(p.grad) for k, p in net.named_parameters()},
            "buckets": n_buckets}


def spawn_worker(out_dir):
    """spawn's target: join the world, sum the ranks' ids + 1, write it."""
    from paddle_tpu_torch import distributed as D

    torch.set_num_threads(1)
    D.init_parallel_env(device="cpu")
    t = D.all_reduce(torch.tensor([float(D.get_rank() + 1)]))
    with open(os.path.join(out_dir, f"rank{D.get_rank()}"), "w") as f:
        f.write(f"{D.get_world_size()} {float(t[0])}")
    dist.destroy_process_group()


def lamb_on_mesh(rank, world, spec):
    """Two Lamb steps of tiny ERNIE on the spec's mesh (tp: the trust
    ratios need the whole parameters' norms); rank 0 returns the full
    parameters."""
    from paddle_tpu_torch.parallel import init_mesh

    mesh = init_mesh(**spec["mesh"])
    tr = trainer(dict(spec, opt=("lamb", {"learning_rate": 1e-2})), mesh)
    for _ in range(2):
        tr.step(*spec["batch"])
    full = to_np(tr.full_params())
    return full if rank == 0 else None


def schedule_and_clip(rank, world, spec):
    """The JAX trainer's from_eager cases on a dp mesh: an eager SGD with
    StepDecay(0.5, step 2, gamma 0.1) (steps 0-1 at 0.5, 2-3 at 0.05),
    and SGD(10) clipped by the global norm at 1e-6; rank 0 returns the
    first two steps' mean update, the third's, and the clipped step's
    largest update."""
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.optimizer.lr import StepDecay
    from paddle_tpu_torch.parallel import SpmdTrainer, init_mesh

    mesh = init_mesh(**spec["mesh"])
    net = build(spec)
    opt = optimizer.SGD(StepDecay(learning_rate=0.5, step_size=2,
                                  gamma=0.1), parameters=net.parameters())
    tr = SpmdTrainer(net, ce, opt, device="cpu", mesh=mesh)
    first = next(iter(tr.params))
    w0 = tr.params[first].detach().clone()
    for _ in range(2):
        tr.step(*spec["batch"])
    w2 = tr.params[first].detach().clone()
    tr.step(*spec["batch"])
    w3 = tr.params[first].detach().clone()
    net = build(spec)
    opt = optimizer.SGD(10.0, parameters=net.parameters(),
                        grad_clip=nn.ClipGradByGlobalNorm(1e-6))
    tr = SpmdTrainer(net, ce, opt, device="cpu", mesh=mesh)
    before = {n: p.detach().clone() for n, p in tr.params.items()}
    x, y = spec["batch"]
    tr.step((x[0] * 100,), y)
    moved = max(float((tr.params[n] - before[n]).abs().max())
                for n in before)
    out = {"big": float((w2 - w0).abs().max()) / 2,
           "small": float((w3 - w2).abs().max()), "clipped": moved}
    return out if rank == 0 else None


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_params(port, jax_params, limit=REL):
    """The parameter vector within `limit` relative L2, and each
    parameter within `limit` of its norm, or of 1 for a parameter whose
    entries are all far below 1 (a key bias, whose gradient is zero up
    to rounding)."""
    names = sorted(jax_params)
    flat = [np.concatenate([np.ravel(np.asarray(d[n], np.float64))
                            for n in names]) for d in (port, jax_params)]
    assert rel_l2(*flat) <= limit
    for n in names:
        a = np.asarray(port[n], np.float64)
        b = np.asarray(jax_params[n], np.float64)
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1.0)
        assert err <= limit, (n, err)
