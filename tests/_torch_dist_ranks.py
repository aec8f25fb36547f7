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
        return self.collect(self.submit(world, fn, *args))

    def submit(self, world, fn, *args):
        """Start a task on ranks 0 .. world - 1 and return at once (the
        caller works meanwhile, e.g. runs the JAX side); `collect` waits
        for its results."""
        if world > self.n:
            raise ValueError(f"a world of {world} in a pool of {self.n}")
        self.tasks += 1
        store = os.path.join(self.dir, f"store_{self.tasks}")
        for r in range(world):
            self.conns[r].send((fn, world, store, args))
        return world, fn

    def collect(self, task):
        world, fn = task
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


def pretrain_loss(outs, labels):
    """The masked-LM (ignore -1) plus next-sentence loss of
    `test_torch_pretraining.py`; labels [b, s + 1]."""
    mlm, nsp = outs
    tgt = labels[:, :-1]
    mlm_loss = torch.nn.functional.cross_entropy(
        mlm.float().reshape(-1, mlm.shape[-1]), tgt.reshape(-1),
        ignore_index=-1)
    return mlm_loss + torch.nn.functional.cross_entropy(nsp.float(),
                                                        labels[:, -1])


def pretrain_grads(rank, world, spec):
    """One `loss_and_grads` of a seeded tiny `ErnieForPretraining` on
    `spec["mesh"]` (Megatron's tp rules, the tied decoder included); rank
    0 returns the loss, every gradient gathered whole, and the word
    table's local shape."""
    from paddle_tpu_torch.optimizer import functional as fopt
    from paddle_tpu_torch.parallel import (COMMON_TP_RULES, SpmdTrainer,
                                           init_mesh)
    from paddle_tpu_torch.text import ErnieConfig, ErnieForPretraining

    mesh = init_mesh(**spec["mesh"])
    model = ErnieForPretraining(
        ErnieConfig.tiny(**spec["cfg"]), device="cpu",
        generator=torch.Generator().manual_seed(spec["seed"]))
    tr = SpmdTrainer(model, pretrain_loss, fopt.sgd(0.1), device="cpu",
                     mesh=mesh, rules=COMMON_TP_RULES,
                     generator=torch.Generator().manual_seed(0))
    inputs, labels = spec["batch"]
    loss, grads = tr.loss_and_grads(inputs, labels)
    full = {}
    for n, g in grads.items():
        sh = tr.param_shardings.get(n)
        full[n] = sh.gather(g) if sh is not None and sh.is_split else g
    table = "ernie.embeddings.word_embeddings.weight"
    if rank:
        return None
    return {"loss": float(loss), "grads": to_np(full),
            "table": tuple(tr.params[table].shape)}


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


# ------------------------------------------------------------ sharded serving
def serving_stack(spec):
    """The port's decoder, embedding and projection (`spec["dims"]`: D,
    heads, ffn, vocab, layers) holding `spec["state"]` (the JAX stack's
    numpy states)."""
    from paddle_tpu_torch import convert, nn

    D, H, FF, V, L = spec["dims"]
    dec = nn.TransformerDecoder(
        nn.TransformerDecoderLayer(D, H, FF, dropout=0.0, device="cpu"), L)
    emb = nn.Embedding(V, D, device="cpu")
    proj = nn.Linear(D, V, device="cpu")
    for mod, st in zip((dec, emb, proj), spec["state"]):
        mod.load_state_dict(convert.from_jax_state(st))
        mod.eval()
    return dec, emb, proj


def _serve_requests(eng, reqs, max_iterations=3000, waves=None):
    """Submit (prompt, memory, max_new, adapter) requests (in `waves` of
    the given sizes, one wave every third iteration, else all at once)
    and drain; returns the Request objects."""
    from paddle_tpu_torch.serving import Request, Scheduler

    sched = Scheduler(max_queue=256)
    out = [Request(p, m, max_new_tokens=n, eos_id=1, adapter=a)
           for p, m, n, a in reqs]
    pending = list(out)
    waves = list(waves or [len(out)])
    it = 0
    while pending or sched.depth() > 0 or eng.occupancy() > 0:
        if pending and it % 3 == 0:
            k = waves.pop(0) if waves else len(pending)
            for r in pending[:k]:
                sched.submit(r)
            pending = pending[k:]
        eng.run_iteration(sched)
        it += 1
        if it >= max_iterations:
            raise RuntimeError(f"no convergence after {it} iterations")
    return out


def _result(r):
    try:
        res = r.result(timeout=5)
    except Exception as e:       # a failed request's future raises
        return {"error": type(e).__name__}
    return {"tokens": [int(t) for t in res.tokens],
            "reason": res.finish_reason,
            "error": None if res.error is None else type(res.error).__name__}


def sharded_serve(rank, world, spec):
    """One sharded serve: `spec["mesh"]` (init_mesh kwargs), the engine's
    kwargs `spec["kw"]`, adapters `spec["tenants"]` (capacity, rank,
    {name: seed}), requests `spec["reqs"]` (optionally in `waves`),
    fault plans `spec["faults"]` ([(point, kwargs)] armed around the
    drain). Every rank returns its requests' results, the snapshot's
    counters, its trace_counts keys and (paged) the pool's leak check."""
    from paddle_tpu_torch.parallel import init_mesh
    from paddle_tpu_torch.serving import AdapterPool, ShardedServingEngine
    from paddle_tpu_torch.testing import faults

    mesh = init_mesh(**spec["mesh"])
    dec, emb, proj = serving_stack(spec)
    kw = dict(spec["kw"])
    pool = None
    if spec.get("tenants"):
        cap, r, names = spec["tenants"]
        pool = AdapterPool(dec, capacity=cap, rank=r)
        for name, seed in names.items():
            pool.register_random(name, seed=seed)
        kw["adapters"] = pool
    events = []
    if spec.get("record_callbacks"):
        from paddle_tpu_torch.serving import ServingCallback

        class Rec(ServingCallback):
            def on_join(self, request, slot):
                events.append(("join", slot))

            def on_token(self, request, token):
                events.append(("token", int(token)))

            def on_finish(self, request):
                events.append(("finish", request.finish_reason))

        kw["callbacks"] = [Rec()]
    eng = ShardedServingEngine(dec, emb, proj, mesh=mesh, **kw)
    eng.sync_tok0 = bool(spec.get("sync_tok0", False))
    plans = []
    try:
        for point, fkw in spec.get("faults", ()):
            plans.append(faults.inject(point, **fkw))
        reqs = _serve_requests(eng, spec["reqs"], waves=spec.get("waves"))
    finally:
        faults.reset()
    snap = eng.metrics.snapshot()
    out = {"results": [_result(r) for r in reqs],
           "requests": snap["requests"], "joins": snap["joins"],
           "tokens_out": snap["tokens_out"], "retries": snap["retries"],
           "sharding": snap.get("sharding"),
           "speculation": snap.get("speculation"),
           "tenancy": snap.get("tenancy"),
           "prefix": snap.get("prefix"),
           "trace_keys": sorted(map(repr, eng.trace_counts)),
           "trace_max": max(eng.trace_counts.values(), default=0),
           "pending": len(eng._pending) + len(eng._pending_info),
           "occupancy": eng.occupancy(),
           "decodes": eng._decodes,
           "weights_bytes": eng.weights_bytes(),
           "last_error": snap["last_error"], "events": events}
    if hasattr(eng, "_alloc"):
        eng.flush_prefix_cache()
        eng._alloc.check()
        out["pages_free"] = (eng._alloc.pages_free, eng.num_pages)
    if pool is not None:
        pool.check()
    return out



def sharded_guard(rank, world, spec):
    """The one-card engines' refusal of a decoder whose feed-forward
    `shard_layer` cut over tp, and the sharded engine's serve of it."""
    from paddle_tpu_torch.parallel import ShardingRules, init_mesh
    from paddle_tpu_torch.parallel.layers import shard_layer
    from paddle_tpu_torch.serving import ServingEngine, ShardedServingEngine

    mesh = init_mesh(**spec["mesh"])
    dec, emb, proj = serving_stack(spec)
    shard_layer(dec, mesh, ShardingRules([
        (r"linear1\.weight$", (None, "tp")),
        (r"linear2\.weight$", ("tp", None))]))
    out = {}
    for key, kw in (("one_card", {}),
                    ("one_card_paged", {"paged": True, "page_size": 8})):
        try:
            ServingEngine(dec, emb, proj, device="cpu", num_slots=4,
                          max_len=32, **kw)
        except ValueError as e:
            out[key] = str(e)
    eng = ShardedServingEngine(dec, emb, proj, mesh=mesh, **spec["kw"])
    out["results"] = [_result(r) for r in _serve_requests(eng, spec["reqs"])]
    return out


def sharded_validation(rank, world, spec):
    """The sharded engine's construction errors on `spec["mesh"]`."""
    from paddle_tpu_torch.parallel import init_mesh
    from paddle_tpu_torch.serving import ShardedServingEngine

    mesh = init_mesh(**spec["mesh"])
    dec, emb, proj = serving_stack(spec)
    out = {}

    def err(key, exc, **kw):
        try:
            ShardedServingEngine(dec, emb, proj, mesh=mesh, **kw)
        except exc as e:
            out[key] = str(e)

    if mesh.axis_size("dp") == 1:
        err("dp", ValueError, prefill="disaggregated")
        err("policy", ValueError, prefill="offline")
        err("chunk", NotImplementedError, prefill_chunk=4)
        err("paged_disaggregated", NotImplementedError, num_slots=2,
            paged=True, prefill="disaggregated")
    else:
        err("slots", ValueError, num_slots=6)
    return out


def sharded_precompile(rank, world, spec):
    """Two engines over the same weights precompiled through one AOT
    cache directory (`spec["cache"]`): the reports, the second's program
    cache after its warm start, then its serve."""
    from paddle_tpu_torch.parallel import init_mesh
    from paddle_tpu_torch.serving import ShardedServingEngine

    mesh = init_mesh(**spec["mesh"])
    D = spec["dims"][0]

    def engine():
        dec, emb, proj = serving_stack(spec)
        return ShardedServingEngine(dec, emb, proj, mesh=mesh, **spec["kw"])

    buckets = (1, 2, 4, 8)
    e1 = engine()
    cold = e1.precompile((4, D), prompt_buckets=buckets,
                         cache=spec["cache"])
    eng = engine()
    warm = eng.precompile((4, D), prompt_buckets=buckets,
                          cache=spec["cache"])
    after = sorted(map(repr, eng.trace_counts))
    reqs = _serve_requests(eng, spec["reqs"])
    return {"cold": cold, "warm": warm, "trace_after_warm": after,
            "results": [_result(r) for r in reqs],
            "trace_max": max(eng.trace_counts.values(), default=0),
            "fingerprint": eng._program_fingerprint()}


def sharded_chaos(rank, world, spec):
    """The chaos cells of the sharded serving tests on one engine, phase
    by phase: `spec["phases"]` holds (requests, fault plans, iterations:
    None drains, n runs n iterations under the plans and then drains
    without them). Returns each phase's results and the engine's state
    after all of them."""
    from paddle_tpu_torch.parallel import init_mesh
    from paddle_tpu_torch.serving import Request, Scheduler
    from paddle_tpu_torch.serving import ShardedServingEngine
    from paddle_tpu_torch.testing import faults

    mesh = init_mesh(**spec["mesh"])
    dec, emb, proj = serving_stack(spec)
    eng = ShardedServingEngine(dec, emb, proj, mesh=mesh, **spec["kw"])
    sched = Scheduler(max_queue=256)
    phases = []
    for reqs, plans, iters in spec["phases"]:
        rs = [Request(p, m, max_new_tokens=n, eos_id=1, adapter=a)
              for p, m, n, a in reqs]
        try:
            for point, fkw in plans:
                faults.inject(point, **fkw)
            for r in rs:
                sched.submit(r)
            if iters is None:
                eng.serve_until_idle(sched, 3000)
            else:
                for _ in range(iters):
                    eng.run_iteration(sched)
        finally:
            faults.reset()
        eng.serve_until_idle(sched, 3000)
        phases.append([_result(r) for r in rs])
    snap = eng.metrics.snapshot()
    out = {"phases": phases, "retries": snap["retries"],
           "failed": snap["requests"]["failed"],
           "trace_max": max(eng.trace_counts.values(), default=0),
           "pending": len(eng._pending) + len(eng._pending_info),
           "occupancy": eng.occupancy()}
    if hasattr(eng, "_alloc"):
        eng.flush_prefix_cache()
        eng._alloc.check()
        out["pages_free"] = (eng._alloc.pages_free, eng.num_pages)
    return out


# ------------------------------------------------------------ fleet
def fleet_metrics(rank, world):
    """The JAX test's fleet metrics from each trainer's local statistics,
    reduced by all-reduces over the gloo world."""
    from paddle_tpu_torch.distributed.fleet import metrics

    local = np.array([1.0 + rank, 10.0 * (rank + 1)])
    pos, neg = np.zeros(4), np.zeros(4)
    if rank == 0:
        pos[3], neg[0] = 5, 5
    else:
        pos[2], neg[1] = 3, 4
    return {"sum": metrics.sum(local).tolist(),
            "max": metrics.max(torch.tensor(local)).tolist(),
            "min": metrics.min(local).tolist(),
            "auc": metrics.auc(pos, neg),
            "acc": metrics.acc(np.array([8.0 + rank]), np.array([10.0])),
            "mae": metrics.mae(np.array([1.0 + rank]), np.array([2.0])),
            "mse": metrics.mse(np.array([4.0 * (rank + 1)]),
                               np.array([2.0])),
            "rmse": metrics.rmse(np.array([4.0 * (rank + 1)]),
                                 np.array([2.0]))}


def local_sgd(rank, world, k):
    """LocalSGDSync over the world: each rank's parameters drift by its
    own rate; every k-th call they are averaged."""
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        LocalSGDSync

    sync = LocalSGDSync(k)
    p = {"w": torch.zeros(3)}
    seen = []
    for _ in range(2 * k):
        p = {"w": p["w"] + (rank + 1)}
        p = sync.maybe_sync(p)
        seen.append(p["w"].tolist())
    return seen


# ------------------------------------------------------------ checkpoints
def sharded_save(rank, world, spec):
    """This rank's blocks of `spec["state"]` (numpy, whole) under
    `spec["specs"]` on `spec["mesh"]`, saved with `save_sharded`; the
    global arrays loaded back and cut again equal the blocks."""
    from paddle_tpu_torch.io.checkpoint import load_sharded, save_sharded
    from paddle_tpu_torch.parallel import init_mesh, named_sharding

    mesh = init_mesh(**spec["mesh"])
    shardings, blocks = {}, {}
    for name, full in spec["state"].items():
        sh = named_sharding(spec["specs"].get(name, ()), mesh)
        blocks[name] = sh.shard(torch.from_numpy(full))
        shardings[f"params/{name}"] = sh
    save_sharded({"params": blocks, "step": torch.tensor(7)},
                 spec["dir"], shardings=shardings)
    back = load_sharded(spec["dir"])["params"]
    same = all(torch.equal(named_sharding(spec["specs"].get(n, ()), mesh)
                           .shard(torch.from_numpy(back[n])), b)
               for n, b in blocks.items())
    return {"cut_back_equal": same,
            "local": {n: tuple(b.shape) for n, b in blocks.items()}}


def serving_blocks(rank, world, spec):
    """For each weight layout: the blocks a sharded engine's rank holds
    equal `convert.from_jax_state(..., serving_param_rules(layout), mesh,
    fitted=True)` of the step net's numpy state."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.parallel import init_mesh, serving_param_rules
    from paddle_tpu_torch.serving import ShardedServingEngine

    mesh = init_mesh(**spec["mesh"])
    dec, emb, proj = serving_stack(spec)
    full = {**{f"decoder.{k}": v for k, v in spec["state"][0].items()},
            **{f"embed.{k}": v for k, v in spec["state"][1].items()},
            **{f"project.{k}": v for k, v in spec["state"][2].items()}}
    out = {}
    for layout in ("gathered", "megatron"):
        eng = ShardedServingEngine(dec, emb, proj, mesh=mesh, layout=layout,
                                   num_slots=2, max_len=16)
        cut = convert.from_jax_state(full, serving_param_rules(layout),
                                     mesh, fitted=True)
        held = eng._net.state_dict()
        out[layout] = {
            "equal": set(held) == set(cut) and all(
                torch.equal(held[n], cut[n]) for n in cut),
            "split": sorted(n for n in cut if cut[n].shape !=
                            tuple(full[n].shape))}
    return out
