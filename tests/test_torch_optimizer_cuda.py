"""The port's optimizer layer and pretraining trainer on the card. Every
test here needs an NVIDIA card and skips without one; the file imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch for CUDA:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_optimizer_cuda.py

On the card the foreach ops run their CUDA multi-tensor kernels (on the
CPU they fall back to one op a tensor), so these tests hold: the
multi-tensor step equal to the per-parameter path bit for bit, for every
rule with and without the clip, and for bf16 parameters on float32
masters; the card's 4 steps against the CPU's. The float32 operations
are the same, one rounding each (the bias corrections divide as 0-d
tensors: CUDA would take a Python divisor as a product by its
reciprocal), but a few round apart by an ulp, and the norms (the
global-norm clip's, Lamb's trust ratio) are summed in another order.
Without the clip every parameter is held within 1e-6 of the CPU's (4
float32 ulps at the largest, ~4; `tools/probe_optimizer_gap.py` read
4.8e-7 at most, Lamb) and the difference within 2e-6 relative L2 of
the update (read 5.7e-7). With the clip the scale differs by an ulp
for every gradient, and where a moment is a difference of near-equal
terms (a gradient that changed sign) that ulp grows to ~1e-3 of the
moment and of the element's step; the limits are 1e-5 and 5e-6 (read
4.5e-6, Adam, and 2.2e-6, Momentum). `remat` bit for bit against no
remat with dropout on (the device generator replayed); `run_epoch`
(pinned copies on a side stream) bit for bit against a loop of
`step`.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.parallel import SpmdTrainer
from paddle_tpu_torch.text import ErnieConfig, ErnieForPretraining

SHAPES = [(64, 33), (33,), (300, 70), (2, 3, 2), (4096,)]
RULES = {
    "sgd": lambda ps, **kw: topt.SGD(0.05, parameters=ps, weight_decay=0.01,
                                     **kw),
    "momentum": lambda ps, **kw: topt.Momentum(0.05, 0.9, parameters=ps,
                                               use_nesterov=True, **kw),
    "adam": lambda ps, **kw: topt.Adam(0.01, parameters=ps,
                                       weight_decay=0.02, **kw),
    "adamw": lambda ps, **kw: topt.AdamW(
        topt.lr.StepDecay(0.01, 2), parameters=ps,
        apply_decay_param_fun=lambda n: not n.endswith("1"), **kw),
    "adamax": lambda ps, **kw: topt.Adamax(0.01, parameters=ps, **kw),
    "adagrad": lambda ps, **kw: topt.Adagrad(0.05, parameters=ps, **kw),
    "adadelta": lambda ps, **kw: topt.Adadelta(1.0, parameters=ps, **kw),
    "rmsprop": lambda ps, **kw: topt.RMSProp(0.01, momentum=0.9,
                                             centered=True, parameters=ps,
                                             **kw),
    "lamb": lambda ps, **kw: topt.Lamb(
        0.01, parameters=ps, exclude_from_weight_decay_fn=lambda n: n == "p0",
        **kw),
}


@pytest.fixture
def fused_steps(monkeypatch):
    """fused_steps(opt): how many of opt's steps took the multi-tensor
    path (`optimizer.fused.apply`)."""
    from paddle_tpu_torch.optimizer import fused

    seen = []
    inner = fused.apply

    def counted(opt, dense_pg):
        seen.append(opt)
        return inner(opt, dense_pg)
    monkeypatch.setattr(fused, "apply", counted)
    return lambda opt: sum(o is opt for o in seen)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the foreach ops' CUDA kernels "
                    "and the flash kernels run only there")
    return torch.device("cuda")


def _params(dev, dtype=torch.float32):
    rs = np.random.RandomState(0)
    out = []
    for i, s in enumerate(SHAPES):
        p = torch.nn.Parameter(torch.tensor(
            rs.randn(*s).astype(np.float32)).to(dev, dtype))
        p.optimize_attr = {"learning_rate": [1.0, 0.5, 2.0, 1.0, 1.0][i]}
        out.append((f"p{i}", p))
    return out


def _run(rule, dev, fused, clip, dtype=torch.float32, steps=4):
    named = _params(dev, dtype)
    kw = dict(grad_clip=tnn.ClipGradByGlobalNorm(0.5) if clip else None)
    if dtype != torch.float32:
        kw["multi_precision"] = True
    opt = RULES[rule](named, **kw)
    opt._use_fused = fused
    for step in range(steps):
        rs = np.random.RandomState(100 + step)
        for _, p in named:
            p.grad = torch.tensor(rs.randn(*p.shape).astype(
                np.float32)).to(dev, dtype)
        opt.step()
        if isinstance(opt._lr, topt.lr.LRScheduler):
            opt._lr.step()
    return [p for _, p in named], opt


@pytest.mark.cuda
@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("clip", [False, True])
def test_multi_tensor_equals_per_param_bitwise_on_the_card(cuda, rule,
                                                           clip,
                                                           fused_steps):
    pa, oa = _run(rule, cuda, True, clip)
    pb, ob = _run(rule, cuda, False, clip)
    assert fused_steps(oa) == 4 and fused_steps(ob) == 0
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)
    sa, sb = oa.state_dict(), ob.state_dict()
    for k, v in sa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, sb[k]), k
    pc, _ = _run(rule, torch.device("cpu"), True, clip)
    start = [p for _, p in _params(torch.device("cpu"))]
    num = den = 0.0
    for a, c, s in zip(pa, pc, start):
        a, c, s = a.detach().cpu().double(), c.detach().double(), \
            s.detach().double()
        assert float((a - c).abs().max()) <= (1e-5 if clip else 1e-6)
        num += float((a - c).pow(2).sum())
        den += float((c - s).pow(2).sum())
    assert (num / den) ** 0.5 <= (5e-6 if clip else 2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["momentum", "adam", "adamw"])
def test_multi_precision_paths_agree_on_the_card(cuda, rule):
    pa, oa = _run(rule, cuda, True, True, torch.bfloat16)
    pb, ob = _run(rule, cuda, False, True, torch.bfloat16)
    for a, b in zip(pa, pb):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        m = oa._accumulators[id(a)]["master_weight"]
        assert m.dtype == torch.float32
        assert torch.equal(m, ob._accumulators[id(b)]["master_weight"])
        assert torch.equal(a.detach(), m.to(torch.bfloat16))


def _batch(seed, b=4, s=64, vocab=1024):
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, vocab, (b, s)).astype(np.int64)
    labels = np.full((b, s + 1), -1, np.int64)
    masked = rs.rand(b, s) < 0.15
    labels[:, :s][masked] = ids[masked]
    ids[masked] = 3
    labels[:, s] = rs.randint(0, 2, b)
    return (ids, np.zeros_like(ids), np.ones((b, s), np.float32)), labels


def _loss(outs, labels):
    mlm, nsp = outs
    return torch.nn.functional.cross_entropy(
        mlm.float().reshape(-1, mlm.shape[-1]),
        labels[:, :-1].reshape(-1), ignore_index=-1) + \
        torch.nn.functional.cross_entropy(nsp.float(), labels[:, -1])


def _trainer(dev, remat=False, accum=1):
    model = ErnieForPretraining(ErnieConfig.tiny(), device=dev,
                                generator=torch.Generator().manual_seed(0))
    opt = topt.AdamW(1e-3, parameters=model.named_parameters(),
                     grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    return SpmdTrainer(model, _loss, opt, compute_dtype="bfloat16",
                       device=dev, generator=torch.Generator().manual_seed(1),
                       remat=remat, grad_accum=accum)


@pytest.mark.cuda
def test_remat_is_bitwise_with_dropout_on_the_card(cuda):
    out = []
    for remat in (False, True):
        tr = _trainer(cuda, remat, accum=2)
        losses = [tr.step(*_batch(s)) for s in (1, 2)]
        out.append((losses, [p.detach().clone()
                             for p in tr.layer.parameters()]))
    (la, pa), (lb, pb) = out
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


@pytest.mark.cuda
def test_run_epoch_equals_a_loop_of_step_on_the_card(cuda):
    batches = [_batch(10 + i) for i in range(5)]
    ta, tb = _trainer(cuda), _trainer(cuda)
    la = ta.run_epoch(iter(batches), chunk=2)
    for inputs, labels in batches:
        lb = tb.step(inputs, labels)
    assert torch.equal(la, lb)
    for a, b in zip(ta.layer.parameters(), tb.layer.parameters()):
        assert torch.equal(a, b)
