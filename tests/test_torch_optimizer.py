"""The port's optimizer layer against the JAX package's, on the CPU:
`regularizer`, the gradient clips, the eager optimizers (multi-tensor
and per-parameter paths), `optimizer.functional` and `from_eager`.

Parameters and gradients come from numpy seeds, the same in both
packages. Limits: parameters and slots after 4 steps within atol 1e-6
+ rtol 1e-6 of the JAX package's (the JAX fused path's own limit
against its per-parameter path is atol 1e-6). The rules compute the
same float32 operations in the same order; what differs is the order
of the reductions (the global norm, Lamb's and LARS's per-tensor norms),
which moves a clip scale or a trust ratio by a few ulps and the
parameters by a few ulps of an update of lr 0.01. The port's
multi-tensor step equals its per-parameter path bit for bit. The clip
scale is held to 1e-6 relative of the JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn.layer.layers import Parameter as JParameter
from paddle_tpu.optimizer import functional as jfopt
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.optimizer import functional as tfopt
from paddle_tpu_torch.optimizer import fused as tfused

torch.set_num_threads(2)
RTOL = ATOL = 1e-6
SHAPES = [(4, 5), (5,), (3, 4), (2, 3, 2), (6,)]


def _values(seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in SHAPES]


def jax_params(mults=None, seed=0):
    return [JParameter(v, name=f"p{i}",
                       learning_rate=mults[i] if mults else 1.0)
            for i, v in enumerate(_values(seed))]


def port_params(mults=None, seed=0, dtype=torch.float32):
    out = []
    for i, v in enumerate(_values(seed)):
        p = torch.nn.Parameter(torch.tensor(v).to(dtype))
        if mults:
            p.optimize_attr = {"learning_rate": mults[i]}
        out.append(p)
    return out


def set_grads(jps, tps, seed):
    for g, jp, tp in zip(_values(seed + 100), jps or [None] * 5,
                         tps or [None] * 5):
        if jp is not None:
            jp.grad = Tensor(g)
        if tp is not None:
            tp.grad = torch.tensor(g).to(tp.dtype)


def make(pkg, rule, params, lr, **kw):
    """The rule of `tests/test_fused_optimizer.py`'s grid, built alike in
    both packages (pkg "jax" or "port"; port parameters are passed with
    the JAX ones' names)."""
    jax = pkg == "jax"
    O = paddle.optimizer if jax else topt
    if not jax:
        params = [(f"p{i}", p) for i, p in enumerate(params)]
    if rule == "sgd":
        return O.SGD(lr, parameters=params, weight_decay=0.01, **kw)
    if rule == "momentum":
        return O.Momentum(lr, 0.9, parameters=params, weight_decay=0.01,
                          **kw)
    if rule == "momentum_nesterov":
        return O.Momentum(lr, 0.9, parameters=params, use_nesterov=True,
                          **kw)
    if rule == "adam":
        return O.Adam(lr, parameters=params, weight_decay=0.02, **kw)
    if rule == "adamw":
        return O.AdamW(lr, parameters=params,
                       apply_decay_param_fun=lambda n: not n.endswith("1"),
                       **kw)
    if rule == "adamax":
        return O.Adamax(lr, parameters=params, **kw)
    if rule == "adagrad":
        return O.Adagrad(lr, parameters=params, **kw)
    if rule == "adadelta":
        return O.Adadelta(lr, parameters=params, **kw)
    if rule == "rmsprop":
        return O.RMSProp(lr, momentum=0.9, centered=True, parameters=params,
                         **kw)
    assert rule == "lamb"
    # the JAX Lamb passes the Parameter, the port's its name
    excl = (lambda p: p.name == "p0") if jax else (lambda n: n == "p0")
    return O.Lamb(lr, parameters=params, exclude_from_weight_decay_fn=excl,
                  **kw)


RULES = ["sgd", "momentum", "momentum_nesterov", "adam", "adamw", "adamax",
         "adagrad", "adadelta", "rmsprop", "lamb"]


def run(pkg, rule, lr=0.01, clip=False, mults=None, sched=False, steps=4,
        fused=True):
    jax = pkg == "jax"
    O = paddle.optimizer if jax else topt
    ps = jax_params(mults) if jax else port_params(mults)
    lrv = O.lr.StepDecay(lr, 2, 0.5) if sched else lr
    clipper = (jnn if jax else tnn).ClipGradByGlobalNorm(0.5) if clip \
        else None
    opt = make(pkg, rule, ps, lrv, grad_clip=clipper)
    if not fused:
        opt._use_fused = False
    for step in range(steps):
        set_grads(ps if jax else None, None if jax else ps, step)
        opt.step()
        if sched:
            opt._lr.step()
    return ps, opt


@pytest.fixture
def fused_steps(monkeypatch):
    """fused_steps(opt): how many of opt's steps took the multi-tensor
    path (`optimizer.fused.apply`)."""
    seen = []
    inner = tfused.apply

    def counted(opt, dense_pg):
        seen.append(opt)
        return inner(opt, dense_pg)
    monkeypatch.setattr(tfused, "apply", counted)
    return lambda opt: sum(o is opt for o in seen)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(v._data if hasattr(v, "_data") else v, np.float32)


def assert_match_jax(tps, topt_, jps, jopt):
    for i, (a, b) in enumerate(zip(tps, jps)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL,
                                   err_msg=f"p{i}")
    sa, sb = topt_.state_dict(), jopt.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        if k in ("_step_count", "LR_Scheduler"):
            assert sa[k] == sb[k], k
        else:
            np.testing.assert_allclose(_np(sa[k]), _np(sb[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


def assert_bitwise(pa, oa, pb, ob):
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)
    sa, sb = oa.state_dict(), ob.state_dict()
    assert set(sa) == set(sb)
    for k, v in sa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, sb[k]), k


# ------------------------------------------------- eager against JAX

@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("clip", [False, True])
def test_eager_rule_x_clip_matches_jax(rule, clip, fused_steps):
    tps, to = run("port", rule, clip=clip)
    jps, jo = run("jax", rule, clip=clip)
    assert fused_steps(to) == 4, "multi-tensor path not taken"
    assert_match_jax(tps, to, jps, jo)


@pytest.mark.parametrize("rule", ["sgd", "adam", "rmsprop"])
def test_eager_schedule_with_clip_matches_jax(rule, fused_steps):
    tps, to = run("port", rule, clip=True, sched=True, steps=5)
    jps, jo = run("jax", rule, clip=True, sched=True, steps=5)
    assert_match_jax(tps, to, jps, jo)
    # the rate enters as a value: every step of the decaying schedule
    # takes the multi-tensor path
    assert fused_steps(to) == 5


@pytest.mark.parametrize("rule", ["sgd", "momentum", "adam", "lamb"])
def test_eager_lr_multipliers_match_jax(rule):
    mults = [1.0, 0.5, 2.0, 1.0, 0.0]
    tps, to = run("port", rule, mults=mults)
    jps, jo = run("jax", rule, mults=mults)
    assert_match_jax(tps, to, jps, jo)
    assert torch.equal(tps[4], port_params()[4])     # multiplier 0: frozen


# ---------------------------- multi-tensor against per-parameter path

@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("variant", ["plain", "schedule_and_multipliers"])
def test_multi_tensor_step_equals_per_param_path_bitwise(rule, clip,
                                                         variant,
                                                         fused_steps):
    kw = dict(clip=clip)
    if variant != "plain":
        kw.update(sched=True, mults=[1.0, 0.5, 2.0, 1.0, 0.0])
    pa, oa = run("port", rule, **kw)
    pb, ob = run("port", rule, fused=False, **kw)
    assert fused_steps(oa) == 4 and fused_steps(ob) == 0
    assert_bitwise(pa, oa, pb, ob)


def test_paths_switch_between_steps_and_env_switch(monkeypatch,
                                                   fused_steps):
    """Slots live where both paths read them: alternating paths gives the
    bits of either path alone; PADDLE_TPU_FUSED_OPT=0 takes the
    per-parameter path."""
    pa, oa = run("port", "adamw", clip=True)
    pb = port_params()
    ob = make("port", "adamw", pb, 0.01,
              grad_clip=tnn.ClipGradByGlobalNorm(0.5))
    for step in range(4):
        set_grads(None, pb, step)
        ob._use_fused = bool(step % 2)
        ob.step()
    assert_bitwise(pa, oa, pb, ob)
    monkeypatch.setenv("PADDLE_TPU_FUSED_OPT", "0")
    pc, oc = run("port", "adamw", clip=True)
    assert fused_steps(oc) == 0
    assert_bitwise(pa, oa, pc, oc)


@pytest.mark.parametrize("rule", ["momentum", "adam", "adamw"])
def test_multi_precision_bf16_params_match_jax(rule):
    """bf16 parameters over float32 master weights: the masters match the
    JAX package's, each parameter is its master rounded to bf16, and the
    two port paths agree bit for bit."""
    lr = 0.1 if rule == "momentum" else 0.01
    jps = jax_params()
    for p in jps:
        p._data = p._data.astype(jnp.bfloat16)
    jo = make("jax", rule, jps, lr, multi_precision=True)
    tpa, tpb = (port_params(dtype=torch.bfloat16) for _ in range(2))
    ta = make("port", rule, tpa, lr, multi_precision=True)
    tb = make("port", rule, tpb, lr, multi_precision=True)
    tb._use_fused = False
    for step in range(4):
        set_grads(None, tpa, step)    # bf16 gradients, as torch gives
        set_grads(None, tpb, step)
        for jp, tp in zip(jps, tpa):  # the same values to JAX
            jp.grad = Tensor(tp.grad.float().numpy())
        jo.step(), ta.step(), tb.step()
    assert_bitwise(tpa, ta, tpb, tb)
    for i, (tp, jp) in enumerate(zip(tpa, jps)):
        tm = ta._accumulators[id(tp)]["master_weight"]
        jm = jo._accumulators[id(jp)]["master_weight"]
        assert tm.dtype == torch.float32 and tp.dtype == torch.bfloat16
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL,
                                   atol=ATOL, err_msg=f"p{i}")
        assert torch.equal(tp.detach(), tm.to(torch.bfloat16))
    assert any(k.endswith("__master_weight") for k in ta.state_dict())


def test_multi_precision_keeps_updates_that_round_away_in_bf16():
    p_mp = torch.nn.Parameter(torch.ones(8, dtype=torch.bfloat16))
    p_lo = torch.nn.Parameter(torch.ones(8, dtype=torch.bfloat16))
    o_mp = topt.Momentum(1e-4, 0.0, parameters=[p_mp],
                         multi_precision=True)
    o_lo = topt.Momentum(1e-4, 0.0, parameters=[p_lo])
    for _ in range(20):
        for p, o in ((p_mp, o_mp), (p_lo, o_lo)):
            p.grad = torch.full((8,), 0.5, dtype=torch.bfloat16)
            o.step()
    master = o_mp._accumulators[id(p_mp)]["master_weight"]
    np.testing.assert_allclose(master.numpy(), 1.0 - 1e-3, rtol=1e-4)
    assert bool((p_lo == 1.0).all())


# --------------------------------------------------------- state, API

def test_state_dict_round_trip_continues_identically():
    pa, pb = port_params(), port_params()
    sched = lambda: topt.lr.StepDecay(0.01, 2, 0.5)  # noqa: E731
    oa = topt.Adam(sched(), parameters=pa)
    ob = topt.Adam(sched(), parameters=pb)
    for step in range(3):
        set_grads(None, pa, step), set_grads(None, pb, step)
        oa.step(), ob.step()
        oa._lr.step(), ob._lr.step()
    ob2 = topt.Adam(sched(), parameters=pb)
    ob2.set_state_dict(ob.state_dict())
    assert ob2._step_count == 3 and ob2.get_lr() == oa.get_lr()
    for step in range(3, 6):
        set_grads(None, pa, step), set_grads(None, pb, step)
        oa.step(), ob2.step()
        oa._lr.step(), ob2._lr.step()
    assert_bitwise(pa, oa, pb, ob2)


@pytest.mark.parametrize("by", ["names", "position"])
def test_jax_state_dict_continues_through_convert(by):
    """Three steps of a JAX AdamW under a schedule, its state_dict
    loaded into the port's optimizer through
    `convert.from_jax_optimizer_state` (renamed by a {JAX name: port
    name} map, or matched by position), then three more steps in both."""
    jps = jax_params()
    jo = paddle.optimizer.AdamW(paddle.optimizer.lr.StepDecay(0.01, 2),
                                parameters=jps, weight_decay=0.05,
                                grad_clip=jnn.ClipGradByGlobalNorm(0.5))
    for step in range(3):
        set_grads(jps, None, step)
        jo.step()
        jo._lr.step()
    np_state = {k: v if k in ("_step_count", "LR_Scheduler")
                else np.asarray(v._data)
                for k, v in jo.state_dict().items()}
    tps = [torch.nn.Parameter(torch.tensor(np.asarray(p._data)))
           for p in jps]
    port_names = [f"layer.w{i}" for i in range(len(tps))]
    to = topt.AdamW(topt.lr.StepDecay(0.01, 2),
                    parameters=list(zip(port_names, tps)), weight_decay=0.05,
                    grad_clip=tnn.ClipGradByGlobalNorm(0.5))
    names = dict(zip((p.name for p in jps), port_names)) if by == "names" \
        else None
    state = convert.from_jax_optimizer_state(np_state, names)
    assert (set(state) - {"_step_count", "LR_Scheduler"}) == (
        {f"{n}__{s}" for n in port_names for s in ("moment1", "moment2")}
        if by == "names" else set(np_state) - {"_step_count",
                                               "LR_Scheduler"})
    to.set_state_dict(state)
    assert to._step_count == 3 and to.get_lr() == jo.get_lr()
    for step in range(3, 6):
        set_grads(jps, tps, step)
        jo.step(), to.step()
        jo._lr.step(), to._lr.step()
    for i, (a, b) in enumerate(zip(tps, jps)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL,
                                   err_msg=f"p{i}")


def test_minimize_matches_jax_and_backs_propagates_once(fused_steps):
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    paddle.seed(0)
    jlin = jnn.Linear(3, 2)
    tlin = tnn.Linear(3, 2, device="cpu")
    tlin.load_state_dict(convert.from_jax_state(
        {k: np.asarray(v) for k, v in jlin.state_dict().items()}))
    jo = paddle.optimizer.SGD(0.1, parameters=jlin.parameters())
    to = topt.SGD(0.1, parameters=tlin.named_parameters())
    jo.minimize(jlin(paddle.to_tensor(x)).mean())
    loss = tlin(torch.tensor(x)).mean()
    assert to.minimize(loss) == (None, None)
    assert fused_steps(to) == 1
    for n, p in tlin.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), np.asarray(jlin.state_dict()[n]),
            rtol=RTOL, atol=ATOL, err_msg=n)
    to.clear_grad()
    assert all(p.grad is None for p in tlin.parameters())


def test_set_lr_refuses_a_schedule():
    ps = port_params()
    opt = topt.SGD(topt.lr.StepDecay(0.1, 2), parameters=ps)
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.5)
    opt2 = topt.SGD(0.1, parameters=ps)
    opt2.set_lr(0.5)
    assert opt2.get_lr() == 0.5


def test_weight_decay_regularizers():
    """L2Decay acts as its coefficient; L1Decay is refused (the JAX
    optimizers would decay it as L2); so is a decay on a rule that
    applies none. Both regularizers' gradient terms match JAX's."""
    from paddle_tpu import regularizer as jreg

    pa, pb = port_params(), port_params()
    oa = topt.Momentum(0.1, parameters=pa, weight_decay=treg.L2Decay(0.03))
    ob = topt.Momentum(0.1, parameters=pb, weight_decay=0.03)
    set_grads(None, pa, 0), set_grads(None, pb, 0)
    oa.step(), ob.step()
    assert_bitwise(pa, oa, pb, ob)
    with pytest.raises(ValueError, match="L1Decay"):
        topt.Adam(0.1, parameters=pa, weight_decay=treg.L1Decay(0.01))
    with pytest.raises(ValueError, match="no weight decay"):
        topt.Adagrad(0.1, parameters=pa, weight_decay=0.01)
    assert treg.L1DecayRegularizer is treg.L1Decay
    v = _values(3)[0]
    for cls in ("L1Decay", "L2Decay"):
        np.testing.assert_allclose(
            getattr(treg, cls)(0.2).grad_term(torch.tensor(v)).numpy(),
            np.asarray(getattr(jreg, cls)(0.2).grad_term(jnp.asarray(v))),
            rtol=1e-7)


def test_sparse_gradients_are_refused():
    p = torch.nn.Parameter(torch.zeros(4, 3))
    opt = topt.SGD(0.1, parameters=[p])
    p.grad = torch.zeros(4, 3).to_sparse()
    with pytest.raises(NotImplementedError, match="sparse"):
        opt.step()


def test_named_parameters_reach_the_decay_rule_on_the_ernie_recipe():
    """AdamW over `model.named_parameters()` with the ERNIE recipe's
    rule: biases and norm weights keep their values at lr 0 with a
    decay, every other weight shrinks by lr * wd exactly."""
    from paddle_tpu_torch.text import ErnieConfig, ErnieForPretraining

    model = ErnieForPretraining(ErnieConfig.tiny(num_layers=1),
                                device="cpu")
    seen = []

    def decays(name):
        seen.append(name)
        return not (name.endswith("bias") or "norm" in name)

    opt = topt.AdamW(0.1, parameters=model.named_parameters(),
                     weight_decay=0.5, apply_decay_param_fun=decays)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    assert set(seen) == set(before)
    for n, p in model.named_parameters():
        if decays(n):
            torch.testing.assert_close(p.detach(), before[n] * 0.95,
                                       rtol=1e-6, atol=0)
        else:
            assert torch.equal(p.detach(), before[n]), n
    assert any("norm" in n for n in before) and \
        any(n.endswith("bias") for n in before)


# ---------------------------------------------------------------- clips

@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_global_norm_clip_scale_matches_jax(scale):
    from paddle_tpu.nn import _clip_global_jit

    gs = [v * scale for v in _values(7)]
    want = _clip_global_jit()(tuple(jnp.asarray(g) for g in gs), 0.7)
    got = tclip.clip_by_global_norm([torch.tensor(g) for g in gs], 0.7)
    ratio = [np.asarray(w) / g for w, g in zip(want, gs)]
    port = [t.numpy() / g for t, g in zip(got, gs)]
    np.testing.assert_allclose(np.concatenate([r.ravel() for r in port]),
                               np.concatenate([r.ravel() for r in ratio]),
                               rtol=1e-6)


@pytest.mark.parametrize("clip", ["by_norm", "by_value"])
def test_per_tensor_clips_match_jax_on_the_per_param_path(clip,
                                                           fused_steps):
    jc = jnn.ClipGradByNorm(0.7) if clip == "by_norm" else \
        jnn.ClipGradByValue(0.1)
    tc = tnn.ClipGradByNorm(0.7) if clip == "by_norm" else \
        tnn.ClipGradByValue(0.1)
    jps, tps = jax_params(), port_params()
    jo = paddle.optimizer.SGD(0.05, parameters=jps, grad_clip=jc)
    to = topt.SGD(0.05, parameters=tps, grad_clip=tc)
    for step in range(3):
        set_grads(jps, tps, step)
        jo.step(), to.step()
    assert fused_steps(to) == 0
    for a, b in zip(tps, jps):
        np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------- functional

def _fdict(vals, pkg):
    if pkg == "jax":
        return {f"p{i}": jnp.asarray(v) for i, v in enumerate(vals)}
    return {f"p{i}": torch.tensor(v) for i, v in enumerate(vals)}


def _no_decay(key):
    """Decay all but p1: the JAX rule passes a key path ("['p1']"), the
    port's the name."""
    return not key.rstrip("']").endswith("1")


FUNCTIONAL = {
    "sgd": lambda F: F.sgd(0.05, weight_decay=0.01),
    "momentum": lambda F: F.momentum(0.05, 0.9, weight_decay=0.01),
    "momentum_nesterov": lambda F: F.momentum(0.05, 0.9,
                                              use_nesterov=True),
    "adam": lambda F: F.adam(0.01, weight_decay=0.02),
    "adamw_mask": lambda F: F.adamw(0.01, weight_decay=0.1,
                                    decay_mask=_no_decay),
    "adam_schedule": lambda F: F.adam(
        (paddle.optimizer.lr if F is jfopt else topt.lr).NaturalExpDecay(
            0.01, 0.3).get_lr_traced),
    "lamb": lambda F: F.lamb(0.01, weight_decay=0.05),
    "adamax": lambda F: F.adamax(0.01),
    "adagrad": lambda F: F.adagrad(0.05),
    "adadelta": lambda F: F.adadelta(1.0),
    "rmsprop": lambda F: F.rmsprop(0.01, momentum=0.9),
    "rmsprop_centered": lambda F: F.rmsprop(0.01, momentum=0.9,
                                            centered=True),
    "lars_momentum": lambda F: F.lars_momentum(0.1, lars_coeff=0.01),
    "clip_adamw": lambda F: F.clip_by_global_norm(F.adamw(0.01), 0.5),
    "dgc_momentum": lambda F: F.dgc(F.momentum(0.05, 0.9), sparsity=0.7),
}


@pytest.mark.parametrize("rule", sorted(FUNCTIONAL))
def test_functional_rule_matches_jax(rule):
    jtx, ttx = FUNCTIONAL[rule](jfopt), FUNCTIONAL[rule](tfopt)
    jp, tp = _fdict(_values(0), "jax"), _fdict(_values(0), "port")
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(4):
        g = _values(step + 100)
        jp, js = jtx.update(jp, _fdict(g, "jax"), js)
        tp_new, ts = ttx.update(tp, _fdict(g, "port"), ts)
        assert all(not torch.equal(tp[n], tp_new[n]) for n in tp) or \
            rule.startswith("dgc")
        tp = tp_new
    for n in tp:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    jl = [np.asarray(x) for x in _leaves(js)]
    tl = [x.numpy() for x in _leaves(ts)]
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _leaves(state):
    """Every slot tensor of a state (nested named tuples of dicts), in
    order; counts are checked to be equal step counts."""
    out = []
    for field in state:
        if isinstance(field, dict):
            out += [field[k] for k in sorted(field)]
        elif isinstance(field, tuple):
            out += _leaves(field)
        else:
            assert int(field) == 4
    return out


def test_functional_update_leaves_its_inputs_unchanged():
    tx = tfopt.clip_by_global_norm(tfopt.adamw(0.1), 0.5)
    p = _fdict(_values(0), "port")
    g = _fdict(_values(1), "port")
    keep = {n: t.clone() for n, t in p.items()}
    state = tx.init(p)
    tx.update(p, g, state)
    assert all(torch.equal(p[n], keep[n]) for n in p)
    assert all(bool((m == 0).all()) for m in state.m.values())


# ---------------------------------------------------------- from_eager

def _eager_pair(kind):
    jps, tps = jax_params(), port_params()
    tnamed = [(f"p{i}", p) for i, p in enumerate(tps)]
    if kind == "adamw_warmup_clip":
        def sched(L):
            return L.LinearWarmup(L.PolynomialDecay(0.01, 10, 0.0), 3,
                                  0.0, 0.01)
        j = paddle.optimizer.AdamW(
            sched(paddle.optimizer.lr), parameters=jps, weight_decay=0.1,
            grad_clip=jnn.ClipGradByGlobalNorm(0.5),
            apply_decay_param_fun=_no_decay)
        t = topt.AdamW(sched(topt.lr), parameters=tnamed, weight_decay=0.1,
                       grad_clip=tnn.ClipGradByGlobalNorm(0.5),
                       apply_decay_param_fun=_no_decay)
    elif kind == "momentum_step_decay":
        j = paddle.optimizer.Momentum(
            paddle.optimizer.lr.StepDecay(0.05, 2), 0.9, parameters=jps,
            weight_decay=0.01, use_nesterov=True)
        t = topt.Momentum(topt.lr.StepDecay(0.05, 2), 0.9,
                          parameters=tnamed, weight_decay=0.01,
                          use_nesterov=True)
    elif kind == "sgd":
        j = paddle.optimizer.SGD(0.05, parameters=jps, weight_decay=0.02)
        t = topt.SGD(0.05, parameters=tnamed, weight_decay=0.02)
    else:
        j = paddle.optimizer.Adam(0.01, parameters=jps, weight_decay=0.02)
        t = topt.Adam(0.01, parameters=tnamed, weight_decay=0.02)
    return j, t


@pytest.mark.parametrize("kind", ["adamw_warmup_clip",
                                  "momentum_step_decay", "sgd", "adam"])
def test_from_eager_matches_jax(kind):
    j, t = _eager_pair(kind)
    jtx, ttx = jfopt.from_eager(j), tfopt.from_eager(t)
    jp, tp = _fdict(_values(0), "jax"), _fdict(_values(0), "port")
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(5):
        g = _values(step + 100)
        jp, js = jtx.update(jp, _fdict(g, "jax"), js)
        tp, ts = ttx.update(tp, _fdict(g, "port"), ts)
    for n in tp:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def test_from_eager_freezes_a_schedule_without_a_count_form():
    ps = port_params()
    sched = topt.lr.ReduceOnPlateau(0.1)
    with pytest.warns(UserWarning, match="freezes its current lr=0.1"):
        tx = tfopt.from_eager(topt.SGD(sched, parameters=ps))
    p = _fdict(_values(0), "port")
    new, _ = tx.update(p, _fdict(_values(1), "port"), tx.init(p))
    torch.testing.assert_close(new["p0"], p["p0"] - 0.1 * torch.tensor(
        _values(1)[0]), rtol=0, atol=0)
    with pytest.warns(UserWarning, match="exclude_from_weight_decay_fn"):
        tfopt.from_eager(topt.Lamb(0.1, parameters=ps,
                                   exclude_from_weight_decay_fn=bool))


def test_from_eager_gives_each_rule_its_own_transform():
    """Adamax, Adagrad, Adadelta and RMSProp become their own rules (the
    JAX package's from_eager falls back to sgd for them)."""
    ps = port_params()
    for opt, want in (
            (topt.Adamax(0.01, parameters=ps), tfopt.adamax(0.01)),
            (topt.Adagrad(0.01, parameters=ps), tfopt.adagrad(0.01)),
            (topt.Adadelta(0.5, parameters=ps), tfopt.adadelta(0.5)),
            (topt.RMSProp(0.01, parameters=ps), tfopt.rmsprop(0.01))):
        tx = tfopt.from_eager(opt)
        p, g = _fdict(_values(0), "port"), _fdict(_values(1), "port")
        a, _ = tx.update(p, g, tx.init(p))
        b, _ = want.update(p, g, want.init(p))
        assert all(torch.equal(a[n], b[n]) for n in p)
