"""The port's learning-rate schedules (`paddle_tpu_torch.optimizer.lr`)
against the JAX package's, on the CPU.

Each of the 14 schedules, built alike in both packages, is stepped 30
times: the host form's `get_lr()` sequences agree in float64 (rtol
1e-12: the same Python arithmetic). The count form, `get_lr_traced(c)`
for c in 0..29, agrees with the JAX traced form evaluated on an int32
count (rtol 1e-6: both compute in float32, one rounding an operation,
but exp, cos and pow come from two libraries). `state_dict()` round
trips and continues identically (ReduceOnPlateau's carries its best
metric and counters too, which the JAX package's drops).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 30

# name -> (constructor args, kwargs) shared by both packages
SCHEDULES = {
    "noam": ("NoamDecay", (64, 10), dict(learning_rate=2.0)),
    "piecewise": ("PiecewiseDecay", ([5, 12, 20], [0.1, 0.05, 0.02, 0.01]),
                  {}),
    "natural_exp": ("NaturalExpDecay", (0.1, 0.07), {}),
    "inverse_time": ("InverseTimeDecay", (0.1, 0.3), {}),
    "polynomial": ("PolynomialDecay", (0.1, 12), dict(end_lr=1e-3,
                                                      power=2.0)),
    "polynomial_cycle": ("PolynomialDecay", (0.1, 7),
                         dict(end_lr=1e-3, power=1.5, cycle=True)),
    "linear_warmup_float": ("LinearWarmup", (0.05, 6, 0.0, 0.05), {}),
    "linear_warmup_poly": ("LinearWarmup",
                           (("PolynomialDecay", (1e-4, 20),
                             dict(end_lr=0.0)), 4, 0.0, 1e-4), {}),
    "exponential": ("ExponentialDecay", (0.1, 0.9), {}),
    "multi_step": ("MultiStepDecay", (0.1, [3, 9, 17]), dict(gamma=0.3)),
    "step": ("StepDecay", (0.1, 4), dict(gamma=0.5)),
    "lambda": ("LambdaDecay", (0.1, lambda e: 0.95 ** e), {}),
    "reduce_on_plateau": ("ReduceOnPlateau", (0.1,),
                          dict(patience=2, factor=0.5, cooldown=1)),
    "cosine": ("CosineAnnealingDecay", (0.1, 11), dict(eta_min=1e-3)),
    "one_cycle": ("OneCycleLR", (0.1, 25), {}),
    "cyclic": ("CyclicLR", (0.01, 0.1, 4), dict(step_size_down=6)),
    "cyclic_triangular2": ("CyclicLR", (0.01, 0.1, 3),
                           dict(mode="triangular2")),
    "cyclic_exp_range": ("CyclicLR", (0.01, 0.1, 3),
                         dict(mode="exp_range", exp_gamma=0.97)),
}
TRACEABLE = {"NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
             "InverseTimeDecay", "PolynomialDecay", "LinearWarmup",
             "ExponentialDecay", "MultiStepDecay", "StepDecay",
             "CosineAnnealingDecay"}


def build(mod, name):
    cls, args, kw = SCHEDULES[name]
    if cls == "LinearWarmup" and isinstance(args[0], tuple):
        icls, iargs, ikw = args[0]
        args = (getattr(mod, icls)(*iargs, **ikw),) + args[1:]
    return getattr(mod, cls)(*args, **kw)


def metric(i):
    """A loss that improves, stalls and improves again."""
    return [5.0, 4.0, 3.9, 3.9, 3.95, 3.9, 3.0, 3.0, 3.1, 3.2][i % 10] - \
        0.01 * (i // 10)


def sequence(mod, name):
    s = build(mod, name)
    out = [s()]
    for i in range(STEPS):
        if SCHEDULES[name][0] == "ReduceOnPlateau":
            s.step(metric(i))
        else:
            s.step()
        out.append(s())
    return out


def test_every_schedule_is_covered():
    classes = {SCHEDULES[n][0] for n in SCHEDULES}
    assert classes == set(tlr.__all__) - {"LRScheduler"}
    assert len(classes) == 14


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_host_form_matches_jax(name):
    np.testing.assert_allclose(sequence(tlr, name), sequence(jlr, name),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_count_form_matches_jax_traced_form(name):
    cls = SCHEDULES[name][0]
    port, ref = build(tlr, name), build(jlr, name)
    assert type(port).traceable() == (cls in TRACEABLE) == \
        type(ref).traceable()
    if cls not in TRACEABLE:
        assert port.get_lr_traced(3) is None
        return
    got = [port.get_lr_traced(c) for c in range(STEPS)]
    want = [float(ref.get_lr_traced(jnp.int32(c))) for c in range(STEPS)]
    assert all(isinstance(v, float) for v in got)
    assert all(v == np.float32(v) for v in got)      # float32 values
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_linear_warmup_over_an_untraceable_schedule_has_no_count_form():
    inner = tlr.LambdaDecay(0.1, lambda e: 0.9 ** e)
    assert tlr.LinearWarmup(inner, 3, 0.0, 0.1).get_lr_traced(5) is None


def test_linear_warmup_steps_its_inner_schedule():
    """Past the warmup the host form moves the inner schedule to
    last_epoch - warmup_steps, as the JAX package's does."""
    for mod in (tlr, jlr):
        inner = mod.StepDecay(0.1, 2, 0.5)
        s = mod.LinearWarmup(inner, 3, 0.0, 0.1)
        for _ in range(8):
            s.step()
        assert inner.last_epoch == 5
        assert s() == inner() == 0.1 * 0.5 ** 2


@pytest.mark.parametrize("name", ["step", "linear_warmup_poly",
                                  "reduce_on_plateau", "cyclic"])
def test_state_dict_round_trip_continues_identically(name):
    a = build(tlr, name)
    for i in range(7):
        a.step(metric(i)) if SCHEDULES[name][0] == "ReduceOnPlateau" \
            else a.step()
    sd = a.state_dict()
    ref = build(jlr, name)
    for i in range(7):
        ref.step(metric(i)) if SCHEDULES[name][0] == "ReduceOnPlateau" \
            else ref.step()
    ref_sd = ref.state_dict()                # the port's may hold more
    assert {k: sd[k] for k in ref_sd} == ref_sd
    b = build(tlr, name)
    b.set_state_dict(dict(sd))
    assert b() == a()
    for i in range(7, 12):
        for s in (a, b):
            s.step(metric(i)) if SCHEDULES[name][0] == "ReduceOnPlateau" \
                else s.step()
        assert a() == b()
