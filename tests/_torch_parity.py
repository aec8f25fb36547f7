"""Helpers of the port's CPU parity tests: run one function of the JAX
package (on its Tensors, through its autograd tape) and its port (on CPU
torch tensors, through torch autograd) on the same numpy inputs, and
return the outputs and the gradients of <outputs, a fixed random
cotangent> with respect to chosen inputs, as numpy arrays."""
import numpy as np
import pytest
import torch


@pytest.fixture
def keep_global_rng():
    """Leave the global random state as the test found it: the JAX
    package's key chain (which its layers' initialisers and `seed` move),
    torch's default CPU generator and numpy's global one. JAX tests that
    a worker runs later draw their initial weights from that chain, and
    some of their thresholds hold only for the draws their usual order
    gives."""
    from paddle_tpu.core import random as jrandom

    saved = (jrandom._key, jrandom._seed_value, torch.get_rng_state(),
             np.random.get_state())
    yield
    jrandom._key, jrandom._seed_value = saved[0], saved[1]
    torch.set_rng_state(saved[2])
    np.random.set_state(saved[3])


def _cot(shape, seed):
    return np.random.RandomState(seed).uniform(0.5, 1.5, shape)


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def run_jax(fn, args, wrt=()):
    import paddle_tpu as paddle

    ts = [paddle.to_tensor(a, stop_gradient=i not in wrt)
          if isinstance(a, np.ndarray) else a for i, a in enumerate(args)]
    outs = _outs(fn(*ts))
    vals = [np.asarray(o.numpy()) for o in outs]
    grads = []
    if wrt:
        total = None
        for j, (o, v) in enumerate(zip(outs, vals)):
            if v.dtype.kind != "f":
                continue
            term = (o * paddle.to_tensor(_cot(v.shape, 7 + j).astype(
                v.dtype))).sum()
            total = term if total is None else total + term
        total.backward()
        for i in wrt:
            g = ts[i].grad
            grads.append(np.zeros_like(args[i]) if g is None
                         else np.asarray(g.numpy()))
    return vals, grads


def run_port(fn, args, wrt=()):
    ts = [torch.from_numpy(a.copy()).requires_grad_(i in wrt)
          if isinstance(a, np.ndarray) else a for i, a in enumerate(args)]
    outs = _outs(fn(*ts))
    vals = [o.detach().numpy() for o in outs]
    grads = []
    if wrt:
        total = None
        for j, (o, v) in enumerate(zip(outs, vals)):
            if v.dtype.kind != "f":
                continue
            term = (o * torch.from_numpy(_cot(v.shape, 7 + j).astype(
                v.dtype))).sum()
            total = term if total is None else total + term
        total.backward()
        for i in wrt:
            g = ts[i].grad
            grads.append(np.zeros_like(args[i]) if g is None
                         else g.numpy())
    return vals, grads


def compare(jax_fn, port_fn, args, wrt=(), rtol=1e-9, atol=1e-12,
            exact_ints=True):
    """Outputs equal in shape; float outputs and gradients within
    rtol / atol; integer and boolean outputs equal."""
    jv, jg = run_jax(jax_fn, args, wrt)
    pv, pg = run_port(port_fn, args, wrt)
    assert len(jv) == len(pv), (len(jv), len(pv))
    for k, (a, b) in enumerate(zip(pv, jv)):
        b = np.asarray(b)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if b.dtype.kind in "fc":
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f"output {k}")
        elif exact_ints:
            np.testing.assert_array_equal(a, b, err_msg=f"output {k}")
    for k, (a, b) in enumerate(zip(pg, jg)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"gradient {k}")
    return pv, jv


def smooth(shape, seed, lo=0.2, hi=2.0):
    """float64 values away from 0 (kinks of the relu family), either
    sign."""
    r = np.random.RandomState(seed)
    return r.uniform(lo, hi, shape) * np.where(r.rand(*shape) < 0.5, -1, 1)


def np_state(layer):
    """A JAX layer's state_dict as numpy arrays."""
    return {k: np.asarray(v) for k, v in layer.state_dict().items()}
