"""Helpers of the op library's parity tests: `run_jax_ops` runs a
function of the JAX package's op library (jax arrays in and out) the way
`_torch_parity.run_jax` runs one of its Tensor API, and `compare` holds
the port to either."""
import numpy as np

from _torch_parity import _cot, _outs, run_jax, run_port


def run_jax_ops(fn, args, wrt=(), jit=True):
    """(outputs, gradients of <outputs, a fixed random cotangent> with
    respect to args[i] for i in wrt) of fn over jax arrays made from the
    numpy args, jitted unless `jit` is False (XLA may contract a float32
    multiply and add into one rounding under jit)."""
    import jax
    import jax.numpy as jnp

    def call(*diff):
        full = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
                for a in args]
        for i, d in zip(wrt, diff):
            full[i] = d
        return _outs(fn(*full))

    wrap = jax.jit if jit else (lambda f: f)
    prim = [jnp.asarray(args[i]) for i in wrt]
    vals = [np.asarray(o) for o in wrap(call)(*prim)]
    grads = []
    if wrt:
        cots = [jnp.asarray(_cot(v.shape, 7 + j).astype(v.dtype))
                if v.dtype.kind == "f" else None for j, v in enumerate(vals)]

        def total(*diff):
            return sum((o * c).sum() for o, c in zip(call(*diff), cots)
                       if c is not None)

        grads = [np.asarray(g) for g in wrap(jax.grad(
            total, argnums=tuple(range(len(prim)))))(*prim)]
    return vals, grads


def compare(jax_fn, port_fn, args, wrt=(), rtol=1e-10, atol=1e-12,
            ops=True):
    """Outputs equal in shape; float outputs and gradients within rtol /
    atol; integer and boolean outputs equal. `ops`: jax_fn takes jax
    arrays (True: jitted, "eager": not); False: the JAX package's
    Tensors (`run_jax`)."""
    if ops:
        jv, jg = run_jax_ops(jax_fn, args, wrt, jit=ops != "eager")
    else:
        jv, jg = run_jax(jax_fn, args, wrt)
    pv, pg = run_port(port_fn, args, wrt)
    assert len(jv) == len(pv), (len(jv), len(pv))
    for k, (a, b) in enumerate(zip(pv, jv)):
        b = np.asarray(b)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if b.dtype.kind in "fc":
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f"output {k}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"output {k}")
    for k, (a, b) in enumerate(zip(pg, jg)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"gradient {k}")
    return pv, jv
