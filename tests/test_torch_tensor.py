"""The port's tensor functions (`paddle_tpu_torch.concat`, ...) against
the JAX package's (`paddle_tpu.concat`, ...), on the CPU.

Each function runs on the same float64 (or integer) numpy inputs in both
packages. Float outputs, and for the differentiable functions the
gradients of <outputs, a fixed random cotangent> with respect to the
float inputs, agree within rtol 1e-9 / atol 1e-12; integer and boolean
outputs, index outputs included, are equal, and so are the dtypes of the
integer results (int64, as under the JAX package's x64). Paddle's
semantics where they differ from torch's each have a case: `median` on
an even count, `split` by sections (with -1), `scatter` with
overwrite=False (adds onto x's rows; unique indices, since with
duplicates and overwrite=True the winner depends on the write order in
both packages), and the tie orders of `topk`, `argsort`, `sort`,
`unique`, `argmax` and `kthvalue`. The random functions are held to
their ranges and moments.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from _torch_parity import compare, run_jax, run_port, smooth

torch.set_num_threads(2)

C = []


def case(name, args, wrt=(0,), jax_fn=None, port_fn=None, fn=None,
         tol=None, **kw):
    fn = fn or name
    jf = jax_fn or (lambda *a: getattr(J, fn)(*a, **kw))
    pf = port_fn or (lambda *a: getattr(T, fn)(*a, **kw))
    C.append(pytest.param(jf, pf, args, wrt, tol or {}, id=name))


x34 = smooth((3, 4), 0)
x234 = smooth((2, 3, 4), 1)
pos34 = np.random.RandomState(2).uniform(0.2, 2.0, (3, 4))
unit34 = np.random.RandomState(3).uniform(-0.9, 0.9, (3, 4))
i34 = np.random.RandomState(4).randint(-5, 6, (3, 4)).astype(np.int64)
ties = np.array([[3.0, 1.0, 3.0, 2.0, 1.0, 3.0], [0.5, 0.5, 0.5, 2.0, 2.0,
                                                   -1.0]])

for nm in ("exp", "expm1", "sin", "cos", "tan", "tanh", "sinh", "cosh",
           "atan", "erf", "square", "abs", "neg", "stanh", "sign"):
    case(nm, [x34])
for nm in ("log", "log2", "log10", "log1p", "sqrt", "rsqrt", "reciprocal",
           "digamma", "lgamma"):
    case(nm, [pos34])
for nm in ("asin", "acos"):
    case(nm, [unit34])
case("logit", [np.random.RandomState(5).uniform(0.1, 0.9, (3, 4))])
for nm in ("floor", "ceil", "round", "trunc", "frac"):
    case(nm, [x34 * 3.3], ())
for nm in ("isnan", "isinf", "isfinite"):
    case(nm, [np.array([1.0, np.nan, np.inf, -np.inf, 0.0])], ())
for nm in ("add", "subtract", "multiply", "divide", "maximum", "minimum",
           "fmax", "fmin", "atan2", "hypot"):
    case(nm, [x34, smooth((3, 4), 6)], (0, 1))
case("pow", [pos34], y=2.5)
case("floor_divide", [i34, np.full((3, 4), 3, np.int64)], ())
case("remainder", [i34, np.full((3, 4), 3, np.int64)], ())
case("remainder_float", [x34 * 3, np.full((3, 4), 0.7)], (0,),
     fn="remainder")
case("scale", [x34], scale=2.5, bias=0.5)
case("scale_before", [x34], fn="scale", scale=2.5, bias=0.5,
     bias_after_scale=False)
case("clip", [x34], min=-0.8, max=1.1)
case("add_n", [x34, smooth((3, 4), 7), smooth((3, 4), 8)], (0, 1, 2),
     jax_fn=lambda *a: J.add_n(list(a)), port_fn=lambda *a: T.add_n(list(a)))
case("lerp", [x34, smooth((3, 4), 9)], (0, 1), weight=0.3)

for nm in ("sum", "mean", "max", "min", "prod", "logsumexp", "amax",
           "amin", "nansum", "nanmean"):
    case(f"{nm}_all", [x34], fn=nm)
    case(f"{nm}_axis", [x234], fn=nm, axis=1, keepdim=True)
    case(f"{nm}_axes", [x234], fn=nm, axis=[0, 2])
for nm in ("std", "var"):
    case(nm, [x234], axis=1)
    case(f"{nm}_biased", [x234], fn=nm, axis=[0, 2], unbiased=False,
         keepdim=True)
    case(f"{nm}_all", [x234], fn=nm)
case("median_even", [x34], fn="median", axis=1)
case("median_odd", [x34], fn="median", axis=0, keepdim=True)
case("median_all", [x34], fn="median")
case("quantile", [x234], q=0.3, axis=1)
case("quantile_all", [x34], fn="quantile", q=0.75)
case("cumsum", [x234], axis=1)
case("cumsum_flat", [x234], fn="cumsum")
case("cumprod", [pos34], dim=1)
case("count_nonzero", [i34], (), axis=1)
case("all", [i34 > 0], (), axis=1)
case("any", [i34 > 3], (), axis=0)
case("all_flat", [i34 > -6], (), fn="all")

case("matmul", [x234, smooth((4, 5), 10)], (0, 1))
case("matmul_tt", [smooth((4, 3), 11), smooth((5, 4), 12)], (0, 1),
     fn="matmul", transpose_x=True, transpose_y=True)
case("mm", [x34, smooth((4, 2), 13)], (0, 1))
case("bmm", [x234, smooth((2, 4, 2), 14)], (0, 1))
case("dot", [smooth((5,), 15), smooth((5,), 16)], (0, 1))
case("t", [x34])
case("transpose", [x234], perm=[2, 0, 1])
# the whole-tensor 2-norm sums float32 squares in both packages: float32
# rounding, summed in another order
case("norm_2_all", [x34], fn="norm", tol=dict(rtol=1e-6, atol=1e-7))
case("norm_2_axis", [x234], fn="norm", axis=1, keepdim=True)
case("norm_1", [x234], fn="norm", p=1, axis=2)
case("norm_inf", [x234], fn="norm", p=float("inf"), axis=0)
case("norm_3", [x234], fn="norm", p=3, axis=1)
case("dist", [x34, smooth((3, 4), 17)], (0, 1), p=1)
case("cross", [smooth((4, 3), 18), smooth((4, 3), 19)], (0, 1))
case("matrix_power", [smooth((3, 3), 20) * 0.5], n=3)
case("einsum", [x234, smooth((4, 5), 21)], (0, 1),
     jax_fn=lambda a, b: J.einsum("bij,jk->bik", a, b),
     port_fn=lambda a, b: T.einsum("bij,jk->bik", a, b))
case("tril", [x34], diagonal=1)
case("triu", [x34], diagonal=-1)
case("kron", [smooth((2, 2), 22), smooth((2, 3), 23)], (0, 1))
case("outer", [smooth((3,), 24), smooth((4,), 25)], (0, 1))
case("inner", [x34, smooth((2, 4), 26)], (0, 1))
case("trace", [smooth((4, 4), 27)], offset=1)

case("reshape", [x234], shape=[4, -1])
case("concat", [x34, smooth((3, 2), 28)], (0, 1),
     jax_fn=lambda a, b: J.concat([a, b], axis=1),
     port_fn=lambda a, b: T.concat([a, b], axis=1))
case("split_count", [x234], fn="split", num_or_sections=2, axis=2)
case("split_sections", [x234], fn="split", num_or_sections=[1, -1, 1],
     axis=2)
case("chunk", [x234], chunks=3, axis=1)
case("stack", [x34, smooth((3, 4), 29)], (0, 1),
     jax_fn=lambda a, b: J.stack([a, b], axis=1),
     port_fn=lambda a, b: T.stack([a, b], axis=1))
case("unstack", [x234], axis=1)
case("unbind", [x234], axis=0)
case("squeeze", [smooth((3, 1, 4, 1), 30)], axis=[1, 2])
case("squeeze_all", [smooth((3, 1, 4, 1), 31)], fn="squeeze")
case("unsqueeze", [x34], axis=[0, 2])
case("flatten", [x234], start_axis=1)
case("expand", [smooth((1, 4), 32)], shape=[2, 3, -1])
case("expand_as", [smooth((1, 4), 33), x34], (0,))
case("broadcast_to", [smooth((1, 4), 34)], shape=[3, 4])
case("tile", [x34], repeat_times=[2, 1, 3])
case("slice", [x234], axes=[1, 2], starts=[1, -3], ends=[3, 10])
case("strided_slice", [x234], axes=[2, 1], starts=[0, 2], ends=[4, 0],
     strides=[2, -1])
case("gather", [x234, np.array([2, 0, 2])], (0,), axis=1)
case("gather_2d_index", [x34, np.array([[2, 0], [1, 1]])], (0,),
     fn="gather")
case("gather_nd", [x234, np.array([[0, 1], [1, 2], [0, 1]])], (0,))
case("scatter_overwrite", [x34, np.array([2, 0]), smooth((2, 4), 35)],
     (0, 2), fn="scatter")
case("scatter_add_unique", [x34, np.array([2, 0]), smooth((2, 4), 36)],
     (0, 2), fn="scatter", overwrite=False)
case("scatter_add_duplicates", [x34, np.array([1, 1]), smooth((2, 4), 37)],
     (0, 2), fn="scatter", overwrite=False)
case("scatter_nd_add", [x34, np.array([[1], [1], [2]]), smooth((3, 4), 38)],
     (0, 2))
case("index_select", [x34, np.array([3, 1, 3])], (0,), axis=1)
case("index_sample", [x34, np.array([[0, 3], [2, 2], [1, 0]])], (0,))
case("masked_select", [x34, x34 > 0], (0,))
case("masked_fill", [x34, x34 > 0], (0,), value=-2.5)
case("where", [x34 > 0, x34, smooth((3, 4), 39)], (1, 2))
case("where_nonzero", [i34 > 0], (), fn="where")
case("nonzero", [i34 > 0], ())
case("nonzero_tuple", [i34 > 0], (), fn="nonzero", as_tuple=True)
for mode in ("constant", "reflect", "replicate", "circular"):
    case(f"pad_{mode}", [x34], fn="pad", paddings=[1, 2, 2, 1], mode=mode,
         value=0.5)
case("roll", [x234], shifts=2, axis=2)
case("roll_flat", [x34], fn="roll", shifts=5)
case("flip", [x234], axis=[0, 2])
case("rot90", [x34], k=3)
case("cast", [x34], (), dtype="int32")
case("crop", [x234], shape=[1, 2, 3], offsets=[1, 1, 0])
case("repeat_interleave", [x34], repeats=2, axis=1)
case("moveaxis", [x234], source=0, destination=2)
case("swapaxes", [x234], axis0=0, axis1=2)
case("meshgrid", [smooth((3,), 40), smooth((2,), 41)], (0, 1))
case("atleast_1d", [np.array(2.5)])
case("diff", [x234], n=2, axis=2)
case("take_along_axis", [x34, np.array([[0, 3], [2, 2], [1, 0]])], (0,),
     axis=1)
case("put_along_axis", [x34, np.array([[0, 3], [2, 1], [1, 0]]),
                        smooth((3, 2), 42)], (0, 2), axis=1)
case("diag_vector", [smooth((3,), 43)], fn="diag", offset=1)
case("diag_padded", [smooth((3,), 44)], fn="diag", padding_value=2.0)
case("diag_matrix", [x34], fn="diag", offset=-1)

case("argmax_ties", [ties], (), fn="argmax", axis=1)
case("argmax_flat", [ties], (), fn="argmax")
case("argmin_ties", [ties], (), fn="argmin", axis=1, keepdim=True)
case("topk_ties", [ties], (0,), fn="topk", k=4)
case("topk_smallest_ties", [ties], (0,), fn="topk", k=3, largest=False)
case("topk_axis0", [x34], (0,), fn="topk", k=2, axis=0)
case("argsort_ties", [ties], (), fn="argsort")
case("argsort_ties_desc", [ties], (), fn="argsort", descending=True)
case("sort", [ties], (0,), axis=1)
case("sort_desc", [x34], (0,), fn="sort", axis=0, descending=True)
case("unique", [np.array([[3, 1, 3], [2, 1, 5]])], ())
case("unique_all", [np.array([3.0, 1.0, 3.0, 2.0, 1.0, 5.0])], (),
     fn="unique", return_index=True, return_counts=True)
case("searchsorted", [np.array([1.0, 2.0, 2.0, 5.0]),
                      np.array([2.0, 0.0, 6.0, 3.0])], ())
case("searchsorted_right", [np.array([1.0, 2.0, 2.0, 5.0]),
                            np.array([2.0, 0.0, 6.0, 3.0])], (),
     fn="searchsorted", right=True)
case("histogram", [x34], (), bins=5)
case("histogram_range", [x34], (), fn="histogram", bins=4, min=-1, max=1)
case("bincount", [np.array([0, 2, 2, 5, 1])], (), minlength=7)
case("bincount_weights", [np.array([0, 2, 2, 5, 1]),
                          np.array([0.5, 1.0, 2.0, 1.5, 3.0])], (),
     fn="bincount")
case("mode", [np.array([[2.0, 1.0, 2.0, 1.0, 3.0], [4.0, 4.0, 0.0, 0.0,
                                                   0.0]])], (), axis=1)
case("kthvalue", [ties], (), k=2, axis=1)

for nm in ("equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal", "logical_and", "logical_or", "logical_xor"):
    case(nm, [i34 > 0, i34 > -2] if nm.startswith("logical") else
         [i34, np.full((3, 4), 1, np.int64)], ())
case("equal_all", [i34, i34.copy()], ())
case("allclose", [x34, x34 + 1e-9], ())
case("isclose", [x34, x34 + 1e-3 * (i34 > 0)], ())
case("logical_not", [i34 > 0], ())
for nm in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    case(nm, [i34, np.full((3, 4), 6, np.int64)], ())
case("bitwise_not", [i34], ())
case("numel", [x234], ())
case("rank", [x234], ())
case("shape", [x234], ())
case("one_hot", [np.array([[1, 0], [3, 2]])], (), num_classes=4)
case("multiplex", [x34, smooth((3, 4), 45), np.array([[1], [0], [1]])],
     (0, 1), jax_fn=lambda a, b, i: J.multiplex([a, b], i),
     port_fn=lambda a, b, i: T.multiplex([a, b], i))


@pytest.mark.parametrize("jax_fn,port_fn,args,wrt,tol", C)
def test_tensor_function_matches_jax(jax_fn, port_fn, args, wrt, tol):
    pv, jv = compare(jax_fn, port_fn, args, wrt, **tol)
    for a, b in zip(pv, jv):
        if np.asarray(b).dtype.kind in "iu":
            assert a.dtype == np.asarray(b).dtype, (a.dtype, b.dtype)


def _cpu(fn, *a, **kw):
    return fn(*a, device="cpu", **kw)


@pytest.mark.parametrize("name,args", [
    ("zeros", ([2, 3],)), ("ones", ([2, 3], "int64")),
    ("full", ([2, 2], 1.5)), ("linspace", (0, 1, 5)), ("eye", (3, 4)), ("empty", ([2],))])
def test_creation_matches_jax(name, args):
    want = getattr(J, name)(*args).numpy()
    got = _cpu(getattr(T, name), *args).numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=1e-7)


@pytest.mark.parametrize("args,dtype", [
    ((2, 11, 3), torch.int64), ((5,), torch.int64), ((-3, 4), torch.int64),
    ((0.5, 3.0, 0.5), torch.float32)])
def test_arange_dtypes(args, dtype):
    """The JAX package's `arange` fails in this JAX version (it hands a
    numpy dtype class to jnp.arange), so the port is held to numpy's
    arange and to the dtype the JAX package asks for: int64 for ints,
    the default float type otherwise."""
    got = T.arange(*args, device="cpu")
    assert got.dtype == dtype
    np.testing.assert_allclose(got.numpy(), np.arange(*args), rtol=1e-7)


def test_like_functions_and_to_tensor():
    x = T.to_tensor(np.arange(6.0).reshape(2, 3), device="cpu")
    assert x.dtype == torch.float64             # a numpy array keeps it
    assert T.to_tensor([1.0, 2.0], device="cpu").dtype == torch.float32
    assert T.to_tensor([1, 2], device="cpu").dtype == torch.int64
    for fn in ("zeros_like", "ones_like", "empty_like"):
        np.testing.assert_array_equal(getattr(T, fn)(x).numpy(),
                                      getattr(J, fn)(J.to_tensor(
                                          x.numpy())).numpy())
    np.testing.assert_array_equal(T.full_like(x, 2.0).numpy(),
                                  J.full_like(J.to_tensor(x.numpy()),
                                              2.0).numpy())
    y = T.zeros([2, 3], "float64", device="cpu")
    T.assign(x, y)
    assert torch.equal(x, y)
    assert T.increment(T.to_tensor([1.0], device="cpu"), 2.0).item() == 3.0
    leaf = T.to_tensor([1.0, 2.0], stop_gradient=False, device="cpu")
    assert leaf.requires_grad and leaf.is_leaf


def test_median_even_is_the_midpoint_not_torchs_lower_value():
    x = torch.tensor([4.0, 1.0, 3.0, 2.0], dtype=torch.float64)
    assert float(T.median(x)) == 2.5 and float(torch.median(x)) == 2.0


def test_split_takes_sections_not_chunk_sizes():
    x = torch.arange(10.0)
    assert [p.numel() for p in T.split(x, [2, -1, 3])] == [2, 5, 3]
    assert [p.numel() for p in T.split(x, 5)] == [2] * 5
    assert [p.numel() for p in torch.split(x, 5)] == [5, 5]
    with pytest.raises(ValueError):
        T.split(x, 3)


def test_topk_ties_come_lower_index_first():
    v, i = T.topk(torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0]), 3)
    assert i.tolist() == [1, 2, 4] and i.dtype == torch.int64


def test_no_method_patching():
    """The JAX package attaches its functions to its Tensor class; the
    port leaves torch.Tensor alone."""
    assert T.topk is not getattr(torch.Tensor, "topk", None)
    assert not hasattr(torch.Tensor, "index_sample")
    assert not hasattr(torch.Tensor, "scatter_nd_add")


def test_random_functions_take_a_generator():
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return [T.rand([50, 40], generator=g, device="cpu"),
                T.randn([200, 100], generator=g, device="cpu"),
                T.uniform([50, 40], min=-2.0, max=3.0, generator=g,
                          device="cpu"),
                T.normal(1.0, 2.0, [200, 100], generator=g, device="cpu"),
                T.randint(3, 9, [50, 40], generator=g, device="cpu"),
                T.randperm(20, generator=g, device="cpu")]

    a, b = draw(0), draw(0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], draw(1)[0])
    rnd, rn, uni, nor, ri, perm = a
    assert rnd.dtype == torch.float32 and 0 <= rnd.min() and rnd.max() < 1
    assert abs(float(rn.mean())) < 0.03 and abs(float(rn.std()) - 1) < 0.03
    assert -2 <= uni.min() and uni.max() < 3
    assert abs(float(nor.mean()) - 1) < 0.06
    assert abs(float(nor.std()) - 2) < 0.06
    assert ri.dtype == torch.int64 and ri.min() >= 3 and ri.max() < 9
    assert sorted(perm.tolist()) == list(range(20))
    g = torch.Generator().manual_seed(2)
    p = torch.full((100, 100), 0.3, dtype=torch.float64)
    bern = T.bernoulli(p, generator=g)
    assert bern.dtype == torch.float64
    assert abs(float(bern.mean()) - 0.3) < 0.02
    probs = torch.tensor([[0.0, 1.0, 3.0], [1.0, 0.0, 0.0]])
    draws = T.multinomial(probs, 200, replacement=True, generator=g)
    assert draws.dtype == torch.int64 and draws.shape == (2, 200)
    assert set(draws[0].tolist()) <= {1, 2} and set(draws[1].tolist()) == {0}
    assert set(T.multinomial(probs[:1], 2, generator=g)[0].tolist()) == {1,
                                                                         2}


def test_creation_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.zeros([2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.rand([2])


def test_every_jax_tensor_function_is_ported():
    import inspect

    from paddle_tpu.tensor import ops as jops

    jax_names = {n for n, v in vars(jops).items()
                 if inspect.isfunction(v) and not n.startswith("_")
                 and v.__module__ == jops.__name__}
    missing = sorted(jax_names - set(T.tensor.__all__))
    assert missing == [], missing


def test_helpers_agree_on_a_gradient_of_two_outputs():
    """run_jax / run_port sum <output, cotangent> over every float
    output: split's gradient sees both parts."""
    x = smooth((2, 4), 50)
    _, jg = run_jax(lambda a: J.split(a, 2, axis=1), [x], (0,))
    _, pg = run_port(lambda a: T.split(a, 2, axis=1), [x], (0,))
    np.testing.assert_allclose(pg[0], jg[0], rtol=1e-12)
    assert np.all(pg[0] != 0)
