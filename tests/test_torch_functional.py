"""The port's `nn.functional` against the JAX package's, on the CPU.

Every function of the port's `nn.functional` that the JAX package also
has runs on the same float64 inputs (numpy, seeded) in both packages;
the outputs, and for the differentiable ones the gradients of <outputs,
a fixed random cotangent> with respect to the float inputs, must agree
within rtol 1e-9 / atol 1e-12 (the same float64 math, summed in another
order or through another libm). Integer outputs must be equal. The
random functions (dropout, alpha dropout, Gumbel softmax) are held to
their statistics instead: only JAX's PRNG gives JAX's samples.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn.functional as TF
from _torch_parity import compare, smooth

torch.set_num_threads(2)

C = []


def case(name, fn, args, wrt=(0,), jax_fn=None, port_fn=None, **tol):
    """`fn` names the function in both packages, called with `args` and
    the keyword arguments in `tol` that are not tolerances."""
    kw = {k: v for k, v in tol.items() if k not in ("rtol", "atol")}
    tol = {k: v for k, v in tol.items() if k in ("rtol", "atol")}
    jf = jax_fn or (lambda *a: getattr(JF, fn)(*a, **kw))
    pf = port_fn or (lambda *a: getattr(TF, fn)(*a, **kw))
    C.append(pytest.param(jf, pf, args, wrt, tol, id=name))


x34 = smooth((3, 4), 0)
x234 = smooth((2, 3, 4), 1)
x2344 = smooth((2, 3, 4, 4), 2)
lbl01 = (np.arange(12).reshape(3, 4) % 2).astype(np.float64)

for nm in ("relu", "relu6", "sigmoid", "tanh", "silu", "swish", "selu",
           "hardswish", "softsign", "mish", "log_sigmoid", "tanhshrink"):
    case(nm, nm, [x34])
case("relu6_kinks", "relu6", [x34 * 4.0])
case("gelu", "gelu", [x34])
case("gelu_tanh", "gelu", [x34], approximate=True)
case("leaky_relu", "leaky_relu", [x34], negative_slope=0.05)
case("elu", "elu", [x34], alpha=0.7)
case("hardsigmoid", "hardsigmoid", [x34 * 4.0])
case("hardtanh", "hardtanh", [x34], min=-0.7, max=0.9)
case("hardshrink", "hardshrink", [x34], threshold=0.6)
case("softshrink", "softshrink", [x34], threshold=0.6)
case("softplus", "softplus", [x34 * 8.0], beta=2.0, threshold=10.0)
case("maxout", "maxout", [smooth((2, 4, 3), 3)], groups=2)
case("softmax", "softmax", [x234], axis=1)
case("log_softmax", "log_softmax", [x234], axis=-1)
case("prelu_shared", "prelu", [x234, np.array([0.3])], (0, 1))
case("prelu_channels", "prelu", [x234, np.array([0.1, 0.2, 0.3])], (0, 1))
case("linear", "linear", [x234, smooth((4, 5), 4), smooth((5,), 5)],
     (0, 1, 2))
case("conv1d", "conv1d", [smooth((2, 3, 9), 6), smooth((4, 3, 3), 7),
                          smooth((4,), 8)], (0, 1, 2), stride=2,
     padding="VALID")
case("conv1d_same_groups", "conv1d",
     [smooth((1, 4, 7), 9), smooth((4, 2, 3), 10)], (0, 1),
     jax_fn=lambda x, w: JF.conv1d(x, w, None, 1, "SAME", 1, 2),
     port_fn=lambda x, w: TF.conv1d(x, w, None, 1, "SAME", 1, 2))
case("layer_norm", "layer_norm",
     [x234, smooth((3, 4), 11), smooth((3, 4), 12)], (0, 1, 2),
     jax_fn=lambda x, w, b: JF.layer_norm(x, [3, 4], w, b),
     port_fn=lambda x, w, b: TF.layer_norm(x, [3, 4], w, b))
case("layer_norm_plain", "layer_norm", [x234], normalized_shape=4)
case("group_norm", "group_norm",
     [smooth((2, 4, 3, 3), 13), smooth((4,), 14), smooth((4,), 15)],
     (0, 1, 2), jax_fn=lambda x, w, b: JF.group_norm(x, 2, w, b),
     port_fn=lambda x, w, b: TF.group_norm(x, 2, w, b))
case("instance_norm", "instance_norm",
     [x2344, smooth((3,), 16), smooth((3,), 17)], (0, 1, 2),
     jax_fn=lambda x, w, b: JF.instance_norm(x, weight=w, bias=b),
     port_fn=lambda x, w, b: TF.instance_norm(x, weight=w, bias=b))
case("normalize", "normalize", [x234], p=2, axis=1)
case("normalize_l1", "normalize", [x234], p=1, axis=-1)
case("local_response_norm", "local_response_norm",
     [smooth((2, 5, 3, 3), 18)], size=3)
case("cosine_similarity", "cosine_similarity",
     [x234, smooth((2, 3, 4), 19)], (0, 1), axis=1)

for red in ("mean", "sum", "none"):
    case(f"l1_loss_{red}", "l1_loss", [x34, smooth((3, 4), 20) * 2], (0,),
         reduction=red)
    case(f"mse_loss_{red}", "mse_loss", [x34, smooth((3, 4), 21)], (0, 1),
         reduction=red)
    case(f"smooth_l1_loss_{red}", "smooth_l1_loss",
         [x34, smooth((3, 4), 22) * 3], (0,), reduction=red, delta=1.5)
    case(f"bce_{red}", "binary_cross_entropy",
         [np.random.RandomState(23).uniform(0.2, 0.8, (3, 4)), lbl01], (0,),
         reduction=red)
    case(f"kl_div_{red}", "kl_div",
         [np.log(np.random.RandomState(24).dirichlet(np.ones(4), 3)),
          np.random.RandomState(25).dirichlet(np.ones(4), 3)], (0,),
         reduction=red)
    case(f"margin_ranking_{red}", "margin_ranking_loss",
         [x34, smooth((3, 4), 26), np.sign(smooth((3, 4), 27))], (0, 1),
         margin=0.1, reduction=red)
    case(f"hinge_embedding_{red}", "hinge_embedding_loss",
         [x34, np.sign(smooth((3, 4), 28))], (0,), reduction=red)
case("kl_div_batchmean", "kl_div",
     [np.log(np.random.RandomState(24).dirichlet(np.ones(4), 3)),
      np.random.RandomState(25).dirichlet(np.ones(4), 3)], (0,),
     reduction="batchmean")
case("bce_weighted", "binary_cross_entropy",
     [np.random.RandomState(29).uniform(0.2, 0.8, (3, 4)), lbl01,
      smooth((3, 4), 30)], (0,))
case("bce_with_logits", "binary_cross_entropy_with_logits", [x34, lbl01],
     (0,))
case("bce_with_logits_weights", "binary_cross_entropy_with_logits",
     [x34, lbl01, smooth((4,), 31), np.abs(smooth((4,), 32))], (0,),
     jax_fn=lambda a, b, w, pw: JF.binary_cross_entropy_with_logits(
         a, b, w, "sum", pw),
     port_fn=lambda a, b, w, pw: TF.binary_cross_entropy_with_logits(
         a, b, w, "sum", pw))
case("nll_loss", "nll_loss",
     [np.log(np.random.RandomState(33).dirichlet(np.ones(4), 5)),
      np.array([1, 0, 3, 2, 1])], (0,))
case("nll_loss_weight_sum", "nll_loss",
     [np.log(np.random.RandomState(34).dirichlet(np.ones(4), 5)),
      np.array([1, 0, 3, 2, 1]), np.array([0.5, 1.0, 2.0, 1.5])], (0,),
     reduction="sum")
case("square_error_cost", "square_error_cost",
     [x34, smooth((3, 4), 35)], (0, 1))
case("log_loss", "log_loss",
     [np.random.RandomState(36).uniform(0.1, 0.9, (3, 4)), lbl01], (0,))
case("sigmoid_focal_loss", "sigmoid_focal_loss", [x34, lbl01], (0,))
case("sigmoid_focal_loss_norm", "sigmoid_focal_loss",
     [x34, lbl01, np.array([3.0])], (0,), reduction="mean")
case("label_smooth", "label_smooth",
     [np.eye(4)[[0, 2, 1]].astype(np.float64)], (0,), epsilon=0.2)
case("label_smooth_prior", "label_smooth",
     [np.eye(4)[[0, 2, 1]].astype(np.float64),
      np.array([0.1, 0.2, 0.3, 0.4])], (0, 1),
     jax_fn=lambda a, p: JF.label_smooth(a, p, 0.2),
     port_fn=lambda a, p: TF.label_smooth(a, p, 0.2))
case("npair_loss", "npair_loss",
     [smooth((4, 5), 37), smooth((4, 5), 38), np.array([0, 1, 0, 2])],
     (0, 1))
case("cross_entropy", "cross_entropy", [x34, np.array([1, 0, 3])], (0,))
case("cross_entropy_soft_sum", "cross_entropy",
     [x34, np.random.RandomState(39).dirichlet(np.ones(4), 3)], (0,),
     soft_label=True, reduction="sum")
case("softmax_with_cross_entropy", "softmax_with_cross_entropy",
     [x34, np.array([[1], [0], [3]])], (0,))

case("embedding", "embedding",
     [np.array([[0, 2, 1], [3, 1, 1]]), smooth((4, 3), 40)], (1,))
case("embedding_padding_idx", "embedding",
     [np.array([[0, 2, 1], [3, 1, 1]]), smooth((4, 3), 41)], (1,),
     padding_idx=1)
case("one_hot", "one_hot", [np.array([[0, 2], [4, 1]])], (), num_classes=5)
case("dropout_downscale_eval", "dropout", [x34], p=0.3, training=False,
     mode="downscale_in_infer")

x_img = smooth((1, 2, 4, 5), 42)
case("interp_nearest", "interpolate", [x_img], size=[7, 3])
case("interp_nearest_scale", "interpolate", [x_img], scale_factor=2)
for ac in (False, True):
    for am in (0, 1):
        case(f"interp_bilinear_ac{int(ac)}_am{am}", "interpolate", [x_img],
             size=[6, 8], mode="bilinear", align_corners=ac, align_mode=am)
    case(f"interp_linear_1d_ac{int(ac)}", "interpolate",
         [smooth((2, 3, 5), 43)], size=[8], mode="linear",
         align_corners=ac)
    case(f"interp_trilinear_ac{int(ac)}", "interpolate",
         [smooth((1, 2, 3, 4, 5), 44)], size=[5, 3, 7], mode="trilinear",
         align_corners=ac)
    case(f"interp_bicubic_ac{int(ac)}", "interpolate", [x_img],
         size=[7, 9], mode="bicubic", align_corners=ac)
case("interp_linear_am1", "interpolate", [smooth((1, 2, 3, 4, 5), 45)],
     size=[5, 6, 2], mode="trilinear", align_mode=1)
case("upsample", "upsample", [x_img], scale_factor=2, mode="bilinear")
case("pixel_shuffle", "pixel_shuffle", [smooth((2, 8, 3, 3), 46)],
     upscale_factor=2)
case("unfold", "unfold", [smooth((2, 3, 5, 6), 47)], kernel_sizes=[2, 3],
     strides=[1, 2], paddings=1)
for ac in (False, True):
    case(f"grid_sample_ac{int(ac)}", "grid_sample",
         [x_img, np.random.RandomState(48).uniform(-1.1, 1.1, (1, 3, 4, 2))],
         (0, 1), align_corners=ac)
    case(f"affine_grid_ac{int(ac)}", "affine_grid", [smooth((2, 2, 3), 49)],
         out_shape=[2, 1, 3, 4], align_corners=ac)
for mode in ("constant", "reflect", "replicate", "circular"):
    case(f"pad_{mode}", "pad", [x2344], pad=[1, 2, 2, 1], mode=mode,
         value=0.5)
case("pad_all_axes", "pad", [x34], pad=[1, 0, 2, 1], mode="constant")
case("temporal_shift", "temporal_shift", [smooth((4, 8, 2, 2), 50)],
     seg_num=2, shift_ratio=0.25)


@pytest.mark.parametrize("jax_fn,port_fn,args,wrt,tol", C)
def test_functional_matches_jax(jax_fn, port_fn, args, wrt, tol):
    compare(jax_fn, port_fn, args, wrt, **tol)


def test_conv1d_int_padding_matches_torch():
    """The JAX `conv1d` raises on an int padding (it hands a list of
    pairs to a rule that takes ints), so the port's int padding is held
    to torch's own conv1d, in float64."""
    x, w, b = (torch.from_numpy(smooth(s, i)) for i, s in
               enumerate(((2, 3, 9), (4, 3, 3), (4,))))
    for stride, pad, dil in ((1, 1, 1), (2, 2, 1), (1, 2, 2)):
        want = torch.nn.functional.conv1d(x, w, b, stride, pad, dil)
        got = TF.conv1d(x, w, b, stride, pad, dil)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_dropout_statistics_and_modes():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200, 500, dtype=torch.float64)
    y = TF.dropout(x, 0.3, True, g)
    kept = y != 0
    assert abs(float(kept.double().mean()) - 0.7) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    y = TF.dropout(x, 0.3, True, g, mode="downscale_in_infer")
    assert set(torch.unique(y).tolist()) <= {0.0, 1.0}
    y = TF.dropout(x, 0.5, True, g, axis=0)           # whole rows
    rows = (y != 0).all(1) | (y == 0).all(1)
    assert bool(rows.all())
    y = TF.dropout2d(torch.ones(8, 16, 3, 3, dtype=torch.float64), 0.5,
                     True, generator=g)
    per_channel = y.reshape(8, 16, 9)
    assert bool(((per_channel != 0).all(-1) | (per_channel == 0).all(
        -1)).all())
    assert torch.equal(TF.dropout(x, 0.3, False), x)


def test_alpha_dropout_keeps_selu_statistics():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(400, 1000, generator=g, dtype=torch.float64)
    y = TF.alpha_dropout(x, 0.2, True, g)
    assert abs(float(y.mean())) < 0.02 and abs(float(y.std()) - 1) < 0.02
    assert torch.equal(TF.alpha_dropout(x, 0.2, False), x)


def test_gumbel_softmax_soft_and_hard():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(64, 5, dtype=torch.float64, requires_grad=True)
    y = TF.gumbel_softmax(x, 0.5, generator=g)
    assert torch.allclose(y.sum(-1), torch.ones(64, dtype=torch.float64))
    h = TF.gumbel_softmax(x, 0.5, hard=True, generator=g)
    # the straight-through sum one-hot + y - y is one-hot up to rounding
    hot = torch.nn.functional.one_hot(h.detach().argmax(-1), 5).double()
    torch.testing.assert_close(h.detach(), hot, rtol=0, atol=1e-15)
    (h * torch.arange(5.0, dtype=torch.float64)).sum().backward()
    assert x.grad is not None and float(x.grad.abs().sum()) > 0


def test_sparse_embedding_and_other_modes_raise():
    """`embedding(sparse=True)` (ROADMAP item 7, done) gives the leaf
    weight a row-sparse gradient equal to the dense one; the modes the
    port does not compute still raise."""
    w = torch.randn(4, 3, requires_grad=True)
    TF.embedding(torch.tensor([1, 2, 1]), w, sparse=True).sum().backward()
    assert w.grad.layout == torch.sparse_coo and w.grad._nnz() == 3
    wd = w.detach().clone().requires_grad_(True)
    TF.embedding(torch.tensor([1, 2, 1]), wd).sum().backward()
    assert torch.equal(w.grad.to_dense(), wd.grad)
    with pytest.raises(NotImplementedError):
        TF.grid_sample(torch.randn(1, 1, 3, 3), torch.zeros(1, 2, 2, 2),
                       mode="nearest")


def test_every_jax_functional_is_ported_or_listed():
    """The names of the JAX `nn.functional` the port leaves out are
    exactly the ones ROADMAP.md lists with the item that takes them."""
    import inspect

    jax_names = {n for n, v in vars(JF).items()
                 if inspect.isfunction(v) and not n.startswith("_")
                 and v.__module__ == JF.__name__}
    missing = sorted(jax_names - set(TF.__all__))
    assert missing == [], missing
