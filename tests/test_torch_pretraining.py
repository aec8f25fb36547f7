"""The port's ERNIE pretraining path against the JAX package's, on the
CPU: `ErnieForPretraining`, and `SpmdTrainer` with an eager optimizer
(`from_eager`), `grad_accum`, `remat` and `run_epoch`.

A tiny `ErnieForPretraining` (2 layers, hidden 64, 4 heads) is built in
JAX and loaded into the port's model through `convert.from_jax_state`.
The batch is random ids with 15% of the positions masked for the masked
LM and random next-sentence labels, packed into one label array
([b, s + 1]: the masked-LM targets, -1 where unmasked, then the NSP
label), all from a numpy seed. The loss is the masked-position
cross-entropy plus the NSP cross-entropy.

Limits, float32: logits and loss rtol / atol 2e-5, every gradient 5e-5
(`tests/test_torch_training.py`'s: the same math with reordered float32
sums); the trainer against the JAX trainer 3 steps of the ERNIE recipe
(AdamW under linear warmup and polynomial decay, a global-norm clip, no
decay on biases and norms, epsilon 1e-4 as `tests/test_torch_ernie.py`
argues): every loss rtol 2e-5, every parameter atol 2e-5, while the
steps move the parameters by ~1e-3; grad_accum=4 against grad_accum=1
rtol 2e-4 / atol 1e-5 (the JAX package's own limit for the same check,
`tests/test_parallel.py`). remat and run_epoch are held bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import paddle_tpu as paddle
from paddle_tpu.parallel import SpmdTrainer as JaxTrainer
from paddle_tpu.parallel import functionalize, init_mesh
from paddle_tpu.parallel import mesh as jax_mesh
from paddle_tpu.text import ErnieConfig as JaxConfig
from paddle_tpu.text import ErnieForPretraining as JaxPretraining
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.parallel import SpmdTrainer
from paddle_tpu_torch.text import ErnieConfig, ErnieForPretraining

torch.set_num_threads(2)
NO_DROPOUT = dict(hidden_dropout=0.0, attn_dropout=0.0)
VOCAB = 1024


def batch(b=4, s=32, seed=0):
    """(ids, token types, attention mask), labels [b, s + 1]."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, VOCAB, (b, s)).astype(np.int64)
    tt = np.zeros((b, s), np.int64)
    tt[:, s // 2:] = 1
    mask = np.ones((b, s), np.float32)
    mask[1, s * 3 // 4:] = 0.0
    # 15% of each row's valid positions, the same count in every row (so
    # the masked-position mean of a batch is the mean of its rows' means)
    masked = np.zeros((b, s), bool)
    valid = int(mask.sum(1).min())
    for row in range(b):
        masked[row, rs.choice(valid, max(1, int(0.15 * valid)),
                              replace=False)] = True
    labels = np.full((b, s + 1), -1, np.int64)
    labels[:, :s][masked] = ids[masked]
    ids[masked] = 3                          # the [MASK] id
    labels[:, s] = rs.randint(0, 2, b)
    return (ids, tt, mask), labels


def port_loss(outs, labels):
    mlm, nsp = outs
    tgt = labels[:, :-1]
    mlm_loss = torch.nn.functional.cross_entropy(
        mlm.float().reshape(-1, mlm.shape[-1]), tgt.reshape(-1),
        ignore_index=-1)
    return mlm_loss + torch.nn.functional.cross_entropy(nsp.float(),
                                                        labels[:, -1])


def jax_loss(outs, labels):
    mlm, nsp = outs
    tgt = labels[:, :-1]
    lp = jax.nn.log_softmax(mlm.astype(jnp.float32), -1)
    hit = jnp.take_along_axis(lp, jnp.maximum(tgt, 0)[..., None], -1)[..., 0]
    sel = (tgt >= 0).astype(jnp.float32)
    mlm_loss = -(hit * sel).sum() / sel.sum()
    nlp = jax.nn.log_softmax(nsp.astype(jnp.float32), -1)
    nsp_loss = -jnp.take_along_axis(nlp, labels[:, -1:], -1).mean()
    return mlm_loss + nsp_loss


def jax_model(seed=0, **kw):
    paddle.seed(seed)
    return JaxPretraining(JaxConfig.tiny(**kw))


def np_state(layer):
    return {k: np.asarray(v) for k, v in layer.state_dict().items()}


def port_model(state=None, seed=0, **kw):
    model = ErnieForPretraining(ErnieConfig.tiny(**kw), device="cpu",
                                generator=torch.Generator().manual_seed(seed))
    if state is not None:
        model.load_state_dict(convert.from_jax_state(state), strict=True)
    return model


def no_decay(name):
    """The ERNIE recipe: no decay on biases and norms. The JAX rule
    passes a key path ("['ernie.pooler.bias']"), the port's the name."""
    name = name.strip("[]'")
    return not (name.endswith("bias") or "norm" in name)


def recipe(O, lr_steps=20):
    """The ERNIE / BERT pretraining optimizer in the package `O`."""
    sched = O.lr.LinearWarmup(O.lr.PolynomialDecay(1e-3, lr_steps, 0.0), 2,
                              0.0, 1e-3)
    clip = (tnn if O is topt else paddle.nn).ClipGradByGlobalNorm(1.0)
    return O.AdamW(sched, epsilon=1e-4, weight_decay=0.01, grad_clip=clip,
                   apply_decay_param_fun=no_decay)


def test_from_jax_state_loads_pretraining_and_ties_the_decoder():
    sd = np_state(jax_model())
    model = port_model()
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(convert.from_jax_state(sd), strict=True)
    assert not any("decoder" in n for n in sd)   # no weight of its own


def test_pretraining_logits_and_every_gradient_match_jax():
    jm = jax_model(**NO_DROPOUT)
    model = port_model(np_state(jm), **NO_DROPOUT)
    (ids, tt, mask), labels = batch()
    fm = functionalize(jm)

    def jloss(params):
        out, _ = fm.apply(params, fm.buffers(), None, jnp.asarray(ids),
                          jnp.asarray(tt), jnp.asarray(mask), training=True)
        return jax_loss(out, jnp.asarray(labels)), out

    (j_loss, (j_mlm, j_nsp)), j_grads = jax.value_and_grad(
        jloss, has_aux=True)(fm.params())
    mlm, nsp = model.train()(torch.from_numpy(ids), torch.from_numpy(tt),
                             torch.from_numpy(mask))
    loss = port_loss((mlm, nsp), torch.from_numpy(labels))
    loss.backward()
    assert mlm.shape == (4, 32, VOCAB) and nsp.shape == (4, 2)
    for got, want in ((mlm, j_mlm), (nsp, j_nsp), (loss, j_loss)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    assert set(dict(model.named_parameters())) == set(j_grads)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_grads[n]),
                                   rtol=5e-5, atol=5e-5, err_msg=n)


@pytest.fixture
def single_device_mesh():
    saved = jax_mesh._current[0]
    yield init_mesh(dp=1, devices=jax.devices("cpu")[:1])
    jax_mesh._current[0] = saved


@pytest.mark.parametrize("accum", [1, 4])
def test_trainer_with_the_eager_recipe_matches_jax(single_device_mesh,
                                                   accum):
    jm = jax_model(1, **NO_DROPOUT)
    model = port_model(np_state(jm), **NO_DROPOUT)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    inputs, labels = batch(seed=1)
    j_tr = JaxTrainer(jm, jax_loss, recipe(paddle.optimizer),
                      mesh=single_device_mesh, grad_accum=accum)
    tr = SpmdTrainer(model, port_loss, recipe(topt), device="cpu",
                     grad_accum=accum)
    for step in range(3):
        j_loss = float(j_tr.step(inputs, labels))
        loss = float(tr.step(inputs, labels))
        np.testing.assert_allclose(loss, j_loss, rtol=2e-5,
                                   err_msg=f"step {step}")
    moved = 0
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(j_tr.params[n]), rtol=0,
                                   atol=2e-5, err_msg=n)
        moved += float((p.detach() - start[n]).abs().max()) > 1e-4
    assert moved >= len(start) // 2      # the check is not vacuous


def test_grad_accum_equals_the_whole_batch():
    inputs, labels = batch(b=8, seed=2)
    out = []
    for accum in (1, 4):
        model = port_model(**NO_DROPOUT)
        tr = SpmdTrainer(model, port_loss, recipe(topt), device="cpu",
                         grad_accum=accum)
        losses = [float(tr.step(inputs, labels)) for _ in range(3)]
        out.append((losses, {n: p.detach().clone()
                             for n, p in model.named_parameters()}))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=2e-4, atol=1e-5)
    for n, p in out[0][1].items():
        np.testing.assert_allclose(out[1][1][n].numpy(), p.numpy(),
                                   rtol=2e-4, atol=1e-5, err_msg=n)
    with pytest.raises(ValueError, match="grad_accum"):
        SpmdTrainer(port_model(), port_loss, recipe(topt), device="cpu",
                    grad_accum=3).step(inputs, labels)


def _grads_and_state(remat, manual=False):
    """Gradients of two batches at dropout 0.1 (attention and hidden),
    and the trainer's generator states after them."""
    model = port_model(seed=4)
    tr = SpmdTrainer(model, port_loss, recipe(topt), device="cpu",
                     generator=torch.Generator().manual_seed(9),
                     remat=remat)
    if manual:      # checkpoint alone: torch's default generators only
        tr._apply = lambda xs: checkpoint(lambda *a: tr._apply_plain(a), *xs,
                                          use_reentrant=False)
    out = []
    for seed in (5, 6):
        inputs, labels = batch(seed=seed)
        out.append(tr.loss_and_grads(inputs, labels))
    return out, (tr.generator.get_state(), tr._mask_gen.get_state())


def test_remat_gives_the_same_gradients_bit_for_bit_with_dropout():
    """remat=True replays the forward's attention seeds and dropout
    masks in the recompute: losses and gradients equal remat=False's
    bit for bit, and the generators end where they would without remat.
    `checkpoint` alone (torch restores only its default generators)
    draws new seeds and masks in the recompute and gets other
    gradients."""
    plain, plain_gens = _grads_and_state(False)
    remat, remat_gens = _grads_and_state(True)
    naive, _ = _grads_and_state(True, manual=True)
    for (l0, g0), (l1, g1), (l2, g2) in zip(plain, remat, naive):
        assert torch.equal(l0, l1)
        for n in g0:
            assert torch.equal(g0[n], g1[n]), n
        assert any(not torch.equal(g0[n], g2[n]) for n in g0)
    # the same first forward; its recompute moved the naive generators
    assert torch.equal(plain[0][0], naive[0][0])
    assert not torch.equal(plain[1][0], naive[1][0])
    for a, b in zip(plain_gens, remat_gens):
        assert torch.equal(a, b)


def test_remat_steps_match_plain_steps():
    params = []
    for remat in (False, True):
        model = port_model(seed=7)
        tr = SpmdTrainer(model, port_loss, recipe(topt), device="cpu",
                         generator=torch.Generator().manual_seed(1),
                         remat=remat, grad_accum=2)
        inputs, labels = batch(seed=8)
        losses = [tr.step(inputs, labels) for _ in range(2)]
        params.append((losses, [p.detach().clone()
                                for p in model.parameters()]))
    (la, pa), (lb, pb) = params
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


def test_run_epoch_equals_a_loop_of_step():
    batches = [batch(seed=20 + i) for i in range(5)]
    runs = []
    for epoch in (True, False):
        model = port_model(seed=3)
        tr = SpmdTrainer(model, port_loss, recipe(topt), device="cpu",
                         generator=torch.Generator().manual_seed(2))
        if epoch:
            last = tr.run_epoch(iter(batches), chunk=2)
        else:
            for inputs, labels in batches:
                last = tr.step(inputs, labels)
        runs.append((last, [p.detach().clone() for p in model.parameters()]))
        assert tr.sync_to_layer() is None
    (la, pa), (lb, pb) = runs
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert SpmdTrainer(port_model(), port_loss, recipe(topt),
                       device="cpu").run_epoch([]) is None
