"""append_backward: static-graph autodiff.

Reference parity: fluid/backward.py:1215 append_backward (Python-side grad-op
construction over OpDesc via the C++ GradOpMaker registry). As in the JAX
package, backward is ONE op marking (loss, params, forward-op range); its
type stays "jax_autodiff", the name saved programs carry on the wire. Its
lowering re-runs the pruned forward slice under torch autograd and calls
`torch.autograd.grad` (fluid/lowering.py). Grad variables (`param@GRAD`)
still appear in the program, so optimizer ops, grad clipping and user
introspection keep their reference semantics.
"""
from __future__ import annotations

from .framework import Parameter, Variable, default_main_program, \
    grad_var_name, unique_name


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Returns [(param, grad_var)] like the reference."""
    program = loss.block.program
    block = program.global_block()

    if parameter_list:
        params = []
        for p in parameter_list:
            if isinstance(p, str):
                params.append(block.var(p))
            else:
                params.append(p)
    else:
        params = [v for v in block.vars.values()
                  if isinstance(v, Parameter) and v.trainable]
    if no_grad_set:
        ng = {n if isinstance(n, str) else n.name for n in no_grad_set}
        params = [p for p in params if p.name not in ng]

    fwd_op_count = len(block.ops)
    param_names = [p.name for p in params]

    grads = []
    for p in params:
        g = block.create_var(name=grad_var_name(p.name), shape=p.shape,
                             dtype=p.dtype, stop_gradient=True)
        grads.append(g)
    loss_grad = block.create_var(name=grad_var_name(loss.name),
                                 shape=loss.shape, dtype=loss.dtype,
                                 stop_gradient=True)

    # params fed to lookup_table ops marked is_sparse get SelectedRows-
    # style (rows, values) gradients: the autodiff lowering diffs w.r.t.
    # the GATHERED rows only, never materializing a [vocab, dim] gradient
    # (lookup_table_op.cc grad with is_sparse=True; SURVEY §7 hard part 3)
    sparse_names = []
    for fop in block.ops[:fwd_op_count]:
        if fop.type in ("lookup_table", "lookup_table_v2") and \
                fop.attrs.get("is_sparse"):
            for w in fop.input("W"):
                if w in param_names and w not in sparse_names:
                    sparse_names.append(w)

    block.append_op(
        type="jax_autodiff",
        inputs={"Loss": [loss], "Params": param_names},
        outputs={"Grads": [g.name for g in grads],
                 "LossGrad": [loss_grad]},
        attrs={
            "loss_name": loss.name,
            "param_names": param_names,
            "sparse_param_names": sparse_names,
            "fwd_op_count": fwd_op_count,
            "checkpoints": [c.name if isinstance(c, Variable) else c
                            for c in (checkpoints or [])],
        })
    return list(zip(params, grads))


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """fluid/backward.py:1665 parity: grads of targets w.r.t. arbitrary
    inputs (Parameters or data/feed vars), with optional seeded cotangents
    `target_gradients[i]` for each target (None → ones)."""
    ts = list(targets) if isinstance(targets, (list, tuple)) else [targets]
    ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    program = ts[0].block.program
    block = program.global_block()

    # resolve strings, keep one result slot per ORIGINAL input; blocked
    # (no_grad_set) inputs yield None in place
    ng = {n if isinstance(n, str) else n.name for n in (no_grad_set or ())}
    resolved = [block.var(v) if isinstance(v, str) else v for v in ins]
    active = [v for v in resolved if v.name not in ng]

    tgs = None
    if target_gradients is not None:
        tgs = list(target_gradients) if isinstance(
            target_gradients, (list, tuple)) else [target_gradients]
        tgs += [None] * (len(ts) - len(tgs))

    fwd_op_count = len(block.ops)
    in_names = [v.name for v in active]
    grad_by_name = {}
    for v in active:
        gname = grad_var_name(v.name)
        if gname in block.vars:
            # a previous append_backward/calc_gradient already claimed this
            # name; each autodiff op must write distinct grad vars
            gname = unique_name.generate(gname)
        g = block.create_var(name=gname, shape=v.shape,
                             dtype=v.dtype, stop_gradient=True)
        grad_by_name[v.name] = g

    # "" is the no-seed sentinel ("" is serializable where None in a str
    # list is not); the lowering treats falsy names as ones-seeding
    tg_names = [""] * len(ts)
    if tgs:
        tg_names = [(g.name if isinstance(g, Variable) else g)
                    if g is not None else "" for g in tgs]
    # ALL targets and seed vars must appear as op inputs so Program._prune
    # and save_inference_model keep their producers alive
    block.append_op(
        type="jax_autodiff",
        inputs={"Loss": [ts[0]], "Targets": [t.name for t in ts],
                "TargetGrads": [n for n in tg_names if n],
                "Params": in_names},
        outputs={"Grads": [grad_by_name[n].name for n in in_names]},
        attrs={
            "loss_name": ts[0].name,
            "loss_names": [t.name for t in ts],
            "target_grad_names": tg_names,
            "param_names": in_names,
            "fwd_op_count": fwd_op_count,
            "checkpoints": [],
        })
    return [grad_by_name.get(v.name) for v in resolved]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    return calc_gradient(targets, inputs, target_gradients, no_grad_set)
