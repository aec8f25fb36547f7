"""Inference deployment API (the JAX package's `inference/`).

Reference parity: paddle.inference — AnalysisConfig
(inference/api/paddle_analysis_config.h), AnalysisPredictor
(api/analysis_predictor.cc:288 Run / :715 ZeroCopyRun), create_predictor,
ZeroCopyTensor.

A Predictor loads a `save_inference_model` artifact (`__model__` /
`__params__`, byte for byte the JAX package's), applies the IR passes and
runs the program on the port's Executor, op by op on the card: a
Transformer encoder's raw attention becomes `fused_sdpa`
(`multihead_matmul_fuse_pass`), which runs the flash forward kernel.
`Config.disable_gpu()` asks for the CPU; without it and with no card,
`create_predictor` raises. Feeds keep batch bucketing (`core.bucketing`).
Unlike the JAX Predictor, which loads into the global scope, each
Predictor keeps its parameters in a Scope of its own.

Waiting, each raising with its ROADMAP sub-item: the native engine
(`enable_native_engine`, the ptcore binding: 8e); the serving engine
behind `generate` and `serve` and the StableHLO export (8d).
"""
from __future__ import annotations

import os

import numpy as np

from ..core.bucketing import pad_batch_feeds

__all__ = ["Config", "Predictor", "create_predictor", "PredictorTensor",
           "create_paddle_predictor", "AnalysisConfig", "INFERENCE_PASSES",
           "WEIGHT_PASSES"]

#: the program rewrites `Predictor` applies, in the JAX package's order
INFERENCE_PASSES = [
    "delete_dropout_pass", "identity_scale_op_clean_pass",
    "multihead_matmul_fuse_pass",
    # add2 (bias+residual) BEFORE the single-add form so the longer
    # chain claims its ops first
    "conv_elementwise_add2_act_fuse_pass",
    "conv_elementwise_add_act_fuse_pass",
    "fc_gru_fuse_pass", "fc_lstm_fuse_pass",
    "embedding_eltwise_layernorm_fuse_pass",
    "fc_fuse_pass",
    # after fc_fuse: these match formed fc ops
    "fc_elementwise_layernorm_fuse_pass",
    "skip_layernorm_fuse_pass",
    "seqconv_eltadd_relu_fuse_pass",
    "seqpool_concat_fuse_pass",
    "repeated_fc_relu_fuse_pass",
    "squared_mat_sub_fuse_pass",
    "transpose_flatten_concat_fuse_pass",
]
#: the weight-folding passes (they need the loaded params)
WEIGHT_PASSES = ["conv_eltwiseadd_bn_fuse_pass", "conv_bn_fuse_pass",
                 "conv_transpose_bn_fuse_pass",
                 "conv_affine_channel_fuse_pass",
                 "attention_lstm_fuse_pass"]


class Config:
    """AnalysisConfig equivalent."""

    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        if model_dir and prog_file is None:
            self.model_dir = model_dir
            self.prog_file = os.path.join(model_dir, "__model__")
            self.params_file = os.path.join(model_dir, "__params__")
        else:
            self.model_dir = model_dir or os.path.dirname(prog_file or "")
            self.prog_file = prog_file
            self.params_file = params_file
        self._device = None           # None: the card
        self._ir_optim = True
        self._batch_bucketing = True

    # engine/device toggles (enable_use_gpu equivalents)
    def enable_use_gpu(self, memory_pool_init_size_mb=0, device_id=0):
        self._device = f"cuda:{int(device_id)}"

    def enable_use_tpu(self, device_id=0):
        """Programs written against the JAX package: the card."""
        self.enable_use_gpu(device_id=device_id)

    def disable_gpu(self):
        """Run on the CPU (the JAX package's CPU engine)."""
        self._device = "cpu"

    def use_gpu(self):
        return self._device != "cpu"

    def enable_native_engine(self):
        raise NotImplementedError(
            "Config.enable_native_engine: the C++ NaiveExecutor binding "
            "comes with ROADMAP item 8e")

    def enable_xla_engine(self):
        """The JAX package's default engine: the port's Executor."""

    def switch_use_feed_fetch_ops(self, flag):
        pass

    def switch_ir_optim(self, flag=True):
        self._ir_optim = bool(flag)

    def enable_memory_optim(self):
        pass

    def enable_serving_engine(self, num_slots=8, max_queue=256,
                              max_joins_per_iter=2):
        raise NotImplementedError(
            "Config.enable_serving_engine: ArtifactServingEngine comes with "
            "ROADMAP item 8d")

    def switch_batch_bucketing(self, flag=True):
        """Pad the leading batch dim of every feed to the next power of
        two (outputs sliced back). On by default; turn off for programs
        that reduce across the batch axis (padding rows would change
        those)."""
        self._batch_bucketing = bool(flag)


class PredictorTensor:
    """ZeroCopyTensor equivalent: named handle for input/output."""

    def __init__(self, owner, name, is_input):
        self._owner = owner
        self.name = name
        self._is_input = is_input

    def copy_from_cpu(self, arr):
        from ..core.lod import LoDTensor

        if isinstance(arr, LoDTensor):
            self._owner._feeds[self.name] = arr
        else:
            self._owner._feeds[self.name] = np.asarray(arr)

    def set_lod(self, lod):
        """Reference ZeroCopyTensor.SetLoD: sequence (LoD) feeds come with
        ROADMAP item 8b."""
        raise NotImplementedError(
            "PredictorTensor.set_lod: LoD feeds come with ROADMAP item 8b")

    def reshape(self, shape):
        pass  # shapes come from the array itself

    def copy_to_cpu(self):
        return self._owner._fetch_value(self.name)


class Predictor:
    def __init__(self, config):
        self.config = config
        self._feeds = {}
        self._outputs = None
        self._load()

    def _load(self):
        from ..core.place import CPUPlace
        from ..fluid import Executor
        from ..fluid import executor as _fx
        from ..fluid.io import load_inference_model
        from ..fluid.ir import apply_pass

        dev = self.config._device
        self._exe = Executor(CPUPlace() if dev == "cpu" else dev)
        # the predictor's own scope: two predictors of one artifact (the
        # card's and the CPU's) never move each other's weights
        self._scope = _fx.Scope()
        with _fx.scope_guard(self._scope):
            prog, feed_names, fetch_vars = load_inference_model(
                self.config.model_dir,
                self._exe,
                model_filename=os.path.basename(self.config.prog_file)
                if self.config.prog_file else None,
                params_filename=os.path.basename(self.config.params_file)
                if self.config.params_file else None)
        if getattr(self.config, "_ir_optim", True):
            apply_pass(prog, INFERENCE_PASSES)
            try:
                # weight-mutating folds (need the loaded params)
                apply_pass(prog, WEIGHT_PASSES, scope=self._scope)
            except Exception:
                pass  # missing weights (program_only artifacts)
        self._program = prog
        self._feed_names = list(feed_names)
        self._fetch_vars = fetch_vars
        self._fetch_names = [v.name for v in fetch_vars]

    # --- paddle.inference 2.x surface ---
    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def get_input_handle(self, name):
        return PredictorTensor(self, name, True)

    def get_output_handle(self, name):
        return PredictorTensor(self, name, False)

    @property
    def device(self):
        return self._exe.device

    def run(self, inputs=None):
        """Either positional list of arrays (ordered by input names) or use
        handles + run() like the reference's ZeroCopyRun."""
        if inputs is not None:
            if len(inputs) != len(self._feed_names):
                raise ValueError(
                    f"Predictor.run expected {len(self._feed_names)} "
                    f"inputs for feeds {self._feed_names}, got "
                    f"{len(inputs)}")
            self._feeds = dict(zip(self._feed_names,
                                   [np.asarray(a) for a in inputs]))
        feeds, pad = self._feeds, None
        if getattr(self.config, "_batch_bucketing", True):
            feeds, pad = pad_batch_feeds(feeds)
        outs = self._exe.run(self._program, feed=feeds,
                             fetch_list=self._fetch_vars, scope=self._scope)
        if pad is not None:
            b, nb = pad
            outs = [o[:b] if getattr(o, "ndim", 0) >= 1
                    and o.shape[0] == nb else o for o in outs]
        self._outputs = dict(zip(self._fetch_names, outs))
        return outs

    def _fetch_value(self, name):
        if self._outputs is None:
            self.run()
        return self._outputs[name]

    def generate(self, input_ids, max_new_tokens=32, eos_id=None):
        """Greedy decoding over an LM artifact (ONE int token-id feed
        [B, S] to ONE logits fetch [B, S, V], causal): each step re-runs
        the whole prefix, as the JAX package's direct path does (without
        its power-of-two length buckets, which exist for its compile
        cache). Returns (tokens [B, max_new_tokens], lengths [B])."""
        if len(self._feed_names) != 1 or len(self._fetch_names) != 1:
            raise ValueError(
                "generate needs a single-feed/single-fetch LM artifact; "
                f"got feeds={self._feed_names} "
                f"fetches={self._fetch_names}")
        ids = np.asarray(input_ids)
        B0 = ids.shape[0]
        dtype = ids.dtype if np.issubdtype(ids.dtype, np.integer) \
            else np.int64
        cur = ids.astype(dtype)
        done = np.zeros((B0,), bool)
        lens = np.zeros((B0,), np.int64)
        toks = []
        for _ in range(max_new_tokens):
            logits = self._exe.run(self._program,
                                   feed={self._feed_names[0]: cur},
                                   fetch_list=self._fetch_vars,
                                   scope=self._scope)[0]
            nxt = logits[:, -1].argmax(-1).astype(dtype)
            if eos_id is not None:
                nxt = np.where(done, eos_id, nxt)
            lens += ~done
            if eos_id is not None:
                done |= nxt == eos_id
            toks.append(nxt)
            cur = np.concatenate([cur, nxt[:, None]], axis=1)
            if eos_id is not None and done.all():
                break
        out = np.stack(toks, axis=1)
        if out.shape[1] < max_new_tokens and eos_id is not None:
            pad = np.full((B0, max_new_tokens - out.shape[1]), eos_id,
                          dtype)
            out = np.concatenate([out, pad], axis=1)
        return out, lens

    def serve(self, *, max_queue=None, **server_kwargs):
        raise NotImplementedError(
            "Predictor.serve: ArtifactServingEngine comes with ROADMAP "
            "item 8d")

    def _generate_serving(self, input_ids, max_new_tokens, eos_id):
        raise NotImplementedError(
            "Predictor generation through the serving engine comes with "
            "ROADMAP item 8d")

    def export_stablehlo(self, example_feeds):
        raise NotImplementedError(
            "Predictor.export_stablehlo is a JAX export; its counterpart "
            "is decided with ROADMAP item 8d")


# the shared pow2 helper under its old private name
_pad_batch_feeds = pad_batch_feeds


def ArtifactServingEngine(*args, **kwargs):  # noqa: N802 (class name)
    raise NotImplementedError(
        "ArtifactServingEngine comes with ROADMAP item 8d")


def create_predictor(config):
    return Predictor(config)


# legacy 1.x-style entry points
AnalysisConfig = Config


def create_paddle_predictor(config):
    return Predictor(config)
