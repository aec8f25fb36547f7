"""The port's program wire format against the JAX package's: the
hand-written proto3 codec (`paddle_tpu_torch/core/program_pb.py`) writes
the bytes protobuf's `SerializeToString()` writes for the JAX package's
messages, and reads them back to the same program, for every program the
static tests build; `__params__` (PTC1) bytes equal the JAX
`ptc_format.save_combine`'s. The JAX side is composed from
`paddle_tpu.core.program_pb` / `ptc_format` only (never its `fluid.io`
save or load, which build the native library)."""
import os

import numpy as np
import pytest

from _torch_parity import keep_global_rng  # noqa: F401
from _torch_static import (carry, fluids, jax_model_bytes,
                           jax_program_bytes, jax_program_from_bytes, lenet,
                           port_program_bytes, static_params, static_ernie)

pytestmark = pytest.mark.usefixtures("keep_global_rng")

ERNIE_TINY = dict(vocab=1024, hidden=64, layers=2, heads=4, ffn=128,
                  max_pos=128, type_vocab=2, seq=16)


def _attr_program(fluid):
    """A program whose op carries an attr of every oneof kind at its
    default, negative ints and dims, an empty list, a sub-block ref and a
    var with a -1 batch dim."""
    main = fluid.Program()
    blk = main.global_block()
    x = blk.create_var(name="x", shape=[-1, 3], dtype="float32",
                       is_data=True, lod_level=0)
    blk.create_var(name="w", shape=[3, 4], dtype="float32",
                   persistable=True, stop_gradient=False, trainable=True)
    sub = main._create_block(0)
    sub.create_var(name="inner", shape=[-7], dtype="int64")
    out = blk.create_var(name="y", shape=[-1, 4])
    blk.append_op(type="custom_probe", inputs={"X": [x], "W": ["w"]},
                  outputs={"Out": [out]},
                  attrs={"i0": 0, "ineg": -1, "ibig": -(2 ** 40),
                         "f0": 0.0, "fneg": -0.0, "f": 2.5, "s0": "",
                         "s": "relu", "b0": False, "b1": True,
                         "ints": [-1, 3, 0], "floats": [0.0, -1.5, 2.0],
                         "mixed": [1, 2.5], "strs": ["", "a"],
                         "bools": [False, True], "empty": [],
                         "sub_block": sub, "np_i": np.int64(-3),
                         "np_f": np.float32(0.5), "none": None,
                         "callable": len})
    return main


def _while_program(fluid):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 4)
        acc = L.fill_constant([1], "float32", 1.0)
        cond = L.less_than(i, n)
        loop = L.While(cond)
        with loop.block():
            L.assign(acc * 2.0, acc)
            L.increment(i, 1.0, in_place=True)
            L.less_than(i, n, cond=cond)
    return main, acc


def _programs():
    """(name, builder(fluid) -> [programs]) of the programs compared."""
    def ernie(fluid):
        main, startup, feeds, outs = static_ernie(fluid, **ERNIE_TINY)
        pruned = main._prune(outs).clone(for_test=True)
        return [main, startup, pruned]

    def lenet_progs(fluid):
        main, startup, _ = lenet(fluid)
        return [main, startup]

    def fit_line(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [2], dtype="float32")
            y = fluid.layers.data("y", [1], dtype="float32")
            h = fluid.layers.dropout(fluid.layers.fc(x, 8, act="tanh"), 0.1)
            loss = fluid.layers.mean(fluid.layers.square_error_cost(
                fluid.layers.fc(h, 1), y))
            fluid.optimizer.Momentum(0.1, 0.9, use_nesterov=True).minimize(
                loss)
        return [main, startup, main.clone(for_test=True)]

    return [("ernie_tiny", ernie), ("lenet_adam", lenet_progs),
            ("fit_line_momentum", fit_line),
            ("attrs", lambda fluid: [_attr_program(fluid)])]


@pytest.mark.parametrize("name,build", _programs(), ids=lambda v: v
                         if isinstance(v, str) else "")
def test_port_program_bytes_equal_the_jax_serialization(name, build):
    jf, tf = fluids()
    for jp, tp in zip(build(jf), build(tf)):
        want = jax_program_bytes(jp)
        assert port_program_bytes(tp) == want, name


@pytest.mark.parametrize("name,build", _programs(), ids=lambda v: v
                         if isinstance(v, str) else "")
def test_both_directions_decode_to_the_same_program(name, build):
    """Port bytes parse in JAX and JAX bytes parse in the port, each to a
    program that serializes to the same bytes again."""
    from paddle_tpu_torch.core import program_pb as TP

    jf, tf = fluids()
    for jp, tp in zip(build(jf), build(tf)):
        feeds = [v.name for v in tp.global_block().vars.values()
                 if v.is_data]
        jbytes = jax_model_bytes(jp, feeds, ["fetch_a", "fetch_b"])
        tbytes = tf.io.model_bytes(tp, feeds, ["fetch_a", "fetch_b"])
        assert tbytes == jbytes
        # JAX bytes -> port program -> bytes
        model = TP.InferenceModel.FromString(jbytes)
        back = TP.proto_to_program(model.program)
        assert tf.io.model_bytes(back, list(model.feed_names),
                                 list(model.fetch_names)) == jbytes
        assert [b.parent_idx for b in back.blocks] == \
            [b.parent_idx for b in tp.blocks]
        # port bytes -> JAX program -> bytes
        jback, jfeeds, jfetches = jax_program_from_bytes(tbytes)
        assert jax_model_bytes(jback, jfeeds, jfetches) == tbytes


def test_attr_kinds_decode_as_the_jax_decoder_reads_them():
    from paddle_tpu.core import program_pb as JP
    from paddle_tpu_torch.core import program_pb as TP

    jf, tf = fluids()
    data = port_program_bytes(_attr_program(tf))
    jprog = JP.proto_to_program(JP.messages().ProgramDesc.FromString(data))
    tprog = TP.proto_to_program(TP.ProgramDesc.FromString(data))
    ja = jprog.global_block().ops[0].attrs
    ta = tprog.global_block().ops[0].attrs
    for k, v in ja.items():
        if k == "sub_block":
            assert ta[k] is tprog.blocks[1] and v is jprog.blocks[1]
            continue
        if k == "op_callstack":   # recorded anew by each decoder's append
            continue
        assert ta[k] == v and type(ta[k]) is type(v), k
    assert set(ja) == set(ta)
    assert ta["ineg"] == -1 and ta["ibig"] == -(2 ** 40)
    assert ta["empty"] == [] and ta["mixed"] == [1.0, 2.5]
    assert "callable" not in ta and "none" not in ta
    assert tprog.blocks[1].vars["inner"].shape == [-7]
    assert tprog.global_block().vars["x"].shape == [-1, 3]


@pytest.mark.parametrize("kind,value,want", [
    ("i", 0, b"\x10\x00"), ("f", 0.0, b"\x19" + b"\x00" * 8),
    ("s", "", b"\x22\x00"), ("b", False, b"\x28\x00"),
    ("i", -1, b"\x10" + b"\xff" * 9 + b"\x01"),
    ("block_idx", -1, b"\x50" + b"\xff" * 9 + b"\x01"),
    ("bools", [], b"\x4a\x00"), ("ints", [-1, 3], None),
    ("floats", [0.0, 1.5], None), ("strs", ["", "x"], None)])
def test_oneof_members_at_their_default_are_written(kind, value, want):
    """A set oneof member is on the wire even at 0 / 0.0 / "" / false;
    ints and bools pack, floats pack as doubles, negatives take ten
    bytes."""
    from paddle_tpu.core import program_pb as JP
    from paddle_tpu_torch.core import program_pb as TP

    jm = JP.messages().Attr()
    if kind in ("ints", "floats", "strs", "bools"):
        getattr(jm, kind).val.extend(value)
        if not value:
            getattr(jm, kind).SetInParent()
        cls = {"ints": TP.IntList, "floats": TP.FloatList,
               "strs": TP.StrList, "bools": TP.BoolList}[kind]
        tm = TP.Attr(**{kind: cls(val=list(value))})
    else:
        setattr(jm, kind, value)
        tm = TP.Attr(**{kind: value})
    jbytes = jm.SerializeToString()
    assert tm.SerializeToString() == jbytes
    if want is not None:
        assert jbytes == want
    back = TP.Attr.FromString(jbytes)
    assert back.WhichOneof("value") == kind
    got = getattr(back, kind)
    assert (list(got.val) if hasattr(got, "val") else got) == value


def test_shape_packs_and_unpacked_input_still_decodes():
    from paddle_tpu.core import program_pb as JP
    from paddle_tpu_torch.core import program_pb as TP

    jv = JP.messages().VarDesc(name="v", shape=[-1, 3], lod_level=-2)
    tv = TP.VarDesc(name="v", shape=[-1, 3], lod_level=-2)
    assert tv.SerializeToString() == jv.SerializeToString()
    assert len(TP.VarDesc(shape=[-1, 3]).SerializeToString()) == 13
    # unpacked repeated int64 (a valid proto2-style encoding) + an
    # unknown field: the decoder takes both, as protobuf's does
    raw = (b"\x0a\x01v" + b"\x18" + TP.encode_varint(-1) + b"\x18\x03"
           + b"\x78\x05")
    back = TP.VarDesc.FromString(raw)
    assert back.name == "v" and back.shape == [-1, 3]
    assert back.shape == list(JP.messages().VarDesc.FromString(raw).shape)


def test_params_bytes_equal_the_jax_save_combine(tmp_path):
    from paddle_tpu.core import ptc_format as JF
    from paddle_tpu_torch.core import ptc_format as TF

    rs = np.random.RandomState(0)
    arrays = {"w": rs.randn(3, 4).astype(np.float32),
              "ids": rs.randint(0, 9, (5,)).astype(np.int64),
              "flag": np.array([True, False]), "h": np.float16([1.5]),
              "q": rs.randint(-127, 127, (2, 2)).astype(np.int8),
              "scalar": np.float64(2.0).reshape(()),
              "empty": np.zeros((0, 3), np.float32)}
    JF.save_combine(str(tmp_path / "j"), arrays)
    TF.save_combine(str(tmp_path / "t"), arrays)
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()
    back = TF.load_combine(str(tmp_path / "j"))
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype
        np.testing.assert_array_equal(back[k], a)


def test_save_inference_model_writes_the_jax_artifact(tmp_path):
    """The port's `__model__` / `__params__` for static ERNIE (tiny) equal
    the bytes the JAX package composes for the same pruned program and
    the same values; a load -> save round trip is byte-identical."""
    from paddle_tpu.core import ptc_format as JF
    from paddle_tpu_torch.convert import from_jax_scope

    jf, tf = fluids()
    tm, ts, feeds, touts = static_ernie(tf, **ERNIE_TINY)
    jm, js, _, jouts = static_ernie(jf, **ERNIE_TINY)
    params = static_params(ts, 3)
    scope = from_jax_scope(params, tf.Scope(), "cpu")
    d = str(tmp_path / "port")
    exe = tf.Executor(tf.CPUPlace())
    with tf.scope_guard(scope):
        fetch = tf.io.save_inference_model(d, feeds, touts, exe,
                                           main_program=tm)
    jpruned = jm._prune(jouts).clone(for_test=True)
    want_model = jax_model_bytes(jpruned, feeds, [v.name for v in jouts])
    with open(os.path.join(d, "__model__"), "rb") as f:
        assert f.read() == want_model
    needed = [v.name for v in jpruned.global_block().vars.values()
              if v.persistable]
    JF.save_combine(str(tmp_path / "jparams"),
                    {n: params[n] for n in jm.global_block().vars
                     if n in needed})
    with open(os.path.join(d, "__params__"), "rb") as f:
        assert f.read() == (tmp_path / "jparams").read_bytes()
    # load -> save round trip
    scope2 = tf.Scope()
    with tf.scope_guard(scope2):
        prog, feed_names, fetch_vars = tf.io.load_inference_model(d, exe)
        assert feed_names == feeds and [v.name for v in fetch_vars] == fetch
        d2 = str(tmp_path / "again")
        tf.io.save_inference_model(d2, feed_names, fetch_vars, exe,
                                   main_program=prog)
    for name in ("__model__", "__params__"):
        with open(os.path.join(d, name), "rb") as a, \
                open(os.path.join(d2, name), "rb") as b:
            assert a.read() == b.read(), name


def test_persistables_pickle_loads_across_packages(tmp_path):
    """`save_persistables` writes the JAX package's (dtype, array) pickle:
    the JAX values, written by the port after the carry, load back equal;
    `static.save` / `static.load` round-trip."""
    import pickle

    import paddle_tpu_torch.static as tstatic

    jf, tf = fluids()
    jm, js, _ = lenet(jf)
    tm, _, _ = lenet(tf)
    jscope = jf.Scope()
    jf.Executor().run(js, scope=jscope)
    tscope = carry(jscope, tf.Scope())
    exe = tf.Executor(tf.CPUPlace())
    with tf.scope_guard(tscope):
        tf.io.save_persistables(exe, str(tmp_path / "p"), tm)
        tstatic.save(tm, str(tmp_path / "s"))
    with open(tmp_path / "p" / "__params__", "rb") as f:
        vals = pickle.load(f)
    for n, v in jscope._values.items():
        dt, arr = vals[n]
        assert dt == np.asarray(v).dtype.name
        np.testing.assert_array_equal(arr, np.asarray(v))
    fresh = tf.Scope()
    with tf.scope_guard(fresh):
        tf.io.load_persistables(exe, str(tmp_path / "p"), tm)
        assert sorted(fresh._values) == sorted(jscope._values)
    fresh2 = tf.Scope()
    with tf.scope_guard(fresh2):
        tstatic.load(tm, str(tmp_path / "s"))
        for n in jscope._values:
            np.testing.assert_array_equal(fresh2._values[n].numpy(),
                                          np.asarray(jscope._values[n]))
    again = tf.Program.parse_from_string(
        (tmp_path / "s.pdmodel").read_bytes())
    assert port_program_bytes(again) == port_program_bytes(tm)


def test_jax_built_control_flow_decodes_with_its_sub_blocks():
    """A While program built by the JAX layers (the port's builder waits
    for item 8b) comes across the wire whole: its sub-block, parent
    index and carry attrs re-serialize to the same bytes."""
    from paddle_tpu_torch.core import program_pb as TP

    jf, tf = fluids()
    jmain, _ = _while_program(jf)
    data = jax_program_bytes(jmain)
    prog = TP.proto_to_program(TP.ProgramDesc.FromString(data))
    assert len(prog.blocks) == 2 and prog.blocks[1].parent_idx == 0
    wop = [op for op in prog.global_block().ops if op.type == "while"][0]
    assert wop.attrs["sub_block"] == 1
    assert port_program_bytes(prog) == data
