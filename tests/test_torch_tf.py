"""The TF GraphDef frontend of the port against the JAX package's, on the CPU.

* The codec (`mnn_tpu_torch/convert/graphdef_pb2.py` on `protowire.py`, no
  TensorFlow or protobuf package): the bytes TensorFlow's generated
  `graph_pb2` writes (deterministic: map entries in key order) for a
  GraphDef with every AttrValue kind, read back equal both ways;
  `make_ndarray` against `tensor_util.MakeNdarray` on `tensor_content`, the
  typed fields, a short list repeating its last value, fp16 and bf16.
* The converter: every graph of `tests/test_tf_frontend.py`, frozen once
  per module with TensorFlow, through the JAX frontend and the port's on
  `device="cpu"` with the same seeded numpy inputs, at that test's
  tolerances; `chip_smoke.tf_cases()`, graphs that reach every op of the
  table (1e-5, ints equal); the GraphDef handed over as bytes, a path, a
  TensorFlow proto, a tf.function and a concrete function.
* A softshrink plugin in the `tf` table inside a converted graph.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from mnn_tpu.convert.tf_frontend import convert_graphdef as jax_convert
from mnn_tpu_torch import plugin
from mnn_tpu_torch.convert import graphdef_pb2 as G, tf_frontend
from mnn_tpu_torch.kernels import softshrink

tf = pytest.importorskip("tensorflow")
from tensorflow.core.framework import (graph_pb2, tensor_pb2,  # noqa: E402
                                       tensor_shape_pb2, types_pb2)
from tensorflow.python.framework import tensor_util  # noqa: E402
from tensorflow.python.framework.convert_to_constants import (  # noqa: E402
    convert_variables_to_constants_v2)


def _frozen(f, *xs):
    specs = [tf.TensorSpec(x.shape, tf.as_dtype(x.dtype)) for x in xs]
    cf = tf.function(f).get_concrete_function(*specs)
    return convert_variables_to_constants_v2(cf).graph.as_graph_def()


def _graphs():
    """The graphs of tests/test_tf_frontend.py: name -> (f, inputs, atol)."""
    rng = np.random.default_rng(0)
    w1 = tf.constant(rng.standard_normal((12, 24), np.float32) * 0.3)
    b1 = tf.constant(rng.standard_normal(24, np.float32) * 0.1)
    w2 = tf.constant(rng.standard_normal((24, 5), np.float32) * 0.3)

    def dense_stack(x):
        h = tf.nn.relu(tf.nn.bias_add(tf.matmul(x, w1), b1))
        return tf.nn.softmax(tf.matmul(h, w2))

    rng = np.random.default_rng(1)
    k = tf.constant(rng.standard_normal((3, 3, 3, 8), np.float32) * 0.2)
    kdw = tf.constant(rng.standard_normal((3, 3, 8, 2), np.float32) * 0.2)
    scale = tf.constant(rng.standard_normal(8, np.float32) * 0.1 + 1)
    offset = tf.constant(rng.standard_normal(8, np.float32) * 0.1)
    mean = tf.constant(rng.standard_normal(8, np.float32) * 0.1)
    var = tf.constant(np.abs(rng.standard_normal(8, np.float32)) + 0.5)

    def conv_bn_pool(x):
        h = tf.nn.conv2d(x, k, 2, "SAME")
        h, *_ = tf.compat.v1.nn.fused_batch_norm(h, scale, offset, mean, var, is_training=False)
        h = tf.nn.relu6(h)
        h = tf.nn.depthwise_conv2d(h, kdw, (1, 1, 1, 1), "VALID")
        h = tf.nn.max_pool2d(h, 2, 2, "SAME")
        h = tf.nn.avg_pool2d(h, 2, 1, "VALID")
        return tf.reduce_mean(h, axis=(1, 2))

    def shape_ops(x):
        h = tf.transpose(x, (0, 2, 1))
        h = tf.reshape(h, (-1, 8))
        a, b = tf.split(h, 2, axis=0)
        h = tf.concat([b * 2.0, a], axis=0)
        h = tf.expand_dims(h, 1)
        return tf.squeeze(h, 1)[1:5, ::2]

    def elementwise_zoo(x):
        h = tf.abs(x) + tf.sqrt(tf.square(x) + 1.0)
        h = tf.math.rsqrt(tf.maximum(h, 0.5))
        h = h * tf.sigmoid(x) - tf.nn.leaky_relu(x, 0.1)
        g = 0.5 * x * (1.0 + tf.math.erf(x / np.sqrt(2.0)))
        return tf.exp(-h) + g + tf.nn.elu(x)

    def pad_gather_stack(x):
        h = tf.pad(x, [[0, 0], [1, 1], [0, 2]])
        h = tf.gather(h, [1, 0, 3], axis=1)
        return tf.stack([h, h + 1.0], axis=0)

    def reductions_argmax_cast(x):
        return (tf.reduce_sum(x, axis=1), tf.cast(tf.argmax(x, axis=-1), tf.int32),
                tf.reduce_max(x, axis=(0, 2), keepdims=True))

    def batch_matmul_and_resize(a, b):
        m = tf.matmul(a, b)
        img = tf.reshape(m, (1, 3, 3, 1))
        return tf.image.resize(img, (6, 6))

    def strided_slice_masks(x):
        return x[:, 1:, ::2] + x[:, :-1, 1::2] + x[:, :0:-1, ::-2]

    kt = tf.constant(np.random.default_rng(8).standard_normal((3, 3, 4, 5), np.float32) * 0.2)

    def conv_transpose(x):
        return tf.nn.conv2d_transpose(x, kt, (2, 9, 9, 4), 2, "SAME")

    r = lambda seed, *s: np.random.default_rng(seed).standard_normal(s).astype(np.float32)
    return {
        "dense_stack": (dense_stack, [r(0, 3, 12)], 1e-5),
        "conv_bn_pool": (conv_bn_pool, [r(1, 2, 16, 16, 3)], 1e-4),
        "shape_ops": (shape_ops, [r(2, 2, 8, 4)], 1e-5),
        "elementwise_zoo": (elementwise_zoo, [r(3, 3, 9)], 1e-4),
        "pad_gather_stack": (pad_gather_stack, [r(4, 2, 4, 3)], 1e-5),
        "reductions_argmax_cast": (reductions_argmax_cast, [r(5, 2, 5, 3)], 1e-5),
        "batch_matmul_and_resize": (batch_matmul_and_resize, [r(6, 1, 3, 4), r(6, 1, 4, 3)], 1e-4),
        "strided_slice_masks": (strided_slice_masks, [r(7, 2, 5, 6)], 1e-5),
        "conv_transpose": (conv_transpose, [r(8, 2, 5, 5, 5)], 1e-4),
    }


@pytest.fixture(scope="module")
def frozen():
    """Each graph frozen once: name -> (TF GraphDef, inputs, atol)."""
    return {name: (_frozen(f, *xs), xs, atol) for name, (f, xs, atol) in _graphs().items()}


def _outs(v):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in (v if isinstance(v, tuple) else (v,))]


@pytest.mark.parametrize("name", sorted(_graphs()))
def test_matches_jax_frontend(frozen, name):
    gd, xs, atol = frozen[name]
    jfn, jp = jax_convert(gd)
    want = _outs(jfn(jp, *[jnp.asarray(x) for x in xs]))
    fn, p = tf_frontend.convert_graphdef(gd, device="cpu")
    got = _outs(fn(p, *[torch.from_numpy(x) for x in xs]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, atol=atol, rtol=1e-4)


def test_conv_filters_laid_out_once(frozen):
    """A Const read only as a Conv2D / depthwise filter is OIHW in
    channels-last memory in `params`; a filter read by another op too keeps
    its HWIO layout; both graphs give the JAX frontend's output."""
    gd, xs, atol = frozen["conv_bn_pool"]
    fn, p = tf_frontend.convert_graphdef(gd, device="cpu")
    filters = {n.input[1].split(":")[0]: n.op for n in gd.node
               if n.op in ("Conv2D", "DepthwiseConv2dNative")}
    assert sorted(filters.values()) == ["Conv2D", "DepthwiseConv2dNative"]
    assert p[next(k for k, v in filters.items() if v == "Conv2D")].shape == (8, 3, 3, 3)
    assert p[next(k for k, v in filters.items() if v != "Conv2D")].shape == (16, 1, 3, 3)
    for name in filters:
        assert p[name].is_contiguous(memory_format=torch.channels_last)

    k = tf.constant(np.random.default_rng(9).standard_normal((3, 3, 3, 4), np.float32) * 0.2)
    shared = _frozen(lambda x: tf.nn.conv2d(x, k, 1, "SAME") + tf.reduce_sum(k), xs[0])
    fn2, p2 = tf_frontend.convert_graphdef(shared, device="cpu")
    assert [tuple(v.shape) for v in p2.values() if v.dim() == 4] == [(3, 3, 3, 4)]
    for graph, f, params in ((gd, fn, p), (shared, fn2, p2)):
        jfn, jp = jax_convert(graph)
        np.testing.assert_allclose(_outs(f(params, torch.from_numpy(xs[0])))[0],
                                   _outs(jfn(jp, jnp.asarray(xs[0])))[0], atol=atol, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(chip_smoke.tf_cases()))
def test_breadth_every_op_matches_jax(name):
    cases = chip_smoke.tf_cases()
    graph, feeds, outs = cases[name]
    covered = set().union(*(chip_smoke.tf_ops_of(c[0]) for c in cases.values()))
    assert covered == set(tf_frontend._OPS)
    got = chip_smoke.run_tf_case(cases[name], "cpu")
    jfn, jp = jax_convert(graph_pb2.GraphDef.FromString(graph), outputs=outs)
    want = _outs(jfn(jp, *[jnp.asarray(a) for _, a in feeds]))
    assert chip_smoke.onnx_worst(got, want, outs) <= 1e-5


def test_graphdef_handed_over_every_way(frozen, tmp_path):
    """bytes, a path, TensorFlow's proto (SerializeToString), a frozen
    concrete function (.graph.as_graph_def()), and for a function with no
    captured constants a tf.function (get_concrete_function): one result."""
    gd, xs, _ = frozen["dense_stack"]
    f, _, _ = _graphs()["dense_stack"]
    spec = tf.TensorSpec(xs[0].shape, tf.float32)
    path = tmp_path / "g.pb"
    path.write_bytes(gd.SerializeToString())
    frozen_cf = convert_variables_to_constants_v2(tf.function(f).get_concrete_function(spec))
    x = torch.from_numpy(xs[0])
    results = []
    for src in (gd.SerializeToString(), str(path), gd, frozen_cf):
        fn, p = tf_frontend.convert_graphdef(src, device="cpu")
        results.append(fn(p, x).numpy())
    for got in results[1:]:
        np.testing.assert_array_equal(got, results[0])
    plain = tf.function(lambda v: tf.nn.softmax(tf.nn.relu(v) * 2.0), input_signature=[spec])
    fn, p = tf_frontend.convert_graphdef(plain, device="cpu")
    np.testing.assert_allclose(fn(p, x).numpy(), plain(xs[0]).numpy(), atol=1e-6)
    assert fn.input_names and fn.output_names
    with pytest.raises(TypeError):
        tf_frontend.convert_graphdef(object(), device="cpu")


# --------------------------------------------------------------------------
# the codec
# --------------------------------------------------------------------------

def _fill(g, M, tensor, shape):
    """The same GraphDef in either codec: M gives NodeDef / AttrValue."""
    n = g.node.add(name="conv", op="Conv2D")
    n.input.extend(["x", "w", "^ctrl"])
    n.device = "/device:CPU:0"
    n.attr["strides"].list.i.extend([1, 2, 2, 1])
    n.attr["padding"].s = b"SAME"
    n.attr["T"].type = 1
    n.attr["use_cudnn_on_gpu"].b = True
    n.attr["alpha"].f = -0.25
    n.attr["i"].i = -3
    n.attr["empty"].list.SetInParent()
    n.attr["floats"].list.f.extend([0.5, -1.0])
    n.attr["types"].list.type.extend([1, 3])
    n.attr["bools"].list.b.extend([True, False])
    n.attr["strs"].list.s.extend([b"a", b""])
    n.attr["shape"].shape.CopyFrom(shape)
    n.attr["value"].tensor.CopyFrom(tensor)
    c = g.node.add(name="c", op="Const")
    c.attr["dtype"].type = 3
    g.versions.producer = 1882
    g.versions.bad_consumers.extend([3, 5])
    return g


def _shape(M):
    s = M.TensorShapeProto()
    for d in (2, -1, 3):
        s.dim.add(size=d)
    return s


def _tensor(M):
    t = M.TensorProto(dtype=1)
    t.tensor_shape.dim.add(size=3)
    t.float_val.extend([1.5, -2.0, 0.0])
    t.int64_val.extend([-1, 1 << 40])
    t.half_val.extend([0x3C00, 0xBC00])
    return t


def test_codec_writes_tensorflows_bytes_and_reads_them_back():
    class TFM:
        TensorShapeProto = tensor_shape_pb2.TensorShapeProto
        TensorProto = tensor_pb2.TensorProto

    theirs = _fill(graph_pb2.GraphDef(), TFM, _tensor(TFM), _shape(TFM)) \
        .SerializeToString(deterministic=True)
    ours = _fill(G.GraphDef(), G, _tensor(G), _shape(G)).SerializeToString()
    assert ours == theirs
    back = G.GraphDef.FromString(theirs)
    assert back.SerializeToString() == theirs
    assert graph_pb2.GraphDef.FromString(ours) == graph_pb2.GraphDef.FromString(theirs)
    a = back.node[0].attr
    assert a["padding"].WhichOneof("value") == "s" and list(a["strides"].list.i) == [1, 2, 2, 1]
    assert a["value"].tensor.int64_val[1] == 1 << 40 and a["i"].i == -3


TENSORS = {  # name -> a TF TensorProto
    "content_f32": tensor_util.make_tensor_proto(np.arange(6, dtype=np.float32).reshape(2, 3)),
    "content_i64": tensor_util.make_tensor_proto(np.arange(-3, 3, dtype=np.int64)),
    "content_bool": tensor_util.make_tensor_proto(np.array([True, False, True])),
    "content_f16": tensor_util.make_tensor_proto(np.array([0.5, -2.0, 65504.0], np.float16)),
    "scalar_f32": tensor_util.make_tensor_proto(np.float32(2.5)),
    "fill_f32": tensor_util.make_tensor_proto(1.25, dtype=tf.float32, shape=[2, 3]),
    "fill_i32": tensor_util.make_tensor_proto(7, dtype=tf.int32, shape=[4]),
}


def _typed(dtype, field, vals, shape):
    t = tensor_pb2.TensorProto(dtype=dtype)
    for d in shape:
        t.tensor_shape.dim.add(size=d)
    getattr(t, field).extend(vals)
    return t


TENSORS.update({
    "float_val_repeats_last": _typed(types_pb2.DT_FLOAT, "float_val", [1.0, 2.5], [2, 2]),
    "int_val": _typed(types_pb2.DT_INT32, "int_val", [3, -4, 5], [3]),
    "int8_int_val": _typed(types_pb2.DT_INT8, "int_val", [-7], [2]),
    "int64_val": _typed(types_pb2.DT_INT64, "int64_val", [1 << 40, -2], [2]),
    "bool_val": _typed(types_pb2.DT_BOOL, "bool_val", [True], [3]),
    "double_val": _typed(types_pb2.DT_DOUBLE, "double_val", [0.1, 1e300], [2]),
    "half_val_f16": _typed(types_pb2.DT_HALF, "half_val", [0x3C00, 0xC000, 0x7BFF], [3]),
    "half_val_bf16": _typed(types_pb2.DT_BFLOAT16, "half_val", [0x3F80, 0xC0A0], [2, 2]),
    "bf16_content": tensor_pb2.TensorProto(
        dtype=types_pb2.DT_BFLOAT16, tensor_content=np.asarray([0x3F80, 0x4049], np.uint16)
        .tobytes(), tensor_shape={"dim": [{"size": 2}]}),
    "empty_values": _typed(types_pb2.DT_FLOAT, "float_val", [], [2, 2]),
})


@pytest.mark.parametrize("name", sorted(TENSORS))
def test_make_ndarray_matches_tensorflow(name):
    t = TENSORS[name]
    want = tensor_util.MakeNdarray(t)
    got = G.make_ndarray(G.TensorProto.FromString(t.SerializeToString()))
    assert got.shape == want.shape
    if want.dtype.name == "bfloat16":           # the port widens bf16 to f32, exactly
        assert got.dtype == np.float32
        want = want.astype(np.float32)
    else:
        assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the plugin
# --------------------------------------------------------------------------

def test_softshrink_plugin_in_a_converted_graph():
    graph = chip_smoke.plugin_graphs([2, 8, 16, 16])["tf"]
    with pytest.raises(NotImplementedError, match=chip_smoke.PLUGIN_OP):
        tf_frontend.convert_graphdef(graph, device="cpu")
    plugin.register_op(chip_smoke.PLUGIN_OP, chip_smoke.PLUGIN_FNS["tf"], frontend="tf")
    try:
        fn, p = tf_frontend.convert_graphdef(graph, device="cpu")
        for dt in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 8, 16, 16))
                                 .astype(np.float32)).to(dt)
            ib = torch.int16 if dt == torch.bfloat16 else torch.int32
            assert torch.equal(fn(p, x).view(ib),
                               softshrink.softshrink_plain(x, chip_smoke.SOFTSHRINK_LAM).view(ib))
    finally:
        plugin.unregister_op(chip_smoke.PLUGIN_OP, frontend="tf")
    assert chip_smoke.PLUGIN_OP not in plugin.registered_ops("tf")
