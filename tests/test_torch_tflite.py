"""The TFLite frontend of the port against the JAX package's, on the CPU.

* The converter: every model of `tests/test_tflite.py`, converted once per
  module by TensorFlow's TFLiteConverter (the weight-only int8 one too),
  through the JAX frontend and the port's on `device="cpu"` with the same
  seeded numpy inputs, at that test's tolerances (the port is held to the
  JAX frontend, not to the interpreter); the reader (`_parse`) reads the
  same tensors, buffers, quantization and operators as the JAX package's;
  `chip_smoke.tfl_cases()`, graphs that reach every builtin code of the
  table (1e-5, ints equal).
* chip_smoke's FlatBuffers writer: its models read back through
  TensorFlow's own generated schema (`schema_py_generated`), the
  MobileNetV2 writer's f32 and int8 models through both frontends.
* A softshrink plugin in the `tflite` table inside a converted model.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from mnn_tpu.convert import tflite_frontend as jtfl
from mnn_tpu_torch import plugin
from mnn_tpu_torch.convert import tflite_frontend
from mnn_tpu_torch.kernels import softshrink

tf = pytest.importorskip("tensorflow")


def _tflite(fn, *specs, quantize=False):
    f = tf.function(fn, input_signature=list(specs))
    conv = tf.lite.TFLiteConverter.from_concrete_functions([f.get_concrete_function()])
    if quantize:
        conv.optimizations = [tf.lite.Optimize.DEFAULT]
    return conv.convert()


def _models():
    """The models of tests/test_tflite.py: name -> (bytes, inputs, atol)."""
    S = lambda *s: tf.TensorSpec(s, tf.float32)
    r = lambda seed, *s: np.random.default_rng(seed).standard_normal(s).astype(np.float32)
    rng = np.random.default_rng(0)
    w1 = tf.constant(rng.standard_normal((16, 32), np.float32) * 0.3)
    b1 = tf.constant(np.zeros(32, np.float32))
    w2 = tf.constant(np.random.default_rng(1).standard_normal((32, 10), np.float32) * 0.3)
    k1 = tf.constant(rng.standard_normal((3, 3, 3, 8), np.float32) * 0.2)
    kdw = tf.constant(rng.standard_normal((3, 3, 8, 1), np.float32) * 0.2)
    k2 = tf.constant(rng.standard_normal((1, 1, 8, 16), np.float32) * 0.2)
    k5 = tf.constant(np.random.default_rng(3).standard_normal((5, 5, 2, 4), np.float32) * 0.1)
    wq = tf.constant(np.random.default_rng(0).standard_normal((32, 48), np.float32) * 0.3)

    def conv_dw_pool_stack(x):
        h = tf.nn.relu6(tf.nn.conv2d(x, k1, 2, "SAME"))
        h = tf.nn.depthwise_conv2d(h, kdw, (1, 1, 1, 1), "SAME")
        h = tf.nn.relu(h)
        h = tf.nn.conv2d(h, k2, 1, "VALID")
        h = tf.nn.avg_pool2d(h, 2, 2, "VALID")
        h = tf.nn.max_pool2d(h, 2, 2, "SAME")
        return tf.reduce_mean(h, axis=(1, 2))

    def shape_manipulation(x):
        h = tf.transpose(x, (0, 2, 1))
        h = tf.reshape(h, (1, -1))
        a, b = tf.split(h, 2, axis=1)
        return tf.concat([b, a], axis=1) * 2.0 + 1.0

    def elementwise_zoo(x):
        h = tf.abs(x) + tf.sqrt(tf.square(x) + 1.0)
        h = tf.minimum(tf.maximum(h, 0.5), 4.0)
        h = tf.math.rsqrt(h) * tf.sigmoid(x) + tf.tanh(x)
        return tf.exp(-h) + tf.nn.gelu(x)

    def pad_slice_gather(x):
        h = tf.pad(x, [[0, 0], [1, 2], [2, 1]])
        h = h[:, 1:5, 0:6]
        return tf.gather(h, [2, 0, 1], axis=1)

    def pack_stack_resize(x):
        up = tf.image.resize(x, (8, 8), method="nearest")
        return tf.stack([up, up * 2.0], axis=1)

    return {
        "dense_relu_softmax": (_tflite(lambda x: tf.nn.softmax(tf.matmul(
            tf.nn.relu(tf.matmul(x, w1) + b1), w2)), S(2, 16)), [r(2, 2, 16)], 1e-5),
        "conv_dw_pool_stack": (_tflite(conv_dw_pool_stack, S(1, 16, 16, 3)),
                               [r(1, 1, 16, 16, 3)], 1e-4),
        "strided_valid_conv": (_tflite(lambda x: tf.nn.conv2d(x, k5, (1, 2, 3, 1), "VALID"),
                                       S(2, 17, 19, 2)), [r(4, 2, 17, 19, 2)], 1e-4),
        "shape_manipulation": (_tflite(shape_manipulation, S(1, 4, 6)), [r(0, 1, 4, 6)], 1e-5),
        "elementwise_zoo": (_tflite(elementwise_zoo, S(3, 7)), [r(1, 3, 7)], 1e-4),
        "pad_slice_gather": (_tflite(pad_slice_gather, S(2, 4, 5)), [r(2, 2, 4, 5)], 1e-5),
        "reductions_and_argmax": (_tflite(lambda x: (
            tf.reduce_sum(x, axis=1), tf.reduce_max(x, axis=-1, keepdims=True),
            tf.cast(tf.argmax(x, axis=1), tf.int32)), S(3, 5, 4)), [r(3, 3, 5, 4)], 1e-5),
        "pack_stack_resize": (_tflite(pack_stack_resize, S(1, 4, 4, 2)), [r(4, 1, 4, 4, 2)], 1e-5),
        "batch_matmul": (_tflite(lambda a, b: tf.matmul(a, b), S(2, 3, 4), S(2, 4, 5)),
                         [r(5, 2, 3, 4), r(6, 2, 4, 5)], 1e-5),
        "dynamic_range_quant": (_tflite(lambda x: tf.nn.relu(tf.matmul(x, wq)), S(4, 32),
                                        quantize=True), [r(7, 4, 32)], 1e-5),
        "io_names_and_shapes": (_tflite(lambda x: x + 1.0, tf.TensorSpec((2, 3), tf.float32,
                                                                         name="inp")),
                                [r(8, 2, 3)], 1e-6),
    }


@pytest.fixture(scope="module")
def models():
    built = _models()
    assert sorted(built) == sorted(MODEL_NAMES)
    return built


def _outs(v):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in (v if isinstance(v, tuple) else (v,))]


def _both(model, xs):
    jfn, jp = jtfl.convert_tflite(model)
    fn, p = tflite_frontend.convert_tflite(model, device="cpu")
    want = _outs(jfn(jp, *[jnp.asarray(x) for x in xs]))
    got = _outs(fn(p, *[torch.from_numpy(x) for x in xs]))
    return (fn, jfn), got, want


# the names of _models(), whose TFLite conversions run in a fixture, not at
# collection
MODEL_NAMES = ["dense_relu_softmax", "conv_dw_pool_stack", "strided_valid_conv",
               "shape_manipulation", "elementwise_zoo", "pad_slice_gather",
               "reductions_and_argmax", "pack_stack_resize", "batch_matmul",
               "dynamic_range_quant", "io_names_and_shapes"]


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_matches_jax_frontend(models, name):
    model, xs, atol = models[name]
    (fn, jfn), got, want = _both(model, xs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, atol=atol, rtol=1e-4)
    assert fn.input_names == jfn.input_names and fn.output_names == jfn.output_names
    assert fn.input_shapes == jfn.input_shapes


def test_reader_reads_what_the_jax_reader_reads(models):
    for model, _, _ in models.values():
        ours, theirs = tflite_frontend._parse(model), jtfl._parse(model)
        for a, b in zip(ours[0], theirs[0]):             # tensors
            assert (a.name, a.type, a.buffer) == (b.name, b.type, b.buffer)
            np.testing.assert_array_equal(a.shape, b.shape)
            assert (a.scale is None) == (b.scale is None)
        for a, b in zip(ours[4], theirs[4]):             # operators
            assert a.code == b.code
            np.testing.assert_array_equal(a.inputs, b.inputs)
        for i, t in enumerate(ours[0]):
            got, want = tflite_frontend._const_value(t, ours[1]), jtfl._const_value(
                theirs[0][i], theirs[1])
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(chip_smoke.tfl_cases()))
def test_breadth_every_code_matches_jax(name):
    cases = chip_smoke.tfl_cases()
    model, feeds, outs = cases[name]
    covered = set().union(*(chip_smoke.tfl_codes_of(c[0]) for c in cases.values()))
    assert covered == set(tflite_frontend._OPS)
    got = chip_smoke.run_tfl_case(cases[name], "cpu")
    jfn, jp = jtfl.convert_tflite(model)
    want = _outs(jfn(jp, *[jnp.asarray(a) for _, a in feeds]))
    assert chip_smoke.onnx_worst(got, want, outs) <= 1e-5


@pytest.fixture(scope="module")
def mobilenet():
    """chip_smoke's MobileNetV2 writer at 10 classes, batch norms calibrated."""
    torch.manual_seed(0)
    mod = chip_smoke.VISION_MODELS["mobilenet_v2"](10, width=0.5).eval()
    import torch.nn as nn

    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in mod.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.momentum = 1.0
                m.weight.uniform_(0.5, 1.5, generator=g)
        mod.train()
        mod(torch.randn(4, 3, 64, 64, generator=g))
    return mod.eval()


@pytest.mark.parametrize("int8", [False, True])
def test_mobilenet_writer_through_both_frontends(mobilenet, int8):
    """f32: both frontends and the module (batch norm folded: 1e-4); int8
    per-channel weights: both frontends dequantize the same bytes."""
    model = chip_smoke.mobilenet_v2_tflite(mobilenet, int8=int8)
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32)
    _, got, want = _both(model, [x])
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=1e-4)
    if not int8:
        with torch.no_grad():
            ref = mobilenet(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        assert np.linalg.norm(got[0] - ref) / np.linalg.norm(ref) <= 1e-4


def test_writer_output_reads_with_tensorflows_schema():
    """The test writer's FlatBuffers read by TensorFlow's generated schema:
    the same operator codes, tensors, inputs and outputs the frontend sees."""
    from tensorflow.lite.python import schema_py_generated as S

    for model, _, outs in chip_smoke.tfl_cases().values():
        m = S.ModelT.InitFromObj(S.Model.GetRootAsModel(model, 0))
        sub = m.subgraphs[0]
        tensors, _, g_in, g_out, ops = tflite_frontend._parse(model)
        assert len(sub.tensors) == len(tensors) and len(sub.operators) == len(ops)
        assert [m.operatorCodes[o.opcodeIndex].builtinCode for o in sub.operators] == \
            [o.code for o in ops]
        assert list(sub.inputs) == list(g_in) and list(sub.outputs) == list(g_out)
        assert [sub.tensors[i].name.decode() for i in sub.outputs] == outs


def test_softshrink_plugin_in_a_converted_model():
    model = chip_smoke.plugin_graphs([2, 8, 16, 16])["tflite"]
    code = chip_smoke.PLUGIN_TFLITE_CODE
    with pytest.raises(NotImplementedError, match=str(code)):
        tflite_frontend.convert_tflite(model, device="cpu")
    plugin.register_op(code, chip_smoke.PLUGIN_FNS["tflite"], frontend="tflite")
    try:
        fn, p = tflite_frontend.convert_tflite(model, device="cpu")
        x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 8, 16, 16))
                             .astype(np.float32))
        assert torch.equal(fn(p, x).view(torch.int32),
                           softshrink.softshrink_plain(x, chip_smoke.SOFTSHRINK_LAM)
                           .view(torch.int32))
    finally:
        plugin.unregister_op(code, frontend="tflite")
    assert code not in plugin.registered_ops("tflite")
