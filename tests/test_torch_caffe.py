"""The Caffe frontend of the port against the JAX package's, on the CPU.

* The codec (`mnn_tpu_torch/convert/caffe_pb2.py` on `protowire.py`, no
  protobuf package): the bytes `google.protobuf` writes for the JAX
  package's generated `caffe_pb2` (proto2: presence, `[default = ...]`,
  unpacked repeated scalars, packed float blobs, uint32), read back equal
  both ways; the text-format reader against `text_format.Parse(...,
  allow_unknown_field=True)` on prototxts with comments, unknown nested
  blocks, enums, escapes, lists and `inf`.
* The converter: every case of `tests/test_caffe.py` built once with the
  port's codec, fed the same seeded numpy inputs through the JAX frontend
  and the port's on `device="cpu"`, at that test's tolerances; SqueezeNet
  1.0's deploy prototxt with a caffemodel of `models/vision`'s weights;
  `chip_smoke.caffe_cases()`, one graph that reaches every layer type of
  the table (1e-5, ints equal).
* A softshrink plugin in the `caffe` table inside a converted net.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from google.protobuf import text_format

import chip_smoke
from mnn_tpu.convert import caffe_pb2 as JC
from mnn_tpu.convert.caffe_frontend import convert_caffe as jax_convert
from mnn_tpu_torch import plugin
from mnn_tpu_torch.convert import caffe_frontend, caffe_pb2 as C
from mnn_tpu_torch.kernels import softshrink

L = chip_smoke.caffe_layer


def _net(shape, name="t"):
    net = C.NetParameter(name=name)
    net.input.append("data")
    net.input_shape.add().dim.extend(shape)
    return net


def _run_both(net, x, caffemodel=None):
    """The JAX frontend on the bytes read by protobuf, the port's on its own."""
    jnet = JC.NetParameter.FromString(net.SerializeToString())
    jfn, jp = jax_convert(jnet, caffemodel)
    want = jfn(jp, jnp.asarray(x))
    fn, p = caffe_frontend.convert_caffe(net, caffemodel, device="cpu")
    got = fn(p, torch.from_numpy(x))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


# --------------------------------------------------------------------------
# the cases of tests/test_caffe.py: (net, input, caffemodel, atol, rtol)
# --------------------------------------------------------------------------

def _lenet(rng):
    net = _net((2, 1, 12, 12))
    L(net, "conv1", "Convolution", ["data"], ["conv1"],
      [rng.standard_normal((4, 1, 3, 3), np.float32) * 0.3,
       rng.standard_normal(4, np.float32) * 0.1],
      convolution_param=dict(num_output=4, kernel_size=[3], stride=[1]))
    L(net, "relu1", "ReLU", ["conv1"], ["conv1"])                       # in place
    L(net, "pool1", "Pooling", ["conv1"], ["pool1"],
      pooling_param=dict(pool=C.PoolingParameter.MAX, kernel_size=2, stride=2))
    L(net, "ip1", "InnerProduct", ["pool1"], ["ip1"],
      [rng.standard_normal((7, 100), np.float32) * 0.1, rng.standard_normal(7, np.float32) * 0.1],
      inner_product_param=dict(num_output=7))
    L(net, "prob", "Softmax", ["ip1"], ["prob"])
    return net, rng.standard_normal((2, 1, 12, 12), np.float32), None, 1e-5, 1e-4


def _pool(shape, atol, **pp):
    def build(rng):
        net = _net(shape)
        L(net, "p", "Pooling", ["data"], ["p"], pooling_param=pp)
        return net, rng.standard_normal(shape, np.float32), None, atol, 1e-7
    return build


def _reshape_axis_span(rng):
    net = _net((2, 6, 2, 2))
    L(net, "r", "Reshape", ["data"], ["r"], reshape_param=dict(shape={"dim": [0, -1]}, axis=1))
    return net, rng.standard_normal((2, 6, 2, 2), np.float32), None, 0, 1e-7


def _batchnorm_scale(rng):
    net = _net((2, 4, 6, 6))
    mean = rng.standard_normal(4, np.float32)
    var = np.abs(rng.standard_normal(4, np.float32)) + 0.5
    L(net, "bn", "BatchNorm", ["data"], ["bn"], [mean * 2.0, var * 2.0, np.float32([2.0])])
    L(net, "scale", "Scale", ["bn"], ["scale"],
      [rng.standard_normal(4, np.float32), rng.standard_normal(4, np.float32)],
      scale_param=dict(bias_term=True))
    return net, rng.standard_normal((2, 4, 6, 6), np.float32), None, 1e-4, 1e-3


def _eltwise_grouped_conv(rng):
    net = _net((1, 4, 5, 5))
    L(net, "g", "Convolution", ["data"], ["g"], [rng.standard_normal((4, 2, 3, 3), np.float32) * 0.3],
      convolution_param=dict(num_output=4, kernel_size=[3], pad=[1], group=2, bias_term=False))
    L(net, "sum", "Eltwise", ["data", "g"], ["sum"], eltwise_param=dict(coeff=[0.5, 2.0]))
    return net, rng.standard_normal((1, 4, 5, 5), np.float32), None, 1e-5, 1e-7


def _lrn(rng):
    net = _net((1, 8, 4, 4))
    L(net, "n", "LRN", ["data"], ["n"], lrn_param=dict(local_size=5, alpha=1e-3, beta=0.75))
    return net, rng.standard_normal((1, 8, 4, 4), np.float32), None, 1e-5, 1e-4


PROTOTXT = """
name: "toy"
input: "data"
input_shape { dim: 1 dim: 2 dim: 4 dim: 4 }
layer {
  name: "c" type: "Convolution" bottom: "data" top: "c"
  convolution_param {
    num_output: 3 kernel_size: 3 pad: 1
    weight_filler { type: "xavier" }   # unknown field: skipped
  }
}
layer { name: "r" type: "ReLU" bottom: "c" top: "c" }
"""


def _prototxt_with_caffemodel(rng):
    net = caffe_frontend.load_prototxt(PROTOTXT)
    wnet = C.NetParameter()
    L(wnet, "c", "Convolution", [], [], [rng.standard_normal((3, 2, 3, 3), np.float32) * 0.2,
                                         rng.standard_normal(3, np.float32) * 0.1])
    return net, rng.standard_normal((1, 2, 4, 4), np.float32), wnet.SerializeToString(), 1e-5, 1e-7


def _slice_concat_flatten(rng):
    net = _net((1, 6, 2, 2))
    L(net, "s", "Slice", ["data"], ["a", "b"], slice_param=dict(axis=1, slice_point=[2]))
    L(net, "cat", "Concat", ["b", "a"], ["cat"])
    L(net, "fl", "Flatten", ["cat"], ["out"])
    return net, rng.standard_normal((1, 6, 2, 2), np.float32), None, 0, 1e-7


def _deconvolution(rng):
    net = _net((1, 3, 5, 5))
    L(net, "d", "Deconvolution", ["data"], ["d"],
      [rng.standard_normal((3, 4, 4, 4), np.float32) * 0.2, rng.standard_normal(4, np.float32) * 0.1],
      convolution_param=dict(num_output=4, kernel_size=[4], stride=[2], pad=[1]))
    return net, rng.standard_normal((1, 3, 5, 5), np.float32), None, 1e-5, 1e-7


CASES = {
    "lenet_ceil_pool_ip_softmax": _lenet,
    "ceil_pooling_odd_size": _pool((1, 2, 5, 5), 1e-6, pool=C.PoolingParameter.MAX,
                                   kernel_size=2, stride=2),
    "ave_pool_floor_mode_with_pad": _pool((1, 2, 6, 6), 1e-5, pool=C.PoolingParameter.AVE,
                                          kernel_size=3, stride=2, pad=1,
                                          round_mode=C.PoolingParameter.FLOOR),
    "reshape_axis_span": _reshape_axis_span,
    "ave_pool_with_pad": _pool((1, 3, 8, 8), 1e-5, pool=C.PoolingParameter.AVE,
                               kernel_size=3, stride=2, pad=1),
    "batchnorm_scale": _batchnorm_scale,
    "eltwise_grouped_conv": _eltwise_grouped_conv,
    "lrn_across_channels": _lrn,
    "prototxt_with_caffemodel": _prototxt_with_caffemodel,
    "slice_concat_flatten": _slice_concat_flatten,
    "deconvolution": _deconvolution,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_frontend(name):
    net, x, model, atol, rtol = CASES[name](np.random.default_rng(sorted(CASES).index(name)))
    got, want = _run_both(net, x, model)
    assert len(got) == len(want) == 1
    assert got[0].shape == want[0].shape and got[0].dtype == want[0].dtype
    np.testing.assert_allclose(got[0], want[0], atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", sorted(chip_smoke.caffe_cases()))
def test_breadth_every_layer_type_matches_jax(name):
    cases = chip_smoke.caffe_cases()
    net, feeds, outs = cases[name]
    covered = set().union(*(chip_smoke.caffe_types_of(c[0]) for c in cases.values()))
    assert covered == set(caffe_frontend._LAYERS)
    got = chip_smoke.run_caffe_case(cases[name], "cpu")
    jfn, jp = jax_convert(JC.NetParameter.FromString(net))
    want = jfn(jp, *[jnp.asarray(a) for _, a in feeds])
    assert chip_smoke.onnx_worst(got, [np.asarray(w) for w in want], outs) <= 1e-5


def test_squeezenet_deploy_net_matches_jax():
    """The published deploy prototxt (227 x 227) and a caffemodel of the
    seeded module, both frontends, batch 1: the softmax output."""
    torch.manual_seed(0)
    mod = chip_smoke.VISION_MODELS["squeezenet_v1.0"](16).eval()
    proto = chip_smoke.squeezenet_prototxt(1).replace("num_output: 1000", "num_output: 16")
    model = chip_smoke.squeezenet_caffemodel(mod)
    x = np.random.default_rng(5).standard_normal((1, 3, 227, 227)).astype(np.float32)
    jfn, jp = jax_convert(proto, model)
    want = np.asarray(jfn(jp, jnp.asarray(x)))
    fn, p = caffe_frontend.convert_caffe(proto, model, device="cpu")
    got = fn(p, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 16, 1, 1)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4)
    with torch.no_grad():
        ref = torch.softmax(mod(torch.from_numpy(x)), -1).numpy()
    np.testing.assert_allclose(got.reshape(1, -1), ref, atol=1e-6, rtol=1e-4)


# --------------------------------------------------------------------------
# the codec
# --------------------------------------------------------------------------

def _fill(net, P):
    """The same NetParameter in either codec (P: a caffe_pb2 module)."""
    net.name = "codec"
    net.input.extend(["data", "aux"])
    net.input_dim.extend([1, 3, -2, 7])
    net.input_shape.add().dim.extend([1, 3, 5, 5])
    layer = net.layer.add()
    layer.name, layer.type = "conv", "Convolution"
    layer.bottom.append("data")
    layer.top.append("conv")
    b = layer.blobs.add()
    b.shape.dim.extend([2, 3])
    b.data.extend([0.5, -1.25, 3.0e-7, 1e30, -0.0, 2.0])
    b2 = layer.blobs.add()
    b2.num, b2.channels = 0, 2                  # set to the default: present all the same
    b2.data.extend([1.0, 2.0])
    cp = layer.convolution_param
    cp.num_output = 4000000000                  # uint32 above int32
    cp.bias_term = True
    cp.pad.extend([1, 2])                       # repeated uint32: unpacked in proto2
    cp.kernel_size.append(3)
    cp.group = 1
    cp.dilation.extend([1])
    pool = net.layer.add(name="pool", type="Pooling")
    pool.pooling_param.pool = P.PoolingParameter.AVE
    pool.pooling_param.round_mode = P.PoolingParameter.CEIL
    pool.pooling_param.global_pooling = False
    bn = net.layer.add(name="bn", type="BatchNorm")
    bn.batch_norm_param.eps = 1e-3
    bn.batch_norm_param.use_global_stats = True
    el = net.layer.add(name="e", type="Eltwise")
    el.eltwise_param.coeff.extend([0.5, -2.0])
    el.eltwise_param.operation = P.EltwiseParameter.PROD
    net.layer.add(name="reshape", type="Reshape").reshape_param.num_axes = -1
    return net


def test_codec_writes_protobufs_bytes_and_reads_them_back():
    ours = _fill(C.NetParameter(), C).SerializeToString()
    theirs = _fill(JC.NetParameter(), JC).SerializeToString()
    assert ours == theirs
    back = C.NetParameter.FromString(theirs)
    assert back.SerializeToString() == theirs
    assert JC.NetParameter.FromString(ours) == JC.NetParameter.FromString(theirs)
    assert back.layer[0].convolution_param.num_output == 4000000000


def test_codec_proto2_defaults_and_presence():
    for P in (C, JC):
        cp = P.ConvolutionParameter()
        assert cp.bias_term is True and cp.group == 1 and not cp.HasField("group")
        cp.group = 1
        assert cp.HasField("group") and cp.SerializeToString() == b"\x28\x01"
        pp = P.PoolingParameter()
        assert pp.round_mode == P.PoolingParameter.CEIL and pp.stride == 1
        assert abs(P.BatchNormParameter().eps - 1e-5) < 1e-12
        assert P.ReshapeParameter().num_axes == -1 and P.LRNParameter().beta == 0.75
    ours, theirs = C.BatchNormParameter(), JC.BatchNormParameter()
    assert ours.eps == theirs.eps and ours.moving_average_fraction == theirs.moving_average_fraction


def test_codec_reads_packed_blobs_in_bulk():
    data = np.random.default_rng(0).standard_normal(1 << 20).astype(np.float32)
    blob = JC.BlobProto()
    blob.data.extend(data.tolist())
    b = C.BlobProto.FromString(blob.SerializeToString())
    assert isinstance(b.data._items, np.ndarray)             # np.frombuffer, not a loop
    np.testing.assert_array_equal(np.asarray(b.data), data)
    again = C.BlobProto()
    again.data.extend(data)                                    # a numpy array kept as one
    assert again.SerializeToString() == blob.SerializeToString()


TEXTS = [
    PROTOTXT,
    chip_smoke.squeezenet_prototxt(10),
    """# comments, enums, escapes, lists, the optional colon, <...> blocks
name: 'it\\'s "quoted"\\n\\x41\\101'
input: ["a", "b"]
input_dim: [1, 2]
layer: {
  name: "p" type: "Pooling"
  pooling_param < pool: AVE kernel_size: 3 round_mode: FLOOR >;
  include { phase: TEST }
  param { lr_mult: 1.0 decay_mult: 0 }
}
layer {
  name: "bn"; type: "BatchNorm",
  batch_norm_param { eps: 1e-5 moving_average_fraction: 9.5e-1 }
  relu_param { negative_slope: -inf }
  unknown_scalar: 3
  unknown_list: [1, 2, 3]
  unknown_block { deeper { deepest: "x" } }
}
layer { name: "e" type: "Eltwise" eltwise_param { operation: MAX coeff: 1 coeff: 2.5e0 } }
layer { name: "pw" type: "Power" power_param { power: inf shift: -0.25f } }
""",
]


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_text_format_reader_matches_protobuf(i):
    ours = caffe_frontend.load_prototxt(TEXTS[i])
    theirs = JC.NetParameter()
    text_format.Parse(TEXTS[i], theirs, allow_unknown_field=True)
    assert ours.SerializeToString() == theirs.SerializeToString()


# --------------------------------------------------------------------------
# the plugin
# --------------------------------------------------------------------------

def test_softshrink_plugin_in_a_converted_net():
    graph = chip_smoke.plugin_graphs([2, 8, 16, 16])["caffe"]
    net = C.NetParameter.FromString(graph)
    with pytest.raises(NotImplementedError, match=chip_smoke.PLUGIN_OP):
        caffe_frontend.convert_caffe(net, device="cpu")
    plugin.register_op(chip_smoke.PLUGIN_OP, chip_smoke.PLUGIN_FNS["caffe"], frontend="caffe")
    try:
        fn, p = caffe_frontend.convert_caffe(net, device="cpu")
        x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 8, 16, 16))
                             .astype(np.float32))
        assert torch.equal(fn(p, x).view(torch.int32),
                           softshrink.softshrink_plain(x, chip_smoke.SOFTSHRINK_LAM)
                           .view(torch.int32))
    finally:
        plugin.unregister_op(chip_smoke.PLUGIN_OP, frontend="caffe")
    assert chip_smoke.PLUGIN_OP not in plugin.registered_ops("caffe")
