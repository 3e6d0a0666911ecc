"""The ONNX frontend of the port against the JAX package's, on the CPU.

* The wire codec (`mnn_tpu_torch/convert/onnx_pb2.py`, no protobuf
  package): bytes that the JAX package's generated `onnx_pb2` writes
  (`google.protobuf`) parse to equal fields and re-serialize to the same
  bytes; the port's bytes parse with `google.protobuf` into an equal
  message; negative int32 / int64 varints, packed and unpacked repeated
  scalars, unknown fields of every wire type, oneofs, subgraphs.
* The op table: the same 129 names as the JAX frontend's. Every op runs in
  `chip_smoke.onnx_cases()`, twelve graphs (If / Loop / Scan bodies
  included) on seeded numpy inputs, through both frontends: integer and bool
  outputs equal with equal dtypes, floats within 1e-5 of JAX (max
  difference over max(1, max |JAX|); the JAX ONNX tests hold 1e-5 to 2e-4
  against their oracles, 1e-3 for convolutions).
* The plugin: the registration rules of the JAX package's `plugin.py`; the
  TF / TFLite / Caffe tables reachable with the JAX tables' entries; the example op
  `MnnTpuSoftShrink` backed by `kernels/softshrink.py`, whose plain version
  must give the bits of the JAX package's Pallas kernel
  (`tests/test_plugin.py:19`, interpret mode) in f32 and in bf16, on inputs
  that straddle lam: JAX rounds lam to bf16 before the subtraction.

The JAX side runs eagerly, as its ONNX tests do, in six fresh JAX-only
processes side by side that read the cases from an `.npz` and write their
outputs to another (eager JAX compiles one executable an op and shape, and
XLA:CPU has segfaulted after about 550 compilations in one process).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from mnn_tpu_torch import plugin
from mnn_tpu_torch.convert import onnx_frontend, onnx_pb2 as P
from mnn_tpu_torch.kernels import softshrink

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = chip_smoke.onnx_cases()
NAMES = sorted(CASES)
TOL = 1e-5
LAM = 0.3            # tests/test_plugin.py's


def softshrink_inputs():
    """The plugin test's (2, 8, 128) normal input, then every bf16 value
    within 0.05 of +-lam: where JAX's rounding of lam shows."""
    x = np.random.default_rng(0).normal(size=(2, 8, 128)).astype(np.float32)
    near = np.arange(0.25, 0.35, 2.0 ** -10, dtype=np.float32)
    ramp = np.concatenate([near, -near, [0.0, -0.0, LAM, -LAM]]).astype(np.float32)
    return x, ramp


# Each job runs in a fresh JAX-only process: it reads the cases (model bytes,
# inputs, static flags, output names) from the .npz the test writes and
# writes JAX's outputs, eagerly, as the JAX ONNX tests run them.
# (balanced by their eager compile time on an 8-core x86 CPU: sample 6.7 s
# of work alone, the plugin's Pallas interpret 3.8 s, each process's JAX
# import about 3.5 s)
JOBS = [["sample"], ["norm_resize", "control_static", "control_dynamic"],
        ["unary", "softshrink"], ["quant_nms", "index"], ["reduce", "shapes", "mlp"],
        ["convnet", "binary"]]
JAX_SIDE = r"""
import json, sys
import numpy as np
import jax.numpy as jnp
from mnn_tpu.convert import onnx_pb2 as JO
from mnn_tpu.convert.onnx_frontend import convert_onnx

src, dst, names = sys.argv[1], sys.argv[2], sys.argv[3].split(",")
out = {}
with np.load(src) as f:
    meta = json.loads(str(f["meta"]))
    for name in names:
        if name == "softshrink":       # the plugin test's Pallas kernel, interpret mode
            from tests.test_plugin import _softshrink_kernel
            run = _softshrink_kernel(meta["lam"])
            for i in range(2):
                for dt in ("float32", "bfloat16"):
                    y = run(jnp.asarray(f[f"softshrink/in/{i}"], dt)).astype(jnp.float32)
                    out[f"softshrink/{i}/{dt}"] = np.asarray(y)
            continue
        fn, params = convert_onnx(JO.ModelProto.FromString(f[name + "/model"].tobytes()))
        args = [f[f"{name}/in/{i}"] if static else jnp.asarray(f[f"{name}/in/{i}"])
                for i, static in enumerate(meta[name]["static"])]
        got = fn(params, *args)
        for o, v in zip(meta[name]["outputs"], got if isinstance(got, tuple) else (got,)):
            out[f"{name}/{o}"] = np.asarray(v)
np.savez(dst, **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    root = tmp_path_factory.mktemp("onnx")
    arrays, meta = {}, {"lam": LAM}
    for name, (model, feeds, outs) in CASES.items():
        arrays[f"{name}/model"] = np.frombuffer(model, np.uint8)
        for i, (_, a, _) in enumerate(feeds):
            arrays[f"{name}/in/{i}"] = a
        meta[name] = {"static": [st for _, _, st in feeds], "outputs": outs}
    for i, x in enumerate(softshrink_inputs()):
        arrays[f"softshrink/in/{i}"] = x
    np.savez(root / "cases.npz", meta=np.asarray(json.dumps(meta)), **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",      # the suite's XLA flags (conftest.py)
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_allow_excess_precision=false")
    procs = []
    for j, job in enumerate(JOBS):      # output to files: a full pipe would stall a job
        with open(root / f"{j}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", JAX_SIDE, str(root / "cases.npz"),
                 str(root / f"{j}.npz"), ",".join(job)],
                env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
    out = {}
    for j, p in enumerate(procs):
        assert p.wait(timeout=600) == 0, (root / f"{j}.log").read_text()[-3000:]
        with np.load(root / f"{j}.npz") as f:
            out.update({k: f[k] for k in f.files})
    return out


# --------------------------------------------------------------------------
# the wire codec
# --------------------------------------------------------------------------

def _rich_model(O):
    """A ModelProto touching every field kind the codec writes, built with
    either package's classes."""
    m = O.ModelProto()
    m.ir_version = 8
    m.producer_name = "codec"
    m.model_version = -3
    m.opset_import.add().version = 17
    op = m.opset_import.add()
    op.domain = "custom"
    op.version = 1
    g = m.graph
    g.name = "g"
    n = g.node.add()
    n.op_type = "Conv"
    n.name = "conv0"
    n.domain = "custom"
    n.input.extend(["x", "w", ""])
    n.output.append("y")
    for name, typ, field, vals in (
            ("pads", O.AttributeProto.INTS, "ints", [1, -1, 2 ** 40, -(2 ** 63)]),
            ("fl", O.AttributeProto.FLOATS, "floats", [0.1, -2.5, 1e30]),
            ("ss", O.AttributeProto.STRINGS, "strings", [b"a", b"", b"\xff\x00"])):
        a = n.attribute.add()
        a.name = name
        a.type = typ
        getattr(a, field).extend(vals)
    a = n.attribute.add()
    a.name, a.type, a.i = "neg", O.AttributeProto.INT, -5
    a = n.attribute.add()
    a.name, a.type, a.f = "alpha", O.AttributeProto.FLOAT, 0.1
    a = n.attribute.add()
    a.name, a.type, a.s = "mode", O.AttributeProto.STRING, b"DCR"
    a = n.attribute.add()
    a.name, a.type = "value", O.AttributeProto.TENSOR
    a.t.dims.extend([2, 2])
    a.t.data_type = O.TensorProto.INT32
    a.t.int32_data.extend([-7, 3, 0, 2 ** 31 - 1])
    sub = O.GraphProto()
    sub.name = "body"
    sub.node.add().op_type = "Relu"
    a = n.attribute.add()
    a.name, a.type = "body", O.AttributeProto.GRAPH
    a.g.CopyFrom(sub)
    a = n.attribute.add()
    a.name, a.type = "branches", O.AttributeProto.GRAPHS
    a.graphs.add().name = "b0"
    a.graphs.add().CopyFrom(sub)
    t = g.initializer.add()
    t.name = "w"
    t.dims.extend([2, 3])
    t.data_type = O.TensorProto.FLOAT
    t.float_data.extend([1, 2, 3, 4, 5, -6.5])
    t.int64_data.extend([-1, 2 ** 40])
    t.double_data.append(1.5)
    t.uint64_data.append(2 ** 63 + 5)
    t.string_data.append(b"s")
    t = g.initializer.add()
    t.name = "raw"
    t.dims.append(3)
    t.data_type = O.TensorProto.INT64
    t.raw_data = np.asarray([1, -2, 3], np.int64).tobytes()
    vi = g.input.add()
    vi.name = "x"
    vi.type.tensor_type.elem_type = O.TensorProto.FLOAT
    vi.type.tensor_type.shape.dim.add().dim_value = 0
    vi.type.tensor_type.shape.dim.add().dim_param = "N"
    g.output.add().name = "y"
    g.value_info.add().name = "h"
    return m


def _varint(v):
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def test_codec_reads_protobuf_bytes_and_writes_them_back():
    from mnn_tpu.convert import onnx_pb2 as G

    jax_bytes = _rich_model(G).SerializeToString()
    got = P.ModelProto.FromString(jax_bytes)
    assert got == _rich_model(P)
    assert got.SerializeToString() == jax_bytes
    n = got.graph.node[0]
    assert [int(v) for v in n.attribute[0].ints] == [1, -1, 2 ** 40, -(2 ** 63)]
    assert n.attribute[3].i == -5 and list(n.attribute[6].t.int32_data)[0] == -7
    assert got.model_version == -3 and got.graph.initializer[0].uint64_data[0] == 2 ** 63 + 5
    dims = got.graph.input[0].type.tensor_type.shape.dim
    assert dims[0].HasField("dim_value") and dims[0].WhichOneof("value") == "dim_value"
    assert dims[1].WhichOneof("value") == "dim_param" and dims[1].dim_param == "N"
    assert n.attribute[7].g.node[0].op_type == "Relu" and len(n.attribute[8].graphs) == 2


def test_codec_bytes_parse_with_protobuf():
    from mnn_tpu.convert import onnx_pb2 as G

    port_bytes = _rich_model(P).SerializeToString()
    assert G.ModelProto.FromString(port_bytes) == _rich_model(G)
    assert port_bytes == _rich_model(G).SerializeToString()


def test_codec_unpacked_repeated_and_unknown_fields():
    """Repeated scalars written unpacked (proto2 style) and fields the
    schema does not know, of each wire type: both parsers agree."""
    from mnn_tpu.convert import onnx_pb2 as G

    data = bytearray(b"\x22\x04Conv")                            # op_type = 4
    for v in (3, -4, 5):                                         # ints = 8, unpacked
        data += _varint(8 << 3 | 0) + _varint(v)
    for v in (0.5, -1.25):                                       # floats = 7, unpacked
        data += _varint(7 << 3 | 5) + np.float32(v).tobytes()
    attr = bytes(b"\x0a\x01k" + data[6:]) + _varint(20 << 3) + _varint(7)
    node = bytearray(b"\x22\x04Conv") + _varint(5 << 3 | 2) + _varint(len(attr)) + attr
    node += _varint(99 << 3 | 0) + _varint(-1)                  # unknown varint
    node += _varint(98 << 3 | 1) + np.float64(2.0).tobytes()     # unknown fixed64
    node += _varint(97 << 3 | 2) + _varint(3) + b"abc"           # unknown length-delimited
    node += _varint(96 << 3 | 5) + np.float32(1.0).tobytes()     # unknown fixed32
    node += b"\x0a\x01x"                                         # input after them
    got, want = P.NodeProto.FromString(bytes(node)), G.NodeProto.FromString(bytes(node))
    a, b = got.attribute[0], want.attribute[0]
    assert list(a.ints) == list(b.ints) == [3, -4, 5]
    assert list(a.floats) == list(b.floats) == [0.5, -1.25]
    assert a.type == b.type == P.AttributeProto.INTS and a.name == b.name == "k"
    assert list(got.input) == list(want.input) == ["x"] and got.op_type == "Conv"


def test_codec_rejects_what_protobuf_rejects():
    n = P.NodeProto()
    with pytest.raises(TypeError):
        n.op_type = 3
    with pytest.raises(AttributeError):
        n.nonexistent = 1
    with pytest.raises(AttributeError):
        n.attribute = []
    a = P.AttributeProto()
    with pytest.raises(TypeError):
        a.i = 1.5
    with pytest.raises(ValueError):
        a.i = 2 ** 63
    with pytest.raises(ValueError):
        P.ModelProto.FromString(b"\x3a\x05ab")          # a truncated graph


@pytest.mark.parametrize("arr", [
    np.arange(6, dtype=np.float32).reshape(2, 3), np.asarray([-1, 2, 3], np.int64),
    np.asarray([[1, -2]], np.int32), np.asarray([True, False]), np.asarray([250, 3], np.uint8),
    np.asarray([-128, 7], np.int8), np.asarray([1.5, -2.25], np.float16),
    np.asarray([0.1, -3.0], np.float64), np.asarray([7, 2 ** 40], np.uint64),
    np.asarray(3.5, np.float32)])
def test_tensor_to_np_raw_and_typed(arr):
    """Raw bytes and the typed fields (float_data, int32_data for the
    narrow types, int64_data, double_data, uint64_data) decode as JAX's
    `tensor_to_np` decodes them."""
    from mnn_tpu.convert import onnx_pb2 as G
    from mnn_tpu.convert.onnx_frontend import tensor_to_np as jax_tensor_to_np

    code = {np.float32: 1, np.uint8: 2, np.int8: 3, np.int32: 6, np.int64: 7, np.bool_: 9,
            np.float16: 10, np.float64: 11, np.uint64: 13}[arr.dtype.type]
    raw = G.TensorProto(dims=arr.shape, data_type=code, raw_data=arr.tobytes())
    typed = G.TensorProto(dims=arr.shape, data_type=code)
    field = {np.float32: "float_data", np.float64: "double_data", np.int64: "int64_data",
             np.uint64: "uint64_data"}.get(arr.dtype.type, "int32_data")
    if arr.dtype != np.float16:         # float16 has no typed field of its own
        getattr(typed, field).extend(arr.ravel().astype(
            np.int64 if arr.dtype == np.bool_ else arr.dtype).tolist())
    for t in (raw, typed) if arr.dtype != np.float16 else (raw,):
        want = jax_tensor_to_np(t)
        got = onnx_frontend.tensor_to_np(P.TensorProto.FromString(t.SerializeToString()))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the op table
# --------------------------------------------------------------------------

def test_op_table_is_the_jax_tables():
    from mnn_tpu.convert import onnx_frontend as jf

    assert sorted(onnx_frontend._OPS) == sorted(jf._OPS)
    assert len(onnx_frontend._OPS) == 129
    covered = set().union(*(chip_smoke.onnx_ops_of(m) for m, _, _ in CASES.values()))
    assert covered == set(onnx_frontend._OPS)


@pytest.mark.parametrize("name", NAMES)
def test_case_matches_jax(ref, name):
    model, feeds, outs = CASES[name]
    got = chip_smoke.run_onnx_case(CASES[name], "cpu")
    want = [ref[f"{name}/{o}"] for o in outs]
    for g, w, o in zip(got, want, outs):
        assert g.shape == w.shape and g.dtype == w.dtype, (o, g.dtype, g.shape, w.dtype, w.shape)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=o)
        else:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=o)
            ok = ~np.isnan(w)
            scale = max(1.0, float(np.abs(w[ok]).max())) if ok.any() else 1.0
            err = float(np.abs(g[ok].astype(np.float64) - w[ok]).max()) / scale if ok.any() else 0
            assert err <= TOL, (o, err)


def test_unknown_op_names_it():
    m = chip_smoke.onnx_model([chip_smoke.onnx_node("FancyCustomOp", ["x"], ["y"])],
                              ["x"], ["y"])
    with pytest.raises(NotImplementedError, match="FancyCustomOp"):
        onnx_frontend.convert_onnx(P.ModelProto.FromString(m), device="cpu")


def test_loop_refuses_a_tensor_condition_and_no_trip_count():
    body = chip_smoke.onnx_graph("b", [chip_smoke.onnx_node("Identity", ["c"], ["c2"]),
                                       chip_smoke.onnx_node("Identity", ["s"], ["s2"])],
                                 ["i", "c", "s"], ["c2", "s2"])
    for ins in (["trip", "cond", "s0"], ["", "cond", "s0"]):
        m = chip_smoke.onnx_model([chip_smoke.onnx_node("Loop", ins, ["sf"], body=body)],
                                  ["cond", "s0"], ["sf"],
                                  [chip_smoke.onnx_tensor("trip", np.asarray(2, np.int64))])
        fn, params = onnx_frontend.convert_onnx(P.ModelProto.FromString(m), device="cpu")
        with pytest.raises(NotImplementedError):
            fn(params, torch.tensor(True), torch.zeros(2))


def test_convert_from_a_file_and_params_on_the_device(tmp_path):
    model, feeds, outs = CASES["mlp"]
    path = tmp_path / "mlp.onnx"
    path.write_bytes(model)
    fn, params = onnx_frontend.convert_onnx(str(path), device="cpu")
    assert fn.input_names == ["x", "q", "k"] and fn.output_names == outs
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in params.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            onnx_frontend.convert_onnx(str(path))


# --------------------------------------------------------------------------
# the plugin
# --------------------------------------------------------------------------

def test_plugin_registration_rules_match_jax():
    from mnn_tpu import plugin as jplugin

    for mod in (plugin, jplugin):
        with pytest.raises(ValueError):
            mod.register_op("Add", lambda ctx, n, a, b: a + b)
        table = mod._table("onnx")
        orig = table["Add"]
        mod.register_op("Add", lambda ctx, n, a, b: a + b, override=True)
        assert table["Add"] is not orig
        mod.register_op("Add", orig, override=True)
        with pytest.raises(ValueError):
            mod.registered_ops("torch")
        mod.unregister_op("NeverRegistered")
    assert plugin.registered_ops() == jplugin.registered_ops()


@pytest.mark.parametrize("frontend", ["tf", "tflite", "caffe"])
def test_plugin_other_frontends_tables_reachable(frontend):
    """The JAX test's check (`tests/test_plugin.py:88-91`): each table is
    reachable and non-empty, here with the JAX table's entries; an op
    registers there and unregisters, and a built-in is not shadowed."""
    from mnn_tpu import plugin as jplugin

    ops = plugin.registered_ops(frontend)
    assert ops and ops == jplugin.registered_ops(frontend)
    if frontend == "tf":
        assert "MaxPool" in ops
    new = 32 if frontend == "tflite" else "MnnTpuSoftShrink"
    plugin.register_op(new, lambda ctx, n, x: x, frontend=frontend)
    try:
        assert new in plugin.registered_ops(frontend)
        with pytest.raises(ValueError):
            plugin.register_op(ops[0], lambda ctx, n, x: x, frontend=frontend)
    finally:
        plugin.unregister_op(new, frontend=frontend)
    assert plugin.registered_ops(frontend) == ops


def test_plugin_softshrink_op_end_to_end(ref):
    """The JAX plugin test on the port: unknown before registration, the
    kernel wrapper's plain version behind it after, gone after unregister."""
    model = P.ModelProto.FromString(chip_smoke.plugin_model())
    with pytest.raises(NotImplementedError, match=chip_smoke.PLUGIN_OP):
        onnx_frontend.convert_onnx(model, device="cpu")
    plugin.register_op(chip_smoke.PLUGIN_OP,
                       lambda ctx, node, x: softshrink.softshrink(ctx.t(x), LAM))
    try:
        fn, params = onnx_frontend.convert_onnx(model, device="cpu")
        x = softshrink_inputs()[0]
        got = fn(params, torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      ref["softshrink/0/float32"].view(np.uint32))
    finally:
        plugin.unregister_op(chip_smoke.PLUGIN_OP)
    assert chip_smoke.PLUGIN_OP not in plugin.registered_ops()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_softshrink_plain_has_the_pallas_kernels_bits(ref, dt):
    tdt = getattr(torch, dt)
    for i, x in enumerate(softshrink_inputs()):
        xt = torch.from_numpy(x).to(tdt)
        got = softshrink.softshrink(xt, LAM).float().numpy()
        want = ref[f"softshrink/{i}/{dt}"]
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if dt == "bfloat16":        # the ramp separates the two rounding points
        xt = torch.from_numpy(softshrink_inputs()[1]).to(tdt).float()
        unrounded = torch.clamp((xt.abs() - LAM).to(tdt), min=0).float() * torch.sign(xt)
        assert not np.array_equal(unrounded.numpy(), ref["softshrink/1/bfloat16"])
