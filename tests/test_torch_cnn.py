"""CNN inference of the port against the JAX package, on the CPU.

`ops/nn_ops.py` op by op, `ops/nms.py`, the torch.fx frontend
(`convert/torch_fx.py`) on the JAX torch.fx test's modules, the three vision
models (`models/vision.py`), `runtime/classify.py`, `utils/benchit.py` and
`cli bench-cnn` / `eval-cls`, each on the same seeded numpy inputs and the
same seeded torch modules as the JAX side.

Bounds: the f32 CNNs (16 classes, 64 x 64, batch 2) within rel-L2 5e-3 of
JAX (`tests/test_torch_fx.py:152`'s bound against torch), the distance
recorded as a test property; in bf16 (params cast as `cli bench-cnn` casts
them) within twice the JAX package's own bf16-vs-f32 distance, measured
here. The fx test modules within the JAX test's tolerances; the ops within
1e-5 (1e-4 for convolutions, the pools' sums and resizes: other summation
orders); NMS indices equal.

The JAX side runs once, in six fresh processes side by side that write
`.npz` files (a model each, the ops, NMS in two, the fx modules with
classification):
the vision models and the fx modules jitted (the JAX torch.fx
tests jit these modules; an eager run of the three CNNs compiles one XLA
executable an op and shape, 47 s against 6 s jitted on an 8-core x86 CPU,
and jit only moves f32 roundings, far inside the bounds), the ops, NMS and the
classification recipe eagerly, as their JAX tests call them.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn as nn

from mnn_tpu_torch import cli
from mnn_tpu_torch.convert.torch_fx import convert_torch_module
from mnn_tpu_torch.models.vision import VISION_MODELS, load_vision
from mnn_tpu_torch.ops import nms as tnms
from mnn_tpu_torch.ops import nn_ops as N
from mnn_tpu_torch.runtime import classify
from mnn_tpu_torch.utils import benchit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CNNS = ["mobilenet_v2", "squeezenet_v1.0", "resnet50"]
CNN_REL = 5e-3
FOLDER = [("a", 40), ("b", 190)]        # classes and their brightness


def cnn_module(name):
    torch.manual_seed(0)
    return VISION_MODELS[name](num_classes=16).eval()


def cnn_input():
    return np.random.default_rng(1).standard_normal((2, 3, 64, 64)).astype(np.float32)


def rng_arrays():
    r = np.random.default_rng(2)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    return dict(x=f(2, 4, 17, 13), w=f(6, 2, 3, 3) * 0.3, b=f(6), xl=f(3, 5, 12),
                wl=f(7, 12), bl=f(7), mean=f(4) * 0.1, var=(r.random(4) + 0.5).astype(np.float32),
                g=(r.random(4) + 0.5).astype(np.float32), beta=f(4), x20=f(1, 2, 20, 7),
                img=r.integers(0, 256, (37, 53, 3), dtype=np.uint8))


def op_cases(M):
    """The op cases over one op library (the port's nn_ops or JAX's)."""
    return {
        "conv2d": lambda a: M.conv2d(a["x"], a["w"], a["b"], stride=2, padding=1, dilation=2,
                                     groups=2),
        "linear": lambda a: M.linear(a["xl"], a["wl"], a["bl"]),
        "batch_norm": lambda a: M.batch_norm(a["x"], a["mean"], a["var"], a["g"], a["beta"]),
        "layer_norm": lambda a: M.layer_norm(a["x"], (17, 13), None, None),
        "max_pool2d": lambda a: M.max_pool2d(a["x"], 3, 2, 1),
        "max_pool2d_ceil": lambda a: M.max_pool2d(a["x"], 3, 2, 0, ceil_mode=True),
        "avg_pool2d": lambda a: M.avg_pool2d(a["x"], 3, 2, 1),
        "avg_pool2d_nopad": lambda a: M.avg_pool2d(a["x"], 3, 2, 1, count_include_pad=False),
        # padding above half the window: past what F.avg_pool2d / F.max_pool2d take
        "avg_pool2d_widepad": lambda a: M.avg_pool2d(a["x"], 3, 1, 2),
        "avg_pool2d_widepad_nopad": lambda a: M.avg_pool2d(a["x"], 3, 1, 2,
                                                           count_include_pad=False),
        "max_pool2d_widepad": lambda a: M.max_pool2d(a["x"], 3, 1, 2),
        "adaptive_avg_pool2d": lambda a: M.adaptive_avg_pool2d(a["x"], (5, 4)),
        "global_avg_pool": lambda a: M.global_avg_pool(a["x"]),
        "resize_nearest_up": lambda a: M.resize_nearest(a["x20"], (50, 16)),
        "resize_nearest_down": lambda a: M.resize_nearest(a["x20"], (9, 4)),
        "resize_bilinear_down": lambda a: M.resize_bilinear(a["x20"], (9, 4)),
        "resize_bilinear_up": lambda a: M.resize_bilinear(a["x20"], (33, 11), align_corners=True),
        "softmax": lambda a: M.softmax(a["x"], axis=1),
        **{f"act_{k}": (lambda a, k=k: M.ACTIVATIONS[k](
            abs(a["x"]) + 0.1 if k in ("log", "sqrt") else a["x"]))
           for k in sorted(N.ACTIVATIONS)},
    }


OPS = sorted(op_cases(N))
LOOSE = {"conv2d", "avg_pool2d", "avg_pool2d_nopad", "avg_pool2d_widepad",
         "avg_pool2d_widepad_nopad", "adaptive_avg_pool2d", "global_avg_pool",
         "resize_bilinear_down", "resize_bilinear_up", "linear"}
NMS = [(300, 0.5, 0.1, 50), (40, 0.3, 0.0, 100), (500, 0.7, 0.5, 400)]


def nms_inputs(n, seed):
    r = np.random.default_rng(seed)
    xy = r.uniform(0, 100, (n, 2)).astype(np.float32)
    wh = r.uniform(5, 40, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], 1), r.random(n).astype(np.float32)


def fx_modules():
    """The JAX torch.fx test's modules and shapes, (module, shape, rtol, atol)."""
    sys.path.insert(0, REPO)
    from tests.test_torch_fx import InvertedResidual, ResBlock, SmallCNN

    torch.manual_seed(0)
    return {
        "conv_bn_relu": (nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.BatchNorm2d(8),
                                       nn.ReLU()), (2, 3, 16, 16), 2e-4, 2e-4),
        "depthwise": (nn.Conv2d(8, 8, 3, padding=1, groups=8), (1, 8, 12, 12), 2e-4, 2e-4),
        "strided_dilated": (nn.Conv2d(4, 6, 3, stride=2, padding=2, dilation=2),
                            (1, 4, 17, 17), 2e-4, 2e-4),
        "pools": (nn.Sequential(nn.MaxPool2d(3, stride=2, padding=1), nn.AvgPool2d(2),
                                nn.AdaptiveAvgPool2d(1)), (1, 4, 9, 9), 2e-4, 2e-4),
        "inverted_residual": (InvertedResidual(8), (1, 8, 10, 10), 1e-3, 1e-4),
        "resblock": (ResBlock(8, 16, 2), (1, 8, 12, 12), 1e-3, 1e-4),
        "small_cnn": (SmallCNN(), (2, 3, 32, 32), 2e-3, 1e-3),
        "linear_mlp": (nn.Sequential(nn.Linear(12, 24), nn.GELU(), nn.LayerNorm(24),
                                     nn.Linear(24, 5)), (3, 12), 1e-3, 1e-4),
    }


def fx_input(shape):
    return np.random.default_rng(3).standard_normal(shape).astype(np.float32)


def make_folder(root):
    from PIL import Image

    for cls, level in FOLDER:
        d = os.path.join(root, cls)
        os.makedirs(d, exist_ok=True)
        for j in range(3):
            arr = np.random.default_rng(10 + j).integers(0, 60, (32 + 4 * j, 40, 3)) + level
            Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
                os.path.join(d, f"{j}.png"))


def _jax_cnn(path, name):
    """One vision model through the JAX torch.fx frontend, jitted, in f32
    and with bf16 params and input."""
    import jax
    import jax.numpy as jnp

    from mnn_tpu.convert.torch_fx import convert_torch_module as jconvert

    x = cnn_input()
    fn, params = jconvert(cnn_module(name))
    f = jax.jit(fn)
    pb = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, params)
    np.savez(path, **{f"{name}/f32": np.asarray(f(params, jnp.asarray(x))),
                      f"{name}/bf16": np.asarray(f(pb, jnp.asarray(x, jnp.bfloat16)), np.float32)})


def _jax_ops(path):
    """nn_ops, eagerly."""
    import jax.numpy as jnp

    from mnn_tpu.ops import nn_ops as JN

    a = {k: jnp.asarray(v) for k, v in rng_arrays().items()}
    np.savez(path, **{f"op/{name}": np.asarray(fn(a)) for name, fn in op_cases(JN).items()})


def _jax_nms(path, which):
    """box_iou and NMS of the cases `which`, eagerly (each NMS call compiles
    its fori_loop: about 2 s)."""
    import jax.numpy as jnp

    from mnn_tpu.ops import nms as jnms

    out = {}
    for i in which:
        n, iou, sth, mo = NMS[i]
        b, s = nms_inputs(n, 20 + i)
        idx, valid = jnms.nms(jnp.asarray(b), jnp.asarray(s), iou, sth, mo)
        out[f"nms/{i}"] = np.asarray(idx)
        out[f"nms_valid/{i}"] = np.asarray(valid)
        out[f"iou/{i}"] = np.asarray(jnms.box_iou(jnp.asarray(b[:50]), jnp.asarray(b[50:90])))
    np.savez(path, **out)


def _jax_fx_classify(path, folder):
    """The fx test modules jitted, as the JAX torch.fx tests run them; the
    classification recipe as the JAX classify tests call it."""
    import jax
    import jax.numpy as jnp

    from mnn_tpu.convert.torch_fx import convert_torch_module as jconvert
    from mnn_tpu.runtime import classify as jclassify

    out = {}
    for name, (mod, shape, _, _) in fx_modules().items():
        fn, params = jconvert(mod)
        out[f"fx/{name}"] = np.asarray(jax.jit(fn)(params, jnp.asarray(fx_input(shape))))
    img = rng_arrays()["img"]
    out["pre/224"] = jclassify.preprocess_classification(img)
    out["pre/32"] = jclassify.preprocess_classification(img, size=32, crop_pct=0.75)
    if folder:
        r = jclassify.eval_folder(lambda x: jnp.stack([-x.mean((1, 2, 3)), x.mean((1, 2, 3))], 1),
                                  folder, size=32, k=1, batch_size=4)
        out["folder"] = np.asarray(json.dumps(r))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    root = tmp_path_factory.mktemp("cnn")
    folder = ""
    try:
        folder = str(root / "images")
        make_folder(folder)
    except ImportError:
        folder = ""
    env = dict(os.environ, JAX_PLATFORMS="cpu",      # the suite's XLA flags (conftest.py)
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_allow_excess_precision=false")
    npz = lambda stem: repr(str(root / f"{stem}.npz"))
    calls = {f"cnn{i}": f"m._jax_cnn({npz(f'cnn{i}')}, {name!r})" for i, name in enumerate(CNNS)}
    calls.update(ops=f"m._jax_ops({npz('ops')})", nms0=f"m._jax_nms({npz('nms0')}, [0, 1])",
                 nms1=f"m._jax_nms({npz('nms1')}, [2])",
                 fx=f"m._jax_fx_classify({npz('fx')}, {folder!r})")
    # side by side, one fresh process a job, balanced by their compile time
    # on an 8-core x86 CPU (about 6 s of imports each; work: MobileNetV2 7 s,
    # ResNet-50 6, the ops 5, SqueezeNet 4, an NMS call 2, the fx modules 3)
    jobs = [["cnn0"], ["cnn2"], ["ops"], ["cnn1"], ["nms0"], ["nms1", "fx"]]
    procs = []
    for j, job in enumerate(jobs):      # output to files: a full pipe would stall a job
        code = (f"import sys; sys.path.insert(0, {REPO!r})\n"
                "import jax; jax.config.update('jax_platforms', 'cpu')\n"
                "import tests.test_torch_cnn as m\n" + "\n".join(calls[k] for k in job) + "\n")
        with open(root / f"{j}.log", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                                          stdout=log, stderr=subprocess.STDOUT))
    out = {"folder_path": folder}
    for j, (job, p) in enumerate(zip(jobs, procs)):
        assert p.wait(timeout=600) == 0, (root / f"{j}.log").read_text()[-3000:]
        for key in job:
            with np.load(root / f"{key}.npz") as f:
                out.update({k: f[k] for k in f.files})
    return out


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


# --------------------------------------------------------------------------
# ops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", OPS)
def test_nn_op_matches_jax(ref, name):
    a = {k: torch.from_numpy(v) for k, v in rng_arrays().items()}
    got = op_cases(N)[name](a).numpy()
    want = ref[f"op/{name}"]
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 1e-4 if name in LOOSE else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("i", range(len(NMS)))
def test_nms_matches_jax(ref, i):
    n, iou, sth, mo = NMS[i]
    b, s = nms_inputs(n, 20 + i)
    idx, valid = tnms.nms(torch.from_numpy(b), torch.from_numpy(s), iou, sth, mo)
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), ref[f"nms/{i}"])
    np.testing.assert_array_equal(valid.numpy(), ref[f"nms_valid/{i}"])
    iou_m = tnms.box_iou(torch.from_numpy(b[:50]), torch.from_numpy(b[50:90])).numpy()
    np.testing.assert_array_equal(iou_m, ref[f"iou/{i}"])


# --------------------------------------------------------------------------
# the torch.fx frontend and the vision models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(fx_modules()))
def test_fx_module_matches_jax(ref, name):
    mod, shape, rtol, atol = fx_modules()[name]
    fn, params = convert_torch_module(mod, device="cpu")
    with torch.no_grad():
        got = fn(params, torch.from_numpy(fx_input(shape))).numpy()
        direct = mod(torch.from_numpy(fx_input(shape))).numpy()
    np.testing.assert_allclose(got, ref[f"fx/{name}"], rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, direct, rtol=rtol, atol=atol)


def test_fx_unsupported_module_names_it():
    class Odd(nn.Module):
        def __init__(self):
            super().__init__()
            self.op = nn.Fold(output_size=(4, 4), kernel_size=(2, 2))

        def forward(self, x):
            return self.op(x)

    fn, params = convert_torch_module(Odd(), device="cpu")
    with pytest.raises(NotImplementedError, match="Fold"):
        fn(params, torch.ones(1, 12, 9))


def test_fx_params_are_copies_on_the_device():
    mod = cnn_module("squeezenet_v1.0")
    fn, params = convert_torch_module(mod, device="cpu")
    w = params["features.0"]["weight"]
    assert w.data_ptr() != mod.features[0].weight.data_ptr() and not w.requires_grad
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            convert_torch_module(mod)


@pytest.mark.parametrize("name", CNNS)
def test_cnn_f32_matches_jax(ref, name, record_property):
    fn, params = convert_torch_module(cnn_module(name), device="cpu")
    with torch.no_grad():
        got = fn(params, torch.from_numpy(cnn_input())).numpy()
    d = rel(got, ref[f"{name}/f32"])
    record_property("rel_l2_to_jax", d)
    assert got.shape == (2, 16) and d < CNN_REL, d


@pytest.mark.parametrize("name", CNNS)
def test_cnn_bf16_within_twice_jax(ref, name, record_property):
    fn, params = convert_torch_module(cnn_module(name), device="cpu")
    with torch.no_grad():
        got = fn(cli._bf16_params(params),
                 torch.from_numpy(cnn_input()).to(torch.bfloat16)).float().numpy()
    d_jax = rel(ref[f"{name}/bf16"], ref[f"{name}/f32"])
    d = rel(got, ref[f"{name}/f32"])
    record_property("rel_l2_bf16", d)
    record_property("rel_l2_bf16_jax", d_jax)
    assert 0 < d <= 2 * d_jax, (d, d_jax)


def test_load_vision_on_the_cpu():
    torch.manual_seed(0)
    fn, params = load_vision("squeezenet_v1.0", 16, device="cpu")
    out = fn(params, torch.zeros(1, 3, 64, 64))
    assert out.shape == (1, 16) and params["features.0"]["weight"].device.type == "cpu"
    assert sorted(VISION_MODELS) == sorted(["mobilenet_v2", "squeezenet_v1.0", "resnet50"])


# --------------------------------------------------------------------------
# classification, benchit, the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("size,crop", [(224, 0.875), (32, 0.75)])
def test_preprocess_matches_jax(ref, size, crop):
    got = classify.preprocess_classification(rng_arrays()["img"], size=size, crop_pct=crop,
                                             device="cpu")
    want = ref[f"pre/{size}"]
    assert got.shape == want.shape == (3, size, size)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_topk_eval_oracle_and_padding():
    """A classifier that reads the label planted in the image scores 1.0;
    the last partial batch's padding is excluded (the JAX test's case)."""
    rng = np.random.default_rng(0)
    images, labels = [], []
    for _ in range(10):
        lab = int(rng.integers(0, 4))
        img = np.zeros((3, 8, 8), np.float32)
        img[0, 0, 0] = lab
        images.append(img)
        labels.append(lab)
    seen = []

    def model(x):
        seen.append(x.shape[0])
        return torch.eye(4)[x[:, 0, 0, 0].long()] * 10.0

    r = classify.topk_eval(model, images, labels, k=2, batch_size=4, device="cpu")
    assert r == {"top1": 1.0, "topk": 1.0, "k": 2, "n": 10} and seen == [4, 4, 4]
    r = classify.topk_eval(lambda x: torch.tensor([5.0, 4.0, 0.0, 0.0]).repeat(x.shape[0], 1),
                           [np.full((3, 4, 4), float(i), np.float32) for i in range(6)],
                           [1] * 6, k=2, batch_size=3, device="cpu")
    assert r["top1"] == 0.0 and r["topk"] == 1.0


def test_eval_folder_matches_jax(ref):
    pytest.importorskip("PIL")
    r = classify.eval_folder(lambda x: torch.stack([-x.mean((1, 2, 3)), x.mean((1, 2, 3))], 1),
                             ref["folder_path"], size=32, k=1, batch_size=4, device="cpu")
    assert r == json.loads(str(ref["folder"])) and r["n"] == 6 and r["top1"] == 1.0


def test_benchit_on_the_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2.0

    x = torch.ones(4, 4)
    t = benchit.chain(fn, x, iters=5, warmup=2)
    assert t > 0 and len(calls) == 3 * 6
    assert benchit.sync({"a": [x]}) == {"a": [x]}
    assert benchit.once(fn, x) > 0


def test_cli_bench_cnn_on_the_cpu(capsys, monkeypatch):
    """The command's plumbing (seeded module, fx conversion, bf16 params,
    `chain`, one JSON line a model) over a small registered CNN: bf16
    convolutions on a CPU vary too much in time (0.5 to 15 s have been seen
    for SqueezeNet's 63 calls) for a test of the real models here."""
    from mnn_tpu_torch.models import vision

    monkeypatch.setitem(vision.VISION_MODELS, "small_cnn", lambda num_classes=1000: nn.Sequential(
        nn.Conv2d(3, 8, 3, 2, 1), nn.BatchNorm2d(8), nn.ReLU6(), nn.AdaptiveAvgPool2d(1),
        nn.Flatten(), nn.Linear(8, num_classes)))
    cli.main(["bench-cnn", "--models", "small_cnn", "--batch", "2", "--size", "32",
              "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rep) == {"model", "batch", "latency_ms", "images_per_s"}
    assert rep["model"] == "small_cnn" and rep["batch"] == 2 and rep["latency_ms"] > 0
    assert rep["images_per_s"] > 0


def test_cli_eval_cls_on_the_cpu(ref, capsys):
    pytest.importorskip("PIL")
    cli.main(["eval-cls", "--dir", ref["folder_path"], "--net", "squeezenet_v1.0",
              "--size", "32", "--k", "1", "--batch", "4", "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["net"] == "squeezenet_v1.0" and rep["n"] == 6 and rep["k"] == 1
    assert 0.0 <= rep["top1"] <= 1.0
