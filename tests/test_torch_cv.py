"""The port's `cv/` library and its native ctypes wrapper against the JAX
package, on the CPU.

Every function runs on the same seeded numpy inputs through the JAX package
(eagerly, as its own tests call it: one XLA computation an op, so no fused
multiply-add changes a rounding) and through the port on CPU tensors. The
JAX side runs once, in a module-scoped fixture. Bounds:

* integer outputs (colour conversions, thresholds, histograms, morphology,
  connected-component labels and stats, drawing): equal;
* resampled uint8 (`warp_affine`, `resize`, `ImageProcess`): within one
  level;
* float outputs (filters, integral images, blends): rel-L2 1e-5;
* `solve_pnp`: the pose within 1e-3 of JAX's.

The adaptive mean threshold takes c = 2.5: with an integer c, a pixel equal
to its window's mean - c is a tie that the order of the window's sum
decides (the JAX package's and PyTorch's convolutions sum in other
orders). The Gaussian method with block 5 has dyadic weights and is exact.

The native wrapper: `StFile` reads the same bytes as `convert/stfile.py`;
`NativeNgramIndex` proposes what the JAX package's wrapper (and the port's
`NgramDraft`) propose over one token stream; the lookahead takes it.
"""

import types

import numpy as np
import pytest
import torch

from mnn_tpu.cv import calib3d as jcalib
from mnn_tpu.cv import color as jcolor
from mnn_tpu.cv import draw as jdraw
from mnn_tpu.cv import filter as jfilter
from mnn_tpu.cv import geometric as jgeo
from mnn_tpu.cv import histogram as jhist
from mnn_tpu.cv import image_process as jip
from mnn_tpu.cv import structural as jstruct
from mnn_tpu.utils import native as jnative
from mnn_tpu_torch.convert import stfile
from mnn_tpu_torch.cv import calib3d, color, draw, filter, geometric, histogram, image_process
from mnn_tpu_torch.cv import structural
from mnn_tpu_torch.runtime import speculative
from mnn_tpu_torch.utils import native
from tests.test_torch_decoder import rel

J = types.SimpleNamespace(color=jcolor, geo=jgeo, filter=jfilter, hist=jhist, struct=jstruct,
                          ip=jip)
P = types.SimpleNamespace(color=color, geo=geometric, filter=filter, hist=histogram,
                          struct=structural, ip=image_process)

rng = np.random.default_rng(22)
IMG = rng.integers(0, 256, (24, 36, 3), dtype=np.uint8)
GRAY = rng.integers(0, 256, (24, 36), dtype=np.uint8)
FIMG = rng.random((24, 36, 3), dtype=np.float32)
IMG2 = rng.integers(0, 256, (24, 36, 3), dtype=np.uint8)
MASK = (rng.random((24, 36)) > 0.5).astype(np.uint8)
BINARY = (rng.random((40, 56)) > 0.45).astype(np.uint8)
NV_Y = rng.integers(0, 256, (24, 36), dtype=np.uint8)
NV_UV = rng.integers(0, 256, (12, 18, 2), dtype=np.uint8)
ROT = jgeo.get_affine_transform((18.0, 12.0), 30.0, 0.9, (1.5, -2.0))
CROSS = np.asarray(jfilter.get_structuring_element(jfilter.MORPH_CROSS, (3, 3)))
ELLIPSE = np.asarray(jfilter.get_structuring_element(jfilter.MORPH_ELLIPSE, (5, 7)))
SHARPEN = np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]], np.float32)

# name -> (kind, fn(m, a)); `m` is J or P, `a` turns a numpy input into the
# side's own (numpy for JAX, a CPU tensor for the port)
CASES = {
    "rgb_to_bgr": ("int", lambda m, a: m.color.rgb_to_bgr(a(IMG))),
    "rgb_to_gray": ("int", lambda m, a: m.color.rgb_to_gray(a(IMG))),
    "rgb_to_gray_f32": ("float", lambda m, a: m.color.rgb_to_gray(a(FIMG))),
    "gray_to_rgb": ("int", lambda m, a: m.color.gray_to_rgb(a(GRAY))),
    "rgb_rgba_rgb": ("int", lambda m, a: m.color.rgba_to_rgb(m.color.rgb_to_rgba(a(IMG), 7))),
    "cvt_bgr_gray": ("int", lambda m, a: m.color.cvt_color(a(IMG), "BGR", "gray")),
    "nv12": ("int", lambda m, a: m.color.yuv_nv12_to_rgb(a(NV_Y), a(NV_UV))),
    "nv21": ("int", lambda m, a: m.color.yuv_nv21_to_rgb(a(NV_Y), a(NV_UV))),
    "crop": ("int", lambda m, a: m.geo.crop(a(IMG), 3, 5, 10, 20)),
    "center_crop": ("int", lambda m, a: m.geo.center_crop(a(IMG), (15, 21))),
    "flip": ("int", lambda m, a: [m.geo.flip(a(IMG)), m.geo.flip(a(IMG), False)]),
    "rotate90": ("int", lambda m, a: [m.geo.rotate90(a(IMG), k) for k in (1, 2, 3)]),
    "pad": ("int", lambda m, a: [m.geo.pad(a(IMG), 1, 2, 3, 4, 9), m.geo.pad(a(GRAY), 2, 0, 1, 0)]),
    "warp_bilinear": ("resample", lambda m, a: m.geo.warp_affine(a(IMG), ROT, (20, 30))),
    "warp_nearest": ("resample", lambda m, a: m.geo.warp_affine(a(IMG), ROT, (20, 30),
                                                               method="nearest", fill=5.0)),
    "warp_gray_f32": ("float", lambda m, a: m.geo.warp_affine(a(FIMG[..., 0]), ROT, (26, 40))),
    "resize": ("resample", lambda m, a: [m.geo.resize(a(IMG), (13, 50)),
                                         m.geo.resize(a(GRAY), (30, 17), "nearest")]),
    "filter2d": ("float", lambda m, a: [m.filter.filter2d(a(IMG), SHARPEN),
                                        m.filter.filter2d(a(FIMG[..., 1]), SHARPEN)]),
    "sep_filter2d": ("float", lambda m, a: m.filter.sep_filter2d(a(IMG), [1.0, 2.0, 1.0],
                                                                 [0.5, 0.0, -0.5])),
    "gaussian_blur": ("float", lambda m, a: [m.filter.gaussian_blur(a(IMG), (5, 5), 0.0),
                                             m.filter.gaussian_blur(a(IMG), (9, 3), 1.7, 0.8),
                                             m.filter.gaussian_blur(a(GRAY), (11, 11), 0.0)]),
    "box_filter": ("float", lambda m, a: [m.filter.box_filter(a(IMG), (3, 5)),
                                          m.filter.box_filter(a(IMG), (3, 3), False),
                                          m.filter.blur(a(FIMG), (5, 5)),
                                          m.filter.sqr_box_filter(a(GRAY), (3, 3))]),
    "sobel": ("float", lambda m, a: [m.filter.sobel(a(GRAY), 1, 0), m.filter.sobel(a(GRAY), 0, 1),
                                     m.filter.sobel(a(IMG), 1, 1, 5, 0.5),
                                     m.filter.sobel(a(GRAY), 2, 0, 1)]),
    "scharr": ("float", lambda m, a: [m.filter.scharr(a(GRAY), 1, 0), m.filter.scharr(a(IMG), 0, 1, 2.0)]),
    "laplacian": ("float", lambda m, a: [m.filter.laplacian(a(GRAY)), m.filter.laplacian(a(IMG), 3)]),
    "spatial_gradient": ("float", lambda m, a: list(m.filter.spatial_gradient(a(GRAY)))),
    "structuring": ("int", lambda m, a: [m.filter.get_structuring_element(s, k) for s, k in (
        (0, (3, 5)), (1, (5, 3)), (2, (5, 7)), (2, (7, 5)), (2, (1, 1)))]),
    "erode_dilate": ("int", lambda m, a: [m.filter.erode(a(IMG), CROSS), m.filter.dilate(a(IMG), ELLIPSE),
                                          m.filter.erode(a(GRAY), np.ones((2, 4), np.uint8))]),
    "morph_f32": ("float", lambda m, a: [m.filter.dilate(a(FIMG), CROSS)]),
    "morphology_ex": ("float", lambda m, a: [m.filter.morphology_ex(a(GRAY), op, ELLIPSE) for op in (
        "open", "close", "gradient", "tophat", "blackhat")]),
    "pyramids": ("float", lambda m, a: [m.filter.pyr_down(a(IMG)), m.filter.pyr_up(a(GRAY)),
                                        m.filter.pyr_up(a(FIMG))]),
    "bilateral": ("float", lambda m, a: [m.filter.bilateral_filter(a(IMG), 5, 30.0, 2.0),
                                         m.filter.bilateral_filter(a(GRAY), 0, 20.0, 1.4)]),
    "calc_hist": ("int", lambda m, a: [m.hist.calc_hist(a(IMG), 1), m.hist.calc_hist(
        a(GRAY), bins=16, value_range=(10.0, 200.0), mask=a(MASK))]),
    "equalize_hist": ("int", lambda m, a: m.hist.equalize_hist(a(GRAY))),
    "threshold": ("int", lambda m, a: [m.hist.threshold(a(GRAY), 100.0, 200.0, t) for t in range(5)]),
    "threshold_f32": ("float", lambda m, a: [m.hist.threshold(a(FIMG), 0.4, 1.0, t) for t in range(5)]),
    "adaptive_threshold": ("int", lambda m, a: [
        m.hist.adaptive_threshold(a(GRAY), 255.0, 0, 0, 5, 2.5),
        m.hist.adaptive_threshold(a(GRAY), 255.0, 1, 1, 5, 3.0)]),
    "integral": ("float", lambda m, a: [m.hist.integral(a(IMG)), m.hist.integral(a(GRAY))]),
    "blend_linear": ("float", lambda m, a: m.hist.blend_linear(a(IMG), a(IMG2), a(FIMG[..., 0]),
                                                               a(FIMG[..., 1]))),
    "connected_components": ("int", lambda m, a: [
        m.struct.connected_components(a(BINARY), c) for c in (8, 4)]),
    "cc_with_stats": ("int", lambda m, a: m.struct.connected_components_with_stats(a(BINARY))[:3]),
    "cc_centroids": ("float", lambda m, a: m.struct.connected_components_with_stats(a(BINARY), 4)[3]),
    "cc_all_foreground": ("int", lambda m, a: m.struct.connected_components_with_stats(
        a(np.ones((5, 6), np.uint8)))[:3]),
    "image_process": ("resample", lambda m, a: [
        m.ip.ImageProcess(m.ip.ImageProcessConfig(
            source_format="bgr", mean=(1.0, 2.0, 3.0), normal=(0.5, 0.25, 2.0),
            target_size=(16, 20)))(a(IMG)),
        m.ip.ImageProcess(m.ip.ImageProcessConfig(
            target_size=(20, 30), matrix=ROT, layout="nhwc"))(a(IMG)),
        m.ip.ImageProcess(m.ip.ImageProcessConfig(
            source_format="rgb", dest_format="gray", mean=(0.0,), normal=(1.0,)))(a(IMG))]),
}


def to_numpy(out):
    if isinstance(out, (list, tuple)):
        return [to_numpy(o) for o in out]
    if isinstance(out, torch.Tensor):
        return out.float().numpy() if out.dtype == torch.bfloat16 else out.numpy()
    return np.asarray(out)


@pytest.fixture(scope="module")
def ref():
    return {name: to_numpy(fn(J, np.asarray)) for name, (_, fn) in CASES.items()}


def port_input(a):
    return torch.from_numpy(np.array(a))


def assert_close(got, want, kind, name):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, kind, f"{name}[{i}]")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if kind == "int":
        np.testing.assert_array_equal(got.astype(np.int64) if got.ndim else got,
                                      want.astype(np.int64) if want.ndim else want, err_msg=name)
    elif kind == "resample":
        assert np.abs(got.astype(np.float64) - want.astype(np.float64)).max() <= 1.0, name
    else:
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        assert rel(got, want) <= 1e-5, name


@pytest.mark.parametrize("name", sorted(CASES))
def test_cv_matches_jax(ref, name):
    kind, fn = CASES[name]
    got = to_numpy(fn(P, port_input))
    assert_close(got, ref[name], kind, name)


def test_cv_exports_match_jax():
    import mnn_tpu.cv as jcv
    import mnn_tpu_torch.cv as cv

    public = {n for n in dir(jcv) if not n.startswith("_")} - {
        "calib3d", "color", "draw", "filter", "geometric", "histogram", "image_process",
        "structural"}
    assert public <= set(dir(cv))
    assert cv.__all__ == jcv.__all__


def test_cv_array_goes_to_the_card_unless_cpu():
    """An array argument is an entry point's input: it goes to the card
    (which raises here) unless `device="cpu"`; a tensor stays where it is."""
    assert color.rgb_to_gray(IMG, device="cpu").device.type == "cpu"
    assert filter.sobel(torch.from_numpy(GRAY), 1, 0).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            color.rgb_to_gray(IMG)


def test_connected_components_checks_fixed_point_every_few_steps(monkeypatch):
    """A spiral needs many steps; the loop reads the card once per
    CC_CHECK steps and still ends at JAX's labels."""
    img = np.zeros((21, 21), np.uint8)
    img[1::4, 1:20] = 1
    img[3::4, 1] = 1
    img[3::8, 19] = 1
    img[5::8, 1] = 0
    img[7::8, 1] = 1
    calls = []
    real = torch.equal
    monkeypatch.setattr(torch, "equal", lambda a, b: calls.append(1) or real(a, b))
    n, labels = structural.connected_components(torch.from_numpy(img))
    jn, jlabels = jstruct.connected_components(img)
    assert n == jn
    np.testing.assert_array_equal(labels.numpy(), jlabels)
    assert len(calls) >= 2


def test_host_side_geometry_matches_jax():
    pts = rng.integers(0, 50, (30, 2)).astype(np.float64)
    poly = np.array([[0, 0], [8, 1], [9, 7], [2, 9], [-1, 4]], np.float64)
    assert structural.bounding_rect(torch.from_numpy(pts)) == jstruct.bounding_rect(pts)
    assert structural.contour_area(poly) == jstruct.contour_area(poly)
    assert structural.contour_area(poly, True) == jstruct.contour_area(poly, True)
    for cw in (False, True):
        np.testing.assert_array_equal(structural.convex_hull(pts, cw), jstruct.convex_hull(pts, cw))
    rect = structural.min_area_rect(pts)
    assert rect == jstruct.min_area_rect(pts)
    np.testing.assert_array_equal(structural.box_points(rect), jstruct.box_points(rect))
    assert structural.min_area_rect(np.array([[3.0, 4.0]] * 3)) == \
        jstruct.min_area_rect(np.array([[3.0, 4.0]] * 3))


def test_draw_matches_jax():
    outs = []
    for mod in (jdraw, draw):
        img = np.zeros((30, 40, 3), np.uint8)
        mod.rectangle(img, (3, 4), (20, 15), (255, 0, 0), 2)
        mod.rectangle(img, (30, 20), (25, 28), (0, 9, 0), -1)
        mod.line(img, (0, 29), (39, 2), (1, 2, 3), 3)
        mod.circle(img, (20, 15), 7, (7, 7, 7), 2)
        mod.circle(img, (5, 25), 4, (9, 8, 7), -1)
        outs.append(img)
    np.testing.assert_array_equal(outs[1], outs[0])


def test_rodrigues_and_solve_pnp_match_jax():
    for rvec in (np.array([0.1, -0.2, 0.3], np.float32), np.zeros(3, np.float32)):
        r = calib3d.rodrigues(torch.from_numpy(rvec))
        np.testing.assert_allclose(r.numpy(), np.asarray(jcalib.rodrigues(rvec)), atol=1e-6)
        np.testing.assert_allclose(calib3d.rodrigues_inv(r).numpy(),
                                   np.asarray(jcalib.rodrigues_inv(np.asarray(r))), atol=1e-6)
    g = np.random.default_rng(3)
    obj = g.uniform(-1, 1, (12, 3)).astype(np.float32)
    cam = np.array([[500.0, 0, 320], [0, 480.0, 240], [0, 0, 1]], np.float32)
    rvec, tvec = np.array([0.2, -0.1, 0.05]), np.array([0.1, -0.2, 5.0])
    proj = np.asarray(jcalib._project(obj, rvec.astype(np.float32), tvec.astype(np.float32), cam))
    img = proj + g.normal(0, 0.5, proj.shape).astype(np.float32)
    want = jcalib.solve_pnp(obj, img, cam)
    got = calib3d.solve_pnp(obj, img, cam, device="cpu")
    for a, b in zip(got, want):
        assert np.abs(a - b).max() <= 1e-3
    assert np.abs(got[1] - tvec).max() < 0.1


def test_imread_imwrite_match_jax(tmp_path):
    import mnn_tpu.cv as jcv
    import mnn_tpu_torch.cv as cv

    cv.imwrite(str(tmp_path / "a.png"), torch.from_numpy(IMG), "bgr")
    jcv.imwrite(str(tmp_path / "b.png"), IMG, "bgr")
    for fmt in ("rgb", "bgr", "gray"):
        np.testing.assert_array_equal(cv.imread(str(tmp_path / "a.png"), fmt),
                                      jcv.imread(str(tmp_path / "b.png"), fmt))


# --------------------------------------------------------------------------
# the native wrapper
# --------------------------------------------------------------------------

def test_native_builds_outside_native_dir():
    assert native.available()
    assert native._lib_path().is_relative_to(native.BUILD_ROOT)
    assert native._lib_path().exists()


def test_native_stfile_reads_the_bytes_stfile_reads(tmp_path):
    g = torch.Generator().manual_seed(4)
    tensors = {"a": torch.randn((17, 9), generator=g),
               "b": torch.randint(-128, 128, (33,), generator=g, dtype=torch.int8),
               "c.d": torch.randn((2, 3, 4), generator=g).bfloat16(),
               "e": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "empty": torch.zeros((0, 4))}
    path = str(tmp_path / "x.safetensors")
    stfile.save_file(tensors, path, metadata={"k": "v", "format": "pt"})
    with native.StFile(path) as nf:
        ref = stfile.StFile(path)
        assert nf.names == ref.names
        assert nf.metadata() == ref.metadata() == {"k": "v", "format": "pt"}
        for name in ref.names:
            got, want = nf.tensor(name), ref.tensor(name)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert got.clone().view(torch.uint8).numpy().tobytes() == \
                want.clone().view(torch.uint8).numpy().tobytes(), name
        ref.close()
    with pytest.raises(OSError):
        native.StFile(str(tmp_path / "missing.safetensors"))


def test_native_ngram_matches_jax_wrapper():
    seq = np.random.default_rng(1).integers(0, 6, 300).tolist()
    mine = native.NativeNgramIndex(max_n=4, draft_len=5)
    theirs = jnative.NativeNgramIndex(max_n=4, draft_len=5)
    plain = speculative.NgramDraft(draft_len=5)
    proposals = 0
    for i in range(0, len(seq), 7):
        chunk = seq[i:i + 7]
        for d in (mine, theirs, plain):
            d.extend(chunk)
        got = mine.propose()
        assert got == theirs.propose() == plain.propose(), i
        proposals += got is not None
    assert proposals > 5 and len(mine) == len(theirs) == len(seq)


def test_lookahead_takes_the_native_index(monkeypatch):
    made = []
    real = native.NativeNgramIndex
    monkeypatch.setattr(native, "NativeNgramIndex",
                        lambda **kw: made.append(kw) or real(**kw))

    class Stop(Exception):
        pass

    def prefill(*a, **k):
        raise Stop
    monkeypatch.setattr(speculative.gen, "run_prefill", prefill)
    llm = types.SimpleNamespace(params=None, config=None, rt=None, cache=None,
                                device=torch.device("cpu"))
    with pytest.raises(Stop):
        next(speculative.lookahead_generate(llm, [1, 2, 3], 4, draft_len=5))
    assert made == [dict(max_n=4, draft_len=5)]
