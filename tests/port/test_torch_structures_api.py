"""The structure API of the port beyond fusion, held against the JAX package
on the CPU on the same seeded numpy inputs, case by case after
``tests/structures/test_pointclouds.py``, ``test_rgbdimages.py``,
``test_structutils.py``, ``test_torch_interop.py`` and ``test_aliasing.py``:
``Pointclouds.from_list``, indexing, the geometric operations and their
operators and in-place names, the tensor semantics, the viewers' refusals,
``RGBDImages``' remaining methods, ``structutils`` and the coercion of host
arrays (numpy, JAX arrays) into tensors.

Tolerances: 1e-6 for offsets and scales, 1e-5 for products (rotations,
transforms, projections in pixels scaled by the focal length); everything
else exact."""

import base64
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
import gradslam_tpu.structures.structutils as JS  # noqa: E402
import gradslam_torch.structures.structutils as TS  # noqa: E402
from gradslam_torch import Pointclouds, RGBDImages  # noqa: E402
from gradslam_torch.interop import pointclouds_from_numpy, rgbdimages_from_numpy  # noqa: E402
from gradslam_torch.utils.precision import tf32_disabled  # noqa: E402

from ._parity import msrd, rigid_transforms  # noqa: E402

PRODUCTS = 1e-5


def _clouds(seed=0, feats=False):
    rng = np.random.RandomState(seed)
    n = (5, 3)
    out = {"points": [rng.randn(k, 3).astype(np.float32) for k in n],
           "normals": [rng.randn(k, 3).astype(np.float32) for k in n],
           "colors": [rng.rand(k, 3).astype(np.float32) for k in n]}
    if feats:
        out["features"] = [rng.rand(k, 2).astype(np.float32) for k in n]
    return out


def _both_from_list(capacity=8, **kw):
    lists = _clouds(**kw)
    return (Pointclouds.from_list(**lists, capacity=capacity, device="cpu"),
            G.Pointclouds.from_list(**lists, capacity=capacity), lists)


def _same(pc, jpc, atol=0.0, fields=("points", "normals", "colors", "features")):
    np.testing.assert_array_equal(pc.num_points.numpy(), np.asarray(jpc.num_points))
    assert pc.num_points.dtype == torch.int64
    for name in fields:
        ours, theirs = getattr(pc, name), getattr(jpc, name)
        assert (ours is None) == (theirs is None), name
        if ours is not None:
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=atol, rtol=0,
                                       err_msg=name)


def _digest(pc):
    h = hashlib.sha256()
    for name in ("points", "num_points", "normals", "colors", "features", "num_dropped"):
        t = getattr(pc, name)
        if t is not None:
            h.update(t.numpy().tobytes())
    return h.hexdigest()


# --------------------------------------------------------------------- #
# Construction
# --------------------------------------------------------------------- #
def test_from_list_matches_jax():
    pc, jpc, lists = _both_from_list(feats=True)
    _same(pc, jpc)
    assert pc.num_dropped is None and jpc.num_dropped is None
    np.testing.assert_allclose(pc.points_list[1], lists["points"][1])
    assert pc.num_features == 2 == jpc.num_features


def test_from_list_is_on_the_card_by_default(monkeypatch):
    seen = []
    real = torch.tensor

    def spy(*args, device=None, **kw):
        seen.append(torch.device(device))
        return real(*args, **kw)

    monkeypatch.setattr(torch, "tensor", spy)
    lists = _clouds()
    pc = Pointclouds.from_list(lists["points"], colors=lists["colors"])
    assert seen == [torch.device("cuda")] * 3  # points, counters, colors
    assert pc.num_points.dtype == torch.int64


def test_from_list_capacity_refusal_and_truncation():
    pts = _clouds()["points"]
    with pytest.raises(ValueError, match="exceeds capacity"):
        Pointclouds.from_list(pts, capacity=2, device="cpu")
    with pytest.raises(ValueError, match="exceeds capacity"):
        G.Pointclouds.from_list(pts, capacity=2)
    pc = Pointclouds.from_list(pts, capacity=2, allow_truncation=True, device="cpu")
    _same(pc, G.Pointclouds.from_list(pts, capacity=2, allow_truncation=True), fields=("points",))
    with pytest.raises(ValueError, match="non-empty"):
        Pointclouds.from_list([], device="cpu")


@pytest.mark.parametrize("kind", ["numpy", "torch", "jax"])
def test_from_list_accepts_every_array_kind(kind):
    pts = _clouds()["points"]
    conv = {"numpy": lambda a: a, "torch": torch.from_numpy, "jax": jnp.asarray}[kind]
    pc = Pointclouds.from_list([conv(p) for p in pts], device="cpu")
    np.testing.assert_array_equal(pc.num_points.numpy(), [5, 3])
    assert pc.capacity == 5
    np.testing.assert_array_equal(pc.points_list[0], pts[0])


def test_properties_match_jax():
    pc, jpc, _ = _both_from_list(feats=True)
    for name in ("equisized", "has_points", "has_normals", "has_colors", "has_features",
                 "num_features", "capacity"):
        assert getattr(pc, name) == getattr(jpc, name), name
    for name in ("points_padded", "normals_padded", "colors_padded", "features_padded",
                 "num_points_per_pointcloud"):
        np.testing.assert_array_equal(getattr(pc, name).numpy(), np.asarray(getattr(jpc, name)))
    empty = Pointclouds.empty(2, 4, device="cpu", feature_dim=None)
    assert not empty.has_points and empty.equisized and empty.num_features == 0
    assert empty.features_padded is None


# --------------------------------------------------------------------- #
# Indexing
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("index", [0, 1, -1, -2, slice(0, 1), slice(1, None), slice(None)])
def test_getitem_matches_jax(index):
    pc, jpc, _ = _both_from_list(feats=True)
    sub, jsub = pc[index], jpc[index]
    assert len(sub) == len(jsub)
    _same(sub, jsub)


@pytest.mark.parametrize("index", [2, -3, 7])
def test_getitem_out_of_range_raises(index):
    pc, jpc, _ = _both_from_list()
    with pytest.raises(IndexError):
        pc[index]
    with pytest.raises(IndexError):
        jpc[index]


def test_getitem_keeps_counters_and_last_row():
    pc = Pointclouds.empty(3, 4, device="cpu").append_masked(
        torch.arange(36, dtype=torch.float32).reshape(3, 4, 3),
        torch.tensor([[1, 0, 0, 0], [1, 1, 0, 0], [1, 1, 1, 0]], dtype=torch.bool))
    last = pc[-1]
    assert len(last) == 1 and last.num_points.tolist() == [3]
    assert last.num_dropped.tolist() == [0]


# --------------------------------------------------------------------- #
# Geometric operations against JAX
# --------------------------------------------------------------------- #
def _rmat(seed, batched):
    T = rigid_transforms(np.random.RandomState(seed), 2 if batched else 1)
    return (T if batched else T[0])[..., :3, :3].copy()


def _tmat(seed, batched):
    T = rigid_transforms(np.random.RandomState(seed), 2 if batched else 1)
    return T if batched else T[0]


def _intrinsics(batched):
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 100.0, 90.0, 50.0, 40.0
    return np.stack([K, K * [[1.1], [1.2], [1], [1]]]) if batched else K


OPS = {
    "offset": (lambda: np.array([1.0, -2.0, 0.5], np.float32), 1e-6),
    "offset batched": (lambda: np.array([[[1.0, 2, 3]], [[-1, 0, 2]]], np.float32), 1e-6),
    "scale": (lambda: np.float32(2.5), 1e-6),
    "scale per axis": (lambda: np.array([1.0, 2.0, -3.0], np.float32), 1e-6),
    "rotate": (lambda: _rmat(1, False), PRODUCTS),
    "rotate batched": (lambda: _rmat(2, True), PRODUCTS),
    "transform": (lambda: _tmat(3, False), PRODUCTS),
    "transform batched": (lambda: _tmat(4, True), PRODUCTS),
    "pinhole_projection": (lambda: _intrinsics(False), PRODUCTS),
    "pinhole_projection batched": (lambda: _intrinsics(True), PRODUCTS),
}


@pytest.mark.parametrize("alias", [False, True])
@pytest.mark.parametrize("op", sorted(OPS))
def test_geometric_ops_match_jax_and_keep_the_input(op, alias):
    pc, jpc, _ = _both_from_list(seed=5)
    pc = dataclasses_replace_points(pc, 3.0)  # projections need points in front
    jpc = G.Pointclouds(points=jnp.asarray(pc.points.numpy()), num_points=jpc.num_points,
                        normals=jpc.normals, colors=jpc.colors)
    make, atol = OPS[op]
    arg = make()
    name = op.split()[0] + ("_" if alias else "")
    before = _digest(pc)
    out = getattr(pc, name)(torch.from_numpy(np.asarray(arg)))
    jout = getattr(jpc, name)(jnp.asarray(arg))
    _same(out, jout, atol=atol, fields=("points", "normals", "colors"))
    mask = ~pc.nonpad_mask
    assert (out.points[mask] == 0).all()  # padding stays exactly zero
    assert _digest(pc) == before  # the input is left as it was
    assert out is not pc and out.points.data_ptr() != pc.points.data_ptr()


def dataclasses_replace_points(pc, dz):
    """The cloud with its live points moved ``dz`` along +z (padding kept
    at zero)."""
    return pc.offset(torch.tensor([0.0, 0.0, dz]))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("kind", ["rotation", "transform"])
def test_matmul_post_multiplies_like_jax(kind, batched):
    pc, jpc, lists = _both_from_list(seed=6)
    arg = _rmat(7, batched) if kind == "rotation" else _tmat(8, batched)
    out, jout = pc @ torch.from_numpy(arg), jpc @ jnp.asarray(arg)
    _same(out, jout, atol=PRODUCTS, fields=("points", "normals"))
    R = arg[..., :3, :3]
    R0 = R[0] if batched else R
    t0 = (arg[0] if batched else arg)[:3, 3] if kind == "transform" else 0.0
    np.testing.assert_allclose(out.points_list[0], lists["points"][0] @ R0 + t0, atol=PRODUCTS)
    # normals rotate and do not translate
    np.testing.assert_allclose(out.normals_list[0], lists["normals"][0] @ R0, atol=PRODUCTS)
    assert (out.points[~pc.nonpad_mask] == 0).all()


def test_matmul_refuses_other_shapes():
    pc, jpc, _ = _both_from_list()
    for bad in (np.zeros((2, 2), np.float32), np.zeros((2, 2, 3, 3, 3), np.float32)):
        with pytest.raises(ValueError, match="Unsupported shape"):
            pc @ torch.from_numpy(bad)
        with pytest.raises(ValueError, match="Unsupported shape"):
            jpc @ jnp.asarray(bad)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "truediv"])
def test_arithmetic_operators_match_jax(op):
    import operator

    pc, jpc, _ = _both_from_list(seed=9)
    arg = np.array([0.5, -1.5, 2.0], np.float32)
    fn = getattr(operator, op)
    _same(fn(pc, torch.from_numpy(arg)), fn(jpc, jnp.asarray(arg)), atol=1e-6,
          fields=("points", "normals"))


def test_offset_and_scale_take_host_arrays_and_scalars():
    pc, jpc, _ = _both_from_list(seed=10)
    _same(pc + [1.0, 2.0, 3.0], jpc + jnp.asarray([1.0, 2.0, 3.0]), atol=1e-6,
          fields=("points",))
    _same(pc / 4, jpc / 4, atol=1e-6, fields=("points",))
    _same(pc.offset(np.ones(3)), jpc.offset(np.ones(3)), atol=1e-6, fields=("points",))


def test_transform_premultiplication_keeps_padding_zero():
    pc = Pointclouds.from_list([np.ones((2, 3), np.float32)], capacity=5, device="cpu")
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [5.0, 6.0, 7.0]
    out = pc.transform(torch.from_numpy(T))
    np.testing.assert_array_equal(out.points[0, 2:].numpy(), 0.0)
    np.testing.assert_allclose(out.points[0, :2].numpy(), [[6, 7, 8], [6, 7, 8]], atol=1e-6)


@pytest.mark.parametrize("op", ["rotate", "transform", "pinhole_projection", "matmul"])
def test_products_run_with_tf32_off(monkeypatch, op):
    seen = []
    real = torch.einsum

    def spy(*args, **kw):
        seen.append(tf32_disabled())
        return real(*args, **kw)

    monkeypatch.setattr(torch, "einsum", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    pc, _, _ = _both_from_list()
    arg = {"rotate": torch.eye(3), "transform": torch.eye(4),
           "pinhole_projection": torch.eye(4), "matmul": torch.eye(4)}[op]
    getattr(pc, op if op != "matmul" else "__matmul__")(arg)
    assert seen and all(seen)
    assert torch.backends.cuda.matmul.allow_tf32


# --------------------------------------------------------------------- #
# Tensor semantics (test_aliasing.py's contract)
# --------------------------------------------------------------------- #
def test_clone_is_separate_and_equal_and_keeps_gradients():
    pc, _, _ = _both_from_list(feats=True)
    c = pc.clone()
    for name in ("points", "num_points", "normals", "colors", "features"):
        a, b = getattr(pc, name), getattr(c, name)
        assert a.data_ptr() != b.data_ptr()
        assert torch.equal(a, b)
    pts = pc.points.clone().requires_grad_(True)
    import dataclasses

    (dataclasses.replace(pc, points=pts).clone().points ** 2).sum().backward()
    assert pts.grad.abs().max() > 0


def test_detach_stops_gradients():
    import dataclasses

    pc, _, _ = _both_from_list()
    pts = pc.points.clone().requires_grad_(True)
    d = dataclasses.replace(pc, points=pts).detach()
    assert not d.points.requires_grad and torch.equal(d.points, pc.points)


def test_to_cpu_and_cuda_move_every_buffer(monkeypatch):
    pc, _, _ = _both_from_list(feats=True)
    moved = pc.to("cpu")
    for name in ("points", "num_points", "normals", "colors", "features"):
        assert torch.equal(getattr(moved, name), getattr(pc, name))
    assert pc.cpu().device.type == "cpu"
    targets = []
    real = torch.Tensor.to

    def spy(t, device, *args, **kw):
        targets.append(device)
        return real(t, "cpu")

    monkeypatch.setattr(torch.Tensor, "to", spy)
    pc.cuda()
    assert targets and all(d == torch.device("cuda") for d in targets)


def test_getitem_leaves_the_source():
    pc, _, _ = _both_from_list()
    before = _digest(pc)
    sub = pc[1]
    _ = sub.offset(torch.ones(3)).transform(torch.eye(4)).scale(3.0)
    assert _digest(pc) == before


# --------------------------------------------------------------------- #
# Viewers: optional dependencies, imported when called
# --------------------------------------------------------------------- #
def _missing(module):
    try:
        __import__(module)
    except ImportError as exc:
        return exc
    return None


def test_open3d_and_plotly_raise_the_jax_packages_import_error():
    pc, jpc, _ = _both_from_list()
    for module, call in (("open3d", lambda c: c.open3d(0)), ("plotly", lambda c: c.plotly(0))):
        exc = _missing(module)
        assert exc is not None, f"{module} is installed: the refusal cannot be held here"
        with pytest.raises(ImportError) as ours:
            call(pc)
        with pytest.raises(ImportError) as theirs:
            call(jpc)
        assert type(ours.value) is type(theirs.value)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(TypeError):
        pc.plotly("0")


def test_rgbdimages_viewers_raise_the_jax_packages_import_error():
    assert _missing("plotly") is not None
    m = msrd()
    fr = rgbdimages_from_numpy(m["colors"], m["depths"], m["intrinsics"], m["poses"],
                               device="cpu")
    jfr = G.RGBDImages(jnp.asarray(m["colors"]), jnp.asarray(m["depths"]),
                       jnp.asarray(m["intrinsics"]), jnp.asarray(m["poses"]))
    for call in (lambda f: f.plotly(0), lambda f: f.plotly_vertex_scatter(0)):
        with pytest.raises(ImportError) as ours:
            call(fr)
        with pytest.raises(ImportError) as theirs:
            call(jfr)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(TypeError):
        fr.plotly("0")


# --------------------------------------------------------------------- #
# RGBDImages
# --------------------------------------------------------------------- #
def _both_frames(channels_first=False):
    m = msrd()
    fr = rgbdimages_from_numpy(m["colors"], m["depths"], m["intrinsics"], m["poses"],
                               device="cpu")
    jfr = G.RGBDImages(jnp.asarray(m["colors"]), jnp.asarray(m["depths"]),
                       jnp.asarray(m["intrinsics"]), jnp.asarray(m["poses"]))
    if channels_first:
        return fr.to_channels_first(), jfr.to_channels_first()
    return fr, jfr


@pytest.mark.parametrize("channels_first", [False, True])
def test_rgbdimages_shape_properties_and_views(channels_first):
    fr, jfr = _both_frames(channels_first)
    assert (fr.h, fr.w, fr.has_poses) == (jfr.h, jfr.w, jfr.has_poses) == (120, 160, True)
    assert not fr.with_poses(None).has_poses
    for name in ("rgb_image_channels_first", "depth_image_channels_first"):
        np.testing.assert_array_equal(getattr(fr, name).numpy(), np.asarray(getattr(jfr, name)))
    assert fr.rgb_image_channels_first.shape == (2, 3, 3, 120, 160)
    # a view, not a copy
    assert fr.rgb_image_channels_first.data_ptr() == fr.rgb_image.data_ptr()
    vm = fr.to_channels_last().vertex_map
    np.testing.assert_array_equal(fr._to_layout(vm).numpy(),
                                  np.asarray(jfr._to_layout(jnp.asarray(vm.numpy()))))


@pytest.mark.parametrize("channels_first", [False, True])
def test_rgbdimages_clone_detach_to(channels_first, monkeypatch):
    fr, _ = _both_frames(channels_first)
    for copy in (fr.clone(), fr.detach(), fr.to("cpu"), fr.cpu()):
        assert copy.channels_first == fr.channels_first
        for name in ("rgb_image", "depth_image", "intrinsics", "poses"):
            assert torch.equal(getattr(copy, name), getattr(fr, name))
    c = fr.clone()
    assert c.rgb_image.data_ptr() != fr.rgb_image.data_ptr()
    depth = fr.depth_image.clone().requires_grad_(True)
    import dataclasses

    (dataclasses.replace(fr, depth_image=depth).detach().global_vertex_map ** 2).sum()
    assert not dataclasses.replace(fr, depth_image=depth).detach().depth_image.requires_grad
    (dataclasses.replace(fr, depth_image=depth).clone().vertex_map ** 2).sum().backward()
    assert depth.grad.abs().max() > 0
    targets = []
    real = torch.Tensor.to
    monkeypatch.setattr(torch.Tensor, "to", lambda t, d, *a, **k: (targets.append(d),
                                                                    real(t, "cpu"))[1])
    fr.cuda()
    assert len(targets) == 4 and all(d == torch.device("cuda") for d in targets)


# --------------------------------------------------------------------- #
# structutils
# --------------------------------------------------------------------- #
def test_plotly_layout_helpers_equal_jax():
    for n in (1, 5):
        assert TS.animation_slider(n) == JS.animation_slider(n)
    for ms in (0, 50):
        assert TS.animation_updatemenus(ms) == JS.animation_updatemenus(ms)
    for is_depth in (False, True):
        for scale in (None, 10.0, 2.5, 1):
            assert (TS.plotly_image_hovertemplate(is_depth, scale)
                    == JS.plotly_image_hovertemplate(is_depth, scale))


@pytest.mark.parametrize("case", ["rgb", "grey", "float", "quality 50"])
def test_img_to_b64str_equals_jax_byte_for_byte(case):
    import cv2

    rng = np.random.RandomState(11)
    img = {"rgb": (rng.rand(16, 24, 3) * 255).astype(np.uint8),
           "grey": (rng.rand(8, 8) * 255).astype(np.uint8),
           "float": rng.rand(9, 7, 3) * 300 - 20,
           "quality 50": (rng.rand(16, 24, 3) * 255).astype(np.uint8)}[case]
    q = 50 if case == "quality 50" else 95
    ours = TS.img_to_b64str(img, quality=q)
    assert ours == JS.img_to_b64str(img, quality=q)
    assert ours.startswith("data:image/jpeg;base64,")
    raw = base64.b64decode(ours.split(",", 1)[1])
    assert cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_UNCHANGED).shape[:2] == img.shape[:2]


def test_numpy_to_plotly_image_needs_plotly():
    assert _missing("plotly") is not None
    with pytest.raises(ImportError) as ours:
        TS.numpy_to_plotly_image(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ImportError) as theirs:
        JS.numpy_to_plotly_image(np.zeros((4, 4, 3), np.uint8))
    assert str(ours.value) == str(theirs.value)


LISTS = {
    "rows": [np.arange(6, dtype=np.float32).reshape(2, 3), np.ones((4, 3), np.float32)],
    "ragged columns": [np.ones((2, 5), np.float32), np.full((3, 2), 7.0, np.float32)],
    "vectors": [np.arange(3, dtype=np.int64), np.arange(5, dtype=np.int64)],
}


@pytest.mark.parametrize("pad", [None, "given"])
@pytest.mark.parametrize("case", sorted(LISTS))
def test_list_to_padded_matches_jax(case, pad):
    x = LISTS[case]
    pad_size = None if pad is None else (6,) + ((6,) if x[0].ndim == 2 else ())
    ours = TS.list_to_padded(x, pad_size, pad_value=-1.0, device="cpu")
    theirs = JS.list_to_padded(x, pad_size, pad_value=-1.0)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert ours.dtype == torch.from_numpy(x[0]).dtype
    # tensors in, the same out
    again = TS.list_to_padded([torch.from_numpy(a) for a in x], pad_size, pad_value=-1.0,
                              device="cpu")
    assert torch.equal(again, ours)


def test_list_to_padded_equisized_refusal_and_card_default(monkeypatch):
    x = [np.ones((2, 3), np.float32), np.zeros((2, 3), np.float32)]
    np.testing.assert_array_equal(TS.list_to_padded(x, equisized=True, device="cpu").numpy(),
                                  np.asarray(JS.list_to_padded(x, equisized=True)))
    with pytest.raises(ValueError, match="Pad size"):
        TS.list_to_padded(x, pad_size=(4,), device="cpu")
    targets = []
    real = torch.Tensor.to
    monkeypatch.setattr(torch.Tensor, "to", lambda t, d, *a, **k: (targets.append(d),
                                                                    real(t, "cpu"))[1])
    TS.list_to_padded(x)
    assert targets == ["cuda"]


@pytest.mark.parametrize("split", [None, [1, 3], [(1, 2), (2, 1)]])
def test_padded_to_list_matches_jax(split):
    x = np.arange(2 * 4 * 3, dtype=np.float32).reshape(2, 4, 3)
    ours = TS.padded_to_list(torch.from_numpy(x), split)
    theirs = JS.padded_to_list(x, split)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="same length"):
        TS.padded_to_list(torch.from_numpy(x), [1])


# --------------------------------------------------------------------- #
# Host arrays into the structures (coerce_torch)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["numpy", "jax"])
def test_coerce_torch_turns_host_arrays_into_tensors(kind):
    src = np.arange(6, dtype=np.float64).reshape(2, 3)
    x = src if kind == "numpy" else jnp.asarray(src, dtype=jnp.float32)
    out = TS.coerce_torch(x, device="cpu")
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), src)
    counts = TS.coerce_torch(np.array([5, 3], np.int32), np.int64, "cpu")
    assert counts.dtype == torch.int64
    if kind == "numpy":  # copied, never aliased
        src[0, 0] = 99.0
        assert out[0, 0] == 0.0


def test_coerce_torch_passes_tensors_and_the_rest_through():
    t = torch.ones(3, dtype=torch.float64)
    for x in (None, t, [1.0, 2.0], 3.0, "text"):
        assert TS.coerce_torch(x) is x


def test_structures_take_host_arrays_onto_their_tensor_fields_device():
    rng = np.random.RandomState(12)
    pc = Pointclouds(points=torch.from_numpy(rng.randn(1, 8, 3).astype(np.float32)),
                     num_points=np.array([5], np.int32),
                     colors=jnp.asarray(rng.rand(1, 8, 3).astype(np.float32)))
    assert isinstance(pc.num_points, torch.Tensor) and pc.num_points.dtype == torch.int64
    assert isinstance(pc.colors, torch.Tensor) and pc.colors.device == pc.points.device
    moved = pc.offset(np.ones(3))
    np.testing.assert_allclose(moved.points[0, :5].numpy(), pc.points[0, :5].numpy() + 1.0)
    np.testing.assert_array_equal(moved.points[0, 5:].numpy(), pc.points[0, 5:].numpy())
    on_meta = Pointclouds(points=torch.zeros(1, 4, 3, device="meta"),
                          num_points=np.array([2]))
    assert on_meta.num_points.device.type == "meta"
    fr = RGBDImages(np.ones((1, 2, 4, 5, 3)), torch.ones(1, 2, 4, 5, 1),
                    jnp.eye(4)[None, None], np.broadcast_to(np.eye(4), (1, 2, 4, 4)))
    assert all(isinstance(getattr(fr, n), torch.Tensor) and getattr(fr, n).dtype == torch.float32
               for n in ("rgb_image", "depth_image", "intrinsics", "poses"))
    assert fr.vertex_map.shape == (1, 2, 4, 5, 3)
    assert fr.with_poses(np.broadcast_to(np.eye(4), (1, 2, 4, 4))).poses.dtype == torch.float32
    with pytest.raises(ValueError, match="rgb_image"):
        RGBDImages(np.ones((1, 2, 3, 4, 5)), torch.ones(1, 2, 1, 4, 5), np.eye(4)[None, None])


def test_structures_built_from_host_arrays_alone_land_on_the_card(monkeypatch):
    """With no tensor field, a host array lands where ``interop`` puts one:
    on the card."""
    seen = []
    real = torch.tensor

    def spy(*args, device=None, **kw):
        seen.append(torch.device(device))
        return real(*args, **kw)

    monkeypatch.setattr(torch, "tensor", spy)
    Pointclouds(points=np.zeros((1, 4, 3)), num_points=np.array([2]))
    RGBDImages(np.ones((1, 1, 4, 5, 3)), np.ones((1, 1, 4, 5, 1)), np.eye(4)[None, None])
    pointclouds_from_numpy(np.zeros((1, 4, 3)), [2])
    rgbdimages_from_numpy(np.ones((1, 1, 4, 5, 3)), np.ones((1, 1, 4, 5, 1)),
                          np.eye(4)[None, None])
    assert len(seen) == 2 + 3 + 2 + 3
    assert all(d == torch.device("cuda") for d in seen)


def test_from_channels_first_takes_host_arrays():
    m = msrd()
    fr = RGBDImages.from_channels_first(
        torch.from_numpy(np.moveaxis(m["colors"], -1, 2).copy()),
        np.moveaxis(m["depths"], -1, 2), m["intrinsics"], m["poses"])
    np.testing.assert_array_equal(fr.rgb_image.numpy(), m["colors"])
    assert fr.depth_image.device.type == "cpu"
