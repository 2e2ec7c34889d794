"""Pairwise IoU, kernel #10 (basedet_tpu_torch/ops/iou_kernel.py), against the
JAX package on the CPU: its plain version (``structures/box_ops.box_iou``,
which a CPU tensor takes) against ``box_iou_pallas(..., interpret=True)`` and
against the JAX package's ``structures.box_iou``, as 2-D, batched and
broadcast inputs, at sizes off the 256 tile, and on edge cases (zero-area,
inverted, identical, touching-edge and disjoint boxes, coordinates up to
1e4, -0.0 coordinates, every pair overlapping; ``chip_smoke.iou_edges``);
then the wrapper's dispatch and refusals; then ``iou_tile_model``, the
kernel's strips and skip rule on the CPU, bit-equal to the plain version (the
sign of zero included) on those cases, on random draws and on zero-padded gt
rows, where the skip takes every padded row.

Inputs come from ``numpy.random.RandomState`` seeds. Tolerance 1e-6
absolute. Measured: the plain version is bit-equal to the JAX package's
``box_iou`` on every case here (the same operations in the same order), and
within 1.8e-7 of the Pallas kernel run in interpret mode, which XLA
compiles to other bits at some sizes. The CUDA kernel itself runs only on
the card (the ``-m cuda`` tests, skipped here: the edge cases and the four
callers' shapes, bit-equal and bit-equal run to run), where ``chip_smoke.py``
holds it to the plain version bit for bit. JAX is
imported inside the tests that use it, so that the card's machine, which
has none, can collect this file.
"""
import numpy as np
import pytest
import torch

from basedet_tpu_torch.ops.iou_kernel import STRIP_COLS, box_iou, box_iou_plain, iou_skip_mask, iou_tile_model
from basedet_tpu_torch.structures import pairwise_intersection
from chip_smoke import _iou_boxes, check_iou_case, iou_edges
from tests.torch_threads import torch_threads  # noqa: F401

ATOL = 1e-6


def random_boxes(rng, shape, size=200.0):
    return _iou_boxes(rng, shape, size).numpy()


def _cases():
    rng = np.random.RandomState(0)
    cases = {
        "300x130": (random_boxes(rng, (300, 4)), random_boxes(rng, (130, 4))),
        "257x511": (random_boxes(rng, (257, 4)), random_boxes(rng, (511, 4))),
        "1x1000 up to 1e4": (random_boxes(rng, (1, 4), 1e4), random_boxes(rng, (1000, 4), 1e4)),
    }
    for name, (a, b) in iou_edges(np.random.RandomState(1)).items():
        if a.dim() == 2 and b.dim() == 2:
            cases[name] = (a.numpy(), b.numpy())
        elif b.dim() == 2:  # the 2-D form of the batched edge case: its first image
            cases[name + ", image 0"] = (a[0].numpy(), b.numpy())
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_and_jax(name):
    import jax.numpy as jnp

    from basedet_tpu.ops.iou_pallas import box_iou_pallas
    from basedet_tpu.structures import box_iou as jax_box_iou

    a, b = CASES[name]
    got = box_iou_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_box_iou(jnp.asarray(a), jnp.asarray(b)))
    pallas = np.asarray(box_iou_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    assert got.shape == want.shape == pallas.shape == (a.shape[0], b.shape[0])
    np.testing.assert_array_equal(got, want)  # bit-equal, as measured
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)


def test_edge_values():
    """Identical proper boxes give exactly 1, a union at or under 0 gives 0,
    touching and disjoint boxes give 0."""
    special = next(iter(iou_edges(np.random.RandomState(1)).values()))[1][:12]
    iou = box_iou_plain(special, special)
    area = (special[:, 2] - special[:, 0]) * (special[:, 3] - special[:, 1])
    proper = (special[:, 2] > special[:, 0]) & (special[:, 3] > special[:, 1])
    assert bool((iou.diagonal()[proper] == 1.0).all())
    union = area[:, None] + area[None, :] - pairwise_intersection(special, special)
    assert bool((union <= 0).any()) and bool((iou[union <= 0] == 0).all())
    assert float(iou[5, 6]) == 0.0 and float(iou[5, 7]) == 0.0  # touching along x, along y
    assert float(iou[5, 8]) == 0.0  # disjoint
    assert bool(((iou >= 0) & (iou <= 1)).all())


@pytest.mark.parametrize("per_image", [False, True], ids=["shared boxes2", "boxes2 per image"])
def test_batched_matches_jax(per_image):
    """(B, M, 4) against (N, 4) shared by every image (RetinaNet's anchors) or
    (B, N, 4): each image as the JAX package's ``box_iou`` and the Pallas
    kernel compute it."""
    import jax
    import jax.numpy as jnp

    from basedet_tpu.ops.iou_pallas import box_iou_pallas
    from basedet_tpu.structures import box_iou as jax_box_iou

    rng = np.random.RandomState(2)
    a = random_boxes(rng, (3, 37, 4), 640.0)
    b = random_boxes(rng, (3, 1030, 4) if per_image else (1030, 4), 640.0)
    calls = box_iou_plain.calls
    got = box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert box_iou_plain.calls == calls + 1
    assert got.shape == (3, 37, 1030)
    for i in range(3):
        bi = b[i] if per_image else b
        np.testing.assert_array_equal(got[i], np.asarray(jax_box_iou(jnp.asarray(a[i]), jnp.asarray(bi))))
        pallas = box_iou_pallas(jnp.asarray(a[i]), jnp.asarray(bi), interpret=True)
        np.testing.assert_allclose(got[i], np.asarray(pallas), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got, np.asarray(jax.vmap(jax_box_iou, (0, 0 if per_image else None))(
        jnp.asarray(a), jnp.asarray(b))))


def test_cpu_takes_the_plain_version():
    a, b = (torch.from_numpy(x) for x in CASES["300x130"])
    calls, launches = box_iou_plain.calls, box_iou.launches
    out = box_iou(a, b)
    assert out.shape == (300, 130) and out.dtype == torch.float32
    assert box_iou_plain.calls == calls + 1 and box_iou.launches == launches
    assert torch.equal(out, box_iou_plain(a, b))


@pytest.mark.parametrize("case", ["f64", "int", "devices", "grad", "last dim", "3-D with 2-D",
                                  "batch", "4-D", "meta"])
def test_wrapper_raises(case):
    a, b = torch.zeros(2, 5, 4), torch.zeros(7, 4)
    if case == "f64":
        a = a.double()
    elif case == "int":
        b = b.int()
    elif case == "devices":
        b = torch.zeros(7, 4, device="meta")
    elif case == "grad":
        b.requires_grad_()
    elif case == "last dim":
        a = torch.zeros(2, 5, 5)
    elif case == "3-D with 2-D":
        a, b = torch.zeros(5, 4), torch.zeros(2, 7, 4)
    elif case == "batch":
        b = torch.zeros(3, 7, 4)
    elif case == "4-D":
        a = torch.zeros(1, 2, 5, 4)
    elif case == "meta":
        a, b = a.to("meta"), b.to("meta")
    calls = box_iou_plain.calls
    with pytest.raises(ValueError):
        box_iou(a, b)
    assert box_iou_plain.calls == calls


def bits(t):
    return t.view(torch.int32)


def padded_gts(rng, B, K, n, size):
    """(B, K, 4) gts as the detectors pad them: n real boxes per image, zero
    boxes after."""
    gts = torch.zeros(B, K, 4)
    gts[:, :n] = _iou_boxes(rng, (B, n, 4), size)
    return gts


def anchor_grid(stride, cells, sizes):
    """Anchor-like boxes centred on a stride grid, reaching past the image's
    left and top edges: (cells², len(sizes), 4) flattened location-major."""
    c = (torch.arange(cells, dtype=torch.float32) * stride)
    cy, cx = torch.meshgrid(c, c, indexing="ij")
    half = torch.tensor(sizes, dtype=torch.float32)[None, :] / 2
    cx, cy = cx.reshape(-1, 1), cy.reshape(-1, 1)
    return torch.stack([cx - half, cy - half, cx + half, cy + half], -1).reshape(-1, 4)


def _model_cases():
    rng = np.random.RandomState(3)
    cases = {f"edge: {k}": v for k, v in iou_edges(np.random.RandomState(4)).items()}
    cases.update({
        "random (2, 45) x (1000,)": (_iou_boxes(rng, (2, 45, 4), 600.0), _iou_boxes(rng, (1000, 4), 600.0)),
        "random per image (3, 33) x (3, 300)": (_iou_boxes(rng, (3, 33, 4), 300.0),
                                                _iou_boxes(rng, (3, 300, 4), 300.0)),
        "random 2-D (64,) x (129,)": (_iou_boxes(rng, (64, 4), 100.0), _iou_boxes(rng, (129, 4), 100.0)),
        "padded gts (2, 100) x anchors (3600,)": (padded_gts(rng, 2, 100, 3, 480.0),
                                                  anchor_grid(16.0, 30, (32.0, 64.0, 128.0, 256.0))),
    })
    return cases


MODEL_CASES = _model_cases()


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_tile_model_is_bit_equal_to_plain(name):
    a, b = MODEL_CASES[name]
    got, want = iou_tile_model(a, b), box_iou_plain(a, b)
    assert got.shape == want.shape
    assert torch.equal(bits(got), bits(want))


def test_skip_takes_every_padded_row():
    """Zero boxes meet no anchor with a positive intersection, the border
    strips' included (there min(0, x2) - max(0, x1) is exactly 0): the kernel
    stores their rows with no arithmetic."""
    a, b = MODEL_CASES["padded gts (2, 100) x anchors (3600,)"]
    skip = iou_skip_mask(a, b)
    assert skip.shape == (2, 100, -(-3600 // STRIP_COLS))
    assert bool(skip[:, 3:].all())
    assert 0.0 < float(skip[:, :3].float().mean()) < 1.0


def test_skip_never_fires_where_every_pair_overlaps():
    a, b = MODEL_CASES["edge: dense: every pair overlaps (2, 37) x (2, 515)"]
    assert not bool(iou_skip_mask(a, b).any())
    assert bool((box_iou_plain(a, b) > 0).all())


def test_negative_zero_turns_the_skip_off():
    """A row or a strip with a -0.0 coordinate takes the full arithmetic,
    which gives the plain version's -0.0 results; the zero rows still skip in
    the strip without one."""
    a, b = MODEL_CASES["edge: -0.0 coordinates among zero rows (2, 40) x (300,)"]
    want = box_iou_plain(a, b)
    assert bool(((want == 0) & torch.signbit(want)).any())
    skip = iou_skip_mask(a, b)
    assert not bool(skip[:, :, :2].any())  # strips 0 and 1 hold -0.0 boxes
    zero_rows = (a == 0).all(-1)
    assert bool(skip[..., 2][zero_rows].all())
    neg0_rows = ((a == 0) & torch.signbit(a)).any(-1)
    assert not bool(skip[neg0_rows].any())


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the IoU kernel has no CPU mode")


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu():
    """Kernel #10 against its plain version on the card, on ``chip_smoke.py``'s
    edge cases: bit-equal (max |diff| 0, the sign of zero included)."""
    _needs_gpu()
    for name, (a, b) in iou_edges(np.random.RandomState(5)).items():
        launches = box_iou.launches
        err, equal = check_iou_case(a.cuda(), b.cuda())
        assert box_iou.launches == launches + 1, name
        assert err == 0.0 and equal, (name, err)


CALLER_SHAPES = {  # name: (B, M, N, boxes2 per image)
    "RetinaNet (2, 100) x (201600,)": (2, 100, 201600, False),
    "RPN targets (2, 100) x (268569,)": (2, 100, 268569, False),
    "R-CNN sampling (2, 1100) x (2, 100)": (2, 1100, 100, True),
    "SimOTA (8, 100) x (8, 8400)": (8, 100, 8400, True),
    "ATSS (2, 100) x (22400,)": (2, 100, 22400, False),
    "FreeAnchor (2, 100) x (2, 201600)": (2, 100, 201600, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CALLER_SHAPES))
def test_kernel_bit_equal_at_the_callers_shapes_on_gpu(name):
    """The callers' shapes, with gts padded as the detectors pad them:
    bit-equal to the plain version, and two runs bit-equal."""
    _needs_gpu()
    B, M, N, per_image = CALLER_SHAPES[name]
    rng = np.random.RandomState(6)
    if M > N:  # R-CNN sampling: the proposals, then the padded gts, against the gts
        b = padded_gts(rng, B, N, 3, 1333.0).cuda()
        a = torch.cat([_iou_boxes(rng, (B, M - N, 4), 1333.0).cuda(), b], 1)
    else:
        a = padded_gts(rng, B, M, 3, 1333.0).cuda()
        b = _iou_boxes(rng, (B, N, 4) if per_image else (N, 4), 1333.0).cuda()
    got = box_iou(a, b)
    assert torch.equal(bits(got), bits(box_iou_plain(a, b)))
    assert torch.equal(bits(got), bits(box_iou(a, b)))


@pytest.mark.cuda
def test_kernel_bit_equal_at_yolov3_shapes_on_gpu():
    """YOLOv3's two calls a step at batch 8 of 800x1344: the gts' centred boxes
    against the 9 anchors, (8, 100, 4) x (9, 4), and the ignore mask's
    decoded boxes of the three levels against each image's padded gts,
    (8, 66150, 4) x (8, 100, 4): bit-equal to the plain version, and two
    runs bit-equal."""
    _needs_gpu()
    rng = np.random.RandomState(7)
    gts = padded_gts(rng, 8, 100, 12, 1333.0).cuda()
    wh = gts[..., 2:] - gts[..., :2]
    anchors = torch.tensor([[116, 90], [156, 198], [373, 326], [30, 61], [62, 45], [42, 119], [10, 13], [16, 30],
                            [33, 23]], dtype=torch.float32, device="cuda")
    decoded = _iou_boxes(rng, (8, 3 * (25 * 42 + 50 * 84 + 100 * 168), 4), 1333.0).cuda()
    for a, b in ((torch.cat([-wh / 2, wh / 2], -1), torch.cat([-anchors / 2, anchors / 2], 1)), (decoded, gts)):
        got = box_iou(a, b)
        assert torch.equal(bits(got), bits(box_iou_plain(a, b)))
        assert torch.equal(bits(got), bits(box_iou(a, b)))
