"""The port's box structures (basedet_tpu_torch/structures) against the JAX
package's on the CPU: every case of tests/structures/test_boxes.py runs
through both packages, as one parametrised test, and the port is held to
the JAX result (1e-6 relative, 1e-6 absolute: the same f32 operations) and
to the golden values there; then ``Container``.

``clip_boxes`` differs in signature: the JAX package takes one image's
``(h, w)``, the port takes per-image h and w tensors for a (B, N, 4) batch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import basedet_tpu.structures as J
import basedet_tpu_torch.structures as P
from tests.torch_threads import torch_threads  # noqa: F401

B1 = [[0.0, 0.0, 10.0, 10.0], [0.0, 0.0, 5.0, 5.0], [2.0, 2.0, 8.0, 8.0]]
B2 = [[0.0, 0.0, 10.0, 10.0], [5.0, 5.0, 15.0, 15.0]]


def _jax(x):
    return jnp.asarray(np.asarray(x, np.float32))


def _torch(x):
    return torch.tensor(np.asarray(x, np.float32))


def _clip(S, b, hw):
    if S is J:
        return S.clip_boxes(b, hw)
    return S.clip_boxes(b[None], torch.tensor([float(hw[0])]), torch.tensor([float(hw[1])]))[0]


# name -> (function of (structures module, array maker) -> {output: array}, golden values)
CASES = {
    "area_center": (lambda S, a: {"area": S.box_area(a(B1)), "center": S.box_center(a(B2))},
                    {"area": [100.0, 25.0, 36.0], "center": [[5.0, 5.0], [10.0, 10.0]]}),
    "pairwise_intersection": (lambda S, a: {"inter": S.pairwise_intersection(a(B1), a(B2))},
                              {"inter": [[100.0, 25.0], [25.0, 0.0], [36.0, 9.0]]}),
    "iou": (lambda S, a: {"iou": S.box_iou(a(B1), a(B2))},
            {"iou": [[1.0, 25.0 / 175.0], [25.0 / 100.0, 0.0], [36.0 / 100.0, 9.0 / 127.0]]}),
    "ioa": (lambda S, a: {"ioa": S.box_ioa(a(B1), a(B2))},
            {"ioa": [[1.0, 0.25], [0.25, 0.0], [0.36, 0.09]]}),
    "giou_matches_iou_when_nested": (
        lambda S, a: {"giou": S.box_giou(a(B1[:1]), a(B1[1:2])), "iou": S.box_iou(a(B1[:1]), a(B1[1:2]))},
        {"giou": [[0.25]], "iou": [[0.25]]}),
    "giou_disjoint_negative": (lambda S, a: {"giou": S.box_giou(a([[0.0, 0.0, 1.0, 1.0]]), a([[2.0, 2.0, 3.0, 3.0]]))},
                               {"giou": [[-7.0 / 9.0]]}),
    "elementwise_iou": (lambda S, a: {"e": S.elementwise_iou(a(B1[:2]), a(B2))}, {"e": [1.0, 0.0]}),
    "point_distance": (lambda S, a: {"d": S.point_distance(a([[5.0, 5.0], [0.0, 0.0]]), a(B2))},
                       {"d": [[[5.0, 5.0, 5.0, 5.0], [0.0, 0.0, 10.0, 10.0]],
                              [[0.0, 0.0, 10.0, 10.0], [-5.0, -5.0, 15.0, 15.0]]]}),
    "clip_scale_nonempty": (
        lambda S, a: {"clip": _clip(S, a([[-5.0, -5.0, 20.0, 20.0], [3.0, 3.0, 3.0, 9.0]]), (10, 12)),
                      "scale": S.scale_boxes(a([[-5.0, -5.0, 20.0, 20.0], [3.0, 3.0, 3.0, 9.0]]), 2.0, 0.5),
                      "nonempty": S.nonempty_mask(a([[-5.0, -5.0, 20.0, 20.0], [3.0, 3.0, 3.0, 9.0]]))},
        {"clip": [[0, 0, 12, 10], [3, 3, 3, 9]], "scale": [[-10.0, -2.5, 40.0, 10.0], [6.0, 1.5, 6.0, 4.5]],
         "nonempty": [True, False]}),
    "convert_roundtrip": (
        lambda S, a: {"xywh": S.convert_boxes(a([[2.0, 3.0, 8.0, 11.0]]), "xyxy", "xywh"),
                      "xcycwh": S.convert_boxes(a([[2.0, 3.0, 8.0, 11.0]]), "xyxy", "xcycwh"),
                      "back": S.convert_boxes(S.convert_boxes(a([[2.0, 3.0, 8.0, 11.0]]), "xyxy", "xcycwh"),
                                              "xcycwh", "xyxy")},
        {"xywh": [[2, 3, 6, 8]], "xcycwh": [[5, 7, 6, 8]], "back": [[2.0, 3.0, 8.0, 11.0]]}),
    "boxcoder_roundtrip": (
        lambda S, a: (lambda c, an, gt: {"rec": c.decode(an, c.encode(an, gt))})(
            S.BoxCoder(reg_mean=(0.1, 0.2, 0.0, 0.0), reg_std=(1.0, 1.0, 2.0, 2.0)),
            a([[0.0, 0.0, 10.0, 10.0], [5.0, 5.0, 9.0, 13.0]]), a([[1.0, 2.0, 11.0, 9.0], [4.0, 4.0, 10.0, 12.0]])),
        {"rec": [[1.0, 2.0, 11.0, 9.0], [4.0, 4.0, 10.0, 12.0]]}),
    "sum_coder_roundtrip": (
        lambda S, a: (lambda c: {"rec": c.decode(a([[0.0, 0.0, 10.0, 10.0]]),
                                                 c.encode(a([[0.0, 0.0, 10.0, 10.0]]), a([[1.0, 2.0, 11.0, 9.0]]))),
                                 "deltas": c.encode(a([[0.0, 0.0, 10.0, 10.0]]), a([[1.0, 2.0, 11.0, 9.0]]))})(
            S.SumBoxCoder(reg_std=(2.0, 2.0, 2.0, 2.0))),
        {"rec": [[1.0, 2.0, 11.0, 9.0]], "deltas": [[0.5, 1.0, 0.5, -0.5]]}),
    "point_coder_roundtrip": (
        lambda S, a: (lambda c, pts, gt: {"deltas": c.encode(pts, gt), "rec": c.decode(pts, c.encode(pts, gt))})(
            S.PointCoder(), a([[5.0, 5.0], [3.0, 4.0]]), a([[1.0, 2.0, 11.0, 9.0], [0.0, 0.0, 6.0, 8.0]])),
        {"deltas": [[4.0, 3.0, 6.0, 4.0], [3.0, 4.0, 3.0, 4.0]],
         "rec": [[1.0, 2.0, 11.0, 9.0], [0.0, 0.0, 6.0, 8.0]]}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_structures_match_jax(name):
    fn, golden = CASES[name]
    want = {k: np.asarray(v) for k, v in fn(J, _jax).items()}
    got = {k: v.numpy() for k, v in fn(P, _torch).items()}
    assert set(got) == set(want) == set(golden)
    for k in golden:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k], np.asarray(golden[k]), rtol=1e-4, atol=1e-3, err_msg=k)


def test_container_fields_and_index():
    c = P.Container(boxes=torch.arange(12.0).reshape(3, 4), scores=torch.tensor([0.5, 0.9, 0.1]))
    c.labels = torch.tensor([1, 2, 3])
    assert set(c) == {"boxes", "scores", "labels"} and c["labels"] is c.labels
    keep = c.scores > 0.3
    sub = c.index(keep)
    assert isinstance(sub, P.Container)
    assert torch.equal(sub.boxes, c.boxes[keep]) and torch.equal(sub.labels, torch.tensor([1, 2]))
    assert torch.equal(c.index(torch.tensor([2, 0])).scores, torch.tensor([0.1, 0.5]))
    with pytest.raises(AttributeError):
        c.missing
