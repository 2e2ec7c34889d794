"""The traffic generator: deterministic per seed, the same work for every
seed, and the statistics the traffic file states."""
from __future__ import annotations

import json

import torch

from conftest import BENCH


def mix():
    return json.loads((BENCH / "traffic" / "coco_train.json").read_text())


def pool(seed, batch=16, hw=(640, 640), pools=8):
    from core import traffic

    t = dict(mix(), pool_batches=pools)
    return traffic.train_pool(t, batch, hw, 100, 80, seed, "cpu")


def test_coco_train_is_deterministic_per_seed():
    a, b, c = pool(2 ** 31 + 7), pool(2 ** 31 + 7), pool(5)
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k])
    assert not torch.equal(a[0]["gt_boxes"], c[0]["gt_boxes"])
    counts = lambda p: sorted(torch.cat([x["im_info"][:, 4] for x in p]).tolist())  # noqa: E731
    assert counts(a) == counts(c)  # every seed the same multiset of gt counts


def test_coco_train_statistics():
    p = pool(11, batch=64, pools=16)
    n = torch.cat([x["im_info"][:, 4] for x in p])
    assert n.min() >= 1 and n.max() <= 100 and abs(float(n.mean()) - 7.3) < 0.15
    assert float((n <= 3).float().mean()) > 0.3 and n.max() >= 40  # most images hold few, a tail holds many
    gt = torch.cat([x["gt_boxes"] for x in p])
    valid = torch.arange(100)[None, :] < n[:, None]
    boxes = gt[valid]
    assert float((gt[~valid] == 0).all())
    side = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])).sqrt()
    shares = [float(((side >= lo) & (side < hi)).float().mean()) for lo, hi in ((0, 32), (32, 96), (96, 1e9))]
    for got, want in zip(shares, (0.41, 0.34, 0.25)):
        assert abs(got - want) < 0.03, shares
    assert float(boxes[:, :4].min()) >= 0 and float(boxes[:, 2].max()) <= 640 and float(boxes[:, 3].max()) <= 640
    labels = boxes[:, 4]
    assert labels.min() >= 1 and labels.max() <= 80 and labels.unique().numel() == 80
    for x in p:
        assert x["data"].dtype == torch.uint8 and x["data"].shape == (64, 640, 640, 3)


def test_coco_infer_host_batches():
    from core import traffic

    t = json.loads((BENCH / "traffic" / "coco_infer.json").read_text())
    a = traffic.infer_pool(t, 2, (64, 96), 3, "cpu")
    b = traffic.infer_pool(t, 2, (64, 96), 3, "cpu")
    assert len(a) == t["pool_batches"] and a[0]["data"].shape == (2, 64, 96, 3)
    assert all(torch.equal(x["data"], y["data"]) for x, y in zip(a, b))
    assert not torch.equal(a[0]["data"], a[1]["data"])
    assert a[0]["im_info"].tolist() == [[64, 96, 64, 96, 0]] * 2
