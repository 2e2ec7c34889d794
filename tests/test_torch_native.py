"""The port's host library (``basedet_tpu_torch/native``) against its plain
versions and the JAX package: ``match_dets`` and ``coco_match_area`` against
``_match_python`` on COCO-like pairs (ties, crowd gts, more than 1024 gts),
``evaluate_coco_map`` against the JAX package's on the same records (all 12
metrics bit for bit, through the batched and the per-pair path), the C++
pack against the numpy pack byte for byte, and a build that fails raising."""
import numpy as np
import pytest

from basedet_tpu_torch.evaluators import coco_metrics as M
from basedet_tpu_torch.native import build as native_build
from tests.torch_threads import torch_threads  # noqa: F401


def _pair(rng, D, G, crowd=0.2, ties=False):
    """A prepped (image, class) pair of ``_prep_pair``: COCO-like xywh boxes,
    the detections jittered copies of gts; with ``ties`` equal scores and
    duplicated detections, so that IoUs tie."""
    g = np.concatenate([rng.uniform(0, 400, (G, 2)), rng.uniform(4, 200, (G, 2))], 1)
    src = g[rng.integers(0, max(G, 1), D)] if G else np.concatenate([rng.uniform(0, 400, (D, 2)),
                                                                     rng.uniform(4, 200, (D, 2))], 1)
    d = src + rng.normal(0, 6, (D, 4)) * [1, 1, 0.5, 0.5]
    d[:, 2:] = np.abs(d[:, 2:]) + 1
    if ties:
        d[1::2] = d[0::2][: len(d[1::2])]
    scores = np.round(rng.uniform(0, 1, D), 1 if ties else 6)
    dts = [dict(bbox=list(b), score=float(s)) for b, s in zip(d, scores)]
    gts = [dict(bbox=list(b), area=float(b[2] * b[3]), iscrowd=int(rng.uniform() < crowd)) for b in g]
    return dts, gts


CASES = {"plain": (40, 12, False), "ties": (60, 8, True), "no gts": (10, 0, False), "no dets": (0, 5, False),
         "over 1024 gts": (24, 1100, False)}


@pytest.mark.parametrize("case", list(CASES))
def test_match_dets_equals_python(case):
    D, G, ties = CASES[case]
    dts, gts = _pair(np.random.default_rng(len(case)), D, G, ties=ties)
    for area in M.AREA_RANGES.values():
        want, got = M._eval_img(dts, gts, area, 100, M._match_python), M._eval_img(dts, gts, area, 100)
        for k in want:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), (case, area, k)


def _preps(rng, n, big=False):
    keys, preps = [], []
    for i in range(n):
        D, G = int(rng.integers(0, 30)), int(rng.integers(0, 15))
        if big and i == n // 2:
            G = 1030
        p = M._prep_pair(*_pair(rng, D, G, ties=bool(i % 3 == 0)), max_det=100)
        if p is not None:
            keys.append((i % 3, i))
            preps.append(p)
    return keys, preps


def test_coco_match_area_equals_python():
    keys, preps = _preps(np.random.default_rng(3), 40)
    got = M._eval_areas_batched(keys, preps, list(M.AREA_RANGES))
    for (cat, img), p in zip(keys, preps):
        for name, area in M.AREA_RANGES.items():
            want, g = M._eval_prepped(p, area, M._match_python), got[(cat, name, img)]
            assert np.array_equal(g["dt_matches"] > 0, want["dt_matches"] > 0), (img, name)
            assert np.array_equal(g["dt_ignore"], want["dt_ignore"]) and g["num_gt"] == want["num_gt"], (img, name)


def test_more_than_1024_gts_takes_the_per_pair_path():
    keys, preps = _preps(np.random.default_rng(4), 6, big=True)
    assert M._eval_areas_batched(keys, preps, list(M.AREA_RANGES)) is None


def _records(rng, n_img, n_cls, big=False):
    gt_by, dt_by = {}, {}
    for img in range(n_img):
        for c in range(1, n_cls + 1):
            if rng.uniform() < 0.3:
                continue
            G = 1030 if big and img == 0 and c == 1 else int(rng.integers(0, 6))
            dts, gts = _pair(rng, int(rng.integers(0, 25)), G, ties=img % 4 == 0)
            if gts:
                gt_by[(img, c)] = gts
            if dts:
                dt_by[(img, c)] = dts
    return gt_by, dt_by, list(range(n_img)), list(range(1, n_cls + 1))


@pytest.mark.parametrize("big", [False, True], ids=["batched", "per-pair"])
def test_evaluate_coco_map_equals_jax(big):
    from basedet_tpu.evaluators.coco_metrics import evaluate_coco_map as jax_evaluate

    args = _records(np.random.default_rng(5 + big), 24, 4, big)
    want = jax_evaluate(*args)
    got = M.evaluate_coco_map(*args)
    plain = M.evaluate_coco_map(*args, match=M._match_python)
    assert len(got) == 12 and got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k] == plain[k], k  # bit for bit
    assert 0 < got["AP"] < 1


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("with_mask", [False, True])
def test_pack_equals_numpy_pack(dtype, with_mask):
    from basedet_tpu.native.pack import _pack_numpy

    from basedet_tpu_torch.data.collators.pack import pack_numpy
    from basedet_tpu_torch.native.pack import pack_into

    rng = np.random.default_rng(6)
    imgs = [rng.integers(0, 256, (int(h), int(w), 3)).astype(dtype) for h, w in rng.integers(1, 70, (5, 2))]
    imgs.append(np.zeros((70, 96, 3), dtype))  # a whole canvas
    pad = 114 if dtype == np.uint8 else 0.5
    out, mask = np.full((6, 70, 96, 3), 7, dtype), np.full((6, 70, 96), 9, np.uint8)
    pack_into(imgs, pad, out, mask if with_mask else None)
    want, want_mask = np.empty_like(out), np.empty_like(mask)
    pack_numpy(imgs, pad, want, want_mask)
    jax_out, jax_mask = _pack_numpy(imgs, 70, 96, pad, np.dtype(dtype), True)
    assert out.tobytes() == want.tobytes() == jax_out.tobytes()
    if with_mask:
        assert mask.tobytes() == want_mask.tobytes() == jax_mask.tobytes()
    else:
        assert (mask == 9).all()  # untouched
    with pytest.raises(ValueError, match="do not fit"):
        pack_into([np.zeros((71, 10, 3), dtype)], pad, out[:1])


def test_a_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "native_ops.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "_SRC", broken)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="building the host library failed"):
        native_build.build()
    assert not any((tmp_path / "_build").iterdir())  # no library, no temporary file left
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CXX", "/usr/bin/g++")  # not read
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native_build.build()
