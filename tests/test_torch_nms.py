"""The port's NMS (basedet_tpu_torch/ops) against the JAX package on the CPU.

The keep mask is held exactly to the Pallas kernel in interpret mode, as
tests/ops/test_nms_pallas.py runs it: both evaluate
``inter > t * max(union, 1e-12)``. The sort, compaction and class-offset
wrappers are held exactly (indices, labels, valid) to the JAX functions, which
on the CPU take the XLA path; boxes agree to 1e-6.

JAX is imported inside the fixtures, so the CUDA test at the end also runs on
a machine without JAX:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_nms.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from basedet_tpu_torch.layers.common.post_processing import post_processing
from basedet_tpu_torch.ops import (
    NEG_INF,
    batched_nms_padded,
    nms_keep,
    nms_keep_plain,
    nms_padded,
)
from basedet_tpu_torch.structures import box_iou, clip_boxes, convert_boxes
from tests.torch_threads import torch_threads  # noqa: F401


def random_boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(1, size / 3, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's NMS functions and the sequential greedy oracle."""
    import types

    import jax
    import jax.numpy as jnp

    from basedet_tpu.layers.common import post_processing as jpost
    from basedet_tpu.ops import nms as jnms
    from basedet_tpu.ops.nms_pallas import nms_keep_pallas
    from tests.ops.test_nms import greedy_nms_oracle

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, nms=jnms, post=jpost,
        keep_pallas=nms_keep_pallas, oracle=greedy_nms_oracle,
    )


def _keep_pallas(jx, boxes, valid, t):
    return np.asarray(jx.keep_pallas(jx.jnp.asarray(boxes), jx.jnp.asarray(valid), t,
                                     interpret=True))


def test_box_ops_match_jax(jx):
    """convert_boxes, box_iou (with degenerate boxes) and clip_boxes."""
    from basedet_tpu import structures as js

    rng = np.random.RandomState(9)
    a = random_boxes(rng, 40, size=120.0)
    b = np.concatenate([random_boxes(rng, 30, size=120.0), np.zeros((2, 4), np.float32)])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(box_iou(ta, tb).numpy(),
                                  np.asarray(js.box_iou(jx.jnp.asarray(a), jx.jnp.asarray(b))))
    for src, dst in [("xyxy", "xcycwh"), ("xcycwh", "xyxy"), ("xyxy", "xywh")]:
        np.testing.assert_array_equal(convert_boxes(ta, src, dst).numpy(),
                                      np.asarray(js.convert_boxes(jx.jnp.asarray(a), src, dst)))
    h, w = np.float32(90.0), np.float32(70.0)
    got = clip_boxes(ta[None], torch.tensor([h]), torch.tensor([w]))[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(js.clip_boxes(jx.jnp.asarray(a), (h, w))))


@pytest.mark.parametrize("n,seed", [(600, 0), (2720, 1)])
def test_nms_keep_plain_matches_pallas_interpret(jx, n, seed):
    """Multi-tile, with a random validity mask (invalid boxes anywhere in
    the order), at the IoU threshold YOLOX evaluates with."""
    rng = np.random.RandomState(seed)
    boxes = random_boxes(rng, n, size=300.0)
    valid = rng.uniform(size=n) > 0.2
    got = nms_keep_plain(torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None], 0.65)
    np.testing.assert_array_equal(got[0].numpy(), _keep_pallas(jx, boxes, valid, 0.65))


def test_nms_keep_plain_threshold_boundary(jx):
    """inter == t · union exactly does not suppress (strict >); more overlap
    does. Integer coordinates keep every product exact."""
    boxes = np.asarray(
        [[0, 0, 10, 10], [0, 0, 10, 5],      # inter 50, union 100: t=0.5 → kept
         [20, 0, 30, 10], [20, 0, 30, 7.5],  # inter 75, union 100
         [40, 0, 50, 10], [40, 0, 50, 10],   # identical boxes
         [60, 0, 70, 10], [60, 0, 70, 6]],   # inter 60 > 0.5 · 100
        np.float32,
    )
    valid = np.ones(len(boxes), bool)
    for t in (0.5, 0.75):
        got = nms_keep_plain(torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None], t)[0]
        np.testing.assert_array_equal(got.numpy(), _keep_pallas(jx, boxes, valid, t))
    got = nms_keep_plain(torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None], 0.5)[0]
    assert got.tolist() == [True, True, True, False, True, False, True, False]


def test_nms_padded_matches_jax(jx):
    rng = np.random.RandomState(2)
    n = 700
    boxes = random_boxes(rng, n, size=300.0)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    scores[rng.uniform(size=n) < 0.1] = NEG_INF                 # padding entries
    scores[:40] = scores[40]                                    # ties: lowest index first
    ref = jx.nms.nms_padded(jx.jnp.asarray(boxes), jx.jnp.asarray(scores), 0.5, 100)
    got = nms_padded(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None], 0.5, 100)
    idx, out_boxes, out_scores, valid = (t[0].numpy() for t in got)
    np.testing.assert_array_equal(idx, np.asarray(ref[0]))
    np.testing.assert_array_equal(valid, np.asarray(ref[3]))
    np.testing.assert_allclose(out_boxes, np.asarray(ref[1]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out_scores, np.asarray(ref[2]))


def test_nms_padded_fewer_candidates_than_slots(jx):
    rng = np.random.RandomState(3)
    boxes = random_boxes(rng, 30)
    scores = rng.uniform(0.01, 1.0, 30).astype(np.float32)
    ref = jx.nms.nms_padded(jx.jnp.asarray(boxes), jx.jnp.asarray(scores), 0.3, 64)
    got = nms_padded(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None], 0.3, 64)
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[3][0].numpy(), np.asarray(ref[3]))


def test_batched_nms_padded_matches_jax(jx):
    """Two images of one batch against the JAX function per image."""
    rng = np.random.RandomState(4)
    B, n = 2, 500
    boxes = np.stack([random_boxes(rng, n, size=200.0) for _ in range(B)])
    scores = rng.uniform(0.01, 1.0, (B, n)).astype(np.float32)
    scores[rng.uniform(size=(B, n)) < 0.2] = NEG_INF
    labels = rng.randint(0, 5, (B, n)).astype(np.int32)
    got = batched_nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                             torch.from_numpy(labels), 0.5, 100)
    for b in range(B):
        ref = jx.nms.batched_nms_padded(jx.jnp.asarray(boxes[b]), jx.jnp.asarray(scores[b]),
                                        jx.jnp.asarray(labels[b]), 0.5, 100)
        np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[3][b].numpy(), np.asarray(ref[3]))
        np.testing.assert_allclose(got[1][b].numpy(), np.asarray(ref[1]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[2][b].numpy(), np.asarray(ref[2]))


def test_post_processing_matches_jax(jx):
    rng = np.random.RandomState(5)
    B, n = 2, 400
    boxes = np.stack([random_boxes(rng, n, size=96.0) for _ in range(B)])
    scores = rng.uniform(0.0, 1.0, (B, n)).astype(np.float32)
    scores[scores < 0.1] = NEG_INF
    labels = rng.randint(0, 80, (B, n)).astype(np.int32)
    img_info = np.asarray([[96, 96, 480, 640, 3], [96, 96, 96, 96, 1]], np.float32)
    got = post_processing(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(labels), torch.from_numpy(img_info), 0.65, 100)
    for b in range(B):
        ref = jx.post.post_processing(
            jx.jnp.asarray(boxes[b]), jx.jnp.asarray(scores[b]), jx.jnp.asarray(labels[b]),
            jx.jnp.asarray(img_info[b]), iou_threshold=0.65, max_detections=100,
        )
        np.testing.assert_allclose(got[0][b].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(got[2][b].numpy(), np.asarray(ref[2]))
        np.testing.assert_array_equal(got[3][b].numpy(), np.asarray(ref[3]))


def test_nms_padded_matches_greedy_oracle(jx):
    rng = np.random.RandomState(6)
    n = 900
    boxes = random_boxes(rng, n, size=300.0)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    expected = jx.oracle(boxes, scores, 0.5)[:200]
    idx, _, _, valid = nms_padded(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
                                  0.5, 200)
    np.testing.assert_array_equal(idx[0][valid[0]].numpy(), expected)


def test_nms_keep_on_cpu_takes_the_plain_version():
    rng = np.random.RandomState(7)
    boxes = torch.from_numpy(random_boxes(rng, 50))[None]
    valid = torch.ones(1, 50, dtype=torch.bool)
    launches, calls = nms_keep.launches, nms_keep_plain.calls
    nms_keep(boxes, valid, 0.5)
    assert (nms_keep.launches, nms_keep_plain.calls) == (launches, calls + 1)


@pytest.mark.parametrize(
    "boxes,valid",
    [
        (torch.zeros(1, 5, 4, dtype=torch.float64), torch.ones(1, 5, dtype=torch.bool)),
        (torch.zeros(5, 4), torch.ones(5, dtype=torch.bool)),
        (torch.zeros(1, 5, 4), torch.ones(1, 5, dtype=torch.int32)),
        (torch.zeros(1, 5, 4), torch.ones(1, 4, dtype=torch.bool)),
    ],
    ids=["float64", "unbatched", "int-valid", "short-valid"],
)
def test_nms_keep_rejects_what_the_kernel_does_not_take(boxes, valid):
    with pytest.raises((TypeError, ValueError)):
        nms_keep(boxes, valid, 0.5)


# -- the word-blocked sweep of csrc/nms.cu, modelled in torch -------------------------------------

def _suppress_words(boxes: torch.Tensor, t: float) -> np.ndarray:
    """(B, K, 4) → (B, K, ceil(K/64)) uint64: bit e of word w of row i is set
    where box i suppresses box 64w + e > i, the kernel's predicate in its
    operations and order (nms_keep_plain's)."""
    B, K = boxes.shape[:2]
    x1, y1, x2, y2 = boxes.unbind(-1)
    iw = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :])).clamp(min=0.0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :])).clamp(min=0.0)
    inter = iw * ih
    area = (x2 - x1) * (y2 - y1)
    union = (area[:, :, None] + area[:, None, :]) - inter
    sup = (inter > torch.tensor(t, dtype=torch.float32) * union.clamp(min=1e-12))
    sup &= torch.ones((K, K), dtype=torch.bool).triu(1)
    words = -(-K // 64)
    padded = np.zeros((B, K, words * 64), bool)
    padded[:, :, :K] = sup.numpy()
    return np.packbits(padded, axis=-1, bitorder="little").view("<u8")


def word_sweep_model(boxes: torch.Tensor, valid: torch.Tensor, t: float) -> torch.Tensor:
    """The sweep of ``csrc/nms.cu`` in plain Python: one round per 64-box
    word, its decisions resolved from the diagonal words (up to four Jacobi
    rounds, then if they have not settled a loop over the kept boxes), then
    the kept rows ORed into the later ``removed`` words. Mask words the kernel never computes are filled with all ones
    first (rows of invalid boxes, words left of the diagonal), so the model
    fails if the sweep reads them."""
    B, K = valid.shape
    words = -(-K // 64)
    mask = _suppress_words(boxes, t).copy()
    ones = np.uint64(2**64 - 1)
    v = valid.numpy()
    keep = np.zeros((B, K), bool)
    for b in range(B):
        mask[b][~v[b]] = ones
        for i in range(K):
            mask[b, i, : i // 64] = ones
        removed = [0] * words
        for w in range(words):
            lo, hi = 64 * w, min(K, 64 * w + 64)
            valid_bits = sum(1 << e for e in range(hi - lo) if v[b, lo + e])
            cand0 = valid_bits & ~removed[w]
            kept, settled = cand0, False
            for _ in range(4):  # Jacobi rounds: a fixed point is the greedy result
                sup = 0
                for e in range(hi - lo):
                    if (kept >> e) & 1:
                        sup |= int(mask[b, lo + e, w])
                nxt = cand0 & ~sup
                settled, kept = nxt == kept, nxt
                if settled:
                    break
            if not settled:  # one kept box at a time
                cand, kept = cand0, 0
                while cand:
                    i = (cand & -cand).bit_length() - 1
                    kept |= 1 << i
                    cand &= cand - 1
                    cand &= ~int(mask[b, lo + i, w])
            for e in range(hi - lo):
                keep[b, lo + e] = bool((kept >> e) & 1)
            if kept:
                for wp in range(w + 1, words):
                    acc = removed[wp]
                    for e in range(64):
                        if (kept >> e) & 1:
                            acc |= int(mask[b, lo + e, wp])
                    removed[wp] = acc
    return torch.from_numpy(keep)


def _sweep_cases():
    """(name, boxes (1, K, 4), valid (1, K), t) for the word-blocked sweep."""
    rng = np.random.RandomState(11)
    cases = []
    for K in (1, 63, 64, 65, 1037, 4097):
        cases.append((f"random K={K}", random_boxes(rng, K, size=40.0 * K ** 0.5),
                      rng.uniform(size=K) > 0.1, 0.5))
    centers = rng.uniform(0, 300, (12, 2))
    pick = rng.randint(0, 12, 700)
    c = centers[pick] + rng.normal(0, 3, (700, 2))
    cases.append(("clustered K=700", np.concatenate([c - 20, c + 20], 1).astype(np.float32),
                  np.ones(700, bool), 0.65))
    # equal scores: the stable order puts ties in index order, which the sweep must keep
    boxes = random_boxes(rng, 500, size=200.0)
    scores = np.round(rng.uniform(size=500), 1)
    order = np.argsort(-scores, kind="stable")
    cases.append(("equal scores", boxes[order], np.ones(500, bool), 0.5))
    edge = np.float32([[0, 0, 10, 10], [0, 0, 10, 5], [20, 0, 30, 10], [20, 0, 30, 7.5]])
    tiled = np.concatenate([edge + 40 * i for i in range(40)])  # inter == t*union exactly
    for t in (0.5, 0.75):
        cases.append((f"inter == {t}*union", tiled, np.ones(len(tiled), bool), t))
    K = 320
    boxes = random_boxes(rng, K, size=120.0)
    at_edges = np.ones(K, bool)
    at_edges[[0, 63, 64, 127, 128, 191, 255, 256, 319]] = False
    cases.append(("invalid at word boundaries", boxes, at_edges, 0.5))
    cases.append(("invalid interleaved", boxes, np.arange(K) % 2 == 1, 0.5))
    cases.append(("one word all invalid", boxes, (np.arange(K) // 64) != 2, 0.5))
    grid = np.stack(np.meshgrid(np.arange(20) * 30.0, np.arange(15) * 30.0), -1).reshape(-1, 2)
    cases.append(("all disjoint", np.concatenate([grid, grid + 20], 1).astype(np.float32),
                  np.ones(len(grid), bool), 0.3))
    same = np.broadcast_to(np.float32([5, 5, 50, 60]), (200, 4)).copy()
    cases.append(("all identical", same, np.ones(200, bool), 0.5))
    # a chain: box k suppresses box k + 1 (IoU 0.54) but not k + 2 (0.25), so the greedy result
    # alternates and the Jacobi rounds do not settle; the words fall back to the walk
    x = 3.0 * np.arange(150, dtype=np.float32)
    chain = np.stack([x, np.zeros_like(x), x + 10, np.full_like(x, 10)], 1)
    cases.append(("suppression chain", chain, np.ones(150, bool), 0.5))
    return cases


SWEEP_CASES = _sweep_cases()


@pytest.mark.parametrize("case", SWEEP_CASES, ids=[c[0] for c in SWEEP_CASES])
def test_word_sweep_model_matches_plain_and_pallas(jx, case):
    """The kernel's word-blocked sweep, modelled, against nms_keep_plain and
    the Pallas kernel in interpret mode: equal on every case."""
    name, boxes, valid, t = case
    b, v = torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None]
    got = word_sweep_model(b, v, t)
    np.testing.assert_array_equal(got.numpy(), nms_keep_plain(b, v, t).numpy())
    np.testing.assert_array_equal(got[0].numpy(), _keep_pallas(jx, boxes, valid, t))
    if name == "all disjoint":
        assert bool(got.all())
    if name == "all identical":
        assert got[0].tolist() == [True] + [False] * 199
    if name == "suppression chain":
        assert got[0].tolist() == [k % 2 == 0 for k in range(150)]


@pytest.mark.cuda
def test_nms_kernel_matches_plain_on_gpu_edge_cases():
    """The redesigned sweep on the card: every case of the word-blocked sweep
    model, batched in twos, equal to nms_keep_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the NMS kernel has no CPU mode")
    for name, boxes, valid, t in SWEEP_CASES:
        b = torch.from_numpy(np.stack([boxes, boxes[::-1].copy()])).cuda()
        v = torch.from_numpy(np.stack([valid, valid[::-1].copy()])).cuda()
        launches = nms_keep.launches
        got = nms_keep(b, v, t)
        torch.cuda.synchronize()
        assert nms_keep.launches == launches + 1
        assert torch.equal(got, nms_keep_plain(b, v, t)), name


@pytest.mark.cuda
def test_nms_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the NMS kernel has no CPU mode")
    rng = np.random.RandomState(8)
    for B, K, t in [(8, 3000, 0.65), (3, 1000, 0.5), (1, 1, 0.65), (2, 65, 0.3)]:
        boxes = torch.from_numpy(np.stack([random_boxes(rng, K, size=640.0) for _ in range(B)]))
        valid = torch.from_numpy(rng.uniform(size=(B, K)) > 0.1)
        boxes, valid = boxes.cuda(), valid.cuda()
        got = nms_keep(boxes, valid, t)
        torch.cuda.synchronize()
        assert torch.equal(got, nms_keep_plain(boxes, valid, t))
