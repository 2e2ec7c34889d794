"""The port's two-stage ground truth (basedet_tpu_torch: ``sample_mask``,
``Matcher``, ``first_argmax``, ``rpn_ground_truth``, ``rcnn_sample``) and
losses (``rpn_losses``, ``rcnn_losses``) against the JAX package on the CPU.

Both sides get the same inputs, made from a numpy seed, and the same noise:
the JAX functions draw theirs from keys, and ``jax_noise`` draws the same
five arrays by the same derivation (``FasterRCNNModule.__call__``,
``rpn_ground_truth_single``, ``rcnn_sample_single``) and hands them to the
port. Labels, match indices, masks and RoI slots must then be equal, element
for element; offsets and targets agree to 1e-6 (the coders' divisions and
logs in another library); the losses to 1e-6 relative and their gradients to
1e-6 of the largest entry (a sum in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basedet_tpu.layers.common import sampling as jsampling
from basedet_tpu.layers.common.matcher import Matcher as JMatcher
from basedet_tpu.layers.head.rcnn import rcnn_losses as jrcnn_losses
from basedet_tpu.layers.head.rcnn import rcnn_sample_single
from basedet_tpu.models.det.rpn import rpn_ground_truth_single
from basedet_tpu.models.det.rpn import rpn_losses as jrpn_losses
from basedet_tpu.structures import BoxCoder as JBoxCoder
from basedet_tpu_torch.layers.common.anchor_generator import DefaultAnchorGenerator
from basedet_tpu_torch.layers.common.function import first_argmax
from basedet_tpu_torch.layers.common.matcher import Matcher
from basedet_tpu_torch.layers.common.sampling import draw_sampling_noise, sample_mask
from basedet_tpu_torch.layers.head.rcnn import rcnn_losses, rcnn_sample
from basedet_tpu_torch.models.det.rpn import rpn_ground_truth, rpn_losses
from basedet_tpu_torch.structures import BoxCoder

IMG_H, IMG_W = 96, 128
K = 6  # padded gt rows


def jax_noise(rng, B, num_anchors, num_candidates):
    """The five uniform arrays that the JAX train branch draws from its
    ``sampling`` key, as numpy: per image, the RPN's positives and negatives
    from ``split(split(fold_in(rng, 0), B)[i])`` and the R-CNN's foreground,
    background and tie-break from ``split(split(fold_in(rng, 1), B)[i], 3)``."""
    def draw(keys, n):
        return np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])

    rpn = [jax.random.split(k) for k in jax.random.split(jax.random.fold_in(rng, 0), B)]
    rcnn = [jax.random.split(k, 3) for k in jax.random.split(jax.random.fold_in(rng, 1), B)]
    return {"rpn_pos": draw([k[0] for k in rpn], num_anchors),
            "rpn_neg": draw([k[1] for k in rpn], num_anchors),
            "rcnn_fg": draw([k[0] for k in rcnn], num_candidates),
            "rcnn_bg": draw([k[1] for k in rcnn], num_candidates),
            "rcnn_tie": draw([k[2] for k in rcnn], num_candidates)}


def as_torch(noise):
    return {k: torch.from_numpy(v) for k, v in noise.items()}


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_first_argmax_takes_the_lowest_index_like_jnp(dim):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 3, (4, 5, 6)).astype(np.float32)  # three values: ties everywhere
    x[1] = 0.0
    got = first_argmax(torch.from_numpy(x), dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.argmax(jnp.asarray(x), axis=dim)))
    assert got.dtype == torch.int64


SAMPLE_CASES = {
    # name: (candidates per image, quota per image, cap)
    "more_candidates_than_quota": ([30, 22], [10, 10], 16),
    "fewer_candidates_than_quota": ([5, 0], [10, 10], 16),
    "quota_zero_and_negative": ([30, 30], [0, -3], 16),
    "quota_per_image": ([30, 30], [3, 16], 16),
    "quota_above_cap": ([40, 40], [25, 16], 16),
    "cap_above_n": ([30, 50], [40, 60], 256),
}


@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_sample_mask_matches_jax(case):
    counts, quotas, cap = SAMPLE_CASES[case]
    n = 50
    rng = np.random.RandomState(1)
    candidates = np.stack([rng.permutation(n) < c for c in counts])
    keys = jax.random.split(jax.random.PRNGKey(3), len(counts))
    noise = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])
    want = np.stack([np.asarray(jsampling.sample_mask(k, jnp.asarray(c), q, cap=cap))
                     for k, c, q in zip(keys, candidates, quotas)])
    got = sample_mask(torch.from_numpy(noise), torch.from_numpy(candidates), torch.tensor(quotas), cap)
    np.testing.assert_array_equal(got.numpy(), want)
    for g, c, q in zip(got.numpy(), counts, quotas):
        assert g.sum() == min(c, max(min(q, cap), 0))
    if len(set(quotas)) == 1:  # an int quota is every image's quota
        same = sample_mask(torch.from_numpy(noise), torch.from_numpy(candidates), quotas[0], cap)
        assert torch.equal(same, got)


def test_sample_mask_keeps_one_more_on_a_tie_at_the_threshold(monkeypatch):
    """Equal noise at the quota-th largest score keeps both, in both packages."""
    noise = np.float32([[0.9, 0.5, 0.5, 0.1, 0.7, 0.3]])
    candidates = np.array([[True, True, True, True, False, True]])
    monkeypatch.setattr(jsampling.jax.random, "uniform", lambda rng, shape: jnp.asarray(noise[0]))
    want = np.asarray(jsampling.sample_mask(jax.random.PRNGKey(0), jnp.asarray(candidates[0]), 2, cap=4))
    got = sample_mask(torch.from_numpy(noise), torch.from_numpy(candidates), 2, 4)
    np.testing.assert_array_equal(got.numpy()[0], want)
    assert got.numpy()[0].tolist() == [True, True, True, False, False, False]


def test_draw_sampling_noise_depends_on_seed_and_step_only():
    a = draw_sampling_noise(42, 3, 2, 100, 20, "cpu")
    torch.rand(7)  # the global generator plays no part
    b = draw_sampling_noise(42, 3, 2, 100, 20, "cpu")
    assert set(a) == {"rpn_pos", "rpn_neg", "rcnn_fg", "rcnn_bg", "rcnn_tie"}
    for k in a:
        assert torch.equal(a[k], b[k])
        assert a[k].shape == (2, 100 if k.startswith("rpn") else 20)
        assert 0 <= float(a[k].min()) and float(a[k].max()) < 1
    assert not torch.equal(a["rpn_pos"], a["rpn_neg"])
    for other in (draw_sampling_noise(42, 4, 2, 100, 20, "cpu"), draw_sampling_noise(43, 3, 2, 100, 20, "cpu")):
        assert not torch.equal(a["rpn_pos"], other["rpn_pos"])


def _matcher_cases():
    rng = np.random.RandomState(2)
    m = 40
    tied = np.round(rng.uniform(0, 1, (2, K, m)), 1).astype(np.float32)  # ties across gts and anchors
    tied[0, 2] = tied[0, 1]  # a repeated gt
    smooth = rng.uniform(0, 1, (2, K, m)).astype(np.float32)
    unseen = smooth.copy()
    unseen[:, 1] = 0.0  # a valid gt that nothing overlaps: its row maximum is 0
    unseen[:, :, :5] = 0.0
    return {
        "ties": (tied, [4, K]),
        "no_gt": (smooth, [0, 3]),
        "gt_nothing_overlaps": (unseen, [3, 2]),
        "all_valid": (smooth, [K, K]),
    }


@pytest.mark.parametrize("low_quality", [True, False], ids=["low_quality", "thresholds_only"])
@pytest.mark.parametrize("case", sorted(_matcher_cases()))
def test_matcher_matches_jax(case, low_quality):
    matrix, num_valid = _matcher_cases()[case]
    valid = np.arange(K)[None] < np.asarray(num_valid)[:, None]
    jm = JMatcher((0.3, 0.7), (0, -1, 1), low_quality)
    want = [jm(jnp.asarray(x), jnp.asarray(v)) for x, v in zip(matrix, valid)]
    idx, labels = Matcher((0.3, 0.7), (0, -1, 1), low_quality)(torch.from_numpy(matrix), torch.from_numpy(valid))
    np.testing.assert_array_equal(idx.numpy(), np.stack([np.asarray(w[0]) for w in want]))
    np.testing.assert_array_equal(labels.numpy(), np.stack([np.asarray(w[1]) for w in want]))
    if case == "no_gt":
        assert (labels[0] == 0).all() and (idx[0] == 0).all()  # -1e8 everywhere: background
    if case == "gt_nothing_overlaps" and low_quality:
        assert (labels[:, :5] == 1).all()  # every zero-IoU anchor equals that gt's maximum


def _gt_boxes(rng, num_valid, repeat=False):
    """(B, K, 5) padded gt on the test image; with ``repeat`` the second box
    of the first image repeats the first (equal IoU with every anchor)."""
    B = len(num_valid)
    gt = np.zeros((B, K, 5), np.float32)
    for b, n in enumerate(num_valid):
        x1, y1 = rng.uniform(0, IMG_W * 0.6, n), rng.uniform(0, IMG_H * 0.6, n)
        w, h = rng.uniform(8, IMG_W * 0.4, n), rng.uniform(8, IMG_H * 0.4, n)
        gt[b, :n] = np.stack([x1, y1, np.minimum(x1 + w, IMG_W - 1), np.minimum(y1 + h, IMG_H - 1),
                              rng.randint(1, 81, n)], 1)
    if repeat:
        gt[0, 1, :4] = gt[0, 0, :4]
    return gt


def _anchors():
    gen = DefaultAnchorGenerator(((16,), (32,), (64,)), ((0.5, 1, 2),), (8, 16, 32), 0.5)
    return torch.cat(gen([(IMG_H // s, IMG_W // s) for s in (8, 16, 32)], "cpu")).numpy()


RPN_CASES = {
    # name: (gts per image, repeat a box, anchors sampled, positives at most)
    "default": ([3, 2], False, 64, 32),
    "repeated_gt_ties": ([4, 1], True, 64, 32),
    "no_gt_in_one_image": ([0, 3], False, 64, 32),
    "more_positives_than_quota": ([K, K], False, 16, 2),
    "fewer_candidates_than_quota": ([1, 1], False, 4096, 2048),
}


@pytest.mark.parametrize("case", sorted(RPN_CASES))
def test_rpn_ground_truth_matches_jax(case):
    num_valid, repeat, num_sample, num_pos = RPN_CASES[case]
    B = len(num_valid)
    gt = _gt_boxes(np.random.RandomState(4), num_valid, repeat)
    anchors = _anchors()
    rng = jax.random.PRNGKey(5)
    jm, jcoder = JMatcher((0.3, 0.7), (0, -1, 1), True), JBoxCoder()
    keys = jax.random.split(jax.random.fold_in(rng, 0), B)
    want_labels, want_offsets = jax.vmap(lambda r, g, n: rpn_ground_truth_single(
        r, jnp.asarray(anchors), g, n, jm, jcoder, num_sample, num_pos))(
        keys, jnp.asarray(gt), jnp.asarray(num_valid))
    noise = as_torch(jax_noise(rng, B, anchors.shape[0], 1))
    labels, offsets = rpn_ground_truth(
        noise["rpn_pos"], noise["rpn_neg"], torch.from_numpy(anchors), torch.from_numpy(gt),
        torch.tensor(num_valid), Matcher((0.3, 0.7), (0, -1, 1), True), BoxCoder(), num_sample, num_pos)
    want_labels = np.asarray(want_labels)
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    np.testing.assert_allclose(offsets.numpy(), np.asarray(want_offsets), rtol=0, atol=1e-6)
    pos, neg = (want_labels == 1).sum(1), (want_labels == 0).sum(1)
    assert (pos <= num_pos).all() and (pos + neg <= num_sample).all()
    for b, n in enumerate(num_valid):
        if n == 0:
            # nothing is foreground; with the matcher's -1e8 everything is background
            assert pos[b] == 0 and neg[b] == min(num_sample, anchors.shape[0])
        else:
            assert pos[b] > 0
    if case == "more_positives_than_quota":
        assert (pos == num_pos).all() and (neg == num_sample - num_pos).all()
    if case == "fewer_candidates_than_quota":
        assert (pos < num_pos).all() and (pos + neg < num_sample).all()


def _proposals(rng, gt, P):
    """(B, P, 4) proposals: jittered copies of the gt boxes (foreground),
    random boxes (background), and invalid zero rows at the end."""
    B = gt.shape[0]
    out = np.zeros((B, P, 4), np.float32)
    valid = np.zeros((B, P), bool)
    for b in range(B):
        n = int((gt[b, :, 2] > 0).sum())
        near = gt[b, rng.randint(0, max(n, 1), P // 3), :4] + rng.normal(0, 2.0, (P // 3, 4))
        x1, y1 = rng.uniform(0, IMG_W - 10, P // 2), rng.uniform(0, IMG_H - 10, P // 2)
        far = np.stack([x1, y1, x1 + rng.uniform(4, 40, P // 2), y1 + rng.uniform(4, 40, P // 2)], 1)
        rows = np.concatenate([near, far]).astype(np.float32)
        out[b, : len(rows)] = rows
        valid[b, : len(rows)] = True
    return out, valid


RCNN_CASES = {
    # name: (gts per image, repeat a box, proposals, rois, fg ratio)
    "default": ([3, 2], False, 60, 32, 0.25),
    "repeated_gt_ties": ([4, 2], True, 60, 32, 0.25),
    "no_gt_in_one_image": ([0, 3], False, 60, 32, 0.25),
    "more_foreground_than_quota": ([K, K], False, 90, 16, 0.25),
    "fewer_candidates_than_rois": ([1, 1], False, 30, 32, 0.5),
}


@pytest.mark.parametrize("case", sorted(RCNN_CASES))
def test_rcnn_sample_matches_jax(case):
    num_valid, repeat, P, num_rois, fg_ratio = RCNN_CASES[case]
    B = len(num_valid)
    rng_np = np.random.RandomState(6)
    gt = _gt_boxes(rng_np, num_valid, repeat)
    proposals, valid = _proposals(rng_np, gt, P)
    rng = jax.random.PRNGKey(7)
    jcoder = JBoxCoder((0.0,) * 4, (0.1, 0.1, 0.2, 0.2))
    keys = jax.random.split(jax.random.fold_in(rng, 1), B)
    want = jax.device_get(jax.vmap(lambda r, p, pv, g, n: rcnn_sample_single(
        r, p, pv, g, n, num_rois, fg_ratio, 0.5, 0.5, 0.0, jcoder))(
        keys, jnp.asarray(proposals), jnp.asarray(valid), jnp.asarray(gt), jnp.asarray(num_valid)))
    noise = as_torch(jax_noise(rng, B, 1, P + K))
    got = rcnn_sample(noise["rcnn_fg"], noise["rcnn_bg"], noise["rcnn_tie"], torch.from_numpy(proposals),
                      torch.from_numpy(valid), torch.from_numpy(gt), torch.tensor(num_valid), num_rois,
                      fg_ratio, 0.5, 0.5, 0.0, BoxCoder((0.0,) * 4, (0.1, 0.1, 0.2, 0.2)))
    rois, labels, targets, weight = (x.numpy() for x in got)
    np.testing.assert_array_equal(rois, want[0])  # the same slots in the same order
    np.testing.assert_array_equal(labels, want[1])
    np.testing.assert_allclose(targets, want[2], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(weight, want[3])
    assert np.isfinite(targets).all()
    fg = (labels > 0).sum(1)
    assert (fg <= int(num_rois * fg_ratio)).all()
    for b, n in enumerate(num_valid):
        if n == 0:  # neither foreground nor background: every row weighs 0
            assert weight[b].sum() == 0 and (labels[b] == -1).all()
        else:
            assert fg[b] > 0 and (labels[b] == 0).sum() > 0
    if case == "more_foreground_than_quota":
        assert (fg == int(num_rois * fg_ratio)).all() and (weight.sum(1) == num_rois).all()
    if case == "fewer_candidates_than_rois":
        assert (weight.sum(1) < num_rois).all() and (labels == -1).any()


def _grads(fn, *args):
    args = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*args)
    return [float(o.detach()) for o in out], torch.autograd.grad(sum(out), args)


@pytest.mark.parametrize("empty", [False, True], ids=["sampled", "nothing_sampled"])
def test_rpn_losses_match_jax(empty):
    rng = np.random.RandomState(8)
    B, R = 2, 300
    logits = rng.normal(0, 2, (B, R)).astype(np.float32)
    offsets = rng.normal(0, 1, (B, R, 4)).astype(np.float32)
    labels = np.full((B, R), -1) if empty else rng.choice([-1, 0, 1], (B, R), p=[0.7, 0.2, 0.1])
    gt_offsets = np.where((labels == 1)[..., None], rng.normal(0, 1, (B, R, 4)), 0.0).astype(np.float32)

    jfn = lambda lg, of: jrpn_losses(lg, of, jnp.asarray(labels), jnp.asarray(gt_offsets), 0.0)
    want = [float(x) for x in jfn(logits, offsets)]
    jgrads = jax.grad(lambda lg, of: sum(jfn(lg, of)), argnums=(0, 1))(jnp.asarray(logits), jnp.asarray(offsets))
    got, grads = _grads(lambda lg, of: rpn_losses(lg, of, torch.from_numpy(labels), torch.from_numpy(gt_offsets), 0.0),
                        logits, offsets)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    for g, j in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0, atol=1e-6 * max(np.abs(j).max(), 1e-30))
    assert (np.asarray(want) == 0).all() if empty else min(want) > 0
    if not empty:  # normalised by the batch's sampled anchors, not per image
        n = (labels >= 0).sum()
        assert abs(got[1] - np.abs(offsets - gt_offsets)[labels == 1].sum() / n) <= 1e-5 * got[1]


@pytest.mark.parametrize("empty", [False, True], ids=["sampled", "all_rows_weigh_0"])
def test_rcnn_losses_match_jax(empty):
    rng = np.random.RandomState(9)
    N, C = 64, 80
    logits = rng.normal(0, 2, (N, C + 1)).astype(np.float32)
    deltas = rng.normal(0, 1, (N, C, 4)).astype(np.float32)
    labels = np.full(N, -1) if empty else np.where(rng.uniform(size=N) < 0.3, rng.randint(1, C + 1, N),
                                                   rng.choice([0, -1], N, p=[0.8, 0.2]))
    weight = (labels >= 0).astype(np.float32)
    targets = np.where((labels > 0)[:, None], rng.normal(0, 1, (N, 4)), 0.0).astype(np.float32)

    jfn = lambda lg, dl: jrcnn_losses(lg, dl, jnp.asarray(labels), jnp.asarray(targets), jnp.asarray(weight), 0.0)
    want = [float(x) for x in jfn(logits, deltas)]
    jgrads = jax.grad(lambda lg, dl: sum(jfn(lg, dl)), argnums=(0, 1))(jnp.asarray(logits), jnp.asarray(deltas))
    got, grads = _grads(lambda lg, dl: rcnn_losses(lg, dl, torch.from_numpy(labels), torch.from_numpy(targets),
                                                   torch.from_numpy(weight), 0.0), logits, deltas)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    for g, j in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0, atol=1e-6 * max(np.abs(j).max(), 1e-30))
    assert (np.asarray(want) == 0).all() if empty else min(want) > 0
