"""The port's SimOTA dynamic-k matching (basedet_tpu_torch/ops/matching_kernel.py)
against the JAX package on the CPU, exactly.

``dynamic_k_matching_plain`` is held to the Pallas kernel in interpret mode (as
tests/ops/test_matching_pallas.py runs it), to the XLA scan version
``topk_dynamic_k_matching`` and to a numpy oracle, on every output element:
best_gt included where fg is false (0 there, in all four). The oracle is the
per-gt loop of tests/ops/test_matching_pallas.py, copied, with one change: it
sums the top-k ious one f32 add at a time, largest first, as both JAX kernels
do. numpy's ``sum`` adds pairwise, which lands on the other side of an integer
on the "integer sums" case below (2.9999995 against 3.0 for one of its rows).

``matching_model`` is the kernel's algorithm in numpy (csrc/matching.cu): keys
that order like the floats (-0.0 folded onto +0.0), a radix select of the k
largest ious and the dk lowest costs digit by digit, the ties at the cost
threshold taken in index order through per-thread runs, claims by the lowest
(cost key, gt); the row staged as keys or streamed (its floats read again on
every pass). It is held to ``dynamic_k_matching_plain`` on every case.

JAX is imported inside the fixture, so the CUDA tests at the end also run on a
machine without JAX:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_matching.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from basedet_tpu_torch.ops.matching_kernel import (
    MAX_STAGED,
    dynamic_k_matching,
    dynamic_k_matching_plain,
)
from tests.torch_threads import torch_threads  # noqa: F401

THREADS = 1024  # kThreads of the source: the runs of the cost ties
NONE = np.uint64(2**64 - 1)


def _naive(cost, ious, valid, k):
    """Per-gt loop over one image (K, M); the top-k sum is sequential f32."""
    K, M = cost.shape
    matching = np.zeros((K, M), bool)
    for g in range(K):
        if not valid[g]:
            continue
        top = np.sort(ious[g])[::-1][:k].astype(np.float32)
        dk = int(np.clip(int(np.cumsum(top, dtype=np.float32)[-1]), 1, k))
        order = np.argsort(cost[g], kind="stable")[:dk]
        matching[g, order] = True
    best = np.zeros(M, np.int32)
    fg = matching.any(axis=0)
    for a in np.where(fg)[0]:
        rows = np.where(matching[:, a])[0]
        best[a] = rows[np.argmin(cost[rows, a])]
    return best, fg


def _random(rng, B, K, M, prefix=True):
    cost = (rng.rand(B, K, M) * 10).astype(np.float32)
    ious = np.clip(rng.rand(B, K, M) * 1.2 - 0.1, 0, 1).astype(np.float32)
    if prefix:
        valid = np.arange(K)[None] < rng.randint(1, K + 1, (B, 1))
    else:
        valid = rng.rand(B, K) < 0.6
    cost = cost + np.float32(1e9) * ~valid[..., None]
    ious = ious * valid[..., None]
    return cost.astype(np.float32), ious.astype(np.float32), valid


def matching_cases():
    """name → (cost, ious, valid) as numpy, (B, K, M)."""
    rng = np.random.RandomState(0)
    cases = {"random": _random(rng, 3, 13, 257)}
    c, i, v = _random(rng, 2, 9, 300)
    cases["tied costs"] = (np.round(c, 1).astype(np.float32), i, v)
    c, i, v = _random(rng, 2, 9, 200)
    i[:, :, 100:] = i[:, :, :100]  # every iou twice
    i[:, :, 50:60] = 0.5  # and a run of equal ones
    cases["duplicated ious"] = (c, i, v)
    c, i, v = _random(rng, 2, 6, 128)
    tops = [np.float32([0.9, 0.7, 0.6, 0.3, 0.2, 0.1, 0.1, 0.05, 0.03, 0.02]),
            np.float32([0.7] * 10), np.float32([0.5] * 10), np.float32([0.1] * 10),
            np.float32([1.0, 1.0, 0.5, 0.5, 0.25, 0.25, 0.25, 0.25, 0.0, 0.0]),
            np.float32([0.95, 0.9, 0.85, 0.8, 0.7, 0.6, 0.5, 0.4, 0.2, 0.1])]
    i = (rng.rand(*i.shape) * 0.01).astype(np.float32)  # below every top value
    for g, top in enumerate(tops):
        i[:, g, rng.permutation(128)[:10]] = top
    cases["integer sums"] = (c, i, np.ones(v.shape, bool))
    cases["invalid rows"] = _random(rng, 3, 10, 150, prefix=False)
    cases["all invalid"] = (lambda c, i, v: (c, i * 0, v & False))(*_random(rng, 2, 4, 64))
    cases["K=1"] = _random(rng, 2, 1, 90)
    cases["M<10"] = _random(rng, 2, 5, 7)
    cases["B=5"] = _random(rng, 5, 8, 130)
    return cases


CASES = list(matching_cases())


def ordered_keys(values):
    """csrc/matching.cu's ordered_bits: f32 → u32 that order like the
    floats, -0.0 folded onto +0.0."""
    u = np.where(values == 0, np.float32(0), values).astype(np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def from_ordered_keys(keys):
    keys = np.asarray(keys, np.uint32)
    return np.where(keys & np.uint32(0x80000000), keys & np.uint32(0x7FFFFFFF), ~keys).astype(np.uint32).view(np.float32)


def radix_select_model(read, M, want):
    """The kernel's radix_select: ``read()`` gives the row's keys (again on
    every pass); the 8-bit digits from the top down, each keeping the bucket
    that holds rank ``want`` (1-based, lowest first), until the bucket holds
    exactly the ranks still wanted or all 32 bits are fixed. Returns
    (prefix, mask, want, group): keys under ``mask`` below ``prefix`` are
    taken, and ``want`` of the ``group`` keys equal to it."""
    prefix = mask = 0
    for shift in (24, 16, 8, 0):
        keys = read()
        assert keys.shape == (M,) and keys.dtype == np.uint32
        hist = np.bincount((keys[(keys & np.uint32(mask)) == prefix] >> np.uint32(shift)) & 0xFF, minlength=256)
        incl = np.cumsum(hist)
        digit = int(np.argmax(incl >= want))
        prefix |= digit << shift
        mask |= 0xFF << shift
        want -= int(incl[digit] - hist[digit])
        group = int(hist[digit])
        if group == want:
            break
    return prefix, mask, want, group


def matching_model(cost, ious, valid, k, staged=None):
    """The kernel on one batch (B, K, M) in numpy → (best_gt, fg). A row is
    staged (its keys made once) where M <= MAX_STAGED unless ``staged`` says
    otherwise, else streamed (its floats turned into keys on every pass)."""
    B, K, M = cost.shape
    staged = M <= MAX_STAGED if staged is None else staged
    best, fg = np.zeros((B, M), np.int32), np.zeros((B, M), bool)
    for b in range(B):
        claims = np.full(M, NONE, np.uint64)
        for g in range(K):
            if not valid[b, g]:
                continue
            if staged:
                ku, kc = ~ordered_keys(ious[b, g]), ordered_keys(cost[b, g])
                read_u, read_c = (lambda: ku), (lambda: kc)
            else:
                read_u, read_c = (lambda: ~ordered_keys(ious[b, g])), (lambda: ordered_keys(cost[b, g]))
            # dk: the k largest ious, summed largest first, one f32 add at a time
            prefix, mask, want, group = radix_select_model(read_u, M, k)
            keys = read_u()
            masked = keys & np.uint32(mask)
            top = keys[(masked < prefix) | ((group == want) & (masked == prefix))]
            top = np.sort(np.concatenate([top, np.full(k - len(top), prefix, np.uint32)]))
            assert len(top) == k
            total = np.float32(0)
            for v in from_ordered_keys(~top):
                total = np.float32(total + v)
            dk = int(np.clip(int(total), 1, k))
            # the dk lowest costs; ties at the threshold by per-thread runs in index order
            prefix, mask, want, group = radix_select_model(read_c, M, dk)
            keys = read_c()
            masked = keys & np.uint32(mask)
            chosen = masked < prefix
            if group == want:
                chosen |= masked == prefix
            else:
                run = -(-M // THREADS)
                ties = keys == prefix
                starts = np.concatenate([[0], np.cumsum([ties[t * run:(t + 1) * run].sum() for t in range(THREADS)])])
                for t in range(THREADS):
                    for m in np.flatnonzero(ties[t * run:(t + 1) * run]) + t * run:
                        if starts[t] < want:
                            chosen[m] = True
                        starts[t] += 1
            assert chosen.sum() == dk
            claims[chosen] = np.minimum(claims[chosen], (keys[chosen].astype(np.uint64) << np.uint64(32)) | np.uint64(g))
        fg[b] = claims != NONE
        best[b] = np.where(fg[b], (claims & np.uint64(0xFFFFFFFF)).astype(np.int64), 0)
    return best, fg


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from basedet_tpu.layers.common.matcher import topk_dynamic_k_matching
    from basedet_tpu.ops.matching_pallas import dynamic_k_matching_pallas

    scan = jax.jit(jax.vmap(topk_dynamic_k_matching, in_axes=(0, 0, 0)))
    return jnp, scan, dynamic_k_matching_pallas


def _plain(cost, ious, valid):
    best, fg = dynamic_k_matching_plain(torch.from_numpy(cost), torch.from_numpy(ious),
                                        torch.from_numpy(valid))
    return best.numpy(), fg.numpy()


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_pallas_scan_and_oracle(jx, name):
    jnp, scan, pallas = jx
    cost, ious, valid = matching_cases()[name]
    best, fg = _plain(cost, ious, valid)
    assert best.dtype == np.int32 and fg.dtype == bool
    args = (jnp.asarray(cost), jnp.asarray(ious), jnp.asarray(valid))
    k = min(10, cost.shape[2])
    for ref_best, ref_fg in (pallas(*args, k_cap=k, interpret=True), scan(*args)):
        np.testing.assert_array_equal(fg, np.asarray(ref_fg))
        np.testing.assert_array_equal(best, np.asarray(ref_best))
    for b in range(cost.shape[0]):
        ref_best, ref_fg = _naive(cost[b], ious[b], valid[b], k)
        np.testing.assert_array_equal(fg[b], ref_fg)
        np.testing.assert_array_equal(best[b], ref_best)


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "streamed"])
@pytest.mark.parametrize("name", CASES)
def test_matching_model_matches_plain(name, staged):
    cost, ious, valid = matching_cases()[name]
    best, fg = matching_model(cost, ious, valid, min(10, cost.shape[2]), staged)
    ref_best, ref_fg = _plain(cost, ious, valid)
    np.testing.assert_array_equal(fg, ref_fg)
    np.testing.assert_array_equal(best, ref_best)


@pytest.mark.parametrize("seed", range(4))
def test_radix_select_model_finds_the_rank(seed):
    """The threshold of rank ``want`` against a sort, on keys with many
    equal values, a shared top digit, -0.0 beside +0.0 and negatives."""
    rng = np.random.RandomState(seed)
    values = np.concatenate([
        np.float32(1e5) + rng.randint(0, 40, 300).astype(np.float32),  # one top digit, many ties
        rng.choice(np.float32([0.0, -0.0, 0.5, -2.0]), 50), rng.uniform(-30, 30, 150).astype(np.float32)])
    keys = ordered_keys(values[rng.permutation(len(values))])
    assert ordered_keys(np.float32([-0.0]))[0] == ordered_keys(np.float32([0.0]))[0]
    ranked = np.sort(keys)
    for want in (1, 2, 5, 10, 57, 300, 499, 500):
        prefix, mask, left, group = radix_select_model(lambda: keys, len(keys), want)
        masked = keys & np.uint32(mask)
        assert int((masked < prefix).sum()) == want - left and int((masked == prefix).sum()) == group
        assert 1 <= left <= group
        assert (ranked[want - 1] & np.uint32(mask)) == prefix
        if group != left:  # only a full key leaves ties
            assert mask == 0xFFFFFFFF and ranked[want - 1] == prefix


def test_matching_model_streams_past_the_staged_row():
    """At M = 22,300 (OTA at 800x1333) the row is streamed; the model, both
    ways, equals the plain version on three images of YOLOX-like rows."""
    assert 22300 > MAX_STAGED
    rng = np.random.RandomState(3)
    cost = (rng.uniform(0, 30, (3, 4, 22300)) + 1e5 * (rng.uniform(size=(3, 4, 22300)) > 0.02)).astype(np.float32)
    ious = (rng.uniform(size=(3, 4, 22300)) ** 6).astype(np.float32)
    cost[:, :, 100:160] = np.round(cost[:, :, 100:160])  # ties at the threshold
    valid = np.array([[True, True, False, True], [True, False, False, False], [False] * 4])
    ref_best, ref_fg = _plain(cost, ious, valid)
    for staged in (None, True):
        best, fg = matching_model(cost, ious, valid, 10, staged)
        np.testing.assert_array_equal(fg, ref_fg)
        np.testing.assert_array_equal(best, ref_best)


def test_matching_on_cpu_takes_the_plain_version():
    cost, ious, valid = matching_cases()["random"]
    launches, calls = dynamic_k_matching.launches, dynamic_k_matching_plain.calls
    best, fg = dynamic_k_matching(torch.from_numpy(cost), torch.from_numpy(ious),
                                  torch.from_numpy(valid))
    assert (dynamic_k_matching.launches, dynamic_k_matching_plain.calls) == (launches, calls + 1)
    ref_best, ref_fg = _plain(cost, ious, valid)
    np.testing.assert_array_equal(best.numpy(), ref_best)
    np.testing.assert_array_equal(fg.numpy(), ref_fg)


@pytest.mark.parametrize(
    "cost,ious,valid",
    [
        (torch.zeros(1, 2, 5, dtype=torch.float64), torch.zeros(1, 2, 5, dtype=torch.float64),
         torch.ones(1, 2, dtype=torch.bool)),
        (torch.zeros(2, 5), torch.zeros(2, 5), torch.ones(2, dtype=torch.bool)),
        (torch.zeros(1, 2, 5), torch.zeros(1, 2, 4), torch.ones(1, 2, dtype=torch.bool)),
        (torch.zeros(1, 2, 5), torch.zeros(1, 2, 5), torch.ones(1, 2, dtype=torch.int32)),
        (torch.zeros(1, 0, 5), torch.zeros(1, 0, 5), torch.ones(1, 0, dtype=torch.bool)),
    ],
    ids=["float64", "unbatched", "short-ious", "int-valid", "K=0"],
)
def test_matching_rejects_what_the_kernel_does_not_take(cost, ious, valid):
    with pytest.raises((TypeError, ValueError)):
        dynamic_k_matching(cost, ious, valid)


@pytest.mark.cuda
def test_matching_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the matching kernel has no CPU mode")
    for name, (cost, ious, valid) in matching_cases().items():
        args = [torch.from_numpy(a).cuda() for a in (cost, ious, valid)]
        best, fg = dynamic_k_matching(*args)
        torch.cuda.synchronize()
        ref_best, ref_fg = dynamic_k_matching_plain(*args)
        assert torch.equal(fg, ref_fg), name
        assert torch.equal(best, ref_best), name


@pytest.mark.cuda
def test_matching_kernel_streams_rows_past_shared_memory_on_gpu():
    """M = 22,300 (OTA at 800x1333), past the staged row: the kernel equals
    the plain version, with ties at the cost threshold and invalid rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the matching kernel has no CPU mode")
    rng = np.random.RandomState(4)
    B, K, M = 4, 20, 22300
    assert M > MAX_STAGED
    cost = (rng.uniform(0, 30, (B, K, M)) + 1e5 * (rng.uniform(size=(B, K, M)) > 0.02)).astype(np.float32)
    ious = (rng.uniform(size=(B, K, M)) ** 6).astype(np.float32)
    cost[:, :, 100:160] = np.round(cost[:, :, 100:160])
    valid = np.arange(K)[None] < np.array([[3], [20], [0], [11]])
    args = [torch.from_numpy(a).cuda() for a in (cost, ious, valid)]
    launches = dynamic_k_matching.launches
    best, fg = dynamic_k_matching(*args)
    torch.cuda.synchronize()
    assert dynamic_k_matching.launches == launches + 1
    ref_best, ref_fg = dynamic_k_matching_plain(*args)
    assert torch.equal(fg, ref_fg) and torch.equal(best, ref_best)


@pytest.mark.cuda
def test_matching_kernel_at_otas_shape_on_gpu():
    """OTA at 800x1344: B = 2, K = 100, M = 22,400 (streamed rows), k = 10,
    costs of ~1-20 on each gt's candidates, +1e6 off them and +1e9 on padded
    gts, ious 0 off the candidates: equal to the plain version, two runs
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the matching kernel has no CPU mode")
    rng = np.random.RandomState(8)
    B, K, M = 2, 100, 22400
    both = rng.uniform(size=(B, K, M)) < 0.003
    valid = np.arange(K)[None] < np.array([[7], [31]])
    cost = (rng.uniform(1.0, 20.0, (B, K, M)) + 1e6 * ~both + 1e9 * ~valid[..., None]).astype(np.float32)
    ious = np.where(both, rng.uniform(size=(B, K, M)), 0.0).astype(np.float32)
    args = [torch.from_numpy(a).cuda() for a in (cost, ious, valid)]
    best, fg = dynamic_k_matching(*args)
    again = dynamic_k_matching(*args)
    torch.cuda.synchronize()
    ref_best, ref_fg = dynamic_k_matching_plain(*args)
    assert torch.equal(fg, ref_fg) and torch.equal(best, ref_best)
    assert torch.equal(again[0], best) and torch.equal(again[1], fg)


@pytest.mark.cuda
def test_matching_kernel_leaves_its_scratch_reset_on_gpu():
    """The kernel's cached claim keys and done-counters must be back at kNone
    and 0 after every call: 200 calls in a row, over shapes that share and
    grow the scratch, each equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the matching kernel has no CPU mode")
    cases = [[torch.from_numpy(a).cuda() for a in arrays] for arrays in matching_cases().values()]
    refs = [dynamic_k_matching_plain(*args) for args in cases]
    for i in range(200):
        args, (ref_best, ref_fg) = cases[i % len(cases)], refs[i % len(cases)]
        best, fg = dynamic_k_matching(*args)
        assert torch.equal(fg, ref_fg) and torch.equal(best, ref_best), i
