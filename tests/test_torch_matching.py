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

JAX is imported inside the fixture, so the CUDA test at the end also runs on a
machine without JAX:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_matching.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from basedet_tpu_torch.ops.matching_kernel import dynamic_k_matching, dynamic_k_matching_plain


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
