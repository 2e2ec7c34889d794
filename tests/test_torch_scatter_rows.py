"""The port's batched row scatter (``basedet_tpu_torch/ops/scatter_rows*.py``,
kernel #9 on the card) and ``gather_rows_batched`` against the JAX package
on the CPU: the plain version against ``scatter_rows_onehot_pallas(...,
interpret=True)`` (D a multiple of 128) and against ``scatter_rows_onehot``
(any D), ``gather_rows_batched``'s forward and gradient against ``jax.vjp``
of the JAX package's, and the edge cases against a float64 loop.

Inputs come from numpy with fixed seeds. Tolerance: each output element
within 2^-20 (8 f32 ulps at 1) of the sum of the |values| that land on it.
Both sides add the same f32 (or exact bf16) values; the JAX one-hot forms
sum them in the order of their chunked matmuls, the port in n order, so
they differ by rounding alone (measured at most 2^-23 of that sum). The
gather's forward is a copy and is held exactly.

The kernel runs only on the card (``-m cuda`` there, with ``chip_smoke.py``'s
tolerance); JAX is imported inside the tests that need it.
"""
import numpy as np
import pytest
import torch

from basedet_tpu_torch.ops.scatter_rows import row_segments, scatter_rows_plain
from basedet_tpu_torch.ops.scatter_rows_kernel import gather_rows_batched, scatter_rows
from tests.torch_threads import torch_threads  # noqa: F401

RTOL = 2.0 ** -20


def make_case(seed, B, N, R, D, dtype=torch.float32, spread=2):
    """idx in [-spread, R + spread) (so some fall outside) and values."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(-spread, R + spread, (B, N)).astype(np.int32)
    values = rng.randn(B, N, D).astype(np.float32)
    v = torch.from_numpy(values).to(dtype)
    return idx, v.float().numpy(), torch.from_numpy(idx), v


def reference(idx, values, R):
    """float64 loop: the sum and the sum of magnitudes per output element."""
    B, N, D = values.shape
    out, mag = np.zeros((B, R, D)), np.zeros((B, R, D))
    for b in range(B):
        for n in range(N):
            if 0 <= idx[b, n] < R:
                out[b, idx[b, n]] += values[b, n]
                mag[b, idx[b, n]] += np.abs(values[b, n])
    return out, mag


def assert_close(got, want, mag):
    assert got.dtype == torch.float32
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= RTOL * mag).all(), float((err / np.maximum(mag, 1e-30)).max())


@pytest.mark.parametrize("B,N,R,D,dtype", [(2, 300, 41, 128, torch.float32),
                                           (1, 513, 70, 256, torch.bfloat16),
                                           (2, 1200, 300, 128, torch.float32)],
                         ids=["f32", "bf16-b1", "f32-many-rows"])
def test_plain_matches_pallas_interpret(B, N, R, D, dtype):
    import jax.numpy as jnp

    from basedet_tpu.ops.scatter_onehot import scatter_rows_onehot_pallas

    idx, vals, tidx, tv = make_case(0, B, N, R, D, dtype)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(scatter_rows_onehot_pallas(jnp.asarray(idx), jnp.asarray(vals, jdtype), R,
                                                 interpret=True))
    calls = scatter_rows_plain.calls
    got = scatter_rows(tidx, tv, R)
    assert scatter_rows_plain.calls == calls + 1
    assert got.shape == (B, R, D)
    _, mag = reference(idx, vals, R)
    assert_close(got, want.astype(np.float64), mag)


@pytest.mark.parametrize("D", [12, 40])
def test_plain_matches_onehot_scan(D):
    """Any width, against the JAX package's default path (one image at a
    time, as its vmap does)."""
    import jax.numpy as jnp

    from basedet_tpu.ops.scatter_onehot import scatter_rows_onehot

    idx, vals, tidx, tv = make_case(1, 2, 2100, 50, D)  # two chunks of 2048
    want = np.stack([np.asarray(scatter_rows_onehot(jnp.asarray(i),
                                                    jnp.asarray(v), 50))
                     for i, v in zip(idx, vals)])
    _, mag = reference(idx, vals, 50)
    assert_close(scatter_rows(tidx, tv, 50), want.astype(np.float64), mag)


@pytest.mark.parametrize("case", ["one-row", "empty-rows", "out-of-range", "b1-ragged", "no-rows"])
def test_edges_match_a_float64_loop(case):
    B, N, R, D = 2, 333, 29, 12
    idx, vals, _, _ = make_case(2, B, N, R, D)
    if case == "one-row":
        idx[:] = 7
    elif case == "empty-rows":
        idx = idx % 5 * 3  # rows 0, 3, ..., 12 only
    elif case == "out-of-range":
        idx[:, ::2] = np.where(idx[:, ::2] % 2 == 0, -5, R + 3)
    elif case == "b1-ragged":  # one image, N and D (odd) off every tile
        B, N, D = 1, 77, 13
        idx, vals, _, _ = make_case(2, B, N, R, D)
    else:
        R = 0
    got = scatter_rows(torch.from_numpy(idx), torch.from_numpy(vals), R)
    want, mag = reference(idx, vals, R)
    assert got.shape == (B, R, D)
    assert_close(got, want, mag)
    if case == "empty-rows":
        assert (got.numpy()[:, 13:] == 0).all()


def test_row_segments_sort_stably_by_row():
    idx = torch.tensor([[3, 1, -1, 3, 1], [0, 5, 0, 2, 2]], dtype=torch.int32)
    order, starts = row_segments(idx, 4)
    # rows of image 0: 1 → n 1, 4; 3 → n 0, 3; image 1 (offset 5): 0 → n 5, 7; 2 → n 8, 9
    assert order[:8].tolist() == [1, 4, 0, 3, 5, 7, 8, 9]
    assert starts.tolist() == [0, 0, 2, 2, 4, 6, 6, 8, 8]


def test_bf16_values_sum_as_their_f32_conversion():
    _, _, tidx, tv = make_case(3, 2, 400, 31, 24, torch.bfloat16)
    assert torch.equal(scatter_rows(tidx, tv, 31), scatter_rows(tidx, tv.float(), 31))


@pytest.mark.parametrize("backend,C", [("onehot", 3), ("pallas", 32)])
def test_gather_rows_batched_matches_jax_vjp(monkeypatch, backend, C):
    """Forward exactly, and the table's gradient (the scatter) against
    ``jax.vjp`` of the JAX package's ``gather_rows_batched`` with the given
    backward (``BASEDET_DCN_SCATTER``; the Pallas one in interpret mode)."""
    import jax
    import jax.numpy as jnp

    from basedet_tpu.ops.scatter_onehot import gather_rows_batched as jgather

    monkeypatch.setenv("BASEDET_DCN_SCATTER", backend)
    rng = np.random.RandomState(4)
    B, R, N, D = 2, 30, 500, 4 * C
    table = rng.randn(B, R, D).astype(np.float32)
    idx = rng.randint(0, R, (B, N)).astype(np.int32)
    cot = rng.randn(B, N, D).astype(np.float32)
    out, vjp = jax.vjp(lambda t: jgather(t, jnp.asarray(idx)), jnp.asarray(table))
    (dtable,) = vjp(jnp.asarray(cot))

    t = torch.from_numpy(table).requires_grad_()
    got = gather_rows_batched(t, torch.from_numpy(idx))
    assert torch.equal(got.detach(), torch.from_numpy(np.array(out)))
    calls = scatter_rows_plain.calls
    got.backward(torch.from_numpy(cot))
    assert scatter_rows_plain.calls == calls + 1
    _, mag = reference(idx, cot, R)
    assert_close(t.grad, np.asarray(dtable).astype(np.float64), mag)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    idx, v = torch.zeros(2, 5, dtype=torch.int32), torch.zeros(2, 5, 4)
    with pytest.raises(ValueError):
        scatter_rows(idx, v.double(), 3)
    with pytest.raises(ValueError):
        scatter_rows(idx.float(), v, 3)
    with pytest.raises(ValueError):
        scatter_rows(idx[:, :4], v, 3)
    with pytest.raises(ValueError):
        scatter_rows(idx.to("meta"), v.to("meta"), 3)
    with pytest.raises(ValueError):
        gather_rows_batched(torch.zeros(2, 3, 4, device="meta"), idx.to("meta"))


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu():
    """Kernel #9 against its plain version on the card, with
    ``chip_smoke.py``'s cases and tolerance (``check_scatter_case``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the scatter kernel has no CPU mode")
    from chip_smoke import check_scatter_case, scatter_edges

    for name, (idx, values, R) in scatter_edges(np.random.RandomState(5)).items():
        launches = scatter_rows.launches
        ratio, _ = check_scatter_case(idx.cuda(), values.cuda(), R)
        assert scatter_rows.launches == launches + 2, name  # the case and its repeat
        assert ratio <= 1.0, (name, ratio)
