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

The kernels' segmentation (``segment_rows`` on the card) has a plain
version, ``segment_rows_plain``, held here to ``row_segments`` exactly, and
its steps, mirrored on the CPU by ``segment_rows_model`` below, are held to
it under random orders of the atomic placement. A bf16 output is the f32 sum rounded once:
held bit-equal to the f32 result cast, and, against the JAX package's bf16
VJP (whose one-hot matmuls sum in another order before the same rounding),
within one bf16 ulp of the sum of the |values| that land on the element.

The kernels run only on the card (``-m cuda`` there, with ``chip_smoke.py``'s
tolerance); JAX is imported inside the tests that need it.
"""
import numpy as np
import pytest
import torch

from basedet_tpu_torch.ops.scatter_rows import row_segments, scatter_rows_plain, segment_rows_plain
from basedet_tpu_torch.ops.scatter_rows_kernel import gather_rows_batched, scatter_rows, segment_rows
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


def bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits): 2^(floor(log2 |x|) - 7), and the
    smallest normal's spacing at 0."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def segment_case(case, seed=6):
    """(idx (B, N) int32, R) for the segmentation's cases."""
    rng = np.random.RandomState(seed)
    B, N, R = 3, 700, 41
    idx = rng.randint(-3, R + 3, (B, N)).astype(np.int32)
    if case == "ties":  # few rows, so every row holds many entries of one image
        idx = rng.randint(0, 4, (B, N)).astype(np.int32)
    elif case == "empty-rows":
        idx = idx % 5 * 7  # rows 0, 7, ..., 28 only
    elif case == "out-of-range":
        idx[:, ::3] = np.where(idx[:, ::3] % 2 == 0, -9, R + 11)
        idx[1] = -1  # one image with nothing in range
    elif case == "one-row":  # past 1024 entries a row the kernel walks the image
        idx = np.full((2, 1300), 5, np.int32)
        idx[1, ::4] = 40
    elif case == "int64":
        idx = idx.astype(np.int64)
    return torch.from_numpy(idx), R


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


@pytest.mark.parametrize("case", ["spread", "ties", "empty-rows", "out-of-range", "one-row", "int64"])
def test_segment_rows_plain_matches_row_segments(case):
    """``row_segments``' order (its first ``starts[-1]`` entries) and starts, as int32; the wrapper
    takes it on a CPU tensor."""
    idx, R = segment_case(case)
    order, starts = row_segments(idx, R)
    calls = segment_rows_plain.calls
    ids, got = segment_rows(idx, R)
    assert segment_rows_plain.calls == calls + 1
    assert ids.dtype == got.dtype == torch.int32
    assert torch.equal(got.long(), starts)
    assert torch.equal(ids.long(), order[:int(starts[-1])])


def segment_rows_model(idx, n_rows, arrival):
    """The steps of ``csrc/scatter_rows.cu``'s segmentation on the CPU: counts
    (``count_rows_kernel``), starts from each image's b*N less the
    out-of-range entries before it (``scan_rows_kernel``), slots taken in the
    order ``arrival`` (a permutation of the B*N entries) gives the atomics
    (``place_rows_kernel``), then each row put in order as
    ``order_rows_kernel`` does: by counting each id's rank up to 1024 ids, by
    walking the image's indices past that. Returns what ``segment_rows``
    returns on the CPU."""
    B, N = idx.shape
    flat = idx.reshape(-1).to(torch.int64)
    image = torch.arange(B * N) // max(N, 1)
    inside = (flat >= 0) & (flat < n_rows)
    counts = torch.bincount((image * n_rows + flat)[inside], minlength=B * n_rows).view(B, n_rows)
    outside = torch.bincount(image[~inside], minlength=B)
    first = torch.arange(B) * N - (torch.cumsum(outside, 0) - outside)
    starts = torch.cat([(first[:, None] + torch.cumsum(counts, 1) - counts).flatten(),
                        (B * N - outside.sum()).view(1)])
    slots = torch.empty(B * N, dtype=torch.int64)
    cursor = torch.zeros(B * n_rows, dtype=torch.int64)
    for i in arrival.tolist():
        if inside[i]:
            key = int(image[i]) * n_rows + int(flat[i])
            slots[starts[key] + cursor[key]] = i
            cursor[key] += 1
    ids = slots.clone()
    for row in range(B * n_rows):
        s, e = int(starts[row]), int(starts[row + 1])
        mine = slots[s:e]
        if e - s <= 1024:
            ids[s + (mine[None, :] < mine[:, None]).sum(1)] = mine
        else:
            b, r = divmod(row, n_rows)
            ids[s:e] = b * N + torch.nonzero(flat[b * N:(b + 1) * N] == r).flatten()
    M = int(starts[-1])
    return ids[:M].to(torch.int32), starts.to(torch.int32)


@pytest.mark.parametrize("case", ["spread", "ties", "empty-rows", "out-of-range", "one-row", "int64"])
def test_segment_rows_model_matches_plain(case):
    """The kernels' steps (counts, per-image scan, slots in an arbitrary order, each row ordered by
    counting ranks or walking the image) give the plain segmentation whatever order the placement's
    atomics land in. The cases reach both ways of ordering a row: ``spread`` rows of up to 32 entries
    (one chunk of ranks), ``ties`` rows of 33-1024 (several), ``one-row`` rows past 1024 (the walk)."""
    idx, R = segment_case(case)
    want = segment_rows_plain(idx, R)
    lengths = want[1][1:] - want[1][:-1]
    assert int(lengths.max()) <= 32 if case == "spread" else True
    assert 32 < int(lengths.max()) <= 1024 if case == "ties" else True
    assert int(lengths.max()) > 1024 if case == "one-row" else True
    rng = np.random.RandomState(7)
    for _ in range(2):
        got = segment_rows_model(idx, R, torch.from_numpy(rng.permutation(idx.numel())))
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_segment_rows_of_nothing():
    ids, starts = segment_rows(torch.zeros(2, 0, dtype=torch.int32), 5)
    assert ids.numel() == 0 and starts.tolist() == [0] * 11
    ids, starts = segment_rows(torch.zeros(2, 4, dtype=torch.int32), 0)
    assert ids.numel() == 0 and starts.tolist() == [0]


@pytest.mark.parametrize("B,N,R,D", [(2, 400, 31, 24), (1, 900, 7, 13), (2, 300, 0, 8)])
def test_bf16_output_is_the_f32_sum_rounded_once(B, N, R, D):
    """``out_dtype=torch.bfloat16`` (the table's dtype under ``--amp``): the plain version and the
    wrapper give the f32 result cast to bf16, bit for bit."""
    _, _, tidx, tv = make_case(8, B, N, R, D, torch.bfloat16)
    want = scatter_rows_plain(tidx, tv, R).to(torch.bfloat16)
    for got in (scatter_rows_plain(tidx, tv, R, out_dtype=torch.bfloat16),
                scatter_rows(tidx, tv, R, out_dtype=torch.bfloat16)):
        assert got.dtype == torch.bfloat16 and got.shape == (B, R, D)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_bf16_values_sum_as_their_f32_conversion():
    _, _, tidx, tv = make_case(3, 2, 400, 31, 24, torch.bfloat16)
    assert torch.equal(scatter_rows(tidx, tv, 31), scatter_rows(tidx, tv.float(), 31))


@pytest.mark.parametrize("backend,C,dtype", [("onehot", 3, "float32"), ("pallas", 32, "float32"),
                                             ("pallas", 32, "bfloat16")])
def test_gather_rows_batched_matches_jax_vjp(monkeypatch, backend, C, dtype):
    """Forward exactly, and the table's gradient (the scatter) against
    ``jax.vjp`` of the JAX package's ``gather_rows_batched`` with the given
    backward (``BASEDET_DCN_SCATTER``; the Pallas one in interpret mode). A
    bf16 table (as under ``--amp``) gets a bf16 gradient on both sides, each
    an f32 sum rounded once, held within one bf16 ulp of the sum of the
    |cotangents| that land on the element."""
    import jax
    import jax.numpy as jnp

    from basedet_tpu.ops.scatter_onehot import gather_rows_batched as jgather

    monkeypatch.setenv("BASEDET_DCN_SCATTER", backend)
    rng = np.random.RandomState(4)
    B, R, N, D = 2, 30, 500, 4 * C
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    table = torch.from_numpy(rng.randn(B, R, D).astype(np.float32)).to(tdtype)
    idx = rng.randint(0, R, (B, N)).astype(np.int32)
    cot = torch.from_numpy(rng.randn(B, N, D).astype(np.float32)).to(tdtype)
    out, vjp = jax.vjp(lambda t: jgather(t, jnp.asarray(idx)), jnp.asarray(table.float().numpy(), jdtype))
    (dtable,) = vjp(jnp.asarray(cot.float().numpy(), jdtype))
    assert dtable.dtype == jdtype

    t = table.clone().requires_grad_()
    got = gather_rows_batched(t, torch.from_numpy(idx))
    assert torch.equal(got.detach().float(), torch.from_numpy(np.asarray(out, np.float32)))
    calls = scatter_rows_plain.calls
    got.backward(cot)
    assert scatter_rows_plain.calls == calls + 1
    assert t.grad.dtype == tdtype
    _, mag = reference(idx, cot.float().numpy(), R)
    want = np.asarray(dtable, np.float32).astype(np.float64)
    if dtype == "float32":
        assert_close(t.grad, want, mag)
    else:
        err = np.abs(t.grad.float().numpy().astype(np.float64) - want)
        assert (err <= bf16_ulp(mag)).all(), float((err / bf16_ulp(mag)).max())


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
    with pytest.raises(ValueError):  # bf16 output only from bf16 values
        scatter_rows(idx, v, 3, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        scatter_rows(idx, v.bfloat16(), 3, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        segment_rows(idx.float(), 3)
    with pytest.raises(ValueError):
        segment_rows(idx[0], 3)
    with pytest.raises(ValueError):
        segment_rows(idx.to("meta"), 3)


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu():
    """Kernel #9 against its plain version on the card, with
    ``chip_smoke.py``'s cases and tolerance (``check_scatter_case``): the
    segmentation equal to ``row_segments``, and on bf16 values the bf16
    output bit-equal to the plain f32 sum cast."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the scatter kernel has no CPU mode")
    from chip_smoke import check_scatter_case, scatter_edges

    edges = scatter_edges(np.random.RandomState(5))
    assert any(v.dtype == torch.bfloat16 for _, v, _ in edges.values())
    for name, (idx, values, R) in edges.items():
        launches, segments = scatter_rows.launches, segment_rows.launches
        ratio, _ = check_scatter_case(idx.cuda(), values.cuda(), R)
        calls = 2 + 2 * (values.dtype == torch.bfloat16)  # the case and its repeat, in f32 and bf16 out
        assert scatter_rows.launches == launches + calls, name
        assert segment_rows.launches == segments + calls + 1, name  # and the segmentation alone
        assert ratio <= 1.0, (name, ratio)
