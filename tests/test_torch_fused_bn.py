"""The port's fused 1x1-GEMM + BN-statistics chain (basedet_tpu_torch) against
the JAX package on the CPU: the plain forward and backward against
``fused_gemm_stats(..., interpret=True)`` and ``jax.vjp`` of it (the Pallas
kernels in interpret mode), ``csp_layer_fused`` against the JAX package's, and
the port's ``CSPLayer`` fused branch against its own unfused bf16 branch.

Inputs come from numpy with fixed seeds. Tolerances:
  * y, dx (bf16): within one bf16 ulp, on at most 1% of the elements. Both
    sides sum exact bf16 products in f32, in another order, and silu's f32
    rounding differs between XLA and PyTorch; either moves a value across a
    bf16 rounding boundary now and then (measured: 1 element of 8192).
  * s, ss: 1e-5 of the column's sum of |y| or y² (a one-ulp y moves them by
    that much; measured 3.4e-6).
  * dw, dscale, dshift: 1e-5 of their largest magnitude (f32 sums in another
    order; measured 2.5e-7; dw is bf16 on both sides, and was equal).
  * Through a whole CSP layer the bf16 roundings of the raw tensors feed the
    next BN's statistics, so the layer is held to 2 bf16 ulps of its output
    scale and its gradients to 1e-2 of each tensor's largest magnitude.

The kernels themselves run only on the card (``-m cuda`` there); JAX is
imported inside the fixtures, so that test also runs on the card's machine.
"""
import numpy as np
import pytest
import torch

from basedet_tpu_torch.layers import precision
from basedet_tpu_torch.layers.blocks.csp_fused import csp_layer_fused
from basedet_tpu_torch.layers.blocks.yolo_block import CSPLayer
from basedet_tpu_torch.ops.fused_bn import (
    flatten_terms,
    fused_gemm_stats_backward_plain,
    fused_gemm_stats_plain,
    moments_to_affine,
    stats_to_moments,
    unflatten_terms,
)
from basedet_tpu_torch.ops import fused_bn_kernel
from basedet_tpu_torch.ops.fused_bn_kernel import MAX_RAW, fused_gemm_stats, fused_gemm_stats_backward
from tests.torch_threads import torch_threads  # noqa: F401

M, K, N = 256, 32, 64
SPECS = [("act",), (1,), (2,), ("act", 1), (1, 1)]
# one raw term with as many inputs as conv3's left term of a CSP layer with n
# bottlenecks has (n + 1): YOLOX-M's n = 6 and YOLOX-X's n = 12
WIDE_CASES = [((7,), M), ((13,), M)]
WIDE_IDS = ["raw7-yolox-m", "raw13-yolox-x"]


def make_terms(rng, spec, m=M):
    """numpy terms as ``tests/ops/test_fused_bn.py`` draws them."""
    terms = []
    for s in spec:
        if s == "act":
            terms.append(("act", rng.randn(m, K), rng.randn(K, N) * 0.3))
        else:
            raws = [(rng.randn(m, K), rng.rand(K) + 0.5, rng.randn(K) * 0.1) for _ in range(s)]
            terms.append(("raw", raws, rng.randn(K, N) * 0.3))
    return terms


def _convert(terms, bf16, f32):
    out = []
    for t in terms:
        if t[0] == "act":
            out.append(("act", bf16(t[1]), bf16(t[2])))
        else:
            out.append(("raw", [(bf16(x), f32(s), f32(b)) for x, s, b in t[1]], bf16(t[2])))
    return out


def torch_terms(terms):
    return _convert(terms, lambda a: torch.tensor(a, dtype=torch.float32).bfloat16(),
                    lambda a: torch.tensor(a, dtype=torch.float32))


def jax_terms(terms):
    import jax.numpy as jnp

    return _convert(terms, lambda a: jnp.asarray(a, jnp.bfloat16), lambda a: jnp.asarray(a, jnp.float32))


def f32(a):
    return np.array(a.float() if isinstance(a, torch.Tensor) else a.astype("float32"), np.float32)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 ulps between two bf16 tensors (+0 and -0 equal)."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def assert_bf16_close(got: torch.Tensor, want: torch.Tensor, ulps=1, share=0.01):
    d = bf16_ulps(got.contiguous(), want.contiguous())
    assert int(d.max()) <= ulps, int(d.max())
    assert float((d > 0).float().mean()) <= share


@pytest.mark.parametrize("spec,m", [*[(s, M) for s in SPECS], (("act", 1), 125), *WIDE_CASES],
                         ids=[*["-".join(map(str, s)) for s in SPECS], "odd-M", *WIDE_IDS])
def test_plain_forward_matches_pallas(spec, m):
    from basedet_tpu.ops.fused_bn import fused_gemm_stats as jax_fused

    terms = make_terms(np.random.RandomState(0), spec, m)
    yj, sj, ssj = jax_fused(jax_terms(terms), interpret=True)
    calls = fused_gemm_stats_plain.calls
    y, s, ss = fused_gemm_stats(torch_terms(terms))
    assert fused_gemm_stats_plain.calls == calls + 1
    assert y.dtype == torch.bfloat16 and y.shape == (m, N) and s.dtype == ss.dtype == torch.float32
    assert_bf16_close(y, torch.from_numpy(f32(yj)).bfloat16())
    yf = y.float()
    np.testing.assert_array_less(np.abs(s.numpy() - f32(sj)), 1e-5 * yf.abs().sum(0).numpy() + 1e-30)
    np.testing.assert_array_less(np.abs(ss.numpy() - f32(ssj)), 1e-5 * (yf * yf).sum(0).numpy() + 1e-30)


@pytest.mark.parametrize("spec,m,dx_ulps", [*[(s, M, 1) for s in SPECS], (("act", 1), 125, 1),
                                            *[(s, m, 2) for s, m in WIDE_CASES]],
                         ids=[*["-".join(map(str, s)) for s in SPECS], "odd-M", *WIDE_IDS])
def test_plain_backward_matches_pallas_vjp(spec, m, dx_ulps):
    """``fused_gemm_stats_backward_plain`` against ``jax.vjp`` of the Pallas
    forward (its custom VJP, the Pallas backward in interpret mode), on one y
    and one set of cotangents, ds and dss included. A wide raw term has 7 or
    13 dx tensors, so 7 or 13 times the elements where the f32 sum of dact's
    64 products cancels to near zero: there the two sums' orders differ by 2
    ulps now and then (measured: one element of 16,384 at 7 inputs, |dx|
    1.2e-5 against a largest 10.3), still on at most 1% of the elements."""
    import jax
    import jax.numpy as jnp
    from basedet_tpu.ops.fused_bn import _flatten_terms, _fused_gemm_flat

    rng = np.random.RandomState(1)
    terms = make_terms(rng, spec, m)
    jspec, jflat = _flatten_terms(jax_terms(terms))
    (yj, _, _), vjp = jax.vjp(lambda *flat: _fused_gemm_flat(jspec, flat, True, 2048), *jflat)
    dy, ds, dss = rng.randn(m, N), rng.randn(N) * 0.01, rng.randn(N) * 0.001
    want = vjp((jnp.asarray(dy, jnp.bfloat16), jnp.asarray(ds, jnp.float32),
                jnp.asarray(dss, jnp.float32)))
    y = torch.from_numpy(f32(yj)).bfloat16()
    got = fused_gemm_stats_backward(torch_terms(terms), y, torch.tensor(dy).bfloat16(),
                                    torch.tensor(ds, dtype=torch.float32),
                                    torch.tensor(dss, dtype=torch.float32))
    _, flat = flatten_terms(torch_terms(terms))
    assert len(got) == len(want) == len(flat)
    for g, w, x in zip(got, want, flat):
        assert g.shape == x.shape and g.dtype == x.dtype
        if g.dim() == 2 and g.shape[0] == m:  # dx
            assert_bf16_close(g, torch.from_numpy(f32(w)).bfloat16(), ulps=dx_ulps)
        else:  # dw (bf16, as the JAX VJP casts it), dscale, dshift
            scale = np.abs(f32(w)).max()
            assert np.abs(f32(g) - f32(w)).max() <= 1e-5 * scale


def test_function_gradients_follow_the_backward():
    """The autograd Function hands its cotangents to the plain backward, with
    zeros where ds or dss arrive as None, and a gradient for every input."""
    rng = np.random.RandomState(2)
    terms = torch_terms(make_terms(rng, ("act", 2)))
    spec, flat = flatten_terms(terms)
    leaves = [a.clone().requires_grad_() for a in flat]
    y, s, ss = fused_gemm_stats(unflatten_terms(spec, leaves))
    dy = torch.tensor(rng.randn(M, N)).bfloat16()
    calls = fused_gemm_stats_backward_plain.calls
    grads = torch.autograd.grad(y, leaves, dy, retain_graph=True)  # ds = dss = 0
    assert fused_gemm_stats_backward_plain.calls == calls + 1
    zero = torch.zeros(N)
    want = fused_gemm_stats_backward_plain(terms, y.detach(), dy, zero, zero)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    # through s and ss: the stats' cotangents reach dy_eff as ds + 2·y·dss
    (s.sum() * 0.01 + (ss * 0.001).sum()).backward()
    want = fused_gemm_stats_backward_plain(terms, y.detach(), torch.zeros_like(dy),
                                           torch.full((N,), 0.01), torch.full((N,), 0.001))
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    rng = np.random.RandomState(3)
    x, w = torch.tensor(rng.randn(M, K)), torch.tensor(rng.randn(K, N))
    with pytest.raises(ValueError):
        fused_gemm_stats([("act", x.bfloat16(), w.float())])  # f32 weight
    with pytest.raises(ValueError):
        fused_gemm_stats([("act", x.bfloat16()[:, :16], w.bfloat16())])  # K mismatch
    with pytest.raises(ValueError):
        fused_gemm_stats([("raw", [(x.bfloat16(), torch.ones(K).double(), torch.zeros(K))],
                           w.bfloat16())])
    with pytest.raises(ValueError):
        fused_gemm_stats([("raw", [(x.bfloat16(), torch.ones(K), torch.zeros(K))] * (MAX_RAW + 1),
                           w.bfloat16())])
    with pytest.raises(ValueError):
        fused_gemm_stats([("act", x.bfloat16(), w.bfloat16().to("meta"))])


def test_stats_glue_matches_jax():
    from basedet_tpu.ops.fused_bn import moments_to_affine as jaffine
    from basedet_tpu.ops.fused_bn import stats_to_moments as jmoments

    rng = np.random.RandomState(4)
    s, ss = rng.randn(N) * 10, rng.rand(N) * 100 + 50
    g, b = rng.rand(N) + 0.5, rng.randn(N)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    mean, var = stats_to_moments(t(s), t(ss), M)
    jmean, jvar = jmoments(np.float32(s), np.float32(ss), M)
    np.testing.assert_allclose(mean.numpy(), jmean, rtol=1e-6)
    np.testing.assert_allclose(var.numpy(), jvar, rtol=1e-6)
    sc, sh = moments_to_affine(mean, var, t(g), t(b), 1e-3)
    jsc, jsh = jaffine(jmean, jvar, np.float32(g), np.float32(b), 1e-3)
    np.testing.assert_allclose(sc.numpy(), jsc, rtol=1e-6)
    np.testing.assert_allclose(sh.numpy(), jsh, rtol=1e-6, atol=1e-6)


def _csp_pair(cin, cout, n, shortcut, seed):
    """A flax CSPLayer's randomised variables and the port's CSPLayer with
    the same weights, in train mode."""
    import jax

    from basedet_tpu.layers.blocks.yolo_block import CSPLayer as JCSPLayer
    from basedet_tpu_torch.utils.weights import state_dict_from_jax
    from tests.test_torch_yolox import _randomise

    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 8, 8, cin) * 0.5).astype(np.float32)
    jlayer = JCSPLayer(out_channels=cout, n=n, shortcut=shortcut, train=True)
    variables = _randomise(jlayer.init(jax.random.PRNGKey(seed), x), rng)
    port = CSPLayer(cin, cout, n=n, shortcut=shortcut)
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()))
    return jlayer, variables, port.train(), x


# (cin, cout, n, shortcut, gradient tolerance relative to each tensor's largest entry)
CSP_CASES = [(32, 32, 1, True, 1e-2), (32, 32, 2, True, 1e-2), (32, 32, 1, False, 1e-2),
             (64, 32, 1, False, 1e-2), (32, 32, 6, True, 2e-2)]


@pytest.mark.parametrize("cin,cout,n,shortcut,grad_rtol", CSP_CASES,
                         ids=["n1", "n2", "n1-no-shortcut", "pafpn-reduce", "n6-yolox-m"])
def test_csp_layer_fused_matches_jax(cin, cout, n, shortcut, grad_rtol):
    """Output, batch moments and the gradient of every parameter against the
    JAX package's ``csp_layer_fused`` (interpret mode) on the same weights.
    YOLOX-M's depth (n = 6, so conv3's left term has 7 raw inputs) chains six
    bottlenecks' bf16 roundings into the next statistics: its worst gradient
    lies 1.1e-2 of its largest entry away (m5a/w, two bf16 ulps of that entry;
    n = 1 and 2: 0.63e-2 and 0.87e-2), so it is held to 2e-2."""
    import jax
    import jax.numpy as jnp

    from basedet_tpu.layers.blocks.csp_fused import csp_layer_fused as jax_csp
    from basedet_tpu.layers.blocks.csp_fused import flax_csp_params_to_fused

    _, variables, port, x = _csp_pair(cin, cout, n, shortcut, seed=n + 2 * shortcut + cin)
    jparams = flax_csp_params_to_fused({k: jax.tree_util.tree_map(jnp.asarray, v)
                                        for k, v in variables.items()}, n)
    xj = jnp.asarray(x, jnp.bfloat16)

    def jloss(p):
        out, moments = jax_csp(p, xj, n, shortcut=shortcut, interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2) * 1e-3, (out, moments)

    (_, (jout, jmom)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = port.fused_params()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2)).bfloat16()
    out, moments = csp_layer_fused(params, xt, n, shortcut=shortcut)
    assert out.shape == (2, cout, 8, 8) and out.dtype == torch.bfloat16
    assert out.is_contiguous(memory_format=torch.channels_last)
    got = out.permute(0, 2, 3, 1).float()
    want = torch.from_numpy(f32(jout))
    scale = float(want.abs().max())
    assert float((got.detach() - want).abs().max()) <= 2 * 2**-8 * scale
    assert set(moments) == set(jmom)
    for key, (mean, var) in moments.items():
        np.testing.assert_allclose(mean.detach().numpy(), f32(jmom[key][0]), rtol=1e-2,
                                   atol=1e-2 * float(np.abs(f32(jmom[key][0])).max()))
        np.testing.assert_allclose(var.detach().numpy(), f32(jmom[key][1]), rtol=1e-2)
    (got.square().sum() * 1e-3).backward()
    for key, p in params.items():
        ref = f32(jgrads[key])
        if key.endswith("/w"):
            ref = ref.transpose(3, 2, 0, 1) if ref.ndim == 4 else ref.T[..., None, None]
        ref = ref.reshape(p.shape)
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= grad_rtol * np.abs(ref).max(), (key, err, np.abs(ref).max())


@pytest.mark.parametrize("n,shortcut", [(1, True), (2, False)])
def test_csp_fused_branch_matches_unfused_bf16_branch(n, shortcut):
    """One state_dict, two branches of the port's CSPLayer under the bf16
    policy: outputs, parameter gradients and the new BN running statistics.
    The fused branch takes its variance as E[y²] - E[y]² from the fused sums
    and rounds its raw tensors to bf16, as the JAX package's does; tolerances
    as the JAX package's own test of the two branches states them."""
    _, _, port, x = _csp_pair(32, 32, n, shortcut, seed=7)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    runs = {}
    for fused in (False, True):
        layer = CSPLayer(32, 32, n=n, shortcut=shortcut).train()
        layer.load_state_dict(port.state_dict())
        calls = fused_gemm_stats_plain.calls
        with precision.precision_policy(torch.bfloat16, fused_bn=fused):
            out = layer(xt)
        assert (fused_gemm_stats_plain.calls - calls) == (3 + n if fused else 0)
        (out.float().square().sum() * 1e-3).backward()
        runs[fused] = (out.detach().float(), {k: p.grad for k, p in layer.named_parameters()},
                       {k: v for k, v in layer.state_dict().items() if "running" in k})
    (a, ga, sa), (b, gb, sb) = runs[True], runs[False]
    assert a.dtype == b.dtype
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=0.05, rtol=0.05)
    assert float((a - b).abs().mean()) < 5e-3
    for k in gb:
        scale = max(float(gb[k].abs().max()), 1e-3)
        assert float((ga[k] - gb[k]).abs().max()) <= 0.06 * scale, k
    for k in sb:
        assert not torch.equal(sb[k], port.state_dict()[k]), k  # both branches updated it
        np.testing.assert_allclose(sa[k].numpy(), sb[k].numpy(), atol=1e-3, rtol=1e-3, err_msg=k)


def test_csp_fused_branch_gate():
    """The fused branch runs only in train mode, under bf16 with the switch
    on, for a dense SiLU layer."""
    x = torch.randn(1, 32, 4, 4)
    cases = [(CSPLayer(32, 32), True, torch.bfloat16, True, 4),
             (CSPLayer(32, 32), False, torch.bfloat16, True, 0),
             (CSPLayer(32, 32), True, None, True, 0),
             (CSPLayer(32, 32), True, torch.bfloat16, False, 0),
             (CSPLayer(32, 32, act="relu"), True, torch.bfloat16, True, 0),
             (CSPLayer(32, 32, depthwise=True), True, torch.bfloat16, True, 0)]
    for layer, train, dtype, fused, want in cases:
        layer.train(train)
        calls = fused_gemm_stats_plain.calls
        with precision.precision_policy(dtype, fused_bn=fused), torch.no_grad():
            layer(x)
        assert fused_gemm_stats_plain.calls - calls == want


@pytest.mark.cuda
def test_kernels_match_plain_on_gpu():
    """Kernels #3 and #4 against their plain versions on the card, with the
    tolerances of ``chip_smoke.py``'s kernel phase (``check_fused_case``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the fused GEMM kernels have no CPU mode")
    from chip_smoke import check_fused_case

    rng = np.random.RandomState(5)
    for spec, m in [*[(s, M) for s in SPECS], (("act", 1), 125), ((4, 1), 300), *WIDE_CASES]:
        terms = [(t[0], [tuple(a.cuda() for a in raw) for raw in t[1]] if t[0] == "raw" else t[1].cuda(),
                  t[2].cuda()) for t in torch_terms(make_terms(rng, spec, m))]
        launches = fused_gemm_stats.launches, fused_gemm_stats_backward.launches
        cts = (torch.tensor(rng.randn(m, N), dtype=torch.float32).bfloat16().cuda(),
               torch.tensor(rng.randn(N) * 0.01, dtype=torch.float32).cuda(),
               torch.tensor(rng.randn(N) * 0.001, dtype=torch.float32).cuda())
        ratios, _, _ = check_fused_case(terms, *cts)
        assert (fused_gemm_stats.launches, fused_gemm_stats_backward.launches) == (launches[0] + 1,
                                                                                   launches[1] + 1)
        assert all(v <= 1.0 for v in ratios.values()), (spec, m, ratios)


def _template_for(terms):
    return fused_bn_kernel._forward_problem(fused_bn_kernel._check(terms))


def test_forward_problem_template_is_cached_per_signature():
    """The forward's C description is built once per call signature: a call
    with new tensors of the same signature reuses it with the new pointers;
    another signature builds another."""
    rng = np.random.RandomState(6)
    first = torch_terms(make_terms(rng, ("act", 2)))
    tpl, p = _template_for(first)
    second = torch_terms(make_terms(rng, ("act", 2)))
    tpl2, p2 = _template_for(second)
    assert tpl2 is tpl and p2 is p
    (_, x, w0), (_, raws, w1) = second
    assert (p.M, p.N, p.n_terms) == (M, N, 2)
    assert (p.t[0].kind, p.t[0].n_raw, p.t[0].K, p.t[1].kind, p.t[1].n_raw, p.t[1].K) == (0, 1, K, 1, 2, K)
    assert (p.t[0].x[0], p.t[0].w, p.t[1].w) == (x.data_ptr(), w0.data_ptr(), w1.data_ptr())
    for j, (xj, sc, sh) in enumerate(raws):
        assert (p.t[1].x[j], p.t[1].scale[j], p.t[1].shift[j]) == (xj.data_ptr(), sc.data_ptr(), sh.data_ptr())
    other, _ = _template_for(torch_terms(make_terms(rng, ("act", 2), m=M + 8)))
    assert other is not tpl
    again, _ = _template_for(torch_terms(make_terms(rng, ("act", 1))))
    assert again is not tpl and again is not other


@pytest.mark.parametrize("drop", ["scale", "shift", "both"])
def test_raw_input_without_scale_or_shift_raises(drop):
    """A raw input must carry its scale and shift: one left as None is
    refused before any pointer reaches the cached template."""
    (kind, raws, w), = torch_terms(make_terms(np.random.RandomState(8), (2,)))
    x, scale, shift = raws[1]
    raws[1] = (x, None if drop != "shift" else scale, None if drop != "scale" else shift)
    with pytest.raises(ValueError, match="scale and shift"):
        fused_gemm_stats([(kind, raws, w)])


def test_forward_template_refuses_a_pointer_list_of_another_length():
    """The template fills its slots from a pointer list of exactly its own
    length: a shorter or longer one raises instead of leaving stale slots."""
    tpl, _ = _template_for(torch_terms(make_terms(np.random.RandomState(9), ("act", 2))))
    ptrs = list(range(16, 16 * (len(tpl.slots) + 1), 16))
    tpl.fill(ptrs)
    for bad in (ptrs[:-1], ptrs + [16]):
        with pytest.raises(ValueError, match="pointers"):
            tpl.fill(bad)


@pytest.mark.parametrize("m,n", [(1, 8), (3200, 512), (12800, 256), (51200, 128), (346112, 32), (777, 40)])
def test_forward_plan_covers_every_row_and_column(m, n):
    """The forward's plan on an H100's 132 SMs: its column groups cover N,
    its strip blocks never outnumber the strips, and the grid fills the card
    where there are rows enough."""
    np_, gx, gy = fused_bn_kernel.forward_plan(m, n, 132, (2, 1, 1, 1))
    strips = -(-m // fused_bn_kernel.STRIP)
    assert 1 <= np_ <= fused_bn_kernel.MAX_PANELS
    assert gy * np_ * fused_bn_kernel.PANEL >= n > (gy - 1) * np_ * fused_bn_kernel.PANEL
    assert 1 <= gx <= strips
    assert gx * gy >= min(132, strips * -(-n // fused_bn_kernel.PANEL))


@pytest.mark.cuda
def test_forward_kernel_edge_shapes_and_repeat_bits_on_gpu():
    """Kernel #3 at M = 1, 127 and 129 (one strip, a ragged strip, a strip
    and a row) and at N = K = 8 (one panel, mostly padding) against its plain
    version, and two launches of every case bit-equal in y, s and ss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the fused GEMM kernels have no CPU mode")
    from chip_smoke import check_fused_case

    gen = torch.Generator(device="cuda").manual_seed(7)
    for spec, m, k, n in [(("act",), 1, 32, 64), ((2,), 127, 32, 64), (("act", 1), 129, 64, 128),
                          (("act",), 300, 8, 8), ((3,), 129, 8, 8), ((1, 1), 4097, 256, 512)]:
        terms = []
        for sp in spec:
            w = (torch.randn(k, n, device="cuda", generator=gen) * k ** -0.5).bfloat16()
            if sp == "act":
                terms.append(("act", torch.randn(m, k, device="cuda", generator=gen).bfloat16(), w))
            else:
                terms.append(("raw", [(torch.randn(m, k, device="cuda", generator=gen).bfloat16(),
                                       torch.rand(k, device="cuda", generator=gen) + 0.5,
                                       torch.randn(k, device="cuda", generator=gen) * 0.1)
                                      for _ in range(sp)], w))
        cts = (torch.randn(m, n, device="cuda", generator=gen).bfloat16(),
               torch.randn(n, device="cuda", generator=gen) * 1e-2,
               torch.randn(n, device="cuda", generator=gen) * 1e-3)
        ratios, _, _ = check_fused_case(terms, *cts)
        assert all(v <= 1.0 for v in ratios.values()), (spec, m, k, n, ratios)
        with torch.no_grad():
            first = [a.clone() for a in fused_gemm_stats(terms)]
            second = fused_gemm_stats(terms)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a.view(torch.int32),
                               b.view(torch.int16) if b.dtype == torch.bfloat16 else b.view(torch.int32))


@pytest.mark.cuda
def test_forward_sums_repeat_bits_where_threads_lie_past_the_stripe_on_gpu():
    """Kernel #3's cross-block sums at N between 128 and 256 (YOLOX-M's N =
    192), where the 2N columns give fewer float4 lanes than a block has
    threads and one stripe: every launch of a few hundred gives s and ss
    bit-equal to the first, within tolerance of the plain version (threads
    past the stripe wrote zeros over some sums, now and then)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the fused GEMM kernels have no CPU mode")
    from chip_smoke import _random_fused_terms, check_fused_case

    gen = torch.Generator(device="cuda").manual_seed(17)
    for spec, m, k, n, reps in [((7,), 51200, 96, 192, 400), ((1, 1), 12800, 64, 136, 200),
                                ((1, 1), 12800, 64, 248, 200)]:
        terms = _random_fused_terms(gen, spec, m, k, n)
        ratios, _, _ = check_fused_case(terms, torch.randn(m, n, device="cuda", generator=gen).bfloat16(),
                                        torch.zeros(n, device="cuda"), torch.zeros(n, device="cuda"))
        assert ratios["s"] <= 1.0 and ratios["ss"] <= 1.0, (spec, m, k, n, ratios)
        with torch.no_grad():
            _, s0, ss0 = fused_gemm_stats(terms)
            differ = 0
            for _ in range(reps):
                _, s, ss = fused_gemm_stats(terms)
                differ += not (torch.equal(s.view(torch.int32), s0.view(torch.int32)) and
                               torch.equal(ss.view(torch.int32), ss0.view(torch.int32)))
        assert differ == 0, (spec, m, k, n, differ)


def _round_f32(x) -> float:
    """An exact rational rounded to the nearest float32, ties to even (normal range)."""
    from fractions import Fraction

    x = Fraction(x)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    e += 1 if Fraction(2) ** (e + 1) <= x else (-1 if Fraction(2) ** e > x else 0)
    q, r = divmod(x * Fraction(2) ** (23 - e), 1)
    q = int(q) + (1 if r > Fraction(1, 2) or (r == Fraction(1, 2) and int(q) % 2) else 0)
    return sign * float(Fraction(q) * Fraction(2) ** (e - 23))


def test_prologue_reciprocal_rounds_like_division():
    """``recip_ge1`` in ``csrc/fused_bn.cu`` (the prologue's 1 / (1 + exp(-p))): from an
    approximate reciprocal up to two ulps off, two residual steps by FMA give the correctly
    rounded 1 / d, the bits of IEEE division, for d in [1, 2^126). Exact rational FMAs here."""
    from fractions import Fraction

    fma = lambda a, b, c: _round_f32(Fraction(a) * Fraction(b) + Fraction(c))
    rng = np.random.RandomState(12)
    ds = np.concatenate([1 + 3 * rng.rand(300), 2.0 ** rng.uniform(0, 125, 300),
                         1 + 2.0 ** -rng.randint(1, 24, 100) * rng.randint(0, 9, 100)]).astype(np.float32)
    for d in map(float, ds):
        exact = _round_f32(Fraction(1) / Fraction(d))
        for ulps in (-2, -1, 0, 1, 2):
            r0 = np.float32(exact)
            for _ in range(abs(ulps)):
                r0 = np.nextafter(r0, np.float32(np.inf if ulps > 0 else -np.inf))
            r = fma(float(r0), fma(-d, float(r0), 1.0), float(r0))
            assert fma(r, fma(-d, r, 1.0), r) == exact, (d, ulps)


def test_backward_problem_template_is_cached_per_signature():
    """The backward's C description is built once per call signature, apart
    from the forward's: a call with new tensors of the same signature reuses
    it with the new pointers, dx pointers after the inputs' in flat order;
    another signature builds another."""
    rng = np.random.RandomState(13)
    terms = torch_terms(make_terms(rng, ("act", 2)))
    spec, flat = flatten_terms(terms)
    tpl = fused_bn_kernel._template(spec, M, N, (K, K), True)
    assert fused_bn_kernel._template(spec, M, N, (K, K), True) is tpl
    assert fused_bn_kernel._template(spec, M, N, (K, K), False) is not tpl
    assert fused_bn_kernel._template(spec, M + 8, N, (K, K), True) is not tpl
    dx = [16 * (1000 + i) for i in range(3)]  # the act term's dx, then the raw term's two
    p = tpl.fill([a.data_ptr() for a in flat] + dx)
    assert (p.M, p.N, p.n_terms) == (M, N, 2)
    (_, x, w0), (_, raws, w1) = terms
    assert (p.t[0].x[0], p.t[0].w, p.t[1].w, p.t[0].dx[0]) == (x.data_ptr(), w0.data_ptr(), w1.data_ptr(), dx[0])
    for j, (xj, sc, sh) in enumerate(raws):
        assert (p.t[1].x[j], p.t[1].scale[j], p.t[1].shift[j], p.t[1].dx[j]) == (
            xj.data_ptr(), sc.data_ptr(), sh.data_ptr(), dx[1 + j])


def test_backward_template_refuses_a_pointer_list_of_another_length():
    """The backward template takes every input's pointer and every dx
    pointer: a list missing the dx pointers, or with one too many, raises."""
    spec, flat = flatten_terms(torch_terms(make_terms(np.random.RandomState(14), ("act", 2))))
    tpl = fused_bn_kernel._template(spec, M, N, (K, K), True)
    ptrs = list(range(16, 16 * (len(flat) + 4), 16))
    tpl.fill(ptrs)
    for bad in (ptrs[:len(flat)], ptrs + [16]):
        with pytest.raises(ValueError, match="pointers"):
            tpl.fill(bad)


# the distinct fused calls of a YOLOX-S train step at batch 8 of 640x640 (spec, M, K per term, N),
# and the edges of chip_smoke.py's kernel phase
YOLOX_S_BWD = [(("act",), 204800, (64,), 32), ((1,), 204800, (32,), 32), ((2, 1), 204800, (32, 32), 64),
               (("act",), 51200, (128,), 64), ((3,), 51200, (64,), 64), ((4, 1), 51200, (64, 64), 128),
               (("act",), 51200, (256,), 64), ((1, 1), 51200, (64, 64), 128),
               (("act",), 12800, (256,), 128), ((2,), 12800, (128,), 128), ((4, 1), 12800, (128, 128), 256),
               (("act",), 12800, (512,), 128), ((1, 1), 12800, (128, 128), 256),
               (("act",), 3200, (512,), 256), ((1,), 3200, (256,), 256), ((1, 1), 3200, (256, 256), 512)]
EDGE_BWD = [(("act",), 1, (32,), 64), ((2,), 127, (32,), 64), (("act", 1), 129, (64, 64), 128),
            (("act",), 300, (8,), 8), ((3,), 129, (8,), 8), ((2,), 777, (24,), 40),
            ((7,), 51200, (96,), 192), ((13,), 12800, (320,), 640), ((4, 1), 3000, (256, 256), 512),
            # conv3 of the dark5 CSP layer of YOLOX-M, -L and -X at batch 8 of 640x640 (N = 1024 x
            # width), where w's rows stream; and a raw term of 16 inputs at N = 640, the most a term
            # takes, where they stream too
            ((1, 1), 3200, (384, 384), 768), ((1, 1), 3200, (512, 512), 1024),
            ((1, 1), 3200, (640, 640), 1280), ((16,), 12800, (320,), 640)]


@pytest.mark.parametrize("spec,m,ks,n", YOLOX_S_BWD + EDGE_BWD,
                         ids=[f"{'+'.join(map(str, s))}-M{m}-K{'+'.join(map(str, k))}-N{n}"
                              for s, m, k, n in YOLOX_S_BWD + EDGE_BWD])
def test_backward_plan_covers_every_output_once(spec, m, ks, n):
    """The backward's plan on an H100's 132 SMs (two blocks an SM where the
    shared memory lets them): its column groups write every dW entry once,
    and the groups that own a k-panel (n0 = 0) every dx column and every
    dscale/dshift column once; the owners come first; the groups' partial
    rows tile their region; the strip blocks take every strip once and fill
    the card; the allocation holds every output apart; the shared memory
    fits a block; w's rows stream exactly where keeping them resident
    would not fit."""
    spec = tuple(("act",) if s == "act" else ("raw", s) for s in spec)
    blocks_for = lambda npn, window, smem: 2 if 2 * (smem + 1024) <= 233472 else 1
    npn, window, stages, gx, gy, smem = fused_bn_kernel.backward_plan(m, n, spec, ks, 132, blocks_for)
    assert npn in (1, 2) and 2 <= stages <= 6 and smem <= fused_bn_kernel.MAX_SMEM
    assert window == (fused_bn_kernel.backward_smem(n, spec, 2) > fused_bn_kernel.MAX_SMEM)
    assert window == (n > 640 or spec == (("raw", 16),)) and (not window or npn == 2)
    assert 1 <= gx <= min(512, -(-m // 64)) and gx * gy >= min(132, -(-m // 64) * gy)
    cols = fused_bn_kernel.backward_columns(spec, ks, n, npn, gx)
    assert len(cols) == gy
    dw = [np.zeros((k, n), int) for k in ks]
    dx = [np.zeros(k, int) for k in ks]
    rows = []
    for c in cols:
        k0, n0, t = c["k0"], c["n0"], c["t"]
        assert c["width"] % 8 == 0 and c["len"] == c["ds_len"] + 64 * c["width"]
        dw[t][k0:k0 + 64, n0:n0 + c["width"]] += 1
        if n0 == 0:
            dx[t][k0:k0 + 64] += 1
            assert c["ds_len"] == (128 * spec[t][1] if spec[t][0] == "raw" else 0)
        else:
            assert c["ds_len"] == 0
        rows.append((c["base"], c["base"] + gx * c["len"]))
    assert all((d == 1).all() for d in dw) and all((d == 1).all() for d in dx)
    assert cols[0]["n0"] == 0 and all(a["n0"] == 0 or b["n0"] != 0 for a, b in zip(cols, cols[1:]))  # owners first
    rows.sort()
    assert rows[0][0] == 0 and all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert sorted(s for bx in range(gx) for s in range(bx, -(-m // 64), gx)) == list(range(-(-m // 64)))
    lay = fused_bn_kernel.backward_layout(spec, m, n, ks, npn, gx)
    spans = [(2 * o if f32 else o, (2 * o if f32 else o) + (2 if f32 else 1) * int(np.prod(shape)))
             for f32, o, shape, _ in lay.outputs]
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])) and spans[-1][1] <= lay.part
    assert lay.total == lay.part + 2 * rows[-1][1] and lay.total % 2 == 0
    assert lay.part % 8 == 0  # the partial rows start on 16 bytes
    assert lay.max_len == max(c["len"] for c in cols)


@pytest.mark.cuda
def test_backward_kernel_edge_shapes_and_repeat_bits_on_gpu():
    """Kernel #4 at M = 1, 127 and 129, at K = N = 8, with 7, 13 and 16 raw
    inputs, with ds = dss = 0 and at YOLOX-M, -L and -X's widest conv3 (N =
    768, 1024, 1280, where w's rows stream) against its plain version (the
    tolerances of ``chip_smoke.py``'s kernel phase), one launch a call, and
    two launches of every case bit-equal in every cotangent."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the fused GEMM kernels have no CPU mode")
    from chip_smoke import _random_fused_terms, check_fused_case

    gen = torch.Generator(device="cuda").manual_seed(15)
    for spec, m, k, n, zero in [(("act",), 1, 32, 64, False), ((2,), 127, 32, 64, False),
                                (("act", 1), 129, 64, 128, False), (("act",), 300, 8, 8, False),
                                ((3,), 129, 8, 8, False), ((7,), 4096, 96, 192, False),
                                ((13,), 1600, 320, 640, False), ((1, 1), 5000, 96, 64, True),
                                ((16,), 1600, 320, 640, False), ((1, 1), 3200, 384, 768, False),
                                ((1, 1), 3200, 512, 1024, False), ((1, 1), 3200, 640, 1280, False)]:
        terms = _random_fused_terms(gen, spec, m, k, n)
        dy = torch.randn(m, n, device="cuda", generator=gen).bfloat16()
        ds, dss = ((torch.zeros(n, device="cuda"),) * 2 if zero else
                   (torch.randn(n, device="cuda", generator=gen) * 1e-2,
                    torch.randn(n, device="cuda", generator=gen) * 1e-3))
        launches = fused_gemm_stats_backward.launches
        ratios, _, _ = check_fused_case(terms, dy, ds, dss)
        assert fused_gemm_stats_backward.launches == launches + 1
        assert all(v <= 1.0 for v in ratios.values()), (spec, m, k, n, ratios)
        y = fused_gemm_stats(terms)[0].detach()
        first = [a.clone() for a in fused_gemm_stats_backward(terms, y, dy, ds, dss)]
        second = fused_gemm_stats_backward(terms, y, dy, ds, dss)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a.view(torch.int32),
                               b.view(torch.int16) if b.dtype == torch.bfloat16 else b.view(torch.int32))


@pytest.mark.cuda
def test_prologue_past_the_exp_range_is_finite_on_gpu():
    """A raw input whose pre-activation lies under -88.7, where exp(-pre) is
    +inf in f32: silu and its derivative are 0 there, as in the plain
    version, in both kernels (the prologue's reciprocal of +inf is 0, not
    NaN)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the fused GEMM kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(16)
    m, k, n = 300, 64, 64
    x = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
    shift = torch.where(torch.arange(k, device="cuda") % 2 == 0, -100.0, 0.1)  # half the columns past the range
    terms = [("raw", [(x, torch.ones(k, device="cuda"), shift)],
              (torch.randn(k, n, device="cuda", generator=gen) * k ** -0.5).bfloat16())]
    with torch.no_grad():
        y, s, ss = fused_gemm_stats(terms)
        got = fused_gemm_stats_backward(terms, y, torch.randn(m, n, device="cuda", generator=gen).bfloat16(),
                                        torch.zeros(n, device="cuda"), torch.zeros(n, device="cuda"))
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(a.float()).all()) for a in (y, s, ss, *got))
    assert not got[0][:, ::2].any() and not got[1][::2].any() and not got[2][::2].any()
