"""The port's bf16 compute policy (``TRAINER.AMP``, ``--amp``) against the JAX
package's on the CPU: BatchNorm and each YOLO block under
``precision_policy(bf16)`` against flax, the tiny YOLOX-S ``get_losses`` with
the fused CSP chain off and on against the JAX package's (Pallas in interpret
mode), and ``det_train --amp`` end to end.

Tolerances and why:
  * BatchNorm on one bf16 input equals flax's ``nn.BatchNorm(dtype=bf16)``
    exactly: statistics in f32 as E[x²] - E[x]², the normalisation in f32 in
    flax's order, one rounding to bf16 (running statistics to 1e-6).
  * A block's output is held to 8 bf16 ulps of its largest value: XLA:CPU
    computes ``jax.nn.silu`` on bf16 with exp, add and divide each rounded
    to bf16, PyTorch's ``F.silu`` rounds once, so 30-40% of the activations
    differ by an ulp, and a block of several layers by a few (measured: 1 ulp
    for ConvBNAct and Focus, 4 for the CSP layer, 6 for SPP, whose pooled
    concat feeds one 1x1 conv). Running statistics: 1e-3.
  * A block's gradients (the backward of one random bf16 cotangent) are held,
    per parameter and for the input, to 16 bf16 ulps of their largest
    magnitude and to 5% in L2 (measured: at most 13.4 ulps, SPP's second conv
    kernel, and 3.7% in L2, SPP's first BN scale; a zero gradient lies 100%
    off, and a BN backward that drops the gradient through the batch
    statistics 16-1800 ulps and 6-550%).
  * Tiny YOLOX-S in train mode (batch 2, 128²) amplifies any perturbation:
    the JAX package's own bf16 head outputs differ from its f32 ones by 10-20%
    of their largest magnitude, and the port's f32 outputs match the JAX
    package's to 1e-4 (tests/test_torch_yolox.py). So the port's bf16 head
    outputs are held to the JAX package's bf16 ones by that yardstick: their
    mean deviation at most 1.5 times the mean deviation of JAX's bf16 from
    JAX's f32 (measured: 0.95-1.05 times). The losses are held to 10%
    relative and the gradient norm to 15% (measured: 3.7% and 3.0% with the
    chain off, 1.5% and 7.9% with it on: SimOTA's near-ties move a few
    anchors). The port's two branches are held to each other as tightly.
  * The gradient vectors: tiny YOLOX-S in train mode is chaotic under bf16,
    so the whole gradient cannot be held tightly. The JAX package's own bf16
    gradient has a cosine of only 0.39 (chain off) and 0.53 (on) with its f32
    one (the port's f32 gradient, which tests/test_torch_yolox_train.py holds
    to JAX's): near the input the gradient is 100 times its size at the head
    and carries the forward's bf16 deviations, and the two runs' SimOTA
    near-ties may put foreground on other levels (JAX's bf16 run, chain off,
    leaves level 1's head without gradient). The port's bf16 gradient must
    point at least half as close to JAX's bf16 one: its cosine with it at
    least half of JAX's bf16-vs-f32 cosine (measured 0.47 and 0.53, so 1.19
    and 0.98 times), which a zero, random or negated gradient fails; the
    block tests above hold the backward of every layer tightly.
"""
import math
import os

import numpy as np
import pytest
import torch

from basedet_tpu_torch.layers import precision
from basedet_tpu_torch.layers.blocks import yolo_block as P
from basedet_tpu_torch.ops.fused_bn import fused_gemm_stats_backward_plain, fused_gemm_stats_plain
from basedet_tpu_torch.ops.fused_bn_kernel import fused_gemm_stats
from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax


def _flat(tree):
    from tests.test_torch_yolox_train import flat

    return flat(tree)


def test_policy_from_cfg():
    from basedet_tpu_torch.configs import YOLOXSConfig

    cfg = YOLOXSConfig()
    assert precision.policy_from_cfg(cfg) == (None, False)
    cfg.TRAINER.AMP.ENABLE = True
    assert precision.policy_from_cfg(cfg) == (torch.bfloat16, False)
    cfg.merge(["TRAINER.AMP.FUSED_BN", "True"])
    assert precision.policy_from_cfg(cfg) == (torch.bfloat16, True)
    cfg.TRAINER.AMP.DTYPE = "int8"
    with pytest.raises(ValueError):
        precision.policy_from_cfg(cfg)
    with precision.precision_policy(torch.bfloat16, True):
        assert precision.compute_dtype() == torch.bfloat16 and precision.fused_bn_enabled()
        with precision.precision_policy(None):
            assert precision.compute_dtype() is None and not precision.fused_bn_enabled()
    assert precision.compute_dtype() is None and not precision.fused_bn_enabled()


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_matches_flax_bf16(train):
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    rng = np.random.RandomState(0)
    x = (rng.randn(2, 6, 5, 8) * 3 + 1).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    bn = nn.BatchNorm(use_running_average=not train, momentum=0.97, epsilon=1e-3, dtype=jnp.bfloat16)
    variables = jax.device_get(bn.init(jax.random.PRNGKey(0), xj))
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
                            "bias": rng.normal(0, 0.3, 8).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(0, 0.2, 8).astype(np.float32),
                                 "var": rng.uniform(0.5, 2.0, 8).astype(np.float32)}}
    ref, new = bn.apply(variables, xj, mutable=["batch_stats"])
    port = P.FlaxBatchNorm2d(8, eps=1e-3, momentum=0.03).train(train)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        port.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        port.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        port.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)).transpose(0, 3, 1, 2)).bfloat16()
    with precision.precision_policy(torch.bfloat16), torch.no_grad():
        got = port(xt)
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy().transpose(0, 2, 3, 1),
                                  np.asarray(ref.astype(jnp.float32)))
    for name, buf in (("mean", port.running_mean), ("var", port.running_var)):
        np.testing.assert_allclose(buf.numpy(), np.asarray(new["batch_stats"][name]), rtol=0, atol=1e-6)


BLOCKS = {
    "conv_bn_act": (lambda J: J._ConvBNAct(8, 3, train=True), lambda: P.ConvBNAct(16, 8, 3)),
    "focus": (lambda J: J.Focus(8, 3, train=True), lambda: P.Focus(16, 8, 3)),
    "spp": (lambda J: J.SPPBottleneck(16, train=True), lambda: P.SPPBottleneck(16, 16)),
    "bottleneck": (lambda J: J.Bottleneck(16, train=True), lambda: P.Bottleneck(16, 16)),
    "csp": (lambda J: J.CSPLayer(16, n=2, train=True), lambda: P.CSPLayer(16, 16, n=2)),
}


@pytest.mark.parametrize("block", list(BLOCKS))
def test_bf16_block_matches_flax(block):
    """One train-mode forward under the bf16 policy: output in bf16 and the
    new BN running statistics, against flax on the same weights; then the
    backward of a random cotangent: the port's autograd against ``jax.vjp``,
    for every parameter and the input."""
    import jax
    import jax.numpy as jnp

    from basedet_tpu.layers.blocks import yolo_block as J
    from basedet_tpu.layers.precision import precision_policy as jax_policy
    from tests.test_torch_yolox import _randomise

    rng = np.random.RandomState(1)
    x = (rng.randn(2, 8, 8, 16) * 2 + 0.5).astype(np.float32)
    make_jax, make_port = BLOCKS[block]
    with jax_policy(jnp.bfloat16):
        jmod = make_jax(J)
        variables = _randomise(jmod.init(jax.random.PRNGKey(1), x), rng)
        ref, new = jmod.apply(variables, x, mutable=["batch_stats"])
        forward = lambda params, xj: jmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                                xj, mutable=["batch_stats"])[0]
        _, vjp = jax.vjp(forward, variables["params"], x)
        cotangent = jnp.asarray(rng.randn(*ref.shape).astype(np.float32), ref.dtype)
        jgrads, jgx = jax.device_get(vjp(cotangent))
    port = make_port()
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()))
    port.train()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2)).requires_grad_()
    with precision.precision_policy(torch.bfloat16):
        got = port(xt)
    # bf16 out, but f32 where a block adds its f32 input (the bottleneck's shortcut)
    assert str(ref.dtype) == str(got.dtype).removeprefix("torch.")
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(got.detach().float().numpy().transpose(0, 2, 3, 1) - ref).max()
    assert err <= 8 * 2**-8 * np.abs(ref).max(), err
    stats = _flat(jax_from_state_dict(port.state_dict())["batch_stats"])
    jstats = _flat(jax.device_get(new["batch_stats"]))
    assert stats.keys() == jstats.keys()
    for k, v in jstats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-3, atol=1e-3, err_msg=k)

    got.backward(torch.from_numpy(np.array(cotangent.astype(jnp.float32)).transpose(0, 3, 1, 2)).to(got.dtype))
    grads = _flat(jax_from_state_dict({n: p.grad for n, p in port.named_parameters()})["params"])
    jgrads = _flat(jgrads)
    assert grads.keys() == jgrads.keys()
    grads["input"], jgrads["input"] = xt.grad.numpy().transpose(0, 2, 3, 1), np.asarray(jgx)
    for k, want in jgrads.items():
        want = np.asarray(want, np.float32)
        assert grads[k].dtype == np.float32 and grads[k].shape == want.shape, k
        diff = grads[k] - want
        assert np.abs(diff).max() <= 16 * 2**-8 * np.abs(want).max(), (k, np.abs(diff).max())
        assert np.linalg.norm(diff) <= 0.05 * np.linalg.norm(want), (k, np.linalg.norm(diff))


@pytest.fixture(scope="module")
def amp_runs():
    """Tiny YOLOX-S get_losses with its gradient, under bf16, the fused chain
    off and on, in the JAX package (its own switches: BASEDET_FUSED_BN with
    interpret-mode Pallas) and in the port (TRAINER.AMP.FUSED_BN's policy)."""
    import jax
    import jax.numpy as jnp

    from basedet_tpu.layers.precision import precision_policy as jax_policy
    from tests.test_torch_yolox_train import make_batch, make_pair, tiny_cfg

    cfg = tiny_cfg()
    cfg.MODEL.USE_L1 = True  # every loss term live
    jmodel, variables, port = make_pair(cfg)
    batch = make_batch()
    state_dict = {k: v.clone() for k, v in port.module.state_dict().items()}
    head = {}

    def keep_head(module, args, out):
        head["port"] = [[t.detach().float() for t in level] for level in out]

    port.module.register_forward_hook(keep_head)
    image = jmodel.pre_process(batch, train=True)["image"]
    f32_head = jax.jit(lambda v: jmodel.make_module(train=True).apply(
        v, image, mutable=["batch_stats"])[0])(variables)
    port.module.load_state_dict(state_dict)
    port.get_losses(batch)[0].backward()
    runs = {"f32_grads": _flat(jax_from_state_dict({n: p.grad for n, p in port.module.named_parameters()})["params"])}
    for fused in (False, True):
        env = {"BASEDET_FUSED_BN": "1", "BASEDET_FUSED_BN_INTERPRET": "1"} if fused else {}
        with pytest.MonkeyPatch.context() as mp, jax_policy(jnp.bfloat16):
            for k, v in env.items():
                mp.setenv(k, v)

            def loss_fn(params):
                total, losses, _ = jmodel.get_losses(
                    {"params": params, "batch_stats": variables["batch_stats"]}, batch)
                head_out = jmodel.make_module(train=True).apply(
                    variables, image, mutable=["batch_stats"])[0]
                return total, (losses, head_out)

            (_, (jlosses, jhead)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                variables["params"])
        port.module.load_state_dict(state_dict)
        port.module.zero_grad(set_to_none=True)
        calls = (fused_gemm_stats_plain.calls, fused_gemm_stats_backward_plain.calls)
        with precision.precision_policy(torch.bfloat16, fused):
            total, losses = port.get_losses(batch)
        total.backward()
        grads = _flat(jax_from_state_dict({n: p.grad for n, p in port.module.named_parameters()})["params"])
        norm = lambda g: math.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values()))
        runs[fused] = dict(
            jlosses={k: float(v) for k, v in jax.device_get(jlosses).items()},
            losses={k: float(v.detach()) for k, v in losses.items()},
            jgrads=_flat(jax.device_get(jgrads)), grads=grads,
            jnorm=norm(_flat(jax.device_get(jgrads))), norm=norm(grads),
            jhead=[[np.asarray(t.astype(jnp.float32)) for t in level] for level in jhead],
            f32_head=[[np.asarray(t) for t in level] for level in f32_head],
            head=head["port"], total_dtype=total.dtype,
            calls=(fused_gemm_stats_plain.calls - calls[0],
                   fused_gemm_stats_backward_plain.calls - calls[1]))
    return runs


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_tiny_yolox_amp_losses_match_jax(amp_runs, fused):
    r = amp_runs[fused]
    # 8 CSP layers of 3 + n fused calls each (n = 1, 3, 3, 1 and four PAFPN 1s)
    assert r["calls"] == ((36, 36) if fused else (0, 0))
    assert r["total_dtype"] == torch.float32
    for level, jlevel, flevel in zip(r["head"], r["jhead"], r["f32_head"]):
        for t, j, f in zip(level, jlevel, flevel):
            noise = np.abs(j - f).mean()  # the JAX package's own bf16 against its f32
            assert 0 < np.abs(t.permute(0, 2, 3, 1).numpy() - j).mean() <= 1.5 * noise
    assert set(r["losses"]) == set(r["jlosses"])
    for k, v in r["losses"].items():
        assert math.isfinite(v) and abs(v - r["jlosses"][k]) <= 0.1 * abs(r["jlosses"][k]), (k, v)
    assert abs(r["norm"] - r["jnorm"]) <= 0.15 * r["jnorm"], (r["norm"], r["jnorm"])
    # the gradient vectors: bf16's own cosine with f32 is the yardstick
    port, yardstick = _cosine(r["grads"], r["jgrads"]), _cosine(r["jgrads"], amp_runs["f32_grads"])
    assert yardstick > 0 and port >= 0.5 * yardstick, (port, yardstick)


def _cosine(a, b):
    """The cosine of two flat gradient trees, in float64; 0 where one is 0."""
    a, b = ([np.asarray(t[k], np.float64).ravel() for k in sorted(b)] for t in (a, b))
    a, b = np.concatenate(a), np.concatenate(b)
    norms = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / norms) if norms > 0 else 0.0


def test_tiny_yolox_fused_branch_matches_unfused(amp_runs):
    a, b = amp_runs[True], amp_runs[False]
    for k, v in a["losses"].items():
        assert abs(v - b["losses"][k]) <= 0.1 * abs(b["losses"][k]), (k, v, b["losses"][k])
    assert abs(a["norm"] - b["norm"]) <= 0.15 * b["norm"]


def test_det_train_amp_fused_on_cpu(tmp_path):
    """``det_train --amp TRAINER.AMP.FUSED_BN True`` on tiny YOLOX-S: 36
    fused forward and 36 backward calls per step, through the plain versions
    (CPU tensors), none through the kernels; then ``det_test`` serves the dump
    in f32."""
    import json

    from basedet_tpu_torch.ops.fused_bn_kernel import fused_gemm_stats_backward
    from basedet_tpu_torch.tools import det_test, det_train
    from tests.test_torch_det_train import CONFIG, _opts

    before = (fused_gemm_stats_plain.calls, fused_gemm_stats_backward_plain.calls,
              fused_gemm_stats.launches, fused_gemm_stats_backward.launches)
    trainer = det_train.main(["-f", CONFIG, "--device", "cpu", "--amp", *_opts(tmp_path),
                              "SOLVER.MAX_EPOCH", "1", "TRAINER.AMP.FUSED_BN", "True"])
    after = (fused_gemm_stats_plain.calls, fused_gemm_stats_backward_plain.calls,
             fused_gemm_stats.launches, fused_gemm_stats_backward.launches)
    assert trainer.state.step == 2
    assert [a - b for a, b in zip(after, before)] == [72, 72, 0, 0]
    for k in ("total_loss", "iou_loss", "obj_loss", "cls_loss", "l1_loss"):
        assert math.isfinite(trainer.meters[k].latest) and trainer.meters[k].latest > 0, k
    assert precision.compute_dtype() is None  # the policy ends with the step
    assert all(p.dtype == torch.float32 for p in trainer.model.module.parameters())
    dumped = tmp_path / "ckpt" / "dumped_model.pt"
    results = det_test.main(["-f", CONFIG, "-w", str(dumped), "--device", "cpu", *_opts(tmp_path)])
    records = json.loads((tmp_path / "predict_coco.json").read_text())
    assert results["num_detections"] == len(records) > 0
    assert all(math.isfinite(r["score"]) for r in records)


def test_make_train_step_refuses_remat():
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.engine.train_state import make_train_step
    from basedet_tpu_torch.solver import YOLOXSolver
    from basedet_tpu_torch.tools import import_config

    cfg = import_config("basedet_tpu_torch/playground/yolox_s/config.py")
    cfg.merge(["MODEL.WIDTH_FACTOR", "0.25", "TRAINER.REMAT", "True", "TRAINER.AMP.ENABLE", "True"])
    with pytest.raises(NotImplementedError, match="REMAT"):
        make_train_step(build_model(cfg, "cpu"), YOLOXSolver.build(cfg), cfg)
