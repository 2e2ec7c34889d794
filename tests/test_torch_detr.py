"""The port's DETR pieces (basedet_tpu_torch) against the JAX package on the
CPU, in f32: the sine and learned position embeddings, the attention with a
padding mask, both forms (post-norm and pre-norm) of the encoder and decoder
layers, ``Transformer``'s stacked outputs, the auction
``hungarian_match_owner`` (exactly, on the same costs: ties, invalid
targets, a capped run that needs the greedy completion, the batched form
against one problem at a time), dropout and ``drop_path`` from a seeded
generator, the DETR pad collator's mask, and tiny DETR (ResNet-10 trunk,
1 + 1 layers, width 32, 2 heads, FFN 64, 8 queries, dropout 0, batch 2 of
128x192, weights carried across by ``utils/weights.py``): decoder outputs,
matching cost, owners, losses, gradients and detections.

Tolerances, and why:
  * the embeddings to 1e-6 absolute (sin, cos and pow of the two libraries);
  * one layer, the transformer and the tiny model's decoder outputs to 1e-5
    of each tensor's largest entry (the same f32 operations, summed in each
    library's order; flax's LayerNorm takes E[x²] - E[x]²);
  * the auction exactly: the same f32 operations on the same costs;
  * the matching cost to 1e-5 of its largest entry, the owners exactly (no
    near-tie on this batch: checked by the exact auction on the JAX cost);
  * losses to 1e-5 relative, gradients to 1e-3 of each tensor's largest
    entry (tests/test_torch_yolox_train.py's bound);
  * detections at least 95% matched one to one (label, IoU >= 0.999,
    |dscore| <= 1e-4).
Frozen parameters (the stem and layer1) get no gradient in the port and a
zero one in the JAX package. Some gradients are 0 by construction: every
attention's key bias (it shifts a query's logits over all keys alike, which
the softmax ignores), and the first decoder layer's self-attention query and
key projections and value kernel (its target is zero, so its values are the
value bias alone and every attention row averages the same vector). Both
sides give rounding noise there (~1e-8), held to ``ZERO_GRAD_ATOL``
absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from basedet_tpu import configs as C
from basedet_tpu.layers.blocks import transformer as jt
from basedet_tpu.layers.common.matcher import hungarian_match_owner as j_auction
from basedet_tpu.utils import all_register
from basedet_tpu_torch import build_model
from basedet_tpu_torch.configs import DETRConfig
from basedet_tpu_torch.layers.blocks import transformer as pt
from basedet_tpu_torch.layers.blocks.drop import DropPath, drop_path, dropout
from basedet_tpu_torch.layers.common.matcher import AUCTION_MAX_CHUNK, AuctionStats, hungarian_match_owner
from basedet_tpu_torch.utils.compare import match_detections
from basedet_tpu_torch.utils.dummy import DummyLoader
from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
from tests.test_torch_retinanet import assert_rel
from tests.test_torch_yolox_train import flat
from tests.torch_threads import torch_threads  # noqa: F401

D, H, FFN, QUERIES = 32, 2, 64, 8
IMG = (128, 192)
MAX_INST = 6
LAYER_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
LOSSES = ("loss_ce", "loss_bbox", "loss_giou", "total_loss")
FROZEN = ("bottom_up/conv1/", "bottom_up/layer1_")
FIRST_SELF_ATTN_ZERO = ("transformer/decoder_0/self_attn/query/", "transformer/decoder_0/self_attn/key/",
                        "transformer/decoder_0/self_attn/value/kernel")
ZERO_GRAD_ATOL = 1e-6


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def noisy(variables, rng, scale=0.1):
    return jax.tree_util.tree_map(lambda v: np.asarray(v) + rng.normal(0.0, scale, v.shape).astype(np.float32),
                                  jax.device_get(variables))


def padding_mask(rng, B, h, w):
    """(B, h, w) True = padding: image b valid over its top-left corner."""
    mask = np.ones((B, h, w), bool)
    for b in range(B):
        mask[b, :rng.randint(h // 2, h + 1), :rng.randint(w // 2, w + 1)] = False
    mask[0] = False
    return mask


def test_sine_position_embedding_matches_jax():
    mask = padding_mask(np.random.RandomState(0), 3, 5, 7)
    want = np.asarray(jt.sine_position_embedding(jnp.asarray(mask), num_pos_feats=16))
    got = pt.sine_position_embedding(t(mask), 16).numpy()
    assert got.shape == (3, 5, 7, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_learned_position_embedding_matches_jax():
    mask = jnp.zeros((2, 4, 6), bool)
    jmod = jt.LearnedPositionEmbedding(num_pos_feats=8, max_size=10)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), mask))
    port = pt.LearnedPositionEmbedding(8, 10)
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()))
    assert sorted(port.state_dict()) == ["col_embed", "row_embed"]
    np.testing.assert_array_equal(port(t(np.zeros((2, 4, 6), bool))).detach().numpy(),
                                  np.asarray(jmod.apply(variables, mask)))


class _Wrap(torch.nn.Module):
    def __init__(self, **mods):
        super().__init__()
        for k, v in mods.items():
            self.add_module(k, v)


def test_attention_with_padding_matches_flax():
    """flax MultiHeadDotProductAttention: the query scaled before the
    product, padded keys at finfo.min, the DenseGeneral projections mapped
    onto nn.Linear and back."""
    rng = np.random.RandomState(1)
    q, kv = (rng.normal(0.0, 1.0, (2, n, D)).astype(np.float32) for n in (5, 9))
    pad = np.zeros((2, 9), bool)
    pad[1, 6:] = True
    jmod = fnn.MultiHeadDotProductAttention(num_heads=H)
    mask = jt._attn_mask_from_padding(jnp.asarray(pad), 5)
    variables = noisy(jmod.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), mask=mask),
                      rng)
    want = np.asarray(jmod.apply(variables, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), mask=mask))
    port = _Wrap(self_attn=pt.MultiHeadAttention(D, H))
    tree = {"params": {"self_attn": variables["params"]}}
    port.load_state_dict(state_dict_from_jax(tree, port.state_dict()))
    with torch.no_grad():
        got = port.self_attn(t(q), t(kv), t(kv), t(pad)).numpy()
    assert_rel(got, want, LAYER_RTOL)
    back = jax_from_state_dict(port.state_dict(), num_heads=H)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)


@pytest.mark.parametrize("pre_norm", [False, True], ids=["post-norm", "pre-norm"])
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_layer_matches_jax(kind, pre_norm):
    rng = np.random.RandomState(2)
    B, L, Q = 2, 12, 4
    src, pos = (rng.normal(0.0, 1.0, (B, L, D)).astype(np.float32) for _ in range(2))
    tgt, query_pos = (rng.normal(0.0, 1.0, (B, Q, D)).astype(np.float32) for _ in range(2))
    pad = np.zeros((B, L), bool)
    pad[1, 9:] = True
    jcls, pcls = (jt.EncoderLayer, pt.EncoderLayer) if kind == "encoder" else (jt.DecoderLayer, pt.DecoderLayer)
    jmod = jcls(D, H, FFN, 0.0, pre_norm)
    args = (src, pos, pad) if kind == "encoder" else (tgt, src, pos, query_pos, pad)
    jargs = [jnp.asarray(a) for a in args]
    variables = noisy(jax.jit(jmod.init)(jax.random.PRNGKey(0), *jargs), rng)
    want = np.asarray(jax.jit(jmod.apply)(variables, *jargs))
    port = pcls(D, H, FFN, 0.0, pre_norm).eval()
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()))
    with torch.no_grad():
        got = port(*[t(a) for a in args]).numpy()
    assert_rel(got, want, LAYER_RTOL)


@pytest.mark.parametrize("pre_norm", [False, True], ids=["post-norm", "pre-norm"])
def test_transformer_stacked_outputs_match_jax(pre_norm):
    """(layers, B, Q, D) decoder_norm outputs and the memory; pre-norm adds
    encoder_norm."""
    rng = np.random.RandomState(3)
    B, h, w = 2, 3, 4
    src, pos = (rng.normal(0.0, 1.0, (B, h, w, D)).astype(np.float32) for _ in range(2))
    mask = padding_mask(rng, B, h, w)
    query = rng.normal(0.0, 1.0, (QUERIES, D)).astype(np.float32)
    jmod = jt.Transformer(dim=D, num_heads=H, num_encoder_layers=2, num_decoder_layers=2, dim_ffn=FFN,
                          dropout=0.0, normalize_before=pre_norm)
    jargs = [jnp.asarray(a) for a in (src, mask, query, pos)]
    variables = noisy(jax.jit(jmod.init)(jax.random.PRNGKey(0), *jargs), rng)
    hs, memory = jax.jit(jmod.apply)(variables, *jargs)
    port = pt.Transformer(D, H, 2, 2, FFN, 0.0, pre_norm).eval()
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()))
    assert ("encoder_norm.weight" in port.state_dict()) == pre_norm
    seq = lambda a: t(a).reshape(B, h * w, -1)
    with torch.no_grad():
        got_hs, got_memory = port(seq(src), t(mask).reshape(B, h * w), t(query), seq(pos))
    assert got_hs.shape == (2, B, QUERIES, D)
    assert_rel(got_hs.numpy(), np.asarray(hs), LAYER_RTOL)
    assert_rel(got_memory.numpy(), np.asarray(memory), LAYER_RTOL)


# -- the auction -----------------------------------------------------------------------------------

def _auction_cases():
    rng = np.random.RandomState(1)
    cases = {"random (20, 7)": [(rng.rand(20, 7).astype(np.float32) * 10, np.ones(7, bool)) for _ in range(5)]}
    rng = np.random.RandomState(7)
    for Q, K, V in [(100, 100, 15), (100, 100, 60), (16, 8, 5)]:
        base = rng.randn(Q) * 3.0
        cost = (base[:, None] + rng.randn(Q, K) * 0.3).astype(np.float32)
        valid = np.arange(K) < V
        cost[:, V:] = 1e6
        cases[f"competitive ({Q}, {K}, {V} valid)"] = [(cost, valid)]
    # ties: integer costs over a small range, so best and second tie and bids tie
    cases["ties"] = [(rng.randint(0, 3, (12, 6)).astype(np.float32), rng.rand(6) < 0.8) for _ in range(4)]
    cases["no valid target"] = [(rng.rand(6, 4).astype(np.float32), np.zeros(4, bool))]
    return cases


@pytest.mark.parametrize("name", list(_auction_cases()))
def test_auction_matches_jax_exactly(name):
    """The batched auction against the JAX package's, problem by problem."""
    cases = _auction_cases()[name]
    j = jax.jit(j_auction, static_argnames=("n_iters",))
    want = np.stack([np.asarray(j(jnp.asarray(c), jnp.asarray(v))) for c, v in cases])
    got = hungarian_match_owner(t(np.stack([c for c, _ in cases])), t(np.stack([v for _, v in cases])))
    np.testing.assert_array_equal(got.numpy(), want)
    valid = np.stack([v for _, v in cases])
    assert (got.numpy()[~valid] == -2).all() and (got.numpy()[valid] >= 0).all()
    assert not AuctionStats.completed and AuctionStats.syncs >= 1
    needed = AuctionStats.needed.numpy()
    assert needed.max() <= AuctionStats.rounds < needed.max() + AUCTION_MAX_CHUNK


def test_capped_auction_runs_the_greedy_completion_as_jax():
    """A cap of 3 rounds leaves competitive targets unassigned: the greedy
    completion gives each, target by target, its best free query."""
    rng = np.random.RandomState(7)
    base = rng.randn(30) * 3.0
    cost = (base[:, None] + rng.randn(30, 20) * 0.3).astype(np.float32)
    valid = rng.rand(20) < 0.9
    want = np.asarray(j_auction(jnp.asarray(cost), jnp.asarray(valid), n_iters=3))
    got = hungarian_match_owner(t(cost[None]), t(valid[None]), n_iters=3)[0].numpy()
    assert AuctionStats.completed and AuctionStats.rounds == 3
    np.testing.assert_array_equal(got, want)
    assert len(set(got[valid].tolist())) == valid.sum()


def test_batched_auction_equals_one_problem_at_a_time():
    rng = np.random.RandomState(7)
    L, B, Q, K = 2, 3, 6, 4
    cost = rng.randn(L * B, Q, K).astype(np.float32)
    valid = rng.rand(L * B, K) < 0.7
    batched = hungarian_match_owner(t(cost), t(valid))
    for p in range(L * B):
        np.testing.assert_array_equal(batched[p].numpy(), hungarian_match_owner(t(cost[p:p + 1]), t(valid[p:p + 1]))[0])


# -- dropout --------------------------------------------------------------------------------------

def test_dropout_and_drop_path_from_a_seeded_generator():
    x = torch.ones(4000, 8)
    g = lambda: torch.Generator().manual_seed(3)
    y = dropout(x, 0.25, g())
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    assert torch.all(y[kept] == 1 / 0.75)
    assert torch.equal(dropout(x, 0.25, g()), y)  # the same seed, the same draw
    assert dropout(x, 0.25, None) is x and dropout(x, 0.0, g()) is x
    z = drop_path(x, 0.3, g())
    per_sample = z[:, 0]
    assert torch.all((z == per_sample[:, None]))  # one draw per sample
    assert abs(float((per_sample != 0).float().mean()) - 0.7) < 0.03
    assert torch.all(per_sample[per_sample != 0] == 1 / 0.7)
    module = DropPath(0.3)
    assert module(x, g()) is not x and torch.equal(module(x, g()), z)
    assert module.eval()(x, g()) is x


# -- the collator's mask --------------------------------------------------------------------------

def test_detr_pad_collator_mask_equals_the_jax_collator():
    from basedet_tpu.data.collators.pad_collator import DETRPadCollator as JCollator

    from basedet_tpu_torch.data.collators import DETRPadCollator

    rng = np.random.RandomState(4)
    records = [{"image": rng.randint(0, 255, (h, w, 3)).astype(np.uint8), "boxes": np.zeros((0, 4), np.float32),
                "labels": np.zeros(0, np.int32), "image_id": i} for i, (h, w) in enumerate([(50, 70), (64, 33)])]
    for buckets in (None, [(64, 64), (96, 96)]):
        want = JCollator(max_instances=4, size_buckets=buckets)(records)
        got = DETRPadCollator(max_instances=4, size_buckets=buckets)(records)
        assert got["mask"].dtype == torch.uint8
        np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
        np.testing.assert_array_equal(got["data"].numpy(), want["data"])


def test_detr_loader_batches_carry_the_mask(tmp_path):
    """DETRDataloaderBuilder: COCO-format sets through the mask collator;
    dummy through the default builder (no mask: the model makes it)."""
    from basedet_tpu_torch.data import DETRDataloaderBuilder, register_dataset
    from basedet_tpu_torch.tools.sanity_e2e import make_synthetic_coco

    train, _ = make_synthetic_coco(str(tmp_path), n_train=4, n_val=1, size=64)
    register_dataset("detr_mask_train", *train)
    cfg = DETRConfig()
    cfg.merge(["DATA.TRAIN.name", "detr_mask_train", "DATA.NUM_WORKERS", "0", "MODEL.BATCHSIZE", "2",
               "AUG.TRAIN_VALUE", "()"])
    loader = DETRDataloaderBuilder.build(cfg)
    batch = next(iter(loader))
    loader.close()
    assert batch["mask"].shape == batch["data"].shape[:3] and bool((batch["mask"] == 1).all())
    cfg.DATA.TRAIN.name = "dummy"
    assert "mask" not in next(iter(DETRDataloaderBuilder.build(cfg)))


# -- tiny DETR ------------------------------------------------------------------------------------

def _shrink(cfg):
    cfg.MODEL.BACKBONE.NAME = "resnet10"
    tr = cfg.MODEL.TRANSFORMER
    tr.DIM, tr.NUM_HEADS, tr.NUM_ENCODERS, tr.NUM_DECODERS, tr.DIM_FFN, tr.DROPOUT = D, H, 1, 1, FFN, 0.0
    cfg.MODEL.NUM_QUERIES = QUERIES
    cfg.DATA.MAX_INSTANCES = MAX_INST
    cfg.MODEL.BATCHSIZE = 2
    return cfg


def make_batch():
    batch = DummyLoader(batch_size=2, image_size=IMG, max_instances=MAX_INST).make_batch()
    batch["im_info"][1, :2] = (100, 150)  # image 1 padded: its mask from im_info
    batch["im_info"][1, 4] = 2
    batch["gt_boxes"][1, 2:] = 0.0
    batch["gt_boxes"][0, 2, 2] = batch["gt_boxes"][0, 2, 0]  # a zero-width gt: not a valid target
    return batch


@pytest.fixture(scope="module")
def tiny():
    all_register()
    jcfg = _shrink(C.DETRConfig())
    jmodel = jcfg.build_model()
    rng = np.random.RandomState(0)
    variables = jax.device_get(jmodel.init_variables(jax.random.PRNGKey(0), image_size=IMG))
    variables = {"frozen": variables["frozen"], "params": noisy(variables["params"], rng, 0.05)}
    batch = make_batch()

    def loss_fn(params):
        total, losses, _ = jmodel.get_losses({**variables, "params": params}, batch)
        return total, losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    jdets = jax.device_get(jmodel.inference_jit(variables, batch))
    inputs = jmodel._prepare(batch, train=True)
    logits, coords = jax.device_get(jax.jit(jmodel.make_module(train=True).apply)(variables, inputs["image"],
                                                                                   inputs["mask"]))

    port = build_model(_shrink(DETRConfig()), "cpu")
    port.module.load_state_dict(state_dict_from_jax(variables, port.module.state_dict()))
    port.train()
    port.module.zero_grad(set_to_none=True)
    total, losses = port.get_losses(batch)
    total.backward()
    named = dict(port.module.named_parameters())
    grads = jax_from_state_dict({n: p.grad for n, p in named.items() if p.grad is not None}, num_heads=H)
    return dict(jmodel=jmodel, variables=variables, batch=batch, jlosses=jax.device_get(jlosses),
                jgrads=flat(jax.device_get(jgrads)), jdets=jdets, logits=logits, coords=coords, port=port,
                losses={k: float(v.detach()) for k, v in losses.items()}, grads=flat(grads["params"]),
                no_grad={n for n, p in named.items() if p.grad is None})


def test_decoder_outputs_match_jax(tiny):
    port = tiny["port"]
    with torch.no_grad():
        x = port.prepare(tiny["batch"], train=True)
        logits, coords = port.module(x["image"], x["mask"])
    assert x["mask"][1, 99, 149] == 1 and x["mask"][1, 100].sum() == 0 and x["mask"][1, :, 150].sum() == 0
    assert logits.shape == (1, 2, QUERIES, 81)
    assert_rel(logits.numpy(), tiny["logits"], LAYER_RTOL, "logits")
    assert_rel(coords.numpy(), tiny["coords"], LAYER_RTOL, "boxes")


def test_matching_cost_and_owners_match_jax(tiny, monkeypatch):
    """The JAX package's cost read from its own ``_match_single`` (problem by
    problem), the port's from its batched form; the owners of both paths."""
    from basedet_tpu.models.det import detr as jdetr

    jmodel, port = tiny["jmodel"], tiny["port"]
    inputs = jmodel._prepare(tiny["batch"], train=True)
    gt, info = inputs["gt_boxes"], inputs["img_info"]
    tgt_boxes, tgt_cls, tgt_valid, _ = port.targets(t(gt), t(info))
    seen = []
    monkeypatch.setattr(jdetr, "hungarian_match_owner", lambda cost, valid: seen.append(np.asarray(cost))
                        or j_auction(cost, valid=valid))
    probs = jax.nn.softmax(jnp.asarray(tiny["logits"][-1]), axis=-1)
    want_owner = np.stack([np.asarray(jmodel._match_single(probs[b], jnp.asarray(tiny["coords"][-1][b]),
                                                           jnp.asarray(tgt_boxes[b].numpy()),
                                                           jnp.asarray(tgt_cls[b].numpy()),
                                                           jnp.asarray(tgt_valid[b].numpy()))) for b in range(2)])
    cost = port.matching_cost(t(tiny["logits"][-1]), t(tiny["coords"][-1]), tgt_boxes, tgt_cls)
    assert_rel(cost.numpy(), np.stack(seen), LAYER_RTOL, "cost")
    with torch.no_grad():
        x = port.prepare(tiny["batch"], train=True)
        logits, coords = port.module(x["image"], x["mask"])
    owner = port.match(logits, coords, tgt_boxes, tgt_cls, tgt_valid)[-1].numpy()
    np.testing.assert_array_equal(owner, want_owner)
    np.testing.assert_array_equal(hungarian_match_owner(t(np.stack(seen)), tgt_valid).numpy(), want_owner)
    assert (owner[~tgt_valid.numpy()] == -2).all() and int(tgt_valid.sum()) == 4


def test_losses_and_grads_match_jax(tiny):
    for k in LOSSES:
        want = float(tiny["jlosses"][k])
        assert abs(tiny["losses"][k] - want) <= LOSS_RTOL * abs(want), (k, tiny["losses"][k], want)
    frozen = {k for k in tiny["jgrads"] if k.startswith(FROZEN)}
    assert frozen and set(tiny["grads"]) == set(tiny["jgrads"]) - frozen
    assert {n.replace(".", "/") for n in tiny["no_grad"]} == {k.rsplit("/", 1)[0] + "/" + {"kernel": "weight"}[
        k.rsplit("/", 1)[1]] for k in frozen}
    for k in frozen:
        assert not np.any(tiny["jgrads"][k]), k
    for k, got in tiny["grads"].items():
        if k.startswith(FIRST_SELF_ATTN_ZERO) or k.endswith("/key/bias"):
            assert np.abs(got).max() <= ZERO_GRAD_ATOL and np.abs(tiny["jgrads"][k]).max() <= ZERO_GRAD_ATOL, k
        else:
            assert_rel(got, tiny["jgrads"][k], GRAD_RTOL, k)


def test_detections_match_jax(tiny):
    port = tiny["port"]
    port.eval()
    got = {k: v.numpy() for k, v in port.inference(tiny["batch"]).items()}
    want = tiny["jdets"]
    assert got["boxes"].shape == (2, QUERIES, 4) and want["valid"].all()
    assert match_detections(want, got) >= 0.95 and match_detections(got, want) >= 0.95


def test_dropout_draws_from_the_step_generator():
    """With dropout, a step's losses depend on (seed, step) alone: the same
    pair gives the same losses, another step others; eval mode draws
    nothing."""
    cfg = _shrink(DETRConfig())
    cfg.MODEL.TRANSFORMER.DROPOUT = 0.1
    port = build_model(cfg, "cpu").train()
    batch = make_batch()
    run = lambda step: float(port.get_losses(batch, seed=42, step=step)[0].detach())
    assert run(3) == run(3) != run(4)
    assert port.eval().dropout_generator(42, 3) is None
