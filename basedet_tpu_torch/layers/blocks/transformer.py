"""DETR's transformer in PyTorch (counterpart of
``basedet_tpu/layers/blocks/transformer.py``).

Sequences are (B, L, D); a key padding mask is (B, L) bool, True =
padding. The attention follows flax's ``MultiHeadDotProductAttention``
numerics: the query divided by sqrt(D/H) before the product, a masked logit
set to ``finfo(f32).min`` (not -inf), and attention dropout as one (Lq, Lk)
keep mask shared by the batch and the heads (flax's ``broadcast_dropout``).
Its ``query``, ``key``, ``value`` and ``out`` projections are ``nn.Linear``
layers under flax's names (``utils/weights.py`` maps the ``DenseGeneral``
kernels onto them); ``nn.LayerNorm`` takes flax's eps, 1e-6. Every dropout
draws from the ``generator`` handed to ``forward``: None (or eval mode)
means none.

Tensor parallelism: where the JAX package constrains the FFN's hidden
activations to its mesh's ``model`` axis (``tp_shard``), the FFN here splits
its hidden width F over the model group that ``parallel/tp.py`` installs
(``TRAINER.TP_SIZE``, inside the train step). Weights stay replicated, so
checkpoints do not change: model rank m uses columns ``[m·F/tp,
(m+1)·F/tp)`` of ``linear1`` and the same rows of ``linear2``'s input, sums
the partial products over the model group and adds ``linear2``'s bias once.
The FFN's dropout mask is drawn at the full (B, L, F) shape and sliced, so
every model rank draws the same stream. The attention and the norms run
whole on every model rank. Without a model group the FFN is the plain one.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch.layers.blocks.drop import batch_keep_mask, dropout, keep_mask
from basedet_tpu_torch.parallel.tp import copy_to_model, reduce_from_model, tp_rank, tp_size

LN_EPS = 1e-6  # flax nn.LayerNorm's


class MLP(nn.Module):
    """``num_layers`` Linear layers (``layer<i>``) with ReLU between them."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, num_layers: int = 3, device=None):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        for i in range(num_layers):
            self.add_module(f"layer{i}", nn.Linear(dims[i], dims[i + 1], device=device))

    def forward(self, x):
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"layer{i}")(x))
        return getattr(self, f"layer{self.num_layers - 1}")(x)


def sine_position_embedding(mask: torch.Tensor, num_pos_feats: int = 128, temperature: int = 10000) -> torch.Tensor:
    """mask (B, H, W) True = padding → (B, H, W, 2·num_pos_feats): the y
    embedding then the x, sine and cosine interleaved."""
    not_mask = 1.0 - mask.to(torch.float32)
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    eps, scale = 1e-6, 2 * math.pi
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)

    def interleave(pos):
        return torch.stack([torch.sin(pos[..., 0::2]), torch.cos(pos[..., 1::2])], dim=-1).flatten(-2)

    return torch.cat([interleave(y_embed[..., None] / dim_t), interleave(x_embed[..., None] / dim_t)], dim=-1)


class LearnedPositionEmbedding(nn.Module):
    """``row_embed`` and ``col_embed`` (max_size, num_pos_feats) → (B, H, W,
    2·num_pos_feats): the column's embedding then the row's."""

    def __init__(self, num_pos_feats: int = 128, max_size: int = 50, device=None):
        super().__init__()
        self.row_embed = nn.Parameter(torch.empty(max_size, num_pos_feats, device=device))
        self.col_embed = nn.Parameter(torch.empty(max_size, num_pos_feats, device=device))

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        B, H, W = mask.shape
        F_ = self.row_embed.shape[1]
        pos = torch.cat([self.col_embed[None, :W, :].expand(H, W, F_),
                         self.row_embed[:H, None, :].expand(H, W, F_)], dim=-1)
        return pos[None].expand(B, H, W, 2 * F_)


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (qkv width = the input's)."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0, device=None):
        super().__init__()
        self.num_heads, self.dropout = num_heads, dropout
        for name in ("query", "key", "value", "out"):
            self.add_module(name, nn.Linear(dim, dim, device=device))

    def forward(self, q_in: torch.Tensor, k_in: torch.Tensor, v_in: torch.Tensor,
                key_padding: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, Lq, D = q_in.shape
        Lk, H = k_in.shape[1], self.num_heads
        q = self.query(q_in).view(B, Lq, H, D // H)
        k = self.key(k_in).view(B, Lk, H, D // H)
        v = self.value(v_in).view(B, Lk, H, D // H)
        q = q / torch.sqrt(torch.tensor(D // H, dtype=q.dtype, device=q.device))
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if key_padding is not None:
            w = w.masked_fill(key_padding[:, None, None, :], torch.finfo(w.dtype).min)
        w = torch.softmax(w, dim=-1)
        if generator is not None and self.dropout > 0.0:
            keep = 1.0 - self.dropout
            w = w * (keep_mask((Lq, Lk), keep, generator, w.device).to(w.dtype) / keep)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Lq, D))


class _Layer(nn.Module):
    def __init__(self, dim, num_heads, dim_ffn, dropout, normalize_before, attns, num_norms, device):
        super().__init__()
        self.rate, self.normalize_before = dropout, normalize_before
        for name in attns:
            self.add_module(name, MultiHeadAttention(dim, num_heads, dropout, device=device))
        self.linear1 = nn.Linear(dim, dim_ffn, device=device)
        self.linear2 = nn.Linear(dim_ffn, dim, device=device)
        for i in range(num_norms):
            self.add_module(f"norm{i + 1}", nn.LayerNorm(dim, eps=LN_EPS, device=device))

    def ffn(self, x, g):
        tp = tp_size()
        if tp == 1:
            return self.linear2(dropout(F.relu(self.linear1(x)), self.rate, g))
        width = self.linear1.out_features
        if width % tp:
            raise ValueError(f"the FFN's width {width} does not split over TRAINER.TP_SIZE {tp}")
        m = tp_rank()
        cols = slice(m * width // tp, (m + 1) * width // tp)
        h = F.relu(F.linear(copy_to_model(x), self.linear1.weight[cols], self.linear1.bias[cols]))
        if g is not None and self.rate > 0.0:
            keep = 1.0 - self.rate
            mask = batch_keep_mask((*h.shape[:-1], width), keep, g, h.device)[..., cols]
            h = torch.where(mask, h / keep, 0.0)
        return reduce_from_model(F.linear(h, self.linear2.weight[:, cols])) + self.linear2.bias

    def tp_sharded_parameters(self):
        """The parameters whose gradient a model rank holds only its slice of
        under tensor parallelism: ``linear1``'s weight and bias and
        ``linear2``'s weight (``linear2``'s bias is whole on every rank)."""
        return [self.linear1.weight, self.linear1.bias, self.linear2.weight]

    def residual(self, x, i, fn, g):
        """Post-norm ``norm(x + drop(fn(x)))`` or pre-norm ``x + drop(fn(norm(x)))``."""
        norm = getattr(self, f"norm{i}")
        if self.normalize_before:
            return x + dropout(fn(norm(x)), self.rate, g)
        return norm(x + dropout(fn(x), self.rate, g))


class EncoderLayer(_Layer):
    def __init__(self, dim, num_heads=8, dim_ffn=2048, dropout=0.1, normalize_before=False, device=None):
        super().__init__(dim, num_heads, dim_ffn, dropout, normalize_before, ("self_attn",), 2, device)

    def forward(self, src, pos, key_padding, generator=None):
        g = generator if self.training else None

        def sa(x):
            q = x + pos
            return self.self_attn(q, q, x, key_padding, g)

        src = self.residual(src, 1, sa, g)
        return self.residual(src, 2, lambda x: self.ffn(x, g), g)


class DecoderLayer(_Layer):
    def __init__(self, dim, num_heads=8, dim_ffn=2048, dropout=0.1, normalize_before=False, device=None):
        super().__init__(dim, num_heads, dim_ffn, dropout, normalize_before, ("self_attn", "cross_attn"), 3, device)

    def forward(self, tgt, memory, pos, query_pos, key_padding, generator=None):
        g = generator if self.training else None

        def sa(x):
            q = x + query_pos
            return self.self_attn(q, q, x, None, g)

        def ca(x):
            return self.cross_attn(x + query_pos, memory + pos, memory, key_padding, g)

        tgt = self.residual(tgt, 1, sa, g)
        tgt = self.residual(tgt, 2, ca, g)
        return self.residual(tgt, 3, lambda x: self.ffn(x, g), g)


class Transformer(nn.Module):
    """``encoder_<i>`` and ``decoder_<i>`` layers, ``encoder_norm`` (pre-norm
    only) and the shared ``decoder_norm`` applied to every decoder layer's
    output."""

    def __init__(self, dim=256, num_heads=8, num_encoder_layers=6, num_decoder_layers=6, dim_ffn=2048,
                 dropout=0.1, normalize_before=False, return_intermediate_dec=True, device=None):
        super().__init__()
        self.num_encoder_layers, self.num_decoder_layers = num_encoder_layers, num_decoder_layers
        self.normalize_before, self.return_intermediate_dec = normalize_before, return_intermediate_dec
        args = (dim, num_heads, dim_ffn, dropout, normalize_before)
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_{i}", EncoderLayer(*args, device=device))
        if normalize_before:
            self.encoder_norm = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_{i}", DecoderLayer(*args, device=device))
        self.decoder_norm = nn.LayerNorm(dim, eps=LN_EPS, device=device)

    def encode(self, src: torch.Tensor, key_padding: torch.Tensor, pos: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """src, pos (B, L, D); key_padding (B, L) True = padding → memory (B, L, D)."""
        x = src
        for i in range(self.num_encoder_layers):
            x = getattr(self, f"encoder_{i}")(x, pos, key_padding, generator)
        return self.encoder_norm(x) if self.normalize_before else x

    def decode(self, memory: torch.Tensor, key_padding: torch.Tensor, query_embed: torch.Tensor, pos: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The decoder over ``memory`` with queries ``query_embed`` (Q, D) → hs
        (layers, B, Q, D): the decoder_norm of each decoder layer's output, or
        of the last one only without ``return_intermediate_dec``."""
        B, Q, D = memory.shape[0], query_embed.shape[0], memory.shape[2]
        query_pos = query_embed[None].expand(B, Q, D)
        tgt = torch.zeros((B, Q, D), dtype=memory.dtype, device=memory.device)
        intermediate = []
        for i in range(self.num_decoder_layers):
            tgt = getattr(self, f"decoder_{i}")(tgt, memory, pos, query_pos, key_padding, generator)
            intermediate.append(self.decoder_norm(tgt))
        if self.return_intermediate_dec:
            return torch.stack(intermediate, dim=0)
        return intermediate[-1][None]

    def forward(self, src: torch.Tensor, key_padding: torch.Tensor, query_embed: torch.Tensor, pos: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """src, pos (B, L, D); key_padding (B, L) True = padding; query_embed
        (Q, D) → (hs (layers, B, Q, D), memory (B, L, D))."""
        memory = self.encode(src, key_padding, pos, generator)
        return self.decode(memory, key_padding, query_embed, pos, generator), memory
