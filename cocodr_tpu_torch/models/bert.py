"""BERT encoder in PyTorch: the counterpart of cocodr_tpu/models/bert.py.

Post-LayerNorm transformer with exact-erf GELU. Parameters are float32
(nn.Linear layout, HuggingFace BertModel names, so the state dict reads
like an HF checkpoint); compute runs in `BertConfig.dtype` (bf16 on the
card) with float32 LayerNorm statistics and float32 attention scores and
softmax statistics, as in the JAX package.

The half-layer after attention (LN1 -> FFN -> +residual -> LN2) is one
call of `ops.ffn.ffn_block`, the K1 kernel on the card, or of
`ops.ffn.ffn_block_int8` (K7, inference only) when `BertConfig.matmul_int8`
is set. A module that trains with hidden_dropout_prob > 0 takes the
semi-fused path instead, which keeps the reference's dropout placement:
LN1, then `ops.ffn.ffn` (K5 on the card; `ffn_impl="dense"` takes the bf16
nn.Linear pair), dropout, the residual add and LN2. With
`attention_impl="fused"` the attention of a sequence length divisible by 8
is one call of `ops.attention.attention` (K8) unless attention dropout
runs. K1, K5 and K8 take gradients: their backward recomputes the XLA
formulation, as the JAX package's custom VJPs do.

Dropout sits where the JAX package puts it: on the embeddings output, on
the unnormalised bf16 attention exponentials (after their sum is taken),
on the attention output and on the FFN output, each before its residual
add. Its masks come from the `torch.Generator` the caller hands to
`forward`; the port never draws from the global RNG.

`BertModel.forward(..., output_hidden_states=True)` also returns the
embeddings output and each layer's output, HuggingFace-style, for the
Condenser head; `BertMLMTransform` and `BertModel.mlm_logits_from_embed`
(the tied decoder) are the MLM head of models/condenser.py. A BertModel
built `with_pooler` (the DPR towers) also returns `BertPooler`'s tanh of a
dense layer on the CLS vector.

RoBERTa (`BertConfig.roberta_base` / `roberta_large`, position_style
'roberta') takes the JAX package's position ids: the running count of
non-pad tokens, offset past pad_token_id, on every slot. Records pad with
id 0, which RoBERTa's vocabulary reads as `<s>` and not as its pad id 1,
so padded slots of a record get positions past its length (at most
S + 1 = 513 of 514 at S = 512); they are masked out of attention, as in
the JAX package. Not carried over yet: remat (ROADMAP.md Queue 1 item 13).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from cocodr_tpu_torch.ops.attention import attention
from cocodr_tpu_torch.ops.ffn import (
    activation,
    ffn,
    ffn_block,
    ffn_block_int8,
    layer_norm_f32,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    # 'bert': positions 0..S-1; 'roberta': the running count of non-pad
    # tokens offset past pad_token_id (HF create_position_ids_from_input_ids)
    position_style: str = "bert"
    dtype: torch.dtype = torch.float32  # compute dtype
    # 'einsum' (default) or 'fused': K8 for sequence lengths divisible by 8
    # when no attention dropout runs
    attention_impl: str = "einsum"
    # FFN formulation: 'fused' (default) runs the half-layer as K1, or K5
    # on the dropout path; 'dense' runs the bf16 nn.Linear pair between
    # the two LayerNorms, with or without dropout
    ffn_impl: str = "fused"
    # W8A8 int8 FFN half-layers (K7), an inference mode; the FFN weights
    # stay float32 and are quantized per call, as in the JAX package
    matmul_int8: bool = False

    def __post_init__(self):
        if self.attention_impl not in ("einsum", "fused"):
            raise ValueError(
                f"attention_impl must be 'einsum' or 'fused', got "
                f"{self.attention_impl!r}"
            )
        if self.ffn_impl not in ("dense", "fused"):
            raise ValueError(
                f"ffn_impl must be 'dense' or 'fused', got {self.ffn_impl!r}"
            )
        if self.position_style not in ("bert", "roberta"):
            raise ValueError(
                f"position_style must be 'bert' or 'roberta', got "
                f"{self.position_style!r}"
            )

    @classmethod
    def base(cls, **kw) -> "BertConfig":
        return cls(**kw)

    @classmethod
    def roberta_base(cls, **kw) -> "BertConfig":
        return cls(**{**_ROBERTA, **kw})

    @classmethod
    def roberta_large(cls, **kw) -> "BertConfig":
        return cls.large(**{**_ROBERTA, **kw})

    @classmethod
    def large(cls, **kw) -> "BertConfig":
        return cls(**{**dict(hidden_size=1024, num_hidden_layers=24,
                             num_attention_heads=16, intermediate_size=4096),
                      **kw})

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        """For tests (the JAX package's tiny widths)."""
        base = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=64)
        return cls(**{**base, **kw})

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


# what RoBERTa changes in BertConfig's defaults (HF roberta-base)
_ROBERTA = dict(vocab_size=50265, max_position_embeddings=514,
                type_vocab_size=1, layer_norm_eps=1e-5, pad_token_id=1,
                position_style="roberta")


def position_ids_for(input_ids, cfg: BertConfig):
    """[B, S] ids -> position ids: [1, S] arange for 'bert'; for 'roberta'
    cumsum(ids != pad) * (ids != pad) + pad on every slot, as the JAX
    package computes them (padded slots of a record whose pad id is not
    pad_token_id count as tokens)."""
    if cfg.position_style == "roberta":
        not_pad = (input_ids != cfg.pad_token_id).to(torch.int64)
        return torch.cumsum(not_pad, 1) * not_pad + cfg.pad_token_id
    return torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]


def make_attention_bias(attention_mask, dtype=torch.float32):
    """[B, S] 0/1 mask -> additive [B, 1, 1, S] bias (0 keep, -1e9 drop)."""
    mask = attention_mask[:, None, None, :].to(dtype)
    return (1.0 - mask) * -1e9


class LayerNorm(nn.Module):
    """LayerNorm with float32 parameters and statistics; output in dtype."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x):
        return layer_norm_f32(x.float(), self.weight, self.bias,
                              self.eps).to(self.dtype)


def linear(x, layer: nn.Linear, dtype):
    """nn.Linear in the compute dtype (flax Dense with dtype=...)."""
    return F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))


def dropout(x, p: float, generator: torch.Generator):
    """flax.linen.Dropout's inverted dropout: each element kept with
    probability 1 - p (a uniform draw from `generator` below 1 - p), kept
    elements divided by 1 - p in x's dtype, the rest zero."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _dropout(module: nn.Module, x, p: float, generator):
    """Dropout of a module in training mode with p > 0; else x."""
    if not module.training or p == 0.0:
        return x
    if generator is None:
        raise ValueError(
            "a training forward with dropout needs generator=<a "
            "torch.Generator on the input's device>; the port never draws "
            "from the global RNG"
        )
    return dropout(x, p, generator)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, H)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, H)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, H)
        self.LayerNorm = LayerNorm(H, cfg.layer_norm_eps, cfg.dtype)

    def forward(self, input_ids, token_type_ids, position_ids,
                generator=None):
        """The token-type rows are taken by a one-hot product, the same
        values as a lookup: its backward is a GEMM, where the card's
        embedding backward sums the many lookups of one row (every token
        of a batch has type 0) in an order that changes from run to run."""
        dt = self.cfg.dtype
        w = self.token_type_embeddings.weight
        one_hot = F.one_hot(token_type_ids.long(), self.cfg.type_vocab_size)
        token_type = one_hot.to(w.dtype) @ w
        h = (self.word_embeddings(input_ids).to(dt)
             + self.position_embeddings(position_ids).to(dt)
             + token_type.to(dt))
        return _dropout(self, self.LayerNorm(h), self.cfg.hidden_dropout_prob,
                        generator)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.query = nn.Linear(H, H)
        self.key = nn.Linear(H, H)
        self.value = nn.Linear(H, H)

    def forward(self, h, attn_bias, generator=None):
        """K8 when attention_impl is 'fused', S % 8 == 0 and no attention
        dropout runs, as in the JAX package; otherwise einsum attention
        with float32 scores and a max held constant under
        differentiation, the softmax division applied to the context,
        (exp(s - max)·V) / Σexp, and dropout on the bf16 exponentials
        after their sum is taken, as in cocodr_tpu/models/bert.py."""
        cfg = self.cfg
        B, S, H = h.shape
        N, D = cfg.num_attention_heads, cfg.head_dim
        dt = cfg.dtype
        q = linear(h, self.query, dt).view(B, S, N, D)
        k = linear(h, self.key, dt).view(B, S, N, D)
        v = linear(h, self.value, dt).view(B, S, N, D)
        p = cfg.attention_probs_dropout_prob
        if (cfg.attention_impl == "fused" and S % 8 == 0
                and (not self.training or p == 0.0)):
            bias = attn_bias[:, 0, 0, :].contiguous()
            ctx = attention(q, k, v, bias, 1.0 / math.sqrt(D))
            return ctx.reshape(B, S, H)
        scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
        scores = scores * (1.0 / math.sqrt(D)) + attn_bias
        m = scores.amax(-1, keepdim=True).detach()
        unnorm = torch.exp(scores - m).to(dt)
        denom = unnorm.float().sum(-1)  # [B, N, S]
        unnorm = _dropout(self, unnorm, p, generator)
        ctx = torch.einsum("bnqk,bknd->bqnd", unnorm, v)
        ctx = (ctx.float() / denom.transpose(1, 2)[..., None]).to(dt)
        return ctx.reshape(B, S, H)


class BertSelfOutput(nn.Module):
    """Attention output projection; its LayerNorm is LN1 of the half-layer."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                   cfg.dtype)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)


class BertOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                   cfg.dtype)


class BertLayer(nn.Module):
    """One post-LN block: attention, then the half-layer: K1 (or K7), or
    in training with hidden dropout the semi-fused path."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, h, attn_bias, generator=None):
        cfg = self.cfg
        dt = cfg.dtype
        p = cfg.hidden_dropout_prob
        ctx = self.attention.self(h, attn_bias, generator)
        r = h + _dropout(self, linear(ctx, self.attention.output.dense, dt),
                         p, generator)
        B, S, H = r.shape
        ln1, ln2 = self.attention.output.LayerNorm, self.output.LayerNorm
        up, down = self.intermediate.dense, self.output.dense
        hidden_dropout = self.training and p > 0
        if cfg.matmul_int8:
            if hidden_dropout:
                raise ValueError(
                    "matmul_int8 is an inference mode (no int8 backward, no "
                    "dropout inside the fused block); call .eval() or zero "
                    "hidden_dropout_prob"
                )
            out = ffn_block_int8(
                r.reshape(B * S, H), ln1.weight, ln1.bias,
                up.weight, up.bias, down.weight, down.bias,
                ln2.weight, ln2.bias, cfg.hidden_act, cfg.layer_norm_eps,
            )
            return out.view(B, S, H)
        if cfg.ffn_impl == "fused" and not hidden_dropout:
            out = ffn_block(
                r.reshape(B * S, H), ln1.weight, ln1.bias,
                up.weight.to(dt), up.bias.to(dt),
                down.weight.to(dt), down.bias.to(dt),
                ln2.weight, ln2.bias, cfg.hidden_act, cfg.layer_norm_eps,
            )
            return out.view(B, S, H)
        # the semi-fused path: dropout between the FFN and the residual add
        x = ln1(r)
        if cfg.ffn_impl == "fused":
            y = ffn(x.reshape(B * S, H), up.weight.to(dt), up.bias.to(dt),
                    down.weight.to(dt), down.bias.to(dt),
                    cfg.hidden_act).view(B, S, H)
        else:
            y = linear(activation(cfg.hidden_act)(linear(x, up, dt)), down,
                       dt)
        return ln2(x + _dropout(self, y, p, generator))


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(
            BertLayer(cfg) for _ in range(cfg.num_hidden_layers)
        )

    def forward(self, h, attn_bias, generator=None,
                output_hidden_states: bool = False):
        """-> the last layer's output, or with output_hidden_states
        (last, (h, layer 1's output, ..., layer L's output))."""
        hidden_states = [h]
        for layer in self.layer:
            h = layer(h, attn_bias, generator)
            if output_hidden_states:
                hidden_states.append(h)
        if output_hidden_states:
            return h, tuple(hidden_states)
        return h


class BertPooler(nn.Module):
    """HuggingFace's pooler: tanh(dense(CLS)), the dense in the compute
    dtype (the JAX package's BertPooler)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, h):
        return torch.tanh(linear(h[:, 0], self.dense, self.cfg.dtype))


class BertModel(nn.Module):
    """Backbone: token ids -> last hidden state [B, S, H] in cfg.dtype;
    with_pooler adds `pooler` and its output to what forward returns."""

    def __init__(self, cfg: BertConfig, with_pooler: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)
        self.pooler = BertPooler(cfg) if with_pooler else None

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                generator=None, output_hidden_states: bool = False):
        """generator: the torch.Generator (on the inputs' device) that
        dropout draws from in training mode; unused in eval mode.
        output_hidden_states: return (last, hidden_states), hidden_states
        the tuple of the embeddings output and each layer's output, so that
        hidden_states[i] is layer i's output (HuggingFace's order). A model
        with a pooler appends the pooled [B, H] vector: (last, pooled) or
        (last, hidden_states, pooled)."""
        B, S = input_ids.shape
        if S > self.cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {S} exceeds max_position_embeddings "
                f"{self.cfg.max_position_embeddings}"
            )
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones((B, S), dtype=torch.int32, device=dev)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        h = self.embeddings(input_ids, token_type_ids,
                            position_ids_for(input_ids, self.cfg), generator)
        out = self.encoder(h, make_attention_bias(attention_mask), generator,
                           output_hidden_states)
        if self.pooler is None:
            return out
        last = out[0] if output_hidden_states else out
        pooled = self.pooler(last)
        return (*out, pooled) if output_hidden_states else (last, pooled)

    def mlm_logits_from_embed(self, transformed):
        """The tied decoder: transformed [..., H] @ word_embeddings.T. As
        flax's nn.Embed.attend, both operands are cast to the compute dtype
        and the product comes out in it (bf16 logits from a bf16
        product on the card)."""
        dt = self.cfg.dtype
        return F.linear(transformed.to(dt),
                        self.embeddings.word_embeddings.weight.to(dt))


class BertMLMTransform(nn.Module):
    """HuggingFace's `cls.predictions.transform`: dense in the compute
    dtype, the activation, then the float32-statistics LayerNorm."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                   cfg.dtype)

    def forward(self, h):
        h = linear(h, self.dense, self.cfg.dtype)
        return self.LayerNorm(activation(self.cfg.hidden_act)(h))


def cast_matmul_weights(module: nn.Module, dtype: torch.dtype) -> None:
    """Hold every Linear and Embedding parameter in the compute dtype, in
    place. The forward casts them to that dtype on every call anyway, so
    the results are unchanged; a server saves the casts (about a dozen
    launches and ~40 MB of traffic per bert-base layer and batch).
    LayerNorm parameters stay float32, as the kernels take them, and so do
    the FFN weights of a matmul_int8 layer: K7 quantizes them from float32,
    as the JAX package does, and bf16-rounded weights would give other int8
    values and scales."""
    keep = set()
    for m in module.modules():
        if isinstance(m, BertLayer) and m.cfg.matmul_int8:
            keep.update((m.intermediate.dense, m.output.dense))
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)) and m not in keep:
            m.to(dtype)


def init_weights(module: nn.Module, std: float, generator: torch.Generator):
    """BERT's initialisation, as the flax modules draw it: every Linear and
    Embedding weight normal(0, std), biases zero, LayerNorm scale one."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
            if isinstance(m, nn.Linear):
                m.bias.zero_()
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
