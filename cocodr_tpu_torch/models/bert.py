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
nn.Linear pair), dropout, the residual add and LN2.

The attention core is one call of `ops.attention.attention` (K8) or the
einsum chain (`BertSelfAttention.core`: float32 scores, the softmax
division after the PV product). `BertConfig.attention_impl` picks it:
  'auto'    (default) K8 under torch.inference_mode (encode, serving,
            eval, mining: `Encoder` and `RetrievalService` enter it) when
            no attention dropout runs, q is on the card and K8 takes the
            shape (bf16, head dim 64, S % 8 == 0, S <= 512, a [B, 1, 1, S]
            float32 bias); the einsum chain otherwise: every training
            forward (COCO's grad-cache pass 1 too: it runs under
            torch.no_grad, and its CLS must be pass 2's), every CPU
            forward, every shape K8 refuses. K8 exists only on the card,
            its CPU version is a plain reference with no speed to gain,
            so the CPU keeps the einsum chain, the JAX package's default
            formulation that the CPU tests hold it to;
  'einsum'  the einsum chain always;
  'fused'   K8 for S % 8 == 0 unless attention dropout runs, with or
            without gradients, as the JAX package's 'pallas'.
`BertSelfAttention.forwards` counts the forwards by the path taken. K1, K5
and K8 take gradients: their backward recomputes the XLA formulation, as
the JAX package's custom VJPs do.

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
the JAX package.

Remat (`BertConfig.remat`, with the JAX package's `remat_policy` names)
trades memory for a second forward in the backward, and never changes a
value: the recompute draws dropout from a fresh generator set to the
state the caller's generator had before the forward (`checkpointed`), so
it draws the forward's masks while the caller's generator goes on past the
later layers and towers as it does without remat.
  ''                 each encoder layer under torch.utils.checkpoint: the
                     forward keeps the layer's input, the backward runs the
                     layer again;
  'dots_saveable'    the same, but the outputs of the matrix products
                     (aten mm, addmm, bmm, baddbmm) are kept and the
                     elementwise tail is recomputed (a selective-checkpoint
                     policy). The kernels K1, K5 and K8 run through ctypes,
                     outside the dispatcher that the policy sees, so their
                     outputs are recomputed: their forward launches again;
  'no_save:attn_scores,attn_probs'
                     the layers run as without remat except the attention
                     core of the einsum path (the float32 scores, their
                     exponentials, the dropout on them and the PV product),
                     which keeps only q, k and v and is recomputed in the
                     backward: no [B, N, S, S] tensor is kept. K8's path
                     keeps none anyway and is left alone.
Under '' and 'dots_saveable' every kernel a layer's forward launches
launches once more in the backward (K5 36 -> 72 a bert-base warmup step
with dropout). The Condenser's c_head layers run without remat, as in the
JAX package, whose remat wraps the encoder's scan only; an encoder whose
`no_remat_last` is k runs its last k layers without it (the iDRO step's
group pass, pipelines/train_step.py).

Tensor parallelism (parallel/tp.py::shard_params_tp gives a BertLayer and
its BertSelfAttention the model axis, `tp`, and cuts their weights): the
layer computes its N/M heads (K8 or the einsum core on them) from f(h),
the attention output's partial product leaves through g, in float32, and
its bias is added once after the sum; the half-layer runs the split K1
(`ops.ffn.ffn_block_tp`), the dropout path the split K5 (`ops.ffn.ffn_tp`)
or the dense pair between f and g. Dropout masks are those of the unsplit
layer: the replicated regions draw the whole mask on every model rank
(the ranks of a data index share their generators), and the attention
probabilities' mask is drawn for all N heads and sliced to the rank's, so
that a split step equals the unsplit one with dropout on. Remat replays
the layer, its collectives and its masks alike.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from cocodr_tpu_torch.ops.attention import attention, kernel_takes
from cocodr_tpu_torch.ops.ffn import (
    activation,
    ffn,
    ffn_block,
    ffn_block_int8,
    ffn_block_tp,
    ffn_tp,
    layer_norm_f32,
)
from cocodr_tpu_torch.parallel.tp import copy_to_model, reduce_from_model

REMAT_POLICIES = ("", "dots_saveable", "no_save:attn_scores,attn_probs")
NO_SAVE_SCORES = REMAT_POLICIES[2]


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
    # recompute in the backward instead of keeping activations (the module
    # docstring): remat_policy '' (each layer), 'dots_saveable' (each
    # layer, the matrix products kept) or 'no_save:attn_scores,attn_probs'
    # (the einsum attention core only)
    remat: bool = False
    remat_policy: str = ""
    # 'auto' (default): K8 for a forward under torch.inference_mode that
    # runs no attention dropout and whose q is on the card in a shape K8
    # takes, the einsum chain otherwise (every CPU and every training
    # forward, torch.no_grad ones included);
    # 'einsum': always the einsum chain; 'fused': K8 for sequence lengths
    # divisible by 8 when no attention dropout runs (the module docstring)
    attention_impl: str = "auto"
    # FFN formulation: 'fused' (default) runs the half-layer as K1, or K5
    # on the dropout path; 'dense' runs the bf16 nn.Linear pair between
    # the two LayerNorms, with or without dropout
    ffn_impl: str = "fused"
    # W8A8 int8 FFN half-layers (K7), an inference mode; the FFN weights
    # stay float32 and are quantized per call, as in the JAX package
    matmul_int8: bool = False

    def __post_init__(self):
        if self.attention_impl not in ("auto", "einsum", "fused"):
            raise ValueError(
                f"attention_impl must be 'auto', 'einsum' or 'fused', got "
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
        if self.remat and self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; valid names "
                f"are {', '.join(repr(p) for p in REMAT_POLICIES)}"
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


# the products 'dots_saveable' keeps, as aten ops reach the dispatcher
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def recompute_generator(generator: torch.Generator, state) -> torch.Generator:
    """The generator a recompute draws dropout from: a fresh one on
    generator's device, set to `state`, the caller's state before the
    forward. The caller's own generator is never rewound."""
    g = torch.Generator(device=generator.device)
    g.set_state(state)
    return g


def checkpointed(fn, generator, *args, context_fn=None):
    """fn(*args, generator) under torch.utils.checkpoint (non-reentrant):
    the forward keeps args, the backward runs fn again, drawing from
    recompute_generator(generator, its state before the forward).
    context_fn: a selective-checkpoint context (None: recompute all)."""
    state = None if generator is None else generator.get_state()
    runs = []

    def run(*a):
        gen = generator
        if runs and generator is not None:
            gen = recompute_generator(generator, state)
        runs.append(None)
        return fn(*a, gen)

    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


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


def dropout(x, p: float, generator: torch.Generator, heads=None):
    """flax.linen.Dropout's inverted dropout: each element kept with
    probability 1 - p (a uniform draw from `generator` below 1 - p), kept
    elements divided by 1 - p in x's dtype, the rest zero. heads (N, lo):
    x [B, n, ...] holds heads lo .. lo + n - 1 of N; the mask is drawn for
    all N heads and sliced, the unsplit mask's rows of those heads."""
    shape = x.shape if heads is None else (x.shape[0], heads[0],
                                           *x.shape[2:])
    keep = torch.rand(shape, generator=generator, device=x.device) < 1 - p
    if heads is not None:
        keep = keep[:, heads[1]:heads[1] + x.shape[1]]
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _dropout(module: nn.Module, x, p: float, generator, heads=None):
    """Dropout of a module in training mode with p > 0; else x."""
    if not module.training or p == 0.0:
        return x
    if generator is None:
        raise ValueError(
            "a training forward with dropout needs generator=<a "
            "torch.Generator on the input's device>; the port never draws "
            "from the global RNG"
        )
    if heads is None:
        return dropout(x, p, generator)
    return dropout(x, p, generator, heads)


def _split_linear(x, layer: nn.Linear, dtype, axis):
    """A Linear whose input dimension is split over the model axis: the
    rank's partial product, summed over the axis by g in float32, the
    bias added once, rounded to dtype (`linear` without an axis)."""
    if axis is None:
        return linear(x, layer, dtype)
    y = reduce_from_model(F.linear(x, layer.weight.to(dtype)).float(), axis)
    return (y + layer.bias.float()).to(dtype)


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


def on_card(t: torch.Tensor) -> bool:
    """Whether t is on the card, the only device K8 exists on."""
    return t.is_cuda


class BertSelfAttention(nn.Module):
    # attention forwards by the path the dispatch took, on every device
    # (K8's own launches: ops.attention.fused_attention_seq_major.launches)
    forwards = {"k8": 0, "einsum": 0}

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.query = nn.Linear(H, H)
        self.key = nn.Linear(H, H)
        self.value = nn.Linear(H, H)
        self.tp = None  # the model axis (parallel/tp.py) when split

    def takes_k8(self, q, attn_bias) -> bool:
        """The dispatch rule of attention_impl (the module docstring)."""
        impl = self.cfg.attention_impl
        if impl == "einsum" or (self.training and
                                self.cfg.attention_probs_dropout_prob > 0):
            return False
        if impl == "fused":
            return q.shape[1] % 8 == 0
        B, S = q.shape[:2]
        return (torch.is_inference_mode_enabled() and on_card(q)
                and kernel_takes(q)
                and attn_bias.dtype == torch.float32
                and tuple(attn_bias.shape) == (B, 1, 1, S))

    def forward(self, h, attn_bias, generator=None,
                recompute_scores: bool = False):
        """K8 or einsum attention (`core`) by `takes_k8`.
        recompute_scores: the einsum core runs under `checkpointed` (the
        'no_save:attn_scores,attn_probs' policy). Split (self.tp): this
        rank's N/M heads -> [B, S, H/M]."""
        cfg = self.cfg
        B, S, _ = h.shape
        D = cfg.head_dim
        N = self.query.weight.shape[0] // D  # N/M heads when split
        dt = cfg.dtype
        h = copy_to_model(h, self.tp)
        q = linear(h, self.query, dt).view(B, S, N, D)
        k = linear(h, self.key, dt).view(B, S, N, D)
        v = linear(h, self.value, dt).view(B, S, N, D)
        if self.takes_k8(q, attn_bias):
            BertSelfAttention.forwards["k8"] += 1
            bias = attn_bias[:, 0, 0, :].contiguous()
            ctx = attention(q, k, v, bias, 1.0 / math.sqrt(D))
            return ctx.reshape(B, S, N * D)
        BertSelfAttention.forwards["einsum"] += 1
        if recompute_scores:
            ctx = checkpointed(self.core, generator, q, k, v, attn_bias)
        else:
            ctx = self.core(q, k, v, attn_bias, generator)
        return ctx.reshape(B, S, N * D)

    def core(self, q, k, v, attn_bias, generator):
        """q, k, v [B, S, N, D] -> the context [B, S, N, D]: float32
        scores and a max held constant under differentiation, the softmax
        division applied to the context, (exp(s - max)·V) / Σexp, and
        dropout on the bf16 exponentials after their sum is taken, as in
        cocodr_tpu/models/bert.py."""
        dt = self.cfg.dtype
        scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
        scores = scores * (1.0 / math.sqrt(q.shape[-1])) + attn_bias
        m = scores.amax(-1, keepdim=True).detach()
        unnorm = torch.exp(scores - m).to(dt)
        denom = unnorm.float().sum(-1)  # [B, N, S]
        heads = (None if self.tp is None else
                 (self.cfg.num_attention_heads, self.tp.rank * q.shape[2]))
        unnorm = _dropout(self, unnorm, self.cfg.attention_probs_dropout_prob,
                          generator, heads)
        ctx = torch.einsum("bnqk,bknd->bqnd", unnorm, v)
        return (ctx.float() / denom.transpose(1, 2)[..., None]).to(dt)


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
    in training with hidden dropout the semi-fused path. Split over a
    model axis (self.tp), the split forms (the module docstring)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)
        self.tp = None  # the model axis (parallel/tp.py) when split

    def forward(self, h, attn_bias, generator=None,
                recompute_scores: bool = False):
        cfg = self.cfg
        dt = cfg.dtype
        p = cfg.hidden_dropout_prob
        ctx = self.attention.self(h, attn_bias, generator, recompute_scores)
        r = h + _dropout(self, _split_linear(ctx, self.attention.output.dense,
                                             dt, self.tp), p, generator)
        B, S, H = r.shape
        ln1, ln2 = self.attention.output.LayerNorm, self.output.LayerNorm
        up, down = self.intermediate.dense, self.output.dense
        hidden_dropout = self.training and p > 0
        if self.tp is not None:
            return self._split_half_layer(r, hidden_dropout, generator)
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

    def _split_half_layer(self, r, hidden_dropout: bool, generator):
        """The half-layer on this rank's F/M: the split K1, or the split
        K5 / the dense pair between f and g, then dropout, the residual
        and LN2 on the replicated sum."""
        cfg, axis = self.cfg, self.tp
        dt, p = cfg.dtype, cfg.hidden_dropout_prob
        B, S, H = r.shape
        ln1, ln2 = self.attention.output.LayerNorm, self.output.LayerNorm
        up, down = self.intermediate.dense, self.output.dense
        if cfg.matmul_int8:
            raise ValueError(
                "matmul_int8 is an inference mode; a split layer trains "
                "(inference runs from parallel/tp.py::unsplit_copy)")
        if cfg.ffn_impl == "fused" and not hidden_dropout:
            out = ffn_block_tp(
                r.reshape(B * S, H), ln1.weight, ln1.bias,
                up.weight.to(dt), up.bias.to(dt),
                down.weight.to(dt), down.bias.to(dt),
                ln2.weight, ln2.bias, cfg.hidden_act, cfg.layer_norm_eps,
                axis)
            return out.view(B, S, H)
        x = ln1(r)
        if cfg.ffn_impl == "fused":
            y = ffn_tp(x.reshape(B * S, H), up.weight.to(dt), up.bias.to(dt),
                       down.weight.to(dt), down.bias.to(dt), cfg.hidden_act,
                       axis).view(B, S, H)
        else:
            hid = activation(cfg.hidden_act)(
                linear(copy_to_model(x, axis), up, dt))
            y = _split_linear(hid, down, dt, axis)
        return ln2(x + _dropout(self, y, p, generator))


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.layer = nn.ModuleList(
            BertLayer(cfg) for _ in range(cfg.num_hidden_layers)
        )
        # the last layers that run without remat (set by the iDRO step)
        self.no_remat_last = 0

    def forward(self, h, attn_bias, generator=None,
                output_hidden_states: bool = False):
        """-> the last layer's output, or with output_hidden_states
        (last, (h, layer 1's output, ..., layer L's output)). With
        cfg.remat and gradients on, each layer but the last no_remat_last
        runs under the remat policy (the module docstring)."""
        cfg = self.cfg
        n_remat = (len(self.layer) - self.no_remat_last
                   if cfg.remat and torch.is_grad_enabled() else 0)
        context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                        _dots_saveable)
                      if cfg.remat_policy == "dots_saveable" else None)
        hidden_states = [h]
        for i, layer in enumerate(self.layer):
            if i >= n_remat:
                h = layer(h, attn_bias, generator)
            elif cfg.remat_policy == NO_SAVE_SCORES:
                h = layer(h, attn_bias, generator, recompute_scores=True)
            else:
                h = checkpointed(layer, generator, h, attn_bias,
                                 context_fn=context_fn)
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
