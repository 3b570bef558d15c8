"""Weights drawn on the device from a seed, by HuggingFace's BERT names.

The harness makes the weights and hands the same tensors to the program
(`load_state_dict`) and to the reference, which reads them by these names.
One normal draw covers every parameter, in one call: matrices, biases and
LayerNorm shifts are normal(0, std), LayerNorm scales 1 + normal(0, std).
Biases and LayerNorm parameters away from 0 and 1 make the comparison see
every add and scale.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Layout = List[Tuple[str, Tuple[int, ...], bool]]  # name, shape, is a scale


def layer_layout(prefix: str, H: int, F: int) -> Layout:
    """One post-LN BERT layer (a BertLayer's names)."""
    out: Layout = []
    for m in ("query", "key", "value"):
        out += [(f"{prefix}attention.self.{m}.weight", (H, H), False),
                (f"{prefix}attention.self.{m}.bias", (H,), False)]
    out += [(f"{prefix}attention.output.dense.weight", (H, H), False),
            (f"{prefix}attention.output.dense.bias", (H,), False),
            (f"{prefix}attention.output.LayerNorm.weight", (H,), True),
            (f"{prefix}attention.output.LayerNorm.bias", (H,), False),
            (f"{prefix}intermediate.dense.weight", (F, H), False),
            (f"{prefix}intermediate.dense.bias", (F,), False),
            (f"{prefix}output.dense.weight", (H, F), False),
            (f"{prefix}output.dense.bias", (H,), False),
            (f"{prefix}output.LayerNorm.weight", (H,), True),
            (f"{prefix}output.LayerNorm.bias", (H,), False)]
    return out


def bert_layout(cfg: dict, prefix: str = "") -> Layout:
    """A BertModel without pooler (embeddings, encoder layers) from a
    configuration's HuggingFace keys."""
    H, F = cfg["hidden_size"], cfg["intermediate_size"]
    out: Layout = [
        (f"{prefix}embeddings.word_embeddings.weight",
         (cfg["vocab_size"], H), False),
        (f"{prefix}embeddings.position_embeddings.weight",
         (cfg["max_position_embeddings"], H), False),
        (f"{prefix}embeddings.token_type_embeddings.weight",
         (cfg["type_vocab_size"], H), False),
        (f"{prefix}embeddings.LayerNorm.weight", (H,), True),
        (f"{prefix}embeddings.LayerNorm.bias", (H,), False),
    ]
    for i in range(cfg["num_hidden_layers"]):
        out += layer_layout(f"{prefix}encoder.layer.{i}.", H, F)
    return out


def condenser_layout(cfg: dict, n_head_layers: int) -> Layout:
    """A coCondenser: the backbone (`bert.`), the MLM head (`cls.`) and the
    c_head's layers (`c_head.{i}.`)."""
    H, F = cfg["hidden_size"], cfg["intermediate_size"]
    out = bert_layout(cfg, "bert.")
    out += [("cls.predictions.transform.dense.weight", (H, H), False),
            ("cls.predictions.transform.dense.bias", (H,), False),
            ("cls.predictions.transform.LayerNorm.weight", (H,), True),
            ("cls.predictions.transform.LayerNorm.bias", (H,), False),
            ("cls.predictions.bias", (cfg["vocab_size"],), False)]
    for i in range(n_head_layers):
        out += layer_layout(f"c_head.{i}.", H, F)
    return out


def draw(layout: Layout, generator: torch.Generator, std: float,
         device) -> Dict[str, torch.Tensor]:
    """-> {name: float32 tensor on device}, views of one buffer drawn by
    one torch.randn call; the scales are laid out last, so one add makes
    them 1 + normal(0, std)."""
    order = ([e for e in layout if not e[2]] + [e for e in layout if e[2]])
    sizes = [math.prod(shape) for _, shape, _ in order]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    flat.mul_(std)
    n_plain = sum(s for (_, _, scale), s in zip(order, sizes) if not scale)
    flat[n_plain:].add_(1.0)
    out, o = {}, 0
    for (name, shape, _), size in zip(order, sizes):
        out[name] = flat[o:o + size].view(shape)
        o += size
    return {name: out[name] for name, _, _ in layout}

