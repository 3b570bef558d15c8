"""The attention dispatch of models/bert.py under attention_impl="auto"
(the default): K8 for a forward under torch.inference_mode that runs no
attention dropout and whose q is on the card in a shape K8 takes, the
einsum chain otherwise (a torch.no_grad forward too). The card check is `models.bert.on_card`; forced
to true here, the K8 path runs K8's plain version on the CPU, so the
dispatch counter `BertSelfAttention.forwards` shows the path taken."""
import contextlib
import dataclasses
import itertools

import pytest
import torch

from cocodr_tpu_torch.models import bert as tbert
from cocodr_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
    BertSelfAttention,
)
from cocodr_tpu_torch.models.condenser import CoCondenserForPretraining
from cocodr_tpu_torch.ops import attention as tatt
from cocodr_tpu_torch.pipelines.coco import CocoConfig, build_coco_train_step
from cocodr_tpu_torch.utils.train_state import TrainState

torch.set_num_threads(1)

CASES = list(itertools.product(
    ("train", "eval"), ("grad", "no_grad", "inference"), (0.0, 0.1),
    (128, 132, 520),
    (64, 8), ("card", "cpu")))


def _config(head_dim, p=0.0, S=16, **kw):
    N = 64 // head_dim
    return BertConfig.tiny(hidden_size=64, num_attention_heads=N,
                           intermediate_size=64, num_hidden_layers=1,
                           max_position_embeddings=max(S, 64),
                           attention_probs_dropout_prob=p,
                           hidden_dropout_prob=0.0, dtype=torch.bfloat16,
                           **kw)


def _inputs(S, B=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(5, 128, (B, S), generator=g)
    mask = torch.ones(B, S, dtype=torch.int64)
    mask[1, S // 2:] = 0
    return ids, mask


def _paths(model, *args, **kw):
    """-> (the forward's output, {path: forwards it counted})."""
    before = dict(BertSelfAttention.forwards)
    out = model(*args, **kw)
    return out, {k: BertSelfAttention.forwards[k] - before[k]
                 for k in before}


@pytest.mark.parametrize("mode,grad,p,S,head_dim,device", CASES)
def test_auto_dispatch_takes_k8_only_where_the_rule_holds(
        monkeypatch, mode, grad, p, S, head_dim, device):
    """One layer, one forward: the counter records one forward, on K8 only
    under inference_mode (torch.no_grad is not enough), without attention
    dropout (eval mode, or p 0), on the card, at S % 8 == 0, S <= 512 and
    head dim 64; the CPU's wrapper launches nothing either way."""
    if device == "card":
        monkeypatch.setattr(tbert, "on_card", lambda t: True)
    torch.manual_seed(0)
    model = BertModel(_config(head_dim, p, S)).train(mode == "train")
    ids, mask = _inputs(S)
    launches = tatt.fused_attention_seq_major.launches
    ctx = {"grad": contextlib.nullcontext, "no_grad": torch.no_grad,
           "inference": torch.inference_mode}[grad]
    with ctx():
        _, counted = _paths(model, ids, mask,
                            generator=torch.Generator().manual_seed(1))
    k8 = (grad == "inference" and (mode == "eval" or p == 0.0)
          and device == "card" and S % 8 == 0 and S <= 512
          and head_dim == 64)
    assert counted == {"k8": int(k8), "einsum": int(not k8)}
    assert tatt.fused_attention_seq_major.launches == launches


@pytest.mark.parametrize("forced", [True, False])
def test_auto_under_inference_mode_equals_fused_on_card_einsum_off(
        monkeypatch, forced):
    """Two layers, head dim 64, a padded row: "auto" gives exactly the
    tensors of "fused" when the card check is forced, of "einsum" when it
    is left as the CPU (the formulations differ in bf16, so the equal one
    names the path)."""
    if forced:
        monkeypatch.setattr(tbert, "on_card", lambda t: True)
    cfg = dataclasses.replace(_config(64), num_hidden_layers=2)
    torch.manual_seed(0)
    models = {impl: BertModel(dataclasses.replace(cfg, attention_impl=impl))
              .eval() for impl in ("auto", "fused", "einsum")}
    for m in models.values():
        m.load_state_dict(models["auto"].state_dict())
    ids, mask = _inputs(24)
    with torch.inference_mode():
        out = {impl: m(ids, mask) for impl, m in models.items()}
    assert not torch.equal(out["fused"], out["einsum"])
    same = "fused" if forced else "einsum"
    assert torch.equal(out["auto"], out[same])


@pytest.mark.parametrize("case", ["float32", "bias_rows", "training_grad"])
def test_auto_keeps_einsum_where_k8_would_refuse(monkeypatch, case):
    """With the card check forced, "auto" still takes the einsum chain for
    a float32 compute dtype (K8 takes bf16), a bias that is not one row a
    batch element ([B, 1, S, S]), and a forward that records gradients,
    and its output is the "einsum" model's bit for bit."""
    monkeypatch.setattr(tbert, "on_card", lambda t: True)
    cfg = _config(64)
    if case == "float32":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    torch.manual_seed(0)
    layer = tbert.BertLayer(cfg).eval()
    ref = tbert.BertLayer(dataclasses.replace(cfg, attention_impl="einsum"))
    ref.load_state_dict(layer.state_dict())
    ref.eval()
    g = torch.Generator().manual_seed(2)
    h = torch.randn(2, 16, 64, generator=g).to(cfg.dtype)
    _, mask = _inputs(16)
    bias = tbert.make_attention_bias(mask)
    if case == "bias_rows":
        bias = bias.expand(2, 1, 16, 16).contiguous()
    ctx = (contextlib.nullcontext() if case == "training_grad"
           else torch.inference_mode())
    with ctx:
        got, counted = _paths(layer, h, bias)
        want = ref(h, bias)
    assert counted == {"k8": 0, "einsum": 1}
    assert torch.equal(got, want)


@pytest.mark.parametrize("chunk", [0, 2])
def test_coco_step_passes_take_one_path(monkeypatch, chunk):
    """COCO's step with dropout off (eval mode), the card check forced, in
    bf16 at head dim 64 and S 8, where an inference_mode forward takes K8:
    the grad cache's pass 1 (torch.no_grad) takes the einsum chain as its
    pass 2 and the direct step do, so that the cotangents of pass 1's CLS
    are those of the representations pass 2 backpropagates through."""
    monkeypatch.setattr(tbert, "on_card", lambda t: True)
    taken = []
    takes_k8 = BertSelfAttention.takes_k8

    def recorded(self, q, attn_bias):
        out = takes_k8(self, q, attn_bias)
        taken.append((torch.is_grad_enabled(), out))
        return out

    monkeypatch.setattr(BertSelfAttention, "takes_k8", recorded)
    cfg = dataclasses.replace(_config(64, S=8), num_hidden_layers=2)
    torch.manual_seed(0)
    model = CoCondenserForPretraining(cfg, n_head_layers=1, skip_from=1)
    ids, mask = _inputs(8, B=4)
    labels = torch.full_like(ids, -100)
    labels[:, 2] = ids[:, 2]
    with torch.inference_mode():
        model.eval().cls_emb(ids, mask)
    assert taken == [(False, True)] * 2
    taken.clear()
    step = build_coco_train_step(CocoConfig(cache_chunk_size=chunk,
                                            max_grad_norm=0))
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
    m = step(state, {"input_ids": ids, "attention_mask": mask,
                     "labels": labels})
    assert torch.isfinite(m["loss"])
    assert not model.training
    passes = {grad for grad, _ in taken}
    assert passes == ({False, True} if chunk else {True})
    assert {k8 for _, k8 in taken} == {False}
