"""models/hf.py, the port's own HuggingFace mapping, against the JAX
package's cocodr_tpu/models/hf.py: configs from a config.json dict, the
reference's checkpoints (a RoBERTa backbone with the rdot_nll head, a BERT
backbone with its pooler, the DPR BiEncoder) loaded into both packages and
run on the same inputs (2e-5, float32 on the CPU), state dicts round-tripped
both ways, and the .bin / .safetensors readers."""
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu.models import hf as jhf
from cocodr_tpu_torch.models import hf
from cocodr_tpu_torch.models.dual_encoder import MODEL_REGISTRY, DualEncoder

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)

FWD = dict(rtol=2e-5, atol=2e-5)
TINY = dict(vocab_size=101, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=40, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


def hf_backbone(kind, seed=0, pooler=False):
    torch.manual_seed(seed)
    if kind == "roberta":
        cfg = transformers.RobertaConfig(**TINY, type_vocab_size=1,
                                         pad_token_id=1, layer_norm_eps=1e-5)
        return transformers.RobertaModel(cfg, add_pooling_layer=pooler)
    return transformers.BertModel(transformers.BertConfig(**TINY),
                                  add_pooling_layer=pooler)


def inputs(seed=3, S=10):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, 101, size=(3, S)).astype(np.int32)
    mask = (np.arange(S)[None, :] < np.array([[S], [6], [9]])).astype(np.int32)
    return ids * mask, mask


def both_models(model_type, sd, hf_cfg, use_head=False):
    """(JAX model and params from the JAX mapping, the port's model from
    the port's mapping), both from the checkpoint sd."""
    jcfg = jhf.config_from_hf(hf_cfg)
    cfg = MODEL_REGISTRY[model_type](hf.config_from_hf(hf_cfg),
                                     head_dim=32)
    model = DualEncoder(cfg).eval()
    model.load_state_dict(hf.state_dict_from_hf(sd, cfg))
    params = jhf.dual_encoder_params_from_torch(sd, jcfg, use_head=use_head)
    return jax_build(model_type, jcfg, head_dim=32), params, model, cfg


def assert_towers_match(jmodel, params, model):
    ids, mask = inputs()
    for tower in ("query_emb", "body_emb"):
        want = jmodel.apply({"params": params}, jnp.asarray(ids),
                            jnp.asarray(mask), method=getattr(jmodel, tower))
        with torch.no_grad():
            got = getattr(model, tower)(torch.from_numpy(ids).long(),
                                        torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("kind", ["bert", "roberta"])
def test_config_from_a_config_json_dict(kind):
    """A config.json dict (no transformers object) gives the JAX
    package's BertConfig field for field."""
    d = hf_backbone(kind).config.to_dict()
    got, want = hf.config_from_hf(d), jhf.config_from_hf(d)
    for f in ("vocab_size", "hidden_size", "num_hidden_layers",
              "num_attention_heads", "intermediate_size", "hidden_act",
              "hidden_dropout_prob", "attention_probs_dropout_prob",
              "max_position_embeddings", "type_vocab_size",
              "layer_norm_eps", "pad_token_id", "position_style"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.position_style == kind


def test_robertadot_checkpoint_loads_into_both_packages():
    """A RobertaDot_NLL_LN checkpoint (`roberta.` backbone, embeddingHead
    and norm) as an rdot_nll model: the port's embeddings equal flax's on
    the JAX package's mapping of the same checkpoint."""
    rob = hf_backbone("roberta")
    torch.manual_seed(2)
    sd = {f"roberta.{k}": v for k, v in rob.state_dict().items()}
    sd.update({f"embeddingHead.{k}": v for k, v in
               torch.nn.Linear(32, 32).state_dict().items()})
    sd.update({f"norm.{k}": v for k, v in
               torch.nn.LayerNorm(32).state_dict().items()})
    jmodel, params, model, cfg = both_models("rdot_nll", sd, rob.config,
                                             use_head=True)
    assert cfg.bert.position_style == "roberta"
    assert_towers_match(jmodel, params, model)


def test_bert_checkpoint_with_a_pooler_loads_with_and_without_it():
    """A BERT checkpoint with its pooler: a 'dpr'-pooled tower needs it, a
    CLS model drops it (and HF's buffers) and loads strictly."""
    bert = hf_backbone("bert", pooler=True)
    cfg = MODEL_REGISTRY["rdot_nll_condenser"](hf.config_from_hf(bert.config))
    got = hf.state_dict_from_hf(bert.state_dict(), cfg)
    assert not any("pooler" in k or "position_ids" in k for k in got)
    DualEncoder(cfg).load_state_dict(got)
    jmodel, params, model, _ = both_models(
        "rdot_nll_condenser", {f"bert.{k}": v for k, v in
                               bert.state_dict().items()}, bert.config)
    assert_towers_match(jmodel, params, model)


def dpr_checkpoint():
    q, c = hf_backbone("bert", 0, True), hf_backbone("bert", 1, True)
    sd = {f"question_model.{k}": v for k, v in q.state_dict().items()}
    sd.update({f"ctx_model.{k}": v for k, v in c.state_dict().items()})
    return sd, q.config


def test_dpr_biencoder_checkpoint_loads_into_both_packages():
    """question_model.* / ctx_model.* (each with its pooler) -> encoder /
    doc_encoder: both towers equal flax's."""
    sd, hcfg = dpr_checkpoint()
    jmodel, params, model, _ = both_models("dpr", sd, hcfg)
    assert "doc_encoder.pooler.dense.weight" in model.state_dict()
    assert_towers_match(jmodel, params, model)


@pytest.mark.parametrize("model_type", ["rdot_nll", "dpr"])
def test_state_dicts_round_trip(model_type):
    """port -> reference naming -> port is the identity, tensor for
    tensor, and the JAX package reads the port's export into the same
    model: the towers agree (2e-5)."""
    bert = hf.config_from_hf(hf_backbone("roberta").config.to_dict())
    cfg = MODEL_REGISTRY[model_type](bert, head_dim=32)
    model = DualEncoder(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(
                p.numel()))
    out = hf.state_dict_to_hf(model.state_dict(), cfg)
    prefixes = ({"question_model.", "ctx_model."} if cfg.two_tower
                else {"roberta.", "embeddingHead.", "norm."})
    assert {k.split(".")[0] + "." for k in out} == prefixes
    back = hf.state_dict_from_hf(out, cfg)
    assert set(back) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    jcfg = jhf.config_from_hf(hf_backbone("roberta").config)
    params = jhf.dual_encoder_params_from_torch(out, jcfg,
                                                use_head=cfg.use_head)
    assert_towers_match(jax_build(model_type, jcfg, head_dim=32), params,
                        model)


@pytest.mark.parametrize("ext", [".bin", ".safetensors"])
def test_load_torch_state_dict_reads_both_formats(tmp_path, ext):
    """A pytorch_model.bin (torch.save) and a model.safetensors give the
    same float32 tensors as the JAX reader's arrays."""
    sd, _ = dpr_checkpoint()
    sd = {k: v.contiguous() for k, v in sd.items()}
    path = os.path.join(tmp_path, "model" + ext)
    if ext == ".bin":
        torch.save(sd, path)
    else:
        from safetensors.torch import save_file

        save_file(sd, path)
    got = hf.load_torch_state_dict(path)
    want = jhf.load_torch_state_dict(path)
    assert set(got) == set(want) == set(sd)
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k],
                                                            np.float32))
