"""RetrievalService serves from a copy of the model (pipelines/encode.py::
inference_copy), as the JAX service takes only copies of its params: a
service built from a model under training leaves the model's float32
Parameters bit-equal, their requires_grad and the module's train/eval mode
as they were, and its answers equal a service's built from a twin that
never trained. CPU, tiny config with a bf16 compute dtype (the card's),
so that the cast the service makes would round float32 weights."""
import numpy as np
import pytest
import torch

from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.dual_encoder import MODEL_REGISTRY, DualEncoder
from cocodr_tpu_torch.optim import Lamb
from cocodr_tpu_torch.pipelines.serve import RetrievalService, ServeConfig
from cocodr_tpu_torch.pipelines.train_step import build_train_step
from cocodr_tpu_torch.utils.train_state import TrainState

torch.set_num_threads(1)

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]


def tokenizer(texts, padding="max_length", truncation=True, max_length=8,
              return_tensors="np"):
    ids = np.zeros((len(texts), max_length), np.int64)
    mask = np.zeros_like(ids)
    for i, text in enumerate(texts):
        toks = [2] + [5 + WORDS.index(w) for w in text.split()][:max_length - 2]
        toks.append(3)
        ids[i, :len(toks)] = toks
        mask[i, :len(toks)] = 1
    return {"input_ids": ids, "attention_mask": mask}


def train_state():
    cfg = MODEL_REGISTRY["rdot_nll_condenser"](
        BertConfig.tiny(dtype=torch.bfloat16))
    torch.manual_seed(0)
    model = DualEncoder(cfg)
    return TrainState(model, Lamb(model.parameters(), lambda c: 1e-3))


def batch():
    rng = np.random.RandomState(3)
    out = {}
    for k, S in (("q", 6), ("pos", 10), ("neg", 10)):
        out[f"{k}_ids"] = torch.from_numpy(rng.randint(5, 11, (4, S)))
        out[f"{k}_mask"] = torch.ones(4, S, dtype=torch.long)
    return out


@pytest.mark.parametrize("training", [True, False])
def test_service_leaves_a_model_under_training_unchanged(training):
    """A service built from state.model after a LAMB step: every parameter
    stays float32, bit-equal and requiring grad, the module keeps its mode,
    and the next train step equals that of a state never served. The
    service's top-k equals one built from the never-served twin."""
    served, fresh = train_state(), train_state()
    step = build_train_step()
    for st in (served, fresh):
        step(st, batch())
        st.model.train(training)
    before = {k: v.clone() for k, v in served.model.state_dict().items()}
    rng = np.random.RandomState(0)
    corpus = rng.randn(64, 32).astype(np.float32)
    cfg = ServeConfig(top_k=5, max_query_len=8, max_batch=8)
    svc = RetrievalService(served.model, tokenizer, corpus, cfg=cfg,
                           device="cpu")
    assert served.model.training == training
    for name, p in served.model.named_parameters():
        assert p.dtype == torch.float32 and p.requires_grad, name
        assert torch.equal(p, before[name]), name
    assert svc.model is not served.model
    assert svc.model.encoder.embeddings.word_embeddings.weight.dtype == (
        torch.bfloat16)
    queries = ["alpha beta", "gamma", "delta epsilon zeta"]
    twin = RetrievalService(fresh.model, tokenizer, corpus, cfg=cfg,
                            device="cpu")
    for got, want in zip(svc.search(queries), twin.search(queries)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    loss_s, _ = step(served, batch())
    loss_f, _ = step(fresh, batch())
    assert torch.equal(loss_s, loss_f)
    for (name, a), b in zip(served.model.state_dict().items(),
                            fresh.model.state_dict().values()):
        assert torch.equal(a, b), name
