"""The DeepSeek-V2 retrieval tower (models/deepseek_v2.py, ops/moe.py) on
the CPU at a tiny config (hidden 64, 3 layers: 1 dense + 2 MoE, 8 experts,
top 2, 1 shared, kv rank 16, rope dim 8, YaRN on), against the benchmark's
plain float32 reference (portbench/reference/deepseek_v2.py) and
transformers' DeepseekV2Model; the router's indices and weights, YaRN's
frequencies and the softmax scale, the checkpoint loader, the CLI's encode,
the encode path's one copy of the weights, and routing without host
reads."""
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cocodr_tpu_torch import cli
from cocodr_tpu_torch.data.records import RecordWriter, TokenCache
from cocodr_tpu_torch.models import deepseek_v2
from cocodr_tpu_torch.models.deepseek_v2 import DeepseekV2Config
from cocodr_tpu_torch.models.dual_encoder import (
    DualEncoder,
    DualEncoderConfig,
    build_dual_encoder,
)
from cocodr_tpu_torch.models.hf import config_from_hf, state_dict_from_hf
from cocodr_tpu_torch.ops import moe
from cocodr_tpu_torch.pipelines.encode import (
    EncodeConfig,
    Encoder,
    encode_cache,
)
from portbench import weights_deepseek_v2
from portbench.reference import deepseek_v2 as reference

torch.set_num_threads(1)


def hf_keys(cfg: DeepseekV2Config) -> dict:
    """The config as config.json's keys (what the reference reads)."""
    out = {f.name: getattr(cfg, f.name)
           for f in dataclasses.fields(cfg) if f.name != "dtype"}
    out["rope_scaling"] = cfg.rope
    return out


def draw(cfg: DeepseekV2Config, seed: int = 0, std: float = 0.1):
    """HuggingFace-named float32 weights: std 0.1 so that the router's
    probabilities are far apart and no top-k choice is a near tie."""
    g = torch.Generator().manual_seed(seed)
    return weights_deepseek_v2.draw(hf_keys(cfg), g, std, "cpu",
                                    dtype=torch.float32)


def port_model(cfg: DeepseekV2Config, weights) -> DualEncoder:
    dcfg = DualEncoderConfig.rdot_nll_condenser(cfg)
    with torch.device("meta"):
        model = DualEncoder(dcfg)
    model.load_state_dict(
        {k: v.to(cfg.dtype) for k, v in state_dict_from_hf(weights, dcfg)
         .items()}, strict=True, assign=True)
    return model.eval()


def records(n=6, S=12, seed=1, vocab=128):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, S + 1, n)
    lengths[0] = S
    ids = rng.integers(1, vocab, (n, S))
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    return torch.as_tensor(ids * mask), torch.as_tensor(mask), lengths


def test_float32_tower_equals_the_reference():
    """float32 on both sides, the same weights: the port's pooled rows
    within 2e-5 of the reference's (sums in another order: the port's
    batched products and SDPA against the reference's per-row ones)."""
    cfg = DeepseekV2Config.tiny()
    W = draw(cfg)
    ids, mask, lengths = records()
    got = port_model(cfg, W).body_emb(ids, mask)
    ref = reference.last_token_embeddings(W, hf_keys(cfg), ids, lengths)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)


def test_bf16_tower_is_near_the_reference():
    """The port computing in bf16 from bf16-rounded weights against the
    float32 reference of those weights: each row within 3% (bf16 keeps 8
    bits of mantissa, ~0.4% a rounding, over three layers' products and
    norms)."""
    cfg = DeepseekV2Config.tiny(dtype=torch.bfloat16)
    W = {k: v.to(torch.bfloat16) for k, v in draw(cfg).items()}
    ids, mask, lengths = records(n=8, S=16, seed=2)
    model = port_model(cfg, W)
    got = model.body_emb(ids, mask).float()
    ref = reference.last_token_embeddings(W, hf_keys(cfg), ids, lengths)
    rel = (got - ref).norm(dim=1) / ref.norm(dim=1)
    assert float(rel.max()) < 0.03, rel


def test_reference_equals_transformers_deepseek_v2_without_rope_scaling():
    """With rope_scaling None (m = 1, plain rotary) transformers 4.57's
    DeepseekV2Model and the reference compute the same tower: the last
    real token's hidden state within 1e-5."""
    tr = pytest.importorskip("transformers")
    cfg = DeepseekV2Config.tiny(rope_scaling=None)
    W = draw(cfg, seed=3)
    keys = hf_keys(cfg)
    hf_cfg = tr.DeepseekV2Config(**{k: v for k, v in keys.items()
                                    if k != "model_type"})
    hf_cfg._attn_implementation = "eager"
    hf = tr.DeepseekV2Model(hf_cfg).eval()
    hf.load_state_dict({k[len("model."):]: v for k, v in W.items()},
                       strict=True)
    ids, mask, lengths = records(seed=4)
    with torch.no_grad():
        out = hf(input_ids=ids, attention_mask=mask).last_hidden_state
    want = out[torch.arange(len(ids)), torch.as_tensor(lengths) - 1]
    ref = reference.last_token_embeddings(W, keys, ids, lengths)
    torch.testing.assert_close(ref, want, rtol=1e-5, atol=1e-5)
    got = port_model(cfg, W).body_emb(ids, mask)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_yarn_frequencies_and_softmax_scale():
    """The port's and the reference's YaRN inverse frequencies against
    transformers' _compute_yarn_parameters (float32, 1e-6 relative: the
    reference divides by the factor in another order); s against
    DeepseekV3Attention's scaling (m^2 kept), and V2-Lite's s = 0.114721."""
    tr = pytest.importorskip("transformers")
    from transformers.modeling_rope_utils import _compute_yarn_parameters
    from transformers.models.deepseek_v3.modeling_deepseek_v3 import (
        DeepseekV3Attention,
    )

    for cfg in (DeepseekV2Config(), DeepseekV2Config.tiny()):
        rope = dict(cfg.rope)
        hf_cfg = tr.DeepseekV3Config(
            hidden_size=cfg.hidden_size,
            num_attention_heads=cfg.num_attention_heads,
            qk_rope_head_dim=cfg.qk_rope_head_dim,
            qk_nope_head_dim=cfg.qk_nope_head_dim,
            v_head_dim=cfg.v_head_dim, kv_lora_rank=cfg.kv_lora_rank,
            q_lora_rank=None, rope_theta=cfg.rope_theta,
            max_position_embeddings=cfg.max_position_embeddings,
            rope_scaling=dict(rope))
        want, factor = _compute_yarn_parameters(hf_cfg, "cpu")
        got, got_factor = deepseek_v2.rope_inv_freq(cfg)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert got_factor == pytest.approx(factor)
        ref, ref_factor = reference.inv_freq(hf_keys(cfg))
        torch.testing.assert_close(ref, want, rtol=1e-6, atol=0)
        assert ref_factor == pytest.approx(factor)
        scale = DeepseekV3Attention(hf_cfg, 0).scaling
        assert cfg.softmax_scale == pytest.approx(scale, rel=1e-12)
        assert reference.softmax_scale(hf_keys(cfg)) == pytest.approx(scale)
    assert DeepseekV2Config().softmax_scale == pytest.approx(0.114721,
                                                             abs=1e-6)


def test_router_indices_and_weights_equal_the_reference():
    """ops/moe.py::route against the reference's router on the same
    inputs: the same top-k experts, their probabilities to 1e-6, pads
    routed to the sentinel E, rows in expert order with each expert's
    first row in offsets."""
    cfg = DeepseekV2Config.tiny()
    W = draw(cfg, seed=5)
    x = torch.randn(40, cfg.hidden_size, generator=torch.Generator()
                    .manual_seed(6))
    gate = W["model.layers.1.mlp.gate.weight"]
    real = torch.arange(40) % 7 != 3
    r = moe.route(x, gate, cfg.num_experts_per_tok, real)
    probs = (x @ gate.T).softmax(-1)
    want = probs.topk(cfg.num_experts_per_tok, dim=-1)
    E = cfg.n_routed_experts
    assert torch.equal(r.topk[real], want.indices[real])
    assert bool((r.topk[~real] == E).all())
    flat = r.topk.reshape(-1)[r.order]
    assert bool((flat[:-1] <= flat[1:]).all())
    for e in range(E + 1):
        assert int(r.offsets[e]) == int((flat < e).sum())
    n = int(r.offsets[E])
    torch.testing.assert_close(
        r.weights[:n], want.values.reshape(-1)[r.order[:n]], rtol=1e-6,
        atol=0)
    torch.testing.assert_close(r.rows, x[r.order // 2], rtol=0, atol=0)
    _, own, ref_probs = reference.moe(
        {k[len("model.layers.1."):]: v for k, v in W.items()
         if k.startswith("model.layers.1.")}, hf_keys(cfg), x[real])
    assert torch.equal(own, want.indices[real])
    torch.testing.assert_close(ref_probs, probs[real], rtol=1e-6, atol=0)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket.__name__))
        return func(*args, **(kwargs or {}))


def test_routing_issues_no_host_read():
    """route and combine issue no op whose result the host has to read
    (`.item()` / `.tolist()` reach aten._local_scalar_dense; nonzero,
    bincount and unique size their output from the data): on the card a
    layer's routing queues behind the card's work without waiting."""
    cfg = DeepseekV2Config.tiny()
    x = torch.randn(24, cfg.hidden_size)
    gate = torch.randn(cfg.n_routed_experts, cfg.hidden_size)
    real = torch.arange(24) < 20
    with _Ops() as rec:
        r = moe.route(x, gate, 2, real)
        moe.combine(torch.zeros(48, cfg.hidden_size), x, real, 2)
    banned = {"_local_scalar_dense", "nonzero", "bincount", "unique",
              "_unique2", "masked_select", "item"}
    assert rec.ops and not banned & set(rec.ops), rec.ops
    assert r.offsets.dtype == torch.int32


def test_expert_ffn_reference_is_the_routed_swiglu():
    """The kernel's plain version: each real (token, slot) row at its slot,
    p * down(bf16(silu(gate x) * up x)), pads' rows zero; combine sums a
    token's rows with the shared output."""
    g = torch.Generator().manual_seed(7)
    E, H, F_, T, k = 4, 16, 8, 10, 2
    x = torch.randn(T, H, generator=g)
    wg, wu = torch.randn(E, F_, H, generator=g), torch.randn(E, F_, H,
                                                             generator=g)
    wd = torch.randn(E, H, F_, generator=g)
    real = torch.arange(T) != 4
    r = moe.route(x, torch.randn(E, H, generator=g), k, real)
    out = moe.expert_ffn(r.rows, wg, wu, wd, r.offsets, r.weights, r.order)
    probs = r.weights.new_zeros(T * k)
    probs[r.order] = r.weights
    for t in range(T):
        for j in range(k):
            e = int(r.topk[t, j])
            if not real[t]:
                assert e == E and not out[t * k + j].any()
                continue
            want = probs[t * k + j] * (wd[e] @ (torch.nn.functional.silu(
                wg[e] @ x[t]) * (wu[e] @ x[t])))
            torch.testing.assert_close(out[t * k + j], want, rtol=1e-5,
                                       atol=1e-5)
    y = moe.combine(out, x, real, k)
    torch.testing.assert_close(y[0], out[0] + out[1] + x[0])
    torch.testing.assert_close(y[4], x[4])
    assert moe.expert_ffn.launches == 0  # the CPU launches nothing


def test_config_refuses_what_the_tower_does_not_compute():
    for bad in (dict(q_lora_rank=1536), dict(topk_method="noaux_tc"),
                dict(scoring_func="sigmoid"), dict(n_group=8),
                dict(first_k_dense_replace=-1)):
        with pytest.raises(ValueError):
            DeepseekV2Config.tiny(**bad)


def _save_hf_checkpoint(tmp_path, seed=8):
    tr = pytest.importorskip("transformers")
    cfg = DeepseekV2Config.tiny()
    keys = hf_keys(cfg)
    hf_cfg = tr.DeepseekV2Config(**{k: v for k, v in keys.items()
                                    if k != "model_type"})
    hf_cfg._attn_implementation = "eager"
    hf = tr.DeepseekV2Model(hf_cfg).eval()
    W = draw(cfg, seed=seed)
    hf.load_state_dict({k[len("model."):]: v for k, v in W.items()})
    path = tmp_path / "ckpt"
    hf.save_pretrained(str(path))
    return str(path), cfg, W


def test_loader_reads_a_saved_deepseek_v2_checkpoint(tmp_path):
    """DeepseekV2Model.save_pretrained's directory: config_from_hf gives
    the tiny config (YaRN included), and cli._load_model a tower equal to
    the reference of the saved weights (float32 on the CPU, 2e-5)."""
    path, cfg, W = _save_hf_checkpoint(tmp_path)
    with open(f"{path}/config.json") as f:
        got_cfg = config_from_hf(json.load(f))
    rope = got_cfg.rope
    assert rope.pop("rope_type") == "yarn"  # transformers adds the alias
    assert rope == cfg.rope
    assert dataclasses.replace(got_cfg, rope_scaling=None) == \
        dataclasses.replace(cfg, rope_scaling=None)
    model = cli._load_model(path, "rdot_nll_condenser", torch.device("cpu"))
    assert model.cfg.pooling == "last"
    ids, mask, lengths = records(seed=9)
    ref = reference.last_token_embeddings(W, hf_keys(cfg), ids, lengths)
    with torch.inference_mode():
        got = model.body_emb(ids, mask)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)


def test_cli_encode_takes_a_deepseek_v2_checkpoint(tmp_path, capsys):
    """`encode` with a deepseek_v2 checkpoint and length buckets writes the
    rows encode_cache gives in process, and those equal the reference."""
    path, cfg, W = _save_hf_checkpoint(tmp_path)
    ids, mask, lengths = records(n=9, S=16, seed=10)
    rec = str(tmp_path / "records")
    with RecordWriter(rec, 16) as w:
        for row, n in zip(ids.numpy(), lengths):
            w.write(row[:n])
    out = str(tmp_path / "emb.npy")
    cli.main(["encode", "--checkpoint", path, "--records", rec, "--out", out,
              "--batch-size", "4", "--length-buckets", "8,16",
              "--cpu-devices", "1"])
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info == {"out": out, "n": 9, "dim": cfg.hidden_size}
    got = np.load(out)
    ref = reference.last_token_embeddings(W, hf_keys(cfg), ids, lengths)
    np.testing.assert_allclose(got, ref.numpy(), rtol=2e-5, atol=2e-5)


def test_encoder_holds_an_inference_ready_tower_once():
    """Encoder encodes from the caller's deepseek_v2 model itself (its
    parameters are made without requires_grad, in the compute dtype), and
    encode_cache with length buckets gives each record's own row; a BERT
    model under training is still encoded from a copy."""
    cfg = DeepseekV2Config.tiny()
    model = port_model(cfg, draw(cfg, seed=11))
    enc = Encoder(model, device="cpu")
    assert enc.model is model
    ids, mask, lengths = records(n=10, S=16, seed=12)
    with TokenCacheFile(ids, lengths) as cache:
        got = encode_cache(enc, cache, EncodeConfig(
            batch_size=4, length_buckets=(4, 8, 16)))
    with torch.inference_mode():
        want = model.body_emb(ids, mask)
    np.testing.assert_allclose(got, want.numpy(), rtol=2e-5, atol=2e-5)
    from cocodr_tpu_torch.models.bert import BertConfig

    bert = build_dual_encoder("rdot_nll_condenser", BertConfig.tiny(),
                              device="cpu").train()
    assert Encoder(bert, device="cpu").model is not bert


def test_build_dual_encoder_draws_a_deepseek_v2_tower():
    """build_dual_encoder takes a DeepseekV2Config: a last-token tower,
    its weights drawn from the generator (two draws of one seed equal),
    in eval mode, no parameter requiring a gradient."""
    cfg = DeepseekV2Config.tiny()
    a = build_dual_encoder("rdot_nll_condenser", cfg, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    b = build_dual_encoder("rdot_nll_condenser", cfg, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    assert a.cfg.pooling == "last" and not a.training
    assert not any(p.requires_grad for p in a.parameters())
    for (n, p), (_, q) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(p, q), n
    ids, mask, _ = records()
    rows = a.encoder.expert_rows
    assert rows is None
    with torch.inference_mode():
        a.body_emb(ids, mask)
    rows = a.encoder.expert_rows
    k = cfg.num_experts_per_tok
    assert rows[0].sum() == 0  # the dense layer routes nothing
    assert all(int(r.sum()) == int(mask.sum()) * k for r in rows[1:])


def test_tower_runs_under_inference_mode_then_no_grad():
    """The expert counter and the rotary tables are made outside inference
    mode: a forward under torch.inference_mode (as Encoder runs it) and
    then forwards under torch.no_grad and with no mode at all run on the
    same model, give the same rows, and add to the one counter."""
    cfg = DeepseekV2Config.tiny()
    model = port_model(cfg, draw(cfg))
    ids, mask, _ = records()
    with torch.inference_mode():
        first = model.body_emb(ids, mask)
    once = model.encoder.expert_rows.clone()
    assert not model.encoder.expert_rows.is_inference()
    with torch.no_grad():
        torch.testing.assert_close(model.body_emb(ids, mask), first,
                                   rtol=0, atol=0)
    torch.testing.assert_close(model.body_emb(ids, mask), first, rtol=0,
                               atol=0)
    assert torch.equal(model.encoder.expert_rows, 3 * once)
    assert int(once[1:].sum()) == 2 * int(mask.sum()) * cfg.num_experts_per_tok


def _expert_ffn_float64(rows, w_gate, w_up, w_down, offsets, weights, dst):
    """expert_ffn's function with float64 sums (another summation order and
    precision), h rounded to the rows' dtype as the kernel rounds it."""
    out = torch.zeros(rows.shape, dtype=torch.float64)
    bounds = offsets.tolist()
    for e in range(w_gate.shape[0]):
        x = rows[bounds[e]:bounds[e + 1]].double()
        h = (torch.nn.functional.silu(x @ w_gate[e].double().T)
             * (x @ w_up[e].double().T)).to(rows.dtype).double()
        out[dst[bounds[e]:bounds[e + 1]]] = (
            weights[bounds[e]:bounds[e + 1], None].double()
            * (h @ w_down[e].double().T))
    return out.float()


def test_e1_row_bound_separates_planted_faults():
    """chip_smoke.py's moe phase holds E1 to its plain version by each
    routed row's error over the row's largest output (MOE_ROW_TOL, two
    bf16 ulps). Here, on bf16 rows and weights of 8 experts (H 256, F
    384), the function summed in float64 with h rounded to bf16 stays
    under the bound, while a row given to the neighbouring expert and an
    expert missing one 128-column tile of F read far above it
    (chip_smoke.moe_planted raises if either does not)."""
    import chip_smoke

    g = torch.Generator().manual_seed(11)
    E, H, F_, T, k = 8, 256, 384, 300, 2
    bf = torch.bfloat16
    w_gate, w_up = ((torch.randn(E, F_, H, generator=g) * 0.05).to(bf)
                    for _ in range(2))
    w_down = (torch.randn(E, H, F_, generator=g) * 0.05).to(bf)
    x = torch.randn(T, H, generator=g).to(bf)
    real = torch.rand(T, generator=g) >= 0.2
    r = moe.route(x, (torch.randn(E, H, generator=g) * 0.05).to(bf), k, real)
    a = (r.rows, w_gate, w_up, w_down, r.offsets, r.weights, r.order)
    got = _expert_ffn_float64(*a)
    ref = moe.expert_ffn_reference(*a)
    err = chip_smoke.moe_row_err(got, ref, r)
    assert 0 < err <= chip_smoke.MOE_ROW_TOL
    chip_smoke.moe_planted(moe, got, r, w_gate, w_up, w_down)


class TokenCacheFile:
    """Records written to a temporary file, read back as a TokenCache."""

    def __init__(self, ids, lengths):
        import tempfile

        self.dir = tempfile.TemporaryDirectory()
        self.path = self.dir.name + "/rec"
        with RecordWriter(self.path, ids.shape[1]) as w:
            for row, n in zip(ids.numpy(), lengths):
                w.write(row[:n])

    def __enter__(self):
        return TokenCache(self.path)

    def __exit__(self, *exc):
        self.dir.cleanup()
