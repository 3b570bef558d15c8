"""The port CLI's surface and the small modules of its slice: every one of
the JAX CLI's fifteen subcommands is registered and accepts every flag the
JAX subcommand does (read from both CLIs' --help); `presets` prints the
JAX CLI's text but for the compute dtype's name; core/configs.py's
PRESETS and to_json; utils/misc.py::lamb_trust_ratios, losses/criteria.py
and core/precision.py against the JAX package (tests/test_aux.py's cases
through the port)."""
import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cocodr_tpu.cli import main as jax_main
from cocodr_tpu.core import configs as jax_configs
from cocodr_tpu.losses import criteria as jax_criteria
from cocodr_tpu_torch import cli
from cocodr_tpu_torch.core import configs
from cocodr_tpu_torch.core.precision import Precision
from cocodr_tpu_torch.losses import criteria
from cocodr_tpu_torch.optim import Lamb, MultiSteps
from cocodr_tpu_torch.utils.misc import lamb_trust_ratios

F = torch.nn.functional
torch.set_num_threads(1)
SUBCOMMANDS = ["presets", "eval-beir", "parity", "encode", "serve",
               "preprocess-msmarco", "preprocess-beir", "warmup", "ance",
               "ance-mine", "ance-train", "export-hf", "preprocess-coco",
               "coco", "convert-hf"]
# the compute dtype's str(): a jnp type in the JAX package, a torch.dtype
# in the port; and the attention's default: the port's 'auto' takes the
# JAX package's 'einsum' formulation except in a forward on the card that
# records no gradient (models/bert.py). The two fields whose JSON differs,
# by design
DTYPE = ("\"<class 'jax.numpy.float32'>\"", '"torch.float32"')
ATTENTION = ('"attention_impl": "einsum"', '"attention_impl": "auto"')


@pytest.fixture(autouse=True)
def wide_help(monkeypatch):
    """argparse wraps --help at the terminal's width: none here."""
    monkeypatch.setenv("COLUMNS", "10000")


def _flags(main, argv, capsys):
    with pytest.raises(SystemExit) as ei:
        main(argv)
    assert ei.value.code == 0
    text = capsys.readouterr().out
    return set(re.findall(r"(?<![\w-])--[a-z0-9][a-z0-9-]*", text)), text


def test_all_fifteen_subcommands_are_registered(capsys):
    _, text = _flags(cli.main, ["--help"], capsys)
    listed = re.search(r"\{([a-z0-9,-]+)\}", text).group(1).split(",")
    assert listed == SUBCOMMANDS
    _, jtext = _flags(jax_main, ["--help"], capsys)
    assert sorted(re.search(r"\{([a-z0-9,-]+)\}", jtext).group(1)
                  .split(",")) == sorted(SUBCOMMANDS)


@pytest.mark.parametrize("name", SUBCOMMANDS)
def test_subcommand_accepts_every_flag_of_the_jax_one(name, capsys):
    jax_flags, _ = _flags(jax_main, [name, "--help"], capsys)
    port_flags, _ = _flags(cli.main, [name, "--help"], capsys)
    assert jax_flags <= port_flags, jax_flags - port_flags


def test_presets_print_the_jax_clis_text(capsys):
    jax_main(["presets"])
    want = capsys.readouterr().out
    cli.main(["presets"])
    got = capsys.readouterr().out
    assert got.count("== ") == 6
    assert got == want.replace(*DTYPE).replace(*ATTENTION)


@pytest.mark.parametrize("name", list(jax_configs.PRESETS))
def test_preset_json_carries_the_jax_keys_and_values(name):
    """Each preset as a dict: the same keys and values, the dtype's name
    and the attention's default aside; PRESETS names the same six
    configs."""
    assert list(configs.PRESETS) == list(jax_configs.PRESETS)
    got = json.loads(configs.to_json(configs.PRESETS[name]()))
    want = json.loads(jax_configs.to_json(jax_configs.PRESETS[name]()))
    for d in (got, want):
        assert d.get("bert", {}).pop("dtype", None) in (
            json.loads(DTYPE[0]), json.loads(DTYPE[1]), None)
    if "bert" in want:
        assert (got["bert"].pop("attention_impl"),
                want["bert"].pop("attention_impl")) == ("auto", "einsum")
    assert got == want


def test_lamb_trust_ratios_match_the_jax_diagnostic():
    """tests/test_aux.py's case: after one LAMB update of w = 2 (4 x 4) and
    b = 0 (4) with unit gradients, the ratios by name equal the JAX
    package's over the updated parameters (the port's step updates them in
    place); b's zero norm gives 1; a MultiSteps around the Lamb reads its
    inner moments; another optimizer gives {}."""
    import optax

    from cocodr_tpu.optim import lamb as jax_lamb
    from cocodr_tpu.utils.misc import lamb_trust_ratios as jax_ratios

    params = {"layer": {"w": jnp.ones((4, 4)) * 2.0, "b": jnp.zeros(4)}}
    tx = jax_lamb(1e-3)
    state = tx.init(params)
    grads = {"layer": {"w": jnp.ones((4, 4)), "b": jnp.ones(4)}}
    updates, state = tx.update(grads, state, params)
    want = jax_ratios(state, optax.apply_updates(params, updates))

    layer = torch.nn.Module()
    layer.w = torch.nn.Parameter(torch.full((4, 4), 2.0))
    layer.b = torch.nn.Parameter(torch.zeros(4))
    model = torch.nn.Module()
    model.layer = layer
    for opt in (Lamb(model.parameters(), 1e-3),
                MultiSteps(Lamb(model.parameters(), 1e-3), 1)):
        assert lamb_trust_ratios(opt, model) == {}
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        got = lamb_trust_ratios(opt, model)
        assert {k.replace(".", "/") for k in got} == set(want)
        for k, v in got.items():
            assert v == pytest.approx(want[k.replace(".", "/")], rel=1e-6)
            assert np.isfinite(v) and v >= 0
        assert got["layer.b"] == want["layer/b"]
        with torch.no_grad():
            layer.w.fill_(2.0)
            layer.b.zero_()
    assert lamb_trust_ratios(torch.optim.SGD(model.parameters(), 0.1),
                             model) == {}


def _pair(seed, shape=(6, 9)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def test_criteria_match_torch_and_jax():
    """tests/test_aux.py::test_criteria_match_torch: KL, MSE and CE against
    torch's, symmetric KL symmetric; every criterion of the registry
    against the JAX one (1e-5)."""
    a, b = _pair(0)
    ta, tb = torch.tensor(a), torch.tensor(b)
    assert float(criteria.kl_loss(ta, tb)) == pytest.approx(float(F.kl_div(
        F.log_softmax(ta, -1), F.softmax(tb, -1), reduction="batchmean")),
        rel=1e-5)
    assert float(criteria.mse_loss(ta, tb)) == pytest.approx(
        float(F.mse_loss(ta, tb)), rel=1e-6)
    targets = np.random.RandomState(1).randint(0, 9, 6)
    assert float(criteria.ce_loss(ta, torch.tensor(targets))) == \
        pytest.approx(float(F.cross_entropy(ta, torch.tensor(targets))),
                      rel=1e-5)
    assert float(criteria.sym_kl_loss(ta, tb)) == pytest.approx(
        float(criteria.sym_kl_loss(tb, ta)), rel=1e-5)
    assert criteria.LOSS_REGISTRY.keys() == jax_criteria.LOSS_REGISTRY.keys()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    labels = np.where(np.arange(6) % 3 == 0, -100, targets)
    cases = {
        "ce": ((ta, torch.tensor(targets)), (ja, jnp.asarray(targets))),
        "mlm": ((ta, torch.tensor(labels)), (ja, jnp.asarray(labels))),
        "rank_ce": ((ta[:, 0], tb[:, 0]), (ja[:, 0], jb[:, 0])),
        "span_ce": ((ta, tb, torch.tensor(targets), torch.tensor(targets)),
                    (ja, jb, jnp.asarray(targets), jnp.asarray(targets))),
    }
    for name, fn in criteria.LOSS_REGISTRY.items():
        ours, theirs = cases.get(name, ((ta, tb), (ja, jb)))
        assert float(fn(*ours, alpha=0.7)) == pytest.approx(
            float(jax_criteria.LOSS_REGISTRY[name](*theirs, alpha=0.7)),
            rel=1e-5, abs=1e-7), name


@pytest.mark.parametrize("name", ["sym_kl_loss", "js_loss", "stable_kl_loss",
                                  "hellinger_loss", "kl_loss"])
def test_criteria_gradients_match_jax(name):
    """tests/test_aux.py::test_criteria_reference_exact_semantics: each
    criterion's gradient in its first argument equals jax.grad of the JAX
    one, the detached sides included (hellinger passes none)."""
    a, b = _pair(3, (5, 7))
    ta = torch.tensor(a, requires_grad=True)
    loss = getattr(criteria, name)(ta, torch.tensor(b))
    want = jax.grad(lambda x: getattr(jax_criteria, name)(
        x, jnp.asarray(b)))(jnp.asarray(a))
    if name == "hellinger_loss":
        assert not loss.requires_grad
        assert float(jnp.abs(want).max()) == 0.0
        return
    loss.backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-6)


def test_precision_policy():
    from cocodr_tpu.core.precision import Precision as JaxPrecision

    for ours, theirs in ((Precision.bf16(), JaxPrecision.bf16()),
                         (Precision.fp32(), JaxPrecision.fp32())):
        assert str(ours.compute_dtype).split(".")[-1] == \
            jnp.dtype(theirs.compute_dtype).name
        assert ours.param_dtype == torch.float32
    assert Precision().compute_dtype == torch.bfloat16
