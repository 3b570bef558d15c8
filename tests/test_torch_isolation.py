"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU on their own."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
# the port's sources; _build/ holds what the kernel build writes
PORT_FILES = sorted(
    p for p in (ROOT / "cocodr_tpu_torch").rglob("*.py")
    if "_build" not in p.relative_to(ROOT).parts
) + [ROOT / "chip_smoke.py"]
MODULES = [
    "cocodr_tpu_torch",
    "cocodr_tpu_torch.ops._build",
    "cocodr_tpu_torch.ops._device",
    "cocodr_tpu_torch.ops._recompute",
    "cocodr_tpu_torch.ops.attention",
    "cocodr_tpu_torch.ops.ffn",
    "cocodr_tpu_torch.ops.int8_matmul",
    "cocodr_tpu_torch.ops.kmeans",
    "cocodr_tpu_torch.ops.mips",
    "cocodr_tpu_torch.ops.mips_blockmax",
    "cocodr_tpu_torch.ops.mips_exact2",
    "cocodr_tpu_torch.ops.mips_hier",
    "cocodr_tpu_torch.ops.mips_int8",
    "cocodr_tpu_torch.models.bert",
    "cocodr_tpu_torch.models.dual_encoder",
    "cocodr_tpu_torch.models.convert",
    "cocodr_tpu_torch.models.hf",
    "cocodr_tpu_torch.models.condenser",
    "cocodr_tpu_torch.parallel",
    "cocodr_tpu_torch.parallel.topk",
    "cocodr_tpu_torch.pipelines.encode",
    "cocodr_tpu_torch.pipelines.serve",
    "cocodr_tpu_torch.pipelines.train_step",
    "cocodr_tpu_torch.pipelines.warmup",
    "cocodr_tpu_torch.pipelines.eval_beir",
    "cocodr_tpu_torch.pipelines.ance",
    "cocodr_tpu_torch.pipelines.coco",
    "cocodr_tpu_torch.evals",
    "cocodr_tpu_torch.evals.metrics",
    "cocodr_tpu_torch.evals.msmarco",
    "cocodr_tpu_torch.evals.mrr_eval",
    "cocodr_tpu_torch.data",
    "cocodr_tpu_torch.data.prefetch",
    "cocodr_tpu_torch.data.preprocess",
    "cocodr_tpu_torch.data.records",
    "cocodr_tpu_torch.data.streams",
    "cocodr_tpu_torch.data.coco_collator",
    "cocodr_tpu_torch.data.coco_spans",
    "cocodr_tpu_torch.losses",
    "cocodr_tpu_torch.losses.dro",
    "cocodr_tpu_torch.losses.nll",
    "cocodr_tpu_torch.losses.contrastive",
    "cocodr_tpu_torch.optim",
    "cocodr_tpu_torch.optim.lamb",
    "cocodr_tpu_torch.optim.adamw",
    "cocodr_tpu_torch.optim.schedules",
    "cocodr_tpu_torch.core",
    "cocodr_tpu_torch.core.configs",
    "cocodr_tpu_torch.utils",
    "cocodr_tpu_torch.utils.logging",
    "cocodr_tpu_torch.utils.misc",
    "cocodr_tpu_torch.utils.train_state",
    "chip_smoke",
]


def test_import_leaves_jax_and_jax_package_out():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'transformers', "
        "'cocodr_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_import_in_source(path):
    text = path.read_text()
    pattern = (r"^\s*(import\s+(jax|jaxlib|flax|optax|transformers|cocodr_tpu)"
               r"\b|from\s+(jax|jaxlib|flax|optax|transformers|cocodr_tpu)"
               r"[\s.])")
    assert not re.search(pattern, text, re.M), path


def test_no_cpu_fallback_without_cuda(monkeypatch):
    """Without a card, every entry point called without device='cpu'
    raises instead of running on the CPU."""
    from cocodr_tpu_torch import resolve_device
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import (
        DualEncoder,
        MODEL_REGISTRY,
        build_dual_encoder,
    )
    from cocodr_tpu_torch.pipelines.serve import RetrievalService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = BertConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_dual_encoder("rdot_nll", cfg)
    model = DualEncoder(MODEL_REGISTRY["rdot_nll"](cfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RetrievalService(model, lambda *a, **k: None,
                         np.zeros((4, 768), np.float32))
    assert resolve_device("cpu") == torch.device("cpu")


def test_eval_and_dro_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The eval and DRO entry points of the ninth slice: without a card,
    called without device='cpu', they raise before any work."""
    from cocodr_tpu_torch.data.records import RecordWriter, TokenCache
    from cocodr_tpu_torch.evals.mrr_eval import combined_mrr, full_ranking_mrr
    from cocodr_tpu_torch.losses.dro import DroConfig, dro_greedy_init
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import DualEncoder, MODEL_REGISTRY
    from cocodr_tpu_torch.pipelines.eval_beir import (
        BeirEvalConfig,
        evaluate_beir_task,
    )

    path = str(tmp_path / "r")
    with RecordWriter(path, 8) as w:
        w.write([2, 5, 3])
    cache = TokenCache(path)
    model = DualEncoder(MODEL_REGISTRY["rdot_nll"](BertConfig.tiny()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_beir_task(model, path, path, {"d": 0}, {"q": 0},
                           {"q": {"d": 1}}, BeirEvalConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        full_ranking_mrr(model, cache, cache, {0: [0]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        combined_mrr(model, cache, cache, {0: [0]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dro_greedy_init(DroConfig())


def test_mining_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The mining entry points of the tenth slice (mine, ance_round, the
    k-means, the corpus placement): without a card, called without
    device='cpu', they raise before any work."""
    from cocodr_tpu_torch.data.records import RecordWriter, TokenCache
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import DualEncoder, MODEL_REGISTRY
    from cocodr_tpu_torch.ops.kmeans import assign_clusters, kmeans
    from cocodr_tpu_torch.optim import Lamb
    from cocodr_tpu_torch.pipelines import ance
    from cocodr_tpu_torch.utils.train_state import TrainState

    path = str(tmp_path / "r")
    with RecordWriter(path, 8) as w:
        w.write([2, 5, 3])
    cache = TokenCache(path)
    model = DualEncoder(MODEL_REGISTRY["rdot_nll"](BertConfig.tiny()))
    state = TrainState(model, Lamb(model.parameters(), 1e-3))
    args = (cache, cache, {0: 0}, cache, {0: {0: 1}}, str(tmp_path / "out"),
            0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ance.mine(model, None, *args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ance.ance_round(state, None, None, *args, ance.MineConfig(), 1, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kmeans(np.zeros((4, 2), np.float32), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ance.place_corpus(np.zeros((4, 2), np.float32))
    assert not (tmp_path / "out").exists()
    ids = assign_clusters(np.zeros((4, 2), np.float32), torch.zeros(2, 2))
    assert ids.device.type == "cpu"


def test_chip_smoke_fails_without_cuda_and_prints_no_result(tmp_path):
    """Without a card the smoke exits non-zero before any result line; a
    directory that holds only chip_smoke.py fails too."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_kernel_sources_are_committed_text_only():
    """The build reads csrc/*.cu and *.cuh; every kernel entry point the
    loader binds is defined in them."""
    from cocodr_tpu_torch.ops import _build

    cu, cuh = _build._sources()
    text = "".join(p.read_text() for p in cu + cuh)
    for name in list(_build.SIGNATURES) + ["cocodr_error_string"]:
        assert re.search(rf'extern "C" [^(]*\b{name}\(', text), name
    assert "torch/extension.h" not in text
