"""The port's utilities (utils/misc.py, utils/logging.py) against the JAX
package's on the same inputs: tests/test_aux.py's cases through both.
Tolerances: exact, except the teacher updates (float32, 1e-6)."""
import json
import os
import threading

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cocodr_tpu.utils import logging as jlog
from cocodr_tpu.utils import misc as jmisc
from cocodr_tpu_torch.utils import logging as tlog
from cocodr_tpu_torch.utils import misc as tmisc


@pytest.mark.parametrize("kw", [dict(alpha=0.9), dict(alpha=0.995),
                                dict(average="simple", step=4)])
def test_mean_teacher_update_matches_jax(kw):
    """tests/test_aux.py:67 and random tensors: a state dict and a list
    give the JAX tree_map's values (1e-6); the arguments stay unchanged and
    the results carry no gradient."""
    rng = np.random.RandomState(0)
    t = {"w": rng.randn(3, 4).astype(np.float32),
         "b": rng.randn(4).astype(np.float32)}
    s = {k: rng.randn(*v.shape).astype(np.float32) for k, v in t.items()}
    want = jmisc.mean_teacher_update({k: jnp.asarray(v) for k, v in t.items()},
                                     {k: jnp.asarray(v) for k, v in s.items()},
                                     **kw)
    tt = {k: torch.tensor(v, requires_grad=True) for k, v in t.items()}
    ss = {k: torch.from_numpy(v) for k, v in s.items()}
    got = tmisc.mean_teacher_update(tt, ss, **kw)
    as_list = tmisc.mean_teacher_update(list(tt.values()), list(ss.values()),
                                        **kw)
    for (k, v), w in zip(got.items(), as_list):
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-6)
        assert torch.equal(v, w) and not v.requires_grad
        np.testing.assert_array_equal(tt[k].detach().numpy(), t[k])
    ones = tmisc.mean_teacher_update({"w": torch.ones(3)},
                                     {"w": torch.zeros(3)}, **kw)["w"]
    np.testing.assert_allclose(ones.numpy(), np.asarray(
        jmisc.mean_teacher_update({"w": jnp.ones(3)}, {"w": jnp.zeros(3)},
                                  **kw)["w"]), rtol=1e-6)


def test_mean_teacher_update_rejects_what_jax_rejects():
    for kw in (dict(average="simple"), dict(average="other")):
        for mod in (jmisc, tmisc):
            with pytest.raises(ValueError):
                mod.mean_teacher_update({"w": jnp.ones(1)} if mod is jmisc
                                        else {"w": torch.ones(1)},
                                        {"w": jnp.ones(1)} if mod is jmisc
                                        else {"w": torch.ones(1)}, **kw)


def test_average_meter_and_episode_lr_decay_match_jax():
    """tests/test_aux.py:84's schedule values and an AverageMeter fed the
    same values and counts (reset included) through both."""
    for step in (0, 17, 50, 79, 99, 100, 250):
        assert tmisc.episode_lr_decay(2e-5, step, 100) == (
            jmisc.episode_lr_decay(2e-5, step, 100))
    assert tmisc.episode_lr_decay(1.0, 99, 100) == pytest.approx(0.2)
    a, b = tmisc.AverageMeter(), jmisc.AverageMeter()
    for i, (v, n) in enumerate(((0.5, 1), (2.0, 3), (1.25, 2), (7.0, 1))):
        if i == 2:
            a.reset()
            b.reset()
        a.update(v, n)
        b.update(v, n)
        assert vars(a) == vars(b)
    assert tmisc.BEIR_GROUP_NAMES == jmisc.BEIR_GROUP_NAMES


def test_metrics_logger_jsonl_matches_jax(tmp_path):
    """tests/test_aux.py:128 through both: the same records, byte for
    byte, for floats, ints, 0-d arrays of each package and a value float()
    refuses; TensorBoard event files written when tensorboardX is
    importable."""
    a, b = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jl = jlog.MetricsLogger(log_dir=str(tmp_path / "tbj"), jsonl_path=a)
    tl = tlog.MetricsLogger(log_dir=str(tmp_path / "tbt"), jsonl_path=b)
    for step, (m, tm) in enumerate((
            ({"loss": 0.5}, {"loss": 0.5}),
            ({"loss": jnp.asarray(0.25)}, {"loss": torch.tensor(0.25)}),
            ({"n": 3, "name": "ck-1"}, {"n": 3, "name": "ck-1"}))):
        jl.log(step, m, prefix="ance/")
        tl.log(step, tm, prefix="ance/")
    jl.close()
    tl.close()
    assert open(a, "rb").read() == open(b, "rb").read()
    recs = [json.loads(line) for line in open(b)]
    assert recs[1] == {"step": 1, "ance/loss": 0.25}
    assert recs[2]["ance/name"] == "ck-1"
    try:
        import tensorboardX  # noqa: F401
        assert os.listdir(tmp_path / "tbt")
    except ImportError:
        pass


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """profile_trace writes one Chrome trace of the block's operations
    (the host's here) and, beside it under the same stamp, the block's
    spans of every thread; disabled, it writes nothing."""
    with tlog.profile_trace(str(tmp_path / "off"), enabled=False):
        torch.ones(4).sum()
    assert not (tmp_path / "off").exists()
    def on_a_thread():
        with tlog.span("cocodr.test.thread"):
            pass

    with tlog.span("cocodr.test.before"):
        pass
    with tlog.profile_trace(str(tmp_path / "on")):
        with tlog.span("cocodr.test.main", unit=3):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
        worker = threading.Thread(target=on_a_thread)
        worker.start()
        worker.join(timeout=60)
    assert not worker.is_alive()
    spans, trace = sorted(os.listdir(tmp_path / "on"))
    assert trace.startswith("trace-") and spans == "spans-" + trace[6:]
    events = json.load(open(tmp_path / "on" / trace))["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any(e.get("name") == "cocodr.test.main" for e in events)
    recs = json.load(open(tmp_path / "on" / spans))
    assert [r["name"] for r in recs] == ["cocodr.test.main",
                                         "cocodr.test.thread"]
    assert recs[0]["unit"] == 3 and recs[0]["parent"] is None
    assert recs[0]["thread"] == threading.get_ident() != recs[1]["thread"]
    assert all(r["start_ns"] <= r["end_ns"] for r in recs)
