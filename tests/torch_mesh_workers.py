"""What the spawned ranks of the port's multi-process tests run
(cocodr_tpu_torch/core/mesh.py::spawn): module-level functions a child
process imports by name. This module imports neither JAX nor the JAX
package, so that a rank starts quickly and its sys.modules stays clean
(tests/test_torch_isolation.py checks it).

`run_cases(cases)` runs a list of (name, kwargs) on every rank of one
world, so that a test module pays for one world and not one a test; each
case returns numpy data (the rank's own view) for the test to compare.
"""
import contextlib
import hashlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from cocodr_tpu_torch.core.mesh import (
    MeshConfig,
    create_mesh,
    data_group,
    shard_batch,
)

LR, WARMUP, TOTAL, HEAD_DIM = 1e-3, 2, 10, 16


def _mesh(shape=None):
    """The world's (data, model) mesh: data-parallel by default, or
    shape = (data, model)."""
    cfg = MeshConfig() if shape is None else MeshConfig(*shape)
    return create_mesh(cfg, device="cpu")


@contextlib.contextmanager
def world_of_one():
    """In the calling process: a gloo world of one (core/mesh.py's
    HashStore world) and its (1, 1) mesh, torn down on exit."""
    mesh = _mesh()
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _digest(tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_cases(cases):
    return [globals()[name](**kw) for name, kw in cases]


# --- core/mesh.py ---------------------------------------------------------

def world():
    mesh = _mesh()
    return {"rank": dist.get_rank(), "size": dist.get_world_size(),
            "data": mesh["data"].size()}


def shard_rows(batch):
    return shard_batch(_mesh(), batch)


def shard_error(batch):
    try:
        shard_batch(_mesh(), batch)
    except ValueError as e:
        return str(e)
    return None


def foreign_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                         "transformers", "cocodr_tpu"))


def die_on_rank_1():
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()


def hang_on_rank_1():
    if dist.get_rank() == 1:
        time.sleep(3600)
    dist.barrier()


# --- parallel/topk.py and parallel/multihost.py ----------------------------

def search(queries, corpus, k, **kw):
    from cocodr_tpu_torch.parallel.topk import search_topk

    return search_topk(queries, corpus, k, mesh=_mesh(), device="cpu", **kw)


def sharded(queries, corpus, k, **kw):
    from cocodr_tpu_torch.parallel.topk import mips_topk_sharded

    return mips_topk_sharded(queries, corpus, k, _mesh(), device="cpu", **kw)


def dtopk(vals, ids, k):
    """vals, ids [W, Q, k']: this rank merges its own slice."""
    from cocodr_tpu_torch.parallel.topk import distributed_topk

    r = dist.get_rank()
    v, i = distributed_topk(torch.from_numpy(vals[r]),
                            torch.from_numpy(ids[r]), k, _mesh())
    return v.numpy(), i.numpy()


def two_level(queries, corpus, k):
    """The corpus in equal shards over (replica, data), as
    tests/test_multihost.py places it; -> (vals, ids) of the two-level
    merge of each shard's exact top-k."""
    from cocodr_tpu_torch.parallel.multihost import hybrid_mesh, two_level_topk

    mesh = hybrid_mesh(model=1, force_replicas=2, device="cpu")
    r = dist.get_rank()
    per = corpus.shape[0] // dist.get_world_size()
    q = torch.from_numpy(queries)
    c = torch.from_numpy(corpus[r * per:(r + 1) * per])
    v, i = torch.topk(q @ c.T, k, dim=1)
    v, i = two_level_topk(v, i + r * per, k, mesh)
    return v.numpy(), i.numpy()


def sharded_2level(queries, corpus, k, tile):
    from cocodr_tpu_torch.parallel.multihost import (
        hybrid_mesh,
        sharded_mips_topk_2level,
    )

    mesh = hybrid_mesh(model=1, force_replicas=2, device="cpu")
    r = dist.get_rank()
    per = corpus.shape[0] // dist.get_world_size()
    v, i = sharded_mips_topk_2level(
        torch.from_numpy(queries),
        torch.from_numpy(corpus[r * per:(r + 1) * per]), r * per, k, mesh,
        tile=tile)
    return v.numpy(), i.numpy()


def hybrid_shape():
    from cocodr_tpu_torch.parallel.multihost import hybrid_mesh, n_slices

    m = hybrid_mesh(model=1, force_replicas=2, device="cpu")
    return {"slices": n_slices(), "shape": tuple(m.shape),
            "names": tuple(m.mesh_dim_names)}


# --- training -------------------------------------------------------------

def _dual_encoder(model_type, sd, **bert_kw):
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import (
        MODEL_REGISTRY,
        DualEncoder,
    )

    cfg = MODEL_REGISTRY[model_type](BertConfig.tiny(**bert_kw),
                                     head_dim=HEAD_DIM)
    model = DualEncoder(cfg)
    model.load_state_dict(sd)
    return model


@contextlib.contextmanager
def _recording(module, name, log, read):
    """module.name wrapped to append read(its result) to log."""
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        log.append(read(out))
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def train(kind, model_type, sd, batches, n_groups=0, total=TOTAL,
          shape=None, dropout_seed=None, lane=False, remat_policy=None):
    """Data-parallel (or with shape = (data, model) tensor-parallel) steps
    of pipelines/train_step.py from the state dict sd, LAMB with a linear
    warmup, dropout off unless dropout_seed, each layer under remat when
    remat_policy is a policy's name -> the losses, each step's
    digest of the parameters and the DroState, the final state dict
    (whole tensors) and h_fun, the clip's global norms, the Gram matrices
    of the iDRO group pass and LAMB's trust ratios after the last step."""
    from cocodr_tpu_torch.core.mesh import data_rank
    from cocodr_tpu_torch.losses import dro as tdro
    from cocodr_tpu_torch.optim import Lamb, warmup_linear
    from cocodr_tpu_torch.parallel.sharded_train import shard_train_init
    from cocodr_tpu_torch.parallel.tp import gather_params_tp
    from cocodr_tpu_torch.pipelines import train_step as ts
    from cocodr_tpu_torch.utils.misc import lamb_trust_ratios

    remat = ({} if remat_policy is None
             else {"remat": True, "remat_policy": remat_policy})
    model = _dual_encoder(model_type, sd, **remat)
    opt = Lamb(model.parameters(), warmup_linear(LR, WARMUP, total),
               eps=1e-6)
    dro = tdro.DroConfig(n_groups=n_groups) if kind != "nll" else None
    extra = tdro.idro_init(dro, device="cpu") if dro else None
    mesh = _mesh(shape)
    state, put = shard_train_init(mesh, model, opt, extra)
    step = ts.build_train_step(ts.TrainStepConfig(
        loss_kind=kind, dro=dro, idro_lane_group_pass=lane,
        idro_lane_grad_dtype="float32"))
    losses, digests, norms, grams = [], [], [], []
    with _recording(ts, "clip_by_global_norm_", norms, float), \
            _recording(tdro, "gram", grams, lambda g: g.numpy().copy()):
        for i, b in enumerate(batches):
            gens = (None if dropout_seed is None else ts.dropout_generators(
                dropout_seed, i, "cpu", data_rank(mesh)))
            out = step(state, put(b), gens)
            loss = out["loss"] if isinstance(out, dict) else out[0]
            losses.append(float(loss))
            tensors = list(state.model.parameters())
            if state.extra is not None:
                tensors += [state.extra.h_fun, state.extra.sum_losses,
                            state.extra.count_cat]
            digests.append(_digest(tensors))
    return {"losses": losses, "digests": digests,
            "params": {k: v.numpy()
                       for k, v in gather_params_tp(model).items()},
            "h_fun": None if state.extra is None
            else state.extra.h_fun.numpy(),
            "norms": norms, "grams": grams,
            "trust": lamb_trust_ratios(opt, model)}


def broadcast_from_rank_0(batch):
    """Every rank builds its own weights (seeded by its rank) and DroState
    (h_fun = rank + 1): shard_train_init gives each rank rank 0's. Then a
    state trained one plain step on this rank's own rows of `batch` (its
    own parameters and LAMB moments): shard_train_setup gives each rank
    rank 0's parameters and moments -> (digest after init, digest after
    setup)."""
    from cocodr_tpu_torch.losses.dro import DroConfig, idro_init
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import (
        MODEL_REGISTRY,
        DualEncoder,
    )
    from cocodr_tpu_torch.optim import Lamb
    from cocodr_tpu_torch.parallel.sharded_train import (
        shard_train_init,
        shard_train_setup,
    )
    from cocodr_tpu_torch.pipelines.train_step import build_train_step
    from cocodr_tpu_torch.utils.train_state import TrainState

    mesh, r = _mesh(), dist.get_rank()
    cfg = MODEL_REGISTRY["rdot_nll"](BertConfig.tiny(), head_dim=HEAD_DIM)
    torch.manual_seed(r)
    model = DualEncoder(cfg)
    extra = idro_init(DroConfig(n_groups=4), device="cpu")
    extra.h_fun.fill_(r + 1.0)
    state, _ = shard_train_init(mesh, model, Lamb(model.parameters(), 1e-3),
                                extra)
    init = _digest(list(model.parameters()) + [extra.h_fun])
    torch.manual_seed(10 + r)
    model = DualEncoder(cfg)
    state = TrainState(model, Lamb(model.parameters(), 1e-3))
    build_train_step()(state, {k: torch.from_numpy(v)
                               for k, v in shard_batch(mesh, batch).items()})
    state, _ = shard_train_setup(mesh, state)
    moments = [v for st in state.optimizer.state.values()
               for v in st.values() if isinstance(v, torch.Tensor)]
    return init, _digest(list(model.parameters()) + moments)


def contrastive(cls_all):
    """This rank's rows of cls_all [B, D] through
    co_contrastive_loss(axis_name=) -> (loss, the rows' gradient)."""
    from cocodr_tpu_torch.losses.contrastive import co_contrastive_loss

    mesh = _mesh()
    rows = shard_batch(mesh, {"x": torch.from_numpy(cls_all)})["x"]
    rows = rows.clone().requires_grad_()
    loss = co_contrastive_loss(rows, axis_name=data_group(mesh))
    loss.backward()
    return float(loss), rows.grad.numpy()


def coco(sd, batches, chunk, late_mlm=True, heads=1, skip=1, shape=None,
         dropout_seed=None):
    """Data-parallel (or with shape = (data, model) tensor-parallel) COCO
    steps (pipelines/coco.py) from the state dict sd, AdamW as
    tests/test_torch_coco.py builds it, dropout off unless dropout_seed ->
    metrics a step, the digests and the final state dict (whole
    tensors)."""
    from cocodr_tpu_torch.core import configs
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.condenser import CoCondenserForPretraining
    from cocodr_tpu_torch.parallel.sharded_train import shard_train_init
    from cocodr_tpu_torch.parallel.tp import gather_params_tp
    from cocodr_tpu_torch.pipelines import coco as tcoco

    model = CoCondenserForPretraining(BertConfig.tiny(), heads, skip,
                                      late_mlm)
    model.load_state_dict(sd)
    opt = configs.OptimizerConfig(
        name="adamw", lr=1e-3, warmup_steps=2, total_steps=10,
        weight_decay=0.01).build(model.parameters())
    state, put = shard_train_init(_mesh(shape), model, opt)
    step = tcoco.build_coco_train_step(tcoco.CocoConfig(
        cache_chunk_size=chunk, max_grad_norm=1.0))
    metrics, digests = [], []
    for b in batches:
        m = step(state, put(b), dropout_seed)
        metrics.append({k: float(v) for k, v in m.items()})
        digests.append(_digest(model.parameters()))
    return {"metrics": metrics, "digests": digests,
            "params": {k: v.numpy()
                       for k, v in gather_params_tp(model).items()}}


# --- encoding -------------------------------------------------------------

class ArrayCache:
    """The TokenCache surface encode_cache reads, over arrays in memory."""

    def __init__(self, ids, mask):
        self.ids, self.mask = ids, mask
        self.max_len = ids.shape[1]

    def __len__(self):
        return len(self.ids)

    def lengths(self):
        return self.mask.sum(1)

    def batch_with_mask(self, idx):
        return self.ids[idx], self.mask[idx]


def encode(model_type, sd, ids, mask, batch_size, buckets=(), chunk_len=0,
           mesh=True):
    """encode_cache (or encode_cache_multivector with chunk_len) of the
    records through Encoder(mesh=) -> the embeddings (and row map)."""
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import (
        MODEL_REGISTRY,
        DualEncoder,
    )
    from cocodr_tpu_torch.pipelines.encode import (
        EncodeConfig,
        Encoder,
        encode_cache,
        encode_cache_multivector,
    )

    kw = {"base_len": chunk_len} if chunk_len else {}
    cfg = MODEL_REGISTRY[model_type](BertConfig.tiny(), head_dim=HEAD_DIM,
                                     **kw)
    model = DualEncoder(cfg)
    model.load_state_dict(sd)
    enc = Encoder(model, mesh=_mesh() if mesh else None, device="cpu")
    ecfg = EncodeConfig(batch_size=batch_size, length_buckets=buckets)
    cache = ArrayCache(ids, mask)
    if chunk_len:
        return encode_cache_multivector(enc, cache, ecfg, chunk_len=chunk_len)
    return encode_cache(enc, cache, ecfg)


def serve(corpus, queries, k, fast=False, exact_fp32=False):
    """The sharded RetrievalService over corpus embeddings, queried with
    token-id strings through a whitespace tokenizer -> (scores, ids)."""
    from cocodr_tpu_torch.pipelines.serve import RetrievalService, ServeConfig

    model = _dual_encoder("rdot_nll", queries["sd"])
    svc = RetrievalService(
        model, _ids_tokenizer, corpus,
        cfg=ServeConfig(top_k=k, max_query_len=8, fast_search=fast,
                        exact_fp32=exact_fp32),
        mesh=_mesh(), device="cpu")
    return svc.search(queries["texts"])


def _ids_tokenizer(texts, padding, truncation, max_length, return_tensors):
    """'3 17 9' -> ids [3, 17, 9] padded with 0 to max_length."""
    ids = np.zeros((len(texts), max_length), np.int64)
    mask = np.zeros_like(ids)
    for i, t in enumerate(texts):
        toks = [int(x) for x in t.split()][:max_length]
        ids[i, :len(toks)] = toks
        mask[i, :len(toks)] = 1
    return {"input_ids": ids, "attention_mask": mask}


# --- tensor parallelism (parallel/tp.py) ----------------------------------

def tp_mesh():
    """The model axis's meshes over this world: create_mesh's (W/2, 2)
    with this rank's place and its model group's ranks, the rows
    shard_batch gives it, and hybrid_mesh's shapes with a model axis of
    2 (one replica, and at W = 4 two forced ones)."""
    from cocodr_tpu_torch.core.mesh import (
        data_rank,
        model_group,
        model_rank,
        model_size,
    )
    from cocodr_tpu_torch.parallel.multihost import hybrid_mesh

    mesh = _mesh((-1, 2))
    out = {"shape": tuple(mesh.shape), "names": tuple(mesh.mesh_dim_names),
           "place": (data_rank(mesh), model_rank(mesh)),
           "model_size": model_size(mesh),
           "model_ranks": dist.get_process_group_ranks(model_group(mesh)),
           "rows": shard_batch(mesh, {"x": np.arange(8)})["x"],
           "hybrid": tuple(hybrid_mesh(model=2, device="cpu").shape)}
    if dist.get_world_size() == 4:
        out["hybrid_forced"] = tuple(
            hybrid_mesh(model=2, force_replicas=2, device="cpu").shape)
    return out


def tp_forward(model_type, sd, ids, mask, shape, attention_impl="einsum"):
    """The query and body embeddings of the records, rows over the data
    axis, weights split over the model axis (shard_params_tp) -> both,
    gathered over the data axis."""
    import dataclasses

    from cocodr_tpu_torch.core.mesh import gather_rows
    from cocodr_tpu_torch.models.dual_encoder import DualEncoder
    from cocodr_tpu_torch.parallel.tp import shard_params_tp

    base = _dual_encoder(model_type, sd)
    cfg = dataclasses.replace(base.cfg, bert=dataclasses.replace(
        base.cfg.bert, attention_impl=attention_impl))
    model = DualEncoder(cfg)
    model.load_state_dict(sd)
    mesh = _mesh(shape)
    shard_params_tp(model.eval(), mesh)
    rows = shard_batch(mesh, {"ids": torch.from_numpy(ids),
                              "mask": torch.from_numpy(mask)})
    with torch.no_grad():
        q = model.query_emb(rows["ids"], rows["mask"])
        d = model.body_emb(rows["ids"], rows["mask"])
    return gather_rows(q, mesh).numpy(), gather_rows(d, mesh).numpy()


def tp_ffn_grads(inputs, cotangent, shape, block):
    """ops.ffn.ffn_block_tp (block) or ffn_tp on this rank's slices of the
    float32 inputs (r or x, then the weights in ffn_block's order) ->
    (the output, the gradient of sum(out * cotangent) for every input,
    the split ones' slices summed whole over the model axis)."""
    from cocodr_tpu_torch.ops.ffn import ffn_block_tp, ffn_tp
    from cocodr_tpu_torch.parallel.tp import axis_of

    axis = axis_of(_mesh(shape))
    full = [torch.from_numpy(a).requires_grad_() for a in inputs]
    split = {3: 0, 4: 0, 5: 1} if block else {1: 0, 2: 0, 3: 1}
    local = []
    for i, t in enumerate(full):
        if i in split:
            k = t.shape[split[i]] // axis.size
            t = t.narrow(split[i], axis.rank * k, k)
        local.append(t)
    if block:
        out = ffn_block_tp(*local, "gelu", 1e-12, axis)
    else:
        out = ffn_tp(*local, "gelu", axis)
    (out * torch.from_numpy(cotangent)).sum().backward()
    for i in split:  # each rank filled its slice of the whole gradient
        dist.all_reduce(full[i].grad, group=axis.group)
    return out.detach().numpy(), [t.grad.numpy() for t in full]


def _tp_state(sd, shape):
    from cocodr_tpu_torch.optim import Lamb, warmup_linear
    from cocodr_tpu_torch.parallel.sharded_train import shard_train_init
    from cocodr_tpu_torch.utils.train_state import TrainState

    model = _dual_encoder("rdot_nll", sd)
    opt = Lamb(model.parameters(), warmup_linear(LR, WARMUP, TOTAL),
               eps=1e-6)
    if shape is None:
        return TrainState(model, opt), None
    return shard_train_init(_mesh(shape), model, opt)


def _whole_state(state):
    """-> (step, the whole parameters, the whole LAMB moments by parameter
    name), numpy."""
    from cocodr_tpu_torch.parallel.tp import (
        gather_optimizer_state,
        gather_params_tp,
    )

    model, opt = state.model, state.optimizer
    names = [n for n, _ in model.named_parameters()]
    osd = gather_optimizer_state(opt, opt.state_dict())
    return state.step, {k: v.numpy() for k, v in
                        gather_params_tp(model).items()}, {
        names[i]: {k: v.numpy() for k, v in st.items()}
        for i, st in osd["state"].items()}


def tp_checkpoint(sd, batches, root, shape, save):
    """save: a state at shape trains on the batches (nll, LAMB, dropout
    off) and saves a checkpoint under root, and another under root +
    '_async' through AsyncSaver; else a fresh state at shape (None: one
    device) loads the newest one under root. -> _whole_state's."""
    from cocodr_tpu_torch.pipelines.train_step import build_train_step
    from cocodr_tpu_torch.utils.train_state import (
        AsyncSaver,
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )

    state, put = _tp_state(sd, shape)
    if save:
        step = build_train_step()
        for b in batches:
            step(state, put(b))
        save_checkpoint(root, state)
        saver = AsyncSaver()
        saver.save(root + "_async", state)
        saver.close()
    else:
        load_checkpoint(latest_checkpoint(root), state)
    return _whole_state(state)


def tp_load_jax(sd, jax_state, shape):
    """models/convert.py::load_jax_train_state of a JAX LAMB TrainState
    (its trees as plain dicts of numpy arrays) into a fresh state at shape
    (None: one device) -> _whole_state's."""
    from cocodr_tpu_torch.models.convert import load_jax_train_state

    state, _ = _tp_state(sd, shape)
    load_jax_train_state(state, jax_state, state.model.cfg)
    return _whole_state(state)
