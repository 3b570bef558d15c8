"""ANCE asynchronous hard-negative mining and training: the counterpart of
cocodr_tpu/pipelines/ance.py (reference ANCE/drivers/run_ann_data_gen.py,
the producer, and ANCE/drivers/run_ann.py, the consumer), the two coupled
only through the filesystem:

  miner:   newest valid checkpoint -> encode corpus + queries -> exact MIPS
           top-k -> filter positives/dupes -> sample negatives -> write
           ann_training_data_{n} (+ weight/group columns when clustering)
           and ann_ndcg_{n} JSON {ndcg, mrr, checkpoint}
  trainer: polls for new ann files, rebuilds the triplet stream, trains
           with (i)DRO group weights (any step of pipelines/train_step.py),
           checkpoints with the DONE-marker protocol

Negatives always come from an older checkpoint: that lag is part of
ANCE's published behaviour. `ance_round` is the single-program
time-multiplexed mode (mine, then train N steps); `mine_loop` /
`train_loop` keep the two-job async mode. FAISS IndexFlatIP and Kmeans
are parallel/topk.py::search_topk and ops/kmeans.py on the device.

`mine` puts the corpus embeddings on the device once a round
(`place_corpus`) and both its searches read that one tensor. A multi-chunk
model's corpus is one row a real chunk (`encode_cache_multivector`, its
emb cache `corpus_{ckpt}_mv.npy` with the row -> document map beside it
in `.rows.npy`); the searches run over the rows, and their ids map back to
documents before the dev metrics (deduped) and the negatives. Not ported
yet, each raising NotImplementedError naming its ROADMAP.md Queue 1 item:
`search_method="ivf"` (item 7), a mesh and `device_put` (item 11).
"""
from __future__ import annotations

import copy
import dataclasses
import glob
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from cocodr_tpu_torch.data.prefetch import prefetch
from cocodr_tpu_torch.data.streams import (
    shuffled_ann_lines,
    triplets_from_ann_lines,
)
from cocodr_tpu_torch.evals.metrics import evaluate_run, run_from_topk
from cocodr_tpu_torch.losses.dro import DroState, dro_state_summary
from cocodr_tpu_torch.ops._device import resolve_device
from cocodr_tpu_torch.ops.kmeans import kmeans
from cocodr_tpu_torch.ops.mips import N_REAL_METHODS, resolve_search_method
from cocodr_tpu_torch.parallel.topk import search_topk
from cocodr_tpu_torch.pipelines.encode import (
    EncodeConfig,
    Encoder,
    encode_cache,
    encode_cache_multivector,
)
from cocodr_tpu_torch.pipelines.train_step import dropout_generators
from cocodr_tpu_torch.utils.misc import read_group_results
from cocodr_tpu_torch.utils.train_state import (
    PAYLOAD,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)

# the placed corpus's row multiple for the methods that honour n_real
# (ops/mips_hier.py pads to max(tile 2048, 64-row coarse blocks))
CORPUS_ROW_MULTIPLE = 2048
# host rows cast per step while the corpus is placed
_PLACE_ROWS = 131072


@dataclasses.dataclass
class MineConfig:
    topk_training: int = 200  # candidates per query (ANCE/README.md)
    negative_sample: int = 30  # kept negatives
    select_topk: bool = True  # top-(n+1) vs random-from-candidates
    n_splits: int = 5  # negative slices per ann file (data_gen.py:408-423)
    cluster_query: bool = False  # k-means groups for iDRO
    cluster_centroids: int = 50
    # faiss.Kmeans defaults in the reference: niter=500, nredo=5
    # (ANCE/drivers/run_ann_data_gen.py:343-352); lower iters is a speed knob
    kmeans_iters: int = 500
    kmeans_redo: int = 5
    dev_topk: int = 100
    batch_size: int = 512
    q_chunk: int = 4096
    mips_tile: int = 32768
    exact_fp32: bool = False  # float32 sweep (FAISS-bit parity)
    # a method of ops/mips.py for the dev and train searches: 'auto'
    # (= 'pallas', the exact kernel search), 'pallas', 'exact2', 'fast'
    # (rescore-free block argmax), 'blockmax', 'refined', 'naive'; 'ivf'
    # raises unless exact_fp32 (ROADMAP.md Queue 1 item 7). Ignored with
    # exact_fp32.
    search_method: str = "auto"
    ivf_nprobe: int = 32  # inert until item 7; kept so configs carry over
    # length-bucketed corpus encode: ascending widths, the last >= the
    # cache's max_len (e.g. (64, 128)); () = single-width encode
    length_buckets: tuple = ()
    # mine each round over 1/chunk_factor of the train queries, rotating by
    # round (reference ann_chunk_factor, data_gen.py:332-386); <=1 disables.
    # ignored when cluster_query=True, matching the reference.
    ann_chunk_factor: int = 1
    # cache corpus embeddings under this dir and reuse them for the same
    # checkpoint (reference embedding_dir_exist/load_embedding,
    # data_gen.py:438-495); the files are the JAX package's
    emb_cache_dir: str = ""
    # keep only the newest N cached corpus embeddings (27 GB each in
    # float32 at MS MARCO's 8.8M passages); 0 = keep all. The reference's
    # --only_keep_latest_embedding_file bounds the same cost by
    # overwriting one file (data_gen.py:972-973).
    emb_cache_keep: int = 2
    seed: int = 0


def _prune_emb_cache(cache_dir: str, keep: int) -> None:
    """Drop all but the `keep` newest corpus_*.npy caches (and their
    .rows.npy sidecars): each is corpus-sized."""
    files = sorted(
        (f for f in glob.glob(os.path.join(cache_dir, "corpus_*.npy"))
         if not f.endswith(".rows.npy")),
        key=os.path.getmtime, reverse=True,
    )
    for f in files[keep:]:
        for victim in (f, f.replace(".npy", ".rows.npy")):
            try:
                os.remove(victim)
            except OSError:
                pass


def ann_data_path(out_dir: str, n: int) -> str:
    return os.path.join(out_dir, f"ann_training_data_{n}")


def ann_ndcg_path(out_dir: str, n: int) -> str:
    return os.path.join(out_dir, f"ann_ndcg_{n}")


def get_latest_ann_data(out_dir: str):
    """(n, data_path, ndcg_json or None); n = -1 when absent (reference
    ANCE/drivers/run_ann.py:263-287)."""
    best = -1
    for p in glob.glob(os.path.join(out_dir, "ann_ndcg_*")):
        try:
            n = int(p.rsplit("_", 1)[1])
        except ValueError:
            continue
        if n > best and os.path.exists(ann_data_path(out_dir, n)):
            best = n
    if best < 0:
        return -1, None, None
    with open(ann_ndcg_path(out_dir, best)) as f:
        meta = json.load(f)
    return best, ann_data_path(out_dir, best), meta


def generate_negatives(
    top_ids: np.ndarray,
    query_ids: np.ndarray,
    positives: Dict[int, int],
    cfg: MineConfig,
    rng: np.random.RandomState,
):
    """Per-query negatives + self-MRR (reference GenerateNegativePassaageID,
    data_gen.py:497-570) -> ({qid: negatives}, {qid: reciprocal rank of
    the positive}). top_ids rows are corpus offsets (== pids in offset
    space), -1 for padding; queries without a positive are skipped. With
    select_topk the candidates are a row's first negative_sample + 1,
    else the whole row in an order drawn from rng; the positive, -1 and
    repeats are dropped."""
    negatives: Dict[int, List[int]] = {}
    mrr_scores: Dict[int, float] = {}
    for row, qid in zip(top_ids, query_ids):
        qid = int(qid)
        if qid not in positives:
            continue
        pos_pid = positives[qid]
        ranks = np.nonzero(row == pos_pid)[0]
        mrr_scores[qid] = 1.0 / (ranks[0] + 1) if len(ranks) else 0.0
        if cfg.select_topk:
            cand = row[: cfg.negative_sample + 1]
        else:
            cand = row[rng.permutation(len(row))]
        negs: List[int] = []
        for pid in cand:
            pid = int(pid)
            if pid == pos_pid or pid < 0 or pid in negs:
                continue
            negs.append(pid)
            if len(negs) >= cfg.negative_sample:
                break
        negatives[qid] = negs
    return negatives, mrr_scores


def write_ann_data(
    path: str,
    negatives: Dict[int, List[int]],
    positives: Dict[int, int],
    cfg: MineConfig,
    rng: np.random.RandomState,
    clusters: Optional[Dict[int, int]] = None,
    weights: Optional[Dict[int, float]] = None,
):
    """The n_splits-split ann file, queries in an order drawn from rng
    (data_gen.py:403-429): split s holds each query's s-th slice of
    len(negatives) // n_splits negatives, as `qid \\t pos \\t negs` lines,
    or with clusters `qid \\t pos \\t negs \\t weight \\t group`. Written to
    path + '.tmp' and renamed."""
    qids = list(negatives.keys())
    with open(path + ".tmp", "w") as f:
        order = rng.permutation(len(qids))
        for split in range(cfg.n_splits):
            for i in order:
                qid = qids[i]
                negs = negatives[qid]
                n5 = len(negs) // cfg.n_splits
                sl = negs[split * n5 : (split + 1) * n5]
                if not sl:
                    continue
                neg_str = ",".join(str(p) for p in sl)
                if clusters is not None:
                    w = 1.0 if weights is None else weights.get(qid, 1.0)
                    f.write(
                        f"{qid}\t{positives[qid]}\t{neg_str}\t{w:.4f}\t"
                        f"{clusters[qid]}\n"
                    )
                else:
                    f.write(f"{qid}\t{positives[qid]}\t{neg_str}\n")
    os.replace(path + ".tmp", path)


def place_corpus(corpus_emb, method: str = "auto", exact_fp32: bool = False,
                 device="cuda"):
    """Put corpus embeddings [N, D] (a numpy array or a tensor, float32 or
    bf16, on any device) on `device` once, as both of a round's searches
    read them -> (tensor, n_real).

    exact_fp32: float32 rows, n_real 0. Otherwise bf16 rows for every
    method, so 'refined' rescores bf16 rows: for a method that honours
    n_real (ops/mips.py::N_REAL_METHODS: 'pallas', 'fast', and 'auto',
    which resolves to 'pallas') the rows are replicate-padded to a
    multiple of CORPUS_ROW_MULTIPLE by copies of the last row and n_real is
    N, so the search pads nothing per call; the other methods get the N
    rows unpadded and n_real 0 (each pads per call as it must: a padded
    corpus would let rows >= N into their results). The rows are cast in
    steps of _PLACE_ROWS into one preallocated tensor: no float32 copy of
    the whole corpus on the device, no bf16 copy of it on the host. A
    tensor already on the device in the right dtype and row count is used
    as it is."""
    dev = resolve_device(device)
    dtype = torch.float32 if exact_fp32 else torch.bfloat16
    pad_rows = (not exact_fp32
                and resolve_search_method(method) in N_REAL_METHODS)
    src = torch.as_tensor(corpus_emb)  # a numpy array's memory, no copy
    n, d = src.shape
    rows = n + ((-n) % CORPUS_ROW_MULTIPLE if pad_rows else 0)
    n_real = n if pad_rows else 0
    if src.device == dev and src.dtype == dtype and rows == n:
        return src, n_real
    out = torch.empty((rows, d), dtype=dtype, device=dev)
    for s in range(0, n, _PLACE_ROWS):
        part = src[s:s + _PLACE_ROWS]
        out[s:s + len(part)].copy_(part.to(dev))  # cast on the device
    if rows > n:
        out[n:].copy_(out[n - 1:n].expand(rows - n, d))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, n_real


def mine(
    model,
    params,
    passage_cache,
    train_query_cache,
    train_positives: Dict[int, int],
    dev_query_cache,
    dev_qrels: Dict[int, Dict[int, int]],
    out_dir: str,
    output_num: int,
    cfg: MineConfig = MineConfig(),
    mesh=None,
    checkpoint_name: str = "",
    corpus_emb=None,
    device="cuda",
) -> Dict[str, float]:
    """One mining round on `device` (the card unless the caller passes
    device="cpu") -> the dev metrics it logged, plus a `time_*` host-clock
    breakdown of its phases (corpus_encode, corpus_to_device, dev_eval,
    train_encode, train_search, negatives, cluster, write) and time_total.

    model: a models.dual_encoder.DualEncoder; params: a state dict loaded
    into a copy of it, or None for the model's own weights (the caller's
    model is never changed). The corpus embeddings come from corpus_emb
    when given, else from the emb cache (cfg.emb_cache_dir, the JAX
    package's corpus_{checkpoint}.npy files) or a fresh encode of
    passage_cache; either way they reach the device once (`place_corpus`)
    before the dev and the train search. Writes ann_training_data_{n} and
    ann_ndcg_{n} under out_dir (n = output_num); with cfg.cluster_query
    each train query's group is its k-means cluster (ops/kmeans.py).

    A multi-chunk model over records wider than its chunk_len searches
    one row a real chunk: the encode (or the `_mv` emb cache and its
    `.rows.npy` map) gives the rows, `place_corpus` places them (n_real
    the row count), and the top ids map to documents before the dev
    metrics (deduped) and the negatives; a corpus_emb the caller passes
    is searched as documents, as in the JAX package."""
    if mesh is not None:
        raise NotImplementedError(
            "mining over a mesh is not ported yet: ROADMAP.md Queue 1 "
            "item 11 (parallel/*)"
        )
    if cfg.search_method == "ivf" and not cfg.exact_fp32:
        raise NotImplementedError(
            "search_method='ivf' is not ported yet: ROADMAP.md Queue 1 "
            "item 7 (ops/ivf.py)"
        )
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    timings: Dict[str, float] = {}
    _t = time.time()

    def _mark(phase):
        nonlocal _t
        now = time.time()
        timings[phase] = timings.get(phase, 0.0) + (now - _t)
        _t = now

    rng = np.random.RandomState(cfg.seed + output_num)
    ecfg = EncodeConfig(batch_size=cfg.batch_size,
                        length_buckets=cfg.length_buckets)
    if params is not None:
        model = copy.deepcopy(model)
        model.load_state_dict(params)
    q_enc = Encoder(model, is_query=True, device=dev)
    chunk_len = model.cfg.chunk_len
    multivector = bool(chunk_len) and passage_cache.max_len > chunk_len
    row2doc = None
    if corpus_emb is None:
        emb_file = None
        if cfg.emb_cache_dir and checkpoint_name:
            os.makedirs(cfg.emb_cache_dir, exist_ok=True)
            safe = checkpoint_name.replace(os.sep, "_")
            suffix = "_mv" if multivector else ""
            emb_file = os.path.join(cfg.emb_cache_dir,
                                    f"corpus_{safe}{suffix}.npy")
        if emb_file and os.path.exists(emb_file):
            os.utime(emb_file)  # LRU: a reused cache is the one to keep
            corpus_emb = np.load(emb_file)
            if multivector:
                row2doc = np.load(emb_file.replace(".npy", ".rows.npy"))
        else:
            d_enc = Encoder(model, is_query=False, device=dev)
            if multivector:
                corpus_emb, row2doc = encode_cache_multivector(
                    d_enc, passage_cache, ecfg, chunk_len=chunk_len)
            else:
                corpus_emb = encode_cache(d_enc, passage_cache, ecfg)
            del d_enc
            if emb_file:
                np.save(emb_file + ".tmp.npy", corpus_emb)
                os.replace(emb_file + ".tmp.npy", emb_file)
                if multivector:
                    np.save(emb_file.replace(".npy", ".rows.npy"), row2doc)
        if emb_file and cfg.emb_cache_keep > 0:
            _prune_emb_cache(cfg.emb_cache_dir, cfg.emb_cache_keep)
    _mark("corpus_encode")

    corpus, n_real = place_corpus(corpus_emb, cfg.search_method,
                                  cfg.exact_fp32, dev)
    n_docs = n_real or corpus.shape[0]
    _mark("corpus_to_device")

    def search(queries, k):
        """-> top ids as documents (a multi-chunk corpus's rows mapped)."""
        _, top = search_topk(
            queries, corpus, k, q_chunk=cfg.q_chunk, tile=cfg.mips_tile,
            exact_fp32=cfg.exact_fp32, method=cfg.search_method,
            n_real=n_real, device=dev)
        if row2doc is None:
            return top
        return np.where(top >= 0, row2doc[top], -1)

    # dev eval at this checkpoint (data_gen.py:306-319)
    dev_emb = encode_cache(q_enc, dev_query_cache, ecfg)
    k = min(cfg.dev_topk, n_docs)
    dev_top = search(dev_emb, k)
    dev_run = run_from_topk(list(range(len(dev_emb))), dev_top,
                            dedupe=row2doc is not None)
    dev_metrics = evaluate_run(dev_run, dev_qrels, recall_ks=(k,))
    _mark("dev_eval")

    # train-query encode + mine; without clustering, rotate over
    # 1/chunk_factor of the queries per round (data_gen.py:375-386)
    n_train = len(train_query_cache)
    if cfg.ann_chunk_factor > 1 and not cfg.cluster_query:
        per = n_train // cfg.ann_chunk_factor
        eff = output_num % cfg.ann_chunk_factor
        start = per * eff
        end = n_train if eff == cfg.ann_chunk_factor - 1 else start + per
        query_ids = np.arange(start, end)
    else:
        query_ids = np.arange(n_train)
    train_emb = encode_cache(q_enc, train_query_cache, ecfg,
                             indices=query_ids)
    _mark("train_encode")
    train_top = search(train_emb, min(cfg.topk_training, n_docs))
    del corpus
    _mark("train_search")
    negatives, _ = generate_negatives(train_top, query_ids, train_positives,
                                      cfg, rng)
    _mark("negatives")

    clusters = weights = None
    if cfg.cluster_query:
        _, assign = kmeans(train_emb, cfg.cluster_centroids,
                           n_iter=cfg.kmeans_iters, n_redo=cfg.kmeans_redo,
                           seed=cfg.seed, device=dev)
        assign = assign.cpu().numpy()
        clusters = {int(query_ids[pos]): int(assign[pos])
                    for pos in range(len(train_emb))}
        weights = {q: 1.0 for q in clusters}  # the reference writes 1
    _mark("cluster")

    write_ann_data(ann_data_path(out_dir, output_num), negatives,
                   train_positives, cfg, rng, clusters=clusters,
                   weights=weights)
    ndcg_path = ann_ndcg_path(out_dir, output_num)
    with open(ndcg_path + ".tmp", "w") as f:
        json.dump({"ndcg": dev_metrics["ndcg_cut_10"],
                   "mrr": dev_metrics["recip_rank"],
                   "checkpoint": checkpoint_name}, f)
    os.replace(ndcg_path + ".tmp", ndcg_path)
    _mark("write")
    for phase, secs in timings.items():
        dev_metrics[f"time_{phase}"] = secs
    dev_metrics["time_total"] = sum(timings.values())
    return dev_metrics


def batch_arrays(tb) -> dict:
    """A data.streams.TripletBatch -> the step's batch of numpy arrays."""
    return {"q_ids": tb.query_ids, "q_mask": tb.query_mask,
            "pos_ids": tb.pos_ids, "pos_mask": tb.pos_mask,
            "neg_ids": tb.neg_ids, "neg_mask": tb.neg_mask,
            "groups": tb.groups, "weights": tb.weights}


def train_on_ann_file(state, train_step: Callable, batcher, ann_file: str,
                      batch_size: int, max_steps: Optional[int] = None,
                      seed: int = 0, device_put=None,
                      metrics_cb: Optional[Callable] = None,
                      dropout_seed: Optional[int] = 0):
    """Consume one ann file (reference run_ann.py:240-356) -> (state,
    steps taken); `state` (utils.train_state.TrainState) is updated in
    place.

    The file's lines are shuffled by `seed`, expanded into triplets and
    batched by `batcher` (data.streams.TripletBatcher over the query and
    passage token caches); the trailing partial batch is dropped. Batches
    are gathered two ahead on a prefetch thread, and sent to the card
    there when the model lies on it. dropout_seed: trains with dropout,
    the step's three generators seeded from (dropout_seed, state.step,
    tower), so a resumed run draws the same masks
    (train_step.dropout_generators; the JAX package folds the step into
    one key); None trains in eval mode, without dropout. metrics_cb(step,
    metrics) after every step, metrics being the DRO kinds' dict or
    {"loss", "acc"} for 'nll'. device_put (the JAX package's placement
    over a mesh) raises: ROADMAP.md Queue 1 item 11."""
    if device_put is not None:
        raise NotImplementedError(
            "device_put (sharded placement) is not ported yet: ROADMAP.md "
            "Queue 1 item 11 (parallel/*)"
        )
    dev = next(state.model.parameters()).device
    with open(ann_file) as f:
        lines = shuffled_ann_lines(f.readlines(), seed)

    def collate_stream():
        for tb in batcher.batches(triplets_from_ann_lines(lines),
                                  batch_size):
            yield batch_arrays(tb)

    steps = 0
    for arrays in prefetch(collate_stream(), depth=2,
                           device_put=dev.type == "cuda"):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in arrays.items()}
        gens = (None if dropout_seed is None
                else dropout_generators(dropout_seed, state.step, dev))
        out = train_step(state, batch, gens)
        steps += 1
        if metrics_cb:
            metrics = (out if isinstance(out, dict)
                       else {"loss": out[0], "acc": out[1]})
            metrics_cb(state.step, metrics)
        if max_steps and steps >= max_steps:
            break
    return state, steps




def ance_round(
    state,
    train_step: Callable,
    batcher,
    passage_cache,
    train_query_cache,
    train_positives: Dict[int, int],
    dev_query_cache,
    dev_qrels: Dict[int, Dict[int, int]],
    work_dir: str,
    round_idx: int,
    mine_cfg: MineConfig,
    batch_size: int,
    steps_per_round: int,
    mesh=None,
    metrics_cb: Optional[Callable] = None,
    dropout_seed: Optional[int] = 0,
    device_put=None,
    device="cuda",
):
    """Time-multiplexed ANCE: mine with state.model's weights as they are
    (checkpoint name `step-{state.step}`), then train up to
    steps_per_round steps on the fresh negatives (train_on_ann_file, lines
    shuffled by round_idx) -> (state, the mine's dev metrics, steps
    taken). One device, no polling, the same staleness as the async pair:
    the negatives were mined before the round's updates. The JAX function
    takes the flax module as `model`; here state.model is the model."""
    dev_metrics = mine(
        state.model, None, passage_cache, train_query_cache,
        train_positives, dev_query_cache, dev_qrels, work_dir, round_idx,
        mine_cfg, mesh=mesh, checkpoint_name=f"step-{int(state.step)}",
        device=device,
    )
    state, steps = train_on_ann_file(
        state, train_step, batcher, ann_data_path(work_dir, round_idx),
        batch_size, max_steps=steps_per_round, seed=round_idx,
        metrics_cb=metrics_cb, dropout_seed=dropout_seed,
        device_put=device_put,
    )
    return state, dev_metrics, steps


def checkpoint_params_loader(ckpt_dir: str, template_state,
                             initial: bool = True):
    """params_loader for mine_loop: a function -> (name, model state dict)
    of the newest valid (DONE-marked) checkpoint, read from its state.pt's
    model entry alone (memory-mapped: the optimizer's moments are not
    read), or None when there is none.

    Mirrors latest_checkpoint's validity protocol (reference
    ANCE/drivers/run_ann.py:51-67; the DONE marker plays scheduler.pt's
    role). With initial=True an empty checkpoint dir yields ("initial",
    template_state.model's state dict) so the first mining round runs from
    the warmup weights before the trainer has saved anything, as the
    reference miner falls back to the initial model path
    (run_ann_data_gen.py:57-73); the async pair would otherwise deadlock
    at startup (miner waiting for a checkpoint, trainer for ann data)."""

    def load():
        path = latest_checkpoint(ckpt_dir)
        if path is None:
            if not initial:
                return None
            return "initial", template_state.model.state_dict()
        payload = torch.load(os.path.join(path, PAYLOAD), map_location="cpu",
                             weights_only=True, mmap=True)
        return os.path.basename(path), payload["model"]

    return load


def _progress_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "ann_progress.json")


def _read_progress(ckpt_dir: str) -> int:
    try:
        with open(_progress_path(ckpt_dir)) as f:
            return int(json.load(f)["last_ann"])
    except (OSError, ValueError, KeyError):
        return -1


def _write_progress(ckpt_dir: str, last_ann: int):
    tmp = _progress_path(ckpt_dir) + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"last_ann": last_ann}, f)
    os.replace(tmp, _progress_path(ckpt_dir))


def write_group_ndcg(result_dir: str, task: str, n: int, ndcg: float,
                     checkpoint: str = ""):
    """Per-BEIR-task group result file `ann_ndcg_group_{task}_{n}`: the
    writer half of the protocol whose reader is
    utils.misc.read_group_results (reference ANCE/drivers/run_ann.py:
    270-284 reads these; the reference never shipped the writer)."""
    os.makedirs(result_dir, exist_ok=True)
    path = os.path.join(result_dir, f"ann_ndcg_group_{task}_{n}")
    with open(path + ".tmp", "w") as f:
        json.dump({"ndcg": ndcg, "checkpoint": checkpoint}, f)
    os.replace(path + ".tmp", path)


def train_loop(
    state,
    train_step: Callable,
    batcher,
    ann_dir: str,
    ckpt_dir: str,
    batch_size: int,
    poll_secs: float = 30.0,
    max_ann_files: Optional[int] = None,
    steps_per_file: Optional[int] = None,
    metrics_cb: Optional[Callable] = None,
    resume: bool = True,
    dropout_seed: Optional[int] = 0,
    metrics_logger=None,
    saver=None,
    group_result_dir: Optional[str] = None,
    device_put=None,
):
    """Async consumer: poll ann_dir for a newer ann file, train on it
    (train_on_ann_file, lines shuffled by the file's number), checkpoint
    (reference ANCE/drivers/run_ann.py:220-285 polling + :376-403 saves)
    -> the state after max_ann_files files (forever when None).

    resume: restore the newest DONE checkpoint (model, optimizer, step and
    DRO state, reference run_ann.py:150-159,998-1002) and skip the ann
    files already consumed (recorded in ckpt_dir/ann_progress.json, which
    is written after the checkpoint so it never runs ahead of one; three
    checkpoints are kept). metrics_logger: a utils.logging.MetricsLogger;
    the mined dev nDCG/MRR are logged at the step where a file is
    consumed, with the per-BEIR-task group curves read from
    group_result_dir (reference run_ann.py:270-284), and after it the
    file's steps and the DRO state's scalars. saver: a
    utils.train_state.AsyncSaver, which writes the progress record after
    the checkpoint's DONE marker (None: both written synchronously);
    device_put raises: item 11."""
    if device_put is not None:
        raise NotImplementedError(
            "device_put (sharded placement) is not ported yet: ROADMAP.md "
            "Queue 1 item 11 (parallel/*)"
        )
    seen = -1
    if resume:
        ck = latest_checkpoint(ckpt_dir)
        if ck:
            load_checkpoint(ck, state)
            seen = _read_progress(ckpt_dir)
    consumed = 0
    while max_ann_files is None or consumed < max_ann_files:
        n, data_path, meta = get_latest_ann_data(ann_dir)
        if n <= seen:
            time.sleep(poll_secs)
            continue
        seen = n
        if metrics_logger is not None and meta:
            mined = {"dev_ndcg": meta.get("ndcg", 0.0),
                     "dev_mrr": meta.get("mrr", 0.0)}
            if group_result_dir:
                for name, res in read_group_results(group_result_dir).items():
                    mined[f"ann_ndcg_group_{name}"] = res.get("ndcg", 0.0)
            metrics_logger.log(int(state.step), mined, prefix="ance/")
        state, steps = train_on_ann_file(
            state, train_step, batcher, data_path, batch_size,
            max_steps=steps_per_file, seed=n, metrics_cb=metrics_cb,
            dropout_seed=dropout_seed,
        )
        if metrics_logger is not None:
            rec = {"ann_file": n, "steps": steps}
            if isinstance(state.extra, DroState):
                # the reference dumps per-group h_fun / running losses via
                # output_state() (ANCE/model/models.py:275-280)
                rec.update({k: v for k, v in
                            dro_state_summary(state.extra).items()
                            if not isinstance(v, list)})
            metrics_logger.log(int(state.step), rec, prefix="ance/")
        # the progress record never runs ahead of a valid checkpoint: a
        # crash between them would resume from an older checkpoint and skip
        # this file's training
        if saver is not None:
            saver.save(ckpt_dir, state, keep=3,
                       on_complete=lambda n=n: _write_progress(ckpt_dir, n))
        else:
            save_checkpoint(ckpt_dir, state, keep=3)
            _write_progress(ckpt_dir, n)
        consumed += 1
    if saver is not None:
        saver.wait()
    return state


def mine_loop(
    model,
    params_loader: Callable[[], Optional[tuple]],
    out_dir: str,
    poll_secs: float = 60.0,
    max_rounds: Optional[int] = None,
    **mine_kwargs,
):
    """Async producer: poll params_loader (checkpoint_params_loader) for a
    new checkpoint, mine when one appears (`mine(model, params, ...)`,
    numbered after the newest ann file in out_dir; mine_kwargs are mine's
    other arguments, device among them), until max_rounds rounds
    (reference evaluate/drivers/run_ann_data_gen.py:695-719)."""
    last_ckpt = None
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        loaded = params_loader()
        if loaded is None:
            time.sleep(poll_secs)
            continue
        ckpt_name, params = loaded
        if ckpt_name == last_ckpt:
            time.sleep(poll_secs)
            continue
        n, _, _ = get_latest_ann_data(out_dir)
        mine(model, params, out_dir=out_dir, output_num=n + 1,
             checkpoint_name=ckpt_name, **mine_kwargs)
        last_ckpt = ckpt_name
        rounds += 1
