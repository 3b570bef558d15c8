"""Tensor parallelism over the mesh's `model` axis: the counterpart of
cocodr_tpu/parallel/tp.py.

The split is Megatron's, by the JAX package's path rules, written here in
nn.Linear layout (weight [out, in]) for the parameters of every BertLayer
(the encoder's layers and a Condenser's c_head):
  - query, key and value split their weight's rows and their bias: each
    model rank holds N / M heads (JAX splits the kernel's N axis);
  - the attention output dense splits its weight's columns (the input
    heads); its bias stays whole;
  - intermediate (the FFN's up projection) splits its weight's rows and
    its bias over F; output.dense (the down projection) its weight's
    columns; its bias stays whole;
  - everything else is replicated: embeddings, LayerNorms, poolers, the
    heads, the MLM head.
Model rank m holds the m-th of M equal contiguous slices, as a
NamedSharding places the m-th shard of an axis on model index m.

GSPMD inserts the collectives in the JAX package; here the layer calls
them (models/bert.py), as Megatron's two conjugate functions:
  f (`copy_to_model`): identity forward, all-reduce of the gradient over
     the model axis in the backward, where a replicated activation enters
     the split weights;
  g (`reduce_from_model`): all-reduce over the model axis forward,
     identity backward, where the split products' partial sums leave them.
Both sum in float32 (a bf16 gradient or partial is rounded once, after
the sum).
(torch.distributed.nn.functional.all_reduce is not g: its backward
all-reduces again.)

A split Parameter carries `tp_dim` (the dimension split) and `tp_axis`
(the model axis's TpAxis); the train step's clip, the iDRO group pass and
LAMB's trust ratios read them to sum the squared norms and products of
split tensors over the axis and count replicated ones once. Checkpoints
hold the full tensors whatever the mesh (`gather_params_tp`,
`split_state_dict`); inference (encode, serve, eval, mining) runs from an
unsplit copy (`unsplit_copy`), rows sharded over `data` only, as the JAX
package replicates its parameters there.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.distributed as dist

# parameter name within a BertLayer -> the nn.Linear dimension it splits
TP_RULES = {
    "attention.self.query.weight": 0,
    "attention.self.query.bias": 0,
    "attention.self.key.weight": 0,
    "attention.self.key.bias": 0,
    "attention.self.value.weight": 0,
    "attention.self.value.bias": 0,
    "attention.output.dense.weight": 1,
    "intermediate.dense.weight": 0,
    "intermediate.dense.bias": 0,
    "output.dense.weight": 1,
}


class TpAxis:
    """The model axis a split module computes over: its process group, its
    size M and this rank's place m on it. A copy of a module shares it."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def __deepcopy__(self, memo):
        return self


def axis_of(mesh) -> Optional[TpAxis]:
    """The mesh's model axis as a TpAxis, None for a model axis of 1 or no
    mesh."""
    from cocodr_tpu_torch.core.mesh import model_group, model_rank, model_size

    if model_size(mesh) == 1:
        return None
    return TpAxis(model_group(mesh), model_size(mesh), model_rank(mesh))


def _layers(model):
    """(name prefix, BertLayer) of every BertLayer of the model."""
    from cocodr_tpu_torch.models.bert import BertLayer

    return [(name + "." if name else "", m)
            for name, m in model.named_modules() if isinstance(m, BertLayer)]


def tp_param_shardings(model) -> dict:
    """{parameter name: the dimension it splits on, or None (replicated)}
    for every parameter of the model."""
    out = {name: None for name, _ in model.named_parameters()}
    for prefix, layer in _layers(model):
        for name, _ in layer.named_parameters():
            out[prefix + name] = TP_RULES.get(name)
    return out


def split_dim(p) -> Optional[int]:
    """The dimension a split Parameter holds a slice of; None if it is
    whole."""
    return getattr(p, "tp_dim", None)


def split_axis(params) -> Optional[TpAxis]:
    """The model axis of the first split parameter among params, or None
    when none is split."""
    for p in params:
        if split_dim(p) is not None:
            return p.tp_axis
    return None


def is_split(model) -> bool:
    return split_axis(model.parameters()) is not None


def _slice(full, dim: int, axis: TpAxis):
    n = full.shape[dim]
    if n % axis.size:
        raise ValueError(f"a dimension of {n} does not split over a model "
                         f"axis of {axis.size}")
    k = n // axis.size
    return full.narrow(dim, axis.rank * k, k)


def local_slice(p, full):
    """This rank's slice of `full`, a whole tensor of p's parameter (the
    parameter itself, a moment, a gradient); full itself when p is
    whole."""
    dim = split_dim(p)
    if dim is None or full.shape == p.shape:
        return full
    return _slice(full, dim, p.tp_axis).contiguous()


def gather_tensor(p, t):
    """The whole tensor from each model rank's slice t of split parameter
    p (a collective over its model axis); t itself when p is whole."""
    dim = split_dim(p)
    if dim is None:
        return t
    axis = p.tp_axis
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t.contiguous(), group=axis.group)
    return torch.cat(parts, dim)


def shard_params_tp(model, mesh):
    """Cut each rule-matched Parameter of the model to this rank's slice,
    in place (the Parameter objects stay, so an optimizer built over them
    keeps them), and give every BertLayer the model axis it computes
    over. A mesh whose model axis is 1 leaves the model whole. -> model."""
    axis = axis_of(mesh)
    if axis is None:
        return model
    for prefix, layer in _layers(model):
        layer.tp = layer.attention.self.tp = axis
        for name, p in layer.named_parameters():
            dim = TP_RULES.get(name)
            if dim is not None:
                p.data = _slice(p.data, dim, axis).contiguous()
                p.tp_dim, p.tp_axis = dim, axis
    return model


def gather_params_tp(model) -> dict:
    """The model's full state dict, each split parameter gathered over the
    model axis (a collective: every model rank calls it)."""
    params = dict(model.named_parameters())
    return {k: gather_tensor(params[k], v) if k in params else v
            for k, v in model.state_dict().items()}


def split_state_dict(model, sd: dict) -> dict:
    """A full state dict -> the slices this rank's split model holds."""
    params = dict(model.named_parameters())
    return {k: local_slice(params[k], v) if k in params else v
            for k, v in sd.items()}


def unsplit_copy(model):
    """A copy of the model with every split parameter gathered whole and
    no model axis: what inference in a tensor-parallel run computes from
    (a collective: every model rank calls it). A whole model is copied as
    it is."""
    full = gather_params_tp(model) if is_split(model) else None
    out = copy.deepcopy(model)
    if full is None:
        return out
    for name, p in out.named_parameters():
        p.data = full[name].detach().clone()
        p.__dict__.pop("tp_dim", None)
        p.__dict__.pop("tp_axis", None)
    for _, layer in _layers(out):
        layer.tp = layer.attention.self.tp = None
    return out


def _optimizer_params(optimizer):
    inner = getattr(optimizer, "inner", optimizer)
    return [p for g in inner.param_groups for p in g["params"]]


def _map_like(p, state: dict, fn) -> dict:
    """fn(p, t) on each tensor of a parameter's optimizer state but the
    scalars (the moments, shaped like p); other entries as they are."""
    return {k: fn(p, v) if isinstance(v, torch.Tensor) and v.dim() else v
            for k, v in state.items()}


def gather_optimizer_state(optimizer, sd: dict) -> dict:
    """optimizer.state_dict() of a split model -> the same with each split
    parameter's moments (and a MultiSteps accumulator) gathered whole."""
    params = _optimizer_params(optimizer)
    return _walk_optimizer_sd(sd, params, gather_tensor)


def split_optimizer_state(optimizer, sd: dict) -> dict:
    """A full optimizer state dict -> this rank's slices of it."""
    params = _optimizer_params(optimizer)
    return _walk_optimizer_sd(sd, params, local_slice)


def _walk_optimizer_sd(sd, params, fn):
    out = dict(sd)
    if "inner" in sd:  # optim.MultiSteps
        out["inner"] = _walk_optimizer_sd(sd["inner"], params, fn)
        out["acc"] = {i: fn(params[int(i)], a) for i, a in sd["acc"].items()}
        return out
    out["state"] = {i: _map_like(params[int(i)], st, fn)
                    for i, st in sd["state"].items()}
    return out


def split_optimizer_(optimizer) -> None:
    """Cut the optimizer's state of each split parameter (whole tensors,
    as a loaded or converted state holds them) to this rank's slice, in
    place."""
    inner = getattr(optimizer, "inner", optimizer)
    for p, st in inner.state.items():
        for k, v in st.items():
            if isinstance(v, torch.Tensor) and v.dim():
                st[k] = local_slice(p, v)
    acc = getattr(optimizer, "acc", None)
    if acc:
        for p in list(acc):
            acc[p] = local_slice(p, acc[p])


def model_sum_sq(params, sq):
    """sq [n] float32, a per-tensor sum (a squared norm) of a tensor of
    each of `params` (the parameter, its gradient or its update): the
    entries of split parameters summed over their model axis (one
    all-reduce), the others as they are -> sq (a new tensor when any was
    summed)."""
    axis = split_axis(params)
    if axis is None:
        return sq
    idx = [i for i, p in enumerate(params) if split_dim(p) is not None]
    sel = torch.tensor(idx, device=sq.device)
    part = sq.index_select(0, sel).contiguous()
    dist.all_reduce(part, group=axis.group)
    return sq.index_copy(0, sel, part)


def _sum(x, axis):
    """The sum of x over the model axis, taken in float32 and returned in
    x's dtype (one all-reduce of a new tensor)."""
    out = x.float().contiguous().clone()
    dist.all_reduce(out, group=axis.group)
    return out.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """f: identity forward; the gradient all-reduced over the model axis."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    """g: all-reduce over the model axis forward; identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return _sum(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x, axis: Optional[TpAxis]):
    """f: x where a replicated activation enters split weights; its
    gradient is the sum of the model ranks'. No axis: x."""
    return x if axis is None else _CopyToModel.apply(x, axis)


def reduce_from_model(x, axis: Optional[TpAxis]):
    """g: the sum over the model ranks of their partial products x. No
    axis: x."""
    return x if axis is None else _ReduceFromModel.apply(x, axis)
