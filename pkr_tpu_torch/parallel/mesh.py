"""The (data, model) process mesh and the classifier's sharding rule.

Port of ``pkr_tpu/parallel/mesh.py``.  ``pkr_tpu`` lays its devices out as a
``jax.sharding.Mesh`` with axes ``data`` and ``model`` and lets XLA insert
the collectives.  Here every card is one process, and the mesh is this
process's place on the same grid with the two process groups its
collectives run over:

- **data**: the global batch is split over it.  Every parameter is whole on
  every rank, and the train step all-reduces the gradients over the data
  group explicitly (``train/loop.py``), as ``pkr_tpu``'s mean over the
  global batch makes XLA do;
- **model**: the AAM weight's class rows may be split over it (the flash
  head's tensor-parallel regime, ``ops/flash_aam.py``'s
  ``make_flash_aam_sharded``).  Ranks of one data row see the same batch.

Ranks are laid out ``rank = data_index * n_model + model_index``: the model
axis innermost, as ``pkr_tpu`` lays it, so that a class-sharded head's
collectives stay among neighbouring ranks (on one host's NVLink).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from pkr_tpu_torch.parallel.distributed import process_count, process_index

_AAM_HEADS = ("AAM", "AAM-v1")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's coordinates on an (n_data, n_model) grid and the groups
    of its row and column; a group is None where its axis has one rank
    (its collectives are then the identity)."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: Any = None   # the ranks with this model_index
    model_group: Any = None  # the ranks with this data_index

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (data, model) mesh over every process of the group (one process:
    a 1 × 1 mesh with no groups).  ``n_data`` defaults to the world size
    over ``n_model``.  Every rank must call it, in the same order as any
    other ``new_group``."""
    world, rank = process_count(), process_index()
    if world % n_model:
        raise ValueError(f"{world} process(es) do not split into model rows of {n_model} "
                         f"(train.model_parallel): start a multiple of {n_model} processes")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} processes")
    groups: Dict[str, Any] = {"data": None, "model": None}
    if world > 1:
        # new_group is collective: every rank creates every group, in order
        d_me, m_me = divmod(rank, n_model)
        if n_data > 1:
            for m in range(n_model):
                g = dist.new_group([d * n_model + m for d in range(n_data)])
                if m == m_me:
                    groups["data"] = g
        if n_model > 1:
            for d in range(n_data):
                g = dist.new_group([d * n_model + m for m in range(n_model)])
                if d == d_me:
                    groups["model"] = g
    return Mesh(n_data, n_model, rank // n_model, rank % n_model,
                groups["data"], groups["model"])


def batch_sharding(mesh: Mesh) -> Tuple[int, int]:
    """(index, count) of this rank's share of a global batch: the leading
    axis splits over ``data`` (what a loader takes as process_index and
    process_count; ranks of one data row load the same share)."""
    return mesh.data_index, mesh.n_data


def replicated(mesh: Mesh) -> None:
    """The split dimension of a tensor that every rank holds whole: none
    (:func:`param_sharding_rules`' answer for it)."""
    return None


def param_sharding_rules(name: str, shape: Tuple[int, ...], model_size: int = 1,
                         loss: str = "AAM") -> Optional[int]:
    """The dimension of parameter ``name`` split over ``model``, or None
    where every rank holds it whole.  ``pkr_tpu``'s rule: the AAM weight's
    class rows (``last.weight``, (n_classes, D)) split only when the class
    count divides the axis; otherwise (a 7325-speaker head on a 2-way axis)
    the weight is whole on every rank, the regime make_flash_aam_sharded's
    replicated weight handles.  Everything else is whole: the trunk is
    small, and data parallelism is its regime.  The softmax head keeps its
    weight whole (its dense logits are (B, n_classes) on every rank
    anyway)."""
    if (loss in _AAM_HEADS and name == "last.weight" and model_size > 1
            and shape[0] % model_size == 0):
        return 0
    return None


def weight_is_sharded(model) -> bool:
    """True where ``model``'s AAM weight holds a class shard (fewer rows
    than ``spk_num``)."""
    return (model.loss in _AAM_HEADS
            and model.last.weight.shape[0] != model.spk_num)


@torch.no_grad()
def shard_params(model, mesh: Mesh, state=None):
    """Cut each parameter that :func:`param_sharding_rules` splits down to
    this rank's rows, in ``model`` and, where given, in the ``TrainState``'s
    momentum, and return the rule's {name: dim} for the parameters it
    split.  A model whose weight is already a shard is left alone."""
    specs = {}
    if weight_is_sharded(model):
        return {"last.weight": 0}
    for name, p in model.named_parameters():
        dim = param_sharding_rules(name, tuple(p.shape), mesh.n_model, model.loss)
        if dim is None:
            continue
        rows = p.shape[dim] // mesh.n_model
        lo = mesh.model_index * rows
        p.data = p.data.narrow(dim, lo, rows).contiguous()
        if state is not None:
            state.momentum[name] = state.momentum[name].narrow(dim, lo, rows).contiguous()
        specs[name] = dim
    return specs


def gather_rows(local: torch.Tensor, mesh: Mesh, n_rows: int) -> torch.Tensor:
    """The whole (n_rows, ...) tensor from every model rank's block of rows:
    each rank writes its block into zeros and the blocks are summed over
    the model group (an all_reduce, which every backend carries for CUDA
    tensors; gloo's all_gather does not)."""
    rows = local.shape[0]
    full = torch.zeros((n_rows,) + tuple(local.shape[1:]), dtype=local.dtype,
                       device=local.device)
    full[mesh.model_index * rows:(mesh.model_index + 1) * rows] = local
    if mesh.model_group is not None:
        dist.all_reduce(full, group=mesh.model_group)
    return full
