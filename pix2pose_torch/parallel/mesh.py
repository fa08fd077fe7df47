"""Process meshes and sharded training and inference on
``torch.distributed`` (port of :mod:`pix2pose_tpu.parallel.mesh`).

The reference has no distributed layer: it trains one object per GPU job
(``train.sh:1-21``). The JAX package lays its chips out as an (obj, dp)
mesh and lets XLA insert the collectives; here each process is one mesh
point (one GPU, or the CPU with gloo) and the collectives are explicit:

- ``dp``: a GAN step's global batch is split over the dp ranks; every
  train-mode BatchNorm normalizes with the whole batch's statistics
  (:func:`pix2pose_torch.models.batchnorm.synced_over`), and gradients
  are averaged over the dp group before each of the step's three Adam
  updates, so a dp step equals the one-process step on the global batch.
- ``obj``: the objects of a multi-object run
  (:func:`pix2pose_torch.training.multi.make_multi_step`) are split over
  the obj ranks, each object's batch over its dp group.

Every rank draws the same global batch from the same seeded generator and
takes its slice (:func:`shard_batch`), so the draws equal a
single-process run's. NCCL serves CUDA devices (one process per GPU: it
refuses two ranks on one device), gloo the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from pix2pose_torch.models.batchnorm import synced_over


def _dist():
    import torch.distributed as dist

    return dist


def _world() -> tuple[int, int]:
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None,
                     device="cuda") -> tuple[int, int]:
    """Join the process group (NCCL for a CUDA ``device``, gloo for the
    CPU) when an ``init_method`` (``tcp://host:port``, ``file://path``) or
    a ``world_size`` is given and no group exists yet; a CUDA process uses
    the device of its rank. Idempotent. Returns ``(rank, world_size)``."""
    dist = _dist()
    dev = torch.device(device)
    if not dist.is_initialized() and (init_method or world_size):
        rank = rank or 0
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else rank % torch.cuda.device_count())
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method or "env://",
            world_size=world_size or 1, rank=rank)
    return _world()


def _share(n_total: int, parts: int, index: int) -> slice:
    per = n_total // parts
    if per * parts != n_total:
        raise ValueError(f"batch {n_total} not divisible by {parts} ranks")
    return slice(per * index, per * (index + 1))


def process_slice(n_total: int) -> slice:
    """This process's contiguous share of a length-``n_total`` axis over
    all processes (raises when they cannot share it evenly)."""
    rank, world = _world()
    return _share(n_total, world, rank)


@dataclasses.dataclass
class Mesh:
    """The processes laid out as an (obj, dp) grid, rank ``r`` at
    ``(r // dp, r % dp)``, with the process group of this rank along each
    axis (None without a process group: one process)."""

    shape: tuple            # (obj, dp)
    axis_names: tuple
    rank: int
    device: torch.device
    groups: dict            # axis name -> process group of this rank

    @property
    def index(self) -> dict:
        return {self.axis_names[0]: self.rank // self.shape[1],
                self.axis_names[1]: self.rank % self.shape[1]}

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_slice(self, n_total: int, axis: str = "dp") -> slice:
        """This rank's share of a length-``n_total`` axis split over the
        mesh ``axis``."""
        return _share(n_total, self.size(axis), self.index[axis])


def make_mesh(axis_sizes: Sequence[int] | None = None,
              axis_names: Sequence[str] = ("obj", "dp"),
              device="cuda") -> Mesh:
    """The mesh over every process: by default all on ``dp`` with
    ``obj=1``; ``axis_sizes`` (obj, dp) splits them, e.g. ``(2, 2)``.
    Every process must call it (it creates the axis groups together)."""
    rank, world = _world()
    axis_sizes = tuple(axis_sizes) if axis_sizes else (1, world)
    if axis_sizes[0] * axis_sizes[1] != world:
        raise ValueError(f"mesh {axis_sizes} != {world} processes")
    n_obj, n_dp = axis_sizes
    groups = {name: None for name in axis_names}
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        for o in range(n_obj):        # every rank creates every group
            g = dist.new_group([o * n_dp + d for d in range(n_dp)])
            if rank // n_dp == o:
                groups[axis_names[1]] = g
        for d in range(n_dp):
            g = dist.new_group([o * n_dp + d for o in range(n_obj)])
            if rank % n_dp == d:
                groups[axis_names[0]] = g
    return Mesh(axis_sizes, tuple(axis_names), rank, torch.device(device),
                groups)


def _map(fn, tree):
    """``fn`` on every tensor or array leaf of dicts, lists, tuples and
    named tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if tree is None or isinstance(tree, (int, float, bool, str)):
        return tree
    return fn(tree)


def shard_batch(mesh: Mesh, batch, obj_axis: bool = False):
    """This rank's share of a global batch, on the mesh's device: the
    leading axis split over ``dp``, or with ``obj_axis`` the leading axis
    over ``obj`` and the next over ``dp``. 0-d leaves (a batch-wide flag)
    are kept whole."""
    def take(x):
        x = torch.as_tensor(x).to(mesh.device)
        if x.dim() == 0:
            return x
        if obj_axis:
            x = x[mesh.axis_slice(x.shape[0], mesh.axis_names[0])]
            return x[:, mesh.axis_slice(x.shape[1], mesh.axis_names[1])]
        return x[mesh.axis_slice(x.shape[0], mesh.axis_names[1])]

    return _map(take, batch)


def replicate(mesh: Mesh, tree):
    """Rank 0's values on every rank: each tensor leaf, or each parameter
    and buffer of a module leaf, broadcast in place. Returns ``tree``."""
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        return tree

    def bcast(x):
        if isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                dist.broadcast(t.data, src=0)
        else:
            dist.broadcast(x, src=0)
        return x

    _map(bcast, tree)
    return tree


def host_local_to_global(mesh: Mesh, batch, axis: str = "dp"):
    """Every rank's local shard of ``batch`` concatenated in rank order
    along the leading axis (an all-gather over the mesh ``axis``); with
    one rank on the axis the shard itself."""
    group = mesh.groups.get(axis)
    if group is None:
        return batch
    dist = _dist()
    n = dist.get_world_size(group)

    def gather(x):
        x = x.contiguous()
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        parts = [torch.empty_like(wire) for _ in range(n)]
        dist.all_gather(parts, wire, group=group)
        out = torch.cat(parts) if x.dim() else torch.stack(parts)
        return out.to(torch.bool) if x.dtype == torch.bool else out

    return _map(gather, batch)


def shard_inference_inputs(mesh: Mesh, rgbs, bboxes, det_valid, cam_ks,
                           generators):
    """This rank's share of a multi-image inference batch, the image axis
    split over ``dp``: rgbs (B, H, W, 3), bboxes (B, N, 4), det_valid
    (B, N), cam_ks (B, 3, 3) and one RANSAC ``torch.Generator`` per image
    (so each image's poses equal those of the unsharded call). Feed them
    to :meth:`~pix2pose_torch.inference.engine.Pix2PoseEstimator.
    estimate_batch` and gather its result with
    :func:`host_local_to_global`."""
    sl = mesh.axis_slice(len(generators), mesh.axis_names[1])
    local = shard_batch(mesh, (rgbs, bboxes, det_valid, cam_ks))
    return (*local, list(generators)[sl])


def _grad_reducer(group):
    """``reduce(net)``: the mean of ``net``'s gradients over ``group``,
    in place, through one flat all-reduce."""
    dist = _dist()
    n = dist.get_world_size(group)

    def reduce(net):
        grads = [p.grad for p in net.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= n
        i = 0
        for g in grads:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()

    return reduce


def make_parallel_train_step(cfg, mesh: Mesh, object_parallel: bool):
    """The port's GAN step (:func:`pix2pose_torch.training.gan.
    make_train_step`) over the mesh.

    - ``object_parallel=False``: ``step(state, batch, sym_pool, lr,
      labels) -> metrics`` takes the GLOBAL batch and label draws (equal
      on every rank), trains on this rank's dp share with BatchNorm
      statistics over the dp group and gradients averaged over it before
      each Adam update, and returns the global batch's metrics (the mean
      of the ranks'). ``state`` must start equal on every rank
      (:func:`replicate`); it stays so.
    - ``object_parallel=True``: ``step(runs, step_idx, lr, batches=None,
      labels=None) -> metrics`` is :func:`~pix2pose_torch.training.multi.
      make_multi_step` over this rank's objects (``runs``, the objects of
      ``mesh.axis_slice(n_objects, "obj")``), each trained by the dp step
      above; the metrics of every object, in object order, come back on
      every rank as (K,) tensors.
    """
    from pix2pose_torch.training.gan import make_train_step
    from pix2pose_torch.training.multi import make_multi_step

    dp_name, obj_name = mesh.axis_names[1], mesh.axis_names[0]
    dp_group = mesh.groups.get(dp_name)
    raw = make_train_step(cfg, reduce_grads=(
        _grad_reducer(dp_group) if dp_group is not None
        else lambda net: None))
    # one dp rank holds the whole batch: its BatchNorms take the plain path
    bn_group = dp_group if mesh.size(dp_name) > 1 else None

    def dp_step(state, batch, sym_pool, lr, labels) -> dict:
        with synced_over(bn_group, state.gen, state.disc):
            metrics = raw(state, shard_batch(mesh, batch), sym_pool, lr,
                          shard_batch(mesh, labels))
        if dp_group is None:
            return metrics
        names = sorted(metrics)
        flat = torch.stack([metrics[k] for k in names])
        _dist().all_reduce(flat, group=dp_group)
        flat /= mesh.size(dp_name)
        return dict(zip(names, flat))

    if not object_parallel:
        return dp_step
    multi = make_multi_step(cfg, train_step=dp_step)

    def obj_step(runs, step_idx, lr, batches=None, labels=None) -> dict:
        return host_local_to_global(
            mesh, multi(runs, step_idx, lr, batches, labels), obj_name)

    return obj_step
