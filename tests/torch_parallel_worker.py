"""Worker of ``tests/test_torch_parallel.py``: one of two gloo processes
on the CPU. Runs, on inputs the test wrote with numpy (``inputs.npz``):

- the data-parallel GAN step of the paper generator on a global batch of
  4 (mesh (1, 2): 2 samples per rank), after the process-slice, gather
  and broadcast checks, with the networks in float32 and in float64; and
  the float64 step on the whole batch with its BatchNorms synced over a
  one-rank group;
- the object-parallel step over 2 objects (mesh (2, 1): one object per
  rank), batches and label draws injected;
- the sharded ``estimate_batch`` of 2 cube images (mesh (1, 2)).

Rank 0 writes what the test compares to ``out_<task>.npz``; each rank
writes its object's parameters. Usage::

    python tests/torch_parallel_worker.py <rank> <world> <rendezvous file>
        <work dir> <repo root>
"""

import os
import sys

rank, world, rdv, work, repo = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
sys.path.insert(0, repo)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pix2pose_torch.config import EstimatorConfig, TrainConfig  # noqa: E402
from pix2pose_torch.inference.engine import Pix2PoseEstimator  # noqa: E402
from pix2pose_torch.models import AutoEncoder, Discriminator  # noqa: E402
from pix2pose_torch.parallel import (host_local_to_global,  # noqa: E402
                                     init_distributed, make_mesh,
                                     make_parallel_train_step, process_slice,
                                     replicate, shard_batch,
                                     shard_inference_inputs)
from pix2pose_torch.models.batchnorm import synced_over  # noqa: E402
from pix2pose_torch.training.gan import (create_train_state,  # noqa: E402
                                         make_train_step)
from pix2pose_torch.training.multi import ObjectRun  # noqa: E402
from pix2pose_torch.utils import synthetic as tsyn  # noqa: E402
from pix2pose_torch.utils.convert import flax_to_state_dict  # noqa: E402

torch.set_num_threads(1)
assert init_distributed(f"file://{rdv}", world, rank, device="cpu") == (
    rank, world)
z = dict(np.load(os.path.join(work, "inputs.npz")))


def tree(prefix):
    """The flat ``prefix/...`` arrays of inputs.npz as a nested tree."""
    out = {}
    for key, v in z.items():
        if key.startswith(prefix + "/"):
            *parents, leaf = key[len(prefix) + 1:].split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = v
    return out


def state_from(prefix, dtype=torch.float32):
    gen, disc = AutoEncoder(), Discriminator()
    gen.load_state_dict(flax_to_state_dict(tree(prefix + "gen")),
                        strict=True)
    disc.load_state_dict(flax_to_state_dict(tree(prefix + "disc")),
                         strict=True)
    return create_train_state(gen.to(dtype), disc.to(dtype),
                              TrainConfig(batch_size=4))


def save(name, **arrays):
    np.savez(os.path.join(work, name), **arrays)


def weights(state):
    return {f"{net}.{k}": v.numpy() for net in ("gen", "disc")
            for k, v in getattr(state, net).state_dict().items()}


batch = {k: torch.from_numpy(z[k]) for k in ("src", "tgt", "prob_gt")}
labels = {k: torch.from_numpy(z[k]) for k in ("y_fake", "y_real",
                                             "flip_fake", "flip_real")}
lr = float(z["lr"])

# --- data parallel: the mesh helpers, then one step -----------------------
mesh = make_mesh((1, world), device="cpu")
assert process_slice(4) == slice(2 * rank, 2 * rank + 2)
try:
    process_slice(3)
    raise AssertionError("process_slice(3) over 2 ranks did not raise")
except ValueError:
    pass
local = shard_batch(mesh, batch)
assert local["src"].shape[0] == 2
assert all(torch.equal(host_local_to_global(mesh, local)[k], batch[k])
           for k in batch)
mine = torch.full((3,), float(rank))
assert torch.equal(replicate(mesh, mine), torch.zeros(3))
state = state_from("")
replicate(mesh, [state.gen, state.disc])
metrics = make_parallel_train_step(TrainConfig(batch_size=4), mesh, False)(
    state, batch, torch.from_numpy(z["pool"]), lr, labels)
# the same step with the networks and the input in float64
state64 = state_from("", torch.float64)
metrics64 = make_parallel_train_step(TrainConfig(batch_size=4), mesh,
                                     False)(
    state64, {**batch, "src": batch["src"].double()},
    torch.from_numpy(z["pool"]), lr, labels)
# the float64 step on the full batch with BatchNorm's synced path over a
# group of one rank (the path a one-GPU dp step does not take)
solo = [torch.distributed.new_group([r]) for r in range(world)][rank]
state64s = state_from("", torch.float64)
with synced_over(solo, state64s.gen, state64s.disc):
    metrics64s = make_train_step(TrainConfig(batch_size=4))(
        state64s, {**batch, "src": batch["src"].double()},
        torch.from_numpy(z["pool"]), lr, labels)
if rank == 0:  # .grad: the generator update's and the last disc update's
    for name, st, m in (("dp", state, metrics), ("dp64", state64,
                                                 metrics64),
                        ("dp64_one", state64s, metrics64s)):
        save(f"out_{name}.npz", **weights(st),
             **{f"metric.{k}": v.numpy() for k, v in m.items()},
             **{f"grad.{net}.{n}": p.grad.numpy() for net in ("gen", "disc")
                for n, p in getattr(st, net).named_parameters()})

# --- object parallel: object k on rank k ----------------------------------
omesh = make_mesh((world, 1), device="cpu")
runs = [ObjectRun(obj_id=k + 1, state=state_from(f"obj{k}/"), store=None,
                  sym_pool=torch.from_numpy(z["pool"]), full_rotation=True,
                  rng=torch.Generator()) for k in range(world)]
mine = omesh.axis_slice(world, "obj")
obj_batches = [{k: torch.from_numpy(z[f"obj{o}.{k}"])
                for k in ("src", "tgt", "prob_gt")} for o in range(world)]
obj_labels = [{k: torch.from_numpy(z[f"obj{o}.{k}"])
               for k in ("y_fake", "y_real", "flip_fake", "flip_real")}
              for o in range(world)]
ometrics = make_parallel_train_step(TrainConfig(batch_size=2), omesh, True)(
    runs[mine], 0, lr, obj_batches[mine], obj_labels[mine])
save(f"out_obj{rank}.npz", **weights(runs[rank].state))
if rank == 0:
    save("out_obj_metrics.npz",
         **{k: v.numpy() for k, v in ometrics.items()})

# --- sharded inference ----------------------------------------------------
est = Pix2PoseEstimator(tsyn.OracleGenerator(),
                        EstimatorConfig(outlier_th=(0.1, 0.2, 0.3),
                                        inlier_th=0.1), device="cpu")
gens = [torch.Generator().manual_seed(10 + i) for i in range(2)]
*inputs, my_gens = shard_inference_inputs(
    mesh, torch.from_numpy(z["rgbs"]), torch.from_numpy(z["bboxes"]),
    torch.from_numpy(z["det_valid"]), torch.from_numpy(z["cam_ks"]), gens)
out = host_local_to_global(mesh, est.estimate_batch(
    None, *inputs, z["obj_param"], my_gens))
if rank == 0:
    save("out_est.npz", R=out.R.numpy(), t=out.t.numpy(),
         valid=out.valid.numpy(), frac=out.frac_inlier.numpy(),
         n_inl=out.n_inliers.numpy(), mask=out.mask_pnp.numpy())
print(f"rank {rank} done", flush=True)
